"""Shading math: Blinn-Phong tube shading, depth cues, channels-first.

Counterpart of `linevis_tpu/render/lighting.py`, a behavioral port of
`Data/Shaders/Utils/Lighting.glsl` (`blinnPhongShadingTube`): headlight at
the camera, tube-aware diffuse term, kA=0.1 kD=0.9 kS=0.3 s=30, exponent
1.7 (tubes) / 1.0 (bands); the general surface Blinn-Phong of triangle-mesh
datasets and hulls; depth-cue darkening toward gray 0.5.

Vector tensors are channels-first: [3, ...].
"""

from __future__ import annotations

import torch

__all__ = [
    "dot3", "normalize3", "cross3", "blinn_phong_shade_tube", "blinn_phong_shade_surface",
    "apply_depth_cue",
]

_EPS = 1e-8


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=0)


def normalize3(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=0, keepdim=True)), min=_EPS)


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        dim=0,
    )


def blinn_phong_shade_tube(
    base_color: torch.Tensor,  # [3, ...] linear RGB
    position: torch.Tensor,  # [3, ...] world
    normal: torch.Tensor,  # [3, ...]
    tangent: torch.Tensor,  # [3, ...]
    camera_position: torch.Tensor,  # [3]
    use_bands: bool = False,
) -> torch.Tensor:
    k_a, k_d, k_s, s = 0.1, 0.9, 0.3, 30.0
    exponent = 1.0 if use_bands else 1.7

    extra = (1,) * (position.dim() - 1)
    cam = camera_position.reshape((3,) + extra)
    n = normalize3(normal)
    v = normalize3(cam - position)
    light = v  # headlight
    h = normalize3(v + light)
    t = normalize3(tangent)

    helper = normalize3(cross3(t, light))
    new_l = normalize3(cross3(helper, t))

    cos1 = torch.clamp(torch.abs(dot3(n, light)), 0.0, 1.0) ** exponent
    cos2 = torch.clamp(torch.abs(dot3(n, new_l)), 0.0, 1.0) ** exponent
    cos_combined = 0.3 * cos1 + 0.7 * cos2

    i_a = k_a * base_color
    i_d = k_d * cos_combined[None] * base_color
    i_s = k_s * torch.clamp(torch.abs(dot3(n, h)), 0.0, 1.0)[None] ** s
    return i_a + i_d + i_s


def blinn_phong_shade_surface(
    base_color: torch.Tensor,  # [3, ...] linear RGB
    position: torch.Tensor,  # [3, ...] world
    normal: torch.Tensor,  # [3, ...]
    camera_position: torch.Tensor,  # [3]
) -> torch.Tensor:
    """General (non-tube) Blinn-Phong with the reference's surface
    constants kA=0.1, kD=1.0, kS=0.3, s=50 (Lighting.glsl:66-72), headlight
    l = v, used for triangle-mesh datasets and hulls."""
    k_a, k_d, k_s, s = 0.1, 1.0, 0.3, 50.0
    extra = (1,) * (position.dim() - 1)
    cam = camera_position.reshape((3,) + extra)
    n = normalize3(normal)
    v = normalize3(cam - position)
    h = v  # headlight: h = normalize(v + l) = v
    i_a = k_a * base_color
    i_d = k_d * torch.clamp(torch.abs(dot3(n, v)), 0.0, 1.0)[None] * base_color
    i_s = k_s * torch.clamp(torch.abs(dot3(n, h)), 0.0, 1.0)[None] ** s
    return i_a + i_d + i_s


def apply_depth_cue(
    color: torch.Tensor,  # [3, ...]
    view_z: torch.Tensor,  # [...] positive distance along view dir
    min_depth: torch.Tensor,
    max_depth: torch.Tensor,
    strength: float = 0.8,
) -> torch.Tensor:
    """Darken toward gray with squared normalized view depth."""
    f = torch.clamp(
        (view_z - min_depth) / torch.clamp(max_depth - min_depth, min=1e-6),
        0.0, 1.0,
    )
    f = (f * f * strength)[None]
    return color * (1.0 - f) + 0.5 * f
