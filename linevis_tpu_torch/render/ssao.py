"""Screen-space ambient occlusion: SSAO and horizon-based GTAO.

Counterpart of `linevis_tpu/render/ssao.py`. Reference:
`src/Renderers/AmbientOcclusion/{SSAO.cpp:396,GTAO.cpp:425}` and
`Data/Shaders/AO/SSAO/GenerateSSAOTexture.glsl`.
- `ssao`: hemisphere kernel samples around each fragment's view-space
  position (radius 0.05, bias 0.005, sample distances lerp-scaled from 0.1
  to 1.0, SSAO.cpp:307-327, GenerateSSAOTexture.glsl:48-100), tested
  against the depth buffer with the reference's smoothstep range check.
- `gtao`: per pixel a screen-space horizon march along a few directions;
  the occlusion is the largest horizon elevation above the tangent plane.
Both read the raster G-buffer's view depth and normals; the sample lookups
are gathers on [H, W] maps.
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.ops import threefry

__all__ = ["ssao", "gtao"]


def _view_positions(view_z, ray_basis):
    """[3, H, W] view-ray-scaled positions (camera at the origin)."""
    H, W = view_z.shape
    dev = view_z.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :] * (2.0 / W) - 1.0
    v = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None] * (2.0 / H)
    d = (
        ray_basis[:, 0][:, None, None] * u.expand(H, W)[None]
        + ray_basis[:, 1][:, None, None] * v.expand(H, W)[None]
        + ray_basis[:, 2][:, None, None]
    )
    return d * view_z[None]


def ssao(
    view_z: torch.Tensor,  # [H, W] view depth (large where background)
    normal: torch.Tensor,  # [3, H, W]
    ray_basis: torch.Tensor,  # [3, 3]
    fg: torch.Tensor,  # [H, W] foreground mask
    radius: float = 0.05,
    bias: float = 0.005,
    num_samples: int = 16,
    seed: int = 0,
    directions: torch.Tensor = None,  # [num_samples, 3] normal draws
) -> torch.Tensor:
    """-> AO [H, W] in [0, 1] (1 = unoccluded). The hemisphere kernel is
    built from `directions` ([num_samples, 3] standard normal draws), or,
    when none are given, from the JAX function's draw: `normal(k1,
    (num_samples, 3))` with (k1, k2) = split(PRNGKey(seed)), drawn on the
    maps' device by `ops/threefry.py:normal` (within 3 ulps of
    jax.random's)."""
    H, W = view_z.shape
    dev = view_z.device
    pos = _view_positions(view_z, ray_basis)
    if directions is None:
        directions = threefry.normal(threefry.split(threefry.prng_key(seed, dev))[0],
                                     (num_samples, 3))
    d = directions.to(device=dev, dtype=torch.float32).clone()
    # Hemisphere kernel with lerp-scaled radii (SSAO.cpp:307-327).
    d[:, 2] = torch.abs(d[:, 2])
    d = d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
    scale = 0.1 + (torch.arange(num_samples, device=dev) / num_samples) * 0.9
    kernel = d * scale[:, None]

    n = normal / torch.clamp(torch.sqrt(torch.sum(normal * normal, dim=0, keepdim=True)),
                             min=1e-12)
    # Per-pixel TBN (branchless Frisvad).
    sign = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t1 = torch.stack([1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    t2 = torch.stack([b, sign + n[1] * n[1] * a, -n[1]])

    fwd = ray_basis[:, 2] / torch.sqrt(torch.sum(ray_basis[:, 2] ** 2))
    r_ax, u_ax = ray_basis[:, 0], ray_basis[:, 1]
    occ = torch.zeros((H, W), dtype=torch.float32, device=dev)
    flat_z = view_z.reshape(-1)
    for i in range(num_samples):
        kx, ky, kz = kernel[i, 0], kernel[i, 1], kernel[i, 2]
        sample = pos + radius * (t1 * kx + t2 * ky + n * kz)
        # Project to pixel coordinates: depth along the forward axis.
        s_z = torch.clamp(torch.sum(sample * fwd[:, None, None], dim=0), min=1e-4)
        su = torch.sum(sample * r_ax[:, None, None], dim=0) / (torch.sum(r_ax * r_ax) * s_z)
        sv = torch.sum(sample * u_ax[:, None, None], dim=0) / (torch.sum(u_ax * u_ax) * s_z)
        px = torch.clamp(((su + 1.0) * 0.5 * W).to(torch.int32), 0, W - 1)
        py = torch.clamp(((1.0 - sv) * 0.5 * H).to(torch.int32), 0, H - 1)
        scene_z = flat_z[(py * W + px).long()]
        range_check = torch.clamp(radius / torch.clamp(torch.abs(view_z - scene_z), min=1e-6),
                                  0.0, 1.0)
        range_check = range_check * range_check * (3.0 - 2.0 * range_check)
        occluded = torch.where(scene_z <= s_z - bias, 1.0, 0.0)
        occ = occ + occluded * range_check
    ao = 1.0 - occ / num_samples
    return torch.where(fg, ao, 1.0)


def gtao(
    view_z: torch.Tensor,  # [H, W]
    normal: torch.Tensor,  # [3, H, W]
    ray_basis: torch.Tensor,
    fg: torch.Tensor,
    radius: float = 0.05,
    num_directions: int = 4,
    num_steps: int = 6,
) -> torch.Tensor:
    """Horizon-based AO (GTAO.cpp's role): march screen-space directions; the
    occlusion is the largest elevation of nearer geometry within `radius`."""
    H, W = view_z.shape
    dev = view_z.device
    pos = _view_positions(view_z, ray_basis)
    n = normal / torch.clamp(torch.sqrt(torch.sum(normal * normal, dim=0, keepdim=True)),
                             min=1e-12)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    xx, yy = xx.float(), yy.float()
    occ = torch.zeros((H, W), dtype=torch.float32, device=dev)
    # Screen-space step length: the radius projected at the pixel's depth.
    px_per_unit = 0.5 * W * torch.sqrt(torch.sum(ray_basis[:, 0] ** 2))
    step_px = torch.clamp(radius * px_per_unit / torch.clamp(view_z, min=1e-3) / num_steps,
                          min=1.0)
    flat_pos = pos.reshape(3, -1)
    flat_fg = fg.reshape(-1)
    for di in range(num_directions):
        ang = np.pi * di / num_directions
        dx, dy = np.cos(ang), np.sin(ang)
        for s_dir in (1.0, -1.0):
            max_sin = torch.zeros((H, W), dtype=torch.float32, device=dev)
            for s in range(1, num_steps + 1):
                sx = torch.clamp((xx + s_dir * dx * s * step_px).to(torch.int32), 0, W - 1)
                sy = torch.clamp((yy + s_dir * dy * s * step_px).to(torch.int32), 0, H - 1)
                idx = (sy * W + sx).long()
                delta = flat_pos[:, idx] - pos
                dist = torch.clamp(torch.sqrt(torch.sum(delta * delta, dim=0)), min=1e-6)
                # Elevation of the sample above the surface's tangent plane.
                sin_h = torch.sum(delta * n, dim=0) / dist
                valid = (dist < radius) & flat_fg[idx]
                max_sin = torch.maximum(max_sin, torch.where(valid, sin_h, 0.0))
            occ = occ + torch.clamp(max_sin, 0.0, 1.0)
    ao = 1.0 - occ / (2.0 * num_directions)
    return torch.where(fg, torch.clamp(ao, 0.0, 1.0), 1.0)
