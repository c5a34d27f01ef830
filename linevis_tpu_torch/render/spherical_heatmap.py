"""Spherical heat map of scattering exit directions (Mollweide projection).

Counterpart of `linevis_tpu/render/spherical_heatmap.py` (reference
`src/Renderers/Scattering/SphericalHeatMapRenderer.{hpp:44-52,cpp}` and
`create_spherical_heatmap_image`, `DtPathTrace.cpp:84-183`): every pixel
of a 2:1 Mollweide ellipse is un-projected to a point on the unit sphere;
the density of exit directions around it is a Gaussian RBF sum (search
radius 0.1, epsilon 3.0), tone-mapped blue -> green -> red. The RBF sum is
kernel R5 (`kernels/spherical_heatmap.py`): one launch a map on the card,
its banded plain version on the CPU; the projection, the max-normalisation
and the colour ramp are plain PyTorch on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.kernels.spherical_heatmap import heatmap_density
from linevis_tpu_torch.kernels.volume_common import vdiv
from linevis_tpu_torch.render.handback import hand_back

__all__ = ["render_spherical_heatmap", "mollweide_points", "SphericalHeatMapRenderer"]


def mollweide_points(height: int, device="cuda"):
    """The inverse Mollweide projection (DtPathTrace.cpp:110-127) of a
    [height, 2 height] map -> (points [H 2H, 3] on the unit sphere, inside
    [H, 2H] bool: the ellipse)."""
    width = height * 2
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    u = -1.0 + vdiv(xs, width - 1) * 2.0  # [-1, 1]
    v = -0.5 + vdiv(ys, height - 1)  # [-0.5, 0.5]
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    inside = uu * uu + 4.0 * vv * vv <= 1.0
    two_sqrt_two = 2.0 * float(np.sqrt(np.float32(2.0)))
    x_in = two_sqrt_two * uu
    y_in = two_sqrt_two * vv
    a = vdiv(x_in, 4.0)
    b = vdiv(y_in, 2.0)
    z = torch.sqrt(torch.clamp(1.0 - a * a - b * b, 0.0, 1.0))
    lam = 2.0 * torch.atan2(z * x_in, 2.0 * (2.0 * z * z - 1.0))
    phi = torch.asin(torch.clamp(z * y_in, -1.0, 1.0))
    # point = rotY(lambda) * rotZ(phi) * (1, 0, 0)
    px = torch.cos(lam) * torch.cos(phi)
    py = torch.sin(phi)
    pz = -torch.sin(lam) * torch.cos(phi)
    return torch.stack([px, py, pz], dim=-1).reshape(-1, 3), inside


def heatmap_ramp(val: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """Max-normalise the density [H, W] over the ellipse and map it through
    the reference's ramp (DtPathTrace.cpp:166-173) -> [H, W, 4]."""
    vmax = torch.clamp(torch.where(inside, val, torch.zeros_like(val)).max(), min=1e-12)
    t = val / vmax
    lo = torch.clamp(2.0 * t, 0.0, 1.0)
    hi = torch.clamp(2.0 * t - 1.0, 0.0, 1.0)
    r = hi
    g = torch.where(t < 0.5, lo, 1.0 - hi)
    b = torch.where(t < 0.5, 1.0 - lo, torch.zeros_like(lo))
    a = inside.float()
    rgb = torch.stack([r, g, b], dim=-1) * a[..., None]
    return torch.cat([rgb, a[..., None]], dim=-1)


def render_spherical_heatmap(exit_dirs: torch.Tensor, height: int = 128) -> torch.Tensor:
    """exit_dirs [N, 3] unit vectors -> [H, 2H, 4] RGBA heat map on their
    device (outside the ellipse: transparent)."""
    pts, inside = mollweide_points(height, exit_dirs.device)
    val = heatmap_density(pts, exit_dirs.float(), 2 * height).reshape(height, 2 * height)
    return heatmap_ramp(val, inside)


class SphericalHeatMapRenderer:
    """Registry renderer (RENDERING_MODE_SPHERICAL_HEAT_MAP) drawing on
    `device`."""

    name = "Spherical Heat Map Renderer"

    def __init__(self, settings=None, device="cuda"):
        self.device = torch.device(device)
        self.line_data = None

    def set_line_data(self, line_data) -> None:
        self.line_data = line_data

    def set_transfer_function(self, tf) -> None:
        pass

    def set_new_settings(self, settings) -> None:
        pass

    def render(self, camera) -> np.ndarray:
        dirs = self.line_data.exit_directions
        if dirs is None or len(dirs) == 0:
            return np.zeros((camera.height, camera.height * 2, 4), np.float32)
        img = render_spherical_heatmap(torch.as_tensor(dirs, device=self.device),
                                       height=camera.height)
        return hand_back(img, channels_first=False)
