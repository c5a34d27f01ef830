"""Line Density Map renderer: DVR of the scattering line-density field.

Counterpart of `linevis_tpu/render/line_density_map.py` (reference
`src/Renderers/Scattering/LineDensityMapRenderer.{hpp:55,cpp}` and
`Data/Shaders/Scattering/LineDensityFieldDvrShader.glsl`): per pixel, a ray
is clipped to the field's box and marched with step voxel_size / 10; each
step samples the field, maps density through the transfer function,
converts opacity by Beer-Lambert with the attenuation coefficient (default
200, LineDensityMapRenderer.hpp:113) and blends front to back. The march is
kernel R4 (`kernels/density_march.py`): one launch a frame on the card, its
plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.kernels.density_march import density_march, march_params
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.transfer_function import TransferFunction

__all__ = ["render_line_density_map", "LineDensityMapRenderer"]


def render_line_density_map(
    field: torch.Tensor,  # [Z, Y, X] in [0, 1]
    b_min,  # [3]
    b_max,
    ray_origin: torch.Tensor,  # [3]
    ray_basis: torch.Tensor,  # [3, 3] columns right/up/fwd (tube_raster)
    width: int,
    height: int,
    attenuation: float = 200.0,
    n_steps: int = 256,
    tf_color: tuple = (),
    tf_opacity: tuple = ((0.0, 0.0), (1.0, 1.0)),
    background=(1.0, 1.0, 1.0, 0.0),
) -> torch.Tensor:
    """-> [H, W, 4] linear RGBA on the field's device."""
    prm, _ = march_params(field.shape, b_min, b_max, ray_origin, ray_basis, width, height,
                          attenuation, background)
    return density_march(field.float(), prm, width, height, n_steps, tf_color, tf_opacity)


class LineDensityMapRenderer:
    """Registry renderer (RENDERING_MODE_LINE_DENSITY_MAP) drawing on
    `device`."""

    name = "Line Density Map Renderer"

    def __init__(self, settings=None, device="cuda"):
        self.device = torch.device(device)
        self.line_data = None
        self.transfer_function = TransferFunction.standard()
        self.attenuation = 200.0
        self.opacity = 0.3
        if settings is not None and settings.has_key("attenuation"):
            self.attenuation = settings.get_float("attenuation")

    def set_line_data(self, line_data) -> None:
        self.line_data = line_data

    def set_transfer_function(self, tf) -> None:
        self.transfer_function = tf

    def set_new_settings(self, settings) -> None:
        if settings.has_key("attenuation"):
            self.attenuation = settings.get_float("attenuation")

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.tube_raster import _ray_basis

        ld = self.line_data
        dev = self.device
        field = ld.get_line_density_field(device=dev)
        c_pts, o_pts = self.transfer_function.as_static_points()
        if all(abs(p[1] - 1.0) < 1e-6 for p in o_pts):
            # A constant-opacity line TF makes the DVR a solid box: take a
            # steep density -> opacity ramp instead (zero transparent,
            # saturating at 5% of the normalised maximum; line-density fields
            # are sparse).
            o_pts = ((0.0, 0.0), (0.05, 1.0), (1.0, 1.0))
        basis = _ray_basis(torch.as_tensor(camera.view_projection_matrix(), device=dev))
        img = render_line_density_map(
            field, ld.grid_b_min, ld.grid_b_max,
            torch.as_tensor(np.asarray(camera.position, np.float32), device=dev),
            basis, camera.width, camera.height, attenuation=self.attenuation,
            tf_color=c_pts, tf_opacity=o_pts)
        return hand_back(img, channels_first=False)
