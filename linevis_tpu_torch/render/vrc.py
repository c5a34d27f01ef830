"""Voxel Ray Casting: quantized voxel-curve rendering.

Counterpart of `linevis_tpu/render/vrc.py` (the reference's VRC mode,
Kanzler et al. 2018; `src/Renderers/VRC/VoxelCurveDiscretizer{Cpu,Gpu}.cpp`,
`Data/Shaders/Renderers/VRC/TraverseGrid.glsl:51-135`): curves are
discretized into a voxel grid (every line segment clipped against each
voxel it crosses, its endpoints quantized to a `quantization`-step lattice
in the voxel, `VoxelData.hpp:57-74`), then drawn as analytic tubes.

As in the JAX package, the quantized per-voxel segments are binned to
screen tiles and drawn by the capsule raster (kernel B1 on the card,
`render/tube_raster.py:render_tubes_image`) instead of a per-ray DDA: the
same nearest-hit analytic intersection, the voxel-snapped geometry kept
exactly. The discretization is elementwise PyTorch on the line data's
device, with the JAX function's integer cells and masks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels.volume_common import vdiv
from linevis_tpu_torch.render.tube_raster import CapsuleScene

__all__ = ["discretize_curves", "VoxelRayCastingRenderer"]


def discretize_curves(
    positions: torch.Tensor,  # [L, P, 3]
    mask: torch.Tensor,  # [L, P]
    attrs: torch.Tensor,  # [L, P]
    grid_resolution: int = 128,
    quantization: int = 8,
    span: int = 3,
):
    """Clip every segment to each voxel it crosses; quantize the endpoints
    to a `quantization`-step in-voxel lattice.

    Returns (a [3, N], b [3, N], attr0 [N], attr1 [N], valid [N]) with
    N = span^3 * S (invalid pairs masked out), on the positions' device.
    """
    pos = positions.float()
    dev = pos.device
    L, P = pos.shape[:2]
    cf = pos.reshape(L * P, 3).T.reshape(3, L, P)
    a = cf[:, :, :-1].reshape(3, -1)
    b = cf[:, :, 1:].reshape(3, -1)
    m = mask.bool()
    seg_ok = (m[:, :-1] & m[:, 1:]).reshape(-1)
    at = attrs.float()
    a0 = at[:, :-1].reshape(-1)
    a1 = at[:, 1:].reshape(-1)
    S = a.shape[1]
    G = int(grid_resolution)

    big = 3e38
    lo_all = torch.where(seg_ok[None], torch.minimum(a, b), torch.full_like(a, big)).amin(dim=1)
    hi_all = torch.where(seg_ok[None], torch.maximum(a, b), torch.full_like(a, -big)).amax(dim=1)
    extent = torch.clamp(hi_all - lo_all, min=1e-6)
    cell = vdiv(extent, G)
    inv_cell = 1.0 / cell

    c0 = torch.clamp(torch.floor((torch.minimum(a, b) - lo_all[:, None]) * inv_cell[:, None])
                     .to(torch.int32), 0, G - 1)
    c1 = torch.clamp(torch.floor((torch.maximum(a, b) - lo_all[:, None]) * inv_cell[:, None])
                     .to(torch.int32), 0, G - 1)

    d = torch.arange(span, dtype=torch.int32, device=dev)
    # Candidate cells [span, span, span, S] per axis.
    cx = c0[0][None, None, None, :] + d[None, None, :, None]
    cy = c0[1][None, None, None, :] + d[None, :, None, None]
    cz = c0[2][None, None, None, :] + d[:, None, None, None]
    in_win = ((cx <= c1[0][None, None, None, :]) & (cy <= c1[1][None, None, None, :])
              & (cz <= c1[2][None, None, None, :]) & seg_ok[None, None, None, :])
    n = span ** 3
    full = (span, span, span, S)
    cxyz = torch.stack([cx.expand(full).reshape(n, S), cy.expand(full).reshape(n, S),
                        cz.expand(full).reshape(n, S)], dim=0).float()  # [3, n, S]
    in_win = in_win.expand(full).reshape(n, S)

    cell3 = cell[:, None, None]
    cell_lo = lo_all[:, None, None] + cxyz * cell3
    cell_hi = cell_lo + cell3

    pa = a[:, None, :]  # [3, 1, S]
    ab = (b - a)[:, None, :]
    inv_ab = torch.where(torch.abs(ab) < 1e-12, 1e12 * torch.sign(ab + 1e-30), 1.0 / ab)
    t_lo = (cell_lo - pa) * inv_ab
    t_hi = (cell_hi - pa) * inv_ab
    t_in = torch.clamp(torch.minimum(t_lo, t_hi).amax(dim=0), 0.0, 1.0)
    t_out = torch.clamp(torch.maximum(t_lo, t_hi).amin(dim=0), 0.0, 1.0)
    valid = in_win & (t_out > t_in + 1e-7)

    q0 = pa + t_in[None] * ab  # [3, n, S]
    q1 = pa + t_out[None] * ab

    def quant(q):
        local = (q - cell_lo) / cell3
        snapped = vdiv(torch.round(local * quantization), quantization)
        return cell_lo + snapped * cell3

    q0 = quant(q0)
    q1 = quant(q1)
    # Quantization can collapse tiny clips to a point: drop those.
    dq = q1 - q0
    nonzero = (dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2]) > 1e-16
    valid = valid & nonzero

    att0 = a0[None, :] + t_in * (a1 - a0)[None, :]
    att1 = a0[None, :] + t_out * (a1 - a0)[None, :]
    return (q0.reshape(3, n * S), q1.reshape(3, n * S), att0.reshape(-1), att1.reshape(-1),
            valid.reshape(-1))


def vrc_window(positions: np.ndarray, mask: np.ndarray, grid_resolution: int):
    """(grid resolution, span) of the static cell window: every segment's
    full extent is covered; long-segment scenes lower the resolution to
    bound the span^3 pair expansion (the JAX renderer's host rule)."""
    pos = np.asarray(positions)
    m2 = mask[:, :-1] & mask[:, 1:]
    seg_ext = np.abs(pos[:, 1:] - pos[:, :-1])[m2]
    lo = pos[mask].min(axis=0)
    hi = pos[mask].max(axis=0)
    extent = float(np.maximum(hi - lo, 1e-6).max())
    res = grid_resolution
    max_seg = float(seg_ext.max()) if seg_ext.size else 0.0
    span = int(np.ceil(max_seg / (extent / res))) + 2
    while span > 8 and res > 8:
        res //= 2
        span = int(np.ceil(max_seg / (extent / res))) + 2
    return res, span


class VoxelRayCastingRenderer:
    """Registry renderer for RENDERING_MODE_VOXEL_RAY_CASTING drawing on
    `device`; the settings, transfer function and raster settings are those
    of the base `LineRenderer` it contains (as in the JAX renderer)."""

    name = "Voxel Ray Casting"

    def __init__(self, settings=None, device="cuda"):
        from linevis_tpu_torch.render.renderer import LineRenderer

        self._base = LineRenderer(settings, device=device)
        self.device = self._base.device
        self.grid_resolution = 128
        self.quantization = 8
        if settings is not None and settings.has_key("grid_resolution"):
            self.grid_resolution = settings.get_int("grid_resolution")
        self._scene: Optional[CapsuleScene] = None

    @property
    def line_data(self):
        return self._base.line_data

    def set_line_data(self, line_data) -> None:
        self._base.set_line_data(line_data)
        self._scene = None

    def set_transfer_function(self, tf) -> None:
        self._base.set_transfer_function(tf)

    def set_new_settings(self, settings) -> None:
        self._base.set_new_settings(settings)
        if settings.has_key("grid_resolution"):
            self.grid_resolution = settings.get_int("grid_resolution")
            self._scene = None

    def quantized_scene(self) -> CapsuleScene:
        """The discretized capsules on the renderer's device (built once a
        scene)."""
        if self._scene is None:
            ld = self._base.line_data
            traj = ld.trajectories
            mask = ld.get_filtered_point_mask()
            res, span = vrc_window(traj.positions, mask, self.grid_resolution)
            dev = self.device
            q0, q1, a0, a1, valid = discretize_curves(
                torch.as_tensor(traj.positions, device=dev), torch.as_tensor(mask, device=dev),
                torch.as_tensor(ld.selected_attributes(), device=dev), grid_resolution=res,
                quantization=self.quantization, span=span)
            self._scene = CapsuleScene(a=q0, ba=q1 - q0, attr0=a0, dattr=a1 - a0, mask=valid,
                                       cap_a=torch.ones_like(a0), radius=ld.line_width / 2.0)
        return self._scene

    def render(self, camera) -> np.ndarray:
        from linevis_tpu_torch.render.tube_raster import render_tubes_image

        return render_tubes_image(self.quantized_scene(), camera,
                                  settings=self._base._raster_settings(camera))
