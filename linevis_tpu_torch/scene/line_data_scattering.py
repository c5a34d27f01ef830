"""`LineDataScattering`: scattered light paths and their line density field.

Counterpart of `linevis_tpu/scene/line_data_scattering.py` (reference
`src/LineData/Scattering/LineDataScattering.{hpp:61,cpp}`): it holds the
trajectories the scattering tracer produced, the cloud density grid they
were traced through, the rays' exit directions (for the spherical heat map)
and builds the line density field that the Line Density Map renderer draws.

The field is splatted with a scatter-add (`index_put_(accumulate=True)`)
over fixed sub-samples of every segment (weight = segment length / n_sub,
the reference's `useLineSegmentLengthForDensityField` mode), then min-max
normalised, on the device the caller names. A scatter-add sums each voxel's
contributions in an order of its own (XLA's and the card's atomics differ),
so the field matches the JAX package's to the float32 rounding of those
sums: a relative ~1e-6 of the voxel, which the normalisation carries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from linevis_tpu_torch.core.trajectories import (
    RaggedTrajectories,
    Trajectories,
    pad_trajectories,
)
from linevis_tpu_torch.kernels.volume_common import vdiv
from linevis_tpu_torch.scene.line_data import LineDataFlow
from linevis_tpu_torch.trace.scattering import (
    ScatteringTracingSettings,
    grid_box,
    trace_scattering_rays,
)

__all__ = ["LineDataScattering", "build_line_density_field", "smooth_density_field"]


def build_line_density_field(
    positions: torch.Tensor,  # [L, P, 3]
    mask: torch.Tensor,  # [L, P]
    b_min,  # [3] world box of the voxel grid
    b_max,
    grid_res: Tuple[int, int, int],  # (Z, Y, X)
    n_sub: int = 8,
    use_length: bool = True,
) -> torch.Tensor:
    """Splat + min-max + normalise -> [Z, Y, X] field in [0, 1] on the
    positions' device."""
    dev = positions.device
    a = positions[:, :-1].reshape(-1, 3)
    b = positions[:, 1:].reshape(-1, 3)
    seg_ok = (mask[:, :-1] & mask[:, 1:]).reshape(-1)
    ab = b - a
    seg_len = torch.sqrt(ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1] + ab[:, 2] * ab[:, 2])
    w = torch.where(seg_ok, vdiv(seg_len if use_length else torch.ones_like(seg_len), n_sub),
                    torch.zeros_like(seg_len))
    nz, ny, nx = (int(v) for v in grid_res)
    res = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
    lo = torch.as_tensor(np.asarray(b_min, np.float32), device=dev)
    extent = torch.as_tensor(np.asarray(b_max, np.float32) - np.asarray(b_min, np.float32),
                             device=dev)
    field = torch.zeros(nz * ny * nx, dtype=torch.float32, device=dev)
    for i in range(n_sub):
        t = float(np.float32((i + 0.5) / n_sub))
        p = a + t * ab
        v = (p - lo) / extent * res
        # Samples outside the voxel grid contribute nothing (the reference's
        # DDA visits only in-grid voxels): clamped into the border voxels,
        # the long camera-to-entry segments would set the normalisation.
        inside = ((v >= 0.0) & (v < res)).all(dim=1)
        xi = torch.clamp(v[:, 0].to(torch.int32), 0, nx - 1).long()
        yi = torch.clamp(v[:, 1].to(torch.int32), 0, ny - 1).long()
        zi = torch.clamp(v[:, 2].to(torch.int32), 0, nz - 1).long()
        field.index_put_(((zi * ny + yi) * nx + xi,), torch.where(inside, w, torch.zeros_like(w)),
                         accumulate=True)
    fmin, fmax = field.min(), field.max()
    return ((field - fmin) / torch.clamp(fmax - fmin, min=1e-12)).reshape(nz, ny, nx)


def smooth_density_field(field: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Separable Gaussian smoothing (LineDensityFieldSmoothingPass) with zero
    padding, as `jax.scipy.signal.convolve(mode="same")` with the symmetric
    kernel: each axis a sum of 2 * radius + 1 shifted copies, in tap order
    (the JAX convolution sums in an order of its own: float32 rounding)."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(radius / 2.0, 1e-6)) ** 2).astype(np.float32)
    k = k / np.sum(k)
    out = field.float()
    for axis in range(3):
        n = out.shape[axis]
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = radius
        padded = torch.nn.functional.pad(out, pad)
        acc = None
        for j, kj in enumerate(k):
            term = float(kj) * padded.narrow(axis, j, n)
            acc = term if acc is None else acc + term
        out = acc
    return out


class LineDataScattering(LineDataFlow):
    """Scattered-path line data (LineDataScattering.hpp:61)."""

    data_set_type = "scattering"

    def __init__(
        self,
        trajectories: Trajectories,
        cloud_grid: np.ndarray,  # [Z, Y, X] density the paths were traced in
        exit_directions: Optional[np.ndarray] = None,  # [N, 3]
        name: str = "",
    ):
        super().__init__(trajectories, name=name)
        self.cloud_grid = np.asarray(cloud_grid, np.float32)
        self.exit_directions = (
            None if exit_directions is None else np.asarray(exit_directions, np.float32))
        b_min, b_max = grid_box(self.cloud_grid.shape)
        self.grid_b_min = b_min
        self.grid_b_max = b_max

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return tuple(self.cloud_grid.shape)

    @classmethod
    def trace(
        cls,
        cloud_grid: np.ndarray,
        settings: Optional[ScatteringTracingSettings] = None,
        name: str = "scattering",
        device="cuda",
    ) -> "LineDataScattering":
        """Run the scattering tracer on `device` (the
        ScatteringLineTracingRequester role)."""
        settings = settings or ScatteringTracingSettings()
        pos, mask, exit_dirs, _ = trace_scattering_rays(cloud_grid, settings, device=device)
        lines = [pos[i][mask[i]] for i in range(pos.shape[0])]
        lines = [np.asarray(ln, np.float32) for ln in lines if len(ln) >= 2]
        ragged = RaggedTrajectories(
            positions=lines,
            attributes=[np.ones((1, len(ln)), np.float32) for ln in lines],
            attribute_names=["Attribute #1"],
        )
        return cls(pad_trajectories(ragged), cloud_grid, exit_directions=exit_dirs, name=name)

    def get_line_density_field(self, n_sub: int = 8, device="cuda") -> torch.Tensor:
        """[Z, Y, X] normalised density field on `device` (cached per
        device, invalidated with the other representations)."""
        return self._cached(("density_field", n_sub, str(device)), lambda: build_line_density_field(
            torch.as_tensor(self.trajectories.positions, device=device),
            torch.as_tensor(self.get_filtered_point_mask(), device=device),
            self.grid_b_min, self.grid_b_max, self.grid_size, n_sub=n_sub))

    def get_cloud_grid(self, device="cuda") -> torch.Tensor:
        """The cloud density grid [Z, Y, X] on `device` (cached per device)."""
        return self._cached(("cloud", str(device)),
                            lambda: torch.as_tensor(self.cloud_grid, device=device))
