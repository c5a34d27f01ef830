"""Block-sparse density grids: the NanoVDB role for the path tracer's clouds.

Counterpart of `linevis_tpu/scene/sparse_grid.py` (the reference vendors
NanoVDB, `src/Renderers/Scattering/nanovdb/*`): memory proportional to the
occupied space and the same trilinear samples as the dense grid.

* the volume is tiled into `block`^3 bricks; empty bricks (all zero) store
  nothing,
* active bricks are packed into one dense [n_active, b+1, b+1, b+1] tensor
  with a +1 apron on the high side, so any trilinear stencil that starts in
  a brick lies in it: one gather a sample,
* a dense [Zb, Yb, Xb] int32 table maps brick coordinates to the packed
  index, index 0 being the shared all-zero brick (NanoVDB's background).

The build runs in numpy on the host; `sample` runs on the bricks' device
and equals `kernels/volume_common.trilinear` on the dense grid bit for bit
wherever both are defined.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SparseGrid"]


@dataclasses.dataclass(frozen=True)
class SparseGrid:
    """Block-sparse [Z, Y, X] scalar grid (see module docstring)."""

    bricks: torch.Tensor  # [n_active + 1, b+1, b+1, b+1]; bricks[0] == 0
    table: torch.Tensor  # [Zb, Yb, Xb] int32 -> brick index
    shape: tuple
    block: int

    @classmethod
    def from_dense(cls, grid, block: int = 8, device="cuda") -> "SparseGrid":
        g = np.asarray(grid, np.float32)
        sz, sy, sx = g.shape
        b = int(block)
        nz, ny, nx = (-(-sz // b), -(-sy // b), -(-sx // b))
        # Pad to brick multiples + 1 apron voxel (edge values, matching the
        # dense sampler's boundary clamp).
        gp = np.pad(
            g, ((0, nz * b - sz + 1), (0, ny * b - sy + 1), (0, nx * b - sx + 1)), mode="edge")
        table = np.zeros((nz, ny, nx), np.int32)
        bricks = [np.zeros((b + 1, b + 1, b + 1), np.float32)]
        for bz in range(nz):
            for by in range(ny):
                for bx in range(nx):
                    br = gp[bz * b:bz * b + b + 1, by * b:by * b + b + 1, bx * b:bx * b + b + 1]
                    if np.any(br != 0.0):
                        table[bz, by, bx] = len(bricks)
                        bricks.append(br)
        return cls(bricks=torch.as_tensor(np.stack(bricks), device=device),
                   table=torch.as_tensor(table, device=device), shape=(sz, sy, sx), block=b)

    @property
    def n_active(self) -> int:
        return int(self.bricks.shape[0]) - 1

    def memory_ratio(self) -> float:
        """Sparse voxel count / dense voxel count."""
        dense = float(np.prod(self.shape))
        b1 = self.block + 1
        return self.bricks.shape[0] * (b1 ** 3) / dense

    def sample(self, p) -> torch.Tensor:
        """Trilinear sample at p in [0, 1]^3: a [..., 3] tensor or an
        (x, y, z) tuple of tensors, as `sample_grid_trilinear` on the dense
        grid."""
        px, py, pz = p if isinstance(p, tuple) else p.unbind(-1)
        sz, sy, sx = self.shape
        b = self.block
        fx = torch.clamp(px, 0.0, 1.0) * (sx - 1)
        fy = torch.clamp(py, 0.0, 1.0) * (sy - 1)
        fz = torch.clamp(pz, 0.0, 1.0) * (sz - 1)
        x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, sx - 2)
        y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, sy - 2)
        z0 = torch.clamp(torch.floor(fz).to(torch.int32), 0, sz - 2)
        tx, ty, tz = fx - x0, fy - y0, fz - z0
        bi = self.table[(z0 // b).long(), (y0 // b).long(), (x0 // b).long()].long()
        lz, ly, lx = (z0 % b).long(), (y0 % b).long(), (x0 % b).long()

        def g(dz, dy, dx):
            return self.bricks[bi, lz + dz, ly + dy, lx + dx]

        c00 = g(0, 0, 0) * (1 - tx) + g(0, 0, 1) * tx
        c01 = g(0, 1, 0) * (1 - tx) + g(0, 1, 1) * tx
        c10 = g(1, 0, 0) * (1 - tx) + g(1, 0, 1) * tx
        c11 = g(1, 1, 0) * (1 - tx) + g(1, 1, 1) * tx
        c0 = c00 * (1 - ty) + c01 * ty
        c1 = c10 * (1 - ty) + c11 * ty
        return c0 * (1 - tz) + c1 * tz
