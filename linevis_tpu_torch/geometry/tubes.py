"""Tube triangle meshing on grid-shaped tensors.

Counterpart of `linevis_tpu/geometry/tubes.py` (behavioural reference:
`createTriangleTubesRenderDataCPU`, `src/Renderers/Tubes/Tubes.hpp:40-150`):
a circle of `num_subdivisions` vertices is extruded along each polyline by
its parallel-transport frames, and consecutive rings are joined by two
triangles per subdivision.

Every per-vertex tensor is grid-shaped [3, S, L, P] (component, ring
subdivision, line, point), so the render pipeline takes triangle corners
by slicing and a roll. Triangle order is (s, a, l, p).

Flat vertex index: v(s, l, p) = s*L*P + l*P + p.
Flat triangle index: tri(s, a, l, p) = ((s*2 + a)*L + l)*(P-1) + p.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from linevis_tpu_torch.geometry.frames import parallel_transport_frames

__all__ = [
    "TubeMesh", "tube_ring_directions", "corner_grids", "build_tube_triangle_mesh",
]


@dataclasses.dataclass
class TubeMesh:
    """Tube surface for the whole line set, grid-shaped (channels-first).

    positions: [3, S, L, P] float32 — ring vertex positions
    normals:   [3, S, L, P] float32 — outward surface normals
    tangents:  [3, S, L, P] float32 — line tangents
    attrs:     [S, L, P] float32 — selected attribute per vertex
    mask:      [L, P] bool — valid line points
    triangles: [3, T] int32 — indexed view (T = S*2*L*(P-1)), flat vertex ids
    triangle_mask: [T] bool
    """

    positions: torch.Tensor
    normals: torch.Tensor
    tangents: torch.Tensor
    attrs: torch.Tensor
    mask: torch.Tensor
    triangles: torch.Tensor
    triangle_mask: torch.Tensor
    num_subdivisions: int

    @property
    def grid_shape(self):
        return tuple(self.positions.shape[1:])  # (S, L, P)

    @property
    def num_vertices(self) -> int:
        s, l, p = self.grid_shape
        return s * l * p

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[1])

    @property
    def vertices(self) -> torch.Tensor:
        return self.positions.reshape(3, -1)


def tube_ring_directions(num_subdivisions: int) -> np.ndarray:
    """Unit circle directions [S, 2] (cos, sin): the reference's global
    circle vertices (`Tubes.hpp:159`)."""
    theta = 2.0 * np.pi * np.arange(num_subdivisions) / num_subdivisions
    return np.stack([np.cos(theta), np.sin(theta)], axis=-1).astype(np.float32)


def _tube_topology(L: int, P: int, S: int) -> np.ndarray:
    """Static triangle index lattice [3, T], T ordered (s, a, l, p).

    Quad (l, p, s): corners v(s,l,p), v(s+1,l,p), v(s,l,p+1), v(s+1,l,p+1).
    Triangle a=0: (v(s,l,p), v(s1,l,p), v(s1,l,p+1));
    triangle a=1: (v(s,l,p), v(s1,l,p+1), v(s,l,p+1)).
    """
    s = np.arange(S)[:, None, None, None]
    a = np.arange(2)[None, :, None, None]
    l = np.arange(L)[None, None, :, None]
    p = np.arange(P - 1)[None, None, None, :]
    s1 = (s + 1) % S

    def vid(ss, pp):
        return ss * (L * P) + l * P + pp

    c0 = np.broadcast_to(vid(s, p), (S, 2, L, P - 1))
    c1 = np.where(a == 0, vid(s1, p), vid(s1, p + 1))
    c2 = np.where(a == 0, vid(s1, p + 1), vid(s, p + 1))
    return np.stack([c0, c1, c2]).reshape(3, -1).astype(np.int32)


def corner_grids(grid: torch.Tensor, num_subdivisions: int):
    """The 3 triangle-corner tensors of a grid-shaped quantity.

    grid: [..., S, L, P] -> 3 tensors [..., S, 2, L, P-1] ordered like the
    flat triangle index (s, a, l, p).
    """
    r = torch.roll(grid, -1, dims=-3)  # ring s+1
    lo = grid[..., :, :, :-1]  # v(s, l, p)
    lo1 = grid[..., :, :, 1:]  # v(s, l, p+1)
    ro = r[..., :, :, :-1]  # v(s1, l, p)
    ro1 = r[..., :, :, 1:]  # v(s1, l, p+1)

    def two(x0, x1):
        return torch.stack([x0, x1], dim=-3)  # a-axis before (L, P-1)

    return two(lo, lo), two(ro, ro1), two(ro1, lo1)


def build_tube_triangle_mesh(
    positions,
    mask,
    attrs,
    radius: float = 0.0025,
    num_subdivisions: int = 8,
    ellipse_ratio: float = 1.0,
    device="cuda",
) -> TubeMesh:
    """Mesh all padded lines into one tube surface on `device`.

    positions [L, P, 3], mask [L, P], attrs [L, P] (selected attribute).
    `ellipse_ratio` scales the ring's binormal axis (elliptic tubes).
    """
    pos = torch.tensor(np.asarray(positions, np.float32), device=device)
    m = torch.tensor(np.asarray(mask, bool), device=device)
    at = torch.tensor(np.asarray(attrs, np.float32), device=device)
    L, P = int(pos.shape[0]), int(pos.shape[1])
    S = int(num_subdivisions)
    tangents, normals, binormals = parallel_transport_frames(pos, m)

    def cf(g):  # [L, P, 3] -> [3, 1, L, P]
        return g.reshape(L * P, 3).T.reshape(3, 1, L, P)

    ring = torch.tensor(tube_ring_directions(S), device=device)  # [S, 2]
    cosr = ring[:, 0].reshape(1, S, 1, 1)
    sinr = (ring[:, 1] * float(ellipse_ratio)).reshape(1, S, 1, 1)
    dir3 = cosr * cf(normals) + sinr * cf(binormals)  # [3, S, L, P]
    verts = cf(pos) + float(radius) * dir3
    vnorm = dir3 / torch.clamp(
        torch.sqrt(torch.sum(dir3 * dir3, dim=0, keepdim=True)), min=1e-8
    )
    seg_valid = m[:, :-1] & m[:, 1:]  # [L, P-1]
    return TubeMesh(
        positions=verts,
        normals=vnorm,
        tangents=cf(tangents).expand(3, S, L, P).contiguous(),
        attrs=at[None].expand(S, L, P).contiguous(),
        mask=m,
        triangles=torch.tensor(_tube_topology(L, P, S), device=device),
        triangle_mask=seg_valid[None, None].expand(S, 2, L, P - 1).reshape(-1),
        num_subdivisions=S,
    )
