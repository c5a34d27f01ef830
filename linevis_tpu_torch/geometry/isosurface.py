"""Isosurface extraction from scalar grids (marching tetrahedra).

Counterpart of `linevis_tpu/geometry/isosurface.py`, in numpy on the host
(its output is a host mesh, as the port's other loaders give). It fills the
role of the reference's `submodules/IsosurfaceCpp` (marching
cubes / snap-MC), which the reference uses for grid hull outlines and
density isosurfaces (linked at CMakeLists.txt:384-391; e.g. the
scattering requester's `createIsosurface`).

This implementation uses **marching tetrahedra**: each cell splits into
six tetrahedra around the 0-6 diagonal; a tetrahedron's sign pattern
needs no case table (1-inside -> one triangle, 2-inside -> two), so the
whole extraction is a handful of vectorized numpy gathers — no 256-entry
lookup, no per-cell Python loop.  Output triangles are wound so normals
point toward decreasing field values (outward for density blobs), and
vertices are welded for smooth normals.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from linevis_tpu_torch.loaders.mesh_loader import SurfaceMesh, compute_vertex_normals

__all__ = ["extract_isosurface"]

# Cube corner offsets (x, y, z), standard binary order.
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int64)

# Six tetrahedra around the 0-6 cube diagonal.
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int64)


def extract_isosurface(
    field: np.ndarray,  # [Z, Y, X]
    iso: float = 0.5,
    origin=(0.0, 0.0, 0.0),
    spacing: Optional[np.ndarray] = None,
) -> SurfaceMesh:
    field = np.asarray(field, np.float32)
    nz, ny, nx = field.shape
    origin = np.asarray(origin, np.float32)
    if spacing is None:
        spacing = np.ones(3, np.float32)
    spacing = np.asarray(spacing, np.float32)

    # Cell base indices [M, 3] as (x, y, z).
    gx, gy, gz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
        indexing="ij",
    )
    base = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)  # [M, 3]
    M = base.shape[0]

    # Corner positions/values per cell: [M, 8]
    cx = base[:, 0][:, None] + _CORNERS[:, 0][None]
    cy = base[:, 1][:, None] + _CORNERS[:, 1][None]
    cz = base[:, 2][:, None] + _CORNERS[:, 2][None]
    vals = field[cz, cy, cx]  # [M, 8]

    # Skip cells not crossing the isovalue.
    crossing = (vals.min(axis=1) <= iso) & (vals.max(axis=1) > iso)
    if not crossing.any():
        return SurfaceMesh(
            vertices=np.zeros((0, 3), np.float32),
            triangles=np.zeros((0, 3), np.int32),
            normals=np.zeros((0, 3), np.float32),
            attributes=np.zeros((0,), np.float32),
        )
    cx, cy, cz = cx[crossing], cy[crossing], cz[crossing]
    vals = vals[crossing]
    Mc = vals.shape[0]

    pos = np.stack([cx, cy, cz], axis=-1).astype(np.float32)  # [Mc, 8, 3]

    # Expand to tetrahedra: [Mc*6, 4]
    tv = vals[:, _TETS]  # [Mc, 6, 4]
    tp = pos[:, _TETS]  # [Mc, 6, 4, 3]
    tv = tv.reshape(-1, 4)
    tp = tp.reshape(-1, 4, 3)

    inside = tv > iso
    count = inside.sum(axis=1)
    active = (count > 0) & (count < 4)
    tv, tp, inside, count = tv[active], tp[active], inside[active], count[active]

    # Canonical order: inside corners first (stable argsort of ~inside).
    order = np.argsort(~inside, axis=1, kind="stable")
    rows = np.arange(tv.shape[0])[:, None]
    tv = tv[rows, order]
    tp = tp[rows, order]

    def edge_point(i, j):
        v1 = tv[:, i]
        v2 = tv[:, j]
        t = (iso - v1) / np.where(np.abs(v2 - v1) < 1e-12, 1e-12, v2 - v1)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return tp[:, i] + t * (tp[:, j] - tp[:, i])

    tris = []
    one = count == 1
    three = count == 3
    two = count == 2
    # count==1: inside corner 0; crossing edges (0,1), (0,2), (0,3).
    if one.any():
        a = edge_point(0, 1)[one]
        b = edge_point(0, 2)[one]
        c = edge_point(0, 3)[one]
        tris.append(np.stack([a, b, c], axis=1))
    # count==3: outside corner 3; crossing edges (0,3), (1,3), (2,3).
    if three.any():
        a = edge_point(0, 3)[three]
        b = edge_point(1, 3)[three]
        c = edge_point(2, 3)[three]
        tris.append(np.stack([a, b, c], axis=1))
    # count==2: inside (0,1), outside (2,3); edges 02, 03, 12, 13 -> quad.
    if two.any():
        e02 = edge_point(0, 2)[two]
        e03 = edge_point(0, 3)[two]
        e12 = edge_point(1, 2)[two]
        e13 = edge_point(1, 3)[two]
        tris.append(np.stack([e02, e03, e12], axis=1))
        tris.append(np.stack([e12, e03, e13], axis=1))

    tri_pts = np.concatenate(tris, axis=0)  # [T, 3, 3] in grid coords

    # Orient: normals point toward decreasing field (outward).
    cen = tri_pts.mean(axis=1)
    ci = np.clip(np.round(cen).astype(np.int64), 0,
                 [nx - 1, ny - 1, nz - 1])

    def grad_axis(axis, n):
        lo = np.clip(ci[:, axis] - 1, 0, n - 1)
        hi = np.clip(ci[:, axis] + 1, 0, n - 1)
        idx_lo = [ci[:, 2], ci[:, 1], ci[:, 0]]
        idx_hi = [ci[:, 2], ci[:, 1], ci[:, 0]]
        idx_lo[2 - axis] = lo
        idx_hi[2 - axis] = hi
        return field[tuple(idx_hi)] - field[tuple(idx_lo)]

    grad = np.stack([grad_axis(0, nx), grad_axis(1, ny), grad_axis(2, nz)],
                    axis=1)
    fn = np.cross(tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0])
    flip = np.sum(fn * grad, axis=1) > 0.0
    tri_pts[flip] = tri_pts[flip][:, ::-1]

    # World transform + weld.
    tri_pts = origin[None, None] + tri_pts * spacing[None, None]
    flat = tri_pts.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(decimals=6), axis=0, return_inverse=True)
    triangles = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate triangles produced by snapped edge points.
    ok = (
        (triangles[:, 0] != triangles[:, 1])
        & (triangles[:, 1] != triangles[:, 2])
        & (triangles[:, 0] != triangles[:, 2])
    )
    triangles = triangles[ok]
    verts = uniq.astype(np.float32)
    normals = compute_vertex_normals(verts, triangles)
    return SurfaceMesh(
        vertices=verts,
        triangles=triangles,
        normals=normals,
        attributes=np.full((verts.shape[0],), 0.5, np.float32),
    )
