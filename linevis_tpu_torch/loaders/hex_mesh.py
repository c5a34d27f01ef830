"""Hexahedral simulation-mesh loader + boundary surface extraction, in numpy.

Counterpart of `linevis_tpu/loaders/hex_mesh.py`; port of
`src/LineData/Mesh/{VtkLoader,HexahedralMeshLoader,MeshBoundarySurface}`:
loads the stress simulation's hex mesh (VTK legacy UNSTRUCTURED_GRID with
CELLS/CELL_TYPES, type 12 = hexahedron) and extracts the boundary surface
(faces referenced by exactly one cell) as renderable hull triangles.
"""

from __future__ import annotations

import numpy as np

from linevis_tpu_torch.loaders.mesh_loader import SurfaceMesh, compute_vertex_normals

__all__ = ["load_hex_mesh_vtk", "extract_boundary_surface",
           "load_hull_from_hex_mesh"]

# VTK hexahedron corner order -> 6 quad faces (outward winding).
_HEX_FACES = np.array([
    [0, 3, 2, 1],  # -z
    [4, 5, 6, 7],  # +z
    [0, 1, 5, 4],  # -y
    [2, 3, 7, 6],  # +y
    [1, 2, 6, 5],  # +x
    [0, 4, 7, 3],  # -x
], np.int64)


def load_hex_mesh_vtk(filename: str):
    """-> (points [V, 3] float32, hexes [H, 8] int64).

    ASCII VTK legacy UNSTRUCTURED_GRID (VtkLoader.cpp:210-230 grammar);
    non-hex cells are skipped.
    """
    points = None
    cells = []
    cell_types = []
    with open(filename, "r") as f:
        lines = f.read().split("\n")
    i = 0
    while i < len(lines):
        tok = lines[i].split()
        i += 1
        if not tok:
            continue
        key = tok[0].upper()
        if key == "POINTS":
            count = int(tok[1])
            vals = []
            while len(vals) < count * 3:
                vals.extend(float(t) for t in lines[i].split())
                i += 1
            points = np.asarray(vals, np.float32).reshape(count, 3)
        elif key == "CELLS":
            n_cells = int(tok[1])
            total = int(tok[2])
            vals = []
            while len(vals) < total:
                vals.extend(int(t) for t in lines[i].split())
                i += 1
            j = 0
            for _ in range(n_cells):
                n = vals[j]
                cells.append(vals[j + 1 : j + 1 + n])
                j += n + 1
        elif key == "CELL_TYPES":
            n_cells = int(tok[1])
            vals = []
            while len(vals) < n_cells:
                vals.extend(int(t) for t in lines[i].split())
                i += 1
            cell_types = vals
    if points is None:
        raise ValueError(f"{filename}: no POINTS found")
    hexes = [
        c for c, t in zip(cells, cell_types or [12] * len(cells))
        if t == 12 and len(c) == 8
    ]
    return points, np.asarray(hexes, np.int64)


def extract_boundary_surface(
    points: np.ndarray, hexes: np.ndarray
) -> SurfaceMesh:
    """Boundary = faces used by exactly one hexahedron
    (MeshBoundarySurface role); quads are split into two triangles."""
    faces = hexes[:, _HEX_FACES]  # [H, 6, 4]
    faces = faces.reshape(-1, 4)
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    boundary = faces[counts[inv] == 1]
    tris = np.concatenate(
        [boundary[:, [0, 1, 2]], boundary[:, [0, 2, 3]]], axis=0
    )
    # Compact vertices to those referenced.
    used, new_idx = np.unique(tris.reshape(-1), return_inverse=True)
    verts = points[used].astype(np.float32)
    triangles = new_idx.reshape(-1, 3).astype(np.int32)
    return SurfaceMesh(
        vertices=verts,
        triangles=triangles,
        normals=compute_vertex_normals(verts, triangles),
        attributes=np.full((verts.shape[0],), 0.5, np.float32),
    )


def load_hull_from_hex_mesh(filename: str) -> SurfaceMesh:
    points, hexes = load_hex_mesh_vtk(filename)
    return extract_boundary_surface(points, hexes)
