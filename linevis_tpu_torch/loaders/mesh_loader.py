"""Triangle surface mesh loaders (.obj / .stl), in numpy.

Counterpart of `linevis_tpu/loaders/mesh_loader.py`, equal to it bit for
bit (the same `np.add.at` order, float64 curvature accumulators). Mirrors
`src/Loaders/TriangleMesh/*` + `src/LineData/TriangleMesh/
TriangleMeshData.hpp:39`: surface meshes rendered with the same shading
stack as the lines, with a computed curvature attribute. (The reference's
Forsyth vertex-cache optimization is a rasterizer locality optimization
with no meaning here: the tile binner re-sorts primitives every frame.)
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

__all__ = ["SurfaceMesh", "load_surface_mesh", "compute_vertex_normals",
           "compute_curvature_attribute"]


@dataclasses.dataclass
class SurfaceMesh:
    vertices: np.ndarray  # [V, 3] float32
    triangles: np.ndarray  # [T, 3] int32
    normals: Optional[np.ndarray] = None  # [V, 3]
    attributes: Optional[np.ndarray] = None  # [V]


def compute_vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    out = np.zeros_like(verts)
    for c in range(3):
        np.add.at(out, tris[:, c], fn)
    norm = np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return (out / norm).astype(np.float32)


def compute_curvature_attribute(
    verts: np.ndarray, tris: np.ndarray, normals: np.ndarray
) -> np.ndarray:
    """Per-vertex curvature proxy (TriangleMeshData's curvature attribute
    role): mean angular deviation of adjacent face normals from the vertex
    normal, normalized to [0, 1]."""
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    acc = np.zeros((verts.shape[0],), np.float64)
    cnt = np.zeros((verts.shape[0],), np.float64)
    for c in range(3):
        d = 1.0 - np.sum(fn * normals[tris[:, c]], axis=1)
        np.add.at(acc, tris[:, c], d)
        np.add.at(cnt, tris[:, c], 1.0)
    curv = acc / np.maximum(cnt, 1.0)
    mx = curv.max()
    if mx > 1e-12:
        curv = curv / mx
    return curv.astype(np.float32)


def _load_obj_surface(filename: str) -> SurfaceMesh:
    verts = []
    normals = []
    faces = []
    with open(filename, "r") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(t) for t in tok[1:4]])
            elif tok[0] == "vn":
                normals.append([float(t) for t in tok[1:4]])
            elif tok[0] == "f":
                idx = [int(t.split("/")[0]) for t in tok[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    t = np.asarray(faces, np.int32)
    n = (np.asarray(normals, np.float32)
         if len(normals) == len(verts) else None)
    return SurfaceMesh(vertices=v, triangles=t, normals=n)


def _load_stl(filename: str) -> SurfaceMesh:
    with open(filename, "rb") as f:
        head = f.read(84)
    is_ascii = head[:5] == b"solid" and b"facet" in open(
        filename, "rb"
    ).read(2048)
    if is_ascii:
        pts = []
        with open(filename, "r", errors="replace") as f:
            for line in f:
                tok = line.split()
                if tok and tok[0] == "vertex":
                    pts.append([float(t) for t in tok[1:4]])
        tri_pts = np.asarray(pts, np.float32).reshape(-1, 3, 3)
    else:
        n_tri = struct.unpack("<I", head[80:84])[0]
        data = np.fromfile(filename, dtype=np.uint8, offset=84)
        rec = np.frombuffer(
            data[: n_tri * 50].tobytes(), dtype=np.dtype([
                ("n", "<3f4"), ("v", "<9f4"), ("attr", "<u2"),
            ]),
        )
        tri_pts = rec["v"].reshape(-1, 3, 3).astype(np.float32)
    # Weld duplicate vertices so smooth normals exist.
    flat = tri_pts.reshape(-1, 3)
    uniq, inv = np.unique(
        flat.round(decimals=6), axis=0, return_inverse=True
    )
    tris = inv.reshape(-1, 3).astype(np.int32)
    return SurfaceMesh(vertices=uniq.astype(np.float32), triangles=tris)


def load_surface_mesh(filename: str) -> SurfaceMesh:
    lower = filename.lower()
    if lower.endswith(".obj"):
        mesh = _load_obj_surface(filename)
    elif lower.endswith(".stl"):
        mesh = _load_stl(filename)
    else:
        raise ValueError(f"Unknown surface mesh extension: {filename}")
    if mesh.normals is None:
        mesh.normals = compute_vertex_normals(mesh.vertices, mesh.triangles)
    if mesh.attributes is None:
        mesh.attributes = compute_curvature_attribute(
            mesh.vertices, mesh.triangles, mesh.normals
        )
    return mesh
