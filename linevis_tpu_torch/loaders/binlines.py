""".binlines binary loader/writer (format versions 1 and 2), in numpy.

Counterpart of `linevis_tpu/loaders/binlines.py`.

Reference: `src/Loaders/BinLinesLoader.cpp:44-160`. Layout (little-endian):
  u32 version (1|2)
  u32 numTrajectories, u32 numAttributes
  per trajectory: u32 numPoints; float3[numPoints]; numAttributes ×
  float[numPoints]
  v2 appends: u32 verticesNormalized; u32 hasAttributeNames
  (+ per-attribute sgl string = u32 length + bytes); u32 hasRibbonData
  (+ float3[numPoints] per trajectory); u32×3 mesh-outline counts (+ data).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np

from linevis_tpu_torch.core.trajectories import RaggedTrajectories


@dataclasses.dataclass
class BinLinesData:
    trajectories: RaggedTrajectories
    vertices_normalized: bool = False
    ribbon_directions: Optional[List[np.ndarray]] = None
    mesh_outline_indices: Optional[np.ndarray] = None
    mesh_outline_positions: Optional[np.ndarray] = None
    mesh_outline_normals: Optional[np.ndarray] = None


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.off)
        self.off += 4
        return v

    def f32_array(self, n: int) -> np.ndarray:
        a = np.frombuffer(self.data, "<f4", count=n, offset=self.off)
        self.off += 4 * n
        return np.asarray(a, np.float32)

    def u32_array(self, n: int) -> np.ndarray:
        a = np.frombuffer(self.data, "<u4", count=n, offset=self.off)
        self.off += 4 * n
        return np.asarray(a, np.uint32)

    def string(self) -> str:
        n = self.u32()
        s = self.data[self.off : self.off + n].decode("utf-8")
        self.off += n
        return s


def load_trajectories_from_binlines(filename: str) -> BinLinesData:
    with open(filename, "rb") as f:
        r = _Reader(f.read())
    version = r.u32()
    if version not in (1, 2):
        raise ValueError(f"Invalid .binlines version {version} in {filename}")
    num_traj = r.u32()
    num_attr = r.u32()
    positions, attributes = [], []
    for _ in range(num_traj):
        n = r.u32()
        positions.append(r.f32_array(n * 3).reshape(n, 3))
        attributes.append(
            np.stack([r.f32_array(n) for _ in range(num_attr)])
            if num_attr
            else np.zeros((0, n), np.float32)
        )
    out = BinLinesData(
        trajectories=RaggedTrajectories(positions, attributes, [])
    )
    if version == 2:
        out.vertices_normalized = r.u32() != 0
        if r.u32() != 0:  # hasAttributeNames
            out.trajectories.attribute_names = [r.string() for _ in range(num_attr)]
        if r.u32() != 0:  # hasRibbonData
            out.ribbon_directions = [
                r.f32_array(p.shape[0] * 3).reshape(-1, 3) for p in positions
            ]
        ni, nv, nn = r.u32(), r.u32(), r.u32()
        if ni:
            out.mesh_outline_indices = r.u32_array(ni)
        if nv:
            out.mesh_outline_positions = r.f32_array(nv * 3).reshape(nv, 3)
        if nn:
            out.mesh_outline_normals = r.f32_array(nn * 3).reshape(nn, 3)
    return out


def save_trajectories_as_binlines(filename: str, data: BinLinesData) -> None:
    """Writer mirroring `saveTrajectoriesAsBinLines` (`BinLinesLoader.cpp:160+`)."""
    traj = data.trajectories
    num_attr = traj.num_attributes
    with open(filename, "wb") as f:
        f.write(struct.pack("<III", 2, traj.num_lines, num_attr))
        for i in range(traj.num_lines):
            pos = np.asarray(traj.positions[i], np.float32)
            f.write(struct.pack("<I", pos.shape[0]))
            f.write(pos.astype("<f4").tobytes())
            for a in range(num_attr):
                f.write(np.asarray(traj.attributes[i][a], "<f4").tobytes())
        f.write(struct.pack("<I", 1 if data.vertices_normalized else 0))
        names = traj.attribute_names
        f.write(struct.pack("<I", 1 if names else 0))
        if names:
            for name in names:
                b = name.encode("utf-8")
                f.write(struct.pack("<I", len(b)) + b)
        f.write(struct.pack("<I", 1 if data.ribbon_directions else 0))
        if data.ribbon_directions:
            for rd in data.ribbon_directions:
                f.write(np.asarray(rd, "<f4").tobytes())
        idx = data.mesh_outline_indices
        vtx = data.mesh_outline_positions
        nrm = data.mesh_outline_normals
        f.write(
            struct.pack(
                "<III",
                0 if idx is None else len(idx),
                0 if vtx is None else len(vtx),
                0 if nrm is None else len(nrm),
            )
        )
        if idx is not None:
            f.write(np.asarray(idx, "<u4").tobytes())
        if vtx is not None:
            f.write(np.asarray(vtx, "<f4").tobytes())
        if nrm is not None:
            f.write(np.asarray(nrm, "<f4").tobytes())
