"""Principal stress line (PSL) `.dat` loaders, in numpy.

Counterpart of `linevis_tpu/loaders/stress_dat.py`. Reference:
`src/Loaders/StressTrajectoriesDatLoader.cpp:108-235` (v1) and
`loadStressLineHierarchyFromDat` (`:77-106`). The v1 ASCII format, per
principal-stress block:

  [psName] numLines            # psName optional; major|medium|minor
  per line:
    numPoints
    3*numPoints floats         # positions
    12*numPoints floats        # (sigma, dir.xyz) × major/medium/minor
    numPoints floats           # von Mises stress

Attributes emitted per line (reference `:165-199`): attr0 = von Mises,
attr1 = |sigma_psIdx| of the block's own principal direction.
Hierarchy `.dat`: per PS block `numLines` then one level per line.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from linevis_tpu_torch.core.trajectories import RaggedTrajectories


@dataclasses.dataclass
class RaggedStressTrajectories:
    """One principal-stress direction's ragged line set + per-point PS data."""

    trajectories: RaggedTrajectories
    ps_index: int  # 0=major, 1=medium, 2=minor
    # per line: [P] sigma and [P, 3] direction for each of the 3 PS
    major_ps: List[np.ndarray] = dataclasses.field(default_factory=list)
    medium_ps: List[np.ndarray] = dataclasses.field(default_factory=list)
    minor_ps: List[np.ndarray] = dataclasses.field(default_factory=list)
    major_ps_dir: List[np.ndarray] = dataclasses.field(default_factory=list)
    medium_ps_dir: List[np.ndarray] = dataclasses.field(default_factory=list)
    minor_ps_dir: List[np.ndarray] = dataclasses.field(default_factory=list)
    hierarchy_levels: List[List[float]] = dataclasses.field(default_factory=list)
    # v2/v3 band strands: per line [P, 3] points of the left/right band edge
    # (v3 additionally carries the unsmoothed variants).
    band_points_left: List[np.ndarray] = dataclasses.field(default_factory=list)
    band_points_right: List[np.ndarray] = dataclasses.field(default_factory=list)
    band_points_left_unsmoothed: List[np.ndarray] = dataclasses.field(
        default_factory=list
    )
    band_points_right_unsmoothed: List[np.ndarray] = dataclasses.field(
        default_factory=list
    )
    # v3 per-line extras (StressTrajectoryData fields)
    appearance_orders: List[int] = dataclasses.field(default_factory=list)
    seed_positions: List[np.ndarray] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SimulationMeshHull:
    """Simulation hull outline mesh (v3 `#Outline` block)."""

    vertices: np.ndarray  # [V, 3] float32
    triangles: np.ndarray  # [F, 3] int32
    mesh_type: str = "cartesian"  # 'cartesian' | 'unstructured'


class _TokenReader:
    """Line-oriented whitespace-token reader (mirrors sgl::LineReader)."""

    def __init__(self, filename: str):
        with open(filename, "r") as f:
            self.lines = [ln.split() for ln in f if ln.strip()]
        self.idx = 0

    def is_line_left(self) -> bool:
        return self.idx < len(self.lines)

    def vector_line(self) -> List[str]:
        toks = self.lines[self.idx]
        self.idx += 1
        return toks

    def floats_line(self, expected: int) -> np.ndarray:
        """Read tokens across lines until `expected` floats are collected."""
        out: List[str] = []
        while len(out) < expected:
            out.extend(self.lines[self.idx])
            self.idx += 1
        return np.array(out[:expected], np.float32)

    def scalar_line(self) -> str:
        toks = self.vector_line()
        return toks[0]


_PS_NAMES = {"major": 0, "medium": 1, "minor": 2}


def load_stress_trajectories_from_dat_v1(
    filenames_trajectories: Sequence[str],
    filenames_hierarchy: Sequence[str] = (),
) -> Tuple[List[int], List[RaggedStressTrajectories]]:
    """Returns (loaded_ps_indices, per-PS ragged stress trajectories)."""
    result: List[RaggedStressTrajectories] = []
    loaded_ps_indices: List[int] = []
    ps_idx = 0
    for filename in filenames_trajectories:
        reader = _TokenReader(filename)
        while reader.is_line_left():
            info = reader.vector_line()
            if len(info) == 1:
                num_lines = int(info[0])
            elif len(info) == 2:
                num_lines = int(info[1])
                name = info[0].lower()
                for key, val in _PS_NAMES.items():
                    if name.endswith(key):
                        loaded_ps_indices.append(val)
                        break
                else:
                    raise ValueError(f"Invalid PS identifier {info[0]!r}")
            else:
                raise ValueError(f"Invalid line metadata in {filename}")
            block = RaggedStressTrajectories(
                trajectories=RaggedTrajectories(
                    [], [], ["von Mises Stress", "Principal Stress Magnitude"]
                ),
                ps_index=ps_idx,
            )
            for _ in range(num_lines):
                n = int(reader.scalar_line())
                pos = reader.floats_line(n * 3).reshape(n, 3)
                ps = reader.floats_line(n * 12).reshape(n, 12)
                von_mises = reader.floats_line(n)
                block.trajectories.positions.append(pos)
                block.major_ps.append(ps[:, 0])
                block.major_ps_dir.append(ps[:, 1:4])
                block.medium_ps.append(ps[:, 4])
                block.medium_ps_dir.append(ps[:, 5:8])
                block.minor_ps.append(ps[:, 8])
                block.minor_ps_dir.append(ps[:, 9:12])
                own = [block.major_ps, block.medium_ps, block.minor_ps][ps_idx][-1]
                block.trajectories.attributes.append(
                    np.stack([von_mises, np.abs(own)]).astype(np.float32)
                )
            result.append(block)
            ps_idx += 1

    if filenames_hierarchy:
        _load_hierarchy(filenames_hierarchy, result)
    if not loaded_ps_indices and len(result) == 3:
        loaded_ps_indices = [0, 1, 2]
    for i, block in enumerate(result):
        if i < len(loaded_ps_indices):
            block.ps_index = loaded_ps_indices[i]
    return loaded_ps_indices, result


_V3_ATTRIBUTE_NAMES = [
    "Principal Stress",
    "Principal Stress Magnitude",
    "von Mises Stress",
    "Normal Stress (xx)",
    "Normal Stress (yy)",
    "Normal Stress (zz)",
    "Shear Stress (yz)",
    "Shear Stress (zx)",
    "Shear Stress (xy)",
    # Derived by eigendecomposition (reference USE_EIGEN path,
    # StressTrajectoriesDatLoader.cpp:42-70, LineDataStress.cpp:435-438):
    "Major Stress",
    "Medium Stress",
    "Minor Stress",
    "Degeneracy Measure",
]


def _principal_stress_attrs(attrs9: np.ndarray) -> np.ndarray:
    """[9, P] measured attrs -> [4, P] (major, medium, minor, degeneracy).

    Mirrors the reference's Eigen path: eigenvalues of the symmetric stress
    tensor assembled from rows (xx 3, yy 4, zz 5, yz 6, zx 7, xy 8) and the
    degeneracy measure max(1-|s1-s2|/|s1+s2|, 1-|s3-s2|/|s3+s2|)
    (StressTrajectoriesDatLoader.cpp:64-69).
    """
    xx, yy, zz, yz, zx, xy = (attrs9[i] for i in (3, 4, 5, 6, 7, 8))
    P = xx.shape[0]
    T = np.zeros((P, 3, 3), np.float32)
    T[:, 0, 0], T[:, 1, 1], T[:, 2, 2] = xx, yy, zz
    T[:, 0, 1] = T[:, 1, 0] = xy
    T[:, 1, 2] = T[:, 2, 1] = yz
    T[:, 0, 2] = T[:, 2, 0] = zx
    ev = np.linalg.eigvalsh(T)  # ascending
    minor, medium, major = ev[:, 0], ev[:, 1], ev[:, 2]

    def safe_ratio(a, b):
        d = a + b
        d = np.where(np.abs(d) < 1e-12, 1e-12, d)
        return np.abs((a - b) / d)

    degeneracy = np.maximum(
        1.0 - safe_ratio(major, medium), 1.0 - safe_ratio(minor, medium)
    )
    return np.stack([major, medium, minor, degeneracy]).astype(np.float32)


def load_stress_trajectories_from_dat_v2(
    filenames_trajectories: Sequence[str],
) -> Tuple[List[int], List[RaggedStressTrajectories]]:
    """v2 PSL format with band strands + one precomputed scalar field.

    Per line: `numPoints hierarchyLevel`, 3N positions, 6N band points
    (left xyz, right xyz interleaved per point), N scalars
    (StressTrajectoriesDatLoader.cpp:236-355).
    """
    result: List[RaggedStressTrajectories] = []
    loaded_ps_indices: List[int] = []
    ps_idx = 0
    for filename in filenames_trajectories:
        reader = _TokenReader(filename)
        while reader.is_line_left():
            info = reader.vector_line()
            num_lines = _parse_block_header(info, loaded_ps_indices, filename)
            block = RaggedStressTrajectories(
                trajectories=RaggedTrajectories([], [], ["Principal Stress"]),
                ps_index=ps_idx,
            )
            for _ in range(num_lines):
                meta = reader.vector_line()
                if len(meta) != 2:
                    raise ValueError(f"Invalid per-line metadata in {filename}")
                n = int(meta[0])
                block.hierarchy_levels.append([float(meta[1])])
                pos = reader.floats_line(n * 3).reshape(n, 3)
                band = reader.floats_line(n * 6).reshape(n, 6)
                scalar = reader.floats_line(n)
                block.trajectories.positions.append(pos)
                block.band_points_left.append(band[:, 0:3].copy())
                block.band_points_right.append(band[:, 3:6].copy())
                block.trajectories.attributes.append(
                    scalar[None].astype(np.float32)
                )
            result.append(block)
            ps_idx += 1
    _apply_ps_indices(result, loaded_ps_indices)
    return loaded_ps_indices, result


def load_stress_trajectories_from_dat_v3(
    filenames_trajectories: Sequence[str],
) -> Tuple[List[int], List[RaggedStressTrajectories], Optional[SimulationMeshHull]]:
    """v3 PSL format: bands (smoothed + unsmoothed), 9 precomputed scalar
    fields, optional `#Outline` simulation hull, per-line appearance order
    and seed point (StressTrajectoriesDatLoader.cpp:403-638). Principal
    stresses + degeneracy are derived by eigendecomposition like the
    reference's Eigen build (13 attributes total).
    """
    result: List[RaggedStressTrajectories] = []
    loaded_ps_indices: List[int] = []
    hull: Optional[SimulationMeshHull] = None
    ps_idx = 0
    for filename in filenames_trajectories:
        reader = _TokenReader(filename)
        while reader.is_line_left():
            info = reader.vector_line()
            if info[0] == "#Outline":
                mesh_type = "cartesian"
                if len(info) > 1 and info[1] != "Cartesian":
                    mesh_type = "unstructured"
                hull = _parse_outline_hull(reader, mesh_type)
                continue
            num_lines = _parse_block_header(info, loaded_ps_indices, filename)
            if num_lines == 0:
                continue
            block = RaggedStressTrajectories(
                trajectories=RaggedTrajectories(
                    [], [], list(_V3_ATTRIBUTE_NAMES)
                ),
                ps_index=ps_idx,
            )
            for _ in range(num_lines):
                meta = reader.vector_line()
                n = int(meta[0])
                # Up to 4 hierarchy levels, then appearance order + seed.
                n_hier = min(max(len(meta) - 1, 0), 4) or 0
                levels = [float(v) for v in meta[1 : 1 + max(n_hier, 0)]]
                block.hierarchy_levels.append(levels)
                if len(meta) == 9:
                    block.appearance_orders.append(int(meta[5]) - 1)
                    block.seed_positions.append(
                        np.array(meta[6:9], np.float32)
                    )
                pos = reader.floats_line(n * 3).reshape(n, 3)
                band_u = reader.floats_line(n * 6).reshape(n, 6)
                band_s = reader.floats_line(n * 6).reshape(n, 6)
                block.trajectories.positions.append(pos)
                block.band_points_left_unsmoothed.append(band_u[:, 0:3].copy())
                block.band_points_right_unsmoothed.append(band_u[:, 3:6].copy())
                block.band_points_left.append(band_s[:, 0:3].copy())
                block.band_points_right.append(band_s[:, 3:6].copy())
                ps = reader.floats_line(n)  # principal stress of this PS dir
                attrs = [ps, np.abs(ps)]
                # von Mises + 6 stress-tensor components.
                for _v in range(7):
                    attrs.append(reader.floats_line(n))
                attrs9 = np.stack(attrs).astype(np.float32)
                derived = _principal_stress_attrs(attrs9)
                block.trajectories.attributes.append(
                    np.concatenate([attrs9, derived], axis=0)
                )
            result.append(block)
            ps_idx += 1
    _apply_ps_indices(result, loaded_ps_indices)
    return loaded_ps_indices, result, hull


def _parse_block_header(
    info: List[str], loaded_ps_indices: List[int], filename: str
) -> int:
    if len(info) == 1:
        return int(info[0])
    if len(info) == 2:
        name = info[0].lower()
        for key, val in _PS_NAMES.items():
            if name.endswith(key):
                loaded_ps_indices.append(val)
                break
        else:
            raise ValueError(f"Invalid PS identifier {info[0]!r}")
        return int(info[1])
    raise ValueError(f"Invalid line metadata in {filename}")


def _apply_ps_indices(
    result: List[RaggedStressTrajectories], loaded_ps_indices: List[int]
) -> None:
    if not loaded_ps_indices and len(result) == 3:
        loaded_ps_indices.extend([0, 1, 2])
    for i, block in enumerate(result):
        if i < len(loaded_ps_indices):
            block.ps_index = loaded_ps_indices[i]


def _parse_outline_hull(
    reader: _TokenReader, mesh_type: str
) -> SimulationMeshHull:
    """`#Vertices N` + N xyz lines, `#Faces M` + M tri/quad index lines
    (quads split into two triangles; parseOutlineMeshHull,
    StressTrajectoriesDatLoader.cpp:360-401)."""
    head = reader.vector_line()
    if len(head) != 2 or head[0] != "#Vertices":
        raise ValueError("Invalid hull vertex information")
    nv = int(head[1])
    verts = np.stack(
        [reader.floats_line(3) for _ in range(nv)]
    ).astype(np.float32) if nv else np.zeros((0, 3), np.float32)
    head = reader.vector_line()
    if len(head) != 2 or head[0] != "#Faces":
        raise ValueError("Invalid hull face information")
    nf = int(head[1])
    tris: List[List[int]] = []
    for _ in range(nf):
        idx = [int(v) for v in reader.vector_line()]
        if len(idx) == 3:
            tris.append(idx)
        elif len(idx) == 4:
            tris.append([idx[0], idx[1], idx[2]])
            tris.append([idx[0], idx[2], idx[3]])
        else:
            raise ValueError("Invalid hull face indices")
    triangles = (
        np.array(tris, np.int32) if tris else np.zeros((0, 3), np.int32)
    )
    return SimulationMeshHull(
        vertices=verts, triangles=triangles, mesh_type=mesh_type
    )


def _load_hierarchy(
    filenames: Sequence[str], blocks: List[RaggedStressTrajectories]
) -> None:
    ps_idx = 0
    for filename in filenames:
        reader = _TokenReader(filename)
        while reader.is_line_left():
            info = reader.vector_line()
            num_lines = int(info[-1])
            block = blocks[ps_idx]
            for line_idx in range(num_lines):
                level = float(reader.scalar_line())
                while len(block.hierarchy_levels) <= line_idx:
                    block.hierarchy_levels.append([])
                block.hierarchy_levels[line_idx].append(level)
            ps_idx += 1


# -- writers (synthetic fixtures; the reference ships no .dat writer) --------

def write_stress_trajectories_dat_v2(
    filename: str, blocks: List[RaggedStressTrajectories]
) -> None:
    """Write v2 PSL files readable by load_stress_trajectories_from_dat_v2."""
    with open(filename, "w") as f:
        for block in blocks:
            name = _PS_NAME_BY_INDEX[block.ps_index]
            f.write(f"{name} {len(block.trajectories.positions)}\n")
            for li, pos in enumerate(block.trajectories.positions):
                n = pos.shape[0]
                level = (
                    block.hierarchy_levels[li][0]
                    if block.hierarchy_levels else 1.0
                )
                f.write(f"{n} {level}\n")
                f.write(" ".join(f"{v:.7g}" for v in pos.reshape(-1)) + "\n")
                band = np.concatenate(
                    [block.band_points_left[li], block.band_points_right[li]],
                    axis=1,
                )
                f.write(" ".join(f"{v:.7g}" for v in band.reshape(-1)) + "\n")
                f.write(
                    " ".join(
                        f"{v:.7g}"
                        for v in block.trajectories.attributes[li][0]
                    )
                    + "\n"
                )


def write_stress_trajectories_dat_v3(
    filename: str,
    blocks: List[RaggedStressTrajectories],
    hull: Optional[SimulationMeshHull] = None,
) -> None:
    """Write v3 PSL files readable by load_stress_trajectories_from_dat_v3.

    Each block's attributes must carry the 9 measured fields
    (_V3_ATTRIBUTE_NAMES[:9]); derived fields are recomputed on load.
    """
    with open(filename, "w") as f:
        if hull is not None:
            kind = "Cartesian" if hull.mesh_type == "cartesian" else "Unstructured"
            f.write(f"#Outline {kind}\n")
            f.write(f"#Vertices {hull.vertices.shape[0]}\n")
            for v in hull.vertices:
                f.write(f"{v[0]:.7g} {v[1]:.7g} {v[2]:.7g}\n")
            f.write(f"#Faces {hull.triangles.shape[0]}\n")
            for t in hull.triangles:
                f.write(f"{t[0]} {t[1]} {t[2]}\n")
        for block in blocks:
            name = _PS_NAME_BY_INDEX[block.ps_index]
            f.write(f"{name} {len(block.trajectories.positions)}\n")
            for li, pos in enumerate(block.trajectories.positions):
                n = pos.shape[0]
                levels = (
                    list(block.hierarchy_levels[li])
                    if block.hierarchy_levels else [1.0]
                )
                while len(levels) < 4:
                    levels.append(levels[-1])
                meta = [str(n)] + [f"{v:.7g}" for v in levels[:4]]
                if block.appearance_orders and block.seed_positions:
                    meta.append(str(block.appearance_orders[li] + 1))
                    meta.extend(
                        f"{v:.7g}" for v in block.seed_positions[li]
                    )
                f.write(" ".join(meta) + "\n")
                f.write(" ".join(f"{v:.7g}" for v in pos.reshape(-1)) + "\n")
                left_u = (
                    block.band_points_left_unsmoothed[li]
                    if block.band_points_left_unsmoothed
                    else block.band_points_left[li]
                )
                right_u = (
                    block.band_points_right_unsmoothed[li]
                    if block.band_points_right_unsmoothed
                    else block.band_points_right[li]
                )
                band_u = np.concatenate([left_u, right_u], axis=1)
                band_s = np.concatenate(
                    [block.band_points_left[li], block.band_points_right[li]],
                    axis=1,
                )
                f.write(" ".join(f"{v:.7g}" for v in band_u.reshape(-1)) + "\n")
                f.write(" ".join(f"{v:.7g}" for v in band_s.reshape(-1)) + "\n")
                attrs = block.trajectories.attributes[li]
                # Rows: 0 = principal stress, then von Mises + 6 tensor
                # components (row 1 = |ps| is derived, not stored).
                for row in (0, 2, 3, 4, 5, 6, 7, 8):
                    f.write(
                        " ".join(f"{v:.7g}" for v in attrs[row]) + "\n"
                    )


_PS_NAME_BY_INDEX = {0: "major", 1: "medium", 2: "minor"}


def load_degenerate_points_dat(filename: str) -> np.ndarray:
    """Degenerate points `.dat`: a count line, then one `x y z` line per
    point (DegeneratePointsDatLoader.cpp loadDegeneratePointsFromDat)."""
    with open(filename) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    vals = np.asarray([float(t) for t in tokens[1 : 1 + 3 * n]], np.float32)
    return vals.reshape(n, 3)
