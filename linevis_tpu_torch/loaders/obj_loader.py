""".obj line-set loader.

Counterpart of `linevis_tpu/loaders/obj_loader.py`. Format (reference
`README.md:144-153`, parser `src/Loaders/ObjLoader.cpp:37+`): `v x y z`
vertices, `vt a0 a1 ...` per-vertex attributes, `g name` group markers
(ignored), `l i1 i2 ... iN` 1-based polyline index lists, `a name0 name1
...` attribute names. Points with any coordinate magnitude > 1e10 are
dropped (invalid-point convention, `ObjLoader.cpp:142-147`).

The native parser (`native.py`) comes first. The Python fallback converts
the vertex and attribute lists to arrays only when they grew since the last
`l` line, where the JAX module converts them at every `l` line (quadratic
in the file's size); each line's output is the same.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from linevis_tpu_torch.core.trajectories import RaggedTrajectories

_MAX_VAL = 1.0e10


def load_trajectories_from_obj(filename: str) -> RaggedTrajectories:
    from linevis_tpu_torch import native

    if native.available():
        parsed = native.parse_obj(filename)
        if parsed is not None:
            positions, attributes, names = parsed
            return RaggedTrajectories(
                positions=positions, attributes=attributes, attribute_names=names
            )

    vertices: List[Tuple[float, float, float]] = []
    vertex_attrs: List[List[float]] = []
    num_attrs = 0
    attribute_names: List[str] = []
    lines_pos: List[np.ndarray] = []
    lines_att: List[np.ndarray] = []
    vert_arr = np.zeros((0, 3), np.float32)
    attr_arr = np.zeros((0, 0), np.float32)

    with open(filename, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line[0] == "#":
                continue
            parts = line.split()
            cmd = parts[0]
            if cmd == "v":
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif cmd == "vt":
                a = [float(x) for x in parts[1:]]
                num_attrs = len(a)
                vertex_attrs.append(a)
            elif cmd == "a":
                if not attribute_names:
                    attribute_names = parts[1:]
            elif cmd == "l":
                idx = np.array([int(x) - 1 for x in parts[1:]], np.int64)
                if len(vert_arr) != len(vertices):
                    vert_arr = np.asarray(vertices, np.float32)
                pos = vert_arr[idx]
                keep = np.all(np.abs(pos) <= _MAX_VAL, axis=1)
                pos = pos[keep]
                if num_attrs:
                    if len(attr_arr) != len(vertex_attrs):
                        attr_arr = np.asarray(vertex_attrs, np.float32)
                    att = attr_arr[idx][keep].T
                else:
                    att = np.zeros((0, pos.shape[0]), np.float32)
                lines_pos.append(pos)
                lines_att.append(att)
            # 'g', 'vn', others: ignored (matches reference behavior)

    return RaggedTrajectories(
        positions=lines_pos, attributes=lines_att, attribute_names=attribute_names
    )
