"""4x4 transform helpers + transform-string parser.

Counterpart of `linevis_tpu/core/transforms.py` (a copy: numpy only).

The reference uses glm + sgl's `parseTransformString` (used from
`src/Loaders/DataSetList.cpp:116-120`; the canonical example is the stress
default `rotate(270°, 1, 0, 0)`). We support chains of
`rotate(angle[°], x, y, z)`, `scale(sx[, sy, sz])`, `translate(x, y, z)`
applied left-to-right (matrix product in written order, glm convention).
Matrices are column-vector convention: `p' = M @ p`.
"""

from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np

__all__ = [
    "parse_transform_string",
    "rotation_matrix",
    "scale_matrix",
    "translation_matrix",
    "apply_transform",
]


def rotation_matrix(angle_rad: float, axis: Sequence[float]) -> np.ndarray:
    """Rotation about `axis` by `angle_rad` (glm::rotate semantics)."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    C = 1.0 - c
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ]
    return m.astype(np.float32)


def scale_matrix(sx: float, sy: float = None, sz: float = None) -> np.ndarray:
    if sy is None:
        sy = sz = sx
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def translation_matrix(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


_CALL_RE = re.compile(r"(\w+)\s*\(([^)]*)\)")


def parse_transform_string(s: str) -> np.ndarray:
    """Parse e.g. `rotate(270°, 1, 0, 0) scale(2)` into a 4x4 matrix."""
    m = np.eye(4, dtype=np.float32)
    for name, args_str in _CALL_RE.findall(s):
        raw_args = [a.strip() for a in args_str.split(",") if a.strip()]
        name = name.lower()
        if name == "rotate":
            ang_str = raw_args[0]
            if "°" in ang_str or "deg" in ang_str:
                ang = math.radians(float(re.sub(r"[^0-9eE+.\-]", "", ang_str)))
            else:
                ang = float(ang_str)
            axis = [float(a) for a in raw_args[1:4]]
            m = m @ rotation_matrix(ang, axis)
        elif name == "scale":
            vals = [float(a) for a in raw_args]
            m = m @ scale_matrix(*vals)
        elif name == "translate":
            vals = [float(a) for a in raw_args]
            m = m @ translation_matrix(*vals)
        else:
            raise ValueError(f"Unknown transform command {name!r} in {s!r}")
    return m


def apply_transform(
    matrix: np.ndarray, points: np.ndarray, is_direction: bool = False
) -> np.ndarray:
    """Apply a 4x4 matrix to [..., 3] points (w=1, no perspective divide).

    is_direction=True applies only the linear part (w=0), for vectors like
    band right directions.
    """
    r = points @ matrix[:3, :3].T
    if not is_direction:
        r = r + matrix[:3, 3]
    return r.astype(points.dtype)
