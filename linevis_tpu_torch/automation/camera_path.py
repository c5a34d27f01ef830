"""Camera paths: control points, slerp playback, `.binpath` files.

Counterpart of `linevis_tpu/automation/camera_path.py`. Mirrors the role of
sgl's `CameraPath` used by the reference (`src/MainApp.cpp:2405-2424`: a
dataset's `.binpath` file is loaded if present, else a circle path around
the model AABB is generated;
`CAMERA_PATH_TIME_PERFORMANCE_MEASUREMENT` = 256 s,
`AutomaticPerformanceMeasurer.hpp:39`).

sgl is an external dependency not vendored in the reference checkout, so
the exact binary layout of its `.binpath` is not known from the reference; this
module defines a versioned little-endian layout (magic `LVBP`, uint32
version, uint32 count, then per control point: float time, vec3 position,
quaternion xyzw) with a matching writer, so paths round-trip within this
framework and external tools have a documented spec.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

import numpy as np

from linevis_tpu_torch.automation.replay import _quat_rotate, slerp

__all__ = ["ControlPoint", "CameraPath",
           "CAMERA_PATH_TIME_PERFORMANCE_MEASUREMENT",
           "CAMERA_PATH_TIME_RECORDING"]

# Reference constants (AutomaticPerformanceMeasurer.hpp:39, MainApp usage).
CAMERA_PATH_TIME_PERFORMANCE_MEASUREMENT = 256.0
CAMERA_PATH_TIME_RECORDING = 30.0

_MAGIC = b"LVBP"
_VERSION = 1


@dataclasses.dataclass
class ControlPoint:
    time: float
    position: np.ndarray  # [3]
    orientation: np.ndarray  # quaternion (x, y, z, w)


def _look_quat(position, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Quaternion rotating (0,0,-1) onto normalize(target - position)."""
    f = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    f = f / max(np.linalg.norm(f), 1e-12)
    up = np.asarray(up, np.float64)
    r = np.cross(f, up)
    nr = np.linalg.norm(r)
    if nr < 1e-9:
        r = np.array([1.0, 0.0, 0.0])
    else:
        r = r / nr
    u = np.cross(r, f)
    m = np.stack([r, u, -f], axis=1)  # columns: right, up, back
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        q = np.array([
            (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
            (m[1, 0] - m[0, 1]) * s, 0.25 / s,
        ])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        q[3] = (m[k, j] - m[j, k]) / s
    return (q / max(np.linalg.norm(q), 1e-12)).astype(np.float32)


class CameraPath:
    def __init__(self, control_points: List[ControlPoint] = None):
        self.control_points: List[ControlPoint] = control_points or []

    @property
    def total_time(self) -> float:
        return self.control_points[-1].time if self.control_points else 0.0

    # -- construction --------------------------------------------------------
    @classmethod
    def from_circle_path(
        cls,
        aabb: np.ndarray,  # [2, 3] (min, max)
        total_time: float = CAMERA_PATH_TIME_PERFORMANCE_MEASUREMENT,
        num_points: int = 64,
        height_factor: float = 0.2,
        radius_factor: float = 1.4,
    ) -> "CameraPath":
        """Circle flight around the model bounding box (sgl
        CameraPath::fromCirclePath role, used at MainApp.cpp:2417)."""
        aabb = np.asarray(aabb, np.float32)
        center = (aabb[0] + aabb[1]) * 0.5
        extent = aabb[1] - aabb[0]
        radius = float(np.linalg.norm(extent[[0, 2]])) * 0.5 * radius_factor
        radius = max(radius, 1e-3)
        height = center[1] + extent[1] * height_factor
        pts = []
        for i in range(num_points + 1):
            t = i / num_points
            ang = 2.0 * np.pi * t
            pos = np.array([
                center[0] + radius * np.sin(ang),
                height,
                center[2] + radius * np.cos(ang),
            ], np.float32)
            pts.append(ControlPoint(
                time=t * total_time, position=pos,
                orientation=_look_quat(pos, center),
            ))
        return cls(pts)

    # -- binary IO ------------------------------------------------------------
    def save_to_binary_file(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<II", _VERSION, len(self.control_points)))
            for cp in self.control_points:
                f.write(struct.pack(
                    "<8f", cp.time, *map(float, cp.position),
                    *map(float, cp.orientation),
                ))

    @classmethod
    def from_binary_file(cls, path: str) -> "CameraPath":
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a linevis_tpu .binpath file")
            version, count = struct.unpack("<II", f.read(8))
            if version != _VERSION:
                raise ValueError(f"{path}: unsupported version {version}")
            pts = []
            for _ in range(count):
                vals = struct.unpack("<8f", f.read(32))
                pts.append(ControlPoint(
                    time=vals[0],
                    position=np.asarray(vals[1:4], np.float32),
                    orientation=np.asarray(vals[4:8], np.float32),
                ))
        return cls(pts)

    # -- playback -------------------------------------------------------------
    def interpolate(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        """(position, orientation quat) at time t — linear position lerp +
        orientation slerp between bracketing control points."""
        cps = self.control_points
        if not cps:
            raise ValueError("empty camera path")
        t = min(max(t, cps[0].time), cps[-1].time)
        hi = 1
        while hi < len(cps) and cps[hi].time < t:
            hi += 1
        hi = min(hi, len(cps) - 1)
        lo = hi - 1
        span = max(cps[hi].time - cps[lo].time, 1e-12)
        w = (t - cps[lo].time) / span
        pos = (1.0 - w) * cps[lo].position + w * cps[hi].position
        quat = slerp(cps[lo].orientation, cps[hi].orientation, w)
        return pos.astype(np.float32), quat

    def camera_at(self, t: float, distance: float = 1.0):
        """(position, look_at) tuple for Camera construction."""
        pos, quat = self.interpolate(t)
        fwd = _quat_rotate(quat, (0.0, 0.0, -1.0))
        return pos, pos + fwd * distance
