"""Replay helpers: quaternion slerp and rotation.

Counterpart of the two helpers of `linevis_tpu/automation/replay.py` that
camera paths need (reference `ReplayWidget.cpp:475-497` py_slerp); the
rest of that module, the `g.*` replay scripting, is not ported yet (ROADMAP
queue A item 9).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["slerp"]


def slerp(q0, q1, t: float) -> np.ndarray:
    """Spherical linear interpolation of quaternions (x, y, z, w) —
    the reference exposes the same helper to scripts
    (`ReplayWidget.cpp:475-497` py_slerp) and uses it for camera
    orientations (`ReplayWidget.cpp:870`)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    q0 = q0 / max(np.linalg.norm(q0), 1e-12)
    q1 = q1 / max(np.linalg.norm(q1), 1e-12)
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return (out / max(np.linalg.norm(out), 1e-12)).astype(np.float32)
    theta0 = math.acos(min(max(d, -1.0), 1.0))
    s0 = math.sin((1.0 - t) * theta0) / math.sin(theta0)
    s1 = math.sin(t * theta0) / math.sin(theta0)
    return (s0 * q0 + s1 * q1).astype(np.float32)


def _quat_rotate(q, v) -> np.ndarray:
    """Rotate vector v by quaternion q = (x, y, z, w)."""
    x, y, z, w = (float(c) for c in q)
    u = np.array([x, y, z], np.float64)
    v = np.asarray(v, np.float64)
    return (
        2.0 * np.dot(u, v) * u
        + (w * w - np.dot(u, u)) * v
        + 2.0 * w * np.cross(u, v)
    ).astype(np.float32)
