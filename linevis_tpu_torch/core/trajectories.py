"""Trajectory containers: padded SoA arrays on the host (numpy).

Counterpart of `linevis_tpu/core/trajectories.py`; behavioral reference
`src/Loaders/TrajectoryFile.hpp:38-105` (Trajectories, AABB and
normalization helpers). Host data stays numpy; renderers move it to a
device when they build their scene.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = [
    "Trajectories",
    "compute_trajectories_aabb",
    "normalize_trajectories",
    "normalize_attributes",
]


@dataclasses.dataclass
class Trajectories:
    """Padded SoA trajectories.

    positions:   [L, P, 3] float32 — padded with the last valid point.
    attributes:  [L, A, P] float32 — padded with edge values.
    mask:        [L, P] bool — True for valid points.
    num_points:  [L] int32.
    """

    positions: np.ndarray
    attributes: np.ndarray
    mask: np.ndarray
    num_points: np.ndarray
    attribute_names: List[str] = dataclasses.field(default_factory=list)

    @property
    def num_lines(self) -> int:
        return int(self.positions.shape[0])

    @property
    def max_points(self) -> int:
        return int(self.positions.shape[1])

    @property
    def num_attributes(self) -> int:
        return int(self.attributes.shape[1])

    def segment_mask(self) -> np.ndarray:
        """[L, P-1] bool — True where both endpoints of a segment are valid."""
        return self.mask[:, :-1] & self.mask[:, 1:]


def compute_trajectories_aabb(traj: Trajectories) -> np.ndarray:
    """AABB over valid points -> [2, 3] (min, max)."""
    if traj.num_lines == 0:
        return np.zeros((2, 3), np.float32)
    m = traj.mask[..., None]
    big = np.float32(3.0e38)
    lo = np.where(m, traj.positions, big).reshape(-1, 3).min(axis=0)
    hi = np.where(m, traj.positions, -big).reshape(-1, 3).max(axis=0)
    return np.stack([lo, hi]).astype(np.float32)


def normalize_trajectories(
    traj: Trajectories, aabb: Optional[np.ndarray] = None
) -> Trajectories:
    """Rescale positions into a box of max extent 1 centered at the origin
    (`normalizeTrajectoriesVertexPositions`, `TrajectoryFile.hpp:85+`)."""
    if aabb is None:
        aabb = compute_trajectories_aabb(traj)
    lo, hi = aabb[0], aabb[1]
    center = 0.5 * (lo + hi)
    extent = float(np.max(hi - lo))
    scale = 1.0 / extent if extent > 0 else 1.0
    positions = (traj.positions - center) * scale
    return dataclasses.replace(traj, positions=positions.astype(np.float32))


def normalize_attributes(
    traj: Trajectories, per_attribute: bool = True
) -> Trajectories:
    """Min-max normalize attributes over valid points to [0, 1]
    (`normalizeTrajectoriesVertexAttributes`, `TrajectoryFile.hpp:95+`)."""
    if traj.num_attributes == 0:
        return traj
    m = traj.mask[:, None, :]
    big = np.float32(3.0e38)
    vals = traj.attributes
    axes = (0, 2) if per_attribute else (0, 1, 2)
    lo = np.where(m, vals, big).min(axis=axes, keepdims=True)
    hi = np.where(m, vals, -big).max(axis=axes, keepdims=True)
    rng = np.maximum(hi - lo, 1e-7)
    out = np.clip((vals - lo) / rng, 0.0, 1.0).astype(np.float32)
    return dataclasses.replace(traj, attributes=out)
