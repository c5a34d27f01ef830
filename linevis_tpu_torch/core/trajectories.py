"""Trajectory containers: ragged lists from loaders -> padded SoA arrays on
the host (numpy).

Counterpart of `linevis_tpu/core/trajectories.py`; behavioral reference
`src/Loaders/TrajectoryFile.hpp:38-105` (Trajectory / Trajectories /
StressTrajectoryData, AABB and normalization helpers). Host data stays
numpy; renderers move it to a device when they build their scene.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = [
    "RaggedTrajectories",
    "Trajectories",
    "StressTrajectoriesData",
    "pad_trajectories",
    "compute_trajectories_aabb",
    "normalize_trajectories",
    "normalize_attributes",
]


@dataclasses.dataclass
class RaggedTrajectories:
    """Ragged trajectories, as file loaders produce them.

    positions: list of [P_i, 3] float32 arrays.
    attributes: list of [A, P_i] float32 arrays (A attributes per line;
    reference `Trajectory::attributes`, `TrajectoryFile.hpp:40-44`).
    """

    positions: List[np.ndarray]
    attributes: List[np.ndarray]
    attribute_names: List[str] = dataclasses.field(default_factory=list)

    @property
    def num_lines(self) -> int:
        return len(self.positions)

    @property
    def num_attributes(self) -> int:
        if not self.attributes:
            return 0
        return int(self.attributes[0].shape[0]) if self.attributes[0].ndim == 2 else 0


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


@dataclasses.dataclass
class StressTrajectoriesData:
    """Per-line stress metadata, padded to [L] (reference
    `StressTrajectoryData`, `TrajectoryFile.hpp:46-62`): hierarchy levels (3
    per line: structure/topology/geometry), appearance order, seed points,
    and the principal-stress index of each line."""

    hierarchy_levels: np.ndarray  # [L, 3] float32 in [0, 1]
    appearance_order: np.ndarray  # [L] int32
    seed_points: np.ndarray  # [L, 3] float32
    principal_stress_index: np.ndarray  # [L] int32 (0=major,1=medium,2=minor)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_trajectories(
    ragged: RaggedTrajectories,
    max_points: Optional[int] = None,
    pad_multiple: int = 8,
) -> Trajectories:
    """Pad ragged trajectories to a fixed [L, P] shape.

    Padding repeats the last valid point (positions) and value (attributes),
    so differences across the padded tail are zero and parallel-transport
    frames stay finite. `pad_multiple` rounds P up; its default of 8 is the
    JAX package's, so P, and every segment id after it, match it.
    """
    num_lines = ragged.num_lines
    if num_lines == 0:
        return Trajectories(
            positions=np.zeros((0, pad_multiple, 3), np.float32),
            attributes=np.zeros((0, 0, pad_multiple), np.float32),
            mask=np.zeros((0, pad_multiple), bool),
            num_points=np.zeros((0,), np.int32),
            attribute_names=list(ragged.attribute_names),
        )
    lengths = np.array([p.shape[0] for p in ragged.positions], np.int32)
    P = int(lengths.max()) if max_points is None else max_points
    P = max(_round_up(max(P, 2), pad_multiple), pad_multiple)
    A = ragged.num_attributes

    positions = np.zeros((num_lines, P, 3), np.float32)
    attributes = np.zeros((num_lines, A, P), np.float32)
    mask = np.zeros((num_lines, P), bool)
    for i, pos in enumerate(ragged.positions):
        n = min(pos.shape[0], P)
        positions[i, :n] = pos[:n]
        positions[i, n:] = pos[n - 1]
        mask[i, :n] = True
        if A:
            att = ragged.attributes[i]
            attributes[i, :, :n] = att[:, :n]
            attributes[i, :, n:] = att[:, n - 1 : n]
    return Trajectories(
        positions=positions,
        attributes=attributes,
        mask=mask,
        num_points=np.minimum(lengths, P).astype(np.int32),
        attribute_names=list(ragged.attribute_names),
    )


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
