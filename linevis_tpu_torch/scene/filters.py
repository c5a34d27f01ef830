"""Trajectory filters (GUI-driven sequential filter chain).

Counterpart of `linevis_tpu/scene/filters.py` (numpy only, on the port's
`Trajectories`).

Reference: `src/LineData/Filters/*` — `LineFilter` base
(`LineFilter.hpp:44-62`) with `LineLengthFilter` (drop lines shorter than
a threshold arc length) and `MaxLineAttributeFilter` (keep lines whose
maximum attribute value lies in a selected range). Filters produce a
per-line keep mask combined by the scene model.
"""

from __future__ import annotations

import numpy as np

from linevis_tpu_torch.core.trajectories import Trajectories

__all__ = ["LineFilter", "LineLengthFilter", "MaxLineAttributeFilter"]


class LineFilter:
    enabled: bool = True

    def filter(self, traj: Trajectories) -> np.ndarray:
        """Returns keep mask [L] bool."""
        raise NotImplementedError


class LineLengthFilter(LineFilter):
    """Keep lines with arc length >= threshold (LineLengthFilter.cpp)."""

    def __init__(self, min_length: float = 0.0, max_length: float = float("inf")):
        self.min_length = min_length
        self.max_length = max_length

    def filter(self, traj: Trajectories) -> np.ndarray:
        seg = traj.positions[:, 1:] - traj.positions[:, :-1]
        seg_len = np.linalg.norm(seg, axis=-1)
        seg_mask = traj.mask[:, :-1] & traj.mask[:, 1:]
        lengths = (seg_len * seg_mask).sum(axis=1)
        return (lengths >= self.min_length) & (lengths <= self.max_length)


class MaxLineAttributeFilter(LineFilter):
    """Keep lines whose max attribute value is within [lo, hi]
    (MaxLineAttributeFilter.cpp)."""

    def __init__(self, attribute_index: int = 0, lo: float = 0.0, hi: float = 1.0):
        self.attribute_index = attribute_index
        self.lo = lo
        self.hi = hi

    def filter(self, traj: Trajectories) -> np.ndarray:
        if traj.num_attributes == 0:
            return np.ones((traj.num_lines,), bool)
        vals = traj.attributes[:, self.attribute_index]
        vals = np.where(traj.mask, vals, -np.inf)
        mx = vals.max(axis=1)
        return (mx >= self.lo) & (mx <= self.hi)
