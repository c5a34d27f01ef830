"""Flat line-segment lists (for ray tracing, opacity optimization, filters).

Counterpart of `linevis_tpu/geometry/segments.py` (reference: the
per-segment buffers of the opacity-optimization renderer,
`src/Renderers/OIT/OpacityOptimizationRenderer.hpp:155-172`, and the AABB
list of the ray tracer's BLAS, `src/LineData/LineData.hpp:186,191`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["LineSegments", "build_line_segments"]


@dataclasses.dataclass
class LineSegments:
    """[S_total] flat segments over all lines (S_total = L*(P-1), padded).

    p0, p1:    [S, 3] endpoints
    attr0/1:   [S] endpoint attribute values
    line_id:   [S] int32
    seg_id_in_line: [S] int32
    mask:      [S] bool: both endpoints valid
    """

    p0: torch.Tensor
    p1: torch.Tensor
    attr0: torch.Tensor
    attr1: torch.Tensor
    line_id: torch.Tensor
    seg_id_in_line: torch.Tensor
    mask: torch.Tensor

    @property
    def num_segments(self) -> int:
        return int(self.p0.shape[0])

    def aabbs(self, radius: float):
        """Per-capsule AABBs ([S, 3], [S, 3]): the segment swept by a sphere
        of `radius`."""
        lo = torch.minimum(self.p0, self.p1) - radius
        hi = torch.maximum(self.p0, self.p1) + radius
        return lo, hi


def build_line_segments(positions, mask, attrs, device="cuda") -> LineSegments:
    """positions [L, P, 3], mask [L, P], attrs [L, P] -> flat LineSegments on
    `device`."""
    positions = torch.as_tensor(np.asarray(positions, np.float32), device=device)
    mask = torch.as_tensor(np.asarray(mask, bool), device=device)
    attrs = torch.as_tensor(np.asarray(attrs, np.float32), device=device)
    L, P = positions.shape[0], positions.shape[1]
    line_id = torch.arange(L, dtype=torch.int32, device=device)[:, None].expand(L, P - 1)
    seg_id = torch.arange(P - 1, dtype=torch.int32, device=device)[None, :].expand(L, P - 1)
    return LineSegments(
        p0=positions[:, :-1].reshape(-1, 3), p1=positions[:, 1:].reshape(-1, 3),
        attr0=attrs[:, :-1].reshape(-1), attr1=attrs[:, 1:].reshape(-1),
        line_id=line_id.reshape(-1), seg_id_in_line=seg_id.reshape(-1),
        mask=(mask[:, :-1] & mask[:, 1:]).reshape(-1),
    )
