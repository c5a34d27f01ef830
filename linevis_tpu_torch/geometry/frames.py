"""Parallel-transport frames along polylines.

Counterpart of `linevis_tpu/geometry/frames.py` (behavioural reference:
the tube frame construction of `src/Renderers/Tubes/Tubes.hpp:159-205`):
a normal is carried along each line by projecting the previous normal onto
the plane of the new tangent. The JAX package scans over the points inside
a vmap over the lines; here the scan is a Python loop over the P points on
[L, 3] tensors (set-up time, not a kernel).
"""

from __future__ import annotations

import torch

__all__ = ["compute_tangents", "parallel_transport_frames"]

_EPS = 1e-8


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(_norm(v), min=_EPS)


def compute_tangents(positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Central-difference tangents for [L, P, 3] padded polylines.

    Endpoints use one-sided differences; padded points (positions padded by
    repetition, so the differences vanish) fall back to whichever one-sided
    difference is nonzero, then to +x.
    """
    fwd = positions[:, 1:] - positions[:, :-1]  # [L, P-1, 3]
    zero = torch.zeros_like(fwd[:, :1])
    d_fwd = torch.cat([fwd, zero], dim=1)
    d_bwd = torch.cat([zero, fwd], dim=1)
    t = d_fwd + d_bwd
    t = torch.where(_norm(t) > _EPS, t, d_bwd)
    t = torch.where(_norm(t) > _EPS, t, d_fwd)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    t = torch.where(_norm(t) > _EPS, t, x_axis)
    return _normalize(t)


def _initial_normal(t0: torch.Tensor) -> torch.Tensor:
    """A stable unit vector orthogonal to each row of t0 [L, 3]: the axis
    most orthogonal to the tangent, Gram-Schmidt projected."""
    ax = torch.abs(t0)
    eye = torch.eye(3, dtype=t0.dtype, device=t0.device)
    use_x = ((ax[:, 0] <= ax[:, 1]) & (ax[:, 0] <= ax[:, 2]))[:, None]
    use_y = (ax[:, 1] <= ax[:, 2])[:, None]
    helper = torch.where(use_x, eye[0], torch.where(use_y, eye[1], eye[2]))
    n = helper - torch.sum(helper * t0, dim=-1, keepdim=True) * t0
    return _normalize(n)


def parallel_transport_frames(positions: torch.Tensor, mask: torch.Tensor):
    """Returns (tangents, normals, binormals), each [L, P, 3].

    Normals are parallel-transported:
    n_i = normalize(n_{i-1} - (n_{i-1} . t_i) t_i), re-seeded where the
    tangent is parallel to the carried normal.
    """
    tangents = compute_tangents(positions, mask)
    n_prev = _initial_normal(tangents[:, 0])
    normals = []
    for i in range(tangents.shape[1]):
        t_i = tangents[:, i]
        n = n_prev - torch.sum(n_prev * t_i, dim=-1, keepdim=True) * t_i
        norm = _norm(n)
        n_prev = torch.where(
            norm > 1e-5, n / torch.clamp(norm, min=_EPS), _initial_normal(t_i)
        )
        normals.append(n_prev)
    normals = torch.stack(normals, dim=1)
    binormals = _normalize(torch.linalg.cross(tangents, normals, dim=-1))
    return tangents, normals, binormals
