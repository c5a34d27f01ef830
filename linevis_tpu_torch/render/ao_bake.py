"""Ambient-occlusion prebaker: per-vertex AO along the tube parametrization.

Counterpart of `linevis_tpu/render/ao_bake.py`. Reference: the RTAO
prebaker (`src/Renderers/AmbientOcclusion/VulkanAmbientOcclusionBaker.hpp:61,135-166`,
`Data/Shaders/AO/RTAO/VulkanAmbientOcclusionBaker.glsl`): for every line
vertex and each of `num_tube_subdivisions` ring positions, `samples_per_frame`
cosine-weighted hemisphere rays leave the tube surface and count the
occluders within `ao_radius`, accumulated over `num_frames` frames (the
iterative baking mode, `AmbientOcclusionBaker.hpp:63-69`). Defaults: 4
samples a frame, 8 subdivisions, radius 0.1.

The rays are traced against the same uniform segment grid as screen-space
RTAO (`kernels/ao_grid.py`, kernel B5): one call of `trace_ao_occlusion` per
sample and frame over all ring points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from linevis_tpu_torch.geometry.frames import parallel_transport_frames
from linevis_tpu_torch.kernels.ao_grid import (
    SegmentGrid,
    auto_grid_span,
    build_segment_grid,
    trace_ao_occlusion,
)
from linevis_tpu_torch.render.rtao import _cosine_hemisphere

__all__ = ["AoBakeSettings", "bake_ambient_occlusion", "segment_average_ao", "bake_grid"]


@dataclasses.dataclass(frozen=True)
class AoBakeSettings:
    """VulkanAmbientOcclusionBaker.hpp:163-166 defaults."""

    num_tube_subdivisions: int = 8
    samples_per_frame: int = 4
    num_frames: int = 8
    ao_radius: float = 0.1
    grid_resolution: int = 64
    max_ray_cells: int = 8
    seed: int = 0


def _bake_rays(positions, normals, binormals, radius: float, bake: AoBakeSettings):
    """Ring points of every vertex -> (origins [3, N], ring normals [3, N]),
    N = sub * L * P ring-major, the origins 1% of the radius off the surface."""
    sub = bake.num_tube_subdivisions
    dev = positions.device
    theta = (torch.arange(sub, dtype=torch.float32, device=dev) + 0.5) * (2.0 * math.pi / sub)
    ring = (torch.cos(theta)[:, None, None, None] * normals[None]
            + torch.sin(theta)[:, None, None, None] * binormals[None])  # [sub, L, P, 3]
    surf = positions[None] + ring * radius
    n_pts = ring.shape[0] * ring.shape[1] * ring.shape[2]
    o = surf.reshape(n_pts, 3).T
    n = ring.reshape(n_pts, 3).T
    return o + n * (radius * 0.01), n


def _bake_frame(positions, mask, normals, binormals, grid: SegmentGrid, radius: float,
                bake: AoBakeSettings, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Occluded ray counts of one frame [sub, L, P] from the uniforms u1, u2
    [samples_per_frame, N, 1] of the cosine-weighted directions."""
    L, P = positions.shape[:2]
    sub = bake.num_tube_subdivisions
    o, n = _bake_rays(positions, normals, binormals, radius, bake)
    n_pts = o.shape[1]
    valid = mask[None].expand(sub, L, P).reshape(-1)
    dirs = _cosine_hemisphere(u1, u2, n.reshape(3, n_pts, 1))[..., 0]  # [S, 3, N]
    t_max = torch.full((n_pts,), bake.ao_radius, dtype=torch.float32, device=o.device)
    occ_acc = torch.zeros(n_pts, dtype=torch.float32, device=o.device)
    for s in range(bake.samples_per_frame):
        occ_acc = occ_acc + trace_ao_occlusion(o, dirs[s].contiguous(), t_max, valid, grid,
                                               max_ray_cells=bake.max_ray_cells)
    return occ_acc.reshape(sub, L, P)


def bake_grid(positions, mask, radius: float, bake: AoBakeSettings) -> SegmentGrid:
    """The occluder grid over all tube segments: the span sized so the grid
    registers long straight segments whole, the resolution halved while the
    span would exceed 6 cells (keeping the pair expansion bounded)."""
    L, P = positions.shape[:2]
    cf = positions.reshape(-1, 3).T.reshape(3, L, P)
    a = cf[:, :, :-1].reshape(3, -1).contiguous()
    b = cf[:, :, 1:].reshape(3, -1)
    ba = (b - a).contiguous()
    seg_mask = (mask[:, :-1] & mask[:, 1:]).reshape(-1)
    a_np, ba_np = a.cpu().numpy(), ba.cpu().numpy()
    res = bake.grid_resolution
    span = auto_grid_span(a_np, ba_np, radius, res)
    while span > 6 and res > 8:
        res //= 2
        span = auto_grid_span(a_np, ba_np, radius, res)
    return build_segment_grid(a, ba, radius, seg_mask, resolution=res, span=span)


def bake_ambient_occlusion(
    positions,  # [L, P, 3]
    mask,  # [L, P]
    radius: float,
    bake: AoBakeSettings = AoBakeSettings(),
    device="cuda",
    uniforms: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> np.ndarray:
    """-> AO [L, P, num_tube_subdivisions] in [0, 1] (1 = unoccluded),
    traced on `device`.

    Frame f's hemisphere directions come from `uniforms[f]` = (u1, u2), each
    [samples_per_frame, sub * L * P, 1] in [0, 1), or, when none are given,
    from one torch.Generator on `device` seeded with `bake.seed` (the JAX
    function splits a jax.random key per frame: other numbers). The ring
    directions are cos(theta) * tangent + sin(theta) * normal, as the JAX
    function unpacks `parallel_transport_frames`' (tangents, normals,
    binormals) as (normals, binormals, _)."""
    pos = torch.as_tensor(np.asarray(positions, np.float32), device=device)
    m = torch.as_tensor(np.asarray(mask, bool), device=device)
    ring_a, ring_b, _ = parallel_transport_frames(pos, m)
    grid = bake_grid(pos, m, radius, bake)
    sub = bake.num_tube_subdivisions
    n_pts = sub * pos.shape[0] * pos.shape[1]
    gen = None
    if uniforms is None:
        gen = torch.Generator(device=device).manual_seed(bake.seed)
    total = torch.zeros((sub,) + tuple(pos.shape[:2]), dtype=torch.float32, device=device)
    shape = (bake.samples_per_frame, n_pts, 1)
    for f in range(bake.num_frames):
        if uniforms is None:
            u1 = torch.rand(shape, generator=gen, device=device)
            u2 = torch.rand(shape, generator=gen, device=device)
        else:
            u1, u2 = (torch.as_tensor(u, dtype=torch.float32, device=device)
                      for u in uniforms[f])
        total = total + _bake_frame(pos, m, ring_a, ring_b, grid, float(radius), bake, u1, u2)
    ao = 1.0 - total / (bake.num_frames * bake.samples_per_frame)
    return np.moveaxis(ao.cpu().numpy(), 0, -1)


def segment_average_ao(ao: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Ring-averaged per-segment AO (a0, da) rows for the capsule shader:
    [2, S] with ao(u) = a0 + da * u along each segment."""
    ring_avg = ao.mean(axis=-1)  # [L, P]
    a0 = ring_avg[:, :-1].reshape(-1)
    a1 = ring_avg[:, 1:].reshape(-1)
    return np.stack([a0, a1 - a0], axis=0).astype(np.float32)
