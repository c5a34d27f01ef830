"""Monte-Carlo scattering line tracer (delta tracking).

Counterpart of `linevis_tpu/trace/scattering.py` (reference
`src/LineData/Scattering/DtPathTrace.cpp:384-485` `dt_path_trace` and the
ray set-up of `ScatteringLineTracingRequester.cpp:380-465`): light paths
are shot through a density grid; every free-flight or collision event
appends a vertex, and the paths become the trajectories of
`scene/line_data_scattering.py:LineDataScattering`.

The JAX package writes the events as one vmapped `lax.scan`; here they are
a lockstep loop over `max_events` on the whole ray batch, every ray one
Woodcock event a step, in plain PyTorch on the rays' device (set-up, not a
frame: 128 events over tens of thousands of paths). Every sample comes from
jax.random's stream (`ops/threefry.py`), keyed as the JAX function keys it,
so the same key gives the same paths up to float rounding. As in the JAX
scan, a ray's state keeps moving after it died (only the records are
masked), which the exit direction of a ray that left early sees.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from linevis_tpu_torch.kernels.volume_common import (
    box_intersect,
    phase_constants,
    sample_phase,
    trilinear,
    vdiv,
)
from linevis_tpu_torch.ops import threefry

__all__ = [
    "grid_box",
    "dt_path_trace_rays",
    "trace_scattering_rays",
    "ScatteringTracingSettings",
]


@dataclasses.dataclass(frozen=True)
class ScatteringTracingSettings:
    """Mirrors reference `ScatteringTracingSettings`
    (`ScatteringLineTracingRequester.hpp:40-57`)."""

    camera_fov_deg: float = 10.0
    camera_position: Tuple[float, float, float] = (-0.5, -0.5, -0.5)
    camera_look_at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    res_x: int = 1
    res_y: int = 1
    samples_per_pixel: int = 10
    extinction: Tuple[float, float, float] = (1024.0, 1024.0, 1024.0)
    scattering_albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    g: float = 0.2
    seed: int = 42
    max_events: int = 128


def grid_box(grid_shape) -> Tuple[np.ndarray, np.ndarray]:
    """Volume AABB for a [Z, Y, X] grid (DtPathTrace.cpp:295-303
    `get_grid_box`): centered at the origin, max half-extent 0.25."""
    sz, sy, sx = grid_shape[0], grid_shape[1], grid_shape[2]
    max_dim = float(max(sx, sy, sz))
    b_max = np.array([sx, sy, sz], np.float32) / max_dim * 0.25
    return -b_max, b_max


def dt_path_trace_rays(
    key: torch.Tensor,  # int64 [2] threefry key
    grid: torch.Tensor,  # [Z, Y, X] density in [0, 1]
    origins: torch.Tensor,  # [N, 3]
    directions: torch.Tensor,  # [N, 3] normalized
    density: torch.Tensor,  # [N] extinction multiplier per ray (channel)
    albedo: torch.Tensor,  # [N] scattering albedo per ray
    g: float,
    max_events: int = 128,
):
    """Woodcock/delta tracking over a ray wavefront on the rays' device.

    Returns (positions [N, max_events+2, 3], mask [N, max_events+2],
    exit_dirs [N, 3], exited [N]): `exited` is True for rays that left the
    volume (False: absorbed or missed), used by the spherical heat map.
    """
    dev = origins.device
    N = origins.shape[0]
    b_min_np, b_max_np = grid_box(grid.shape)
    b_min = tuple(float(v) for v in b_min_np)
    b_max = tuple(float(v) for v in b_max_np)
    extent = tuple(float(v) for v in (b_max_np - b_min_np))
    grid = grid.float()
    pc = phase_constants(float(g))
    keys = threefry.split(key.to(dev), N)
    o = origins.unbind(1)
    w = directions.unbind(1)
    t_min, t_max, hit = box_intersect(b_min, b_max, o, w)
    x_entry = tuple(o[i] + w[i] * t_min for i in range(3))
    x, d, alive = x_entry, t_max - t_min, hit
    safe_dens = torch.clamp(density, min=1e-5)
    thin = density <= 1e-5
    pts, recs, exits = [], [], []
    for j in range(max_events):
        ks = threefry.split(threefry.split_at(keys, j), 3)
        u = threefry.uniform_at(ks[:, :2])
        t = torch.where(thin, torch.full_like(safe_dens, 1e7),
                        -torch.log(torch.clamp(1.0 - u[:, 0], min=1e-11)) / safe_dens)
        x_new = tuple(x[i] + w[i] * t for i in range(3))
        exited = t >= d
        tpos = tuple(vdiv(x_new[i] - b_min[i], extent[i]) for i in range(3))
        m_t = trilinear(grid, tpos) * density
        m_s = m_t * albedo
        pa = (m_t - m_s) / safe_dens
        pn = 1.0 - m_t / safe_dens
        xi = u[:, 1]
        absorbed = (~exited) & (xi < pa)
        scattered = (~exited) & (~absorbed) & (xi < 1.0 - pn)
        w_new = list(w)
        d_new = torch.where(exited, d, d - t)
        x_out = list(x_new)
        hit2 = torch.ones_like(hit)
        sc = torch.nonzero(scattered).reshape(-1)
        if sc.numel():
            up = threefry.uniform_at(threefry.split(ks[sc, 2], 2))
            wn = sample_phase(up[:, 0], up[:, 1], pc, tuple(c[sc] for c in w))
            xs = tuple(c[sc] for c in x_new)
            t2_min, t2_max, h2 = box_intersect(b_min, b_max, xs, wn)
            for i in range(3):
                w_new[i] = w_new[i].index_put((sc,), wn[i])
                x_out[i] = x_out[i].index_put((sc,), torch.where(h2, xs[i] + wn[i] * t2_min,
                                                                 xs[i]))
            d_new = d_new.index_put((sc,), torch.where(h2, t2_max - t2_min,
                                                       torch.zeros_like(t2_max)))
            hit2 = hit2.index_put((sc,), h2)
        pts.append(torch.stack(x_new, 1))
        recs.append(alive)
        exits.append(exited & alive)
        alive = alive & (~exited) & (~absorbed) & ~(scattered & ~hit2)
        x, w, d = tuple(x_out), tuple(w_new), d_new
    positions = torch.stack([torch.stack(o, 1), torch.stack(x_entry, 1), *pts], 1)
    mask = torch.stack([hit, hit, *recs], 1)
    exited_any = torch.stack(exits, 1).any(1) if exits else torch.zeros_like(hit)
    n = torch.clamp(torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]), min=1e-12)
    exit_dir = torch.stack([w[i] / n for i in range(3)], 1)
    return positions, mask, exit_dir, exited_any


def scattering_rays(settings: ScatteringTracingSettings):
    """The requester's rays (ScatteringLineTracingRequester.cpp:405-465) in
    numpy: (origins [N, 3], directions [N, 3], density [N], albedo [N]),
    `samples_per_pixel` paths per focal-plane pixel, the extinction and
    albedo channels cycling with the sample number."""
    cam = np.asarray(settings.camera_position, np.float32)
    look = np.asarray(settings.camera_look_at, np.float32)
    fwd = look - cam
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    y_axis = np.array([0.0, -1.0, 0.0], np.float32)
    x_axis = np.cross(fwd, y_axis)
    y_axis = np.cross(x_axis, fwd)

    focal_length = 1.0
    grid_w = np.tan(np.radians(settings.camera_fov_deg) / 2.0) * 2 * focal_length
    grid_h = settings.res_y * (grid_w / settings.res_x)
    p00 = cam + fwd * focal_length - 0.5 * y_axis * grid_h - 0.5 * x_axis * grid_w

    dirs, dens, albs = [], [], []
    ext = np.asarray(settings.extinction, np.float32)
    alb = np.asarray(settings.scattering_albedo, np.float32)
    for y in range(settings.res_y):
        yp = 0.5 if settings.res_y < 2 else y / (settings.res_y - 1)
        for x in range(settings.res_x):
            xp = 0.5 if settings.res_x < 2 else x / (settings.res_x - 1)
            p = p00 + x_axis * (xp * grid_w) + y_axis * (yp * grid_h)
            d = p - cam
            d = d / max(np.linalg.norm(d), 1e-12)
            for i in range(settings.samples_per_pixel):
                dirs.append(d)
                dens.append(ext[i % 3])
                albs.append(alb[i % 3])
    n = len(dirs)
    origins = np.broadcast_to(cam, (n, 3)).astype(np.float32)
    return (origins, np.stack(dirs).astype(np.float32), np.asarray(dens, np.float32),
            np.asarray(albs, np.float32))


def trace_scattering_rays(grid: np.ndarray, settings: ScatteringTracingSettings, device="cuda"):
    """Full requester protocol (ScatteringLineTracingRequester.cpp:405-465)
    traced on `device`: the focal-plane ray grid, `samples_per_pixel`
    stochastic paths per pixel, the extinction and albedo channels cycling
    with the pass number, keyed by `PRNGKey(settings.seed)`.

    Returns (positions [N, Pmax, 3] np, mask [N, Pmax] np,
    exit_dirs [N, 3] np, exited [N] np bool).
    """
    origins, dirs, dens, albs = scattering_rays(settings)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    pos, mask, exit_dirs, exited = dt_path_trace_rays(
        threefry.prng_key(settings.seed, device), t(np.asarray(grid, np.float32)), t(origins),
        t(dirs), t(dens), t(albs), float(settings.g), max_events=settings.max_events,
    )
    return (pos.cpu().numpy(), mask.cpu().numpy(), exit_dirs.cpu().numpy(),
            exited.cpu().numpy())
