"""Streamline tracer: all seeds advance in lockstep on the device.

Counterpart of `linevis_tpu/trace/streamline.py` (behavioral reference
`src/LineData/Flow/StreamlineTracingGrid.{hpp,cpp}`, integrators
`StreamlineTracingDefines.hpp:63-81`, settings `:148-180`, seeders
`StreamlineSeeder.hpp`). The JAX package runs the integration as one
`lax.scan`; here it is a Python loop over steps whose body is a handful of
elementwise ops on [N, 3] tensors.

- Fixed-step integrators (explicit Euler, Heun, midpoint, RK4, RKF45's
  5th-order solution) with the bounds test and the speed termination.
- Adaptive RKF45 (`adaptive=True`): each line's dt adapts within
  [dt_min, dt_max] against the embedded 4th/5th-order error; a rejected
  step records nothing, and the lines are repacked into prefix form after
  the trace (`_compact_prefix`).
- Loop termination (`termination_distance > 0`): a line stops when its new
  point comes within the distance of one of its points recorded at least
  `loop_min_gap` steps earlier (StreamlineTracingDefines.hpp:89-104); the
  history is [max_steps, N, 3] on the device.
- Derived attributes (velocity magnitude, vorticity magnitude, helicity),
  the grid tracer and streamribbons.

Seeds given as None are drawn on the host from
`np.random.default_rng(settings.seed)` (jax.random's bits cannot be
reproduced); `seed_points_volume` / `seed_points_plane` draw them on a
`torch.Generator`'s device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from linevis_tpu_torch.core.trajectories import Trajectories
from linevis_tpu_torch.trace.fields import sample_grid_trilinear

__all__ = [
    "StreamlineTracingSettings", "seed_points_volume", "seed_points_plane",
    "trace_streamlines", "trace_streamlines_grid", "trace_streamribbons",
]

# Integrator names (reference StreamlineTracingDefines.hpp:63-81)
INTEGRATOR_EXPLICIT_EULER = "explicit_euler"
INTEGRATOR_HEUN = "heun"
INTEGRATOR_MIDPOINT = "midpoint"
INTEGRATOR_RK4 = "rk4"
INTEGRATOR_RKF45 = "rkf45"


@dataclasses.dataclass(frozen=True)
class StreamlineTracingSettings:
    """Subset of reference `StreamlineTracingSettings`
    (StreamlineTracingDefines.hpp:148-180)."""

    num_seeds: int = 256
    max_steps: int = 512
    dt: float = 1.0 / 256.0
    integrator: str = INTEGRATOR_RK4
    terminate_speed: float = 1e-6
    seed: int = 42
    forward: bool = True
    backward: bool = False
    # Adaptive RKF45 (reference StreamlineTracingGrid _integrationStep
    # RKF45 branch): dt adapts per line within [dt_min, dt_max] against
    # the embedded 4th/5th-order error estimate.
    adaptive: bool = False
    tolerance: float = 1e-5
    dt_min: float = 1.0 / 2048.0
    dt_max: float = 1.0 / 32.0
    # Self-proximity / loop termination (StreamlineTracingDefines.hpp:89-104):
    # stop when the new point comes within `termination_distance` of a point
    # recorded at least `loop_min_gap` steps earlier.
    termination_distance: float = 0.0  # 0 disables
    loop_min_gap: int = 10


def seed_points_volume(generator: torch.Generator, n: int) -> torch.Tensor:
    """Uniform random seeds in [0,1]^3 on the generator's device (reference
    VolumeSeeder)."""
    return torch.rand((n, 3), generator=generator, device=generator.device)


def seed_points_plane(
    generator: torch.Generator, n: int, axis: int = 2, offset: float = 0.1
) -> torch.Tensor:
    """Random seeds on an axis-aligned plane (reference PlaneSeeder)."""
    p = seed_points_volume(generator, n)
    p[:, axis] = offset
    return p


def _step(field: Callable, p: torch.Tensor, dt: float, method: str) -> torch.Tensor:
    v1 = field(p)
    if method == INTEGRATOR_EXPLICIT_EULER:
        return p + dt * v1
    if method == INTEGRATOR_MIDPOINT:
        return p + dt * field(p + 0.5 * dt * v1)
    if method == INTEGRATOR_HEUN:
        v2 = field(p + dt * v1)
        return p + dt * 0.5 * (v1 + v2)
    if method == INTEGRATOR_RK4:
        k1 = v1
        k2 = field(p + 0.5 * dt * k1)
        k3 = field(p + 0.5 * dt * k2)
        k4 = field(p + dt * k3)
        return p + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    if method == INTEGRATOR_RKF45:
        # Fixed-step Fehlberg 4(5): the 5th-order solution.
        return _rkf45_embedded(field, p, dt)[0]
    raise ValueError(f"Unknown integrator {method!r}")


def _vorticity(field: Callable, p: torch.Tensor, h: float = 1e-3) -> torch.Tensor:
    """Curl via central differences."""

    def d(axis):
        e = torch.zeros(3, dtype=torch.float32, device=p.device)
        e[axis] = h
        return (field(p + e) - field(p - e)) / (2.0 * h)

    dv_dx, dv_dy, dv_dz = d(0), d(1), d(2)
    return torch.stack(
        [
            dv_dy[..., 2] - dv_dz[..., 1],
            dv_dz[..., 0] - dv_dx[..., 2],
            dv_dx[..., 1] - dv_dy[..., 0],
        ],
        dim=-1,
    )


def _rkf45_embedded(field, p, dt):
    """Fehlberg 4(5): returns (p5, err), the 5th-order step and its error
    estimate against the embedded 4th-order solution."""
    k1 = field(p)
    k2 = field(p + dt * (k1 / 4.0))
    k3 = field(p + dt * (3.0 / 32.0 * k1 + 9.0 / 32.0 * k2))
    k4 = field(
        p + dt * (1932.0 / 2197.0 * k1 - 7200.0 / 2197.0 * k2
                  + 7296.0 / 2197.0 * k3)
    )
    k5 = field(
        p + dt * (439.0 / 216.0 * k1 - 8.0 * k2 + 3680.0 / 513.0 * k3
                  - 845.0 / 4104.0 * k4)
    )
    k6 = field(
        p + dt * (-8.0 / 27.0 * k1 + 2.0 * k2 - 3544.0 / 2565.0 * k3
                  + 1859.0 / 4104.0 * k4 - 11.0 / 40.0 * k5)
    )
    p5 = p + dt * (16.0 / 135.0 * k1 + 6656.0 / 12825.0 * k3
                   + 28561.0 / 56430.0 * k4 - 9.0 / 50.0 * k5
                   + 2.0 / 55.0 * k6)
    p4 = p + dt * (25.0 / 216.0 * k1 + 1408.0 / 2565.0 * k3
                   + 2197.0 / 4104.0 * k4 - k5 / 5.0)
    return p5, torch.linalg.norm(p5 - p4, dim=-1)


def _trace_batch(
    field: Callable, settings: StreamlineTracingSettings, seeds: torch.Tensor
):
    """Integration -> (positions [N, steps+1, 3], mask [N, steps+1]); with
    adaptive RKF45 a rejected step's slot is False and holds the line's
    last point."""
    sign = 1.0 if settings.forward else -1.0
    dt = sign * settings.dt
    adaptive = settings.adaptive and settings.integrator == INTEGRATOR_RKF45
    max_steps = settings.max_steps
    dev = seeds.device
    N = seeds.shape[0]
    p = seeds
    alive = torch.ones(seeds.shape[:-1], dtype=torch.bool, device=dev)
    dts = torch.full((N,), dt, dtype=torch.float32, device=dev)
    history = None
    if settings.termination_distance > 0.0:
        history = torch.full((max_steps, N, 3), 1e6, dtype=torch.float32, device=dev)
    positions = [seeds]
    masks = [alive]
    for i in range(max_steps):
        if adaptive:
            p_try, err = _rkf45_embedded(field, p, dts[:, None])
            accept = (err <= settings.tolerance) | (
                torch.abs(dts) <= settings.dt_min * 1.0001
            )
            # Standard controller: dt *= 0.9 * (tol/err)^(1/5), clamped.
            fac = torch.clamp(
                0.9 * (settings.tolerance / torch.clamp(err, min=1e-30)) ** 0.2, 0.2, 4.0
            )
            dts = torch.clamp(torch.abs(dts * fac), settings.dt_min, settings.dt_max) * sign
            p_new = torch.where(accept[:, None], p_try, p)
        else:
            p_new = _step(field, p, dt, settings.integrator)
        in_bounds = torch.all((p_new >= 0.0) & (p_new <= 1.0), dim=-1)
        speed = torch.linalg.norm(field(p_new), dim=-1)
        ok = alive & in_bounds & (speed > settings.terminate_speed)
        # The slots a loop test reads: recorded (j < i) and at least
        # loop_min_gap steps old (i - j >= loop_min_gap).
        old = i - max(settings.loop_min_gap, 1) + 1
        if history is not None and old > 0:
            d2 = torch.sum((history[:old] - p_new[None]) ** 2, dim=-1)  # [old, N]
            ok = ok & ~torch.any(d2 < settings.termination_distance ** 2, dim=0)
        if adaptive:
            alive = torch.where(accept, ok, alive)
            rec = alive & accept
        else:
            alive = rec = ok
        p = torch.where(rec[:, None], p_new, p)
        if history is not None:
            history[i] = torch.where(rec[:, None], p, 1e6)
        positions.append(p)
        masks.append(rec)
    return torch.stack(positions, dim=1), torch.stack(masks, dim=1)


def _derived_attributes(field: Callable, positions: torch.Tensor) -> torch.Tensor:
    """[Velocity Magnitude, Vorticity Magnitude, Helicity] -> [N, 3, P]."""
    v = field(positions)
    vel_mag = torch.linalg.norm(v, dim=-1)
    vort = _vorticity(field, positions)
    vort_mag = torch.linalg.norm(vort, dim=-1)
    helicity = torch.sum(v * vort, dim=-1)
    return torch.stack([vel_mag, vort_mag, helicity], dim=1)


def _compact_prefix(positions: np.ndarray, mask: np.ndarray):
    """Repack per-line recorded points into prefix form (adaptive RKF45
    rejections leave interior False slots holding duplicate points)."""
    N, P = mask.shape
    out_pos = positions.copy()
    out_mask = np.zeros_like(mask)
    for i in range(N):
        sel = np.nonzero(mask[i])[0]
        n = len(sel)
        out_pos[i, :n] = positions[i, sel]
        if n:
            out_pos[i, n:] = positions[i, sel[-1]]
        out_mask[i, :n] = True
    return out_pos, out_mask


def _trace(field, settings, seeds, device) -> Trajectories:
    if seeds is None:
        rng = np.random.default_rng(settings.seed)
        seeds = rng.uniform(size=(settings.num_seeds, 3)).astype(np.float32)
    seeds = torch.as_tensor(seeds, dtype=torch.float32, device=device)
    positions, mask = _trace_batch(field, settings, seeds)
    if settings.adaptive and settings.integrator == INTEGRATOR_RKF45:
        pos_np, mask_np = _compact_prefix(positions.cpu().numpy(), mask.cpu().numpy())
        positions = torch.as_tensor(pos_np, device=seeds.device)
    else:
        mask_np = mask.cpu().numpy()
    attributes = _derived_attributes(field, positions)
    return Trajectories(
        positions=positions.cpu().numpy(),
        attributes=attributes.cpu().numpy(),
        mask=mask_np,
        num_points=np.asarray(mask_np.sum(axis=1), np.int32),
        attribute_names=[
            "Velocity Magnitude", "Vorticity Magnitude", "Helicity"
        ],
    )


def trace_streamlines(
    field: Callable[[torch.Tensor], torch.Tensor],
    settings: StreamlineTracingSettings = StreamlineTracingSettings(),
    seeds=None,
    device="cuda",
) -> Trajectories:
    """Trace streamlines through an analytic velocity field on `device`.

    seeds: [N, 3] in [0,1]^3 (tensor or array); None draws
    `settings.num_seeds` uniform seeds from `np.random.default_rng(settings.seed)`.
    Returns host `Trajectories` with attributes
    [Velocity Magnitude, Vorticity Magnitude, Helicity].
    """
    return _trace(field, settings, seeds, device)


def trace_streamlines_grid(
    grid,
    settings: StreamlineTracingSettings = StreamlineTracingSettings(),
    seeds=None,
    device="cuda",
) -> Trajectories:
    """Trace streamlines through a [Z, Y, X, 3] velocity grid (array or
    tensor) on `device`, sampled trilinearly; seeds as `trace_streamlines`."""
    if not isinstance(grid, torch.Tensor):
        grid = torch.tensor(np.asarray(grid, np.float32))
    grid = grid.to(device=device, dtype=torch.float32)

    def field(p):
        return sample_grid_trilinear(grid, p)

    return _trace(field, settings, seeds, device)


def trace_streamribbons(
    field: Callable[[torch.Tensor], torch.Tensor],
    settings: StreamlineTracingSettings = StreamlineTracingSettings(),
    seeds=None,
    device="cuda",
):
    """Streamribbons (reference StreamlineTracingGrid::traceStreamribbons,
    StreamlineTracingGrid.hpp:75): trace centerlines, then integrate a
    ribbon right-vector along each line, rotating around the tangent with
    the local helicity angle per step.

    Returns (Trajectories, ribbon_dirs [N, P, 3] numpy): feed the
    right-vectors to `geometry.bands.build_band_tube_mesh` for elliptic
    ribbon geometry.
    """
    traj = trace_streamlines(field, settings, seeds, device)
    pos = torch.as_tensor(traj.positions, device=device)
    mask = torch.as_tensor(traj.mask, device=device)

    v = field(pos)
    vort = _vorticity(field, pos)
    speed2 = torch.clamp(torch.sum(v * v, dim=-1), min=1e-12)
    # Helicity angle per unit step (the reference rotates the ribbon by the
    # normalized helicity along the line).
    twist = torch.sum(v * vort, dim=-1) / speed2  # [N, P]
    tangents = v / torch.sqrt(speed2)[..., None]

    def unit(r):
        return r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)

    t0 = tangents[:, 0]
    helper = torch.where(
        (torch.abs(t0[:, 2]) < 0.9)[:, None],
        torch.tensor([0.0, 0.0, 1.0], device=pos.device),
        torch.tensor([1.0, 0.0, 0.0], device=pos.device),
    )
    r = unit(torch.linalg.cross(t0, helper, dim=-1))
    out = [r]
    for i in range(1, pos.shape[1]):
        t_i = tangents[:, i]
        # Re-orthogonalize against the new tangent, then twist.
        r_new = unit(r - t_i * torch.sum(r * t_i, dim=-1, keepdim=True))
        ang = twist[:, i] * settings.dt
        c = torch.cos(ang)[:, None]
        s = torch.sin(ang)[:, None]
        r_new = (r_new * c + torch.linalg.cross(t_i, r_new, dim=-1) * s
                 + t_i * torch.sum(t_i * r_new, dim=-1, keepdim=True) * (1.0 - c))
        r = torch.where(mask[:, i, None], r_new, r)
        out.append(r)
    return traj, torch.stack(out, dim=1).cpu().numpy()
