"""Streamline tracer: all seeds advance in lockstep on the device.

Counterpart of `linevis_tpu/trace/streamline.py` (behavioral reference
`src/LineData/Flow/StreamlineTracingGrid.{hpp,cpp}`). The JAX package runs
the fixed-step integration as one `lax.scan`; here it is a Python loop over
steps whose body is a handful of elementwise ops on [N, 3] tensors.

Ported: the fixed-step integrators, the bounds test and the speed
termination, and the derived attributes (velocity magnitude, vorticity
magnitude, helicity). Not ported yet: proximity/loop termination, adaptive
RKF45 and streamribbons; their settings fields stay and raise
`NotImplementedError` when set.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from linevis_tpu_torch.core.trajectories import Trajectories

__all__ = ["StreamlineTracingSettings", "trace_streamlines"]

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
    # Adaptive RKF45: not ported yet.
    adaptive: bool = False
    tolerance: float = 1e-5
    dt_min: float = 1.0 / 2048.0
    dt_max: float = 1.0 / 32.0
    # Self-proximity / loop termination: not ported yet (0 disables).
    termination_distance: float = 0.0
    loop_min_gap: int = 10


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
        # Fixed-step Fehlberg 4(5), 5th-order solution.
        k1 = field(p)
        k2 = field(p + dt * (k1 / 4.0))
        k3 = field(p + dt * (3.0 / 32.0 * k1 + 9.0 / 32.0 * k2))
        k4 = field(
            p + dt * (1932.0 / 2197.0 * k1 - 7200.0 / 2197.0 * k2 + 7296.0 / 2197.0 * k3)
        )
        k5 = field(
            p
            + dt
            * (439.0 / 216.0 * k1 - 8.0 * k2 + 3680.0 / 513.0 * k3 - 845.0 / 4104.0 * k4)
        )
        k6 = field(
            p
            + dt
            * (
                -8.0 / 27.0 * k1
                + 2.0 * k2
                - 3544.0 / 2565.0 * k3
                + 1859.0 / 4104.0 * k4
                - 11.0 / 40.0 * k5
            )
        )
        return p + dt * (
            16.0 / 135.0 * k1
            + 6656.0 / 12825.0 * k3
            + 28561.0 / 56430.0 * k4
            - 9.0 / 50.0 * k5
            + 2.0 / 55.0 * k6
        )
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


def _trace_batch(
    field: Callable, settings: StreamlineTracingSettings, seeds: torch.Tensor
):
    """Fixed-step integration -> (positions [N, steps+1, 3], mask [N, steps+1])."""
    dt = (1.0 if settings.forward else -1.0) * settings.dt
    p = seeds
    alive = torch.ones(seeds.shape[:-1], dtype=torch.bool, device=seeds.device)
    positions = [seeds]
    masks = [alive]
    for _ in range(settings.max_steps):
        p_new = _step(field, p, dt, settings.integrator)
        in_bounds = torch.all((p_new >= 0.0) & (p_new <= 1.0), dim=-1)
        speed = torch.linalg.norm(field(p_new), dim=-1)
        alive = alive & in_bounds & (speed > settings.terminate_speed)
        p = torch.where(alive[..., None], p_new, p)
        positions.append(p)
        masks.append(alive)
    return torch.stack(positions, dim=1), torch.stack(masks, dim=1)


def _derived_attributes(field: Callable, positions: torch.Tensor) -> torch.Tensor:
    """[Velocity Magnitude, Vorticity Magnitude, Helicity] -> [N, 3, P]."""
    v = field(positions)
    vel_mag = torch.linalg.norm(v, dim=-1)
    vort = _vorticity(field, positions)
    vort_mag = torch.linalg.norm(vort, dim=-1)
    helicity = torch.sum(v * vort, dim=-1)
    return torch.stack([vel_mag, vort_mag, helicity], dim=1)


def trace_streamlines(
    field: Callable[[torch.Tensor], torch.Tensor],
    settings: StreamlineTracingSettings = StreamlineTracingSettings(),
    seeds: Optional[torch.Tensor] = None,
    device="cuda",
) -> Trajectories:
    """Trace streamlines through an analytic velocity field on `device`.

    seeds: [N, 3] in [0,1]^3 (tensor or array); None draws
    `settings.num_seeds` uniform seeds from `np.random.default_rng(settings.seed)`.
    Returns host `Trajectories` with attributes
    [Velocity Magnitude, Vorticity Magnitude, Helicity].
    """
    if settings.adaptive:
        raise NotImplementedError("adaptive RKF45 is not ported yet")
    if settings.termination_distance > 0.0:
        raise NotImplementedError("proximity/loop termination is not ported yet")
    if seeds is None:
        rng = np.random.default_rng(settings.seed)
        seeds = rng.uniform(size=(settings.num_seeds, 3)).astype(np.float32)
    seeds = torch.as_tensor(seeds, dtype=torch.float32, device=device)
    positions, mask = _trace_batch(field, settings, seeds)
    attributes = _derived_attributes(field, positions)
    mask = mask.cpu().numpy()
    return Trajectories(
        positions=positions.cpu().numpy(),
        attributes=attributes.cpu().numpy(),
        mask=mask,
        num_points=np.asarray(mask.sum(axis=1), np.int32),
        attribute_names=[
            "Velocity Magnitude", "Vorticity Magnitude", "Helicity"
        ],
    )
