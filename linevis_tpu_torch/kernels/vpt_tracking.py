"""The path tracer's Woodcock tracking per ray (kernel R3).

`vpt_tracking` computes `trace_one` of the JAX package's `vpt_trace_rays`
(`linevis_tpu/render/vpt.py:189-278`) for its three scan modes, Delta,
Spectral Delta and Ratio tracking, which JAX writes as a vmapped `lax.scan`
over `max_events` Woodcock events (no `pl.pallas_call`). At 1080p that loop
is ~10^5 small PyTorch launches a frame, so the port gives it a kernel of its
own: on a CUDA tensor `vpt_tracking` launches `csrc/vpt_tracking.cu` (one
thread a ray until the ray dies, in persistent warps whose lanes take the
next ray as theirs die) and counts the launch in `vpt_tracking.launches`;
on a CPU tensor it runs the plain version, `vpt_tracking_reference`, a
lockstep loop over the events on the rays still alive. Both draw every
sample from jax.random's stream (`ops/threefry.py`, `csrc/threefry.cuh`)
and round every operation alike (`volume_common`), so they agree bit for
bit on the card. The grid may be dense or a block-sparse `SparseGrid`,
which the kernel reads through its table as `SparseGrid.sample` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.volume_common import (
    BRICK,
    box_intersect,
    env_map_sample,
    grid_bricks,
    phase_constants,
    sample_density,
    sample_phase,
    sky_light,
    vdiv,
)
from linevis_tpu_torch.ops import threefry

__all__ = ["VptParams", "vpt_params", "vpt_tracking", "vpt_tracking_reference", "grid_bricks",
           "BRICK", "threefry_device", "SCAN_MODES", "INTERPOLATIONS"]

SCAN_MODES = ("Delta Tracking", "Spectral Delta Tracking", "Ratio Tracking")
INTERPOLATIONS = ("Trilinear", "Nearest", "Stochastic")


@dataclasses.dataclass(frozen=True)
class VptParams:
    """A trace's constants, float32 values held as Python floats."""

    mode: str
    interpolation: str
    max_events: int
    b_min: Tuple[float, float, float]
    b_max: Tuple[float, float, float]
    extent: Tuple[float, float, float]
    extinction: Tuple[float, float, float]
    abs_ext: Tuple[float, float, float]  # (1 - albedo) * extinction
    scat_ext: Tuple[float, float, float]  # albedo * extinction
    majorant: float
    phase: dict
    sun_dir: Tuple[float, float, float]
    sun_ic: Tuple[float, float, float]
    env_intensity: float

    def array(self) -> np.ndarray:
        """The kernel's parameter block (`csrc/vpt_tracking.cu` P_*)."""
        pc = self.phase
        vals = [*self.b_min, *self.b_max, *self.extent, *self.extinction, *self.abs_ext,
                *self.scat_ext, self.majorant, float(pc["isotropic"]), pc["one_minus_g2"],
                pc["one_minus_g"], pc["two_g"], pc["half_over_g"], pc["one_plus_g2"],
                *self.sun_dir, *self.sun_ic, self.env_intensity]
        return np.asarray(vals, np.float32)


def vpt_params(grid_shape, extinction, albedo, sun_dir, sun_ic, phase_g: float, mode: str,
               max_events: int, interpolation: str, env_intensity: float = 1.0) -> VptParams:
    """The constants of `vpt_trace_rays` rounded as the JAX function rounds
    them: the grid box (`grid_box`), (1 - albedo) * extinction, albedo *
    extinction and the majorant (the largest extinction for Spectral Delta
    tracking, else the first), in float32."""
    from linevis_tpu_torch.trace.scattering import grid_box

    if mode not in SCAN_MODES:
        raise ValueError(f"vpt_tracking runs {SCAN_MODES}, not {mode!r}")
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"interpolation {interpolation!r}")
    f = np.float32
    b_min, b_max = grid_box(grid_shape)
    ext = np.asarray(extinction, f)
    alb = np.asarray(albedo, f)
    maj = f(ext.max()) if mode == "Spectral Delta Tracking" else f(ext[0])

    def t3(v):
        return tuple(float(x) for x in np.asarray(v, f))

    return VptParams(
        mode=mode, interpolation=interpolation, max_events=int(max_events),
        b_min=t3(b_min), b_max=t3(b_max), extent=t3(b_max - b_min), extinction=t3(ext),
        abs_ext=t3((f(1.0) - alb) * ext), scat_ext=t3(alb * ext), majorant=float(maj),
        phase=phase_constants(float(phase_g)), sun_dir=t3(sun_dir), sun_ic=t3(sun_ic),
        env_intensity=float(f(env_intensity)))


def vpt_tracking_reference(grid, origins: torch.Tensor, dirs: torch.Tensor, key: torch.Tensor,
                           p: VptParams, env: Optional[torch.Tensor] = None,
                           events: Optional[torch.Tensor] = None, first: int = 0,
                           scatters: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel (the contract of `vpt_tracking`).
    `grid` may also be a `scene/sparse_grid.py:SparseGrid`. The loop takes
    one event a step on the rays still alive; a dead ray's state stays as
    it is, as in the JAX scan."""
    dev = origins.device
    N = origins.shape[0]
    keys = threefry.split_at(key.to(dev), first + torch.arange(N, device=dev))
    o = origins.unbind(1)
    w0 = dirs.unbind(1)
    t_min, t_max, hit = box_intersect(p.b_min, p.b_max, o, w0)
    x = torch.stack([o[i] + w0[i] * t_min for i in range(3)], 1)
    w = dirs.clone()
    d = torch.where(hit, t_max - t_min, torch.full_like(t_max, -1.0))
    wt = torch.ones((N, 3), dtype=torch.float32, device=dev)
    absorbed = torch.zeros(N, dtype=torch.bool, device=dev)
    first_x = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    first_has = torch.zeros(N, dtype=torch.bool, device=dev)
    ev = torch.zeros(N, dtype=torch.int32, device=dev)
    n_sc = torch.zeros(N, dtype=torch.int32, device=dev)
    spectral = p.mode == "Spectral Delta Tracking"
    ratio = p.mode == "Ratio Tracking"
    stochastic = p.interpolation == "Stochastic"
    maj = torch.full((), p.majorant, dtype=torch.float32, device=dev)
    idx = torch.nonzero(hit).reshape(-1)
    for j in range(p.max_events):
        if idx.numel() == 0:
            break
        ev[idx] += 1
        k = threefry.split_at(keys[idx], j)
        ks = threefry.split(k, 4 if stochastic else 3)
        u = threefry.uniform_at(ks[:, :2])
        u1, xi = u[:, 0], u[:, 1]
        t = -torch.log(torch.clamp(1.0 - u1, min=1e-10)) / maj
        go = ~(t > d[idx])  # rays that leave stay as they are, dead
        idx, t, xi, k, ks = idx[go], t[go], xi[go], k[go], ks[go]
        xs, ws, ds = x[idx].unbind(1), w[idx].unbind(1), d[idx]
        xn = tuple(xs[i] + ws[i] * t for i in range(3))
        tp = tuple(vdiv(xn[i] - p.b_min[i], p.extent[i]) for i in range(3))
        jitter = threefry.uniform(ks[:, 3], (3,)).unbind(1) if stochastic else None
        dens = sample_density(grid, tp, p.interpolation, jitter)
        sa = [p.abs_ext[c] * dens for c in range(3)]
        ss = [p.scat_ext[c] * dens for c in range(3)]
        sn = [p.majorant - p.extinction[c] * dens for c in range(3)]
        wts = wt[idx].unbind(1)
        if spectral:
            pa, ps, pn = (vdiv(s[0] * wts[0] + s[1] * wts[1] + s[2] * wts[2], 3.0)
                          for s in (sa, ss, sn))
            cs = torch.clamp(pa + ps + pn, min=1e-20)
            pa, ps, pn = pa / cs, ps / cs, pn / cs
        else:
            pa, ps, pn = sa[0] / maj, ss[0] / maj, sn[0] / maj
        absorb = xi < pa
        scatter = (~absorb) & (xi < 1.0 - pn)
        if ratio:
            wt[idx] = torch.stack([wts[c] * (1.0 - pa) for c in range(3)], 1)
            absorb = torch.zeros_like(absorb)
            scatter = xi < 1.0 - pn
        elif spectral:
            den = torch.where(scatter, torch.clamp(maj * ps, min=1e-20),
                              torch.clamp(maj * pn, min=1e-20))
            wt[idx] = torch.stack([torch.clamp(wts[c] * torch.where(scatter, ss[c], sn[c]) / den,
                                               max=100.0) for c in range(3)], 1)
        # Null collisions (and absorptions) move on; scatters turn.
        d[idx] = ds - t
        x[idx] = torch.stack(xn, 1)
        sc = torch.nonzero(scatter).reshape(-1)
        if sc.numel():
            isc = idx[sc]
            n_sc[isc] += 1
            kp = threefry.split(ks[sc, 2], 2)
            up = threefry.uniform_at(kp)
            xs_sc = tuple(c[sc] for c in xn)
            wn = sample_phase(up[:, 0], up[:, 1], p.phase, tuple(c[sc] for c in ws))
            t2_min, t2_max, hit2 = box_intersect(p.b_min, p.b_max, xs_sc, wn)
            d[isc] = torch.where(hit2, t2_max - t2_min, torch.zeros_like(t2_max))
            x[isc] = torch.stack([torch.where(hit2, xs_sc[i] + wn[i] * t2_min, xs_sc[i])
                                  for i in range(3)], 1)
            w[isc] = torch.stack(wn, 1)
            rec = ~first_has[isc]
            first_x[isc[rec]] = torch.stack(xs_sc, 1)[rec]
            first_has[isc[rec]] = True
        absorbed[idx[absorb]] = True
        idx = idx[~absorb]
    wf = w.unbind(1)
    bg = (env_map_sample(env, wf, p.env_intensity) if env is not None
          else sky_light(wf, p.sun_dir, p.sun_ic))
    wt = torch.clamp(wt, max=1e5)
    rad = torch.stack([wt[:, c] * bg[c] for c in range(3)], 1)
    rad = torch.where(absorbed[:, None], torch.zeros_like(rad), rad)
    if events is not None:
        events.copy_(ev)
    if scatters is not None:
        scatters.copy_(n_sc)
    return rad, first_x, first_has


def _launcher(name):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _build.load("vpt_tracking")
    if name == "vpt":
        fn = lib.vpt_tracking_launch
        fn.argtypes = [p, p, i, i, i, i, p, p, p, i, i, i, i, i, p, p, i, i, p, p, p, p, p, p, p]
    else:
        fn = lib.threefry_launch
        fn.argtypes = [p, i, i, ctypes.c_uint, p, p]
    fn.restype = ctypes.c_int
    return fn


def vpt_tracking(grid, origins: torch.Tensor, dirs: torch.Tensor,
                 key: torch.Tensor, p: VptParams, env: Optional[torch.Tensor] = None,
                 events: Optional[torch.Tensor] = None, first: int = 0,
                 scatters: Optional[torch.Tensor] = None):
    """Trace rays through the density grid -> (radiance [N, 3], first
    scatter position [N, 3], first scatter flag [N] bool).

    grid [Z, Y, X] float32 (dense; the kernel reads `grid_bricks(grid)`,
    made at its first launch on the grid) or a `scene/sparse_grid.py:
    SparseGrid` (the kernel reads its bricks through its table, as
    `SparseGrid.sample` does), origins and dirs [N, 3] float32
    (unit dirs), key [2] int64: the trace's threefry key `kt`, of which ray i
    takes `split(kt, .)[first + i]` (as `vpt_trace_rays` keys its rays;
    `first` lets a call trace a slice of a larger set), `p` from
    `vpt_params`, env an optional [He, We, 3]
    environment map (else the procedural sky and sun). `events`, an
    optional int32 [N] tensor, receives the events each ray ran (the step
    at which it died, or max_events); `scatters`, likewise, the events at
    which it scattered. A CUDA tensor launches the kernel; a CPU tensor runs
    the plain version."""
    if origins.device.type == "cpu":
        return vpt_tracking_reference(grid, origins, dirs, key, p, env, events, first, scatters)
    if origins.device.type != "cuda":
        raise ValueError(f"vpt_tracking: unsupported device {origins.device}")
    dev = origins.device
    N = origins.shape[0]
    sparse = hasattr(grid, "table")
    if sparse:
        if (grid.bricks.dtype != torch.float32 or grid.bricks.device != dev
                or grid.table.dtype != torch.int32 or grid.table.device != dev):
            raise ValueError("a SparseGrid's float32 bricks and int32 table must be on the rays' "
                             "device")
        g, table, block = grid.bricks.contiguous(), grid.table.contiguous(), int(grid.block)
    elif grid.dim() != 3 or grid.dtype != torch.float32 or grid.device != dev:
        raise ValueError("grid must be a dense float32 [Z, Y, X] tensor on the rays' device")
    else:
        g, table, block = grid_bricks(grid), None, 0
    for name, x, dt, shape in (("origins", origins, torch.float32, (N, 3)),
                               ("dirs", dirs, torch.float32, (N, 3)),
                               ("key", key, torch.int64, (2,))):
        if x.dtype != dt or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dt} {shape} on {dev}")
    if env is not None and (env.dim() != 3 or env.shape[2] != 3 or env.device != dev):
        raise ValueError("env must be a [He, We, 3] tensor on the rays' device")
    ins = [origins.contiguous(), dirs.contiguous(), key.to(torch.int32).contiguous()]
    prm = p.array()  # host memory: the launch passes it by value
    envc = None if env is None else env.float().contiguous()
    rad = torch.empty((N, 3), dtype=torch.float32, device=dev)
    fx = torch.empty((N, 3), dtype=torch.float32, device=dev)
    fh = torch.empty(N, dtype=torch.uint8, device=dev)
    ev = None if events is None else torch.empty(N, dtype=torch.int32, device=dev)
    n_sc = None if scatters is None else torch.empty(N, dtype=torch.int32, device=dev)
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the kernel's ray counter
    with torch.cuda.device(dev):
        rc = _launcher("vpt")(
            g.data_ptr(), None if table is None else table.data_ptr(), block,
            *(int(n) for n in grid.shape), *(x.data_ptr() for x in ins), first,
            N, p.max_events, SCAN_MODES.index(p.mode), INTERPOLATIONS.index(p.interpolation),
            prm.ctypes.data, None if envc is None else envc.data_ptr(),
            0 if envc is None else envc.shape[0], 0 if envc is None else envc.shape[1],
            rad.data_ptr(), fx.data_ptr(), fh.data_ptr(), None if ev is None else ev.data_ptr(),
            None if n_sc is None else n_sc.data_ptr(), nxt.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_tracking kernel launch failed: CUDA error {rc}")
    vpt_tracking.launches += 1
    if events is not None:
        events.copy_(ev)
    if scatters is not None:
        scatters.copy_(n_sc)
    return rad, fx, fh.bool()


vpt_tracking.launches = 0


def threefry_device(keys: torch.Tensor, op: str, counter: int) -> torch.Tensor:
    """The device threefry (`csrc/threefry.cuh`) on CUDA keys [n, 2] int64:
    op "split" -> split(key, .)[counter] [n, 2] int64, op "uniform" ->
    element `counter` of uniform(key, .) [n] float32."""
    if keys.device.type != "cuda":
        raise ValueError("threefry_device runs on the card")
    n = keys.shape[0]
    words = keys.to(torch.int32).contiguous()
    out = torch.empty((n, 2) if op == "split" else (n,), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        rc = _launcher("threefry")(words.data_ptr(), n, 0 if op == "split" else 1, counter,
                                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {rc}")
    if op == "split":
        return out.long() & 0xFFFFFFFF
    return out.view(torch.float32)
