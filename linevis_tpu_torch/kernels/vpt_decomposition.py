"""The path tracer's decomposition tracking per ray (kernel R7).

`vpt_decomposition` computes `trace_one` of the JAX package's
`_decomposition_trace` (`linevis_tpu/render/vpt.py:342-473`, Kutz et al.
2017), which JAX writes as a vmapped `lax.scan` over `max_events` events
(no `pl.pallas_call`): per super voxel a homogeneous control component
mu_c = extinction x min density is tracked analytically and only the
residual is sampled, against mu_r = extinction x max density - mu_c; empty
super voxels are skipped. On a CUDA tensor `vpt_decomposition` launches
`csrc/vpt_decomposition.cu` (persistent warps that refill their lanes from a
counter, one thread a ray until the ray dies) and counts the launch in
`vpt_decomposition.launches`; on a CPU tensor it runs the
plain version, `vpt_decomposition_reference`, a lockstep loop over the
events on the rays still alive. Both draw every sample from jax.random's
stream (`ops/threefry.py`, `csrc/threefry.cuh`) and round every operation
alike (`volume_common`), so they agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.volume_common import (
    box_intersect,
    env_map_sample,
    grid_bricks,
    phase_constants,
    sample_phase,
    sky_light,
    trilinear,
    vdiv,
)
from linevis_tpu_torch.ops import threefry

__all__ = ["DecompositionParams", "decomposition_params", "vpt_decomposition",
           "vpt_decomposition_reference", "EVENT_KINDS"]

# The columns of `kinds`: columns 0-5 partition the events (they sum to
# `events`); column 6 counts the collisions (absorbs and scatters) whose
# residual candidate was tested against the density first.
EVENT_KINDS = ("skip", "enter", "residual", "residual_tested", "absorb", "scatter",
               "tested_collision")

F3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class DecompositionParams:
    """A trace's constants, float32 values held as Python floats."""

    max_events: int
    b_min: F3
    b_max: F3
    extent: F3
    cell: F3  # a super voxel's extent
    sv_n: F3  # super voxels along x, y, z
    majorant: float  # extinction[0]
    abs_albedo: float  # 1 - albedo[0]
    phase: dict
    sun_dir: F3
    sun_ic: F3
    env_intensity: float

    def array(self) -> np.ndarray:
        """The kernel's parameter block (`csrc/vpt_decomposition.cu` Q_*)."""
        pc = self.phase
        vals = [*self.b_min, *self.b_max, *self.extent, *self.cell, *self.sv_n, self.majorant,
                self.abs_albedo, float(pc["isotropic"]), pc["one_minus_g2"], pc["one_minus_g"],
                pc["two_g"], pc["half_over_g"], pc["one_plus_g2"], *self.sun_dir, *self.sun_ic,
                self.env_intensity]
        return np.asarray(vals, np.float32)


def decomposition_params(grid_shape, sv_shape, extinction, albedo, sun_dir, sun_ic,
                         phase_g: float, max_events: int,
                         env_intensity: float = 1.0) -> DecompositionParams:
    """The constants of `_decomposition_trace` rounded as it rounds them:
    the grid box (`grid_box`), the super voxels' extent (box extent / their
    count, in float32), extinction[0] and 1 - albedo[0]. `sv_shape` is the
    [Sz, Sy, Sx] shape of the super-voxel min/max grids."""
    from linevis_tpu_torch.trace.scattering import grid_box

    f = np.float32
    b_min, b_max = grid_box(grid_shape)
    extent = b_max - b_min
    Sz, Sy, Sx = sv_shape
    sv_n = np.asarray([Sx, Sy, Sz], f)

    def t3(v):
        return tuple(float(x) for x in np.asarray(v, f))

    return DecompositionParams(
        max_events=int(max_events), b_min=t3(b_min), b_max=t3(b_max), extent=t3(extent),
        cell=t3(extent / sv_n), sv_n=t3(sv_n), majorant=float(f(np.asarray(extinction, f)[0])),
        abs_albedo=float(f(1.0) - f(np.asarray(albedo, f)[0])),
        phase=phase_constants(float(phase_g)), sun_dir=t3(sun_dir), sun_ic=t3(sun_ic),
        env_intensity=float(f(env_intensity)))


def vpt_decomposition_reference(grid: torch.Tensor, dmin_g: torch.Tensor, dmax_g: torch.Tensor,
                                origins: torch.Tensor, dirs: torch.Tensor, key: torch.Tensor,
                                p: DecompositionParams, env: Optional[torch.Tensor] = None,
                                events: Optional[torch.Tensor] = None, first: int = 0,
                                kinds: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel (the contract of
    `vpt_decomposition`). Each event either enters a super voxel (draws
    the control flight, or skips it if empty) or takes one residual
    collision candidate; a scatter re-enters the super voxel of its point
    with the new direction (DecompositionTracking.glsl:35-130). The loop
    takes one event a step on the rays alive; a dead ray's state stays as
    it is, as in the JAX scan."""
    majorant = p.majorant
    abs_albedo = p.abs_albedo
    pc = p.phase
    sv_n, b_min, b_max, extent, cell = p.sv_n, p.b_min, p.b_max, p.extent, p.cell
    N = origins.shape[0]
    dev = origins.device
    keys = threefry.split_at(key.to(dev), first + torch.arange(N, device=dev))
    o, w0 = origins.float().unbind(1), dirs.float().unbind(1)
    t_min, _, hit = box_intersect(b_min, b_max, o, w0)
    t_in = t_min + 1e-6
    x = torch.stack([o[i] + w0[i] * t_in for i in range(3)], 1)
    idx = torch.stack([torch.clamp(torch.floor(vdiv(x[:, i] - b_min[i], cell[i])), 0.0,
                                   sv_n[i] - 1.0) for i in range(3)], 1)
    w = dirs.float().clone()
    t_c = torch.zeros(N, dtype=torch.float32, device=dev)
    t_r = torch.zeros(N, dtype=torch.float32, device=dev)
    in_sv = torch.zeros(N, dtype=torch.bool, device=dev)
    absorbed = torch.zeros(N, dtype=torch.bool, device=dev)
    ev = torch.zeros(N, dtype=torch.int32, device=dev)
    kind = torch.zeros((N, len(EVENT_KINDS)), dtype=torch.int32, device=dev)
    live = torch.nonzero(hit).reshape(-1)
    for j in range(p.max_events):
        if live.numel() == 0:
            break
        ev[live] += 1
        ks = threefry.split(threefry.split_at(keys[live], j), 5)
        u = threefry.uniform_at(ks[:, :4])
        xs, ws, ids = x[live].unbind(1), w[live].unbind(1), idx[live].unbind(1)
        tc, tr, isv = t_c[live], t_r[live], in_sv[live]
        ix = [torch.clamp(ids[i], 0.0, sv_n[i] - 1.0).to(torch.int32).long() for i in range(3)]
        d_min = dmin_g[ix[2], ix[1], ix[0]]
        d_max = dmax_g[ix[2], ix[1], ix[0]]
        mu_c = torch.clamp(majorant * d_min, min=1e-10)
        mu_r = torch.clamp(majorant * d_max - mu_c, min=1e-10)
        # The distance to the super voxel's exit face and that face's axis.
        t_far = []
        for i in range(3):
            lo = b_min[i] + ids[i] * cell[i]
            hi = lo + cell[i]
            small = torch.abs(ws[i]) < 1e-9
            safe_w = torch.where(small, torch.full_like(ws[i], 1e-9), ws[i])
            tf = torch.maximum((lo - xs[i]) / safe_w, (hi - xs[i]) / safe_w)
            t_far.append(torch.where(small, torch.full_like(tf, 1e30), tf))
        a0 = (t_far[0] <= t_far[1]) & (t_far[0] <= t_far[2])
        a1 = (~a0) & (t_far[1] <= t_far[2])
        axis = [a0, a1, (~a0) & (~a1)]
        d_seg = torch.clamp(torch.minimum(torch.minimum(t_far[0], t_far[1]), t_far[2]), min=0.0)
        empty = d_max < 1e-5
        enter = ~isv
        t_c0 = -torch.log(torch.clamp(1.0 - u[:, 0], min=1e-10)) / mu_c
        t_r_new = tr - torch.log(torch.clamp(1.0 - u[:, 1], min=1e-10)) / mu_r
        seg_done = (tc >= d_seg) & (t_r_new >= d_seg)
        t_hit = torch.minimum(tc, t_r_new)
        xh = tuple(xs[i] + ws[i] * t_hit for i in range(3))
        dens = trilinear(grid, tuple(vdiv(xh[i] - b_min[i], extent[i]) for i in range(3)))
        control_hit = tc <= t_r_new
        residual_hit = u[:, 2] * mu_r < majorant * dens - mu_c
        collision = (~enter) & (~seg_done) & (control_hit | residual_hit)
        absorb = collision & (u[:, 3] < abs_albedo)
        scatter = collision & ~absorb
        advance = (enter & empty) | ((~enter) & seg_done)
        if kinds is not None:
            kind[live] += torch.stack(
                [enter & empty, enter & ~empty, ~enter & seg_done,
                 ~enter & ~seg_done & ~collision, absorb, scatter, collision & ~control_hit],
                1).to(torch.int32)
        step = d_seg + 1e-6
        x_adv = tuple(xs[i] + ws[i] * step for i in range(3))
        idx_adv = [ids[i] + torch.sign(ws[i]) * axis[i].float() for i in range(3)]
        out = torch.zeros_like(advance)
        for i in range(3):
            out = out | (idx_adv[i] < 0.0) | (idx_adv[i] >= sv_n[i])
        exited = advance & out
        x_new = [torch.where(scatter, xh[i], torch.where(advance, x_adv[i], xs[i]))
                 for i in range(3)]
        idx_new = [torch.where(advance, idx_adv[i], ids[i]) for i in range(3)]
        w_new = list(ws)
        sc = torch.nonzero(scatter).reshape(-1)
        if sc.numel():
            up = threefry.uniform_at(threefry.split(ks[sc, 4], 2))
            wn = sample_phase(up[:, 0], up[:, 1], pc, tuple(c[sc] for c in ws))
            for i in range(3):
                w_new[i] = w_new[i].index_put((sc,), wn[i])
                cell_i = torch.clamp(torch.floor(vdiv(xh[i][sc] - b_min[i], cell[i])), 0.0,
                                     sv_n[i] - 1.0)
                idx_new[i] = idx_new[i].index_put((sc,), cell_i)
        x[live] = torch.stack(x_new, 1)
        w[live] = torch.stack(w_new, 1)
        idx[live] = torch.stack(idx_new, 1)
        in_sv[live] = torch.where(enter, ~empty, ~(seg_done | scatter))
        t_c[live] = torch.where(enter, t_c0, tc)
        t_r[live] = torch.where(enter | collision, torch.zeros_like(t_r_new), t_r_new)
        absorbed[live[absorb]] = True
        live = live[~absorb & ~exited]
    wf = w.unbind(1)
    bg = (env_map_sample(env, wf, p.env_intensity) if env is not None
          else sky_light(wf, p.sun_dir, p.sun_ic))
    rad = torch.stack(bg, 1)
    rad = torch.where(absorbed[:, None], torch.zeros_like(rad), rad)
    if events is not None:
        events.copy_(ev)
    if kinds is not None:
        kinds.copy_(kind)
    return (rad, torch.zeros((N, 3), dtype=torch.float32, device=dev),
            torch.zeros(N, dtype=torch.bool, device=dev))


def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.load("vpt_decomposition").vpt_decomposition_launch
    fn.argtypes = [p, i, i, i, p, p, i, i, i, p, p, p, i, i, i, p, p, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def vpt_decomposition(grid: torch.Tensor, dmin_g: torch.Tensor, dmax_g: torch.Tensor,
                      origins: torch.Tensor, dirs: torch.Tensor, key: torch.Tensor,
                      p: DecompositionParams, env: Optional[torch.Tensor] = None,
                      events: Optional[torch.Tensor] = None, first: int = 0,
                      kinds: Optional[torch.Tensor] = None):
    """Trace rays by decomposition tracking -> (radiance [N, 3], first
    scatter position [N, 3] (zeros), first scatter flag [N] (False), as the
    JAX function returns them).

    grid [Z, Y, X] float32 (dense; the kernel reads `grid_bricks(grid)`),
    dmin_g and dmax_g [Sz, Sy, Sx] float32 the per-super-voxel min and max
    density (`render/super_voxel.py:build_super_voxel_minmax`), origins and
    dirs [N, 3] float32 (unit dirs), key [2] int64: the trace's threefry key
    `kt`, of which ray i takes `split(kt, .)[first + i]`, `p` from
    `decomposition_params`, env an optional [He, We, 3] environment map
    (else the procedural sky and sun). `events`, an optional int32 [N]
    tensor, receives the events each ray ran, and `kinds`, an optional int32
    [N, 7] tensor, its events by kind (`EVENT_KINDS`). A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version."""
    if origins.device.type == "cpu":
        return vpt_decomposition_reference(grid, dmin_g, dmax_g, origins, dirs, key, p, env,
                                           events, first, kinds)
    if origins.device.type != "cuda":
        raise ValueError(f"vpt_decomposition: unsupported device {origins.device}")
    dev = origins.device
    N = origins.shape[0]
    if grid.dim() != 3 or grid.dtype != torch.float32 or grid.device != dev:
        raise ValueError("grid must be a dense float32 [Z, Y, X] tensor on the rays' device")
    for name, x, dt, shape in (("origins", origins, torch.float32, (N, 3)),
                               ("dirs", dirs, torch.float32, (N, 3)),
                               ("key", key, torch.int64, (2,)),
                               ("dmin_g", dmin_g, torch.float32, tuple(dmax_g.shape)),
                               ("dmax_g", dmax_g, torch.float32, tuple(dmin_g.shape))):
        if x.dtype != dt or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dt} {shape} on {dev}")
    if dmin_g.dim() != 3 or tuple(float(n) for n in dmin_g.shape[::-1]) != p.sv_n:
        raise ValueError("the super-voxel grids do not match the parameters' sv_n")
    if env is not None and (env.dim() != 3 or env.shape[2] != 3 or env.device != dev):
        raise ValueError("env must be a [He, We, 3] tensor on the rays' device")
    g = grid_bricks(grid)
    ins = [origins.contiguous(), dirs.contiguous(), key.to(torch.int32).contiguous()]
    dmn, dmx = dmin_g.contiguous(), dmax_g.contiguous()
    prm = p.array()  # host memory: the launch passes it by value
    envc = None if env is None else env.float().contiguous()
    rad = torch.empty((N, 3), dtype=torch.float32, device=dev)
    ev = None if events is None else torch.empty(N, dtype=torch.int32, device=dev)
    kd = None if kinds is None else torch.zeros((N, len(EVENT_KINDS)), dtype=torch.int32,
                                                device=dev)
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the rays taken
    with torch.cuda.device(dev):
        rc = _launcher()(
            g.data_ptr(), *grid.shape, dmn.data_ptr(), dmx.data_ptr(), *dmn.shape,
            *(x.data_ptr() for x in ins), first, N, p.max_events, prm.ctypes.data,
            None if envc is None else envc.data_ptr(), 0 if envc is None else envc.shape[0],
            0 if envc is None else envc.shape[1], rad.data_ptr(),
            None if ev is None else ev.data_ptr(), None if kd is None else kd.data_ptr(),
            nxt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_decomposition kernel launch failed: CUDA error {rc}")
    vpt_decomposition.launches += 1
    if events is not None:
        events.copy_(ev)
    if kinds is not None:
        kinds.copy_(kd)
    return (rad, torch.zeros((N, 3), dtype=torch.float32, device=dev),
            torch.zeros(N, dtype=torch.bool, device=dev))


vpt_decomposition.launches = 0
