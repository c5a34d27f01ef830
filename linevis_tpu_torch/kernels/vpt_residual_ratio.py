"""The path tracer's residual ratio tracking per ray (kernel R8).

`vpt_residual_ratio` computes `trace_one` of the JAX package's
`_residual_ratio_trace` (`linevis_tpu/render/vpt.py:281-339`, Novák et al.
2014): up to 11 bounces in a `lax.while_loop`, each the super-voxel DDA of
`linevis_tpu/render/super_voxel.py:162-236` (a `lax.scan`) whose every step
is the residual estimator `_rr_segment` (`:114-159`, a `lax.while_loop`),
vmapped over the rays; no `pl.pallas_call`. `rr_transmittance` is one DDA
of it, albedo 0 (`residual_ratio_transmittance`). On a CUDA tensor both
launch `csrc/vpt_residual_ratio.cu` (persistent warps that refill their lanes
from a counter, one thread a ray, the whole estimator in registers) and
count the launch in `vpt_residual_ratio.launches`; on a
CPU tensor they run the plain version, `vpt_residual_ratio_reference` (and
`rr_transmittance_reference`) over `render/super_voxel.py:
make_residual_ratio_tracer` and `_rr_segments`: lockstep loops over the
bounces, the super voxels and the residual steps of the rays not yet done.
Both draw every sample from jax.random's stream (`ops/threefry.py`,
`csrc/threefry.cuh`) and round every operation alike (`volume_common`), so
they agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.volume_common import (
    env_map_sample,
    grid_bricks,
    phase_constants,
    sample_phase,
    sky_light,
)
from linevis_tpu_torch.ops import threefry

__all__ = ["RrParams", "rr_params", "vpt_residual_ratio", "vpt_residual_ratio_reference",
           "rr_transmittance", "rr_transmittance_reference"]

F3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class RrParams:
    """A trace's constants, float32 values held as Python floats."""

    max_iterations: int  # bounces after the first (glsl:216)
    max_sv_steps: int  # the DDA's steps a bounce
    max_steps_per_sv: int  # residual steps a super voxel
    b_min: F3
    b_max: F3
    extent: F3
    cell: F3  # a super voxel's extent
    sv_n: F3  # super voxels along x, y, z
    extinction: float  # extinction[0]
    albedo: float  # albedo[0] (the reservoir's sigma_s / sigma_t)
    phase: dict
    sun_dir: F3
    sun_ic: F3
    env_intensity: float

    def array(self) -> np.ndarray:
        """The kernel's parameter block (`csrc/vpt_residual_ratio.cu` R_*)."""
        pc = self.phase
        vals = [*self.b_min, *self.b_max, *self.extent, *self.cell, *self.sv_n, self.extinction,
                self.albedo, float(pc["isotropic"]), pc["one_minus_g2"], pc["one_minus_g"],
                pc["two_g"], pc["half_over_g"], pc["one_plus_g2"], *self.sun_dir, *self.sun_ic,
                self.env_intensity]
        return np.asarray(vals, np.float32)


def rr_params(grid_shape, sv_shape, extinction, albedo, sun_dir=(0.0, 1.0, 0.0),
              sun_ic=(0.0, 0.0, 0.0), phase_g: float = 0.0, env_intensity: float = 1.0,
              max_iterations: int = 10, max_sv_steps: int = 64,
              max_steps_per_sv: int = 256) -> RrParams:
    """The constants of `make_residual_ratio_tracer` and
    `_residual_ratio_trace` rounded as they round them: the grid box
    (`grid_box`), the super voxels' extent (box extent / their count, in
    float32), extinction[0] and albedo[0] in float32 (scalars are taken as
    they are). `sv_shape` is the [Sz, Sy, Sx] shape of the
    `SuperVoxelGrid`."""
    from linevis_tpu_torch.trace.scattering import grid_box

    f = np.float32
    b_min, b_max = grid_box(grid_shape)
    extent = b_max - b_min
    Sz, Sy, Sx = sv_shape
    sv_n = np.asarray([Sx, Sy, Sz], f)

    def t3(v):
        return tuple(float(x) for x in np.asarray(v, f))

    return RrParams(
        max_iterations=int(max_iterations), max_sv_steps=int(max_sv_steps),
        max_steps_per_sv=int(max_steps_per_sv), b_min=t3(b_min), b_max=t3(b_max),
        extent=t3(extent), cell=t3(extent / sv_n), sv_n=t3(sv_n),
        extinction=float(f(np.asarray(extinction, f).reshape(-1)[0])),
        albedo=float(f(np.asarray(albedo, f).reshape(-1)[0])),
        phase=phase_constants(float(phase_g)), sun_dir=t3(sun_dir), sun_ic=t3(sun_ic),
        env_intensity=float(f(env_intensity)))


def _tracer(grid, sv, p: RrParams):
    from linevis_tpu_torch.render.super_voxel import make_residual_ratio_tracer

    return make_residual_ratio_tracer(grid, sv, p.extinction, p.albedo, p.max_sv_steps,
                                      p.max_steps_per_sv)


def vpt_residual_ratio_reference(grid: torch.Tensor, sv, origins: torch.Tensor, dirs: torch.Tensor,
                                 key: torch.Tensor, p: RrParams,
                                 env: Optional[torch.Tensor] = None,
                                 steps: Optional[torch.Tensor] = None, first: int = 0):
    """Plain PyTorch version of the kernel (the contract of
    `vpt_residual_ratio`; ResidualRatioTracking.glsl:85-239): per bounce, a
    super-voxel DDA multiplies analytic-control x tracked-residual
    transmittance along the whole ray while reservoir-sampling one scatter
    location weighted by T sigma_s; the sky seen through the whole ray is
    added with its transmittance at every bounce, then the walk restarts
    from the reservoir sample, at most max_iterations + 1 bounces. A
    lockstep loop over the bounces of the rays not yet done."""
    tracer = _tracer(grid, sv, p)
    pc = p.phase
    max_iterations = p.max_iterations
    N = origins.shape[0]
    dev = origins.device
    keys = threefry.split_at(key.to(dev), first + torch.arange(N, device=dev))
    x = origins.float().clone()
    w = dirs.float().clone()
    T = torch.ones(N, dtype=torch.float32, device=dev)
    acc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    first_x = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    first_has = torch.zeros(N, dtype=torch.bool, device=dev)
    counts = torch.zeros((N, 3), dtype=torch.int32, device=dev)
    live = torch.arange(N, device=dev)
    for it in range(max_iterations + 1):
        if live.numel() == 0:
            break
        counts[live, 0] += 1
        ks = threefry.split(keys[live], 4)
        keys[live] = ks[:, 0]
        xs, ws = x[live].unbind(1), w[live].unbind(1)
        c_live = counts[live, 1:]
        T_seg, (r_wsum, r_T, r_dist), x_entry = tracer(ks[:, 1], xs, ws, c_live)
        counts[live, 1:] = c_live
        T_new = T[live] * T_seg
        xi = threefry.uniform_at(ks[:, 2])
        stop = (xi > r_wsum) | (it >= max_iterations)
        bg = (env_map_sample(env, ws, p.env_intensity) if env is not None
              else sky_light(ws, p.sun_dir, p.sun_ic))
        acc[live] = torch.stack([acc[live, c] + T_new * bg[c] for c in range(3)], 1)
        x_scat = torch.stack([x_entry[i] + ws[i] * r_dist for i in range(3)], 1)
        record = (~stop) & (~first_has[live])
        first_x[live[record]] = x_scat[record]
        first_has[live[record]] = True
        T[live] = torch.where(stop, T_new, r_T)
        go = torch.nonzero(~stop).reshape(-1)
        if go.numel():
            up = threefry.uniform_at(threefry.split(ks[go, 3], 2))
            wn = sample_phase(up[:, 0], up[:, 1], pc, tuple(c[go] for c in ws))
            x[live[go]] = x_scat[go]
            w[live[go]] = torch.stack(wn, 1)
        live = live[~stop]
    if steps is not None:
        steps.copy_(counts)
    return acc, first_x, first_has


def rr_transmittance_reference(grid: torch.Tensor, sv, origins: torch.Tensor,
                               dirs: torch.Tensor, key: torch.Tensor, p: RrParams,
                               steps: Optional[torch.Tensor] = None,
                               first: int = 0) -> torch.Tensor:
    """Plain PyTorch version of `rr_transmittance`: one DDA of the tracer
    per ray, keyed `split(key, .)[first + i]` -> T [N]."""
    tracer = _tracer(grid, sv, p)
    dev = origins.device
    N = origins.shape[0]
    keys = threefry.split_at(key.to(dev), first + torch.arange(N, device=dev))
    counts = torch.zeros((N, 3), dtype=torch.int32, device=dev)
    counts[:, 0] = 1
    T = tracer(keys, origins.unbind(1), dirs.unbind(1), counts[:, 1:])[0]
    if steps is not None:
        steps.copy_(counts)
    return T


def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.load("vpt_residual_ratio").vpt_residual_ratio_launch
    fn.argtypes = [p, i, i, i, p, p, i, i, i, p, p, p, i, i, i, i, i, i, p, p, i, i, p, p, p, p, p,
                   p]
    fn.restype = ctypes.c_int
    return fn


def _launch(grid, sv, origins, dirs, key, p: RrParams, env, steps, first, transmittance):
    dev = origins.device
    N = origins.shape[0]
    mu_c, mu_r = sv.mu_c, sv.mu_r_bar
    if grid.dim() != 3 or grid.dtype != torch.float32 or grid.device != dev:
        raise ValueError("grid must be a dense float32 [Z, Y, X] tensor on the rays' device")
    for name, x, dt, shape in (("origins", origins, torch.float32, (N, 3)),
                               ("dirs", dirs, torch.float32, (N, 3)),
                               ("key", key, torch.int64, (2,)),
                               ("mu_c", mu_c, torch.float32, tuple(mu_r.shape)),
                               ("mu_r_bar", mu_r, torch.float32, tuple(mu_c.shape))):
        if x.dtype != dt or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dt} {shape} on {dev}")
    if mu_c.dim() != 3 or tuple(float(n) for n in mu_c.shape[::-1]) != p.sv_n:
        raise ValueError("the SuperVoxelGrid does not match the parameters' sv_n")
    if env is not None and (env.dim() != 3 or env.shape[2] != 3 or env.device != dev):
        raise ValueError("env must be a [He, We, 3] tensor on the rays' device")
    g = grid_bricks(grid)
    ins = [origins.contiguous(), dirs.contiguous(), key.to(torch.int32).contiguous()]
    mc, mr = mu_c.contiguous(), mu_r.contiguous()
    prm = p.array()  # host memory: the launch passes it by value
    envc = None if env is None else env.float().contiguous()
    rad = torch.empty((N,) if transmittance else (N, 3), dtype=torch.float32, device=dev)
    fx = None if transmittance else torch.empty((N, 3), dtype=torch.float32, device=dev)
    fh = None if transmittance else torch.empty(N, dtype=torch.uint8, device=dev)
    st = None if steps is None else torch.empty((N, 3), dtype=torch.int32, device=dev)
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the rays taken
    with torch.cuda.device(dev):
        rc = _launcher()(
            g.data_ptr(), *grid.shape, mc.data_ptr(), mr.data_ptr(), *mc.shape,
            *(x.data_ptr() for x in ins), first, N, p.max_iterations, p.max_sv_steps,
            p.max_steps_per_sv, int(transmittance), prm.ctypes.data,
            None if envc is None else envc.data_ptr(), 0 if envc is None else envc.shape[0],
            0 if envc is None else envc.shape[1], rad.data_ptr(),
            None if fx is None else fx.data_ptr(), None if fh is None else fh.data_ptr(),
            None if st is None else st.data_ptr(), nxt.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_residual_ratio kernel launch failed: CUDA error {rc}")
    vpt_residual_ratio.launches += 1
    if steps is not None:
        steps.copy_(st)
    return rad, fx, fh


def vpt_residual_ratio(grid: torch.Tensor, sv, origins: torch.Tensor, dirs: torch.Tensor,
                       key: torch.Tensor, p: RrParams, env: Optional[torch.Tensor] = None,
                       steps: Optional[torch.Tensor] = None, first: int = 0):
    """Trace rays by residual ratio tracking -> (radiance [N, 3], first
    scatter position [N, 3], first scatter flag [N] bool).

    grid [Z, Y, X] float32 (dense; the kernel reads `grid_bricks(grid)`),
    sv a `render/super_voxel.py:SuperVoxelGrid` of it (mu_c and mu_r_bar
    [Sz, Sy, Sx] float32), origins and dirs [N, 3] float32 (unit dirs), key
    [2] int64: the trace's threefry key `kt`, of which ray i takes
    `split(kt, .)[first + i]`, `p` from `rr_params`, env an optional [He,
    We, 3] environment map (else the procedural sky and sun). `steps`, an
    optional int32 [N, 3] tensor, receives each ray's bounces, its DDA steps
    inside the grid and its residual steps, over all its bounces. A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version."""
    if origins.device.type == "cpu":
        return vpt_residual_ratio_reference(grid, sv, origins, dirs, key, p, env, steps, first)
    if origins.device.type != "cuda":
        raise ValueError(f"vpt_residual_ratio: unsupported device {origins.device}")
    rad, fx, fh = _launch(grid, sv, origins, dirs, key, p, env, steps, first, False)
    return rad, fx, fh.bool()


def rr_transmittance(grid: torch.Tensor, sv, origins: torch.Tensor, dirs: torch.Tensor,
                     key: torch.Tensor, p: RrParams, steps: Optional[torch.Tensor] = None,
                     first: int = 0) -> torch.Tensor:
    """Unbiased whole-volume transmittance per ray -> T [N]: one DDA of
    `vpt_residual_ratio` with albedo 0, ray i keyed `split(key, .)[first +
    i]` itself (`residual_ratio_transmittance`). Arguments as there; a CUDA
    tensor launches the kernel, a CPU tensor runs the plain version."""
    if origins.device.type == "cpu":
        return rr_transmittance_reference(grid, sv, origins, dirs, key, p, steps, first)
    if origins.device.type != "cuda":
        raise ValueError(f"rr_transmittance: unsupported device {origins.device}")
    return _launch(grid, sv, origins, dirs, key, p, None, steps, first, True)[0]


vpt_residual_ratio.launches = 0
