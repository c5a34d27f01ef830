"""Super-voxel grids and residual ratio tracking (Novák et al. 2014).

Counterpart of `linevis_tpu/render/super_voxel.py` (reference
`src/Renderers/Scattering/PathTracer/SuperVoxelGrid.cpp:410` and
`Data/Shaders/Scattering/Clouds/ResidualRatioTracking.glsl:34-83`): the
density grid is pooled into cubic super voxels, each holding the control
extinction mu_c (extinction x the super voxel's mean density) and the
residual majorant mu_r_bar = extinction x max |density - mean| over the
super voxel and its neighbours. The residual ratio estimator walks the super
voxels with an Amanatides-Woo DDA and in each estimates T = T_c T_r: the
control part analytic, exp(-mu_c d), only the residual tracked.

The JAX package runs the DDA as a `lax.scan` and each segment's estimator as
a `lax.while_loop`, vmapped over the rays. Here `make_residual_ratio_tracer`
and `_rr_segments` are the plain versions of kernel R8
(`kernels/vpt_residual_ratio.py`): lockstep loops in plain PyTorch over the
rays still inside (the DDA) and those still short of their segment's end
(the estimator); a ray outside keeps its state, which is all the JAX loops
do with it too. `residual_ratio_transmittance` launches R8 on a CUDA tensor
and runs them on a CPU tensor. Every sample comes from jax.random's stream
(`ops/threefry.py`), keyed as there.

The path tracer builds a grid's super voxels once (`super_voxel_minmax_of`,
`super_voxel_grid_of`) and keeps them on the grid tensor with its version,
as `grid_bricks` keeps the bricks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from linevis_tpu_torch.kernels.volume_common import box_intersect, trilinear, vdiv
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.trace.scattering import grid_box

__all__ = [
    "SuperVoxelGrid",
    "build_super_voxel_grid",
    "build_super_voxel_minmax",
    "make_residual_ratio_tracer",
    "residual_ratio_transmittance",
    "super_voxel_grid_of",
    "super_voxel_minmax_of",
]


@dataclasses.dataclass(frozen=True)
class SuperVoxelGrid:
    """Per-super-voxel control/residual extinctions, [Sz, Sy, Sx]."""

    mu_c: torch.Tensor
    mu_r_bar: torch.Tensor
    size: int


def _edge_index(n_out: int, n: int, device, lo: int = 0) -> torch.Tensor:
    return torch.clamp(torch.arange(n_out, device=device) - lo, 0, n - 1)


def _halo_block_stats(grid: torch.Tensor, size: int):
    """(hmin, hmax, mean) pooled into size^3 blocks, with min and max taken
    over the 3^3 block neighbourhood: a trilinear sample inside a super
    voxel mixes a one-voxel halo of its neighbours, so the neighbourhood
    bound is what brackets every sample. The grid and the block grid are
    padded with edge values. The mean sums each block in PyTorch's order
    (XLA's differs: float32 rounding of mu_c)."""
    g = grid.float()
    dev = g.device
    sz, sy, sx = g.shape
    nz, ny, nx = (-(-sz // size), -(-sy // size), -(-sx // size))
    gp = g[_edge_index(nz * size, sz, dev)][:, _edge_index(ny * size, sy, dev)][
        :, :, _edge_index(nx * size, sx, dev)]
    blocks = gp.reshape(nz, size, ny, size, nx, size)
    mean = blocks.mean(dim=(1, 3, 5))
    bmax = blocks.amax(dim=(1, 3, 5))
    bmin = blocks.amin(dim=(1, 3, 5))

    def padded(b):
        return b[_edge_index(nz + 2, nz, dev, 1)][:, _edge_index(ny + 2, ny, dev, 1)][
            :, :, _edge_index(nx + 2, nx, dev, 1)]

    bmax_p, bmin_p = padded(bmax), padded(bmin)
    hmax = torch.full_like(bmax, -float("inf"))
    hmin = torch.full_like(bmin, float("inf"))
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                hmax = torch.maximum(hmax, bmax_p[dz:dz + nz, dy:dy + ny, dx:dx + nx])
                hmin = torch.minimum(hmin, bmin_p[dz:dz + nz, dy:dy + ny, dx:dx + nx])
    return hmin, hmax, mean


def build_super_voxel_minmax(grid: torch.Tensor, size: int = 8):
    """Per-super-voxel (min, max) density: the reference's
    superVoxelMinMaxDensity texture (used by DecompositionTracking.glsl)."""
    hmin, hmax, _ = _halo_block_stats(grid, size)
    return hmin, hmax


def build_super_voxel_grid(grid: torch.Tensor, extinction: float, size: int = 8) -> SuperVoxelGrid:
    """Reference SuperVoxelGrid.cpp:410 (`computeSuperVoxels`): control =
    extinction x mean density, residual majorant = extinction x max
    |density - mean| (at least 1e-6)."""
    hmin, hmax, mean = _halo_block_stats(grid, size)
    resid = torch.maximum(hmax - mean, mean - hmin)
    ext = float(np.float32(extinction))
    return SuperVoxelGrid(mu_c=ext * mean, mu_r_bar=torch.clamp(ext * resid, min=1e-6),
                          size=int(size))


def _kept_on(grid: torch.Tensor, key, build):
    """`build()`, kept on the grid tensor under `key` with the grid's
    version (built again once the grid changes)."""
    kept = getattr(grid, "_super_voxels", None)
    if kept is None or kept[0] != grid._version:
        kept = (grid._version, {})
        grid._super_voxels = kept
    if key not in kept[1]:
        kept[1][key] = build()
    return kept[1][key]


def super_voxel_minmax_of(grid: torch.Tensor, size: int = 8):
    """`build_super_voxel_minmax(grid, size)`, built once per grid."""
    return _kept_on(grid, ("minmax", int(size)), lambda: build_super_voxel_minmax(grid, size))


def super_voxel_grid_of(grid: torch.Tensor, extinction: float, size: int = 8) -> SuperVoxelGrid:
    """`build_super_voxel_grid(grid, extinction, size)`, built once per grid
    and extinction."""
    ext = float(np.float32(extinction))
    return _kept_on(grid, ("grid", ext, int(size)),
                    lambda: build_super_voxel_grid(grid, ext, size))


def _rr_segments(keys, grid, b_min, extent, extinction, x0, w, d_seg, mu_c, mu_r_bar, max_steps,
                 T_in, t_base, scat_albedo, res, steps=None):
    """The residual ratio estimator over one super-voxel segment of length
    d_seg for a batch of rays (ResidualRatioTracking.glsl:34-83), with the
    reservoir of candidate scatter locations (weight T_local Ps, RTG2 ch.
    22) carried as (weight sum, T at the sample, distance). Returns (keys,
    T_c T_r, reservoir); `steps`, an int32 [n] tensor, gains each ray's
    steps."""
    r_wsum, r_T, r_dist = (r.clone() for r in res)
    keys = keys.clone()
    n = keys.shape[0]
    dev = keys.device
    t = torch.zeros(n, dtype=torch.float32, device=dev)
    T_r = torch.ones(n, dtype=torch.float32, device=dev)
    T_c = torch.exp(-mu_c * d_seg)
    live = torch.nonzero(t < d_seg).reshape(-1)
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        if steps is not None:
            steps[live] += 1
        ks = threefry.split(keys[live], 3)
        keys[live] = ks[:, 0]
        u = threefry.uniform_at(ks[:, 1:])
        mr, mc, ds = mu_r_bar[live], mu_c[live], d_seg[live]
        t_new = t[live] - torch.log(torch.clamp(1.0 - u[:, 0], min=1e-10)) / mr
        x = tuple(x0[i][live] + w[i][live] * t_new for i in range(3))
        density = trilinear(grid, tuple(vdiv(x[i] - b_min[i], extent[i]) for i in range(3)))
        mu = extinction * density
        factor = 1.0 - (mu - mc) / mr
        inside = t_new < ds
        T_old = T_r[live]
        T_r[live] = torch.where(inside, T_old * factor, T_old)
        Ps = scat_albedo * density
        T_local = T_in[live] * T_old * torch.exp(-mc * t_new)
        rw = torch.where(inside, T_local * Ps, torch.zeros_like(T_local))
        wsum = r_wsum[live] + rw
        r_wsum[live] = wsum
        take = inside & (u[:, 1] < rw / torch.clamp(wsum, min=1e-20))
        r_T[live] = torch.where(take, T_local, r_T[live])
        r_dist[live] = torch.where(take, t_base[live] + t_new, r_dist[live])
        t[live] = t_new
        live = live[t_new < ds]
    return keys, T_c * T_r, (r_wsum, r_T, r_dist)


def make_residual_ratio_tracer(grid: torch.Tensor, sv: SuperVoxelGrid, extinction, scat_albedo,
                               max_sv_steps: int = 64, max_steps_per_sv: int = 256):
    """Build `trace(keys [n, 2], x0, w, counts=None) -> (T [n], reservoir,
    x_entry)` (x0, w (x, y, z) tuples of [n] tensors): the super-voxel DDA
    (ResidualRatioTracking.glsl:124-210) estimating the whole-segment
    transmittance while reservoir-sampling a scatter location; `reservoir`
    = (weight sum, T at the sample, distance from x_entry). `counts`, an
    int32 [n, 2] tensor, gains each ray's DDA steps inside the grid and its
    residual steps. The plain version of kernel R8's DDA."""
    f = np.float32
    b_min_np, b_max_np = grid_box(grid.shape)
    extent_np = b_max_np - b_min_np
    Sz, Sy, Sx = sv.mu_c.shape
    sv_n = (float(Sx), float(Sy), float(Sz))
    cell_np = extent_np / np.asarray(sv_n, f)
    b_min = tuple(float(v) for v in b_min_np)
    b_max = tuple(float(v) for v in b_max_np)
    extent = tuple(float(v) for v in extent_np)
    cell = tuple(float(v) for v in cell_np)
    ext = float(f(extinction))
    alb = float(f(scat_albedo))
    grid = grid.float()

    def trace(keys, x0, w, counts=None):
        n = keys.shape[0]
        dev = keys.device
        t_min, t_max, hit = box_intersect(b_min, b_max, x0, w)
        t_in = t_min + 1e-7
        x_entry = tuple(x0[i] + w[i] * t_in for i in range(3))
        d_total = torch.clamp(t_max - t_min - 2e-7, min=0.0)
        idx, t_max3, t_delta, step = [], [], [], []
        for i in range(3):
            p0 = vdiv(x_entry[i] - b_min[i], cell[i])
            ix = torch.clamp(torch.floor(p0), 0.0, sv_n[i] - 1.0)
            st = torch.sign(w[i])
            aw = torch.abs(w[i])
            small = aw < 1e-9
            inv = torch.where(small, torch.full_like(aw, 1e9), 1.0 / aw)
            frac = p0 - ix
            dist = torch.where(st > 0, 1.0 - frac, frac)
            idx.append(ix)
            step.append(st)
            t_delta.append(cell[i] * inv)
            t_max3.append(torch.where(small, torch.full_like(aw, 1e9), dist * cell[i] * inv))
        t_cur = torch.zeros(n, dtype=torch.float32, device=dev)
        T = torch.ones(n, dtype=torch.float32, device=dev)
        res = tuple(torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3))
        keys = keys.clone()
        for _ in range(max_sv_steps):
            inside = t_cur < d_total
            for i in range(3):
                inside = inside & (idx[i] >= 0) & (idx[i] < sv_n[i])
            if not bool(inside.any()):
                break
            if counts is not None:
                counts[:, 0] += inside.to(torch.int32)
            t_next = torch.minimum(torch.minimum(torch.minimum(t_max3[0], t_max3[1]), t_max3[2]),
                                   d_total)
            d_seg = torch.clamp(t_next - t_cur, min=0.0)
            ok = torch.nonzero(inside & (d_seg > 0)).reshape(-1)
            if ok.numel():
                ix = [idx[i][ok].to(torch.int32).long() for i in range(3)]
                mu_c = sv.mu_c[ix[2], ix[1], ix[0]]
                mu_r = sv.mu_r_bar[ix[2], ix[1], ix[0]]
                tc = t_cur[ok]
                xs = tuple(x_entry[i][ok] + w[i][ok] * tc for i in range(3))
                seg_steps = None if counts is None else torch.zeros_like(ok, dtype=torch.int32)
                k_new, T_seg, r_new = _rr_segments(
                    keys[ok], grid, b_min, extent, ext, xs, tuple(c[ok] for c in w), d_seg[ok],
                    mu_c, mu_r, max_steps_per_sv, T[ok], tc, alb, tuple(r[ok] for r in res),
                    seg_steps)
                if counts is not None:
                    counts[ok, 1] += seg_steps
                keys[ok] = k_new
                T[ok] = T[ok] * T_seg
                for r, rn in zip(res, r_new):
                    r[ok] = rn
            # Advance to the neighbour across the nearest face (argmin: the
            # first of equal values).
            a0 = (t_max3[0] <= t_max3[1]) & (t_max3[0] <= t_max3[2])
            a1 = (~a0) & (t_max3[1] <= t_max3[2])
            axis = [a0, a1, (~a0) & (~a1)]
            for i in range(3):
                mv = inside & axis[i]
                idx[i] = torch.where(mv, idx[i] + step[i], idx[i])
                t_max3[i] = torch.where(mv, t_max3[i] + t_delta[i], t_max3[i])
            t_cur = torch.where(inside, t_next, t_cur)
        T = torch.where(hit, T, torch.ones_like(T))
        return T, res, x_entry

    return trace


def residual_ratio_transmittance(
    key: torch.Tensor,  # int64 [2] threefry key
    grid: torch.Tensor,  # [Z, Y, X] density
    sv: SuperVoxelGrid,
    origins: torch.Tensor,  # [N, 3]
    directions: torch.Tensor,  # [N, 3] unit
    extinction: float,
    max_sv_steps: int = 64,
    max_steps_per_sv: int = 256,
) -> torch.Tensor:
    """Unbiased whole-volume transmittance per ray -> [N]
    (ResidualRatioTracking.glsl:34-83 over a DDA of super voxels): kernel
    R8's transmittance on a CUDA tensor, its plain version on a CPU one."""
    from linevis_tpu_torch.kernels.vpt_residual_ratio import rr_params, rr_transmittance

    p = rr_params(grid.shape, sv.mu_c.shape, extinction, 0.0, max_sv_steps=max_sv_steps,
                  max_steps_per_sv=max_steps_per_sv)
    return rr_transmittance(grid.float(), sv, origins.float(), directions.float(),
                            key.to(origins.device), p)
