"""Arithmetic shared by the volume paths' plain PyTorch versions.

The scattering tracer, the path tracer (R3, `csrc/vpt_tracking.cu`), the
density march (R4, `csrc/density_march.cu`) and their plain versions work on
3-vectors held as three tensors (x, y, z), one operation at a time, so that
each rounds as its counterpart in `csrc/volume_common.cuh` does (the kernels
build with --fmad=false). Division by a constant goes through `vdiv`: on the
card PyTorch turns division by a Python scalar into multiplication by its
reciprocal, which rounds otherwise than the kernels' IEEE division.

The functions follow the JAX package's `linevis_tpu/trace/scattering.py`
(`_box_intersect`, `_orthonormal_basis`, `_sample_phase`),
`linevis_tpu/render/vpt.py` (`_sample_density`, `sample_skybox`,
`sample_light`) and `linevis_tpu/render/env_map.py` (`sample_env_map`)
operation for operation.

R3 reads the grid in BRICK^3 bricks (`grid_bricks`); R4 reads the dense
grid and each brick's occupancy (`brick_occupancy`) to skip the steps whose
cell can add nothing.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "TWO_PI", "vdiv", "box_intersect", "orthonormal_basis", "phase_constants",
    "sample_phase", "trilinear", "sample_density", "sky", "sun_light", "sky_light",
    "env_map_sample", "grid_bricks", "brick_occupancy", "trilinear_cell",
    "SKY_COLORS", "SKY_EDGES", "PHONG_N", "BRICK", "EMPTY_FLOOR",
]

V3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

TWO_PI = 6.283185307179586
BIG = 1000.0  # the slab test's stand-in for an unbounded interval
# Procedural sky (VptUtils.glsl:156-186): the five colours and their edges.
SKY_COLORS = ((0.1, 0.05, 0.01), (0.01, 0.05, 0.2), (0.8, 0.9, 1.0), (0.1, 0.3, 1.0),
              (0.01, 0.1, 0.7))
SKY_EDGES = (-1.0, -0.1, 0.0, 0.4, 1.0)
PHONG_N = 10  # the sun lobe's exponent (VptUtils.glsl:187-191)
BRICK = 8  # csrc/volume_common.cuh VOL_BRICK: a brick holds BRICK^3 voxels
# A voxel counts as empty only if 0 >= v >= EMPTY_FLOOR: NaN fails both
# tests, and -inf (or a value so negative that a lerp overflows to -inf)
# times a zero trilinear weight would give NaN.
EMPTY_FLOOR = -1e30


def vdiv(x: torch.Tensor, c) -> torch.Tensor:
    """x / c with c rounded to float32 and an IEEE division on every device."""
    return x / torch.full((), float(np.float32(c)), dtype=torch.float32, device=x.device)


def box_intersect(b_min: Sequence[float], b_max: Sequence[float], x: V3, w: V3):
    """Slab test (`_box_intersect`) of rays x + t w against the box ->
    (t_min, t_max, hit). Where |w_i| <= 1e-6 the slab is unbounded if x_i
    lies in it and empty otherwise."""
    lo = hi = None
    for i in range(3):
        small = torch.abs(w[i]) <= 1e-6
        inv = 1.0 / w[i]
        t0 = (float(b_min[i]) - x[i]) * inv
        t1 = (float(b_max[i]) - x[i]) * inv
        in_slab = (x[i] >= float(b_min[i])) & (x[i] <= float(b_max[i]))
        t0 = torch.where(small, torch.where(in_slab, -BIG, BIG), t0)
        t1 = torch.where(small, torch.full_like(t1, BIG), t1)
        a, b = torch.minimum(t0, t1), torch.maximum(t0, t1)
        lo = a if lo is None else torch.maximum(lo, a)
        hi = b if hi is None else torch.minimum(hi, b)
    t_min = torch.clamp(lo, min=0.0)
    return t_min, hi, (hi >= t_min) & (hi >= 0.0)


def _cross(a: V3, b: V3) -> V3:
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _normalized(v: V3) -> V3:
    n = torch.clamp(torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), min=1e-12)
    return (v[0] / n, v[1] / n, v[2] / n)


def orthonormal_basis(d: V3):
    """(b, t) perpendicular to d (`_orthonormal_basis`)."""
    near_z = torch.abs(d[2]) >= 0.999
    one, zero = torch.ones_like(d[2]), torch.zeros_like(d[2])
    other = (torch.where(near_z, one, zero), zero, torch.where(near_z, zero, one))
    b = _normalized(_cross(other, d))
    return b, _normalized(_cross(d, b))


def phase_constants(g: float) -> dict:
    """The float32 constants of the Henyey-Greenstein inversion for `g`, as
    `_sample_phase` rounds them (g_safe = 0.5 where |g| < 1e-3)."""
    f = np.float32
    g_safe = f(0.5) if abs(g) < 1e-3 else f(g)
    return dict(isotropic=abs(g) < 1e-3, one_minus_g2=f(f(1.0) - g_safe * g_safe),
                one_minus_g=f(f(1.0) - g_safe), two_g=f(f(2.0) * g_safe),
                half_over_g=f(f(0.5) / g_safe), one_plus_g2=f(f(1.0) + g_safe * g_safe))


def sample_phase(u1: torch.Tensor, u2: torch.Tensor, pc: dict, d: V3) -> V3:
    """New direction after a scatter along d (`_sample_phase`): isotropic
    for |g| < 1e-3, else Henyey-Greenstein; u1, u2 the uniforms of the
    phase key's two halves."""
    if pc["isotropic"]:
        r2 = u2 * 2.0 - 1.0
        s = torch.sqrt(torch.clamp(1.0 - r2 * r2, min=0.0))
        ang = u1 * TWO_PI
        i0, i1 = torch.cos(ang) * s, torch.sin(ang) * s
        nd = (-d[0], -d[1], -d[2])
        b, t = orthonormal_basis(nd)
        return tuple(b[k] * i0 + t[k] * i1 + nd[k] * r2 for k in range(3))
    t_cdf = torch.full_like(u2, float(pc["one_minus_g2"])) / (
        float(pc["one_minus_g"]) + float(pc["two_g"]) * u2)
    cos_t = float(pc["half_over_g"]) * (float(pc["one_plus_g2"]) - t_cdf * t_cdf)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u1 * TWO_PI
    ss, sc = sin_t * torch.sin(phi), sin_t * torch.cos(phi)
    b, t = orthonormal_basis(d)
    return tuple(ss * b[k] + sc * t[k] + cos_t * d[k] for k in range(3))


def trilinear(grid: torch.Tensor, p: V3) -> torch.Tensor:
    """Trilinear sample of a [Z, Y, X] grid at p in [0, 1]^3 (xyz order,
    clamped), as `trace/fields.py:sample_grid_trilinear` on one channel."""
    nz, ny, nx = grid.shape
    fx = torch.clamp(p[0], 0.0, 1.0) * (nx - 1)
    fy = torch.clamp(p[1], 0.0, 1.0) * (ny - 1)
    fz = torch.clamp(p[2], 0.0, 1.0) * (nz - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, nx - 2)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, ny - 2)
    z0 = torch.clamp(torch.floor(fz).to(torch.int32), 0, nz - 2)
    tx, ty, tz = fx - x0, fy - y0, fz - z0
    flat = grid.reshape(-1)
    base = (z0.long() * ny + y0.long()) * nx + x0.long()

    def g(dz, dy, dx):
        return flat[base + ((dz * ny + dy) * nx + dx)]

    c00 = g(0, 0, 0) * (1 - tx) + g(0, 0, 1) * tx
    c01 = g(0, 1, 0) * (1 - tx) + g(0, 1, 1) * tx
    c10 = g(1, 0, 0) * (1 - tx) + g(1, 0, 1) * tx
    c11 = g(1, 1, 0) * (1 - tx) + g(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def sample_density(grid, p: V3, interpolation: str, jitter=None) -> torch.Tensor:
    """Density at p in [0, 1]^3 (`_sample_density`): "Trilinear", "Nearest"
    (snapped to the nearest voxel centre) or "Stochastic" (p jittered by
    `jitter` - 0.5 voxels, `jitter` the three uniforms of the event's key
    k4, before the snap). `grid` is a dense [Z, Y, X] tensor or anything
    with a `sample(p)` method taking the same xyz tuple (`SparseGrid`)."""
    tri = grid.sample if hasattr(grid, "sample") else (lambda q: trilinear(grid, q))
    if interpolation == "Trilinear":
        return tri(p)
    if interpolation not in ("Nearest", "Stochastic"):
        raise ValueError(f"interpolation {interpolation!r}")
    nz, ny, nx = grid.shape
    res = (float(nx - 1), float(ny - 1), float(nz - 1))
    q = []
    for i in range(3):
        f = torch.clamp(p[i], 0.0, 1.0) * res[i]
        if interpolation == "Stochastic":
            f = f + jitter[i] - 0.5
        q.append(vdiv(torch.round(torch.clamp(f, 0.0, res[i])), max(res[i], 1.0)))
    return tri(tuple(q))


def _smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(vdiv(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sky(w: V3) -> V3:
    """Procedural sky gradient (`sample_skybox`) for unit directions w."""
    col = [torch.full_like(w[1], SKY_COLORS[0][c]) for c in range(3)]
    for i in range(1, 5):
        s = _smoothstep(SKY_EDGES[i - 1], SKY_EDGES[i], w[1])
        col = [col[c] * (1.0 - s) + SKY_COLORS[i][c] * s for c in range(3)]
    return tuple(col)


def sun_light(w: V3, sun_dir: Sequence[float], sun_ic: Sequence[float]) -> V3:
    """Phong sun lobe, N = 10 (`sample_light`). The lobe's d^10 is d2 = d*d,
    d4 = d2*d2, d8 = d4*d4, d8*d2 (the kernel's too)."""
    d = torch.clamp(w[0] * float(sun_dir[0]) + w[1] * float(sun_dir[1])
                    + w[2] * float(sun_dir[2]), min=0.0)
    d2 = d * d
    d4 = d2 * d2
    d10 = d4 * d4 * d2
    norm = float(np.float32((PHONG_N + 1.0) / (2.0 * np.pi)))
    return tuple(float(sun_ic[c]) * d10 * norm for c in range(3))


def sky_light(w: V3, sun_dir: Sequence[float], sun_ic: Sequence[float]) -> V3:
    """The radiance an escaping ray sees: sky plus sun."""
    s, l_ = sky(w), sun_light(w, sun_dir, sun_ic)
    return tuple(s[c] + l_[c] for c in range(3))


def env_map_sample(env: torch.Tensor, w: V3, intensity: float) -> V3:
    """Bilinear lat-long lookup of an [He, We, 3] environment map
    (`sample_env_map`): longitude wraps, latitude clamps at the poles."""
    He, We = int(env.shape[0]), int(env.shape[1])
    u = vdiv(torch.atan2(w[2], w[0]), 2.0 * np.pi) + 0.5
    v = vdiv(-torch.asin(torch.clamp(w[1], -1.0, 1.0)), np.pi) + 0.5
    fx = u * We - 0.5
    fy = v * He - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    x0i = torch.remainder(x0.to(torch.int32), We)
    x1i = torch.remainder(x0i + 1, We)
    y0i = torch.clamp(y0.to(torch.int32), 0, He - 1)
    y1i = torch.clamp(y0i + 1, 0, He - 1)
    flat = env.reshape(-1, 3)
    out = []
    for c in range(3):
        def at(yi, xi):
            return flat[(yi.long() * We + xi.long()), c]

        top = at(y0i, x0i) * (1 - tx) + at(y0i, x1i) * tx
        bot = at(y1i, x0i) * (1 - tx) + at(y1i, x1i) * tx
        out.append(float(intensity) * (top * (1 - ty) + bot * ty))
    return tuple(out)


def grid_bricks(grid: torch.Tensor) -> torch.Tensor:
    """The dense grid [Z, Y, X] as R3 reads it: in BRICK^3 bricks,
    brick-major, each brick z, y, x (padded with zeros to whole bricks; the
    kernel reads no padding) -> a new float32 tensor on the grid's device.
    Kept on the grid tensor itself with the grid's version, so a grid the
    scene caches (`get_cloud_grid`) is bricked once and an edited one
    again."""
    cached = getattr(grid, "_vpt_bricks", None)
    if cached is not None and cached[0] == grid._version:
        return cached[1]
    Z, Y, X = grid.shape
    pad = [(-n) % BRICK for n in (Z, Y, X)]
    g = torch.nn.functional.pad(grid.float(), (0, pad[2], 0, pad[1], 0, pad[0]))
    b = g.reshape((Z + pad[0]) // BRICK, BRICK, (Y + pad[1]) // BRICK, BRICK,
                  (X + pad[2]) // BRICK, BRICK).permute(0, 2, 4, 1, 3, 5).contiguous()
    grid._vpt_bricks = (grid._version, b)
    return b


def _any_with_apron(occ: torch.Tensor, axis: int) -> torch.Tensor:
    """Along `axis` of a bool tensor: for each brick b, whether any of its
    voxels BRICK b .. BRICK b + BRICK (the next brick's first voxel
    included, where there is one) is set."""
    n = occ.shape[axis]
    nb = -(-n // BRICK)
    pad = [0, 0] * occ.dim()
    pad[2 * (occ.dim() - 1 - axis) + 1] = nb * BRICK + 1 - n
    p = torch.nn.functional.pad(occ, pad)  # False beyond the grid
    core = p.narrow(axis, 0, nb * BRICK).unflatten(axis, (nb, BRICK)).any(axis + 1)
    first_of_next = torch.arange(BRICK, nb * BRICK + 1, BRICK, device=occ.device)
    return core | p.index_select(axis, first_of_next)


def brick_occupancy(grid: torch.Tensor) -> torch.Tensor:
    """uint8 [Zb, Yb, Xb] on the grid's device: 1 where a brick may add to
    a trilinear sample, 0 where every cell that starts in it reads only
    empty voxels (0 >= v >= EMPTY_FLOOR, so NaN and -inf count as
    occupied). A cell starting at voxel x0 reads x0 and x0 + 1, so a brick
    covers its voxels and a one-voxel apron on the high side of each axis.
    Kept on the grid tensor with the grid's version, as `grid_bricks`."""
    cached = getattr(grid, "_brick_occupancy", None)
    if cached is not None and cached[0] == grid._version:
        return cached[1]
    occ = ~((grid <= 0.0) & (grid >= EMPTY_FLOOR))
    for axis in range(3):
        occ = _any_with_apron(occ, axis)
    out = occ.to(torch.uint8).contiguous()
    grid._brick_occupancy = (grid._version, out)
    return out


def trilinear_cell(shape, p: V3):
    """The cell (x0, y0, z0) int32 that `trilinear` reads at p, from the
    same clamped coordinates."""
    nz, ny, nx = shape
    fx = torch.clamp(p[0], 0.0, 1.0) * (nx - 1)
    fy = torch.clamp(p[1], 0.0, 1.0) * (ny - 1)
    fz = torch.clamp(p[2], 0.0, 1.0) * (nz - 1)
    return (torch.clamp(torch.floor(fx).to(torch.int32), 0, nx - 2),
            torch.clamp(torch.floor(fy).to(torch.int32), 0, ny - 2),
            torch.clamp(torch.floor(fz).to(torch.int32), 0, nz - 2))
