"""The line density map's ray march (kernel R4).

`density_march` computes the march of the JAX package's
`render_line_density_map` (`linevis_tpu/render/line_density_map.py:51-93`,
a `lax.scan` of 256 steps over all pixels; no `pl.pallas_call`): each
pixel's ray clipped to the field's box, 256 trilinear steps of voxel_size /
10 through the piecewise-linear transfer function, Beer-Lambert opacity and
the front-to-back blend over the background. On a CUDA tensor it launches
`csrc/density_march.cu` (one thread a pixel, each warp on an 8x4 pixel
block) and counts the launch in `density_march.launches`; on a CPU tensor
it runs the plain version, `density_march_reference`, the lockstep loop
over the steps. The two round every operation alike and agree bit for bit
on the card wherever a step outside the box adds nothing: the colours are
finite and every alpha lies in [0, 1] (opacities and attenuation >= 0).
Each ray of the kernel stops at its box's far end, while the plain version
steps every pixel until the frame's last ray has left; outside that domain
(alpha overflowing to -inf, a colour of inf) they may differ in NaN and inf.

Where `skip_allowed` holds, the kernel skips each step whose cell lies in
an empty brick (`volume_common.brick_occupancy`): such a step adds exactly
nothing. `density_march_skipping` is that rule in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Sequence

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.volume_common import (
    BRICK,
    brick_occupancy,
    trilinear,
    trilinear_cell,
    vdiv,
)
from linevis_tpu_torch.render.transfer_function import tf_eval_points, tf_static_table

__all__ = ["density_march", "density_march_reference", "density_march_skipping", "march_params",
           "march_rays", "skip_allowed", "step_t"]


def march_params(field_shape, b_min, b_max, ray_origin: torch.Tensor, ray_basis: torch.Tensor,
                 width: int, height: int, attenuation: float, background: Sequence[float]):
    """The march's float32 constants -> (params [29] numpy, step): the box,
    its extent, the ray origin and basis, step = min(extent / res) / 10 as
    the JAX function rounds it, the attenuation, 2 / width, 2 / height and
    the background RGBA."""
    f = np.float32
    nz, ny, nx = field_shape
    lo = np.asarray(b_min, f)
    hi = np.asarray(b_max, f)
    extent = hi - lo
    step = f(np.min(extent / np.asarray([nx, ny, nz], f)) / f(10.0))
    prm = np.concatenate([
        lo, hi, extent, ray_origin.detach().float().cpu().numpy().reshape(3),
        ray_basis.detach().float().cpu().numpy().reshape(9),
        np.asarray([step, attenuation, 2.0 / width, 2.0 / height], f),
        np.asarray(background, f).reshape(4)]).astype(f)
    return prm, step


def density_march_reference(field: torch.Tensor, prm: np.ndarray, width: int, height: int,
                            n_steps: int, tf_color, tf_opacity, stats: dict = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the contract of
    `density_march`). `stats`, a dict, receives "steps": the steps that
    sample the field (a pixel's steps inside its box), the work the
    function needs."""
    dev = field.device
    p = [float(v) for v in prm]
    u = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) * p[23] - 1.0
    v = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) * p[24]
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = [(p[12 + 3 * c] * uu + p[13 + 3 * c] * vv + p[14 + 3 * c]).reshape(-1) for c in range(3)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = [c / n for c in d]
    lo = hi = None
    for c in range(3):
        inv = 1.0 / torch.where(torch.abs(d[c]) < 1e-9, torch.full_like(d[c], 1e-9), d[c])
        t0 = (p[c] - p[9 + c]) * inv
        t1 = (p[3 + c] - p[9 + c]) * inv
        a, b = torch.minimum(t0, t1), torch.maximum(t0, t1)
        lo = a if lo is None else torch.maximum(lo, a)
        hi = b if hi is None else torch.minimum(hi, b)
    t_near = torch.clamp(lo, min=0.0)
    t_far = hi
    hit = t_far > t_near
    step, att = p[21], p[22]
    acc = [torch.zeros_like(t_near) for _ in range(3)]
    acc_a = torch.zeros_like(t_near)
    steps = 0
    for k in range(n_steps):
        # (k + 0.5) * step in float32, as the kernel (and the JAX scan) form it.
        t = t_near + float(np.float32(k + 0.5) * np.float32(step))
        inside = hit & (t < t_far)
        if not bool(inside.any()):
            break  # t only grows: no pixel has a step left in its box
        if stats is not None:
            steps += int(inside.sum())
        tex = tuple(vdiv(p[9 + c] + t * d[c] - p[c], p[6 + c]) for c in range(3))
        dens = trilinear(field, tex)
        rgb, a_tf = tf_eval_points(tf_color, tf_opacity, dens)
        alpha = 1.0 - torch.exp(-a_tf * step * att)
        alpha = torch.where(inside, alpha, torch.zeros_like(alpha))
        w = (1.0 - acc_a) * alpha
        acc = [acc[c] + w * rgb[c] for c in range(3)]
        acc_a = acc_a + w
    if stats is not None:
        stats["steps"] = steps
    out = [acc[c] + (1.0 - acc_a) * p[25 + c] for c in range(3)] + [acc_a]
    return torch.stack(out, -1).reshape(height, width, 4)


def _tf_at(group: np.ndarray, npts: int, nch: int, xc: np.float32) -> np.ndarray:
    """The kernel's `tf_eval_last` in float32 on one group of
    `tf_static_table` ([init[nch], (p0, p1, span, v0[nch], dv[nch]) per
    segment]) at a clamped x -> nch values."""
    seg_len = 3 + 2 * nch
    segs = group[nch:nch + (npts - 1) * seg_len].reshape(-1, seg_len)
    inside = [j for j, sg in enumerate(segs) if xc >= sg[0] and xc <= sg[1]]
    if not inside:
        return group[:nch]
    sg = segs[inside[-1]]
    with np.errstate(all="ignore"):
        w = np.float32(xc - sg[0]) / sg[2]
        return (sg[3:3 + nch] + w * sg[3 + nch:]).astype(np.float32)


def _points(pts):
    """A TF's points as hashable float tuples: the caches' keys."""
    return tuple(tuple(float(v) for v in p) for p in pts)


@functools.lru_cache(maxsize=64)
def _tables(tf_color, tf_opacity):
    """-> (`tf_static_table` of both TFs, whether the opacity TF is exactly
    0 at density +0 and -0 and never negative, and every colour of the
    table is finite). The opacity at a density in a segment is v0 + w dv in
    float32 with w in [0, 1], so at least v0 or v0 + dv, whichever is less:
    it is >= 0 everywhere when the first value, each v0 and each v0 + dv
    are (NaN fails)."""
    table = tf_static_table(tf_color, tf_opacity)
    nc, no = int(table[0]), int(table[1])
    color = table[2:2 + 3 + (nc - 1) * 9]
    opacity = table[2 + color.size:]
    segs = opacity[1:].reshape(-1, 5)
    never_negative = bool(opacity[0] >= 0) and bool((segs[:, 3] >= 0).all()) and bool(
        (segs[:, 3] + segs[:, 4] >= 0).all())
    empty_adds_nothing = bool(np.isfinite(color).all()) and never_negative and all(
        float(_tf_at(opacity, no, 1, np.float32(x))[0]) == 0.0 for x in (0.0, -0.0))
    return table, empty_adds_nothing


def skip_allowed(prm: np.ndarray, tf_color, tf_opacity) -> bool:
    """Whether a step whose cell lies in an empty brick adds exactly
    nothing under these parameters, so that the kernel may skip it: the
    opacity TF is exactly 0 at density +0 and -0 (an empty cell's clamped
    value) and never negative, every colour of the TF's table is finite,
    and the step and the attenuation are finite with step > 0 and
    attenuation >= 0. Then every step's alpha is in [0, 1] (or NaN, which
    stays in every channel), so 1 - acc_a stays finite, and an empty step's
    alpha = 1 - exp(-0) = +0 adds +-0 to each channel. A negative opacity
    or attenuation could drive alpha to -inf and acc_a to -inf, after which
    the plain version's empty steps add inf * 0 = NaN."""
    step, att = np.float32(prm[21]), np.float32(prm[22])
    return (_tables(_points(tf_color), _points(tf_opacity))[1] and bool(np.isfinite(step))
            and bool(np.isfinite(att)) and bool(step > 0) and bool(att >= 0))


@functools.lru_cache(maxsize=64)
def _table_on(tf_color, tf_opacity, device: str) -> torch.Tensor:
    """Both TFs' table on `device`, uploaded once: a copy each launch would
    wait on the card."""
    return torch.tensor(_tables(tf_color, tf_opacity)[0], device=device)


def march_rays(prm: np.ndarray, width: int, height: int, device):
    """The pixels' unit rays and their clip to the box, as the plain
    version forms them -> (d: three [H*W] tensors, t_near, t_far, hit)."""
    p = [float(v) for v in prm]
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) * p[23] - 1.0
    v = 1.0 - (torch.arange(height, dtype=torch.float32, device=device) + 0.5) * p[24]
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = [(p[12 + 3 * c] * uu + p[13 + 3 * c] * vv + p[14 + 3 * c]).reshape(-1) for c in range(3)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = [c / n for c in d]
    lo = hi = None
    for c in range(3):
        inv = 1.0 / torch.where(torch.abs(d[c]) < 1e-9, torch.full_like(d[c], 1e-9), d[c])
        t0 = (p[c] - p[9 + c]) * inv
        t1 = (p[3 + c] - p[9 + c]) * inv
        a, b = torch.minimum(t0, t1), torch.maximum(t0, t1)
        lo = a if lo is None else torch.maximum(lo, a)
        hi = b if hi is None else torch.minimum(hi, b)
    t_near = torch.clamp(lo, min=0.0)
    return d, t_near, hi, hi > t_near


def step_t(t_near: torch.Tensor, k: int, step: float) -> torch.Tensor:
    """Step k's t: (k + 0.5) * step in float32, as the kernel (and the JAX
    scan) form it."""
    return t_near + float(np.float32(k + 0.5) * np.float32(step))


def density_march_skipping(field: torch.Tensor, prm: np.ndarray, width: int, height: int,
                           n_steps: int, tf_color, tf_opacity, stats: dict = None) -> torch.Tensor:
    """The kernel's empty-space skipping in plain PyTorch: the plain
    version's steps, of which each step whose cell (`trilinear_cell` of
    the same grid coordinates) lies in an empty brick takes no sample and
    adds nothing, where `skip_allowed` holds. Equal to
    `density_march_reference` bit for bit. `stats` receives "steps" (the
    steps in the box), "sampled" (those the kernel samples) and
    "voxels_read" (the distinct voxels their samples read)."""
    dev = field.device
    skip = skip_allowed(prm, tf_color, tf_opacity)
    occ = brick_occupancy(field).reshape(-1).bool()
    _, ny, nx = field.shape
    nyb, nxb = -(-ny // BRICK), -(-nx // BRICK)
    p = [float(v) for v in prm]
    d, t_near, t_far, hit = march_rays(prm, width, height, dev)
    step, att = p[21], p[22]
    acc = [torch.zeros_like(t_near) for _ in range(3)]
    acc_a = torch.zeros_like(t_near)
    steps = sampled = 0
    read = torch.zeros(field.numel() if stats is not None else 0, dtype=torch.bool, device=dev)
    for k in range(n_steps):
        t = step_t(t_near, k, step)
        inside = hit & (t < t_far)
        if not bool(inside.any()):
            break
        tex = tuple(vdiv(p[9 + c] + t * d[c] - p[c], p[6 + c]) for c in range(3))
        x0, y0, z0 = (c.long() for c in trilinear_cell(field.shape, tex))
        if skip:
            inside = inside & occ[((z0 // BRICK) * nyb + y0 // BRICK) * nxb + x0 // BRICK]
        idx = torch.nonzero(inside).reshape(-1)
        if stats is not None:
            steps += int((hit & (t < t_far)).sum())
            sampled += idx.numel()
            first = (z0[idx] * ny + y0[idx]) * nx + x0[idx]
            for dz, dy, dx in itertools.product((0, 1), repeat=3):
                read[first + (dz * ny + dy) * nx + dx] = True
        if idx.numel() == 0:
            continue
        dens = trilinear(field, tuple(c[idx] for c in tex))
        rgb, a_tf = tf_eval_points(tf_color, tf_opacity, dens)
        alpha = 1.0 - torch.exp(-a_tf * step * att)
        w = (1.0 - acc_a[idx]) * alpha
        for c in range(3):
            acc[c][idx] = acc[c][idx] + w * rgb[c]
        acc_a[idx] = acc_a[idx] + w
    if stats is not None:
        stats["steps"] = steps
        stats["sampled"] = sampled
        stats["voxels_read"] = int(read.sum())
    out = [acc[c] + (1.0 - acc_a) * p[25 + c] for c in range(3)] + [acc_a]
    return torch.stack(out, -1).reshape(height, width, 4)


def _launcher():
    fn = _build.load("density_march").density_march_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, p, p, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def density_march(field: torch.Tensor, prm: np.ndarray, width: int, height: int, n_steps: int,
                  tf_color, tf_opacity) -> torch.Tensor:
    """March every pixel -> [H, W, 4] linear RGBA on the field's device.

    field [Z, Y, X] float32 in [0, 1], prm from `march_params`, tf_color /
    tf_opacity the transfer function's static points. A CUDA tensor
    launches the kernel on the field and, where `skip_allowed` holds, its
    `brick_occupancy` (made at its first launch on the field and kept with
    it); a CPU tensor runs the plain version."""
    if field.device.type == "cpu":
        return density_march_reference(field, prm, width, height, n_steps, tf_color, tf_opacity)
    if field.device.type != "cuda":
        raise ValueError(f"density_march: unsupported device {field.device}")
    dev = field.device
    if field.dim() != 3 or field.dtype != torch.float32:
        raise ValueError("field must be a float32 [Z, Y, X] tensor")
    prm = np.ascontiguousarray(prm, np.float32)  # host memory: the launch passes it by value
    if prm.shape != (29,):
        raise ValueError("prm must hold march_params' 29 values")
    skip = skip_allowed(prm, tf_color, tf_opacity)
    grid, occ = field.contiguous(), brick_occupancy(field) if skip else None
    tf = _table_on(_points(tf_color), _points(tf_opacity), str(dev))
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _launcher()(grid.data_ptr(), None if occ is None else occ.data_ptr(),
                         *field.shape, width, height, n_steps, prm.ctypes.data, tf.data_ptr(),
                         tf.numel(), int(skip), out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"density_march kernel launch failed: CUDA error {rc}")
    density_march.launches += 1
    return out


density_march.launches = 0
