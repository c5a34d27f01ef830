"""The line density map's ray march (kernel R4).

`density_march` computes the march of the JAX package's
`render_line_density_map` (`linevis_tpu/render/line_density_map.py:51-93`,
a `lax.scan` of 256 steps over all pixels; no `pl.pallas_call`): each
pixel's ray clipped to the field's box, 256 trilinear steps of voxel_size /
10 through the piecewise-linear transfer function, Beer-Lambert opacity and
the front-to-back blend over the background. On a CUDA tensor it launches
`csrc/density_march.cu` (one thread a pixel) and counts the launch in
`density_march.launches`; on a CPU tensor it runs the plain version,
`density_march_reference`, the lockstep loop over the steps. The two round
every operation alike and agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.volume_common import trilinear, vdiv
from linevis_tpu_torch.render.transfer_function import tf_eval_points, tf_static_table

__all__ = ["density_march", "density_march_reference", "march_params"]


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


def _launcher():
    fn = _build.load("density_march").density_march_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def density_march(field: torch.Tensor, prm: np.ndarray, width: int, height: int, n_steps: int,
                  tf_color, tf_opacity) -> torch.Tensor:
    """March every pixel -> [H, W, 4] linear RGBA on the field's device.

    field [Z, Y, X] float32 in [0, 1], prm from `march_params`, tf_color /
    tf_opacity the transfer function's static points. A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version."""
    if field.device.type == "cpu":
        return density_march_reference(field, prm, width, height, n_steps, tf_color, tf_opacity)
    if field.device.type != "cuda":
        raise ValueError(f"density_march: unsupported device {field.device}")
    dev = field.device
    if field.dim() != 3 or field.dtype != torch.float32:
        raise ValueError("field must be a float32 [Z, Y, X] tensor")
    f = field.contiguous()
    prm_t = torch.as_tensor(np.asarray(prm, np.float32), device=dev)
    tf = torch.as_tensor(tf_static_table(tf_color, tf_opacity), device=dev)
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _launcher()(f.data_ptr(), f.shape[0], f.shape[1], f.shape[2], width, height, n_steps,
                         prm_t.data_ptr(), tf.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"density_march kernel launch failed: CUDA error {rc}")
    density_march.launches += 1
    return out


density_march.launches = 0
