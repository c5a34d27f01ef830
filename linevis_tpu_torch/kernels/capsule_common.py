"""Arithmetic shared by the plain PyTorch versions of the capsule kernels.

`csrc/capsule_common.cuh` holds the same helpers for the CUDA kernels; each
helper here rounds exactly as its device counterpart, so a kernel and its
plain version agree bit for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.render.transfer_function import tf_channels_static

__all__ = ["BIG", "fma32", "pixel_rays", "capsule_surfaces", "capsule_features"]

BIG = 1e30  # "no hit" depth


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once to float32, as the MLAB kernel's `__fmaf_rn`.

    The product of two float32 values is exact in float64; the float64 sum
    rounds to 53 bits before the float32 rounding, which can differ from a
    single rounding only when that sum lands exactly on a float32 tie."""
    return (a.double() * b.double() + c.double()).float()


def pixel_rays(params, n_tiles, tiles_x, tile_w, tile_h, width, height):
    """Unit ray directions (3 x [n_tiles, P]) and 1/|dir| for every tile
    pixel (params rows 0-8: the row-major ray basis, dir = B @ [u, v, 1])."""
    dev = params.device
    P = tile_w * tile_h
    lin = torch.arange(P, device=dev)
    t = torch.arange(n_tiles, device=dev)
    gx = ((t % tiles_x)[:, None] * tile_w + (lin % tile_w)[None, :]).float() + 0.5
    gy = ((t // tiles_x)[:, None] * tile_h + (lin // tile_w)[None, :]).float() + 0.5
    un = gx * (2.0 / width) - 1.0
    vn = 1.0 - gy * (2.0 / height)
    p = params
    dx = p[0] * un + p[1] * vn + p[2]
    dy = p[3] * un + p[4] * vn + p[5]
    dz = p[6] * un + p[7] * vn + p[8]
    invlen = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (dx * invlen, dy * invlen, dz * invlen), invlen


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def capsule_surfaces(scene, prim, o, d, accept):
    """Entry and exit surface of capsules `prim` [A] along rays o, d [A, 3]
    -> (t_in, t_out) [A], inf where the capsule is masked or no surface
    qualifies. A surface is the nearer of the body's, the start cap's (where
    `cap_a`) and the end cap's candidate for which `accept(t)` holds
    (`linevis_tpu/render/ray_tracer.py:_make_capsule_surfaces`; the
    traversal kernels' `capsule_surfaces` rounds the same operations in the
    same order)."""
    r32 = np.float32(scene.radius)
    rr = float(r32 * r32)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    oax, oay, oaz = ox - scene.a[0, prim], oy - scene.a[1, prim], oz - scene.a[2, prim]
    bx, by, bz = scene.ba[0, prim], scene.ba[1, prim], scene.ba[2, prim]
    baba = _dot(bx, by, bz, bx, by, bz)
    bard = _dot(bx, by, bz, dx, dy, dz)
    baoa = _dot(bx, by, bz, oax, oay, oaz)
    rd = _dot(dx, dy, dz, oax, oay, oaz)
    oaoa = _dot(oax, oay, oaz, oax, oay, oaz)
    k2 = torch.clamp(baba - bard * bard, min=1e-20)
    k1 = baba * rd - baoa * bard
    k0 = baba * oaoa - baoa * baoa - rr * baba
    h = k1 * k1 - k2 * k0
    sq = torch.sqrt(torch.clamp(h, min=0.0))
    ha = rd * rd - (oaoa - rr)
    sqa = torch.sqrt(torch.clamp(ha, min=0.0))
    b1b = rd - bard
    obob = oaoa - 2.0 * baoa + baba
    hb = b1b * b1b - (obob - rr)
    sqb = torch.sqrt(torch.clamp(hb, min=0.0))
    cap_on = scene.cap_a[prim] > 0.5
    on = scene.mask[prim]
    inf = torch.full_like(k2, float("inf"))

    def surface(near):
        if near:
            tb, ta, tc = (-k1 - sq) / k2, -rd - sqa, -b1b - sqb
        else:
            tb, ta, tc = (-k1 + sq) / k2, -rd + sqa, -b1b + sqb
        yb, ya, yc = baoa + tb * bard, baoa + ta * bard, baoa + tc * bard
        cb = torch.where((h >= 0.0) & (yb > 0.0) & (yb < baba) & accept(tb), tb, inf)
        ca = torch.where((ha >= 0.0) & (ya <= 0.0) & cap_on & accept(ta), ta, inf)
        cc = torch.where((hb >= 0.0) & (yc >= baba) & accept(tc), tc, inf)
        return torch.where(on, torch.minimum(cb, torch.minimum(ca, cc)), inf)

    return surface(True), surface(False)


def capsule_features(scene, prim, o, d, t, tf_opacity, opacity):
    """Deferred-shading features of the surface point at t on capsules
    `prim` [A] -> (attr, cos1, cos2, alpha) [A]: the attribute at the point's
    axial position, the headlight cosines of its normal and of the tube
    (1/sqrt where the JAX package takes `lax.rsqrt`), the opacity TF times
    `opacity`. Divisions by the radius take a tensor divisor (see
    `tf_channels_static`)."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
    ax, ay, az = scene.a[0, prim], scene.a[1, prim], scene.a[2, prim]
    bx, by, bz = scene.ba[0, prim], scene.ba[1, prim], scene.ba[2, prim]
    baba = torch.clamp(_dot(bx, by, bz, bx, by, bz), min=1e-20)
    uax = torch.clamp(_dot(px - ax, py - ay, pz - az, bx, by, bz) / baba, 0.0, 1.0)
    attr = scene.attr0[prim] + scene.dattr[prim] * uax
    radius = torch.full((), float(np.float32(scene.radius)), dtype=torch.float32,
                        device=t.device)
    nx = (px - (ax + bx * uax)) / radius
    ny = (py - (ay + by * uax)) / radius
    nz = (pz - (az + bz * uax)) / radius
    inv_len = 1.0 / torch.sqrt(baba)
    tx, ty, tz = bx * inv_len, by * inv_len, bz * inv_len
    ndl = -_dot(nx, ny, nz, dx, dy, dz)
    tdl = -_dot(tx, ty, tz, dx, dy, dz)
    ndt = _dot(nx, ny, nz, tx, ty, tz)
    denom = 1.0 / torch.sqrt(torch.clamp(1.0 - tdl * tdl, min=1e-6))
    cos1 = torch.clamp(torch.abs(ndl), 0.0, 1.0)
    cos2 = torch.clamp(torch.abs(ndl - tdl * ndt) * denom, 0.0, 1.0)
    alpha = tf_channels_static(tf_opacity, 1, attr)[0] * opacity
    return attr, cos1, cos2, alpha
