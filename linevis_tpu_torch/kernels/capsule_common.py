"""Arithmetic shared by the plain PyTorch versions of the capsule kernels.

`csrc/capsule_common.cuh` holds the same helpers for the CUDA kernels; each
helper here rounds exactly as its device counterpart, so a kernel and its
plain version agree bit for bit on the card.
"""

from __future__ import annotations

import torch

__all__ = ["BIG", "fma32", "pixel_rays"]

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
