"""Tiling-mode address generation for per-pixel buffers.

Counterpart of `linevis_tpu/kernels/tiled_address.py` (numpy, kept equal to
it). Reference: the tiled addressing of
`Data/Shaders/Utils/TiledAddress.glsl:28-91` (host plumbing
`src/Renderers/LineRenderer.hpp:233-244`): per-pixel fragment buffers (PPLL
lists, MLAB node arrays, depth-complexity counters) addressed LINEAR, TILED
NxM (2x2 / 2x8 / generic) or MORTON 8x8 so that neighbouring fragments share
cache lines ("OIT to Volumetric Shadow Mapping", Davies 2015).

The port's kernels address per-pixel state by screen tile already
(`kernels/tiles.py`); no kernel calls these helpers. They repack per-pixel
buffers on the host into any of the reference's layouts.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "MORTON_8X8",
    "addr_gen",
    "pack_image",
    "unpack_image",
]

# mortonCodeLookupTable (TiledAddress.glsl:37-46): pixel (x + 8y) -> slot.
MORTON_8X8 = np.array(
    [
        0, 1, 4, 5, 16, 17, 20, 21,
        2, 3, 6, 7, 18, 19, 22, 23,
        8, 9, 12, 13, 24, 25, 28, 29,
        10, 11, 14, 15, 26, 27, 30, 31,
        32, 33, 36, 37, 48, 49, 52, 53,
        34, 35, 38, 39, 50, 51, 54, 55,
        40, 41, 44, 45, 56, 57, 60, 61,
        42, 43, 46, 47, 58, 59, 62, 63,
    ],
    np.int64,
)


def addr_gen(x, y, viewport_w: int, mode: str = "linear",
             tile_n: int = 2, tile_m: int = 8):
    """addrGen (TiledAddress.glsl:52-85): (x, y) -> 1D buffer offset.

    mode: 'linear' | 'tiled' (tile_n x tile_m) | 'morton' (8x8).
    Vectorized over numpy arrays; viewport_w must be a multiple of the
    tile width (the reference rounds buffer sizes up likewise).
    """
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    if mode == "linear":
        return x + viewport_w * y
    if mode == "morton":
        surface_w = viewport_w >> 3
        tile_1d = ((x >> 3) + surface_w * (y >> 3)) << 6
        pixel_1d = (x & 7) + ((y & 7) << 3)
        return tile_1d | MORTON_8X8[pixel_1d]
    if mode == "tiled":
        surface_w = viewport_w // tile_n
        tile_1d = ((x // tile_n) + surface_w * (y // tile_m)) * (
            tile_n * tile_m
        )
        pixel_1d = (x % tile_n) + (y % tile_m) * tile_n
        return tile_1d | pixel_1d
    raise ValueError(f"unknown addressing mode {mode!r}")


def pack_image(img: np.ndarray, mode: str = "linear",
               tile_n: int = 2, tile_m: int = 8) -> np.ndarray:
    """[H, W] image -> flat buffer in the chosen addressing layout."""
    H, W = img.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W]
    addr = addr_gen(xs, ys, W, mode, tile_n, tile_m)
    out = np.zeros((H * W,) + img.shape[2:], img.dtype)
    out[addr.reshape(-1)] = img.reshape((H * W,) + img.shape[2:])
    return out


def unpack_image(buf: np.ndarray, width: int, height: int,
                 mode: str = "linear", tile_n: int = 2,
                 tile_m: int = 8) -> np.ndarray:
    """Inverse of pack_image."""
    ys, xs = np.mgrid[0:height, 0:width]
    addr = addr_gen(xs, ys, width, mode, tile_n, tile_m)
    return buf[addr.reshape(-1)].reshape((height, width) + buf.shape[1:])
