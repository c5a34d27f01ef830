"""Tile layout utilities shared by all tile-grid kernels.

Counterpart of `linevis_tpu/kernels/tiles.py`.
"""

from __future__ import annotations

import torch

__all__ = ["unpack_tiles"]


def unpack_tiles(
    tiled: torch.Tensor, tiles_x: int, tiles_y: int, tile_w: int, tile_h: int,
    width: int, height: int,
) -> torch.Tensor:
    """[n_tiles, P] or [n_tiles, tile_h, tile_w] -> [height, width]."""
    img = tiled.reshape(tiles_y, tiles_x, tile_h, tile_w)
    img = img.permute(0, 2, 1, 3).reshape(tiles_y * tile_h, tiles_x * tile_w)
    return img[:height, :width]
