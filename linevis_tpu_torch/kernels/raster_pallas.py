"""Sort-carried tile binning for the capsule kernels.

Counterpart of `linevis_tpu/kernels/raster_pallas.py:SortedBinning` /
`build_sorted_binning` (`:57-215`). The JAX package runs this in XLA,
outside any Pallas kernel; here it is plain PyTorch: a stable `torch.sort`
of the packed (tile, depth-bucket) key, one index gather of the payload
columns through the sort permutation, and `torch.searchsorted` for the
per-tile runs. The triangle CSR binning and its kernel are not ported yet.

Within one key the JAX sort is unstable and this one is stable, so a
tile's run holds the same pairs as the JAX package's, possibly in another
order inside one depth bucket.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SortedBinning", "build_sorted_binning"]


@dataclasses.dataclass
class SortedBinning:
    """Sort-carried tile binning.

    payload:    [R, Np + chunk] float32 — tile-sorted pair payload (invalid
                pairs sort to the end; `chunk` zero padding columns keep the
                layout of the JAX package)
    tile_start: [n_tiles] int32 — first pair of each tile's run
    tile_count: [n_tiles] int32 — pairs in each tile's run
    """

    payload: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor
    tiles_x: int
    tiles_y: int
    chunk: int


def _tile_index(v: torch.Tensor, size: int, n: int) -> torch.Tensor:
    # floor(v / size) clipped to [0, n-1]; clamping in float first keeps
    # the int conversion in range (XLA's conversion saturates).
    return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int32)


def build_sorted_binning(
    xmin: torch.Tensor,  # [T] screen-space bbox per primitive
    xmax: torch.Tensor,
    ymin: torch.Tensor,
    ymax: torch.Tensor,
    payload_rows: torch.Tensor,  # [R, T], row 15 = bucket-floored zmin
    valid: torch.Tensor,  # [T] bool
    width: int,
    height: int,
    tile_w: int = 32,
    tile_h: int = 16,
    chunk: int = 128,
    span_x: int = 2,
    span_y: int = 2,
    seg2d: tuple = None,  # (sxa, sya, sxb, syb, sr): exact 2D capsule cull
) -> SortedBinning:
    dev = xmin.device
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    num_tiles = tiles_x * tiles_y
    T = xmin.shape[0]

    on_screen = (xmax >= 0) & (ymax >= 0) & (xmin < width) & (ymin < height)
    covers_x = torch.floor(xmax - 0.5) >= torch.ceil(xmin - 0.5)
    covers_y = torch.floor(ymax - 0.5) >= torch.ceil(ymin - 0.5)
    valid = valid & on_screen & covers_x & covers_y

    tx0 = _tile_index(xmin, tile_w, tiles_x)
    tx1 = _tile_index(xmax, tile_w, tiles_x)
    ty0 = _tile_index(ymin, tile_h, tiles_y)
    ty1 = _tile_index(ymax, tile_h, tiles_y)

    # Candidate tiles [span_y, span_x, T]: the bbox window from (tx0, ty0).
    dx = torch.arange(span_x, dtype=torch.int32, device=dev)
    dy = torch.arange(span_y, dtype=torch.int32, device=dev)
    cand_tx = tx0[None, None, :] + dx[None, :, None]
    cand_ty = ty0[None, None, :] + dy[:, None, None]
    in_range = (
        (cand_tx <= tx1[None, None, :])
        & (cand_ty <= ty1[None, None, :])
        & valid[None, None, :]
    )
    if seg2d is not None:
        # Exact 2D test: does the screen-space capsule (segment dilated by
        # sr) overlap the tile's rect? Liang-Barsky clip of the segment
        # against the sr-expanded rect.
        sxa, sya, sxb, syb, sr = (v[None, None, :] for v in seg2d)
        rx0 = cand_tx.float() * tile_w - sr
        rx1 = (cand_tx + 1).float() * tile_w + sr
        ry0 = cand_ty.float() * tile_h - sr
        ry1 = (cand_ty + 1).float() * tile_h + sr

        def axis_range(a0, r0, r1, d):
            small = torch.abs(d) < 1e-6
            inv = 1.0 / torch.where(small, torch.ones_like(d), d)
            t0 = (r0 - a0) * inv
            t1 = (r1 - a0) * inv
            lo = torch.minimum(t0, t1)
            hi = torch.maximum(t0, t1)
            inside = (a0 >= r0) & (a0 <= r1)
            big = torch.full_like(lo, 1e9)
            lo = torch.where(small, torch.where(inside, -big, big), lo)
            hi = torch.where(small, torch.where(inside, big, -big), hi)
            return lo, hi

        lox, hix = axis_range(sxa, rx0, rx1, sxb - sxa)
        loy, hiy = axis_range(sya, ry0, ry1, syb - sya)
        t_lo = torch.clamp(torch.maximum(lox, loy), min=0.0)
        t_hi = torch.clamp(torch.minimum(hix, hiy), max=1.0)
        in_range = in_range & (t_hi >= t_lo)
    tile_id = torch.where(
        in_range, cand_ty * tiles_x + cand_tx,
        torch.full_like(cand_tx, num_tiles),
    )

    zq = torch.clamp(payload_rows[15] * 1023.0, 0.0, 1023.0).to(torch.int32)
    key = (tile_id * 1024 + zq[None, None, :]).reshape(-1)

    sorted_keys, perm = torch.sort(key, stable=True)
    # Pair column j = s * T + t of the [span, T] candidate grid carries
    # primitive t's payload.
    payload = payload_rows[:, perm % T]
    payload = torch.nn.functional.pad(payload, (0, chunk))

    bounds = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) * 1024
    edges = torch.searchsorted(sorted_keys, bounds, side="left").to(torch.int32)
    starts = edges[:-1]
    return SortedBinning(
        payload=payload,
        tile_start=starts,
        tile_count=edges[1:] - starts,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        chunk=chunk,
    )
