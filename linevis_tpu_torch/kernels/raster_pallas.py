"""Tile binnings and the triangle tile rasterizer.

Counterpart of `linevis_tpu/kernels/raster_pallas.py`.

**Sort-carried binning for the capsule and prism kernels**
(`SortedBinning`, `build_sorted_binning`, `:57-215` there). The JAX package
runs it in XLA, outside any Pallas kernel; here it is plain PyTorch: a
stable `torch.sort` of the packed (tile, depth-bucket) key, one index gather
of the payload columns through the sort permutation, and
`torch.searchsorted` for the per-tile runs. Within one key the JAX sort is
unstable and this one is stable, so a tile's run holds the same pairs as the
JAX package's, possibly in another order inside one depth bucket.

**CSR chunk binning for the triangle rasterizer** (`CsrBinning`,
`build_csr_binning`, `:224-424` there): the (tile, triangle) pairs are
sorted by (tile, conservative depth bucket) with a stable sort (stable in
the JAX package too, so the slot order is identical), each tile's run is
padded to whole chunks of `chunk` slots, and all runs are concatenated into
one [R, total_chunks, chunk] payload. Padded slots carry rejecting rows.

**The triangle tile rasterizer** (`rasterize_depth`, `rasterize_gbuffer`;
`_raster_kernel`, `:427` there). Every per-fragment quantity is an affine
plane in screen space, `(a*gx + b*gy) + c` at the pixel centre, evaluated in
that order, unfused; the rasterizer evaluates planes and selects the
nearest. Inside a chunk the winner is the lowest id among the slots at the
chunk's minimum depth; across chunks the earlier chunk keeps a tie; with
early-z a tile stops at the first chunk behind all its pixels. On a
CUDA payload the wrappers launch `csrc/raster_triangle.cu`; on a CPU payload
they run `rasterize_triangles_reference`, the same function in plain
PyTorch.

Payload rows (R = 16 for depth only, 40 with the G-buffer planes):
  0-8:   edge functional coefficients (a, b, c) x 3 (orientation-normalized)
  9-11:  affine depth plane (a, b, c)
  12-14: id plane (0, 0, id): ids are exact below 2^24 in float32
  15:    conservative min NDC depth of the triangle (sort key within a tile)
  16+3j: attribute plane j (inv_w, attr/w, normal/w xyz, tangent/w xyz)
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from linevis_tpu_torch.automation.profiling import span
from linevis_tpu_torch.kernels import _build

__all__ = [
    "SortedBinning", "build_sorted_binning",
    "CsrBinning", "build_csr_binning", "build_csr_binning_bbox",
    "rasterize_depth", "rasterize_gbuffer", "rasterize_triangles_reference",
]

_MAX_PIXELS = 512  # pixels per tile in the CUDA kernel
_THREAD_PIXELS = (2, 2)  # columns x rows of pixels a thread owns (PIX_ROWS)
# Shared memory a block may opt in to on sm_90, the kernel's build target:
# it stages rows 0-15 of a chunk in two buffers, 2 * 16 * 4 B per slot.
_MAX_SHARED = 227 * 1024
_SHARED_PER_SLOT = 2 * 16 * 4
MAX_ID = 1 << 24  # float32 holds ids exactly below this


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

    @functools.cached_property
    def longest_first(self) -> torch.Tensor:
        """[n_tiles] int32: the tiles longest run first, the order in which
        the capsule, prism and accumulation kernels' blocks take them;
        computed once per binning (MBOIT's two passes share one)."""
        return torch.argsort(self.tile_count, descending=True).to(torch.int32)


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

    with span("bin.window"):
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
        # against the sr-expanded rect, one axis in each span.
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

        with span("bin.cull"):
            sxa, sya, sxb, syb, sr = (v[None, None, :] for v in seg2d)
            rx0 = cand_tx.float() * tile_w - sr
            rx1 = (cand_tx + 1).float() * tile_w + sr
            lox, hix = axis_range(sxa, rx0, rx1, sxb - sxa)
        with span("bin.cull"):
            ry0 = cand_ty.float() * tile_h - sr
            ry1 = (cand_ty + 1).float() * tile_h + sr
            loy, hiy = axis_range(sya, ry0, ry1, syb - sya)
            t_lo = torch.clamp(torch.maximum(lox, loy), min=0.0)
            t_hi = torch.clamp(torch.minimum(hix, hiy), max=1.0)
            in_range = in_range & (t_hi >= t_lo)
    with span("bin.sort"):
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


@dataclasses.dataclass
class CsrBinning:
    """Chunk-padded CSR triangle lists for the triangle rasterizer.

    payload:         [R, total_chunks, chunk] float32 (see module docstring)
    tile_chunk_base: [n_tiles] int32 — first chunk index of each tile
    tile_num_chunks: [n_tiles] int32 — chunks owned by each tile
    overflow:        [] int32 — (tile, tri) pairs dropped due to capacity
    num_primitives:  primitives binned (their ids are 0 .. num_primitives-1)
    """

    payload: torch.Tensor
    tile_chunk_base: torch.Tensor
    tile_num_chunks: torch.Tensor
    overflow: torch.Tensor
    tiles_x: int
    tiles_y: int
    chunk: int
    num_primitives: int = 0


def build_csr_binning(
    tri_x: torch.Tensor,  # [3, T]
    tri_y: torch.Tensor,  # [3, T]
    payload_rows: torch.Tensor,  # [R, T] per-triangle payload (row 15 = zmin)
    valid: torch.Tensor,  # [T]
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 8,
    chunk: int = 128,
    span_x: int = 2,
    span_y: int = 2,
    pairs_capacity: int = 0,
) -> CsrBinning:
    """Triangle front end for `build_csr_binning_bbox` (bbox from corners)."""
    return build_csr_binning_bbox(
        tri_x.min(dim=0).values, tri_x.max(dim=0).values,
        tri_y.min(dim=0).values, tri_y.max(dim=0).values,
        payload_rows, valid, width, height,
        tile_w, tile_h, chunk, span_x, span_y, pairs_capacity,
    )


# Values of a padded slot's rows (the others are 0): the three edge constants
# at -1, so the slot covers no pixel, and a far zmin: padded slots sit at the
# end of a front-to-back run, so a large finite value keeps the early-exit
# key monotone.
_REJECT_ROWS = ((2, -1.0), (5, -1.0), (8, -1.0), (15, 3.0))


def build_csr_binning_bbox(
    xmin: torch.Tensor,  # [T] screen-space bbox
    xmax: torch.Tensor,
    ymin: torch.Tensor,
    ymax: torch.Tensor,
    payload_rows: torch.Tensor,  # [R, T] per-primitive payload (row 15 = zmin)
    valid: torch.Tensor,  # [T]
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 8,
    chunk: int = 128,
    span_x: int = 2,
    span_y: int = 2,
    pairs_capacity: int = 0,
) -> CsrBinning:
    dev = xmin.device
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    num_tiles = tiles_x * tiles_y
    T = xmin.shape[0]
    R = payload_rows.shape[0]
    if R < 16 or R % 8:
        raise ValueError("payload rows must be a multiple of 8, at least 16")
    if pairs_capacity <= 0:
        # Default capacity policy: ~2 tiles per primitive on average, like
        # the reference's expected-depth-complexity fragment buffer sizing
        # (PerPixelLinkedListLineRenderer.hpp:44-48). Overflow is counted.
        pairs_capacity = min(span_x * span_y * T, 2 * T + 65536)
    C = chunk
    cap_chunks = -(-pairs_capacity // C) + num_tiles  # worst-case padding

    on_screen = (xmax >= 0) & (ymax >= 0) & (xmin < width) & (ymin < height)
    # Sub-pixel cull: a primitive whose bbox straddles no pixel centre
    # (integer + 0.5) can never produce coverage.
    covers_x = torch.floor(xmax - 0.5) >= torch.ceil(xmin - 0.5)
    covers_y = torch.floor(ymax - 0.5) >= torch.ceil(ymin - 0.5)
    valid = valid & on_screen & covers_x & covers_y

    tx0 = _tile_index(xmin, tile_w, tiles_x)
    tx1 = _tile_index(xmax, tile_w, tiles_x)
    ty0 = _tile_index(ymin, tile_h, tiles_y)
    ty1 = _tile_index(ymax, tile_h, tiles_y)

    dx = torch.arange(span_x, dtype=torch.int32, device=dev)
    dy = torch.arange(span_y, dtype=torch.int32, device=dev)
    cand_tx = tx0[None, None, :] + dx[None, :, None]
    cand_ty = ty0[None, None, :] + dy[:, None, None]
    in_range = (
        (cand_tx <= tx1[None, None, :])
        & (cand_ty <= ty1[None, None, :])
        & valid[None, None, :]
    )
    tile_id = torch.where(
        in_range, cand_ty * tiles_x + cand_tx, torch.full_like(cand_tx, num_tiles)
    )

    # Single packed sort key: tile * 1024 + quantized depth bucket, front to
    # back within a tile. The payload's row 15 holds the bucket's lower edge
    # (build_payload quantizes it the same way), so chunk order and the
    # early-exit key agree exactly.
    zq = torch.clamp(payload_rows[15] * 1023.0, 0.0, 1023.0).to(torch.int32)
    key = tile_id * 1024 + zq[None, None, :]
    sorted_keys, perm = torch.sort(key.reshape(-1), stable=True)
    sorted_tris = (perm % T).to(torch.int32)  # pair column j = s * T + t

    bounds = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) * 1024
    edges = torch.searchsorted(sorted_keys, bounds, side="left").to(torch.int32)
    starts = edges[:-1]
    raw_counts = edges[1:] - starts

    # Chunk-pad each tile's run; truncate tiles that exceed the capacity
    # (deterministic, with an overflow count surfaced to the caller).
    zero1 = torch.zeros(1, dtype=torch.int32, device=dev)
    nchunks_raw = -(-raw_counts // C)
    base_raw = torch.cat([zero1, torch.cumsum(nchunks_raw, 0).to(torch.int32)])
    fit = base_raw[1:] <= cap_chunks
    nchunks = torch.where(
        fit, nchunks_raw, torch.clamp(cap_chunks - base_raw[:-1], min=0)
    )
    counts = torch.minimum(raw_counts, nchunks * C)
    overflow = torch.sum(raw_counts - counts).to(torch.int32)
    base = torch.cat([zero1, torch.cumsum(nchunks, 0).to(torch.int32)])[:-1]

    # Gather-form CSR fill: slot s belongs to tile t(s); its rank within the
    # tile maps back into the sorted pair array. The tile of a chunk is a
    # step function of the chunk index: scatter the tile starts and cumsum.
    slot = torch.arange(cap_chunks * C, dtype=torch.int32, device=dev)
    slot_chunk = slot // C
    chunk_marks = torch.zeros(cap_chunks + 1, dtype=torch.int32, device=dev)
    chunk_marks.index_add_(0, base.long(), torch.ones_like(base))
    tile_of_chunk = torch.cumsum(chunk_marks[:cap_chunks], 0) - 1
    tile_of_slot = torch.clamp(tile_of_chunk[slot_chunk.long()], 0, num_tiles - 1)
    rank = slot - base[tile_of_slot] * C
    slot_valid = (rank >= 0) & (rank < counts[tile_of_slot]) & (
        slot_chunk < base[tile_of_slot] + nchunks[tile_of_slot]
    )
    j = torch.where(slot_valid, starts[tile_of_slot] + rank, torch.zeros_like(rank))
    tri = torch.where(slot_valid, sorted_tris[j.long()], torch.zeros_like(rank))

    reject = torch.zeros(R, dtype=torch.float32, device=dev)
    for row, val in _REJECT_ROWS:
        reject[row] = val
    rows = payload_rows[:, tri.long()]  # [R, cap_chunks * C]
    rows = torch.where(slot_valid[None, :], rows, reject[:, None])
    return CsrBinning(
        payload=rows.reshape(R, cap_chunks, C),
        tile_chunk_base=base,
        tile_num_chunks=nchunks,
        overflow=overflow,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        chunk=C,
        num_primitives=T,
    )


def _tile_pixel_centres(tiles, tiles_x, tile_w, tile_h):
    """Pixel centres (gx, gy), each [B, P] float32, of the tiles `tiles` [B]."""
    lin = torch.arange(tile_w * tile_h, device=tiles.device)
    gx = ((tiles % tiles_x)[:, None] * tile_w + (lin % tile_w)[None, :]).float() + 0.5
    gy = ((tiles // tiles_x)[:, None] * tile_h + (lin // tile_w)[None, :]).float() + 0.5
    return gx, gy


def rasterize_triangles_reference(
    csr: CsrBinning,
    tile_w: int = 16,
    tile_h: int = 8,
    num_attr_planes: int = 0,
    batch_elems: int = 1 << 24,
    stats: Optional[dict] = None,
    use_early_z: bool = True,
):
    """Plain PyTorch version of the triangle raster kernel ->
    (depth [n_tiles, P], tri_id int32 [n_tiles, P], [attr planes ...]).

    Step c handles the c-th chunk of every tile that has one, in batches of
    tiles of at most `batch_elems` (slot, pixel) evaluations, so the chunks
    of a tile are walked in order as the kernel walks them. With
    `use_early_z` a tile stops, as the kernel's and the JAX kernel's do, at
    the first chunk whose conservative minimum depth (row 15 of its first
    slot) lies behind every pixel of the tile. That exit is part of the
    function: a float32 depth plane evaluated inside a sub-pixel or sliver
    triangle can come out nearer than its corners' minimum, so a later chunk
    could still have won. `stats`, if given, receives "takes": the (chunk,
    pixel) updates made, and "work": [n_tiles] int32, the chunks each tile
    evaluated.
    """
    payload = csr.payload
    dev = payload.device
    n_tiles = csr.tile_chunk_base.shape[0]
    C = csr.chunk
    P = tile_w * tile_h
    inf = float("inf")
    depth = torch.full((n_tiles, P), 2.0, dtype=torch.float32, device=dev)
    fid = torch.full((n_tiles, P), -1.0, dtype=torch.float32, device=dev)
    planes = torch.zeros((num_attr_planes, n_tiles, P), dtype=torch.float32, device=dev)
    nch = csr.tile_num_chunks.long()
    base = csr.tile_chunk_base.long()
    max_nch = int(nch.max()) if n_tiles else 0
    per_batch = max(1, batch_elems // (C * P))
    takes = 0
    running = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    work = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    for c in range(max_nch):
        running &= nch > c
        if use_early_z and c > 0:
            tiles = torch.nonzero(running).reshape(-1)
            behind = payload[15, base[tiles] + c, 0] > depth[tiles].max(dim=1).values
            running[tiles[behind]] = False
        active = torch.nonzero(running).reshape(-1)
        work[active] += 1
        for b0 in range(0, active.shape[0], per_batch):
            tiles = active[b0:b0 + per_batch]
            coef = payload[:, base[tiles] + c, :]  # [R, B, C]
            gx, gy = _tile_pixel_centres(tiles, csr.tiles_x, tile_w, tile_h)
            gxb, gyb = gx[:, None, :], gy[:, None, :]

            def functional(r):
                return (coef[r][:, :, None] * gxb + coef[r + 1][:, :, None] * gyb) \
                    + coef[r + 2][:, :, None]

            z = functional(9)
            inside = (functional(0) >= 0.0) & (functional(3) >= 0.0) \
                & (functional(6) >= 0.0) & (z >= 0.0) & (z <= 1.0)
            zm = torch.where(inside, z, torch.full_like(z, inf))  # [B, C, P]
            bz = zm.min(dim=1).values  # [B, P]
            row = depth[tiles]
            take = bz < row
            if not bool(take.any()):
                continue
            ids = functional(12)
            at_min = zm <= bz[:, None, :]
            bid = torch.where(at_min, ids, torch.full_like(ids, inf)).min(dim=1).values
            depth[tiles] = torch.where(take, bz, row)
            fid[tiles] = torch.where(take, bid, fid[tiles])
            takes += int(take.sum())
            if num_attr_planes:
                # The winner's slot: the first at the chunk's minimum depth
                # with the lowest id. Its planes are evaluated for it alone.
                win = at_min & (ids == bid[:, None, :])
                slot = win.to(torch.uint8).argmax(dim=1)  # [B, P]
                for jdx in range(num_attr_planes):
                    r = 16 + 3 * jdx
                    a, b, cc = (torch.gather(coef[r + k], 1, slot) for k in range(3))
                    val = (a * gx + b * gy) + cc
                    planes[jdx, tiles] = torch.where(take, val, planes[jdx, tiles])
    if stats is not None:
        stats["takes"] = takes
        stats["work"] = work
    tri_id = torch.where(fid < 0, -1, fid.to(torch.int32))
    return depth, tri_id, list(planes)


def _launcher():
    """The kernel's C entry point (built and loaded at first use), with
    its argument types declared so ctypes passes 64-bit pointers."""
    fn = _build.load("raster_triangle").raster_triangle_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _rasterize(csr, tile_w, tile_h, num_attr_planes, use_early_z, work):
    payload = csr.payload
    if payload.device.type == "cpu":
        stats = {}
        out = rasterize_triangles_reference(csr, tile_w, tile_h, num_attr_planes, stats=stats,
                                            use_early_z=use_early_z)
        if work is not None:
            work.copy_(stats["work"])
        return out
    if payload.device.type != "cuda":
        raise ValueError(f"triangle raster: unsupported device {payload.device}")

    n_tiles = csr.tile_chunk_base.shape[0]
    P = tile_w * tile_h
    if P % 32 or P > _MAX_PIXELS:
        raise ValueError(f"tile of {P} pixels: need a multiple of 32, at most {_MAX_PIXELS}")
    tx, ty = _THREAD_PIXELS
    if tile_w % tx or tile_h % ty or (P // (tx * ty)) % 32:
        raise ValueError(f"tile {tile_w}x{tile_h}: the kernel's threads own {tx}x{ty} pixels "
                         "and form whole warps")
    if payload.dtype != torch.float32 or payload.dim() != 3:
        raise ValueError("payload must be [R, chunks, chunk] float32")
    R, cap_chunks, C = payload.shape
    if C != csr.chunk or R < 16 + 3 * num_attr_planes or num_attr_planes < 0:
        raise ValueError(
            f"payload [{R}, ., {C}] does not hold chunk {csr.chunk} with "
            f"{num_attr_planes} attribute planes"
        )
    if C * _SHARED_PER_SLOT > _MAX_SHARED:
        raise ValueError(f"chunk {C}: two staged chunks of 16 rows exceed {_MAX_SHARED} B "
                         "of shared memory")
    if csr.num_primitives > MAX_ID:
        raise ValueError(
            f"{csr.num_primitives} primitives: ids are not exact in float32 beyond 2^24"
        )
    tensors = [payload, csr.tile_chunk_base, csr.tile_num_chunks]
    if work is not None:
        tensors.append(work)
        if work.dtype != torch.int32 or work.shape != (n_tiles,):
            raise ValueError("work must be [n_tiles] int32")
    for t in tensors:
        if t.device != payload.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous on the payload's device")
    if csr.tile_chunk_base.dtype != torch.int32 or csr.tile_num_chunks.dtype != torch.int32:
        raise ValueError("tile_chunk_base / tile_num_chunks must be int32")

    # The blocks take the tiles longest run first: the longest runs start
    # first instead of setting the tail (each tile writes its own slot).
    order = torch.argsort(csr.tile_num_chunks, descending=True).to(torch.int32)
    out = torch.empty((2 + num_attr_planes, n_tiles, P), dtype=torch.float32,
                      device=payload.device)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            payload.data_ptr(), csr.tile_chunk_base.data_ptr(),
            csr.tile_num_chunks.data_ptr(), order.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            cap_chunks, C, n_tiles, csr.tiles_x, tile_w, tile_h,
            num_attr_planes, int(use_early_z), stream,
        )
    if rc != 0:
        raise RuntimeError(f"raster_triangle kernel launch failed: CUDA error {rc}")
    rasterize_gbuffer.launches += 1
    fid = out[1]
    return out[0], torch.where(fid < 0, -1, fid.to(torch.int32)), list(out[2:])


def rasterize_depth(
    csr: CsrBinning,
    tile_w: int = 16,
    tile_h: int = 8,
    use_early_z: bool = True,
    work: Optional[torch.Tensor] = None,
):
    """Z-buffer pass -> (depth [n_tiles, P], tri_id int32 [n_tiles, P]).

    Depth is NDC z in [0, 1]; background pixels have depth 2.0 and id -1.
    The same kernel as `rasterize_gbuffer` with no attribute planes; its
    launches count in `rasterize_gbuffer.launches`.
    """
    depth, tri_id, _ = _rasterize(csr, tile_w, tile_h, 0, use_early_z, work)
    return depth, tri_id


def rasterize_gbuffer(
    csr: CsrBinning,
    num_attr_planes: int,
    tile_w: int = 16,
    tile_h: int = 8,
    use_early_z: bool = True,
    work: Optional[torch.Tensor] = None,
):
    """Full G-buffer pass -> (depth, tri_id, [attr planes ...]).

    A CUDA payload launches the CUDA kernel (counted in
    `rasterize_gbuffer.launches`); a CPU payload runs the plain version.
    `work`, an optional [n_tiles] int32 tensor, receives the chunks each
    tile evaluated after early-z.
    """
    return _rasterize(csr, tile_w, tile_h, num_attr_planes, use_early_z, work)


rasterize_gbuffer.launches = 0
