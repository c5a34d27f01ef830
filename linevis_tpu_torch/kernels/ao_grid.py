"""Ray-traced ambient occlusion over a uniform segment grid.

Counterpart of `linevis_tpu/kernels/ao_grid.py`. The scene's capsule
segments are binned once into a uniform G^3 grid whose cells hold contiguous
runs of cell-sorted segment records (`build_segment_grid`). An AO ray is
short, so the cells it can cross are sampled up front (`max_ray_cells`
points along it), expanded into (cell, ray) pairs and sorted by cell. Pairs
and records are then both cell-sorted, so each chunk of 128 pairs faces ONE
contiguous slot range of records: a dense [segments x rays] any-hit test
with no gathers. On CUDA tensors `trace_pairs` launches the hand-written
kernel `csrc/ao_grid.cu` for that test; on CPU tensors it runs
`trace_pairs_reference`, the same function in plain PyTorch.

A chunk tests every slot from the 128-aligned floor of its first cell's run
to the end of its last cell's run, so a ray is also tested against segments
of neighbouring cells that share its chunk. Any hit inside t_max is a true
occlusion, so this only adds true positives; but it makes a ray's result
depend on which pairs share its chunk, i.e. on the order of the pair sort
(stable here, by pair index within a cell).

Segment record rows (camera-independent; built once per scene):
  0-2: a, 3-5: ba, 6: r, 7: baba.
Ray record rows: 0-2: origin, 3-5: direction (unit), 6: t_max, 7: zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.automation import profiling
from linevis_tpu_torch.kernels import _build

__all__ = [
    "SegmentGrid", "PairChunks", "auto_grid_span", "build_segment_grid",
    "expand_ray_pairs", "trace_pairs", "trace_pairs_reference", "scatter_occlusion",
    "trace_ao_occlusion",
]

_POISON = 1e10  # position of records no ray can hit
_BATCH_CHUNKS = 1024  # pair chunks per step of the plain version (memory)


@dataclasses.dataclass
class SegmentGrid:
    """Uniform grid CSR over capsule segments (camera-independent).

    records:    [8, Ns + chunk] float32, cell-sorted segment records
    cell_start: [G^3] int32; cell_count: [G^3] int32
    origin:     [3] grid minimum corner; inv_cell: [3] 1 / cell size
    """

    records: torch.Tensor
    cell_start: torch.Tensor
    cell_count: torch.Tensor
    origin: torch.Tensor
    inv_cell: torch.Tensor
    resolution: int
    chunk: int


@dataclasses.dataclass
class PairChunks:
    """The cell-sorted (cell, ray) pairs of one trace, in chunks of C.

    rays:       [8, n_pairs_pad + C] float32 ray records in pair order
    seg_begin:  [n_chunks] int32, first record slot of each chunk (C-aligned)
    seg_chunks: [n_chunks] int32, record chunks each pair chunk tests
    ray_ids:    [n_pairs] int64, the ray of each pair
    keys:       [n_pairs] cell of each pair (G^3: dropped pair)
    """

    rays: torch.Tensor
    seg_begin: torch.Tensor
    seg_chunks: torch.Tensor
    ray_ids: torch.Tensor
    keys: torch.Tensor


def auto_grid_span(a, ba, radius, resolution: int) -> int:
    """Cells per axis a segment's AABB may span at `resolution` (host-side;
    use as the `span` of `build_segment_grid`). a, ba: [3, S] arrays."""
    a = np.asarray(a)
    b = a + np.asarray(ba)
    lo = np.minimum(a, b).min(axis=1) - radius
    hi = np.maximum(a, b).max(axis=1) + radius
    cell = np.maximum(hi - lo, 1e-6) / resolution
    ext = (np.abs(np.asarray(ba)) + 2.0 * radius).max(axis=1)
    return int(np.ceil((ext / cell).max())) + 1


def _cell_index(x, G):
    """floor(x) clipped to [0, G-1] as int64 (x in cell units)."""
    return torch.clamp(torch.floor(x), 0, G - 1).long()


def build_segment_grid(
    a: torch.Tensor,  # [3, S]
    ba: torch.Tensor,  # [3, S]
    radius: float,
    mask: torch.Tensor,  # [S]
    resolution: int = 64,
    chunk: int = 128,
    span: int = 2,
) -> SegmentGrid:
    """Bin the segments into a resolution^3 grid over their bounds.

    Each segment is entered into the span^3 cell window at the low corner of
    its AABB, as far as the AABB reaches: a segment whose AABB spans more
    than `span` cells per axis gets clamped coverage (size `span` with
    `auto_grid_span`, or lower `resolution`). Pairs outside the AABB or of
    masked segments keep a slot behind every cell's run, with their position
    moved out of every ray's reach."""
    S = a.shape[1]
    G = resolution
    dev = a.device
    b = a + ba
    big = 3e38
    lo_seg, hi_seg = torch.minimum(a, b), torch.maximum(a, b)
    lo_all = torch.where(mask[None], lo_seg, big).amin(dim=1) - radius
    hi_all = torch.where(mask[None], hi_seg, -big).amax(dim=1) + radius
    cell = torch.clamp(hi_all - lo_all, min=1e-6) / G
    inv_cell = 1.0 / cell

    c0 = _cell_index((lo_seg - radius - lo_all[:, None]) * inv_cell[:, None], G)
    c1 = _cell_index((hi_seg + radius - lo_all[:, None]) * inv_cell[:, None], G)
    d = torch.arange(span, device=dev)
    cx = c0[0][None, None, None, :] + d[None, None, :, None]
    cy = c0[1][None, None, None, :] + d[None, :, None, None]
    cz = c0[2][None, None, None, :] + d[:, None, None, None]
    ok = (cx <= c1[0]) & (cy <= c1[1]) & (cz <= c1[2]) & mask
    key = torch.where(ok, (cz * G + cy) * G + cx, G * G * G).reshape(-1)

    rows = torch.stack([
        a[0], a[1], a[2], ba[0], ba[1], ba[2],
        torch.full((S,), radius, dtype=torch.float32, device=dev),
        torch.sum(ba * ba, dim=0),
    ])
    n_pairs = span ** 3 * S
    skeys, perm = torch.sort(key, stable=True)
    records = torch.zeros((8, n_pairs + chunk), dtype=torch.float32, device=dev)
    records[:, :n_pairs] = rows[:, perm % S]
    # The tracer's chunk ranges may reach into the sorted tail and the
    # padding, so those records must be unhittable.
    records[0:3, :n_pairs] = torch.where(
        ok.reshape(-1)[perm], records[0:3, :n_pairs], _POISON
    )
    records[0:3, n_pairs:] = _POISON

    crange = torch.arange(G * G * G + 1, device=dev)
    bounds = torch.searchsorted(skeys, crange, right=False)
    return SegmentGrid(
        records=records,
        cell_start=bounds[:-1].to(torch.int32),
        cell_count=(bounds[1:] - bounds[:-1]).to(torch.int32),
        origin=lo_all,
        inv_cell=inv_cell,
        resolution=G,
        chunk=chunk,
    )


def expand_ray_pairs(
    origins: torch.Tensor,  # [3, R]
    dirs: torch.Tensor,  # [3, R] unit
    t_max: torch.Tensor,  # [R]
    valid: torch.Tensor,  # [R] bool
    grid: SegmentGrid,
    max_ray_cells: int = 8,
) -> PairChunks:
    """Sample `max_ray_cells` cells along every ray, drop repeated and empty
    cells, sort the (cell, ray) pairs by cell (stable) and give every chunk
    of C pairs the record slots of its first to its last cell. While a
    profiler records, counts the pairs sorted (`ao.pairs_sorted`) and those
    kept, with a cell below G^3 (`ao.pairs_kept`, on the device)."""
    R = origins.shape[1]
    G, C = grid.resolution, grid.chunk
    G3 = G * G * G
    dev = origins.device

    ts = torch.linspace(0.0, 1.0, max_ray_cells, dtype=torch.float32, device=dev)
    p = origins[:, None, :] + dirs[:, None, :] * (ts[None, :, None] * t_max[None, None, :])
    cc = _cell_index((p - grid.origin[:, None, None]) * grid.inv_cell[:, None, None], G)
    cell = (cc[2] * G + cc[1]) * G + cc[0]  # [M, R]
    prev = torch.cat([torch.full((1, R), -1, dtype=cell.dtype, device=dev), cell[:-1]])
    keep = (cell != prev) & valid[None, :] & (grid.cell_count[cell] > 0)
    key = torch.where(keep, cell, G3).reshape(-1)

    n_pairs = max_ray_cells * R
    skeys, perm = torch.sort(key, stable=True)
    if profiling.tracing():
        profiling.count("ao.pairs_sorted", n_pairs)
        profiling.count("ao.pairs_kept", torch.searchsorted(skeys, G3))
    ray_ids = perm % R
    n_pairs_pad = -(-n_pairs // C) * C
    rays = torch.zeros((8, n_pairs_pad + C), dtype=torch.float32, device=dev)
    rays[0:3, :n_pairs] = origins[:, ray_ids]
    rays[3:6, :n_pairs] = dirs[:, ray_ids]
    rays[6, :n_pairs] = t_max[ray_ids]

    # Dropped pairs (key G^3) sort to the tail; their chunks walk the last
    # cell's run like any other and are masked when the result is scattered.
    skeys_p = torch.full((n_pairs_pad,), G3, dtype=skeys.dtype, device=dev)
    skeys_p[:n_pairs] = skeys
    by_chunk = skeys_p.reshape(-1, C)
    first_cell = by_chunk[:, 0].clamp(0, G3 - 1)
    last_cell = by_chunk[:, C - 1].clamp(0, G3 - 1)
    s_begin = grid.cell_start[first_cell]
    s_end = grid.cell_start[last_cell] + grid.cell_count[last_cell]
    begin_floor = torch.div(s_begin, C, rounding_mode="floor") * C
    seg_chunks = torch.where(
        s_end > s_begin,
        torch.div(s_end - begin_floor + C - 1, C, rounding_mode="floor"), 0,
    )
    return PairChunks(
        rays=rays, seg_begin=begin_floor.to(torch.int32),
        seg_chunks=seg_chunks.to(torch.int32), ray_ids=ray_ids, keys=skeys,
    )


def _any_hit(ray, seg):
    """Ray-capsule any-hit of rays `ray` (7 x [A, 1, C]: o, d, t_max) against
    records `seg` (8 x [A, C, 1]) -> bool [A, C, C] (segment, ray): the body
    and both end spheres, entry surfaces only, 1e-4 < t < t_max."""
    ox, oy, oz, dx, dy, dz, tmax = ray
    oax, oay, oaz = ox - seg[0], oy - seg[1], oz - seg[2]
    bard = seg[3] * dx + seg[4] * dy + seg[5] * dz
    rdoa = oax * dx + oay * dy + oaz * dz
    baba = torch.clamp(seg[7], min=1e-20)
    rr = seg[6] * seg[6]
    # Re-origin at the closest approach to the segment midpoint (precision).
    t0 = -(rdoa + 0.5 * bard)
    pax, pay, paz = oax + t0 * dx, oay + t0 * dy, oaz + t0 * dz
    baoa = seg[3] * pax + seg[4] * pay + seg[5] * paz
    oaoa = pax * pax + pay * pay + paz * paz
    rd = rdoa + t0
    k2 = torch.clamp(baba - bard * bard, min=1e-20)
    k1 = baba * rd - baoa * bard
    k0 = baba * oaoa - baoa * baoa - rr * baba
    h = k1 * k1 - k2 * k0
    tb = (-k1 - torch.sqrt(torch.clamp(h, min=0.0))) / k2
    yb = baoa + tb * bard
    okb = (h >= 0.0) & (yb > 0.0) & (yb < baba)
    ha = rd * rd - (oaoa - rr)
    ta = -rd - torch.sqrt(torch.clamp(ha, min=0.0))
    oka = (ha >= 0.0) & (baoa + ta * bard <= 0.0)
    b1b = rd - bard
    obob = oaoa - 2.0 * baoa + baba
    hb = b1b * b1b - (obob - rr)
    tc = -b1b - torch.sqrt(torch.clamp(hb, min=0.0))
    okc = (hb >= 0.0) & (baoa + tc * bard >= baba)

    def inside(tp, ok):
        t_world = t0 + tp
        return ok & (t_world > 1e-4) & (t_world < tmax)

    return inside(tb, okb) | inside(ta, oka) | inside(tc, okc)


def trace_pairs_reference(
    rays_sorted: torch.Tensor,  # [8, >= n_chunks * C]
    seg_begin: torch.Tensor,  # [n_chunks] int32, C-aligned
    seg_chunks: torch.Tensor,  # [n_chunks] int32
    records: torch.Tensor,  # [8, Ns + C]
    chunk: int = 128,
    walked: Optional[torch.Tensor] = None,
    tests: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the AO kernel (same contract as
    `trace_pairs`). Step c tests, for every pair chunk that has a c-th record
    chunk and still has an unoccluded ray, its 128 rays against that record
    chunk's 128 slots, `_BATCH_CHUNKS` pair chunks at a time."""
    C = chunk
    dev = rays_sorted.device
    n_chunks = seg_begin.shape[0]
    occ = torch.zeros((n_chunks, C), dtype=torch.bool, device=dev)
    steps = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    needed = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    rays_c = rays_sorted[:7, :n_chunks * C].reshape(7, n_chunks, C)
    begin = seg_begin.long()
    lane = torch.arange(C, device=dev)
    last_col = records.shape[1] - 1
    for c in range(int(seg_chunks.max()) if n_chunks else 0):
        active = torch.nonzero((seg_chunks > c) & ~occ.all(dim=1)).flatten()
        steps[active] += 1
        for idx in active.split(_BATCH_CHUNKS):
            cols = begin[idx, None] + c * C + lane
            seg = records[:, cols.clamp(max=last_col)]
            # Slots past the records' end are the unhittable padding record.
            seg = torch.where(cols[None] > last_col,
                              seg.new_tensor([_POISON] * 3 + [0.0] * 5)[:, None, None], seg)
            needed[idx] += ((~occ[idx]).sum(dim=1) * (seg[0] < 0.5 * _POISON).sum(dim=1)).int()
            hit = _any_hit(rays_c[:, idx, None, :], seg[:, :, :, None])
            occ[idx] |= hit.any(dim=1)
    if walked is not None:
        walked.copy_(steps)
    if tests is not None:
        tests.copy_(needed)
    return occ.float().reshape(-1)


def _launcher():
    """The kernel's C entry point (built and loaded at first use), with its
    argument types declared so ctypes passes 64-bit pointers."""
    fn = _build.load("ao_grid").ao_grid_launch
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, ll, p, p, p, ll, p, p, p, p, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def trace_pairs(
    rays_sorted: torch.Tensor,  # [8, >= n_chunks * C] float32
    seg_begin: torch.Tensor,  # [n_chunks] int32 first slot (C-aligned)
    seg_chunks: torch.Tensor,  # [n_chunks] int32
    records: torch.Tensor,  # [8, Ns + C] float32
    chunk: int = 128,
    walked: Optional[torch.Tensor] = None,
    tests: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Occlusion flag of every pair -> [n_chunks * C] float32 in {0, 1}.

    Pair chunk i tests its C rays against the record slots
    [seg_begin[i], seg_begin[i] + seg_chunks[i] * C), one record chunk after
    the other, and stops once all its rays are occluded. `walked`, an
    optional [n_chunks] int32 tensor, receives the record chunks each pair
    chunk tested; `tests`, likewise, the (slot, ray) tests its result needed:
    per walked record chunk, its hittable slots times the rays not yet
    occluded when it is staged.

    CUDA tensors launch the CUDA kernel (and count the launch in
    `trace_pairs.launches`), whose blocks walk only the active chunks; the
    pairs of the other chunks, and their counts, are 0. CPU tensors run the
    plain version.
    """
    if rays_sorted.device.type == "cpu":
        return trace_pairs_reference(rays_sorted, seg_begin, seg_chunks, records, chunk,
                                     walked=walked, tests=tests)
    if rays_sorted.device.type != "cuda":
        raise ValueError(f"trace_pairs: unsupported device {rays_sorted.device}")
    n_chunks = seg_begin.shape[0]
    if chunk != 128:
        raise ValueError(f"chunk={chunk}: the CUDA kernel takes chunks of 128")
    for t, rows in ((rays_sorted, 7), (records, 8)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] < rows:
            raise ValueError(f"rays and records must be [>= {rows}, n] float32")
    if rays_sorted.shape[1] < n_chunks * chunk:
        raise ValueError("rays_sorted holds fewer than n_chunks * chunk columns")
    counts = [seg_begin, seg_chunks] + [t for t in (walked, tests) if t is not None]
    for t in counts:
        if t.dtype != torch.int32 or t.shape != (n_chunks,):
            raise ValueError("seg_begin, seg_chunks, walked and tests must be "
                             "[n_chunks] int32")
    for t in [rays_sorted, records, *counts]:
        if t.device != rays_sorted.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous on the rays' device")

    occ = torch.zeros(n_chunks * chunk, dtype=torch.float32, device=rays_sorted.device)
    if n_chunks == 0:
        return occ
    # The kernel's work-list counters and entries (ao_grid.cu), zero-filled.
    sched = torch.zeros(n_chunks + 4, dtype=torch.int32, device=rays_sorted.device)
    with torch.cuda.device(rays_sorted.device):
        rc = _launcher()(
            rays_sorted.data_ptr(), rays_sorted.shape[1], seg_begin.data_ptr(),
            seg_chunks.data_ptr(), records.data_ptr(), records.shape[1], sched.data_ptr(),
            occ.data_ptr(), None if walked is None else walked.data_ptr(),
            None if tests is None else tests.data_ptr(), n_chunks,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ao_grid kernel launch failed: CUDA error {rc}")
    trace_pairs.launches += 1
    return occ


trace_pairs.launches = 0


def scatter_occlusion(pairs: PairChunks, occ_pairs: torch.Tensor, n_rays: int,
                      resolution: int) -> torch.Tensor:
    """Max of the pairs' flags per ray -> [n_rays] float32; dropped pairs and
    the padded tail do not write."""
    n_pairs = pairs.keys.shape[0]
    vals = torch.where(pairs.keys < resolution ** 3, occ_pairs[:n_pairs], 0.0)
    occluded = torch.zeros(n_rays, dtype=torch.float32, device=occ_pairs.device)
    return occluded.scatter_reduce_(0, pairs.ray_ids, vals, "amax", include_self=True)


def trace_ao_occlusion(
    origins: torch.Tensor,  # [3, R]
    dirs: torch.Tensor,  # [3, R] unit
    t_max: torch.Tensor,  # [R]
    valid: torch.Tensor,  # [R] bool
    grid: SegmentGrid,
    max_ray_cells: int = 8,
) -> torch.Tensor:
    """Occluded [R] in {0, 1}: 1 where the ray hits a capsule of a sampled
    cell (or of a cell that shares the pair's chunk) within t_max. Never a
    false occlusion; a crossing of a cell that the samples skip is missed."""
    with profiling.span("ao.pairs"):
        pairs = expand_ray_pairs(origins, dirs, t_max, valid, grid, max_ray_cells)
    with profiling.span("ao.trace"):
        occ_pairs = trace_pairs(pairs.rays, pairs.seg_begin, pairs.seg_chunks, grid.records,
                                grid.chunk)
    with profiling.span("ao.scatter"):
        return scatter_occlusion(pairs, occ_pairs, origins.shape[1], grid.resolution)
