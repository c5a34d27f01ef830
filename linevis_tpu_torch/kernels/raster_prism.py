"""Analytic N-gon prism rasterizer: the reference's triangle-tube geometry
through the capsule binning.

Counterpart of `linevis_tpu/kernels/raster_prism.py`. The reference's
default raster geometry is the `tubeNumSubdivisions`-gon triangle tube
(`src/Renderers/Tubes/Tubes.hpp:40`): per segment, S ring vertices at each
end (parallel-transport frames), S quads split into 2S triangles. This
rasterizer instead intersects each pixel's ray with the convex prism bounded
by the S planarized side-quad planes and the two ring planes, per binned
segment. Ring vertices, frames and the faceted silhouette are those of the
triangle mesh (`geometry/tubes.py`); each side quad is planarized, exact on
straight runs and sub-pixel under curvature. The G-buffer carries the
radial normal `hit - axis(u)` like the capsule kernel's, so the shared
shading path applies unchanged; coverage is binary.

On a CUDA tensor `rasterize_prisms` launches the hand-written kernel
`csrc/raster_prism.cu`; on a CPU tensor it runs
`rasterize_prisms_reference`, the same function in plain PyTorch.

Payload rows 0-15 are the capsule layout (`kernels/raster_capsule.py`), so
the binning is byte-identical; rows 24-35 hold the parallel-transport frames
(na, bna, nb, bnb), gathered by sorted segment id after the sort
(`render/tube_raster.py:prepare_prism_frame`).

Equal depths go to the lower segment id (the minimum of (world t, id)),
whatever the candidate order; the JAX kernel breaks such ties by the lowest
id inside a `sub` block and by block order across blocks, a vector-shape
parameter that the port does not carry. Normalisations use 1/sqrt, not the
JAX kernel's `lax.rsqrt`, in the kernel and the plain version alike.

There is no early-z chunk exit, unlike in the JAX package: that exit holds
the tile's depth against the capsule's depth key, and the plane-bounded
prism reaches beyond the capsule where a line bends sharply (the ring planes
diverge), so a skipped candidate can be the nearest one. Every candidate of
a tile's run is evaluated.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.capsule_common import BIG as _BIG
from linevis_tpu_torch.kernels.capsule_common import pixel_rays
from linevis_tpu_torch.kernels.raster_capsule import _ids
from linevis_tpu_torch.kernels.raster_pallas import SortedBinning

__all__ = ["rasterize_prisms", "rasterize_prisms_reference", "ROW_FRAME0", "MAX_SIDES"]

ROW_FRAME0 = 24  # first frame row (na.x); 12 rows: na, bna, nb, bnb
MAX_SIDES = 16  # the CUDA kernel's shared-memory plane table (MAX_SIDES)
_MAX_PIXELS = 512  # threads per block in the CUDA kernel (MAX_THREADS)
_INT64_MAX = torch.iinfo(torch.int64).max


_ring_tables = {}


def ring_table(n_sides: int, device) -> torch.Tensor:
    """[2 * n_sides] float32: cos then sin of 2 pi s / n_sides (the angles
    of `geometry.tubes.tube_ring_directions`), made once per device."""
    key = (n_sides, str(device))
    if key not in _ring_tables:
        ang = [2.0 * math.pi * s / n_sides for s in range(n_sides)]
        _ring_tables[key] = torch.tensor(
            [math.cos(a) for a in ang] + [math.sin(a) for a in ang],
            dtype=torch.float32, device=device,
        )
    return _ring_tables[key]


def _add(u, v):
    return (u[0] + v[0], u[1] + v[1], u[2] + v[2])


def _sub(u, v):
    return (u[0] - v[0], u[1] - v[1], u[2] - v[2])


def _scale(u, s):
    return (u[0] * s, u[1] * s, u[2] * s)


def _dot(u, v):
    return (u[0] * v[0] + u[1] * v[1]) + u[2] * v[2]


def _cross(u, v):
    return (
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    )


def _planes(s, n_sides: int, cs: torch.Tensor):
    """The S + 2 planes of candidates `s` (payload rows, each [B]) as
    (nx, ny, nz, num) with num = n.oa - offset; f(t) = num + t * (n.dn) <= 0
    inside. The last two are the ring planes."""
    oa = (s[0], s[1], s[2])
    ba = (s[3], s[4], s[5])
    r_w = s[6]
    f = ROW_FRAME0
    na, bna = (s[f], s[f + 1], s[f + 2]), (s[f + 3], s[f + 4], s[f + 5])
    nb, bnb = (s[f + 6], s[f + 7], s[f + 8]), (s[f + 9], s[f + 10], s[f + 11])

    # Ring corner offsets relative to a.
    va, vb = [], []
    for k in range(n_sides):
        ck, sk = cs[k], cs[n_sides + k]
        va.append(_scale(_add(_scale(na, ck), _scale(bna, sk)), r_w))
        vb.append(_add(ba, _scale(_add(_scale(nb, ck), _scale(bnb, sk)), r_w)))
    half_ba = _scale(ba, 0.5)

    def plane_of(n, cpl):
        return (n[0], n[1], n[2], _dot(n, oa) - cpl)

    planes = []
    for k in range(n_sides):
        k1 = (k + 1) % n_sides
        # Planarized side quad: normal from the two mid-edge directions,
        # oriented away from the axis midpoint, through the centroid.
        d1 = _sub(_add(vb[k], vb[k1]), _add(va[k], va[k1]))
        d2 = _sub(_add(va[k1], vb[k1]), _add(va[k], vb[k]))
        nq = _cross(d1, d2)
        nq = _scale(nq, 1.0 / torch.sqrt(torch.clamp(_dot(nq, nq), min=1e-30)))
        mid = _scale(_add(_add(va[k], va[k1]), _add(vb[k], vb[k1])), 0.25)
        sgn = torch.where(_dot(nq, _sub(mid, half_ba)) >= 0.0, 1.0, -1.0)
        nq = _scale(nq, sgn)
        planes.append(plane_of(nq, _dot(nq, mid)))
    # Ring planes, orthogonal to the transported tangent t = n x b at each
    # end: inside is ta.(x - a) >= 0 and tb.(x - a) <= tb.ba.
    tb = _cross(nb, bnb)
    planes.append(plane_of(_scale(_cross(na, bna), -1.0), torch.zeros_like(r_w)))
    planes.append(plane_of(tb, _dot(tb, ba)))
    return planes


def _clip(planes, n_sides, dn):
    """Slab clip of rays dn (3 x [B, P]) against the candidates' planes ->
    (hit [B, P] bool, t_in [B, P])."""
    dnx, dny, dnz = dn
    t_in = torch.full_like(dnx, -_BIG)
    t_out = torch.full_like(dnx, _BIG)
    cap_in = torch.full_like(dnx, -_BIG)
    rej = torch.zeros_like(dnx, dtype=torch.bool)
    big = torch.full_like(dnx, _BIG)
    for k, (nx, ny, nz, num) in enumerate(planes):
        nx, ny, nz, num = (v[:, None] for v in (nx, ny, nz, num))
        den = (nx * dnx + ny * dny) + nz * dnz
        para = torch.abs(den) < 1e-12
        den_s = torch.where(para, torch.where(den >= 0.0, 1e-12, -1e-12), den)
        tp = -num * (1.0 / den_s)
        t_enter = torch.where((den < 0.0) & ~para, tp, -big)
        t_in = torch.maximum(t_in, t_enter)
        t_out = torch.minimum(t_out, torch.where((den > 0.0) & ~para, tp, big))
        if k >= n_sides:
            cap_in = torch.maximum(cap_in, t_enter)
        rej = rej | (para & (num > 0.0))
    # A hit enters last through a side, in front of the camera.
    hit = (t_in <= t_out) & (t_in > 0.0) & (t_in > cap_in) & ~rej
    return hit, t_in


def rasterize_prisms_reference(
    csr: SortedBinning,
    params: torch.Tensor,
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 8,
    n_sides: int = 8,
    batch_pairs: int = 4096,
):
    """Plain PyTorch version of the prism kernel (same contract as
    `rasterize_prisms`), vectorised over [pairs, P] batches.

    Pass 1 finds each pixel's winner as the minimum of the packed key
    (float bits of the world t, segment id); pass 2 recomputes the batches
    and writes the winners' G-buffer."""
    dev = csr.payload.device
    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    dn_all, invlen_all = pixel_rays(
        params, n_tiles, csr.tiles_x, tile_w, tile_h, width, height
    )
    zA, zB = params[9], params[10]
    cs = ring_table(n_sides, dev)

    counts = csr.tile_count.long()
    total = int(counts.sum())
    pair_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
    run_base = torch.cumsum(counts, 0) - counts
    pair_col = (csr.tile_start.long()[pair_tile]
                + torch.arange(total, device=dev) - run_base[pair_tile])
    lin = torch.arange(P, device=dev)

    def batches():
        for b0 in range(0, total, batch_pairs):
            tiles = pair_tile[b0:b0 + batch_pairs]
            s = csr.payload[:, pair_col[b0:b0 + batch_pairs]]  # [R, B]
            dn = tuple(d[tiles] for d in dn_all)
            pix = tiles[:, None] * P + lin[None, :]
            hit, t_in = _clip(_planes(s, n_sides, cs), n_sides, dn)
            # World t > 0 on a hit, so its float bits order like the floats.
            key = (t_in.view(torch.int32).long() << 32) | s[9].long()[:, None]
            key = torch.where(hit, key, torch.full_like(key, _INT64_MAX))
            yield pix, key, (s, dn, invlen_all[tiles], t_in)

    best = torch.full((n_tiles * P,), _INT64_MAX, dtype=torch.int64, device=dev)
    for pix, key, _ in batches():
        best.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), "amin")

    out = torch.zeros((10, n_tiles * P), dtype=torch.float32, device=dev)
    out[0] = 2.0
    out[1] = -1.0
    for pix, key, (s, dn, invlen, tw) in batches():
        win = (key == best[pix]) & (key != _INT64_MAX)
        if not bool(win.any()):
            continue
        s = s[:, :, None]
        oa = (s[0], s[1], s[2])
        ba = (s[3], s[4], s[5])
        bard = (ba[0] * dn[0] + ba[1] * dn[1]) + ba[2] * dn[2]
        y = _dot(ba, oa) + tw * bard
        uax = torch.clamp(y * (1.0 / torch.clamp(s[10], min=1e-20)), 0.0, 1.0)
        vals = [
            zA - zB / torch.clamp(tw * invlen, min=1e-12),
            s[9].expand_as(tw),
            s[7] + s[8] * uax,
            *((o + tw * d) - b * uax for o, d, b in zip(oa, dn, ba)),
            *(b.expand_as(tw) for b in ba),
            torch.ones_like(tw),
        ]
        idx = pix[win]
        for plane, v in enumerate(vals):
            out[plane, idx] = v[win]
    out = out.reshape(10, n_tiles, P)
    return out[0], _ids(out[1]), list(out[2:])


def _launcher():
    """The kernel's C entry point (built and loaded at first use), with
    its argument types declared so ctypes passes 64-bit pointers."""
    fn = _build.load("raster_prism").raster_prism_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, p, i, i, i, i, f, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def rasterize_prisms(
    csr: SortedBinning,
    params: torch.Tensor,  # [32], the capsule params layout
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 8,
    n_sides: int = 8,
    work: Optional[torch.Tensor] = None,
):
    """N-gon prism raster pass ->
    (z_ndc, seg_id int32, [attr, nx, ny, nz, tx, ty, tz, coverage]), each
    [n_tiles, tile_w * tile_h]: the output contract of `rasterize_capsules`.
    The payload must carry the 12 frame rows at ROW_FRAME0.

    A CUDA payload launches the CUDA kernel (and counts the launch in
    `rasterize_prisms.launches`); a CPU payload runs the plain version.
    `work`, an optional [n_tiles] int32 tensor, receives the candidates each
    tile evaluated: its whole run, `tile_count`.
    """
    payload = csr.payload
    if payload.dim() != 2 or payload.shape[0] < ROW_FRAME0 + 12:
        raise ValueError(
            f"prism payload needs frame rows {ROW_FRAME0}..{ROW_FRAME0 + 11}; "
            f"got shape {tuple(payload.shape)}"
        )
    if not 3 <= n_sides <= MAX_SIDES:
        raise ValueError(f"n_sides={n_sides}: the prism kernel takes 3..{MAX_SIDES}")
    if payload.device.type == "cpu":
        if work is not None:
            work.copy_(csr.tile_count)
        return rasterize_prisms_reference(
            csr, params, width, height, tile_w, tile_h, n_sides=n_sides
        )
    if payload.device.type != "cuda":
        raise ValueError(f"rasterize_prisms: unsupported device {payload.device}")

    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    if P % 32 or P > _MAX_PIXELS:
        raise ValueError(f"tile of {P} pixels: need a multiple of 32, at most {_MAX_PIXELS}")
    if payload.dtype != torch.float32:
        raise ValueError("payload must be float32")
    if params.dtype != torch.float32 or params.numel() < 11:
        raise ValueError("params must be float32 with at least 11 entries")
    tensors = [payload, csr.tile_start, csr.tile_count, params]
    if work is not None:
        tensors.append(work)
        if work.dtype != torch.int32 or work.shape != (n_tiles,):
            raise ValueError("work must be [n_tiles] int32")
    for t in tensors:
        if t.device != payload.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous on the payload's device")
    if csr.tile_start.dtype != torch.int32 or csr.tile_count.dtype != torch.int32:
        raise ValueError("tile_start / tile_count must be int32")

    cs = ring_table(n_sides, payload.device)
    # The blocks take the tiles longest run first: the longest runs start
    # first instead of setting the tail (each tile writes its own slot).
    order = csr.longest_first
    out = torch.empty((10, n_tiles, P), dtype=torch.float32, device=payload.device)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            payload.data_ptr(), payload.shape[1],
            csr.tile_start.data_ptr(), csr.tile_count.data_ptr(), order.data_ptr(),
            params.data_ptr(), cs.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            n_tiles, csr.tiles_x, tile_w, tile_h,
            2.0 / width, 2.0 / height, n_sides, stream,
        )
    if rc != 0:
        raise RuntimeError(f"raster_prism kernel launch failed: CUDA error {rc}")
    rasterize_prisms.launches += 1
    return out[0], _ids(out[1]), list(out[2:])


rasterize_prisms.launches = 0
