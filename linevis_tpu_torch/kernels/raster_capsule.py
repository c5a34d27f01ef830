"""Analytic capsule (tube segment) rasterizer — the primary line renderer.

Counterpart of `linevis_tpu/kernels/raster_capsule.py`. Each line segment
is a capsule (linear swept sphere) intersected exactly per pixel, driven by
the sort-carried tile binning. On a CUDA tensor `rasterize_capsules`
launches the hand-written kernel `csrc/raster_capsule.cu`; on a CPU tensor
it runs `rasterize_capsules_reference`, the same function in plain PyTorch.

Payload rows (per pair, packed by `render/tube_raster.py:prepare_capsule_frame`;
o = camera origin, capsule (a, b, r)):
  0-2: oa = o - a        3-5: ba = b - a      6: r
  7: attr0   8: dattr    9: id (float, exact below 2^24)   10: |ba|^2
  11-12: alpha0, dalpha (opacity optimization)   13: cap_a (start cap)
  14: Cb (OIT kernels)   15: bucket-floored min NDC depth (sort key)
  16-23: derived scalars (OIT kernels)
params[32]: 0-8 ray basis (row-major, dir = B @ [u_ndc, v_ndc, 1]),
9 A and 10 Bc of z_ndc = A - Bc / view_z, 19 world units per pixel at view
depth 1 (coverage AA); see `render/tube_raster.py` for the rest.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.capsule_common import BIG as _BIG
from linevis_tpu_torch.kernels.capsule_common import pixel_rays
from linevis_tpu_torch.kernels.raster_pallas import SortedBinning

__all__ = ["rasterize_capsules", "rasterize_capsules_reference"]

_MAX_PIXELS = 512  # threads per block in the CUDA kernel (MAX_THREADS)
_INT64_MAX = torch.iinfo(torch.int64).max


def _candidates(s, dn, invlen, px, use_aa):
    """Capsule hits of candidate rows `s` ([B, 1] each, indexed by payload
    row) against rays dn ([B, P] each). Returns (tall, t0, cov, geometry)
    with tall = _BIG on a miss; t0 + tall is the world-space t."""
    dnx, dny, dnz = dn
    bard = s[3] * dnx + s[4] * dny + s[5] * dnz
    rdoa = s[0] * dnx + s[1] * dny + s[2] * dnz
    baba = s[10]
    r_w = s[6]
    rr = r_w * r_w

    # Re-origin the ray at its closest approach to the segment midpoint:
    # segments are ~1e-3 of the camera distance, and the raw quadratic
    # cancels catastrophically in f32.
    t0 = -(rdoa + 0.5 * bard)
    oax = s[0] + t0 * dnx
    oay = s[1] + t0 * dny
    oaz = s[2] + t0 * dnz
    baoa = s[3] * oax + s[4] * oay + s[5] * oaz
    oaoa = oax * oax + oay * oay + oaz * oaz
    rd = rdoa + t0

    # Cylinder body.
    k2 = torch.clamp(baba - bard * bard, min=1e-20)
    k1 = baba * rd - baoa * bard
    k0 = baba * oaoa - baoa * baoa - rr * baba
    h = k1 * k1 - k2 * k0
    tb = (-k1 - torch.sqrt(torch.clamp(h, min=0.0))) / k2
    yb = baoa + tb * bard
    # Sphere cap at a.
    ha = rd * rd - (oaoa - rr)
    ta = -rd - torch.sqrt(torch.clamp(ha, min=0.0))
    ya = baoa + ta * bard
    # Sphere cap at b.
    b1b = rd - bard
    obob = oaoa - 2.0 * baoa + baba
    hb = b1b * b1b - (obob - rr)
    tbb = -b1b - torch.sqrt(torch.clamp(hb, min=0.0))
    yb2 = baoa + tbb * bard
    cap_a = s[13] > 0.5

    if use_aa:
        # Analytic coverage AA: accept silhouettes within half a pixel
        # footprint; coverage = 0.5 + signed pixel distance.
        def sdist(d2, t_rel):
            w_px = torch.clamp((t0 + t_rel) * invlen, min=1e-6) * px
            return (r_w - torch.sqrt(torch.clamp(d2, min=0.0))) * (1.0 / w_px)

        # Miss distance of the body: the ray-to-axis line distance
        # |oa' . (dn x ba)| / |dn x ba|, with oa' at segment scale. (The
        # JAX kernel's equal form r^2 - h / (k2 |ba|^2) cancels in f32 for
        # segments ~1e-3 long: up to 2e-3 px of coverage on the tornado.)
        nx = dny * s[5] - dnz * s[4]
        ny = dnz * s[3] - dnx * s[5]
        nz = dnx * s[4] - dny * s[3]
        on = oax * nx + oay * ny + oaz * nz
        sdb = sdist(on * on / torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20), tb)
        sda = sdist(rr - ha, ta)
        sdb2 = sdist(rr - hb, tbb)
        okb = (sdb > -0.5) & (yb > 0.0) & (yb < baba)
        oka = (sda > -0.5) & (ya <= 0.0) & cap_a
        okb2 = (sdb2 > -0.5) & (yb2 >= baba)
    else:
        okb = (h >= 0.0) & (yb > 0.0) & (yb < baba)
        oka = (ha >= 0.0) & (ya <= 0.0) & cap_a
        okb2 = (hb >= 0.0) & (yb2 >= baba)
    okb = okb & (t0 + tb > 0.0)
    oka = oka & (t0 + ta > 0.0)
    okb2 = okb2 & (t0 + tbb > 0.0)

    big = torch.full_like(tb, _BIG)
    tall = torch.minimum(
        torch.where(okb, tb, big),
        torch.minimum(torch.where(oka, ta, big), torch.where(okb2, tbb, big)),
    )
    if use_aa:
        zero = torch.zeros_like(tb)

        def covp(sd, ok):
            return torch.where(ok, torch.clamp(0.5 + sd, 0.0, 1.0), zero)

        cov = torch.maximum(
            covp(sdb, okb), torch.maximum(covp(sda, oka), covp(sdb2, okb2))
        )
    else:
        cov = (tall < _BIG).float()
    return tall, t0, cov, (bard, baoa, oax, oay, oaz)


def rasterize_capsules_reference(
    csr: SortedBinning,
    params: torch.Tensor,
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 8,
    use_aa: bool = True,
    batch_pairs: int = 4096,
):
    """Plain PyTorch version of the capsule kernel (same contract as
    `rasterize_capsules`), vectorised over [pairs, P] batches.

    Pass 1 finds each pixel's winner as the minimum of the packed key
    (float bits of the world t, segment id) — nearest hit, equal depths to
    the lower id; pass 2 recomputes the batches and writes the winners'
    G-buffer. It evaluates every pair (no early-z, which only skips
    candidates that cannot win)."""
    dev = csr.payload.device
    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    dn_all, invlen_all = pixel_rays(
        params, n_tiles, csr.tiles_x, tile_w, tile_h, width, height
    )
    zA, zB, px = params[9], params[10], params[19]

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
            s = csr.payload[:, pair_col[b0:b0 + batch_pairs]][:, :, None]
            dn = tuple(d[tiles] for d in dn_all)
            invlen = invlen_all[tiles]
            pix = tiles[:, None] * P + lin[None, :]
            tall, t0, cov, geo = _candidates(s, dn, invlen, px, use_aa)
            hit = tall < _BIG
            tw = torch.where(hit, t0 + tall, torch.full_like(tall, _BIG))
            # World t > 0 on a hit, so its float bits order like the floats.
            key = (tw.view(torch.int32).long() << 32) | s[9].long()
            key = torch.where(hit, key, torch.full_like(key, _INT64_MAX))
            yield pix, key, (s, dn, invlen, tall, tw, cov, geo)

    best = torch.full((n_tiles * P,), _INT64_MAX, dtype=torch.int64, device=dev)
    for pix, key, _ in batches():
        best.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), "amin")

    out = torch.zeros((10, n_tiles * P), dtype=torch.float32, device=dev)
    out[0] = 2.0
    out[1] = -1.0
    for pix, key, (s, dn, invlen, tall, tw, cov, geo) in batches():
        win = (key == best[pix]) & (key != _INT64_MAX)
        if not bool(win.any()):
            continue
        bard, baoa, oax, oay, oaz = geo
        uax = torch.clamp((baoa + tall * bard) / s[10], 0.0, 1.0)
        ba = (s[3], s[4], s[5])
        vals = [
            zA - zB / torch.clamp(tw * invlen, min=1e-12),
            s[9].expand_as(tall),
            s[7] + s[8] * uax,
            *(tall * d + o - b * uax for d, o, b in zip(dn, (oax, oay, oaz), ba)),
            *(b.expand_as(tall) for b in ba),
            cov,
        ]
        idx = pix[win]
        for plane, v in enumerate(vals):
            out[plane, idx] = v[win]
    out = out.reshape(10, n_tiles, P)
    return out[0], _ids(out[1]), list(out[2:])


def _ids(fid: torch.Tensor) -> torch.Tensor:
    return torch.where(fid < 0, -1, fid.to(torch.int32))


def _launcher():
    """The kernel's C entry point (built and loaded at first use), with
    its argument types declared so ctypes passes 64-bit pointers."""
    fn = _build.load("raster_capsule").raster_capsule_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, i, i, i, i, f, f, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def rasterize_capsules(
    csr: SortedBinning,
    params: torch.Tensor,  # [32] (ray basis, zA, zB, ..., 19: px scale)
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 8,
    use_early_z: bool = True,
    use_aa: bool = True,
    work: Optional[torch.Tensor] = None,
):
    """Capsule raster pass ->
    (z_ndc, seg_id int32, [attr, nx, ny, nz, tx, ty, tz, coverage]), each
    [n_tiles, tile_w * tile_h]; seg_id is -1 and z_ndc 2.0 where no capsule
    is hit.

    A CUDA payload launches the CUDA kernel (and counts the launch in
    `rasterize_capsules.launches`); a CPU payload runs the plain version.
    `work`, an optional [n_tiles] int32 tensor, receives the candidates each
    tile evaluated (after early-z on the card; every pair on the CPU).
    """
    payload = csr.payload
    if payload.device.type == "cpu":
        if work is not None:
            work.copy_(csr.tile_count)
        return rasterize_capsules_reference(
            csr, params, width, height, tile_w, tile_h, use_aa=use_aa
        )
    if payload.device.type != "cuda":
        raise ValueError(f"rasterize_capsules: unsupported device {payload.device}")

    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    if tile_w % 8 or tile_h % 4 or P > _MAX_PIXELS:
        raise ValueError(f"tile {tile_w}x{tile_h}: the kernel's warps take 8x4 pixel blocks, "
                         f"at most {_MAX_PIXELS} pixels")
    if payload.dtype != torch.float32 or payload.dim() != 2 or payload.shape[0] < 16:
        raise ValueError("payload must be [R >= 16, pairs] float32")
    if params.dtype != torch.float32 or params.numel() < 20:
        raise ValueError("params must be float32 with at least 20 entries")
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

    # The blocks take the tiles longest run first: the longest runs start
    # first instead of setting the tail (each tile writes its own slot).
    order = csr.longest_first
    out = torch.empty((10, n_tiles, P), dtype=torch.float32, device=payload.device)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            payload.data_ptr(), payload.shape[1],
            csr.tile_start.data_ptr(), csr.tile_count.data_ptr(), order.data_ptr(),
            params.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            n_tiles, csr.tiles_x, tile_w, tile_h,
            2.0 / width, 2.0 / height, int(use_early_z), int(use_aa), stream,
        )
    if rc != 0:
        raise RuntimeError(f"raster_capsule kernel launch failed: CUDA error {rc}")
    rasterize_capsules.launches += 1
    return out[0], _ids(out[1]), list(out[2:])


rasterize_capsules.launches = 0
