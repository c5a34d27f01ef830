"""Wavefront traversal of the 8-wide BVH with a per-ray K-nearest buffer.

Counterpart of `linevis_tpu/kernels/bvh_wavefront.py`. Reference role: the
tube ray tracer's re-cast loop with the MLAT any-hit payload
(`Data/Shaders/Renderers/RayTracing/TubeRayTracing.glsl:61-82`,
`MlatInsert.glsl`). On a CUDA tensor `trace_wavefront_kbuffer` launches the
hand-written kernel `csrc/bvh_wavefront.cu`; on a CPU tensor it runs
`trace_wavefront_kbuffer_reference`, the same function in plain PyTorch.

What both compute (see `ops/wide_bvh.py` for the packing):
- Rays are processed in blocks of 128 (one screen tile of primary rays:
  coherent by construction). Each block owns ONE LIFO traversal stack: a
  node group is visited when ANY ray of the block wants it, popped from the
  top, its internal children pushed in row order 0..7. Coherent rays share
  every fetch; incoherent rays only over-visit, never miss.
- A visit tests the 8 child boxes against every ray (slab test against the
  ray's bound: its t_max and, with `no_overflow`, the depth of its K-th node
  once the buffer is full), and the capsules of the group's leaf rows
  against EVERY ray of the block, also one whose own box test failed: the
  entry and exit surfaces of body and caps, 16 candidate depths per visit.
- The candidates are extracted nearest first in tie windows
  (t <= t_min + |t_min| * 1e-6), at most K windows per visit; each window's
  deferred-shading features (attr, cos1, cos2) and alpha are averaged and
  inserted into the ray's K depth-sorted nodes unless a node within the same
  window (mapped to NDC) is there already (coincident joint surfaces seen in
  an earlier visit). Insertion past K merges the evicted fragment into node
  K-1 under its remaining transmittance (MLAB), or drops it (`no_overflow`).
  The merge and the dedup see fragments in arrival order, so results depend
  on the visit order, which is why the stack discipline above is part of
  the function.

Nodes store premultiplied features (headlight scalar identities, no
transcendentals); the caller resolves them with
`render.oit.shade_deferred_nodes` and front-to-back blending. Entry and exit
surfaces are both inserted: the reference ray tracer composites both.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.capsule_common import BIG
from linevis_tpu_torch.kernels.raster_capsule_oit import tf_table
from linevis_tpu_torch.ops.lbvh import StackOverflowError
from linevis_tpu_torch.ops.wide_bvh import (
    LANE_A,
    LANE_ATTR0,
    LANE_BA,
    LANE_BABA,
    LANE_BMAX,
    LANE_BMIN,
    LANE_CAPA,
    LANE_DATTR,
    LANE_LEAF,
    LANE_PTR,
    LANE_R,
    USED_LANES,
)
from linevis_tpu_torch.render.transfer_function import tf_channels_static

__all__ = [
    "trace_wavefront_kbuffer", "trace_wavefront_kbuffer_reference", "StackOverflowError",
    "P", "MAX_STACK", "STATS",
]

P = 128  # rays per wavefront block
MAX_STACK = 192  # entries of a block's traversal stack
_K_MAX = 32  # deepest node buffer of the CUDA kernel (its nodes in shared memory)
# Columns of the optional per-block `stats` tensor.
STATS = ("visits", "leaf_visits", "leaf_rows", "sweeps", "members", "max_stack")


def _pad_rays(rays: torch.Tensor) -> torch.Tensor:
    """Rays padded with zero (invalid) rays to whole blocks of P."""
    pad = -rays.shape[1] % P
    if pad == 0:
        return rays.contiguous()
    return torch.nn.functional.pad(rays, (0, pad))


def _safe_inv(c):
    """Slab reciprocal: a zero component becomes a huge signed number."""
    tiny = torch.abs(c) < 1e-12
    return torch.where(tiny, torch.where(c >= 0, 1e12, -1e12),
                       1.0 / torch.where(tiny, 1.0, c))


def trace_wavefront_kbuffer_reference(
    groups: torch.Tensor,  # [n_groups * 8, 128] packed 8-wide BVH
    rays: torch.Tensor,  # [8, R]: o(3), d(3), tmax_world, valid
    proj_ab: torch.Tensor,  # [2] = (zA, zB) NDC depth mapping
    K: int = 8,
    opacity: float = 0.3,
    tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0)),
    no_overflow: bool = False,
    stats: Optional[torch.Tensor] = None,
    blocks: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the wavefront kernel (same contract as
    `trace_wavefront_kbuffer`). All ray blocks step together, each with its
    own stack, until every stack is empty. `blocks`, an optional index
    tensor, restricts the trace to those ray blocks (blocks are independent)
    and the outputs to [.., len(blocks), P]."""
    dev = rays.device
    rays_b = _pad_rays(rays).reshape(8, -1, P)
    if blocks is not None:
        rays_b = rays_b[:, blocks]
    B = rays_b.shape[1]
    rec_all = groups.reshape(-1, 8, groups.shape[1])[:, :, :USED_LANES]
    zA, zB = proj_ab[0], proj_ab[1]
    ox, oy, oz, dx, dy, dz, tmax_w = (rays_b[i] for i in range(7))
    valid = rays_b[7] > 0.5
    invlen = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))
    dnx, dny, dnz = dx * invlen, dy * invlen, dz * invlen
    inv = (_safe_inv(dnx), _safe_inv(dny), _safe_inv(dnz))
    len_p = 1.0 / invlen
    # The NDC clip volume as bounds on the world t of a hit.
    tw_lo = (zB / zA) * len_p
    tw_hi = (zB / (zA - 1.0)) * len_p

    st = torch.zeros((B, 5, K, P), dtype=torch.float32, device=dev)  # d, attr, c1, c2, a
    st[:, 0] = 2.0
    stack = torch.zeros((B, MAX_STACK), dtype=torch.int64, device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    counts = torch.zeros((B, len(STATS)), dtype=torch.int64, device=dev)
    counts[:, 5] = 1
    kidx = torch.arange(K, device=dev)[None, :, None]

    while True:
        act = torch.nonzero(sp > 0).flatten()
        if act.numel() == 0:
            break
        sp[act] -= 1
        rec = rec_all[stack[act, sp[act]]]  # [A, 8, lanes]
        counts[act, 0] += 1

        def scal(lane):
            return rec[:, :, lane, None]  # [A, 8, 1] child scalars

        o = (ox[act, None], oy[act, None], oz[act, None])  # [A, 1, P]
        dn = (dnx[act, None], dny[act, None], dnz[act, None])
        if no_overflow:
            # A full buffer's K-th depth prunes what lies behind it.
            dK = st[act, 0, K - 1][:, None]
            tw_bound = torch.where(
                dK < 2.0, zB / torch.clamp(zA - dK, min=1e-9) * len_p[act, None], BIG
            )
            tw_bound = torch.minimum(tw_bound, tmax_w[act, None])
        else:
            tw_bound = tmax_w[act, None]

        # Slab test, [A, 8 children, P rays].
        t0s = [(scal(LANE_BMIN + i) - o[i]) * inv[i][act, None] for i in range(3)]
        t1s = [(scal(LANE_BMAX + i) - o[i]) * inv[i][act, None] for i in range(3)]
        if any(bool(torch.isnan(t).any()) for t in t0s + t1s):
            raise FloatingPointError("NaN in the slab test")
        tn = torch.maximum(
            torch.maximum(torch.minimum(t0s[0], t1s[0]), torch.minimum(t0s[1], t1s[1])),
            torch.clamp(torch.minimum(t0s[2], t1s[2]), min=0.0),
        )
        tf_ = torch.minimum(
            torch.minimum(torch.maximum(t0s[0], t1s[0]), torch.maximum(t0s[1], t1s[1])),
            torch.maximum(t0s[2], t1s[2]),
        )
        hitb = (tf_ >= tn) & (tn <= tw_bound) & valid[act, None]
        wanted = hitb.any(dim=2)  # [A, 8]

        leaf_row = rec[:, :, LANE_LEAF] > 0.5
        has_leaf = leaf_row.any(dim=1)
        counts[act, 1] += has_leaf
        counts[act, 2] += leaf_row.sum(dim=1)
        if bool(has_leaf.any()):
            sub = torch.nonzero(has_leaf).flatten()
            la = act[sub]
            _leaf_visit(
                st, la, rec[sub], tuple(x[sub] for x in o), tuple(x[sub] for x in dn),
                valid[la, None], invlen[la, None], tw_lo[la, None], tw_hi[la, None],
                tw_bound[sub], zA, zB, K, opacity, tf_opacity, no_overflow, kidx,
                counts,
            )

        # Push the internal children that any ray still wants, in row order.
        ptr = rec[:, :, LANE_PTR]
        push = (ptr >= 0.0) & wanted
        sp_a = sp[act]
        for j in range(8):
            pj = push[:, j]
            if bool((pj & (sp_a >= MAX_STACK)).any()):
                raise StackOverflowError(
                    f"a ray block's traversal stack passed {MAX_STACK} entries"
                )
            rows = act[pj]
            stack[rows, sp_a[pj]] = ptr[pj, j].long()
            sp_a = sp_a + pj
        sp[act] = sp_a
        counts[act, 5] = torch.maximum(counts[act, 5], sp_a)

    if stats is not None:
        stats.copy_(counts)
    out = st.permute(1, 2, 0, 3)  # [5, K, B, P]
    return out[0], out[1:4], out[4]


def _leaf_visit(st, la, rec, o, dn, valid, invlen, tw_lo, tw_hi, tw_bound, zA, zB, K,
                opacity, tf_opacity, no_overflow, kidx, counts):
    """Capsule tests of the leaf rows of the visited groups `rec` [A, 8,
    lanes] against every ray of their blocks `la`, and the extraction of the
    16 candidates into the node state st[la] (updated in place)."""
    def scal(lane):
        return rec[:, :, lane, None]

    ox, oy, oz = o
    dnx, dny, dnz = dn
    leaf_ok = scal(LANE_LEAF) > 0.5
    oax, oay, oaz = ox - scal(LANE_A), oy - scal(LANE_A + 1), oz - scal(LANE_A + 2)
    bax, bay, baz = scal(LANE_BA), scal(LANE_BA + 1), scal(LANE_BA + 2)
    bard = bax * dnx + bay * dny + baz * dnz
    rdoa = oax * dnx + oay * dny + oaz * dnz
    baba = torch.clamp(scal(LANE_BABA), min=1e-20)
    rr = scal(LANE_R) * scal(LANE_R)
    # Re-origin at the closest approach to the segment midpoint (precision).
    t0 = -(rdoa + 0.5 * bard)
    pax, pay, paz = oax + t0 * dnx, oay + t0 * dny, oaz + t0 * dnz
    baoa = bax * pax + bay * pay + baz * paz
    oaoa = pax * pax + pay * pay + paz * paz
    rd = rdoa + t0
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
    cap_on = scal(LANE_CAPA) > 0.5
    big = torch.full_like(bard, BIG)

    def cand(tp, ok):
        return torch.where(ok & leaf_ok & valid & (t0 + tp > 0.0), tp, big)

    def surface_t(near):
        if near:
            tb, ta, tc = (-k1 - sq) / k2, -rd - sqa, -b1b - sqb
        else:
            tb, ta, tc = (-k1 + sq) / k2, -rd + sqa, -b1b + sqb
        yb, ya, yc = baoa + tb * bard, baoa + ta * bard, baoa + tc * bard
        return torch.minimum(
            cand(tb, (h >= 0.0) & (yb > 0.0) & (yb < baba)),
            torch.minimum(
                cand(ta, (ha >= 0.0) & (ya <= 0.0) & cap_on),
                cand(tc, (hb >= 0.0) & (yc >= baba)),
            ),
        )

    def two(x):
        return torch.cat([x, x], dim=1)

    tcand = torch.cat([surface_t(True), surface_t(False)], dim=1)  # [A, 16, P]
    tw = torch.where(tcand < BIG, two(t0) + tcand, BIG)
    tw = torch.where((tw >= tw_lo) & (tw <= torch.minimum(tw_hi, tw_bound)), tw, BIG)
    if not bool((tw < BIG).any()):
        return

    # Deferred-shading features through the scalar identities of the unit
    # ray and the tube axis (headlight: l = -dn).
    bard2, rd2 = two(bard), two(rd)
    y2 = two(baoa) + tcand * bard2
    uax = torch.clamp(y2 / two(baba), 0.0, 1.0)
    attr = two(scal(LANE_ATTR0)) + two(scal(LANE_DATTR)) * uax
    inv_r2 = 1.0 / torch.clamp(two(scal(LANE_R)), min=1e-12)
    ndl = -(rd2 + tcand - uax * bard2) * inv_r2
    tn2 = two(1.0 / torch.sqrt(baba))
    tdl = -bard2 * tn2
    ndt = (y2 - uax * two(baba)) * tn2 * inv_r2
    denom = 1.0 / torch.sqrt(torch.clamp(1.0 - tdl * tdl, min=1e-6))
    cos1 = torch.clamp(torch.abs(ndl), 0.0, 1.0)
    cos2 = torch.clamp(torch.abs(ndl - tdl * ndt) * denom, 0.0, 1.0)
    ac = tf_channels_static(tf_opacity, 1, attr)[0] * opacity
    feats = (attr, cos1, cos2, ac)

    s = st[la]
    for _ in range(K):
        bt = tw.amin(dim=1)
        has = bt < BIG
        if not bool(has.any()):
            break
        win = tw <= (bt + torch.abs(bt) * 1e-6)[:, None]
        nwin = torch.clamp(win.sum(dim=1).float(), min=1.0)
        counts[la, 3] += has.sum(dim=1)
        counts[la, 4] += (win & has[:, None]).sum(dim=(1, 2))
        # Window sums in candidate order (entry rows 0-7, then exit rows).
        acc = [torch.zeros_like(bt) for _ in feats]
        for j in range(16):
            wj = win[:, j]
            for c, f in enumerate(feats):
                acc[c] = acc[c] + torch.where(wj, f[:, j], 0.0)
        sel = [torch.where(has, a_ / nwin, 0.0) for a_ in acc]
        vz = torch.clamp(bt * invlen[:, 0], min=1e-12)
        znd = torch.where(has, zA - zB / vz, 2.0)
        sa = sel[3]
        carry = torch.stack((znd, sel[0] * sa, sel[1] * sa, sel[2] * sa, sa), dim=1)[:, :, None]

        d_all = s[:, 0]
        pos = (d_all <= znd[:, None]).sum(dim=1)
        eps_znd = torch.abs(zB) * 1e-6 / vz
        dup = (
            ((torch.abs(d_all - znd[:, None]) <= eps_znd[:, None]) & (d_all < 2.0))
            .any(dim=1) & has
        )
        pos = torch.where(dup, K, pos)[:, None]
        shifted = torch.cat([s[:, :, 0:1], s[:, :, :K - 1]], dim=2)
        new = torch.where(
            (kidx < pos)[:, None], s,
            torch.where((kidx == pos)[:, None], carry, shifted),
        )
        if not no_overflow:
            ev = torch.where(pos < K, s[:, :, K - 1], carry[:, :, 0])
            evict = has & ~dup & (ev[:, 0] < 2.0)
            w = 1.0 - new[:, 4, K - 1]
            for ch in (1, 2, 3):
                new[:, ch, K - 1] = new[:, ch, K - 1] + torch.where(evict, w * ev[:, ch], 0.0)
            new[:, 4, K - 1] = torch.where(
                evict, torch.clamp(new[:, 4, K - 1] + w * ev[:, 4], max=1.0), new[:, 4, K - 1]
            )
        s = new
        tw = torch.where(win, BIG, tw)
    st[la] = s


def _launcher():
    """The kernel's C entry point (built and loaded at first use), with its
    argument types declared so ctypes passes 64-bit pointers."""
    fn = _build.load("bvh_wavefront").bvh_wavefront_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, ctypes.c_longlong, p, p, p, p, p, i, i, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def trace_wavefront_kbuffer(
    groups: torch.Tensor,  # [n_groups * 8, 128] packed 8-wide BVH
    rays: torch.Tensor,  # [8, R]: o(3), d(3), tmax_world, valid
    proj_ab: torch.Tensor,  # [2] = (zA, zB) NDC depth mapping
    K: int = 8,
    opacity: float = 0.3,
    tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0)),
    no_overflow: bool = False,
    stats: Optional[torch.Tensor] = None,
):
    """Trace R rays -> K-nearest deferred-shading node buffers.

    Returns (depths [K, B, P], feat [3, K, B, P] premultiplied (attr, cos1,
    cos2), alpha [K, B, P]) with B = ceil(R / 128) ray blocks, the
    `shade_deferred_nodes` convention; empty nodes have depth 2.0 and alpha
    0. Ray directions are expected with unit forward component
    (basis @ [u, v, 1]), so the world hit distance along the unit ray maps
    to view depth via vz = tw / |d| and to NDC via zA - zB / vz.

    A CUDA tensor launches the CUDA kernel (and counts the launch in
    `trace_wavefront_kbuffer.launches`); a CPU tensor runs the plain
    version. Both raise StackOverflowError where a block's stack would pass
    MAX_STACK entries (on the card after a synchronize). `stats`, an
    optional [B, 6] int64 tensor, receives per ray block the columns
    `STATS`: group visits, visits of groups with leaf rows, leaf rows
    tested, (ray, sweep) extractions, fragments in the extracted windows,
    and the deepest stack.
    """
    if not 1 <= K <= _K_MAX:
        raise ValueError(f"K={K}: need 1 <= K <= {_K_MAX}")
    if rays.device.type == "cpu":
        return trace_wavefront_kbuffer_reference(
            groups, rays, proj_ab, K, opacity, tf_opacity, no_overflow, stats=stats
        )
    if rays.device.type != "cuda":
        raise ValueError(f"trace_wavefront_kbuffer: unsupported device {rays.device}")
    if groups.dtype != torch.float32 or groups.dim() != 2 or groups.shape[0] % 8 \
            or groups.shape[1] < USED_LANES:
        raise ValueError(f"groups must be [n_groups * 8, >= {USED_LANES}] float32")
    if groups.data_ptr() % 16 or groups.shape[1] % 4:
        # The kernel copies group rows with TMA bulk copies.
        raise ValueError("groups rows must start on 16-byte boundaries")
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError("rays must be [8, R] float32")
    dev = rays.device
    rays_p = _pad_rays(rays)
    n_blocks = rays_p.shape[1] // P
    params = torch.stack([proj_ab[0], proj_ab[1]]).float().contiguous()
    tensors = [groups, params] + ([] if stats is None else [stats])
    if stats is not None and (stats.dtype != torch.int64
                              or stats.shape != (n_blocks, len(STATS))):
        raise ValueError(f"stats must be [n_blocks, {len(STATS)}] int64")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("inputs must be contiguous on the rays' device")

    tf = tf_table((), tf_opacity, dev)
    out = torch.empty((5 * K, n_blocks, P), dtype=torch.float32, device=dev)
    counts = torch.zeros((n_blocks, len(STATS)), dtype=torch.int32, device=dev) \
        if stats is not None else None
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _launcher()(
            groups.data_ptr(), groups.shape[1], rays_p.data_ptr(), rays_p.shape[1],
            params.data_ptr(), tf.data_ptr(), out.data_ptr(),
            None if counts is None else counts.data_ptr(), overflow.data_ptr(),
            n_blocks, K, float(np.float32(opacity)), int(no_overflow),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh_wavefront kernel launch failed: CUDA error {rc}")
    trace_wavefront_kbuffer.launches += 1
    if int(overflow):
        raise StackOverflowError(
            f"a ray block's traversal stack passed {MAX_STACK} entries"
        )
    if stats is not None:
        stats.copy_(counts)
    out = out.reshape(5, K, n_blocks, P)
    return out[0], out[1:4], out[4]


trace_wavefront_kbuffer.launches = 0
