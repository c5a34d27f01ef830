"""Order-independent transparency over binned capsules: the MLAB K-buffer and
the per-pixel accumulators of WBOIT, MBOIT and depth complexity.

Counterpart of `linevis_tpu/kernels/raster_capsule_oit.py`. On a CUDA tensor
`rasterize_capsules_mlab` launches a hand-written kernel: the K-buffer modes
run `csrc/raster_capsule_oit.cu`, the accumulation modes ('wboit', 'count',
'mboit_gen', 'mboit_resolve') `csrc/raster_capsule_accum.cu`. On a CPU
tensor it runs `rasterize_capsules_mlab_reference`, the same function in
plain PyTorch.

K-buffer modes: each pixel keeps K depth-sorted nodes of front-face capsule
fragments, inserted in the binning's front-to-back run order, with the
Multi-Layer Alpha Blending overflow merge into node K-1 (or, with
`no_overflow`, the exact front-K buffer of the reference's Atomic Loop and
of depth peeling). Walking every tile's run in aligned blocks of `sub`
candidates (the block grid is fixed by absolute pair index, as the JAX
kernel's chunk/sub-chunk walk fixes it):
  1. chunk exit and block cull (tile-wide): a chunk or block whose least
     bucket-floored depth (payload row 15) lies behind every pixel's bound
     (the K-th node's depth where the pixel is blocked, else 2.0) is
     skipped; runs are depth-bucket ordered, so the chunk exit ends the run;
  2. per candidate: the entry surface (and, `two_sided`, the exit surface)
     of the capsule, its world t clipped to the NDC depth range; with `peel`
     only fragments whose NDC depth lies behind the pixel's peel depth;
     then the rejection of fragments behind a blocked pixel's K-th node,
     against the node state at the start of the block;
  3. at most K sweeps per block: each takes the nearest remaining tie
     window (t <= t_min + |t_min|*1e-6), averages its members' colors (with
     `deferred_shade`, the shading features attr, cos1, cos2 instead) and
     alpha, and inserts the carry at pos = #{d_j <= carry} unless it is
     within the dedup window of an existing node; an insertion past K
     merges the evicted fragment into node K-1 with weight 1 - a_{K-1}
     (MLAB), or drops it (`no_overflow`). Candidates past the K-th window of
     a block are dropped;
  4. `composite`: shade the nodes (TF color, Phong cosine powers, depth cue)
     and blend them front to back over the background in params[24:27].
Per-fragment shading (`deferred_shade=False`) colors each fragment at its
own attribute, cosines and view depth (`_fragments`), and the nodes carry
premultiplied rgb.

Accumulation modes have no K-buffer, rejection or culls: every fragment of
the run that survives the clip (and `peel`) adds to per-pixel sums, in
candidate order (entry surface, then exit surface, of each candidate):
'count' the fragments; 'wboit' the WBOITGather weight's sums; 'mboit_gen'
(K=2) the absorbance b0 and the power or trigonometric moments of the
log-warped depth; 'mboit_resolve' the transmittance-weighted color from the
pass-1 `moments` (`_accum_terms`).

Store mode 'gather' (the importance gather of opacity optimization) is the
K-buffer with another payload: each fragment is (attribute, segment id as a
float, 0, alpha 1), and the carry is the tie window's plain average, not
premultiplied. With every alpha at 1 the MLAB merge weight is 0 and T_K is
0 once a node is filled. `use_bands` sets the diffuse exponent of the
shading (per fragment and in the composite) to 1.0 instead of 1.7; the
power is then the base itself, in the kernels and here alike.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.capsule_common import BIG, fma32, pixel_rays
from linevis_tpu_torch.kernels.moment_math import (
    transmittance_at_depth_4,
    transmittance_at_depth_6,
    transmittance_at_depth_8,
)
from linevis_tpu_torch.kernels.raster_pallas import SortedBinning
from linevis_tpu_torch.kernels.trig_moment_math import (
    circle_powers,
    transmittance_at_depth_trig_2,
    transmittance_at_depth_trig_3,
    transmittance_at_depth_trig_4,
)
from linevis_tpu_torch.render.transfer_function import (
    tf_channels_static,
    tf_static_table,
)

__all__ = [
    "rasterize_capsules_mlab", "rasterize_capsules_mlab_reference", "rasterize_capsules_accum",
    "shade_nodes", "blend_front_to_back", "tf_table", "ACCUM_MODES",
]

_K_MAX = 32  # deepest node buffer of the CUDA kernel (templated on 8/16/32)
ROWS = 23  # payload rows the kernel reads: 0-22
_MAX_PIXELS = 512  # threads per block in the CUDA kernel
_MAX_CHUNK = 256  # staged payload columns of the CUDA kernel
ACCUM_MODES = ("wboit", "count", "mboit_gen", "mboit_resolve")
_ACCUM_CODE = {"count": 0, "wboit": 1, "mboit_gen": 2, "mboit_resolve": 3}
MBOIT_DISCARD_B0 = 0.00100050033  # resolveMoments' discard (MomentOIT.glsl:421)
_tf_tables = {}  # (tf_color, tf_opacity, device) -> the kernel's TF table


def tf_table(tf_color, tf_opacity, device) -> torch.Tensor:
    """The CUDA kernels' TF table (`tf_static_table`) on `device`, cached. A
    kernel mode that reads no color TF takes an empty tf_color: a black one
    stands in."""
    key = (tf_color or ((0.0, 0.0, 0.0, 0.0),), tf_opacity, str(device))
    tf = _tf_tables.get(key)
    if tf is None:
        tf = torch.from_numpy(tf_static_table(*key[:2])).to(device)
        _tf_tables[key] = tf
    return tf


def _row_product(x: torch.Tensor, n: int) -> torch.Tensor:
    """prod over the leading n rows of x ([n, ...] -> [1, ...]) as a halving
    tree (an odd remainder row folds into row 0): the JAX kernel's order of
    multiplications, so T_K <= 1 - sat is decided on the same bits."""
    while n > 1:
        h = n // 2
        lo = x[0:h] * x[h:2 * h]
        if n % 2:
            lo = torch.cat([lo[0:1] * x[n - 1:n], lo[1:]], dim=0)
        x, n = lo, h
    return x


def _check_modes(store_mode, deferred_shade, peel, use_bands, composite, K, chunk, sub,
                 tf_color, n_mom, moments):
    """Mode checks shared by the kernels and their plain version (those of
    the JAX wrapper); -> sub."""
    if store_mode not in ("shade", "gather") and store_mode not in ACCUM_MODES:
        raise ValueError(f"unknown store_mode {store_mode!r}")
    if store_mode == "mboit_gen" and K != 2:
        raise ValueError("mboit_gen requires K=2 (moment channel layout)")
    if deferred_shade and store_mode != "shade":
        raise ValueError("deferred_shade only applies to store_mode='shade'")
    if composite and not (deferred_shade and store_mode == "shade" and peel is None):
        raise ValueError("composite requires store_mode='shade' + deferred_shade, no peel")
    if store_mode in ("mboit_gen", "mboit_resolve") and n_mom not in (4, 6, 8):
        raise ValueError(f"n_mom={n_mom}: need 4, 6 or 8")
    if store_mode == "mboit_resolve" and (moments is None or moments.shape[0] != 1 + n_mom):
        raise ValueError(f"mboit_resolve needs moments[{1 + n_mom}, T, P]")
    if not 1 <= K <= _K_MAX:
        raise ValueError(f"K={K}: need 1 <= K <= {_K_MAX}")
    if (composite or (store_mode in ("shade", "wboit", "mboit_resolve")
                      and not deferred_shade)) and not tf_color:
        raise ValueError("this mode shades fragments: it needs the color TF (tf_color)")
    # Sub-chunk width: a multiple-of-8 divisor of the chunk; wider clamps.
    if sub >= chunk:
        sub = chunk
    elif sub <= 0 or chunk % sub or sub % 8:
        raise ValueError(f"sub={sub} must be a multiple-of-8 divisor of chunk={chunk}")
    return sub


def _two(x, two_sided, interleave):
    """A per-candidate quantity ([A, M, ...]) for each surface slot: entry
    surfaces then exit surfaces (K-buffer), or each candidate's entry then
    exit surface (`interleave`, the accumulation modes' order)."""
    if not two_sided:
        return x
    return x.repeat_interleave(2, dim=1) if interleave else torch.cat([x, x], dim=1)


def _surfaces(s, dn, in_run, two_sided, interleave=False, need=None):
    """Capsule hits of candidates `s` ([ROWS, A, M, 1] payload rows) against
    rays dn ([A, 1, P] each): (tcand [A, M', P] relative t or BIG, t0, and
    the per-candidate scalars the shading reuses). M' = 2M with the exit
    surfaces ordered as `_two` orders them. `need`, an optional int64 [4]
    tensor, receives the in-run (candidate, pixel) evaluations at which the
    front-face test needs each part's root and tests (its discriminant not
    negative; the start cap only where payload row 13 holds one: body,
    start cap, end cap) and those with a front surface."""
    dnx, dny, dnz = dn
    baoa0, oaoa0, rrbaba, rr, baba = s[16], s[17], s[19], s[22], s[10]
    bard = s[3] * dnx + s[4] * dny + s[5] * dnz
    rdoa = s[0] * dnx + s[1] * dny + s[2] * dnz
    t0 = -(rdoa + 0.5 * bard)
    # Re-origin at the closest approach to the segment midpoint, each start
    # rounded once (the kernel's __fmaf_rn): rd = (oa + t0*d).d = -bard/2.
    rd = -0.5 * bard
    baoa = fma32(t0, bard, baoa0)
    oaoa = fma32(t0, rdoa + rd, oaoa0)

    k2 = torch.clamp(baba - bard * bard, min=1e-20)
    k1 = baba * rd - baoa * bard
    k0 = baba * oaoa - baoa * baoa - rrbaba
    h = k1 * k1 - k2 * k0
    sq = torch.sqrt(torch.clamp(h, min=0.0))
    ha = rd * rd - (oaoa - rr)
    sqa = torch.sqrt(torch.clamp(ha, min=0.0))
    b1b = rd - bard
    obob = oaoa - 2.0 * baoa + baba
    hb = b1b * b1b - (obob - rr)
    sqb = torch.sqrt(torch.clamp(hb, min=0.0))
    cap_a_on = s[13] > 0.5
    big = torch.full_like(bard, BIG)

    def cand(tp, ok):
        return torch.where(ok & in_run & (t0 + tp > 0.0), tp, big)

    def surface_t(near):
        if near:
            tb, ta, tc = (-k1 - sq) / k2, -rd - sqa, -b1b - sqb
        else:
            tb, ta, tc = (-k1 + sq) / k2, -rd + sqa, -b1b + sqb
        yb, ya, yc = baoa + tb * bard, baoa + ta * bard, baoa + tc * bard
        return torch.minimum(
            cand(tb, (h >= 0.0) & (yb > 0.0) & (yb < baba)),
            torch.minimum(
                cand(ta, (ha >= 0.0) & (ya <= 0.0) & cap_a_on),
                cand(tc, (hb >= 0.0) & (yc >= baba)),
            ),
        )

    tcand = surface_t(True)
    if need is not None:
        need += torch.stack([((h >= 0.0) & in_run).sum(), ((ha >= 0.0) & cap_a_on & in_run).sum(),
                             ((hb >= 0.0) & in_run).sum(), (tcand < BIG).sum()])
    if two_sided:
        t_out = surface_t(False)
        tcand = (torch.stack([tcand, t_out], dim=2).flatten(1, 2) if interleave
                 else torch.cat([tcand, t_out], dim=1))
    return tcand, t0, (bard, rd, baoa)


def _cos_power(x, use_bands):
    """The diffuse cosine power x**e, e = 1.0 with `use_bands` (the base
    itself, as XLA simplifies x**1.0; powf(x, 1.0f) need not return x), else
    1.7."""
    return x if use_bands else x ** 1.7


def _fragments(s, tcand, tw, invlen, geo, params, tf_color, tf_opacity, alpha_from_rows,
               two_sided, interleave, deferred_shade, gather=False, use_bands=False):
    """Every candidate fragment's color and alpha, each [A, M', P]: with
    `gather` the importance gather's (attr, segment id, 0, 1); with
    `deferred_shade` the shading features (attr, cos1, cos2), else the
    shaded color at the fragment (headlight Blinn-Phong through scalar
    identities of the unit ray and the tube axis, the TF color at its
    attribute, the depth cue at its view depth tw*invlen)."""
    bard, rd, baoa = geo

    def two(x):
        return _two(x, two_sided, interleave)

    bard2, rd2 = two(bard), two(rd)
    y2 = two(baoa) + tcand * bard2
    uax = torch.clamp(y2 * two(s[18]), 0.0, 1.0)
    attr = two(s[7]) + two(s[8]) * uax
    if gather:
        return (attr, two(s[9]).expand_as(attr), torch.zeros_like(attr),
                torch.ones_like(attr))
    inv_r2 = two(s[21])
    ndl = -(rd2 + tcand - uax * bard2) * inv_r2
    tn2 = two(s[20])
    tdl = -bard2 * tn2
    ndt = (y2 - uax * two(s[10])) * tn2 * inv_r2
    denom = 1.0 / torch.sqrt(torch.clamp(1.0 - tdl * tdl, min=1e-6))
    cos1 = torch.clamp(torch.abs(ndl), 0.0, 1.0)
    cos2 = torch.clamp(torch.abs(ndl - tdl * ndt) * denom, 0.0, 1.0)
    if alpha_from_rows:
        ac = torch.clamp(two(s[11]) + two(s[12]) * uax, 0.0, 1.0)
    else:
        ac = tf_channels_static(tf_opacity, 1, attr)[0] * params[14]
    if deferred_shade:
        return attr, cos1, cos2, ac
    cos1s = torch.clamp(cos1, min=1e-20)
    cos2s = torch.clamp(cos2, min=1e-20)
    cosc = 0.3 * _cos_power(cos1s, use_bands) + 0.7 * _cos_power(cos2s, use_bands)
    spec = 0.3 * cos1s ** 30.0
    shade = 0.1 + 0.9 * cosc
    dmin, dmax, cue = params[11], params[12], params[13]
    fcue = torch.clamp((tw * invlen - dmin) / torch.clamp(dmax - dmin, min=1e-6), 0.0, 1.0)
    fcue = fcue * fcue * cue
    rgb = tf_channels_static(tf_color, 3, attr)
    return (*[(c * shade + spec) * (1.0 - fcue) + 0.5 * fcue for c in rgb], ac)


def _sweeps(st, tw, feats, invlen, zA, zB, K, no_overflow, stats, gather=False):
    """At most K extraction sweeps of one block into the node state st
    ([A, 5, K, P], updated in place). tw [A, M', P]; feats 4 x [A, M', P].
    The carry is premultiplied by its alpha, except with `gather`. Adds
    the (pixel, sweep) extractions and their window members to `stats`
    when it is a dict."""
    kidx = torch.arange(K, device=tw.device)[None, :, None]
    M = tw.shape[1]
    for _ in range(K):
        bt = tw.amin(dim=1)
        has = bt < BIG
        if not bool(has.any()):
            break
        win = tw <= (bt + torch.abs(bt) * 1e-6)[:, None]
        nwin = torch.clamp(win.sum(dim=1).float(), min=1.0)
        if stats is not None:
            stats["sweeps"] += int(has.sum())
            stats["members"] += int((win & has[:, None]).sum())
        # Window sums in candidate order, as the kernel accumulates them.
        acc = [torch.zeros_like(bt) for _ in feats]
        for j in range(M):
            wj = win[:, j]
            for c, f in enumerate(feats):
                acc[c] = acc[c] + torch.where(wj, f[:, j], 0.0)
        sel = [torch.where(has, a / nwin, 0.0) for a in acc]
        znd = torch.where(has, zA - zB / torch.clamp(bt * invlen, min=1e-12), 2.0)
        sa = sel[3]
        if gather:
            carry = (znd, sel[0], sel[1], sel[2], sa)
        else:
            carry = (znd, sel[0] * sa, sel[1] * sa, sel[2] * sa, sa)

        d_all = st[:, 0]
        pos = (d_all <= znd[:, None]).sum(dim=1)
        # A carry within the tie window of an existing node is that node
        # (coincident geometry extracted in an earlier block): dropped.
        eps_znd = torch.abs(zB) * 1e-6 / torch.clamp(bt * invlen, min=1e-12)
        dup = (
            ((torch.abs(d_all - znd[:, None]) <= eps_znd[:, None]) & (d_all < 2.0))
            .any(dim=1) & has
        )
        pos = torch.where(dup, K, pos)[:, None]
        shifted = torch.cat([st[:, :, 0:1], st[:, :, :K - 1]], dim=2)
        carry_t = torch.stack(carry, dim=1)[:, :, None]
        new = torch.where(
            (kidx < pos)[:, None], st,
            torch.where((kidx == pos)[:, None], carry_t, shifted),
        )
        if not no_overflow:
            # MLAB overflow: the evicted fragment (old node K-1 after an
            # insert, else the carry) composites into node K-1 under the
            # new node's remaining transmittance.
            ev = torch.where(pos < K, st[:, :, K - 1], carry_t[:, :, 0])
            evict = has & ~dup & (ev[:, 0] < 2.0)
            w = 1.0 - new[:, 4, K - 1]
            for ch in (1, 2, 3):
                new[:, ch, K - 1] = new[:, ch, K - 1] + torch.where(evict, w * ev[:, ch], 0.0)
            new[:, 4, K - 1] = torch.clamp(
                new[:, 4, K - 1] + torch.where(evict, w * ev[:, 4], 0.0), max=1.0
            )
        st.copy_(new)
        tw = torch.where(win, BIG, tw)


def _bound(st, K, no_overflow, sat_thr):
    """(blocked [A, P], dK [A, P]) of the node state: a blocked pixel drops
    every fragment behind its K-th node (no_overflow: the buffer is full;
    overflow: T_K = prod(1 - a_i) <= 1 - sat)."""
    dK = st[:, 0, K - 1]
    if no_overflow:
        return dK < 2.0, dK
    T_K = _row_product((1.0 - st[:, 4]).transpose(0, 1), K)[0]
    return T_K <= sat_thr, dK


def shade_nodes(depths, feat, alpha, zA, zB, dmin, dmax, cue, tf_color,
                use_bands: bool = False):
    """Deferred shading of K nodes that carry PREMULTIPLIED features (attr,
    cos1, cos2): un-premultiply, apply the color TF, the Phong cosine
    powers and the depth cue once per node, and re-premultiply. feat
    [3, K, ...]; depths, alpha [K, ...] -> premultiplied rgb [3, K, ...].
    The kernel's composite computes the same."""
    inv_a = torch.where(alpha > 1e-6, 1.0 / torch.clamp(alpha, min=1e-6), 0.0)
    attr = feat[0] * inv_a
    cos1 = torch.clamp(feat[1] * inv_a, min=1e-20)
    cos2 = torch.clamp(feat[2] * inv_a, min=1e-20)
    cosc = 0.3 * _cos_power(cos1, use_bands) + 0.7 * _cos_power(cos2, use_bands)
    spec = 0.3 * cos1 ** 30.0
    rgb = torch.stack(tf_channels_static(tf_color, 3, attr))
    shade = 0.1 + 0.9 * cosc
    vz = zB / torch.clamp(zA - depths, min=1e-9)
    fcue = torch.clamp((vz - dmin) / torch.clamp(dmax - dmin, min=1e-6), 0.0, 1.0)
    fcue = fcue * fcue * cue
    col = (rgb * shade[None] + spec[None]) * (1.0 - fcue[None]) + 0.5 * fcue[None]
    return col * alpha[None]


def blend_front_to_back(rgb, alpha, bg):
    """Blend premultiplied nodes (rgb [3, K, ...], alpha [K, ...]) front to
    back over the background color bg [3] -> [4, ...] RGBA."""
    T = torch.ones_like(alpha[0])
    acc = torch.zeros_like(rgb[:, 0])
    for j in range(alpha.shape[0]):
        acc = acc + T[None] * rgb[:, j]
        T = T * (1.0 - alpha[j])
    bg = bg.reshape((3,) + (1,) * T.dim())
    return torch.cat([acc + T[None] * bg, (1.0 - T)[None]])


def _accum_slots(store_mode, n_mom):
    """(channel, node) of each accumulator in the [5, K] output planes, in
    the JAX kernel's layout: 'count' and 'wboit' sum into depths[0] (the
    count, the revealage sum of log(1 - a)), 'wboit' and 'mboit_resolve'
    into rgb[:, 0] and alpha[0]; 'mboit_gen' puts b0 in depths[0], the odd
    moments in rgb[0..2, 0], alpha[0], the even ones in depths[1],
    rgb[0..2, 1]."""
    if store_mode == "count":
        return [(0, 0)]
    if store_mode == "wboit":
        return [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0)]
    if store_mode == "mboit_resolve":
        return [(1, 0), (2, 0), (3, 0), (4, 0)]
    nh = n_mom // 2
    odd = [(1, 0), (2, 0), (3, 0), (4, 0)][:nh]
    even = [(0, 1), (1, 1), (2, 1), (3, 1)][:nh]
    return [(0, 0)] + odd + even


def _accum_terms(store_mode, frags, tw, invlen, params, n_mom, trig, mom):
    """Per-fragment terms of the accumulators (`_accum_slots` order), each
    [A, M', P]. `mom`: the pixels' pass-1 moments for 'mboit_resolve'
    ([1 + n_mom] x [A, 1, P])."""
    if store_mode == "count":
        return [torch.ones_like(tw)]
    zA, zB = params[9], params[10]
    rc, gc, bc, ac = frags
    if store_mode == "wboit":
        # WBOITGather.glsl:14-37: weight from alpha and NDC depth.
        zndc = zA - zB / torch.clamp(tw * invlen, min=1e-12)
        x = torch.clamp(ac * 10.0, max=1.0) + 0.01
        y = 1.0 - torch.clamp(zndc, 0.0, 1.0) * 0.9
        wgt = torch.clamp(x * x * x * 1e8 * (y * y * y), 1e-2, 3e3)
        wa = wgt * ac
        return [torch.log(torch.clamp(1.0 - ac, min=1e-6)), wa * rc, wa * gc, wa * bc, wa]
    # MBOIT log depth warp (MBOITHeader.glsl:49-52).
    log_dmin, log_dmax = params[15], params[16]
    dw = torch.clamp(
        (torch.log(torch.clamp(tw * invlen, min=1e-9)) - log_dmin)
        / torch.clamp(log_dmax - log_dmin, min=1e-9) * 2.0 - 1.0,
        -1.0, 1.0,
    )
    nh = n_mom // 2
    wzp_y, wzp_z, wzp_w = params[20], params[21], params[22]
    if store_mode == "mboit_gen":
        # MomentOIT.glsl:69-133 (power), :338-355 (trigonometric).
        absorb = torch.clamp(-torch.log(torch.clamp(1.0 - ac, min=1e-7)), max=10.0)
        if trig:
            powers = circle_powers(dw, wzp_y, nh)
            odd = [p[0] * absorb for p in powers]
            even = [p[1] * absorb for p in powers]
        else:
            d2 = dw * dw
            pow_odd, pow_even, odd, even = dw, d2, [], []
            for _ in range(nh):
                odd.append(pow_odd * absorb)
                even.append(pow_even * absorb)
                pow_odd = pow_odd * d2
                pow_even = pow_even * d2
        return [absorb] + odd + even
    # mboit_resolve (MBOITPass2.glsl:21-37): the pixel's moments normalized
    # by b0, the transmittance at the fragment's depth, discarded (T = 1)
    # where b0 is below the reference's threshold.
    m_bias, m_overest = params[17], params[18]
    b0v = mom[0]
    inv_b0 = 1.0 / torch.clamp(b0v, min=1e-6)
    odds = [mom[1 + j] * inv_b0 for j in range(nh)]
    evens = [mom[1 + nh + j] * inv_b0 for j in range(nh)]
    if trig:
        fn = {4: transmittance_at_depth_trig_2, 6: transmittance_at_depth_trig_3,
              8: transmittance_at_depth_trig_4}[n_mom]
        T_at = fn(b0v, list(zip(odds, evens)), dw, m_bias, m_overest, wzp_y, wzp_z, wzp_w)
    else:
        fn = {4: transmittance_at_depth_4, 6: transmittance_at_depth_6,
              8: transmittance_at_depth_8}[n_mom]
        T_at = fn(b0v, evens, odds, dw, m_bias, m_overest)
    T_at = torch.where(b0v < MBOIT_DISCARD_B0, 1.0, T_at)
    wgt = ac * T_at
    return [wgt * rc, wgt * gc, wgt * bc, wgt]


def rasterize_capsules_mlab_reference(
    csr: SortedBinning,
    params: torch.Tensor,
    width: int,
    height: int,
    tile_w: int = 32,
    tile_h: int = 16,
    K: int = 8,
    tf_color: tuple = (),
    tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0)),
    use_bands: bool = False,
    store_mode: str = "shade",
    alpha_from_rows: bool = False,
    n_mom: int = 4,
    trig: bool = False,
    moments: torch.Tensor = None,
    peel: torch.Tensor = None,
    no_overflow: bool = False,
    deferred_shade: bool = False,
    sub: int = 32,
    sat: float = 0.999,
    composite: bool = False,
    two_sided: bool = False,
    work: Optional[torch.Tensor] = None,
    batch_tiles: int = 2048,
    stats: Optional[dict] = None,
):
    """Plain PyTorch version of the kernels (same contract as
    `rasterize_capsules_mlab`). It walks every tile's run by block index,
    batching at each index the tiles whose run reaches it (`batch_tiles` at
    a time); `work`, an optional [n_tiles] int32 tensor, receives the
    candidates each tile evaluated after the culls. `stats`, an optional
    dict, receives the work the run's data needed: "evaluations" ((candidate,
    pixel) front-face tests after the culls), among them "body", "start_cap"
    and "end_cap" (those that need the part's root and tests, `_surfaces`)
    and "surfaces" (those with a front surface), "hits" ((candidate, pixel)
    fragments past the clip, the peel and the rejection), "sweeps" ((pixel,
    sweep) extractions) and "members" (fragments in the extracted tie
    windows); the accumulation modes have no sweeps."""
    if stats is not None:
        stats.update(hits=0, sweeps=0, members=0)
    dev = csr.payload.device
    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    C = csr.chunk
    sub = _check_modes(store_mode, deferred_shade, peel, use_bands, composite, K, C, sub,
                       tf_color, n_mom, moments)
    accum = store_mode in ACCUM_MODES
    dn_all, invlen_all = pixel_rays(
        params, n_tiles, csr.tiles_x, tile_w, tile_h, width, height
    )
    zA, zB = params[9], params[10]
    sat_thr = float(np.float32(1.0 - sat))
    payload = csr.payload[:ROWS]
    last_col = payload.shape[1] - 1

    start = csr.tile_start.long()
    end = start + csr.tile_count.long()
    first_block = start // sub
    n_blocks = torch.where(end > start, (end - 1) // sub - first_block + 1, 0)
    st_all = torch.zeros((n_tiles, 5, K, P), dtype=torch.float32, device=dev)
    if not accum:
        st_all[:, 0] = 2.0
    slots = _accum_slots(store_mode, n_mom) if accum else []
    stopped = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    evaluated = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    need = None if stats is None else torch.zeros(4, dtype=torch.int64, device=dev)
    lane = torch.arange(sub, device=dev)
    lane_c = torch.arange(C, device=dev)

    for i in range(int(n_blocks.max()) if n_tiles else 0):
        active = torch.nonzero((n_blocks > i) & ~stopped).flatten()
        for tiles in active.split(batch_tiles):
            st = st_all[tiles]
            t_start, t_end = start[tiles, None], end[tiles, None]
            col0 = (first_block[tiles] + i) * sub
            cols = col0[:, None] + lane
            in_run = (cols >= t_start) & (cols < t_end)
            s = payload[:, cols.clamp(max=last_col)]  # [ROWS, A, sub]
            if accum:
                live = torch.ones_like(tiles, dtype=torch.bool)
            else:
                blocked, dK = _bound(st, K, no_overflow, sat_thr)
                zk_eff = torch.where(blocked, dK, 2.0).amax(dim=1)
                # Chunk exit: at the first block of a chunk (or of the run),
                # a chunk whose in-run candidates all lie behind the tile's
                # bound ends the run.
                ccol0 = col0 // C * C
                opens = (col0 == ccol0) | (i == 0)
                ccols = ccol0[:, None] + lane_c
                c_in = (ccols >= t_start) & (ccols < t_end)
                czmin = torch.where(c_in, payload[15][ccols.clamp(max=last_col)],
                                    3.0).amin(dim=1)
                exits = opens & (czmin > zk_eff)
                stopped[tiles[exits]] = True
                zmin = torch.where(in_run, s[15], 3.0).amin(dim=1)
                live = ~exits & (zmin <= zk_eff)
            evaluated[tiles[live]] += in_run[live].sum(dim=1)
            if not bool(live.any()):
                continue
            tiles, st, s = tiles[live], st[live], s[:, live, :, None]
            in_run = in_run[live, :, None]
            dn = tuple(d[tiles][:, None, :] for d in dn_all)
            invlen = invlen_all[tiles][:, None, :]
            len_p = 1.0 / invlen

            tcand, t0, geo = _surfaces(s, dn, in_run, two_sided, interleave=accum, need=need)
            tw = torch.where(tcand < BIG, _two(t0, two_sided, accum) + tcand, BIG)
            # Near/far clip in NDC, as world-t bounds of the pixel's ray.
            tw_lo = (zB / zA) * len_p
            tw_hi = (zB / (zA - 1.0)) * len_p
            tw = torch.where((tw >= tw_lo) & (tw <= tw_hi), tw, BIG)
            znd = zA - zB / torch.clamp(tw * invlen, min=1e-12)
            if peel is not None:
                # Depth peeling: fragments at or in front of the previous
                # pass's farthest layer were composited already. The NDC
                # depth is the extraction's formula, so a layer at the peel
                # depth compares equal and is neither doubled nor skipped.
                tw = torch.where(znd > peel[tiles][:, None, :], tw, BIG)
            if not accum:
                # Reject fragments behind a blocked pixel's K-th node (node
                # state at the start of the block).
                blocked, dK = blocked[live], dK[live]
                if no_overflow:
                    tw = torch.where(blocked[:, None] & (znd >= dK[:, None]), BIG, tw)
                else:
                    t_rej = zB / torch.clamp(zA - dK, min=1e-9) * len_p[:, 0]
                    tw = torch.where(blocked[:, None] & (tw >= t_rej[:, None]), BIG, tw)
            valid = tw < BIG
            n_hits = int(valid.sum())
            if stats is not None:
                stats["hits"] += n_hits
            if not n_hits:
                continue
            frags = None
            if store_mode != "count":
                frags = _fragments(s, tcand, tw, invlen, geo, params, tf_color, tf_opacity,
                                   alpha_from_rows, two_sided, accum, deferred_shade,
                                   store_mode == "gather", use_bands)
            if not accum:
                _sweeps(st, tw, frags, invlen[:, 0], zA, zB, K, no_overflow, stats,
                        store_mode == "gather")
                st_all[tiles] = st
                continue
            mom = None
            if store_mode == "mboit_resolve":
                mom = [m[tiles][:, None, :] for m in moments]
            terms = _accum_terms(store_mode, frags, tw, invlen, params, n_mom, trig, mom)
            # Per-pixel sums in candidate order, as the kernel adds them.
            for j in range(tw.shape[1]):
                vj = valid[:, j]
                for (ch, node), term in zip(slots, terms):
                    st[:, ch, node] = st[:, ch, node] + torch.where(vj, term[:, j], 0.0)
            st_all[tiles] = st

    if work is not None:
        work.copy_(evaluated)
    if stats is not None:
        stats["evaluations"] = int(evaluated.sum()) * P
        stats.update(zip(("body", "start_cap", "end_cap", "surfaces"), need.tolist()))
    out = st_all.permute(1, 2, 0, 3)  # [5, K, T, P]
    if composite:
        rgb = shade_nodes(out[0], out[1:4], out[4], params[9], params[10], params[11],
                          params[12], params[13], tf_color, use_bands)
        return blend_front_to_back(rgb, out[4], params[24:27])
    return out[0], out[1:4], out[4]


def _launcher(name):
    """The C entry point of kernel library `name` (built and loaded at first
    use), with its argument types declared so ctypes passes 64-bit
    pointers."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "raster_capsule_oit":
        fn = _build.load(name).raster_capsule_mlab_launch
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, p,
                       i, i, i, i, f, f, i, i, i, i, i, i, i, i, i, i, f, p]
    else:
        fn = _build.load(name).raster_capsule_accum_launch
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, p, p,
                       i, i, i, i, f, f, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_plane(t, name, n_tiles, P, device):
    if (t.dtype != torch.float32 or t.shape[-2:] != (n_tiles, P) or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 [..., {n_tiles}, {P}] "
                         "tensor on the payload's device")


def rasterize_capsules_mlab(
    csr: SortedBinning,
    params: torch.Tensor,  # [32] (see tube_raster.prepare_capsule_frame)
    width: int,
    height: int,
    tile_w: int = 32,
    tile_h: int = 16,
    K: int = 8,
    tf_color: tuple = (),
    tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0)),
    use_bands: bool = False,
    store_mode: str = "shade",
    alpha_from_rows: bool = False,
    n_mom: int = 4,
    trig: bool = False,
    moments: torch.Tensor = None,
    peel: torch.Tensor = None,
    no_overflow: bool = False,
    deferred_shade: bool = False,
    sub: int = 32,
    sat: float = 0.999,
    composite: bool = False,
    two_sided: bool = False,
    work: Optional[torch.Tensor] = None,
):
    """MLAB-K transparency pass and the per-pixel accumulators (signature of
    the JAX kernel's wrapper).

    store_mode 'shade' returns (depths [K, n_tiles, P], premultiplied colors
    [3, K, n_tiles, P], alpha [K, n_tiles, P]); empty nodes have depth 2.0
    and alpha 0. 'gather' returns the same planes holding (depth,
    importance = the attribute, segment id as a float, 0, alpha 1) per node,
    not premultiplied: a tie window's members are averaged (a joint's cap
    and the next segment's body give the id i + 0.5). The colors are the shaded rgb, or with `deferred_shade` the
    features (attr, cos1, cos2). With `composite=True` (deferred shading, no
    peel) the nodes are shaded and blended front to back over the
    background in params[24:28] instead -> [4, n_tiles, P] RGBA. `peel`
    ([n_tiles, P] NDC depths) keeps only fragments behind the pixel's peel
    depth. Accumulation modes return the same three planes holding their
    sums (`_accum_slots`), zero elsewhere: 'mboit_gen' needs K=2 and writes
    b0, then the n_mom moments (power, or with `trig` trigonometric);
    'mboit_resolve' reads `moments` [1 + n_mom, n_tiles, P] (b0, the odd,
    the even moments). Also ported: no_overflow, two_sided,
    alpha_from_rows (alpha = row 11 + row 12 * u), sat, sub, 1 <= K <= 32,
    and `use_bands` (diffuse exponent 1.0 instead of 1.7).

    A CUDA payload launches the CUDA kernel of the mode: the K-buffer
    kernel, counted in `rasterize_capsules_mlab.launches`, or through
    `rasterize_capsules_accum` (its own count) the accumulation kernel. A
    CPU payload runs the plain version. `work`, an optional [n_tiles] int32 tensor, receives
    the candidates each tile evaluated after the chunk exit and block cull
    (every candidate of the run in the accumulation modes).
    """
    C = csr.chunk
    sub = _check_modes(store_mode, deferred_shade, peel, use_bands, composite, K, C, sub,
                       tf_color, n_mom, moments)
    payload = csr.payload
    kw = dict(K=K, tf_color=tf_color, tf_opacity=tf_opacity, use_bands=use_bands,
              store_mode=store_mode, alpha_from_rows=alpha_from_rows, n_mom=n_mom,
              trig=trig, moments=moments, peel=peel, no_overflow=no_overflow,
              deferred_shade=deferred_shade, sub=sub, sat=sat, composite=composite,
              two_sided=two_sided, work=work)
    if payload.device.type == "cpu":
        return rasterize_capsules_mlab_reference(
            csr, params, width, height, tile_w, tile_h, **kw
        )
    if payload.device.type != "cuda":
        raise ValueError(f"rasterize_capsules_mlab: unsupported device {payload.device}")

    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    if P % 32 or P > _MAX_PIXELS:
        raise ValueError(f"tile of {P} pixels: need a multiple of 32, at most {_MAX_PIXELS}")
    if C > _MAX_CHUNK:
        raise ValueError(f"chunk={C}: the CUDA kernel takes chunk <= {_MAX_CHUNK}")
    if payload.dtype != torch.float32 or payload.dim() != 2 or payload.shape[0] < ROWS:
        raise ValueError(f"payload must be [R >= {ROWS}, pairs] float32")
    if params.dtype != torch.float32 or params.numel() < 28:
        raise ValueError("params must be float32 with at least 28 entries")
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
    if peel is not None:
        _check_plane(peel, "peel", n_tiles, P, payload.device)
    if moments is not None and store_mode == "mboit_resolve":
        _check_plane(moments, "moments", n_tiles, P, payload.device)

    tf = tf_table(tf_color, tf_opacity, payload.device)
    if store_mode in ACCUM_MODES:
        out = rasterize_capsules_accum(csr, params, tf, width, height, tile_w, tile_h, K,
                                       store_mode, alpha_from_rows, n_mom, trig, moments,
                                       peel, two_sided, use_bands)
        if work is not None:
            work.copy_(csr.tile_count)
    else:
        out = torch.empty((4 if composite else 5 * K, n_tiles, P), dtype=torch.float32,
                          device=payload.device)
        with torch.cuda.device(payload.device):
            rc = _launcher("raster_capsule_oit")(
                payload.data_ptr(), payload.shape[1],
                csr.tile_start.data_ptr(), csr.tile_count.data_ptr(),
                params.data_ptr(), tf.data_ptr(), None if peel is None else peel.data_ptr(),
                out.data_ptr(), None if work is None else work.data_ptr(),
                n_tiles, csr.tiles_x, tile_w, tile_h, 2.0 / width, 2.0 / height,
                K, C, sub, int(composite), int(no_overflow), int(two_sided),
                int(alpha_from_rows), int(deferred_shade), int(store_mode == "gather"),
                int(use_bands), float(np.float32(1.0 - sat)),
                torch.cuda.current_stream().cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"raster_capsule_oit kernel launch failed: CUDA error {rc}")
        rasterize_capsules_mlab.launches += 1
    if composite:
        return out
    out = out.reshape(5, K, n_tiles, P)
    return out[0], out[1:4], out[4]


def rasterize_capsules_accum(csr, params, tf, width, height, tile_w, tile_h, K, store_mode,
                             alpha_from_rows, n_mom, trig, moments, peel, two_sided,
                             use_bands=False):
    """Launch `csrc/raster_capsule_accum.cu`, the accumulation modes' kernel,
    on CUDA inputs that `rasterize_capsules_mlab` checked -> [5 * K, n_tiles,
    P] planes; counts the launch in `rasterize_capsules_accum.launches`. The
    blocks take the tiles longest run first (`csr.longest_first`); each warp
    holds an 8x4 block of a tile's pixels where such blocks cover the tile,
    else 32 pixels in row-major order."""
    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    out = torch.empty((5 * K, n_tiles, P), dtype=torch.float32, device=csr.payload.device)
    with torch.cuda.device(csr.payload.device):
        rc = _launcher("raster_capsule_accum")(
            csr.payload.data_ptr(), csr.payload.shape[1],
            csr.tile_start.data_ptr(), csr.tile_count.data_ptr(), csr.longest_first.data_ptr(),
            params.data_ptr(), tf.data_ptr(),
            moments.data_ptr() if store_mode == "mboit_resolve" else None,
            None if peel is None else peel.data_ptr(), out.data_ptr(),
            n_tiles, csr.tiles_x, tile_w, tile_h, 2.0 / width, 2.0 / height,
            K, csr.chunk, _ACCUM_CODE[store_mode], n_mom, int(trig), int(two_sided),
            int(alpha_from_rows), int(use_bands), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raster_capsule_accum kernel launch failed: CUDA error {rc}")
    rasterize_capsules_accum.launches += 1
    return out


rasterize_capsules_mlab.launches = 0
rasterize_capsules_accum.launches = 0
