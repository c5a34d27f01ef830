"""Plain reference of the registry's "RTAO" frame on a line set, pixel by
pixel, for chosen rows.

A frame after a camera move is one sample set: PRNGKey(0), 4 cosine
rays a pixel (uniforms of split(key)[0] and split(key)[1] at the flat
index (sample, y, x)), radius 0.1, traced against the capsules; the pixel
is shaded by headlight Blinn-Phong with the AO terms of Lighting.glsl
(kA = 0.2 + (1 - ao) 0.5, kD = 0.9 ao, colour *= ao). It is computed here
without any of the program's tiling, binning, sorting or batching:

- primary visibility: every capsule near the row against each pixel-centre
  ray (no coverage AA), the nearest hit winning and equal depths going to
  the lower segment id (the float bits of the world t, then the id);
- occlusion: each AO ray against the capsules. The program samples 8 cells
  along a ray in a 64^3 grid and tests the segments binned there, plus
  those of other cells that share its chunk of 128 sorted pairs. Any hit it
  finds is real, so its answer lies between the hits among the segments of
  the ray's own sampled cells (the lower end, with the grid binned by the
  same rule) and the hits among all segments (the upper end). A pixel is
  right when the program's colour is the shade of one of the occlusion
  counts between those ends.

The float operations of each value the program rounds are taken in the
order the program's plain versions take them, so on the same device a
right pixel matches to the bit; `dtype` computes the whole reference in
another precision (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from linebench.reference import camera as cam
from linebench.reference import threefry
from linebench.reference.lines import PIXEL_TOLERANCE, Capsules, strata_rows

BIG = 1e30
INT64_MAX = torch.iinfo(torch.int64).max
Z_NEAR_CULL = 1e-3  # segments nearer than this view depth are not drawn
GRID = 64  # the AO grid's cells per axis
SPAN = 2  # cells per axis a segment is binned into, from its AABB's low corner
RAY_CELLS = 8  # cells sampled along an AO ray
AO_SAMPLES = 4
AO_RADIUS = 0.1
BACKGROUND = (1.0, 1.0, 1.0, 1.0)
# Operations of one ray-capsule any-hit test that the AO kernel's estimator
# needs (the re-origin, dot products and three discriminants), and of each
# root taken where a discriminant is not negative: the body, cap a, cap b.
AO_OPS_PER_TEST = 62
AO_OPS_PER_ROOT = (12, 10, 10)


def _tf_segments(points):
    """(init [3], segments [(p0, p1, span, v0[3], dv[3])]) in float32, the
    colour points (pos, r, g, b) in linear RGB."""
    f32 = np.float32
    init = [f32(points[0][1 + c]) for c in range(3)]
    segs = []
    for k in range(len(points) - 1):
        p0, p1 = float(points[k][0]), float(points[k + 1][0])
        v0 = [f32(points[k][1 + c]) for c in range(3)]
        dv = [f32(float(points[k + 1][1 + c]) - float(points[k][1 + c])) for c in range(3)]
        segs.append((f32(p0), f32(p1), f32(max(p1 - p0, 1e-9)), v0, dv))
    return init, segs


def transfer_function_points(srgb_points):
    """Colour points (pos, r, g, b in 0-255 sRGB) -> (pos, r, g, b linear),
    rounded to float32 as the renderer holds them."""
    cp = np.asarray(srgb_points, np.float64)
    c = np.clip(cp[:, 1:4] / 255.0, 0.0, 1.0)
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    pts = np.concatenate([cp[:, :1], lin], axis=1).astype(np.float32)
    return tuple(tuple(float(v) for v in row) for row in pts)


def tf_rgb(points, x: torch.Tensor):
    init, segs = _tf_segments(points)
    xc = torch.clamp(x, 0.0, 1.0)
    out = [torch.full_like(x, float(v)) for v in init]
    for p0, p1, span, v0, dv in segs:
        inside = (xc >= float(p0)) & (xc <= float(p1))
        w = (xc - float(p0)) / torch.full((), float(span), dtype=x.dtype, device=x.device)
        for c in range(3):
            out[c] = torch.where(inside, float(v0[c]) + w * float(dv[c]), out[c])
    return torch.stack(out)


def _capsule_hits(s, dn):
    """Nearest surface of capsules s (rows [C, 1]: oa 0-2, ba 3-5, r 6,
    baba 10, cap_a 13) along unit rays dn (3 x [1, K]) -> (tall, t0, geo);
    tall = BIG on a miss, t0 + tall the world t."""
    dnx, dny, dnz = dn
    bard = s[3] * dnx + s[4] * dny + s[5] * dnz
    rdoa = s[0] * dnx + s[1] * dny + s[2] * dnz
    baba = s[10]
    rr = s[6] * s[6]
    t0 = -(rdoa + 0.5 * bard)
    oax = s[0] + t0 * dnx
    oay = s[1] + t0 * dny
    oaz = s[2] + t0 * dnz
    baoa = s[3] * oax + s[4] * oay + s[5] * oaz
    oaoa = oax * oax + oay * oay + oaz * oaz
    rd = rdoa + t0
    k2 = torch.clamp(baba - bard * bard, min=1e-20)
    k1 = baba * rd - baoa * bard
    k0 = baba * oaoa - baoa * baoa - rr * baba
    h = k1 * k1 - k2 * k0
    tb = (-k1 - torch.sqrt(torch.clamp(h, min=0.0))) / k2
    yb = baoa + tb * bard
    ha = rd * rd - (oaoa - rr)
    ta = -rd - torch.sqrt(torch.clamp(ha, min=0.0))
    ya = baoa + ta * bard
    b1b = rd - bard
    obob = oaoa - 2.0 * baoa + baba
    hb = b1b * b1b - (obob - rr)
    tbb = -b1b - torch.sqrt(torch.clamp(hb, min=0.0))
    yb2 = baoa + tbb * bard
    okb = (h >= 0.0) & (yb > 0.0) & (yb < baba) & (t0 + tb > 0.0)
    oka = (ha >= 0.0) & (ya <= 0.0) & (s[13] > 0.5) & (t0 + ta > 0.0)
    okb2 = (hb >= 0.0) & (yb2 >= baba) & (t0 + tbb > 0.0)
    big = torch.full_like(tb, BIG)
    tall = torch.minimum(torch.where(okb, tb, big),
                         torch.minimum(torch.where(oka, ta, big), torch.where(okb2, tbb, big)))
    return tall, t0, (bard, baoa, oax, oay, oaz)


def _any_hit(ray, seg):
    """Any-hit of rays (7 rows: o, d, t_max) against segment records (8 rows:
    a, ba, r, baba), broadcast -> (hit, (body, cap a, cap b) roots taken):
    the body and both end spheres, entry surfaces, 1e-4 < t < t_max."""
    ox, oy, oz, dx, dy, dz, tmax = ray
    oax, oay, oaz = ox - seg[0], oy - seg[1], oz - seg[2]
    bard = seg[3] * dx + seg[4] * dy + seg[5] * dz
    rdoa = oax * dx + oay * dy + oaz * dz
    baba = torch.clamp(seg[7], min=1e-20)
    rr = seg[6] * seg[6]
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

    hit = inside(tb, okb) | inside(ta, oka) | inside(tc, okc)
    return hit, (h >= 0.0, ha >= 0.0, hb >= 0.0)


class Frame:
    """The fixed parts of one camera's frame: matrices, the capsules'
    per-frame rows and their screen rows."""

    def __init__(self, caps: Capsules, position, width: int, height: int):
        dev, dt = caps.a.device, caps.a.dtype
        self.W, self.H = width, height
        vp = torch.as_tensor(cam.view_projection(position, width, height), device=dev)
        self.basis = cam.ray_basis(vp).to(dt)
        self.params = self.basis.reshape(-1)
        pab = cam.depth_constants()
        self.zA, self.zB = (torch.tensor(float(v), device=dev, dtype=torch.float32).to(dt)
                            for v in pab)
        self.proj_ab = torch.as_tensor(pab, device=dev).to(dt)
        self.o = torch.as_tensor(np.asarray(position, np.float32), device=dev).to(dt)
        a, ba, r = caps.a, caps.ba, caps.radius
        S = a.shape[1]
        ones = torch.ones(S, dtype=dt, device=dev)
        oa = self.o[:, None] - a
        self.rows = torch.stack([oa[0], oa[1], oa[2], ba[0], ba[1], ba[2], ones * r,
                                 caps.attr0, caps.dattr,
                                 torch.arange(S, dtype=torch.float32, device=dev).to(dt),
                                 torch.sum(ba * ba, dim=0), ones, ones, caps.cap_a])
        # Screen rows each segment may cover, in float64 with a margin of
        # pixels: a cull that keeps every capsule a row's rays can hit.
        v64 = vp.double()
        a64, b64 = a.double(), (a + ba).double()
        wa = v64[3, :3] @ a64 + v64[3, 3]
        wb = v64[3, :3] @ b64 + v64[3, 3]
        wmin = torch.minimum(wa, wb)
        self.valid = caps.mask & (wmin > Z_NEAR_CULL)
        ya = (0.5 - (v64[1, :3] @ a64 + v64[1, 3]) / wa * 0.5) * height
        yb = (0.5 - (v64[1, :3] @ b64 + v64[1, 3]) / wb * 0.5) * height
        ppu = 0.5 * height * torch.linalg.norm(v64[1, :3])
        sr = r * ppu / torch.clamp(wmin - r, min=Z_NEAR_CULL) + 4.0
        self.y_lo = torch.minimum(ya, yb) - sr
        self.y_hi = torch.maximum(ya, yb) + sr

    def content_rows(self):
        """[first, last] screen rows any valid segment may cover."""
        lo = float(self.y_lo[self.valid].min()) if bool(self.valid.any()) else 0.0
        hi = float(self.y_hi[self.valid].max()) if bool(self.valid.any()) else 0.0
        return max(int(math.floor(lo)), 0), min(int(math.ceil(hi)), self.H - 1)

    def pixel_rays(self, xs, y: int):
        """Unit rays and 1/|dir| of the pixels (xs, y)."""
        p = self.params
        un = (xs.float() + 0.5).to(p.dtype) * (2.0 / self.W) - 1.0
        vn = 1.0 - (torch.full_like(xs, y).float() + 0.5).to(p.dtype) * (2.0 / self.H)
        dx = p[0] * un + p[1] * vn + p[2]
        dy = p[3] * un + p[4] * vn + p[5]
        dz = p[6] * un + p[7] * vn + p[8]
        invlen = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
        return (dx * invlen, dy * invlen, dz * invlen), invlen, (un, vn)

    def gbuffer_row(self, y: int):
        """The visible surface of row y -> dict of [W] tensors (fg, attr,
        normal [3, W], tangent [3, W], ray [3, W], pos [3, W])."""
        dev, dt = self.rows.device, self.rows.dtype
        W = self.W
        xs = torch.arange(W, device=dev)
        dn, invlen, (un, vn) = self.pixel_rays(xs, y)
        cand = torch.nonzero(self.valid & (self.y_lo <= y + 0.5) & (self.y_hi >= y + 0.5))[:, 0]
        best = torch.full((W,), INT64_MAX, dtype=torch.int64, device=dev)
        for c in cand.split(2048) if cand.numel() else ():
            s = self.rows[:, c][:, :, None]
            tall, t0, _ = _capsule_hits(s, tuple(d[None] for d in dn))
            hit = tall < BIG
            tw = torch.where(hit, t0 + tall, torch.full_like(tall, BIG)).float()
            key = (tw.view(torch.int32).long() << 32) | c[:, None]
            key = torch.where(hit, key, torch.full_like(key, INT64_MAX))
            best = torch.minimum(best, key.amin(dim=0))
        fg = best != INT64_MAX
        win = torch.where(fg, best & 0xFFFFFFFF, 0)
        s = self.rows[:, win]
        tall, t0, (bard, baoa, oax, oay, oaz) = _capsule_hits(s, dn)
        tw = t0 + tall
        uax = torch.clamp((baoa + tall * bard) / s[10], 0.0, 1.0)
        zndc = self.zA - self.zB / torch.clamp(tw * invlen, min=1e-12)
        attr = s[7] + s[8] * uax
        ba = (s[3], s[4], s[5])
        nrm = [tall * d + o - b * uax for d, o, b in zip(dn, (oax, oay, oaz), ba)]
        zero = torch.zeros((), dtype=dt, device=dev)
        zndc = torch.where(fg, zndc, torch.full_like(zndc, 2.0))
        attr = torch.where(fg, attr, zero)
        nrm = torch.stack([torch.where(fg, v, zero) for v in nrm])
        tan = torch.stack([torch.where(fg, v, zero) for v in ba])
        b = self.basis
        d = torch.stack([b[i, 0] * un + b[i, 1] * vn + b[i, 2] for i in range(3)])
        view_z = self.proj_ab[1] / torch.clamp(self.proj_ab[0] - zndc, min=1e-9)
        return dict(fg=fg, attr=attr, normal=_normalize3(nrm), tangent=_normalize3(tan), ray=d,
                    pos=self.o[:, None] + d * view_z[None])


def _normalize3(v):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=0, keepdim=True)), min=1e-8)


def cosine_hemisphere(u1, u2, n):
    """Directions [S, 3, K] around unit normals n [3, K] from [S, K] uniforms."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    sign = torch.where(n[2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t1 = torch.stack([1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    t2 = torch.stack([b, sign + n[1] * n[1] * a, -n[1]])
    return t1[None] * x[:, None] + t2[None] * y[:, None] + n[None] * z[:, None]


class SegmentGrid:
    """Which segments each of the 64^3 cells holds, binned as the program
    bins them: a segment goes into the SPAN^3 cells from its AABB's low
    corner, as far as its AABB (grown by the radius) reaches."""

    def __init__(self, caps: Capsules):
        a, ba, r, mask = caps.a, caps.ba, caps.radius, caps.mask
        dev = a.device
        S, G = a.shape[1], GRID
        b = a + ba
        big = 3e38
        lo_seg, hi_seg = torch.minimum(a, b), torch.maximum(a, b)
        lo_all = torch.where(mask[None], lo_seg, big).amin(dim=1) - r
        hi_all = torch.where(mask[None], hi_seg, -big).amax(dim=1) + r
        cell = torch.clamp(hi_all - lo_all, min=1e-6) / G
        self.origin, self.inv_cell = lo_all, 1.0 / cell
        c0 = _cell_index((lo_seg - r - lo_all[:, None]) * self.inv_cell[:, None])
        c1 = _cell_index((hi_seg + r - lo_all[:, None]) * self.inv_cell[:, None])
        d = torch.arange(SPAN, device=dev)
        cx = c0[0][None, None, None, :] + d[None, None, :, None]
        cy = c0[1][None, None, None, :] + d[None, :, None, None]
        cz = c0[2][None, None, None, :] + d[:, None, None, None]
        ok = (cx <= c1[0]) & (cy <= c1[1]) & (cz <= c1[2]) & mask
        key = torch.where(ok, (cz * G + cy) * G + cx, G ** 3).reshape(-1)
        skey, perm = torch.sort(key, stable=True)
        n_ok = int(ok.sum())
        self.seg = (perm % S)[:n_ok]
        bounds = torch.searchsorted(skey[:n_ok], torch.arange(G ** 3 + 1, device=dev))
        self.start, self.count = bounds[:-1], bounds[1:] - bounds[:-1]
        self.records = torch.stack([a[0], a[1], a[2], ba[0], ba[1], ba[2],
                                    torch.full((S,), r, dtype=a.dtype, device=dev),
                                    torch.sum(ba * ba, dim=0)])
        self.n_entries = n_ok

    def ray_cells(self, o, d, tmax):
        """The distinct cells RAY_CELLS points along each ray fall in, in
        order -> (ray index, cell) of each kept (ray, cell) pair."""
        G, R = GRID, o.shape[1]
        ts = torch.linspace(0.0, 1.0, RAY_CELLS, dtype=torch.float32, device=o.device).to(o.dtype)
        p = o[:, None, :] + d[:, None, :] * (ts[None, :, None] * tmax[None, None, :])
        cc = _cell_index((p - self.origin[:, None, None]) * self.inv_cell[:, None, None])
        cell = (cc[2] * G + cc[1]) * G + cc[0]  # [M, R]
        prev = torch.cat([torch.full((1, R), -1, dtype=cell.dtype, device=o.device), cell[:-1]])
        keep = (cell != prev) & (self.count[cell] > 0)
        m, ray = torch.nonzero(keep, as_tuple=True)
        order = torch.argsort(ray * RAY_CELLS + m)
        return ray[order], cell[m, ray][order]


def _cell_index(x):
    """floor(x) clipped to the grid; a NaN (which only a control in a lower
    precision makes) goes to cell 0."""
    return torch.clamp(torch.floor(torch.nan_to_num(x, nan=0.0)), 0, GRID - 1).long()


def occlusion_bounds(grid: SegmentGrid, o, d, tmax, radius: float, counts: dict):
    """Per ray (o, d [3, R], tmax [R]) -> (lower, upper) bool [R]: a hit
    among the segments of its own sampled cells, a hit among all segments.
    Adds to `counts` the tests and roots the estimator needs: the segments
    of a ray's cells in order along it, up to its first hit."""
    dev, R = o.device, o.shape[1]
    ray7 = torch.cat([o, d, tmax[None]])
    ray_i, cell = grid.ray_cells(o, d, tmax)
    n_seg = grid.count[cell]
    pair_ray = torch.repeat_interleave(ray_i, n_seg)
    n_pairs = pair_ray.shape[0]
    first = torch.repeat_interleave(grid.start[cell] - (torch.cumsum(n_seg, 0) - n_seg), n_seg)
    seg = grid.seg[first + torch.arange(n_pairs, device=dev)]
    hit = torch.zeros(n_pairs, dtype=torch.bool, device=dev)
    roots = torch.zeros((3, n_pairs), dtype=torch.bool, device=dev)
    for sl in torch.arange(n_pairs, device=dev).split(1 << 22):
        h, r3 = _any_hit(ray7[:, pair_ray[sl]], grid.records[:, seg[sl]])
        hit[sl] = h
        roots[:, sl] = torch.stack(r3)
    # Pairs run in ray order, then in cell order along the ray: a pair is
    # needed unless an earlier pair of its ray hit.
    pos = torch.arange(n_pairs, device=dev)
    first_hit = torch.full((R,), n_pairs, dtype=torch.int64, device=dev)
    first_hit.scatter_reduce_(0, pair_ray[hit], pos[hit], "amin")
    need = pos <= first_hit[pair_ray]
    counts["ao_tests"] = counts.get("ao_tests", 0.0) + float(need.sum())
    counts["ao_roots"] = [c + float((need & k).sum())
                          for c, k in zip(counts.get("ao_roots", [0.0] * 3), roots)]
    counts["ao_rays"] = counts.get("ao_rays", 0.0) + R
    lower = first_hit < n_pairs
    # Upper end: every segment whose bounding sphere the ray can reach.
    rec = grid.records
    mid = rec[0:3] + 0.5 * rec[3:6]
    reach = (float(tmax.max()) + radius + 1e-3) + 0.5 * torch.sqrt(rec[7].float())
    upper = lower.clone()
    for rs in torch.arange(R, device=dev).split(max(1, (1 << 24) // rec.shape[1])):
        diff = mid[:, None, :].float() - o[:, rs, None].float()
        near = torch.sum(diff * diff, dim=0) <= (reach * reach)[None]
        rr, ss = torch.nonzero(near, as_tuple=True)
        if rr.numel():
            h, _ = _any_hit(ray7[:, rs[rr]], rec[:, ss])
            upper[rs[rr][h]] = True
    return lower, upper


def shade(g: dict, ao: torch.Tensor, tf_points):
    """Headlight Blinn-Phong of the visible surface with AO -> [4, K]."""
    d = g["ray"]
    dn = d * (1.0 / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True)))
    light = -dn
    ndl = torch.sum(g["normal"] * light, dim=0)
    tdl = torch.sum(g["tangent"] * light, dim=0)
    ndt = torch.sum(g["normal"] * g["tangent"], dim=0)
    denom = 1.0 / torch.sqrt(torch.clamp(1.0 - tdl * tdl, min=1e-6))
    cos1 = torch.clamp(torch.abs(ndl), 0.0, 1.0)
    cos2 = torch.clamp(torch.abs(ndl - tdl * ndt) * denom, 0.0, 1.0)
    cosc = 0.3 * cos1 ** 1.7 + 0.7 * cos2 ** 1.7
    spec = 0.3 * cos1 ** 30.0
    rgb = tf_rgb(tf_points, g["attr"])
    k_a = 0.2 + (1.0 - ao) * 0.5
    k_d = 0.9 * ao
    color = rgb * k_a[None] + rgb * (k_d * cosc)[None] + (spec * ao)[None]
    color = color * ao[None]
    bg = torch.tensor(BACKGROUND, dtype=torch.float32, device=ao.device).to(ao.dtype)
    out_rgb = torch.where(g["fg"][None], color, bg[:3, None])
    out_a = torch.where(g["fg"], torch.ones_like(ao), bg[3])
    return torch.cat([out_rgb, out_a[None]])


def rows_reference(caps: Capsules, grid: SegmentGrid, position, width, height, rows, tf_points,
                   counts: dict):
    """For each row y: (fg [W], shades [AO_SAMPLES + 1, 4, W], lo [W], hi
    [W]): the pixel's colour for every count c of its occluded rays, and
    the counts between which the program's must lie."""
    fr = Frame(caps, position, width, height)
    dev, dt = caps.a.device, caps.a.dtype
    key = threefry.prng_key(0, dev)
    k1, k2 = threefry.split_at(key, 0), threefry.split_at(key, 1)
    out = []
    for y in rows:
        g = fr.gbuffer_row(y)
        xs = torch.nonzero(g["fg"])[:, 0]
        K = xs.shape[0]
        lo = torch.zeros(width, dtype=torch.int64, device=dev)
        hi = torch.zeros(width, dtype=torch.int64, device=dev)
        if K:
            s_idx = torch.arange(AO_SAMPLES, device=dev)[:, None]
            flat = s_idx * (height * width) + y * width + xs[None, :]
            u1 = threefry.uniform_at(k1, flat).to(dt)
            u2 = threefry.uniform_at(k2, flat).to(dt)
            nrm, pos = g["normal"][:, xs], g["pos"][:, xs]
            dirs = cosine_hemisphere(u1, u2, nrm)  # [S, 3, K]
            origins = pos + nrm * (2.0 * caps.radius)
            o = origins[:, None].expand(3, AO_SAMPLES, K).reshape(3, -1)
            d = dirs.transpose(0, 1).reshape(3, -1)
            tmax = torch.full((AO_SAMPLES * K,), AO_RADIUS, dtype=dt, device=dev)
            low, up = occlusion_bounds(grid, o, d, tmax, caps.radius, counts)
            lo[xs] = low.reshape(AO_SAMPLES, K).sum(dim=0)
            hi[xs] = up.reshape(AO_SAMPLES, K).sum(dim=0)
        shades = torch.stack([shade(g, 1.0 - torch.full((width,), c / AO_SAMPLES, dtype=dt,
                                                        device=dev), tf_points)
                              for c in range(AO_SAMPLES + 1)])
        out.append((g["fg"], shades, lo, hi))
    return out


# The Standard.xml transfer function the renderer colours by (pos, r, g, b
# in 0-255 sRGB).
STANDARD_TF = ((0.0, 59, 76, 192), (0.25, 144, 178, 254), (0.5, 220, 220, 220),
               (0.75, 245, 156, 125), (1.0, 180, 4, 38))


def check(ctx, control=None) -> dict:
    """Compare the program's frames in `ctx.frames` on `ctx.rows` rows each,
    drawn from `ctx.rng` among the rows the line set covers. -> {"numbers":
    {"mismatch_share": wrong pixels / pixels the reference shows a line in},
    "counts": the AO estimator's work a frame}. With `control`, a dtype,
    the reference computed in that precision stands in the program's place
    (its pixels at the fewest occluded rays it finds)."""
    from linebench.reference.lines import capsules, read_binlines

    dev = ctx.device
    lines = read_binlines(ctx.inputs.path)
    caps = capsules(lines, ctx.inputs.line_width / 2.0, dev)
    grid = SegmentGrid(caps)
    if control is not None:
        caps_c = capsules(lines, ctx.inputs.line_width / 2.0, dev, control)
        grid_c = SegmentGrid(caps_c)
    tf = transfer_function_points(STANDARD_TF)
    W, H = ctx.width, ctx.height
    wrong = shown = 0
    counts = {}
    for fr in ctx.frames:
        lo, hi = Frame(caps, fr.position, W, H).content_rows()
        rows = strata_rows(ctx.rng, lo, hi, ctx.rows)
        n = len(rows)
        frame_counts = {}
        refs = rows_reference(caps, grid, fr.position, W, H, rows, tf, frame_counts)
        f = (hi - lo + 1) / n / len(ctx.frames)
        for k, v in frame_counts.items():
            counts[k] = ([c + x * f for c, x in zip(counts.get(k, [0.0] * len(v)), v)]
                         if isinstance(v, list) else counts.get(k, 0.0) + v * f)
        if control is not None:
            ctrl = rows_reference(caps_c, grid_c, fr.position, W, H, rows, tf, {})
        for i, (y, (fg, shades, c_lo, c_hi)) in enumerate(zip(rows, refs)):
            if control is None:
                prog = torch.as_tensor(np.ascontiguousarray(fr.image[y].T), device=dev)
            else:
                sh, lo_c = ctrl[i][1], ctrl[i][2]
                prog = sh.float().gather(0, lo_c[None, None].expand(1, 4, W))[0]
            err = (prog[None] - shades).abs() / (1.0 + shades.abs())
            err = err.amax(dim=1)  # [counts, W]
            c = torch.arange(AO_SAMPLES + 1, device=dev)[:, None]
            allowed = (c >= c_lo[None]) & (c <= c_hi[None])
            best = torch.where(allowed, err, torch.full_like(err, float("inf"))).amin(dim=0)
            wrong += int((best > PIXEL_TOLERANCE).sum())
            shown += int(fg.sum())
    counts["ao_records"] = float(grid.n_entries)
    return {"numbers": {"mismatch_share": wrong / max(shown, 1)}, "counts": counts}
