"""Plain reference of the registry's "Opaque" frame with `tubeGeometry`
"triangle" on a line set, for chosen rows: the reference's own tube mesh
(`Tubes.hpp:40-150`: a ring of 8 vertices extruded along each line by its
parallel-transport frames, two triangles a quad), drawn at twice the width
and height and box-filtered down, as the registry draws it.

A sample at a pixel centre takes the nearest triangle whose three edge
functions are not negative there and whose depth lies in [0, 1], the lower
triangle id among equal depths, among the triangles binned to the sample's
32x16 tile: a triangle whose bounding box straddles no pixel centre is
culled (in float32 the edge functions of such a sliver can pass at a
centre outside it), the others go into the 2x2 tiles from their box's low
corner. Its attribute, normal and tangent are interpolated
perspective-correctly from planes in screen space; the sample is shaded by
headlight Blinn-Phong for tubes (kA 0.1, kD 0.9, kS 0.3, s 30, the cosines
to the power 1.7) with the Standard transfer function's 256-entry table.
The program walks a tile's triangles in chunks of 128 sorted by a depth
bucket, keeps a tie with the earlier chunk and stops at the first chunk
behind the whole tile; a sample where that order picks another triangle
than the nearest-then-lowest-id rule is a mismatch here.

Every value is rounded as the program's plain versions round it, so on the
same device a right sample matches to the bit; `dtype` computes the whole
reference in another precision (the control).
"""

from __future__ import annotations

import numpy as np
import torch

from linebench.reference import camera as cam
from linebench.reference.lines import PIXEL_TOLERANCE, Lines, read_binlines, strata_rows

SUBDIV = 8
SUPERSAMPLE = 2
TILE_W, TILE_H = 32, 16  # the registry's tiles for this path
SPAN = 2  # tiles per axis a triangle is binned into, from its bbox's low corner
Z_NEAR = 1e-4
BACKGROUND = (1.0, 1.0, 1.0, 1.0)
STANDARD_TF = ((0.0, 59, 76, 192), (0.25, 144, 178, 254), (0.5, 220, 220, 220),
               (0.75, 245, 156, 125), (1.0, 180, 4, 38))


def tf_table(points, n: int = 256) -> np.ndarray:
    """[n, 4] float32: linear RGB interpolated between the points (0-255
    sRGB), opacity 1."""
    xs = np.linspace(0.0, 1.0, n)
    cp = np.asarray(points, np.float64)
    c = np.clip(cp[:, 1:4] / 255.0, 0.0, 1.0)
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    table = np.zeros((n, 4), np.float32)
    for ch in range(3):
        table[:, ch] = np.interp(xs, cp[:, 0], lin[:, ch])
    table[:, 3] = np.interp(xs, [0.0, 1.0], [1.0, 1.0])
    return table


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalize(v):
    return v / torch.clamp(_norm(v), min=1e-8)


def _initial_normal(t0):
    ax = torch.abs(t0)
    eye = torch.eye(3, dtype=t0.dtype, device=t0.device)
    use_x = ((ax[:, 0] <= ax[:, 1]) & (ax[:, 0] <= ax[:, 2]))[:, None]
    use_y = (ax[:, 1] <= ax[:, 2])[:, None]
    helper = torch.where(use_x, eye[0], torch.where(use_y, eye[1], eye[2]))
    n = helper - torch.sum(helper * t0, dim=-1, keepdim=True) * t0
    return _normalize(n)


def frames(pos):
    """(tangents, normals, binormals) [L, P, 3] of padded lines: central
    differences (one-sided at the ends and over the padding), the normal
    carried from point to point by projection onto the tangent's plane."""
    fwd = pos[:, 1:] - pos[:, :-1]
    zero = torch.zeros_like(fwd[:, :1])
    d_fwd = torch.cat([fwd, zero], dim=1)
    d_bwd = torch.cat([zero, fwd], dim=1)
    t = d_fwd + d_bwd
    t = torch.where(_norm(t) > 1e-8, t, d_bwd)
    t = torch.where(_norm(t) > 1e-8, t, d_fwd)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    t = _normalize(torch.where(_norm(t) > 1e-8, t, x_axis))
    n_prev = _initial_normal(t[:, 0])
    normals = []
    for i in range(t.shape[1]):
        t_i = t[:, i]
        n = n_prev - torch.sum(n_prev * t_i, dim=-1, keepdim=True) * t_i
        norm = _norm(n)
        n_prev = torch.where(norm > 1e-5, n / torch.clamp(norm, min=1e-8), _initial_normal(t_i))
        normals.append(n_prev)
    normals = torch.stack(normals, dim=1)
    return t, normals, _normalize(torch.linalg.cross(t, normals, dim=-1))


class TubeMesh:
    """Grid-shaped [3, S, L, P] ring vertices, normals, tangents and [S, L, P]
    attributes; triangle (s, a, l, p) joins ring s and s + 1 between points p
    and p + 1."""

    def __init__(self, lines: Lines, radius: float, device, dtype):
        pos = torch.tensor(lines.positions, device=device).to(dtype)
        m = torch.tensor(lines.mask, device=device)
        at = torch.tensor(lines.attr, device=device).to(dtype)
        L, P, S = pos.shape[0], pos.shape[1], SUBDIV
        tangents, normals, binormals = frames(pos)

        def cf(g):
            return g.reshape(L * P, 3).T.reshape(3, 1, L, P)

        theta = 2.0 * np.pi * np.arange(S) / S
        ring = torch.tensor(np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32),
                            device=device).to(dtype)
        cosr = ring[:, 0].reshape(1, S, 1, 1)
        sinr = (ring[:, 1] * 1.0).reshape(1, S, 1, 1)
        dir3 = cosr * cf(normals) + sinr * cf(binormals)
        self.positions = cf(pos) + float(radius) * dir3
        self.normals = dir3 / torch.clamp(torch.sqrt(torch.sum(dir3 * dir3, dim=0, keepdim=True)),
                                          min=1e-8)
        self.tangents = cf(tangents).expand(3, S, L, P).contiguous()
        self.attrs = at[None].expand(S, L, P).contiguous()
        self.mask = m


def _corners(g):
    """The 3 corner tensors [..., S, 2, L, P - 1] of a grid [..., S, L, P],
    flattened in triangle order (s, a, l, p)."""
    r = torch.roll(g, -1, dims=-3)
    lo, lo1, ro, ro1 = g[..., :-1], g[..., 1:], r[..., :-1], r[..., 1:]

    def two(x0, x1):
        return torch.stack([x0, x1], dim=-3)

    return torch.stack([c.reshape(c.shape[:-4] + (-1,)) for c in
                        (two(lo, lo), two(ro, ro1), two(ro1, lo1))], dim=0)


class Frame:
    """One camera's vertex stage over the whole mesh at the drawn size."""

    def __init__(self, mesh: TubeMesh, position, width: int, height: int):
        dev, dt = mesh.positions.device, mesh.positions.dtype
        self.W, self.H = width, height
        vp = torch.as_tensor(cam.view_projection(position, width, height), device=dev).to(dt)
        grid_shape = tuple(mesh.positions.shape[1:])
        flat = mesh.positions.reshape(3, -1)
        clip = vp[:3, :3] @ flat + vp[:3, 3][:, None]
        w = vp[3, :3] @ flat + vp[3, 3]
        w_safe = torch.where(torch.abs(w) < Z_NEAR, torch.full_like(w, Z_NEAR), w)
        inv_w = (1.0 / w_safe).reshape(grid_shape)
        clip = clip.reshape((3,) + grid_shape)
        w = w.reshape(grid_shape)
        self.x = _corners((clip[0] * inv_w * 0.5 + 0.5) * width)
        self.y = _corners((0.5 - clip[1] * inv_w * 0.5) * height)
        self.z = _corners(clip[2] * inv_w)
        self.iw = _corners(inv_w)
        self.attr = _corners(mesh.attrs)
        self.normal = [_corners(mesh.normals[c]) for c in range(3)]
        self.tangent = [_corners(mesh.tangents[c]) for c in range(3)]
        seg = mesh.mask[:, :-1] & mesh.mask[:, 1:]
        S = grid_shape[0]
        tri_mask = seg[None, None].expand((S, 2) + tuple(seg.shape)).reshape(-1)
        valid = tri_mask & torch.all(_corners(w) > Z_NEAR, dim=0)
        # The binning: a triangle whose bbox straddles no pixel centre is
        # culled; the others go into the SPAN x SPAN tiles from their bbox's
        # low corner, as far as the bbox reaches.
        xmin, xmax = self.x.amin(dim=0), self.x.amax(dim=0)
        ymin, ymax = self.y.amin(dim=0), self.y.amax(dim=0)
        on_screen = (xmax >= 0) & (ymax >= 0) & (xmin < width) & (ymin < height)
        covers_x = torch.floor(xmax - 0.5) >= torch.ceil(xmin - 0.5)
        covers_y = torch.floor(ymax - 0.5) >= torch.ceil(ymin - 0.5)
        self.valid = valid & on_screen & covers_x & covers_y
        tiles_x, tiles_y = -(-width // TILE_W), -(-height // TILE_H)

        def tile(v, size, n):
            return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int32)

        self.tx0, self.ty0 = tile(xmin, TILE_W, tiles_x), tile(ymin, TILE_H, tiles_y)
        self.tx1 = torch.minimum(tile(xmax, TILE_W, tiles_x), self.tx0 + SPAN - 1)
        self.ty1 = torch.minimum(tile(ymax, TILE_H, tiles_y), self.ty0 + SPAN - 1)
        self.y_lo = ymin.float()
        self.y_hi = ymax.float()
        fwd, r, u = vp[3, :3], vp[0, :3], vp[1, :3]
        tx, ty = torch.linalg.norm(r), torch.linalg.norm(u)
        right, up = r / torch.clamp(tx, min=1e-12), u / torch.clamp(ty, min=1e-12)
        fwd = fwd / torch.clamp(torch.linalg.norm(fwd), min=1e-12)
        self.basis = torch.stack([right / tx, up / ty, fwd], dim=1)
        self.o = torch.as_tensor(np.asarray(position, np.float32), device=dev).to(dt)

    def payload(self, t):
        """Edge rows (9), then the planes of depth, 1/w, attr/w, normal/w,
        tangent/w, each (a, b, c) with value (a gx + b gy) + c, of the
        triangles t."""
        x, y = self.x[:, t], self.y[:, t]

        def edge(i, j):
            return y[i] - y[j], x[j] - x[i], x[i] * y[j] - x[j] * y[i]

        a0, b0, c0 = edge(1, 2)
        a1, b1, c1 = edge(2, 0)
        a2, b2, c2 = edge(0, 1)
        area2 = a0 * x[0] + b0 * y[0] + c0
        sign = torch.where(area2 >= 0, 1.0, -1.0).to(area2.dtype)
        degenerate = torch.abs(area2) < 1e-12
        zero = torch.zeros_like(area2)

        def fix(a, b, c):
            return (torch.where(degenerate, zero, a * sign), torch.where(degenerate, zero, b * sign),
                    torch.where(degenerate, zero - 1.0, c * sign))

        e = [*fix(a0, b0, c0), *fix(a1, b1, c1), *fix(a2, b2, c2)]
        inv_area = torch.where(degenerate, zero, 1.0 / torch.abs(area2))

        def plane(u):
            return [(u[0] * e[k] + u[1] * e[k + 3] + u[2] * e[k + 6]) * inv_area for k in range(3)]

        iw = self.iw[:, t]

        def wplane(q):
            q = q[:, t]
            return plane([q[0] * iw[0], q[1] * iw[1], q[2] * iw[2]])

        planes = [plane(self.z[:, t]), plane(iw), wplane(self.attr)]
        planes += [wplane(c) for c in self.normal] + [wplane(c) for c in self.tangent]
        return e, planes

    def sample_row(self, ys: int, table: torch.Tensor):
        """The shaded samples [4, W] of sample row ys."""
        dev, dt = self.o.device, self.o.dtype
        W = self.W
        gx = (torch.arange(W, device=dev).float() + 0.5).to(dt)
        gy = float(ys) + 0.5
        ty = ys // TILE_H
        cand = torch.nonzero(self.valid & (self.ty0 <= ty) & (self.ty1 >= ty))[:, 0]
        tx = torch.arange(W, device=dev) // TILE_W
        best_z = torch.full((W,), float("inf"), dtype=torch.float32, device=dev)
        best_id = torch.full((W,), -1, dtype=torch.int64, device=dev)
        gyt = torch.full_like(gx, gy)
        for t in cand.split(4096) if cand.numel() else ():
            e, planes = self.payload(t)

            def f(a, b, c):
                return (a[:, None] * gx[None] + b[:, None] * gyt[None]) + c[:, None]

            z = f(*planes[0])
            binned = (self.tx0[t][:, None] <= tx[None]) & (self.tx1[t][:, None] >= tx[None])
            inside = (f(*e[0:3]) >= 0.0) & (f(*e[3:6]) >= 0.0) & (f(*e[6:9]) >= 0.0) \
                & (z >= 0.0) & (z <= 1.0) & binned
            zm = torch.where(inside, z, torch.full_like(z, float("inf"))).float()
            bz = zm.amin(dim=0)
            ids = torch.where(zm <= bz[None], t[:, None], torch.iinfo(torch.int64).max).amin(dim=0)
            better = (bz < best_z) | ((bz == best_z) & (ids < best_id) & (bz < float("inf")))
            best_z = torch.where(better, bz, best_z)
            best_id = torch.where(better, ids, best_id)
        fg = best_id >= 0
        win = torch.where(fg, best_id, 0)
        _, planes = self.payload(win)
        val = [(p[0] * gx + p[1] * gyt) + p[2] for p in planes[1:]]
        zero = torch.zeros((), dtype=dt, device=dev)
        val = [torch.where(fg, v, zero) for v in val]
        return shade(val, fg, gx, gy, self, table)


def _normalize3(v):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=0, keepdim=True)), min=1e-8)


def _cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _dot3(a, b):
    return torch.sum(a * b, dim=0)


def shade(val, fg, gx, gy, fr: Frame, table):
    """Samples -> [4, W] linear RGBA (shade_gbuffer of the registry's
    Opaque frame: no depth cue, white background)."""
    dev, dt = fg.device, val[0].dtype
    inv_w, attr_w = torch.clamp(val[0], min=1e-12), val[1]
    view_z = 1.0 / inv_w
    attr = attr_w * view_z
    normal = _normalize3(torch.stack(val[2:5]))
    tangent = _normalize3(torch.stack(val[5:8]))
    u = gx * (2.0 / fr.W) - 1.0
    v = 1.0 - torch.full_like(gx, gy) * (2.0 / fr.H)
    b = fr.basis
    dirs = b[:, 0][:, None] * u[None] + b[:, 1][:, None] * v[None] + b[:, 2][:, None]
    pos = fr.o[:, None] + dirs * view_z[None]
    n = table.shape[0]
    tt = table.T
    f = torch.clamp(attr, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(f).long(), 0, n - 2)
    wgt = f - i0
    lut = [tt[c][i0] * (1.0 - wgt) + tt[c][i0 + 1] * wgt for c in range(4)]
    rgb = torch.stack(lut[:3])
    nn = _normalize3(normal)
    vv = _normalize3(fr.o[:, None] - pos)
    h = _normalize3(vv + vv)
    t = _normalize3(tangent)
    helper = _normalize3(_cross3(t, vv))
    new_l = _normalize3(_cross3(helper, t))
    cos1 = torch.clamp(torch.abs(_dot3(nn, vv)), 0.0, 1.0) ** 1.7
    cos2 = torch.clamp(torch.abs(_dot3(nn, new_l)), 0.0, 1.0) ** 1.7
    cos_c = 0.3 * cos1 + 0.7 * cos2
    color = 0.1 * rgb + 0.9 * cos_c[None] * rgb + 0.3 * torch.clamp(
        torch.abs(_dot3(nn, h)), 0.0, 1.0)[None] ** 30.0
    bg = torch.tensor(BACKGROUND, dtype=torch.float32, device=dev).to(dt)
    out_rgb = torch.where(fg[None], color, bg[:3, None])
    out_a = torch.where(fg, lut[3], bg[3])
    return torch.cat([out_rgb, out_a[None]])


def rows_reference(mesh: TubeMesh, position, width, height, rows, table):
    """The registry's image on rows `rows` -> [len(rows), width, 4] numpy:
    each row the box filter of its two sample rows at twice the size."""
    k = SUPERSAMPLE
    fr = Frame(mesh, position, width * k, height * k)
    out = []
    for y in rows:
        s = torch.stack([fr.sample_row(k * y + j, table) for j in range(k)])  # [k, 4, kW]
        img = np.moveaxis(s.float().cpu().numpy(), 1, -1)  # [k, kW, 4]
        out.append(img.reshape(1, k, width, k, 4).mean(axis=(1, 3))[0])
    return np.stack(out)


def content_rows(fr: Frame, height: int):
    """[first, last] output rows the valid triangles may cover."""
    if not bool(fr.valid.any()):
        return 0, 0
    lo = float(fr.y_lo[fr.valid].min()) / SUPERSAMPLE
    hi = float(fr.y_hi[fr.valid].max()) / SUPERSAMPLE
    return max(int(np.floor(lo)), 0), min(int(np.ceil(hi)), height - 1)


def check(ctx, control=None) -> dict:
    """Compare the program's frames in `ctx.frames` on `ctx.rows` rows each,
    drawn from `ctx.rng` among the rows the tubes cover. -> {"numbers":
    {"mismatch_share": wrong pixels / pixels the reference shows a tube in}}.
    With `control`, a dtype, the reference computed in that precision
    stands in the program's place."""
    dev = ctx.device
    # The vertex stage's matrix products in float32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = read_binlines(ctx.inputs.path)
    table = torch.as_tensor(tf_table(STANDARD_TF), device=dev)
    mesh = TubeMesh(lines, ctx.inputs.line_width / 2.0, dev, torch.float32)
    mesh_c = None if control is None else TubeMesh(lines, ctx.inputs.line_width / 2.0, dev,
                                                   control)
    W, H = ctx.width, ctx.height
    wrong = shown = 0
    for fr in ctx.frames:
        probe = Frame(mesh, fr.position, W * SUPERSAMPLE, H * SUPERSAMPLE)
        lo, hi = content_rows(probe, H)
        del probe
        rows = strata_rows(ctx.rng, lo, hi, ctx.rows)
        want = rows_reference(mesh, fr.position, W, H, rows, table)
        if control is None:
            got = np.stack([fr.image[y] for y in rows])
        else:
            got = rows_reference(mesh_c, fr.position, W, H, rows, table.to(control))
        err = (np.abs(got - want) / (1.0 + np.abs(want))).max(axis=-1)
        wrong += int((err > PIXEL_TOLERANCE).sum())
        shown += int((np.abs(want - np.asarray(BACKGROUND, np.float32)).max(axis=-1) > 0).sum())
    return {"numbers": {"mismatch_share": wrong / max(shown, 1)}, "counts": {}}
