"""The traversal kernels' warp-shared walk order, emulated on the CPU.

The ray tracer's kernels (`csrc/bvh_closest_hit.cu`, `csrc/bvh_mlat.cu`)
walk the binary BVH one warp of 32 rays at a time (`bvh_capsule.cuh:
bvh_warp_walk`): one stack of (node, lane mask) a warp, an accepted node's
record holding both children's boxes (tested there against the box-only
part of each lane's test), the right child taken at once and the left one
pushed with each lane's entry t, and the state-dependent part of the test
applied when the child comes off the stack. `_warp_walk` below is a plain
emulation of that walk (all warps in lockstep, one node a warp a step) over
`ops.lbvh.node_records`, with the kernels' tests and leaf work written with
the plain versions' own helpers. Held bit for bit:
- the packed records against the tree's boxes, children and primitives,
  and the shared stack within `walk_stack_depth` entries;
- R1's walk against `capsule_closest_hit_reference` on every cast of the
  re-cast loop ((t, prim) and each ray's node visits and leaf tests), and
  the loop kernel's walk over the tree collapsed two levels at a time
  (`_wide_walk`, `ops.lbvh.wide_node_records`: (t, prim) and leaf tests);
- R2's walk against `mlat_nodes_reference` (nodes and counts);
on the random-walk scene and on a masked tornado cut (its parked segments
collapse the linear tree's Morton codes), over the linear and the
binned-SAH trees. A warp tests at least every node one of its lanes
accepts and at most the nodes its lanes visit.

R2's saturation cull and the order of a walk: node K-1's alpha never falls
and its depth never grows over a ray's insertions (checked on a saturating
scene and over the merge's float arithmetic), so once a box is culled its
descendants would be too; the kernels test every binary node all the same.
"""

import numpy as np
import pytest
import torch

from linevis_tpu_torch.core.trajectories import Trajectories
from linevis_tpu_torch.entry import tornado_trajectories
from linevis_tpu_torch.kernels import bvh_closest_hit as tch
from linevis_tpu_torch.kernels import bvh_mlat as tml
from linevis_tpu_torch.kernels.capsule_common import capsule_features, capsule_surfaces
from linevis_tpu_torch.ops import lbvh as tlbvh
from linevis_tpu_torch.render import ray_tracer as trt
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.pipeline import RasterSettings

torch.set_num_threads(1)

W, H = 64, 48
LANES = 32


def _walk_lines(seed=12, L=10, P=8, radius=0.03):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


def _tornado_lines():
    """24 tornado lines of up to 80 steps (some end early: masked
    segments), tubes thick enough to cover the small frame."""
    traj = tornado_trajectories("cpu", num_seeds=24, max_steps=80)
    assert isinstance(traj, Trajectories) and not traj.mask.all()
    return traj.positions, traj.mask, traj.attributes[:, 0], 0.02


SCENES = {"walk": _walk_lines, "tornado": _tornado_lines}


def _inputs(scene_name, builder):
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    s = RasterSettings(width=W, height=H)
    scene = ttr.build_capsule_scene(*SCENES[scene_name](), device="cpu")
    vp, cp, ab = ttr.camera_tensors(cam, "cpu")
    tree = tlbvh.lbvh_on(trt.build_capsule_bvh(scene, builder=builder), "cpu")
    return scene, tree, trt.tile_rays(vp, cp, s), ab, s, vp


def _warp_walk(tree, origins, dirs, walking, stat, dyn, leaf, max_stack=64):
    """The kernels' warp-shared walk over rays [R] (R a multiple of 32).

    stat(rays, tn, tf) -> bool: the part of a lane's test that depends on
    the box alone, tested at the parent; dyn(rays, tn) -> bool: the part
    that depends on the lane's state, tested when the child comes off the
    stack; leaf(rays, prim): the leaf work. -> (visits [R] and leaf tests
    [R] as each lane's own walk counts them, the nodes each warp tested
    [R / 32], the rays that overflowed [R])."""
    rec, depth = tlbvh.packed_nodes(tree, "cpu")
    box = rec.view(torch.float32)
    n = tree.leaf_prim.shape[0]
    inv = tlbvh.safe_inv(dirs)
    R = origins.shape[0]
    nw = R // LANES
    rays = torch.arange(R).reshape(nw, LANES)
    walking = walking.reshape(nw, LANES).clone()

    def slab_lanes(ws, rows, col):
        lo = box[rows, col:col + 3][:, None]
        hi = box[rows, col + 4:col + 7][:, None]
        o, iv = origins[rays[ws]], inv[rays[ws]]
        t0 = (lo - o) * iv
        t1 = (hi - o) * iv
        return torch.minimum(t0, t1).amax(dim=2), torch.maximum(t0, t1).amin(dim=2)

    def masked(fn, ws, sel, *xs):
        """fn on the lanes `sel` [A, 32] of warps ws -> bool [A, 32]."""
        out = torch.zeros_like(sel)
        aw, al = torch.nonzero(sel, as_tuple=True)
        if aw.numel():
            out[aw, al] = fn(rays[ws][aw, al], *(x[aw, al] for x in xs))
        return out

    all_w = torch.arange(nw)
    root = torch.full((nw,), n - 1, dtype=torch.int64)
    my_tn, tf = slab_lanes(all_w, root, 0)
    code = rec[n - 1, 3].long().repeat(nw)
    mask = masked(stat, all_w, walking, my_tn, tf)
    visits = walking.long()
    leaves = torch.zeros_like(visits)
    warp_visits = torch.zeros(nw, dtype=torch.int64)
    overflow = torch.zeros_like(walking)
    rd = torch.zeros(nw, dtype=torch.int64)
    sp = torch.zeros(nw, dtype=torch.int64)
    st_code = torch.zeros((nw, max_stack), dtype=torch.int64)
    st_rd = torch.zeros((nw, max_stack), dtype=torch.int64)
    st_mask = torch.zeros((nw, max_stack, LANES), dtype=torch.bool)
    st_tn = torch.zeros((nw, max_stack, LANES))
    alive = torch.ones(nw, dtype=torch.bool)
    while bool(alive.any()):
        w = torch.nonzero(alive).flatten()
        took = torch.zeros(len(w), dtype=torch.bool)  # took its right child at once
        has = mask[w].any(dim=1)
        warp_visits[w[has]] += 1
        acc = masked(dyn, w, mask[w] & walking[w], my_tn[w])
        is_leaf = code[w] < 0
        lh = acc & is_leaf[:, None]
        if bool(lh.any()):
            hw, hl = torch.nonzero(lh, as_tuple=True)
            leaves[w[hw], hl] += 1
            leaf(rays[w[hw], hl], ~code[w[hw]])
        inner = acc & ~is_leaf[:, None]
        m = inner.any(dim=1)
        over = m & (rd[w] + 2 > max_stack)
        if bool(over.any()):
            overflow[w[over]] |= inner[over]
            walking[w[over]] &= ~inner[over]
        go = m & ~over
        if bool(go.any()):
            gw, gacc = w[go], inner[go]
            rows = code[gw]
            tnl, tfl = slab_lanes(gw, rows, 0)
            tnr, tfr = slab_lanes(gw, rows, 8)
            visits[gw] += 2 * gacc
            sl = masked(stat, gw, gacc, tnl, tfl)
            sr = masked(stat, gw, gacc, tnr, tfr)
            push = sl.any(dim=1)
            pw = gw[push]
            st_code[pw, sp[pw]] = rec[rows[push], 3].long()
            st_mask[pw, sp[pw]] = sl[push]
            st_rd[pw, sp[pw]] = rd[pw]
            st_tn[pw, sp[pw]] = tnl[push]
            sp[pw] += 1
            assert int(sp.max()) <= depth  # the kernels' stack, sized by walk_stack_depth
            code[gw] = rec[rows, 7].long()
            mask[gw] = sr
            my_tn[gw] = tnr
            rd[gw] += 1
            took[go] = True
        rest = w[~took]
        empty = sp[rest] == 0
        alive[rest[empty]] = False
        pr = rest[~empty]
        sp[pr] -= 1
        code[pr] = st_code[pr, sp[pr]]
        mask[pr] = st_mask[pr, sp[pr]]
        rd[pr] = st_rd[pr, sp[pr]]
        my_tn[pr] = st_tn[pr, sp[pr]]
    return visits.flatten(), leaves.flatten(), warp_visits, overflow.flatten()


def _wide_walk(tree, origins, dirs, walking, stat, dyn, leaf):
    """The re-cast loop kernel's walk over the tree collapsed two levels at
    a time (`ops.lbvh.wide_node_records`): as `_warp_walk`, four slots a
    record in the binary walk's visit order, slot 0 taken at once, the
    others pushed last first; the intermediate level never tested. ->
    (leaf tests [R], the nodes each warp tested [R / 32])."""
    rec, depth = tlbvh.packed_wide_nodes(tree, "cpu")
    box = rec.view(torch.float32)
    m_rec = rec.shape[0] - 1
    inv = tlbvh.safe_inv(dirs)
    R = origins.shape[0]
    nw = R // LANES
    rays = torch.arange(R).reshape(nw, LANES)
    walking = walking.reshape(nw, LANES)

    def slab_lanes(ws, rows, col):
        lo = box[rows, col:col + 3][:, None]
        hi = box[rows, col + 4:col + 7][:, None]
        o, iv = origins[rays[ws]], inv[rays[ws]]
        t0 = (lo - o) * iv
        t1 = (hi - o) * iv
        return torch.minimum(t0, t1).amax(dim=2), torch.maximum(t0, t1).amin(dim=2)

    def masked(fn, ws, sel, *xs):
        out = torch.zeros_like(sel)
        aw, al = torch.nonzero(sel, as_tuple=True)
        if aw.numel():
            out[aw, al] = fn(rays[ws][aw, al], *(x[aw, al] for x in xs))
        return out

    all_w = torch.arange(nw)
    my_tn, tf = slab_lanes(all_w, torch.full((nw,), m_rec), 0)
    code = rec[m_rec, 3].long().repeat(nw)
    mask = masked(stat, all_w, walking, my_tn, tf)
    leaves = torch.zeros((nw, LANES), dtype=torch.int64)
    warp_visits = torch.zeros(nw, dtype=torch.int64)
    sp = torch.zeros(nw, dtype=torch.int64)
    st_code = torch.zeros((nw, depth), dtype=torch.int64)
    st_mask = torch.zeros((nw, depth, LANES), dtype=torch.bool)
    st_tn = torch.zeros((nw, depth, LANES))
    alive = torch.ones(nw, dtype=torch.bool)
    while bool(alive.any()):
        w = torch.nonzero(alive).flatten()
        took = torch.zeros(len(w), dtype=torch.bool)
        warp_visits[w[mask[w].any(dim=1)]] += 1
        acc = masked(dyn, w, mask[w] & walking[w], my_tn[w])
        is_leaf = code[w] < 0
        lh = acc & is_leaf[:, None]
        if bool(lh.any()):
            hw, hl = torch.nonzero(lh, as_tuple=True)
            leaves[w[hw], hl] += 1
            leaf(rays[w[hw], hl], ~code[w[hw]])
        go = (acc & ~is_leaf[:, None]).any(dim=1)
        if bool(go.any()):
            gw, gacc = w[go], acc[go]
            rows = code[gw]
            slots = []
            for k in range(4):
                tnk, tfk = slab_lanes(gw, rows, 8 * k)
                ck = rec[rows, 8 * k + 3].long()
                mk = masked(stat, gw, gacc & (ck != tlbvh.WIDE_EMPTY)[:, None], tnk, tfk)
                slots.append((ck, mk, tnk))
            for ck, mk, tnk in slots[:0:-1]:  # slots 3, 2, 1
                push = mk.any(dim=1)
                pw = gw[push]
                st_code[pw, sp[pw]] = ck[push]
                st_mask[pw, sp[pw]] = mk[push]
                st_tn[pw, sp[pw]] = tnk[push]
                sp[pw] += 1
            assert int(sp.max()) <= depth  # the kernel's stack, sized by wide_node_records
            code[gw], mask[gw], my_tn[gw] = slots[0]
            took[go] = True
        rest = w[~took]
        empty = sp[rest] == 0
        alive[rest[empty]] = False
        pr = rest[~empty]
        sp[pr] -= 1
        code[pr] = st_code[pr, sp[pr]]
        mask[pr] = st_mask[pr, sp[pr]]
        my_tn[pr] = st_tn[pr, sp[pr]]
    return leaves.flatten(), warp_visits


def _emulated_closest_hit(scene, tree, origins, dirs, t_min, prim_min, done, wide=False):
    """R1's cast through `_warp_walk` -> (t, prim, [R, 2] counts, warp
    tests); `wide`: through `_wide_walk` -> (t, prim, leaf tests [R], warp
    tests)."""
    R = origins.shape[0]
    t_best = torch.full((R,), float("inf"))
    best = torch.full((R,), -1, dtype=torch.int64)
    hit_fn = tch.capsule_hit_fn(scene)

    def stat(r, tn, tf):
        return (tf >= torch.clamp(tn, min=0.0)) & (tf >= t_min[r])

    def dyn(r, tn):
        return tn <= t_best[r]

    def leaf(r, prim):
        t_leaf = hit_fn(prim, origins[r], dirs[r], t_min[r], prim_min[r])
        tb, bb = t_best[r], best[r]
        closer = (t_leaf < tb) | ((t_leaf == tb) & torch.isfinite(t_leaf) & (prim < bb))
        t_best[r] = torch.where(closer, t_leaf, tb)
        best[r] = torch.where(closer, prim, bb)

    if wide:
        leaves, warps = _wide_walk(tree, origins, dirs, ~done, stat, dyn, leaf)
        return t_best, torch.where(torch.isfinite(t_best), best, -1).to(torch.int32), leaves, warps
    visits, leaves, warps, overflow = _warp_walk(tree, origins, dirs, ~done, stat, dyn, leaf)
    assert not bool(overflow.any())
    prim = torch.where(torch.isfinite(t_best), best, -1).to(torch.int32)
    return t_best, prim, torch.stack([visits, leaves], dim=1), warps


def _emulated_mlat(scene, tree, origins, dirs, wz, done, proj_ab, K, opacity, tf_opacity,
                   trail=None):
    """R2's walk through `_warp_walk` -> (nodes as `mlat_nodes`, [R, 3]
    counts, warp pops). `trail`, a list, receives node K-1's (depth,
    alpha) before and after every insertion of a ray whose buffer is full."""
    R = origins.shape[0]
    nd = torch.full((R, K), float("inf"))
    nf = torch.zeros((R, 3, K))
    na = torch.zeros((R, K))
    inserts = torch.zeros(R, dtype=torch.int64)
    zA, zB = proj_ab[0], proj_ab[1]

    def stat(r, tn, tf):
        return tf >= torch.clamp(tn, min=0.0)

    def dyn(r, tn):
        return (tn <= nd[r, K - 1]) | ~(na[r, K - 1] > 0.999)

    def leaf(r, prim):
        o, d = origins[r], dirs[r]
        for tc in capsule_surfaces(scene, prim, o, d, lambda tp: tp > 0.0):
            znd = zA - zB / torch.clamp(tc * wz[r], min=1e-12)
            valid = torch.isfinite(tc) & (znd >= 0.0) & (znd <= 1.0)
            inserts[r] += valid
            if not bool(valid.any()):
                continue
            v = torch.nonzero(valid).flatten()
            rv = r[v]
            feats = capsule_features(scene, prim[v], o[v], d[v], tc[v], tf_opacity, opacity)
            b_nd, b_nf, b_na = nd[rv], nf[rv], na[rv]
            before = (b_nd[:, K - 1].clone(), b_na[:, K - 1].clone())
            tml._insert(b_nd, b_nf, b_na, tc[v], *feats, K)
            if trail is not None:
                full = torch.isfinite(before[0])
                trail.append((before[0][full], before[1][full], b_nd[full, K - 1],
                              b_na[full, K - 1]))
            nd[rv], nf[rv], na[rv] = b_nd, b_nf, b_na

    visits, leaves, warps, overflow = _warp_walk(tree, origins, dirs, ~done, stat, dyn, leaf)
    assert not bool(overflow.any())
    nodes = (nd.T.contiguous(), nf.permute(1, 2, 0).contiguous(), na.T.contiguous())
    return nodes, torch.stack([visits, leaves, inserts], dim=1), warps


def _warp_bounds(warps, visits, leaves):
    """A warp tests every node one of its lanes accepts (the root and the
    internal nodes it accepted, (visits - 1) / 2 of them, and its leaf
    tests) and only nodes one of its lanes visits."""
    accepted = torch.where(visits > 0, (visits - 1) // 2 + leaves, 0).reshape(-1, LANES)
    assert bool((warps >= accepted.max(dim=1).values).all())
    assert bool((warps <= visits.reshape(-1, LANES).sum(dim=1)).all())


@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
@pytest.mark.parametrize("scene_name", ["walk", "tornado"])
def test_node_records_hold_the_tree(scene_name, builder):
    """Each internal node's record: both children's boxes exactly, their
    ids, or ~prim for a leaf child; the last record the root's box."""
    scene, tree, _, _, _, _ = _inputs(scene_name, builder)
    rec = tlbvh.node_records(tree)
    n = tree.leaf_prim.shape[0]
    assert rec.dtype == torch.int32 and rec.shape == (n, 16)
    box = rec.view(torch.float32)
    left, right = tree.left.long(), tree.right.long()
    for col, ids in ((0, left), (8, right)):
        assert torch.equal(box[:n - 1, col:col + 3], tree.node_min[ids])
        assert torch.equal(box[:n - 1, col + 4:col + 7], tree.node_max[ids])
    for col, ids in ((3, left), (7, right)):
        leaf = ids >= n - 1
        assert torch.equal(rec[:n - 1, col][~leaf], ids[~leaf].int())
        assert torch.equal(~rec[:n - 1, col][leaf], tree.leaf_prim[ids[leaf] - (n - 1)])
    assert torch.equal(box[n - 1, 0:3], tree.node_min[0])
    assert torch.equal(box[n - 1, 4:7], tree.node_max[0]) and int(rec[n - 1, 3]) == 0
    assert not bool(rec[:n - 1, [11, 15]].any()) and not bool(rec[n - 1, 7:].any())
    # The same records from the host form of the tree; a one-leaf tree's
    # root is its leaf.
    assert torch.equal(tlbvh.node_records(tree.numpy()), rec)
    one = tlbvh.build_lbvh(tree.node_min[n - 1:n], tree.node_max[n - 1:n])
    assert int(tlbvh.node_records(one)[0, 3]) == ~0


@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
def test_wide_records_hold_the_tree(builder):
    """Each 4-wide record's slots are its node's grandchildren (a leaf
    child standing for itself) in the binary walk's visit order: right
    child's right, right child's left, left child's right, left child's
    left, each with its box and its wide record or ~prim."""
    scene, tree, _, _, _, _ = _inputs("tornado", builder)
    rec, depth = tlbvh.wide_node_records(tree)
    box = rec.view(torch.float32)
    n = tree.leaf_prim.shape[0]
    left, right = tree.left.long(), tree.right.long()
    wide_of = {0: 0}  # binary internal node -> wide record, filled in walk order
    seen = 0
    for w in range(rec.shape[0] - 1):
        x = next(k for k, v in wide_of.items() if v == w)
        want = []
        for c in (int(right[x]), int(left[x])):
            want += [int(right[c]), int(left[c])] if c < n - 1 else [c, None]
        for k, node in enumerate(want):
            code = int(rec[w, 8 * k + 3])
            if node is None:
                assert code == tlbvh.WIDE_EMPTY
                continue
            assert torch.equal(box[w, 8 * k:8 * k + 3], tree.node_min[node])
            assert torch.equal(box[w, 8 * k + 4:8 * k + 7], tree.node_max[node])
            if node < n - 1:
                wide_of.setdefault(node, code)
                assert wide_of[node] == code
            else:
                assert ~code == int(tree.leaf_prim[node - (n - 1)])
        seen += 1
    assert seen == rec.shape[0] - 1 and 1 <= depth <= 3 * 20
    assert torch.equal(box[-1, 0:3], tree.node_min[0]) and int(rec[-1, 3]) == 0


@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
@pytest.mark.parametrize("scene_name", ["walk", "tornado"])
def test_closest_hit_walk_order_matches_plain(scene_name, builder):
    """Every cast of the re-cast loop: the emulated warp walk's (t, prim)
    and per-ray counts, and the collapsed walk's (t, prim) and leaf tests,
    equal `capsule_closest_hit_reference`'s on the same inputs (the loop
    goes on with the plain version's output)."""
    scene, tree, (o, d, wz, pad), ab, s, vp = _inputs(scene_name, builder)
    dmin, dmax = trt._depth_cue_range(scene, vp)
    casts = []

    def both(tree_, scene_, o_, d_, t_min, prim_min, done):
        st = torch.zeros((o_.shape[0], 2), dtype=torch.int64)
        p = tch.capsule_closest_hit_reference(tree_, scene_, o_, d_, t_min, prim_min, done,
                                              stats=st)
        e = _emulated_closest_hit(scene_, tree_, o_, d_, t_min, prim_min, done)
        assert torch.equal(e[0], p[0]) and torch.equal(e[1], p[1])
        assert torch.equal(e[2], st)
        _warp_bounds(e[3], st[:, 0], st[:, 1])
        w = _emulated_closest_hit(scene_, tree_, o_, d_, t_min, prim_min, done, wide=True)
        assert torch.equal(w[0], p[0]) and torch.equal(w[1], p[1])
        assert torch.equal(w[2], st[:, 1])  # the same leaf tests
        casts.append((int((p[1] >= 0).sum()), int(w[3].sum()), int(e[3].sum())))
        return p

    trt.trace_recast(tree, scene, o, d, wz, pad, ab, s, 6, 0.3, dmin, dmax, closest_hit=both)
    assert len(casts) == 6 and casts[0][0] > 50 and casts[-1][0] > 0
    # The collapsed walk tests fewer nodes than the binary one.
    assert sum(c[1] for c in casts) < sum(c[2] for c in casts)


@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
@pytest.mark.parametrize("scene_name", ["walk", "tornado"])
def test_mlat_walk_order_matches_plain(scene_name, builder):
    scene, tree, (o, d, wz, pad), ab, s, _ = _inputs(scene_name, builder)
    kw = dict(K=4, opacity=0.6, tf_opacity=((0.0, 0.6), (0.5, 1.0), (1.0, 0.8)))
    st = torch.zeros((o.shape[0], 3), dtype=torch.int64)
    p = tml.mlat_nodes_reference(tree, scene, o, d, wz, pad, ab, stats=st, **kw)
    e, e_st, warps = _emulated_mlat(scene, tree, o, d, wz, pad, ab, **kw)
    for a, b in zip(e, p):
        assert torch.equal(a, b)
    assert torch.equal(e_st, st)
    _warp_bounds(warps, st[:, 0], st[:, 1])
    assert int(torch.isfinite(p[0]).sum()) > 100


def test_mlat_saturation_never_lifts():
    """On a scene that saturates (opacity 1, K=2), node K-1's alpha never
    falls and its depth never grows over a ray's insertions once its buffer
    is full, and saturated rays cull boxes; over the merge's float
    arithmetic (node K-1 after an insertion in front: the shifted node's
    alpha a plus (1 - a) times the evicted alpha) no alpha above 0.999
    falls to 0.999 or below."""
    scene, tree, (o, d, wz, pad), ab, _, _ = _inputs("walk", "linear")
    trail = []
    kw = dict(K=2, opacity=1.0, tf_opacity=((0.0, 1.0), (1.0, 1.0)))
    nodes, st, _ = _emulated_mlat(scene, tree, o, d, wz, pad, ab, trail=trail, **kw)
    d0, a0, d1, a1 = (torch.cat(x) for x in zip(*trail))
    assert d0.numel() > 100 and int((a0 > 0.999).sum()) > 50
    assert bool((a1 >= a0).all()) and bool((d1 <= d0).all())
    no_cull = torch.zeros_like(st)
    tml.mlat_nodes_reference(tree, scene, o, d, wz, pad, ab, stats=no_cull,
                             **{**kw, "opacity": 0.05})
    assert int(st[:, 0].sum()) < int(no_cull[:, 0].sum())
    rng = np.random.default_rng(3)
    f = np.float32
    old = np.nextafter(f(0.999), f(1))
    olds = [old]
    for _ in range(15):
        olds.append(np.nextafter(olds[-1], f(1)))
    a = np.concatenate([rng.uniform(0, 1, 200_000), np.geomspace(1e-12, 1e-2, 20_000)])
    a = torch.from_numpy(a.astype(f))
    for ao in olds:
        ao = torch.tensor(float(ao))
        new = torch.clamp(a + (1.0 - a) * ao, max=1.0)
        assert bool((new >= ao).all())
