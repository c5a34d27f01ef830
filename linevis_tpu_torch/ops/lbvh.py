"""Binary BVHs over primitive AABBs: the linear (Morton radix tree) builder
and the host-side quality builders.

Counterpart of `linevis_tpu/ops/lbvh.py`. The reference offers four builder
qualities (Binned SAH / Sweep SAH / LOC / Linear,
`src/LineData/TrianglePayload/NodesBVHTreePayload.cpp:474-521` over
madmann91/bvh; enum `src/Renderers/Deferred/DeferredModes.hpp:79-92`):
- `build_lbvh`: the LINEAR builder as a data-parallel Karras 2012 radix
  tree on the device of its inputs. Every step (Morton codes, sort,
  per-node range search, split, range-min/max bounds) is a batched tensor
  operation over all nodes; nothing loops over nodes on the host.
- `build_bvh_sah`, `build_bvh_sweep_sah`, `build_bvh_ploc`: numpy on the
  host, as the reference builds them on the CPU. A scene-build-time
  operation, not a per-frame one.

Layout shared by all four (N leaves, N-1 internal nodes): internal nodes
[0, N-2] with the root at 0, leaves [N-1, 2N-2] over a permutation
`leaf_prim` of the primitives. With one primitive the tree is the single
leaf node 0.

`ray_query` is the stack-based closest-hit traversal, written as a lockstep
loop over all rays: each step pops one node of every ray whose stack is not
empty, so the loop runs as many steps as the longest walk. It is the plain
version of the per-ray traversal kernels (`kernels/bvh_closest_hit.py`,
`kernels/bvh_mlat.py`), which walk the same nodes in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Lbvh", "morton_codes", "build_lbvh", "build_bvh_sah", "build_bvh_sweep_sah",
    "build_bvh_ploc", "lbvh_on", "node_records", "walk_stack_depth", "packed_nodes",
    "wide_node_records", "packed_wide_nodes", "WIDE_EMPTY", "ray_query", "safe_inv",
    "StackOverflowError",
]


class StackOverflowError(RuntimeError):
    """A traversal stack would have passed its capacity."""


def _expand_bits(v):
    """Spread 10 bits to every 3rd position (int64 carrying 32-bit values)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """[N, 3] points in [0,1]^3 -> 30-bit Morton codes [N] (int64)."""
    q = torch.clamp(points * 1024.0, 0.0, 1023.0).long()
    return (
        (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | _expand_bits(q[:, 2])
    )


@dataclasses.dataclass(frozen=True)
class Lbvh:
    """Binary BVH. Internal nodes [0, N-2], leaves [N-1, 2N-2]. The arrays
    are tensors (`build_lbvh`) or numpy arrays (the host builders)."""

    left: object  # [N-1] child node id
    right: object  # [N-1]
    node_min: object  # [2N-1, 3]
    node_max: object  # [2N-1, 3]
    leaf_prim: object  # [N] sorted-leaf -> original primitive index
    # The traversal kernels' records of this tree (`packed_nodes`,
    # `packed_wide_nodes`), made at first use.
    packed: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def numpy(self) -> "Lbvh":
        """The same tree as numpy arrays on the host."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        return Lbvh(host(self.left), host(self.right), host(self.node_min), host(self.node_max),
                    host(self.leaf_prim))


def lbvh_on(bvh: Lbvh, device) -> Lbvh:
    """The tree as contiguous tensors on `device`: int32 child and leaf
    arrays, float32 [2N-1, 3] boxes (what the traversal kernels read);
    `bvh` itself, with its packed records, where it is in that form."""
    def t(x, dtype):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))
        return x.to(device=device, dtype=dtype).contiguous()

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    forms = ((bvh.left, torch.int32), (bvh.right, torch.int32), (bvh.node_min, torch.float32),
             (bvh.node_max, torch.float32), (bvh.leaf_prim, torch.int32))
    if all(isinstance(x, torch.Tensor) and x.dtype == dtype and x.is_contiguous()
           and x.device == dev for x, dtype in forms):
        return bvh
    return Lbvh(left=t(bvh.left, torch.int32), right=t(bvh.right, torch.int32),
                node_min=t(bvh.node_min, torch.float32),
                node_max=t(bvh.node_max, torch.float32),
                leaf_prim=t(bvh.leaf_prim, torch.int32))


def node_records(bvh: Lbvh) -> torch.Tensor:
    """The tree packed for the traversal kernels -> [N, 16] int32 on the
    tree's device, one 64-byte record a row: row i < N-1 holds internal node
    i's two children, (L.min.xyz, L.code, L.max.xyz, R.code, R.min.xyz, 0,
    R.max.xyz, 0), row N-1 the root, (min.xyz, code, max.xyz, 0, 0 x 8).
    Boxes are float32 bits; a code >= 0 is an internal node's id, a code < 0
    the leaf of primitive ~code. One record serves both children's box
    tests and both pushes."""
    n = bvh.leaf_prim.shape[0]
    tree = lbvh_on(bvh, bvh.node_min.device if isinstance(bvh.node_min, torch.Tensor) else "cpu")
    dev = tree.leaf_prim.device
    mn, mx = tree.node_min.view(torch.int32), tree.node_max.view(torch.int32)

    def code(ids):
        leaf = ids >= n - 1
        prim = tree.leaf_prim[torch.clamp(ids - (n - 1), min=0)]
        return torch.where(leaf, ~prim, ids.int())[:, None]

    left, right = tree.left.long(), tree.right.long()
    zero = torch.zeros((n - 1, 1), dtype=torch.int32, device=dev)
    inner = torch.cat([mn[left], code(left), mx[left], code(right), mn[right], zero, mx[right],
                       zero], dim=1)
    root_id = torch.zeros(1, dtype=torch.int64, device=dev)
    root = torch.cat([mn[:1], code(root_id), mx[:1],
                      torch.zeros((1, 9), dtype=torch.int32, device=dev)], dim=1)
    return torch.cat([inner, root]).contiguous()


def walk_stack_depth(bvh: Lbvh) -> int:
    """The most entries the traversal kernels' shared stack holds on this
    tree: a depth-first walk that takes the right child at once keeps one
    pushed left child per right turn on its path, so the largest number of
    right turns on a path from the root to an internal node, plus the push
    there (1 for a one-leaf tree)."""
    h = bvh.numpy()
    n = len(h.leaf_prim)
    left, right = h.left.astype(np.int64), h.right.astype(np.int64)
    turns = np.zeros(max(n - 1, 1), np.int64)
    front = np.zeros(1 if n > 1 else 0, np.int64)
    most = 0
    while front.size:
        most = max(most, int(turns[front].max()))
        l, r = left[front], right[front]
        inner_l, inner_r = l < n - 1, r < n - 1
        turns[l[inner_l]] = turns[front][inner_l]
        turns[r[inner_r]] = turns[front][inner_r] + 1
        front = np.concatenate([l[inner_l], r[inner_r]])
    return most + 1


WIDE_EMPTY = 0x7FFFFFFF  # the code of an unused slot of a 4-wide record


def wide_node_records(bvh: Lbvh):
    """The tree collapsed two binary levels at a time for the re-cast loop's
    walk -> (records [M + 1, 32] int32 on the tree's device, the most
    entries the walk's stack holds).

    Record w < M holds a 4-wide node X (the root and every internal
    grandchild reached so) as four slots in the binary walk's visit order:
    X's right child's children (right, then left) or the right child
    itself where it is a leaf, then the same of X's left child. Slot k is
    (min.xyz, code) at columns 8k..8k+3 and (max.xyz, 0) at 8k+4..8k+7: a
    code >= 0 the wide record of an internal node, < 0 the leaf of
    primitive ~code, `WIDE_EMPTY` no node. Record M is the root, (min.xyz,
    code, max.xyz, 0, 0 x 24). The walk takes slot 0 at once and pushes
    the other valid slots, last first, so its stack holds at most the sum
    over a path's records of the slots still pending, plus a push."""
    h = bvh.numpy()
    n = len(h.leaf_prim)
    left, right = h.left.astype(np.int64), h.right.astype(np.int64)
    mn = np.ascontiguousarray(h.node_min, np.float32).view(np.int32)
    mx = np.ascontiguousarray(h.node_max, np.float32).view(np.int32)
    prim = h.leaf_prim.astype(np.int64)
    inner = (lambda ids: ids < n - 1) if n > 1 else (lambda ids: np.zeros(ids.shape, bool))
    wid = np.full(max(n - 1, 1), -1, np.int64)
    rows, front, height = [], np.zeros(1 if n > 1 else 0, np.int64), np.zeros(1, np.int64)
    if n > 1:
        wid[0] = 0
    count, most = int(n > 1), 1
    while front.size:
        slots = []
        for c in (right[front], left[front]):
            ci = inner(c)
            cc = np.where(ci, c, 0)
            slots += [np.where(ci, right[cc], c), np.where(ci, left[cc], -1)]
        sl = np.stack(slots, 1)  # [F, 4] binary node ids in visit order, -1 none
        valid = sl >= 0
        # Slots still pending when the walk descends into slot k, and the
        # stack after this record's pushes.
        after = np.cumsum(valid[:, ::-1], axis=1)[:, ::-1] - valid
        most = max(most, int((height + valid.sum(1) - 1).max()))
        nxt = valid & inner(np.maximum(sl, 0))
        new_ids = sl[nxt]
        wid[new_ids] = count + np.arange(new_ids.size)
        count += new_ids.size
        code = np.full(sl.shape, WIDE_EMPTY, np.int64)
        code[nxt] = wid[new_ids]
        leaf_slot = valid & ~nxt
        code[leaf_slot] = ~prim[sl[leaf_slot] - (n - 1)]
        idx = np.maximum(sl, 0)
        rec = np.zeros((front.size, 4, 8), np.int32)
        rec[:, :, 0:3] = np.where(valid[:, :, None], mn[idx], 0)
        rec[:, :, 3] = code
        rec[:, :, 4:7] = np.where(valid[:, :, None], mx[idx], 0)
        rows.append(rec.reshape(-1, 32))
        height = np.broadcast_to(height[:, None], sl.shape)[nxt] + after[nxt]
        front = new_ids
    root = np.zeros((1, 32), np.int32)
    root[0, 0:3], root[0, 4:7] = mn[0], mx[0]
    root[0, 3] = 0 if n > 1 else ~prim[0]
    out = np.concatenate(rows + [root]) if rows else root
    dev = bvh.node_min.device if isinstance(bvh.node_min, torch.Tensor) else "cpu"
    return torch.from_numpy(out).to(dev), most


def packed_nodes(bvh: Lbvh, device) -> tuple:
    """The tree on `device` as the traversal kernels read it ->
    (`node_records` [N, 16] int32, `walk_stack_depth`), made once per tree
    in `lbvh_on` form (kept in its `packed`)."""
    tree = lbvh_on(bvh, device)
    if "binary" not in tree.packed:
        tree.packed["binary"] = (node_records(tree), walk_stack_depth(tree))
    return tree.packed["binary"]


def packed_wide_nodes(bvh: Lbvh, device) -> tuple:
    """`wide_node_records` of the tree on `device`, kept as `packed_nodes`."""
    tree = lbvh_on(bvh, device)
    if "wide" not in tree.packed:
        tree.packed["wide"] = wide_node_records(tree)
    return tree.packed["wide"]


def _bit_length(x):
    """Highest set bit position + 1 of non-negative int64 values (0 -> 0)."""
    r = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        hi = x >> s
        has = hi > 0
        r = r + torch.where(has, s, 0)
        x = torch.where(has, hi, x)
    return r + (x > 0).long()


def build_lbvh(aabb_min: torch.Tensor, aabb_max: torch.Tensor) -> Lbvh:
    """Build from per-primitive AABBs [N, 3] on their device.

    Centroids are normalized by the bounds of ALL boxes before they are
    quantized to 10 bits per axis, so a few far-away boxes collapse the
    codes of all the others; equal codes are split by sorted index (Karras
    2012, section 4)."""
    n = aabb_min.shape[0]
    dev = aabb_min.device
    centroid = 0.5 * (aabb_min + aabb_max)
    lo = aabb_min.amin(dim=0)
    hi = aabb_max.amax(dim=0)
    unit = (centroid - lo) / torch.clamp(hi - lo, min=1e-12)
    codes_s, order = torch.sort(morton_codes(unit), stable=True)
    lmin, lmax = aabb_min[order], aabb_max[order]
    if n == 1:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return Lbvh(empty, empty, lmin, lmax, order.to(torch.int32))

    i = torch.arange(n - 1, device=dev)

    def delta(j):
        """Common-prefix length of the (code, index) pairs i and j; -1
        outside the array."""
        valid = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        x = codes_s[i] ^ codes_s[jc]
        lz = torch.where(x == 0, 64 - _bit_length(i ^ jc), 32 - _bit_length(x))
        return torch.where(valid, lz, -1)

    n_bits = int(np.ceil(np.log2(max(n, 2)))) + 1
    d = torch.sign(delta(i + 1) - delta(i - 1))
    dmin = delta(i - d)
    # Exponential upper bound of the range length, then binary search.
    lmax_ = torch.full_like(i, 2)
    for _ in range(n_bits + 2):
        lmax_ = torch.where(delta(i + lmax_ * d) > dmin, lmax_ * 2, lmax_)
    length, t = torch.zeros_like(i), lmax_ // 2
    for _ in range(n_bits + 1):
        length = torch.where((t > 0) & (delta(i + (length + t) * d) > dmin),
                             length + t, length)
        t = t // 2
    j = i + length * d
    # Split position: highest differing bit inside [min(i,j), max(i,j)].
    dnode = delta(j)
    s, t = torch.zeros_like(i), (length + 1) // 2
    for _ in range(n_bits + 1):
        s = torch.where((t > 0) & (delta(i + (s + t) * d) > dnode), s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp(d, max=0)
    first, last = torch.minimum(i, j), torch.maximum(i, j)
    left = torch.where(first == gamma, (n - 1) + gamma, gamma)
    right = torch.where(last == gamma + 1, (n - 1) + gamma + 1, gamma + 1)

    # Bounds: sparse-table range min/max over the sorted leaf AABBs.
    levels_min, levels_max = [lmin], [lmax]
    w = 1
    while w < n:
        pmin, pmax = levels_min[-1], levels_max[-1]
        levels_min.append(torch.minimum(pmin, torch.cat([pmin[w:], pmin[-w:]])))
        levels_max.append(torch.maximum(pmax, torch.cat([pmax[w:], pmax[-w:]])))
        w *= 2
    table_min, table_max = torch.stack(levels_min), torch.stack(levels_max)  # [L, N, 3]
    k = (_bit_length(last - first + 1) - 1).clamp(0, len(levels_min) - 1)
    b2 = torch.clamp(last - torch.bitwise_left_shift(torch.ones_like(k), k) + 1, min=0)
    int_min = torch.minimum(table_min[k, first], table_min[k, b2])
    int_max = torch.maximum(table_max[k, first], table_max[k, b2])
    return Lbvh(
        left=left.to(torch.int32), right=right.to(torch.int32),
        node_min=torch.cat([int_min, lmin]), node_max=torch.cat([int_max, lmax]),
        leaf_prim=order.to(torch.int32),
    )


def _surface_np(mn, mx):
    d = np.maximum(mx - mn, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _host_boxes(aabb_min, aabb_max):
    """(amin, amax) float32 arrays, or the single-leaf tree when N == 1."""
    amin = np.asarray(aabb_min, np.float32)
    amax = np.asarray(aabb_max, np.float32)
    n = amin.shape[0]
    if n == 0:
        raise ValueError("need >= 1 primitive")
    if n == 1:
        # Node 0 is the leaf, as the linear builder gives for one primitive.
        empty = np.zeros((0,), np.int32)
        return Lbvh(empty, empty, amin, amax, np.zeros((1,), np.int32))
    return amin, amax


def _fill_bounds(left, right, perm, amin, amax):
    """Leaf bounds from the permutation, then internal nodes in reverse id
    order (preorder ids: children are resolved first) -> Lbvh."""
    n = perm.shape[0]
    node_min = np.zeros((2 * n - 1, 3), np.float32)
    node_max = np.zeros((2 * n - 1, 3), np.float32)
    node_min[n - 1:] = amin[perm]
    node_max[n - 1:] = amax[perm]
    for i in range(n - 2, -1, -1):
        node_min[i] = np.minimum(node_min[left[i]], node_min[right[i]])
        node_max[i] = np.maximum(node_max[left[i]], node_max[right[i]])
    return Lbvh(left, right, node_min, node_max, perm)


def _topdown_from_split(amin, amax, perm, split_range):
    """Top-down scaffolding of the host builders (iterative DFS, preorder
    internal ids so that every child id exceeds its parent's, bounds fill):
    `split_range(lo, hi)` partitions `perm[lo:hi]` in place and returns mid
    (lo < mid < hi)."""
    n = amin.shape[0]
    left = np.zeros((n - 1,), np.int32)
    right = np.zeros((n - 1,), np.int32)

    def child_id(lo, hi, next_internal):
        if hi - lo == 1:
            return (n - 1) + lo, next_internal
        return next_internal, next_internal + 1

    next_internal = 1  # root = 0
    stack = [(0, 0, n)]
    while stack:
        my_id, lo, hi = stack.pop()
        mid = split_range(lo, hi)
        lid, next_internal = child_id(lo, mid, next_internal)
        rid, next_internal = child_id(mid, hi, next_internal)
        left[my_id] = lid
        right[my_id] = rid
        if mid - lo > 1:
            stack.append((lid, lo, mid))
        if hi - mid > 1:
            stack.append((rid, mid, hi))
    return _fill_bounds(left, right, perm, amin, amax)


def build_bvh_sah(aabb_min, aabb_max, num_bins: int = 16) -> Lbvh:
    """Binned-SAH top-down builder (host-side numpy).

    Split rule per node: `num_bins` uniform centroid bins on every axis
    (largest extent first), take the partition minimizing
    SA_L*N_L + SA_R*N_R; median split when binning degenerates."""
    boxes = _host_boxes(aabb_min, aabb_max)
    if isinstance(boxes, Lbvh):
        return boxes
    amin, amax = boxes
    n = amin.shape[0]
    cent = 0.5 * (amin + amax)
    perm = np.arange(n, dtype=np.int32)

    def split_range(lo, hi):
        idx = perm[lo:hi]
        c = cent[idx]
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        ext = chi - clo
        best = None  # (cost, axis, bin_j)
        for ax in np.argsort(-ext):
            if ext[ax] <= 1e-12:
                continue
            rel = (c[:, ax] - clo[ax]) / ext[ax]
            b = np.minimum((rel * num_bins).astype(np.int32), num_bins - 1)
            counts = np.bincount(b, minlength=num_bins)
            if int((counts > 0).sum()) < 2:
                continue
            binmin = np.full((num_bins, 3), np.inf, np.float32)
            binmax = np.full((num_bins, 3), -np.inf, np.float32)
            np.minimum.at(binmin, b, amin[idx])
            np.maximum.at(binmax, b, amax[idx])
            lc = np.cumsum(counts)[:-1]
            rc = (hi - lo) - lc
            lmin = np.minimum.accumulate(binmin, axis=0)[:-1]
            lmax = np.maximum.accumulate(binmax, axis=0)[:-1]
            rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1][1:]
            rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1][1:]
            ok = (lc > 0) & (rc > 0)
            cost = np.where(
                ok, _surface_np(lmin, lmax) * lc + _surface_np(rmin, rmax) * rc, np.inf
            )
            j = int(np.argmin(cost))
            if np.isfinite(cost[j]) and (best is None or cost[j] < best[0]):
                best = (float(cost[j]), int(ax), j)
        if best is None:
            return lo + (hi - lo) // 2
        _, ax, j = best
        rel = (c[:, ax] - clo[ax]) / ext[ax]
        b = np.minimum((rel * num_bins).astype(np.int32), num_bins - 1)
        go_left = b <= j
        order = np.argsort(~go_left, kind="stable")
        perm[lo:hi] = idx[order]
        mid = lo + int(go_left.sum())
        if mid == lo or mid == hi:
            mid = lo + (hi - lo) // 2
        return mid

    return _topdown_from_split(amin, amax, perm, split_range)


def build_bvh_sweep_sah(aabb_min, aabb_max) -> Lbvh:
    """Full-sweep SAH builder (host-side numpy): per node, primitives are
    sorted by centroid on each axis and the exact SAH cost
    SA_L*N_L + SA_R*N_R is evaluated at every split position through prefix
    and suffix bound sweeps. O(n log^2 n); the best tree of the top-down
    family."""
    boxes = _host_boxes(aabb_min, aabb_max)
    if isinstance(boxes, Lbvh):
        return boxes
    amin, amax = boxes
    n = amin.shape[0]
    cent = 0.5 * (amin + amax)
    perm = np.arange(n, dtype=np.int32)

    def split_range(lo, hi):
        idx = perm[lo:hi]
        m = hi - lo
        best = None  # (cost, axis, i, order)
        for ax in range(3):
            order = np.argsort(cent[idx, ax], kind="stable")
            o_idx = idx[order]
            pmin = np.minimum.accumulate(amin[o_idx], axis=0)[:-1]
            pmax = np.maximum.accumulate(amax[o_idx], axis=0)[:-1]
            smin = np.minimum.accumulate(amin[o_idx][::-1], axis=0)[::-1][1:]
            smax = np.maximum.accumulate(amax[o_idx][::-1], axis=0)[::-1][1:]
            counts = np.arange(1, m, dtype=np.float64)
            cost = _surface_np(pmin, pmax) * counts + _surface_np(smin, smax) * (m - counts)
            i = int(np.argmin(cost))
            if best is None or cost[i] < best[0]:
                best = (float(cost[i]), ax, i, order)
        _, ax, i, order = best
        perm[lo:hi] = idx[order]
        return lo + i + 1

    return _topdown_from_split(amin, amax, perm, split_range)


def build_bvh_ploc(aabb_min, aabb_max, search_radius: int = 16) -> Lbvh:
    """PLOC (parallel locally-ordered clustering, Meister & Bittner 2018)
    builder (host-side numpy): leaves are Morton-sorted, then clusters merge
    with their nearest neighbor (least merged surface area) within a window
    of +-`search_radius`; mutual nearest pairs merge each round. The
    bottom-up topology is relabeled to this module's preorder ids."""
    boxes = _host_boxes(aabb_min, aabb_max)
    if isinstance(boxes, Lbvh):
        return boxes
    amin, amax = boxes
    n = amin.shape[0]
    cent = 0.5 * (amin + amax)
    lo_all = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo_all, 1e-12)
    q = np.clip(((cent - lo_all) / ext * 1023.0), 0, 1023).astype(np.uint64)

    def expand(v):
        v = (v | (v << 16)) & np.uint64(0x30000FF)
        v = (v | (v << 8)) & np.uint64(0x300F00F)
        v = (v | (v << 4)) & np.uint64(0x30C30C3)
        v = (v | (v << 2)) & np.uint64(0x9249249)
        return v

    codes = ((expand(q[:, 0]) << np.uint64(2)) | (expand(q[:, 1]) << np.uint64(1))
             | expand(q[:, 2]))
    order = np.argsort(codes, kind="stable")

    # Cluster state: temp node ids (leaves 0..n-1, internals n..2n-2).
    ids = order.astype(np.int32)
    bmin = amin[order].copy()
    bmax = amax[order].copy()
    tmp_l = np.zeros((n - 1,), np.int32)
    tmp_r = np.zeros((n - 1,), np.int32)
    next_tmp = n
    while ids.shape[0] > 1:
        m = ids.shape[0]
        rad = min(search_radius, m - 1)
        best_c = np.full((m,), np.inf, np.float64)
        best_j = np.full((m,), -1, np.int64)
        for d in range(1, rad + 1):
            c = _surface_np(np.minimum(bmin[:-d], bmin[d:]), np.maximum(bmax[:-d], bmax[d:]))
            i = np.arange(m - d)
            upd = c < best_c[:-d]
            best_c[:-d][upd] = c[upd]
            best_j[:-d][upd] = i[upd] + d
            updr = c < best_c[d:]
            best_c[d:][updr] = c[updr]
            best_j[d:][updr] = i[updr]
        mutual = best_j[best_j] == np.arange(m)
        first = mutual & (np.arange(m) < best_j)
        keep = np.ones((m,), bool)
        new_ids = ids.copy()
        fi = np.nonzero(first)[0]
        for i in fi:  # sequential id assignment (deterministic)
            j = best_j[i]
            tmp_l[next_tmp - n] = ids[i]
            tmp_r[next_tmp - n] = ids[j]
            new_ids[i] = next_tmp
            next_tmp += 1
            keep[j] = False
        bmin[fi] = np.minimum(bmin[fi], bmin[best_j[fi]])
        bmax[fi] = np.maximum(bmax[fi], bmax[best_j[fi]])
        if not first.any():  # safety: force-merge the first pair
            tmp_l[next_tmp - n] = ids[0]
            tmp_r[next_tmp - n] = ids[1]
            new_ids[0] = next_tmp
            next_tmp += 1
            keep[1] = False
            bmin[0] = np.minimum(bmin[0], bmin[1])
            bmax[0] = np.maximum(bmax[0], bmax[1])
        ids = new_ids[keep]
        bmin = bmin[keep]
        bmax = bmax[keep]

    # Preorder relabel: internal ids 0..n-2 (parent < children), leaf slots
    # in DFS encounter order carry the primitive permutation.
    left = np.zeros((n - 1,), np.int32)
    right = np.zeros((n - 1,), np.int32)
    perm = np.zeros((n,), np.int32)
    next_internal = 1
    next_leaf = 0
    stack = [(0, int(ids[0]))]  # (new id, temp id), from the temp root
    while stack:
        my_id, tmp = stack.pop()
        for side, arr in ((tmp_l[tmp - n], left), (tmp_r[tmp - n], right)):
            if side < n:  # leaf
                perm[next_leaf] = side
                arr[my_id] = (n - 1) + next_leaf
                next_leaf += 1
            else:
                arr[my_id] = next_internal
                stack.append((next_internal, int(side)))
                next_internal += 1
    return _fill_bounds(left, right, perm, amin, amax)


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """Slab reciprocal of ray directions: 1/d, or +-1e12 (the sign of
    d + 1e-30) where |d| < 1e-12."""
    tiny = torch.abs(d) < 1e-12
    return torch.where(tiny, 1e12 * torch.sign(d + 1e-30), 1.0 / torch.where(tiny, 1.0, d))


def _ray_aabb(o, inv_d, bmin, bmax, t_best, t_min=None):
    """Slab test of rays [A, 3] against boxes [A, 3] -> hit [A]: the box
    is entered in front of the origin, no later than t_best, and (with
    `t_min`) left no earlier than t_min."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=1)
    tf = torch.maximum(t0, t1).amin(dim=1)
    hit = (tf >= torch.clamp(tn, min=0.0)) & (tn <= t_best)
    if t_min is not None:
        hit = hit & (tf >= t_min)
    return hit


def ray_query(
    bvh: Lbvh,
    origins: torch.Tensor,  # [R, 3]
    directions: torch.Tensor,  # [R, 3]
    prim_hit_fn=None,  # (prim [A], o [A, 3], d [A, 3]) -> t [A] (inf on miss); None: AABB t
    max_stack: int = 64,
    t_min: torch.Tensor = None,  # [R] enumerate hits with (t, prim) >
    prim_min: torch.Tensor = None,  # [R] ... lexicographically (t_min, prim_min)
    done: torch.Tensor = None,  # [R] bool: rays that query nothing
    stats: torch.Tensor = None,  # [R, 2] int64: node visits, leaf tests
):
    """Closest-hit traversal -> (t [R] float32, prim [R] int32; inf and -1
    on a miss) on the rays' device.

    With `t_min`/`prim_min` given, returns the closest hit STRICTLY
    lexicographically after (t_min, prim_min): repeated queries from a fixed
    origin enumerate every surface along the ray in (t, prim) order, ties on
    t going to the smaller prim id. `prim_hit_fn` is then called as
    (prim, o, d, t_min, prim_min), on the rays that reach a leaf at that step,
    and must itself honor the lexicographic lower bound among its surfaces.

    Each ray pops its stack's top, tests the node's box, runs the primitive
    test at a leaf and pushes an internal node's left child, then its right
    (popped first). A push past `max_stack` raises StackOverflowError (the
    JAX function writes it to the last slot unchecked). Rays flagged `done`
    return (inf, -1) and visit nothing. `stats` receives each ray's node
    visits and leaf tests (leaves whose box test passed).
    """
    if (t_min is None) != (prim_min is None):
        raise ValueError("t_min and prim_min go together")
    dev = origins.device
    tree = lbvh_on(bvh, dev)
    n = tree.leaf_prim.shape[0]
    R = origins.shape[0]
    inv_d = safe_inv(directions)
    stack = torch.zeros((R, max_stack), dtype=torch.int64, device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)
    if done is not None:
        sp = torch.where(done, 0, sp)
    t_best = torch.full((R,), float("inf"), dtype=torch.float32, device=dev)
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((R, 2), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(sp > 0).flatten()
        if act.numel() == 0:
            break
        sp_a = sp[act] - 1
        node = stack[act, sp_a]
        hit = _ray_aabb(origins[act], inv_d[act], tree.node_min[node], tree.node_max[node],
                        t_best[act], None if t_min is None else t_min[act])
        is_leaf = node >= n - 1
        leaf = is_leaf & hit
        counts[act, 0] += 1
        counts[act, 1] += leaf
        if bool(leaf.any()):
            la = act[leaf]
            ln = node[leaf]
            prim = tree.leaf_prim[ln - (n - 1)].long()
            if prim_hit_fn is None:
                t0 = (tree.node_min[ln] - origins[la]) * inv_d[la]
                t1 = (tree.node_max[ln] - origins[la]) * inv_d[la]
                t_leaf = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=0.0)
            elif t_min is None:
                t_leaf = prim_hit_fn(prim, origins[la], directions[la])
            else:
                t_leaf = prim_hit_fn(prim, origins[la], directions[la], t_min[la], prim_min[la])
            tb, bb = t_best[la], best[la]
            closer = t_leaf < tb
            if t_min is not None:
                closer = closer | ((t_leaf == tb) & torch.isfinite(t_leaf) & (prim < bb))
            t_best[la] = torch.where(closer, t_leaf, tb)
            best[la] = torch.where(closer, prim, bb)
        push = ~is_leaf & hit
        if bool(push.any()):
            pa, ps, pn = act[push], sp_a[push], node[push].long()
            if bool((ps + 2 > max_stack).any()):
                raise StackOverflowError(f"a ray's traversal stack passed {max_stack} entries")
            stack[pa, ps] = tree.left[pn].long()
            stack[pa, ps + 1] = tree.right[pn].long()
            sp_a[push] = ps + 2
        sp[act] = sp_a
    if stats is not None:
        stats.copy_(counts)
    best = torch.where(torch.isfinite(t_best), best, -1)
    return t_best, best.to(torch.int32)
