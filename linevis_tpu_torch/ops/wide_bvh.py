"""8-wide BVH packing for the wavefront traversal kernel.

Counterpart of `linevis_tpu/ops/wide_bvh.py`. The reference traces tubes
through a hardware binary BVH
(`Data/Shaders/Renderers/RayTracing/TubeRayTracing.glsl:61-82`). A block of
128 rays that shares one traversal stack wants few, wide visits: this module
collapses any binary `Lbvh` (linear, SAH or PLOC: the tree's quality
survives the collapse) into an 8-wide BVH whose node group is one
[8, 128] float32 record:

- each ROW is one child: lanes 0-2 aabb min, 3-5 aabb max, 6 child group
  pointer (-1 for leaves), 7 leaf flag, 8-19 the capsule payload of a leaf
  child (a, ba, r, baba, attr0, dattr, cap_a, prim id), so a leaf group
  carries its geometry and needs no second fetch; lanes 20-127 are zero
  (the layout is shared with the JAX package);
- groups are emitted in BFS order (root = group 0). Padding rows get +inf
  bounds (never hit), pointer -1 and leaf flag 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from linevis_tpu_torch.ops.lbvh import Lbvh

__all__ = ["WideBvh", "pack_wide_bvh"]

# Record lane layout (per child row).
LANE_BMIN = 0  # 0-2
LANE_BMAX = 3  # 3-5
LANE_PTR = 6
LANE_LEAF = 7
LANE_A = 8  # 8-10
LANE_BA = 11  # 11-13
LANE_R = 14
LANE_BABA = 15
LANE_ATTR0 = 16
LANE_DATTR = 17
LANE_CAPA = 18
LANE_ID = 19
USED_LANES = 20
RECORD_LANES = 128


@dataclasses.dataclass(frozen=True)
class WideBvh:
    """groups: [n_groups * 8, 128] float32 (C-contiguous)."""

    groups: np.ndarray
    n_groups: int


def pack_wide_bvh(
    bvh: Lbvh,
    a: np.ndarray,  # [3, S] capsule starts
    ba: np.ndarray,  # [3, S]
    radius: float,
    attr0: np.ndarray,  # [S]
    dattr: np.ndarray,  # [S]
    cap_a: np.ndarray,  # [S] chain-start cap flags
    max_width: int = 8,
) -> WideBvh:
    """Collapse a binary Lbvh into BFS-ordered 8-wide groups (host-side)."""
    bvh = bvh.numpy()
    left, right = bvh.left.tolist(), bvh.right.tolist()
    node_min, node_max = bvh.node_min, bvh.node_max
    leaf_prim = bvh.leaf_prim
    n = leaf_prim.shape[0]
    a = np.asarray(a, np.float32)
    ba = np.asarray(ba, np.float32)
    d = np.maximum(node_max - node_min, 0.0)
    surface = (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]).tolist()

    def expand(root):
        """At most max_width binary subtree roots under `root`: the
        internal child of largest surface is expanded first (the usual
        binary-to-wide collapse rule)."""
        ch = [root]
        while len(ch) < max_width:
            ints = [c for c in ch if c < n - 1]
            if not ints:
                break
            c = max(ints, key=surface.__getitem__)
            ch.remove(c)
            ch.append(left[c])
            ch.append(right[c])
        return ch

    # BFS over group roots. With one primitive the tree is the single leaf
    # node 0: a one-child group.
    nodes, ptrs, rows = [], [], []  # per child row: binary node, group pointer, record row
    n_groups, queue, head = 0, [0], 0
    while head < len(queue):
        ch = [0] if n == 1 else expand(queue[head])
        head += 1
        for j, c in enumerate(ch):
            nodes.append(c)
            rows.append(n_groups * 8 + j)
            if c >= n - 1:
                ptrs.append(-1)
            else:
                ptrs.append(len(queue))  # the group this child's subtree becomes
                queue.append(c)
        n_groups += 1

    rec = np.zeros((n_groups * 8, RECORD_LANES), np.float32)
    # Padding rows: bmin == bmax == +inf makes the slab test miss every ray
    # whatever the direction's sign (an inverted [-inf, +inf] box would HIT:
    # the slab test's per-axis min/max erases the inversion).
    rec[:, LANE_BMIN:LANE_BMAX + 3] = np.inf
    rec[:, LANE_PTR] = -1.0
    nodes, ptrs, rows = np.asarray(nodes), np.asarray(ptrs, np.float32), np.asarray(rows)
    rec[rows, LANE_BMIN:LANE_BMIN + 3] = node_min[nodes]
    rec[rows, LANE_BMAX:LANE_BMAX + 3] = node_max[nodes]
    rec[rows, LANE_PTR] = ptrs
    leaf = nodes >= n - 1
    lrows = rows[leaf]
    p = leaf_prim[nodes[leaf] - (n - 1)]
    rec[lrows, LANE_LEAF] = 1.0
    rec[lrows, LANE_A:LANE_A + 3] = a[:, p].T
    rec[lrows, LANE_BA:LANE_BA + 3] = ba[:, p].T
    rec[lrows, LANE_R] = radius
    rec[lrows, LANE_BABA] = np.sum(ba * ba, axis=0)[p]
    rec[lrows, LANE_ATTR0] = np.asarray(attr0, np.float32)[p]
    rec[lrows, LANE_DATTR] = np.asarray(dattr, np.float32)[p]
    rec[lrows, LANE_CAPA] = np.asarray(cap_a, np.float32)[p]
    rec[lrows, LANE_ID] = p.astype(np.float32)
    return WideBvh(groups=rec, n_groups=n_groups)
