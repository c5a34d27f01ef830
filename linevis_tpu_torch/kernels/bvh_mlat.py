"""Multi-layer alpha tracing over the binary BVH (kernel R2).

The traversal of the MLAT ray tracer (`render/ray_tracer.py:render_tubes_mlat`):
one walk per ray that inserts every capsule surface it reaches into K
depth-sorted nodes of premultiplied deferred-shading features. The JAX
package writes it as the vmapped `lax.while_loop` of
`linevis_tpu/render/ray_tracer.py:441-533`; it reaches no `pl.pallas_call`.

On a CUDA tensor `mlat_nodes` launches the hand-written kernel
`csrc/bvh_mlat.cu` (each warp of 32 rays walks the tree together over
`ops.lbvh.packed_nodes`, every lane in its own order); on a CPU tensor it runs
`mlat_nodes_reference`, the same function in plain PyTorch, a lockstep loop
over all rays. The semantics, in order per ray:
- pop the stack's top; an internal node pushes its left child, then its
  right (popped first);
- a box is culled where it lies behind node K-1 while that node's alpha is
  above 0.999 (the buffer is saturated);
- at a leaf the capsule's entry surface, then its exit surface (t > 0, NDC
  depth in [0, 1]) is inserted by depth into the K nodes; a fragment pushed
  out of node K-1 merges into it under its remaining transmittance, and
  node K-1's alpha is clamped to 1 after every insertion.
The merge sees fragments in arrival order, so the visit order is part of the
function. Both versions round every operation alike and agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.bvh_closest_hit import traversal_counts, walk_records
from linevis_tpu_torch.kernels.capsule_common import capsule_features, capsule_surfaces
from linevis_tpu_torch.kernels.raster_capsule_oit import tf_table
from linevis_tpu_torch.ops.lbvh import Lbvh, StackOverflowError, lbvh_on, safe_inv

__all__ = ["mlat_nodes", "mlat_nodes_reference", "MAX_STACK", "K_MAX", "STATS"]

MAX_STACK = 64  # node ids a ray's stack holds (the JAX default)
K_MAX = 32  # most nodes the kernel keeps
STATS = ("visits", "leaf_tests", "inserts")


def _insert(nd, nf, na, tc, attr, c1, c2, ac, K):
    """Insert one fragment per row into the rows' K nodes ([B, K], [B, 3,
    K], [B, K], updated in place) and merge the evicted one into node K-1."""
    cd, cf, ca = tc, [attr * ac, c1 * ac, c2 * ac], ac
    for j in range(K):
        take = cd < nd[:, j]
        x = nd[:, j]
        new = torch.where(take, cd, x)
        cd = torch.where(take, x, cd)
        nd[:, j] = new
        for c in range(3):
            x = nf[:, c, j]
            new = torch.where(take, cf[c], x)
            cf[c] = torch.where(take, x, cf[c])
            nf[:, c, j] = new
        x = na[:, j]
        new = torch.where(take, ca, x)
        ca = torch.where(take, x, ca)
        na[:, j] = new
    evict = torch.isfinite(cd)
    w = 1.0 - na[:, K - 1]
    for c in range(3):
        nf[:, c, K - 1] = torch.where(evict, nf[:, c, K - 1] + w * cf[c], nf[:, c, K - 1])
    na[:, K - 1] = torch.clamp(na[:, K - 1] + torch.where(evict, w * ca, 0.0), max=1.0)


def mlat_nodes_reference(tree: Lbvh, scene, origins, dirs, wz, done, proj_ab, K: int = 8,
                         opacity: float = 0.3, tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0)),
                         max_stack: int = MAX_STACK, stats=None):
    """Plain PyTorch version of the kernel (same contract as `mlat_nodes`)."""
    dev = origins.device
    tree = lbvh_on(tree, dev)
    n = tree.leaf_prim.shape[0]
    R = origins.shape[0]
    inv_d = safe_inv(dirs)
    zA, zB = proj_ab[0], proj_ab[1]
    stack = torch.zeros((R, max_stack), dtype=torch.int64, device=dev)
    sp = torch.where(done, 0, 1).long()
    nd = torch.full((R, K), float("inf"), dtype=torch.float32, device=dev)
    nf = torch.zeros((R, 3, K), dtype=torch.float32, device=dev)
    na = torch.zeros((R, K), dtype=torch.float32, device=dev)
    counts = torch.zeros((R, len(STATS)), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(sp > 0).flatten()
        if act.numel() == 0:
            break
        sp_a = sp[act] - 1
        node = stack[act, sp_a]
        o, inv = origins[act], inv_d[act]
        t0 = (tree.node_min[node] - o) * inv
        t1 = (tree.node_max[node] - o) * inv
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1)
        saturated = na[act, K - 1] > 0.999
        hit = (tf >= torch.clamp(tn, min=0.0)) & ((tn <= nd[act, K - 1]) | ~saturated)
        is_leaf = node >= n - 1
        leaf = is_leaf & hit
        counts[act, 0] += 1
        counts[act, 1] += leaf
        if bool(leaf.any()):
            la = act[leaf]
            prim = tree.leaf_prim[node[leaf] - (n - 1)].long()
            o_l, d_l, wz_l = origins[la], dirs[la], wz[la]
            surfaces = capsule_surfaces(scene, prim, o_l, d_l, lambda tp: tp > 0.0)
            s_nd, s_nf, s_na = nd[la], nf[la], na[la]
            for tc in surfaces:
                vz = tc * wz_l
                znd = zA - zB / torch.clamp(vz, min=1e-12)
                valid = torch.isfinite(tc) & (znd >= 0.0) & (znd <= 1.0)
                counts[la, 2] += valid
                if not bool(valid.any()):
                    continue
                v = torch.nonzero(valid).flatten()
                feats = capsule_features(scene, prim[v], o_l[v], d_l[v], tc[v], tf_opacity,
                                         opacity)
                b_nd, b_nf, b_na = s_nd[v], s_nf[v], s_na[v]
                _insert(b_nd, b_nf, b_na, tc[v], *feats, K)
                s_nd[v], s_nf[v], s_na[v] = b_nd, b_nf, b_na
            nd[la], nf[la], na[la] = s_nd, s_nf, s_na
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
    return nd.T.contiguous(), nf.permute(1, 2, 0).contiguous(), na.T.contiguous()


def _launcher():
    """The kernel's C entry point (built and loaded at first use), with its
    argument types declared so ctypes passes 64-bit pointers."""
    fn = _build.load("bvh_mlat").bvh_mlat_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, p, p, p, p, p, i, f, f, p, p, p, p, i, i, i, i, f, f, f, p, p, p, p,
                   p, p]
    fn.restype = ctypes.c_int
    return fn


def mlat_nodes(
    tree: Lbvh,  # binary BVH over the scene's capsules
    scene,  # CapsuleScene
    origins: torch.Tensor,  # [R, 3]
    dirs: torch.Tensor,  # [R, 3] unit
    wz: torch.Tensor,  # [R] view depth per unit t along the ray
    done: torch.Tensor,  # [R] bool: rays that trace nothing
    proj_ab: torch.Tensor,  # [2] = (zA, zB): z_ndc = zA - zB / view_z
    K: int = 8,
    opacity: float = 0.3,
    tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0)),
    max_stack: int = MAX_STACK,
    stats: Optional[torch.Tensor] = None,
    warp_visits: Optional[torch.Tensor] = None,
):
    """Trace R rays into K nodes each -> (depth [K, R] world t, inf where
    empty; feat [3, K, R] premultiplied (attr, cos1, cos2); alpha [K, R]).

    A CUDA tensor launches the CUDA kernel (counted in `mlat_nodes.launches`);
    a CPU tensor runs the plain version. `stats`, an optional [R, 3] int64
    tensor, receives each ray's `STATS`: node visits, leaf tests, surfaces
    inserted. `warp_visits`, an optional [ceil(R / 32)] int64 tensor,
    receives the nodes each warp of 32 rays tested in the kernel's shared
    walk (the kernel alone has it: a CPU tensor raises). A push past
    `max_stack` (<= 64) raises StackOverflowError (on the card after a
    synchronize)."""
    if not 1 <= K <= K_MAX:
        raise ValueError(f"K={K}: need 1 <= K <= {K_MAX}")
    if not 1 <= max_stack <= MAX_STACK:
        raise ValueError(f"max_stack={max_stack}: need 1 <= max_stack <= {MAX_STACK}")
    if origins.device.type == "cpu":
        if warp_visits is not None:
            raise ValueError("warp_visits counts the kernel's shared walk: a CUDA reading")
        return mlat_nodes_reference(tree, scene, origins, dirs, wz, done, proj_ab, K, opacity,
                                    tf_opacity, max_stack, stats)
    if origins.device.type != "cuda":
        raise ValueError(f"mlat_nodes: unsupported device {origins.device}")
    dev = origins.device
    tree = lbvh_on(tree, dev)
    R = origins.shape[0]
    for name, x, dtype, shape in (
        ("origins", origins, torch.float32, (R, 3)), ("dirs", dirs, torch.float32, (R, 3)),
        ("wz", wz, torch.float32, (R,)), ("done", done, torch.bool, (R,)),
    ):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}")
    seg = [scene.a.float().contiguous(), scene.ba.float().contiguous(),
           scene.cap_a.float().contiguous(), scene.mask.contiguous(),
           scene.attr0.float().contiguous(), scene.dattr.float().contiguous()]
    if any(x.device != dev for x in seg):
        raise ValueError("the scene must lie on the rays' device")
    ins = [x.contiguous() for x in (origins, dirs, wz, done)]
    ab = proj_ab.float().cpu().numpy()
    tf = tf_table((), tf_opacity, dev)
    out = torch.empty((5 * K, R), dtype=torch.float32, device=dev)
    counts, warps = traversal_counts(stats, warp_visits, R, dev, len(STATS))
    nodes, cap = walk_records(tree, dev, max_stack)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    r32 = np.float32(scene.radius)
    with torch.cuda.device(dev):
        rc = _launcher()(
            nodes.data_ptr(), tree.leaf_prim.shape[0], *(x.data_ptr() for x in seg),
            scene.a.shape[1], float(r32 * r32), float(r32), *(x.data_ptr() for x in ins), R, K,
            max_stack, cap, float(ab[0]), float(ab[1]), float(np.float32(opacity)), tf.data_ptr(),
            out.data_ptr(), None if counts is None else counts.data_ptr(),
            None if warps is None else warps.data_ptr(), overflow.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh_mlat kernel launch failed: CUDA error {rc}")
    mlat_nodes.launches += 1
    if int(overflow):
        raise StackOverflowError(f"a ray's traversal stack passed {max_stack} entries")
    if stats is not None:
        stats.copy_(counts)
    if warp_visits is not None:
        warp_visits.copy_(warps)
    out = out.reshape(5, K, R)
    return out[0], out[1:4], out[4]


mlat_nodes.launches = 0
