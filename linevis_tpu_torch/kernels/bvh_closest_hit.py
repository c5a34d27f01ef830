"""The transparent ray tracer's closest hit over the binary BVH (kernel R1).

`capsule_closest_hit` is one cast of `render/ray_tracer.py:trace_recast`'s
loop: each ray's next surface strictly after the last one in (t, prim)
order. `recast_launch` launches the whole loop in one kernel (the clip, the
tie-window join, the shading and the front-to-back blend too) for
`render/ray_tracer.py:capsule_recast`. The JAX package writes the loop as
the vmapped `fori_loop` of `linevis_tpu/render/ray_tracer.py:271`
(`trace_one`), each cast `ray_query` (`linevis_tpu/ops/lbvh.py:211`, a
vmapped `lax.while_loop`) with the leaf function of
`linevis_tpu/render/ray_tracer.py:147`; it reaches no `pl.pallas_call`.

On a CUDA tensor `capsule_closest_hit` launches its hand-written kernel in
`csrc/bvh_closest_hit.cu` (each warp walks the tree together over
`ops.lbvh.packed_nodes`); on a CPU tensor it runs its plain version,
`capsule_closest_hit_reference`: the lockstep `ops.lbvh.ray_query` with
`capsule_common.capsule_surfaces` at the leaves. Kernel and plain version
walk every ray's nodes in the same order and round every operation alike,
so every cast's (t, prim) agrees bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.capsule_common import capsule_surfaces
from linevis_tpu_torch.kernels.raster_capsule_oit import tf_table
from linevis_tpu_torch.ops.lbvh import (
    Lbvh, StackOverflowError, packed_nodes, packed_wide_nodes, ray_query,
)

__all__ = [
    "capsule_closest_hit", "capsule_closest_hit_reference", "capsule_hit_fn", "recast_launch",
    "traversal_counts", "walk_records", "MAX_STACK",
]

MAX_STACK = 64  # node ids a ray's stack holds (the JAX default)


def capsule_hit_fn(scene):
    """Leaf function of the enumerate mode of `ray_query` on a capsule
    scene: the nearer of the entry and exit surface strictly after
    (t_min, prim_min) in (t, prim) order."""
    def hit(prim, o, d, t_min, prim_min):
        def accept(tp):
            return (tp > t_min) | ((tp == t_min) & (prim > prim_min))

        t_in, t_out = capsule_surfaces(scene, prim, o, d, accept)
        return torch.minimum(t_in, t_out)

    return hit


def capsule_closest_hit_reference(tree: Lbvh, scene, origins, dirs, t_min, prim_min, done,
                                  max_stack: int = MAX_STACK, stats=None):
    """Plain PyTorch version of the kernel (same contract as
    `capsule_closest_hit`)."""
    return ray_query(tree, origins, dirs, prim_hit_fn=capsule_hit_fn(scene), max_stack=max_stack,
                     t_min=t_min, prim_min=prim_min, done=done, stats=stats)


def _launcher(name):
    """A kernel's C entry point (built and loaded at first use), with its
    argument types declared so ctypes passes 64-bit pointers."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "closest_hit":
        fn = _build.load("bvh_closest_hit").bvh_closest_hit_launch
        fn.argtypes = [p, i, p, p, p, p, i, f, p, p, p, p, p, i, i, i, p, p, p, p, p, p]
    else:
        fn = _build.load("bvh_closest_hit").bvh_recast_launch
        fn.argtypes = [p, i, p, p, p, p, p, p, i, f, f, p, p, p, p, i, i, i, f, f, f, f, f, f,
                       p, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(dev, R, tensors):
    """Raise unless each (name, tensor, dtype, shape) matches on `dev`."""
    for name, x, dtype, shape in tensors:
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}")


def _scene_args(scene, dev, features):
    """The scene's channels the kernels read (`features`: also the
    attribute rows), contiguous on `dev`."""
    seg = [scene.a.float().contiguous(), scene.ba.float().contiguous(),
           scene.cap_a.float().contiguous(), scene.mask.contiguous()]
    if features:
        seg += [scene.attr0.float().contiguous(), scene.dattr.float().contiguous()]
    if any(x.device != dev for x in seg):
        raise ValueError("the scene must lie on the rays' device")
    return seg


def traversal_counts(stats, warp_visits, R, dev, n_stats):
    """int32 buffers for a traversal kernel's optional counts (None where
    not asked): [R, n_stats] per ray, [ceil(R / 32)] per warp."""
    counts = (None if stats is None
              else torch.empty((R, n_stats), dtype=torch.int32, device=dev))
    warps = (None if warp_visits is None
             else torch.empty(-(-R // 32), dtype=torch.int32, device=dev))
    if warps is not None and tuple(warp_visits.shape) != tuple(warps.shape):
        raise ValueError(f"warp_visits must have shape {tuple(warps.shape)}")
    return counts, warps


def _ptr(x):
    return None if x is None else x.data_ptr()


def walk_records(tree, dev, max_stack):
    """The tree's `node_records` on `dev` and the binary walk's shared
    stack entries for `max_stack`."""
    nodes, depth = packed_nodes(tree, dev)
    return nodes, max(1, min(depth, max_stack - 1))


def capsule_closest_hit(
    tree: Lbvh,  # binary BVH over the scene's capsules (`lbvh_on` form on the card)
    scene,  # CapsuleScene
    origins: torch.Tensor,  # [R, 3]
    dirs: torch.Tensor,  # [R, 3] unit
    t_min: torch.Tensor,  # [R] float32
    prim_min: torch.Tensor,  # [R] int32
    done: torch.Tensor,  # [R] bool: rays that query nothing
    max_stack: int = MAX_STACK,
    stats: Optional[torch.Tensor] = None,
    overflow: Optional[torch.Tensor] = None,
    warp_visits: Optional[torch.Tensor] = None,
):
    """-> (t [R] float32, prim [R] int32): each ray's capsule surface
    strictly after (t_min, prim_min) in (t, prim) order, ties on t to the
    smaller id; (inf, -1) on a miss and for rays flagged done.

    A CUDA tensor launches the CUDA kernel (counted in
    `capsule_closest_hit.launches`); a CPU tensor runs the plain version.
    `stats`, an optional [R, 2] int64 tensor, receives each ray's node
    visits and leaf tests. `warp_visits`, an optional [ceil(R / 32)] int64
    tensor, receives the nodes each warp of 32 rays tested in the kernel's
    shared walk (the kernel alone has it: a CPU tensor raises). A push past
    `max_stack` (<= 64) raises StackOverflowError: the plain version at
    once, the kernel after a synchronize, or, when the caller passes an
    int32 `overflow` counter, whenever the caller checks it (the counter
    gains the rays that overflowed)."""
    if not 1 <= max_stack <= MAX_STACK:
        raise ValueError(f"max_stack={max_stack}: need 1 <= max_stack <= {MAX_STACK}")
    if origins.device.type == "cpu":
        if warp_visits is not None:
            raise ValueError("warp_visits counts the kernel's shared walk: a CUDA reading")
        return capsule_closest_hit_reference(tree, scene, origins, dirs, t_min, prim_min, done,
                                             max_stack, stats)
    if origins.device.type != "cuda":
        raise ValueError(f"capsule_closest_hit: unsupported device {origins.device}")
    dev = origins.device
    R = origins.shape[0]
    _check(dev, R, (
        ("origins", origins, torch.float32, (R, 3)), ("dirs", dirs, torch.float32, (R, 3)),
        ("t_min", t_min, torch.float32, (R,)), ("prim_min", prim_min, torch.int32, (R,)),
        ("done", done, torch.bool, (R,)),
    ))
    seg = _scene_args(scene, dev, features=False)
    nodes, cap = walk_records(tree, dev, max_stack)
    ins = [x.contiguous() for x in (origins, dirs, t_min, prim_min, done)]
    t_out = torch.empty(R, dtype=torch.float32, device=dev)
    prim_out = torch.empty(R, dtype=torch.int32, device=dev)
    counts, warps = traversal_counts(stats, warp_visits, R, dev, 2)
    flag = overflow if overflow is not None else torch.zeros(1, dtype=torch.int32, device=dev)
    if flag.dtype != torch.int32 or flag.device != dev:
        raise ValueError("overflow must be an int32 tensor on the rays' device")
    r32 = np.float32(scene.radius)
    with torch.cuda.device(dev):
        rc = _launcher("closest_hit")(
            nodes.data_ptr(), tree.leaf_prim.shape[0], *(x.data_ptr() for x in seg),
            scene.a.shape[1], float(r32 * r32), *(x.data_ptr() for x in ins), R, max_stack, cap,
            t_out.data_ptr(), prim_out.data_ptr(), _ptr(counts), _ptr(warps), flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh_closest_hit kernel launch failed: CUDA error {rc}")
    capsule_closest_hit.launches += 1
    if overflow is None and int(flag):
        raise StackOverflowError(f"a ray's traversal stack passed {max_stack} entries")
    if stats is not None:
        stats.copy_(counts)
    if warp_visits is not None:
        warp_visits.copy_(warps)
    return t_out, prim_out


capsule_closest_hit.launches = 0


def recast_launch(tree: Lbvh, scene, origins, dirs, wz, pad, proj_ab, settings, casts: int,
                  opacity: float, dmin, dmax, max_stack: int = MAX_STACK,
                  record: Optional[tuple] = None, warp_visits: Optional[torch.Tensor] = None):
    """Launch the re-cast loop kernel on CUDA tensors -> (color [3, R],
    transmittance [R]): the card side of `render/ray_tracer.py:
    capsule_recast`, which documents the arguments and counts the launches.

    The kernel walks the tree collapsed two levels at a time
    (`ops.lbvh.packed_wide_nodes`), which cannot count a ray's own pushes:
    a tree with a path on which a ray's stack could pass `max_stack` raises
    StackOverflowError before any launch; on any other tree no ray's stack
    can."""
    if origins.device.type != "cuda":
        raise ValueError(f"recast_launch: unsupported device {origins.device}")
    dev = origins.device
    R = origins.shape[0]
    _check(dev, R, (
        ("origins", origins, torch.float32, (R, 3)), ("dirs", dirs, torch.float32, (R, 3)),
        ("wz", wz, torch.float32, (R,)), ("pad", pad, torch.bool, (R,)),
    ))
    if record is not None:
        _check(dev, R, (("record t", record[0], torch.float32, (casts, R)),
                        ("record prim", record[1], torch.int32, (casts, R))))
    seg = _scene_args(scene, dev, features=True)
    # A ray's own stack holds an internal node's right-depth (at most
    # walk_stack_depth - 1) and the push's 2 above it.
    depth = packed_nodes(tree, dev)[1]
    nodes, cap = packed_wide_nodes(tree, dev)
    if depth + 1 > max_stack or cap > MAX_STACK:
        raise StackOverflowError(
            f"the loop kernel takes trees whose walks need at most max_stack={max_stack} "
            f"entries (of at most {MAX_STACK} collapsed): this one needs {depth + 1} "
            f"({cap} collapsed)")
    ins = [x.contiguous() for x in (origins, dirs, wz, pad)]
    ab = proj_ab.float().cpu().numpy()
    tf = tf_table(settings.tf_color, settings.tf_opacity, dev)
    acc = torch.empty((3, R), dtype=torch.float32, device=dev)
    T = torch.empty(R, dtype=torch.float32, device=dev)
    _, warps = traversal_counts(None, warp_visits, R, dev, 0)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    r32 = np.float32(scene.radius)
    with torch.cuda.device(dev):
        rc = _launcher("recast")(
            nodes.data_ptr(), nodes.shape[0] - 1, *(x.data_ptr() for x in seg),
            scene.a.shape[1], float(r32 * r32), float(r32), *(x.data_ptr() for x in ins), R,
            casts, cap, float(ab[0]), float(ab[1]), float(np.float32(opacity)), float(dmin),
            float(dmax), float(np.float32(settings.depth_cue_strength)), tf.data_ptr(),
            acc.data_ptr(), T.data_ptr(), None if record is None else record[0].data_ptr(),
            None if record is None else record[1].data_ptr(), _ptr(warps),
            overflow.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh_recast kernel launch failed: CUDA error {rc}")
    if int(overflow):
        raise StackOverflowError("the loop kernel's shared stack passed its tree's depth")
    if warp_visits is not None:
        warp_visits.copy_(warps)
    return acc, T
