"""Closest capsule hit in enumerate mode over the binary BVH (kernel R1).

One step of the transparent ray tracer's re-cast loop
(`render/ray_tracer.py:render_tubes_raytraced`): per ray, the capsule surface
strictly after (t_min, prim_min) in (t, prim) order. The JAX package writes
it as `ray_query` (`linevis_tpu/ops/lbvh.py:211`, a vmapped
`lax.while_loop`) with the leaf function of
`linevis_tpu/render/ray_tracer.py:147`; it reaches no `pl.pallas_call`.

On a CUDA tensor `capsule_closest_hit` launches the hand-written kernel
`csrc/bvh_closest_hit.cu` (one thread per ray); on a CPU tensor it runs
`capsule_closest_hit_reference`, the same function in plain PyTorch: the
lockstep `ops.lbvh.ray_query` with `capsule_common.capsule_surfaces` at the
leaves. Both walk every ray's nodes in the same order and round every
operation alike, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.capsule_common import capsule_surfaces
from linevis_tpu_torch.ops.lbvh import Lbvh, StackOverflowError, lbvh_on, ray_query

__all__ = [
    "capsule_closest_hit", "capsule_closest_hit_reference", "capsule_hit_fn", "MAX_STACK",
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


def _launcher():
    """The kernel's C entry point (built and loaded at first use), with its
    argument types declared so ctypes passes 64-bit pointers."""
    fn = _build.load("bvh_closest_hit").bvh_closest_hit_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, i, p, p, p, p, i, f, p, p, p, p, p, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


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
):
    """-> (t [R] float32, prim [R] int32): each ray's capsule surface
    strictly after (t_min, prim_min) in (t, prim) order, ties on t to the
    smaller id; (inf, -1) on a miss and for rays flagged done.

    A CUDA tensor launches the CUDA kernel (counted in
    `capsule_closest_hit.launches`); a CPU tensor runs the plain version.
    `stats`, an optional [R, 2] int64 tensor, receives each ray's node
    visits and leaf tests. A push past `max_stack` (<= 64) raises
    StackOverflowError: the plain version at once, the kernel after a
    synchronize, or, when the caller passes an int32 `overflow` counter,
    whenever the caller checks it (the counter gains the rays that
    overflowed)."""
    if not 1 <= max_stack <= MAX_STACK:
        raise ValueError(f"max_stack={max_stack}: need 1 <= max_stack <= {MAX_STACK}")
    if origins.device.type == "cpu":
        return capsule_closest_hit_reference(tree, scene, origins, dirs, t_min, prim_min, done,
                                             max_stack, stats)
    if origins.device.type != "cuda":
        raise ValueError(f"capsule_closest_hit: unsupported device {origins.device}")
    dev = origins.device
    tree = lbvh_on(tree, dev)
    R = origins.shape[0]
    for name, x, dtype, shape in (
        ("origins", origins, torch.float32, (R, 3)), ("dirs", dirs, torch.float32, (R, 3)),
        ("t_min", t_min, torch.float32, (R,)), ("prim_min", prim_min, torch.int32, (R,)),
        ("done", done, torch.bool, (R,)),
    ):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}")
    seg = [scene.a.float().contiguous(), scene.ba.float().contiguous(),
           scene.cap_a.float().contiguous(), scene.mask.contiguous()]
    if any(x.device != dev for x in seg):
        raise ValueError("the scene must lie on the rays' device")
    ins = [x.contiguous() for x in (origins, dirs, t_min, prim_min, done)]
    t_out = torch.empty(R, dtype=torch.float32, device=dev)
    prim_out = torch.empty(R, dtype=torch.int32, device=dev)
    counts = None if stats is None else torch.empty((R, 2), dtype=torch.int32, device=dev)
    flag = overflow if overflow is not None else torch.zeros(1, dtype=torch.int32, device=dev)
    if flag.dtype != torch.int32 or flag.device != dev:
        raise ValueError("overflow must be an int32 tensor on the rays' device")
    r32 = np.float32(scene.radius)
    with torch.cuda.device(dev):
        rc = _launcher()(
            tree.left.data_ptr(), tree.right.data_ptr(), tree.node_min.data_ptr(),
            tree.node_max.data_ptr(), tree.leaf_prim.data_ptr(), tree.leaf_prim.shape[0],
            *(x.data_ptr() for x in seg), scene.a.shape[1], float(r32 * r32),
            *(x.data_ptr() for x in ins), R, max_stack, t_out.data_ptr(), prim_out.data_ptr(),
            None if counts is None else counts.data_ptr(), flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh_closest_hit kernel launch failed: CUDA error {rc}")
    capsule_closest_hit.launches += 1
    if overflow is None and int(flag):
        raise StackOverflowError(f"a ray's traversal stack passed {max_stack} entries")
    if stats is not None:
        stats.copy_(counts)
    return t_out, prim_out


capsule_closest_hit.launches = 0
