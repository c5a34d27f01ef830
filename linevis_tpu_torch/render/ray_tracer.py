"""Ray-traced transparent tubes through the wavefront BVH kernel.

Counterpart of `linevis_tpu/render/ray_tracer.py` (the reference's hardware
ray tracer, `src/Renderers/RayTracing/VulkanRayTracer.*`, with the analytic
linear-swept-sphere / capsule geometry of `VulkanRayTracer.hpp:53-63`). The
BLAS/TLAS role is a binary BVH over per-segment capsule AABBs
(`build_capsule_bvh`, any of the four builders of `ops/lbvh.py`), collapsed
into 8-wide groups (`build_wide_capsule_bvh`);
`render_tubes_raytraced_wavefront` traces one primary ray per pixel through
it with `kernels/bvh_wavefront.py` and resolves the K nodes per pixel like
the raster OIT path.

The closest-hit re-cast loop (`render_tubes_raytraced`) and the MLAT variant
(`render_tubes_mlat`) are not ported yet (ROADMAP queue A item 4).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from linevis_tpu_torch.kernels.bvh_wavefront import P, trace_wavefront_kbuffer
from linevis_tpu_torch.kernels.raster_capsule_oit import blend_front_to_back
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.ops import lbvh
from linevis_tpu_torch.ops.wide_bvh import pack_wide_bvh
from linevis_tpu_torch.render.oit import shade_deferred_nodes
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.tube_raster import CapsuleScene, _ray_basis

__all__ = [
    "build_capsule_bvh", "build_wide_capsule_bvh", "primary_rays",
    "render_tubes_raytraced_wavefront", "resolve_wavefront_nodes",
]

_HOST_BUILDERS = {
    "binned_sah": lbvh.build_bvh_sah,
    "sweep_sah": lbvh.build_bvh_sweep_sah,
    "ploc": lbvh.build_bvh_ploc,
}


def build_capsule_bvh(scene: CapsuleScene, builder: str = "linear") -> lbvh.Lbvh:
    """BVH over per-segment capsule AABBs. Masked-out segments get
    degenerate boxes at 1e7, where no ray reaches them.

    `builder`: "linear" (Morton radix tree, on the scene's device) or one of
    the host-side quality builders "binned_sah" | "sweep_sah" | "ploc". The
    linear builder normalizes centroids by the bounds of all boxes, the
    parked ones included: with any masked segment every real centroid
    quantizes to Morton code 0 and the tree is split by segment index alone.
    """
    r = scene.radius
    a = scene.a
    b = scene.a + scene.ba
    far = torch.full_like(a, 1e7)
    lo = torch.where(scene.mask[None], torch.minimum(a, b) - r, far).T
    hi = torch.where(scene.mask[None], torch.maximum(a, b) + r, far).T
    if builder in _HOST_BUILDERS:
        return _HOST_BUILDERS[builder](lo.cpu().numpy(), hi.cpu().numpy())
    if builder != "linear":
        raise ValueError(f"unknown BVH builder {builder!r}")
    return lbvh.build_lbvh(lo.contiguous(), hi.contiguous())


def build_wide_capsule_bvh(scene: CapsuleScene, builder: str = "linear",
                           timings: Optional[dict] = None) -> torch.Tensor:
    """The capsule BVH packed for the wavefront kernel: the groups tensor
    [n_groups * 8, 128] on the scene's device (see `ops/wide_bvh.py`).
    Scene-build-time and camera-independent: build once, reuse across
    frames. `timings`, an optional dict, receives the host seconds of the
    binary build ("build_s") and of the collapse ("pack_s")."""
    t0 = time.perf_counter()
    bvh = build_capsule_bvh(scene, builder=builder).numpy()
    t1 = time.perf_counter()
    wide = pack_wide_bvh(
        bvh, scene.a.cpu().numpy(), scene.ba.cpu().numpy(), float(scene.radius),
        scene.attr0.cpu().numpy(), scene.dattr.cpu().numpy(), scene.cap_a.cpu().numpy(),
    )
    if timings is not None:
        timings.update(build_s=t1 - t0, pack_s=time.perf_counter() - t1)
    return torch.from_numpy(wide.groups).to(scene.a.device)


def primary_rays(view_proj, camera_position, settings: RasterSettings, t_max: float):
    """One ray per pixel, tile-major (tile_w x tile_h = 128 rays per ray
    block, so ray blocks are screen tiles) -> [8, n_tiles * 128]: origin,
    direction with unit forward component, t_max, valid = 1."""
    W, H = settings.width, settings.height
    tw_, th_ = settings.tile_w, settings.tile_h
    dev = view_proj.device
    basis = _ray_basis(view_proj)
    tiles_x = -(-W // tw_)
    n_tiles = tiles_x * -(-H // th_)
    lin = torch.arange(P, device=dev)
    tid = torch.arange(n_tiles, device=dev)
    gx = ((tid % tiles_x)[:, None] * tw_ + (lin % tw_)[None, :]).float() + 0.5  # [T, P]
    gy = ((tid // tiles_x)[:, None] * th_ + (lin // tw_)[None, :]).float() + 0.5
    un = gx * (2.0 / W) - 1.0
    vn = 1.0 - gy * (2.0 / H)
    d = (
        basis[:, 0][:, None, None] * un[None]
        + basis[:, 1][:, None, None] * vn[None]
        + basis[:, 2][:, None, None]
    )
    R = n_tiles * P
    return torch.cat([
        camera_position[:, None].expand(3, R),
        d.reshape(3, R),
        torch.full((1, R), t_max, dtype=torch.float32, device=dev),
        torch.ones((1, R), dtype=torch.float32, device=dev),
    ])


def render_tubes_raytraced_wavefront(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    K: int = 8,
    opacity: float = 0.3,
    wide_groups: Optional[torch.Tensor] = None,  # build_wide_capsule_bvh output
    t_max: float = 1e6,
) -> torch.Tensor:
    """Ray-traced transparency through the wavefront kernel -> [4, H, W]
    linear RGBA on the scene's device: one shared-stack 8-wide BVH traversal
    per 128-ray screen tile, K nearest nodes per pixel with deferred-shading
    features, resolved by `shade_deferred_nodes` and blended front to back
    (the TubeRayTracing.glsl:61-82 + MlatInsert.glsl role)."""
    tw_, th_ = settings.tile_w, settings.tile_h
    if tw_ * th_ != P:
        raise ValueError(
            f"wavefront blocks are {P} rays: need tile_w*tile_h == {P}, got {tw_}x{th_}"
        )
    if wide_groups is None:
        wide_groups = build_wide_capsule_bvh(scene)
    rays = primary_rays(view_proj, camera_position, settings, t_max)
    nodes = trace_wavefront_kbuffer(
        wide_groups, rays, proj_ab, K=K, opacity=opacity,
        tf_opacity=settings.tf_opacity,
    )
    return resolve_wavefront_nodes(scene, nodes, view_proj, proj_ab, settings)


def resolve_wavefront_nodes(scene, nodes, view_proj, proj_ab, settings: RasterSettings):
    """Shade the kernel's K nodes per ray (`shade_deferred_nodes`), blend
    them front to back over the background and untile -> [4, H, W]."""
    depths, feat, alpha = nodes
    W, H = settings.width, settings.height
    tw_, th_ = settings.tile_w, settings.tile_h
    # Depth-cue range: the same reduction as the raster OIT path's.
    w_all = view_proj[3, :3] @ scene.a + view_proj[3, 3]
    big = torch.full_like(w_all, 3e38)
    dmin = torch.min(torch.where(scene.mask, w_all, big))
    dmax = torch.max(torch.where(scene.mask, w_all, -big))
    col = shade_deferred_nodes(
        depths, feat, alpha, proj_ab, dmin, dmax, settings.depth_cue_strength, settings
    )
    bg = torch.tensor(settings.background_color[:3], dtype=torch.float32, device=alpha.device)
    out = blend_front_to_back(col, alpha, bg)
    tiles_x, tiles_y = -(-W // tw_), -(-H // th_)
    return torch.stack([
        unpack_tiles(out[c], tiles_x, tiles_y, tw_, th_, W, H) for c in range(4)
    ])
