"""Ray-traced transparent tubes: the re-cast loop, MLAT and the wavefront path.

Counterpart of `linevis_tpu/render/ray_tracer.py` (the reference's hardware
ray tracer, `src/Renderers/RayTracing/VulkanRayTracer.*`, with the analytic
linear-swept-sphere / capsule geometry of `VulkanRayTracer.hpp:53-63`). The
BLAS/TLAS role is a binary BVH over per-segment capsule AABBs
(`build_capsule_bvh`, any of the four builders of `ops/lbvh.py`).
- `render_tubes_raytraced`: the iterative re-cast loop
  (`TubeRayTracing.glsl:61-82`). Each of `max_depth_complexity` casts asks
  every ray for its next surface strictly after the last one in (t, prim)
  order and blends coincident surfaces as one group, front to back
  (`trace_recast`; `capsule_recast` runs the whole loop in one launch of
  the kernel of `kernels/bvh_closest_hit.py` on the card).
- `render_tubes_mlat`: multi-layer alpha tracing, one walk per ray into K
  nodes (`kernels/bvh_mlat.py`), resolved front to back.
- `render_tubes_raytraced_wavefront`: the tree collapsed into 8-wide groups
  (`build_wide_capsule_bvh`) and traced per 128-ray screen tile with
  `kernels/bvh_wavefront.py`.
The first two take their primary rays in 16x8 screen-tile order
(`tile_rays`), so that a block of 128 rays of a kernel is one tile; their
per-ray state lives in that order and the image is untiled at the end.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels.bvh_closest_hit import (
    MAX_STACK, capsule_closest_hit, capsule_closest_hit_reference, recast_launch,
)
from linevis_tpu_torch.kernels.bvh_mlat import mlat_nodes
from linevis_tpu_torch.kernels.bvh_wavefront import P, trace_wavefront_kbuffer
from linevis_tpu_torch.kernels.capsule_common import capsule_features
from linevis_tpu_torch.kernels.raster_capsule_oit import blend_front_to_back
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.ops import lbvh
from linevis_tpu_torch.ops.wide_bvh import pack_wide_bvh
from linevis_tpu_torch.render.oit import shade_deferred_nodes
from linevis_tpu_torch.ops.lbvh import StackOverflowError, lbvh_on
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import tf_channels_static
from linevis_tpu_torch.render.tube_raster import CapsuleScene, _ray_basis

__all__ = [
    "build_capsule_bvh", "build_wide_capsule_bvh", "primary_rays",
    "render_tubes_raytraced_wavefront", "resolve_wavefront_nodes",
    "tile_rays", "trace_recast", "capsule_recast", "render_tubes_raytraced", "resolve_mlat_nodes",
    "render_tubes_mlat", "RT_TILE",
]

RT_TILE = (16, 8)  # the screen tile of a 128-ray block of the per-ray kernels

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
    dmin, dmax = _depth_cue_range(scene, view_proj)
    col = shade_deferred_nodes(
        depths, feat, alpha, proj_ab, dmin, dmax, settings.depth_cue_strength, settings
    )
    bg = torch.tensor(settings.background_color[:3], dtype=torch.float32, device=alpha.device)
    out = blend_front_to_back(col, alpha, bg)
    tiles_x, tiles_y = -(-W // tw_), -(-H // th_)
    return torch.stack([
        unpack_tiles(out[c], tiles_x, tiles_y, tw_, th_, W, H) for c in range(4)
    ])


def tile_rays(view_proj, camera_position, settings: RasterSettings, jitter=None):
    """Unit primary rays through the pixel centers (+ `jitter` [2] pixels),
    in 16x8 screen-tile order -> (origins [R, 3], dirs [R, 3], wz [R] view
    depth per unit t, pad [R] bool: the tile pixels outside the image)."""
    W, H = settings.width, settings.height
    tw, th = RT_TILE
    dev = view_proj.device
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    lin = torch.arange(tw * th, device=dev)
    tid = torch.arange(tiles_x * tiles_y, device=dev)
    px = ((tid % tiles_x)[:, None] * tw + (lin % tw)[None, :]).reshape(-1)
    py = ((tid // tiles_x)[:, None] * th + (lin // tw)[None, :]).reshape(-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    jx, jy = (zero, zero) if jitter is None else (jitter[0], jitter[1])
    u = (px.float() + 0.5 + jx) * (2.0 / W) - 1.0
    v = 1.0 - (py.float() + 0.5 + jy) * (2.0 / H)
    basis = _ray_basis(view_proj)
    d = [basis[i, 0] * u + basis[i, 1] * v + basis[i, 2] for i in range(3)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dirs = torch.stack([d[0] / n, d[1] / n, d[2] / n], dim=1)
    fwd = view_proj[3, :3]
    wz = dirs[:, 0] * fwd[0] + dirs[:, 1] * fwd[1] + dirs[:, 2] * fwd[2]
    origins = camera_position[None, :].expand(dirs.shape[0], 3).contiguous()
    return origins, dirs, wz, (px >= W) | (py >= H)


def _depth_cue_range(scene, view_proj):
    """(min, max) view depth of the valid segments' start points (the
    raster OIT path's depth-cue range)."""
    w_all = view_proj[3, :3] @ scene.a + view_proj[3, 3]
    big = torch.full_like(w_all, 3e38)
    return (torch.min(torch.where(scene.mask, w_all, big)),
            torch.max(torch.where(scene.mask, w_all, -big)))


def _shade(attr, cos1, cos2, vz, dmin, dmax, settings: RasterSettings):
    """TF color, Blinn-Phong of the (averaged) node features and depth cue
    at view depth vz (`render/oit.py:shade_deferred_nodes`' formula)."""
    cos1 = torch.clamp(cos1, min=1e-20)
    cos2 = torch.clamp(cos2, min=1e-20)
    cosc = 0.3 * cos1 ** 1.7 + 0.7 * cos2 ** 1.7
    spec = 0.3 * cos1 ** 30.0
    rgb = torch.stack(tf_channels_static(settings.tf_color, 3, attr))
    col = rgb * (0.1 + 0.9 * cosc) + spec
    fcue = torch.clamp((vz - dmin) / torch.clamp(dmax - dmin, min=1e-6), 0.0, 1.0)
    fcue = fcue * fcue * settings.depth_cue_strength
    return col * (1.0 - fcue) + 0.5 * fcue


def _image(acc, T, settings: RasterSettings):
    """Tile-ordered accumulated color [3, R] and transmittance [R] over the
    background -> [4, H, W] linear RGBA."""
    W, H = settings.width, settings.height
    tw, th = RT_TILE
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    bg = torch.tensor(settings.background_color[:3], dtype=torch.float32, device=T.device)
    out = torch.cat([acc + T[None] * bg[:, None], (1.0 - T)[None]])
    return torch.stack([unpack_tiles(out[c].reshape(-1, tw * th), tiles_x, tiles_y, tw, th,
                                     W, H) for c in range(4)])


def trace_recast(tree, scene, origins, dirs, wz, pad, proj_ab, settings: RasterSettings,
                 max_depth_complexity: int, opacity: float, dmin, dmax, closest_hit=None):
    """The re-cast loop over rays [R] -> (color [3, R], transmittance [R]).

    Each cast asks every ray for its next surface strictly after the last
    one (`closest_hit`; None: `capsule_closest_hit`, whose stack overflows
    are checked once after the loop). A surface outside the NDC clip volume
    is skipped; one within the relative 1e-6 tie window of the pending
    group joins it (its features and alpha are averaged before shading, the
    raster's joint-cap dedup); otherwise the pending group is shaded and
    blended front to back. A ray is done at a miss or once its
    transmittance falls below 1e-4; done rays keep their state. Every cast
    runs for every ray (the JAX function's `fori_loop`)."""
    R = dirs.shape[0]
    dev = dirs.device
    zA, zB = proj_ab[0], proj_ab[1]
    overflow = None
    if closest_hit is None:
        overflow = torch.zeros(1, dtype=torch.int32, device=dev) if dev.type == "cuda" else None

        def closest_hit(*args):
            return capsule_closest_hit(*args, overflow=overflow)

    def flush(g, T, acc):
        g_t0, g_attr, g_c1, g_c2, g_a, g_n = g
        nn = torch.clamp(g_n, min=1.0)
        col = _shade(g_attr / nn, g_c1 / nn, g_c2 / nn, g_t0 * wz, dmin, dmax, settings)
        a_m = g_a / nn
        has = g_n > 0.0
        return (torch.where(has[None], acc + (T * a_m)[None] * col, acc),
                torch.where(has, T * (1.0 - a_m), T))

    zeros = torch.zeros(R, dtype=torch.float32, device=dev)
    t_last = zeros
    p_last = torch.full((R,), np.iinfo(np.int32).max, dtype=torch.int32, device=dev)
    g = (zeros,) * 6
    T = torch.ones(R, dtype=torch.float32, device=dev)
    acc = torch.zeros((3, R), dtype=torch.float32, device=dev)
    done = pad.clone()
    for _ in range(max_depth_complexity):
        t, prim = closest_hit(tree, scene, origins, dirs, t_last, p_last, done)
        miss = (prim < 0) | done
        znd = zA - zB / torch.clamp(t * wz, min=1e-12)
        clipped = ~miss & ((znd < 0.0) | (znd > 1.0))
        attr, c1, c2, al = capsule_features(scene, torch.clamp(prim, min=0).long(), origins,
                                            dirs, t, settings.tf_opacity, opacity)
        g_t0, g_attr, g_c1, g_c2, g_a, g_n = g
        ok = ~miss & ~clipped
        join = ok & (g_n > 0.0) & (t <= g_t0 + torch.abs(g_t0) * 1e-6)
        new_frag = ok & ~join
        do_flush = (g_n > 0.0) & (miss | new_frag)
        acc_f, T_f = flush(g, T, acc)
        acc = torch.where(do_flush[None], acc_f, acc)
        T = torch.where(do_flush, T_f, T)

        def upd(cur, add):
            return torch.where(join, cur + add,
                               torch.where(new_frag, add, torch.where(miss, 0.0, cur)))

        g = (torch.where(new_frag, t, torch.where(miss, 0.0, g_t0)), upd(g_attr, attr),
             upd(g_c1, c1), upd(g_c2, c2), upd(g_a, al), upd(g_n, torch.ones_like(g_n)))
        done = miss | (T < 1e-4)
        t_last = torch.where(miss, t_last, t)
        p_last = torch.where(miss, p_last, prim)
    acc, T = flush(g, T, acc)  # the pending tail group
    if overflow is not None and int(overflow):
        raise StackOverflowError("a ray's traversal stack passed its capacity")
    return acc, T


def capsule_recast(
    tree,  # binary BVH over the scene's capsules
    scene: CapsuleScene,
    origins: torch.Tensor,  # [R, 3]
    dirs: torch.Tensor,  # [R, 3] unit
    wz: torch.Tensor,  # [R] view depth per unit t along the ray
    pad: torch.Tensor,  # [R] bool: rays that trace nothing
    proj_ab: torch.Tensor,  # [2] = (zA, zB): z_ndc = zA - zB / view_z
    settings: RasterSettings,  # the TFs and the depth cue's strength
    max_depth_complexity: int,  # casts
    opacity: float,
    dmin,  # the depth cue's view-depth range (`_depth_cue_range`)
    dmax,
    max_stack: int = MAX_STACK,
    record: Optional[tuple] = None,
    warp_visits: Optional[torch.Tensor] = None,
):
    """`trace_recast`'s function over rays [R] -> (color [3, R]
    premultiplied, transmittance [R]), the whole loop in one kernel (R1).

    A CUDA tensor launches `csrc/bvh_closest_hit.cu`'s loop kernel once
    (`kernels/bvh_closest_hit.py:recast_launch`, counted in
    `capsule_recast.launches`); a CPU tensor runs the plain version,
    `trace_recast` with `capsule_closest_hit_reference` as its closest hit.
    `record`, an optional pair of [casts, R] tensors (float32 t, int32
    prim), receives every cast's (t, prim), (inf, -1) for rays that are
    done. `warp_visits` ([ceil(R / 32)] int64, the kernel alone) receives
    the nodes each warp tested. A ray's push past `max_stack` (<= 64)
    raises StackOverflowError: the plain version where a ray's walk does,
    the kernel before its launch where a path of the tree would allow it."""
    if not 1 <= max_stack <= MAX_STACK:
        raise ValueError(f"max_stack={max_stack}: need 1 <= max_stack <= {MAX_STACK}")
    casts = int(max_depth_complexity)
    if origins.device.type != "cpu":
        acc, T = recast_launch(tree, scene, origins, dirs, wz, pad, proj_ab, settings, casts,
                               opacity, dmin, dmax, max_stack, record, warp_visits)
        capsule_recast.launches += 1
        return acc, T
    if warp_visits is not None:
        raise ValueError("warp_visits counts the kernel's shared walk: a CUDA reading")
    k = [0]

    def hit(*args):
        t, prim = capsule_closest_hit_reference(*args, max_stack=max_stack)
        if record is not None:
            record[0][k[0]], record[1][k[0]] = t, prim
        k[0] += 1
        return t, prim

    return trace_recast(tree, scene, origins, dirs, wz, pad, proj_ab, settings, casts, opacity,
                        dmin, dmax, closest_hit=hit)


capsule_recast.launches = 0


def render_tubes_raytraced(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,  # [2] = (A, Bc): z_ndc = A - Bc / view_z
    settings: RasterSettings,
    max_depth_complexity: int = 32,
    opacity: float = 0.3,
    bvh=None,
    jitter: Optional[torch.Tensor] = None,  # [2] subpixel offset in pixels
) -> torch.Tensor:
    """Transparent tubes by iterative closest-hit re-querying
    (TubeRayTracing.glsl:61-82) -> [4, H, W] linear RGBA on the scene's
    device.

    Blends every surface along each ray front to back, up to
    `max_depth_complexity` surfaces: no K-node bound, no overflow merge.
    Surfaces are enumerated in exact (t, prim) order from the fixed camera
    origin, coincident ones (the raster's relative 1e-6 window) are averaged
    before shading, and fragments outside the NDC clip volume are culled, so
    it agrees with the MLAB raster where the depth complexity is at most K.
    `bvh` is a tree of `build_capsule_bvh` (built here when None)."""
    if bvh is None:
        bvh = build_capsule_bvh(scene)
    tree = lbvh_on(bvh, scene.a.device)
    origins, dirs, wz, pad = tile_rays(view_proj, camera_position, settings, jitter)
    dmin, dmax = _depth_cue_range(scene, view_proj)
    acc, T = capsule_recast(tree, scene, origins, dirs, wz, pad, proj_ab, settings,
                            max_depth_complexity, opacity, dmin, dmax)
    return _image(acc, T, settings)


def resolve_mlat_nodes(nodes, wz, settings: RasterSettings, dmin, dmax):
    """Front-to-back blend of the K nodes per ray (their features averaged
    by alpha and shaded like `shade_deferred_nodes`) -> (color [3, R],
    transmittance [R])."""
    depth, feat, alpha = nodes
    T = torch.ones_like(wz)
    acc = torch.zeros((3,) + wz.shape, dtype=torch.float32, device=wz.device)
    for j in range(alpha.shape[0]):
        a_j = alpha[j]
        inv_a = torch.where(a_j > 1e-6, 1.0 / torch.clamp(a_j, min=1e-6), 0.0)
        vz = torch.where(torch.isfinite(depth[j]), depth[j], 0.0) * wz
        col = _shade(feat[0, j] * inv_a, feat[1, j] * inv_a, feat[2, j] * inv_a, vz, dmin,
                     dmax, settings)
        acc = acc + (T * a_j)[None] * col
        T = T * (1.0 - a_j)
    return acc, T


def render_tubes_mlat(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    K: int = 8,
    opacity: float = 0.3,
    bvh=None,
    max_stack: int = 64,
    jitter: Optional[torch.Tensor] = None,  # [2] subpixel offset in pixels
) -> torch.Tensor:
    """Multi-layer alpha tracing (TubeRayTracing.glsl:85-130 any-hit path +
    MlatInsert.glsl) -> [4, H, W] linear RGBA: one BVH walk per ray
    inserting the entry and exit surface of every capsule it reaches into K
    depth-sorted nodes (`kernels/bvh_mlat.py`), subtrees behind a saturated
    buffer culled, evictions merged into the last node; then the nodes are
    shaded and blended front to back. Exact sorted blending where the depth
    complexity is at most K; coincident joint surfaces are both inserted."""
    if bvh is None:
        bvh = build_capsule_bvh(scene)
    tree = lbvh_on(bvh, scene.a.device)
    origins, dirs, wz, pad = tile_rays(view_proj, camera_position, settings, jitter)
    nodes = mlat_nodes(tree, scene, origins, dirs, wz, pad, proj_ab, K=K, opacity=opacity,
                       tf_opacity=settings.tf_opacity, max_stack=max_stack)
    dmin, dmax = _depth_cue_range(scene, view_proj)
    acc, T = resolve_mlat_nodes(nodes, wz, settings, dmin, dmax)
    return _image(acc, T, settings)
