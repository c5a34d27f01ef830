"""Ray-traced ambient occlusion renderer.

Counterpart of `linevis_tpu/render/rtao.py`. Reference:
`src/Renderers/AmbientOcclusion/VulkanRayTracedAmbientOcclusion.*` (per-frame
cosine-hemisphere occlusion rays from the visible surface with frame
accumulation; 4 samples per frame) combined with the ray-traced tube
rendering of `src/Renderers/RayTracing/VulkanRayTracer.*`. Primary
visibility comes from the binned-capsule raster (an exact per-pixel
ray-capsule intersection); the AO rays are traced through the uniform
segment grid (`kernels/ao_grid.py`). AO shading modulation follows
`Lighting.glsl` (kA = 0.2 + (1-ao)*0.5, kD = 0.9*ao, color *= ao).

A frame is four steps, each a function of its own so that a caller can time
them: `rtao_gbuffer` (frame prep, capsule raster, untile), `rtao_rays` (AO
ray origins and directions), `trace_ao_batched` (pair expansion, AO kernel
and scatter per batch of rays) and `rtao_shade`; `RtaoSettings.denoiser`
"Spatial Hashing" or "EAW" filters the AO map between the last two
(`render/denoiser.py`). `rtao_occlusion` is the first three, `rtao_image`
the last two.

Ray-sharded frames (`psum_axis`, a process group, `parallel/mesh.py`): rank
r draws its samples under `fold_in(PRNGKey(seed + frame), r)`, as the JAX
package folds the mesh's axis index in, and the per-pixel share of occluded
rays is averaged over the ranks (a SUM, then one float32 division).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from linevis_tpu_torch.automation.profiling import span
from linevis_tpu_torch.kernels.ao_grid import (
    SegmentGrid,
    build_segment_grid,
    trace_ao_occlusion,
)
from linevis_tpu_torch.kernels.raster_capsule import rasterize_capsules
from linevis_tpu_torch.kernels.threefry_uniform import threefry_uniform
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.denoiser import eaw_denoise, spatial_hash_denoise
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.lighting import normalize3
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction, tf_eval_points
from linevis_tpu_torch.render.tube_raster import (
    CapsuleScene,
    camera_tensors,
    prepare_capsule_frame,
)

__all__ = [
    "RtaoSettings", "RtaoGbuffer", "render_tubes_rtao", "render_tubes_rtao_image",
    "hemisphere_uniforms", "rtao_gbuffer", "rtao_rays", "ray_batches", "trace_ao_batched",
    "denoise_ao", "rtao_shade", "rtao_occlusion", "rtao_image",
]


@dataclasses.dataclass(frozen=True)
class RtaoSettings:
    num_samples: int = 4  # AO rays per pixel per frame (reference default 4)
    ao_radius: float = 0.1  # occlusion distance in world units
    grid_resolution: int = 64
    max_ray_cells: int = 8  # cells sampled along each AO ray
    seed: int = 0
    # AO denoiser chain of the reference: "None" | "Spatial Hashing" | "EAW"
    # (other names filter nothing, as in the JAX package).
    denoiser: str = "None"
    # Rays traced per batch. The (cell, ray) pair expansion holds
    # max_ray_cells records per ray through a sort: 1080p x 4 spp is 8.3 M
    # rays and 66 M pairs in one shot. 0 = single batch.
    rays_per_batch: int = 2_100_000


@dataclasses.dataclass
class RtaoGbuffer:
    """The visible surface of a frame, [H, W] images (vectors [3, H, W])."""

    fg: torch.Tensor  # bool: a capsule is hit
    attr: torch.Tensor
    normal: torch.Tensor  # unit
    tangent: torch.Tensor  # unit
    ray: torch.Tensor  # pixel ray with unit forward component
    pos: torch.Tensor  # world position of the hit


def hemisphere_uniforms(key: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two draws of the JAX `_cosine_hemisphere(key, ...)`
    (`linevis_tpu/render/rtao.py:58-64`): (k1, k2) = split(key), then
    uniform(k1, shape) and uniform(k2, shape), on the key's device (two
    launches of kernel R6 on the card, each deriving its half of the
    split)."""
    return threefry_uniform(key, shape, split=0), threefry_uniform(key, shape, split=1)


def _cosine_hemisphere(u1: torch.Tensor, u2: torch.Tensor, normal: torch.Tensor):
    """Cosine-weighted directions around `normal` [3, H, W] from uniforms
    u1, u2 [S, H, W] -> [S, 3, H, W]."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    # Orthonormal basis around the normal (branchless Frisvad).
    n = normal
    sign = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t1 = torch.stack([1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    t2 = torch.stack([b, sign + n[1] * n[1] * a, -n[1]])
    return t1[None] * x[:, None] + t2[None] * y[:, None] + n[None] * z[:, None]


def rtao_gbuffer(scene, view_proj, camera_position, proj_ab, settings) -> RtaoGbuffer:
    """Primary visibility through the binned-capsule raster, without
    coverage AA: the AO rays want solid geometric hits only (an edge
    fragment below half a pixel would spawn them from a grazing point)."""
    W, H = settings.width, settings.height
    csr, params, basis = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings
    )
    with span("capsule.raster"):
        depth_t, id_t, gbuf_t = rasterize_capsules(
            csr, params, W, H, settings.tile_w, settings.tile_h, use_aa=False
        )

    def unp(x):
        return unpack_tiles(
            x, csr.tiles_x, csr.tiles_y, settings.tile_w, settings.tile_h, W, H
        )

    with span("rtao.unpack"):
        zndc = unp(depth_t)
        attr, nx, ny, nz, tx, ty, tz = (unp(g) for g in gbuf_t[:7])
        fg = unp(id_t) >= 0
    with span("rtao.surface"):
        dev = zndc.device
        # Surface positions from the depth buffer.
        u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :] * (2.0 / W) - 1.0
        v = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None] * (2.0 / H)
        d = (
            basis[:, 0][:, None, None] * u.expand(H, W)[None]
            + basis[:, 1][:, None, None] * v.expand(H, W)[None]
            + basis[:, 2][:, None, None]
        )
        view_z = proj_ab[1] / torch.clamp(proj_ab[0] - zndc, min=1e-9)
        return RtaoGbuffer(
            fg=fg, attr=attr,
            normal=normalize3(torch.stack([nx, ny, nz])),
            tangent=normalize3(torch.stack([tx, ty, tz])),
            ray=d, pos=camera_position[:, None, None] + d * view_z[None],
        )


def rtao_rays(gbuf: RtaoGbuffer, radius: float, rtao: RtaoSettings, u1, u2):
    """AO rays of a frame from the uniforms u1, u2 [S, H, W] -> (origins
    [3, R], dirs [3, R], t_max [R], valid [R]), R = S * H * W, sample-major.
    Origins sit two radii off the surface to avoid self-hits."""
    S = rtao.num_samples
    H, W = gbuf.fg.shape
    dirs = _cosine_hemisphere(u1, u2, gbuf.normal)  # [S, 3, H, W]
    origins = gbuf.pos + gbuf.normal * (2.0 * radius)
    o_flat = origins[:, None].expand(3, S, H, W).reshape(3, -1)
    d_flat = dirs.transpose(0, 1).reshape(3, -1)
    t_max = torch.full((S * H * W,), rtao.ao_radius, dtype=torch.float32,
                       device=o_flat.device)
    valid = gbuf.fg[None].expand(S, H, W).reshape(-1)
    return o_flat, d_flat, t_max, valid


def ray_batches(n_rays: int, rays_per_batch: int):
    """[start, end) of the batches `trace_ao_batched` traces: equal widths,
    multiples of 128, the last one cut at n_rays."""
    if not rays_per_batch or n_rays <= rays_per_batch:
        return [(0, n_rays)]
    n_b = -(-n_rays // rays_per_batch)
    per = -(-n_rays // n_b)
    per = -(-per // 128) * 128
    return [(s, min(s + per, n_rays)) for s in range(0, n_rays, per)]


def trace_ao_batched(origins, dirs, t_max, valid, grid: SegmentGrid, rtao: RtaoSettings):
    """`trace_ao_occlusion` over `rays_per_batch` rays at a time (peak memory
    is one batch's pair expansion) -> occluded [R]. A ray's result can depend
    on the pairs that share its chunk, hence on the batching."""
    return torch.cat([
        trace_ao_occlusion(origins[:, s:e], dirs[:, s:e], t_max[s:e], valid[s:e], grid,
                           max_ray_cells=rtao.max_ray_cells)
        for s, e in ray_batches(origins.shape[1], rtao.rays_per_batch)
    ])


def denoise_ao(ao: torch.Tensor, gbuf: RtaoGbuffer, camera_position, rtao: RtaoSettings):
    """The AO map [H, W] through `rtao.denoiser` on the foreground: "Spatial
    Hashing" (world-space hash cells, the reference's AO-specific choice) or
    "EAW" (a-trous on the AO with position and normal edge-stopping); any
    other name leaves it as it is."""
    if rtao.denoiser == "Spatial Hashing":
        return torch.where(gbuf.fg, spatial_hash_denoise(ao, gbuf.pos, gbuf.normal,
                                                         camera_position), ao)
    if rtao.denoiser == "EAW":
        den = eaw_denoise(ao[None], position=gbuf.pos, normal=gbuf.normal)[0]
        return torch.where(gbuf.fg, den, ao)
    return ao


def rtao_shade(gbuf: RtaoGbuffer, ao: torch.Tensor, settings: RasterSettings):
    """Headlight Blinn-Phong of the visible surface with AO modulation
    (Lighting.glsl's AO variant) -> [4, H, W] linear RGBA."""
    with span("rtao.light"):
        d = gbuf.ray
        dn = d * (1.0 / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True)))
        light = -dn
        ndl = torch.sum(gbuf.normal * light, dim=0)
        tdl = torch.sum(gbuf.tangent * light, dim=0)
        ndt = torch.sum(gbuf.normal * gbuf.tangent, dim=0)
        denom = 1.0 / torch.sqrt(torch.clamp(1.0 - tdl * tdl, min=1e-6))
        cos1 = torch.clamp(torch.abs(ndl), 0.0, 1.0)
        cos2 = torch.clamp(torch.abs(ndl - tdl * ndt) * denom, 0.0, 1.0)
        cosc = 0.3 * cos1 ** 1.7 + 0.7 * cos2 ** 1.7
        spec = 0.3 * cos1 ** 30.0
    rgb, alpha = tf_eval_points(settings.tf_color, settings.tf_opacity, gbuf.attr)
    with span("rtao.composite"):
        k_a = 0.2 + (1.0 - ao) * 0.5
        k_d = 0.9 * ao
        color = rgb * k_a[None] + rgb * (k_d * cosc)[None] + (spec * ao)[None]
        color = color * ao[None]
        bg = torch.tensor(settings.background_color, dtype=torch.float32, device=ao.device)
        out_rgb = torch.where(gbuf.fg[None], color, bg[:3, None, None])
        out_a = torch.where(gbuf.fg, alpha, bg[3])
        return torch.cat([out_rgb, out_a[None]])


def rtao_occlusion(scene: CapsuleScene, view_proj, camera_position, proj_ab,
                   settings: RasterSettings, rtao: RtaoSettings = RtaoSettings(), frame: int = 0,
                   grid: Optional[SegmentGrid] = None, uniforms=None, rank: Optional[int] = None):
    """A frame's G-buffer and AO trace -> (RtaoGbuffer, occlusion [H, W]: the
    share of each pixel's rays that hit). The samples are `uniforms`, or
    jax.random's under PRNGKey(rtao.seed + frame), folded with `rank` when
    one is given (`threefry.fold_in`), on the scene's device."""
    W, H, S = settings.width, settings.height, rtao.num_samples
    dev = scene.a.device
    with span("rtao.gbuffer"):
        gbuf = rtao_gbuffer(scene, view_proj, camera_position, proj_ab, settings)
    if grid is None:
        grid = build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                                  resolution=rtao.grid_resolution)
    if uniforms is None:
        key = threefry.prng_key(rtao.seed + frame, dev)
        if rank is not None:
            key = threefry.fold_in(key, rank)
        with span("rtao.samples"):
            u1, u2 = hemisphere_uniforms(key, (S, H, W))
    else:
        u1, u2 = uniforms
    with span("rtao.rays"):
        rays = rtao_rays(gbuf, scene.radius, rtao, u1, u2)
    occluded = trace_ao_batched(*rays, grid, rtao)
    return gbuf, occluded.reshape(S, H, W).mean(dim=0)


def rtao_image(gbuf: RtaoGbuffer, occlusion: torch.Tensor, camera_position,
               settings: RasterSettings, rtao: RtaoSettings) -> torch.Tensor:
    """AO = 1 - occlusion through the denoiser, then the shading -> [4, H, W]."""
    return rtao_shade(gbuf, denoise_ao(1.0 - occlusion, gbuf, camera_position, rtao), settings)


def render_tubes_rtao(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    rtao: RtaoSettings = RtaoSettings(),
    frame: int = 0,
    grid: Optional[SegmentGrid] = None,  # camera-independent: build once per scene
    return_features: bool = False,
    psum_axis=None,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """RTAO-shaded tubes -> [4, H, W] linear RGBA on the scene's device.

    The hemisphere samples come from `uniforms` = (u1, u2), each
    [num_samples, H, W] in [0, 1), or, when none are given, from
    jax.random's stream under `PRNGKey(rtao.seed + frame)` as the JAX
    function draws them (`hemisphere_uniforms`), on the scene's device.
    With `psum_axis`, a process group (or a 1-D DeviceMesh) of the ranks
    that trace a frame together, rank r folds r into that key and the
    occlusion is averaged over the group: every rank returns the same
    frame. With `return_features`, also returns (position [3, H, W], normal
    [3, H, W], foreground [H, W]), the G-buffer maps a temporal denoiser
    consumes."""
    rank = None
    if psum_axis is not None:
        from linevis_tpu_torch.parallel.mesh import group_rank_size, pmean

        pg, rank, _ = group_rank_size(psum_axis, scene.a.device)
    gbuf, occlusion = rtao_occlusion(scene, view_proj, camera_position, proj_ab, settings, rtao,
                                     frame, grid, uniforms, rank)
    if psum_axis is not None:
        occlusion = pmean(occlusion, pg)
    with span("rtao.shade"):
        img = rtao_image(gbuf, occlusion, camera_position, settings, rtao)
    if return_features:
        return img, (gbuf.pos, gbuf.normal, gbuf.fg)
    return img


def render_tubes_rtao_image(
    scene: CapsuleScene,
    camera: Camera,
    tf: Optional[TransferFunction] = None,
    settings: Optional[RasterSettings] = None,
    rtao: RtaoSettings = RtaoSettings(),
    accumulate_frames: int = 1,
) -> np.ndarray:
    """Host wrapper with frame accumulation (reference: up to 32 frames) ->
    numpy [H, W, 4] linear RGBA."""
    settings = settings or RasterSettings(width=camera.width, height=camera.height)
    if tf is not None:
        c_pts, o_pts = tf.as_static_points()
        settings = dataclasses.replace(settings, tf_color=c_pts, tf_opacity=o_pts)
    cam = camera_tensors(camera, scene.a.device)
    grid = build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                              resolution=rtao.grid_resolution)
    acc = None
    for f in range(accumulate_frames):
        img = render_tubes_rtao(scene, *cam, settings, rtao, frame=f, grid=grid)
        acc = img if acc is None else acc + img
    return hand_back(acc / accumulate_frames)
