"""Transparent line renderers (OIT family) on the capsule OIT kernels.

Counterpart of `linevis_tpu/render/oit.py` (reference `src/Renderers/OIT/*`),
the whole family on `rasterize_capsules_mlab`:
- `render_tubes_mlab(K=8)`: the reference's MLAB renderer (8 nodes); with
  K >= the depth complexity it equals exact sorted blending;
- `render_tubes_atomic_loop(K=16)`: the reference's Atomic Loop 64, the
  exact front-K buffer (`no_overflow`) blended front to back;
- `render_tubes_depth_peeling(K=8, passes=4)`: `passes` exact K-layer peels;
- `render_tubes_mlab_buckets(K=8)`: one exact K-layer peel, then MLAB over
  the fragments behind it;
- `render_tubes_wboit`: weighted blended OIT (accumulation mode 'wboit');
- `render_tubes_mboit`: moment-based OIT, power or trigonometric moments,
  4/6/8 of them, float32 or emulated unorm16 storage (modes 'mboit_gen'
  and 'mboit_resolve');
- `render_depth_complexity`: front-face fragments per pixel ('count').
Each fills the kernel's params as its JAX counterpart does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels.moment_math import (
    UNORM_BIAS_VECTOR,
    UNORM_MOMENT_BIAS,
    UNORM_MOMENT_BIAS_TRIG,
    dequantize_moments_unorm16,
    quantize_moments_unorm16,
)
from linevis_tpu_torch.kernels.raster_capsule_oit import (
    blend_front_to_back,
    rasterize_capsules_mlab,
    shade_nodes,
)
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.kernels.trig_moment_math import TRIG_BIAS, wrapping_zone_parameters
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction
from linevis_tpu_torch.render.tube_raster import (
    CapsuleScene,
    camera_tensors,
    prepare_capsule_frame,
)

__all__ = [
    "shade_deferred_nodes", "prepare_mlab_frame", "render_tubes_mlab",
    "render_tubes_mlab_image", "render_tubes_atomic_loop", "render_tubes_wboit",
    "render_tubes_depth_peeling", "render_tubes_mlab_buckets", "prepare_mboit_frame",
    "render_tubes_mboit", "render_depth_complexity",
]


def shade_deferred_nodes(depths, feat, alpha, proj_ab, dmin, dmax, cue,
                         settings, use_bands: bool = False):
    """Shade-after-extract resolve of the kernel's K nodes, which carry
    PREMULTIPLIED features (attr, cos1, cos2): `shade_nodes` with the
    settings' color TF. feat: [3, K, T, P]; depths/alpha: [K, T, P]
    -> premultiplied rgb [3, K, T, P]."""
    return shade_nodes(depths, feat, alpha, proj_ab[0], proj_ab[1], dmin, dmax, cue,
                       settings.tf_color, use_bands)


def _mlab_params(scene, view_proj, params, settings, opacity):
    """Fill the depth-cue range, cue strength and opacity slots shared by
    the transparent passes (a new tensor)."""
    w_all = view_proj[3, :3] @ scene.a + view_proj[3, 3]
    big = torch.full_like(w_all, 3e38)
    params = params.clone()
    params[11] = torch.min(torch.where(scene.mask, w_all, big))
    params[12] = torch.max(torch.where(scene.mask, w_all, -big))
    params[13] = settings.depth_cue_strength
    params[14] = opacity
    return params


def _untile(x, csr, settings):
    return unpack_tiles(
        x, csr.tiles_x, csr.tiles_y, settings.tile_w, settings.tile_h,
        settings.width, settings.height,
    )


def _kernel(csr, params, settings, K, **kw):
    """`rasterize_capsules_mlab` at the settings' size, tiles and TFs."""
    return rasterize_capsules_mlab(
        csr, params, settings.width, settings.height, settings.tile_w, settings.tile_h,
        K, settings.tf_color, settings.tf_opacity, **kw
    )


def _image(rgb, alpha, csr, settings):
    """rgb [3, T, P] and alpha [T, P] -> [4, H, W]."""
    return torch.stack([_untile(c, csr, settings) for c in (*rgb, alpha)], dim=0)


def _background(settings, like):
    return torch.tensor(settings.background_color[:3], dtype=torch.float32,
                        device=like.device)[:, None, None]


def _blend_nodes(acc, T, rgb, alpha):
    """Front-to-back blend of premultiplied nodes (rgb [3, K, T, P], alpha
    [K, T, P]) under the running (acc, T)."""
    for i in range(alpha.shape[0]):
        acc = acc + T[None] * rgb[:, i]
        T = T * (1.0 - alpha[i])
    return acc, T


def prepare_mlab_frame(scene, view_proj, camera_position, proj_ab, settings,
                       opacity=0.3, seg_alpha=None, y_offset=None, full_height=None):
    """Frame prep of the MLAB pass -> (csr, params): the capsule frame prep
    with the kernel's alpha rows (`seg_alpha` premultiplied by the global
    opacity, since the rows replace the TF alpha), depth-cue range,
    opacity and background color. `y_offset` / `full_height`: a band of
    settings.height rows (`prepare_capsule_frame`); the depth-cue range is
    taken over the whole masked scene, the same on every band."""
    if seg_alpha is not None:
        seg_alpha = seg_alpha * opacity
    csr, params, _ = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings, seg_alpha=seg_alpha,
        y_offset=y_offset, full_height=full_height,
    )
    params = _mlab_params(scene, view_proj, params, settings, opacity)
    for i, v in enumerate(settings.background_color):
        params[24 + i] = float(v)
    return csr, params


def render_tubes_mlab(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    K: int = 8,
    opacity: float = 0.3,
    seg_alpha: torch.Tensor = None,  # [2, S]: per-segment (alpha0, dalpha)
    sub: int = 32,  # kernel block width
    sat: float = 0.999,  # saturation-culling threshold (see the kernel)
    two_sided: bool = False,  # also blend exit-surface fragments
    y_offset: int = None,  # a band's first row in the frame of full_height rows
    full_height: int = None,
) -> torch.Tensor:
    """Transparent tube render -> [4, H, W] linear RGBA on the scene's device.

    `seg_alpha` multiplies the TF opacity per segment through the kernel's
    alpha rows. `two_sided=False` blends front-face fragments only, as the
    reference rasterizes transparent tubes with CULL_BACK
    (LineRasterPass.cpp:86-91). The kernel shades and composites in place
    (composite mode, deferred shading). With `y_offset` and `full_height`,
    the settings.height rows from y_offset of a frame of full_height rows
    (the band layout of `parallel/mesh.py`)."""
    csr, params = prepare_mlab_frame(
        scene, view_proj, camera_position, proj_ab, settings, opacity, seg_alpha,
        y_offset, full_height,
    )
    rgba = _kernel(csr, params, settings, K, alpha_from_rows=seg_alpha is not None,
                   deferred_shade=True, sub=sub, sat=sat, composite=True,
                   two_sided=two_sided)
    return _image(rgba[:3], rgba[3], csr, settings)


def render_tubes_mlab_image(
    scene: CapsuleScene,
    camera: Camera,
    tf: Optional[TransferFunction] = None,
    settings: Optional[RasterSettings] = None,
    K: int = 8,
    opacity: float = 0.3,
) -> np.ndarray:
    """Host convenience wrapper -> numpy [H, W, 4] linear RGBA."""
    settings = settings or RasterSettings(width=camera.width, height=camera.height)
    if tf is not None:
        c_pts, o_pts = tf.as_static_points()
        settings = dataclasses.replace(settings, tf_color=c_pts, tf_opacity=o_pts)
    img = render_tubes_mlab(
        scene, *camera_tensors(camera, scene.a.device), settings, K, opacity
    )
    return hand_back(img)


def render_tubes_atomic_loop(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    K: int = 16,
    opacity: float = 0.3,
) -> torch.Tensor:
    """Atomic Loop 64 (reference AtomicLoop64Renderer.cpp:283): the exact K
    nearest fragments per pixel in depth order, fragments beyond K dropped,
    blended front to back -> [4, H, W] linear RGBA.

    The kernel computes that steady state directly (`no_overflow`, no MLAB
    merge), shading each fragment as it is generated (per-fragment shading,
    as the JAX package does)."""
    csr, params = prepare_mlab_frame(
        scene, view_proj, camera_position, proj_ab, settings, opacity
    )
    _, rgb, alpha = _kernel(csr, params, settings, K, no_overflow=True)
    out = blend_front_to_back(rgb, alpha, params[24:27])
    return _image(out[:3], out[3], csr, settings)


def render_tubes_wboit(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    opacity: float = 0.3,
) -> torch.Tensor:
    """Weighted blended OIT (reference WBOITRenderer.cpp:195): accumulation
    and revealage with the depth weight of WBOITGather.glsl -> [4, H, W].
    Only the opacity slot of the params is set (no depth cue), as in the
    JAX package."""
    csr, params, _ = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings
    )
    params[14] = opacity
    depths, rgb, alpha = _kernel(csr, params, settings, 1, store_mode="wboit")
    revealage = torch.exp(depths[0])
    acc = rgb[:, 0] / torch.clamp(alpha[0], min=1e-6)[None]
    out = acc * (1.0 - revealage)[None] + revealage[None] * _background(settings, acc)
    return _image(out, 1.0 - revealage, csr, settings)


def render_tubes_depth_peeling(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    K: int = 8,
    passes: int = 4,
    opacity: float = 0.3,
) -> torch.Tensor:
    """Depth peeling (reference DepthPeelingRenderer.cpp:423) -> [4, H, W].

    Each pass extracts the next K nearest layers exactly (no overflow merge)
    behind the previous passes' per-pixel peel depth: `passes * K` exact
    layers, one kernel launch per pass."""
    csr, params = prepare_mlab_frame(
        scene, view_proj, camera_position, proj_ab, settings, opacity
    )
    n_tiles, P = csr.tile_start.shape[0], settings.tile_w * settings.tile_h
    peel = torch.full((n_tiles, P), -1.0, device=params.device)
    T = torch.ones((n_tiles, P), device=params.device)
    acc = torch.zeros((3, n_tiles, P), device=params.device)
    for _ in range(passes):
        depths, rgb, alpha = _kernel(csr, params, settings, K, peel=peel, no_overflow=True)
        acc, T = _blend_nodes(acc, T, rgb, alpha)
        # Next peel depth: the farthest extracted layer (2.0 marks empty),
        # monotone so that an empty pass does not re-extract earlier layers.
        peel = torch.maximum(
            peel, torch.where(depths < 1.5, depths, -1.0).amax(dim=0)
        )
    return _image(acc + T[None] * _background(settings, acc), 1.0 - T, csr, settings)


def render_tubes_mlab_buckets(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    K: int = 8,
    opacity: float = 0.3,
) -> torch.Tensor:
    """MLAB (Buckets), reference MLABBucketRenderer -> [4, H, W]: the
    nearest bucket of K fragments is kept exact (one exact peel pass), the
    far bucket degrades to MLAB overflow merging (one MLAB pass over the
    fragments behind it)."""
    csr, params = prepare_mlab_frame(
        scene, view_proj, camera_position, proj_ab, settings, opacity
    )
    n_tiles, P = csr.tile_start.shape[0], settings.tile_w * settings.tile_h
    peel = torch.full((n_tiles, P), -1.0, device=params.device)
    T = torch.ones((n_tiles, P), device=params.device)
    acc = torch.zeros((3, n_tiles, P), device=params.device)
    depths, rgb, alpha = _kernel(csr, params, settings, K, peel=peel, no_overflow=True)
    acc, T = _blend_nodes(acc, T, rgb, alpha)
    peel = torch.where(depths < 1.5, depths, -1.0).amax(dim=0)
    _, rgb, alpha = _kernel(csr, params, settings, K, peel=peel)
    acc, T = _blend_nodes(acc, T, rgb, alpha)
    return _image(acc + T[None] * _background(settings, acc), 1.0 - T, csr, settings)


def prepare_mboit_frame(scene, view_proj, camera_position, proj_ab, settings, n_mom=4,
                        opacity=0.3, overestimation=0.1, moment_bias=None,
                        trigonometric=False, pixel_format="float32"):
    """Frame prep of the two MBOIT passes -> (csr, params, moment_bias): the
    capsule frame prep with the depth-cue range, cue strength and opacity
    (params 11-14), the log depth range (15-16), the kernel's moment bias
    and overestimation (17-18) and, for trigonometric moments, the wrapping
    zone (20-22). `moment_bias` None takes the format's default
    (MBOITRenderer.cpp:134-161); with unorm16 the kernel's bias is 0 (the
    renderer pre-mixes it between the passes)."""
    unorm = pixel_format == "unorm16"
    if pixel_format not in ("float32", "unorm16"):
        raise ValueError(f"pixel_format {pixel_format!r}")
    if moment_bias is None:
        if trigonometric:
            moment_bias = UNORM_MOMENT_BIAS_TRIG[n_mom] if unorm else TRIG_BIAS[n_mom]
        else:
            moment_bias = (UNORM_MOMENT_BIAS[n_mom] if unorm
                           else {4: 5e-7, 6: 5e-6, 8: 5e-5}[n_mom])
    csr, params, _ = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings
    )
    params = _mlab_params(scene, view_proj, params, settings, opacity)
    # Log depth range over the scene in view space with the reference's 0.1
    # offset (MBOITRenderer::computeDepthRange).
    near = proj_ab[1] / torch.clamp(proj_ab[0], min=1e-9)
    zmin = torch.maximum(params[11] - scene.radius - 0.1, near)
    zmax = torch.maximum(params[12] + scene.radius + 0.1, near * 2.0)
    params[15] = torch.log(zmin)
    params[16] = torch.log(zmax)
    params[17] = 0.0 if unorm else moment_bias
    params[18] = overestimation
    if trigonometric:
        params[20:23] = torch.tensor(wrapping_zone_parameters()[1:], dtype=torch.float32)
    return csr, params, moment_bias


def render_tubes_mboit(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    n_mom: int = 4,
    opacity: float = 0.3,
    overestimation: float = 0.1,
    moment_bias: float = None,
    trigonometric: bool = False,
    pixel_format: str = "float32",  # | "unorm16"
) -> torch.Tensor:
    """Moment-based OIT (reference MBOITRenderer.cpp:688) -> [4, H, W].

    Two fragment passes over one binning: pass 1 ('mboit_gen') accumulates
    the absorbance b0 and the moments of the log-warped depth, pass 2
    ('mboit_resolve') reconstructs each fragment's transmittance from them
    and accumulates the weighted color; the blend follows
    MBOITBlend.glsl:100-101. `trigonometric` selects the reference's
    `usePowerMoments = false` (n_mom/2 complex moments). `pixel_format`
    'unorm16' emulates 16-bit moment storage between the passes in plain
    PyTorch: the normalized moments go through the reference's quantization
    basis change, are rounded to the 65535-step grid and come back, with
    the bias pre-mixed (MomentMath.glsl:156-243)."""
    unorm = pixel_format == "unorm16"
    csr, params, moment_bias = prepare_mboit_frame(
        scene, view_proj, camera_position, proj_ab, settings, n_mom, opacity, overestimation,
        moment_bias, trigonometric, pixel_format,
    )
    depths, rgb, alpha = _kernel(csr, params, settings, 2, store_mode="mboit_gen",
                                 n_mom=n_mom, trig=trigonometric)
    nh = n_mom // 2
    b0 = depths[0]
    odd_ch = (rgb[0, 0], rgb[1, 0], rgb[2, 0], alpha[0])[:nh]
    even_ch = (depths[1], rgb[0, 1], rgb[1, 1], rgb[2, 1])[:nh]
    if unorm:
        inv_b0 = 1.0 / torch.clamp(b0, min=1e-6)
        on = [o * inv_b0 for o in odd_ch]
        en = [e * inv_b0 for e in even_ch]
        if trigonometric:
            oq = [0.5 * x + 0.5 for x in on]
            eq = [0.5 * x + 0.5 for x in en]
        else:
            oq, eq = quantize_moments_unorm16(on, en, n_mom)

        def u16(x):
            return torch.round(torch.clamp(x, 0.0, 1.0) * 65535.0) / torch.full(
                (), 65535.0, device=x.device)

        oq = [u16(x) for x in oq]
        eq = [u16(x) for x in eq]
        if trigonometric:
            scale = 1.0 - moment_bias
            od = [(2.0 * x - 1.0) * scale for x in oq]
            ed = [(2.0 * x - 1.0) * scale for x in eq]
        else:
            od, ed = dequantize_moments_unorm16(oq, eq, n_mom)
            bv = UNORM_BIAS_VECTOR[n_mom]
            od = [(1.0 - moment_bias) * x + moment_bias * bv[2 * j] for j, x in enumerate(od)]
            ed = [(1.0 - moment_bias) * x + moment_bias * bv[2 * j + 1]
                  for j, x in enumerate(ed)]
        odd_ch = tuple(x * b0 for x in od)
        even_ch = tuple(x * b0 for x in ed)
    moments = torch.stack([b0, *odd_ch, *even_ch], dim=0)

    _, rgb2, alpha2 = _kernel(csr, params, settings, 1, store_mode="mboit_resolve",
                              n_mom=n_mom, trig=trigonometric, moments=moments)
    total_t = torch.exp(-b0)
    src_a = 1.0 - total_t
    out = (rgb2[:, 0] / torch.clamp(alpha2[0], min=1e-6)[None]) * src_a[None] \
        + total_t[None] * _background(settings, b0)
    return _image(out, src_a, csr, settings)


def render_depth_complexity(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
) -> torch.Tensor:
    """Front-face fragments per pixel (reference
    DepthComplexityRenderer.cpp:346) -> [H, W] float32 counts: one fragment
    per capsule crossing, as the reference's CULL_BACK transparent raster
    (LineRasterPass.cpp:86-91) counts them."""
    csr, params, _ = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings
    )
    depths, _, _ = _kernel(csr, params, settings, 1, store_mode="count")
    return _untile(depths[0], csr, settings)
