"""Transparent line renderers (OIT family) on the MLAB K-buffer kernel.

Counterpart of `linevis_tpu/render/oit.py`. Ported so far:
- `render_tubes_mlab(K=8)`: the reference's MLAB renderer (8 nodes); with
  K >= the depth complexity it equals exact sorted blending;
- `render_tubes_atomic_loop(K=16)`: the reference's Atomic Loop 64, the
  exact front-K buffer (`no_overflow`) blended front to back.
WBOIT, depth peeling, MLAB buckets, MBOIT and depth complexity are not
ported yet (ROADMAP queue A item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels.raster_capsule_oit import (
    blend_front_to_back,
    rasterize_capsules_mlab,
    shade_nodes,
)
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction
from linevis_tpu_torch.render.tube_raster import (
    CapsuleScene,
    camera_tensors,
    prepare_capsule_frame,
)

__all__ = [
    "shade_deferred_nodes", "prepare_mlab_frame", "render_tubes_mlab",
    "render_tubes_mlab_image", "render_tubes_atomic_loop",
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


def prepare_mlab_frame(scene, view_proj, camera_position, proj_ab, settings,
                       opacity=0.3, seg_alpha=None):
    """Frame prep of the MLAB pass -> (csr, params): the capsule frame prep
    with the kernel's alpha rows (`seg_alpha` premultiplied by the global
    opacity, since the rows replace the TF alpha), depth-cue range,
    opacity and background color."""
    if seg_alpha is not None:
        seg_alpha = seg_alpha * opacity
    csr, params, _ = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings, seg_alpha=seg_alpha,
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
) -> torch.Tensor:
    """Transparent tube render -> [4, H, W] linear RGBA on the scene's device.

    `seg_alpha` multiplies the TF opacity per segment through the kernel's
    alpha rows. `two_sided=False` blends front-face fragments only, as the
    reference rasterizes transparent tubes with CULL_BACK
    (LineRasterPass.cpp:86-91). The kernel shades and composites in place
    (composite mode, deferred shading)."""
    csr, params = prepare_mlab_frame(
        scene, view_proj, camera_position, proj_ab, settings, opacity, seg_alpha
    )
    rgba = rasterize_capsules_mlab(
        csr, params, settings.width, settings.height, settings.tile_w,
        settings.tile_h, K, settings.tf_color, settings.tf_opacity,
        alpha_from_rows=seg_alpha is not None, deferred_shade=True, sub=sub,
        sat=sat, composite=True, two_sided=two_sided,
    )
    return torch.stack([_untile(rgba[c], csr, settings) for c in range(4)], dim=0)


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
    return np.moveaxis(img.cpu().numpy(), 0, -1)


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
    merge). The nodes carry deferred-shading features and are shaded by
    `shade_deferred_nodes`; the JAX package shades each fragment in the
    kernel instead (`deferred_shade=False`, not ported), which differs only
    by rounding, and where coincident fragments are averaged (the average
    of their features is shaded, not the average of their colors)."""
    csr, params = prepare_mlab_frame(
        scene, view_proj, camera_position, proj_ab, settings, opacity
    )
    depths, feat, alpha = rasterize_capsules_mlab(
        csr, params, settings.width, settings.height, settings.tile_w,
        settings.tile_h, K, settings.tf_color, settings.tf_opacity,
        no_overflow=True, deferred_shade=True,
    )
    rgb = shade_deferred_nodes(
        depths, feat, alpha, proj_ab, params[11], params[12], params[13], settings
    )
    out = blend_front_to_back(rgb, alpha, params[24:27])
    return torch.stack([_untile(out[c], csr, settings) for c in range(4)], dim=0)
