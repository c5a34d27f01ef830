"""Deferred (visibility-buffer) opaque rendering, motion vectors, temporal upscaler.

Counterpart of `linevis_tpu/render/deferred.py`. Reference: the deferred
renderer (`src/Renderers/Deferred/DeferredRenderer.{hpp:83,cpp}`), a
visibility buffer of primitive ids and depth resolved per pixel, with the
deferred resolve's extras: per-pixel motion vectors from the previous
frame's camera (`DeferredRenderer.hpp:70-80`) and a temporal upscaler slot
(the reference wires vendor DLSS/XeSS SDKs, `src/Renderers/Upscaler/*`; this
one is a vendor-free temporal reprojection upscaler in the same role).

The capsule raster kernel (`kernels/raster_capsule.py`, B1) already is the
visibility phase: it writes a G-buffer and shades nothing, and
`resolve_capsule_frame` is the deferred resolve. So `render_tubes_deferred`
draws the same image as `render_tubes` and adds the motion vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from linevis_tpu_torch.kernels.raster_capsule import rasterize_capsules
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.renderer import LineRenderer
from linevis_tpu_torch.render.tube_raster import (
    camera_tensors,
    prepare_capsule_frame,
    resolve_capsule_frame,
)

__all__ = [
    "render_tubes_deferred", "motion_vectors", "TemporalUpscaler", "DeferredOpaqueRenderer",
]


def _reconstruct_positions(zndc, camera_position, ray_basis, proj_ab):
    """World position per pixel [3, H, W] from the visibility buffer's NDC depth."""
    H, W = zndc.shape
    dev = zndc.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :] * (2.0 / W) - 1.0
    v = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None] * (2.0 / H)
    d = (
        ray_basis[:, 0][:, None, None] * u.expand(H, W)[None]
        + ray_basis[:, 1][:, None, None] * v.expand(H, W)[None]
        + ray_basis[:, 2][:, None, None]
    )
    view_z = proj_ab[1] / torch.clamp(proj_ab[0] - zndc, min=1e-9)
    return camera_position[:, None, None] + d * view_z[None]


def motion_vectors(pos, fg, prev_view_proj):
    """Per-pixel screen motion (pixels, +x right / +y down) of the visible
    surface from the previous camera to the current one
    (DeferredRenderer.hpp:70-80; the geometry is static, so the motion is
    the camera's). pos [3, H, W] world positions, fg [H, W] foreground ->
    [2, H, W]; background pixels get zero motion."""
    _, H, W = pos.shape
    dev = pos.device
    p = pos.reshape(3, -1)
    clip = prev_view_proj[:3, :3] @ p + prev_view_proj[:3, 3:4]
    w = prev_view_proj[3, :3] @ p + prev_view_proj[3, 3]
    ndc = clip[:2] / torch.clamp(torch.abs(w), min=1e-9)[None]
    prev_px = torch.stack([(ndc[0] * 0.5 + 0.5) * W, (0.5 - ndc[1] * 0.5) * H]).reshape(2, H, W)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    mv = torch.stack([xs, ys]) - prev_px
    return torch.where(fg[None], mv, 0.0)


def render_tubes_deferred(
    scene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    prev_view_proj: torch.Tensor = None,
    with_motion: bool = False,
):
    """Visibility-buffer render -> [4, H, W] RGBA (and [2, H, W] motion with
    `with_motion`). The same frame prep, kernel (B1) and resolve as
    `render_tubes`, so the same image; the motion vectors are the deferred
    pipeline's extra target for upscalers and TAA."""
    W, H = settings.width, settings.height
    csr, params, basis = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings,
        aa_margin=0.5 if settings.aa else 0.0,
    )
    raster = rasterize_capsules(csr, params, W, H, settings.tile_w, settings.tile_h,
                                use_aa=settings.aa)
    img = resolve_capsule_frame(scene, csr, raster, view_proj, camera_position, proj_ab, basis,
                                settings)
    if not with_motion:
        return img

    def unp(x):
        return unpack_tiles(x, csr.tiles_x, csr.tiles_y, settings.tile_w, settings.tile_h, W, H)

    zndc, seg_id = unp(raster[0]), unp(raster[1])
    pos = _reconstruct_positions(zndc, camera_position, basis, proj_ab)
    return img, motion_vectors(pos, seg_id >= 0, prev_view_proj)


def _resize_bilinear(x, scale: int):
    """[C, h, w] -> [C, h * scale, w * scale], bilinear at half-pixel centers
    with the edge samples clamped (what `jax.image.resize(..., "bilinear")`
    computes when it upsamples)."""
    return F.interpolate(x[None], scale_factor=scale, mode="bilinear", align_corners=False,
                         antialias=False)[0]


def _taa_step(history, low, motion_low, scale: int, blend: float):
    """One temporal-upscale step: bilinear history reprojection, a 3x3
    neighborhood color clamp (TAA rectification) and an exponential blend of
    the upsampled current frame."""
    C, h, w = low.shape
    H, W = h * scale, w * scale
    dev = low.device
    up = _resize_bilinear(low, scale)
    mv = _resize_bilinear(motion_low * scale, scale)
    # Reproject the history: sample at (cur - motion).
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - mv[1]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - mv[0]
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    fy, fx = ys - y0, xs - x0
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = torch.clamp(y0i + 1, 0, H - 1), torch.clamp(x0i + 1, 0, W - 1)
    hist = (
        history[:, y0i, x0i] * ((1 - fy) * (1 - fx))[None]
        + history[:, y0i, x1i] * ((1 - fy) * fx)[None]
        + history[:, y1i, x0i] * (fy * (1 - fx))[None]
        + history[:, y1i, x1i] * (fy * fx)[None]
    )
    # Neighborhood clamp against the current frame (ghosting control).
    lo, hi = up, up
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny = torch.clamp(torch.arange(H, device=dev) + dy * scale, 0, H - 1)
            nx = torch.clamp(torch.arange(W, device=dev) + dx * scale, 0, W - 1)
            v = up.index_select(1, ny).index_select(2, nx)
            lo = torch.minimum(lo, v)
            hi = torch.maximum(hi, v)
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    b = torch.full((), float(np.float32(blend)), dtype=torch.float32, device=dev)
    return hist * (1.0 - b) + up * b


class TemporalUpscaler:
    """Vendor-free temporal upscaler in the reference's DLSS/XeSS slot
    (`src/Renderers/Upscaler/Upscaler.hpp:56-60`): takes the deferred
    pipeline's low-resolution color and motion vectors and keeps a
    full-resolution history on their device."""

    def __init__(self, scale: int = 2, blend: float = 0.125):
        self.scale = int(scale)
        self.blend = float(blend)
        self._history = None

    def reset(self):
        self._history = None

    def step(self, low_img: torch.Tensor, motion_low: torch.Tensor) -> torch.Tensor:
        """low_img [C, h, w], motion_low [2, h, w] -> [C, h * s, w * s]."""
        if self._history is None:
            self._history = _resize_bilinear(low_img, self.scale)
        else:
            self._history = _taa_step(self._history, low_img, motion_low, self.scale,
                                      self.blend)
        return self._history


class DeferredOpaqueRenderer(LineRenderer):
    """Reference RENDERING_MODE_DEFERRED_SHADING (`DeferredRenderer.hpp:83`):
    the Opaque image, the previous frame's camera kept for motion vectors;
    with `upscaling_factor` > 1 it renders at the reduced resolution and
    upscales temporally."""

    name = "Deferred Opaque"

    def __init__(self, settings=None, device="cuda"):
        super().__init__(settings, device)
        # Set after the base applies `settings`, as in the JAX renderer: an
        # `upscaling_factor` given to the constructor is overridden; it takes
        # effect through set_new_settings.
        self.prev_vp = None
        self.upscaling_factor = 1
        self.upscaler = None
        self.last_motion = None

    def set_new_settings(self, settings) -> None:
        super().set_new_settings(settings)
        if settings.has_key("upscaling_factor"):
            self.upscaling_factor = settings.get_int("upscaling_factor")
            self.upscaler = None

    def render(self, camera: Camera) -> np.ndarray:
        f = self.upscaling_factor
        cam = camera
        if f > 1:
            cam = dataclasses.replace(camera, width=camera.width // f,
                                      height=camera.height // f)
        vp, cp, ab = camera_tensors(cam, self.device)
        prev = self.prev_vp if self.prev_vp is not None else vp
        img, mv = render_tubes_deferred(self._capsules(), vp, cp, ab,
                                        self._raster_settings(cam), prev_view_proj=prev,
                                        with_motion=True)
        self.prev_vp = vp
        self.last_motion = mv
        if f > 1:
            if self.upscaler is None:
                self.upscaler = TemporalUpscaler(scale=f)
            img = self.upscaler.step(img, mv)
        return hand_back(img)
