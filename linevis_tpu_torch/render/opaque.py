"""Opaque triangle-tube renderer (G-buffer raster + elementwise shading).

Counterpart of `linevis_tpu/render/opaque.py` (reference:
`src/Renderers/OpaqueLineRenderer.{hpp:40,cpp}`, an MSAA raster of tube
triangles): one CSR tile pass produces depth and the interpolated G-buffer
planes (`kernels/raster_pallas.py`), then shading is elementwise
(`render/pipeline.py:shade_gbuffer`); anti-aliasing is ordered
supersampling (render at k x the resolution, box downsample) in MSAA's place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.automation.profiling import span
from linevis_tpu_torch.geometry.tubes import TubeMesh
from linevis_tpu_torch.kernels import raster_pallas
from linevis_tpu_torch.kernels.raster_pallas import build_csr_binning
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.pipeline import (
    GBUFFER_PLANES,
    RasterSettings,
    build_payload,
    shade_gbuffer,
    tube_vertex_stage,
)
from linevis_tpu_torch.render.transfer_function import TransferFunction

__all__ = ["render_opaque", "render_opaque_image", "rasterize_gbuffer", "untile_gbuffer"]

_GBUF_KEYS = ["inv_w", "attr_w", "nx", "ny", "nz", "tx", "ty", "tz"]


def untile_gbuffer(csr, raster, settings: RasterSettings):
    """The raster pass's tiled (depth, id, planes) -> (gbuf dict of [H, W]
    images, depth [H, W])."""
    depth_t, id_t, attrs_t = raster

    def unp(x):
        return unpack_tiles(
            x, csr.tiles_x, csr.tiles_y, settings.tile_w, settings.tile_h,
            settings.width, settings.height,
        )

    gbuf = {"id": unp(id_t)}
    for key, buf in zip(_GBUF_KEYS, attrs_t):
        gbuf[key] = unp(buf)
    return gbuf, unp(depth_t)


def rasterize_gbuffer(mesh: TubeMesh, view_proj, settings: RasterSettings):
    """Mesh -> (gbuf dict of [H, W] images, depth, batch, overflow)."""
    with span("opaque.vertex"):
        batch = tube_vertex_stage(mesh, view_proj, settings.width, settings.height)
    with span("opaque.payload"):
        payload = build_payload(batch)  # [40, T]
    with span("opaque.bin"):
        csr = build_csr_binning(
            batch.tri_x, batch.tri_y, payload, batch.tri_valid,
            settings.width, settings.height, settings.tile_w, settings.tile_h,
            settings.chunk, settings.span_x, settings.span_y, settings.pairs_capacity,
        )
    with span("opaque.raster"):
        raster = raster_pallas.rasterize_gbuffer(
            csr, GBUFFER_PLANES, settings.tile_w, settings.tile_h
        )
    with span("opaque.untile"):
        gbuf, depth = untile_gbuffer(csr, raster, settings)
    return gbuf, depth, batch, csr.overflow


def render_opaque(
    mesh: TubeMesh,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    tf_table: torch.Tensor,
    settings: RasterSettings,
    ray_basis: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render the tube mesh -> [4, H, W] linear RGBA on the mesh's device."""
    gbuf, _depth, batch, _overflow = rasterize_gbuffer(mesh, view_proj, settings)
    with span("opaque.shade"):
        if ray_basis is None:
            ray_basis = _ray_basis_from_view_proj(view_proj)
        return shade_gbuffer(
            gbuf, tf_table, camera_position, ray_basis,
            batch.view_z_min, batch.view_z_max, settings,
        )


def _ray_basis_from_view_proj(view_proj: torch.Tensor) -> torch.Tensor:
    """The scaled camera ray basis from the view-projection matrix.

    Columns: right * tan(fovx/2), up * tan(fovy/2), forward, such that a
    pixel with NDC (u, v) has ray direction basis @ [u, v, 1] with unit
    view depth. view_proj = P @ V; the rows of V are right, up, -forward
    and P's row 3 is (0, 0, -1, 0), so view_proj[3, :3] = +forward and the
    x/y rows are right/up scaled by 1/tan of the half angles.
    """
    fwd = view_proj[3, :3]
    r = view_proj[0, :3]
    u = view_proj[1, :3]
    tx = torch.linalg.norm(r)
    ty = torch.linalg.norm(u)
    right = r / torch.clamp(tx, min=1e-12)
    up = u / torch.clamp(ty, min=1e-12)
    fwd = fwd / torch.clamp(torch.linalg.norm(fwd), min=1e-12)
    return torch.stack([right / tx, up / ty, fwd], dim=1)


def render_opaque_image(
    mesh: TubeMesh,
    camera: Camera,
    tf: Optional[TransferFunction] = None,
    settings: Optional[RasterSettings] = None,
    supersample: int = 1,
) -> np.ndarray:
    """Convenience host wrapper -> numpy [H, W, 4] linear RGBA."""
    tf = tf or TransferFunction.standard()
    settings = settings or RasterSettings(width=camera.width, height=camera.height)
    dev = mesh.positions.device
    cam = camera
    s = settings
    if supersample > 1:
        s = dataclasses.replace(
            settings, width=settings.width * supersample,
            height=settings.height * supersample,
        )
        cam = dataclasses.replace(camera, width=s.width, height=s.height)
    img = render_opaque(
        mesh,
        torch.as_tensor(cam.view_projection_matrix(), device=dev),
        torch.as_tensor(np.asarray(camera.position, np.float32), device=dev),
        torch.as_tensor(np.asarray(tf.table, np.float32), device=dev),
        s,
    )
    return hand_back(img, supersample)
