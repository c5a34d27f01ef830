"""Triangle surface rendering through the tile-binned G-buffer pipeline.

Counterpart of `linevis_tpu/render/surface.py`. The tube raster's vertex
stage derives triangle corners from the tube grid; indexed meshes
(`TriangleMeshData.hpp:39` datasets, simulation hulls) gather their corner
data through the index buffer here, then share the same payload -> CSR
binning -> triangle raster (B3, `kernels/raster_pallas.py`) pipeline.
Shading uses the reference's general surface Blinn-Phong
(Lighting.glsl:66-72) rather than the tube halo model.

Surface triangles can be arbitrarily large on screen, so the binning window
(`span_x`, `span_y`) is sized per camera from the largest projected
triangle bounding box (`surface_span`, the JAX registry renderer's policy,
computed on the mesh's device with one host read).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from linevis_tpu_torch.kernels import raster_pallas
from linevis_tpu_torch.kernels.raster_pallas import build_csr_binning
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.lighting import (
    apply_depth_cue,
    blinn_phong_shade_surface,
    normalize3,
)
from linevis_tpu_torch.render.opaque import _ray_basis_from_view_proj
from linevis_tpu_torch.render.pipeline import (
    GBUFFER_PLANES,
    RasterSettings,
    TriangleBatch,
    build_payload,
)
from linevis_tpu_torch.render.transfer_function import TransferFunction, tf_eval_points

__all__ = [
    "SurfaceTensors", "surface_tensors", "surface_vertex_stage", "surface_span",
    "surface_frame", "shade_surface", "render_surface", "render_surface_image",
]


@dataclasses.dataclass
class SurfaceTensors:
    """A SurfaceMesh's arrays on one device."""

    vertices: torch.Tensor  # [V, 3] float32
    normals: torch.Tensor  # [V, 3] float32
    attributes: torch.Tensor  # [V] float32
    triangles: torch.Tensor  # [T, 3] int64

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])


def surface_tensors(mesh, device="cuda") -> SurfaceTensors:
    """`loaders.mesh_loader.SurfaceMesh` -> its arrays on `device`."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SurfaceTensors(
        vertices=f32(mesh.vertices), normals=f32(mesh.normals),
        attributes=f32(mesh.attributes),
        triangles=torch.as_tensor(np.asarray(mesh.triangles, np.int64), device=device),
    )


def _project(verts, view_proj, rows):
    """Rows `rows` of view_proj @ [verts, 1], each ((x m0 + y m1) + z m2) + m3
    in float32, unfused: a device's matrix product rounds by its library's
    FMA order, these operations round alike on the card and the CPU."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    return [((x * view_proj[r, 0] + y * view_proj[r, 1]) + z * view_proj[r, 2])
            + view_proj[r, 3] for r in rows]


def surface_vertex_stage(
    verts, normals, attrs, tris, view_proj, width, height, z_near=1e-4
) -> TriangleBatch:
    """Indexed mesh -> per-triangle corner batch (one gather per corner).
    The projection is `_project`'s, so a frame of sub-pixel triangles, whose
    edge constants cancel ~1e6 at 1080p, is the same on every device."""
    cx, cy, cz, w = _project(verts, view_proj, range(4))
    w_safe = torch.where(torch.abs(w) < z_near, z_near, w)
    inv_w = 1.0 / w_safe
    sx = (cx * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - cy * inv_w * 0.5) * height
    z_ndc = cz * inv_w

    idx = tris.T  # [3, T]

    def corners(v):
        return v[idx]  # [3, T]

    tri_w = corners(w)
    nrm = normals.T  # [3, V]
    return TriangleBatch(
        tri_x=corners(sx),
        tri_y=corners(sy),
        tri_z=corners(z_ndc),
        tri_valid=torch.all(tri_w > z_near, dim=0),
        corner_inv_w=corners(inv_w),
        corner_attr=corners(attrs),
        corner_normal=tuple(corners(nrm[c]) for c in range(3)),
        corner_tangent=tuple(torch.zeros_like(corners(sx)) for _ in range(3)),
        view_z_min=torch.min(torch.where(w > z_near, w, 3e38)),
        view_z_max=torch.max(torch.where(w > z_near, w, -3e38)),
    )


def surface_span(
    verts, tris, view_proj, width: int, height: int, tile_w: int, tile_h: int
) -> Tuple[int, int]:
    """The binning window (span_x, span_y) for this camera: the largest
    projected bounding box of a triangle with every corner in front, in
    tiles, rounded up, plus 2, at most the tile grid; 2 without such a
    triangle. The JAX registry renderer's numpy policy
    (`TriangleMeshRenderer.render`) in float32 on the vertices' device, one
    host read; its projection is `_project`'s where numpy's matrix products
    round in their own FMA order, so an extent within an ulp of an integer
    may round up on one side only."""
    cx, cy, cw = _project(verts, view_proj, (0, 1, 3))
    w = torch.where(torch.abs(cw) < 1e-4, 1e-4, cw)
    sx = torch.clamp((cx / w * 0.5 + 0.5) * width, -width, 2 * width)
    sy = torch.clamp((0.5 - cy / w * 0.5) * height, -height, 2 * height)
    tx, ty = sx[tris], sy[tris]  # [T, 3]
    ex = (tx.max(dim=1).values - tx.min(dim=1).values) / tile_w
    ey = (ty.max(dim=1).values - ty.min(dim=1).values) / tile_h
    front = (w[tris] > 0).all(dim=1)
    stats = torch.stack([
        front.any().float(),
        torch.where(front, ex, float("-inf")).max(),
        torch.where(front, ey, float("-inf")).max(),
    ]).tolist()
    if stats[0]:
        span_x, span_y = math.ceil(stats[1]) + 2, math.ceil(stats[2]) + 2
    else:
        span_x = span_y = 2
    return min(span_x, -(-width // tile_w)), min(span_y, -(-height // tile_h))


def surface_frame(mesh: SurfaceTensors, view_proj, settings: RasterSettings):
    """Vertex stage, payload and CSR binning -> (batch, csr)."""
    batch = surface_vertex_stage(
        mesh.vertices, mesh.normals, mesh.attributes, mesh.triangles, view_proj,
        settings.width, settings.height,
    )
    payload = build_payload(batch)
    csr = build_csr_binning(
        batch.tri_x, batch.tri_y, payload, batch.tri_valid,
        settings.width, settings.height, settings.tile_w, settings.tile_h,
        settings.chunk, settings.span_x, settings.span_y, settings.pairs_capacity,
    )
    return batch, csr


def shade_surface(csr, raster, batch, view_proj, camera_position,
                  settings: RasterSettings) -> torch.Tensor:
    """The raster pass's tiled (depth, id, planes) -> [4, H, W] linear RGBA."""
    _depth_t, id_t, attrs_t = raster

    def unp(x):
        return unpack_tiles(
            x, csr.tiles_x, csr.tiles_y, settings.tile_w, settings.tile_h,
            settings.width, settings.height,
        )

    seg_id = unp(id_t)
    inv_w, attr_w, nx, ny, nz = (unp(attrs_t[i]) for i in range(5))
    H, W = seg_id.shape
    dev = seg_id.device
    fg = seg_id >= 0
    inv_w = torch.clamp(inv_w, min=1e-12)
    view_z = 1.0 / inv_w
    attr = attr_w * view_z
    normal = normalize3(torch.stack([nx, ny, nz], dim=0) * view_z[None])

    basis = _ray_basis_from_view_proj(view_proj)
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :] * (2.0 / W) - 1.0
    v = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None] * (2.0 / H)
    dirs = (
        basis[:, 0][:, None, None] * u.expand(H, W)[None]
        + basis[:, 1][:, None, None] * v.expand(H, W)[None]
        + basis[:, 2][:, None, None]
    )
    pos = camera_position[:, None, None] + dirs * view_z[None]

    rgb, alpha = tf_eval_points(settings.tf_color, settings.tf_opacity, attr)
    color = blinn_phong_shade_surface(rgb, pos, normal, camera_position)
    if settings.depth_cue_strength > 0.0:
        color = apply_depth_cue(
            color, view_z, batch.view_z_min, batch.view_z_max,
            settings.depth_cue_strength,
        )
    bg = torch.tensor(settings.background_color, dtype=torch.float32, device=dev)
    out_rgb = torch.where(fg[None], color, bg[:3, None, None])
    out_a = torch.where(fg, alpha, bg[3])
    return torch.cat([out_rgb, out_a[None]], dim=0)


def render_surface(
    mesh: SurfaceTensors,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    settings: RasterSettings,
) -> torch.Tensor:
    """-> [4, H, W] linear RGBA on the mesh's device. B3 on a CUDA mesh, its
    plain version on a CPU mesh."""
    batch, csr = surface_frame(mesh, view_proj, settings)
    raster = raster_pallas.rasterize_gbuffer(
        csr, GBUFFER_PLANES, settings.tile_w, settings.tile_h
    )
    return shade_surface(csr, raster, batch, view_proj, camera_position, settings)


def render_surface_image(
    mesh,  # loaders.mesh_loader.SurfaceMesh or SurfaceTensors
    camera: Camera,
    tf: Optional[TransferFunction] = None,
    settings: Optional[RasterSettings] = None,
    device="cuda",
) -> np.ndarray:
    """Host wrapper -> numpy [H, W, 4] linear RGBA; a SurfaceMesh is
    uploaded to `device` first."""
    settings = settings or RasterSettings(width=camera.width, height=camera.height)
    if tf is not None:
        c_pts, o_pts = tf.as_static_points()
        settings = dataclasses.replace(settings, tf_color=c_pts, tf_opacity=o_pts)
    if not isinstance(mesh, SurfaceTensors):
        mesh = surface_tensors(mesh, device)
    dev = mesh.vertices.device
    img = render_surface(
        mesh,
        torch.as_tensor(camera.view_projection_matrix(), device=dev),
        torch.as_tensor(np.asarray(camera.position, np.float32), device=dev),
        settings,
    )
    return hand_back(img)
