"""Render pipeline stages: structured vertex stage, plane payloads, shading.

Counterpart of `linevis_tpu/render/pipeline.py` (which replaces the
reference's `LinePassTriangleTubes.glsl` vertex and fragment shaders):
- the vertex stage projects the tube grid [3, S, L, P] with one matrix
  product and takes triangle corners by slicing
  (`geometry.tubes.corner_grids`);
- every interpolated fragment quantity (normal, tangent, attribute, 1/w) is
  a screen-space affine plane per triangle (q/w is affine in screen space),
  which the triangle rasterizer evaluates like its edges, so shading needs
  no per-pixel gathers beyond the transfer-function table;
- shading is elementwise over [H, W] images; the fragment position comes
  from the view depth and the camera ray basis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from linevis_tpu_torch.geometry.tubes import TubeMesh, corner_grids
from linevis_tpu_torch.render.lighting import (
    apply_depth_cue,
    blinn_phong_shade_tube,
    normalize3,
)

__all__ = [
    "RasterSettings", "TriangleBatch", "tube_vertex_stage", "build_payload",
    "shade_gbuffer", "GBUFFER_PLANES",
]

# Interpolated fragment quantities carried as planes (beyond edges/z/id):
# inv_w, attr/w, normal/w (xyz), tangent/w (xyz)
GBUFFER_PLANES = 8


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Static raster configuration."""

    width: int = 800
    height: int = 600
    tile_w: int = 16
    tile_h: int = 8
    # Padding columns appended to the sorted pair payload (layout contract
    # shared with the JAX package; the CUDA kernels bounds-check instead).
    chunk: int = 128
    span_x: int = 2
    span_y: int = 2
    # (tile, triangle) pair capacity of the CSR binning; 0 -> the default
    # policy of `kernels/raster_pallas.py:build_csr_binning_bbox`.
    pairs_capacity: int = 0
    background_color: tuple = (1.0, 1.0, 1.0, 1.0)
    depth_cue_strength: float = 0.0
    # Analytic coverage AA on the opaque capsule raster (the reference's
    # MSAA role). Off: exact binary hit test.
    aa: bool = True
    # Transfer function as static control points (pos, r, g, b linear RGB)
    # and (pos, alpha). Defaults to the reference's Standard.xml map.
    tf_color: tuple = (
        (0.0, 0.04373503, 0.07227185, 0.52711511),
        (0.25, 0.27889428, 0.44520119, 0.9911021),
        (0.5, 0.71569347, 0.71569347, 0.71569347),
        (0.75, 0.91309863, 0.33245152, 0.20507874),
        (1.0, 0.45641103, 0.00121411, 0.01938236),
    )
    tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0))


@dataclasses.dataclass
class TriangleBatch:
    """Per-triangle screen-space data, channels-first [.., T]."""

    tri_x: torch.Tensor  # [3, T] corner screen x
    tri_y: torch.Tensor  # [3, T]
    tri_z: torch.Tensor  # [3, T] NDC depth
    tri_valid: torch.Tensor  # [T]
    # Per-corner interpolants (q values at corners), [3, T] each
    corner_inv_w: torch.Tensor
    corner_attr: torch.Tensor
    corner_normal: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    corner_tangent: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    # Depth-cue range inputs
    view_z_min: torch.Tensor
    view_z_max: torch.Tensor


def tube_vertex_stage(
    mesh: TubeMesh,
    view_proj: torch.Tensor,  # [4, 4]
    width: int,
    height: int,
    z_near: float = 1e-4,
) -> TriangleBatch:
    """Project the tube grid and build per-triangle corner data."""
    S = mesh.num_subdivisions
    pos = mesh.positions  # [3, S, L, P]
    grid_shape = tuple(pos.shape[1:])
    flat = pos.reshape(3, -1)
    clip = view_proj[:3, :3] @ flat + view_proj[:3, 3][:, None]
    w = view_proj[3, :3] @ flat + view_proj[3, 3]
    w_safe = torch.where(torch.abs(w) < z_near, torch.full_like(w, z_near), w)
    inv_w = (1.0 / w_safe).reshape(grid_shape)
    clip = clip.reshape((3,) + grid_shape)
    w = w.reshape(grid_shape)
    sx = (clip[0] * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - clip[1] * inv_w * 0.5) * height
    z_ndc = clip[2] * inv_w

    def corners(g):
        return torch.stack([c.reshape(-1) for c in corner_grids(g, S)], dim=0)

    def corners3(g3):
        return tuple(corners(g3[c]) for c in range(3))

    tri_w = corners(w)
    # Validity: both segment endpoints valid and all corners in front of the
    # near plane (conservative near-plane cull; no clipping).
    seg_valid = mesh.mask[:, :-1] & mesh.mask[:, 1:]  # [L, P-1]
    tri_mask = seg_valid[None, None].expand((S, 2) + tuple(seg_valid.shape)).reshape(-1)
    tri_valid = tri_mask & torch.all(tri_w > z_near, dim=0)

    vmask = mesh.mask[None].expand((S,) + tuple(mesh.mask.shape))
    big = torch.full_like(w, 3e38)
    return TriangleBatch(
        tri_x=corners(sx),
        tri_y=corners(sy),
        tri_z=corners(z_ndc),
        tri_valid=tri_valid,
        corner_inv_w=corners(inv_w),
        corner_attr=corners(mesh.attrs),
        corner_normal=corners3(mesh.normals),
        corner_tangent=corners3(mesh.tangents),
        view_z_min=torch.min(torch.where(vmask, w, big)),
        view_z_max=torch.max(torch.where(vmask, w, -big)),
    )


def _edge_functionals(tri_x, tri_y):
    """Edge coefficients (9 rows, orientation-normalized; degenerate
    triangles get rejecting rows) and 1/|2 area|."""
    x0, x1, x2 = tri_x[0], tri_x[1], tri_x[2]
    y0, y1, y2 = tri_y[0], tri_y[1], tri_y[2]

    def edge(xi, yi, xj, yj):
        return yi - yj, xj - xi, xi * yj - xj * yi

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    area2 = a0 * x0 + b0 * y0 + c0
    sign = torch.where(area2 >= 0, 1.0, -1.0)
    degenerate = torch.abs(area2) < 1e-12
    zero = torch.zeros_like(area2)

    def fix(a, b, c):
        return (
            torch.where(degenerate, zero, a * sign),
            torch.where(degenerate, zero, b * sign),
            torch.where(degenerate, zero - 1.0, c * sign),
        )

    e = [*fix(a0, b0, c0), *fix(a1, b1, c1), *fix(a2, b2, c2)]
    inv_area = torch.where(degenerate, zero, 1.0 / torch.abs(area2))
    return e, inv_area


def build_payload(batch: TriangleBatch) -> torch.Tensor:
    """[40, T] rasterizer payload (see `kernels/raster_pallas.py`).

    Rows: 0-8 edges; 9-11 z plane; 12-14 id plane (0, 0, id); 15 zmin;
    16-18 inv_w plane; 19-21 attr/w; 22-30 normal/w; 31-39 tangent/w.
    A plane for a quantity u (affine in screen space) has coefficients
    sum_i u_i * E_i / |2A|, the structure of the depth plane.
    """
    e, inv_area = _edge_functionals(batch.tri_x, batch.tri_y)
    T = batch.tri_x.shape[1]
    dev = batch.tri_x.device

    def plane(u0, u1, u2):
        pa = (u0 * e[0] + u1 * e[3] + u2 * e[6]) * inv_area
        pb = (u0 * e[1] + u1 * e[4] + u2 * e[7]) * inv_area
        pc = (u0 * e[2] + u1 * e[5] + u2 * e[8]) * inv_area
        return [pa, pb, pc]

    rows = list(e)
    rows += plane(batch.tri_z[0], batch.tri_z[1], batch.tri_z[2])
    zero = torch.zeros(T, dtype=torch.float32, device=dev)
    rows += [zero, zero, torch.arange(T, dtype=torch.float32, device=dev)]
    # Conservative min depth, quantized down to the 1/1023 sort-bucket edge
    # of the binning's packed key, so chunk order and the kernel's early
    # exit agree exactly.
    zmin = torch.min(batch.tri_z, dim=0).values
    rows += [torch.floor(torch.clamp(zmin, 0.0, 1.0) * 1023.0) / 1023.0]
    iw = batch.corner_inv_w
    rows += plane(iw[0], iw[1], iw[2])

    def wplane(q):
        return plane(q[0] * iw[0], q[1] * iw[1], q[2] * iw[2])

    rows += wplane(batch.corner_attr)
    for c in range(3):
        rows += wplane(batch.corner_normal[c])
    for c in range(3):
        rows += wplane(batch.corner_tangent[c])
    return torch.stack(rows, dim=0).float()


def shade_gbuffer(
    gbuf: dict,
    tf_table: torch.Tensor,  # [N, 4]
    camera_position: torch.Tensor,  # [3]
    ray_basis: torch.Tensor,  # [3, 3]: columns scaled right, up, forward
    depth_min: torch.Tensor,
    depth_max: torch.Tensor,
    settings: RasterSettings,
    row0: int = 0,
    full_height: Optional[int] = None,
) -> torch.Tensor:
    """G-buffer -> [4, H, W] linear RGBA: elementwise math and the
    transfer-function table lookup.

    gbuf keys: 'id' [H, W] int32 (-1 background); 'inv_w', 'attr_w', 'nx',
    'ny', 'nz', 'tx', 'ty', 'tz' [H, W] float32 (all but inv_w still
    premultiplied by 1/w). A band of a frame (`parallel/mesh.py:_shade_band`)
    gives the full-frame row of its row 0 and the frame's height.
    """
    H, W = gbuf["id"].shape
    full_h = H if full_height is None else int(full_height)
    dev = gbuf["id"].device
    fg = gbuf["id"] >= 0
    inv_w = torch.clamp(gbuf["inv_w"], min=1e-12)
    view_z = 1.0 / inv_w
    attr = gbuf["attr_w"] * view_z
    normal = normalize3(torch.stack([gbuf["nx"], gbuf["ny"], gbuf["nz"]], dim=0))
    tangent = normalize3(torch.stack([gbuf["tx"], gbuf["ty"], gbuf["tz"]], dim=0))

    # Fragment position from the camera ray: ndc in [-1, 1].
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :] * (2.0 / W) - 1.0
    rows = torch.arange(H, dtype=torch.float32, device=dev) + float(row0)
    v = 1.0 - (rows + 0.5)[:, None] * (2.0 / full_h)
    u = u.expand(H, W)
    v = v.expand(H, W)
    dirs = (
        ray_basis[:, 0][:, None, None] * u[None]
        + ray_basis[:, 1][:, None, None] * v[None]
        + ray_basis[:, 2][:, None, None]
    )
    pos = camera_position[:, None, None] + dirs * view_z[None]

    n = tf_table.shape[0]
    tt = tf_table.T  # [4, N]
    f = torch.clamp(attr, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(f).long(), 0, n - 2)
    wgt = f - i0
    lut = [tt[c][i0] * (1.0 - wgt) + tt[c][i0 + 1] * wgt for c in range(4)]
    rgb = torch.stack(lut[:3], dim=0)
    alpha = lut[3]

    color = blinn_phong_shade_tube(rgb, pos, normal, tangent, camera_position)
    if settings.depth_cue_strength > 0.0:
        color = apply_depth_cue(
            color, view_z, depth_min, depth_max, settings.depth_cue_strength
        )
    bg = torch.tensor(settings.background_color, dtype=torch.float32, device=dev)
    out_rgb = torch.where(fg[None], color, bg[:3, None, None])
    out_a = torch.where(fg, alpha, bg[3])
    return torch.cat([out_rgb, out_a[None]], dim=0)
