"""Decoupled opacity optimization (Günther et al. 2017).

Counterpart of `linevis_tpu/render/opacity_optimization.py` (reference
`src/Renderers/OIT/OpacityOptimizationRenderer.*`). A frame:
1. `gather_importance`: the importance gather at reduced resolution, the
   capsule frame prep at the half-res size and the K-buffer in store mode
   'gather' (`rasterize_capsules_mlab`: the hand-written kernel on a CUDA
   scene), per pixel the K nearest front-face fragments as (depth,
   importance g_i, segment id);
2. `solve_vertex_opacity`, plain PyTorch on those nodes: Algorithm 1
   unrolled over the K nodes, alpha_i = p / (p + (1-g_i)^(2 lambda)
   (r g_f + q g_b)); the per-segment minimum (a scatter-min, which does not
   depend on order, so it is deterministic on the card too) and visibility;
   `s` Laplacian iterations along each line's segment chain; per-vertex
   opacities and the temporal blend with the previous frame's;
3. `final_render`: the full-res MLAB frame with the solved per-segment
   alpha rows (`render_tubes_mlab(opacity=1, seg_alpha=...)`).
`OpacityOptimizationRenderer` keeps the temporal state: the vertex
opacities and the post-move schedule of NUM_SMOOTHING_FRAMES solves.

Defaults mirror the reference (`OpacityOptimizationRenderer.hpp:197-206`):
q=2000, r=20, s=15, lambda=2, relaxation=0.1, temporal=0.15, half-res
opacity pass. With `band_axis` (a process group, `parallel/mesh.py`), rank
r gathers band r of the half-res frame and the per-segment minimum and
visibility are reduced over the ranks (MIN, MAX) before the smoothing,
which every rank runs on the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.kernels.raster_capsule_oit import rasterize_capsules_mlab
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.oit import render_tubes_mlab
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.tube_raster import (
    CapsuleScene,
    camera_tensors,
    prepare_capsule_frame,
)

__all__ = [
    "OpacityOptimizationSettings", "gather_settings", "prepare_gather_frame",
    "gather_importance", "segment_reductions", "smooth_vertex_opacity", "solve_vertex_opacity",
    "opacity_solve", "final_render", "OpacityOptimizationRenderer",
    "render_opacity_optimization",
]


@dataclasses.dataclass(frozen=True)
class OpacityOptimizationSettings:
    q: float = 2000.0
    r: float = 20.0
    s: int = 15
    lambda_: float = 2.0
    relaxation: float = 0.1
    temporal_smoothing: float = 0.15
    opacity_resolution_scale: float = 0.5  # half-res importance pass
    gather_k: int = 8
    render_k: int = 8


def gather_settings(settings: RasterSettings, oo: OpacityOptimizationSettings) -> RasterSettings:
    """The importance gather's raster settings: the frame scaled by
    `opacity_resolution_scale`, width floored to 32 and height to 16 pixels
    (at least one of each), as the JAX package rounds them."""
    scale = oo.opacity_resolution_scale
    w2 = max(int(settings.width * scale) // 32 * 32, 32)
    h2 = max(int(settings.height * scale) // 16 * 16, 16)
    return dataclasses.replace(settings, width=w2, height=h2)


def prepare_gather_frame(scene: CapsuleScene, view_proj, camera_position, proj_ab,
                         settings: RasterSettings, oo: OpacityOptimizationSettings,
                         band: Optional[int] = None, n_bands: int = 1):
    """The importance gather's frame prep -> (csr, params, raster settings).
    With `band`, band `band` of `n_bands` of the half-res frame, each of
    h2 // n_bands rows, as the JAX package cuts them: rows past n_bands
    bands are gathered by none, and a band need not be whole tiles."""
    s2 = gather_settings(settings, oo)
    if band is None:
        csr, params, _ = prepare_capsule_frame(scene, view_proj, camera_position, proj_ab, s2)
        return csr, params, s2
    band_h = s2.height // n_bands
    sb = dataclasses.replace(s2, height=band_h)
    csr, params, _ = prepare_capsule_frame(scene, view_proj, camera_position, proj_ab, sb,
                                           y_offset=band * band_h, full_height=s2.height)
    return csr, params, sb


def gather_importance(scene: CapsuleScene, view_proj, camera_position, proj_ab,
                      settings: RasterSettings, oo: OpacityOptimizationSettings,
                      band: Optional[int] = None, n_bands: int = 1):
    """Step 1: the half-res frame prep (of one band with `band`) and the
    importance gather -> (depths, importance, segment ids), each
    [gather_k, n_tiles, P]; empty nodes have depth 2.0."""
    csr, params, s2 = prepare_gather_frame(scene, view_proj, camera_position, proj_ab,
                                           settings, oo, band, n_bands)
    depths, vals, _ = rasterize_capsules_mlab(
        csr, params, s2.width, s2.height, s2.tile_w, s2.tile_h, oo.gather_k,
        s2.tf_color, s2.tf_opacity, store_mode="gather",
    )
    return depths, vals[0], vals[1]


def _shift_left(x):
    """x's left neighbour along dim 1, the first column repeated."""
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


def _shift_right(x):
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def segment_reductions(depths, g, sid, oo: OpacityOptimizationSettings, num_segments: int):
    """Step 2 and the per-segment reductions on gathered nodes (each [K,
    n_tiles, P]) -> (segment opacity: the minimum of its nodes' alphas, 1
    where it has none; visibility: 1 where it has a node), each [S]."""
    K = depths.shape[0]
    valid = depths < 1.5

    # Algorithm 1, unrolled over the K front-to-back nodes.
    g2 = torch.where(valid, g * g, 0.0)
    g_all = g2[0]
    for i in range(1, K):
        g_all = g_all + g2[i]
    g_f = torch.zeros_like(g_all)
    p_const = 1.0
    alphas = []
    for i in range(K):
        g_b = torch.clamp(g_all - g2[i] - g_f, min=0.0)
        a_i = p_const / (
            p_const
            + torch.clamp(1.0 - g[i], 0.0, 1.0) ** (2.0 * oo.lambda_)
            * (oo.r * g_f + oo.q * g_b)
        )
        alphas.append(torch.where(valid[i], a_i, 1.0))
        g_f = g_f + g2[i]
    alpha_nodes = torch.stack(alphas, dim=0)

    # Per-segment minimum and visibility. The float ids truncate as the JAX
    # package's .astype(int32) does (a tie window's i + 0.5 counts for i);
    # ids outside the scene are dropped. Empty nodes (most of them) would add
    # each reduction's identity to one segment; each goes to a slot of its
    # own past the S segments instead, so that the card's atomics do not all
    # meet on one address. The result is the same.
    S = num_segments
    ids = torch.where(valid, sid, 0.0).to(torch.int32).reshape(-1).long()
    keep = valid.reshape(-1) & (ids >= 0) & (ids < S)
    dev = depths.device
    n = ids.numel()
    idx = torch.where(keep, ids, S + torch.arange(n, device=dev))
    seg_opacity = torch.ones(S + n, dtype=torch.float32, device=dev).scatter_reduce(
        0, idx, alpha_nodes.reshape(-1), "amin", include_self=True)[:S]
    seg_visible = torch.zeros(S + n, dtype=torch.float32, device=dev).scatter_reduce(
        0, idx, keep.float(), "amax", include_self=True)[:S]
    return seg_opacity, seg_visible


def smooth_vertex_opacity(seg_opacity, seg_visible, prev_vertex_opacity,
                          oo: OpacityOptimizationSettings, num_lines: int, pts_per_line: int):
    """Steps 4-5: Laplacian smoothing along each line's segment chain, the
    per-vertex opacities and the temporal blend -> [num_lines, pts_per_line]."""
    L, Pm1 = num_lines, pts_per_line - 1
    op = seg_opacity.reshape(L, Pm1)
    vis = seg_visible.reshape(L, Pm1)
    vleft, vright = _shift_left(vis) > 0, _shift_right(vis) > 0
    for _ in range(oo.s):
        left = torch.where(vleft, _shift_left(op), op)
        right = torch.where(vright, _shift_right(op), op)
        op = op + oo.relaxation * (-op + 0.5 * left + 0.5 * right)

    # Per-vertex opacity: the mean of the adjacent segments, then the
    # temporal blend with the previous frame's.
    vert = torch.cat([op[:, :1], 0.5 * (op[:, :-1] + op[:, 1:]), op[:, -1:]], dim=1)
    vvert = torch.cat([vis[:, :1], torch.maximum(vis[:, :-1], vis[:, 1:]), vis[:, -1:]], dim=1)
    vert = torch.where(vvert > 0, vert, prev_vertex_opacity)
    t = oo.temporal_smoothing
    return (1.0 - t) * prev_vertex_opacity + t * vert


def solve_vertex_opacity(depths, g, sid, prev_vertex_opacity, oo: OpacityOptimizationSettings,
                         num_lines: int, pts_per_line: int, num_segments: int):
    """Steps 2-5 on gathered nodes (each [K, n_tiles, P]) -> the smoothed
    per-vertex opacities [num_lines, pts_per_line]."""
    seg_opacity, seg_visible = segment_reductions(depths, g, sid, oo, num_segments)
    return smooth_vertex_opacity(seg_opacity, seg_visible, prev_vertex_opacity, oo,
                                 num_lines, pts_per_line)


def opacity_solve(scene: CapsuleScene, view_proj, camera_position, proj_ab,
                  prev_vertex_opacity, settings: RasterSettings,
                  oo: OpacityOptimizationSettings, num_lines: int, pts_per_line: int,
                  band_axis=None):
    """Steps 1-5: importance gather -> smoothed per-vertex opacities [L, P].

    With `band_axis`, a process group of n ranks (or a 1-D DeviceMesh,
    `parallel/mesh.py`), rank r gathers band r of n of the half-res frame
    and the per-segment minimum and visibility are reduced over the group
    (MIN, MAX); every rank returns the same opacities."""
    if band_axis is None:
        depths, g, sid = gather_importance(scene, view_proj, camera_position, proj_ab,
                                           settings, oo)
        return solve_vertex_opacity(depths, g, sid, prev_vertex_opacity, oo, num_lines,
                                    pts_per_line, scene.num_segments)
    from linevis_tpu_torch.parallel.mesh import all_reduce, group_rank_size

    pg, band, n = group_rank_size(band_axis, scene.a.device)
    depths, g, sid = gather_importance(scene, view_proj, camera_position, proj_ab, settings, oo,
                                       band=band, n_bands=n)
    seg_opacity, seg_visible = segment_reductions(depths, g, sid, oo, scene.num_segments)
    seg_opacity = all_reduce(seg_opacity, "min", pg)
    seg_visible = all_reduce(seg_visible, "max", pg)
    return smooth_vertex_opacity(seg_opacity, seg_visible, prev_vertex_opacity, oo, num_lines,
                                 pts_per_line)


def final_render(scene: CapsuleScene, view_proj, camera_position, proj_ab, vertex_opacity,
                 settings: RasterSettings, K: int) -> torch.Tensor:
    """Step 6: the full-res MLAB frame (opacity 1: the solved vertex
    opacities are the alphas) with per-segment alpha rows -> [4, H, W]."""
    a0 = vertex_opacity[:, :-1].reshape(-1)
    a1 = vertex_opacity[:, 1:].reshape(-1)
    seg_alpha = torch.stack([a0, a1 - a0], dim=0)
    return render_tubes_mlab(scene, view_proj, camera_position, proj_ab, settings, K=K,
                             opacity=1.0, seg_alpha=seg_alpha)


class OpacityOptimizationRenderer:
    """Stateful frame renderer (temporal smoothing across frames), on the
    scene's device: construct per scene, call `render(camera)` per frame.
    The last view-projection is kept on the host, so a frame adds no
    device-to-host copy."""

    # Extra opacity-solve frames after a camera move, so the temporal blend
    # (temporal_smoothing=0.15) converges
    # (OpacityOptimizationRenderer.hpp:125-127: NUM_SMOOTHING_FRAMES=40).
    NUM_SMOOTHING_FRAMES = 40

    def __init__(
        self,
        scene: CapsuleScene,
        num_lines: int,
        pts_per_line: int,
        settings: RasterSettings,
        oo: OpacityOptimizationSettings = OpacityOptimizationSettings(),
    ):
        self.scene = scene
        self.num_lines = num_lines
        self.pts_per_line = pts_per_line
        self.settings = settings
        self.oo = oo
        self.vertex_opacity = torch.ones((num_lines, pts_per_line), dtype=torch.float32,
                                         device=scene.a.device)
        self._last_vp: Optional[np.ndarray] = None
        self.smoothing_frames_remaining = self.NUM_SMOOTHING_FRAMES

    def render(self, camera: Camera) -> torch.Tensor:
        """One frame -> [4, H, W] linear RGBA on the scene's device."""
        vp_np = np.asarray(camera.view_projection_matrix())
        if self._last_vp is None or not np.array_equal(self._last_vp, vp_np):
            # onHasMoved: restart the post-move smoothing schedule.
            self.smoothing_frames_remaining = self.NUM_SMOOTHING_FRAMES
            self._last_vp = vp_np
        cam = camera_tensors(camera, self.scene.a.device)
        if self.smoothing_frames_remaining > 0:
            self.vertex_opacity = opacity_solve(
                self.scene, *cam, self.vertex_opacity, self.settings, self.oo,
                self.num_lines, self.pts_per_line,
            )
            self.smoothing_frames_remaining -= 1
        return final_render(self.scene, *cam, self.vertex_opacity, self.settings,
                            self.oo.render_k)

    def settle(self, camera: Camera) -> torch.Tensor:
        """Run the full post-move smoothing schedule, return the final frame
        (the reference's converged steady state)."""
        img = self.render(camera)
        while self.smoothing_frames_remaining > 0:
            img = self.render(camera)
        return img


def render_opacity_optimization(
    scene: CapsuleScene,
    num_lines: int,
    pts_per_line: int,
    camera: Camera,
    settings: Optional[RasterSettings] = None,
    oo: OpacityOptimizationSettings = OpacityOptimizationSettings(),
    warmup_frames: int = 4,
) -> np.ndarray:
    """Convenience: a few frames to settle the temporal smoothing -> numpy
    [H, W, 4] linear RGBA."""
    settings = settings or RasterSettings(width=camera.width, height=camera.height)
    r = OpacityOptimizationRenderer(scene, num_lines, pts_per_line, settings, oo)
    img = None
    for _ in range(warmup_frames):
        img = r.render(camera)
    return hand_back(img)
