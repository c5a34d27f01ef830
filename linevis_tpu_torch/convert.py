"""Carry state across from the JAX package as plain numpy arrays.

The system has no weights: its state is the scene. A caller holding a
`linevis_tpu` `CapsuleScene`, `PrismScene`, `TubeMesh`, `Trajectories`,
`SegmentGrid`, `Lbvh`, `SparseGrid`, `SuperVoxelGrid`, `LineDataScattering`
or packed wide-BVH groups array passes its fields as
numpy arrays (e.g. `{f.name: np.asarray(getattr(s, f.name)) for f in
dataclasses.fields(s)}`), and gets the port's counterpart back. The state
of an `OpacityOptimizationRenderer` carries over into the port's renderer
(`opacity_state_from_numpy`), and an `SvgfTemporalState` history into the
port's (`svgf_state_from_numpy`), so that a run can continue in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.core.trajectories import Trajectories
from linevis_tpu_torch.geometry.tubes import TubeMesh
from linevis_tpu_torch.kernels.ao_grid import SegmentGrid
from linevis_tpu_torch.ops.lbvh import Lbvh
from linevis_tpu_torch.render.denoiser import SvgfTemporalState
from linevis_tpu_torch.render.super_voxel import SuperVoxelGrid
from linevis_tpu_torch.render.tube_raster import CapsuleScene, PrismScene
from linevis_tpu_torch.scene.line_data_scattering import LineDataScattering
from linevis_tpu_torch.scene.sparse_grid import SparseGrid

__all__ = [
    "capsule_scene_from_numpy", "prism_scene_from_numpy", "tube_mesh_from_numpy",
    "trajectories_from_numpy", "segment_grid_from_numpy", "lbvh_from_numpy",
    "wide_groups_from_numpy", "opacity_state_from_numpy", "svgf_state_from_numpy",
    "sparse_grid_from_numpy", "super_voxel_grid_from_numpy", "line_data_scattering_from_numpy",
]


def capsule_scene_from_numpy(d, device="cuda") -> CapsuleScene:
    """{a, ba, attr0, dattr, mask, cap_a, radius} arrays -> CapsuleScene on `device`."""

    def t(name, dtype):
        return torch.tensor(np.asarray(d[name]), dtype=dtype, device=device)

    return CapsuleScene(
        a=t("a", torch.float32),
        ba=t("ba", torch.float32),
        attr0=t("attr0", torch.float32),
        dattr=t("dattr", torch.float32),
        mask=t("mask", torch.bool),
        cap_a=t("cap_a", torch.float32),
        radius=float(d["radius"]),
    )


def prism_scene_from_numpy(d, device="cuda") -> PrismScene:
    """{capsule: {CapsuleScene fields}, frames [12, S], n_sides} ->
    PrismScene on `device`."""
    return PrismScene(
        capsule=capsule_scene_from_numpy(d["capsule"], device),
        frames=torch.tensor(np.asarray(d["frames"]), dtype=torch.float32, device=device),
        n_sides=int(d["n_sides"]),
    )


def tube_mesh_from_numpy(d, device="cuda") -> TubeMesh:
    """{positions, normals, tangents [3, S, L, P], attrs [S, L, P], mask
    [L, P], triangles [3, T], triangle_mask [T], num_subdivisions} ->
    TubeMesh on `device`."""

    def t(name, dtype):
        return torch.tensor(np.asarray(d[name]), dtype=dtype, device=device)

    return TubeMesh(
        positions=t("positions", torch.float32),
        normals=t("normals", torch.float32),
        tangents=t("tangents", torch.float32),
        attrs=t("attrs", torch.float32),
        mask=t("mask", torch.bool),
        triangles=t("triangles", torch.int32),
        triangle_mask=t("triangle_mask", torch.bool),
        num_subdivisions=int(d["num_subdivisions"]),
    )


def trajectories_from_numpy(d) -> Trajectories:
    """{positions, attributes, mask, num_points[, attribute_names]} -> Trajectories."""
    return Trajectories(
        positions=np.asarray(d["positions"], np.float32),
        attributes=np.asarray(d["attributes"], np.float32),
        mask=np.asarray(d["mask"], bool),
        num_points=np.asarray(d["num_points"], np.int32),
        attribute_names=list(d.get("attribute_names", [])),
    )


def segment_grid_from_numpy(d, device="cuda") -> SegmentGrid:
    """{records [8, Ns + chunk], cell_start, cell_count [G^3], origin,
    inv_cell [3], resolution, chunk} -> SegmentGrid on `device`."""

    def t(name, dtype):
        return torch.tensor(np.asarray(d[name]), dtype=dtype, device=device)

    return SegmentGrid(
        records=t("records", torch.float32),
        cell_start=t("cell_start", torch.int32),
        cell_count=t("cell_count", torch.int32),
        origin=t("origin", torch.float32),
        inv_cell=t("inv_cell", torch.float32),
        resolution=int(d["resolution"]),
        chunk=int(d["chunk"]),
    )


def lbvh_from_numpy(d) -> Lbvh:
    """{left, right [N-1], node_min, node_max [2N-1, 3], leaf_prim [N]} ->
    Lbvh of host arrays (what `ops.wide_bvh.pack_wide_bvh` consumes)."""
    return Lbvh(
        left=np.asarray(d["left"], np.int32), right=np.asarray(d["right"], np.int32),
        node_min=np.asarray(d["node_min"], np.float32),
        node_max=np.asarray(d["node_max"], np.float32),
        leaf_prim=np.asarray(d["leaf_prim"], np.int32),
    )


def wide_groups_from_numpy(groups, device="cuda") -> torch.Tensor:
    """A packed 8-wide BVH [n_groups * 8, 128] -> float32 tensor on `device`
    (the `wide_groups` of `render_tubes_raytraced_wavefront`)."""
    return torch.tensor(np.asarray(groups), dtype=torch.float32, device=device)


def opacity_state_from_numpy(renderer, d):
    """Carry the temporal state of an opacity-optimization renderer into the
    port's `renderer` (in place; returned): {vertex_opacity [L, P],
    smoothing_frames_remaining, last_vp [4, 4] or None}, the JAX renderer's
    `vertex_opacity`, `smoothing_frames_remaining` and `_last_vp`. The
    opacities go to the renderer's device; the view-projection stays on the
    host."""
    renderer.vertex_opacity = torch.tensor(
        np.asarray(d["vertex_opacity"]), dtype=torch.float32,
        device=renderer.vertex_opacity.device)
    renderer.smoothing_frames_remaining = int(d["smoothing_frames_remaining"])
    vp = d.get("last_vp")
    renderer._last_vp = None if vp is None else np.asarray(vp)
    return renderer


def svgf_state_from_numpy(d, device="cuda") -> SvgfTemporalState:
    """{color [3, H, W], moments [2, H, W], length [H, W], position [3, H, W]}
    -> SvgfTemporalState on `device` (the history `svgf_temporal_denoise`
    carries from frame to frame)."""
    return SvgfTemporalState(**{
        name: torch.tensor(np.asarray(d[name]), dtype=torch.float32, device=device)
        for name in ("color", "moments", "length", "position")
    })


def sparse_grid_from_numpy(d, device="cuda") -> SparseGrid:
    """{bricks [n + 1, b+1, b+1, b+1], table [Zb, Yb, Xb], shape, block} ->
    SparseGrid on `device`."""
    return SparseGrid(
        bricks=torch.tensor(np.asarray(d["bricks"]), dtype=torch.float32, device=device),
        table=torch.tensor(np.asarray(d["table"]), dtype=torch.int32, device=device),
        shape=tuple(int(v) for v in d["shape"]), block=int(d["block"]))


def super_voxel_grid_from_numpy(d, device="cuda") -> SuperVoxelGrid:
    """{mu_c, mu_r_bar [Sz, Sy, Sx], size} -> SuperVoxelGrid on `device`."""
    return SuperVoxelGrid(
        mu_c=torch.tensor(np.asarray(d["mu_c"]), dtype=torch.float32, device=device),
        mu_r_bar=torch.tensor(np.asarray(d["mu_r_bar"]), dtype=torch.float32, device=device),
        size=int(d["size"]))


def line_data_scattering_from_numpy(d) -> LineDataScattering:
    """{trajectories: {Trajectories fields}, cloud_grid [Z, Y, X],
    exit_directions [N, 3] or None, name} -> LineDataScattering (host
    arrays, as the JAX scene holds them)."""
    return LineDataScattering(trajectories_from_numpy(d["trajectories"]),
                              np.asarray(d["cloud_grid"], np.float32),
                              exit_directions=d.get("exit_directions"), name=d.get("name", ""))
