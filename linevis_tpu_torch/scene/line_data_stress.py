"""Principal stress line (PSL) scene model.

Counterpart of `linevis_tpu/scene/line_data_stress.py`; behavioral port of
`LineDataStress` (`src/LineData/LineDataStress.hpp:45`):
up to three principal-stress-direction line sets (`trajectoriesPs`),
per-direction enable flags (`:209-217` usedPsDirections), per-line
hierarchy levels with per-direction slider filtering (`:240-246`), seed
process animation ordering (`:168-177` appearance order), and degenerate
points. Multi-PS rendering merges the selected directions into one capsule
scene; the principal-stress index rides along for per-PS coloring. The
getters build the port's scenes and meshes on the `device` they are given
(the card unless the caller asks for the CPU); the hull's surface mesh is
a host `SurfaceMesh` for `render/surface.py`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from linevis_tpu_torch.core.trajectories import (
    Trajectories,
    normalize_attributes,
    normalize_trajectories,
    pad_trajectories,
)
from linevis_tpu_torch.core.transforms import apply_transform
from linevis_tpu_torch.loaders.stress_dat import (
    SimulationMeshHull,
    load_stress_trajectories_from_dat_v1,
    load_stress_trajectories_from_dat_v2,
    load_stress_trajectories_from_dat_v3,
)
from linevis_tpu_torch.scene.line_data import LineData

__all__ = ["LineDataStress", "BAND_RENDER_MODES"]

# Reference LineDataStress.hpp:224-229.
BAND_RENDER_MODES = ("RIBBONS", "EIGENVALUE_RATIO", "HYPERSTREAMLINES")

PS_NAMES = ("major", "medium", "minor")
# Reference per-PS default colors (red/yellow/blue legends,
# LineDataStress.cpp color map for the three principal directions).
PS_COLORS = ((1.0, 0.1, 0.1), (0.9, 0.8, 0.1), (0.1, 0.3, 1.0))


class LineDataStress(LineData):
    data_set_type = "stress"

    def __init__(
        self,
        trajectories_ps: List[Trajectories],
        ps_indices: List[int],
        hierarchy_levels_ps: Optional[List[np.ndarray]] = None,  # [Li, 3] each
        appearance_order_ps: Optional[List[np.ndarray]] = None,
        degenerate_points: Optional[np.ndarray] = None,  # [N, 3]
        band_right_vectors_ps: Optional[List[np.ndarray]] = None,  # [Li,P,3]
        principal_stresses_ps: Optional[List[np.ndarray]] = None,  # [Li,3,P]
        hull: Optional[SimulationMeshHull] = None,
        name: str = "",
    ):
        self.trajectories_ps = trajectories_ps
        self.ps_indices = list(ps_indices)
        self.hierarchy_levels_ps = hierarchy_levels_ps
        self.appearance_order_ps = appearance_order_ps
        self.degenerate_points = degenerate_points
        # v2/v3 band data: per-PS padded right vectors aligned with the
        # trajectories' padding; None when the file carries no bands.
        self.band_right_vectors_ps = band_right_vectors_ps
        # Per-PS padded (major, medium, minor) stresses [Li, 3, P] for
        # EIGENVALUE_RATIO / HYPERSTREAMLINES band sizing.
        self.principal_stresses_ps = principal_stresses_ps
        self.hull = hull
        # Band render mode (LineDataStress.hpp:224-229).
        self.band_render_mode = "RIBBONS"
        self.use_bands = band_right_vectors_ps is not None
        # Per-direction usage flags (reference usedPsDirections).
        self.used_ps_directions = [True] * len(trajectories_ps)
        # Per-direction hierarchy slider in [0, 1]: lines with hierarchy
        # level < slider are hidden (LineDataStress.hpp:240-246).
        self.hierarchy_sliders = [0.0] * len(trajectories_ps)
        # Seed process animation step (-1 = all lines; LineDataStress.hpp:168).
        self.seed_animation_step = -1

        merged = self._merge()
        super().__init__(merged, name=name)
        if trajectories_ps:
            self.attribute_names = list(trajectories_ps[0].attribute_names)

    # -- loading -----------------------------------------------------------
    @classmethod
    def load_from_dat(
        cls,
        filenames: Sequence[str],
        filenames_hierarchy: Sequence[str] = (),
        transform: Optional[np.ndarray] = None,
        version: int = 1,
        name: str = "",
    ) -> "LineDataStress":
        """Load PSL `.dat` files (versions 1/2/3; DataSetInformation
        `version` field, reference MainApp.cpp:2357-2369 dispatch)."""
        hull = None
        if version == 1:
            ps_indices, blocks = load_stress_trajectories_from_dat_v1(
                filenames, filenames_hierarchy
            )
        elif version == 2:
            ps_indices, blocks = load_stress_trajectories_from_dat_v2(filenames)
        elif version == 3:
            ps_indices, blocks, hull = load_stress_trajectories_from_dat_v3(
                filenames
            )
        else:
            raise ValueError(f"Unsupported stress .dat version {version}")
        trajs, hier, bands, stresses, appearance = [], [], [], [], []
        has_bands = any(b.band_points_right for b in blocks)
        for block in blocks:
            ragged = block.trajectories
            if transform is not None:
                ragged.positions = [
                    apply_transform(transform, p) for p in ragged.positions
                ]
            t = pad_trajectories(ragged)
            trajs.append(t)
            if block.hierarchy_levels and any(block.hierarchy_levels):
                h = np.zeros((t.num_lines, 3), np.float32)
                for i, levels in enumerate(block.hierarchy_levels[: t.num_lines]):
                    for j, v in enumerate(levels[:3]):
                        h[i, j] = v
                hier.append(h)
            else:
                hier.append(np.ones((t.num_lines, 3), np.float32))
            if has_bands:
                rv = np.zeros(t.positions.shape, np.float32)
                rv[..., 0] = 1.0
                for i, bp in enumerate(block.band_points_right[: t.num_lines]):
                    n = min(bp.shape[0], rv.shape[1])
                    if transform is not None:
                        bp = apply_transform(
                            transform, bp, is_direction=True
                        )
                    rv[i, :n] = bp[:n]
                    if n < rv.shape[1]:
                        rv[i, n:] = rv[i, n - 1]
                bands.append(rv)
            # Per-point principal stresses for EIGENVALUE_RATIO /
            # HYPERSTREAMLINES sizing: v3 attrs 9-11; v1 has them in the
            # per-point PS arrays.
            if version == 3 and t.attributes.shape[1] >= 12:
                stresses.append(t.attributes[:, 9:12])
            elif version == 1 and block.major_ps:
                st = np.zeros((t.num_lines, 3, t.max_points), np.float32)
                for i in range(min(t.num_lines, len(block.major_ps))):
                    for j, arr in enumerate(
                        (block.major_ps[i], block.medium_ps[i], block.minor_ps[i])
                    ):
                        n = min(arr.shape[0], t.max_points)
                        st[i, j, :n] = arr[:n]
                stresses.append(st)
            if block.appearance_orders:
                appearance.append(
                    np.asarray(block.appearance_orders, np.int32)
                )
        # Joint normalization across all PS directions
        # (normalizeTrajectoriesPsVertexPositions semantics).
        if trajs:
            all_lo = np.min([t.positions[t.mask].min(0) for t in trajs if t.mask.any()], axis=0)
            all_hi = np.max([t.positions[t.mask].max(0) for t in trajs if t.mask.any()], axis=0)
            aabb = np.stack([all_lo, all_hi]).astype(np.float32)
            trajs = [normalize_trajectories(t, aabb) for t in trajs]
            trajs = [normalize_attributes(t) for t in trajs]
            if hull is not None:
                hull = SimulationMeshHull(
                    vertices=_normalize_points(hull.vertices, aabb),
                    triangles=hull.triangles,
                    mesh_type=hull.mesh_type,
                )
        return cls(
            trajs,
            ps_indices or list(range(len(trajs))),
            hierarchy_levels_ps=hier,
            appearance_order_ps=appearance or None,
            band_right_vectors_ps=bands if has_bands else None,
            principal_stresses_ps=stresses or None,
            hull=hull,
            name=name or (filenames[0] if filenames else "stress"),
        )

    # -- PS selection / hierarchy filtering --------------------------------
    def set_used_ps_directions(self, flags: Sequence[bool]) -> None:
        self.used_ps_directions = list(flags)
        self._remerge()

    def set_hierarchy_slider(self, ps: int, value: float) -> None:
        self.hierarchy_sliders[ps] = float(value)
        self._remerge()

    # -- hierarchy mapping curve (StressLineHierarchyMappingWidget.hpp:46) --
    def set_hierarchy_mapping_curve(self, ps: int, points) -> None:
        """Editable opacity(hierarchy) piecewise-linear curve per PS
        direction: list of (hierarchy_level, opacity) control points.
        Applied as per-line opacity in the transparent renderers (the
        reference maps the curve into the opacity channel)."""
        if not hasattr(self, "hierarchy_mapping_curves"):
            self.hierarchy_mapping_curves = {}
        pts = sorted((float(x), float(y)) for x, y in points)
        self.hierarchy_mapping_curves[ps] = pts
        self.mark_dirty()

    def get_line_hierarchy_opacities(self) -> np.ndarray:
        """[L_merged] per-line opacity from the mapping curves (1.0 where
        no curve is set), aligned with the merged trajectories."""
        curves = getattr(self, "hierarchy_mapping_curves", {})
        out = []
        for i, t in enumerate(self.trajectories_ps):
            keep = self._line_keep_mask(i)
            n = int(keep.sum())
            if i in curves and self.hierarchy_levels_ps is not None:
                xs = np.asarray([p[0] for p in curves[i]], np.float32)
                ys = np.asarray([p[1] for p in curves[i]], np.float32)
                # Hierarchy channel: geometry level (index 2), matching
                # the slider filter's channel.
                h = self.hierarchy_levels_ps[i][keep, 2]
                out.append(np.interp(h, xs, ys).astype(np.float32))
            else:
                out.append(np.ones((n,), np.float32))
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def get_segment_opacity_rows(self) -> np.ndarray:
        """[2, S] (alpha0, dalpha) rows for the OIT kernel's
        alpha_from_rows mode: constant per line along each segment."""
        line_op = self.get_line_hierarchy_opacities()
        L, P = self.trajectories.positions.shape[:2]
        per_point = np.repeat(line_op[:, None], P, axis=1)
        a0 = per_point[:, :-1].reshape(-1)
        return np.stack([a0, np.zeros_like(a0)], axis=0).astype(np.float32)

    def set_seed_animation_step(self, step: int) -> None:
        self.seed_animation_step = int(step)
        self._remerge()

    def _line_keep_mask(self, i: int) -> np.ndarray:
        t = self.trajectories_ps[i]
        keep = np.ones((t.num_lines,), bool)
        if not self.used_ps_directions[i]:
            keep[:] = False
            return keep
        if self.hierarchy_levels_ps is not None:
            # Slider filters on the per-PS hierarchy channel (reference uses
            # the direction's own channel by default).
            ch = min(self.ps_indices[i], 2)
            keep &= self.hierarchy_levels_ps[i][:, ch] >= self.hierarchy_sliders[i]
        if self.seed_animation_step >= 0 and self.appearance_order_ps is not None:
            keep &= self.appearance_order_ps[i] <= self.seed_animation_step
        return keep

    def _merge(self) -> Trajectories:
        """Concatenate enabled PS direction sets into one padded container."""
        parts = []
        self._ps_of_line = []
        band_parts, stress_parts = [], []
        max_p = max((t.max_points for t in self.trajectories_ps), default=8)
        for i, t in enumerate(self.trajectories_ps):
            keep = self._line_keep_mask(i)
            mask = t.mask & keep[:, None]
            pad = max_p - t.max_points
            parts.append(
                (
                    np.pad(t.positions, ((0, 0), (0, pad), (0, 0)), mode="edge"),
                    np.pad(t.attributes, ((0, 0), (0, 0), (0, pad)), mode="edge"),
                    np.pad(mask, ((0, 0), (0, pad))),
                )
            )
            if self.band_right_vectors_ps is not None:
                band_parts.append(
                    np.pad(
                        self.band_right_vectors_ps[i],
                        ((0, 0), (0, pad), (0, 0)), mode="edge",
                    )
                )
            if self.principal_stresses_ps is not None and i < len(
                self.principal_stresses_ps
            ):
                stress_parts.append(
                    np.pad(
                        self.principal_stresses_ps[i],
                        ((0, 0), (0, 0), (0, pad)), mode="edge",
                    )
                )
            self._ps_of_line.append(
                np.full((t.num_lines,), self.ps_indices[i], np.int32)
            )
        # Merged band/stress arrays aligned with the merged trajectories.
        self.band_right_vectors = (
            np.concatenate(band_parts) if band_parts else None
        )
        self.principal_stresses = (
            np.concatenate(stress_parts) if stress_parts else None
        )
        if not parts:
            return Trajectories(
                np.zeros((0, 8, 3), np.float32),
                np.zeros((0, 0, 8), np.float32),
                np.zeros((0, 8), bool),
                np.zeros((0,), np.int32),
            )
        positions = np.concatenate([p[0] for p in parts])
        attributes = np.concatenate([p[1] for p in parts])
        mask = np.concatenate([p[2] for p in parts])
        self.line_ps_index = np.concatenate(self._ps_of_line)
        return Trajectories(
            positions=positions,
            attributes=attributes,
            mask=mask,
            num_points=mask.sum(1).astype(np.int32),
            attribute_names=(
                self.trajectories_ps[0].attribute_names
                if self.trajectories_ps
                else []
            ),
        )

    def _remerge(self) -> None:
        self.trajectories = self._merge()
        self.mark_dirty()

    # Reference hull appearance (LineData.hpp:470-475): sRGB(0.5) gray,
    # opacity 0.3, shaded.
    HULL_COLOR_LINEAR = (0.2140, 0.2140, 0.2140)
    HULL_OPACITY = 0.3

    # Degenerate points render as red sphere billboards with pointWidth =
    # STANDARD_LINE_WIDTH (OpaqueLineRenderer.cpp:212-213, hpp:97).
    show_degenerate_points = False

    def set_show_degenerate_points(self, value: bool) -> None:
        if value != self.show_degenerate_points:
            self.show_degenerate_points = bool(value)
            self.mark_dirty()

    def get_capsule_scene(self, device="cuda"):
        """Tube capsules + (optionally) degenerate-point spheres on `device`.

        A sphere is a zero-length capsule (the analytic kernel's cap
        tests render it exactly). Spheres carry attribute 1.0 — the TF's
        hot end — approximating the reference's fixed red point color."""
        scene = super().get_capsule_scene(device=device)
        if not self.show_degenerate_points or self.degenerate_points is None \
                or len(self.degenerate_points) == 0:
            return scene
        key = ("capsules+degen", self.line_width, self.selected_attribute_index, str(device))
        if key not in self._cache:
            dev = scene.a.device
            pts = torch.tensor(np.asarray(self.degenerate_points, np.float32),
                               device=dev).T  # [3, N]
            n = pts.shape[1]
            eps = torch.zeros((3, n), dtype=torch.float32, device=dev)
            eps[0] = self.line_width * 1e-3

            def full(v, dtype):
                return torch.full((n,), v, dtype=dtype, device=dev)

            self._cache[key] = dataclasses.replace(
                scene,
                a=torch.cat([scene.a, pts], dim=1),
                ba=torch.cat([scene.ba, eps], dim=1),
                attr0=torch.cat([scene.attr0, full(1.0, torch.float32)]),
                dattr=torch.cat([scene.dattr, full(0.0, torch.float32)]),
                mask=torch.cat([scene.mask, full(True, torch.bool)]),
                cap_a=torch.cat([scene.cap_a, full(1.0, torch.float32)]),
            )
        return self._cache[key]

    def get_hull_surface(self):
        """Simulation-mesh hull as a renderable SurfaceMesh (constant
        attribute; render with `render/surface.py` and a constant TF of the
        hull color, HULL_COLOR_LINEAR and HULL_OPACITY: the reference hull
        pass, LineData.hpp:470-475); None without a hull."""
        if self.hull is None:
            return None
        key = "hull_surface"
        if key not in self._cache:
            from linevis_tpu_torch.loaders.mesh_loader import (
                SurfaceMesh,
                compute_vertex_normals,
            )

            verts = np.asarray(self.hull.vertices, np.float32)
            tris = np.asarray(self.hull.triangles, np.int32)
            self._cache[key] = SurfaceMesh(
                vertices=verts,
                triangles=tris,
                normals=compute_vertex_normals(verts, tris),
                attributes=np.full((verts.shape[0],), 0.5, np.float32),
            )
        return self._cache[key]

    def get_line_ps_colors(self) -> np.ndarray:
        """[L, 3] per-line base color from the PS direction legend."""
        return np.asarray(
            [PS_COLORS[min(i, 2)] for i in self.line_ps_index], np.float32
        )

    # -- band geometry (v2/v3) ----------------------------------------------
    def set_band_render_mode(self, mode: str) -> None:
        if mode not in BAND_RENDER_MODES:
            raise ValueError(f"Unknown band render mode {mode!r}")
        self.band_render_mode = mode
        self.mark_dirty()

    def get_band_tube_mesh(
        self,
        band_width: float = 0.005,
        min_band_thickness: float = 0.15,
        num_subdivisions: int = 8,
        device="cuda",
    ):
        """Elliptic band tube mesh on `device` for the active band render mode
        (LineDataStress.cpp:2654-2692). Requires v2/v3 band data."""
        if self.band_right_vectors is None:
            raise ValueError("This dataset carries no band geometry (v1?)")
        from linevis_tpu_torch.geometry.bands import (
            build_band_tube_mesh,
            build_principal_stress_tube_mesh,
        )

        t = self.trajectories
        attr = t.attributes[:, self.selected_attribute_index]
        if self.band_render_mode == "RIBBONS":
            return build_band_tube_mesh(
                t.positions, t.mask, attr, self.band_right_vectors,
                band_width=band_width,
                min_band_thickness=min_band_thickness,
                num_subdivisions=num_subdivisions, device=device,
            )
        if self.principal_stresses is None:
            raise ValueError(
                f"{self.band_render_mode} needs per-point principal stresses"
            )
        return build_principal_stress_tube_mesh(
            t.positions, t.mask, attr, self.band_right_vectors,
            self.line_ps_index,
            self.principal_stresses[:, 0],
            self.principal_stresses[:, 1],
            self.principal_stresses[:, 2],
            band_width=band_width,
            hyperstreamline=(self.band_render_mode == "HYPERSTREAMLINES"),
            num_subdivisions=num_subdivisions, device=device,
        )


def _normalize_points(points: np.ndarray, aabb: np.ndarray) -> np.ndarray:
    """Uniform AABB normalization, matching normalize_trajectories."""
    lo, hi = aabb[0], aabb[1]
    center = 0.5 * (lo + hi)
    extent = float(np.max(hi - lo))
    scale = 1.0 / extent if extent > 0 else 1.0
    return ((points - center) * scale).astype(np.float32)
