"""`LineData` scene model: attributes, filters, cached device representations.

Counterpart of `linevis_tpu/scene/line_data.py` (reference abstract
`LineData`, `src/LineData/LineData.hpp:86`): it owns the attribute list and
selected attribute, a filter chain, per-attribute min/max statistics, and
caches every device representation with dirty-flag invalidation
(`rebuildInternalRepresentationIfNecessary`, `LineData.cpp:449-511`). The
getters build the port's capsule scene, prism scene and tube mesh on the
`device` they are given (the card unless the caller asks for the CPU); the
device is part of the cache key.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.core.trajectories import Trajectories, compute_trajectories_aabb
from linevis_tpu_torch.scene.filters import LineFilter

__all__ = ["LineData", "LineDataFlow"]

# Reference line-width default: STANDARD_LINE_WIDTH = 0.002
# (src/Renderers/LineRenderer.hpp:266-276); radius = width / 2.
STANDARD_LINE_WIDTH = 0.002


class LineData:
    """Base scene object for a loaded line dataset."""

    data_set_type = "lines"

    def __init__(self, trajectories: Trajectories, name: str = ""):
        self.name = name
        self.trajectories = trajectories
        self.attribute_names: List[str] = list(trajectories.attribute_names)
        self.selected_attribute_index: int = 0
        self.line_width: float = STANDARD_LINE_WIDTH
        self.filters: List[LineFilter] = []
        self.dirty: bool = True
        self._filter_mask: Optional[np.ndarray] = None
        self._cache: Dict = {}

    # -- statistics (LineData.hpp getters) --------------------------------
    @property
    def num_lines(self) -> int:
        return self.trajectories.num_lines

    @property
    def num_line_points(self) -> int:
        return int(self.trajectories.mask.sum())

    @property
    def num_line_segments(self) -> int:
        return int(self.trajectories.segment_mask().sum())

    def get_attribute_range(self, index: Optional[int] = None):
        idx = self.selected_attribute_index if index is None else index
        vals = self.trajectories.attributes[:, idx]
        m = self.trajectories.mask
        if not m.any():
            return (0.0, 1.0)
        return (float(vals[m].min()), float(vals[m].max()))

    def get_aabb(self) -> np.ndarray:
        return compute_trajectories_aabb(self.trajectories)

    # -- configuration -----------------------------------------------------
    def set_selected_attribute(self, index_or_name) -> None:
        if isinstance(index_or_name, str):
            index_or_name = self.attribute_names.index(index_or_name)
        if index_or_name != self.selected_attribute_index:
            self.selected_attribute_index = int(index_or_name)
            self.mark_dirty()

    def set_line_width(self, width: float) -> None:
        if width != self.line_width:
            self.line_width = float(width)
            self.mark_dirty()

    def add_filter(self, f: LineFilter) -> None:
        self.filters.append(f)
        self.mark_dirty()

    def clear_filters(self) -> None:
        if self.filters:
            self.filters = []
            self.mark_dirty()

    def set_new_settings(self, settings: SettingsMap) -> None:
        """Apply a settings map (reference setNewSettings mechanism)."""
        if settings.has_key("line_width"):
            self.set_line_width(settings.get_float("line_width"))
        if settings.has_key("attribute"):
            self.set_selected_attribute(settings.get_value("attribute"))

    def mark_dirty(self) -> None:
        self.dirty = True
        self._cache.clear()
        self._filter_mask = None

    # -- filtered data ------------------------------------------------------
    def get_filter_mask(self) -> np.ndarray:
        """[L] keep mask from the filter chain (filterData analogue)."""
        if self._filter_mask is None:
            mask = np.ones((self.num_lines,), bool)
            for f in self.filters:
                if f.enabled:
                    mask &= f.filter(self.trajectories)
            self._filter_mask = mask
        return self._filter_mask

    def get_filtered_point_mask(self) -> np.ndarray:
        """[L, P] point mask with filtered lines removed."""
        keep = self.get_filter_mask()
        return self.trajectories.mask & keep[:, None]

    def selected_attributes(self) -> np.ndarray:
        return self.trajectories.attributes[:, self.selected_attribute_index]

    # -- cached device representations (LineData.cpp:449-511 discipline) ----
    def _cached(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
            self.dirty = False
        return self._cache[key]

    def _lines(self):
        return (self.trajectories.positions, self.get_filtered_point_mask(),
                self.selected_attributes())

    def get_capsule_scene(self, device="cuda"):
        """Primary render representation: the port's CapsuleScene on `device`."""
        from linevis_tpu_torch.render.tube_raster import build_capsule_scene

        key = ("capsules", self.line_width, self.selected_attribute_index, str(device))
        return self._cached(key, lambda: build_capsule_scene(
            *self._lines(), radius=self.line_width / 2.0, device=device))

    def get_prism_scene(self, num_subdivisions: int = 8, device="cuda"):
        """Analytic N-gon prism representation — the reference's raster
        triangle-tube geometry (`Tubes.hpp:40`, `LineData.hpp:374-386`)."""
        from linevis_tpu_torch.render.tube_raster import build_prism_scene

        key = ("prisms", self.line_width, self.selected_attribute_index, num_subdivisions,
               str(device))
        return self._cached(key, lambda: build_prism_scene(
            *self._lines(), radius=self.line_width / 2.0, n_sides=num_subdivisions,
            device=device))

    def get_tube_mesh(self, num_subdivisions: int = 8, device="cuda"):
        """Triangle-tube representation (reference tubeNumSubdivisions=8)."""
        from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh

        key = ("tubes", self.line_width, self.selected_attribute_index, num_subdivisions,
               str(device))
        return self._cached(key, lambda: build_tube_triangle_mesh(
            *self._lines(), radius=self.line_width / 2.0,
            num_subdivisions=num_subdivisions, device=device))

    def get_line_segments(self, device="cuda"):
        """Flat per-segment lists on `device` (`geometry/segments.py`)."""
        from linevis_tpu_torch.geometry.segments import build_line_segments

        key = ("segments", self.selected_attribute_index, str(device))
        return self._cached(key, lambda: build_line_segments(*self._lines(), device=device))


class LineDataFlow(LineData):
    """Flow trajectories (reference `LineDataFlow`, LineDataFlow.hpp:35).

    Optional ribbon rendering (`LineDataFlow.hpp:158-161`): per-point
    ribbon right-vectors feed elliptic band geometry. Helicity bands
    (`:163-171`): the band right-vector rotates around the tangent
    proportionally to the helicity attribute times
    `helicity_rotation_factor`.
    """

    data_set_type = "flow"

    def __init__(self, trajectories: Trajectories, name: str = ""):
        super().__init__(trajectories, name=name)
        self.ribbon_directions: Optional[np.ndarray] = None  # [L, P, 3]
        self.use_ribbons = False
        self.helicity_rotation_factor = 1.0

    def set_ribbon_directions(self, dirs: np.ndarray) -> None:
        self.ribbon_directions = np.asarray(dirs, np.float32)
        self.use_ribbons = True
        self.mark_dirty()

    def get_ribbon_mesh(self, band_width: float = 0.005, num_subdivisions: int = 8,
                        device="cuda"):
        """Flow-ribbon band geometry on `device` from the ribbon right-vectors."""
        from linevis_tpu_torch.geometry.bands import build_band_tube_mesh

        if self.ribbon_directions is None:
            raise ValueError("no ribbon directions loaded/traced")
        key = ("ribbons", band_width, num_subdivisions, self.selected_attribute_index,
               str(device))
        return self._cached(key, lambda: build_band_tube_mesh(
            *self._lines(), self.ribbon_directions, band_width=band_width,
            num_subdivisions=num_subdivisions, device=device))

    def get_helicity_band_mesh(self, band_width: float = 0.005, num_subdivisions: int = 8,
                               helicity_attribute: str = "Helicity", device="cuda"):
        """Helicity-rotating bands on `device` (LineDataFlow.hpp:163-171): the
        right vector starts at the parallel-transport normal and accumulates
        a twist angle of helicity * factor per step."""
        key = ("helicity_bands", band_width, num_subdivisions,
               self.helicity_rotation_factor, str(device))
        return self._cached(key, lambda: self._helicity_band_mesh(
            band_width, num_subdivisions, helicity_attribute, device))

    def _helicity_band_mesh(self, band_width, num_subdivisions, helicity_attribute, device):
        from linevis_tpu_torch.geometry.bands import build_band_tube_mesh
        from linevis_tpu_torch.geometry.frames import parallel_transport_frames

        try:
            h_idx = self.attribute_names.index(helicity_attribute)
        except ValueError:
            h_idx = self.selected_attribute_index
        hel = torch.tensor(self.trajectories.attributes[:, h_idx], device=device)
        hmax = torch.clamp(torch.max(torch.abs(hel)), min=1e-12)
        angle = torch.cumsum(hel / hmax * self.helicity_rotation_factor, dim=1)
        pos = torch.tensor(self.trajectories.positions, device=device)
        m = torch.tensor(self.get_filtered_point_mask(), device=device)
        # The JAX package unpacks (tangents, normals, binormals) as (normals,
        # binormals, _), so its twist starts at the tangent and turns towards
        # the normal; the port keeps that (ROADMAP queue C).
        tangents, normals, _ = parallel_transport_frames(pos, m)
        right = (torch.cos(angle)[..., None] * tangents
                 + torch.sin(angle)[..., None] * normals)
        return build_band_tube_mesh(pos, m, self.selected_attributes(), right,
                                    band_width=band_width,
                                    num_subdivisions=num_subdivisions, device=device)

    @classmethod
    def load_from_file(cls, filename: str, name: str = "", transform=None,
                       attribute_names=None) -> "LineDataFlow":
        """A flow-line file (.obj, .binlines, .nc) through
        `loaders/flow_file.py`; `attribute_names` rename the first
        attributes."""
        from linevis_tpu_torch.loaders.flow_file import load_flow_trajectories_from_file

        traj = load_flow_trajectories_from_file(filename, transform=transform)
        obj = cls(traj, name=name or filename)
        if attribute_names:
            obj.attribute_names = list(attribute_names) + obj.attribute_names[
                len(attribute_names):
            ]
        return obj
