"""`TriangleMeshData`: triangle surface datasets in the scene model.

Counterpart of `linevis_tpu/scene/triangle_mesh_data.py` (reference
`src/LineData/TriangleMesh/TriangleMeshData.hpp:39`): .obj/.stl surface
meshes rendered with the same shading / transfer-function stack as the line
datasets, with the computed curvature attribute as the default scalar. Its
renderer, the registry's "Opaque (Triangle Mesh)" mode, draws on `device`
(the card unless the caller asks for the CPU) from the mesh's arrays kept
there, cached on the data and dropped when it is marked dirty.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.loaders.mesh_loader import SurfaceMesh, load_surface_mesh
from linevis_tpu_torch.render.handback import hand_back

__all__ = ["TriangleMeshData", "TriangleMeshRenderer"]


class TriangleMeshData:
    data_set_type = "triangle_mesh"

    def __init__(self, mesh: SurfaceMesh, name: str = ""):
        self.name = name
        self.mesh = mesh
        self.attribute_names = ["Curvature"]
        self.selected_attribute_index = 0
        self.dirty = True
        self._cache: Dict = {}

    @classmethod
    def load_from_file(cls, filename: str, name: str = "",
                       normalize: bool = True) -> "TriangleMeshData":
        mesh = load_surface_mesh(filename)
        if normalize:
            v = mesh.vertices
            lo, hi = v.min(axis=0), v.max(axis=0)
            center = (lo + hi) * 0.5
            scale = 1.0 / max(float((hi - lo).max()), 1e-12)
            mesh.vertices = ((v - center) * scale).astype(np.float32)
        return cls(mesh, name=name or filename)

    @property
    def num_vertices(self) -> int:
        return int(self.mesh.vertices.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.mesh.triangles.shape[0])

    def get_aabb(self) -> np.ndarray:
        return np.stack(
            [self.mesh.vertices.min(axis=0), self.mesh.vertices.max(axis=0)]
        )

    def set_new_settings(self, settings: SettingsMap) -> None:
        pass

    def mark_dirty(self) -> None:
        self.dirty = True
        self._cache.clear()

    def get_surface_tensors(self, device="cuda"):
        """The mesh's arrays on `device` (`render.surface.SurfaceTensors`),
        uploaded once per device until the data is marked dirty."""
        from linevis_tpu_torch.render.surface import surface_tensors

        key = str(torch.device(device))
        if key not in self._cache:
            self._cache[key] = surface_tensors(self.mesh, device)
            self.dirty = False
        return self._cache[key]


class TriangleMeshRenderer:
    """Registry renderer drawing TriangleMeshData surfaces opaquely on
    `device`, tile 16x8. As the JAX renderer, it takes its settings through
    `set_new_settings` only: the constructor's map is not applied."""

    name = "Opaque (Triangle Mesh)"
    TILE_W, TILE_H = 16, 8

    def __init__(self, settings: Optional[SettingsMap] = None, device="cuda"):
        from linevis_tpu_torch.render.transfer_function import TransferFunction

        self.device = torch.device(device)
        self.line_data: Optional[TriangleMeshData] = None
        self.transfer_function = TransferFunction.standard()
        self.depth_cue_strength = 0.0

    def set_line_data(self, data) -> None:
        self.line_data = data

    def set_transfer_function(self, tf) -> None:
        self.transfer_function = tf

    def set_new_settings(self, settings) -> None:
        if settings.has_key("depth_cue_strength"):
            self.depth_cue_strength = settings.get_float("depth_cue_strength")

    def raster_settings(self, camera):
        """This camera's RasterSettings: the binning window from
        `render.surface.surface_span` on the mesh's device arrays, the
        transfer function as static points."""
        from linevis_tpu_torch.render.pipeline import RasterSettings
        from linevis_tpu_torch.render.surface import surface_span

        mesh = self.line_data.get_surface_tensors(self.device)
        vp = torch.as_tensor(camera.view_projection_matrix(), device=self.device)
        span_x, span_y = surface_span(mesh.vertices, mesh.triangles, vp, camera.width,
                                      camera.height, self.TILE_W, self.TILE_H)
        c_pts, o_pts = self.transfer_function.as_static_points()
        return RasterSettings(
            width=camera.width, height=camera.height,
            tile_w=self.TILE_W, tile_h=self.TILE_H,
            span_x=span_x, span_y=span_y,
            depth_cue_strength=self.depth_cue_strength,
            tf_color=c_pts, tf_opacity=o_pts,
        )

    def render(self, camera) -> np.ndarray:
        """-> numpy [H, W, 4] linear RGBA."""
        from linevis_tpu_torch.render.surface import render_surface

        img = render_surface(
            self.line_data.get_surface_tensors(self.device),
            torch.as_tensor(camera.view_projection_matrix(), device=self.device),
            torch.as_tensor(np.asarray(camera.position, np.float32), device=self.device),
            self.raster_settings(camera),
        )
        return hand_back(img)
