"""Multi-view DataViews: an independent camera and renderer per view.

Counterpart of `linevis_tpu/render/data_view.py` (reference
`src/Widgets/DataView.{hpp:47,cpp}`: in the docked multi-view mode every
view has its own framebuffer, camera and line renderer over the shared scene
data). Headless, each `DataView` owns a Camera and a renderer of the
registry (with its own settings) drawing on `device`; a
`MultiViewCompositor` renders every view and tiles them into one image (the
dockspace layout reduced to a grid).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.renderer import create_renderer

__all__ = ["DataView", "MultiViewCompositor"]


class DataView:
    """One view: camera + renderer (+ its own settings) over shared data."""

    def __init__(
        self,
        rendering_mode: str = "Opaque",
        camera: Optional[Camera] = None,
        settings: Optional[SettingsMap] = None,
        name: str = "",
        device="cuda",
    ):
        self.name = name or rendering_mode
        self.rendering_mode = rendering_mode
        self.camera = camera or Camera()
        self.device = device
        self.renderer = create_renderer(rendering_mode, settings, device=device)
        self.line_data = None

    def set_line_data(self, line_data) -> None:
        self.line_data = line_data
        self.renderer.set_line_data(line_data)

    def set_renderer(self, rendering_mode: str, settings: Optional[SettingsMap] = None) -> None:
        self.rendering_mode = rendering_mode
        self.renderer = create_renderer(rendering_mode, settings, device=self.device)
        if self.line_data is not None:
            self.renderer.set_line_data(self.line_data)

    def render(self) -> np.ndarray:
        return self.renderer.render(self.camera)


class MultiViewCompositor:
    """Renders every DataView and tiles them into one [H, W, 4] image."""

    def __init__(self, views: List[DataView], gap: int = 2):
        self.views = views
        self.gap = gap

    def set_line_data(self, line_data) -> None:
        for v in self.views:
            v.set_line_data(line_data)

    def render(self) -> np.ndarray:
        n = len(self.views)
        cols = int(math.ceil(math.sqrt(n)))
        rows = int(math.ceil(n / cols))
        imgs = [v.render() for v in self.views]
        vh = max(im.shape[0] for im in imgs)
        vw = max(im.shape[1] for im in imgs)
        H = rows * vh + (rows - 1) * self.gap
        W = cols * vw + (cols - 1) * self.gap
        out = np.zeros((H, W, 4), np.float32)
        for i, im in enumerate(imgs):
            r, c = divmod(i, cols)
            y = r * (vh + self.gap)
            x = c * (vw + self.gap)
            out[y:y + im.shape[0], x:x + im.shape[1]] = im
        return out

    def sync_cameras(self, camera: Camera) -> None:
        """Lock all views to one camera (the reference's camera link)."""
        for v in self.views:
            v.camera = dataclasses.replace(camera, width=v.camera.width, height=v.camera.height)
