"""Camera model: lookAt view + perspective projection + viewport mapping.

Counterpart of `linevis_tpu/render/camera.py` (host numpy). Conventions:
right-handed world, camera looks down -Z in view space, NDC depth in
[0, 1] (Vulkan-style), screen y increases downward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

__all__ = ["Camera", "look_at", "perspective"]


def look_at(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m.astype(np.float32)


def perspective(fovy: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """Vulkan-style projection: NDC z in [0, 1], y flipped handled later."""
    t = 1.0 / math.tan(fovy / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = z_far / (z_near - z_far)
    m[2, 3] = (z_far * z_near) / (z_near - z_far)
    m[3, 2] = -1.0
    return m.astype(np.float32)


@dataclasses.dataclass
class Camera:
    position: Tuple[float, float, float] = (0.0, 0.0, 0.8)
    look_at_point: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    # sgl SciVisApp default fovy: atan(1/2)*2 (~53.13 deg)
    fovy: float = 2.0 * math.atan(0.5)
    z_near: float = 0.01
    z_far: float = 100.0
    width: int = 800
    height: int = 600

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def view_matrix(self) -> np.ndarray:
        return look_at(self.position, self.look_at_point, self.up)

    def projection_matrix(self) -> np.ndarray:
        return perspective(self.fovy, self.aspect, self.z_near, self.z_far)

    def view_projection_matrix(self) -> np.ndarray:
        return (
            self.projection_matrix().astype(np.float64)
            @ self.view_matrix().astype(np.float64)
        ).astype(np.float32)

    def generate_rays(self):
        """Per-pixel primary rays: returns (origin [3], dirs [H, W, 3])."""
        v = self.view_matrix().astype(np.float64)
        right = v[0, :3]
        up = v[1, :3]
        fwd = -v[2, :3]
        th = math.tan(self.fovy / 2.0)
        ys = (1.0 - 2.0 * (np.arange(self.height) + 0.5) / self.height) * th
        xs = (2.0 * (np.arange(self.width) + 0.5) / self.width - 1.0) * th * self.aspect
        dirs = (
            fwd[None, None, :]
            + xs[None, :, None] * right[None, None, :]
            + ys[:, None, None] * up[None, None, :]
        )
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        return np.asarray(self.position, np.float32), dirs.astype(np.float32)

    def orbit(self, yaw: float, pitch: float, radius: float) -> "Camera":
        """New camera orbiting the look-at point (camera-flight helper)."""
        cx, cy, cz = self.look_at_point
        pos = (
            cx + radius * math.cos(pitch) * math.sin(yaw),
            cy + radius * math.sin(pitch),
            cz + radius * math.cos(pitch) * math.cos(yaw),
        )
        return dataclasses.replace(self, position=pos)
