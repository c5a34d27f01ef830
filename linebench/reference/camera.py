"""The camera of a flight frame, worked out as LineVis does: a look-at view
and a Vulkan-style perspective (NDC depth in [0, 1]), composed in float64
and rounded to float32 once; the pixel-ray basis and the depth constants
taken from that matrix. The harness hands the program a camera built from
the same numbers (position, look-at point, field of view, planes, size)."""

from __future__ import annotations

import math

import numpy as np
import torch

FOVY = 2.0 * math.atan(0.5)
Z_NEAR, Z_FAR = 0.01, 100.0


def view_projection(position, width: int, height: int, look_at=(0.0, 0.0, 0.0),
                    up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """[4, 4] float32 view-projection matrix."""
    eye = np.asarray(position, np.float64)
    f = np.asarray(look_at, np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3], view[1, 3], view[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    view = view.astype(np.float32)
    t = 1.0 / math.tan(FOVY / 2.0)
    proj = np.zeros((4, 4), np.float64)
    proj[0, 0] = t / (width / height)
    proj[1, 1] = t
    proj[2, 2] = Z_FAR / (Z_NEAR - Z_FAR)
    proj[2, 3] = (Z_FAR * Z_NEAR) / (Z_NEAR - Z_FAR)
    proj[3, 2] = -1.0
    proj = proj.astype(np.float32)
    return (proj.astype(np.float64) @ view.astype(np.float64)).astype(np.float32)


def depth_constants() -> np.ndarray:
    """(A, Bc) of z_ndc = A - Bc / view_z, float32."""
    n, f = Z_NEAR, Z_FAR
    return np.array([f / (f - n), f * n / (f - n)], np.float32)


def ray_basis(vp: torch.Tensor) -> torch.Tensor:
    """[3, 3] columns (right / tan_x^2, up / tan_y^2, unit forward): a pixel
    at NDC (u, v) looks along basis @ (u, v, 1)."""
    fwd, r, u = vp[3, :3], vp[0, :3], vp[1, :3]
    tx, ty = torch.linalg.norm(r), torch.linalg.norm(u)
    return torch.stack([r / torch.clamp(tx * tx, min=1e-12), u / torch.clamp(ty * ty, min=1e-12),
                        fwd / torch.clamp(torch.linalg.norm(fwd), min=1e-12)], dim=1)
