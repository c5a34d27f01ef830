"""The tornado line set, written as a `.binlines` file that the program
loads as a user's dataset.

The field is the Crawfis tornado (2003) on [0, 1]^3; the lines start at
`num_seeds` uniform points drawn from the configuration's `trace_seed` (one
line set, as a deployment loads one file) and take `max_steps` RK4
steps of `dt`, each line ending where a step leaves the box or the speed
falls to 1e-6. The file holds each line's points, normalised into a box of
largest extent 1 centred at the origin, and their velocity magnitude,
min-max normalised; it says its vertices are normalised.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch


def tornado_velocity(p: torch.Tensor) -> torch.Tensor:
    """Crawfis tornado velocity at p [..., 3] in [0, 1]^3 (time 0)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    xc = 0.5 + 0.1 * torch.sin(10.0 * z)
    yc = 0.5 + 0.1 * torch.cos(3.0 * z)
    r = 0.1 + 0.4 * z * z + 0.1 * z * torch.sin(8.0 * z)
    r2 = 0.2 + 0.1 * z
    temp = torch.sqrt((y - yc) ** 2 + (x - xc) ** 2)
    scale = torch.abs(r - temp)
    scale = torch.where(scale > r2, 0.8 - scale, torch.ones_like(scale))
    z0 = torch.clamp(0.1 * (0.1 - temp * z), min=0.0)
    temp = torch.sqrt(temp * temp + z0 * z0)
    scale = (r + r2 - temp) * scale / (temp + 1e-10)
    scale = scale / (1.0 + z)
    vx = scale * (y - yc) + 0.1 * (x - xc)
    vy = scale * -(x - xc) + 0.1 * (y - yc)
    vz = scale * z0
    return torch.stack([vx, vy, vz], dim=-1)


def trace(seed: int, num_seeds: int, max_steps: int, dt: float):
    """-> (points [N, steps + 1, 3], valid [N, steps + 1], speed [N, steps + 1])
    on the host, float32."""
    starts = np.random.default_rng(seed).uniform(size=(num_seeds, 3)).astype(np.float32)
    p = torch.from_numpy(starts)
    alive = torch.ones(num_seeds, dtype=torch.bool)
    pts, valid = [p], [alive]
    for _ in range(max_steps):
        k1 = tornado_velocity(p)
        k2 = tornado_velocity(p + 0.5 * dt * k1)
        k3 = tornado_velocity(p + 0.5 * dt * k2)
        k4 = tornado_velocity(p + dt * k3)
        p_new = p + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        inside = torch.all((p_new >= 0.0) & (p_new <= 1.0), dim=-1)
        moving = torch.linalg.norm(tornado_velocity(p_new), dim=-1) > 1e-6
        alive = alive & inside & moving
        p = torch.where(alive[:, None], p_new, p)
        pts.append(p)
        valid.append(alive)
    pts = torch.stack(pts, 1)
    valid = torch.stack(valid, 1)
    speed = torch.linalg.norm(tornado_velocity(pts), dim=-1)
    return pts.numpy(), valid.numpy(), speed.numpy()


def write_binlines(path: str, pts: np.ndarray, valid: np.ndarray, attr: np.ndarray) -> None:
    """Version 2 `.binlines`: each line's valid points and one attribute,
    flagged as normalised."""
    lines = [i for i in range(pts.shape[0]) if valid[i].sum() >= 2]
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 2, len(lines), 1))
        for i in lines:
            n = int(valid[i].sum())
            f.write(struct.pack("<I", n))
            f.write(np.ascontiguousarray(pts[i, :n], "<f4").tobytes())
            f.write(np.ascontiguousarray(attr[i, :n], "<f4").tobytes())
        f.write(struct.pack("<IIIIII", 1, 0, 0, 0, 0, 0))


class Inputs:
    """The configuration's tornado: its file and how the renderer receives it."""

    def __init__(self, config: dict, workdir: str, device=None):
        pts, valid, speed = trace(config["trace_seed"], config["num_seeds"], config["max_steps"],
                                  config["dt"])
        m = valid[..., None]
        lo = np.where(m, pts, np.float32(3e38)).reshape(-1, 3).min(axis=0)
        hi = np.where(m, pts, np.float32(-3e38)).reshape(-1, 3).max(axis=0)
        pts = ((pts - 0.5 * (lo + hi)) * (1.0 / float(np.max(hi - lo)))).astype(np.float32)
        s_lo, s_hi = speed[valid].min(), speed[valid].max()
        attr = np.clip((speed - s_lo) / max(s_hi - s_lo, 1e-7), 0.0, 1.0).astype(np.float32)
        self.path = os.path.join(workdir, "tornado.binlines")
        write_binlines(self.path, pts, valid, attr)
        self.line_width = float(config["line_width"])
        self.segments = int((valid[:, :-1] & valid[:, 1:]).sum())

    def load(self, renderer) -> None:
        """Load the file as a user's dataset and hand it to the renderer."""
        from linevis_tpu_torch.scene.factory import load_line_data

        data = load_line_data(self.path)
        data.set_line_width(self.line_width)
        renderer.set_line_data(data)

    def prepare(self, renderer, mode: str) -> None:
        """Build the scene representation the mode draws from (the first
        frame would build it otherwise)."""
        data, dev = renderer.line_data, renderer.device
        if mode == "Opaque" and renderer.settings.get_value("tubeGeometry", "") == "triangle":
            data.get_tube_mesh(int(renderer.settings.get_float("tubeNumSubdivisions", 8)),
                               device=dev)
        else:
            data.get_capsule_scene(device=dev)

    def cleanup(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
