"""Analytic vector fields + structured-grid sampling.

Counterpart of `linevis_tpu/trace/fields.py`. The reference generates the
ABC flow analytically (`src/LineData/Flow/Loader/AbcFlowGenerator.cpp`) and
loads the classic Crawfis "Tornado" dataset from file; here the Crawfis 2003
tornado field is evaluated analytically (Crawfis's public tornado.c
formula) so scenes are reproducible without external data. The fields are
torch functions on the points' device; the grids are built on the host
(numpy arrays, as the JAX module returns them). Grid sampling mirrors the
trilinear interpolation of `StreamlineTracingGrid`
(`src/LineData/Flow/StreamlineTracingGrid.hpp`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "tornado_velocity", "abc_flow_velocity", "make_tornado_grid", "make_abc_flow_grid",
    "sample_grid_trilinear",
]


def tornado_velocity(p: torch.Tensor, time: float = 0.0) -> torch.Tensor:
    """Crawfis tornado velocity at p in [0,1]^3. p: [..., 3] -> [..., 3]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    xc = 0.5 + 0.1 * torch.sin(0.04 * time + 10.0 * z)
    yc = 0.5 + 0.1 * torch.cos(0.03 * time + 3.0 * z)
    r = 0.1 + 0.4 * z * z + 0.1 * z * torch.sin(8.0 * z)
    r2 = 0.2 + 0.1 * z
    temp = torch.sqrt((y - yc) ** 2 + (x - xc) ** 2)
    scale = torch.abs(r - temp)
    scale = torch.where(scale > r2, 0.8 - scale, torch.ones_like(scale))
    z0 = torch.clamp(0.1 * (0.1 - temp * z), min=0.0)
    temp = torch.sqrt(temp * temp + z0 * z0)
    eps = 1e-10
    scale = (r + r2 - temp) * scale / (temp + eps)
    scale = scale / (1.0 + z)
    vx = scale * (y - yc) + 0.1 * (x - xc)
    vy = scale * -(x - xc) + 0.1 * (y - yc)
    vz = scale * z0
    return torch.stack([vx, vy, vz], dim=-1)


def abc_flow_velocity(
    p: torch.Tensor,
    a: float = 1.7320508075688772,  # sqrt(3)
    b: float = 1.4142135623730951,  # sqrt(2)
    c: float = 1.0,
) -> torch.Tensor:
    """Arnold-Beltrami-Childress flow (reference AbcFlowGenerator.cpp)."""
    two_pi = 2.0 * np.pi
    x, y, z = p[..., 0] * two_pi, p[..., 1] * two_pi, p[..., 2] * two_pi
    vx = a * torch.sin(z) + c * torch.cos(y)
    vy = b * torch.sin(x) + a * torch.cos(z)
    vz = c * torch.sin(y) + b * torch.cos(x)
    return torch.stack([vx, vy, vz], dim=-1)


def _grid_points(res: int) -> torch.Tensor:
    axis = np.linspace(0.0, 1.0, res, dtype=np.float32)
    gz, gy, gx = np.meshgrid(axis, axis, axis, indexing="ij")
    return torch.from_numpy(np.stack([gx, gy, gz], axis=-1))


def make_tornado_grid(res: int = 64, time: float = 0.0) -> np.ndarray:
    """The tornado field sampled onto a [res, res, res, 3] float32 grid over
    [0,1]^3 (index order z, y, x), evaluated on the host."""
    return tornado_velocity(_grid_points(res), time=time).numpy()


def make_abc_flow_grid(res: int = 64) -> np.ndarray:
    return abc_flow_velocity(_grid_points(res)).numpy()


def sample_grid_trilinear(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a [Z, Y, X, C] grid at p in [0,1]^3 ([..., 3]).

    Out-of-bounds coordinates are clamped (matching the reference tracer's
    boundary clamp before termination checks).
    """
    nz, ny, nx = grid.shape[0], grid.shape[1], grid.shape[2]
    fx = torch.clamp(p[..., 0], 0.0, 1.0) * (nx - 1)
    fy = torch.clamp(p[..., 1], 0.0, 1.0) * (ny - 1)
    fz = torch.clamp(p[..., 2], 0.0, 1.0) * (nz - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, nx - 2)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, ny - 2)
    z0 = torch.clamp(torch.floor(fz).to(torch.int32), 0, nz - 2)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    tz = (fz - z0)[..., None]
    flat = grid.reshape(nz * ny * nx, -1)
    base = (z0.long() * ny + y0.long()) * nx + x0.long()

    def g(dz, dy, dx):
        return flat[base + ((dz * ny + dy) * nx + dx)]

    c00 = g(0, 0, 0) * (1 - tx) + g(0, 0, 1) * tx
    c01 = g(0, 1, 0) * (1 - tx) + g(0, 1, 1) * tx
    c10 = g(1, 0, 0) * (1 - tx) + g(1, 0, 1) * tx
    c11 = g(1, 1, 0) * (1 - tx) + g(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz
