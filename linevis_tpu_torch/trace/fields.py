"""Analytic vector fields.

Counterpart of `linevis_tpu/trace/fields.py`: the Crawfis 2003 tornado
field, evaluated analytically (Crawfis's public tornado.c formula) so the
benchmark scene is reproducible without external data.
"""

from __future__ import annotations

import torch

__all__ = ["tornado_velocity"]


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
