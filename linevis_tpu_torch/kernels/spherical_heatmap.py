"""The spherical heat map's RBF density (kernel R5).

`heatmap_density` computes the RBF sum of the JAX package's
`render_spherical_heatmap` (`linevis_tpu/render/spherical_heatmap.py:57-66`,
which materialises the [pixels, directions] distance matrix; no
`pl.pallas_call`): for each point on the unit sphere, the sum over the exit
directions within the search radius 0.1 of exp(-(3 dist / 0.1)^2). On a
CUDA tensor it launches `csrc/spherical_heatmap.cu` (one thread a pixel,
the directions staged through shared memory, added in direction order) and
counts the launch in `heatmap_density.launches`; on a CPU tensor it runs
the plain version, `heatmap_density_reference`, a loop over the directions
that adds each one's term to every pixel at once: it never builds the
[pixels, directions] matrix, and it adds in the kernel's order, direction
after direction, so the two agree bit for bit. (JAX's `jnp.sum(axis=1)`
sums each row in an order of its own: the port and JAX agree to float32
rounding of the sum.)
"""

from __future__ import annotations

import ctypes

import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.volume_common import vdiv

__all__ = ["heatmap_density", "heatmap_density_reference", "SEARCH_RADIUS", "RBF_EPSILON"]

SEARCH_RADIUS = 0.1  # DtPathTrace.cpp:85
RBF_EPSILON = 3.0  # DtPathTrace.cpp:86
_BAND_TERMS = 1 << 24  # (pixel, direction) distances the plain version holds at once


def _distance(px, py, pz, dx0, dy0, dz0):
    dx, dy, dz = px - dx0, py - dy0, pz - dz0
    return torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=0.0))


def heatmap_density_reference(pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the contract of
    `heatmap_density`): direction after direction, each one's term added to
    every pixel's sum. A direction that no pixel has in range would add
    exactly 0 to every sum, so it is skipped (found a band of pixels at a
    time, with the same distance arithmetic)."""
    px, py, pz = pts.float().unbind(1)
    dl = dirs.float()
    keep = torch.zeros(dl.shape[0], dtype=torch.bool, device=dl.device)
    band = max(1, _BAND_TERMS // max(dl.shape[0], 1))
    for s in range(0, px.shape[0], band):
        dist = _distance(px[s:s + band, None], py[s:s + band, None], pz[s:s + band, None],
                         dl[None, :, 0], dl[None, :, 1], dl[None, :, 2])
        keep |= (dist <= SEARCH_RADIUS).any(dim=0)
    dl = dl[keep]
    acc = torch.zeros_like(px)
    for d in dl.tolist() if dl.device.type == "cpu" else dl.unbind(0):
        dist = _distance(px, py, pz, d[0], d[1], d[2])
        q = vdiv(RBF_EPSILON * dist, SEARCH_RADIUS)
        acc = acc + torch.where(dist <= SEARCH_RADIUS, torch.exp(-(q * q)), torch.zeros_like(dist))
    return acc


def _launcher():
    fn = _build.load("spherical_heatmap").heatmap_density_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def heatmap_density(pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """RBF density of exit directions dirs [N, 3] at the points pts [M, 3]
    on the unit sphere -> [M] float32 on their device. A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version."""
    if pts.device.type == "cpu":
        return heatmap_density_reference(pts, dirs)
    if pts.device.type != "cuda":
        raise ValueError(f"heatmap_density: unsupported device {pts.device}")
    dev = pts.device
    for name, x in (("pts", pts), ("dirs", dirs)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or x.device != dev:
            raise ValueError(f"{name} must be float32 [., 3] on {dev}")
    p, d = pts.contiguous(), dirs.contiguous()
    val = torch.empty(p.shape[0], dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _launcher()(p.data_ptr(), p.shape[0], d.data_ptr(), d.shape[0], val.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spherical_heatmap kernel launch failed: CUDA error {rc}")
    heatmap_density.launches += 1
    return val


heatmap_density.launches = 0
