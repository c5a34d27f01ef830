"""The spherical heat map's RBF density (kernel R5).

`heatmap_density` computes the RBF sum of the JAX package's
`render_spherical_heatmap` (`linevis_tpu/render/spherical_heatmap.py:57-66`,
which materialises the [pixels, directions] distance matrix; no
`pl.pallas_call`): for each point on the unit sphere, the sum over the exit
directions within the search radius 0.1 of exp(-(3 dist / 0.1)^2). On a
CUDA tensor it launches `csrc/spherical_heatmap.cu` and counts the launch in
`heatmap_density.launches`: one block a TILE of the map culls the
directions to those within reach of its cap (`heatmap_tile_candidates` is
the cull's PyTorch twin, for the tests) and sums them in direction order.
On a CPU tensor it runs the plain version, `heatmap_density_reference`, a
loop over the directions that adds each one's term to every pixel at once:
it never builds the [pixels, directions] matrix, and it adds in the
kernel's order, direction after direction, so the two agree bit for bit.
(JAX's `jnp.sum(axis=1)` sums each row in an order of its own: the port and
JAX agree to float32 rounding of the sum.)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.kernels.volume_common import vdiv

__all__ = ["heatmap_density", "heatmap_density_reference", "heatmap_in_range",
           "heatmap_term_mismatches", "heatmap_tile_candidates", "heatmap_tiles", "SEARCH_RADIUS",
           "RBF_EPSILON", "TILE"]

SEARCH_RADIUS = 0.1  # DtPathTrace.cpp:85
RBF_EPSILON = 3.0  # DtPathTrace.cpp:86
TILE = (16, 8)  # the kernel's block: columns and rows of map pixels (HM_TW, HM_TH)
CULL_SCALE = 1.001  # HM_CULL_SCALE: the cap's reach over r_t + the radius
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


def heatmap_in_range(pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Plain count of the directions within the search radius of each point
    -> [M] int64, with the plain version's distance arithmetic."""
    px, py, pz = pts.float().unbind(1)
    dl = dirs.float()
    out = torch.zeros(px.shape[0], dtype=torch.int64, device=px.device)
    band = max(1, _BAND_TERMS // max(dl.shape[0], 1))
    for s in range(0, px.shape[0], band):
        dist = _distance(px[s:s + band, None], py[s:s + band, None], pz[s:s + band, None],
                         dl[None, :, 0], dl[None, :, 1], dl[None, :, 2])
        out[s:s + band] = (dist <= SEARCH_RADIUS).sum(dim=1)
    return out


def heatmap_tiles(m: int, width: int, tile=TILE):
    """The kernel's tiles of m points laid out as rows of `width`:
    (tiles across, tiles down)."""
    rows = -(-m // width)
    return -(-width // tile[0]), -(-rows // tile[1])


def heatmap_tile_candidates(pts: torch.Tensor, width: int, dirs: torch.Tensor, tile=TILE):
    """The kernel's cull in PyTorch: each tile's cap (the centre c of its
    finite points and r_t, the longest distance from c to one of them) and
    the directions within (r_t + 0.1) CULL_SCALE of c -> (each point's tile
    [M] int64, the candidates [tiles, N] bool, tiles row-major). The kernel
    sums its centre in another order, so its c and r_t may differ from these
    by rounding; both caps hold every direction in range of their tile."""
    m = pts.shape[0]
    tx, ty = heatmap_tiles(m, width, tile)
    i = torch.arange(m, device=pts.device)
    tile_of = (i // width // tile[1]) * tx + (i % width) // tile[0]
    p = pts.float()
    fin = torch.isfinite(p).all(dim=1)
    pf = torch.where(fin[:, None], p, torch.zeros_like(p))
    n_tiles = tx * ty
    cnt = torch.zeros(n_tiles, device=p.device).index_add_(0, tile_of, fin.float())
    c = torch.zeros((n_tiles, 3), device=p.device).index_add_(0, tile_of, pf)
    c = c / torch.clamp(cnt, min=1.0)[:, None]
    e = pf - c[tile_of]
    r2 = torch.where(fin, (e * e).sum(dim=1), torch.zeros_like(cnt[tile_of]))
    r2 = torch.zeros(n_tiles, device=p.device).scatter_reduce_(0, tile_of, r2, "amax")
    reach = (torch.sqrt(r2) + SEARCH_RADIUS) * CULL_SCALE
    ed = dirs.float()[None, :, :] - c[:, None, :]
    cand = ((ed * ed).sum(dim=2) <= (reach * reach)[:, None]) & (cnt > 0)[:, None]
    return tile_of, cand


def _launcher():
    fn = _build.load("spherical_heatmap").heatmap_density_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, p, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def heatmap_term_mismatches(device="cuda") -> int:
    """The float bit patterns d2, all 2^32 of them, on which the kernel's
    branch-free term (`csrc/spherical_heatmap.cu:hm_term`) differs from the
    IEEE library term its plain version computes, in value or in range: 0
    on a card whose build keeps the kernel exact. Card only."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("heatmap_term_mismatches runs on the card")
    fn = _build.load("spherical_heatmap").heatmap_term_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = fn(count.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"heatmap term check failed: CUDA error {rc}")
    return int(count)


def heatmap_density(pts: torch.Tensor, dirs: torch.Tensor, width: int,
                    counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RBF density of exit directions dirs [N, 3] at the points pts [M, 3]
    on the unit sphere -> [M] float32 on their device. The points are a map
    laid out as rows of `width` (the last row may be short), which the
    kernel cuts into TILE blocks. `counts`, an optional int64 [tiles, 2]
    CUDA tensor (`heatmap_tiles`, row-major), receives the kernel's
    candidates and pairs in range per tile. A CUDA tensor launches the
    kernel; a CPU tensor runs the plain version."""
    if width < 1:
        raise ValueError("width must be positive")
    tx, ty = heatmap_tiles(pts.shape[0], width)
    if counts is not None and (counts.dtype != torch.int64 or tuple(counts.shape) != (tx * ty, 2)
                               or counts.device != pts.device or not counts.is_contiguous()
                               or pts.device.type != "cuda"):
        raise ValueError(f"counts must be int64 [{tx * ty}, 2] on the points' CUDA device")
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
        rc = _launcher()(p.data_ptr(), p.shape[0], width, d.data_ptr(), d.shape[0], val.data_ptr(),
                         None if counts is None else counts.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spherical_heatmap kernel launch failed: CUDA error {rc}")
    heatmap_density.launches += 1
    return val


heatmap_density.launches = 0
