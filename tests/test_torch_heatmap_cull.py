"""The heat map kernel's tile cull (R5), through its PyTorch twin.

`kernels/spherical_heatmap.py:heatmap_tile_candidates` repeats the cull of
`csrc/spherical_heatmap.cu`: each tile of the map keeps the directions
within reach of its cap. Held here on the CPU: no (pixel, direction) pair
within the search radius falls outside its tile's candidates, and the sum
over each tile's candidates in direction order equals the plain version,
`heatmap_density_reference`, bit for bit. The kernel itself is held against
the plain version on the card (`tests/test_torch_cuda_kernels.py`).
"""

import numpy as np
import pytest
import torch

from linevis_tpu_torch.kernels import spherical_heatmap as shm
from linevis_tpu_torch.render.spherical_heatmap import mollweide_points


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))


def _in_range(pts, dirs):
    """[M, N] bool: the plain version's test, dist <= 0.1 in float32."""
    px, py, pz = pts.unbind(1)
    dist = shm._distance(px[:, None], py[:, None], pz[:, None],
                         dirs[None, :, 0], dirs[None, :, 1], dirs[None, :, 2])
    return dist <= shm.SEARCH_RADIUS


def _check(pts, width, dirs):
    """The cull keeps every pair in range, and the culled sum is the plain
    sum bit for bit. -> (pairs in range, candidates)."""
    tile_of, cand = shm.heatmap_tile_candidates(pts, width, dirs)
    inr = _in_range(pts, dirs)
    assert not bool((inr & ~cand[tile_of]).any())
    ref = shm.heatmap_density_reference(pts, dirs)
    culled = torch.full_like(ref, float("nan"))
    for t in torch.unique(tile_of).tolist():
        rows = tile_of == t
        culled[rows] = shm.heatmap_density_reference(pts[rows], dirs[cand[t]])
    assert torch.equal(culled, ref)
    return int(inr.sum()), int(cand.sum())


def _corner_dirs(pts, width, rng, tile=shm.TILE, steps=range(-3, 4)):
    """Directions at 0.1 (1 + k 2^-23) from the corner pixels of every tile,
    on both sides of the radius, in random directions."""
    m = pts.shape[0]
    rows = -(-m // width)
    corners = []
    for r0 in range(0, rows, tile[1]):
        for c0 in range(0, width, tile[0]):
            for r in (r0, min(r0 + tile[1], rows) - 1):
                for c in (c0, min(c0 + tile[0], width) - 1):
                    if r * width + c < m:
                        corners.append(r * width + c)
    p = pts[torch.tensor(corners)].double()
    out = []
    for k in steps:
        u = _unit(rng, p.shape[0]).double()
        out.append((p + shm.SEARCH_RADIUS * (1.0 + k * 2.0 ** -23) * u).float())
    d = torch.cat(out)
    return d[torch.isfinite(d).all(dim=1)]


def test_cull_keeps_directions_at_the_radius_of_tile_corners():
    rng = np.random.default_rng(0)
    pts, inside = mollweide_points(40, "cpu")  # 40 x 80: edge tiles, poles, outside the ellipse
    assert not bool(inside.all())
    dirs = _corner_dirs(pts, 80, rng)
    n_in, _ = _check(pts, 80, dirs)
    assert n_in > 100


@pytest.mark.parametrize("height", [1, 2, 31])
def test_cull_on_ragged_maps(height):
    rng = np.random.default_rng(height)
    pts, _ = mollweide_points(height, "cpu")
    fin = torch.isfinite(pts).all(dim=1)
    dirs = torch.cat([_unit(rng, 2000),
                      _corner_dirs(torch.where(fin[:, None], pts, torch.zeros_like(pts)),
                                   2 * height, rng)])
    _check(pts, 2 * height, dirs)


def test_cull_on_rows_that_do_not_fill_a_tile():
    rng = np.random.default_rng(3)
    pts = _unit(rng, 1000)  # rows of 37, the last one short: no map at all
    dirs = torch.cat([_unit(rng, 3000), _corner_dirs(pts, 37, rng)])
    _check(pts, 37, dirs)


def test_cull_with_no_directions():
    pts, _ = mollweide_points(24, "cpu")
    tile_of, cand = shm.heatmap_tile_candidates(pts, 48, torch.zeros((0, 3)))
    tx, ty = shm.heatmap_tiles(pts.shape[0], 48)
    assert cand.shape == (tx * ty, 0) and tx == -(-48 // shm.TILE[0])
    assert not bool(shm.heatmap_density_reference(pts, torch.zeros((0, 3))).any())


def test_cull_with_every_direction_in_one_cap():
    rng = np.random.default_rng(5)
    pts, _ = mollweide_points(32, "cpu")
    centre = pts[16 * 64 + 40]
    d = centre[None, :] + 0.03 * _unit(rng, 3000)
    dirs = d / torch.linalg.norm(d, dim=1, keepdim=True)
    n_in, n_cand = _check(pts, 64, dirs)
    assert n_in > 3000 and n_cand >= 3000


def test_cpu_path_and_arguments():
    """On the CPU the wrapper runs the plain version; the counts are the
    kernel's own (CUDA only); the tiles follow TILE; `heatmap_in_range`
    counts the pairs the plain version sums."""
    rng = np.random.default_rng(6)
    pts, _ = mollweide_points(20, "cpu")
    dirs = _unit(rng, 2000)
    tx, ty = shm.heatmap_tiles(pts.shape[0], 40)
    assert (tx, ty) == (-(-40 // shm.TILE[0]), -(-20 // shm.TILE[1]))
    assert torch.equal(shm.heatmap_density(pts, dirs, 40), shm.heatmap_density_reference(pts, dirs))
    assert torch.equal(shm.heatmap_in_range(pts, dirs), _in_range(pts, dirs).sum(dim=1))
    with pytest.raises(ValueError, match="counts"):
        shm.heatmap_density(pts, dirs, 40, torch.zeros((tx * ty, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="width"):
        shm.heatmap_density(pts, dirs, 0)
