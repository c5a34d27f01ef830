"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(the CPU test machine). Run on a GPU machine with

    python -m pytest tests/test_torch_cuda_kernels.py -q

Bars (kernel vs plain version, same inputs on the card): segment ids equal
on >= 99.9% of pixels, z_ndc and G-buffer within 1e-5 where they agree,
coverage within 2e-3. For the MLAB kernel: node depths and alpha within
1e-5 on >= 99.9% of pixels, features within 1e-5 there, composited RGBA
within 1e-4 on >= 99.9% of pixels (the composite's powf may differ from
torch.pow by an ulp). Kernels and plain versions are built without fast math
and FMA contraction, so they normally agree bit for bit.
"""

import numpy as np
import pytest
import torch

from linevis_tpu_torch.kernels.raster_capsule import (
    rasterize_capsules,
    rasterize_capsules_reference,
)
from linevis_tpu_torch.kernels.raster_capsule_oit import (
    rasterize_capsules_mlab,
    rasterize_capsules_mlab_reference,
)
from linevis_tpu_torch.render import oit as toit
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.pipeline import RasterSettings

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _walk(seed, L, P, radius):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


def _frame(device, W, H, tile, use_aa, scene=(11, 10, 8, 0.02)):
    cam = Camera(position=(0.1, 0.2, 1.4), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=tile[0], tile_h=tile[1], aa=use_aa)
    ts = ttr.build_capsule_scene(*_walk(*scene), device=device)
    csr, params, _ = ttr.prepare_capsule_frame(
        ts, *ttr.camera_tensors(cam, device), S, aa_margin=0.5 if use_aa else 0.0
    )
    return csr, params, S


def _check(k, p):
    agree = k[1] == p[1]
    assert agree.float().mean().item() >= 0.999
    for a, b in zip([k[0], *k[2][:7]], [p[0], *p[2][:7]]):
        assert (a - b).abs()[agree].max().item() <= 1e-5
    assert (k[2][7] - p[2][7]).abs()[agree].max().item() <= 2e-3


@pytest.mark.parametrize("use_aa", [False, True], ids=["aa_off", "aa_on"])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_capsule_kernel_matches_plain(cuda, tile, use_aa):
    W, H = 200, 120  # not a multiple of the tile: edge tiles are cropped
    csr, params, S = _frame(cuda, W, H, tile, use_aa)
    before = rasterize_capsules.launches
    k = rasterize_capsules(csr, params, W, H, *tile, use_aa=use_aa)
    assert rasterize_capsules.launches == before + 1
    p = rasterize_capsules_reference(csr, params, W, H, *tile, use_aa=use_aa)
    torch.cuda.synchronize()
    assert (k[1] >= 0).sum().item() > 100
    _check(k, p)


def test_early_z_preserves_result(cuda):
    """A dense scene whose tiles fill up, so the chunk exit fires."""
    W, H = 128, 64
    csr, params, _ = _frame(cuda, W, H, (16, 8), True, scene=(5, 60, 40, 0.05))
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32, device=cuda)
    fast = rasterize_capsules(csr, params, W, H, 16, 8, work=work)
    full = rasterize_capsules(csr, params, W, H, 16, 8, use_early_z=False)
    torch.cuda.synchronize()
    assert (work <= csr.tile_count).all()
    assert int(work.sum()) < int(csr.tile_count.sum())
    for a, b in zip([fast[0], fast[1], *fast[2]], [full[0], full[1], *full[2]]):
        assert torch.equal(a, b)


def test_render_tubes_card_matches_cpu(cuda):
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=32, tile_h=16, depth_cue_strength=0.2)
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(11, 10, 8, 0.02), device=dev)
        imgs.append(ttr.render_tubes(scene, *ttr.camera_tensors(cam, dev), S).cpu())
    assert bool(torch.isfinite(imgs[0]).all())
    assert (imgs[0] - imgs[1]).abs().mean().item() <= 2e-3


def _mlab_frame(device, W, H, tile):
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=tile[0], tile_h=tile[1], chunk=32,
                       depth_cue_strength=0.2)
    ts = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=device)
    csr, params = toit.prepare_mlab_frame(ts, *ttr.camera_tensors(cam, device), S, 0.4)
    return csr, params, S


@pytest.mark.parametrize(
    "mode,K", [("composite", 8), ("nodes", 8), ("no_overflow", 16), ("no_overflow", 32),
               ("two_sided", 8)],
)
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_mlab_kernel_matches_plain(cuda, tile, mode, K):
    W, H = 200, 120  # not a multiple of the tile: edge tiles are cropped
    csr, params, S = _mlab_frame(cuda, W, H, tile)
    kw = dict(K=K, tf_color=S.tf_color, tf_opacity=S.tf_opacity,
              composite=mode == "composite", no_overflow=mode == "no_overflow",
              two_sided=mode == "two_sided")
    before = rasterize_capsules_mlab.launches
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32, device=cuda)
    k = rasterize_capsules_mlab(csr, params, W, H, *tile, deferred_shade=True,
                                work=work, **kw)
    assert rasterize_capsules_mlab.launches == before + 1
    p_work = torch.zeros_like(work)
    p = rasterize_capsules_mlab_reference(csr, params, W, H, *tile, work=p_work, **kw)
    torch.cuda.synchronize()
    assert torch.equal(work, p_work)
    if mode == "composite":
        assert bool(torch.isfinite(k).all())
        assert ((k - p).abs().amax(dim=0) <= 1e-4).float().mean().item() >= 0.999
        assert (k[3] > 0).sum().item() > 100
        return
    (kd, kf, ka), (pd, pf, pa) = k, p
    assert (kd < 2.0).sum().item() > 100
    ok = ((kd - pd).abs().amax(dim=0) <= 1e-5) & ((ka - pa).abs().amax(dim=0) <= 1e-5)
    assert ok.float().mean().item() >= 0.999
    assert (kf - pf).abs().amax(dim=(0, 1))[ok].max().item() <= 1e-5


@pytest.mark.parametrize("renderer", ["render_tubes_mlab", "render_tubes_atomic_loop"])
def test_render_tubes_mlab_card_matches_cpu(cuda, renderer):
    """The MLAB frame (K=8) and the Atomic Loop frame (K=16, no_overflow,
    node mode) on the card, each one kernel launch, against the CPU."""
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, depth_cue_strength=0.2)
    render = getattr(toit, renderer)
    K = 8 if renderer == "render_tubes_mlab" else 16
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=dev)
        before = rasterize_capsules_mlab.launches
        imgs.append(render(scene, *ttr.camera_tensors(cam, dev), S, K=K, opacity=0.4).cpu())
        assert rasterize_capsules_mlab.launches == before + (dev.type == "cuda")
    assert bool(torch.isfinite(imgs[0]).all())
    assert (imgs[0][3] > 0).sum().item() > 100
    assert (imgs[0] - imgs[1]).abs().mean().item() <= 2e-3
