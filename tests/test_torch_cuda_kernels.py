"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(the CPU test machine). Run on a GPU machine with

    python -m pytest tests/test_torch_cuda_kernels.py -q

Bars (kernel vs plain version, same inputs on the card): for the capsule
kernel bit for bit (`torch.equal` on every output). For the MLAB kernel:
node depths and alpha within 1e-5 on >= 99.9% of pixels, features within
1e-5 there, composited RGBA within 1e-4 on >= 99.9% of pixels (the composite's powf may differ from
torch.pow by an ulp). For the accumulation kernel: counts exactly, the
WBOIT and MBOIT moment sums within 1e-5 of each pixel's scale (its sum of
weights, or b0) on >= 99.9% of pixels, the MBOIT resolve within 1e-4 (the
moment solves amplify an ulp of a moment); the importance gather bit for bit;
`use_bands` at the bars of its mode. For the prism and the triangle kernel: bit for bit
(`torch.equal` on every output), the triangle kernel also at the surface
frame's tile 16x8 with sub-pixel and hundred-tile triangles in one CSR; the
surface frame card against CPU at SSIM >= 0.999, mean abs <= 2e-3. For the AO grid kernel: every pair's flag
and every chunk's walked count equal. For the wavefront kernel: depths,
features, alpha and the per-block counts bit for bit. For the per-ray
traversal kernels (closest hit, MLAT, the whole re-cast loop): every output
and per-ray count bit for bit (the re-cast loop: every cast's (t, prim); its
color and transmittance within 1e-5, its powf against torch.pow). For the
volume kernels: the path tracer's tracking (R3) on a 1080p row in each of
its three modes and each interpolation, and the density march (R4) on a
whole 1080p frame, bit for bit (every output and per-ray event count); the
heat map's RBF sum (R5) bit for bit (its plain version adds the directions
in the kernel's order); R3 on a SparseGrid, decomposition tracking (R7) and
residual ratio tracking (R8, also its transmittance) bit for bit with their
plain versions, counts included (R7's events by kind too), also at ray
counts and offsets that stress their persistent warps' refills, and
`vpt_trace_rays` on the card with every
plain version patched to raise; the device threefry bit for bit against
`ops/threefry.py`, and R6 (`kernels/threefry_uniform.py`) bit for bit
against `ops/threefry.py:uniform`, also at the folded keys of the sharded
paths' ranks. One band of 3 at 1080p (`parallel/mesh.py`'s band layout):
B3 bit for bit, B2 at its composite and node bars. Kernels
and plain versions are built
without fast math and FMA contraction, so they normally agree bit for bit.
"""

import dataclasses


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
from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh
from linevis_tpu_torch.kernels import ao_grid as tao
from linevis_tpu_torch.kernels import bvh_closest_hit as tch
from linevis_tpu_torch.kernels import bvh_mlat as tml
from linevis_tpu_torch.kernels import bvh_wavefront as twf
from linevis_tpu_torch.kernels import raster_pallas as trp
from linevis_tpu_torch.kernels.raster_prism import (
    MAX_SIDES,
    rasterize_prisms,
    rasterize_prisms_reference,
)
from linevis_tpu_torch.render import oit as toit
from linevis_tpu_torch.render import opaque as top
from linevis_tpu_torch.render import pipeline as tpl
from linevis_tpu_torch.render import ray_tracer as trt
from linevis_tpu_torch.render import rtao as trtao
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.ops import lbvh as tlbvh
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


def _frame(device, W, H, tile, use_aa, scene=(11, 10, 8, 0.02), lines=None):
    cam = Camera(position=(0.1, 0.2, 1.4), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=tile[0], tile_h=tile[1], aa=use_aa)
    ts = ttr.build_capsule_scene(*(lines or _walk(*scene)), device=device)
    csr, params, _ = ttr.prepare_capsule_frame(
        ts, *ttr.camera_tensors(cam, device), S, aa_margin=0.5 if use_aa else 0.0
    )
    return csr, params, S


def _all_equal(k, p):
    for a, b in zip([k[0], k[1], *k[2]], [p[0], p[1], *p[2]]):
        assert torch.equal(a, b)


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
    _all_equal(k, p)


@pytest.mark.parametrize("use_aa", [False, True], ids=["aa_off", "aa_on"])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_capsule_kernel_start_caps_mid_line(cuda, tile, use_aa):
    """Lines broken by masked points: start caps (payload row 13) sit in
    mid-line, where the kernel evaluates them behind a uniform branch."""
    W, H = 200, 120
    pos, mask, attrs, radius = _walk(11, 10, 24, 0.02)
    mask[:, 4::5] = False  # every line breaks into five chains
    csr, params, _ = _frame(cuda, W, H, tile, use_aa, lines=(pos, mask, attrs, radius))
    runs = csr.payload[:, :int(csr.tile_count.sum())]  # the tiles' runs, in order
    capped = torch.unique(runs[9][runs[13] > 0.5])
    assert capped.numel() > 10  # more start caps than the 10 lines' own starts
    k = rasterize_capsules(csr, params, W, H, *tile, use_aa=use_aa)
    p = rasterize_capsules_reference(csr, params, W, H, *tile, use_aa=use_aa)
    torch.cuda.synchronize()
    assert (k[1] >= 0).sum().item() > 100
    _all_equal(k, p)


@pytest.mark.parametrize("use_aa", [False, True], ids=["aa_off", "aa_on"])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_capsule_kernel_long_runs_late_tiles(cuda, tile, use_aa):
    """Runs longer than one chunk of 128 candidates, on tiles past the
    middle of the index order (the kernel takes the longest runs first)."""
    W, H = 200, 120
    csr, params, _ = _frame(cuda, W, H, tile, use_aa, lines=_bundle())
    counts = csr.tile_count
    assert int(counts.max()) > 128
    assert int(counts.argmax()) > counts.numel() // 2
    p = rasterize_capsules_reference(csr, params, W, H, *tile, use_aa=use_aa)
    assert (p[1] >= 0).sum().item() > 50  # the bundle covers a small patch
    for early_z in (False, True):
        work = torch.zeros(counts.shape[0], dtype=torch.int32, device=cuda)
        k = rasterize_capsules(csr, params, W, H, *tile, use_early_z=early_z, use_aa=use_aa,
                               work=work)
        torch.cuda.synchronize()
        assert torch.equal(work, counts) if not early_z else bool((work <= counts).all())
        _all_equal(k, p)


def test_capsule_wrapper_rejects_bad_tiles(cuda):
    W, H = 64, 32
    csr, params, _ = _frame(cuda, W, H, (16, 8), True)
    for tile in ((12, 8), (16, 6), (64, 16)):  # not 8x4 blocks, or over 512 pixels
        with pytest.raises(ValueError):
            rasterize_capsules(csr, params, W, H, *tile)


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
    kw = dict(K=K, tf_color=S.tf_color, tf_opacity=S.tf_opacity, deferred_shade=True,
              composite=mode == "composite", no_overflow=mode == "no_overflow",
              two_sided=mode == "two_sided")
    before = rasterize_capsules_mlab.launches
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32, device=cuda)
    k = rasterize_capsules_mlab(csr, params, W, H, *tile, work=work, **kw)
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


@pytest.mark.parametrize("alpha_rows", [False, True], ids=["tf_alpha", "alpha_from_rows"])
@pytest.mark.parametrize("K", [8, 32])
def test_mlab_composite_femur_matches_plain(cuda, K, alpha_rows):
    """B2's composite on a small frame of config 4's Femur (opacity 0.45, the
    baseline camera, tile 16x8) at K=32, as the Per-Pixel Linked Lists mode
    takes it, and K=8, also with bench.py's per-segment alpha rows."""
    from linevis_tpu_torch.entry import femur_line_data

    W, H = 240, 136
    ld = femur_line_data()
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    seg_alpha = torch.tensor(ld.get_segment_opacity_rows(), device=cuda) if alpha_rows else None
    csr, params = toit.prepare_mlab_frame(ld.get_capsule_scene(device=cuda),
                                          *ttr.camera_tensors(cam, cuda), S, 0.45, seg_alpha)
    kw = dict(K=K, tf_color=S.tf_color, tf_opacity=S.tf_opacity, deferred_shade=True,
              composite=True, alpha_from_rows=alpha_rows)
    before = rasterize_capsules_mlab.launches
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32, device=cuda)
    k = rasterize_capsules_mlab(csr, params, W, H, 16, 8, work=work, **kw)
    assert rasterize_capsules_mlab.launches == before + 1
    p_work = torch.zeros_like(work)
    p = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, work=p_work, **kw)
    torch.cuda.synchronize()
    assert torch.equal(work, p_work)
    assert bool(torch.isfinite(k).all())
    assert ((k - p).abs().amax(dim=0) <= 1e-4).float().mean().item() >= 0.999
    assert (k[3] > 0).sum().item() > 500


@pytest.mark.parametrize("kernel", ["capsule", "mlab", "mboit"])
def test_degenerate_point_spheres_match_plain(cuda, kernel):
    """Config 4's Femur with degenerate-point spheres: capsules whose ba is
    (w * 1e-3, 0, 0). B1 (with AA), B2's composite and its MBOIT passes on
    them against their plain versions, at their bars; no non-finite value."""
    from linevis_tpu_torch.entry import femur_line_data
    from linevis_tpu_torch.kernels.raster_capsule_oit import rasterize_capsules_accum

    W, H = 240, 136
    ld = femur_line_data()
    rng = np.random.default_rng(3)
    ld.degenerate_points = rng.uniform(-0.4, 0.4, (40, 3)).astype(np.float32)
    ld.set_show_degenerate_points(True)
    scene = ld.get_capsule_scene(device=cuda)
    assert scene.num_segments == 72 * 47 + 40
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    if kernel == "capsule":
        S = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
        csr, params, _ = ttr.prepare_capsule_frame(scene, *ttr.camera_tensors(cam, cuda), S,
                                                   aa_margin=0.5)
        k = rasterize_capsules(csr, params, W, H, 32, 16, use_aa=True)
        p = rasterize_capsules_reference(csr, params, W, H, 32, 16, use_aa=True)
        torch.cuda.synchronize()
        assert (k[1] >= 72 * 47).sum().item() > 50  # sphere pixels
        _all_equal(k, p)
        return
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    if kernel == "mlab":
        csr, params = toit.prepare_mlab_frame(scene, *ttr.camera_tensors(cam, cuda), S, 0.45)
        kw = dict(K=8, tf_color=S.tf_color, tf_opacity=S.tf_opacity, deferred_shade=True,
                  composite=True)
        k = rasterize_capsules_mlab(csr, params, W, H, 16, 8, **kw)
        p = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(k).all())
        assert ((k - p).abs().amax(dim=0) <= 1e-4).float().mean().item() >= 0.999
        return
    csr, params, _ = toit.prepare_mboit_frame(scene, *ttr.camera_tensors(cam, cuda), S, 4, 0.45)
    args = (csr, params, W, H, 16, 8)
    before = rasterize_capsules_accum.launches
    gen = rasterize_capsules_mlab(*args, 2, S.tf_color, S.tf_opacity, store_mode="mboit_gen",
                                  n_mom=4)
    p_gen = rasterize_capsules_mlab_reference(*args, 2, S.tf_color, S.tf_opacity,
                                              store_mode="mboit_gen", n_mom=4)
    moments = torch.stack([gen[0][0], gen[1][0, 0], gen[1][1, 0], gen[0][1], gen[1][0, 1]])
    res = rasterize_capsules_mlab(*args, 1, S.tf_color, S.tf_opacity,
                                  store_mode="mboit_resolve", n_mom=4, moments=moments)
    p_res = rasterize_capsules_mlab_reference(*args, 1, S.tf_color, S.tf_opacity,
                                              store_mode="mboit_resolve", n_mom=4,
                                              moments=moments)
    torch.cuda.synchronize()
    assert rasterize_capsules_accum.launches == before + 2
    for a, b in ((gen, p_gen), (res, p_res)):
        ka = torch.cat([a[0], a[1].flatten(0, 1), a[2]])
        pa = torch.cat([b[0], b[1].flatten(0, 1), b[2]])
        assert bool(torch.isfinite(ka).all())
        assert torch.equal(ka, pa)


def _prism_frame(device, W, H, tile, n_sides, scene=(11, 10, 8, 0.02), lines=None):
    cam = Camera(position=(0.1, 0.2, 1.4), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=tile[0], tile_h=tile[1])
    ts = ttr.build_prism_scene(*(lines or _walk(*scene)), n_sides=n_sides, device=device)
    csr, params, _ = ttr.prepare_prism_frame(ts, *ttr.camera_tensors(cam, device), S)
    return csr, params


@pytest.mark.parametrize("n_sides", [3, 6, 8, MAX_SIDES])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_prism_kernel_matches_plain(cuda, tile, n_sides):
    W, H = 200, 120  # not a multiple of the tile: edge tiles are cropped
    csr, params = _prism_frame(cuda, W, H, tile, n_sides)
    before = rasterize_prisms.launches
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32, device=cuda)
    k = rasterize_prisms(csr, params, W, H, *tile, n_sides=n_sides, work=work)
    assert rasterize_prisms.launches == before + 1
    assert torch.equal(work, csr.tile_count)  # every candidate is evaluated
    p = rasterize_prisms_reference(csr, params, W, H, *tile, n_sides=n_sides)
    torch.cuda.synchronize()
    assert (k[1] >= 0).sum().item() > 100
    _all_equal(k, p)


def _bundle(seed=7, L=48, P=12, radius=0.003, center=(0.35, -0.2, 0.0)):
    """48 short random walks packed near `center`: a few tiles right of and
    below the screen's middle hold runs of several chunks."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.01, (L, P, 3)), axis=1).astype(np.float32)
    pos += np.asarray(center, np.float32) - pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


@pytest.mark.parametrize("n_sides", [3, 8])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_prism_kernel_long_runs_late_tiles(cuda, tile, n_sides):
    """Runs longer than one chunk of 128 candidates, on tiles past the
    middle of the index order (the kernel takes the longest runs first)."""
    W, H = 200, 120
    csr, params = _prism_frame(cuda, W, H, tile, n_sides, lines=_bundle())
    counts = csr.tile_count
    assert int(counts.max()) > 2 * 128
    assert int(counts.argmax()) > counts.numel() // 2
    work = torch.zeros(counts.shape[0], dtype=torch.int32, device=cuda)
    k = rasterize_prisms(csr, params, W, H, *tile, n_sides=n_sides, work=work)
    p = rasterize_prisms_reference(csr, params, W, H, *tile, n_sides=n_sides)
    torch.cuda.synchronize()
    assert torch.equal(work, counts)
    assert (k[1] >= 0).sum().item() > 100
    _all_equal(k, p)


def test_prism_wrapper_rejects_bad_inputs(cuda):
    W, H = 64, 32
    csr, params = _prism_frame(cuda, W, H, (16, 8), 8)
    for n_sides in (2, MAX_SIDES + 1):
        with pytest.raises(ValueError):
            rasterize_prisms(csr, params, W, H, 16, 8, n_sides=n_sides)
    bad = [
        dataclasses.replace(csr, payload=csr.payload.double()),
        dataclasses.replace(csr, payload=csr.payload.T.contiguous().T),
        dataclasses.replace(csr, payload=csr.payload[:24]),
        dataclasses.replace(csr, tile_start=csr.tile_start.cpu()),
        dataclasses.replace(csr, tile_count=csr.tile_count.long()),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            rasterize_prisms(b, params, W, H, 16, 8)
    with pytest.raises(ValueError):
        rasterize_prisms(csr, params, W, H, 24, 9)  # 216 pixels: not whole warps


def _triangle_csr(device, W, H, tile, chunk, rows=40, scene=(11, 10, 8, 0.02), lines=None):
    pos, mask, attrs, radius = lines or _walk(*scene)
    mesh = build_tube_triangle_mesh(pos, mask, attrs, radius=radius, device=device)
    cam = Camera(position=(0.1, 0.2, 1.4), width=W, height=H)
    vp = ttr.camera_tensors(cam, device)[0]
    batch = tpl.tube_vertex_stage(mesh, vp, W, H)
    payload = tpl.build_payload(batch)[:rows].contiguous()
    return trp.build_csr_binning(batch.tri_x, batch.tri_y, payload, batch.tri_valid,
                                 W, H, *tile, chunk, 4, 4)


@pytest.mark.parametrize("mode", ["depth", "gbuffer"])
@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_triangle_kernel_matches_plain(cuda, tile, chunk, mode):
    W, H = 200, 120  # not a multiple of the tile: edge tiles are cropped
    planes = 8 if mode == "gbuffer" else 0
    csr = _triangle_csr(cuda, W, H, tile, chunk, rows=40 if planes else 16)
    assert int(csr.overflow) == 0
    before = trp.rasterize_gbuffer.launches
    if planes:
        k = trp.rasterize_gbuffer(csr, planes, *tile)
    else:
        k = (*trp.rasterize_depth(csr, *tile), [])
    assert trp.rasterize_gbuffer.launches == before + 1
    p = trp.rasterize_triangles_reference(csr, *tile, planes)
    torch.cuda.synchronize()
    assert (k[1] >= 0).sum().item() > 100 and len(k[2]) == planes
    _all_equal(k, p)


def _layered_csr(device, W, H, tile, chunk, layers=5, seed=5):
    """Planes that cover the whole frame (edge planes (0, 0, 1)), one chunk
    of them per depth layer, each layer nearer than the one before: every
    row 15 is 0, so the CSR keeps their order and a pixel's winner changes
    chunk at nearly every chunk. Within a layer every depth plane comes
    twice (exact ties, ids in random order); the last layer repeats the
    depth planes of the one before it, so it never wins (a later chunk
    must be strictly nearer). -> (csr, ids of the last layer)."""
    rng = np.random.default_rng(seed)
    T = layers * chunk
    pay = np.zeros((40, T), np.float32)
    pay[[2, 5, 8]] = 1.0
    layer = np.arange(T) // chunk
    pay[9:11] = rng.uniform(-2e-4, 2e-4, (2, T))
    pay[11] = 0.85 - 0.15 * layer + rng.uniform(-0.05, 0.05, T)
    pay[9:12, 1::2] = pay[9:12, 0::2]  # ties inside each layer
    pay[9:12, T - chunk:] = pay[9:12, T - 2 * chunk:T - chunk]
    ids = rng.permutation(T).astype(np.float32)
    pay[14] = ids
    pay[16:] = rng.uniform(-1e-2, 1e-2, (24, T))
    pay[18::3] = rng.uniform(-1.0, 1.0, (8, T))
    tiles_x, tiles_y = -(-W // tile[0]), -(-H // tile[1])
    full = torch.ones(T, device=device)
    csr = trp.build_csr_binning_bbox(
        0 * full, W * full, 0 * full, H * full, torch.tensor(pay, device=device),
        full > 0, W, H, *tile, chunk, tiles_x, tiles_y, T * tiles_x * tiles_y)
    return csr, torch.tensor(ids[T - chunk:], device=device).int()


@pytest.mark.parametrize("mode", ["depth", "gbuffer"])
@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_triangle_kernel_winner_changes_chunk(cuda, tile, chunk, mode):
    """A pixel's winner moves to a later chunk several times: its planes
    must be the last winner's; an equal depth in a later chunk keeps the
    earlier winner, an equal depth in the same chunk goes to the lower id."""
    W, H = 200, 120
    planes = 8 if mode == "gbuffer" else 0
    csr, last_ids = _layered_csr(cuda, W, H, tile, chunk)
    assert int(csr.overflow) == 0
    stats = {}
    p = trp.rasterize_triangles_reference(csr, *tile, planes, stats=stats)
    k = trp.rasterize_gbuffer(csr, planes, *tile)
    torch.cuda.synchronize()
    n_pixels = p[0].numel()
    assert stats["takes"] > 3 * n_pixels  # four changes of chunk a pixel, nearly
    assert bool((p[1] >= 0).all()) and not bool(torch.isin(p[1], last_ids).any())
    _all_equal(k, p)


@pytest.mark.parametrize("mode", ["depth", "gbuffer"])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_triangle_kernel_long_runs_late_tiles(cuda, tile, mode):
    """Runs of several chunks on tiles past the middle of the index order
    (the kernel takes the longest runs first)."""
    W, H = 200, 120
    planes = 8 if mode == "gbuffer" else 0
    csr = _triangle_csr(cuda, W, H, tile, 16, lines=_bundle())
    nch = csr.tile_num_chunks
    assert int(nch.max()) > 4 and int(nch.argmax()) > nch.numel() // 2
    p = trp.rasterize_triangles_reference(csr, *tile, planes)
    for early_z in (False, True):
        work = torch.zeros(nch.shape[0], dtype=torch.int32, device=cuda)
        k = trp.rasterize_gbuffer(csr, planes, *tile, use_early_z=early_z, work=work)
        torch.cuda.synchronize()
        assert torch.equal(work, nch) if not early_z else bool((work <= nch).all())
        assert (k[1] >= 0).sum().item() > 50  # the bundle covers a small patch
        _all_equal(k, p)


def test_triangle_early_z_preserves_result(cuda):
    """A dense scene with several chunks per tile, so the chunk exit fires."""
    W, H = 128, 64
    csr = _triangle_csr(cuda, W, H, (16, 8), 16, scene=(5, 60, 40, 0.05))
    assert int(csr.tile_num_chunks.max()) > 2
    work = torch.zeros(csr.tile_chunk_base.shape[0], dtype=torch.int32, device=cuda)
    fast = trp.rasterize_gbuffer(csr, 8, 16, 8, work=work)
    full = trp.rasterize_gbuffer(csr, 8, 16, 8, use_early_z=False)
    torch.cuda.synchronize()
    assert (work <= csr.tile_num_chunks).all()
    assert int(work.sum()) < int(csr.tile_num_chunks.sum())
    _all_equal(fast, full)
    _all_equal(fast, trp.rasterize_triangles_reference(csr, 16, 8, 8))


def test_triangle_wrapper_rejects_bad_inputs(cuda):
    csr = _triangle_csr(cuda, 64, 32, (16, 8), 16)
    bad = [
        dataclasses.replace(csr, payload=csr.payload.double()),
        dataclasses.replace(csr, payload=csr.payload.transpose(1, 2)),
        dataclasses.replace(csr, payload=csr.payload[:16]),  # no room for 8 planes
        dataclasses.replace(csr, tile_chunk_base=csr.tile_chunk_base.cpu()),
        dataclasses.replace(csr, tile_num_chunks=csr.tile_num_chunks.long()),
        dataclasses.replace(csr, num_primitives=(1 << 24) + 1),  # ids beyond float32
    ]
    for b in bad:
        with pytest.raises(ValueError):
            trp.rasterize_gbuffer(b, 8, 16, 8)
    # The kernel stages 16 rows of two chunks: chunk 512 takes 64 KB (opted
    # in), chunk 2048 256 KB, past the 227 KB a block may have.
    wide = _triangle_csr(cuda, 64, 32, (16, 8), 512)
    _all_equal(trp.rasterize_gbuffer(wide, 8, 16, 8),
               trp.rasterize_triangles_reference(wide, 16, 8, 8))
    big = _triangle_csr(cuda, 64, 32, (16, 8), 2048)
    with pytest.raises(ValueError):
        trp.rasterize_gbuffer(big, 8, 16, 8)
    for tile in ((24, 4), (16, 3)):  # not whole warps of 2x2-pixel threads
        with pytest.raises(ValueError):
            trp.rasterize_gbuffer(csr, 8, *tile)


def _huge_and_subpixel_csr(device, W=320, H=200, seed=7):
    """Tile 16x8: 4000 triangles of 0.2-1.5 px (most cover no pixel centre)
    and 6 whose boxes span a hundred tiles and more, in one CSR, its binning
    window sized from the largest (as `render/surface.py:surface_span`)."""
    rng = np.random.default_rng(seed)

    def f(lo, hi, shape):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=device)

    n_small, n_big = 4000, 6
    centre = torch.cat([f(0, W, (2, 1, n_small)), f(0.2 * W, 0.8 * W, (2, 1, n_big))], dim=2)
    size = torch.cat([f(0.2, 1.5, (1, 1, n_small)), f(150, 300, (1, 1, n_big))], dim=2)
    xy = centre + size * f(-0.5, 0.5, (2, 3, n_small + n_big))
    T = n_small + n_big
    batch = tpl.TriangleBatch(
        tri_x=xy[0], tri_y=xy[1] * (H / W), tri_z=f(0.05, 0.95, (3, T)),
        tri_valid=torch.ones(T, dtype=torch.bool, device=device),
        corner_inv_w=f(0.5, 1.5, (3, T)), corner_attr=f(0, 1, (3, T)),
        corner_normal=tuple(f(-1, 1, (3, T)) for _ in range(3)),
        corner_tangent=tuple(f(-1, 1, (3, T)) for _ in range(3)),
        view_z_min=torch.tensor(0.0), view_z_max=torch.tensor(1.0),
    )
    ex = (batch.tri_x.max(0).values - batch.tri_x.min(0).values).max() / 16
    ey = (batch.tri_y.max(0).values - batch.tri_y.min(0).values).max() / 8
    span_x, span_y = int(torch.ceil(ex)) + 2, int(torch.ceil(ey)) + 2
    csr = trp.build_csr_binning(batch.tri_x, batch.tri_y, tpl.build_payload(batch),
                                batch.tri_valid, W, H, 16, 8, 128, span_x, span_y)
    return csr, span_x, span_y


@pytest.mark.parametrize("mode", ["depth", "gbuffer"])
def test_triangle_kernel_16x8_huge_and_subpixel(cuda, mode):
    """The surface frame's shape of B3: tile 16x8 (one warp of 2x2-pixel
    threads a tile), sub-pixel and hundred-tile triangles in one CSR."""
    csr, span_x, span_y = _huge_and_subpixel_csr(cuda)
    assert span_x * span_y >= 100 and int(csr.overflow) == 0
    assert int(csr.tile_num_chunks.max()) >= 1
    planes = 8 if mode == "gbuffer" else 0
    if not planes:
        csr = dataclasses.replace(csr, payload=csr.payload[:16].contiguous())
    before = trp.rasterize_gbuffer.launches
    work = torch.zeros(csr.tile_chunk_base.shape[0], dtype=torch.int32, device=cuda)
    k = trp.rasterize_gbuffer(csr, planes, 16, 8, work=work)
    assert trp.rasterize_gbuffer.launches == before + 1
    stats = {}
    p = trp.rasterize_triangles_reference(csr, 16, 8, planes, stats=stats)
    torch.cuda.synchronize()
    assert (k[1] >= 0).float().mean().item() > 0.15
    _all_equal(k, p)
    assert torch.equal(work, stats["work"])  # the chunks each tile evaluated


def test_surface_frame_card_matches_cpu(cuda):
    """The registry's "Opaque (Triangle Mesh)" on a displaced icosphere
    (5120 triangles) at 160x120, card against CPU (SSIM >= 0.999, mean abs
    <= 2e-3), one B3 launch a frame, B3 bit for bit with its plain version
    on the frame's CSR, the span equal on both devices."""
    from linevis_tpu_torch.entry import displaced_icosphere
    from linevis_tpu_torch.loaders.mesh_loader import (
        SurfaceMesh,
        compute_curvature_attribute,
        compute_vertex_normals,
    )
    from linevis_tpu_torch.render import renderer as trenderer
    from linevis_tpu_torch.render import surface as tsurf
    from linevis_tpu_torch.render.framebuffer import ssim
    from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData

    soup = displaced_icosphere(4)
    verts, inv = np.unique(soup.reshape(-1, 3), axis=0, return_inverse=True)
    tris = inv.reshape(-1, 3).astype(np.int32)
    normals = compute_vertex_normals(verts, tris)
    data = TriangleMeshData(SurfaceMesh(verts * np.float32(0.5), tris, normals,
                                        compute_curvature_attribute(verts, tris, normals)))
    cam = Camera(position=(0.3, 0.2, 1.0), look_at_point=(0, 0, 0), width=160, height=120)
    imgs, spans = [], []
    for dev in (cuda, torch.device("cpu")):
        r = trenderer.create_renderer("Opaque (Triangle Mesh)", device=dev)
        r.set_line_data(data)
        spans.append(r.raster_settings(cam))
        before = trp.rasterize_gbuffer.launches
        imgs.append(r.render(cam))
        assert trp.rasterize_gbuffer.launches == before + (dev.type == "cuda")
    assert spans[0] == spans[1]
    g, c = imgs
    assert np.isfinite(g).all() and 0.2 < (g[..., :3] < 0.999).any(-1).mean() < 0.95
    assert ssim(g[..., :3], c[..., :3]) >= 0.999 and np.abs(g - c).mean() <= 2e-3
    mesh = data.get_surface_tensors(cuda)
    _, csr = tsurf.surface_frame(mesh, ttr.camera_tensors(cam, cuda)[0], spans[0])
    k = trp.rasterize_gbuffer(csr, 8, 16, 8)
    _all_equal(k, trp.rasterize_triangles_reference(csr, 16, 8, 8))


@pytest.mark.parametrize("geometry", ["prism", "triangle"])
def test_render_prism_and_triangle_card_matches_cpu(cuda, geometry):
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=32, tile_h=16, depth_cue_strength=0.2)
    pos, mask, attrs, radius = _walk(11, 10, 8, 0.02)
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        vp, cp, ab = ttr.camera_tensors(cam, dev)
        if geometry == "prism":
            before = rasterize_prisms.launches
            scene = ttr.build_prism_scene(pos, mask, attrs, radius, device=dev)
            imgs.append(ttr.render_tubes_prism(scene, vp, cp, ab, S).cpu())
            assert rasterize_prisms.launches == before + (dev.type == "cuda")
        else:
            before = trp.rasterize_gbuffer.launches
            mesh = build_tube_triangle_mesh(pos, mask, attrs, radius=radius, device=dev)
            table = torch.as_tensor(top.TransferFunction.standard().table, device=dev)
            imgs.append(top.render_opaque(mesh, vp, cp, table, S).cpu())
            assert trp.rasterize_gbuffer.launches == before + (dev.type == "cuda")
    assert bool(torch.isfinite(imgs[0]).all())
    assert (imgs[0][:3] < 0.999).any()
    assert (imgs[0] - imgs[1]).abs().mean().item() <= 2e-3


def _ao_inputs(device, n_rays, seed=3, t_max=0.2, scene=(12345, 12, 6, 0.03)):
    """Rays from near the tube surfaces of a walk scene, expanded into pair
    chunks over its grid (resolution 16)."""
    ts = ttr.build_capsule_scene(*_walk(*scene), device=device)
    grid = tao.build_segment_grid(ts.a, ts.ba, ts.radius, ts.mask, resolution=16)
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, ts.num_segments, n_rays)
    u = rng.uniform(0, 1, n_rays).astype(np.float32)
    a, ba = ts.a.cpu().numpy(), ts.ba.cpu().numpy()
    o = (a[:, seg] + u * ba[:, seg] + rng.normal(0, 0.04, (3, n_rays))).astype(np.float32)
    d = rng.normal(0, 1, (3, n_rays)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    rays = [torch.as_tensor(x, device=device) for x in (o, d)]
    rays.append(torch.full((n_rays,), t_max, device=device))
    rays.append(torch.ones(n_rays, dtype=torch.bool, device=device))
    return ts, grid, rays


@pytest.mark.parametrize("n_rays", [1000, 4096, 77])
def test_ao_kernel_matches_plain(cuda, n_rays):
    """Chunk counts that are no multiple of 8, chunks with seg_chunks == 0
    (the dropped pairs' tail), chunks that walk several record chunks."""
    ts, grid, rays = _ao_inputs(cuda, n_rays)
    pairs = tao.expand_ray_pairs(*rays, grid)
    n_chunks = pairs.seg_begin.shape[0]
    assert (pairs.seg_chunks == 0).any() and (pairs.seg_chunks > 0).any()
    walked = torch.zeros(n_chunks, dtype=torch.int32, device=cuda)
    tests = torch.zeros_like(walked)
    before = tao.trace_pairs.launches
    k = tao.trace_pairs(pairs.rays, pairs.seg_begin, pairs.seg_chunks, grid.records,
                        grid.chunk, walked=walked, tests=tests)
    assert tao.trace_pairs.launches == before + 1
    p_walked, p_tests = torch.zeros_like(walked), torch.zeros_like(walked)
    p = tao.trace_pairs_reference(pairs.rays, pairs.seg_begin, pairs.seg_chunks,
                                  grid.records, grid.chunk, walked=p_walked, tests=p_tests)
    torch.cuda.synchronize()
    assert k.shape == (n_chunks * 128,) and k.sum().item() > 10
    assert torch.equal(k, p)
    assert torch.equal(walked, p_walked) and torch.equal(tests, p_tests)
    assert (walked <= pairs.seg_chunks).all()
    assert (tests <= walked * 128 * 128).all() and tests.sum().item() > 0
    # The counters change nothing: the same flags without them.
    assert torch.equal(k, tao.trace_pairs(pairs.rays, pairs.seg_begin, pairs.seg_chunks,
                                          grid.records, grid.chunk))


def test_ao_kernel_saturation_exit(cuda):
    """A chunk whose 128 rays all hit the first record's capsule saturates
    on its first record chunk and stops, though many more were assigned."""
    ts, grid, _ = _ao_inputs(cuda, 8)
    n_rec = int(grid.cell_start[-1] + grid.cell_count[-1])
    assert n_rec > 3 * 128
    # 128 rays aimed at the midpoint of the first record's segment.
    rec = grid.records[:, 0]
    aim = torch.tensor([0.0, 1.0, 0.0], device=cuda)
    rays = torch.zeros((8, 256), device=cuda)
    rays[0:3, :128] = (rec[0:3] + 0.5 * rec[3:6] - 0.5 * aim)[:, None]
    rays[3:6, :128] = aim[:, None]
    rays[6, :128] = 10.0
    seg_begin = torch.zeros(1, dtype=torch.int32, device=cuda)
    seg_chunks = torch.full((1,), n_rec // 128, dtype=torch.int32, device=cuda)
    walked = torch.zeros(1, dtype=torch.int32, device=cuda)
    tests = torch.zeros_like(walked)
    k = tao.trace_pairs(rays, seg_begin, seg_chunks, grid.records, 128, walked=walked,
                        tests=tests)
    p_walked, p_tests = torch.zeros_like(walked), torch.zeros_like(walked)
    p = tao.trace_pairs_reference(rays, seg_begin, seg_chunks, grid.records, 128,
                                  walked=p_walked, tests=p_tests)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and torch.equal(walked, p_walked)
    assert torch.equal(tests, p_tests)
    assert k.sum().item() == 128 and walked.item() < seg_chunks.item()
    # All 128 rays are live for the first record chunk and none after it.
    assert tests.item() == 128 * 128


def test_ao_kernel_all_chunks_empty(cuda):
    """A batch whose every pair chunk is empty: no block walks, every flag
    and count is 0 (the counts are written over whatever they held)."""
    _, grid, rays = _ao_inputs(cuda, 1000)
    pairs = tao.expand_ray_pairs(*rays, grid)
    empty = torch.zeros_like(pairs.seg_chunks)
    walked = torch.full_like(empty, -1)
    tests = torch.full_like(empty, -1)
    before = tao.trace_pairs.launches
    k = tao.trace_pairs(pairs.rays, pairs.seg_begin, empty, grid.records, grid.chunk,
                        walked=walked, tests=tests)
    assert tao.trace_pairs.launches == before + 1
    torch.cuda.synchronize()
    assert k.shape == (empty.shape[0] * 128,) and not bool(k.any())
    assert not bool(walked.any()) and not bool(tests.any())


def test_ao_kernel_active_chunks_past_the_kept_prefix(cuda):
    """Active pair chunks anywhere, not only the prefix of kept pairs: the
    dropped pairs' chunks walk a record range, as they do where the grid's
    last cell holds records, and some kept chunks are emptied."""
    _, grid, rays = _ao_inputs(cuda, 4096)
    pairs = tao.expand_ray_pairs(*rays, grid)
    seg_begin, seg_chunks = pairs.seg_begin.clone(), pairs.seg_chunks.clone()
    tail = torch.nonzero(seg_chunks == 0).flatten()
    assert tail.numel() > 4
    n_rec = int(grid.cell_start[-1] + grid.cell_count[-1])
    seg_begin[tail] = (torch.arange(tail.numel(), device=cuda, dtype=torch.int32) * 128) % (
        max(n_rec // 128, 1) * 128)
    seg_chunks[tail] = 2
    seg_chunks[1:tail[0]:3] = 0
    walked = torch.zeros_like(seg_chunks)
    tests = torch.zeros_like(seg_chunks)
    k = tao.trace_pairs(pairs.rays, seg_begin, seg_chunks, grid.records, grid.chunk,
                        walked=walked, tests=tests)
    p_walked, p_tests = torch.zeros_like(walked), torch.zeros_like(walked)
    p = tao.trace_pairs_reference(pairs.rays, seg_begin, seg_chunks, grid.records, grid.chunk,
                                  walked=p_walked, tests=p_tests)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and torch.equal(walked, p_walked) and torch.equal(tests, p_tests)
    assert k.reshape(-1, 128)[tail].sum().item() > 0  # the tail chunks were traced
    assert int(walked[tail].sum()) > 0


def test_trace_ao_occlusion_card_matches_cpu(cuda):
    """The whole trace (expansion, sorts, kernel, scatter) on the card
    against the CPU: both sorts are stable, so every ray is equal."""
    occ = []
    for dev in (cuda, torch.device("cpu")):
        _, grid, rays = _ao_inputs(dev, 3000)
        rays[3][::7] = False
        occ.append(tao.trace_ao_occlusion(*rays, grid).cpu())
    assert torch.equal(occ[0], occ[1]) and occ[0].sum().item() > 50


def test_render_rtao_card_matches_cpu(cuda):
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    rt = trtao.RtaoSettings(num_samples=2, ao_radius=0.2, grid_resolution=16,
                            rays_per_batch=8192)
    gen = torch.Generator().manual_seed(1)
    u = [torch.rand((2, H, W), generator=gen) for _ in range(2)]
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=dev)
        b1, b5 = rasterize_capsules.launches, tao.trace_pairs.launches
        imgs.append(trtao.render_tubes_rtao(
            scene, *ttr.camera_tensors(cam, dev), S, rt,
            uniforms=tuple(x.to(dev) for x in u),
        ).cpu())
        on_card = dev.type == "cuda"
        assert rasterize_capsules.launches == b1 + on_card
        assert tao.trace_pairs.launches == b5 + 5 * on_card  # one per batch of rays
    assert bool(torch.isfinite(imgs[0]).all())
    assert (imgs[0] - imgs[1]).abs().mean().item() <= 2e-3


def _wavefront_inputs(device, W, H, builder="linear", scene=(12, 10, 8, 0.03)):
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    ts = ttr.build_capsule_scene(*_walk(*scene), device=device)
    vp, cp, ab = ttr.camera_tensors(cam, device)
    return trt.build_wide_capsule_bvh(ts, builder=builder), trt.primary_rays(vp, cp, S, 1e6), ab


@pytest.mark.parametrize("no_overflow", [False, True], ids=["mlab_merge", "no_overflow"])
@pytest.mark.parametrize("K", [3, 8, 16, 32])
@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
def test_wavefront_kernel_matches_plain(cuda, builder, K, no_overflow):
    groups, rays, ab = _wavefront_inputs(cuda, 96, 64, builder)
    rays = rays[:, :rays.shape[1] - 50]  # R is no multiple of 128
    n_blocks = -(-rays.shape[1] // 128)
    stats = torch.zeros((n_blocks, 6), dtype=torch.int64, device=cuda)
    before = twf.trace_wavefront_kbuffer.launches
    k = twf.trace_wavefront_kbuffer(groups, rays, ab, K=K, opacity=0.4,
                                    no_overflow=no_overflow, stats=stats)
    assert twf.trace_wavefront_kbuffer.launches == before + 1
    p_stats = torch.zeros_like(stats)
    p = twf.trace_wavefront_kbuffer_reference(groups, rays, ab, K=K, opacity=0.4,
                                              no_overflow=no_overflow, stats=p_stats)
    torch.cuda.synchronize()
    assert k[0].shape == (K, n_blocks, 128) and k[1].shape == (3, K, n_blocks, 128)
    assert (k[0] < 2.0).sum().item() > 100
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(stats, p_stats)


@pytest.mark.parametrize("no_overflow", [False, True], ids=["mlab_merge", "no_overflow"])
@pytest.mark.parametrize("K", [8, 32])
def test_wavefront_kernel_incoherent_rays_match_plain(cuda, K, no_overflow):
    """Rays from random points in random directions: every block visits
    nearly every group, the leaf rows of most, with many sweeps."""
    groups, _, ab = _wavefront_inputs(cuda, 96, 64, "binned_sah")
    rng = np.random.default_rng(5)
    n = 128 * 16
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    rays = np.concatenate([rng.uniform(-0.4, 0.4, (3, n)), d, np.full((1, n), 1e6),
                           np.ones((1, n))]).astype(np.float32)
    rays = torch.as_tensor(rays, device=cuda)
    stats = torch.zeros((16, 6), dtype=torch.int64, device=cuda)
    k = twf.trace_wavefront_kbuffer(groups, rays, ab, K=K, opacity=0.4,
                                    no_overflow=no_overflow, stats=stats)
    p_stats = torch.zeros_like(stats)
    p = twf.trace_wavefront_kbuffer_reference(groups, rays, ab, K=K, opacity=0.4,
                                              no_overflow=no_overflow, stats=p_stats)
    torch.cuda.synchronize()
    assert stats[:, 0].float().mean().item() > 0.8 * (groups.shape[0] // 8)
    assert (k[0] < 2.0).sum().item() > 500
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(stats, p_stats)


def test_wavefront_kernel_opacity_tf_and_blocks(cuda):
    """A non-trivial opacity TF, and the plain version on a subset of ray
    blocks against the kernel's output there."""
    groups, rays, ab = _wavefront_inputs(cuda, 96, 64)
    tf_opacity = ((0.0, 0.2), (0.4, 0.9), (1.0, 0.5))
    k = twf.trace_wavefront_kbuffer(groups, rays, ab, K=8, opacity=0.7, tf_opacity=tf_opacity)
    blocks = torch.arange(0, rays.shape[1] // 128, 3, device=cuda)
    p = twf.trace_wavefront_kbuffer_reference(groups, rays, ab, K=8, opacity=0.7,
                                              tf_opacity=tf_opacity, blocks=blocks)
    torch.cuda.synchronize()
    assert torch.equal(k[0][:, blocks], p[0]) and torch.equal(k[2][:, blocks], p[2])
    assert torch.equal(k[1][:, :, blocks], p[1])


def test_wavefront_kernel_stack_overflow_raises(cuda):
    n_groups = 40
    rec = np.zeros((n_groups * 8, 128), np.float32)
    rec[:, 0:3] = -1.0
    rec[:, 3:6] = 1.0
    rec[:, 6] = -1.0
    for g in range(n_groups - 1):
        rec[g * 8:g * 8 + 8, 6] = n_groups - 1
        rec[g * 8 + 7, 6] = g + 1
    rec[(n_groups - 1) * 8:, 0:6] = np.inf
    rays = np.zeros((8, 128), np.float32)
    rays[:, :] = np.array([0, 0, -5, 0, 0, 1, 1e6, 1], np.float32)[:, None]
    ab = torch.tensor([1.0001, 0.010001], device=cuda)
    with pytest.raises(twf.StackOverflowError):
        twf.trace_wavefront_kbuffer(torch.as_tensor(rec, device=cuda),
                                    torch.as_tensor(rays, device=cuda), ab, K=4)


def test_render_wavefront_card_matches_cpu(cuda):
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, depth_cue_strength=0.2)
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=dev)
        before = twf.trace_wavefront_kbuffer.launches
        imgs.append(trt.render_tubes_raytraced_wavefront(
            scene, *ttr.camera_tensors(cam, dev), S, K=8, opacity=0.4
        ).cpu())
        assert twf.trace_wavefront_kbuffer.launches == before + (dev.type == "cuda")
    assert bool(torch.isfinite(imgs[0]).all()) and (imgs[0][3] > 0).sum().item() > 100
    assert (imgs[0] - imgs[1]).abs().mean().item() <= 2e-3


def test_build_lbvh_card_matches_cpu(cuda):
    trees = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(3, 7, 9, 0.03), device=dev)
        trees.append(trt.build_capsule_bvh(scene).numpy())
    for name in ("left", "right", "leaf_prim", "node_min", "node_max"):
        np.testing.assert_array_equal(getattr(trees[0], name), getattr(trees[1], name))


# The accumulation modes and the K-buffer's peel and per-fragment shading
# (the rest of the OIT family).

_ACCUM_CASES = (
    [("count", 4, False), ("wboit", 4, False)]
    + [("mboit_gen", n, t) for t in (False, True) for n in (4, 6, 8)]
    + [("mboit_resolve", n, t) for t in (False, True) for n in (4, 6, 8)]
)


def _mboit_frame(device, W, H, n_mom, trig, chunk=32, scene=(12, 10, 8, 0.03)):
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=chunk,
                       depth_cue_strength=0.2)
    ts = ttr.build_capsule_scene(*_walk(*scene), device=device)
    csr, params, _ = toit.prepare_mboit_frame(ts, *ttr.camera_tensors(cam, device), S, n_mom,
                                              0.4, trigonometric=trig)
    return csr, params, S


def _within_rel(k, p, scale, tol):
    """Share of pixels whose every plane is within tol * scale."""
    err = (k - p).abs().reshape(-1, *k.shape[-2:]).amax(dim=0)
    return (err <= tol * scale).float().mean().item()


@pytest.mark.parametrize("store_mode,n_mom,trig", _ACCUM_CASES)
def test_accum_kernel_matches_plain(cuda, store_mode, n_mom, trig):
    """Count exactly; wboit and mboit_gen sums within 1e-5 of each pixel's
    scale (its sum of w*a, or b0) on >= 99.9% of pixels; the resolve, on the
    kernel's own pass-1 moments, within 1e-4 there."""
    W, H = 200, 120  # not a multiple of the tile: edge tiles are cropped
    csr, params, S = _mboit_frame(cuda, W, H, n_mom, trig)
    K = 2 if store_mode == "mboit_gen" else 1
    kw = dict(K=K, tf_color=S.tf_color, tf_opacity=S.tf_opacity, n_mom=n_mom, trig=trig)
    if store_mode == "mboit_resolve":
        d, rgb, a = rasterize_capsules_mlab(csr, params, W, H, 16, 8, store_mode="mboit_gen",
                                            **dict(kw, K=2))
        nh = n_mom // 2
        kw["moments"] = torch.stack([d[0], *(rgb[0, 0], rgb[1, 0], rgb[2, 0], a[0])[:nh],
                                     *(d[1], rgb[0, 1], rgb[1, 1], rgb[2, 1])[:nh]])
    before = tk_accum().launches
    k = rasterize_capsules_mlab(csr, params, W, H, 16, 8, store_mode=store_mode, **kw)
    assert tk_accum().launches == before + 1
    p = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, store_mode=store_mode, **kw)
    torch.cuda.synchronize()
    k, p = torch.cat([k[0][None], k[1], k[2][None]]), torch.cat([p[0][None], p[1], p[2][None]])
    assert bool(torch.isfinite(k).all())
    if store_mode == "count":
        assert torch.equal(k, p) and k.max().item() >= 3
        return
    if store_mode == "wboit":
        scale = p[4, 0].abs() + 1e-30
    elif store_mode == "mboit_gen":
        scale = p[0, 0].abs() + 1e-30
    else:
        scale = torch.ones_like(p[0, 0])
    assert (p[0, 0] != 0).sum().item() > 100 or (p[4, 0] != 0).sum().item() > 100
    tol = 1e-4 if store_mode == "mboit_resolve" else 1e-5
    assert _within_rel(k, p, scale, tol) >= 0.999


def tk_accum():
    from linevis_tpu_torch.kernels.raster_capsule_oit import rasterize_capsules_accum

    return rasterize_capsules_accum


def test_accum_kernel_edge_cases(cuda):
    """Empty tiles (all sums zero), runs longer than one chunk, a peel depth
    with two-sided fragments, and resolve moments whose b0 is under the
    discard threshold (T = 1 there)."""
    W, H = 160, 120
    csr, params, S = _mboit_frame(cuda, W, H, 4, False, chunk=8, scene=(3, 24, 12, 0.05))
    counts = csr.tile_count
    assert (counts == 0).any() and counts.max().item() > 3 * csr.chunk
    kw = dict(tf_color=S.tf_color, tf_opacity=S.tf_opacity, n_mom=4)
    k = rasterize_capsules_mlab(csr, params, W, H, 16, 8, 1, store_mode="wboit", **kw)
    p = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, 1, store_mode="wboit", **kw)
    empty = counts == 0
    for x in (k[0], k[1], k[2]):
        assert (x[..., empty, :] == 0).all()
    assert _within_rel(torch.cat([k[0], k[1][:, 0], k[2]]), torch.cat([p[0], p[1][:, 0], p[2]]),
                       p[2][0].abs() + 1e-30, 1e-5) >= 0.999
    # Behind a peel depth, entry and exit surfaces.
    d1 = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, 1, S.tf_color,
                                           S.tf_opacity, deferred_shade=True,
                                           no_overflow=True)[0][0]
    peel = torch.where(d1 < 1.5, d1, -1.0).contiguous()
    kw2 = dict(kw, peel=peel, two_sided=True)
    k = rasterize_capsules_mlab(csr, params, W, H, 16, 8, 1, store_mode="wboit", **kw2)
    p = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, 1, store_mode="wboit",
                                          **kw2)
    assert (p[2][0] > 0).sum().item() > 100
    assert _within_rel(torch.cat([k[0], k[1][:, 0], k[2]]), torch.cat([p[0], p[1][:, 0], p[2]]),
                       p[2][0].abs() + 1e-30, 1e-5) >= 0.999
    d, rgb, a = rasterize_capsules_mlab(csr, params, W, H, 16, 8, 2, store_mode="mboit_gen", **kw)
    moments = torch.stack([d[0], rgb[0, 0], rgb[1, 0], d[1], rgb[0, 1]])
    moments[0, :, ::3] = 5e-4  # under the threshold
    kr = rasterize_capsules_mlab(csr, params, W, H, 16, 8, 1, store_mode="mboit_resolve",
                                 moments=moments, **kw)
    pr = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, 1,
                                           store_mode="mboit_resolve", moments=moments, **kw)
    torch.cuda.synchronize()
    ok = ((kr[1][:, 0] - pr[1][:, 0]).abs().amax(dim=0) <= 1e-4) & ((kr[2][0] - pr[2][0]).abs() <= 1e-4)
    assert ok.float().mean().item() >= 0.999
    # Where T = 1 the resolve's alpha sum is the plain sum of alphas.
    assert (kr[2][0][:, ::3] > 0).sum().item() > 10


# The accumulation kernel's design: tiles longest run first, a warp per 8x4
# pixel block with votes on the discriminants, each chunk's fragments
# marked first and then shaded and added in candidate order, the resolve's
# moment factors once per pixel. Its parent equals the plain version bit for
# bit, and so must it: every plane of every case below (NaN where the plain
# version has NaN).

_ACCUM_MODES4 = ("count", "wboit", "mboit_gen", "mboit_resolve")


def _accum_frame(device, W, H, tile=(16, 8), chunk=32, lines=None, n_mom=4, trig=False,
                 position=(0.0, 0.1, 1.2)):
    cam = Camera(position=position, width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=tile[0], tile_h=tile[1], chunk=chunk,
                       depth_cue_strength=0.2)
    ts = ttr.build_capsule_scene(*(lines or _walk(12, 10, 8, 0.03)), device=device)
    cams = ttr.camera_tensors(cam, device)
    csr, params, _ = toit.prepare_mboit_frame(ts, *cams, S, n_mom, 0.4, trigonometric=trig)
    return csr, params, S, ts, cams


def _accum_planes(out):
    return torch.cat([out[0], out[1].flatten(0, 1), out[2]])


def _same_bits(k, p):
    """Equal in every element, NaN where the other is NaN."""
    return bool(((k == p) | (k.isnan() & p.isnan())).all())


def _accum_vs_plain(csr, params, S, W, H, tile, store_mode, n_mom=4, trig=False, **kw):
    """The kernel (one launch) and the plain version in `store_mode` ->
    their planes; 'mboit_resolve' reads the kernel's own pass-1 moments
    unless `moments` is given."""
    K = 2 if store_mode == "mboit_gen" else 1
    kw = dict(tf_color=S.tf_color, tf_opacity=S.tf_opacity, n_mom=n_mom, trig=trig, **kw)
    if store_mode == "mboit_resolve" and "moments" not in kw:
        kw["moments"] = _kernel_moments(csr, params, W, H, tile, **kw)
    before = tk_accum().launches
    k = rasterize_capsules_mlab(csr, params, W, H, *tile, K, store_mode=store_mode, **kw)
    assert tk_accum().launches == before + 1
    p = rasterize_capsules_mlab_reference(csr, params, W, H, *tile, K, store_mode=store_mode,
                                          **kw)
    torch.cuda.synchronize()
    return _accum_planes(k), _accum_planes(p)


def _kernel_moments(csr, params, W, H, tile, n_mom, **kw):
    d, rgb, a = rasterize_capsules_mlab(csr, params, W, H, *tile, 2, store_mode="mboit_gen",
                                        n_mom=n_mom, **kw)
    nh = n_mom // 2
    return torch.stack([d[0], *(rgb[0, 0], rgb[1, 0], rgb[2, 0], a[0])[:nh],
                        *(d[1], rgb[0, 1], rgb[1, 1], rgb[2, 1])[:nh]]).contiguous()


@pytest.mark.parametrize("store_mode", _ACCUM_MODES4)
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_accum_kernel_longest_run_taken_first(cuda, tile, store_mode):
    """The longest run, past the middle of the index order and longer than
    one chunk of 128, taken first, at 16x8 and 32x16 tiles."""
    W, H = 200, 120
    csr, params, S, _, _ = _accum_frame(cuda, W, H, tile, 128, _bundle(),
                                        position=(0.1, 0.2, 1.4))
    counts = csr.tile_count
    assert int(counts.max()) > 128 and int(counts.argmax()) > counts.numel() // 2
    assert int(csr.longest_first[0]) == int(counts.argmax())
    k, p = _accum_vs_plain(csr, params, S, W, H, tile, store_mode)
    assert (p[0] != 0).sum().item() + (p[4] != 0).sum().item() > 50
    assert _same_bits(k, p)


@pytest.mark.parametrize("store_mode", _ACCUM_MODES4)
@pytest.mark.parametrize("chunk", [8, 32, 128, 256])
def test_accum_kernel_runs_over_chunks(cuda, chunk, store_mode):
    """Runs of several chunks at every staged width, and empty runs (all
    planes zero)."""
    W, H = 200, 120
    csr, params, S, _, _ = _accum_frame(cuda, W, H, chunk=chunk, lines=_bundle(),
                                        position=(0.1, 0.2, 1.4))
    counts = csr.tile_count
    assert int(counts.max()) > min(chunk, 128) and bool((counts == 0).any())
    k, p = _accum_vs_plain(csr, params, S, W, H, (16, 8), store_mode)
    assert _same_bits(k, p)
    assert bool((k[:, counts == 0] == 0).all())


@pytest.mark.parametrize("store_mode", _ACCUM_MODES4)
def test_accum_kernel_peel_two_sided(cuda, store_mode):
    """Entry and exit surfaces behind a peel depth."""
    W, H = 160, 120
    csr, params, S, _, _ = _accum_frame(cuda, W, H, chunk=8, lines=_walk(3, 24, 12, 0.05))
    d1 = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, 1, S.tf_color,
                                           S.tf_opacity, deferred_shade=True,
                                           no_overflow=True)[0][0]
    peel = torch.where(d1 < 1.5, d1, -1.0).contiguous()
    k, p = _accum_vs_plain(csr, params, S, W, H, (16, 8), store_mode, peel=peel, two_sided=True)
    assert (p[0] != 0).sum().item() + (p[4] != 0).sum().item() > 100
    assert _same_bits(k, p)


@pytest.mark.parametrize("store_mode", ["wboit", "mboit_gen", "mboit_resolve"])
def test_accum_kernel_alpha_from_rows(cuda, store_mode):
    """Alpha from payload rows 11-12 (alpha0 + dalpha * u) instead of the
    opacity TF."""
    W, H = 200, 120
    _, params, S, ts, cams = _accum_frame(cuda, W, H)
    rng = np.random.default_rng(5)
    seg_alpha = torch.tensor(np.stack([rng.uniform(0.1, 0.6, ts.num_segments),
                                       rng.uniform(-0.1, 0.3, ts.num_segments)]),
                             dtype=torch.float32, device=cuda)
    csr, _, _ = ttr.prepare_capsule_frame(ts, *cams, S, seg_alpha=seg_alpha)
    k, p = _accum_vs_plain(csr, params, S, W, H, (16, 8), store_mode, alpha_from_rows=True)
    k1, p1 = _accum_vs_plain(csr, params, S, W, H, (16, 8), store_mode)
    assert not torch.equal(p, p1)  # the rows change the alpha
    assert _same_bits(k, p)


def test_accum_kernel_lone_lanes(cuda):
    """Capsules under a pixel across, each hitting one lane of its warp's
    8x4 block (the votes pass, every other lane misses), in every mode."""
    W, H = 160, 96
    rng = np.random.default_rng(9)
    pos = np.zeros((40, 2, 3), np.float32)
    pos[:, 0, :2] = rng.uniform(-0.35, 0.35, (40, 2))
    pos[:, 1] = pos[:, 0] + rng.normal(0, 0.002, (40, 3))
    lines = (pos, np.ones((40, 2), bool), rng.uniform(0, 1, (40, 2)).astype(np.float32), 0.0025)
    csr, params, S, _, _ = _accum_frame(cuda, W, H, lines=lines)
    for store_mode in _ACCUM_MODES4:
        k, p = _accum_vs_plain(csr, params, S, W, H, (16, 8), store_mode)
        if store_mode == "count":
            # The warps' 8x4 blocks: some hold exactly one pixel with a fragment.
            blocks = p[0].reshape(-1, 2, 4, 2, 8).permute(0, 1, 3, 2, 4).reshape(-1, 32)
            assert ((blocks > 0).sum(dim=1) == 1).sum().item() >= 5
        assert _same_bits(k, p)


@pytest.mark.parametrize("store_mode", _ACCUM_MODES4)
@pytest.mark.parametrize("tile", [(12, 8), (4, 16), (32, 1)])
def test_accum_kernel_tiles_off_8x4_blocks(cuda, tile, store_mode):
    """Tiles that the warps' 8x4 pixel blocks do not cover (any tile of a
    multiple of 32 pixels is taken): each warp holds 32 pixels in row-major
    order, and every plane equals the plain version's."""
    W, H = 200, 120
    csr, params, S, _, _ = _accum_frame(cuda, W, H, tile)
    k, p = _accum_vs_plain(csr, params, S, W, H, tile, store_mode)
    assert (p[0] != 0).sum().item() + (p[4] != 0).sum().item() > 100
    assert _same_bits(k, p)


def test_accum_kernel_instances_spill_free(cuda, tmp_path):
    """No instance of the accumulation kernel spills (ptxas's report of a
    fresh build), and each has few enough registers for a block of 512
    pixels (it has no launch bounds). A 32-byte stack frame is cosf/sinf's
    range reduction in the power-moment resolves, not a spill."""
    import ctypes
    import subprocess

    from linevis_tpu_torch.kernels import _build

    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp_path / "lib.so"),
                        str(_build.CSRC / "raster_capsule_accum.cu")],
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr
    reports = [ln for ln in (p.stdout + p.stderr).splitlines() if "spill stores" in ln]
    assert len(reports) == 21
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in reports), reports
    fn = _build.load("raster_capsule_accum").kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    for i in range(21):
        v, label = (ctypes.c_int * 6)(), ctypes.create_string_buffer(64)
        assert fn(i, v, label, 64) == 0
        assert v[0] * 512 <= 65536, (label.value, v[0])


@pytest.mark.parametrize("n_mom,trig", [(n, t) for t in (False, True) for n in (4, 6, 8)])
def test_accum_resolve_discarded_pixels(cuda, n_mom, trig):
    """Every resolve instance on moments whose b0 is under the discard
    threshold at every third pixel column (T = 1 there)."""
    W, H = 160, 120
    csr, params, S, _, _ = _accum_frame(cuda, W, H, n_mom=n_mom, trig=trig)
    mom = _kernel_moments(csr, params, W, H, (16, 8), n_mom, tf_color=S.tf_color,
                          tf_opacity=S.tf_opacity, trig=trig)
    mom[0, :, ::3] = 5e-4
    k, p = _accum_vs_plain(csr, params, S, W, H, (16, 8), "mboit_resolve", n_mom, trig,
                           moments=mom)
    assert (p[4][:, ::3] > 0).sum().item() > 10
    assert _same_bits(k, p)


@pytest.mark.parametrize("K", [8, 16, 32])
def test_kbuffer_peel_per_fragment_matches_plain(cuda, K):
    """Per-fragment shading with a peel depth (a depth-peeling pass): node
    depths and alpha within 1e-5 on >= 99.9% of pixels, colors within 1e-5
    there."""
    W, H = 200, 120
    csr, params, S = _mlab_frame(cuda, W, H, (16, 8))
    n_tiles = csr.tile_start.shape[0]
    kw = dict(K=4, tf_color=S.tf_color, tf_opacity=S.tf_opacity, no_overflow=True)
    d0, _, _ = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, **kw)
    peel = torch.where(d0 < 1.5, d0, -1.0).amax(dim=0).contiguous()
    assert peel.shape == (n_tiles, 128) and (peel > 0).sum().item() > 100
    for no_overflow in (True, False):
        kw = dict(K=K, tf_color=S.tf_color, tf_opacity=S.tf_opacity, peel=peel,
                  no_overflow=no_overflow)
        before = rasterize_capsules_mlab.launches
        kd, kc, ka = rasterize_capsules_mlab(csr, params, W, H, 16, 8, **kw)
        assert rasterize_capsules_mlab.launches == before + 1
        pd, pc, pa = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, **kw)
        torch.cuda.synchronize()
        assert (kd < 2.0).sum().item() > 100
        assert bool(((kd > peel[None]) | (kd == 2.0)).all())  # nothing at or before the peel
        ok = ((kd - pd).abs().amax(dim=0) <= 1e-5) & ((ka - pa).abs().amax(dim=0) <= 1e-5)
        assert ok.float().mean().item() >= 0.999
        assert (kc - pc).abs().amax(dim=(0, 1))[ok].max().item() <= 1e-5


@pytest.mark.parametrize(
    "renderer,kw,launches",
    [("render_tubes_wboit", {}, (0, 1)),
     ("render_tubes_depth_peeling", dict(K=8, passes=4), (4, 0)),
     ("render_tubes_mlab_buckets", dict(K=8), (2, 0)),
     ("render_tubes_mboit", dict(n_mom=4), (0, 2)),
     ("render_tubes_mboit", dict(n_mom=6, trigonometric=True, pixel_format="unorm16"), (0, 2)),
     ("render_tubes_atomic_loop", dict(K=16), (1, 0))],
)
def test_render_oit_modes_card_matches_cpu(cuda, renderer, kw, launches):
    """Each renderer on the card, with exactly its kernel launches, against
    the CPU: mean abs <= 2e-3."""
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, depth_cue_strength=0.2)
    render = getattr(toit, renderer)
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=dev)
        before = (rasterize_capsules_mlab.launches, tk_accum().launches)
        imgs.append(render(scene, *ttr.camera_tensors(cam, dev), S, opacity=0.4, **kw).cpu())
        got = (rasterize_capsules_mlab.launches - before[0], tk_accum().launches - before[1])
        assert got == (launches if dev.type == "cuda" else (0, 0))
    assert bool(torch.isfinite(imgs[0]).all())
    assert (imgs[0][3] > 0).sum().item() > 100
    assert (imgs[0] - imgs[1]).abs().mean().item() <= 2e-3


def test_render_depth_complexity_card_equals_cpu(cuda):
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    out = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=dev)
        out.append(toit.render_depth_complexity(scene, *ttr.camera_tensors(cam, dev), S).cpu())
    assert torch.equal(out[0], out[1]) and out[0].max().item() >= 3


def _dense_mlab_frame(device, copies=10, W=96, H=64, chunk=32):
    """The segments of a dense walk scene as lines of one segment each, every
    one laid down `copies` times in a row at the same place (tie windows of
    `copies` coincident fragments, more than the kernel keeps in registers,
    next to each other in the runs), binned in chunks of 32 (default), so
    tile runs span several chunks and a block of 16 candidates holds more
    than K windows."""
    pos, _, attrs, radius = _walk(5, 12, 10, 0.05)
    seg = np.stack([pos[:, :-1], pos[:, 1:]], axis=2).reshape(-1, 2, 3)
    seg_attr = np.stack([attrs[:, :-1], attrs[:, 1:]], axis=2).reshape(-1, 2)
    pos, attrs = np.repeat(seg, copies, axis=0), np.repeat(seg_attr, copies, axis=0)
    mask = np.ones(attrs.shape, bool)
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=chunk,
                       depth_cue_strength=0.2)
    ts = ttr.build_capsule_scene(pos, mask, attrs, radius, device=device)
    csr, params = toit.prepare_mlab_frame(ts, *ttr.camera_tensors(cam, device), S, 0.4)
    return csr, params, S


_DENSE_CASES = [("composite", 8), ("nodes", 3), ("nodes", 8), ("nodes", 16), ("nodes", 32),
                ("no_overflow", 16), ("no_overflow", 32), ("two_sided", 8), ("peel", 8),
                ("peel_merge", 8), ("gather", 8), ("bands", 8), ("wide_blocks", 8)]


@pytest.mark.parametrize("mode,K", _DENSE_CASES)
def test_kbuffer_dense_runs_equal_plain(cuda, mode, K):
    """The K-buffer kernel bit for bit against its plain version where runs
    span several chunks, a block of `sub` candidates holds more than K tie
    windows and more hits than the kernel keeps in registers, and windows
    hold 10 coincident fragments: every K-buffer mode, K 3 to 32; and the
    composite in chunks of 256 and blocks of 128 candidates."""
    W, H = 96, 64
    wide = mode == "wide_blocks"
    csr, params, S = _dense_mlab_frame(cuda, chunk=256 if wide else 32)
    assert int(csr.tile_count.max()) > (128 if wide else 3 * csr.chunk)
    kw = dict(K=K, tf_color=S.tf_color, tf_opacity=S.tf_opacity, sub=128 if wide else 16)
    if mode in ("composite", "bands", "wide_blocks"):
        kw.update(deferred_shade=True, composite=True, use_bands=mode == "bands")
    elif mode in ("nodes", "no_overflow", "two_sided"):
        kw.update(deferred_shade=True, no_overflow=mode == "no_overflow",
                  two_sided=mode == "two_sided")
    elif mode == "gather":
        kw.update(store_mode="gather")
    else:
        d0, _, _ = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, K=2,
                                                     tf_color=S.tf_color, no_overflow=True)
        kw.update(peel=torch.where(d0 < 1.5, d0, -1.0).amax(dim=0).contiguous(),
                  no_overflow=mode == "peel")
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32, device=cuda)
    before = rasterize_capsules_mlab.launches
    k = rasterize_capsules_mlab(csr, params, W, H, 16, 8, work=work, **kw)
    assert rasterize_capsules_mlab.launches == before + 1
    p_work = torch.zeros_like(work)
    stats = {}
    p = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, work=p_work, stats=stats,
                                          **kw)
    torch.cuda.synchronize()
    assert torch.equal(work, p_work)
    assert stats["members"] > 2 * stats["sweeps"]  # windows of several fragments
    for a, b in zip((k,) if torch.is_tensor(k) else k, (p,) if torch.is_tensor(p) else p):
        assert torch.equal(a, b)
    filled = (k[3] > 0) if torch.is_tensor(k) else (k[0] < 2.0)
    assert filled.sum().item() > 100


# B2's last two modes: the importance gather ('gather') and band shading
# (`use_bands`).

@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_gather_kernel_equals_plain(cuda, tile, K):
    """The gather kernel is bit-identical to its plain version: node depths,
    importance, segment ids (tie-window averages included) and alpha."""
    W, H = 200, 120
    csr, params, S = _mlab_frame(cuda, W, H, tile)
    kw = dict(K=K, tf_color=S.tf_color, tf_opacity=S.tf_opacity, store_mode="gather")
    before = rasterize_capsules_mlab.launches
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32, device=cuda)
    k = rasterize_capsules_mlab(csr, params, W, H, *tile, work=work, **kw)
    assert rasterize_capsules_mlab.launches == before + 1
    p_work = torch.zeros_like(work)
    p = rasterize_capsules_mlab_reference(csr, params, W, H, *tile, work=p_work, **kw)
    torch.cuda.synchronize()
    assert torch.equal(work, p_work)
    assert (k[0] < 2.0).sum().item() > 100
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(k[2], (k[0] < 2.0).float())


@pytest.mark.parametrize("mode", ["shade", "composite", "wboit", "mboit_resolve"])
def test_use_bands_kernels_match_plain(cuda, mode):
    """use_bands (diffuse exponent 1.0) in per-fragment shading (exact K
    nodes), the composite and the accumulation modes that shade, at the bars
    of the same modes without it; the exponent changes the result."""
    W, H = 200, 120
    csr, params, S = _mlab_frame(cuda, W, H, (16, 8))
    kw = dict(tf_color=S.tf_color, tf_opacity=S.tf_opacity)
    if mode == "shade":
        kw.update(K=8, no_overflow=True)
    elif mode == "composite":
        kw.update(K=8, deferred_shade=True, composite=True)
    elif mode == "wboit":
        kw.update(K=1, store_mode="wboit")
    else:
        params = params.clone()
        params[15], params[16], params[17], params[18] = -1.0, 1.0, 5e-7, 0.1
        d, rgb, _ = rasterize_capsules_mlab(csr, params, W, H, 16, 8, 2,
                                            store_mode="mboit_gen", **kw)
        kw.update(K=1, store_mode="mboit_resolve", n_mom=4, moments=torch.stack(
            [d[0], rgb[0, 0], rgb[1, 0], d[1], rgb[0, 1]]))
    launches = (rasterize_capsules_mlab.launches, tk_accum().launches)
    k = rasterize_capsules_mlab(csr, params, W, H, 16, 8, use_bands=True, **kw)
    accum = mode in ("wboit", "mboit_resolve")
    assert (rasterize_capsules_mlab.launches - launches[0],
            tk_accum().launches - launches[1]) == ((0, 1) if accum else (1, 0))
    p = rasterize_capsules_mlab_reference(csr, params, W, H, 16, 8, use_bands=True, **kw)
    k17 = rasterize_capsules_mlab(csr, params, W, H, 16, 8, **kw)
    torch.cuda.synchronize()
    if mode == "composite":
        assert ((k - p).abs().amax(dim=0) <= 1e-4).float().mean().item() >= 0.999
        assert (k - k17).abs().max().item() > 1e-3
        return
    kp, pp, k17p = (torch.cat([x[0], x[1].flatten(0, 1), x[2]]) for x in (k, p, k17))
    if accum:
        scale = p[2][0].abs() + 1e-30
        tol = 1e-5 if mode == "wboit" else 1e-4
        ok = ((kp - pp).abs().amax(dim=0) <= tol * (scale if mode == "wboit" else 1.0))
    else:
        ok = (kp - pp).abs().amax(dim=0) <= 1e-5
    assert ok.float().mean().item() >= 0.999
    assert (kp - k17p).abs().max().item() > 1e-3


def test_opacity_optimization_card_matches_cpu(cuda):
    """Three frames of the opacity-optimization renderer on the card (two
    launches of the K-buffer kernel each: the gather and the final render)
    against the CPU: vertex opacities within 2e-3 (the frame prep rounds on
    the card as PyTorch's kernels do there), images mean abs <= 2e-3."""
    from linevis_tpu_torch.render.opacity_optimization import (
        OpacityOptimizationRenderer,
        OpacityOptimizationSettings,
    )

    W, H = 160, 128
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, depth_cue_strength=0.2)
    out = []
    for dev in (cuda, torch.device("cpu")):
        pos, mask, attrs, radius = _walk(12, 10, 8, 0.03)
        scene = ttr.build_capsule_scene(pos, mask, attrs, radius, device=dev)
        r = OpacityOptimizationRenderer(scene, 10, 8, S, OpacityOptimizationSettings())
        before = rasterize_capsules_mlab.launches
        for i in range(3):
            img = r.render(Camera(position=(0.02 * i, 0.1, 1.2), width=W, height=H))
        assert rasterize_capsules_mlab.launches - before == (6 if dev.type == "cuda" else 0)
        out.append((img.cpu(), r.vertex_opacity.cpu()))
    (ki, kv), (pi, pv) = out
    assert bool(torch.isfinite(ki).all()) and (ki[3] > 0).sum().item() > 100
    assert (kv - pv).abs().max().item() <= 2e-3
    assert kv.min().item() < 0.9
    assert (ki - pi).abs().mean().item() <= 2e-3


# The per-ray traversal kernels of the transparent ray tracer: the closest
# hit of the re-cast loop (R1) and MLAT (R2).

def _traversal_inputs(device, W, H, builder="linear", scene=(12, 10, 8, 0.03)):
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H)
    ts = ttr.build_capsule_scene(*_walk(*scene), device=device)
    vp, cp, ab = ttr.camera_tensors(cam, device)
    tree = tlbvh.lbvh_on(trt.build_capsule_bvh(ts, builder=builder), device)
    return ts, tree, trt.tile_rays(vp, cp, S), ab, S


@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
def test_closest_hit_kernel_matches_plain(cuda, builder):
    """Twelve casts of the enumeration from the camera (W = 90: padded tile
    rays start done), each cast's (t, prim) and per-ray counts bit for bit;
    the next cast starts from the kernel's output."""
    ts, tree, (o, d, _, pad), _, _ = _traversal_inputs(cuda, 90, 64, builder)
    R = o.shape[0]
    t_last = torch.zeros(R, device=cuda)
    p_last = torch.full((R,), 2 ** 31 - 1, dtype=torch.int32, device=cuda)
    done = pad.clone()
    hits = 0
    for _ in range(12):
        before = tch.capsule_closest_hit.launches
        stats = torch.zeros((R, 2), dtype=torch.int64, device=cuda)
        k = tch.capsule_closest_hit(tree, ts, o, d, t_last, p_last, done, stats=stats)
        assert tch.capsule_closest_hit.launches == before + 1
        p_stats = torch.zeros_like(stats)
        p = tch.capsule_closest_hit_reference(tree, ts, o, d, t_last, p_last, done,
                                              stats=p_stats)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert torch.equal(stats, p_stats)
        miss = k[1] < 0
        hits += int((~miss).sum())
        t_last = torch.where(miss, t_last, k[0])
        p_last = torch.where(miss, p_last, k[1])
        done = done | miss
    assert hits > 1000


@pytest.mark.parametrize("opacity", [0.3, 1.0], ids=["no_saturation", "saturation"])
@pytest.mark.parametrize("K", [4, 8, 16, 32])
def test_mlat_kernel_matches_plain(cuda, K, opacity):
    """Nodes and per-ray counts bit for bit; at opacity 1 the buffers
    saturate and the cull prunes subtrees (fewer visits than without it)."""
    ts, tree, (o, d, wz, pad), ab, _ = _traversal_inputs(cuda, 90, 64,
                                                          scene=(12, 16, 10, 0.05))
    tf_opacity = ((0.0, 0.6), (0.5, 1.0), (1.0, 0.8))
    R = o.shape[0]
    stats = torch.zeros((R, 3), dtype=torch.int64, device=cuda)
    before = tml.mlat_nodes.launches
    k = tml.mlat_nodes(tree, ts, o, d, wz, pad, ab, K=K, opacity=opacity,
                       tf_opacity=tf_opacity, stats=stats)
    assert tml.mlat_nodes.launches == before + 1
    p_stats = torch.zeros_like(stats)
    p = tml.mlat_nodes_reference(tree, ts, o, d, wz, pad, ab, K=K, opacity=opacity,
                                 tf_opacity=tf_opacity, stats=p_stats)
    torch.cuda.synchronize()
    assert k[0].shape == (K, R) and k[1].shape == (3, K, R)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(stats, p_stats)
    assert int(torch.isfinite(k[0]).sum()) > 500
    if opacity == 1.0 and K <= 8:
        assert int((k[2][K - 1] > 0.999).sum()) > 50


def _chain_tree(depth, device):
    """A tree whose right spine is `depth` internal nodes deep, every box
    [-1, 1]^3: a ray through the origin pushes two ids a level and pops one."""
    n = depth + 1
    left = np.arange(n - 1) + (n - 1)
    right = np.arange(1, n)
    right[-1] = 2 * n - 2
    box = np.tile(np.array([[-1.0, -1.0, -1.0]], np.float32), (2 * n - 1, 1))
    return tlbvh.Lbvh(left=torch.as_tensor(left, device=device).int(),
                      right=torch.as_tensor(right, device=device).int(),
                      node_min=torch.as_tensor(box, device=device),
                      node_max=torch.as_tensor(-box, device=device),
                      leaf_prim=(torch.arange(n, device=device) % 60).int())


@pytest.mark.parametrize("kernel", ["closest_hit", "mlat"])
def test_traversal_stack_overflow_raises(cuda, kernel):
    ts = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=cuda)
    o = torch.tensor([[0.0, 0.0, -5.0]] * 128, device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 128, device=cuda)
    z = torch.zeros(128, device=cuda)
    done = torch.zeros(128, dtype=torch.bool, device=cuda)
    for depth, raises in ((40, False), (80, True)):
        tree = _chain_tree(depth, cuda)
        if kernel == "closest_hit":
            call = (lambda: tch.capsule_closest_hit(
                tree, ts, o, d, z, torch.full((128,), 2 ** 31 - 1, dtype=torch.int32,
                                              device=cuda), done))
        else:
            call = (lambda: tml.mlat_nodes(tree, ts, o, d, z + 1.0, done,
                                           torch.tensor([1.0001, 0.010001], device=cuda)))
        if raises:
            with pytest.raises(tlbvh.StackOverflowError):
                call()
        else:
            call()


def _warp_bounds(warps, stats, walks=1):
    """A warp tests every node one of its lanes accepts (in each of a
    lane's walks the root and the internal nodes it accepts, half its
    visits less one, and its leaf tests) and only nodes one of its lanes
    visits."""
    visits, leaves = stats[:, 0], stats[:, 1]
    accepted = (torch.clamp(visits - walks, min=0) // 2 + leaves).reshape(-1, 32)
    assert bool((warps >= accepted.max(dim=1).values).all())
    assert bool((warps <= visits.reshape(-1, 32).sum(dim=1)).all())


def _counted_loop(args, casts):
    """`trace_recast` with the one-cast kernel -> (record, each ray's node
    visits and leaf tests summed over the casts)."""
    tree, ts, o = args[:3]
    R = o.shape[0]
    rec = (torch.zeros((casts, R), device=o.device),
           torch.zeros((casts, R), dtype=torch.int32, device=o.device))
    st = torch.zeros((R, 2), dtype=torch.int64, device=o.device)

    def hit(*a):
        s = torch.zeros_like(st)
        t, prim = tch.capsule_closest_hit(*a, stats=s)
        k = int(hit.casts)
        rec[0][k], rec[1][k] = t, prim
        st.add_(s)
        hit.casts += 1
        return t, prim

    hit.casts = 0
    trt.trace_recast(*args, closest_hit=hit)
    return rec, st


@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
def test_recast_kernel_matches_plain_loop(cuda, builder):
    """The whole re-cast loop in one launch against `trace_recast` with the
    plain closest hit (W = 90: padded tile rays start done): every cast's
    (t, prim) bit for bit (also against the loop of one-cast kernel
    launches), color and transmittance within 1e-5, rays done early
    recorded as (inf, -1)."""
    ts, tree, (o, d, wz, pad), ab, S = _traversal_inputs(cuda, 90, 64, builder)
    vp = ttr.camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=90, height=64), cuda)[0]
    dmin, dmax = trt._depth_cue_range(ts, vp)
    R, casts = o.shape[0], 12
    args = (tree, ts, o, d, wz, pad, ab, S, casts, 0.4, dmin, dmax)
    recs = []
    for on_card in (True, False):
        rec = (torch.zeros((casts, R), device=cuda),
               torch.zeros((casts, R), dtype=torch.int32, device=cuda))
        before = trt.capsule_recast.launches
        if on_card:
            out = trt.capsule_recast(*args, record=rec)
        else:
            k = [0]

            def hit(*a):
                t, prim = tch.capsule_closest_hit_reference(*a)
                rec[0][k[0]], rec[1][k[0]] = t, prim
                k[0] += 1
                return t, prim

            out = trt.trace_recast(*args, closest_hit=hit)
        assert trt.capsule_recast.launches == before + on_card
        recs.append((rec, out))
    torch.cuda.synchronize()
    (k_rec, (k_acc, k_T)), (p_rec, (p_acc, p_T)) = recs
    assert torch.equal(k_rec[0], p_rec[0]) and torch.equal(k_rec[1], p_rec[1])
    c_rec, _ = _counted_loop(args, casts)
    assert torch.equal(c_rec[0], p_rec[0]) and torch.equal(c_rec[1], p_rec[1])
    assert (k_acc - p_acc).abs().max().item() <= 1e-5
    assert (k_T - p_T).abs().max().item() <= 1e-5
    assert bool((k_rec[1][:, pad] == -1).all()) and bool(torch.isinf(k_rec[0][:, pad]).all())
    assert bool((k_T[pad] == 1.0).all()) and bool((k_acc[:, pad] == 0.0).all())
    hits = k_rec[1] >= 0
    assert int(hits[0].sum()) > 300 and int(hits[-1].sum()) < int(hits[0].sum())
    # A ray that missed stays (inf, -1) on every later cast.
    missed = torch.cumsum((~hits & ~pad[None]).int(), dim=0) > 0
    assert not bool((hits & missed).any())


def test_recast_kernel_warp_visits_and_overflow(cuda):
    """The loop's warp tests every leaf one of its lanes tests and at most
    the root a cast and four slots of each wide node its lanes accept (each
    an internal node of their binary walks: fewer than half their visits);
    a tree on which a ray's stack could pass max_stack raises before any
    launch."""
    ts, tree, (o, d, wz, pad), ab, S = _traversal_inputs(cuda, 96, 64)
    R, casts = o.shape[0], 8
    args = (tree, ts, o, d, wz, pad, ab, S, casts, 0.3, torch.tensor(0.0, device=cuda),
            torch.tensor(1.0, device=cuda))
    warps = torch.zeros(R // 32, dtype=torch.int64, device=cuda)
    trt.capsule_recast(*args, warp_visits=warps)
    _, st = _counted_loop(args, casts)
    leaves = st[:, 1].reshape(-1, 32)
    inner = (st[:, 0] // 2).reshape(-1, 32)
    assert bool((warps >= leaves.max(dim=1).values).all())
    assert bool((warps <= casts + 4 * inner.sum(dim=1)).all())
    assert int(warps.sum()) > 0
    o1 = torch.tensor([[0.0, 0.0, -5.0]] * 128, device=cuda)
    d1 = torch.tensor([[0.0, 0.0, 1.0]] * 128, device=cuda)
    one = torch.ones(128, device=cuda)
    no = torch.zeros(128, dtype=torch.bool, device=cuda)
    ab1 = torch.tensor([1.0001, 0.010001], device=cuda)
    for depth, raises in ((40, False), (80, True)):
        before = trt.capsule_recast.launches
        call = (lambda: trt.capsule_recast(_chain_tree(depth, cuda), ts, o1, d1, one, no, ab1,
                                           S, 4, 0.3, 0.0, 1.0))
        if raises:
            with pytest.raises(tlbvh.StackOverflowError):
                call()
        else:
            call()
        assert trt.capsule_recast.launches == before + (not raises)


def test_render_raytraced_one_launch_per_frame(cuda):
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H)
    scene = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=cuda)
    before = (trt.capsule_recast.launches, tch.capsule_closest_hit.launches)
    trt.render_tubes_raytraced(scene, *ttr.camera_tensors(cam, cuda), S)
    assert (trt.capsule_recast.launches, tch.capsule_closest_hit.launches) == (
        before[0] + 1, before[1])


@pytest.mark.parametrize("K", [8, 16, 32])
def test_mlat_kernel_matches_plain_sah(cuda, K):
    """R2 on the binned-SAH tree: nodes and per-ray counts bit for bit, the
    warp's node tests within its lanes' walks."""
    ts, tree, (o, d, wz, pad), ab, _ = _traversal_inputs(cuda, 90, 64, "binned_sah",
                                                          scene=(12, 16, 10, 0.05))
    R = o.shape[0]
    kw = dict(K=K, opacity=0.5, tf_opacity=((0.0, 0.6), (0.5, 1.0), (1.0, 0.8)))
    stats = torch.zeros((R, 3), dtype=torch.int64, device=cuda)
    warps = torch.zeros(-(-R // 32), dtype=torch.int64, device=cuda)
    k = tml.mlat_nodes(tree, ts, o, d, wz, pad, ab, stats=stats, warp_visits=warps, **kw)
    p_stats = torch.zeros_like(stats)
    p = tml.mlat_nodes_reference(tree, ts, o, d, wz, pad, ab, stats=p_stats, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(stats, p_stats)
    _warp_bounds(warps, stats)


@pytest.mark.parametrize("renderer", ["render_tubes_raytraced", "render_tubes_mlat"])
def test_render_raytraced_card_matches_cpu(cuda, renderer):
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, depth_cue_strength=0.2)
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene = ttr.build_capsule_scene(*_walk(12, 10, 8, 0.03), device=dev)
        imgs.append(getattr(trt, renderer)(scene, *ttr.camera_tensors(cam, dev), S,
                                           opacity=0.4).cpu())
    assert bool(torch.isfinite(imgs[0]).all()) and (imgs[0][3] > 0).sum().item() > 100
    assert (imgs[0] - imgs[1]).abs().mean().item() <= 2e-3


# -- the volume kernels: R3 (path tracer), R4 (density march), R5 (heat map) ---


def _blob_cloud(n=64, blobs=40, seed=7):
    """A procedural cloud [n, n, n] in [0, 1]: a clipped sum of Gaussian blobs."""
    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, n, dtype=np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    out = np.zeros((n, n, n), np.float32)
    for c, r, a in zip(rng.uniform(0.2, 0.8, (blobs, 3)), rng.uniform(0.05, 0.15, blobs),
                       rng.uniform(0.3, 1.0, blobs)):
        out += a * np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2 + (zz - c[2]) ** 2) / (r * r))
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _vpt_row(cuda, width=1920, height=1080, row=540):
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render import vpt as tvpt

    cam = Camera(position=(0.0, 0.15, 0.9), look_at_point=(0, 0, 0), width=width, height=height)
    basis = ttr._ray_basis(torch.as_tensor(cam.view_projection_matrix(), device=cuda))
    o = torch.as_tensor(np.asarray(cam.position, np.float32), device=cuda)
    _, kt, origins, dirs = tvpt.primary_rays(threefry.prng_key(1, cuda), o, basis, width, height)
    sl = slice(row * width, (row + 1) * width)
    return origins[sl].contiguous(), dirs[sl].contiguous(), kt, row * width


def test_threefry_device_matches_torch(cuda):
    from linevis_tpu_torch.kernels.vpt_tracking import threefry_device
    from linevis_tpu_torch.ops import threefry

    keys = threefry.split(threefry.prng_key(42, cuda), 4096)
    for c in (0, 1, 5, 1000):
        assert torch.equal(threefry_device(keys, "split", c), threefry.split_at(keys, c))
        assert torch.equal(threefry_device(keys, "uniform", c), threefry.uniform_at(keys, c))


@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (4, 1080, 1920)])
def test_threefry_uniform_kernel_matches_plain(cuda, shape):
    from linevis_tpu_torch.kernels.threefry_uniform import threefry_uniform
    from linevis_tpu_torch.ops import threefry

    keys = threefry.split(threefry.prng_key(7, cuda), 3)
    for key in (keys[0], keys[2]):
        n0 = threefry_uniform.launches
        got = threefry_uniform(key, shape)
        assert threefry_uniform.launches == n0 + 1 and got.device == key.device
        assert got.shape == shape and torch.equal(got, threefry.uniform(key, shape))
        for j in (0, 1):  # the half split(key)[j], derived in the kernel
            assert torch.equal(threefry_uniform(key, shape, split=j),
                               threefry.uniform(threefry.split_at(key, j), shape))
    with pytest.raises(ValueError, match="one key"):
        threefry_uniform(keys, (4,))


@pytest.mark.parametrize("interpolation", ["Trilinear", "Nearest", "Stochastic"])
@pytest.mark.parametrize("mode", ["Delta Tracking", "Spectral Delta Tracking", "Ratio Tracking"])
def test_vpt_tracking_kernel_matches_plain(cuda, mode, interpolation):
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    origins, dirs, kt, first = _vpt_row(cuda)
    ext = (1024.0, 900.0, 800.0) if mode == "Spectral Delta Tracking" else (1024.0,) * 3
    p = tvt.vpt_params(grid.shape, ext, (0.95, 0.9, 1.0), (0.58, 0.77, 0.27), (2.6, 2.5, 2.3),
                       0.2, mode, 512, interpolation)
    ev_k = torch.empty(origins.shape[0], dtype=torch.int32, device=cuda)
    ev_p = torch.empty_like(ev_k)
    n0 = tvt.vpt_tracking.launches
    got = tvt.vpt_tracking(grid, origins, dirs, kt, p, events=ev_k, first=first)
    assert tvt.vpt_tracking.launches == n0 + 1
    ref = tvt.vpt_tracking_reference(grid, origins, dirs, kt, p, events=ev_p, first=first)
    again = tvt.vpt_tracking(grid, origins, dirs, kt, p, first=first)
    for a, b, c in zip(got, ref, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(ev_k, ev_p) and int(ev_k.max()) > 10


def test_vpt_tracking_env_map_matches_plain(cuda):
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    origins, dirs, kt, first = _vpt_row(cuda)
    env = torch.as_tensor(np.random.default_rng(3).uniform(0, 2, (16, 32, 3)).astype(np.float32),
                          device=cuda)
    p = tvt.vpt_params(grid.shape, (1024.0,) * 3, (1.0,) * 3, (0.58, 0.77, 0.27), (1, 1, 1),
                       0.0, "Delta Tracking", 512, "Trilinear", env_intensity=1.5)
    for a, b in zip(tvt.vpt_tracking(grid, origins, dirs, kt, p, env, first=first),
                    tvt.vpt_tracking_reference(grid, origins, dirs, kt, p, env, first=first)):
        assert torch.equal(a, b)


def _vpt_case(cuda, grid, origins, dirs, kt, p, env=None, first=0):
    """The kernel (with its events) against the plain version bit for bit,
    and a second launch equal to the first."""
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    ev_k = torch.full((origins.shape[0],), -1, dtype=torch.int32, device=cuda)
    ev_p = torch.empty_like(ev_k)
    got = tvt.vpt_tracking(grid, origins, dirs, kt, p, env, events=ev_k, first=first)
    again = tvt.vpt_tracking(grid, origins, dirs, kt, p, env, first=first)
    ref = tvt.vpt_tracking_reference(grid, origins, dirs, kt, p, env, events=ev_p, first=first)
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(ev_k, ev_p)
    return ev_k


def _vpt_defaults(grid, max_events=512, mode="Delta Tracking", interpolation="Trilinear"):
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    return tvt.vpt_params(grid.shape, (1024.0,) * 3, (0.95, 0.9, 1.0), (0.58, 0.77, 0.27),
                          (2.6, 2.5, 2.3), 0.2, mode, max_events, interpolation)


@pytest.mark.parametrize("n", [0, 1, 33, 100_003])
def test_vpt_tracking_ray_counts(cuda, n):
    """Counts below a warp, across a few and past the persistent grid's
    lanes (132 SMs hold fewer than 100,003 resident threads), not a multiple
    of 32."""
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render import vpt as tvpt

    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    cam = Camera(position=(0.0, 0.15, 0.9), look_at_point=(0, 0, 0), width=1920, height=1080)
    basis = ttr._ray_basis(torch.as_tensor(cam.view_projection_matrix(), device=cuda))
    o = torch.as_tensor(np.asarray(cam.position, np.float32), device=cuda)
    _, kt, origins, dirs = tvpt.primary_rays(threefry.prng_key(1, cuda), o, basis, 1920, 1080)
    first = 540 * 1920 + 960 - n // 2  # around the frame's centre, into the cloud
    o_n, d_n = origins[first:first + n].contiguous(), dirs[first:first + n].contiguous()
    ev = _vpt_case(cuda, grid, o_n, d_n, kt, _vpt_defaults(grid), first=first)
    assert ev.shape == (n,) and (n < 33 or int(ev.max()) > 10)


@pytest.mark.parametrize("mode", ["Delta Tracking", "Spectral Delta Tracking"])
def test_vpt_tracking_divisors_not_powers_of_two(cuda, mode):
    """A majorant of 1000 and a box of a 40 x 48 x 64 grid (extents not
    powers of two): the kernel divides as the plain version does."""
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    grid = torch.as_tensor(_blob_cloud()[:40, :48].copy(), device=cuda)
    origins, dirs, kt, first = _vpt_row(cuda)
    ext = (1000.0, 900.0, 800.0) if mode == "Spectral Delta Tracking" else (1000.0,) * 3
    p = tvt.vpt_params(grid.shape, ext, (0.95, 0.9, 1.0), (0.58, 0.77, 0.27), (2.6, 2.5, 2.3),
                       0.2, mode, 256, "Trilinear")
    assert p.majorant == 1000.0 and p.extent[1] not in (0.25, 0.5, 1.0)
    ev = _vpt_case(cuda, grid, origins, dirs, kt, p, first=first)
    assert int(ev.max()) > 10


def test_vpt_tracking_one_event_and_all_missing(cuda):
    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    origins, dirs, kt, first = _vpt_row(cuda)
    ev = _vpt_case(cuda, grid, origins, dirs, kt, _vpt_defaults(grid, max_events=1), first=first)
    assert int(ev.max()) == 1
    away = -dirs  # from behind the camera, away from the box: every ray misses
    ev = _vpt_case(cuda, grid, origins, away, kt, _vpt_defaults(grid), first=first)
    assert not bool(ev.any())


@pytest.mark.parametrize("interpolation", ["Trilinear", "Nearest", "Stochastic"])
@pytest.mark.parametrize("mode", ["Delta Tracking", "Spectral Delta Tracking", "Ratio Tracking"])
def test_vpt_tracking_env_map_every_mode(cuda, mode, interpolation):
    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    origins, dirs, kt, first = _vpt_row(cuda)
    env = torch.as_tensor(np.random.default_rng(5).uniform(0, 2, (16, 32, 3)).astype(np.float32),
                          device=cuda)
    _vpt_case(cuda, grid, origins, dirs, kt, _vpt_defaults(grid, 128, mode, interpolation), env,
              first)


def test_vpt_launch_failure_raises(cuda):
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    origins, dirs, kt, first = _vpt_row(cuda, width=64, height=8, row=4)
    flat = torch.zeros((1, 4, 4), device=cuda)  # a grid one voxel deep: invalid
    p = tvt.vpt_params(flat.shape, (1024.0,) * 3, (1.0,) * 3, (0, 1, 0), (1, 1, 1), 0.0,
                       "Delta Tracking", 8, "Trilinear")
    with pytest.raises(RuntimeError, match="launch failed"):
        tvt.vpt_tracking(flat, origins, dirs, kt, p, first=first)


def test_render_vpt_launches_once_a_sample(cuda):
    from linevis_tpu_torch.kernels import vpt_tracking as tvt
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render import vpt as tvpt

    cam = Camera(position=(0.0, 0.15, 0.9), width=64, height=48)
    grid = torch.as_tensor(_blob_cloud(32), device=cuda)
    basis = ttr._ray_basis(torch.as_tensor(cam.view_projection_matrix(), device=cuda))
    o = torch.as_tensor(np.asarray(cam.position, np.float32), device=cuda)
    n0 = tvt.vpt_tracking.launches
    args = (grid, o, basis, 64, 48, tvpt.VptSettings(max_events=64))
    img = tvpt.render_vpt(threefry.prng_key(0, cuda), *args, spp=2)
    assert tvt.vpt_tracking.launches == n0 + 2
    cpu = tvpt.render_vpt(threefry.prng_key(0), grid.cpu(), o.cpu(), basis.cpu(), 64, 48,
                          tvpt.VptSettings(max_events=64), spp=2)
    assert float((img.cpu() - cpu).abs().mean()) <= 2e-3


# R3 on a SparseGrid, R7 (decomposition tracking), R8 (residual ratio tracking).


def _mixed_rays(cuda, width=480, height=270, row=135):
    """A row of the blob cloud's frame with every fourth ray turned away
    from the box (misses)."""
    origins, dirs, kt, first = _vpt_row(cuda, width, height, row)
    dirs = dirs.clone()
    dirs[::4] = -dirs[::4]
    return origins, dirs.contiguous(), kt, first


@pytest.mark.parametrize("interpolation", ["Trilinear", "Nearest", "Stochastic"])
@pytest.mark.parametrize("mode", ["Delta Tracking", "Spectral Delta Tracking", "Ratio Tracking"])
def test_vpt_sparse_grid_kernel_matches_plain(cuda, mode, interpolation):
    """R3 on a SparseGrid (a grid whose sides are not whole blocks, most
    blocks empty): bit for bit with its plain version on the same SparseGrid
    and with R3's launch on the dense grid; an environment map for Delta
    tracking."""
    from linevis_tpu_torch.kernels import vpt_tracking as tvt
    from linevis_tpu_torch.scene.sparse_grid import SparseGrid

    cloud = _blob_cloud()[:37, :45].copy()
    cloud[cloud < 0.3] = 0.0
    dense = torch.as_tensor(cloud, device=cuda)
    origins, dirs, kt, first = _mixed_rays(cuda)
    ext = (1024.0, 900.0, 800.0) if mode == "Spectral Delta Tracking" else (1024.0,) * 3
    p = tvt.vpt_params(dense.shape, ext, (0.95, 0.9, 1.0), (0.58, 0.77, 0.27), (2.6, 2.5, 2.3),
                       0.2, mode, 512, interpolation)
    env = None
    if mode == "Delta Tracking":
        env = torch.as_tensor(np.random.default_rng(3).uniform(0, 2, (16, 32, 3)).astype(
            np.float32), device=cuda)
    for block in (8, 5):
        sg = SparseGrid.from_dense(cloud, block, device=cuda)
        assert 0 < sg.n_active < int(np.prod(sg.table.shape))
        ev_k = torch.empty(origins.shape[0], dtype=torch.int32, device=cuda)
        ev_p = torch.empty_like(ev_k)
        n0 = tvt.vpt_tracking.launches
        got = tvt.vpt_tracking(sg, origins, dirs, kt, p, env, events=ev_k, first=first)
        assert tvt.vpt_tracking.launches == n0 + 1
        ref = tvt.vpt_tracking_reference(sg, origins, dirs, kt, p, env, events=ev_p, first=first)
        on_dense = tvt.vpt_tracking(dense, origins, dirs, kt, p, env, first=first)
        for a, b, c in zip(got, ref, on_dense):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(ev_k, ev_p) and int(ev_k.max()) > 10 and not bool(ev_k[::4].any())


_DECOMPOSITION_CASES = {
    "size8": dict(size=8, crop=False, albedo=0.9, g=0.2, env=False, max_events=512),
    "size4_ragged_env": dict(size=4, crop=True, albedo=0.8, g=0.3, env=True, max_events=512),
    "size8_ragged_isotropic": dict(size=8, crop=True, albedo=0.95, g=0.0, env=False,
                                   max_events=512),
    "event_cap": dict(size=8, crop=False, albedo=0.9, g=0.2, env=False, max_events=6),
}


def _vpt_scene(cuda, case):
    cloud = _blob_cloud()
    if case["crop"]:
        cloud = cloud[:37, :45].copy()  # sides that are not multiples of 4 or 8
    grid = torch.as_tensor(cloud, device=cuda)
    env = None
    if case["env"]:
        env = torch.as_tensor(np.random.default_rng(3).uniform(0, 2, (16, 32, 3)).astype(
            np.float32), device=cuda)
    return grid, env


@pytest.mark.parametrize("case", list(_DECOMPOSITION_CASES))
def test_vpt_decomposition_kernel_matches_plain(cuda, case):
    """R7 against its plain version on a row with misses, bit for bit, events
    and their kinds included: absorption (albedo < 1), Henyey-Greenstein and isotropic
    phases, an environment map, super voxels of 4 and 8 on a grid whose sides
    are not multiples of them, and rays stopped at the event cap."""
    from linevis_tpu_torch.kernels import vpt_decomposition as tvd
    from linevis_tpu_torch.render.super_voxel import build_super_voxel_minmax

    c = _DECOMPOSITION_CASES[case]
    grid, env = _vpt_scene(cuda, c)
    dmin, dmax = build_super_voxel_minmax(grid, c["size"])
    origins, dirs, kt, first = _mixed_rays(cuda)
    p = tvd.decomposition_params(grid.shape, dmin.shape, (1024.0,) * 3, (c["albedo"],) * 3,
                                 (0.58, 0.77, 0.27), (2.6, 2.5, 2.3), c["g"], c["max_events"])
    ev_k = torch.full((origins.shape[0],), -1, dtype=torch.int32, device=cuda)
    ev_p = torch.empty_like(ev_k)
    kinds_k = torch.full((origins.shape[0], len(tvd.EVENT_KINDS)), -1, dtype=torch.int32,
                         device=cuda)
    kinds_p = torch.empty_like(kinds_k)
    n0 = tvd.vpt_decomposition.launches
    got = tvd.vpt_decomposition(grid, dmin, dmax, origins, dirs, kt, p, env, ev_k, first,
                                kinds_k)
    assert tvd.vpt_decomposition.launches == n0 + 1
    again = tvd.vpt_decomposition(grid, dmin, dmax, origins, dirs, kt, p, env, first=first)
    ref = tvd.vpt_decomposition_reference(grid, dmin, dmax, origins, dirs, kt, p, env, ev_p,
                                          first, kinds_p)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b) and torch.equal(a, r)
    assert torch.equal(ev_k, ev_p) and not bool(ev_k[::4].any())
    assert torch.equal(kinds_k, kinds_p) and torch.equal(kinds_k[:, :6].sum(1), ev_k)
    absorbed = (got[0] == 0).all(1) & (ev_k > 0)
    if c["max_events"] < 512:
        assert int((ev_k == c["max_events"]).sum()) > 10
    else:
        assert int(ev_k.max()) > 20 and bool(absorbed.any()) and bool((~absorbed).any())


_RR_CASES = {
    "size8": dict(size=8, crop=False, albedo=0.9, g=0.2, env=False, caps=(10, 64, 256)),
    "size4_ragged_env": dict(size=4, crop=True, albedo=0.8, g=0.3, env=True,
                             caps=(10, 64, 256)),
    "size8_ragged_isotropic": dict(size=8, crop=True, albedo=1.0, g=0.0, env=False,
                                   caps=(10, 64, 256)),
    "caps": dict(size=4, crop=False, albedo=0.9, g=0.2, env=False, caps=(1, 5, 3)),
}


@pytest.mark.parametrize("case", list(_RR_CASES))
def test_vpt_residual_ratio_kernel_matches_plain(cuda, case):
    """R8 against its plain version on a row with misses, bit for bit, its
    DDA and residual steps included: albedo < 1, both phases, an environment
    map, super voxels of 4 and 8 on a ragged grid, and rays cut at the
    bounce, DDA and segment caps (which change the result); the steps count
    each ray's bounces, DDA steps and residual steps."""
    from linevis_tpu_torch.kernels import vpt_residual_ratio as tvr
    from linevis_tpu_torch.render.super_voxel import build_super_voxel_grid

    c = _RR_CASES[case]
    grid, env = _vpt_scene(cuda, c)
    sv = build_super_voxel_grid(grid, 1024.0, c["size"])
    origins, dirs, kt, first = _mixed_rays(cuda, 240, 135, 67)
    it, sv_steps, seg_steps = c["caps"]

    def params(*caps):
        return tvr.rr_params(grid.shape, sv.mu_c.shape, (1024.0,) * 3, (c["albedo"],) * 3,
                             (0.58, 0.77, 0.27), (2.6, 2.5, 2.3), c["g"], 1.0, *caps)

    p = params(it, sv_steps, seg_steps)
    st_k = torch.full((origins.shape[0], 3), -1, dtype=torch.int32, device=cuda)
    st_p = torch.empty_like(st_k)
    n0 = tvr.vpt_residual_ratio.launches
    got = tvr.vpt_residual_ratio(grid, sv, origins, dirs, kt, p, env, st_k, first)
    assert tvr.vpt_residual_ratio.launches == n0 + 1
    again = tvr.vpt_residual_ratio(grid, sv, origins, dirs, kt, p, env, first=first)
    ref = tvr.vpt_residual_ratio_reference(grid, sv, origins, dirs, kt, p, env, st_p, first)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b) and torch.equal(a, r)
    assert torch.equal(st_k, st_p) and bool(got[2].any()) and int(st_k[:, 2].max()) > 0
    assert int(st_k[:, 0].min()) >= 1 and int(st_k[:, 0].max()) <= it + 1
    if it < 10:
        assert int(st_k[:, 0].max()) == it + 1
        assert int(st_k[:, 1].max()) <= (it + 1) * sv_steps
        free = tvr.vpt_residual_ratio(grid, sv, origins, dirs, kt, params(), env, first=first)
        assert not torch.equal(free[0], got[0])


def _schedule_rays(cuda, case):
    """Rays for the persistent warps' schedule cases, from rows 100-169 of
    the blob cloud's 480x270 frame (every fourth turned away: misses), ray i
    keyed split(kt, .)[first + i]: `n` rays of row 100 from pixel `start`
    on, or ("interleaved") the 70 rows with rays from across them in each
    warp, so that one warp holds misses, grazing rays and rays through the
    densest blobs."""
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render import vpt as tvpt

    cam = Camera(position=(0.0, 0.15, 0.9), look_at_point=(0, 0, 0), width=480, height=270)
    basis = ttr._ray_basis(torch.as_tensor(cam.view_projection_matrix(), device=cuda))
    o = torch.as_tensor(np.asarray(cam.position, np.float32), device=cuda)
    _, kt, origins, dirs = tvpt.primary_rays(threefry.prng_key(1, cuda), o, basis, 480, 270)
    dirs = dirs.clone()
    dirs[::4] = -dirs[::4]
    first = 100 * 480
    if case == "interleaved":
        n = 70 * 480
        perm = first + torch.arange(n, device=cuda).reshape(32, -1).t().reshape(-1)
        return origins[perm].contiguous(), dirs[perm].contiguous(), kt, first
    n, start = {"n0": (0, 0), "n1": (1, 240), "n31": (31, 230), "n33": (33, 223),
                "n1000_first": (1000, 97)}[case]
    sl = slice(first + start, first + start + n)
    return origins[sl].contiguous(), dirs[sl].contiguous(), kt, first + start


_SCHEDULE_CASES = ["n0", "n1", "n31", "n33", "n1000_first", "interleaved"]


@pytest.mark.parametrize("case", _SCHEDULE_CASES)
def test_vpt_decomposition_schedule(cuda, case):
    """R7's persistent warps refilling lanes: counts below a warp, not a
    multiple of 32 and none, a slice keyed from an offset (`first`), and
    warps whose rays differ wildly in cost; each bit for bit with the plain
    version (events and their kinds included), two launches equal."""
    from linevis_tpu_torch.kernels import vpt_decomposition as tvd
    from linevis_tpu_torch.render.super_voxel import build_super_voxel_minmax

    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    dmin, dmax = build_super_voxel_minmax(grid, 8)
    origins, dirs, kt, first = _schedule_rays(cuda, case)
    p = tvd.decomposition_params(grid.shape, dmin.shape, (1024.0,) * 3, (0.9,) * 3,
                                 (0.58, 0.77, 0.27), (2.6, 2.5, 2.3), 0.2, 512)
    n = origins.shape[0]
    ev_k, ev_p = (torch.full((n,), -1, dtype=torch.int32, device=cuda) for _ in range(2))
    kinds_k, kinds_p = (torch.full((n, len(tvd.EVENT_KINDS)), -1, dtype=torch.int32, device=cuda)
                        for _ in range(2))
    got = tvd.vpt_decomposition(grid, dmin, dmax, origins, dirs, kt, p, events=ev_k,
                                first=first, kinds=kinds_k)
    again = tvd.vpt_decomposition(grid, dmin, dmax, origins, dirs, kt, p, first=first)
    ref = tvd.vpt_decomposition_reference(grid, dmin, dmax, origins, dirs, kt, p, events=ev_p,
                                          first=first, kinds=kinds_p)
    for a, b, r in zip(got, again, ref):
        assert a.shape[0] == n and torch.equal(a, b) and torch.equal(a, r)
    assert torch.equal(ev_k, ev_p) and torch.equal(kinds_k, kinds_p)
    if case == "interleaved":
        warp_max = ev_k.reshape(-1, 32).max(1).values.double()
        assert float(ev_k.double().sum() / (32 * warp_max.sum())) < 0.5  # uneven warps
        assert int(ev_k.max()) == 512 and not bool(ev_k.reshape(-1, 32).min(1).values.any())


@pytest.mark.parametrize("case", _SCHEDULE_CASES)
def test_vpt_residual_ratio_schedule(cuda, case):
    """R8's persistent warps refilling lanes, in the cases of
    `test_vpt_decomposition_schedule`: bit for bit with the plain version
    (bounces, DDA and residual steps included), two launches equal; the
    transmittance too."""
    from linevis_tpu_torch.kernels import vpt_residual_ratio as tvr
    from linevis_tpu_torch.render.super_voxel import build_super_voxel_grid

    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    sv = build_super_voxel_grid(grid, 1024.0, 8)
    origins, dirs, kt, first = _schedule_rays(cuda, case)
    if case == "interleaved":  # the plain version's time: a quarter of the frame
        origins, dirs = origins[:8192].contiguous(), dirs[:8192].contiguous()
    p = tvr.rr_params(grid.shape, sv.mu_c.shape, (1024.0,) * 3, (0.9,) * 3, (0.58, 0.77, 0.27),
                      (2.6, 2.5, 2.3), 0.2)
    n = origins.shape[0]
    st_k, st_p = (torch.full((n, 3), -1, dtype=torch.int32, device=cuda) for _ in range(2))
    got = tvr.vpt_residual_ratio(grid, sv, origins, dirs, kt, p, steps=st_k, first=first)
    again = tvr.vpt_residual_ratio(grid, sv, origins, dirs, kt, p, first=first)
    ref = tvr.vpt_residual_ratio_reference(grid, sv, origins, dirs, kt, p, steps=st_p,
                                           first=first)
    for a, b, r in zip(got, again, ref):
        assert a.shape[0] == n and torch.equal(a, b) and torch.equal(a, r)
    assert torch.equal(st_k, st_p)
    p0 = tvr.rr_params(grid.shape, sv.mu_c.shape, 1024.0, 0.0)
    T = tvr.rr_transmittance(grid, sv, origins, dirs, kt, p0, first=first)
    assert torch.equal(T, tvr.rr_transmittance(grid, sv, origins, dirs, kt, p0, first=first))
    assert torch.equal(T, tvr.rr_transmittance_reference(grid, sv, origins, dirs, kt, p0,
                                                         first=first))
    if case == "interleaved":
        res = st_k[:, 2].reshape(-1, 32)
        assert float(res.double().sum() / (32 * res.max(1).values.double().sum())) < 0.5
        assert not bool(res.min(1).values.any())


def test_vpt_rr_transmittance_kernel_matches_plain(cuda):
    """`residual_ratio_transmittance` on the card launches R8 (one DDA,
    albedo 0), bit for bit with the plain tracer, also at small caps."""
    from linevis_tpu_torch.kernels import vpt_residual_ratio as tvr
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render.super_voxel import (
        build_super_voxel_grid,
        residual_ratio_transmittance,
    )

    grid = torch.as_tensor(_blob_cloud(), device=cuda)
    sv = build_super_voxel_grid(grid, 300.0, 4)
    origins, dirs, _, _ = _mixed_rays(cuda)
    key = threefry.prng_key(2, cuda)
    for caps in ((64, 256), (4, 2)):
        n0 = tvr.vpt_residual_ratio.launches
        T = residual_ratio_transmittance(key, grid, sv, origins, dirs, 300.0, *caps)
        assert tvr.vpt_residual_ratio.launches == n0 + 1
        p = tvr.rr_params(grid.shape, sv.mu_c.shape, 300.0, 0.0, max_sv_steps=caps[0],
                          max_steps_per_sv=caps[1])
        assert torch.equal(T, tvr.rr_transmittance_reference(grid, sv, origins, dirs, key, p))
        assert bool((T[::4] == 1.0).all()) and float(T.min()) < 0.5


def test_vpt_trace_rays_reaches_no_plain_version(cuda, monkeypatch):
    """With every plain version of R3, R7 and R8 patched to raise,
    `vpt_trace_rays` on CUDA tensors still traces all five modes and a
    SparseGrid, and `residual_ratio_transmittance` its rays."""
    from linevis_tpu_torch.kernels import vpt_decomposition as tvd
    from linevis_tpu_torch.kernels import vpt_residual_ratio as tvr
    from linevis_tpu_torch.kernels import vpt_tracking as tvt
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render import super_voxel as tsv
    from linevis_tpu_torch.render import vpt as tvpt
    from linevis_tpu_torch.scene.sparse_grid import SparseGrid

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card path")

    for mod, name in ((tvt, "vpt_tracking_reference"), (tvd, "vpt_decomposition_reference"),
                      (tvr, "vpt_residual_ratio_reference"), (tvr, "rr_transmittance_reference"),
                      (tsv, "_rr_segments"), (tsv, "make_residual_ratio_tracer")):
        monkeypatch.setattr(mod, name, refuse)
    cloud = _blob_cloud(32)
    grid = torch.as_tensor(cloud, device=cuda)
    origins, dirs, kt, _ = _mixed_rays(cuda, 64, 48, 24)
    args = ((1024.0,) * 3, (0.9,) * 3, (0.58, 0.77, 0.27), (2.6, 2.5, 2.3))
    for g, mode in [(grid, m) for m in tvpt.VPT_MODES] + [
            (SparseGrid.from_dense(cloud, 8, device=cuda), "Delta Tracking")]:
        rad, fx, fh = tvpt.vpt_trace_rays(kt, g, origins, dirs, *args, phase_g=0.2, mode=mode,
                                          super_voxel_size=4)
        assert rad.device == origins.device and bool(torch.isfinite(rad).all())
    sv = tsv.build_super_voxel_grid(grid, 300.0, 4)
    T = tsv.residual_ratio_transmittance(threefry.prng_key(1, cuda), grid, sv, origins, dirs,
                                         300.0)
    assert T.shape == (origins.shape[0],)


def test_density_march_kernel_matches_plain(cuda):
    from linevis_tpu_torch.kernels import density_march as tdm
    from linevis_tpu_torch.render.transfer_function import TransferFunction

    field = torch.as_tensor(_blob_cloud(64, seed=11), device=cuda)
    cam = Camera(position=(0.0, 0.1, 0.8), width=1920, height=1080)
    basis = ttr._ray_basis(torch.as_tensor(cam.view_projection_matrix(), device=cuda))
    o = torch.as_tensor(np.asarray(cam.position, np.float32), device=cuda)
    prm, _ = tdm.march_params(field.shape, (-0.25,) * 3, (0.25,) * 3, o, basis, 1920, 1080, 200.0,
                              (1.0, 1.0, 1.0, 0.0))
    c_pts, _ = TransferFunction.standard().as_static_points()
    o_pts = ((0.0, 0.0), (0.05, 1.0), (1.0, 1.0))
    n0 = tdm.density_march.launches
    got = tdm.density_march(field, prm, 1920, 1080, 256, c_pts, o_pts)
    assert tdm.density_march.launches == n0 + 1
    ref = tdm.density_march_reference(field, prm, 1920, 1080, 256, c_pts, o_pts)
    assert torch.equal(got, ref) and float(got[..., 3].max()) > 0.5


def _sparse_field(shape, seed=5):
    """A line-density-like field: a few blobs in one part of the grid, zero
    elsewhere, so that most bricks are empty."""
    rng = np.random.default_rng(seed)
    out = np.zeros(shape, np.float32)
    for _ in range(6):
        c = [rng.integers(n // 8, n // 2) for n in shape]
        r = [rng.integers(2, 6) for _ in shape]
        sl = tuple(slice(ci, ci + ri) for ci, ri in zip(c, r))
        out[sl] = rng.uniform(0.0, 1.0, out[sl].shape).astype(np.float32)
    return out


def _march_case(cuda, field, b_min, b_max, position, width, height, n_steps=256,
                o_pts=((0.0, 0.0), (0.05, 1.0), (1.0, 1.0)), basis=None, skip=True, c_pts=None):
    """R4 against its plain version on one frame: every output bit equal (int32 views,
    NaN-safe), one launch counted, the skip rule on or off as expected."""
    from linevis_tpu_torch.kernels import density_march as tdm
    from linevis_tpu_torch.render.transfer_function import TransferFunction

    f = torch.as_tensor(field, device=cuda)
    cam = Camera(position=position, look_at_point=(0.0, 0.0, 0.0), width=width, height=height)
    if basis is None:
        basis = ttr._ray_basis(torch.as_tensor(cam.view_projection_matrix(), device=cuda))
    o = torch.as_tensor(np.asarray(position, np.float32), device=cuda)
    prm, _ = tdm.march_params(f.shape, b_min, b_max, o, basis, width, height, 200.0,
                              (1.0, 1.0, 1.0, 0.0))
    if c_pts is None:
        c_pts, _ = TransferFunction.standard().as_static_points()
    assert tdm.skip_allowed(prm, c_pts, o_pts) == skip
    n0 = tdm.density_march.launches
    got = tdm.density_march(f, prm, width, height, n_steps, c_pts, o_pts)
    assert tdm.density_march.launches == n0 + 1
    ref = tdm.density_march_reference(f, prm, width, height, n_steps, c_pts, o_pts)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    return got


_BOX = ((-0.25,) * 3, (0.25,) * 3)


@pytest.mark.parametrize("case", [
    "box_not_cubic_nor_pow2", "nan_and_negative_cells", "opacity_at_zero", "camera_inside",
    "axis_parallel_rays", "grid_not_whole_bricks", "steps_0", "steps_1", "frame_not_whole_tiles",
    "tf_table_in_global_memory"])
def test_density_march_kernel_cases(cuda, case):
    """R4 bit for bit against its plain version: the IEEE divisions (a box that is not
    cubic, its extents no powers of two), NaN and negative cells in an empty field (NaN
    counts as occupied), an opacity TF not 0 at density 0 (no skipping), a camera inside
    the box, rays parallel to two axes (|d| < 1e-9), a grid of no whole bricks, 0 and 1
    steps, a frame of no whole 16x8 tiles, a colour TF of 600 points (a table of 5,407
    floats: past the 4,096 that shared memory holds, read from global memory)."""
    field = _sparse_field((64, 64, 64))
    pos = (-0.6, -0.45, -0.55)
    if case == "box_not_cubic_nor_pow2":
        _march_case(cuda, field, (-0.2, -0.3, -0.17), (0.21, 0.25, 0.2), pos, 480, 270)
    elif case == "nan_and_negative_cells":
        f = np.zeros((64, 64, 64), np.float32)
        f[10, 20, 30] = np.nan
        f[12, 40, 9] = -0.5
        f[30, 30, 30] = 0.8
        got = _march_case(cuda, f, *_BOX, pos, 480, 270)
        from linevis_tpu_torch.kernels.volume_common import brick_occupancy

        occ = brick_occupancy(torch.as_tensor(f, device=cuda))
        assert int(occ[1, 2, 3]) == 1 and int(occ[1, 5, 1]) == 0 and int(occ.sum()) == 2
        assert bool(torch.isfinite(got).all())  # NaN's density takes the TF's first values
    elif case == "opacity_at_zero":
        got = _march_case(cuda, field, *_BOX, pos, 480, 270, o_pts=((0.0, 0.2), (1.0, 1.0)),
                          skip=False)
        assert float(got[..., 3].max()) > 0.5
    elif case == "camera_inside":
        _march_case(cuda, field, *_BOX, (0.05, -0.02, 0.1), 320, 200)
    elif case == "axis_parallel_rays":
        # A basis whose first row is 0: every ray has d.x = 0 exactly (and the
        # middle row's d.y is within 1e-9 of 0), its x slab unbounded.
        basis = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.3, 0.0], [0.0, 0.0, 1.0]], device=cuda)
        _march_case(cuda, field, *_BOX, (0.01, 0.02, -0.6), 161, 91, basis=basis)
    elif case == "grid_not_whole_bricks":
        got = _march_case(cuda, _sparse_field((37, 42, 50), seed=6), *_BOX, pos, 480, 270)
        assert float(got[..., 3].max()) > 0.1
    elif case in ("steps_0", "steps_1"):
        _march_case(cuda, field, *_BOX, pos, 240, 135, n_steps=int(case[-1]))
    elif case == "tf_table_in_global_memory":
        x = np.linspace(0.0, 1.0, 600)
        rgb = np.random.default_rng(8).uniform(0.0, 1.0, (600, 3))
        c_pts = tuple((float(xi), *map(float, c)) for xi, c in zip(x, rgb))
        dense = np.random.default_rng(9).uniform(0.0, 1.0, (16, 16, 16)).astype(np.float32)
        # 48 steps of the plain version's 599 segments: a few seconds.
        got = _march_case(cuda, dense, *_BOX, pos, 120, 68, n_steps=48, c_pts=c_pts)
        assert float(got[..., 3].max()) > 0.1
    else:
        _march_case(cuda, field, *_BOX, pos, 75, 43)


def test_heatmap_kernel_matches_plain(cuda):
    from linevis_tpu_torch.kernels import spherical_heatmap as tsh
    from linevis_tpu_torch.render.spherical_heatmap import mollweide_points

    d = torch.as_tensor(np.random.default_rng(9).normal(size=(8192, 3)).astype(np.float32),
                        device=cuda)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    d[:2048] = d[:1] + 0.02 * d[:2048]  # a dense lobe
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    pts, _ = mollweide_points(256, cuda)
    n0 = tsh.heatmap_density.launches
    got = tsh.heatmap_density(pts, d, 512)
    assert tsh.heatmap_density.launches == n0 + 1
    ref = tsh.heatmap_density_reference(pts, d)
    assert torch.equal(got, ref) and float(ref.max()) > 100.0


def _unit_dirs(cuda, n, seed=9, lobe=0):
    d = torch.as_tensor(np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32),
                        device=cuda)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    if lobe:  # the first `lobe` directions in one cap around the first
        d[:lobe] = d[:1] + 0.02 * d[:lobe]
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return d


def _heatmap_case(cuda, pts, width, d):
    """The kernel with its counts against the plain version: the sum bit for
    bit, every tile's pairs in range equal to the plain count and no more
    than its candidates at each of its pixels; two launches equal."""
    from linevis_tpu_torch.kernels import spherical_heatmap as tsh

    tx, ty = tsh.heatmap_tiles(pts.shape[0], width)
    counts = torch.full((tx * ty, 2), -1, dtype=torch.int64, device=cuda)
    got = tsh.heatmap_density(pts, d, width, counts)
    assert torch.equal(got, tsh.heatmap_density(pts, d, width))
    assert torch.equal(got, tsh.heatmap_density_reference(pts, d))
    tile_of, _ = tsh.heatmap_tile_candidates(pts, width, d)
    in_range = torch.zeros(tx * ty, dtype=torch.int64, device=cuda).index_add_(
        0, tile_of, tsh.heatmap_in_range(pts, d))
    assert torch.equal(counts[:, 1], in_range)
    assert bool((counts[:, 0] * tsh.TILE[0] * tsh.TILE[1] >= counts[:, 1]).all())
    return got, counts


@pytest.mark.parametrize("height", [1, 2, 31])
def test_heatmap_kernel_ragged_maps(cuda, height):
    from linevis_tpu_torch.render.spherical_heatmap import mollweide_points

    pts, _ = mollweide_points(height, cuda)
    _heatmap_case(cuda, pts, 2 * height, _unit_dirs(cuda, 4096, lobe=512))
    # A layout whose rows are not a multiple of the tile and whose last row
    # is short.
    g = _unit_dirs(cuda, 1000, seed=4)
    _heatmap_case(cuda, g, 37, _unit_dirs(cuda, 4096, lobe=512))
    g[::7] = float("nan")  # points without a place on the sphere add nothing
    _heatmap_case(cuda, g, 37, _unit_dirs(cuda, 4096, lobe=512))


def test_heatmap_term_equals_ieee_on_every_float(cuda):
    """The kernel's branch-free term equals the library's IEEE term on all
    2^32 float bit patterns of the squared distance: the walk adds what
    the plain version adds whatever the inputs."""
    from linevis_tpu_torch.kernels import spherical_heatmap as tsh

    assert tsh.heatmap_term_mismatches(cuda) == 0


def test_heatmap_kernel_no_directions(cuda):
    from linevis_tpu_torch.render.spherical_heatmap import mollweide_points

    pts, _ = mollweide_points(64, cuda)
    got, counts = _heatmap_case(cuda, pts, 128, torch.zeros((0, 3), device=cuda))
    assert not bool(got.any()) and not bool(counts.any())


def test_heatmap_kernel_every_direction_in_one_cap(cuda):
    from linevis_tpu_torch.render.spherical_heatmap import mollweide_points

    pts, _ = mollweide_points(64, cuda)
    d = _unit_dirs(cuda, 6000, lobe=6000)  # more than the kernel stages before a walk
    got, counts = _heatmap_case(cuda, pts, 128, d)
    assert float(got.max()) > 1000.0 and int(counts[:, 0].max()) == 6000


def test_threefry_uniform_kernel_at_folded_keys(cuda):
    """R6 at the keys of a ray-sharded frame's ranks, fold_in(PRNGKey(seed +
    frame), rank) (`parallel/mesh.py`), bit for bit against
    `ops/threefry.py:uniform` of each half of the split."""
    from linevis_tpu_torch.kernels.threefry_uniform import threefry_uniform
    from linevis_tpu_torch.ops import threefry

    for seed, rank in ((0, 0), (0, 1), (7, 2), (123, 2**31 - 1), (5, 2**32 - 1)):
        key = threefry.fold_in(threefry.prng_key(seed, cuda), rank)
        for j in (0, 1):
            got = threefry_uniform(key, (4, 135, 240), split=j)
            want = threefry.uniform(threefry.split_at(key, j), (4, 135, 240))
            assert torch.equal(got, want)


@pytest.mark.parametrize("band", [0, 1, 2])
def test_band_of_three_kernels_match_plain(cuda, band):
    """Band `band` of 3 at 1920x1080 (360 rows: 45 tiles of 8), the band
    layout of `parallel/mesh.py`: B3 on the band's CSR binning bit for bit,
    and B2 on the band's MLAB prep (its params carry the band window) in
    composite and node mode at `test_mlab_kernel_matches_plain`'s bars."""
    from linevis_tpu_torch.parallel import mesh as pm

    W, H, n = 1920, 1080, 3
    vp, cp, ab = ttr.camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H), cuda)
    pos, mask, attrs, radius = _walk(11, 10, 8, 0.02)
    bs = RasterSettings(width=W, height=H // n, tile_w=16, tile_h=8, depth_cue_strength=0.2)
    mesh = build_tube_triangle_mesh(pos, mask, attrs, radius=radius, device=cuda)
    _, csr = pm._band_binning(mesh, vp, bs, band, n)
    k = trp.rasterize_gbuffer(csr, 8, 16, 8)
    p = trp.rasterize_triangles_reference(csr, 16, 8, 8)
    torch.cuda.synchronize()
    assert (k[1] >= 0).sum().item() > 100
    _all_equal(k, p)

    scene = ttr.build_capsule_scene(pos, mask, attrs, radius, device=cuda)
    csr, params = toit.prepare_mlab_frame(scene, vp, cp, ab, bs, 0.3, y_offset=band * bs.height,
                                          full_height=H)
    args = (csr, params, W, H // n, 16, 8, 8, bs.tf_color, bs.tf_opacity)
    kc = rasterize_capsules_mlab(*args, deferred_shade=True, composite=True)
    pc = rasterize_capsules_mlab_reference(*args, deferred_shade=True, composite=True)
    assert bool(torch.isfinite(kc).all()) and (kc[3] > 0).sum().item() > 100
    assert ((kc - pc).abs().amax(dim=0) <= 1e-4).float().mean().item() >= 0.999
    (kd, kf, ka), (pd, pf, pa) = (f(*args, deferred_shade=True) for f in (
        rasterize_capsules_mlab, rasterize_capsules_mlab_reference))
    ok = ((kd - pd).abs().amax(dim=0) <= 1e-5) & ((ka - pa).abs().amax(dim=0) <= 1e-5)
    assert ok.float().mean().item() >= 0.999
    assert (kf - pf).abs().amax(dim=(0, 1))[ok].max().item() <= 1e-5
