"""linevis_tpu_torch capsule tube frame vs the JAX package on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode) and its port (plain PyTorch versions on CPU tensors), held
to these bars:
- segment ids equal on >= 99.9% of pixels;
- z_ndc and the G-buffer within 1e-5 where the ids agree, on all but at
  most 1% of the hit pixels. Those few sit at the float32 noise floor of
  the geometry: the re-origined ray start oa' = oa + t0*dn is rounded at
  the camera distance (~1.4, ulp 1.2e-7) and the attribute's position
  along the segment divides by |ba|^2 (~1e-2), while XLA's FMA contraction
  rounds once less than the port's separate multiply and add. There both
  sides must lie within 5e-5 of each other and of a float64 evaluation of
  the same capsule (measured: at most 2.6e-5, on 5 of 1081 hit pixels);
- coverage within 2e-3. The port takes the body's AA miss distance as the
  ray-to-axis line distance, equal to the JAX kernel's r^2 - h/(k2 |ba|^2)
  but free of its float32 cancellation at tornado scale (ROADMAP queue C);
- whole images at SSIM >= 0.999 and mean abs difference <= 2e-3, and the
  checked-in golden at the golden harness's bar.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from linevis_tpu.kernels.raster_capsule import rasterize_capsules_pallas
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu.render.transfer_function import TransferFunction as JTF
from linevis_tpu_torch.convert import capsule_scene_from_numpy
from linevis_tpu_torch.entry import entry, tornado_scene
from linevis_tpu_torch.kernels.raster_capsule import (
    rasterize_capsules,
    rasterize_capsules_reference,
)
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "opaque_tubes.png")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _two_segments():
    pos = np.array(
        [[[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]],
         [[0.0, -0.3, 0.1], [0.0, 0.3, 0.1]]], np.float32,
    )
    attrs = np.array([[0.2, 0.8], [0.4, 0.6]], np.float32)
    return pos, np.ones((2, 2), bool), attrs, 0.08


def _walk(L=10, P=8, seed=11, radius=0.02):
    # tests/golden_scenes.py:_walk_scene's inputs.
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


SCENES = {"two_segments": (_two_segments, 64, 32), "walk": (_walk, 160, 120)}


def _scenes(name):
    make, W, H = SCENES[name]
    pos, mask, attrs, radius = make()
    return (
        jtr.build_capsule_scene(pos, mask, attrs, radius),
        ttr.build_capsule_scene(pos, mask, attrs, radius, device="cpu"),
        W, H,
    )


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """Route the JAX kernel's `pl.reciprocal(approx=True)` to the exact
    reciprocal. On the CPU, Pallas emulates approx=True in bfloat16
    (jax/_src/pallas/primitives.py, `_reciprocal_lowering_rule`), which
    moves the AA coverage by up to ~2e-2 through the cancellation in
    r^2 - h / (k2 |ba|^2); the TPU's approximate reciprocal (2^-12) and the
    port's exact one are both far below the 2e-3 coverage bar."""
    exact = pl.reciprocal
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: exact(x))
    yield
    jax.clear_caches()


def _camera_arrays(cam):
    return (cam.view_projection_matrix(), np.asarray(cam.position, np.float32),
            jtr._proj_constants(cam))


def _winner_f64(payload, start, count, params, tile, p, seg, tiles_x, tile_w,
                tile_h, W, H, use_aa):
    """float64 evaluation of segment `seg`'s capsule hit at pixel p of
    `tile`: (z_ndc, attr, nx, ny, nz). Mirrors the kernel's formulas."""
    run = payload[:, start[tile]:start[tile] + count[tile]].astype(np.float64)
    s = run[:, np.nonzero(run[9] == seg)[0][0]]
    q = params.astype(np.float64)
    gx = (tile % tiles_x) * tile_w + p % tile_w + 0.5
    gy = (tile // tiles_x) * tile_h + p // tile_w + 0.5
    un = gx * (2.0 / W) - 1.0
    vn = 1.0 - gy * (2.0 / H)
    d = np.array([q[0] * un + q[1] * vn + q[2], q[3] * un + q[4] * vn + q[5],
                  q[6] * un + q[7] * vn + q[8]])
    invlen = 1.0 / np.linalg.norm(d)
    dn = d * invlen
    oa, ba, r = s[0:3], s[3:6], s[6]
    baba = s[10]
    bard, rdoa = ba @ dn, oa @ dn
    t0 = -(rdoa + 0.5 * bard)
    oap = oa + t0 * dn
    baoa, oaoa, rd = ba @ oap, oap @ oap, rdoa + t0
    rr = r * r
    k2 = max(baba - bard * bard, 1e-20)
    k1 = baba * rd - baoa * bard
    h = k1 * k1 - k2 * (baba * oaoa - baoa * baoa - rr * baba)
    tb = (-k1 - np.sqrt(max(h, 0.0))) / k2
    ha = rd * rd - (oaoa - rr)
    ta = -rd - np.sqrt(max(ha, 0.0))
    b1b = rd - bard
    hb = b1b * b1b - (oaoa - 2.0 * baoa + baba - rr)
    tbb = -b1b - np.sqrt(max(hb, 0.0))

    def sd(d2, t):
        return (r - np.sqrt(max(d2, 0.0))) / (max((t0 + t) * invlen, 1e-6) * q[19])

    if use_aa:
        okb = sd(rr - h / (k2 * baba), tb) > -0.5
        oka = sd(rr - ha, ta) > -0.5
        okb2 = sd(rr - hb, tbb) > -0.5
    else:
        okb, oka, okb2 = h >= 0, ha >= 0, hb >= 0
    okb &= (0 < baoa + tb * bard < baba) and t0 + tb > 0
    oka &= baoa + ta * bard <= 0 and s[13] > 0.5 and t0 + ta > 0
    okb2 &= baoa + tbb * bard >= baba and t0 + tbb > 0
    tall = min(tb if okb else np.inf, ta if oka else np.inf, tbb if okb2 else np.inf)
    uax = np.clip((baoa + tall * bard) / baba, 0.0, 1.0)
    z = q[9] - q[10] / max((t0 + tall) * invlen, 1e-12)
    n = tall * dn + oap - ba * uax
    return np.array([z, s[7] + s[8] * uax, *n])


@pytest.mark.parametrize("use_aa", [False, True], ids=["aa_off", "aa_on"])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_rasterize_capsules_reference_matches_pallas(
    exact_reciprocal, scene_name, use_aa
):
    js, ts, W, H = _scenes(scene_name)
    kw = dict(width=W, height=H, tile_w=16, tile_h=8, chunk=16, span_x=4,
              span_y=4, aa=use_aa)
    vp, cp, ab = _camera_arrays(JCamera(position=(0.1, 0.2, 1.4), width=W, height=H))
    margin = 0.5 if use_aa else 0.0
    csr, params, _ = jtr.prepare_capsule_frame(
        js, jnp.asarray(vp), jnp.asarray(cp), jnp.asarray(ab), JSettings(**kw),
        aa_margin=margin,
    )
    jz, jid, jg = rasterize_capsules_pallas(
        csr, params, W, H, 16, 8, interpret=True, use_aa=use_aa
    )
    tcsr, tparams, _ = ttr.prepare_capsule_frame(
        ts, torch.tensor(vp), torch.tensor(cp), torch.tensor(ab),
        RasterSettings(**kw), aa_margin=margin,
    )
    launches = rasterize_capsules.launches
    tz, tid, tg = rasterize_capsules(tcsr, tparams, W, H, 16, 8, use_aa=use_aa)
    assert rasterize_capsules.launches == launches  # CPU: plain version

    jid, tid = np.asarray(jid), tid.numpy()
    assert tid.dtype == np.int32 and tid.shape == jid.shape
    agree = jid == tid
    assert agree.mean() >= 0.999
    assert (tid >= 0).sum() > 50  # the scene is on screen
    miss = agree & (tid < 0)
    assert (tz.numpy()[miss] == 2.0).all()

    jplanes = np.stack([np.asarray(jz), *(np.asarray(g) for g in jg[:7])])
    tplanes = np.stack([tz.numpy(), *(g.numpy() for g in tg[:7])])
    hit = agree & (tid >= 0)
    off = (np.abs(jplanes - tplanes) > 1e-5).any(axis=0) & hit
    assert off.sum() <= 0.01 * hit.sum()
    payload = tcsr.payload.numpy()
    start, count = tcsr.tile_start.numpy(), tcsr.tile_count.numpy()
    for tile, p in zip(*np.nonzero(off)):
        ref = _winner_f64(payload, start, count, tparams.numpy(), tile, p,
                          tid[tile, p], tcsr.tiles_x, 16, 8, W, H, use_aa)
        np.testing.assert_allclose(tplanes[:5, tile, p], ref, rtol=0, atol=5e-5)
        np.testing.assert_allclose(jplanes[:5, tile, p], ref, rtol=0, atol=5e-5)
        np.testing.assert_allclose(
            tplanes[:, tile, p], jplanes[:, tile, p], rtol=0, atol=5e-5
        )
    # Tangent = the segment vector, exactly.
    np.testing.assert_array_equal(jplanes[5:][:, agree], tplanes[5:][:, agree])
    cov_err = np.abs(np.asarray(jg[7]) - tg[7].numpy())[agree]
    assert cov_err.max() <= 2e-3


def test_thin_tornado_tubes_match_pallas(exact_reciprocal):
    """The main path's precision regime: tornado segments ~2e-3 long with
    radius 0.0015, ~1e-3 of the camera distance (tile 32x16, chunk 128,
    span 2x2, AA on), traced by the port and handed to both packages."""
    ts = tornado_scene("cpu", num_seeds=32, max_steps=100)
    js = jtr.CapsuleScene(
        **{f.name: jnp.asarray(getattr(ts, f.name).numpy())
           for f in dataclasses.fields(ts) if f.name != "radius"},
        radius=ts.radius,
    )
    W, H = 256, 128
    kw = dict(width=W, height=H, tile_w=32, tile_h=16)
    vp, cp, ab = _camera_arrays(
        JCamera(position=(0.0, 0.1, 1.2), width=W, height=H).orbit(0.3, 0.1, 1.2)
    )
    csr, params, _ = jtr.prepare_capsule_frame(
        js, jnp.asarray(vp), jnp.asarray(cp), jnp.asarray(ab), JSettings(**kw),
        aa_margin=0.5,
    )
    jz, jid, jg = rasterize_capsules_pallas(csr, params, W, H, 32, 16, interpret=True)
    tcsr, tparams, _ = ttr.prepare_capsule_frame(
        ts, torch.tensor(vp), torch.tensor(cp), torch.tensor(ab),
        RasterSettings(**kw), aa_margin=0.5,
    )
    np.testing.assert_array_equal(tcsr.tile_start.numpy(), np.asarray(csr.tile_start))
    np.testing.assert_array_equal(tcsr.tile_count.numpy(), np.asarray(csr.tile_count))
    tz, tid, tg = rasterize_capsules(tcsr, tparams, W, H, 32, 16)
    jid, tid = np.asarray(jid), tid.numpy()
    agree = jid == tid
    assert agree.mean() >= 0.999
    hit = agree & (tid >= 0)
    assert hit.sum() > 200
    for j, t in zip([jz, *jg[:7]], [tz, *tg[:7]]):
        assert np.abs(np.asarray(j) - t.numpy())[hit].max() <= 1e-5
    assert np.abs(np.asarray(jg[7]) - tg[7].numpy())[agree].max() <= 2e-3


def test_reference_batches_do_not_change_result():
    _, ts, W, H = _scenes("walk")
    vp, cp, ab = _camera_arrays(Camera(position=(0.1, 0.2, 1.4), width=W, height=H))
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=16)
    csr, params, _ = ttr.prepare_capsule_frame(
        ts, torch.tensor(vp), torch.tensor(cp), torch.tensor(ab), S, aa_margin=0.5
    )
    a = rasterize_capsules_reference(csr, params, W, H, 16, 8, batch_pairs=7)
    b = rasterize_capsules_reference(csr, params, W, H, 16, 8)
    for x, y in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        assert torch.equal(x, y)


def test_shade_capsules_matches_jax():
    rng = np.random.default_rng(5)
    H, W = 24, 40
    zndc = rng.uniform(0.95, 0.999, (H, W)).astype(np.float32)
    seg_id = rng.integers(-1, 50, (H, W)).astype(np.int32)
    attr = rng.uniform(-0.1, 1.1, (H, W)).astype(np.float32)
    normal = rng.normal(size=(3, H, W)).astype(np.float32)
    tangent = rng.normal(size=(3, H, W)).astype(np.float32)
    cov = rng.uniform(0, 1, (H, W)).astype(np.float32)
    cam = JCamera(position=(0.2, 0.1, 1.3), width=W, height=H)
    vp, cp, ab = _camera_arrays(cam)
    tf = JTF.from_points([(0.0, 10, 200, 30), (0.4, 250, 20, 90), (1.0, 5, 5, 250)],
                         [(0.0, 0.3), (1.0, 0.9)])
    c_pts, o_pts = tf.as_static_points()
    kw = dict(width=W, height=H, depth_cue_strength=0.6, tf_color=c_pts, tf_opacity=o_pts)
    jbasis = jtr._ray_basis(jnp.asarray(vp))
    args = (zndc, seg_id, attr, normal, tangent, cp)
    j = jtr.shade_capsules(
        *map(jnp.asarray, args), jbasis, jnp.asarray(ab), jnp.float32(1.0),
        jnp.float32(1.6), JSettings(**kw), coverage=jnp.asarray(cov),
    )
    t = ttr.shade_capsules(
        *map(torch.tensor, args), ttr._ray_basis(torch.tensor(vp)), torch.tensor(ab),
        torch.tensor(1.0), torch.tensor(1.6), RasterSettings(**kw),
        coverage=torch.tensor(cov),
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        ttr._ray_basis(torch.tensor(vp)).numpy(), np.asarray(jbasis), rtol=1e-6,
        atol=1e-7,
    )
    # The port's TransferFunction carries the same control points.
    port_tf = TransferFunction.from_points(
        [(0.0, 10, 200, 30), (0.4, 250, 20, 90), (1.0, 5, 5, 250)],
        [(0.0, 0.3), (1.0, 0.9)],
    )
    assert port_tf.as_static_points() == (c_pts, o_pts)
    np.testing.assert_array_equal(port_tf.table, tf.table)


def test_camera_matches_jax():
    jc = JCamera(position=(0.3, -0.2, 1.1), width=48, height=30).orbit(0.4, 0.2, 1.3)
    tc = Camera(position=(0.3, -0.2, 1.1), width=48, height=30).orbit(0.4, 0.2, 1.3)
    np.testing.assert_array_equal(tc.view_projection_matrix(), jc.view_projection_matrix())
    for a, b in zip(tc.generate_rays(), jc.generate_rays()):
        np.testing.assert_array_equal(a, b)


def _golden_settings(cls, w, h):
    # tests/golden_scenes.py:_settings
    return cls(width=w, height=h, tile_w=16, tile_h=8, chunk=32, span_x=3,
               span_y=3, depth_cue_strength=0.2)


def test_render_tubes_image_matches_jax_and_golden():
    """The whole frame on the golden scene (tests/golden_scenes.py
    scene_opaque_tubes): against the JAX package run as it is, and
    against the checked-in golden."""
    w, h = 160, 120
    pos, mask, attrs, radius = _walk()
    js = jtr.build_capsule_scene(pos, mask, attrs, radius)
    jimg = jtr.render_tubes_image(
        js, JCamera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h),
        settings=_golden_settings(JSettings, w, h),
    )
    ts = capsule_scene_from_numpy(
        {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}, device="cpu"
    )
    timg = ttr.render_tubes_image(
        ts, Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h),
        settings=_golden_settings(RasterSettings, w, h),
    )
    assert timg.shape == (h, w, 4) and np.isfinite(timg).all()
    assert ssim(timg[..., :3], jimg[..., :3]) >= 0.999
    assert np.abs(timg - jimg).mean() <= 2e-3

    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(timg), np.float64) / 255.0
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def test_supersample_and_transfer_function():
    _, ts, W, H = _scenes("two_segments")
    cam = Camera(position=(0.0, 0.0, 1.5), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=16,
                       span_x=4, span_y=4)
    img = ttr.render_tubes_image(ts, cam, tf=TransferFunction.standard(),
                                 settings=S, supersample=2)
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    assert (img[H // 2, :, :3] < 0.999).any()
    np.testing.assert_allclose(img[0, 0, :3], 1.0)
    single = ttr.render_tubes_image(ts, cam, tf=TransferFunction.standard(), settings=S)
    assert ssim(img[..., :3], single[..., :3]) > 0.9


def test_capsule_scene_from_numpy_matches_builder():
    pos, mask, attrs, radius = _walk()
    mask[2, 5:] = False
    js = jtr.build_capsule_scene(pos, mask, attrs, radius)
    conv = capsule_scene_from_numpy(
        {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}, device="cpu"
    )
    built = ttr.build_capsule_scene(pos, mask, attrs, radius, device="cpu")
    for f in dataclasses.fields(built):
        a, b = getattr(conv, f.name), getattr(built, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b


def test_entry_runs_on_cpu_and_defaults_to_cuda():
    fn, args = entry(device="cpu")
    img = fn(*args)
    assert img.shape == (4, 128, 256) and bool(torch.isfinite(img).all())
    assert bool((img[:3] < 0.999).any())
    if torch.cuda.is_available():
        _, args = entry()
        assert args[0].a.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            entry()


def test_wrapper_rejects_other_devices():
    _, ts, W, H = _scenes("two_segments")
    vp, cp, ab = _camera_arrays(Camera(position=(0.1, 0.2, 1.4), width=W, height=H))
    csr, params, _ = ttr.prepare_capsule_frame(
        ts, torch.tensor(vp), torch.tensor(cp), torch.tensor(ab),
        RasterSettings(width=W, height=H),
    )
    meta = dataclasses.replace(csr, payload=csr.payload.to("meta"))
    with pytest.raises(ValueError):
        rasterize_capsules(meta, params.to("meta"), W, H)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor
    linevis_tpu."""
    code = (
        "import importlib, pkgutil, sys, linevis_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'linevis_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'linevis_tpu' or n.startswith('linevis_tpu.')]\n"
        "print(len([n for n in sys.modules if n.startswith('linevis_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "need = ['geometry.frames', 'geometry.tubes', 'kernels.raster_prism',\n"
        "        'kernels.raster_pallas', 'render.opaque', 'render.pipeline',\n"
        "        'render.tube_raster', 'convert', 'entry', 'automation.profiling',\n"
        "        'automation.parity', 'automation.linear_bvh', 'kernels.ao_grid',\n"
        "        'kernels.bvh_wavefront',\n"
        "        'ops.lbvh', 'ops.wide_bvh', 'render.rtao', 'render.ray_tracer',\n"
        "        'render.opacity_optimization', 'render.renderer', 'scene.line_data',\n"
        "        'scene.filters', 'core.settings', 'core.transforms',\n"
        "        'loaders.stress_dat', 'scene.line_data_stress', 'geometry.bands',\n"
        "        'automation.camera_path', 'automation.replay', 'kernels.bvh_closest_hit',\n"
        "        'kernels.bvh_mlat', 'render.denoiser', 'render.deferred', 'render.ssao',\n"
        "        'render.ao_bake', 'ops.threefry', 'kernels.vpt_tracking',\n"
        "        'kernels.density_march', 'kernels.spherical_heatmap', 'render.vpt',\n"
        "        'render.line_density_map', 'render.spherical_heatmap', 'render.vrc',\n"
        "        'render.multivar', 'render.super_voxel', 'render.env_map',\n"
        "        'trace.scattering', 'scene.line_data_scattering', 'scene.sparse_grid',\n"
        "        'geometry.segments', 'geometry.isosurface', 'loaders.cloud_loader',\n"
        "        'loaders.grid_loader', '__main__', 'app', 'automation.perf',\n"
        "        'automation.replay_compat', 'automation.tsv_requester',\n"
        "        'kernels.tiled_address', 'kernels.threefry_uniform', 'render.data_view',\n"
        "        'scene.requester', 'parallel', 'parallel.mesh']\n"
        "missing = [m for m in need if 'linevis_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 45
