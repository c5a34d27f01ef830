"""linevis_tpu_torch denoisers, RTAO denoise paths, deferred family, SSAO/GTAO and
the AO bake vs the JAX package on the CPU.

The same numpy inputs go to both packages; where a JAX function draws from
jax.random (`ssao`'s kernel, the bake's and RTAO's hemisphere samples), its
draws are handed to the port. Bars, each stated where it is checked:
- the denoisers, SSAO/GTAO, the bilinear upsampling, the TAA step and the
  motion vectors: float32 elementwise arithmetic in the same order, apart
  from exp, pow and tan, whose float32 results may differ by an ulp between
  XLA:CPU and PyTorch: within 1e-5 (measured 3e-7 to 2.4e-6);
- `spatial_hash_denoise`: the hash itself bit for bit; the denoised map
  equal within 1e-6 on >= 99% of pixels. A pixel's cell size comes from
  tan, log2 and exp2, so a pixel on a cell boundary can fall into the next
  cell on another device and read that cell's mean (on the CPU: every pixel
  equal, measured); on the card the table's float sums are taken in no
  fixed order;
- whole frames (deferred, RTAO with a denoiser, the golden): SSIM >= 0.999
  and mean abs <= 2e-3 against JAX, SSIM >= 0.99 and image mean difference
  <= 2e-3 against the golden PNG (tests/test_golden.py's bars);
- the AO bake: B5's result depends on which pairs share a chunk (ROADMAP
  queue C), so each ring point's occluded count, in both packages, lies
  between the count of rays occluded by a segment of a sampled cell and the
  count occluded by any segment (tests/test_torch_rtao.py's bracket).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.render import ao_bake as jbake
from linevis_tpu.render import deferred as jdf
from linevis_tpu.render import denoiser as jd
from linevis_tpu.render import rtao as jrtao
from linevis_tpu.render import ssao as jss
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch.convert import capsule_scene_from_numpy, svgf_state_from_numpy
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.kernels import ao_grid as tao
from linevis_tpu_torch.kernels import raster_capsule as trc
from linevis_tpu_torch.render import ao_bake as tbake
from linevis_tpu_torch.render import deferred as tdf
from linevis_tpu_torch.render import denoiser as td
from linevis_tpu_torch.render import renderer as trenderer
from linevis_tpu_torch.render import rtao as trtao
from linevis_tpu_torch.render import ssao as tss
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.scene.line_data import LineData

from tests import golden_scenes
from tests.test_torch_registry import _port_traj
from tests.test_torch_rtao import _bracket

torch.set_num_threads(1)

ATOL = 1e-5  # float32 elementwise work, an ulp of exp/pow/tan apart
T = torch.as_tensor


def _images_agree(t_img, j_img):
    t_img, j_img = np.asarray(t_img), np.asarray(j_img)
    assert t_img.shape == j_img.shape and np.isfinite(t_img).all()
    assert ssim(np.moveaxis(t_img[:3], 0, -1), np.moveaxis(j_img[:3], 0, -1)) >= 0.999
    assert np.abs(t_img - j_img).mean() <= 2e-3


def _noisy_edge(h=32, w=32, sigma=0.15, seed=0):
    # tests/test_denoiser.py:_noisy_edge
    rng = np.random.default_rng(seed)
    clean = np.zeros((3, h, w), np.float32)
    clean[:, :, w // 2:] = 0.8
    clean[:, :, : w // 2] = 0.2
    noisy = clean + rng.normal(0, sigma, clean.shape).astype(np.float32)
    pos = np.zeros((3, h, w), np.float32)
    pos[0] = np.linspace(0, 1, w)[None, :]
    nrm = np.zeros((3, h, w), np.float32)
    nrm[2, :, : w // 2] = 1.0
    nrm[0, :, w // 2:] = 1.0
    return clean, noisy, pos, nrm


@pytest.mark.parametrize("features", [False, True], ids=["color_only", "position_normal"])
@pytest.mark.parametrize("denoiser", ["eaw_denoise", "svgf_denoise"])
def test_spatial_denoisers_match_jax(denoiser, features):
    clean, noisy, pos, nrm = _noisy_edge(seed=4)
    extra = (pos, nrm) if features else ()
    j = np.asarray(getattr(jd, denoiser)(jnp.asarray(noisy), *(jnp.asarray(x) for x in extra),
                                         num_iterations=3))
    t = getattr(td, denoiser)(T(noisy), *(T(x) for x in extra), num_iterations=3).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    if features:
        # tests/test_denoiser.py: noise down, the edge kept.
        mse = float(np.mean((t - clean) ** 2))
        assert mse < 0.3 * float(np.mean((noisy - clean) ** 2))
        assert t[:, :, 20:].mean() - t[:, :, :12].mean() > 0.45


def test_eaw_identity_on_constant():
    out = td.eaw_denoise(torch.full((3, 16, 16), 0.5), num_iterations=2).numpy()
    np.testing.assert_allclose(out, 0.5, atol=1e-5)


def test_svgf_temporal_three_frames_match_jax():
    """Three frames of a panning camera, each package carrying its own state:
    outputs and states within ATOL, history lengths equal; then JAX's state
    after frame 1, carried across with `svgf_state_from_numpy`, gives the
    port's frame 2 within ATOL of JAX's."""
    H, W = 24, 32
    rng = np.random.default_rng(7)
    nrm = np.zeros((3, H, W), np.float32)
    nrm[2] = 1.0
    j_state = t_state = None
    frames = []
    for f in range(3):
        color = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        pos = np.zeros((3, H, W), np.float32)
        pos[0] = (np.arange(W) * 0.01 + f * 0.01)[None]
        pos[1] = (np.arange(H) * 0.01)[:, None]
        if f == 2:
            pos[:, :, :4] += 0.5  # a disocclusion: the history restarts there
        motion = np.zeros((2, H, W), np.float32)
        motion[0] = -1.0 if f else 0.0
        frames.append((color, motion, pos))
        j_prev = j_state
        j_out, j_state = jd.svgf_temporal_denoise(
            jnp.asarray(color), jnp.asarray(motion), jnp.asarray(pos), j_state,
            normal=jnp.asarray(nrm))
        t_out, t_state = td.svgf_temporal_denoise(T(color), T(motion), T(pos), t_state,
                                                  normal=T(nrm))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)
        for name in ("color", "moments", "position"):
            np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                       np.asarray(getattr(j_state, name)), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(t_state.length.numpy(), np.asarray(j_state.length))
    length = t_state.length.numpy()
    assert length[:, 10:20].min() == 3.0 and length[:, :4].max() == 1.0
    carried = svgf_state_from_numpy(
        {k: np.asarray(getattr(j_prev, k)) for k in ("color", "moments", "length", "position")},
        "cpu")
    t_out2, _ = td.svgf_temporal_denoise(*(T(x) for x in frames[2]), carried, normal=T(nrm))
    np.testing.assert_allclose(t_out2.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)


def test_wang_hash_and_bitcast_match_jax():
    """uint32 wraparound carried in int64, and the float bits, on edge values."""
    x = np.array([0, 1, 2, 61, 2 ** 16, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0x27D4EB2D,
                  123456789, 0xDEADBEEF], np.uint32)
    np.testing.assert_array_equal(td._wang_hash(T(x.astype(np.int64))).numpy(),
                                  np.asarray(jd._wang_hash(jnp.asarray(x))).astype(np.int64))
    f = np.array([0.0, -0.0, 1.0, -1.5, np.inf, -np.inf, 3e38, 1e-45, -7.25e-3], np.float32)
    np.testing.assert_array_equal(td._f2u(T(f)).numpy(),
                                  np.asarray(jd._f2u(jnp.asarray(f))).astype(np.int64))


def test_spatial_hash_denoise_matches_jax():
    rng = np.random.default_rng(3)
    H, W = 48, 64
    pos = rng.normal(0, 0.3, (3, H, W)).astype(np.float32)
    nrm = rng.normal(0, 1, (3, H, W)).astype(np.float32)
    vals = rng.uniform(0, 1, (H, W)).astype(np.float32)
    # Clusters of pixels sharing a cell: every fourth pixel copies its
    # neighbour's position and normal.
    pos[:, :, 1::4], nrm[:, :, 1::4] = pos[:, :, ::4], nrm[:, :, ::4]
    cp = np.array([0.0, 0.1, 1.2], np.float32)
    j = np.asarray(jd.spatial_hash_denoise(*(jnp.asarray(x) for x in (vals, pos, nrm, cp))))
    t = td.spatial_hash_denoise(*(T(x) for x in (vals, pos, nrm, cp))).numpy()
    assert (np.abs(t - j) <= 1e-6).mean() >= 0.99
    assert (np.abs(t - vals) > 1e-6).mean() > 0.2  # the clusters were averaged


def test_spatial_hash_denoise_cells_and_normals():
    """tests/test_denoiser.py's two behaviours on the port: pixels of one
    cell get its mean, distant surfaces and opposing normals do not mix."""
    H, W = 16, 32
    rng = np.random.default_rng(0)
    pos = np.zeros((3, H, W), np.float32)
    pos[:, :, W // 2:] = 5.0
    nrm = np.zeros((3, H, W), np.float32)
    nrm[2] = 1.0
    noisy = np.where(np.arange(W)[None, :] < W // 2, 0.3 + rng.normal(0, 0.05, (H, W)),
                     0.8 + rng.normal(0, 0.05, (H, W))).astype(np.float32)
    cam = T(np.array([0.0, 0.0, 2.0], np.float32))
    out = td.spatial_hash_denoise(T(noisy), T(pos), T(nrm), cam).numpy()
    np.testing.assert_allclose(out[:, :W // 2], noisy[:, :W // 2].mean(), atol=1e-5)
    np.testing.assert_allclose(out[:, W // 2:], noisy[:, W // 2:].mean(), atol=1e-5)
    pos = np.zeros((3, 8, 8), np.float32)
    nrm = np.zeros((3, 8, 8), np.float32)
    nrm[2, :, :4], nrm[2, :, 4:] = 1.0, -1.0
    vals = np.broadcast_to(np.where(np.arange(8) < 4, 0.2, 0.9), (8, 8)).astype(np.float32)
    out = td.spatial_hash_denoise(T(vals), T(pos), T(nrm), cam).numpy()
    np.testing.assert_allclose(out, vals, atol=1e-5)


def _step_scene(h=32, w=48):
    # tests/test_ssao.py:_step_scene
    view_z = np.full((h, w), 1.0, np.float32)
    view_z[:, 20:28] = 1.3
    normal = np.zeros((3, h, w), np.float32)
    normal[2] = -1.0
    fg = np.ones((h, w), bool)
    basis = np.eye(3, dtype=np.float32)
    return view_z, normal, basis, fg


def test_ssao_matches_jax_on_its_kernel_samples():
    view_z, normal, basis, fg = _step_scene()
    j = np.asarray(jss.ssao(*(jnp.asarray(x) for x in (view_z, normal, basis, fg)),
                            radius=0.5, num_samples=32, seed=3))
    k1, _ = jax.random.split(jax.random.PRNGKey(3))
    dirs = np.array(jax.random.normal(k1, (32, 3)))
    t = tss.ssao(*(T(x) for x in (view_z, normal, basis, fg)), radius=0.5, num_samples=32,
                 directions=T(dirs)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    assert t[8:24, 22:26].mean() < t[8:24, 4:12].mean() - 0.05  # the trench is darker
    # Its own draws on the CPU: the same behaviour; background unoccluded.
    own = tss.ssao(*(T(x) for x in (view_z, normal, basis, fg)), radius=0.5, num_samples=32)
    assert own.numpy()[8:24, 22:26].mean() < own.numpy()[8:24, 4:12].mean() - 0.05
    bg = tss.ssao(*(T(x) for x in (view_z, normal, basis, np.zeros_like(fg))))
    np.testing.assert_allclose(bg.numpy(), 1.0)


def test_gtao_matches_jax():
    view_z, normal, basis, fg = _step_scene()
    args = [jnp.asarray(x) for x in (view_z, normal, basis, fg)]
    j = np.asarray(jss.gtao(*args, radius=0.6))
    t = tss.gtao(*(T(x) for x in (view_z, normal, basis, fg)), radius=0.6).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    assert t[8:24, 22:26].mean() < t[8:24, 4:12].mean() - 0.05


@pytest.mark.parametrize("scale", [2, 4])
def test_bilinear_upsampling_matches_jax_resize(scale):
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize(..., "bilinear"), edges included."""
    x = np.random.default_rng(scale).uniform(0, 1, (3, 7, 9)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(x), (3, 7 * scale, 9 * scale), "bilinear"))
    np.testing.assert_allclose(tdf._resize_bilinear(T(x), scale).numpy(), j, rtol=0, atol=1e-6)


def test_taa_step_and_upscaler_match_jax():
    rng = np.random.default_rng(1)
    hist = rng.uniform(0, 1, (3, 32, 48)).astype(np.float32)
    low = rng.uniform(0, 1, (3, 16, 24)).astype(np.float32)
    mv = rng.normal(0, 1.5, (2, 16, 24)).astype(np.float32)
    j = np.asarray(jdf._taa_step(jnp.asarray(hist), jnp.asarray(low), jnp.asarray(mv), 2,
                                 jnp.float32(0.125)))
    np.testing.assert_allclose(tdf._taa_step(T(hist), T(low), T(mv), 2, 0.125).numpy(), j,
                               rtol=0, atol=ATOL)
    ju, tu = jdf.TemporalUpscaler(scale=2, blend=0.5), tdf.TemporalUpscaler(scale=2, blend=0.5)
    for _ in range(3):
        low = rng.uniform(0, 1, (3, 16, 24)).astype(np.float32)
        mv = rng.normal(0, 0.5, (2, 16, 24)).astype(np.float32)
        j = np.asarray(ju.step(jnp.asarray(low), jnp.asarray(mv)))
        t = tu.step(T(low), T(mv)).numpy()
        assert t.shape == (3, 32, 48)
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def _deferred_scene(seed=3, radius=0.03):
    # tests/test_deferred.py:_scene
    rng = np.random.default_rng(seed)
    L, P = 6, 10
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    js = jtr.build_capsule_scene(pos, np.ones((L, P), bool),
                                 rng.uniform(0, 1, (L, P)).astype(np.float32), radius=radius)
    ts = capsule_scene_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}, "cpu")
    return js, ts


def _cam_args(cam_cls, pos=(0.0, 0.1, 1.2), look=(0, 0, 0), W=96, H=64):
    return cam_cls(position=pos, look_at_point=look, width=W, height=H)


def test_deferred_matches_jax_and_the_forward_frame():
    """tests/test_deferred.py's scene at 96x64: the image equal to the port's
    `render_tubes` bit for bit and to JAX's at the image bars; motion zero for
    a static camera; under a pan, the motion vectors against JAX's (both from
    each package's own depth buffer) within 1e-3 px on >= 99% of the pixels
    both call foreground."""
    js, ts = _deferred_scene()
    kw = dict(width=96, height=64, tile_w=16, tile_h=8, chunk=32, span_x=3, span_y=3)
    jS, tS = JSettings(**kw), RasterSettings(**kw)
    jcam, tcam = _cam_args(JCamera), _cam_args(Camera)
    jargs = (jnp.asarray(jcam.view_projection_matrix()),
             jnp.asarray(np.asarray(jcam.position, np.float32)),
             jnp.asarray(jtr._proj_constants(jcam)), jS)
    targs = (*ttr.camera_tensors(tcam, "cpu"), tS)
    before = trc.rasterize_capsules.launches
    t_img, t_mv = tdf.render_tubes_deferred(ts, *targs, prev_view_proj=targs[0],
                                            with_motion=True)
    assert trc.rasterize_capsules.launches == before  # the plain version on the CPU
    assert torch.equal(t_img, ttr.render_tubes(ts, *targs))
    assert t_mv.abs().max().item() < 1e-3
    j_img = jdf.render_tubes_deferred(js, *jargs)
    _images_agree(t_img.numpy(), j_img)

    prev_j = _cam_args(JCamera, pos=(-0.05, 0.1, 1.2), look=(-0.05, 0, 0))
    prev_t = _cam_args(Camera, pos=(-0.05, 0.1, 1.2), look=(-0.05, 0, 0))
    _, j_mv = jdf.render_tubes_deferred(js, *jargs, prev_view_proj=jnp.asarray(
        prev_j.view_projection_matrix()), with_motion=True)
    _, t_mv = tdf.render_tubes_deferred(ts, *targs, prev_view_proj=T(
        prev_t.view_projection_matrix()), with_motion=True)
    j_mv, t_mv = np.asarray(j_mv), t_mv.numpy()
    fg = (j_mv != 0).any(axis=0) & (t_mv != 0).any(axis=0)
    assert fg.sum() > 50
    assert (np.abs(t_mv - j_mv).max(axis=0)[fg] <= 1e-3).mean() >= 0.99
    assert t_mv[0][fg].mean() < -0.5 and abs(t_mv[1][fg].mean()) < abs(t_mv[0][fg].mean()) * 0.5


def test_motion_vectors_match_jax():
    rng = np.random.default_rng(2)
    pos = rng.normal(0, 0.2, (3, 24, 32)).astype(np.float32)
    fg = rng.uniform(0, 1, (24, 32)) > 0.3
    prev = _cam_args(JCamera, pos=(0.05, 0.12, 1.2), W=32, H=24).view_projection_matrix()
    j = np.asarray(jdf.motion_vectors(jnp.asarray(pos), jnp.asarray(fg), jnp.asarray(prev)))
    t = tdf.motion_vectors(T(pos), T(fg), T(prev)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)  # pixels; a matrix product each
    assert (t[:, ~fg] == 0).all()


def _port_line_data(seed=5, L=4, P=8, width=0.04):
    # tests/test_deferred.py::test_deferred_renderer_mode_and_upscaling's lines.
    from linevis_tpu.core.trajectories import Trajectories as JTraj

    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.06, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    traj = JTraj(positions=pos, attributes=rng.uniform(0, 1, (L, 1, P)).astype(np.float32),
                 mask=np.ones((L, P), bool), num_points=np.full((L,), P, np.int32),
                 attribute_names=["a"])
    ld = LineData(_port_traj(traj))
    ld.set_line_width(width)
    return ld


def test_deferred_opaque_mode_by_name():
    """"Deferred Opaque" resolves lazily; a frame is `render_tubes_deferred`'s
    image with its motion kept; `upscaling_factor` 2 (set after creation: the
    constructor's value is overridden, as in the JAX renderer) renders at half
    resolution and upscales, the second frame through the TAA step."""
    ld = _port_line_data()
    cam = _cam_args(Camera)
    r = trenderer.create_renderer("Deferred Opaque", device="cpu")
    assert type(r).__name__ == "DeferredOpaqueRenderer" and r.device.type == "cpu"
    r.set_line_data(ld)
    a = r.render(cam)
    scene = ld.get_capsule_scene(device="cpu")
    want = tdf.render_tubes_deferred(scene, *ttr.camera_tensors(cam, "cpu"),
                                     r._raster_settings(cam))
    np.testing.assert_array_equal(a, np.moveaxis(want.numpy(), 0, -1))
    assert r.last_motion is not None and r.last_motion.abs().max().item() < 1e-3
    assert trenderer.create_renderer("Deferred Opaque", SettingsMap(
        {"upscaling_factor": 2}), device="cpu").upscaling_factor == 1
    r2 = trenderer.create_renderer("Deferred Opaque", device="cpu")
    r2.set_line_data(ld)
    r2.set_new_settings(SettingsMap({"upscaling_factor": 2}))
    b = r2.render(cam)
    b = r2.render(cam.orbit(0.01, 0.1, 1.2))
    assert b.shape == (64, 96, 4) and np.isfinite(b).all()
    assert r2.last_motion.shape == (2, 32, 48) and r2.last_motion.abs().max().item() > 0.01


def _line_pair(gap=0.01, radius=0.02, n=8):
    # tests/test_ao_bake.py:_straight_line, twice
    pos = np.zeros((2, n, 3), np.float32)
    pos[:, :, 0] = np.linspace(-0.4, 0.4, n)
    pos[1, :, 1] = 2 * radius + gap
    return pos


def test_bake_matches_jax_bracketed():
    """Two parallel tubes, 3 frames x 2 samples, JAX's samples in both: each
    ring point's occluded count in either package between the rays occluded
    by a segment of a sampled cell and by any segment; the AO means within
    2 rays' worth of each other."""
    pos = _line_pair()
    mask = np.ones(pos.shape[:2], bool)
    radius = 0.02
    bake_kw = dict(num_frames=3, samples_per_frame=2, seed=3, grid_resolution=16)
    jb, tb = jbake.AoBakeSettings(**bake_kw), tbake.AoBakeSettings(**bake_kw)
    j_ao = jbake.bake_ambient_occlusion(pos, mask, radius, jb)
    sub, L, P = tb.num_tube_subdivisions, pos.shape[0], pos.shape[1]
    n_pts = sub * L * P
    key = jax.random.PRNGKey(tb.seed)
    uniforms = []
    for _ in range(tb.num_frames):
        key, k = jax.random.split(key)
        k1, k2 = jax.random.split(k)
        shape = (tb.samples_per_frame, n_pts, 1)
        uniforms.append((np.array(jax.random.uniform(k1, shape)),
                         np.array(jax.random.uniform(k2, shape))))
    t_ao = tbake.bake_ambient_occlusion(pos, mask, radius, tb, device="cpu", uniforms=uniforms)
    assert t_ao.shape == j_ao.shape == (L, P, sub)

    tpos, tmask = T(pos), T(mask)
    ring_a, ring_b, _ = tbake.parallel_transport_frames(tpos, tmask)
    grid = tbake.bake_grid(tpos, tmask, radius, tb)
    o, n = tbake._bake_rays(tpos, ring_a, ring_b, radius, tb)
    lo = np.zeros(n_pts)
    hi = np.zeros(n_pts)
    for u1, u2 in uniforms:
        dirs = trtao._cosine_hemisphere(T(u1), T(u2), n.reshape(3, n_pts, 1))[..., 0]
        for s in range(tb.samples_per_frame):
            lower, upper = _bracket(o.numpy(), dirs[s].numpy(),
                                    np.full(n_pts, tb.ao_radius, np.float32), grid,
                                    tb.max_ray_cells)
            lo += lower
            hi += upper
    n_rays = tb.num_frames * tb.samples_per_frame

    def counts(ao):
        return np.moveaxis(np.rint((1.0 - ao) * n_rays), -1, 0).reshape(-1)

    for c in (counts(t_ao), counts(j_ao)):
        assert (lo <= c).all() and (c <= hi).all()
    assert hi.sum() > 10  # the facing sides occlude
    assert abs(t_ao.mean() - j_ao.mean()) <= 2.0 / n_rays


def test_segment_average_ao_matches_jax():
    ao = np.random.default_rng(4).uniform(0, 1, (2, 5, 8)).astype(np.float32)
    mask = np.ones((2, 5), bool)
    np.testing.assert_array_equal(tbake.segment_average_ao(ao, mask),
                                  jbake.segment_average_ao(ao, mask))


def _rtao_frames(scene, cam, settings, rtao, frames, grid):
    """render_tubes_rtao's frames f = 0.. on the JAX registry's samples
    (PRNGKey(seed + f), as `linevis_tpu.render.rtao` draws them)."""
    out = []
    for f in range(frames):
        k1, k2 = jax.random.split(jax.random.PRNGKey(rtao.seed + f))
        shape = (rtao.num_samples, settings.height, settings.width)
        u = (T(np.array(jax.random.uniform(k1, shape))), T(np.array(jax.random.uniform(k2, shape))))
        out.append(trtao.render_tubes_rtao(scene, *ttr.camera_tensors(cam, "cpu"), settings,
                                           rtao, frame=f, grid=grid, uniforms=u))
    return out


@pytest.mark.parametrize("denoiser", ["EAW", "Spatial Hashing"])
def test_rtao_denoisers_match_jax(denoiser):
    """render_tubes_rtao with the denoiser on the same samples in both
    packages (tests/test_torch_rtao.py's walk scene at 64x48)."""
    from tests.test_torch_rtao import _frame_args, _scenes

    js, ts = _scenes()
    jcam, jS = _frame_args(JCamera, JSettings)
    tcam, tS = _frame_args(Camera, RasterSettings)
    kw = dict(num_samples=2, ao_radius=0.2, grid_resolution=16, seed=7, denoiser=denoiser)
    j_img = jrtao.render_tubes_rtao(
        js, jnp.asarray(jcam.view_projection_matrix()),
        jnp.asarray(np.asarray(jcam.position, np.float32)),
        jnp.asarray(jtr._proj_constants(jcam)), jS, jrtao.RtaoSettings(**kw), frame=1)
    tr = trtao.RtaoSettings(**kw)
    t_img = _rtao_frames(ts, tcam, tS, tr, 2, None)[1]
    _images_agree(t_img.numpy(), j_img)
    plain = _rtao_frames(ts, tcam, tS, dataclasses.replace(tr, denoiser="None"), 2, None)[1]
    assert not torch.equal(t_img, plain)
    assert torch.equal(t_img[3], plain[3])


def test_golden_rtao_through_the_port():
    """tests/golden_scenes.py scene_rtao: the registry's RTAO on
    `_line_data(seed=21)` at 64x48, 2 accumulated frames, drawn from
    jax.random's samples (PRNGKey(0 + frame)) through render_tubes_rtao."""
    w, h = golden_scenes.SMALL_SIZE
    jld = golden_scenes._line_data(seed=21)
    ld = LineData(_port_traj(jld.trajectories))
    ld.set_line_width(jld.line_width)
    r = trenderer.create_renderer("RTAO", device="cpu")
    r.set_line_data(ld)
    cam = golden_scenes._camera(w, h)
    scene = ld.get_capsule_scene(device="cpu")
    rtao = trtao.RtaoSettings()
    grid = tao.build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                                  resolution=rtao.grid_resolution)
    f0, f1 = _rtao_frames(scene, cam, r._raster_settings(cam), rtao, 2, grid)
    img = np.moveaxis(((f0 * 1 + f1) / 2).numpy(), 0, -1)
    golden = np.asarray(load_png(os.path.join(os.path.dirname(__file__), "golden", "rtao.png")),
                        np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert rendered.shape == golden.shape
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def test_rtao_registry_svgf_temporal():
    """The registry's "SVGF (Temporal)": each frame is render_tubes_rtao's
    frame f (its own samples) through motion_vectors and
    svgf_temporal_denoise with the carried state, on the renderer's device;
    a camera move neither resets the state nor the frame count."""
    w, h = golden_scenes.SMALL_SIZE
    jld = golden_scenes._line_data(seed=21)
    ld = LineData(_port_traj(jld.trajectories))
    ld.set_line_width(jld.line_width)
    r = trenderer.create_renderer("RTAO", SettingsMap({"denoiser": "SVGF (Temporal)"}),
                                  device="cpu")
    r.set_line_data(ld)
    cams = [golden_scenes._camera(w, h), golden_scenes._camera(w, h, pos=(0.03, 0.1, 1.2))]
    imgs = [r.render(cams[0]), r.render(cams[0]), r.render(cams[1])]
    assert r._frame == 3 and r._svgf_state.length.max().item() == 3.0
    scene = ld.get_capsule_scene(device="cpu")
    rtao = trtao.RtaoSettings()
    state, prev = None, None
    for f, cam in enumerate([cams[0], cams[0], cams[1]]):
        ct = ttr.camera_tensors(cam, "cpu")
        img, (pos, normal, fg) = trtao.render_tubes_rtao(scene, *ct, r._raster_settings(cam),
                                                          rtao, frame=f, grid=r._grid,
                                                          return_features=True)
        motion = (torch.zeros((2, h, w)) if prev is None
                  else tdf.motion_vectors(pos, fg, prev))
        out, state = td.svgf_temporal_denoise(img[:3], motion, pos, state, normal=normal)
        prev = ct[0]
        want = np.moveaxis(torch.cat([out, img[3:4]]).numpy(), 0, -1)
        np.testing.assert_array_equal(imgs[f], want)
    assert np.isfinite(imgs[2]).all() and (imgs[2][..., :3] < 0.99).any()
