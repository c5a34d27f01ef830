"""linevis_tpu_torch's volumetric path tracer vs the JAX package on the CPU.

The port draws jax.random's own stream (ops/threefry.py), so on the same
key it traces the JAX package's paths. Bars:
- Each of the five modes (`vpt_trace_rays`; the scan modes through R3's
  plain version, and each interpolation of Delta tracking) against JAX:
  radiance within 1e-4 on at least 95% of rays (measured: 100% at these
  sizes; a flipped `t > d` or `xi < p` changes the rest of a path), first
  scatter flags likewise, image means within 2e-3, the reference's own
  criterion (test/TestVolumetricPathTracing.cpp:92-95, cited at
  tests/test_golden.py:4-5).
- The estimators agree with each other in image mean within 0.015, as
  tests/test_vpt.py requires (24x24 at 8 spp, where tests/test_vpt.py
  takes 48x48 at 24 spp).
- `render_vpt`'s jitter and first-scatter features equal JAX's within 1e-4;
  a SparseGrid equals the dense grid bit for bit; the environment map's
  lighting within 1e-4.
- The registry renderer: accumulation, denoisers, `cloud_file` and
  `environment_map` settings against the JAX renderer (mean abs <= 2e-3),
  and the golden `vpt.png` through `create_renderer("Volumetric Path
  Tracer", device="cpu")` on tests/golden_scenes.py:scene_vpt's scene,
  frames 0-3, under the golden gate of tests/test_golden.py:46-50 (SSIM >=
  0.99, image mean difference <= 2e-3; measured SSIM 1.0).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.core.settings import SettingsMap as JSettingsMap
from linevis_tpu.loaders.cloud_loader import write_cloud_xyz
from linevis_tpu.render import vpt as jvpt
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.renderer import create_renderer as jcreate
from linevis_tpu.render.tube_raster import _ray_basis as j_ray_basis
from linevis_tpu.scene.line_data_scattering import LineDataScattering as JLDS
from linevis_tpu_torch.convert import trajectories_from_numpy
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.core.trajectories import Trajectories
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.render import vpt as tvpt
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.render.tube_raster import _ray_basis
from linevis_tpu_torch.scene.line_data_scattering import LineDataScattering
from linevis_tpu_torch.scene.sparse_grid import SparseGrid

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
W, H = 24, 18


def _t(a):
    return torch.as_tensor(np.array(a))


def _cloud(g=20, seed=None):
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    c = np.exp(-4.0 * (xx**2 + yy**2 + zz**2))
    if seed is not None:
        c = c * np.random.default_rng(seed).uniform(0.5, 1.0, c.shape)
    return c.astype(np.float32)


def _cams(w=W, h=H, pos=(0.0, 0.2, 1.2)):
    j = JCamera(position=pos, look_at_point=(0, 0, 0), width=w, height=h)
    t = Camera(position=pos, look_at_point=(0, 0, 0), width=w, height=h)
    return j, t


def _render_both(settings, grid, seed=3, w=W, h=H, spp=2, env=None):
    jc, tc = _cams(w, h)
    jimg, (jfx, jfh) = jvpt.render_vpt(
        jax.random.PRNGKey(seed), jnp.asarray(grid), jnp.asarray(np.asarray(jc.position, np.float32)),
        j_ray_basis(jnp.asarray(jc.view_projection_matrix())), w, h, settings=settings, spp=spp,
        return_features=True, env_map=None if env is None else jnp.asarray(env),
        env_intensity=1.5)
    ts = tvpt.VptSettings(**dataclasses.asdict(settings))
    tg = grid if isinstance(grid, SparseGrid) else _t(grid)
    timg, (tfx, tfh) = tvpt.render_vpt(
        threefry.prng_key(seed), tg, _t(np.asarray(tc.position, np.float32)),
        _ray_basis(_t(tc.view_projection_matrix())), w, h, settings=ts, spp=spp,
        return_features=True, env_map=None if env is None else _t(env), env_intensity=1.5)
    return ((np.asarray(jimg), np.asarray(jfx), np.asarray(jfh)),
            (timg.numpy(), tfx.numpy(), tfh.numpy()))


def _agree(j, t, share=0.95):
    jimg, jfx, jfh = j
    timg, tfx, tfh = t
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    ok = (np.abs(jimg - timg) <= 1e-4).all(-1)
    assert ok.mean() >= share, ok.mean()
    assert (jfh == tfh).mean() >= share
    both = jfh & tfh
    if both.any():  # decomposition tracking records no first scatter
        assert (np.abs(jfx - tfx)[both] <= 1e-4).all(-1).mean() >= share
    assert abs(float(jimg.mean()) - float(timg.mean())) <= 2e-3
    return ok.mean()


@pytest.mark.parametrize("mode,interpolation", [
    ("Delta Tracking", "Trilinear"), ("Delta Tracking", "Nearest"),
    ("Delta Tracking", "Stochastic"), ("Spectral Delta Tracking", "Trilinear"),
    ("Ratio Tracking", "Trilinear"), ("Decomposition Tracking", "Trilinear"),
    ("Residual Ratio Tracking", "Trilinear"),
])
def test_modes_equal_jax(mode, interpolation):
    ext = (60.0, 80.0, 100.0) if mode == "Spectral Delta Tracking" else (80.0,) * 3
    s = jvpt.VptSettings(mode=mode, extinction=ext, scattering_albedo=(0.9, 0.85, 0.95),
                         phase_g=0.0 if mode == "Ratio Tracking" else 0.3, max_events=48,
                         interpolation=interpolation)
    _agree(*_render_both(s, _cloud(seed=1)))


def test_vpt_trace_rays_equals_jax_per_ray():
    """vpt_trace_rays itself on arbitrary rays, with a denser cloud and the
    reference's extinction at 64 events (many rays reach max_events)."""
    rng = np.random.default_rng(2)
    n = 300
    o = np.tile(np.float32([0.1, 0.2, 1.0]), (n, 1))
    d = -o + rng.normal(0, 0.1, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sun = np.float32([0.58, 0.77, 0.27])
    ic = np.float32([2.6, 2.5, 2.3])
    args = (np.float32([1024.0] * 3), np.float32([1.0] * 3), sun, ic)
    cloud = _cloud(24, seed=4)
    j = jvpt.vpt_trace_rays(jax.random.PRNGKey(8), jnp.asarray(cloud), jnp.asarray(o),
                            jnp.asarray(d), *(jnp.asarray(a) for a in args), phase_g=0.2,
                            max_events=64)
    ev = torch.empty(n, dtype=torch.int32)
    t = tvpt.vpt_trace_rays(threefry.prng_key(8), _t(cloud), _t(o), _t(d), *args, phase_g=0.2,
                            max_events=64, events=ev)
    ok = (np.abs(np.asarray(j[0]) - t[0].numpy()) <= 1e-4).all(-1)
    assert ok.mean() >= 0.95
    assert (np.asarray(j[2]) == t[2].numpy()).mean() >= 0.95
    assert int(ev.max()) == 64 and int(ev.min()) >= 0


def test_r3_slice_takes_the_frames_ray_keys():
    """R3 keys ray i of a call `split(kt, .)[first + i]`: a slice of the rays
    traced with its offset equals the same slice of the whole trace, bit
    for bit (the smoke's one-row gate relies on it)."""
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    rng = np.random.default_rng(5)
    n, a, b = 200, 70, 130
    o = torch.as_tensor(np.tile(np.float32([0.1, 0.2, 1.0]), (n, 1)))
    d = -o + torch.as_tensor(rng.normal(0, 0.1, (n, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    grid = _t(_cloud(20, seed=6))
    p = tvt.vpt_params(grid.shape, (200.0,) * 3, (0.9,) * 3, (0.58, 0.77, 0.27), (2.6, 2.5, 2.3),
                       0.2, "Delta Tracking", 32, "Trilinear")
    kt = threefry.split(threefry.prng_key(9), 3)[2]
    whole = tvt.vpt_tracking(grid, o, d, kt, p)
    part = tvt.vpt_tracking(grid, o[a:b], d[a:b], kt, p, first=a)
    for x, y in zip(whole, part):
        assert torch.equal(x[a:b], y)
    assert bool(whole[2].any())
    shifted = tvt.vpt_tracking(grid, o[a:b], d[a:b], kt, p)
    assert not torch.equal(shifted[0], part[0])


def test_r3_counts_events_and_scatters():
    """R3's optional counts (`events=`, `scatters=`) on the plain version: a
    ray scattered iff it records a first scatter, never more often than it
    ran events, and a slice traced with its offset counts as the whole
    trace does."""
    from linevis_tpu_torch.kernels import vpt_tracking as tvt

    rng = np.random.default_rng(8)
    n, a, b = 200, 40, 160
    o = torch.as_tensor(np.tile(np.float32([0.1, 0.2, 1.0]), (n, 1)))
    d = -o + torch.as_tensor(rng.normal(0, 0.1, (n, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    grid = _t(_cloud(20, seed=6))
    kt = threefry.split(threefry.prng_key(4), 3)[2]
    for mode in tvt.SCAN_MODES:
        p = tvt.vpt_params(grid.shape, (200.0,) * 3, (0.9,) * 3, (0.58, 0.77, 0.27),
                           (2.6, 2.5, 2.3), 0.2, mode, 32, "Trilinear")
        ev, sc = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
        _, _, has = tvt.vpt_tracking(grid, o, d, kt, p, events=ev, scatters=sc)
        assert torch.equal(has, sc > 0) and bool((sc <= ev).all()) and int(sc.sum()) > 0
        ev2, sc2 = torch.empty(b - a, dtype=torch.int32), torch.empty(b - a, dtype=torch.int32)
        tvt.vpt_tracking(grid, o[a:b], d[a:b], kt, p, events=ev2, first=a, scatters=sc2)
        assert torch.equal(ev[a:b], ev2) and torch.equal(sc[a:b], sc2)


def test_r3_grid_bricks_hold_every_voxel():
    """R3 reads the grid in 8^3 bricks (`grid_bricks`): every voxel of a
    grid whose sides are not whole bricks sits where the kernel's
    `brick_at` looks, and the copy is kept with the grid until the grid
    changes."""
    from linevis_tpu_torch.kernels.vpt_tracking import BRICK, grid_bricks

    g = torch.arange(10 * 13 * 17, dtype=torch.float32).reshape(10, 13, 17)
    b = grid_bricks(g).reshape(-1)
    nyb, nxb = -(-13 // BRICK), -(-17 // BRICK)
    z, y, x = torch.meshgrid(torch.arange(10), torch.arange(13), torch.arange(17), indexing="ij")
    at = ((((z // 8) * nyb + y // 8) * nxb + x // 8) * 512 + (z % 8) * 64 + (y % 8) * 8 + x % 8)
    assert torch.equal(b[at], g)
    assert grid_bricks(g) is grid_bricks(g)
    g[0, 0, 0] = -1.0
    assert float(grid_bricks(g).reshape(-1)[0]) == -1.0


def test_estimators_agree():
    """Delta vs spectral delta vs ratio vs decomposition tracking: equal
    image means (TestVolumetricPathTracing.cpp:123-227), on the port alone."""
    grid = np.zeros((8, 8, 8), np.float32)
    grid[2:-2, 2:-2, 2:-2] = 1.0
    _, tc = _cams(24, 24, pos=(0.0, 0.1, 0.9))
    basis = _ray_basis(_t(tc.view_projection_matrix()))
    means = {}
    for mode in ("Delta Tracking", "Spectral Delta Tracking", "Ratio Tracking",
                 "Decomposition Tracking"):
        s = tvpt.VptSettings(mode=mode, extinction=(150.0,) * 3, scattering_albedo=(0.9,) * 3,
                             phase_g=0.2, max_events=192)
        img = tvpt.render_vpt(threefry.prng_key(0), _t(grid), _t(np.float32(tc.position)),
                              basis, 24, 24, settings=s, spp=8)
        assert bool(torch.isfinite(img).all())
        means[mode] = float(img.mean())
    vals = list(means.values())
    for v in vals[1:]:
        assert abs(vals[0] - v) < 0.015, means


def test_sparse_grid_equals_dense_and_skybox():
    cloud = _cloud(17, seed=3)
    cloud[cloud < 0.2] = 0.0
    s = tvpt.VptSettings(extinction=(80.0,) * 3, max_events=40)
    _, tc = _cams()
    args = (_t(np.float32(tc.position)), _ray_basis(_t(tc.view_projection_matrix())), W, H, s)
    dense = tvpt.render_vpt(threefry.prng_key(4), _t(cloud), *args)
    sparse = tvpt.render_vpt(threefry.prng_key(4), SparseGrid.from_dense(cloud, 4, "cpu"), *args)
    assert torch.equal(dense, sparse)
    up = tvpt.sample_skybox(torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]))
    np.testing.assert_allclose(up.numpy(), [[0.01, 0.1, 0.7], [0.1, 0.05, 0.01]], atol=1e-6)
    w = torch.nn.functional.normalize(torch.randn(64, 3, generator=torch.Generator().manual_seed(0)),
                                      dim=1)
    sun, ic = np.float32([0.58, 0.77, 0.27]), np.float32([2.6, 2.5, 2.3])
    for jf, tf, a in ((jvpt.sample_skybox, tvpt.sample_skybox, ()),
                      (jvpt.sample_light, tvpt.sample_light, (sun, ic))):
        ja = np.asarray(jf(jnp.asarray(w.numpy()), *(jnp.asarray(x) for x in a)))
        assert np.abs(ja - tf(w, *a).numpy()).max() <= 1e-5


def test_environment_map_lighting_equals_jax():
    env = np.random.default_rng(5).uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
    s = jvpt.VptSettings(extinction=(60.0,) * 3, max_events=40, phase_g=0.2)
    _agree(*_render_both(s, _cloud(seed=2), env=env))


def _scene_ld(seed=17):
    rng = np.random.default_rng(seed)
    L, P = 5, 8
    pos = np.cumsum(rng.normal(0, 0.08, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    d = {"positions": pos, "attributes": rng.uniform(0, 1, (L, 1, P)).astype(np.float32),
         "mask": np.ones((L, P), bool), "num_points": np.full((L,), P, np.int32),
         "attribute_names": ["a"]}
    return d


def test_renderer_accumulation_denoisers_and_settings_equal_jax(tmp_path):
    """The registry renderer against the JAX renderer: accumulation over 3
    frames, the EAW denoiser, `cloud_file`, `environment_map` (and its
    intensity), `vpt_mode` and `extinction`. The
    SVGF denoisers (a JAX compile of 8-18 s each here; the denoisers
    themselves are held against JAX in tests/test_torch_denoise_deferred.py)
    against the port's own denoiser on the port's frame, which equals
    JAX's."""
    d = _scene_ld()
    from linevis_tpu.core.trajectories import Trajectories as JTrajectories
    from linevis_tpu_torch.render.denoiser import svgf_denoise

    cloud = _cloud(16, seed=6)
    jld = JLDS(JTrajectories(**d), cloud_grid=cloud)
    tld = LineDataScattering(trajectories_from_numpy(d), cloud_grid=cloud)
    jc, tc = _cams(16, 12, pos=(0.0, 0.2, 1.4))
    xyz = str(tmp_path / "cloud.xyz")
    write_cloud_xyz(xyz, _cloud(12, seed=7) * 2.0)
    from PIL import Image

    png = str(tmp_path / "env.png")
    Image.fromarray((np.random.default_rng(9).uniform(0, 1, (8, 16, 3)) * 255).astype(np.uint8)
                    ).save(png)

    def renderer(settings, jax_too=True):
        out = []
        for make, ld, sm in ((create_renderer, tld, SettingsMap),) + (
                ((jcreate, jld, JSettingsMap),) if jax_too else ()):
            r = (make("Volumetric Path Tracer", device="cpu") if make is create_renderer
                 else make("Volumetric Path Tracer"))
            r.set_new_settings(sm(settings))
            r.set_line_data(ld)
            r.vpt = dataclasses.replace(r.vpt, max_events=32, extinction=(
                r.vpt.extinction if "extinction" in settings else (100.0,) * 3))
            out.append(r)
        return out

    for settings, frames in (({}, 3), ({"denoiser": "EAW"}, 2), ({"cloud_file": xyz}, 2),
                             ({"environment_map": png, "environment_map_intensity": 1.5}, 2),
                             ({"vpt_mode": "Ratio Tracking", "extinction": 90.0}, 2)):
        tr, jr = renderer(settings)
        assert tr.device.type == "cpu"
        for _ in range(frames):
            ja, ta = jr.render(jc), tr.render(tc)
        assert ta.shape == (12, 16, 4) and np.isfinite(ta).all() and tr.frame == frames
        assert np.abs(np.asarray(ja) - ta).mean() <= 2e-3, settings
    # SVGF: the accumulator denoised with the first-scatter positions.
    (plain,) = renderer({}, jax_too=False)
    (den,) = renderer({"denoiser": "SVGF"}, jax_too=False)
    img, fx, fh = plain.render(tc), plain._features[0], plain._features[1]
    pos = torch.where(fh[None], fx.permute(2, 0, 1), torch.full((3,) + tuple(fh.shape), 1e3))
    want = svgf_denoise(torch.as_tensor(img[..., :3]).permute(2, 0, 1), position=pos)
    assert np.allclose(den.render(tc)[..., :3], want.permute(1, 2, 0).numpy(), atol=1e-6)
    # SVGF (Temporal): a moving camera keeps converging; no accumulator.
    (tmp,) = renderer({"denoiser": "SVGF (Temporal)"}, jax_too=False)
    for i in range(3):
        _, cam = _cams(16, 12, pos=(0.02 * i, 0.2, 1.4))
        out = tmp.render(cam)
        assert out.shape == (12, 16, 4) and np.isfinite(out).all()
    assert tmp.frame == 3 and tmp._accum is None and tmp._svgf_state is not None
    assert create_renderer("Volumetric Path Tracer").device.type == "cuda"  # the default


def test_golden_vpt_through_the_registry():
    """tests/golden_scenes.py:scene_vpt on the port (the JAX golden test of
    this scene is `slow`): 64x48, the renderer's defaults (Delta tracking,
    extinction 1024, 512 events, 2 spp), frames 0-3."""
    d = _scene_ld()
    g = 20
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    cloud = np.exp(-4.0 * (xx**2 + yy**2 + zz**2)).astype(np.float32)
    ld = LineDataScattering(Trajectories(**d), cloud_grid=cloud)
    r = create_renderer("Volumetric Path Tracer", device="cpu")
    r.set_line_data(ld)
    cam = Camera(position=(0.0, 0.2, 1.6), look_at_point=(0, 0, 0), width=64, height=48)
    for _ in range(4):
        img = r.render(cam)
    golden = np.asarray(load_png(os.path.join(GOLDEN_DIR, "vpt.png")), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert rendered.shape == golden.shape
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3
