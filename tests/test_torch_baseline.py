"""The repo's five reference configs (tests/baseline_scenes.py) through the
port's registry, against the JAX package on the CPU.

- `automation/camera_path.py` and replay's `slerp` and `_quat_rotate`
  against JAX (tests/test_camera_path.py:9-52's cases on both packages).
- Config 3's convection field and its trace against JAX on the same numpy
  seeds: masks equal; positions within 1e-5 (measured 3.0e-6 after 300 RK4
  steps: XLA's and PyTorch's sin/cos differ by an ulp, 1.2e-7 in the field);
  velocity magnitude within 3e-5 and vorticity and helicity within 1e-4
  (central differences, as tests/test_torch_trace.py states).
- Each of `entry.BASELINE_CONFIGS`' six builders at scale 0.05 (the scale of
  tests/test_golden_baseline.py:test_baseline_config_smoke_small), drawing
  the JAX builders' resolutions, cameras and frame counts. The tornado and
  convection scenes are the JAX package's trajectories carried across with
  `convert.trajectories_from_numpy` (jax.random drew their seeds; the port
  draws from numpy), so the images do not depend on the trace. Config 1
  against the JAX registry's image (SSIM >= 0.999, mean abs <= 2e-3; met at
  SSIM 0.9999999999, mean abs 1.7e-7, with the JAX kernel's bfloat16
  reciprocal routed to the exact one).
  The others bit for bit against the port's render function called with
  the arguments the JAX registry's renderer passes, since a JAX interpret
  frame of them takes 40-110 s at this scale: configs 2, 4 and 4b (B2's
  K-buffer at K 4-32 and its composite at K 8 and 32, config 2's, are held
  against the JAX kernel in tests/test_torch_oit.py, `render_tubes_mlab`'s
  image at K=8 there too; 4 and 4b through the JAX registry on a small
  Femur in tests/test_torch_stress.py); config 3, whose samples the JAX registry
  draws from jax.random, against `render_tubes_rtao`'s two frames on the same
  device; config 5 against `OpacityOptimizationRenderer` on the cameras of
  the JAX package's own circle path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from linevis_tpu.automation import camera_path as jcp
from linevis_tpu.automation import replay as jreplay
from linevis_tpu.core.settings import SettingsMap as JSettingsMap
from linevis_tpu.core.trajectories import normalize_attributes, normalize_trajectories
from linevis_tpu.render import renderer as jrenderer
from linevis_tpu.trace.streamline import StreamlineTracingSettings as JSettings
from linevis_tpu.trace.streamline import trace_streamlines as jtrace
from linevis_tpu_torch import entry
from linevis_tpu_torch.automation import camera_path as tcp
from linevis_tpu_torch.automation import replay as treplay
from linevis_tpu_torch.convert import trajectories_from_numpy
from linevis_tpu_torch.render.framebuffer import ssim
from linevis_tpu_torch.render.opacity_optimization import OpacityOptimizationRenderer
from linevis_tpu_torch.render.rtao import RtaoSettings, render_tubes_rtao
from linevis_tpu_torch.render.tube_raster import camera_tensors
from linevis_tpu_torch.scene.line_data import LineData

from tests import baseline_scenes

torch.set_num_threads(1)

SCALE = 0.05


def test_slerp_and_quat_rotate_match_jax():
    s = np.sin(np.pi / 4)
    q0 = np.array([0, 0, 0, 1], np.float32)
    q1 = np.array([0, s, 0, np.cos(np.pi / 4)], np.float32)
    q2 = np.array([0.1, -0.7, 0.3, -0.6], np.float32)  # d < 0: the short way round
    for a, b in ((q0, q1), (q1, q2), (q0, q0 * 1.0001)):
        for t in (0.0, 0.3, 0.5, 1.0):
            np.testing.assert_array_equal(treplay.slerp(a, b, t), jreplay.slerp(a, b, t))
    mid = treplay.slerp(q0, q1, 0.5)
    v = treplay._quat_rotate(mid, (0, 0, -1))
    np.testing.assert_array_equal(v, jreplay._quat_rotate(mid, (0, 0, -1)))
    assert abs(np.degrees(np.arctan2(-v[0], -v[2])) - 45.0) < 0.1


def test_binpath_round_trip_matches_jax(tmp_path):
    cps = [
        tcp.ControlPoint(0.0, np.array([1, 2, 3], np.float32), np.array([0, 0, 0, 1], np.float32)),
        tcp.ControlPoint(2.5, np.array([4, 5, 6], np.float32),
                         np.array([0, 0.7071, 0, 0.7071], np.float32)),
    ]
    tp, jp = str(tmp_path / "t.binpath"), str(tmp_path / "j.binpath")
    tcp.CameraPath(cps).save_to_binary_file(tp)
    jcp.CameraPath([jcp.ControlPoint(c.time, c.position, c.orientation)
                    for c in cps]).save_to_binary_file(jp)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    q = tcp.CameraPath.from_binary_file(jp)
    assert len(q.control_points) == 2
    np.testing.assert_allclose(q.control_points[1].position, [4, 5, 6])
    assert q.control_points[1].time == 2.5
    pos, quat = q.interpolate(1.25)
    jpos, jquat = jcp.CameraPath.from_binary_file(tp).interpolate(1.25)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(quat, jquat)
    np.testing.assert_allclose(pos, [2.5, 3.5, 4.5], atol=1e-5)
    (tmp_path / "bad.binpath").write_bytes(b"NOPE")
    with pytest.raises(ValueError, match="not a linevis_tpu .binpath"):
        tcp.CameraPath.from_binary_file(str(tmp_path / "bad.binpath"))


def test_circle_path_matches_jax():
    aabb = np.array([[-0.5, -0.2, -0.5], [0.5, 0.2, 0.5]], np.float32)
    t_path = tcp.CameraPath.from_circle_path(aabb, total_time=8.0)
    j_path = jcp.CameraPath.from_circle_path(aabb, total_time=8.0)
    assert t_path.total_time == j_path.total_time == 8.0
    assert tcp.CAMERA_PATH_TIME_PERFORMANCE_MEASUREMENT == 256.0
    assert tcp.CAMERA_PATH_TIME_RECORDING == jcp.CAMERA_PATH_TIME_RECORDING
    for a, b in zip(t_path.control_points, j_path.control_points, strict=True):
        assert a.time == b.time
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.orientation, b.orientation)
    for t in (0.0, 2.0, 5.3, 9.0):
        pos, look = t_path.camera_at(t)
        jpos, jlook = j_path.camera_at(t)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(look, jlook)
        fwd = look - pos
        to_center = -pos + np.array([0, pos[1], 0])
        cos = np.dot(fwd, to_center) / (np.linalg.norm(fwd) * np.linalg.norm(to_center))
        assert cos > 0.95
    # _look_quat's other branch: a camera looking straight down.
    np.testing.assert_array_equal(tcp._look_quat((0, 1, 0), (0, 0, 0)),
                                  jcp._look_quat((0, 1, 0), (0, 0, 0)))
    with pytest.raises(ValueError, match="empty camera path"):
        tcp.CameraPath().interpolate(0.0)


def _jax_convection(p, time=0.0):
    # tests/baseline_scenes.py:99-106.
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    k = 2.0 * np.pi
    vx = jnp.sin(k * x) * jnp.cos(k * y)
    vy = -jnp.cos(k * x) * jnp.sin(k * y)
    vz = 0.3 * jnp.sin(k * x) * jnp.sin(k * z)
    return jnp.stack([vx, vy, vz], axis=-1)


def test_convection_velocity_matches_jax():
    p = np.random.default_rng(0).uniform(-0.1, 1.1, (4000, 3)).astype(np.float32)
    np.testing.assert_allclose(entry.convection_velocity(torch.tensor(p)).numpy(),
                               np.asarray(_jax_convection(jnp.asarray(p))), rtol=0, atol=3e-7)


@pytest.fixture(scope="module")
def convection():
    """Config 3's trace on numpy seeds by each package -> (port, JAX)."""
    seeds = np.random.default_rng(42).uniform(size=(256, 3)).astype(np.float32)
    j = jtrace(_jax_convection, JSettings(num_seeds=256, max_steps=300, dt=1.0 / 120.0),
               seeds=jnp.asarray(seeds))
    j = normalize_attributes(normalize_trajectories(j))
    return entry.convection_trajectories("cpu", seeds=seeds), j


def test_convection_trace_matches_jax(convection):
    t, j = convection
    assert t.positions.shape == j.positions.shape == (256, 301, 3)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.num_points, j.num_points)
    assert t.mask.sum() > 0.5 * t.mask.size
    np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.attributes[:, 0], j.attributes[:, 0], rtol=0, atol=3e-5)
    np.testing.assert_allclose(t.attributes[:, 1:], j.attributes[:, 1:], rtol=0, atol=1e-4)
    # The config's own seeds: the tracer's default draw from default_rng(42).
    ld = entry.convection_line_data("cpu")
    np.testing.assert_array_equal(ld.trajectories.positions, t.positions)
    assert ld.line_width == 0.004


def _port_line_data(t, line_width):
    """JAX-package trajectories as the port's LineData of `line_width`."""
    ld = LineData(trajectories_from_numpy(dict(
        positions=t.positions, attributes=t.attributes, mask=t.mask,
        num_points=t.num_points, attribute_names=t.attribute_names)))
    ld.set_line_width(line_width)
    return ld


@pytest.fixture(scope="module")
def tornado():
    """The JAX builders' tornado line data and its port copy."""
    jld = baseline_scenes._tornado_line_data()
    assert jld.line_width == entry.TORNADO_LINE_WIDTH
    return jld, _port_line_data(jld.trajectories, jld.line_width)


def _run(name, line_data, frames=None):
    return entry.BASELINE_CONFIGS[name](device="cpu", scale=SCALE, frames=frames,
                                        line_data=line_data)


def _jax_renderer(run, settings):
    """The JAX registry's renderer of `run`'s mode and settings."""
    j = jrenderer.create_renderer(run.renderer.name, JSettingsMap(settings))
    s, js = run.renderer._raster_settings(run.cameras[0]), j._raster_settings(run.cameras[0])
    assert (s.width, s.height, s.tile_w, s.tile_h, s.tf_color, s.tf_opacity,
            s.depth_cue_strength) == (js.width, js.height, js.tile_w, js.tile_h, js.tf_color,
                                      js.tf_opacity, js.depth_cue_strength)
    return j, s


def _nonempty(img):
    assert np.isfinite(img).all()
    assert (np.abs(img[..., :3] - 1.0).max(-1) > 1e-3).mean() > 0.02


def test_baseline_configs_match_the_jax_builders():
    assert list(entry.BASELINE_CONFIGS) == list(baseline_scenes.BASELINE_SCENES)
    assert entry._res(1920, 1080, SCALE) == (96, 48)
    assert entry._res(800, 600, SCALE) == (32, 16)
    assert entry._res(1920, 1080, 1.0) == (1920, 1072)
    ld = LineData(trajectories_from_numpy(dict(
        positions=np.zeros((1, 8, 3), np.float32), attributes=np.zeros((1, 1, 8), np.float32),
        mask=np.ones((1, 8), bool), num_points=np.array([8], np.int32))))
    modes = {}
    for name, build in entry.BASELINE_CONFIGS.items():
        run = build(device="cpu", scale=SCALE, line_data=ld)
        modes[name] = (run.renderer.name, len(run.cameras), run.renderer.opacity,
                       run.cameras[0].width, run.cameras[0].height)
        assert run.renderer.device.type == "cpu"
    assert modes == {
        "cfg1_tornado_opaque_800x600": ("Opaque", 1, 0.3, 32, 16),
        "cfg2_tornado_ppll_1080p": ("Per-Pixel Linked Lists", 1, 0.3, 96, 48),
        "cfg3_convection_rtao_1080p": ("RTAO", 2, 0.3, 96, 48),
        "cfg4_femur_mlab_1080p": ("Multi-Layer Alpha Blending", 1, 0.45, 96, 48),
        "cfg4b_femur_mboit_1080p": ("Moment-Based OIT", 1, 0.45, 96, 48),
        "cfg5_tornado_opacityopt_1080p": ("Opacity Optimization", 3, 0.3, 96, 48),
    }
    # An orbit keeps the first camera and its distance to the look-at point.
    cams = entry.BASELINE_CONFIGS["cfg2_tornado_ppll_1080p"](
        device="cpu", frames=4, line_data=ld).cameras
    assert len(cams) == 4 and cams[0].position == entry.BASELINE_CAMERA
    for c in cams[1:]:
        assert np.linalg.norm(c.position) == pytest.approx(np.linalg.norm(cams[0].position))
        assert c.position != cams[0].position


def test_config1_matches_the_jax_registry(tornado, monkeypatch):
    """The JAX capsule kernel's `pl.reciprocal(approx=True)` goes to the
    exact reciprocal: Pallas interpret mode emulates the approximation in
    bfloat16 (tests/test_torch_tube_raster.py `exact_reciprocal`, ROADMAP
    queue C)."""
    jld, ld = tornado
    monkeypatch.setenv("LINEVIS_BASELINE_SCALE", str(SCALE))
    exact = pl.reciprocal
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: exact(x))
    jimg = np.asarray(baseline_scenes.config1_tornado_opaque())
    jax.clear_caches()
    img = _run("cfg1_tornado_opaque_800x600", ld).render()
    assert img.shape == jimg.shape == (16, 32, 4)
    _nonempty(img)
    assert ssim(img[..., :3], jimg[..., :3]) >= 0.999
    assert np.abs(img - jimg).mean() <= 2e-3


def _oit_frame(run, fn, **kw):
    from linevis_tpu_torch.render import oit

    cam = run.cameras[-1]
    img = getattr(oit, fn)(run.renderer.line_data.get_capsule_scene(device="cpu"),
                           *camera_tensors(cam, "cpu"), run.renderer._raster_settings(cam), **kw)
    return np.moveaxis(img.numpy(), 0, -1)


def test_config2_calls_its_render_function(tornado):
    _, ld = tornado
    run = _run("cfg2_tornado_ppll_1080p", ld)
    j, _ = _jax_renderer(run, {"opacity": 0.3})
    img = run.render()
    _nonempty(img)
    assert j.K == 32
    np.testing.assert_array_equal(img, _oit_frame(run, "render_tubes_mlab", K=j.K,
                                                  opacity=j.opacity))


def test_config3_calls_its_render_function(convection):
    _, jt = convection
    ld = _port_line_data(jt, entry.CONVECTION_LINE_WIDTH)
    run = _run("cfg3_convection_rtao_1080p", ld)
    _jax_renderer(run, {})
    img = run.render()
    _nonempty(img)
    cam = run.cameras[0]
    frames = [render_tubes_rtao(ld.get_capsule_scene(device="cpu"), *camera_tensors(cam, "cpu"),
                                run.renderer._raster_settings(cam), RtaoSettings(), frame=f,
                                grid=run.renderer._grid) for f in range(2)]
    want = np.moveaxis(((frames[0] * 1 + frames[1]) / 2).numpy(), 0, -1)
    np.testing.assert_allclose(img, want, rtol=0, atol=1e-6)
    assert (img[..., :3] < 0.99).any()


@pytest.fixture(scope="module")
def femur():
    return entry.femur_line_data()


@pytest.mark.parametrize("name,fn", [("cfg4_femur_mlab_1080p", "render_tubes_mlab"),
                                     ("cfg4b_femur_mboit_1080p", "render_tubes_mboit")])
def test_config4_calls_its_render_function(femur, name, fn):
    run = _run(name, None if name.startswith("cfg4_") else femur)
    j, _ = _jax_renderer(run, {"opacity": 0.45})
    img = run.render()
    _nonempty(img)
    if fn == "render_tubes_mlab":
        kw = dict(K=j.K, opacity=j.opacity)
        ld = run.renderer.line_data
        np.testing.assert_array_equal(ld.trajectories.positions, femur.trajectories.positions)
    else:
        kw = dict(n_mom=j.n_mom, opacity=j.opacity, trigonometric=not j.use_power_moments,
                  pixel_format=j.pixel_format)
    np.testing.assert_array_equal(img, _oit_frame(run, fn, **kw))


def test_config5_calls_its_render_function(tornado):
    jld, ld = tornado
    run = _run("cfg5_tornado_opacityopt_1080p", ld)
    j, s = _jax_renderer(run, {})
    img = run.render()
    _nonempty(img)
    # The cameras: the 1st to 3rd of 16 steps along the JAX package's circle
    # path around the same line data.
    path = jcp.CameraPath.from_circle_path(jld.get_aabb())
    for i, cam in enumerate(run.cameras):
        pos, look = path.camera_at(i / 16.0 * path.total_time)
        assert cam.position == tuple(pos) and cam.look_at_point == tuple(look)
    traj = ld.trajectories
    r = OpacityOptimizationRenderer(ld.get_capsule_scene(device="cpu"), traj.num_lines,
                                    traj.max_points, s)
    for cam in run.cameras:
        want = r.render(cam)
    np.testing.assert_array_equal(img, np.moveaxis(want.numpy(), 0, -1))
