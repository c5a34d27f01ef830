"""The port's replay scripting (`automation/replay.py`, `replay_compat.py`)
and `TransferFunction.from_xml` against the JAX package on the CPU.

- The state timeline: the scripts of tests/test_camera_path.py:55-210 and
  tests/test_scene_api.py:148 load into equal `ReplayState`s in both
  packages, state by state, and `run` hands each package's renderer the
  same settings, cameras and screenshots, frame by frame. Both widgets
  draw with a recording stand-in for `create_renderer` (the JAX widget
  renders nothing), so no frame is computed.
- The golden `replay_screenshot.png` (tests/golden_scenes.py:336-358): the
  port's widget on the CPU, at the golden harness's bars (SSIM >= 0.99,
  image mean <= 2e-3, tests/test_golden.py:46-50); its final frame bit for
  bit the registry's MLAB frame at the script's last camera.
- `from_xml` on a file written here: the same points and table as JAX's.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from linevis_tpu.automation import replay as jreplay
from linevis_tpu.render.transfer_function import TransferFunction as JTF
from linevis_tpu_torch.automation import replay as treplay
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.render import renderer as trenderer
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.transfer_function import TransferFunction

from tests import golden_scenes
from tests.test_torch_registry import _line_data

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "replay_screenshot.png")


class _Recorder:
    """A renderer stand-in that records what the widget hands it."""

    def __init__(self, log, name):
        self.log, self.name = log, name
        self.line_data = None
        self.transfer_function_range = None
        self.vals = {}

    def set_line_data(self, ld):
        self.line_data = ld
        self.log.append(("line_data", self.name))

    def set_new_settings(self, s):
        self.vals.update(dict(s.items()))
        self.log.append(("settings", self.name, dict(s.items())))

    def set_transfer_function(self, tf):
        self.log.append(("tf", self.name, np.asarray(tf.color_points_linear).tolist()))

    def render(self, cam):
        self.log.append(("render", self.name, dict(self.vals), tuple(map(float, cam.position)),
                         tuple(map(float, cam.look_at_point)), float(cam.fovy), cam.width,
                         cam.height, self.transfer_function_range))
        return np.zeros((cam.height, cam.width, 4), np.float32)


def _state_dict(s):
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if hasattr(v, "items") and not isinstance(v, dict):
            v = dict(v.items())
        elif isinstance(v, np.ndarray):
            v = (str(v.dtype), v.tolist())
        out[f.name] = v
    return out


def _both(monkeypatch, script, loaders, tmp_path, fps=2.0, run=True, size=(8, 6),
          flight=False):
    """Load `script` into each package's widget and run it with recorders:
    -> (JAX log, port log, JAX widget, port widget)."""
    _write_tf_xml(tmp_path / "tf.xml")
    logs = []
    widgets = []
    for mod, loader, sub in ((jreplay, loaders[0], "j"), (treplay, loaders[1], "t")):
        log = []
        monkeypatch.setattr(mod, "create_renderer",
                            lambda name, *a, _log=log, **kw: _Recorder(_log, name))
        out = tmp_path / sub
        kw = dict(device="cpu") if mod is treplay else {}
        w = mod.ReplayWidget(loader, fps=fps, output_dir=str(out), **kw)
        w.use_camera_flight = flight
        w.transfer_function_dir = str(tmp_path)
        w.frame_callback = lambda i, img, _log=log: _log.append(("frame", i, img.shape))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # unknown camera checkpoints
            w.load_script(script)
        if run:
            log.append(("frames", w.run(width=size[0], height=size[1])))
            log.append(("files", sorted(os.listdir(out)) if out.exists() else []))
        logs.append(log)
        widgets.append(w)
    return logs[0], logs[1], widgets[0], widgets[1]


def _assert_same(jlog, tlog, jw, tw):
    assert [_state_dict(s) for s in tw.states] == [_state_dict(s) for s in jw.states]
    assert len(tlog) == len(jlog)
    for a, b in zip(tlog, jlog):
        assert a == b
    assert tw.use_camera_flight == jw.use_camera_flight
    assert tw.render_every_frame == jw.render_every_frame


SCRIPTS = {
    # tests/test_camera_path.py:55-92 (a numeric setting lerped, a quaternion).
    "interpolation_and_quat": (
        "g.set_renderer('FakeTest')\n"
        "g.set_rendering_algorithm_settings({'opacity_q': 0.0})\n"
        "g.set_duration(1.0)\n"
        "g.set_rendering_algorithm_settings({'opacity_q': 1.0})\n"
        "g.set_camera_orientation_quaternion([0, 0, 0, 1])\n"
        "g.set_duration(0)\n"),
    # tests/test_camera_path.py:95-131 (import g, modules.campath).
    "reference_compat": """
import math
from modules.campath import camera_path_circle, blend_camera_view, jitter_camera
import g

g.set_duration(0)
g.set_renderer('Opaque')
g.set_camera_fovy_deg(math.degrees(0.7))
g.set_camera_yaw_pitch_rad(0.5, 0.1)
g.set_camera_look_at_location((0.0, 0.0, 0.0))
g.set_transfer_function_range(0.1, 0.9)
g.set_transfer_function('tf.xml')
g.set_duration(0.5)
camera_path_circle(0.0, math.pi, 1.0, 1.0, 2.0, subdivisions=8)
g.set_camera_checkpoint('missing')
g.set_rendering_algorithm_settings({'opacity': '0.4', 'mode': 'x', 'v': '0 1 2'})
g.set_duration(0.5)
g.set_rendering_algorithm_settings({'opacity': '0.8', 'mode': 'y', 'v': '1 1 1'})
q = g.convert_yaw_pitch_rad_to_quaternion(0.3, -0.2)
g.set_camera_orientation_quaternion(q)
g.set_duration(0.5)
blend_camera_view((0.0, 0.1, 1.0), (0.3, 0.1, 0.9), 0.1, 0.4, total_time=0.5)
jitter_camera((0.0, 0.0, 0.0), (0.0, 0.2, 1.1), 0.2, 0.1)
g.save_screenshot('shot.png')
""",
    # tests/test_camera_path.py:134-153 (the replay() convention).
    "replay_function": (
        "import g\n"
        "def init_scene():\n"
        "    g.set_duration(0)\n"
        "    g.set_renderer('Opaque')\n"
        "def replay():\n"
        "    init_scene()\n"
        "    g.set_duration(2)\n"
        "    g.set_camera_position(0.1, 0.2, 1.0)\n"),
    # tests/test_scene_api.py:148-172 (dataset settings, screenshots).
    "scene_api": """
g.set_dataset("test")
g.set_renderer("Opaque")
g.set_dataset_settings({"line_width": 0.01})
g.set_camera_position(0.0, 0.0, 1.5)
g.set_duration(0.5)
g.set_camera_position(0.3, 0.1, 1.4)
g.set_duration(0.5)
g.save_screenshot("final.png")
""",
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_replay_timeline_equals_jax(monkeypatch, tmp_path, name):
    jld, ld = _line_data(21)
    _assert_same(*_both(monkeypatch, SCRIPTS[name], (lambda n: jld, lambda n: ld), tmp_path,
                        fps=4.0))
    if name == "scene_api":
        assert ld.line_width == jld.line_width == 0.01


def test_replay_camera_flight_equals_jax(monkeypatch, tmp_path):
    """tests/test_camera_path.py:187-210: set_use_camera_flight(True) flies
    the circle path around the data's AABB; every frame's camera equal."""
    jld, ld = _line_data(3)
    script = ("g.set_duration(0)\n"
              "g.set_dataset('x')\n"
              "g.set_renderer('Opaque')\n"
              "g.set_use_camera_flight(True)\n"
              "g.set_render_every_frame(True)\n"
              "g.set_duration(1.5)\n")
    jlog, tlog, jw, tw = _both(monkeypatch, script, (lambda n: jld, lambda n: ld), tmp_path)
    _assert_same(jlog, tlog, jw, tw)
    cams = [e[3] for e in tlog if e[0] == "render"]
    assert len(cams) == 3 and cams[0] != cams[-1]


def test_replay_helpers_and_checkpoints_equal_jax(tmp_path):
    for v in ("0.5", "3", "1 2", "1, 2, 3", "1 2 3 4", "1 2 3 4 5", "abc", None, 2.0):
        j, t = jreplay._parse_numeric(v), treplay._parse_numeric(v)
        assert (t is None) == (j is None) and np.array_equal(np.asarray(t), np.asarray(j))
    jw = jreplay.ReplayWidget(lambda n: None)
    tw = treplay.ReplayWidget(lambda n: None, device="cpu")
    for w in (jw, tw):
        w.checkpoints = {"a": {"position": [0.1, 0.2, 1.0], "look_at": [0.0, 0.1, 0.0]}}
    path = tmp_path / "cp.json"
    tw.save_checkpoints(str(path))
    jw.load_checkpoints(str(path))
    assert jw.checkpoints == tw.checkpoints
    script = "g.set_camera_checkpoint('a')\ng.set_duration(1)\n"
    jw.load_script(script)
    tw.load_script(script)
    assert [_state_dict(s) for s in tw.states] == [_state_dict(s) for s in jw.states]
    g = treplay._GApi(tw)
    assert g.get_default_camera_fov_deg() == jreplay._GApi(jw).get_default_camera_fov_deg()
    np.testing.assert_array_equal(g.slerp([0, 0, 0, 1], [0, 1, 0, 0], 0.3),
                                  jreplay.slerp([0, 0, 0, 1], [0, 1, 0, 0], 0.3))


def _write_tf_xml(path):
    path.write_text(
        "<TransferFunction colorspace=\"sRGB\" interpolation_colorspace=\"Linear RGB\">\n"
        "  <OpacityPoints>\n"
        "    <OpacityPoint position=\"0\" opacity=\"0.2\"/>\n"
        "    <OpacityPoint position=\"0.6\" opacity=\"0.9\"/>\n"
        "    <OpacityPoint position=\"1\" opacity=\"1\"/>\n"
        "  </OpacityPoints>\n"
        "  <ColorPoints color_data=\"ushort\">\n"
        "    <ColorPoint position=\"0\" r=\"10\" g=\"20\" b=\"200\"/>\n"
        "    <ColorPoint position=\"0.3\" r=\"250\" g=\"250\" b=\"250\"/>\n"
        "    <ColorPoint position=\"1\" r=\"200\" g=\"20\" b=\"10\"/>\n"
        "  </ColorPoints>\n"
        "</TransferFunction>\n")


def test_transfer_function_from_xml_equals_jax(tmp_path):
    path = tmp_path / "tf.xml"
    _write_tf_xml(path)
    j, t = JTF.from_xml(str(path), (0.1, 0.9)), TransferFunction.from_xml(str(path), (0.1, 0.9))
    for a, b in ((t, j), (TransferFunction.viridis_like(), JTF.viridis_like())):
        np.testing.assert_array_equal(a.color_points_linear, b.color_points_linear)
        np.testing.assert_array_equal(a.opacity_points_np, b.opacity_points_np)
        np.testing.assert_array_equal(a.table, b.table)
        assert a.value_range == b.value_range
        for x, y in zip(a.points_arrays(), b.points_arrays()):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert t.opacity_points_np.tolist()[1] == pytest.approx([0.6, 0.9])


def test_replay_screenshot_golden_through_the_port(tmp_path):
    """tests/golden_scenes.py:scene_replay_screenshot on the port's widget
    (the CPU), held to the golden; its last frame is the registry's MLAB
    frame at the script's last camera, bit for bit."""
    w, h = golden_scenes.SMALL_SIZE
    _, ld = _line_data(21)
    captured = []
    widget = treplay.ReplayWidget(lambda name: ld, fps=2.0, output_dir=str(tmp_path),
                                  device="cpu")
    widget.frame_callback = lambda i, img: captured.append(img)
    widget.load_script(
        'g.set_duration(0)\n'
        'g.set_dataset("synthetic")\n'
        'g.set_renderer("Multi-Layer Alpha Blending")\n'
        'g.set_rendering_algorithm_settings({"opacity": 0.5})\n'
        'g.set_camera_position(0.0, 0.2, 1.4)\n'
        'g.set_camera_look_at(0.0, 0.0, 0.0)\n'
        'g.set_duration(1)\n'
        'g.set_camera_position(0.35, 0.25, 1.3)\n'
    )
    assert widget.run(width=w, height=h) == 2
    img = captured[-1]
    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert rendered.shape == golden.shape
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3
    r = trenderer.create_renderer("Multi-Layer Alpha Blending", SettingsMap({"opacity": 0.5}),
                                  device="cpu")
    r.set_line_data(ld)
    # The widget's camera: the script's numbers as float32 (ReplayState's arrays).
    cam = Camera(position=tuple(np.float32([0.35, 0.25, 1.3])),
                 look_at_point=tuple(np.float32([0.0, 0.0, 0.0])), width=w, height=h)
    np.testing.assert_array_equal(r.render(cam), img)
