"""The port's multi-view compositor, requesters, 3D-TSV socket requester,
tiled addressing and per-pass frame profiler on the CPU.

- `render/data_view.py`: tests/test_data_view.py's tiling and camera link
  on the port, each view's tile bit for bit its own renderer's frame.
- `scene/requester.py`: each reply equal to the direct call (the loader,
  the tracer on the requester's device); a failure in the worker raised at
  the poll (tests/test_requester.py).
- `automation/tsv_requester.py`: the loopback ZeroMQ round trip of
  tests/test_tsv_requester.py against a fake tracer on a port the
  operating system picks (no fixed port), the request equal to JAX's JSON.
- `kernels/tiled_address.py`: equal to JAX's on every mode.
- `automation/profiling.py:FrameProfiler`: rows, averages and the CSV; a
  pass on the CPU has no device time.
"""

import csv
import json
import queue
import threading
import time

import numpy as np
import pytest
import torch

from linevis_tpu.automation import tsv_requester as jtsv
from linevis_tpu.kernels import tiled_address as jta
from linevis_tpu_torch.automation import tsv_requester as ttsv
from linevis_tpu_torch.automation.profiling import FrameProfiler
from linevis_tpu_torch.core.trajectories import Trajectories
from linevis_tpu_torch.kernels import tiled_address as tta
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.data_view import DataView, MultiViewCompositor
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.scene.factory import load_line_data
from linevis_tpu_torch.scene.line_data import LineData
from linevis_tpu_torch.scene.requester import LineDataRequester, StreamlineTracingRequester
from linevis_tpu_torch.trace.fields import tornado_velocity
from linevis_tpu_torch.trace.streamline import StreamlineTracingSettings, trace_streamlines

torch.set_num_threads(1)


def _line_data():
    # tests/test_data_view.py:_line_data
    rng = np.random.default_rng(6)
    L, P = 4, 6
    pos = np.cumsum(rng.normal(0, 0.08, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    ld = LineData(Trajectories(
        positions=pos, attributes=rng.uniform(0, 1, (L, 1, P)).astype(np.float32),
        mask=np.ones((L, P), bool), num_points=np.full((L,), P, np.int32),
        attribute_names=["a"]))
    ld.set_line_width(0.05)
    return ld


def test_two_views_tiled_and_each_its_renderers_frame():
    ld = _line_data()
    cam = Camera(position=(0.0, 0.1, 1.2), width=32, height=16)
    views = [DataView("Opaque", camera=cam, device="cpu"),
             DataView("Depth Complexity", camera=cam, device="cpu")]
    assert all(v.renderer.device.type == "cpu" for v in views)
    comp = MultiViewCompositor(views, gap=2)
    comp.set_line_data(ld)
    img = comp.render()
    assert img.shape == (16, 32 * 2 + 2, 4) and np.isfinite(img).all()
    assert (img[:, 32:34] == 0).all()  # the gap stays zero
    for v, tile in zip(views, (img[:, :32], img[:, 34:])):
        r = create_renderer(v.rendering_mode, device="cpu")
        r.set_line_data(ld)
        np.testing.assert_array_equal(tile, r.render(cam))
    assert not np.allclose(img[:, :32], img[:, 34:])
    views[1].set_renderer("Opaque")
    assert views[1].renderer.device.type == "cpu" and views[1].renderer.line_data is ld
    np.testing.assert_array_equal(views[1].render(), img[:, :32])


def test_camera_sync_and_three_view_grid():
    ld = _line_data()
    views = [DataView("Opaque", camera=Camera(position=(0, 0, 2), width=16, height=8),
                      device="cpu"),
             DataView("Opaque", camera=Camera(position=(2, 0, 0), width=16, height=8),
                      device="cpu")]
    comp = MultiViewCompositor(views)
    comp.set_line_data(ld)
    assert not np.allclose(views[0].render(), views[1].render())
    comp.sync_cameras(Camera(position=(0.0, 0.1, 1.2), width=8, height=8))
    assert views[0].camera.width == 16 and views[0].camera.position == (0.0, 0.1, 1.2)
    np.testing.assert_array_equal(views[0].render(), views[1].render())
    three = MultiViewCompositor(views + [DataView("Opaque", camera=views[0].camera,
                                                 device="cpu")], gap=1)
    three.set_line_data(ld)
    assert three.render().shape == (8 * 2 + 1, 16 * 2 + 1, 4)  # a 2 x 2 grid


def _poll(get, tries=500):
    for _ in range(tries):
        out = get()
        if out is not None:
            return out
        time.sleep(0.01)
    return None


def _write_obj_lines(path):
    # tests/test_requester.py:_write_obj_lines
    with open(path, "w") as f:
        for i in range(6):
            f.write(f"v {i * 0.1} 0 0\n")
            f.write(f"vt {i * 0.1}\n")
        f.write("l 1 2 3\n")
        f.write("l 4 5 6\n")


def test_line_data_requester_equals_the_loader_and_errors_propagate(tmp_path):
    path = str(tmp_path / "lines.obj")
    _write_obj_lines(path)
    req = LineDataRequester()
    req.queue_request([path])
    req.join()
    data = _poll(req.get_loaded_data)
    assert data is not None and req.get_loaded_data() is None  # the slot is consumed
    direct = load_line_data(path)
    np.testing.assert_array_equal(data.trajectories.positions, direct.trajectories.positions)
    assert data.trajectories.positions.shape[0] == 2
    req.queue_request([str(tmp_path / "missing.obj")])
    req.join()
    with pytest.raises(Exception):
        _poll(req.get_loaded_data)
    assert not req.is_processing


def test_streamline_requester_traces_on_its_device():
    settings = StreamlineTracingSettings(num_seeds=8, max_steps=16, dt=0.01)
    req = StreamlineTracingRequester(device="cpu")
    req.queue_request(tornado_velocity, settings)
    req.join(timeout=120)
    traj = _poll(req.get_traced_lines)
    assert traj is not None and traj.positions.shape[0] == 8
    direct = trace_streamlines(tornado_velocity, settings, device="cpu")
    np.testing.assert_array_equal(traj.positions, direct.positions)
    np.testing.assert_array_equal(traj.mask, direct.mask)

    def broken(p):
        raise RuntimeError("field failed")

    req.queue_request(broken, settings)
    req.join(timeout=30)
    with pytest.raises(RuntimeError, match="field failed"):
        _poll(req.get_traced_lines)


def _fake_tsv_server(reply, got, port_box):
    zmq = pytest.importorskip("zmq")
    sock = zmq.Context.instance().socket(zmq.REP)
    sock.setsockopt(zmq.LINGER, 0)
    sock.setsockopt(zmq.RCVTIMEO, 5000)
    port_box.put(sock.bind_to_random_port("tcp://127.0.0.1"))
    try:
        got.append(json.loads(sock.recv_string()))
        sock.send_string(json.dumps(reply))
    finally:
        sock.close(0)


def test_tsv_request_reply_roundtrip(tmp_path):
    pytest.importorskip("zmq")
    from examples.render_stress_bands import synth_v3_blocks
    from linevis_tpu_torch.loaders.stress_dat import write_stress_trajectories_dat_v3

    write_stress_trajectories_dat_v3(str(tmp_path / "tsv_result.dat"),
                                     synth_v3_blocks(np.random.default_rng(0), lines_per_ps=2,
                                                     n=8), None)
    got, port_box = [], queue.Queue()
    server = threading.Thread(target=_fake_tsv_server, args=(
        {"fileName": ["tsv_result.dat"], "version": 3}, got, port_box))
    server.start()
    port = port_box.get(timeout=10)
    req = ttsv.StressLineTracingRequester(address="127.0.0.1", port=port, timeout_ms=5000)
    kw = dict(mesh_filename="femur.mesh", seed_strategy="Volume", trace_medium=False,
              max_angle_deviation=6.0, multi_merging_thresholds=[0.1, 0.2])
    req.queue_request(ttsv.StressLineTracingSettings(**kw))
    reply = req.get_reply(timeout=10.0)
    server.join(timeout=10.0)
    req.join()
    assert not server.is_alive()
    assert got and got[0] == json.loads(jtsv.StressLineTracingSettings(**kw).to_request_json())
    assert got[0]["selectedPrincipalStressField"] == [1, 3]
    assert reply is not None and "error" not in reply
    ld = req.load_reply_line_data(reply, base_dir=str(tmp_path))
    assert len(ld.trajectories_ps) == 3
    assert ttsv.SEED_STRATEGIES == jtsv.SEED_STRATEGIES


@pytest.mark.parametrize("mode,kw", [("linear", {}), ("morton", {}),
                                     ("tiled", dict(tile_n=2, tile_m=8)),
                                     ("tiled", dict(tile_n=2, tile_m=2)),
                                     ("tiled", dict(tile_n=4, tile_m=4))])
def test_tiled_address_equals_jax(mode, kw):
    W, H = 32, 16
    ys, xs = np.mgrid[0:H, 0:W]
    np.testing.assert_array_equal(tta.addr_gen(xs, ys, W, mode, **kw),
                                  jta.addr_gen(xs, ys, W, mode, **kw))
    img = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)
    packed = tta.pack_image(img, mode, **kw)
    np.testing.assert_array_equal(packed, jta.pack_image(img, mode, **kw))
    np.testing.assert_array_equal(tta.unpack_image(packed, W, H, mode, **kw), img)
    np.testing.assert_array_equal(tta.MORTON_8X8, jta.MORTON_8X8)
    with pytest.raises(ValueError):
        tta.addr_gen(xs, ys, W, "hilbert")


def test_frame_profiler_rows_summary_and_csv(tmp_path):
    prof = FrameProfiler()
    x = torch.ones(64)
    for _ in range(2):
        with prof.pass_("a", force=x):
            x = x * 2.0
        with prof.pass_("b"):
            time.sleep(0.002)
        prof.next_frame()
    assert [(r["Frame"], r["Pass"]) for r in prof.rows] == [(0, "a"), (0, "b"), (1, "a"),
                                                             (1, "b")]
    assert all(r["Device Time (ms)"] == "" for r in prof.rows)  # no pass on a card
    s = prof.summary()
    assert set(s) == {"a", "b"} and s["b"] >= 2.0
    assert prof.summary("Device Time (ms)") == {}
    path = tmp_path / "passes.csv"
    prof.write_csv(str(path))
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == FrameProfiler.COLUMNS and len(rows) == 4
