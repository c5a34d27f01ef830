"""`python -m linevis_tpu_torch`, the viewer app and the performance
measurer on the CPU (`--device cpu`).

The five commands mirror tests/test_cli.py (datasets, render, render's
fallback, replay, perf) plus `view`; each output is held against the port's
own registry, which tests/test_torch_registry.py holds against JAX: the
rendered PNG byte for byte `save_png` of the registry's in-process frame,
the viewer's `/frame` byte for byte `LineVisApp.frame_png`. Without
`--device` the commands draw on the card, so here they raise: nothing falls
back to the CPU. The measurer's CSV columns and test-mode matrices equal
JAX's, and a triangle-mesh dataset (no capsule scene) leaves the three
depth-complexity cells blank while a line dataset fills them.
"""

import csv
import json
import os
import queue
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from linevis_tpu.automation import perf as jperf
from linevis_tpu_torch import app as tapp
from linevis_tpu_torch.__main__ import main
from linevis_tpu_torch.automation import perf as tperf
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.entry import displaced_icosphere, write_binary_stl
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import save_png
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.scene.factory import load_line_data

torch.set_num_threads(1)

W, H = 48, 32


def _write_obj(path, rng, n_lines=3, n_pts=6):
    # tests/test_cli.py:_write_obj
    lines = []
    with open(path, "w") as f:
        for _ in range(n_lines):
            pts = np.cumsum(rng.normal(0, 0.08, (n_pts, 3)), axis=0)
            pts -= pts.mean(axis=0)
            start = len(lines) + 1
            for p in pts:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
                lines.append(p)
            for p in pts:
                f.write(f"vt {rng.uniform():.4f}\n")
            idx = " ".join(str(start + i) for i in range(n_pts))
            f.write(f"l {idx}\n")


@pytest.fixture
def registry(tmp_path):
    _write_obj(str(tmp_path / "mini.obj"), np.random.default_rng(12345))
    write_binary_stl(str(tmp_path / "ball.stl"), displaced_icosphere(1))
    reg = tmp_path / "datasets.json"
    reg.write_text(json.dumps({"datasets": [
        {"name": "mini", "filenames": "mini.obj", "linewidth": 0.01},
        {"name": "ball", "filenames": "ball.stl", "type": "triangle_mesh"},
    ]}))
    return str(reg)


def _mini(registry):
    from linevis_tpu_torch.loaders.dataset_list import load_dataset_list

    leaf = {x.name: x for x in load_dataset_list(registry).flat_leaves()}["mini"]
    return load_line_data(leaf, base_dir=os.path.dirname(registry))


def test_cli_datasets_and_render_equal_the_registry(tmp_path, registry, capsys):
    assert main(["datasets", registry]) == 0
    out = capsys.readouterr().out
    assert "mini" in out and "mini.obj" in out and "ball" in out
    png = str(tmp_path / "frame.png")
    args = ["render", "mini", "--datasets-json", registry,
            "--renderer", "Multi-Layer Alpha Blending",
            "--set", "opacity=0.5", "--set", "depth_cue_strength=0.2",
            "--camera-position", "0", "0.1", "1.3", "--width", str(W), "--height", str(H),
            "-o", png]
    assert main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith(f"{W}x{H}, cpu]")
    r = create_renderer("Multi-Layer Alpha Blending",
                        SettingsMap({"opacity": "0.5", "depth_cue_strength": "0.2"}),
                        device="cpu")
    r.set_line_data(_mini(registry))
    save_png(str(tmp_path / "direct.png"),
             r.render(Camera(position=(0.0, 0.1, 1.3), width=W, height=H)))
    with open(png, "rb") as a, open(tmp_path / "direct.png", "rb") as b:
        assert a.read() == b.read()
    # The default device is the card: here that raises, and nothing is written.
    os.remove(png)
    with pytest.raises((AssertionError, RuntimeError)):
        main(args)
    assert not os.path.exists(png)


def test_cli_render_unknown_mode_falls_back_to_opaque(tmp_path, registry):
    png = str(tmp_path / "fb.png")
    with pytest.warns(UserWarning, match="falling back to Opaque"):
        rc = main(["render", "mini", "--datasets-json", registry, "--renderer", "No Such Mode",
                   "--width", "16", "--height", "8", "-o", png, "--device", "cpu"])
    assert rc == 0 and os.path.exists(png)


def test_cli_replay(tmp_path, registry, capsys):
    script = tmp_path / "replay.py"
    script.write_text(
        'g.set_dataset("mini")\n'
        'g.set_renderer("Opaque")\n'
        "g.set_camera_position(0.0, 0.0, 1.4)\n"
        "g.set_duration(0.4)\n"
        "g.set_camera_position(0.2, 0.1, 1.3)\n"
        'g.save_screenshot("cli_replay.png")\n'
    )
    rc = main(["replay", str(script), "--datasets-json", registry, "--fps", "5",
               "--output-dir", str(tmp_path), "--width", "16", "--height", "8",
               "--final-frames-only", "--device", "cpu"])
    assert rc == 0 and (tmp_path / "cli_replay.png").exists()
    assert "replay done: 2 frames" in capsys.readouterr().out


def test_cli_perf_filtered(tmp_path, registry):
    csv_path = str(tmp_path / "perf.csv")
    frames_csv = str(tmp_path / "frames.csv")
    rc = main(["perf", "mini", "--datasets-json", registry, "--oit", "--mode-filter", "Opaque",
               "--csv", csv_path, "--per-frame-csv", frames_csv, "--flight-seconds", "0.4",
               "--fps", "5", "--width", str(W), "--height", str(H), "--device", "cpu"])
    assert rc == 0
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert [r["State Name"] for r in rows] == ["Opaque"]
    assert float(rows[0]["Average FPS"]) > 0 and rows[0]["Device Name"] == "cpu"
    assert int(rows[0]["Total Fragments"]) > 0
    with open(frames_csv) as f:
        assert [r["frame"] for r in csv.DictReader(f)] == ["1"]


def test_measurer_columns_modes_and_blank_cells_for_a_mesh(tmp_path, registry):
    assert tperf.AutomaticPerformanceMeasurer.CSV_COLUMNS == \
        jperf.AutomaticPerformanceMeasurer.CSV_COLUMNS

    def key(s):
        st = s.renderer_settings
        return (s.name, s.dataset, s.rendering_mode, s.window_size,
                None if st is None else sorted((k, str(v)) for k, v in st.items()))

    for name in ("get_test_modes", "get_test_modes_oit"):
        t, j = getattr(tperf, name)("d", (64, 32)), getattr(jperf, name)("d", (64, 32))
        assert [key(s) for s in t] == [key(s) for s in j]
    assert len(tperf.get_test_modes("d")) == 15
    for a in (0.0, 3.0, 11.5):
        assert tperf.circle_flight(a) == jperf.circle_flight(a)

    base = os.path.dirname(registry)
    data = {"mini": _mini(registry), "ball": load_line_data(os.path.join(base, "ball.stl"))}
    states = [tperf.InternalState(name="ball", dataset="ball",
                                  rendering_mode="Opaque (Triangle Mesh)", window_size=(16, 8)),
              tperf.InternalState(name="mini", dataset="mini", rendering_mode="Opaque",
                                  window_size=(W, H))]
    m = tperf.AutomaticPerformanceMeasurer(states, data.__getitem__,
                                           csv_path=str(tmp_path / "p.csv"),
                                           flight_seconds=0.3, fps_target=10.0, device="cpu")
    assert m.device_name == "cpu"
    ball, mini = m.run()
    assert [ball[c] for c in ("Avg Depth Complexity", "Max Depth Complexity",
                              "Total Fragments")] == ["", "", ""]
    assert ball["Frames"] == 2 and ball["Dataset Buffer Size (GiB)"] > 0
    assert mini["Max Depth Complexity"] >= 1 and mini["Total Fragments"] > 0
    with open(tmp_path / "p.csv") as f:
        assert list(csv.DictReader(f))[0]["Total Fragments"] == ""


def _app(registry):
    return tapp.LineVisApp(_mini(registry), width=W, height=H, device="cpu")


def test_app_render_frame_and_png(registry):
    app = _app(registry)
    img = app.render_frame(0.5, 0.2, 2.0)
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    assert app._renderer("Opaque") is app._renderer("Opaque")
    assert app._renderer("Opaque").device.type == "cpu"
    png = app.frame_png(0.5, 0.2, 2.0)
    assert png[:4] == b"\x89PNG"


def test_app_server_on_port_zero(registry):
    app = _app(registry)
    srv = tapp.make_server(app, 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        assert b"linevis_tpu_torch" in urllib.request.urlopen(base + "/", timeout=10).read()
        modes = json.loads(urllib.request.urlopen(base + "/modes", timeout=10).read())
        assert "Opaque" in modes and len(modes) >= 19
        png = urllib.request.urlopen(base + "/frame?yaw=0.4&pitch=0.2&dist=2.0",
                                     timeout=120).read()
        assert png == app.frame_png(0.4, 0.2, 2.0)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/frame?yaw=x", timeout=10)
        assert e.value.code == 500
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_cli_view_serves_frames(registry, monkeypatch):
    """`view` on port 0: the server it starts answers /frame with the app's
    own PNG, and the command returns once the server is shut down."""
    servers = queue.Queue()
    make = tapp.make_server

    def recording(app, port):
        srv = make(app, port)
        servers.put((app, srv))
        return srv

    monkeypatch.setattr(tapp, "make_server", recording)
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(main(
        ["view", "mini", "--datasets-json", registry, "--port", "0", "--width", str(W),
         "--height", str(H), "--device", "cpu"])), daemon=True)
    t.start()
    app, srv = servers.get(timeout=60)
    try:
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/frame?yaw=0.3&pitch=0.1&dist=2.2",
            timeout=120).read()
        assert app.device == "cpu" and png == app.frame_png(0.3, 0.1, 2.2)
    finally:
        srv.shutdown()
        t.join(timeout=10)
    assert not t.is_alive() and rcs == [0]
