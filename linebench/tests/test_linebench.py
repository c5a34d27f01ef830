"""Tests of the benchmark harness, on the CPU at small sizes (the program
runs its plain versions there), and one card test.

    python -m pytest linebench/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from linebench import catalog, peaks
from linebench.run import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("tornado.rtao.flight-1080p", "tornado.opaque-triangle.flight-1080p")
# Small enough for the program's plain versions on the CPU; lines thick
# enough to cover many pixels. No warm-up beyond the two frames a run
# always draws.
SMALL = {"config": {"num_seeds": 96, "max_steps": 160, "line_width": 0.02},
         "traffic": {"width": 96, "height": 54, "check_rows": 6, "warmup_seconds": 0}}
BANNED = ("jax", "jaxlib", "flax", "linevis_tpu")


def _benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_catalog_finds_every_part_by_name():
    bench = _benchmark()
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell.config is not None and cell.traffic is not None
        assert w["config"] == catalog._json("workloads", w["name"])["config"]
        assert w["traffic"] == catalog._json("workloads", w["name"])["traffic"]
        assert catalog.inputs_maker(cell.config) is not None
        assert hasattr(catalog.reference(cell.traffic), "check")
        assert set(cell.limits) == {"mismatch_share"}
        assert set(cell.end_to_end) == {m["name"] for m in bench["end_to_end"]
                                        if w["name"] in m.get("workloads", [w["name"]])}
    for c in bench["configs"]:
        assert c["file"] == f"linebench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    kernels = catalog.kernels()
    assert {"ao_grid", "vpt_tracking", "raster_triangle"} <= set(kernels)
    for k in kernels.values():
        assert os.path.exists(os.path.join(ROOT, k["source"]))
    metrics = catalog.metrics()
    assert {m["name"] for m in bench["per_layer"]} == set(metrics)
    for m in bench["per_layer"]:
        assert metrics[m["name"]].UNIT == m["unit"]


def test_roofline_arithmetic_on_a_hand_count():
    # 1e9 integer operations at 33.4541e12/s plus 6.7e9 float operations at
    # 67e12/s: 29.892 us + 100 us; 1e8 bytes at 3.35e12 B/s: 29.85 us.
    ms = peaks.least_ms(int_ops=1e9, float_ops=6.7e9, nbytes=1e8)
    assert ms == pytest.approx((1e9 / (132 * 128 * 1.98e9) + 0.1e-3) * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.1298918, rel=1e-6)
    assert peaks.least_ms(nbytes=3.35e12) == pytest.approx(1e3)
    from linebench.devtrace import DeviceTrace
    from linebench.metrics import ao_grid_roofline

    run = {"trace": DeviceTrace(1.0, 10, {"ao_kernel(float const*)": 0.01}, 0.5, 0.0, []),
           "frames": 10, "kernels": catalog.kernels(),
           "counts": {"ao_tests": 1e6, "ao_roots": [1e5, 0.0, 0.0], "ao_rays": 0.0,
                      "ao_records": 0.0}}
    # (1e6 x 62 + 1e5 x 12) / 67e12 s = 0.9433 us against 1 ms a frame.
    assert ao_grid_roofline.read(run) == pytest.approx(100 * 63.2e6 / 67e12 / 1e-3, rel=1e-9)
    run["trace"] = DeviceTrace(1.0, 10, {"vpt_kernel<0>(float const*)": 0.01}, 0.5, 0.0, [])
    assert ao_grid_roofline.read(run) is None


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import sys, linebench.run, linebench.control, linebench.catalog, linebench.devtrace\n"
            "from linebench import catalog\n"
            "for w in catalog.names('workloads', '.json'):\n"
            "    c = catalog.cell(w); catalog.reference(c.traffic); catalog.inputs_maker(c.config)\n"
            "catalog.metrics()\n"
            "import linevis_tpu_torch.render.renderer\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & set(BANNED)


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "linebench", "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref_dir, f)):
                assert name.split(".")[0] not in ("linevis_tpu_torch",) + BANNED, (f, name)
    code = ("import sys, importlib, os\n"
            "for f in sorted(os.listdir('linebench/reference')):\n"
            "    f.endswith('.py') and importlib.import_module('linebench.reference.' + f[:-3])\n"
            "print([m for m in sys.modules if m.split('.')[0] == 'linevis_tpu_torch'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_the_allocator_thresholds_hold():
    code = "from linebench.run import fix_malloc_thresholds; fix_malloc_thresholds(); print('held')"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "held"


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    r = run_cell("tornado.rtao.flight-1080p", 2**31 + 17, 0.2, trace, device="cpu",
                 overrides=SMALL)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(r["metrics"]) == {"scene_s"}  # nothing on a device to read on the CPU
    else:
        assert set(r["metrics"]) == set(catalog.cell("tornado.rtao.flight-1080p").end_to_end)
        assert set(r["metrics"]) <= {"frame_ms", "frame_ms_p95", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_lower_precision_fails_the_check(cell):
    r = run_cell(cell, 90210, 0.1, False, device="cpu", overrides=SMALL,
                 control=torch.bfloat16)
    limit = catalog.cell(cell).limits["mismatch_share"]
    assert r["checks"]["mismatch_share"]["value"] <= limit
    assert r["control"]["mismatch_share"] > limit


class _Fault:
    """The registry's renderer with a fault planted where its image is
    produced: the state left as it was (the last frame's image returned),
    or every pixel's answer altered."""

    def __init__(self, renderer, kind):
        self.renderer, self.kind, self.prev = renderer, kind, None

    def render(self, camera):
        img = self.renderer.render(camera)
        out = img
        if self.kind == "state_unchanged" and self.prev is not None:
            out = self.prev
        elif self.kind == "answer_altered":
            out = img.copy()
            out[..., 0] += np.float32(2.0 / 255.0)
        self.prev = img
        return out


def _half_the_samples(cell, monkeypatch):
    """Half of each pixel's samples left out, the mean taken over the rest:
    2 of RTAO's 4 AO rays, 1 of the triangle frame's 2x2 supersamples."""
    import dataclasses

    if ".rtao." in cell:
        from linevis_tpu_torch.render import rtao

        half = dataclasses.make_dataclass("Half", [("num_samples", int, 2)],
                                          bases=(rtao.RtaoSettings,), frozen=True)
        monkeypatch.setattr(rtao, "RtaoSettings", half)
        return None
    from linevis_tpu_torch.render import opaque

    full = opaque.render_opaque_image
    monkeypatch.setattr(opaque, "render_opaque_image",
                        lambda *a, **k: full(*a, **{**k, "supersample": 1}))
    return None


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(cell, kind, monkeypatch):
    if kind == "half_left_out":
        wrap = _half_the_samples(cell, monkeypatch)
    else:
        def wrap(rd):
            return _Fault(rd, kind)
    r = run_cell(cell, 4242, 0.1, False, device="cpu", overrides=SMALL,
                 wrap_renderer=wrap)
    assert r["correct"] is False, r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    r = run_cell("tornado.rtao.flight-1080p", 2**31 + 5, 1.0, False)
    assert r["correct"] and r["device"]["platform"] == "gpu"
