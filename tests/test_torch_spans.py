"""The port's in-program spans and counters (`automation/profiling.py`) on
the CPU at small sizes: nothing recorded without a profiler, the frame's
spans and their nesting under one, the AO pair counters against an
independent count, images equal with tracing on and off, and the image
hand-back (`render/handback.py`) against the numpy form it replaced.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from linevis_tpu_torch.automation import profiling
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.entry import tornado_trajectories
from linevis_tpu_torch.kernels import ao_grid
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.scene.line_data import LineData

W, H = 48, 32
CAMERA = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
HANDBACK = ("handback.wait", "handback.copy", "handback.host")
# The cells' modes and the stage spans each frame holds under `frame`.
# Longer stages hold spans of their parts (a run of one name listed once),
# so that a gap on the device lies few host events after the start of the
# span that covers it.
PARTS = {
    "rtao.gbuffer": ["capsule.project", "capsule.payload", "bin.window", "bin.cull", "bin.sort",
                     "capsule.derive", "capsule.raster", "rtao.unpack", "rtao.surface"],
    "rtao.shade": ["rtao.light", "tf.segment", "rtao.composite"],
}
MODES = {
    "rtao": ("RTAO", {}, ("rtao.gbuffer", "rtao.samples", "rtao.rays", "ao.pairs", "ao.trace",
                          "ao.scatter", "rtao.shade") + HANDBACK),
    "triangle": ("Opaque", {"tubeGeometry": "triangle"},
                 ("opaque.vertex", "opaque.payload", "opaque.bin", "opaque.raster",
                  "opaque.untile", "opaque.shade") + HANDBACK),
}


@pytest.fixture(scope="module")
def line_data():
    ld = LineData(tornado_trajectories("cpu", num_seeds=24, max_steps=60))
    ld.set_line_width(0.02)
    return ld


def _renderer(mode, line_data):
    name, settings, _ = MODES[mode]
    r = create_renderer(name, SettingsMap(settings), device="cpu")
    r.set_line_data(line_data)
    return r


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_nothing_is_recorded_without_a_profiler(line_data):
    profiling.reset()
    assert not profiling.tracing()
    assert profiling.span("frame") is profiling.span("ao.pairs")  # the shared no-op
    for mode in MODES:
        _renderer(mode, line_data).render(CAMERA)
    profiling.count("ao.pairs_sorted", 5)
    assert profiling.records() == {"spans": [], "counts": {}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_traced_frame_nests_its_stage_spans(mode, line_data):
    r = _renderer(mode, line_data)
    r.render(CAMERA)  # builds what the first frame builds
    profiling.reset()
    _, prof = _profiled(lambda: r.render(CAMERA))
    rec = profiling.records()
    frames = [s for s in rec["spans"] if s.name == "frame"]
    assert len(frames) == 1 and frames[0].parent is None and frames[0].frame is not None
    frame = frames[0]
    by_id = {s.id: s for s in rec["spans"]}

    def children(span):
        return [s.name for s in sorted(rec["spans"], key=lambda s: s.start_ns)
                if s.parent == span.id]

    assert children(frame) == list(MODES[mode][2])
    for s in rec["spans"]:
        assert s.frame == frame.frame
        if s is not frame:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
            parts = PARTS.get(up.name)
            assert up is frame or (parts and s.name in parts), (up.name, s.name)
    for s in rec["spans"]:
        if s.name in PARTS:
            names = children(s)
            assert [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n] == PARTS[s.name]
    # Self times add up to the frame's duration.
    assert sum(s.self_ns for s in rec["spans"]) == frame.end_ns - frame.start_ns
    assert all(s.self_ns >= 0 for s in rec["spans"])
    # Each span is an ordinary host event of the profiler's timeline.
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    for name in {s.name for s in rec["spans"]}:
        assert len(events[name]) == sum(s.name == name for s in rec["spans"]), name
        for e in events[name]:
            assert e.is_user_annotation is False
            assert e.device_type == torch.autograd.DeviceType.CPU


def test_frames_get_their_own_ids(line_data):
    r = _renderer("triangle", line_data)
    profiling.reset()
    _profiled(lambda: [r.render(CAMERA) for _ in range(2)])
    spans = profiling.records()["spans"]
    ids = sorted({s.frame for s in spans})
    assert len(ids) == 2
    for f in ids:
        assert sorted(s.name for s in spans if s.frame == f) == sorted(
            ("frame",) + MODES["triangle"][2])


def test_ao_pair_counters_match_an_independent_count(line_data, monkeypatch):
    r = _renderer("rtao", line_data)
    r.render(CAMERA)
    seen = []
    expand = ao_grid.expand_ray_pairs

    def kept_by_hand(origins, dirs, t_max, valid, grid, max_ray_cells=8):
        pairs = expand(origins, dirs, t_max, valid, grid, max_ray_cells)
        seen.append((origins.shape[1], max_ray_cells,
                     int((pairs.keys < grid.resolution ** 3).sum())))
        return pairs

    monkeypatch.setattr(ao_grid, "expand_ray_pairs", kept_by_hand)
    profiling.reset()
    _profiled(lambda: r.render(CAMERA.orbit(0.01, 0.1, 1.2)))
    counts = profiling.records()["counts"]
    rays = sum(n for n, _, _ in seen)
    assert rays == 4 * W * H and all(m == 8 for _, m, _ in seen)
    assert counts["ao.pairs_sorted"] == 8 * rays
    assert counts["ao.pairs_kept"] == sum(k for _, _, k in seen)
    assert 0 < counts["ao.pairs_kept"] < counts["ao.pairs_sorted"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_images_are_equal_with_tracing_on_and_off(mode, line_data):
    off = _renderer(mode, line_data).render(CAMERA)
    on, _ = _profiled(lambda: _renderer(mode, line_data).render(CAMERA))
    assert on.dtype == off.dtype and on.shape == off.shape
    assert np.array_equal(on, off)


@pytest.mark.parametrize("supersample", [1, 2, 3])
@pytest.mark.parametrize("channels_first", [True, False])
def test_hand_back_equals_the_numpy_form(supersample, channels_first):
    g = torch.Generator().manual_seed(supersample)
    img = torch.rand((4, H * supersample, W * supersample), generator=g)
    if not channels_first:
        img = img.permute(1, 2, 0).contiguous()
    want = img.cpu().numpy()
    if channels_first:
        want = np.moveaxis(want, 0, -1)
    if supersample > 1:
        k = supersample
        want = want.reshape(H, k, W, k, 4).mean(axis=(1, 3))
    got = hand_back(img, supersample, channels_first=channels_first)
    assert got.dtype == np.float32 and got.shape == (H, W, 4)
    assert np.array_equal(got, want)


def test_concurrent_spans_and_counts_lose_nothing(monkeypatch):
    """Threads record spans and counts at once (as if each were traced):
    every span is kept with its own thread's parent, every add counted."""
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    rec = profiling.Recorder()
    threads, per = 16, 200
    errors = []

    def work():
        try:
            for _ in range(per):
                with rec.span("frame") as outer:
                    with rec.span("inner") as inner:
                        rec.count("adds", 1)
                    if inner._parent != outer._id:
                        errors.append((inner._parent, outer._id))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    out = rec.records()
    assert out["counts"] == {"adds": threads * per}
    spans = out["spans"]
    assert len(spans) == 2 * threads * per
    assert len({s.id for s in spans}) == len(spans)
    outer = {s.id: s for s in spans if s.name == "frame"}
    assert len({s.frame for s in outer.values()}) == threads * per
    for s in spans:
        if s.name == "inner":
            assert outer[s.parent].frame == s.frame
