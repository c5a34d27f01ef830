"""The span and counter readers (`metrics/_spans.py` and the metrics that
read it) on hand-built runs and hand-built program records, on the CPU."""

from __future__ import annotations

import pytest

from linebench.devtrace import DeviceTrace
from linebench.metrics import (
    ao_sort_waste_pct,
    device_wait_ms,
    handback_ms,
    idle_unnamed_pct,
    issue_ms,
)
from linevis_tpu_torch.automation import profiling
from linevis_tpu_torch.automation.profiling import Span

MS = 1_000_000  # ns
UNNAMED = "host, outside PyTorch operations"
SPAN_METRICS = (issue_ms, device_wait_ms, handback_ms)


def _frame(fid, t0, ids, wait=2, copy=3, host=5, stages=20):
    """One frame's spans, `ids` its span ids: stages, the three hand-back
    spans in turn, then the frame that holds them."""
    f, *kids = ids
    rows, t = [], t0
    for i, (name, ms) in enumerate((("stage", stages), ("handback.wait", wait),
                                    ("handback.copy", copy), ("handback.host", host))):
        rows.append(Span(kids[i], name, f, fid, t, t + ms * MS, ms * MS))
        t += ms * MS
    rows.append(Span(f, "frame", None, fid, t0, t + MS, MS))
    return rows


def _run(frames=2, busy=0.5, gaps=((UNNAMED, 0.1), ("handback.host", 0.3))):
    return {"trace": DeviceTrace(1.0, frames, {"k": busy}, busy, 0.0, list(gaps)),
            "frames": frames, "counts": {}, "scene_s": 0.0, "kernels": {}}


@pytest.fixture
def records(monkeypatch):
    """Hands the readers `box["records"]` as the program's records()."""
    box = {"records": {"spans": [], "counts": {}}}
    monkeypatch.setattr(profiling, "records", lambda: box["records"])
    return box


def test_span_readers_on_hand_built_frames(records):
    spans = _frame(7, 0, range(0, 5)) + _frame(8, 100 * MS, range(5, 10), wait=4, host=9)
    records["records"] = {"spans": spans, "counts": {}}
    run = _run()
    # Frames of 31 and 37 ms: issue 21 a frame, waits 2 and 4, copy 3 and
    # host work 5 and 9.
    assert issue_ms.read(run) == pytest.approx(21.0)
    assert device_wait_ms.read(run) == pytest.approx(3.0)
    assert handback_ms.read(run) == pytest.approx(10.0)
    total = sum(m.read(run) for m in SPAN_METRICS)
    assert total == pytest.approx((31 + 37) / 2)


def test_span_readers_take_the_windows_frames_only(records):
    early = _frame(1, 0, range(0, 5), host=500)  # a frame before the window
    window = _frame(2, 900 * MS, range(5, 10)) + _frame(3, 1000 * MS, range(10, 15))
    records["records"] = {"spans": early + window, "counts": {}}
    assert handback_ms.read(_run()) == pytest.approx(8.0)
    # Fewer recorded frames than the window's: nothing to read.
    records["records"] = {"spans": window[:5], "counts": {}}
    assert all(m.read(_run()) is None for m in SPAN_METRICS)


def test_a_nested_frame_is_not_counted_twice(records):
    spans = _frame(4, 0, range(0, 5))
    outer = spans[-1]
    spans.insert(0, Span(99, "frame", outer.id, 4, MS, 2 * MS, MS))
    records["records"] = {"spans": spans, "counts": {}}
    assert issue_ms.read(_run(frames=1)) == pytest.approx(21.0)


def test_idle_unnamed_share():
    assert idle_unnamed_pct.read(_run()) == pytest.approx(25.0)
    assert idle_unnamed_pct.read(_run(gaps=(("frame", 0.2),))) == 0.0
    assert idle_unnamed_pct.read(_run(gaps=())) is None


def test_ao_sort_waste(records):
    records["records"] = {"spans": [], "counts": {"ao.pairs_sorted": 66_355_200,
                                                  "ao.pairs_kept": 1_858_000}}
    assert ao_sort_waste_pct.read(_run()) == pytest.approx(
        100.0 * (66_355_200 - 1_858_000) / 66_355_200)
    records["records"] = {"spans": [], "counts": {}}
    assert ao_sort_waste_pct.read(_run()) is None


def test_nothing_is_read_from_an_untraced_run(records):
    records["records"] = {"spans": _frame(1, 0, range(5)) + _frame(2, 50 * MS, range(5, 10)),
                          "counts": {"ao.pairs_sorted": 8, "ao.pairs_kept": 1}}
    run = _run(busy=0.0)
    for m in SPAN_METRICS + (idle_unnamed_pct, ao_sort_waste_pct):
        assert m.read(run) is None


def test_a_program_without_records_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "records")
    run = _run()
    for m in SPAN_METRICS + (ao_sort_waste_pct,):
        assert m.read(run) is None
