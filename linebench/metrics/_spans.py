"""What the span and counter readers share: the program's own records of
the traced window (`linevis_tpu_torch/automation/profiling.py:records`),
read in the run's process after the window. A program that records no
spans or counters (one older than them) gives nothing to read."""

from __future__ import annotations

from collections import defaultdict

from linebench.metrics._common import traced


def _records(run):
    if not traced(run):
        return None
    try:
        from linevis_tpu_torch.automation.profiling import records
    except ImportError:
        return None
    return records()


def span_seconds(run):
    """{span name: host seconds} summed over the spans of the window's
    frames (the last run["frames"] outermost `frame` spans and the spans
    inside them); None unless such spans cover every frame of the window."""
    rec = _records(run)
    if rec is None:
        return None
    frames = sorted({s.frame for s in rec["spans"] if s.name == "frame" and s.parent is None})
    window = set(frames[-run["frames"]:])
    if len(window) != run["frames"]:
        return None
    seconds = defaultdict(float)
    for s in rec["spans"]:
        if s.frame in window and (s.name != "frame" or s.parent is None):
            seconds[s.name] += (s.end_ns - s.start_ns) / 1e9
    return seconds


def counts(run):
    """The program's counter totals ({name: int}); None where the run is not
    traced or the program keeps no counters."""
    rec = _records(run)
    return None if rec is None else rec["counts"]
