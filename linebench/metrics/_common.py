"""What the per-layer readers share: the traced window's device time a
frame, and the hand-written kernels' launch names."""

from __future__ import annotations


def traced(run) -> bool:
    """True where the window's trace holds device operations."""
    return run["trace"].busy_s > 0.0 and run["frames"] > 0


def ms_a_frame(run, seconds: float) -> float:
    return seconds / run["frames"] * 1e3


def handwritten_names(run):
    return [n for k in run["kernels"].values() for n in k["trace_names"]]


def kernel_ms(run, kernel: str):
    """Device ms a frame of one hand-written kernel; None where it did not
    run in the window."""
    if not traced(run):
        return None
    s = run["trace"].seconds_matching(run["kernels"][kernel]["trace_names"])
    return ms_a_frame(run, s) if s > 0.0 else None
