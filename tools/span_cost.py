"""What the port's in-program spans and counters cost the host, per site.

A one-off script beside `chip_smoke.py`, not part of the port's package.
It times, on the host it runs on, each kind of site the frame path holds
(`automation/profiling.py`): a `span` block, a `count`, a `tracing()`
check and a call through a registered renderer's `frame` wrapper, each
against the same block without it, with no profiler recording (what every
untraced frame pays) and, for the span and the count, inside a CPU
profiler session (what a traced frame pays on the host besides the
profiler's own events). Prints one JSON line of ns per site.

    python3 tools/span_cost.py [--n 200000]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from linevis_tpu_torch.automation.profiling import count, span, tracing  # noqa: E402
from linevis_tpu_torch.render.renderer import _framed  # noqa: E402


def _ns_per_call(fn, n: int) -> float:
    """Least of 5 rounds of n calls, ns a call."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def _bare(n):
    for _ in range(n):
        pass


def _span(n):
    for _ in range(n):
        with span("ao.pairs"):
            pass


def _count(n):
    for _ in range(n):
        count("ao.pairs_sorted", 8)


def _check(n):
    for _ in range(n):
        if tracing():
            pass


def _noop(camera):
    return camera


_framed_noop = _framed(_noop)


def _call(n):
    for _ in range(n):
        _noop(None)


def _framed_call(n):
    for _ in range(n):
        _framed_noop(None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    n = ap.parse_args(argv).n
    bare, call = _ns_per_call(_bare, n), _ns_per_call(_call, n)
    out = {"host": platform.processor() or platform.machine(), "torch": torch.__version__,
           "off_ns": {"span": _ns_per_call(_span, n) - bare,
                      "count": _ns_per_call(_count, n) - bare,
                      "tracing_check": _ns_per_call(_check, n) - bare,
                      "frame_wrapper": _ns_per_call(_framed_call, n) - call}}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        m = max(n // 20, 1)
        bare = _ns_per_call(_bare, m)
        out["on_ns"] = {"span": _ns_per_call(_span, m) - bare,
                        "count": _ns_per_call(_count, m) - bare}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
