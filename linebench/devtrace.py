"""Reduce a `torch.profiler` trace of the measured window to what the
per-layer metrics read: device time by operation name, the union of the
device's busy intervals, the copies to the host, and the idle gaps labelled
by the host operation that was running.

The arithmetic of the device's busy time follows the port's
`automation/profiling.py:device_summary` (kernel and copy time against a
host window that ends when the last frame's image is on the host), with the
busy time taken as the union of intervals so that overlapping copies and
kernels count once.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    frames: int
    by_name: Dict[str, float]  # seconds of device time by operation name
    busy_s: float
    dtoh_s: float  # copies to the host
    idle_by_host_op: List[Tuple[str, float]]

    def seconds_matching(self, patterns) -> float:
        rx = [re.compile(rf"(^|[^A-Za-z0-9_]){re.escape(p)}([^A-Za-z0-9_]|$)") for p in patterns]
        return sum(s for n, s in self.by_name.items() if any(r.search(n) for r in rx))


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def reduce(prof, window_s: float, frames: int) -> DeviceTrace:
    by_name = defaultdict(float)
    dev, host = [], []
    dtoh = 0.0
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s = tr.elapsed_us() / 1e6
            by_name[e.name] += s
            dev.append((tr.start, tr.end))
            if e.name.startswith("Memcpy DtoH"):
                dtoh += s
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    merged = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for length, g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "host, outside PyTorch operations"
        i = bisect.bisect_right(starts, mid)
        # The operation that started last among those running at the gap.
        for _, t, name in reversed(host[max(0, i - 200):i]):
            if t >= mid:
                label = name
                break
        idle[label] += length / 1e6
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    return DeviceTrace(window_s=window_s, frames=frames, by_name=dict(by_name), busy_s=busy,
                       dtoh_s=dtoh, idle_by_host_op=ranked)


def breakdown(t: DeviceTrace, top: int = 10) -> dict:
    ops = sorted(t.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in t.idle_by_host_op[:top]]}


def is_kernel(name: str) -> bool:
    return not _is_copy(name)
