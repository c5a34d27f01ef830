"""Run one cell of the benchmark of `linevis_tpu_torch` once.

    python3 linebench/run.py --workload tornado.rtao.flight-1080p --seed 7 \\
        --seconds 45 --trace 0

A cell is a deployment (`configs/`) under a traffic mix (`traffic/`): one
interactive user who asks the registry for the next frame when the last one
has arrived. The run makes the deployment's inputs, hands them to the
program as a user's data, sets up the registry's renderer and warms it up
for the traffic's `warmup_seconds` on the 32 cameras before the flight's
start, then renders the camera flight for `--seconds` seconds: frame i
looks at the origin from radius R at height h and yaw start + i * step, and
ends when `render` has returned the image in host memory. The inputs and
the flight are the same whatever the seed, so that every seed asks for the
same work; the seed draws what the check compares. With `--trace 0` it reports the
cell's end-to-end metrics, with `--trace 1` the per-layer ones, read from a
profiler trace of the window. After the window it frees the program's
state and compares a frame drawn from the seed, and the first frame of the
warm-up, with the plain reference on rows drawn from the seed
(`reference/`). The last line of standard output is one JSON object:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}; the numbers compared, each beside its limit, are the last lines
of standard error too.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# Modules that may not be loaded in the process that prints a result: JAX
# and the JAX package (compared by whole top-level names).
BANNED = ("jax", "jaxlib", "flax", "linevis_tpu")
# A traced run profiles at most this much of its window: a profiler trace
# of a longer window takes longer to read than the run may last.
TRACE_WINDOW_S = 5.0


# The host allocator held where glibc's own rule settles in a process that
# frees a block of the program's per-frame host image (31.6 MiB at 1080p)
# again and again: the mmap threshold at its ceiling, 32 MiB, and the trim
# threshold at twice that. glibc reaches that state only after such a free,
# and leaves it for a while when other blocks come and go, so whether an
# image reuses the heap's pages or is mapped anew, page faults and all,
# depended on the order of earlier frees: a run switched between a fast and
# a slow mode for seconds at a time. Larger blocks (the 4K image, 133 MB)
# are mapped anew every frame either way.
MMAP_THRESHOLD = 32 << 20
TRIM_THRESHOLD = 64 << 20
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3  # mallopt's parameter numbers (malloc.h)


def fix_malloc_thresholds() -> None:
    import ctypes

    libc = ctypes.CDLL(None)
    if not hasattr(libc, "mallopt") or not (
            libc.mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD) == 1
            and libc.mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD) == 1):
        raise RuntimeError("linebench: cannot hold the allocator's thresholds (glibc's "
                           "mallopt is needed)")


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


# Warm-up frames walk the WARM_CAMERAS cameras that precede the flight's
# start, over and over, so that the window draws the same cameras whatever
# the warm-up managed.
WARM_CAMERAS = 32


@dataclasses.dataclass
class CheckedFrame:
    position: tuple
    image: object  # numpy [H, W, 4] as the program returned it


@dataclasses.dataclass
class CheckContext:
    device: object
    inputs: object
    width: int
    height: int
    rows: int
    frames: List[CheckedFrame]
    rng: object


def flight_position(flight: dict, i: int):
    yaw = flight["start_yaw"] + i * flight["yaw_step"]
    r = flight["radius"]
    return (r * math.sin(yaw), flight["height"], r * math.cos(yaw))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None,
             wrap_renderer: Optional[Callable] = None, t0: float = _T0,
             control=None) -> dict:
    """One run of a cell -> the result object. `overrides` ({"config": {...},
    "traffic": {...}}) resize a cell (tests on the CPU); `wrap_renderer`
    replaces the renderer the window drives (tests that plant a fault);
    `control`, a dtype, also reads the numbers compared with the reference
    computed in that precision in the program's place (`control.py`)."""
    import numpy as np
    import torch

    from linebench import catalog, devtrace
    from linevis_tpu_torch.core.settings import SettingsMap
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.renderer import create_renderer

    cell = catalog.cell(workload)
    config = {**cell.config, **(overrides or {}).get("config", {})}
    traffic = {**cell.traffic, **(overrides or {}).get("traffic", {})}
    W, H = int(traffic["width"]), int(traffic["height"])
    flight = traffic["flight"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    check_rng = np.random.default_rng(int(seed))
    workdir = tempfile.mkdtemp(prefix="linebench-")
    inputs = catalog.inputs_maker(config)(config, workdir, device=device)

    t_scene = time.perf_counter()
    renderer = create_renderer(traffic["mode"], SettingsMap(traffic.get("settings") or {}),
                               device=device)
    inputs.load(renderer)
    inputs.prepare(renderer, traffic["mode"])
    sync()
    scene_s = time.perf_counter() - t_scene
    if wrap_renderer is not None:
        renderer = wrap_renderer(renderer)

    def camera(i):
        return Camera(position=flight_position(flight, i), width=W, height=H)

    # Warm up for warmup_seconds, at least two frames: the first frames of a
    # process run slower for seconds (allocators, caches, clocks).
    warm_s = float(traffic["warmup_seconds"])
    t_warm = time.perf_counter()
    k = 0
    while k < 2 or time.perf_counter() - t_warm < warm_s:
        i = k % WARM_CAMERAS - WARM_CAMERAS
        img = renderer.render(camera(i))
        if k == 0:
            first = CheckedFrame(flight_position(flight, i), img)
        k += 1
    sync()
    setup_s = time.perf_counter() - t0

    window = min(seconds, TRACE_WINDOW_S) if trace else seconds
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    # The window frame to check is copied into a buffer made beforehand: a
    # kept reference to the program's image would change where its next
    # images are allocated, and with that what they cost.
    times, kept = [], CheckedFrame(None, np.empty_like(first.image))
    t_win = time.perf_counter()
    i = 0
    while True:
        cam = camera(i)
        ts = time.perf_counter()
        img = renderer.render(cam)
        te = time.perf_counter()
        times.append(te - ts)
        if check_rng.random() * (i + 1) < 1.0:  # one frame of the window, each as likely
            kept.position = cam.position
            np.copyto(kept.image, img)
        i += 1
        if te - t_win >= window:
            break
    window_s = time.perf_counter() - t_win
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    n = len(times)
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": memory_peak}
    del renderer, img
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = catalog.reference(traffic)
    ctx = CheckContext(device=torch.device(device), inputs=inputs, width=W, height=H,
                       rows=int(traffic["check_rows"]),
                       frames=[first, kept], rng=check_rng)
    rng_state = copy.deepcopy(check_rng)
    t_ref = time.perf_counter()
    checked = ref.check(ctx)
    ref_s = time.perf_counter() - t_ref
    control_numbers = None
    if control is not None:
        ctx.rng = rng_state
        control_numbers = ref.check(ctx, control=control)["numbers"]
    inputs.cleanup()
    os.rmdir(workdir)
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in checked["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": n, "failed": 0}
    if not trace:
        ms = np.asarray(times) * 1e3
        metrics = {
            "frame_ms": {"value": window_s * 1e3 / n, "unit": "ms"},
            "frame_ms_p95": {"value": float(np.percentile(ms, 95)), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["metrics"] = {k: metrics[k] for k in cell.end_to_end}
        result["device"] = dev_info
    else:
        dt = (devtrace.reduce(prof, window_s, n) if on_card else
              devtrace.DeviceTrace(window_s, n, {}, 0.0, 0.0, []))
        run = dict(trace=dt, frames=n, counts=checked.get("counts", {}), scene_s=scene_s,
                   kernels=catalog.kernels())
        metrics = {}
        for name, mod in catalog.metrics().items():
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
        result["metrics"] = metrics
        result["device"] = {**dev_info, "busy_s": dt.busy_s, "window_s": window_s}
        result["breakdown"] = devtrace.breakdown(dt)
    result["reference_s"] = ref_s
    if control_numbers is not None:
        result["control"] = control_numbers
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_malloc_thresholds()
    # Kernel caches stay inside the checkout, at fixed paths.
    cache = os.path.join(_ROOT, ".linebench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))

    import torch

    from linebench import catalog

    if not torch.cuda.is_available():
        print("linebench: no CUDA device", file=sys.stderr)
        return 2
    chips = catalog.cell(args.workload).chips
    if torch.cuda.device_count() < chips:
        print(f"linebench: the cell needs {chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = banned_modules()
    if bad:
        print(f"linebench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
