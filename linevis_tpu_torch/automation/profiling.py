"""Profiling harness: torch.profiler traces, device-time summaries,
per-pass frame timers, and the spans and counters inside the frame.

Counterpart of `linevis_tpu/automation/profiling.py` (jax.profiler there).
`trace` records host ops and CUDA kernels and can write a Chrome/Perfetto
trace; `device_summary` turns a recording into the device's busy time, its
idle share of a host-timed window, and the kernels that take the time;
`FrameProfiler` times named passes, one CSV row per (frame, pass), on the
host clock and, for a pass on the card, also between CUDA events.

Spans and counters, placed in the program where the work happens, record
only while a `torch.profiler` session records (`tracing()`):

    with span("ao.pairs"):          # a stage of the frame
        ...
    count("ao.pairs_sorted", n)     # a host int, or a 0-d tensor summed on
                                    # its device without a sync
    rec = records()                 # {"spans": [Span, ...], "counts": {...}}
    reset()

With no profiler recording, `span` costs one check and returns a shared
no-op, and `count` returns after the same check: no clock read, no
`record_function`, no allocation. While one records, a span enters
`torch._C._profiler._RecordFunctionFast(name)`, an ordinary host event of
the profiler's timeline (not a user annotation, which kineto mirrors as
device-typed events), and keeps its name, start and end
(`time.perf_counter_ns`), its parent span and its frame: the id the
outermost `frame` span (`render/renderer.py:register_renderer` wraps every
mode's `render` in one) hands to every span inside it, on its thread.
`records()` gives each span's self time (its duration less the part its
children cover) and the counters' totals, reading device counters in one
transfer. The profiler records per thread, and so do spans and counters;
threads may record at once.

    python -m linevis_tpu_torch.automation.profiling [OUT_DIR [PATH]]

PATH: opaque|mlab|prism|triangle|rtao|wavefront|recast|mlat|wboit|depth_peeling|mlab_buckets|
      mboit|depth_complexity|opacity_optimization|rtao_registry|surface|vpt|vpt_decomposition|
      vpt_residual_ratio|density_map|heatmap|vrc|multivar|a name of entry.BASELINE_CONFIGS

profiles a tornado tube frame on the card at 1920x1080: `opaque` (the
default) the opaque capsule frame (`render_tubes`, tile 32x16, AA on),
`mlab` the transparent MLAB frame (`render_tubes_mlab`, tile 16x8, K=8,
opacity 0.3), `prism` the opaque 8-gon prism frame (`render_tubes_prism`,
tile 32x16), `triangle` the opaque triangle-tube frame (`render_opaque`, 8
subdivisions, tile 32x16), `rtao` the ray-traced ambient occlusion frame
(`render_tubes_rtao`, 4 rays per pixel, radius 0.1, grid 64^3, tile 32x16;
4 frames), `wavefront` the wavefront ray tracer's frame
(`render_tubes_raytraced_wavefront`, binned-SAH tree, tile 16x8, K=8,
opacity 0.3; 4 frames), `recast` and `mlat` the transparent ray tracer's
re-cast frame (`render_tubes_raytraced`, 32 casts) and MLAT frame
(`render_tubes_mlat`, K=8) over the linear tree, opacity 0.3 (4 frames
each), and the rest of the transparent family at tile 16x8
and opacity 0.3: `wboit` (`render_tubes_wboit`), `depth_peeling`
(`render_tubes_depth_peeling`, K=8, 4 passes), `mlab_buckets`
(`render_tubes_mlab_buckets`, K=8), `mboit` (`render_tubes_mboit`, 4 power
moments, float32) and `depth_complexity` (`render_depth_complexity`);
`opacity_optimization` the opacity-optimization frame
(`OpacityOptimizationRenderer.render`, default settings, tile 16x8: the
half-res importance gather, the plain solve and the final MLAB render; every
frame moves the camera, so every frame solves); `rtao_registry` the RTAO
frame as the renderer registry draws it (`create_renderer("RTAO")` on a
`LineData` of the tornado, the image handed back as numpy; the camera moves,
so no frames accumulate); `surface` a triangle-mesh dataset from a file
(`entry.sphere_mesh_data`: the displaced icosphere of 1,310,720 triangles
written as binary STL and loaded) through the registry's "Opaque (Triangle
Mesh)" (tile 16x8, the binning window sized per camera, the image handed
back as numpy); `vpt`, `density_map` and `heatmap` the scattering
modes through the registry on `entry.scattering_line_data` (the 512^3
procedural cloud traced at 40,960 paths, ~10 s of set-up first): the
"Volumetric Path Tracer" at its defaults accumulating at one camera (4
frames; `vpt_decomposition` and `vpt_residual_ratio` likewise in the
Decomposition and Residual Ratio tracking modes), the "Line Density Map Renderer" from the side the paths enter, the
"Spherical Heat Map Renderer" as a 1080x2160 map (4 frames); `vrc` the
tornado through "Voxel Ray Casting" (grid 128, quantization 8) and
`multivar` its multivariate tubes (the attribute and 1 - it, 8
subdivisions) through `render_opaque`; a name of `entry.BASELINE_CONFIGS` that reference
config through the registry at its own resolution, on its frames (an orbit
of cameras; config 3 accumulates at one camera, config 5 follows its circle
path; configs 4 and 4b draw the Femur-like stress lines). It runs 8 frames
(4 of the ray-traced paths: `rtao`, `wavefront`, `recast`, `mlat`,
`rtao_registry` and a config whose renderer is RTAO) after 2 warm-up frames, timed once without
the profiler (the window the idle share is taken against) and once
recorded, and prints one JSON line, with `spans` (self ms a frame by span
name) and `counts` (counter totals a frame) from the recorded frames; with
OUT_DIR (give "" for none) it also writes that line to
OUT_DIR/summary.json, the Chrome trace to OUT_DIR/tube_frames.json and
`records()` to OUT_DIR/records.json.
"""



from __future__ import annotations

import contextlib
import csv
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

__all__ = ["trace", "device_summary", "FrameProfiler", "Span", "Recorder", "tracing", "span",
           "count", "records", "reset"]


def tracing() -> bool:
    """True while a `torch.profiler` session records on this thread."""
    return _profiler_enabled()


class Span(NamedTuple):
    """One closed span: perf_counter_ns times; `parent` the id of the span
    that was open around it on its thread, `frame` the id of the outermost
    `frame` span around it (None outside any)."""

    id: int
    name: str
    parent: Optional[int]
    frame: Optional[int]
    start_ns: int
    end_ns: int
    self_ns: int  # end - start less the part the span's children cover


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("_rec", "_name", "_rf", "_id", "_parent", "_frame", "_t0")

    def __init__(self, rec, name):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        up = stack[-1] if stack else None
        self._parent = None if up is None else up._id
        self._frame = None if up is None else up._frame
        with rec._lock:
            self._id = next(rec._ids)
            if self._frame is None and self._name == "frame":
                self._frame = next(rec._frames)
        stack.append(self)
        self._rf = _RecordFunctionFast(self._name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._rf.__exit__(None, None, None)
        rec = self._rec
        rec._stack().pop()
        with rec._lock:
            rec._spans.append((self._id, self._name, self._parent, self._frame, self._t0, t1))
        return False


class Recorder:
    """Spans and counters of a process's traced frames (module docstring).
    The module's `span`, `count`, `records` and `reset` are one Recorder's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._frames = itertools.count()
        self._spans = []
        self._counts = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """Context manager timing the block as span `name` while tracing."""
        if not _profiler_enabled():
            return _NO_SPAN
        return _OpenSpan(self, name)

    def count(self, name: str, value) -> None:
        """Adds `value` (a host int, or a 0-d tensor, added on its device
        without a sync) to counter `name` while tracing."""
        if not _profiler_enabled():
            return
        with self._lock:
            prev = self._counts.get(name)
            self._counts[name] = value if prev is None else prev + value

    def records(self) -> dict:
        """{"spans": [Span, ...] in the order they closed, "counts": {name:
        int total}}; the device counters read in one transfer per device."""
        with self._lock:
            raw, counts = list(self._spans), dict(self._counts)
        covered = defaultdict(int)
        for _, _, parent, _, t0, t1 in raw:
            if parent is not None:
                covered[parent] += t1 - t0
        spans = [Span(i, n, p, f, t0, t1, t1 - t0 - covered[i]) for i, n, p, f, t0, t1 in raw]
        on_device = defaultdict(list)
        for k, v in counts.items():
            if isinstance(v, torch.Tensor):
                on_device[v.device].append(k)
        for keys in on_device.values():
            vals = torch.stack([counts[k].reshape(()).to(torch.int64) for k in keys]).tolist()
            counts.update(zip(keys, vals))
        return {"spans": spans, "counts": {k: int(v) for k, v in counts.items()}}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
records = _RECORDER.records
reset = _RECORDER.reset


@contextlib.contextmanager
def trace(path: str = None):
    """torch.profiler recording of CPU ops and CUDA kernels; with `path`,
    the Chrome trace is written there on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if path:
        prof.export_chrome_trace(path)


def device_summary(prof, wall_ms: float, top: int = 12) -> dict:
    """Busy time of the CUDA kernels in `prof` against a host window of
    `wall_ms` ending in a synchronize: {"wall_ms", "device_busy_ms",
    "idle_share", "kernels": [[name, ms, launches], ...], "host_ops":
    [[name, self ms on the host, calls], ...]}."""
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name[e.name]
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if wall_ms > 0 else None,
        "kernels": [[name, ms, n] for name, (ms, n) in ranked],
        "host_ops": [[a.key, a.self_cpu_time_total / 1e3, a.count] for a in sorted(
            prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:top]],
    }


class FrameProfiler:
    """Named pass timers (the reference's per-pass GPU timers feeding its
    perf CSVs, AutomaticPerformanceMeasurer.hpp:64-65,98).

        with prof.pass_("gather", force=tensor_on_the_card):
            out = kernel(...)

    `force`, a tensor, names the device the pass runs on. For a CUDA tensor
    the pass records a CUDA event on the current stream at its start and
    end, and on exit waits with `torch.cuda.synchronize`, so the host-clock
    "Time (ms)" includes the device work queued inside (as the JAX
    profiler's block on `force`); "Device Time (ms)" is the interval
    between the two events. A pass without a CUDA tensor is timed on the
    host alone and leaves the device column blank.
    """

    COLUMNS = ["Frame", "Pass", "Time (ms)", "Device Time (ms)"]

    def __init__(self):
        self.rows = []
        self.frame = 0

    @contextlib.contextmanager
    def pass_(self, name: str, force=None):
        dev = force.device if isinstance(force, torch.Tensor) and force.is_cuda else None
        events = None
        if dev is not None:
            with torch.cuda.device(dev):
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
        t0 = time.perf_counter()
        yield
        if dev is not None:
            with torch.cuda.device(dev):
                events[1].record()
            torch.cuda.synchronize(dev)
        host_ms = (time.perf_counter() - t0) * 1000.0
        self.rows.append({
            "Frame": self.frame,
            "Pass": name,
            "Time (ms)": host_ms,
            "Device Time (ms)": events[0].elapsed_time(events[1]) if events else "",
        })

    def next_frame(self) -> None:
        self.frame += 1

    def summary(self, column: str = "Time (ms)") -> dict:
        """Average ms per pass name of `column` ("Time (ms)" on the host,
        "Device Time (ms)" between the events; passes without it left out)."""
        acc = {}
        for r in self.rows:
            if r[column] != "":
                acc.setdefault(r["Pass"], []).append(r[column])
        return {k: sum(v) / len(v) for k, v in acc.items()}

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.COLUMNS)
            w.writeheader()
            w.writerows(self.rows)


def main(out_dir: str = None, path: str = "opaque") -> int:
    import subprocess
    from functools import partial

    from linevis_tpu_torch.entry import (
        BASELINE_CONFIGS,
        TORNADO_LINE_WIDTH,
        TORNADO_RADIUS,
        scattering_line_data,
        tornado_prism_scene,
        tornado_scene,
        tornado_segment_grid,
        tornado_trajectories,
        tornado_tube_mesh,
        tornado_wide_bvh,
        sphere_mesh_data,
    )
    from linevis_tpu_torch.core.settings import SettingsMap
    from linevis_tpu_torch.render import oit
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.opacity_optimization import OpacityOptimizationRenderer
    from linevis_tpu_torch.render.opaque import render_opaque
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.ops.lbvh import lbvh_on
    from linevis_tpu_torch.render.ray_tracer import (
        build_capsule_bvh,
        render_tubes_mlat,
        render_tubes_raytraced,
        render_tubes_raytraced_wavefront,
    )
    from linevis_tpu_torch.render.renderer import create_renderer
    from linevis_tpu_torch.render.rtao import RtaoSettings, render_tubes_rtao
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import (
        camera_tensors,
        render_tubes,
        render_tubes_prism,
    )
    from linevis_tpu_torch.scene.line_data import LineData

    oit_paths = {
        "mlab": ("render_tubes_mlab", dict(K=8, opacity=0.3)),
        "wboit": ("render_tubes_wboit", dict(opacity=0.3)),
        "depth_peeling": ("render_tubes_depth_peeling", dict(K=8, passes=4, opacity=0.3)),
        "mlab_buckets": ("render_tubes_mlab_buckets", dict(K=8, opacity=0.3)),
        "mboit": ("render_tubes_mboit", dict(n_mom=4, opacity=0.3)),
        "depth_complexity": ("render_depth_complexity", {}),
    }
    vpt_paths = {"vpt": {}, "vpt_decomposition": {"vpt_mode": "Decomposition Tracking"},
                 "vpt_residual_ratio": {"vpt_mode": "Residual Ratio Tracking"}}
    scattering = {**{k: ("Volumetric Path Tracer", v) for k, v in vpt_paths.items()},
                  "density_map": ("Line Density Map Renderer", {}),
                  "heatmap": ("Spherical Heat Map Renderer", {})}
    paths = ("opaque", "prism", "triangle", "rtao", "wavefront", "recast", "mlat", *oit_paths,
             "opacity_optimization", "rtao_registry", "surface", *scattering, "vrc", "multivar",
             *BASELINE_CONFIGS)
    # These take the Camera, the rest its tensors.
    takes_camera = ("opacity_optimization", "rtao_registry", "surface", *scattering, "vrc",
                    *BASELINE_CONFIGS)
    if path not in paths:
        raise SystemExit(f"profiling: unknown path {path!r} (one of {', '.join(paths)})")
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    W, H = 1920, 1080
    n = 4 if path in ("rtao", "wavefront", "recast", "mlat", "rtao_registry", *vpt_paths,
                      "heatmap") else 8
    base = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    cams = [base.orbit(0.002 * (i + 1), 0.1, 1.2) for i in range(n + 2)]
    wide = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    if path == "opaque":
        scene = tornado_scene(dev)
        render = partial(render_tubes, settings=wide)
    elif path in oit_paths:
        scene = tornado_scene(dev)
        name, kw = oit_paths[path]
        render = partial(getattr(oit, name),
                         settings=RasterSettings(width=W, height=H, tile_w=16, tile_h=8), **kw)
    elif path == "opacity_optimization":
        traj = tornado_trajectories(dev)
        scene = tornado_scene(dev, traj=traj)
        oo = OpacityOptimizationRenderer(
            scene, traj.num_lines, traj.max_points,
            RasterSettings(width=W, height=H, tile_w=16, tile_h=8))

        def render(_scene, camera):
            return oo.render(camera)
    elif path == "rtao_registry":
        scene = LineData(tornado_trajectories(dev))
        scene.set_line_width(2.0 * TORNADO_RADIUS)
        registry = create_renderer("RTAO", device=dev)
        registry.set_line_data(scene)

        def render(_scene, camera):
            return registry.render(camera)
    elif path == "surface":
        scene = sphere_mesh_data()
        registry = create_renderer("Opaque (Triangle Mesh)", device=dev)
        registry.set_line_data(scene)

        def render(_scene, camera):
            return registry.render(camera)
    elif path in scattering:
        scene = scattering_line_data(dev)
        name, settings = scattering[path]
        registry = create_renderer(name, SettingsMap(settings) if settings else None, device=dev)
        registry.set_line_data(scene)
        look = Camera(position=(0.0, 0.15, 0.9), look_at_point=(0.0, 0.0, 0.0), width=W, height=H)
        if path == "density_map":  # from the side the traced paths enter
            cams = [Camera(position=(-0.6 + 0.002 * i, -0.45, -0.55), width=W, height=H)
                    for i in range(n + 2)]
        else:  # the path tracer accumulates at one camera; the map takes its height
            cams = [look if path in vpt_paths else Camera(width=2 * H, height=H)] * (n + 2)

        def render(_scene, camera):
            return registry.render(camera)
    elif path == "vrc":
        scene = LineData(tornado_trajectories(dev))
        scene.set_line_width(TORNADO_LINE_WIDTH)
        registry = create_renderer("Voxel Ray Casting", device=dev)
        registry.set_line_data(scene)

        def render(_scene, camera):
            return registry.render(camera)
    elif path == "multivar":
        from linevis_tpu_torch.render.multivar import (
            MultiVarTransferFunctions,
            build_multivar_tube_mesh,
            combine_transfer_function_table,
        )

        traj = tornado_trajectories(dev)
        attr = traj.attributes[:, 0]
        scene = build_multivar_tube_mesh(traj.positions, traj.mask, [attr, 1.0 - attr],
                                         radius=TORNADO_RADIUS, num_subdivisions=8, device=dev)
        table = torch.as_tensor(combine_transfer_function_table(
            MultiVarTransferFunctions.default(2)).table, device=dev)

        def render(mesh, view_proj, position, _proj_ab):
            return render_opaque(mesh, view_proj, position, table, wide)
    elif path in BASELINE_CONFIGS:
        run = BASELINE_CONFIGS[path](device=dev, frames=n + 2)
        if run.renderer.name == "RTAO":
            n = 4
        scene, cams = run.renderer.line_data, run.cameras[:n + 2]

        def render(_scene, camera):
            return run.renderer.render(camera)
    elif path == "prism":
        scene = tornado_prism_scene(dev)
        render = partial(render_tubes_prism, settings=wide)
    elif path == "rtao":
        scene = tornado_scene(dev)
        rtao = RtaoSettings()
        render = partial(render_tubes_rtao, settings=wide, rtao=rtao,
                         grid=tornado_segment_grid(scene, rtao.grid_resolution))
    elif path == "wavefront":
        scene = tornado_scene(dev)
        render = partial(render_tubes_raytraced_wavefront,
                         settings=RasterSettings(width=W, height=H, tile_w=16, tile_h=8),
                         K=8, opacity=0.3, wide_groups=tornado_wide_bvh(scene)[0])
    elif path in ("recast", "mlat"):
        scene = tornado_scene(dev)
        kw = dict(settings=RasterSettings(width=W, height=H), opacity=0.3,
                  bvh=lbvh_on(build_capsule_bvh(scene), dev))
        render = (partial(render_tubes_raytraced, max_depth_complexity=32, **kw)
                  if path == "recast" else partial(render_tubes_mlat, K=8, **kw))
    else:
        scene = tornado_tube_mesh(dev)
        table = torch.as_tensor(TransferFunction.standard().table, device=dev)

        def render(mesh, view_proj, position, _proj_ab):
            return render_opaque(mesh, view_proj, position, table, wide)
    cams = [(c,) if path in takes_camera else camera_tensors(c, dev) for c in cams]
    for cam in cams[:2]:
        render(scene, *cam)
    torch.cuda.synchronize()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    def frames():
        t0 = time.perf_counter()
        for cam in cams[2:]:
            render(scene, *cam)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # The profiler slows the host, so the window it is held against is
    # the same frames timed without it.
    # The program records into the imported module's recorder, not into
    # this file's when it runs as __main__.
    from linevis_tpu_torch.automation import profiling

    wall_ms = frames()
    profiling.reset()
    with trace(out_dir and os.path.join(out_dir, "tube_frames.json")) as prof:
        profiled_wall_ms = frames()
    rec = profiling.records()
    self_ms = defaultdict(float)
    for s in rec["spans"]:
        self_ms[s.name] += s.self_ns / 1e6 / n
    summary = device_summary(prof, wall_ms)
    summary.update(path=path, frames=n, profiled_wall_ms=profiled_wall_ms,
                   per_frame_wall_ms=wall_ms / n,
                   per_frame_busy_ms=summary["device_busy_ms"] / n, gpu=gpu,
                   spans=dict(self_ms), counts={k: v / n for k, v in rec["counts"].items()})
    line = json.dumps(summary)
    if out_dir:
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            f.write(line + "\n")
        with open(os.path.join(out_dir, "records.json"), "w") as f:
            json.dump({"spans": [s._asdict() for s in rec["spans"]], "counts": rec["counts"]}, f)
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:3]))
