"""Profiling harness: torch.profiler traces, device-time summaries and
per-pass frame timers.

Counterpart of `linevis_tpu/automation/profiling.py` (jax.profiler there).
`trace` records host ops and CUDA kernels and can write a Chrome/Perfetto
trace; `device_summary` turns a recording into the device's busy time, its
idle share of a host-timed window, and the kernels that take the time;
`FrameProfiler` times named passes, one CSV row per (frame, pass), on the
host clock and, for a pass on the card, also between CUDA events.

    python -m linevis_tpu_torch.automation.profiling [OUT_DIR [PATH]]

PATH: opaque|mlab|prism|triangle|rtao|wavefront|recast|mlat|wboit|depth_peeling|mlab_buckets|
      mboit|depth_complexity|opacity_optimization|rtao_registry|surface|vpt|density_map|heatmap|
      vrc|multivar|a name of entry.BASELINE_CONFIGS

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
frames), the "Line Density Map Renderer" from the side the paths enter, the
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
recorded, and prints one JSON line; with OUT_DIR (give "" for none) it
also writes that line to OUT_DIR/summary.json and the Chrome trace to
OUT_DIR/tube_frames.json.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import sys
import time
from collections import defaultdict

import torch

__all__ = ["trace", "device_summary", "FrameProfiler"]


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
    scattering = {"vpt": "Volumetric Path Tracer", "density_map": "Line Density Map Renderer",
                  "heatmap": "Spherical Heat Map Renderer"}
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
    n = 4 if path in ("rtao", "wavefront", "recast", "mlat", "rtao_registry", "vpt",
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
        registry = create_renderer(scattering[path], device=dev)
        registry.set_line_data(scene)
        look = Camera(position=(0.0, 0.15, 0.9), look_at_point=(0.0, 0.0, 0.0), width=W, height=H)
        if path == "density_map":  # from the side the traced paths enter
            cams = [Camera(position=(-0.6 + 0.002 * i, -0.45, -0.55), width=W, height=H)
                    for i in range(n + 2)]
        else:  # the path tracer accumulates at one camera; the map takes its height
            cams = [look if path == "vpt" else Camera(width=2 * H, height=H)] * (n + 2)

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
    wall_ms = frames()
    with trace(out_dir and os.path.join(out_dir, "tube_frames.json")) as prof:
        profiled_wall_ms = frames()
    summary = device_summary(prof, wall_ms)
    summary.update(path=path, frames=n, profiled_wall_ms=profiled_wall_ms,
                   per_frame_wall_ms=wall_ms / n,
                   per_frame_busy_ms=summary["device_busy_ms"] / n, gpu=gpu)
    line = json.dumps(summary)
    if out_dir:
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:3]))
