"""Automatic performance measurement: state sweeps + camera flight + CSV.

Counterpart of `linevis_tpu/automation/perf.py`. Reference:
`src/Utils/AutomaticPerformanceMeasurer.*` and the `InternalState`
test-mode matrices (`src/Utils/InternalState.hpp:171-199`, `getTestModes`
in InternalState.cpp). Each state = {dataset, rendering mode, renderer
settings, dataset settings, resolution}; the measurer drives a camera
flight per state through the port's registry on `device` (the card unless
the caller asks for the CPU) and writes a CSV with the reference's column
schema (`AutomaticPerformanceMeasurer.cpp:230-279`): state name, average
time, FPS average / 5% / 95% percentiles / stddev. A frame's time is the
host clock around `renderer.render`, which returns the image in host
memory, so the device's work is inside it.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.renderer import create_renderer

__all__ = ["InternalState", "AutomaticPerformanceMeasurer", "circle_flight",
           "get_test_modes", "get_test_modes_oit"]


@dataclasses.dataclass
class InternalState:
    """One benchmark state (reference InternalState.hpp:171-199)."""

    name: str = ""
    dataset: str = ""
    rendering_mode: str = "Opaque"
    renderer_settings: Optional[SettingsMap] = None
    dataset_settings: Optional[SettingsMap] = None
    window_size: Tuple[int, int] = (1920, 1080)


def circle_flight(t: float, radius: float = 1.2, height: float = 0.1,
                  period: float = 16.0) -> Tuple[float, float, float]:
    """Circular camera path around the origin (the reference's default
    camera flight when no .binpath exists, MainApp.cpp:2483-2497)."""
    a = 2.0 * math.pi * t / period
    return (radius * math.sin(a), height, radius * math.cos(a))


def get_test_modes_oit(
    dataset: str, window_size: Tuple[int, int] = (1920, 1080)
) -> List[InternalState]:
    """OIT benchmark sweep — the reference's `getTestModesPaper`-style
    matrix (InternalState.cpp:60-120): every transparency algorithm with
    its parameter variants on one dataset."""
    states = []

    def add(name, mode, **settings):
        states.append(InternalState(
            name=name, dataset=dataset, rendering_mode=mode,
            renderer_settings=SettingsMap(settings) if settings else None,
            window_size=window_size,
        ))

    add("Opaque", "Opaque")
    add("MLAB 8 Layers", "Multi-Layer Alpha Blending")
    add("PPLL (K=32 exact)", "Per-Pixel Linked Lists")
    add("MLAB (Buckets)", "MLAB (Buckets)")
    for n_mom in (4, 6, 8):
        add(f"MBOIT {n_mom} Power Moments", "Moment-Based OIT",
            numMoments=n_mom)
    add("MBOIT 4 Trigonometric Moments", "Moment-Based OIT",
        numMoments=4, usePowerMoments=False)
    add("MBOIT 4 Power Moments UNorm16", "Moment-Based OIT",
        numMoments=4, pixelFormat="UNorm")
    add("WBOIT", "WBOIT")
    add("Depth Peeling", "Depth Peeling")
    add("Depth Complexity", "Depth Complexity")
    add("Opacity Optimization", "Opacity Optimization")
    return states


def get_test_modes(
    dataset: str, window_size: Tuple[int, int] = (1920, 1080)
) -> List[InternalState]:
    """Full rendering-mode sweep (reference getTestModes role)."""
    states = get_test_modes_oit(dataset, window_size)
    for mode in ("Vulkan Ray Tracer", "Voxel Ray Casting"):
        states.append(InternalState(
            name=mode, dataset=dataset, rendering_mode=mode,
            window_size=window_size,
        ))
    return states


class AutomaticPerformanceMeasurer:
    """Drives the state list and writes the benchmark CSV."""

    CSV_COLUMNS = [
        "State Name",
        "Data Set Name",
        "Device Name",
        "Resolution",
        "Average Time (ms)",
        "Average FPS",
        "5% Percentile FPS",
        "95% Percentile FPS",
        "StdDev FPS",
        "Frames",
        # Buffer / depth-complexity statistics
        # (AutomaticPerformanceMeasurer.hpp:59-71).
        "Dataset Buffer Size (GiB)",
        "Avg Depth Complexity",
        "Max Depth Complexity",
        "Total Fragments",
    ]

    def __init__(
        self,
        states: List[InternalState],
        dataset_loader: Callable[[str], object],
        csv_path: str = "performance.csv",
        flight_seconds: float = 4.0,
        fps_target: float = 10.0,
        device_name: Optional[str] = None,
        device="cuda",
    ):
        self.states = states
        self.dataset_loader = dataset_loader
        self.csv_path = csv_path
        self.flight_seconds = flight_seconds
        self.fps_target = fps_target
        self.device = torch.device(device)
        if device_name is None:
            device_name = (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu")
        self.device_name = device_name
        self.per_frame_rows: List[dict] = []

    def run(self) -> List[dict]:
        rows = []
        datasets = {}
        for state in self.states:
            if state.dataset not in datasets:
                datasets[state.dataset] = self.dataset_loader(state.dataset)
            line_data = datasets[state.dataset]
            renderer = create_renderer(state.rendering_mode, state.renderer_settings,
                                       device=self.device)
            renderer.set_line_data(line_data)
            if state.dataset_settings is not None:
                line_data.set_new_settings(state.dataset_settings)
            w, h = state.window_size
            n_frames = max(int(self.flight_seconds * self.fps_target), 2)
            frame_times = []
            for i in range(n_frames):
                t = i / self.fps_target
                pos = circle_flight(t)
                cam = Camera(position=pos, width=w, height=h)
                t0 = time.perf_counter()
                renderer.render(cam)  # numpy in host memory: the device work is done
                dt = time.perf_counter() - t0
                if i > 0:  # skip the first frame (builds, uploads, caches)
                    frame_times.append(dt)
                    self.per_frame_rows.append(
                        {"state": state.name, "frame": i, "time_ms": dt * 1000.0}
                    )
            ft = np.array(frame_times)
            fps = 1.0 / ft
            dc_stats = self._depth_complexity_stats(line_data, w, h)
            rows.append(
                {
                    "State Name": state.name,
                    "Data Set Name": state.dataset,
                    "Device Name": self.device_name,
                    "Resolution": f"{w}x{h}",
                    "Average Time (ms)": round(float(ft.mean() * 1000.0), 3),
                    "Average FPS": round(float(fps.mean()), 3),
                    "5% Percentile FPS": round(float(np.percentile(fps, 5)), 3),
                    "95% Percentile FPS": round(float(np.percentile(fps, 95)), 3),
                    "StdDev FPS": round(float(fps.std()), 3),
                    "Frames": len(frame_times),
                    "Dataset Buffer Size (GiB)": round(_dataset_bytes(line_data) / 2**30, 6),
                    **dc_stats,
                }
            )
        with open(self.csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.CSV_COLUMNS)
            writer.writeheader()
            writer.writerows(rows)
        return rows

    def write_per_frame_csv(self, path: str) -> None:
        """Per-frame timing CSV (the reference's second CSV,
        AutomaticPerformanceMeasurer.hpp:100-117)."""
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["state", "frame", "time_ms"])
            w.writeheader()
            w.writerows(self.per_frame_rows)

    def _depth_complexity_stats(self, line_data, w: int, h: int) -> dict:
        """Per-state depth-complexity statistics fed into the CSV
        (AutomaticPerformanceMeasurer.hpp:59-60), computed once per state
        with the depth-complexity store mode at a fixed camera on the
        measurer's device. A dataset without a capsule scene (a triangle
        mesh) leaves the three columns blank; any other failure raises."""
        if not hasattr(line_data, "get_capsule_scene"):
            return {"Avg Depth Complexity": "", "Max Depth Complexity": "",
                    "Total Fragments": ""}
        from linevis_tpu_torch.render.oit import render_depth_complexity
        from linevis_tpu_torch.render.pipeline import RasterSettings
        from linevis_tpu_torch.render.tube_raster import camera_tensors

        cam = Camera(position=circle_flight(0.0), width=w, height=h)
        counts = render_depth_complexity(
            line_data.get_capsule_scene(device=self.device),
            *camera_tensors(cam, self.device),
            RasterSettings(width=w, height=h),
        ).cpu().numpy()
        used = counts[counts > 0]
        return {
            "Avg Depth Complexity": round(float(used.mean()) if used.size else 0.0, 3),
            "Max Depth Complexity": int(counts.max()),
            "Total Fragments": int(counts.sum()),
        }


def _dataset_bytes(data) -> int:
    """Host bytes of the dataset's geometry: the trajectories' positions and
    attributes, or a triangle mesh's vertices and triangles."""
    if hasattr(data, "trajectories"):
        return data.trajectories.positions.nbytes + data.trajectories.attributes.nbytes
    return data.mesh.vertices.nbytes + data.mesh.triangles.nbytes
