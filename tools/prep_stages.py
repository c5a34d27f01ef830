#!/usr/bin/env python3
"""Config 5's frame prep on the card against the CPU, op by op.

    python3 tools/prep_stages.py [--out chiprun_out/prep_stages.json] [--scale 0.1]

Traces the smoke's tornado on the card (`entry.tornado_trajectories`),
builds reference config 5 (`entry.BASELINE_CONFIGS`, "Opacity
Optimization" at `--scale`, the scale of the smoke's card-vs-CPU check) and
runs its frame 0's importance-gather prep (`render/tube_raster.py:
prepare_capsule_frame` at `render/opacity_optimization.py:gather_settings`)
once on the card and once on the CPU, from the same host line data and
camera. Every torch call inside is recorded in order (a TorchFunctionMode):
the call's source line in the package, whether its tensor inputs are equal
on the two devices, and how many of its output elements differ (and by how
much). It prints the first call whose outputs differ, the first whose
outputs differ while its inputs are equal (the op that rounds otherwise on
the card), then the gather's nodes and the payload. A reading: it gates
nothing and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

import torch
from torch.overrides import TorchFunctionMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class _Record(TorchFunctionMode):
    """Each torch call -> (source line, name, tensor inputs, tensor outputs),
    the tensors copied to the host."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        where = next((f"{os.path.relpath(fr.filename, REPO)}:{fr.lineno}"
                      for fr in reversed(traceback.extract_stack())
                      if "linevis_tpu_torch" in fr.filename), "?")
        self.calls.append((where, getattr(func, "__name__", str(func)),
                           _tensors(args) + _tensors(list((kwargs or {}).values())),
                           _tensors([out])))
        return out


def _tensors(xs):
    found = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            found.append(x.detach().to("cpu", copy=True))
        elif isinstance(x, (list, tuple)):
            found.extend(_tensors(list(x)))
    return found


def _equal(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _diff(a, b):
    """(elements that differ, largest |difference|) over matching tensors."""
    n, big = 0, 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return -1, float("inf")
        ne = x != y
        if x.is_floating_point():
            ne &= ~(torch.isnan(x) & torch.isnan(y))
        n += int(ne.sum())
        if ne.any() and x.is_floating_point():
            big = max(big, float((x.double() - y.double()).abs()[ne].max()))
    return n, big


def main() -> int:
    if not torch.cuda.is_available():
        print("prep_stages: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--scale", type=float, default=0.1)
    args = ap.parse_args()
    from linevis_tpu_torch.entry import BASELINE_CONFIGS, TORNADO_LINE_WIDTH, tornado_trajectories
    from linevis_tpu_torch.render.opacity_optimization import (
        OpacityOptimizationSettings,
        gather_importance,
        gather_settings,
    )
    from linevis_tpu_torch.render.tube_raster import camera_tensors, prepare_capsule_frame
    from linevis_tpu_torch.scene.line_data import LineData

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    ld = LineData(tornado_trajectories(dev))
    ld.set_line_width(TORNADO_LINE_WIDTH)
    run = BASELINE_CONFIGS["cfg5_tornado_opacityopt_1080p"](device="cpu", scale=args.scale,
                                                           line_data=ld)
    cam = run.cameras[0]
    oo = OpacityOptimizationSettings()
    s2 = gather_settings(run.renderer._raster_settings(cam), oo)
    runs = []
    for d in (dev, "cpu"):
        scene = ld.get_capsule_scene(device=d)
        ct = camera_tensors(cam, d)
        rec = _Record()
        with rec:
            csr, params, _ = prepare_capsule_frame(scene, *ct, s2)
        nodes = gather_importance(scene, *ct, run.renderer._raster_settings(cam), oo)
        runs.append((rec.calls, csr, [x.cpu() for x in nodes],
                     [scene.a.cpu(), scene.ba.cpu(), scene.attr0.cpu(), scene.dattr.cpu()]))
    (g_calls, g_csr, g_nodes, g_scene), (c_calls, c_csr, c_nodes, c_scene) = runs
    calls, first_out, first_op = [], None, None
    diverged = None
    for i, (g, c) in enumerate(zip(g_calls, c_calls)):
        if g[1] != c[1]:
            diverged = {"i": i, "card": [g[0], g[1]], "cpu": [c[0], c[1]]}
            break
        same_in = _equal(g[2], c[2])
        n, big = _diff(g[3], c[3])
        row = {"i": i, "where": g[0], "op": g[1], "inputs_equal": same_in,
               "outputs_differ": n, "max_abs": big,
               "elements": sum(x.numel() for x in g[3])}
        calls.append(row)
        if n and first_out is None:
            first_out = row
        if n and same_in and first_op is None:
            first_op = row
    scene_diff = [_diff([a], [b]) for a, b in zip(g_scene, c_scene)]
    node_ok = ((g_nodes[0] - c_nodes[0]).abs() <= 1e-5) & (g_nodes[2] == c_nodes[2])
    out = {
        "config": "cfg5_tornado_opacityopt_1080p", "scale": args.scale,
        "gather_frame": [s2.width, s2.height], "segments": int(g_scene[0].shape[1]),
        "scene_a_ba_attr0_dattr_differ": [d[0] for d in scene_diff],
        "calls": len(g_calls), "calls_cpu": len(c_calls), "call_sequences_diverge": diverged,
        "first_call_whose_outputs_differ": first_out,
        "first_op_that_differs_on_equal_inputs": first_op,
        "payload_differs": _diff([g_csr.payload.cpu()], [c_csr.payload.cpu()]),
        "tile_count_equal": bool(torch.equal(g_csr.tile_count.cpu(), c_csr.tile_count.cpu())),
        "gather_pixels_with_equal_nodes": float(node_ok.all(dim=0).float().mean()),
        "gpu": gpu,
    }
    print("prep stages card vs cpu: " + json.dumps(out), flush=True)
    for row in calls:
        if row["outputs_differ"]:
            print("  differs: " + json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**out, "every_call": calls}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
