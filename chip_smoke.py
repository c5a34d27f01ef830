#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (linevis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `linevis_tpu_torch/kernels/csrc/`, then
drives the main path at full size: the Crawfis tornado traced on the card
(512 seeds from np.random.default_rng(42), 400 RK4 steps, dt 1/150; ~205k
capsule segments) and rendered as opaque capsule tubes at 1920x1080 (tile
32x16, analytic-coverage AA, span 2x2) for 16 orbit-camera frames through
`render_tubes`. It times the frames and their stages with CUDA events,
holds every kernel against its plain PyTorch version on the same 1080p
inputs, checks a small frame on the card against the plain path on the CPU,
and prints one JSON line of kernel figures, then the device line last.

Exits non-zero, printing no result, without a CUDA device or without the
repository beside it. Any failed check raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
N_FRAMES = 16
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores (H100 SXM data sheet)
H100_HBM_BYTES = 3.35e12
# Float operations of one (candidate, pixel) evaluation of the capsule kernel
# with coverage AA, each add/mul/min/max/compare/sqrt/div counted once:
# ray re-origin and dot products 38, three quadratics and their roots 35,
# three AA signed distances 51 (the body's through a cross product),
# acceptance tests and selects 19.
CAPSULE_OPS_PER_EVAL = 143
STAGED_ROWS = 13  # payload rows the capsule kernel reads per candidate


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = _events()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from linevis_tpu_torch.entry import entry, tornado_scene
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.raster_capsule import (
        rasterize_capsules,
        rasterize_capsules_reference,
    )
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.framebuffer import ssim
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import (
        camera_tensors,
        prepare_capsule_frame,
        render_tubes,
        resolve_capsule_frame,
    )

    # The reference comparisons run in full float32: no TF32 in matmuls or
    # convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul off, cudnn off", flush=True)

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"gpu: {gpu}", flush=True)
    dev = torch.device("cuda", 0)

    # 1. Build every kernel, one nvcc each, in parallel.
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)}", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # 2. Trace the tornado on the card.
    t0 = time.perf_counter()
    scene = tornado_scene(dev)
    torch.cuda.synchronize()
    n_valid = int(scene.mask.sum())
    print(f"trace: {time.perf_counter() - t0:.2f} s, {scene.num_segments} segments, "
          f"{n_valid} valid", flush=True)
    if n_valid < 100_000:
        raise RuntimeError("tornado trace produced too few segments")

    settings = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    base = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    cams = [camera_tensors(base.orbit(0.002 * (i + 1), 0.1, 1.2), dev)
            for i in range(N_FRAMES)]

    # 3. The main path: N_FRAMES frames through render_tubes, launches counted.
    render_tubes(scene, *cams[0], settings)  # warm-up (allocator, first launch)
    torch.cuda.synchronize()
    rasterize_capsules.launches = 0
    frame_ev = [_events() for _ in cams]
    imgs_sum = torch.zeros((), device=dev)
    for (a, b), cam in zip(frame_ev, cams):
        a.record()
        img = render_tubes(scene, *cam, settings)
        b.record()
        imgs_sum += img[:3].sum()
    torch.cuda.synchronize()
    launches = rasterize_capsules.launches
    if launches != N_FRAMES:
        raise RuntimeError(f"capsule kernel launched {launches} times for {N_FRAMES} frames")
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite frame on the main path")
    frame_ms = [a.elapsed_time(b) for a, b in frame_ev]

    # Stage breakdown of the same frames: prep+binning, kernel, resolve+shade.
    stage_ms = {"prep_binning": [], "kernel": [], "shade": []}
    for cam in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        csr, params, basis = prepare_capsule_frame(
            scene, *cam, settings, aa_margin=0.5
        )
        ev[1].record()
        raster = rasterize_capsules(csr, params, W, H, settings.tile_w, settings.tile_h)
        ev[2].record()
        resolve_capsule_frame(scene, csr, raster, *cam, basis, settings)
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stage_ms, zip(ev[:-1], ev[1:])):
            stage_ms[k].append(a.elapsed_time(b))
    frame_line = {
        "frame_ms_median": float(np.median(frame_ms)),
        "fps": 1000.0 / float(np.median(frame_ms)),
        "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "frames": N_FRAMES, "width": W, "height": H, "gpu": gpu,
    }
    print("frame: " + json.dumps(frame_line), flush=True)

    # 4. Kernel vs plain version on frame 0's inputs.
    csr, params, basis = prepare_capsule_frame(scene, *cams[0], settings, aa_margin=0.5)
    n_tiles = csr.tile_start.shape[0]
    P = settings.tile_w * settings.tile_h
    pairs = int(csr.tile_count.sum())
    work = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    k_out = rasterize_capsules(csr, params, W, H, 32, 16, work=work)
    p_out = rasterize_capsules_reference(csr, params, W, H, 32, 16)
    torch.cuda.synchronize()
    evaluated = int(work.sum())

    ids_k, ids_p = k_out[1], p_out[1]
    agree = ids_k == ids_p
    id_agree = float(agree.float().mean())
    planes_k = [k_out[0], *k_out[2][:7]]
    planes_p = [p_out[0], *p_out[2][:7]]
    max_gbuf = max(float((a - b).abs()[agree].max()) for a, b in zip(planes_k, planes_p))
    max_cov = float((k_out[2][7] - p_out[2][7]).abs()[agree].max())
    img_k = resolve_capsule_frame(scene, csr, k_out, *cams[0], basis, settings)
    img_p = resolve_capsule_frame(scene, csr, p_out, *cams[0], basis, settings)
    img_k_np = img_k.permute(1, 2, 0).cpu().numpy()
    img_p_np = img_p.permute(1, 2, 0).cpu().numpy()
    img_ssim = ssim(img_k_np[..., :3], img_p_np[..., :3])
    img_mad = float(np.abs(img_k_np - img_p_np).mean())
    fg = float((ids_k >= 0).float().mean())
    print(f"capsule_raster vs plain: pairs {pairs}, evaluated after early-z {evaluated}, "
          f"id agree {id_agree:.6f}, max |dz, dgbuf| {max_gbuf:.3g}, max |dcov| "
          f"{max_cov:.3g}, image ssim {img_ssim:.6f}, mean abs {img_mad:.3g}, "
          f"foreground {fg:.4f}", flush=True)
    if not np.isfinite(img_k_np).all():
        raise RuntimeError("non-finite pixels in the 1080p frame")
    if id_agree < 0.999 or max_gbuf > 1e-5 or max_cov > 2e-3:
        raise RuntimeError("capsule kernel disagrees with its plain version")
    if img_ssim < 0.999 or img_mad > 2e-3:
        raise RuntimeError("kernel image disagrees with the plain version's")
    if fg < 0.01:
        raise RuntimeError("the tornado frame is almost empty")

    # 5. A small frame on the card against the plain path on the CPU.
    fn, args = entry(device=dev)
    small_gpu = fn(*args).permute(1, 2, 0).cpu().numpy()
    fn_cpu, args_cpu = entry(device="cpu")
    small_cpu = fn_cpu(*args_cpu).permute(1, 2, 0).numpy()
    small_ssim = ssim(small_gpu[..., :3], small_cpu[..., :3])
    small_mad = float(np.abs(small_gpu - small_cpu).mean())
    print(f"entry frame card vs cpu: ssim {small_ssim:.6f}, mean abs {small_mad:.3g}",
          flush=True)
    if small_ssim < 0.999 or small_mad > 2e-3:
        raise RuntimeError("card frame disagrees with the CPU plain path")

    # 6. Kernel figures at the 1080p shapes.
    kernel_ms = _time_ms(lambda: rasterize_capsules(csr, params, W, H, 32, 16), 20)
    plain_ms = _time_ms(
        lambda: rasterize_capsules_reference(csr, params, W, H, 32, 16), 2
    )
    out_bytes = 10 * n_tiles * P * 4
    in_bytes = evaluated * STAGED_ROWS * 4 + 2 * n_tiles * 4 + 32 * 4
    ops = evaluated * P * CAPSULE_OPS_PER_EVAL
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    kernels = [{
        "name": "capsule_raster",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/raster_capsule.cu",
        "replaces": "linevis_tpu/kernels/raster_capsule.py:52",
        "launches": launches,
        "max_abs_err": max(max_gbuf, max_cov),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "id_agree": id_agree,
        "max_abs_gbuf": max_gbuf,
        "max_abs_cov": max_cov,
        "kernel_ms": kernel_ms,
        "pairs": pairs,
        "evaluated": evaluated,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
