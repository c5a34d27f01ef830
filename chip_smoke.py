#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (linevis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `linevis_tpu_torch/kernels/csrc/`, then
drives the ported paths at full size on the Crawfis tornado traced on the
card (512 seeds from np.random.default_rng(42), 400 RK4 steps, dt 1/150;
~205k capsule segments), 16 orbit-camera frames each at 1920x1080:
- opaque capsule tubes through `render_tubes` (tile 32x16, analytic-coverage
  AA, span 2x2; kernel capsule_raster);
- transparent MLAB tubes through `render_tubes_mlab` (the JAX package's
  bench.py MLAB settings: tile 16x8, chunk 128, K=8, opacity 0.3, sat
  0.999, sub 32, front faces only; kernel capsule_mlab);
- opaque 8-gon prism tubes through `render_tubes_prism` (tile 32x16, the
  capsule binning; kernel prism_raster);
- opaque triangle tubes (8 subdivisions, ~3.3 M triangles) through
  `render_opaque` (tile 32x16, chunk 128, span 2x2; kernel triangle_raster).
For each path it times the frames and their stages with CUDA events, holds
the path's kernel against its plain PyTorch version on the same 1080p
inputs, and checks a small frame on the card against the plain path on the
CPU (for the transparent path also the Atomic Loop frame, K=16
`no_overflow`, through `render_tubes_atomic_loop`). It also prints the SSIM
of the prism frame against the triangle frame of the same camera. Then it
prints one JSON line of kernel figures, and the device line last.

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
# Float operations of the MLAB kernel (each add/mul/min/max/compare/select/
# sqrt/div counted once, an FMA twice), front faces only:
# per (candidate, pixel) evaluation 95: the two dot products and the
# re-origin 20, the three quadratics and their roots 29, the entry surface's
# three roots, axial positions and acceptance tests 40, the world t, NDC clip
# and rejection 6;
MLAB_OPS_PER_EVAL = 95
# per fragment in an extracted tie window 45: its axial position, attribute,
# the two headlight cosines through the tube-axis identities 29, the
# opacity TF 10, the window sums 4, and the window test 2;
MLAB_OPS_PER_MEMBER = 45
# per (pixel, sweep) extraction: the scan for the nearest hit, 1 per block
# candidate, and the carry and insertion into K nodes: the carry's NDC depth
# and averages 12, then 4 per node (position count, dedup test, shift).
MLAB_OPS_PER_SWEEP = 12
MLAB_OPS_PER_SWEEP_NODE = 4
MLAB_ROWS = 23  # payload rows the MLAB kernel stages per candidate
MLAB_K, MLAB_OPACITY, MLAB_SUB = 8, 0.3, 32
PRISM_SIDES = 8
# Float operations of one (candidate, pixel) evaluation of the prism kernel,
# each add/mul/min/max/compare/abs/div counted once. Per plane 15: the
# denominator n.dn 5, the parallel test (abs, compare) 2, the sign select 1,
# the reciprocal 1, the plane's t 1, the entering and exiting compares 2, the
# max and min 2, the parallel reject compare 1; a ring plane one max more.
# The hit rule and the tie take 6. The winner's G-buffer (per update, not per
# evaluation) is left out.
PRISM_OPS_PER_EVAL = 15 * PRISM_SIDES + 16 * 2 + 6
PRISM_ROWS = 23  # payload rows the prism kernel reads per candidate (0-10, 24-35)
# Float operations of one (slot, pixel) evaluation of the triangle kernel:
# three edge planes and the depth plane at 2 multiplies and 2 adds each, 16,
# and the five inside compares; per (chunk, pixel) update the id plane and 8
# attribute planes, 4 each, and the depth compare.
TRIANGLE_OPS_PER_EVAL = 21
TRIANGLE_OPS_PER_TAKE = 4 * 9 + 1
TRIANGLE_PLANES = 8


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
    from linevis_tpu_torch.entry import (
        entry,
        entry_mlab,
        entry_prism,
        entry_triangle,
        tornado_prism_scene,
        tornado_scene,
        tornado_trajectories,
        tornado_tube_mesh,
    )
    from linevis_tpu_torch.kernels import _build, raster_pallas
    from linevis_tpu_torch.kernels.raster_capsule import (
        rasterize_capsules,
        rasterize_capsules_reference,
    )
    from linevis_tpu_torch.kernels.raster_capsule_oit import (
        rasterize_capsules_mlab,
        rasterize_capsules_mlab_reference,
    )
    from linevis_tpu_torch.kernels.raster_prism import (
        rasterize_prisms,
        rasterize_prisms_reference,
    )
    from linevis_tpu_torch.kernels.tiles import unpack_tiles
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.framebuffer import ssim
    from linevis_tpu_torch.render.oit import (
        prepare_mlab_frame,
        render_tubes_atomic_loop,
        render_tubes_mlab,
    )
    from linevis_tpu_torch.render.opaque import (
        _ray_basis_from_view_proj,
        render_opaque,
        untile_gbuffer,
    )
    from linevis_tpu_torch.render.pipeline import (
        RasterSettings,
        build_payload,
        shade_gbuffer,
        tube_vertex_stage,
    )
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import (
        camera_tensors,
        prepare_capsule_frame,
        prepare_prism_frame,
        render_tubes,
        render_tubes_prism,
        resolve_capsule_frame,
    )

    wrappers = {
        "capsule_raster": rasterize_capsules, "capsule_mlab": rasterize_capsules_mlab,
        "prism_raster": rasterize_prisms, "triangle_raster": raster_pallas.rasterize_gbuffer,
    }

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def only_launched(name):
        """Launches of `name` since reset_launches(); raises unless it was
        launched once per frame and no other kernel at all."""
        for other, w in wrappers.items():
            if other != name and w.launches:
                raise RuntimeError(f"the {name} path launched {other} {w.launches} times")
        n = wrappers[name].launches
        if n != N_FRAMES:
            raise RuntimeError(f"{name} launched {n} times for {N_FRAMES} frames")
        return n

    def card_vs_cpu(make_entry, label):
        """A small frame on the card against the plain path on the CPU."""
        fn, args = make_entry(device=dev)
        gpu_img = fn(*args).permute(1, 2, 0).cpu().numpy()
        fn_cpu, args_cpu = make_entry(device="cpu")
        cpu_img = fn_cpu(*args_cpu).permute(1, 2, 0).numpy()
        s_ = ssim(gpu_img[..., :3], cpu_img[..., :3])
        mad = float(np.abs(gpu_img - cpu_img).mean())
        print(f"{label} frame card vs cpu: ssim {s_:.6f}, mean abs {mad:.3g}", flush=True)
        if not np.isfinite(gpu_img).all() or not (gpu_img[..., :3] < 0.999).any():
            raise RuntimeError(f"card {label} frame is non-finite or empty")
        if s_ < 0.999 or mad > 2e-3:
            raise RuntimeError(f"card {label} frame disagrees with the CPU plain path")

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
    traj = tornado_trajectories(dev)
    scene = tornado_scene(dev, traj=traj)
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
    reset_launches()
    frame_ev = [_events() for _ in cams]
    imgs_sum = torch.zeros((), device=dev)
    for (a, b), cam in zip(frame_ev, cams):
        a.record()
        img = render_tubes(scene, *cam, settings)
        b.record()
        imgs_sum += img[:3].sum()
    torch.cuda.synchronize()
    launches = only_launched("capsule_raster")
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
    card_vs_cpu(entry, "entry")

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
        "bytes": in_bytes + out_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "id_agree": id_agree,
        "max_abs_gbuf": max_gbuf,
        "max_abs_cov": max_cov,
        "kernel_ms": kernel_ms,
        "pairs": pairs,
        "evaluated": evaluated,
    }]

    # 7. The transparent path: N_FRAMES MLAB frames through render_tubes_mlab.
    s_oit = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    mlab_kw = dict(K=MLAB_K, opacity=MLAB_OPACITY, sub=MLAB_SUB, sat=0.999)

    def mlab_frame(cam):
        return render_tubes_mlab(scene, *cam, s_oit, **mlab_kw)

    mlab_frame(cams[0])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    frame_ev = [_events() for _ in cams]
    imgs_sum = torch.zeros((), device=dev)
    fg_sum = torch.zeros((), device=dev)
    for (a, b), cam in zip(frame_ev, cams):
        a.record()
        img = mlab_frame(cam)
        b.record()
        imgs_sum += img.sum()
        fg_sum += (img[3] > 0).float().mean()
    torch.cuda.synchronize()
    mlab_launches = only_launched("capsule_mlab")
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite MLAB frame on the main path")
    mlab_fg = float(fg_sum) / N_FRAMES
    if mlab_fg < 0.01:
        raise RuntimeError("the MLAB tornado frames are almost empty")
    mlab_frame_ms = [a.elapsed_time(b) for a, b in frame_ev]

    def mlab_kernel(csr, params, composite=True, **kw):
        return rasterize_capsules_mlab(
            csr, params, W, H, 16, 8, MLAB_K, s_oit.tf_color, s_oit.tf_opacity,
            deferred_shade=True, sub=MLAB_SUB, sat=0.999, composite=composite, **kw
        )

    def mlab_plain(csr, params, composite=True, **kw):
        return rasterize_capsules_mlab_reference(
            csr, params, W, H, 16, 8, MLAB_K, s_oit.tf_color, s_oit.tf_opacity,
            sub=MLAB_SUB, sat=0.999, composite=composite, **kw
        )

    def untile(csr, x):
        return unpack_tiles(x, csr.tiles_x, csr.tiles_y, 16, 8, W, H)

    stage_ms = {"prep_binning": [], "kernel": [], "unpack": []}
    for cam in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        csr, params = prepare_mlab_frame(scene, *cam, s_oit, MLAB_OPACITY)
        ev[1].record()
        rgba = mlab_kernel(csr, params)
        ev[2].record()
        torch.stack([untile(csr, rgba[c]) for c in range(4)])
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stage_ms, zip(ev[:-1], ev[1:])):
            stage_ms[k].append(a.elapsed_time(b))
    mlab_line = {
        "frame_ms_median": float(np.median(mlab_frame_ms)),
        "fps": 1000.0 / float(np.median(mlab_frame_ms)),
        "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "foreground_share": mlab_fg,
        "frames": N_FRAMES, "width": W, "height": H, "K": MLAB_K, "gpu": gpu,
    }
    print("mlab frame: " + json.dumps(mlab_line), flush=True)

    # 8. The MLAB kernel vs its plain version on frame 0's inputs, composite
    # and node mode.
    csr, params = prepare_mlab_frame(scene, *cams[0], s_oit, MLAB_OPACITY)
    n_tiles = csr.tile_start.shape[0]
    P = 16 * 8
    mlab_pairs = int(csr.tile_count.sum())
    work = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    k_rgba = mlab_kernel(csr, params, work=work)
    k_nodes = mlab_kernel(csr, params, composite=False)
    stats = {}
    a, b = _events()
    a.record()
    p_rgba = mlab_plain(csr, params, stats=stats)
    b.record()
    p_nodes = mlab_plain(csr, params, composite=False)
    torch.cuda.synchronize()
    mlab_plain_ms = a.elapsed_time(b)
    mlab_evaluated = int(work.sum())
    d_err = (k_nodes[0] - p_nodes[0]).abs().amax(dim=0)
    a_err = (k_nodes[2] - p_nodes[2]).abs().amax(dim=0)
    f_err = (k_nodes[1] - p_nodes[1]).abs().amax(dim=(0, 1))
    rgba_err = (k_rgba - p_rgba).abs().amax(dim=0)
    nodes_agree = (d_err <= 1e-5) & (a_err <= 1e-5)
    nodes_ok = float(nodes_agree.float().mean())
    f_err_ok = float(f_err[nodes_agree].max())
    rgba_ok = float((rgba_err <= 1e-4).float().mean())
    img_k = torch.stack([untile(csr, k_rgba[c]) for c in range(4)]).permute(1, 2, 0)
    img_p = torch.stack([untile(csr, p_rgba[c]) for c in range(4)]).permute(1, 2, 0)
    img_k, img_p = img_k.cpu().numpy(), img_p.cpu().numpy()
    mlab_ssim = ssim(img_k[..., :3], img_p[..., :3])
    mlab_mad = float(np.abs(img_k - img_p).mean())
    mlab_max_err = max(float(d_err.max()), float(a_err.max()), float(f_err.max()),
                       float(rgba_err.max()))
    print(f"capsule_mlab vs plain: pairs {mlab_pairs}, evaluated after culls "
          f"{mlab_evaluated}, hits {stats['hits']}, sweeps {stats['sweeps']}, "
          f"members {stats['members']}; node depth+alpha within 1e-5 on "
          f"{nodes_ok:.6f} of pixels (max |dd| {float(d_err.max()):.3g}, |da| "
          f"{float(a_err.max()):.3g}, |dfeat| {float(f_err.max()):.3g}, there "
          f"{f_err_ok:.3g}), rgba within "
          f"1e-4 on {rgba_ok:.6f} (max {float(rgba_err.max()):.3g}), image ssim "
          f"{mlab_ssim:.6f}, mean abs {mlab_mad:.3g}", flush=True)
    if not np.isfinite(img_k).all():
        raise RuntimeError("non-finite pixels in the 1080p MLAB frame")
    if nodes_ok < 0.999 or f_err_ok > 1e-5 or rgba_ok < 0.999:
        raise RuntimeError("MLAB kernel disagrees with its plain version")
    if mlab_ssim < 0.999 or mlab_mad > 2e-3:
        raise RuntimeError("MLAB kernel image disagrees with the plain version's")

    # 9. A small MLAB frame on the card against the plain path on the CPU.
    card_vs_cpu(entry_mlab, "entry_mlab")
    fn, args = entry_mlab(device=dev)
    _, args_cpu = entry_mlab(device="cpu")
    # The Atomic Loop path (K=16 no_overflow nodes, blended in torch) on the
    # same scene: one kernel launch on the card, and the CPU's image.
    small = {}
    for d, a in ((dev, args), ("cpu", args_cpu)):
        before = rasterize_capsules_mlab.launches
        small[str(d)] = render_tubes_atomic_loop(
            *a, fn.keywords["settings"], K=16, opacity=MLAB_OPACITY
        ).permute(1, 2, 0).cpu().numpy()
        al_launches = rasterize_capsules_mlab.launches - before
        if al_launches != (1 if d is dev else 0):
            raise RuntimeError(f"atomic loop on {d} launched the MLAB kernel "
                               f"{al_launches} times")
    al_gpu, al_cpu = small[str(dev)], small["cpu"]
    al_ssim = ssim(al_gpu[..., :3], al_cpu[..., :3])
    al_mad = float(np.abs(al_gpu - al_cpu).mean())
    print(f"atomic loop frame card vs cpu: ssim {al_ssim:.6f}, mean abs {al_mad:.3g}, "
          f"foreground {float((al_gpu[..., 3] > 0).mean()):.4f}", flush=True)
    if not np.isfinite(al_gpu).all() or (al_gpu[..., 3] > 0).mean() < 0.01:
        raise RuntimeError("atomic loop card frame is non-finite or empty")
    if al_ssim < 0.999 or al_mad > 2e-3:
        raise RuntimeError("card atomic loop frame disagrees with the CPU plain path")

    # 10. MLAB kernel figures at the 1080p shapes.
    mlab_ms = _time_ms(lambda: mlab_kernel(csr, params), 20)
    out_bytes = 4 * n_tiles * P * 4
    in_bytes = mlab_evaluated * MLAB_ROWS * 4 + 2 * n_tiles * 4 + 32 * 4
    ops = (mlab_evaluated * P * MLAB_OPS_PER_EVAL
           + stats["members"] * MLAB_OPS_PER_MEMBER
           + stats["sweeps"] * (MLAB_OPS_PER_SWEEP + MLAB_SUB
                                + MLAB_OPS_PER_SWEEP_NODE * MLAB_K))
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    kernels.append({
        "name": "capsule_mlab",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/raster_capsule_oit.cu",
        "replaces": "linevis_tpu/kernels/raster_capsule_oit.py:116",
        "launches": mlab_launches,
        "max_abs_err": mlab_max_err,
        "ms": mlab_ms,
        "plain_ms": mlab_plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": in_bytes + out_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "node_agree": nodes_ok,
        "rgba_agree": rgba_ok,
        "pairs": mlab_pairs,
        "evaluated": mlab_evaluated,
        "hits": stats["hits"],
        "sweeps": stats["sweeps"],
        "members": stats["members"],
    })

    # 11. The prism path: N_FRAMES frames through render_tubes_prism.
    prism_scene = tornado_prism_scene(dev, n_sides=PRISM_SIDES, traj=traj)
    render_tubes_prism(prism_scene, *cams[0], settings)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    frame_ev = [_events() for _ in cams]
    imgs_sum = torch.zeros((), device=dev)
    for (a, b), cam in zip(frame_ev, cams):
        a.record()
        img = render_tubes_prism(prism_scene, *cam, settings)
        b.record()
        imgs_sum += img[:3].sum()
    torch.cuda.synchronize()
    prism_launches = only_launched("prism_raster")
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite prism frame on the main path")
    prism_frame_ms = [a.elapsed_time(b) for a, b in frame_ev]

    def prism_kernel(csr, params, **kw):
        return rasterize_prisms(csr, params, W, H, 32, 16, n_sides=PRISM_SIDES, **kw)

    def prism_resolve(csr, raster, cam, basis):
        return resolve_capsule_frame(prism_scene, csr, raster, *cam, basis, settings,
                                     use_coverage=False)

    stage_ms = {"prep_binning": [], "kernel": [], "shade": []}
    for cam in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        csr, params, basis = prepare_prism_frame(prism_scene, *cam, settings)
        ev[1].record()
        raster = prism_kernel(csr, params)
        ev[2].record()
        prism_resolve(csr, raster, cam, basis)
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stage_ms, zip(ev[:-1], ev[1:])):
            stage_ms[k].append(a.elapsed_time(b))
    prism_line = {
        "frame_ms_median": float(np.median(prism_frame_ms)),
        "fps": 1000.0 / float(np.median(prism_frame_ms)),
        "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "frames": N_FRAMES, "width": W, "height": H, "n_sides": PRISM_SIDES, "gpu": gpu,
    }
    print("prism frame: " + json.dumps(prism_line), flush=True)

    # 12. The prism kernel vs its plain version on frame 0's inputs.
    csr, params, basis = prepare_prism_frame(prism_scene, *cams[0], settings)
    n_tiles = csr.tile_start.shape[0]
    P = settings.tile_w * settings.tile_h
    prism_pairs = int(csr.tile_count.sum())
    work = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    k_out = prism_kernel(csr, params, work=work)
    p_out = rasterize_prisms_reference(csr, params, W, H, 32, 16, n_sides=PRISM_SIDES)
    torch.cuda.synchronize()
    prism_evaluated = int(work.sum())
    if prism_evaluated != prism_pairs:
        raise RuntimeError("the prism kernel did not evaluate every candidate")
    agree = k_out[1] == p_out[1]
    prism_id_agree = float(agree.float().mean())
    prism_max = max(float((a - b).abs()[agree].max())
                    for a, b in zip([k_out[0], *k_out[2]], [p_out[0], *p_out[2]]))
    prism_img = prism_resolve(csr, k_out, cams[0], basis).permute(1, 2, 0).cpu().numpy()
    img_p_np = prism_resolve(csr, p_out, cams[0], basis).permute(1, 2, 0).cpu().numpy()
    img_ssim = ssim(prism_img[..., :3], img_p_np[..., :3])
    img_mad = float(np.abs(prism_img - img_p_np).mean())
    prism_fg = unpack_tiles(k_out[1] >= 0, csr.tiles_x, csr.tiles_y, 32, 16, W, H)
    fg = float((k_out[1] >= 0).float().mean())
    print(f"prism_raster vs plain: pairs {prism_pairs}, evaluated "
          f"{prism_evaluated}, id agree {prism_id_agree:.6f}, max |dz, dgbuf, dcov| "
          f"{prism_max:.3g}, image ssim {img_ssim:.6f}, mean abs {img_mad:.3g}, "
          f"foreground {fg:.4f}", flush=True)
    if not np.isfinite(prism_img).all():
        raise RuntimeError("non-finite pixels in the 1080p prism frame")
    if prism_id_agree < 0.999 or prism_max > 1e-5:
        raise RuntimeError("prism kernel disagrees with its plain version")
    if img_ssim < 0.999 or img_mad > 2e-3:
        raise RuntimeError("prism kernel image disagrees with the plain version's")
    if fg < 0.01:
        raise RuntimeError("the prism tornado frame is almost empty")
    card_vs_cpu(entry_prism, "entry_prism")

    prism_ms = _time_ms(lambda: prism_kernel(csr, params), 20)
    prism_plain_ms = _time_ms(
        lambda: rasterize_prisms_reference(csr, params, W, H, 32, 16, n_sides=PRISM_SIDES), 2
    )
    out_bytes = 10 * n_tiles * P * 4
    in_bytes = prism_evaluated * PRISM_ROWS * 4 + 2 * n_tiles * 4 + 32 * 4
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = prism_evaluated * P * PRISM_OPS_PER_EVAL / H100_FP32_FLOPS * 1e3
    kernels.append({
        "name": "prism_raster",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/raster_prism.cu",
        "replaces": "linevis_tpu/kernels/raster_prism.py:59",
        "launches": prism_launches,
        "max_abs_err": prism_max,
        "ms": prism_ms,
        "plain_ms": prism_plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": in_bytes + out_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "id_agree": prism_id_agree,
        "pairs": prism_pairs,
        "evaluated": prism_evaluated,
    })
    del prism_scene, csr, k_out, p_out

    # 13. The triangle path: N_FRAMES frames through render_opaque.
    mesh = tornado_tube_mesh(dev, num_subdivisions=PRISM_SIDES, traj=traj)
    table = torch.as_tensor(TransferFunction.standard().table, device=dev)
    render_opaque(mesh, cams[0][0], cams[0][1], table, settings)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ev = [_events() for _ in cams]
    imgs_sum = torch.zeros((), device=dev)
    for (a, b), cam in zip(frame_ev, cams):
        a.record()
        img = render_opaque(mesh, cam[0], cam[1], table, settings)
        b.record()
        imgs_sum += img[:3].sum()
    torch.cuda.synchronize()
    tri_launches = only_launched("triangle_raster")
    tri_peak_bytes = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite triangle frame on the main path")
    tri_frame_ms = [a.elapsed_time(b) for a, b in frame_ev]

    def tri_binning(batch, payload):
        return raster_pallas.build_csr_binning(
            batch.tri_x, batch.tri_y, payload, batch.tri_valid, W, H,
            settings.tile_w, settings.tile_h, settings.chunk, settings.span_x,
            settings.span_y, settings.pairs_capacity,
        )

    def tri_shade(csr, raster, batch, cam):
        gbuf, _ = untile_gbuffer(csr, raster, settings)
        return shade_gbuffer(gbuf, table, cam[1], _ray_basis_from_view_proj(cam[0]),
                             batch.view_z_min, batch.view_z_max, settings)

    stage_ms = {"vertex_payload": [], "csr_binning": [], "kernel": [], "untile_shade": []}
    for cam in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        batch = tube_vertex_stage(mesh, cam[0], W, H)
        payload = build_payload(batch)
        ev[1].record()
        csr = tri_binning(batch, payload)
        ev[2].record()
        raster = raster_pallas.rasterize_gbuffer(csr, TRIANGLE_PLANES, 32, 16)
        ev[3].record()
        tri_shade(csr, raster, batch, cam)
        ev[4].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stage_ms, zip(ev[:-1], ev[1:])):
            stage_ms[k].append(a.elapsed_time(b))
        del batch, payload, csr, raster

    # 14. The triangle kernel vs its plain version on frame 0's CSR.
    batch = tube_vertex_stage(mesh, cams[0][0], W, H)
    csr = tri_binning(batch, build_payload(batch))
    n_tiles = csr.tile_chunk_base.shape[0]
    C = csr.chunk
    tri_overflow = int(csr.overflow)
    tri_chunks = int(csr.tile_num_chunks.sum())
    real = (csr.payload[15] < 2.5).sum(dim=1)  # real (not padded) slots per chunk
    tri_pairs = int(real.sum())
    tri_line = {
        "frame_ms_median": float(np.median(tri_frame_ms)),
        "fps": 1000.0 / float(np.median(tri_frame_ms)),
        "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "triangles": mesh.num_triangles, "valid_triangles": int(batch.tri_valid.sum()),
        "pairs": tri_pairs, "chunks": tri_chunks, "overflow": tri_overflow,
        "payload_chunks_capacity": int(csr.payload.shape[1]),
        "peak_memory_bytes": tri_peak_bytes,
        "frames": N_FRAMES, "width": W, "height": H, "gpu": gpu,
    }
    print("triangle frame: " + json.dumps(tri_line), flush=True)
    if tri_overflow:
        raise RuntimeError(f"the triangle binning dropped {tri_overflow} pairs")

    work = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    k_out = raster_pallas.rasterize_gbuffer(csr, TRIANGLE_PLANES, 32, 16, work=work)
    stats = {}
    p_out = raster_pallas.rasterize_triangles_reference(
        csr, 32, 16, TRIANGLE_PLANES, stats=stats
    )
    torch.cuda.synchronize()
    # Real slots in the chunks each tile evaluated after early-z.
    cum = torch.cat([real.new_zeros(1), torch.cumsum(real, 0)])
    base = csr.tile_chunk_base.long()
    tri_evaluated = int((cum[base + work.long()] - cum[base]).sum())
    tri_chunks_evaluated = int(work.sum())
    tri_ids_equal = bool(torch.equal(k_out[1], p_out[1]))
    tri_depth_equal = bool(torch.equal(k_out[0], p_out[0]))
    tri_id_agree = float((k_out[1] == p_out[1]).float().mean())
    tri_max = max(float((a - b).abs().max())
                  for a, b in zip([k_out[0], *k_out[2]], [p_out[0], *p_out[2]]))
    tri_img = tri_shade(csr, k_out, batch, cams[0]).permute(1, 2, 0).cpu().numpy()
    img_p_np = tri_shade(csr, p_out, batch, cams[0]).permute(1, 2, 0).cpu().numpy()
    img_ssim = ssim(tri_img[..., :3], img_p_np[..., :3])
    img_mad = float(np.abs(tri_img - img_p_np).mean())
    fg = float((k_out[1] >= 0).float().mean())
    print(f"triangle_raster vs plain: pairs {tri_pairs}, chunks {tri_chunks}, evaluated "
          f"after early-z {tri_chunks_evaluated} chunks / {tri_evaluated} pairs, updates "
          f"{stats['takes']}, ids equal {tri_ids_equal} ({tri_id_agree:.6f}), depth equal "
          f"{tri_depth_equal}, max |dz, dplanes| {tri_max:.3g}, image ssim {img_ssim:.6f}, "
          f"mean abs {img_mad:.3g}, foreground {fg:.4f}", flush=True)
    if not np.isfinite(tri_img).all():
        raise RuntimeError("non-finite pixels in the 1080p triangle frame")
    if not (tri_ids_equal and tri_depth_equal) or tri_max > 1e-5:
        raise RuntimeError("triangle kernel disagrees with its plain version")
    if img_ssim < 0.999 or img_mad > 2e-3:
        raise RuntimeError("triangle kernel image disagrees with the plain version's")
    if fg < 0.01:
        raise RuntimeError("the triangle tornado frame is almost empty")
    card_vs_cpu(entry_triangle, "entry_triangle")

    # The parity pair: the prism frame against the triangle frame of camera 0.
    parity_ssim = ssim(prism_img[..., :3].mean(-1), tri_img[..., :3].mean(-1))
    parity_mad = float(np.abs(prism_img - tri_img).mean())
    tri_fg = unpack_tiles(k_out[1] >= 0, csr.tiles_x, csr.tiles_y, 32, 16, W, H)
    prism_only = float((prism_fg & ~tri_fg).float().mean())
    tri_only = float((tri_fg & ~prism_fg).float().mean())
    print(f"prism vs triangle frame (camera 0, on the card): ssim {parity_ssim:.6f}, "
          f"mean abs {parity_mad:.3g}; pixels covered by the prism frame only "
          f"{prism_only:.5f}, by the triangle frame only {tri_only:.5f}", flush=True)
    if parity_ssim < 0.9:
        raise RuntimeError("the prism frame does not look like the triangle frame")

    tri_ms = _time_ms(
        lambda: raster_pallas.rasterize_gbuffer(csr, TRIANGLE_PLANES, 32, 16), 20
    )
    tri_plain_ms = _time_ms(
        lambda: raster_pallas.rasterize_triangles_reference(csr, 32, 16, TRIANGLE_PLANES), 1
    )
    rows = 16 + 3 * TRIANGLE_PLANES
    out_bytes = (2 + TRIANGLE_PLANES) * n_tiles * P * 4
    in_bytes = tri_evaluated * rows * 4 + 2 * n_tiles * 4
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = (tri_evaluated * P * TRIANGLE_OPS_PER_EVAL
             + stats["takes"] * TRIANGLE_OPS_PER_TAKE) / H100_FP32_FLOPS * 1e3
    kernels.append({
        "name": "triangle_raster",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/raster_triangle.cu",
        "replaces": "linevis_tpu/kernels/raster_pallas.py:427",
        "launches": tri_launches,
        "max_abs_err": tri_max,
        "ms": tri_ms,
        "plain_ms": tri_plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": in_bytes + out_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "id_agree": tri_id_agree,
        "pairs": tri_pairs,
        "chunks": tri_chunks,
        "evaluated": tri_evaluated,
        "chunks_evaluated": tri_chunks_evaluated,
        "updates": stats["takes"],
        "prism_vs_triangle_ssim": parity_ssim,
        "prism_only_pixels": prism_only,
        "triangle_only_pixels": tri_only,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
