"""The linear (Morton) BVH builder beside the binned-SAH one on the tornado.

`render/ray_tracer.py:build_capsule_bvh` parks masked segments far away
(1e7) and `ops/lbvh.py:build_lbvh` normalizes the centroids by the bounds of
all boxes, the parked ones included. This script counts the distinct Morton
codes of the tornado's real segments with and without the parked boxes in
the bounds, then traces the same 1920x1080 primary rays (the first orbit
camera of `chip_smoke.py`, tile 16x8, K=8, opacity 0.3) through both trees
with the wavefront kernel and reports set-up seconds, groups, group visits,
leaf rows, deepest stack, kernel ms and the difference of the two images.

    python -m linevis_tpu_torch.automation.linear_bvh [OUT_JSON]

runs on the card and prints one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

__all__ = ["linear_vs_binned_sah"]

_PARKED = 1e7  # where build_capsule_bvh puts masked segments


def _distinct_codes(scene):
    """Distinct Morton codes of the valid segments' centroids: normalized by
    their own bounds, and by bounds that include a box parked at 1e7."""
    from linevis_tpu_torch.ops.lbvh import morton_codes

    lo = torch.minimum(scene.a, scene.a + scene.ba).T[scene.mask]
    hi = torch.maximum(scene.a, scene.a + scene.ba).T[scene.mask]
    cen = 0.5 * (lo + hi)
    lo_real, hi_real = lo.amin(0), hi.amax(0)
    lo_all = torch.clamp(lo_real, max=_PARKED)
    hi_all = torch.clamp(hi_real, min=_PARKED)
    real = morton_codes((cen - lo_real) / (hi_real - lo_real))
    parked = morton_codes((cen - lo_all) / (hi_all - lo_all))
    return int(torch.unique(real).numel()), int(torch.unique(parked).numel())


def linear_vs_binned_sah(scene, camera, settings, K=8, opacity=0.3, reps=3) -> dict:
    """Trace `camera`'s primary rays through the linear and the binned-SAH
    tree of `scene` (module docstring). camera: (view_proj, cam_pos, ab)
    tensors on the scene's device."""
    from linevis_tpu_torch.entry import tornado_wide_bvh
    from linevis_tpu_torch.kernels.bvh_wavefront import STATS, trace_wavefront_kbuffer
    from linevis_tpu_torch.render.ray_tracer import primary_rays, resolve_wavefront_nodes

    rays = primary_rays(camera[0], camera[1], settings, 1e6)
    n_blocks = rays.shape[1] // 128
    out, images = {}, {}
    for builder in ("linear", "binned_sah"):
        groups, setup = tornado_wide_bvh(scene, builder=builder)

        def trace(**kw):
            return trace_wavefront_kbuffer(groups, rays, camera[2], K=K, opacity=opacity,
                                           tf_opacity=settings.tf_opacity, **kw)

        stats = torch.zeros((n_blocks, len(STATS)), dtype=torch.int64, device=rays.device)
        nodes = trace(stats=stats)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            trace()
        b.record()
        torch.cuda.synchronize()
        img = resolve_wavefront_nodes(scene, nodes, camera[0], camera[2], settings)
        images[builder] = img.permute(1, 2, 0).cpu().numpy()
        by = dict(zip(STATS, stats.sum(dim=0).tolist()))
        out[builder] = {
            "bvh_build_s": setup["build_s"], "bvh_pack_s": setup["pack_s"],
            "groups": groups.shape[0] // 8, "kernel_ms": a.elapsed_time(b) / reps,
            "visits": by["visits"], "leaf_rows": by["leaf_rows"],
            "max_stack": int(stats[:, STATS.index("max_stack")].max()),
        }
        del groups, nodes, stats
    diff = np.abs(images["linear"] - images["binned_sah"])
    real, parked = _distinct_codes(scene)
    return {
        "distinct_morton_codes_of_real_segments": real,
        "with_masked_segments_parked_at_1e7": parked,
        **out,
        "image_max_abs_diff": float(diff.max()),
        "pixels_off_by_more_than_1e-4": float((diff.max(axis=-1) > 1e-4).mean()),
        "rays": rays.shape[1], "K": K,
    }


def main(out_json: str = None) -> int:
    from linevis_tpu_torch.entry import tornado_scene
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import camera_tensors

    if not torch.cuda.is_available():
        raise SystemExit("linear_bvh: no CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    W, H = 1920, 1080
    dev = torch.device("cuda", 0)
    scene = tornado_scene(dev)
    camera = Camera(position=(0.0, 0.1, 1.2), width=W, height=H).orbit(0.002, 0.1, 1.2)
    result = linear_vs_binned_sah(
        scene, camera_tensors(camera, dev),
        RasterSettings(width=W, height=H, tile_w=16, tile_h=8),
    )
    result["gpu"] = gpu
    line = json.dumps(result)
    if out_json:
        with open(out_json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:2]))
