"""How far one ulp of input moves the reference configs' frames, on the CPU.

A one-off reading beside `chip_smoke.py`, not part of the port's package.
On the port's plain versions (the CPU), it draws configs 2 (Per-Pixel
Linked Lists, K=32) and 5 (opacity optimization) of `entry.BASELINE_CONFIGS`
at the given scales twice: on the tornado, and on the tornado with every
position moved one ulp up. Then, for config 5's first frame, it moves the
importance gather's values by one ulp before the opacity solve, and the
solved vertex opacities by one ulp before the final render. It prints one
JSON line: the SSIM and mean abs difference of each pair of frames, and the
largest change of the solve's output. It explains why `chip_smoke.py` holds
config 5 card vs CPU stage by stage.

    python3 tools/ulp_sensitivity.py [SCALE ...]   # default 0.1 0.2; ~2 min
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch


def main(scales) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from linevis_tpu_torch.entry import BASELINE_CONFIGS, tornado_line_data
    from linevis_tpu_torch.render import opacity_optimization as oo_mod
    from linevis_tpu_torch.render.framebuffer import ssim
    from linevis_tpu_torch.render.tube_raster import camera_tensors
    from linevis_tpu_torch.scene.line_data import LineData

    def compare(a, b):
        return {"ssim": ssim(a[..., :3], b[..., :3]), "mean_abs": float(np.abs(a - b).mean())}

    ld = tornado_line_data("cpu")
    t = ld.trajectories
    moved = LineData(dataclasses.replace(
        t, positions=np.nextafter(t.positions, np.float32(np.inf)).astype(np.float32)))
    moved.set_line_width(ld.line_width)
    out = {}
    for scale in scales:
        for name in ("cfg2_tornado_ppll_1080p", "cfg5_tornado_opacityopt_1080p"):
            a, b = (BASELINE_CONFIGS[name](device="cpu", scale=scale, line_data=x).render()
                    for x in (ld, moved))
            out[f"{name} at {scale}, positions + 1 ulp"] = compare(a, b)

    run = BASELINE_CONFIGS["cfg5_tornado_opacityopt_1080p"](device="cpu", scale=scales[0],
                                                            line_data=ld)
    cam = run.cameras[0]
    s = run.renderer._raster_settings(cam)
    scene = ld.get_capsule_scene(device="cpu")
    oo = oo_mod.OpacityOptimizationSettings()
    ct = camera_tensors(cam, "cpu")
    depths, g, sid = oo_mod.gather_importance(scene, *ct, s, oo)
    prev = torch.ones((t.num_lines, t.max_points))

    def solve(g_):
        return oo_mod.solve_vertex_opacity(depths, g_, sid, prev, oo, t.num_lines,
                                           t.max_points, scene.num_segments)

    def render(v):
        return oo_mod.final_render(scene, *ct, v, s, oo.render_k).permute(1, 2, 0).numpy()

    v = solve(g)
    up = torch.tensor(2.0)
    out["cfg5 solve, gather values + 1 ulp: max |d opacity|"] = float(
        (solve(torch.nextafter(g, up)) - v).abs().max())
    out["cfg5 final render, opacities + 1 ulp"] = compare(render(v),
                                                          render(torch.nextafter(v, up)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main([float(x) for x in sys.argv[1:]] or [0.1, 0.2]))
