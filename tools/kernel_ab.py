"""The port's hand-written kernels (B1-B6, R1-R5, R7, R8) timed across source trees.

A one-off A/B script beside `chip_smoke.py`, not part of the port's
package. It compares two or more source trees of this repository on one
card, in turns, so that a change to a kernel under `csrc/` can be held
against its parent (unpack the parent with `git archive` into a directory that
`.gitignore` lists). Each turn is a fresh process in the tree's root, which
builds the tree's own kernels and times, on the first orbit camera of
`chip_smoke.py` over the 1920x1080 tornado (tile 16x8):
  - the MLAB composite (K=8, opacity 0.3, deferred shading, sub 32, sat
    0.999);
  - the exact peel pass (K=8, per-fragment shading behind the depth of an
    exact K=8 pass: depth peeling's second pass) and the same with the
    MLAB merge (MLAB buckets' second pass);
  - the Atomic Loop's exact K-buffer at K=16 and K=32 (per-fragment
    shading, no_overflow), and the Per-Pixel Linked Lists composite (the
    MLAB composite at K=32);
  - at 32x16 tiles, K=32: the composite and the exact K-buffer (the one
    K-buffer instance whose nodes do not fit in shared memory);
  - where the tree has `use_bands`, its two K-buffer cases at
    `chip_smoke.py`'s 480x272 frame: the composite, and per-fragment
    shading behind an exact pass;
  - where the tree has it, the opacity optimization's 'gather' at 960x528
    (K=8);
  - the accumulation kernel (`accum`): 'count' and 'wboit' on the capsule
    binning, 'mboit_gen' and 'mboit_resolve' with 4, 6 and 8 power and
    trigonometric moments on `prepare_mboit_frame`'s (each resolve on its
    tree's own pass-1 moments), and 'wboit' and 'mboit_resolve' (4 power
    moments) with `use_bands` at 480x272. Every output plane of every case
    is held bit for bit (`torch.equal` of the int32 views) against the
    first tree's, which its first turn saves in a temporary file;
  - B5 (`trace_pairs`) on the first batch of rays of `chip_smoke.py`'s
    first RTAO frame (tile 32x16);
  - B4 (8 sides) at 32x16 and 16x8; B6 at K=8 (MLAB merge and
    `no_overflow`), K=16 and K=32 on the binned-SAH tree (10 launches);
  - B1 at 32x16 with AA (the capsule frame) and without (the RTAO
    G-buffer's pass), and at 16x8 with AA;
  - B3 at 32x16 (chunk 128) with 8 attribute planes and depth only;
each the mean of 40 launches between CUDA events;
  - R1 (`r1`): the ray tracer's re-cast loop on the 1080p tornado's
    tile-ordered rays over the linear tree (32 casts, opacity 0.3): the
    tree's `render/ray_tracer.py:capsule_recast` where it has one (the
    whole loop in one launch), else `trace_recast` over its one-cast `capsule_closest_hit`
    (32 launches and the per-cast PyTorch state update); every cast's
    (t, prim) is held bit for bit against the first tree's (SHA-256 of each
    cast's planes) and the color and transmittance within 1e-5; the loop
    and `render_tubes_raytraced`'s frame, each the mean of 5;
  - R2 (`r2`): `mlat_nodes` on the same rays at K 8, 16 and 32, the nodes
    held bit for bit against the first tree's, each the mean of 5;
  - R3 (`r3`): `vpt_tracking` on `chip_smoke.py`'s first path-traced
    sample (the 512^3 cloud of `entry.procedural_cloud`, 1920x1080 rays,
    Delta tracking, trilinear, 512 events), every output and the events per
    ray held bit for bit against the first tree's, the mean of 10;
  - R4 (`r4`): `density_march` on `chip_smoke.py`'s 1080p density-map
    frame (the line density field of `entry.scattering_line_data`, traced
    by the first turn and handed on in a temporary file), and on the same
    field in a box of extent 0.375 under an opacity of 0.2 at density 0
    (the kernel's IEEE divisions, nothing to skip), both held bit for bit
    against the first tree's, the means of 10 and 5;
  - R5 (`r5`): `heatmap_density` on a 1080x2160 map of the exit directions
    of `entry.scattering_line_data` (traced by the first turn, handed on in
    a temporary file), held bit for bit against the first tree's, the mean
    of 5;
  - R7 (`r7`) and R8 (`r8`): `vpt_decomposition` and `vpt_residual_ratio`
    on R3's sample (the smoke's defaults: extinction 1024, albedo 1,
    isotropic, 512 events; super voxels of 8; R8's caps 10 / 64 / 256),
    every output and the events (R7) or steps (R8) per ray held bit for bit
    against the first tree's, the mean of 5.

    python3 tools/kernel_ab.py TREE [TREE ...] [--turns N]
        [--kernels b2,b5,b4,b6,b1,b3,accum,r1,r2,r3,r4,r5,r7,r8]

runs the trees in the order given, then reversed, N times (default 2),
printing one JSON line per turn and a last line with the card and every
turn. On a tree's first turn, which builds its kernel sources anew,
the line also holds each source's build cost: nvcc's seconds (compiled one
after the other), the number of kernel instances ptxas compiled, the
library's bytes and its ptxas register and spill lines.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

__all__ = ["main"]

_CHILD = r'''
import json, os, sys, torch
import numpy as np
from linevis_tpu_torch.kernels import _build
groups_file, kernels = sys.argv[2], sys.argv[3].split(",")
sources = {"b2": ("raster_capsule_oit",), "b5": ("ao_grid",),
           "b4": ("raster_prism",), "b6": ("bvh_wavefront",), "b1": ("raster_capsule",),
           "b3": ("raster_triangle",), "accum": ("raster_capsule_accum",),
           "r1": ("bvh_closest_hit",), "r2": ("bvh_mlat",), "r3": ("vpt_tracking",),
           "r4": ("density_march",), "r5": ("spherical_heatmap",),
           "r7": ("vpt_decomposition",), "r8": ("vpt_residual_ratio",)}
info = {}
for name in [n for k in kernels for n in sources[k]]:
    if sys.argv[1] == "rebuild":  # a tree's first turn: time its build
        _build._lib_path(name).unlink(missing_ok=True)
    info.update(_build.build([name]))  # one after the other: each nvcc timed alone
from linevis_tpu_torch.entry import tornado_scene, tornado_trajectories
from linevis_tpu_torch.kernels.raster_capsule_oit import rasterize_capsules_mlab
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.oit import prepare_mlab_frame
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.tube_raster import camera_tensors, prepare_capsule_frame

dev = "cuda"
if set(kernels) - {"r3", "r4", "r5", "r7", "r8"}:  # the volume kernels draw the cloud
    traj = tornado_trajectories(dev)
    scene = tornado_scene(dev, traj=traj)
W, H = 1920, 1080
s = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
cam = camera_tensors(
    Camera(position=(0.0, 0.1, 1.2), width=W, height=H).orbit(0.002, 0.1, 1.2), dev)


def timed(fn, n=40):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


log = info.get("raster_capsule_oit", {}).get("log", "")
res = {"ptxas": [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l][-2:]}
res["build"] = {
    name: {"nvcc_s": b["seconds"], "instances": b["log"].count("Compiling entry function"),
           "library_bytes": _build._lib_path(name).stat().st_size,
           "ptxas": [l.split(":")[-1].strip() for l in b["log"].splitlines()
                     if "Used" in l or "spill" in l]}
    for name, b in info.items()}


def b2():
    csr, params = prepare_mlab_frame(scene, *cam, s, 0.3)
    res["composite"] = timed(lambda: rasterize_capsules_mlab(
        csr, params, W, H, 16, 8, 8, s.tf_color, s.tf_opacity, deferred_shade=True, sub=32,
        sat=0.999, composite=True))
    kargs = (csr, params, W, H, 16, 8, 8, s.tf_color, s.tf_opacity)
    d1, _, _ = rasterize_capsules_mlab(*kargs, no_overflow=True)
    peel = torch.where(d1 < 1.5, d1, -1.0).amax(dim=0).contiguous()
    res["peel_exact"] = timed(lambda: rasterize_capsules_mlab(*kargs, peel=peel, no_overflow=True))
    res["peel_merge"] = timed(lambda: rasterize_capsules_mlab(*kargs, peel=peel))
    for k_al in (16, 32):  # the Atomic Loop's exact K-buffer (per-fragment shading)
        res[f"atomic_loop_k{k_al}"] = timed(lambda: rasterize_capsules_mlab(
            csr, params, W, H, 16, 8, k_al, s.tf_color, s.tf_opacity, no_overflow=True))
    res["composite_k32"] = timed(lambda: rasterize_capsules_mlab(
        csr, params, W, H, 16, 8, 32, s.tf_color, s.tf_opacity, deferred_shade=True, sub=32,
        sat=0.999, composite=True))
    s4 = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    csr4, params4 = prepare_mlab_frame(scene, *cam, s4, 0.3)
    args4 = (csr4, params4, W, H, 32, 16, 32, s4.tf_color, s4.tf_opacity)
    res["composite_k32_32x16"] = timed(lambda: rasterize_capsules_mlab(
        *args4, deferred_shade=True, sub=32, sat=0.999, composite=True))
    res["atomic_loop_k32_32x16"] = timed(lambda: rasterize_capsules_mlab(
        *args4, no_overflow=True))
    s2 = RasterSettings(width=960, height=528, tile_w=16, tile_h=8)
    csr2, params2, _ = prepare_capsule_frame(scene, *cam, s2)
    try:
        res["gather"] = timed(lambda: rasterize_capsules_mlab(
            csr2, params2, 960, 528, 16, 8, 8, s2.tf_color, s2.tf_opacity,
            store_mode="gather"))
    except (NotImplementedError, ValueError):
        pass  # a tree from before the gather mode
    # use_bands at chip_smoke.py's reduced frame (480x272): the composite and
    # per-fragment shading behind the depth of an exact pass.
    s3 = RasterSettings(width=480, height=272, tile_w=16, tile_h=8)
    cam3 = camera_tensors(
        Camera(position=(0.0, 0.1, 1.2), width=480, height=272).orbit(0.002, 0.1, 1.2), dev)
    csr3, params3 = prepare_mlab_frame(scene, *cam3, s3, 0.3)
    args3 = (csr3, params3, 480, 272, 16, 8, 8, s3.tf_color, s3.tf_opacity)
    try:
        d3, _, _ = rasterize_capsules_mlab(*args3, no_overflow=True, use_bands=True)
        peel3 = torch.where(d3 < 1.5, d3, -1.0).amax(dim=0).contiguous()
        res["bands_composite"] = timed(lambda: rasterize_capsules_mlab(
            *args3, deferred_shade=True, composite=True, use_bands=True))
        res["bands_peel"] = timed(lambda: rasterize_capsules_mlab(
            *args3, peel=peel3, no_overflow=True, use_bands=True))
    except TypeError:
        pass  # a tree from before use_bands


def accum():
    from linevis_tpu_torch.render.oit import prepare_mboit_frame

    def planes(out):
        return [out[0], out[1].flatten(0, 1), out[2]]

    def moments_of(gen, n_mom):
        d, rgb, a = gen
        nh = n_mom // 2
        return torch.stack([d[0], *(rgb[0, 0], rgb[1, 0], rgb[2, 0], a[0])[:nh],
                            *(d[1], rgb[0, 1], rgb[1, 1], rgb[2, 1])[:nh]]).contiguous()

    cases = {}
    csr_w, params_w, _ = prepare_capsule_frame(scene, *cam, s)
    params_w[14] = 0.3
    for mode in ("count", "wboit"):
        cases[mode] = (lambda mode=mode: rasterize_capsules_mlab(
            csr_w, params_w, W, H, 16, 8, 1, s.tf_color, s.tf_opacity, store_mode=mode))
    for trig in (False, True):
        for n_mom in (4, 6, 8):
            key = f"{'trig' if trig else 'power'}{n_mom}"
            csr_m, params_m, _ = prepare_mboit_frame(scene, *cam, s, n_mom, 0.3,
                                                     trigonometric=trig)
            margs = (csr_m, params_m, W, H, 16, 8)
            kw = dict(tf_color=s.tf_color, tf_opacity=s.tf_opacity, n_mom=n_mom, trig=trig)
            cases[f"mboit_gen_{key}"] = (lambda margs=margs, kw=kw: rasterize_capsules_mlab(
                *margs, 2, store_mode="mboit_gen", **kw))
            mom = moments_of(cases[f"mboit_gen_{key}"](), n_mom)
            cases[f"mboit_resolve_{key}"] = (lambda margs=margs, kw=kw, mom=mom:
                                             rasterize_capsules_mlab(
                                                 *margs, 1, store_mode="mboit_resolve",
                                                 moments=mom, **kw))
    # use_bands at chip_smoke.py's reduced frame (480x272).
    s3 = RasterSettings(width=480, height=272, tile_w=16, tile_h=8)
    cam3 = camera_tensors(
        Camera(position=(0.0, 0.1, 1.2), width=480, height=272).orbit(0.002, 0.1, 1.2), dev)
    csr3, params3, _ = prepare_capsule_frame(scene, *cam3, s3)
    params3[14] = 0.3
    cases["bands_wboit"] = lambda: rasterize_capsules_mlab(
        csr3, params3, 480, 272, 16, 8, 1, s3.tf_color, s3.tf_opacity, store_mode="wboit",
        use_bands=True)
    csr3m, params3m, _ = prepare_mboit_frame(scene, *cam3, s3, 4, 0.3)
    mom3 = moments_of(rasterize_capsules_mlab(csr3m, params3m, 480, 272, 16, 8, 2, s3.tf_color,
                                              s3.tf_opacity, store_mode="mboit_gen", n_mom=4),
                      4)
    cases["bands_mboit_resolve"] = lambda: rasterize_capsules_mlab(
        csr3m, params3m, 480, 272, 16, 8, 1, s3.tf_color, s3.tf_opacity,
        store_mode="mboit_resolve", n_mom=4, moments=mom3, use_bands=True)

    ref_file = os.path.join(os.path.dirname(groups_file), "accum_first_tree.pt")
    outs = {k: [x.view(torch.int32).cpu() for x in planes(fn())] for k, fn in cases.items()}
    if os.path.exists(ref_file):
        ref = torch.load(ref_file)
        res["accum_equal_to_first_tree"] = {
            k: all(torch.equal(a, b) for a, b in zip(v, ref[k])) for k, v in outs.items()}
    else:
        torch.save(outs, ref_file)
    del outs
    for k, fn in cases.items():
        res[f"accum_{k}"] = timed(fn)


def b5():
    from linevis_tpu_torch.entry import tornado_segment_grid
    from linevis_tpu_torch.kernels import ao_grid
    from linevis_tpu_torch.render.rtao import RtaoSettings, ray_batches, rtao_gbuffer, rtao_rays
    rt = RtaoSettings()
    grid = tornado_segment_grid(scene, rt.grid_resolution)
    gbuf = rtao_gbuffer(scene, *cam, RasterSettings(width=W, height=H, tile_w=32, tile_h=16))
    gen = torch.Generator(device=dev).manual_seed(rt.seed)
    u1 = torch.rand((rt.num_samples, H, W), generator=gen, device=dev)
    u2 = torch.rand((rt.num_samples, H, W), generator=gen, device=dev)
    o, d, t_max, valid = rtao_rays(gbuf, scene.radius, rt, u1, u2)
    b0, b1 = ray_batches(o.shape[1], rt.rays_per_batch)[0]
    pairs = ao_grid.expand_ray_pairs(o[:, b0:b1], d[:, b0:b1], t_max[b0:b1], valid[b0:b1],
                                     grid, rt.max_ray_cells)
    res["ao_grid"] = timed(lambda: ao_grid.trace_pairs(
        pairs.rays, pairs.seg_begin, pairs.seg_chunks, grid.records, grid.chunk))


def b4():
    from linevis_tpu_torch.entry import tornado_prism_scene
    from linevis_tpu_torch.kernels.raster_prism import rasterize_prisms
    from linevis_tpu_torch.render.tube_raster import prepare_prism_frame
    prism_scene = tornado_prism_scene(dev, n_sides=8, traj=traj)
    for tw, th in ((32, 16), (16, 8)):
        sp = RasterSettings(width=W, height=H, tile_w=tw, tile_h=th)
        csr, params, _ = prepare_prism_frame(prism_scene, *cam, sp)
        res[f"prism_{tw}x{th}"] = timed(lambda: rasterize_prisms(
            csr, params, W, H, tw, th, n_sides=8))


def b6():
    from linevis_tpu_torch.entry import tornado_wide_bvh
    from linevis_tpu_torch.kernels.bvh_wavefront import trace_wavefront_kbuffer
    from linevis_tpu_torch.render.ray_tracer import primary_rays
    if os.path.exists(groups_file):
        groups = torch.load(groups_file).to(dev)
    else:  # the run's first turn builds the tree for every turn
        groups, _ = tornado_wide_bvh(scene, builder="binned_sah")
        torch.save(groups.cpu(), groups_file)
    rays = primary_rays(cam[0], cam[1], s, 1e6)
    for name, K, no_overflow in (("wavefront_k8", 8, False), ("wavefront_k8_no_overflow", 8, True),
                                 ("wavefront_k16", 16, False), ("wavefront_k32", 32, False)):
        res[name] = timed(lambda: trace_wavefront_kbuffer(
            groups, rays, cam[2], K=K, opacity=0.3, tf_opacity=s.tf_opacity,
            no_overflow=no_overflow), n=10)


def b1():
    from linevis_tpu_torch.kernels.raster_capsule import rasterize_capsules
    # The capsule frame (AA, 0.5 px of cull slack) at both tiles, and the
    # RTAO G-buffer's pass (no AA, no slack).
    for key, tw, th, aa in (("capsule_aa_32x16", 32, 16, True),
                            ("capsule_no_aa_32x16", 32, 16, False),
                            ("capsule_aa_16x8", 16, 8, True)):
        sc = RasterSettings(width=W, height=H, tile_w=tw, tile_h=th)
        csr, params, _ = prepare_capsule_frame(scene, *cam, sc, aa_margin=0.5 if aa else 0.0)
        res[key] = timed(lambda csr=csr, params=params, tw=tw, th=th, aa=aa: rasterize_capsules(
            csr, params, W, H, tw, th, use_aa=aa))


def b3():
    from linevis_tpu_torch.entry import tornado_tube_mesh
    from linevis_tpu_torch.kernels import raster_pallas
    from linevis_tpu_torch.render.pipeline import build_payload, tube_vertex_stage
    st = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    batch = tube_vertex_stage(tornado_tube_mesh(dev, num_subdivisions=8, traj=traj), cam[0], W, H)
    csr = raster_pallas.build_csr_binning(
        batch.tri_x, batch.tri_y, build_payload(batch), batch.tri_valid, W, H, 32, 16,
        st.chunk, st.span_x, st.span_y, st.pairs_capacity)
    del batch
    res["triangle_gbuffer_32x16"] = timed(lambda: raster_pallas.rasterize_gbuffer(csr, 8, 32, 16))
    res["triangle_depth_32x16"] = timed(lambda: raster_pallas.rasterize_depth(csr, 32, 16))


def _ray_tracer_inputs():
    from linevis_tpu_torch.ops.lbvh import lbvh_on
    from linevis_tpu_torch.render import ray_tracer as rt
    s_rt = RasterSettings(width=W, height=H)
    tree = lbvh_on(rt.build_capsule_bvh(scene), dev)
    o, d, wz, pad = rt.tile_rays(cam[0], cam[1], s_rt)
    return rt, s_rt, tree, o, d, wz, pad


def _against_first_tree(name, digests, tensors=()):
    """Hold this tree's per-plane SHA-256 digests (and `tensors` within
    1e-5) against the first tree's, which its first turn saves."""
    ref_file = os.path.join(os.path.dirname(groups_file), f"{name}_first_tree.pt")
    cur = {"digests": digests, "tensors": [t.cpu() for t in tensors]}
    if os.path.exists(ref_file):
        ref = torch.load(ref_file)
        res[f"{name}_equal_to_first_tree"] = digests == ref["digests"]
        res[f"{name}_first_differing_plane"] = next(
            (i for i, (a, b) in enumerate(zip(digests, ref["digests"])) if a != b), None)
        res[f"{name}_max_abs_vs_first_tree"] = max(
            [float((a - b).abs().max()) for a, b in zip(cur["tensors"], ref["tensors"])],
            default=0.0)
    else:
        torch.save(cur, ref_file)


def _digest(x):
    import hashlib
    return hashlib.sha256(x.contiguous().view(torch.int32).cpu().numpy().tobytes()).hexdigest()


def r1():
    from linevis_tpu_torch.kernels import bvh_closest_hit as ch
    rt, s_rt, tree, o, d, wz, pad = _ray_tracer_inputs()
    dmin, dmax = rt._depth_cue_range(scene, cam[0])
    casts, R = 32, o.shape[0]
    rec = (torch.empty((casts, R), device=dev), torch.empty((casts, R), dtype=torch.int32,
                                                           device=dev))
    args = (tree, scene, o, d, wz, pad, cam[2], s_rt, casts, 0.3, dmin, dmax)
    if hasattr(rt, "capsule_recast"):
        acc, T = rt.capsule_recast(*args, record=rec)

        def loop():
            return rt.capsule_recast(*args)
    else:  # a tree from before the loop kernel: 32 launches of the one-cast kernel
        k = [0]

        def hit(*a):
            t, prim = ch.capsule_closest_hit(*a)
            rec[0][k[0]], rec[1][k[0]] = t, prim
            k[0] += 1
            return t, prim

        acc, T = rt.trace_recast(*args, closest_hit=hit)

        def loop():
            return rt.trace_recast(*args)
    digests = [_digest(rec[0][c]) + _digest(rec[1][c]) for c in range(casts)]
    _against_first_tree("r1", digests, (acc, T))
    res["r1_hits_first_cast"] = int((rec[1][0] >= 0).sum())
    del rec
    res["r1_loop"] = timed(loop, n=5)
    res["r1_recast_frame"] = timed(lambda: rt.render_tubes_raytraced(
        scene, *cam, s_rt, max_depth_complexity=casts, opacity=0.3, bvh=tree), n=5)


def r2():
    from linevis_tpu_torch.kernels.bvh_mlat import mlat_nodes
    rt, s_rt, tree, o, d, wz, pad = _ray_tracer_inputs()
    digests = []
    for K in (8, 16, 32):
        def run(K=K):
            return mlat_nodes(tree, scene, o, d, wz, pad, cam[2], K=K, opacity=0.3,
                              tf_opacity=s_rt.tf_opacity)

        digests += [_digest(x) for x in run()]
        res[f"r2_mlat_k{K}"] = timed(run, n=5)
    _against_first_tree("r2", digests)
    res["r2_mlat_frame"] = timed(lambda: rt.render_tubes_mlat(
        scene, *cam, s_rt, K=8, opacity=0.3, bvh=tree), n=5)


_CLOUD = {}


def _cloud_sample():
    """R3's sample: the 512^3 cloud, the smoke's camera, its 1080p rays and
    trace key, the renderer's defaults (made once a process)."""
    if not _CLOUD:
        from linevis_tpu_torch import entry
        from linevis_tpu_torch.ops import threefry
        from linevis_tpu_torch.render.tube_raster import _ray_basis
        from linevis_tpu_torch.render.vpt import VptSettings, primary_rays
        grid = entry.procedural_cloud(dev)
        cv = camera_tensors(Camera(position=(0.0, 0.15, 0.9), look_at_point=(0.0, 0.0, 0.0),
                                   width=W, height=H), dev)
        _, kt, o, d = primary_rays(threefry.prng_key(0, dev), cv[1], _ray_basis(cv[0]), W, H)
        _CLOUD.update(grid=grid, vs=VptSettings(), kt=kt, o=o, d=d)
    c = _CLOUD
    return c["grid"], c["vs"], c["o"], c["d"], c["kt"]


def r3():
    from linevis_tpu_torch.kernels import vpt_tracking as vt
    from linevis_tpu_torch.render.vpt import sun_constants
    grid, vs, o, d, kt = _cloud_sample()
    p = vt.vpt_params(grid.shape, vs.extinction, vs.scattering_albedo, *sun_constants(vs),
                      vs.phase_g, vs.mode, vs.max_events, vs.interpolation)
    ev = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    out = vt.vpt_tracking(grid, o, d, kt, p, events=ev)
    _against_first_tree("r3", [_digest(x.float()) for x in (*out, ev)])
    res["r3_events"] = int(ev.sum())
    res["r3_delta_sample"] = timed(lambda: vt.vpt_tracking(grid, o, d, kt, p), n=10)


def r7():
    from linevis_tpu_torch.kernels import vpt_decomposition as vd
    from linevis_tpu_torch.render.super_voxel import super_voxel_minmax_of
    from linevis_tpu_torch.render.vpt import sun_constants
    grid, vs, o, d, kt = _cloud_sample()
    dmin, dmax = super_voxel_minmax_of(grid, vs.super_voxel_size)
    p = vd.decomposition_params(grid.shape, dmin.shape, vs.extinction, vs.scattering_albedo,
                                *sun_constants(vs), vs.phase_g, vs.max_events)
    ev = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    out = vd.vpt_decomposition(grid, dmin, dmax, o, d, kt, p, events=ev)
    _against_first_tree("r7", [_digest(x.float()) for x in (*out, ev)])
    res["r7_events"] = int(ev.double().sum())
    res["r7_decomposition_sample"] = timed(
        lambda: vd.vpt_decomposition(grid, dmin, dmax, o, d, kt, p), n=5)


def r8():
    from linevis_tpu_torch.kernels import vpt_residual_ratio as vr
    from linevis_tpu_torch.render.super_voxel import super_voxel_grid_of
    from linevis_tpu_torch.render.vpt import sun_constants
    grid, vs, o, d, kt = _cloud_sample()
    sv = super_voxel_grid_of(grid, float(vs.extinction[0]), vs.super_voxel_size)
    p = vr.rr_params(grid.shape, sv.mu_c.shape, vs.extinction, vs.scattering_albedo,
                     *sun_constants(vs), vs.phase_g)
    st = torch.empty((o.shape[0], 3), dtype=torch.int32, device=dev)
    out = vr.vpt_residual_ratio(grid, sv, o, d, kt, p, steps=st)
    _against_first_tree("r8", [_digest(x.float()) for x in (*out, st)])
    res["r8_steps"] = [int(v) for v in st.double().sum(0)]
    res["r8_residual_ratio_sample"] = timed(
        lambda: vr.vpt_residual_ratio(grid, sv, o, d, kt, p), n=5)


def r4():
    from linevis_tpu_torch import entry
    from linevis_tpu_torch.kernels import density_march as dm
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import _ray_basis
    field_file = os.path.join(os.path.dirname(groups_file), "line_density_field.pt")
    if os.path.exists(field_file):
        field, b_min, b_max = torch.load(field_file)
        field = field.to(dev)
    else:  # the run's first turn traces the cloud for every turn
        ld = entry.scattering_line_data(dev)
        field = ld.get_line_density_field(device=dev)
        b_min, b_max = [float(v) for v in ld.grid_b_min], [float(v) for v in ld.grid_b_max]
        torch.save((field.cpu(), b_min, b_max), field_file)
    cd = camera_tensors(Camera(position=(-0.6, -0.45, -0.55), look_at_point=(0.0, 0.0, 0.0),
                               width=W, height=H), dev)
    c_pts, _ = TransferFunction.standard().as_static_points()
    digests = []
    # The smoke's frame (a box of extent 0.5, the renderer's ramp: zero
    # opacity at density 0), and a box of extent 0.375 under an opacity TF
    # of 0.2 at density 0 (IEEE divisions; nothing to skip).
    lo = np.asarray(b_min, np.float32)
    hi_ieee = lo + np.float32(0.75) * (np.asarray(b_max, np.float32) - lo)
    for case, box, o_pts, n in (("frame", b_max, ((0.0, 0.0), (0.05, 1.0), (1.0, 1.0)), 10),
                                ("ieee_no_skip", hi_ieee, ((0.0, 0.2), (1.0, 1.0)), 5)):
        prm, _ = dm.march_params(field.shape, b_min, box, cd[1], _ray_basis(cd[0]), W, H, 200.0,
                                 (1.0, 1.0, 1.0, 0.0))

        def run(prm=prm, o_pts=o_pts):
            return dm.density_march(field, prm, W, H, 256, c_pts, o_pts)
        digests.append(_digest(run()))
        res[f"r4_{case}"] = timed(run, n=n)
    _against_first_tree("r4", digests)


def r5():
    from linevis_tpu_torch import entry
    from linevis_tpu_torch.kernels import spherical_heatmap as shm
    from linevis_tpu_torch.render.spherical_heatmap import mollweide_points
    dirs_file = os.path.join(os.path.dirname(groups_file), "exit_directions.pt")
    if os.path.exists(dirs_file):
        dirs = torch.load(dirs_file).to(dev)
    else:  # the run's first turn traces the cloud for every turn
        dirs = torch.as_tensor(entry.scattering_line_data(dev).exit_directions, device=dev)
        torch.save(dirs.cpu(), dirs_file)
    pts, _ = mollweide_points(H, dev)

    def run():
        return shm.heatmap_density(pts, dirs, 2 * H)
    _against_first_tree("r5", [_digest(run())])
    res["r5_directions"] = int(dirs.shape[0])
    res["r5_map_1080x2160"] = timed(run, n=5)


for k in kernels:
    {"b2": b2, "b5": b5, "b4": b4, "b6": b6, "b1": b1, "b3": b3, "accum": accum, "r1": r1,
     "r2": r2, "r3": r3, "r4": r4, "r5": r5, "r7": r7, "r8": r8}[k]()
print("RESULT " + json.dumps(res), flush=True)
'''


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    turns, kernels = 2, "b2,b5,b4,b6,b1,b3,accum,r1,r2"
    if "--turns" in args:
        i = args.index("--turns")
        turns = int(args[i + 1])
        del args[i:i + 2]
    if "--kernels" in args:
        i = args.index("--kernels")
        kernels = args[i + 1]
        del args[i:i + 2]
    if not args:
        raise SystemExit(__doc__)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    order = [t for k in range(turns) for t in (args if k % 2 == 0 else args[::-1])]
    results = {t: [] for t in args}
    tmp = tempfile.mkdtemp(prefix="kernel_ab_")
    groups_file = os.path.join(tmp, "groups.pt")
    try:
        for tree in order:
            first = "rebuild" if not results[tree] else "cached"
            p = subprocess.run([sys.executable, "-c", _CHILD, first, groups_file, kernels],
                               cwd=tree, capture_output=True, text=True, timeout=900)
            line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not line:
                print(f"{tree}: failed (rc {p.returncode})\n{p.stdout[-2000:]}\n"
                      f"{p.stderr[-3000:]}", flush=True)
                return 1
            r = json.loads(line[0][len("RESULT "):])
            if not r["build"]:
                del r["ptxas"], r["build"]
            results[tree].append(r)
            print(json.dumps({"tree": tree, **r}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"gpu": gpu, "turns": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
