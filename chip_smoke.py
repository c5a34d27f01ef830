#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (linevis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `linevis_tpu_torch/kernels/csrc/`, then
drives the ported paths at full size on the Crawfis tornado traced on the
card (512 seeds from np.random.default_rng(42), 400 RK4 steps, dt 1/150;
~205k capsule segments) with orbit cameras at 1920x1080:
- opaque capsule tubes through `render_tubes` (tile 32x16, analytic-coverage
  AA, span 2x2; kernel capsule_raster), 16 frames;
- transparent MLAB tubes through `render_tubes_mlab` (the JAX package's
  bench.py MLAB settings: tile 16x8, chunk 128, K=8, opacity 0.3, sat
  0.999, sub 32, front faces only; kernel capsule_mlab), 16 frames;
- opaque 8-gon prism tubes through `render_tubes_prism` (tile 32x16, the
  capsule binning; kernel prism_raster), 16 frames;
- opaque triangle tubes (8 subdivisions, ~3.3 M triangles) through
  `render_opaque` (tile 32x16, chunk 128, span 2x2; kernel triangle_raster),
  16 frames;
- ray-traced ambient occlusion through `render_tubes_rtao` (bench.py's RTAO
  settings: 4 rays per pixel, radius 0.1, grid 64^3, 8 cells per ray,
  batches of 2.1 M rays, tile 32x16, the grid built once; kernels
  capsule_raster, once per frame without AA, ao_grid, once per batch, and
  threefry_uniform, twice: the frame's two draws of jax.random.uniform,
  held bit for bit against `ops/threefry.py:uniform` on frame 0's
  16,588,800), 8 frames;
- the wavefront ray tracer through `render_tubes_raytraced_wavefront`
  (bench.py's settings: tile 16x8, K=8, opacity 0.3, binned-SAH tree
  collapsed to 8-wide groups on the host; kernel bvh_wavefront), 4 frames;
- the rest of the OIT family at tile 16x8, opacity 0.3, 8 frames each:
  depth complexity (`render_depth_complexity`; capsule_accum once per
  frame), WBOIT (`render_tubes_wboit`; capsule_accum once), MBOIT
  (`render_tubes_mboit`, 4 power moments, float32; capsule_accum twice),
  MLAB buckets (`render_tubes_mlab_buckets`, K=8; capsule_mlab twice) and
  depth peeling (`render_tubes_depth_peeling`, K=8, 4 passes; capsule_mlab
  four times, with a peel depth and per-fragment shading). Each mode is held
  against its plain version on frame 0 (the accumulation modes, count, WBOIT
  and both MBOIT passes, bit for bit; the peel passes' nodes within 1e-4),
  each frame against the same frame on the plain path,
  the MBOIT variants (6/8 power, 4/6/8 trigonometric moments, unorm16) at
  480x272, and depth peeling against the Atomic Loop K=32, MBOIT and WBOIT
  against MLAB K=8;
- opacity optimization through `OpacityOptimizationRenderer.render` (bench.py
  cfg5: tile 16x8, the default settings: q 2000, r 20, s 15, lambda 2, the
  importance gather at half resolution with K=8, the final MLAB render with
  K=8), 8 frames of a moving camera, so each frame solves: the gather
  (capsule_mlab in store mode 'gather') and the final render launch
  capsule_mlab once each. The gather is held bit for bit against its plain
  version on frame 0, the vertex opacities against the plain path's on every
  frame (equal), the final frame against the plain path's (SSIM);
- `use_bands` (diffuse exponent 1.0) against the plain version at 480x272 in
  per-fragment shading behind a peel depth, the composite, 'wboit' and
  'mboit_resolve'; then the opacity-optimization entry and every mode the
  port's renderer registry draws, by name, on a small scene, card vs CPU
  (RTAO after 2 accumulated frames: each device draws jax.random's samples,
  the same rays), and the registry's RTAO mode on the tornado at
  1080p (its first frame equal to `render_tubes_rtao`'s, 8 frames timed);
- the repo's five reference configs (tests/baseline_scenes.py, six images)
  through the registry at full size, `entry.BASELINE_CONFIGS` on the card:
  config 1 (tornado, Opaque, 800x600), 2 (tornado, Per-Pixel Linked Lists,
  K=32), 4 and 4b (the Femur-like stress lines, MLAB and MBOIT, opacity 0.45)
  and 5 (tornado, opacity optimization along its circle path) 8 frames each
  on an orbit of cameras, config 3 (convection rolls traced on the card,
  RTAO) its 2 accumulating frames; each frame timed with CUDA events and the
  host clock (a registry frame hands back a numpy image), its launches
  counted. B2's composite at K=32 on config 2's frame 0 and on the Femur's
  (also in bench.py's form with per-segment alpha rows, whose frames are
  timed too), and both MBOIT passes on the Femur's frame 0 (bit for bit),
  against their plain versions; each config at scale 0.1 on the card
  against the CPU's plain path (config 3: its 2 accumulated registry frames,
  each device drawing jax.random's samples; config 5, whose frame an ulp of
  its input moves, at a lower
  SSIM floor and stage by stage: the gather's nodes on most pixels, the
  solve on identical nodes and the final render on identical opacities);
- the transparent ray tracer (the registry's "Vulkan Ray Tracer") on the
  tornado over the registry's default "linear" tree, opacity 0.3: the
  re-cast loop through `render_tubes_raytraced` (32 casts; kernel
  bvh_recast, the whole loop, once a frame) and MLAT through
  `render_tubes_mlat` (K=8; kernel bvh_mlat once), 4 frames each; on frame
  0 at 1080p the loop kernel's record of every cast's (t, prim) against 32
  launches of the one-cast kernel (bvh_closest_hit, each timed) through the
  plain loop `trace_recast`, bit for bit, whose per-ray counts give the
  loop's work; on one band (a tile row of 16x8 tiles, see
  RT_BAND_MIN_HITS) the kernels against their lockstep plain versions: the
  one-cast kernel's (t, prim) and per-ray counts on every cast, the loop
  kernel's record, and bvh_mlat's nodes and counts, all bit for bit, the
  loop kernel's RGBA within 1e-4 (its powf against torch.pow);
- the deferred family and the RTAO denoisers: `render_tubes_deferred` equal
  to `render_tubes` and a static camera's motion vectors near zero, the
  registry's "Deferred Opaque" at upscaling factor 2, `render_tubes_rtao`
  with "EAW" and "Spatial Hashing" and the registry's RTAO with "SVGF
  (Temporal)" on a moving camera, 4 frames each, and each denoiser on the
  small scene card vs CPU on identical samples; SSAO and GTAO on the RTAO
  G-buffer (a reading); the AO bake of the whole tornado (`AoBakeSettings`'
  defaults, 32 launches of ao_grid; seconds, a reading);
- datasets from files (`datasets_phase`): every file type the JAX package
  reads, written to a temporary directory by in-repo generators, named in a
  datasets.json and loaded through `scene/factory.py:load_line_data` (the
  .obj parser must be the native one): a displaced icosphere of 1,310,720
  triangles as binary STL (the weld, normals and curvature timed) through
  the registry's "Opaque (Triangle Mesh)" (tile 16x8, the binning window
  per camera; kernel triangle_raster once a frame), 8 frames, each frame's
  span, keys, capacity and overflow (0 required), B3 bit for bit with its
  plain version on frame 0's CSR, a float64 ray-mesh reading of coverage on
  every 16th pixel, the frame card vs CPU at scale 0.1; the Femur-like lines
  with the boundary of a 48x48x96 hexahedral mesh (ASCII VTK) as their hull
  in a v3 .dat, the hull drawn with the hull TF, 8 frames, B3 bit for bit
  on frame 0, its overflow printed; the traced tornado as .binlines, .obj
  and NetCDF-classic, each loaded as written (.binlines and .obj exactly,
  NetCDF within 1e-6 of its normalized log-pressure mapping restated in
  numpy), the .binlines through "Opaque" (capsule_raster once a frame), 8
  frames, its frame 0 equal to the in-memory trajectories'; the grid
  streamline tracer (RKF45 adaptive, loop termination) on the tornado
  sampled at 128^3, 512 seeds, 400 steps, card vs CPU: trilinear samples
  and the first 16 steps gated, the full trace read as the share of lines
  with the CPU's point count;
- scattering, VRC and multivariate tubes (`scattering_phase`): a 512^3
  procedural cloud (300 Gaussian blobs from np.random.default_rng(7),
  clipped to [0, 1]) traced by `LineDataScattering.trace` (64x64 pixels x 10
  samples, 128 events, g 0.2, seed 42: 40,960 paths), written and reloaded
  as .xyz (equal); the registry's "Volumetric Path Tracer" at 1080p with
  the renderer's defaults (Delta tracking, extinction 1024, 512 events, 2
  spp; kernel vpt_tracking twice a frame), 4 accumulating frames, R3
  against its plain version bit for bit (events and scatters included) on
  one 1080p row of both samples in each scan mode, sliced from launches on
  the whole samples, two launches on the whole first sample equal, the
  events per ray and the warp efficiency they give a lockstep warp, the
  frame card vs CPU at scale 0.1
  on the same keys (image mean), decomposition and residual ratio tracking
  at 240x135 (plain, 1 frame of 1 sample each, a reading); "Line Density Map Renderer"
  (density_march once a frame), 8 frames, R4 bit for bit on the whole
  frame and on one more 1080p launch on its IEEE divisions with skipping
  off (a box of extent 0.375, an opacity of 0.2 at density 0), the skip
  rule's plain twin bit for bit too; "Spherical Heat Map Renderer" at
  height 1080 (a 1080x2160 map of the 40,960 exit directions;
  spherical_heatmap once), 4 frames, R5 bit for bit on two bands of 8 rows
  (one tile row: the hottest, and the top rows) sliced from the whole
  map's launch, the pairs in range the kernel counts there equal to the
  plain count, two launches equal, its branch-free term equal to the IEEE
  one on every float, and at most 5%
  of the pairs tested exactly; "Voxel Ray Casting" on the
  tornado (grid 128, quantization 8; capsule_raster once), 8 frames, card
  vs CPU at scale 0.1; the tornado's multivariate tubes (its attribute and
  1 - it, 8 subdivisions) through `render_opaque` (triangle_raster once), 8
  frames, B3 bit for bit on that CSR. The four modes also join the
  registry's card-vs-CPU check (the path tracer on identical keys, by image
  mean);
- the application layer (`app_phase`) on the tornado written as .binlines
  with a datasets.json: `python -m linevis_tpu_torch render` in process at
  1920x1080 (Opaque and MLAB, each PNG byte for byte the registry frame's)
  and as a subprocess on its default device, `replay` of the golden replay
  script (its last frame the registry's, bit for bit), `perf` over the 15
  states of `get_test_modes` (8 frames each, launches counted per state,
  every CSV cell filled), the HTTP viewer on port 0 (one 1080p frame, byte
  for byte `frame_png`'s), two DataViews, both requesters, a frame drawn
  from a worker thread on a side stream, a 3D-TSV reply's lines and
  `FrameProfiler` over the capsule frame's passes;
- multi-GPU through torch.distributed (`parallel_phase`) on the one card:
  `entry.dryrun_multichip(1)`; a world of one (NCCL on an in-memory
  store, `make_device_mesh(1)`) through the five sharded functions at
  1080p, each frame timed, its launches those of its unsharded frame and
  the frame held against the unsharded one bit for bit on the same draws;
  the band layout at n=3 run band by band (rank by rank for RTAO and VPT)
  and combined as the collectives would, every kernel of a band against
  its plain version, each stitched frame against the world of one at
  constant bars (PAR_*_BARS) that planted faults must fail.
For each path it times the frames and their stages with CUDA events, checks
that exactly the expected kernels were launched the expected number of
times, holds the path's kernel against its plain PyTorch version on the same
1080p inputs (the wavefront kernel on every WF_COMPARE_EVERY-th ray block:
blocks are independent), and checks a small frame on the card against the
plain path on the CPU (for the transparent path also the Atomic Loop frame,
K=16 `no_overflow` with per-fragment shading, through
`render_tubes_atomic_loop`). It also prints the
SSIM of the prism frame against the triangle frame, and of the wavefront
frame against the two-sided MLAB frame, of the same camera. Then it prints
one JSON line of kernel figures, and the device line last. A kernel's bound
is computed from its plain version's counts (the work the function needs,
whatever implements it), with the kernel's own counts beside them; the AO
kernel's entry also times its launch with every pair chunk empty. The
capsule, triangle, prism and wavefront kernels' entries carry their
instances' registers per thread, local memory and resident blocks per SM
(read through each library's `kernel_info`), the candidates or chunks per
tile (50th and 99th centile, largest) and the group visits per ray block
(50th and 99th centile). The capsule kernel is held against its plain
version bit for bit, with AA on the capsule frame and without AA on the
RTAO G-buffer's binning, and its bound charges the start cap and each
part's AA distance only where the function needs them
(`capsule_needed_work`, itself held against the plain version's
arithmetic). B2's bounds, in every mode, charge each part's root and tests
only where its discriminant is not negative, and the world t and clip only
where a surface exists (the plain version's `stats`); each B2 row also
carries the bound with every part charged at every evaluation.

Exits non-zero, printing no result, without a CUDA device or without the
repository beside it. Any failed check raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 16
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores (H100 SXM data sheet)
H100_HBM_BYTES = 3.35e12
# Float operations of one (candidate, pixel) evaluation of the capsule kernel
# with coverage AA, each add/mul/min/max/compare/sqrt/div counted once:
# ray re-origin and dot products 38, three quadratics and their roots 35,
# three AA signed distances 51 (the body's through a cross product),
# acceptance tests and selects 19; 143 with every part.
CAPSULE_OPS_PER_EVAL = 143
# The parts that the function needs only at some (candidate, pixel) pairs:
# the start cap (root 9, tests 4) only where payload row 13 holds one; a
# part's AA distance (the body's 31, a cap's 10) only where the rest of its
# test holds (`capsule_needed_work`). Every evaluation needs the rest, 79.
CAPSULE_OPS_START_CAP = 13
CAPSULE_OPS_BODY_AA = 31
CAPSULE_OPS_CAP_AA = 10
CAPSULE_OPS_BASE = (CAPSULE_OPS_PER_EVAL - CAPSULE_OPS_START_CAP - CAPSULE_OPS_BODY_AA
                    - 2 * CAPSULE_OPS_CAP_AA)
STAGED_ROWS = 13  # payload rows the capsule kernel reads per candidate
# Float operations of the MLAB kernel (each add/mul/min/max/compare/select/
# sqrt/div counted once, an FMA twice), front faces only:
# per (candidate, pixel) evaluation 95: the two dot products and the
# re-origin 20, the three quadratics and their roots 29, the entry surface's
# three roots, axial positions and acceptance tests 40, the world t, NDC clip
# and rejection 6;
MLAB_OPS_PER_EVAL = 95
# Every mode of B2 (the K-buffer modes and the accumulation modes) charges
# each evaluation only what the function needs there (the plain version's
# `stats`): at every one the dot products and the re-origin 20, the three
# discriminants 23 and their signs 3; a part's root, axial position and
# acceptance tests only where its discriminant is not negative (the body's
# 15, the start cap's 15 and only where payload row 13 holds one, the end
# cap's 13); the world t, NDC clip and rejection 6 only where a surface
# exists. 95 with every part.
HIT_OPS_BASE = 46
HIT_OPS_PART = (15, 15, 13)  # the body, the start cap, the end cap
HIT_OPS_SURFACE = 6
NEED_KEYS = ("evaluations", "body", "start_cap", "end_cap", "surfaces")
# per fragment in an extracted tie window 45: its axial position, attribute,
# the two headlight cosines through the tube-axis identities 29, the
# opacity TF 10, the window sums 4, and the window test 2;
MLAB_OPS_PER_MEMBER = 45
# per (pixel, sweep) extraction: the carry and insertion into K nodes: the
# carry's NDC depth and averages 12, then 4 per node (position count, dedup
# test, shift). Finding a window's nearest hit is the insertion into a short
# sorted list, counted with its member.
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
# The kernel takes the ring planes first; a pixel that already misses after
# them and PRISM_SIDES // 2 side planes needs those and the miss test (2).
PRISM_OPS_PER_OUT = 16 * 2 + 15 * (PRISM_SIDES // 2) + 2
PRISM_ROWS = 23  # payload rows the prism kernel reads per candidate (0-10, 24-35)
# Float operations of one (slot, pixel) evaluation of the triangle kernel:
# three edge planes and the depth plane at 2 multiplies and 2 adds each, 16,
# and the five inside compares; per (chunk, pixel) update the id plane and 8
# attribute planes, 4 each, and the depth compare.
TRIANGLE_OPS_PER_EVAL = 21
TRIANGLE_OPS_PER_TAKE = 4 * 9 + 1
TRIANGLE_PLANES = 8
# Payload rows the triangle kernel reads per evaluated slot (the edge, depth
# and id planes and the chunk's depth bound, 0-15); the attribute planes'
# rows it reads only for each pixel's final winner.
TRIANGLE_STAGED_ROWS = 16
RTAO_FRAMES = 8
# Float operations of one (record slot, ray) test of the AO kernel, each
# add/mul/neg/min/max/compare/sqrt/div counted once. Every test 62: o - a 3,
# the two dot products 10, baba and r^2 2, the re-origin (t0, the moved
# origin, ba.oa', oa'.oa', rd) 20, the three discriminants 24 and their
# signs 3. A root only where its discriminant is not negative (the others
# miss in any case): the body's root, axial position, world t and acceptance
# compares 12; each cap's 10. The tests counted are those the result needs
# (`trace_pairs(tests=)`): per walked record chunk, its hittable slots times
# the rays not yet occluded when it is staged; `ao_root_tests` counts the
# roots among them.
AO_OPS_PER_TEST = 62
AO_OPS_PER_ROOT = (12, 10, 10)  # the body, cap a, cap b
WF_FRAMES = 4
WF_K, WF_OPACITY = 8, 0.3
WF_BUILDER = "binned_sah"  # its host build + packing stays under 90 s here
WF_COMPARE_EVERY = 8  # the plain version runs on every 8th ray block
# Float operations of the wavefront kernel, counted as above. Per (group
# visit, ray) 208: per child box 12 for the six slab distances, 11 for the
# entry and exit t, 3 compares. Per (leaf row, ray) 143: o - a, the two dot
# products, the re-origin and the three quadratics with their roots 67, then
# per surface side 38 (three roots, axial positions, acceptance tests, the
# world t and its clip). Per fragment in an extracted tie window 45 (as the
# MLAB kernel's). Per (ray, sweep) extraction: the scan of 16 candidates and
# their window test 32, the carry 12, then 4 per node.
WF_OPS_PER_VISIT = 208
WF_OPS_PER_LEAF_ROW = 143
WF_OPS_PER_MEMBER = 45
WF_OPS_PER_SWEEP = 32 + 12
WF_OPS_PER_SWEEP_NODE = 4
OIT_FRAMES = 8  # frames of each phase of the rest of the OIT family
OIT_OPACITY = 0.3
OIT_SMALL = (480, 272)  # the reduced frame of the MBOIT variants
# Float operations of the per-fragment work of the OIT family, counted as
# above, a logf/expf/powf/cosf/sinf as 8: per shaded fragment, beyond the 45
# of its features, 80 (the color TF 30, three powf 24, the cosine mix,
# specular and shade 6, the depth cue 8, the color mix 12); per fragment of
# an accumulation mode its terms: count 1, wboit 35 (weight 20, log 10, sums
# 5), mboit_gen 4 moments 45 (warp 14, absorbance 11, moments 20),
# mboit_resolve 4 moments 100 (warp 14, the transmittance at the fragment's
# depth from the pixel's factors 77, the discard's select 1, sums 8); per
# pixel whose moments the resolve keeps (b0 at or above the discard
# threshold), its moment factors once: 31 (the normalization by b0 6, the
# biased moments 12, the Cholesky factors 12, the discard test 1); per
# fragment of a peel pass its NDC depth and the peel test 5.
OIT_OPS_PER_SHADE = 80
# With use_bands the diffuse powers are their bases: two powf fewer.
OIT_OPS_PER_SHADE_BANDS = OIT_OPS_PER_SHADE - 2 * 8
OIT_OPS_PER_ACCUM = {"count": 1, "wboit": 35, "mboit_gen": 45, "mboit_resolve": 100}
OIT_OPS_RESOLVE_PIXEL = 31
OIT_OPS_PER_PEEL = 5
RT_FRAMES = 4  # frames of each ray-tracer, deferred and denoiser phase
RT_CASTS, RT_MLAT_K, RT_OPACITY = 32, 8, 0.3  # the registry's Vulkan Ray Tracer defaults
# The band of the ray tracer's gates against the lockstep plain versions: the
# tile row (8 pixel rows) with the shortest longest walk among the rows where
# at least this share of the rays hits a surface at the first cast.
RT_BAND_MIN_HITS = 0.15
# Float operations of the per-ray traversal kernels, counted as above. Per
# node visit 28: the six slab distances 12, the entry and exit t 10, the hit
# test 6 (MLAT 30: the saturation cull 2 more). Per leaf test of the closest
# hit 138: o - a 3, five dot products 25, the three quadratics and roots 31,
# per surface side (entry, exit) 36 (three roots 6, axial positions 6, the
# acceptance tests with the (t, prim) bound 19, selects and mins 5), the
# mask and the (t, prim) comparison 7. Per leaf test of MLAT 145: the same
# quadratics and roots 131 and per side its NDC clip 7. Per surface inserted
# 95: the features 73 (the point, the axial position, the attribute, the
# normal, the tube's direction, the two headlight cosines), the opacity TF 8,
# the alpha and premultiplied features 4, the merge into node K-1 10; and 1
# per node compared (K).
RT_OPS_PER_VISIT = 28
RT_OPS_PER_LEAF = 138
# The re-cast loop's state update, counted from `trace_recast` (a powf as
# 8, as below): per surface a cast finds inside the clip volume 97 (the NDC
# clip 6, the features 73, the opacity TF 8, the alpha 1, the tie-window
# test 4, the group's sums 5); per surface outside it the clip 6; per group
# flushed (shaded and blended once) 99 (the averages 5, the clamps 2, the
# diffuse mix 19, the specular 9, the color TF 30, the shade 2, the depth
# cue 9, the color 14, the blend 9).
RT_OPS_PER_SURFACE = 97
RT_OPS_PER_CLIPPED = 6
RT_OPS_PER_FLUSH = 99
MLAT_OPS_PER_VISIT = 30
MLAT_OPS_PER_LEAF = 145
MLAT_OPS_PER_INSERT = 95
# A static camera's motion vectors round-trip each pixel through its NDC
# depth and the projection: float32 pixel coordinates near 1920 have an ulp
# of 1.2e-4 px (2.4e-4 px read on the 1080p tornado); tests/test_deferred.py's
# bar.
DEFERRED_STATIC_MV = 1e-3
OO_FRAMES = 8  # opacity-optimization frames (bench.py cfg5's flight)
BASE_FRAMES = 8  # frames of each baseline config but config 3 (its own 2)
BASE_CHECK_SCALE = 0.1  # the baseline configs' card-vs-CPU frames
BASE_CHECK_RTAO_FRAMES = 2  # config 3's own frames; both devices draw the same samples
# Config 5's solve on identical gathered nodes, card vs CPU: the device's
# powf against the CPU's pow, through 15 Laplacian steps.
OO_SOLVE_TOL = 1e-5
# Config 5's stages that an ulp of their input moves (K-buffer truncation in
# the gather), card vs CPU, held at floors set from the readings: its
# registry frame at SSIM >= OO_FRAME_SSIM (0.9799 read on the card, 0.984
# for one ulp of the positions on the CPU alone, tools/ulp_sensitivity.py),
# the gather's nodes equal on >= OO_GATHER_NODES of pixels (99.91% read).
OO_FRAME_SSIM = 0.95
OO_GATHER_NODES = 0.99
# Float operations per fragment in an extracted tie window of the importance
# gather: its axial position and attribute 7, the window sums 4, the window
# test 2 (no shading, no TF).
GATHER_OPS_PER_MEMBER = 13


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


def prism_out_early(csr, params, width, height, tile_w, tile_h, n_sides, batch_pairs=2048):
    """The (candidate, pixel) evaluations of the prism kernel whose pixel
    already misses (t_in > t_out or t_out <= 0) after the ring planes and
    n_sides // 2 side planes, the kernel's order, replayed on the plain
    version's planes -> (evaluations, of them out early)."""
    from linevis_tpu_torch.kernels.capsule_common import BIG, pixel_rays
    from linevis_tpu_torch.kernels.raster_prism import _planes, ring_table

    dev = csr.payload.device
    n_tiles = csr.tile_start.shape[0]
    dn_all, _ = pixel_rays(params, n_tiles, csr.tiles_x, tile_w, tile_h, width, height)
    cs = ring_table(n_sides, dev)
    counts = csr.tile_count.long()
    total = int(counts.sum())
    pair_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
    run_base = torch.cumsum(counts, 0) - counts
    pair_col = (csr.tile_start.long()[pair_tile] + torch.arange(total, device=dev)
                - run_base[pair_tile])
    out = torch.zeros((), dtype=torch.int64, device=dev)
    for b0 in range(0, total, batch_pairs):
        tiles = pair_tile[b0:b0 + batch_pairs]
        planes = _planes(csr.payload[:, pair_col[b0:b0 + batch_pairs]], n_sides, cs)
        dnx, dny, dnz = (d[tiles] for d in dn_all)
        t_in, t_out = torch.full_like(dnx, -BIG), torch.full_like(dnx, BIG)
        for nx, ny, nz, num in planes[n_sides:] + planes[:n_sides // 2]:
            nx, ny, nz, num = (v[:, None] for v in (nx, ny, nz, num))
            den = (nx * dnx + ny * dny) + nz * dnz
            tp = -num * (1.0 / den)
            t_in = torch.where(den <= -1e-12, torch.maximum(t_in, tp), t_in)
            t_out = torch.where(den >= 1e-12, torch.minimum(t_out, tp), t_out)
        out += ((t_in > t_out) | (t_out <= 0.0)).sum()
    return total * tile_w * tile_h, int(out)


def capsule_needed_work(csr, params, width, height, tile_w, tile_h, work, batch_pairs=2048):
    """The (candidate, pixel) evaluations of the capsule function with AA
    in the candidates each tile evaluated (`work`), and among them those
    that need each optional part, replayed on the plain version's
    arithmetic: the start cap where payload row 13 holds one, and a part's
    AA distance where the rest of its test holds (the body's axial range
    and t > 0; each cap's axial side and t > 0). The replay is held against
    the plain version's `_candidates` on the same batches: the same
    re-origin t0 bit for bit, and every hit there the t of a part that the
    replay counts as needed; it raises otherwise.
    -> {"evaluations", "start_cap", "body_aa", "cap_a_aa", "cap_b_aa", "hits"}."""
    from linevis_tpu_torch.kernels.capsule_common import BIG, pixel_rays
    from linevis_tpu_torch.kernels.raster_capsule import _candidates

    dev = csr.payload.device
    n_tiles = csr.tile_start.shape[0]
    P = tile_w * tile_h
    dn_all, invlen_all = pixel_rays(params, n_tiles, csr.tiles_x, tile_w, tile_h, width,
                                    height)
    counts = csr.tile_count.long()
    pair_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
    run_base = torch.cumsum(counts, 0) - counts
    rank = torch.arange(pair_tile.numel(), device=dev) - run_base[pair_tile]
    keep = rank < work.long()[pair_tile]
    pair_tile = pair_tile[keep]
    pair_col = csr.tile_start.long()[pair_tile] + rank[keep]
    acc = torch.zeros(5, dtype=torch.int64, device=dev)
    for b0 in range(0, pair_tile.numel(), batch_pairs):
        tiles = pair_tile[b0:b0 + batch_pairs]
        s = csr.payload[:, pair_col[b0:b0 + batch_pairs]][:, :, None]
        dn = tuple(d[tiles] for d in dn_all)
        dnx, dny, dnz = dn
        bard = s[3] * dnx + s[4] * dny + s[5] * dnz
        rdoa = s[0] * dnx + s[1] * dny + s[2] * dnz
        baba, rr = s[10], s[6] * s[6]
        t0 = -(rdoa + 0.5 * bard)
        oax, oay, oaz = s[0] + t0 * dnx, s[1] + t0 * dny, s[2] + t0 * dnz
        baoa = s[3] * oax + s[4] * oay + s[5] * oaz
        oaoa = oax * oax + oay * oay + oaz * oaz
        rd = rdoa + t0
        k2 = torch.clamp(baba - bard * bard, min=1e-20)
        k1 = baba * rd - baoa * bard
        h = k1 * k1 - k2 * (baba * oaoa - baoa * baoa - rr * baba)
        tb = (-k1 - torch.sqrt(torch.clamp(h, min=0.0))) / k2
        yb = baoa + tb * bard
        ta = -rd - torch.sqrt(torch.clamp(rd * rd - (oaoa - rr), min=0.0))
        b1b = rd - bard
        tbb = -b1b - torch.sqrt(torch.clamp(b1b * b1b - (oaoa - 2.0 * baoa + baba - rr), min=0.0))
        cap = (s[13] > 0.5).expand_as(yb)
        body = (yb > 0.0) & (yb < baba) & (t0 + tb > 0.0)
        cap_a = cap & (baoa + ta * bard <= 0.0) & (t0 + ta > 0.0)
        cap_b = (baoa + tbb * bard >= baba) & (t0 + tbb > 0.0)
        tall, t0_plain, _, _ = _candidates(s, dn, invlen_all[tiles], params[19], True)
        hit = tall < BIG
        explained = ((tall == tb) & body) | ((tall == ta) & cap_a) | ((tall == tbb) & cap_b)
        if not torch.equal(t0_plain, t0) or bool((hit & ~explained).any()):
            raise RuntimeError("the capsule replay drifted from the plain version's arithmetic")
        acc += torch.stack([cap.sum(), body.sum(), cap_a.sum(), cap_b.sum(), hit.sum()])
    start_cap, body, cap_a, cap_b, hits = acc.tolist()
    return {"evaluations": pair_tile.numel() * P, "start_cap": start_cap, "body_aa": body,
            "cap_a_aa": cap_a, "cap_b_aa": cap_b, "hits": hits}


def hit_ops(stats):
    """Operations of B2's front-face test from the plain version's `stats`
    -> (the needed work, every part charged at every evaluation, the
    needed-work counts)."""
    need = {k: stats[k] for k in NEED_KEYS}
    parts = (need["body"], need["start_cap"], need["end_cap"])
    return (need["evaluations"] * HIT_OPS_BASE
            + sum(n * o for n, o in zip(parts, HIT_OPS_PART))
            + need["surfaces"] * HIT_OPS_SURFACE,
            need["evaluations"] * MLAB_OPS_PER_EVAL, need)


def recast_work(rec, wz, proj_ab):
    """The re-cast loop's surfaces from its record of every cast ((t, prim)
    [casts, R], (inf, -1) where a ray is done): {"surfaces": found,
    "surfaces_in_clip": inside the NDC depth range, "groups": shaded and
    blended}, replaying `trace_recast`'s clip and tie window."""
    zA, zB = proj_ab[0], proj_ab[1]
    g_t0 = torch.zeros_like(wz)
    has = torch.zeros(wz.shape, dtype=torch.bool, device=wz.device)
    found = in_clip = groups = 0
    for t, prim in zip(*rec):
        hit = prim >= 0
        znd = zA - zB / torch.clamp(t * wz, min=1e-12)
        ok = hit & (znd >= 0.0) & (znd <= 1.0)
        new = ok & ~(has & (t <= g_t0 + torch.abs(g_t0) * 1e-6))
        g_t0 = torch.where(new, t, g_t0)
        has = has | new
        found += int(hit.sum())
        in_clip += int(ok.sum())
        groups += int(new.sum())
    return {"surfaces": found, "surfaces_in_clip": in_clip, "groups": groups}


def warp_figures(lane_visits, warp_visits):
    """A warp-shared walk's cost: the node pops of its rays and of its
    warps, and each warp's against its longest and its mean ray."""
    lanes = lane_visits.reshape(-1, 32).double()
    longest = lanes.max(dim=1).values
    live = longest > 0
    w = warp_visits.double()
    ratio = (w[live] / longest[live]).cpu().numpy()
    return {"ray_visits": int(lane_visits.sum()), "warp_visits": int(warp_visits.sum()),
            "live_warps": int(live.sum()),
            "warp_over_longest_ray_p50_p90_max": [float(np.percentile(ratio, 50)),
                                                  float(np.percentile(ratio, 90)),
                                                  float(ratio.max())],
            "sum_warp_over_sum_longest_ray": float(w.sum() / longest.sum()),
            "warp_x32_over_ray_sum": float(w.sum() * 32 / lanes.sum())}


def ptxas_lines(built, name):
    """ptxas's register and spill lines for source `name` from the build."""
    return [ln.split(":", 1)[-1].strip() for ln in built.get(name, {}).get("log", "").splitlines()
            if "Used" in ln or "spill" in ln]


def kernel_resources(lib):
    """Each kernel instance of a built library through its `kernel_info`
    entry point (cudaFuncGetAttributes and the occupancy calculator):
    registers per thread, local memory bytes, shared memory bytes, threads
    and resident blocks per SM."""
    import ctypes

    fn = lib.kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = []
    while True:
        v, label = (ctypes.c_int * 6)(), ctypes.create_string_buffer(64)
        rc = fn(len(out), v, label, 64)
        if rc:
            if not out:
                raise RuntimeError(f"kernel_info failed: CUDA error {rc}")
            return out
        out.append({"instance": label.value.decode(), "registers": v[0], "local_bytes": v[1],
                    "shared_bytes": v[2] + v[5], "threads": v[4], "blocks_per_sm": v[3]})


def ao_root_tests(pairs, records, chunk):
    """The walk of `trace_pairs_reference` over one batch of pair chunks,
    replayed -> (the (slot, ray) tests its result needs, [of those, the tests
    whose body, cap a, cap b discriminant is not negative])."""
    from linevis_tpu_torch.kernels.ao_grid import _BATCH_CHUNKS, _POISON, _any_hit

    C, dev = chunk, records.device
    n_chunks = pairs.seg_begin.shape[0]
    occ = torch.zeros((n_chunks, C), dtype=torch.bool, device=dev)
    rays = pairs.rays[:7, :n_chunks * C].reshape(7, n_chunks, C)
    begin, lane = pairs.seg_begin.long(), torch.arange(C, device=dev)
    last = records.shape[1] - 1
    pad = records.new_tensor([_POISON] * 3 + [0.0] * 5)[:, None, None]
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    roots = torch.zeros(3, dtype=torch.int64, device=dev)
    for c in range(int(pairs.seg_chunks.max()) if n_chunks else 0):
        for idx in torch.nonzero((pairs.seg_chunks > c) & ~occ.all(dim=1)).flatten().split(
                _BATCH_CHUNKS):
            cols = begin[idx, None] + c * C + lane
            seg = torch.where(cols[None] > last, pad, records[:, cols.clamp(max=last)])[..., None]
            ray = rays[:, idx, None, :]
            need = (seg[0] < 0.5 * _POISON) & ~occ[idx][:, None, :]  # [chunks, slots, rays]
            tests += need.sum()
            # The discriminants as `_any_hit` forms them.
            ox, oy, oz, dx, dy, dz, _ = ray
            oax, oay, oaz = ox - seg[0], oy - seg[1], oz - seg[2]
            bard = seg[3] * dx + seg[4] * dy + seg[5] * dz
            rdoa = oax * dx + oay * dy + oaz * dz
            baba = torch.clamp(seg[7], min=1e-20)
            rr = seg[6] * seg[6]
            t0 = -(rdoa + 0.5 * bard)
            pax, pay, paz = oax + t0 * dx, oay + t0 * dy, oaz + t0 * dz
            baoa = seg[3] * pax + seg[4] * pay + seg[5] * paz
            oaoa = pax * pax + pay * pay + paz * paz
            rd = rdoa + t0
            k2 = torch.clamp(baba - bard * bard, min=1e-20)
            k1 = baba * rd - baoa * bard
            k0 = baba * oaoa - baoa * baoa - rr * baba
            b1b = rd - bard
            hb = b1b * b1b - ((oaoa - 2.0 * baoa + baba) - rr)
            discs = (k1 * k1 - k2 * k0, rd * rd - (oaoa - rr), hb)
            roots += torch.stack([(need & (h >= 0.0)).sum() for h in discs])
            occ[idx] |= _any_hit(ray, seg).any(dim=1)
    return int(tests), roots.tolist()


# 24. Datasets from files (see `datasets_phase`).
DS_FRAMES = 8  # frames of the surface frame, the hull pass and the flow-file frame
DS_HEX_CELLS = (48, 48, 96)  # the Femur-like hexahedral mesh, whose boundary is the hull
DS_GRID_RES = 128  # the tornado grid of the grid tracer
DS_GRID_SEEDS, DS_GRID_STEPS = 512, 400  # the grid tracer's lines and their steps
DS_CHECK_SCALE = 0.1  # the surface frame's card-vs-CPU frame
DS_ORACLE_STRIDE = 4  # the coverage oracle reads every 4th pixel in x and y: one in 16
DS_GRID_SAMPLES = 65536  # trilinear samples held card vs CPU
DS_FIRST_STEPS = 16  # the grid tracer's steps held card vs CPU


def b3_check(csr, tile_w, tile_h):
    """B3 against its plain version on one CSR (`equal`: bit for bit on
    every output; the chunks each tile evaluated after early-z must be
    equal, or it raises) and the figures of its `kernels` row: its time,
    the plain version's, and the bound from the (slot, pixel) evaluations
    of the chunks the kernel evaluated after early-z and the plain
    version's updates. Its bytes: rows 0-15 of every evaluated slot, the
    attribute rows of every slot that ends as some pixel's winner, the
    tiles' chunk base and count, and the outputs. -> (kernel outputs,
    plain outputs, figures)."""
    from linevis_tpu_torch.kernels import raster_pallas

    n_tiles = csr.tile_chunk_base.shape[0]
    P = tile_w * tile_h
    work = torch.zeros(n_tiles, dtype=torch.int32, device=csr.payload.device)
    k_out = raster_pallas.rasterize_gbuffer(csr, TRIANGLE_PLANES, tile_w, tile_h, work=work)
    stats = {}
    p_out = raster_pallas.rasterize_triangles_reference(csr, tile_w, tile_h, TRIANGLE_PLANES,
                                                        stats=stats)
    if not torch.equal(work, stats["work"]):
        raise RuntimeError("B3's chunks evaluated per tile differ from its plain version's")
    k_all, p_all = [k_out[0], k_out[1], *k_out[2]], [p_out[0], p_out[1], *p_out[2]]
    equal = all(torch.equal(a, b) for a, b in zip(k_all, p_all))
    max_err = max(float((a - b).abs().max()) for a, b in zip([k_out[0], *k_out[2]],
                                                              [p_out[0], *p_out[2]]))
    # Real (not padded) slots in the chunks each tile evaluated after early-z.
    real = (csr.payload[15] < 2.5).sum(dim=1)
    cum = torch.cat([real.new_zeros(1), torch.cumsum(real, 0)])
    base = csr.tile_chunk_base.long()
    evaluated = int((cum[base + work.long()] - cum[base]).sum())
    per_tile = csr.tile_num_chunks.double()
    ms = _time_ms(lambda: raster_pallas.rasterize_gbuffer(csr, TRIANGLE_PLANES, tile_w, tile_h), 20)
    plain_ms = _time_ms(lambda: raster_pallas.rasterize_triangles_reference(
        csr, tile_w, tile_h, TRIANGLE_PLANES), 1)
    # A (tile, id) names one slot: the binning pairs each triangle with a tile once.
    ids = p_out[1].long()
    tile_of = torch.arange(n_tiles, device=ids.device)[:, None].expand_as(ids)
    won = ids >= 0
    winners = int(torch.unique(tile_of[won] * (int(ids.max()) + 1) + ids[won]).numel())
    out_bytes = (2 + TRIANGLE_PLANES) * n_tiles * P * 4
    in_bytes = (evaluated * TRIANGLE_STAGED_ROWS * 4 + winners * 3 * TRIANGLE_PLANES * 4
                + 2 * n_tiles * 4)
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = (evaluated * P * TRIANGLE_OPS_PER_EVAL
             + stats["takes"] * TRIANGLE_OPS_PER_TAKE) / H100_FP32_FLOPS * 1e3
    return k_out, p_out, {
        "equal": equal, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": in_bytes + out_bytes, "bytes_ms": t_bytes, "operations_ms": t_ops,
        "library_ms": None, "pairs": int(real.sum()), "chunks": int(csr.tile_num_chunks.sum()),
        "evaluated": evaluated, "chunks_evaluated": int(work.sum()), "updates": stats["takes"],
        "winning_slots": winners,
        "chunks_per_tile_p50": float(per_tile.quantile(0.5)),
        "chunks_per_tile_p99": float(per_tile.quantile(0.99)),
        "chunks_per_tile_max": int(csr.tile_num_chunks.max()),
        "tile": [tile_w, tile_h],
    }


def coverage_oracle(mesh, camera, fg, stride=DS_ORACLE_STRIDE, batch=1 << 22):
    """float64 reading of a surface frame's coverage: on the pixels (x, y)
    with x % stride == 0 and y % stride == 0, a float64 Moller-Trumbore ray
    from the camera through the pixel centre against every triangle whose
    float64 screen box, dilated by 1 px, holds that centre; against `fg`
    [H, W] (the frame's foreground). -> {"samples", "oracle_covered",
    "frame_covered", "lost": covered by the oracle, background in the frame,
    "extra": the reverse}."""
    from linevis_tpu_torch.automation.parity import _pixel_rays64
    from linevis_tpu_torch.render.opaque import _ray_basis_from_view_proj

    dev = fg.device
    H, W = fg.shape
    vp = torch.tensor(camera.view_projection_matrix(), dtype=torch.float64, device=dev)
    origin = torch.tensor(camera.position, dtype=torch.float64, device=dev)
    basis = _ray_basis_from_view_proj(vp)
    verts, tris = mesh.vertices.double(), mesh.triangles
    c = verts @ vp[:, :3].T + vp[:, 3]
    sx = (c[:, 0] / c[:, 3] * 0.5 + 0.5) * W
    sy = (0.5 - c[:, 1] / c[:, 3] * 0.5) * H
    nsx, nsy = (W - 1) // stride + 1, (H - 1) // stride + 1
    tx, ty = sx[tris], sy[tris]
    ix0 = torch.ceil((tx.min(dim=1).values - 1.5) / stride).clamp(min=0).long()
    ix1 = torch.floor((tx.max(dim=1).values + 0.5) / stride).clamp(max=nsx - 1).long()
    iy0 = torch.ceil((ty.min(dim=1).values - 1.5) / stride).clamp(min=0).long()
    iy1 = torch.floor((ty.max(dim=1).values + 0.5) / stride).clamp(max=nsy - 1).long()
    keep = (c[:, 3][tris] > 1e-4).all(dim=1) & (ix1 >= ix0) & (iy1 >= iy0)
    sel = torch.nonzero(keep).reshape(-1)
    covered = torch.zeros(nsy * nsx, dtype=torch.bool, device=dev)
    if sel.numel():
        mx = int((ix1 - ix0)[sel].max()) + 1
        my = int((iy1 - iy0)[sel].max()) + 1
        di = torch.arange(mx, device=dev)
        dj = torch.arange(my, device=dev)
        step = max(1, batch // (mx * my))
        for b0 in range(0, sel.numel(), step):
            t = sel[b0:b0 + step]
            gi = (ix0[t][:, None, None] + di[None, None, :]).expand(-1, my, mx)
            gj = (iy0[t][:, None, None] + dj[None, :, None]).expand(-1, my, mx)
            ok = (gi <= ix1[t][:, None, None]) & (gj <= iy1[t][:, None, None])
            tri = t[:, None, None].expand(-1, my, mx)[ok]
            gi, gj = gi[ok], gj[ok]
            d = _pixel_rays64(gi * stride, gj * stride, basis, W, H)  # [3, N]
            corner = [verts[tris[tri, k]].T for k in range(3)]  # [3, N] each
            e1, e2 = corner[1] - corner[0], corner[2] - corner[0]
            pvec = torch.linalg.cross(d, e2, dim=0)
            det = (e1 * pvec).sum(0)
            nz = det.abs() > 1e-300
            inv = 1.0 / torch.where(nz, det, torch.ones_like(det))
            tvec = origin[:, None] - corner[0]
            uu = (tvec * pvec).sum(0) * inv
            qvec = torch.linalg.cross(tvec, e1, dim=0)
            vv = (d * qvec).sum(0) * inv
            tt = (e2 * qvec).sum(0) * inv
            hit = nz & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 0)
            covered[(gj * nsx + gi)[hit]] = True
    frame = fg[::stride, ::stride].reshape(-1)
    return {"samples": int(covered.numel()), "oracle_covered": int(covered.sum()),
            "frame_covered": int(frame.sum()), "lost": int((covered & ~frame).sum()),
            "extra": int((frame & ~covered).sum())}


def datasets_phase(dev, gpu, traj, reset_launches, expect_launches, resources):
    """24. Datasets from files: every file type the JAX package reads,
    written to a temporary directory from in-repo generators, named in a
    datasets.json and loaded through `scene/factory.py:load_line_data`:
    the displaced icosphere (`entry.SPHERE_SUBDIVISIONS`) as binary STL,
    drawn through the registry's "Opaque (Triangle Mesh)"; the Femur-like
    lines with the boundary of a hexahedral mesh (ASCII VTK, `DS_HEX_CELLS`
    cells) as their hull in a v3 .dat, the hull drawn with the hull TF; the
    traced tornado `traj` as .binlines, .obj and NetCDF-classic, the
    .binlines through "Opaque"; and the grid streamline tracer (RKF45
    adaptive, loop termination) on the tornado sampled at `DS_GRID_RES`^3.
    Each of the three frames is also traced in this run order
    (`profiling.device_summary`).
    Returns the phase's `kernels` rows (B3 at tile 16x8 on the surface and
    the hull)."""
    import shutil
    import tempfile

    from scipy.io import netcdf_file

    from linevis_tpu_torch import native
    from linevis_tpu_torch.core.trajectories import (
        RaggedTrajectories,
        normalize_attributes,
        normalize_trajectories,
        pad_trajectories,
    )
    from linevis_tpu_torch.automation.profiling import device_summary, trace
    from linevis_tpu_torch.entry import (
        SPHERE_SUBDIVISIONS,
        TORNADO_RADIUS,
        displaced_icosphere,
        femur_hex_mesh,
        synth_v3_blocks,
        write_binary_stl,
        write_hex_mesh_vtk,
    )
    from linevis_tpu_torch.kernels import raster_pallas
    from linevis_tpu_torch.kernels.tiles import unpack_tiles
    from linevis_tpu_torch.loaders import mesh_loader
    from linevis_tpu_torch.loaders.binlines import BinLinesData, save_trajectories_as_binlines
    from linevis_tpu_torch.loaders.dataset_list import load_dataset_list
    from linevis_tpu_torch.loaders.hex_mesh import load_hull_from_hex_mesh
    from linevis_tpu_torch.loaders.stress_dat import (
        SimulationMeshHull,
        write_stress_trajectories_dat_v3,
    )
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.framebuffer import ssim
    from linevis_tpu_torch.render.pipeline import GBUFFER_PLANES, RasterSettings, build_payload
    from linevis_tpu_torch.render.renderer import create_renderer
    from linevis_tpu_torch.render.surface import (
        render_surface,
        shade_surface,
        surface_frame,
        surface_span,
        surface_tensors,
        surface_vertex_stage,
    )
    from linevis_tpu_torch.render.tube_raster import camera_tensors
    from linevis_tpu_torch.scene.factory import load_line_data
    from linevis_tpu_torch.scene.line_data import LineDataFlow
    from linevis_tpu_torch.scene.line_data_stress import LineDataStress
    from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData
    from linevis_tpu_torch.trace.fields import make_tornado_grid, sample_grid_trilinear
    from linevis_tpu_torch.trace.streamline import (
        StreamlineTracingSettings,
        trace_streamlines_grid,
    )

    parser = "native" if native.available() else "python"
    print(f"obj parser: {parser} ({native.library_path().name})", flush=True)
    if parser != "native":
        raise RuntimeError("the native loader library did not build on the card's machine")
    sync = torch.cuda.synchronize
    width, height, frames = W, H, DS_FRAMES
    base = Camera(position=(0.0, 0.1, 1.2), width=width, height=height)
    cams = [base.orbit(0.002 * (i + 1), 0.1, 1.2) for i in range(frames)]
    seconds = {}
    tmp = tempfile.mkdtemp(prefix="linevis_datasets_")

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[key] = time.perf_counter() - t0
        return out

    def path(name):
        return os.path.join(tmp, name)

    def in_order_trace(render_frame, items, host_ms):
        """The frames once more under the profiler, here in the smoke's run
        order: the card's busy ms and idle share against the host clock of
        the same frames timed without it (`host_ms`), the top kernels and
        host ops."""
        with trace() as prof:
            for item in items:
                render_frame(item)
                sync()
        out = device_summary(prof, float(np.sum(host_ms)), top=6)
        out["per_frame_busy_ms"] = out["device_busy_ms"] / len(items)
        return out

    try:
        # Write the files.
        n_tris = 20 * 4 ** SPHERE_SUBDIVISIONS
        timed("write_stl", lambda: write_binary_stl(path("sphere.stl"), displaced_icosphere()))
        points, hexes = femur_hex_mesh(*DS_HEX_CELLS)
        timed("write_vtk", lambda: write_hex_mesh_vtk(path("femur_hex.vtk"), points, hexes))
        hull = timed("hex_mesh_boundary", lambda: load_hull_from_hex_mesh(path("femur_hex.vtk")))
        write_stress_trajectories_dat_v3(
            path("femur.dat"), synth_v3_blocks(np.random.default_rng(11)),
            SimulationMeshHull(hull.vertices, hull.triangles, mesh_type="unstructured"))
        n_pts = traj.mask.sum(axis=1)
        names = list(traj.attribute_names)
        ragged = RaggedTrajectories([traj.positions[i, :n] for i, n in enumerate(n_pts)],
                                    [traj.attributes[i, :, :n] for i, n in enumerate(n_pts)],
                                    names)
        save_trajectories_as_binlines(path("tornado.binlines"), BinLinesData(ragged))
        obj_names = [n.replace(" ", "_") for n in names]
        with open(path("tornado.obj"), "w") as f:
            # 9 significant digits: every float32 reads back exactly.
            np.savetxt(f, np.concatenate(ragged.positions), fmt="v %.9g %.9g %.9g")
            np.savetxt(f, np.concatenate([a.T for a in ragged.attributes]),
                       fmt="vt " + " ".join(["%.9g"] * len(names)))
            f.write("a " + " ".join(obj_names) + "\n")
            offs = np.concatenate([[0], np.cumsum(n_pts)])
            for i in range(len(n_pts)):
                f.write("l " + " ".join(map(str, range(offs[i] + 1, offs[i + 1] + 1))) + "\n")
        # NetCDF (CF layout, tests/test_loaders.py): lat, lon and pressure
        # from the tornado's x, z and y (pressure 1000 exp(-(y + 0.5)), NaN
        # past a line's end), its first attribute as a fourth variable.
        m = traj.mask
        nc_vars = {
            "lat": np.where(m, traj.positions[..., 0], 0.0),
            "lon": np.where(m, traj.positions[..., 2], 0.0),
            "pressure": np.where(m, 1000.0 * np.exp(-(traj.positions[..., 1] + 0.5)), np.nan),
            "velocity_magnitude": np.where(m, traj.attributes[:, 0], 0.0),
        }
        nc_vars = {k: v.astype(np.float32)[None] for k, v in nc_vars.items()}
        f = netcdf_file(path("tornado.nc"), "w")
        f.createDimension("ensemble", 1)
        f.createDimension("trajectory", m.shape[0])
        f.createDimension("time", m.shape[1])
        for k, v in nc_vars.items():
            f.createVariable(k, "f", ("ensemble", "trajectory", "time"))[:] = v
        f.variables["velocity_magnitude"].standard_name = "Velocity Magnitude"
        f.close()
        line_width = 2.0 * TORNADO_RADIUS
        with open(path("datasets.json"), "w") as f:
            json.dump({"datasets": [
                {"type": "trimesh", "name": "sphere", "filenames": "sphere.stl"},
                {"type": "stress", "name": "femur", "filenames": "femur.dat", "version": 3},
                {"type": "node", "name": "tornado", "children": [
                    {"type": "flow", "name": name, "filenames": name, "linewidth": line_width}
                    for name in ("tornado.binlines", "tornado.obj", "tornado.nc")]},
            ]}, f)
        leaves = {x.name: x for x in load_dataset_list(path("datasets.json")).flat_leaves()}
        sizes = {n: os.path.getsize(path(n)) for n in sorted(os.listdir(tmp))}
        print("dataset files: " + json.dumps({"bytes": sizes, "write_seconds": dict(seconds),
                                              "parser": parser}), flush=True)

        # The surface frame.
        sphere = timed("load_sphere", lambda: load_line_data(leaves["sphere"]))
        if not isinstance(sphere, TriangleMeshData) or sphere.num_triangles != n_tris:
            raise RuntimeError("the STL did not load as the icosphere's TriangleMeshData")
        mesh_np = timed("stl_weld", lambda: mesh_loader._load_stl(path("sphere.stl")))
        nrm = timed("normals", lambda: mesh_loader.compute_vertex_normals(
            mesh_np.vertices, mesh_np.triangles))
        timed("curvature", lambda: mesh_loader.compute_curvature_attribute(
            mesh_np.vertices, mesh_np.triangles, nrm))
        renderer = create_renderer("Opaque (Triangle Mesh)", device=dev)
        renderer.set_line_data(sphere)
        renderer.render(cams[0])  # warm-up: the mesh's upload and the first launch
        sync()
        reset_launches()
        frame_ms, host_ms = [], []
        for cam in cams:
            a, b = _events()
            t0 = time.perf_counter()
            a.record()
            img = renderer.render(cam)
            b.record()
            sync()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            frame_ms.append(a.elapsed_time(b))
            if not np.isfinite(img).all():
                raise RuntimeError("non-finite surface frame")
        surface_launches = expect_launches({"triangle_raster": frames})["triangle_raster"]
        surface_trace = in_order_trace(renderer.render, cams, host_ms)

        mesh_t = sphere.get_surface_tensors(dev)
        stage_ms = {k: [] for k in ("span", "vertex_payload", "csr_binning", "kernel", "shade",
                                    "to_host")}
        per_frame = []
        for cam in cams:
            vp, cp, _ = camera_tensors(cam, dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            ev[0].record()
            S = renderer.raster_settings(cam)
            ev[1].record()
            batch = surface_vertex_stage(mesh_t.vertices, mesh_t.normals, mesh_t.attributes,
                                         mesh_t.triangles, vp, width, height)
            payload = build_payload(batch)
            ev[2].record()
            csr = raster_pallas.build_csr_binning(
                batch.tri_x, batch.tri_y, payload, batch.tri_valid, width, height, 16, 8,
                S.chunk, S.span_x, S.span_y, S.pairs_capacity)
            ev[3].record()
            raster = raster_pallas.rasterize_gbuffer(csr, GBUFFER_PLANES, 16, 8)
            ev[4].record()
            img = shade_surface(csr, raster, batch, vp, cp, S)
            ev[5].record()
            img.cpu()
            ev[6].record()
            sync()
            for k, (a, b) in zip(stage_ms, zip(ev[:-1], ev[1:])):
                stage_ms[k].append(a.elapsed_time(b))
            keys = S.span_x * S.span_y * n_tris
            per_frame.append({"span": [S.span_x, S.span_y], "keys": keys,
                              "pairs_capacity": min(keys, 2 * n_tris + 65536),
                              "overflow": int(csr.overflow)})
            del batch, payload, csr, raster, img
        vp0, cp0, _ = camera_tensors(cams[0], dev)
        S0 = renderer.raster_settings(cams[0])
        batch, csr = surface_frame(mesh_t, vp0, S0)
        k_out, _, fig_s = b3_check(csr, 16, 8)
        fg = unpack_tiles(k_out[1] >= 0, csr.tiles_x, csr.tiles_y, 16, 8, width, height)
        oracle = coverage_oracle(mesh_t, cams[0], fg)
        small = dataclasses.replace(cams[0], width=round(width * DS_CHECK_SCALE),
                                    height=round(height * DS_CHECK_SCALE))
        g_img = renderer.render(small)
        r_cpu = create_renderer("Opaque (Triangle Mesh)", device="cpu")
        r_cpu.set_line_data(sphere)
        c_img = r_cpu.render(small)
        check = [ssim(g_img[..., :3], c_img[..., :3]), float(np.abs(g_img - c_img).mean())]
        surface_line = {
            "frame_ms_median": float(np.median(frame_ms)),
            "host_ms_median": float(np.median(host_ms)),
            "frame_ms": frame_ms, "host_ms": host_ms, "trace": surface_trace,
            "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
            "triangles": n_tris, "vertices": sphere.num_vertices,
            "valid_triangles": int(batch.tri_valid.sum()), "per_frame": per_frame,
            "payload_chunks_capacity": int(csr.payload.shape[1]),
            "foreground": float(fg.float().mean()), "oracle": oracle,
            "b3_equal": fig_s["equal"],
            "card_vs_cpu_small (ssim, mean abs)": check,
            "load_seconds": {k: seconds[k] for k in ("load_sphere", "stl_weld", "normals",
                                                     "curvature")},
            "launches": surface_launches, "frames": frames, "width": width,
            "height": height, "gpu": gpu,
        }
        print("surface frame: " + json.dumps(surface_line), flush=True)
        if any(f["overflow"] for f in per_frame):
            raise RuntimeError("the surface frame's binning dropped pairs")
        if not fig_s["equal"]:
            raise RuntimeError("B3 disagrees with its plain version on the surface frame")
        if check[0] < 0.999 or check[1] > 2e-3 or not np.isfinite(g_img).all():
            raise RuntimeError("the card's surface frame disagrees with the CPU's")
        if surface_line["foreground"] < 0.2:
            raise RuntimeError("the surface frame is almost empty")
        del batch, csr, k_out, fg

        # The hull pass.
        femur = timed("load_femur_dat", lambda: load_line_data(leaves["femur"]))
        hull_mesh = femur.get_hull_surface()
        if hull_mesh is None or hull_mesh.triangles.shape != hull.triangles.shape:
            raise RuntimeError("the v3 .dat did not carry the hex mesh's boundary as its hull")
        hull_t = surface_tensors(hull_mesh, dev)
        color = ((0.0,) + LineDataStress.HULL_COLOR_LINEAR, (1.0,) + LineDataStress.HULL_COLOR_LINEAR)
        opacity = ((0.0, LineDataStress.HULL_OPACITY), (1.0, LineDataStress.HULL_OPACITY))

        def hull_settings(vp):
            sx, sy = surface_span(hull_t.vertices, hull_t.triangles, vp, width, height, 16, 8)
            return RasterSettings(width=width, height=height, tile_w=16, tile_h=8, span_x=sx,
                                  span_y=sy, tf_color=color, tf_opacity=opacity,
                                  background_color=(1.0, 1.0, 1.0, 0.0))

        hull_cams = [camera_tensors(c, dev) for c in cams]
        render_surface(hull_t, hull_cams[0][0], hull_cams[0][1], hull_settings(hull_cams[0][0]))
        sync()
        reset_launches()
        hull_ms, hull_host_ms = [], []
        for vp, cp, _ in hull_cams:
            a, b = _events()
            t0 = time.perf_counter()
            a.record()
            img = render_surface(hull_t, vp, cp, hull_settings(vp))
            b.record()
            sync()
            hull_host_ms.append((time.perf_counter() - t0) * 1e3)
            hull_ms.append(a.elapsed_time(b))
        hull_launches = expect_launches({"triangle_raster": frames})["triangle_raster"]
        hull_trace = in_order_trace(lambda c: render_surface(hull_t, c[0], c[1],
                                                             hull_settings(c[0])),
                                    hull_cams, hull_host_ms)
        hull_frames = []
        for vp, _, _ in hull_cams:
            S = hull_settings(vp)
            _, csr = surface_frame(hull_t, vp, S)
            keys = S.span_x * S.span_y * hull_t.num_triangles
            hull_frames.append({"span": [S.span_x, S.span_y], "keys": keys,
                                "pairs_capacity": min(keys, 2 * hull_t.num_triangles + 65536),
                                "overflow": int(csr.overflow)})
        S0 = hull_settings(hull_cams[0][0])
        batch, csr = surface_frame(hull_t, hull_cams[0][0], S0)
        k_out, _, fig_h = b3_check(csr, 16, 8)
        img = shade_surface(csr, k_out, batch, hull_cams[0][0], hull_cams[0][1], S0)
        covered = float((img[3] > 0).float().mean())
        hull_line = {
            "frame_ms_median": float(np.median(hull_ms)),
            "host_ms_median": float(np.median(hull_host_ms)),
            "frame_ms": hull_ms, "host_ms": hull_host_ms, "trace": hull_trace,
            "hull_triangles": hull_t.num_triangles, "hull_vertices": int(hull_t.vertices.shape[0]),
            "hex_cells": int(hexes.shape[0]), "per_frame": hull_frames,
            "covered": covered, "b3_equal": fig_h["equal"],
            "load_seconds": {k: seconds[k] for k in ("hex_mesh_boundary", "load_femur_dat")},
            "launches": hull_launches, "frames": frames, "width": width, "height": height,
            "gpu": gpu,
        }
        print("hull pass: " + json.dumps(hull_line), flush=True)
        if not fig_h["equal"]:
            raise RuntimeError("B3 disagrees with its plain version on the hull pass")
        if not bool(torch.isfinite(img).all()) or not 0.05 < covered < 0.95:
            raise RuntimeError("the hull pass is non-finite or empty")
        del batch, csr, k_out, img, hull_t

        # The flow files, loaded through the factory and held against what
        # was written.
        flows = {n: timed("load_" + n, lambda n=n: load_line_data(leaves[n]))
                 for n in ("tornado.binlines", "tornado.obj", "tornado.nc")}
        expected = normalize_attributes(normalize_trajectories(pad_trajectories(ragged)))
        p = nc_vars["pressure"][0]
        ok = np.isfinite(p) & (p > 0.0)
        log_min = np.log(max(p[ok].min(), 1e-30))
        log_max = np.log(max(np.nanmax(p), 1e-30))
        y = (np.log(np.maximum(p, 1e-30)) - log_max) / (log_min - log_max)
        nc_ragged = RaggedTrajectories(
            [np.stack([nc_vars["lat"][0, i, :n], y[i, :n], nc_vars["lon"][0, i, :n]],
                      axis=-1).astype(np.float32) for i, n in enumerate(n_pts)],
            [np.stack([p[i, :n], nc_vars["velocity_magnitude"][0, i, :n]]) for i, n in
             enumerate(n_pts)], ["pressure", "Velocity Magnitude"])
        nc_expected = normalize_attributes(normalize_trajectories(pad_trajectories(nc_ragged)))
        flow_check = {}
        for name, want, want_names in (("tornado.binlines", expected, names),
                                       ("tornado.obj", expected, obj_names),
                                       ("tornado.nc", nc_expected, nc_ragged.attribute_names)):
            got = flows[name].trajectories
            same_shape = got.positions.shape == want.positions.shape
            err = (max(float(np.abs(getattr(got, k) - getattr(want, k)).max())
                       for k in ("positions", "attributes")) if same_shape else float("inf"))
            flow_check[name] = {"max_abs_err": err, "load_seconds": seconds["load_" + name],
                                "mask_equal": same_shape and bool(np.array_equal(got.mask,
                                                                                 want.mask)),
                                "names": got.attribute_names == want_names}
            bar = 1e-6 if name == "tornado.nc" else 0.0
            if not (flow_check[name]["mask_equal"] and flow_check[name]["names"]) or err > bar:
                raise RuntimeError(f"{name} did not load as written: {flow_check[name]}")
        ld_file = flows["tornado.binlines"]
        r_op = create_renderer("Opaque", device=dev)
        r_op.set_line_data(ld_file)
        r_op.render(cams[0])
        sync()
        reset_launches()
        flow_ms, flow_host_ms, first = [], [], None
        for cam in cams:
            a, b = _events()
            t0 = time.perf_counter()
            a.record()
            img = r_op.render(cam)
            b.record()
            sync()
            flow_host_ms.append((time.perf_counter() - t0) * 1e3)
            flow_ms.append(a.elapsed_time(b))
            first = img if first is None else first
        flow_launches = expect_launches({"capsule_raster": frames})
        flow_trace = in_order_trace(r_op.render, cams, flow_host_ms)
        ld_mem = LineDataFlow(expected, name="memory")
        ld_mem.set_line_width(line_width)
        r_mem = create_renderer("Opaque", device=dev)
        r_mem.set_line_data(ld_mem)
        from_memory = bool(np.array_equal(first, r_mem.render(cams[0])))
        flow_line = {"files": flow_check, "frame_ms_median": float(np.median(flow_ms)),
                     "host_ms_median": float(np.median(flow_host_ms)),
                     "frame_ms": flow_ms, "host_ms": flow_host_ms, "trace": flow_trace,
                     "frame0_equals_memory": from_memory,
                     "foreground": float((first[..., :3] < 0.999).any(-1).mean()),
                     "launches": flow_launches["capsule_raster"], "frames": frames,
                     "width": width, "height": height, "gpu": gpu}
        print("flow files: " + json.dumps(flow_line), flush=True)
        if not from_memory or flow_line["foreground"] < 0.01:
            raise RuntimeError("the .binlines frame differs from the in-memory trajectories'")

        # The grid tracer: RKF45 adaptive with loop termination, card vs CPU.
        grid = timed("tornado_grid", lambda: make_tornado_grid(DS_GRID_RES))
        gs = StreamlineTracingSettings(num_seeds=DS_GRID_SEEDS, max_steps=DS_GRID_STEPS,
                                       dt=1.0 / 150.0, integrator="rkf45", adaptive=True,
                                       termination_distance=0.005, loop_min_gap=10)
        seeds = np.random.default_rng(42).uniform(size=(DS_GRID_SEEDS, 3)).astype(np.float32)
        trace_streamlines_grid(grid, dataclasses.replace(gs, max_steps=2), seeds, dev)
        sync()
        t0 = time.perf_counter()
        g_traj = trace_streamlines_grid(grid, gs, seeds, dev)
        trace_s = time.perf_counter() - t0
        c_traj = timed("grid_trace_cpu", lambda: trace_streamlines_grid(grid, gs, seeds, "cpu"))
        pts = np.random.default_rng(7).uniform(-0.1, 1.1, (DS_GRID_SAMPLES, 3)).astype(np.float32)
        g_grid = torch.as_tensor(grid, device=dev)
        samples = [sample_grid_trilinear(g, torch.as_tensor(pts, device=g.device)).cpu()
                   for g in (g_grid, torch.as_tensor(grid))]
        sample_err = float((samples[0] - samples[1]).abs().max())
        short = dataclasses.replace(gs, max_steps=DS_FIRST_STEPS)
        gf, cf = (trace_streamlines_grid(grid, short, seeds, d) for d in (dev, "cpu"))
        first_same = (gf.mask == cf.mask).all(axis=1)
        first_err = float(np.abs(gf.positions - cf.positions)[first_same].max())
        same = g_traj.num_points == c_traj.num_points
        grid_line = {
            "seconds": trace_s, "cpu_seconds": seconds["grid_trace_cpu"],
            "grid_seconds": seconds["tornado_grid"], "grid_res": DS_GRID_RES,
            "lines": int(g_traj.num_lines), "points": int(g_traj.mask.sum()),
            "points_per_line": [int(g_traj.num_points.min()), float(np.median(g_traj.num_points)),
                                int(g_traj.num_points.max())],
            "samples_max_abs_err": sample_err,
            f"first_{DS_FIRST_STEPS}_steps": {"lines_mask_equal": float(first_same.mean()),
                                              "max_abs_err": first_err},
            "full_trace": {"lines_equal_count": float(same.mean()),
                           "max_abs_err_those": float(np.abs(
                               g_traj.positions[same] - c_traj.positions[same]).max())
                           if same.any() else None},
            "settings": dataclasses.asdict(gs), "gpu": gpu,
        }
        print("grid tracer: " + json.dumps(grid_line), flush=True)
        if not np.isfinite(g_traj.positions).all() or int(g_traj.mask.sum()) < DS_GRID_SEEDS * 2:
            raise RuntimeError("the grid trace is non-finite or empty")
        if sample_err > 1e-6 or first_same.mean() < 0.99 or first_err > 1e-5:
            raise RuntimeError("the grid tracer's first steps or samples differ card vs CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    row = {"route": "cuda", "source": "linevis_tpu_torch/kernels/csrc/raster_triangle.cu",
           "replaces": "linevis_tpu/kernels/raster_pallas.py:427",
           "instances": resources.get("raster_triangle")}
    return [{"name": "triangle_raster:surface", **row, "launches": surface_launches, **fig_s},
            {"name": "triangle_raster:hull", **row, "launches": hull_launches, **fig_h}]


# The scattering, VRC and multivariate phase (`scattering_phase`).
SC_CAMERA = (0.0, 0.15, 0.9)  # the cloud frames' camera, looking at its centre
# The density map's camera: on the side the traced paths enter from (the
# tracer's camera sits at (-0.5, -0.5, -0.5); 128 events take a path ~0.13 in).
SC_LDM_CAMERA = (-0.6, -0.45, -0.55)
SC_VPT_FRAMES = 4
SC_FRAMES = 8  # the density map, VRC and multivariate frames
SC_HEAT_FRAMES = 4
SC_CHECK_SCALE = 0.1  # the card-vs-CPU frames
SC_VRC = dict(grid_resolution=128, quantization=8)
# Work of the bounds, counted from this run's events, scatters, steps and
# pairs; a library function (logf, expf, sqrtf, cosf, a division) counts as
# one operation. Integer operations are (logic and shifts, adds): the INT32
# lanes run the first, while the compiler issues adds on either pipe (IMAD.IADD
# or IADD3). One threefry2x32, as the SASS of `csrc/vpt_tracking.cu`'s
# `threefry_kernel` has it: 20 rotates (funnel shifts) and 21 xors (the
# rounds, the key's third word), 26 adds (rounds and key injections, IADD3
# taking three inputs); a uniform adds the bits' xor, shift and or and a
# float subtract.
THREEFRY_OPS = (41, 26)
# R3, (logic, add, float) operations: a ray's key, box test, sky and outputs;
# an event that collides: five threefry (the event's key, two keys, two
# uniforms), the trilinear sample's integer work (clamps, brick index: 12
# logic, 5 adds) and ~82 float (free flight, the move, the grid coordinates,
# the sample, the probabilities); an event that leaves the volume: three
# threefry and the free flight; a scatter besides: five threefry (k3, two
# keys, two uniforms), the phase sample and the box test (~116 float).
VPT_OPS = {"ray": (THREEFRY_OPS[0], THREEFRY_OPS[1], 155),
           "collision": (5 * THREEFRY_OPS[0] + 6 + 12, 5 * THREEFRY_OPS[1] + 5, 82),
           "leave": (3 * THREEFRY_OPS[0] + 3, 3 * THREEFRY_OPS[1], 12),
           "scatter": (5 * THREEFRY_OPS[0] + 6, 5 * THREEFRY_OPS[1], 116)}
# R7, (logic, add, float) operations by event kind (`vpt_decomposition`'s
# `kinds`): the draws each kind's branch reads (THREEFRY_OPS each, a
# uniform's bits 3 logic and a float subtract) and its float work counted
# from the source (a library function or division one operation). A ray:
# its key, box test, sky and outputs; one in the box also its first super
# voxel (three divisions) and that super voxel's state. A super voxel's
# state, wherever it is entered (after a skip, a crossing or a scatter):
# its min and max (address: 6 logic, 6 adds), mu_c and mu_r, the exit face
# (a division an axis: the face ahead) and its axis, ~64 float. A skip: the
# move and the next super voxel. An entry: k_j, a key, a uniform; logf and
# a division. A residual candidate without a density test: the same draws
# and the crossing into the next super voxel. With a test (a null
# collision): two more threefry and a uniform, the point, the grid
# coordinates (three divisions) and the trilinear sample (12 logic, 5 adds,
# ~40 float). A collision, as a control hit: k_j, u1, and u3 =
# uniform(split(k_j, 3)) where rays can be absorbed (`absorb_test`, charged
# per collision when the albedo is below 1); a scatter besides: k_5, two
# keys, two uniforms, the phase sample (~60 float), the point and the next
# super voxel. A tested collision adds the density test's draws and sample.
_TF, _U = THREEFRY_OPS, (3, 0, 1)


def _r7_ops(hashes, uniforms, logic, adds, floats):
    return (hashes * _TF[0] + uniforms * _U[0] + logic, hashes * _TF[1] + adds,
            uniforms * _U[2] + floats)


R7_KIND_OPS = {"ray": _r7_ops(1, 0, 0, 0, 150), "ray_in_box": _r7_ops(0, 0, 8, 10, 76),
               "skip": _r7_ops(0, 0, 8, 10, 70),
               "enter": _r7_ops(3, 1, 0, 0, 6), "residual": _r7_ops(3, 1, 8, 10, 78),
               "residual_tested": _r7_ops(5, 2, 12, 5, 65),
               "absorb": _r7_ops(3, 1, 0, 0, 12), "scatter": _r7_ops(8, 3, 8, 10, 152),
               "absorb_test": _r7_ops(2, 1, 0, 0, 1),
               "tested_collision": _r7_ops(2, 1, 12, 5, 50)}
# The count of the first design's bound (printed beside): every event
# charged as the cheapest (its key, an empty super voxel crossed), nothing
# for flights, samples, collisions or scatters.
R7_OPS_EVERY_EVENT = {"ray": (THREEFRY_OPS[0], THREEFRY_OPS[1], 170),
                      "event": (THREEFRY_OPS[0] + 2, THREEFRY_OPS[1] + 4, 70)}
# R8, (logic, add, float) operations: a ray's key and outputs; a bounce's
# four keys and stop uniform, box test, DDA set-up (three divisions, three
# reciprocals), sky and sun and the accumulation; a bounce that goes on:
# the phase sample (two keys, two uniforms); a DDA step: the exit distance,
# the super voxel's two values, the segment's start and control term, the
# advance; a residual step: five threefry (three keys, two uniforms), the
# trilinear sample's integer work (12 logic, 5 adds) and ~74 float (free
# flight, position, grid coordinates, the sample, the ratio, the
# reservoir's weight and draw).
R8_OPS = {"ray": (THREEFRY_OPS[0], THREEFRY_OPS[1], 0),
          "bounce": (5 * THREEFRY_OPS[0] + 3, 5 * THREEFRY_OPS[1], 195),
          "turn": (4 * THREEFRY_OPS[0] + 6, 4 * THREEFRY_OPS[1], 60),
          "dda_step": (0, 4, 30),
          "residual_step": (5 * THREEFRY_OPS[0] + 6 + 12, 5 * THREEFRY_OPS[1] + 5, 74)}
# R3 on a SparseGrid: a colliding event's sample also finds its brick in the
# table (three divisions and three remainders by the block, the address).
R3_SPARSE_OPS = dict(VPT_OPS, collision=(VPT_OPS["collision"][0] + 6,
                                         VPT_OPS["collision"][1] + 12, VPT_OPS["collision"][2]))
# R4, (logic, add, float) operations, as the SASS of `csrc/density_march.cu`'s
# POW2, SKIP instance has them: a pixel's ray, its clip, the estimate's set-up
# and its output; a step that samples an occupied cell, a quarter of the
# batch path with its loop head (138, 137, 499 for four steps: the cells, the
# 32 loads' addresses, the lerps, both TFs' segment compares and divisions,
# expf and the blend). Steps in empty bricks add nothing: not the function's
# work (`bound_ms_every_step` charges every step in the box as sampled).
R4_OPS = {"ray": (55, 63, 124), "sampled_step": (35, 34, 125)}
# An in-range (pixel, direction) pair of R5: the distance (3 subtracts, 3
# multiplies, 2 adds, the clamp, sqrt), the compare, 3 dist / 0.1 (a multiply
# and a division), the square, expf and the add.
HEAT_OPS_PER_PAIR_IN_RANGE = 16
# One uniform of R6, (logic, add, float): threefry2x32, the bits' xor, shift
# and or, the subtract.
R6_OPS_PER_UNIFORM = (THREEFRY_OPS[0] + 3, THREEFRY_OPS[1], 1)


def int32_ops_per_s():
    """The card's INT32 rate: 64 INT32 lanes an SM (Hopper) x its SMs x the
    SM clock nvidia-smi reads as clocks.max.sm."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 64 * mhz * 1e6


def ops_ms(logic, adds, floats, int_rate):
    """The least time of the (logic, add, float) operations: logic and shifts
    on the INT32 lanes; and every operation through the SM's issue, 128
    lanes an SM (twice the INT32 lanes' rate), where an integer operation is
    one instruction and the float operations go at H100_FP32_FLOPS (which
    counts an FMA as two)."""
    return max(logic / int_rate,
               (logic + adds) / (2.0 * int_rate) + floats / H100_FP32_FLOPS) * 1e3


def vpt_extension(dev, gpu, ld, base, grid, rays, p_delta, frames, host_timed, int_rate, built):
    """Part of phase 25: the registry's "Volumetric Path Tracer" in
    Decomposition tracking (kernel R7, `vpt_decomposition`) and Residual
    Ratio tracking (R8, `vpt_residual_ratio`), SC_VPT_FRAMES 1080p frames of
    2 samples each, one launch a sample; each kernel bit for bit with its
    plain version (events, or bounces and steps, included) on the middle row
    of both samples, sliced from whole-sample launches (~10.6 s and ~26.3 s
    of plain time on an H100 host; R7's events by kind too, which charge its
    bound); both modes card vs CPU at
    SC_CHECK_SCALE. Then R3 on `SparseGrid.from_dense(cloud, 8)`: that row
    of sample 0 bit for bit with its plain version on the SparseGrid, the
    whole sample with R3's dense launch (`p_delta`), and SC_VPT_FRAMES
    frames of `render_vpt` on the SparseGrid, the first equal to the dense
    grid's. `rays` are the first frame's two samples (origins, dirs, kt) on
    `grid`, the cloud; `frames` and `host_timed` the phase's timers. Returns
    the three `kernels` rows."""
    from linevis_tpu_torch.core.settings import SettingsMap
    from linevis_tpu_torch.kernels import vpt_decomposition as vd
    from linevis_tpu_torch.kernels import vpt_residual_ratio as vr
    from linevis_tpu_torch.kernels import vpt_tracking as vt
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render.framebuffer import image_mean_difference, ssim
    from linevis_tpu_torch.render.renderer import create_renderer
    from linevis_tpu_torch.render.super_voxel import super_voxel_grid_of, super_voxel_minmax_of
    from linevis_tpu_torch.render.tube_raster import _ray_basis, camera_tensors
    from linevis_tpu_torch.render.vpt import VptSettings, render_vpt, sun_constants
    from linevis_tpu_torch.scene.sparse_grid import SparseGrid

    vs = VptSettings()
    f32 = np.float32
    ext, alb = np.asarray(vs.extinction, f32), np.asarray(vs.scattering_albedo, f32)
    sun_dir, sun_ic = sun_constants(vs)
    n_rays = W * H
    r0 = (H // 2) * W
    n_row = W
    row_rays = [(o[r0:r0 + n_row].contiguous(), d[r0:r0 + n_row].contiguous(), kt)
                for o, d, kt in rays]
    sw, sh = int(W * SC_CHECK_SCALE), int(H * SC_CHECK_SCALE)
    small = dataclasses.replace(base, width=sw, height=sh)
    out, rows = {}, []

    def registry_frames(mode, kernel):
        """The registry's frames in `mode` -> (event ms, host ms, launches,
        card-vs-CPU figures at SC_CHECK_SCALE)."""
        r = create_renderer("Volumetric Path Tracer", SettingsMap({"vpt_mode": mode}), device=dev)
        r.set_line_data(ld)
        (_, build_ms) = host_timed(lambda: r.render(base))  # super voxels, first launches
        r.set_line_data(ld)  # the accumulation restarts; the grid and its super voxels stay
        img, ev_ms, host_ms, launches = frames(r.render, [base] * SC_VPT_FRAMES,
                                               {kernel: 2 * SC_VPT_FRAMES}, warm=False)
        if not np.isfinite(img).all() or not (img[..., :3].std() > 1e-3):
            raise RuntimeError(f"the {mode} frame is non-finite or flat")
        chk = {}
        for d_ in (dev, "cpu"):
            rc = create_renderer("Volumetric Path Tracer", SettingsMap({"vpt_mode": mode}),
                                 device=d_)
            rc.set_line_data(ld)
            chk[str(d_)], chk[f"{d_}_ms"] = host_timed(lambda: rc.render(small))
        a, b = chk[str(dev)][..., :3], chk["cpu"][..., :3]
        fig = {"image_mean_difference": image_mean_difference(a, b), "ssim": ssim(a, b),
               "mean_abs": float(np.abs(chk[str(dev)] - chk["cpu"]).mean()),
               "card_ms": chk[f"{dev}_ms"], "cpu_ms": chk["cpu_ms"]}
        if fig["image_mean_difference"] > 2e-3 or fig["ssim"] < 0.999 or fig["mean_abs"] > 2e-3:
            raise RuntimeError(f"the {mode} frame on the card differs from the CPU's: {fig}")
        return {"frame_ms": ev_ms, "host_ms": host_ms, "frame_ms_median": float(np.median(ev_ms)),
                "host_ms_median": float(np.median(host_ms)), "first_frame_ms": build_ms,
                "launches": launches[kernel], "mean_rgb": float(img[..., :3].mean()),
                f"card_vs_cpu_{sw}x{sh}": fig}

    def against_plain(name, launch, plain, counts_shape):
        """`launch(o, d, kt, counts)` on both whole samples, the slice of
        the middle row against `plain(o, d, kt, counts, first)` on it (every
        output and the counts bit for bit), and two whole launches equal."""
        k_rows, counts_full = [], None
        for o, d, kt in rays:
            c = torch.empty((n_rays,) + counts_shape, dtype=torch.int32, device=dev)
            res = launch(o, d, kt, c)
            k_rows.append([x[r0:r0 + n_row] for x in (*res, c)])
            if counts_full is None:
                counts_full = c
                again = launch(o, d, kt, torch.empty_like(c))
                twice_equal = all(torch.equal(x, y) for x, y in zip(res, again))
            del res
        k_out = [torch.cat(x) for x in zip(*k_rows)]
        c_p = torch.empty((len(rays) * n_row,) + counts_shape, dtype=torch.int32, device=dev)

        def plain_rows():
            outs = [plain(o, d, kt, c_p[s * n_row:(s + 1) * n_row], r0)
                    for s, (o, d, kt) in enumerate(row_rays)]
            return [torch.cat(x) for x in zip(*outs)] + [c_p]

        p_out, plain_ms = host_timed(plain_rows)
        equal = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
        fig = {"equal": equal, "plain_ms": plain_ms, "two_full_launches_equal": twice_equal,
               "max_abs_err": float((k_out[0] - p_out[0]).abs().max()),
               "counted_on_the_rows": [int(v) for v in c_p.reshape(len(rays) * n_row, -1)
                                       .sum(0)]}
        if not (equal and twice_equal):
            raise RuntimeError(f"{name} differs from its plain version on the rows sliced from "
                               f"its whole-sample launches, or two launches differ: {fig}")
        return fig, counts_full

    # R7.
    dmin_g, dmax_g = super_voxel_minmax_of(grid, vs.super_voxel_size)
    p7 = vd.decomposition_params(grid.shape, dmin_g.shape, ext, alb, sun_dir, sun_ic, vs.phase_g,
                                 vs.max_events)
    frames7 = registry_frames("Decomposition Tracking", "vpt_decomposition")
    # counts: each ray's events, then its events by kind (`EVENT_KINDS`).
    fig7, c7 = against_plain(
        "vpt_decomposition",
        lambda o, d, kt, c: vd.vpt_decomposition(grid, dmin_g, dmax_g, o, d, kt, p7,
                                                 events=c[:, 0], kinds=c[:, 1:]),
        lambda o, d, kt, c, first: vd.vpt_decomposition_reference(
            grid, dmin_g, dmax_g, o, d, kt, p7, events=c[:, 0], first=first, kinds=c[:, 1:]),
        (1 + len(vd.EVENT_KINDS),))
    ms7 = _time_ms(lambda: vd.vpt_decomposition(grid, dmin_g, dmax_g, *rays[0], p7), 3)
    ev7 = c7[:, 0]
    events7 = int(ev7.double().sum())
    kinds7 = dict(zip(vd.EVENT_KINDS, (int(v) for v in c7[:, 1:].double().sum(0))))
    if sum(kinds7[k] for k in vd.EVENT_KINDS[:6]) != events7:
        raise RuntimeError(f"R7's event kinds do not sum to its events: {kinds7}, {events7}")
    collisions7 = kinds7["absorb"] + kinds7["scatter"]
    count7 = {"ray": n_rays, "ray_in_box": int((ev7 > 0).sum()), **kinds7,
              "absorb_test": collisions7 if p7.abs_albedo > 0 else 0}
    ops7 = [sum(count7[k] * R7_KIND_OPS[k][i] for k in R7_KIND_OPS) for i in range(3)]
    every_event = {"ray": n_rays, "event": events7}
    ops7_every_event = [sum(every_event[k] * R7_OPS_EVERY_EVENT[k][i] for k in every_event)
                        for i in range(3)]
    bytes7 = grid.numel() * 4 + 2 * dmin_g.numel() * 4 + 8 + n_rays * (24 + 12)
    evf = ev7.double()
    hit = evf > 0
    out["decomposition"] = {
        **frames7, "kernel_vs_plain_rows": fig7, "ms_full_sample": ms7,
        "events_per_ray": {"p50": float(evf[hit].quantile(0.5)),
                           "p99": float(evf[hit].quantile(0.99)), "max": int(evf.max()),
                           "events": events7,
                           "share_at_max_events": float((evf == vs.max_events).double().mean())},
        "events_by_kind": kinds7}
    del ev7, evf, hit, c7

    # R8.
    sv = super_voxel_grid_of(grid, float(ext[0]), vs.super_voxel_size)
    p8 = vr.rr_params(grid.shape, sv.mu_c.shape, ext, alb, sun_dir, sun_ic, vs.phase_g)
    frames8 = registry_frames("Residual Ratio Tracking", "vpt_residual_ratio")
    fig8, st8 = against_plain(
        "vpt_residual_ratio",
        lambda o, d, kt, c: vr.vpt_residual_ratio(grid, sv, o, d, kt, p8, steps=c),
        lambda o, d, kt, c, first: vr.vpt_residual_ratio_reference(
            grid, sv, o, d, kt, p8, steps=c, first=first), (3,))
    ms8 = _time_ms(lambda: vr.vpt_residual_ratio(grid, sv, *rays[0], p8), 3)
    tot8 = [int(v) for v in st8.double().sum(0)]
    count8 = {"ray": n_rays, "bounce": tot8[0], "turn": tot8[0] - n_rays, "dda_step": tot8[1],
              "residual_step": tot8[2]}
    ops8 = [sum(count8[k] * R8_OPS[k][i] for k in R8_OPS) for i in range(3)]
    bytes8 = grid.numel() * 4 + 2 * sv.mu_c.numel() * 4 + 8 + n_rays * (24 + 12 + 12 + 1)
    out["residual_ratio"] = {
        **frames8, "kernel_vs_plain_rows": fig8, "ms_full_sample": ms8, "counted": count8,
        "bounces_max": int(st8[:, 0].max()), "dda_steps_max": int(st8[:, 1].max()),
        "residual_steps_max": int(st8[:, 2].max())}
    del st8

    # R3 on a SparseGrid of the cloud.
    cloud = grid.cpu().numpy()
    sg, sparse_ms = host_timed(lambda: SparseGrid.from_dense(cloud, 8, device=dev))
    del cloud
    o_row, d_row, kt0 = row_rays[0]
    ev_k = torch.empty(n_rays, dtype=torch.int32, device=dev)
    sc_k = torch.empty_like(ev_k)
    sp = vt.vpt_tracking(sg, *rays[0], p_delta, events=ev_k, scatters=sc_k)
    dense = vt.vpt_tracking(grid, *rays[0], p_delta)
    dense_equal = all(torch.equal(a, b) for a, b in zip(sp, dense))
    ev_p = torch.empty(n_row, dtype=torch.int32, device=dev)
    sc_p = torch.empty_like(ev_p)
    ref, plain3_ms = host_timed(lambda: vt.vpt_tracking_reference(
        sg, o_row, d_row, kt0, p_delta, events=ev_p, first=r0, scatters=sc_p))
    row_equal = (all(torch.equal(a[r0:r0 + n_row], b) for a, b in zip(sp, ref))
                 and torch.equal(ev_k[r0:r0 + n_row], ev_p)
                 and torch.equal(sc_k[r0:r0 + n_row], sc_p))
    err3 = float((sp[0][r0:r0 + n_row] - ref[0]).abs().max())
    ms3 = _time_ms(lambda: vt.vpt_tracking(sg, *rays[0], p_delta), 3)
    cam_t = camera_tensors(base, dev)
    basis = _ray_basis(cam_t[0])

    def sparse_frame(cam, grid_=sg):
        return render_vpt(threefry.prng_key(0, dev), grid_, cam_t[1], basis, W, H, settings=vs,
                          spp=vs.samples_per_frame)

    img_s, ev_ms3, host_ms3, launches3 = frames(sparse_frame, [base] * SC_VPT_FRAMES,
                                                {"vpt_tracking": 2 * SC_VPT_FRAMES})
    frame_equal = torch.equal(img_s, sparse_frame(base, grid))
    leaves = int(((ev_k > 0) & (ev_k < vs.max_events)).sum())
    events3 = int(ev_k.double().sum())
    count3 = {"ray": n_rays, "collision": events3 - leaves, "leave": leaves,
              "scatter": int(sc_k.double().sum())}
    ops3 = [sum(count3[k] * R3_SPARSE_OPS[k][i] for k in R3_SPARSE_OPS) for i in range(3)]
    bytes3 = (sg.bricks.numel() + sg.table.numel()) * 4 + 8 + n_rays * (24 + 12 + 12 + 1)
    out["sparse_grid"] = {
        "block": sg.block, "active_bricks": sg.n_active, "memory_ratio": sg.memory_ratio(),
        "from_dense_ms": sparse_ms, "row_equal": row_equal, "plain_ms": plain3_ms,
        "whole_sample_equal_to_dense": dense_equal, "first_frame_equal_to_dense": frame_equal,
        "ms_full_sample": ms3, "frame_ms": ev_ms3, "host_ms": host_ms3,
        "frame_ms_median": float(np.median(ev_ms3)), "launches": launches3["vpt_tracking"],
        "counted": count3}
    out.update({"frames": SC_VPT_FRAMES, "spp": vs.samples_per_frame, "width": W, "height": H,
                "plain_on": f"row {H // 2}", "gpu": gpu})
    print("vpt decomposition, residual ratio, sparse grid: " + json.dumps(out), flush=True)
    if not (row_equal and dense_equal and frame_equal):
        raise RuntimeError("R3 on the SparseGrid differs from its plain version or from the dense "
                           "grid's launch")
    del sp, dense, ref, img_s, ev_k, sc_k, sg

    def row(name, source, replaces, note, launches, ms, plain_ms, err, ops, nbytes, counted,
            opsdef, per_launch, plain_on, ptx):
        t_bytes = nbytes / H100_HBM_BYTES * 1e3
        t_ops = ops_ms(*ops, int_rate)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "replaces_note": note, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes", "bytes": nbytes,
                "bytes_ms": t_bytes, "operations_ms": t_ops, "library_ms": None,
                "per_launch": per_launch, "plain_on": plain_on, "counted": counted,
                "ops_logic_add_float": opsdef, "operations": ops, "int32_ops_per_s": int_rate,
                "ptxas": ptx}

    rows_on = f"row {H // 2} of both samples ({2 * n_row} rays), sliced from whole-sample launches"
    rows.append(row(
        "vpt_decomposition", "linevis_tpu_torch/kernels/csrc/vpt_decomposition.cu",
        "linevis_tpu/render/vpt.py:342",
        "no pallas_call: _decomposition_trace's vmapped lax.scan of events (vpt.py:342-473)",
        out["decomposition"]["launches"], ms7, fig7["plain_ms"], fig7["max_abs_err"], ops7, bytes7,
        count7, R7_KIND_OPS, "one sample of every pixel (2 a frame)", rows_on,
        ptxas_lines(built, "vpt_decomposition")))
    rows[-1]["bound_ms_charging_every_event_as_the_cheapest"] = max(
        bytes7 / H100_HBM_BYTES * 1e3, ops_ms(*ops7_every_event, int_rate))
    rows.append(row(
        "vpt_residual_ratio", "linevis_tpu_torch/kernels/csrc/vpt_residual_ratio.cu",
        "linevis_tpu/render/vpt.py:281",
        "no pallas_call: _residual_ratio_trace's vmapped lax.while_loop of bounces (vpt.py:"
        "281-339), each the lax.scan DDA and lax.while_loop segments of super_voxel.py:114-236",
        out["residual_ratio"]["launches"], ms8, fig8["plain_ms"], fig8["max_abs_err"], ops8, bytes8,
        count8, R8_OPS, "one sample of every pixel (2 a frame)", rows_on,
        ptxas_lines(built, "vpt_residual_ratio")))
    rows.append(row(
        "vpt_tracking:sparse", "linevis_tpu_torch/kernels/csrc/vpt_tracking.cu",
        "linevis_tpu/render/vpt.py:189",
        "no pallas_call: trace_one's lax.scan (vpt.py:189-278) on a SparseGrid "
        "(scene/sparse_grid.py:71-99 sample)", out["sparse_grid"]["launches"], ms3, plain3_ms,
        err3, ops3, bytes3, count3, R3_SPARSE_OPS,
        "one Delta-tracking sample of every pixel on SparseGrid.from_dense(cloud, 8)",
        f"row {H // 2} of sample 0, sliced from a whole-sample launch", []))
    return rows


def scattering_phase(dev, gpu, traj, reset_launches, expect_launches, built):
    """25. Scattering, VRC and multivariate tubes: a procedural cloud
    (`entry.procedural_cloud`) traced by `LineDataScattering.trace`
    (`entry.SCATTERING_TRACE`),
    written and reloaded as .xyz, drawn through the registry's "Volumetric
    Path Tracer" (the renderer's defaults: Delta tracking, extinction 1024,
    512 events, 2 spp; kernel vpt_tracking twice a frame), "Line Density
    Map Renderer" (density_march once) and "Spherical Heat Map Renderer"
    (spherical_heatmap once); the tornado `traj` through "Voxel Ray Casting"
    (capsule_raster once) and as multivariate tubes through `render_opaque`
    (triangle_raster once). Each kernel against its plain version (R3 on one
    1080p row in each scan mode, R4 on the whole frame, R5 on two bands;
    R3's and R5's sliced from launches on the whole sample or map),
    card-vs-CPU frames at SC_CHECK_SCALE, and `vpt_extension`'s
    decomposition and residual ratio frames and R3 on a SparseGrid. Returns
    the phase's `kernels` rows."""
    import shutil
    import tempfile

    from linevis_tpu_torch.core.settings import SettingsMap
    from linevis_tpu_torch import entry
    from linevis_tpu_torch.entry import TORNADO_LINE_WIDTH, TORNADO_RADIUS
    from linevis_tpu_torch.kernels import density_march as dm
    from linevis_tpu_torch.kernels import spherical_heatmap as shm
    from linevis_tpu_torch.kernels import vpt_tracking as vt
    from linevis_tpu_torch.loaders.cloud_loader import load_cloud_file, write_cloud_xyz
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.framebuffer import image_mean_difference, ssim
    from linevis_tpu_torch.render.multivar import (
        MultiVarTransferFunctions,
        build_multivar_tube_mesh,
        combine_transfer_function_table,
    )
    from linevis_tpu_torch.render.opaque import render_opaque
    from linevis_tpu_torch.render.pipeline import RasterSettings, build_payload, tube_vertex_stage
    from linevis_tpu_torch.render.renderer import create_renderer
    from linevis_tpu_torch.render.spherical_heatmap import mollweide_points
    from linevis_tpu_torch.render.tube_raster import (
        _ray_basis,
        camera_tensors,
        prepare_capsule_frame,
    )
    from linevis_tpu_torch.render.vpt import VptSettings, primary_rays, sun_constants
    from linevis_tpu_torch.scene.line_data import LineData
    from linevis_tpu_torch.scene.line_data_scattering import LineDataScattering
    from linevis_tpu_torch.trace.scattering import ScatteringTracingSettings
    from linevis_tpu_torch.kernels import raster_pallas

    sync = torch.cuda.synchronize
    rows = []
    int_rate = int32_ops_per_s()

    def host_timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def frames(render, cams, expected, warm=True):
        """Time `render(cam)` per camera with CUDA events and the host clock,
        launches counted (after a warm-up frame unless `warm` is False) ->
        (last image, event ms, host ms, launches)."""
        if warm:
            render(cams[0])
        sync()
        reset_launches()
        ev_ms, host_ms, img = [], [], None
        for cam in cams:
            a, b = _events()
            t0 = time.perf_counter()
            a.record()
            img = render(cam)
            b.record()
            sync()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(a.elapsed_time(b))
        return img, ev_ms, host_ms, expect_launches(expected)

    # The scene: the cloud on the card, traced, written and reloaded.
    # The cloud (`entry.procedural_cloud`: 512^3 float32, 537 MB on the card,
    # 300 blobs) and its trace (`entry.SCATTERING_TRACE`: 40,960 paths).
    cloud_t, cloud_ms = host_timed(lambda: entry.procedural_cloud(
        dev, entry.CLOUD_SIZE, entry.CLOUD_BLOBS))
    cloud = cloud_t.cpu().numpy()
    del cloud_t
    if cloud.max() != 1.0 or cloud.min() != 0.0:
        raise RuntimeError("the procedural cloud does not span [0, 1]")
    trace_kw = entry.SCATTERING_TRACE
    sc_settings = ScatteringTracingSettings(**trace_kw)
    ld, trace_ms = host_timed(lambda: LineDataScattering.trace(cloud, sc_settings, device=dev))
    tmp = tempfile.mkdtemp(prefix="linevis_cloud_")
    try:
        path = os.path.join(tmp, "cloud.xyz")
        _, write_ms = host_timed(lambda: write_cloud_xyz(path, cloud))
        loaded, load_ms = host_timed(lambda: load_cloud_file(path))
        file_equal = bool(np.array_equal(loaded.density, cloud))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    scene_line = {
        "cloud_voxels": list(cloud.shape), "cloud_ms": cloud_ms,
        "occupied_share": float((cloud > 0).mean()), "trace_ms": trace_ms,
        "paths": trace_kw["res_x"] * trace_kw["res_y"] * trace_kw["samples_per_pixel"],
        "paths_kept": ld.num_lines, "points": ld.num_line_points,
        "exit_directions": int(ld.exit_directions.shape[0]),
        "xyz_write_ms": write_ms, "xyz_load_ms": load_ms, "xyz_equal": file_equal,
        "trace_settings": trace_kw, "gpu": gpu}
    print("scattering scene: " + json.dumps(scene_line), flush=True)
    if not file_equal or ld.num_lines < scene_line["paths"] // 2:
        raise RuntimeError("the cloud file differs from the cloud, or the trace kept few paths")

    base = Camera(position=SC_CAMERA, look_at_point=(0.0, 0.0, 0.0), width=W, height=H)

    # "Volumetric Path Tracer": SC_VPT_FRAMES accumulating frames.
    vpt = create_renderer("Volumetric Path Tracer", device=dev)
    vpt.set_line_data(ld)

    def vpt_frame(cam):
        return vpt.render(cam)

    vpt.render(base)  # the cloud's upload and the first launch
    vpt.set_line_data(ld)  # the accumulation restarts; the grid stays cached
    img, ev_ms, host_ms, launches = frames(vpt_frame, [base] * SC_VPT_FRAMES,
                                           {"vpt_tracking": 2 * SC_VPT_FRAMES}, warm=False)
    vpt_launches = launches["vpt_tracking"]
    if not np.isfinite(img).all() or not (img[..., :3].std() > 1e-3):
        raise RuntimeError("the path-traced frame is non-finite or flat")
    vs = VptSettings()
    grid = ld.get_cloud_grid(device=dev)
    sun_dir, sun_ic = sun_constants(vs)
    cam_t = camera_tensors(base, dev)
    basis = _ray_basis(cam_t[0])
    key = threefry.prng_key(0, dev)
    rays = []
    for _ in range(vs.samples_per_frame):
        key, kt, origins, dirs = primary_rays(key, cam_t[1], basis, W, H)
        rays.append((origins, dirs, kt))
    # Each scan mode on both samples, every ray in one launch: the middle
    # row of each sample, sliced from those launches, against the plain
    # version on that row (ray i of the row takes the frame's key
    # split(kt, W * H)[r0 + i], as in the renderer), events and scatters
    # included.
    r0 = (H // 2) * W
    row_rays = [(o[r0:r0 + W].contiguous(), d[r0:r0 + W].contiguous(), kt) for o, d, kt in rays]
    r3 = {}
    for mode in vt.SCAN_MODES:
        p = vt.vpt_params(grid.shape, vs.extinction, vs.scattering_albedo, sun_dir, sun_ic,
                          vs.phase_g, mode, vs.max_events, vs.interpolation)
        k_rows = []
        for o, d, kt in rays:
            ev_s = torch.empty(W * H, dtype=torch.int32, device=dev)
            sc_s = torch.empty_like(ev_s)
            out = vt.vpt_tracking(grid, o, d, kt, p, events=ev_s, scatters=sc_s)
            k_rows.append([x[r0:r0 + W] for x in (*out, ev_s, sc_s)])
            del out, ev_s, sc_s
        k_out = [torch.cat(x) for x in zip(*k_rows)]
        ev_p = torch.empty(len(rays) * W, dtype=torch.int32, device=dev)
        sc_p = torch.empty_like(ev_p)

        def plain_rows(p=p, ev_p=ev_p, sc_p=sc_p):
            outs = [vt.vpt_tracking_reference(grid, o, d, kt, p, events=ev_p[s * W:(s + 1) * W],
                                              first=r0, scatters=sc_p[s * W:(s + 1) * W])
                    for s, (o, d, kt) in enumerate(row_rays)]
            return [torch.cat(x) for x in zip(*outs)] + [ev_p, sc_p]

        p_out, plain_ms = host_timed(plain_rows)
        equal = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
        r3[mode] = {"equal": equal, "plain_ms": plain_ms,
                    "ms_full_sample": _time_ms(lambda: vt.vpt_tracking(grid, *rays[0], p), 3),
                    "max_abs_err": float((k_out[0] - p_out[0]).abs().max()),
                    "events_on_the_row": int(ev_p.sum()), "scatters_on_the_row": int(sc_p.sum())}
        if not equal:
            raise RuntimeError(f"vpt_tracking ({mode}) differs from its plain version on the row "
                               "sliced from its full-sample launch")
    # The renderer's mode on the whole first sample, launched twice.
    p_delta = vt.vpt_params(grid.shape, vs.extinction, vs.scattering_albedo, sun_dir, sun_ic,
                            vs.phase_g, vs.mode, vs.max_events, vs.interpolation)
    ev_full = torch.empty(W * H, dtype=torch.int32, device=dev)
    sc_full = torch.empty_like(ev_full)
    once = vt.vpt_tracking(grid, *rays[0], p_delta, events=ev_full, scatters=sc_full)
    ev_again = torch.empty_like(ev_full)
    twice = vt.vpt_tracking(grid, *rays[0], p_delta, events=ev_again)
    launches_equal = (all(torch.equal(a, b) for a, b in zip(once, twice))
                      and torch.equal(ev_full, ev_again))
    del once, twice, ev_again
    if not launches_equal:
        raise RuntimeError("two launches of vpt_tracking on the full sample differ")
    r3_ms = r3[vs.mode]["ms_full_sample"]
    evf = ev_full.double()
    events_total = int(evf.sum())
    scatters_total = int(sc_full.sum())
    # Rays that left the volume (ran fewer than max_events; no absorption
    # under the renderer's albedo of 1) end on an event that does not collide.
    leaves = int(((ev_full > 0) & (ev_full < vs.max_events)).sum())
    n_count = {"ray": W * H, "collision": events_total - leaves, "leave": leaves,
               "scatter": scatters_total}
    r3_ops = [sum(n_count[k] * VPT_OPS[k][i] for k in VPT_OPS) for i in range(3)]
    r3_bytes = grid.numel() * 4 + 8 + W * H * (12 + 12) + W * H * (12 + 12 + 1)
    t_bytes = r3_bytes / H100_HBM_BYTES * 1e3
    t_ops = ops_ms(*r3_ops, int_rate)
    hit = evf > 0
    warps = evf.reshape(-1, 32)
    vpt_events = {"p50": float(evf[hit].quantile(0.5)), "p99": float(evf[hit].quantile(0.99)),
                  "max": int(evf.max()), "rays_in_the_box": float(hit.double().mean()),
                  "share_at_max_events": float((evf == vs.max_events).double().mean()),
                  "events": events_total, "scatters": scatters_total, "leaves": leaves,
                  # The lanes a warp of 32 neighbouring rays keeps busy when it
                  # runs until its longest ray dies (the one-thread-a-ray
                  # design before the persistent warps).
                  "warp_efficiency_lockstep_32": float(
                      warps.sum() / (32.0 * warps.max(dim=1).values.sum())),
                  "two_full_launches_equal": launches_equal}
    # The frame on the card against the CPU's at SC_CHECK_SCALE, same keys.
    sw, sh = int(W * SC_CHECK_SCALE), int(H * SC_CHECK_SCALE)
    small = dataclasses.replace(base, width=sw, height=sh)
    chk = {}
    for d in (dev, "cpu"):
        r = create_renderer("Volumetric Path Tracer", device=d)
        r.set_line_data(ld)
        chk[str(d)] = r.render(small)
    vpt_mean_diff = image_mean_difference(chk[str(dev)][..., :3], chk["cpu"][..., :3])
    vpt_ssim = ssim(chk[str(dev)][..., :3], chk["cpu"][..., :3])
    vpt_mad = float(np.abs(chk[str(dev)] - chk["cpu"]).mean())
    vpt_line = {
        "frame_ms": ev_ms, "host_ms": host_ms, "frame_ms_median": float(np.median(ev_ms)),
        "host_ms_median": float(np.median(host_ms)), "launches": vpt_launches,
        "kernel_vs_plain_row": r3, "events_per_ray": vpt_events,
        f"card_vs_cpu_{sw}x{sh}": {"image_mean_difference": vpt_mean_diff, "ssim": vpt_ssim,
                                   "mean_abs": vpt_mad},
        "frames": SC_VPT_FRAMES, "spp": vs.samples_per_frame, "max_events": vs.max_events,
        "width": W, "height": H, "gpu": gpu}
    print("volumetric path tracer: " + json.dumps(vpt_line), flush=True)
    if vpt_mean_diff > 2e-3 or vpt_ssim < 0.999 or vpt_mad > 2e-3:
        raise RuntimeError("the path-traced frame on the card differs from the CPU's")
    rows.append({
        "name": "vpt_tracking", "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/vpt_tracking.cu",
        "replaces": "linevis_tpu/render/vpt.py:189",
        "replaces_note": "no pallas_call: trace_one's vmapped lax.scan of Woodcock events "
                         "(vpt.py:189-278), Delta, Spectral Delta and Ratio tracking",
        "launches": vpt_launches, "max_abs_err": max(v["max_abs_err"] for v in r3.values()),
        "ms": r3_ms, "plain_ms": r3[vs.mode]["plain_ms"],
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": r3_bytes, "bytes_ms": t_bytes, "operations_ms": t_ops, "library_ms": None,
        "per_launch": "one sample of every pixel (2 a frame)",
        "plain_on": f"row {H // 2} of both samples ({len(rays) * W} rays), sliced from "
                    "full-sample launches",
        "counted": n_count, "ops_logic_add_float": VPT_OPS, "operations": r3_ops,
        "int32_ops_per_s": int_rate, "ptxas": ptxas_lines(built, "vpt_tracking")})
    rows.extend(vpt_extension(dev, gpu, ld, base, grid, rays, p_delta, frames, host_timed, int_rate,
                              built))
    del vpt, grid, rays, row_rays, ev_full, sc_full
    torch.cuda.empty_cache()

    # "Line Density Map Renderer": SC_FRAMES frames on an orbit.
    cams = [dataclasses.replace(base, position=(SC_LDM_CAMERA[0] + 0.002 * i, *SC_LDM_CAMERA[1:]))
            for i in range(SC_FRAMES)]
    field, field_ms = host_timed(lambda: ld.get_line_density_field(device=dev))
    ldm = create_renderer("Line Density Map Renderer", device=dev)
    ldm.set_line_data(ld)
    img, ev_ms, host_ms, launches = frames(ldm.render, cams, {"density_march": SC_FRAMES})
    if not np.isfinite(img).all() or not (img[..., 3] > 0.05).any():
        raise RuntimeError("the density map frame is non-finite or empty")
    ct = camera_tensors(cams[0], dev)
    c_pts, _ = ldm.transfer_function.as_static_points()
    o_pts = ((0.0, 0.0), (0.05, 1.0), (1.0, 1.0))  # the renderer's ramp for a flat opacity TF
    prm, _ = dm.march_params(field.shape, ld.grid_b_min, ld.grid_b_max, ct[1], _ray_basis(ct[0]),
                             W, H, ldm.attenuation, (1.0, 1.0, 1.0, 0.0))
    k_out = dm.density_march(field, prm, W, H, 256, c_pts, o_pts)
    stats, skip_stats = {}, {}
    p_out, plain_ms = host_timed(lambda: dm.density_march_reference(
        field, prm, W, H, 256, c_pts, o_pts, stats=stats))
    r4_equal = bool(torch.equal(k_out, p_out))
    # The skip rule in plain PyTorch: equal too, and its count of the steps
    # that sample an occupied cell (the work the function needs).
    skip_equal = bool(torch.equal(dm.density_march_skipping(
        field, prm, W, H, 256, c_pts, o_pts, stats=skip_stats), p_out))
    r4_ms = _time_ms(lambda: dm.density_march(field, prm, W, H, 256, c_pts, o_pts), 10)
    # One more launch on the kernel's IEEE divisions with skipping off: a box
    # of extent 0.375 (no power of two) and an opacity of 0.2 at density 0.
    lo = np.asarray(ld.grid_b_min, np.float32)
    hi_ieee = lo + np.float32(0.75) * (np.asarray(ld.grid_b_max, np.float32) - lo)
    o_ieee = ((0.0, 0.2), (1.0, 1.0))
    prm_i, _ = dm.march_params(field.shape, ld.grid_b_min, hi_ieee, ct[1], _ray_basis(ct[0]), W, H,
                               ldm.attenuation, (1.0, 1.0, 1.0, 0.0))
    ki_out = dm.density_march(field, prm_i, W, H, 256, c_pts, o_ieee)
    pi_out, plain_ieee_ms = host_timed(lambda: dm.density_march_reference(
        field, prm_i, W, H, 256, c_pts, o_ieee))
    ieee_equal = bool(torch.equal(ki_out, pi_out)) and not dm.skip_allowed(prm_i, c_pts, o_ieee)
    r4_ieee_ms = _time_ms(lambda: dm.density_march(field, prm_i, W, H, 256, c_pts, o_ieee), 10)
    # Bounds from this run's counts: every ray, and the steps that sample an
    # occupied cell (skipped steps add nothing: not the function's work);
    # bytes, the distinct voxels those samples read and the image.
    r4_count = {"ray": W * H, "sampled_step": skip_stats["sampled"]}
    r4_ops = [sum(r4_count[k] * R4_OPS[k][i] for k in R4_OPS) for i in range(3)]
    r4_ops_every = [W * H * R4_OPS["ray"][i] + stats["steps"] * R4_OPS["sampled_step"][i]
                    for i in range(3)]
    r4_bytes = skip_stats["voxels_read"] * 4 + W * H * 16
    t_bytes = r4_bytes / H100_HBM_BYTES * 1e3
    t_ops = ops_ms(*r4_ops, int_rate)
    ldm_line = {"frame_ms": ev_ms, "host_ms": host_ms, "frame_ms_median": float(np.median(ev_ms)),
                "host_ms_median": float(np.median(host_ms)), "field_ms": field_ms,
                "field_voxels": list(field.shape), "launches": launches["density_march"],
                "equal": r4_equal, "skip_twin_equal": skip_equal, "ieee_no_skip_equal": ieee_equal,
                "steps": stats["steps"], "steps_sampled": skip_stats["sampled"],
                "voxels_read": skip_stats["voxels_read"], "frames": SC_FRAMES, "width": W,
                "height": H, "gpu": gpu}
    print("line density map: " + json.dumps(ldm_line), flush=True)
    if not (r4_equal and skip_equal):
        raise RuntimeError("density_march (or its skip rule's twin) differs from its plain version "
                           "on the 1080p frame")
    if not ieee_equal:
        raise RuntimeError("density_march differs from its plain version on its IEEE divisions "
                           "with skipping off")
    rows.append({
        "name": "density_march", "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/density_march.cu",
        "replaces": "linevis_tpu/render/line_density_map.py:51",
        "replaces_note": "no pallas_call: render_line_density_map's lax.scan of 256 steps "
                         "(line_density_map.py:76-93)",
        "launches": launches["density_march"],
        "max_abs_err": max(float((k_out - p_out).abs().max()),
                           float((ki_out - pi_out).abs().max())),
        "ms": r4_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "bytes": r4_bytes,
        "bytes_ms": t_bytes, "operations_ms": t_ops, "library_ms": None,
        "steps_counted": stats["steps"], "steps_sampled_counted": skip_stats["sampled"],
        "counted": r4_count, "ops_logic_add_float": R4_OPS, "operations": r4_ops,
        "bound_ms_every_step": ops_ms(*r4_ops_every, int_rate), "int32_ops_per_s": int_rate,
        "ieee_no_skip_ms": r4_ieee_ms, "ieee_no_skip_plain_ms": plain_ieee_ms,
        "ptxas": ptxas_lines(built, "density_march")})
    del field, k_out, p_out, ki_out, pi_out

    # "Spherical Heat Map Renderer": a 1080 x 2160 map of the exit directions.
    heat_cam = dataclasses.replace(base, width=2 * H, height=H)
    shm_r = create_renderer("Spherical Heat Map Renderer", device=dev)
    shm_r.set_line_data(ld)
    img, ev_ms, host_ms, launches = frames(shm_r.render, [heat_cam] * SC_HEAT_FRAMES,
                                           {"spherical_heatmap": SC_HEAT_FRAMES})
    if not np.isfinite(img).all() or not (img[..., 0] > 0.5).any():
        raise RuntimeError("the heat map is non-finite or has no hot spot")
    dirs = torch.as_tensor(ld.exit_directions, device=dev)
    pts, _ = mollweide_points(H, dev)
    tw, th = shm.TILE
    tx, ty = shm.heatmap_tiles(pts.shape[0], 2 * H)
    counts = torch.empty((tx * ty, 2), dtype=torch.int64, device=dev)
    full = shm.heatmap_density(pts, dirs, 2 * H, counts)
    r5_twice = bool(torch.equal(full, shm.heatmap_density(pts, dirs, 2 * H)))
    full = full.reshape(H, 2 * H)
    tile_counts = counts.reshape(ty, tx, 2)
    # Two bands of whole tile rows, sliced from the full map's launch: the
    # tile row of the hottest pixel, and the top rows (the pole, and pixels
    # outside the ellipse).
    hot_row = int(full.amax(dim=1).argmax())
    bands = {"hot": min(hot_row // th, H // th - 1) * th, "top": 0}
    band_figs = {}
    r5_err, r5_ok, plain_ms = 0.0, r5_twice, None
    for name, top in bands.items():
        band = pts.reshape(H, 2 * H, 3)[top:top + th].reshape(-1, 3)
        k_band = full[top:top + th].reshape(-1)
        p_band, b_ms = host_timed(lambda: shm.heatmap_density_reference(band, dirs))
        in_plain = int(shm.heatmap_in_range(band, dirs).sum())
        in_kernel = int(tile_counts[top // th, :, 1].sum())
        equal = bool(torch.equal(k_band, p_band))
        band_figs[name] = {"rows": [top, top + th], "equal": equal, "plain_ms": b_ms,
                           "pairs_in_range_kernel": in_kernel, "pairs_in_range_plain": in_plain,
                           "candidates": int(tile_counts[top // th, :, 0].sum()),
                           "max": float(p_band.max())}
        r5_err = max(r5_err, float((k_band - p_band).abs().max()))
        r5_ok = r5_ok and equal and in_kernel == in_plain
        plain_ms = b_ms if name == "hot" else plain_ms
    # The walk's branch-free term against the IEEE one on every float d^2.
    term_mismatches = shm.heatmap_term_mismatches(dev)
    r5_ok = r5_ok and term_mismatches == 0
    r5_ms = _time_ms(lambda: shm.heatmap_density(pts, dirs, 2 * H), 10)
    n_pairs = pts.shape[0] * dirs.shape[0]
    in_range = int(counts[:, 1].sum())
    candidates = int(counts[:, 0].sum())
    # The exact test runs on each tile's candidates at each of its pixels.
    tile_px = (torch.clamp(H - th * torch.arange(ty, device=dev), max=th)[:, None]
               * torch.clamp(2 * H - tw * torch.arange(tx, device=dev), max=tw)[None, :])
    exact_tests = int((tile_counts[..., 0] * tile_px).sum())
    r5_bytes = pts.numel() * 4 + dirs.numel() * 4 + pts.shape[0] * 4
    t_bytes = r5_bytes / H100_HBM_BYTES * 1e3
    t_ops = in_range * HEAT_OPS_PER_PAIR_IN_RANGE / H100_FP32_FLOPS * 1e3
    heat_line = {"frame_ms": ev_ms, "host_ms": host_ms, "frame_ms_median": float(np.median(ev_ms)),
                 "host_ms_median": float(np.median(host_ms)), "map": [H, 2 * H],
                 "directions": int(dirs.shape[0]), "pairs": n_pairs,
                 "pairs_in_range": in_range, "candidates": candidates,
                 "exact_tests": exact_tests, "exact_test_share": exact_tests / n_pairs,
                 "tiles": tx * ty, "tile": [tw, th],
                 "bands": band_figs, "two_launches_equal": r5_twice,
                 "term_mismatches_every_float": term_mismatches,
                 "launches": launches["spherical_heatmap"],
                 "frames": SC_HEAT_FRAMES, "gpu": gpu}
    print("spherical heat map: " + json.dumps(heat_line), flush=True)
    if not r5_ok:
        raise RuntimeError("spherical_heatmap differs from its plain version on a band (sum or "
                           "pairs in range), between two launches, or in its term")
    if exact_tests > 0.05 * n_pairs:
        raise RuntimeError(f"spherical_heatmap tested {exact_tests} of {n_pairs} pairs exactly")
    rows.append({
        "name": "spherical_heatmap", "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/spherical_heatmap.cu",
        "replaces": "linevis_tpu/render/spherical_heatmap.py:57",
        "replaces_note": "no pallas_call: render_spherical_heatmap's [pixels, directions] "
                         "RBF sum (spherical_heatmap.py:57-66)",
        "launches": launches["spherical_heatmap"], "max_abs_err": r5_err, "ms": r5_ms,
        "plain_ms": plain_ms,
        "plain_on": f"the hottest band of {th} rows ({th * 2 * H} pixels)",
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": r5_bytes, "bytes_ms": t_bytes, "operations_ms": t_ops, "library_ms": None,
        "pairs_in_range_counted": in_range, "ops_per_pair_in_range": HEAT_OPS_PER_PAIR_IN_RANGE,
        "candidates": candidates, "exact_tests": exact_tests,
        "ptxas": ptxas_lines(built, "spherical_heatmap")})
    del dirs, pts, full, ld
    torch.cuda.empty_cache()

    # "Voxel Ray Casting" on the tornado: SC_FRAMES frames.
    t_cams = [Camera(position=(0.0, 0.1, 1.2), width=W, height=H).orbit(0.002 * (i + 1), 0.1, 1.2)
              for i in range(SC_FRAMES)]
    tld = LineData(traj)
    tld.set_line_width(TORNADO_LINE_WIDTH)
    vrc_settings = SettingsMap({"grid_resolution": SC_VRC["grid_resolution"]})
    vrc = create_renderer("Voxel Ray Casting", vrc_settings, device=dev)
    vrc.quantization = SC_VRC["quantization"]
    vrc.set_line_data(tld)
    q_scene, disc_ms = host_timed(vrc.quantized_scene)
    img, ev_ms, host_ms, launches = frames(vrc.render, t_cams, {"capsule_raster": SC_FRAMES})
    csr, _, _ = prepare_capsule_frame(q_scene, *camera_tensors(t_cams[0], dev),
                                      vrc._base._raster_settings(t_cams[0]))
    small = dataclasses.replace(t_cams[0], width=int(W * SC_CHECK_SCALE),
                                height=int(H * SC_CHECK_SCALE))
    chk = {}
    for d in (dev, "cpu"):
        r = create_renderer("Voxel Ray Casting", vrc_settings, device=d)
        r.quantization = SC_VRC["quantization"]
        r.set_line_data(tld)
        chk[str(d)] = r.render(small)
    vrc_ssim = ssim(chk[str(dev)][..., :3], chk["cpu"][..., :3])
    vrc_line = {"frame_ms": ev_ms, "host_ms": host_ms, "frame_ms_median": float(np.median(ev_ms)),
                "host_ms_median": float(np.median(host_ms)), "discretize_ms": disc_ms,
                "capsules": q_scene.num_segments, "valid": int(q_scene.mask.sum()),
                "b1_pairs": int(csr.tile_count.sum()), "launches": launches["capsule_raster"],
                f"card_vs_cpu_ssim_{small.width}x{small.height}": vrc_ssim, **SC_VRC,
                "frames": SC_FRAMES, "width": W, "height": H, "gpu": gpu}
    print("voxel ray casting: " + json.dumps(vrc_line), flush=True)
    if not np.isfinite(img).all() or vrc_ssim < 0.999 or not (img[..., :3] < 0.999).any():
        raise RuntimeError("the VRC frame is empty or disagrees card vs CPU")
    del q_scene, csr, vrc

    # Multivariate tubes: the tornado's attribute and 1 - it in alternate
    # sectors, SC_FRAMES frames through render_opaque (B3 once a frame).
    attr = traj.attributes[:, 0]
    mesh, mesh_ms = host_timed(lambda: build_multivar_tube_mesh(
        traj.positions, traj.mask, [attr, 1.0 - attr], radius=TORNADO_RADIUS,
        num_subdivisions=8, device=dev))
    table = torch.as_tensor(combine_transfer_function_table(
        MultiVarTransferFunctions.default(2)).table, device=dev)
    mv_settings = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    mv_cams = [camera_tensors(c, dev) for c in t_cams]

    def mv_frame(cam):
        return render_opaque(mesh, cam[0], cam[1], table, mv_settings)

    img, ev_ms, host_ms, launches = frames(mv_frame, mv_cams, {"triangle_raster": SC_FRAMES})
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("non-finite multivariate frame")
    batch = tube_vertex_stage(mesh, mv_cams[0][0], W, H)
    csr = raster_pallas.build_csr_binning(
        batch.tri_x, batch.tri_y, build_payload(batch), batch.tri_valid, W, H,
        mv_settings.tile_w, mv_settings.tile_h, mv_settings.chunk, mv_settings.span_x,
        mv_settings.span_y, mv_settings.pairs_capacity)
    _, _, fig = b3_check(csr, mv_settings.tile_w, mv_settings.tile_h)
    mv_line = {"frame_ms": ev_ms, "host_ms": host_ms, "frame_ms_median": float(np.median(ev_ms)),
               "host_ms_median": float(np.median(host_ms)), "mesh_ms": mesh_ms,
               "triangles": mesh.num_triangles, "launches": launches["triangle_raster"],
               "b3_equal": fig["equal"], "b3_ms": fig["ms"], "b3_plain_ms": fig["plain_ms"],
               "b3_pairs": fig["pairs"], "frames": SC_FRAMES, "width": W, "height": H, "gpu": gpu}
    print("multivariate tubes: " + json.dumps(mv_line), flush=True)
    if not fig["equal"]:
        raise RuntimeError("B3 differs from its plain version on the multivariate CSR")
    return rows


# The application layer's phase (`app_phase`).
APP_FLIGHT_SECONDS = 0.8  # the perf matrix's flight: 8 frames at 10 per second
APP_FPS = 10.0
APP_REPLAY = (  # tests/golden_scenes.py:scene_replay_screenshot's script on the tornado
    'g.set_duration(0)\n'
    'g.set_dataset("tornado")\n'
    'g.set_renderer("Multi-Layer Alpha Blending")\n'
    'g.set_rendering_algorithm_settings({"opacity": 0.5})\n'
    'g.set_camera_position(0.0, 0.2, 1.4)\n'
    'g.set_camera_look_at(0.0, 0.0, 0.0)\n'
    'g.set_duration(1)\n'
    'g.set_camera_position(0.35, 0.25, 1.3)\n'
)
# Launches a frame of each rendering mode of `automation/perf.py:get_test_modes`.
APP_MODE_LAUNCHES = {
    "Opaque": {"capsule_raster": 1},
    "Multi-Layer Alpha Blending": {"capsule_mlab": 1},
    "Per-Pixel Linked Lists": {"capsule_mlab": 1},
    "MLAB (Buckets)": {"capsule_mlab": 2},
    "Moment-Based OIT": {"capsule_accum": 2},
    "WBOIT": {"capsule_accum": 1},
    "Depth Peeling": {"capsule_mlab": 4},
    "Depth Complexity": {"capsule_accum": 1},
    "Opacity Optimization": {"capsule_mlab": 2},
    "Vulkan Ray Tracer": {"bvh_recast": 1},
    "Voxel Ray Casting": {"capsule_raster": 1},
}


def app_phase(dev, gpu, traj, reset_launches, expect_launches):
    """26. The application layer at full size on the tornado `traj`,
    written as .binlines and named in a datasets.json: `python -m
    linevis_tpu_torch render` in process (Opaque and Multi-Layer Alpha
    Blending at 1920x1080, each PNG byte for byte `save_png` of the
    registry's frame) and as a subprocess on its default device (which
    prints the card it drew on); `replay` of the golden replay script (its last frame bit for bit
    the registry's frame at the script's last camera); `perf`, the 15 states
    of `get_test_modes` over a flight of 8 frames each (every cell filled,
    the card's name, each state's launches); `view`, `make_server` on port 0
    answering one 1080p /frame with `frame_png`'s bytes; two DataViews at
    960x1080, each its own renderer's frame; both requesters on the card,
    each reply equal to the direct call, and a frame drawn from a worker
    thread on a side stream equal to the main thread's; a 3D-TSV reply's
    .dat loaded by `load_reply_line_data` and drawn (the ZeroMQ round trip
    itself is tested on the CPU: this machine has no pyzmq); `FrameProfiler`
    over the capsule frame's passes."""
    import csv
    import shutil
    import tempfile
    import threading
    import urllib.request

    from linevis_tpu_torch import app as app_module
    from linevis_tpu_torch.__main__ import main as cli
    from linevis_tpu_torch.automation.perf import AutomaticPerformanceMeasurer, get_test_modes
    from linevis_tpu_torch.automation.profiling import FrameProfiler
    from linevis_tpu_torch.automation.replay import ReplayWidget
    from linevis_tpu_torch.automation.tsv_requester import StressLineTracingRequester
    from linevis_tpu_torch.core.settings import SettingsMap
    from linevis_tpu_torch.core.trajectories import RaggedTrajectories
    from linevis_tpu_torch.entry import TORNADO_RADIUS, synth_v3_blocks
    from linevis_tpu_torch.kernels.raster_capsule import rasterize_capsules
    from linevis_tpu_torch.loaders.binlines import BinLinesData, save_trajectories_as_binlines
    from linevis_tpu_torch.loaders.dataset_list import load_dataset_list
    from linevis_tpu_torch.loaders.stress_dat import write_stress_trajectories_dat_v3
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.data_view import DataView, MultiViewCompositor
    from linevis_tpu_torch.render.framebuffer import save_png
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.renderer import create_renderer
    from linevis_tpu_torch.render.tube_raster import (
        camera_tensors,
        prepare_capsule_frame,
        resolve_capsule_frame,
    )
    from linevis_tpu_torch.scene.factory import load_line_data
    from linevis_tpu_torch.scene.line_data_stress import LineDataStress
    from linevis_tpu_torch.scene.requester import LineDataRequester, StreamlineTracingRequester
    from linevis_tpu_torch.trace.fields import tornado_velocity
    from linevis_tpu_torch.trace.streamline import StreamlineTracingSettings, trace_streamlines

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize
    card = torch.cuda.get_device_name(dev)
    tmp = tempfile.mkdtemp(prefix="linevis_app_")
    line = {}

    def path(name):
        return os.path.join(tmp, name)

    try:
        n_pts = traj.mask.sum(axis=1)
        save_trajectories_as_binlines(path("tornado.binlines"), BinLinesData(RaggedTrajectories(
            [traj.positions[i, :n] for i, n in enumerate(n_pts)],
            [traj.attributes[i, :, :n] for i, n in enumerate(n_pts)],
            list(traj.attribute_names))))
        with open(path("datasets.json"), "w") as f:
            json.dump({"datasets": [{"type": "flow", "name": "tornado",
                                     "filenames": "tornado.binlines",
                                     "linewidth": 2.0 * TORNADO_RADIUS}]}, f)
        leaf = {x.name: x for x in load_dataset_list(path("datasets.json")).flat_leaves()}
        ld = load_line_data(leaf["tornado"], base_dir=tmp)
        cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)

        # render: the CLI in process, each PNG against the registry's frame.
        render_check = {}
        for mode, launches in (("Opaque", {"capsule_raster": 1}),
                               ("Multi-Layer Alpha Blending", {"capsule_mlab": 1})):
            out = path(f"cli_{len(render_check)}.png")
            sync()
            reset_launches()
            t0 = time.perf_counter()
            rc = cli(["render", "tornado", "--datasets-json", path("datasets.json"),
                      "--renderer", mode, "--camera-position", "0", "0.1", "1.2",
                      "--width", str(W), "--height", str(H), "-o", out, "--device", str(dev)])
            cli_s = time.perf_counter() - t0
            expect_launches(launches)
            r = create_renderer(mode, SettingsMap(), device=dev)
            r.set_line_data(ld)
            save_png(path("direct.png"), r.render(cam))
            with open(out, "rb") as a, open(path("direct.png"), "rb") as b:
                same = a.read() == b.read()
            render_check[mode] = {"seconds_with_load": cli_s, "png_equals_registry": same}
            if rc != 0 or not same:
                raise RuntimeError(f"render {mode}: the CLI's PNG differs from the registry's")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [REPO_DIR] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "linevis_tpu_torch", "render", "tornado", "--datasets-json",
             path("datasets.json"), "--camera-position", "0", "0.1", "1.2", "--width", str(W),
             "--height", str(H), "-o", path("sub.png")],
            cwd=REPO_DIR, env=env, capture_output=True, text=True, timeout=300)
        sub_s = time.perf_counter() - t0
        said = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else proc.stderr[-2000:]
        with open(path("sub.png"), "rb") as a, open(path("cli_0.png"), "rb") as b:
            sub_same = proc.returncode == 0 and a.read() == b.read()
        render_check["subprocess"] = {"seconds": sub_s, "said": said,
                                      "png_equals_in_process": sub_same}
        if not sub_same or not said.endswith(f"{card}]"):
            raise RuntimeError(f"python -m linevis_tpu_torch render: {said}")
        line["render"] = render_check

        # replay: the golden script at 1920x1080.
        stamps = []
        widget = ReplayWidget(lambda name: ld, fps=2.0, output_dir=tmp, device=dev)
        widget.frame_callback = lambda i, img: stamps.append((time.perf_counter(), img))
        widget.load_script(APP_REPLAY)
        sync()
        reset_launches()
        t0 = time.perf_counter()
        n_replay = widget.run(width=W, height=H)
        replay_ms = [(b - a) * 1e3 for a, b in zip([t0] + [s for s, _ in stamps[:-1]],
                                                    [s for s, _ in stamps])]
        expect_launches({"capsule_mlab": n_replay})
        r = create_renderer("Multi-Layer Alpha Blending", SettingsMap({"opacity": 0.5}),
                            device=dev)
        r.set_line_data(ld)
        last = r.render(Camera(position=tuple(np.float32([0.35, 0.25, 1.3])),
                               look_at_point=tuple(np.float32([0.0, 0.0, 0.0])),
                               width=W, height=H))
        replay_same = bool(np.array_equal(stamps[-1][1], last))
        line["replay"] = {"frames": n_replay, "ms_per_frame": replay_ms,
                          "last_frame_equals_registry": replay_same}
        if n_replay != 2 or not replay_same:
            raise RuntimeError("replay: the last frame differs from the registry's")

        # perf: get_test_modes, one measurer a state so that each state's
        # launches are counted alone (its flight and its depth-complexity
        # frame).
        perf_rows = []
        n_flight = max(int(APP_FLIGHT_SECONDS * APP_FPS), 2)
        for state in get_test_modes("tornado", (W, H)):
            m = AutomaticPerformanceMeasurer(
                [state], lambda name: ld, csv_path=path("perf.csv"),
                flight_seconds=APP_FLIGHT_SECONDS, fps_target=APP_FPS, device=dev)
            sync()
            reset_launches()
            row = m.run()[0]
            want = {k: n * n_flight for k, n in APP_MODE_LAUNCHES[state.rendering_mode].items()}
            want["capsule_accum"] = want.get("capsule_accum", 0) + 1  # the depth complexity
            expect_launches(want)
            with open(path("perf.csv")) as f:
                cells = next(iter(csv.DictReader(f)))
            if (any(v == "" for v in cells.values())
                    or list(cells) != AutomaticPerformanceMeasurer.CSV_COLUMNS
                    or row["Device Name"] != card or row["Frames"] != n_flight - 1):
                raise RuntimeError(f"perf {state.name}: a cell is blank or wrong: {cells}")
            perf_rows.append(row)
            print(f"perf {state.name}: {row['Average Time (ms)']} ms "
                  f"({row['Average FPS']} FPS, {row['Frames']} frames)", flush=True)
        line["perf"] = {"states": len(perf_rows), "frames_each": n_flight - 1,
                        "average_ms": {r["State Name"]: r["Average Time (ms)"]
                                       for r in perf_rows},
                        "depth_complexity": {k: perf_rows[0][k] for k in (
                            "Avg Depth Complexity", "Max Depth Complexity", "Total Fragments")}}
        if len(perf_rows) != 15:
            raise RuntimeError("perf: get_test_modes did not give 15 states")

        # view: the HTTP viewer on port 0, one 1080p frame.
        app = app_module.LineVisApp(ld, width=W, height=H, device=dev)
        want_png = app.frame_png(0.6, 0.25, 2.2)  # builds the renderer and the scene
        srv = app_module.make_server(app, 0)
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        try:
            sync()
            reset_launches()
            t0 = time.perf_counter()
            png = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.server_address[1]}/frame?yaw=0.6&pitch=0.25&dist=2.2",
                timeout=120).read()
            request_ms = (time.perf_counter() - t0) * 1e3
            expect_launches({"capsule_raster": 1})
        finally:
            srv.shutdown()
            srv.server_close()
            server.join(timeout=10)
        line["view"] = {"request_ms": request_ms, "png_bytes": len(png),
                        "png_equals_frame_png": png == want_png}
        if png != want_png or server.is_alive():
            raise RuntimeError("view: the served frame differs from frame_png's")

        # Two DataViews side by side, each its own renderer's frame.
        half = Camera(position=(0.0, 0.1, 1.2), width=W // 2, height=H)
        views = [DataView("Opaque", camera=half, device=dev),
                 DataView("Multi-Layer Alpha Blending", camera=half, device=dev)]
        comp = MultiViewCompositor(views, gap=0)
        comp.set_line_data(ld)
        tiled = comp.render()
        views_equal = []
        for i, v in enumerate(views):
            r = create_renderer(v.rendering_mode, device=dev)
            r.set_line_data(ld)
            views_equal.append(bool(np.array_equal(tiled[:, i * (W // 2):(i + 1) * (W // 2)],
                                                   r.render(half))))
        line["data_views"] = {"shape": list(tiled.shape), "each_equals_its_renderer": views_equal}
        if tiled.shape != (H, W, 4) or not all(views_equal):
            raise RuntimeError("DataView: a tile differs from its renderer's frame")

        # The requesters on the card, and a frame from a worker thread on a
        # side stream.
        req = LineDataRequester()
        req.queue_request([path("tornado.binlines")])
        req.join(timeout=120)
        loaded = req.get_loaded_data()
        load_equal = loaded is not None and bool(np.array_equal(
            loaded.trajectories.positions, load_line_data(path("tornado.binlines"))
            .trajectories.positions))
        st = StreamlineTracingSettings(num_seeds=512, max_steps=400, dt=1.0 / 150.0)
        treq = StreamlineTracingRequester(device=dev)
        treq.queue_request(tornado_velocity, st)
        treq.join(timeout=300)
        traced = treq.get_traced_lines()
        direct = trace_streamlines(tornado_velocity, st, device=dev)
        trace_equal = traced is not None and bool(
            np.array_equal(traced.positions, direct.positions)
            and np.array_equal(traced.mask, direct.mask))
        r_side = create_renderer("Opaque", device=dev)
        r_side.set_line_data(ld)
        main_img = r_side.render(cam)
        side = []

        def side_frame():
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                side.append(r_side.render(cam))

        worker = threading.Thread(target=side_frame)
        worker.start()
        worker.join(timeout=120)
        side_equal = bool(side) and bool(np.array_equal(side[0], main_img))
        line["requesters"] = {"line_data_equals_loader": load_equal,
                              "trace_equals_direct": trace_equal,
                              "side_stream_frame_equals_main": side_equal}
        if not (load_equal and trace_equal and side_equal):
            raise RuntimeError(f"requesters: {line['requesters']}")

        # A 3D-TSV reply's .dat, loaded as the requester loads it and drawn.
        write_stress_trajectories_dat_v3(path("tsv_result.dat"),
                                         synth_v3_blocks(np.random.default_rng(11)), None)
        reply_ld = StressLineTracingRequester.load_reply_line_data(
            {"fileName": ["tsv_result.dat"], "version": 3}, base_dir=tmp)
        direct_ld = LineDataStress.load_from_dat([path("tsv_result.dat")], version=3)
        imgs = []
        for data in (reply_ld, direct_ld):
            r = create_renderer("Opaque", device=dev)
            r.set_line_data(data)
            imgs.append(r.render(Camera(position=(0.0, 0.1, 1.6), width=W // 2, height=H // 2)))
        tsv_fg = float((imgs[0][..., :3] < 0.999).any(-1).mean())
        line["tsv_reply"] = {"families": len(reply_ld.trajectories_ps),
                             "frame_equals_direct_load": bool(np.array_equal(*imgs)),
                             "foreground": tsv_fg,
                             "socket_round_trip": "CPU only (no pyzmq on this machine)"}
        if not line["tsv_reply"]["frame_equals_direct_load"] or tsv_fg < 0.005:
            raise RuntimeError("the 3D-TSV reply's lines do not draw as loaded directly")

        # FrameProfiler over the capsule frame's three passes.
        scene = ld.get_capsule_scene(device=dev)
        s_c = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
        prof = FrameProfiler()
        for i in range(4):
            ct = camera_tensors(cam.orbit(0.002 * (i + 1), 0.1, 1.2), dev)
            with prof.pass_("prep_binning", force=ct[0]):
                csr, params, basis = prepare_capsule_frame(scene, *ct, s_c, aa_margin=0.5)
            with prof.pass_("kernel", force=ct[0]):
                raster = rasterize_capsules(csr, params, W, H, 32, 16)
            with prof.pass_("shade", force=ct[0]):
                resolve_capsule_frame(scene, csr, raster, *ct, basis, s_c)
            prof.next_frame()
        prof.write_csv(path("passes.csv"))
        line["frame_profiler"] = {"host_ms": prof.summary(),
                                  "device_ms": prof.summary("Device Time (ms)")}
        if set(line["frame_profiler"]["device_ms"]) != {"prep_binning", "kernel", "shade"}:
            raise RuntimeError("FrameProfiler recorded no device time on the card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line.update(seconds=time.perf_counter() - t_phase, width=W, height=H, gpu=gpu)
    print("app layer: " + json.dumps(line), flush=True)


PAR_BANDS = 3  # the band layout on one card: 1080 rows are 3 bands of 45 8-row tiles
PAR_REF_AO_SAMPLES = 16  # the RTAO reference's rays a pixel (its own key)
PAR_REF_VPT_SPP = 8  # the VPT reference's samples a pixel (its own key)
PAR_R3_RAYS = 256  # R3 against its plain version on this many rays of a rank's middle row
# The stitched band frames against the world of one at n = PAR_BANDS. The
# JAX package's sharded bars (tests/test_multichip.py) were set on small
# fat-tube frames and do not hold on the 1080p tornado (ROADMAP C31). So each
# bar is a constant: 1.25 times the bands' own reading on an H100 (PERF.md,
# multi-GPU), rounded up; every planted fault of `parallel_phase` reads beyond it.
PAR_OPAQUE_BARS = {"share_over_001": 0.40, "mean_abs": 0.030}  # read 0.3145, 0.0238
PAR_MLAB_BARS = {"share_over_002": 0.023, "mean_abs": 2.4e-3}  # read 0.01832, 1.869e-3
PAR_SOLVE_BARS = {"share_over_1e3": 0.096, "median_abs": 1e-6}  # read 0.07667, 0.0


def parallel_phase(dev, gpu, traj, reset_launches, expect_launches):
    """27. Multi-GPU through torch.distributed (`parallel/mesh.py`) on the
    one card, at 1920x1080 on the tornado and the 512^3 cloud.
    `entry.dryrun_multichip(1)` first (its rank a thread with a bare NCCL
    group). (a) A world of one: an NCCL process group on an in-memory
    store, `make_device_mesh(1)`, and the five sharded functions once each
    (opaque triangle tubes of 8 subdivisions at tile 16x8, whose 8-row tiles
    1080 rows hold, depth cue 0.2; MLAB K=8, opacity 0.3; RTAO at the smoke's settings;
    the opacity solve's 960x528 gather; VPT at the registry's settings, 2
    spp), each frame timed with CUDA events and its launches counted
    (those of its unsharded frame), held against the unsharded function on
    the same draws bit for bit.
    (b) The band layout at n = PAR_BANDS on the card, each band's or rank's
    body run in turn without a group and combined as the collectives would
    (rows concatenated, torch.minimum / maximum, the float32 mean), every
    kernel launched in a band against its plain version on that band's
    inputs (B3, B1, B5, R6, 'gather' bit for bit; B2 composite at its
    gate's bar; R3 on PAR_R3_RAYS rays). Each stitched frame is held
    against (a)'s at the constant bars PAR_*_BARS (opaque: colour on the
    pixels both frames cover, and coverage against the 8-gon prism frame no
    worse than the world of one's); planted faults (a band shaded as a
    frame of its own, a band-local depth cue, MLAB bands one row off, one
    band of the gather dropped) must fail those bars, and the one-ulp
    floors (every position one ulp up, then down) are printed beside them.
    The ray-sharded paths: rank 0 equal to (a), and the mean of the ranks
    nearer a reference of more samples than rank 0 alone. Returns
    {path: world-of-one frame ms}."""
    import torch.distributed as dist

    from linevis_tpu_torch import entry
    from linevis_tpu_torch.kernels import ao_grid
    from linevis_tpu_torch.kernels import raster_pallas
    from linevis_tpu_torch.kernels import vpt_tracking as vt
    from linevis_tpu_torch.kernels.raster_capsule import (
        rasterize_capsules,
        rasterize_capsules_reference,
    )
    from linevis_tpu_torch.kernels.raster_capsule_oit import (
        rasterize_capsules_mlab,
        rasterize_capsules_mlab_reference,
    )
    from linevis_tpu_torch.kernels.threefry_uniform import threefry_uniform
    from linevis_tpu_torch.kernels.volume_common import vdiv
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.parallel import mesh as pm
    from linevis_tpu_torch.render import opacity_optimization as oo_mod
    from linevis_tpu_torch.render import rtao as rtao_mod
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.oit import prepare_mlab_frame, render_tubes_mlab
    from linevis_tpu_torch.render.opaque import (
        _ray_basis_from_view_proj,
        render_opaque,
        untile_gbuffer,
    )
    from linevis_tpu_torch.render.pipeline import GBUFFER_PLANES, RasterSettings
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import (
        _ray_basis,
        camera_tensors,
        prepare_capsule_frame,
        render_tubes_prism,
    )
    from linevis_tpu_torch.render.vpt import VptSettings, primary_rays, render_vpt, sun_constants

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    entry.dryrun_multichip(1, device=dev.type)
    dryrun_s = time.perf_counter() - t0

    n = PAR_BANDS
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H).orbit(
        0.002, 0.1, 1.2), dev)
    scene = entry.tornado_scene(dev, traj=traj)
    tmesh = entry.tornado_tube_mesh(dev, num_subdivisions=PRISM_SIDES, traj=traj)
    table = torch.as_tensor(TransferFunction.standard().table, device=dev)
    # The depth cue on, so that the bands' MIN / MAX range reaches the image.
    s_tri = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, depth_cue_strength=0.2)
    s_oit = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    s_rt = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    rt = rtao_mod.RtaoSettings()
    grid_ao = entry.tornado_segment_grid(scene, rt.grid_resolution)
    batches = rtao_mod.ray_batches(rt.num_samples * W * H, rt.rays_per_batch)
    oo = oo_mod.OpacityOptimizationSettings()
    L, P = traj.num_lines, traj.max_points
    prev = torch.ones((L, P), dtype=torch.float32, device=dev)
    cloud = entry.procedural_cloud(dev)
    vs = VptSettings()
    vcam = camera_tensors(Camera(position=SC_CAMERA, look_at_point=(0.0, 0.0, 0.0), width=W,
                                 height=H), dev)
    vbasis = _ray_basis(vcam[0])
    key = threefry.prng_key(0, dev)
    sync()
    setup_s = time.perf_counter() - t0 - dryrun_s

    def fold(r):
        return threefry.fold_in(threefry.prng_key(rt.seed, dev), r)

    failures = []  # every gate is read, the lines printed, then the phase fails

    def gate(ok, what):
        if not ok:
            failures.append(what)

    def within(stats, bars):
        return all(stats[k] < v for k, v in bars.items())

    def nudged(x, toward):  # every element one ulp toward +-inf
        return torch.nextafter(x, torch.full_like(x, toward))

    paths = {
        "opaque": (lambda m: pm.render_opaque_sharded(tmesh, cam[0], cam[1], table, s_tri, m),
                   lambda: render_opaque(tmesh, cam[0], cam[1], table, s_tri),
                   {"triangle_raster": 1}),
        "mlab": (lambda m: pm.render_tubes_mlab_sharded(scene, *cam, s_oit, m, K=MLAB_K,
                                                        opacity=MLAB_OPACITY),
                 lambda: render_tubes_mlab(scene, *cam, s_oit, K=MLAB_K, opacity=MLAB_OPACITY),
                 {"capsule_mlab": 1}),
        "rtao": (lambda m: pm.render_tubes_rtao_sharded(scene, *cam, s_rt, m, rtao=rt,
                                                        grid=grid_ao),
                 lambda: rtao_mod.render_tubes_rtao(
                     scene, *cam, s_rt, rt, grid=grid_ao, uniforms=rtao_mod.hemisphere_uniforms(
                         fold(0), (rt.num_samples, H, W))),
                 {"capsule_raster": 1, "ao_grid": len(batches), "threefry_uniform": 2}),
        "opacity_solve": (lambda m: pm.opacity_solve_sharded(scene, *cam, prev, s_oit, oo, L, P,
                                                             m),
                          lambda: oo_mod.opacity_solve(scene, *cam, prev, s_oit, oo, L, P),
                          {"capsule_mlab": 1}),
        "vpt": (lambda m: pm.render_vpt_sharded(key, cloud, vcam[1], vbasis, W, H, m, vs,
                                                spp=vs.samples_per_frame),
                lambda: render_vpt(threefry.fold_in(key, 0), cloud, vcam[1], vbasis, W, H, vs,
                                   spp=vs.samples_per_frame),
                {"vpt_tracking": vs.samples_per_frame}),
    }

    # (a) A world of one over NCCL.
    dist.init_process_group(pm.BACKENDS[dev.type], store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    world = {}
    one = {}
    try:
        mesh = pm.make_device_mesh(1, device_type=dev.type)
        if pm.group_rank_size(mesh, dev)[0].name() != pm.BACKENDS[dev.type]:
            raise RuntimeError("the world of one does not run NCCL")
        for name, (sharded, single, launches) in paths.items():
            sharded(mesh)  # warm-up
            sync()
            reset_launches()
            a, b = _events()
            a.record()
            out = sharded(mesh)
            b.record()
            sync()
            got = expect_launches(launches)
            one[name] = out
            ref = single()
            line = {"frame_ms": a.elapsed_time(b), "launches": {k: got[k] for k in launches},
                    "equal_to_unsharded": bool(torch.equal(out, ref))}
            gate(line["equal_to_unsharded"], f"{name}: the world of one differs from the "
                 "unsharded frame")
            gate(bool(torch.isfinite(out).all()), f"{name}: non-finite world-of-one frame")
            world[name] = line
    finally:
        dist.destroy_process_group()
    print("parallel world of one: " + json.dumps({**world, "width": W, "height": H,
                                                  "gpu": gpu}), flush=True)

    # (b) The band layout at n bands (ranks) on the card.
    bands = {}
    gates = {}

    def timed_bands(label, body, launches):
        """body(r) for r < n, each launch-counted and timed -> [outputs]."""
        outs, ms = [], []
        for r in range(n):
            sync()
            reset_launches()
            a, b = _events()
            a.record()
            outs.append(body(r))
            b.record()
            sync()
            expect_launches(launches)
            ms.append(a.elapsed_time(b))
        bands[label] = {"band_ms": ms}
        return outs

    # Opaque triangle tubes: B3 on each band's CSR.
    bs_tri = dataclasses.replace(s_tri, height=H // n)
    parts = timed_bands("opaque", lambda r: pm._render_band(
        tmesh, cam[0], cam[1], table, bs_tri, r, n), {"triangle_raster": 1})
    stitched = torch.cat(parts, dim=1)
    ray_basis = _ray_basis_from_view_proj(cam[0])

    def opaque_gbuf(mesh_, s_, r, m):
        """Band r of m's G-buffer from B3 -> (gbuf, csr, B3's output, dmin, dmax)."""
        batch, csr = pm._band_binning(mesh_, cam[0], s_, r, m)
        k = raster_pallas.rasterize_gbuffer(csr, GBUFFER_PLANES, 16, 8)
        return untile_gbuffer(csr, k, s_)[0], csr, k, batch.view_z_min, batch.view_z_max

    def shade(gbuf, s_, r, m, dmin, dmax):
        return pm._shade_band(gbuf, table, cam[1], ray_basis, dmin, dmax, s_, r, m)

    eq, ids = [], []
    faults = {"band_as_own_frame": [], "band_local_depth_cue": []}
    for r in range(n):
        gbuf, csr, k, dmin, dmax = opaque_gbuf(tmesh, bs_tri, r, n)
        p = raster_pallas.rasterize_triangles_reference(csr, 16, 8, GBUFFER_PLANES)
        eq.append(all(torch.equal(x, y) for x, y in zip([k[0], k[1], *k[2]],
                                                         [p[0], p[1], *p[2]])))
        ids.append(gbuf["id"])
        view_z = 1.0 / torch.clamp(gbuf["inv_w"], min=1e-12)[gbuf["id"] >= 0]
        faults["band_as_own_frame"].append(shade(gbuf, bs_tri, 0, 1, dmin, dmax))
        faults["band_local_depth_cue"].append(shade(gbuf, bs_tri, r, n, view_z.min(),
                                                    view_z.max()))
        del gbuf, csr, k, p
    gates["triangle_raster"] = eq
    ids = torch.cat(ids, dim=0)
    gbuf_one = opaque_gbuf(tmesh, s_tri, 0, 1)[0]
    ids_one = gbuf_one["id"]
    del gbuf_one

    def cover_stats(img, ids_, ref=one["opaque"], ref_ids=ids_one):
        """Colour on the pixels both frames cover (max abs over RGB a pixel),
        split by whether the same triangle won there."""
        both = (ids_ >= 0) & (ref_ids >= 0)
        d = (img[:3] - ref[:3]).abs()[:, both]
        over = d.amax(dim=0) > 1e-2
        same = (ids_ == ref_ids)[both]
        return {"covered_both": int(both.sum()), "same_triangle": float(same.float().mean()),
                "share_over_001": float(over.float().mean()), "mean_abs": float(d.mean()),
                "share_over_001_same_triangle": float(over[same].float().mean()),
                "share_over_001_other_triangle": float(over[~same].float().mean())}

    floors = {}
    for label, toward in (("up", float("inf")), ("down", float("-inf"))):
        m_ = dataclasses.replace(tmesh, positions=nudged(tmesh.positions, toward))
        g_, _, _, dmin, dmax = opaque_gbuf(m_, s_tri, 0, 1)
        floors[label] = cover_stats(shade(g_, s_tri, 0, 1, dmin, dmax), g_["id"])
        del m_, g_
    # Coverage: the bands' planes have band-local constants, the whole
    # frame's lose more of the tubes to float32 (ROADMAP C10), so coverage is
    # held against the 8-gon prism frame of the same lines (tile 32x16): the
    # bands may disagree with it on no more pixels than the world of one.
    pscene = entry.tornado_prism_scene(dev, n_sides=PRISM_SIDES, traj=traj)
    ref_cov = (render_tubes_prism(pscene, *cam, s_rt)[:3] < 0.999).any(dim=0)
    del pscene
    f = bands["opaque"]
    f.update(cover_stats(stitched, ids), one_ulp_floor=floors, prism_covered=int(ref_cov.sum()),
             planted_faults={k: cover_stats(torch.cat(v, dim=1), ids) for k, v in faults.items()},
             **{f"{k}_{what}_prism": int((got & ~want).sum()) for k, cov in (
                 ("bands", ids >= 0), ("world_of_one", ids_one >= 0))
                for what, got, want in (("missing", ref_cov, cov), ("beyond", cov, ref_cov))})
    gate(bool(torch.isfinite(stitched).all()) and within(f, PAR_OPAQUE_BARS)
         and f["bands_missing_prism"] + f["bands_beyond_prism"]
         <= f["world_of_one_missing_prism"] + f["world_of_one_beyond_prism"],
         f"opaque bands: {f}")
    for k, v in f["planted_faults"].items():
        gate(not within(v, PAR_OPAQUE_BARS), f"opaque bands: the planted fault {k} passes")
    del faults, ids, ids_one, ref_cov

    # MLAB: `render_tubes_mlab` (B2 composite) on each band's rows.
    bs_oit = dataclasses.replace(s_oit, height=H // n)

    def mlab_band(r, shift=0):
        return render_tubes_mlab(scene, *cam, bs_oit, K=MLAB_K, opacity=MLAB_OPACITY,
                                 y_offset=r * bs_oit.height + shift, full_height=H)

    parts = timed_bands("mlab", mlab_band, {"capsule_mlab": 1})
    stitched = torch.cat(parts, dim=1)
    comp_ok = []
    for r in range(n):
        csr, params = prepare_mlab_frame(scene, *cam, bs_oit, MLAB_OPACITY,
                                         y_offset=r * bs_oit.height, full_height=H)
        args = (csr, params, W, bs_oit.height, 16, 8, MLAB_K, s_oit.tf_color, s_oit.tf_opacity)
        err = (rasterize_capsules_mlab(*args, deferred_shade=True, composite=True)
               - rasterize_capsules_mlab_reference(*args, deferred_shade=True,
                                                   composite=True)).abs().amax(dim=0)
        comp_ok.append([float((err <= 1e-4).float().mean()), float(err.max())])
        gate(comp_ok[-1][0] >= 0.999, f"mlab band {r}: B2 disagrees with its plain version")
    gates["capsule_mlab (composite: rgba share within 1e-4, max)"] = comp_ok

    def mlab_stats(x, y=one["mlab"]):
        d = (x - y).abs()
        return {"mean_abs": float(d.mean()), "share_over_002": float((d > 0.02).float().mean()),
                "max_abs": float(d.max())}

    f = bands["mlab"]
    f.update(mlab_stats(stitched), one_ulp_floor={
        label: mlab_stats(render_tubes_mlab(dataclasses.replace(scene, a=nudged(scene.a, t)),
                                            *cam, s_oit, K=MLAB_K, opacity=MLAB_OPACITY))
        for label, t in (("up", float("inf")), ("down", float("-inf")))},
        planted_faults={"bands_1_on_one_row_off": mlab_stats(torch.cat(
            [parts[0]] + [mlab_band(r, 1) for r in range(1, n)], dim=1))})
    gate(within(f, PAR_MLAB_BARS), f"mlab bands disagree with the world of one: {f}")
    for k, v in f["planted_faults"].items():
        gate(not within(v, PAR_MLAB_BARS), f"mlab bands: the planted fault {k} passes")

    # RTAO ranks: rank r draws under fold_in(key, r); B1, R6, B5 gated.
    parts = timed_bands("rtao", lambda r: rtao_mod.rtao_occlusion(
        scene, *cam, s_rt, rt, grid=grid_ao, rank=r),
        {"capsule_raster": 1, "ao_grid": len(batches), "threefry_uniform": 2})
    gbuf = parts[0][0]
    mean = vdiv(torch.stack([o for _, o in parts]).sum(dim=0), n)
    stitched = rtao_mod.rtao_image(gbuf, mean, cam[1], s_rt, rt)
    rank0 = rtao_mod.rtao_image(gbuf, parts[0][1], cam[1], s_rt, rt)
    csr, params, _ = prepare_capsule_frame(scene, *cam, s_rt)
    g_args = (csr, params, W, H, 32, 16)
    k, p = rasterize_capsules(*g_args, use_aa=False), rasterize_capsules_reference(
        *g_args, use_aa=False)
    gates["capsule_raster (no AA)"] = all(torch.equal(x, y) for x, y in zip(
        [k[0], k[1], *k[2]], [p[0], p[1], *p[2]]))
    r6, b5 = [], []
    for r in range(n):
        shape = (rt.num_samples, H, W)
        u = [threefry_uniform(fold(r), shape, split=j) for j in range(2)]
        r6.append(all(torch.equal(u[j], threefry.uniform(threefry.split_at(fold(r), j), shape))
                      for j in range(2)))
        o, d, t_max, valid = rtao_mod.rtao_rays(gbuf, scene.radius, rt, *u)
        s0, s1 = batches[0]
        pairs = ao_grid.expand_ray_pairs(o[:, s0:s1], d[:, s0:s1], t_max[s0:s1], valid[s0:s1],
                                         grid_ao, rt.max_ray_cells)
        args = (pairs.rays, pairs.seg_begin, pairs.seg_chunks, grid_ao.records, grid_ao.chunk)
        b5.append(bool(torch.equal(ao_grid.trace_pairs(*args),
                                   ao_grid.trace_pairs_reference(*args))))
    gates["threefry_uniform"], gates["ao_grid (batch 0)"] = r6, b5
    ref = rtao_mod.render_tubes_rtao(scene, *cam, s_rt, dataclasses.replace(
        rt, num_samples=PAR_REF_AO_SAMPLES, seed=99), grid=grid_ao)
    bands["rtao"].update(
        rank0_equal_world_of_one=bool(torch.equal(rank0, one["rtao"])),
        mse_ranks_vs_reference=float(((stitched - ref) ** 2).mean()),
        mse_rank0_vs_reference=float(((rank0 - ref) ** 2).mean()))

    # The opacity solve: each band's gather ('gather'), MIN / MAX, smoothing.
    parts = timed_bands("opacity_solve", lambda r: oo_mod.segment_reductions(
        *oo_mod.gather_importance(scene, *cam, s_oit, oo, band=r, n_bands=n), oo,
        scene.num_segments), {"capsule_mlab": 1})
    seg_op, seg_vis = parts[0]
    for o_, v_ in parts[1:]:
        seg_op, seg_vis = torch.minimum(seg_op, o_), torch.maximum(seg_vis, v_)
    solved = oo_mod.smooth_vertex_opacity(seg_op, seg_vis, prev, oo, L, P)
    g_eq = []
    for r in range(n):
        csr, params, s2 = oo_mod.prepare_gather_frame(scene, *cam, s_oit, oo, r, n)
        args = (csr, params, s2.width, s2.height, 16, 8, oo.gather_k, s2.tf_color,
                s2.tf_opacity)
        k = rasterize_capsules_mlab(*args, store_mode="gather")
        p = rasterize_capsules_mlab_reference(*args, store_mode="gather")
        g_eq.append(all(torch.equal(x, y) for x, y in zip(k, p)))
    gates["capsule_mlab:gather"] = g_eq

    def solve_stats(x, y=one["opacity_solve"]):
        d = (x - y).abs()
        return {"share_over_1e3": float((d > 1e-3).float().mean()),
                "median_abs": float(d.median()), "max_abs": float(d.max())}

    def band_solve(kept):
        seg_op, seg_vis = parts[kept[0]]
        for r in kept[1:]:
            seg_op = torch.minimum(seg_op, parts[r][0])
            seg_vis = torch.maximum(seg_vis, parts[r][1])
        return oo_mod.smooth_vertex_opacity(seg_op, seg_vis, prev, oo, L, P)

    f = bands["opacity_solve"]
    f.update(solve_stats(band_solve(range(n))), one_ulp_floor={
        label: solve_stats(oo_mod.opacity_solve(dataclasses.replace(scene, a=nudged(scene.a, t)),
                                                *cam, prev, s_oit, oo, L, P))
        for label, t in (("up", float("inf")), ("down", float("-inf")))},
        planted_faults={"band_1_dropped": solve_stats(band_solve([0] + list(range(2, n))))})
    gate(within(f, PAR_SOLVE_BARS), f"opacity-solve bands disagree with the world of one: {f}")
    for k, v in f["planted_faults"].items():
        gate(not within(v, PAR_SOLVE_BARS), f"opacity-solve bands: the planted fault {k} passes")

    # VPT ranks: rank r traces under fold_in(key, r); R3 on a slice of rank 1.
    parts = timed_bands("vpt", lambda r: render_vpt(
        threefry.fold_in(key, r), cloud, vcam[1], vbasis, W, H, vs, spp=vs.samples_per_frame),
        {"vpt_tracking": vs.samples_per_frame})
    stitched = vdiv(torch.stack(parts).sum(dim=0), n)
    sun_dir, sun_ic = sun_constants(vs)
    _, kt, origins, dirs = primary_rays(threefry.fold_in(key, 1), vcam[1], vbasis, W, H)
    vp_ = vt.vpt_params(cloud.shape, vs.extinction, vs.scattering_albedo, sun_dir, sun_ic,
                        vs.phase_g, vs.mode, vs.max_events, vs.interpolation)
    r0 = (H // 2) * W
    k_out = vt.vpt_tracking(cloud, origins, dirs, kt, vp_)
    p_out = vt.vpt_tracking_reference(cloud, origins[r0:r0 + PAR_R3_RAYS],
                                      dirs[r0:r0 + PAR_R3_RAYS], kt, vp_, first=r0)
    gates["vpt_tracking (rank 1, sample 0, rays of the middle row)"] = all(
        torch.equal(x[r0:r0 + PAR_R3_RAYS], y) for x, y in zip(k_out, p_out))
    vref = render_vpt(threefry.prng_key(99, dev), cloud, vcam[1], vbasis, W, H, vs,
                      spp=PAR_REF_VPT_SPP)
    bands["vpt"].update(
        rank0_equal_world_of_one=bool(torch.equal(parts[0], one["vpt"])),
        mse_ranks_vs_reference=float(((stitched - vref) ** 2).mean()),
        mse_rank0_vs_reference=float(((parts[0] - vref) ** 2).mean()))
    for label in ("rtao", "vpt"):
        f = bands[label]
        gate(f["rank0_equal_world_of_one"]
             and f["mse_ranks_vs_reference"] < f["mse_rank0_vs_reference"],
             f"{label} ranks: {f}")
    print("parallel bands: " + json.dumps({
        "bands": n, **bands, "gates": gates, "dryrun_multichip_s": dryrun_s,
        "setup_s": setup_s, "phase_s": time.perf_counter() - t_phase, "width": W, "height": H,
        "gpu": gpu}), flush=True)
    bad = [k for k, v in gates.items() if v is not True and not (
        isinstance(v, list) and all(x is True or isinstance(x, list) for x in v))]
    gate(not bad, f"kernels differ from their plain versions: {bad}")
    if failures:
        raise RuntimeError("parallel phase: " + "; ".join(failures))
    return {name: line["frame_ms"] for name, line in world.items()}


def main() -> int:
    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from linevis_tpu_torch.entry import (
        entry,
        entry_depth_complexity,
        entry_depth_peeling,
        entry_mboit,
        entry_mlab,
        entry_mlab_buckets,
        entry_opacity_optimization,
        entry_wboit,
        entry_prism,
        entry_rtao,
        entry_triangle,
        entry_wavefront,
        tornado_prism_scene,
        tornado_scene,
        tornado_segment_grid,
        tornado_trajectories,
        tornado_tube_mesh,
        tornado_wide_bvh,
        _small_lines,
        BASELINE_CONFIGS,
        TORNADO_LINE_WIDTH,
        TORNADO_RADIUS,
        convection_line_data,
        femur_line_data,
        sphere_mesh_data,
    )
    from linevis_tpu_torch.core.settings import SettingsMap
    from linevis_tpu_torch.core.trajectories import Trajectories
    from linevis_tpu_torch.kernels import _build, ao_grid, raster_pallas
    from linevis_tpu_torch.kernels.bvh_closest_hit import (
        capsule_closest_hit,
        capsule_closest_hit_reference,
    )
    from linevis_tpu_torch.kernels.bvh_mlat import STATS as MLAT_STATS
    from linevis_tpu_torch.kernels.bvh_mlat import mlat_nodes, mlat_nodes_reference
    from linevis_tpu_torch.kernels.density_march import density_march
    from linevis_tpu_torch.kernels.spherical_heatmap import heatmap_density
    from linevis_tpu_torch.kernels.threefry_uniform import threefry_uniform
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.kernels.vpt_decomposition import vpt_decomposition
    from linevis_tpu_torch.kernels.vpt_residual_ratio import vpt_residual_ratio
    from linevis_tpu_torch.kernels.vpt_tracking import vpt_tracking
    from linevis_tpu_torch.ops.lbvh import lbvh_on, packed_nodes, packed_wide_nodes
    from linevis_tpu_torch.kernels.bvh_wavefront import (
        STATS as WF_STATS,
        trace_wavefront_kbuffer,
        trace_wavefront_kbuffer_reference,
    )
    from linevis_tpu_torch.kernels.raster_capsule import (
        rasterize_capsules,
        rasterize_capsules_reference,
    )
    from linevis_tpu_torch.kernels.raster_capsule_oit import (
        MBOIT_DISCARD_B0,
        rasterize_capsules_accum,
        rasterize_capsules_mlab,
        rasterize_capsules_mlab_reference,
    )
    from linevis_tpu_torch.kernels.raster_prism import (
        rasterize_prisms,
        rasterize_prisms_reference,
    )
    from linevis_tpu_torch.kernels.tiles import unpack_tiles
    from linevis_tpu_torch.ops.wide_bvh import USED_LANES
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.framebuffer import ssim
    from linevis_tpu_torch.render import oit as oit_module
    from linevis_tpu_torch.render import opacity_optimization as oo_module
    from linevis_tpu_torch.render.opacity_optimization import (
        OpacityOptimizationRenderer,
        OpacityOptimizationSettings,
        final_render,
        gather_importance,
        gather_settings,
        solve_vertex_opacity,
    )
    from linevis_tpu_torch.render.renderer import (
        RENDERING_MODE_ALL,
        UNPORTED_MODES,
        create_renderer,
    )
    from linevis_tpu_torch.scene.line_data import LineData
    from linevis_tpu_torch.render.oit import (
        prepare_mboit_frame,
        prepare_mlab_frame,
        render_depth_complexity,
        render_tubes_atomic_loop,
        render_tubes_depth_peeling,
        render_tubes_mboit,
        render_tubes_mlab,
        render_tubes_mlab_buckets,
        render_tubes_wboit,
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
    from linevis_tpu_torch.render.ao_bake import AoBakeSettings, bake_ambient_occlusion
    from linevis_tpu_torch.render.deferred import motion_vectors, render_tubes_deferred
    from linevis_tpu_torch.render.denoiser import svgf_temporal_denoise
    from linevis_tpu_torch.render.ray_tracer import (
        RT_TILE,
        _depth_cue_range,
        build_capsule_bvh,
        capsule_recast,
        primary_rays,
        render_tubes_mlat,
        render_tubes_raytraced,
        render_tubes_raytraced_wavefront,
        resolve_wavefront_nodes,
        tile_rays,
        trace_recast,
    )
    from linevis_tpu_torch.render.ssao import gtao, ssao
    from linevis_tpu_torch.render.rtao import (
        RtaoSettings,
        hemisphere_uniforms,
        ray_batches,
        render_tubes_rtao,
        rtao_gbuffer,
        rtao_rays,
        rtao_shade,
    )
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import (
        _ray_basis,
        camera_tensors,
        prepare_capsule_frame,
        prepare_prism_frame,
        render_tubes,
        render_tubes_prism,
        resolve_capsule_frame,
    )

    wrappers = {
        "capsule_raster": rasterize_capsules, "capsule_mlab": rasterize_capsules_mlab,
        "capsule_accum": rasterize_capsules_accum,
        "prism_raster": rasterize_prisms, "triangle_raster": raster_pallas.rasterize_gbuffer,
        "ao_grid": ao_grid.trace_pairs, "bvh_wavefront": trace_wavefront_kbuffer,
        "bvh_closest_hit": capsule_closest_hit, "bvh_recast": capsule_recast,
        "bvh_mlat": mlat_nodes, "vpt_tracking": vpt_tracking, "density_march": density_march,
        "spherical_heatmap": heatmap_density, "threefry_uniform": threefry_uniform,
        "vpt_decomposition": vpt_decomposition, "vpt_residual_ratio": vpt_residual_ratio,
    }

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def expect_launches(expected):
        """Launches since reset_launches() against {kernel: count}; raises
        unless each named kernel was launched exactly that often and no
        other kernel at all. Returns the counts."""
        got = {name: w.launches for name, w in wrappers.items()}
        for name, n in got.items():
            if n != expected.get(name, 0):
                raise RuntimeError(f"the path launched {name} {n} times, expected "
                                   f"{expected.get(name, 0)} (all launches: {got})")
        return got

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
            if "Compiling entry function" in line:
                print(f"  {name}: {line.split(chr(39))[1]}", flush=True)
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    resources = {name: kernel_resources(_build.load(name))
                 for name in ("raster_capsule", "raster_triangle", "raster_prism", "bvh_wavefront",
                              "bvh_closest_hit", "bvh_mlat", "vpt_decomposition",
                              "vpt_residual_ratio")}
    for name, inst in resources.items():
        print(f"{name} instances: " + json.dumps(inst), flush=True)

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
    launches = expect_launches({"capsule_raster": N_FRAMES})["capsule_raster"]
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
    cap_equal = all(bool(torch.equal(a, b)) for a, b in zip(
        [k_out[0], ids_k, *k_out[2]], [p_out[0], ids_p, *p_out[2]]))
    cap_per_tile = csr.tile_count.double()
    cap_tiles = {"candidates_per_tile_p50": float(cap_per_tile.quantile(0.5)),
                 "candidates_per_tile_p99": float(cap_per_tile.quantile(0.99)),
                 "candidates_per_tile_max": int(csr.tile_count.max())}
    img_k = resolve_capsule_frame(scene, csr, k_out, *cams[0], basis, settings)
    img_p = resolve_capsule_frame(scene, csr, p_out, *cams[0], basis, settings)
    img_k_np = img_k.permute(1, 2, 0).cpu().numpy()
    img_p_np = img_p.permute(1, 2, 0).cpu().numpy()
    img_ssim = ssim(img_k_np[..., :3], img_p_np[..., :3])
    img_mad = float(np.abs(img_k_np - img_p_np).mean())
    fg = float((ids_k >= 0).float().mean())
    print(f"capsule_raster vs plain: pairs {pairs}, evaluated after early-z {evaluated}, "
          f"equal {cap_equal}, id agree {id_agree:.6f}, max |dz, dgbuf| {max_gbuf:.3g}, "
          f"max |dcov| {max_cov:.3g}, image ssim {img_ssim:.6f}, mean abs {img_mad:.3g}, "
          f"foreground {fg:.4f}, candidates per tile p50 "
          f"{cap_tiles['candidates_per_tile_p50']:.1f}, p99 "
          f"{cap_tiles['candidates_per_tile_p99']:.1f}, max "
          f"{cap_tiles['candidates_per_tile_max']}", flush=True)
    if not np.isfinite(img_k_np).all():
        raise RuntimeError("non-finite pixels in the 1080p frame")
    if not cap_equal:
        raise RuntimeError("capsule kernel differs from its plain version")
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
    need = capsule_needed_work(csr, params, W, H, 32, 16, work)
    ops = (need["evaluations"] * CAPSULE_OPS_BASE + need["start_cap"] * CAPSULE_OPS_START_CAP
           + need["body_aa"] * CAPSULE_OPS_BODY_AA
           + (need["cap_a_aa"] + need["cap_b_aa"]) * CAPSULE_OPS_CAP_AA)
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    t_ops_every_part = evaluated * P * CAPSULE_OPS_PER_EVAL / H100_FP32_FLOPS * 1e3
    print("capsule_raster needed work: " + json.dumps(need), flush=True)
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
        "operations_ms_every_part": t_ops_every_part,
        "library_ms": None,
        "equal": cap_equal,
        "id_agree": id_agree,
        "max_abs_gbuf": max_gbuf,
        "max_abs_cov": max_cov,
        "kernel_ms": kernel_ms,
        "pairs": pairs,
        "evaluated": evaluated,
        "needed_work": need,
        **cap_tiles,
        "instances": resources["raster_capsule"],
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
    mlab_launches = expect_launches({"capsule_mlab": N_FRAMES})["capsule_mlab"]
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

    def timed_plain(fn):
        a, b = _events()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def oit_entry(name, source, launches, max_err, ms, plain_ms, n_tiles, K, stats, ops,
                  extra_in_planes=0, out_planes=None, P=16 * 8, **extra):
        """A B2 `kernels` row. Its bound: the front-face test's needed work
        from the plain version's `stats` (`hit_ops`) and `ops`, the rest of
        the work; beside it the bound with every part of the test charged
        at every evaluation. Output: 5K planes, or `out_planes`."""
        evaluated = stats["evaluations"] // P
        hit, hit_every, need = hit_ops(stats)
        in_bytes = (evaluated * MLAB_ROWS * 4 + 2 * n_tiles * 4 + 32 * 4
                    + extra_in_planes * n_tiles * P * 4)
        out_bytes = (5 * K if out_planes is None else out_planes) * n_tiles * P * 4
        t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
        t_ops = (hit + ops) / H100_FP32_FLOPS * 1e3
        row = {
            "name": name, "route": "cuda",
            "source": f"linevis_tpu_torch/kernels/csrc/{source}",
            "replaces": "linevis_tpu/kernels/raster_capsule_oit.py:116",
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "evaluated": evaluated,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": in_bytes + out_bytes, "bytes_ms": t_bytes, "operations_ms": t_ops,
            "library_ms": None, "needed_work": need,
            "bound_ms_every_part": max(t_bytes, (hit_every + ops) / H100_FP32_FLOPS * 1e3),
            **extra,
        }
        print(f"{name} bound: {row['bound_ms']:.5f} ms from the needed work "
              f"{json.dumps(need)} (every part at every evaluation: "
              f"{row['bound_ms_every_part']:.5f} ms)", flush=True)
        return row

    def composite_gate(name, scene_g, cam, s_g, K, opacity, launches, seg_alpha=None,
                       **extra):
        """B2's composite (deferred shading, sub MLAB_SUB, sat 0.999) on one
        frame (camera tensors `cam`) against its plain version: depths and
        alpha within 1e-5 on >= 99.9% of pixels, features there within 1e-5,
        RGBA within 1e-4 on >= 99.9%, equal work counts, the image at SSIM
        >= 0.999 and mean abs <= 2e-3 -> (its `kernels` row, the prepared
        frame)."""
        csr_g, params_g = prepare_mlab_frame(scene_g, *cam, s_g, opacity, seg_alpha)
        n_t = csr_g.tile_start.shape[0]
        args = (csr_g, params_g, s_g.width, s_g.height, s_g.tile_w, s_g.tile_h, K,
                s_g.tf_color, s_g.tf_opacity)
        kw = dict(deferred_shade=True, sub=MLAB_SUB, sat=0.999,
                  alpha_from_rows=seg_alpha is not None)
        work_g = torch.zeros(n_t, dtype=torch.int32, device=dev)
        k_rgba = rasterize_capsules_mlab(*args, composite=True, work=work_g, **kw)
        k_nodes = rasterize_capsules_mlab(*args, composite=False, **kw)
        st, p_work_g = {}, torch.zeros_like(work_g)
        p_rgba, p_ms = timed_plain(lambda: rasterize_capsules_mlab_reference(
            *args, composite=True, stats=st, work=p_work_g, **kw))
        p_nodes = rasterize_capsules_mlab_reference(*args, composite=False, **kw)
        d_err = (k_nodes[0] - p_nodes[0]).abs().amax(dim=0)
        a_err = (k_nodes[2] - p_nodes[2]).abs().amax(dim=0)
        f_err = (k_nodes[1] - p_nodes[1]).abs().amax(dim=(0, 1))
        rgba_err = (k_rgba - p_rgba).abs().amax(dim=0)
        agree = (d_err <= 1e-5) & (a_err <= 1e-5)
        nodes_ok_g = float(agree.float().mean())
        f_ok = float(f_err[agree].max())
        rgba_ok_g = float((rgba_err <= 1e-4).float().mean())

        def img(x):
            return torch.stack([unpack_tiles(x[c], csr_g.tiles_x, csr_g.tiles_y, s_g.tile_w,
                                             s_g.tile_h, s_g.width, s_g.height)
                                for c in range(4)]).permute(1, 2, 0).cpu().numpy()

        i_k, i_p = img(k_rgba), img(p_rgba)
        s_img, mad_img = ssim(i_k[..., :3], i_p[..., :3]), float(np.abs(i_k - i_p).mean())
        evaluated, k_evaluated = int(p_work_g.sum()), int(work_g.sum())
        max_err = max(float(d_err.max()), float(a_err.max()), float(f_err.max()),
                      float(rgba_err.max()))
        print(f"{name} vs plain: K {K}, pairs {int(csr_g.tile_count.sum())}, evaluated "
              f"{evaluated} (kernel {k_evaluated}), hits {st['hits']}, sweeps {st['sweeps']}, "
              f"members {st['members']}; node depth+alpha within 1e-5 on {nodes_ok_g:.6f} "
              f"(max |dd| {float(d_err.max()):.3g}, |da| {float(a_err.max()):.3g}, features "
              f"there {f_ok:.3g}), rgba within 1e-4 on {rgba_ok_g:.6f} (max "
              f"{float(rgba_err.max()):.3g}), image ssim {s_img:.6f}, mean abs {mad_img:.3g}",
              flush=True)
        if not np.isfinite(i_k).all() or (i_k[..., 3] > 0).mean() < 0.01:
            raise RuntimeError(f"{name}: the kernel's frame is non-finite or empty")
        if nodes_ok_g < 0.999 or f_ok > 1e-5 or rgba_ok_g < 0.999:
            raise RuntimeError(f"{name}: the kernel disagrees with its plain version")
        if k_evaluated != evaluated:
            raise RuntimeError(f"{name}: the kernel's work count differs from its plain "
                               "version's")
        if s_img < 0.999 or mad_img > 2e-3:
            raise RuntimeError(f"{name}: the kernel's image disagrees with the plain version's")
        ms = _time_ms(lambda: rasterize_capsules_mlab(*args, composite=True, **kw), 20)
        ops = (st["members"] * MLAB_OPS_PER_MEMBER
               + st["sweeps"] * (MLAB_OPS_PER_SWEEP + MLAB_OPS_PER_SWEEP_NODE * K))
        return oit_entry(
            name, "raster_capsule_oit.cu", launches, max_err, ms, p_ms, n_t, K, st, ops,
            out_planes=4, P=s_g.tile_w * s_g.tile_h, node_agree=nodes_ok_g,
            rgba_agree=rgba_ok_g, pairs=int(csr_g.tile_count.sum()),
            kernel_evaluated=k_evaluated, hits=st["hits"], sweeps=st["sweeps"],
            members=st["members"], shape=[s_g.width, s_g.height], **extra), (csr_g, params_g)

    # 8. The MLAB kernel vs its plain version on frame 0's inputs (composite
    # and node mode), and its figures at the 1080p shapes.
    kernels.append(composite_gate("capsule_mlab", scene, cams[0], s_oit, MLAB_K, MLAB_OPACITY,
                                  mlab_launches)[0])

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

    # 10a. The rest of the OIT family: OIT_FRAMES frames of each renderer
    # through its entry point, launches counted per phase.
    oit_runs = {
        "depth complexity": (
            lambda cam: render_depth_complexity(scene, *cam, s_oit), {"capsule_accum": 1}),
        "wboit": (lambda cam: render_tubes_wboit(scene, *cam, s_oit, opacity=OIT_OPACITY),
                  {"capsule_accum": 1}),
        "mboit": (lambda cam: render_tubes_mboit(scene, *cam, s_oit, n_mom=4,
                                                 opacity=OIT_OPACITY), {"capsule_accum": 2}),
        "mlab buckets": (lambda cam: render_tubes_mlab_buckets(scene, *cam, s_oit, K=8,
                                                               opacity=OIT_OPACITY),
                         {"capsule_mlab": 2}),
        "depth peeling": (lambda cam: render_tubes_depth_peeling(
            scene, *cam, s_oit, K=8, passes=4, opacity=OIT_OPACITY), {"capsule_mlab": 4}),
    }
    ocams = cams[:OIT_FRAMES]
    oit_launches, oit_img0 = {}, {}
    for label, (render, per_frame) in oit_runs.items():
        render(ocams[0])  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        frame_ev = [_events() for _ in ocams]
        imgs_sum = torch.zeros((), device=dev)
        for (a, b), cam in zip(frame_ev, ocams):
            a.record()
            img = render(cam)
            b.record()
            imgs_sum += img.sum()
        torch.cuda.synchronize()
        oit_launches[label] = expect_launches(
            {k: n * OIT_FRAMES for k, n in per_frame.items()})
        if not bool(torch.isfinite(imgs_sum)):
            raise RuntimeError(f"non-finite {label} frame on the main path")
        oit_img0[label] = render(ocams[0])
        med = float(np.median([a.elapsed_time(b) for a, b in frame_ev]))
        line = {"frame_ms_median": med, "fps": 1000.0 / med,
                "launches_per_frame": per_frame, "frames": OIT_FRAMES, "width": W,
                "height": H, "gpu": gpu}
        if label == "depth complexity":
            counts = oit_img0[label]
            fg_counts = counts[counts > 0]
            line.update(foreground_share=float((counts > 0).float().mean()),
                        max_count_foreground=float(fg_counts.max()),
                        mean_count_foreground=float(fg_counts.mean()),
                        pixels_over_32=int((counts > 32).sum()))
            if line["foreground_share"] < 0.01:
                raise RuntimeError("the depth complexity frame is almost empty")
        else:
            line["foreground_share"] = float((oit_img0[label][3] > 0).float().mean())
            if line["foreground_share"] < 0.01:
                raise RuntimeError(f"the {label} frame is almost empty")
        print(f"{label} frame: " + json.dumps(line), flush=True)

    # 10b. Each new mode's kernel against its plain version on frame 0's
    # inputs at 1080p, and the five frames rendered on the plain path.
    def plain_path_image(render, cam):
        """`render`'s frame with every OIT kernel call on its plain version."""
        oit_module.rasterize_capsules_mlab = rasterize_capsules_mlab_reference
        try:
            return render(cam)
        finally:
            oit_module.rasterize_capsules_mlab = rasterize_capsules_mlab

    def images_agree(label, k_img, p_img, nonfinite_ok=False):
        """SSIM and mean abs of a kernel frame against its plain-path frame.
        `nonfinite_ok`: non-finite pixels pass where both frames have them
        (the trigonometric MBOIT transmittance overflows as the JAX
        package's does, ROADMAP queue C) and are left out of the figures."""
        if k_img.dim() == 2:
            ok = bool(torch.equal(k_img, p_img))
            print(f"{label} frame kernel vs plain path: equal {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"the {label} frame differs from its plain path")
            return 1.0, 0.0, 0
        k_np, p_np = k_img.permute(1, 2, 0).cpu().numpy(), p_img.permute(1, 2, 0).cpu().numpy()
        k_bad, p_bad = ~np.isfinite(k_np).all(-1), ~np.isfinite(p_np).all(-1)
        n_bad = int(k_bad.sum())
        if n_bad and not (nonfinite_ok and np.array_equal(k_bad, p_bad)):
            raise RuntimeError(f"the {label} frame has {n_bad} non-finite pixels")
        k_np, p_np = np.nan_to_num(k_np), np.nan_to_num(p_np)
        s_, mad = ssim(k_np[..., :3], p_np[..., :3]), float(np.abs(k_np - p_np).mean())
        print(f"{label} frame kernel vs plain path: ssim {s_:.6f}, mean abs {mad:.3g}, "
              f"non-finite pixels {n_bad} (the same in both)", flush=True)
        if s_ < 0.999 or mad > 2e-3:
            raise RuntimeError(f"the {label} frame disagrees with its plain path")
        return s_, mad, n_bad

    oit_image_check = {}
    for label, (render, _) in oit_runs.items():
        oit_image_check[label] = images_agree(
            label, oit_img0[label], plain_path_image(render, ocams[0]))

    def share_within(k, p, scale, tol):
        """Share of pixels whose every plane of k is within tol * scale of p."""
        err = (k - p).abs().reshape(-1, *k.shape[-2:]).amax(dim=0)
        return float((err <= tol * scale).float().mean())

    def planes(out):
        return torch.cat([out[0], out[1].flatten(0, 1), out[2]])

    def accum_check(mode, csr, params, K, kept=None, s=None, **kw):
        """The accumulation kernel vs its plain version in `mode`, bit for
        bit -> (kernel output, entry fields). kept: for 'mboit_resolve', the
        pixels whose moments it keeps and their fragments, which need the
        moment factors and the transmittance. s: the frame's RasterSettings
        (s_oit if None)."""
        s = s or s_oit
        args = (csr, params, s.width, s.height, s.tile_w, s.tile_h, K, s.tf_color,
                s.tf_opacity)
        k = rasterize_capsules_mlab(*args, store_mode=mode, **kw)
        stats = {}
        p, p_ms = timed_plain(lambda: rasterize_capsules_mlab_reference(
            *args, store_mode=mode, stats=stats, **kw))
        kp, pp = planes(k), planes(p)
        if not bool(torch.isfinite(kp).all()):
            raise RuntimeError(f"non-finite {mode} accumulators")
        equal = torch.equal(kp, pp)
        max_err = float((kp - pp).abs().max())
        ms = _time_ms(lambda: rasterize_capsules_mlab(*args, store_mode=mode, **kw), 20)
        pairs = int(csr.tile_count.sum())
        per_fragment = OIT_OPS_PER_ACCUM[mode]
        extra = 0
        if mode == "mboit_resolve":
            # The transmittance only at the kept pixels' fragments; the
            # factors once per kept pixel.
            per_fragment = 8
            extra = (kept["fragments"] * (OIT_OPS_PER_ACCUM[mode] - 8)
                     + kept["pixels"] * OIT_OPS_RESOLVE_PIXEL)
        frag_ops = extra + stats["hits"] * (
            (0 if mode == "count" else MLAB_OPS_PER_MEMBER)
            + (OIT_OPS_PER_SHADE if mode in ("wboit", "mboit_resolve") else 0)
            + per_fragment)
        print(f"capsule_accum:{mode} vs plain: pairs {pairs}, fragments {stats['hits']}, "
              f"equal {equal}, max |diff| {max_err:.3g}, kernel {ms:.3f} ms, plain "
              f"{p_ms:.1f} ms", flush=True)
        if not equal:
            raise RuntimeError(f"accumulation kernel differs from its plain version ({mode})")
        return k, dict(max_err=max_err, ms=ms, plain_ms=p_ms, stats=stats, ops=frag_ops,
                       pairs=pairs, fragments=stats["hits"], equal=equal)

    def accum_entry(name, launches, f, n_tiles, K, **extra):
        """The `kernels` row of an accumulation mode (`oit_entry`)."""
        return oit_entry(name, "raster_capsule_accum.cu", launches, f["max_err"], f["ms"],
                         f["plain_ms"], n_tiles, K, f["stats"], f["ops"], pairs=f["pairs"],
                         fragments=f["fragments"], equal=f["equal"], **extra)

    csr, params, _ = prepare_capsule_frame(scene, *cams[0], s_oit)
    params[14] = OIT_OPACITY
    n_tiles = csr.tile_start.shape[0]
    new_kernels = []
    for mode, label in (("count", "depth complexity"), ("wboit", "wboit")):
        k_acc, f = accum_check(mode, csr, params, 1)
        if mode == "count":
            frag_count = k_acc[0][0]  # fragments per pixel
        new_kernels.append(accum_entry(f"capsule_accum:{mode}",
                                       oit_launches[label]["capsule_accum"], f, n_tiles, 1))
    csr_c = csr
    csr, params, _ = prepare_mboit_frame(scene, *cams[0], s_oit, 4, OIT_OPACITY)
    if not torch.equal(csr.tile_count, csr_c.tile_count):
        raise RuntimeError("the MBOIT frame's binning differs from the capsule frame's")
    gen, f = accum_check("mboit_gen", csr, params, 2, n_mom=4)
    new_kernels.append(accum_entry("capsule_accum:mboit_gen",
                                   oit_launches["mboit"]["capsule_accum"] // 2, f, n_tiles, 2))
    moments = torch.stack([gen[0][0], gen[1][0, 0], gen[1][1, 0], gen[0][1], gen[1][0, 1]])
    kept_px = moments[0] >= MBOIT_DISCARD_B0
    kept = {"pixels": int(kept_px.sum()), "fragments": int(frag_count[kept_px].sum())}
    _, f = accum_check("mboit_resolve", csr, params, 1, kept, n_mom=4, moments=moments)
    new_kernels.append(accum_entry("capsule_accum:mboit_resolve",
                                   oit_launches["mboit"]["capsule_accum"] // 2, f, n_tiles, 1,
                                   extra_in_planes=5,
                                   kept_pixels=kept["pixels"], kept_fragments=kept["fragments"]))

    # The K-buffer with a peel depth and per-fragment shading: the second
    # pass of depth peeling (exact) and of MLAB buckets (MLAB merge).
    csr, params = prepare_mlab_frame(scene, *cams[0], s_oit, OIT_OPACITY)
    n_tiles = csr.tile_start.shape[0]
    kargs = (csr, params, W, H, 16, 8, 8, s_oit.tf_color, s_oit.tf_opacity)
    d1, _, _ = rasterize_capsules_mlab(*kargs, no_overflow=True)
    peel = torch.where(d1 < 1.5, d1, -1.0).amax(dim=0).contiguous()
    for no_overflow, name, launches in (
            (True, "capsule_mlab:peel_exact",
             oit_launches["depth peeling"]["capsule_mlab"]
             + oit_launches["mlab buckets"]["capsule_mlab"] // 2),
            (False, "capsule_mlab:peel_merge",
             oit_launches["mlab buckets"]["capsule_mlab"] // 2)):
        kw = dict(peel=peel, no_overflow=no_overflow)
        work = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        kd, kc, ka = rasterize_capsules_mlab(*kargs, work=work, **kw)
        stats = {}
        p_work = torch.zeros_like(work)
        (pd, pc, pa), p_ms = timed_plain(
            lambda: rasterize_capsules_mlab_reference(*kargs, stats=stats, work=p_work, **kw))
        evaluated, k_evaluated = int(p_work.sum()), int(work.sum())
        d_err = (kd - pd).abs().amax(dim=0)
        rgba_err = torch.maximum((kc - pc).abs().amax(dim=(0, 1)), (ka - pa).abs().amax(dim=0))
        agree = float(((d_err <= 1e-5) & (rgba_err <= 1e-4)).float().mean())
        max_err = max(float(d_err.max()), float(rgba_err.max()))
        behind = bool(((kd > peel[None]) | (kd == 2.0)).all())
        ms = _time_ms(lambda: rasterize_capsules_mlab(*kargs, **kw), 20)
        ops = (stats["hits"] * OIT_OPS_PER_PEEL
               + stats["members"] * (MLAB_OPS_PER_MEMBER + OIT_OPS_PER_SHADE)
               + stats["sweeps"] * (MLAB_OPS_PER_SWEEP + MLAB_OPS_PER_SWEEP_NODE * 8))
        print(f"{name} vs plain (peel behind an exact K=8 pass): evaluated {evaluated} "
              f"(kernel {k_evaluated}), hits "
              f"{stats['hits']}, sweeps {stats['sweeps']}, members {stats['members']}, nodes "
              f"within 1e-5 (depth) and 1e-4 (rgba) on {agree:.6f} of pixels (max |diff| "
              f"{max_err:.3g}), every node behind the peel depth {behind}, kernel {ms:.3f} ms, "
              f"plain {p_ms:.1f} ms", flush=True)
        if agree < 0.999 or not behind or not bool(torch.isfinite(kc).all()):
            raise RuntimeError(f"{name}: the kernel disagrees with its plain version")
        new_kernels.append(oit_entry(
            name, "raster_capsule_oit.cu", launches, max_err, ms, p_ms, n_tiles, 8, stats,
            ops, extra_in_planes=1, hits=stats["hits"], kernel_evaluated=k_evaluated,
            sweeps=stats["sweeps"], members=stats["members"], node_agree=agree))

    # 10c. Cross-mode readings on frame 0.
    def np_img(x):
        return x.permute(1, 2, 0).cpu().numpy()

    dc0 = oit_img0["depth complexity"]
    al32 = np_img(render_tubes_atomic_loop(scene, *ocams[0], s_oit, K=32, opacity=OIT_OPACITY))
    dp = np_img(oit_img0["depth peeling"])
    shallow = (dc0 <= 32).cpu().numpy()
    dp_cmp = np.where(shallow[..., None], dp, al32)
    dp_al_ssim = ssim(dp_cmp[..., :3], al32[..., :3])
    dp_al_mad = float(np.abs(dp - al32)[shallow].mean())
    ml = np_img(render_tubes_mlab(scene, *ocams[0], s_oit, K=8, opacity=OIT_OPACITY))
    mb = np_img(oit_img0["mboit"])
    # MBOIT's coverage 1 - exp(-b0) is exact over every fragment; MLAB's is
    # where it keeps every fragment as a node: not where the tie window
    # merges coincident fragments (a segment's cap and the next one's body at
    # a joint), nor where the saturation cull drops fragments behind T_K.
    csr_m, params_m = prepare_mlab_frame(scene, *ocams[0], s_oit, OIT_OPACITY)
    n_nodes = (rasterize_capsules_mlab(csr_m, params_m, W, H, 16, 8, 8, s_oit.tf_color,
                                       s_oit.tf_opacity, deferred_shade=True)[0] < 2.0).sum(0)
    n_nodes = unpack_tiles(n_nodes.float(), csr_m.tiles_x, csr_m.tiles_y, 16, 8, W, H)
    every = (n_nodes == dc0).cpu().numpy()
    alpha_ok = np.abs(mb[..., 3] - ml[..., 3]) <= 2e-3
    mb_alpha_ok = float(alpha_ok[every].mean())
    mb_color_mad = float(np.abs(mb[..., :3] - ml[..., :3]).mean())
    wb = np_img(oit_img0["wboit"])
    wb_ml_ssim = ssim(wb[..., :3], ml[..., :3])
    cross = {"depth_peeling_vs_atomic_loop32_ssim": dp_al_ssim,
             "depth_peeling_vs_atomic_loop32_mean_abs": dp_al_mad,
             "pixels_over_32_layers": int((~shallow).sum()),
             "mboit_vs_mlab8_alpha_within_2e-3": mb_alpha_ok,
             "mboit_vs_mlab8_alpha_within_2e-3_all_pixels": float(alpha_ok.mean()),
             "pixels_mlab8_keeps_every_fragment": float(every.mean()),
             "mboit_vs_mlab8_color_mean_abs": mb_color_mad,
             "wboit_vs_mlab8_ssim": wb_ml_ssim}
    print("oit cross-mode (camera 0, on the card): " + json.dumps(cross), flush=True)
    if dp_al_ssim < 0.999:
        raise RuntimeError("depth peeling (32 layers) does not match the Atomic Loop K=32")
    if mb_alpha_ok < 0.999 or mb_color_mad >= 0.02:
        raise RuntimeError("MBOIT is not within its bars of MLAB K=8")
    if wb_ml_ssim < 0.9:
        raise RuntimeError("the WBOIT frame does not look like the MLAB frame")

    # 10d. The MBOIT variants at a reduced frame: kernel vs plain path.
    sw, sh_ = OIT_SMALL
    s_small = RasterSettings(width=sw, height=sh_, tile_w=16, tile_h=8)
    cam_small = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=sw, height=sh_)
                               .orbit(0.002, 0.1, 1.2), dev)
    variants = {}
    for n_mom, trig, fmt in ((6, False, "float32"), (8, False, "float32"),
                             (4, True, "float32"), (6, True, "float32"),
                             (8, True, "float32"), (4, False, "unorm16"),
                             (8, True, "unorm16")):
        def render(cam, n_mom=n_mom, trig=trig, fmt=fmt):
            return render_tubes_mboit(scene, *cam, s_small, n_mom=n_mom, opacity=OIT_OPACITY,
                                      trigonometric=trig, pixel_format=fmt)

        key = f"{'trig' if trig else 'power'}{n_mom}_{fmt}"
        before = rasterize_capsules_accum.launches
        k_img = render(cam_small)
        if rasterize_capsules_accum.launches != before + 2:
            raise RuntimeError(f"MBOIT {key} did not launch the accumulation kernel twice")
        ms = _time_ms(lambda: render(cam_small), 5)
        s_, mad, n_bad = images_agree(f"mboit {key} {sw}x{sh_}", k_img,
                                      plain_path_image(render, cam_small), nonfinite_ok=trig)
        variants[key] = {"frame_ms": ms, "ssim_vs_plain": s_, "mean_abs_vs_plain": mad,
                         "nonfinite_pixels": n_bad}
    print("mboit variants: " + json.dumps(variants), flush=True)

    for make_entry, label in ((entry_wboit, "entry_wboit"),
                              (entry_depth_peeling, "entry_depth_peeling"),
                              (entry_mlab_buckets, "entry_mlab_buckets"),
                              (entry_mboit, "entry_mboit")):
        card_vs_cpu(make_entry, label)
    fn, args = entry_depth_complexity(device=dev)
    _, args_cpu = entry_depth_complexity(device="cpu")
    if not torch.equal(fn(*args).cpu(), fn(*args_cpu)):
        raise RuntimeError("the depth complexity of entry's scene differs card vs cpu")
    print("entry_depth_complexity card vs cpu: equal", flush=True)

    # 10e. Opacity optimization (bench.py cfg5): OO_FRAMES frames through the
    # renderer at tile 16x8 with the default settings, every frame moving the
    # camera, so each solves: the half-res importance gather (the K-buffer in
    # store mode 'gather'), the plain solve and the final MLAB render.
    oo_set = OpacityOptimizationSettings()
    oo_cams = [base.orbit(0.002 * (i + 1), 0.1, 1.2) for i in range(OO_FRAMES)]
    OpacityOptimizationRenderer(scene, traj.num_lines, traj.max_points, s_oit).render(
        oo_cams[0])  # warm-up
    torch.cuda.synchronize()
    oo_r = OpacityOptimizationRenderer(scene, traj.num_lines, traj.max_points, s_oit, oo_set)
    reset_launches()
    frame_ev = [_events() for _ in oo_cams]
    imgs_sum = torch.zeros((), device=dev)
    k_vo = []
    for (a, b), cam in zip(frame_ev, oo_cams):
        a.record()
        img = oo_r.render(cam)
        b.record()
        imgs_sum += img.sum()
        k_vo.append(oo_r.vertex_opacity.clone())
    torch.cuda.synchronize()
    oo_launches = expect_launches({"capsule_mlab": 2 * OO_FRAMES})["capsule_mlab"]
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite opacity-optimization frame on the main path")
    k_oo_img = img
    oo_frame_ms = [a.elapsed_time(b) for a, b in frame_ev]

    # The same frames on the plain path: every K-buffer call on its plain
    # version; the vertex opacities must be equal frame by frame.
    plain_oo = OpacityOptimizationRenderer(scene, traj.num_lines, traj.max_points, s_oit,
                                           oo_set)
    oit_module.rasterize_capsules_mlab = rasterize_capsules_mlab_reference
    oo_module.rasterize_capsules_mlab = rasterize_capsules_mlab_reference
    try:
        vo_equal = True
        for cam, kv in zip(oo_cams, k_vo):
            p_oo_img = plain_oo.render(cam)
            vo_equal = vo_equal and bool(torch.equal(plain_oo.vertex_opacity, kv))
    finally:
        oit_module.rasterize_capsules_mlab = rasterize_capsules_mlab
        oo_module.rasterize_capsules_mlab = rasterize_capsules_mlab
    oo_ssim, oo_mad, _ = images_agree("opacity optimization", k_oo_img, p_oo_img)

    # Stage breakdown of the same frames: the half-res prep and binning, the
    # gather kernel, the plain solve, the final render.
    s2 = gather_settings(s_oit, oo_set)

    def gather_inputs(csr2, params2):
        """`gather_importance`'s K-buffer arguments on a prepared half-res frame."""
        return (csr2, params2, s2.width, s2.height, s2.tile_w, s2.tile_h, oo_set.gather_k,
                s2.tf_color, s2.tf_opacity)

    stage_ms = {"oo_prep_binning": [], "oo_gather": [], "oo_solve": [], "final_render": []}
    vo = torch.ones((traj.num_lines, traj.max_points), device=dev)
    for cam in oo_cams:
        camt = camera_tensors(cam, dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        csr2, params2, _ = prepare_capsule_frame(scene, *camt, s2)
        ev[1].record()
        depths, vals, _ = rasterize_capsules_mlab(*gather_inputs(csr2, params2),
                                                  store_mode="gather")
        nodes = (depths, vals[0], vals[1])
        ev[2].record()
        vo = solve_vertex_opacity(*nodes, vo, oo_set, traj.num_lines, traj.max_points,
                                  scene.num_segments)
        ev[3].record()
        final_render(scene, *camt, vo, s_oit, oo_set.render_k)
        ev[4].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stage_ms, zip(ev[:-1], ev[1:])):
            stage_ms[k].append(a.elapsed_time(b))

    # The gather kernel against its plain version on frame 0's half-res inputs.
    csr2, params2, _ = prepare_capsule_frame(scene, *camera_tensors(oo_cams[0], dev), s2)
    n_tiles2 = csr2.tile_start.shape[0]
    gather_args = gather_inputs(csr2, params2)
    work = torch.zeros(n_tiles2, dtype=torch.int32, device=dev)
    kg = rasterize_capsules_mlab(*gather_args, store_mode="gather", work=work)
    stats = {}
    p_work = torch.zeros_like(work)
    pg, g_plain_ms = timed_plain(lambda: rasterize_capsules_mlab_reference(
        *gather_args, store_mode="gather", stats=stats, work=p_work))
    g_err = max(float((a - b).abs().max()) for a, b in zip(kg, pg))
    g_equal = all(bool(torch.equal(a, b)) for a, b in zip(kg, pg))
    g_ms = _time_ms(lambda: rasterize_capsules_mlab(*gather_args, store_mode="gather"), 20)
    g_pairs = int(csr2.tile_count.sum())
    g_evaluated, g_k_evaluated = int(p_work.sum()), int(work.sum())
    half_px = s2.width * s2.height
    K_g = oo_set.gather_k
    oo_line = {
        "frame_ms_median": float(np.median(oo_frame_ms)),
        "fps": 1000.0 / float(np.median(oo_frame_ms)),
        "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "launches_per_frame": {"capsule_mlab": 2},
        "gather_size": [s2.width, s2.height], "gather_pairs": g_pairs,
        "gather_evaluated": g_evaluated, "gather_kernel_evaluated": g_k_evaluated,
        "half_res_pixels_with_nodes": int((kg[0][0] < 1.5).sum()) / half_px,
        "half_res_pixels_with_K_nodes": int((kg[0][K_g - 1] < 1.5).sum()) / half_px,
        "gather_nodes": int((kg[0] < 1.5).sum()),
        # Nodes holding a tie window's averaged id (a joint's cap and the next
        # segment's body): the solve truncates i + 0.5 to i, as JAX does.
        "gather_nodes_with_half_ids": int(((kg[1][1] % 1 != 0) & (kg[0] < 1.5)).sum()),
        "vertex_opacity_min_mean": [float(k_vo[-1].min()), float(k_vo[-1].mean())],
        "foreground_share": float((k_oo_img[3] > 0).float().mean()),
        "frames": OO_FRAMES, "width": W, "height": H, "gpu": gpu,
    }
    print("opacity optimization frame: " + json.dumps(oo_line), flush=True)
    print(f"capsule_mlab:gather vs plain (frame 0, {s2.width}x{s2.height}): pairs {g_pairs}, "
          f"evaluated {g_evaluated}, hits {stats['hits']}, sweeps {stats['sweeps']}, members "
          f"{stats['members']}, equal {g_equal} (max |diff| {g_err:.3g}), kernel {g_ms:.3f} ms, "
          f"plain {g_plain_ms:.1f} ms; vertex opacities equal to the plain path's on every "
          f"frame {vo_equal}; final frame ssim {oo_ssim:.6f}, mean abs {oo_mad:.3g}", flush=True)
    if not g_equal:
        raise RuntimeError("the gather kernel differs from its plain version")
    if not vo_equal:
        raise RuntimeError("the vertex opacities differ from the plain path's")
    if oo_line["foreground_share"] < 0.01 or oo_line["half_res_pixels_with_nodes"] < 0.01:
        raise RuntimeError("the opacity-optimization frames are almost empty")
    ops = (stats["members"] * GATHER_OPS_PER_MEMBER
           + stats["sweeps"] * (MLAB_OPS_PER_SWEEP + MLAB_OPS_PER_SWEEP_NODE * K_g))
    new_kernels.append(oit_entry(
        "capsule_mlab:gather", "raster_capsule_oit.cu", oo_launches // 2, g_err, g_ms,
        g_plain_ms, n_tiles2, K_g, stats, ops, P=s2.tile_w * s2.tile_h, pairs=g_pairs,
        hits=stats["hits"],
        kernel_evaluated=g_k_evaluated,
        sweeps=stats["sweeps"], members=stats["members"], equal=g_equal,
        shape=[s2.width, s2.height]))

    # 10f. use_bands (diffuse exponent 1.0) against the plain version at
    # 480x272 in the modes that shade: per fragment (an exact pass behind a
    # peel depth), the composite, 'wboit' and 'mboit_resolve'. No path of
    # the port passes it (the JAX package's neither): no main-path launches.
    csr_s, params_s = prepare_mlab_frame(scene, *cam_small, s_small, OIT_OPACITY)
    sargs = (csr_s, params_s, sw, sh_, 16, 8)
    d1, _, _ = rasterize_capsules_mlab(*sargs, 8, s_small.tf_color, s_small.tf_opacity,
                                       no_overflow=True, use_bands=True)
    peel_s = torch.where(d1 < 1.5, d1, -1.0).amax(dim=0).contiguous()
    csr_w, params_w, _ = prepare_capsule_frame(scene, *cam_small, s_small)
    params_w[14] = OIT_OPACITY
    csr_m, params_mb, _ = prepare_mboit_frame(scene, *cam_small, s_small, 4, OIT_OPACITY)
    gen_d, gen_rgb, _ = rasterize_capsules_mlab(csr_m, params_mb, sw, sh_, 16, 8, 2,
                                                s_small.tf_color, s_small.tf_opacity,
                                                store_mode="mboit_gen", n_mom=4)
    moments_s = torch.stack([gen_d[0], gen_rgb[0, 0], gen_rgb[1, 0], gen_d[1], gen_rgb[0, 1]])
    kept_s = moments_s[0] >= MBOIT_DISCARD_B0
    frags_s = rasterize_capsules_mlab(csr_m, params_mb, sw, sh_, 16, 8, 1, s_small.tf_color,
                                      s_small.tf_opacity, store_mode="count")[0][0]
    band_cases = {
        "shade_peel": ((csr_s, params_s), 8, dict(peel=peel_s, no_overflow=True)),
        "composite": ((csr_s, params_s), 8, dict(deferred_shade=True, composite=True)),
        "wboit": ((csr_w, params_w), 1, dict(store_mode="wboit")),
        "mboit_resolve": ((csr_m, params_mb), 1, dict(store_mode="mboit_resolve", n_mom=4,
                                                      moments=moments_s)),
    }
    band_figures = {}
    for key, ((c, p), K_b, kw) in band_cases.items():
        args = (c, p, sw, sh_, 16, 8, K_b, s_small.tf_color, s_small.tf_opacity)
        accum = "store_mode" in kw
        before = (rasterize_capsules_mlab.launches, rasterize_capsules_accum.launches)
        k = rasterize_capsules_mlab(*args, use_bands=True, **kw)
        if (rasterize_capsules_mlab.launches - before[0],
                rasterize_capsules_accum.launches - before[1]) != ((0, 1) if accum else (1, 0)):
            raise RuntimeError(f"use_bands {key} did not launch its kernel once")
        stats = {}
        p_out, p_ms = timed_plain(lambda: rasterize_capsules_mlab_reference(
            *args, use_bands=True, stats=stats, **kw))
        k17 = rasterize_capsules_mlab(*args, **kw)
        if key == "composite":
            kp, pp, k17p = k, p_out, k17
            agree = float(((kp - pp).abs().amax(dim=0) <= 1e-4).float().mean())
        else:
            kp, pp, k17p = planes(k), planes(p_out), planes(k17)
            if key == "wboit":
                agree = share_within(kp, pp, pp[4].abs() + 1e-30, 1e-5)
            elif key == "mboit_resolve":
                agree = share_within(kp, pp, 1.0, 1e-4)
            else:
                d_err = (k[0] - p_out[0]).abs().amax(dim=0)
                c_err = torch.maximum((k[1] - p_out[1]).abs().amax(dim=(0, 1)),
                                      (k[2] - p_out[2]).abs().amax(dim=0))
                agree = float(((d_err <= 1e-5) & (c_err <= 1e-4)).float().mean())
        max_err = float((kp - pp).abs().max())
        moved = float((kp - k17p).abs().max())
        ms = _time_ms(lambda: rasterize_capsules_mlab(*args, use_bands=True, **kw), 10)
        pairs = int(c.tile_count.sum())
        if accum:
            ops = stats["hits"] * (
                MLAB_OPS_PER_MEMBER + OIT_OPS_PER_SHADE_BANDS + OIT_OPS_PER_ACCUM[kw["store_mode"]])
            if key == "mboit_resolve":  # the transmittance at kept pixels only, as at 1080p
                ops += (int(kept_s.sum()) * OIT_OPS_RESOLVE_PIXEL - (
                    stats["hits"] - int(frags_s[kept_s].sum())) * (OIT_OPS_PER_ACCUM[key] - 8))
        else:
            shade = OIT_OPS_PER_SHADE_BANDS if key == "shade_peel" else 0
            ops = (stats["hits"] * (OIT_OPS_PER_PEEL if key == "shade_peel" else 0)
                   + stats["members"] * (MLAB_OPS_PER_MEMBER + shade)
                   + stats["sweeps"] * (MLAB_OPS_PER_SWEEP + MLAB_OPS_PER_SWEEP_NODE * 8))
        band_figures[key] = {"agree": agree, "max_abs_err": max_err,
                             "moved_by_the_exponent": moved, "ms": ms, "plain_ms": p_ms}
        if agree < 0.999 or moved < 1e-4:
            raise RuntimeError(f"use_bands {key}: the kernel disagrees with its plain version, "
                               "or the exponent changes nothing")
        # Not a kernel of its own and on no main path: its figures go under
        # `use_bands` in the row of the kernel mode it modifies.
        parent = f"capsule_accum:{key}" if accum else "capsule_mlab"
        entry_ = oit_entry(
            f"use_bands {key}", "raster_capsule_accum.cu" if accum else "raster_capsule_oit.cu",
            0, max_err, ms, p_ms, c.tile_start.shape[0], K_b, stats, ops,
            extra_in_planes={"shade_peel": 1, "mboit_resolve": 5}.get(key, 0),
            out_planes=4 if key == "composite" else None, pairs=pairs, agree=agree,
            shape=[sw, sh_])
        row = next(r for r in kernels + new_kernels if r["name"] == parent)
        for k_ in ("name", "route", "source", "replaces", "launches"):
            del entry_[k_]
        row.setdefault("use_bands", {})[key] = entry_
    print(f"use_bands vs plain ({sw}x{sh_}): " + json.dumps(band_figures), flush=True)

    # Small frames on the card against the CPU: the opacity-optimization
    # entry, and every mode the port's registry draws, by name.
    card_vs_cpu(entry_opacity_optimization, "entry_opacity_optimization")
    pos_l, mask_l, attrs_l = _small_lines()
    small_traj = Trajectories(positions=pos_l, attributes=attrs_l[:, None, :], mask=mask_l,
                              num_points=mask_l.sum(axis=1).astype(np.int32),
                              attribute_names=["t"])
    small_cam = Camera(position=(0.0, 0.3, 1.2), width=256, height=128)
    registry_check = {}
    modes = [(m, {}) for m in RENDERING_MODE_ALL if m not in UNPORTED_MODES]
    modes += [("Opaque", {"tubeGeometry": "prism"}), ("Opaque", {"tubeGeometry": "triangle"}),
              ("Vulkan Ray Tracer", {"use_mlat": True}),
              ("Deferred Opaque", {"upscaling_factor": 2})]
    # The scattering modes draw a LineDataScattering: a small cloud traced
    # once on the CPU, shared by both devices.
    from linevis_tpu_torch.entry import scattering_line_data

    small_scatter = scattering_line_data("cpu", n=32, blobs=12, trace=dict(
        res_x=8, res_y=8, samples_per_pixel=4, max_events=64))
    scattering_modes = ("Line Density Map Renderer", "Spherical Heat Map Renderer",
                        "Volumetric Path Tracer")
    for mode, mode_settings in modes:
        if mode == "Opaque (Triangle Mesh)":
            ld = sphere_mesh_data(4)  # a surface: 5120 triangles from an STL
        elif mode in scattering_modes:
            ld = small_scatter
        else:
            ld = LineData(small_traj)
            ld.set_line_width(0.04)
        out = {}
        for d in (dev, "cpu"):
            r = create_renderer(mode, SettingsMap(mode_settings), device=d)
            # Deferred Opaque takes its factor after creation (as the JAX
            # renderer does); a second call changes no other mode.
            r.set_new_settings(SettingsMap(mode_settings))
            r.set_line_data(ld)
            # RTAO draws jax.random's samples on each device, the same rays:
            # held at the image bars after 2 accumulated frames.
            for _ in range(2 if mode == "RTAO" else 1):
                out[str(d)] = r.render(small_cam)
        g_img, c_img = out[str(dev)], out["cpu"]
        s_, mad = ssim(g_img[..., :3], c_img[..., :3]), float(np.abs(g_img - c_img).mean())
        label = " ".join([mode, *(v if isinstance(v, str) else f"{k}={v}"
                                  for k, v in mode_settings.items())])
        registry_check[label] = [s_, mad]
        agree = s_ >= 0.999 and mad <= 2e-3
        if mode == "Volumetric Path Tracer":
            # Identical keys: the same paths up to the devices' float rounding,
            # held pixel by pixel as every mode is, and by the reference's
            # criterion, the image mean.
            mean_diff = float(abs(g_img[..., :3].mean() - c_img[..., :3].mean()))
            registry_check[label].append(mean_diff)
            agree = agree and mean_diff <= 2e-3
        if not np.isfinite(g_img).all() or not agree:
            raise RuntimeError(f"registry mode {label!r}: the card frame disagrees with the CPU's")
    print("registry modes card vs cpu (ssim, mean abs; RTAO: after 2 accumulated frames; "
          "the path tracer: and the image mean difference): "
          + json.dumps(registry_check), flush=True)
    kernels.extend(new_kernels)

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
    prism_launches = expect_launches({"prism_raster": N_FRAMES})["prism_raster"]
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
    per_tile = csr.tile_count.double()
    prism_per_tile = {"candidates_per_tile_max": int(csr.tile_count.max()),
                      "candidates_per_tile_p99": float(per_tile.quantile(0.99))}
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
          f"foreground {fg:.4f}, candidates per tile max "
          f"{prism_per_tile['candidates_per_tile_max']}, p99 "
          f"{prism_per_tile['candidates_per_tile_p99']:.1f}", flush=True)
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
    n_evals, n_out = prism_out_early(csr, params, W, H, 32, 16, PRISM_SIDES)
    ops = (n_evals - n_out) * PRISM_OPS_PER_EVAL + n_out * PRISM_OPS_PER_OUT
    t_ops = ops / H100_FP32_FLOPS * 1e3
    print(f"prism evaluations out after the ring planes and {PRISM_SIDES // 2} sides: "
          f"{n_out} of {n_evals} ({n_out / max(n_evals, 1):.4f})", flush=True)
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
        "pixel_evaluations": n_evals,
        "pixel_evaluations_out_early": n_out,
        **prism_per_tile,
        "instances": resources["raster_prism"],
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
    tri_launches = expect_launches({"triangle_raster": N_FRAMES})["triangle_raster"]
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

    k_out, p_out, tri_fig = b3_check(csr, 32, 16)
    tri_id_agree = float((k_out[1] == p_out[1]).float().mean())
    tri_img = tri_shade(csr, k_out, batch, cams[0]).permute(1, 2, 0).cpu().numpy()
    img_p_np = tri_shade(csr, p_out, batch, cams[0]).permute(1, 2, 0).cpu().numpy()
    img_ssim = ssim(tri_img[..., :3], img_p_np[..., :3])
    img_mad = float(np.abs(tri_img - img_p_np).mean())
    fg = float((k_out[1] >= 0).float().mean())
    tri_ids_equal = bool(torch.equal(k_out[1], p_out[1]))
    tri_depth_equal = bool(torch.equal(k_out[0], p_out[0]))
    print(f"triangle_raster vs plain: pairs {tri_pairs}, chunks {tri_chunks}, evaluated "
          f"after early-z {tri_fig['chunks_evaluated']} chunks / {tri_fig['evaluated']} pairs, "
          f"updates {tri_fig['updates']}, ids equal {tri_ids_equal} ({tri_id_agree:.6f}), depth "
          f"equal {tri_depth_equal}, every output equal {tri_fig['equal']}, max |dz, dplanes| "
          f"{tri_fig['max_abs_err']:.3g}, image ssim {img_ssim:.6f}, mean abs {img_mad:.3g}, "
          f"foreground {fg:.4f}, chunks per tile p50 {tri_fig['chunks_per_tile_p50']:.1f}, p99 "
          f"{tri_fig['chunks_per_tile_p99']:.1f}, max {tri_fig['chunks_per_tile_max']}", flush=True)
    if not np.isfinite(tri_img).all():
        raise RuntimeError("non-finite pixels in the 1080p triangle frame")
    if not (tri_ids_equal and tri_depth_equal) or tri_fig["max_abs_err"] > 1e-5:
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

    kernels.append({
        "name": "triangle_raster",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/raster_triangle.cu",
        "replaces": "linevis_tpu/kernels/raster_pallas.py:427",
        "launches": tri_launches,
        **tri_fig,
        "id_agree": tri_id_agree,
        "prism_vs_triangle_ssim": parity_ssim,
        "prism_only_pixels": prism_only,
        "triangle_only_pixels": tri_only,
        "instances": resources["raster_triangle"],
    })
    del mesh, batch, csr, k_out, p_out, real
    torch.cuda.empty_cache()

    def stage_sums(marks):
        """{stage: ms} summed over consecutive (stage, event) marks."""
        out = {}
        for (_, a), (name, b) in zip(marks[:-1], marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out

    # 15. The RTAO path: RTAO_FRAMES frames through render_tubes_rtao, the
    # grid built once. B1 runs once per frame, B5 once per batch of rays.
    rt = RtaoSettings()
    t0 = time.perf_counter()
    grid = tornado_segment_grid(scene, rt.grid_resolution)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    n_ao_rays = rt.num_samples * W * H
    batches = ray_batches(n_ao_rays, rt.rays_per_batch)
    rcams = cams[:RTAO_FRAMES]
    render_tubes_rtao(scene, *rcams[0], settings, rt, frame=0, grid=grid)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ev = [_events() for _ in rcams]
    imgs_sum = torch.zeros((), device=dev)
    for i, ((a, b), cam) in enumerate(zip(frame_ev, rcams)):
        a.record()
        img = render_tubes_rtao(scene, *cam, settings, rt, frame=i, grid=grid)
        b.record()
        imgs_sum += img[:3].sum()
    torch.cuda.synchronize()
    rtao_launches = expect_launches({
        "capsule_raster": RTAO_FRAMES, "ao_grid": RTAO_FRAMES * len(batches),
        "threefry_uniform": 2 * RTAO_FRAMES,
    })
    rtao_peak_bytes = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite RTAO frame on the main path")
    rtao_frame_ms = [a.elapsed_time(b) for a, b in frame_ev]

    def rtao_staged(cam, frame, on_batch=None):
        """One RTAO frame step by step -> (image, AO map, stage marks)."""
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name):
            marks.append((name, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

        gbuf = rtao_gbuffer(scene, *cam, settings)
        mark("gbuffer")
        u1, u2 = hemisphere_uniforms(threefry.prng_key(rt.seed + frame, dev),
                                     (rt.num_samples, H, W))
        mark("draw")
        o, d, t_max, valid = rtao_rays(gbuf, scene.radius, rt, u1, u2)
        mark("ray_setup")
        occ = []
        for s0, s1 in batches:
            pairs = ao_grid.expand_ray_pairs(o[:, s0:s1], d[:, s0:s1], t_max[s0:s1],
                                             valid[s0:s1], grid, rt.max_ray_cells)
            mark("pairs_sort")
            walked = None if on_batch is None else torch.zeros_like(pairs.seg_chunks)
            tests = None if on_batch is None else torch.zeros_like(pairs.seg_chunks)
            occ_pairs = ao_grid.trace_pairs(pairs.rays, pairs.seg_begin, pairs.seg_chunks,
                                            grid.records, grid.chunk, walked=walked,
                                            tests=tests)
            mark("ao_kernel")
            occ.append(ao_grid.scatter_occlusion(pairs, occ_pairs, s1 - s0, grid.resolution))
            mark("scatter_shade")
            if on_batch is not None:
                on_batch(pairs, occ_pairs, walked, tests)
        ao = 1.0 - torch.cat(occ).reshape(rt.num_samples, H, W).mean(dim=0)
        img = rtao_shade(gbuf, ao, settings)
        mark("scatter_shade")
        torch.cuda.synchronize()
        return img, ao, gbuf, marks

    stage_ms = {}
    for i, cam in enumerate(rcams):
        for k, v in stage_sums(rtao_staged(cam, i)[3]).items():
            stage_ms.setdefault(k, []).append(v)

    # Frame 0 once more, counting what the data needed, and keeping the
    # first batch's inputs for the comparison with the plain version.
    ao_counts = {"kept_pairs": 0, "pair_chunks": 0, "active_pair_chunks": 0,
                 "record_chunks_assigned": 0, "record_chunks_walked": 0,
                 "slot_ray_tests_needed": 0}
    first_batch = []
    G3 = grid.resolution ** 3

    def count_batch(pairs, occ_pairs, walked, tests):
        ao_counts["kept_pairs"] += int((pairs.keys < G3).sum())
        ao_counts["pair_chunks"] += pairs.seg_chunks.shape[0]
        ao_counts["active_pair_chunks"] += int((pairs.seg_chunks > 0).sum())
        ao_counts["record_chunks_assigned"] += int(pairs.seg_chunks.sum())
        ao_counts["record_chunks_walked"] += int(walked.sum())
        ao_counts["slot_ray_tests_needed"] += int(tests.sum())
        if not first_batch:
            first_batch.extend([pairs, occ_pairs, walked, tests])

    img_staged, ao_map, gbuf, _ = rtao_staged(rcams[0], 0, count_batch)
    img_main = render_tubes_rtao(scene, *rcams[0], settings, rt, frame=0, grid=grid)
    if not torch.equal(img_staged, img_main):
        raise RuntimeError("the staged RTAO frame differs from render_tubes_rtao's")
    # The capsule kernel's instance without AA, as the G-buffer launches it,
    # against its plain version bit for bit on frame 0's binning.
    csr_g, params_g, _ = prepare_capsule_frame(scene, *rcams[0], settings)
    g_args = (csr_g, params_g, W, H, settings.tile_w, settings.tile_h)
    k_gout = rasterize_capsules(*g_args, use_aa=False)
    p_gout = rasterize_capsules_reference(*g_args, use_aa=False)
    g_no_aa_equal = all(bool(torch.equal(a, b)) for a, b in zip(
        [k_gout[0], k_gout[1], *k_gout[2]], [p_gout[0], p_gout[1], *p_gout[2]]))
    g_fg = float((k_gout[1] >= 0).float().mean())
    print(f"capsule_raster without AA (RTAO G-buffer, frame 0) vs plain: pairs "
          f"{int(csr_g.tile_count.sum())}, equal {g_no_aa_equal}, foreground {g_fg:.4f}",
          flush=True)
    if not g_no_aa_equal:
        raise RuntimeError("capsule kernel without AA differs from its plain version")
    next(k for k in kernels if k["name"] == "capsule_raster")["equal_no_aa"] = g_no_aa_equal
    del csr_g, params_g, k_gout, p_gout
    rtao_fg = float(gbuf.fg.float().mean())
    ao_fg_mean = float(ao_map[gbuf.fg].mean())
    if rtao_fg < 0.01 or not 0.05 < ao_fg_mean < 0.999:
        raise RuntimeError(f"RTAO frame: foreground {rtao_fg}, mean AO there {ao_fg_mean}")
    med = float(np.median(rtao_frame_ms))
    rtao_line = {
        "frame_ms_median": med, "fps": 1000.0 / med,
        "mrays_per_s": n_ao_rays / med / 1e3,
        "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "rays": n_ao_rays, "batches": len(batches), **ao_counts,
        "record_chunks_skipped_by_saturation":
            ao_counts["record_chunks_assigned"] - ao_counts["record_chunks_walked"],
        "launches_per_frame": {k: v // RTAO_FRAMES for k, v in rtao_launches.items() if v},
        "foreground_share": rtao_fg, "mean_ao_on_foreground": ao_fg_mean,
        "grid_build_s": grid_s, "grid_records": int(grid.cell_count.sum()),
        "peak_memory_bytes": rtao_peak_bytes,
        "frames": RTAO_FRAMES, "width": W, "height": H, "gpu": gpu,
    }
    print("rtao frame: " + json.dumps(rtao_line), flush=True)

    # 16. The AO kernel vs its plain version on the first batch of frame 0.
    pairs, k_occ, k_walked, k_tests = first_batch
    p_walked, p_tests = torch.zeros_like(k_walked), torch.zeros_like(k_tests)
    a, b = _events()
    a.record()
    p_occ = ao_grid.trace_pairs_reference(pairs.rays, pairs.seg_begin, pairs.seg_chunks,
                                          grid.records, grid.chunk, walked=p_walked,
                                          tests=p_tests)
    b.record()
    torch.cuda.synchronize()
    ao_plain_ms = a.elapsed_time(b)
    ao_differ = int((k_occ != p_occ).sum())
    # The bound is the work of the plain version; the kernel's own counts
    # stand beside it.
    ao_walked_batch, ao_k_walked = int(p_walked.sum()), int(k_walked.sum())
    ao_tests_batch, ao_k_tests = int(p_tests.sum()), int(k_tests.sum())
    ao_counts_equal = torch.equal(k_walked, p_walked) and torch.equal(k_tests, p_tests)
    ao_active = int((pairs.seg_chunks > 0).sum())
    print(f"ao_grid vs plain (batch 0 of frame 0): pairs {k_occ.numel()}, occluded "
          f"{int(k_occ.sum())}, pairs that differ {ao_differ}, walked and test counts equal "
          f"{ao_counts_equal}, pair chunks {pairs.seg_chunks.shape[0]} "
          f"({ao_active} active), record chunks walked {ao_walked_batch}, longest walk "
          f"{int(p_walked.max())}, (slot, ray) tests needed {ao_tests_batch} of "
          f"{ao_walked_batch * 128 * 128} staged (kernel: walked {ao_k_walked}, tests "
          f"{ao_k_tests})", flush=True)
    if ao_differ or not ao_counts_equal:
        raise RuntimeError("AO kernel disagrees with its plain version")
    # The roots those tests need: the bound charges a root's operations only
    # where its discriminant is not negative.
    ao_replayed_tests, ao_roots = ao_root_tests(pairs, grid.records, grid.chunk)
    print(f"ao_grid bound: tests {ao_replayed_tests} with non-negative discriminants "
          f"(body, cap a, cap b) {ao_roots}", flush=True)
    if ao_replayed_tests != ao_tests_batch:
        raise RuntimeError("the replayed AO walk counts other tests than the plain version")
    if int(k_occ.sum()) < 1000:
        raise RuntimeError("the AO trace found almost no occlusion")
    card_vs_cpu(entry_rtao, "entry_rtao")

    # The registry's RTAO mode on the same tornado at 1080p: its first frame
    # equals render_tubes_rtao's frame 0 (the samples drawn on the card from
    # the same seed), and its accumulating frames launch what the path does.
    ld_t = LineData(traj)
    ld_t.set_line_width(2.0 * TORNADO_RADIUS)
    reg = create_renderer("RTAO", device=dev)
    reg.set_line_data(ld_t)
    reg_cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H).orbit(0.002, 0.1, 1.2)
    reg_img = reg.render(reg_cam)  # builds the scene and the grid
    want = render_tubes_rtao(ld_t.get_capsule_scene(device=dev), *camera_tensors(reg_cam, dev),
                             reg._raster_settings(reg_cam), rt, frame=0, grid=reg._grid)
    reg_equal = np.array_equal(reg_img, want.permute(1, 2, 0).cpu().numpy())
    # Each registry frame is followed by the path's frame on the same host
    # clock, its image copied to the host as the registry hands its image
    # back: both launch B1 once and B5 once per batch.
    reg_scene, reg_camt = ld_t.get_capsule_scene(device=dev), camera_tensors(reg_cam, dev)
    torch.cuda.synchronize()
    reset_launches()
    reg_ms, copy_ms = [], []
    for i in range(RTAO_FRAMES):
        t0 = time.perf_counter()
        reg_img = reg.render(reg_cam)
        t1 = time.perf_counter()
        render_tubes_rtao(reg_scene, *reg_camt, reg._raster_settings(reg_cam), rt, frame=i,
                          grid=reg._grid).cpu()
        t2 = time.perf_counter()
        reg_ms.append((t1 - t0) * 1e3)
        copy_ms.append((t2 - t1) * 1e3)
    expect_launches({"capsule_raster": 2 * RTAO_FRAMES,
                     "ao_grid": 2 * RTAO_FRAMES * len(batches),
                     "threefry_uniform": 4 * RTAO_FRAMES})
    print("rtao registry frame: " + json.dumps({
        "frame_ms_median": float(np.median(reg_ms)),
        "path_frame_ms_median": rtao_line["frame_ms_median"],
        "path_frame_copied_to_host_ms_median": float(np.median(copy_ms)),
        "first_frame_equals_the_path": reg_equal, "frames": RTAO_FRAMES,
        "timed": "host clock, render() to the numpy image", "width": W, "height": H,
        "gpu": gpu}), flush=True)
    if not reg_equal or not np.isfinite(reg_img).all():
        raise RuntimeError("the registry's RTAO frame differs from render_tubes_rtao's")

    # R6 on frame 0's two draws (2 x num_samples x H x W uniforms, each a
    # launch on the frame's key with the split derived in the kernel) against
    # its plain version, ops/threefry.py:uniform of the split key, bit for bit.
    r6_key = threefry.prng_key(rt.seed, dev)
    r6_shape = (rt.num_samples, H, W)
    r6_equal, r6_err = True, 0.0
    for j in (0, 1):
        got_u = threefry_uniform(r6_key, r6_shape, split=j)
        want_u = threefry.uniform(threefry.split_at(r6_key, j), r6_shape)
        r6_equal = r6_equal and bool(torch.equal(got_u, want_u))
        r6_err = max(r6_err, float((got_u - want_u).abs().max()))
    del got_u, want_u
    r6_n = 2 * rt.num_samples * H * W
    r6_ms = _time_ms(lambda: threefry_uniform(r6_key, r6_shape, split=0), 20)
    r6_plain_ms = _time_ms(
        lambda: threefry.uniform(threefry.split_at(r6_key, 0), r6_shape), 3)
    r6_bytes_ms = r6_n // 2 * 4 / H100_HBM_BYTES * 1e3
    r6_ops_ms = ops_ms(*(r6_n // 2 * n for n in R6_OPS_PER_UNIFORM), int32_ops_per_s())
    print(f"threefry_uniform vs plain (frame 0's draws): {r6_n} uniforms, equal {r6_equal}, "
          f"{r6_ms:.4f} ms a launch of {r6_n // 2}, plain {r6_plain_ms:.3f} ms", flush=True)
    if not r6_equal:
        raise RuntimeError("threefry_uniform differs from ops/threefry.py:uniform")
    kernels.append({
        "name": "threefry_uniform",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/threefry_uniform.cu",
        "replaces": "linevis_tpu/render/rtao.py:62",
        "launches": rtao_launches["threefry_uniform"],
        "max_abs_err": r6_err,
        "ms": r6_ms,
        "plain_ms": r6_plain_ms,
        "bound_ms": max(r6_bytes_ms, r6_ops_ms),
        "bound_by": "operations" if r6_ops_ms >= r6_bytes_ms else "bytes",
        "bytes_ms": r6_bytes_ms,
        "operations_ms": r6_ops_ms,
        "library_ms": None,
        "uniforms_per_launch": r6_n // 2,
        "uniforms_held_bit_for_bit": r6_n,
    })

    ao_ms = _time_ms(lambda: ao_grid.trace_pairs(
        pairs.rays, pairs.seg_begin, pairs.seg_chunks, grid.records, grid.chunk), 5)
    # The same launch with every pair chunk empty: what the launch costs
    # without a walk.
    no_walk = torch.zeros_like(pairs.seg_chunks)
    ao_empty_ms = _time_ms(lambda: ao_grid.trace_pairs(
        pairs.rays, pairs.seg_begin, no_walk, grid.records, grid.chunk), 5)
    C = grid.chunk
    in_bytes = (ao_active * 7 * C * 4 + 2 * pairs.seg_chunks.shape[0] * 4
                + min(ao_walked_batch * 8 * C, grid.records.numel()) * 4)
    out_bytes = k_occ.numel() * 4
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = (ao_tests_batch * AO_OPS_PER_TEST
             + sum(n * o for n, o in zip(ao_roots, AO_OPS_PER_ROOT))) / H100_FP32_FLOPS * 1e3
    kernels.append({
        "name": "ao_grid",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/ao_grid.cu",
        "replaces": "linevis_tpu/kernels/ao_grid.py:157",
        "launches": rtao_launches["ao_grid"],
        "max_abs_err": float((k_occ - p_occ).abs().max()),
        "ms": ao_ms,
        "plain_ms": ao_plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": in_bytes + out_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "pairs_differ": ao_differ,
        "pairs": k_occ.numel(),
        "active_pair_chunks": ao_active,
        "record_chunks_walked": ao_walked_batch,
        "slot_ray_tests_needed": ao_tests_batch,
        "tests_with_roots": dict(zip(("body", "cap_a", "cap_b"), ao_roots)),
        "kernel_record_chunks_walked": ao_k_walked,
        "kernel_slot_ray_tests": ao_k_tests,
        "all_empty_ms": ao_empty_ms,
        "longest_walk": int(p_walked.max()),
        "capsule_raster_launches": rtao_launches["capsule_raster"],
    })
    del first_batch, pairs, k_occ, p_occ, gbuf, grid
    torch.cuda.empty_cache()

    # 17. The wavefront path: WF_FRAMES frames through
    # render_tubes_raytraced_wavefront, the tree built once on the host.
    groups, wf_setup = tornado_wide_bvh(scene, builder=WF_BUILDER)
    n_groups = groups.shape[0] // 8
    s_wf = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    wcams = cams[:WF_FRAMES]

    def wf_frame(cam):
        return render_tubes_raytraced_wavefront(
            scene, *cam, s_wf, K=WF_K, opacity=WF_OPACITY, wide_groups=groups
        )

    wf_frame(wcams[0])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    frame_ev = [_events() for _ in wcams]
    imgs_sum = torch.zeros((), device=dev)
    for (a, b), cam in zip(frame_ev, wcams):
        a.record()
        img = wf_frame(cam)
        b.record()
        imgs_sum += img.sum()
    torch.cuda.synchronize()
    wf_launches = expect_launches({"bvh_wavefront": WF_FRAMES})["bvh_wavefront"]
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite wavefront frame on the main path")
    wf_frame_ms = [a.elapsed_time(b) for a, b in frame_ev]

    def wf_kernel(rays, ab, **kw):
        return trace_wavefront_kbuffer(groups, rays, ab, K=WF_K, opacity=WF_OPACITY,
                                       tf_opacity=s_wf.tf_opacity, **kw)

    stage_ms = {}
    for cam in wcams:
        marks = [(n, torch.cuda.Event(enable_timing=True)) for n in
                 ("start", "primary_rays", "kernel", "shade_blend_unpack")]
        marks[0][1].record()
        rays = primary_rays(cam[0], cam[1], s_wf, 1e6)
        marks[1][1].record()
        nodes = wf_kernel(rays, cam[2])
        marks[2][1].record()
        resolve_wavefront_nodes(scene, nodes, cam[0], cam[2], s_wf)
        marks[3][1].record()
        torch.cuda.synchronize()
        for k, v in stage_sums(marks).items():
            stage_ms.setdefault(k, []).append(v)

    # 18. The wavefront kernel vs its plain version on frame 0's rays and
    # tree, on every WF_COMPARE_EVERY-th ray block, bit for bit.
    cam = wcams[0]
    rays = primary_rays(cam[0], cam[1], s_wf, 1e6)
    n_blocks = rays.shape[1] // 128
    wf_stats = torch.zeros((n_blocks, len(WF_STATS)), dtype=torch.int64, device=dev)
    k_nodes = wf_kernel(rays, cam[2], stats=wf_stats)
    blocks = torch.arange(0, n_blocks, WF_COMPARE_EVERY, device=dev)
    p_stats = torch.zeros((blocks.numel(), len(WF_STATS)), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    p_nodes = trace_wavefront_kbuffer_reference(
        groups, rays, cam[2], K=WF_K, opacity=WF_OPACITY, tf_opacity=s_wf.tf_opacity,
        stats=p_stats, blocks=blocks,
    )
    torch.cuda.synchronize()
    wf_plain_ms = (time.perf_counter() - t0) * 1e3
    wf_equal = (torch.equal(k_nodes[0][:, blocks], p_nodes[0])
                and torch.equal(k_nodes[1][:, :, blocks], p_nodes[1])
                and torch.equal(k_nodes[2][:, blocks], p_nodes[2]))
    wf_stats_equal = bool(torch.equal(wf_stats[blocks], p_stats))
    wf_err = max(float((k_nodes[0][:, blocks] - p_nodes[0]).abs().max()),
                 float((k_nodes[1][:, :, blocks] - p_nodes[1]).abs().max()),
                 float((k_nodes[2][:, blocks] - p_nodes[2]).abs().max()))
    by = dict(zip(WF_STATS, wf_stats.sum(dim=0).tolist()))
    by["max_stack"] = int(wf_stats[:, 5].max())
    wf_img = resolve_wavefront_nodes(scene, k_nodes, cam[0], cam[2], s_wf)
    wf_img = wf_img.permute(1, 2, 0).cpu().numpy()
    wf_fg = float((wf_img[..., 3] > 0).mean())
    med = float(np.median(wf_frame_ms))
    wf_line = {
        "frame_ms_median": med, "fps": 1000.0 / med,
        "mrays_per_s": rays.shape[1] / med / 1e3,
        "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "rays": rays.shape[1], "ray_blocks": n_blocks, "builder": WF_BUILDER,
        "bvh_build_s": wf_setup["build_s"], "bvh_pack_s": wf_setup["pack_s"],
        "groups": n_groups, **{k + "_per_frame": v for k, v in by.items()},
        "visits_per_block_max": int(wf_stats[:, 0].max()),
        "visits_per_block_p50": float(wf_stats[:, 0].double().quantile(0.5)),
        "visits_per_block_p99": float(wf_stats[:, 0].double().quantile(0.99)),
        "foreground_share": wf_fg, "K": WF_K,
        "frames": WF_FRAMES, "width": W, "height": H, "gpu": gpu,
    }
    print("wavefront frame: " + json.dumps(wf_line), flush=True)
    print(f"bvh_wavefront vs plain (every {WF_COMPARE_EVERY}th of {n_blocks} ray blocks: "
          f"{blocks.numel()}): depths, features, alpha equal {wf_equal} (max |diff| "
          f"{wf_err:.3g}), per-block counts equal {wf_stats_equal}, plain "
          f"{wf_plain_ms:.0f} ms", flush=True)
    if not np.isfinite(wf_img).all() or wf_fg < 0.01:
        raise RuntimeError("the wavefront frame is non-finite or almost empty")
    if not (wf_equal and wf_stats_equal):
        raise RuntimeError("wavefront kernel disagrees with its plain version")
    if wf_setup["build_s"] + wf_setup["pack_s"] > 90.0:
        print(f"warning: the {WF_BUILDER} build and packing took more than 90 s", flush=True)
    card_vs_cpu(entry_wavefront, "entry_wavefront")

    # The wavefront frame against the two-sided MLAB frame of the same camera
    # (both composite entry and exit surfaces; they merge beyond K otherwise).
    ml_img = render_tubes_mlab(scene, *cam, s_oit, two_sided=True, **mlab_kw)
    ml_img = ml_img.permute(1, 2, 0).cpu().numpy()
    wf_ml_ssim = ssim(wf_img[..., :3], ml_img[..., :3])
    wf_ml_mad = float(np.abs(wf_img - ml_img).mean())
    print(f"wavefront vs two-sided MLAB frame (camera 0, on the card): ssim "
          f"{wf_ml_ssim:.6f}, mean abs {wf_ml_mad:.3g}", flush=True)
    if wf_ml_ssim < 0.9:
        raise RuntimeError("the wavefront frame does not look like the MLAB frame")

    wf_ms = _time_ms(lambda: wf_kernel(rays, cam[2]), 3)
    n_rays = rays.shape[1]
    # Of a packed row's 128 lanes the function needs the USED_LANES.
    in_bytes = n_groups * 8 * USED_LANES * 4 + rays.numel() * 4 + 2 * 4
    out_bytes = 5 * WF_K * n_rays * 4
    ops = (128 * (by["visits"] * WF_OPS_PER_VISIT + by["leaf_rows"] * WF_OPS_PER_LEAF_ROW)
           + by["members"] * WF_OPS_PER_MEMBER
           + by["sweeps"] * (WF_OPS_PER_SWEEP + WF_OPS_PER_SWEEP_NODE * WF_K))
    t_bytes = (in_bytes + out_bytes) / H100_HBM_BYTES * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    kernels.append({
        "name": "bvh_wavefront",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/bvh_wavefront.cu",
        "replaces": "linevis_tpu/kernels/bvh_wavefront.py:70",
        "launches": wf_launches,
        "max_abs_err": wf_err,
        "ms": wf_ms,
        "plain_ms": wf_plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": in_bytes + out_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "plain_ray_blocks": blocks.numel(),
        "ray_blocks": n_blocks,
        "groups": n_groups,
        **by,
        "wavefront_vs_mlab_two_sided_ssim": wf_ml_ssim,
        "instances": resources["bvh_wavefront"],
    })
    # 19. The repo's five reference configs (tests/baseline_scenes.py, six
    # images) through the port's registry at full size:
    # entry.BASELINE_CONFIGS on the card, each config's frames timed with its
    # launches counted; B2's composite at K=32 (config 2) and on the Femur
    # (config 4, also in bench.py's form with per-segment alpha rows) and
    # both MBOIT passes on the Femur (config 4b) against their plain
    # versions; each config at scale BASE_CHECK_SCALE, card against the CPU.
    t0 = time.perf_counter()
    ld_tornado = LineData(traj)
    ld_tornado.set_line_width(TORNADO_LINE_WIDTH)
    ld_conv = convection_line_data(dev)
    conv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ld_femur = femur_line_data()
    femur_s = time.perf_counter() - t0
    base_line_data = {
        "cfg1_tornado_opaque_800x600": ld_tornado, "cfg2_tornado_ppll_1080p": ld_tornado,
        "cfg3_convection_rtao_1080p": ld_conv, "cfg4_femur_mlab_1080p": ld_femur,
        "cfg4b_femur_mboit_1080p": ld_femur, "cfg5_tornado_opacityopt_1080p": ld_tornado,
    }
    rt_base = RtaoSettings()
    base_lines, base_runs = {}, {}
    for name, build in BASELINE_CONFIGS.items():
        ld = base_line_data[name]
        run = build(device=dev, frames=None if name.startswith("cfg3") else BASE_FRAMES,
                    line_data=ld)
        cams_b = run.cameras
        w_b, h_b = cams_b[0].width, cams_b[0].height
        per_frame = {
            "cfg1": {"capsule_raster": 1}, "cfg2": {"capsule_mlab": 1},
            "cfg3": {"capsule_raster": 1,
                     "ao_grid": len(ray_batches(rt_base.num_samples * w_b * h_b,
                                                rt_base.rays_per_batch)),
                     "threefry_uniform": 2},
            "cfg4": {"capsule_mlab": 1}, "cfg4b": {"capsule_accum": 2},
            "cfg5": {"capsule_mlab": 2},
        }[name.split("_")[0]]
        # Warm-up at a camera off the run's: builds the scene (and RTAO's
        # grid, the opacity solver's state) on the card.
        run.renderer.render(cams_b[0].orbit(0.5, 0.3, 1.3))
        torch.cuda.synchronize()
        reset_launches()
        ev_b, host_ms, img_b = [_events() for _ in cams_b], [], None
        for (a, b), cam in zip(ev_b, cams_b):
            t1 = time.perf_counter()
            a.record()
            img_b = run.renderer.render(cam)
            b.record()
            host_ms.append((time.perf_counter() - t1) * 1e3)
            if not np.isfinite(img_b).all():
                raise RuntimeError(f"{name}: non-finite frame")
        torch.cuda.synchronize()
        got = expect_launches({k: n * len(cams_b) for k, n in per_frame.items()})
        fg = float((np.abs(img_b[..., :3] - 1.0).max(-1) > 1e-3).mean())
        if fg < 0.01:
            raise RuntimeError(f"{name}: the frame is almost empty")
        scene_b = ld.get_capsule_scene(device=dev)
        med = float(np.median([a.elapsed_time(b) for a, b in ev_b]))
        base_lines[name] = {
            "frame_ms_median": med, "fps": 1000.0 / med,
            "host_frame_ms_median": float(np.median(host_ms)),
            "launches_per_frame": per_frame, "launches": got,
            "mode": run.renderer.name, "frames": len(cams_b), "width": w_b, "height": h_b,
            "segments": scene_b.num_segments, "valid_segments": int(scene_b.mask.sum()),
            "lines": ld.num_lines, "foreground_share": fg, "gpu": gpu,
        }
        base_runs[name] = run

    # Counts of frame 0 of each config: pairs, fragments, rays.
    def cam0(name):
        return base_runs[name].cameras[0]

    def reg_settings(name):
        return base_runs[name].renderer._raster_settings(cam0(name))

    c1 = cam0("cfg1_tornado_opaque_800x600")
    csr_b, _, _ = prepare_capsule_frame(ld_tornado.get_capsule_scene(device=dev),
                                        *camera_tensors(c1, dev),
                                        reg_settings("cfg1_tornado_opaque_800x600"),
                                        aa_margin=0.5)
    base_lines["cfg1_tornado_opaque_800x600"]["pairs"] = int(csr_b.tile_count.sum())
    c3 = cam0("cfg3_convection_rtao_1080p")
    csr_b, _, _ = prepare_capsule_frame(ld_conv.get_capsule_scene(device=dev),
                                        *camera_tensors(c3, dev),
                                        reg_settings("cfg3_convection_rtao_1080p"))
    base_lines["cfg3_convection_rtao_1080p"].update(
        pairs=int(csr_b.tile_count.sum()), rays=rt_base.num_samples * c3.width * c3.height,
        grid_records=int(base_runs["cfg3_convection_rtao_1080p"].renderer._grid.cell_count.sum()),
        trace_s=conv_s)
    base_lines["cfg4_femur_mlab_1080p"]["scene_s"] = femur_s

    # Config 2: B2's composite at K=32, newly on a main path.
    c2 = "cfg2_tornado_ppll_1080p"
    f_k32, _ = composite_gate("capsule_mlab:k32", ld_tornado.get_capsule_scene(device=dev),
                              camera_tensors(cam0(c2), dev), reg_settings(c2),
                              base_runs[c2].renderer.K, base_runs[c2].renderer.opacity,
                              base_lines[c2]["launches"]["capsule_mlab"], config=c2)
    base_lines[c2]["pairs"] = f_k32["pairs"]
    base_lines[c2]["fragments"] = f_k32["hits"]
    kernels.append(f_k32)

    # Config 4: the registry's MLAB composite on the Femur, and bench.py's
    # form of the same frame (alpha rows from the hierarchy opacities).
    c4, c4b = "cfg4_femur_mlab_1080p", "cfg4b_femur_mboit_1080p"
    femur_scene = ld_femur.get_capsule_scene(device=dev)
    s4 = reg_settings(c4)
    f_f4, _ = composite_gate("capsule_mlab:femur", femur_scene, camera_tensors(cam0(c4), dev),
                             s4, base_runs[c4].renderer.K, base_runs[c4].renderer.opacity,
                             base_lines[c4]["launches"]["capsule_mlab"], config=c4)
    base_lines[c4]["pairs"] = f_f4["pairs"]
    base_lines[c4]["fragments"] = f_f4["hits"]
    seg_alpha4 = torch.tensor(ld_femur.get_segment_opacity_rows(), device=dev)
    # bench.py's Femur frame: render_tubes_mlab with the alpha rows at its
    # camera, BASE_FRAMES orbit frames, launches counted.
    bench_cams = [camera_tensors(c, dev) for c in base_runs[c4].cameras]
    render_tubes_mlab(femur_scene, *bench_cams[0], s4, K=8, opacity=0.45, seg_alpha=seg_alpha4)
    torch.cuda.synchronize()
    reset_launches()
    ev_b = [_events() for _ in bench_cams]
    imgs_sum = torch.zeros((), device=dev)
    for (a, b), cam in zip(ev_b, bench_cams):
        a.record()
        img = render_tubes_mlab(femur_scene, *cam, s4, K=8, opacity=0.45, seg_alpha=seg_alpha4)
        b.record()
        imgs_sum += img.sum()
    torch.cuda.synchronize()
    bench_launches = expect_launches({"capsule_mlab": len(bench_cams)})["capsule_mlab"]
    if not bool(torch.isfinite(imgs_sum)):
        raise RuntimeError("non-finite frame of bench.py's Femur MLAB form")
    med = float(np.median([a.elapsed_time(b) for a, b in ev_b]))
    base_lines[c4]["bench_alpha_rows_frame_ms_median"] = med
    print("femur mlab bench.py form (render_tubes_mlab, seg_alpha rows, K=8, opacity 0.45): "
          + json.dumps({"frame_ms_median": med, "fps": 1000.0 / med, "frames": len(bench_cams),
                        "launches": bench_launches, "width": s4.width, "height": s4.height,
                        "gpu": gpu}), flush=True)
    f_f4["alpha_from_rows"], _ = composite_gate(
        "capsule_mlab:femur alpha_from_rows (bench.py)", femur_scene,
        camera_tensors(cam0(c4), dev), s4, 8, 0.45, bench_launches, seg_alpha=seg_alpha4)
    kernels.append(f_f4)

    # Config 4b: both MBOIT passes on the Femur, bit for bit.
    r4b = base_runs[c4b].renderer
    s4b = reg_settings(c4b)
    csr_m, params_m, _ = prepare_mboit_frame(femur_scene, *camera_tensors(cam0(c4b), dev), s4b,
                                             r4b.n_mom, r4b.opacity)
    n_t = csr_m.tile_start.shape[0]
    frags = rasterize_capsules_mlab(csr_m, params_m, s4b.width, s4b.height, 16, 8, 1,
                                    s4b.tf_color, s4b.tf_opacity, store_mode="count")[0][0]
    gen_m, f_gen = accum_check("mboit_gen", csr_m, params_m, 2, s=s4b, n_mom=r4b.n_mom)
    mboit_launches = base_lines[c4b]["launches"]["capsule_accum"] // 2
    kernels.append(accum_entry("capsule_accum:mboit_gen:femur", mboit_launches, f_gen, n_t, 2,
                               config=c4b))
    mom_m = torch.stack([gen_m[0][0], gen_m[1][0, 0], gen_m[1][1, 0], gen_m[0][1],
                         gen_m[1][0, 1]])
    kept_m = mom_m[0] >= MBOIT_DISCARD_B0
    kept_m = {"pixels": int(kept_m.sum()), "fragments": int(frags[kept_m].sum())}
    _, f_res = accum_check("mboit_resolve", csr_m, params_m, 1, kept_m, s=s4b,
                           n_mom=r4b.n_mom, moments=mom_m)
    kernels.append(accum_entry("capsule_accum:mboit_resolve:femur", mboit_launches, f_res, n_t,
                               1, extra_in_planes=5, config=c4b,
                               kept_pixels=kept_m["pixels"],
                               kept_fragments=kept_m["fragments"]))
    base_lines[c4b].update(pairs=f_gen["pairs"], fragments=f_gen["fragments"])
    c5 = "cfg5_tornado_opacityopt_1080p"
    csr_b, _ = prepare_mlab_frame(ld_tornado.get_capsule_scene(device=dev),
                                  *camera_tensors(cam0(c5), dev), reg_settings(c5), 0.3)
    base_lines[c5]["pairs"] = int(csr_b.tile_count.sum())
    del csr_b, csr_m, params_m, gen_m, mom_m, frags
    for name, line in base_lines.items():
        print(f"baseline config {name}: " + json.dumps(line), flush=True)

    # Each config at BASE_CHECK_SCALE on the card against the CPU's plain
    # path, on the same line data. Config 3's registry frames draw jax.random's
    # samples under PRNGKey(seed + frame) on each device, the same rays: its
    # BASE_CHECK_RTAO_FRAMES accumulated frames are held at the image bars.
    # Config 5's frame turns on which fragments the importance gather keeps
    # per pixel (K=8 of hundreds on the tornado at scale 0.1): on the CPU
    # alone, positions moved by one ulp move its image to SSIM 0.984
    # (tools/ulp_sensitivity.py). So its registry frame card vs CPU is held
    # at OO_FRAME_SSIM, and the config stage by stage on frame 0's camera:
    # the gather card vs CPU (the nodes equal on OO_GATHER_NODES of pixels;
    # whether the payload is equal is a reading), the solve on the card's
    # nodes (vertex opacities within OO_SOLVE_TOL), the final render on the
    # CPU solve's opacities (the image bars).
    def oo_stages(build, line_data):
        run_ = build(device="cpu", scale=BASE_CHECK_SCALE, line_data=line_data)
        cam_ = run_.cameras[0]
        s_ = run_.renderer._raster_settings(cam_)
        oo_s = OpacityOptimizationSettings()
        t_ = line_data.trajectories
        got = []
        for d in (dev, "cpu"):
            sc = line_data.get_capsule_scene(device=d)
            ct = camera_tensors(cam_, d)
            csr_, _, _ = prepare_capsule_frame(sc, *ct, gather_settings(s_, oo_s))
            got.append((sc, ct, csr_.payload.cpu(),
                        [x.cpu() for x in gather_importance(sc, *ct, s_, oo_s)]))
        (sc_g, ct_g, pay_g, nodes_g), (sc_c, ct_c, pay_c, nodes_c) = got
        same_shape = pay_g.shape == pay_c.shape
        prep_equal = same_shape and bool(torch.equal(pay_g, pay_c))
        node_ok = ((nodes_g[0] - nodes_c[0]).abs() <= 1e-5) & (nodes_g[2] == nodes_c[2])
        nodes_agree = float(node_ok.all(dim=0).float().mean())
        prev = torch.ones((t_.num_lines, t_.max_points))
        solve = [solve_vertex_opacity(*(x.to(d) for x in nodes_g), prev.to(d), oo_s,
                                      t_.num_lines, t_.max_points, sc_c.num_segments).cpu()
                 for d in (dev, "cpu")]
        solve_err = float((solve[0] - solve[1]).abs().max())
        imgs = [final_render(sc, *ct, solve[1].to(sc.a.device), s_, oo_s.render_k)
                .permute(1, 2, 0).cpu().numpy() for sc, ct in ((sc_g, ct_g), (sc_c, ct_c))]
        s_r = ssim(imgs[0][..., :3], imgs[1][..., :3])
        mad_r = float(np.abs(imgs[0] - imgs[1]).mean())
        ok = (nodes_agree >= OO_GATHER_NODES and solve_err <= OO_SOLVE_TOL
              and np.isfinite(imgs[0]).all() and s_r >= 0.999 and mad_r <= 2e-3)
        return ok, {"gather_prep_payload_equal": prep_equal,
                    "gather_pixels_with_equal_nodes": nodes_agree,
                    "solve_on_the_cards_nodes_max_abs": solve_err,
                    "final_render_same_opacities_ssim": s_r,
                    "final_render_same_opacities_mean_abs": mad_r}

    base_check = {}
    for name, build in BASELINE_CONFIGS.items():
        rtao_cfg = name.startswith("cfg3")
        out = []
        for d in (dev, "cpu"):
            t1 = time.perf_counter()
            out.append(build(device=d, scale=BASE_CHECK_SCALE,
                             frames=BASE_CHECK_RTAO_FRAMES if rtao_cfg else None,
                             line_data=base_line_data[name]).render())
            if d == "cpu":
                cpu_s = time.perf_counter() - t1
        g_img, c_img = out
        s_, mad = ssim(g_img[..., :3], c_img[..., :3]), float(np.abs(g_img - c_img).mean())
        base_check[name] = {"ssim": s_, "mean_abs": mad, "shape": list(g_img.shape[:2]),
                            "cpu_s": cpu_s}
        if name.startswith("cfg5"):
            agree, stages = oo_stages(build, base_line_data[name])
            agree = agree and s_ >= OO_FRAME_SSIM
            base_check[name].update(stages)
        else:
            agree = s_ >= 0.999 and mad <= 2e-3
        if not np.isfinite(g_img).all() or not agree:
            raise RuntimeError(f"{name}: the card frame disagrees with the CPU's "
                               f"({base_check[name]})")
    print(f"baseline configs card vs cpu at scale {BASE_CHECK_SCALE}: "
          + json.dumps(base_check), flush=True)
    del base_runs, femur_scene
    torch.cuda.empty_cache()

    # 20. The transparent ray tracer (the registry's "Vulkan Ray Tracer")
    # on the 1080p tornado over the registry's default "linear" tree:
    # RT_FRAMES re-cast frames (RT_CASTS casts, the whole loop in one launch
    # of bvh_recast) and RT_FRAMES MLAT frames (K = RT_MLAT_K, bvh_mlat
    # once), opacity RT_OPACITY, launches counted.
    t0 = time.perf_counter()
    rt_tree = lbvh_on(build_capsule_bvh(scene), dev)
    torch.cuda.synchronize()
    rt_build_s = time.perf_counter() - t0
    s_rt = RasterSettings(width=W, height=H)
    rt_cams = cams[:RT_FRAMES]

    def recast_frame(cam):
        return render_tubes_raytraced(scene, *cam, s_rt, max_depth_complexity=RT_CASTS,
                                      opacity=RT_OPACITY, bvh=rt_tree)

    def mlat_frame(cam):
        return render_tubes_mlat(scene, *cam, s_rt, K=RT_MLAT_K, opacity=RT_OPACITY,
                                 bvh=rt_tree)

    rt_lines, rt_launches, rt_imgs = {}, {}, {}
    for name, fn, kernel in (("recast", recast_frame, "bvh_recast"),
                             ("mlat", mlat_frame, "bvh_mlat")):
        fn(rt_cams[0])  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        frame_ev = [_events() for _ in rt_cams]
        imgs_sum = torch.zeros((), device=dev)
        for (a, b), cam in zip(frame_ev, rt_cams):
            a.record()
            img = fn(cam)
            b.record()
            imgs_sum += img.sum()
        torch.cuda.synchronize()
        rt_launches[kernel] = expect_launches({kernel: RT_FRAMES})[kernel]
        if not bool(torch.isfinite(imgs_sum)):
            raise RuntimeError(f"non-finite {name} frame on the main path")
        rt_imgs[name] = fn(rt_cams[0]).permute(1, 2, 0).cpu().numpy()
        frame_ms = [a.elapsed_time(b) for a, b in frame_ev]
        med = float(np.median(frame_ms))
        rt_lines[name] = {"frame_ms_median": med, "fps": 1000.0 / med, "frame_ms": frame_ms,
                          "launches_per_frame": {kernel: 1},
                          "foreground_share": float((rt_imgs[name][..., 3] > 0.01).mean())}
    rt_vs_mlat = ssim(rt_imgs["recast"][..., :3], rt_imgs["mlat"][..., :3])

    # Frame 0: the loop kernel's time and warp walk (over the collapsed
    # tree). The full-frame gate: its record of every cast against RT_CASTS
    # launches of the one-cast kernel through the plain loop
    # (`trace_recast`), each cast timed, and again with the casts' per-ray
    # counts (the loop's work for its bound). The one-cast kernel's
    # launches in these gates are read from its count.
    cam = rt_cams[0]
    o_rt, d_rt, wz_rt, pad_rt = tile_rays(cam[0], cam[1], s_rt)
    n_rt = o_rt.shape[0]
    dmin_rt, dmax_rt = _depth_cue_range(scene, cam[0])
    loop_args = (rt_tree, scene, o_rt, d_rt, wz_rt, pad_rt, cam[2], s_rt, RT_CASTS,
                 RT_OPACITY, dmin_rt, dmax_rt)
    r1_ms = _time_ms(lambda: capsule_recast(*loop_args), 3)
    one_cast_before = capsule_closest_hit.launches
    rec_k = (torch.empty((RT_CASTS, n_rt), device=dev),
             torch.empty((RT_CASTS, n_rt), dtype=torch.int32, device=dev))
    wide_wv = torch.zeros(n_rt // 32, dtype=torch.int64, device=dev)
    acc_k, T_k = capsule_recast(*loop_args, record=rec_k, warp_visits=wide_wv)
    rec_c = (torch.empty_like(rec_k[0]), torch.empty_like(rec_k[1]))
    cast_ev = []

    def timed_hit(*args):
        a, b = _events()
        a.record()
        t, prim = capsule_closest_hit(*args)
        b.record()
        rec_c[0][len(cast_ev)], rec_c[1][len(cast_ev)] = t, prim
        cast_ev.append((a, b))
        return t, prim

    cast_st = torch.zeros((n_rt, 2), dtype=torch.int64, device=dev)
    cast_wv = []

    def counted_hit(*args):
        st = torch.zeros_like(cast_st)
        wv = torch.zeros_like(wide_wv)
        out = capsule_closest_hit(*args, stats=st, warp_visits=wv)
        cast_st.add_(st)
        cast_wv.append(wv)
        return out

    acc_c, T_c = trace_recast(*loop_args, closest_hit=timed_hit)
    torch.cuda.synchronize()
    cast_ms = [a.elapsed_time(b) for a, b in cast_ev]
    trace_recast(*loop_args, closest_hit=counted_hit)
    full_equal = (len(cast_ev) == RT_CASTS and torch.equal(rec_k[0], rec_c[0])
                  and torch.equal(rec_k[1], rec_c[1]))
    full_err = max(float((acc_k - acc_c).abs().max()), float((T_k - T_c).abs().max()))
    r1_visits, r1_leaves = int(cast_st[:, 0].sum()), int(cast_st[:, 1].sum())
    r1_work = recast_work(rec_k, wz_rt, cam[2])
    warp_walk = {"loop": warp_figures(cast_st[:, 0], wide_wv),
                 "one_cast_kernels_loop": warp_figures(cast_st[:, 0],
                                                       torch.stack(cast_wv).sum(dim=0))}
    del rec_c, cast_wv

    # The band: a tile row where the rays find surfaces and walk least.
    row_rays = -(-W // RT_TILE[0]) * RT_TILE[0] * RT_TILE[1]
    first = torch.zeros_like(cast_st)
    first_wv = torch.zeros_like(wide_wv)
    t_first, p_first = capsule_closest_hit(
        rt_tree, scene, o_rt, d_rt, torch.zeros(n_rt, device=dev),
        torch.full((n_rt,), np.iinfo(np.int32).max, dtype=torch.int32, device=dev), pad_rt,
        stats=first, warp_visits=first_wv)
    if not (torch.equal(t_first, rec_k[0][0]) and torch.equal(p_first, rec_k[1][0])):
        raise RuntimeError("the one-cast kernel's first cast differs from the loop's")
    warp_walk["first_cast"] = warp_figures(first[:, 0], first_wv)
    row_hits = (p_first >= 0).reshape(-1, row_rays).float().mean(dim=1)
    row_walk = first[:, 0].reshape(-1, row_rays).max(dim=1).values
    rows_ok = torch.nonzero(row_hits >= RT_BAND_MIN_HITS).flatten()
    if rows_ok.numel() == 0:
        raise RuntimeError("no tile row of the ray tracer's frame hits enough surfaces")
    band_row = int(rows_ok[torch.argmin(row_walk[rows_ok])])
    band = slice(band_row * row_rays, (band_row + 1) * row_rays)
    band_args = (o_rt[band], d_rt[band], wz_rt[band], pad_rt[band])

    # R1 on the band against the plain loop: the one-cast kernel against
    # the plain ray_query on every cast (the loop going on with the plain
    # version's output), then the loop kernel's record of every cast bit for
    # bit, and the band's RGBA within 1e-4.
    casts_equal, plain_s = [], [0.0]
    rec_p = (torch.empty((RT_CASTS, row_rays), device=dev),
             torch.empty((RT_CASTS, row_rays), dtype=torch.int32, device=dev))

    def both_hits(*args):
        ks = torch.zeros((args[2].shape[0], 2), dtype=torch.int64, device=dev)
        ps = torch.zeros_like(ks)
        k = capsule_closest_hit(*args, stats=ks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p = capsule_closest_hit_reference(*args, stats=ps)
        torch.cuda.synchronize()
        plain_s[0] += time.perf_counter() - t1
        casts_equal.append(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
                           and torch.equal(ks, ps))
        rec_p[0][len(casts_equal) - 1], rec_p[1][len(casts_equal) - 1] = p
        return p

    band_loop = (rt_tree, scene, *band_args, cam[2], s_rt, RT_CASTS, RT_OPACITY, dmin_rt,
                 dmax_rt)
    acc_p, T_p = trace_recast(*band_loop, closest_hit=both_hits)
    rec_b = (torch.empty_like(rec_p[0]), torch.empty_like(rec_p[1]))
    acc_b, T_b = capsule_recast(*band_loop, record=rec_b)
    one_cast_launches = capsule_closest_hit.launches - one_cast_before
    torch.cuda.synchronize()
    bg_rt = torch.tensor(s_rt.background_color[:3], dtype=torch.float32, device=dev)[:, None]
    band_rgba_err = float((torch.cat([acc_b + T_b[None] * bg_rt, (1.0 - T_b)[None]])
                           - torch.cat([acc_p + T_p[None] * bg_rt, (1.0 - T_p)[None]]))
                          .abs().max())
    band_record_equal = torch.equal(rec_b[0], rec_p[0]) and torch.equal(rec_b[1], rec_p[1])
    r1_equal = all(casts_equal) and len(casts_equal) == RT_CASTS
    # R2 against its plain version on the band.
    k_st = torch.zeros((row_rays, len(MLAT_STATS)), dtype=torch.int64, device=dev)
    p_st = torch.zeros_like(k_st)
    mlat_kw = dict(K=RT_MLAT_K, opacity=RT_OPACITY, tf_opacity=s_rt.tf_opacity)
    k_nodes = mlat_nodes(rt_tree, scene, *band_args, cam[2], stats=k_st, **mlat_kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p_nodes = mlat_nodes_reference(rt_tree, scene, *band_args, cam[2], stats=p_st, **mlat_kw)
    torch.cuda.synchronize()
    mlat_plain_ms = (time.perf_counter() - t1) * 1e3
    r2_equal = all(torch.equal(a, b) for a, b in zip(k_nodes, p_nodes)) and torch.equal(k_st, p_st)
    # R2's full-frame counts, warp walk and time.
    m_st = torch.zeros((n_rt, len(MLAT_STATS)), dtype=torch.int64, device=dev)
    m_wv = torch.zeros(n_rt // 32, dtype=torch.int64, device=dev)
    mlat_nodes(rt_tree, scene, o_rt, d_rt, wz_rt, pad_rt, cam[2], stats=m_st, warp_visits=m_wv,
               **mlat_kw)
    r2_counts = dict(zip(MLAT_STATS, m_st.sum(dim=0).tolist()))
    warp_walk["mlat"] = warp_figures(m_st[:, 0], m_wv)
    r2_ms = _time_ms(lambda: mlat_nodes(rt_tree, scene, o_rt, d_rt, wz_rt, pad_rt, cam[2],
                                        **mlat_kw), 3)
    band_line = {
        "tile_row": band_row, "rays": row_rays,
        "first_cast_hit_share": float(row_hits[band_row]),
        "longest_walk_first_cast": int(row_walk[band_row]),
        "one_cast_casts_equal": sum(casts_equal), "casts": len(casts_equal),
        "loop_record_equal": band_record_equal, "loop_rgba_max_abs": band_rgba_err, "mlat_nodes_equal": r2_equal,
        "plain_recast_s": plain_s[0], "plain_mlat_s": mlat_plain_ms / 1e3,
    }
    print("ray tracer frame: " + json.dumps({
        **{k: v for k, v in rt_lines.items()}, "recast_vs_mlat_ssim": rt_vs_mlat,
        "bvh_build_s": rt_build_s, "builder": "linear", "casts": RT_CASTS, "K": RT_MLAT_K,
        "opacity": RT_OPACITY, "loop_kernel_ms": r1_ms, "one_cast_ms": cast_ms,
        "one_cast_ms_sum": float(sum(cast_ms)), "visits_per_frame": r1_visits,
        "leaf_tests_per_frame": r1_leaves, "loop_work": r1_work, "mlat_counts": r2_counts,
        "warp_walk": warp_walk, "full_frame_record_equal": full_equal,
        "full_frame_acc_T_max_abs": full_err, "one_cast_launches_in_the_gates": one_cast_launches,
        "frames": RT_FRAMES, "width": W, "height": H, "gpu": gpu}), flush=True)
    print("ray tracer band vs plain: " + json.dumps(band_line), flush=True)
    if not (r1_equal and band_record_equal and band_rgba_err <= 1e-4 and r2_equal):
        raise RuntimeError("a ray-tracer kernel disagrees with its plain version on the band")
    if not (full_equal and full_err <= 1e-5):
        raise RuntimeError("the loop kernel disagrees with the one-cast kernel's loop at 1080p")
    if min(v["foreground_share"] for v in rt_lines.values()) < 0.01:
        raise RuntimeError("the ray tracer's frame is almost empty")
    n_leaves = rt_tree.leaf_prim.shape[0]
    # The walks' shared stack entries: the collapsed and the binary walk's.
    rt_stack = [packed_wide_nodes(rt_tree, dev)[1], packed_nodes(rt_tree, dev)[1]]
    tree_bytes = (n_leaves - 1) * 8 + (2 * n_leaves - 1) * 24 + n_leaves * 4  # the tree's arrays
    S_seg = scene.num_segments
    ray_bytes = 12 + 12 + 4 + 1  # origin, direction, wz, pad
    r1_bytes = tree_bytes + S_seg * (12 + 12 + 4 + 1 + 4 + 4) + n_rt * (ray_bytes + 12 + 4)
    r1_ops = (r1_visits * RT_OPS_PER_VISIT + r1_leaves * RT_OPS_PER_LEAF
              + r1_work["surfaces_in_clip"] * RT_OPS_PER_SURFACE
              + (r1_work["surfaces"] - r1_work["surfaces_in_clip"]) * RT_OPS_PER_CLIPPED
              + r1_work["groups"] * RT_OPS_PER_FLUSH)
    t_bytes, t_ops = r1_bytes / H100_HBM_BYTES * 1e3, r1_ops / H100_FP32_FLOPS * 1e3
    one_bytes = tree_bytes + S_seg * (12 + 12 + 4 + 1) + n_rt * (12 + 12 + 4 + 4 + 1 + 4 + 4)
    one_ops = (r1_visits * RT_OPS_PER_VISIT + r1_leaves * RT_OPS_PER_LEAF) / RT_CASTS
    kernels.append({
        "name": "bvh_recast",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/bvh_closest_hit.cu",
        "replaces": "linevis_tpu/render/ray_tracer.py:271",
        "replaces_note": "no pallas_call: trace_one's fori_loop of casts, each ray_query's "
                         "vmapped while_loop (linevis_tpu/ops/lbvh.py:211) with the leaf "
                         "function of linevis_tpu/render/ray_tracer.py:147",
        "launches": rt_launches["bvh_recast"],
        "max_abs_err": band_rgba_err,  # RGBA on the band; every cast's (t, prim) equal
        "ms": r1_ms,
        "plain_ms": plain_s[0] * 1e3,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": r1_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "per_launch": "one launch a frame: all RT_CASTS casts, the state update and shading",
        "plain_on": f"tile row {band_row} ({row_rays} rays), the whole loop",
        "node_visits_per_frame": r1_visits,
        "leaf_tests_per_frame": r1_leaves,
        **r1_work,
        "warp_node_tests_per_frame": warp_walk["loop"]["warp_visits"],
        "stack_entries": rt_stack,
        "instances": resources["bvh_closest_hit"],
        "ptxas": ptxas_lines(built, "bvh_closest_hit"),
        "one_cast": {
            "launches_on_the_main_path": 0, "launches_in_the_gates": one_cast_launches,
            "ms": float(np.mean(cast_ms)), "ms_first_cast": cast_ms[0],
            "ms_sum_of_casts": float(sum(cast_ms)),
            "plain_ms": plain_s[0] * 1e3 / RT_CASTS,
            "bound_ms": max(one_bytes / H100_HBM_BYTES, one_ops / H100_FP32_FLOPS) * 1e3,
            "note": "capsule_closest_hit, one cast: the mean of a frame's casts; bound and "
                    "plain_ms per launch"},
    })
    r2_bytes = (tree_bytes + S_seg * (12 + 12 + 4 + 1 + 4 + 4) + n_rt * ray_bytes
                + 5 * RT_MLAT_K * n_rt * 4)
    r2_ops = (r2_counts["visits"] * MLAT_OPS_PER_VISIT + r2_counts["leaf_tests"]
              * MLAT_OPS_PER_LEAF + r2_counts["inserts"] * (MLAT_OPS_PER_INSERT + RT_MLAT_K))
    t_bytes, t_ops = r2_bytes / H100_HBM_BYTES * 1e3, r2_ops / H100_FP32_FLOPS * 1e3
    kernels.append({
        "name": "bvh_mlat",
        "route": "cuda",
        "source": "linevis_tpu_torch/kernels/csrc/bvh_mlat.cu",
        "replaces": "linevis_tpu/render/ray_tracer.py:441",
        "replaces_note": "no pallas_call: render_tubes_mlat's vmapped while_loop",
        "launches": rt_launches["bvh_mlat"],
        "max_abs_err": max(float((a - b).abs().nan_to_num(0.0).max())
                           for a, b in zip(k_nodes, p_nodes)),
        "ms": r2_ms,
        "plain_ms": mlat_plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bytes": r2_bytes,
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "library_ms": None,
        "plain_on": f"tile row {band_row} ({row_rays} rays)",
        **{k + "_per_frame": v for k, v in r2_counts.items()},
        "warp_node_tests_per_frame": warp_walk["mlat"]["warp_visits"],
        "stack_entries": rt_stack[1],
        "K": RT_MLAT_K,
        "instances": resources["bvh_mlat"],
        "ptxas": ptxas_lines(built, "bvh_mlat"),
    })
    del o_rt, d_rt, wz_rt, pad_rt, rec_k, cast_st, first, m_st, k_nodes, p_nodes, rec_b, rec_p
    torch.cuda.empty_cache()

    # 21. The deferred family and the RTAO denoisers at 1080p.
    cam = cams[0]
    img_fwd = render_tubes(scene, *cam, settings)
    img_def, mv_static = render_tubes_deferred(scene, *cam, settings, prev_view_proj=cam[0],
                                               with_motion=True)
    deferred_equal = torch.equal(img_def, img_fwd)
    mv_static_max = float(mv_static.abs().max())
    ld_rt = LineData(traj)
    ld_rt.set_line_width(2.0 * TORNADO_RADIUS)
    cam_base = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    orbit = [cam_base.orbit(0.002 * (i + 1), 0.1, 1.2) for i in range(RT_FRAMES)]

    def timed_registry(r, expected, moving=True):
        """RT_FRAMES registry frames (orbit cameras, or the first one
        throughout) after a warm-up at a camera off the orbit: CUDA events
        and the host clock around render(), launches checked."""
        r.render(cam_base.orbit(0.5, 0.3, 1.3))
        torch.cuda.synchronize()
        reset_launches()
        ev, host = [_events() for _ in orbit], []
        for i, (a, b) in enumerate(ev):
            t1 = time.perf_counter()
            a.record()
            img_r = r.render(orbit[i] if moving else orbit[0])
            b.record()
            host.append((time.perf_counter() - t1) * 1e3)
            if not np.isfinite(img_r).all():
                raise RuntimeError(f"{r.name}: non-finite registry frame")
        torch.cuda.synchronize()
        expect_launches({k: n * RT_FRAMES for k, n in expected.items()})
        return {"frame_ms_median": float(np.median([a.elapsed_time(b) for a, b in ev])),
                "host_frame_ms_median": float(np.median(host)),
                "launches_per_frame": expected}

    den_lines = {}
    r_def = create_renderer("Deferred Opaque", device=dev)
    r_def.set_line_data(ld_rt)
    r_def.set_new_settings(SettingsMap({"upscaling_factor": 2}))
    den_lines["deferred_opaque_upscaling_2"] = timed_registry(r_def, {"capsule_raster": 1})
    grid_rt = tornado_segment_grid(scene, rt.grid_resolution)
    per_rtao = {"capsule_raster": 1, "ao_grid": len(batches), "threefry_uniform": 2}
    for den in ("EAW", "Spatial Hashing"):
        rt_den = dataclasses.replace(rt, denoiser=den)
        render_tubes_rtao(scene, *cams[0], settings, rt_den, frame=0, grid=grid_rt)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        ev = [_events() for _ in range(RT_FRAMES)]
        imgs_sum = torch.zeros((), device=dev)
        for i, (a, b) in enumerate(ev):
            a.record()
            img = render_tubes_rtao(scene, *cams[i], settings, rt_den, frame=i, grid=grid_rt)
            b.record()
            imgs_sum += img.sum()
        torch.cuda.synchronize()
        expect_launches({k: n * RT_FRAMES for k, n in per_rtao.items()})
        if not bool(torch.isfinite(imgs_sum)):
            raise RuntimeError(f"non-finite RTAO frame with the {den} denoiser")
        den_lines[f"rtao_{den}"] = {
            "frame_ms_median": float(np.median([a.elapsed_time(b) for a, b in ev])),
            "launches_per_frame": per_rtao}
    r_svgf = create_renderer("RTAO", SettingsMap({"denoiser": "SVGF (Temporal)"}), device=dev)
    r_svgf.set_line_data(ld_rt)
    den_lines["rtao_svgf_temporal_registry"] = timed_registry(r_svgf, per_rtao)
    den_lines["rtao_svgf_temporal_registry"]["history_length_max"] = float(
        r_svgf._svgf_state.length.max())
    if r_svgf._frame != RT_FRAMES + 1:
        raise RuntimeError("the temporal SVGF frame count restarted on a camera move")

    # Card vs CPU on the small scene and identical samples (entry_rtao's):
    # EAW and Spatial Hashing, and two temporal SVGF frames of a moving
    # camera, the state carried.
    def rtao_small(d, den):
        fn, args = entry_rtao(device=d)
        return fn(*args, rtao=dataclasses.replace(fn.keywords["rtao"], denoiser=den))

    def svgf_small(d):
        fn, args = entry_rtao(device=d)
        state, prev, out = None, None, None
        for i in range(2):
            ct = camera_tensors(Camera(position=(0.02 * i, 0.3, 1.2), width=256, height=128), d)
            img_s, (pos, nrm, fg) = fn(args[0], *ct, return_features=True)
            mv = (torch.zeros((2,) + tuple(fg.shape), device=d) if prev is None
                  else motion_vectors(pos, fg, prev))
            out, state = svgf_temporal_denoise(img_s[:3], mv, pos, state, normal=nrm)
            prev = ct[0]
        return torch.cat([out, img_s[3:4]])

    den_check = {}
    for label, make in (("EAW", lambda d: rtao_small(d, "EAW")),
                        ("Spatial Hashing", lambda d: rtao_small(d, "Spatial Hashing")),
                        ("SVGF (Temporal)", svgf_small)):
        g_img, c_img = (make(d).permute(1, 2, 0).cpu().numpy() for d in (dev, "cpu"))
        s_, mad = ssim(g_img[..., :3], c_img[..., :3]), float(np.abs(g_img - c_img).mean())
        den_check[label] = [s_, mad]
        if not np.isfinite(g_img).all() or s_ < 0.999 or mad > 2e-3:
            raise RuntimeError(f"RTAO with {label}: the card frame disagrees with the CPU's")
    print("deferred and denoisers: " + json.dumps({
        "deferred_equals_render_tubes": deferred_equal,
        "static_motion_max_px": mv_static_max, **den_lines,
        "card_vs_cpu_small (ssim, mean abs)": den_check, "frames": RT_FRAMES,
        "width": W, "height": H, "gpu": gpu}), flush=True)
    if not deferred_equal or mv_static_max > DEFERRED_STATIC_MV:
        raise RuntimeError("the deferred frame differs from render_tubes', or a static camera "
                           "moves")

    # 22. SSAO and GTAO on the 1080p capsule G-buffer (a reading).
    # View depth along the unit forward axis (the pixel rays have a unit
    # forward component); the background far away.
    gbuf = rtao_gbuffer(scene, *cam, settings)
    basis = _ray_basis(cam[0])
    view_z = torch.where(gbuf.fg, torch.sum((gbuf.pos - cam[1][:, None, None])
                                            * basis[:, 2][:, None, None], dim=0), 1e6)
    ao_lines = {}
    for name, fn in (("ssao", lambda: ssao(view_z, gbuf.normal, basis, gbuf.fg)),
                     ("gtao", lambda: gtao(view_z, gbuf.normal, basis, gbuf.fg))):
        ao_map = fn()
        ms = _time_ms(fn, 2)
        ao_lines[name] = {"ms": ms, "mean_ao_on_foreground": float(ao_map[gbuf.fg].mean())}
        if not bool(torch.isfinite(ao_map).all()):
            raise RuntimeError(f"non-finite {name} map")
    print("ssao and gtao: " + json.dumps({**ao_lines, "width": W, "height": H, "gpu": gpu}),
          flush=True)
    del gbuf, view_z, grid_rt

    # 23. The AO bake of the whole tornado (AoBakeSettings' defaults): ring
    # points of every vertex, traced through B5 once per sample and frame.
    bake = AoBakeSettings()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    baked = bake_ambient_occlusion(traj.positions, traj.mask, TORNADO_RADIUS, bake, device=dev)
    bake_s = time.perf_counter() - t0
    bake_launches = expect_launches({"ao_grid": bake.num_frames * bake.samples_per_frame,
                                     "threefry_uniform": 2 * bake.num_frames})
    valid_pts = traj.mask.astype(bool)
    bake_line = {"seconds": bake_s, "shape": list(baked.shape),
                 "ring_points": int(valid_pts.sum()) * bake.num_tube_subdivisions,
                 "rays": int(np.prod(baked.shape)) * bake.num_frames * bake.samples_per_frame,
                 "mean_ao_valid": float(baked[valid_pts].mean()),
                 "launches": bake_launches["ao_grid"], "gpu": gpu}
    print("ao bake: " + json.dumps(bake_line), flush=True)
    if not np.isfinite(baked).all() or not 0.05 < bake_line["mean_ao_valid"] < 1.0:
        raise RuntimeError("the AO bake is non-finite or has no occlusion")
    torch.cuda.empty_cache()

    kernels.extend(datasets_phase(dev, gpu, traj, reset_launches, expect_launches, resources))
    torch.cuda.empty_cache()
    kernels.extend(scattering_phase(dev, gpu, traj, reset_launches, expect_launches, built))
    torch.cuda.empty_cache()
    app_phase(dev, gpu, traj, reset_launches, expect_launches)
    torch.cuda.empty_cache()
    par_ms = parallel_phase(dev, gpu, traj, reset_launches, expect_launches)
    torch.cuda.empty_cache()
    print(f"parallel frame ms ({gpu}): " + json.dumps(par_ms), flush=True)
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
