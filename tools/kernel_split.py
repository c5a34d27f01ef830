"""Where the time of the port's hand-written kernels (B1-B6, R1-R5, R7, R8) goes, on one card.

A one-off measurement script beside `chip_smoke.py` and `tools/kernel_ab.py`,
not part of the port's package. Run from the root of a source tree:

    python3 tools/kernel_split.py [--turns N] [--out FILE]
        [--kernels b5,b2,b4,b6,b1,b3,accum,r1,r2,r3,r4,r5,r7,r8]

B5 (`csrc/ao_grid.cu`), on the first 1080p batch of rays of `chip_smoke.py`'s
first RTAO frame: the launch as it is; the same launch with every
`seg_chunks` set to 0 (every pair chunk empty); only the active pair chunks;
those without the longest walk; and the longest walk alone. It also prints
the walk lengths (record chunks per active pair chunk).

Then the tree's B5 against its variants (`B5_VARIANTS`: block shapes and
register budgets), in turns.

Every kernel's variants are text substitutions of the tree's own source,
each built into a library of its own and timed in turns with the source as
it is; a variant that changes the function says so (`equal_to_base`). A
source that no longer holds a variant's text exactly once stops the script:
the variants follow the committed sources (git history keeps those of the
first designs). Each time is the mean of 40 launches between CUDA events.

B2 (`csrc/raster_capsule_oit.cu`), on the first orbit camera of the 1080p
tornado (tile 16x8, K=8, opacity 0.3), against `VARIANTS`: the MLAB
composite, the exact peel pass (per-fragment shading behind a peel depth)
and the 'gather' at 960x528.

B4 (`csrc/raster_prism.cu`), on the first orbit camera of the 1080p prism
tornado (8 sides, tile 32x16, and 16x8): the histogram of candidates per
tile, the longest run's tile alone (every other tile's run emptied), and
the tree's kernel against `B4_VARIANTS` (register budgets, no miss vote,
tiles in index order, the set-up alone) with `clock64()` phase shares.

B6 (`csrc/bvh_wavefront.cu`), on that camera's 1080p primary rays through
the binned-SAH tree (K=8, opacity 0.3): the histogram of group visits per
ray block, the block with the most visits alone, and the tree's kernel
against `B6_VARIANTS` (register budgets, the traversal alone with leaf rows
treated as none, the leaf tests without sweeps, the sweeps without the
members' shading or without the insertion, the next record waited for as
soon as its copy starts) and `clock64()` phase shares of the warp-cycles
(record wait, slab test with its reduction and barrier, leaf tests,
sweeps, push; the compiler moves independent work across the clock reads,
so the shares are rough).

B1 (`csrc/raster_capsule.cu`), on that camera's 1080p capsule frame at
32x16 with AA, the RTAO G-buffer's pass (32x16, no AA) and 16x8 with AA:
the histogram of candidates per tile, the start caps among the pairs,
whether the kernel equals its plain version bit for bit, and the tree's
kernel against `B1_VARIANTS`, the longest run's tile alone timed as one
more mode. B3 (`csrc/raster_triangle.cu`), on the 1080p triangle tubes (8
subdivisions, 32x16, chunk 128) with 8 attribute planes and depth only:
the histogram of chunks per tile and the same against `B3_VARIANTS`.

The accumulation kernel (`csrc/raster_capsule_accum.cu`, `accum`), on that
camera's 1080p frame at 16x8 (chunk 128): 'count' and 'wboit' on the
capsule binning, both MBOIT passes (4 power moments; the resolve also with
8 trigonometric ones) on `prepare_mboit_frame`'s, and 'wboit' with the
longest run's tile alone: the histogram of candidates per tile, the
fragments and the pixels whose moments the resolve keeps, whether the
kernel equals its plain version bit for bit in each mode, and the tree's
kernel against `ACCUM_VARIANTS` with the share of (warp, candidate) pairs
in which no lane has a fragment; 'count' also with the 132 longest runs
alone and with every run but them.

R1 (`csrc/bvh_closest_hit.cu`, `r1`) and R2 (`csrc/bvh_mlat.cu`, `r2`), on
that camera's 1080p tile-ordered rays through the linear tree (R1: the
re-cast loop of 32 casts in one launch over the collapsed tree, and its
first cast alone through the one-cast kernel; R2: K=8 and K=32, opacity
0.3): each ray's node visits (its own binary walk's, from the one-cast
kernel through the plain loop) against its warp's node tests (the histogram
of that ratio), and the tree's kernels against
`R1_VARIANTS` / `R2_VARIANTS` (register budgets, block sizes) with
`clock64()` phase shares (`phase_clock`: the record's load, the children's
slab tests and push, the leaf work, the pop and the state-dependent test,
R1's per-cast state update, R2's insertions within its leaf work; R1's
phases are those of its collapsed walk in `csrc/bvh_closest_hit.cu`, R2's
of the binary walk in `csrc/bvh_capsule.cuh`, which the variants' sources
inline so that their substitutions reach it).

R3 (`csrc/vpt_tracking.cu`, `r3`), on `chip_smoke.py`'s first path-traced
sample (the 512^3 cloud, 1080p, Delta tracking, 512 events): the events
and scatters per ray, the share of lane-events a lockstep warp of 32
neighbouring rays keeps busy (sum of events over 32 x each warp's most),
and the tree's kernel against `R3_VARIANTS`: `clock64()` phase shares
(`phase_clock`), the warps' busy steps (`warp_steps`, the persistent
design's lane use), register budgets, block size, the IEEE divisions where
the divisors are powers of two, refill thresholds; and
the persistent design against its grid layouts (`R3_LAYOUT_VARIANTS`: the
linear grid, bricks of voxel pairs or quads), each handed its layout.
R4 (`csrc/density_march.cu`, `r4`), on the smoke's 1080p density-map frame
(the line density field of `entry.scattering_line_data`): the steps per
pixel, their share whose cell has a non-zero corner and in an occupied 8^3
brick (`volume_common.brick_occupancy`), the lanes a lockstep warp keeps
busy on rows of 32 and on 8x4 and 16x2 blocks, and the tree's kernel
against `R4_VARIANTS` (phase clocks, the kernel's own counts of sampled
steps, jumps and batches, each block's start and end, the clip alone,
skipping off, the field's layouts with skipping on and off (on the
power-of-two and the IEEE instances), the transfer functions' table in
shared or global memory, batch sizes, block shapes, register budgets and
probes of a batch).
R5 (`csrc/spherical_heatmap.cu`, `r5`), on the smoke's 1080x2160 heat map
of the traced cloud's exit directions: the kernel's own counts (pairs in
range and candidates per tile), its branch-free term against the IEEE term
on every float (`heatmap_term_mismatches`), and the kernel against
`R5_VARIANTS` (the scan alone, tiles, unrolls, threads a pixel, the IEEE
term).

R7 (`csrc/vpt_decomposition.cu`, `r7`) and R8 (`csrc/vpt_residual_ratio.cu`,
`r8`), on R3's sample (the smoke's defaults, super voxels of 8): R7's events
per ray and by kind (`kinds`: skips, entries, residual candidates without and
with a density test, absorptions, scatters), R8's bounces, turns, DDA and
residual steps (their shares of the steps), the lanes a lockstep warp of 32
neighbouring rays keeps busy, and the tree's kernel against the variants of
its design (`_matching_variants`: the first, one thread a ray, or the
persistent one): `clock64()` phase shares (`phase_clock`: draws, the
super voxel's state or the residual step's other work, the density sample),
the warps' steps (`warp_steps`, the persistent design's lane use), register
budgets. A/B timing against a parent tree is `tools/kernel_ab.py --kernels
r7,r8`.

For B4, B6, B1, B3, R1-R4, R7, R8 and the accumulation kernel: registers, local memory,
shared memory and resident blocks per SM of every instance of every
variant, read through the library's `kernel_info`, and each variant's
ptxas lines (registers, stack frame, spills).

The last line holds the card's name and power limit and every figure (also
written to FILE with --out).
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = ["main", "VARIANTS", "B5_VARIANTS", "B4_VARIANTS", "B6_VARIANTS", "B1_VARIANTS",
           "B3_VARIANTS", "ACCUM_VARIANTS", "R1_VARIANTS", "R2_VARIANTS", "R3_VARIANTS",
           "R4_VARIANTS", "R5_VARIANTS", "R7_VARIANTS", "R8_VARIANTS"]

# name -> [(old, new), ...] applied to csrc/raster_capsule_oit.cu (B2: a
# sorted per-thread list of the nearest hits, the nodes in shared memory):
# parts taken out or changed.
VARIANTS = {
    "slots_4": [("#define SLOTS 6 ", "#define SLOTS 4 ")],
    "slots_8": [("#define SLOTS 6 ", "#define SLOTS 8 ")],
    # The scan and the sorted insertion alone: no window taken (the list is
    # read once, so neither is dead code).
    "fill_only": [("          need_fill = false;\n          fresh = true;\n        }\n",
                   "          need_fill = false;\n          fresh = true;\n        }\n"
                   "        if (Ltw[0] == -1.0f) evaluated = -1;\n        break;\n")],
    # The nodes in registers at every KMAX and tile (no channel in shared
    # memory).
    "nodes_in_registers": [("      launch<8, 5>(", "      launch<8, 0>("),
                           ("      launch<16, 5>(", "      launch<16, 0>("),
                           ("      launch<32, 5>(", "      launch<32, 0>("),
                           ("      launch<32, 3>(", "      launch<32, 0>(")],
    # The phases timed with clock64() by lane 0 of each warp:
    # the hit scans (fill), the window loop (scans included), the wait at
    # the tile-wide bound's barrier, the epilogue and the whole kernel,
    # summed into `g_phase` (read back and zeroed by `read_phase`).
    "phase_clock": [
        ('#include "capsule_common.cuh"\n',
         '#include "capsule_common.cuh"\n__device__ unsigned long long g_phase[5];\n'
         'extern "C" int read_phase(unsigned long long* h) {\n'
         '  const int e = (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n'
         '  const unsigned long long z[5] = {0, 0, 0, 0, 0};\n'
         '  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  return e;\n}\n'),
        ("  const int K = o.K;\n",
         "  const int K = o.K;\n  long long ph_fill = 0, ph_win = 0, ph_bar = 0;\n"
         "  const long long ph_start = clock64();\n"),
        ("      __syncthreads();\n      float zk = s_red[red][0];\n",
         "      const long long ph_b0 = clock64();\n      __syncthreads();\n"
         "      ph_bar += clock64() - ph_b0;\n      float zk = s_red[red][0];\n"),
        ("      for (int win = 0; win < K;) {\n        if (need_fill) {\n",
         "      const long long ph_w0 = clock64();\n      for (int win = 0; win < K;) {\n"
         "        if (need_fill) {\n          const long long ph_f0 = clock64();\n"),
        ("          need_fill = false;\n          fresh = true;\n        }\n",
         "          need_fill = false;\n          fresh = true;\n"
         "          ph_fill += clock64() - ph_f0;\n        }\n"),
        ("          dirty = true;\n        }\n      }\n    }\n  }\n\n",
         "          dirty = true;\n        }\n      }\n      ph_win += clock64() - ph_w0;\n"
         "    }\n  }\n\n  const long long ph_e0 = clock64();\n"),
        ("  if (work != nullptr && tid == 0) work[tile] = evaluated;",
         "  if (lane == 0) {\n    const long long ph_end = clock64();\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_fill);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_win);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)(ph_end - ph_start));\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)ph_bar);\n"
         "    atomicAdd(&g_phase[4], (unsigned long long)(ph_end - ph_e0));\n  }\n"
         "  if (work != nullptr && tid == 0) work[tile] = evaluated;")],
}
# The same for csrc/ao_grid.cu (B5): block shapes and register budgets (4 slot groups of 32 slots per ray:
# blocks of 512 threads; no minimum of resident blocks per SM, which lets
# the registers exceed 32).
B5_VARIANTS = {
    "min_blocks_1": [("__launch_bounds__(C * SPLIT, 2)", "__launch_bounds__(C * SPLIT)")],
    "split_4_min_blocks_4": [("#define SPLIT 8 ", "#define SPLIT 4 "),
                             ("__launch_bounds__(C * SPLIT, 2)", "__launch_bounds__(C * SPLIT, 4)")],
}

# The `phase_clock` variants' counters: warp-cycles summed into `g_phase`
# by lane 0 of each warp, read back and zeroed by `read_phase`.
_PHASE_COUNTERS = (
    '#include "capsule_common.cuh"\n',
    '#include "capsule_common.cuh"\n__device__ unsigned long long g_phase[8];\n'
    'extern "C" int read_phase(unsigned long long* h) {\n'
    '  const int e = (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n'
    '  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n'
    '  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  return e;\n}\n')
# The same for csrc/raster_prism.cu (B4: S a template argument, set-up one
# thread per (plane, candidate), tiles longest run first).
B4_VARIANTS = {
    # Register budgets of the 8-side instance: 3 resident blocks per SM (at
    # most 40 registers) or 1 (at most 128).
    "min_blocks_3": [("#define MIN_BLOCKS 2\n", "#define MIN_BLOCKS 3\n")],
    "min_blocks_1": [("#define MIN_BLOCKS 2\n", "#define MIN_BLOCKS 1\n")],
    # No miss vote (the same function).
    "no_miss_vote": [("        if (kk == 2 + S / 2 && __all_sync(",
                      "        if (false && __all_sync(")],
    # Tiles in index order instead of longest run first (the same function).
    "index_order": [("  const int tile = order[blockIdx.x];", "  const int tile = blockIdx.x;")],
    # The staging and set-up alone: no pixel loop.
    "setup_only": [("    int best_j = -1;\n    for (int j = 0; j < n; ++j) {",
                    "    int best_j = -1;\n    for (int j = 0; j < 0; ++j) {")],
    # Warp-cycles: the staging and set-up with their barriers, the pixel
    # loop, the winner's G-buffer after it, the whole kernel.
    "phase_clock": [
        _PHASE_COUNTERS,
        ("  const int start = tile_start[tile];\n",
         "  long long ph_setup = 0, ph_pix = 0, ph_after = 0;\n"
         "  const long long ph_start = clock64();\n  const int start = tile_start[tile];\n"),
        ("    const int n = min(CHUNK, count - c0);\n",
         "    const int n = min(CHUNK, count - c0);\n    const long long ph0 = clock64();\n"),
        ("    int best_j = -1;\n",
         "    const long long ph1 = clock64();\n    ph_setup += ph1 - ph0;\n    int best_j = -1;\n"),
        ("    if (best_j >= 0) {  // the winner changed in this chunk: its G-buffer\n",
         "    const long long ph2 = clock64();\n    ph_pix += ph2 - ph1;\n"
         "    if (best_j >= 0) {  // the winner changed in this chunk: its G-buffer\n"),
        ("      updated = true;\n    }\n  }\n",
         "      updated = true;\n    }\n    ph_after += clock64() - ph2;\n  }\n"),
        ("  if (work != nullptr && tid == 0) work[tile] = count;",
         "  if ((tid & 31) == 0) {\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_setup);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_pix);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)ph_after);\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)(clock64() - ph_start));\n  }\n"
         "  if (work != nullptr && tid == 0) work[tile] = count;")],
}
B4_PHASES = ("setup", "pixels", "winner_gbuffer", "total")

# The same for csrc/bvh_wavefront.cu (B6: nodes in shared memory, the next
# record in flight during the leaf work, one barrier a visit).
B6_VARIANTS = {
    # Register budgets: 8, 6 or 4 resident blocks per SM.
    "min_blocks_8": [("#define MIN_BLOCKS 5 ", "#define MIN_BLOCKS 8 ")],
    "min_blocks_6": [("#define MIN_BLOCKS 5 ", "#define MIN_BLOCKS 6 ")],
    "min_blocks_4": [("#define MIN_BLOCKS 5 ", "#define MIN_BLOCKS 4 ")],
    "traversal_only": [("    if (leaf_mask) {\n      ++leaf_visits;",
                        "    if (false) {\n      ++leaf_visits;")],
    "no_sweeps": [("      for (int sw = 0; sw < K && nhit > 0; ++sw) {",
                   "      my_members += nhit;\n      for (int sw = 0; sw < 0 && nhit > 0; ++sw) {")],
    # The sweeps without the members' shading (the windows' sizes kept).
    "sweeps_no_shading": [("        while (members) {  // in candidate order\n",
                           "        cnt = (float)__popc(members);\n"
                           "        nhit -= __popc(members);\n        members = 0u;\n"
                           "        while (members) {  // in candidate order\n")],
    # The sweeps without the insertion and the merge (every carry dropped).
    "sweeps_no_insert": [("        if (dup) pos = K;\n        float ed",
                          "        dup = dup || cdp > -3.0e38f;\n        if (dup) pos = K;\n"
                          "        float ed")],
    # The nearest candidate of a sweep as a tree of minima instead of a
    # chain (the same function: the candidates are finite).
    "bt_tree": [("        float bt = BIG;\n#pragma unroll\n"
                 "        for (int i = 0; i < 16; ++i) bt = fminf(bt, tw[i]);\n",
                 "        float m8[8];\n#pragma unroll\n"
                 "        for (int i = 0; i < 8; ++i) m8[i] = fminf(tw[i], tw[8 + i]);\n"
                 "#pragma unroll\n"
                 "        for (int i = 0; i < 4; ++i) m8[i] = fminf(m8[i], m8[4 + i]);\n"
                 "        const float bt = fminf(fminf(m8[0], m8[2]), fminf(m8[1], m8[3]));\n")],
    # The next record waited for right after it is started: no overlap with
    # the leaf work (the same function).
    "fetch_not_overlapped": [(
        "      fetch_group(rec[n & 1], groups, ld_groups, top >= 0 ? top : stack[sp - 1], "
        "&bar[n & 1]);\n",
        "      fetch_group(rec[n & 1], groups, ld_groups, top >= 0 ? top : stack[sp - 1], "
        "&bar[n & 1]);\n    if (sp > 0) wait_group(&bar[n & 1], (n >> 1) & 1);\n")],
    # Warp-cycles: the wait for the record, the slab test with the
    # reduction and the barrier, the leaf tests, the sweeps, the push with
    # the next copy's start, the whole kernel.
    "phase_clock": [
        _PHASE_COUNTERS,
        ("  bool failed = false;\n",
         "  bool failed = false;\n"
         "  long long ph_wait = 0, ph_slab = 0, ph_leaf = 0, ph_sweep = 0, ph_push = 0;\n"
         "  const long long ph_start = clock64();\n"),
        ("    const int b = n & 1;\n    wait_group(&bar[b], (n >> 1) & 1);\n",
         "    const int b = n & 1;\n    const long long ph0 = clock64();\n"
         "    wait_group(&bar[b], (n >> 1) & 1);\n    const long long ph1 = clock64();\n"
         "    ph_wait += ph1 - ph0;\n"),
        ("    unsigned any = 0u;\n",
         "    const long long ph2 = clock64();\n    ph_slab += ph2 - ph1;\n    unsigned any = 0u;\n"),
        ("    if (leaf_mask) {\n      ++leaf_visits;",
         "    const long long ph3 = clock64();\n    ph_push += ph3 - ph2;\n"
         "    if (leaf_mask) {\n      ++leaf_visits;"),
        ("      // At most K sweeps: the nearest tie window each.\n",
         "      const long long ph4 = clock64();\n      ph_leaf += ph4 - ph3;\n"
         "      // At most K sweeps: the nearest tie window each.\n"),
        ("      }\n    }\n  }\n\n  if (failed && tid == 0) atomicExch(overflow, 1);",
         "      }\n      ph_sweep += clock64() - ph4;\n    }\n  }\n\n"
         "  if ((tid & 31) == 0) {\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_wait);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_slab);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)ph_leaf);\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)ph_sweep);\n"
         "    atomicAdd(&g_phase[4], (unsigned long long)ph_push);\n"
         "    atomicAdd(&g_phase[5], (unsigned long long)(clock64() - ph_start));\n  }\n"
         "  if (failed && tid == 0) atomicExch(overflow, 1);")],
}
B6_PHASES = ("record_wait", "slab", "leaf_tests", "sweeps", "push", "total")

# The same for csrc/raster_capsule.cu (B1: tiles longest run first, AA and
# early-z template arguments, warps on 8x4 pixel blocks with votes, the
# start cap behind a uniform branch, double-buffered staging).
_B1_VOTES_OFF = [
    ("      if (AA || __any_sync(FULL, h >= 0.0f)) {", "      if (true) {"),
    ("      if (AA && __any_sync(FULL, okb)) {", "      if (AA) {"),
    ("        if (AA || __any_sync(FULL, ha >= 0.0f)) {", "        if (true) {"),
    ("        if (AA && __any_sync(FULL, oka)) {", "        if (AA) {"),
    ("      if (AA || __any_sync(FULL, hb >= 0.0f)) {", "      if (true) {"),
    ("      if (AA && __any_sync(FULL, okb2)) {", "      if (AA) {")]
B1_VARIANTS = {
    # Tiles in index order (the same function).
    "index_order": [("  const int tile = order[blockIdx.x];", "  const int tile = blockIdx.x;")],
    # No warp votes (the same function).
    "no_votes": _B1_VOTES_OFF,
    # Warps on rows of 32 pixels (the same function).
    "rows_of_32": [(
        "  const int pix = ((warp / bw) * 4 + lane / 8) * tile_w + (warp % bw) * 8 + lane % 8;",
        "  const int pix = tid;")],
    # The start cap evaluated for every candidate (the same function).
    "no_cap_skip": [
        ("      if (sc[ROW_CAP_A][j] > 0.5f) {", "      if (true) {"),
        ("          oka = (AA || ha >= 0.0f) && (ya <= 0.0f) && (t0 + ta > 0.0f);",
         "          oka = (AA || ha >= 0.0f) && (ya <= 0.0f) && (t0 + ta > 0.0f)\n"
         "                && sc[ROW_CAP_A][j] > 0.5f;")],
    # One resident block per SM (up to 128 registers).
    "min_blocks_1": [("#define MIN_BLOCKS 2 ", "#define MIN_BLOCKS 1 ")],
    # The candidate loop unrolled by 2 (the same function).
    "unroll_2": [("    for (int j = 0; j < n; ++j) {\n      const float oa0",
                  "#pragma unroll 2\n    for (int j = 0; j < n; ++j) {\n      const float oa0")],
    # Warp-cycles: the staging with its barrier and early-z, per candidate
    # the set-up and body (with its AA distance), the two caps (with
    # theirs), the rest of the pixel loop (nearest part, winner update),
    # the whole kernel.
    "phase_clock": [
        _PHASE_COUNTERS,
        ("  int evaluated = 0;\n",
         "  int evaluated = 0;\n  long long ph_stage = 0, ph_body = 0, ph_caps = 0, ph_loop = 0;\n"
         "  const long long ph_start = clock64();\n"),
        ("    const int n = min(CHUNK, count - c0);\n",
         "    const int n = min(CHUNK, count - c0);\n    const long long p0 = clock64();\n"),
        ("    evaluated += n;\n",
         "    evaluated += n;\n    const long long p1 = clock64();\n    ph_stage += p1 - p0;\n"),
        ("      const float oa0 = sc[0][j], oa1 = sc[1][j], oa2 = sc[2][j];\n",
         "      const long long q0 = clock64();\n"
         "      const float oa0 = sc[0][j], oa1 = sc[1][j], oa2 = sc[2][j];\n"),
        ("      // Sphere cap at a: only at a chain start (uniform across the block).\n",
         "      const long long q1 = clock64();\n      ph_body += q1 - q0;\n"
         "      // Sphere cap at a: only at a chain start (uniform across the block).\n"),
        ("      const float tall = fminf(",
         "      ph_caps += clock64() - q1;\n      const float tall = fminf("),
        ("    }\n  }\n\n  const long long plane",
         "    }\n    ph_loop += clock64() - p1;\n  }\n\n  const long long plane"),
        ("  if (work != nullptr && tid == 0) work[tile] = evaluated;",
         "  if ((tid & 31) == 0) {\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_stage);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_body);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)ph_caps);\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)(ph_loop - ph_body - ph_caps));\n"
         "    atomicAdd(&g_phase[4], (unsigned long long)(clock64() - ph_start));\n  }\n"
         "  if (work != nullptr && tid == 0) work[tile] = evaluated;")],
}
B1_PHASES = ("staging", "body", "caps", "winner", "total")
# The same for csrc/raster_triangle.cu (B3: tiles longest run first, 2 x PIX_ROWS pixels a thread, rows 0-15
# staged slot-major in two buffers, one branch a slot, the slot loop
# unrolled by 4, the winner's planes at the end).
B3_VARIANTS = {
    # Tiles in index order (the same function).
    "index_order": [("  const int tile = order[blockIdx.x];", "  const int tile = blockIdx.x;")],
    # The slot loop not unrolled, or unrolled by 2 (the same function).
    "no_unroll": [("#pragma unroll 4\n    for (int j = 0; j < C; ++j) {",
                   "    for (int j = 0; j < C; ++j) {")],
    "unroll_2": [("#pragma unroll 4\n    for (int j = 0; j < C; ++j) {",
                  "#pragma unroll 2\n    for (int j = 0; j < C; ++j) {")],
    # At most 64 registers (8 resident blocks of 128 per SM).
    "min_blocks_8": [("#define MIN_BLOCKS 4 ", "#define MIN_BLOCKS 8 ")],
    # Two pixels a thread (256 threads at 32x16; the same function).
    "pixel_rows_1": [("#define PIX_ROWS 2 ", "#define PIX_ROWS 1 ")],
    # A warp vote after the first edge plane: a slot whose e0 is negative
    # at every pixel of the warp is left (the same function).
    "edge0_vote": [(
        "#pragma unroll\n      for (int r = 0; r < PIX_ROWS; ++r) {\n        const float e0y",
        "      bool any0 = false;\n#pragma unroll\n      for (int r = 0; r < PIX_ROWS; ++r)\n"
        "#pragma unroll\n        for (int i = 0; i < 2; ++i)\n"
        "          any0 = any0 || ((e0x[i] + A.y * gy[r]) + A.z >= 0.0f);\n"
        "      if (!__any_sync(0xffffffffu, any0)) continue;\n"
        "#pragma unroll\n      for (int r = 0; r < PIX_ROWS; ++r) {\n        const float e0y")],
    # A branch for each pixel, as the first build had it (the same function).
    "branch_per_pixel": [(
        "      if (any) {\n        const float4 D = sb[j * 4 + 3];  // rows 12-15: the id plane\n"
        "#pragma unroll\n        for (int k = 0; k < NPIX; ++k) {\n          if (!cover[k]) continue;\n",
        "      {\n        const float4 D = sb[j * 4 + 3];  // rows 12-15: the id plane\n"
        "#pragma unroll\n        for (int k = 0; k < NPIX; ++k) {\n          if (!cover[k]) continue;\n")],
    # Warp-cycles: the staging with its barrier and early-z, the slot loop,
    # the epilogue (depth, id and the winner's planes), the whole kernel.
    "phase_clock": [
        _PHASE_COUNTERS,
        ("  int evaluated = 0;\n",
         "  int evaluated = 0;\n  long long ph_stage = 0, ph_slot = 0;\n"
         "  const long long ph_start = clock64();\n"),
        ("    float4* const sb = s_slots + (c & 1) * C * 4;\n",
         "    float4* const sb = s_slots + (c & 1) * C * 4;\n    const long long p0 = clock64();\n"),
        ("    ++evaluated;\n",
         "    ++evaluated;\n    const long long p1 = clock64();\n    ph_stage += p1 - p0;\n"),
        ("    }\n  }\n\n  const long long plane",
         "    }\n    ph_slot += clock64() - p1;\n  }\n  const long long p9 = clock64();\n\n"
         "  const long long plane"),
        ("  if (work != nullptr && tid == 0) work[tile] = evaluated;",
         "  if ((tid & 31) == 0) {\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_stage);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_slot);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)(clock64() - p9));\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)(clock64() - ph_start));\n  }\n"
         "  if (work != nullptr && tid == 0) work[tile] = evaluated;")],
}
B3_PHASES = ("staging", "slot_loop", "epilogue", "total")

# The same for csrc/raster_capsule_accum.cu (the accumulation modes of B2:
# tiles longest run first, one thread a pixel in 8x4 warp blocks, votes on
# the discriminants, fragments marked in pass 1 and shaded in pass 2).
_VOTES_OFF = [
    ("      const bool pb = __any_sync(FULL, d.h >= 0.0f);", "      const bool pb = true;"),
    ("      const bool pa = cj[13] > 0.5f && __any_sync(FULL, d.ha >= 0.0f);",
     "      const bool pa = cj[13] > 0.5f;"),
    ("      const bool pc = __any_sync(FULL, d.hb >= 0.0f);", "      const bool pc = true;")]
ACCUM_VARIANTS = {
    # Tiles in index order (the same function).
    "index_order": [("  const int tile = order[blockIdx.x];", "  const int tile = blockIdx.x;")],
    # __launch_bounds__(512): ptxas then holds every instance at 64
    # registers and spills (the same function).
    "launch_bounds_512": [("__global__ void accum_kernel(",
                           "__global__ void __launch_bounds__(MAX_THREADS) accum_kernel(")],
    # No warp votes (the same function).
    "no_votes": _VOTES_OFF,
    # Warps on rows of 32 pixels (the same function).
    "rows_of_32": [("  const bool blocks = tile_w % 8 == 0 && tile_h % 4 == 0;",
                    "  const bool blocks = false;")],
    # Empty tiles walk the set-up like the others (the same function).
    "no_empty_exit": [("  if (count == 0) {  // the whole block",
                       "  if (count < 0) {  // the whole block")],
    # Pass 2 word by word: a warp takes the most fragments of any lane in
    # each mark word, summed over the words (the same function).
    "pass2_per_word": [(
        "      int w = 0;\n      unsigned m = mk[0];\n      for (;;) {\n"
        "        while (m == 0u && ++w < nw) m = mk[w * P];\n        if (m == 0u) break;\n",
        "      for (int w = 0; w < nw; ++w)\n      for (unsigned m = mk[w * P]; m != 0u;) {\n")],
    # Only the first chunk staged (changes the function on longer runs).
    "staged_once": [("    for (int r = warp; r < NROWS; r += P >> 5)\n",
                     "    if (c0 == 0)\n    for (int r = warp; r < NROWS; r += P >> 5)\n")],
    # Pass 1 alone: no fragment shaded or added (changes the function but
    # in 'count').
    "pass1_only": [("      for (;;) {\n        while (m == 0u && ++w < nw)",
                    "      for (; n < 0;) {\n        while (m == 0u && ++w < nw)")],
    # The (warp, candidate) counts of pass 1, into g_phase by lane 0 of each
    # warp: [0] pairs, [1] those with no discriminant >= 0, [2] those with
    # no fragment, [3] the lanes with a fragment, summed, [4] those with a
    # fragment.
    "warp_hits": [
        _PHASE_COUNTERS,
        ("  const int start = tile_start[tile];\n",
         "  unsigned long long wc_[5] = {0, 0, 0, 0, 0};\n  const int start = tile_start[tile];\n"),
        ("      if (!(pb || pa || pc)) continue;\n",
         "      wc_[0] += 1;\n      if (!(pb || pa || pc)) {\n"
         "        wc_[1] += 1;\n        wc_[2] += 1;\n        continue;\n      }\n"
         "      bool frag_ = false;\n"),
        ("        mk[(bit >> 5) * P] |= 1u << (bit & 31);\n      }\n",
         "        mk[(bit >> 5) * P] |= 1u << (bit & 31);\n        frag_ = true;\n      }\n"
         "      const unsigned bf_ = __ballot_sync(FULL, frag_);\n"
         "      wc_[2] += bf_ == 0u;\n      wc_[3] += __popc(bf_);\n      wc_[4] += bf_ != 0u;\n"),
        ("  for (int p = 0; p < 5 * K; ++p) {\n    float v = 0.0f;\n",
         "  if (lane == 0)\n    for (int i = 0; i < 5; ++i) atomicAdd(&g_phase[i], wc_[i]);\n"
         "  for (int p = 0; p < 5 * K; ++p) {\n    float v = 0.0f;\n")],
    # Warp-cycles: staging with its barrier, pass 1, pass 2, the epilogue,
    # the whole kernel (tiles with a run).
    "phase_clock": [
        _PHASE_COUNTERS,
        ("  const int start = tile_start[tile];\n",
         "  long long ph_stage = 0, ph_p1 = 0, ph_p2 = 0;\n"
         "  const long long ph_start = clock64();\n  const int start = tile_start[tile];\n"),
        ("    const int n = min(C, count - c0);\n",
         "    const int n = min(C, count - c0);\n    const long long p0 = clock64();\n"),
        ("    __syncthreads();\n\n    // Pass 1",
         "    __syncthreads();\n    const long long p1 = clock64();\n    ph_stage += p1 - p0;\n\n"
         "    // Pass 1"),
        ("\n    // Pass 2: the marked fragments",
         "    const long long p2 = clock64();\n    ph_p1 += p2 - p1;\n\n"
         "    // Pass 2: the marked fragments"),
        ("      }\n    }\n  }\n\n  for (int p = 0; p < 5 * K; ++p) {",
         "      }\n    }\n    ph_p2 += clock64() - p2;\n  }\n  const long long p9 = clock64();\n\n"
         "  for (int p = 0; p < 5 * K; ++p) {"),
        ("    px[(long long)p * plane] = v;\n  }\n}",
         "    px[(long long)p * plane] = v;\n  }\n"
         "  if (lane == 0) {\n    const long long p10 = clock64();\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_stage);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_p1);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)ph_p2);\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)(p10 - p9));\n"
         "    atomicAdd(&g_phase[4], (unsigned long long)(p10 - ph_start));\n  }\n}")],
}
ACCUM_PHASES = ("staging", "pass1", "pass2", "epilogue", "total")


# The traversal kernels' walk (csrc/bvh_capsule.cuh, inlined into the
# variants' sources): per accepted internal node the record's load (waited
# for by a dummy use), the children's slab tests with their ballots and the
# push; per leaf the leaf work (the warp reconverged); per node taken the
# state-dependent test, and per pop the shared stack's read (waited for).
# Per-lane clocks kept in the walk's counts.
_WALK_PHASES = [
    ("struct WalkCounts {\n  int visits, leaves, warp_visits;\n};",
     "struct WalkCounts {\n  int visits, leaves, warp_visits;\n  long long ph[8];\n};"),
    ("            const float4 l0 = __ldg(q), l1 = __ldg(q + 1), r0 = __ldg(q + 2), "
     "r1 = __ldg(q + 3);\n",
     "            const long long q0 = clock64();\n"
     "            const float4 l0 = __ldg(q), l1 = __ldg(q + 1), r0 = __ldg(q + 2), "
     "r1 = __ldg(q + 3);\n            float q_use;\n"
     '            asm volatile("add.f32 %0, %1, %2;" : "=f"(q_use) : "f"(l0.x), "f"(l1.w));\n'
     '            asm volatile("add.f32 %0, %1, %2;" : "=f"(q_use) : "f"(r0.x), "f"(r1.z));\n'
     "            const long long q1 = clock64();\n            cnt.ph[0] += q1 - q0;\n"),
    ("            my_tn = tnr;\n            ++rd;\n            continue;",
     "            my_tn = tnr;\n            ++rd;\n            cnt.ph[1] += clock64() - q1;\n"
     "            continue;"),
    ("      if (code < 0) {\n        if (acc) {\n          ++cnt.leaves;\n          leaf(~code);\n"
     "        }\n      }",
     "      if (code < 0) {\n        const long long q2 = clock64();\n        if (acc) {\n"
     "          ++cnt.leaves;\n          leaf(~code);\n        }\n        __syncwarp();\n"
     "        cnt.ph[2] += clock64() - q2;\n      }"),
    ("      ++cnt.warp_visits;\n      const bool acc = (mask & bit) && walking && dyn(my_tn);\n",
     "      ++cnt.warp_visits;\n      const long long q3 = clock64();\n"
     "      const bool acc = (mask & bit) && walking && dyn(my_tn);\n"
     "      const unsigned q_any = __ballot_sync(BVH_FULL, acc);\n"
     "      cnt.ph[3] += clock64() - q3 + (q_any & 0);\n"),
    ("    if (sp == 0) break;\n    __syncwarp();\n    --sp;\n    const int4 e = stk.e[sp];\n"
     "    code = e.x;\n    mask = (unsigned)e.y;\n    rd = e.z;\n"
     "    my_tn = stk.tn[sp * 32 + lane];\n  }",
     "    const long long q4 = clock64();\n    if (sp == 0) break;\n    __syncwarp();\n"
     "    --sp;\n    const int4 e = stk.e[sp];\n    code = e.x;\n    mask = (unsigned)e.y;\n"
     "    rd = e.z;\n    my_tn = stk.tn[sp * 32 + lane];\n    float q_pop;\n"
     '    asm volatile("add.f32 %0, %1, %2;" : "=f"(q_pop) : "f"(my_tn), '
     '"f"(__int_as_float(code)));\n'
     "    cnt.ph[3] += clock64() - q4;\n  }"),
]


# The re-cast loop's collapsed walk (csrc/bvh_closest_hit.cu,
# `wide_warp_walk`), the same phases: the record's load (its 8 float4,
# waited for), the four slots' slab tests with their ballots and pushes,
# the leaf work, the state-dependent test and the pop.
_WIDE_PHASES = [
    _WALK_PHASES[0],
    ("        float4 lo[4], hi[4];\n",
     "        const long long q0 = clock64();\n        float4 lo[4], hi[4];\n"),
    ("        float tns[4];\n        unsigned ms[4];\n",
     "        float q_use;\n"
     '        asm volatile("add.f32 %0, %1, %2;" : "=f"(q_use) : "f"(lo[0].x), "f"(hi[3].z));\n'
     '        asm volatile("add.f32 %0, %1, %2;" : "=f"(q_use) : "f"(lo[3].x), "f"(hi[0].z));\n'
     '        asm volatile("add.f32 %0, %1, %2;" : "=f"(q_use) : "f"(lo[1].x), "f"(hi[2].z));\n'
     '        asm volatile("add.f32 %0, %1, %2;" : "=f"(q_use) : "f"(lo[2].x), "f"(hi[1].z));\n'
     "        const long long q1 = clock64();\n        cnt.ph[0] += q1 - q0;\n"
     "        float tns[4];\n        unsigned ms[4];\n"),
    ("        my_tn = tns[0];\n        continue;",
     "        my_tn = tns[0];\n        cnt.ph[1] += clock64() - q1;\n        continue;"),
    ("      if (code < 0) {  // a leaf slot\n        if (acc) {\n          ++cnt.leaves;\n"
     "          leaf(~code);\n        }\n      }",
     "      if (code < 0) {  // a leaf slot\n        const long long q2 = clock64();\n"
     "        if (acc) {\n          ++cnt.leaves;\n          leaf(~code);\n        }\n"
     "        __syncwarp();\n        cnt.ph[2] += clock64() - q2;\n      }"),
    ("      const bool acc = walking && (mask & bit) && dyn(my_tn);\n",
     "      const long long q3 = clock64();\n"
     "      const bool acc = walking && (mask & bit) && dyn(my_tn);\n"
     "      const unsigned q_any = __ballot_sync(BVH_FULL, acc);\n"
     "      cnt.ph[3] += clock64() - q3 + (q_any & 0);\n"),
    ("    mask = (unsigned)e.y;\n    my_tn = stk.tn[sp * 32 + lane];\n  }",
     "    mask = (unsigned)e.y;\n    my_tn = stk.tn[sp * 32 + lane];\n    float q_pop;\n"
     '    asm volatile("add.f32 %0, %1, %2;" : "=f"(q_pop) : "f"(my_tn), '
     '"f"(__int_as_float(code)));\n'
     "    cnt.ph[3] += clock64() - q4;\n  }"),
    ("    if (sp == 0) break;\n    __syncwarp();\n    --sp;\n    const int4 e = stk.e[sp];\n"
     "    code = e.x;\n    mask = (unsigned)e.y;\n    my_tn",
     "    const long long q4 = clock64();\n    if (sp == 0) break;\n    __syncwarp();\n"
     "    --sp;\n    const int4 e = stk.e[sp];\n    code = e.x;\n    mask = (unsigned)e.y;\n"
     "    my_tn"),
]


def _phase_flush(n):
    """Each lane's first `n` phase clocks summed over its warp, added to
    `g_phase` once a warp in warp-cycles (the warp's sum over 32)."""
    return ("#pragma unroll\n  for (int p = 0; p < %d; ++p) {\n    long long v = cnt.ph[p];\n"
            "    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(BVH_FULL, v, o);\n"
            "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase[p], (unsigned long long)(v / 32));\n"
            "  }\n" % n)


# The same for csrc/bvh_closest_hit.cu (R1: the re-cast loop in one launch,
# blocks of 128 rays, a warp-shared walk a cast, the stack in dynamic shared
# memory sized to the tree). Phases: the walk's four,
# the per-cast state update (features, clip, join, flush), the whole kernel.
R1_VARIANTS = {
    # Register budgets of the loop kernel: 6 resident blocks per SM (at most
    # 80 registers) or 10 (at most 48); the base has 8 (64).
    "min_blocks_6": [("__global__ void __launch_bounds__(P, 8)\nrecast_kernel(",
                      "__global__ void __launch_bounds__(P, 6)\nrecast_kernel(")],
    "min_blocks_10": [("__global__ void __launch_bounds__(P, 8)\nrecast_kernel(",
                       "__global__ void __launch_bounds__(P, 10)\nrecast_kernel(")],
    "block_64": [("constexpr int P = 128;  // rays per block", "constexpr int P = 64;")],
    "phase_clock": [
        _PHASE_COUNTERS, *_WIDE_PHASES,
        ("  WalkCounts cnt{0, 0, 0};\n  int c = 0;",
         "  WalkCounts cnt{0, 0, 0};\n  int c = 0;\n  const long long ph_start = clock64();"),
        ("    float attr = 0.0f, c1 = 0.0f, c2 = 0.0f, al = 0.0f;\n",
         "    float attr = 0.0f, c1 = 0.0f, c2 = 0.0f, al = 0.0f;\n    long long u0 = clock64();\n"),
        ("                       overflow);\n      if (rec_t && in) {",
         "                       overflow);\n      u0 = clock64();\n      if (rec_t && in) {"),
        ("    if (end) break;\n",
         "    __syncwarp();\n    cnt.ph[4] += clock64() - u0;\n    if (end) break;\n"),
        ("    if (warp_visits && (threadIdx.x & 31) == 0) warp_visits[r >> 5] = cnt.warp_visits;\n"
         "  }\n}\n\n}  // namespace",
         "    if (warp_visits && (threadIdx.x & 31) == 0) warp_visits[r >> 5] = cnt.warp_visits;\n"
         "  }\n  cnt.ph[5] = clock64() - ph_start;\n" + _phase_flush(6) + "}\n\n}  // namespace")],
}
R1_PHASES = ("node_load", "child_tests", "leaf", "pop_test", "update", "total")

# The same for csrc/bvh_mlat.cu (R2: blocks of 128 rays, a warp-shared walk,
# the K nodes in registers). Phases: the walk's four, the whole kernel, and
# (in `phase_cycles` only, nested in the leaf work) the mean lane's cycles in
# its insertions.
R2_VARIANTS = {
    # Register budgets of the KMAX 8 instance: 8 resident blocks per SM (at
    # most 64 registers) or 6 (80); the base takes what its nodes need.
    "min_blocks_8": [("__launch_bounds__(P)\nmlat_kernel(",
                      "__launch_bounds__(P, KMAX == 8 ? 8 : 1)\nmlat_kernel(")],
    "min_blocks_6": [("__launch_bounds__(P)\nmlat_kernel(",
                      "__launch_bounds__(P, KMAX == 8 ? 6 : 1)\nmlat_kernel(")],
    # The nodes left-aligned (node j at index j, node K-1 found by a runtime
    # compare in the merge, its depth and alpha cached for the cull) at 8
    # blocks an SM: the compiler then keeps the node arrays in local memory.
    "left_aligned_b8": [
        ("__launch_bounds__(P)\nmlat_kernel(",
         "__launch_bounds__(P, KMAX == 8 ? 8 : 1)\nmlat_kernel("),
        ("  const int k0 = KMAX - K;\n", "  const int k0 = 0;\n"),
        ("  int inserts = 0;\n", "  float d_last = INFINITY, a_last = 0.0f;\n  int inserts = 0;\n"),
        ("      [&](float tn) { return (tn <= nd[KMAX - 1]) || !(na[KMAX - 1] > 0.999f); },",
         "      [&](float tn) { return (tn <= d_last) || !(a_last > 0.999f); },"),
        ("            if (j >= k0 && cd < nd[j]) {", "            if (j < K && cd < nd[j]) {"),
        ("          const float w = 1.0f - na[KMAX - 1];\n          if (evict) {\n"
         "            f0[KMAX - 1] = f0[KMAX - 1] + w * c0;\n"
         "            f1[KMAX - 1] = f1[KMAX - 1] + w * c1;\n"
         "            f2[KMAX - 1] = f2[KMAX - 1] + w * c2;\n          }\n"
         "          na[KMAX - 1] = fminf(na[KMAX - 1] + (evict ? w * ca : 0.0f), 1.0f);\n",
         "#pragma unroll\n          for (int j = 0; j < KMAX; ++j) {\n            if (j == K - 1) {\n"
         "              const float w = 1.0f - na[j];\n              if (evict) {\n"
         "                f0[j] = f0[j] + w * c0;\n                f1[j] = f1[j] + w * c1;\n"
         "                f2[j] = f2[j] + w * c2;\n              }\n"
         "              na[j] = fminf(na[j] + (evict ? w * ca : 0.0f), 1.0f);\n"
         "              d_last = nd[j];\n              a_last = na[j];\n            }\n"
         "          }\n"),
        ("    if (j >= k0) {", "    if (j < K) {")],
    "phase_clock": [
        _PHASE_COUNTERS, *_WALK_PHASES,
        ("  int inserts = 0;\n  WalkCounts cnt{0, 0, 0};",
         "  int inserts = 0;\n  WalkCounts cnt{0, 0, 0};\n  const long long ph_start = clock64();"),
        ("          ++inserts;\n", "          ++inserts;\n          const long long i0 = clock64();\n"),
        ("          na[KMAX - 1] = fminf(na[KMAX - 1] + (evict ? w * ca : 0.0f), 1.0f);\n",
         "          na[KMAX - 1] = fminf(na[KMAX - 1] + (evict ? w * ca : 0.0f), 1.0f);\n"
         "          cnt.ph[5] += clock64() - i0;\n"),
        ("      cnt, overflow);\n  if (r >= R) return;",
         "      cnt, overflow);\n  cnt.ph[4] = clock64() - ph_start;\n" + _phase_flush(6)
         + "  if (r >= R) return;")],
}
R2_PHASES = ("node_load", "child_tests", "leaf", "pop_test", "total")


# R3 (csrc/vpt_tracking.cu). The `phase_clock` variants' counters, after
# the volume header: lane 0 of each warp adds its warp's figures.
_R3_COUNTERS = (
    '#include "volume_common.cuh"\n',
    '#include "volume_common.cuh"\n' + _PHASE_COUNTERS[1].split("\n", 1)[1])


def _r3_wait(v):
    """A use of float `v` that the next clock read waits for."""
    return ('    { float q_use; asm volatile("add.f32 %%0, %%1, %%1;" : "=f"(q_use) : "f"(%s)); }\n'
            % v)


def _r3_flush(n_sum):
    """Each lane's first `n_sum` phase clocks summed over its warp (over
    32: warp-cycles), and the warp's longest lane total (ph[n_sum - 1])
    as phase n_sum, added to `g_phase` by lane 0."""
    return ("  __syncwarp();\n  ph[%d] = ph[%d];\n"
            "#pragma unroll\n  for (int p = 0; p <= %d; ++p) {\n    long long v = ph[p];\n"
            "    for (int o = 16; o > 0; o >>= 1) {\n"
            "      const long long u = __shfl_xor_sync(0xffffffffu, v, o);\n"
            "      v = p == %d ? max(v, u) : v + u;\n    }\n"
            "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase[p], "
            "(unsigned long long)(p == %d ? v : v / 32));\n  }\n"
            % (n_sum, n_sum - 1, n_sum, n_sum, n_sum))


# The persistent design (warps take rays from a global counter, a lane
# whose ray dies takes the next; every lane's step draws in the same code).
# `phase_clock`: per lane, the step's draws (every lane), the event step
# (of which the density sample), the scatter step, the refill (every lane:
# the warp's claim and the new rays' set-up), the dead ray's outputs, the
# key and done steps, and the whole kernel; all over 32 (warp-cycles).
# `warp_steps`: the warps' steps with a lane busy.
_R3_LOOP_TOP = "  uint2 key = make_uint2(0u, 0u), kev = make_uint2(0u, 0u);\n  for (;;) {\n"
_R3_END = "      active = false;\n    }\n  }\n}\n"
_R3_SAMPLE = ("        const float dens = SPARSE ? density_at_sparse<INTERP>(sgrid, nz, ny, nx, tp, kk)\n"
              "                                  : density_at<INTERP>(grid, nz, ny, nx, tp, kk);\n")
R3_VARIANTS = {
    "phase_clock": [
        _R3_COUNTERS,
        (_R3_LOOP_TOP,
         _R3_LOOP_TOP.replace("  for (;;) {\n", "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                              "  const long long ph_start = clock64();\n  for (;;) {\n"
                              "    const long long r0 = clock64();\n")),
        ("    if (!__any_sync(0xffffffffu, active)) break;\n",
         "    ph[4] += clock64() - r0;\n    if (!__any_sync(0xffffffffu, active)) break;\n"
         "    const long long c0 = clock64();\n"),
        ("    if (!active) continue;\n    bool done = step == ST_DONE;\n",
         _r3_wait("ua") + _r3_wait("ub") + "    const long long c1 = clock64();\n"
         "    ph[0] += c1 - c0;\n    if (!active) continue;\n    bool done = step == ST_DONE;\n"
         "    const int st0 = step;\n"),
        (_R3_SAMPLE, _r3_wait("tp[2]") + "        const long long c2 = clock64();\n" + _R3_SAMPLE
         + _r3_wait("dens") + "        ph[2] += clock64() - c2;\n"),
        ("    if (done) {  // the ray is dead: its outputs, and the lane is free\n",
         _r3_wait("x.x") + _r3_wait("d") + _r3_wait("wt[0]") + "    const long long c5 = clock64();\n"
         "    ph[st0 == ST_EVENT ? 1 : (st0 == ST_SCATTER ? 3 : 6)] += c5 - c1;\n"
         "    if (done) {\n"),
        (_R3_END,
         "      active = false;\n      ph[5] += clock64() - c5;\n    }\n  }\n"
         "  ph[7] = clock64() - ph_start;\n  __syncwarp();\n"
         "#pragma unroll\n  for (int p = 0; p < 8; ++p) {\n    long long v = ph[p];\n"
         "    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);\n"
         "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase[p], (unsigned long long)(v / 32));\n"
         "  }\n}\n")],
    "warp_steps": [
        _R3_COUNTERS,
        (_R3_LOOP_TOP, _R3_LOOP_TOP.replace("  for (;;) {\n", "  long long steps = 0;\n  for (;;) {\n")),
        ("    if (!active) continue;\n", "    ++steps;\n    if (!active) continue;\n"),
        (_R3_END, "      active = false;\n    }\n  }\n"
         "  if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase[0], (unsigned long long)steps);\n}\n")],
    # Register budgets: no minimum of resident blocks of 128 per SM, or 5, 6
    # or 8 (at most 96, 80 or 64 registers; the base asks for 4, 128).
    **{f"min_blocks_{b or 'none'}": [("__global__ void __launch_bounds__(VPT_THREADS, 4)\nvpt_kernel(",
                            "__global__ void __launch_bounds__(VPT_THREADS%s)\nvpt_kernel("
                            % ("" if b is None else f", {b}"))]
       for b in (None, 5, 6, 8)},
    "threads_256": [("#define VPT_THREADS 128\n", "#define VPT_THREADS 256\n")],
    # The IEEE divisions by the majorant and the extents where they are
    # powers of two (the smoke's 1024 and 1), as for any other divisor.
    "ieee_divisions": [("  const void* f = vpt_instance(mode, interp, pow2);",
                        "  const void* f = vpt_instance(mode, interp, false);")],
    # A warp refills only once 8 or 16 of its lanes are idle (or all), so
    # that its new rays start together, from neighbouring pixels.
    **{f"refill_{n}": [("    while (idle != 0u && !drained) {\n",
                        "    while (idle != 0u && !drained && (__popc(idle) >= %d || idle == ~0u)) {\n"
                        % n)]
       for n in (8, 16)},
}
# The density sample from the linear grid (`volume_common.cuh:trilinear`),
# as before the bricks: the same function when the variant is handed the
# linear grid (`_r3` times it so).
def _r3_sampler(name):
    """Substitutions that make density_at sample with `name`."""
    return [("  if (INTERP == INTERP_TRILINEAR) return trilinear_bricked(grid,",
             f"  if (INTERP == INTERP_TRILINEAR) return {name}(grid,"),
            ("  return trilinear_bricked(grid, nz, ny, nx, q[0], q[1], q[2]);",
             f"  return {name}(grid, nz, ny, nx, q[0], q[1], q[2]);")]


# Bricks of voxel pairs (x, x + 1) or quads (x, x + 1) x (y, y + 1), one
# float2 or float4 a voxel: a sample in four or two vector loads.
_R3_VEC_SAMPLERS = (
    "template <int V>\n__device__ __forceinline__ float trilinear_vec(const float* __restrict__ g,"
    " int nz, int ny,\n    int nx, float px, float py, float pz) {\n"
    "  const float fx = fminf(fmaxf(px, 0.0f), 1.0f) * (float)(nx - 1);\n"
    "  const float fy = fminf(fmaxf(py, 0.0f), 1.0f) * (float)(ny - 1);\n"
    "  const float fz = fminf(fmaxf(pz, 0.0f), 1.0f) * (float)(nz - 1);\n"
    "  const int x0 = min(max((int)floorf(fx), 0), nx - 2);\n"
    "  const int y0 = min(max((int)floorf(fy), 0), ny - 2);\n"
    "  const int z0 = min(max((int)floorf(fz), 0), nz - 2);\n"
    "  const float tx = fx - (float)x0, ty = fy - (float)y0, tz = fz - (float)z0;\n"
    "  const int nyb = (ny + 7) / 8, nxb = (nx + 7) / 8;\n"
    "  auto at = [&](int z, int y, int x) {\n"
    "    const long long b = ((long long)(z >> 3) * nyb + (y >> 3)) * nxb + (x >> 3);\n"
    "    return (b << 9) + ((z & 7) << 6) + ((y & 7) << 3) + (x & 7);\n  };\n"
    "  float c00, c01, c10, c11;\n"
    "  if (V == 4) {\n    const float4* g4 = reinterpret_cast<const float4*>(g);\n"
    "    const float4 a = __ldg(g4 + at(z0, y0, x0)), b = __ldg(g4 + at(z0 + 1, y0, x0));\n"
    "    c00 = a.x * (1.0f - tx) + a.y * tx;\n    c01 = a.z * (1.0f - tx) + a.w * tx;\n"
    "    c10 = b.x * (1.0f - tx) + b.y * tx;\n    c11 = b.z * (1.0f - tx) + b.w * tx;\n"
    "  } else {\n    const float2* g2 = reinterpret_cast<const float2*>(g);\n"
    "    const float2 a = __ldg(g2 + at(z0, y0, x0)), b = __ldg(g2 + at(z0, y0 + 1, x0));\n"
    "    const float2 c = __ldg(g2 + at(z0 + 1, y0, x0)), e = __ldg(g2 + at(z0 + 1, y0 + 1, x0));\n"
    "    c00 = a.x * (1.0f - tx) + a.y * tx;\n    c01 = b.x * (1.0f - tx) + b.y * tx;\n"
    "    c10 = c.x * (1.0f - tx) + c.y * tx;\n    c11 = e.x * (1.0f - tx) + e.y * tx;\n  }\n"
    "  const float c0 = c00 * (1.0f - ty) + c01 * ty;\n"
    "  const float c1 = c10 * (1.0f - ty) + c11 * ty;\n"
    "  return c0 * (1.0f - tz) + c1 * tz;\n}\n"
    "__device__ __forceinline__ float trilinear_pairs(const float* __restrict__ g, int nz, int ny,"
    " int nx,\n    float px, float py, float pz) {\n"
    "  return trilinear_vec<2>(g, nz, ny, nx, px, py, pz);\n}\n"
    "__device__ __forceinline__ float trilinear_quads(const float* __restrict__ g, int nz, int ny,"
    " int nx,\n    float px, float py, float pz) {\n"
    "  return trilinear_vec<4>(g, nz, ny, nx, px, py, pz);\n}\n\n")
# The density sample from other layouts of the grid: the linear grid
# (`volume_common.cuh:trilinear`, as before the bricks), bricks of pairs or
# quads: the same values and arithmetic, so the same function when the
# variant is handed that layout (`_r3` times them so).
R3_LAYOUT_VARIANTS = {
    "linear_grid": _r3_sampler("trilinear"),
    **{f"{k}_bricks": [("template <int INTERP>\n__device__ __forceinline__ float density_at(",
                        _R3_VEC_SAMPLERS + "template <int INTERP>\n__device__ __forceinline__ "
                        "float density_at(")] + _r3_sampler(f"trilinear_{k}")
       for k in ("pairs", "quads")},
}


def _r3_layouts(grid):
    """The grid laid out as each of R3_LAYOUT_VARIANTS reads it."""
    Z, Y, X = grid.shape
    gp = torch.nn.functional.pad(grid, (0, 1, 0, 1))
    vec = {"pairs": torch.stack([grid, gp[:, :Y, 1:]], -1),
           "quads": torch.stack([grid, gp[:, :Y, 1:], gp[:, 1:, :X], gp[:, 1:, 1:]], -1)}
    out = {"linear_grid": grid}
    for k, v in vec.items():
        n = v.shape[-1]
        out[f"{k}_bricks"] = (v.reshape(Z // 8, 8, Y // 8, 8, X // 8, 8, n)
                              .permute(0, 2, 4, 1, 3, 5, 6).contiguous())
    return out
R3_PHASES = ("draws", "event", "sample", "scatter", "refill", "finish", "key_or_done", "total")


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _timed(fn, n=40):
    fn()
    torch.cuda.synchronize()
    a, b = _events()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _build_variants(out_dir: Path, source: str, variants: dict, inline=()):
    """csrc/<source>.cu (with the headers named in `inline` pasted in
    place of their #include) and each of its `variants`, compiled into a
    library each, all nvcc started together -> {name: (path, ptxas lines,
    seconds)}. Stops if the source does not hold a variant's text exactly
    once."""
    from linevis_tpu_torch.kernels import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    for header in inline:
        text = (_build.CSRC / header).read_text().replace("#pragma once\n", "")
        src = src.replace(f'#include "{header}"\n', text)
    out_dir.mkdir(parents=True, exist_ok=True)
    stale = sorted({name for name, subs in variants.items()
                    for old, _ in subs if src.count(old) != 1})
    if stale:
        raise SystemExit(f"{source}.cu no longer matches the variants {stale}")
    jobs = {"base": src}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            text = text.replace(old, new)
        jobs[name] = text

    def compile_one(item):
        name, text = item
        cu = out_dir / f"split_{source}_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libsplit_{source}_{name}.so"
        t0 = time.perf_counter()
        p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                            str(lib), str(cu)], capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{p.stdout}{p.stderr}")
        log = p.stdout + p.stderr
        ptx = [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        return name, (lib, ptx, time.perf_counter() - t0)

    with ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(compile_one, jobs.items()))


def _b5(dev, scene, W, H, res, turns):
    from linevis_tpu_torch.entry import tornado_segment_grid
    from linevis_tpu_torch.kernels import ao_grid
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.rtao import RtaoSettings, ray_batches, rtao_gbuffer, rtao_rays
    from linevis_tpu_torch.render.tube_raster import camera_tensors

    rt = RtaoSettings()
    grid = tornado_segment_grid(scene, rt.grid_resolution)
    settings = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    gbuf = rtao_gbuffer(scene, *cam, settings)
    gen = torch.Generator(device=dev).manual_seed(rt.seed)
    u1 = torch.rand((rt.num_samples, H, W), generator=gen, device=dev)
    u2 = torch.rand((rt.num_samples, H, W), generator=gen, device=dev)
    o, d, t_max, valid = rtao_rays(gbuf, scene.radius, rt, u1, u2)
    s0, s1 = ray_batches(o.shape[1], rt.rays_per_batch)[0]
    pairs = ao_grid.expand_ray_pairs(o[:, s0:s1], d[:, s0:s1], t_max[s0:s1], valid[s0:s1],
                                     grid, rt.max_ray_cells)
    rec, C = grid.records, grid.chunk
    n_chunks = pairs.seg_chunks.shape[0]
    walked = torch.zeros_like(pairs.seg_chunks)
    tests = torch.zeros_like(pairs.seg_chunks)
    occ = ao_grid.trace_pairs(pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C,
                              walked=walked, tests=tests)
    active = torch.nonzero(pairs.seg_chunks > 0).flatten()
    n_active = active.numel()
    prefix = bool(n_active == 0 or int(active[-1]) == n_active - 1)
    w_act = walked[active]
    top = torch.sort(w_act, descending=True)
    longest = int(active[top.indices[0]])

    def run(idx, drop=None):
        sc = pairs.seg_chunks[idx].clone()
        if drop is not None:
            sc[drop] = 0
        cols = (idx[:, None] * C + torch.arange(C, device=dev)).reshape(-1)
        rays = torch.cat([pairs.rays[:, cols], torch.zeros((8, C), device=dev)], 1).contiguous()
        sb = pairs.seg_begin[idx].contiguous()
        return lambda: ao_grid.trace_pairs(rays, sb, sc, rec, C)

    zeros = torch.zeros_like(pairs.seg_chunks)
    res["b5"] = {
        "pairs": n_chunks * C, "pair_chunks": n_chunks, "active_pair_chunks": n_active,
        "active_chunks_are_a_prefix": prefix, "occluded": int(occ.sum()),
        "record_chunks_walked": int(walked.sum()), "tests": int(tests.sum()),
        "longest_walk": int(walked.max()), "longest_walk_chunk": longest,
        "walks_top10": top.values[:10].tolist(),
        "assigned_of_longest": int(pairs.seg_chunks[longest]),
        "ms_as_is": _timed(lambda: ao_grid.trace_pairs(
            pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C)),
        "ms_all_empty": _timed(lambda: ao_grid.trace_pairs(
            pairs.rays, pairs.seg_begin, zeros, rec, C)),
        "ms_active_only": _timed(run(active)),
        "ms_active_without_longest": _timed(run(active, drop=top.indices[0])),
        "ms_longest_alone": _timed(run(active[top.indices[:1]])),
    }
    hist = torch.bincount(w_act.clamp(max=16)).tolist()
    res["b5"]["walk_histogram_to_16"] = hist
    print("b5: " + json.dumps(res["b5"]), flush=True)

    from linevis_tpu_torch.kernels import _build
    libs = _build_variants(_build.BUILD_DIR / "split", "ao_grid", B5_VARIANTS)
    fig = {name: {"ptxas": libs[name][1][-3:], "ms": []} for name in libs}
    for name in libs:
        _build._loaded["ao_grid"] = ctypes.CDLL(str(libs[name][0]))
        fig[name]["equal_to_base"] = bool(torch.equal(ao_grid.trace_pairs(
            pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C), occ))
    for k in range(turns):
        for name in (list(libs) if k % 2 == 0 else list(libs)[::-1]):
            _build._loaded["ao_grid"] = ctypes.CDLL(str(libs[name][0]))
            fig[name]["ms"].append(_timed(lambda: ao_grid.trace_pairs(
                pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C)))
    _build._loaded.pop("ao_grid")
    res["b5_variants"] = fig
    print("b5 variants: " + json.dumps(fig), flush=True)


def _b2(dev, scene, W, H, res, turns):
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.raster_capsule_oit import rasterize_capsules_mlab
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.oit import prepare_mlab_frame
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import camera_tensors, prepare_capsule_frame

    t0 = time.perf_counter()
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_capsule_oit", VARIANTS)
    res["b2_build_s"] = time.perf_counter() - t0
    s = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    csr, params = prepare_mlab_frame(scene, *cam, s, 0.3)
    args = (csr, params, W, H, 16, 8, 8, s.tf_color, s.tf_opacity)
    d1, _, _ = rasterize_capsules_mlab(*args, no_overflow=True)
    peel = torch.where(d1 < 1.5, d1, -1.0).amax(dim=0).contiguous()
    s2 = RasterSettings(width=960, height=528, tile_w=16, tile_h=8)
    csr2, params2, _ = prepare_capsule_frame(scene, *cam, s2)
    modes = {
        "composite": lambda: rasterize_capsules_mlab(
            *args, deferred_shade=True, sub=32, sat=0.999, composite=True),
        "peel_exact": lambda: rasterize_capsules_mlab(*args, peel=peel, no_overflow=True),
        "gather": lambda: rasterize_capsules_mlab(
            csr2, params2, 960, 528, 16, 8, 8, s2.tf_color, s2.tf_opacity, store_mode="gather"),
    }

    def use(name):
        _build._loaded["raster_capsule_oit"] = ctypes.CDLL(str(libs[name][0]))

    def flat(out):
        return out if torch.is_tensor(out) else torch.cat([out[0], out[1].flatten(0, 1), out[2]])

    base_out = {}
    use("base")
    for m, fn in modes.items():
        base_out[m] = flat(fn())
    fig = {name: {"ptxas": libs[name][1][-18:], "nvcc_s": libs[name][2], "ms": {}}
           for name in libs}
    for name in libs:
        use(name)
        fig[name]["equal_to_base"] = {m: bool(torch.equal(flat(fn()), base_out[m]))
                                      for m, fn in modes.items()}
    names = list(libs)
    for k in range(turns):
        for name in (names if k % 2 == 0 else names[::-1]):
            use(name)
            for m, fn in modes.items():
                fig[name]["ms"].setdefault(m, []).append(_timed(fn))
    for name in names:
        lib = ctypes.CDLL(str(libs[name][0]))
        if not hasattr(lib, "read_phase"):
            continue
        _build._loaded["raster_capsule_oit"] = lib
        buf = (ctypes.c_ulonglong * 5)()
        lib.read_phase(buf)  # zero the counters
        fig[name]["phase_share"], fig[name]["phase_cycles"] = {}, {}
        for m, fn in modes.items():
            fn()
            torch.cuda.synchronize()
            lib.read_phase(buf)
            fig[name]["phase_cycles"][m] = list(buf)
            fill, win, total, bar, epi = (float(x) for x in buf)
            # Warp-cycles: the scans, the windows without their scans, the
            # barrier wait, the epilogue, the rest (set-up, staging, bound).
            fig[name]["phase_share"][m] = {
                "fill": fill / total, "windows": (win - fill) / total, "barrier": bar / total,
                "epilogue": epi / total, "other": (total - win - bar - epi) / total}
    res["b2"] = fig
    for name in names:
        brief = {k: v for k, v in fig[name].items() if k != "ptxas"}
        brief["ptxas"] = [ln.replace("ptxas info    : ", "") for ln in fig[name]["ptxas"]
                          if "Used" in ln][-2:]
        print(f"b2 {name}: " + json.dumps(brief), flush=True)


def _kernel_info(lib):
    """Each kernel instance of a library through its `kernel_info` entry
    point: registers, local memory (spills and stack), static and dynamic
    shared memory, threads and resident blocks per SM."""
    fn = lib.kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = []
    for i in range(64):
        v, label = (ctypes.c_int * 6)(), ctypes.create_string_buffer(64)
        rc = fn(i, v, label, 64)
        if rc:
            if not out:
                raise RuntimeError(f"kernel_info failed: CUDA error {rc}")
            break
        out.append({"instance": label.value.decode(), "registers": v[0], "local_bytes": v[1],
                    "static_smem": v[2], "blocks_per_sm": v[3], "threads": v[4],
                    "dynamic_smem": v[5]})
    return out


def _variant_figures(source, libs, modes, turns, phases):
    """Each variant library of `source` in turn: its instances, whether
    every mode's output equals the base's, its times over `turns`, and the
    warp-cycle shares of `phases` where it is named `phase_clock`."""
    from linevis_tpu_torch.kernels import _build

    def use(name):
        lib = ctypes.CDLL(str(libs[name][0]))
        _build._loaded[source] = lib
        return lib

    use("base")
    base_out = {m: [t.clone() for t in fn()] for m, fn in modes.items()}
    fig = {}
    for name in libs:
        lib = use(name)
        fig[name] = {"instances": _kernel_info(lib) if hasattr(lib, "kernel_info") else [],
                     "nvcc_s": libs[name][2], "ms": {},
                     "ptxas": [ln.replace("ptxas info    : ", "") for ln in libs[name][1]
                               if "Used" in ln or "spill" in ln],
                     "equal_to_base": {m: all(torch.equal(a, b) for a, b in zip(fn(), base_out[m]))
                                       for m, fn in modes.items()}}
    names = list(libs)
    for k in range(turns):
        for name in (names if k % 2 == 0 else names[::-1]):
            use(name)
            for m, fn in modes.items():
                fig[name]["ms"].setdefault(m, []).append(_timed(fn))
    for name in names:
        if name != "phase_clock":
            continue
        lib = use(name)
        buf = (ctypes.c_ulonglong * 8)()
        lib.read_phase(buf)  # zero the counters
        fig[name]["phase_share"], fig[name]["phase_cycles"] = {}, {}
        for m, fn in modes.items():
            fn()
            torch.cuda.synchronize()
            lib.read_phase(buf)
            fig[name]["phase_cycles"][m] = list(buf)
            total = float(buf[len(phases) - 1])
            if total == 0.0:  # a mode whose kernel keeps no phase clocks
                continue
            share = {ph: float(buf[i]) / total for i, ph in enumerate(phases[:-1])}
            share["other"] = 1.0 - sum(share.values())
            fig[name]["phase_share"][m] = share
    _build._loaded.pop(source)
    return fig


def _histogram(x, step):
    """Percentiles, maximum and the counts per bin of `step` of int tensor x."""
    xf = x.double()
    return {"mean": float(xf.mean()), "p50": float(xf.quantile(0.5)),
            "p90": float(xf.quantile(0.9)), "p99": float(xf.quantile(0.99)),
            "max": int(x.max()), "bin": step, "counts": torch.bincount(x // step).tolist()}


def _b4(dev, traj, W, H, res, turns):
    import dataclasses

    from linevis_tpu_torch.entry import tornado_prism_scene
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.raster_prism import rasterize_prisms
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import camera_tensors, prepare_prism_frame

    scene = tornado_prism_scene(dev, n_sides=8, traj=traj)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    fig, modes = {}, {}
    for tw, th in ((32, 16), (16, 8)):
        s = RasterSettings(width=W, height=H, tile_w=tw, tile_h=th)
        csr, params, _ = prepare_prism_frame(scene, *cam, s)
        counts = csr.tile_count.long()
        longest = int(counts.argmax())
        alone = torch.zeros_like(csr.tile_count)
        alone[longest] = csr.tile_count[longest]
        csr_alone = dataclasses.replace(csr, tile_count=alone)

        def run(c=csr, tw=tw, th=th, p=params):
            z, ids, g = rasterize_prisms(c, p, W, H, tw, th, n_sides=8)
            return [z, ids, *g]

        key = f"{tw}x{th}"
        modes[key] = run
        fig[key] = {"tiles": counts.numel(), "pairs": int(counts.sum()),
                    "candidates_per_tile": _histogram(counts, 16),
                    "longest_tile": longest, "ms_as_is": _timed(run),
                    "ms_longest_tile_alone": _timed(lambda r=run, c=csr_alone: r(c))}
        print(f"b4 {key}: " + json.dumps(fig[key]), flush=True)
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_prism", B4_VARIANTS)
    fig["variants"] = _variant_figures("raster_prism", libs, modes, turns, B4_PHASES)
    for name, v in fig["variants"].items():
        print(f"b4 {name}: " + json.dumps(v), flush=True)
    res["b4"] = fig


def _b6(dev, scene, W, H, res, turns):
    from linevis_tpu_torch.entry import tornado_wide_bvh
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.bvh_wavefront import trace_wavefront_kbuffer
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.ray_tracer import primary_rays
    from linevis_tpu_torch.render.tube_raster import camera_tensors

    groups, setup = tornado_wide_bvh(scene, builder="binned_sah")
    s = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    rays = primary_rays(cam[0], cam[1], s, 1e6)
    n_blocks = rays.shape[1] // 128

    def run(r=rays, stats=None):
        out = trace_wavefront_kbuffer(groups, r, cam[2], K=8, opacity=0.3,
                                      tf_opacity=s.tf_opacity, stats=stats)
        return [out[0], out[1], out[2]] + ([] if stats is None else [stats])

    stats = torch.zeros((n_blocks, 6), dtype=torch.int64, device=dev)
    run(stats=stats)
    busiest = int(stats[:, 0].argmax())
    rays_b = rays[:, busiest * 128:(busiest + 1) * 128].contiguous()
    fig = {"ray_blocks": n_blocks, "groups": groups.shape[0] // 8, "bvh_build_s": setup,
           "visits_per_block": _histogram(stats[:, 0], 4),
           "leaf_visits_per_block": _histogram(stats[:, 1], 4),
           "sweeps_per_block": _histogram(stats[:, 3], 16),
           "totals": stats.sum(dim=0).tolist(), "busiest_block": busiest,
           "ms_as_is": _timed(run), "ms_busiest_block_alone": _timed(lambda: run(rays_b))}
    print("b6: " + json.dumps(fig), flush=True)
    p_stats = torch.zeros_like(stats)
    modes = {"k8_mlab": lambda: run(stats=p_stats)}
    libs = _build_variants(_build.BUILD_DIR / "split", "bvh_wavefront", B6_VARIANTS)
    fig["variants"] = _variant_figures("bvh_wavefront", libs, modes, turns, B6_PHASES)
    for name, v in fig["variants"].items():
        print(f"b6 {name}: " + json.dumps(v), flush=True)
    res["b6"] = fig


def _differing(k, p):
    """Per output plane, the pixels where kernel and plain version differ
    (NaN equals NaN)."""
    return [int((~((a == b) | (a.isnan() & b.isnan()))).sum()) for a, b in zip(k, p)]


def _b1(dev, scene, W, H, res, turns):
    import dataclasses

    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.raster_capsule import (
        rasterize_capsules, rasterize_capsules_reference)
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import camera_tensors, prepare_capsule_frame

    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    # The capsule frame (coverage AA, 0.5 px of cull slack) at both tiles,
    # and the RTAO G-buffer's pass (no AA, no slack).
    cases = {"aa_32x16": (32, 16, True), "no_aa_32x16": (32, 16, False), "aa_16x8": (16, 8, True)}
    fig, modes = {}, {}
    for key, (tw, th, aa) in cases.items():
        s = RasterSettings(width=W, height=H, tile_w=tw, tile_h=th)
        csr, params, _ = prepare_capsule_frame(scene, *cam, s, aa_margin=0.5 if aa else 0.0)
        counts = csr.tile_count.long()
        longest = int(counts.argmax())
        alone = torch.zeros_like(csr.tile_count)
        alone[longest] = csr.tile_count[longest]

        def run(c=csr, tw=tw, th=th, p=params, aa=aa):
            z, ids, g = rasterize_capsules(c, p, W, H, tw, th, use_aa=aa)
            return [z, ids, *g]

        k = run()
        pz, pids, pg = rasterize_capsules_reference(csr, params, W, H, tw, th, use_aa=aa)
        diff = _differing(k, [pz, pids, *pg])
        modes[key] = run
        if key == "aa_32x16":
            modes["aa_32x16_longest_tile_alone"] = (
                lambda r=run, c=dataclasses.replace(csr, tile_count=alone): r(c))
        fig[key] = {"tiles": counts.numel(), "pairs": int(counts.sum()),
                    "start_caps": int((csr.payload[13, :int(counts.sum())] > 0.5).sum()),
                    "candidates_per_tile": _histogram(counts, 16), "longest_tile": longest,
                    "longest_tile_rank_in_index_order": longest / counts.numel(),
                    "equal_to_plain": sum(diff) == 0, "pixels_differing_per_plane": diff,
                    "ms_as_is": _timed(run),
                    "ms_longest_tile_alone": _timed(
                        lambda r=run, c=dataclasses.replace(csr, tile_count=alone): r(c))}
        print(f"b1 {key}: " + json.dumps(fig[key]), flush=True)
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_capsule", B1_VARIANTS)
    fig["variants"] = _variant_figures("raster_capsule", libs, modes, turns, B1_PHASES)
    for name, v in fig["variants"].items():
        print(f"b1 {name}: " + json.dumps(v), flush=True)
    res["b1"] = fig


def _b3(dev, traj, W, H, res, turns):
    import dataclasses

    from linevis_tpu_torch.entry import tornado_tube_mesh
    from linevis_tpu_torch.kernels import _build, raster_pallas
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import (
        RasterSettings, build_payload, tube_vertex_stage)
    from linevis_tpu_torch.render.tube_raster import camera_tensors

    mesh = tornado_tube_mesh(dev, num_subdivisions=8, traj=traj)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    s = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    batch = tube_vertex_stage(mesh, cam[0], W, H)
    csr = raster_pallas.build_csr_binning(
        batch.tri_x, batch.tri_y, build_payload(batch), batch.tri_valid, W, H,
        s.tile_w, s.tile_h, s.chunk, s.span_x, s.span_y, s.pairs_capacity)
    del batch, mesh
    nch = csr.tile_num_chunks.long()
    longest = int(nch.argmax())
    alone = torch.zeros_like(csr.tile_num_chunks)
    alone[longest] = csr.tile_num_chunks[longest]
    csr_alone = dataclasses.replace(csr, tile_num_chunks=alone)

    def run(c=csr, planes=8):
        z, ids, g = raster_pallas.rasterize_gbuffer(c, planes, 32, 16)
        return [z, ids, *g]

    modes = {"gbuffer_32x16": run, "depth_32x16": lambda: run(planes=0),
             "gbuffer_32x16_longest_tile_alone": lambda: run(csr_alone)}
    real = (csr.payload[15] < 2.5).sum(dim=1)
    fig = {"tiles": nch.numel(), "chunks": int(nch.sum()), "pairs": int(real.sum()),
           "chunks_per_tile": _histogram(nch, 1), "longest_tile": longest,
           "longest_tile_rank_in_index_order": longest / nch.numel(),
           "ms_as_is": {m: _timed(fn) for m, fn in modes.items()},
           "ms_longest_tile_alone": _timed(lambda: run(csr_alone))}
    print("b3: " + json.dumps(fig), flush=True)
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_triangle", B3_VARIANTS)
    fig["variants"] = _variant_figures("raster_triangle", libs, modes, turns, B3_PHASES)
    for name, v in fig["variants"].items():
        print(f"b3 {name}: " + json.dumps(v), flush=True)
    res["b3"] = fig


def _accum(dev, scene, W, H, res, turns):
    import dataclasses

    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.raster_capsule_oit import (
        rasterize_capsules_mlab, rasterize_capsules_mlab_reference)
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.oit import prepare_mboit_frame
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import camera_tensors, prepare_capsule_frame

    s = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    # 'count' and 'wboit' on the capsule binning, the MBOIT passes (4 power
    # moments) on prepare_mboit_frame's, as chip_smoke.py checks them.
    csr, params, _ = prepare_capsule_frame(scene, *cam, s)
    params[14] = 0.3
    csr_m, params_m, _ = prepare_mboit_frame(scene, *cam, s, 4, 0.3)
    if not (torch.equal(csr.tile_count, csr_m.tile_count)
            and torch.equal(csr.tile_start, csr_m.tile_start)):
        raise SystemExit("the capsule and the MBOIT binnings differ")
    counts = csr.tile_count.long()
    longest = int(counts.argmax())
    alone = torch.zeros_like(csr.tile_count)
    alone[longest] = csr.tile_count[longest]
    csr_alone = dataclasses.replace(csr, tile_count=alone)
    # The 132 longest runs (one a SM) alone, and every run but them.
    top = csr.longest_first[:132].long()
    top_alone = torch.zeros_like(csr.tile_count)
    top_alone[top] = csr.tile_count[top]
    without_top = csr.tile_count.clone()
    without_top[top] = 0
    csr_top = dataclasses.replace(csr, tile_count=top_alone)
    csr_rest = dataclasses.replace(csr, tile_count=without_top)
    tf = (s.tf_color, s.tf_opacity)

    def flat(out):
        return [out[0], out[1].flatten(0, 1), out[2]]

    def call(mode, c=csr, p=params, K=1, fn=rasterize_capsules_mlab, **kw):
        return flat(fn(c, p, W, H, 16, 8, K, *tf, store_mode=mode, **kw))

    gen = call("mboit_gen", csr_m, params_m, 2, n_mom=4)
    d, rgb = gen[0], gen[1].reshape(3, 2, *gen[0].shape[1:])
    moments = torch.stack([d[0], rgb[0, 0], rgb[1, 0], d[1], rgb[0, 1]]).contiguous()
    csr_t, params_t, _ = prepare_mboit_frame(scene, *cam, s, 8, 0.3, trigonometric=True)
    gen_t = call("mboit_gen", csr_t, params_t, 2, n_mom=8, trig=True)
    d, rgb, a = gen_t[0], gen_t[1].reshape(3, 2, *gen_t[0].shape[1:]), gen_t[2]
    moments_t = torch.stack([d[0], rgb[0, 0], rgb[1, 0], rgb[2, 0], a[0],
                             d[1], rgb[0, 1], rgb[1, 1], rgb[2, 1]]).contiguous()
    modes = {
        "count": lambda: call("count"),
        "wboit": lambda: call("wboit"),
        "mboit_gen": lambda: call("mboit_gen", csr_m, params_m, 2, n_mom=4),
        "mboit_resolve": lambda: call("mboit_resolve", csr_m, params_m, n_mom=4,
                                      moments=moments),
        "mboit_resolve_trig8": lambda: call("mboit_resolve", csr_t, params_t, n_mom=8,
                                            trig=True, moments=moments_t),
        "wboit_longest_tile_alone": lambda: call("wboit", csr_alone),
        "count_longest_132_alone": lambda: call("count", csr_top),
        "count_without_longest_132": lambda: call("count", csr_rest),
    }
    plain = {
        "count": call("count", fn=rasterize_capsules_mlab_reference),
        "wboit": call("wboit", fn=rasterize_capsules_mlab_reference),
        "mboit_gen": call("mboit_gen", csr_m, params_m, 2, n_mom=4,
                          fn=rasterize_capsules_mlab_reference),
        "mboit_resolve": call("mboit_resolve", csr_m, params_m, n_mom=4, moments=moments,
                              fn=rasterize_capsules_mlab_reference),
        "mboit_resolve_trig8": call("mboit_resolve", csr_t, params_t, n_mom=8, trig=True,
                                    moments=moments_t, fn=rasterize_capsules_mlab_reference)}
    frags = modes["count"]()[0][0]
    fig = {"tiles": counts.numel(), "pairs": int(counts.sum()),
           "fragments": int(frags.sum()), "pixels_with_fragments": int((frags > 0).sum()),
           "pixels_resolved": int((moments[0] >= 0.00100050033).sum()),
           "fragments_resolved": int(frags[moments[0] >= 0.00100050033].sum()),
           "candidates_per_tile": _histogram(counts, 16), "longest_tile": longest,
           "longest_tile_rank_in_index_order": longest / counts.numel(),
           "equal_to_plain": {}, "pixels_differing_per_plane": {},
           "ms_as_is": {m: _timed(fn) for m, fn in modes.items()}}
    for m, p in plain.items():
        diff = _differing(modes[m](), p)
        fig["equal_to_plain"][m] = sum(diff) == 0
        fig["pixels_differing_per_plane"][m] = diff
    print("accum: " + json.dumps(fig), flush=True)

    t0 = time.perf_counter()
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_capsule_accum", ACCUM_VARIANTS)
    fig["build_s"] = time.perf_counter() - t0
    fig["variants"] = _variant_figures("raster_capsule_accum", libs, modes, turns,
                                       ACCUM_PHASES)
    for name in [n for n in libs if n.startswith("warp_hits")]:
        lib = ctypes.CDLL(str(libs[name][0]))
        _build._loaded["raster_capsule_accum"] = lib
        buf = (ctypes.c_ulonglong * 8)()
        lib.read_phase(buf)  # zero the counters
        modes["count"]()
        torch.cuda.synchronize()
        lib.read_phase(buf)
        n, no_disc, no_frag, lanes, with_frag = (int(x) for x in buf[:5])
        fig["variants"][name]["warp_candidates"] = {
            "pairs": n, "no_discriminant_share": no_disc / n, "no_fragment_share": no_frag / n,
            "lanes_per_pair_with_a_fragment": lanes / max(with_frag, 1)}
    _build._loaded.pop("raster_capsule_accum", None)
    for name, v in fig["variants"].items():
        print(f"accum {name}: " + json.dumps({k: x for k, x in v.items() if k != "ptxas"}),
              flush=True)
    res["accum"] = fig


def _ray_tracer_inputs(dev, scene, W, H):
    from linevis_tpu_torch.ops.lbvh import lbvh_on
    from linevis_tpu_torch.render import ray_tracer as rt
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import camera_tensors

    s = RasterSettings(width=W, height=H)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    tree = lbvh_on(rt.build_capsule_bvh(scene), dev)
    return rt, s, cam, tree, rt.tile_rays(cam[0], cam[1], s)


def _warp_figures(lane_visits, warp_visits):
    """A walk's node pops: per ray, per warp, and each warp's against its
    longest and its mean lane."""
    lanes = lane_visits.reshape(-1, 32).double()
    w = warp_visits.double()
    live = lanes.max(dim=1).values > 0
    return {"ray_visits": int(lane_visits.sum()), "warp_visits": int(warp_visits.sum()),
            "warp_over_longest_lane": _histogram(
                (w[live] / lanes.max(dim=1).values[live] * 10).long(), 5),
            "warp_over_mean_lane_mean": float((w[live] / lanes.mean(dim=1)[live]).mean()),
            "sum_warp_over_sum_longest_lane": float(w.sum() / lanes.max(dim=1).values.sum()),
            "sum_warp_x32_over_sum_lanes": float(w.sum() * 32 / lanes.sum())}


def _r1(dev, scene, W, H, res, turns):
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels import bvh_closest_hit as ch

    rt, s, cam, tree, (o, d, wz, pad) = _ray_tracer_inputs(dev, scene, W, H)
    dmin, dmax = rt._depth_cue_range(scene, cam[0])
    R, casts = o.shape[0], 32
    args = (tree, scene, o, d, wz, pad, cam[2], s, casts, 0.3, dmin, dmax)
    # Each ray's binary-walk visits and leaf tests over the loop's casts,
    # from the one-cast kernel through the plain loop, and its warps' tests.
    st = torch.zeros((R, 2), dtype=torch.int64, device=dev)
    wv = torch.zeros(R // 32, dtype=torch.int64, device=dev)

    def counted(*a):
        s1, w1 = torch.zeros_like(st), torch.zeros_like(wv)
        out = ch.capsule_closest_hit(*a, stats=s1, warp_visits=w1)
        st.add_(s1)
        wv.add_(w1)
        return out

    rt.trace_recast(*args, closest_hit=counted)
    wide_wv = torch.zeros_like(wv)
    rt.capsule_recast(*args, warp_visits=wide_wv)  # the loop kernel's collapsed walk
    t0 = torch.zeros(R, device=dev)
    p0 = torch.full((R,), 2 ** 31 - 1, dtype=torch.int32, device=dev)
    st1 = torch.zeros_like(st)
    wv1 = torch.zeros_like(wv)
    ch.capsule_closest_hit(tree, scene, o, d, t0, p0, pad, stats=st1, warp_visits=wv1)
    fig = {"rays": R, "casts": casts, "loop": _warp_figures(st[:, 0], wide_wv),
           "one_cast_kernels_loop": _warp_figures(st[:, 0], wv),
           "leaf_tests": int(st[:, 1].sum()), "first_cast": _warp_figures(st1[:, 0], wv1),
           "ray_visits_per_warp_first_cast": _histogram(st1[:, 0].reshape(-1, 32).max(dim=1)
                                                        .values, 256)}
    print("r1: " + json.dumps(fig), flush=True)

    def loop():
        return list(rt.capsule_recast(*args))

    def first_cast():
        return list(ch.capsule_closest_hit(tree, scene, o, d, t0, p0, pad))

    modes = {"recast_32": loop, "closest_hit_first_cast": first_cast}
    libs = _build_variants(_build.BUILD_DIR / "split", "bvh_closest_hit", R1_VARIANTS,
                           inline=("bvh_capsule.cuh",))
    fig["variants"] = _variant_figures("bvh_closest_hit", libs, modes, turns, R1_PHASES)
    for name, v in fig["variants"].items():
        print(f"r1 {name}: " + json.dumps(v), flush=True)
    res["r1"] = fig


def _r2(dev, scene, W, H, res, turns):
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.bvh_mlat import mlat_nodes

    rt, s, cam, tree, (o, d, wz, pad) = _ray_tracer_inputs(dev, scene, W, H)
    R = o.shape[0]
    fig = {"rays": R}
    modes = {}
    for K in (8, 32):
        st = torch.zeros((R, 3), dtype=torch.int64, device=dev)
        wv = torch.zeros(R // 32, dtype=torch.int64, device=dev)
        kw = dict(K=K, opacity=0.3, tf_opacity=s.tf_opacity)
        mlat_nodes(tree, scene, o, d, wz, pad, cam[2], stats=st, warp_visits=wv, **kw)
        fig[f"k{K}"] = {**_warp_figures(st[:, 0], wv), "leaf_tests": int(st[:, 1].sum()),
                        "inserts": int(st[:, 2].sum())}
        modes[f"mlat_k{K}"] = (lambda kw=kw: list(mlat_nodes(tree, scene, o, d, wz, pad, cam[2],
                                                             **kw)))
    print("r2: " + json.dumps(fig), flush=True)
    libs = _build_variants(_build.BUILD_DIR / "split", "bvh_mlat", R2_VARIANTS,
                           inline=("bvh_capsule.cuh",))
    fig["variants"] = _variant_figures("bvh_mlat", libs, modes, turns, R2_PHASES)
    for name, v in fig["variants"].items():
        print(f"r2 {name}: " + json.dumps(v), flush=True)
    res["r2"] = fig


# R5 (csrc/spherical_heatmap.cu): the tile culled sum. The scan alone (the
# walk skipped: a variant that changes the result), other tiles, unrolls and
# threads a pixel, two directions a thread a round, the IEEE term (the same
# function).
R5_VARIANTS = {
    "scan_only": [("    if (nb > 0 && (nb > HM_CAP - HM_ROUND || base + HM_ROUND >= n)) {\n",
                   "    if (nb < 0) {\n"),
                  ("    nb += total;\n", "    nb = 0;\n")],
    "tile_16x16": [("#define HM_TW 16\n#define HM_TH 8\n", "#define HM_TW 16\n#define HM_TH 16\n")],
    "tile_8x8": [("#define HM_TW 16\n#define HM_TH 8\n", "#define HM_TW 8\n#define HM_TH 8\n")],
    "unroll_4": [("#define HM_UNROLL 8 ", "#define HM_UNROLL 4 ")],
    "tpp_1": [("#define HM_TPP 2 ", "#define HM_TPP 1 ")],
    "tpp_4": [("#define HM_TPP 2 ", "#define HM_TPP 4 ")],
    "tpp_4_unroll_4": [("#define HM_TPP 2 ", "#define HM_TPP 4 "),
                       ("#define HM_UNROLL 8 ", "#define HM_UNROLL 4 ")],
    "dpt_2": [("#define HM_DPT 4 ", "#define HM_DPT 2 ")],
    # The walk's term as the library computes it (IEEE sqrtf and division,
    # with their slow-path branches): the same function.
    "ieee_term": [("          t[u] = hm_term(kk < nb", "          t[u] = hm_term_ieee(kk < nb")],
}


def _r5(dev, H, res, turns):
    """R5 on `chip_smoke.py`'s 1080x2160 heat map of the traced cloud's exit
    directions: the kernel's counts (candidates and pairs in range per tile)
    and the tree's kernel against `R5_VARIANTS`."""
    from linevis_tpu_torch import entry
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels import spherical_heatmap as shm
    from linevis_tpu_torch.render.spherical_heatmap import mollweide_points

    dirs = torch.as_tensor(entry.scattering_line_data(dev).exit_directions, device=dev)
    pts, _ = mollweide_points(H, dev)
    tx, ty = shm.heatmap_tiles(pts.shape[0], 2 * H)
    counts = torch.zeros((tx * ty, 2), dtype=torch.int64, device=dev)
    shm.heatmap_density(pts, dirs, 2 * H, counts)
    n_pairs = pts.shape[0] * dirs.shape[0]
    fig = {"pixels": pts.shape[0], "directions": dirs.shape[0], "tiles": tx * ty,
           "pairs_in_range": int(counts[:, 1].sum()), "candidates": int(counts[:, 0].sum()),
           "candidate_share_of_pairs": float(counts[:, 0].sum()) / n_pairs,
           "candidates_per_tile": _histogram(counts[:, 0], 2048),
           "in_range_per_tile": _histogram(counts[:, 1], 1 << 20)}
    print("r5: " + json.dumps(fig), flush=True)
    modes = {"map_1080": lambda: [shm.heatmap_density(pts, dirs, 2 * H)]}
    libs = _build_variants(_build.BUILD_DIR / "split", "spherical_heatmap", R5_VARIANTS)
    fig["variants"] = _variant_figures("spherical_heatmap", libs, modes, turns, ())
    fig["term_mismatches_every_float"] = shm.heatmap_term_mismatches(dev)
    for name, v in fig["variants"].items():
        print(f"r5 {name}: " + json.dumps({k: v[k] for k in ("ms", "equal_to_base", "ptxas")}),
              flush=True)
    print("r5 term mismatches: " + str(fig["term_mismatches_every_float"]), flush=True)
    res["r5"] = fig


def _r3_inputs(dev, W, H):
    """`chip_smoke.py`'s first path-traced sample: the 512^3 cloud, its
    camera's 1080p rays and trace key, the renderer's defaults (Delta
    tracking, trilinear, extinction 1024, 512 events)."""
    from linevis_tpu_torch import entry
    from linevis_tpu_torch.kernels import vpt_tracking as vt
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.tube_raster import _ray_basis, camera_tensors
    from linevis_tpu_torch.render.vpt import VptSettings, primary_rays, sun_constants

    grid = entry.procedural_cloud(dev)
    vs = VptSettings()
    cam = camera_tensors(Camera(position=(0.0, 0.15, 0.9), look_at_point=(0.0, 0.0, 0.0),
                                width=W, height=H), dev)
    _, kt, o, d = primary_rays(threefry.prng_key(0, dev), cam[1], _ray_basis(cam[0]), W, H)
    p = vt.vpt_params(grid.shape, vs.extinction, vs.scattering_albedo, *sun_constants(vs),
                      vs.phase_g, vs.mode, vs.max_events, vs.interpolation)
    return vt, grid, o, d, kt, p


def _warp_efficiency(events):
    """Lockstep warps of 32 consecutive rays: the events run over the
    lane-events their warps hold, sum(events) / sum over warps of 32 x the
    warp's most."""
    e = events.reshape(-1, 32).double()
    return float(e.sum() / (32.0 * e.max(dim=1).values.sum()))


def _r3(dev, W, H, res, turns):
    from linevis_tpu_torch.kernels import _build

    vt, grid, o, d, kt, p = _r3_inputs(dev, W, H)
    ev = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    sc = torch.zeros_like(ev)
    vt.vpt_tracking(grid, o, d, kt, p, events=ev, scatters=sc)
    evd = ev.double()
    fig = {"rays": o.shape[0], "events": int(evd.sum()), "scatters": int(sc.sum()),
           "rays_in_the_box": int((ev > 0).sum()), "events_mean": float(evd.mean()),
           "events_max": int(ev.max()), "events_p99": float(evd.quantile(0.99)),
           "warp_efficiency_lockstep_32": _warp_efficiency(ev),
           "warp_efficiency_sorted_32": _warp_efficiency(torch.sort(ev).values),
           "events_histogram": _histogram(ev.long(), 32)}
    print("r3: " + json.dumps(fig), flush=True)
    modes = {"delta_1080p": lambda: list(vt.vpt_tracking(grid, o, d, kt, p))}
    libs = _build_variants(_build.BUILD_DIR / "split", "vpt_tracking", R3_VARIANTS)
    fig["variants"] = _variant_figures("vpt_tracking", libs, modes, turns, R3_PHASES)
    pc = fig["variants"]["phase_clock"]["phase_cycles"]["delta_1080p"]
    total = float(pc[len(R3_PHASES) - 1])
    fig["phase_share_of_warp_cycles"] = {ph: pc[i] / total
                                         for i, ph in enumerate(R3_PHASES[:-1])}
    # The lanes' use: events over 32 x the warps' busy steps.
    lib = ctypes.CDLL(str(libs["warp_steps"][0]))
    _build._loaded["vpt_tracking"] = lib
    buf = (ctypes.c_ulonglong * 8)()
    lib.read_phase(buf)
    modes["delta_1080p"]()
    torch.cuda.synchronize()
    lib.read_phase(buf)
    _build._loaded.pop("vpt_tracking")
    fig["warp_steps"] = int(buf[0])
    fig["warp_efficiency_persistent"] = fig["events"] / (32.0 * buf[0])
    # Lane-steps with work: events, scatter steps, key steps.
    fig["lane_use_persistent"] = (fig["events"] + fig["scatters"]
                                  + fig["rays_in_the_box"]) / (32.0 * buf[0])
    # The other layouts' variants, in turns with the base on the bricks.
    grids = {"base": grid}
    for name, layout in _r3_layouts(grid).items():
        g = grid.clone()  # a grid whose bricks the wrapper finds made: this layout
        g._vpt_bricks = (g._version, layout)
        grids[name] = g
    llibs = _build_variants(_build.BUILD_DIR / "split_layout", "vpt_tracking",
                            R3_LAYOUT_VARIANTS)
    base_out = [t.clone() for t in modes["delta_1080p"]()]
    fig["layouts"] = {}
    for k in range(turns):
        for name in (list(llibs) if k % 2 == 0 else list(llibs)[::-1]):
            _build._loaded["vpt_tracking"] = ctypes.CDLL(str(llibs[name][0]))
            run = (lambda g=grids[name]: list(vt.vpt_tracking(g, o, d, kt, p)))
            f = fig["layouts"].setdefault(name, {"ms": [], "equal_to_base": all(
                torch.equal(a, b) for a, b in zip(run(), base_out)), "ptxas": [
                    ln for ln in llibs[name][1] if "Used" in ln][:1]})
            f["ms"].append(_timed(run, n=10))
    _build._loaded.pop("vpt_tracking")
    del grids
    print("r3 layouts: " + json.dumps(fig["layouts"]), flush=True)
    for name, v in fig["variants"].items():
        print(f"r3 {name}: " + json.dumps(v), flush=True)
    print("r3 phase shares: " + json.dumps(fig["phase_share_of_warp_cycles"]), flush=True)
    print("r3 lanes: " + json.dumps({k: fig.get(k) for k in (
        "warp_efficiency_lockstep_32", "warp_steps", "warp_efficiency_persistent",
        "lane_use_persistent", "events", "scatters")}), flush=True)
    res["r3"] = fig


# R7 (csrc/vpt_decomposition.cu) and R8 (csrc/vpt_residual_ratio.cu). Each
# design of a kernel has its own variants; `_matching_variants` takes the set
# whose texts the tree's source holds, so the script splits the first
# designs (one thread a ray, `*_ONE_THREAD_A_RAY`) in a tree that
# has them as well as the persistent designs.
def _wait_u32(v):
    """A use of uint32 `v` that the next clock read waits for."""
    return ('    { unsigned q_use; asm volatile("add.u32 %%0, %%1, %%1;" : "=r"(q_use) : "r"(%s)); }\n'
            % v)


def _clocked(text, phase, label, waits, indent="    "):
    """`text` (whole statements) timed into ph[phase] (clock `q_<label>`),
    its results waited for."""
    return (f"{indent}const long long q_{label} = clock64();\n" + text + "".join(waits)
            + f"{indent}ph[{phase}] += clock64() - q_{label};\n")


def _per_thread_flush(n):
    """Each thread's n phase clocks added to `g_phase` (lane-cycles)."""
    return ("#pragma unroll\n  for (int p = 0; p < %d; ++p) atomicAdd(&g_phase[p], "
            "(unsigned long long)ph[p]);\n" % n)


# R7's first design: one thread a ray. `phase_clock`: the draws (every threefry),
# the super voxel's state (its min and max, mu_c, mu_r, the exit face's six
# divisions), the density sample (with its three divisions), the whole
# thread; lane-cycles (a finished thread stops counting).
_R7A_KJ = "    const uint2 kj = tf_split(key, (uint32_t)j);\n"
_R7A_U = "        const float u%d = tf_uniform(tf_split(kj, %du));\n"
_R7A_U1 = "      const float u1 = tf_uniform(tf_split(kj, 1u));\n"
_R7A_U2 = "          const float u2 = tf_uniform(tf_split(kj, 2u));\n"
_R7A_SV0 = "    const int ix = (int)fminf(fmaxf(idx[0], 0.0f), svn[0] - 1.0f);\n"
_R7A_SV1 = "    const float d_seg = fmaxf(fminf(fminf(t_far[0], t_far[1]), t_far[2]), 0.0f);\n"
_R7A_SAMPLE = ("          const float dens = trilinear_bricked(\n"
               "              grid, nz, ny, nx, (xh[0] - bmin[0]) / extent[0], (xh[1] - bmin[1]) / extent[1],\n"
               "              (xh[2] - bmin[2]) / extent[2]);\n")
_R7A_SCATTER = ("        const uint2 k5 = tf_split(kj, 4u);\n"
                "        const V3 wn = sample_phase(tf_uniform(tf_split(k5, 0u)), tf_uniform(tf_split(k5, 1u)), pc,\n"
                "                                   V3{w[0], w[1], w[2]});\n")
_R7A_TOP = "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n  if (i >= N) return;\n"
_R7A_END = "  if (events != nullptr) events[i] = ev;\n}\n"
R7_VARIANTS_ONE_THREAD_A_RAY = {
    "phase_clock": [
        _R3_COUNTERS,
        (_R7A_TOP, _R7A_TOP + "  long long ph[4] = {0, 0, 0, 0};\n"
         "  const long long ph_start = clock64();\n"),
        (_R7A_KJ, _clocked(_R7A_KJ, 0, "kj", [_wait_u32("kj.x")])),
        *[(_R7A_U % (k, k), _clocked(_R7A_U % (k, k), 0, f"u{k}", [_r3_wait(f"u{k}")],
                                     "        ")) for k in (0, 3)],
        (_R7A_U1, _clocked(_R7A_U1, 0, "u1", [_r3_wait("u1")], "      ")),
        (_R7A_U2, _clocked(_R7A_U2, 0, "u2", [_r3_wait("u2")], "          ")),
        (_R7A_SCATTER, _clocked(
            "        const uint2 k5 = tf_split(kj, 4u);\n"
            "        const float ua5 = tf_uniform(tf_split(k5, 0u)), ub5 = tf_uniform(tf_split(k5, 1u));\n",
            0, "k5", [_r3_wait("ua5"), _r3_wait("ub5")], "        ")
         + "        const V3 wn = sample_phase(ua5, ub5, pc, V3{w[0], w[1], w[2]});\n"),
        (_R7A_SV0, "    const long long q_sv = clock64();\n" + _R7A_SV0),
        (_R7A_SV1, _R7A_SV1 + _r3_wait("d_seg") + _r3_wait("mu_r")
         + "    ph[1] += clock64() - q_sv;\n"),
        (_R7A_SAMPLE, _clocked(_R7A_SAMPLE, 2, "dens", [_r3_wait("dens")], "          ")),
        (_R7A_END, _R7A_END[:-2] + "  ph[3] = clock64() - ph_start;\n" + _per_thread_flush(4)
         + "}\n")],
    # Register budgets: at least 4 or 8 resident blocks of 128 an SM.
    **{f"min_blocks_{b}": [("__global__ void __launch_bounds__(VD_THREADS)\nvd_kernel(",
                            f"__global__ void __launch_bounds__(VD_THREADS, {b})\nvd_kernel(")]
       for b in (4, 8)},
}
R7_PHASES_ONE_THREAD_A_RAY = ("draws", "super_voxel", "sample", "total")

# R8's first design: one thread a ray, three nested loops. `phase_clock`: a
# residual step's draws (its five threefry), its density sample (with the
# three divisions by the extents), the rest of the residual step (the free
# flight's division, the ratio's, the reservoir's, expf), the whole thread
# (the rest: bounces, their draws, the DDA); lane-cycles.
_R8A_DRAWS = ("    const uint2 k1 = tf_split(key, 1u), k2 = tf_split(key, 2u);\n"
              "    key = tf_split(key, 0u);\n"
              "    const float u0 = tf_uniform(k1), u1 = tf_uniform(k2);\n")
_R8A_TNEW = "    const float t_new = t - logf(fmaxf(1.0f - u0, 1e-10f)) / mu_r;\n"
_R8A_SAMPLE = ("    const float density = trilinear_bricked(G.grid, G.nz, G.ny, G.nx, (x - bmin[0]) / extent[0],\n"
               "                                            (y - bmin[1]) / extent[1], (z - bmin[2]) / extent[2]);\n")
_R8A_STEP_END = "    t = t_new;\n  }\n  return T_c * T_r;\n"
_R8A_SEG_SIG = "                                            Reservoir& res, int& n_res) {\n"
_R8A_TRACE_SIG = "                                          float* x_entry, int& n_dda, int& n_res) {\n"
_R8A_SEG_CALL = "                                     __ldg(G.mu_r + sv), T, t_cur, res, n_res);\n"
_R8A_TOP = "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n  if (i >= N) return;\n"
_R8A_END = "    steps[3 * i + 2] = n_res;\n  }\n}\n"
R8_VARIANTS_ONE_THREAD_A_RAY = {
    "phase_clock": [
        _R3_COUNTERS,
        (_R8A_SEG_SIG, _R8A_SEG_SIG[:-4] + ", long long* ph) {\n"),
        (_R8A_TRACE_SIG, _R8A_TRACE_SIG[:-4] + ", long long* ph) {\n"),
        (_R8A_SEG_CALL, _R8A_SEG_CALL[:-3] + ", ph);\n"),
        ("    radiance[i] = rr_trace(G, P, key, x, w, res, x_entry, n_dda, n_res);\n",
         "    radiance[i] = rr_trace(G, P, key, x, w, res, x_entry, n_dda, n_res, ph);\n"),
        ("      const float T_seg = rr_trace(G, P, k_dda, x, w, res, x_entry, n_dda, n_res);\n",
         "      const float T_seg = rr_trace(G, P, k_dda, x, w, res, x_entry, n_dda, n_res, ph);\n"),
        (_R8A_TOP, _R8A_TOP + "  long long ph[4] = {0, 0, 0, 0};\n"
         "  const long long ph_start = clock64();\n"),
        (_R8A_DRAWS, _clocked(_R8A_DRAWS, 0, "draws",
                              [_r3_wait("u0"), _r3_wait("u1"), _wait_u32("key.x")])),
        (_R8A_TNEW, "    const long long q_r = clock64();\n" + _R8A_TNEW),
        (_R8A_SAMPLE, _r3_wait("z") + "    ph[2] += clock64() - q_r;\n"
         + _clocked(_R8A_SAMPLE, 1, "dens", [_r3_wait("density")])
         + "    const long long q_r2 = clock64();\n"),
        (_R8A_STEP_END, _r3_wait("res.dist") + _r3_wait("T_r") + "    ph[2] += clock64() - q_r2;\n"
         + _R8A_STEP_END),
        (_R8A_END, _R8A_END[:-2] + "  ph[3] = clock64() - ph_start;\n" + _per_thread_flush(4)
         + "}\n")],
    **{f"min_blocks_{b}": [
        ("template <bool TRANSMITTANCE>\n__global__ void __launch_bounds__(RR_THREADS)\n",
         f"template <bool TRANSMITTANCE>\n__global__ void __launch_bounds__(RR_THREADS, {b})\n")]
       for b in (4, 8)},
}
R8_PHASES_ONE_THREAD_A_RAY = ("draws", "sample", "step_rest", "total")


# The persistent designs. `phase_clock`: per lane, the step's draws (every
# lane), then by the step it took: R7's event (of which the density
# sample), its absorption tests and turns, the super voxels entered and
# skipped, the refill (the warp's claim, the new rays' set-up), a dead ray's
# outputs; R8's residual step (of which the density sample), its other
# steps (key, bounce, turn), the DDA (a bounce's set-up, the steps between
# segments), the bounce's end with the outputs; the refill; the whole
# kernel; all over 32 (warp-cycles). `warp_steps`: the warps' steps.
def _persistent_clock(loop_top, body_start, step_var, sample, seams, end):
    """R3's `phase_clock` scheme for a persistent design: `seams` are
    [(text, waits, charge)], each closing an interval begun at the last
    one (or at the draws' end) and charging it to `charge` (a C expression
    of the phase)."""
    subs = [_R3_COUNTERS,
            (loop_top, loop_top.replace("  for (;;) {\n",
                                        "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                                        "  const long long ph_start = clock64();\n  for (;;) {\n"
                                        "    const long long r0 = clock64();\n")),
            ("    if (!__any_sync(0xffffffffu, active)) break;\n",
             "    ph[4] += clock64() - r0;\n    if (!__any_sync(0xffffffffu, active)) break;\n"
             "    const long long c0 = clock64();\n"),
            (body_start, _r3_wait("ua") + _r3_wait("ub") + "    long long c1 = clock64();\n"
             "    ph[0] += c1 - c0;\n" + body_start + f"    const int st0 = {step_var};\n")]
    # The density sample, timed inside its step's interval.
    indent = sample[0][:len(sample[0]) - len(sample[0].lstrip())]
    subs.append((sample[0], f"{indent}const long long c2 = clock64();\n" + sample[0]
                 + _r3_wait(sample[1]) + f"{indent}ph[2] += clock64() - c2;\n"))
    for text, waits, charge in seams:
        subs.append((text, "".join(waits) + "    { const long long c = clock64();\n"
                     f"      ph[{charge}] += c - c1;\n      c1 = c; }}\n" + text))
    subs.append((end, end[:-len("  }\n}\n")] + "  }\n  ph[7] = clock64() - ph_start;\n"
                 "  __syncwarp();\n#pragma unroll\n  for (int p = 0; p < 8; ++p) {\n"
                 "    long long v = ph[p];\n"
                 "    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);\n"
                 "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase[p], "
                 "(unsigned long long)(v / 32));\n  }\n}\n"))
    return subs


def _persistent_steps(loop_top, end):
    return [_R3_COUNTERS,
            (loop_top, loop_top.replace("  for (;;) {\n", "  long long warp_n = 0;\n  for (;;) {\n")),
            ("    if (!active) continue;\n", "    ++warp_n;\n    if (!active) continue;\n"),
            (end, end[:-len("}\n")]
             + "  if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase[0], (unsigned long long)warp_n);\n}\n")]


_R7_LOOP_TOP = "  int axis = 0;\n  for (;;) {\n"
_R7_END = "      active = false;\n    }\n  }\n}\n"
R7_VARIANTS = {
    "phase_clock": _persistent_clock(
        _R7_LOOP_TOP, "    if (!active) continue;\n", "step",
        ("            const float dens = trilinear_bricked(grid, nz, ny, nx, tp[0], tp[1], tp[2]);\n",
         "dens"),
        [("    // Across the exit face, and on through empty super voxels: each skip is\n",
          [_r3_wait("x[0]"), _r3_wait("t_r"), _r3_wait("w[0]")],
          "st0 == ST_EVENT ? 1 : (st0 == ST_COLLIDE || st0 == ST_SCATTER ? 3 : 6)"),
         ("    if (done) {  // the ray is dead: its outputs, and the lane is free\n",
          [_r3_wait("d_seg"), _r3_wait("mu_r"), _r3_wait("x[0]")], "5")],
        _R7_END),
    "warp_steps": _persistent_steps(_R7_LOOP_TOP, _R7_END),
    # Register budgets: 3, 5, 6 or 8 resident blocks of 128 an SM (the
    # source asks for VD_MIN_BLOCKS).
    **{f"min_blocks_{b}": [("#define VD_MIN_BLOCKS 4\n", f"#define VD_MIN_BLOCKS {b}\n")]
       for b in (3, 5, 6, 8)},
    "threads_256": [("#define VD_THREADS 128\n", "#define VD_THREADS 256\n"),
                    ("#define VD_MIN_BLOCKS 4\n", "#define VD_MIN_BLOCKS 2\n")],
}
R7_PHASES = ("draws", "event", "sample", "collide_scatter", "refill", "super_voxel", "key_or_done",
             "total")

_R8_LOOP_TOP = "  int s = 0, n = 0;\n  for (;;) {\n"
_R8_END = "      active = false;\n    }\n  }\n}\n"
R8_VARIANTS = {
    "phase_clock": _persistent_clock(
        _R8_LOOP_TOP, "    if (!active) continue;\n", "step",
        ("      const float density = trilinear_bricked(G.grid, G.nz, G.ny, G.nx, tp[0], tp[1], tp[2]);\n",
         "density"),
        [("    if (start) {  // the bounce's DDA: the box, the entry, the first super voxel\n",
          [_r3_wait("T_r"), _r3_wait("w[0]"), _r3_wait("Tb")],
          "st0 == ST_RES ? 1 : 3"),
         ("    if (end) {  // the bounce's end\n",
          [_r3_wait("t_cur"), _r3_wait("mu_r"), _r3_wait("Tb")], "5"),
         ("    if (done) {  // the ray's outputs, and the lane is free\n",
          [_r3_wait("Tp"), _r3_wait("x[0]")], "6")],
        _R8_END),
    "warp_steps": _persistent_steps(_R8_LOOP_TOP, _R8_END),
    **{f"min_blocks_{b}": [("#define RR_MIN_BLOCKS 4\n", f"#define RR_MIN_BLOCKS {b}\n")]
       for b in (3, 5, 6)},
    "threads_256": [("#define RR_THREADS 128\n", "#define RR_THREADS 256\n"),
                    ("#define RR_MIN_BLOCKS 4\n", "#define RR_MIN_BLOCKS 2\n")],
}
R8_PHASES = ("draws", "residual_step", "sample", "key_bounce_turn", "refill", "dda",
             "bounce_end", "total")


def _matching_variants(source, designs):
    """(name, variants, phases) of the first of `designs` whose every
    substitution the tree's csrc/<source>.cu holds exactly once."""
    from linevis_tpu_torch.kernels import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    for name, variants, phases in designs:
        if variants and all(src.count(old) == 1 for subs in variants.values() for old, _ in subs):
            return name, variants, phases
    raise SystemExit(f"{source}.cu matches none of the designs' variants")


def _lockstep_use(work):
    """The lanes lockstep warps of 32 neighbouring rays keep busy
    (`_warp_efficiency`) for per-ray `work`, the last partial warp left out."""
    n = work.shape[0] - work.shape[0] % 32
    return _warp_efficiency(work[:n]) if n else None


def _phase_shares(fig, phases, mode):
    pc = fig["variants"]["phase_clock"]["phase_cycles"][mode]
    total = float(pc[len(phases) - 1])
    return {ph: pc[i] / total for i, ph in enumerate(phases[:-1])}


def _warp_step_use(libs, source, run, useful):
    """(warps' steps, lane use) of a persistent design: `useful` lane-steps
    over 32 x the warps' steps, which its `warp_steps` variant counts."""
    from linevis_tpu_torch.kernels import _build

    if "warp_steps" not in libs:
        return None, None
    lib = ctypes.CDLL(str(libs["warp_steps"][0]))
    _build._loaded[source] = lib
    buf = (ctypes.c_ulonglong * 8)()
    lib.read_phase(buf)
    run()
    torch.cuda.synchronize()
    lib.read_phase(buf)
    _build._loaded.pop(source)
    return int(buf[0]), useful / (32.0 * buf[0])


def _r7(dev, W, H, res, turns):
    """R7 on R3's sample: events per ray and by kind, the lanes a lockstep
    warp keeps busy, and the tree's kernel against its design's variants."""
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels import vpt_decomposition as vd
    from linevis_tpu_torch.render.super_voxel import super_voxel_minmax_of
    from linevis_tpu_torch.render.vpt import VptSettings, sun_constants

    _, grid, o, d, kt, _ = _r3_inputs(dev, W, H)
    vs = VptSettings()
    dmin, dmax = super_voxel_minmax_of(grid, vs.super_voxel_size)
    p = vd.decomposition_params(grid.shape, dmin.shape, vs.extinction, vs.scattering_albedo,
                                *sun_constants(vs), vs.phase_g, vs.max_events)
    ev = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    kinds = None  # a tree from before the kinds counts them not
    if hasattr(vd, "EVENT_KINDS"):
        kinds = torch.empty((o.shape[0], len(vd.EVENT_KINDS)), dtype=torch.int32, device=dev)
        vd.vpt_decomposition(grid, dmin, dmax, o, d, kt, p, events=ev, kinds=kinds)
    else:
        vd.vpt_decomposition(grid, dmin, dmax, o, d, kt, p, events=ev)
    evd = ev.double()
    hit = ev > 0
    fig = {"rays": o.shape[0], "events": int(evd.sum()), "rays_in_the_box": int(hit.sum()),
           "events_p50_hit": float(evd[hit].quantile(0.5)),
           "events_p99_hit": float(evd[hit].quantile(0.99)), "events_max": int(ev.max()),
           "lockstep_lane_use_32": _lockstep_use(ev),
           "lockstep_lane_use_sorted_32": _lockstep_use(torch.sort(ev).values)}
    k = None
    if kinds is not None:
        tot = kinds.double().sum(0)
        k = fig["kinds"] = {name: int(v) for name, v in zip(vd.EVENT_KINDS, tot)}
        fig["kind_share_of_events"] = {name: float(v) / float(evd.sum())
                                       for name, v in zip(vd.EVENT_KINDS[:6], tot[:6])}
    print("r7: " + json.dumps(fig), flush=True)
    design, variants, phases = _matching_variants("vpt_decomposition", (
        ("persistent", R7_VARIANTS, R7_PHASES),
        ("one_thread_a_ray", R7_VARIANTS_ONE_THREAD_A_RAY, R7_PHASES_ONE_THREAD_A_RAY)))
    fig["design"] = design
    mode = "decomposition_1080p"
    modes = {mode: lambda: list(vd.vpt_decomposition(grid, dmin, dmax, o, d, kt, p))}
    libs = _build_variants(_build.BUILD_DIR / "split", "vpt_decomposition", variants)
    fig["variants"] = _variant_figures("vpt_decomposition", libs, modes, turns, phases)
    fig["phase_share"] = _phase_shares(fig, phases, mode)
    # Lane-steps with work in the persistent design: a ray's key, every
    # event but a skip, and each scatter's turn (and, where rays can be
    # absorbed, each collision's absorption draw).
    if k is not None:
        collisions = k["absorb"] + k["scatter"]
        useful = (fig["rays_in_the_box"] + fig["events"] - k["skip"] + k["scatter"]
                  + (collisions if p.abs_albedo > 0 else 0))
        fig["warp_steps"], fig["lane_use_persistent"] = _warp_step_use(
            libs, "vpt_decomposition", modes[mode], useful)
    for name, v in fig["variants"].items():
        print(f"r7 {name}: " + json.dumps(v), flush=True)
    print("r7 phase shares: " + json.dumps(fig["phase_share"]), flush=True)
    res["r7"] = fig


def _r8(dev, W, H, res, turns):
    """R8 on R3's sample: bounces, DDA and residual steps per ray, the lanes
    a lockstep warp keeps busy, and the tree's kernel against its design's
    variants."""
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels import vpt_residual_ratio as vr
    from linevis_tpu_torch.render.super_voxel import super_voxel_grid_of
    from linevis_tpu_torch.render.vpt import VptSettings, sun_constants

    _, grid, o, d, kt, _ = _r3_inputs(dev, W, H)
    vs = VptSettings()
    sv = super_voxel_grid_of(grid, float(vs.extinction[0]), vs.super_voxel_size)
    p = vr.rr_params(grid.shape, sv.mu_c.shape, vs.extinction, vs.scattering_albedo,
                     *sun_constants(vs), vs.phase_g)
    st = torch.empty((o.shape[0], 3), dtype=torch.int32, device=dev)
    vr.vpt_residual_ratio(grid, sv, o, d, kt, p, steps=st)
    tot = [int(v) for v in st.double().sum(0)]
    n = o.shape[0]
    steps = {"bounce": tot[0], "turn": tot[0] - n, "dda_step": tot[1], "residual_step": tot[2]}
    fig = {"rays": n, "steps": steps,
           "step_share": {name: v / float(sum(steps.values())) for name, v in steps.items()},
           "max": [int(v) for v in st.max(0).values],
           "lockstep_lane_use_32_residual": _lockstep_use(st[:, 2]),
           "lockstep_lane_use_32_bounce_turn_residual": _lockstep_use(
               2 * st[:, 0] - 1 + st[:, 2])}
    print("r8: " + json.dumps(fig), flush=True)
    design, variants, phases = _matching_variants("vpt_residual_ratio", (
        ("persistent", R8_VARIANTS, R8_PHASES),
        ("one_thread_a_ray", R8_VARIANTS_ONE_THREAD_A_RAY, R8_PHASES_ONE_THREAD_A_RAY)))
    fig["design"] = design
    mode = "residual_ratio_1080p"
    modes = {mode: lambda: list(vr.vpt_residual_ratio(grid, sv, o, d, kt, p))}
    libs = _build_variants(_build.BUILD_DIR / "split", "vpt_residual_ratio", variants)
    fig["variants"] = _variant_figures("vpt_residual_ratio", libs, modes, turns, phases)
    fig["phase_share"] = _phase_shares(fig, phases, mode)
    # Lane-steps with work in the persistent design: a ray's key, its
    # bounces and turns, its residual steps.
    useful = n + steps["bounce"] + steps["turn"] + steps["residual_step"]
    fig["warp_steps"], fig["lane_use_persistent"] = _warp_step_use(
        libs, "vpt_residual_ratio", modes[mode], useful)
    for name, v in fig["variants"].items():
        print(f"r8 {name}: " + json.dumps(v), flush=True)
    print("r8 phase shares: " + json.dumps(fig["phase_share"]), flush=True)
    res["r8"] = fig


# R4 (`csrc/density_march.cu`) on `chip_smoke.py`'s density-map frame: `r4`
# splits the tree's design with `R4_VARIANTS`. Each variant is
# (substitutions, layout): the field the wrapper is handed, dense ("dense")
# or in 8^3 bricks ("bricks", `volume_common.grid_bricks`).
R4_PHASES = ("clip", "sample", "tf_color", "tf_opacity", "blend", "position", "skip", "total")
# The tree's design (8x4 pixel blocks a warp, exact reciprocals,
# each TF's segment first, empty bricks skipped with verified jumps on the
# dense field, DM_BATCH steps sampled together). Its `phase_clock`: per lane, the ray and its clip, the step's
# position and cell, the skip (occupancy read, estimate and verification),
# the batch's cells and samples, both TFs and the blend, and the lane's
# whole time. `counts`: steps sampled, skips of one step, jumps taken and
# the steps they pass, batches. `block_times`: each block's start and end
# (%globaltimer) and SM.
_R4_CELL = "    const VolCell cell = step_cell<POW2>(P, d, t, nz, ny, nx);\n"
_R4_NEXT = "        k = next;\n        continue;\n"
_R4_SAMPLE = "sample_cell(field, ny, nx, cells[j])"
_R4_TF = ("    tf_eval_last<3, DM_BATCH>(tf_c, nc, dens, rgb);\n"
          "    tf_eval_last<1, DM_BATCH>(tf_o, no, dens, a_tf);\n")
_R4_BLEND_END = "    k += m;\n  }\n"
_R4_BATCH_END = "        m = j + 1;\n    }\n"
_R4_OUT_END = "                                     acc[2] + (1.0f - acc_a) * P.v[27], acc_a);\n}\n"
_R4_TOP = "  if (px >= width || py >= height) return;\n"
_R4_LOOP = "  int k = t_far > t_near ? 0 : n_steps;\n"
_R4_JUMP_OK = "            next = tc < t_far ? kc + 1 : n_steps;\n"
_R4_DISPATCH = "  const void* f = dm_instance(pow2, skip != 0);\n"
_R4_SYNC = "  __syncthreads();\n  const float* tab"
_R4_BLOCKS = (
    '#include "volume_common.cuh"\n',
    '#include "volume_common.cuh"\n__device__ unsigned long long g_blk[3 * 65536];\n'
    'extern "C" int read_blocks(unsigned long long* h, int n) {\n'
    '  return (int)cudaMemcpyFromSymbol(h, g_blk, sizeof(unsigned long long) * 3 * n);\n}\n'
    '__device__ __forceinline__ unsigned long long dm_now() {\n  unsigned long long t;\n'
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n')


def _r4_tiles(tw, th):
    """Warps on tw x th pixel blocks, four a tile of (2 tw) x (2 th)."""
    return [("#define DM_TW 8   // a warp's pixel block: DM_TW x DM_TH\n#define DM_TH 4\n"
             "#define DM_BW 16  // a block's tile: DM_BW x DM_BH, four warps\n#define DM_BH 8\n",
             f"#define DM_TW {tw}\n#define DM_TH {th}\n#define DM_BW {2 * tw}\n"
             f"#define DM_BH {2 * th}\n")]


_R4_NO_SKIP = (_R4_DISPATCH, "  const void* f = dm_instance(pow2, false);\n")
_R4_IEEE_NO_SKIP = (_R4_DISPATCH, "  const void* f = dm_instance(false, false);\n")
_R4_BRICKED = (_R4_SAMPLE, "sample_cell_bricked(field, nyb, nxb, cells[j])")
_R4_TAB = "  const float* tab = tf_shared ? s_tf : tf;\n"
_R4_NO_TF = ("#pragma unroll\n    for (int j = 0; j < DM_BATCH; ++j) {\n"
             "      rgb[j][0] = rgb[j][1] = rgb[j][2] = dens[j];\n      a_tf[j][0] = dens[j];\n    }\n")
_R4_NO_EXPF = ("        const float alpha = 1.0f - expf(-a_tf[j][0] * step * att);\n",
               "        const float alpha = a_tf[j][0] * step * att;\n")
R4_VARIANTS = {
    "phase_clock": ([
        _R3_COUNTERS,
        (_R4_TOP, _R4_TOP + "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  const long long ph_start = clock64();\n"),
        (_R4_LOOP, _r3_wait("t_near") + _r3_wait("d[2]") + _r3_wait("h[2]")
         + "  long long c_top = clock64();\n  ph[0] += c_top - ph_start;\n" + _R4_LOOP),
        (_R4_CELL, _R4_CELL + _r3_wait("cell.tx") + _r3_wait("cell.tz")
         + "    const long long c1 = clock64();\n    ph[5] += c1 - c_top;\n"),
        (_R4_NEXT, "        k = next;\n        c_top = clock64();\n        ph[6] += c_top - c1;\n"
         "        continue;\n"),
        (_R4_TF, _r3_wait("dens[0]") + _r3_wait(f"dens[DM_BATCH - 1]")
         + "    const long long c2 = clock64();\n    ph[1] += c2 - c1;\n"
         "    tf_eval_last<3, DM_BATCH>(tf_c, nc, dens, rgb);\n" + _r3_wait("rgb[0][2]")
         + _r3_wait("rgb[DM_BATCH - 1][2]")
         + "    const long long c3 = clock64();\n    ph[2] += c3 - c2;\n"
         "    tf_eval_last<1, DM_BATCH>(tf_o, no, dens, a_tf);\n" + _r3_wait("a_tf[0][0]")
         + _r3_wait("a_tf[DM_BATCH - 1][0]")
         + "    const long long c4 = clock64();\n    ph[3] += c4 - c3;\n"),
        (_R4_BLEND_END, _r3_wait("acc_a") + _r3_wait("acc[2]")
         + "    c_top = clock64();\n    ph[4] += c_top - c4;\n" + _R4_BLEND_END),
        (_R4_OUT_END, _R4_OUT_END[:-2] + "  ph[7] = clock64() - ph_start;\n"
         "#pragma unroll\n  for (int p = 0; p < 8; ++p)\n"
         "    atomicAdd(&g_phase[p], (unsigned long long)(ph[p] / 32));\n}\n")], "dense"),
    "counts": ([
        _R3_COUNTERS,
        (_R4_BLEND_END, "    atomicAdd(&g_phase[0], (unsigned long long)m);\n"
         "    atomicAdd(&g_phase[4], 1ull);\n" + _R4_BLEND_END),
        (_R4_JUMP_OK, _R4_JUMP_OK + "            atomicAdd(&g_phase[2], 1ull);\n"
         "            atomicAdd(&g_phase[3], (unsigned long long)(kc + 1 - k));\n"),
        (_R4_NEXT, "        if (next == k + 1) atomicAdd(&g_phase[1], 1ull);\n" + _R4_NEXT)],
        "dense"),
    "block_times": ([
        _R4_BLOCKS,
        (_R4_SYNC, "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
         "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
         "    g_blk[3 * blockIdx.x] = dm_now();\n    g_blk[3 * blockIdx.x + 1] = 0;\n"
         "    g_blk[3 * blockIdx.x + 2] = sm;\n  }\n  __syncthreads();\n  const float* tab"),
        (_R4_OUT_END, _R4_OUT_END[:-2] + "  __syncwarp(__activemask());\n"
         "  if ((threadIdx.x & 31) == 0) atomicMax(&g_blk[3 * blockIdx.x + 1], dm_now());\n}\n")],
        "dense"),
    # The clip and the output alone (no step taken: another function).
    "clip_only": ([(_R4_LOOP, "  int k = n_steps;\n")], "dense"),
    # Skipping off (on the power-of-two and the IEEE instances) and on,
    # on the dense field and in 8^3 bricks.
    "no_skip": ([_R4_NO_SKIP], "dense"),
    "no_skip_bricked_field": ([_R4_NO_SKIP, _R4_BRICKED], "bricks"),
    "ieee_no_skip": ([_R4_IEEE_NO_SKIP], "dense"),
    "ieee_no_skip_bricked_field": ([_R4_IEEE_NO_SKIP, _R4_BRICKED], "bricks"),
    "skip_bricked_field": ([_R4_BRICKED], "bricks"),
    # The TF table as the compiler sees it: always in shared memory (the
    # kernel's loads of it then LDS, not generic), always in global memory.
    "tf_shared_known": ([(_R4_TAB, "  const float* tab = s_tf;\n")], "dense"),
    "tf_global": ([(_R4_TAB, "  const float* tab = tf;\n")], "dense"),
    "no_jumps": ([("        if (kc > k) {\n", "        if (false && kc > k) {\n")], "dense"),
    "ieee_divisions": ([(_R4_DISPATCH, "  const void* f = dm_instance(false, skip != 0);\n")],
                       "dense"),
    **{f"batch_{n}": ([("#define DM_BATCH 4 ", f"#define DM_BATCH {n} ")], "dense")
       for n in (1, 2, 8)},
    # What a batch waits on: its TFs as identities, alpha without expf, both
    # (loads, lerps and blend alone; each another function), the segment
    # loop unrolled, and the occupancy read once a brick.
    "no_tf": ([(_R4_TF, _R4_NO_TF)], "dense"),
    "no_expf": ([_R4_NO_EXPF], "dense"),
    "loads_only": ([(_R4_TF, _R4_NO_TF), _R4_NO_EXPF], "dense"),
    "tf_unroll_4": ([("  for (int k = 0; k + 1 < npts; ++k, seg += 3 + 2 * NCH) {\n",
                      "#pragma unroll 4\n  for (int k = 0; k + 1 < npts; ++k, seg += 3 + 2 * NCH) {\n")],
                    "dense"),
    "occupancy_once_a_brick": ([(_R4_LOOP, "  int last_b = -1;\n  bool last_empty = false;\n"
                                 + _R4_LOOP),
                                ("      if (__ldg(occ + b) == 0) {\n",
                                 "      if (b != last_b) {\n        last_b = b;\n"
                                 "        last_empty = __ldg(occ + b) == 0;\n      }\n"
                                 "      if (last_empty) {\n")], "dense"),
    "rows_32x1": (_r4_tiles(32, 1), "dense"),
    "tiles_16x2": (_r4_tiles(16, 2), "dense"),
    **{f"min_blocks_{b}": ([("#define DM_MIN_BLOCKS 4 ", f"#define DM_MIN_BLOCKS {b} ")], "dense")
       for b in (2, 6, 8)},
}
# chip_smoke.py's density map: SC_LDM_CAMERA looking at the cloud's centre,
# the renderer's standard colour TF, its ramp for a flat opacity TF, the
# attenuation 200 and a transparent white background.
R4_CAMERA = (-0.6, -0.45, -0.55)
R4_OPACITY = ((0.0, 0.0), (0.05, 1.0), (1.0, 1.0))


def _r4_inputs(dev, W, H):
    """-> (density_march module, field, prm, colour points, opacity points)."""
    from linevis_tpu_torch import entry
    from linevis_tpu_torch.kernels import density_march as dm
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import _ray_basis, camera_tensors

    ld = entry.scattering_line_data(dev)
    field = ld.get_line_density_field(device=dev)
    ct = camera_tensors(Camera(position=R4_CAMERA, look_at_point=(0.0, 0.0, 0.0), width=W,
                               height=H), dev)
    prm, _ = dm.march_params(field.shape, ld.grid_b_min, ld.grid_b_max, ct[1],
                             _ray_basis(ct[0]), W, H, 200.0, (1.0, 1.0, 1.0, 0.0))
    c_pts, _ = TransferFunction.standard().as_static_points()
    return dm, field, prm, c_pts, R4_OPACITY


def _r4_counts(field, prm, W, H, n_steps):
    """The march's steps as the plain version takes them, per pixel: all
    steps in the box, those whose trilinear cell has a non-zero corner, and
    those whose cell lies in an occupied brick (`brick_occupancy`)."""
    from linevis_tpu_torch.kernels.density_march import march_rays, step_t
    from linevis_tpu_torch.kernels.volume_common import brick_occupancy, trilinear_cell, vdiv

    p = [float(v) for v in prm]
    nz, ny, nx = field.shape
    d, t_near, t_far, hit = march_rays(prm, W, H, field.device)
    occ = brick_occupancy(field).reshape(-1).bool()
    nyb, nxb = -(-ny // 8), -(-nx // 8)
    flat = field.reshape(-1)
    steps, nonzero, occupied = (torch.zeros(W * H, dtype=torch.int32, device=field.device)
                                for _ in range(3))
    for k in range(n_steps):
        t = step_t(t_near, k, p[21])
        inside = hit & (t < t_far)
        if not bool(inside.any()):
            break
        tex = tuple(vdiv(p[9 + c] + t * d[c] - p[c], p[6 + c]) for c in range(3))
        x0, y0, z0 = (c.long() for c in trilinear_cell(field.shape, tex))
        base = (z0 * ny + y0) * nx + x0
        corner = torch.zeros_like(inside)
        for dz, dy, dx in itertools.product((0, 1), repeat=3):
            corner |= flat[base + (dz * ny + dy) * nx + dx] != 0
        in_occ = occ[((z0 // 8) * nyb + y0 // 8) * nxb + x0 // 8]
        steps += inside.int()
        nonzero += (inside & corner).int()
        occupied += (inside & in_occ).int()
    return steps, nonzero, occupied


def _lane_use(per_pixel, W, H, tw, th):
    """Lockstep warps on tw x th pixel blocks: the lanes' work over 32 x
    each warp's most (whole warps only; the 1080p frame's are)."""
    x = per_pixel.reshape(H // th, th, W // tw, tw).permute(0, 2, 1, 3).reshape(-1, tw * th)
    x = x.double()
    return float(x.sum() / (x.shape[1] * x.max(dim=1).values.sum()))


def _r4(dev, W, H, res, turns):
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.volume_common import brick_occupancy, grid_bricks

    dm, field, prm, c_pts, o_pts = _r4_inputs(dev, W, H)
    steps, nonzero, occupied = _r4_counts(field, prm, W, H, 256)
    occ = brick_occupancy(field)
    fig = {"pixels": W * H, "field": list(field.shape), "steps": int(steps.sum()),
           "steps_per_pixel": _histogram(steps.long(), 16),
           "steps_with_a_nonzero_corner": int(nonzero.sum()),
           "steps_in_occupied_bricks": int(occupied.sum()),
           "lane_use_lockstep": {f"{tw}x{th}": _lane_use(steps, W, H, tw, th)
                                 for tw, th in ((32, 1), (8, 4), (16, 2))},
           "occupied_lane_use_lockstep": {f"{tw}x{th}": _lane_use(occupied, W, H, tw, th)
                                          for tw, th in ((32, 1), (8, 4), (16, 2))},
           "bricks": occ.numel(), "occupied_bricks": int(occ.sum())}
    fig["steps_nonzero_share"] = fig["steps_with_a_nonzero_corner"] / max(fig["steps"], 1)
    fig["steps_occupied_share"] = fig["steps_in_occupied_bricks"] / max(fig["steps"], 1)
    print("r4: " + json.dumps(fig), flush=True)
    libs = _build_variants(_build.BUILD_DIR / "split", "density_march",
                           {k: v[0] for k, v in R4_VARIANTS.items()})
    # The frame's TFs let the wrapper skip, so it hands the kernel the
    # tensor itself: the field, or a copy whose data is in bricks.
    bricked = grid_bricks(field).reshape(field.shape)
    bricked._brick_occupancy = (bricked._version, brick_occupancy(field))
    layouts = {"dense": field, "bricks": bricked}
    layout_of = {"base": "dense", **{k: v[1] for k, v in R4_VARIANTS.items()}}

    def use(name):
        _build._loaded["density_march"] = ctypes.CDLL(str(libs[name][0]))
        return _build._loaded["density_march"]

    def run(name):
        return dm.density_march(layouts[layout_of[name]], prm, W, H, 256, c_pts, o_pts)

    use("base")
    base_out = run("base").clone()
    fig["variants"] = {}
    for name in libs:
        lib = use(name)
        fig["variants"][name] = {
            "instances": _kernel_info(lib) if hasattr(lib, "kernel_info") else [],
            "ptxas": [ln.replace("ptxas info    : ", "") for ln in libs[name][1]
                      if "Used" in ln or "spill" in ln],
            "equal_to_base": bool(torch.equal(run(name), base_out)), "ms": []}
    names = list(libs)
    for k in range(turns):
        for name in (names if k % 2 == 0 else names[::-1]):
            use(name)
            fig["variants"][name]["ms"].append(_timed(lambda: run(name), n=20))
    buf = (ctypes.c_ulonglong * 8)()
    for name in ("phase_clock", "counts"):
        if name not in libs:
            continue
        lib = use(name)
        lib.read_phase(buf)  # zero the counters
        run(name)
        torch.cuda.synchronize()
        lib.read_phase(buf)
        fig[f"{name}_read"] = list(buf)
    if "phase_clock_read" in fig:
        total = float(fig["phase_clock_read"][len(R4_PHASES) - 1])
        fig["phase_share_of_warp_cycles"] = {ph: fig["phase_clock_read"][i] / total
                                             for i, ph in enumerate(R4_PHASES[:-1])}
    if "block_times" in libs:
        lib = use("block_times")
        run("block_times")
        torch.cuda.synchronize()
        nb = ((W + 15) // 16) * ((H + 7) // 8)
        buf_b = (ctypes.c_ulonglong * (3 * nb))()
        lib.read_blocks(buf_b, nb)
        blk = torch.tensor(list(buf_b), dtype=torch.float64).reshape(nb, 3)
        dur = (blk[:, 1] - blk[:, 0]) / 1e3  # us
        t0 = float(blk[:, 0].min())
        order = torch.argsort(dur, descending=True)[:10]
        tiles_x = (W + 15) // 16
        fig["blocks"] = {
            "span_us": (float(blk[:, 1].max()) - t0) / 1e3,
            "last_start_us": (float(blk[:, 0].max()) - t0) / 1e3,
            "duration_us": {q: float(dur.quantile(v)) for q, v in
                            (("p50", 0.5), ("p90", 0.9), ("p99", 0.99), ("max", 1.0))},
            "sum_over_132_sms_us": float(dur.sum()) / 132,
            "longest": [[int(i) % tiles_x, int(i) // tiles_x, float(dur[i])] for i in order],
            "sms": int(blk[:, 2].unique().numel())}
        print("r4 blocks: " + json.dumps(fig["blocks"]), flush=True)
    if "counts_read" in fig:
        c = fig["counts_read"]
        fig["kernel_counts"] = {"sampled": c[0], "skips_of_one_step": c[1], "jumps": c[2],
                                "steps_jumped": c[3], "batches": c[4],
                                "sampled_equals_steps_in_occupied_bricks":
                                    c[0] == fig["steps_in_occupied_bricks"]}
    _build._loaded.pop("density_march")
    for name, v in fig["variants"].items():
        print(f"r4 {name}: " + json.dumps(v), flush=True)
    print("r4 phase shares: " + json.dumps(fig.get("phase_share_of_warp_cycles")), flush=True)
    print("r4 kernel counts: " + json.dumps(fig.get("kernel_counts")), flush=True)
    res["r4"] = fig


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 2
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from linevis_tpu_torch.entry import tornado_scene, tornado_trajectories

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"gpu: {gpu}", flush=True)
    dev = torch.device("cuda", 0)
    W, H = 1920, 1080
    res = {"gpu": gpu}
    which = (args[args.index("--kernels") + 1] if "--kernels" in args else "b5,b2,b4,b6,b1,b3")
    if set(which.split(",")) - {"r3", "r4", "r5", "r7", "r8"}:
        traj = tornado_trajectories(dev)
        scene = tornado_scene(dev, traj=traj)
    for k in which.split(","):
        if k in ("r3", "r7", "r8"):
            {"r3": _r3, "r7": _r7, "r8": _r8}[k](dev, W, H, res, turns)
        elif k == "r4":
            _r4(dev, W, H, res, turns)
        elif k == "r5":
            _r5(dev, H, res, turns)
        elif k in ("b4", "b3"):
            {"b4": _b4, "b3": _b3}[k](dev, traj, W, H, res, turns)
        else:
            {"b5": _b5, "b2": _b2, "b6": _b6, "b1": _b1, "accum": _accum, "r1": _r1,
             "r2": _r2}[k](dev, scene, W, H, res, turns)
    print(json.dumps(res), flush=True)
    if "--out" in args:
        out = Path(args[args.index("--out") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
