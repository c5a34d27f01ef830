"""Where the time of B2's K-buffer kernel, B5's AO grid trace, B4's prism raster and B6's wavefront traversal goes, on one card.

A one-off measurement script beside `chip_smoke.py` and `tools/kernel_ab.py`,
not part of the port's package. Run from the root of a source tree:

    python3 tools/kernel_split.py [--turns N] [--out FILE] [--kernels b5,b2,b4,b6]

B5 (`csrc/ao_grid.cu`), on the first 1080p batch of rays of `chip_smoke.py`'s
first RTAO frame: the launch as it is; the same launch with every
`seg_chunks` set to 0 (every pair chunk empty); only the active pair chunks;
those without the longest walk; and the longest walk alone. It also prints
the walk lengths (record chunks per active pair chunk).

Then the tree's B5 against its variants (`B5_VARIANTS`, for the redesign),
in turns.

B2 (`csrc/raster_capsule_oit.cu`), on the first orbit camera of the 1080p
tornado (tile 16x8, K=8, opacity 0.3): ablation variants of the tree's own
kernel, each built from a copy of its source with one part taken out or
changed by text substitution, timed in turns with the source as it is. The
variants are those of the tree's design: `FIRST_DESIGN_VARIANTS` where the
source is the first design (per-thread hit arrays rescanned for each tie
window; unpack such a tree with `git archive` and run the script from its
root), `VARIANTS` where it is the redesign (a sorted per-thread list of
the nearest hits); a source that matches neither set stops the script.
The modes timed: the MLAB composite,
the exact peel pass (per-fragment shading behind a peel depth) and the
'gather' at 960x528. A variant that changes the function says so
(`equal_to_base`). Each time is the mean of 40 launches between CUDA events.

B4 (`csrc/raster_prism.cu`), on the first orbit camera of the 1080p prism
tornado (8 sides, tile 32x16, and 16x8): the histogram of candidates per
tile, the longest run's tile alone (every other tile's run emptied), and
the tree's kernel against its variants (`B4_PARENT_VARIANTS` for the first
design: the set-up alone, the pixel loop alone, a warp's exit once its
pixels miss; `B4_VARIANTS` for the redesign: register budgets, no miss
vote, tiles in index order, the set-up alone), and `clock64()` phase
shares.

B6 (`csrc/bvh_wavefront.cu`), on that camera's 1080p primary rays through
the binned-SAH tree (K=8, opacity 0.3): the histogram of group visits per
ray block, the block with the most visits alone, and the tree's kernel
against its variants (`B6_PARENT_VARIANTS` for the first design,
`B6_VARIANTS` for the redesign, which adds register budgets, the sweeps
without the members' shading or without the insertion, and the next
record waited for as soon as its copy starts): the traversal alone (leaf
rows treated as none), the leaf tests without sweeps, and `clock64()`
phase shares of the warp-cycles (record wait, slab test with its
reduction and barriers, leaf tests, sweeps, push; the compiler moves
independent work across the clock reads, so the shares are rough). For
both: registers, local memory, static shared memory and resident blocks
per SM of every instance, read through the library (`kernel_info`;
appended to a source of the first designs).

The last line holds the card's name and power limit and every figure (also
written to FILE with --out).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["main", "FIRST_DESIGN_VARIANTS", "VARIANTS", "B5_VARIANTS", "B4_PARENT_VARIANTS",
           "B4_VARIANTS", "B6_PARENT_VARIANTS", "B6_VARIANTS"]

# name -> [(old, new), ...] applied to csrc/raster_capsule_oit.cu: parts
# taken out of the first design.
FIRST_DESIGN_VARIANTS = {
    # The composite epilogue over nodes with alpha only (an empty node adds
    # exactly 0 and multiplies T by 1: the same function).
    "epilogue_filled_only": [(
        "      if (q < K) {\n        const float aN = na[q];",
        "      if (q < K && na[q] != 0.0f) {\n        const float aN = na[q];")],
    # No sweeps: hits found and stored, nothing extracted (the stores die).
    "no_sweeps": [("for (int sw = 0; sw < K; ++sw) {", "for (int sw = 0; sw < 0; ++sw) {")],
    # No tile-wide bound: no reduction, no barrier but the staging one, no
    # T_K (the culls and the rejection never fire on the tornado at K=8).
    "no_tile_bound": [
        ("    float zk = tile_bound();  // synchronises: the staged rows are visible",
         "    __syncthreads();\n    float zk = 2.0f;"),
        ("      if (!first) zk = tile_bound();", "      if (!first) zk = 2.0f;")],
    # Staging without the integer division: rows outer, columns inner.
    "staging_no_division": [(
        "    for (int i = tid; i < NROWS * C; i += P) {\n"
        "      const int r = i / C, j = i - r * C;\n"
        "      if (c0 + j >= lo && c0 + j < hi) s[r][j] = payload[(long long)r * ld + c0 + j];\n"
        "    }",
        "    for (int r = warp; r < NROWS; r += nwarps)\n"
        "      for (int j = lo - c0 + lane; j < hi - c0; j += 32)\n"
        "        s[r][j] = payload[(long long)r * ld + c0 + j];")],
}
# The same for the redesign.
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
    # The redesign's phases timed with clock64() by lane 0 of each warp:
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
# The same for the redesigned csrc/ao_grid.cu (the first design has none):
# block shapes and register budgets (4 slot groups of 32 slots per ray:
# blocks of 512 threads; no minimum of resident blocks per SM, which lets
# the registers exceed 32).
B5_VARIANTS = {
    "min_blocks_1": [("__launch_bounds__(C * SPLIT, 2)", "__launch_bounds__(C * SPLIT)")],
    "split_4_min_blocks_4": [("#define SPLIT 8 ", "#define SPLIT 4 "),
                             ("__launch_bounds__(C * SPLIT, 2)", "__launch_bounds__(C * SPLIT, 4)")],
}

# B4, the first design of csrc/raster_prism.cu (one thread per candidate builds its
# S + 2 planes; the plane loop to the run-time n_planes): parts taken out or
# changed.
B4_PARENT_VARIANTS = {
    # The set-up alone: no pixel loop.
    "setup_only": [("    for (int j = 0; j < n; ++j) {\n      // Slab clip:",
                    "    for (int j = 0; j < 0; ++j) {\n      // Slab clip:")],
    # The pixel loop alone: every plane a cheap stand-in (the frame loads,
    # corners, cross products and normalisations die; the function changes).
    "pixel_loop_only": [
        ("        s_plane[j][k] = plane_of(nq, dot(nq, mid), oa);",
         "        s_plane[j][k] = make_float4(ba.x, ba.y, ba.z, oa.x - (float)k);"),
        ("      s_plane[j][n_sides] = plane_of(scale(cross(na, bna), -1.0f), 0.0f, oa);",
         "      s_plane[j][n_sides] = make_float4(ba.x, ba.y, ba.z, oa.x);"),
        ("      s_plane[j][n_sides + 1] = plane_of(tb, dot(tb, ba), oa);",
         "      s_plane[j][n_sides + 1] = make_float4(ba.x, ba.y, ba.z, -oa.x);")],
    # A warp leaves a candidate's plane loop once each of its pixels misses
    # (t_in > t_out, t_out <= 0 or a parallel reject): the same function.
    "miss_exit": [("        rej = rej || (para && pl.w > 0.0f);\n      }",
                   "        rej = rej || (para && pl.w > 0.0f);\n"
                   "        if (__all_sync(0xffffffffu, rej || t_in > t_out || t_out <= 0.0f)) break;\n"
                   "      }")],
    # The same with the two ring planes first (max and min do not depend
    # on the order).
    "ring_first_miss_exit": [
        ("      for (int k = 0; k < n_planes; ++k) {\n        const float4 pl = s_plane[j][k];",
         "      for (int kk = 0; kk < n_planes; ++kk) {\n"
         "        const int k = kk < 2 ? n_sides + kk : kk - 2;\n"
         "        const float4 pl = s_plane[j][k];"),
        ("        rej = rej || (para && pl.w > 0.0f);\n      }",
         "        rej = rej || (para && pl.w > 0.0f);\n"
         "        if (__all_sync(0xffffffffu, rej || t_in > t_out || t_out <= 0.0f)) break;\n"
         "      }")],
    # Warp-cycles by clock64() (lane 0 of each warp): the set-up with its
    # barrier, the pixel loop, the closing barrier, the whole kernel.
    "phase_clock": [
        ('#include "capsule_common.cuh"\n',
         '#include "capsule_common.cuh"\n__device__ unsigned long long g_phase[8];\n'
         'extern "C" int read_phase(unsigned long long* h) {\n'
         '  const int e = (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n'
         '  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n'
         '  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  return e;\n}\n'),
        ("  const int start = tile_start[tile];\n",
         "  long long ph_setup = 0, ph_pix = 0, ph_bar = 0;\n"
         "  const long long ph_start = clock64();\n  const int start = tile_start[tile];\n"),
        ("    const int n = min(CHUNK, count - c0);\n",
         "    const int n = min(CHUNK, count - c0);\n    const long long ph0 = clock64();\n"),
        ("    __syncthreads();\n\n    for (int j = 0; j < n; ++j) {",
         "    __syncthreads();\n    const long long ph1 = clock64();\n    ph_setup += ph1 - ph0;\n\n"
         "    for (int j = 0; j < n; ++j) {"),
        ("    __syncthreads();  // the next chunk overwrites the staged candidates\n",
         "    const long long ph2 = clock64();\n    ph_pix += ph2 - ph1;\n"
         "    __syncthreads();  // the next chunk overwrites the staged candidates\n"
         "    ph_bar += clock64() - ph2;\n"),
        ("  if (work != nullptr && tid == 0) work[tile] = count;",
         "  if ((tid & 31) == 0) {\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_setup);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_pix);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)ph_bar);\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)(clock64() - ph_start));\n  }\n"
         "  if (work != nullptr && tid == 0) work[tile] = count;")],
}
# The first design's third phase is its closing barrier, the redesign's the
# winner's G-buffer.
B4_PHASES = ("setup", "pixels", "after_pixels", "total")
# `kernel_info` for a source of that design, which lacks it.
B4_PARENT_INFO = r"""
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 1) return (int)cudaErrorInvalidValue;
  const int threads = i == 0 ? 512 : 128;
  const char* nm = i == 0 ? "512 threads (32x16)" : "128 threads (16x8)";
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, (const void*)prism_raster_kernel);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, prism_raster_kernel, threads, 0);
  v[0] = a.numRegs; v[1] = (int)a.localSizeBytes; v[2] = (int)a.sharedSizeBytes; v[3] = nb;
  v[4] = threads; v[5] = 0;
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return e;
}
"""
# The same for the redesign (S a template argument, set-up one thread per
# (plane, candidate), tiles longest run first).
_PHASE_COUNTERS = (
    '#include "capsule_common.cuh"\n',
    '#include "capsule_common.cuh"\n__device__ unsigned long long g_phase[8];\n'
    'extern "C" int read_phase(unsigned long long* h) {\n'
    '  const int e = (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n'
    '  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n'
    '  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  return e;\n}\n')
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

# B6, the first design of csrc/bvh_wavefront.cu (K nodes in registers, the record
# fetched after the pop, three barriers a visit).
B6_PARENT_VARIANTS = {
    # The traversal alone: leaf rows treated as none.
    "traversal_only": [("    if (has_leaf) {\n      ++leaf_visits;",
                        "    if (false) {\n      ++leaf_visits;")],
    # The leaf tests without sweeps (their hit count kept alive).
    "no_sweeps": [("      for (int sw = 0; sw < K && nhit > 0; ++sw) {",
                   "      my_members += nhit;\n      for (int sw = 0; sw < 0 && nhit > 0; ++sw) {")],
    # Warp-cycles by clock64() (lane 0 of each warp): the pop and record
    # fetch with the two barriers around it, the slab test with the
    # reduction and its barrier, the leaf tests, the sweeps, the push, the
    # whole kernel.
    "phase_clock": [
        ('#include "capsule_common.cuh"\n',
         '#include "capsule_common.cuh"\n__device__ unsigned long long g_phase[8];\n'
         'extern "C" int read_phase(unsigned long long* h) {\n'
         '  const int e = (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n'
         '  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n'
         '  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  return e;\n}\n'),
        ("  bool failed = false;\n",
         "  bool failed = false;\n"
         "  long long ph_wait = 0, ph_slab = 0, ph_leaf = 0, ph_sweep = 0, ph_push = 0;\n"
         "  const long long ph_start = clock64();\n"),
        ("  while (sp > 0) {\n    __syncthreads();",
         "  while (sp > 0) {\n    const long long ph0 = clock64();\n    __syncthreads();"),
        ("    __syncthreads();\n    ++visits;\n",
         "    __syncthreads();\n    ++visits;\n    const long long ph1 = clock64();\n"
         "    ph_wait += ph1 - ph0;\n"),
        ("    const unsigned any = s_any;\n",
         "    const unsigned any = s_any;\n    const long long ph2 = clock64();\n"
         "    ph_slab += ph2 - ph1;\n"),
        ("      // At most K sweeps: the nearest tie window each.\n",
         "      const long long ph3 = clock64();\n      ph_leaf += ph3 - ph2;\n"
         "      // At most K sweeps: the nearest tie window each.\n"),
        ("      }\n    }\n\n    // Push the internal children that any ray still wants, in row order.\n",
         "      }\n      ph_sweep += clock64() - ph3;\n    }\n\n    const long long ph4 = clock64();\n"
         "    // Push the internal children that any ray still wants, in row order.\n"),
        ("    max_sp = max(max_sp, sp);\n  }\n",
         "    max_sp = max(max_sp, sp);\n    ph_push += clock64() - ph4;\n  }\n"),
        ("  if (failed && tid == 0) atomicExch(overflow, 1);",
         "  if ((tid & 31) == 0) {\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_wait);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_slab);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)ph_leaf);\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)ph_sweep);\n"
         "    atomicAdd(&g_phase[4], (unsigned long long)ph_push);\n"
         "    atomicAdd(&g_phase[5], (unsigned long long)(clock64() - ph_start));\n  }\n"
         "  if (failed && tid == 0) atomicExch(overflow, 1);")],
}
B6_PHASES = ("pop_fetch", "slab", "leaf_tests", "sweeps", "push", "total")
B6_PARENT_INFO = r"""
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  const void* f;
  const char* nm;
  if (i == 0) { f = (const void*)wavefront_kernel<8>; nm = "KMAX 8"; }
  else if (i == 1) { f = (const void*)wavefront_kernel<16>; nm = "KMAX 16"; }
  else if (i == 2) { f = (const void*)wavefront_kernel<32>; nm = "KMAX 32"; }
  else return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, P, 0);
  v[0] = a.numRegs; v[1] = (int)a.localSizeBytes; v[2] = (int)a.sharedSizeBytes; v[3] = nb;
  v[4] = P; v[5] = 0;
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return e;
}
"""
# The same for the redesign (nodes in shared memory, the next record in
# flight during the leaf work, one barrier a visit).
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


def _build_variants(out_dir: Path, source: str, variant_sets: list, info: str = ""):
    """Each variant of csrc/<source>.cu, of the first set in `variant_sets`
    whose every text the source holds once, compiled into its own library,
    all nvcc started together -> {name: (path, ptxas lines, seconds)}.
    `info` (a `kernel_info` entry point) is appended to a source that has
    none."""
    from linevis_tpu_torch.kernels import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    if info and "kernel_info" not in src:
        src += info
    out_dir.mkdir(parents=True, exist_ok=True)
    for variants in variant_sets:
        if all(src.count(old) == 1 for subs in variants.values() for old, _ in subs):
            break
    else:
        raise SystemExit(f"{source}.cu matches none of the variant sets")
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
    libs = _build_variants(_build.BUILD_DIR / "split", "ao_grid", [B5_VARIANTS, {}])
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
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_capsule_oit",
                           [FIRST_DESIGN_VARIANTS, VARIANTS])
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
        fig[name]["phase_share"] = {}
        for m, fn in modes.items():
            fn()
            torch.cuda.synchronize()
            lib.read_phase(buf)
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
    warp-cycle shares of `phases` where it has `read_phase`."""
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
        fig[name] = {"instances": _kernel_info(lib), "nvcc_s": libs[name][2], "ms": {},
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
        lib = use(name)
        if not hasattr(lib, "read_phase"):
            continue
        buf = (ctypes.c_ulonglong * 8)()
        lib.read_phase(buf)  # zero the counters
        fig[name]["phase_share"] = {}
        for m, fn in modes.items():
            fn()
            torch.cuda.synchronize()
            lib.read_phase(buf)
            total = float(buf[len(phases) - 1])
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
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_prism",
                           [B4_PARENT_VARIANTS, B4_VARIANTS], B4_PARENT_INFO)
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
    libs = _build_variants(_build.BUILD_DIR / "split", "bvh_wavefront",
                           [B6_PARENT_VARIANTS, B6_VARIANTS], B6_PARENT_INFO)
    fig["variants"] = _variant_figures("bvh_wavefront", libs, modes, turns, B6_PHASES)
    for name, v in fig["variants"].items():
        print(f"b6 {name}: " + json.dumps(v), flush=True)
    res["b6"] = fig


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
    traj = tornado_trajectories(dev)
    scene = tornado_scene(dev, traj=traj)
    res = {"gpu": gpu}
    which = (args[args.index("--kernels") + 1] if "--kernels" in args else "b5,b2,b4,b6")
    for k in which.split(","):
        if k == "b4":
            _b4(dev, traj, W, H, res, turns)
        else:
            {"b5": _b5, "b2": _b2, "b6": _b6}[k](dev, scene, W, H, res, turns)
    print(json.dumps(res), flush=True)
    if "--out" in args:
        out = Path(args[args.index("--out") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
