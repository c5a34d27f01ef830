// Ambient-occlusion grid trace for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ao_kernel` in
// linevis_tpu/kernels/ao_grid.py:157 (wrapper `_trace_pairs`, :304): for
// each chunk of 128 cell-sorted (cell, ray) pairs, a dense [segments x rays]
// ray-capsule any-hit test (body and both end spheres, entry surfaces,
// 1e-4 < t < t_max) over the contiguous slot range
// [seg_begin, seg_begin + seg_chunks * 128) of the cell-sorted segment
// records, one flag per pair. A pair chunk stops walking once all its 128
// rays are occluded. The plain PyTorch version it is held against is
// `trace_pairs_reference` (kernels/ao_grid.py).
//
// What bounds it on the H100, measured on the first design (one 1024-thread
// block per pair chunk; tools/kernel_split.py on the first 1080p batch of
// the tornado's RTAO frame, 1.20 ms): 3,582 of the 129,600 pair chunks are
// active (the rest hold dropped pairs, seg_chunks 0), and the same launch
// with every chunk empty took 0.58 ms; the active chunks alone 0.72 ms. The
// longest walk is 13 record chunks (0.17 ms alone), so no walk sets the
// pace; most walk 1 or 2.
//
// Design (a persistent grid; blocks of 128 rays x 8 slot groups = 1024
// threads):
//  - as many blocks as the card holds at once, and no block spent on an
//    empty pair chunk: the blocks first claim slices of 1024 pair chunks
//    with an atomic, scan their seg_chunks (one load a thread) and append
//    the active ones to a work list in `sched`; once every slice is scanned
//    (a block waits only for blocks that claimed a slice, so for running
//    ones: the grid needs no co-residency) each block takes the next list
//    entry with one atomic and walks it. The pairs of empty chunks stay 0
//    in the zero-filled output; their counts are written 0. Each active
//    chunk is one sequential walk, as in the plain version, so the `walked`
//    and `tests` counts are the plain version's.
//  - at most 32 registers, so two blocks reside per SM.
//  - thread (r, q) holds ray r of the chunk in registers and tests it
//    against slots 16q .. 16q+15 of each staged record chunk (8 rows x 128
//    slots, 4 KB of shared memory, every read a warp-wide broadcast). The
//    three quadratics' roots (three square roots and a division) are taken
//    only where their discriminant is not negative: the rest miss in any
//    case.
//  - the rays' flags live in shared memory; a thread skips a record chunk
//    once its ray is occluded, and `__syncthreads_and` over the flags is the
//    saturation exit before the next record chunk is staged. Slots past the
//    records' end read as the unhittable padding record.
//
// Precision: built with --fmad=false and without fast math; every product
// and sum is rounded on its own, in the order of the plain version, so the
// two agree on every pair.
//
// Bound on the H100: FP32 ALU. A (slot, ray) test is 62 float operations up
// to the signs of the three discriminants (each add, multiply, negation,
// min/max, compare, sqrt and division of the loop body below counted once),
// and a root, only where its discriminant is not negative, 12 more for the
// body and 10 for a cap; all against 32 bytes of staged record shared by
// 128 rays. chip_smoke.py computes the least time from the plain version's
// `tests` counts (the hittable slots of each walked record chunk times the
// rays not yet occluded when it is staged) and, among those tests, the
// discriminants that are not negative.

#include <cuda_runtime.h>

#define C 128      // pairs per chunk, slots per record chunk
#define SPLIT 8    // slot groups per ray
#define SLICE (C * SPLIT)  // pair chunks a block scans for active ones at once
#define POISON 1e10f

// sched (int32, zero-filled): [0] slices of SLICE pair chunks claimed for
// scanning, [1] work-list entries written, [2] entries taken, [3] slices
// scanned, [4 + e] entry e: an active pair chunk.
__global__ void __launch_bounds__(C * SPLIT, 2)
ao_kernel(const float* __restrict__ rays, long long ld_rays,
          const int* __restrict__ seg_begin, const int* __restrict__ seg_chunks,
          const float* __restrict__ records, long long ld_rec, int* __restrict__ sched,
          float* __restrict__ occ, int* __restrict__ walked, int* __restrict__ tests,
          int n_chunks) {
  __shared__ float s[8][C];
  __shared__ volatile int s_occ[C];
  __shared__ int s_cmd, s_base;
  __shared__ int s_warp[SLICE / 32];

  const int r = threadIdx.x, q = threadIdx.y;
  const int tid = q * C + r;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_slices = (n_chunks + SLICE - 1) / SLICE;
  volatile int* vsched = sched;

  // 1. Claim slices until none is left: each slice's active chunks go to
  // the work list; the others keep their zero flags and get zero counts.
  for (;;) {
    if (tid == 0) s_cmd = atomicAdd(&sched[0], 1);
    __syncthreads();
    const int sl = s_cmd;
    if (sl >= n_slices) break;
    const int i = sl * SLICE + tid;
    const bool act = i < n_chunks && seg_chunks[i] > 0;
    if (i < n_chunks && !act) {
      if (walked != nullptr) walked[i] = 0;
      if (tests != nullptr) tests[i] = 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < SLICE / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (total > 0) {
      if (tid == 0) s_base = atomicAdd(&sched[1], total);
      __syncthreads();
      if (act) {
        sched[4 + s_base + before + __popc(ballot & ((1u << lane) - 1u))] = i;
        __threadfence();
      }
    }
    __syncthreads();  // the slice's entries are written
    if (tid == 0) atomicAdd(&sched[3], 1);
  }
  // 2. Wait until every slice is scanned: every slice is claimed, so the
  // blocks still scanning are running.
  if (tid == 0) {
    while (vsched[3] < n_slices) __nanosleep(200);
    __threadfence();
    s_base = vsched[1];
  }
  __syncthreads();
  const int n_entries = s_base;
  // 3. Walk the active chunks, one list entry at a time.
  for (;;) {
    if (tid == 0) s_cmd = atomicAdd(&sched[2], 1);
    __syncthreads();
    const int e = s_cmd;
    if (e >= n_entries) break;
    const int pc = vsched[4 + e];
    const int n = seg_chunks[pc];
    const long long begin = seg_begin[pc];
    const long long col = (long long)pc * C + r;
    const float ox = rays[0 * ld_rays + col], oy = rays[1 * ld_rays + col],
                oz = rays[2 * ld_rays + col];
    const float dx = rays[3 * ld_rays + col], dy = rays[4 * ld_rays + col],
                dz = rays[5 * ld_rays + col];
    const float tmax = rays[6 * ld_rays + col];
    if (q == 0) s_occ[r] = 0;

    int c = 0, n_tests = 0;
    while (c < n) {
      // The previous record chunk's reads ended at the barriers below.
      for (int i = tid; i < 8 * C; i += C * SPLIT) {
        const int row = i / C, j = i - row * C;
        const long long slot = begin + (long long)c * C + j;
        s[row][j] = slot < ld_rec ? records[row * ld_rec + slot] : (row < 3 ? POISON : 0.0f);
      }
      __syncthreads();
      if (tests != nullptr) {
        // Rays still to be tested x slots that can be hit (thread r of slot
        // group 0 speaks for ray r, then for slot r).
        const int live = __syncthreads_count(q == 0 && !s_occ[r]);
        n_tests += live * __syncthreads_count(q == 0 && s[0][r] < 0.5f * POISON);
      }
      if (!s_occ[r]) {
        bool hit = false;
        for (int j = q * (C / SPLIT); j < (q + 1) * (C / SPLIT) && !hit; ++j) {
          const float bax = s[3][j], bay = s[4][j], baz = s[5][j];
          const float oax = ox - s[0][j], oay = oy - s[1][j], oaz = oz - s[2][j];
          const float bard = bax * dx + bay * dy + baz * dz;
          const float rdoa = oax * dx + oay * dy + oaz * dz;
          const float baba = fmaxf(s[7][j], 1e-20f);
          const float rr = s[6][j] * s[6][j];
          // Re-origin at the closest approach to the segment midpoint.
          const float t0 = -(rdoa + 0.5f * bard);
          const float pax = oax + t0 * dx, pay = oay + t0 * dy, paz = oaz + t0 * dz;
          const float baoa = bax * pax + bay * pay + baz * paz;
          const float oaoa = pax * pax + pay * pay + paz * paz;
          const float rd = rdoa + t0;
          const float k2 = fmaxf(baba - bard * bard, 1e-20f);
          const float k1 = baba * rd - baoa * bard;
          const float k0 = baba * oaoa - baoa * baoa - rr * baba;
          const float h = k1 * k1 - k2 * k0;
          const float ha = rd * rd - (oaoa - rr);
          const float b1b = rd - bard;
          const float obob = oaoa - 2.0f * baoa + baba;
          const float hb = b1b * b1b - (obob - rr);
          // Roots only of a quadratic with real ones: a miss of all three
          // skips the square roots and the division.
          if (h >= 0.0f) {
            const float tb = (-k1 - sqrtf(fmaxf(h, 0.0f))) / k2;
            const float yb = baoa + tb * bard;
            const float twb = t0 + tb;
            hit = yb > 0.0f && yb < baba && twb > 1e-4f && twb < tmax;
          }
          if (ha >= 0.0f) {
            const float ta = -rd - sqrtf(fmaxf(ha, 0.0f));
            const float twa = t0 + ta;
            hit = hit || (baoa + ta * bard <= 0.0f && twa > 1e-4f && twa < tmax);
          }
          if (hb >= 0.0f) {
            const float tc = -b1b - sqrtf(fmaxf(hb, 0.0f));
            const float twc = t0 + tc;
            hit = hit || (baoa + tc * bard >= baba && twc > 1e-4f && twc < tmax);
          }
        }
        if (hit) s_occ[r] = 1;
      }
      ++c;
      __syncthreads();  // the flags of this record chunk are written
      if (__syncthreads_and(s_occ[r])) break;
    }
    if (q == 0 && s_occ[r]) occ[col] = 1.0f;
    if (walked != nullptr && tid == 0) walked[pc] = c;
    if (tests != nullptr && tid == 0) tests[pc] = n_tests;
    __syncthreads();  // s_cmd, s_occ and the staged records are free again
  }
}

// Launches a persistent grid of blocks of 128 x 8 threads on `stream`, as
// many as the card holds at once (at most n_chunks); the blocks scan
// seg_chunks for the active pair chunks and share them out through the work
// list in `sched`. rays: [>= 7, ld_rays] with at least
// n_chunks * 128 columns; records: [8, ld_rec]; sched: [n_chunks + 4] int32,
// zero-filled; occ: [n_chunks * 128] float32, zero-filled: only occluded
// pairs are written; walked: optional [n_chunks] int32, the record chunks
// each pair chunk tested; tests: optional [n_chunks] int32, the (hittable
// slot, unoccluded ray) tests its result needed. Returns the CUDA error
// code of the launch.
extern "C" int ao_grid_launch(const float* rays, long long ld_rays, const int* seg_begin,
                              const int* seg_chunks, const float* records,
                              long long ld_rec, int* sched, float* occ, int* walked,
                              int* tests, int n_chunks, void* stream) {
  if (n_chunks < 0 || sched == nullptr) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0) {
    static int resident[64];  // blocks the card holds at once, per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev < 0 || dev >= 64)) err = cudaErrorInvalidValue;
    if (err == cudaSuccess && resident[dev] == 0) {
      int n_sm = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ao_kernel, C * SPLIT, 0);
      if (err == cudaSuccess) resident[dev] = max(n_sm * per_sm, 1);
    }
    if (err != cudaSuccess) return (int)err;
    const int blocks = min(resident[dev], n_chunks);
    const dim3 grid(blocks), block(C, SPLIT);
    ao_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(rays, ld_rays, seg_begin, seg_chunks,
                                                        records, ld_rec, sched, occ, walked,
                                                        tests, n_chunks);
  }
  return (int)cudaGetLastError();
}
