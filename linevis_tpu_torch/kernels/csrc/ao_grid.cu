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
// Design (one block per pair chunk; 128 rays x 8 slot groups = 1024
// threads):
//  - thread (r, q) holds ray r of the chunk in registers and tests it
//    against slots 16q .. 16q+15 of each staged record chunk (8 rows x 128
//    slots, 4 KB of shared memory, every read a warp-wide broadcast).
//    Splitting the slots eight ways shortens the longest block of a launch:
//    the pair chunk in which the kept pairs end and the dropped ones begin
//    walks every record from its first cell to the end of the grid.
//  - the rays' flags live in shared memory; a thread skips a record chunk
//    once its ray is occluded, and `__syncthreads_and` over the flags is the
//    saturation exit before the next record chunk is staged.
//  - a block whose seg_chunks is 0 writes zeros and returns at once; slots
//    past the records' end read as the unhittable padding record.
//
// Precision: built with --fmad=false and without fast math; every product
// and sum is rounded on its own, in the order of the plain version, so the
// two agree on every pair.
//
// Bound on the H100: FP32 ALU. A (slot, ray) test is 94 float operations
// (each add, multiply, negation, min/max, compare, sqrt and division of the
// loop body below counted once) against 32 bytes of staged record shared by
// 128 rays; chip_smoke.py computes the least time from the `tests` counts:
// the hittable slots of each walked record chunk times the rays not yet
// occluded when it is staged.
// Speed work (cp.async double buffering of the record chunks, several pair
// chunks per block) is left to later changes.

#include <cuda_runtime.h>

#define C 128      // pairs per chunk, slots per record chunk
#define SPLIT 8    // slot groups per ray
#define POISON 1e10f

__global__ void __launch_bounds__(C * SPLIT)
ao_kernel(const float* __restrict__ rays, long long ld_rays,
          const int* __restrict__ seg_begin, const int* __restrict__ seg_chunks,
          const float* __restrict__ records, long long ld_rec, float* __restrict__ occ,
          int* __restrict__ walked, int* __restrict__ tests) {
  __shared__ float s[8][C];
  __shared__ volatile int s_occ[C];

  const int pc = blockIdx.x;
  const int r = threadIdx.x, q = threadIdx.y;
  const int tid = q * C + r;
  const int n = seg_chunks[pc];
  if (n <= 0) {
    if (q == 0) occ[(long long)pc * C + r] = 0.0f;
    if (walked != nullptr && tid == 0) walked[pc] = 0;
    if (tests != nullptr && tid == 0) tests[pc] = 0;
    return;
  }
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
        const float tb = (-k1 - sqrtf(fmaxf(h, 0.0f))) / k2;
        const float yb = baoa + tb * bard;
        const float ha = rd * rd - (oaoa - rr);
        const float ta = -rd - sqrtf(fmaxf(ha, 0.0f));
        const float ya = baoa + ta * bard;
        const float b1b = rd - bard;
        const float obob = oaoa - 2.0f * baoa + baba;
        const float hb = b1b * b1b - (obob - rr);
        const float tc = -b1b - sqrtf(fmaxf(hb, 0.0f));
        const float yc = baoa + tc * bard;
        const float twb = t0 + tb, twa = t0 + ta, twc = t0 + tc;
        hit = (h >= 0.0f && yb > 0.0f && yb < baba && twb > 1e-4f && twb < tmax) ||
              (ha >= 0.0f && ya <= 0.0f && twa > 1e-4f && twa < tmax) ||
              (hb >= 0.0f && yc >= baba && twc > 1e-4f && twc < tmax);
      }
      if (hit) s_occ[r] = 1;
    }
    ++c;
    __syncthreads();  // the flags of this record chunk are written
    if (__syncthreads_and(s_occ[r])) break;
  }
  if (q == 0) occ[col] = s_occ[r] ? 1.0f : 0.0f;
  if (walked != nullptr && tid == 0) walked[pc] = c;
  if (tests != nullptr && tid == 0) tests[pc] = n_tests;
}

// Launches one block of 128 x 8 threads per pair chunk on `stream`. rays:
// [>= 7, ld_rays] with at least n_chunks * 128 columns; records: [8, ld_rec];
// occ: [n_chunks * 128] float32; walked: optional [n_chunks] int32, the
// record chunks each pair chunk tested; tests: optional [n_chunks] int32, the
// (hittable slot, unoccluded ray) tests its result needed. Returns the
// cudaGetLastError() code of the launch.
extern "C" int ao_grid_launch(const float* rays, long long ld_rays, const int* seg_begin,
                              const int* seg_chunks, const float* records,
                              long long ld_rec, float* occ, int* walked, int* tests,
                              int n_chunks, void* stream) {
  if (n_chunks > 0) {
    const dim3 grid(n_chunks), block(C, SPLIT);
    ao_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(rays, ld_rays, seg_begin,
                                                        seg_chunks, records, ld_rec, occ,
                                                        walked, tests);
  }
  return (int)cudaGetLastError();
}
