// Opaque capsule (linear swept sphere) tile rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_capsule_kernel` in
// linevis_tpu/kernels/raster_capsule.py:52 (wrapper
// `rasterize_capsules_pallas`, :410). It computes the same function: for
// every screen tile, walk that tile's depth-bucket-ordered run of
// (tile, segment) pairs from the sort-carried binning, intersect each
// pixel's ray with each candidate capsule, keep the nearest hit (ties go to
// the lower segment id) and write its G-buffer: z_ndc, id, attribute,
// unnormalized normal and tangent, and the analytic edge-AA coverage.
//
// Design (one block per tile, one thread per pixel):
//  - Blocks take the tiles longest run first (`order`, the wrapper's sort
//    of `tile_count`): on the 1080p tornado the longest run (569
//    candidates) alone takes 0.57 ms on an H100, and in index order it
//    started late and set the tail. Output goes to each tile's own slot,
//    so the order changes no pixel.
//  - The block loops over its run in chunks of up to CHUNK candidates. The
//    threads stage the payload rows the intersection reads (13 of the 24
//    rows: 0-10, 13, 15) into shared memory, coalesced along the pair axis;
//    every thread then reads each candidate scalar as a shared-memory
//    broadcast. Two buffers: a chunk is staged while no thread still reads
//    the buffer it overwrites, so a chunk costs one barrier.
//  - Coverage AA and early-z are template arguments (four instances): a
//    run-time flag keeps registers for both paths.
//  - Each warp holds an 8x4 block of the tile's pixels, so that a capsule a
//    few pixels across meets few warps, and the warp votes skip work that
//    no pixel of the warp reads. Each skip is exact: the value skipped is
//    read only where the rest of its conjunction holds, which the vote
//    found false at every pixel of the warp.
//      * The start cap (payload row 13) exists only at a chain start (677
//        of 212,889 pairs on the tornado). It is staged per candidate, so
//        its root and AA distance sit behind a branch that is uniform across
//        the block; without it `oka` is false whatever `ta` holds.
//      * With AA, a part's signed pixel distance (sqrt, reciprocal) only
//        after a vote on the rest of its test: the body's axial range and
//        t > 0, the end cap's axial range and t > 0.
//      * Without AA, a root (sqrt, and the body's division) only after a
//        vote on its discriminant.
//  - Early-z chunk exit, as on the TPU: before a chunk is evaluated, a
//    block max-reduction of the current depth is held against the chunk's
//    minimum bucket-floored depth (payload row 15). Runs are front to back,
//    so once the chunk lies behind every pixel of the tile, so does the rest
//    of the run. This is result-preserving.
//  - Each thread keeps its best world-space t and the winner's G-buffer in
//    registers and writes its pixel once at the end. Pixels past the image
//    edge compute like the others; unpack_tiles crops them, as in JAX.
//
// Precision: segments are ~1e-3 of the camera distance, so the capsule
// quadratic is solved with the ray re-origined at its closest approach to
// the segment midpoint (as the TPU kernel does), and the file is built
// without --use_fast_math and with --fmad=false: IEEE sqrt and division,
// and the same rounding as the plain PyTorch version
// (`rasterize_capsules_reference`) that the kernel is held against, bit for
// bit.
//
// Bound on the H100: FP32 ALU. Every (candidate, pixel) evaluation costs
// ~140 float operations (three quadratics, three AA signed distances with
// their sqrt and reciprocals; the start cap's ~20 only at a chain start)
// against ~52 bytes of staged payload shared by the block's 512 threads, so
// the bytes from device memory are negligible next to the arithmetic:
//   sum over tiles (candidates evaluated after early-z) * P * ops / 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "capsule_common.cuh"

#define CHUNK 128
#define NROWS 13          // staged payload rows
#define ROW_CAP_A 11      // staged index of payload row 13
#define ROW_ZQ 12         // staged index of payload row 15
#define MAX_THREADS 512   // pixels per tile: 32x16 on the main path
#define MIN_BLOCKS 2      // resident 512-thread blocks per SM: at most 64 registers
#define FULL 0xffffffffu

__device__ __forceinline__ int payload_row(int staged) {
  return staged < 11 ? staged : (staged == ROW_CAP_A ? 13 : 15);
}

// Signed pixel distance of the silhouette: (r - miss distance) / pixel
// footprint at the hit's view depth.
__device__ __forceinline__ float sdist(float r_w, float d2, float t_world, float invlen,
                                       float px) {
  float w_px = fmaxf(t_world * invlen, 1e-6f) * px;
  return (r_w - sqrtf(fmaxf(d2, 0.0f))) * (1.0f / w_px);
}

template <bool AA, bool EZ>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
capsule_raster_kernel(const float* __restrict__ payload, long long ld,
                      const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                      const int* __restrict__ order, const float* __restrict__ params,
                      float* __restrict__ out, int* __restrict__ work, int n_tiles, int tiles_x,
                      int tile_w, float sx, float sy) {
  __shared__ float s[2][NROWS][CHUNK];
  __shared__ float s_zmax[2][MAX_THREADS / 32];

  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = P >> 5;
  // The warp's 8x4 pixel block; lane l is pixel (l % 8, l / 8) in it.
  const int bw = tile_w / 8;
  const int pix = ((warp / bw) * 4 + lane / 8) * tile_w + (warp % bw) * 8 + lane % 8;

  const PixelRay ray = pixel_ray(params, tile, pix, tiles_x, tile_w, P / tile_w, sx, sy);
  const float invlen = ray.invlen;
  const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz;
  const float zA = params[9], zB = params[10], px = params[19];

  float best_t = BIG, best_id = BIG, zcur = 2.0f;
  float w_attr = 0.f, w_nx = 0.f, w_ny = 0.f, w_nz = 0.f;
  float w_tx = 0.f, w_ty = 0.f, w_tz = 0.f, w_cov = 0.f;

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  int evaluated = 0;
  for (int c0 = 0, b = 0; c0 < count; c0 += CHUNK, b ^= 1) {
    const int n = min(CHUNK, count - c0);
    float(*const sc)[CHUNK] = s[b];
    const float* src = payload + (long long)start + c0;
    for (int i = tid; i < NROWS * CHUNK; i += P) {
      const int r = i / CHUNK, j = i - r * CHUNK;
      if (j < n) sc[r][j] = src[(long long)payload_row(r) * ld + j];
    }
    if (EZ) {
      const float zm = warp_max(zcur);
      if (lane == 0) s_zmax[b][warp] = zm;
    }
    // The one barrier of a chunk: its rows (and the depth maxima) are
    // visible, and every thread is past the last chunk, so the next one may
    // overwrite the other buffer.
    __syncthreads();
    if (EZ) {
      // Every thread computes the same two reductions: the exit is uniform.
      float zfar = s_zmax[b][0];
      for (int w = 1; w < nwarps; ++w) zfar = fmaxf(zfar, s_zmax[b][w]);
      float zmin = 3.0f;
      for (int j = lane; j < n; j += 32) zmin = fminf(zmin, sc[ROW_ZQ][j]);
      zmin = warp_min(zmin);
      if (zmin > zfar) break;
    }
    evaluated += n;

    for (int j = 0; j < n; ++j) {
      const float oa0 = sc[0][j], oa1 = sc[1][j], oa2 = sc[2][j];
      const float ba0 = sc[3][j], ba1 = sc[4][j], ba2 = sc[5][j];
      const float r_w = sc[6][j];
      const float baba = sc[10][j];
      const float bard = ba0 * dnx + ba1 * dny + ba2 * dnz;
      const float rdoa = oa0 * dnx + oa1 * dny + oa2 * dnz;
      const float rr = r_w * r_w;

      // Re-origin the ray at its closest approach to the segment midpoint.
      const float t0 = -(rdoa + 0.5f * bard);
      const float oax = oa0 + t0 * dnx;
      const float oay = oa1 + t0 * dny;
      const float oaz = oa2 + t0 * dnz;
      const float baoa = ba0 * oax + ba1 * oay + ba2 * oaz;
      const float oaoa = oax * oax + oay * oay + oaz * oaz;
      const float rd = rdoa + t0;

      // Cylinder body.
      const float k2 = fmaxf(baba - bard * bard, 1e-20f);
      const float k1 = baba * rd - baoa * bard;
      const float k0 = baba * oaoa - baoa * baoa - rr * baba;
      const float h = k1 * k1 - k2 * k0;
      float tb = 0.0f, sdb = 0.0f;
      bool okb = false;
      if (AA || __any_sync(FULL, h >= 0.0f)) {
        tb = (-k1 - sqrtf(fmaxf(h, 0.0f))) / k2;
        const float yb = baoa + tb * bard;
        okb = (AA || h >= 0.0f) && (yb > 0.0f) && (yb < baba) && (t0 + tb > 0.0f);
      }
      if (AA && __any_sync(FULL, okb)) {
        // Body miss distance as the ray-to-axis line distance
        // |oa' . (dn x ba)| / |dn x ba|: the TPU kernel's equal form
        // r^2 - h / (k2 |ba|^2) cancels in f32 for segments ~1e-3 long.
        const float nx = dny * ba2 - dnz * ba1;
        const float ny = dnz * ba0 - dnx * ba2;
        const float nz = dnx * ba1 - dny * ba0;
        const float on = oax * nx + oay * ny + oaz * nz;
        sdb = sdist(r_w, on * on / fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f), t0 + tb,
                    invlen, px);
        okb = okb && (sdb > -0.5f);
      }

      // Sphere cap at a: only at a chain start (uniform across the block).
      float ta = 0.0f, sda = 0.0f;
      bool oka = false;
      if (sc[ROW_CAP_A][j] > 0.5f) {
        const float ha = rd * rd - (oaoa - rr);
        if (AA || __any_sync(FULL, ha >= 0.0f)) {
          ta = -rd - sqrtf(fmaxf(ha, 0.0f));
          const float ya = baoa + ta * bard;
          oka = (AA || ha >= 0.0f) && (ya <= 0.0f) && (t0 + ta > 0.0f);
        }
        if (AA && __any_sync(FULL, oka)) {
          sda = sdist(r_w, rr - ha, t0 + ta, invlen, px);
          oka = oka && (sda > -0.5f);
        }
      }

      // Sphere cap at b.
      const float b1b = rd - bard;
      const float obob = oaoa - 2.0f * baoa + baba;
      const float hb = b1b * b1b - (obob - rr);
      float tbb = 0.0f, sdb2 = 0.0f;
      bool okb2 = false;
      if (AA || __any_sync(FULL, hb >= 0.0f)) {
        tbb = -b1b - sqrtf(fmaxf(hb, 0.0f));
        const float yb2 = baoa + tbb * bard;
        okb2 = (AA || hb >= 0.0f) && (yb2 >= baba) && (t0 + tbb > 0.0f);
      }
      if (AA && __any_sync(FULL, okb2)) {
        sdb2 = sdist(r_w, rr - hb, t0 + tbb, invlen, px);
        okb2 = okb2 && (sdb2 > -0.5f);
      }

      const float tall = fminf(okb ? tb : BIG, fminf(oka ? ta : BIG, okb2 ? tbb : BIG));
      if (!(tall < BIG)) continue;
      const float tw = t0 + tall;
      const float id = sc[9][j];
      if (!(tw < best_t || (tw == best_t && id < best_id))) continue;

      best_t = tw;
      best_id = id;
      zcur = zA - zB / fmaxf(tw * invlen, 1e-12f);
      const float uax = clamp01((baoa + tall * bard) / baba);
      w_attr = sc[7][j] + sc[8][j] * uax;
      w_nx = tall * dnx + oax - ba0 * uax;
      w_ny = tall * dny + oay - ba1 * uax;
      w_nz = tall * dnz + oaz - ba2 * uax;
      w_tx = ba0;
      w_ty = ba1;
      w_tz = ba2;
      if (AA) {
        w_cov = fmaxf(okb ? clamp01(0.5f + sdb) : 0.0f,
                      fmaxf(oka ? clamp01(0.5f + sda) : 0.0f,
                            okb2 ? clamp01(0.5f + sdb2) : 0.0f));
      } else {
        w_cov = 1.0f;
      }
    }
  }

  const long long plane = (long long)n_tiles * P;
  float* o = out + (long long)tile * P + pix;
  const bool hit = best_t < BIG;
  o[0 * plane] = zcur;
  o[1 * plane] = hit ? best_id : -1.0f;
  o[2 * plane] = w_attr;
  o[3 * plane] = w_nx;
  o[4 * plane] = w_ny;
  o[5 * plane] = w_nz;
  o[6 * plane] = w_tx;
  o[7 * plane] = w_ty;
  o[8 * plane] = w_tz;
  o[9 * plane] = w_cov;
  if (work != nullptr && tid == 0) work[tile] = evaluated;
}

typedef void (*capsule_kernel_t)(const float*, long long, const int*, const int*, const int*,
                                 const float*, float*, int*, int, int, int, float, float);

static capsule_kernel_t capsule_instance(int use_aa, int use_early_z) {
  if (use_aa)
    return use_early_z ? capsule_raster_kernel<true, true> : capsule_raster_kernel<true, false>;
  return use_early_z ? capsule_raster_kernel<false, true> : capsule_raster_kernel<false, false>;
}

// Launches one block of tile_w * tile_h threads per tile on `stream`.
// order: [n_tiles] int32, the tiles in the order the blocks take them (a
// permutation). out: [10, n_tiles, tile_w * tile_h] float32. work: optional
// [n_tiles] int32, the candidates each tile evaluated after early-z.
// Returns a CUDA error code: cudaErrorInvalidValue for a tile the warps'
// 8x4 pixel blocks do not cover (tile_w a multiple of 8, tile_h of 4, at
// most MAX_THREADS pixels), else that of the launch.
extern "C" int raster_capsule_launch(const float* payload, long long ld,
                                     const int* tile_start, const int* tile_count,
                                     const int* order, const float* params, float* out,
                                     int* work, int n_tiles, int tiles_x, int tile_w, int tile_h,
                                     float sx, float sy, int use_early_z, int use_aa,
                                     void* stream) {
  if (tile_w % 8 || tile_h % 4 || tile_w * tile_h > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const capsule_kernel_t kernel = capsule_instance(use_aa, use_early_z);
    kernel<<<n_tiles, tile_w * tile_h, 0, (cudaStream_t)stream>>>(
        payload, ld, tile_start, tile_count, order, params, out, work, n_tiles, tiles_x, tile_w,
        sx, sy);
  }
  return (int)cudaGetLastError();
}

// Resources of the four instances (i = 2 * use_aa + use_early_z) at 512
// threads: v = (registers, local bytes, static shared bytes, resident blocks
// per SM, threads, dynamic shared bytes), `label` its name. Returns a CUDA
// error code, cudaErrorInvalidValue past the last instance.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 3) return (int)cudaErrorInvalidValue;
  const void* f = (const void*)capsule_instance(i >> 1, i & 1);
  const char* nm = i == 0 ? "no AA, no early-z" : i == 1 ? "no AA, early-z"
                 : i == 2 ? "AA, no early-z" : "AA, early-z";
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, MAX_THREADS, 0);
  if (e) return e;
  v[0] = a.numRegs;
  v[1] = (int)a.localSizeBytes;
  v[2] = (int)a.sharedSizeBytes;
  v[3] = nb;
  v[4] = MAX_THREADS;
  v[5] = 0;
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
