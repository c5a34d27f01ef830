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
//  - The block loops over its run in chunks of up to CHUNK candidates. The
//    threads stage the payload rows the intersection reads (13 of the 24
//    rows: 0-10, 13, 15) into shared memory, coalesced along the pair axis;
//    every thread then reads each candidate scalar as a shared-memory
//    broadcast. Runs are pair-granular and start anywhere: the staging
//    loop bounds-checks the run's end instead of padding to an alignment.
//  - Early-z chunk exit, as on the TPU: before a chunk is evaluated, a
//    block max-reduction of the current depth is held against the chunk's
//    minimum bucket-floored depth (payload row 15). Runs are front to back,
//    so once the chunk lies behind every pixel of the tile, so does the rest
//    of the run. This is result-preserving and the kernel's main saving.
//  - Each thread keeps its best world-space t and the winner's G-buffer in
//    registers and writes its pixel once at the end. Pixels past the image
//    edge compute like the others; unpack_tiles crops them, as in JAX.
//
// Precision: segments are ~1e-3 of the camera distance, so the capsule
// quadratic is solved with the ray re-origined at its closest approach to
// the segment midpoint (as the TPU kernel does), and the file is built
// without --use_fast_math and with --fmad=false: IEEE sqrt and division,
// and the same rounding as the plain PyTorch version
// (`rasterize_capsules_reference`) that the kernel is held against.
//
// Bound on the H100: FP32 ALU. Every (candidate, pixel) evaluation costs
// ~140 float operations (three quadratics, three AA signed distances with
// their sqrt and reciprocals) against ~52 bytes of staged payload shared by
// the block's 512 threads, so the bytes from device memory are negligible
// next to the arithmetic: the least time is
//   sum over tiles (candidates evaluated after early-z) * P * ops / 67 TFLOP/s.
// Speed work (cp.async/TMA double-buffered staging, several tiles per
// block, register tuning) is left to later changes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "capsule_common.cuh"

#define CHUNK 128
#define NROWS 13          // staged payload rows
#define ROW_CAP_A 11      // staged index of payload row 13
#define ROW_ZQ 12         // staged index of payload row 15

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

#define MAX_THREADS 512   // pixels per tile: 32x16 on the main path

__global__ void __launch_bounds__(MAX_THREADS)
capsule_raster_kernel(const float* __restrict__ payload, long long ld,
                      const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                      const float* __restrict__ params, float* __restrict__ out,
                      int* __restrict__ work, int n_tiles, int tiles_x, int tile_w,
                      float sx, float sy, int use_early_z, int use_aa) {
  __shared__ float s[NROWS][CHUNK];
  __shared__ float s_zmax[32];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = P >> 5;

  const PixelRay ray = pixel_ray(params, tile, tid, tiles_x, tile_w, P / tile_w, sx, sy);
  const float invlen = ray.invlen;
  const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz;
  const float zA = params[9], zB = params[10], px = params[19];

  float best_t = BIG, best_id = BIG, zcur = 2.0f;
  float w_attr = 0.f, w_nx = 0.f, w_ny = 0.f, w_nz = 0.f;
  float w_tx = 0.f, w_ty = 0.f, w_tz = 0.f, w_cov = 0.f;

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  int evaluated = 0;
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    const float* src = payload + (long long)start + c0;
    for (int i = tid; i < NROWS * CHUNK; i += P) {
      const int r = i / CHUNK, j = i - r * CHUNK;
      if (j < n) s[r][j] = src[(long long)payload_row(r) * ld + j];
    }
    if (use_early_z) {
      const float zm = warp_max(zcur);
      if (lane == 0) s_zmax[warp] = zm;
    }
    __syncthreads();
    if (use_early_z) {
      // Every thread computes the same two reductions: the exit is uniform.
      float zfar = s_zmax[0];
      for (int w = 1; w < nwarps; ++w) zfar = fmaxf(zfar, s_zmax[w]);
      float zmin = 3.0f;
      for (int j = lane; j < n; j += 32) zmin = fminf(zmin, s[ROW_ZQ][j]);
      zmin = warp_min(zmin);
      if (zmin > zfar) break;
    }
    evaluated += n;

    for (int j = 0; j < n; ++j) {
      const float oa0 = s[0][j], oa1 = s[1][j], oa2 = s[2][j];
      const float ba0 = s[3][j], ba1 = s[4][j], ba2 = s[5][j];
      const float r_w = s[6][j];
      const float baba = s[10][j];
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
      const float tb = (-k1 - sqrtf(fmaxf(h, 0.0f))) / k2;
      const float yb = baoa + tb * bard;
      // Sphere cap at a.
      const float ha = rd * rd - (oaoa - rr);
      const float ta = -rd - sqrtf(fmaxf(ha, 0.0f));
      const float ya = baoa + ta * bard;
      // Sphere cap at b.
      const float b1b = rd - bard;
      const float obob = oaoa - 2.0f * baoa + baba;
      const float hb = b1b * b1b - (obob - rr);
      const float tbb = -b1b - sqrtf(fmaxf(hb, 0.0f));
      const float yb2 = baoa + tbb * bard;
      const bool cap_a = s[ROW_CAP_A][j] > 0.5f;

      bool okb, oka, okb2;
      float sdb = 0.f, sda = 0.f, sdb2 = 0.f;
      if (use_aa) {
        // Body miss distance as the ray-to-axis line distance
        // |oa' . (dn x ba)| / |dn x ba|: the TPU kernel's equal form
        // r^2 - h / (k2 |ba|^2) cancels in f32 for segments ~1e-3 long.
        const float nx = dny * ba2 - dnz * ba1;
        const float ny = dnz * ba0 - dnx * ba2;
        const float nz = dnx * ba1 - dny * ba0;
        const float on = oax * nx + oay * ny + oaz * nz;
        sdb = sdist(r_w, on * on / fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f), t0 + tb,
                    invlen, px);
        sda = sdist(r_w, rr - ha, t0 + ta, invlen, px);
        sdb2 = sdist(r_w, rr - hb, t0 + tbb, invlen, px);
        okb = (sdb > -0.5f) && (yb > 0.0f) && (yb < baba);
        oka = (sda > -0.5f) && (ya <= 0.0f) && cap_a;
        okb2 = (sdb2 > -0.5f) && (yb2 >= baba);
      } else {
        okb = (h >= 0.0f) && (yb > 0.0f) && (yb < baba);
        oka = (ha >= 0.0f) && (ya <= 0.0f) && cap_a;
        okb2 = (hb >= 0.0f) && (yb2 >= baba);
      }
      okb = okb && (t0 + tb > 0.0f);
      oka = oka && (t0 + ta > 0.0f);
      okb2 = okb2 && (t0 + tbb > 0.0f);

      const float tall = fminf(okb ? tb : BIG, fminf(oka ? ta : BIG, okb2 ? tbb : BIG));
      if (!(tall < BIG)) continue;
      const float tw = t0 + tall;
      const float id = s[9][j];
      if (!(tw < best_t || (tw == best_t && id < best_id))) continue;

      best_t = tw;
      best_id = id;
      zcur = zA - zB / fmaxf(tw * invlen, 1e-12f);
      const float uax = clamp01((baoa + tall * bard) / baba);
      w_attr = s[7][j] + s[8][j] * uax;
      w_nx = tall * dnx + oax - ba0 * uax;
      w_ny = tall * dny + oay - ba1 * uax;
      w_nz = tall * dnz + oaz - ba2 * uax;
      w_tx = ba0;
      w_ty = ba1;
      w_tz = ba2;
      if (use_aa) {
        w_cov = fmaxf(okb ? clamp01(0.5f + sdb) : 0.0f,
                      fmaxf(oka ? clamp01(0.5f + sda) : 0.0f,
                            okb2 ? clamp01(0.5f + sdb2) : 0.0f));
      } else {
        w_cov = 1.0f;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  const long long plane = (long long)n_tiles * P;
  float* o = out + (long long)tile * P + tid;
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

// Launches one block of tile_w * tile_h threads per tile on `stream`.
// out: [10, n_tiles, tile_w * tile_h] float32. work: optional [n_tiles]
// int32, the candidates each tile evaluated after early-z. Returns the
// cudaGetLastError() code of the launch.
extern "C" int raster_capsule_launch(const float* payload, long long ld,
                                     const int* tile_start, const int* tile_count,
                                     const float* params, float* out, int* work,
                                     int n_tiles, int tiles_x, int tile_w, int tile_h,
                                     float sx, float sy, int use_early_z, int use_aa,
                                     void* stream) {
  if (n_tiles > 0) {
    capsule_raster_kernel<<<n_tiles, tile_w * tile_h, 0, (cudaStream_t)stream>>>(
        payload, ld, tile_start, tile_count, params, out, work, n_tiles, tiles_x, tile_w,
        sx, sy, use_early_z, use_aa);
  }
  return (int)cudaGetLastError();
}
