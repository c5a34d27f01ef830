// Device helpers shared by the capsule kernels (raster_capsule.cu,
// raster_capsule_oit.cu, bvh_wavefront.cu). `kernels/capsule_common.py` holds the same
// arithmetic for their plain PyTorch versions: every helper here rounds as
// its Python counterpart does (the files build with --fmad=false, so an
// explicit __fmaf_rn, `capsule_common.fma32` there, is the only fused
// operation).
#pragma once

#include <cuda_runtime.h>

#define BIG 1e30f

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// Unrolled piecewise-linear TF over a table group of `tf_static_table`:
// [init[nch], (p0, p1, span, v0[nch], dv[nch]) per segment]. Later segments
// win at shared endpoints, as in the JAX kernel's `where` chain.
template <int NCH>
__device__ __forceinline__ void tf_eval(const float* __restrict__ g, int npts, float x,
                                        float* out) {
  const float xc = clamp01(x);
#pragma unroll
  for (int c = 0; c < NCH; ++c) out[c] = g[c];
  const float* seg = g + NCH;
  for (int k = 0; k + 1 < npts; ++k, seg += 3 + 2 * NCH) {
    if (xc >= seg[0] && xc <= seg[1]) {
      const float w = (xc - seg[0]) / seg[2];
#pragma unroll
      for (int c = 0; c < NCH; ++c) out[c] = seg[3 + c] + w * seg[3 + NCH + c];
    }
  }
}

// Unit ray of pixel `tid` of `tile` (params rows 0-8: row-major ray basis,
// dir = B @ [u_ndc, v_ndc, 1]) and 1/|dir|: capsule_common.pixel_rays.
// IEEE sqrt and division, never the approximate rsqrtf.
struct PixelRay {
  float dnx, dny, dnz, invlen;
};

__device__ __forceinline__ PixelRay pixel_ray(const float* __restrict__ params, int tile,
                                              int tid, int tiles_x, int tile_w, int tile_h,
                                              float sx, float sy) {
  const float gx = (float)((tile % tiles_x) * tile_w + tid % tile_w) + 0.5f;
  const float gy = (float)((tile / tiles_x) * tile_h + tid / tile_w) + 0.5f;
  const float un = gx * sx - 1.0f;
  const float vn = 1.0f - gy * sy;
  const float rx = params[0] * un + params[1] * vn + params[2];
  const float ry = params[3] * un + params[4] * vn + params[5];
  const float rz = params[6] * un + params[7] * vn + params[8];
  PixelRay r;
  r.invlen = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz);
  r.dnx = rx * r.invlen;
  r.dny = ry * r.invlen;
  r.dnz = rz * r.invlen;
  return r;
}
