// Analytic N-gon prism tile rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_prism_kernel` in
// linevis_tpu/kernels/raster_prism.py:59 (wrapper `rasterize_prisms_pallas`,
// :415). It computes the same function: for every screen tile, walk that
// tile's depth-bucket-ordered run of (tile, segment) pairs from the capsule
// binning, clip each pixel's ray against the convex prism of each candidate
// segment (S planarized side-quad planes and the two ring planes; the tube
// is open-ended, so entering through a ring plane is a miss), keep the
// nearest entry point and write the capsule G-buffer layout: z_ndc, id,
// attribute, radial normal `hit - axis(u)`, tangent `ba`, coverage 1.
//
// Design (one block per tile, one thread per pixel), after raster_capsule.cu:
//  - The block loops over its run in chunks of up to CHUNK candidates. Runs
//    are pair-granular and start anywhere: the loop bounds-checks the run's
//    end instead of padding to an alignment.
//  - The S + 2 planes of a candidate do not depend on the pixel. One thread
//    per candidate reads its 23 payload values (rows 0-10 and the frame
//    rows 24-35), builds the ring corners from the frames and the table of
//    cos/sin(2 pi s / S), and writes each plane as (normal, n.oa - offset)
//    into shared memory. The pixel loop then reads four floats per plane as
//    one broadcast and keeps only t_in, t_out, the ring entry and the
//    reject flag in registers: the corner vectors never live per pixel.
//  - No early-z chunk exit. The TPU kernel holds the tile's depth against
//    the run's depth key (payload row 15), which is the capsule's. Where a
//    line bends sharply the two ring planes diverge and the plane-bounded
//    prism reaches beyond the capsule's end sphere, so that exit can skip
//    the nearest candidate. An exit that preserves the result needs a depth
//    key that bounds the prism; until the binning carries one, every
//    candidate of the run is evaluated.
//  - Ties: the TPU kernel breaks equal-t ties by the lowest id inside a
//    sub-block and by block order across blocks. Here the winner is the
//    minimum of (world t, id), which does not depend on the candidate order.
//
// Precision: IEEE sqrt and division, never rsqrtf (the TPU kernel's
// lax.rsqrt is not correctly rounded on every backend); the file builds
// without --use_fast_math and with --fmad=false, so it rounds as the plain
// PyTorch version (`rasterize_prisms_reference`) that it is held against.
//
// Bound on the H100: FP32 ALU. A (candidate, pixel) evaluation costs 15
// float operations per side plane, 16 per ring plane and 6 for the hit rule
// and the tie (158 at S = 8) against ~100 bytes of payload shared by the
// block's 512 threads, so the least time is
//   sum over tiles (candidates in the run) * P * ops / 67 TFLOP/s.
// Speed work (a reciprocal-free clip, cp.async staging, more set-up
// threads, several tiles per block) is left to later changes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "capsule_common.cuh"

#define CHUNK 128
#define MAX_SIDES 16
#define MAX_THREADS 512   // pixels per tile: 32x16 on the main path
#define ROW_FRAME0 24     // payload rows 24-35: na, bna, nb, bnb

// Staged per-candidate scalars.
enum { S_OA = 0, S_BA = 3, S_ATTR0 = 6, S_DATTR = 7, S_ID = 8, S_BABA = 9, S_BAOA = 10,
       S_ROWS = 11 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x; r.y = y; r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 u, V3 v) {
  return v3(u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z, u.x * v.y - u.y * v.x);
}

// Plane n.(x - a) <= c as (n, n.oa - c): f(t) = num + t * (n.dn).
__device__ __forceinline__ float4 plane_of(V3 n, float cpl, V3 oa) {
  return make_float4(n.x, n.y, n.z, dot(n, oa) - cpl);
}

__global__ void __launch_bounds__(MAX_THREADS)
prism_raster_kernel(const float* __restrict__ payload, long long ld,
                    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                    const float* __restrict__ params, const float* __restrict__ cs,
                    float* __restrict__ out, int* __restrict__ work, int n_tiles,
                    int tiles_x, int tile_w, float sx, float sy, int n_sides) {
  __shared__ float4 s_plane[CHUNK][MAX_SIDES + 2];
  __shared__ float s[S_ROWS][CHUNK];
  __shared__ float s_cs[2 * MAX_SIDES];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int n_planes = n_sides + 2;

  const PixelRay ray = pixel_ray(params, tile, tid, tiles_x, tile_w, P / tile_w, sx, sy);
  const float invlen = ray.invlen;
  const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz;
  const float zA = params[9], zB = params[10];

  if (tid < 2 * n_sides) s_cs[tid] = cs[tid];  // cos[0..S), sin[0..S)
  __syncthreads();

  float best_t = BIG, best_id = BIG, zcur = 2.0f;
  float w_attr = 0.f, w_nx = 0.f, w_ny = 0.f, w_nz = 0.f;
  float w_tx = 0.f, w_ty = 0.f, w_tz = 0.f;

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    const float* src = payload + (long long)start + c0;

    // Per-candidate set-up: segment scalars and the S + 2 planes.
    for (int j = tid; j < n; j += P) {
      const float* col = src + j;
      const V3 oa = v3(col[0 * ld], col[1 * ld], col[2 * ld]);
      const V3 ba = v3(col[3 * ld], col[4 * ld], col[5 * ld]);
      const float r_w = col[6 * ld];
      const float* f = col + (long long)ROW_FRAME0 * ld;
      const V3 na = v3(f[0 * ld], f[1 * ld], f[2 * ld]);
      const V3 bna = v3(f[3 * ld], f[4 * ld], f[5 * ld]);
      const V3 nb = v3(f[6 * ld], f[7 * ld], f[8 * ld]);
      const V3 bnb = v3(f[9 * ld], f[10 * ld], f[11 * ld]);

      s[S_OA + 0][j] = oa.x;
      s[S_OA + 1][j] = oa.y;
      s[S_OA + 2][j] = oa.z;
      s[S_BA + 0][j] = ba.x;
      s[S_BA + 1][j] = ba.y;
      s[S_BA + 2][j] = ba.z;
      s[S_ATTR0][j] = col[7 * ld];
      s[S_DATTR][j] = col[8 * ld];
      s[S_ID][j] = col[9 * ld];
      s[S_BABA][j] = col[10 * ld];
      s[S_BAOA][j] = dot(ba, oa);

      // Ring corner offsets relative to a: va at the a end, vb at the b end.
      const V3 half_ba = scale(ba, 0.5f);
      const V3 va0 = scale(add(scale(na, s_cs[0]), scale(bna, s_cs[n_sides])), r_w);
      const V3 vb0 = add(ba, scale(add(scale(nb, s_cs[0]), scale(bnb, s_cs[n_sides])), r_w));
      V3 va = va0, vb = vb0;
      for (int k = 0; k < n_sides; ++k) {
        V3 va1 = va0, vb1 = vb0;
        if (k + 1 < n_sides) {
          const float ck = s_cs[k + 1], sk = s_cs[n_sides + k + 1];
          va1 = scale(add(scale(na, ck), scale(bna, sk)), r_w);
          vb1 = add(ba, scale(add(scale(nb, ck), scale(bnb, sk)), r_w));
        }
        // Planarized side quad: normal from the two mid-edge directions,
        // oriented away from the axis midpoint, through the centroid.
        const V3 d1 = sub(add(vb, vb1), add(va, va1));
        const V3 d2 = sub(add(va1, vb1), add(va, vb));
        V3 nq = cross(d1, d2);
        nq = scale(nq, 1.0f / sqrtf(fmaxf(dot(nq, nq), 1e-30f)));
        const V3 mid = scale(add(add(va, va1), add(vb, vb1)), 0.25f);
        nq = scale(nq, dot(nq, sub(mid, half_ba)) >= 0.0f ? 1.0f : -1.0f);
        s_plane[j][k] = plane_of(nq, dot(nq, mid), oa);
        va = va1;
        vb = vb1;
      }
      // Ring planes, orthogonal to the transported tangent t = n x b at
      // each end: inside is ta.(x - a) >= 0 and tb.(x - a) <= tb.ba.
      const V3 tb = cross(nb, bnb);
      s_plane[j][n_sides] = plane_of(scale(cross(na, bna), -1.0f), 0.0f, oa);
      s_plane[j][n_sides + 1] = plane_of(tb, dot(tb, ba), oa);
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      // Slab clip: f(t) = num + t * den, inside f <= 0. Entering planes
      // (den < 0) raise t_in, exiting planes lower t_out, parallel planes
      // with num > 0 reject the ray.
      float t_in = -BIG, t_out = BIG, cap_in = -BIG;
      bool rej = false;
      for (int k = 0; k < n_planes; ++k) {
        const float4 pl = s_plane[j][k];
        const float den = (pl.x * dnx + pl.y * dny) + pl.z * dnz;
        const bool para = fabsf(den) < 1e-12f;
        const float den_s = para ? (den >= 0.0f ? 1e-12f : -1e-12f) : den;
        const float tp = -pl.w * (1.0f / den_s);
        const float t_enter = (den < 0.0f && !para) ? tp : -BIG;
        t_in = fmaxf(t_in, t_enter);
        t_out = fminf(t_out, (den > 0.0f && !para) ? tp : BIG);
        if (k >= n_sides) cap_in = fmaxf(cap_in, t_enter);
        rej = rej || (para && pl.w > 0.0f);
      }
      // A hit enters last through a side, in front of the camera.
      if (!(t_in <= t_out && t_in > 0.0f && t_in > cap_in && !rej)) continue;
      const float id = s[S_ID][j];
      if (!(t_in < best_t || (t_in == best_t && id < best_id))) continue;

      best_t = t_in;
      best_id = id;
      zcur = zA - zB / fmaxf(t_in * invlen, 1e-12f);
      const float oa0 = s[S_OA + 0][j], oa1 = s[S_OA + 1][j], oa2 = s[S_OA + 2][j];
      const float ba0 = s[S_BA + 0][j], ba1 = s[S_BA + 1][j], ba2 = s[S_BA + 2][j];
      const float bard = (ba0 * dnx + ba1 * dny) + ba2 * dnz;
      const float y = s[S_BAOA][j] + t_in * bard;
      const float uax = clamp01(y * (1.0f / fmaxf(s[S_BABA][j], 1e-20f)));
      w_attr = s[S_ATTR0][j] + s[S_DATTR][j] * uax;
      w_nx = (oa0 + t_in * dnx) - ba0 * uax;
      w_ny = (oa1 + t_in * dny) - ba1 * uax;
      w_nz = (oa2 + t_in * dnz) - ba2 * uax;
      w_tx = ba0;
      w_ty = ba1;
      w_tz = ba2;
    }
    __syncthreads();  // the next chunk overwrites the staged candidates
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
  o[9 * plane] = hit ? 1.0f : 0.0f;
  if (work != nullptr && tid == 0) work[tile] = count;
}

// Launches one block of tile_w * tile_h threads per tile on `stream`.
// payload: [36 or more rows, ld] float32; cs: [2 * n_sides] float32, the
// ring's cosines then sines; 3 <= n_sides <= MAX_SIDES. out: [10, n_tiles,
// tile_w * tile_h] float32. work: optional [n_tiles] int32, the candidates
// each tile evaluated (its whole run). Returns the cudaGetLastError() code of
// the launch.
extern "C" int raster_prism_launch(const float* payload, long long ld, const int* tile_start,
                                   const int* tile_count, const float* params,
                                   const float* cs, float* out, int* work, int n_tiles,
                                   int tiles_x, int tile_w, int tile_h, float sx, float sy,
                                   int n_sides, void* stream) {
  if (n_sides < 3 || n_sides > MAX_SIDES) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    prism_raster_kernel<<<n_tiles, tile_w * tile_h, 0, (cudaStream_t)stream>>>(
        payload, ld, tile_start, tile_count, params, cs, out, work, n_tiles, tiles_x,
        tile_w, sx, sy, n_sides);
  }
  return (int)cudaGetLastError();
}
