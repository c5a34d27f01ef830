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
// Design (one block per tile, one thread per pixel):
//  - Blocks take the tiles longest run first (`order`, the wrapper's sort
//    of `tile_count`): the longest runs start first instead of setting the
//    tail. Output goes to each tile's own slot, so the order changes no
//    pixel.
//  - The block loops over its run in chunks of up to CHUNK candidates. Per
//    chunk the block stages the 23 payload rows it needs (0-10, 24-35)
//    into shared memory, row by row with neighbouring threads on
//    neighbouring candidates, then builds the S + 2 planes with one thread
//    per (plane, candidate): a chunk's set-up takes about one plane's
//    latency. Each plane is written as (normal, n.oa - offset).
//  - The side count S is a template argument (one instance for each S from
//    3 to 16), so the plane loop is unrolled and the ring planes are known
//    at compile time. A plane costs the denominator n.dn, the reciprocal,
//    the plane's t and two predicated min/max updates. Parallel planes
//    (|n.dn| < 1e-12, never on the main path) are found from the smallest
//    |n.dn| and their reject rule is re-evaluated only for a candidate that
//    has one.
//  - Max and min do not depend on the order of their operands, so the
//    ring planes go first. After them and S / 2 side planes one warp vote
//    asks whether every pixel of the warp already misses (t_in > t_out, or
//    t_out <= 0: t_in only grows and t_out only falls); such a warp leaves
//    the candidate. It is not a depth test: no candidate is skipped that
//    could hit. On the main path this is 15% faster than the full loop; a
//    vote after every plane was 25% slower (tools/kernel_split.py).
//  - A thread keeps only the best (t, id) and the chunk's winner index; the
//    winner's G-buffer is written at the end of each chunk in which it
//    changed, while its rows are still staged. Registers stay at most 64
//    up to 8 sides, so two 512-thread blocks fit on an SM (one did
//    before); at 32 (four blocks) ptxas spills and the kernel is 10%
//    slower. Splitting a 32x16 tile's pixels over two 256-thread blocks
//    was no faster.
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
// PyTorch version (`rasterize_prisms_reference`) that it is held against:
// every plane is built and clipped with the plain version's operations in
// its order (max and min do not depend on the order of their operands).
//
// Bound on the H100: FP32 ALU. A (candidate, pixel) evaluation costs 15
// float operations per side plane, 16 per ring plane and 6 for the hit rule
// and the tie (158 at S = 8) against ~100 bytes of payload shared by the
// block's 512 threads; a pixel that already misses after the ring planes
// and S / 2 sides needs those and the miss test alone. chip_smoke.py counts
// both kinds on the run's data; the least time is their operations over
// 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "capsule_common.cuh"

#define CHUNK 128
#define MAX_SIDES 16
#define MAX_THREADS 512   // pixels per tile: 32x16 on the main path
// Resident 512-thread blocks per SM asked of ptxas: two up to 8 sides (at
// most 64 registers), one beyond (where 64 spill).
#define MIN_BLOCKS 2
#define MIN_BLOCKS_WIDE 1
#define IN_ROWS 23        // staged payload rows: 0-10, then 24-35 at 11-22
#define ROW_FRAME0 24     // payload rows 24-35: na, bna, nb, bnb

// Staged rows (payload row r < 11 at r, frame row 24 + i at 11 + i).
enum { S_OA = 0, S_BA = 3, S_RW = 6, S_ATTR0 = 7, S_DATTR = 8, S_ID = 9, S_BABA = 10,
       S_NA = 11, S_BNA = 14, S_NB = 17, S_BNB = 20 };

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

// Plane k of the staged candidate at `c` (its rows CHUNK apart): the side
// quads k < S, then the ring planes at the a and the b end.
template <int S>
__device__ __forceinline__ float4 prism_plane(const float* c, int k, const float* cs) {
  const V3 oa = v3(c[(S_OA + 0) * CHUNK], c[(S_OA + 1) * CHUNK], c[(S_OA + 2) * CHUNK]);
  const V3 ba = v3(c[(S_BA + 0) * CHUNK], c[(S_BA + 1) * CHUNK], c[(S_BA + 2) * CHUNK]);
  const V3 na = v3(c[(S_NA + 0) * CHUNK], c[(S_NA + 1) * CHUNK], c[(S_NA + 2) * CHUNK]);
  const V3 bna = v3(c[(S_BNA + 0) * CHUNK], c[(S_BNA + 1) * CHUNK], c[(S_BNA + 2) * CHUNK]);
  const V3 nb = v3(c[(S_NB + 0) * CHUNK], c[(S_NB + 1) * CHUNK], c[(S_NB + 2) * CHUNK]);
  const V3 bnb = v3(c[(S_BNB + 0) * CHUNK], c[(S_BNB + 1) * CHUNK], c[(S_BNB + 2) * CHUNK]);
  if (k == S) {
    // Ring planes, orthogonal to the transported tangent t = n x b at
    // each end: inside is ta.(x - a) >= 0 and tb.(x - a) <= tb.ba.
    return plane_of(scale(cross(na, bna), -1.0f), 0.0f, oa);
  }
  if (k == S + 1) {
    const V3 tb = cross(nb, bnb);
    return plane_of(tb, dot(tb, ba), oa);
  }
  // Ring corner offsets relative to a: va at the a end, vb at the b end.
  const float r_w = c[S_RW * CHUNK];
  const int k1 = k + 1 == S ? 0 : k + 1;
  const float ck = cs[k], sk = cs[S + k], ck1 = cs[k1], sk1 = cs[S + k1];
  const V3 va = scale(add(scale(na, ck), scale(bna, sk)), r_w);
  const V3 va1 = scale(add(scale(na, ck1), scale(bna, sk1)), r_w);
  const V3 vb = add(ba, scale(add(scale(nb, ck), scale(bnb, sk)), r_w));
  const V3 vb1 = add(ba, scale(add(scale(nb, ck1), scale(bnb, sk1)), r_w));
  // Planarized side quad: normal from the two mid-edge directions,
  // oriented away from the axis midpoint, through the centroid.
  const V3 d1 = sub(add(vb, vb1), add(va, va1));
  const V3 d2 = sub(add(va1, vb1), add(va, vb));
  V3 nq = cross(d1, d2);
  nq = scale(nq, 1.0f / sqrtf(fmaxf(dot(nq, nq), 1e-30f)));
  const V3 mid = scale(add(add(va, va1), add(vb, vb1)), 0.25f);
  nq = scale(nq, dot(nq, sub(mid, scale(ba, 0.5f))) >= 0.0f ? 1.0f : -1.0f);
  return plane_of(nq, dot(nq, mid), oa);
}

template <int S>
__global__ void __launch_bounds__(MAX_THREADS, S <= 8 ? MIN_BLOCKS : MIN_BLOCKS_WIDE)
prism_raster_kernel(const float* __restrict__ payload, long long ld,
                    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                    const int* __restrict__ order, const float* __restrict__ params,
                    const float* __restrict__ cs, float* __restrict__ out,
                    int* __restrict__ work, int n_tiles, int tiles_x, int tile_w, float sx,
                    float sy) {
  extern __shared__ float4 s_dyn[];
  float4* const s_plane = s_dyn;                                   // [S + 2][CHUNK]
  float* const s_in = reinterpret_cast<float*>(s_dyn + (S + 2) * CHUNK);  // [IN_ROWS][CHUNK]
  __shared__ float s_cs[2 * S];

  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int P = blockDim.x;

  const PixelRay ray = pixel_ray(params, tile, tid, tiles_x, tile_w, P / tile_w, sx, sy);
  const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz;
  const float zA = params[9], zB = params[10];
  if (tid < 2 * S) s_cs[tid] = cs[tid];  // cos[0..S), sin[0..S); read after a barrier

  const long long plane = (long long)n_tiles * P;
  float* const o = out + (long long)tile * P + tid;
  float best_t = BIG, best_id = BIG;
  bool updated = false;  // a winner's G-buffer was written

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    if (c0 > 0) __syncthreads();  // the last chunk's rows and planes are read
    for (int i = tid; i < IN_ROWS * n; i += P) {
      const int r = i / n, j = i - r * n;
      s_in[r * CHUNK + j] = payload[(long long)(r < 11 ? r : r + ROW_FRAME0 - 11) * ld + start +
                                    c0 + j];
    }
    __syncthreads();
    for (int w = tid; w < (S + 2) * n; w += P) {
      const int k = w / n, j = w - k * n;
      s_plane[k * CHUNK + j] = prism_plane<S>(s_in + j, k, s_cs);
    }
    __syncthreads();

    int best_j = -1;
    for (int j = 0; j < n; ++j) {
      // Slab clip: f(t) = num + t * den, inside f <= 0. Entering planes
      // (den < 0) raise t_in, exiting planes lower t_out, parallel planes
      // (|den| < 1e-12) move neither.
      float t_in = -BIG, t_out = BIG, cap_in = -BIG, den_min = BIG;
      bool gone = false;
#pragma unroll
      for (int kk = 0; kk < S + 2; ++kk) {
        const int k = kk < 2 ? S + kk : kk - 2;  // the ring planes first
        if (kk == 2 + S / 2 && __all_sync(0xffffffffu, t_in > t_out || t_out <= 0.0f)) {
          gone = true;  // every pixel of the warp misses: t_in only grows, t_out only falls
          break;
        }
        const float4 pl = s_plane[k * CHUNK + j];
        const float den = (pl.x * dnx + pl.y * dny) + pl.z * dnz;
        const float tp = -pl.w * (1.0f / den);
        if (den <= -1e-12f) {
          t_in = fmaxf(t_in, tp);
          if (k >= S) cap_in = fmaxf(cap_in, tp);
        }
        if (den >= 1e-12f) t_out = fminf(t_out, tp);
        den_min = fminf(den_min, fabsf(den));
      }
      // A hit enters last through a side, in front of the camera.
      if (gone || !(t_in <= t_out && t_in > 0.0f && t_in > cap_in)) continue;
      if (den_min < 1e-12f) {
        // A parallel plane with num > 0 rejects the ray.
        bool rej = false;
#pragma unroll
        for (int k = 0; k < S + 2; ++k) {
          const float4 pl = s_plane[k * CHUNK + j];
          const float den = (pl.x * dnx + pl.y * dny) + pl.z * dnz;
          rej = rej || (fabsf(den) < 1e-12f && pl.w > 0.0f);
        }
        if (rej) continue;
      }
      const float id = s_in[S_ID * CHUNK + j];
      if (!(t_in < best_t || (t_in == best_t && id < best_id))) continue;
      best_t = t_in;
      best_id = id;
      best_j = j;
    }

    if (best_j >= 0) {  // the winner changed in this chunk: its G-buffer
      const float* c = s_in + best_j;
      const V3 oa = v3(c[(S_OA + 0) * CHUNK], c[(S_OA + 1) * CHUNK], c[(S_OA + 2) * CHUNK]);
      const V3 ba = v3(c[(S_BA + 0) * CHUNK], c[(S_BA + 1) * CHUNK], c[(S_BA + 2) * CHUNK]);
      const float t_in = best_t;
      const float bard = (ba.x * dnx + ba.y * dny) + ba.z * dnz;
      const float y = dot(ba, oa) + t_in * bard;
      const float uax = clamp01(y * (1.0f / fmaxf(c[S_BABA * CHUNK], 1e-20f)));
      const bool hit = best_t < BIG;
      o[0 * plane] = zA - zB / fmaxf(t_in * ray.invlen, 1e-12f);
      o[1 * plane] = hit ? best_id : -1.0f;
      o[2 * plane] = c[S_ATTR0 * CHUNK] + c[S_DATTR * CHUNK] * uax;
      o[3 * plane] = (oa.x + t_in * dnx) - ba.x * uax;
      o[4 * plane] = (oa.y + t_in * dny) - ba.y * uax;
      o[5 * plane] = (oa.z + t_in * dnz) - ba.z * uax;
      o[6 * plane] = ba.x;
      o[7 * plane] = ba.y;
      o[8 * plane] = ba.z;
      o[9 * plane] = hit ? 1.0f : 0.0f;
      updated = true;
    }
  }

  if (!updated) {
    o[0 * plane] = 2.0f;
    o[1 * plane] = -1.0f;
#pragma unroll
    for (int p = 2; p < 10; ++p) o[p * plane] = 0.0f;
  }
  if (work != nullptr && tid == 0) work[tile] = count;
}

template <int S>
static size_t prism_smem() {
  return (size_t)(S + 2) * CHUNK * sizeof(float4) + (size_t)IN_ROWS * CHUNK * sizeof(float);
}

template <int S>
static int launch(const float* payload, long long ld, const int* tile_start,
                  const int* tile_count, const int* order, const float* params,
                  const float* cs, float* out, int* work, int n_tiles, int tiles_x, int tile_w,
                  int threads, float sx, float sy, cudaStream_t stream) {
  const size_t smem = prism_smem<S>();
  const cudaError_t e = cudaFuncSetAttribute(
      prism_raster_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  prism_raster_kernel<S><<<n_tiles, threads, smem, stream>>>(
      payload, ld, tile_start, tile_count, order, params, cs, out, work, n_tiles, tiles_x,
      tile_w, sx, sy);
  return 0;
}

// Launches one block of tile_w * tile_h threads per tile on `stream`.
// payload: [36 or more rows, ld] float32; order: [n_tiles] int32, the tiles
// in the order the blocks take them (a permutation); cs: [2 * n_sides]
// float32, the ring's cosines then sines; 3 <= n_sides <= MAX_SIDES. out:
// [10, n_tiles, tile_w * tile_h] float32. work: optional [n_tiles] int32,
// the candidates each tile evaluated (its whole run). Returns the
// cudaGetLastError() code of the launch.
extern "C" int raster_prism_launch(const float* payload, long long ld, const int* tile_start,
                                   const int* tile_count, const int* order,
                                   const float* params, const float* cs, float* out,
                                   int* work, int n_tiles, int tiles_x, int tile_w, int tile_h,
                                   float sx, float sy, int n_sides, void* stream) {
  const int threads = tile_w * tile_h;
  if (n_sides < 3 || n_sides > MAX_SIDES || threads % 32 != 0 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
#define PRISM_CASE(S)                                                                    \
  case S:                                                                                \
    if (int e = launch<S>(payload, ld, tile_start, tile_count, order, params, cs, out,   \
                          work, n_tiles, tiles_x, tile_w, threads, sx, sy, st))          \
      return e;                                                                          \
    break;
    switch (n_sides) {
      PRISM_CASE(3) PRISM_CASE(4) PRISM_CASE(5) PRISM_CASE(6) PRISM_CASE(7) PRISM_CASE(8)
      PRISM_CASE(9) PRISM_CASE(10) PRISM_CASE(11) PRISM_CASE(12) PRISM_CASE(13)
      PRISM_CASE(14) PRISM_CASE(15) PRISM_CASE(16)
    }
#undef PRISM_CASE
  }
  return (int)cudaGetLastError();
}

// Resources of the S = 8 and S = 16 instances at 512 and 128 threads
// (instance i = 0..3): v = (registers, local bytes, static shared bytes,
// resident blocks per SM, threads, dynamic shared bytes), `label` its name.
// Returns a CUDA error code, cudaErrorInvalidValue past the last instance.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 3) return (int)cudaErrorInvalidValue;
  const int threads = i % 2 == 0 ? 512 : 128;
  const void* f = i < 2 ? (const void*)prism_raster_kernel<8> : (const void*)prism_raster_kernel<16>;
  const size_t smem = i < 2 ? prism_smem<8>() : prism_smem<16>();
  const char* nm = i == 0 ? "S 8, 512 threads" : i == 1 ? "S 8, 128 threads"
                 : i == 2 ? "S 16, 512 threads" : "S 16, 128 threads";
  cudaFuncAttributes a;
  int e = (int)cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!e) e = (int)cudaFuncGetAttributes(&a, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, threads, smem);
  if (e) return e;
  v[0] = a.numRegs;
  v[1] = (int)a.localSizeBytes;
  v[2] = (int)a.sharedSizeBytes;
  v[3] = nb;
  v[4] = threads;
  v[5] = (int)smem;
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
