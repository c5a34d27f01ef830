// Per-pixel accumulators over binned capsules for Hopper (sm_90a): the
// weighted blended OIT sums, depth complexity, and both passes of
// moment-based OIT.
//
// Replaces the Pallas TPU kernel `_mlab_kernel` in
// linevis_tpu/kernels/raster_capsule_oit.py:116 (wrapper
// `rasterize_capsules_mlab`, :1096) in its accumulation store modes
// (`_ACCUM_MODES`, bodies at :604-754):
//  - 'count': front-face fragments per pixel;
//  - 'wboit': the WBOITGather weight w(a, z_ndc); sums of w*a*rgb, w*a and
//    log(1 - a) (revealage);
//  - 'mboit_gen': the absorbance b0 = sum(-log(1 - a)) and the power or
//    trigonometric moments of the log-warped depth (moment_math.cuh,
//    trig_moment_math.cuh);
//  - 'mboit_resolve': each fragment's transmittance T from the pixel's
//    pass-1 moments (discarded, T = 1, where b0 < 0.00100050033), and the
//    sums of a*T*rgb and a*T.
// The plain PyTorch version it is held against is
// `rasterize_capsules_mlab_reference` (kernels/raster_capsule_oit.py), whose
// `_accum_slots` gives the JAX kernel's output layout.
//
// Design (one block per tile, one thread per pixel, as the K-buffer kernel
// raster_capsule_oit.cu): the block walks its whole run in chunks of
// `chunk` pair columns, staging payload rows 0-22 of the chunk's in-run
// columns in shared memory (read by every thread as a broadcast). There is
// no K-buffer, no rejection and no cull: every candidate's entry surface
// (and, two_sided, then its exit surface) that lies inside the NDC depth
// range (and behind the pixel's `peel` depth, where given) adds to the
// pixel's sums in registers, in candidate order, as the plain version adds
// them. Shading is per fragment (capsule_common.cuh:cand_fragment). The
// kernel is specialised on the mode, the moment count and power or
// trigonometric moments (14 instances), so every accumulator index is
// static.
//
// Precision: built without --use_fast_math and with --fmad=false, as the
// plain version rounds: IEEE division and sqrt, powf/expf/logf/cosf/sinf.
//
// Bound on the H100: FP32 ALU. Each (candidate, pixel) evaluation costs the
// intersection's ~90 float operations against 92 bytes of staged payload
// shared by the block; each fragment adds its shading (~115 operations) and
// its mode's terms (wboit ~25; mboit_gen 10 + 2 per moment, trigonometric
// ~40 more; mboit_resolve the transmittance reconstruction, ~150 to ~900
// operations with 4 to 8 moments). chip_smoke.py computes the least time
// from the run's own counts. Speed work (candidate compaction, several tiles
// per block) is left to later changes.

#include <cuda_runtime.h>

#include "capsule_common.cuh"
#include "moment_math.cuh"
#include "trig_moment_math.cuh"

#define NROWS 23         // staged payload rows 0-22
#define MAX_CHUNK 256    // staged columns
#define MAX_THREADS 512  // pixels per tile

enum Mode { COUNT = 0, WBOIT = 1, GEN = 2, RESOLVE = 3 };

#define MBOIT_DISCARD_B0 0.00100050033f  // resolveMoments (MomentOIT.glsl:421)

template <int MODE, int NMOM>
struct Acc {
  // accumulators: count; wboit log(1-a), r, g, b, a; mboit_gen b0, odd
  // moments, even moments; mboit_resolve r, g, b, a.
  static constexpr int N = MODE == COUNT ? 1 : MODE == WBOIT ? 5 : MODE == GEN ? 1 + NMOM : 4;

  // (channel, node) of accumulator i in the [5, K] output planes.
  __device__ static int plane(int i, int K) {
    if (MODE == RESOLVE) return (1 + i) * K;
    if (MODE != GEN) return i * K;  // count, wboit: node 0, channels 0-4
    const int nh = NMOM / 2;
    if (i == 0) return 0;                    // b0 -> depths[0]
    if (i <= nh) return i * K;               // odd j -> rgb[0..2, 0], alpha[0]
    return (i - 1 - nh) * K + 1;             // even j -> depths[1], rgb[0..2, 1]
  }
};

// Adds one shaded fragment (color, alpha in f) at world t `tw` to the
// accumulators of a mode other than 'count'. b0v, odds, evens: the pixel's
// normalized pass-1 moments ('mboit_resolve').
template <int MODE, int NMOM, bool TRIG>
__device__ __forceinline__ void add_fragment(float* acc, float4 f, float tw, float invlen,
                                             float zA, float zB, float log_dmin,
                                             float log_dmax, float m_bias, float m_overest,
                                             float wzp_y, float wzp_z, float wzp_w, float b0v,
                                             const float* odds, const float* evens) {
  constexpr int NH = NMOM / 2;
  const float a = f.w;
  if constexpr (MODE == WBOIT) {
    // WBOITGather.glsl:14-37: weight from alpha and NDC depth.
    const float zndc = zA - zB / fmaxf(tw * invlen, 1e-12f);
    const float x = fminf(a * 10.0f, 1.0f) + 0.01f;
    const float y = 1.0f - clamp01(zndc) * 0.9f;
    const float wgt = fminf(fmaxf(x * x * x * 1e8f * (y * y * y), 1e-2f), 3e3f);
    const float wa = wgt * a;
    acc[0] = acc[0] + logf(fmaxf(1.0f - a, 1e-6f));
    acc[1] = acc[1] + wa * f.x;
    acc[2] = acc[2] + wa * f.y;
    acc[3] = acc[3] + wa * f.z;
    acc[4] = acc[4] + wa;
  } else {
    // MBOIT log depth warp (MBOITHeader.glsl:49-52).
    const float dw = fminf(
        fmaxf((logf(fmaxf(tw * invlen, 1e-9f)) - log_dmin) / fmaxf(log_dmax - log_dmin, 1e-9f) *
                      2.0f -
                  1.0f,
              -1.0f),
        1.0f);
    if constexpr (MODE == GEN) {
      // MomentOIT.glsl:69-133 (power), :338-355 (trigonometric).
      const float absorb = fminf(-logf(fmaxf(1.0f - a, 1e-7f)), 10.0f);
      acc[0] = acc[0] + absorb;
      if constexpr (TRIG) {
        cpx pw[NH];
        circle_powers<NH>(dw, wzp_y, pw);
#pragma unroll
        for (int k = 0; k < NH; ++k) {
          acc[1 + k] = acc[1 + k] + pw[k].re * absorb;
          acc[1 + NH + k] = acc[1 + NH + k] + pw[k].im * absorb;
        }
      } else {
        const float d2 = dw * dw;
        float pow_odd = dw, pow_even = d2;
#pragma unroll
        for (int k = 0; k < NH; ++k) {
          acc[1 + k] = acc[1 + k] + pow_odd * absorb;
          acc[1 + NH + k] = acc[1 + NH + k] + pow_even * absorb;
          pow_odd = pow_odd * d2;
          pow_even = pow_even * d2;
        }
      }
    } else {
      // mboit_resolve (MBOITPass2.glsl:21-37).
      float T_at;
      if constexpr (TRIG) {
        cpx trig_b[NH];
#pragma unroll
        for (int k = 0; k < NH; ++k) trig_b[k] = cx(odds[k], evens[k]);
        T_at = transmittance_at_depth_trig<NH>(b0v, trig_b, dw, m_bias, m_overest, wzp_y,
                                               wzp_z, wzp_w);
      } else if constexpr (NMOM == 4) {
        T_at = transmittance_at_depth_4(b0v, evens, odds, dw, m_bias, m_overest);
      } else if constexpr (NMOM == 6) {
        T_at = transmittance_at_depth_6(b0v, evens, odds, dw, m_bias, m_overest);
      } else {
        T_at = transmittance_at_depth_8(b0v, evens, odds, dw, m_bias, m_overest);
      }
      T_at = b0v < MBOIT_DISCARD_B0 ? 1.0f : T_at;
      const float wgt = a * T_at;
      acc[0] = acc[0] + wgt * f.x;
      acc[1] = acc[1] + wgt * f.y;
      acc[2] = acc[2] + wgt * f.z;
      acc[3] = acc[3] + wgt;
    }
  }
}

template <int MODE, int NMOM, bool TRIG, bool BANDS>
__global__ void __launch_bounds__(MAX_THREADS)
accum_kernel(const float* __restrict__ payload, long long ld,
             const int* __restrict__ tile_start, const int* __restrict__ tile_count,
             const float* __restrict__ params, const float* __restrict__ tf,
             const float* __restrict__ moments, const float* __restrict__ peel,
             float* __restrict__ out, int n_tiles, int tiles_x, int tile_w, int tile_h,
             float sx, float sy, int K, int chunk, int two_sided, int alpha_from_rows) {
  __shared__ float s[NROWS][MAX_CHUNK];
  constexpr int NH = NMOM / 2;
  constexpr int NACC = Acc<MODE, NMOM>::N;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const long long plane = (long long)n_tiles * P;
  const long long pix = (long long)tile * P + tid;

  const PixelRay ray = pixel_ray(params, tile, tid, tiles_x, tile_w, tile_h, sx, sy);
  const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz, invlen = ray.invlen;
  const float len_p = 1.0f / invlen;
  const float zA = params[9], zB = params[10];
  const float tw_lo = (zB / zA) * len_p;
  const float tw_hi = (zB / (zA - 1.0f)) * len_p;
  const Shading sh = shading_of(params, tf, alpha_from_rows != 0);
  const float peel_d = peel != nullptr ? peel[pix] : 0.0f;
  const float log_dmin = params[15], log_dmax = params[16];
  const float m_bias = params[17], m_overest = params[18];
  const float wzp_y = params[20], wzp_z = params[21], wzp_w = params[22];

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  // mboit_resolve: the pixel's pass-1 moments, normalized by b0.
  float b0v = 0.0f, odds[NH], evens[NH];
  if constexpr (MODE == RESOLVE) {
    b0v = moments[pix];
    const float inv_b0 = 1.0f / fmaxf(b0v, 1e-6f);
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      odds[j] = moments[(1 + j) * plane + pix] * inv_b0;
      evens[j] = moments[(1 + NH + j) * plane + pix] * inv_b0;
    }
  }

  const int start = tile_start[tile];
  const int end = start + tile_count[tile];
  const int C = chunk;
  for (int c0 = (start / C) * C; c0 < end; c0 += C) {
    const int lo = max(c0, start), hi = min(c0 + C, end);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < NROWS * C; i += P) {
      const int r = i / C, j = i - r * C;
      if (c0 + j >= lo && c0 + j < hi) s[r][j] = payload[(long long)r * ld + c0 + j];
    }
    __syncthreads();
    for (int j = lo - c0; j < hi - c0; ++j) {
      const Cand cd = cand_setup(s, j, dnx, dny, dnz);
      const Quad q = cand_quad(s, j, cd);
      const bool cap_a_on = s[13][j] > 0.5f;
      for (int side = 0; side <= two_sided; ++side) {
        const float tc = surface_t(q, cd, s[10][j], cap_a_on, side == 0);
        if (!(tc < BIG)) continue;
        const float tw = cd.t0 + tc;
        if (!(tw >= tw_lo && tw <= tw_hi)) continue;
        if (peel != nullptr && !(zA - zB / fmaxf(tw * invlen, 1e-12f) > peel_d)) continue;
        if constexpr (MODE == COUNT) {
          acc[0] = acc[0] + 1.0f;
        } else {
          add_fragment<MODE, NMOM, TRIG>(
              acc, cand_fragment<BANDS>(s, j, cd, tc, tw, invlen, sh, MODE == GEN), tw, invlen, zA,
              zB, log_dmin, log_dmax, m_bias, m_overest, wzp_y, wzp_z, wzp_w, b0v, odds, evens);
        }
      }
    }
  }

  float* px = out + pix;
  for (int i = 0; i < 5 * K; ++i) px[i * plane] = 0.0f;
#pragma unroll
  for (int i = 0; i < NACC; ++i) px[Acc<MODE, NMOM>::plane(i, K) * plane] = acc[i];
}

template <int MODE, int NMOM, bool TRIG>
static void launch(dim3 grid, dim3 block, cudaStream_t st, const float* payload, long long ld,
                   const int* tile_start, const int* tile_count, const float* params,
                   const float* tf, const float* moments, const float* peel, float* out,
                   int n_tiles, int tiles_x, int tile_w, int tile_h, float sx, float sy, int K,
                   int chunk, int two_sided, int alpha_from_rows, int bands) {
  // Band shading changes only the modes that shade (wboit, mboit_resolve).
  if constexpr (MODE == WBOIT || MODE == RESOLVE) {
    if (bands) {
      accum_kernel<MODE, NMOM, TRIG, true><<<grid, block, 0, st>>>(
          payload, ld, tile_start, tile_count, params, tf, moments, peel, out, n_tiles,
          tiles_x, tile_w, tile_h, sx, sy, K, chunk, two_sided, alpha_from_rows);
      return;
    }
  }
  accum_kernel<MODE, NMOM, TRIG, false><<<grid, block, 0, st>>>(
      payload, ld, tile_start, tile_count, params, tf, moments, peel, out, n_tiles, tiles_x,
      tile_w, tile_h, sx, sy, K, chunk, two_sided, alpha_from_rows);
}

// Launches one block of tile_w * tile_h threads per tile on `stream`.
// mode: 0 count, 1 wboit, 2 mboit_gen (K = 2), 3 mboit_resolve; n_mom 4, 6
// or 8 and trig for the MBOIT modes. tf: the `tf_static_table` of the color
// and opacity TFs. moments: [1 + n_mom, n_tiles, P] (mboit_resolve only).
// peel: optional [n_tiles, P] NDC peel depths. out: [5 * K, n_tiles, P]
// float32, the planes of the accumulators (`_accum_slots`), zero elsewhere.
// Returns the cudaGetLastError() code of the launch.
extern "C" int raster_capsule_accum_launch(
    const float* payload, long long ld, const int* tile_start, const int* tile_count,
    const float* params, const float* tf, const float* moments, const float* peel, float* out,
    int n_tiles, int tiles_x, int tile_w, int tile_h, float sx, float sy, int K, int chunk,
    int mode, int n_mom, int trig, int two_sided, int alpha_from_rows, int bands,
    void* stream) {
  const bool mboit = mode == GEN || mode == RESOLVE;
  if (K < 1 || K > 32 || chunk > MAX_CHUNK || chunk < 1 || tile_w * tile_h > MAX_THREADS ||
      mode < COUNT || mode > RESOLVE || (mode == GEN && K != 2) ||
      (mboit && n_mom != 4 && n_mom != 6 && n_mom != 8) ||
      (mode == RESOLVE && moments == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles), block(tile_w * tile_h);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles == 0) return (int)cudaGetLastError();
#define ACCUM_ARGS                                                                           \
  grid, block, st, payload, ld, tile_start, tile_count, params, tf, moments, peel, out,      \
      n_tiles, tiles_x, tile_w, tile_h, sx, sy, K, chunk, two_sided, alpha_from_rows, bands
  if (mode == COUNT) {
    launch<COUNT, 4, false>(ACCUM_ARGS);
  } else if (mode == WBOIT) {
    launch<WBOIT, 4, false>(ACCUM_ARGS);
  } else if (mode == GEN) {
    if (trig) {
      if (n_mom == 4) launch<GEN, 4, true>(ACCUM_ARGS);
      else if (n_mom == 6) launch<GEN, 6, true>(ACCUM_ARGS);
      else launch<GEN, 8, true>(ACCUM_ARGS);
    } else {
      if (n_mom == 4) launch<GEN, 4, false>(ACCUM_ARGS);
      else if (n_mom == 6) launch<GEN, 6, false>(ACCUM_ARGS);
      else launch<GEN, 8, false>(ACCUM_ARGS);
    }
  } else {
    if (trig) {
      if (n_mom == 4) launch<RESOLVE, 4, true>(ACCUM_ARGS);
      else if (n_mom == 6) launch<RESOLVE, 6, true>(ACCUM_ARGS);
      else launch<RESOLVE, 8, true>(ACCUM_ARGS);
    } else {
      if (n_mom == 4) launch<RESOLVE, 4, false>(ACCUM_ARGS);
      else if (n_mom == 6) launch<RESOLVE, 6, false>(ACCUM_ARGS);
      else launch<RESOLVE, 8, false>(ACCUM_ARGS);
    }
  }
#undef ACCUM_ARGS
  return (int)cudaGetLastError();
}
