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
// `_accum_slots` gives the JAX kernel's output layout. Every fragment adds
// to its pixel's sums in candidate order (entry surface, then exit
// surface), with the plain version's expressions, so the sums are the plain
// version's bit for bit.
//
// What bounds it on the H100 (tools/kernel_split.py --kernels accum, the
// 1080p tornado at 16x8 tiles, chunk 128). The first design (tiles in index
// order, one thread a pixel on rows of 32, every candidate's three roots at
// every pixel, each fragment shaded where it was found) took 0.37 ms in
// 'count', 0.61 in 'wboit', 0.44 in 'mboit_gen' and 0.71 in 'mboit_resolve'.
// Its split: the longest run (231 candidates) alone took 0.30 of wboit's
// 0.61 ms and started three quarters through the index order (longest first
// -17 to -20%); the staging loop's integer division 7-11%; in 76% of the
// (warp, candidate) pairs no lane has a fragment, and a warp that shades
// has 3.3 lanes busy (wboit - count = 0.23 ms); the transmittance was 0.8%
// of the resolve's warp-cycles (2.5 fragments a pixel), so its set-up once
// a pixel bought nothing there; ptxas held the power resolves at 64
// registers with spills. In this design count spends 13% of its
// warp-cycles staging and 84% in pass 1; wboit 66% in pass 1 and 20% in
// pass 2; the longest tile alone takes 0.14 of wboit's 0.26 ms.
//
// Design (one block per tile, one thread per pixel):
//  - Blocks take the tiles longest run first (`order`: the binning's
//    `longest_first`, computed once per binning, so MBOIT's two passes share
//    it); in index order the launch takes 23-29% longer. A tile with an
//    empty run writes its zeros and leaves.
//  - Each warp holds an 8x4 block of the tile's pixels (rows of 32: +5-7%),
//    so a capsule a few pixels across meets few warps; a tile that such
//    blocks do not cover (12x8, 4x16, 32x1) gives each warp 32 pixels in
//    row-major order instead, the same sums.
//  - The run is walked in chunks of `chunk` candidates. Only the payload
//    rows the mode reads are staged (12 for 'count', 19 otherwise),
//    candidate-major with the odd stride NROWS, a warp per row: no division,
//    coalesced reads, no bank conflicts. Two buffers, one barrier a chunk;
//    dynamic shared memory sized to `chunk`.
//  - Pass 1, per candidate: the set-up and the three discriminants (body,
//    start cap, end cap); a warp vote per part skips that part's root where
//    no lane of the warp has its discriminant >= 0 (no votes: +5-9%, but -5%
//    in the trigonometric-8 resolve). Every fragment that survives the clip
//    and the peel test sets a bit of the thread's marks in shared memory (2
//    bits a candidate: entry, exit).
//  - Pass 2: each thread walks its marks in candidate order, takes the
//    surface again (the same operations, so the same t), shades it and adds
//    its terms. A warp thus takes as many steps as its lane with the most
//    fragments in the chunk, not one divergent step per candidate some lane
//    hits (word by word: +11-29%). 'count' adds the words' popcounts, which
//    rounds alike: counts are integers below 2^24.
//  - 'mboit_resolve' builds each pixel's moment factors once (the biased
//    moments and the Cholesky or LDL* factors; moment_math.cuh,
//    trig_moment_math.cuh), in registers; a fragment only takes the part at
//    its depth.
//  - No launch bounds: with __launch_bounds__(512) ptxas held every instance
//    at 64 registers and spilled 8-232 bytes; left to itself it takes 55-109
//    registers without spills (8 resident blocks of 128 threads a SM in
//    'count', 'wboit' and 'mboit_gen'), and a 512-pixel tile still fits.
//  - Mode, moment count and kind, and band shading are template arguments
//    (21 instances).
//
// Bound on the H100: FP32 ALU in 'count' and 'wboit', the output planes'
// bytes in the MBOIT passes. Each (candidate, pixel) evaluation needs ~46
// float operations (the set-up and the three discriminants) against 92 bytes
// of staged payload shared by the block; a part's root and tests (13-15)
// only where its discriminant is not negative, which at 1080p is a fifth of
// the evaluations for the body; each fragment adds its shading (~125
// operations) and its mode's terms (wboit ~35; mboit_gen 45 with 4 moments;
// mboit_resolve 100 at its depth, and the pixel's factors, 31 with 4
// moments, once). chip_smoke.py computes the least time from the run's own
// counts (`accum_needed_work`).
//
// Precision: built without --use_fast_math and with --fmad=false, as the
// plain version rounds: IEEE division and sqrt, powf/expf/logf/cosf/sinf.

#include <cuda_runtime.h>
#include <limits.h>

#include "capsule_common.cuh"
#include "moment_math.cuh"
#include "trig_moment_math.cuh"

#define NROWS 23         // payload rows 0-22, the stride of a staged candidate
#define MAX_CHUNK 256    // staged columns
#define MAX_THREADS 512  // pixels per tile
#define FULL 0xffffffffu
// Staged payload rows: those of the intersection (cand_setup, the
// discriminants, the start cap's flag) and those of the shading.
#define ROWS_HIT \
  (0x3Fu | (1u << 10) | (1u << 13) | (1u << 16) | (1u << 17) | (1u << 19) | (1u << 22))
#define ROWS_SHADE \
  ((1u << 7) | (1u << 8) | (1u << 11) | (1u << 12) | (1u << 18) | (1u << 20) | (1u << 21))

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

// The resolve's per-pixel part of the transmittance (moment_math.cuh,
// trig_moment_math.cuh), kept in registers.
template <int NMOM, bool TRIG>
struct Factors;
template <>
struct Factors<4, false> {
  using T = Moments4;
};
template <>
struct Factors<6, false> {
  using T = Moments6;
};
template <>
struct Factors<8, false> {
  using T = Moments8;
};
template <int NMOM>
struct Factors<NMOM, true> {
  using T = MomentsTrig<NMOM / 2>;
};

template <int NMOM, bool TRIG>
__device__ __forceinline__ typename Factors<NMOM, TRIG>::T pixel_factors(float b0v,
                                                                         const float* odds,
                                                                         const float* evens,
                                                                         float bias) {
  constexpr int NH = NMOM / 2;
  if constexpr (TRIG) {
    cpx trig_b[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) trig_b[k] = cx(odds[k], evens[k]);
    return trig_moment_setup<NH>(b0v, trig_b, bias);
  } else if constexpr (NMOM == 4) {
    return moment_setup_4(b0v, evens, odds, bias);
  } else if constexpr (NMOM == 6) {
    return moment_setup_6(b0v, evens, odds, bias);
  } else {
    return moment_setup_8(b0v, evens, odds, bias);
  }
}

template <int NMOM, bool TRIG>
__device__ __forceinline__ float factors_transmittance(const typename Factors<NMOM, TRIG>::T& m,
                                                       float dw, float overest, float wzp_y,
                                                       float wzp_z, float wzp_w) {
  if constexpr (TRIG) {
    return transmittance_trig<NMOM / 2>(m, dw, overest, wzp_y, wzp_z, wzp_w);
  } else if constexpr (NMOM == 4) {
    return transmittance_4(m, dw, overest);
  } else if constexpr (NMOM == 6) {
    return transmittance_6(m, dw, overest);
  } else {
    return transmittance_8(m, dw, overest);
  }
}

// Adds one shaded fragment (color, alpha in f) at world t `tw` to the
// accumulators of a mode other than 'count'. mf, resolve: the pixel's
// moment factors and whether its moments are kept (b0 at or above the
// discard threshold; else T = 1), for 'mboit_resolve'.
template <int MODE, int NMOM, bool TRIG>
__device__ __forceinline__ void add_fragment(float* acc, float4 f, float tw, float invlen,
                                             float zA, float zB, float log_dmin,
                                             float log_dmax, float m_overest, float wzp_y,
                                             float wzp_z, float wzp_w,
                                             const typename Factors<NMOM, TRIG>::T& mf,
                                             bool resolve) {
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
      // mboit_resolve (MBOITPass2.glsl:21-37): the transmittance from the
      // pixel's factors, only where the moments are kept.
      const float T_at =
          resolve ? factors_transmittance<NMOM, TRIG>(mf, dw, m_overest, wzp_y, wzp_z, wzp_w)
                  : 1.0f;
      const float wgt = a * T_at;
      acc[0] = acc[0] + wgt * f.x;
      acc[1] = acc[1] + wgt * f.y;
      acc[2] = acc[2] + wgt * f.z;
      acc[3] = acc[3] + wgt;
    }
  }
}

// The discriminants of capsule_common.cuh:cand_quad without its roots:
// the same operations, so the same bits.
struct Disc {
  float k1, k2, h, ha, b1b, hb;
};

__device__ __forceinline__ Disc cand_disc(const float* c, const Cand& cd) {
  const float baba = c[10], rr = c[22];
  const float oaoa = __fmaf_rn(cd.t0, cd.rdoa + cd.rd, c[17]);
  Disc d;
  d.k2 = fmaxf(baba - cd.bard * cd.bard, 1e-20f);
  d.k1 = baba * cd.rd - cd.baoa * cd.bard;
  const float k0 = baba * oaoa - cd.baoa * cd.baoa - c[19];
  d.h = d.k1 * d.k1 - d.k2 * k0;
  d.ha = cd.rd * cd.rd - (oaoa - rr);
  d.b1b = cd.rd - cd.bard;
  const float obob = oaoa - 2.0f * cd.baoa + baba;
  d.hb = d.b1b * d.b1b - (obob - rr);
  return d;
}

// capsule_common.cuh:surface_t with each part (body, start cap, end cap)
// evaluated only where its flag is set. A part whose discriminant is
// negative is rejected (its `h >= 0` term), whatever its root: a caller may
// clear a part's flag where that holds at every pixel it stands for, and
// the result is the same. sq, sqa, sqb: the parts' roots, read only where
// their flag is set.
__device__ __forceinline__ float surface(const Disc& d, const Cand& c, float baba, bool near,
                                         bool pb, bool pa, bool pc, float sq, float sqa,
                                         float sqb) {
  float rb = BIG, ra = BIG, rc = BIG;
  if (pb) {
    const float tb = near ? (-d.k1 - sq) / d.k2 : (-d.k1 + sq) / d.k2;
    const float yb = c.baoa + tb * c.bard;
    if ((d.h >= 0.0f) && (yb > 0.0f) && (yb < baba) && (c.t0 + tb > 0.0f)) rb = tb;
  }
  if (pa) {  // the start cap: `pa` includes its flag
    const float ta = near ? -c.rd - sqa : -c.rd + sqa;
    const float ya = c.baoa + ta * c.bard;
    if ((d.ha >= 0.0f) && (ya <= 0.0f) && (c.t0 + ta > 0.0f)) ra = ta;
  }
  if (pc) {
    const float tc = near ? -d.b1b - sqb : -d.b1b + sqb;
    const float yc = c.baoa + tc * c.bard;
    if ((d.hb >= 0.0f) && (yc >= baba) && (c.t0 + tc > 0.0f)) rc = tc;
  }
  return fminf(rb, fminf(ra, rc));
}

// Words of a thread's fragment marks for a chunk of C candidates.
__host__ __device__ __forceinline__ int mark_words(int C) { return (2 * C + 31) / 32; }

// Candidate j of a staged chunk (candidate-major, NROWS floats each) as the
// [row][column] view the capsule_common.cuh helpers read, at column 0.
__device__ __forceinline__ const float (*cand_view(const float* sb, int j))[1] {
  return reinterpret_cast<const float(*)[1]>(sb + j * NROWS);
}

template <int MODE, int NMOM, bool TRIG, bool BANDS>
__global__ void accum_kernel(const float* __restrict__ payload, long long ld,
                             const int* __restrict__ tile_start,
                             const int* __restrict__ tile_count, const int* __restrict__ order,
                             const float* __restrict__ params, const float* __restrict__ tf,
                             const float* __restrict__ moments, const float* __restrict__ peel,
                             float* __restrict__ out, int n_tiles, int tiles_x, int tile_w,
                             int tile_h, float sx, float sy, int K, int chunk, int two_sided,
                             int alpha_from_rows) {
  extern __shared__ float s_dyn[];
  constexpr int NH = NMOM / 2;
  constexpr int NACC = Acc<MODE, NMOM>::N;
  using FT = typename Factors<NMOM, TRIG>::T;
  constexpr unsigned ROWS = MODE == COUNT ? ROWS_HIT : (ROWS_HIT | ROWS_SHADE);

  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The warp's 8x4 block of the tile's pixels, lane l at pixel (l % 8, l / 8),
  // where such blocks cover the tile; else its 32 pixels in row-major order
  // (blocks of 32x1 pixels, one row stride of 32: q = tid). The choice is the
  // same for the whole launch, and the votes below hold under any mapping.
  // One expression for both (a branch or a select per term cost the power-8
  // resolve 7 registers and 4%).
  const bool blocks = tile_w % 8 == 0 && tile_h % 4 == 0;
  const int bw = blocks ? tile_w >> 3 : 1;  // blocks across the tile
  const int bsh = blocks ? 3 : 5;           // log2 of a block's width
  const int rs = blocks ? 4 * tile_w : 32;  // pixels per row of blocks
  const int q = (warp / bw) * rs + (lane >> bsh) * tile_w + ((warp % bw) << bsh) +
                (lane & ((1 << bsh) - 1));
  const int plane = n_tiles * P;  // element indices of `out` and `moments` fit an int
  const int pix = tile * P + q;
  float* const px = out + pix;

  const int count = tile_count[tile];
  if (count == 0) {  // the whole block: every sum is 0
    for (int p = 0; p < 5 * K; ++p) px[(long long)p * plane] = 0.0f;
    return;
  }

  // Shared memory: two staging buffers of `chunk` candidates and this
  // thread's fragment marks (2 bits a candidate: entry, exit).
  const int C = chunk;
  float* const stage = s_dyn;
  unsigned* const mk = reinterpret_cast<unsigned*>(s_dyn + 2 * C * NROWS) + q;

  const PixelRay ray = pixel_ray(params, tile, q, tiles_x, tile_w, tile_h, sx, sy);
  const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz, invlen = ray.invlen;
  const float len_p = 1.0f / invlen;
  const float zA = params[9], zB = params[10];
  const float tw_lo = (zB / zA) * len_p;
  const float tw_hi = (zB / (zA - 1.0f)) * len_p;
  const float peel_d = peel != nullptr ? peel[pix] : 0.0f;
  const Shading sh = shading_of(params, tf, alpha_from_rows != 0);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  // mboit_resolve: the moment factors, once, from the pass-1 moments
  // normalized by b0, where they are kept (b0 not under the threshold).
  FT mf;
  bool resolve = false;
  if constexpr (MODE == RESOLVE) {
    const float b0v = moments[pix];
    resolve = !(b0v < MBOIT_DISCARD_B0);
    if (resolve) {
      const float inv_b0 = 1.0f / fmaxf(b0v, 1e-6f);
      float odds[NH], evens[NH];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        odds[j] = moments[(1 + j) * plane + pix] * inv_b0;
        evens[j] = moments[(1 + NH + j) * plane + pix] * inv_b0;
      }
      mf = pixel_factors<NMOM, TRIG>(b0v, odds, evens, params[17]);
    }
  }

  const int start = tile_start[tile];
  for (int c0 = 0, b = 0; c0 < count; c0 += C, b ^= 1) {
    const int n = min(C, count - c0);
    float* const sb = stage + b * C * NROWS;
    // Staging: a warp per payload row, the run's columns along the lanes
    // (coalesced reads; the odd stride NROWS keeps the writes free of bank
    // conflicts). Two buffers: a chunk is staged while no thread still reads
    // the buffer it overwrites, so one barrier a chunk orders the staging.
    const float* src = payload + (long long)start + c0;
    for (int r = warp; r < NROWS; r += P >> 5)
      if ((ROWS >> r) & 1u)
        for (int j = lane; j < n; j += 32) sb[j * NROWS + r] = src[(long long)r * ld + j];
    __syncthreads();

    // Pass 1: the chunk's fragments of this pixel, as marks.
    const int nw = (2 * n + 31) / 32;
    for (int w = 0; w < nw; ++w) mk[w * P] = 0u;
    for (int j = 0; j < n; ++j) {
      const float* cj = sb + j * NROWS;
      const Cand cd = cand_setup(cand_view(sb, j), 0, dnx, dny, dnz);
      const Disc d = cand_disc(cj, cd);
      // The votes: a part whose discriminant is negative at every pixel of
      // the warp (whichever pixels it holds) is rejected at every pixel
      // whatever its root (`surface`),
      // so its root is not taken. The start cap's flag is the same at every
      // pixel of the block. Where no part is left, neither surface exists.
      const bool pb = __any_sync(FULL, d.h >= 0.0f);
      const bool pa = cj[13] > 0.5f && __any_sync(FULL, d.ha >= 0.0f);
      const bool pc = __any_sync(FULL, d.hb >= 0.0f);
      if (!(pb || pa || pc)) continue;
      const float sq = pb ? sqrtf(fmaxf(d.h, 0.0f)) : 0.0f;
      const float sqa = pa ? sqrtf(fmaxf(d.ha, 0.0f)) : 0.0f;
      const float sqb = pc ? sqrtf(fmaxf(d.hb, 0.0f)) : 0.0f;
      for (int side = 0; side <= two_sided; ++side) {
        const float tc = surface(d, cd, cj[10], side == 0, pb, pa, pc, sq, sqa, sqb);
        if (!(tc < BIG)) continue;
        const float tw = cd.t0 + tc;
        if (!(tw >= tw_lo && tw <= tw_hi)) continue;
        if (peel != nullptr && !(zA - zB / fmaxf(tw * invlen, 1e-12f) > peel_d)) continue;
        const int bit = 2 * j + side;
        mk[(bit >> 5) * P] |= 1u << (bit & 31);
      }
    }

    // Pass 2: the marked fragments in candidate order (column, then entry
    // before exit), each surface taken again (the same operations, so the
    // same t), shaded and added. Each lane walks its own marks, so a warp
    // takes as many steps as its lane with the most fragments in the chunk.
    if constexpr (MODE == COUNT) {
      // Counts are integers below 2^24: adding a word's count at once
      // rounds as adding its fragments one by one.
      for (int w = 0; w < nw; ++w) acc[0] = acc[0] + (float)__popc(mk[w * P]);
    } else {
      int w = 0;
      unsigned m = mk[0];
      for (;;) {
        while (m == 0u && ++w < nw) m = mk[w * P];
        if (m == 0u) break;
        const int bit = w * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const int j = bit >> 1;
        const float* cj = sb + j * NROWS;
        const Cand cd = cand_setup(cand_view(sb, j), 0, dnx, dny, dnz);
        const Disc d = cand_disc(cj, cd);
        const float tc = surface(d, cd, cj[10], (bit & 1) == 0, true, cj[13] > 0.5f, true,
                                 sqrtf(fmaxf(d.h, 0.0f)), sqrtf(fmaxf(d.ha, 0.0f)),
                                 sqrtf(fmaxf(d.hb, 0.0f)));
        const float tw = cd.t0 + tc;
        add_fragment<MODE, NMOM, TRIG>(
            acc, cand_fragment<BANDS>(cand_view(sb, j), 0, cd, tc, tw, invlen, sh, MODE == GEN),
            tw, invlen, zA, zB, params[15], params[16], params[18], params[20], params[21],
            params[22], mf, resolve);
      }
    }
  }

  for (int p = 0; p < 5 * K; ++p) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < NACC; ++i) v = Acc<MODE, NMOM>::plane(i, K) == p ? acc[i] : v;
    px[(long long)p * plane] = v;
  }
}

typedef void (*accum_kernel_t)(const float*, long long, const int*, const int*, const int*,
                               const float*, const float*, const float*, const float*, float*,
                               int, int, int, int, float, float, int, int, int, int);

template <int MODE, bool TRIG, bool BANDS>
static accum_kernel_t by_moments(int n_mom) {
  return n_mom == 4   ? accum_kernel<MODE, 4, TRIG, BANDS>
         : n_mom == 6 ? accum_kernel<MODE, 6, TRIG, BANDS>
                      : accum_kernel<MODE, 8, TRIG, BANDS>;
}

// The instance of a mode (0 count, 1 wboit, 2 mboit_gen, 3 mboit_resolve),
// moment count and kind; band shading changes only the modes that shade.
static accum_kernel_t accum_instance(int mode, int n_mom, int trig, int bands) {
  switch (mode) {
    case COUNT:
      return accum_kernel<COUNT, 4, false, false>;
    case WBOIT:
      return bands ? accum_kernel<WBOIT, 4, false, true> : accum_kernel<WBOIT, 4, false, false>;
    case GEN:
      return trig ? by_moments<GEN, true, false>(n_mom) : by_moments<GEN, false, false>(n_mom);
    default:
      if (trig) return bands ? by_moments<RESOLVE, true, true>(n_mom)
                             : by_moments<RESOLVE, true, false>(n_mom);
      return bands ? by_moments<RESOLVE, false, true>(n_mom)
                   : by_moments<RESOLVE, false, false>(n_mom);
  }
}

// The dynamic shared memory of a block of P pixels.
static size_t shared_bytes(int P, int chunk) {
  return (size_t)2 * chunk * NROWS * sizeof(float) + (size_t)mark_words(chunk) * P * 4;
}

// Launches one block of tile_w * tile_h threads per tile on `stream`, the
// tiles in the order `order` gives ([n_tiles] int32, a permutation; the
// longest runs first). mode: 0 count, 1 wboit, 2 mboit_gen (K = 2), 3
// mboit_resolve; n_mom 4, 6 or 8 and trig for the MBOIT modes. tf: the
// `tf_static_table` of the color and opacity TFs. moments: [1 + n_mom,
// n_tiles, P] (mboit_resolve only). peel: optional [n_tiles, P] NDC peel
// depths. out: [5 * K, n_tiles, P] float32, the planes of the accumulators
// (`_accum_slots`), zero elsewhere. Returns a CUDA error code:
// cudaErrorInvalidValue for arguments out of range (a tile of P pixels needs
// P a multiple of 32, at most 512; the planes of `out` and `moments` need
// fewer than 2^31 elements), else that of the launch.
extern "C" int raster_capsule_accum_launch(
    const float* payload, long long ld, const int* tile_start, const int* tile_count,
    const int* order, const float* params, const float* tf, const float* moments,
    const float* peel, float* out, int n_tiles, int tiles_x, int tile_w, int tile_h, float sx,
    float sy, int K, int chunk, int mode, int n_mom, int trig, int two_sided,
    int alpha_from_rows, int bands, void* stream) {
  const bool mboit = mode == GEN || mode == RESOLVE;
  const int P = tile_w * tile_h;
  const int planes = mode == RESOLVE && 1 + n_mom > 5 * K ? 1 + n_mom : 5 * K;
  if (K < 1 || K > 32 || chunk > MAX_CHUNK || chunk < 1 || P > MAX_THREADS || P % 32 ||
      P == 0 || (long long)n_tiles * P * planes > INT_MAX || mode < COUNT ||
      mode > RESOLVE || (mode == GEN && K != 2) ||
      (mboit && n_mom != 4 && n_mom != 6 && n_mom != 8) ||
      (mode == RESOLVE && moments == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const accum_kernel_t kernel = accum_instance(mode, n_mom, trig, bands);
  const size_t smem = shared_bytes(P, chunk);
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute((const void*)kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)smem);
    if (e) return e;
  }
  kernel<<<n_tiles, P, smem, (cudaStream_t)stream>>>(
      payload, ld, tile_start, tile_count, order, params, tf, moments, peel, out, n_tiles,
      tiles_x, tile_w, tile_h, sx, sy, K, chunk, two_sided, alpha_from_rows);
  return (int)cudaGetLastError();
}

// The 21 instances: (mode, n_mom, trig, bands).
static const int INSTANCES[21][4] = {
    {COUNT, 4, 0, 0},   {WBOIT, 4, 0, 0},   {WBOIT, 4, 0, 1},   {GEN, 4, 0, 0},
    {GEN, 6, 0, 0},     {GEN, 8, 0, 0},     {GEN, 4, 1, 0},     {GEN, 6, 1, 0},
    {GEN, 8, 1, 0},     {RESOLVE, 4, 0, 0}, {RESOLVE, 6, 0, 0}, {RESOLVE, 8, 0, 0},
    {RESOLVE, 4, 1, 0}, {RESOLVE, 6, 1, 0}, {RESOLVE, 8, 1, 0}, {RESOLVE, 4, 0, 1},
    {RESOLVE, 6, 0, 1}, {RESOLVE, 8, 0, 1}, {RESOLVE, 4, 1, 1}, {RESOLVE, 6, 1, 1},
    {RESOLVE, 8, 1, 1}};

// Resources of instance i at a 16x8 tile and chunk 128: v = (registers,
// local bytes, static shared bytes, resident blocks per SM, threads,
// dynamic shared bytes), `label` its name. Returns a CUDA error code,
// cudaErrorInvalidValue past the last instance.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i >= 21) return (int)cudaErrorInvalidValue;
  const int* c = INSTANCES[i];
  const void* f = (const void*)accum_instance(c[0], c[1], c[2], c[3]);
  const int P = 128, threads = P;
  const size_t smem = shared_bytes(P, 128);
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, f);
  int nb = 0;
  if (!e && smem > 48 * 1024)
    e = (int)cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, threads, smem);
  if (e) return e;
  v[0] = a.numRegs;
  v[1] = (int)a.localSizeBytes;
  v[2] = (int)a.sharedSizeBytes;
  v[3] = nb;
  v[4] = threads;
  v[5] = (int)smem;
  static const char* modes[4] = {"count", "wboit", "mboit_gen", "mboit_resolve"};
  char nm[48];
  int k = 0;
  for (const char* p = modes[c[0]]; *p; ++p) nm[k++] = *p;
  if (c[0] >= GEN) {
    nm[k++] = ' ';
    nm[k++] = (char)('0' + c[1]);
    if (c[2])
      for (const char* p = " trig"; *p; ++p) nm[k++] = *p;
  }
  if (c[3])
    for (const char* p = " bands"; *p; ++p) nm[k++] = *p;
  nm[k] = 0;
  for (k = 0; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
