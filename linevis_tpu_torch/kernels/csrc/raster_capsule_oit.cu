// MLAB K-buffer over binned capsules for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlab_kernel` in
// linevis_tpu/kernels/raster_capsule_oit.py:116 (wrapper
// `rasterize_capsules_mlab`, :1096) in its K-buffer store modes 'shade' and
// 'gather' (the accumulation modes are raster_capsule_accum.cu): per pixel, a K-node
// depth-sorted buffer of front-face capsule fragments (and, with two_sided,
// exit-surface fragments), inserted in the binning's front-to-back run
// order, with the Multi-Layer Alpha Blending overflow merge into node K-1,
// or the exact front-K buffer (no_overflow, the reference's Atomic Loop and
// each depth-peeling pass). With `peel` only fragments behind the pixel's
// peel depth enter. The nodes carry each fragment's shaded color
// (per-fragment shading) or, with `deferred`, its shading features;
// composite mode shades such nodes and blends them front to back over the
// background; node mode writes the 5K planes. In 'gather' (the importance
// gather of opacity optimization) each fragment is (attribute, segment id
// as a float, 0, 1) and a node holds its tie window's plain average, not
// premultiplied; with every alpha at 1 the MLAB merge adds nothing. `bands`
// sets the diffuse exponent to 1.0 (band shading) per fragment and in the
// composite.
// The plain PyTorch version it is held against is
// `rasterize_capsules_mlab_reference` (kernels/raster_capsule_oit.py); the
// semantics are listed in that module's docstring.
//
// What bounds it on the H100 (tools/kernel_split.py, 1080p tornado, K=8).
// The first design kept every hit of a block in per-thread local-memory
// arrays, rescanned them for each of up to K windows, and shaded all K
// nodes in the composite: 1.94 ms, 128 registers, a 1616-byte stack. Its
// split: shading the composite's empty nodes 0.65 ms (85% of the pixels
// hold none), the staging loop's integer division 0.13 ms, the tile-wide
// bound 0.10 ms. Then register pressure: with the K nodes and the hits in
// registers the kernel needs its full 128 registers (4 blocks of 128
// threads per SM), and the node state in registers cost 38-49% against
// the same nodes in shared memory. In this design (with 4 list slots) the
// warp-cycles of the composite go 33% to the candidate scans, 24% to the
// windows, 14% to the epilogue, 29% to set-up, staging and the bound;
// barrier waits are nil. A list of 4 slots is ~12% faster at 1080p than
// one of 6, but at 480x272, where a block holds more hits per pixel and
// the list refills more often, 10% slower: 6 keeps every mode at or under
// the first design's time.
//
// Design (one block per tile, one thread per pixel):
//  - The block walks its run in chunks of `chunk` pair columns aligned as
//    the TPU kernel's DMA windows are, staging payload rows 0-22 of the
//    chunk's in-run columns in shared memory (a warp per row, no division;
//    23 x 4 B per candidate, read by every thread as a broadcast). Within a
//    chunk it walks aligned blocks of `sub` candidates: the block grid, and
//    with it the per-block limit of K extracted tie windows, is that of the
//    TPU kernel. A tile with an empty run skips the walk.
//  - Tile-wide culls as on the TPU: one barrier per block max-reduces each
//    pixel's bound (its K-th node depth where the pixel is blocked, else
//    2.0; a warp with an open pixel contributes 2.0 without shuffles) and
//    holds it against the chunk's and then each block's least
//    bucket-floored depth (payload row 15). The chunk exit ends the run;
//    the block cull skips the block. `work` counts the candidates evaluated
//    after both. T_K = prod(1 - a_i) is the TPU kernel's halving tree with
//    every index known at compile time (one tree per K), recomputed only
//    after the node state changed.
//  - Per thread and block, one pass over the candidates keeps the SLOTS
//    nearest hits in registers, sorted by world t (with relative t and the
//    key side * MAX_CHUNK + column, whose order is the candidate order of
//    the plain version's sums), and the least t of any hit that did not fit.
//    The rejection of fragments behind a blocked pixel's K-th node is
//    evaluated against the node state at block start. The tie windows
//    (t <= t_min + |t_min|*1e-6) then come off the front of the list, at
//    most K of them; each window's members are summed in key order (a lone
//    member, the common case, skips the selection and the divisions), and
//    only they are shaded. A window whose bound reaches a hit that did not
//    fit refills the list from the staged candidates past the windows
//    taken; one of more than SLOTS hits (coincident geometry) is summed in
//    batches of SLOTS members in key order. The peel test and the
//    no_overflow rejection compare the fragment's NDC depth, formed as the
//    extraction forms node depths, so a layer at the peel depth is neither
//    taken twice nor skipped. Every piece of the walk has one call site:
//    nothing is called out of line.
//  - The K nodes (5 channels) live in shared memory, a padded row per
//    thread (101 registers, 5 blocks per SM at 16x8 tiles and KMAX 8),
//    wherever they fit beside the staged rows: every tile at KMAX 8 and 16,
//    up to 256 pixels at KMAX 32. Beyond that three channels stay in shared
//    memory (194 KB at 512 pixels) and two in registers (128 registers, 298
//    bytes of spills); all five in registers spilled 9.6 KB and ran 7x
//    slower. Every node loop is unrolled over KMAX and guarded by the
//    runtime K <= KMAX, so no node index is dynamic. The
//    kernel is also templated on BANDS, the diffuse exponent
//    (capsule_common.cuh:diffuse_mix). The composite shades only nodes with
//    alpha: an empty node adds exactly +-0 to the sums and multiplies T by
//    exactly 1, so the result is the same.
//
// Precision: built without --use_fast_math and with --fmad=false (IEEE
// sqrt, division and powf, never __powf; 1.0f/sqrtf, never rsqrtf). The
// re-origined scalars ba.oa' and oa'.oa' are the explicitly fused operations
// (__fmaf_rn; capsule_common.fma32 in the plain version), as XLA contracts
// them: oa'.oa' is ~1e-3 formed from terms ~2, so its rounding decides the
// hit depth at silhouettes.
//
// Bound on the H100: FP32 ALU. Each (candidate, pixel) evaluation costs
// about 95 float operations (two dot products, the three quadratics and
// roots, acceptance tests, the clip and the rejection), against 92 bytes of
// staged payload shared by the block's threads; each window member adds its
// shading features (~45 operations; per-fragment shading adds the color TF,
// three powf and the depth cue, ~80 more). The least time is those
// operations over 67 TFLOP/s (chip_smoke.py computes it from the plain
// version's counts).

#include <cuda_runtime.h>
#include <limits.h>

#include "capsule_common.cuh"

#define NROWS 23         // staged payload rows 0-22
#define MAX_CHUNK 256    // staged columns
#define MAX_THREADS 512  // pixels per tile
#define ROW_ZQ 15
#define SLOTS 6          // nearest hits of a block a thread keeps in registers
#define NO_HIT __int_as_float(0x7f800000)  // +inf: an empty slot

struct Opts {
  int K, chunk, sub, composite, no_overflow, two_sided, alpha_from_rows, deferred, gather;
  float sat_thr;  // float32(1 - sat)
};

// prod(x[0:N]) as the TPU kernel's halving tree (an odd remainder folds into
// x[0] after each level), every index known at compile time.
template <int N>
struct HalvingTree {
  template <int KMAX>
  __device__ __forceinline__ static void run(float (&x)[KMAX]) {
    constexpr int h = N / 2;
#pragma unroll
    for (int i = 0; i < h; ++i) x[i] = x[i] * x[h + i];
    if constexpr ((N & 1) != 0) x[0] = x[0] * x[N - 1];
    HalvingTree<h>::run(x);
  }
};

template <>
struct HalvingTree<1> {
  template <int KMAX>
  __device__ __forceinline__ static void run(float (&)[KMAX]) {}
};

// T_K = prod(1 - a_i) over the first K nodes: the tree of the runtime K.
template <int N, int KMAX>
__device__ __forceinline__ float transmittance_k(float (&x)[KMAX], int K) {
  if constexpr (N > 1) {
    if (K == N) {
      HalvingTree<N>::run(x);
      return x[0];
    }
    return transmittance_k<N - 1, KMAX>(x, K);
  } else {
    return x[0];
  }
}

// The K nodes of a pixel, channel c (depth, three colors or features,
// alpha) of node q: channels c < NSM in shared memory, a row of
// NSM * KMAX + 1 words per thread (odd: the threads of a warp hit 32
// different banks; every offset an immediate), the others in registers.
template <int KMAX, int NSM>
struct NodeBuf {
  float* p;
  float v[NSM < 5 ? 5 - NSM : 1][KMAX];
  __device__ __forceinline__ explicit NodeBuf(float* row) : p(row) {}
  __device__ __forceinline__ float& operator()(int c, int q) {
    return c < NSM ? p[c * KMAX + q] : v[c - NSM][q];
  }
};

template <int KMAX, bool BANDS, int NSM>
__global__ void __launch_bounds__(MAX_THREADS)
mlab_kernel(const float* __restrict__ payload, long long ld,
            const int* __restrict__ tile_start, const int* __restrict__ tile_count,
            const float* __restrict__ params, const float* __restrict__ tf,
            const float* __restrict__ peel, float* __restrict__ out,
            int* __restrict__ work, int n_tiles, int tiles_x,
            int tile_w, int tile_h, float sx, float sy, Opts o) {
  __shared__ float s[NROWS][MAX_CHUNK];
  __shared__ float s_red[2][MAX_THREADS / 32];
  extern __shared__ float s_nodes[];  // [P][NSM * KMAX + 1]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = P >> 5;
  const int K = o.K;

  const float zA = params[9], zB = params[10];
  const Shading sh = shading_of(params, tf, o.alpha_from_rows);

  NodeBuf<KMAX, NSM> N(s_nodes + tid * (NSM * KMAX + 1));
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    N(0, q) = 2.0f;
    N(1, q) = N(2, q) = N(3, q) = N(4, q) = 0.0f;
  }

  const int start = tile_start[tile];
  const int end = start + tile_count[tile];
  int evaluated = 0;
  if (end > start) {  // an empty run leaves the nodes empty: no ray, no walk
    const PixelRay ray = pixel_ray(params, tile, tid, tiles_x, tile_w, tile_h, sx, sy);
    const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz, invlen = ray.invlen;
    const float len_p = 1.0f / invlen;
    const float tw_lo = (zB / zA) * len_p;
    const float tw_hi = (zB / (zA - 1.0f)) * len_p;
    const float peel_d = peel != nullptr ? peel[(long long)tile * P + tid] : 0.0f;

    // Walk state. Every piece of the walk below has one call site, so
    // everything is inlined and the hit list stays in registers.
    bool dirty = true, blocked = false;
    float dK = 2.0f;
    int red = 0;  // s_red buffer of the next reduction

    // The block's nearest hits, sorted by world t (an empty slot is NO_HIT):
    // relative t and the key side * MAX_CHUNK + column, whose order is the
    // candidate order the window sums follow (entry surfaces, then exit
    // surfaces). `dropped`: a hit fell off the end; `dmin` the least such t.
    float Ltw[SLOTS], Ltc[SLOTS];
    int Lkey[SLOTS];
    bool dropped = false;
    float dmin = NO_HIT;

    const int C = o.chunk, sub = o.sub;
    int c0 = -1, lo = 0, hi = 0;  // the staged chunk and its in-run columns
    for (int b0 = (start / sub) * sub; b0 < end; b0 += sub) {
      const bool new_chunk = (b0 / C) * C != c0;
      if (new_chunk) {
        c0 = (b0 / C) * C;
        lo = max(c0, start);
        hi = min(c0 + C, end);
        __syncthreads();  // the previous chunk's reads are done
        for (int r = warp; r < NROWS; r += nwarps)
          for (int j = lo - c0 + lane; j < hi - c0; j += 32)
            s[r][j] = payload[(long long)r * ld + c0 + j];
      }
      // The pixel's bound for the tile-wide culls, max-reduced over the tile
      // in one barrier (which also makes the staged rows visible); a warp
      // with an open pixel bounds it at 2.0 without shuffles.
      if (dirty) {
        dK = 2.0f;
#pragma unroll
        for (int q = 0; q < KMAX; ++q)
          if (q == K - 1) dK = N(0, q);
        if (o.no_overflow) {
          blocked = dK < 2.0f;
        } else {
          float x[KMAX];
#pragma unroll
          for (int q = 0; q < KMAX; ++q) x[q] = 1.0f - N(4, q);
          blocked = transmittance_k<KMAX, KMAX>(x, K) <= o.sat_thr;
        }
        dirty = false;
      }
      {
        const float m = __all_sync(0xffffffffu, blocked) ? warp_max(dK) : 2.0f;
        if (lane == 0) s_red[red][warp] = m;
      }
      __syncthreads();
      float zk = s_red[red][0];
      for (int w = 1; w < nwarps; ++w) zk = fmaxf(zk, s_red[red][w]);
      red ^= 1;
      if (new_chunk) {
        // Chunk exit: the chunk lies behind every pixel's bound, and so does
        // the rest of the depth-ordered run.
        float zmin = 3.0f;
        for (int j = lo - c0 + lane; j < hi - c0; j += 32) zmin = fminf(zmin, s[ROW_ZQ][j]);
        if (warp_min(zmin) > zk) break;
      }
      const int jlo = max(b0, lo) - c0, jhi = min(b0 + sub, hi) - c0;
      float bz = 3.0f;
      for (int j = jlo + lane; j < jhi; j += 32) bz = fminf(bz, s[ROW_ZQ][j]);
      if (warp_min(bz) > zk) continue;  // block cull
      evaluated += jhi - jlo;

      // The rejection of fragments behind a blocked pixel's K-th node uses
      // the node state at block start.
      const bool blk = blocked;
      const float blk_dK = dK;
      const float t_rej = zB / fmaxf(zA - dK, 1e-9f) * len_p;
      const bool by_znd = peel != nullptr || (blk && o.no_overflow);

      // At most K tie windows, nearest first, off the front of the sorted
      // list. A window whose bound reaches a hit that did not fit refills the
      // list from the staged candidates past the windows taken. A window of
      // more than SLOTS hits (coincident geometry) is summed in batches: each
      // refill takes its next SLOTS members in candidate order.
      float t_done = -NO_HIT;  // the last window's bound: hits up to it are taken
      bool need_fill = true, fresh = false;
      bool big = false;  // summing a window of more than SLOTS hits
      float bt = 0.0f, thr = 0.0f;
      int last_key = -1;  // of a big window: the members summed so far
      float n = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f, sa = 0.0f;
      for (int win = 0; win < K;) {
        if (need_fill) {
#pragma unroll
          for (int q = 0; q < SLOTS; ++q) {
            Ltw[q] = NO_HIT;
            Ltc[q] = 0.0f;
            Lkey[q] = 0;
          }
          dropped = false;
          dmin = NO_HIT;
          if (!big) {
            // The nearest SLOTS hits beyond `t_done`: clipped to the NDC
            // depth range, behind the peel depth, not rejected.
            for (int j = jlo; j < jhi; ++j) {
              const Cand cd = cand_setup(s, j, dnx, dny, dnz);
              const Quad qd = cand_quad(s, j, cd);
              const bool cap_a_on = s[13][j] > 0.5f;
              for (int side = 0; side <= o.two_sided; ++side) {
                const float tc = surface_t(qd, cd, s[10][j], cap_a_on, side == 0);
                const float tw = cd.t0 + tc;
                bool ok = tc < BIG && tw >= tw_lo && tw <= tw_hi && tw > t_done;
                if (ok && by_znd) {
                  const float znd = zA - zB / fmaxf(tw * invlen, 1e-12f);
                  if (peel != nullptr) ok = znd > peel_d;  // peeled already
                  if (blk && o.no_overflow) ok = ok && znd < blk_dK;
                }
                if (blk && !o.no_overflow) ok = ok && tw < t_rej;
                if (!ok) continue;
                // The farthest of SLOTS + 1 hits falls off.
                if (!(tw < Ltw[SLOTS - 1])) {
                  dropped = true;
                  dmin = fminf(dmin, tw);
                  continue;
                }
                if (Ltw[SLOTS - 1] != NO_HIT) {
                  dropped = true;
                  dmin = fminf(dmin, Ltw[SLOTS - 1]);
                }
                // Sorted insertion by world t.
                const int key = side * MAX_CHUNK + j;
#pragma unroll
                for (int q = SLOTS - 1; q >= 0; --q) {
                  if (q > 0 && Ltw[q - 1] > tw) {
                    Ltw[q] = Ltw[q - 1];
                    Ltc[q] = Ltc[q - 1];
                    Lkey[q] = Lkey[q - 1];
                  } else if (Ltw[q] > tw) {
                    Ltw[q] = tw;
                    Ltc[q] = tc;
                    Lkey[q] = key;
                  }
                }
              }
            }
          } else {
            // The next SLOTS members of the big window (t_done, thr] past
            // last_key, in candidate order: entry surfaces, then exit surfaces.
            int got = 0;
            for (int side = 0; side <= o.two_sided; ++side) {
              for (int j = jlo; j < jhi; ++j) {
                const Cand cd = cand_setup(s, j, dnx, dny, dnz);
                const float tc = surface_t(cand_quad(s, j, cd), cd, s[10][j], s[13][j] > 0.5f,
                                           side == 0);
                const float tw = cd.t0 + tc;
                const int key = side * MAX_CHUNK + j;
                bool ok = tc < BIG && tw >= tw_lo && tw <= tw_hi && tw > t_done && tw <= thr &&
                          key > last_key;
                if (ok && by_znd) {
                  const float znd = zA - zB / fmaxf(tw * invlen, 1e-12f);
                  if (peel != nullptr) ok = znd > peel_d;
                  if (blk && o.no_overflow) ok = ok && znd < blk_dK;
                }
                if (blk && !o.no_overflow) ok = ok && tw < t_rej;
                if (!ok) continue;
                if (got == SLOTS) {  // full: members left for the next batch
                  dropped = true;
                  continue;
                }
                ++got;  // sorted by world t; the members are summed by key
#pragma unroll
                for (int q = SLOTS - 1; q >= 0; --q) {
                  if (q > 0 && Ltw[q - 1] > tw) {
                    Ltw[q] = Ltw[q - 1];
                    Ltc[q] = Ltc[q - 1];
                    Lkey[q] = Lkey[q - 1];
                  } else if (Ltw[q] > tw) {
                    Ltw[q] = tw;
                    Ltc[q] = tc;
                    Lkey[q] = key;
                  }
                }
              }
            }
          }
          need_fill = false;
          fresh = true;
        }
        if (!big) {
          if (Ltw[0] == NO_HIT) {
            if (!dropped) break;
            need_fill = true;  // the hits that did not fit
            continue;
          }
          bt = Ltw[0];
          thr = bt + fabsf(bt) * 1e-6f;
          n = sr = sg = sb = sa = 0.0f;
          if (dropped && !(thr < dmin)) {
            if (!fresh) {
              need_fill = true;
              continue;
            }
            big = true;  // its members may not all be in the list
            last_key = -1;
            need_fill = true;
            continue;
          }
        }
        // The members in the list (its prefix up to thr; of a big window all
        // of it), summed by key: the member's color, its shading features
        // (deferred), or its importance and segment id (gather).
        int m = 0;
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) m += Ltw[q] <= thr;
        for (int t = 0; t < m; ++t) {
          // A lone member is the list's first slot.
          int bk = Lkey[0];
          float btw = Ltw[0], btc = Ltc[0];
          if (m > 1) {
            bk = INT_MAX;
#pragma unroll
            for (int q = 0; q < SLOTS; ++q) {
              if (Ltw[q] <= thr && Lkey[q] > last_key && Lkey[q] < bk) {
                bk = Lkey[q];
                btw = Ltw[q];
                btc = Ltc[q];
              }
            }
          }
          last_key = bk;
          const int j = bk & (MAX_CHUNK - 1);
          const Cand cd = cand_setup(s, j, dnx, dny, dnz);
          const float4 f = o.gather ? gather_fragment(s, j, cd, btc)
                                    : cand_fragment<BANDS>(s, j, cd, btc, btw, invlen, sh,
                                                           o.deferred);
          n += 1.0f;
          sr = sr + f.x;
          sg = sg + f.y;
          sb = sb + f.z;
          sa = sa + f.w;
        }
        if (big) {
          if (dropped) {  // more members to come
            need_fill = true;
            continue;
          }
          big = false;
#pragma unroll
          for (int q = 0; q < SLOTS; ++q) Ltw[q] = NO_HIT;
          dropped = true;  // refilled for the next window
        } else {
          for (int t = 0; t < m; ++t) {  // pop the members
#pragma unroll
            for (int q = 0; q < SLOTS - 1; ++q) {
              Ltw[q] = Ltw[q + 1];
              Ltc[q] = Ltc[q + 1];
              Lkey[q] = Lkey[q + 1];
            }
            Ltw[SLOTS - 1] = NO_HIT;
          }
          fresh = false;
        }
        last_key = -1;
        t_done = thr;
        ++win;

        // The carry: the window's averages (x / 1 is x: a lone member skips
        // the divisions), premultiplied except in gather.
        const float nwin = fmaxf(n, 1.0f);
        const bool lone = nwin == 1.0f;
        const float ca = lone ? sa : sa / nwin;
        const float cdp = zA - zB / fmaxf(bt * invlen, 1e-12f);
        float cr = lone ? sr : sr / nwin, cg = lone ? sg : sg / nwin, cb = lone ? sb : sb / nwin;
        if (!o.gather) {
          cr = cr * ca;
          cg = cg * ca;
          cb = cb * ca;
        }

        // Insert at pos = #{d_j <= carry}; a carry within the tie window of
        // an existing node is that node, extracted earlier: dropped.
        const float eps = fabsf(zB) * 1e-6f / fmaxf(bt * invlen, 1e-12f);
        int pos = 0;
        bool dup = false;
#pragma unroll
        for (int q = 0; q < KMAX; ++q) {
          if (q < K) {
            pos += N(0, q) <= cdp;
            dup = dup || (fabsf(N(0, q) - cdp) <= eps && N(0, q) < 2.0f);
          }
        }
        if (dup) pos = K;
        float ed = cdp, er = cr, eg = cg, eb = cb, ea = ca;  // evicted
        if (pos < K) {
#pragma unroll
          for (int q = 0; q < KMAX; ++q) {
            if (q == K - 1) {
              ed = N(0, q); er = N(1, q); eg = N(2, q); eb = N(3, q); ea = N(4, q);
            }
          }
#pragma unroll
          for (int q = KMAX - 1; q >= 0; --q) {
            if (q < K && q >= pos) {
              if (q == pos) {
                N(0, q) = cdp; N(1, q) = cr; N(2, q) = cg; N(3, q) = cb; N(4, q) = ca;
              } else {
                N(0, q) = N(0, q - 1); N(1, q) = N(1, q - 1); N(2, q) = N(2, q - 1);
                N(3, q) = N(3, q - 1); N(4, q) = N(4, q - 1);
              }
            }
          }
          dirty = true;
        }
        if (!o.no_overflow && !dup && ed < 2.0f) {
          // MLAB overflow: the evicted fragment composites into node K-1
          // under the new node's remaining transmittance.
#pragma unroll
          for (int q = 0; q < KMAX; ++q) {
            if (q == K - 1) {
              const float w = 1.0f - N(4, q);
              N(1, q) = N(1, q) + w * er;
              N(2, q) = N(2, q) + w * eg;
              N(3, q) = N(3, q) + w * eb;
              N(4, q) = fminf(N(4, q) + w * ea, 1.0f);
            }
          }
          dirty = true;
        }
      }
    }
  }

  const long long plane = (long long)n_tiles * P;
  float* px = out + (long long)tile * P + tid;
  if (o.composite) {
    // Only nodes with alpha: an empty node (or one of alpha 0) adds exactly
    // +-0 to the sums and multiplies T by exactly 1.
    const float dmin_c = sh.dmin, dmax_c = sh.dmax, cue = sh.cue;
    float T = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      if (q < K && N(4, q) != 0.0f) {
        const float aN = N(4, q);
        const float inv_a = aN > 1e-6f ? 1.0f / fmaxf(aN, 1e-6f) : 0.0f;
        const float attr = N(1, q) * inv_a;
        const float cos1 = fmaxf(N(2, q) * inv_a, 1e-20f);
        const float cos2 = fmaxf(N(3, q) * inv_a, 1e-20f);
        const float cosc = diffuse_mix<BANDS>(cos1, cos2);
        const float spec = 0.3f * powf(cos1, 30.0f);
        float rgb[3];
        tf_eval<3>(sh.tf_color, sh.n_color, attr, rgb);
        const float shade = 0.1f + 0.9f * cosc;
        const float vz = zB / fmaxf(zA - N(0, q), 1e-9f);
        float fcue = clamp01((vz - dmin_c) / fmaxf(dmax_c - dmin_c, 1e-6f));
        fcue = fcue * fcue * cue;
        ar = ar + T * (((rgb[0] * shade + spec) * (1.0f - fcue) + 0.5f * fcue) * aN);
        ag = ag + T * (((rgb[1] * shade + spec) * (1.0f - fcue) + 0.5f * fcue) * aN);
        ab = ab + T * (((rgb[2] * shade + spec) * (1.0f - fcue) + 0.5f * fcue) * aN);
        T = T * (1.0f - aN);
      }
    }
    px[0 * plane] = ar + T * params[24];
    px[1 * plane] = ag + T * params[25];
    px[2 * plane] = ab + T * params[26];
    px[3 * plane] = 1.0f - T;
  } else {
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      if (q < K) {
        px[(long long)(0 * K + q) * plane] = N(0, q);
        px[(long long)(1 * K + q) * plane] = N(1, q);
        px[(long long)(2 * K + q) * plane] = N(2, q);
        px[(long long)(3 * K + q) * plane] = N(3, q);
        px[(long long)(4 * K + q) * plane] = N(4, q);
      }
    }
  }
  if (work != nullptr && tid == 0) work[tile] = evaluated;
}

template <int KMAX, int NSM>
static void launch(bool bands, const float* payload, long long ld, const int* tile_start,
                   const int* tile_count, const float* params, const float* tf,
                   const float* peel, float* out, int* work, int n_tiles, int tiles_x,
                   int tile_w, int tile_h, float sx, float sy, const Opts& o, cudaStream_t st) {
  const dim3 grid(n_tiles), block(tile_w * tile_h);
  const size_t bytes = (size_t)(NSM * KMAX + 1) * tile_w * tile_h * sizeof(float);
  if (bands) {
    cudaFuncSetAttribute(mlab_kernel<KMAX, true, NSM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    mlab_kernel<KMAX, true, NSM><<<grid, block, bytes, st>>>(
        payload, ld, tile_start, tile_count, params, tf, peel, out, work, n_tiles, tiles_x,
        tile_w, tile_h, sx, sy, o);
  } else {
    cudaFuncSetAttribute(mlab_kernel<KMAX, false, NSM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    mlab_kernel<KMAX, false, NSM><<<grid, block, bytes, st>>>(
        payload, ld, tile_start, tile_count, params, tf, peel, out, work, n_tiles, tiles_x,
        tile_w, tile_h, sx, sy, o);
  }
}

// Launches one block of tile_w * tile_h threads per tile on `stream`.
// tf: the `tf_static_table` of the color and opacity TFs. peel: optional
// [n_tiles, P] NDC peel depths. out: [4, n_tiles, P] (composite) or
// [5 * K, n_tiles, P] float32. work: optional [n_tiles] int32, the
// candidates each tile evaluated after the chunk exit and block cull.
// deferred: nodes carry shading features, else shaded colors; gather: nodes
// carry (importance, segment id, 0, 1), not premultiplied; bands: diffuse
// exponent 1.0. Returns the cudaGetLastError() code of the launch.
extern "C" int raster_capsule_mlab_launch(
    const float* payload, long long ld, const int* tile_start, const int* tile_count,
    const float* params, const float* tf, const float* peel, float* out, int* work,
    int n_tiles, int tiles_x, int tile_w, int tile_h, float sx, float sy, int K, int chunk,
    int sub, int composite, int no_overflow, int two_sided, int alpha_from_rows,
    int deferred, int gather, int bands, float sat_thr, void* stream) {
  if (K < 1 || K > 32 || chunk > MAX_CHUNK || sub > chunk || sub < 1 ||
      tile_w * tile_h > MAX_THREADS || (composite && !deferred) ||
      (gather && (deferred || composite)))
    return (int)cudaErrorInvalidValue;
  const Opts o{K,         chunk,           sub,      composite, no_overflow,
               two_sided, alpha_from_rows, deferred, gather,    sat_thr};
  if (n_tiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    // The nodes in shared memory beside the staged rows: all five channels
    // where they fit (up to 166 KB: every tile at KMAX 8 and 16, up to 256
    // pixels at KMAX 32), else three (194 KB at 512 pixels), the other two
    // in registers.
    if (K <= 8)
      launch<8, 5>(bands, payload, ld, tile_start, tile_count, params, tf, peel, out, work,
                   n_tiles, tiles_x, tile_w, tile_h, sx, sy, o, st);
    else if (K <= 16)
      launch<16, 5>(bands, payload, ld, tile_start, tile_count, params, tf, peel, out, work,
                    n_tiles, tiles_x, tile_w, tile_h, sx, sy, o, st);
    else if (tile_w * tile_h <= 256)
      launch<32, 5>(bands, payload, ld, tile_start, tile_count, params, tf, peel, out, work,
                    n_tiles, tiles_x, tile_w, tile_h, sx, sy, o, st);
    else
      launch<32, 3>(bands, payload, ld, tile_start, tile_count, params, tf, peel, out, work,
                    n_tiles, tiles_x, tile_w, tile_h, sx, sy, o, st);
  }
  return (int)cudaGetLastError();
}
