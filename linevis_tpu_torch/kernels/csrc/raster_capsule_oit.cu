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
// Design (one block per tile, one thread per pixel):
//  - The block walks its run in chunks of `chunk` pair columns aligned as
//    the TPU kernel's DMA windows are, staging payload rows 0-22 of the
//    chunk's in-run columns in shared memory (23 x 4 B per candidate, read
//    by every thread as a broadcast). Within a chunk it walks aligned blocks
//    of `sub` candidates: the block grid, and with it the per-block limit
//    of K extracted tie windows, is that of the TPU kernel.
//  - Tile-wide culls as on the TPU: a block max-reduction of each pixel's
//    bound (its K-th node depth where the pixel is blocked, else 2.0) is
//    held against the chunk's and then each block's least bucket-floored
//    depth (payload row 15). The chunk exit ends the run; the block cull
//    skips the block. `work` counts the candidates evaluated after both.
//  - Per thread and block: the candidate hits (world t, relative t, index)
//    in a local array, with the rejection of fragments behind a blocked
//    pixel's K-th node evaluated against the node state at block start;
//    then at most K sweeps, each extracting the nearest tie window, whose
//    color (or shading features) is computed only for the window's members
//    and summed in candidate order. T_K = prod(1 - a_i) is recomputed only
//    after the node state changed (one predicate: `dirty`). The peel test
//    and the no_overflow rejection compare the fragment's NDC depth, formed
//    as the extraction forms node depths, so a layer at the peel depth is
//    neither taken twice nor skipped.
//  - The K nodes (5 channels) live in registers: the kernel is templated
//    on KMAX in {8, 16, 32} with every node loop unrolled over KMAX and
//    guarded by the runtime K <= KMAX, so no node index is dynamic; and on
//    BANDS, the diffuse exponent (capsule_common.cuh:diffuse_mix).
//
// Precision: built without --use_fast_math and with --fmad=false (IEEE
// sqrt, division and powf, never __powf; 1.0f/sqrtf, never rsqrtf). The
// re-origined scalars ba.oa' and oa'.oa' are the explicitly fused operations
// (__fmaf_rn; capsule_common.fma32 in the plain version), as XLA contracts
// them: oa'.oa' is ~1e-3 formed from terms ~2, so its rounding decides the
// hit depth at silhouettes.
//
// Bound on the H100: FP32 ALU. Each (candidate, pixel) evaluation costs
// about 90 float operations (two dot products, the three quadratics and
// roots, acceptance tests, the clip and the rejection), against 92 bytes of
// staged payload shared by the block's threads; each extracted candidate
// adds its shading features (~45 operations; per-fragment shading adds the
// color TF, three powf and the depth cue, ~70 more) and each sweep a scan of
// the block's hits. The least time is those operations over 67 TFLOP/s
// (chip_smoke.py computes it from the run's own counts). Speed work
// (candidate compaction across warps, several tiles per block, cp.async
// staging) is left to later changes.

#include <cuda_runtime.h>

#include "capsule_common.cuh"

#define NROWS 23         // staged payload rows 0-22
#define MAX_CHUNK 256    // staged columns
#define MAX_SUB 64       // block width; two_sided doubles the hit slots
#define MAX_THREADS 512  // pixels per tile
#define ROW_ZQ 15

struct Opts {
  int K, chunk, sub, composite, no_overflow, two_sided, alpha_from_rows, deferred, gather;
  float sat_thr;  // float32(1 - sat)
};

template <int KMAX, bool BANDS>
__global__ void __launch_bounds__(MAX_THREADS)
mlab_kernel(const float* __restrict__ payload, long long ld,
            const int* __restrict__ tile_start, const int* __restrict__ tile_count,
            const float* __restrict__ params, const float* __restrict__ tf,
            const float* __restrict__ peel, float* __restrict__ out,
            int* __restrict__ work, int n_tiles, int tiles_x,
            int tile_w, int tile_h, float sx, float sy, Opts o) {
  __shared__ float s[NROWS][MAX_CHUNK];
  __shared__ float s_red[2][MAX_THREADS / 32];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = P >> 5;
  const int K = o.K;

  const PixelRay ray = pixel_ray(params, tile, tid, tiles_x, tile_w, tile_h, sx, sy);
  const float dnx = ray.dnx, dny = ray.dny, dnz = ray.dnz, invlen = ray.invlen;
  const float len_p = 1.0f / invlen;
  const float zA = params[9], zB = params[10];
  const float tw_lo = (zB / zA) * len_p;
  const float tw_hi = (zB / (zA - 1.0f)) * len_p;
  const Shading sh = shading_of(params, tf, o.alpha_from_rows);
  const float peel_d = peel != nullptr ? peel[(long long)tile * P + tid] : 0.0f;

  float nd[KMAX], nr[KMAX], ng[KMAX], nb[KMAX], na[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    nd[q] = 2.0f;
    nr[q] = ng[q] = nb[q] = na[q] = 0.0f;
  }

  // Candidate hits of the current block: world t, relative t, and the
  // staged column (+ MAX_CHUNK for an exit surface), entry surfaces first.
  float h_tw[2 * MAX_SUB], h_tc[2 * MAX_SUB];
  int h_j[2 * MAX_SUB];

  bool dirty = true, blocked = false;
  float dK = 2.0f;
  int red = 0;  // s_red buffer of the next reduction
  auto tile_bound = [&]() -> float {
    // The pixel's bound for the tile-wide culls, max-reduced over the tile.
    if (dirty) {
      dK = 2.0f;
#pragma unroll
      for (int q = 0; q < KMAX; ++q)
        if (q == K - 1) dK = nd[q];
      if (o.no_overflow) {
        blocked = dK < 2.0f;
      } else {
        // T_K = prod(1 - a_i) as the TPU kernel's halving tree.
        float x[KMAX];
#pragma unroll
        for (int q = 0; q < KMAX; ++q) x[q] = 1.0f - na[q];
        for (int n = K; n > 1;) {
          const int h = n >> 1;
          for (int i = 0; i < h; ++i) x[i] = x[i] * x[h + i];
          if (n & 1) x[0] = x[0] * x[n - 1];
          n = h;
        }
        blocked = x[0] <= o.sat_thr;
      }
      dirty = false;
    }
    const float m = warp_max(blocked ? dK : 2.0f);
    if (lane == 0) s_red[red][warp] = m;
    __syncthreads();
    float zk = s_red[red][0];
    for (int w = 1; w < nwarps; ++w) zk = fmaxf(zk, s_red[red][w]);
    red ^= 1;
    return zk;
  };

  const int start = tile_start[tile];
  const int end = start + tile_count[tile];
  const int C = o.chunk, sub = o.sub;
  int evaluated = 0;
  for (int c0 = (start / C) * C; c0 < end; c0 += C) {
    const int lo = max(c0, start), hi = min(c0 + C, end);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < NROWS * C; i += P) {
      const int r = i / C, j = i - r * C;
      if (c0 + j >= lo && c0 + j < hi) s[r][j] = payload[(long long)r * ld + c0 + j];
    }
    float zk = tile_bound();  // synchronises: the staged rows are visible
    // Chunk exit: the chunk lies behind every pixel's bound, and so does
    // the rest of the depth-ordered run.
    float zmin = 3.0f;
    for (int j = lo - c0 + lane; j < hi - c0; j += 32) zmin = fminf(zmin, s[ROW_ZQ][j]);
    if (warp_min(zmin) > zk) break;

    bool first = true;
    for (int b0 = (lo / sub) * sub; b0 < hi; b0 += sub) {
      const int jlo = max(b0, lo) - c0, jhi = min(b0 + sub, hi) - c0;
      if (!first) zk = tile_bound();
      first = false;
      float bz = 3.0f;
      for (int j = jlo + lane; j < jhi; j += 32) bz = fminf(bz, s[ROW_ZQ][j]);
      if (warp_min(bz) > zk) continue;  // block cull
      evaluated += jhi - jlo;

      // Candidates: hits, clipped to the NDC depth range and rejected
      // behind a blocked pixel's K-th node (state at block start).
      const float t_rej = zB / fmaxf(zA - dK, 1e-9f) * len_p;
      int nf = 0, nbk = 0;
      for (int j = jlo; j < jhi; ++j) {
        const Cand cd = cand_setup(s, j, dnx, dny, dnz);
        const Quad q = cand_quad(s, j, cd);
        const bool cap_a_on = s[13][j] > 0.5f;
        for (int side = 0; side <= o.two_sided; ++side) {
          const float tc = surface_t(q, cd, s[10][j], cap_a_on, side == 0);
          if (!(tc < BIG)) continue;
          const float tw = cd.t0 + tc;
          if (!(tw >= tw_lo && tw <= tw_hi)) continue;
          const bool by_znd = peel != nullptr || (blocked && o.no_overflow);
          const float znd = by_znd ? zA - zB / fmaxf(tw * invlen, 1e-12f) : 0.0f;
          if (peel != nullptr && !(znd > peel_d)) continue;  // peeled already
          if (blocked) {
            if (o.no_overflow) {
              if (znd >= dK) continue;
            } else if (tw >= t_rej) {
              continue;
            }
          }
          const int slot = side == 0 ? nf++ : MAX_SUB + nbk++;
          h_tw[slot] = tw;
          h_tc[slot] = tc;
          h_j[slot] = j;
        }
      }

      // At most K sweeps: the nearest tie window each.
      for (int sw = 0; sw < K; ++sw) {
        float bt = BIG;
        for (int i = 0; i < nf; ++i) bt = fminf(bt, h_tw[i]);
        for (int i = MAX_SUB; i < MAX_SUB + nbk; ++i) bt = fminf(bt, h_tw[i]);
        if (!(bt < BIG)) break;
        const float thr = bt + fabsf(bt) * 1e-6f;
        float n = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f, sa = 0.0f;
        for (int pass = 0; pass < 2; ++pass) {
          const int i0 = pass == 0 ? 0 : MAX_SUB;
          const int i1 = pass == 0 ? nf : MAX_SUB + nbk;
          for (int i = i0; i < i1; ++i) {
            const float tw = h_tw[i];
            if (!(tw <= thr)) continue;
            h_tw[i] = BIG;
            n += 1.0f;
            // The member's color, its shading features (deferred), or its
            // importance and segment id (gather).
            const int j = h_j[i];
            const Cand cd = cand_setup(s, j, dnx, dny, dnz);
            const float4 f = o.gather ? gather_fragment(s, j, cd, h_tc[i])
                                      : cand_fragment<BANDS>(s, j, cd, h_tc[i], tw, invlen, sh,
                                                      o.deferred);
            sr = sr + f.x;
            sg = sg + f.y;
            sb = sb + f.z;
            sa = sa + f.w;
          }
        }
        const float nwin = fmaxf(n, 1.0f);
        const float ca = sa / nwin;
        const float cdp = zA - zB / fmaxf(bt * invlen, 1e-12f);
        // The carry: the window's averages, premultiplied except in gather.
        float cr = sr / nwin, cg = sg / nwin, cb = sb / nwin;
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
            pos += nd[q] <= cdp;
            dup = dup || (fabsf(nd[q] - cdp) <= eps && nd[q] < 2.0f);
          }
        }
        if (dup) pos = K;
        float ed = cdp, er = cr, eg = cg, eb = cb, ea = ca;  // evicted
        if (pos < K) {
#pragma unroll
          for (int q = 0; q < KMAX; ++q) {
            if (q == K - 1) {
              ed = nd[q]; er = nr[q]; eg = ng[q]; eb = nb[q]; ea = na[q];
            }
          }
#pragma unroll
          for (int q = KMAX - 1; q >= 0; --q) {
            if (q < K && q >= pos) {
              if (q == pos) {
                nd[q] = cdp; nr[q] = cr; ng[q] = cg; nb[q] = cb; na[q] = ca;
              } else {
                nd[q] = nd[q - 1]; nr[q] = nr[q - 1]; ng[q] = ng[q - 1];
                nb[q] = nb[q - 1]; na[q] = na[q - 1];
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
              const float w = 1.0f - na[q];
              nr[q] = nr[q] + w * er;
              ng[q] = ng[q] + w * eg;
              nb[q] = nb[q] + w * eb;
              na[q] = fminf(na[q] + w * ea, 1.0f);
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
    const float dmin = sh.dmin, dmax = sh.dmax, cue = sh.cue;
    float T = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      if (q < K) {
        const float aN = na[q];
        const float inv_a = aN > 1e-6f ? 1.0f / fmaxf(aN, 1e-6f) : 0.0f;
        const float attr = nr[q] * inv_a;
        const float cos1 = fmaxf(ng[q] * inv_a, 1e-20f);
        const float cos2 = fmaxf(nb[q] * inv_a, 1e-20f);
        const float cosc = diffuse_mix<BANDS>(cos1, cos2);
        const float spec = 0.3f * powf(cos1, 30.0f);
        float rgb[3];
        tf_eval<3>(sh.tf_color, sh.n_color, attr, rgb);
        const float shade = 0.1f + 0.9f * cosc;
        const float vz = zB / fmaxf(zA - nd[q], 1e-9f);
        float fcue = clamp01((vz - dmin) / fmaxf(dmax - dmin, 1e-6f));
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
        px[(long long)(0 * K + q) * plane] = nd[q];
        px[(long long)(1 * K + q) * plane] = nr[q];
        px[(long long)(2 * K + q) * plane] = ng[q];
        px[(long long)(3 * K + q) * plane] = nb[q];
        px[(long long)(4 * K + q) * plane] = na[q];
      }
    }
  }
  if (work != nullptr && tid == 0) work[tile] = evaluated;
}

template <int KMAX>
static void launch(bool bands, const float* payload, long long ld, const int* tile_start,
                   const int* tile_count, const float* params, const float* tf,
                   const float* peel, float* out, int* work, int n_tiles, int tiles_x,
                   int tile_w, int tile_h, float sx, float sy, const Opts& o, cudaStream_t st) {
  const dim3 grid(n_tiles), block(tile_w * tile_h);
  if (bands)
    mlab_kernel<KMAX, true><<<grid, block, 0, st>>>(payload, ld, tile_start, tile_count,
                                                    params, tf, peel, out, work, n_tiles,
                                                    tiles_x, tile_w, tile_h, sx, sy, o);
  else
    mlab_kernel<KMAX, false><<<grid, block, 0, st>>>(payload, ld, tile_start, tile_count,
                                                     params, tf, peel, out, work, n_tiles,
                                                     tiles_x, tile_w, tile_h, sx, sy, o);
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
  if (K < 1 || K > 32 || chunk > MAX_CHUNK || sub > MAX_SUB || sub < 1 ||
      tile_w * tile_h > MAX_THREADS || (composite && !deferred) ||
      (gather && (deferred || composite)))
    return (int)cudaErrorInvalidValue;
  const Opts o{K,         chunk,           sub,      composite, no_overflow,
               two_sided, alpha_from_rows, deferred, gather,    sat_thr};
  if (n_tiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (K <= 8)
      launch<8>(bands, payload, ld, tile_start, tile_count, params, tf, peel, out, work,
                n_tiles, tiles_x, tile_w, tile_h, sx, sy, o, st);
    else if (K <= 16)
      launch<16>(bands, payload, ld, tile_start, tile_count, params, tf, peel, out, work,
                 n_tiles, tiles_x, tile_w, tile_h, sx, sy, o, st);
    else
      launch<32>(bands, payload, ld, tile_start, tile_count, params, tf, peel, out, work,
                 n_tiles, tiles_x, tile_w, tile_h, sx, sy, o, st);
  }
  return (int)cudaGetLastError();
}
