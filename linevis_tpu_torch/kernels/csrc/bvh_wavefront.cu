// Wavefront traversal of the 8-wide capsule BVH with a per-ray K-nearest
// node buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wavefront_kernel` in
// linevis_tpu/kernels/bvh_wavefront.py:70 (wrapper
// `trace_wavefront_kbuffer`, :426). Per block of 128 rays one shared LIFO
// stack over the packed 8-wide BVH (ops/wide_bvh.py); per visit 8 slab
// tests and, in leaf rows, 8 capsule tests giving 16 entry/exit candidates;
// tie windows (1e-6 relative) extracted nearest first into the ray's K-node
// buffer with cross-visit dedup, MLAB overflow merge or `no_overflow` with
// K-th-depth pruning; nodes carry premultiplied deferred-shading features
// (attr, cos1, cos2) and alpha. The plain PyTorch version it is held
// against is `trace_wavefront_kbuffer_reference` (kernels/bvh_wavefront.py);
// the semantics are listed in that module's docstring.
//
// Design (one block of 128 threads per ray block, one thread per ray):
//  - The stack (MAX_STACK ints) and the visited group's 8 x 20 used lanes
//    live in shared memory; thread 0 pushes, all threads carry the stack
//    pointer in a register (every push decision is block-uniform). The
//    visit order is the TPU kernel's: pop from the top, push the wanted
//    internal children in row order, visit a group when ANY ray of the
//    block wants it. The merge and the dedup see fragments in arrival
//    order, so the order is part of the result.
//  - "Any ray wants child j" is one 8-bit mask per thread, OR-reduced in
//    the warp (`__reduce_or_sync`) and across warps by a shared atomicOr.
//  - The capsule tests of a leaf row run for every ray of the block; rows
//    that are no leaves are skipped (they yield no candidate).
//  - Each thread extracts its own tie windows, at most K per visit: a sweep
//    in which a ray has no candidate left is an exact no-op for it, so no
//    block-wide sweep count is needed. Shading features are computed only
//    for the members of an extracted window, summed in candidate order.
//  - The K nodes (5 channels) live in registers: the kernel is templated on
//    KMAX in {8, 16, 32} with every node loop unrolled and guarded by the
//    runtime K; the 16 candidate depths are a local array.
//  - A push past MAX_STACK sets a flag that the wrapper raises on, and ends
//    the block: nothing is written out of bounds or dropped silently.
//
// Precision: --fmad=false and no fast math; IEEE sqrtf and division,
// 1.0f / sqrtf for the reciprocal square roots. Every operation is rounded
// on its own in the plain version's order, so the two agree bit for bit.
//
// Bound on the H100: FP32 ALU (slab tests 8 x ~22 operations per ray and
// visit, ~130 per leaf row and ray) against 640 bytes of group record per
// visit shared by 128 rays; chip_smoke.py computes the least time from the
// run's own visit and sweep counts. What it loses time on is the shared
// stack: every ray of a block walks every group any of them wants. Per-warp
// stacks, a group cache and ordered traversal change the visit order and
// are left to a later change that can show the results survive.

#include <cuda_runtime.h>

#include "capsule_common.cuh"

#define P 128
#define MAX_STACK 192
#define LANES 20  // used lanes of a child row
#define LANE_BMIN 0
#define LANE_BMAX 3
#define LANE_PTR 6
#define LANE_LEAF 7
#define LANE_A 8
#define LANE_BA 11
#define LANE_R 14
#define LANE_BABA 15
#define LANE_ATTR0 16
#define LANE_DATTR 17
#define LANE_CAPA 18

__device__ __forceinline__ float safe_inv(float c) {
  return fabsf(c) < 1e-12f ? (c >= 0.0f ? 1e12f : -1e12f) : 1.0f / c;
}

template <int KMAX>
__global__ void __launch_bounds__(P)
wavefront_kernel(const float* __restrict__ groups, int ld_groups,
                 const float* __restrict__ rays, long long ld_rays,
                 const float* __restrict__ params, const float* __restrict__ tf,
                 float* __restrict__ out, int* __restrict__ stats,
                 int* __restrict__ overflow, int n_blocks, int K, float opacity,
                 int no_overflow) {
  __shared__ int stack[MAX_STACK];
  __shared__ float rec[8][LANES];
  __shared__ unsigned s_any;
  __shared__ int s_count[2];  // sweeps, members

  const int tid = threadIdx.x;
  const long long col = (long long)blockIdx.x * P + tid;
  const float ox = rays[0 * ld_rays + col], oy = rays[1 * ld_rays + col],
              oz = rays[2 * ld_rays + col];
  const float dx = rays[3 * ld_rays + col], dy = rays[4 * ld_rays + col],
              dz = rays[5 * ld_rays + col];
  const float tmax_w = rays[6 * ld_rays + col];
  const bool valid = rays[7 * ld_rays + col] > 0.5f;
  const float invlen = 1.0f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
  const float dnx = dx * invlen, dny = dy * invlen, dnz = dz * invlen;
  const float idx = safe_inv(dnx), idy = safe_inv(dny), idz = safe_inv(dnz);
  const float len_p = 1.0f / invlen;
  const float zA = params[0], zB = params[1];
  // The NDC clip volume as bounds on the world t of a hit.
  const float tw_lo = (zB / zA) * len_p;
  const float tw_hi = (zB / (zA - 1.0f)) * len_p;
  const int n_opacity = (int)tf[1];
  const float* tf_opacity = tf + 2 + 3 + ((int)tf[0] - 1) * 9;

  float nd[KMAX], nr[KMAX], ng[KMAX], nb[KMAX], na[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    nd[q] = 2.0f;
    nr[q] = ng[q] = nb[q] = na[q] = 0.0f;
  }

  if (tid == 0) {
    stack[0] = 0;
    s_count[0] = s_count[1] = 0;
  }
  int sp = 1, visits = 0, leaf_visits = 0, leaf_rows = 0, max_sp = 1;
  int my_sweeps = 0, my_members = 0;
  bool failed = false;

  while (sp > 0) {
    __syncthreads();  // pushes are visible; the last visit's reads are done
    const int g = stack[--sp];
    for (int i = tid; i < 8 * LANES; i += P)
      rec[i / LANES][i % LANES] = groups[((long long)g * 8 + i / LANES) * ld_groups + i % LANES];
    if (tid == 0) s_any = 0u;
    __syncthreads();
    ++visits;

    // A full buffer's K-th depth prunes what lies behind it (no_overflow;
    // with the overflow merge every fragment still contributes).
    float tw_bound = tmax_w;
    if (no_overflow) {
      float dK = 2.0f;
#pragma unroll
      for (int q = 0; q < KMAX; ++q)
        if (q == K - 1) dK = nd[q];
      const float b = dK < 2.0f ? zB / fmaxf(zA - dK, 1e-9f) * len_p : BIG;
      tw_bound = fminf(b, tmax_w);
    }

    // Slab test of the 8 child boxes.
    unsigned want = 0u;
    bool has_leaf = false;
    int rows_leaf = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t0x = (rec[j][LANE_BMIN + 0] - ox) * idx;
      const float t1x = (rec[j][LANE_BMAX + 0] - ox) * idx;
      const float t0y = (rec[j][LANE_BMIN + 1] - oy) * idy;
      const float t1y = (rec[j][LANE_BMAX + 1] - oy) * idy;
      const float t0z = (rec[j][LANE_BMIN + 2] - oz) * idz;
      const float t1z = (rec[j][LANE_BMAX + 2] - oz) * idz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), 0.0f));
      const float tf_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      if (tf_ >= tn && tn <= tw_bound && valid) want |= 1u << j;
      if (rec[j][LANE_LEAF] > 0.5f) {
        has_leaf = true;
        ++rows_leaf;
      }
    }
    want = __reduce_or_sync(0xffffffffu, want);
    if ((tid & 31) == 0 && want) atomicOr(&s_any, want);
    __syncthreads();
    const unsigned any = s_any;

    if (has_leaf) {
      ++leaf_visits;
      leaf_rows += rows_leaf;
      // The 16 candidates: entry surfaces of rows 0-7, then exit surfaces.
      float tw[16], tcd[16], c_bard[8], c_rd[8], c_baoa[8];
      int nhit = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tw[j] = tw[8 + j] = BIG;
        tcd[j] = tcd[8 + j] = BIG;
        c_bard[j] = c_rd[j] = c_baoa[j] = 0.0f;
        if (!(rec[j][LANE_LEAF] > 0.5f) || !valid) continue;
        const float bax = rec[j][LANE_BA + 0], bay = rec[j][LANE_BA + 1],
                    baz = rec[j][LANE_BA + 2];
        const float oax = ox - rec[j][LANE_A + 0], oay = oy - rec[j][LANE_A + 1],
                    oaz = oz - rec[j][LANE_A + 2];
        const float bard = bax * dnx + bay * dny + baz * dnz;
        const float rdoa = oax * dnx + oay * dny + oaz * dnz;
        const float baba = fmaxf(rec[j][LANE_BABA], 1e-20f);
        const float rr = rec[j][LANE_R] * rec[j][LANE_R];
        // Re-origin at the closest approach to the segment midpoint.
        const float t0 = -(rdoa + 0.5f * bard);
        const float pax = oax + t0 * dnx, pay = oay + t0 * dny, paz = oaz + t0 * dnz;
        const float baoa = bax * pax + bay * pay + baz * paz;
        const float oaoa = pax * pax + pay * pay + paz * paz;
        const float rd = rdoa + t0;
        const float k2 = fmaxf(baba - bard * bard, 1e-20f);
        const float k1 = baba * rd - baoa * bard;
        const float k0 = baba * oaoa - baoa * baoa - rr * baba;
        const float h = k1 * k1 - k2 * k0;
        const float sq = sqrtf(fmaxf(h, 0.0f));
        const float ha = rd * rd - (oaoa - rr);
        const float sqa = sqrtf(fmaxf(ha, 0.0f));
        const float b1b = rd - bard;
        const float obob = oaoa - 2.0f * baoa + baba;
        const float hb = b1b * b1b - (obob - rr);
        const float sqb = sqrtf(fmaxf(hb, 0.0f));
        const bool cap_on = rec[j][LANE_CAPA] > 0.5f;
        c_bard[j] = bard;
        c_rd[j] = rd;
        c_baoa[j] = baoa;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const float sg = side == 0 ? -1.0f : 1.0f;
          const float tb = (-k1 + sg * sq) / k2;
          const float ta = -rd + sg * sqa;
          const float tc = -b1b + sg * sqb;
          const float yb = baoa + tb * bard, ya = baoa + ta * bard, yc = baoa + tc * bard;
          const bool okb = h >= 0.0f && yb > 0.0f && yb < baba && t0 + tb > 0.0f;
          const bool oka = ha >= 0.0f && ya <= 0.0f && cap_on && t0 + ta > 0.0f;
          const bool okc = hb >= 0.0f && yc >= baba && t0 + tc > 0.0f;
          const float tcand = fminf(okb ? tb : BIG, fminf(oka ? ta : BIG, okc ? tc : BIG));
          if (!(tcand < BIG)) continue;
          const float t = t0 + tcand;
          if (!(t >= tw_lo && t <= fminf(tw_hi, tw_bound))) continue;
          tw[side * 8 + j] = t;
          tcd[side * 8 + j] = tcand;
          ++nhit;
        }
      }

      // At most K sweeps: the nearest tie window each.
      for (int sw = 0; sw < K && nhit > 0; ++sw) {
        float bt = BIG;
#pragma unroll
        for (int i = 0; i < 16; ++i) bt = fminf(bt, tw[i]);
        if (!(bt < BIG)) break;
        const float thr = bt + fabsf(bt) * 1e-6f;
        float n = 0.0f, sr = 0.0f, sg_ = 0.0f, sb = 0.0f, sa = 0.0f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (!(tw[i] <= thr)) continue;
          tw[i] = BIG;
          --nhit;
          n += 1.0f;
          const int j = i & 7;
          const float tc = tcd[i];
          const float bard = c_bard[j], rd = c_rd[j], baoa = c_baoa[j];
          const float baba = fmaxf(rec[j][LANE_BABA], 1e-20f);
          const float y2 = baoa + tc * bard;
          const float uax = clamp01(y2 / baba);
          const float attr = rec[j][LANE_ATTR0] + rec[j][LANE_DATTR] * uax;
          const float inv_r = 1.0f / fmaxf(rec[j][LANE_R], 1e-12f);
          const float ndl = -(rd + tc - uax * bard) * inv_r;
          const float tn = 1.0f / sqrtf(baba);
          const float tdl = -bard * tn;
          const float ndt = (y2 - uax * baba) * tn * inv_r;
          const float denom = 1.0f / sqrtf(fmaxf(1.0f - tdl * tdl, 1e-6f));
          const float cos1 = clamp01(fabsf(ndl));
          const float cos2 = clamp01(fabsf(ndl - tdl * ndt) * denom);
          float al;
          tf_eval<1>(tf_opacity, n_opacity, attr, &al);
          sr = sr + attr;
          sg_ = sg_ + cos1;
          sb = sb + cos2;
          sa = sa + al * opacity;
        }
        ++my_sweeps;
        my_members += (int)n;
        const float nwin = fmaxf(n, 1.0f);
        const float ca = sa / nwin;
        const float vz = fmaxf(bt * invlen, 1e-12f);
        const float cdp = zA - zB / vz;
        const float cr = sr / nwin * ca, cg = sg_ / nwin * ca, cb = sb / nwin * ca;

        // Insert at pos = #{d_j <= carry}; a carry within the tie window of
        // an existing node is that node, seen in an earlier visit: dropped.
        const float eps = fabsf(zB) * 1e-6f / vz;
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
        }
        if (!no_overflow && !dup && ed < 2.0f) {
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
        }
      }
    }

    // Push the internal children that any ray still wants, in row order.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ptr = rec[j][LANE_PTR];
      if (ptr >= 0.0f && (any >> j & 1u)) {
        if (sp >= MAX_STACK) {
          failed = true;
          break;
        }
        if (tid == 0) stack[sp] = (int)ptr;
        ++sp;
      }
    }
    if (failed) break;  // block-uniform
    max_sp = max(max_sp, sp);
  }

  if (failed && tid == 0) atomicExch(overflow, 1);
  const long long plane = (long long)n_blocks * P;
  float* px = out + col;
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
  if (stats != nullptr) {
    atomicAdd(&s_count[0], my_sweeps);
    atomicAdd(&s_count[1], my_members);
    __syncthreads();
    if (tid == 0) {
      int* s = stats + (long long)blockIdx.x * 6;
      s[0] = visits;
      s[1] = leaf_visits;
      s[2] = leaf_rows;
      s[3] = s_count[0];
      s[4] = s_count[1];
      s[5] = max_sp;
    }
  }
}

// Launches one block of 128 threads per ray block on `stream`. groups:
// [n_groups * 8, ld_groups] float32; rays: [8, ld_rays] with ld_rays >=
// n_blocks * 128 (padding rays zero); params: (zA, zB); tf: the
// `tf_static_table` holding the opacity TF; out: [5 * K, n_blocks, 128];
// stats: optional [n_blocks, 6] int32 (visits, leaf visits, leaf rows,
// sweeps, window members, deepest stack); overflow: [1] int32, set to 1
// where a stack would pass MAX_STACK. Returns the cudaGetLastError() code of
// the launch.
extern "C" int bvh_wavefront_launch(const float* groups, int ld_groups, const float* rays,
                                    long long ld_rays, const float* params, const float* tf,
                                    float* out, int* stats, int* overflow, int n_blocks,
                                    int K, float opacity, int no_overflow, void* stream) {
  if (K < 1 || K > 32 || ld_groups < LANES || ld_rays < (long long)n_blocks * P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_blocks > 0) {
    const dim3 grid(n_blocks), block(P);
    if (K <= 8)
      wavefront_kernel<8><<<grid, block, 0, st>>>(groups, ld_groups, rays, ld_rays, params,
                                                 tf, out, stats, overflow, n_blocks, K,
                                                 opacity, no_overflow);
    else if (K <= 16)
      wavefront_kernel<16><<<grid, block, 0, st>>>(groups, ld_groups, rays, ld_rays, params,
                                                  tf, out, stats, overflow, n_blocks, K,
                                                  opacity, no_overflow);
    else
      wavefront_kernel<32><<<grid, block, 0, st>>>(groups, ld_groups, rays, ld_rays, params,
                                                  tf, out, stats, overflow, n_blocks, K,
                                                  opacity, no_overflow);
  }
  return (int)cudaGetLastError();
}
