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
//  - The visit order is the TPU kernel's: pop from the top, push the wanted
//    internal children in row order, visit a group when ANY ray of the
//    block wants it. The merge and the dedup see fragments in arrival
//    order, so the order is part of the result.
//  - The next group is known before a visit's leaf work: the push depends
//    only on the slab test, whose bound is taken at the visit's start. So
//    right after the push thread 0 starts the copy of the next group's 8
//    rows (their 20 used lanes, 80 bytes each) into the other half of a
//    double buffer with TMA bulk copies that complete on an mbarrier, and
//    the leaf tests and sweeps run while it is in flight (on the tornado
//    the records come from L2, and waiting for the copy right after it
//    starts measured no slower). A visit has one block barrier: the OR of
//    "any ray wants child j" (a warp reduction, one word per warp and
//    buffer half).
//  - Only thread 0 reads and writes the stack; every thread carries the
//    stack pointer (every push decision is block-uniform).
//  - The K nodes (5 channels) live in dynamic shared memory, a row of
//    5 KMAX + 1 (odd) floats per thread; the kernel is templated on KMAX in
//    {8, 16, 32}, the row's size. The registers hold the ray, the 16
//    candidate world depths and the row in work: five blocks per SM
//    without spills (at 64 or 80 registers ptxas spills).
//  - The capsule tests of a leaf row run for every ray of the block; rows
//    that are no leaves are skipped (they yield no candidate). A hit's
//    relative t goes to the thread's row of 16 in shared memory; an
//    extracted window's members (a bit mask, taken in candidate order)
//    read it there and recompute their row's axial terms for the shading.
//    The same operations on the same inputs give the same bits.
//  - Each thread extracts its own tie windows, at most K per visit: a sweep
//    in which a ray has no candidate left is an exact no-op for it. The
//    sweeps run with few lanes of a warp active, so a sweep does as little
//    as the result allows: a row's ray-independent terms (baba, 1/r,
//    1/|ba|) are computed once a visit by 8 threads, the opacity TF is
//    read from shared memory, a lone member skips the divisions by the
//    window's size (x / 1 is x), and the insertion scans and shifts only
//    the filled nodes: empty nodes are a suffix of exact (2, 0, 0, 0, 0),
//    which no comparison, shift or merge changes.
//  - A push past MAX_STACK sets a flag that the wrapper raises on, and ends
//    the block before any copy is started: nothing is written out of bounds
//    or dropped silently.
//
// Precision: --fmad=false and no fast math; IEEE sqrtf and division,
// 1.0f / sqrtf for the reciprocal square roots. Every operation is rounded
// on its own in the plain version's order, so the two agree bit for bit.
//
// Bound on the H100: FP32 ALU (slab tests 8 x ~22 operations per ray and
// visit, ~130 per leaf row and ray) against 640 bytes of group record per
// visit shared by 128 rays; chip_smoke.py computes the least time from the
// run's own visit and sweep counts. What it loses time on is the shared
// stack: every ray of a block walks every group any of them wants, and the
// visit's barrier waits for the warp with the most sweeps, which run with
// few lanes active (the traversal alone is under a third of the time,
// tools/kernel_split.py). Per-warp stacks, a group cache and ordered
// traversal change the visit order and are left to a later change that
// can show the results survive.

#include <cuda_runtime.h>
#include <stdint.h>

#include "capsule_common.cuh"

#define P 128
#define MIN_BLOCKS 5  // resident blocks per SM asked of ptxas: at most 102 registers
#define MAX_STACK 192
#define LANES 20  // used lanes of a child row
#define ROW_BYTES (LANES * 4)
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
#define TF_CAP 256  // opacity TF floats kept in shared memory (52 points)

__device__ __forceinline__ float safe_inv(float c) {
  return fabsf(c) < 1e-12f ? (c >= 0.0f ? 1e12f : -1e12f) : 1.0f / c;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0: the 8 rows of group g into `dst`, completing on `bar`.
__device__ __forceinline__ void fetch_group(float (*dst)[LANES], const float* groups,
                                            int ld_groups, int g, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(8 * ROW_BYTES)
               : "memory");
#pragma unroll
  for (int j = 0; j < 8; ++j)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(dst[j])),
        "l"(groups + ((long long)g * 8 + j) * ld_groups), "r"(ROW_BYTES), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void wait_group(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A leaf row's axial terms against one ray: the re-origin t0 at the closest
// approach to the segment midpoint and what the quadratics and the shading
// take from it.
struct RowAxial {
  float bard, t0, rd, baoa, oaoa;
};

__device__ __forceinline__ RowAxial row_axial(const float* row, float ox, float oy, float oz,
                                              float dnx, float dny, float dnz) {
  const float4 A = *reinterpret_cast<const float4*>(row + 8);   // a, ba.x
  const float4 B = *reinterpret_cast<const float4*>(row + 12);  // ba.y, ba.z, r, baba
  const float bax = A.w, bay = B.x, baz = B.y;
  const float oax = ox - A.x, oay = oy - A.y, oaz = oz - A.z;
  RowAxial x;
  x.bard = bax * dnx + bay * dny + baz * dnz;
  const float rdoa = oax * dnx + oay * dny + oaz * dnz;
  x.t0 = -(rdoa + 0.5f * x.bard);
  const float pax = oax + x.t0 * dnx, pay = oay + x.t0 * dny, paz = oaz + x.t0 * dnz;
  x.baoa = bax * pax + bay * pay + baz * paz;
  x.oaoa = pax * pax + pay * pay + paz * paz;
  x.rd = rdoa + x.t0;
  return x;
}

// The row's capsule test: the relative t of the entry (side 0) and the exit
// (side 1) surface, BIG where there is none.
struct RowHit {
  float t0, tc[2];
};

__device__ __forceinline__ RowHit row_test(const float* row, float ox, float oy, float oz,
                                           float dnx, float dny, float dnz) {
  const RowAxial x = row_axial(row, ox, oy, oz, dnx, dny, dnz);
  const float bard = x.bard, t0 = x.t0, rd = x.rd, baoa = x.baoa, oaoa = x.oaoa;
  const float baba = fmaxf(row[LANE_BABA], 1e-20f);
  const float rr = row[LANE_R] * row[LANE_R];
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
  const bool cap_on = row[LANE_CAPA] > 0.5f;
  RowHit o;
  o.t0 = t0;
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
    o.tc[side] = fminf(okb ? tb : BIG, fminf(oka ? ta : BIG, okc ? tc : BIG));
  }
  return o;
}

template <int KMAX>
__global__ void __launch_bounds__(P, MIN_BLOCKS)
wavefront_kernel(const float* __restrict__ groups, int ld_groups,
                 const float* __restrict__ rays, long long ld_rays,
                 const float* __restrict__ params, const float* __restrict__ tf,
                 float* __restrict__ out, int* __restrict__ stats,
                 int* __restrict__ overflow, int n_blocks, int K, float opacity,
                 int no_overflow) {
  extern __shared__ float s_nodes[];  // [P][5 KMAX + 1]: d, attr, c1, c2, a (KMAX each)
  __shared__ __align__(16) float rec[2][8][LANES];
  __shared__ float s_tc[P][17];  // a thread's relative t of its 16 candidates
  __shared__ float s_row[2][8][3];  // per row: baba, 1/r, 1/|ba| (buffer halves as rec)
  __shared__ float s_tf[TF_CAP];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int stack[MAX_STACK];  // thread 0's alone
  __shared__ unsigned s_want[2][P / 32];
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
  const int n_tf = 1 + 5 * (n_opacity - 1);
  for (int i = tid; i < n_tf && i < TF_CAP; i += P) s_tf[i] = tf_opacity[i];
  if (n_opacity >= 1 && n_tf <= TF_CAP) tf_opacity = s_tf;  // visible after the barrier below

  float* const node = s_nodes + tid * (5 * KMAX + 1);
  float* const tc_row = s_tc[tid];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    node[q] = 2.0f;
    node[KMAX + q] = node[2 * KMAX + q] = node[3 * KMAX + q] = node[4 * KMAX + q] = 0.0f;
  }

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_count[0] = s_count[1] = 0;
    fetch_group(rec[0], groups, ld_groups, 0, &bar[0]);  // the root
  }
  __syncthreads();

  // Visit n reads rec[n & 1], whose copy is the (n >> 1)-th to complete on
  // bar[n & 1].
  int sp = 1, n = 0, leaf_visits = 0, leaf_rows = 0, max_sp = 1;
  int filled = 0;  // non-empty nodes, a prefix
  int my_sweeps = 0, my_members = 0;
  bool failed = false;

  while (sp > 0) {
    --sp;  // pop: the group on top is the one in flight
    const int b = n & 1;
    wait_group(&bar[b], (n >> 1) & 1);
    const float(*r)[LANES] = rec[b];
    if (tid < 8) {  // published by the visit's barrier
      const float baba = fmaxf(r[tid][LANE_BABA], 1e-20f);
      s_row[b][tid][0] = baba;
      s_row[b][tid][1] = 1.0f / fmaxf(r[tid][LANE_R], 1e-12f);
      s_row[b][tid][2] = 1.0f / sqrtf(baba);
    }

    // A full buffer's K-th depth prunes what lies behind it (no_overflow;
    // with the overflow merge every fragment still contributes).
    float tw_bound = tmax_w;
    if (no_overflow) {
      const float dK = node[K - 1];
      const float bnd = dK < 2.0f ? zB / fmaxf(zA - dK, 1e-9f) * len_p : BIG;
      tw_bound = fminf(bnd, tmax_w);
    }

    // Slab test of the 8 child boxes.
    unsigned want = 0u, leaf_mask = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 lo = *reinterpret_cast<const float4*>(&r[j][0]);  // bmin, bmax.x
      const float4 hi = *reinterpret_cast<const float4*>(&r[j][4]);  // bmax.yz, ptr, leaf
      const float t0x = (lo.x - ox) * idx;
      const float t1x = (lo.w - ox) * idx;
      const float t0y = (lo.y - oy) * idy;
      const float t1y = (hi.x - oy) * idy;
      const float t0z = (lo.z - oz) * idz;
      const float t1z = (hi.y - oz) * idz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), 0.0f));
      const float tf_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      if (tf_ >= tn && tn <= tw_bound && valid) want |= 1u << j;
      if (hi.w > 0.5f) leaf_mask |= 1u << j;
    }
    want = __reduce_or_sync(0xffffffffu, want);
    if ((tid & 31) == 0) s_want[b][tid >> 5] = want;
    __syncthreads();  // the visit's one barrier
    unsigned any = 0u;
#pragma unroll
    for (int w = 0; w < P / 32; ++w) any |= s_want[b][w];

    // Push the internal children that any ray still wants, in row order.
    int top = -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ptr = r[j][LANE_PTR];
      if (ptr >= 0.0f && (any >> j & 1u)) {
        if (sp >= MAX_STACK) {
          failed = true;
          break;
        }
        top = (int)ptr;
        if (tid == 0) stack[sp] = top;
        ++sp;
      }
    }
    if (failed) break;  // block-uniform
    max_sp = max(max_sp, sp);
    ++n;
    // The next visit's group in flight during this one's leaf work. Its
    // buffer half was last read in visit n - 2, before this visit's barrier.
    if (tid == 0 && sp > 0)
      fetch_group(rec[n & 1], groups, ld_groups, top >= 0 ? top : stack[sp - 1], &bar[n & 1]);

    if (leaf_mask) {
      ++leaf_visits;
      leaf_rows += __popc(leaf_mask);
      // The 16 candidates: entry surfaces of rows 0-7, then exit surfaces.
      float tw[16];
      int nhit = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tw[j] = tw[8 + j] = BIG;
        if (!(leaf_mask >> j & 1u) || !valid) continue;
        const RowHit hit = row_test(r[j], ox, oy, oz, dnx, dny, dnz);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const float tcand = hit.tc[side];
          if (!(tcand < BIG)) continue;
          const float t = hit.t0 + tcand;
          if (!(t >= tw_lo && t <= fminf(tw_hi, tw_bound))) continue;
          tw[side * 8 + j] = t;
          tc_row[side * 8 + j] = tcand;
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
        unsigned members = 0u;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (tw[i] <= thr) {
            members |= 1u << i;
            tw[i] = BIG;
          }
        }
        float cnt = 0.0f, sr = 0.0f, sg_ = 0.0f, sb = 0.0f, sa = 0.0f;
        while (members) {  // in candidate order
          const int i = __ffs(members) - 1;
          members &= members - 1u;
          const float* row = r[i & 7];
          const float* rc = s_row[b][i & 7];
          const RowAxial x = row_axial(row, ox, oy, oz, dnx, dny, dnz);
          const float bard = x.bard, rd = x.rd, baoa = x.baoa;
          --nhit;
          cnt += 1.0f;
          const float tc = tc_row[i];
          const float baba = rc[0];
          const float y2 = baoa + tc * bard;
          const float uax = clamp01(y2 / baba);
          const float attr = row[LANE_ATTR0] + row[LANE_DATTR] * uax;
          const float inv_r = rc[1];
          const float ndl = -(rd + tc - uax * bard) * inv_r;
          const float tn = rc[2];
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
        my_members += (int)cnt;
        float ca, cr, cg, cb;
        if (cnt == 1.0f) {  // the window's averages: x / 1 is x
          ca = sa;
          cr = sr * ca;
          cg = sg_ * ca;
          cb = sb * ca;
        } else {
          const float nwin = fmaxf(cnt, 1.0f);
          ca = sa / nwin;
          cr = sr / nwin * ca;
          cg = sg_ / nwin * ca;
          cb = sb / nwin * ca;
        }
        const float vz = fmaxf(bt * invlen, 1e-12f);
        const float cdp = zA - zB / vz;

        // Insert at pos = #{d_j <= carry}; a carry within the tie window of
        // an existing node is that node, seen in an earlier visit: dropped.
        const float eps = fabsf(zB) * 1e-6f / vz;
        // The empty nodes (d = 2) count in pos only for a carry at d >= 2,
        // which is then not inserted; no empty node is a duplicate.
        int pos = 0;
        bool dup = false;
        for (int q = 0; q < filled; ++q) {
          const float d = node[q];
          pos += d <= cdp;
          dup = dup || (fabsf(d - cdp) <= eps && d < 2.0f);
        }
        if (cdp >= 2.0f) pos += K - filled;
        if (dup) pos = K;
        float ed = cdp, er = cr, eg = cg, eb = cb, ea = ca;  // evicted
        if (pos < K) {
          ed = node[K - 1];
          er = node[KMAX + K - 1];
          eg = node[2 * KMAX + K - 1];
          eb = node[3 * KMAX + K - 1];
          ea = node[4 * KMAX + K - 1];
          for (int q = min(filled, K - 1); q > pos; --q) {
#pragma unroll
            for (int c = 0; c < 5; ++c) node[c * KMAX + q] = node[c * KMAX + q - 1];
          }
          node[pos] = cdp;
          node[KMAX + pos] = cr;
          node[2 * KMAX + pos] = cg;
          node[3 * KMAX + pos] = cb;
          node[4 * KMAX + pos] = ca;
          filled = min(filled + 1, K);
        }
        if (!no_overflow && !dup && ed < 2.0f) {
          // MLAB overflow: the evicted fragment composites into node K-1
          // under the new node's remaining transmittance.
          float* last = node + K - 1;
          const float w = 1.0f - last[4 * KMAX];
          last[KMAX] = last[KMAX] + w * er;
          last[2 * KMAX] = last[2 * KMAX] + w * eg;
          last[3 * KMAX] = last[3 * KMAX] + w * eb;
          last[4 * KMAX] = fminf(last[4 * KMAX] + w * ea, 1.0f);
        }
      }
    }
  }

  if (failed && tid == 0) atomicExch(overflow, 1);
  const long long plane = (long long)n_blocks * P;
  float* px = out + col;
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    if (q < K) {
#pragma unroll
      for (int c = 0; c < 5; ++c) px[(long long)(c * K + q) * plane] = node[c * KMAX + q];
    }
  }
  if (stats != nullptr) {
    atomicAdd(&s_count[0], my_sweeps);
    atomicAdd(&s_count[1], my_members);
    __syncthreads();
    if (tid == 0) {
      int* s = stats + (long long)blockIdx.x * 6;
      s[0] = n;
      s[1] = leaf_visits;
      s[2] = leaf_rows;
      s[3] = s_count[0];
      s[4] = s_count[1];
      s[5] = max_sp;
    }
  }
}

template <int KMAX>
static size_t node_bytes() {
  return (size_t)P * (5 * KMAX + 1) * sizeof(float);
}

template <int KMAX>
static int launch(const float* groups, int ld_groups, const float* rays, long long ld_rays,
                  const float* params, const float* tf, float* out, int* stats, int* overflow,
                  int n_blocks, int K, float opacity, int no_overflow, cudaStream_t stream) {
  const size_t smem = node_bytes<KMAX>();
  const cudaError_t e = cudaFuncSetAttribute(
      wavefront_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wavefront_kernel<KMAX><<<n_blocks, P, smem, stream>>>(groups, ld_groups, rays, ld_rays,
                                                         params, tf, out, stats, overflow,
                                                         n_blocks, K, opacity, no_overflow);
  return 0;
}

// Launches one block of 128 threads per ray block on `stream`. groups:
// [n_groups * 8, ld_groups] float32, 16-byte aligned with ld_groups a
// multiple of 4 (its rows are copied by TMA); rays: [8, ld_rays] with
// ld_rays >= n_blocks * 128 (padding rays zero); params: (zA, zB); tf: the
// `tf_static_table` holding the opacity TF; out: [5 * K, n_blocks, 128];
// stats: optional [n_blocks, 6] int32 (visits, leaf visits, leaf rows,
// sweeps, window members, deepest stack); overflow: [1] int32, set to 1
// where a stack would pass MAX_STACK. Returns the cudaGetLastError() code of
// the launch.
extern "C" int bvh_wavefront_launch(const float* groups, int ld_groups, const float* rays,
                                    long long ld_rays, const float* params, const float* tf,
                                    float* out, int* stats, int* overflow, int n_blocks,
                                    int K, float opacity, int no_overflow, void* stream) {
  if (K < 1 || K > 32 || ld_groups < LANES || ld_groups % 4 != 0 ||
      ((uintptr_t)groups & 15) != 0 || ld_rays < (long long)n_blocks * P)
    return (int)cudaErrorInvalidValue;
  if (n_blocks > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int e = K <= 8 ? launch<8>(groups, ld_groups, rays, ld_rays, params, tf, out, stats,
                                      overflow, n_blocks, K, opacity, no_overflow, st)
                : K <= 16 ? launch<16>(groups, ld_groups, rays, ld_rays, params, tf, out, stats,
                                        overflow, n_blocks, K, opacity, no_overflow, st)
                          : launch<32>(groups, ld_groups, rays, ld_rays, params, tf, out, stats,
                                        overflow, n_blocks, K, opacity, no_overflow, st);
    if (e) return e;
  }
  return (int)cudaGetLastError();
}

// The KMAX = 8, 16, 32 instances' resources (i = 0, 1, 2): v =
// (registers, local bytes, static shared bytes, resident blocks per SM,
// threads, dynamic shared bytes), `label` its name. Returns a CUDA error
// code, cudaErrorInvalidValue past the last instance.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 2) return (int)cudaErrorInvalidValue;
  const void* f = i == 0 ? (const void*)wavefront_kernel<8>
                : i == 1 ? (const void*)wavefront_kernel<16> : (const void*)wavefront_kernel<32>;
  const size_t smem = i == 0 ? node_bytes<8>() : i == 1 ? node_bytes<16>() : node_bytes<32>();
  cudaFuncAttributes a;
  int e = (int)cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!e) e = (int)cudaFuncGetAttributes(&a, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, P, smem);
  if (e) return e;
  v[0] = a.numRegs;
  v[1] = (int)a.localSizeBytes;
  v[2] = (int)a.sharedSizeBytes;
  v[3] = nb;
  v[4] = P;
  v[5] = (int)smem;
  const char* nm = i == 0 ? "KMAX 8" : i == 1 ? "KMAX 16" : "KMAX 32";
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
