// Multi-layer alpha tracing (MLAT) over the binary BVH, for Hopper (sm_90a):
// one traversal per ray inserting every capsule surface it reaches into K
// depth-sorted nodes.
//
// Replaces no Pallas kernel: the JAX package writes this traversal as the
// vmapped `lax.while_loop` of linevis_tpu/render/ray_tracer.py:441-533
// (`render_tubes_mlat`, the reference's any-hit path with MlatInsert.glsl).
// The plain PyTorch version it is held against is `mlat_nodes_reference`
// (kernels/bvh_mlat.py); the front-to-back resolve stays in PyTorch.
//
// Per ray, in the plain version's order: pop a node (an internal node pushes
// its left child, then its right, so the right is visited first); cull a
// box that lies behind node K-1 while the buffer is saturated (alpha of
// node K-1 > 0.999); at a leaf take the capsule's entry and then its exit
// surface (t > 0, inside the NDC depth range [0, 1]), compute its
// deferred-shading features and insert it into the K registers by depth;
// a fragment pushed out of node K-1 merges into node K-1 under its
// remaining transmittance (MLAB). The merge sees fragments in arrival
// order, so the visit order is part of the function.
//
// Design: blocks of 128 rays (a 16x8 screen tile), each warp walking the
// tree together (`bvh_capsule.cuh:bvh_warp_walk`: one stack of (node, lane
// mask) in shared memory, one 64-byte record load per accepted node for the
// warp, both children's boxes tested there and each lane's cull applied at
// the child's turn, so every lane keeps its own walk's order and its own
// culls). The K nodes
// (depth, three premultiplied features, alpha) sit in arrays indexed only by
// unrolled loops at constant positions, so that they stay in registers
// (KMAX 8, 16, 32 instances; the K actually kept is a runtime argument):
// node j at index j + KMAX - K, so that node K-1, which the cull reads at
// every pop and the merge writes, is always at KMAX - 1. What bounds it:
// the warp's walk (the union of its lanes' walks) and the K-step insertion
// per surface. Every binary node is tested (no levels skipped).
//
// Precision: --fmad=false and no fast math; IEEE sqrtf and division,
// 1.0f / sqrtf where the JAX package takes `lax.rsqrt`. Every operation is
// rounded on its own in the plain version's order, so the two agree bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh_capsule.cuh"
#include "capsule_common.cuh"

namespace {

constexpr int P = 128;  // rays per block
constexpr int WARPS = P / 32;
constexpr int STACK = 64;  // most node ids a ray's stack holds

struct Frame {
  float zA, zB, opacity;
  const float* tf;  // `tf_static_table`: [n_color, n_opacity, color group, opacity group]
};

// As many registers as the nodes need (KMAX 8: 96, 5 resident blocks an
// SM). A cap of 64 (8 blocks) spills the nodes: 3.6x the time at K=8 on
// an H100 (`tools/kernel_split.py` variant `min_blocks_8`).
template <int KMAX>
__global__ void __launch_bounds__(P)
mlat_kernel(BvhNodes tr, BvhCaps caps, Frame fr, const float* __restrict__ origins,
            const float* __restrict__ dirs, const float* __restrict__ wz_in,
            const unsigned char* __restrict__ done, int R, int K, int max_stack, int cap,
            float* __restrict__ out, int* __restrict__ stats, int* __restrict__ warp_visits,
            int* __restrict__ overflow) {
  extern __shared__ int4 smem[];
  const WalkStack stk = walk_stack(smem, WARPS, threadIdx.x >> 5, cap);
  const int r = blockIdx.x * P + threadIdx.x;
  const bool live = r < R && !done[r];
  const int n_opacity = (int)fr.tf[1];
  const float* tf_opacity = fr.tf + 2 + 3 + ((int)fr.tf[0] - 1) * 9;
  // Node j of the K kept at index j + k0: node K-1 at KMAX - 1 for every K.
  const int k0 = KMAX - K;
  float nd[KMAX], f0[KMAX], f1[KMAX], f2[KMAX], na[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    nd[j] = INFINITY;
    f0[j] = 0.0f;
    f1[j] = 0.0f;
    f2[j] = 0.0f;
    na[j] = 0.0f;
  }
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, wz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  if (live) {
    ox = origins[3 * r];
    oy = origins[3 * r + 1];
    oz = origins[3 * r + 2];
    dx = dirs[3 * r];
    dy = dirs[3 * r + 1];
    dz = dirs[3 * r + 2];
    wz = wz_in[r];
    ix = bvh_safe_inv(dx);
    iy = bvh_safe_inv(dy);
    iz = bvh_safe_inv(dz);
  }
  int inserts = 0;
  WalkCounts cnt{0, 0, 0};
  bvh_warp_walk(
      tr, stk, max_stack, live, ox, oy, oz, ix, iy, iz,
      [](float tn, float tf) { return tf >= fmaxf(tn, 0.0f); },
      [&](float tn) { return (tn <= nd[KMAX - 1]) || !(na[KMAX - 1] > 0.999f); },
      [&](int prim) {
        float t_in, t_out;
        bvh_capsule_surfaces(caps, prim, ox, oy, oz, dx, dy, dz,
                             [](float tp) { return tp > 0.0f; }, t_in, t_out);
#pragma unroll 1
        for (int s = 0; s < 2; ++s) {
          const float tc = s == 0 ? t_in : t_out;
          if (!isfinite(tc)) continue;
          const float vz = tc * wz;
          const float znd = fr.zA - fr.zB / fmaxf(vz, 1e-12f);
          if (!(znd >= 0.0f && znd <= 1.0f)) continue;
          ++inserts;
          const BvhFeat ft = bvh_capsule_features(caps, prim, ox, oy, oz, dx, dy, dz, tc);
          float al;
          tf_eval<1>(tf_opacity, n_opacity, ft.attr, &al);
          const float ac = al * fr.opacity;
          float cd = tc, c0 = ft.attr * ac, c1 = ft.cos1 * ac, c2 = ft.cos2 * ac, ca = ac;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j >= k0 && cd < nd[j]) {
              float x = nd[j]; nd[j] = cd; cd = x;
              x = f0[j]; f0[j] = c0; c0 = x;
              x = f1[j]; f1[j] = c1; c1 = x;
              x = f2[j]; f2[j] = c2; c2 = x;
              x = na[j]; na[j] = ca; ca = x;
            }
          }
          // The evicted fragment merges into node K-1 (MlatInsert.glsl).
          const bool evict = isfinite(cd);
          const float w = 1.0f - na[KMAX - 1];
          if (evict) {
            f0[KMAX - 1] = f0[KMAX - 1] + w * c0;
            f1[KMAX - 1] = f1[KMAX - 1] + w * c1;
            f2[KMAX - 1] = f2[KMAX - 1] + w * c2;
          }
          na[KMAX - 1] = fminf(na[KMAX - 1] + (evict ? w * ca : 0.0f), 1.0f);
        }
      },
      cnt, overflow);
  if (r >= R) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= k0) {
      out[(size_t)(j - k0) * R + r] = nd[j];
      out[(size_t)(K + j - k0) * R + r] = f0[j];
      out[(size_t)(2 * K + j - k0) * R + r] = f1[j];
      out[(size_t)(3 * K + j - k0) * R + r] = f2[j];
      out[(size_t)(4 * K + j - k0) * R + r] = na[j];
    }
  }
  if (stats) {
    stats[3 * r] = cnt.visits;
    stats[3 * r + 1] = cnt.leaves;
    stats[3 * r + 2] = inserts;
  }
  if (warp_visits && (threadIdx.x & 31) == 0) warp_visits[r >> 5] = cnt.warp_visits;
}

template <int KMAX>
int launch(const BvhNodes& tr, const BvhCaps& caps, const Frame& fr, const float* origins,
           const float* dirs, const float* wz, const unsigned char* done, int R, int K,
           int max_stack, int cap, float* out, int* stats, int* warp_visits, int* overflow,
           cudaStream_t st) {
  mlat_kernel<KMAX><<<(R + P - 1) / P, P, walk_stack_bytes(WARPS, cap), st>>>(
      tr, caps, fr, origins, dirs, wz, done, R, K, max_stack, cap, out, stats, warp_visits,
      overflow);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch over R rays on `stream`: out [5, K, R] = depth (world t, inf
// empty), attr * a, cos1 * a, cos2 * a, a. `nodes` are the records of
// `ops/lbvh.py:node_records`. `stats` ([R, 3] int32: node visits, leaf
// tests, surfaces inserted) and `warp_visits` ([ceil(R / 32)] int32: the
// nodes each warp tested) may be null. `cap` is the walk's stack entries
// (`walk_stack_depth`, <= max_stack - 1). Adds the rays whose stack would
// pass `max_stack` (<= 64) to *overflow. Returns a CUDA error code.
extern "C" int bvh_mlat_launch(const float* nodes, int n_leaves, const float* a,
                               const float* ba, const float* cap_a, const unsigned char* mask,
                               const float* attr0, const float* dattr, int S, float rr,
                               float radius, const float* origins, const float* dirs,
                               const float* wz, const unsigned char* done, int R, int K,
                               int max_stack, int cap, float zA, float zB, float opacity,
                               const float* tf, float* out, int* stats, int* warp_visits,
                               int* overflow, void* stream) {
  if (n_leaves < 1 || K < 1 || K > 32 || max_stack < 1 || max_stack > STACK || cap < 1 ||
      cap > STACK)
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  const BvhNodes tr{(const float4*)nodes, n_leaves};
  const BvhCaps caps{a, ba, cap_a, mask, attr0, dattr, S, rr, radius};
  const Frame fr{zA, zB, opacity, tf};
  const cudaStream_t st = (cudaStream_t)stream;
  if (K <= 8)
    return launch<8>(tr, caps, fr, origins, dirs, wz, done, R, K, max_stack, cap, out, stats,
                     warp_visits, overflow, st);
  if (K <= 16)
    return launch<16>(tr, caps, fr, origins, dirs, wz, done, R, K, max_stack, cap, out, stats,
                      warp_visits, overflow, st);
  return launch<32>(tr, caps, fr, origins, dirs, wz, done, R, K, max_stack, cap, out, stats,
                    warp_visits, overflow, st);
}

// The KMAX = 8, 16, 32 instances' resources (i = 0, 1, 2): v = (registers,
// local bytes, static shared bytes, resident blocks per SM without dynamic
// shared memory, threads, dynamic shared bytes a stack entry), `label` its
// name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 2) return (int)cudaErrorInvalidValue;
  const void* f = i == 0 ? (const void*)mlat_kernel<8>
                : i == 1 ? (const void*)mlat_kernel<16> : (const void*)mlat_kernel<32>;
  cudaFuncAttributes at;
  int e = (int)cudaFuncGetAttributes(&at, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, P, 0);
  if (e) return e;
  v[0] = at.numRegs;
  v[1] = (int)at.localSizeBytes;
  v[2] = (int)at.sharedSizeBytes;
  v[3] = nb;
  v[4] = P;
  v[5] = (int)walk_stack_bytes(WARPS, 1);
  const char* nm = i == 0 ? "KMAX 8" : i == 1 ? "KMAX 16" : "KMAX 32";
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
