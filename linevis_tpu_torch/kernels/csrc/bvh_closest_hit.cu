// Closest capsule hit in enumerate mode over the binary BVH, for Hopper
// (sm_90a): one step of the transparent ray tracer's re-cast loop.
//
// Replaces no Pallas kernel: the JAX package writes this traversal as
// `jax.vmap` of a `lax.while_loop` over a per-ray stack
// (linevis_tpu/ops/lbvh.py:211 `ray_query`) with the leaf function of
// linevis_tpu/render/ray_tracer.py:147 `_make_capsule_hit`. The plain
// PyTorch version it is held against is `capsule_closest_hit_reference`
// (kernels/bvh_closest_hit.py): `ops.lbvh.ray_query` with
// `kernels.capsule_common.capsule_surfaces` at the leaves.
//
// Per ray: the surface strictly after (t_min, prim_min) in (t, prim) order,
// ties on t to the smaller prim id; rays flagged done return (inf, -1).
//
// Design: one thread per ray, blocks of 128 rays (the caller orders the rays
// by 16x8 screen tiles, so a block is one tile), the stack of up to 64 node
// ids in local memory, nodes popped from the top, an internal node's left
// child pushed before its right. What bounds it: every ray walks its own
// path from the root, so the time is the longest walk of each warp times
// the node and leaf work; the tree (a few MB) stays in L2. A simple kernel
// that is right: no shared stack, no node compression, no early exit.
//
// Precision: --fmad=false and no fast math; IEEE sqrtf and division. Every
// operation is rounded on its own in the plain version's order, so the two
// agree bit for bit (the enumeration walks every surface exactly once only
// if t is the same float on both sides).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh_capsule.cuh"

namespace {

constexpr int P = 128;  // rays per block
constexpr int STACK = 64;  // most node ids a ray's stack holds

__global__ void __launch_bounds__(P)
closest_hit_kernel(BvhTree tr, BvhCaps caps, const float* __restrict__ origins,
                   const float* __restrict__ dirs, const float* __restrict__ t_min_in,
                   const int* __restrict__ prim_min_in, const unsigned char* __restrict__ done,
                   int R, int max_stack, float* __restrict__ t_out, int* __restrict__ prim_out,
                   int* __restrict__ stats, int* __restrict__ overflow) {
  const int r = blockIdx.x * P + threadIdx.x;
  if (r >= R) return;
  float t_best = INFINITY;
  int best = -1, visits = 0, leaves = 0;
  if (!done[r]) {
    const float ox = origins[3 * r], oy = origins[3 * r + 1], oz = origins[3 * r + 2];
    const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
    const float ix = bvh_safe_inv(dx), iy = bvh_safe_inv(dy), iz = bvh_safe_inv(dz);
    const float t_min = t_min_in[r];
    const int prim_min = prim_min_in[r];
    int stack[STACK];
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const int node = stack[--sp];
      ++visits;
      float tn, tf;
      bvh_slab(tr, node, ox, oy, oz, ix, iy, iz, tn, tf);
      const bool hit = (tf >= fmaxf(tn, 0.0f)) && (tn <= t_best) && (tf >= t_min);
      if (!hit) continue;
      if (node >= tr.n - 1) {
        ++leaves;
        const int prim = tr.leaf_prim[node - (tr.n - 1)];
        // The nearer of entry and exit strictly after (t_min, prim_min).
        float t_in, t_out;
        bvh_capsule_surfaces(
            caps, prim, ox, oy, oz, dx, dy, dz,
            [&](float tp) { return tp > t_min || (tp == t_min && prim > prim_min); }, t_in,
            t_out);
        const float t = fminf(t_in, t_out);
        if (t < t_best || (t == t_best && isfinite(t) && prim < best)) {
          t_best = t;
          best = prim;
        }
      } else {
        if (sp + 2 > max_stack) {
          atomicAdd(overflow, 1);
          break;
        }
        stack[sp++] = tr.left[node];
        stack[sp++] = tr.right[node];
      }
    }
  }
  t_out[r] = t_best;
  prim_out[r] = isfinite(t_best) ? best : -1;
  if (stats) {
    stats[2 * r] = visits;
    stats[2 * r + 1] = leaves;
  }
}

}  // namespace

// Launch over R rays on `stream`. Arrays as the wrapper documents them;
// `stats` ([R, 2] int32: node visits, leaf tests) may be null. Adds the
// rays whose stack would pass `max_stack` (<= 64) to *overflow. Returns a
// CUDA error code.
extern "C" int bvh_closest_hit_launch(const int* left, const int* right, const float* node_min,
                                      const float* node_max, const int* leaf_prim, int n_leaves,
                                      const float* a, const float* ba, const float* cap_a,
                                      const unsigned char* mask, int S, float rr,
                                      const float* origins, const float* dirs,
                                      const float* t_min, const int* prim_min,
                                      const unsigned char* done, int R, int max_stack,
                                      float* t_out, int* prim_out, int* stats, int* overflow,
                                      void* stream) {
  if (n_leaves < 1 || max_stack < 1 || max_stack > STACK) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const BvhTree tr{left, right, node_min, node_max, leaf_prim, n_leaves};
    const BvhCaps caps{a, ba, cap_a, mask, nullptr, nullptr, S, rr, 0.0f};
    closest_hit_kernel<<<(R + P - 1) / P, P, 0, (cudaStream_t)stream>>>(
        tr, caps, origins, dirs, t_min, prim_min, done, R, max_stack, t_out, prim_out, stats,
        overflow);
  }
  return (int)cudaGetLastError();
}

// The kernel's resources: v = (registers, local bytes, static shared bytes,
// resident blocks per SM, threads, dynamic shared bytes), `label` its name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  int e = (int)cudaFuncGetAttributes(&at, (const void*)closest_hit_kernel);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, closest_hit_kernel, P, 0);
  if (e) return e;
  v[0] = at.numRegs;
  v[1] = (int)at.localSizeBytes;
  v[2] = (int)at.sharedSizeBytes;
  v[3] = nb;
  v[4] = P;
  v[5] = 0;
  const char* nm = "closest hit";
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
