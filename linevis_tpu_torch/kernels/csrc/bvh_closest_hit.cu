// The transparent ray tracer's re-cast loop over the binary BVH, for Hopper
// (sm_90a): the whole loop in one launch (`recast_kernel`), and one cast of
// it alone (`closest_hit_kernel`, the closest capsule hit in enumerate mode).
//
// Replaces no Pallas kernel: the JAX package writes the loop as `jax.vmap`
// of a `fori_loop` of casts (linevis_tpu/render/ray_tracer.py:271
// `trace_one`), each cast a per-ray `lax.while_loop` over a stack
// (linevis_tpu/ops/lbvh.py:211 `ray_query`) with the leaf function of
// linevis_tpu/render/ray_tracer.py:147 `_make_capsule_hit`. The plain PyTorch
// versions they are held against: `render/ray_tracer.py:trace_recast` with
// `capsule_closest_hit_reference` (kernels/bvh_closest_hit.py) as its
// closest hit, and that function alone.
//
// A cast, per ray: the surface strictly after (t_last, p_last) in (t, prim)
// order, ties on t to the smaller prim id; rays that are done get (inf, -1).
// The loop, per ray, in the plain version's order: a surface outside the
// NDC depth range is skipped; one within the relative 1e-6 tie window of the
// pending group joins it (features and alpha summed, averaged at the
// flush); any other flushes the pending group (shaded: TF color, the
// diffuse mix, the 30th power of cos1, the depth cue; blended front to back)
// and starts a new one. A ray is done at a miss or once its transmittance
// falls below 1e-4; its pending group is flushed once, as the plain loop's
// next cast or tail flush does.
//
// Design: blocks of 128 rays (the caller orders the rays by 16x8 screen
// tiles, so a block is one tile, a warp two rows of it). Each warp walks the
// tree together (`bvh_warp_walk`): one stack of (node, lane mask) in shared
// memory, one record load per accepted node for the whole warp holding its
// children's boxes, each lane testing each child against its own state at
// the child's turn, so every lane visits its own walk's nodes in its own
// order. The loop kernel walks the tree collapsed two levels at a time
// (`wide_warp_walk`: four grandchildren a 128-byte record), keeps each
// ray's loop state in registers across all casts (no per-cast pass over
// the rays, no state in device memory) and lets a warp leave once its 32
// rays are done. What bounds it: the warp's walk (the union of its lanes'
// walks: about 0.6x the longest lane's binary walk on the 1080p tornado)
// times the slab tests and the bookkeeping of each node, latency-bound at 8
// blocks an SM; the records and the capsules stay in L2.
//
// Precision: --fmad=false and no fast math; IEEE sqrtf and division, powf.
// Every operation is rounded on its own in the plain version's order, so a
// cast's t is the same float on both sides (the enumeration walks every
// surface exactly once only then) and the transmittance that ends a ray is
// the same too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh_capsule.cuh"
#include "capsule_common.cuh"

namespace {

constexpr int P = 128;  // rays per block
constexpr int WARPS = P / 32;
constexpr int STACK = 64;  // most node ids a ray's stack holds
constexpr int WIDE_EMPTY = 0x7FFFFFFF;  // `ops/lbvh.py:WIDE_EMPTY`

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origins,
                                        const float* __restrict__ dirs, int r) {
  Ray ry;
  ry.ox = origins[3 * r];
  ry.oy = origins[3 * r + 1];
  ry.oz = origins[3 * r + 2];
  ry.dx = dirs[3 * r];
  ry.dy = dirs[3 * r + 1];
  ry.dz = dirs[3 * r + 2];
  ry.ix = bvh_safe_inv(ry.dx);
  ry.iy = bvh_safe_inv(ry.dy);
  ry.iz = bvh_safe_inv(ry.dz);
  return ry;
}

// One cast for the warp: each walking lane's nearest surface strictly after
// (t_min, prim_min) -> (t, prim); (inf, -1) on a miss and for the others.
// WIDE: over `wide_node_records` (`tr.n` the wide records), else over
// `node_records`.
template <bool WIDE>
__device__ __forceinline__ void closest_hit_walk(const BvhNodes& tr, const BvhCaps& caps,
                                                 const WalkStack& stk, int max_stack,
                                                 bool walking, const Ray& ry, float t_min,
                                                 int prim_min, float& t_best, int& best,
                                                 WalkCounts& cnt, int* overflow) {
  t_best = INFINITY;
  best = -1;
  const auto stat = [&](float tn, float tf) { return (tf >= fmaxf(tn, 0.0f)) && (tf >= t_min); };
  const auto dyn = [&](float tn) { return tn <= t_best; };
  const auto leaf = [&](int prim) {
    // The nearer of entry and exit strictly after (t_min, prim_min).
    float t_in, t_out;
    bvh_capsule_surfaces(
        caps, prim, ry.ox, ry.oy, ry.oz, ry.dx, ry.dy, ry.dz,
        [&](float tp) { return tp > t_min || (tp == t_min && prim > prim_min); }, t_in, t_out);
    const float t = fminf(t_in, t_out);
    if (t < t_best || (t == t_best && isfinite(t) && prim < best)) {
      t_best = t;
      best = prim;
    }
  };
  if constexpr (WIDE)
    wide_warp_walk(tr, stk, walking, ry, stat, dyn, leaf, cnt, overflow);
  else
    bvh_warp_walk(tr, stk, max_stack, walking, ry.ox, ry.oy, ry.oz, ry.ix, ry.iy, ry.iz, stat,
                  dyn, leaf, cnt, overflow);
  if (!isfinite(t_best)) best = -1;
}

// The re-cast loop's walk over the tree collapsed two levels at a time
// (`ops/lbvh.py:wide_node_records`): `bvh_warp_walk` with four slots a
// record (8 float4, 128 bytes) in the binary walk's visit order, the
// intermediate level never tested. Exact for the closest hit: a box inside
// a box that fails `stat` fails it too (the slab's floats are monotone in
// the box), and `dyn` (tn <= the lane's nearest hit, which only falls)
// fails later for a box whose parent it failed; so each lane accepts the
// same nodes in the same order as its binary walk. Only for trees on which
// no lane's own stack can overflow (the tree's right-depth + 2 <= 64),
// since the skipped level's pushes are not counted; no per-lane visit
// counts (`WalkCounts::visits`), which count the binary walk's pops.
template <class Static, class Dynamic, class Leaf>
__device__ __forceinline__ void wide_warp_walk(const BvhNodes& tr, const WalkStack& stk,
                                               bool walking, const Ray& ry, Static stat,
                                               Dynamic dyn, Leaf leaf, WalkCounts& cnt,
                                               int* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const unsigned bit = 1u << lane;
  const float4* root = tr.rec + 8 * tr.n;  // tr.n: the wide records
  float my_tn, tf;
  bvh_slab(__ldg(root), __ldg(root + 1), ry.ox, ry.oy, ry.oz, ry.ix, ry.iy, ry.iz, my_tn, tf);
  int code = __float_as_int(__ldg(root).w);
  unsigned mask = __ballot_sync(BVH_FULL, walking && stat(my_tn, tf));
  int sp = 0;
  for (;;) {
    if (mask) {
      ++cnt.warp_visits;
      const bool acc = walking && (mask & bit) && dyn(my_tn);
      if (code < 0) {  // a leaf slot
        if (acc) {
          ++cnt.leaves;
          leaf(~code);
        }
      } else if (__any_sync(BVH_FULL, acc)) {
        const float4* q = tr.rec + 8 * code;
        float4 lo[4], hi[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo[k] = __ldg(q + 2 * k);
          hi[k] = __ldg(q + 2 * k + 1);
        }
        float tns[4];
        unsigned ms[4];
        int codes[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float tfk;
          bvh_slab(lo[k], hi[k], ry.ox, ry.oy, ry.oz, ry.ix, ry.iy, ry.iz, tns[k], tfk);
          codes[k] = __float_as_int(lo[k].w);
          ms[k] = __ballot_sync(BVH_FULL, acc && codes[k] != WIDE_EMPTY && stat(tns[k], tfk));
        }
#pragma unroll
        for (int k = 3; k >= 1; --k) {
          if (ms[k]) {
            if (sp < stk.cap) {
              if (lane == 0) stk.e[sp] = make_int4(codes[k], (int)ms[k], 0, 0);
              stk.tn[sp * 32 + lane] = tns[k];
              ++sp;
            } else if (ms[k] & bit) {  // a stack sized below its tree: flagged
              atomicAdd(overflow, 1);
            }
          }
        }
        code = codes[0];
        mask = ms[0];
        my_tn = tns[0];
        continue;
      }
    }
    if (sp == 0) break;
    __syncwarp();
    --sp;
    const int4 e = stk.e[sp];
    code = e.x;
    mask = (unsigned)e.y;
    my_tn = stk.tn[sp * 32 + lane];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(P)
closest_hit_kernel(BvhNodes tr, BvhCaps caps, const float* __restrict__ origins,
                   const float* __restrict__ dirs, const float* __restrict__ t_min_in,
                   const int* __restrict__ prim_min_in, const unsigned char* __restrict__ done,
                   int R, int max_stack, int cap, float* __restrict__ t_out,
                   int* __restrict__ prim_out,
                   int* __restrict__ stats, int* __restrict__ warp_visits,
                   int* __restrict__ overflow) {
  extern __shared__ int4 smem[];
  const WalkStack stk = walk_stack(smem, WARPS, threadIdx.x >> 5, cap);
  const int r = blockIdx.x * P + threadIdx.x;
  const bool live = r < R && !done[r];
  Ray ry{};
  float t_min = 0.0f;
  int prim_min = 0;
  if (live) {
    ry = load_ray(origins, dirs, r);
    t_min = t_min_in[r];
    prim_min = prim_min_in[r];
  }
  float t_best;
  int best;
  WalkCounts cnt{0, 0, 0};
  closest_hit_walk<false>(tr, caps, stk, max_stack, live, ry, t_min, prim_min, t_best, best,
                          cnt, overflow);
  if (r < R) {
    t_out[r] = t_best;
    prim_out[r] = best;
    if (stats) {
      stats[2 * r] = cnt.visits;
      stats[2 * r + 1] = cnt.leaves;
    }
    if (warp_visits && (threadIdx.x & 31) == 0) warp_visits[r >> 5] = cnt.warp_visits;
  }
}

// The frame's shading constants: the NDC depth range's projection terms,
// the opacity scale, the depth cue's range and strength, and the TF table
// (`tf_static_table`: [n_color, n_opacity, color group, opacity group]).
struct Shade {
  float zA, zB, opacity, dmin, dmax, cue;
  const float* tf;
};

// Shade the pending group (features averaged over its n surfaces) at view
// depth g_t0 * wz and blend it behind what the ray holds:
// `render/ray_tracer.py:trace_recast`'s `flush` with `_shade`.
__device__ __forceinline__ void flush_group(const Shade& sh, const float* __restrict__ tf_color,
                                            int n_color, float wz, float g_t0, float g_attr,
                                            float g_c1, float g_c2, float g_a, float g_n,
                                            float& T, float* acc) {
  const float nn = fmaxf(g_n, 1.0f);
  const float attr = g_attr / nn;
  const float c1 = fmaxf(g_c1 / nn, 1e-20f);
  const float c2 = fmaxf(g_c2 / nn, 1e-20f);
  const float cosc = diffuse_mix<false>(c1, c2);
  const float spec = 0.3f * powf(c1, 30.0f);
  float rgb[3];
  tf_eval<3>(tf_color, n_color, attr, rgb);
  const float shade = 0.1f + 0.9f * cosc;
  float fcue = clamp01((g_t0 * wz - sh.dmin) / fmaxf(sh.dmax - sh.dmin, 1e-6f));
  fcue = fcue * fcue * sh.cue;
  const float a_m = g_a / nn;
  const float ta = T * a_m;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    acc[c] = acc[c] + ta * ((rgb[c] * shade + spec) * (1.0f - fcue) + 0.5f * fcue);
  T = T * (1.0f - a_m);
}

// At most 64 registers: 8 resident blocks an SM (32 warps), a few bytes of
// spills; the walk is latency-bound, and more warps beat fewer spills. The
// walk is over the collapsed tree (`wide_warp_walk`), so no per-ray visit
// counts: the one-cast kernel keeps those.
__global__ void __launch_bounds__(P, 8)
recast_kernel(BvhNodes tr, BvhCaps caps, Shade sh, const float* __restrict__ origins,
              const float* __restrict__ dirs, const float* __restrict__ wz_in,
              const unsigned char* __restrict__ pad, int R, int casts, int cap,
              float* __restrict__ acc_out, float* __restrict__ T_out,
              float* __restrict__ rec_t, int* __restrict__ rec_prim,
              int* __restrict__ warp_visits, int* __restrict__ overflow) {
  extern __shared__ int4 smem[];
  const WalkStack stk = walk_stack(smem, WARPS, threadIdx.x >> 5, cap);
  const int r = blockIdx.x * P + threadIdx.x;
  const bool in = r < R;
  Ray ry{};
  float wz = 0.0f;
  bool done = true;
  if (in) {
    ry = load_ray(origins, dirs, r);
    wz = wz_in[r];
    done = pad[r] != 0;
  }
  const int n_color = (int)sh.tf[0];
  const int n_opacity = (int)sh.tf[1];
  const float* tf_color = sh.tf + 2;
  const float* tf_opacity = tf_color + 3 + (n_color - 1) * 9;
  float t_last = 0.0f;
  int p_last = INT32_MAX;
  // The pending group: its first surface's t, summed features, count.
  float g_t0 = 0.0f, g_attr = 0.0f, g_c1 = 0.0f, g_c2 = 0.0f, g_a = 0.0f, g_n = 0.0f;
  float T = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  WalkCounts cnt{0, 0, 0};
  int c = 0;
  for (;; ++c) {
    // Past the last cast, or once every ray of the warp is done: the tail
    // flush of what each ray holds pending.
    const bool end = c == casts || __all_sync(BVH_FULL, done);
    float t = INFINITY;
    int prim = -1;
    bool take = false, join = false, flush;
    float attr = 0.0f, c1 = 0.0f, c2 = 0.0f, al = 0.0f;
    if (end) {
      flush = g_n > 0.0f;
    } else {
      closest_hit_walk<true>(tr, caps, stk, STACK, !done, ry, t_last, p_last, t, prim, cnt,
                             overflow);
      if (rec_t && in) {
        rec_t[(size_t)c * R + r] = t;
        rec_prim[(size_t)c * R + r] = prim;
      }
      if (!done && prim >= 0) {
        const float znd = sh.zA - sh.zB / fmaxf(t * wz, 1e-12f);
        take = !((znd < 0.0f) || (znd > 1.0f));  // inside the clip volume
      }
      if (take) {
        const BvhFeat ft = bvh_capsule_features(caps, prim, ry.ox, ry.oy, ry.oz, ry.dx, ry.dy,
                                                ry.dz, t);
        attr = ft.attr;
        c1 = ft.cos1;
        c2 = ft.cos2;
        tf_eval<1>(tf_opacity, n_opacity, attr, &al);
        al = al * sh.opacity;
        join = (g_n > 0.0f) && (t <= g_t0 + fabsf(g_t0) * 1e-6f);
      }
      flush = take && !join && g_n > 0.0f;
    }
    if (flush)
      flush_group(sh, tf_color, n_color, wz, g_t0, g_attr, g_c1, g_c2, g_a, g_n, T, acc);
    if (end) break;
    if (done) continue;
    if (prim < 0) {  // a miss: the pending group waits for the tail flush
      done = true;
      continue;
    }
    if (join) {
      g_attr = g_attr + attr;
      g_c1 = g_c1 + c1;
      g_c2 = g_c2 + c2;
      g_a = g_a + al;
      g_n = g_n + 1.0f;
    } else if (take) {
      g_t0 = t;
      g_attr = attr;
      g_c1 = c1;
      g_c2 = c2;
      g_a = al;
      g_n = 1.0f;
    }
    t_last = t;
    p_last = prim;
    done = T < 1e-4f;
  }
  if (rec_t && in) {
    for (int k = c; k < casts; ++k) {
      rec_t[(size_t)k * R + r] = INFINITY;
      rec_prim[(size_t)k * R + r] = -1;
    }
  }
  if (in) {
    acc_out[r] = acc[0];
    acc_out[R + r] = acc[1];
    acc_out[2 * R + r] = acc[2];
    T_out[r] = T;
    if (warp_visits && (threadIdx.x & 31) == 0) warp_visits[r >> 5] = cnt.warp_visits;
  }
}

}  // namespace

// Ray-tracer launches on `stream`. Arrays as the wrappers
// (kernels/bvh_closest_hit.py, render/ray_tracer.py:capsule_recast)
// document them, the scene channels first; `warp_visits` ([ceil(R / 32)]
// int32: the nodes each warp tested) may be null. Return a CUDA error code.

// One cast: (t_out, prim_out) [R] after (t_min, prim_min); `done` rays
// skip. `nodes` the records of `ops/lbvh.py:node_records`, `cap` the walk's
// stack entries (`walk_stack_depth`, <= max_stack - 1). `stats` ([R, 2]
// int32: node visits and leaf tests) may be null. Adds the rays whose stack
// would pass `max_stack` (<= 64) to *overflow.
extern "C" int bvh_closest_hit_launch(const float* nodes, int n_leaves, const float* a,
                                      const float* ba, const float* cap_a,
                                      const unsigned char* mask, int S, float rr,
                                      const float* origins, const float* dirs,
                                      const float* t_min, const int* prim_min,
                                      const unsigned char* done, int R, int max_stack,
                                      int cap, float* t_out, int* prim_out, int* stats,
                                      int* warp_visits, int* overflow, void* stream) {
  if (n_leaves < 1 || max_stack < 1 || max_stack > STACK || cap < 1 || cap > STACK)
    return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const BvhNodes tr{(const float4*)nodes, n_leaves};
    const BvhCaps caps{a, ba, cap_a, mask, nullptr, nullptr, S, rr, 0.0f};
    closest_hit_kernel<<<(R + P - 1) / P, P, walk_stack_bytes(WARPS, cap),
                         (cudaStream_t)stream>>>(tr, caps, origins, dirs, t_min, prim_min, done,
                                                 R, max_stack, cap, t_out, prim_out, stats,
                                                 warp_visits, overflow);
  }
  return (int)cudaGetLastError();
}

// The whole loop of `casts` casts over the collapsed tree (`nodes` the
// records of `ops/lbvh.py:wide_node_records`, `n` of them before the
// root's; `cap` its stack entries): acc [3, R] premultiplied color and T
// [R] transmittance; `rec_t` / `rec_prim` ([casts, R], may be null) every
// cast's (t, prim), (inf, -1) for rays that are done. The caller takes only
// trees on which no ray's own stack can pass its capacity: the collapsed
// walk does not count a ray's pushes, and *overflow gains only a stack
// sized below its tree.
extern "C" int bvh_recast_launch(const float* nodes, int n, const float* a, const float* ba,
                                 const float* cap_a, const unsigned char* mask,
                                 const float* attr0, const float* dattr, int S, float rr,
                                 float radius, const float* origins, const float* dirs,
                                 const float* wz, const unsigned char* pad, int R, int casts,
                                 int cap, float zA, float zB, float opacity, float dmin,
                                 float dmax, float cue, const float* tf, float* acc, float* T,
                                 float* rec_t, int* rec_prim, int* warp_visits, int* overflow,
                                 void* stream) {
  if (n < 0 || casts < 0 || cap < 1 || cap > STACK || (rec_t == nullptr) != (rec_prim == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const BvhNodes tr{(const float4*)nodes, n};
    const BvhCaps caps{a, ba, cap_a, mask, attr0, dattr, S, rr, radius};
    const Shade sh{zA, zB, opacity, dmin, dmax, cue, tf};
    recast_kernel<<<(R + P - 1) / P, P, walk_stack_bytes(WARPS, cap), (cudaStream_t)stream>>>(
        tr, caps, sh, origins, dirs, wz, pad, R, casts, cap, acc, T, rec_t, rec_prim,
        warp_visits, overflow);
  }
  return (int)cudaGetLastError();
}

// The kernels' resources (i = 0: the loop, 1: one cast): v = (registers,
// local bytes, static shared bytes, resident blocks per SM without dynamic
// shared memory, threads, dynamic shared bytes a stack entry), `label` its
// name. A launch takes `walk_stack_bytes(WARPS, cap)` of dynamic shared
// memory for a `cap`-entry stack.
extern "C" int kernel_info(int i, int* v, char* label, int label_cap) {
  if (i < 0 || i > 1) return (int)cudaErrorInvalidValue;
  const void* f = i == 0 ? (const void*)recast_kernel : (const void*)closest_hit_kernel;
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
  const char* nm = i == 0 ? "recast" : "closest hit";
  int k = 0;
  for (; nm[k] && k < label_cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
