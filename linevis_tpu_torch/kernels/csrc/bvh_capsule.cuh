// Device helpers of the per-ray BVH traversal kernels (bvh_closest_hit.cu,
// bvh_mlat.cu): the warp-shared walk of the binary tree over packed node
// records, and the capsule leaf math. `ops/lbvh.py` (`safe_inv`,
// `_ray_aabb`, `node_records`) and `kernels/capsule_common.py`
// (`capsule_surfaces`, `capsule_features`) hold the same arithmetic for the
// plain PyTorch versions; every helper rounds each operation on its own in
// the same order (the files build with --fmad=false).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define BVH_FULL 0xffffffffu

// Binary BVH (internal nodes [0, n-2], leaves [n-1, 2n-2]) as the records
// of `ops/lbvh.py:node_records`, four float4 (64 bytes) a record: record
// i < n-1 holds internal node i's two children, (L.min.xyz, L.code),
// (L.max.xyz, R.code), (R.min.xyz, -), (R.max.xyz, -); record n-1 the root,
// (min.xyz, code), (max.xyz, -). A code >= 0 is an internal node's id, a
// code < 0 the leaf of primitive ~code (ints stored as float bits). One
// record serves both children's box tests and both pushes.
struct BvhNodes {
  const float4* rec;  // [n, 4]
  int n;  // leaves
};

// The box (lo.xyz, hi.xyz) against the ray: entry and exit t.
__device__ __forceinline__ void bvh_slab(const float4& lo, const float4& hi, float ox,
                                         float oy, float oz, float ix, float iy, float iz,
                                         float& tn, float& tf) {
  const float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
  const float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
  const float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// Counts of one walk: the lane's node visits and leaf tests as its own
// depth-first walk would count them (the plain version's `stats`), and the
// nodes the warp tested (the shared walk's cost).
struct WalkCounts {
  int visits, leaves, warp_visits;
};

// A warp's stack in shared memory: per entry (code, lane mask,
// right-depth), and per entry and lane the entry t of that lane's slab test
// (`tn`, [cap][32]). `cap` entries: `ops/lbvh.py:walk_stack_depth` (the
// tree's most right turns on a path, plus one), at most max_stack - 1.
struct WalkStack {
  int4* e;
  float* tn;
  int cap;
};

// Warp w's stack in a block's dynamic shared memory of `walk_stack_bytes`.
__device__ __forceinline__ WalkStack walk_stack(void* smem, int warps, int w, int cap) {
  int4* e = (int4*)smem;
  float* tn = (float*)(e + warps * cap);
  return WalkStack{e + w * cap, tn + w * cap * 32, cap};
}

__host__ __device__ constexpr size_t walk_stack_bytes(int warps, int cap) {
  return (size_t)warps * cap * (sizeof(int4) + 32 * sizeof(float));
}

// One depth-first walk of the tree by the 32 rays of a warp, all lanes
// calling it together (`walking` false for a lane without a ray). A lane
// accepts a node where `stat(tn, tf)` (the part of its test that depends
// only on the box and the ray) and `dyn(tn)` (the part that depends on the
// lane's state, e.g. its nearest hit so far) both hold; at an accepted
// leaf it calls `leaf(prim)`.
//
// The warp keeps ONE stack of (node, lane mask) in shared memory and takes
// nodes in the order every lane's own stack would: from the top, the right
// child first (an accepted internal node's left child is pushed, its right
// one taken at once). At an accepted node the warp loads its record once
// (a broadcast) and each lane tests both children's boxes with `stat`; a
// child enters the stack, or is taken, with the mask of the lanes that
// passed, and each lane's `tn` beside it. Each lane applies `dyn` when the
// child comes off the stack, against its state at that moment, so each
// lane accepts exactly the nodes of its own walk in the same order with the
// same state: its tests depend on nothing but itself and the same floats.
// Children that no lane's `stat` passes are never taken.
//
// Counts and stack depth: a lane's own walk would pop the root and both
// children of every node it accepts (`visits`). Its own stack, once it has
// popped a node, holds one entry for each ancestor where the path turned
// right (the left sibling, still pending): the node's right-depth `rd`,
// the same for every lane that accepts it (the masks shrink down the path).
// An accepted internal node with rd + 2 > `max_stack` is a push past each
// such lane's own stack: those lanes count an overflow and stop walking,
// as the per-ray walk does. The shared stack holds only pushed left
// children of the path's right turns, so at most the tree's largest
// right-depth plus one entries (`WalkStack::cap`).
template <class Static, class Dynamic, class Leaf>
__device__ __forceinline__ void bvh_warp_walk(const BvhNodes& tr, const WalkStack& stk,
                                              int max_stack, bool walking, float ox, float oy,
                                              float oz, float ix, float iy, float iz,
                                              Static stat, Dynamic dyn, Leaf leaf,
                                              WalkCounts& cnt, int* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const unsigned bit = 1u << lane;
  const float4* root = tr.rec + 4 * (tr.n - 1);
  float my_tn, tf;
  bvh_slab(__ldg(root), __ldg(root + 1), ox, oy, oz, ix, iy, iz, my_tn, tf);
  int code = __float_as_int(__ldg(root).w);
  unsigned mask = __ballot_sync(BVH_FULL, walking && stat(my_tn, tf));
  if (walking) ++cnt.visits;
  int rd = 0, sp = 0;
  for (;;) {
    if (mask) {
      ++cnt.warp_visits;
      const bool acc = (mask & bit) && walking && dyn(my_tn);
      if (code < 0) {
        if (acc) {
          ++cnt.leaves;
          leaf(~code);
        }
      } else {
        const unsigned m = __ballot_sync(BVH_FULL, acc);
        if (m) {
          if (rd + 2 <= max_stack) {
            const float4* q = tr.rec + 4 * code;
            const float4 l0 = __ldg(q), l1 = __ldg(q + 1), r0 = __ldg(q + 2), r1 = __ldg(q + 3);
            float tnl, tfl, tnr, tfr;
            bvh_slab(l0, l1, ox, oy, oz, ix, iy, iz, tnl, tfl);
            bvh_slab(r0, r1, ox, oy, oz, ix, iy, iz, tnr, tfr);
            if (acc) cnt.visits += 2;
            const unsigned ml = __ballot_sync(BVH_FULL, acc && stat(tnl, tfl));
            if (ml && sp < stk.cap) {
              if (lane == 0) stk.e[sp] = make_int4(__float_as_int(l0.w), (int)ml, rd, 0);
              stk.tn[sp * 32 + lane] = tnl;
              ++sp;
            } else if (ml && (ml & bit)) {  // a stack sized below its tree: flagged
              atomicAdd(overflow, 1);
            }
            code = __float_as_int(l1.w);
            mask = __ballot_sync(BVH_FULL, acc && stat(tnr, tfr));
            my_tn = tnr;
            ++rd;
            continue;
          }
          if (acc) {
            atomicAdd(overflow, 1);
            walking = false;
          }
        }
      }
    }
    if (sp == 0) break;
    __syncwarp();
    --sp;
    const int4 e = stk.e[sp];
    code = e.x;
    mask = (unsigned)e.y;
    rd = e.z;
    my_tn = stk.tn[sp * 32 + lane];
  }
  __syncwarp();
}

// The capsule scene, channels first.
struct BvhCaps {
  const float* a;  // [3, S] start points
  const float* ba;  // [3, S] segment vectors
  const float* cap_a;  // [S] 1 where the start cap renders
  const unsigned char* mask;  // [S]
  const float* attr0;  // [S] (features only)
  const float* dattr;  // [S]
  int S;
  float rr;  // radius^2 in float32
  float radius;
};

// 1/d, or +-1e12 (the sign of d + 1e-30) where |d| < 1e-12.
__device__ __forceinline__ float bvh_safe_inv(float d) {
  if (fabsf(d) < 1e-12f) {
    const float s = d + 1e-30f;
    return s > 0.0f ? 1e12f : (s < 0.0f ? -1e12f : 0.0f);
  }
  return 1.0f / d;
}

// Entry (t_in) and exit (t_out) surface of capsule `prim`: the nearer of the
// body's, the start cap's and the end cap's candidate that `accept(t)`
// takes; INFINITY where none qualifies or the capsule is masked.
template <class Accept>
__device__ __forceinline__ void bvh_capsule_surfaces(const BvhCaps& c, int prim, float ox,
                                                     float oy, float oz, float dx, float dy,
                                                     float dz, Accept accept, float& t_in,
                                                     float& t_out) {
  const int S = c.S;
  const float oax = ox - c.a[prim], oay = oy - c.a[S + prim], oaz = oz - c.a[2 * S + prim];
  const float bx = c.ba[prim], by = c.ba[S + prim], bz = c.ba[2 * S + prim];
  const float baba = bx * bx + by * by + bz * bz;
  const float bard = bx * dx + by * dy + bz * dz;
  const float baoa = bx * oax + by * oay + bz * oaz;
  const float rd = dx * oax + dy * oay + dz * oaz;
  const float oaoa = oax * oax + oay * oay + oaz * oaz;
  const float rr = c.rr;
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
  const bool cap_on = c.cap_a[prim] > 0.5f;
  float t[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float tb = s == 0 ? (-k1 - sq) / k2 : (-k1 + sq) / k2;
    const float ta = s == 0 ? -rd - sqa : -rd + sqa;
    const float tc = s == 0 ? -b1b - sqb : -b1b + sqb;
    const float yb = baoa + tb * bard, ya = baoa + ta * bard, yc = baoa + tc * bard;
    const bool okb = (h >= 0.0f) && (yb > 0.0f) && (yb < baba) && accept(tb);
    const bool oka = (ha >= 0.0f) && (ya <= 0.0f) && cap_on && accept(ta);
    const bool okc = (hb >= 0.0f) && (yc >= baba) && accept(tc);
    t[s] = fminf(okb ? tb : INFINITY, fminf(oka ? ta : INFINITY, okc ? tc : INFINITY));
  }
  const bool on = c.mask[prim] != 0;
  t_in = on ? t[0] : INFINITY;
  t_out = on ? t[1] : INFINITY;
}

// Deferred-shading features of the point at t on capsule `prim`: the
// attribute, the headlight cosines of the normal and of the tube, the
// opacity TF's alpha (before the opacity scale).
struct BvhFeat {
  float attr, cos1, cos2;
};

__device__ __forceinline__ BvhFeat bvh_capsule_features(const BvhCaps& c, int prim, float ox,
                                                        float oy, float oz, float dx, float dy,
                                                        float dz, float t) {
  const int S = c.S;
  const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
  const float ax = c.a[prim], ay = c.a[S + prim], az = c.a[2 * S + prim];
  const float bx = c.ba[prim], by = c.ba[S + prim], bz = c.ba[2 * S + prim];
  const float baba = fmaxf(bx * bx + by * by + bz * bz, 1e-20f);
  const float uax =
      fminf(fmaxf(((px - ax) * bx + (py - ay) * by + (pz - az) * bz) / baba, 0.0f), 1.0f);
  BvhFeat f;
  f.attr = c.attr0[prim] + c.dattr[prim] * uax;
  const float nx = (px - (ax + bx * uax)) / c.radius;
  const float ny = (py - (ay + by * uax)) / c.radius;
  const float nz = (pz - (az + bz * uax)) / c.radius;
  const float inv_len = 1.0f / sqrtf(baba);
  const float tx = bx * inv_len, ty = by * inv_len, tz = bz * inv_len;
  const float ndl = -(nx * dx + ny * dy + nz * dz);
  const float tdl = -(tx * dx + ty * dy + tz * dz);
  const float ndt = nx * tx + ny * ty + nz * tz;
  const float denom = 1.0f / sqrtf(fmaxf(1.0f - tdl * tdl, 1e-6f));
  f.cos1 = fminf(fmaxf(fabsf(ndl), 0.0f), 1.0f);
  f.cos2 = fminf(fmaxf(fabsf(ndl - tdl * ndt) * denom, 0.0f), 1.0f);
  return f;
}
