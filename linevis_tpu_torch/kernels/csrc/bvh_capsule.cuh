// Device helpers of the per-ray BVH traversal kernels (bvh_closest_hit.cu,
// bvh_mlat.cu): the binary tree's slab test and the capsule leaf math.
// `ops/lbvh.py` (`safe_inv`, `_ray_aabb`) and `kernels/capsule_common.py`
// (`capsule_surfaces`, `capsule_features`) hold the same arithmetic for the
// plain PyTorch versions; every helper rounds each operation on its own in
// the same order (the files build with --fmad=false).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Binary BVH: internal nodes [0, n-2], leaves [n-1, 2n-2] over leaf_prim.
struct BvhTree {
  const int* left;
  const int* right;
  const float* node_min;  // [2n-1, 3]
  const float* node_max;
  const int* leaf_prim;
  int n;  // leaves
};

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

// The box of `node` against the ray: entry and exit t.
__device__ __forceinline__ void bvh_slab(const BvhTree& tr, int node, float ox, float oy,
                                         float oz, float ix, float iy, float iz, float& tn,
                                         float& tf) {
  const float* mn = tr.node_min + 3 * node;
  const float* mx = tr.node_max + 3 * node;
  const float t0x = (mn[0] - ox) * ix, t1x = (mx[0] - ox) * ix;
  const float t0y = (mn[1] - oy) * iy, t1y = (mx[1] - oy) * iy;
  const float t0z = (mn[2] - oz) * iz, t1z = (mx[2] - oz) * iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
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
