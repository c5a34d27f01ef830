// Device helpers shared by the capsule kernels (raster_capsule.cu,
// raster_capsule_oit.cu, raster_capsule_accum.cu, bvh_wavefront.cu). `kernels/capsule_common.py` holds the same
// arithmetic for their plain PyTorch versions: every helper here rounds as
// its Python counterpart does (the files build with --fmad=false, so an
// explicit __fmaf_rn, `capsule_common.fma32` there, is the only fused
// operation).
#pragma once

#include <cuda_runtime.h>

#define BIG 1e30f

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// Unrolled piecewise-linear TF over a table group of `tf_static_table`:
// [init[nch], (p0, p1, span, v0[nch], dv[nch]) per segment]. Later segments
// win at shared endpoints, as in the JAX kernel's `where` chain.
template <int NCH>
__device__ __forceinline__ void tf_eval(const float* __restrict__ g, int npts, float x,
                                        float* out) {
  const float xc = clamp01(x);
#pragma unroll
  for (int c = 0; c < NCH; ++c) out[c] = g[c];
  const float* seg = g + NCH;
  for (int k = 0; k + 1 < npts; ++k, seg += 3 + 2 * NCH) {
    if (xc >= seg[0] && xc <= seg[1]) {
      const float w = (xc - seg[0]) / seg[2];
#pragma unroll
      for (int c = 0; c < NCH; ++c) out[c] = seg[3 + c] + w * seg[3 + NCH + c];
    }
  }
}

// Unit ray of pixel `tid` of `tile` (params rows 0-8: row-major ray basis,
// dir = B @ [u_ndc, v_ndc, 1]) and 1/|dir|: capsule_common.pixel_rays.
// IEEE sqrt and division, never the approximate rsqrtf.
struct PixelRay {
  float dnx, dny, dnz, invlen;
};

__device__ __forceinline__ PixelRay pixel_ray(const float* __restrict__ params, int tile,
                                              int tid, int tiles_x, int tile_w, int tile_h,
                                              float sx, float sy) {
  const float gx = (float)((tile % tiles_x) * tile_w + tid % tile_w) + 0.5f;
  const float gy = (float)((tile / tiles_x) * tile_h + tid / tile_w) + 0.5f;
  const float un = gx * sx - 1.0f;
  const float vn = 1.0f - gy * sy;
  const float rx = params[0] * un + params[1] * vn + params[2];
  const float ry = params[3] * un + params[4] * vn + params[5];
  const float rz = params[6] * un + params[7] * vn + params[8];
  PixelRay r;
  r.invlen = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz);
  r.dnx = rx * r.invlen;
  r.dny = ry * r.invlen;
  r.dnz = rz * r.invlen;
  return r;
}

// ---------------------------------------------------------------------------
// Capsule candidates of the OIT kernels (raster_capsule_oit.cu,
// raster_capsule_accum.cu): payload rows 0-22 of a chunk staged as
// s[row][column]. `raster_capsule_oit.py:_surfaces` and `_fragments` hold
// the same arithmetic.

// Per-candidate scalars shared by the intersection and the shading.
struct Cand {
  float bard, rdoa, rd, baoa, t0;
};

template <int LD>
__device__ __forceinline__ Cand cand_setup(const float (*s)[LD], int j, float dnx, float dny,
                                           float dnz) {
  Cand c;
  c.bard = s[3][j] * dnx + s[4][j] * dny + s[5][j] * dnz;
  c.rdoa = s[0][j] * dnx + s[1][j] * dny + s[2][j] * dnz;
  c.t0 = -(c.rdoa + 0.5f * c.bard);
  c.rd = -0.5f * c.bard;
  c.baoa = __fmaf_rn(c.t0, c.bard, s[16][j]);
  return c;
}

// The body and cap quadratics of candidate j, re-origined at its closest
// approach to the segment midpoint.
struct Quad {
  float k1, k2, sq, sqa, sqb, b1b, h, ha, hb;
};

template <int LD>
__device__ __forceinline__ Quad cand_quad(const float (*s)[LD], int j, const Cand& cd) {
  const float baba = s[10][j], rr = s[22][j];
  const float oaoa = __fmaf_rn(cd.t0, cd.rdoa + cd.rd, s[17][j]);
  Quad q;
  q.k2 = fmaxf(baba - cd.bard * cd.bard, 1e-20f);
  q.k1 = baba * cd.rd - cd.baoa * cd.bard;
  const float k0 = baba * oaoa - cd.baoa * cd.baoa - s[19][j];
  q.h = q.k1 * q.k1 - q.k2 * k0;
  q.sq = sqrtf(fmaxf(q.h, 0.0f));
  q.ha = cd.rd * cd.rd - (oaoa - rr);
  q.sqa = sqrtf(fmaxf(q.ha, 0.0f));
  q.b1b = cd.rd - cd.bard;
  const float obob = oaoa - 2.0f * cd.baoa + baba;
  q.hb = q.b1b * q.b1b - (obob - rr);
  q.sqb = sqrtf(fmaxf(q.hb, 0.0f));
  return q;
}

// Entry (near) or exit surface of a candidate: relative t, or BIG.
__device__ __forceinline__ float surface_t(const Quad& q, const Cand& c, float baba,
                                           bool cap_a_on, bool near) {
  float tb, ta, tc;
  if (near) {
    tb = (-q.k1 - q.sq) / q.k2;
    ta = -c.rd - q.sqa;
    tc = -q.b1b - q.sqb;
  } else {
    tb = (-q.k1 + q.sq) / q.k2;
    ta = -c.rd + q.sqa;
    tc = -q.b1b + q.sqb;
  }
  const float yb = c.baoa + tb * c.bard;
  const float ya = c.baoa + ta * c.bard;
  const float yc = c.baoa + tc * c.bard;
  const bool okb = (q.h >= 0.0f) && (yb > 0.0f) && (yb < baba) && (c.t0 + tb > 0.0f);
  const bool oka = (q.ha >= 0.0f) && (ya <= 0.0f) && cap_a_on && (c.t0 + ta > 0.0f);
  const bool okc = (q.hb >= 0.0f) && (yc >= baba) && (c.t0 + tc > 0.0f);
  return fminf(okb ? tb : BIG, fminf(oka ? ta : BIG, okc ? tc : BIG));
}

// What the OIT kernels shade with: the TF tables, the opacity scale, the
// depth-cue range and strength (params 11-14).
struct Shading {
  const float* tf_color;
  const float* tf_opacity;
  int n_color, n_opacity;
  float opacity_scale, dmin, dmax, cue;
  bool alpha_from_rows;
};

__device__ __forceinline__ Shading shading_of(const float* __restrict__ params,
                                              const float* __restrict__ tf,
                                              bool alpha_from_rows) {
  Shading sh;
  sh.n_color = (int)tf[0];
  sh.n_opacity = (int)tf[1];
  sh.tf_color = tf + 2;
  sh.tf_opacity = sh.tf_color + 3 + (sh.n_color - 1) * 9;
  sh.opacity_scale = params[14];
  sh.dmin = params[11];
  sh.dmax = params[12];
  sh.cue = params[13];
  sh.alpha_from_rows = alpha_from_rows;
  return sh;
}

// The diffuse term 0.3 cos1^e + 0.7 cos2^e: with BANDS (band shading, e = 1)
// the bases themselves, as the plain version takes them (powf(x, 1.0f) need
// not be x), else e = 1.7. A template argument, not a runtime flag: a branch
// here made the MLAB composite ~10% slower.
template <bool BANDS>
__device__ __forceinline__ float diffuse_mix(float cos1, float cos2) {
  if constexpr (BANDS) return 0.3f * cos1 + 0.7f * cos2;
  return 0.3f * powf(cos1, 1.7f) + 0.7f * powf(cos2, 1.7f);
}

// Axial position (clamped to the segment) and attribute of candidate j's
// fragment at relative t `tc`.
struct FragAxis {
  float y2, uax, attr;
};

template <int LD>
__device__ __forceinline__ FragAxis frag_axis(const float (*s)[LD], int j, const Cand& cd,
                                              float tc) {
  FragAxis x;
  x.y2 = cd.baoa + tc * cd.bard;
  x.uax = clamp01(x.y2 * s[18][j]);
  x.attr = s[7][j] + s[8][j] * x.uax;
  return x;
}

// The importance gather's fragment: (attribute, segment id as a float, 0, 1).
template <int LD>
__device__ __forceinline__ float4 gather_fragment(const float (*s)[LD], int j, const Cand& cd,
                                                  float tc) {
  return make_float4(frag_axis(s, j, cd, tc).attr, s[9][j], 0.0f, 1.0f);
}

// One fragment of candidate j at relative t `tc` (world t `tw`) -> (r, g, b,
// a): headlight Blinn-Phong through scalar identities of the unit ray and the
// tube axis (no per-pixel normal). `deferred`: the shading features (attr,
// cos1, cos2) instead of the color; else the TF color at the fragment's
// attribute, the cosine powers (`diffuse_mix<BANDS>`), and the depth cue at
// its view depth.
template <bool BANDS, int LD>
__device__ __forceinline__ float4 cand_fragment(const float (*s)[LD], int j, const Cand& cd,
                                                float tc, float tw, float invlen,
                                                const Shading& sh, bool deferred) {
  const FragAxis ax = frag_axis(s, j, cd, tc);
  const float y2 = ax.y2, uax = ax.uax, attr = ax.attr;
  const float inv_r = s[21][j], tn = s[20][j];
  const float ndl = -(cd.rd + tc - uax * cd.bard) * inv_r;
  const float tdl = -cd.bard * tn;
  const float ndt = (y2 - uax * s[10][j]) * tn * inv_r;
  const float denom = 1.0f / sqrtf(fmaxf(1.0f - tdl * tdl, 1e-6f));
  const float cos1 = clamp01(fabsf(ndl));
  const float cos2 = clamp01(fabsf(ndl - tdl * ndt) * denom);
  float a;
  if (sh.alpha_from_rows) {
    a = clamp01(s[11][j] + s[12][j] * uax);
  } else {
    float al;
    tf_eval<1>(sh.tf_opacity, sh.n_opacity, attr, &al);
    a = al * sh.opacity_scale;
  }
  if (deferred) return make_float4(attr, cos1, cos2, a);
  const float cos1s = fmaxf(cos1, 1e-20f);
  const float cos2s = fmaxf(cos2, 1e-20f);
  const float cosc = diffuse_mix<BANDS>(cos1s, cos2s);
  const float spec = 0.3f * powf(cos1s, 30.0f);
  const float shade = 0.1f + 0.9f * cosc;
  float fcue = clamp01((tw * invlen - sh.dmin) / fmaxf(sh.dmax - sh.dmin, 1e-6f));
  fcue = fcue * fcue * sh.cue;
  float rgb[3];
  tf_eval<3>(sh.tf_color, sh.n_color, attr, rgb);
  return make_float4((rgb[0] * shade + spec) * (1.0f - fcue) + 0.5f * fcue,
                     (rgb[1] * shade + spec) * (1.0f - fcue) + 0.5f * fcue,
                     (rgb[2] * shade + spec) * (1.0f - fcue) + 0.5f * fcue, a);
}
