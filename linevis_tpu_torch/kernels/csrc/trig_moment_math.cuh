// Trigonometric-moment transmittance reconstruction for MBOIT, as device code.
//
// One for one with linevis_tpu_torch/kernels/trig_moment_math.py (the JAX
// package's linevis_tpu/kernels/trig_moment_math.py; the reference's
// `usePowerMoments = false` mode, TrigonometricMomentMath.glsl and
// ComplexAlgebra.glsl), except that its _transmittance_trig is split into
// trig_moment_setup and transmittance_trig (below). Complex numbers are (re, im) pairs of floats; sin and
// cos are the degree-9 polynomial `sin_poly`, atan2 the polynomial of
// moment_math.cuh. Every operation rounds as its plain counterpart does
// (--fmad=false, no fast math).
#pragma once

#include <cuda_runtime.h>

#include "moment_math.cuh"

#define TM_PI 3.141592653589793f
#define TM_TWO_PI 6.283185307179586f
#define TM_HALF_PI 1.5707963267948966f

struct cpx {
  float re, im;
};

__device__ __forceinline__ cpx cx(float re, float im) {
  cpx c;
  c.re = re;
  c.im = im;
  return c;
}

__device__ __forceinline__ float sin_poly(float phi) {
  float x = phi - TM_TWO_PI * floorf(phi / TM_TWO_PI + 0.5f);  // -> [-pi, pi]
  x = x > TM_HALF_PI ? TM_PI - x : x;
  x = x < -TM_HALF_PI ? -TM_PI - x : x;  // -> [-pi/2, pi/2]
  const float z = x * x;
  return x * (1.0f +
              z * ((float)(-1.0 / 6.0) +
                   z * ((float)(1.0 / 120.0) +
                        z * ((float)(-1.0 / 5040.0) + z * (float)(1.0 / 362880.0)))));
}

// (re, im) = (cos, sin) of phi.
__device__ __forceinline__ cpx sincos_poly(float phi) {
  return cx(sin_poly(phi + TM_HALF_PI), sin_poly(phi));
}

__device__ __forceinline__ cpx cmul(cpx a, cpx b) {
  return cx(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
__device__ __forceinline__ cpx cconj(cpx a) { return cx(a.re, -a.im); }
__device__ __forceinline__ cpx cadd(cpx a, cpx b) { return cx(a.re + b.re, a.im + b.im); }
__device__ __forceinline__ cpx csub(cpx a, cpx b) { return cx(a.re - b.re, a.im - b.im); }
__device__ __forceinline__ cpx cscale(cpx a, float s) { return cx(a.re * s, a.im * s); }
// GLSL dot() of the vec2 representations (not the Hermitian product).
__device__ __forceinline__ float cdot(cpx a, cpx b) { return a.re * b.re + a.im * b.im; }

__device__ __forceinline__ cpx cdiv(cpx num, cpx den) {
  const float d = fmaxf(den.re * den.re + den.im * den.im, 1e-20f);
  return cx((num.re * den.re + num.im * den.im) / d, (-num.re * den.im + num.im * den.re) / d);
}

__device__ __forceinline__ cpx crcp(cpx a) {
  const float d = fmaxf(a.re * a.re + a.im * a.im, 1e-20f);
  return cx(a.re / d, -a.im / d);
}

__device__ __forceinline__ cpx csq(cpx a) {
  return cx(a.re * a.re - a.im * a.im, 2.0f * a.re * a.im);
}

// One square root (ComplexAlgebra.glsl SquareRoot): the half-angle
// construction on (|re|, im), components swapped for negative re.
__device__ __forceinline__ cpx csqrt_(cpx z) {
  const float zr = fabsf(z.re), zi = z.im;
  const float len_sq = fmaxf(zr * zr + zi * zi, 1e-30f);
  const float inv_len = 1.0f / sqrtf(len_sq);
  const float ur = zr * inv_len + 1.0f, ui = zi * inv_len;
  const float ur_len_sq = fmaxf(ur * ur + ui * ui, 1e-30f);
  const float norm = 1.0f / sqrtf(ur_len_sq * inv_len);
  const float rr = ur * norm, ri = ui * norm;
  const bool neg = z.re < 0.0f;
  return cx(neg ? ri : rr, neg ? rr : ri);
}

// One cubic root (ComplexAlgebra.glsl CubicRoot).
__device__ __forceinline__ cpx ccbrt(cpx z) {
  const float arg = atan2_poly(z.im, z.re) * (float)(1.0 / 3.0);
  const cpx cs = sincos_poly(arg);
  const float len_sq = fmaxf(z.re * z.re + z.im * z.im, 1e-30f);
  const float mag = expf(logf(len_sq) * (float)(1.0 / 6.0));
  return cx(cs.re * mag, cs.im * mag);
}

__device__ __forceinline__ void solve_quadratic_c(cpx A, cpx B, cpx C, cpx* roots) {
  const cpx inv_a = crcp(A);
  B = cscale(cmul(B, inv_a), 0.5f);
  C = cmul(C, inv_a);
  const cpx disc_root = csqrt_(csub(csq(B), C));
  roots[0] = csub(cscale(B, -1.0f), disc_root);
  roots[1] = cadd(cscale(B, -1.0f), disc_root);
}

__device__ __forceinline__ void solve_cubic_blinn_c(cpx A, cpx B, cpx C, cpx D, cpx* roots) {
  const cpx inv_a = crcp(A);
  B = cscale(cmul(B, inv_a), (float)(1.0 / 3.0));
  C = cscale(cmul(C, inv_a), (float)(1.0 / 3.0));
  D = cmul(D, inv_a);
  const cpx delta00 = csub(C, csq(B));
  const cpx delta01 = csub(D, cmul(C, B));
  const cpx delta11 = csub(cmul(B, D), csq(C));
  const cpx disc = csub(cscale(cmul(delta00, delta11), 4.0f), csq(delta01));
  const cpx depr_d = cadd(cscale(cmul(B, delta00), -2.0f), delta01);
  const cpx depr_c = delta00;
  cpx disc_root = csqrt_(cx(-disc.re, -disc.im));
  // faceforward(N, I, Nref) with N = I = disc_root, Nref = depr_d.
  const float flip = cdot(depr_d, disc_root) < 0.0f ? 1.0f : -1.0f;
  disc_root = cscale(disc_root, flip);
  const cpx cubed = csub(disc_root, depr_d);
  const cpx first = ccbrt(cscale(cubed, 0.5f));
  const cpx inv_first = crcp(first);
  // Primitive cube roots of unity.
  const cpx w1 = cx(-0.5f, (float)(-0.5 * 1.7320508075688772));
  const cpx w2 = cx(-0.5f, (float)(0.5 * 1.7320508075688772));
  roots[0] = csub(csub(first, cmul(depr_c, inv_first)), B);
  roots[1] = csub(csub(cmul(w1, first), cmul(depr_c, cmul(w2, inv_first))), B);
  roots[2] = csub(csub(cmul(w2, first), cmul(depr_c, cmul(w1, inv_first))), B);
}

__device__ __forceinline__ void solve_quartic_neumark_c(cpx A, cpx B, cpx C, cpx D, cpx E,
                                                        cpx* roots) {
  const cpx inv_a = crcp(A);
  B = cmul(B, inv_a);
  C = cmul(C, inv_a);
  D = cmul(D, inv_a);
  E = cmul(E, inv_a);
  const cpx P = cscale(C, -2.0f);
  const cpx Q = csub(cadd(csq(C), cmul(B, D)), cscale(E, 4.0f));
  const cpx R = csub(cadd(csq(D), cmul(csq(B), E)), cmul(cmul(B, C), D));
  cpx cr[3];
  solve_cubic_blinn_c(cx(1.0f, 0.0f), P, Q, R, cr);
  const bool take1 =
      (cr[1].re * cr[1].re + cr[1].im * cr[1].im) > (cr[0].re * cr[0].re + cr[0].im * cr[0].im);
  const cpx y = take1 ? cr[1] : cr[0];
  const cpx bb = csq(B);
  const cpx bb_fy = csub(bb, cscale(y, 4.0f));
  cpx tmp = csqrt_(bb_fy);
  const cpx G = cscale(cadd(B, tmp), 0.5f);
  const cpx g = cscale(csub(B, tmp), 0.5f);
  const cpx Z = csub(C, y);
  tmp = cdiv(csub(cscale(cmul(B, Z), 0.5f), D), tmp);
  const cpx H = cadd(cscale(Z, 0.5f), tmp);
  const cpx h = csub(cscale(Z, 0.5f), tmp);
  solve_quadratic_c(cx(1.0f, 0.0f), G, H, roots);
  solve_quadratic_c(cx(1.0f, 0.0f), g, h, roots + 2);
}

// Monotone arc parameter of a unit-circle point.
__device__ __forceinline__ float circle_to_parameter(cpx p) {
  float r = fabsf(p.im) - fabsf(p.re);
  r = p.re < 0.0f ? 2.0f - r : r;
  return p.im < 0.0f ? 6.0f - r : r;
}

__device__ __forceinline__ float root_weight_factor(float ref_param, float root_param,
                                                    float wzp_z, float wzp_w) {
  const float binary = root_param < ref_param ? 1.0f : 0.0f;
  const float linear = fminf(fmaxf(root_param * wzp_z + wzp_w, 0.0f), 1.0f);
  return binary + linear;
}

// k-th power (k = 1..N) of the unit-circle point at phase wzp_y * (dw + 1),
// by repeated complex multiplication (MomentOIT.glsl:338-355).
template <int N>
__device__ __forceinline__ void circle_powers(float dw, float wzp_y, cpx* powers) {
  const cpx c = sincos_poly(wzp_y * (dw + 1.0f));
  powers[0] = c;
#pragma unroll
  for (int k = 1; k < N; ++k) powers[k] = cmul(powers[k - 1], c);
}

// sum_k Re(b_k * p_k), p the polynomial through (z_i, f_i) (real f_i):
// Newton divided differences expanded to monomial coefficients.
template <int N>  // N = n + 1 nodes
__device__ __forceinline__ float newton_eval(const cpx* zs, const float* fs, const cpx* bs) {
  cpx table[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) table[0][i] = cx(fs[i], 0.0f);
#pragma unroll
  for (int j = 1; j < N; ++j)
#pragma unroll
    for (int i = 0; i < N - j; ++i)
      table[j][i] = cdiv(csub(table[j - 1][i + 1], table[j - 1][i]), csub(zs[i + j], zs[i]));
  // In place: before step j, poly holds len = N - 1 - j coefficients.
  cpx poly[N];
  poly[0] = table[N - 1][0];
#pragma unroll
  for (int j = N - 2; j >= 0; --j) {
    const int len = N - 1 - j;
    const cpx z = zs[j];
    poly[len] = poly[len - 1];
#pragma unroll
    for (int i = N - 1; i > 0; --i)
      if (i < len) poly[i] = csub(poly[i - 1], cmul(poly[i], z));
    poly[0] = csub(table[j][0], cmul(poly[0], z));
  }
  float ws = bs[0].re * poly[0].re - bs[0].im * poly[0].im;
#pragma unroll
  for (int k = 1; k < N; ++k) ws = ws + (bs[k].re * poly[k].re - bs[k].im * poly[k].im);
  return ws;
}

// n complex moments (n = 2, 3, 4: NUM_MOMENTS 4, 6, 8) -> transmittance at
// `depth`, in two parts for a caller that evaluates one pixel's moments at
// many depths, as moment_math.cuh splits the power moments:
// `trig_moment_setup` depends on the moments only (trig_b[k] = (Re, Im) of
// moment k + 1, normalized by b0; the biased moments and the LDL* factors of
// their Hermitian Toeplitz matrix, entry (i, j) = b[i - j]),
// `transmittance_trig` solves (LDL*) c = the powers of the circle point at
// the query depth and weights the roots. Together they do the operations of
// trig_moment_math.py's _transmittance_trig in the same order.
template <int n>
struct MomentsTrig {
  float b0;
  cpx bs[n + 1];
  cpx L[n + 1][n + 1];  // strictly lower part
  float invD[n + 1];
};

template <int n>
__device__ __forceinline__ MomentsTrig<n> trig_moment_setup(float b0, const cpx* trig_b,
                                                            float bias) {
  MomentsTrig<n> m;
  m.b0 = b0;
  const float scale = 1.0f - bias;
  m.bs[0] = cx(1.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < n; ++k) m.bs[k + 1] = cscale(trig_b[k], scale);

  const float eps = 1e-12f;
  float D[n + 1];
  D[0] = m.bs[0].re;
  m.invD[0] = 1.0f / fmaxf(D[0], eps);
#pragma unroll
  for (int i = 1; i <= n; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      cpx acc = m.bs[i - j];
#pragma unroll
      for (int k = 0; k < j; ++k)
        acc = csub(acc, cscale(cmul(m.L[i][k], cconj(m.L[j][k])), D[k]));
      m.L[i][j] = cscale(acc, m.invD[j]);
    }
    float di = m.bs[0].re;
#pragma unroll
    for (int k = 0; k < i; ++k)
      di = di - D[k] * (m.L[i][k].re * m.L[i][k].re + m.L[i][k].im * m.L[i][k].im);
    D[i] = di;
    m.invD[i] = 1.0f / (fabsf(di) > eps ? di : (di >= 0.0f ? eps : -eps));
  }
  return m;
}

template <int n>
__device__ __forceinline__ float transmittance_trig(const MomentsTrig<n>& m, float depth,
                                                    float overestimation, float wzp_y,
                                                    float wzp_z, float wzp_w) {
  const cpx cp = sincos_poly(wzp_y * (depth + 1.0f));
  cpx c[n + 1];
  c[0] = cx(1.0f, 0.0f);
#pragma unroll
  for (int k = 1; k <= n; ++k) c[k] = cmul(c[k - 1], cp);
#pragma unroll
  for (int i = 1; i <= n; ++i)  // forward substitution
#pragma unroll
    for (int j = 0; j < i; ++j) c[i] = csub(c[i], cmul(m.L[i][j], c[j]));
#pragma unroll
  for (int i = 0; i <= n; ++i) c[i] = cscale(c[i], m.invD[i]);
#pragma unroll
  for (int i = n - 1; i >= 0; --i)  // backward substitution (conjugates)
#pragma unroll
    for (int j = i + 1; j <= n; ++j) c[i] = csub(c[i], cmul(cconj(m.L[j][i]), c[j]));

  cpx coeffs[n + 1];
#pragma unroll
  for (int i = 0; i <= n; ++i) coeffs[i] = cconj(c[i]);
  cpx zs[n + 1];
  zs[0] = cp;
  if constexpr (n == 2) {
    solve_quadratic_c(coeffs[2], coeffs[1], coeffs[0], zs + 1);
  } else if constexpr (n == 3) {
    solve_cubic_blinn_c(coeffs[3], coeffs[2], coeffs[1], coeffs[0], zs + 1);
  } else {
    solve_quartic_neumark_c(coeffs[4], coeffs[3], coeffs[2], coeffs[1], coeffs[0], zs + 1);
  }

  const float depth_param = circle_to_parameter(cp);
  float fs[n + 1];
  fs[0] = overestimation * 1.0f;
#pragma unroll
  for (int k = 1; k <= n; ++k)
    fs[k] = root_weight_factor(depth_param, circle_to_parameter(zs[k]), wzp_z, wzp_w);
  const float weight_sum = newton_eval<n + 1>(zs, fs, m.bs);
  return expf(-m.b0 * weight_sum);
}
