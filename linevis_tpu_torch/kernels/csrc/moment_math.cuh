// Power-moment transmittance reconstruction for MBOIT, as device code.
//
// One for one with linevis_tpu_torch/kernels/moment_math.py (the JAX
// package's linevis_tpu/kernels/moment_math.py; the reference's
// MomentMath.glsl, the published CC0 code of Munstermann, Krumpen, Klein,
// Peters, "Moment-Based Order-Independent Transparency", i3D 2018), except
// that each transmittance_at_depth_N is split into a per-pixel part,
// moment_setup_N, and a per-depth part, transmittance_N (below). Every
// `torch.where` of the plain version is a select here, both sides computed;
// the same degree-11 atan polynomial, the same safe reciprocal
// (sign(x) / max(|x|, eps): the reciprocal of 0 is 0). Built with
// --fmad=false and without fast math: IEEE division and sqrt, and the
// libm-accurate cosf/sinf/expf/logf that PyTorch's CUDA kernels call, so a
// function here rounds as its plain counterpart does on the card.
#pragma once

#include <cuda_runtime.h>

#define MM_HALF_PI 1.5707963267948966f
#define MM_PI 3.141592653589793f
#define MM_S3 0.8660254037844386f  // sqrt(3)/2

__device__ __forceinline__ float mm_sign(float x) {
  // torch.sign: 0 for 0 and NaN.
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float mm_safe_rcp(float x) {
  return mm_sign(x) / fmaxf(fabsf(x), 1e-12f);
}

__device__ __forceinline__ float mm_atan_unit(float t) {
  const float z = t * t;
  return t * (0.99997726f +
              z * (-0.33262347f +
                   z * (0.19354346f + z * (-0.11643287f + z * (0.05265332f + z * (-0.01172120f))))));
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool swap = ay > ax;
  const float num = swap ? ax : ay;
  const float den = swap ? ay : ax;
  const float t = num / fmaxf(den, 1e-30f);
  float r = mm_atan_unit(t);
  r = swap ? MM_HALF_PI - r : r;
  r = x < 0.0f ? MM_PI - r : r;
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float mm_mix(float a, float b, float t) { return a + (b - a) * t; }

__device__ __forceinline__ float mm_step(bool c) { return c ? 1.0f : 0.0f; }

// Two real roots of ca*x^2 + cb*x + cc (MomentMath.glsl:25-42).
__device__ __forceinline__ void mm_solve_quadratic(float ca, float cb, float cc, float& x1,
                                                   float& x2) {
  const float b = cb * 0.5f;
  const float tmp = sqrtf(fmaxf(b * b - ca * cc, 0.0f));
  const bool pos = b >= 0.0f;
  x1 = pos ? -cc * mm_safe_rcp(b + tmp) : (-b + tmp) * mm_safe_rcp(ca);
  x2 = pos ? (-b - tmp) * mm_safe_rcp(ca) : cc * mm_safe_rcp(-b + tmp);
}

// Three real roots of c0 + c1 x + c2 x^2 + c3 x^3 (MomentMath.glsl:48-78).
__device__ __forceinline__ void mm_solve_cubic(float c0, float c1, float c2, float c3, float& z1,
                                               float& z2, float& z3) {
  const float inv = mm_safe_rcp(c3);
  const float a0 = c0 * inv;
  const float a1 = (c1 * inv) / 3.0f;
  const float a2 = (c2 * inv) / 3.0f;
  const float dx = -a2 * a2 + a1;
  const float dy = -a1 * a2 + a0;
  const float dz = a2 * a0 - a1 * a1;
  const float disc = 4.0f * dx * dz - dy * dy;
  const float dep_x = -2.0f * a2 * dx + dy;
  const float dep_y = dx;
  const float theta = atan2_poly(sqrtf(fmaxf(disc, 0.0f)), -dep_x) / 3.0f;
  const float ct = cosf(theta);
  const float st = sinf(theta);
  const float r0 = ct;
  const float r1 = -0.5f * ct - MM_S3 * st;
  const float r2 = -0.5f * ct + MM_S3 * st;
  const float scale = 2.0f * sqrtf(fmaxf(-dep_y, 0.0f));
  z1 = scale * r0 - a2;
  z2 = scale * r1 - a2;
  z3 = scale * r2 - a2;
}

// Root of least magnitude of a cubic with three real roots
// (MomentMath.glsl:83-99).
__device__ __forceinline__ float mm_solve_cubic_blinn_smallest(float c0, float c1, float c2,
                                                              float c3) {
  const float inv = mm_safe_rcp(c3);
  const float a0 = c0 * inv;
  const float a1 = (c1 * inv) / 3.0f;
  const float a2 = (c2 * inv) / 3.0f;
  const float dx = -a2 * a2 + a1;
  const float dy = -a2 * a1 + a0;
  const float dz = a2 * a0 - a1 * a1;
  const float disc = fmaxf(4.0f * dx * dz - dy * dy, 0.0f);
  const float dep_x = dz;
  const float dep_y = -a0 * dy + 2.0f * a1 * dz;
  const float theta = fabsf(atan2_poly(a0 * sqrtf(disc), -dep_y)) / 3.0f;
  const float st = sinf(theta);
  const float ct = cosf(theta);
  const float tmp = 2.0f * sqrtf(fmaxf(-dep_x, 0.0f));
  const float xx = tmp * ct;
  const float xy = tmp * (-0.5f * ct - MM_S3 * st);
  const bool use_x = (xx + xy) < 2.0f * a1;
  const float sy = use_x ? xx + a1 : xy + a1;
  return -a0 * mm_safe_rcp(sy);
}

// Four real roots of a quartic (MomentMath.glsl:104-152).
__device__ __forceinline__ void mm_solve_quartic_neumark(float c0, float c1, float c2, float c3,
                                                         float c4, float* roots) {
  const float inv = mm_safe_rcp(c4);
  const float B = c3 * inv;
  const float C = c2 * inv;
  const float D = c1 * inv;
  const float E = c0 * inv;

  const float P = -2.0f * C;
  const float Q = C * C + B * D - 4.0f * E;
  const float R = D * D + B * B * E - B * C * D;
  const float y = mm_solve_cubic_blinn_smallest(R, Q, P, 1.0f);

  const float BB = B * B;
  const float fy = 4.0f * y;
  const float BB_fy = BB - fy;
  const float Z = C - y;
  const float ZZ = Z * Z;
  const float fE = 4.0f * E;
  const float ZZ_fE = ZZ - fE;

  // Herbison-Evans heuristic picks between Neumark's two factorizations.
  const bool use_first = (y < 0.0f) || ((ZZ + fE) * BB_fy > ZZ_fE * (BB + fy));

  const float t1 = sqrtf(fmaxf(BB_fy, 0.0f));
  const float G1 = (B + t1) * 0.5f;
  const float g1 = (B - t1) * 0.5f;
  const float tt1 = (B * Z - 2.0f * D) * mm_safe_rcp(2.0f * t1);
  const float H1 = Z * 0.5f + tt1;
  const float h1 = Z * 0.5f - tt1;

  const float t2 = sqrtf(fmaxf(ZZ_fE, 0.0f));
  const float H2 = (Z + t2) * 0.5f;
  const float h2 = (Z - t2) * 0.5f;
  const float tt2 = (B * Z - 2.0f * D) * mm_safe_rcp(2.0f * t2);
  const float G2 = B * 0.5f + tt2;
  const float g2 = B * 0.5f - tt2;

  const float G = use_first ? G1 : G2;
  const float g = use_first ? g1 : g2;
  const float H = use_first ? H1 : H2;
  const float h = use_first ? h1 : h2;

  mm_solve_quadratic(1.0f, G, H, roots[0], roots[1]);
  mm_solve_quadratic(1.0f, g, h, roots[2], roots[3]);
}

__device__ __forceinline__ float mm_clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// 4, 6 and 8 power moments -> transmittance at `depth` (MomentMath.glsl:246-301,
// :305-385, :389-505), each in two parts for a caller that evaluates one
// pixel's moments at many depths: `moment_setup_N` depends on the moments
// only (b_even: (m2, m4, ...), b_odd: (m1, m3, ...), normalized by b0; the
// biased moments and the Cholesky factors of the moment matrix),
// `transmittance_N` is the part at one depth. Together they do the
// operations of moment_math.py's transmittance_at_depth_N in the same order,
// so they round alike.

struct Moments4 {
  float b0, b1, b2, L21, InvD11, D22;
};

__device__ __forceinline__ Moments4 moment_setup_4(float b0, const float* b_even,
                                                   const float* b_odd, float bias) {
  Moments4 m;
  m.b0 = b0;
  m.b1 = mm_mix(b_odd[0], 0.0f, bias);
  m.b2 = mm_mix(b_even[0], 0.375f, bias);
  const float b3 = mm_mix(b_odd[1], 0.0f, bias);
  const float b4 = mm_mix(b_even[1], 0.375f, bias);
  const float L21D11 = -m.b1 * m.b2 + b3;
  const float D11 = fmaxf(-m.b1 * m.b1 + m.b2, 1e-10f);
  m.InvD11 = 1.0f / D11;
  m.L21 = L21D11 * m.InvD11;
  const float sq_var = -m.b2 * m.b2 + b4;
  m.D22 = fmaxf(-L21D11 * m.L21 + sq_var, 1e-10f);
  return m;
}

__device__ __forceinline__ float transmittance_4(const Moments4& m, float depth,
                                                 float overestimation) {
  const float z0 = depth;
  float c0 = 1.0f;
  float c1 = z0 - m.b1;
  float c2 = z0 * z0 - m.b2 - m.L21 * c1;
  c1 = c1 * m.InvD11;
  c2 = c2 / m.D22;
  c1 = c1 - m.L21 * c2;
  c0 = c0 - c1 * m.b1 - c2 * m.b2;

  const float InvC2 = mm_safe_rcp(c2);
  const float p = c1 * InvC2;
  const float q = c0 * InvC2;
  const float D = p * p * 0.25f - q;
  const float r = sqrtf(fmaxf(D, 0.0f));
  const float z1 = -p * 0.5f - r;
  const float z2 = -p * 0.5f + r;

  const float f0 = overestimation;
  const float f1 = mm_step(z1 < z0);
  const float f2 = mm_step(z2 < z0);
  const float f01 = (f1 - f0) * mm_safe_rcp(z1 - z0);
  const float f12 = (f2 - f1) * mm_safe_rcp(z2 - z1);
  const float f012 = (f12 - f01) * mm_safe_rcp(z2 - z0);
  float p0 = f012;
  float p1 = p0;
  p0 = f01 - p0 * z1;
  const float p2 = p1;
  p1 = p0 - p1 * z0;
  p0 = f0 - p0 * z0;
  const float absorbance = p0 + m.b1 * p1 + m.b2 * p2;
  return mm_clamp01(expf(-m.b0 * absorbance));
}

struct Moments6 {
  float b0, b[3], L21, L31, L32, InvD11, InvD22, InvD33;
};

__device__ __forceinline__ Moments6 moment_setup_6(float b0, const float* b_even,
                                                   const float* b_odd, float bias) {
  float b[6];
  b[0] = mm_mix(b_odd[0], 0.0f, bias);
  b[1] = mm_mix(b_even[0], 0.48f, bias);
  b[2] = mm_mix(b_odd[1], 0.0f, bias);
  b[3] = mm_mix(b_even[1], 0.451f, bias);
  b[4] = mm_mix(b_odd[2], 0.0f, bias);
  b[5] = mm_mix(b_even[2], 0.45f, bias);
  Moments6 m;
  m.b0 = b0;
  m.b[0] = b[0];
  m.b[1] = b[1];
  m.b[2] = b[2];
  m.InvD11 = 1.0f / fmaxf(-b[0] * b[0] + b[1], 1e-10f);
  const float L21D11 = -b[0] * b[1] + b[2];
  m.L21 = L21D11 * m.InvD11;
  const float D22 = fmaxf(-L21D11 * m.L21 + (-b[1] * b[1] + b[3]), 1e-10f);
  const float L31D11 = -b[0] * b[2] + b[3];
  m.L31 = L31D11 * m.InvD11;
  m.InvD22 = 1.0f / D22;
  const float L32D22 = -L21D11 * m.L31 + (-b[1] * b[2] + b[4]);
  m.L32 = L32D22 * m.InvD22;
  const float D33 = fmaxf((-b[2] * b[2] + b[5]) - (L31D11 * m.L31 + L32D22 * m.L32), 1e-10f);
  m.InvD33 = 1.0f / D33;
  return m;
}

__device__ __forceinline__ float transmittance_6(const Moments6& m, float depth,
                                                 float overestimation) {
  const float* b = m.b;
  const float z0 = depth;
  float c0 = 1.0f;
  float c1 = z0;
  float c2 = c1 * z0;
  float c3 = c2 * z0;
  c1 = c1 - b[0];
  c2 = c2 - (m.L21 * c1 + b[1]);
  c3 = c3 - b[2] - m.L31 * c1 - m.L32 * c2;
  c1 = c1 * m.InvD11;
  c2 = c2 * m.InvD22;
  c3 = c3 * m.InvD33;
  c2 = c2 - m.L32 * c3;
  c1 = c1 - (m.L21 * c2 + m.L31 * c3);
  c0 = c0 - (b[0] * c1 + b[1] * c2 + b[2] * c3);

  float z1, z2, z3;
  mm_solve_cubic(c0, c1, c2, c3, z1, z2, z3);

  const float f0 = overestimation;
  const float f1 = 1.0f - mm_step(z1 > z0);
  const float f2 = 1.0f - mm_step(z2 > z0);
  const float f3 = 1.0f - mm_step(z3 > z0);
  const float f01 = (f1 - f0) * mm_safe_rcp(z1 - z0);
  const float f12 = (f2 - f1) * mm_safe_rcp(z2 - z1);
  const float f23 = (f3 - f2) * mm_safe_rcp(z3 - z2);
  const float f012 = (f12 - f01) * mm_safe_rcp(z2 - z0);
  const float f123 = (f23 - f12) * mm_safe_rcp(z3 - z1);
  const float f0123 = (f123 - f012) * mm_safe_rcp(z3 - z0);

  float p0 = -f0123 * z2 + f012;
  float p1 = f0123;
  float p2 = p1;
  p1 = p1 * (-z1) + p0;
  p0 = p0 * (-z1) + f01;
  const float p3 = p2;
  p2 = p2 * (-z0) + p1;
  p1 = p1 * (-z0) + p0;
  p0 = p0 * (-z0) + f0;
  const float absorbance = p0 + p1 * b[0] + p2 * b[1] + p3 * b[2];
  return mm_clamp01(expf(-m.b0 * absorbance));
}

struct Moments8 {
  float b0, b[4], L32, L42, L52, L43, L53, L54, InvD22, InvD33, InvD44, InvD55;
};

__device__ __forceinline__ Moments8 moment_setup_8(float b0, const float* b_even,
                                                   const float* b_odd, float bias) {
  float b[8];
  b[0] = mm_mix(b_odd[0], 0.0f, bias);
  b[1] = mm_mix(b_even[0], 0.75f, bias);
  b[2] = mm_mix(b_odd[1], 0.0f, bias);
  b[3] = mm_mix(b_even[1], 0.67666666666666664f, bias);
  b[4] = mm_mix(b_odd[2], 0.0f, bias);
  b[5] = mm_mix(b_even[2], 0.63f, bias);
  b[6] = mm_mix(b_odd[3], 0.0f, bias);
  b[7] = mm_mix(b_even[3], 0.60030303030303034f, bias);
  Moments8 m;
  m.b0 = b0;
#pragma unroll
  for (int i = 0; i < 4; ++i) m.b[i] = b[i];

  const float D22 = fmaxf(-b[0] * b[0] + b[1], 1e-10f);
  m.InvD22 = 1.0f / D22;
  const float L32D22 = -b[1] * b[0] + b[2];
  m.L32 = L32D22 * m.InvD22;
  const float L42D22 = -b[2] * b[0] + b[3];
  m.L42 = L42D22 * m.InvD22;
  const float L52D22 = -b[3] * b[0] + b[4];
  m.L52 = L52D22 * m.InvD22;

  const float D33 = fmaxf(-m.L32 * L32D22 + (-b[1] * b[1] + b[3]), 1e-10f);
  m.InvD33 = 1.0f / D33;
  const float L43D33 = -m.L42 * L32D22 + (-b[2] * b[1] + b[4]);
  m.L43 = L43D33 * m.InvD33;
  const float L53D33 = -m.L52 * L32D22 + (-b[3] * b[1] + b[5]);
  m.L53 = L53D33 * m.InvD33;

  const float D44 = fmaxf((-b[2] * b[2] + b[5]) - (m.L42 * L42D22 + m.L43 * L43D33), 1e-10f);
  m.InvD44 = 1.0f / D44;
  const float L54D44 = (-b[3] * b[2] + b[6]) - (m.L52 * L42D22 + m.L53 * L43D33);
  m.L54 = L54D44 * m.InvD44;

  const float D55 = fmaxf(
      (-b[3] * b[3] + b[7]) - (m.L52 * L52D22 + m.L53 * L53D33 + m.L54 * L54D44), 1e-10f);
  m.InvD55 = 1.0f / D55;
  return m;
}

__device__ __forceinline__ float transmittance_8(const Moments8& m, float depth,
                                                 float overestimation) {
  const float* b = m.b;
  const float z0 = depth;
  float c0 = 1.0f;
  float c1 = z0;
  float c2 = c1 * z0;
  float c3 = c2 * z0;
  float c4 = c3 * z0;
  c1 = c1 - b[0];
  c2 = c2 - (m.L32 * c1 + b[1]);
  c3 = c3 - b[2] - (m.L42 * c1 + m.L43 * c2);
  c4 = c4 - b[3] - (m.L52 * c1 + m.L53 * c2 + m.L54 * c3);
  c1 = c1 * m.InvD22;
  c2 = c2 * m.InvD33;
  c3 = c3 * m.InvD44;
  c4 = c4 * m.InvD55;
  c3 = c3 - m.L54 * c4;
  c2 = c2 - (m.L53 * c4 + m.L43 * c3);
  c1 = c1 - (m.L52 * c4 + m.L42 * c3 + m.L32 * c2);
  c0 = c0 - (b[3] * c4 + b[2] * c3 + b[1] * c2 + b[0] * c1);

  float z[4];
  mm_solve_quartic_neumark(c0, c1, c2, c3, c4, z);
  const float z1 = z[0], z2 = z[1], z3 = z[2], z4 = z[3];

  const float f0 = overestimation;
  const float f1 = mm_step(z1 <= z0);
  const float f2 = mm_step(z2 <= z0);
  const float f3 = mm_step(z3 <= z0);
  const float f4 = mm_step(z4 <= z0);
  const float f01 = (f1 - f0) * mm_safe_rcp(z1 - z0);
  const float f12 = (f2 - f1) * mm_safe_rcp(z2 - z1);
  const float f23 = (f3 - f2) * mm_safe_rcp(z3 - z2);
  const float f34 = (f4 - f3) * mm_safe_rcp(z4 - z3);
  const float f012 = (f12 - f01) * mm_safe_rcp(z2 - z0);
  const float f123 = (f23 - f12) * mm_safe_rcp(z3 - z1);
  const float f234 = (f34 - f23) * mm_safe_rcp(z4 - z2);
  const float f0123 = (f123 - f012) * mm_safe_rcp(z3 - z0);
  const float f1234 = (f234 - f123) * mm_safe_rcp(z4 - z1);
  const float f01234 = (f1234 - f0123) * mm_safe_rcp(z4 - z0);

  float P_0 = -f01234 * z3 + f0123;
  float P1 = f01234;
  float P2 = P1;
  P1 = -P1 * z2 + P_0;
  P_0 = -P_0 * z2 + f012;
  float P3 = P2;
  P2 = -P2 * z1 + P1;
  P1 = -P1 * z1 + P_0;
  P_0 = -P_0 * z1 + f01;
  const float P4 = P3;
  P3 = -P3 * z0 + P2;
  P2 = -P2 * z0 + P1;
  P1 = -P1 * z0 + P_0;
  P_0 = -P_0 * z0 + f0;
  const float absorbance = P_0 + P1 * b[0] + P2 * b[1] + P3 * b[2] + P4 * b[3];
  return mm_clamp01(expf(-m.b0 * absorbance));
}
