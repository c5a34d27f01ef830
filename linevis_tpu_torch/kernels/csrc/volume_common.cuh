// Device helpers of the volume kernels (vpt_tracking.cu, density_march.cu):
// the twins of `kernels/volume_common.py`, which their plain PyTorch
// versions use. Each rounds its operations in the same order (the files
// build with --fmad=false, and divide with IEEE division), so a kernel and
// its plain version agree bit for bit on the card.
#pragma once

#include <cuda_runtime.h>

#define VOL_TWO_PI 6.283185307179586f
#define VOL_BIG 1000.0f
#define VOL_BRICK 8  // the grids' bricks: VOL_BRICK^3 voxels, 2 KB (brick_at's shifts)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float v3_at(const V3& v, int i) { return i == 0 ? v.x : (i == 1 ? v.y : v.z); }

// Slab test of x + t w against [bmin, bmax] (`volume_common.box_intersect`).
__device__ __forceinline__ bool box_intersect(const float* bmin, const float* bmax, V3 x, V3 w,
                                              float& t_min, float& t_max) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float xi = v3_at(x, i), wi = v3_at(w, i);
    const bool small = fabsf(wi) <= 1e-6f;
    const float inv = 1.0f / wi;
    float t0 = (bmin[i] - xi) * inv;
    float t1 = (bmax[i] - xi) * inv;
    const bool in_slab = (xi >= bmin[i]) && (xi <= bmax[i]);
    if (small) {
      t0 = in_slab ? -VOL_BIG : VOL_BIG;
      t1 = VOL_BIG;
    }
    const float a = fminf(t0, t1), b = fmaxf(t0, t1);
    lo = i == 0 ? a : fmaxf(lo, a);
    hi = i == 0 ? b : fminf(hi, b);
  }
  t_min = fmaxf(lo, 0.0f);
  t_max = hi;
  return (hi >= t_min) && (hi >= 0.0f);
}

__device__ __forceinline__ V3 v3_cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 v3_normalized(V3 v) {
  const float n = fmaxf(sqrtf(v.x * v.x + v.y * v.y + v.z * v.z), 1e-12f);
  return V3{v.x / n, v.y / n, v.z / n};
}

__device__ __forceinline__ void orthonormal_basis(V3 d, V3& b, V3& t) {
  const bool near_z = fabsf(d.z) >= 0.999f;
  const V3 other{near_z ? 1.0f : 0.0f, 0.0f, near_z ? 0.0f : 1.0f};
  b = v3_normalized(v3_cross(other, d));
  t = v3_normalized(v3_cross(d, b));
}

// Henyey-Greenstein (or isotropic) constants: `volume_common.phase_constants`.
struct Phase {
  int isotropic;
  float one_minus_g2, one_minus_g, two_g, half_over_g, one_plus_g2;
};

__device__ __forceinline__ V3 sample_phase(float u1, float u2, const Phase& pc, V3 d) {
  if (pc.isotropic) {
    const float r2 = u2 * 2.0f - 1.0f;
    const float s = sqrtf(fmaxf(1.0f - r2 * r2, 0.0f));
    const float ang = u1 * VOL_TWO_PI;
    const float i0 = cosf(ang) * s, i1 = sinf(ang) * s;
    const V3 nd{-d.x, -d.y, -d.z};
    V3 b, t;
    orthonormal_basis(nd, b, t);
    return V3{b.x * i0 + t.x * i1 + nd.x * r2, b.y * i0 + t.y * i1 + nd.y * r2,
              b.z * i0 + t.z * i1 + nd.z * r2};
  }
  const float t_cdf = pc.one_minus_g2 / (pc.one_minus_g + pc.two_g * u2);
  const float cos_t = pc.half_over_g * (pc.one_plus_g2 - t_cdf * t_cdf);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const float phi = u1 * VOL_TWO_PI;
  const float ss = sin_t * sinf(phi), sc = sin_t * cosf(phi);
  V3 b, t;
  orthonormal_basis(d, b, t);
  return V3{ss * b.x + sc * t.x + cos_t * d.x, ss * b.y + sc * t.y + cos_t * d.y,
            ss * b.z + sc * t.z + cos_t * d.z};
}

// Voxel (z, y, x) of the grid in VOL_BRICK^3 bricks (`grid_bricks`:
// brick-major, each brick z, y, x; nyb, nxb bricks a row and a column).
__device__ __forceinline__ float brick_at(const float* __restrict__ g, int nyb, int nxb, int z,
                                          int y, int x) {
  const long long b = ((long long)(z >> 3) * nyb + (y >> 3)) * nxb + (x >> 3);
  return __ldg(g + (b << 9) + ((z & 7) << 6) + ((y & 7) << 3) + (x & 7));
}

// The cell of a trilinear sample at p in [0, 1]^3, clamped, as
// `trilinear` forms it: its first voxel and the weights along each axis.
struct VolCell {
  int x0, y0, z0;
  float tx, ty, tz;
};

__device__ __forceinline__ VolCell vol_cell(int nz, int ny, int nx, float px, float py, float pz) {
  const float fx = fminf(fmaxf(px, 0.0f), 1.0f) * (float)(nx - 1);
  const float fy = fminf(fmaxf(py, 0.0f), 1.0f) * (float)(ny - 1);
  const float fz = fminf(fmaxf(pz, 0.0f), 1.0f) * (float)(nz - 1);
  VolCell c;
  c.x0 = min(max((int)floorf(fx), 0), nx - 2);
  c.y0 = min(max((int)floorf(fy), 0), ny - 2);
  c.z0 = min(max((int)floorf(fz), 0), nz - 2);
  c.tx = fx - (float)c.x0;
  c.ty = fy - (float)c.y0;
  c.tz = fz - (float)c.z0;
  return c;
}

// `trilinear`'s loads and arithmetic on cell c of the dense [nz, ny, nx] grid.
__device__ __forceinline__ float sample_cell(const float* __restrict__ g, int ny, int nx,
                                             const VolCell& c) {
  const float* p = g + ((long long)c.z0 * ny + c.y0) * nx + c.x0;
  const long long sy = nx, sz = (long long)ny * nx;
  const float c00 = __ldg(p) * (1.0f - c.tx) + __ldg(p + 1) * c.tx;
  const float c01 = __ldg(p + sy) * (1.0f - c.tx) + __ldg(p + sy + 1) * c.tx;
  const float c10 = __ldg(p + sz) * (1.0f - c.tx) + __ldg(p + sz + 1) * c.tx;
  const float c11 = __ldg(p + sz + sy) * (1.0f - c.tx) + __ldg(p + sz + sy + 1) * c.tx;
  const float c0 = c00 * (1.0f - c.ty) + c01 * c.ty;
  const float c1 = c10 * (1.0f - c.ty) + c11 * c.ty;
  return c0 * (1.0f - c.tz) + c1 * c.tz;
}

// Trilinear sample of a [nz, ny, nx] grid at p in [0, 1]^3, clamped
// (`volume_common.trilinear`).
__device__ __forceinline__ float trilinear(const float* __restrict__ g, int nz, int ny, int nx,
                                           float px, float py, float pz) {
  return sample_cell(g, ny, nx, vol_cell(nz, ny, nx, px, py, pz));
}

// `trilinear`'s arithmetic on cell c of the bricked grid (nyb, nxb bricks a
// row and a column): the same voxels, so the same value. A sample's eight
// voxels then lie in two 128-byte lines where the bricks hold them (four in
// the linear layout).
__device__ __forceinline__ float sample_cell_bricked(const float* __restrict__ g, int nyb, int nxb,
                                                     const VolCell& c) {
  const float c00 = brick_at(g, nyb, nxb, c.z0, c.y0, c.x0) * (1.0f - c.tx) +
                    brick_at(g, nyb, nxb, c.z0, c.y0, c.x0 + 1) * c.tx;
  const float c01 = brick_at(g, nyb, nxb, c.z0, c.y0 + 1, c.x0) * (1.0f - c.tx) +
                    brick_at(g, nyb, nxb, c.z0, c.y0 + 1, c.x0 + 1) * c.tx;
  const float c10 = brick_at(g, nyb, nxb, c.z0 + 1, c.y0, c.x0) * (1.0f - c.tx) +
                    brick_at(g, nyb, nxb, c.z0 + 1, c.y0, c.x0 + 1) * c.tx;
  const float c11 = brick_at(g, nyb, nxb, c.z0 + 1, c.y0 + 1, c.x0) * (1.0f - c.tx) +
                    brick_at(g, nyb, nxb, c.z0 + 1, c.y0 + 1, c.x0 + 1) * c.tx;
  const float c0 = c00 * (1.0f - c.ty) + c01 * c.ty;
  const float c1 = c10 * (1.0f - c.ty) + c11 * c.ty;
  return c0 * (1.0f - c.tz) + c1 * c.tz;
}

// `volume_common.cuh:trilinear` on the bricked grid.
__device__ __forceinline__ float trilinear_bricked(const float* __restrict__ g, int nz, int ny,
                                                   int nx, float px, float py, float pz) {
  const int nyb = (ny + VOL_BRICK - 1) / VOL_BRICK, nxb = (nx + VOL_BRICK - 1) / VOL_BRICK;
  return sample_cell_bricked(g, nyb, nxb, vol_cell(nz, ny, nx, px, py, pz));
}

// A block-sparse grid (`scene/sparse_grid.py:SparseGrid`): `bricks` [n + 1,
// b + 1, b + 1, b + 1] with a one-voxel apron on the high side, `table`
// [Zb, Yb, Xb] int32 the brick of each block (0: the all-zero brick).
struct SparseBricks {
  const float* bricks;
  const int* table;
  int block, nyb, nxb;
};

// `SparseGrid.sample`'s loads and arithmetic on cell c: the brick of the
// cell's first voxel holds the whole stencil (its apron), and the lerps are
// `sample_cell`'s, so the value is the dense grid's.
__device__ __forceinline__ float sample_cell_sparse(const SparseBricks& g, const VolCell& c) {
  const int b = g.block, b1 = g.block + 1;
  const int bi = __ldg(g.table + ((long long)(c.z0 / b) * g.nyb + c.y0 / b) * g.nxb + c.x0 / b);
  const long long sy = b1, sz = (long long)b1 * b1;
  const float* p = g.bricks + (long long)bi * sz * b1 + (c.z0 % b) * sz + (c.y0 % b) * sy + c.x0 % b;
  const float c00 = __ldg(p) * (1.0f - c.tx) + __ldg(p + 1) * c.tx;
  const float c01 = __ldg(p + sy) * (1.0f - c.tx) + __ldg(p + sy + 1) * c.tx;
  const float c10 = __ldg(p + sz) * (1.0f - c.tx) + __ldg(p + sz + 1) * c.tx;
  const float c11 = __ldg(p + sz + sy) * (1.0f - c.tx) + __ldg(p + sz + sy + 1) * c.tx;
  const float c0 = c00 * (1.0f - c.ty) + c01 * c.ty;
  const float c1 = c10 * (1.0f - c.ty) + c11 * c.ty;
  return c0 * (1.0f - c.tz) + c1 * c.tz;
}

// `SparseGrid.sample` at p in [0, 1]^3 of a grid of [nz, ny, nx] voxels.
__device__ __forceinline__ float trilinear_sparse(const SparseBricks& g, int nz, int ny, int nx,
                                                  float px, float py, float pz) {
  return sample_cell_sparse(g, vol_cell(nz, ny, nx, px, py, pz));
}

__device__ __forceinline__ float smoothstep_f(float e0, float e1, float span, float x) {
  const float t = fminf(fmaxf((x - e0) / span, 0.0f), 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

// Procedural sky plus the Phong sun lobe (`volume_common.sky_light`).
__device__ __forceinline__ V3 sky_light(V3 w, const float* sun_dir, const float* sun_ic) {
  const float C[5][3] = {{0.1f, 0.05f, 0.01f}, {0.01f, 0.05f, 0.2f}, {0.8f, 0.9f, 1.0f},
                         {0.1f, 0.3f, 1.0f}, {0.01f, 0.1f, 0.7f}};
  const float E[5] = {-1.0f, -0.1f, 0.0f, 0.4f, 1.0f};
  // The edges' spans as the Python side rounds them: float32(e1 - e0) of
  // the double edges.
  const float S[4] = {0.9f, 0.1f, 0.4f, 0.6f};
  float col[3] = {C[0][0], C[0][1], C[0][2]};
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    const float s = smoothstep_f(E[i - 1], E[i], S[i - 1], w.y);
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = col[c] * (1.0f - s) + C[i][c] * s;
  }
  const float d = fmaxf(w.x * sun_dir[0] + w.y * sun_dir[1] + w.z * sun_dir[2], 0.0f);
  const float d2 = d * d;
  const float d4 = d2 * d2;
  const float d10 = d4 * d4 * d2;
  const float norm = 1.7507044f;  // float32((10 + 1) / (2 pi))
  return V3{col[0] + sun_ic[0] * d10 * norm, col[1] + sun_ic[1] * d10 * norm,
            col[2] + sun_ic[2] * d10 * norm};
}

// Bilinear lat-long lookup of an [he, we, 3] environment map
// (`volume_common.env_map_sample`).
__device__ __forceinline__ V3 env_map_sample(const float* __restrict__ env, int he, int we, V3 w,
                                             float intensity) {
  const float u = atan2f(w.z, w.x) / 6.2831855f + 0.5f;
  const float v = -asinf(fminf(fmaxf(w.y, -1.0f), 1.0f)) / 3.1415927f + 0.5f;
  const float fx = u * (float)we - 0.5f;
  const float fy = v * (float)he - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float tx = fx - x0, ty = fy - y0;
  int x0i = ((int)x0) % we;
  if (x0i < 0) x0i += we;
  const int x1i = (x0i + 1) % we;
  const int y0i = min(max((int)y0, 0), he - 1);
  const int y1i = min(max(y0i + 1, 0), he - 1);
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = env[(y0i * we + x0i) * 3 + c] * (1.0f - tx) + env[(y0i * we + x1i) * 3 + c] * tx;
    const float bot = env[(y1i * we + x0i) * 3 + c] * (1.0f - tx) + env[(y1i * we + x1i) * 3 + c] * tx;
    out[c] = intensity * (top * (1.0f - ty) + bot * ty);
  }
  return V3{out[0], out[1], out[2]};
}
