// The line density map's ray march for Hopper (sm_90a): kernel R4.
//
// Port-only: the JAX package writes the march as a `lax.scan` of 256 steps
// over all pixels at once (linevis_tpu/render/line_density_map.py:51-93,
// `render_line_density_map`); it reaches no pl.pallas_call. The kernel
// computes the same function per pixel, one thread a pixel: the jitter-free
// pixel ray from the camera basis, its clip to the field's box, the fixed
// steps of voxel_size / 10 (each a trilinear sample, the piecewise-linear
// transfer functions, alpha = 1 - exp(-a step attenuation) and the
// front-to-back blend), then the background under the remaining
// transmittance. Each operation rounds as in the plain version
// (`kernels/density_march.py:density_march_reference`), so the two agree
// bit for bit on the card.
//
// What bounds it (`tools/kernel_split.py --kernels r4` on the smoke's
// 1080p frame of the 512^3 line density field): 95.6% of the 149 M steps
// lie in empty bricks and add nothing; of the rest, the few rays that cross
// occupied bricks for all their 256 steps, one step after another, so the
// kernel lasts as long as its heaviest blocks (latency, not throughput). So:
//  - with SKIP, steps whose cell can add nothing take no sample (below),
//    and runs of them are jumped over;
//  - up to DM_BATCH consecutive steps sample together: their loads in
//    flight at once and their transfer functions interleaved, then the
//    blend takes them in order;
//  - each warp marches an 8x4 pixel block (four warps a 16x8 tile), so that
//    its rays sample and skip alike;
//  - the field stays dense: in 8^3 bricks (`volume_common.grid_bricks`, as
//    R3 reads it) only the launches without SKIP, off the main path, ran
//    faster (10-22%), which does not pay for a second copy of the field
//    (537 MB at 512^3); with SKIP they ran slower;
//  - where the box's extents are powers of two (template argument POW2),
//    the grid coordinates multiply by the extents' reciprocals: the same
//    real number rounded once, so the same float as the IEEE division;
//  - each transfer function finds its last segment holding the density
//    first and then divides once (`tf_eval_last`), its table in shared
//    memory where it fits (DM_MAX_TF floats, ~450 colour points), else read
//    from global memory.
//
// Empty-space skipping, and why it is exact. `volume_common.brick_occupancy`
// marks a brick empty when each voxel of it and of its one-voxel apron on
// the high side of each axis is in [EMPTY_FLOOR, 0] (NaN counts as
// occupied): every cell whose first voxel lies in the brick then reads
// only such voxels. Its trilinear value is then a sum of non-positive
// finite products, so in [-8e30, 0] and never NaN, and clamp01 maps it to
// +0 or -0. The wrapper switches SKIP on only where the opacity transfer
// function is exactly 0 at +0 and -0 and never negative, every colour of
// its table is finite, the step is finite and > 0, and the attenuation
// finite and >= 0 (`skip_allowed`). Then every step's alpha lies in [0, 1]
// (or is NaN, which then stays in every channel), so 1 - acc_a stays
// finite, and such a step's plain arithmetic gives alpha = 1 - expf(-(+-0))
// = +0 and w = +-0, and acc + w * rgb = acc (acc starts at +0 and is never
// -0): it adds exactly nothing, and skipping it changes no bit. A step is
// skipped only if its own cell, from the same clamped coordinates as the
// sample's (`vol_cell`), lies in an empty brick.
// Jumps: t_k = t_near + (k + 0.5f) step is non-decreasing in k, and each
// operation from t to a cell index (multiply, add, subtract, the division
// or the reciprocal's multiply by a positive extent, the clamps, floorf,
// the shift) is monotone, so each brick coordinate of step k is monotone in
// k. Two steps k < kc in the same brick therefore hold every step between
// them in that brick. From a step in an empty brick the kernel estimates
// the last step kc still in it (the ray as a line in voxel units), computes
// kc's cell exactly, and jumps past kc only if kc's brick is the same;
// otherwise it moves one step on. Steps at or past t_far add nothing
// (alpha 0 in the plain version), so the march stops at the first one, or
// at a verified kc that is past it. Each step the kernel does take keeps
// t = t_near + (k + 0.5f) step with its own k.
// That stop at t_far, with or without SKIP, rests on the same ground: the
// plain version steps on until the frame's last ray leaves its box, with
// alpha 0, which adds nothing where the colours are finite and 1 - acc_a
// is. Where they are not (a negative attenuation or opacity that overflows
// alpha to -inf, a colour of inf) the two may differ in NaN and inf.
#include <cuda_runtime.h>

#include <cmath>
#include <cstring>

#include "capsule_common.cuh"
#include "volume_common.cuh"

#define DM_TW 8   // a warp's pixel block: DM_TW x DM_TH
#define DM_TH 4
#define DM_BW 16  // a block's tile: DM_BW x DM_BH, four warps
#define DM_BH 8
#define DM_THREADS 128
#define DM_MIN_BLOCKS 4  // resident blocks an SM asked of ptxas (at most 128 registers)
#define DM_BATCH 4       // steps that sample together
#define DM_MAX_TF 4096   // floats of the transfer-function tables in shared memory

// prm: [0-2] b_min, [3-5] b_max, [6-8] extent, [9-11] ray origin, [12-20]
// the row-major ray basis (component c of column k at 3c + k), [21] step,
// [22] attenuation, [23] 2 / width, [24] 2 / height, [25-28] background.
// inv: the extents' reciprocals (used where POW2). For the jumps' estimate
// only: scale, voxels per unit length along each axis, and 1 / step.
struct DmPrm {
  float v[29];
  float inv[3];
  float scale[3];
  float inv_step;
};

// `tf_eval` of capsule_common.cuh on B values at once, each with the last
// segment that holds it found first, then one division: later segments win
// at shared endpoints there, so this is the value its last write leaves.
template <int NCH, int B>
__device__ __forceinline__ void tf_eval_last(const float* g, int npts, const float* x,
                                             float (*out)[NCH]) {
  float xc[B];
  int j[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    xc[b] = clamp01(x[b]);
    j[b] = -1;
  }
  const float* seg = g + NCH;
  for (int k = 0; k + 1 < npts; ++k, seg += 3 + 2 * NCH) {
    const float p0 = seg[0], p1 = seg[1];
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (xc[b] >= p0 && xc[b] <= p1) j[b] = k;
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    if (j[b] < 0) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) out[b][c] = g[c];
    } else {
      const float* sg = g + NCH + j[b] * (3 + 2 * NCH);
      const float w = (xc[b] - sg[0]) / sg[2];
#pragma unroll
      for (int c = 0; c < NCH; ++c) out[b][c] = sg[3 + c] + w * sg[3 + NCH + c];
    }
  }
}

// The cell of step k's sample: t, the grid coordinates as the plain
// version forms them ((o + t d - b_min) / extent), then `vol_cell`.
template <bool POW2>
__device__ __forceinline__ VolCell step_cell(const DmPrm& P, const float* d, float t, int nz,
                                             int ny, int nx) {
  float tex[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rel = P.v[9 + c] + t * d[c] - P.v[c];
    tex[c] = POW2 ? rel * P.inv[c] : rel / P.v[6 + c];
  }
  return vol_cell(nz, ny, nx, tex[0], tex[1], tex[2]);
}

__device__ __forceinline__ int brick_of(const VolCell& c, int nyb, int nxb) {
  return ((c.z0 >> 3) * nyb + (c.y0 >> 3)) * nxb + (c.x0 >> 3);
}

template <bool POW2, bool SKIP>
__global__ void __launch_bounds__(DM_THREADS, DM_MIN_BLOCKS)
density_march_kernel(const float* __restrict__ field, const unsigned char* __restrict__ occ,
                     int nz, int ny, int nx, int width, int height, int n_steps,
                     const __grid_constant__ DmPrm P, const float* __restrict__ tf, int tf_len,
                     float4* __restrict__ out) {
  extern __shared__ float s_tf[];
  const bool tf_shared = tf_len <= DM_MAX_TF;  // else read from global memory
  if (tf_shared)
    for (int j = threadIdx.x; j < tf_len; j += DM_THREADS) s_tf[j] = tf[j];
  __syncthreads();
  const float* tab = tf_shared ? s_tf : tf;
  const int tiles_x = (width + DM_BW - 1) / DM_BW;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int px = (blockIdx.x % tiles_x) * DM_BW + (w & 1) * DM_TW + l % DM_TW;
  const int py = (blockIdx.x / tiles_x) * DM_BH + (w >> 1) * DM_TH + l / DM_TW;
  if (px >= width || py >= height) return;
  const float u = ((float)px + 0.5f) * P.v[23] - 1.0f;
  const float v = 1.0f - ((float)py + 0.5f) * P.v[24];
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    d[c] = P.v[12 + 3 * c] * u + P.v[13 + 3 * c] * v + P.v[14 + 3 * c];
  const float n = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = d[c] / n;
    const float inv = 1.0f / (fabsf(d[c]) < 1e-9f ? 1e-9f : d[c]);
    const float t0 = (P.v[c] - P.v[9 + c]) * inv;
    const float t1 = (P.v[3 + c] - P.v[9 + c]) * inv;
    lo = c == 0 ? fminf(t0, t1) : fmaxf(lo, fminf(t0, t1));
    hi = c == 0 ? fmaxf(t0, t1) : fminf(hi, fmaxf(t0, t1));
  }
  const float t_near = fmaxf(lo, 0.0f), t_far = hi;
  const float step = P.v[21], att = P.v[22];
  const int nc = (int)tab[0], no = (int)tab[1];
  const float* tf_c = tab + 2;
  const float* tf_o = tf_c + 3 + (nc - 1) * 9;
  const int nyb = (ny + VOL_BRICK - 1) / VOL_BRICK, nxb = (nx + VOL_BRICK - 1) / VOL_BRICK;
  // The jumps' estimate only (never a result): the ray as a line h + t g in
  // voxel units, rg ~ 1 / g (0 where g is).
  float h[3], rg[3];
  if (SKIP) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = d[c] * P.scale[c];
      h[c] = (P.v[9 + c] - P.v[c]) * P.scale[c];
      rg[c] = g == 0.0f ? 0.0f : __fdividef(1.0f, g);
    }
  }
  float acc[3] = {0.0f, 0.0f, 0.0f}, acc_a = 0.0f;
  int k = t_far > t_near ? 0 : n_steps;
  while (k < n_steps) {
    const float t = t_near + ((float)k + 0.5f) * step;
    if (!(t < t_far)) break;  // alpha 0 from here on: nothing more adds
    const VolCell cell = step_cell<POW2>(P, d, t, nz, ny, nx);
    const int b = brick_of(cell, nyb, nxb);
    if (SKIP) {
      if (__ldg(occ + b) == 0) {
        // The last step the line puts in brick b, less a margin.
        const int bc[3] = {cell.x0 >> 3, cell.y0 >> 3, cell.z0 >> 3};
        float t_exit = INFINITY;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float plane = (float)(VOL_BRICK * (rg[c] > 0.0f ? bc[c] + 1 : bc[c]));
          if (rg[c] != 0.0f) t_exit = fminf(t_exit, (plane - h[c]) * rg[c]);
        }
        float kf = fminf((t_exit - t_near) * P.inv_step - 0.5f,
                         (t_far - t_near) * P.inv_step + 0.5f);
        kf = fminf(fmaxf(kf, (float)k), (float)n_steps);  // NaN: k
        const int kc = (int)ceilf(kf - 0.125f) - 1;
        int next = k + 1;
        if (kc > k) {
          const float tc = t_near + ((float)kc + 0.5f) * step;
          // Steps k..kc all lie in brick b (or past t_far) if kc does.
          if (brick_of(step_cell<POW2>(P, d, tc, nz, ny, nx), nyb, nxb) == b)
            next = tc < t_far ? kc + 1 : n_steps;
        }
        k = next;
        continue;
      }
    }
    // Steps k .. k + DM_BATCH - 1 before t_far (and, where SKIP, in brick b)
    // sample together, their loads in flight at once, then blend in order.
    // They form a prefix: t and each brick coordinate are monotone in k.
    VolCell cells[DM_BATCH];
    cells[0] = cell;
    int m = 1;
#pragma unroll
    for (int j = 1; j < DM_BATCH; ++j) {
      const float tj = t_near + ((float)(k + j) + 0.5f) * step;
      cells[j] = step_cell<POW2>(P, d, tj, nz, ny, nx);
      if (m == j && k + j < n_steps && tj < t_far && (!SKIP || brick_of(cells[j], nyb, nxb) == b))
        m = j + 1;
    }
    float dens[DM_BATCH], rgb[DM_BATCH][3], a_tf[DM_BATCH][1];
#pragma unroll
    for (int j = 0; j < DM_BATCH; ++j)
      dens[j] = j >= m ? 0.0f : sample_cell(field, ny, nx, cells[j]);
    tf_eval_last<3, DM_BATCH>(tf_c, nc, dens, rgb);
    tf_eval_last<1, DM_BATCH>(tf_o, no, dens, a_tf);
#pragma unroll
    for (int j = 0; j < DM_BATCH; ++j) {
      if (j < m) {
        const float alpha = 1.0f - expf(-a_tf[j][0] * step * att);
        const float wt = (1.0f - acc_a) * alpha;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = acc[c] + wt * rgb[j][c];
        acc_a = acc_a + wt;
      }
    }
    k += m;
  }
  out[py * width + px] = make_float4(acc[0] + (1.0f - acc_a) * P.v[25],
                                     acc[1] + (1.0f - acc_a) * P.v[26],
                                     acc[2] + (1.0f - acc_a) * P.v[27], acc_a);
}

template <bool POW2>
static const void* dm_instance_of(bool skip) {
  return skip ? (const void*)density_march_kernel<POW2, true>
              : (const void*)density_march_kernel<POW2, false>;
}

static const void* dm_instance(bool pow2, bool skip) {
  return pow2 ? dm_instance_of<true>(skip) : dm_instance_of<false>(skip);
}

// x is a power of two whose reciprocal is a normal float.
static bool power_of_two(float x) {
  int e = 0;
  return x > 0.0f && std::isfinite(x) && std::frexp(x, &e) == 0.5f && e > -125 && e < 126;
}

// March every pixel of a width x height frame on `stream`: field the
// [nz, ny, nx] float32 field, occ its `brick_occupancy` (read only where
// skip is 1), prm the 29 parameters above (host memory, passed by value),
// tf the `tf_static_table`
// of both transfer functions (tf_len floats on the device); out [height,
// width, 4] RGBA. skip: 1 where `skip_allowed` holds for this launch. A
// table of more than DM_MAX_TF floats is read from global memory.
extern "C" int density_march_launch(const float* field, const unsigned char* occ, int nz, int ny,
                                    int nx, int width, int height, int n_steps, const float* prm,
                                    const float* tf, int tf_len, int skip, float* out,
                                    void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || width < 0 || height < 0 || n_steps < 0 || tf_len < 2 ||
      (skip && occ == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((width + DM_BW - 1) / DM_BW) * ((height + DM_BH - 1) / DM_BH);
  if (tiles == 0) return (int)cudaGetLastError();
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  DmPrm P;
  memcpy(P.v, prm, sizeof(P.v));
  const int n[3] = {nx, ny, nz};
  for (int c = 0; c < 3; ++c) {
    P.inv[c] = 1.0f / prm[6 + c];
    P.scale[c] = (float)(n[c] - 1) / prm[6 + c];
  }
  P.inv_step = 1.0f / prm[21];
  const bool pow2 = power_of_two(prm[6]) && power_of_two(prm[7]) && power_of_two(prm[8]);
  const void* f = dm_instance(pow2, skip != 0);
  float4* o = (float4*)out;
  void* args[] = {(void*)&field, (void*)&occ, (void*)&nz, (void*)&ny, (void*)&nx,
                  (void*)&width, (void*)&height, (void*)&n_steps, (void*)&P, (void*)&tf,
                  (void*)&tf_len, (void*)&o};
  const size_t smem = tf_len <= DM_MAX_TF ? tf_len * sizeof(float) : 0;
  const int e = (int)cudaLaunchKernel(f, dim3((unsigned)tiles), dim3(DM_THREADS), args, smem,
                                      (cudaStream_t)stream);
  return e ? e : (int)cudaGetLastError();
}

// The 4 instances' resources (i = 2 pow2 + skip): v = (registers, local
// bytes, static shared bytes, resident blocks per SM, threads, 0), `label`
// its name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 3) return (int)cudaErrorInvalidValue;
  const void* f = dm_instance(i >= 2, i % 2 == 1);
  cudaFuncAttributes at;
  int e = (int)cudaFuncGetAttributes(&at, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, DM_THREADS, 256);
  if (e) return e;
  v[0] = at.numRegs;
  v[1] = (int)at.localSizeBytes;
  v[2] = (int)at.sharedSizeBytes;
  v[3] = nb;
  v[4] = DM_THREADS;
  v[5] = 0;
  const char* names[4] = {"ieee", "ieee skip", "pow2", "pow2 skip"};
  int n = 0;
  for (const char* q = names[i]; *q && n < cap - 1; ++q) label[n++] = *q;
  label[n] = 0;
  return 0;
}
