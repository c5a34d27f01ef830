// The path tracer's residual ratio tracking for Hopper (sm_90a): kernel R8.
//
// Port-only: the JAX package writes this estimator as a vmapped
// `lax.while_loop` over at most 11 bounces (linevis_tpu/render/vpt.py:
// 281-339, `_residual_ratio_trace`), each bounce the super-voxel DDA of
// linevis_tpu/render/super_voxel.py:162-236 (a `lax.scan` of max_sv_steps
// steps) whose every step runs the residual estimator `_rr_segment`
// (:114-159, a `lax.while_loop` of at most max_steps_per_sv steps); it
// reaches no pl.pallas_call. The kernel runs the whole estimator of one ray
// in one thread (Novák et al. 2014, ResidualRatioTracking.glsl:34-239):
//  - a bounce: the key chain split(key, 4) (the next key, the DDA's key, the
//    stop test's, the phase function's); the Amanatides-Woo DDA over the
//    super voxels of `SuperVoxelGrid` from the ray's entry into the box,
//    at most max_sv_steps of them (a ray still inside after that many is
//    cut there, as the scan cuts it); in each super voxel of non-zero
//    length, the transmittance T_c T_r (control exp(-mu_c d), residual
//    tracked against mu_r_bar in at most max_steps_per_sv steps, each
//    split(key, 3)) and the weighted reservoir of scatter candidates
//    (weight sum, T at the sample, distance);
//  - then the stop test xi > weight sum (or the 11th bounce), the
//    background seen along the bounce direction added with the path's
//    transmittance, the first scatter recorded, and the walk restarted from
//    the reservoir's point in a direction from split(k_phase, 2);
//  - TRANSMITTANCE (`residual_ratio_transmittance`): one DDA with albedo 0
//    keyed by the ray's key itself, and T alone.
// Every sample comes from jax.random's stream, derived in registers from the
// trace's key kt (`threefry.cuh`): ray i's key is split(kt, .)[first + i].
// The grid is read in 8^3 bricks (`grid_bricks`, R3's copy). Each operation
// rounds as in the plain version (`kernels/vpt_residual_ratio.py:
// vpt_residual_ratio_reference`, with `render/super_voxel.py:
// make_residual_ratio_tracer` and `_rr_segments`): logf and expf as torch's
// CUDA ops take them, IEEE division, no contraction (--fmad=false), so the
// two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "volume_common.cuh"

#define RR_THREADS 128

// Parameter layout of `prm` (`kernels/vpt_residual_ratio.py:RrParams.array`).
enum {
  R_BMIN = 0, R_BMAX = 3, R_EXTENT = 6, R_CELL = 9, R_SVN = 12, R_EXT = 15, R_ALB = 16,
  R_ISO = 17, R_OMG2 = 18, R_OMG = 19, R_TWOG = 20, R_HALFG = 21, R_OPG2 = 22, R_SUN = 23,
  R_SUNIC = 26, R_ENVI = 29, R_COUNT = 30
};

struct RrPrm {
  float v[R_COUNT];
};

// The grids one ray reads and the caps of its loops.
struct RrGrids {
  const float* grid;  // grid_bricks of the [nz, ny, nx] density grid
  int nz, ny, nx;
  const float* mu_c;  // [sz, sy, sx] control extinction
  const float* mu_r;  // [sz, sy, sx] residual majorant
  int sy, sx;
  int max_sv_steps, max_steps_per_sv;
};

// The reservoir of candidate scatter points: (weight sum, T at the sample,
// distance from the entry point).
struct Reservoir {
  float wsum, T, dist;
};

// The residual estimator over one super-voxel segment of length d_seg from
// x0 (`_rr_segments`): advances `key`, feeds the reservoir, counts its steps
// in `n_res` -> T_c T_r.
__device__ __forceinline__ float rr_segment(const RrGrids& G, const RrPrm& P, uint2& key,
                                            const float* x0, const float* w, float d_seg,
                                            float mu_c, float mu_r, float T_in, float t_base,
                                            Reservoir& res, int& n_res) {
  const float *bmin = P.v + R_BMIN, *extent = P.v + R_EXTENT;
  const float ext = P.v[R_EXT], alb = P.v[R_ALB];
  const float T_c = expf(-mu_c * d_seg);
  float t = 0.0f, T_r = 1.0f;
  for (int n = 0; n < G.max_steps_per_sv && t < d_seg; ++n) {
    ++n_res;
    const uint2 k1 = tf_split(key, 1u), k2 = tf_split(key, 2u);
    key = tf_split(key, 0u);
    const float u0 = tf_uniform(k1), u1 = tf_uniform(k2);
    const float t_new = t - logf(fmaxf(1.0f - u0, 1e-10f)) / mu_r;
    const float x = x0[0] + w[0] * t_new, y = x0[1] + w[1] * t_new, z = x0[2] + w[2] * t_new;
    const float density = trilinear_bricked(G.grid, G.nz, G.ny, G.nx, (x - bmin[0]) / extent[0],
                                            (y - bmin[1]) / extent[1], (z - bmin[2]) / extent[2]);
    const float mu = ext * density;
    const float factor = 1.0f - (mu - mu_c) / mu_r;
    const bool inside = t_new < d_seg;
    const float T_old = T_r;
    T_r = inside ? T_old * factor : T_old;
    const float Ps = alb * density;
    const float T_local = T_in * T_old * expf(-mu_c * t_new);
    const float rw = inside ? T_local * Ps : 0.0f;
    res.wsum = res.wsum + rw;
    const bool take = inside && (u1 < rw / fmaxf(res.wsum, 1e-20f));
    res.T = take ? T_local : res.T;
    res.dist = take ? t_base + t_new : res.dist;
    t = t_new;
  }
  return T_c * T_r;
}

// One DDA through the super voxels (`make_residual_ratio_tracer`'s trace):
// -> T over the whole ray, the reservoir and the entry point; counts its
// steps inside the grid in `n_dda`.
__device__ __forceinline__ float rr_trace(const RrGrids& G, const RrPrm& P, uint2 key,
                                          const float* x0, const float* w, Reservoir& res,
                                          float* x_entry, int& n_dda, int& n_res) {
  const float *bmin = P.v + R_BMIN, *bmax = P.v + R_BMAX, *cell = P.v + R_CELL;
  const float* svn = P.v + R_SVN;
  float t_min, t_max;
  const bool hit = box_intersect(bmin, bmax, V3{x0[0], x0[1], x0[2]}, V3{w[0], w[1], w[2]},
                                 t_min, t_max);
  const float t_in = t_min + 1e-7f;
#pragma unroll
  for (int c = 0; c < 3; ++c) x_entry[c] = x0[c] + w[c] * t_in;
  const float d_total = fmaxf(t_max - t_min - 2e-7f, 0.0f);
  float idx[3], t_max3[3], t_delta[3], step[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p0 = (x_entry[c] - bmin[c]) / cell[c];
    const float ix = fminf(fmaxf(floorf(p0), 0.0f), svn[c] - 1.0f);
    const float st = w[c] > 0.0f ? 1.0f : (w[c] < 0.0f ? -1.0f : 0.0f);
    const float aw = fabsf(w[c]);
    const bool small = aw < 1e-9f;
    const float inv = small ? 1e9f : 1.0f / aw;
    const float frac = p0 - ix;
    const float dist = st > 0.0f ? 1.0f - frac : frac;
    idx[c] = ix;
    step[c] = st;
    t_delta[c] = cell[c] * inv;
    t_max3[c] = small ? 1e9f : dist * cell[c] * inv;
  }
  float t_cur = 0.0f, T = 1.0f;
  res = Reservoir{0.0f, 0.0f, 0.0f};
  for (int s = 0; s < G.max_sv_steps; ++s) {
    bool inside = t_cur < d_total;
#pragma unroll
    for (int c = 0; c < 3; ++c) inside = inside && idx[c] >= 0.0f && idx[c] < svn[c];
    if (!inside) break;  // a ray outside stays outside: its state is final
    ++n_dda;
    const float t_next = fminf(fminf(fminf(t_max3[0], t_max3[1]), t_max3[2]), d_total);
    const float d_seg = fmaxf(t_next - t_cur, 0.0f);
    if (d_seg > 0.0f) {
      const long long sv = ((long long)(int)idx[2] * G.sy + (int)idx[1]) * G.sx + (int)idx[0];
      const float xs[3] = {x_entry[0] + w[0] * t_cur, x_entry[1] + w[1] * t_cur,
                           x_entry[2] + w[2] * t_cur};
      const float T_seg = rr_segment(G, P, key, xs, w, d_seg, __ldg(G.mu_c + sv),
                                     __ldg(G.mu_r + sv), T, t_cur, res, n_res);
      T = T * T_seg;
    }
    // Advance to the neighbour across the nearest face (argmin: the first
    // of equal values).
    const bool a0 = (t_max3[0] <= t_max3[1]) && (t_max3[0] <= t_max3[2]);
    const int axis = a0 ? 0 : (t_max3[1] <= t_max3[2] ? 1 : 2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (axis == c) {
        idx[c] = idx[c] + step[c];
        t_max3[c] = t_max3[c] + t_delta[c];
      }
    }
    t_cur = t_next;
  }
  return hit ? T : 1.0f;
}

template <bool TRANSMITTANCE>
__global__ void __launch_bounds__(RR_THREADS)
rr_kernel(const RrGrids G, const float* __restrict__ origins, const float* __restrict__ dirs,
          const uint2* __restrict__ kt, int first, int N, int max_iterations,
          const __grid_constant__ RrPrm P, const float* __restrict__ env, int he, int we,
          float* __restrict__ radiance, float* __restrict__ first_x,
          unsigned char* __restrict__ first_has, int* __restrict__ steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint2 key = tf_split(*kt, (uint32_t)(first + i));
  float x[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  float w[3] = {dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  int n_bounce = 0, n_dda = 0, n_res = 0;
  Reservoir res;
  float x_entry[3];
  if (TRANSMITTANCE) {
    n_bounce = 1;
    radiance[i] = rr_trace(G, P, key, x, w, res, x_entry, n_dda, n_res);
  } else {
    const Phase pc{(int)P.v[R_ISO], P.v[R_OMG2], P.v[R_OMG], P.v[R_TWOG], P.v[R_HALFG],
                   P.v[R_OPG2]};
    float T = 1.0f;
    float acc[3] = {0.0f, 0.0f, 0.0f}, fx[3] = {0.0f, 0.0f, 0.0f};
    bool fh = false;
    for (int it = 0; it <= max_iterations; ++it) {
      ++n_bounce;
      const uint2 k_dda = tf_split(key, 1u), kx = tf_split(key, 2u), kp = tf_split(key, 3u);
      key = tf_split(key, 0u);
      const float T_seg = rr_trace(G, P, k_dda, x, w, res, x_entry, n_dda, n_res);
      const float T_new = T * T_seg;
      const float xi = tf_uniform(kx);
      const bool stop = (xi > res.wsum) || (it >= max_iterations);
      const V3 wv{w[0], w[1], w[2]};
      const V3 bg = env != nullptr ? env_map_sample(env, he, we, wv, P.v[R_ENVI])
                                   : sky_light(wv, P.v + R_SUN, P.v + R_SUNIC);
      acc[0] = acc[0] + T_new * bg.x;
      acc[1] = acc[1] + T_new * bg.y;
      acc[2] = acc[2] + T_new * bg.z;
      const float x_scat[3] = {x_entry[0] + w[0] * res.dist, x_entry[1] + w[1] * res.dist,
                               x_entry[2] + w[2] * res.dist};
      if (!stop && !fh) {
        fx[0] = x_scat[0];
        fx[1] = x_scat[1];
        fx[2] = x_scat[2];
        fh = true;
      }
      T = stop ? T_new : res.T;
      if (stop) break;
      const V3 wn = sample_phase(tf_uniform(tf_split(kp, 0u)), tf_uniform(tf_split(kp, 1u)), pc,
                                 wv);
      w[0] = wn.x;
      w[1] = wn.y;
      w[2] = wn.z;
      x[0] = x_scat[0];
      x[1] = x_scat[1];
      x[2] = x_scat[2];
    }
    radiance[3 * i] = acc[0];
    radiance[3 * i + 1] = acc[1];
    radiance[3 * i + 2] = acc[2];
    first_x[3 * i] = fx[0];
    first_x[3 * i + 1] = fx[1];
    first_x[3 * i + 2] = fx[2];
    first_has[i] = fh ? 1 : 0;
  }
  if (steps != nullptr) {
    steps[3 * i] = n_bounce;
    steps[3 * i + 1] = n_dda;
    steps[3 * i + 2] = n_res;
  }
}

// Trace N rays on `stream`: grid the [nz, ny, nx] float32 grid in bricks
// (`kernels/volume_common.py:grid_bricks`), mu_c and mu_r the [sz, sy, sx]
// `SuperVoxelGrid` (control extinction, residual majorant), origins and
// dirs [N, 3], kt the trace's key (k0, k1) as two uint32 words on the
// device, of which ray i takes split(kt, .)[first + i], prm the R_COUNT
// parameters (host memory, passed by value), env [he, we, 3] or null (the
// sky and sun). transmittance 0: the estimator, up to max_iterations + 1
// bounces, writes radiance [N, 3], first_x [N, 3], first_has [N] (0/1);
// transmittance 1: one DDA with albedo 0, writes T to radiance [N]. steps,
// if not null, receives [N, 3]: the bounces, the DDA's steps inside the
// grid and the residual steps, summed over the bounces.
extern "C" int vpt_residual_ratio_launch(const float* grid, int nz, int ny, int nx,
                                         const float* mu_c, const float* mu_r, int sz, int sy,
                                         int sx, const float* origins, const float* dirs,
                                         const unsigned int* kt, int first, int N,
                                         int max_iterations, int max_sv_steps,
                                         int max_steps_per_sv, int transmittance,
                                         const float* prm, const float* env, int he, int we,
                                         float* radiance, float* first_x,
                                         unsigned char* first_has, int* steps, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || sz < 1 || sy < 1 || sx < 1 || N < 0 || N > (1 << 30) ||
      first < 0 || max_iterations < 0 || max_sv_steps < 0 || max_steps_per_sv < 0 ||
      (env != nullptr && (he < 1 || we < 1)) ||
      (!transmittance && (first_x == nullptr || first_has == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  RrPrm P;
  memcpy(P.v, prm, sizeof(P.v));
  const RrGrids G{grid, nz, ny, nx, mu_c, mu_r, sy, sx, max_sv_steps, max_steps_per_sv};
  const int blocks = (N + RR_THREADS - 1) / RR_THREADS;
  if (transmittance)
    rr_kernel<true><<<blocks, RR_THREADS, 0, (cudaStream_t)stream>>>(
        G, origins, dirs, (const uint2*)kt, first, N, max_iterations, P, env, he, we, radiance,
        first_x, first_has, steps);
  else
    rr_kernel<false><<<blocks, RR_THREADS, 0, (cudaStream_t)stream>>>(
        G, origins, dirs, (const uint2*)kt, first, N, max_iterations, P, env, he, we, radiance,
        first_x, first_has, steps);
  return (int)cudaGetLastError();
}

// The two instances' resources (0: the estimator, 1: the transmittance): v
// = (registers, local bytes, static shared bytes, resident blocks per SM,
// threads, 0), `label` its name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 1) return (int)cudaErrorInvalidValue;
  const void* f = i == 0 ? (const void*)rr_kernel<false> : (const void*)rr_kernel<true>;
  cudaFuncAttributes at;
  int e = (int)cudaFuncGetAttributes(&at, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, RR_THREADS, 0);
  if (e) return e;
  v[0] = at.numRegs;
  v[1] = (int)at.localSizeBytes;
  v[2] = (int)at.sharedSizeBytes;
  v[3] = nb;
  v[4] = RR_THREADS;
  v[5] = 0;
  const char* name = i == 0 ? "residual ratio" : "transmittance";
  int n = 0;
  for (const char* q = name; *q && n < cap - 1; ++q) label[n++] = *q;
  label[n] = 0;
  return 0;
}
