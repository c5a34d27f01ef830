// The path tracer's decomposition tracking for Hopper (sm_90a): kernel R7.
//
// Port-only: the JAX package writes this estimator as the vmapped
// `lax.scan` of `trace_one` in linevis_tpu/render/vpt.py:342-473
// (`_decomposition_trace`, Kutz et al. 2017); it reaches no
// pl.pallas_call. The kernel computes the same function per ray, one thread
// a ray until the ray dies (absorbed, or out of the grid of super voxels)
// or has run max_events events: the scan runs dead rays to its end with
// their state frozen, so the result is the same. Each event is one step of
// the scan's flat state machine:
//  - entering a super voxel draws the control flight t_c against
//    mu_c = extinction x the super voxel's min density, or skips the super
//    voxel if it is empty (max density < 1e-5);
//  - inside one, one residual candidate t_r is drawn against the local
//    reduced majorant mu_r = extinction x max density - mu_c; the nearer of
//    t_c and t_r collides (t_c always, t_r with probability
//    (extinction x density - mu_c) / mu_r), and a collision absorbs or
//    scatters (Henyey-Greenstein); a scatter re-enters the super voxel of
//    its point with the new direction;
//  - with neither flight inside the super voxel, the ray crosses its exit
//    face (the first axis of equal distances) into the next.
// Every sample comes from jax.random's stream, derived in registers from
// the trace's key kt (`threefry.cuh`): ray i's key is split(kt, .)[first
// + i], event j's key split(key, .)[j], its five keys split(k, 5), each
// uniform uniform(k_c); the phase function's two uniforms come from
// split(k_5). Draws that an event's branch does not read are not made
// (they are pure functions of the keys). The grid is read in 8^3 bricks
// (`grid_bricks`, R3's copy), the per-super-voxel min and max from
// `render/super_voxel.py:build_super_voxel_minmax`. Each operation rounds as
// in the plain version, `kernels/vpt_decomposition.py:
// vpt_decomposition_reference` (`volume_common.cuh` / `volume_common.py`):
// logf as torch.log, IEEE division, no contraction (--fmad=false), so the
// two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "volume_common.cuh"

#define VD_THREADS 128

// Parameter layout of `prm` (`kernels/vpt_decomposition.py:DecompositionParams.array`).
enum {
  Q_BMIN = 0, Q_BMAX = 3, Q_EXTENT = 6, Q_CELL = 9, Q_SVN = 12, Q_MAJ = 15, Q_ABS = 16,
  Q_ISO = 17, Q_OMG2 = 18, Q_OMG = 19, Q_TWOG = 20, Q_HALFG = 21, Q_OPG2 = 22, Q_SUN = 23,
  Q_SUNIC = 26, Q_ENVI = 29, Q_COUNT = 30
};

struct VdPrm {
  float v[Q_COUNT];
};

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// The super-voxel index of point x along axis c: clamp(floor((x - bmin) /
// cell), 0, n - 1), as floats.
__device__ __forceinline__ float sv_index(float x, float bmin, float cell, float n) {
  return fminf(fmaxf(floorf((x - bmin) / cell), 0.0f), n - 1.0f);
}

__global__ void __launch_bounds__(VD_THREADS)
vd_kernel(const float* __restrict__ grid, int nz, int ny, int nx,
          const float* __restrict__ dmin_g, const float* __restrict__ dmax_g, int sy, int sx,
          const float* __restrict__ origins, const float* __restrict__ dirs,
          const uint2* __restrict__ kt, int first, int N, int max_events,
          const __grid_constant__ VdPrm P, const float* __restrict__ env, int he, int we,
          float* __restrict__ radiance, int* __restrict__ events) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float *bmin = P.v + Q_BMIN, *bmax = P.v + Q_BMAX, *extent = P.v + Q_EXTENT;
  const float *cell = P.v + Q_CELL, *svn = P.v + Q_SVN;
  const float maj = P.v[Q_MAJ], abs_albedo = P.v[Q_ABS];
  const Phase pc{(int)P.v[Q_ISO], P.v[Q_OMG2], P.v[Q_OMG], P.v[Q_TWOG], P.v[Q_HALFG], P.v[Q_OPG2]};
  const uint2 key = tf_split(*kt, (uint32_t)(first + i));
  const V3 o{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  float w[3] = {dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  float t_min, t_max;
  const bool hit = box_intersect(bmin, bmax, o, V3{w[0], w[1], w[2]}, t_min, t_max);
  const float t_in = t_min + 1e-6f;
  float x[3] = {o.x + w[0] * t_in, o.y + w[1] * t_in, o.z + w[2] * t_in};
  float idx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) idx[c] = sv_index(x[c], bmin[c], cell[c], svn[c]);
  float t_c = 0.0f, t_r = 0.0f;
  bool in_sv = false, absorbed = false;
  int ev = 0;
  for (int j = 0; hit && j < max_events; ++j) {
    ++ev;
    const uint2 kj = tf_split(key, (uint32_t)j);
    const int ix = (int)fminf(fmaxf(idx[0], 0.0f), svn[0] - 1.0f);
    const int iy = (int)fminf(fmaxf(idx[1], 0.0f), svn[1] - 1.0f);
    const int iz = (int)fminf(fmaxf(idx[2], 0.0f), svn[2] - 1.0f);
    const long long s = ((long long)iz * sy + iy) * sx + ix;
    const float d_min = __ldg(dmin_g + s), d_max = __ldg(dmax_g + s);
    const float mu_c = fmaxf(maj * d_min, 1e-10f);
    const float mu_r = fmaxf(maj * d_max - mu_c, 1e-10f);
    // The distance to the super voxel's exit face and that face's axis.
    float t_far[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lo = bmin[c] + idx[c] * cell[c];
      const float hi = lo + cell[c];
      const bool small = fabsf(w[c]) < 1e-9f;
      const float safe_w = small ? 1e-9f : w[c];
      const float tf = fmaxf((lo - x[c]) / safe_w, (hi - x[c]) / safe_w);
      t_far[c] = small ? 1e30f : tf;
    }
    const bool a0 = (t_far[0] <= t_far[1]) && (t_far[0] <= t_far[2]);
    const int axis = a0 ? 0 : (t_far[1] <= t_far[2] ? 1 : 2);
    const float d_seg = fmaxf(fminf(fminf(t_far[0], t_far[1]), t_far[2]), 0.0f);
    bool advance;
    if (!in_sv) {  // enter: the control flight, or skip an empty super voxel
      advance = d_max < 1e-5f;
      if (!advance) {
        const float u0 = tf_uniform(tf_split(kj, 0u));
        t_c = -logf(fmaxf(1.0f - u0, 1e-10f)) / mu_c;
        in_sv = true;
      }
      t_r = 0.0f;
    } else {  // one residual candidate
      const float u1 = tf_uniform(tf_split(kj, 1u));
      const float t_r_new = t_r - logf(fmaxf(1.0f - u1, 1e-10f)) / mu_r;
      advance = (t_c >= d_seg) && (t_r_new >= d_seg);
      bool collision = false;
      float xh[3];
      if (!advance) {
        const float t_hit = fminf(t_c, t_r_new);
#pragma unroll
        for (int c = 0; c < 3; ++c) xh[c] = x[c] + w[c] * t_hit;
        collision = t_c <= t_r_new;
        if (!collision) {
          const float dens = trilinear_bricked(
              grid, nz, ny, nx, (xh[0] - bmin[0]) / extent[0], (xh[1] - bmin[1]) / extent[1],
              (xh[2] - bmin[2]) / extent[2]);
          const float u2 = tf_uniform(tf_split(kj, 2u));
          collision = u2 * mu_r < maj * dens - mu_c;
        }
      }
      t_r = collision ? 0.0f : t_r_new;
      in_sv = !advance;
      if (collision) {
        const float u3 = tf_uniform(tf_split(kj, 3u));
        if (u3 < abs_albedo) {
          absorbed = true;
          break;
        }
        // Scatter: a new direction from split(k_5, 2), and the super voxel
        // of the point, entered anew.
        const uint2 k5 = tf_split(kj, 4u);
        const V3 wn = sample_phase(tf_uniform(tf_split(k5, 0u)), tf_uniform(tf_split(k5, 1u)), pc,
                                   V3{w[0], w[1], w[2]});
        w[0] = wn.x;
        w[1] = wn.y;
        w[2] = wn.z;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          x[c] = xh[c];
          idx[c] = sv_index(xh[c], bmin[c], cell[c], svn[c]);
        }
        in_sv = false;
      }
    }
    if (advance) {  // across the exit face; out of the grid, the ray escapes
      const float step = d_seg + 1e-6f;
      bool out = false;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c] = x[c] + w[c] * step;
        idx[c] = idx[c] + sign_f(w[c]) * (axis == c ? 1.0f : 0.0f);
        out = out || idx[c] < 0.0f || idx[c] >= svn[c];
      }
      if (out) break;
    }
  }
  const V3 wf{w[0], w[1], w[2]};
  const V3 bg = env != nullptr ? env_map_sample(env, he, we, wf, P.v[Q_ENVI])
                               : sky_light(wf, P.v + Q_SUN, P.v + Q_SUNIC);
  radiance[3 * i] = absorbed ? 0.0f : bg.x;
  radiance[3 * i + 1] = absorbed ? 0.0f : bg.y;
  radiance[3 * i + 2] = absorbed ? 0.0f : bg.z;
  if (events != nullptr) events[i] = ev;
}

// Trace N rays on `stream`: grid the [nz, ny, nx] float32 grid in bricks
// (`kernels/volume_common.py:grid_bricks`), dmin and dmax the [sz, sy, sx]
// per-super-voxel min and max density, origins and dirs [N, 3], kt the
// trace's key (k0, k1) as two uint32 words on the device, of which ray i
// takes split(kt, .)[first + i], prm the Q_COUNT parameters (host memory,
// passed by value), env [he, we, 3] or null (the sky and sun). Writes
// radiance [N, 3] and, if not null, events [N] (the events each ray ran).
extern "C" int vpt_decomposition_launch(const float* grid, int nz, int ny, int nx,
                                        const float* dmin, const float* dmax, int sz, int sy,
                                        int sx, const float* origins, const float* dirs,
                                        const unsigned int* kt, int first, int N, int max_events,
                                        const float* prm, const float* env, int he, int we,
                                        float* radiance, int* events, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || sz < 1 || sy < 1 || sx < 1 || N < 0 || N > (1 << 30) ||
      first < 0 || max_events < 0 || (env != nullptr && (he < 1 || we < 1)))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  VdPrm P;
  memcpy(P.v, prm, sizeof(P.v));
  vd_kernel<<<(N + VD_THREADS - 1) / VD_THREADS, VD_THREADS, 0, (cudaStream_t)stream>>>(
      grid, nz, ny, nx, dmin, dmax, sy, sx, origins, dirs, (const uint2*)kt, first, N, max_events,
      P, env, he, we, radiance, events);
  return (int)cudaGetLastError();
}

// The instance's resources: v = (registers, local bytes, static shared
// bytes, resident blocks per SM, threads, 0), `label` its name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  int e = (int)cudaFuncGetAttributes(&at, (const void*)vd_kernel);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, (const void*)vd_kernel,
                                                                 VD_THREADS, 0);
  if (e) return e;
  v[0] = at.numRegs;
  v[1] = (int)at.localSizeBytes;
  v[2] = (int)at.sharedSizeBytes;
  v[3] = nb;
  v[4] = VD_THREADS;
  v[5] = 0;
  const char* name = "decomposition";
  int n = 0;
  for (const char* q = name; *q && n < cap - 1; ++q) label[n++] = *q;
  label[n] = 0;
  return 0;
}
