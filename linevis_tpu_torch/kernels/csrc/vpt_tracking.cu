// The path tracer's Woodcock tracking for Hopper (sm_90a): kernel R3.
//
// Port-only: the JAX package writes this loop as the vmapped `lax.scan` of
// `trace_one` in linevis_tpu/render/vpt.py:189-278 (`vpt_trace_rays`, the
// Delta, Spectral Delta and Ratio tracking modes); it reaches no
// pl.pallas_call. The kernel computes the same function per ray:
//  - one thread runs one ray, event after event, and stops when the ray
//    dies (leaves the volume or is absorbed). The scan runs dead rays to
//    its end with their state frozen, so the result is the same;
//  - every sample comes from jax.random's stream, derived in registers
//    from the trace's key kt (`threefry.cuh`): ray i's key is
//    split(kt, .)[first + i], event j's key split(key, max_events)[j],
//    its four keys split(k, 4), each uniform uniform(k_i); the phase
//    function's two uniforms come from split(k3); Stochastic
//    interpolation's jitter is uniform(k4, (3,));
//  - the grid is sampled trilinearly, at the nearest voxel or jittered
//    (template argument INTERP), the phase sampled as `_sample_phase`
//    (scattering.py:103-132), and an escaping ray takes the procedural
//    sky and sun or the environment map (env_map.py:85-110).
// Each operation rounds as in the plain version, `kernels/vpt_tracking.py:
// vpt_tracking_reference` (`volume_common.cuh` / `volume_common.py`): logf
// and expf as torch's CUDA ops take them, IEEE division, no contraction
// (--fmad=false), so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "volume_common.cuh"

#define VPT_THREADS 128

enum { MODE_DELTA = 0, MODE_SPECTRAL = 1, MODE_RATIO = 2 };
enum { INTERP_TRILINEAR = 0, INTERP_NEAREST = 1, INTERP_STOCHASTIC = 2 };

// Parameter layout of `prm` (the wrapper's `vpt_params`).
enum {
  P_BMIN = 0, P_BMAX = 3, P_EXTENT = 6, P_EXT = 9, P_AEXT = 12, P_SEXT = 15, P_MAJ = 18,
  P_ISO = 19, P_OMG2 = 20, P_OMG = 21, P_TWOG = 22, P_HALFG = 23, P_OPG2 = 24, P_SUN = 25,
  P_SUNIC = 28, P_ENVI = 31, P_COUNT = 32
};

template <int INTERP>
__device__ __forceinline__ float density_at(const float* __restrict__ grid, int nz, int ny, int nx,
                                            const float* tp, uint2 k) {
  if (INTERP == INTERP_TRILINEAR) return trilinear(grid, nz, ny, nx, tp[0], tp[1], tp[2]);
  const float res[3] = {(float)(nx - 1), (float)(ny - 1), (float)(nz - 1)};
  float q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float f = fminf(fmaxf(tp[i], 0.0f), 1.0f) * res[i];
    if (INTERP == INTERP_STOCHASTIC) f = f + tf_uniform(tf_split(k, 3), (uint32_t)i) - 0.5f;
    q[i] = rintf(fminf(fmaxf(f, 0.0f), res[i])) / fmaxf(res[i], 1.0f);
  }
  return trilinear(grid, nz, ny, nx, q[0], q[1], q[2]);
}

template <int MODE, int INTERP>
__global__ void __launch_bounds__(VPT_THREADS)
vpt_kernel(const float* __restrict__ grid, int nz, int ny, int nx,
           const float* __restrict__ origins, const float* __restrict__ dirs,
           const uint2* __restrict__ kt, int first, int N, int max_events,
           const float* __restrict__ prm,
           const float* __restrict__ env, int he, int we, float* __restrict__ radiance,
           float* __restrict__ first_x, unsigned char* __restrict__ first_has,
           int* __restrict__ events) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float bmin[3], bmax[3], extent[3], ext[3], aext[3], sext[3], sun[3], sun_ic[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bmin[c] = prm[P_BMIN + c];
    bmax[c] = prm[P_BMAX + c];
    extent[c] = prm[P_EXTENT + c];
    ext[c] = prm[P_EXT + c];
    aext[c] = prm[P_AEXT + c];
    sext[c] = prm[P_SEXT + c];
    sun[c] = prm[P_SUN + c];
    sun_ic[c] = prm[P_SUNIC + c];
  }
  const float maj = prm[P_MAJ];
  const Phase pc{(int)prm[P_ISO], prm[P_OMG2], prm[P_OMG], prm[P_TWOG], prm[P_HALFG], prm[P_OPG2]};

  const V3 o{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  V3 w{dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  float t_min, t_max;
  const bool hit = box_intersect(bmin, bmax, o, w, t_min, t_max);
  V3 x{o.x + w.x * t_min, o.y + w.y * t_min, o.z + w.z * t_min};
  float d = hit ? t_max - t_min : -1.0f;
  float wt[3] = {1.0f, 1.0f, 1.0f};
  bool alive = hit, absorbed = false, scattered = false;
  V3 fx{0.0f, 0.0f, 0.0f};
  const uint2 key = tf_split(*kt, (uint32_t)(first + i));
  int ev = 0;
  for (int j = 0; j < max_events && alive; ++j) {
    ++ev;
    const uint2 k = tf_split(key, (uint32_t)j);
    const float u1 = tf_uniform(tf_split(k, 0u));
    const float t = -logf(fmaxf(1e-10f, 1.0f - u1)) / maj;
    if (t > d) break;  // the ray leaves the volume: its state stays as it is
    const V3 xn{x.x + w.x * t, x.y + w.y * t, x.z + w.z * t};
    const float tp[3] = {(xn.x - bmin[0]) / extent[0], (xn.y - bmin[1]) / extent[1],
                         (xn.z - bmin[2]) / extent[2]};
    const float dens = density_at<INTERP>(grid, nz, ny, nx, tp, k);
    float sa[3], ss[3], sn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sa[c] = aext[c] * dens;
      ss[c] = sext[c] * dens;
      sn[c] = maj - ext[c] * dens;
    }
    float pa, ps, pn;
    if (MODE == MODE_SPECTRAL) {
      pa = (sa[0] * wt[0] + sa[1] * wt[1] + sa[2] * wt[2]) / 3.0f;
      ps = (ss[0] * wt[0] + ss[1] * wt[1] + ss[2] * wt[2]) / 3.0f;
      pn = (sn[0] * wt[0] + sn[1] * wt[1] + sn[2] * wt[2]) / 3.0f;
      const float cs = fmaxf(pa + ps + pn, 1e-20f);
      pa = pa / cs;
      ps = ps / cs;
      pn = pn / cs;
    } else {
      pa = sa[0] / maj;
      ps = ss[0] / maj;
      pn = sn[0] / maj;
    }
    const float xi = tf_uniform(tf_split(k, 1u));
    bool absorb = xi < pa;
    bool scatter = !absorb && (xi < 1.0f - pn);
    if (MODE == MODE_RATIO) {
#pragma unroll
      for (int c = 0; c < 3; ++c) wt[c] = wt[c] * (1.0f - pa);
      absorb = false;
      scatter = xi < 1.0f - pn;
    } else if (MODE == MODE_SPECTRAL) {
      const float den = scatter ? fmaxf(maj * ps, 1e-20f) : fmaxf(maj * pn, 1e-20f);
#pragma unroll
      for (int c = 0; c < 3; ++c) wt[c] = fminf(wt[c] * (scatter ? ss[c] : sn[c]) / den, 100.0f);
    }
    if (scatter) {
      const uint2 k3 = tf_split(k, 2u);
      const V3 wn = sample_phase(tf_uniform(tf_split(k3, 0u)), tf_uniform(tf_split(k3, 1u)), pc, w);
      float t2_min, t2_max;
      const bool hit2 = box_intersect(bmin, bmax, xn, wn, t2_min, t2_max);
      d = hit2 ? t2_max - t2_min : 0.0f;
      x = hit2 ? V3{xn.x + wn.x * t2_min, xn.y + wn.y * t2_min, xn.z + wn.z * t2_min} : xn;
      w = wn;
      if (!scattered) {
        fx = xn;
        scattered = true;
      }
    } else {
      d = d - t;
      x = xn;
    }
    if (absorb) {
      absorbed = true;
      alive = false;
    }
  }
  const V3 bg = env != nullptr ? env_map_sample(env, he, we, w, prm[P_ENVI]) : sky_light(w, sun, sun_ic);
  radiance[3 * i] = absorbed ? 0.0f : fminf(wt[0], 1e5f) * bg.x;
  radiance[3 * i + 1] = absorbed ? 0.0f : fminf(wt[1], 1e5f) * bg.y;
  radiance[3 * i + 2] = absorbed ? 0.0f : fminf(wt[2], 1e5f) * bg.z;
  first_x[3 * i] = fx.x;
  first_x[3 * i + 1] = fx.y;
  first_x[3 * i + 2] = fx.z;
  first_has[i] = scattered ? 1 : 0;
  if (events != nullptr) events[i] = ev;
}

template <int MODE>
static void launch_mode(int interp, dim3 grid_dim, cudaStream_t s, const float* grid, int nz, int ny,
                        int nx, const float* o, const float* d, const uint2* kt, int first, int N,
                        int E,
                        const float* prm, const float* env, int he, int we, float* rad, float* fx,
                        unsigned char* fh, int* ev) {
  if (interp == INTERP_TRILINEAR)
    vpt_kernel<MODE, INTERP_TRILINEAR><<<grid_dim, VPT_THREADS, 0, s>>>(
        grid, nz, ny, nx, o, d, kt, first, N, E, prm, env, he, we, rad, fx, fh, ev);
  else if (interp == INTERP_NEAREST)
    vpt_kernel<MODE, INTERP_NEAREST><<<grid_dim, VPT_THREADS, 0, s>>>(
        grid, nz, ny, nx, o, d, kt, first, N, E, prm, env, he, we, rad, fx, fh, ev);
  else
    vpt_kernel<MODE, INTERP_STOCHASTIC><<<grid_dim, VPT_THREADS, 0, s>>>(
        grid, nz, ny, nx, o, d, kt, first, N, E, prm, env, he, we, rad, fx, fh, ev);
}

// Trace N rays on `stream`: grid [nz, ny, nx] float32, origins and dirs
// [N, 3], kt the trace's key (k0, k1) as two uint32 words on the device,
// of which ray i takes split(kt, .)[first + i], prm the P_COUNT parameters, env
// [he, we, 3] or null (the sky and sun). Writes radiance [N, 3], first_x
// [N, 3], first_has [N] (0/1) and, if not null, events [N] (the events each
// ray ran). mode 0/1/2: Delta, Spectral Delta, Ratio tracking; interp
// 0/1/2: Trilinear, Nearest, Stochastic.
extern "C" int vpt_tracking_launch(const float* grid, int nz, int ny, int nx, const float* origins,
                                   const float* dirs, const unsigned int* kt, int first, int N,
                                   int max_events, int mode, int interp, const float* prm,
                                   const float* env, int he, int we, float* radiance,
                                   float* first_x, unsigned char* first_has, int* events,
                                   void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || N < 0 || first < 0 || max_events < 0 || mode < 0 ||
      mode > 2 || interp < 0 || interp > 2 || (env != nullptr && (he < 1 || we < 1)))
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    const dim3 g((N + VPT_THREADS - 1) / VPT_THREADS);
    const cudaStream_t s = (cudaStream_t)stream;
    const uint2* k = (const uint2*)kt;
    if (mode == MODE_DELTA)
      launch_mode<MODE_DELTA>(interp, g, s, grid, nz, ny, nx, origins, dirs, k, first, N,
                              max_events, prm, env, he, we, radiance, first_x, first_has, events);
    else if (mode == MODE_SPECTRAL)
      launch_mode<MODE_SPECTRAL>(interp, g, s, grid, nz, ny, nx, origins, dirs, k, first, N,
                                 max_events, prm, env, he, we, radiance, first_x, first_has,
                                 events);
    else
      launch_mode<MODE_RATIO>(interp, g, s, grid, nz, ny, nx, origins, dirs, k, first, N,
                              max_events, prm, env, he, we, radiance, first_x, first_has, events);
  }
  return (int)cudaGetLastError();
}

__global__ void threefry_kernel(const uint2* __restrict__ keys, int n, int op, unsigned int c,
                                unsigned int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (op == 0) {
    const uint2 k = tf_split(keys[i], c);
    out[2 * i] = k.x;
    out[2 * i + 1] = k.y;
  } else {
    const float u = tf_uniform(keys[i], c);
    out[i] = __float_as_uint(u);
  }
}

// The device threefry on n keys [n] (k0, k1): op 0 writes split(key, .)[c]
// as [n, 2] uint32, op 1 element c of uniform(key, .) as [n] float32 bits.
extern "C" int threefry_launch(const unsigned int* keys, int n, int op, unsigned int c,
                               unsigned int* out, void* stream) {
  if (n < 0 || op < 0 || op > 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    threefry_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const uint2*)keys, n, op, c,
                                                                       out);
  return (int)cudaGetLastError();
}
