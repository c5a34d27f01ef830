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
//
// What bounds it (`tools/kernel_split.py --kernels r3` on the 1080p cloud
// sample): rays run from 0 events (a miss) to max_events, so a warp of 32
// neighbouring rays that runs until its longest ray dies keeps a third of
// its lanes idle; and the threefry draws, integer work on half the lanes'
// rate, lead the busy lanes' time, the scatter's five beside the event's
// five in a branch that a few lanes of nearly every warp take. So:
//  - the grid is persistent (as many warps as the card keeps resident):
//    each warp claims rays 32 indices at a time from a global counter
//    (`next`), and a lane whose ray dies takes the next index of its
//    warp's claim (ballot and popcount), until the counter runs out;
//  - a lane's step is one of: derive its ray's key, run an event, or turn
//    its ray after a scattering event (the step after the event). The
//    three need the same draws (a key split(x, c), then the uniforms of
//    split(k, 0) and split(k, 1)), so every lane draws in the same code
//    and only the float work differs between them;
//  - with the lanes on unrelated rays, the density samples led (30% of the
//    warp-cycles), so the kernel reads the grid in 8^3 bricks (a copy made
//    once per grid on the card, `grid_bricks`): a sample's voxels share
//    cache lines, and a ray's next samples mostly the same ones.
// Each ray still runs in one thread, keyed and written by its own index,
// with the plain version's operations in its order, so the result does not
// depend on the schedule. A `scene/sparse_grid.py:SparseGrid` (template
// SPARSE) is read as `SparseGrid.sample` reads it: the block's brick from
// the table, then the sample's eight voxels from that brick and its apron.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "threefry.cuh"
#include "volume_common.cuh"

#define VPT_THREADS 128

enum { MODE_DELTA = 0, MODE_SPECTRAL = 1, MODE_RATIO = 2 };
enum { INTERP_TRILINEAR = 0, INTERP_NEAREST = 1, INTERP_STOCHASTIC = 2 };
// What a lane's next step does: derive its ray's key, run an event, turn
// the ray of a scattering event, or write a dead ray's outputs.
enum { ST_KEY = 0, ST_EVENT = 1, ST_SCATTER = 2, ST_DONE = 3 };

// Parameter layout of `prm` (the wrapper's `vpt_params`).
enum {
  P_BMIN = 0, P_BMAX = 3, P_EXTENT = 6, P_EXT = 9, P_AEXT = 12, P_SEXT = 15, P_MAJ = 18,
  P_ISO = 19, P_OMG2 = 20, P_OMG = 21, P_TWOG = 22, P_HALFG = 23, P_OPG2 = 24, P_SUN = 25,
  P_SUNIC = 28, P_ENVI = 31, P_COUNT = 32
};

// The parameters passed by value: the kernel reads them from the constant
// bank, so the persistent loop holds none of them in registers. inv: the
// reciprocals of the majorant and the extents (the launch's).
struct VptPrm {
  float v[P_COUNT];
  float inv[4];
};

// Nearest and Stochastic interpolation's point q: tp snapped to the nearest
// voxel centre, after Stochastic's jitter (uniform(k4, (3,)) - 0.5 voxels).
template <int INTERP>
__device__ __forceinline__ void snap_point(int nz, int ny, int nx, const float* tp, uint2 k,
                                           float* q) {
  const float res[3] = {(float)(nx - 1), (float)(ny - 1), (float)(nz - 1)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float f = fminf(fmaxf(tp[i], 0.0f), 1.0f) * res[i];
    if (INTERP == INTERP_STOCHASTIC) f = f + tf_uniform(tf_split(k, 3), (uint32_t)i) - 0.5f;
    q[i] = rintf(fminf(fmaxf(f, 0.0f), res[i])) / fmaxf(res[i], 1.0f);
  }
}

template <int INTERP>
__device__ __forceinline__ float density_at(const float* __restrict__ grid, int nz, int ny, int nx,
                                            const float* tp, uint2 k) {
  if (INTERP == INTERP_TRILINEAR) return trilinear_bricked(grid, nz, ny, nx, tp[0], tp[1], tp[2]);
  float q[3];
  snap_point<INTERP>(nz, ny, nx, tp, k, q);
  return trilinear_bricked(grid, nz, ny, nx, q[0], q[1], q[2]);
}

// `density_at` on a block-sparse grid (`SparseGrid.sample`).
template <int INTERP>
__device__ __forceinline__ float density_at_sparse(const SparseBricks& grid, int nz, int ny,
                                                   int nx, const float* tp, uint2 k) {
  if (INTERP == INTERP_TRILINEAR) return trilinear_sparse(grid, nz, ny, nx, tp[0], tp[1], tp[2]);
  float q[3];
  snap_point<INTERP>(nz, ny, nx, tp, k, q);
  return trilinear_sparse(grid, nz, ny, nx, q[0], q[1], q[2]);
}

// At least 4 resident blocks an SM: at most 128 registers, which the
// persistent loop's state takes without spilling (`kernel_split.py`).
// POW2: the majorant and the box's extents are powers of two, so dividing
// by them is multiplying by their reciprocals, bit for bit (both round the
// same real once), without the IEEE division's slow-path branch. SPARSE:
// the grid is a `SparseGrid`'s bricks and `table` (block `block`); else
// `grid_bricks` of the dense grid.
template <int MODE, int INTERP, bool POW2, bool SPARSE>
__global__ void __launch_bounds__(VPT_THREADS, 4)
vpt_kernel(const float* __restrict__ grid, const int* __restrict__ table, int block, int nz,
           int ny, int nx,
           const float* __restrict__ origins, const float* __restrict__ dirs,
           const uint2* __restrict__ kt, int first, int N, int max_events,
           const __grid_constant__ VptPrm P,
           const float* __restrict__ env, int he, int we, float* __restrict__ radiance,
           float* __restrict__ first_x, unsigned char* __restrict__ first_has,
           int* __restrict__ events, int* __restrict__ scatters, int* __restrict__ next) {
  const float *bmin = P.v + P_BMIN, *bmax = P.v + P_BMAX, *extent = P.v + P_EXTENT;
  const float *ext = P.v + P_EXT, *aext = P.v + P_AEXT, *sext = P.v + P_SEXT;
  const float maj = P.v[P_MAJ];
  const Phase pc{(int)P.v[P_ISO], P.v[P_OMG2], P.v[P_OMG], P.v[P_TWOG], P.v[P_HALFG], P.v[P_OPG2]};
  const uint2 ktv = *kt;
  const SparseBricks sgrid{grid, table, block, (ny + block - 1) / max(block, 1),
                           (nx + block - 1) / max(block, 1)};
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  // The warp's claimed indices [pool, pool_end), the same in every lane;
  // `drained` once the counter has passed N.
  int pool = 0, pool_end = 0;
  bool drained = false;
  // The lane's ray: its index, what its next step does, its state and its
  // events so far; kev is the key of the event whose scatter is pending.
  bool active = false;
  int i = 0, j = 0, ev = 0, nsc = 0, step = ST_DONE;
  V3 x{0.0f, 0.0f, 0.0f}, w{0.0f, 0.0f, 0.0f}, fx{0.0f, 0.0f, 0.0f};
  float d = 0.0f;
  float wt[3] = {1.0f, 1.0f, 1.0f};
  bool alive = false, absorbed = false, scattered = false;
  uint2 key = make_uint2(0u, 0u), kev = make_uint2(0u, 0u);
  for (;;) {
    // Lanes without a ray take the next indices of the warp's pool, in lane
    // order; an empty pool claims 32 more.
    unsigned idle = __ballot_sync(0xffffffffu, !active);
    while (idle != 0u && !drained) {
      if (pool == pool_end) {
        int b = 0;
        if (lane == 0) b = atomicAdd(next, 32);
        b = __shfl_sync(0xffffffffu, b, 0);
        if (b >= N) {
          drained = true;
          break;
        }
        pool = b;
        pool_end = min(b + 32, N);
      }
      const int take = min(__popc(idle), pool_end - pool);
      if (!active && __popc(idle & lt) < take) {
        i = pool + __popc(idle & lt);
        const V3 o{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
        w = V3{dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
        float t_min, t_max;
        const bool hit = box_intersect(bmin, bmax, o, w, t_min, t_max);
        x = V3{o.x + w.x * t_min, o.y + w.y * t_min, o.z + w.z * t_min};
        d = hit ? t_max - t_min : -1.0f;
        wt[0] = wt[1] = wt[2] = 1.0f;
        alive = hit;
        absorbed = scattered = false;
        fx = V3{0.0f, 0.0f, 0.0f};
        j = ev = nsc = 0;
        step = hit && max_events > 0 ? ST_KEY : ST_DONE;
        active = true;
      }
      pool += take;
      idle = __ballot_sync(0xffffffffu, !active);
    }
    if (!__any_sync(0xffffffffu, active)) break;
    // The step's three threefry draws, the same code in every lane: the
    // ray's key split(kt, .)[first + i]; an event's key k = split(key, j)
    // and its uniforms u1 and xi; or a scatter's k3 = split(k, 2) and the
    // phase function's two uniforms.
    const uint2 kk = tf_split(step == ST_KEY ? ktv : (step == ST_SCATTER ? kev : key),
                              step == ST_KEY ? (uint32_t)(first + i)
                                             : (step == ST_SCATTER ? 2u : (uint32_t)j));
    const float ua = tf_uniform(tf_split(kk, 0u));
    const float ub = tf_uniform(tf_split(kk, 1u));
    if (!active) continue;
    bool done = step == ST_DONE;
    if (step == ST_KEY) {
      key = kk;
      step = ST_EVENT;
    } else if (step == ST_SCATTER) {  // the direction of event j's scatter
      const V3 xn = x;
      const V3 wn = sample_phase(ua, ub, pc, w);
      float t2_min, t2_max;
      const bool hit2 = box_intersect(bmin, bmax, xn, wn, t2_min, t2_max);
      d = hit2 ? t2_max - t2_min : 0.0f;
      x = hit2 ? V3{xn.x + wn.x * t2_min, xn.y + wn.y * t2_min, xn.z + wn.z * t2_min} : xn;
      w = wn;
      ++nsc;
      if (!scattered) {
        fx = xn;
        scattered = true;
      }
      ++j;
      step = ST_EVENT;
      done = !(j < max_events && alive);
    } else if (step == ST_EVENT) {  // event j, as the plain version's loop takes it
      ++ev;
      const float fl = -logf(fmaxf(1e-10f, 1.0f - ua));
      const float t = POW2 ? fl * P.inv[0] : fl / maj;
      if (t > d) {
        done = true;  // the ray leaves the volume: its state stays as it is
      } else {
        const V3 xn{x.x + w.x * t, x.y + w.y * t, x.z + w.z * t};
        const float rel[3] = {xn.x - bmin[0], xn.y - bmin[1], xn.z - bmin[2]};
        float tp[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) tp[c] = POW2 ? rel[c] * P.inv[1 + c] : rel[c] / extent[c];
        const float dens = SPARSE ? density_at_sparse<INTERP>(sgrid, nz, ny, nx, tp, kk)
                                  : density_at<INTERP>(grid, nz, ny, nx, tp, kk);
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
          pa = POW2 ? sa[0] * P.inv[0] : sa[0] / maj;
          ps = POW2 ? ss[0] * P.inv[0] : ss[0] / maj;
          pn = POW2 ? sn[0] * P.inv[0] : sn[0] / maj;
        }
        const float xi = ub;
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
          for (int c = 0; c < 3; ++c)
            wt[c] = fminf(wt[c] * (scatter ? ss[c] : sn[c]) / den, 100.0f);
        }
        x = xn;
        if (scatter) {  // its direction in the next step
          kev = kk;
          step = ST_SCATTER;
        } else {
          d = d - t;
          ++j;
        }
        if (absorb) {
          absorbed = true;
          alive = false;
        }
        done = !scatter && !(j < max_events && alive);
      }
    }
    if (done) {  // the ray is dead: its outputs, and the lane is free
      const V3 bg = env != nullptr ? env_map_sample(env, he, we, w, P.v[P_ENVI])
                                   : sky_light(w, P.v + P_SUN, P.v + P_SUNIC);
      radiance[3 * i] = absorbed ? 0.0f : fminf(wt[0], 1e5f) * bg.x;
      radiance[3 * i + 1] = absorbed ? 0.0f : fminf(wt[1], 1e5f) * bg.y;
      radiance[3 * i + 2] = absorbed ? 0.0f : fminf(wt[2], 1e5f) * bg.z;
      first_x[3 * i] = fx.x;
      first_x[3 * i + 1] = fx.y;
      first_x[3 * i + 2] = fx.z;
      first_has[i] = scattered ? 1 : 0;
      if (events != nullptr) events[i] = ev;
      if (scatters != nullptr) scatters[i] = nsc;
      active = false;
    }
  }
}

template <int MODE, bool POW2, bool SPARSE>
static const void* vpt_instance_of(int interp) {
  if (interp == INTERP_TRILINEAR)
    return (const void*)vpt_kernel<MODE, INTERP_TRILINEAR, POW2, SPARSE>;
  if (interp == INTERP_NEAREST) return (const void*)vpt_kernel<MODE, INTERP_NEAREST, POW2, SPARSE>;
  return (const void*)vpt_kernel<MODE, INTERP_STOCHASTIC, POW2, SPARSE>;
}

// The instance of (mode, interp, pow2, sparse).
template <bool POW2, bool SPARSE>
static const void* vpt_instance(int mode, int interp) {
  if (mode == MODE_DELTA) return vpt_instance_of<MODE_DELTA, POW2, SPARSE>(interp);
  if (mode == MODE_SPECTRAL) return vpt_instance_of<MODE_SPECTRAL, POW2, SPARSE>(interp);
  return vpt_instance_of<MODE_RATIO, POW2, SPARSE>(interp);
}

// The dense grid's instances.
static const void* vpt_instance(int mode, int interp, bool pow2) {
  return pow2 ? vpt_instance<true, false>(mode, interp) : vpt_instance<false, false>(mode, interp);
}

// A SparseGrid's instances divide (no POW2 instances: a power of two's
// reciprocal rounds as the division does, so these give the same result).
static const void* vpt_sparse_instance(int mode, int interp) {
  return vpt_instance<false, true>(mode, interp);
}

// x is a power of two whose reciprocal is a normal float.
static bool power_of_two(float x) {
  int e = 0;
  return x > 0.0f && std::isfinite(x) && std::frexp(x, &e) == 0.5f && e > -125 && e < 126;
}

// Trace N rays on `stream`: grid the [nz, ny, nx] float32 grid in bricks
// (`kernels/volume_common.py:grid_bricks`) where `table` is null, else a
// `SparseGrid`'s bricks of `block`^3 voxels (and their apron) and its table
// of [ceil(nz / block), ceil(ny / block), ceil(nx / block)] brick indices; origins and dirs
// [N, 3], kt the trace's key (k0, k1) as two uint32 words on the device,
// of which ray i takes split(kt, .)[first + i], prm the P_COUNT parameters
// (host memory, passed by value), env
// [he, we, 3] or null (the sky and sun). Writes radiance [N, 3], first_x
// [N, 3], first_has [N] (0/1) and, if not null, events [N] (the events each
// ray ran) and scatters [N] (its scattering events). mode 0/1/2: Delta, Spectral Delta, Ratio tracking; interp
// 0/1/2: Trilinear, Nearest, Stochastic. `next`, one int on the device that
// the caller zeroes, counts the rays taken. The grid holds as many blocks
// as the card keeps resident, fewer where N needs fewer.
extern "C" int vpt_tracking_launch(const float* grid, const int* table, int block, int nz, int ny,
                                   int nx, const float* origins,
                                   const float* dirs, const unsigned int* kt, int first, int N,
                                   int max_events, int mode, int interp, const float* prm,
                                   const float* env, int he, int we, float* radiance,
                                   float* first_x, unsigned char* first_has, int* events,
                                   int* scatters, int* next, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || N < 0 || N > (1 << 30) || first < 0 || max_events < 0 ||
      mode < 0 || mode > 2 || interp < 0 || interp > 2 || (env != nullptr && (he < 1 || we < 1)) ||
      next == nullptr || (table != nullptr && block < 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  const bool pow2 = power_of_two(prm[P_MAJ]) && power_of_two(prm[P_EXTENT]) &&
                    power_of_two(prm[P_EXTENT + 1]) && power_of_two(prm[P_EXTENT + 2]);
  const void* f = vpt_instance(mode, interp, pow2);
  if (table != nullptr) f = vpt_sparse_instance(mode, interp);
  int dev = 0, n_sm = 0, per_sm = 0;
  int e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, VPT_THREADS, 0);
  if (e) return e;
  const int blocks = max(1, min(n_sm * per_sm, (N + VPT_THREADS - 1) / VPT_THREADS));
  const uint2* k = (const uint2*)kt;
  VptPrm P;
  memcpy(P.v, prm, sizeof(P.v));
  P.inv[0] = 1.0f / prm[P_MAJ];
  for (int c = 0; c < 3; ++c) P.inv[1 + c] = 1.0f / prm[P_EXTENT + c];
  void* args[] = {(void*)&grid, (void*)&table, (void*)&block, (void*)&nz, (void*)&ny, (void*)&nx, (void*)&origins,
                  (void*)&dirs, (void*)&k, (void*)&first, (void*)&N, (void*)&max_events,
                  (void*)&P, (void*)&env, (void*)&he, (void*)&we, (void*)&radiance,
                  (void*)&first_x, (void*)&first_has, (void*)&events, (void*)&scatters,
                  (void*)&next};
  e = (int)cudaLaunchKernel(f, dim3(blocks), dim3(VPT_THREADS), args, 0, (cudaStream_t)stream);
  return e ? e : (int)cudaGetLastError();
}

// The 27 instances' resources (i = 9 pow2 + 3 mode + interp, then the 9
// sparse ones at 18 + 3 mode + interp): v = (registers, local bytes, static
// shared bytes, resident blocks per SM, threads, 0), `label` its name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 26) return (int)cudaErrorInvalidValue;
  const void* f = i >= 18 ? vpt_sparse_instance(i % 9 / 3, i % 3)
                          : vpt_instance(i % 9 / 3, i % 3, i >= 9);
  cudaFuncAttributes at;
  int e = (int)cudaFuncGetAttributes(&at, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, VPT_THREADS, 0);
  if (e) return e;
  v[0] = at.numRegs;
  v[1] = (int)at.localSizeBytes;
  v[2] = (int)at.sharedSizeBytes;
  v[3] = nb;
  v[4] = VPT_THREADS;
  v[5] = 0;
  const char* modes[3] = {"delta", "spectral", "ratio"};
  const char* interps[3] = {" trilinear", " nearest", " stochastic"};
  int n = 0;
  for (const char* q = modes[i % 9 / 3]; *q && n < cap - 1; ++q) label[n++] = *q;
  for (const char* q = interps[i % 3]; *q && n < cap - 1; ++q) label[n++] = *q;
  for (const char* q = i >= 18 ? " sparse" : (i >= 9 ? " pow2" : ""); *q && n < cap - 1; ++q)
    label[n++] = *q;
  label[n] = 0;
  return 0;
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
