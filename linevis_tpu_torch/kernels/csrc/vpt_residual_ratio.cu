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
//
// What bounds it (`tools/kernel_split.py --kernels r8` on the 1080p cloud
// sample): one thread ran a ray's three nested loops (bounces, DDA steps,
// residual steps), whose counts differ by orders of magnitude between
// neighbouring rays, so a warp ran until its longest ray ended and its lanes
// diverged at every level. The draws of the three kinds of step already
// have one shape: a key's three splits and two more threefry (a residual
// step: the next key, two keys and their uniforms; a bounce: the next key,
// the DDA's and the stop test's keys, the stop test's uniform and the
// phase function's key; a turn: two keys and their uniforms). So:
//  - the grid is persistent (as many warps as the card keeps resident):
//    each warp claims rays 32 indices at a time from a global counter
//    (`next`), and a lane whose ray ends takes the next index of its warp's
//    claim (ballot and popcount), until the counter runs out;
//  - a lane's step is one of: derive its ray's key, start a bounce (its
//    key chain, the box test and the DDA's set-up), take one residual step,
//    or turn its ray after a bounce. Each draws in the one threefry site,
//    so every lane hashes in the same code; the DDA's steps between
//    segments (and a segment's end) need no draw and run after the step
//    that reaches them, in the same code for every lane;
//  - the IEEE divisions by the box's extents become multiplications by
//    their reciprocals where those are powers of two (template POW2, as
//    R3's), which round alike.
// Each ray still runs in one thread, keyed and written by its own index,
// with the plain version's operations in its order, so the result does not
// depend on the schedule.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cmath>

#include "threefry.cuh"
#include "volume_common.cuh"

#define RR_THREADS 128
// Resident blocks of RR_THREADS an SM the launch bounds ask for (at most
// 65536 / (RR_MIN_BLOCKS x RR_THREADS) registers a thread).
#define RR_MIN_BLOCKS 4

// Parameter layout of `prm` (`kernels/vpt_residual_ratio.py:RrParams.array`).
enum {
  R_BMIN = 0, R_BMAX = 3, R_EXTENT = 6, R_CELL = 9, R_SVN = 12, R_EXT = 15, R_ALB = 16,
  R_ISO = 17, R_OMG2 = 18, R_OMG = 19, R_TWOG = 20, R_HALFG = 21, R_OPG2 = 22, R_SUN = 23,
  R_SUNIC = 26, R_ENVI = 29, R_COUNT = 30
};
// What a lane's next step does: derive its ray's key, start a bounce, take
// a residual step, turn the ray after a bounce, or write its outputs.
enum { ST_KEY = 0, ST_BOUNCE = 1, ST_RES = 2, ST_TURN = 3, ST_DONE = 4 };

// The parameters passed by value (read from the constant bank). inv: the
// reciprocals of the box's extents.
struct RrPrm {
  float v[R_COUNT];
  float inv[3];
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

// jax.random's uniform of a threefry output x = threefry2x32(k, 0, c):
// tf_uniform(k, c) without its hash.
__device__ __forceinline__ float bits_uniform(uint2 x) {
  const uint32_t b = ((x.x ^ x.y) >> 9) | 0x3F800000u;
  float f;
  memcpy(&f, &b, 4);
  return f - 1.0f;
}

// The DDA's exit from the current super voxel: t_next = the nearest face
// (or the ray's end), then the neighbour across that face (argmin: the
// first of equal values); s counts the steps.
__device__ __forceinline__ void dda_advance(float* idx, float* tm, const float* td,
                                            const float* w, float d_total, float& t_cur, int& s) {
  const float t_next = fminf(fminf(fminf(tm[0], tm[1]), tm[2]), d_total);
  const bool a0 = (tm[0] <= tm[1]) && (tm[0] <= tm[2]);
  const int axis = a0 ? 0 : (tm[1] <= tm[2] ? 1 : 2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (axis == c) {
      idx[c] = idx[c] + (w[c] > 0.0f ? 1.0f : (w[c] < 0.0f ? -1.0f : 0.0f));
      tm[c] = tm[c] + td[c];
    }
  }
  t_cur = t_next;
  ++s;
}

// At least RR_MIN_BLOCKS resident blocks an SM. TRANSMITTANCE: one DDA a
// ray, T alone. POW2: the box's extents are powers of two.
template <bool TRANSMITTANCE, bool POW2>
__global__ void __launch_bounds__(RR_THREADS, RR_MIN_BLOCKS)
rr_kernel(const RrGrids G, const float* __restrict__ origins, const float* __restrict__ dirs,
          const uint2* __restrict__ kt, int first, int N, int max_iterations,
          const __grid_constant__ RrPrm P, const float* __restrict__ env, int he, int we,
          float* __restrict__ radiance, float* __restrict__ first_x,
          unsigned char* __restrict__ first_has, int* __restrict__ steps,
          int* __restrict__ next) {
  const float *bmin = P.v + R_BMIN, *bmax = P.v + R_BMAX, *extent = P.v + R_EXTENT;
  const float *cell = P.v + R_CELL, *svn = P.v + R_SVN;
  const float ext = P.v[R_EXT], alb = P.v[R_ALB];
  const Phase pc{(int)P.v[R_ISO], P.v[R_OMG2], P.v[R_OMG], P.v[R_TWOG], P.v[R_HALFG],
                 P.v[R_OPG2]};
  const uint2 ktv = *kt;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  // The warp's claimed indices [pool, pool_end), the same in every lane;
  // `drained` once the counter has passed N.
  int pool = 0, pool_end = 0;
  bool drained = false;
  // The lane's ray: its index, what its next step does, its bounce and
  // counts; its key chain, the bounce's DDA key (advanced by each residual
  // step), the turn's key and the stop test's uniform; the bounce's start
  // and direction, the path's transmittance, the radiance and first
  // scatter so far.
  bool active = false, fh = false, hit = false;
  int i = 0, step = ST_DONE, it = 0, n_bounce = 0, n_dda = 0, n_res = 0;
  uint2 key = make_uint2(0u, 0u), key_res = make_uint2(0u, 0u), kp = make_uint2(0u, 0u);
  float xi = 0.0f, Tp = 1.0f;
  float x[3] = {0.0f, 0.0f, 0.0f}, w[3] = {0.0f, 0.0f, 0.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f}, fx[3] = {0.0f, 0.0f, 0.0f};
  // The bounce's DDA: its entry point, length, super voxel, next face
  // distances and their steps, its steps s, the distance t_cur and the
  // transmittance Tb so far; the reservoir (weight sum, T at the sample,
  // distance); the segment: its length, mu_c, mu_r, its residual distance t,
  // T_r and steps n.
  float xe[3] = {0.0f, 0.0f, 0.0f}, idx[3] = {0.0f, 0.0f, 0.0f};
  float tm[3] = {0.0f, 0.0f, 0.0f}, td[3] = {0.0f, 0.0f, 0.0f};
  float d_total = 0.0f, t_cur = 0.0f, Tb = 1.0f, wsum = 0.0f, rT = 0.0f, rdist = 0.0f;
  float d_seg = 0.0f, mu_c = 0.0f, mu_r = 1.0f, t = 0.0f, T_r = 1.0f;
  int s = 0, n = 0;
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
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          x[c] = origins[3 * i + c];
          w[c] = dirs[3 * i + c];
          acc[c] = fx[c] = 0.0f;
        }
        fh = false;
        Tp = 1.0f;
        it = n_bounce = n_dda = n_res = 0;
        step = ST_KEY;
        active = true;
      }
      pool += take;
      idle = __ballot_sync(0xffffffffu, !active);
    }
    if (!__any_sync(0xffffffffu, active)) break;
    // The step's five threefry, the same code in every lane: three keys of
    // K (a0, a1, a2 = split(K, c0), split(K, 1), split(K, 2)) and two more,
    // b0 and b1. KEY: a0 = split(kt, first + i). BOUNCE (K the key chain):
    // the next key a0, the DDA's key a1, the stop test's key a2 and its
    // uniform (b0's bits), the phase function's key b1 = split(K, 3). RES (K
    // the DDA's key): the next key a0, the free flight's uniform (b0 =
    // threefry(a1), u0 = uniform(split(K, 1))) and the reservoir's (b1,
    // uniform(split(K, 2))). TURN (K the phase function's key): the
    // uniforms of split(K, 0) and split(K, 1).
    const uint2 K = step == ST_KEY ? ktv
                                   : (step == ST_BOUNCE ? key : (step == ST_RES ? key_res : kp));
    const uint2 a0 = tf_split(K, step == ST_KEY ? (uint32_t)(first + i) : 0u);
    const uint2 a1 = tf_split(K, 1u);
    const uint2 a2 = tf_split(K, 2u);
    const uint2 b0 = tf_split(step == ST_TURN ? a0 : (step == ST_RES ? a1 : a2), 0u);
    const uint2 b1 = tf_split(step == ST_BOUNCE ? K : (step == ST_TURN ? a1 : a2),
                              step == ST_BOUNCE ? 3u : 0u);
    const float ua = bits_uniform(b0), ub = bits_uniform(b1);
    if (!active) continue;
    bool done = step == ST_DONE, start = false, seek = false, end = false;
    if (step == ST_KEY) {
      key = a0;
      if (TRANSMITTANCE) {  // one DDA keyed by the ray's key
        key_res = a0;
        n_bounce = 1;
        start = true;
      } else {
        step = ST_BOUNCE;
      }
    } else if (step == ST_BOUNCE) {
      ++n_bounce;
      key = a0;
      key_res = a1;
      xi = ua;
      kp = b1;
      start = true;
    } else if (step == ST_RES) {  // one step of the residual estimator
      ++n_res;
      ++n;
      key_res = a0;
      const float t_new = t - logf(fmaxf(1.0f - ua, 1e-10f)) / mu_r;
      float tp[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float p = (xe[c] + w[c] * t_cur) + w[c] * t_new;
        tp[c] = POW2 ? (p - bmin[c]) * P.inv[c] : (p - bmin[c]) / extent[c];
      }
      const float density = trilinear_bricked(G.grid, G.nz, G.ny, G.nx, tp[0], tp[1], tp[2]);
      const float mu = ext * density;
      const float factor = 1.0f - (mu - mu_c) / mu_r;
      const bool inside = t_new < d_seg;
      const float T_old = T_r;
      T_r = inside ? T_old * factor : T_old;
      const float Ps = alb * density;
      const float T_local = Tb * T_old * expf(-mu_c * t_new);
      const float rw = inside ? T_local * Ps : 0.0f;
      wsum = wsum + rw;
      const bool take = inside && (ub < rw / fmaxf(wsum, 1e-20f));
      rT = take ? T_local : rT;
      rdist = take ? t_cur + t_new : rdist;
      t = t_new;
      if (!(n < G.max_steps_per_sv && t < d_seg)) {  // the segment's end: T_c T_r
        Tb = Tb * (expf(-mu_c * d_seg) * T_r);
        dda_advance(idx, tm, td, w, d_total, t_cur, s);
        seek = true;
      }
    } else if (step == ST_TURN) {  // the next bounce's direction
      const V3 wn = sample_phase(ua, ub, pc, V3{w[0], w[1], w[2]});
      w[0] = wn.x;
      w[1] = wn.y;
      w[2] = wn.z;
      ++it;
      step = ST_BOUNCE;
    }
    if (start) {  // the bounce's DDA: the box, the entry, the first super voxel
      float t_min, t_max;
      hit = box_intersect(bmin, bmax, V3{x[0], x[1], x[2]}, V3{w[0], w[1], w[2]}, t_min, t_max);
      const float t_in = t_min + 1e-7f;
#pragma unroll
      for (int c = 0; c < 3; ++c) xe[c] = x[c] + w[c] * t_in;
      d_total = fmaxf(t_max - t_min - 2e-7f, 0.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float p0 = (xe[c] - bmin[c]) / cell[c];
        const float ix = fminf(fmaxf(floorf(p0), 0.0f), svn[c] - 1.0f);
        const float st = w[c] > 0.0f ? 1.0f : (w[c] < 0.0f ? -1.0f : 0.0f);
        const float aw = fabsf(w[c]);
        const bool small = aw < 1e-9f;
        const float inv = small ? 1e9f : 1.0f / aw;
        const float frac = p0 - ix;
        const float dist = st > 0.0f ? 1.0f - frac : frac;
        idx[c] = ix;
        td[c] = cell[c] * inv;
        tm[c] = small ? 1e9f : dist * cell[c] * inv;
      }
      t_cur = 0.0f;
      Tb = 1.0f;
      wsum = rT = rdist = 0.0f;
      s = 0;
      seek = true;
    }
    // On through the DDA to the next super voxel of non-zero length, whose
    // residual steps follow; a ray outside stays outside (the bounce ends).
    while (seek) {
      bool inside = s < G.max_sv_steps && t_cur < d_total;
#pragma unroll
      for (int c = 0; c < 3; ++c) inside = inside && idx[c] >= 0.0f && idx[c] < svn[c];
      if (!inside) {
        seek = false;
        end = true;
        break;
      }
      ++n_dda;
      const float t_next = fminf(fminf(fminf(tm[0], tm[1]), tm[2]), d_total);
      const float d = fmaxf(t_next - t_cur, 0.0f);
      if (d > 0.0f) {
        const long long sv = ((long long)(int)idx[2] * G.sy + (int)idx[1]) * G.sx + (int)idx[0];
        mu_c = __ldg(G.mu_c + sv);
        mu_r = __ldg(G.mu_r + sv);
        d_seg = d;
        if (G.max_steps_per_sv > 0) {
          t = 0.0f;
          T_r = 1.0f;
          n = 0;
          step = ST_RES;
          seek = false;
          break;
        }
        Tb = Tb * (expf(-mu_c * d_seg) * 1.0f);  // a segment of no residual steps
      }
      dda_advance(idx, tm, td, w, d_total, t_cur, s);
    }
    if (end) {  // the bounce's end
      const float T_seg = hit ? Tb : 1.0f;
      if (TRANSMITTANCE) {
        radiance[i] = T_seg;
        done = true;
      } else {
        const float T_new = Tp * T_seg;
        const bool stop = (xi > wsum) || (it >= max_iterations);
        const V3 wv{w[0], w[1], w[2]};
        const V3 bg = env != nullptr ? env_map_sample(env, he, we, wv, P.v[R_ENVI])
                                     : sky_light(wv, P.v + R_SUN, P.v + R_SUNIC);
        acc[0] = acc[0] + T_new * bg.x;
        acc[1] = acc[1] + T_new * bg.y;
        acc[2] = acc[2] + T_new * bg.z;
        float x_scat[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) x_scat[c] = xe[c] + w[c] * rdist;
        if (!stop && !fh) {
#pragma unroll
          for (int c = 0; c < 3; ++c) fx[c] = x_scat[c];
          fh = true;
        }
        Tp = stop ? T_new : rT;
        if (stop) {
          done = true;
        } else {  // the walk restarts from the reservoir's point, turned next step
#pragma unroll
          for (int c = 0; c < 3; ++c) x[c] = x_scat[c];
          step = ST_TURN;
        }
      }
    }
    if (done) {  // the ray's outputs, and the lane is free
      if (!TRANSMITTANCE) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          radiance[3 * i + c] = acc[c];
          first_x[3 * i + c] = fx[c];
        }
        first_has[i] = fh ? 1 : 0;
      }
      if (steps != nullptr) {
        steps[3 * i] = n_bounce;
        steps[3 * i + 1] = n_dda;
        steps[3 * i + 2] = n_res;
      }
      active = false;
    }
  }
}

// x is a power of two whose reciprocal is a normal float.
static bool power_of_two(float x) {
  int e = 0;
  return x > 0.0f && std::isfinite(x) && std::frexp(x, &e) == 0.5f && e > -125 && e < 126;
}

// The instance of (transmittance, pow2).
static const void* rr_instance(bool transmittance, bool pow2) {
  if (transmittance)
    return pow2 ? (const void*)rr_kernel<true, true> : (const void*)rr_kernel<true, false>;
  return pow2 ? (const void*)rr_kernel<false, true> : (const void*)rr_kernel<false, false>;
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
// grid and the residual steps, summed over the bounces. `next`, one int on
// the device that the caller zeroes, counts the rays taken. The grid holds
// as many blocks as the card keeps resident, fewer where N needs fewer.
extern "C" int vpt_residual_ratio_launch(const float* grid, int nz, int ny, int nx,
                                         const float* mu_c, const float* mu_r, int sz, int sy,
                                         int sx, const float* origins, const float* dirs,
                                         const unsigned int* kt, int first, int N,
                                         int max_iterations, int max_sv_steps,
                                         int max_steps_per_sv, int transmittance,
                                         const float* prm, const float* env, int he, int we,
                                         float* radiance, float* first_x,
                                         unsigned char* first_has, int* steps, int* next,
                                         void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || sz < 1 || sy < 1 || sx < 1 || N < 0 || N > (1 << 30) ||
      first < 0 || max_iterations < 0 || max_sv_steps < 0 || max_steps_per_sv < 0 ||
      (env != nullptr && (he < 1 || we < 1)) || next == nullptr)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();  // (an empty tensor's pointer is null)
  if (!transmittance && (first_x == nullptr || first_has == nullptr))
    return (int)cudaErrorInvalidValue;
  RrPrm P;
  memcpy(P.v, prm, sizeof(P.v));
  bool pow2 = true;
  for (int c = 0; c < 3; ++c) {
    pow2 = pow2 && power_of_two(prm[R_EXTENT + c]);
    P.inv[c] = 1.0f / prm[R_EXTENT + c];
  }
  const void* f = rr_instance(transmittance != 0, pow2);
  int dev = 0, n_sm = 0, per_sm = 0;
  int e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, RR_THREADS, 0);
  if (e) return e;
  const int blocks = max(1, min(n_sm * per_sm, (N + RR_THREADS - 1) / RR_THREADS));
  const RrGrids G{grid, nz, ny, nx, mu_c, mu_r, sy, sx, max_sv_steps, max_steps_per_sv};
  const uint2* k = (const uint2*)kt;
  void* args[] = {(void*)&G,        (void*)&origins, (void*)&dirs,      (void*)&k,
                  (void*)&first,    (void*)&N,       (void*)&max_iterations, (void*)&P,
                  (void*)&env,      (void*)&he,      (void*)&we,        (void*)&radiance,
                  (void*)&first_x,  (void*)&first_has, (void*)&steps,   (void*)&next};
  e = (int)cudaLaunchKernel(f, dim3(blocks), dim3(RR_THREADS), args, 0, (cudaStream_t)stream);
  return e ? e : (int)cudaGetLastError();
}

// The four instances' resources (i = 2 transmittance + pow2; 0: the
// estimator, 2: the transmittance): v = (registers, local bytes, static
// shared bytes, resident blocks per SM, threads, 0), `label` its name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 3) return (int)cudaErrorInvalidValue;
  const void* f = rr_instance(i >= 2, i % 2 == 1);
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
  const char* names[4] = {"residual ratio", "residual ratio pow2", "transmittance",
                          "transmittance pow2"};
  int n = 0;
  for (const char* q = names[i]; *q && n < cap - 1; ++q) label[n++] = *q;
  label[n] = 0;
  return 0;
}
