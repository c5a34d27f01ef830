// The path tracer's decomposition tracking for Hopper (sm_90a): kernel R7.
//
// Port-only: the JAX package writes this estimator as the vmapped
// `lax.scan` of `trace_one` in linevis_tpu/render/vpt.py:342-473
// (`_decomposition_trace`, Kutz et al. 2017); it reaches no
// pl.pallas_call. The kernel computes the same function per ray until the
// ray dies (absorbed, or out of the grid of super voxels) or has run
// max_events events: the scan runs dead rays to its end with their state
// frozen, so the result is the same. Each event is one step of the scan's
// flat state machine:
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
// + i], event j's key k_j = split(key, .)[j], its five keys split(k_j, 5),
// each uniform uniform(k_c); the phase function's two uniforms come from
// split(k_5). The grid is read in 8^3 bricks (`grid_bricks`, R3's copy),
// the per-super-voxel min and max from `render/super_voxel.py:
// build_super_voxel_minmax`. Each operation rounds as in the plain version,
// `kernels/vpt_decomposition.py:vpt_decomposition_reference`
// (`volume_common.cuh` / `volume_common.py`): logf as torch.log, IEEE
// division, no contraction (--fmad=false), so the two agree bit for bit.
//
// What bounds it (`tools/kernel_split.py --kernels r7` on the 1080p cloud
// sample): rays run from 0 events (a miss) to the 512-event cap, so a warp
// of 32 neighbouring rays run one a thread until its longest ray ends keeps
// most lanes idle; the branches of an event draw different numbers of
// threefry (67 integer operations each, at half the float rate), one after
// another where a warp's lanes sit on different branches; and every event
// reloaded its super voxel's min and max and recomputed the exit face with
// six IEEE divisions. So:
//  - the grid is persistent (as many warps as the card keeps resident):
//    each warp claims rays 32 indices at a time from a global counter
//    (`next`), and a lane whose ray dies takes the next index of its warp's
//    claim (ballot and popcount), until the counter runs out;
//  - a lane's step is one of: derive its ray's key, run an event (enter or
//    one residual candidate), draw a collision's absorption test, or turn
//    its ray after a scatter. Each makes its draws as five threefry of one
//    shape (a key, two keys of it, a uniform of each), so every lane hashes
//    in the same code. An event's second uniform is the density test's,
//    drawn with the first, since draws are pure functions of the keys; an
//    empty super voxel's skip draws nothing and runs where the super voxel
//    is entered, with no step of its own;
//  - a super voxel's state (mu_c, mu_r, the exit face's distance and axis,
//    whether it is empty) lives in registers from its entry to its exit: it
//    changes only where the ray enters a super voxel, crosses a face or
//    scatters, and is computed there in the plain version's operations,
//    but for the exit face's larger quotient of each axis, which it takes
//    as the one of the face ahead (the same value: three divisions, not
//    six);
//  - the IEEE divisions by the extents and the super voxels' extent become
//    multiplications by their reciprocals where those are powers of two
//    (template POW2, as R3's), which round alike.
// Each ray still runs in one thread, keyed and written by its own index,
// with the plain version's operations in its order, so the result does not
// depend on the schedule.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cmath>

#include "threefry.cuh"
#include "volume_common.cuh"

#define VD_THREADS 128
// Resident blocks of VD_THREADS an SM the launch bounds ask for (at most
// 65536 / (VD_MIN_BLOCKS x VD_THREADS) registers a thread).
#define VD_MIN_BLOCKS 4

// Parameter layout of `prm` (`kernels/vpt_decomposition.py:DecompositionParams.array`).
enum {
  Q_BMIN = 0, Q_BMAX = 3, Q_EXTENT = 6, Q_CELL = 9, Q_SVN = 12, Q_MAJ = 15, Q_ABS = 16,
  Q_ISO = 17, Q_OMG2 = 18, Q_OMG = 19, Q_TWOG = 20, Q_HALFG = 21, Q_OPG2 = 22, Q_SUN = 23,
  Q_SUNIC = 26, Q_ENVI = 29, Q_COUNT = 30
};
// What a lane's next step does: derive its ray's key, run an event, draw a
// collision's absorption test, turn the ray of a scatter, or write a dead
// ray's outputs.
enum { ST_KEY = 0, ST_EVENT = 1, ST_COLLIDE = 2, ST_SCATTER = 3, ST_DONE = 4 };
// The columns of `kinds` (`EVENT_KINDS`): 0-5 partition the events; 6
// counts the collisions whose residual candidate was tested first.
enum {
  K_SKIP = 0, K_ENTER = 1, K_RESIDUAL = 2, K_TESTED = 3, K_ABSORB = 4, K_SCATTER = 5,
  K_TESTED_COLLISION = 6, K_COUNT = 7
};

// The parameters passed by value (read from the constant bank). inv: the
// reciprocals of the box's extents and of the super voxels' extents.
struct VdPrm {
  float v[Q_COUNT];
  float inv[6];
};

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// jax.random's uniform of a threefry output x = threefry2x32(k, 0, c):
// tf_uniform(k, c) without its hash.
__device__ __forceinline__ float bits_uniform(uint2 x) {
  const uint32_t b = ((x.x ^ x.y) >> 9) | 0x3F800000u;
  float f;
  memcpy(&f, &b, 4);
  return f - 1.0f;
}

// (x - lo) / d, or times its reciprocal r where d is a power of two.
template <bool POW2>
__device__ __forceinline__ float rel(float x, float lo, float d, float r) {
  return POW2 ? (x - lo) * r : (x - lo) / d;
}

// The super-voxel index of point x along axis c: clamp(floor((x - bmin) /
// cell), 0, n - 1), as floats.
template <bool POW2>
__device__ __forceinline__ float sv_index(float x, float bmin, float cell, float inv, float n) {
  return fminf(fmaxf(floorf(rel<POW2>(x, bmin, cell, inv)), 0.0f), n - 1.0f);
}

// At least VD_MIN_BLOCKS resident blocks an SM. POW2: the box's and the
// super voxels' extents are powers of two (their reciprocals multiply).
template <bool POW2>
__global__ void __launch_bounds__(VD_THREADS, VD_MIN_BLOCKS)
vd_kernel(const float* __restrict__ grid, int nz, int ny, int nx,
          const float* __restrict__ dmin_g, const float* __restrict__ dmax_g, int sy, int sx,
          const float* __restrict__ origins, const float* __restrict__ dirs,
          const uint2* __restrict__ kt, int first, int N, int max_events,
          const __grid_constant__ VdPrm P, const float* __restrict__ env, int he, int we,
          float* __restrict__ radiance, int* __restrict__ events, int* __restrict__ kinds,
          int* __restrict__ next) {
  const float *bmin = P.v + Q_BMIN, *bmax = P.v + Q_BMAX, *extent = P.v + Q_EXTENT;
  const float *cell = P.v + Q_CELL, *svn = P.v + Q_SVN;
  const float maj = P.v[Q_MAJ], abs_albedo = P.v[Q_ABS];
  // Uniforms lie in [0, 1): without a positive absorption share no
  // collision absorbs, and its test draws nothing.
  const bool absorbing = abs_albedo > 0.0f;
  const Phase pc{(int)P.v[Q_ISO], P.v[Q_OMG2], P.v[Q_OMG], P.v[Q_TWOG], P.v[Q_HALFG], P.v[Q_OPG2]};
  const uint2 ktv = *kt;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  // The warp's claimed indices [pool, pool_end), the same in every lane;
  // `drained` once the counter has passed N.
  int pool = 0, pool_end = 0;
  bool drained = false;
  // The lane's ray: its index, what its next step does, event j and the
  // events so far, its point, direction and super voxel; t_hit the flight
  // of a pending collision, kj its event's key. `fresh`: the super voxel's
  // state below is to be computed (the ray entered it).
  bool active = false, in_sv = false, absorbed = false, fresh = false;
  int i = 0, j = 0, ev = 0, step = ST_DONE;
  float x[3] = {0.0f, 0.0f, 0.0f}, w[3] = {0.0f, 0.0f, 0.0f}, idx[3] = {0.0f, 0.0f, 0.0f};
  float t_c = 0.0f, t_r = 0.0f, t_hit = 0.0f;
  uint2 key = make_uint2(0u, 0u), kj = make_uint2(0u, 0u);
  // The super voxel's state: control and residual majorants, the distance
  // to its exit face and that face's axis.
  float mu_c = 1e-10f, mu_r = 1e-10f, d_seg = 0.0f;
  int axis = 0;
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
        w[0] = dirs[3 * i];
        w[1] = dirs[3 * i + 1];
        w[2] = dirs[3 * i + 2];
        float t_min, t_max;
        const bool hit = box_intersect(bmin, bmax, o, V3{w[0], w[1], w[2]}, t_min, t_max);
        const float t_in = t_min + 1e-6f;
        x[0] = o.x + w[0] * t_in;
        x[1] = o.y + w[1] * t_in;
        x[2] = o.z + w[2] * t_in;
#pragma unroll
        for (int c = 0; c < 3; ++c) idx[c] = sv_index<POW2>(x[c], bmin[c], cell[c], P.inv[3 + c], svn[c]);
        t_c = t_r = 0.0f;
        in_sv = absorbed = false;
        j = ev = 0;
        step = hit && max_events > 0 ? ST_KEY : ST_DONE;
        fresh = step != ST_DONE;
        active = true;
      }
      pool += take;
      idle = __ballot_sync(0xffffffffu, !active);
    }
    if (!__any_sync(0xffffffffu, active)) break;
    // The step's five threefry, the same code in every lane: h0 = split(X,
    // c), h1 and h2 two keys of it, a uniform of each. KEY: the ray's key
    // split(kt, first + i). EVENT: k_j = split(key, j), the control
    // flight's or the residual candidate's uniform (split(k_j, 0 or 1)) and
    // the density test's (split(k_j, 2)). COLLIDE: split(k_j, 3), whose
    // uniform is h1's bits. SCATTER: k_5 = split(k_j, 4) and the phase
    // function's two uniforms (split(k_5, 0 and 1)).
    const uint2 kx = step == ST_KEY ? ktv : (step == ST_EVENT ? key : kj);
    const uint32_t cx = step == ST_KEY ? (uint32_t)(first + i)
                                       : (step == ST_EVENT ? (uint32_t)j
                                                           : (step == ST_COLLIDE ? 3u : 4u));
    const uint2 h0 = tf_split(kx, cx);
    const uint2 h1 = tf_split(h0, step == ST_EVENT && in_sv ? 1u : 0u);
    const uint2 h2 = tf_split(h0, step == ST_EVENT ? 2u : 1u);
    const float ua = tf_uniform(h1), ub = tf_uniform(h2);
    if (!active) continue;
    bool done = step == ST_DONE, advance = false;
    if (step == ST_KEY) {
      key = h0;
      step = ST_EVENT;
    } else if (step == ST_EVENT) {  // event j
      ++ev;
      const float q = logf(fmaxf(1.0f - ua, 1e-10f)) / (in_sv ? mu_r : mu_c);
      if (!in_sv) {  // enter: the control flight
        t_c = -q;
        t_r = 0.0f;
        in_sv = true;
        if (kinds != nullptr) kinds[K_COUNT * i + K_ENTER] += 1;
        ++j;
      } else {  // one residual candidate
        const float t_r_new = t_r - q;
        if ((t_c >= d_seg) && (t_r_new >= d_seg)) {  // neither flight inside
          t_r = t_r_new;
          in_sv = false;
          advance = true;
          if (kinds != nullptr) kinds[K_COUNT * i + K_RESIDUAL] += 1;
          ++j;
        } else {
          t_hit = fminf(t_c, t_r_new);
          bool collision = t_c <= t_r_new;
          if (!collision) {
            float tp[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) tp[c] = rel<POW2>(x[c] + w[c] * t_hit, bmin[c], extent[c], P.inv[c]);
            const float dens = trilinear_bricked(grid, nz, ny, nx, tp[0], tp[1], tp[2]);
            collision = ub * mu_r < maj * dens - mu_c;
            if (kinds != nullptr)
              kinds[K_COUNT * i + (collision ? K_TESTED_COLLISION : K_TESTED)] += 1;
          }
          if (collision) {  // its absorption test, or its turn, in the next step
            t_r = 0.0f;
            kj = h0;
            step = absorbing ? ST_COLLIDE : ST_SCATTER;
          } else {
            t_r = t_r_new;
            ++j;
          }
        }
      }
    } else if (step == ST_COLLIDE) {  // u3 = uniform(split(k_j, 3))
      if (bits_uniform(h1) < abs_albedo) {
        absorbed = true;
        done = true;
        if (kinds != nullptr) kinds[K_COUNT * i + K_ABSORB] += 1;
      } else {
        step = ST_SCATTER;
      }
    } else if (step == ST_SCATTER) {  // a new direction, the super voxel of the point entered anew
      const V3 wn = sample_phase(ua, ub, pc, V3{w[0], w[1], w[2]});
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c] = x[c] + w[c] * t_hit;
        idx[c] = sv_index<POW2>(x[c], bmin[c], cell[c], P.inv[3 + c], svn[c]);
      }
      w[0] = wn.x;
      w[1] = wn.y;
      w[2] = wn.z;
      in_sv = false;
      fresh = true;
      if (kinds != nullptr) kinds[K_COUNT * i + K_SCATTER] += 1;
      ++j;
      step = ST_EVENT;
    }
    // Across the exit face, and on through empty super voxels: each skip is
    // an event that draws nothing. Out of the grid, the ray escapes.
    for (;;) {
      if (advance) {
        const float st = d_seg + 1e-6f;
        bool out = false;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          x[c] = x[c] + w[c] * st;
          idx[c] = idx[c] + sign_f(w[c]) * (axis == c ? 1.0f : 0.0f);
          out = out || idx[c] < 0.0f || idx[c] >= svn[c];
        }
        advance = false;
        done = done || out;
        fresh = !out;
      }
      if (!done && step == ST_EVENT && j >= max_events) done = true;
      if (done || !fresh) break;
      // The super voxel entered: its state, as the plain version computes it
      // at every event.
      fresh = false;
      const int ix = (int)fminf(fmaxf(idx[0], 0.0f), svn[0] - 1.0f);
      const int iy = (int)fminf(fmaxf(idx[1], 0.0f), svn[1] - 1.0f);
      const int iz = (int)fminf(fmaxf(idx[2], 0.0f), svn[2] - 1.0f);
      const long long s = ((long long)iz * sy + iy) * sx + ix;
      const float d_min = __ldg(dmin_g + s), d_max = __ldg(dmax_g + s);
      mu_c = fmaxf(maj * d_min, 1e-10f);
      mu_r = fmaxf(maj * d_max - mu_c, 1e-10f);
      // The plain version's fmaxf((lo - x) / w, (hi - x) / w) is the quotient
      // of the face ahead: lo - x <= hi - x, and a correctly rounded division
      // by w is monotone (increasing for w > 0, decreasing for w < 0), so
      // the other quotient is never the larger; neither is a zero of the
      // other sign (|lo - x| is 0 or at least an ulp of the box's size, and
      // |w| <= 1). Where |w| < 1e-9 the plain version takes 1e30.
      float t_far[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lo = bmin[c] + idx[c] * cell[c];
        const float hi = lo + cell[c];
        const bool small = fabsf(w[c]) < 1e-9f;
        const float tf = ((w[c] > 0.0f ? hi : lo) - x[c]) / (small ? 1e-9f : w[c]);
        t_far[c] = small ? 1e30f : tf;
      }
      const bool a0 = (t_far[0] <= t_far[1]) && (t_far[0] <= t_far[2]);
      axis = a0 ? 0 : (t_far[1] <= t_far[2] ? 1 : 2);
      d_seg = fmaxf(fminf(fminf(t_far[0], t_far[1]), t_far[2]), 0.0f);
      if (!(d_max < 1e-5f)) break;  // not empty
      // Event j skips the empty super voxel.
      ++ev;
      if (kinds != nullptr) kinds[K_COUNT * i + K_SKIP] += 1;
      ++j;
      advance = true;
    }
    if (done) {  // the ray is dead: its outputs, and the lane is free
      const V3 wf{w[0], w[1], w[2]};
      const V3 bg = env != nullptr ? env_map_sample(env, he, we, wf, P.v[Q_ENVI])
                                   : sky_light(wf, P.v + Q_SUN, P.v + Q_SUNIC);
      radiance[3 * i] = absorbed ? 0.0f : bg.x;
      radiance[3 * i + 1] = absorbed ? 0.0f : bg.y;
      radiance[3 * i + 2] = absorbed ? 0.0f : bg.z;
      if (events != nullptr) events[i] = ev;
      active = false;
    }
  }
}

// x is a power of two whose reciprocal is a normal float.
static bool power_of_two(float x) {
  int e = 0;
  return x > 0.0f && std::isfinite(x) && std::frexp(x, &e) == 0.5f && e > -125 && e < 126;
}

static const void* vd_instance(bool pow2) {
  return pow2 ? (const void*)vd_kernel<true> : (const void*)vd_kernel<false>;
}

// Trace N rays on `stream`: grid the [nz, ny, nx] float32 grid in bricks
// (`kernels/volume_common.py:grid_bricks`), dmin and dmax the [sz, sy, sx]
// per-super-voxel min and max density, origins and dirs [N, 3], kt the
// trace's key (k0, k1) as two uint32 words on the device, of which ray i
// takes split(kt, .)[first + i], prm the Q_COUNT parameters (host memory,
// passed by value), env [he, we, 3] or null (the sky and sun). Writes
// radiance [N, 3] and, if not null, events [N] (the events each ray ran)
// and kinds [N, 7] (which the caller zeroes: each ray's events by kind, the
// K_* columns). `next`, one int on the device that the caller zeroes,
// counts the rays taken. The grid holds as many blocks as the card keeps
// resident, fewer where N needs fewer.
extern "C" int vpt_decomposition_launch(const float* grid, int nz, int ny, int nx,
                                        const float* dmin, const float* dmax, int sz, int sy,
                                        int sx, const float* origins, const float* dirs,
                                        const unsigned int* kt, int first, int N, int max_events,
                                        const float* prm, const float* env, int he, int we,
                                        float* radiance, int* events, int* kinds, int* next,
                                        void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || sz < 1 || sy < 1 || sx < 1 || N < 0 || N > (1 << 30) ||
      first < 0 || max_events < 0 || (env != nullptr && (he < 1 || we < 1)) || next == nullptr)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  bool pow2 = true;
  for (int c = 0; c < 3; ++c)
    pow2 = pow2 && power_of_two(prm[Q_EXTENT + c]) && power_of_two(prm[Q_CELL + c]);
  const void* f = vd_instance(pow2);
  int dev = 0, n_sm = 0, per_sm = 0;
  int e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, VD_THREADS, 0);
  if (e) return e;
  const int blocks = max(1, min(n_sm * per_sm, (N + VD_THREADS - 1) / VD_THREADS));
  VdPrm P;
  memcpy(P.v, prm, sizeof(P.v));
  for (int c = 0; c < 3; ++c) {
    P.inv[c] = 1.0f / prm[Q_EXTENT + c];
    P.inv[3 + c] = 1.0f / prm[Q_CELL + c];
  }
  const uint2* k = (const uint2*)kt;
  void* args[] = {(void*)&grid,   (void*)&nz,     (void*)&ny,     (void*)&nx,
                  (void*)&dmin,   (void*)&dmax,   (void*)&sy,     (void*)&sx,
                  (void*)&origins, (void*)&dirs,  (void*)&k,      (void*)&first,
                  (void*)&N,      (void*)&max_events, (void*)&P,  (void*)&env,
                  (void*)&he,     (void*)&we,     (void*)&radiance, (void*)&events,
                  (void*)&kinds,  (void*)&next};
  e = (int)cudaLaunchKernel(f, dim3(blocks), dim3(VD_THREADS), args, 0, (cudaStream_t)stream);
  return e ? e : (int)cudaGetLastError();
}

// The two instances' resources (0: IEEE divisions, 1: POW2): v =
// (registers, local bytes, static shared bytes, resident blocks per SM,
// threads, 0), `label` its name.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 1) return (int)cudaErrorInvalidValue;
  const void* f = vd_instance(i == 1);
  cudaFuncAttributes at;
  int e = (int)cudaFuncGetAttributes(&at, f);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, VD_THREADS, 0);
  if (e) return e;
  v[0] = at.numRegs;
  v[1] = (int)at.localSizeBytes;
  v[2] = (int)at.sharedSizeBytes;
  v[3] = nb;
  v[4] = VD_THREADS;
  v[5] = 0;
  const char* name = i == 1 ? "decomposition pow2" : "decomposition";
  int n = 0;
  for (const char* q = name; *q && n < cap - 1; ++q) label[n++] = *q;
  label[n] = 0;
  return 0;
}
