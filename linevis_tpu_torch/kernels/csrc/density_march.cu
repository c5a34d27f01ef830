// The line density map's ray march for Hopper (sm_90a): kernel R4.
//
// Port-only: the JAX package writes the march as a `lax.scan` of 256 steps
// over all pixels at once (linevis_tpu/render/line_density_map.py:51-93,
// `render_line_density_map`); it reaches no pl.pallas_call. The kernel
// computes the same function per pixel, one thread a pixel: the jittered-
// free pixel ray from the camera basis, its clip to the field's box, the
// fixed 256 steps of voxel_size / 10 (each a trilinear sample, the
// piecewise-linear transfer function `tf_eval` of capsule_common.cuh,
// alpha = 1 - exp(-a step attenuation) and the front-to-back blend), then
// the background under the remaining transmittance. A step at or past the
// box's far end has alpha 0 and adds exactly nothing, so the loop stops
// there. Each operation rounds as in the plain version
// (`kernels/density_march.py:density_march_reference`), so the two agree
// bit for bit on the card.
#include <cuda_runtime.h>

#include "capsule_common.cuh"
#include "volume_common.cuh"

#define DM_THREADS 128

// prm: [0-2] b_min, [3-5] b_max, [6-8] extent, [9-11] ray origin, [12-20]
// the row-major ray basis (component c of column k at 3c + k), [21] step,
// [22] attenuation, [23] 2 / width, [24] 2 / height, [25-28] background.
__global__ void __launch_bounds__(DM_THREADS)
density_march_kernel(const float* __restrict__ field, int nz, int ny, int nx, int width,
                     int height, int n_steps, const float* __restrict__ prm,
                     const float* __restrict__ tf, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width * height) return;
  const int px = i % width, py = i / width;
  const float u = ((float)px + 0.5f) * prm[23] - 1.0f;
  const float v = 1.0f - ((float)py + 0.5f) * prm[24];
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = prm[12 + 3 * c] * u + prm[13 + 3 * c] * v + prm[14 + 3 * c];
  const float n = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = d[c] / n;
    const float inv = 1.0f / (fabsf(d[c]) < 1e-9f ? 1e-9f : d[c]);
    const float t0 = (prm[c] - prm[9 + c]) * inv;
    const float t1 = (prm[3 + c] - prm[9 + c]) * inv;
    lo = c == 0 ? fminf(t0, t1) : fmaxf(lo, fminf(t0, t1));
    hi = c == 0 ? fmaxf(t0, t1) : fminf(hi, fmaxf(t0, t1));
  }
  const float t_near = fmaxf(lo, 0.0f), t_far = hi;
  const bool hit = t_far > t_near;
  const float step = prm[21], att = prm[22];
  const int nc = (int)tf[0], no = (int)tf[1];
  const float* tf_c = tf + 2;
  const float* tf_o = tf_c + 3 + (nc - 1) * 9;
  float acc[3] = {0.0f, 0.0f, 0.0f}, acc_a = 0.0f;
  for (int k = 0; k < n_steps && hit; ++k) {
    const float t = t_near + ((float)k + 0.5f) * step;
    if (!(t < t_far)) break;  // alpha 0 from here on: nothing more adds
    const float tex[3] = {(prm[9] + t * d[0] - prm[0]) / prm[6], (prm[10] + t * d[1] - prm[1]) / prm[7],
                          (prm[11] + t * d[2] - prm[2]) / prm[8]};
    const float dens = trilinear(field, nz, ny, nx, tex[0], tex[1], tex[2]);
    float rgb[3], a_tf;
    tf_eval<3>(tf_c, nc, dens, rgb);
    tf_eval<1>(tf_o, no, dens, &a_tf);
    const float alpha = 1.0f - expf(-a_tf * step * att);
    const float w = (1.0f - acc_a) * alpha;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + w * rgb[c];
    acc_a = acc_a + w;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[4 * i + c] = acc[c] + (1.0f - acc_a) * prm[25 + c];
  out[4 * i + 3] = acc_a;
}

// March every pixel of a width x height frame on `stream`: field [nz, ny,
// nx] float32, prm the 29 parameters above, tf the `tf_static_table` of
// both transfer functions; out [height, width, 4] RGBA.
extern "C" int density_march_launch(const float* field, int nz, int ny, int nx, int width,
                                    int height, int n_steps, const float* prm, const float* tf,
                                    float* out, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || width < 0 || height < 0 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  const int n = width * height;
  if (n > 0)
    density_march_kernel<<<(n + DM_THREADS - 1) / DM_THREADS, DM_THREADS, 0,
                           (cudaStream_t)stream>>>(field, nz, ny, nx, width, height, n_steps, prm,
                                                   tf, out);
  return (int)cudaGetLastError();
}
