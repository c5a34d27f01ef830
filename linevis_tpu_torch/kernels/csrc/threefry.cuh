// jax.random's Threefry-2x32 stream on the card: the device twin of
// `ops/threefry.py` (see there for the recipe). A key is a uint2 (x, y) =
// (k0, k1); every function is one threefry2x32 evaluation, so a kernel
// derives any key or uniform of the stream in registers from its ray key.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

__host__ __device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__host__ __device__ __forceinline__ uint2 threefry2x32(uint2 k, uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = tf_rotl(x1, rot[i % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.split(key, n)[i], any n > i.
__host__ __device__ __forceinline__ uint2 tf_split(uint2 key, uint32_t i) {
  return threefry2x32(key, 0u, i);
}

// Element i of jax.random.uniform(key, shape), float32 in [0, 1).
__host__ __device__ __forceinline__ float tf_uniform(uint2 key, uint32_t i = 0u) {
  const uint2 x = threefry2x32(key, 0u, i);
  const uint32_t b = ((x.x ^ x.y) >> 9) | 0x3F800000u;
  float f;
  memcpy(&f, &b, 4);
  return f - 1.0f;
}
