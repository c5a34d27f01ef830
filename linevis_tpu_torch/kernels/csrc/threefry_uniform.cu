// jax.random.uniform on the card (sm_90a): kernel R6.
//
// Port-only: the JAX package draws RTAO's and the AO bake's hemisphere
// samples with `jax.random.uniform` inside `_cosine_hemisphere`
// (linevis_tpu/render/rtao.py:58-64, render/ao_bake.py:124-129), which XLA
// fuses; it reaches no pl.pallas_call. The plain version,
// `ops/threefry.py:uniform`, runs threefry2x32 in int64 tensors masked to
// 32 bits, about 20 launches a round, ~3 ms for 2 M keys on the card; a
// 1080p RTAO frame draws 2 x 8,294,400.
//
// One thread an element, grid-stride: out[i] = tf_uniform(k, i), the flat
// index i as the counter (0, i), exactly as jax.random.uniform with
// `jax_threefry_partitionable` for shapes of fewer than 2^32 elements. k is
// the key read from device memory (int64 [2], each word < 2^32), or with
// split >= 0 its half split(key)[split], derived once a thread: the two
// draws of RTAO's `_cosine_hemisphere` are two launches on the frame's
// key, with no split on the host and no host read. Bound: the 4 n bytes written and
// ~100 integer operations an element (20 rounds of add, rotate, xor; five
// key injections; the float conversion); both far below the launch for
// small n, and at 8 M elements ~10 us of writes against ~12 us of ALU.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define TU_THREADS 256
#define TU_MAX_BLOCKS (132 * 16)

__global__ void __launch_bounds__(TU_THREADS)
threefry_uniform_kernel(const long long* __restrict__ key, int split, unsigned int n,
                        float* __restrict__ out) {
  uint2 k = make_uint2((uint32_t)key[0], (uint32_t)key[1]);
  if (split >= 0) k = tf_split(k, (uint32_t)split);
  for (unsigned int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = tf_uniform(k, i);
}

// out[i] = element i of jax.random.uniform(key, (n,)) for i < n (of
// uniform(split(key)[split], (n,)) with split >= 0), on `stream`; key is
// int64 [2] on the device.
extern "C" int threefry_uniform_launch(const long long* key, int split, long long n,
                                       float* out, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    long long blocks = (n + TU_THREADS - 1) / TU_THREADS;
    if (blocks > TU_MAX_BLOCKS) blocks = TU_MAX_BLOCKS;
    threefry_uniform_kernel<<<(unsigned int)blocks, TU_THREADS, 0, (cudaStream_t)stream>>>(
        key, split, (unsigned int)n, out);
  }
  return (int)cudaGetLastError();
}
