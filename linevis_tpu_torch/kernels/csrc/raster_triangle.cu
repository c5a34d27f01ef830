// Triangle tile rasterizer over the CSR chunk layout for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_raster_kernel` in
// linevis_tpu/kernels/raster_pallas.py:427 (wrappers
// `rasterize_depth_pallas`, :616, and `rasterize_gbuffer_pallas`, :634). It
// computes the same function: every per-fragment quantity of a triangle is
// an affine plane in screen space; for every screen tile the kernel walks
// that tile's chunks of triangle slots front to back, evaluates at each
// pixel centre the three edge planes and the depth plane of every slot,
// keeps the nearest covering triangle, and writes its depth, id and
// attribute planes (the G-buffer). Depth-only mode is the same kernel with
// no attribute planes.
//
// Selection rule, as on the TPU: inside a chunk the winner is the lowest id
// among the slots at the chunk's minimum depth; across chunks a later chunk
// wins only if strictly nearer. The CSR order is deterministic (stable
// sort), so the result is too.
//
// Design (one block per tile, one thread per pixel):
//  - The payload is [R, total_chunks, C]: one row of one chunk is C
//    contiguous floats. The block stages the 16 + 3 * planes rows of a chunk
//    into dynamic shared memory, coalesced along the slot axis; every thread
//    then reads each slot's coefficients as shared-memory broadcasts.
//  - The planes go through the TPU's matrix unit there; here each is
//    (a * gx + b * gy) + c in float32 on the ALUs, unfused, in this order
//    (the file builds with --fmad=false), exactly as the plain PyTorch
//    version `rasterize_triangles_reference` evaluates them.
//  - The attribute planes are evaluated for the chunk's winner only, after
//    the slot loop, not for every slot.
//  - Padded slots carry rejecting rows (edge c = -1, so e < 0) and lose
//    without a special case.
//  - Early-z chunk exit: before a chunk is staged, a block max-reduction of
//    the current depth is held against the chunk's conservative minimum
//    depth (row 15 of its first slot; slots are sorted by it). Once a chunk
//    lies behind every pixel of the tile, so does the rest of the run.
//
// Bound on the H100: FP32 ALU. A (slot, pixel) evaluation costs 21 float
// operations (four planes of two multiplies and two adds, five compares)
// against 40 rows * 4 B of payload shared by the block's up to 512 threads,
// so the least time is
//   (slots in evaluated chunks) * P * 21 / 67 TFLOP/s,
// far above the time to read the payload once. Speed work (cp.async/TMA
// double-buffered staging, skipping a slot on its first failed edge,
// several tiles per block) is left to later changes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "capsule_common.cuh"

#define MAX_THREADS 512   // pixels per tile: 32x16 on the main path
#define ROW_Z 9
#define ROW_ID 12
#define ROW_ZMIN 15
#define ROW_ATTR0 16

__global__ void __launch_bounds__(MAX_THREADS)
triangle_raster_kernel(const float* __restrict__ payload,
                       const int* __restrict__ tile_chunk_base,
                       const int* __restrict__ tile_num_chunks,
                       float* __restrict__ out, int* __restrict__ work,
                       int total_chunks, int C, int n_tiles, int tiles_x, int tile_w,
                       int num_attr_planes, int use_early_z) {
  extern __shared__ float s[];  // [rows][C]
  __shared__ float s_zmax[32];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = P >> 5;
  const int rows = ROW_ATTR0 + 3 * num_attr_planes;
  const long long row_stride = (long long)total_chunks * C;

  const float gx = (float)((tile % tiles_x) * tile_w + tid % tile_w) + 0.5f;
  const float gy = (float)((tile / tiles_x) * (P / tile_w) + tid / tile_w) + 0.5f;

  const long long plane = (long long)n_tiles * P;
  float* o = out + (long long)tile * P + tid;
  float depth = 2.0f, fid = -1.0f;
  for (int j = 0; j < num_attr_planes; ++j) o[(2 + j) * plane] = 0.0f;

  const int base = tile_chunk_base[tile];
  const int nch = tile_num_chunks[tile];
  int evaluated = 0;
  for (int c = 0; c < nch; ++c) {
    const float* src = payload + (long long)(base + c) * C;
    if (use_early_z) {
      const float zm = warp_max(depth);
      if (lane == 0) s_zmax[warp] = zm;
      __syncthreads();
      // Every thread computes the same reduction: the exit is uniform.
      float zfar = s_zmax[0];
      for (int w = 1; w < nwarps; ++w) zfar = fmaxf(zfar, s_zmax[w]);
      if (src[ROW_ZMIN * row_stride] > zfar) break;
    }
    for (int i = tid; i < rows * C; i += P) {
      const int r = i / C, j = i - r * C;
      s[i] = src[(long long)r * row_stride + j];
    }
    __syncthreads();
    ++evaluated;

    // The chunk's nearest covering slot; equal depths go to the lower id.
    float bz = BIG, bid = BIG;
    int bslot = -1;
    for (int j = 0; j < C; ++j) {
      const float e0 = (s[0 * C + j] * gx + s[1 * C + j] * gy) + s[2 * C + j];
      const float e1 = (s[3 * C + j] * gx + s[4 * C + j] * gy) + s[5 * C + j];
      const float e2 = (s[6 * C + j] * gx + s[7 * C + j] * gy) + s[8 * C + j];
      const float z = (s[ROW_Z * C + j] * gx + s[(ROW_Z + 1) * C + j] * gy)
                      + s[(ROW_Z + 2) * C + j];
      if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z >= 0.0f && z <= 1.0f)) continue;
      if (z > bz) continue;
      const float id = (s[ROW_ID * C + j] * gx + s[(ROW_ID + 1) * C + j] * gy)
                       + s[(ROW_ID + 2) * C + j];
      if (z < bz || id < bid) {
        bz = z;
        bid = id;
        bslot = j;
      }
    }
    if (bslot >= 0 && bz < depth) {
      depth = bz;
      fid = bid;
      for (int j = 0; j < num_attr_planes; ++j) {
        const float* a = s + (ROW_ATTR0 + 3 * j) * C + bslot;
        o[(2 + j) * plane] = (a[0] * gx + a[C] * gy) + a[2 * C];
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  o[0 * plane] = depth;
  o[1 * plane] = fid;
  if (work != nullptr && tid == 0) work[tile] = evaluated;
}

// Launches one block of tile_w * tile_h threads per tile on `stream`.
// payload: [16 + 3 * num_attr_planes or more rows, total_chunks, C] float32.
// out: [2 + num_attr_planes, n_tiles, tile_w * tile_h] float32 (depth, id,
// planes). work: optional [n_tiles] int32, the chunks each tile evaluated
// after early-z. Returns the cudaGetLastError() code of the launch.
extern "C" int raster_triangle_launch(const float* payload, const int* tile_chunk_base,
                                      const int* tile_num_chunks, float* out, int* work,
                                      int total_chunks, int C, int n_tiles, int tiles_x,
                                      int tile_w, int tile_h, int num_attr_planes,
                                      int use_early_z, void* stream) {
  if (n_tiles > 0) {
    const size_t shared = (size_t)(ROW_ATTR0 + 3 * num_attr_planes) * C * sizeof(float);
    triangle_raster_kernel<<<n_tiles, tile_w * tile_h, shared, (cudaStream_t)stream>>>(
        payload, tile_chunk_base, tile_num_chunks, out, work, total_chunks, C, n_tiles,
        tiles_x, tile_w, num_attr_planes, use_early_z);
  }
  return (int)cudaGetLastError();
}
