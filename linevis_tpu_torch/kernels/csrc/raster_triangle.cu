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
// Design (one block per tile, 2 x PIX_ROWS pixels a thread):
//  - Blocks take the tiles longest run first (`order`, the wrapper's sort
//    of `tile_num_chunks`): the longest runs start first instead of setting
//    the tail. Output goes to each tile's own slot, so the order changes no
//    pixel.
//  - The payload is [R, total_chunks, C]: one row of one chunk is C
//    contiguous floats. Only rows 0-15, which the slot loop reads, are
//    staged, slot-major: a slot's edge, depth and id planes come in as four
//    16-byte shared-memory broadcasts (each thread stages whole slots, its
//    loads coalesced along the slot axis). Two buffers: a chunk is staged
//    while no thread still reads the buffer it overwrites, so a chunk costs
//    one barrier.
//  - A thread owns 2 x PIX_ROWS pixels: each coefficient loaded serves them
//    all, and a plane's a*gx (b*gy) is shared by the pixels of a column
//    (row). Each plane is still (a * gx + b * gy) + c in float32, unfused, in
//    this order (the file builds with --fmad=false), exactly as the plain
//    PyTorch version `rasterize_triangles_reference` evaluates it (the TPU
//    runs the planes through its matrix unit). The inside tests of all the
//    thread's pixels come first and one branch holds the updates, so a slot
//    that covers none of them costs no branch; the slot loop is unrolled
//    by 4. On an H100 at 1080p a branch a pixel was 8% slower and no
//    unroll 6%; two lanes on each pixel group, on alternate slots and
//    merged at a chunk's end, cut the longest tile's time by a fifth but
//    were 6% slower in all (tools/kernel_split.py).
//  - One running winner a pixel (depth, id, slot): a slot replaces it when
//    strictly nearer, or at an equal depth with a lower id when the winner
//    is from the same chunk. That is the two-level rule above in one pass.
//    The winner's attribute planes are evaluated once, at the end, from its
//    slot's coefficients in device memory, with the same operations in the
//    same order; a pixel that never wins gets 0 there.
//  - Padded slots carry rejecting rows (edge c = -1, so e < 0) and lose
//    without a special case.
//  - Early-z chunk exit: a block max-reduction of the current depth is held
//    against the chunk's conservative minimum depth (row 15 of its first
//    slot; slots are sorted by it). Once a chunk lies behind every pixel of
//    the tile, so does the rest of the run.
//
// Bound on the H100: FP32 ALU. A (slot, pixel) evaluation costs 21 float
// operations (four planes of two multiplies and two adds, five compares)
// against 16 rows * 4 B of payload shared by the block's pixels, so the
// least time is
//   (slots in evaluated chunks) * P * 21 / 67 TFLOP/s,
// far above the time to read the payload once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "capsule_common.cuh"

#define PIX_ROWS 2                    // pixel rows a thread owns (2 columns each)
#define NPIX (2 * PIX_ROWS)
#define MAX_THREADS (512 / NPIX)      // a 32x16 tile
#define MIN_BLOCKS 4                  // resident blocks per SM: at most 128 registers
#define MAX_WARPS (MAX_THREADS / 32)
#define ROW_ATTR0 16

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
triangle_raster_kernel(const float* __restrict__ payload,
                       const int* __restrict__ tile_chunk_base,
                       const int* __restrict__ tile_num_chunks,
                       const int* __restrict__ order, float* __restrict__ out,
                       int* __restrict__ work, int total_chunks, int C, int n_tiles,
                       int tiles_x, int tile_w, int tile_h, int num_attr_planes,
                       int use_early_z) {
  extern __shared__ float4 s_slots[];  // [2][C][4]: rows 0-15 of each slot
  __shared__ float s_zmax[2][MAX_WARPS];

  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const long long row_stride = (long long)total_chunks * C;

  // The thread's pixels: columns px, px + 1 of rows py .. py + PIX_ROWS - 1.
  const int px = 2 * (tid % (tile_w / 2));
  const int py = PIX_ROWS * (tid / (tile_w / 2));
  const int x0 = (tile % tiles_x) * tile_w + px;
  const int y0 = (tile / tiles_x) * tile_h + py;
  float gx[2], gy[PIX_ROWS];
  gx[0] = (float)x0 + 0.5f;
  gx[1] = (float)(x0 + 1) + 0.5f;
#pragma unroll
  for (int r = 0; r < PIX_ROWS; ++r) gy[r] = (float)(y0 + r) + 0.5f;

  // Pixel k = 2 * row + column: its depth, id and winning payload slot.
  float depth[NPIX], fid[NPIX];
  int wslot[NPIX];
#pragma unroll
  for (int k = 0; k < NPIX; ++k) {
    depth[k] = 2.0f;
    fid[k] = -1.0f;
    wslot[k] = -1;
  }

  const int base = tile_chunk_base[tile];
  const int nch = tile_num_chunks[tile];
  int evaluated = 0;
  for (int c = 0; c < nch; ++c) {
    float4* const sb = s_slots + (c & 1) * C * 4;
    const float* const src = payload + (long long)(base + c) * C;
    for (int j = tid; j < C; j += T) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* r = src + 4 * q * row_stride + j;
        sb[j * 4 + q] = make_float4(r[0], r[row_stride], r[2 * row_stride], r[3 * row_stride]);
      }
    }
    if (use_early_z) {
      float zm = depth[0];
#pragma unroll
      for (int k = 1; k < NPIX; ++k) zm = fmaxf(zm, depth[k]);
      zm = warp_max(zm);
      if (lane == 0) s_zmax[c & 1][warp] = zm;
    }
    // The one barrier of a chunk: its rows (and the depth maxima) are
    // visible, and every thread is past chunk c - 1, so chunk c + 1 may
    // overwrite the other buffer.
    __syncthreads();
    if (use_early_z) {
      // Every thread computes the same reduction: the exit is uniform.
      float zfar = s_zmax[c & 1][0];
      for (int w = 1; w < nwarps; ++w) zfar = fmaxf(zfar, s_zmax[c & 1][w]);
      if (sb[3].w > zfar) break;  // row 15 of the chunk's first slot
    }
    ++evaluated;

    const int slot0 = (base + c) * C;  // payload column of the chunk's first slot
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      // Rows 0-3, 4-7, 8-11: (e0 a b c, e1 a), (e1 b c, e2 a b), (e2 c, z a b c).
      const float4 A = sb[j * 4 + 0];
      const float4 B = sb[j * 4 + 1];
      const float4 Z = sb[j * 4 + 2];
      float e0x[2], e1x[2], e2x[2], zx[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        e0x[i] = A.x * gx[i];
        e1x[i] = A.w * gx[i];
        e2x[i] = B.z * gx[i];
        zx[i] = Z.y * gx[i];
      }
      // The inside tests of all the thread's pixels first, then one
      // branch: a slot that covers none of them costs no branch a pixel.
      float z[NPIX];
      bool cover[NPIX];
      bool any = false;
#pragma unroll
      for (int r = 0; r < PIX_ROWS; ++r) {
        const float e0y = A.y * gy[r], e1y = B.x * gy[r], e2y = B.w * gy[r];
        const float zy = Z.z * gy[r];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 2 * r + i;
          const float e0 = (e0x[i] + e0y) + A.z;
          const float e1 = (e1x[i] + e1y) + B.y;
          const float e2 = (e2x[i] + e2y) + Z.x;
          z[k] = (zx[i] + zy) + Z.w;
          cover[k] = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z[k] >= 0.0f && z[k] <= 1.0f &&
                  z[k] <= depth[k];
          any = any || cover[k];
        }
      }
      if (any) {
        const float4 D = sb[j * 4 + 3];  // rows 12-15: the id plane
#pragma unroll
        for (int k = 0; k < NPIX; ++k) {
          if (!cover[k]) continue;
          const float id = (D.x * gx[k & 1] + D.y * gy[k >> 1]) + D.z;
          if (z[k] < depth[k] || (wslot[k] >= slot0 && id < fid[k])) {
            depth[k] = z[k];
            fid[k] = id;
            wslot[k] = slot0 + j;
          }
        }
      }
    }
  }

  const long long plane = (long long)n_tiles * tile_w * tile_h;
  float* const o = out + (long long)tile * tile_w * tile_h + py * tile_w + px;
#pragma unroll
  for (int r = 0; r < PIX_ROWS; ++r) {
    reinterpret_cast<float2*>(o + r * tile_w)[0] = make_float2(depth[2 * r], depth[2 * r + 1]);
    reinterpret_cast<float2*>(o + plane + r * tile_w)[0] = make_float2(fid[2 * r], fid[2 * r + 1]);
  }
  for (int p = 0; p < num_attr_planes; ++p) {
    const float* const a = payload + (ROW_ATTR0 + 3 * p) * row_stride;
    float* const op = o + (2 + p) * plane;
#pragma unroll
    for (int r = 0; r < PIX_ROWS; ++r) {
      float v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = wslot[2 * r + i];
        v[i] = s < 0 ? 0.0f : (a[s] * gx[i] + a[row_stride + s] * gy[r]) + a[2 * row_stride + s];
      }
      reinterpret_cast<float2*>(op + r * tile_w)[0] = make_float2(v[0], v[1]);
    }
  }
  if (work != nullptr && tid == 0) work[tile] = evaluated;
}

static size_t triangle_smem(int C) { return (size_t)2 * C * 4 * sizeof(float4); }

// Launches one block of tile_w * tile_h / (2 * PIX_ROWS) threads per tile
// on `stream`. payload: [16 + 3 * num_attr_planes or more rows,
// total_chunks, C] float32; order: [n_tiles] int32, the tiles in the order
// the blocks take them (a permutation). out: [2 + num_attr_planes, n_tiles,
// tile_w * tile_h] float32 (depth, id, planes). work: optional [n_tiles]
// int32, the chunks each tile evaluated after early-z. Returns a CUDA error
// code: cudaErrorInvalidValue for a tile the thread layout does not cover
// (tile_w even, tile_h a multiple of PIX_ROWS, whole warps, at most
// MAX_THREADS), else that of the launch.
extern "C" int raster_triangle_launch(const float* payload, const int* tile_chunk_base,
                                      const int* tile_num_chunks, const int* order, float* out,
                                      int* work, int total_chunks, int C, int n_tiles,
                                      int tiles_x, int tile_w, int tile_h, int num_attr_planes,
                                      int use_early_z, void* stream) {
  const int threads = tile_w * tile_h / NPIX;
  if (tile_w % 2 || tile_h % PIX_ROWS || threads % 32 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const size_t smem = triangle_smem(C);
    const cudaError_t e = cudaFuncSetAttribute(
        triangle_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    triangle_raster_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
        payload, tile_chunk_base, tile_num_chunks, order, out, work, total_chunks, C, n_tiles,
        tiles_x, tile_w, tile_h, num_attr_planes, use_early_z);
  }
  return (int)cudaGetLastError();
}

// Resources at a 32x16 and a 16x8 tile with chunk 128 (instance i = 0, 1):
// v = (registers, local bytes, static shared bytes, resident blocks per SM,
// threads, dynamic shared bytes), `label` its name. Returns a CUDA error
// code, cudaErrorInvalidValue past the last instance.
extern "C" int kernel_info(int i, int* v, char* label, int cap) {
  if (i < 0 || i > 1) return (int)cudaErrorInvalidValue;
  const int threads = (i == 0 ? 512 : 128) / NPIX;
  const char* nm = i == 0 ? "32x16 tile, chunk 128" : "16x8 tile, chunk 128";
  const size_t smem = triangle_smem(128);
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, (const void*)triangle_raster_kernel);
  int nb = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, triangle_raster_kernel,
                                                                  threads, smem);
  if (e) return e;
  v[0] = a.numRegs;
  v[1] = (int)a.localSizeBytes;
  v[2] = (int)a.sharedSizeBytes;
  v[3] = nb;
  v[4] = threads;
  v[5] = (int)smem;
  int k = 0;
  for (; nm[k] && k < cap - 1; ++k) label[k] = nm[k];
  label[k] = 0;
  return 0;
}
