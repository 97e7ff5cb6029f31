// Shared by the per-op angular attention kernels, K7 (ang_attn.cu) and K8
// (ang_attn_sweep.cu): the softmax chunk, the block limits, cp.async row
// staging, whole-line stores from a staged tile, the chunk walk and the
// persistent grid.
#pragma once

#include <algorithm>
#include <type_traits>

#include "attn.cuh"
#include "tf32.cuh"

namespace lft {

constexpr int KB = 8;              // keys (or queries) a softmax or sum chunk (K1's)
constexpr int NT_MAX = 512;        // threads a block at most
constexpr int SMEM_TWO = 115712;   // bytes a block, two blocks an SM: (228 KB - 2 x 1 KB) / 2
constexpr int SMEM_MAX = 232448;   // bytes a block at most

inline int round32(int n) { return (n + 31) / 32 * 32; }

// rows [row0, row0 + rows) of a [*, W] tensor -> a [rows][LD] f32 tile, 4
// values a thread at a time: f32 by cp.async, bf16 (the `_bf16io`
// instances) by the thread's own loads widened to f32 (`copy4`)
template <int W, int LD, class IO>
__device__ __forceinline__ void stage_async(float* dst, const IO* __restrict__ src,
                                            size_t row0, int rows) {
  for (int i = threadIdx.x; i < rows * (W / 4); i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    copy4(dst + r * LD + c, src + (row0 + r) * W + c, true);
  }
}

// a [rows][LD] tile -> rows [row0, row0 + rows) of a [*, W] tensor, whole
// lines (bf16: each value rounded to nearest even)
template <int W, int LD, class IO>
__device__ __forceinline__ void store_rows(IO* __restrict__ dst, const float* src, size_t row0,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * (W / 4); i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    st4(dst + (row0 + r) * W + c, load4(src + r * LD + c));
  }
}

// columns [col0, col0 + W) of rows [row0, row0 + rows) of a [*, C] tensor ->
// a [rows][LD] f32 tile, 4 values a thread at a time (K8's head groups; f32
// by cp.async, bf16 widened by the thread)
template <int C, int W, int LD, class IO>
__device__ __forceinline__ void stage_cols(float* dst, const IO* __restrict__ src, size_t row0,
                                           int rows, int col0) {
  for (int i = threadIdx.x; i < rows * (W / 4); i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    copy4(dst + r * LD + c, src + (row0 + r) * C + col0 + c, true);
  }
}

// a [rows][LD] tile -> columns [col0, col0 + W) of rows [row0, row0 + rows)
// of a [*, C] tensor, 4 values a thread at a time
template <int C, int W, int LD, class IO>
__device__ __forceinline__ void store_cols(IO* __restrict__ dst, const float* src, size_t row0,
                                           int rows, int col0) {
  for (int i = threadIdx.x; i < rows * (W / 4); i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    st4(dst + (row0 + r) * C + col0 + c, load4(src + r * LD + c));
  }
}

// f(j0, full) for the chunks of KB keys (or queries) of n: the whole ones
// with full a std::true_type, so that their loops run without per-key
// predicates, then a last partial one
template <class F>
__device__ __forceinline__ void chunks(int n, F&& f) {
  int j0 = 0;
  for (; j0 + KB <= n; j0 += KB) f(j0, std::true_type{});
  if (j0 < n) f(j0, std::false_type{});
}

// A persistent launch's grid: as many blocks as fit the card, at most one a
// tile. Sets the kernel's shared memory first.
template <class Kernel>
int persistent_grid(Kernel kernel, int nt, size_t bytes, int tiles, int* grid) {
  LFT_SET_SMEM(kernel, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = std::min(tiles, sms * per_sm);
  return 0;
}

}  // namespace lft
