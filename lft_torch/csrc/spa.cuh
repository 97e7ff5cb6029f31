// Shared by the SpaTrans and window-attention kernels: the 5x5 window's
// radius, K11's pixel-major row map and the launch helpers.
#pragma once

#include "common.cuh"

namespace lft {

constexpr int R = 2;  // the 5x5 window's radius

// Token t of the view-major [Bb * A2, hw] order -> its row in a pixel-major
// [Bb, hw, A2] buffer (K11).
__device__ __forceinline__ long long pm_row(long long t, int hw, int A2) {
  const long long view = t / hw;
  return ((view / A2) * hw + t % hw) * A2 + view % A2;
}

}  // namespace lft

#define LFT_SET_SMEM(kernel, bytes)                                            \
  do {                                                                         \
    cudaError_t e_ = cudaFuncSetAttribute(                                     \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)); \
    if (e_ != cudaSuccess) return static_cast<int>(e_);                        \
  } while (0)

// Runs the statements with CC bound to C as a compile-time constant.
#define LFT_DISPATCH_C(C, ...)                                  \
  switch (C) {                                                  \
    case 16: { constexpr int CC = 16; __VA_ARGS__; break; }     \
    case 32: { constexpr int CC = 32; __VA_ARGS__; break; }     \
    case 64: { constexpr int CC = 64; __VA_ARGS__; break; }     \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
