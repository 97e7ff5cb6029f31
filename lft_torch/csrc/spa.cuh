// Shared by the SpaTrans kernels (spa_block.cu, the forward K2, and
// spa_block_bwd.cu, its backward K3): tile geometry, the row loader and the
// launch helpers.
#pragma once

#include "common.cuh"

namespace lft {

constexpr int BM = 64;                  // token rows per block in the product steps
constexpr int TH = 16, TW = 16, R = 2;  // window steps: query tile, radius
constexpr int HH = TH + 2 * R, HW = TW + 2 * R;

template <int C>
struct Spa {
  static constexpr int D = 2 * C;
  static constexpr int LDD = D + 4;
};

// Token t of T = V*h*w tokens -> its offset in [V, h, w, *] is t itself;
// the (y, x) position inside its view is (t % hw) / w, t % w.

// Loads rows [t0, t0 + BM) of a [T, W] tensor into a [BM][ld] tile (zero
// past T).
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int t0, int T) {
  for (int i = threadIdx.x; i < BM * (W / 4); i += NT) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    const float4 v = t0 + r < T ? ldg4(src + static_cast<size_t>(t0 + r) * W + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * ld + c, v);
  }
}

inline int blocks(int T) { return (T + BM - 1) / BM; }

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
