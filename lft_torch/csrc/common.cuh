// Building blocks shared by the hand-written LFT kernels (ang_block.cu,
// spa_block.cu, spa_block_bwd.cu): a row-tile matrix product on the FP32
// pipes and a warp-per-row LayerNorm.
//
// `gemm_acc` multiplies a tile of token rows held in shared memory by a
// weight matrix that stays in device memory (it is small enough to live in
// L1/L2: at most 256 x 256 f32), in full f32 on the FP32 pipes (no TF32, no
// tensor cores): the port's parity mode is the reference's f32/HIGHEST
// arithmetic. The backwards K3.a-d and K4 use it. The 3x3 tokenization
// (tokenize.cuh: K2.1, K11.1, K3.e), the row-tile products of K1, K2.2,
// K2.4 and K2.5 / K11.5 (rowgemm.cuh) and the weight gradients (wgrad.cu)
// reach the same accuracy on the tensor cores instead, as 3xTF32 (tf32.cuh).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace lft {

constexpr int NT = 256;  // threads per block in every kernel of the port

// Register tiling of a BM x N product tile. Where BM and N are multiples
// of 32, each warp owns a 32 x 32 output tile and each thread a 4 x 8
// micro-tile of it: rows r, r+8, r+16, r+24 (r = band + lane / 4) and 8
// consecutive columns (lane % 4). Per 4 k steps a thread then issues one
// float4 A load per row, conflict-free because the 8 rows a warp reads at
// once are consecutive, and two float4 W loads per k step, for 128 FMAs:
// the FP32 pipes, not the load path, set the pace. Other shapes (C = 16)
// fall back to 4 x 4 micro-tiles with scalar A loads.
// Micro-tile m = threadIdx.x + i * NT (i < MT).
template <int BM, int N>
struct Tiles {
  static_assert(BM % 4 == 0 && N % 4 == 0, "tile dims must be multiples of 4");
  static constexpr bool WARP = BM % 32 == 0 && N % 32 == 0;
  static constexpr int TC = WARP ? 8 : 4;       // columns per micro-tile
  static constexpr int RSTEP = WARP ? 8 : 1;    // row step inside a micro-tile
  static constexpr int TOTAL = (BM / 4) * (N / TC);
  static constexpr int MT = (TOTAL + NT - 1) / NT;

  // First row and column of micro-tile m, clamped to the last valid one
  // (a clamped duplicate is computed and dropped by for_tiles).
  __device__ __forceinline__ static void origin(int m, int& r, int& c) {
    m = m < TOTAL ? m : TOTAL - 1;
    if constexpr (WARP) {
      const int lane = m & 31, wt = m >> 5;
      r = (wt / (N / 32)) * 32 + (lane >> 2);
      c = (wt % (N / 32)) * 32 + (lane & 3) * 8;
    } else {
      r = (m / (N / 4)) * 4;
      c = (m % (N / 4)) * 4;
    }
  }
};

template <int BM, int N>
using Acc = float[Tiles<BM, N>::MT][4][Tiles<BM, N>::TC];

template <int BM, int N>
__device__ __forceinline__ void zero_acc(Acc<BM, N>& acc) {
#pragma unroll
  for (int i = 0; i < Tiles<BM, N>::MT; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < Tiles<BM, N>::TC; ++b) acc[i][a][b] = 0.f;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc += A[BM x K] * W[K x N]. A lies in shared memory with row stride
// `lda` (a multiple of 4, 16-byte aligned rows); W is row-major in device
// memory, 16-byte aligned, and small enough to stay in L1/L2.
template <int BM, int K, int N>
__device__ __forceinline__ void gemm_acc(Acc<BM, N>& acc, const float* A,
                                         int lda,
                                         const float* __restrict__ W) {
  using T = Tiles<BM, N>;
  static_assert(K % 4 == 0, "K must be a multiple of 4");
  const float* arow[T::MT];
  int col[T::MT];
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
    int r, c;
    T::origin(threadIdx.x + i * NT, r, c);
    arow[i] = A + r * lda;
    col[i] = c;
  }
  if constexpr (T::WARP) {
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[i][r] = *reinterpret_cast<const float4*>(arow[i] + r * 8 * lda + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          const float* wk = W + static_cast<size_t>(k + kk) * N + col[i];
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(wk));
          const float4 w1 = __ldg(reinterpret_cast<const float4*>(wk + 4));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float av = comp(a[i][r], kk);
            float* c = acc[i][r];
            c[0] = fmaf(av, w0.x, c[0]);
            c[1] = fmaf(av, w0.y, c[1]);
            c[2] = fmaf(av, w0.z, c[2]);
            c[3] = fmaf(av, w0.w, c[3]);
            c[4] = fmaf(av, w1.x, c[4]);
            c[5] = fmaf(av, w1.y, c[5]);
            c[6] = fmaf(av, w1.z, c[6]);
            c[7] = fmaf(av, w1.w, c[7]);
          }
        }
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float* wk = W + static_cast<size_t>(k) * N;
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(wk + col[i]));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float av = arow[i][r * lda + k];
          acc[i][r][0] = fmaf(av, w.x, acc[i][r][0]);
          acc[i][r][1] = fmaf(av, w.y, acc[i][r][1]);
          acc[i][r][2] = fmaf(av, w.z, acc[i][r][2]);
          acc[i][r][3] = fmaf(av, w.w, acc[i][r][3]);
        }
      }
    }
  }
}

// Calls f(row, col, float4 value) once for every valid 1 x 4 output strip.
template <int BM, int N, class F>
__device__ __forceinline__ void for_tiles(const Acc<BM, N>& acc, F f) {
  using T = Tiles<BM, N>;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
    const int m = threadIdx.x + i * NT;
    if (m >= T::TOTAL) continue;
    int r0, c0;
    T::origin(m, r0, c0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < T::TC; c += 4)
        f(r0 + r * T::RSTEP, c0 + c,
          make_float4(acc[i][r][c], acc[i][r][c + 1], acc[i][r][c + 2], acc[i][r][c + 3]));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp normalises one D-wide row held as v[e] = row[lane + 32 e]:
// torch LayerNorm (biased variance, eps 1e-5) with affine g, b.
template <int D>
struct RowLN {
  static constexpr int E = (D + 31) / 32;
  __device__ __forceinline__ static bool valid(int e) {
    return (threadIdx.x & 31) + 32 * e < D;
  }
  __device__ __forceinline__ static int col(int e) {
    return (threadIdx.x & 31) + 32 * e;
  }
  __device__ __forceinline__ static void apply(float (&v)[E],
                                               const float* __restrict__ g,
                                               const float* __restrict__ b) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (valid(e)) s += v[e];
    const float mu = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (valid(e)) {
        const float d = v[e] - mu;
        q = fmaf(d, d, q);
      }
    const float rstd = rsqrtf(warp_sum(q) / D + 1e-5f);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (valid(e)) v[e] = (v[e] - mu) * rstd * __ldg(g + col(e)) + __ldg(b + col(e));
  }
};

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

}  // namespace lft

// Each library exports this so the Python wrappers can name a failed launch.
#define LFT_EXPORT_ERROR_STRING                                    \
  extern "C" const char* lft_error_string(int code) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
