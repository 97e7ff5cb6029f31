// Building blocks shared by the hand-written LFT kernels: the block size
// of the kernels that take NT threads, a warp-per-row LayerNorm (K2.1 and
// K11.1's epilogue, K3.b's prologue) and float4 helpers. The token-row
// products run 3xTF32 on the tensor cores (tf32.cuh: rowgemm.cuh,
// tokenize.cuh, wgrad.cu).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace lft {

constexpr int NT = 256;  // threads per block in every kernel of the port

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
