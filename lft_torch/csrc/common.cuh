// Building blocks shared by the hand-written LFT kernels: the block size
// of the kernels that take NT threads, a warp-per-row LayerNorm (K2.1 and
// K11.1's epilogue, K3.b's prologue) and float4 helpers. The token-row
// products run 3xTF32 on the tensor cores (tf32.cuh: rowgemm.cuh,
// tokenize.cuh, wgrad.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

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

// ---- Activations in the IO type of a kernel instance: float, or bf16 for
// the `_bf16io` instances of `--dtype bfloat16` (K1, K2's five steps). A
// bf16 load widens to f32 exactly; a bf16 store rounds to nearest even. The
// float overloads are the plain f32 accesses.
using bf16 = __nv_bfloat16;
template <class IO>
constexpr bool is_bf16 = std::is_same<IO, bf16>::value;

// IO in a function parameter's type, where it is named and never deduced
// (a nullptr argument leaves it to the template's default).
template <class T>
struct Named {
  using type = T;
};
template <class T>
using named_t = typename Named<T>::type;

// v as the IO type stores it, in f32: v itself, or v rounded to bf16.
template <class IO>
__device__ __forceinline__ float io_round(float v) {
  if constexpr (is_bf16<IO>)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

__device__ __forceinline__ float2 widen2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ uint32_t narrow2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  return widen2(__ldg(reinterpret_cast<const unsigned int*>(p)));
}
// 8 bytes: four bf16 values (16-byte aligned rows of 8 k values)
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = widen2(u.x), b = widen2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = narrow2(a, b);
}
__device__ __forceinline__ void st4(float* p, float4 v) { store4(p, v); }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(narrow2(v.x, v.y), narrow2(v.z, v.w));
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// Streaming (evict-first) accesses of a row read or written once: 2 or 4
// values, bf16 widened on load and rounded on store.
__device__ __forceinline__ float2 ldcs2(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldcs2(const bf16* p) {
  return widen2(__ldcs(reinterpret_cast<const unsigned int*>(p)));
}
__device__ __forceinline__ float4 ldcs4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldcs4(const bf16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = widen2(u.x), b = widen2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void stcs2(float* p, float a, float b) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a, b));
}
__device__ __forceinline__ void stcs2(bf16* p, float a, float b) {
  __stcs(reinterpret_cast<unsigned int*>(p), narrow2(a, b));
}
__device__ __forceinline__ void stcs4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void stcs4(bf16* p, float4 v) {
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(narrow2(v.x, v.y), narrow2(v.z, v.w)));
}

}  // namespace lft

// Each library exports this so the Python wrappers can name a failed launch.
#define LFT_EXPORT_ERROR_STRING                                    \
  extern "C" const char* lft_error_string(int code) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
