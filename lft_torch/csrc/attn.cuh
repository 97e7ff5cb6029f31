// Shared by the per-op attention kernels (spa_attn_hp.cu; ang_attn.cu and
// ang_attn_sweep.cu through ang_attn.cuh) and by K4's attention step
// (ang_block.cu): one head's DH-wide row segment in registers, its dot
// product with the forward's fixed fmaf order (every backward rebuilds a
// score with exactly this arithmetic), and the row-tile loader.
#pragma once

#include "spa.cuh"

namespace lft {

// DH floats at p (shared or device memory) -> registers; DH = 2 or a
// multiple of 4, p aligned to the access width.
template <int DH>
__device__ __forceinline__ void ld(const float* p, float (&r)[DH]) {
  if constexpr (DH % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 t = load4(p + d);
      r[d] = t.x; r[d + 1] = t.y; r[d + 2] = t.z; r[d + 3] = t.w;
    }
  } else {
    static_assert(DH == 2, "head width 2, or a multiple of 4");
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  }
}

// The same from device memory through the read-only path.
template <int DH>
__device__ __forceinline__ void ldg(const float* __restrict__ p, float (&r)[DH]) {
  if constexpr (DH % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 t = ldg4(p + d);
      r[d] = t.x; r[d + 1] = t.y; r[d + 2] = t.z; r[d + 3] = t.w;
    }
  } else {
    static_assert(DH == 2, "head width 2, or a multiple of 4");
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = t.x; r[1] = t.y;
  }
}

// The same from bf16 (`_bf16io` instances), widened to f32.
template <int DH>
__device__ __forceinline__ void ldg(const bf16* __restrict__ p, float (&r)[DH]) {
  if constexpr (DH % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 t = ldg4(p + d);
      r[d] = t.x; r[d + 1] = t.y; r[d + 2] = t.z; r[d + 3] = t.w;
    }
  } else {
    static_assert(DH == 2, "head width 2, or a multiple of 4");
    const float2 t = ldg2(p);
    r[0] = t.x; r[1] = t.y;
  }
}

template <int DH>
__device__ __forceinline__ void st(float* p, const float (&r)[DH]) {
  if constexpr (DH % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DH; d += 4)
      store4(p + d, make_float4(r[d], r[d + 1], r[d + 2], r[d + 3]));
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  }
}

// The same into bf16, each value rounded to nearest even.
template <int DH>
__device__ __forceinline__ void st(bf16* p, const float (&r)[DH]) {
  if constexpr (DH % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DH; d += 4) st4(p + d, make_float4(r[d], r[d + 1], r[d + 2], r[d + 3]));
  } else {
    st2(p, r[0], r[1]);
  }
}

template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float (&b)[DH]) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// rows [row0, row0 + rows) of a [*, C] tensor -> a [rows][C + 4] tile
template <int C>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      size_t row0, int rows) {
  for (int i = threadIdx.x; i < rows * (C / 4); i += NT) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4));
    store4(dst + r * (C + 4) + c, ldg4(src + (row0 + r) * C + c));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace lft
