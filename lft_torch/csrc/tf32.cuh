// f32 products on the tensor cores (3xTF32) and the cp.async copies that
// feed them: the building blocks of wgrad.cu (`mma.sync`), of the 3x3
// tokenization (tokenize.cuh, for spa_block.cu and spa_block_bwd.cu:
// `wgmma`) and of the blocks' row-tile products (rowgemm.cuh, for
// spa_block.cu and ang_block.cu: `wgmma`).
//
// 3xTF32: each f32 operand is split into a TF32 head and a TF32 tail,
// a = a_hi + a_lo, and a product takes a_lo b_hi + a_hi b_lo + a_hi b_hi
// (`mma.sync.m16n8k8` tf32 with f32 accumulators). Only a_lo b_lo and the
// tails' truncation to TF32 are lost (about 2^-21 of |a b|): f32 accuracy,
// where one TF32 product keeps three decimal digits. The tensor cores round
// their f32 sums toward zero, so a kernel keeps each MMA chain short (tens
// of MMAs) and adds the chains in f32 on the FP32 pipes.
//
// bf16 operands (`--dtype mixed`'s backward, the kernels' `BF` instances):
// an operand rounded to bf16 is exact in TF32, and the product of two is
// exact in f32, so a product over bf16-rounded operands is ONE TF32 product
// (`bf16_bits`), with the same chains and f32 accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace lft {

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 values of src into f32 shared memory at dst (16-byte aligned), zero
// where !valid: f32 by cp.async (16 bytes); bf16 (`--dtype bfloat16`'s
// `_bf16io` instances) by the thread's own 8-byte load, widened to f32 as
// it is stored (cp.async copies bytes), so the rows in shared memory and
// every read of them are the f32 instance's.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void copy4(float* dst, const bf16* src, bool valid) {
  store4(dst, valid ? ldg4(src) : make_float4(0.f, 0.f, 0.f, 0.f));
}

// v = hi + lo: hi is v rounded to TF32 as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero), by two integer operations instead of the
// conversion unit; lo = v - hi is exact in f32 and goes to the MMA as it is,
// which reads its top 19 bits (a truncation to TF32). |v - hi - lo_tf32| <=
// 2^-21 |v|. The splits are most of a warp's non-MMA instructions: with
// two cvt a split, wgrad ran 12% slower on an H100.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// As split_tf32, with lo rounded to TF32 the same way instead of left to
// the MMA's truncation: |v - hi - lo| <= 2^-23 |v|, and unbiased, where the
// truncated tails of a sum all err toward zero (rowgemm.cuh).
__device__ __forceinline__ void split_tf32_rn(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// v rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v rounded to bf16, kept as its TF32 bit pattern: an exact TF32 operand.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __float_as_uint(bf16_round(v));
}

// `--dtype mixed`'s product sites as the bits of a `_sites` instance's mask
// (kernels/common.py: SITE_BITS): a set bit rounds both operands of the
// site's products to bf16, a clear one keeps them f32 (3xTF32). The mask is
// a kernel argument, the same in every thread, so a branch on it is uniform.
constexpr int S_TOK = 1 << 0, S_QK = 1 << 1, S_V = 1 << 2, S_SCORE = 1 << 3, S_AV = 1 << 4,
              S_WO = 1 << 5, S_FFN = 1 << 6, S_LIN = 1 << 7, S_AQKV = 1 << 8,
              S_ASCORE = 1 << 9, S_AAV = 1 << 10, S_AWO = 1 << 11, S_AFFN = 1 << 12;

// c += a b over one m16n8k8 tile. Fragments (lane = 4 g + q): A (row,
// column) a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4); B (k, n) b0
// (q, g), b1 (q+4, g); C c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- wgmma (sm_90a): a warpgroup's m64nNk8 tf32 product, A from registers
// (each warp's 16 rows in the m16n8k8 fragment layout above), B from shared
// memory through a matrix descriptor, f32 accumulators in registers.

template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  // d (+)= a b over m64n128k8; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= a b over m64n64k8; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  // d (+)= a b over m64n32k8; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<16> {
  // d (+)= a b over m64n16k8; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of d across the asynchronous
// products that write it.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Descriptor of a K-major operand in shared memory without swizzle: core
// matrices of 8 rows (N) x 16 bytes (4 tf32 along K), each 128 contiguous
// bytes, `lbo` bytes apart along K and `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc(const float* p, int lbo, int sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

}  // namespace lft
