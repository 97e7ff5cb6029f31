// bf16 products on the tensor cores with f32 accumulation: the building
// blocks of the kernels redesigned for bf16 operands that lie in shared
// memory or in registers as bf16, with no f32 widening and no TF32 pass.
//
// * `mma_bf16` (`mma.sync.m16n8k16`, bf16 in, f32 out) fed by
//   `ldmatrix_x4_trans`: the weight gradients of `--dtype bfloat16`
//   training (wgrad.cu, `wgrad_bf16io`). The reduction axis there (tokens)
//   is the slow axis of both operands, so each 8 x 8 piece of a fragment is
//   read transposed from token-major rows as it lies. With `mma_bf16_k8`
//   and `ldmatrix_x4` also the attentions of the window kernel
//   (window_mma.cuh) and of K1's all-bf16 kernel (ang_bf16.cuh): scores
//   of q against k rows, and bf16(e) against v's rows read transposed.
// * `WgmmaBf<N>` (`wgmma.mma_async` m64nNk16, bf16, A from registers, B
//   from shared memory K-major without swizzle, `bf16_piece_desc`, f32
//   accumulators): K2.5's `_bf16`, `_bf16io` and `_sites` kernels
//   (ffn_bf16.cuh, ffn_sites.cuh) and K1's all-bf16 kernel. An m64nN
//   accumulator's pairs are the A fragments of the next product over its N
//   columns (`acc_to_a`), so a hidden layer goes from one product into the
//   next in registers.
//
// A product of two bf16 values is exact in f32. The tensor cores add them
// and the accumulator with their sums rounded toward zero; each kernel says
// how long a chain it lets them add before an f32 addition on the FP32
// pipes.
#pragma once

#include "tf32.cuh"

namespace lft {

// 16 bytes from device to shared memory (zero where !valid), any element type.
__device__ __forceinline__ void cp_async16v(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// Four 8 x 8 b16 matrices, transposed: lane 8 i + r gives the address of
// row r of matrix i (16 bytes); thread (g, q) = (lane / 4, lane % 4)
// receives elements (2 q, g) and (2 q + 1, g) of each, packed, as r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Four 8 x 8 b16 matrices: lane 8 i + r gives the address of row r of
// matrix i (16 bytes); thread (g, q) receives elements (g, 2 q) and (g, 2 q
// + 1) of each, packed, as r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b over one m16n8k8 bf16 tile: A a0 (g, 2q), a1 (g+8, 2q); B b0 (2q,
// g); C as mma_bf16's.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// c += a b over one m16n8k16 bf16 tile, f32 accumulators. Fragments (lane =
// 4 g + q), each register two bf16 values, the lower k in the low half: A
// (row, k) a0 (g, 2q), a1 (g+8, 2q), a2 (g, 2q+8), a3 (g+8, 2q+8); B (k, n)
// b0 (2q, g), b1 (2q+8, g); C c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3
// (g+8, 2q+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- wgmma (sm_90a): a warpgroup's m64nNk16 bf16 product, A from registers
// (each warp's 16 rows in mma_bf16's A layout), B from shared memory through
// a descriptor (K-major: core matrices of 8 n x 8 k, 128 contiguous bytes),
// f32 accumulators in registers.

template <int N>
struct WgmmaBf;

template <>
struct WgmmaBf<128> {
  // d (+)= a b over m64n128k16; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
struct WgmmaBf<64> {
  // d (+)= a b over m64n64k16; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
struct WgmmaBf<32> {
  // d (+)= a b over m64n32k16; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct WgmmaBf<16> {
  // d (+)= a b over m64n16k16; d[4 j + e] is (row g + 8 (e / 2), column 8 j + 2 q + e % 2)
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};


// Descriptor of a K-major bf16 operand without swizzle: core matrices of 8
// rows (n) x 16 bytes (8 k), `lbo` bytes apart along K and `sbo` bytes apart
// along N (tf32.cuh's smem_desc for any element type).
__device__ __forceinline__ uint64_t smem_desc_b16(const void* p, int lbo, int sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// The descriptor of k16 step s of the K x N weight at bf16 offset `off` of
// ws (kernels/rowgemm.py:bf16_piece's layout), from column n0 (a multiple
// of 8) on.
template <int N>
__device__ __forceinline__ uint64_t bf16_piece_desc(const bf16* ws, int off, int s, int n0) {
  return smem_desc_b16(ws + off + (2 * s * (N / 8) + n0 / 8) * 64, N / 8 * 128, 128);
}

// The A fragments of k16 step s of a product whose K runs over the N
// columns of an m64nN accumulator d (as WgmmaBf lays it out), each value
// passed through f and rounded to bf16: columns 16 s .. 16 s + 15 are the
// accumulator's 8-column groups 2 s and 2 s + 1.
template <int R, class F>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int s, F f) {
  const int j0 = 8 * s, j1 = 8 * s + 4;
  a[0] = narrow2(f(d[j0]), f(d[j0 + 1]));
  a[1] = narrow2(f(d[j0 + 2]), f(d[j0 + 3]));
  a[2] = narrow2(f(d[j1]), f(d[j1 + 1]));
  a[3] = narrow2(f(d[j1 + 2]), f(d[j1 + 3]));
}

}  // namespace lft
