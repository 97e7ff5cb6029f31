// K2.5's bf16-operand instance, `spa_ffn_out_bf16` (`--dtype mixed` serving
// under LFT_MM_HP_SITES=none, f32 IO), and K11.5's, `spa_ffn_out_pm_bf16`
// (PM: the output pixel-major, as spa_block.cu's K11): out = (relu(xn2 W1) W2
// + x2) Wlin with every product over bf16-rounded operands and f32 sums,
// at the plain version's rounding points (kernels/spa_block.py:
// ffn_out_plain under the plan `none`): hid = relu(xn2 W1) rounded to bf16
// for the W2 product; y = hid W2 + x2 in f32, rounded to bf16 for Wlin; out
// f32. Replaces lft_tpu/kernels/spa_block.py:_kernel :198-202 under mm_half
// with every site rounded, as spa_block.cu's f32 step 5 replaces it in f32.
//
// Bound on this card: at [400, 32, 32, 64] (T = 409,600, D = 128) 60.4 GFLOP,
// 0.061 ms at the bf16 rate (989 TFLOP/s), and 0.52 GB of f32 rows (xn2, x2
// in; out), 0.157 ms at 3.35 TB/s: bytes. The design keeps the rows moving
// and gives the products nothing to wait for:
// * The weights stay resident. The launch's first kernel rounds W1, W2 and
//   Wlin to bf16 once, into the K-major core matrices `wgmma` reads
//   (`FfnBf16::ELEMS` values, kernels/rowgemm.py:ffn_out_bf16_stream); each
//   persistent block copies them into shared memory once and keeps them
//   for its whole pass over the tiles: no ring, no lo parts, no block
//   barrier after the first.
// * The products are bf16 `wgmma` m64nNk16 (bf16mma.cuh: WgmmaBf) with A
//   from registers. A warp rounds its 16 rows of xn2 into A fragments once
//   a tile; the hidden chunk's accumulator becomes the W2 product's A
//   fragments in registers (relu, then bf16: `acc_to_a`), and y's the Wlin
//   product's, so no intermediate goes through shared memory.
// * Each product's sums run in the tensor cores' f32 accumulators over its
//   whole K (at most 256), the truncations of their additions (<= 2^-23
//   relative each) far below the bf16 roundings of hid and y (2^-9).
// * Overlap: as soon as a warp has its rows in registers it starts the
//   cp.async of its rows of its next tile into the same 16 rows of shared
//   memory, and one bulk prefetch brings its rows of x2 into L2 for the
//   epilogue; the two warpgroups of a block go at their own pace.
// Shared memory (`FfnBf16::BYTES`): the weights 2 (4 D^2 + D C) bytes and
// 128 rows of xn2 at a stride of D + 8 floats (conflict-free float2 reads
// of the A fragments):
//   C = 16:   9,216 + 20,480 =  29,696 bytes
//   C = 32:  36,864 + 36,864 =  73,728 bytes
//   C = 64: 147,456 + 69,632 = 217,088 bytes (of 232,448)
// One block of 256 threads (two warpgroups of 64 rows) an SM. Every output
// is written by one warp of one block, no atomics: a call repeats bitwise.
//
// IO = bf16: K2.5's bf16-IO instance `spa_ffn_out_bf16io` (`--dtype
// bfloat16`) and K11.5's `spa_ffn_out_pm_bf16io`, lft_tpu's _kernel
// :198-202 with io = bf16 (kernels/spa_block.py:ffn_out_plain on bf16
// tensors): xn2, x2 and out bf16; hid = bf16(relu(xn2 W1)), y = bf16(bf16(hid
// W2) + x2) (the W2 product rounded before x2 is added, the sum again), out =
// bf16(y Wlin). The rows of xn2 come into shared memory by 16-byte cp.async
// as they lie, bf16 at a stride of D + 8 values, and into the A fragments by
// ldmatrix (no widening); x2 is read as bf16 pairs, out written as bf16
// pairs (pixel-major under PM, 4-byte pairs of a (pixel, view) row). Bound
// at [400, 32, 32, 64]: the rows halve, 0.26 GB, 0.078 ms at 3.35 TB/s,
// still above the 60.4 GFLOP at the bf16 rate: bytes. It replaced
// spa_block.cu's `spa_ffn_out_kernel<C, PM, bf16>` (TF32 weight parts on a
// WeightRing, the rows widened to f32 by the threads, hid and y through f32
// shared memory: 0.8393 ms on an H100 at 700 W). Shared memory (`BYTES16`):
//   C = 16:   9,216 + 10,240 =  19,456 bytes
//   C = 32:  36,864 + 18,432 =  55,296 bytes
//   C = 64: 147,456 + 34,816 = 182,272 bytes
#pragma once

#include "bf16mma.cuh"
#include "rowgemm.cuh"
#include "spa.cuh"

namespace lft {

template <int C>
struct FfnBf16 {
  static constexpr int D = 2 * C;
  static constexpr int HC = 64;                       // hidden columns a chunk (wgmma n64)
  static constexpr int NH = 2 * D / HC;               // chunks
  static constexpr int OFF_W2 = 2 * D * D, OFF_LIN = 4 * D * D;   // bf16 offsets of W2, Wlin
  static constexpr int ELEMS = OFF_LIN + D * C;       // bf16 values of the three weights
  static constexpr int WBYTES = 2 * ELEMS;
  static constexpr int LDX = D + 8;                   // f32 row stride of the xn2 rows
  static constexpr int BYTES = WBYTES + RG_M * LDX * 4;
  static constexpr int BYTES16 = WBYTES + RG_M * LDX * 2;   // bf16 rows (IO = bf16)
  template <class IO>
  static constexpr int bytes = is_bf16<IO> ? BYTES16 : BYTES;
  static_assert(2 * D % HC == 0, "whole hidden chunks");
  static_assert(BYTES <= RG_SMEM_MAX, "the weights and the rows must fit in shared memory");
};

// W1 [D, 2D], W2 [2D, D], Wlin [D, C] rounded to bf16 (to nearest even),
// each K x N weight as [K / 16][2 (k half)][N / 8][8 (n)][8 (k)]: a k16
// step's two halves of K-major core matrices, 8 columns x 8 k, 128 bytes
// each, N / 8 of them 128 bytes apart (kernels/rowgemm.py:bf16_piece).
template <int C>
__global__ void __launch_bounds__(256)
    ffn_bf16_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                            const float* __restrict__ wlin, bf16* __restrict__ wb) {
  using F = FfnBf16<C>;
  constexpr int D = F::D;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < F::ELEMS; i += gridDim.x * 256) {
    const bool is1 = i < F::OFF_W2, is2 = !is1 && i < F::OFF_LIN;
    const int off = is1 ? 0 : is2 ? F::OFF_W2 : F::OFF_LIN;
    const int N = is1 ? 2 * D : is2 ? D : C;
    const float* src = is1 ? w1 : is2 ? w2 : wlin;
    const int e = i - off, k = e / N, n = e % N;
    const int at = off + ((k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 + k % 8;
    wb[at] = __float2bfloat16_rn(__ldg(src + e));
  }
}

// The warp's 16 rows of tile `tile` of src [T, D] into aw (row stride
// D + 8 values of the IO type) by cp.async, zero past T; one group.
template <int D, class IO>
__device__ __forceinline__ void ffn_bf16_rows(IO* aw, const IO* __restrict__ src, int tile,
                                              int T) {
  constexpr int V = 16 / sizeof(IO);   // values a 16-byte chunk
  const int lane = threadIdx.x & 31, t0 = tile * RG_M + 16 * (threadIdx.x >> 5);
  for (int i = lane; i < 16 * (D / V); i += 32) {
    const int r = i / (D / V), c = V * (i % (D / V));
    const bool ok = t0 + r < T;
    cp_async16v(aw + r * (D + 8) + c, src + static_cast<size_t>(ok ? t0 + r : 0) * D + c, ok);
  }
  cp_async_commit();
}

// wb: the rounded weights (ffn_bf16_weights_kernel). xn2, x2 [T, D] -> out
// [T, C], or with PM out [T / (hw A2), hw, A2, C] (spa.cuh: pm_row); IO the
// activations' type (bf16: the bf16-IO instance's rounding points, above).
template <int C, bool PM, class IO = float>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_ffn_out_bf16_kernel(const IO* __restrict__ xn2, const IO* __restrict__ x2,
                            const bf16* __restrict__ wb, IO* __restrict__ out, int T, int hw,
                            int A2) {
  using F = FfnBf16<C>;
  constexpr int D = F::D, HC = F::HC, NH = F::NH, LDX = F::LDX;
  constexpr int KD = D / 16, KH = HC / 16;   // k16 steps over D and over a chunk
  extern __shared__ __align__(16) float smem[];   // the type the other kernels of lft declare
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const bf16* ws = reinterpret_cast<const bf16*>(sm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  constexpr bool BIO = is_bf16<IO>;
  IO* xw = reinterpret_cast<IO*>(sm + F::WBYTES) + 16 * warp * LDX;   // the warp's rows
  const int tiles = (T + RG_M - 1) / RG_M;
  for (int i = 16 * static_cast<int>(threadIdx.x); i < F::WBYTES; i += 16 * RG_NT)
    cp_async16v(sm + i, reinterpret_cast<const unsigned char*>(wb) + i, true);
  ffn_bf16_rows<D>(xw, xn2, blockIdx.x, T);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;   // the warp's first token
    if (lane == 0 && t0 < T) {                // its rows of x2 into L2 for the epilogue
      const int n = (T - t0 < 16 ? T - t0 : 16) * D * static_cast<int>(sizeof(IO));
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                       x2 + static_cast<size_t>(t0) * D),
                   "r"(n)
                   : "memory");
    }
    cp_async_wait<0>();
    __syncwarp();
    uint32_t xa[KD][4];   // xn2 rounded to bf16: the A fragments of the W1 products
#pragma unroll
    for (int s = 0; s < KD; ++s) {
      if constexpr (BIO) {   // as it lies: matrices (rows 8 (i % 2), k 16 s + 8 (i / 2))
        ldmatrix_x4(xa[s], xw + (lane & 15) * LDX + 16 * s + 8 * (lane >> 4));
      } else {
        const float* r0 = xw + g * LDX + 16 * s + 2 * q;
        const float* r1 = r0 + 8 * LDX;
        const float2 a0 = *reinterpret_cast<const float2*>(r0);
        const float2 a1 = *reinterpret_cast<const float2*>(r1);
        const float2 a2 = *reinterpret_cast<const float2*>(r0 + 8);
        const float2 a3 = *reinterpret_cast<const float2*>(r1 + 8);
        xa[s][0] = narrow2(a0.x, a0.y);
        xa[s][1] = narrow2(a1.x, a1.y);
        xa[s][2] = narrow2(a2.x, a2.y);
        xa[s][3] = narrow2(a3.x, a3.y);
      }
    }
    __syncwarp();   // the rows are read: the next tile's come into their place
    if (tile + static_cast<int>(gridDim.x) < tiles) ffn_bf16_rows<D>(xw, xn2, tile + gridDim.x, T);

    // y = sum over the hidden chunks c of bf16(relu(xn2 W1[:, c])) W2[c, :]:
    // W2 of chunk c and W1 of chunk c + 1 go to the tensor cores together
    float h[HC / 2], y[D / 2];
    uint32_t ha[KH][4];
    auto hidden = [&](int c) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KD; ++s)
        WgmmaBf<HC>::mma(h, xa[s], bf16_piece_desc<2 * D>(ws, 0, s, c * HC), s);
      wgmma_commit();
    };
    auto relu = [](float v) { return fmaxf(v, 0.f); };
    hidden(0);
    wgmma_wait<0>();
    reg_fence(h);
#pragma unroll
    for (int s = 0; s < KH; ++s) acc_to_a(ha[s], h, s, relu);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      reg_fence(y);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KH; ++s)
        WgmmaBf<D>::mma(y, ha[s], bf16_piece_desc<D>(ws, F::OFF_W2, c * KH + s, 0), c + s);
      wgmma_commit();
      if (c + 1 < NH) hidden(c + 1);
      wgmma_wait<0>();
      reg_fence(h);
      reg_fence(y);
      if (c + 1 < NH) {
#pragma unroll
        for (int s = 0; s < KH; ++s) acc_to_a(ha[s], h, s, relu);
      }
    }

    // y + x2 in f32 (bf16 IO: bf16(bf16(y) + x2)), rounded to bf16: the A
    // fragments of the Wlin product
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + g + 8 * hh;
        const float2 r = t < T ? ldg2(x2 + static_cast<size_t>(t) * D + 8 * j + 2 * q)
                               : make_float2(0.f, 0.f);
        y[4 * j + 2 * hh] = io_round<IO>(io_round<IO>(y[4 * j + 2 * hh]) + r.x);
        y[4 * j + 2 * hh + 1] = io_round<IO>(io_round<IO>(y[4 * j + 2 * hh + 1]) + r.y);
      }
    uint32_t ya[KD][4];
#pragma unroll
    for (int s = 0; s < KD; ++s) acc_to_a(ya[s], y, s, [](float v) { return v; });
    float o[C / 2];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KD; ++s)
      WgmmaBf<C>::mma(o, ya[s], bf16_piece_desc<C>(ws, F::OFF_LIN, s, 0), s);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + g + 8 * hh;
        if (t >= T) continue;
        long long row = t;
        if constexpr (PM) row = pm_row(row, hw, A2);
        st2(out + row * C + 8 * j + 2 * q, o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      }
  }
  cp_async_wait<0>();
}

// The launch: the weights' rounding into wb (FfnBf16<C>::ELEMS bf16 values),
// then the persistent kernel, one block an SM.
template <int C, bool PM, class IO = float>
int launch_ffn_bf16(const IO* xn2, const IO* x2, const float* w1, const float* w2,
                    const float* wlin, bf16* wb, IO* out, int T, int hw, int A2,
                    cudaStream_t s) {
  using F = FfnBf16<C>;
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  ffn_bf16_weights_kernel<C><<<(F::ELEMS + 255) / 256, 256, 0, s>>>(w1, w2, wlin, wb);
  auto kernel = spa_ffn_out_bf16_kernel<C, PM, IO>;
  constexpr int BYTES = F::template bytes<IO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rg_grid((T + RG_M - 1) / RG_M), RG_NT, BYTES, s>>>(xn2, x2, wb, out, T, hw, A2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lft
