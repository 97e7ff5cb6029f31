// K2.5's site-subset instance, `spa_ffn_out_sites` (`--dtype mixed` under an
// LFT_MM_HP_SITES subset that rounds exactly one of K2.5's two sites, f32
// IO), and K11.5's, `spa_ffn_out_pm_sites` (PM: the output pixel-major, as
// spa_block.cu's K11): out = (relu(xn2 W1) W2 + x2) Wlin at the plain
// version's rounding points (kernels/spa_block.py: ffn_out_plain under the
// plan): W1 and W2 over bf16-rounded operands where `ffn` rounds, at f32
// accuracy (3xTF32) where it does not; Wlin likewise by `lin`; hid rounded
// to bf16 only for a W2 product that rounds, y only for a Wlin product that
// rounds; out f32. Replaces lft_tpu/kernels/spa_block.py:_kernel :198-202
// under mm_half with a site subset (:197-203).
//
// The plans that reach it are two (kernels/common.py: card_fwd names
// `_sites` only where one of the two sites rounds; LFT_MM_HP_SITES lists the
// sites kept f32): `ffn` rounds and `lin` stays f32 (FFN, e.g. S2 =
// `tok,v,av,lin,ascore,awo,affn`), or `ffn` stays f32 and `lin` rounds (e.g.
// S1 = `qk,score,ffn,aqkv,aav,wo`). The kernel is templated on the case and
// the launcher picks it from the mask (a mask that rounds both or neither is
// refused: those take the `_bf16` or f32 instance); no product takes a
// run-time branch.
//
// Bound on this card at [400, 32, 32, 64] (T = 409,600, D = 128): 53.7
// GFLOP in W1 and W2 and 6.7 in Wlin, and 0.52 GB of f32 rows (xn2, x2 in;
// out): with FFN the rounded products at the bf16 rate (0.054 ms) and Wlin
// as 3 TF32 products (0.041 ms), bytes bind (0.157 ms); without, W1 and W2
// as 3 TF32 products, 161 GFLOP at 495 TFLOP/s, 0.326 ms, and Wlin at the
// bf16 rate: operations bind (0.332 ms). The design before this one
// (spa_block.cu: spa_ffn_out_kernel<C, PM, float, false, true>, a run-time
// mask) streamed all three weights split into TF32 hi/lo (576 KB a 128-row
// tile, ~1.8 GB through L2 a launch) through `WeightRing` with a block
// barrier a 16 KB stage, its rounded products one TF32 pass over rounded
// operands, hid and y each through shared memory.
//
// FFN (W1, W2 rounded): the `_bf16` instance's design (ffn_bf16.cuh) for the two
// rounded products: W1 and W2 rounded to bf16 once a launch into K-major
// core matrices and held in shared memory for the block's whole pass (128
// KB at C = 64), bf16 `wgmma` with A from registers (xn2 rounded to bf16 as
// it loads; the hidden chunk's accumulator becomes the W2 product's A
// fragments, relu and bf16: `acc_to_a`). y = hid W2 + x2 stays f32 in
// registers, and the Wlin product runs 3xTF32 with A from those registers:
// its TF32 A fragment wants columns q and q + 4 of an 8-column group where
// the accumulator holds 2 q and 2 q + 1, so Wlin's rows are laid out in
// that order (`ffn_sites_k`: logical k q <-> row 2 q, k q + 4 <-> row 2 q +
// 1; a product's sum over K in another order), split hi and lo once a
// launch and held whole in shared memory too (64 KB at C = 64). 196,608
// bytes at C = 64, no room for the f32 rows of xn2 beside them, so each
// warp loads its 16 rows straight into bf16 A fragments, the next tile's
// rows prefetched into L2 a tile ahead. No block barrier after the first.
//
// Without FFN (W1, W2 f32): their hi and lo are 512 KB at C = 64 and stay
// streamed, now through `MbarRing` (bulk copies on mbarriers, no block
// barrier a stage; K3.a's ring, 1.33x WeightRing's speed there on an H100), 512 KB a
// 128-row tile (~1.6 GB through L2 a launch: the L2 carries that at well
// under the products' time, so the stream is not what binds). The two
// products take A as the f32 instance's do (`rows_a`: the warp's rows in
// shared memory, split as loaded; relu(h) through a hidden chunk's rows:
// taking it from the accumulator instead, split in registers, held h
// beside y, the chain sums and the fragments, 255 registers with spills
// and the compiler's serialising `warpgroup.arrive`s, at twice the time on
// an H100), in chains of 64 of K (`FS_CHAIN`); y + x2 is rounded to bf16 into the A fragments of the Wlin
// product (`acc_to_a`), Wlin rounded to bf16 and resident (16 KB), a bf16
// `wgmma` over the whole K, so neither y nor Wlin's split goes through
// shared memory or the ring. The warp's rows of the next tile come in by
// cp.async as soon as its last W1 product has read them. 217,184 bytes at
// C = 64 (Wlin 16,384, the rows 67,584 and 34,816, 6 slots and their
// mbarriers).
//
// Both: one block of 256 threads (two warpgroups of 64 rows) an SM,
// persistent over 128-row tiles; a 3xTF32 product's sums in chains of 64
// of K in the tensor cores' accumulators, added in f32 (`FS_CHAIN`; the
// rounding of y to bf16 for Wlin, 2^-9, sits far above the chains'
// truncations, ~24 x 2^-24), a bf16 product's over its whole K (as
// ffn_bf16.cuh). Every output is written by one warp of one block, no
// atomics: a call repeats bitwise.
#pragma once

#include "bf16mma.cuh"
#include "ffn_bf16.cuh"
#include "rowgemm.cuh"
#include "spa.cuh"

namespace lft {

// 16s of K a chain of the 3xTF32 products (rg_product_a): chains of 64 of
// K. Under S1 on an H100 (`probe_variants`, in turns) 16 took 1.10 ms at
// [400, 32, 32, 64], 32 0.87, 64 and the whole K 0.85: the flushes of 16-K
// chains, not the tensor cores, set the old design's pace.
constexpr int FS_CHAIN = 4;

template <int C, bool FFN>
struct FfnSites {
  static constexpr int D = 2 * C;
  static constexpr int HC = 64;                         // hidden columns a chunk
  static constexpr int NH = 2 * D / HC;                 // chunks
  static constexpr int LDX = D + 4, LDH = HC + 4;       // f32 row strides of xn2, hid (no FFN)
  // FFN: W1, W2 bf16 (FfnBf16's layout, bf16 offsets 0 and OFF_W2), then
  // Wlin split at float offset LIN.
  static constexpr int OFF_W2 = 2 * D * D, LIN = 2 * D * D;
  // no FFN: chunk c's W1[:, c] and W2[c, :] split at c (PW1 + PW2), then
  // Wlin bf16 at float offset STREAM; the rows of xn2 and of a hidden chunk.
  static constexpr int PW1 = 2 * D * HC, PW2 = 2 * HC * D;
  static constexpr int STREAM = NH * (PW1 + PW2);
  static constexpr int FLOATS = FFN ? LIN + 2 * D * C : STREAM + D * C / 2;
  static constexpr int WBYTES = FFN ? 4 * FLOATS : 2 * D * C;   // resident weights
  static constexpr int ROWS = FFN ? 0 : RG_M * (LDX + LDH) * 4;
  static constexpr int NS = FFN ? 0 : rg_slots(ROWS + WBYTES + 16 * 8);
  static constexpr int BYTES = WBYTES + ROWS + NS * (RG_SF * 4 + 16);
  static_assert(2 * D % HC == 0, "whole hidden chunks");
  static_assert(FFN || NS >= 3, "the ring needs three slots");
  static_assert(BYTES <= RG_SMEM_MAX, "the weights and the rows must fit in shared memory");
};

// Row k of an 8-row group of a weight whose product takes its A fragments
// from an accumulator (`rg_product_a`): the TF32 fragment's k = q, q + 4
// hold the accumulator's columns 2 q, 2 q + 1, so logical row k of the
// group is the weight's row 2 (k % 4) + k / 4.
__host__ __device__ constexpr int ffn_sites_k(int k) {
  return 8 * (k / 8) + 2 * (k % 4) + k % 8 / 4;
}

// The launch's weights into wf, each element once: FFN W1, W2 rounded to
// bf16 (ffn_bf16_weights_kernel's layout) and Wlin split into TF32 hi/lo
// (rowgemm.cuh's layout, rows in ffn_sites_k order); else per chunk W1[:, c]
// and W2[c, :] split, then Wlin rounded to bf16 (kernels/rowgemm.py:
// ffn_out_sites_stream).
template <int C, bool FFN>
__global__ void __launch_bounds__(256)
    ffn_sites_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                             const float* __restrict__ wlin, float* __restrict__ wf) {
  using F = FfnSites<C, FFN>;
  constexpr int D = F::D, HC = F::HC, N1 = 2 * D * D;
  bf16* wb = reinterpret_cast<bf16*>(wf);
  // TF32 hi/lo of B[k][n] (N columns) at float offset off, logical row k
  auto split = [&](int off, int N, int k, int n, float v) {
    uint32_t hi, lo;
    split_tf32_rn(v, hi, lo);
    const size_t at = off + (static_cast<size_t>((k / 8) * 4 + k % 8 / 4) * (N / 8) + n / 8) * 32 +
                      n % 8 * 4 + k % 4;
    wf[at] = __uint_as_float(hi);
    wf[at + 8 * N] = __uint_as_float(lo);
  };
  // bf16 of B[k][n] (K x N) at bf16 offset off
  auto to_bf16 = [&](int off, int N, int k, int n, float v) {
    wb[off + ((k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 + k % 8] =
        __float2bfloat16_rn(v);
  };
  // logical row of physical row r of an 8-row group (ffn_sites_k's inverse)
  auto lrow = [](int r) { return 8 * (r / 8) + r % 8 % 2 * 4 + r % 8 / 2; };
  static_assert(ffn_sites_k(5) == 3 && ffn_sites_k(12) == 9, "the row order");
  for (int i = blockIdx.x * 256 + threadIdx.x; i < 2 * N1 + D * C; i += gridDim.x * 256) {
    if (i < N1) {                       // W1 [D, 2D]
      const int k = i / (2 * D), n = i % (2 * D);
      const float v = __ldg(w1 + i);
      if constexpr (FFN)
        to_bf16(0, 2 * D, k, n, v);
      else
        split(n / HC * (F::PW1 + F::PW2), HC, k, n % HC, v);
    } else if (i < 2 * N1) {            // W2 [2D, D]
      const int e = i - N1, r = e / D, n = e % D;
      const float v = __ldg(w2 + e);
      if constexpr (FFN)
        to_bf16(F::OFF_W2, D, r, n, v);
      else
        split(r / HC * (F::PW1 + F::PW2) + F::PW1, D, r % HC, n, v);
    } else {                            // Wlin [D, C]
      const int e = i - 2 * N1, r = e / C, n = e % C;
      const float v = __ldg(wlin + e);
      if constexpr (FFN)
        split(F::LIN, C, lrow(r), n, v);
      else
        to_bf16(2 * F::STREAM, C, r, n, v);
    }
  }
}

// acc (+)= A B for the warpgroup's 64 rows, 3xTF32, as rg_product but with
// A from `af` and chains of G x 16 of K: af(kk, hi, lo) fills the TF32 hi
// and lo fragments of k8 step kk (rows g, g + 8; k q, q + 4 of the step, as
// B's rows are laid out), from registers or from rows in shared memory
// (`rows_a`). A group is 16 of K times a part of N (<= 64 columns: one
// `wgmma` of width NW), its A fragments double-buffered as rg_product's; a
// chain is G groups of one part summed in the tensor cores' accumulators
// (a set of chain sums: two, alternating by chain, or one a part where N
// has two), added into acc in f32 once its last group has retired. G = 1 is
// rg_product's arithmetic; longer chains flush less often and let fewer
// waits for the FP32 pipes stand between the products (`FS_CHAIN`).
template <int K, int N, int OFF, int G, class W, class AF>
__device__ __forceinline__ void rg_product_a(RgAcc<N>& acc, AF af, W& ring, const float*& st) {
  using P = RgParts<N>;
  constexpr int NP = P::NP, NW = P::NW, R = P::R, NC = K / 16, SF = W::SF;
  constexpr int GC = G < NC ? G : NC;   // groups of a chain
  constexpr int CHAIN = 32 * N;         // floats of B a 16 of K reads (hi and lo)
  static_assert(K % 16 == 0 && N % 16 == 0 && N <= 128 && NP <= 2, "unsupported product shape");
  static_assert(OFF % CHAIN == 0 && SF % CHAIN == 0, "a chunk must not straddle two stages");
  constexpr int LBO = N / 8 * 128, SBO = 128;
  uint32_t ah[2][2][4], al[2][2][4];   // [buffer][k8 step][fragment]
  float sum[2][R];
  auto load_a = [&](int c, int b) {
#pragma unroll
    for (int u = 0; u < 2; ++u) af(2 * c + u, ah[b][u], al[b][u]);
  };
  // group i = (16 of K c, part p) into set z, the first of its chain from zero
  auto set_of = [](int c, int p) { return NP == 2 ? p : (c / GC) & 1; };
  auto issue = [&](int i) {
    const int c = i / NP, p = i % NP, z = set_of(c, p), first = c % GC == 0;
    const uint64_t d0 = smem_desc(st + (OFF + c * CHAIN) % SF + p * (NW / 8) * 32, LBO, SBO);
    reg_fence(sum[z]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint64_t dh = d0 + u * 4 * N, dl = dh + 2 * N;
      Wgmma<NW>::mma(sum[z], al[c & 1][u], dh, u || !first);
      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dl, 1);
      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dh, 1);
    }
    wgmma_commit();
  };
  // group i retired: the chain it ends into acc
  auto flush = [&](int i) {
    const int c = i / NP, p = i % NP, z = set_of(c, p);
    if (c % GC != GC - 1 && c != NC - 1) return;
    reg_fence(sum[z]);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[p][r] += sum[z][r];
  };
  load_a(0, 0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if ((OFF + c * CHAIN) % SF == 0) st = ring.enter();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int i = c * NP + p;
      issue(i);
      if (i > 0) {
        wgmma_wait<1>();
        flush(i - 1);
      }
      if (p == 0 && c + 1 < NC) load_a(c + 1, (c + 1) & 1);
    }
  }
  wgmma_wait<0>();
  flush(NC * NP - 1);
}

// The A fragments of rg_product_a from the warp's 16 rows at a (row stride
// lda floats), split as rg_product splits them.
__device__ __forceinline__ auto rows_a(const float* a, int lda) {
  const int lane = threadIdx.x & 31;
  const float* a0 = a + (lane >> 2) * lda + (lane & 3);
  const float* a1 = a0 + 8 * lda;
  return [a0, a1](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
    const int k0 = 8 * kk;
    split_tf32_rn(a0[k0], hi[0], lo[0]);
    split_tf32_rn(a1[k0], hi[1], lo[1]);
    split_tf32_rn(a0[k0 + 4], hi[2], lo[2]);
    split_tf32_rn(a1[k0 + 4], hi[3], lo[3]);
  };
}

// The TF32 hi and lo of k8 step kk of an accumulator's columns as rg_product_a
// reads them (d[4 j + e]: row g + 8 (e / 2), column 8 j + 2 q + e % 2),
// each value through f.
template <int R_, class Fn>
__device__ __forceinline__ void acc_to_tf32(const float (&d)[R_], int kk, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4], Fn f) {
  split_tf32_rn(f(d[4 * kk]), hi[0], lo[0]);       // (g, k q)      = column 2 q
  split_tf32_rn(f(d[4 * kk + 2]), hi[1], lo[1]);   // (g + 8, k q)
  split_tf32_rn(f(d[4 * kk + 1]), hi[2], lo[2]);   // (g, k q + 4)  = column 2 q + 1
  split_tf32_rn(f(d[4 * kk + 3]), hi[3], lo[3]);   // (g + 8, k q + 4)
}

// The warp's 16 rows of tile `tile` of xn2 [T, D] as bf16 A fragments of
// the W1 products (zero past T).
template <int D>
__device__ __forceinline__ void ffn_sites_xa(uint32_t (&xa)[D / 16][4],
                                             const float* __restrict__ xn2, int tile, int T) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int t0 = tile * RG_M + 16 * (threadIdx.x >> 5) + g;
  const bool ok0 = t0 < T, ok1 = t0 + 8 < T;
  const float* r0 = xn2 + static_cast<size_t>(ok0 ? t0 : 0) * D + 2 * q;
  const float* r1 = xn2 + static_cast<size_t>(ok1 ? t0 + 8 : 0) * D + 2 * q;
  const float2 z = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const float2 a0 = ok0 ? ldg2(r0 + 16 * s) : z, a1 = ok1 ? ldg2(r1 + 16 * s) : z;
    const float2 a2 = ok0 ? ldg2(r0 + 16 * s + 8) : z, a3 = ok1 ? ldg2(r1 + 16 * s + 8) : z;
    xa[s][0] = narrow2(a0.x, a0.y);
    xa[s][1] = narrow2(a1.x, a1.y);
    xa[s][2] = narrow2(a2.x, a2.y);
    xa[s][3] = narrow2(a3.x, a3.y);
  }
}

// The warp's 16 rows of `tile` of src [T, D] (and of x2 if given) into L2.
template <int D>
__device__ __forceinline__ void ffn_sites_l2(const float* __restrict__ src, int tile, int T) {
  const int t0 = tile * RG_M + 16 * (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && t0 < T) {
    const int n = (T - t0 < 16 ? T - t0 : 16) * D * 4;
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                     src + static_cast<size_t>(t0) * D),
                 "r"(n)
                 : "memory");
  }
}

// The warp's 16 rows of tile `tile` of xn2 into aw (row stride D + 4) by
// cp.async, zero past T; one group.
template <int D>
__device__ __forceinline__ void ffn_sites_rows(float* aw, const float* __restrict__ src, int tile,
                                               int T) {
  const int lane = threadIdx.x & 31, t0 = tile * RG_M + 16 * (threadIdx.x >> 5);
  for (int i = lane; i < 16 * (D / 4); i += 32) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const bool ok = t0 + r < T;
    cp_async16(aw + r * (D + 4) + c, src + static_cast<size_t>(ok ? t0 + r : 0) * D + c, ok);
  }
  cp_async_commit();
}

// The output pairs of an m64nN accumulator d (WgmmaBf / Wgmma layout) of
// the warp's rows into out [T, C], or with PM pixel-major (spa.cuh: pm_row).
template <int C, bool PM, int R_>
__device__ __forceinline__ void ffn_sites_store(float* __restrict__ out, const float (&d)[R_],
                                                int col0, int t0, int T, int hw, int A2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < R_ / 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + g + 8 * hh;
      if (t >= T) continue;
      long long row = t;
      if constexpr (PM) row = pm_row(row, hw, A2);
      st2(out + row * C + col0 + 8 * j + 2 * q, d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
    }
}

// FFN (`ffn` rounds, `lin` f32). wf: ffn_sites_weights_kernel<C, true>'s.
template <int C, bool PM>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_ffn_out_sites_ffn_kernel(const float* __restrict__ xn2, const float* __restrict__ x2,
                                 const float* __restrict__ wf, float* __restrict__ out, int T,
                                 int hw, int A2) {
  using F = FfnSites<C, true>;
  constexpr int D = F::D, HC = F::HC, NH = F::NH, KD = D / 16, KH = HC / 16;
  extern __shared__ __align__(16) float smem[];   // the type the other kernels of lft declare
  const bf16* ws = reinterpret_cast<const bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (T + RG_M - 1) / RG_M;
  for (int i = 16 * static_cast<int>(threadIdx.x); i < F::WBYTES; i += 16 * RG_NT)
    cp_async16v(reinterpret_cast<unsigned char*>(smem) + i,
                reinterpret_cast<const unsigned char*>(wf) + i, true);
  cp_async_commit();
  uint32_t xa[KD][4];   // xn2 rounded to bf16: the A fragments of the W1 products
  ffn_sites_l2<D>(x2, blockIdx.x, T);
  ffn_sites_xa<D>(xa, xn2, blockIdx.x, T);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  ResidentWeights lin{smem + F::LIN};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;   // the warp's first token
    const int next = tile + static_cast<int>(gridDim.x);
    if (next < tiles) {                       // the next tile's rows into L2
      ffn_sites_l2<D>(xn2, next, T);
      ffn_sites_l2<D>(x2, next, T);
    }
    // y = sum over the hidden chunks c of bf16(relu(xn2 W1[:, c])) W2[c, :]
    // (ffn_bf16.cuh's order: W2 of chunk c and W1 of chunk c + 1 together)
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
    if (next < tiles) ffn_sites_xa<D>(xa, xn2, next, T);   // from L2
    // y + x2 in f32: the A operand of the 3xTF32 Wlin product
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + (lane >> 2) + 8 * hh;
        const float2 r = t < T ? ldg2(x2 + static_cast<size_t>(t) * D + 8 * j + 2 * (lane & 3))
                               : make_float2(0.f, 0.f);
        y[4 * j + 2 * hh] += r.x;
        y[4 * j + 2 * hh + 1] += r.y;
      }
    RgAcc<C> o;
    rg_zero<C>(o);
    const float* st = nullptr;
    rg_product_a<D, C, 0, FS_CHAIN>(
        o, [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          acc_to_tf32(y, kk, hi, lo, [](float v) { return v; });
        },
        lin, st);
    using P = RgParts<C>;
#pragma unroll
    for (int p = 0; p < P::NP; ++p) ffn_sites_store<C, PM>(out, o[p], p * P::NW, t0, T, hw, A2);
  }
}

// No FFN (`ffn` f32, `lin` rounds). wf: ffn_sites_weights_kernel<C, false>'s.
template <int C, bool PM>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_ffn_out_sites_lin_kernel(const float* __restrict__ xn2, const float* __restrict__ x2,
                                 const float* __restrict__ wf, float* __restrict__ out, int T,
                                 int hw, int A2) {
  using F = FfnSites<C, false>;
  using PD = RgParts<F::D>;
  constexpr int D = F::D, HC = F::HC, LDX = F::LDX, LDH = F::LDH, KD = D / 16, SP = PD::NW / 16;
  extern __shared__ __align__(16) float smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const bf16* wl = reinterpret_cast<const bf16*>(sm);   // Wlin bf16
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xw = reinterpret_cast<float*>(sm + F::WBYTES) + 16 * warp * LDX;   // the warp's rows
  float* hw16 = reinterpret_cast<float*>(sm + F::WBYTES) + RG_M * LDX + 16 * warp * LDH;
  float* slots = reinterpret_cast<float*>(sm + F::WBYTES + F::ROWS);
  const int tiles = (T + RG_M - 1) / RG_M;
  for (int i = 16 * static_cast<int>(threadIdx.x); i < F::WBYTES; i += 16 * RG_NT)
    cp_async16v(sm + i, reinterpret_cast<const unsigned char*>(wf + F::STREAM) + i, true);
  cp_async_commit();
  ffn_sites_rows<D>(xw, xn2, blockIdx.x, T);
  MbarRing<F::NS> ring;
  ring.start(slots, reinterpret_cast<uint64_t*>(slots + F::NS * RG_SF), wf, F::STREAM,
             (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  const float* st = nullptr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;
    const int next = tile + static_cast<int>(gridDim.x);
    ffn_sites_l2<D>(x2, tile, T);
    cp_async_wait<0>();   // the warp's rows of this tile
    __syncwarp();
    RgAcc<D> y;
    rg_zero<D>(y);
    rg_static_for<F::NH>([&](auto J) {
      constexpr int c = decltype(J)::value, off = c * (F::PW1 + F::PW2);
      RgAcc<HC> h;
      rg_zero<HC>(h);
      rg_product_a<D, HC, off, FS_CHAIN>(h, rows_a(xw, LDX), ring, st);
      __syncwarp();   // the previous chunk's hidden rows and, at the last, xn2 are read
      if constexpr (c + 1 == F::NH)   // the next tile's rows come in
        if (next < tiles) ffn_sites_rows<D>(xw, xn2, next, T);
      rg_pairs<HC>(h, [&](int r, int c_, float v0, float v1) {
        *reinterpret_cast<float2*>(hw16 + r * LDH + c_) = make_float2(fmaxf(v0, 0.f),
                                                                      fmaxf(v1, 0.f));
      });
      __syncwarp();
      rg_product_a<HC, D, off + F::PW1, FS_CHAIN>(y, rows_a(hw16, LDH), ring, st);
    });
    // y + x2 in f32, rounded to bf16: the A fragments of the Wlin product
    rg_pairs<D>(y, [&](int r, int c, float& v0, float& v1) {
      const int t = t0 + r;
      const float2 res = t < T ? ldg2(x2 + static_cast<size_t>(t) * D + c) : make_float2(0.f, 0.f);
      v0 += res.x;
      v1 += res.y;
    });
    uint32_t ya[KD][4];
#pragma unroll
    for (int s = 0; s < KD; ++s) acc_to_a(ya[s], y[s / SP], s % SP, [](float v) { return v; });
    float o[C / 2];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KD; ++s)
      WgmmaBf<C>::mma(o, ya[s], bf16_piece_desc<C>(wl, 0, s, 0), s);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    ffn_sites_store<C, PM>(out, o, 0, t0, T, hw, A2);
  }
  cp_async_wait<0>();
}

// The launch: the weights' preparation into wf (FfnSites<C, FFN>::FLOATS
// floats, within kernels/rowgemm.py:ffn_out_floats), then the persistent
// kernel, one block an SM. `sites` must round exactly one of S_FFN, S_LIN.
template <int C, bool PM>
int launch_ffn_sites(const float* xn2, const float* x2, const float* w1, const float* w2,
                     const float* wlin, float* wf, float* out, int T, int hw, int A2, int sites,
                     cudaStream_t s) {
  const bool ffn = (sites & S_FFN) != 0, lin = (sites & S_LIN) != 0;
  if (T < 1 || ffn == lin) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int D = 2 * C, ELEMS = 4 * D * D + D * C;
  const int grid = rg_grid((T + RG_M - 1) / RG_M);
  auto run = [&](auto kernel, auto weights, int bytes) {
    weights<<<(ELEMS + 255) / 256, 256, 0, s>>>(w1, w2, wlin, wf);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, RG_NT, bytes, s>>>(xn2, x2, wf, out, T, hw, A2);
    return static_cast<int>(cudaGetLastError());
  };
  if (ffn)
    return run(spa_ffn_out_sites_ffn_kernel<C, PM>, ffn_sites_weights_kernel<C, true>,
               FfnSites<C, true>::BYTES);
  return run(spa_ffn_out_sites_lin_kernel<C, PM>, ffn_sites_weights_kernel<C, false>,
             FfnSites<C, false>::BYTES);
}

}  // namespace lft
