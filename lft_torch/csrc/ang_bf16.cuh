// K1's all-bf16 forms on bf16 tensor-core products: `ang_block_bf16io` and
// `ang_block_res_bf16io` (IO = bf16, `--dtype bfloat16` serving and
// training) and `ang_block_bf16` and `ang_block_res_bf16` (IO = float,
// `--dtype mixed` under LFT_MM_HP_SITES=none). Replaces
// lft_tpu/kernels/ang_block.py:_core_fwd / _kernel (:110-152) with io = bf16,
// and with mm_half and every site rounded, as ang_block.cu's
// `ang_block_kernel` replaces it in f32 and under a site subset.
//
// The function, per pixel over its A2 <= 128 view tokens of width C, 8
// heads of dh = C / 8 (kernels/ang_block.py: ang_block_bf16io_plain,
// _ang_block_planned under `none`): xn = bf16(LN1(x + pe)); q = bf16(xn
// Wq), k = bf16(xn Wk), v = bf16(bf16(x) Wv); scores (q . k) scale, m each
// token's max over every head and key, e = exp(s - m), l the sum of the
// unrounded e, a = bf16((sum bf16(e) v) (1 / l)); then
//   IO = bf16:  x2 = bf16(bf16(a Wo) + x), hid = bf16(relu(bf16(LN2(x2))
//               W1)), out = bf16(bf16(hid W2) + x2);
//   IO = float: x2 = a Wo + x, hid = bf16(relu(bf16(LN2(x2)) W1)), out =
//               hid W2 + x2, all f32.
// Every product over bf16 operands with f32 sums; the PE, both LayerNorms
// and the softmax's statistics f32. RES also writes m (the token's max, in
// every head's slot) and l [N, A2, 8] f32 and attn (IO: bf16, or f32 of
// bf16 values); its out is the forward's bit for bit (the same code, more
// stores).
//
// Bound on this card at [16384, 25, 64] (409,600 tokens): the six products
// 26.8 GFLOP, 0.027 ms at the bf16 rate; the attention 2.6 GFLOP (5.2 with
// the max pass), at the same rate on the tensor cores; x in and out 0.105
// GB in bf16, 0.0313 ms at 3.35 TB/s (0.210 GB in f32, 0.0626 ms): bytes.
// The design before this one (ang_block_kernel<C, 8, RES, IO, BF>: weights
// split on a WeightRing and read as TF32, one TF32 pass over rows widened to
// f32 in shared memory, the attention a thread an item on the FP32 pipes
// with a max pass through shared memory) took 0.7511 ms (bf16 IO) and 0.7000
// ms (f32 IO) on an H100 at 700 W. This one:
// * The weights stay resident as bf16: the launch's first kernel rounds Wv,
//   Wq, Wk, Wo, W1 and W2 once (8 C^2 values, 64 KB at C = 64) into the
//   K-major core matrices `wgmma` reads (kernels/rowgemm.py:bf16_piece,
//   ang_bf16_stream); each persistent block copies them into shared memory
//   once. No ring, no lo parts, no block barrier for them after the first.
// * Every product is bf16 `wgmma` m64nNk16 (bf16mma.cuh: WgmmaBf) with A
//   from registers: a warp holds its 16 token rows of x, xn, LN2(x2) and
//   each hidden chunk in the accumulator layout and rounds them into A
//   fragments there (`acc_to_a`); the attention output comes from shared
//   memory by ldmatrix. x2, y and out stay in registers.
// * A block takes RG_M = 128 token rows, P = 128 / A2 whole pixels, a tile
//   (5 at A2 = 25, 1 at 65-128), persistent over tiles. Each warp stages its
//   16 rows of the next tile's x by 16-byte cp.async, as they lie (bf16 or
//   f32), into the other of two stages while this tile runs; only the
//   attention reads other warps' rows (q, k, v as bf16 in shared memory),
//   between the tile's block barriers (three a tile).
// * The attention runs on `mma.sync` bf16: a warp takes one (pixel, 16
//   queries, head group) item, a group the heads of two chunks of 8
//   channels (2 heads at C = 64, 4 at 32, all 8 at 16), so that a 128-row
//   tile's items spread over its 8 warps (40 at A2 = 25, C = 64). Scores
//   are m16n8k8 MMAs of the query rows against 8 keys at a time (k8: the
//   head's channels; at dh = 4 and 2 the chunk of 8 channels holds 2 or 4
//   heads and the other heads' q channels are zero), keys past A2 masked.
//   Pass 1 writes each item's max over its heads and keys to MH; after a
//   barrier pass 2 takes the token's m, the max over its groups, forms e =
//   exp(s scale - m) (the SFU's 2^x of one FMA, `ex2`: within 2 f32 ulps),
//   l over the unrounded e, and the scores' C fragments become, rounded,
//   the A fragments of the product with v (m16n8k16 over 16 keys, v's B
//   fragments by ldmatrix.trans), so e never leaves registers. `expf` of the
//   plain version's argument, rounded as it rounds it, took 0.4547 ms
//   against 0.3166 at [16384, 25, 64] on an H100 and moved out's distance
//   from the plain version by under 0.02 of the bf16-vs-f32 distance
//   (`probe_variants --accuracy`). A first version (an item a (pixel, 16
//   queries) with all 8 heads and its max in registers,
//   `expf`) left 6 of 8 warps idle in a tile's second round of items: 0.5508
//   ms at [16384, 25, 64], its attention 0.39 of it (`probe_variants`). A
//   pixel's last 16 queries and keys may reach 15 rows past the tile: q, k
//   and v have 16 rows more, zeroed once, and a key past A2 scores -inf.
// * Sums: a product's over its K in the tensor cores' f32 accumulators; a
//   score over the head's channels in one MMA, then times scale; l over a
//   lane's keys in key order, then the quad's four lanes (xor 1, then 2);
//   o over keys in the tensor cores' order. These differ from the plain
//   version's order and from the design before (the limits do not).
// Shared memory (`AngBf16::bytes`): the weights, q, k, v [144][C + 8] and
// the attention output [128][C + 8] in bf16, pass 1's maxima MH [144][C /
// 16] in f32, and two stages of x [128][C + 8] in the IO type:
//   C = 16:  4,096 + 20,736 +  6,144 +   576 + 12,288 (bf16) / 24,576 (f32)
//            = 43,840 / 56,128 bytes
//   C = 32: 16,384 + 34,560 + 10,240 + 1,152 + 20,480 / 40,960 = 82,816 / 103,296
//   C = 64: 65,536 + 62,208 + 18,432 + 2,304 + 36,864 / 73,728 = 185,344 / 222,208
// One block of 256 threads an SM. Every output is written by one thread of
// one block, no atomics: a call repeats bitwise.
#pragma once

#include "bf16mma.cuh"
#include "rowgemm.cuh"
#include "spa.cuh"

namespace lft {

template <int C>
struct AngBf16 {
  static constexpr int H = 8, DH = C / H;
  static constexpr int HPC = 8 / DH;                  // heads a chunk of 8 channels
  static constexpr int NG = C / 16;                   // head groups (two chunks) of the attention
  static constexpr int HG = H / NG;                   // heads a group
  static constexpr int HC = 2 * C < 64 ? 2 * C : 64;  // hidden columns a chunk (wgmma n)
  static constexpr int NH = 2 * C / HC;               // chunks
  static constexpr int SQ = C * C;
  // bf16 offsets of Wv, Wq, Wk, Wo (C x C), W1 (C x 2C), W2 (2C x C)
  static constexpr int OFF_V = 0, OFF_Q = SQ, OFF_K = 2 * SQ, OFF_O = 3 * SQ;
  static constexpr int OFF_1 = 4 * SQ, OFF_2 = 6 * SQ;
  static constexpr int ELEMS = 8 * SQ;
  static constexpr int WBYTES = 2 * ELEMS;
  static constexpr int LDR = C + 8;           // row stride (values) of every tile
  static constexpr int ROWS = RG_M + 16;      // rows of q, k, v
  static constexpr int QKV = 3 * ROWS * LDR * 2;
  static constexpr int AO = RG_M * LDR * 2;
  static constexpr int MHB = ROWS * NG * 4;           // pass 1's maxima
  template <class IO>
  static constexpr int bytes =
      WBYTES + QKV + AO + MHB + 2 * RG_M * LDR * static_cast<int>(sizeof(IO));
};

// Wv, Wq, Wk, Wo, W1, W2 rounded to bf16 (to nearest even) at AngBf16's
// offsets, each K x N weight as [K / 16][2 (k half)][N / 8][8 (n)][8 (k)]
// (kernels/rowgemm.py:bf16_piece, as ffn_bf16_weights_kernel lays them).
template <int C>
__global__ void __launch_bounds__(256)
    ang_bf16_weights_kernel(const float* __restrict__ wv, const float* __restrict__ wq,
                            const float* __restrict__ wk, const float* __restrict__ wo,
                            const float* __restrict__ w1, const float* __restrict__ w2,
                            bf16* __restrict__ wb) {
  using L = AngBf16<C>;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < L::ELEMS; i += gridDim.x * 256) {
    const int which = i < L::OFF_1 ? i / L::SQ : i < L::OFF_2 ? 4 : 5;
    const int off = which < 4 ? which * L::SQ : which == 4 ? L::OFF_1 : L::OFF_2;
    const int N = which == 4 ? 2 * C : C;
    const float* src = which == 0 ? wv : which == 1 ? wq : which == 2 ? wk
                     : which == 3 ? wo : which == 4 ? w1 : w2;
    const int e = i - off, k = e / N, n = e % N;
    const int at = off + ((k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 + k % 8;
    wb[at] = __float2bfloat16_rn(__ldg(src + e));
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz: within 2 ulps, results below 2^-126 flushed
// to 0), what exp2f compiles to less its scaling of subnormal results.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two values of a row in shared memory, as f32.
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lds2(const bf16* p) {
  return widen2(*reinterpret_cast<const uint32_t*>(p));
}

// wb: the rounded weights (ang_bf16_weights_kernel). x, out [N, A2, C] in
// the IO type; pe [A2, C], ln [4, C] f32; RES: m, l [N, A2, 8], attn [N, A2,
// C] (IO).
template <int C, bool RES, class IO>
__global__ void __launch_bounds__(RG_NT, 1)
    ang_bf16_kernel(const IO* __restrict__ x, const float* __restrict__ pe,
                    const float* __restrict__ ln, const bf16* __restrict__ wb,
                    IO* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                    IO* __restrict__ attn_out, int N, int A2, float scale) {
  using L = AngBf16<C>;
  constexpr int H = L::H, DH = L::DH, HPC = L::HPC, HC = L::HC, NH = L::NH, LDR = L::LDR;
  constexpr int NG = L::NG, HG = L::HG;
  constexpr int KC = C / 16, KH = HC / 16;   // k16 steps over C and over a hidden chunk
  constexpr int VPC = 16 / static_cast<int>(sizeof(IO));   // values of x a 16-byte chunk
  extern __shared__ __align__(16) float smem[];   // the type the other kernels of lft declare
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const bf16* ws = reinterpret_cast<const bf16*>(sm);
  bf16* Q = reinterpret_cast<bf16*>(sm + L::WBYTES);
  bf16* K = Q + L::ROWS * LDR;
  bf16* V = K + L::ROWS * LDR;
  bf16* AO = V + L::ROWS * LDR;
  float* MH = reinterpret_cast<float*>(AO + RG_M * LDR);   // [ROWS][NG]: pass 1's maxima
  IO* X = reinterpret_cast<IO*>(MH + L::ROWS * NG);          // [2][RG_M][LDR]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int wr = 16 * warp;   // the warp's rows
  const int P = RG_M / A2;
  const int tiles = (N + P - 1) / P;

  // the warp's rows of tile `tile`'s x into stage `st` (zero past its
  // pixels); one group
  auto stage_x = [&](int tile, int st) {
    const int pix0 = tile * P, nrows = min(P, N - pix0) * A2;
    const size_t row0 = static_cast<size_t>(pix0) * A2;
    IO* dst = X + (st * RG_M + wr) * LDR;
    for (int i = lane; i < 16 * (C / VPC); i += 32) {
      const int r = i / (C / VPC), c = VPC * (i % (C / VPC));
      const bool ok = wr + r < nrows;
      cp_async16v(dst + r * LDR + c, x + (ok ? row0 + wr + r : 0) * C + c, ok);
    }
    cp_async_commit();
  };

  for (int i = 16 * tid; i < L::WBYTES; i += 16 * RG_NT)
    cp_async16v(sm + i, reinterpret_cast<const unsigned char*>(wb) + i, true);
  cp_async_commit();
  stage_x(blockIdx.x, 0);
  {  // q, k, v's 16 rows past the tile (read as a pixel's padding, never
     // written), the attention output (rows no pixel writes are read by the
     // Wo product) and MH (padding queries read rows no item writes) to
     // zero, once
    uint4* z = reinterpret_cast<uint4*>(AO);
    for (int i = tid; i < (RG_M * LDR * 2 + L::MHB) / 16; i += RG_NT)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < 3 * 16 * LDR / 8; i += RG_NT) {
      bf16* t = i < 16 * LDR / 8 ? Q : i < 2 * 16 * LDR / 8 ? K : V;
      reinterpret_cast<uint4*>(t + RG_M * LDR)[i % (16 * LDR / 8)] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_wait<1>();   // the weights
  fence_proxy_async();
  __syncthreads();

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int st = it & 1;
    const int pix0 = tile * P, np = min(P, N - pix0), nrows = np * A2;
    const size_t row0 = static_cast<size_t>(pix0) * A2;
    __syncwarp();   // the warp's reads of the other stage (the last tile's) are done
    if (tile + static_cast<int>(gridDim.x) < tiles)
      stage_x(tile + gridDim.x, st ^ 1);
    else
      cp_async_commit();   // an empty group: this tile's is the one before
    cp_async_wait<1>();
    __syncwarp();
    const IO* xs = X + (st * RG_M + wr) * LDR;   // the warp's rows of x

    {  // xn = LN1(x + pe) and x in the accumulator layout, rounded into the
       // A fragments of q, k and of v; then q, k, v into shared memory
      RgAcc<C> xn;
      uint32_t xa[KC][4], na[KC][4];
      float xr[C / 2];
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h, c = 8 * j + 2 * q4;
          const float2 v = lds2(xs + r * LDR + c);
          const float2 p = ldg2(pe + ((wr + r) % A2) * C + c);
          xr[4 * j + 2 * h] = v.x;
          xr[4 * j + 2 * h + 1] = v.y;
          xn[0][4 * j + 2 * h] = v.x + p.x;
          xn[0][4 * j + 2 * h + 1] = v.y + p.y;
        }
      quad_ln<C>(xn, ln, ln + C);
#pragma unroll
      for (int s = 0; s < KC; ++s) {
        acc_to_a(xa[s], xr, s, [](float v) { return v; });
        acc_to_a(na[s], xn[0], s, [](float v) { return v; });
      }
      float qa[C / 2], ka[C / 2], va[C / 2];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(va, xa[s], bf16_piece_desc<C>(ws, L::OFF_V, s, 0), s);
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(qa, na[s], bf16_piece_desc<C>(ws, L::OFF_Q, s, 0), s);
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(ka, na[s], bf16_piece_desc<C>(ws, L::OFF_K, s, 0), s);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(va);
      reg_fence(qa);
      reg_fence(ka);
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (wr + g + 8 * h) * LDR + 8 * j + 2 * q4, e = 4 * j + 2 * h;
          *reinterpret_cast<uint32_t*>(Q + at) = narrow2(qa[e], qa[e + 1]);
          *reinterpret_cast<uint32_t*>(K + at) = narrow2(ka[e], ka[e + 1]);
          *reinterpret_cast<uint32_t*>(V + at) = narrow2(va[e], va[e + 1]);
        }
    }
    __syncthreads();

    // the attention: a warp an item (pixel, 16 queries, head group), the
    // items in two rounds with a barrier between: pass 1 writes each item's
    // max over its group's heads and the pixel's keys to MH, pass 2 takes the
    // token's max over the groups and forms e, l and the product with v. Lane
    // (g, q4) holds queries g and g + 8 of the item and, of each 8 keys, keys
    // 2 q4 and 2 q4 + 1; of each chunk of 8 channels, channels 2 q4 and 2 q4
    // + 1 (those of head e where `mine(e)`).
    const int MT = (A2 + 15) / 16;   // items (and key steps) a pixel and group
    const int items = np * MT * NG;
    auto mine = [&](int e) { return (2 * q4) / DH == e % HPC; };
    // the item's pixel row 0, first query and group; q of the group's heads
    // as m16n8k8 A fragments, other heads' channels 0
    auto item_of = [&](int item, int& base, int& i0, int& grp, uint32_t (&qf)[HG][2]) {
      grp = item % NG;
      base = item / NG / MT * A2;
      i0 = 16 * (item / NG % MT);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const int e = grp * HG + hh;
        const int at = (base + i0 + g) * LDR + 8 * (e / HPC) + 2 * q4;
        qf[hh][0] = mine(e) ? *reinterpret_cast<const uint32_t*>(Q + at) : 0u;
        qf[hh][1] = mine(e) ? *reinterpret_cast<const uint32_t*>(Q + at + 8 * LDR) : 0u;
      }
    };
    // head hh's scores against keys k0 .. k0 + 15 (kb: ldmatrix of k's rows,
    // the group's two chunks): s0[i] is query g + 8 (i / 2) and key k0 + 2 q4
    // + i % 2, s1 the same 8 keys on
    auto scores = [](const uint32_t (&qh)[2], int u, const uint32_t (&kb)[4], float (&s0)[4],
                     float (&s1)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s0[i] = s1[i] = 0.f;
      mma_bf16_k8(s0, qh, kb[2 * u]);
      mma_bf16_k8(s1, qh, kb[2 * u + 1]);
    };
    for (int item = warp; item < items; item += RG_NT / 32) {   // pass 1
      int base, i0, grp;
      uint32_t qf[HG][2];
      item_of(item, base, i0, grp, qf);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      for (int k0 = 0; k0 < A2; k0 += 16) {
        uint32_t kb[4];
        ldmatrix_x4(kb, K + (base + k0 + (lane & 15)) * LDR + 8 * (2 * grp + (lane >> 4)));
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
          float s0[4], s1[4];
          scores(qf[hh], hh / HPC, kb, s0, s1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 2 * q4 + (i & 1);
            if (key < A2) mx[i >> 1] = fmaxf(mx[i >> 1], s0[i]);
            if (key + 8 < A2) mx[i >> 1] = fmaxf(mx[i >> 1], s1[i]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (q4 == 0 && i0 + g + 8 * h < A2) MH[(base + i0 + g + 8 * h) * NG + grp] = mx[h];
      }
    }
    __syncthreads();
    for (int item = warp; item < items; item += RG_NT / 32) {   // pass 2
      int base, i0, grp;
      uint32_t qf[HG][2];
      item_of(item, base, i0, grp, qf);
      // m the token's max over its heads (scale > 0: the max of the scaled
      // scores); e = 2^(s scale log2(e) - m log2(e)), one FMA and the SFU's 2^x
      float m[2], ml[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* mh = MH + (base + i0 + g + 8 * h) * NG;
        float mx = mh[0];
#pragma unroll
        for (int j = 1; j < NG; ++j) mx = fmaxf(mx, mh[j]);
        m[h] = mx * scale;
        ml[h] = m[h] * kLog2e;
      }
      const float sl = scale * kLog2e;
      float o[HG][4], l[HG][2];
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        o[hh][0] = o[hh][1] = o[hh][2] = o[hh][3] = 0.f;
        l[hh][0] = l[hh][1] = 0.f;
      }
      for (int k0 = 0; k0 < A2; k0 += 16) {
        const int row = base + k0 + (lane & 15), ch = 8 * (2 * grp + (lane >> 4));
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, K + row * LDR + ch);
        ldmatrix_x4_trans(vb, V + row * LDR + ch);
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
          const int u = hh / HPC;
          float s0[4], s1[4];
          scores(qf[hh], u, kb, s0, s1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 2 * q4 + (i & 1);
            s0[i] = key < A2 ? ex2(fmaf(s0[i], sl, -ml[i >> 1])) : 0.f;
            s1[i] = key + 8 < A2 ? ex2(fmaf(s1[i], sl, -ml[i >> 1])) : 0.f;
            l[hh][i >> 1] += s0[i];
            l[hh][i >> 1] += s1[i];
          }
          const uint32_t pa[4] = {narrow2(s0[0], s0[1]), narrow2(s0[2], s0[3]),
                                  narrow2(s1[0], s1[1]), narrow2(s1[2], s1[3])};
          mma_bf16(o[hh], pa, vb[2 * u], vb[2 * u + 1]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const int e = grp * HG + hh;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[hh][h] += __shfl_xor_sync(0xffffffffu, l[hh][h], 1);
          l[hh][h] += __shfl_xor_sync(0xffffffffu, l[hh][h], 2);
        }
        const int col = 8 * (e / HPC) + 2 * q4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + g + 8 * h;
          if (i >= A2) continue;
          const float inv = 1.f / l[hh][h];
          const float a0 = bf16_round(o[hh][2 * h] * inv);
          const float a1 = bf16_round(o[hh][2 * h + 1] * inv);
          if (mine(e)) {
            *reinterpret_cast<uint32_t*>(AO + (base + i) * LDR + col) = narrow2(a0, a1);
            if constexpr (RES) st2(attn_out + (row0 + base + i) * C + col, a0, a1);
          }
          if constexpr (RES) {   // from the lane of the head's first channels
            if (2 * q4 == e % HPC * DH) {
              m_out[(row0 + base + i) * H + e] = m[h];
              l_out[(row0 + base + i) * H + e] = l[hh][h];
            }
          }
        }
      }
    }
    __syncthreads();

    // x2 = a Wo + x (bf16 IO: bf16(bf16(a Wo) + x)), then LN2(x2) rounded
    // into the A fragments of the FFN
    float x2[C / 2];
    uint32_t la[KC][4];
    {
      uint32_t aa[KC][4];
#pragma unroll
      for (int s = 0; s < KC; ++s)
        ldmatrix_x4(aa[s], AO + (wr + (lane & 15)) * LDR + 16 * s + 8 * (lane >> 4));
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(x2, aa[s], bf16_piece_desc<C>(ws, L::OFF_O, s, 0), s);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(x2);
      RgAcc<C> t;
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h;
          const float2 v = lds2(xs + (g + 8 * h) * LDR + 8 * j + 2 * q4);
          x2[e] = io_round<IO>(io_round<IO>(x2[e]) + v.x);
          x2[e + 1] = io_round<IO>(io_round<IO>(x2[e + 1]) + v.y);
          t[0][e] = x2[e];
          t[0][e + 1] = x2[e + 1];
        }
      quad_ln<C>(t, ln + 2 * C, ln + 3 * C);
#pragma unroll
      for (int s = 0; s < KC; ++s) acc_to_a(la[s], t[0], s, [](float v) { return v; });
    }

    // y = sum over the hidden chunks c of bf16(relu(LN2(x2) W1[:, c])) W2[c, :]:
    // W2 of chunk c and W1 of chunk c + 1 go to the tensor cores together
    float hid[HC / 2], y[C / 2];
    uint32_t ha[KH][4];
    auto hidden = [&](int c) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<HC>::mma(hid, la[s], bf16_piece_desc<2 * C>(ws, L::OFF_1, s, c * HC), s);
      wgmma_commit();
    };
    auto relu = [](float v) { return fmaxf(v, 0.f); };
    hidden(0);
    wgmma_wait<0>();
    reg_fence(hid);
#pragma unroll
    for (int s = 0; s < KH; ++s) acc_to_a(ha[s], hid, s, relu);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      reg_fence(y);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KH; ++s)
        WgmmaBf<C>::mma(y, ha[s], bf16_piece_desc<C>(ws, L::OFF_2, c * KH + s, 0), c + s);
      wgmma_commit();
      if (c + 1 < NH) hidden(c + 1);
      wgmma_wait<0>();
      reg_fence(hid);
      reg_fence(y);
      if (c + 1 < NH) {
#pragma unroll
        for (int s = 0; s < KH; ++s) acc_to_a(ha[s], hid, s, relu);
      }
    }

    // out = y + x2 (bf16 IO: bf16(bf16(y) + x2))
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + g + 8 * h, e = 4 * j + 2 * h;
        if (r < nrows)
          st2(out + (row0 + r) * C + 8 * j + 2 * q4, io_round<IO>(y[e]) + x2[e],
              io_round<IO>(y[e + 1]) + x2[e + 1]);
      }
  }
  cp_async_wait<0>();
}

// The launch: the weights' rounding into wb (AngBf16<C>::ELEMS bf16 values),
// then the persistent kernel, one block an SM.
template <int C, bool RES, class IO>
int launch_ang_bf16(const IO* x, const float* pe, const float* ln, const float* wq,
                    const float* wk, const float* wv, const float* wo, const float* w1,
                    const float* w2, bf16* wb, IO* out, float* m, float* l, IO* attn, int N,
                    int A2, float scale, cudaStream_t s) {
  using L = AngBf16<C>;
  constexpr int BYTES = L::template bytes<IO>;
  static_assert(BYTES <= RG_SMEM_MAX, "the weights and the rows must fit");
  ang_bf16_weights_kernel<C><<<(L::ELEMS + 255) / 256, 256, 0, s>>>(wv, wq, wk, wo, w1, w2, wb);
  auto kernel = ang_bf16_kernel<C, RES, IO>;
  LFT_SET_SMEM(kernel, BYTES);
  const int P = RG_M / A2;
  kernel<<<rg_grid((N + P - 1) / P), RG_NT, BYTES, s>>>(x, pe, ln, wb, out, m, l, attn, N, A2,
                                                         scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lft
