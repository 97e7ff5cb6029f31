// K2: the whole SpaTrans block (reference model/LFT.py:118-191), forward,
// as a fixed sequence of five hand-written kernels.
//
// Replaces lft_tpu/kernels/spa_block.py:_fwd_call / _kernel (the Pallas TPU
// kernel behind spa_trans_block_fused, view-major form). Per view image
// x [h, w, C], with token width D = 2C:
//   1 spa_tokenize_ln  tok = unfold3x3(x) Wu;  xn = LN1(tok + pe_tok)
//   2 spa_qkv          q = xn Wq, k = xn Wk, v = tok Wv  (v from the RAW tok)
//   3 spa_window_attn  a = 5x5-window softmax_heads(q k^T (D/H)^-0.5) v,
//                      out-of-image keys excluded
//   4 spa_outproj_ln   x2 = a Wo + tok;  xn2 = LN2(x2)
//   5 spa_ffn_out      out = (relu(xn2 W1) W2 + x2) Wlin     (Token2SAI)
//
// Why five kernels: at C = 64 / D = 128 the block's weights are ~0.8 MB in
// f32 and one view's tokens 512 KB, far past the 227 KB of shared memory a
// block can hold, so the TPU kernel's one-view-per-step VMEM chain cannot
// carry over. Each step instead owns a tile of tokens (steps 2, 4, 5: 128,
// persistent; step 1: a rectangle of up to 128 pixels of one view; step 3:
// a 16 x 16 query tile of one head group, two blocks an SM), runs
// its products from shared memory, and hands its result to the next step
// through device memory. Every block computes its own halo and zero padding
// (the TPU kernel zeroed scratch borders once at grid step 0, which is
// exact only on a sequential grid). The window step skips keys outside the
// image instead of scoring zero keys and correcting the denominator.
//
// Bound on this card: at the production shape [400, 32, 32, 64] the block
// does ~176 GFLOP over the window pairs and taps inside the image
// (tokenisation 57.9, q/k 26.8, v 13.4, attention 5.2, Wo 13.4, FFN 53.7,
// Token2SAI 6.7) and its intermediates add ~1.9 GB of device memory traffic
// (~0.6 ms at 3.35 TB/s). Every product runs 3xTF32 on the tensor cores:
// step 1 as an implicit GEMM (tokenize.cuh), steps 2, 4 and 5 as row-tile
// products (rowgemm.cuh); their bounds and designs are set out at each
// step. On the tensor cores steps 2 and 4 are bound by bytes, steps 1 and 5
// by operations; the window step, on the FP32 pipes, by bytes.
//
// Step 2's kernel with an LN1 prologue is also the backward's step b (K3.b
// `spa_ln_qkv`, `lft_spa_ln_qkv` below): it recomputes xn, q, k, v from tok
// as steps 1 and 2 computed them, bit for bit.
//
// K11, the same forward on a pixel-major buffer x [Bb, h, w, A2, C] ->
// [Bb, h, w, A2, C] (replaces lft_tpu/kernels/spa_block.py:_fwd_call with
// pixel_major=True, whose BlockSpec gathers each (batch, view) plane out of
// the strided layout): only step 1 reads x and only step 5 writes the
// output, everything between is the block's own view-major [V = Bb A2, h, w,
// D] buffers. So steps 1 and 5 have a PM form that turns a view-major token
// index into the pixel-major row (`pm_row`); a pixel's C floats stay one
// contiguous 4 C-byte segment at a stride of A2 C floats, so the reads and
// writes remain whole 128-byte lines and the bounds are K2's. No view-major
// copy of x or of the output is ever made.
//
// `--dtype bfloat16` (lft_tpu's K2 with io = bf16, spa_block.py:_kernel
// :116-203): each step has a `_bf16io` instance (`lft_spa_*_bf16io`, IO =
// bf16) whose activations are bf16 in device memory: the buffers between
// the steps too, each rounded where lft_tpu rounds it, which is at every
// step's boundary. Rows are widened to f32 as they are loaded into shared
// memory (by the threads: cp.async copies bytes), the products take the
// BF path (the weights' bf16 parts, one TF32 pass over bf16 values, exact
// products summed in f32), and the epilogues round what they store: K2.2
// q, k, v; K2.4 x2 = bf16(bf16(attn Wo) + tok) and xn2 = bf16(LN2(x2));
// K2.5 hid = bf16(relu(xn2 W1)), y = bf16(bf16(hid W2) + x2) and out =
// bf16(y Wlin). K2.1 (and K11.1): tok_bf16.cuh, resident bf16 taps, bf16
// `wgmma` on a bf16 band by ldmatrix; K2.3: window_mma.cuh; K2.5 (and K11.5)
// the `_bf16` instance's kernel with bf16 rows as they lie, resident bf16
// weights and bf16 `wgmma` (ffn_bf16.cuh). With half
// the bytes, every step is bound by its bytes (the bounds at each). K11's
// two steps have the same instances (`lft_spa_*_pm_bf16io`).
//
// `--dtype mixed` serving under LFT_MM_HP_SITES=none (lft_tpu's K2 with
// mm_half and every site rounded, spa_block.py:_kernel :117-202): each step
// and K11's two have a `_bf16` instance (`lft_spa_*_bf16`) with f32
// activations in device memory and the BF products (operands rounded to
// bf16 as they load, the weights' bf16 parts, sums in f32). Only a product's
// operands round: tok, xn, x2 = attn Wo + tok, LN2, y = hid W2 + x2 and the
// output stay f32, as in the plain version; K2.3 takes lft_tpu's softmax
// (window_attn.cuh). The bytes are K2's f32 ones and the products run at the
// bf16 rate, so steps 1 and 5 become bound by bytes too. Steps 1 and 5, and
// K11's, keep their bf16 weights resident and run bf16 `wgmma` (tok_bf16.cuh,
// ffn_bf16.cuh).
//
// `--dtype mixed` under an LFT_MM_HP_SITES subset (lft_tpu's K2 with that
// plan, spa_block.py:131-203): a step whose sites all round takes its
// `_bf16` instance, one whose sites all stay f32 its f32 one, and one whose
// products span sites that differ a `_sites` instance (`lft_spa_*_sites`)
// that takes a mask of the rounding sites (tf32.cuh: S_TOK .. S_LIN) and
// picks each product's path at run time (rowgemm.cuh: rg_product_site;
// its weights split piece by piece): K2.2 (q, k by `qk`; v by `v`), K2.3
// (window_attn.cuh: q, k by `score`, v and e by `av`, the residual attn by
// `wo`) and K2.5 / K11.5 (W1, W2 by `ffn`; Wlin by `lin`). K3.b under an
// LFT_MM_HP_BWD_SITES subset that splits `qk` from `v` is K2.2's `_sites`
// kernel with the LN1 prologue (`lft_spa_ln_qkv_sites`).

#include "ffn_bf16.cuh"
#include "ffn_sites.cuh"
#include "rowgemm.cuh"
#include "spa.cuh"
#include "tok_bf16.cuh"
#include "tokenize.cuh"
#include "window_attn.cuh"

using namespace lft;

namespace {

// ---- 1: tokenisation (9 shifted C -> D taps) + PE + LN1 -----------------
// tap_conv_kernel<C, 2C, PM, true> (tokenize.cuh); the bf16 forms
// tok_bf16_kernel<C, PM, IO> (tok_bf16.cuh).

// ---- 2 and 4: token rows times one resident D x D weight --------------
// Steps 2 and 4 run their products 3xTF32 on the tensor cores (rowgemm.cuh)
// as passes of one shape: out = a W over [T, D] rows, W one D x D weight
// held in shared memory (`ResidentWeights`). Step 2 (replaces
// lft_tpu/kernels/spa_block.py:142-147, qk = xn wqk and v = tok wv: v from
// the RAW tok) is three passes, q = xn Wq, k = xn Wk, v = tok Wv; step 4
// (:196-197) one, which adds tok to the finished product (x2 = attn Wo +
// tok, one f32 rounding as in the plain version: accumulators started from
// tok would round the sum at x2's scale once a chain, 4x the plain
// version's error on an H100 when attn Wo is small beside tok) and
// normalises it in place (LN2, rowgemm.cuh:quad_ln) before both are
// written.
//
// Bound: at [400, 32, 32, 64] (T = 409,600, D = 128) step 2 does 40.3
// GFLOP, 0.244 ms as 3 TF32 products at 495 TFLOP/s (0.60 on the FP32
// pipes), and moves 1.05 GB (xn, tok in; q, k, v out), 0.313 ms at 3.35
// TB/s; step 4 13.4 GFLOP (0.081 ms) and 0.84 GB (attn, tok in; x2, xn2
// out), 0.250 ms. Both are bound by bytes, so the design keeps device
// memory busy while the tensor cores run:
// * W split is 128 KB at C = 64: it fits beside one 128-row tile of rows
//   (66 KB); 194 KB, one block an SM, persistent over tiles. With no
//   weight ring there is no block barrier in a pass: each warp owns its 16
//   rows of the tile, and the two warpgroups go at their own pace.
// * As soon as a warp's product has read its rows, it starts the cp.async
//   of its rows of its next tile into the same place, so they arrive under
//   its epilogue and the other warpgroup's product.
// * Step 2 reads xn twice (for q and for k): 1.26 GB instead of 1.05, a
//   bound of 0.376 ms, for passes without a ring. Its three weights (384
//   KB split) do not fit beside the rows at once; the first version of
//   this kernel streamed them through a weight ring as K2.5 does, all
//   three products in one pass with the rows brought ahead by bulk copies,
//   and took 1.7x the time of the three passes on an H100: the ring's
//   products, not the bytes, bound it.
// Every output is written by one warp of one block, no atomics.
template <int C>
struct RowProj {
  static constexpr int D = 2 * C;
  static constexpr int LDX = D + 4;                 // row stride of the tile
  static constexpr int SQ = 2 * D * D;              // floats of a D x D weight split
  static constexpr size_t BYTES = (static_cast<size_t>(SQ) + RG_M * LDX) * 4;
  static_assert(BYTES <= RG_SMEM_MAX, "the weight and the tile must fit in shared memory");
};

// The warp's 16 rows of tile `tile` of src [T, D] into aw (row stride D + 4)
// by cp.async, zero past T; one group.
template <int D>
__device__ __forceinline__ void warp_rows(float* aw, const float* __restrict__ src, int tile,
                                          int T) {
  const int lane = threadIdx.x & 31, t0 = tile * RG_M + 16 * (threadIdx.x >> 5);
  for (int i = lane; i < 16 * (D / 4); i += 32) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const bool ok = t0 + r < T;
    cp_async16(aw + r * (D + 4) + c, src + static_cast<size_t>(ok ? t0 + r : 0) * D + c, ok);
  }
  cp_async_commit();
}

// The same from bf16 rows, widened to f32 by the warp's own loads and
// stores, with the group committed as the f32 form commits it: the caller's
// `cp_async_wait` then covers the copies issued before (row_pass's weight),
// which an uncommitted group would leave in flight. The loads are coherent
// (ld.global.cs, not the read-only path): K3.b's pass k reads back the xn
// its pass q wrote in the same launch.
template <int D>
__device__ __forceinline__ void warp_rows(float* aw, const bf16* __restrict__ src, int tile,
                                          int T) {
  const int lane = threadIdx.x & 31, t0 = tile * RG_M + 16 * (threadIdx.x >> 5);
  for (int i = lane; i < 16 * (D / 4); i += 32) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    store4(aw + r * (D + 4) + c, t0 + r < T ? ldcs4(src + static_cast<size_t>(t0 + r) * D + c)
                                            : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  cp_async_commit();
}

// What a pass does to the warp's 16 rows of a tile [t0, t0 + 16) once they
// have landed, before its product: nothing (K2.2, K2.4) or K3.b's LN1.
struct NoRows {
  __device__ __forceinline__ void operator()(float*, int, int) const {}
};

// K3.b's prologue: the rows, tok, become xn = LN1(tok + pe_tok[t % hw]) in
// place with K2.1's epilogue arithmetic (RowLN, one warp a row, as
// tokenize.cuh's tap_conv_kernel normalises tok), so the pass's product
// reads xn, and xn is written to device memory (rows < T). With tok from
// K2.1 the rows are K2.1's xn bit for bit, and the product K2.2's. All 16
// rows' loads go out before the first row's sums, and their 32 warp sums
// interleave: row by row, each waiting on its pe_tok loads and then on its
// two dependent sums, the prologue took K3.b from K2.2's 0.15 ms to 0.22 at
// [100, 32, 32, 64] on an H100. Pad rows past T are normalised too (their
// pe_tok row exists; their products are not stored).
// IO = bf16 (K3.b's bf16-IO instance): xn written as bf16 (the product
// rounds the rows it reads alike, with BF); pe_tok f32 (its bf16 values).
template <int D, class IO = float>
struct Ln1Rows {
  const float* pe_tok;   // [hw, D]
  const float* ln;       // LN1 weight, then bias
  IO* xn;                // [T, D]
  int hw;
  __device__ __forceinline__ void operator()(float* aw, int t0, int T) const {
    using RL = RowLN<D>;
    constexpr int LDX = D + 4;
    float v[16][RL::E];
    int p = t0 % hw;   // token t0's row of pe_tok
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* pe = pe_tok + static_cast<size_t>(p) * D;
#pragma unroll
      for (int e = 0; e < RL::E; ++e)
        if (RL::valid(e)) v[r][e] = aw[r * LDX + RL::col(e)] + __ldg(pe + RL::col(e));
      p = p + 1 == hw ? 0 : p + 1;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) RL::apply(v[r], ln, ln + D);
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int e = 0; e < RL::E; ++e)
        if (RL::valid(e)) {
          aw[r * LDX + RL::col(e)] = v[r][e];
          if (t0 + r < T) st1(xn + static_cast<size_t>(t0 + r) * D + RL::col(e), v[r][e]);
        }
    __syncwarp();   // the product reads other lanes' columns
  }
};

// Loads the split weight w (RowProj::SQ floats) into shared memory and the
// warps' rows of the block's first tile of a, then out = a W over the
// block's tiles. LN (step 4): out = a W + res, and out_ln = LN(out) with
// weight lw, bias lb. `rows` runs on each tile's rows before its product.
// Ends with every warp past its last read of W. IO = bf16: a, res, out and
// out_ln bf16, out = bf16(bf16(a W) + res) under LN, else bf16(a W).
template <int C, bool LN, class Rows = NoRows, bool BF = false, class IO = float>
__device__ __forceinline__ void row_pass(const named_t<IO>* __restrict__ a,
                                         const float* __restrict__ w,
                                         named_t<IO>* __restrict__ out,
                                         const named_t<IO>* __restrict__ res,
                                         const float* __restrict__ lw,
                                         const float* __restrict__ lb,
                                         named_t<IO>* __restrict__ out_ln, float* smem, int T,
                                         Rows rows = {}) {
  using L = RowProj<C>;
  constexpr int D = L::D, LDX = L::LDX;
  const int warp = threadIdx.x >> 5;
  float* aw = smem + L::SQ + 16 * warp * LDX;   // the warp's 16 rows of a
  const int tiles = (T + RG_M - 1) / RG_M;
  for (int i = 4 * static_cast<int>(threadIdx.x); i < L::SQ; i += 4 * RG_NT)
    cp_async16(smem + i, w + i, true);
  warp_rows<D>(aw, a, blockIdx.x, T);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  ResidentWeights wr{smem};
  const float* st = nullptr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;   // the warp's first token
    rows(aw, t0, T);
    RgAcc<D> acc;
    rg_zero<D>(acc);
    rg_product<D, D, 0, false, BF>(acc, aw, LDX, wr, st);
    __syncwarp();   // the warp's rows are read
    if (tile + static_cast<int>(gridDim.x) < tiles) warp_rows<D>(aw, a, tile + gridDim.x, T);
    if constexpr (LN) {   // + res, to the finished product as the plain version adds it
      rg_pairs<D>(acc, [&](int r, int c, float& v0, float& v1) {
        if (t0 + r < T) {
          const float2 t = ldg2(res + static_cast<size_t>(t0 + r) * D + c);
          v0 = io_round<IO>(io_round<IO>(v0) + t.x);
          v1 = io_round<IO>(io_round<IO>(v1) + t.y);
        }
      });
    }
    auto put = [&](IO* __restrict__ dst) {
      rg_pairs<D>(acc, [&](int r, int c, float v0, float v1) {
        if (t0 + r < T) st2(dst + static_cast<size_t>(t0 + r) * D + c, v0, v1);
      });
    };
    put(out);
    if constexpr (LN) {
      quad_ln<D>(acc, lw, lb);
      put(out_ln);
    }
    cp_async_wait<0>();
    __syncwarp();
  }
  __syncthreads();
}

// Step 2 (LN1 false), and K3.b (LN1 true: spa_block_bwd.cu's step b, which
// recomputes xn, q, k, v from tok). wf: Wq, Wk, Wv split (3 RowProj::SQ
// floats, kernels/rowgemm.py:qkv_stream), written by rg_weights_kernel.
// K3.b's pass q reads tok and runs the LN1 prologue (`Ln1Rows`), which
// writes xn (ln1.xn, the buffer `xn` points to); pass k reads that xn back
// (each warp the rows it wrote; 52 MB more at [100, 32, 32, 64], as K2.2
// reads xn twice), pass v reads tok. So K3.b's (xn, q, k, v) are K2.1's xn
// and K2.2's (q, k, v) bit for bit, and step c's scores from them are
// K2.3's, which the forward's (m, l) fit exactly.
// Bound of K3.b at [100, 32, 32, 64] (T = 102,400, D = 128): 10.07 GFLOP,
// 0.061 ms as 3 TF32 products at 495 TFLOP/s (0.150 on the FP32 pipes); tok
// and pe_tok in, xn, q, k, v out, 262.9 MB, 0.0785 ms at 3.35 TB/s: bytes.
// BF (K3.b under `--dtype mixed`'s backward, `lft_spa_ln_qkv_bf16`): the
// products over bf16-rounded xn, tok and weights, one TF32 pass each; its q,
// k, v then differ from the f32 forward's, as lft_tpu's do (its backward
// rebuilds the scores from bf16 q and k against the f32 forward's (m, l)).
// IO = bf16 (with BF): K2.2 `spa_qkv_bf16io`, xn, tok, q, k, v bf16; with
// LN1 K3.b's `spa_ln_qkv_bf16io` (`--dtype bfloat16` training, lft_tpu's
// _bwd_kernel :433-445): tok in bf16, xn = bf16(LN1(tok + pe_tok)), q, k,
// v bf16, pe_tok f32 of its bf16 values. Bound at [400, 32, 32, 64]: 40.3
// GFLOP at the bf16 rate 0.041 ms, 0.52 GB (0.63 reading xn twice) 0.157
// ms: bytes; K3.b's at [100, 32, 32, 64]: tok in, xn, q, k, v out and xn
// read back, 0.16 GB, 0.047 ms.
template <int C, bool LN1, bool BF = false, class IO = float>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_qkv_kernel(const IO* xn, const IO* __restrict__ tok,
                   const float* __restrict__ wf, IO* __restrict__ q,
                   IO* __restrict__ k, IO* __restrict__ v, int T, Ln1Rows<2 * C, IO> ln1) {
  constexpr int SQ = RowProj<C>::SQ;
  extern __shared__ __align__(16) float smem[];
  if constexpr (LN1)
    row_pass<C, false, Ln1Rows<2 * C, IO>, BF, IO>(tok, wf, q, nullptr, nullptr, nullptr,
                                                   nullptr, smem, T, ln1);
  else
    row_pass<C, false, NoRows, BF, IO>(xn, wf, q, nullptr, nullptr, nullptr, nullptr, smem, T);
  row_pass<C, false, NoRows, BF, IO>(xn, wf + SQ, k, nullptr, nullptr, nullptr, nullptr, smem, T);
  row_pass<C, false, NoRows, BF, IO>(tok, wf + 2 * SQ, v, nullptr, nullptr, nullptr, nullptr,
                                     smem, T);
}

// Step 2's site-subset form (`spa_qkv_sites`, `--dtype mixed` under an
// LFT_MM_HP_SITES subset): the same three passes, q and k BF where `qk`
// rounds (S_QK of `sites`), v where `v` does, 3xTF32 elsewhere (a uniform
// branch a pass); wf split piece by piece to match. LN1 (K3.b's
// `spa_ln_qkv_sites`, an LFT_MM_HP_BWD_SITES subset): pass q reads tok and
// runs spa_qkv_kernel<C, true>'s prologue (xn = LN1(tok + pe_tok) f32,
// written to ln1.xn, which passes k reads back).
template <int C, bool LN1 = false>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_qkv_sites_kernel(const float* xn, const float* __restrict__ tok,
                         const float* __restrict__ wf, float* __restrict__ q,
                         float* __restrict__ k, float* __restrict__ v, int T, int sites,
                         Ln1Rows<2 * C, float> ln1) {
  constexpr int SQ = RowProj<C>::SQ;
  extern __shared__ __align__(16) float smem[];
  auto pass = [&](bool bf, const float* a, const float* w, float* out) {
    if (bf)
      row_pass<C, false, NoRows, true>(a, w, out, nullptr, nullptr, nullptr, nullptr, smem, T);
    else
      row_pass<C, false, NoRows, false>(a, w, out, nullptr, nullptr, nullptr, nullptr, smem, T);
  };
  if constexpr (LN1) {
    if (sites & S_QK)
      row_pass<C, false, Ln1Rows<2 * C, float>, true>(tok, wf, q, nullptr, nullptr, nullptr,
                                                      nullptr, smem, T, ln1);
    else
      row_pass<C, false, Ln1Rows<2 * C, float>, false>(tok, wf, q, nullptr, nullptr, nullptr,
                                                       nullptr, smem, T, ln1);
  } else {
    pass(sites & S_QK, xn, wf, q);
  }
  pass(sites & S_QK, xn, wf + SQ, k);
  pass(sites & S_V, tok, wf + 2 * SQ, v);
}

// ---- 3: 5x5-window attention -------------------------------------------
// spa_window_attn_kernel<DH, STATS> (window_attn.cuh), which K5's forward
// launches too.

// ---- 4: out-projection + residual + LN2 ---------------------------------
// One pass of step 2's (above). wf: Wo split (RowProj::SQ floats,
// kernels/rowgemm.py:outproj_stream), written by rg_weights_kernel. IO =
// bf16 (`spa_outproj_ln_bf16io`, BF products): attn, tok, x2, xn2 bf16;
// bound at [400, 32, 32, 64]: 0.42 GB, 0.125 ms, bytes. BF with IO = float
// (`spa_outproj_ln_bf16`): attn and Wo rounded to bf16 in the product, x2 =
// attn Wo + tok and LN2 f32.
template <int C, class IO = float, bool BF = is_bf16<IO>>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_outproj_ln_kernel(const IO* __restrict__ attn, const IO* __restrict__ tok,
                          const float* __restrict__ wf, const float* __restrict__ ln,
                          IO* __restrict__ x2, IO* __restrict__ xn2, int T) {
  constexpr int D = 2 * C;
  extern __shared__ __align__(16) float smem[];
  row_pass<C, true, NoRows, BF, IO>(attn, wf, x2, tok, ln + 2 * D, ln + 3 * D, xn2, smem, T);
}

// ---- 5: FFN + residual + Token2SAI --------------------------------------
// out = (relu(xn2 W1) W2 + x2) Wlin, the three products 3xTF32 on the tensor
// cores (rowgemm.cuh): at [400, 32, 32, 64] 60.4 GFLOP, 0.37 ms as 3 TF32
// products at 495 TFLOP/s (0.90 on the FP32 pipes), its 0.52 GB 0.16 ms; so
// bound by operations. A block of two warpgroups takes 128 token rows a
// tile, persistent over tiles. The hidden layer goes in chunks of HC = 64
// columns: h = relu(xn2 W1[:, chunk]) into shared memory, then y += h
// W2[chunk, :] in registers, so neither the 2D-wide hidden tile nor the
// two accumulator sets of a 256-column product are ever held. Then y + x2
// (f32) goes over the dead xn2 rows and out = y Wlin is written. Shared
// memory at C = 64: xn2 / y 66 KB, a hidden chunk 34 KB, a ring of 7
// 16-KB weight stages; 212 KB, one block an SM.
template <int C>
struct FfnOut {
  static constexpr int D = 2 * C;
  static constexpr int HC = 2 * D < 64 ? 2 * D : 64;   // hidden columns a chunk
  static constexpr int NH = 2 * D / HC;                 // chunks
  static constexpr int LDX = D + 4, LDH = HC + 4;       // row strides
  static constexpr int W1 = 2 * D * HC, W2 = 2 * HC * D;  // floats of a chunk's pieces
  static constexpr int OFF_LIN = NH * (W1 + W2);
  static constexpr int FLOATS = OFF_LIN + 2 * D * C;    // the weight stream
  static constexpr int TILES = RG_M * (LDX + LDH) * 4;  // bytes of rows
  static constexpr int NS = rg_slots(TILES);
  static constexpr size_t BYTES = TILES + static_cast<size_t>(NS) * RG_SF * 4;
};

// PM: out is pixel-major [T / (hw A2), hw, A2, C]; xn2 and x2 are view-major.
// wf: the weight stream (FfnOut::FLOATS floats, kernels/rowgemm.py:
// ffn_out_stream), written by rg_weights_kernel. (K2.5's other instances
// have kernels of their own: `spa_ffn_out[_pm]_bf16` and `_bf16io`
// ffn_bf16.cuh, `spa_ffn_out[_pm]_sites` ffn_sites.cuh.)
template <int C, bool PM>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_ffn_out_kernel(const float* __restrict__ xn2, const float* __restrict__ x2,
                       const float* __restrict__ wf, float* __restrict__ out, int T, int hw,
                       int A2) {
  using F = FfnOut<C>;
  constexpr int D = F::D, HC = F::HC, LDX = F::LDX, LDH = F::LDH;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xw = smem + 16 * warp * LDX;                   // the warp's 16 rows: xn2, then y
  float* hw16 = smem + RG_M * LDX + 16 * warp * LDH;    // and of a hidden chunk
  const int tiles = (T + RG_M - 1) / RG_M;
  WeightRing<F::NS> ring;
  ring.start(smem + RG_M * (LDX + LDH), wf, F::FLOATS,
             (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x);
  const float* st = nullptr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;   // the warp's first token
    {  // the warp's rows of xn2, all loads in flight at once (zero past T)
      constexpr int L = D / 8;   // float4 a lane
      float4 v[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = lane + 32 * k, r = i / (D / 4), c = 4 * (i % (D / 4));
        v[k] = t0 + r < T ? ldg4(xn2 + static_cast<size_t>(t0 + r) * D + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = lane + 32 * k;
        store4(xw + i / (D / 4) * LDX + 4 * (i % (D / 4)), v[k]);
      }
      __syncwarp();
    }
    RgAcc<D> y;
    rg_zero<D>(y);
    rg_static_for<F::NH>([&](auto J) {
      constexpr int off = decltype(J)::value * (F::W1 + F::W2);
      RgAcc<HC> h;
      rg_zero<HC>(h);
      rg_product<D, HC, off>(h, xw, LDX, ring, st);
      __syncwarp();   // the previous chunk's rows are read
      rg_pairs<HC>(h, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(hw16 + r * LDH + c) =
            make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      });
      __syncwarp();
      rg_product<HC, D, off + F::W1>(y, hw16, LDH, ring, st);
    });
    __syncwarp();     // xn2 is read
    rg_pairs<D>(y, [&](int r, int c, float v0, float v1) {
      const int t = t0 + r;
      const float2 res = t < T ? ldg2(x2 + static_cast<size_t>(t) * D + c)
                               : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(xw + r * LDX + c) = make_float2(v0 + res.x, v1 + res.y);
    });
    __syncwarp();
    RgAcc<C> o;
    rg_zero<C>(o);
    rg_product<D, C, F::OFF_LIN>(o, xw, LDX, ring, st);
    rg_pairs<C>(o, [&](int r, int c, float v0, float v1) {
      const int t = t0 + r;
      if (t >= T) return;
      long long row = t;
      if constexpr (PM) row = pm_row(row, hw, A2);
      st2(out + row * C + c, v0, v1);
    });
  }
  cp_async_wait<0>();
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// All token tensors are [T, *] with T = V*h*w tokens in [V, h, w] order.
// Weights use "x @ W" layouts: wqk [D, 2D],
// wv/wo [D, D], w1 [D, 2D], w2 [2D, D], wlin [D, C]; ln [4, D] is
// (LN1 w, b, LN2 w, b). Each returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take (C in {16, 32, 64}).

namespace {

// BF: the band and the taps rounded to bf16, tok_bf16.cuh's kernel (tiles
// of kernels/spa_block.py:tok_bf16_tile); set by IO = bf16.
template <bool PM, class IO = float, bool BF = is_bf16<IO>>
int tokenize_ln(const IO* x, const IO* pe_tok, const float* wu, float* wf, const float* ln,
                IO* tok, IO* xn, int V, int h, int w, int A2, int C, int r, int cw,
                cudaStream_t s) {
  LFT_DISPATCH_C(C, {
    if constexpr (BF)
      return launch_tok_bf16<CC, PM, IO>(x, wu, wf, pe_tok, ln, tok, xn, V, h, w, A2, r, cw, s);
    else
      return launch_tap_conv<CC, 2 * CC, PM, true, false>(x, wu, wf, pe_tok, ln, tok, xn, V, h,
                                                         w, A2, r, cw, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool PM>
int ffn_out(const float* xn2, const float* x2, const float* w1, const float* w2,
            const float* wlin, float* wf, float* out, int T, int hw, int A2, int C,
            cudaStream_t s) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  LFT_DISPATCH_C(C, {
    using F = FfnOut<CC>;
    RgPieces ps{};
    int n = 0;
    for (int j = 0; j < F::NH; ++j) {
      ps.p[n++] = RgPiece{w1 + j * F::HC, 2 * F::D, F::D, F::HC, j * (F::W1 + F::W2)};
      ps.p[n++] = RgPiece{w2 + static_cast<size_t>(j) * F::HC * F::D, F::D, F::HC, F::D,
                          j * (F::W1 + F::W2) + F::W1};
    }
    ps.p[n++] = RgPiece{wlin, CC, F::D, CC, F::OFF_LIN};
    launch_rg_weights(ps, n, wf, s);
    auto kernel = spa_ffn_out_kernel<CC, PM>;
    LFT_SET_SMEM(kernel, F::BYTES);
    kernel<<<rg_grid((T + RG_M - 1) / RG_M), RG_NT, F::BYTES, s>>>(xn2, x2, wf, out, T, hw, A2);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Step 1: x [V, h, w, C] -> tok, xn [V, h, w, D]; wu [9, C, D]; wf scratch of
// 18 C D floats (wu split into TF32 hi/lo, kernels/spa_block.py:tap_weights);
// a block takes r x cw pixels of a view (kernels/spa_block.py:tok_tile).
extern "C" int lft_spa_tokenize_ln(const float* x, const float* pe_tok, const float* wu,
                                   float* wf, const float* ln, float* tok, float* xn, int V,
                                   int h, int w, int C, int r, int cw, void* stream) {
  return tokenize_ln<false>(x, pe_tok, wu, wf, ln, tok, xn, V, h, w, 1, C, r, cw,
                            static_cast<cudaStream_t>(stream));
}

// Step 1's bf16-IO instance: x, pe_tok, tok, xn bf16; wu and ln f32 (wu's
// bf16 values); wf a scratch of 9 C D bf16 values (kernels/spa_block.py:
// tok_bf16_floats floats); tiles of kernels/spa_block.py:tok_bf16_tile.
extern "C" int lft_spa_tokenize_ln_bf16io(const bf16* x, const bf16* pe_tok, const float* wu,
                                          float* wf, const float* ln, bf16* tok, bf16* xn,
                                          int V, int h, int w, int C, int r, int cw,
                                          void* stream) {
  return tokenize_ln<false, bf16>(x, pe_tok, wu, wf, ln, tok, xn, V, h, w, 1, C, r, cw,
                                  static_cast<cudaStream_t>(stream));
}

// Step 1's bf16-operand instance (`--dtype mixed` where `tok` rounds):
// lft_spa_tokenize_ln_bf16io's arguments with x, pe_tok, tok and xn f32; x
// and wu rounded to bf16 in the product.
extern "C" int lft_spa_tokenize_ln_bf16(const float* x, const float* pe_tok, const float* wu,
                                        float* wf, const float* ln, float* tok, float* xn, int V,
                                        int h, int w, int C, int r, int cw, void* stream) {
  return tokenize_ln<false, float, true>(x, pe_tok, wu, wf, ln, tok, xn, V, h, w, 1, C, r, cw,
                                         static_cast<cudaStream_t>(stream));
}

namespace {

template <class IO, bool BF = is_bf16<IO>>
int tokenize_ln_pm(const IO* x, const IO* pe_tok, const float* wu, float* wf, const float* ln,
                   IO* tok, IO* xn, int Bb, int h, int w, int A2, int C, int r, int cw,
                   cudaStream_t s) {
  if (Bb < 1 || A2 < 1 || static_cast<long long>(Bb) * A2 * h * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return tokenize_ln<true, IO, BF>(x, pe_tok, wu, wf, ln, tok, xn, Bb * A2, h, w, A2, C, r, cw,
                                   s);
}

}  // namespace

// K11's first step: x [Bb, h, w, A2, C] pixel-major -> tok, xn [Bb * A2, h, w, D].
extern "C" int lft_spa_tokenize_ln_pm(const float* x, const float* pe_tok, const float* wu,
                                      float* wf, const float* ln, float* tok, float* xn, int Bb,
                                      int h, int w, int A2, int C, int r, int cw, void* stream) {
  return tokenize_ln_pm<float>(x, pe_tok, wu, wf, ln, tok, xn, Bb, h, w, A2, C, r, cw,
                               static_cast<cudaStream_t>(stream));
}

// Its bf16-operand instance: as lft_spa_tokenize_ln_bf16.
extern "C" int lft_spa_tokenize_ln_pm_bf16(const float* x, const float* pe_tok, const float* wu,
                                           float* wf, const float* ln, float* tok, float* xn,
                                           int Bb, int h, int w, int A2, int C, int r, int cw,
                                           void* stream) {
  return tokenize_ln_pm<float, true>(x, pe_tok, wu, wf, ln, tok, xn, Bb, h, w, A2, C, r, cw,
                                     static_cast<cudaStream_t>(stream));
}

// Its bf16-IO instance: as lft_spa_tokenize_ln_bf16io, x pixel-major (a
// (pixel, view) row is C bf16 values, 2 C bytes, at a stride of A2 C).
extern "C" int lft_spa_tokenize_ln_pm_bf16io(const bf16* x, const bf16* pe_tok, const float* wu,
                                             float* wf, const float* ln, bf16* tok, bf16* xn,
                                             int Bb, int h, int w, int A2, int C, int r, int cw,
                                             void* stream) {
  return tokenize_ln_pm<bf16>(x, pe_tok, wu, wf, ln, tok, xn, Bb, h, w, A2, C, r, cw,
                              static_cast<cudaStream_t>(stream));
}

namespace {

// Step 2 or (LN1) K3.b: the weights split into wf, then spa_qkv_kernel; BF:
// their bf16 parts and the BF instance; IO = bf16: step 2's bf16-IO instance.
template <bool LN1, bool BF = false, class IO = float>
int qkv(const named_t<IO>* xn, const named_t<IO>* tok, const float* wqk, const float* wv,
        float* wf, named_t<IO>* q, named_t<IO>* k, named_t<IO>* v, int T, int C,
        const float* pe_tok, const float* ln, named_t<IO>* xn_out, int hw, cudaStream_t s) {
  if (T < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  LFT_DISPATCH_C(C, {
    using L = RowProj<CC>;
    RgPieces ps{};
    ps.p[0] = RgPiece{wqk, 2 * L::D, L::D, L::D, 0};
    ps.p[1] = RgPiece{wqk + L::D, 2 * L::D, L::D, L::D, L::SQ};
    ps.p[2] = RgPiece{wv, L::D, L::D, L::D, 2 * L::SQ};
    launch_rg_weights(ps, 3, wf, s, BF);
    auto kernel = spa_qkv_kernel<CC, LN1, BF, IO>;
    LFT_SET_SMEM(kernel, L::BYTES);
    Ln1Rows<L::D, IO> ln1{};
    if constexpr (LN1) ln1 = Ln1Rows<L::D, IO>{pe_tok, ln, xn_out, hw};
    kernel<<<rg_grid((T + RG_M - 1) / RG_M), RG_NT, L::BYTES, s>>>(LN1 ? xn_out : xn, tok, wf, q,
                                                                    k, v, T, ln1);
  });
  return static_cast<int>(cudaGetLastError());
}

// Step 2's site-subset form: each weight split as its pass reads it, then
// spa_qkv_sites_kernel; LN1: K3.b's, pe_tok, ln, xn_out and hw as qkv's.
template <bool LN1 = false>
int qkv_sites(const float* xn, const float* tok, const float* wqk, const float* wv, float* wf,
              float* q, float* k, float* v, int T, int C, int sites, cudaStream_t s,
              const float* pe_tok = nullptr, const float* ln = nullptr, float* xn_out = nullptr,
              int hw = 1) {
  if (T < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  LFT_DISPATCH_C(C, {
    using L = RowProj<CC>;
    RgPieces ps{};
    ps.p[0] = RgPiece{wqk, 2 * L::D, L::D, L::D, 0};
    ps.p[1] = RgPiece{wqk + L::D, 2 * L::D, L::D, L::D, L::SQ};
    ps.p[2] = RgPiece{wv, L::D, L::D, L::D, 2 * L::SQ};
    ps.p[0].bf = ps.p[1].bf = (sites & S_QK) != 0;
    ps.p[2].bf = (sites & S_V) != 0;
    launch_rg_weights(ps, 3, wf, s, false, true);
    auto kernel = spa_qkv_sites_kernel<CC, LN1>;
    LFT_SET_SMEM(kernel, L::BYTES);
    Ln1Rows<L::D, float> ln1{};
    if constexpr (LN1) ln1 = Ln1Rows<L::D, float>{pe_tok, ln, xn_out, hw};
    kernel<<<rg_grid((T + RG_M - 1) / RG_M), RG_NT, L::BYTES, s>>>(LN1 ? xn_out : xn, tok, wf, q,
                                                                    k, v, T, sites, ln1);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Step 2: wf is a scratch of 3 RowProj<C>::SQ floats (kernels/rowgemm.py:
// qkv_floats), Wq, Wk, Wv split into TF32 hi/lo by the launch's first
// kernel.
extern "C" int lft_spa_qkv(const float* xn, const float* tok, const float* wqk,
                           const float* wv, float* wf, float* q, float* k, float* v, int T,
                           int C, void* stream) {
  return qkv<false>(xn, tok, wqk, wv, wf, q, k, v, T, C, nullptr, nullptr, nullptr, 1,
                    static_cast<cudaStream_t>(stream));
}

// Step 2's bf16-IO instance: xn, tok, q, k, v bf16; wqk, wv f32 (their bf16
// values), wf as lft_spa_qkv's, holding their bf16 parts.
extern "C" int lft_spa_qkv_bf16io(const bf16* xn, const bf16* tok, const float* wqk,
                                  const float* wv, float* wf, bf16* q, bf16* k, bf16* v, int T,
                                  int C, void* stream) {
  return qkv<false, true, bf16>(xn, tok, wqk, wv, wf, q, k, v, T, C, nullptr, nullptr, nullptr,
                                1, static_cast<cudaStream_t>(stream));
}

// Step 2's bf16-operand instance (`--dtype mixed` serving under
// LFT_MM_HP_SITES=none): lft_spa_qkv's arguments; xn, tok and the weights
// rounded to bf16 in the products (wf holding their bf16 parts), q, k, v f32.
extern "C" int lft_spa_qkv_bf16(const float* xn, const float* tok, const float* wqk,
                                const float* wv, float* wf, float* q, float* k, float* v, int T,
                                int C, void* stream) {
  return qkv<false, true>(xn, tok, wqk, wv, wf, q, k, v, T, C, nullptr, nullptr, nullptr, 1,
                          static_cast<cudaStream_t>(stream));
}

// Step 2's site-subset instance (`--dtype mixed` under an LFT_MM_HP_SITES
// subset): lft_spa_qkv's arguments and `sites`, the mask of the sites that
// round (tf32.cuh: S_QK for passes q and k, S_V for pass v); wf holds each
// weight split as its pass reads it.
extern "C" int lft_spa_qkv_sites(const float* xn, const float* tok, const float* wqk,
                                 const float* wv, float* wf, float* q, float* k, float* v, int T,
                                 int C, int sites, void* stream) {
  return qkv_sites(xn, tok, wqk, wv, wf, q, k, v, T, C, sites, static_cast<cudaStream_t>(stream));
}

// K3.b (the backward's step b): tok [T, D], pe_tok [hw, D], ln [4, D] (LN1's
// rows first) -> xn, q, k, v [T, D]; wf as lft_spa_qkv's.
extern "C" int lft_spa_ln_qkv(const float* tok, const float* pe_tok, const float* ln,
                              const float* wqk, const float* wv, float* wf, float* xn,
                              float* q, float* k, float* v, int T, int hw, int C,
                              void* stream) {
  return qkv<true>(nullptr, tok, wqk, wv, wf, q, k, v, T, C, pe_tok, ln, xn, hw,
                   static_cast<cudaStream_t>(stream));
}

// K3.b's bf16-operand instance (`--dtype mixed`'s backward): the same
// arguments; wf holds the weights' bf16 parts in the same layout.
extern "C" int lft_spa_ln_qkv_bf16(const float* tok, const float* pe_tok, const float* ln,
                                   const float* wqk, const float* wv, float* wf, float* xn,
                                   float* q, float* k, float* v, int T, int hw, int C,
                                   void* stream) {
  return qkv<true, true>(nullptr, tok, wqk, wv, wf, q, k, v, T, C, pe_tok, ln, xn, hw,
                         static_cast<cudaStream_t>(stream));
}

// K3.b's site-subset instance (`--dtype mixed` under an LFT_MM_HP_BWD_SITES
// subset that rounds one of `qk` and `v`): the same arguments and `sites`
// (tf32.cuh: S_QK, S_V), wf holding each weight split as its pass reads it.
extern "C" int lft_spa_ln_qkv_sites(const float* tok, const float* pe_tok, const float* ln,
                                    const float* wqk, const float* wv, float* wf, float* xn,
                                    float* q, float* k, float* v, int T, int hw, int C,
                                    int sites, void* stream) {
  return qkv_sites<true>(nullptr, tok, wqk, wv, wf, q, k, v, T, C, sites,
                         static_cast<cudaStream_t>(stream), pe_tok, ln, xn, hw);
}

// K3.b's bf16-IO instance (`--dtype bfloat16` training): tok, xn, q, k, v
// bf16; pe_tok, ln and the weights f32 (their bf16 values), wf holding the
// weights' bf16 parts.
extern "C" int lft_spa_ln_qkv_bf16io(const bf16* tok, const float* pe_tok, const float* ln,
                                     const float* wqk, const float* wv, float* wf, bf16* xn,
                                     bf16* q, bf16* k, bf16* v, int T, int hw, int C,
                                     void* stream) {
  return qkv<true, true, bf16>(nullptr, tok, wqk, wv, wf, q, k, v, T, C, pe_tok, ln, xn, hw,
                               static_cast<cudaStream_t>(stream));
}

namespace {

template <bool STATS>
int window_attn(const float* q, const float* k, const float* v, float* attn, float* m,
                float* l, int V, int h, int w, int D, int H, float scale, cudaStream_t s) {
  if (H != 8 || V < 1 || h < 1 || w < 1 || D % WA_G) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(V) * ((h + WA_TY - 1) / WA_TY) *
                          ((w + WA_TX - 1) / WA_TX) * (D / WA_G);
  if (items > 0x7fffffffLL || static_cast<long long>(V) * h * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D / H) {
#define LFT_ATTN_CASE(DHV)                                                        \
    case DHV: {                                                                   \
      auto kernel = spa_window_attn_kernel<DHV, STATS>;                           \
      LFT_SET_SMEM(kernel, WA_BYTES);                                             \
      kernel<<<static_cast<int>(items), WA_NT, WA_BYTES, s>>>(q, k, v, attn, m, l, V, h, w, \
                                                               scale);              \
      break;                                                                      \
    }
    LFT_ATTN_CASE(4)
    LFT_ATTN_CASE(8)
    LFT_ATTN_CASE(16)
#undef LFT_ATTN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lft_spa_window_attn(const float* q, const float* k, const float* v,
                                   float* attn, int V, int h, int w, int D, int H,
                                   float scale, void* stream) {
  return window_attn<false>(q, k, v, attn, nullptr, nullptr, V, h, w, D, H, scale,
                            static_cast<cudaStream_t>(stream));
}

namespace {

// lft_tpu's softmax on f32 q, k, v (window_attn.cuh: window_softmax_max_heads,
// the bf16-operand kernel): a block a (view, 16 x 16 tile) item.
template <bool STATS>
int window_attn_max_heads(const float* q, const float* k, const float* v, float* attn, float* m,
                          float* l, int V, int h, int w, int D, int H, float scale,
                          cudaStream_t s) {
  if (H != 8 || V < 1 || h < 1 || w < 1 || D % WA_G) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(V) * ((h + WA_TY - 1) / WA_TY) *
                          ((w + WA_TX - 1) / WA_TX);
  if (items > 0x7fffffffLL || static_cast<long long>(V) * h * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D / H) {
#define LFT_ATTN_CASE(DHV)                                                                  \
    case DHV: {                                                                             \
      auto kernel = spa_window_attn_bf16_kernel<DHV, STATS>;                                \
      LFT_SET_SMEM(kernel, WA_BYTES);                                                       \
      kernel<<<static_cast<int>(items), WA_NT, WA_BYTES, s>>>(q, k, v, attn, m, l, V, h, w, \
                                                               scale);                      \
      break;                                                                                \
    }
    LFT_ATTN_CASE(4)
    LFT_ATTN_CASE(8)
    LFT_ATTN_CASE(16)
#undef LFT_ATTN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Step 3's bf16-IO instance (window_mma.cuh): q, k, v, attn bf16; a block
// takes a (view, 8 x 8 tile) item and every head.
extern "C" int lft_spa_window_attn_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                          bf16* attn, int V, int h, int w, int D, int H,
                                          float scale, void* stream) {
  return launch_window_mma<false>(q, k, v, attn, nullptr, nullptr, V, h, w, D, H, scale,
                                  static_cast<cudaStream_t>(stream));
}

// Step 3's bf16-operand instance (`--dtype mixed` serving under
// LFT_MM_HP_SITES=none): lft_spa_window_attn's arguments; q, k, v rounded to
// bf16 as they load, lft_tpu's softmax with e rounded, attn f32.
extern "C" int lft_spa_window_attn_bf16(const float* q, const float* k, const float* v,
                                        float* attn, int V, int h, int w, int D, int H,
                                        float scale, void* stream) {
  return window_attn_max_heads<false>(q, k, v, attn, nullptr, nullptr, V, h, w, D, H, scale,
                                      static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [V, h, w, H] f32 (the residuals of K3's
// bf16-IO form: m each query's max over its heads, in every head's slot).
extern "C" int lft_spa_window_attn_res_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                              bf16* attn, float* m, float* l, int V, int h,
                                              int w, int D, int H, float scale, void* stream) {
  return launch_window_mma<true>(q, k, v, attn, m, l, V, h, w, D, H, scale,
                                 static_cast<cudaStream_t>(stream));
}

// The bf16-operand instance with the residuals (`--dtype mixed` training
// under LFT_MM_HP_SITES=none): lft_spa_window_attn_res's arguments; m each
// query's max over its heads and its window's out-of-image keys in every
// head's slot, l each head's sum, attn f32 holding bf16 values.
extern "C" int lft_spa_window_attn_res_bf16(const float* q, const float* k, const float* v,
                                            float* attn, float* m, float* l, int V, int h,
                                            int w, int D, int H, float scale, void* stream) {
  return window_attn_max_heads<true>(q, k, v, attn, m, l, V, h, w, D, H, scale,
                                     static_cast<cudaStream_t>(stream));
}

namespace {

// The site-subset form of lft_tpu's softmax (window_attn.cuh:
// spa_window_attn_sites_kernel): a block a (view, 16 x 16 tile) item.
template <bool STATS>
int window_attn_sites(const float* q, const float* k, const float* v, float* attn, float* m,
                      float* l, int V, int h, int w, int D, int H, float scale, int sites,
                      cudaStream_t s) {
  if (H != 8 || V < 1 || h < 1 || w < 1 || D % WA_G) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(V) * ((h + WA_TY - 1) / WA_TY) *
                          ((w + WA_TX - 1) / WA_TX);
  if (items > 0x7fffffffLL || static_cast<long long>(V) * h * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D / H) {
#define LFT_ATTN_CASE(DHV)                                                                  \
    case DHV: {                                                                             \
      auto kernel = spa_window_attn_sites_kernel<DHV, STATS>;                               \
      LFT_SET_SMEM(kernel, WA_BYTES);                                                       \
      kernel<<<static_cast<int>(items), WA_NT, WA_BYTES, s>>>(q, k, v, attn, m, l, V, h, w, \
                                                               scale, sites);               \
      break;                                                                                \
    }
    LFT_ATTN_CASE(4)
    LFT_ATTN_CASE(8)
    LFT_ATTN_CASE(16)
#undef LFT_ATTN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Step 3's site-subset instances (`--dtype mixed` under an LFT_MM_HP_SITES
// subset): lft_spa_window_attn's and lft_spa_window_attn_res's arguments
// and `sites`, the mask of the sites that round (tf32.cuh: S_SCORE, S_AV,
// and for the residual attn S_WO); m, l as `_res_bf16`'s.
extern "C" int lft_spa_window_attn_sites(const float* q, const float* k, const float* v,
                                         float* attn, int V, int h, int w, int D, int H,
                                         float scale, int sites, void* stream) {
  return window_attn_sites<false>(q, k, v, attn, nullptr, nullptr, V, h, w, D, H, scale, sites,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_window_attn_res_sites(const float* q, const float* k, const float* v,
                                             float* attn, float* m, float* l, int V, int h,
                                             int w, int D, int H, float scale, int sites,
                                             void* stream) {
  return window_attn_sites<true>(q, k, v, attn, m, l, V, h, w, D, H, scale, sites,
                                 static_cast<cudaStream_t>(stream));
}

// Step 3 also writing m, l [V, h, w, H] (the residuals of K3).
extern "C" int lft_spa_window_attn_res(const float* q, const float* k, const float* v,
                                       float* attn, float* m, float* l, int V, int h,
                                       int w, int D, int H, float scale, void* stream) {
  return window_attn<true>(q, k, v, attn, m, l, V, h, w, D, H, scale,
                           static_cast<cudaStream_t>(stream));
}

namespace {

// Step 4: Wo split (or its bf16 part, BF) into wf, then spa_outproj_ln_kernel.
template <class IO, bool BF = is_bf16<IO>>
int outproj_ln(const IO* attn, const IO* tok, const float* wo, const float* ln, float* wf,
               IO* x2, IO* xn2, int T, int C, cudaStream_t s) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  LFT_DISPATCH_C(C, {
    using L = RowProj<CC>;
    RgPieces ps{};
    ps.p[0] = RgPiece{wo, L::D, L::D, L::D, 0};
    launch_rg_weights(ps, 1, wf, s, BF);
    auto kernel = spa_outproj_ln_kernel<CC, IO, BF>;
    LFT_SET_SMEM(kernel, L::BYTES);
    kernel<<<rg_grid((T + RG_M - 1) / RG_M), RG_NT, L::BYTES, s>>>(attn, tok, wf, ln, x2, xn2,
                                                                    T);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Step 4: wf is a scratch of RowProj<C>::SQ floats (kernels/rowgemm.py:
// outproj_floats), Wo split into TF32 hi/lo by the launch's first kernel.
extern "C" int lft_spa_outproj_ln(const float* attn, const float* tok, const float* wo,
                                  const float* ln, float* wf, float* x2, float* xn2, int T,
                                  int C, void* stream) {
  return outproj_ln<float>(attn, tok, wo, ln, wf, x2, xn2, T, C,
                           static_cast<cudaStream_t>(stream));
}

// Step 4's bf16-operand instance (`--dtype mixed` serving under
// LFT_MM_HP_SITES=none): the same arguments, wf holding Wo's bf16 part.
extern "C" int lft_spa_outproj_ln_bf16(const float* attn, const float* tok, const float* wo,
                                       const float* ln, float* wf, float* x2, float* xn2, int T,
                                       int C, void* stream) {
  return outproj_ln<float, true>(attn, tok, wo, ln, wf, x2, xn2, T, C,
                                 static_cast<cudaStream_t>(stream));
}

// Step 4's bf16-IO instance: attn, tok, x2, xn2 bf16; wo, ln f32, wf holding
// Wo's bf16 part.
extern "C" int lft_spa_outproj_ln_bf16io(const bf16* attn, const bf16* tok, const float* wo,
                                         const float* ln, float* wf, bf16* x2, bf16* xn2, int T,
                                         int C, void* stream) {
  return outproj_ln<bf16>(attn, tok, wo, ln, wf, x2, xn2, T, C,
                          static_cast<cudaStream_t>(stream));
}

// Step 5: wf is a scratch of FfnOut<C>::FLOATS floats (kernels/rowgemm.py:
// ffn_out_floats), the weights split into TF32 hi/lo by the launch's first
// kernel.
extern "C" int lft_spa_ffn_out(const float* xn2, const float* x2, const float* w1,
                               const float* w2, const float* wlin, float* wf, float* out,
                               int T, int C, void* stream) {
  return ffn_out<false>(xn2, x2, w1, w2, wlin, wf, out, T, 1, 1, C,
                        static_cast<cudaStream_t>(stream));
}

// Step 5's bf16-operand instance (`--dtype mixed` serving under
// LFT_MM_HP_SITES=none): the same arguments, wf a scratch of
// FfnBf16<C>::ELEMS bf16 values (kernels/rowgemm.py:ffn_out_bf16_floats
// floats) for the weights rounded to bf16; its own kernel (ffn_bf16.cuh:
// resident bf16 weights, bf16 `wgmma`).
extern "C" int lft_spa_ffn_out_bf16(const float* xn2, const float* x2, const float* w1,
                                    const float* w2, const float* wlin, float* wf, float* out,
                                    int T, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  bf16* wb = reinterpret_cast<bf16*>(wf);
  LFT_DISPATCH_C(C, {
    return launch_ffn_bf16<CC, false>(xn2, x2, w1, w2, wlin, wb, out, T, 1, 1, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// Step 5's site-subset instance (`--dtype mixed` under an LFT_MM_HP_SITES
// subset): the same arguments and `sites`, the mask of the sites that round
// (tf32.cuh: S_FFN for W1 and W2, S_LIN for Wlin), exactly one of the two;
// its own kernels (ffn_sites.cuh), wf holding the weights as they read them.
extern "C" int lft_spa_ffn_out_sites(const float* xn2, const float* x2, const float* w1,
                                     const float* w2, const float* wlin, float* wf, float* out,
                                     int T, int C, int sites, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    return launch_ffn_sites<CC, false>(xn2, x2, w1, w2, wlin, wf, out, T, 1, 1, sites, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// Step 5's bf16-IO instance: xn2, x2, out bf16; the weights f32 (their bf16
// values), wf the scratch of lft_spa_ffn_out_bf16 for the weights rounded to
// bf16; its kernel is the `_bf16` instance's with bf16 rows (ffn_bf16.cuh).
extern "C" int lft_spa_ffn_out_bf16io(const bf16* xn2, const bf16* x2, const float* w1,
                                      const float* w2, const float* wlin, float* wf, bf16* out,
                                      int T, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  bf16* wb = reinterpret_cast<bf16*>(wf);
  LFT_DISPATCH_C(C, {
    return launch_ffn_bf16<CC, false, bf16>(xn2, x2, w1, w2, wlin, wb, out, T, 1, 1, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11's last step: xn2, x2 [Bb * A2, hw, D] view-major -> out [Bb, hw, A2, C]
// pixel-major.
extern "C" int lft_spa_ffn_out_pm(const float* xn2, const float* x2, const float* w1,
                                  const float* w2, const float* wlin, float* wf, float* out,
                                  int Bb, int hw, int A2, int C, void* stream) {
  if (Bb < 1 || A2 < 1 || hw < 1 || static_cast<long long>(Bb) * A2 * hw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return ffn_out<true>(xn2, x2, w1, w2, wlin, wf, out, Bb * A2 * hw, hw, A2, C,
                       static_cast<cudaStream_t>(stream));
}

// Its bf16-operand instance: the arguments of lft_spa_ffn_out_pm, wf the
// scratch of lft_spa_ffn_out_bf16, whose kernel it launches with the output
// pixel-major (so that K11 under the plan `none` is view-major K2's chain bit
// for bit).
extern "C" int lft_spa_ffn_out_pm_bf16(const float* xn2, const float* x2, const float* w1,
                                       const float* w2, const float* wlin, float* wf, float* out,
                                       int Bb, int hw, int A2, int C, void* stream) {
  if (Bb < 1 || A2 < 1 || hw < 1 || static_cast<long long>(Bb) * A2 * hw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  bf16* wb = reinterpret_cast<bf16*>(wf);
  LFT_DISPATCH_C(C, {
    return launch_ffn_bf16<CC, true>(xn2, x2, w1, w2, wlin, wb, out, Bb * A2 * hw, hw, A2, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// Its site-subset instance: as lft_spa_ffn_out_sites, launching its kernel
// with the output pixel-major (so that K11 under the subset is view-major
// K2's chain bit for bit).
extern "C" int lft_spa_ffn_out_pm_sites(const float* xn2, const float* x2, const float* w1,
                                        const float* w2, const float* wlin, float* wf,
                                        float* out, int Bb, int hw, int A2, int C, int sites,
                                        void* stream) {
  if (Bb < 1 || A2 < 1 || hw < 1 || static_cast<long long>(Bb) * A2 * hw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    return launch_ffn_sites<CC, true>(xn2, x2, w1, w2, wlin, wf, out, Bb * A2 * hw, hw, A2,
                                      sites, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// Its bf16-IO instance: as lft_spa_ffn_out_bf16io, out pixel-major (a (pixel,
// view) row of C bf16 values written as 4-byte pairs), so that K11 in bf16
// IO is view-major K2's chain bit for bit.
extern "C" int lft_spa_ffn_out_pm_bf16io(const bf16* xn2, const bf16* x2, const float* w1,
                                         const float* w2, const float* wlin, float* wf, bf16* out,
                                         int Bb, int hw, int A2, int C, void* stream) {
  if (Bb < 1 || A2 < 1 || hw < 1 || static_cast<long long>(Bb) * A2 * hw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  bf16* wb = reinterpret_cast<bf16*>(wf);
  LFT_DISPATCH_C(C, {
    return launch_ffn_bf16<CC, true, bf16>(xn2, x2, w1, w2, wlin, wb, out, Bb * A2 * hw, hw, A2,
                                           s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
