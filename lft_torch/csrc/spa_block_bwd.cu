// K3: the SpaTrans block's backward (reference model/LFT.py:118-191), as a
// fixed sequence of five hand-written kernels, the forward's steps (K2,
// spa_block.cu) in reverse.
//
// Replaces lft_tpu/kernels/spa_block.py:_spa_vjp_bwd / _bwd_kernel. From the
// block input x and the forward's residuals tok, (m, l) and attn:
//   a spa_ffn_out_bwd     recompute x2 = attn Wo + tok, xn2 = LN2(x2),
//                         hid = relu(xn2 W1), y = hid W2 + x2; then
//                         dy = dout Wlinᵀ, dpre = (hid > 0) dy W2ᵀ,
//                         dx2 = dy + LN2ᵀ(dpre W1ᵀ), dattn = dx2 Woᵀ
//   b spa_ln_qkv          recompute xn = LN1(tok + pe_tok), q, k, v: K2.2's
//                         kernel with an LN1 prologue (spa_block.cu,
//                         spa_qkv_kernel<C, true>), so they are the
//                         forward's bit for bit
//   c spa_window_attn_bwd dq, dk, dv from (q, k, v, m, l, dattn): K5's
//                         backward (spa_attn_hp.cu: pass q dq and D =
//                         sum_j p_j dp_j, pass kv dk and dv as a gather over
//                         the <= 25 queries whose 5x5 window holds a key);
//                         the saved attn is not read
//   d spa_qkv_ln_bwd      dxn = dq Wqᵀ + dk Wkᵀ, dtokpe = LN1ᵀ(dxn),
//                         dtok = dx2 + dv Wvᵀ + dtokpe (rowbwd.cuh: 3xTF32
//                         on the tensor cores, shared with K4's step c)
//   e spa_tokenize_bwd    dx = the 3x3 tokenization transposed, a gather
//                         over the 9 taps (tokenize.cuh: 3xTF32 on the
//                         tensor cores)
// Each writes the per-token operands of the weight gradients, and a and d
// their blocks' partial column sums of the LayerNorm affine grads;
// wgrad.cu reduces all of them, and dtokpe over the views (pe_tok's
// gradient, which reaches MLP.weight outside), in a fixed order.
//
// What changed from the TPU kernel: it scattered each query tile's dk/dv
// into padded halo accumulators and the 9 transposed taps into a padded
// dx, view by view, and accumulated every weight grad across its sequential
// grid. CUDA blocks run in parallel, so every scatter here is recast as a
// gather (each output element is written by exactly one thread) and every
// sum over tokens goes through the deterministic reductions: no atomics.
// Out-of-image keys are skipped exactly as spa_window_attn skips them.
// Steps a and b recompute x2, xn2 and xn, q, k, v with the forward's own
// arithmetic (K2.4's pass; K2.1's LN1 and K2.2's passes), so they equal
// the forward's bit for bit, and step c's scores from step b's q and k are
// K2.3's: the forward's (m, l) fit them exactly.
//
// Bound on this card: ~48 D^2 + 250 D FLOP a token in steps a-d without
// the weight grads (~84 GFLOP at [100, 32, 32, 64], 1.3 ms at 67 TFLOP/s
// FP32); the operand tensors add ~1.5 GB of traffic (~0.45 ms): operations.
// Steps a (21 D^2 of those), b and d (6 D^2 each) and e (14.5 GFLOP) run
// 3xTF32 on the tensor cores (rowgemm.cuh, rowbwd.cuh, tokenize.cuh); step
// c, a gather of 5x5 windows, on the FP32 pipes. This file holds steps a, d
// and e; b and c are launched from spa_block.cu and spa_attn_hp.cu.
//
// `--dtype mixed` (lft_tpu's backward plan `none`, the default: both
// operands of every product rounded to bf16, f32 accumulation,
// lft_tpu/kernels/spa_block.py:_bwd_kernel :430-557): each step has a BF
// instance, exported with `_bf16` after its name, whose products are one
// TF32 pass over the rounded operands (tf32.cuh, rowgemm.cuh, tokenize.cuh;
// the weights' bf16 parts in the same scratch layouts). What a step hands
// on stays f32; the next product rounds it as it loads it, as lft_tpu's
// casts round it at the site.
//
// `--dtype mixed` under an LFT_MM_HP_BWD_SITES subset (lft_tpu's
// _bwd_kernel with that plan): a step whose sites all round takes its
// `_bf16` instance, one whose sites all stay f32 its f32 one, and one whose
// products span sites the plan splits a `_sites` instance with the mask of
// the rounding sites (tf32.cuh: S_TOK ..), each product BF or 3xTF32 by its
// bit (rowgemm.cuh: rg_product_site), the weights split piece by piece
// (RgPiece::bf): a (x2 and dattn `wo`, the FFN's four `ffn`, dy `lin`), b
// (spa_block.cu, q and k `qk`, v `v`), c (spa_attn_hp.cu, `score` and
// `av`) and d (dq Wqᵀ, dk Wkᵀ `qk`, dv Wvᵀ `v`: rowbwd.cuh's phase mask).
// Step e computes `tok` alone. Bound: each product at the bf16 rate where
// its site rounds, as 3xTF32 where not; bytes as the f32 instance's.
//
// `--dtype bfloat16` training (lft_tpu's _bwd_kernel with io = bf16, every
// site's operands bf16, :427-568): each step has a bf16-IO instance,
// `_bf16io` after its name, its BF instance on bf16 rows (rowbwd.cuh:
// widened to f32 as loaded, rounded to nearest even as stored). What the
// steps hand on is bf16 where lft_tpu stores or casts it in io: x, tok,
// attn and dout in; a's dattn, y, dy, hid, dpre, xn2, b's xn, q, k, v, c's
// dq, dk, dv, d's dtok and e's dx out. dx2, dtokpe and the LN partial sums
// stay f32 (lft_tpu keeps dx2 = dtok's start and dtokpe in f32, :482,
// :552-556). The two roundings at each residual add are the forward's (K2.4,
// K2.5): x2 = bf16(bf16(attn Wo) + tok), y = bf16(bf16(hid W2) + x2).

#include "rowbwd.cuh"
#include "spa.cuh"
#include "tokenize.cuh"

using namespace lft;

namespace {

// ---- a: Token2SAI, FFN and LN2 backward ---------------------------------
// Replaces the FFN / Token2SAI / LN2 part of lft_tpu/kernels/spa_block.py:
// _bwd_kernel (:447-482, x2 recomputed from the saved attn). Its seven
// products run 3xTF32 on the tensor cores as row-tile products
// (rowgemm.cuh), in this order over a 128-row tile:
//   x2 = attn Wo + tok, xn2 = LN2(x2)       K2.4's pass arithmetic
//   per hidden chunk c (HC = 64 columns):
//     hid_c = relu(xn2 W1[:, c]);  y += hid_c W2[c, :]
//   y += x2;  dy = dout Wlinᵀ
//   per hidden chunk c:
//     dpre_c = (hid_c > 0) dy W2ᵀ[:, c];  dxn2 += dpre_c W1ᵀ[c, :]
//   dx2 = dy + LN2ᵀ(dxn2);  dattn = dx2 Woᵀ
// Bound: at [100, 32, 32, 64] (T = 102,400, D = 128) 21 D^2 = 344 kFLOP a
// token, 35.2 GFLOP: 0.2135 ms as 3 TF32 products at 495 TFLOP/s (0.526 on
// the FP32 pipes); its bytes (attn, tok, dout in; dx2, dattn, y, dy, xn2
// and the 2D-wide hid, dpre out: 1,472 floats a token) 0.180 ms at 3.35
// TB/s. So bound by operations, as K2.5 is. The design:
// * A persistent block of two warpgroups takes 128 rows a tile; each warp
//   owns 16 of them from its loads to its stores, so no warp waits for
//   another but at the two block barriers around a tile's LN2 sums.
// * The weights split (Wo, W1, W2, Wlinᵀ, W2ᵀ, W1ᵀ, Woᵀ: 1.38 MB at C = 64)
//   do not fit in shared memory; they are one stream, written by
//   rg_weights_kernel first in the launch (kernels/rowgemm.py:
//   ffn_out_bwd_stream), through MbarRing: with no block barrier a stage
//   the two warpgroups run up to PD stages apart (1.33x WeightRing's speed
//   here on an H100).
// * The 2D-wide products go in hidden chunks, as K2.5's do, so the hid and
//   dpre tiles are never held whole, and the forward's chunks (y) and the
//   backward's (dxn2) run as two loops: y and dxn2, each 64 floats a
//   thread, are never live together (both, beside a product's chain sets
//   and A fragments, would pass 255 registers). What the second loop needs
//   of hid is its sign: one bit an element, a word a thread and chunk (the
//   chunk's accumulator layout is the same in both loops), kept in shared
//   memory with the rows' LN2 mean and 1/std.
// * The products after x2's issue a chain's tail MMAs first (rg_product<...,
//   true>): dy = dout Wlinᵀ is one 16-deep chain at C = 16.
// * x2 and xn2 are recomputed with K2.4's own arithmetic (row_pass<C,
//   true>, spa_block.cu: the product, then + tok, then quad_ln), so they
//   equal the forward's bit for bit; quad_ln keeps each row's mean and
//   1/std for the LN2 backward. x2 is needed again (y's residual, xhat) but
//   its 64 KB tile would leave the ring 3 stages; it waits in the rows of
//   dx2's output instead (in L2) until dx2 replaces it.
// * Every output goes from the accumulators to the warp's rows in shared
//   memory and from there to device memory as whole 128-byte lines.
// * L2: the stream is re-read by every block each tile (132 x 1.38 MB a
//   round of tiles), while attn, tok, dout and the outputs pass through L2
//   once (5.9 KB a token). Loaded and stored with evict-first hints (.cs),
//   they leave the weights in L2: on an H100 the kernel took 1.8x the time
//   without the hints (a scratch A/B; hid, dpre and the other outputs
//   written normally evicted the stream, whose stages then came late).
// * LN2's backward runs on the dxn2 accumulators (row sums in a quad, as
//   quad_ln's), and the affine grads' partial sums are one row a 128-row
//   tile ([tiles, 2, D]): their number and the order of the colsum after
//   depend on T alone. Every output is written by one warp of one block,
//   no atomics: a call repeats bitwise.
template <int C>
struct FfnOutBwd {
  static constexpr int D = 2 * C;
  static constexpr int HC = 2 * D < 64 ? 2 * D : 64;   // hidden columns a chunk
  static constexpr int NH = 2 * D / HC;                 // chunks
  static constexpr int LDX = D + 4, LDH = HC + 4;       // row strides
  static constexpr int SQ = 2 * D * D;                  // floats of Wo (Woᵀ) split
  static constexpr int PC = 2 * D * HC;                 // floats of a chunk's piece
  static constexpr int ALIGN = 32 * (D > HC ? D : HC);  // a 16-of-K chain of any piece
  static constexpr int OFF_F = SQ;                      // W1[:, c], W2[c, :] a chunk
  static constexpr int OFF_LIN = OFF_F + NH * 2 * PC;   // Wlinᵀ
  static constexpr int OFF_B =                          // W2ᵀ[:, c], W1ᵀ[c, :] a chunk
      (OFF_LIN + 2 * C * D + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int OFF_OT = OFF_B + NH * 2 * PC;    // Woᵀ
  static constexpr int FLOATS = OFF_OT + SQ;            // the weight stream
  static constexpr int PIECES = 3 + 4 * NH;
  // rows, the LN2 sums [8 warps][2][D], the rows' LN2 mean and 1/std
  // [128][2], the ReLU signs [NH][256 threads]
  static constexpr int TILES = (RG_M * (LDX + LDH) + 8 * 2 * D + 2 * RG_M + NH * RG_NT) * 4;
  static constexpr int NS = rg_slots(TILES + 16 * 8);   // the ring and its 2 NS mbarriers
  static constexpr size_t BYTES = TILES + static_cast<size_t>(NS) * RG_SF * 4 + 2 * NS * 8;
  static_assert(RgParts<HC>::NP * RgParts<HC>::R == 32, "a chunk's ReLU signs fill one word");
  static_assert(BYTES <= RG_SMEM_MAX, "the rows and the ring must fit in shared memory");
};

// The forward's hidden chunk J and those after it: hid_c = relu(xn2 W1[:,
// c]) into hid_out and the warp's chunk rows, its signs into the thread's
// word on[J RG_NT] (bit i: the chunk accumulator's element i), y += hid_c
// W2[c, :]. SITES: both products BF where rf (the `ffn` site's bit).
template <int C, int J, bool BF, bool SITES = false, class Ring, class IO>
__device__ __forceinline__ void fwd_chunks(RgAcc<2 * C>& y, uint32_t* on, const float* xw,
                                           float* hw16,
                                           IO* __restrict__ hid_out, Ring& ring,
                                           const float*& st, int t0, int T, bool rf = false) {
  using F = FfnOutBwd<C>;
  constexpr int off = F::OFF_F + J * 2 * F::PC;
  RgAcc<F::HC> hc;
  rg_zero<F::HC>(hc);
  if constexpr (SITES)
    rg_product_site<F::D, F::HC, off, false, true, true>(rf, hc, xw, F::LDX, ring, st);
  else
    rg_product<F::D, F::HC, off, true, BF>(hc, xw, F::LDX, ring, st);
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < RgParts<F::HC>::R; ++i) {
    bits |= (hc[0][i] > 0.f ? 1u : 0u) << i;
    hc[0][i] = fmaxf(hc[0][i], 0.f);
  }
  on[J * RG_NT] = bits;
  put_tile<F::HC>(hc, hw16, F::LDH);
  store_rows<F::HC>(hw16, F::LDH, hid_out, 2 * F::D, J * F::HC, t0, T);
  if constexpr (SITES)
    rg_product_site<F::HC, F::D, off + F::PC, false, true, true>(rf, y, hw16, F::LDH, ring, st);
  else
    rg_product<F::HC, F::D, off + F::PC, true, BF>(y, hw16, F::LDH, ring, st);
  if constexpr (J + 1 < F::NH)
    fwd_chunks<C, J + 1, BF, SITES>(y, on, xw, hw16, hid_out, ring, st, t0, T, rf);
}

// The backward's hidden chunk J and those after it: dpre_c = (hid_c > 0)
// dy W2ᵀ[:, c] into dpre_out and the warp's chunk rows, dxn2 += dpre_c
// W1ᵀ[c, :]. SITES: both products BF where rf (the `ffn` site's bit).
template <int C, int J, bool BF, bool SITES = false, class Ring, class IO>
__device__ __forceinline__ void bwd_chunks(RgAcc<2 * C>& dxn, const uint32_t* on,
                                           const float* xw, float* hw16,
                                           IO* __restrict__ dpre_out, Ring& ring,
                                           const float*& st, int t0, int T, bool rf = false) {
  using F = FfnOutBwd<C>;
  constexpr int off = F::OFF_B + J * 2 * F::PC;
  RgAcc<F::HC> dp;
  rg_zero<F::HC>(dp);
  if constexpr (SITES)
    rg_product_site<F::D, F::HC, off, false, true, true>(rf, dp, xw, F::LDX, ring, st);
  else
    rg_product<F::D, F::HC, off, true, BF>(dp, xw, F::LDX, ring, st);
  const uint32_t bits = on[J * RG_NT];
#pragma unroll
  for (int i = 0; i < RgParts<F::HC>::R; ++i)
    if (!((bits >> i) & 1u)) dp[0][i] = 0.f;
  put_tile<F::HC>(dp, hw16, F::LDH);
  store_rows<F::HC>(hw16, F::LDH, dpre_out, 2 * F::D, J * F::HC, t0, T);
  if constexpr (SITES)
    rg_product_site<F::HC, F::D, off + F::PC, false, true, true>(rf, dxn, hw16, F::LDH, ring,
                                                                 st);
  else
    rg_product<F::HC, F::D, off + F::PC, true, BF>(dxn, hw16, F::LDH, ring, st);
  if constexpr (J + 1 < F::NH)
    bwd_chunks<C, J + 1, BF, SITES>(dxn, on, xw, hw16, dpre_out, ring, st, t0, T, rf);
}

// wf: the weight stream (FfnOutBwd::FLOATS floats, kernels/rowgemm.py:
// ffn_out_bwd_stream), written by rg_weights_kernel. ln_part [tiles, 2, D].
// BF: the products over bf16-rounded operands (the weights' bf16 parts).
// IO = bf16 (with BF): attn, tok, dout and the outputs but dx2 and ln_part
// bf16; x2 and y rounded twice, as the forward rounds them. SITES (with IO
// = float, BF = false: `spa_ffn_out_bwd_sites`): each product BF where its
// site's bit of `sites` is set (x2 and dattn `wo`, the FFN's four `ffn`,
// dy `lin`), 3xTF32 elsewhere.
template <int C, bool BF = false, class IO = float, bool SITES = false>
__global__ void __launch_bounds__(RG_NT, 1)
    spa_ffn_out_bwd_kernel(const IO* __restrict__ attn, const IO* __restrict__ tok,
                           const IO* __restrict__ dout, const float* __restrict__ ln,
                           const float* __restrict__ wf, float* dx2_out,
                           IO* __restrict__ dattn_out, IO* __restrict__ y_out,
                           IO* __restrict__ dy_out, IO* __restrict__ hid_out,
                           IO* __restrict__ dpre_out, IO* __restrict__ xn2_out,
                           float* __restrict__ ln_part, int T, int sites) {
  static_assert(!SITES || (!BF && !is_bf16<IO>), "a `_sites` instance is f32 IO with its own mask");
  using F = FfnOutBwd<C>;
  using P = RgParts<F::D>;
  constexpr int D = F::D, LDX = F::LDX, LDH = F::LDH;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xw = smem + 16 * warp * LDX;                   // the warp's rows: attn, xn2, dy, dx2
  float* hw16 = smem + RG_M * LDX + 16 * warp * LDH;    // dout, then a hidden chunk
  float* part = smem + RG_M * (LDX + LDH);              // [8 warps][2][D] LN2 sums
  float* stats = part + 8 * 2 * D + 32 * warp;          // the warp's rows' mean, 1/std
  uint32_t* on = reinterpret_cast<uint32_t*>(part + 8 * 2 * D + 2 * RG_M) + threadIdx.x;
  const float* g2 = ln + 2 * D;                         // LN2's weight
  const int tiles = (T + RG_M - 1) / RG_M;
  float* slots = reinterpret_cast<float*>(on - threadIdx.x) + F::NH * RG_NT;
  MbarRing<F::NS> ring;
  ring.start(slots, reinterpret_cast<uint64_t*>(slots + F::NS * RG_SF), wf, F::FLOATS,
             (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x);
  const float* st = nullptr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;   // the warp's first token
    warp_rows<D>(xw, LDX, attn, t0, T);

    // x2 = attn Wo + tok (tok added to the finished product), xn2 = LN2(x2)
    RgAcc<D> a;
    rg_zero<D>(a);
    if constexpr (SITES)
      rg_product_site<D, D, 0, false, true>((sites & S_WO) != 0, a, xw, LDX, ring, st);
    else
      rg_product<D, D, 0, false, BF>(a, xw, LDX, ring, st);
    rg_pairs<D>(a, [&](int r, int c, float& v0, float& v1) {
      if (t0 + r < T) {
        const float2 t = ldcs2(tok + static_cast<size_t>(t0 + r) * D + c);
        v0 = io_round<IO>(io_round<IO>(v0) + t.x);
        v1 = io_round<IO>(io_round<IO>(v1) + t.y);
      }
    });
    put_tile<D>(a, xw, LDX);   // attn is read
    store_rows<D, true>(xw, LDX, dx2_out, D, 0, t0, T);   // x2, until dx2 replaces it
    {
      float mu[2], rstd[2];
      quad_ln<D, true>(a, g2, ln + 3 * D, mu, rstd);
      if ((lane & 3) == 0) {
        const int g = lane >> 2;
        *reinterpret_cast<float2*>(stats + 2 * g) = make_float2(mu[0], rstd[0]);
        *reinterpret_cast<float2*>(stats + 2 * g + 16) = make_float2(mu[1], rstd[1]);
      }
    }
    put_tile<D>(a, xw, LDX);
    store_rows<D>(xw, LDX, xn2_out, D, 0, t0, T);

    // hid = relu(xn2 W1) and y = hid W2 + x2, a hidden chunk at a time;
    // on[j RG_NT] keeps the chunk's ReLU signs
    {
      RgAcc<D> y;
      rg_zero<D>(y);
      fwd_chunks<C, 0, BF, SITES>(y, on, xw, hw16, hid_out, ring, st, t0, T,
                                  (sites & S_FFN) != 0);
      rg_pairs<D>(y, [&](int r, int c, float& v0, float& v1) {
        if (t0 + r < T) {
          const float2 x2 =
              *reinterpret_cast<const float2*>(dx2_out + static_cast<size_t>(t0 + r) * D + c);
          v0 = io_round<IO>(io_round<IO>(v0) + x2.x);
          v1 = io_round<IO>(io_round<IO>(v1) + x2.y);
        }
      });
      put_tile<D>(y, xw, LDX);   // xn2 is read
      store_rows<D>(xw, LDX, y_out, D, 0, t0, T);
    }

    // dy = dout Wlinᵀ, kept in the warp's rows (xn2 is read)
    {
      warp_rows<C>(hw16, LDH, dout, t0, T);
      RgAcc<D> dy;
      rg_zero<D>(dy);
      if constexpr (SITES)
        rg_product_site<C, D, F::OFF_LIN, false, true, true>((sites & S_LIN) != 0, dy, hw16, LDH,
                                                             ring, st);
      else
        rg_product<C, D, F::OFF_LIN, true, BF>(dy, hw16, LDH, ring, st);
      put_tile<D>(dy, xw, LDX);
      store_rows<D>(xw, LDX, dy_out, D, 0, t0, T);
    }

    // dpre = (hid > 0) dy W2ᵀ and dxn2 = dpre W1ᵀ, a hidden chunk at a time
    RgAcc<D> dxn;
    rg_zero<D>(dxn);
    bwd_chunks<C, 0, BF, SITES>(dxn, on, xw, hw16, dpre_out, ring, st, t0, T,
                                (sites & S_FFN) != 0);

    // LN2 backward on the accumulators: xhat = (x2 - mu) rstd as the
    // forward made it (zero on rows past T, whose dxn2 is zero too)
    RgAcc<D> xh;
    float mu[2], rstd[2];
    {
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 ms = *reinterpret_cast<const float2*>(stats + 2 * g + 16 * h);
        mu[h] = ms.x;
        rstd[h] = ms.y;
        const bool in = t0 + g + 8 * h < T;
        const float* row = dx2_out + static_cast<size_t>(in ? t0 + g + 8 * h : 0) * D + 2 * q;
#pragma unroll
        for (int p = 0; p < P::NP; ++p)
#pragma unroll
          for (int jj = 0; jj < P::NW / 8; ++jj) {
            const float2 x2 = in ? *reinterpret_cast<const float2*>(row + p * P::NW + 8 * jj)
                                 : make_float2(mu[h], mu[h]);
            xh[p][4 * jj + 2 * h] = (x2.x - mu[h]) * rstd[h];
            xh[p][4 * jj + 2 * h + 1] = (x2.y - mu[h]) * rstd[h];
          }
      }
    }
    // the affine grads' column sums over the warp's 16 rows: sum dxn2 xhat,
    // sum dxn2; rows g and g + 8 in a thread, then the 8 lanes of a column
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int jj = 0; jj < P::NW / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i0 = 4 * jj + e, i1 = 4 * jj + 2 + e;
          float sw = fmaf(dxn[p][i1], xh[p][i1], dxn[p][i0] * xh[p][i0]);
          float sb = dxn[p][i0] + dxn[p][i1];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            sw += __shfl_xor_sync(0xffffffffu, sw, o);
            sb += __shfl_xor_sync(0xffffffffu, sb, o);
          }
          if (lane < 4) {
            const int c = p * P::NW + 8 * jj + 2 * lane + e;
            part[(warp * 2) * D + c] = sw;
            part[(warp * 2 + 1) * D + c] = sb;
          }
        }
    // dx2 = dy + rstd (dxh - mean(dxh) - xhat mean(dxh xhat)), dxh = dxn2 g2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sa = 0.f, sx = 0.f;
#pragma unroll
      for (int p = 0; p < P::NP; ++p)
#pragma unroll
        for (int jj = 0; jj < P::NW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * h + e;
            const float dxh = dxn[p][i] * __ldg(g2 + p * P::NW + 8 * jj + 2 * (lane & 3) + e);
            dxn[p][i] = dxh;
            sa += dxh;
            sx = fmaf(dxh, xh[p][i], sx);
          }
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      sx += __shfl_xor_sync(0xffffffffu, sx, 1);
      sx += __shfl_xor_sync(0xffffffffu, sx, 2);
      sa /= D;
      sx /= D;
#pragma unroll
      for (int p = 0; p < P::NP; ++p)
#pragma unroll
        for (int jj = 0; jj < P::NW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * h + e;
            dxn[p][i] = rstd[h] * (dxn[p][i] - sa - xh[p][i] * sx);
          }
    }
    rg_pairs<D>(dxn, [&](int r, int c, float& v0, float& v1) {
      const float2 dy = *reinterpret_cast<const float2*>(xw + r * LDX + c);
      v0 += dy.x;
      v1 += dy.y;
    });
    put_tile<D>(dxn, xw, LDX);
    store_rows<D>(xw, LDX, dx2_out, D, 0, t0, T);

    // dattn = dx2 Woᵀ
    RgAcc<D> da;
    rg_zero<D>(da);
    if constexpr (SITES)
      rg_product_site<D, D, F::OFF_OT, false, true, true>((sites & S_WO) != 0, da, xw, LDX, ring,
                                                          st);
    else
      rg_product<D, D, F::OFF_OT, true, BF>(da, xw, LDX, ring, st);
    put_tile<D>(da, xw, LDX);   // dx2 is read
    store_rows<D>(xw, LDX, dattn_out, D, 0, t0, T);

    // the tile's LN2 sums: the 8 warps' in order, one row [2, D] a tile
    // (the ring has no block barrier: one on each side of the reads)
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * D; i += RG_NT) {
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < 8; ++wp) s += part[wp * 2 * D + i];
      ln_part[static_cast<size_t>(tile) * 2 * D + i] = s;
    }
    __syncthreads();
  }
}

// ---- b: recompute xn = LN1(tok + pe_tok), q, k, v -------------------------
// spa_qkv_kernel<C, true> (spa_block.cu, lft_spa_ln_qkv).

// ---- c: 5x5-window attention backward --------------------------------------
// spa_attn_hp_bwd_q_kernel<DH> and spa_attn_hp_bwd_kv_kernel<DH>
// (spa_attn_hp.cu, lft_spa_attn_hp_bwd) with dout = dattn.

// ---- d: projections and LN1 backward ---------------------------------------
// qkv_ln_bwd_kernel<D> (rowbwd.cuh), with pe_tok indexed t % hw and dtokpe.

// ---- e: tokenization backward, a gather over the 9 taps -------------------
// The forward's tok[t] = sum_tap x[t + s_tap] Wu[tap] (s_tap = (ky-1, kx-1)
// inside the image) gives dx[u] = sum_tap dtok[u - s_tap] Wu[tap]ᵀ = sum_tap
// dtok[u + s_tap] Wu[8 - tap]ᵀ: tap_conv_kernel<D, C, false, false>
// (tokenize.cuh) with the mirrored, transposed taps.

}  // namespace

LFT_EXPORT_ERROR_STRING

// Token tensors are [T, *] in [V, h, w] order (T = V h w), weights "x @ W"
// layouts as in spa_block.cu, "...T" their transposes: wlinT [C, D], w2T
// [D, 2D], w1T [2D, D], woT [D, D]. ln [4, D] is (LN1 w, b, LN2 w, b).
// Each returns the launch's cudaGetLastError(), or cudaErrorInvalidValue
// for a shape it does not take (C in {16, 32, 64}).

namespace {

// SITES: the `_sites` instance, each weight piece split as its site's bit
// of `sites` says (Wo, Woᵀ `wo`; Wlinᵀ `lin`; the FFN's `ffn`).
template <bool BF, class IO = float, bool SITES = false>
int ffn_out_bwd(const named_t<IO>* attn, const named_t<IO>* tok, const named_t<IO>* dout,
                const float* ln, const float* wo, const float* w1, const float* w2,
                const float* wlinT, const float* w2T, const float* w1T, const float* woT,
                float* wf, float* dx2, named_t<IO>* dattn, named_t<IO>* y, named_t<IO>* dy,
                named_t<IO>* hid, named_t<IO>* dpre, named_t<IO>* xn2, float* ln_part, int T,
                int C, cudaStream_t s, int sites = 0) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  LFT_DISPATCH_C(C, {
    using F = FfnOutBwd<CC>;
    RgPiece all[F::PIECES];
    int n = 0;
    all[n++] = RgPiece{wo, F::D, F::D, F::D, 0};
    for (int j = 0; j < F::NH; ++j) {
      const int off = F::OFF_F + j * 2 * F::PC;
      all[n++] = RgPiece{w1 + j * F::HC, 2 * F::D, F::D, F::HC, off};
      all[n++] = RgPiece{w2 + static_cast<size_t>(j) * F::HC * F::D, F::D, F::HC, F::D,
                         off + F::PC};
    }
    all[n++] = RgPiece{wlinT, F::D, CC, F::D, F::OFF_LIN};
    for (int j = 0; j < F::NH; ++j) {
      const int off = F::OFF_B + j * 2 * F::PC;
      all[n++] = RgPiece{w2T + j * F::HC, 2 * F::D, F::D, F::HC, off};
      all[n++] = RgPiece{w1T + static_cast<size_t>(j) * F::HC * F::D, F::D, F::HC, F::D,
                         off + F::PC};
    }
    all[n++] = RgPiece{woT, F::D, F::D, F::D, F::OFF_OT};
    if constexpr (SITES)
      for (int i = 0; i < n; ++i)
        all[i].bf = (sites & (i == 0 || i == n - 1 ? S_WO : i == 1 + 2 * F::NH ? S_LIN
                                                                               : S_FFN)) != 0;
    launch_rg_pieces(all, n, wf, s, BF, SITES);
    auto kernel = spa_ffn_out_bwd_kernel<CC, BF, IO, SITES>;
    LFT_SET_SMEM(kernel, F::BYTES);
    kernel<<<rg_grid((T + RG_M - 1) / RG_M), RG_NT, F::BYTES, s>>>(
        attn, tok, dout, ln, wf, dx2, dattn, y, dy, hid, dpre, xn2, ln_part, T, sites);
  });
  return static_cast<int>(cudaGetLastError());
}

// SITES: the `_sites` instance, dq Wqᵀ and dk Wkᵀ BF where `qk` rounds, dv
// Wvᵀ where `v` does (rowbwd.cuh's phase mask rb).
template <bool BF, class IO = float, bool SITES = false>
int qkv_ln_bwd(const named_t<IO>* tok, const float* pe_tok, const named_t<IO>* dq,
               const named_t<IO>* dk, const named_t<IO>* dv, const float* dx2, const float* ln,
               const float* wqk, const float* wv, float* wf, named_t<IO>* dtok, float* dtokpe,
               float* ln_part, int T, int hw, int C, cudaStream_t s, int sites = 0) {
  if (T < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  LFT_DISPATCH_C(C, {
    constexpr int D = 2 * CC;
    const QkvLnBwdArgs<IO> a{tok, pe_tok, dq, dk, dv, dx2, ln, nullptr, dtok, dtokpe,
                             ln_part, hw, 2 * D, T};
    if constexpr (SITES)
      return launch_qkv_ln_bwd<D, false, float, true>(
          a, wqk, wqk + D, 2 * D, wv, wf, s, (sites & S_QK ? 3 : 0) | (sites & S_V ? 4 : 0));
    return launch_qkv_ln_bwd<D, BF, IO>(a, wqk, wqk + D, 2 * D, wv, wf, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool BF, class IO = float>
int tokenize_bwd(const named_t<IO>* dtok, const float* wu, float* wf, named_t<IO>* dx, int T,
                 int h, int w, int C, int r, int cw, cudaStream_t s) {
  if (h < 1 || w < 1 || T < 1 || T % (h * w)) return static_cast<int>(cudaErrorInvalidValue);
  LFT_DISPATCH_C(C, {
    return launch_tap_conv<2 * CC, CC, false, false, true, BF, IO>(
        dtok, wu, wf, nullptr, nullptr, dx, nullptr, T / (h * w), h, w, 1, r, cw, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Step a: wf is a scratch of FfnOutBwd<C>::FLOATS floats (kernels/rowgemm.py:
// ffn_out_bwd_floats), the weights split into TF32 hi/lo by the launch's
// first kernels; ln_part [ceil(T / 128), 2, D].
extern "C" int lft_spa_ffn_out_bwd(const float* attn, const float* tok, const float* dout,
                                   const float* ln, const float* wo, const float* w1,
                                   const float* w2, const float* wlinT, const float* w2T,
                                   const float* w1T, const float* woT, float* wf, float* dx2,
                                   float* dattn, float* y, float* dy, float* hid,
                                   float* dpre, float* xn2, float* ln_part, int T, int C,
                                   void* stream) {
  return ffn_out_bwd<false>(attn, tok, dout, ln, wo, w1, w2, wlinT, w2T, w1T, woT, wf, dx2,
                            dattn, y, dy, hid, dpre, xn2, ln_part, T, C,
                            static_cast<cudaStream_t>(stream));
}

// Step d: wqk [D, 2D] and wv [D, D] as the forward takes them (read
// transposed by the launch's first kernel into the scratch wf of
// QkvLnBwd<D>::FLOATS floats, kernels/rowgemm.py:qkv_ln_bwd_floats);
// ln_part [ceil(T / 128), 2, D].
extern "C" int lft_spa_qkv_ln_bwd(const float* tok, const float* pe_tok, const float* dq,
                                  const float* dk, const float* dv, const float* dx2,
                                  const float* ln, const float* wqk, const float* wv, float* wf,
                                  float* dtok, float* dtokpe, float* ln_part, int T, int hw,
                                  int C, void* stream) {
  return qkv_ln_bwd<false>(tok, pe_tok, dq, dk, dv, dx2, ln, wqk, wv, wf, dtok, dtokpe,
                           ln_part, T, hw, C, static_cast<cudaStream_t>(stream));
}

// dtok [T, D] -> dx [T, C], T = V h w; wu [9, C, D]; wf scratch of 18 C D
// floats (wu[8 - tap]ᵀ split into TF32 hi/lo, kernels/spa_block.py:
// tap_weights(wu, backward=True)); a block takes r x cw pixels of a view
// (tok_tile).
extern "C" int lft_spa_tokenize_bwd(const float* dtok, const float* wu, float* wf, float* dx,
                                    int T, int h, int w, int C, int r, int cw, void* stream) {
  return tokenize_bwd<false>(dtok, wu, wf, dx, T, h, w, C, r, cw,
                             static_cast<cudaStream_t>(stream));
}

// The steps' bf16-operand instances under `--dtype mixed` (the header): the
// same arguments, each wf holding the weights' bf16 parts in its layout.
extern "C" int lft_spa_ffn_out_bwd_bf16(const float* attn, const float* tok, const float* dout,
                                        const float* ln, const float* wo, const float* w1,
                                        const float* w2, const float* wlinT, const float* w2T,
                                        const float* w1T, const float* woT, float* wf,
                                        float* dx2, float* dattn, float* y, float* dy,
                                        float* hid, float* dpre, float* xn2, float* ln_part,
                                        int T, int C, void* stream) {
  return ffn_out_bwd<true>(attn, tok, dout, ln, wo, w1, w2, wlinT, w2T, w1T, woT, wf, dx2,
                           dattn, y, dy, hid, dpre, xn2, ln_part, T, C,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_qkv_ln_bwd_bf16(const float* tok, const float* pe_tok, const float* dq,
                                       const float* dk, const float* dv, const float* dx2,
                                       const float* ln, const float* wqk, const float* wv,
                                       float* wf, float* dtok, float* dtokpe, float* ln_part,
                                       int T, int hw, int C, void* stream) {
  return qkv_ln_bwd<true>(tok, pe_tok, dq, dk, dv, dx2, ln, wqk, wv, wf, dtok, dtokpe,
                          ln_part, T, hw, C, static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_tokenize_bwd_bf16(const float* dtok, const float* wu, float* wf,
                                         float* dx, int T, int h, int w, int C, int r, int cw,
                                         void* stream) {
  return tokenize_bwd<true>(dtok, wu, wf, dx, T, h, w, C, r, cw,
                            static_cast<cudaStream_t>(stream));
}

// The site-subset instances of steps a and d (`--dtype mixed` under an
// LFT_MM_HP_BWD_SITES subset; the header): the f32 instances' arguments and
// `sites`, the mask of the sites whose operands round (tf32.cuh: S_TOK ..),
// each wf holding every weight split as its site's products read it. Step
// a: Wo, Woᵀ by `wo`, the FFN's by `ffn`, Wlinᵀ by `lin`; step d: Wqᵀ, Wkᵀ
// by `qk`, Wvᵀ by `v`. Step e computes one site (`tok`) and takes its f32
// or `_bf16` instance whole.
extern "C" int lft_spa_ffn_out_bwd_sites(const float* attn, const float* tok, const float* dout,
                                         const float* ln, const float* wo, const float* w1,
                                         const float* w2, const float* wlinT, const float* w2T,
                                         const float* w1T, const float* woT, float* wf,
                                         float* dx2, float* dattn, float* y, float* dy,
                                         float* hid, float* dpre, float* xn2, float* ln_part,
                                         int T, int C, int sites, void* stream) {
  return ffn_out_bwd<false, float, true>(attn, tok, dout, ln, wo, w1, w2, wlinT, w2T, w1T, woT,
                                         wf, dx2, dattn, y, dy, hid, dpre, xn2, ln_part, T, C,
                                         static_cast<cudaStream_t>(stream), sites);
}

extern "C" int lft_spa_qkv_ln_bwd_sites(const float* tok, const float* pe_tok, const float* dq,
                                        const float* dk, const float* dv, const float* dx2,
                                        const float* ln, const float* wqk, const float* wv,
                                        float* wf, float* dtok, float* dtokpe, float* ln_part,
                                        int T, int hw, int C, int sites, void* stream) {
  return qkv_ln_bwd<false, float, true>(tok, pe_tok, dq, dk, dv, dx2, ln, wqk, wv, wf, dtok,
                                        dtokpe, ln_part, T, hw, C,
                                        static_cast<cudaStream_t>(stream), sites);
}

// The steps' bf16-IO instances (`--dtype bfloat16` training, the header):
// the BF instances on bf16 activations. Step a: attn, tok, dout bf16; dx2
// and ln_part f32, dattn, y, dy, hid, dpre, xn2 bf16. Step d: tok, dq, dk,
// dv and dtok bf16; pe_tok (its bf16 values), dx2, dtokpe and ln_part f32.
// Step e: dtok and dx bf16. The weights f32 (their bf16 values), each wf
// holding their bf16 parts.
extern "C" int lft_spa_ffn_out_bwd_bf16io(const bf16* attn, const bf16* tok, const bf16* dout,
                                          const float* ln, const float* wo, const float* w1,
                                          const float* w2, const float* wlinT,
                                          const float* w2T, const float* w1T, const float* woT,
                                          float* wf, float* dx2, bf16* dattn, bf16* y, bf16* dy,
                                          bf16* hid, bf16* dpre, bf16* xn2, float* ln_part,
                                          int T, int C, void* stream) {
  return ffn_out_bwd<true, bf16>(attn, tok, dout, ln, wo, w1, w2, wlinT, w2T, w1T, woT, wf,
                                 dx2, dattn, y, dy, hid, dpre, xn2, ln_part, T, C,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_qkv_ln_bwd_bf16io(const bf16* tok, const float* pe_tok, const bf16* dq,
                                         const bf16* dk, const bf16* dv, const float* dx2,
                                         const float* ln, const float* wqk, const float* wv,
                                         float* wf, bf16* dtok, float* dtokpe, float* ln_part,
                                         int T, int hw, int C, void* stream) {
  return qkv_ln_bwd<true, bf16>(tok, pe_tok, dq, dk, dv, dx2, ln, wqk, wv, wf, dtok, dtokpe,
                                ln_part, T, hw, C, static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_tokenize_bwd_bf16io(const bf16* dtok, const float* wu, float* wf,
                                           bf16* dx, int T, int h, int w, int C, int r, int cw,
                                           void* stream) {
  return tokenize_bwd<true, bf16>(dtok, wu, wf, dx, T, h, w, C, r, cw,
                                  static_cast<cudaStream_t>(stream));
}
