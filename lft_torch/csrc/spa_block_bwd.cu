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
//   b spa_ln_qkv          recompute xn = LN1(tok + pe_tok), q, k, v
//   c spa_window_attn_bwd dq per query over its window; dk, dv per key as a
//                         GATHER over the <= 25 queries whose 5x5 window
//                         holds it (the window is symmetric), with
//                         dsum_i = dattn_i . attn_i
//   d spa_qkv_ln_bwd      dxn = dq Wqᵀ + dk Wkᵀ, dtokpe = LN1ᵀ(dxn),
//                         dtok = dx2 + dv Wvᵀ + dtokpe
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
// Out-of-image keys are skipped exactly as spa_window_attn skips them. The
// recomputed q, k and x2 are bit-identical to the forward's (same tile
// code), so p = exp(s - m) / l uses the forward's own scores.
//
// Bound on this card: ~48 D^2 + 250 D FLOP a token in steps a-d without
// the weight grads (~84 GFLOP at [100, 32, 32, 64], 1.3 ms at 67 TFLOP/s
// FP32); the operand tensors add ~1.5 GB of traffic (~0.45 ms): operations.
// Step e (14.5 GFLOP) runs 3xTF32 on the tensor cores (tokenize.cuh).

#include "bwd.cuh"
#include "spa.cuh"
#include "tokenize.cuh"

using namespace lft;

namespace {

// ---- a: Token2SAI, FFN and LN2 backward ---------------------------------
template <int C>
__global__ void __launch_bounds__(NT)
    spa_ffn_out_bwd_kernel(const float* __restrict__ attn, const float* __restrict__ tok,
                           const float* __restrict__ dout, const float* __restrict__ ln,
                           const float* __restrict__ wo, const float* __restrict__ w1,
                           const float* __restrict__ w2, const float* __restrict__ wlinT,
                           const float* __restrict__ w2T, const float* __restrict__ w1T,
                           const float* __restrict__ woT, float* __restrict__ dx2_out,
                           float* __restrict__ dattn_out, float* __restrict__ y_out,
                           float* __restrict__ dy_out, float* __restrict__ hid_out,
                           float* __restrict__ dpre_out, float* __restrict__ xn2_out,
                           float* __restrict__ ln_part, int T) {
  using S = Spa<C>;
  constexpr int D = S::D, LDC = S::LDC, LDD = S::LDD, LDH = S::LDH;
  using LN = RowLN<D>;
  extern __shared__ float4 smem4[];
  float* AT = reinterpret_cast<float*>(smem4);   // attn -> dxn2
  float* X2 = AT + BM * LDD;                      // x2 -> dx2
  float* XN = X2 + BM * LDD;                      // xn2 -> dy
  float* HD = XN + BM * LDD;                      // [BM][LDH] hid -> dpre
  float* DO = HD + BM * LDH;                      // [BM][LDC] dout
  float* MU = DO + BM * LDC;
  float* RS = MU + BM;
  float* WP = RS + BM;                            // [8][2][D]
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * BM;
  const int nr = min(BM, T - t0);
  auto gl = [&](float* p, int r, int c, int W) { return p + static_cast<size_t>(t0 + r) * W + c; };

  load_rows<D>(AT, LDD, attn, t0, T);
  load_rows<C>(DO, LDC, dout, t0, T);
  __syncthreads();
  {  // x2 = attn Wo + tok
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, D, D>(acc, AT, LDD, wo);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 v) {
      const float4 tv = r < nr ? ldg4(tok + static_cast<size_t>(t0 + r) * D + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(X2 + r * LDD + c, add4(v, tv));
    });
  }
  __syncthreads();
  for (int r = warp; r < BM; r += NT / 32) {  // xn2 = LN2(x2) and its statistics
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) v[e] = X2[r * LDD + LN::col(e)];
    float mu, rstd;
    ln_stats<D>(v, mu, rstd);
    if ((threadIdx.x & 31) == 0) {
      MU[r] = mu;
      RS[r] = rstd;
    }
    LN::apply(v, ln + 2 * D, ln + 3 * D);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        XN[r * LDD + LN::col(e)] = v[e];
        if (r < nr) *gl(xn2_out, r, LN::col(e), D) = v[e];
      }
  }
  __syncthreads();
  {  // hid = relu(xn2 W1)
    Acc<BM, 2 * D> acc;
    zero_acc<BM, 2 * D>(acc);
    gemm_acc<BM, D, 2 * D>(acc, XN, LDD, w1);
    for_tiles<BM, 2 * D>(acc, [&](int r, int c, float4 v) {
      v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      store4(HD + r * LDH + c, v);
      if (r < nr) store4(gl(hid_out, r, c, 2 * D), v);
    });
  }
  __syncthreads();
  {  // y = hid W2 + x2 (the Token2SAI operand); dy = dout Wlinᵀ over xn2
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, 2 * D, D>(acc, HD, LDH, w2);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 v) {
      if (r < nr) store4(gl(y_out, r, c, D), add4(v, load4(X2 + r * LDD + c)));
    });
    zero_acc<BM, D>(acc);
    gemm_acc<BM, C, D>(acc, DO, LDC, wlinT);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 v) {
      store4(XN + r * LDD + c, v);
      if (r < nr) store4(gl(dy_out, r, c, D), v);
    });
  }
  __syncthreads();
  {  // dpre = (hid > 0) dy W2ᵀ, in place over hid
    Acc<BM, 2 * D> acc;
    zero_acc<BM, 2 * D>(acc);
    gemm_acc<BM, D, 2 * D>(acc, XN, LDD, w2T);
    for_tiles<BM, 2 * D>(acc, [&](int r, int c, float4 v) {
      const float4 hv = load4(HD + r * LDH + c);
      v = make_float4(hv.x > 0.f ? v.x : 0.f, hv.y > 0.f ? v.y : 0.f,
                      hv.z > 0.f ? v.z : 0.f, hv.w > 0.f ? v.w : 0.f);
      store4(HD + r * LDH + c, v);
      if (r < nr) store4(gl(dpre_out, r, c, 2 * D), v);
    });
  }
  __syncthreads();
  {  // dxn2 = dpre W1ᵀ over attn
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, 2 * D, D>(acc, HD, LDH, w1T);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 v) { store4(AT + r * LDD + c, v); });
  }
  __syncthreads();
  LnGradAcc<D> g2;
  g2.zero();
  for (int r = warp; r < nr; r += NT / 32) {  // dx2 = dy + LN2ᵀ(dxn2), over x2
    float xh[LN::E] = {}, d[LN::E] = {};
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        xh[e] = (X2[r * LDD + LN::col(e)] - MU[r]) * RS[r];
        d[e] = AT[r * LDD + LN::col(e)];
      }
    g2.add(d, xh);
    ln_bwd<D>(d, xh, RS[r], ln + 2 * D);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        const float v = XN[r * LDD + LN::col(e)] + d[e];
        X2[r * LDD + LN::col(e)] = v;
        *gl(dx2_out, r, LN::col(e), D) = v;
      }
  }
  g2.flush(WP, 2, 0);
  __syncthreads();
  {  // dattn = dx2 Woᵀ
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, D, D>(acc, X2, LDD, woT);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 v) {
      if (r < nr) store4(gl(dattn_out, r, c, D), v);
    });
  }
  block_colsum(WP, 2 * D, ln_part + static_cast<size_t>(blockIdx.x) * 2 * D);
}

// ---- b: recompute xn = LN1(tok + pe_tok), q, k, v -------------------------
template <int C>
__global__ void __launch_bounds__(NT)
    spa_ln_qkv_kernel(const float* __restrict__ tok, const float* __restrict__ pe_tok,
                      const float* __restrict__ ln, const float* __restrict__ wqk,
                      const float* __restrict__ wv, float* __restrict__ xn,
                      float* __restrict__ q, float* __restrict__ k, float* __restrict__ v,
                      int T, int hw) {
  using S = Spa<C>;
  constexpr int D = S::D, LDD = S::LDD;
  using LN = RowLN<D>;
  extern __shared__ float4 smem4[];
  float* TK = reinterpret_cast<float*>(smem4);
  float* XN = TK + BM * LDD;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * BM;
  load_rows<D>(TK, LDD, tok, t0, T);
  __syncthreads();
  for (int r = warp; r < BM; r += NT / 32) {
    const int t = t0 + r;
    const float* pe = pe_tok + static_cast<size_t>(t % hw) * D;
    float val[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) val[e] = TK[r * LDD + LN::col(e)] + __ldg(pe + LN::col(e));
    LN::apply(val, ln, ln + D);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        XN[r * LDD + LN::col(e)] = val[e];
        if (t < T) xn[static_cast<size_t>(t) * D + LN::col(e)] = val[e];
      }
  }
  __syncthreads();
  {
    Acc<BM, 2 * D> acc;
    zero_acc<BM, 2 * D>(acc);
    gemm_acc<BM, D, 2 * D>(acc, XN, LDD, wqk);
    for_tiles<BM, 2 * D>(acc, [&](int r, int c, float4 val) {
      const int t = t0 + r;
      if (t >= T) return;
      if (c < D) store4(q + static_cast<size_t>(t) * D + c, val);
      else store4(k + static_cast<size_t>(t) * D + c - D, val);
    });
  }
  {
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, D, D>(acc, TK, LDD, wv);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 val) {
      const int t = t0 + r;
      if (t < T) store4(v + static_cast<size_t>(t) * D + c, val);
    });
  }
}

// ---- c: 5x5-window attention backward, one head of one 16 x 16 tile ------
// The block stages the tile's (16+4)^2 halo of q, k, v and dattn for its
// head, with m, l and dsum. Thread (ly, lx) owns pixel (y, x): as a query
// it sums dq over the keys of its window, as a key it gathers dk, dv from
// the queries whose window holds it (the same 5x5 neighbourhood).
template <int DH>
__global__ void __launch_bounds__(NT)
    spa_window_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ attn,
                               const float* __restrict__ dattn,
                               const float* __restrict__ m_in,
                               const float* __restrict__ l_in, float* __restrict__ dq_out,
                               float* __restrict__ dk_out, float* __restrict__ dv_out,
                               int h, int w, int D, float scale) {
  constexpr int KS = DH + 4;
  constexpr int NH = HH * HW;
  extern __shared__ float4 smem4[];
  float* QT = reinterpret_cast<float*>(smem4);   // [NH][KS] each
  float* KT = QT + NH * KS;
  float* VT = KT + NH * KS;
  float* GT = VT + NH * KS;                       // dattn
  float* MT = GT + NH * KS;                       // [NH] each
  float* LT = MT + NH;
  float* ST = LT + NH;                            // dsum
  const int H = gridDim.y;
  const int ntw = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / ntw) * TH, x0 = (blockIdx.x % ntw) * TW;
  const int head = blockIdx.y;
  const size_t view = static_cast<size_t>(blockIdx.z) * h * w;

  for (int i = threadIdx.x; i < NH * (DH / 4); i += NT) {
    const int key = i / (DH / 4), d = 4 * (i % (DH / 4));
    const int ky = y0 - R + key / HW, kx = x0 - R + key % HW;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv = qv, vv = qv, gv = qv;
    if (ky >= 0 && ky < h && kx >= 0 && kx < w) {
      const size_t off = (view + static_cast<size_t>(ky) * w + kx) * D + head * DH + d;
      qv = ldg4(q + off);
      kv = ldg4(k + off);
      vv = ldg4(v + off);
      gv = ldg4(dattn + off);
    }
    store4(QT + key * KS + d, qv);
    store4(KT + key * KS + d, kv);
    store4(VT + key * KS + d, vv);
    store4(GT + key * KS + d, gv);
  }
  for (int key = threadIdx.x; key < NH; key += NT) {
    const int ky = y0 - R + key / HW, kx = x0 - R + key % HW;
    float mv = 0.f, lv = 1.f, sv = 0.f;
    if (ky >= 0 && ky < h && kx >= 0 && kx < w) {
      const size_t pix = view + static_cast<size_t>(ky) * w + kx;
      mv = __ldg(m_in + pix * H + head);
      lv = __ldg(l_in + pix * H + head);
      const float* ar = attn + pix * D + head * DH;
      const float* gr = dattn + pix * D + head * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) sv = fmaf(__ldg(gr + d), __ldg(ar + d), sv);
    }
    MT[key] = mv;
    LT[key] = lv;
    ST[key] = sv;
  }
  __syncthreads();

  const int ly = threadIdx.x / TW, lx = threadIdx.x % TW;
  const int y = y0 + ly, x = x0 + lx;
  if (y >= h || x >= w) return;
  const int me = (ly + R) * HW + (lx + R);
  float qs[DH], kme[DH], vme[DH], gme[DH], dq[DH], dk[DH], dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qs[d] = QT[me * KS + d] * scale;
    kme[d] = KT[me * KS + d];
    vme[d] = VT[me * KS + d];
    gme[d] = GT[me * KS + d];
    dq[d] = dk[d] = dv[d] = 0.f;
  }
  const float m_me = MT[me], l_me = LT[me], s_me = ST[me];
  for (int dy = -R; dy <= R; ++dy) {
    if (y + dy < 0 || y + dy >= h) continue;
    for (int dx = -R; dx <= R; ++dx) {
      if (x + dx < 0 || x + dx >= w) continue;
      const int o = me + dy * HW + dx;
      const float* kr = KT + o * KS;
      const float* vr = VT + o * KS;
      const float* qr = QT + o * KS;
      const float* gr = GT + o * KS;
      // me as the query, o as the key (the forward's score arithmetic)
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qs[d], kr[d], s);
        dp = fmaf(gme[d], vr[d], dp);
      }
      float p = expf(s - m_me) / l_me;
      float g = p * (dp - s_me);
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] = fmaf(g, kr[d], dq[d]);
      // o as the query, me as the key
      float qo[DH];
      s = 0.f;
      dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qo[d] = qr[d] * scale;
        s = fmaf(qo[d], kme[d], s);
        dp = fmaf(gr[d], vme[d], dp);
      }
      p = expf(s - MT[o]) / LT[o];
      g = p * (dp - ST[o]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] = fmaf(g, qo[d], dk[d]);
        dv[d] = fmaf(p, gr[d], dv[d]);
      }
    }
  }
  const size_t off = (view + static_cast<size_t>(y) * w + x) * D + head * DH;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    store4(dq_out + off + d, make_float4(dq[d] * scale, dq[d + 1] * scale,
                                         dq[d + 2] * scale, dq[d + 3] * scale));
    store4(dk_out + off + d, make_float4(dk[d], dk[d + 1], dk[d + 2], dk[d + 3]));
    store4(dv_out + off + d, make_float4(dv[d], dv[d + 1], dv[d + 2], dv[d + 3]));
  }
}

// ---- d: projections and LN1 backward ---------------------------------------
template <int C>
__global__ void __launch_bounds__(NT)
    spa_qkv_ln_bwd_kernel(const float* __restrict__ tok, const float* __restrict__ pe_tok,
                          const float* __restrict__ dq, const float* __restrict__ dk,
                          const float* __restrict__ dv, const float* __restrict__ dx2,
                          const float* __restrict__ ln, const float* __restrict__ wqT,
                          const float* __restrict__ wkT, const float* __restrict__ wvT,
                          float* __restrict__ dtok, float* __restrict__ dtokpe,
                          float* __restrict__ ln_part, int T, int hw) {
  using S = Spa<C>;
  constexpr int D = S::D, LDD = S::LDD;
  using LN = RowLN<D>;
  extern __shared__ float4 smem4[];
  float* DQ = reinterpret_cast<float*>(smem4);   // dq -> dv Wvᵀ
  float* DK = DQ + BM * LDD;
  float* DV = DK + BM * LDD;
  float* DXN = DV + BM * LDD;
  float* WP = DXN + BM * LDD;                     // [8][2][D]
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * BM;
  const int nr = min(BM, T - t0);
  load_rows<D>(DQ, LDD, dq, t0, T);
  load_rows<D>(DK, LDD, dk, t0, T);
  load_rows<D>(DV, LDD, dv, t0, T);
  __syncthreads();
  {  // dxn = dq Wqᵀ + dk Wkᵀ
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, D, D>(acc, DQ, LDD, wqT);
    gemm_acc<BM, D, D>(acc, DK, LDD, wkT);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 v) { store4(DXN + r * LDD + c, v); });
  }
  __syncthreads();
  {  // dv Wvᵀ over dq
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, D, D>(acc, DV, LDD, wvT);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 v) { store4(DQ + r * LDD + c, v); });
  }
  __syncthreads();
  LnGradAcc<D> g1;
  g1.zero();
  for (int r = warp; r < nr; r += NT / 32) {
    const size_t t = static_cast<size_t>(t0 + r);
    const float* pe = pe_tok + (t % hw) * D;
    float xh[LN::E] = {}, d[LN::E] = {};
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) xh[e] = __ldg(tok + t * D + LN::col(e)) + __ldg(pe + LN::col(e));
    float mu, rstd;
    ln_stats<D>(xh, mu, rstd);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        xh[e] = (xh[e] - mu) * rstd;
        d[e] = DXN[r * LDD + LN::col(e)];
      }
    g1.add(d, xh);
    ln_bwd<D>(d, xh, rstd, ln);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        const int c = LN::col(e);
        dtokpe[t * D + c] = d[e];
        dtok[t * D + c] = __ldg(dx2 + t * D + c) + DQ[r * LDD + c] + d[e];
      }
  }
  g1.flush(WP, 2, 0);
  __syncthreads();
  block_colsum(WP, 2 * D, ln_part + static_cast<size_t>(blockIdx.x) * 2 * D);
}

// ---- e: tokenization backward, a gather over the 9 taps -------------------
// The forward's tok[t] = sum_tap x[t + s_tap] Wu[tap] (s_tap = (ky-1, kx-1)
// inside the image) gives dx[u] = sum_tap dtok[u - s_tap] Wu[tap]ᵀ = sum_tap
// dtok[u + s_tap] Wu[8 - tap]ᵀ: tap_conv_kernel<D, C, false, false>
// (tokenize.cuh) with the mirrored, transposed taps.

}  // namespace

LFT_EXPORT_ERROR_STRING

// Token tensors are [T, *] in [V, h, w] order (T = V h w), weights "x @ W"
// layouts as in spa_block.cu, "...T" their transposes: wlinT [C, D], w2T
// [D, 2D], w1T [2D, D], woT/wqT/wkT/wvT [D, D]. ln [4, D] is
// (LN1 w, b, LN2 w, b); ln_part [blocks, 2, D] with blocks = ceil(T / 64).
// Each returns the launch's cudaGetLastError(), or cudaErrorInvalidValue
// for a shape it does not take (C in {16, 32, 64}).

extern "C" int lft_spa_ffn_out_bwd(const float* attn, const float* tok, const float* dout,
                                   const float* ln, const float* wo, const float* w1,
                                   const float* w2, const float* wlinT, const float* w2T,
                                   const float* w1T, const float* woT, float* dx2,
                                   float* dattn, float* y, float* dy, float* hid,
                                   float* dpre, float* xn2, float* ln_part, int T, int C,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    using SS = Spa<CC>;
    auto kernel = spa_ffn_out_bwd_kernel<CC>;
    const size_t bytes = (BM * (3 * SS::LDD + SS::LDH + SS::LDC) + 2 * BM +
                          (NT / 32) * 2 * SS::D) * sizeof(float);
    LFT_SET_SMEM(kernel, bytes);
    kernel<<<blocks(T), NT, bytes, s>>>(attn, tok, dout, ln, wo, w1, w2, wlinT, w2T, w1T,
                                        woT, dx2, dattn, y, dy, hid, dpre, xn2, ln_part, T);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lft_spa_ln_qkv(const float* tok, const float* pe_tok, const float* ln,
                              const float* wqk, const float* wv, float* xn, float* q,
                              float* k, float* v, int T, int hw, int C, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    auto kernel = spa_ln_qkv_kernel<CC>;
    const size_t bytes = 2 * BM * Spa<CC>::LDD * sizeof(float);
    LFT_SET_SMEM(kernel, bytes);
    kernel<<<blocks(T), NT, bytes, s>>>(tok, pe_tok, ln, wqk, wv, xn, q, k, v, T, hw);
  });
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, attn, dattn, dq, dk, dv [V, h, w, D]; m, l [V, h, w, H].
extern "C" int lft_spa_window_attn_bwd(const float* q, const float* k, const float* v,
                                       const float* attn, const float* dattn,
                                       const float* m, const float* l, float* dq,
                                       float* dk, float* dv, int V, int h, int w, int D,
                                       int H, float scale, void* stream) {
  if (H != 8) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), H, V);
  switch (D / H) {
#define LFT_ATTN_CASE(DHV)                                                      \
    case DHV: {                                                                 \
      auto kernel = spa_window_attn_bwd_kernel<DHV>;                            \
      const size_t bytes = HH * HW * (4 * (DHV + 4) + 3) * sizeof(float);       \
      LFT_SET_SMEM(kernel, bytes);                                              \
      kernel<<<grid, NT, bytes, s>>>(q, k, v, attn, dattn, m, l, dq, dk, dv, h, w, D, \
                                     scale);                                    \
      break;                                                                    \
    }
    LFT_ATTN_CASE(4)
    LFT_ATTN_CASE(8)
    LFT_ATTN_CASE(16)
#undef LFT_ATTN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lft_spa_qkv_ln_bwd(const float* tok, const float* pe_tok, const float* dq,
                                  const float* dk, const float* dv, const float* dx2,
                                  const float* ln, const float* wqT, const float* wkT,
                                  const float* wvT, float* dtok, float* dtokpe,
                                  float* ln_part, int T, int hw, int C, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    auto kernel = spa_qkv_ln_bwd_kernel<CC>;
    const size_t bytes = (4 * BM * Spa<CC>::LDD + (NT / 32) * 2 * Spa<CC>::D) * sizeof(float);
    LFT_SET_SMEM(kernel, bytes);
    kernel<<<blocks(T), NT, bytes, s>>>(tok, pe_tok, dq, dk, dv, dx2, ln, wqT, wkT, wvT,
                                        dtok, dtokpe, ln_part, T, hw);
  });
  return static_cast<int>(cudaGetLastError());
}

// dtok [T, D] -> dx [T, C], T = V h w; wu [9, C, D]; wf scratch of 18 C D
// floats (wu[8 - tap]ᵀ split into TF32 hi/lo, kernels/spa_block.py:
// tap_weights(wu, backward=True)); a block takes r x cw pixels of a view
// (tok_tile).
extern "C" int lft_spa_tokenize_bwd(const float* dtok, const float* wu, float* wf, float* dx,
                                    int T, int h, int w, int C, int r, int cw, void* stream) {
  if (h < 1 || w < 1 || T < 1 || T % (h * w)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    return launch_tap_conv<2 * CC, CC, false, false, true>(dtok, wu, wf, nullptr, nullptr, dx,
                                                           nullptr, T / (h * w), h, w, 1, r,
                                                           cw, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
