// K1: the whole AngTrans block (reference model/LFT.py:194-238), forward,
// with or without the residuals of the backward; K4, its backward, below.
//
// Replaces lft_tpu/kernels/ang_block.py:_core_fwd / _kernel (the Pallas TPU
// kernel behind ang_trans_block_fused). Per pixel, over its A2 view tokens
// of width C:
//   xn  = LN1(x + ang_pe)
//   q = xn Wq, k = xn Wk, v = x Wv           (asymmetric pre-norm: v is RAW)
//   a   = softmax_heads(q k^T * (C/H)^-0.5) v   over the A2 tokens
//   x2  = a Wo + x
//   out = relu(LN2(x2) W1) W2 + x2
//
// Bound on this card: at the production shape [16384, 25, 64] the six
// products are 26.8 GFLOP (16 C^2 FLOP a token), the attention 2.6 GFLOP and
// the block moves ~210 MB. On the FP32 pipes (67 TFLOP/s) that is 0.44 ms,
// bound by operations; as 3xTF32 on the tensor cores (3 TF32 products at
// 495 TFLOP/s) the products take 0.163 ms and the attention, which stays
// on the FP32 pipes, 0.04 ms; the bytes 0.063 ms. So the products run on the
// tensor cores (rowgemm.cuh):
//
// * A block of two warpgroups takes RP = 128 token rows = P = 128 / A2
//   whole pixels a tile (5 at A2 = 25, 1 at A2 = 81-128), persistent over
//   tiles, so attention never leaves the block. Each warp owns 16 rows: it
//   loads them, normalises them (LN1, one row at a time) and runs the
//   products on them; only the attention reads other warps' rows, between
//   two barriers. The block-diagonal key replication, head masks and pixel
//   groups of the TPU kernel are gone: a thread runs one (pixel, head,
//   query) softmax over the A2 keys, chunks of 8 keys at a time with an
//   online max, reading k/v from shared memory.
// * v first (from x), then q over x's rows, then k; after the attention,
//   x2 = a Wo + x (x read again from device memory, an L2 hit) goes over
//   q's rows, LN2 runs on the accumulators (rowgemm.cuh:quad_ln: a row's C
//   values lie in the four lanes of a quad; LN1 likewise, on x + pe read in that layout: the
//   16 rows of a warp at once, where a row at a time left the warp waiting
//   on its shuffles), and the FFN goes in hidden chunks of 64 columns:
//   relu(LN2(x2) W1[:, chunk]) into shared memory over the dead k/v tiles,
//   then out += chunk W2[chunk, :] in registers, + x2 as it is written.
//   Shared memory at C = 64: four 128 x 68 tiles (x / q / x2, xn /
//   attention / LN2(x2), k, v / hidden) 136 KB and a ring of 5 16-KB weight
//   stages (the 6 products' weights, split, are 256 KB): 216 KB, one block
//   an SM.
// * With residuals (training) each thread also writes its query's m, l and
//   attention output.

#include "attn.cuh"
#include "bwd.cuh"
#include "rowgemm.cuh"

using namespace lft;

namespace {

constexpr int RP = 128;  // token rows per block
static_assert(RP == RG_M, "a tile is one row-tile product's 128 rows");

template <int C>
struct AngLayout {
  static constexpr int LD = C + 4;                      // row stride of the C-wide tiles
  static constexpr int HC = 2 * C < 64 ? 2 * C : 64;    // hidden columns a chunk
  static constexpr int NH = 2 * C / HC;                 // chunks
  static constexpr int LDH = HC + 4;                    // row stride of a hidden chunk
  static constexpr int TILE = RP * LD;
  // the weight stream: Wv, Wq, Wk, Wo, then per chunk W1[:, chunk], W2[chunk, :]
  static constexpr int SQ = 2 * C * C;                  // floats of a C x C piece
  static constexpr int OFF_V = 0, OFF_Q = SQ, OFF_K = 2 * SQ, OFF_O = 3 * SQ, OFF_F = 4 * SQ;
  static constexpr int W1 = 2 * C * HC, W2 = 2 * HC * C;
  static constexpr int FLOATS = OFF_F + NH * (W1 + W2);
  static constexpr int TILES = 4 * TILE * 4;            // bytes of rows
  static constexpr int NS = rg_slots(TILES);
  static constexpr size_t BYTES = TILES + static_cast<size_t>(NS) * RG_SF * 4;
  static_assert(RP * LDH <= 2 * TILE, "a hidden chunk must fit over k and v");
};

// wf: the weight stream (AngLayout::FLOATS floats, kernels/rowgemm.py:
// ang_block_stream), written by rg_weights_kernel.
template <int C, int H, bool RES>
__global__ void __launch_bounds__(RG_NT, 1)
    ang_block_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                     const float* __restrict__ ln, const float* __restrict__ wf,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ attn_out, int N, int A2,
                     float scale) {
  using L = AngLayout<C>;
  constexpr int LD = L::LD, LDH = L::LDH, HC = L::HC, DH = C / H;
  extern __shared__ __align__(16) float smem[];
  float* XQ = smem;             // x, then q, then x2
  float* XN = XQ + L::TILE;     // xn, then the attention output, then LN2(x2)
  float* K = XN + L::TILE;
  float* V = K + L::TILE;
  float* HID = K;               // a hidden chunk [RP][LDH], over k and v

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = 16 * warp;     // the warp's rows
  const int P = RP / A2;
  const int tiles = (N + P - 1) / P;
  WeightRing<L::NS> ring;
  ring.start(V + L::TILE, wf, L::FLOATS,
             (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x);
  const float* st = nullptr;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int pix0 = tile * P;
    const int np = min(P, N - pix0);
    const int nrows = np * A2;
    const size_t row0 = static_cast<size_t>(pix0) * A2;

    {  // the warp's rows of x (contiguous; zero past the tile's pixels), all
       // loads in flight at once; then xn = LN1(x + pe)
      constexpr int L4 = C / 8;   // float4 a lane
      float4 v[L4];
#pragma unroll
      for (int k = 0; k < L4; ++k) {
        const int i = lane + 32 * k, r = wr + i / (C / 4), c = 4 * (i % (C / 4));
        v[k] = r < nrows ? ldg4(x + (row0 + r) * C + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < L4; ++k) {
        const int i = lane + 32 * k;
        store4(XQ + (wr + i / (C / 4)) * LD + 4 * (i % (C / 4)), v[k]);
      }
      __syncwarp();
    }
    {  // xn = LN1(x + pe), the warp's 16 rows at once
      RgAcc<C> xp;
      rg_pairs<C>(xp, [&](int r, int c, float& v0, float& v1) {
        const float2 a = *reinterpret_cast<const float2*>(XQ + (wr + r) * LD + c);
        const float2 b = __ldg(reinterpret_cast<const float2*>(pe + ((wr + r) % A2) * C + c));
        v0 = a.x + b.x;
        v1 = a.y + b.y;
      });
      quad_ln<C>(xp, ln, ln + C);
      rg_pairs<C>(xp, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(XN + (wr + r) * LD + c) = make_float2(v0, v1);
      });
    }
    __syncwarp();

    {  // v from the raw x, then q over x's rows, k from xn
      RgAcc<C> acc;
      auto put = [&](float* dst) {
        rg_pairs<C>(acc, [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(dst + (wr + r) * LD + c) = make_float2(v0, v1);
        });
      };
      rg_zero<C>(acc);
      rg_product<C, C, L::OFF_V>(acc, XQ + wr * LD, LD, ring, st);
      put(V);
      rg_zero<C>(acc);
      rg_product<C, C, L::OFF_Q>(acc, XN + wr * LD, LD, ring, st);
      __syncwarp();   // x is read
      put(XQ);
      rg_zero<C>(acc);
      rg_product<C, C, L::OFF_K>(acc, XN + wr * LD, LD, ring, st);
      put(K);
    }
    __syncthreads();

    // attention over each pixel's A2 tokens; one thread per (pixel, head,
    // query), queries fastest so a warp reads the same key rows (broadcast).
    // Keys go in chunks of KB: their scores are independent, then one
    // rescale of the running sums a chunk (an online softmax over chunks).
    // The output overwrites xn, which is dead after the projections.
    constexpr int KB = 8;
    for (int t = tid; t < np * H * A2; t += RG_NT) {
      const int i = t % A2, hh = (t / A2) % H, p = t / (A2 * H);
      const float* qr = XQ + (p * A2 + i) * LD + hh * DH;
      const float* kp = K + p * A2 * LD + hh * DH;
      const float* vp = V + p * A2 * LD + hh * DH;
      float qv[DH], o[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qv[d] = qr[d] * scale;
        o[d] = 0.f;
      }
      float m = -CUDART_INF_F, l = 0.f;
      for (int j0 = 0; j0 < A2; j0 += KB) {
        float sc[KB];
        float mc = m;
#pragma unroll
        for (int jj = 0; jj < KB; ++jj) {
          float s = -CUDART_INF_F;
          if (j0 + jj < A2) {
            const float* kr = kp + (j0 + jj) * LD;
            s = 0.f;
#pragma unroll
            for (int d = 0; d < DH; ++d) s = fmaf(qv[d], kr[d], s);
          }
          sc[jj] = s;
          mc = fmaxf(mc, s);
        }
        const float corr = expf(m - mc);
        l *= corr;
#pragma unroll
        for (int d = 0; d < DH; ++d) o[d] *= corr;
#pragma unroll
        for (int jj = 0; jj < KB; ++jj) {
          if (j0 + jj < A2) {
            const float e = expf(sc[jj] - mc);
            const float* vr = vp + (j0 + jj) * LD;
            l += e;
#pragma unroll
            for (int d = 0; d < DH; ++d) o[d] = fmaf(e, vr[d], o[d]);
          }
        }
        m = mc;
      }
      const float inv = 1.f / l;
      float* ar = XN + (p * A2 + i) * LD + hh * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) ar[d] = o[d] * inv;
      if constexpr (RES) {  // the residuals of the backward (K4)
        const size_t row = row0 + p * A2 + i;
        m_out[row * H + hh] = m;
        l_out[row * H + hh] = l;
#pragma unroll
        for (int d = 0; d < DH; ++d) attn_out[row * C + hh * DH + d] = ar[d];
      }
    }
    __syncthreads();

    // x2 = a Wo + x over the warp's rows of q (dead), LN2(x2) over its rows
    // of the attention output
    RgAcc<C> x2;
    rg_zero<C>(x2);
    rg_product<C, C, L::OFF_O>(x2, XN + wr * LD, LD, ring, st);
    rg_pairs<C>(x2, [&](int r, int c, float& v0, float& v1) {
      if (wr + r < nrows) {
        const float2 xv = __ldg(reinterpret_cast<const float2*>(x + (row0 + wr + r) * C + c));
        v0 += xv.x;
        v1 += xv.y;
      }
      *reinterpret_cast<float2*>(XQ + (wr + r) * LD + c) = make_float2(v0, v1);
    });
    __syncwarp();   // the attention output is read
    quad_ln<C>(x2, ln + 2 * C, ln + 3 * C);
    rg_pairs<C>(x2, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(XN + (wr + r) * LD + c) = make_float2(v0, v1);
    });
    __syncwarp();

    // out = relu(LN2(x2) W1) W2 + x2, the hidden layer in chunks
    RgAcc<C> y;
    rg_zero<C>(y);
    rg_static_for<L::NH>([&](auto J) {
      constexpr int off = L::OFF_F + decltype(J)::value * (L::W1 + L::W2);
      RgAcc<HC> hid;
      rg_zero<HC>(hid);
      rg_product<C, HC, off>(hid, XN + wr * LD, LD, ring, st);
      __syncwarp();   // the previous chunk's rows are read
      rg_pairs<HC>(hid, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(HID + (wr + r) * LDH + c) = make_float2(fmaxf(v0, 0.f),
                                                                           fmaxf(v1, 0.f));
      });
      __syncwarp();
      rg_product<HC, C, off + L::W1>(y, HID + wr * LDH, LDH, ring, st);
    });
    rg_pairs<C>(y, [&](int r, int c, float v0, float v1) {
      if (wr + r >= nrows) return;
      const float2 res = *reinterpret_cast<const float2*>(XQ + (wr + r) * LD + c);
      *reinterpret_cast<float2*>(out + (row0 + wr + r) * C + c) =
          make_float2(v0 + res.x, v1 + res.y);
    });
  }
  cp_async_wait<0>();
}

template <int C, bool RES>
int launch(const float* x, const float* pe, const float* ln, const float* wq,
           const float* wk, const float* wv, const float* wo, const float* w1,
           const float* w2, float* wf, float* out, float* m, float* l, float* attn, int N,
           int A2, float scale, cudaStream_t stream) {
  using L = AngLayout<C>;
  constexpr int H = 8;
  RgPieces ps{};
  int n = 0;
  ps.p[n++] = RgPiece{wv, C, C, C, L::OFF_V};
  ps.p[n++] = RgPiece{wq, C, C, C, L::OFF_Q};
  ps.p[n++] = RgPiece{wk, C, C, C, L::OFF_K};
  ps.p[n++] = RgPiece{wo, C, C, C, L::OFF_O};
  for (int j = 0; j < L::NH; ++j) {
    ps.p[n++] = RgPiece{w1 + j * L::HC, 2 * C, C, L::HC, L::OFF_F + j * (L::W1 + L::W2)};
    ps.p[n++] = RgPiece{w2 + j * L::HC * C, C, L::HC, C, L::OFF_F + j * (L::W1 + L::W2) + L::W1};
  }
  launch_rg_weights(ps, n, wf, stream);
  auto kernel = ang_block_kernel<C, H, RES>;
  LFT_SET_SMEM(kernel, L::BYTES);
  const int P = RP / A2;
  kernel<<<rg_grid((N + P - 1) / P), RG_NT, L::BYTES, stream>>>(x, pe, ln, wf, out, m, l, attn,
                                                                 N, A2, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4: the block's backward ---------------------------------------------
//
// Replaces lft_tpu/kernels/ang_block.py:_vjp_bwd / _bwd_kernel. One block
// owns RB = 64 token rows = RB / A2 whole pixels (2 at A2 = 25) and runs,
// in shared memory:
//   recompute   xn = LN1(x + pe), q, k, v; x2 = attn Wo + x (attn saved);
//               xn2 = LN2(x2); hid = relu(xn2 W1)
//   backward    dpre = (hid > 0) dout W2ᵀ;  dxn2 = dpre W1ᵀ;
//               dx2 = dout + LN2ᵀ(dxn2);  dattn = dx2 Woᵀ;
//               attention from the saved (m, l): thread (pixel, head, t)
//               computes dq of query t over the keys and dk, dv of key t
//               over the queries, with dsum_i = dattn_i . attn_i;
//               dxn = dq Wqᵀ + dk Wkᵀ;  dx = dx2 + dv Wvᵀ + LN1ᵀ(dxn)
// and writes dx plus the per-token operands of the weight gradients (xn,
// dq, dk, dv, dx2, xn2, dpre, hid) and its own partial column sums of the
// LayerNorm affine grads; `wgrad`/`colsum` (wgrad.cu) reduce them in a
// fixed order. The TPU kernel accumulated the weight grads across its
// sequential grid; CUDA blocks run in no order, and float atomics would
// make every step's result depend on the schedule. Pad rows of the last
// block are masked: they are computed from zeros and never stored or
// summed.
//
// Bound: ~44 C^2 + 10 A2 C FLOP a token (~22 GFLOP at [4096, 25, 64],
// 0.33 ms at 67 TFLOP/s FP32) and ~20 C-wide token tensors of traffic
// (~0.16 ms): operations. 188 KB of shared memory at C = 64: one block of
// 8 warps per SM.

constexpr int RB = 64;  // token rows per block of the backward

template <int C>
struct AngBwdLayout {
  static constexpr int LD = C + 4, LDH = 2 * C + 4;
  static constexpr int TILE = RB * LD;
  static constexpr int FLOATS = 8 * TILE + RB * LDH + 3 * RB * 8 + 2 * RB + (NT / 32) * 4 * C;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int C, int H>
__global__ void __launch_bounds__(NT)
    ang_block_bwd_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                         const float* __restrict__ ln, const float* __restrict__ wq,
                         const float* __restrict__ wk, const float* __restrict__ wv,
                         const float* __restrict__ wo, const float* __restrict__ w1,
                         const float* __restrict__ wqT, const float* __restrict__ wkT,
                         const float* __restrict__ wvT, const float* __restrict__ woT,
                         const float* __restrict__ w1T, const float* __restrict__ w2T,
                         const float* __restrict__ m_in, const float* __restrict__ l_in,
                         const float* __restrict__ attn, const float* __restrict__ dout,
                         float* __restrict__ dx, float* __restrict__ xn_out,
                         float* __restrict__ dq_out, float* __restrict__ dk_out,
                         float* __restrict__ dv_out, float* __restrict__ dx2_out,
                         float* __restrict__ xn2_out, float* __restrict__ dpre_out,
                         float* __restrict__ hid_out, float* __restrict__ ln_part, int N,
                         int A2, float scale) {
  using L = AngBwdLayout<C>;
  using LN = RowLN<C>;
  constexpr int LD = L::LD, LDH = L::LDH, DH = C / H;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // x
  float* XN = X + L::TILE;                      // xn -> xn2 -> dxn2 -> dq
  float* Q = XN + L::TILE;                      // q -> dxn
  float* K = Q + L::TILE;
  float* V = K + L::TILE;
  float* A = V + L::TILE;                       // attn (saved)
  float* X2 = A + L::TILE;                      // x2 -> dx2 -> dx
  float* DO = X2 + L::TILE;                     // dout -> dattn
  float* HD = DO + L::TILE;                     // [RB][LDH] hid -> dpre -> (dk | dv)
  float* M = HD + RB * LDH;                     // [RB][8]
  float* Lsum = M + RB * 8;
  float* DS = Lsum + RB * 8;                    // dsum_i = dattn_i . attn_i per head
  float* MU2 = DS + RB * 8;
  float* RS2 = MU2 + RB;
  float* WP = RS2 + RB;                         // [8 warps][4][C]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int P = RB / A2;
  const int pix0 = blockIdx.x * P;
  const int np = min(P, N - pix0);
  const int nrows = np * A2;
  const size_t row0 = static_cast<size_t>(pix0) * A2;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < RB * (C / 4); i += NT) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4));
    const bool ok = r < nrows;
    const size_t g = (row0 + r) * C + c;
    store4(X + r * LD + c, ok ? ldg4(x + g) : z4);
    store4(A + r * LD + c, ok ? ldg4(attn + g) : z4);
    store4(DO + r * LD + c, ok ? ldg4(dout + g) : z4);
  }
  for (int i = tid; i < RB * H; i += NT) {
    const bool ok = i / H < nrows;
    M[i] = ok ? __ldg(m_in + row0 * H + i) : 0.f;
    Lsum[i] = ok ? __ldg(l_in + row0 * H + i) : 1.f;
  }
  __syncthreads();

  // xn = LN1(x + pe), as the forward computed it
  for (int r = warp; r < RB; r += NT / 32) {
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) v[e] = X[r * LD + LN::col(e)] + __ldg(pe + (r % A2) * C + LN::col(e));
    LN::apply(v, ln, ln + C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        XN[r * LD + LN::col(e)] = v[e];
        if (r < nrows) xn_out[(row0 + r) * C + LN::col(e)] = v[e];
      }
  }
  __syncthreads();

  {  // q, k from xn; v from x; x2 = attn Wo + x
    Acc<RB, C> acc;
    zero_acc<RB, C>(acc);
    gemm_acc<RB, C, C>(acc, XN, LD, wq);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) { store4(Q + r * LD + c, v); });
    zero_acc<RB, C>(acc);
    gemm_acc<RB, C, C>(acc, XN, LD, wk);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) { store4(K + r * LD + c, v); });
    zero_acc<RB, C>(acc);
    gemm_acc<RB, C, C>(acc, X, LD, wv);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) { store4(V + r * LD + c, v); });
    zero_acc<RB, C>(acc);
    gemm_acc<RB, C, C>(acc, A, LD, wo);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) {
      store4(X2 + r * LD + c, add4(load4(X + r * LD + c), v));
    });
  }
  __syncthreads();

  // xn2 = LN2(x2) over xn, and its statistics
  for (int r = warp; r < RB; r += NT / 32) {
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) v[e] = X2[r * LD + LN::col(e)];
    float mu, rstd;
    ln_stats<C>(v, mu, rstd);
    if ((tid & 31) == 0) {
      MU2[r] = mu;
      RS2[r] = rstd;
    }
    LN::apply(v, ln + 2 * C, ln + 3 * C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        XN[r * LD + LN::col(e)] = v[e];
        if (r < nrows) xn2_out[(row0 + r) * C + LN::col(e)] = v[e];
      }
  }
  __syncthreads();

  {  // hid = relu(xn2 W1)
    Acc<RB, 2 * C> acc;
    zero_acc<RB, 2 * C>(acc);
    gemm_acc<RB, C, 2 * C>(acc, XN, LD, w1);
    for_tiles<RB, 2 * C>(acc, [&](int r, int c, float4 v) {
      v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      store4(HD + r * LDH + c, v);
      if (r < nrows) store4(hid_out + (row0 + r) * (2 * C) + c, v);
    });
  }
  __syncthreads();

  {  // dpre = (hid > 0) * (dout W2ᵀ), in place over hid
    Acc<RB, 2 * C> acc;
    zero_acc<RB, 2 * C>(acc);
    gemm_acc<RB, C, 2 * C>(acc, DO, LD, w2T);
    for_tiles<RB, 2 * C>(acc, [&](int r, int c, float4 v) {
      const float4 hv = load4(HD + r * LDH + c);
      v = make_float4(hv.x > 0.f ? v.x : 0.f, hv.y > 0.f ? v.y : 0.f,
                      hv.z > 0.f ? v.z : 0.f, hv.w > 0.f ? v.w : 0.f);
      store4(HD + r * LDH + c, v);
      if (r < nrows) store4(dpre_out + (row0 + r) * (2 * C) + c, v);
    });
  }
  __syncthreads();

  {  // dxn2 = dpre W1ᵀ over xn2
    Acc<RB, C> acc;
    zero_acc<RB, C>(acc);
    gemm_acc<RB, 2 * C, C>(acc, HD, LDH, w1T);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) { store4(XN + r * LD + c, v); });
  }
  __syncthreads();

  LnGradAcc<C> g2;
  g2.zero();
  // dx2 = dout + LN2ᵀ(dxn2), in place over x2
  for (int r = warp; r < nrows; r += NT / 32) {
    float xh[LN::E] = {}, d[LN::E] = {};
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        xh[e] = (X2[r * LD + LN::col(e)] - MU2[r]) * RS2[r];
        d[e] = XN[r * LD + LN::col(e)];
      }
    g2.add(d, xh);
    ln_bwd<C>(d, xh, RS2[r], ln + 2 * C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        const float v = DO[r * LD + LN::col(e)] + d[e];
        X2[r * LD + LN::col(e)] = v;
        dx2_out[(row0 + r) * C + LN::col(e)] = v;
      }
  }
  g2.flush(WP, 4, 2);
  __syncthreads();

  {  // dattn = dx2 Woᵀ over dout
    Acc<RB, C> acc;
    zero_acc<RB, C>(acc);
    gemm_acc<RB, C, C>(acc, X2, LD, woT);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) { store4(DO + r * LD + c, v); });
  }
  __syncthreads();

  for (int i = tid; i < nrows * H; i += NT) {  // dsum = dattn . attn per head
    const int r = i / H, hh = i % H;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) s = fmaf(DO[r * LD + hh * DH + d], A[r * LD + hh * DH + d], s);
    DS[i] = s;
  }
  __syncthreads();

  // attention backward; thread (pixel, head, t), t fastest. Scores are
  // rebuilt with the forward's arithmetic (q scaled first, then an fmaf
  // chain), so p = exp(s - m) / l uses exactly the forward's s.
  for (int t = tid; t < np * H * A2; t += NT) {
    const int i = t % A2, hh = (t / A2) % H, p = t / (A2 * H);
    const int me = p * A2 + i;
    float qs[DH], kv[DH], vv[DH], dov[DH], dq[DH], dk[DH], dv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qs[d] = Q[me * LD + hh * DH + d] * scale;
      kv[d] = K[me * LD + hh * DH + d];
      vv[d] = V[me * LD + hh * DH + d];
      dov[d] = DO[me * LD + hh * DH + d];
      dq[d] = dk[d] = dv[d] = 0.f;
    }
    const float m_me = M[me * H + hh], inv_me = 1.f / Lsum[me * H + hh];
    const float ds_me = DS[me * H + hh];
    for (int j = 0; j < A2; ++j) {
      const int o = p * A2 + j;
      const float* kr = K + o * LD + hh * DH;
      const float* vr = V + o * LD + hh * DH;
      const float* qr = Q + o * LD + hh * DH;
      const float* dr = DO + o * LD + hh * DH;
      // me as the query, o as the key
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qs[d], kr[d], s);
        dp = fmaf(dov[d], vr[d], dp);
      }
      float pr = expf(s - m_me) * inv_me;
      float g = pr * (dp - ds_me);
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] = fmaf(g, kr[d], dq[d]);
      // o as the query, me as the key
      float qo[DH];
      s = 0.f;
      dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qo[d] = qr[d] * scale;
        s = fmaf(qo[d], kv[d], s);
        dp = fmaf(dr[d], vv[d], dp);
      }
      pr = expf(s - M[o * H + hh]) / Lsum[o * H + hh];
      g = pr * (dp - DS[o * H + hh]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] = fmaf(g, qo[d], dk[d]);
        dv[d] = fmaf(pr, dr[d], dv[d]);
      }
    }
    const size_t row = row0 + me;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const int c = hh * DH + d;
      XN[me * LD + c] = dq[d] * scale;
      HD[me * LDH + c] = dk[d];
      HD[me * LDH + C + c] = dv[d];
      dq_out[row * C + c] = dq[d] * scale;
      dk_out[row * C + c] = dk[d];
      dv_out[row * C + c] = dv[d];
    }
  }
  __syncthreads();

  {  // dxn = dq Wqᵀ + dk Wkᵀ over q; dx = dx2 + dv Wvᵀ over dx2
    Acc<RB, C> acc;
    zero_acc<RB, C>(acc);
    gemm_acc<RB, C, C>(acc, XN, LD, wqT);
    gemm_acc<RB, C, C>(acc, HD, LDH, wkT);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) { store4(Q + r * LD + c, v); });
    zero_acc<RB, C>(acc);
    gemm_acc<RB, C, C>(acc, HD + C, LDH, wvT);
    for_tiles<RB, C>(acc, [&](int r, int c, float4 v) {
      store4(X2 + r * LD + c, add4(load4(X2 + r * LD + c), v));
    });
  }
  __syncthreads();

  LnGradAcc<C> g1;
  g1.zero();
  // dx += LN1ᵀ(dxn)
  for (int r = warp; r < nrows; r += NT / 32) {
    float xh[LN::E] = {}, d[LN::E] = {};
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) xh[e] = X[r * LD + LN::col(e)] + __ldg(pe + (r % A2) * C + LN::col(e));
    float mu, rstd;
    ln_stats<C>(xh, mu, rstd);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        xh[e] = (xh[e] - mu) * rstd;
        d[e] = Q[r * LD + LN::col(e)];
      }
    g1.add(d, xh);
    ln_bwd<C>(d, xh, rstd, ln);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e))
        dx[(row0 + r) * C + LN::col(e)] = X2[r * LD + LN::col(e)] + d[e];
  }
  g1.flush(WP, 4, 0);
  __syncthreads();
  block_colsum(WP, 4 * C, ln_part + static_cast<size_t>(blockIdx.x) * 4 * C);
}

template <int C>
int launch_bwd(const float* const* in, float* const* out, int N, int A2, float scale,
               cudaStream_t stream) {
  auto kernel = ang_block_bwd_kernel<C, 8>;
  const size_t bytes = AngBwdLayout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = RB / A2;
  kernel<<<(N + P - 1) / P, NT, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10], in[11],
      in[12], in[13], in[14], in[15], in[16], in[17], out[0], out[1], out[2], out[3],
      out[4], out[5], out[6], out[7], out[8], out[9], N, A2, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4 for 64 < A2 <= 128: the same backward as three kernels ------------
//
// A pixel of 65 to 128 view tokens does not fit the kernel above: its nine
// [rows][C + 4] tiles and the hidden tile take 376 KB at 128 rows and C = 64,
// and a block can hold 227 KB. Only the attention needs a pixel's rows
// together, so the backward is cut there, as K3 is cut into five kernels,
// and the intermediates pass through device memory:
//   a  ang_bwd_tok_kernel   BM = 64 token rows a block, rows of any pixels:
//                           recompute xn, q, k, v, x2, xn2, hid; dpre, dxn2,
//                           dx2, dattn = dx2 Woᵀ and dsum = dattn . attn per
//                           head; writes xn, xn2, hid, dpre, dx2 (operands of
//                           the weight grads) and the scratch q, k, v, dattn,
//                           dsum; LN2's partial affine sums
//   b  ang_bwd_attn_kernel  one pixel a block (P = 1: rows of two pixels never
//                           share a block), its q, k, v, dattn rows (<= 139 KB)
//                           and m, l, dsum in shared memory; thread (head, t)
//                           computes dq of query t and dk, dv of key t exactly
//                           as the kernel above does; writes dq, dk, dv
//   c  ang_bwd_in_kernel    BM = 64 token rows a block: dxn = dq Wqᵀ + dk Wkᵀ,
//                           dx = dx2 + dv Wvᵀ + LN1ᵀ(dxn); LN1's partial sums
// Each output element is written by one thread and every sum has a fixed
// order: no atomics, a step repeats bit for bit. ln_part is [blocks, 4, C]
// with blocks = ceil(N A2 / 64): kernel c fills rows 0-1 of a block's slot,
// kernel a rows 2-3. Ragged tails (the last block's rows past N A2) are
// computed from zeros and never stored or summed. The extra traffic is the
// scratch written and read once (9 C-wide token tensors more than the
// 64-row kernel): the bound stays the operations'.

template <int C>
struct AngBwdTokLayout {
  static constexpr int LD = C + 4, LDH = 2 * C + 4;
  static constexpr int TILE = BM * LD;
  static constexpr int FLOATS = 5 * TILE + BM * LDH + 2 * BM + (NT / 32) * 2 * C;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int C, int H>
__global__ void __launch_bounds__(NT)
    ang_bwd_tok_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                       const float* __restrict__ ln, const float* __restrict__ wq,
                       const float* __restrict__ wk, const float* __restrict__ wv,
                       const float* __restrict__ wo, const float* __restrict__ w1,
                       const float* __restrict__ woT, const float* __restrict__ w1T,
                       const float* __restrict__ w2T, const float* __restrict__ attn,
                       const float* __restrict__ dout, float* __restrict__ xn_out,
                       float* __restrict__ q_out, float* __restrict__ k_out,
                       float* __restrict__ v_out, float* __restrict__ dx2_out,
                       float* __restrict__ xn2_out, float* __restrict__ dpre_out,
                       float* __restrict__ hid_out, float* __restrict__ dattn_out,
                       float* __restrict__ dsum_out, float* __restrict__ ln_part, int T,
                       int A2) {
  using L = AngBwdTokLayout<C>;
  using LN = RowLN<C>;
  constexpr int LD = L::LD, LDH = L::LDH, DH = C / H;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // x
  float* XN = X + L::TILE;                      // xn -> xn2 -> dxn2
  float* A = XN + L::TILE;                      // attn (saved)
  float* X2 = A + L::TILE;                      // x2 -> dx2
  float* DO = X2 + L::TILE;                     // dout -> dattn
  float* HD = DO + L::TILE;                     // [BM][LDH] hid -> dpre
  float* MU2 = HD + BM * LDH;
  float* RS2 = MU2 + BM;
  float* WP = RS2 + BM;                         // [8 warps][2][C]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int t0 = blockIdx.x * BM;
  const int nrows = min(BM, T - t0);
  const size_t row0 = static_cast<size_t>(t0);

  load_rows<C>(X, LD, x, t0, T);
  load_rows<C>(A, LD, attn, t0, T);
  load_rows<C>(DO, LD, dout, t0, T);
  __syncthreads();

  // xn = LN1(x + pe), as the forward computed it
  for (int r = warp; r < BM; r += NT / 32) {
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e))
        v[e] = X[r * LD + LN::col(e)] + __ldg(pe + ((t0 + r) % A2) * C + LN::col(e));
    LN::apply(v, ln, ln + C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        XN[r * LD + LN::col(e)] = v[e];
        if (r < nrows) xn_out[(row0 + r) * C + LN::col(e)] = v[e];
      }
  }
  __syncthreads();

  {  // q, k from xn and v from x, to the scratch; x2 = attn Wo + x
    Acc<BM, C> acc;
    zero_acc<BM, C>(acc);
    gemm_acc<BM, C, C>(acc, XN, LD, wq);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) {
      if (r < nrows) store4(q_out + (row0 + r) * C + c, v);
    });
    zero_acc<BM, C>(acc);
    gemm_acc<BM, C, C>(acc, XN, LD, wk);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) {
      if (r < nrows) store4(k_out + (row0 + r) * C + c, v);
    });
    zero_acc<BM, C>(acc);
    gemm_acc<BM, C, C>(acc, X, LD, wv);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) {
      if (r < nrows) store4(v_out + (row0 + r) * C + c, v);
    });
    zero_acc<BM, C>(acc);
    gemm_acc<BM, C, C>(acc, A, LD, wo);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) {
      store4(X2 + r * LD + c, add4(load4(X + r * LD + c), v));
    });
  }
  __syncthreads();

  // xn2 = LN2(x2) over xn, and its statistics
  for (int r = warp; r < BM; r += NT / 32) {
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) v[e] = X2[r * LD + LN::col(e)];
    float mu, rstd;
    ln_stats<C>(v, mu, rstd);
    if ((tid & 31) == 0) {
      MU2[r] = mu;
      RS2[r] = rstd;
    }
    LN::apply(v, ln + 2 * C, ln + 3 * C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        XN[r * LD + LN::col(e)] = v[e];
        if (r < nrows) xn2_out[(row0 + r) * C + LN::col(e)] = v[e];
      }
  }
  __syncthreads();

  {  // hid = relu(xn2 W1)
    Acc<BM, 2 * C> acc;
    zero_acc<BM, 2 * C>(acc);
    gemm_acc<BM, C, 2 * C>(acc, XN, LD, w1);
    for_tiles<BM, 2 * C>(acc, [&](int r, int c, float4 v) {
      v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      store4(HD + r * LDH + c, v);
      if (r < nrows) store4(hid_out + (row0 + r) * (2 * C) + c, v);
    });
  }
  __syncthreads();

  {  // dpre = (hid > 0) * (dout W2ᵀ), in place over hid
    Acc<BM, 2 * C> acc;
    zero_acc<BM, 2 * C>(acc);
    gemm_acc<BM, C, 2 * C>(acc, DO, LD, w2T);
    for_tiles<BM, 2 * C>(acc, [&](int r, int c, float4 v) {
      const float4 hv = load4(HD + r * LDH + c);
      v = make_float4(hv.x > 0.f ? v.x : 0.f, hv.y > 0.f ? v.y : 0.f,
                      hv.z > 0.f ? v.z : 0.f, hv.w > 0.f ? v.w : 0.f);
      store4(HD + r * LDH + c, v);
      if (r < nrows) store4(dpre_out + (row0 + r) * (2 * C) + c, v);
    });
  }
  __syncthreads();

  {  // dxn2 = dpre W1ᵀ over xn2
    Acc<BM, C> acc;
    zero_acc<BM, C>(acc);
    gemm_acc<BM, 2 * C, C>(acc, HD, LDH, w1T);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) { store4(XN + r * LD + c, v); });
  }
  __syncthreads();

  LnGradAcc<C> g2;
  g2.zero();
  // dx2 = dout + LN2ᵀ(dxn2), in place over x2
  for (int r = warp; r < nrows; r += NT / 32) {
    float xh[LN::E] = {}, d[LN::E] = {};
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        xh[e] = (X2[r * LD + LN::col(e)] - MU2[r]) * RS2[r];
        d[e] = XN[r * LD + LN::col(e)];
      }
    g2.add(d, xh);
    ln_bwd<C>(d, xh, RS2[r], ln + 2 * C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        const float v = DO[r * LD + LN::col(e)] + d[e];
        X2[r * LD + LN::col(e)] = v;
        dx2_out[(row0 + r) * C + LN::col(e)] = v;
      }
  }
  g2.flush(WP, 2, 0);
  __syncthreads();

  {  // dattn = dx2 Woᵀ over dout, and to the scratch
    Acc<BM, C> acc;
    zero_acc<BM, C>(acc);
    gemm_acc<BM, C, C>(acc, X2, LD, woT);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) {
      store4(DO + r * LD + c, v);
      if (r < nrows) store4(dattn_out + (row0 + r) * C + c, v);
    });
  }
  __syncthreads();

  for (int i = tid; i < nrows * H; i += NT) {  // dsum = dattn . attn per head
    const int r = i / H, hh = i % H;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) s = fmaf(DO[r * LD + hh * DH + d], A[r * LD + hh * DH + d], s);
    dsum_out[row0 * H + i] = s;
  }
  block_colsum(WP, 2 * C, ln_part + (static_cast<size_t>(blockIdx.x) * 4 + 2) * C);
}

// b: one pixel a block; tiles are [A2][C + 4], sized by the launch.
template <int C, int H>
__global__ void __launch_bounds__(NT)
    ang_bwd_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dattn,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        const float* __restrict__ dsum, float* __restrict__ dq_out,
                        float* __restrict__ dk_out, float* __restrict__ dv_out, int A2,
                        float scale) {
  constexpr int LD = C + 4, DH = C / H;
  extern __shared__ float4 smem4[];
  float* Q = reinterpret_cast<float*>(smem4);
  float* K = Q + A2 * LD;
  float* V = K + A2 * LD;
  float* DO = V + A2 * LD;
  float* M = DO + A2 * LD;                      // [A2][8] each
  float* Lsum = M + A2 * H;
  float* DS = Lsum + A2 * H;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * A2;
  stage<C>(Q, q, row0, A2);
  stage<C>(K, k, row0, A2);
  stage<C>(V, v, row0, A2);
  stage<C>(DO, dattn, row0, A2);
  for (int i = threadIdx.x; i < A2 * H; i += NT) {
    M[i] = __ldg(m_in + row0 * H + i);
    Lsum[i] = __ldg(l_in + row0 * H + i);
    DS[i] = __ldg(dsum + row0 * H + i);
  }
  __syncthreads();

  // thread (head, t), t fastest. Scores are rebuilt with the forward's
  // arithmetic (q scaled first, then an fmaf chain), so p = exp(s - m) / l
  // uses exactly the forward's s.
  for (int t = threadIdx.x; t < H * A2; t += NT) {
    const int me = t % A2, hh = t / A2;
    float qs[DH], kv[DH], vv[DH], dov[DH], dq[DH], dk[DH], dv[DH];
    ld<DH>(Q + me * LD + hh * DH, qs);
    ld<DH>(K + me * LD + hh * DH, kv);
    ld<DH>(V + me * LD + hh * DH, vv);
    ld<DH>(DO + me * LD + hh * DH, dov);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qs[d] *= scale;
      dq[d] = dk[d] = dv[d] = 0.f;
    }
    const float m_me = M[me * H + hh], inv_me = 1.f / Lsum[me * H + hh];
    const float ds_me = DS[me * H + hh];
    for (int o = 0; o < A2; ++o) {
      float kr[DH], vr[DH], qo[DH], dr[DH];
      ld<DH>(K + o * LD + hh * DH, kr);
      ld<DH>(V + o * LD + hh * DH, vr);
      ld<DH>(Q + o * LD + hh * DH, qo);
      ld<DH>(DO + o * LD + hh * DH, dr);
      // me as the query, o as the key
      float pr = expf(dot<DH>(qs, kr) - m_me) * inv_me;
      float g = pr * (dot<DH>(dov, vr) - ds_me);
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] = fmaf(g, kr[d], dq[d]);
      // o as the query, me as the key
#pragma unroll
      for (int d = 0; d < DH; ++d) qo[d] *= scale;
      pr = expf(dot<DH>(qo, kv) - M[o * H + hh]) / Lsum[o * H + hh];
      g = pr * (dot<DH>(dr, vv) - DS[o * H + hh]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] = fmaf(g, qo[d], dk[d]);
        dv[d] = fmaf(pr, dr[d], dv[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[d] *= scale;
    const size_t off = (row0 + me) * C + hh * DH;
    st<DH>(dq_out + off, dq);
    st<DH>(dk_out + off, dk);
    st<DH>(dv_out + off, dv);
  }
}

template <int C>
struct AngBwdInLayout {
  static constexpr int LD = C + 4;
  static constexpr int TILE = BM * LD;
  static constexpr size_t BYTES = (6 * TILE + (NT / 32) * 2 * C) * sizeof(float);
};

template <int C>
__global__ void __launch_bounds__(NT)
    ang_bwd_in_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                      const float* __restrict__ ln, const float* __restrict__ wqT,
                      const float* __restrict__ wkT, const float* __restrict__ wvT,
                      const float* __restrict__ dq, const float* __restrict__ dk,
                      const float* __restrict__ dv, const float* __restrict__ dx2,
                      float* __restrict__ dx, float* __restrict__ ln_part, int T, int A2) {
  using L = AngBwdInLayout<C>;
  using LN = RowLN<C>;
  constexpr int LD = L::LD;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* DQ = X + L::TILE;
  float* DK = DQ + L::TILE;
  float* DV = DK + L::TILE;
  float* X2 = DV + L::TILE;                     // dx2 -> dx2 + dv Wvᵀ
  float* DN = X2 + L::TILE;                     // dxn
  float* WP = DN + L::TILE;                     // [8 warps][2][C]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int t0 = blockIdx.x * BM;
  const int nrows = min(BM, T - t0);
  const size_t row0 = static_cast<size_t>(t0);
  load_rows<C>(X, LD, x, t0, T);
  load_rows<C>(DQ, LD, dq, t0, T);
  load_rows<C>(DK, LD, dk, t0, T);
  load_rows<C>(DV, LD, dv, t0, T);
  load_rows<C>(X2, LD, dx2, t0, T);
  __syncthreads();

  {  // dxn = dq Wqᵀ + dk Wkᵀ; dx2 + dv Wvᵀ in place
    Acc<BM, C> acc;
    zero_acc<BM, C>(acc);
    gemm_acc<BM, C, C>(acc, DQ, LD, wqT);
    gemm_acc<BM, C, C>(acc, DK, LD, wkT);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) { store4(DN + r * LD + c, v); });
    zero_acc<BM, C>(acc);
    gemm_acc<BM, C, C>(acc, DV, LD, wvT);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 v) {
      store4(X2 + r * LD + c, add4(load4(X2 + r * LD + c), v));
    });
  }
  __syncthreads();

  LnGradAcc<C> g1;
  g1.zero();
  // dx = dx2 + dv Wvᵀ + LN1ᵀ(dxn)
  for (int r = warp; r < nrows; r += NT / 32) {
    float xh[LN::E] = {}, d[LN::E] = {};
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e))
        xh[e] = X[r * LD + LN::col(e)] + __ldg(pe + ((t0 + r) % A2) * C + LN::col(e));
    float mu, rstd;
    ln_stats<C>(xh, mu, rstd);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        xh[e] = (xh[e] - mu) * rstd;
        d[e] = DN[r * LD + LN::col(e)];
      }
    g1.add(d, xh);
    ln_bwd<C>(d, xh, rstd, ln);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e))
        dx[(row0 + r) * C + LN::col(e)] = X2[r * LD + LN::col(e)] + d[e];
  }
  g1.flush(WP, 2, 0);
  __syncthreads();
  block_colsum(WP, 2 * C, ln_part + static_cast<size_t>(blockIdx.x) * 4 * C);
}

// in: x, pe, ln, wq, wk, wv, wo, w1, wqT, wkT, wvT, woT, w1T, w2T, m, l, attn,
// dout; out: dx, xn, dq, dk, dv, dx2, xn2, dpre, hid, ln_part; scratch: q, k,
// v, dattn [T, C], dsum [T, 8].
template <int C>
int launch_bwd128(const float* const* in, float* const* out, float* const* scr, int N, int A2,
                  float scale, cudaStream_t stream) {
  const int T = N * A2;
  auto tok = ang_bwd_tok_kernel<C, 8>;
  auto att = ang_bwd_attn_kernel<C, 8>;
  auto inp = ang_bwd_in_kernel<C>;
  const size_t att_bytes = (4 * A2 * (C + 4) + 3 * A2 * 8) * sizeof(float);
  LFT_SET_SMEM(tok, AngBwdTokLayout<C>::BYTES);
  LFT_SET_SMEM(att, att_bytes);
  LFT_SET_SMEM(inp, AngBwdInLayout<C>::BYTES);
  tok<<<blocks(T), NT, AngBwdTokLayout<C>::BYTES, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[11], in[12], in[13], in[16],
      in[17], out[1], scr[0], scr[1], scr[2], out[5], out[6], out[7], out[8], scr[3], scr[4],
      out[9], T, A2);
  att<<<N, NT, att_bytes, stream>>>(scr[0], scr[1], scr[2], scr[3], in[14], in[15], scr[4],
                                    out[2], out[3], out[4], A2, scale);
  inp<<<blocks(T), NT, AngBwdInLayout<C>::BYTES, stream>>>(
      in[0], in[1], in[2], in[8], in[9], in[10], out[2], out[3], out[4], out[5], out[0], out[9],
      T, A2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// x, out [N, A2, C]; pe [A2, C]; ln [4, C] (LN1 w, b, LN2 w, b); wq/wk/wv/wo
// [C, C], w1 [C, 2C], w2 [2C, C], all "x @ W" layouts; wf a scratch of
// AngLayout<C>::FLOATS floats (kernels/rowgemm.py:ang_block_floats), the
// weights split into TF32 hi/lo by the launch's first kernel. Returns the
// launch's cudaGetLastError(); cudaErrorInvalidValue for a shape it does not
// take.
extern "C" int lft_ang_block_fwd(const float* x, const float* pe, const float* ln,
                                 const float* wq, const float* wk, const float* wv,
                                 const float* wo, const float* w1, const float* w2, float* wf,
                                 float* out, int N, int A2, int C, int H, float scale,
                                 void* stream) {
  if (H != 8 || A2 < 1 || A2 > RP || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define LFT_CASE(CV)                                                                       \
    case CV: return launch<CV, false>(x, pe, ln, wq, wk, wv, wo, w1, w2, wf, out, nullptr, \
                                      nullptr, nullptr, N, A2, scale, s);
    LFT_CASE(16) LFT_CASE(32) LFT_CASE(64)
#undef LFT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same, with the residuals of the backward: m, l [N, A2, H] (per token
// and head, the softmax's max and sum of exp(s - m)) and attn [N, A2, C].
extern "C" int lft_ang_block_fwd_res(const float* x, const float* pe, const float* ln,
                                     const float* wq, const float* wk, const float* wv,
                                     const float* wo, const float* w1, const float* w2,
                                     float* wf, float* out, float* m, float* l, float* attn,
                                     int N, int A2, int C, int H, float scale, void* stream) {
  if (H != 8 || A2 < 1 || A2 > RP || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define LFT_CASE(CV)                                                                    \
    case CV: return launch<CV, true>(x, pe, ln, wq, wk, wv, wo, w1, w2, wf, out, m, l,  \
                                     attn, N, A2, scale, s);
    LFT_CASE(16) LFT_CASE(32) LFT_CASE(64)
#undef LFT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4. Inputs x, pe, ln, wq, wk, wv, wo, w1 (as above), the transposes wqT,
// wkT, wvT, woT [C, C], w1T [2C, C], w2T [C, 2C], the saved m, l, attn, and
// dout [N, A2, C]. Outputs dx [N, A2, C]; xn, dq, dk, dv, dx2, xn2 [T, C]
// and dpre, hid [T, 2C] (T = N A2 tokens), the operands of the weight
// grads; ln_part [blocks, 4, C], each block's sums of the LN affine grads.
extern "C" int lft_ang_block_bwd(
    const float* x, const float* pe, const float* ln, const float* wq, const float* wk,
    const float* wv, const float* wo, const float* w1, const float* wqT, const float* wkT,
    const float* wvT, const float* woT, const float* w1T, const float* w2T, const float* m,
    const float* l, const float* attn, const float* dout, float* dx, float* xn, float* dq,
    float* dk, float* dv, float* dx2, float* xn2, float* dpre, float* hid, float* ln_part,
    int N, int A2, int C, int H, float scale, void* stream) {
  if (H != 8 || A2 < 1 || A2 > RB || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* in[] = {x, pe, ln, wq, wk, wv, wo, w1, wqT, wkT, wvT, woT, w1T, w2T, m, l,
                       attn, dout};
  float* out[] = {dx, xn, dq, dk, dv, dx2, xn2, dpre, hid, ln_part};
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_bwd<16>(in, out, N, A2, scale, s);
    case 32: return launch_bwd<32>(in, out, N, A2, scale, s);
    case 64: return launch_bwd<64>(in, out, N, A2, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4 for every A2 <= 128 (the wrapper sends it 64 < A2 <= 128): inputs and
// outputs as lft_ang_block_bwd, except ln_part [ceil(N A2 / 64), 4, C], plus
// the scratch q, k, v, dattn [T, C] and dsum [T, 8] that its three kernels
// pass through device memory.
extern "C" int lft_ang_block_bwd128(
    const float* x, const float* pe, const float* ln, const float* wq, const float* wk,
    const float* wv, const float* wo, const float* w1, const float* wqT, const float* wkT,
    const float* wvT, const float* woT, const float* w1T, const float* w2T, const float* m,
    const float* l, const float* attn, const float* dout, float* dx, float* xn, float* dq,
    float* dk, float* dv, float* dx2, float* xn2, float* dpre, float* hid, float* ln_part,
    float* q, float* k, float* v, float* dattn, float* dsum, int N, int A2, int C, int H,
    float scale, void* stream) {
  if (H != 8 || A2 < 1 || A2 > RP || N < 1 ||
      static_cast<long long>(N) * A2 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* in[] = {x, pe, ln, wq, wk, wv, wo, w1, wqT, wkT, wvT, woT, w1T, w2T, m, l,
                       attn, dout};
  float* out[] = {dx, xn, dq, dk, dv, dx2, xn2, dpre, hid, ln_part};
  float* scr[] = {q, k, v, dattn, dsum};
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_bwd128<16>(in, out, scr, N, A2, scale, s);
    case 32: return launch_bwd128<32>(in, out, scr, N, A2, scale, s);
    case 64: return launch_bwd128<64>(in, out, scr, N, A2, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
