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
// * The all-bf16 forms, `ang_block_bf16io` and `ang_block_res_bf16io`
//   (`--dtype bfloat16`: x, out and attn bf16) and `ang_block_bf16` and
//   `ang_block_res_bf16` (`--dtype mixed` under LFT_MM_HP_SITES=none: f32
//   IO, every product over bf16-rounded operands), have a kernel of their
//   own: ang_bf16.cuh (resident bf16 weights, bf16 `wgmma`, the attention on
//   `mma.sync`).
// * The site-subset forms, `ang_block_sites` and `ang_block_res_sites`
//   (`--dtype mixed` under an LFT_MM_HP_SITES subset that rounds some of
//   K1's sites and not others: f32 IO and a runtime mask `sites`, a bit a
//   site), have a kernel of their own too: ang_sites.cuh (the rounded
//   products on resident bf16 weights, the f32 ones 3xTF32 on a stream of
//   the others split, the attention on `mma.sync` in bf16 or 3xTF32 by
//   site).

#include "ang_bf16.cuh"
#include "ang_sites.cuh"
#include "attn.cuh"
#include "rowbwd.cuh"

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
// ang_block_stream), written by rg_weights_kernel. The all-bf16 and
// site-subset forms have kernels of their own (ang_bf16.cuh, ang_sites.cuh).
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
        for (int d = 0; d < DH; ++d) st1(attn_out + row * C + hh * DH + d, ar[d]);
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
        const float2 xv = ldg2(x + (row0 + wr + r) * C + c);
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
        *reinterpret_cast<float2*>(HID + (wr + r) * LDH + c) =
            make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      });
      __syncwarp();
      rg_product<HC, C, off + L::W1>(y, HID + wr * LDH, LDH, ring, st);
    });
    rg_pairs<C>(y, [&](int r, int c, float v0, float v1) {
      if (wr + r >= nrows) return;
      const float2 res = *reinterpret_cast<const float2*>(XQ + (wr + r) * LD + c);
      st2(out + (row0 + wr + r) * C + c, v0 + res.x, v1 + res.y);
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
  constexpr size_t BYTES = L::BYTES;
  static_assert(BYTES <= RG_SMEM_MAX, "the rows and the ring must fit");
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
  LFT_SET_SMEM(kernel, BYTES);
  const int P = RP / A2;
  kernel<<<rg_grid((N + P - 1) / P), RG_NT, BYTES, stream>>>(x, pe, ln, wf, out, m, l, attn, N,
                                                              A2, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4: the block's backward ---------------------------------------------
//
// Replaces lft_tpu/kernels/ang_block.py:_vjp_bwd / _bwd_kernel. Three
// kernels for every A2 <= 128 (a pixel's rows are needed together only by
// the attention, so the backward is cut there, as K3 is cut into five
// kernels), the intermediates through device memory:
//   a  ang_bwd_tok_kernel   persistent 128-row tiles of token rows of any
//                           pixels: recompute xn = LN1(x + pe), q = xn Wq,
//                           k = xn Wk, v = x Wv, x2 = attn Wo + x (attn
//                           saved), xn2 = LN2(x2), hid = relu(xn2 W1); then
//                           dpre = (hid > 0) dout W2ᵀ, dxn2 = dpre W1ᵀ,
//                           dx2 = dout + LN2ᵀ(dxn2), dattn = dx2 Woᵀ and
//                           dsum = dattn . attn per head
//   b  ang_bwd_attn_kernel  P whole pixels a block (as many as fill its 256
//                           threads, at least one): from the saved (m, l),
//                           thread (pixel, head, t) computes dq of query t
//                           over the keys and dk, dv of key t over the
//                           queries
//   c  qkv_ln_bwd_kernel<C> (rowbwd.cuh: K3.d's kernel at width C, its three
//                           weights resident): dxn = dq Wqᵀ + dk Wkᵀ,
//                           dx = (dx2 + dv Wvᵀ) + LN1ᵀ(dxn)
// They write dx and the per-token operands of the weight grads (xn, dq, dk,
// dv, dx2, xn2, dpre, hid) and, one row a 128-row tile, the partial column
// sums of the LayerNorm affine grads (ln_part [tiles, 4, C]: c fills rows
// 0-1 of a tile's slot, a rows 2-3); `wgrad`/`colsum` (wgrad.cu) reduce
// them in a fixed order. The TPU kernel accumulated the weight grads across
// its sequential grid; CUDA blocks run in no order, and float atomics would
// make every step's result depend on the schedule. Rows past T are computed
// from zeros and never stored or summed. Every output is written by one
// thread, no atomics: a step repeats bit for bit.
//
// Bound: 28 C^2 FLOP a token in products and 10 A2 C in the attention; at
// [4096, 25, 64] (T = 102,400) 11.7 GFLOP, 0.071 ms as 3 TF32 products at
// 495 TFLOP/s, and 1.6 GFLOP, 0.024 ms on the FP32 pipes; x, attn, dout, m,
// l in and dx, xn, dq, dk, dv, dx2, xn2, dpre, hid out, 3.65 KB a token,
// 374 MB: 0.1115 ms at 3.35 TB/s, so bound by bytes. The scratch q, k, v,
// dattn and dsum add ~0.1 ms of traffic: the design's own floor is ~0.2 ms.
// The first version was one kernel of 64-row blocks of whole pixels, its
// products on the FP32 pipes: a one-kernel form with 128-row tiles of whole
// pixels needs eight C-wide tiles and a hidden tile, ~280 KB at C = 64, and
// a block has 227 KB. So steps a and c are plain token-row kernels on
// rowgemm.cuh's 3xTF32 `wgmma` products, as K3.a and K3.d are:
// * a: K3.a's design at width C (spa_block_bwd.cu): its 11 C^2 weights split
//   (360 KB at C = 64) are one stream in product order (Wv, Wq, Wk, Wo, per
//   hidden chunk W1[:, c], W2ᵀ[:, c], W1ᵀ[c, :], then Woᵀ: kernels/
//   rowgemm.py:ang_bwd_tok_layout), through `MbarRing`; rows read and
//   outputs written once are marked evict-first, so they leave the stream
//   in L2. The LayerNorms are K1's (quad_ln) and x is added to attn Wo's
//   finished product, but every product issues its tail MMAs first,
//   K1's recomputed ones too: with K1's default order q and k (K = 16 or
//   32 at C = 16 or 32: one or two chains) carried up to twice the f32
//   product's error, and dk, through the scores, 2.1-2.2x the f32 plain
//   backward's float64 error at A2 = 25 (an H100; tails first: at most
//   1.61x at every C and A2 tried). So the scores match K1's to f32
//   rounding, not bit for bit; (m, l) normalise them to that rounding.
//   One hidden chunk at a time: hid_c, its signs in a register, dpre_c,
//   dxn2 += dpre_c W1ᵀ[c, :]. LN2's backward runs on the accumulators
//   (rowbwd.cuh:quad_ln_bwd), and dsum on dattn's, a head's columns in the
//   lanes of a quad. Every output goes from the accumulators to the warp's
//   rows in shared memory and from there to device memory as whole
//   128-byte lines (the hidden chunk's tile stages q, k, v and dattn): the
//   outputs' stores took 0.135 of the kernel's 0.36 ms at [4096, 25, 64],
//   and staged they ran 1-6% faster than float2 stores from the
//   accumulators (an H100, scratch A/B).
// * b: the attention stays on the FP32 pipes; scores are rebuilt with the
//   forward's arithmetic (q scaled first, then an fmaf chain).
// * c: the three weights split take 96 KB at C = 64 and stay resident.
// `--dtype mixed` (lft_tpu's backward plan `none`: both operands of every
// product rounded to bf16, f32 accumulation, lft_tpu/kernels/ang_block.py:
// _bwd_kernel :307-378) runs the three kernels' BF instances
// (`lft_ang_block_bwd_bf16`): a's and c's products one TF32 pass over the
// rounded operands (rowgemm.cuh; a writes no dsum); b rounds q, k, v and
// dattn as it stages them, takes s = (q . k) scale as lft_tpu does, first
// D = sum_j p_j dp_j a query from those products (a pass over the keys
// before the gradients), and rounds ds = p (dp - D) scale (the scale inside)
// and p before their products. The saved (m, l) are the f32 forward's: p
// is not renormalised.
// `--dtype mixed` with the forward under LFT_MM_HP_SITES=none and this
// backward under LFT_MM_HP_BWD_SITES=all (`lft_ang_block_bwd_dp`): the f32
// instances of a and c, and b forming D = sum_j p_j dp_j from its own f32
// products as BF's b does (lft_tpu forms D so, :360-362). dsum = dattn .
// attn equals that D only where the saved attn is this backward's sum p v;
// here it is the rounded forward's. Bound as the f32 instance's.
// `--dtype bfloat16` training (`lft_ang_block_bwd_bf16io`, lft_tpu's
// _bwd_kernel with io = bf16, :305-394): the BF instances on bf16 x, attn
// and dout (rowbwd.cuh: rows widened to f32 as loaded), with K1 res's
// bf16-IO (m, l); a recomputes x2 = bf16(bf16(attn Wo) + x) as K1 rounds
// it, and writes xn, xn2, hid and dpre as bf16 (lft_tpu's operands of the
// weight grads) and dx2 as f32 (lft_tpu keeps it f32: dx starts from it);
// b writes dq, dk, dv as bf16, each summed in f32 and rounded once; c reads
// them and x in bf16 and writes dx = bf16((dx2 + dv Wvᵀ) + LN1ᵀ(dxn)). q,
// k, v and dattn pass from a to b in f32 as before, rounded as b stages
// them. Bound at [4096, 25, 64]: x, attn, dout, dx, xn, dq, dk, dv, xn2
// and the 2C-wide hid, dpre in bf16, dx2 in f32 and m, l: 1.92 KB a token,
// 197 MB, 0.059 ms; the products at the bf16 rate 0.012 ms.
// `--dtype mixed` under an LFT_MM_HP_BWD_SITES subset that rounds some of
// K4's sites and not others (`lft_ang_block_bwd_sites`, counted
// `ang_block_bwd[128]_sites`; lft_tpu's _bwd_kernel with that plan,
// :307-385): f32 IO and a runtime mask `sites` (tf32.cuh: S_AQKV ..
// S_AFFN). a: each product BF or 3xTF32 as its site's bit says
// (rowgemm.cuh: rg_product_site; a uniform branch): the recomputed q, k, v
// by `aqkv`, x2 and dattn by `awo`, the FFN's three by `affn`; its stream
// split piece by piece to match; no dsum. b: BF's arithmetic (D first from
// its own products, s = (q . k) scale, ds with the scale inside), q, k and
// ds rounded where `ascore` rounds, v, dattn and p where `aav` does. c
// computes one site (`aqkv`) and runs its f32 or BF instance whole. A subset
// that rounds none of K4's sites takes `_dp` (after a forward that rounded)
// or the f32 instance, one that rounds all of them `_bf16`. Bound: the
// products at the bf16 rate where their site rounds and as 3xTF32 where it
// does not; bytes as the f32 instance's.

// The weight stream of step a and the block's shared memory.
template <int C>
struct AngBwdTok {
  static constexpr int HC = 2 * C < 64 ? 2 * C : 64;   // hidden columns a chunk
  static constexpr int NH = 2 * C / HC;                 // chunks
  static constexpr int LD = C + 4, LDH = HC + 4;        // row strides
  static constexpr int SQ = 2 * C * C;                  // floats of a C x C piece
  static constexpr int PC = 2 * C * HC;                 // floats of a chunk's piece
  static constexpr int OFF_V = 0, OFF_Q = SQ, OFF_K = 2 * SQ, OFF_O = 3 * SQ, OFF_F = 4 * SQ;
  static constexpr int OFF_OT = OFF_F + NH * 3 * PC;    // Woᵀ
  static constexpr int FLOATS = OFF_OT + SQ;            // the stream
  static constexpr int PIECES = 5 + 3 * NH;
  // rows: x / x2 / dx2, xn / attn / xn2 and dout [128][LD], a hidden chunk
  // [128][LDH]; the 8 warps' LN2 sums [8][2][C]
  static constexpr int TILES = (RG_M * (3 * LD + LDH) + 16 * C) * 4;
  static constexpr int NS = rg_slots(TILES + 16 * 8);   // the ring and its 2 NS mbarriers
  static constexpr size_t BYTES = TILES + static_cast<size_t>(NS) * RG_SF * 4 + 2 * NS * 8;
  static_assert(BYTES <= RG_SMEM_MAX, "the rows and the ring must fit in shared memory");
};

// a. wf: the weight stream (AngBwdTok<C>::FLOATS floats), written by
// rg_weights_kernel. q, k, v, dattn [T, C] and dsum [T, H]: step b's
// inputs; ln_part [tiles, 4, C], rows 2-3 (LN2). BF: products over bf16
// operands, and no dsum (step b's BF instance forms D itself). SITES (f32
// IO): each product BF where its site's bit of `sites` is set, no dsum.
template <int C, int H, bool BF = false, class IO = float, bool SITES = false>
__global__ void __launch_bounds__(RG_NT, 1)
    ang_bwd_tok_kernel(const IO* __restrict__ x, const float* __restrict__ pe,
                       const float* __restrict__ ln, const IO* __restrict__ attn,
                       const IO* __restrict__ dout, const float* __restrict__ wf,
                       IO* __restrict__ xn_out, float* __restrict__ q_out,
                       float* __restrict__ k_out, float* __restrict__ v_out,
                       IO* __restrict__ xn2_out, IO* __restrict__ hid_out,
                       IO* __restrict__ dpre_out, float* __restrict__ dx2_out,
                       float* __restrict__ dattn_out, float* __restrict__ dsum_out,
                       float* __restrict__ ln_part, int T, int A2, int sites) {
  static_assert(BF || !is_bf16<IO>, "bf16 IO takes the BF products");
  static_assert(!SITES || (!BF && !is_bf16<IO>), "a `_sites` instance is f32 IO with its own mask");
  const bool r_qkv = (sites & S_AQKV) != 0, r_wo = (sites & S_AWO) != 0,
             r_ffn = (sites & S_AFFN) != 0;
  using L = AngBwdTok<C>;
  constexpr int LD = L::LD, LDH = L::LDH, HC = L::HC, DH = C / H;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xw = smem + 16 * warp * LD;                    // x, then x2, then dx2
  float* nw = smem + RG_M * LD + 16 * warp * LD;        // xn, then attn, then xn2
  float* dw = smem + 2 * RG_M * LD + 16 * warp * LD;    // dout
  float* hw = smem + 3 * RG_M * LD + 16 * warp * LDH;   // a hidden chunk; outputs staged
  float* part = smem + RG_M * (3 * LD + LDH);           // [8 warps][2][C] LN2 sums
  float* slots = part + 16 * C;
  const int tiles = (T + RG_M - 1) / RG_M;
  MbarRing<L::NS> ring;
  ring.start(slots, reinterpret_cast<uint64_t*>(slots + L::NS * RG_SF), wf, L::FLOATS,
             (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x);
  const float* st = nullptr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;   // the warp's first token
    warp_rows<C>(xw, LD, x, t0, T);

    {  // xn = LN1(x + pe), as K1 computes it
      RgAcc<C> a;
      rg_pairs<C>(a, [&](int r, int c, float& v0, float& v1) {
        const float2 xv = *reinterpret_cast<const float2*>(xw + r * LD + c);
        const float2 pv = __ldg(reinterpret_cast<const float2*>(pe + ((t0 + r) % A2) * C + c));
        v0 = xv.x + pv.x;
        v1 = xv.y + pv.y;
      });
      quad_ln<C>(a, ln, ln + C);
      put_tile<C>(a, nw, LD);
      store_rows<C>(nw, LD, xn_out, C, 0, t0, T);
    }
    {  // v = x Wv, q = xn Wq, k = xn Wk, into step b's scratch
      RgAcc<C> a;
      rg_zero<C>(a);
      if constexpr (SITES)
        rg_product_site<C, C, L::OFF_V, false, true, true>(r_qkv, a, xw, LD, ring, st);
      else
        rg_product<C, C, L::OFF_V, true, BF>(a, xw, LD, ring, st);
      put_tile<C>(a, hw, LDH);
      store_rows<C, true>(hw, LDH, v_out, C, 0, t0, T);
      rg_zero<C>(a);
      if constexpr (SITES)
        rg_product_site<C, C, L::OFF_Q, false, true, true>(r_qkv, a, nw, LD, ring, st);
      else
        rg_product<C, C, L::OFF_Q, true, BF>(a, nw, LD, ring, st);
      put_tile<C>(a, hw, LDH);
      store_rows<C, true>(hw, LDH, q_out, C, 0, t0, T);
      rg_zero<C>(a);
      if constexpr (SITES)
        rg_product_site<C, C, L::OFF_K, false, true, true>(r_qkv, a, nw, LD, ring, st);
      else
        rg_product<C, C, L::OFF_K, true, BF>(a, nw, LD, ring, st);
      put_tile<C>(a, hw, LDH);
      store_rows<C, true>(hw, LDH, k_out, C, 0, t0, T);
    }
    warp_rows<C>(nw, LD, attn, t0, T);   // xn is read
    float mu[2], rstd[2];
    {  // x2 = attn Wo + x (x added to the finished product), xn2 = LN2(x2)
      RgAcc<C> a;
      rg_zero<C>(a);
      if constexpr (SITES)
        rg_product_site<C, C, L::OFF_O, false, true, true>(r_wo, a, nw, LD, ring, st);
      else
        rg_product<C, C, L::OFF_O, true, BF>(a, nw, LD, ring, st);
      rg_pairs<C>(a, [&](int r, int c, float& v0, float& v1) {
        const float2 xv = *reinterpret_cast<const float2*>(xw + r * LD + c);
        v0 = io_round<IO>(io_round<IO>(v0) + xv.x);
        v1 = io_round<IO>(io_round<IO>(v1) + xv.y);
      });
      put_tile<C>(a, xw, LD);   // x2 over x
      quad_ln<C, true>(a, ln + 2 * C, ln + 3 * C, mu, rstd);
      put_tile<C>(a, nw, LD);   // xn2 over attn
      store_rows<C>(nw, LD, xn2_out, C, 0, t0, T);
    }
    warp_rows<C>(dw, LD, dout, t0, T);

    // a hidden chunk at a time: hid_c = relu(xn2 W1[:, c]),
    // dpre_c = (hid_c > 0) dout W2ᵀ[:, c], dxn2 += dpre_c W1ᵀ[c, :]
    RgAcc<C> dxn;
    rg_zero<C>(dxn);
    rg_static_for<L::NH>([&](auto J) {
      constexpr int j = decltype(J)::value, off = L::OFF_F + j * 3 * L::PC;
      RgAcc<HC> hc;
      rg_zero<HC>(hc);
      if constexpr (SITES)
        rg_product_site<C, HC, off, false, true, true>(r_ffn, hc, nw, LD, ring, st);
      else
        rg_product<C, HC, off, true, BF>(hc, nw, LD, ring, st);
      uint32_t on = 0;   // the ReLU's signs, bit i: element i
#pragma unroll
      for (int i = 0; i < RgParts<HC>::R; ++i) {
        on |= (hc[0][i] > 0.f ? 1u : 0u) << i;
        hc[0][i] = fmaxf(hc[0][i], 0.f);
      }
      put_tile<HC>(hc, hw, LDH);
      store_rows<HC>(hw, LDH, hid_out, 2 * C, j * HC, t0, T);
      rg_zero<HC>(hc);
      if constexpr (SITES)
        rg_product_site<C, HC, off + L::PC, false, true, true>(r_ffn, hc, dw, LD, ring, st);
      else
        rg_product<C, HC, off + L::PC, true, BF>(hc, dw, LD, ring, st);
#pragma unroll
      for (int i = 0; i < RgParts<HC>::R; ++i)
        if (!((on >> i) & 1u)) hc[0][i] = 0.f;
      put_tile<HC>(hc, hw, LDH);
      store_rows<HC>(hw, LDH, dpre_out, 2 * C, j * HC, t0, T);
      if constexpr (SITES)
        rg_product_site<HC, C, off + 2 * L::PC, false, true, true>(r_ffn, dxn, hw, LDH, ring,
                                                                   st);
      else
        rg_product<HC, C, off + 2 * L::PC, true, BF>(dxn, hw, LDH, ring, st);
    });

    {  // dx2 = dout + LN2ᵀ(dxn2) on the accumulators, xhat from x2 as LN2 made it
      RgAcc<C> xh;
      rg_each<C>([&](int p, int i, int r, int c) {
        const float2 v = *reinterpret_cast<const float2*>(xw + r * LD + c);
        const float m = i & 2 ? mu[1] : mu[0], rs = i & 2 ? rstd[1] : rstd[0];   // row g + 8 h
        xh[p][i] = (v.x - m) * rs;
        xh[p][i + 1] = (v.y - m) * rs;
      });
      quad_ln_bwd<C>(dxn, xh, rstd, ln + 2 * C, part + warp * 2 * C);
      rg_pairs<C>(dxn, [&](int r, int c, float& v0, float& v1) {
        const float2 d = *reinterpret_cast<const float2*>(dw + r * LD + c);
        v0 = d.x + v0;
        v1 = d.y + v1;
      });
      put_tile<C>(dxn, xw, LD);   // dx2 over x2
      store_rows<C>(xw, LD, dx2_out, C, 0, t0, T);
    }
    {  // dattn = dx2 Woᵀ; dsum = dattn . attn per head (attn read again)
      RgAcc<C> a;
      rg_zero<C>(a);
      if constexpr (SITES)
        rg_product_site<C, C, L::OFF_OT, false, true, true>(r_wo, a, xw, LD, ring, st);
      else
        rg_product<C, C, L::OFF_OT, true, BF>(a, xw, LD, ring, st);
      put_tile<C>(a, hw, LDH);
      store_rows<C, true>(hw, LDH, dattn_out, C, 0, t0, T);
      constexpr int LH = DH / 2;   // lanes of a quad that hold a head of a row
      if constexpr (!BF && !SITES) rg_each<C>([&](int p, int i, int r, int c) {
        const int t = t0 + r;
        const float2 av =
            t < T ? __ldcs(reinterpret_cast<const float2*>(attn + static_cast<size_t>(t) * C + c))
                  : make_float2(0.f, 0.f);
        float s = fmaf(a[p][i + 1], av.y, a[p][i] * av.x);
#pragma unroll
        for (int o = 1; o < LH; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (t < T && (lane & (LH - 1)) == 0) dsum_out[static_cast<size_t>(t) * H + c / DH] = s;
      });
    }
    tile_ln_sums<C>(part, ln_part + static_cast<size_t>(tile) * 4 * C + 2 * C);
  }
}

// b. P pixels a block (attn_pixels), tiles [P A2][C + 4] sized by the launch.
// BF: the header's arithmetic; dsum is not read. BF or DP: D = sum_j p_j
// dp_j formed here in a first pass over the keys instead of read from dsum
// (= dattn . attn, which equals it only where the saved attn is this
// backward's sum p v); DP alone the `_dp` instance, f32 products after a
// forward that rounded its products (LFT_MM_HP_SITES=none). SITES (f32 IO):
// BF's arithmetic, q, k and ds rounded where `ascore`'s bit of `sites` is
// set, v, dattn and p where `aav`'s is.
template <int C, int H, bool BF = false, class IO = float, bool DP = false, bool SITES = false>
__global__ void __launch_bounds__(NT)
    ang_bwd_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dattn,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        const float* __restrict__ dsum, IO* __restrict__ dq_out,
                        IO* __restrict__ dk_out, IO* __restrict__ dv_out, int N, int A2,
                        int P, float scale, int sites) {
  static_assert(!SITES || (!BF && !DP && !is_bf16<IO>), "a `_sites` instance is f32 IO");
  constexpr int LD = C + 4, DH = C / H;
  const bool r_sc = (sites & S_ASCORE) != 0, r_av = (sites & S_AAV) != 0;
  extern __shared__ float4 smem4[];
  const int pix0 = blockIdx.x * P, np = min(P, N - pix0), rows = np * A2;
  float* Q = reinterpret_cast<float*>(smem4);
  float* K = Q + P * A2 * LD;
  float* V = K + P * A2 * LD;
  float* DO = V + P * A2 * LD;
  float* M = DO + P * A2 * LD;                  // [P A2][H] each
  float* Lsum = M + P * A2 * H;
  float* DS = Lsum + P * A2 * H;
  const size_t row0 = static_cast<size_t>(pix0) * A2;
  stage<C>(Q, q, row0, rows);
  stage<C>(K, k, row0, rows);
  stage<C>(V, v, row0, rows);
  stage<C>(DO, dattn, row0, rows);
  if constexpr (BF) {   // the elements this thread staged, rounded to bf16
    for (int i = threadIdx.x; i < rows * (C / 4); i += NT) {
      const int off = i / (C / 4) * (C + 4) + 4 * (i % (C / 4));
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float* p = Q + b * P * A2 * (C + 4) + off;
        const float4 t = load4(p);
        store4(p, make_float4(bf16_round(t.x), bf16_round(t.y), bf16_round(t.z),
                              bf16_round(t.w)));
      }
    }
  }
  if constexpr (SITES) {   // q, k where `ascore` rounds; v, dattn where `aav` does
    if (r_sc || r_av)
      for (int i = threadIdx.x; i < rows * (C / 4); i += NT) {
        const int off = i / (C / 4) * (C + 4) + 4 * (i % (C / 4));
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (!(b < 2 ? r_sc : r_av)) continue;
          float* p = Q + b * P * A2 * (C + 4) + off;
          const float4 t = load4(p);
          store4(p, make_float4(bf16_round(t.x), bf16_round(t.y), bf16_round(t.z),
                                bf16_round(t.w)));
        }
      }
  }
  for (int i = threadIdx.x; i < rows * H; i += NT) {
    M[i] = __ldg(m_in + row0 * H + i);
    Lsum[i] = __ldg(l_in + row0 * H + i);
    if constexpr (!(BF || DP || SITES)) DS[i] = __ldg(dsum + row0 * H + i);
  }
  __syncthreads();
  if constexpr (BF || DP || SITES) {   // D = sum_j p_j dp_j of each (query, head), into DS
    for (int t = threadIdx.x; t < np * H * A2; t += NT) {
      const int hh = (t / A2) % H, base = t / (A2 * H) * A2;
      const int me = base + t % A2;
      float qs[DH], dov[DH];
      ld<DH>(Q + me * LD + hh * DH, qs);
      ld<DH>(DO + me * LD + hh * DH, dov);
      const float m_me = M[me * H + hh], inv_me = 1.f / Lsum[me * H + hh];
      float d = 0.f;
      for (int o = base; o < base + A2; ++o) {
        float kr[DH], vr[DH];
        ld<DH>(K + o * LD + hh * DH, kr);
        ld<DH>(V + o * LD + hh * DH, vr);
        d = fmaf(expf(dot<DH>(qs, kr) * scale - m_me) * inv_me, dot<DH>(dov, vr), d);
      }
      DS[me * H + hh] = d;
    }
    __syncthreads();
  }

  // thread (pixel, head, t), t fastest. Scores are rebuilt with the
  // forward's arithmetic (q scaled first, then an fmaf chain).
  for (int t = threadIdx.x; t < np * H * A2; t += NT) {
    const int hh = (t / A2) % H, base = t / (A2 * H) * A2;
    const int me = base + t % A2;
    float qs[DH], kv[DH], vv[DH], dov[DH], dq[DH], dk[DH], dv[DH];
    ld<DH>(Q + me * LD + hh * DH, qs);
    ld<DH>(K + me * LD + hh * DH, kv);
    ld<DH>(V + me * LD + hh * DH, vv);
    ld<DH>(DO + me * LD + hh * DH, dov);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if constexpr (!BF && !SITES) qs[d] *= scale;
      dq[d] = dk[d] = dv[d] = 0.f;
    }
    const float m_me = M[me * H + hh], inv_me = 1.f / Lsum[me * H + hh];
    const float ds_me = DS[me * H + hh];
    for (int o = base; o < base + A2; ++o) {
      float kr[DH], vr[DH], qo[DH], dr[DH];
      ld<DH>(K + o * LD + hh * DH, kr);
      ld<DH>(V + o * LD + hh * DH, vr);
      ld<DH>(Q + o * LD + hh * DH, qo);
      ld<DH>(DO + o * LD + hh * DH, dr);
      // me as the query, o as the key
      if constexpr (SITES) {   // BF's arithmetic, ds rounded by `ascore`, p by `aav`
        float pr = expf(dot<DH>(qs, kr) * scale - m_me) * inv_me;
        float g = pr * (dot<DH>(dov, vr) - ds_me) * scale;
        g = r_sc ? bf16_round(g) : g;
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] = fmaf(g, kr[d], dq[d]);
        // o as the query, me as the key
        pr = expf(dot<DH>(qo, kv) * scale - M[o * H + hh]) * (1.f / Lsum[o * H + hh]);
        g = pr * (dot<DH>(dr, vv) - DS[o * H + hh]) * scale;
        g = r_sc ? bf16_round(g) : g;
        pr = r_av ? bf16_round(pr) : pr;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dk[d] = fmaf(g, qo[d], dk[d]);
          dv[d] = fmaf(pr, dr[d], dv[d]);
        }
        continue;
      }
      if constexpr (BF) {
        float pr = expf(dot<DH>(qs, kr) * scale - m_me) * inv_me;
        float g = bf16_round(pr * (dot<DH>(dov, vr) - ds_me) * scale);
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] = fmaf(g, kr[d], dq[d]);
        // o as the query, me as the key
        pr = expf(dot<DH>(qo, kv) * scale - M[o * H + hh]) * (1.f / Lsum[o * H + hh]);
        g = bf16_round(pr * (dot<DH>(dr, vv) - DS[o * H + hh]) * scale);
        pr = bf16_round(pr);
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dk[d] = fmaf(g, qo[d], dk[d]);
          dv[d] = fmaf(pr, dr[d], dv[d]);
        }
        continue;
      }
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
    if constexpr (!BF && !SITES) {
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] *= scale;
    }
    const size_t off = (row0 + me) * C + hh * DH;
    st<DH>(dq_out + off, dq);
    st<DH>(dk_out + off, dk);
    st<DH>(dv_out + off, dv);
  }
}

// Pixels a block of step b: as many as fill its NT threads (one thread a
// pixel, head and view), at least one (kernels/ang_block.py:
// ang_bwd_attn_pixels).
inline int attn_pixels(int A2) { return NT / (8 * A2) > 1 ? NT / (8 * A2) : 1; }

// K4's arguments: the inputs, outputs and scratch of the C interface below,
// the activations in IO.
template <class IO>
struct AngBwdArgs {
  const IO* x;
  const float *pe, *ln, *wq, *wk, *wv, *wo, *w1, *w2, *m, *l;
  const IO *attn, *dout;
  float* wf;
  IO *dx, *xn, *dq, *dk, *dv;
  float* dx2;
  IO *xn2, *dpre, *hid;
  float *ln_part, *q, *k, *v, *dattn, *dsum;
};

// BF: the three kernels' bf16-operand instances (the header); IO = bf16
// (with BF) their bf16-IO instances; DP step b's `_dp` instance; SITES the
// `_sites` instances of a and b with the mask `sites`, step a's stream split
// piece by piece (Wv, Wq, Wk `aqkv`; Wo, Woᵀ `awo`; the FFN's `affn`), and
// step c's f32 or BF instance as `aqkv` says.
template <int C, bool BF = false, class IO = float, bool DP = false, bool SITES = false>
int launch_bwd(const AngBwdArgs<IO>& g, int N, int A2, float scale, cudaStream_t s,
               int sites = 0) {
  using L = AngBwdTok<C>;
  constexpr int H = 8;
  const int T = N * A2;
  const float *pe = g.pe, *ln = g.ln, *wq = g.wq, *wk = g.wk, *wv = g.wv, *wo = g.wo,
              *w1 = g.w1, *w2 = g.w2;
  float* wf = g.wf;
  // step a's stream, the backward's transposes read straight from the weights
  RgPiece all[L::PIECES];
  int n = 0;
  all[n++] = RgPiece{wv, C, C, C, L::OFF_V, 0};
  all[n++] = RgPiece{wq, C, C, C, L::OFF_Q, 0};
  all[n++] = RgPiece{wk, C, C, C, L::OFF_K, 0};
  all[n++] = RgPiece{wo, C, C, C, L::OFF_O, 0};
  for (int j = 0; j < L::NH; ++j) {
    const int off = L::OFF_F + j * 3 * L::PC;
    all[n++] = RgPiece{w1 + j * L::HC, 2 * C, C, L::HC, off, 0};                // W1[:, c]
    all[n++] = RgPiece{w2 + j * L::HC * C, C, C, L::HC, off + L::PC, 1};         // W2ᵀ[:, c]
    all[n++] = RgPiece{w1 + j * L::HC, 2 * C, L::HC, C, off + 2 * L::PC, 1};     // W1ᵀ[c, :]
  }
  all[n++] = RgPiece{wo, C, C, C, L::OFF_OT, 1};                                // Woᵀ
  if constexpr (SITES)
    for (int i = 0; i < n; ++i)
      all[i].bf = (sites & (i < 3 ? S_AQKV : i == 3 || i == n - 1 ? S_AWO : S_AFFN)) != 0;
  launch_rg_pieces(all, n, wf, s, BF, SITES);
  auto tok = ang_bwd_tok_kernel<C, H, BF, IO, SITES>;
  LFT_SET_SMEM(tok, L::BYTES);
  tok<<<rg_grid((T + RG_M - 1) / RG_M), RG_NT, L::BYTES, s>>>(
      g.x, pe, ln, g.attn, g.dout, wf, g.xn, g.q, g.k, g.v, g.xn2, g.hid, g.dpre, g.dx2,
      g.dattn, g.dsum, g.ln_part, T, A2, sites);
  const int P = attn_pixels(A2);
  auto att = ang_bwd_attn_kernel<C, H, BF, IO, DP, SITES>;
  const size_t att_bytes = static_cast<size_t>(P) * A2 * (4 * (C + 4) + 3 * H) * sizeof(float);
  LFT_SET_SMEM(att, att_bytes);
  att<<<(N + P - 1) / P, NT, att_bytes, s>>>(g.q, g.k, g.v, g.dattn, g.m, g.l, g.dsum, g.dq,
                                            g.dk, g.dv, N, A2, P, scale, sites);
  const QkvLnBwdArgs<IO> a{g.x, pe, g.dq, g.dk, g.dv, g.dx2, ln, nullptr, g.dx, nullptr,
                           g.ln_part, A2, 4 * C, T};
  if constexpr (SITES)   // step c: one site, `aqkv`
    if (sites & S_AQKV) return launch_qkv_ln_bwd<C, true, IO>(a, wq, wk, C, wv, wf + L::FLOATS, s);
  return launch_qkv_ln_bwd<C, BF, IO>(a, wq, wk, C, wv, wf + L::FLOATS, s);
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

// The all-bf16 forms (the K1 header; their kernel: ang_bf16.cuh). wf is a
// scratch of AngBf16<C>::ELEMS bf16 values (kernels/rowgemm.py:
// ang_bf16_floats floats) for the weights rounded to bf16. The bf16-operand instance (`--dtype mixed` serving under
// LFT_MM_HP_SITES=none): lft_ang_block_fwd's arguments.
#define LFT_ANG_BF16(RES, IO, ...)                                                       \
  if (H != 8 || A2 < 1 || A2 > RP || N < 1) return static_cast<int>(cudaErrorInvalidValue); \
  const auto s = static_cast<cudaStream_t>(stream);                                      \
  bf16* wb = reinterpret_cast<bf16*>(wf);                                                \
  LFT_DISPATCH_C(C, {                                                                    \
    return launch_ang_bf16<CC, RES, IO>(x, pe, ln, wq, wk, wv, wo, w1, w2, wb, out,      \
                                        __VA_ARGS__, N, A2, scale, s);                   \
  });                                                                                    \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int lft_ang_block_fwd_bf16(const float* x, const float* pe, const float* ln,
                                      const float* wq, const float* wk, const float* wv,
                                      const float* wo, const float* w1, const float* w2,
                                      float* wf, float* out, int N, int A2, int C, int H,
                                      float scale, void* stream) {
  LFT_ANG_BF16(false, float, nullptr, nullptr, nullptr)
}

// The bf16-IO instance (`--dtype bfloat16`): x and out bf16 [N, A2, C]; pe,
// ln and the weights f32 (the weights' bf16 values).
extern "C" int lft_ang_block_fwd_bf16io(const bf16* x, const float* pe, const float* ln,
                                        const float* wq, const float* wk, const float* wv,
                                        const float* wo, const float* w1, const float* w2,
                                        float* wf, bf16* out, int N, int A2, int C, int H,
                                        float scale, void* stream) {
  LFT_ANG_BF16(false, bf16, nullptr, nullptr, nullptr)
}

// The same, with the residuals of the backward: m, l [N, A2, H] (per token
// and head, the softmax's max and sum of exp(s - m)) and attn [N, A2, C].
// The bf16-IO instance with the residuals (`--dtype bfloat16` training): x,
// out and attn bf16; m, l f32 (m the token's max over its heads, in each
// head's slot; l each head's sum under it).
extern "C" int lft_ang_block_fwd_res_bf16io(const bf16* x, const float* pe, const float* ln,
                                            const float* wq, const float* wk, const float* wv,
                                            const float* wo, const float* w1, const float* w2,
                                            float* wf, bf16* out, float* m, float* l, bf16* attn,
                                            int N, int A2, int C, int H, float scale,
                                            void* stream) {
  LFT_ANG_BF16(true, bf16, m, l, attn)
}

// The bf16-operand instance with the residuals (`--dtype mixed` training
// under LFT_MM_HP_SITES=none): lft_ang_block_fwd_res's arguments; m the
// token's max over its heads in every head's slot, l each head's sum of the
// unrounded e, attn f32 holding bf16 values (lft_tpu stores it at the `awo`
// site's dtype).
extern "C" int lft_ang_block_fwd_res_bf16(const float* x, const float* pe, const float* ln,
                                          const float* wq, const float* wk, const float* wv,
                                          const float* wo, const float* w1, const float* w2,
                                          float* wf, float* out, float* m, float* l,
                                          float* attn, int N, int A2, int C, int H,
                                          float scale, void* stream) {
  LFT_ANG_BF16(true, float, m, l, attn)
}
#undef LFT_ANG_BF16

// The site-subset instances (`--dtype mixed` under an LFT_MM_HP_SITES
// subset; the K1 header, their kernel: ang_sites.cuh): lft_ang_block_fwd's
// and lft_ang_block_fwd_res's arguments and `sites`, the mask of the sites
// whose operands round (tf32.cuh: S_AQKV .. S_AFFN), some of K1's five and
// not all; wf a scratch of AngSites<C>::FLOATS floats (kernels/rowgemm.py:
// ang_sites_floats) for the weights rounded or split as their sites say. m,
// l and attn as `_res_bf16`'s, attn rounded where `awo` rounds.
#define LFT_ANG_SITES(RES, ...)                                                            \
  if (H != 8 || A2 < 1 || A2 > RP || N < 1) return static_cast<int>(cudaErrorInvalidValue); \
  const auto s = static_cast<cudaStream_t>(stream);                                        \
  LFT_DISPATCH_C(C, {                                                                      \
    return launch_ang_sites<CC, RES>(x, pe, ln, wq, wk, wv, wo, w1, w2, wf, out,           \
                                     __VA_ARGS__, N, A2, scale, sites, s);                 \
  });                                                                                      \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int lft_ang_block_fwd_sites(const float* x, const float* pe, const float* ln,
                                       const float* wq, const float* wk, const float* wv,
                                       const float* wo, const float* w1, const float* w2,
                                       float* wf, float* out, int N, int A2, int C, int H,
                                       float scale, int sites, void* stream) {
  LFT_ANG_SITES(false, nullptr, nullptr, nullptr)
}

extern "C" int lft_ang_block_fwd_res_sites(const float* x, const float* pe, const float* ln,
                                           const float* wq, const float* wk, const float* wv,
                                           const float* wo, const float* w1, const float* w2,
                                           float* wf, float* out, float* m, float* l,
                                           float* attn, int N, int A2, int C, int H,
                                           float scale, int sites, void* stream) {
  LFT_ANG_SITES(true, m, l, attn)
}
#undef LFT_ANG_SITES

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

// K4 for every A2 <= 128. x, dout, dx [N, A2, C]; pe [A2, C]; ln [4, C]; the
// weights as lft_ang_block_fwd takes them (the backward's transposes are
// read from them by the launch's first kernels into wf, a scratch of
// AngBwdTok<C>::FLOATS + QkvLnBwd<C>::FLOATS floats, kernels/rowgemm.py:
// ang_bwd_floats); the saved m, l [N, A2, H] and attn. Outputs xn, dq, dk,
// dv, dx2, xn2 [T, C] and dpre, hid [T, 2C] (T = N A2 tokens), the operands
// of the weight grads, and ln_part [ceil(T / 128), 4, C], each 128-row
// tile's sums of the LN affine grads; q, k, v, dattn [T, C] and dsum [T, H]
// are the scratch its three kernels pass through device memory.
#define LFT_ANG_BWD_ARGS(IO)                                                              \
  const IO *x, const float *pe, const float *ln, const float *wq, const float *wk,        \
      const float *wv, const float *wo, const float *w1, const float *w2, const float *m, \
      const float *l, const IO *attn, const IO *dout, float *wf, IO *dx, IO *xn, IO *dq,  \
      IO *dk, IO *dv, float *dx2, IO *xn2, IO *dpre, IO *hid, float *ln_part, float *q,   \
      float *k, float *v, float *dattn, float *dsum, int N, int A2, int C, int H,         \
      float scale, void *stream
#define LFT_ANG_BWD_BODY(BF, IO, DP)                                                       \
  if (H != 8 || A2 < 1 || A2 > RP || N < 1 || static_cast<long long>(N) * A2 > 0x7fffffffLL) \
    return static_cast<int>(cudaErrorInvalidValue);                                        \
  const AngBwdArgs<IO> g{x, pe, ln, wq, wk, wv, wo, w1, w2, m, l, attn, dout, wf, dx, xn,   \
                         dq, dk, dv, dx2, xn2, dpre, hid, ln_part, q, k, v, dattn, dsum};  \
  auto s = static_cast<cudaStream_t>(stream);                                              \
  switch (C) {                                                                             \
    case 16: return launch_bwd<16, BF, IO, DP>(g, N, A2, scale, s);                        \
    case 32: return launch_bwd<32, BF, IO, DP>(g, N, A2, scale, s);                        \
    case 64: return launch_bwd<64, BF, IO, DP>(g, N, A2, scale, s);                        \
    default: return static_cast<int>(cudaErrorInvalidValue);                               \
  }

extern "C" int lft_ang_block_bwd(LFT_ANG_BWD_ARGS(float)) {
  LFT_ANG_BWD_BODY(false, float, false)
}

// K4 with step b forming D from its own p (`ang_block_bwd_dp`: a forward under
// LFT_MM_HP_SITES=none, this backward under LFT_MM_HP_BWD_SITES=all; lft_tpu's
// _bwd_kernel forms D so at every plan, ang_block.py:360-362): the same
// arguments, dsum written by step a and not read.
extern "C" int lft_ang_block_bwd_dp(LFT_ANG_BWD_ARGS(float)) {
  LFT_ANG_BWD_BODY(false, float, true)
}

// K4's bf16-operand instances under `--dtype mixed` (the K4 header): the
// same arguments (dsum is left unwritten), wf holding the weights' bf16
// parts in the same layouts.
extern "C" int lft_ang_block_bwd_bf16(LFT_ANG_BWD_ARGS(float)) {
  LFT_ANG_BWD_BODY(true, float, false)
}

// K4's site-subset instances under an LFT_MM_HP_BWD_SITES subset (the K4
// header): the same arguments and `sites` (tf32.cuh: S_AQKV .. S_AFFN)
// before the stream; dsum is left unwritten, wf holds each weight split as
// its site's products read it.
extern "C" int lft_ang_block_bwd_sites(
    const float* x, const float* pe, const float* ln, const float* wq, const float* wk,
    const float* wv, const float* wo, const float* w1, const float* w2, const float* m,
    const float* l, const float* attn, const float* dout, float* wf, float* dx, float* xn,
    float* dq, float* dk, float* dv, float* dx2, float* xn2, float* dpre, float* hid,
    float* ln_part, float* q, float* k, float* v, float* dattn, float* dsum, int N, int A2,
    int C, int H, float scale, int sites, void* stream) {
  if (H != 8 || A2 < 1 || A2 > RP || N < 1 || static_cast<long long>(N) * A2 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const AngBwdArgs<float> g{x, pe, ln, wq, wk, wv, wo, w1, w2, m, l, attn, dout, wf, dx, xn,
                            dq, dk, dv, dx2, xn2, dpre, hid, ln_part, q, k, v, dattn, dsum};
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_bwd<16, false, float, false, true>(g, N, A2, scale, s, sites);
    case 32: return launch_bwd<32, false, float, false, true>(g, N, A2, scale, s, sites);
    case 64: return launch_bwd<64, false, float, false, true>(g, N, A2, scale, s, sites);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4's bf16-IO instances under `--dtype bfloat16` (the K4 header): the same
// arguments with x, attn, dout and dx, xn, dq, dk, dv, xn2, dpre, hid bf16
// (dx2, ln_part, m, l and the scratch f32; dsum left unwritten).
extern "C" int lft_ang_block_bwd_bf16io(LFT_ANG_BWD_ARGS(bf16)) {
  LFT_ANG_BWD_BODY(true, bf16, false)
}
