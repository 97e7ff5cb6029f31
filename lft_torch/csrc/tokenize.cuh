// The SpaTrans block's 3x3 tokenization (K2.1, K11.1) and its transpose
// (K3.e) as one implicit GEMM on the tensor cores, 3xTF32:
//
//   out[t] = sum_tap in[t + s_tap] B[tap],  s_tap = (tap / 3 - 1, tap % 3 - 1),
//   in[.] zero outside t's h x w image.
//
// Forward (spa_block.cu): in = x [V, h, w, C] (or K11's pixel-major buffer),
// B[tap] = Wu[tap] [C, D], then tok = out and xn = LN1(out + pe_tok).
// Backward (spa_block_bwd.cu): in = dtok [V, h, w, D], B[tap] = Wu[8 - tap]ᵀ
// [D, C] (dx[u] = sum_tap dtok[u - s_tap] Wu[tap]ᵀ with the taps mirrored),
// out = dx.
//
// Replaces the 9 accumulated MXU taps of lft_tpu/kernels/spa_block.py:
// _kernel :128-142 (forward, inside _fwd_call :248: pallas_call :352
// view-major, :339 with residuals, :309 pixel-major) and _bwd_kernel
// :557-568 (inside the K3 call :667), which staged each view once in a
// zero-bordered VMEM scratch and read the taps as shifted windows of it.
//
// Bound on this card, at the main path's shapes: the forward at
// [400, 32, 32, 64] does 57.9 GFLOP over the taps inside the image and
// moves 525 MB (x 105, tok 210, xn 210); the backward at [100, 32, 32, 128]
// 14.5 GFLOP and 79 MB. On the FP32 pipes (67 TFLOP/s) that is 0.86 and
// 0.22 ms, bound by operations; as 3xTF32 on the tensor cores (3 TF32
// products at 495 TFLOP/s) 0.35 and 0.088 ms, bound by operations, the
// bytes 0.16 and 0.024 ms. So the products run on the tensor cores:
//
// * A block takes a rectangle of r x cw pixels of one view (r cw <= 128
//   tokens; the shape is `kernels/spa_block.py:tok_tile`, a function of (h,
//   w, C)) and stages the band of image rows y0-1 .. y0+r, columns x0-1 ..
//   x0+cw once, zero outside the image (written by the block itself: blocks
//   run in no order). All nine taps read it at a fixed pixel offset, so no
//   tap is masked and no input is gathered twice. Rows are CIN + 4 floats:
//   the 32 lanes of a fragment load (8 neighbouring pixels, 4 channels)
//   hit 32 banks.
// * `wgmma.m64nNk8` tf32, N = COUT: two warpgroups of 64 tokens each.
//   A (the band) comes from registers: a tap's rows start at any pixel of
//   the band, which no shared-memory descriptor can express, and the
//   activations are split into TF32 hi/lo as they are loaded (integer
//   rounding). B (the weights) comes from shared memory, K-major without
//   swizzle: a first kernel of the call splits the weights once and lays
//   them out in core matrices (`tap_weights_kernel`; in plain PyTorch
//   `kernels/spa_block.py:tap_weights`). With `mma.sync.m16n8k8` fragments
//   for B instead, the kernel took 1.28 ms at [400, 32, 32, 64] and 0.34 at
//   [100, 32, 32, 128] on an H100 (`lft_torch.compare_tokenize`; wgmma:
//   0.98 and 0.24), and neither bands split in shared memory, 16 warps,
//   persistent blocks nor skipping the taps outside the image moved it.
// * The split weights stream through a 3-stage `cp.async` ring of 32 KB
//   stages (a tap, or half a tap at C = 64), two stages ahead of the MMAs.
// * The products of every 16 input channels (two k8 steps: 6 wgmma, the
//   first of which starts from zero) add into their own accumulators,
//   which the FP32 pipes add in a fixed order (tap, then channel): the
//   tensor cores round their f32 sums toward zero, and that bias grows with
//   the chain. With one chain a tap (24 MMAs forward, 48 backward at
//   C = 64) K3.e's error against float64 was 2.7-3.8x that of the f32 cuDNN
//   convolution on an H100 (tests/test_torch_cuda.py); with these chains
//   1.1-1.7x (chip_smoke.py, compare_tokenize). Every output is written by
//   one block, no atomics: a call repeats bitwise.
// * Forward epilogue: the tile goes through shared memory; tok, then xn =
//   LN1(tok + pe_tok) (RowLN, the arithmetic K3.b recomputes bit for bit),
//   one warp a token, both written as 16-byte, coalesced rows.
// * BF (K3.e under `--dtype mixed`'s backward): the band and the taps
//   rounded to bf16 (the taps by `tap_weights_kernel<BWD, true>` into the hi
//   part of the same layout, lo 0), one TF32 `wgmma` a k8 step instead of
//   three, the same chains and f32 accumulation (tf32.cuh).
// * IO = bf16 (K3.e `spa_tokenize_bwd_bf16io`, `--dtype bfloat16` training,
//   with BF): dtok and dx bf16. The band stays f32 in shared memory, written
//   by the threads from 8-byte loads widened to f32 (cp.async copies bytes,
//   and an f32 band keeps the fragment loads and their banks as they are);
//   dx is rounded as it is stored. The forward's bf16 forms (K2.1 and K11.1
//   `_bf16io` and `_bf16`) have a kernel of their own: tok_bf16.cuh.
#pragma once

#include "spa.cuh"
#include "tf32.cuh"

namespace lft {

constexpr int TOK_M = 128;               // token rows of a block: 2 warpgroups of 64
constexpr int TOK_NT = 256;              // threads of a block
constexpr int TOK_STAGES = 3;            // depth of the weight ring
constexpr int TOK_STAGE_FLOATS = 8192;   // at most 32 KB a stage
constexpr int TOK_SMEM_MAX = 232448;     // shared memory a block can use

// Geometry of the product in[.., CIN] -> out[.., COUT] (kernels/spa_block.py
// mirrors it in `tok_smem`).
template <int CIN, int COUT>
struct TapConv {
  static constexpr int KC = CIN < TOK_STAGE_FLOATS / (2 * COUT) ? CIN
                                                                 : TOK_STAGE_FLOATS / (2 * COUT);
  static constexpr int KK = KC / 8;                  // k8 steps of a stage
  static constexpr int NKC = CIN / KC;               // stages of a tap
  static constexpr int STAGE = KC * COUT * 2;        // floats of a stage (hi and lo)
  static constexpr int LDA = CIN + 4;                // band row stride
  static constexpr int LDO = COUT + 8;               // epilogue row stride
  static constexpr int R = COUT / 2;                 // accumulators a thread
  // a k8 step's B (hi or lo) in a stage: core matrices of 8 columns x 4 k,
  // COUT / 8 of them along N 128 bytes apart, 2 along K LBO bytes apart
  static constexpr int LBO = COUT / 8 * 128, SBO = 128;
  static_assert(CIN % KC == 0 && KC % 16 == 0 && COUT % 16 == 0 && COUT <= 128,
                "unsupported tokenization width");

  static size_t smem(int r, int cw, bool ln) {
    const size_t main = (static_cast<size_t>(r + 2) * (cw + 2) * LDA +
                         static_cast<size_t>(TOK_STAGES) * STAGE) * sizeof(float);
    const size_t epi = ln ? static_cast<size_t>(TOK_M) * LDO * sizeof(float) : 0;
    return main > epi ? main : epi;
  }
};

// B of the tokenization from wu [9, C, D] (B[tap] = wu[tap], or wu[8 -
// tap]ᵀ with BWD), split into TF32 hi and lo (truncated as the MMA reads it)
// and laid out as tap_conv_kernel reads it: wf[tap][kk][hi or lo][kh][j][n]
// [t] = B[tap][8 kk + 4 kh + t][8 j + n], K x N = C x D (D x C with BWD).
// BF: hi is B rounded to bf16, lo 0.
template <bool BWD, bool BF = false>
__global__ void __launch_bounds__(256)
    tap_weights_kernel(const float* __restrict__ wu, float* __restrict__ wf, int K, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 9 * K * N) return;
  const int tap = i / (K * N), k = i % (K * N) / N, n = i % N;
  const float v = BWD ? wu[(static_cast<size_t>(8 - tap) * N + n) * K + k] : wu[i];
  uint32_t hi, lo;
  if constexpr (BF) {
    hi = bf16_bits(v);
    lo = 0u;
  } else {
    split_tf32(v, hi, lo);
  }
  const size_t at =
      ((static_cast<size_t>(tap * (K / 8) + k / 8) * 4 + k % 8 / 4) * (N / 8) + n / 8) * 32 +
      n % 8 * 4 + k % 4;
  wf[at] = __uint_as_float(hi);
  wf[at + 2 * 4 * N] = __uint_as_float(lo & 0xffffe000u);   // the next part: 2 x N/8 x 32
}

// LN (the f32 forward, K2.1 and K11.1): out = tok, xn = LN1(tok + pe_tok)
// with ln = (LN1 w, b); else out only (K3.e). PM: in is pixel-major [V / A2,
// h, w, A2, CIN]; out and xn stay view-major. wf: [9, CIN / 8, 2 (hi, lo),
// 2, COUT / 8, 8, 4] (kernels/spa_block.py: tap_weights). BF (K3.e's
// bf16-operand and bf16-IO instances): the band rounded to bf16 as it loads,
// one product a k8 step over the taps' bf16 part.
template <int CIN, int COUT, bool PM, bool LN, bool BF = false, class IO = float>
__global__ void __launch_bounds__(TOK_NT, 1)
    tap_conv_kernel(const IO* __restrict__ in, const float* __restrict__ wf,
                    const IO* __restrict__ pe_tok, const float* __restrict__ ln,
                    IO* __restrict__ out, IO* __restrict__ xn, int h, int w, int A2,
                    int r, int cw) {
  static_assert(!LN || (!BF && !is_bf16<IO>), "the bf16 forwards run tok_bf16.cuh");
  using G = TapConv<CIN, COUT>;
  constexpr int LDA = G::LDA, R = G::R;
  extern __shared__ __align__(16) float smem[];
  const int bw = cw + 2, P = (r + 2) * bw;
  float* band = smem;                  // [P][LDA]
  float* ring = smem + P * LDA;        // [TOK_STAGES][STAGE]
  const int txs = (w + cw - 1) / cw, per_view = ((h + r - 1) / r) * txs;
  const int view = blockIdx.x / per_view, tile = blockIdx.x % per_view;
  const int y0 = (tile / txs) * r, x0 = (tile % txs) * cw;
  const int hw = h * w, ntok = r * cw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = 16 * warp;            // the warp's 16 token rows

  for (int i = tid; i < P * (CIN / 4); i += TOK_NT) {
    const int p = i / (CIN / 4), c = 4 * (i % (CIN / 4));
    const int y = y0 - 1 + p / bw, x = x0 - 1 + p % bw;
    const bool ok = y >= 0 && y < h && x >= 0 && x < w;
    long long row = ok ? static_cast<long long>(view) * hw + y * w + x : 0;
    if constexpr (PM) row = pm_row(row, hw, A2);
    if constexpr (is_bf16<IO>)
      store4(band + p * LDA + c, ok ? ldg4(in + row * CIN + c) : make_float4(0.f, 0.f, 0.f, 0.f));
    else
      cp_async16(band + p * LDA + c, in + row * CIN + c, ok);
  }
  auto load_stage = [&](int s) {
    const float* src = wf + static_cast<size_t>(s) * G::STAGE;
    float* dst = ring + (s % TOK_STAGES) * G::STAGE;
    for (int i = tid; i < G::STAGE / 4; i += TOK_NT) cp_async16(dst + 4 * i, src + 4 * i, true);
  };
  load_stage(0);
  cp_async_commit();   // the band and stage 0
  load_stage(1);
  cp_async_commit();

  // band pixels of the warp's rows g and g + 8 (a pad row past the tile
  // reads pixel (1, 1) and is not written)
  int pix[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = wm + g + 8 * e;
    pix[e] = m < ntok ? (m / cw + 1) * bw + m % cw + 1 : bw + 1;
  }

  // acc[4 j + e]: row g + 8 (e / 2), column 8 j + 2 q + e % 2 of the warp's
  // 16 x COUT slab
  float acc[R] = {}, sum[R];
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = (tap / 3 - 1) * bw + (tap % 3 - 1);
#pragma unroll
    for (int kc = 0; kc < G::NKC; ++kc) {
      const int s = tap * G::NKC + kc;
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
      if (s + 2 < 9 * G::NKC) load_stage(s + 2);
      cp_async_commit();
      const float* st = ring + (s % TOK_STAGES) * G::STAGE;
#pragma unroll
      for (int c2 = 0; c2 < G::KK / 2; ++c2) {   // a chain: 16 input channels
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k0 = kc * G::KC + (2 * c2 + u) * 8 + q;
          const float* a0 = band + (pix[0] + toff) * LDA + k0;
          const float* a1 = band + (pix[1] + toff) * LDA + k0;
          if constexpr (BF) {
            ah[u][0] = bf16_bits(a0[0]);
            ah[u][1] = bf16_bits(a1[0]);
            ah[u][2] = bf16_bits(a0[4]);
            ah[u][3] = bf16_bits(a1[4]);
            continue;
          }
          split_tf32(a0[0], ah[u][0], al[u][0]);
          split_tf32(a1[0], ah[u][1], al[u][1]);
          split_tf32(a0[4], ah[u][2], al[u][2]);
          split_tf32(a1[4], ah[u][3], al[u][3]);
        }
        reg_fence(sum);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* bk = st + (2 * c2 + u) * 16 * COUT;   // the k8 step's hi, then lo
          const uint64_t dh = smem_desc(bk, G::LBO, G::SBO);
          const uint64_t dl = smem_desc(bk + 8 * COUT, G::LBO, G::SBO);
          if constexpr (BF) {
            Wgmma<COUT>::mma(sum, ah[u], dh, u);
            continue;
          }
          Wgmma<COUT>::mma(sum, al[u], dh, u);
          Wgmma<COUT>::mma(sum, ah[u], dl, 1);
          Wgmma<COUT>::mma(sum, ah[u], dh, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sum);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] += sum[i];
      }
    }
  }
  cp_async_wait<0>();

  // token index of a tile row, or -1 past the tile or the image
  auto token = [&](int m) {
    if (m >= ntok) return -1;
    const int y = y0 + m / cw, x = x0 + m % cw;
    return y < h && x < w ? view * hw + y * w + x : -1;
  };

  if constexpr (!LN) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = token(wm + g + 8 * e);
      if (t < 0) continue;
      IO* dst = out + static_cast<size_t>(t) * COUT + 2 * q;
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j)
        st2(dst + 8 * j, acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
  } else {
    using RL = RowLN<COUT>;
    constexpr int LDO = G::LDO;
    __syncthreads();   // every warp is done with the band and the ring
    float* tk = smem;  // [TOK_M][LDO]
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(tk + (wm + g + 8 * e) * LDO + 8 * j + 2 * q) =
            make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    __syncthreads();
    const bool vec = lane < COUT / 4;   // lanes of a 16-byte row store
    for (int m = warp; m < ntok; m += TOK_NT / 32) {
      const int t = token(m);
      if (t < 0) continue;
      float* row = tk + m * LDO;
      const IO* pe = pe_tok + static_cast<size_t>(t % hw) * COUT;
      float v[RL::E];
#pragma unroll
      for (int e = 0; e < RL::E; ++e)
        if (RL::valid(e)) v[e] = row[RL::col(e)] + ldg1(pe + RL::col(e));
      if (vec) st4(out + static_cast<size_t>(t) * COUT + 4 * lane, load4(row + 4 * lane));
      RL::apply(v, ln, ln + COUT);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < RL::E; ++e)
        if (RL::valid(e)) row[RL::col(e)] = v[e];
      __syncwarp();
      if (vec) st4(xn + static_cast<size_t>(t) * COUT + 4 * lane, load4(row + 4 * lane));
    }
  }
}

// Splits wu into wf (tap_weights_kernel), then launches tap_conv_kernel over
// V views of h x w (tiles of r x cw pixels). BWD: the backward's mirrored,
// transposed taps. BF: the bf16-operand instances of both kernels. IO: the
// activations' type (named, never deduced).
template <int CIN, int COUT, bool PM, bool LN, bool BWD, bool BF = false, class IO = float>
int launch_tap_conv(const named_t<IO>* in, const float* wu, float* wf,
                    const named_t<IO>* pe_tok, const float* ln, named_t<IO>* out,
                    named_t<IO>* xn, int V, int h, int w, int A2, int r, int cw, cudaStream_t s) {
  using G = TapConv<CIN, COUT>;
  if (V < 1 || h < 1 || w < 1 || A2 < 1 || r < 1 || cw < 1 || r * cw > TOK_M)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(V) * ((h + r - 1) / r) * ((w + cw - 1) / cw);
  const size_t bytes = G::smem(r, cw, LN);
  if (static_cast<long long>(V) * h * w > 0x7fffffffLL || blocks > 0x7fffffffLL ||
      bytes > static_cast<size_t>(TOK_SMEM_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  tap_weights_kernel<BWD, BF><<<(9 * CIN * COUT + 255) / 256, 256, 0, s>>>(wu, wf, CIN, COUT);
  auto kernel = tap_conv_kernel<CIN, COUT, PM, LN, BF, IO>;
  LFT_SET_SMEM(kernel, bytes);
  kernel<<<static_cast<unsigned>(blocks), TOK_NT, bytes, s>>>(in, wf, pe_tok, ln, out, xn, h, w,
                                                               A2, r, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lft
