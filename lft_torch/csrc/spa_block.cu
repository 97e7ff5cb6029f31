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
// carry over. Each step instead owns a tile of BM = 64 tokens, runs its
// products from shared memory against weights read through L1/L2, and
// hands its result to the next step through device memory. Every block
// computes its own halo and zero padding (the TPU kernel zeroed scratch
// borders once at grid step 0, which is exact only on a sequential grid).
// The window step skips keys outside the image instead of scoring zero
// keys and correcting the denominator.
//
// Bound on this card: f32 on the FP32 pipes. At the production shape
// [400, 32, 32, 64] the block does ~180 GFLOP (tokenisation 60.4, q/k 26.8,
// v 13.4, attention 5.2, Wo 13.4, FFN 53.7, Token2SAI 6.7), ~2.7 ms at
// 67 TFLOP/s on an H100 SXM; the intermediates add ~1.9 GB of device
// memory traffic (~0.6 ms at 3.35 TB/s), so the steps are compute-bound
// except the window attention, which is bound by its k/v reads.

#include "common.cuh"

using namespace lft;

namespace {

constexpr int BM = 64;  // token rows per block in the product steps
constexpr int TH = 16, TW = 16, R = 2;  // window step: query tile, radius
constexpr int HH = TH + 2 * R, HW = TW + 2 * R;

template <int C>
struct Spa {
  static constexpr int D = 2 * C;
  static constexpr int LDC = C + 4, LDD = D + 4, LDH = 2 * D + 4;
  static constexpr int DH = D / 8;
};

// Token t of T = V*h*w tokens -> its offset in [V, h, w, *] is t itself;
// the (y, x) position inside its view is (t % hw) / w, t % w.

// ---- 1: tokenisation (9 shifted C -> D taps) + PE + LN1 -----------------
template <int C>
__global__ void __launch_bounds__(NT)
    spa_tokenize_ln_kernel(const float* __restrict__ x, const float* __restrict__ pe_tok,
                           const float* __restrict__ wu, const float* __restrict__ ln,
                           float* __restrict__ tok, float* __restrict__ xn, int T,
                           int h, int w) {
  using S = Spa<C>;
  using LN = RowLN<S::D>;
  constexpr int D = S::D, LDC = S::LDC, LDD = S::LDD;
  extern __shared__ float4 smem4[];
  float* AS = reinterpret_cast<float*>(smem4);   // [BM][LDC] one tap's inputs
  float* TK = AS + BM * LDC;                      // [BM][LDD] tok tile
  const int tid = threadIdx.x, warp = tid >> 5;
  const int t0 = blockIdx.x * BM;
  const int hw = h * w;

  Acc<BM, D> acc;
  zero_acc<BM, D>(acc);
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int i = tid; i < BM * (C / 4); i += NT) {
      const int r = i / (C / 4), c = 4 * (i % (C / 4));
      const int t = t0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) {
        const int rem = t % hw;
        const int y = rem / w + dy, xx = rem % w + dx;
        if (y >= 0 && y < h && xx >= 0 && xx < w)
          v = ldg4(x + (static_cast<long long>(t) + dy * w + dx) * C + c);
      }
      store4(AS + r * LDC + c, v);
    }
    __syncthreads();
    gemm_acc<BM, C, D>(acc, AS, LDC, wu + static_cast<size_t>(tap) * C * D);
    __syncthreads();
  }
  for_tiles<BM, D>(acc, [&](int r, int c, float4 v) { store4(TK + r * LDD + c, v); });
  __syncthreads();

  for (int r = warp; r < BM; r += NT / 32) {
    const int t = t0 + r;
    if (t >= T) break;
    const float* pe = pe_tok + static_cast<size_t>(t % hw) * D;
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        const float tv = TK[r * LDD + LN::col(e)];
        tok[static_cast<size_t>(t) * D + LN::col(e)] = tv;
        v[e] = tv + __ldg(pe + LN::col(e));
      }
    LN::apply(v, ln, ln + D);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) xn[static_cast<size_t>(t) * D + LN::col(e)] = v[e];
  }
}

// Loads rows [t0, t0 + BM) of a [T, W] tensor into a [BM][ld] tile (zero
// past T).
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int t0, int T) {
  for (int i = threadIdx.x; i < BM * (W / 4); i += NT) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    const float4 v = t0 + r < T ? ldg4(src + static_cast<size_t>(t0 + r) * W + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * ld + c, v);
  }
}

// ---- 2: q/k from xn, v from tok -----------------------------------------
template <int C>
__global__ void __launch_bounds__(NT)
    spa_qkv_kernel(const float* __restrict__ xn, const float* __restrict__ tok,
                   const float* __restrict__ wqk, const float* __restrict__ wv,
                   float* __restrict__ q, float* __restrict__ k, float* __restrict__ v,
                   int T) {
  using S = Spa<C>;
  constexpr int D = S::D, LDD = S::LDD;
  extern __shared__ float4 smem4[];
  float* XN = reinterpret_cast<float*>(smem4);
  float* TK = XN + BM * LDD;
  const int t0 = blockIdx.x * BM;
  load_rows<D>(XN, LDD, xn, t0, T);
  load_rows<D>(TK, LDD, tok, t0, T);
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

// ---- 3: 5x5-window attention, one head of one 16 x 16 query tile --------
// The block stages the tile's (16+4)^2 key/value halo of its head in shared
// memory (row stride DH+4 floats, so the float4 reads of neighbouring
// threads fall in distinct banks); positions outside the image are never
// scored.
template <int DH>
__global__ void __launch_bounds__(NT)
    spa_window_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ attn,
                           int h, int w, int D, float scale) {
  constexpr int KS = DH + 4;
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);   // [HH*HW][KS]
  float* VT = KT + HH * HW * KS;
  const int ntw = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / ntw) * TH, x0 = (blockIdx.x % ntw) * TW;
  const int head = blockIdx.y;
  const size_t view = static_cast<size_t>(blockIdx.z) * h * w;

  for (int i = threadIdx.x; i < HH * HW * (DH / 4); i += NT) {
    const int key = i / (DH / 4), d = 4 * (i % (DH / 4));
    const int ky = y0 - R + key / HW, kx = x0 - R + key % HW;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (ky >= 0 && ky < h && kx >= 0 && kx < w) {
      const size_t off = (view + static_cast<size_t>(ky) * w + kx) * D + head * DH + d;
      kv = ldg4(k + off);
      vv = ldg4(v + off);
    }
    store4(KT + key * KS + d, kv);
    store4(VT + key * KS + d, vv);
  }
  __syncthreads();

  const int ly = threadIdx.x / TW, lx = threadIdx.x % TW;
  const int y = y0 + ly, x = x0 + lx;
  if (y >= h || x >= w) return;
  const size_t qoff = (view + static_cast<size_t>(y) * w + x) * D + head * DH;
  float qv[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 t = ldg4(q + qoff + d);
    qv[d] = t.x * scale; qv[d + 1] = t.y * scale;
    qv[d + 2] = t.z * scale; qv[d + 3] = t.w * scale;
    o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  for (int dy = -R; dy <= R; ++dy) {
    if (y + dy < 0 || y + dy >= h) continue;
    for (int dx = -R; dx <= R; ++dx) {
      if (x + dx < 0 || x + dx >= w) continue;
      const int key = (ly + dy + R) * HW + (lx + dx + R);
      const float* kr = KT + key * KS;
      const float* vr = VT + key * KS;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qv[d], kr[d], s);
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), e = expf(s - mn);
      l = fmaf(l, corr, e);
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(o[d], corr, e * vr[d]);
      m = mn;
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < DH; d += 4)
    store4(attn + qoff + d, make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv,
                                        o[d + 3] * inv));
}

// ---- 4: out-projection + residual + LN2 ---------------------------------
template <int C>
__global__ void __launch_bounds__(NT)
    spa_outproj_ln_kernel(const float* __restrict__ attn, const float* __restrict__ tok,
                          const float* __restrict__ wo, const float* __restrict__ ln,
                          float* __restrict__ x2, float* __restrict__ xn2, int T) {
  using S = Spa<C>;
  using LN = RowLN<S::D>;
  constexpr int D = S::D, LDD = S::LDD;
  extern __shared__ float4 smem4[];
  float* AT = reinterpret_cast<float*>(smem4);
  float* X2 = AT + BM * LDD;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * BM;
  load_rows<D>(AT, LDD, attn, t0, T);
  __syncthreads();
  {
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, D, D>(acc, AT, LDD, wo);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 val) {
      const int t = t0 + r;
      if (t < T) store4(X2 + r * LDD + c, add4(val, ldg4(tok + static_cast<size_t>(t) * D + c)));
    });
  }
  __syncthreads();
  for (int r = warp; r < BM; r += NT / 32) {
    const int t = t0 + r;
    if (t >= T) break;
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) {
        v[e] = X2[r * LDD + LN::col(e)];
        x2[static_cast<size_t>(t) * D + LN::col(e)] = v[e];
      }
    LN::apply(v, ln + 2 * D, ln + 3 * D);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) xn2[static_cast<size_t>(t) * D + LN::col(e)] = v[e];
  }
}

// ---- 5: FFN + residual + Token2SAI --------------------------------------
template <int C>
__global__ void __launch_bounds__(NT)
    spa_ffn_out_kernel(const float* __restrict__ xn2, const float* __restrict__ x2,
                       const float* __restrict__ w1, const float* __restrict__ w2,
                       const float* __restrict__ wlin, float* __restrict__ out, int T) {
  using S = Spa<C>;
  constexpr int D = S::D, LDD = S::LDD, LDH = S::LDH;
  extern __shared__ float4 smem4[];
  float* XN = reinterpret_cast<float*>(smem4);   // xn2, then y
  float* HID = XN + BM * LDD;
  const int t0 = blockIdx.x * BM;
  load_rows<D>(XN, LDD, xn2, t0, T);
  __syncthreads();
  {
    Acc<BM, 2 * D> acc;
    zero_acc<BM, 2 * D>(acc);
    gemm_acc<BM, D, 2 * D>(acc, XN, LDD, w1);
    for_tiles<BM, 2 * D>(acc, [&](int r, int c, float4 val) {
      store4(HID + r * LDH + c, make_float4(fmaxf(val.x, 0.f), fmaxf(val.y, 0.f),
                                            fmaxf(val.z, 0.f), fmaxf(val.w, 0.f)));
    });
  }
  __syncthreads();
  {
    Acc<BM, D> acc;
    zero_acc<BM, D>(acc);
    gemm_acc<BM, 2 * D, D>(acc, HID, LDH, w2);
    for_tiles<BM, D>(acc, [&](int r, int c, float4 val) {
      const int t = t0 + r;
      const float4 res = t < T ? ldg4(x2 + static_cast<size_t>(t) * D + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(XN + r * LDD + c, add4(val, res));
    });
  }
  __syncthreads();
  {
    Acc<BM, C> acc;
    zero_acc<BM, C>(acc);
    gemm_acc<BM, D, C>(acc, XN, LDD, wlin);
    for_tiles<BM, C>(acc, [&](int r, int c, float4 val) {
      const int t = t0 + r;
      if (t < T) store4(out + static_cast<size_t>(t) * C + c, val);
    });
  }
}

int blocks(int T) { return (T + BM - 1) / BM; }

#define LFT_SET_SMEM(kernel, bytes)                                            \
  do {                                                                         \
    cudaError_t e_ = cudaFuncSetAttribute(                                     \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)); \
    if (e_ != cudaSuccess) return static_cast<int>(e_);                        \
  } while (0)

// Runs the statements with CC bound to C as a compile-time constant.
#define LFT_DISPATCH_C(C, ...)                                  \
  switch (C) {                                                  \
    case 16: { constexpr int CC = 16; __VA_ARGS__; break; }     \
    case 32: { constexpr int CC = 32; __VA_ARGS__; break; }     \
    case 64: { constexpr int CC = 64; __VA_ARGS__; break; }     \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

}  // namespace

LFT_EXPORT_ERROR_STRING

// All token tensors are [T, *] with T = V*h*w tokens in [V, h, w] order.
// Weights use "x @ W" layouts: wu [9, C, D] (tap-major), wqk [D, 2D],
// wv/wo [D, D], w1 [D, 2D], w2 [2D, D], wlin [D, C]; ln [4, D] is
// (LN1 w, b, LN2 w, b). Each returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take (C in {16, 32, 64}).

extern "C" int lft_spa_tokenize_ln(const float* x, const float* pe_tok, const float* wu,
                                   const float* ln, float* tok, float* xn, int V, int h,
                                   int w, int C, void* stream) {
  const int T = V * h * w;
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    auto kernel = spa_tokenize_ln_kernel<CC>;
    const size_t bytes = BM * (Spa<CC>::LDC + Spa<CC>::LDD) * sizeof(float);
    LFT_SET_SMEM(kernel, bytes);
    kernel<<<blocks(T), NT, bytes, s>>>(x, pe_tok, wu, ln, tok, xn, T, h, w);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lft_spa_qkv(const float* xn, const float* tok, const float* wqk,
                           const float* wv, float* q, float* k, float* v, int T, int C,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    auto kernel = spa_qkv_kernel<CC>;
    const size_t bytes = 2 * BM * Spa<CC>::LDD * sizeof(float);
    LFT_SET_SMEM(kernel, bytes);
    kernel<<<blocks(T), NT, bytes, s>>>(xn, tok, wqk, wv, q, k, v, T);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lft_spa_window_attn(const float* q, const float* k, const float* v,
                                   float* attn, int V, int h, int w, int D, int H,
                                   float scale, void* stream) {
  if (H != 8) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), H, V);
  switch (D / H) {
#define LFT_ATTN_CASE(DHV)                                                    \
    case DHV: {                                                               \
      auto kernel = spa_window_attn_kernel<DHV>;                              \
      const size_t bytes = 2 * HH * HW * (DHV + 4) * sizeof(float);           \
      LFT_SET_SMEM(kernel, bytes);                                            \
      kernel<<<grid, NT, bytes, s>>>(q, k, v, attn, h, w, D, scale);          \
      break;                                                                  \
    }
    LFT_ATTN_CASE(4)
    LFT_ATTN_CASE(8)
    LFT_ATTN_CASE(16)
#undef LFT_ATTN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lft_spa_outproj_ln(const float* attn, const float* tok, const float* wo,
                                  const float* ln, float* x2, float* xn2, int T, int C,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    auto kernel = spa_outproj_ln_kernel<CC>;
    const size_t bytes = 2 * BM * Spa<CC>::LDD * sizeof(float);
    LFT_SET_SMEM(kernel, bytes);
    kernel<<<blocks(T), NT, bytes, s>>>(attn, tok, wo, ln, x2, xn2, T);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lft_spa_ffn_out(const float* xn2, const float* x2, const float* w1,
                               const float* w2, const float* wlin, float* out, int T,
                               int C, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  LFT_DISPATCH_C(C, {
    auto kernel = spa_ffn_out_kernel<CC>;
    const size_t bytes = BM * (Spa<CC>::LDD + Spa<CC>::LDH) * sizeof(float);
    LFT_SET_SMEM(kernel, bytes);
    kernel<<<blocks(T), NT, bytes, s>>>(xn2, x2, w1, w2, wlin, out, T);
  });
  return static_cast<int>(cudaGetLastError());
}
