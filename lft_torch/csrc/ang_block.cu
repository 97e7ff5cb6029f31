// K1: the whole AngTrans block (reference model/LFT.py:194-238), forward.
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
// Design for the H100. One block owns RP = 128 token rows = P = 128 / A2
// whole pixels (5 at A2 = 25), so attention never leaves the block and the
// whole chain runs in shared memory: x (kept as the residual, then x2), xn
// (then the attention output, then LN2), q, k, v, and the hidden FFN tile
// over q/k. Only x is read and only out is written. The block-diagonal
// key replication, head masks and pixel groups of the TPU kernel are gone:
// a thread runs one (pixel, head, query) softmax over the A2 keys with an
// online max, reading k/v from shared memory.
//
// Bound on this card: f32 with TF32 off runs on the FP32 pipes. At the
// production shape [16384, 25, 64] the block does ~29.5 GFLOP and moves
// ~210 MB, i.e. it is compute-bound (~0.44 ms at 67 TFLOP/s on an H100
// SXM). The products use 4 x 4 register tiles, so each k step issues
// 16 FMAs per five loads; the weights (128 KB) stay in L1/L2. Shared
// memory (174 KB at C = 64) allows one block of 8 warps per SM. The tensor
// cores do not compute in exact f32, so they are not used.

#include "common.cuh"

using namespace lft;

namespace {

constexpr int RP = 128;  // token rows per block

template <int C>
struct AngLayout {
  static constexpr int LD = C + 4;        // row stride of the C-wide tiles
  static constexpr int LDH = 2 * C + 4;   // row stride of the hidden tile
  static constexpr int TILE = RP * LD;
  static constexpr size_t BYTES = 5 * TILE * sizeof(float);
  static_assert(RP * LDH <= 2 * TILE, "hidden tile must fit over q and k");
};

template <int C, int H>
__global__ void __launch_bounds__(NT)
    ang_block_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                     const float* __restrict__ ln, const float* __restrict__ wq,
                     const float* __restrict__ wk, const float* __restrict__ wv,
                     const float* __restrict__ wo, const float* __restrict__ w1,
                     const float* __restrict__ w2, float* __restrict__ out,
                     int N, int A2, float scale) {
  using L = AngLayout<C>;
  using LN = RowLN<C>;
  constexpr int LD = L::LD, LDH = L::LDH, DH = C / H;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* XN = X + L::TILE;
  float* Q = XN + L::TILE;
  float* K = Q + L::TILE;
  float* V = K + L::TILE;
  float* HID = Q;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int P = RP / A2;
  const int pix0 = blockIdx.x * P;
  const int np = min(P, N - pix0);
  const int nrows = np * A2;
  const size_t row0 = static_cast<size_t>(pix0) * A2;

  // x rows of this block's pixels are contiguous; pad rows are zero.
  for (int i = tid; i < RP * (C / 4); i += NT) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4));
    const float4 v = r < nrows ? ldg4(x + (row0 + r) * C + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(X + r * LD + c, v);
  }
  __syncthreads();

  // xn = LN1(x + pe)
  for (int r = warp; r < RP; r += NT / 32) {
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) v[e] = X[r * LD + LN::col(e)] + __ldg(pe + (r % A2) * C + LN::col(e));
    LN::apply(v, ln, ln + C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) XN[r * LD + LN::col(e)] = v[e];
  }
  __syncthreads();

  {  // q, k from xn; v from the raw x
    Acc<RP, C> acc;
    zero_acc<RP, C>(acc);
    gemm_acc<RP, C, C>(acc, XN, LD, wq);
    for_tiles<RP, C>(acc, [&](int r, int c, float4 v) { store4(Q + r * LD + c, v); });
    zero_acc<RP, C>(acc);
    gemm_acc<RP, C, C>(acc, XN, LD, wk);
    for_tiles<RP, C>(acc, [&](int r, int c, float4 v) { store4(K + r * LD + c, v); });
    zero_acc<RP, C>(acc);
    gemm_acc<RP, C, C>(acc, X, LD, wv);
    for_tiles<RP, C>(acc, [&](int r, int c, float4 v) { store4(V + r * LD + c, v); });
  }
  __syncthreads();

  // attention over each pixel's A2 tokens; one thread per (pixel, head,
  // query), queries fastest so a warp reads the same key rows (broadcast).
  // The output overwrites xn, which is dead after the projections.
  for (int t = tid; t < np * H * A2; t += NT) {
    const int i = t % A2, hh = (t / A2) % H, p = t / (A2 * H);
    const float* qr = Q + (p * A2 + i) * LD + hh * DH;
    float q[DH], o[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      q[d] = qr[d] * scale;
      o[d] = 0.f;
    }
    float m = -CUDART_INF_F, l = 0.f;
    for (int j = 0; j < A2; ++j) {
      const float* kr = K + (p * A2 + j) * LD + hh * DH;
      const float* vr = V + (p * A2 + j) * LD + hh * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(q[d], kr[d], s);
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), e = expf(s - mn);
      l = fmaf(l, corr, e);
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(o[d], corr, e * vr[d]);
      m = mn;
    }
    const float inv = 1.f / l;
    float* ar = XN + (p * A2 + i) * LD + hh * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) ar[d] = o[d] * inv;
  }
  __syncthreads();

  {  // x2 = a Wo + x, in place over x
    Acc<RP, C> acc;
    zero_acc<RP, C>(acc);
    gemm_acc<RP, C, C>(acc, XN, LD, wo);
    for_tiles<RP, C>(acc, [&](int r, int c, float4 v) {
      store4(X + r * LD + c, add4(load4(X + r * LD + c), v));
    });
  }
  __syncthreads();

  // LN2 over x2 into xn
  for (int r = warp; r < RP; r += NT / 32) {
    float v[LN::E];
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) v[e] = X[r * LD + LN::col(e)];
    LN::apply(v, ln + 2 * C, ln + 3 * C);
#pragma unroll
    for (int e = 0; e < LN::E; ++e)
      if (LN::valid(e)) XN[r * LD + LN::col(e)] = v[e];
  }
  __syncthreads();

  {  // hidden = relu(LN2(x2) W1), over the dead q/k tiles
    Acc<RP, 2 * C> acc;
    zero_acc<RP, 2 * C>(acc);
    gemm_acc<RP, C, 2 * C>(acc, XN, LD, w1);
    for_tiles<RP, 2 * C>(acc, [&](int r, int c, float4 v) {
      store4(HID + r * LDH + c, make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f),
                                            fmaxf(v.z, 0.f), fmaxf(v.w, 0.f)));
    });
  }
  __syncthreads();

  {  // out = hidden W2 + x2
    Acc<RP, C> acc;
    zero_acc<RP, C>(acc);
    gemm_acc<RP, 2 * C, C>(acc, HID, LDH, w2);
    for_tiles<RP, C>(acc, [&](int r, int c, float4 v) {
      if (r < nrows) store4(out + (row0 + r) * C + c, add4(load4(X + r * LD + c), v));
    });
  }
}

template <int C>
int launch(const float* x, const float* pe, const float* ln, const float* wq,
           const float* wk, const float* wv, const float* wo, const float* w1,
           const float* w2, float* out, int N, int A2, float scale,
           cudaStream_t stream) {
  constexpr int H = 8;
  auto kernel = ang_block_kernel<C, H>;
  const size_t bytes = AngLayout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = RP / A2;
  const int grid = (N + P - 1) / P;
  kernel<<<grid, NT, bytes, stream>>>(x, pe, ln, wq, wk, wv, wo, w1, w2, out, N, A2,
                                      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// x, out [N, A2, C]; pe [A2, C]; ln [4, C] (LN1 w, b, LN2 w, b); wq/wk/wv/wo
// [C, C], w1 [C, 2C], w2 [2C, C], all "x @ W" layouts. Returns the launch's
// cudaGetLastError(); cudaErrorInvalidValue for a shape it does not take.
extern "C" int lft_ang_block_fwd(const float* x, const float* pe, const float* ln,
                                 const float* wq, const float* wk, const float* wv,
                                 const float* wo, const float* w1, const float* w2,
                                 float* out, int N, int A2, int C, int H, float scale,
                                 void* stream) {
  if (H != 8 || A2 < 1 || A2 > RP || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(x, pe, ln, wq, wk, wv, wo, w1, w2, out, N, A2, scale, s);
    case 32: return launch<32>(x, pe, ln, wq, wk, wv, wo, w1, w2, out, N, A2, scale, s);
    case 64: return launch<64>(x, pe, ln, wq, wk, wv, wo, w1, w2, out, N, A2, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
