// K7: per-op angular attention on projected q/k/v, forward and backward.
//
// Replaces lft_tpu/kernels/ang_attn_mxu.py:_fwd / _vjp_bwd (the Pallas TPU
// kernels behind ang_attention_blockdiag). For every pixel n of N and head
// hh of 8, over the pixel's A2 view tokens (q, k, v [N, A2, C], dh = C / 8):
//   s_ij = (q_i * scale) . k_j        out_i = sum_j softmax_j(s_ij) v_j
// with m_i = max_j s_ij and l_i = sum_j exp(s_ij - m_i) per (token, head)
// as the residuals of the backward, which returns dq, dk, dv from
// (q, k, v, m, l, dout):
//   p_ij = exp(s_ij - m_i) / l_i      dp_ij = dout_i . v_j
//   D_i = sum_j p_ij dp_ij            ds_ij = p_ij (dp_ij - D_i)
//   dq_i = scale sum_j ds_ij k_j      dk_j = sum_i ds_ij (q_i * scale)
//   dv_j = sum_i p_ij dout_i
// The q/k/v/out projections stay outside (torch.matmul), as the JAX package
// leaves them to XLA.
//
// What the TPU kernel does to fill its matrix unit (keys replicated per
// head behind channel masks, a block-diagonal mask over a 128-row group of
// pixels, pixel pairs packed side by side, one row-wide softmax shift
// shared by the heads) has no purpose here. A block owns P whole pixels
// and stages their rows in shared memory with coalesced float4 loads; one
// thread runs one (pixel, head, query) online softmax over the A2 keys with
// its own per-(token, head) max. Query threads of a warp share a pixel and
// head, so their key reads are shared-memory broadcasts. The backward
// rebuilds every score with the forward's arithmetic (q scaled first, one
// fmaf chain), first per query (D, then dq) and then per key (dk, dv
// gathered over the pixel's A2 queries): every output element is written
// by exactly one thread, without atomics, so a step repeats bit for bit.
// N is ragged (the last block's missing pixels are masked) where the TPU
// wrapper pads it.
//
// Bound on this card: the bytes. At [16384, 25, 64] the forward moves
// 4 x 105 MB (0.125 ms at 3.35 TB/s) for 2.6 GFLOP (0.04 ms at 67 TFLOP/s
// FP32); the backward moves 7 tensors for 6.6 GFLOP of minimal work.

#include "attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;

// ---- forward: one thread per (pixel, head, query view) --------------------
template <int DH, bool STATS>
__global__ void __launch_bounds__(NT)
    ang_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int N, int A2,
                    int P, float scale) {
  constexpr int C = H * DH, LD = C + 4;
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);   // [P*A2][LD]
  float* VT = KT + P * A2 * LD;
  const int p0 = blockIdx.x * P;
  const int np = min(P, N - p0);
  const size_t row0 = static_cast<size_t>(p0) * A2;
  stage<C>(KT, k, row0, np * A2);
  stage<C>(VT, v, row0, np * A2);
  __syncthreads();

  for (int t = threadIdx.x; t < np * H * A2; t += NT) {
    const int i = t % A2, hh = (t / A2) % H, p = t / (A2 * H);
    const size_t row = row0 + p * A2 + i;
    float qs[DH], o[DH];
    ld<DH>(q + row * C + hh * DH, qs);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qs[d] *= scale;
      o[d] = 0.f;
    }
    float m = -CUDART_INF_F, l = 0.f;
    for (int j = 0; j < A2; ++j) {
      float kr[DH], vr[DH];
      ld<DH>(KT + (p * A2 + j) * LD + hh * DH, kr);
      ld<DH>(VT + (p * A2 + j) * LD + hh * DH, vr);
      const float s = dot<DH>(qs, kr);
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), e = expf(s - mn);
      l = fmaf(l, corr, e);
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(o[d], corr, e * vr[d]);
      m = mn;
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] *= inv;
    st<DH>(out + row * C + hh * DH, o);
    if constexpr (STATS) {
      m_out[row * H + hh] = m;
      l_out[row * H + hh] = l;
    }
  }
}

// ---- backward: per query (D, dq), then per key (dk, dv) -------------------
template <int DH>
__global__ void __launch_bounds__(NT)
    ang_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        float* __restrict__ dq_out, float* __restrict__ dk_out,
                        float* __restrict__ dv_out, int N, int A2, int P, float scale) {
  constexpr int C = H * DH, LD = C + 4;
  extern __shared__ float4 smem4[];
  const int tile = P * A2 * LD;
  float* QT = reinterpret_cast<float*>(smem4);   // [P*A2][LD] each
  float* KT = QT + tile;
  float* VT = KT + tile;
  float* GT = VT + tile;                          // dout
  float* MT = GT + tile;                          // [P*A2][H] each
  float* LT = MT + P * A2 * H;
  float* DT = LT + P * A2 * H;                    // D = sum_j p dp
  const int p0 = blockIdx.x * P;
  const int np = min(P, N - p0);
  const int rows = np * A2;
  const size_t row0 = static_cast<size_t>(p0) * A2;
  stage<C>(QT, q, row0, rows);
  stage<C>(KT, k, row0, rows);
  stage<C>(VT, v, row0, rows);
  stage<C>(GT, dout, row0, rows);
  for (int i = threadIdx.x; i < rows * H; i += NT) {
    MT[i] = __ldg(m_in + row0 * H + i);
    LT[i] = __ldg(l_in + row0 * H + i);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < np * H * A2; t += NT) {
    const int i = t % A2, hh = (t / A2) % H, p = t / (A2 * H);
    const int me = p * A2 + i;
    float qs[DH], g[DH], dq[DH];
    ld<DH>(QT + me * LD + hh * DH, qs);
    ld<DH>(GT + me * LD + hh * DH, g);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qs[d] *= scale;
      dq[d] = 0.f;
    }
    const float m_me = MT[me * H + hh], inv = 1.f / LT[me * H + hh];
    float dsum = 0.f;
    for (int j = 0; j < A2; ++j) {
      float kr[DH], vr[DH];
      ld<DH>(KT + (p * A2 + j) * LD + hh * DH, kr);
      ld<DH>(VT + (p * A2 + j) * LD + hh * DH, vr);
      dsum = fmaf(expf(dot<DH>(qs, kr) - m_me) * inv, dot<DH>(g, vr), dsum);
    }
    for (int j = 0; j < A2; ++j) {
      float kr[DH], vr[DH];
      ld<DH>(KT + (p * A2 + j) * LD + hh * DH, kr);
      ld<DH>(VT + (p * A2 + j) * LD + hh * DH, vr);
      const float ds = expf(dot<DH>(qs, kr) - m_me) * inv * (dot<DH>(g, vr) - dsum);
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, kr[d], dq[d]);
    }
    DT[me * H + hh] = dsum;
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[d] *= scale;
    st<DH>(dq_out + (row0 + me) * C + hh * DH, dq);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < np * H * A2; t += NT) {
    const int j = t % A2, hh = (t / A2) % H, p = t / (A2 * H);
    const int me = p * A2 + j;
    float kme[DH], vme[DH], dk[DH], dv[DH];
    ld<DH>(KT + me * LD + hh * DH, kme);
    ld<DH>(VT + me * LD + hh * DH, vme);
#pragma unroll
    for (int d = 0; d < DH; ++d) dk[d] = dv[d] = 0.f;
    for (int i = 0; i < A2; ++i) {
      const int o = p * A2 + i;
      float qo[DH], go[DH];
      ld<DH>(QT + o * LD + hh * DH, qo);
      ld<DH>(GT + o * LD + hh * DH, go);
#pragma unroll
      for (int d = 0; d < DH; ++d) qo[d] *= scale;
      const float pr = expf(dot<DH>(qo, kme) - MT[o * H + hh]) / LT[o * H + hh];
      const float ds = pr * (dot<DH>(go, vme) - DT[o * H + hh]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] = fmaf(ds, qo[d], dk[d]);
        dv[d] = fmaf(pr, go[d], dv[d]);
      }
    }
    st<DH>(dk_out + (row0 + me) * C + hh * DH, dk);
    st<DH>(dv_out + (row0 + me) * C + hh * DH, dv);
  }
}

// Pixels a block owns: as many whole pixels as fit `max_rows` token rows.
inline int pixels_per_block(int A2, int max_rows) { return max_rows / A2 > 0 ? max_rows / A2 : 1; }

template <bool STATS>
int ang_attn(const float* q, const float* k, const float* v, float* out, float* m, float* l,
             int N, int A2, int C, int heads, float scale, cudaStream_t s) {
  if (heads != H || A2 < 1 || A2 > 128 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int P = pixels_per_block(A2, 128);
  const int grid = (N + P - 1) / P;
  switch (C / H) {
#define LFT_ANG_CASE(DHV)                                                       \
    case DHV: {                                                                 \
      auto kernel = ang_attn_kernel<DHV, STATS>;                                \
      const size_t bytes = 2 * static_cast<size_t>(P) * A2 * (H * DHV + 4) * sizeof(float); \
      LFT_SET_SMEM(kernel, bytes);                                              \
      kernel<<<grid, NT, bytes, s>>>(q, k, v, out, m, l, N, A2, P, scale);      \
      break;                                                                    \
    }
    LFT_ANG_CASE(2)
    LFT_ANG_CASE(4)
    LFT_ANG_CASE(8)
#undef LFT_ANG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [N, A2, C], C = 8 heads x {2, 4, 8}, A2 <= 128. Each returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int lft_ang_attn(const float* q, const float* k, const float* v, float* out, int N,
                            int A2, int C, int heads, float scale, void* stream) {
  return ang_attn<false>(q, k, v, out, nullptr, nullptr, N, A2, C, heads, scale,
                         static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [N, A2, 8] (the residuals of the backward).
extern "C" int lft_ang_attn_res(const float* q, const float* k, const float* v, float* out,
                                float* m, float* l, int N, int A2, int C, int heads,
                                float scale, void* stream) {
  return ang_attn<true>(q, k, v, out, m, l, N, A2, C, heads, scale,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int lft_ang_attn_bwd(const float* q, const float* k, const float* v,
                                const float* dout, const float* m, const float* l, float* dq,
                                float* dk, float* dv, int N, int A2, int C, int heads,
                                float scale, void* stream) {
  if (heads != H || A2 < 1 || A2 > 128 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int P = pixels_per_block(A2, 80);
  const int grid = (N + P - 1) / P;
  switch (C / H) {
#define LFT_ANG_CASE(DHV)                                                       \
    case DHV: {                                                                 \
      auto kernel = ang_attn_bwd_kernel<DHV>;                                   \
      const size_t bytes =                                                      \
          static_cast<size_t>(P) * A2 * (4 * (H * DHV + 4) + 3 * H) * sizeof(float); \
      LFT_SET_SMEM(kernel, bytes);                                              \
      kernel<<<grid, NT, bytes, s>>>(q, k, v, dout, m, l, dq, dk, dv, N, A2, P, scale); \
      break;                                                                    \
    }
    LFT_ANG_CASE(2)
    LFT_ANG_CASE(4)
    LFT_ANG_CASE(8)
#undef LFT_ANG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
