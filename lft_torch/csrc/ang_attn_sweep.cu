// K8: per-op angular attention as a sweep over the key views, any view
// count, forward and backward.
//
// Replaces lft_tpu/kernels/ang_attn_vjp.py:_fwd / _vjp_bwd (the Pallas TPU
// kernels behind ang_attention). For every pixel n of N and head hh of 8,
// over the pixel's A2 view tokens (q, k, v [N, A2, C], dh = C / 8):
//   s_ij = (q_i * scale) . k_j        out_i = sum_j softmax_j(s_ij) v_j
// computed as an online softmax over the key views j = 0 .. A2-1: a running
// max m (from -1e30), a running sum l and an accumulator, both rescaled by
// exp(m_old - m_new) at each key; out = acc / l. m and l per (token, head)
// and the output itself are the residuals of the backward, which returns
// dq, dk, dv from (q, k, v, out, m, l, dout):
//   D_i = dout_i . out_i (per head)   a_ij = exp(s_ij - m_i) / l_i
//   ds_ij = a_ij (dout_i . v_j - D_i)
//   dq_i = scale sum_j ds_ij k_j      dk_j = sum_i ds_ij (q_i * scale)
//   dv_j = sum_i a_ij dout_i
// The q/k/v/out projections stay outside (torch.matmul), as the JAX package
// leaves them to XLA.
//
// The TPU kernel holds a chunk of 32 pixels with all their views in VMEM
// and walks fori_loop(0, A2) over whole key views; pixel pairs are packed
// side by side to fill its lanes. Here no view count is assumed to fit
// shared memory (A2 = 169 at C = 64 is 2 x 43 KB, larger is legal): a block
// serves one pixel and up to NT (query view, head) pairs of it, a thread
// owns one such pair with its (m, l, acc) in registers, and the pixel's key
// views pass through shared memory in chunks of KC rows. Threads of a warp
// are 4 queries x 8 heads, so a key row is read as 8 head segments, each a
// broadcast to 4 threads. N needs no padding: the grid has one row of blocks
// per pixel.
//
// The backward has no atomics. Phase A: the thread is a query, takes D from
// its saved output, and sweeps the key chunks for dq. Phase B: the thread is
// a key and sweeps the QUERY views in chunks (q, dout staged; m, l and D of
// the chunk's queries staged beside them) to gather dk, dv. Every output
// element is written by one thread, so a step repeats bit for bit; every
// score is rebuilt with the forward's arithmetic (q scaled first, one fmaf
// chain).
//
// Bound on this card: the bytes. At [16384, 25, 64] the forward moves
// 4 x 105 MB (0.125 ms at 3.35 TB/s) for 2.6 GFLOP (0.04 ms at 67 TFLOP/s).

#include "attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;
constexpr int KC = 32;   // key (or query) views staged per chunk

// ---- forward: one thread per (query view, head) of the block's pixel ------
template <int DH, bool STATS>
__global__ void __launch_bounds__(NT)
    ang_attn_sweep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ m_out, float* __restrict__ l_out, int A2,
                          float scale) {
  constexpr int C = H * DH, LD = C + 4;
  __shared__ float4 kt4[KC * LD / 4], vt4[KC * LD / 4];
  float* KT = reinterpret_cast<float*>(kt4);     // [KC][LD]
  float* VT = reinterpret_cast<float*>(vt4);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * A2;
  const int item = blockIdx.y * NT + threadIdx.x;
  const bool active = item < A2 * H;
  const int qi = item / H, hh = item % H;
  const size_t off = (row0 + qi) * C + hh * DH;

  float qs[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qs[d] = o[d] = 0.f;
  if (active) {
    ldg<DH>(q + off, qs);
#pragma unroll
    for (int d = 0; d < DH; ++d) qs[d] *= scale;
  }
  float m = -1e30f, l = 0.f;
  for (int j0 = 0; j0 < A2; j0 += KC) {
    const int nk = min(KC, A2 - j0);
    if (j0) __syncthreads();                     // the last chunk's readers are done
    stage<C>(KT, k, row0 + j0, nk);
    stage<C>(VT, v, row0 + j0, nk);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nk; ++j) {
      float kr[DH], vr[DH];
      ld<DH>(KT + j * LD + hh * DH, kr);
      ld<DH>(VT + j * LD + hh * DH, vr);
      const float s = dot<DH>(qs, kr);
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), e = expf(s - mn);
      l = fmaf(l, corr, e);
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(o[d], corr, e * vr[d]);
      m = mn;
    }
  }
  if (!active) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] *= inv;
  st<DH>(out + off, o);
  if constexpr (STATS) {
    m_out[row0 * H + item] = m;
    l_out[row0 * H + item] = l;
  }
}

// ---- backward: the thread as a query (D, dq), then as a key (dk, dv) ------
template <int DH>
__global__ void __launch_bounds__(NT)
    ang_attn_sweep_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ out, const float* __restrict__ m_in,
                              const float* __restrict__ l_in, float* __restrict__ dq_out,
                              float* __restrict__ dk_out, float* __restrict__ dv_out, int A2,
                              float scale) {
  constexpr int C = H * DH, LD = C + 4;
  __shared__ float4 at4[KC * LD / 4], bt4[KC * LD / 4];
  __shared__ float MT[KC * H], LT[KC * H], DT[KC * H];
  float* AT = reinterpret_cast<float*>(at4);     // k rows, then q rows
  float* BT = reinterpret_cast<float*>(bt4);     // v rows, then dout rows
  const size_t row0 = static_cast<size_t>(blockIdx.x) * A2;
  const int item = blockIdx.y * NT + threadIdx.x;
  const bool active = item < A2 * H;
  const int me = item / H, hh = item % H;
  const size_t off = (row0 + me) * C + hh * DH;

  // phase A: me as the query
  float qs[DH], g[DH], acc[DH];
  float m_me = 0.f, inv = 0.f, d_me = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) qs[d] = g[d] = acc[d] = 0.f;
  if (active) {
    float o[DH];
    ldg<DH>(q + off, qs);
    ldg<DH>(dout + off, g);
    ldg<DH>(out + off, o);
#pragma unroll
    for (int d = 0; d < DH; ++d) qs[d] *= scale;
    d_me = dot<DH>(g, o);
    m_me = __ldg(m_in + row0 * H + item);
    inv = 1.f / __ldg(l_in + row0 * H + item);
  }
  for (int j0 = 0; j0 < A2; j0 += KC) {
    const int nk = min(KC, A2 - j0);
    if (j0) __syncthreads();
    stage<C>(AT, k, row0 + j0, nk);
    stage<C>(BT, v, row0 + j0, nk);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nk; ++j) {
      float kr[DH], vr[DH];
      ld<DH>(AT + j * LD + hh * DH, kr);
      ld<DH>(BT + j * LD + hh * DH, vr);
      const float ds = expf(dot<DH>(qs, kr) - m_me) * inv * (dot<DH>(g, vr) - d_me);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= scale;
    st<DH>(dq_out + off, acc);
  }

  // phase B: me as the key, the query views in chunks
  float kme[DH], vme[DH], dk[DH], dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) kme[d] = vme[d] = dk[d] = dv[d] = 0.f;
  if (active) {
    ldg<DH>(k + off, kme);
    ldg<DH>(v + off, vme);
  }
  for (int i0 = 0; i0 < A2; i0 += KC) {
    const int ni = min(KC, A2 - i0);
    __syncthreads();
    stage<C>(AT, q, row0 + i0, ni);
    stage<C>(BT, dout, row0 + i0, ni);
    for (int idx = threadIdx.x; idx < ni * H; idx += NT) {
      const size_t s = (row0 + i0) * H + idx;        // (query view, head) of the chunk
      const size_t o = (row0 + i0 + idx / H) * C + (idx % H) * DH;
      float go[DH], oo[DH];
      ldg<DH>(dout + o, go);
      ldg<DH>(out + o, oo);
      MT[idx] = __ldg(m_in + s);
      LT[idx] = __ldg(l_in + s);
      DT[idx] = dot<DH>(go, oo);
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < ni; ++i) {
      float qo[DH], go[DH];
      ld<DH>(AT + i * LD + hh * DH, qo);
      ld<DH>(BT + i * LD + hh * DH, go);
#pragma unroll
      for (int d = 0; d < DH; ++d) qo[d] *= scale;
      const float pr = expf(dot<DH>(qo, kme) - MT[i * H + hh]) / LT[i * H + hh];
      const float ds = pr * (dot<DH>(go, vme) - DT[i * H + hh]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] = fmaf(ds, qo[d], dk[d]);
        dv[d] = fmaf(pr, go[d], dv[d]);
      }
    }
  }
  if (active) {
    st<DH>(dk_out + off, dk);
    st<DH>(dv_out + off, dv);
  }
}

inline bool bad_shape(int N, int A2, int heads) {
  return heads != H || N < 1 || A2 < 1 || (static_cast<long long>(A2) * H + NT - 1) / NT > 65535;
}

template <bool STATS>
int ang_attn_sweep(const float* q, const float* k, const float* v, float* out, float* m,
                   float* l, int N, int A2, int C, int heads, float scale, cudaStream_t s) {
  if (bad_shape(N, A2, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N, (A2 * H + NT - 1) / NT);
  switch (C / H) {
    case 2: ang_attn_sweep_kernel<2, STATS><<<grid, NT, 0, s>>>(q, k, v, out, m, l, A2, scale); break;
    case 4: ang_attn_sweep_kernel<4, STATS><<<grid, NT, 0, s>>>(q, k, v, out, m, l, A2, scale); break;
    case 8: ang_attn_sweep_kernel<8, STATS><<<grid, NT, 0, s>>>(q, k, v, out, m, l, A2, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [N, A2, C], C = 8 heads x {2, 4, 8}, any A2. Each returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int lft_ang_attn_sweep(const float* q, const float* k, const float* v, float* out,
                                  int N, int A2, int C, int heads, float scale, void* stream) {
  return ang_attn_sweep<false>(q, k, v, out, nullptr, nullptr, N, A2, C, heads, scale,
                               static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [N, A2, 8] (with out, the residuals of the backward).
extern "C" int lft_ang_attn_sweep_res(const float* q, const float* k, const float* v,
                                      float* out, float* m, float* l, int N, int A2, int C,
                                      int heads, float scale, void* stream) {
  return ang_attn_sweep<true>(q, k, v, out, m, l, N, A2, C, heads, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int lft_ang_attn_sweep_bwd(const float* q, const float* k, const float* v,
                                      const float* dout, const float* out, const float* m,
                                      const float* l, float* dq, float* dk, float* dv, int N,
                                      int A2, int C, int heads, float scale, void* stream) {
  if (bad_shape(N, A2, heads)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N, (A2 * H + NT - 1) / NT);
  switch (C / H) {
#define LFT_SWEEP_CASE(DHV)                                                              \
    case DHV:                                                                            \
      ang_attn_sweep_bwd_kernel<DHV><<<grid, NT, 0, s>>>(q, k, v, dout, out, m, l, dq, dk, dv, \
                                                         A2, scale);                     \
      break;
    LFT_SWEEP_CASE(2)
    LFT_SWEEP_CASE(4)
    LFT_SWEEP_CASE(8)
#undef LFT_SWEEP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
