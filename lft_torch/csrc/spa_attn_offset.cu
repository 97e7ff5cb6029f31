// K9: per-op 5x5-window attention as a sweep over the 25 window offsets on
// the whole view, any view size, forward and backward.
//
// Replaces lft_tpu/kernels/local_attn_vjp.py:_call_fwd / _vjp_bwd (the
// Pallas TPU kernels behind windowed_attention). For every view b, head hh
// of 8 and pixel (y, x) of q, k, v [B, h, w, E] (dh = E / 8), over the
// offsets (dy, dx) of the 5x5 window whose key lies inside the image:
//   s_o = (q * scale) . k[y+dy, x+dx]      out = sum_o softmax_o(s_o) v_o
// as an online softmax over the offsets in row-major order (running max m,
// running sum l, accumulator rescaled at every offset, out = acc / l). m, l
// per (pixel, head) and the output are the residuals of the backward, which
// returns dq, dk, dv from (q, k, v, out, m, l, dout):
//   D = dout . out (per head)    a_o = exp(s_o - m) / l
//   ds_o = a_o (dout . v_o - D)  dq = scale sum_o ds_o k_o
//   dk[p + o] += ds_o (q * scale)   dv[p + o] += a_o dout
// The q/k/v/out projections stay outside (torch.matmul).
//
// This is the kernel with no tile: it takes every (h, w). The TPU kernel
// sweeps 25 shifted copies of a whole zero-padded view (or row band) held in
// VMEM, scores the out-of-image offsets as -1e30, and in the backward adds
// each offset's dk, dv slab into padded accumulators, which is exact only
// because its grid runs in order. None of that is carried over. A thread
// owns one (pixel, head): threads of a warp are 4 neighbouring pixels x 8
// heads, so every read of a pixel's row (its own or a neighbour's) is one
// contiguous 4 x E-float segment, and the <= 25 neighbours come straight
// from device memory through L1/L2 (a row of a view is revisited by the
// five query rows around it). Out-of-image offsets are skipped, which
// equals the -1e30 mask because the centre is always inside.
//
// The backward is a gather with no atomics: a first small kernel writes
// D [B, h, w, 8] from dout and out (the JAX package computes it in XLA
// before its kernel); the main kernel's thread sums dq over its window as
// the query and collects dk, dv from the <= 25 queries whose window holds it
// as the key, rebuilding each score with the forward's arithmetic. Every
// output element is written by one thread, so a step repeats bit for bit.
// All of it runs in f32 (the TPU backward streams k, v, dout as bf16 to fit
// VMEM).
//
// Bound on this card: the bytes. At [400, 32, 32, 128] the forward moves
// 4 x 210 MB (0.25 ms at 3.35 TB/s) for 4.9 GFLOP (0.07 ms at 67 TFLOP/s).

#include "attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;

// ---- forward: one thread per (pixel, head) --------------------------------
template <int DH, bool STATS>
__global__ void __launch_bounds__(NT)
    spa_attn_offset_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ m_out, float* __restrict__ l_out,
                           long long total, int h, int w, float scale) {
  constexpr int E = H * DH;
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (t >= total) return;
  const long long pix = t / H;                   // over B * h * w
  const int x = static_cast<int>(pix % w), y = static_cast<int>((pix / w) % h);
  const size_t off = static_cast<size_t>(t) * DH;   // = pix * E + head * DH
  float qs[DH], o[DH];
  ldg<DH>(q + off, qs);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qs[d] *= scale;
    o[d] = 0.f;
  }
  float m = -1e30f, l = 0.f;
  for (int dy = -R; dy <= R; ++dy) {
    if (y + dy < 0 || y + dy >= h) continue;
    for (int dx = -R; dx <= R; ++dx) {
      if (x + dx < 0 || x + dx >= w) continue;
      const size_t nb = off + static_cast<long long>(dy * w + dx) * E;
      float kr[DH], vr[DH];
      ldg<DH>(k + nb, kr);
      ldg<DH>(v + nb, vr);
      const float s = dot<DH>(qs, kr);
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
  for (int d = 0; d < DH; ++d) o[d] *= inv;
  st<DH>(out + off, o);
  if constexpr (STATS) {
    m_out[t] = m;
    l_out[t] = l;
  }
}

// ---- backward, first kernel: D = dout . out per (pixel, head) -------------
template <int DH>
__global__ void __launch_bounds__(NT)
    spa_attn_offset_d_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                             float* __restrict__ d_out, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (t >= total) return;
  float g[DH], o[DH];
  ldg<DH>(dout + static_cast<size_t>(t) * DH, g);
  ldg<DH>(out + static_cast<size_t>(t) * DH, o);
  d_out[t] = dot<DH>(g, o);
}

// ---- backward, main kernel: dq as the query, dk and dv as the key ---------
template <int DH>
__global__ void __launch_bounds__(NT)
    spa_attn_offset_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ m_in, const float* __restrict__ l_in,
                               const float* __restrict__ d_in, float* __restrict__ dq_out,
                               float* __restrict__ dk_out, float* __restrict__ dv_out,
                               long long total, int h, int w, float scale) {
  constexpr int E = H * DH;
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (t >= total) return;
  const long long pix = t / H;
  const int x = static_cast<int>(pix % w), y = static_cast<int>((pix / w) % h);
  const size_t off = static_cast<size_t>(t) * DH;
  float qs[DH], kme[DH], vme[DH], gme[DH], dq[DH], dk[DH], dv[DH];
  ldg<DH>(q + off, qs);
  ldg<DH>(k + off, kme);
  ldg<DH>(v + off, vme);
  ldg<DH>(dout + off, gme);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qs[d] *= scale;
    dq[d] = dk[d] = dv[d] = 0.f;
  }
  const float m_me = __ldg(m_in + t), inv = 1.f / __ldg(l_in + t), d_me = __ldg(d_in + t);
  for (int dy = -R; dy <= R; ++dy) {
    if (y + dy < 0 || y + dy >= h) continue;
    for (int dx = -R; dx <= R; ++dx) {
      if (x + dx < 0 || x + dx >= w) continue;
      const long long step = dy * w + dx;
      const size_t nb = off + step * E;          // the neighbour's row segment
      const size_t ns = t + step * H;            // its (pixel, head) statistic
      float a[DH], b[DH];
      // me as the query, the neighbour as the key (the forward's score arithmetic)
      ldg<DH>(k + nb, a);
      ldg<DH>(v + nb, b);
      float ds = expf(dot<DH>(qs, a) - m_me) * inv * (dot<DH>(gme, b) - d_me);
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, a[d], dq[d]);
      // the neighbour as the query, me as the key
      ldg<DH>(q + nb, a);
      ldg<DH>(dout + nb, b);
#pragma unroll
      for (int d = 0; d < DH; ++d) a[d] *= scale;
      const float pr = expf(dot<DH>(a, kme) - __ldg(m_in + ns)) / __ldg(l_in + ns);
      ds = pr * (dot<DH>(b, vme) - __ldg(d_in + ns));
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] = fmaf(ds, a[d], dk[d]);
        dv[d] = fmaf(pr, b[d], dv[d]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[d] *= scale;
  st<DH>(dq_out + off, dq);
  st<DH>(dk_out + off, dk);
  st<DH>(dv_out + off, dv);
}

// (pixel, head) threads of the whole batch, or -1 where the grid cannot hold them
inline long long n_threads(int B, int h, int w, int heads) {
  if (heads != H || B < 1 || h < 1 || w < 1) return -1;
  const long long total = static_cast<long long>(B) * h * w * H;
  return (total + NT - 1) / NT > 0x7fffffffLL ? -1 : total;
}

template <bool STATS>
int spa_attn_offset(const float* q, const float* k, const float* v, float* out, float* m,
                    float* l, int B, int h, int w, int E, int heads, float scale,
                    cudaStream_t s) {
  const long long total = n_threads(B, h, w, heads);
  if (total < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((total + NT - 1) / NT);
  switch (E / H) {
#define LFT_OFFSET_CASE(DHV)                                                            \
    case DHV:                                                                           \
      spa_attn_offset_kernel<DHV, STATS><<<grid, NT, 0, s>>>(q, k, v, out, m, l, total, h, w, \
                                                             scale);                    \
      break;
    LFT_OFFSET_CASE(4)
    LFT_OFFSET_CASE(8)
    LFT_OFFSET_CASE(16)
#undef LFT_OFFSET_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [B, h, w, E], E = 8 heads x {4, 8, 16}; any h, w. Each
// returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int lft_spa_attn_offset(const float* q, const float* k, const float* v, float* out,
                                   int B, int h, int w, int E, int heads, float scale,
                                   void* stream) {
  return spa_attn_offset<false>(q, k, v, out, nullptr, nullptr, B, h, w, E, heads, scale,
                                static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [B, h, w, 8] (with out, the residuals of the backward).
extern "C" int lft_spa_attn_offset_res(const float* q, const float* k, const float* v,
                                       float* out, float* m, float* l, int B, int h, int w,
                                       int E, int heads, float scale, void* stream) {
  return spa_attn_offset<true>(q, k, v, out, m, l, B, h, w, E, heads, scale,
                               static_cast<cudaStream_t>(stream));
}

// dsum [B, h, w, 8] is scratch the caller allocates: D = dout . out per head.
extern "C" int lft_spa_attn_offset_bwd(const float* q, const float* k, const float* v,
                                       const float* dout, const float* out, const float* m,
                                       const float* l, float* dsum, float* dq, float* dk,
                                       float* dv, int B, int h, int w, int E, int heads,
                                       float scale, void* stream) {
  const long long total = n_threads(B, h, w, heads);
  if (total < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>((total + NT - 1) / NT);
  switch (E / H) {
#define LFT_OFFSET_CASE(DHV)                                                            \
    case DHV:                                                                           \
      spa_attn_offset_d_kernel<DHV><<<grid, NT, 0, s>>>(dout, out, dsum, total);        \
      spa_attn_offset_bwd_kernel<DHV><<<grid, NT, 0, s>>>(q, k, v, dout, m, l, dsum, dq, dk, \
                                                          dv, total, h, w, scale);      \
      break;
    LFT_OFFSET_CASE(4)
    LFT_OFFSET_CASE(8)
    LFT_OFFSET_CASE(16)
#undef LFT_OFFSET_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
