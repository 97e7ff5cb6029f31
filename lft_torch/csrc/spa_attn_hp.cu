// K5: per-op 5x5-window attention on projected q/k/v images, all heads of a
// query tile in one block, forward and backward.
//
// Replaces lft_tpu/kernels/spa_attn_hp.py:_fwd / _vjp_bwd (the Pallas TPU
// kernels behind windowed_attention_headpacked). For every view b, head hh
// of 8 and pixel (y, x) of q, k, v [B, h, w, E] (dh = E / 8), over the keys
// of the pixel's 5x5 window that lie inside the image:
//   s_j = (q * scale) . k_j      out = sum_j softmax_j(s_j) v_j
// with m = max_j s_j and l = sum_j exp(s_j - m) per (pixel, head) as the
// residuals of the backward, which returns dq, dk, dv from (q, k, v, m, l,
// dout):  p_j = exp(s_j - m) / l,  dp_j = dout . v_j,  D = sum_j p_j dp_j,
//   ds_j = p_j (dp_j - D),  dq = scale sum_j ds_j k_j,
//   dk_j += ds_j (q * scale),  dv_j += p_j dout  (over the queries whose
// window holds j). The q/k/v/out projections stay outside (torch.matmul).
//
// The TPU kernel packs the heads into one wide matrix product (keys
// replicated per head behind channel masks, the key count padded to KB,
// zero-pad keys scored and taken out of the denominator again by npad).
// What survives of "head-packed" on this card is one block serving ALL
// heads of an 8 x 8 query tile: the (8+4)^2 halo's full rows (E floats,
// 512 bytes at E = 128) are staged once with coalesced float4 loads, a
// thread owns one (query, head), and m, l leave as contiguous [.., 8] rows.
// Keys outside the image are never scored. A 16 x 16 tile's two halos at
// E = 128 would take 410 KB, past the 227 KB a block can hold; 8 x 8 takes
// 152 KB. Threads of a warp are 32 queries of one head, so neighbouring
// threads read neighbouring halo rows (row stride E + 4 floats: distinct
// banks for float4 reads).
//
// The backward is a gather, like K3's window step: a thread owns a pixel
// and head, sums dq over its window as the query, and collects dk, dv from
// the <= 25 queries whose window holds it as the key (a second score per
// pair), so every output is written by one thread and a step repeats bit
// for bit. Unlike K3 it is not given the forward's output, so it first
// computes D for every pixel of the halo: the windows of the halo's outer
// ring reach past the staged halo, and those few keys are read from device
// memory. q, k, v and dout halos of all heads do not fit at E = 128, so the
// block walks the heads in chunks of 64 channels (256-byte row segments).
//
// Bound on this card: the bytes. At [400, 32, 32, 128] the forward moves
// 4 x 210 MB (0.25 ms at 3.35 TB/s) for 4.9 GFLOP (0.07 ms at 67 TFLOP/s).

#include "attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;               // heads
constexpr int QT = 8;              // query tile edge
constexpr int HL = QT + 2 * R;     // halo edge
constexpr int NQ = QT * QT, NH = HL * HL;

// ---- forward: 512 threads = 64 queries x 8 heads --------------------------
template <int DH, bool STATS>
__global__ void __launch_bounds__(NQ * H)
    spa_attn_hp_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int h, int w,
                       float scale) {
  constexpr int E = H * DH, LD = E + 4;
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);   // [NH][LD]
  float* VT = KT + NH * LD;
  const int ntw = (w + QT - 1) / QT, nth = (h + QT - 1) / QT;
  const int tile = blockIdx.x % (nth * ntw);
  const int y0 = (tile / ntw) * QT, x0 = (tile % ntw) * QT;
  const size_t view = static_cast<size_t>(blockIdx.x / (nth * ntw)) * h * w;
  stage_tile_halo<E, QT>(KT, k + view * E, E, 0, y0, x0, h, w, NQ * H);
  stage_tile_halo<E, QT>(VT, v + view * E, E, 0, y0, x0, h, w, NQ * H);
  __syncthreads();

  const int qi = threadIdx.x % NQ, hh = threadIdx.x / NQ;
  const int ly = qi / QT, lx = qi % QT;
  const int y = y0 + ly, x = x0 + lx;
  const bool valid = y < h && x < w;
  float m = 0.f, l = 1.f;
  if (valid) {
    const size_t off = (view + static_cast<size_t>(y) * w + x) * E + hh * DH;
    float qs[DH], o[DH];
    ld<DH>(q + off, qs);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qs[d] *= scale;
      o[d] = 0.f;
    }
    m = -CUDART_INF_F;
    l = 0.f;
    for (int dy = -R; dy <= R; ++dy) {
      if (y + dy < 0 || y + dy >= h) continue;
      for (int dx = -R; dx <= R; ++dx) {
        if (x + dx < 0 || x + dx >= w) continue;
        const int key = (ly + dy + R) * HL + (lx + dx + R);
        float kr[DH], vr[DH];
        ld<DH>(KT + key * LD + hh * DH, kr);
        ld<DH>(VT + key * LD + hh * DH, vr);
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
  }
  if constexpr (STATS) {
    // m, l through shared memory, so they leave as [.., 8] rows: thread
    // (query, head) wrote [query][head], thread i stores element i
    __syncthreads();
    float* MS = KT;                                // [NQ][H]
    float* LS = KT + NQ * H;
    MS[qi * H + hh] = m;
    LS[qi * H + hh] = l;
    __syncthreads();
    const int sq = threadIdx.x / H, sh = threadIdx.x % H;
    const int sy = y0 + sq / QT, sx = x0 + sq % QT;
    if (sy < h && sx < w) {
      const size_t soff = (view + static_cast<size_t>(sy) * w + sx) * H + sh;
      m_out[soff] = MS[threadIdx.x];
      l_out[soff] = LS[threadIdx.x];
    }
  }
}

// ---- backward: heads in chunks of HP, 64 x HP threads ---------------------
template <int DH>
struct Bwd {
  static constexpr int HP = DH <= 8 ? 8 : 4;       // heads per chunk
  static constexpr int CW = HP * DH, LD = CW + 4;  // chunk width <= 64 channels
  static constexpr int NTB = NQ * HP;
  static constexpr size_t BYTES = (4 * NH * LD + 3 * NH * HP) * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(Bwd<DH>::NTB)
    spa_attn_hp_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           float* __restrict__ dq_out, float* __restrict__ dk_out,
                           float* __restrict__ dv_out, int h, int w, float scale) {
  using B = Bwd<DH>;
  constexpr int E = H * DH, HP = B::HP, CW = B::CW, LD = B::LD, NTB = B::NTB;
  extern __shared__ float4 smem4[];
  float* QS = reinterpret_cast<float*>(smem4);   // [NH][LD] each
  float* KT = QS + NH * LD;
  float* VT = KT + NH * LD;
  float* GT = VT + NH * LD;                       // dout
  float* MT = GT + NH * LD;                       // [NH][HP] each
  float* LT = MT + NH * HP;
  float* DT = LT + NH * HP;                       // D = sum_j p dp
  const int ntw = (w + QT - 1) / QT, nth = (h + QT - 1) / QT;
  const int tile = blockIdx.x % (nth * ntw);
  const int y0 = (tile / ntw) * QT, x0 = (tile % ntw) * QT;
  const size_t view = static_cast<size_t>(blockIdx.x / (nth * ntw)) * h * w;
  const float* kv = k + view * E;
  const float* vv = v + view * E;

  for (int c0 = 0; c0 < E; c0 += CW) {
    const int h0 = c0 / DH;
    if (c0) __syncthreads();                       // the last chunk's readers are done
    stage_tile_halo<CW, QT>(QS, q + view * E, E, c0, y0, x0, h, w, NTB);
    stage_tile_halo<CW, QT>(KT, kv, E, c0, y0, x0, h, w, NTB);
    stage_tile_halo<CW, QT>(VT, vv, E, c0, y0, x0, h, w, NTB);
    stage_tile_halo<CW, QT>(GT, dout + view * E, E, c0, y0, x0, h, w, NTB);
    for (int i = threadIdx.x; i < NH * HP; i += NTB) {
      const int pos = i / HP, hh = i % HP;
      const int y = y0 - R + pos / HL, x = x0 - R + pos % HL;
      float mv = 0.f, lv = 1.f;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        const size_t s = (view + static_cast<size_t>(y) * w + x) * H + h0 + hh;
        mv = __ldg(m_in + s);
        lv = __ldg(l_in + s);
      }
      MT[i] = mv;
      LT[i] = lv;
    }
    __syncthreads();

    // D of every halo pixel inside the image; a key outside the staged halo
    // (the windows of the halo's outer ring) comes from device memory
    for (int t = threadIdx.x; t < NH * HP; t += NTB) {
      const int pos = t % NH, hh = t / NH;
      const int py = pos / HL, px = pos % HL;
      const int y = y0 - R + py, x = x0 - R + px;
      float dsum = 0.f;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        float qs[DH], g[DH];
        ld<DH>(QS + pos * LD + hh * DH, qs);
        ld<DH>(GT + pos * LD + hh * DH, g);
#pragma unroll
        for (int d = 0; d < DH; ++d) qs[d] *= scale;
        const float m_me = MT[pos * HP + hh], inv = 1.f / LT[pos * HP + hh];
        for (int dy = -R; dy <= R; ++dy) {
          if (y + dy < 0 || y + dy >= h) continue;
          for (int dx = -R; dx <= R; ++dx) {
            if (x + dx < 0 || x + dx >= w) continue;
            const int ky = py + dy, kx = px + dx;
            float kr[DH], vr[DH];
            if (ky >= 0 && ky < HL && kx >= 0 && kx < HL) {
              ld<DH>(KT + (ky * HL + kx) * LD + hh * DH, kr);
              ld<DH>(VT + (ky * HL + kx) * LD + hh * DH, vr);
            } else {
              const size_t off = (static_cast<size_t>(y + dy) * w + x + dx) * E + c0 + hh * DH;
              ld<DH>(kv + off, kr);
              ld<DH>(vv + off, vr);
            }
            dsum = fmaf(expf(dot<DH>(qs, kr) - m_me) * inv, dot<DH>(g, vr), dsum);
          }
        }
      }
      DT[pos * HP + hh] = dsum;
    }
    __syncthreads();

    const int qi = threadIdx.x % NQ, hh = threadIdx.x / NQ;
    const int ly = qi / QT, lx = qi % QT;
    const int y = y0 + ly, x = x0 + lx;
    if (y < h && x < w) {
      const int me = (ly + R) * HL + (lx + R);
      float qs[DH], kme[DH], vme[DH], gme[DH], dq[DH], dk[DH], dv[DH];
      ld<DH>(QS + me * LD + hh * DH, qs);
      ld<DH>(KT + me * LD + hh * DH, kme);
      ld<DH>(VT + me * LD + hh * DH, vme);
      ld<DH>(GT + me * LD + hh * DH, gme);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qs[d] *= scale;
        dq[d] = dk[d] = dv[d] = 0.f;
      }
      const float m_me = MT[me * HP + hh], inv = 1.f / LT[me * HP + hh];
      const float d_me = DT[me * HP + hh];
      for (int dy = -R; dy <= R; ++dy) {
        if (y + dy < 0 || y + dy >= h) continue;
        for (int dx = -R; dx <= R; ++dx) {
          if (x + dx < 0 || x + dx >= w) continue;
          const int o = me + dy * HL + dx;
          float a[DH], b[DH];
          // me as the query, o as the key (the forward's score arithmetic)
          ld<DH>(KT + o * LD + hh * DH, a);
          ld<DH>(VT + o * LD + hh * DH, b);
          float ds = expf(dot<DH>(qs, a) - m_me) * inv * (dot<DH>(gme, b) - d_me);
#pragma unroll
          for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, a[d], dq[d]);
          // o as the query, me as the key
          ld<DH>(QS + o * LD + hh * DH, a);
          ld<DH>(GT + o * LD + hh * DH, b);
#pragma unroll
          for (int d = 0; d < DH; ++d) a[d] *= scale;
          const float pr = expf(dot<DH>(a, kme) - MT[o * HP + hh]) / LT[o * HP + hh];
          ds = pr * (dot<DH>(b, vme) - DT[o * HP + hh]);
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dk[d] = fmaf(ds, a[d], dk[d]);
            dv[d] = fmaf(pr, b[d], dv[d]);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] *= scale;
      const size_t off = (view + static_cast<size_t>(y) * w + x) * E + c0 + hh * DH;
      st<DH>(dq_out + off, dq);
      st<DH>(dk_out + off, dk);
      st<DH>(dv_out + off, dv);
    }
  }
}

inline bool bad_shape(int B, int h, int w, int heads) {
  return heads != H || B < 1 || h < 1 || w < 1;
}

inline long long n_blocks(int B, int h, int w) {
  return static_cast<long long>(B) * ((h + QT - 1) / QT) * ((w + QT - 1) / QT);
}

template <bool STATS>
int spa_attn_hp(const float* q, const float* k, const float* v, float* out, float* m, float* l,
                int B, int h, int w, int E, int heads, float scale, cudaStream_t s) {
  if (bad_shape(B, h, w, heads) || n_blocks(B, h, w) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_blocks(B, h, w));
  switch (E / H) {
#define LFT_HP_CASE(DHV)                                                      \
    case DHV: {                                                               \
      auto kernel = spa_attn_hp_kernel<DHV, STATS>;                           \
      const size_t bytes = 2 * NH * (H * DHV + 4) * sizeof(float);            \
      LFT_SET_SMEM(kernel, bytes);                                            \
      kernel<<<grid, NQ * H, bytes, s>>>(q, k, v, out, m, l, h, w, scale);    \
      break;                                                                  \
    }
    LFT_HP_CASE(4)
    LFT_HP_CASE(8)
    LFT_HP_CASE(16)
#undef LFT_HP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [B, h, w, E], E = 8 heads x {4, 8, 16}; any h, w (ragged
// tiles are masked). Each returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int lft_spa_attn_hp(const float* q, const float* k, const float* v, float* out,
                               int B, int h, int w, int E, int heads, float scale,
                               void* stream) {
  return spa_attn_hp<false>(q, k, v, out, nullptr, nullptr, B, h, w, E, heads, scale,
                            static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [B, h, w, 8] (the residuals of the backward).
extern "C" int lft_spa_attn_hp_res(const float* q, const float* k, const float* v, float* out,
                                   float* m, float* l, int B, int h, int w, int E, int heads,
                                   float scale, void* stream) {
  return spa_attn_hp<true>(q, k, v, out, m, l, B, h, w, E, heads, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_attn_hp_bwd(const float* q, const float* k, const float* v,
                                   const float* dout, const float* m, const float* l,
                                   float* dq, float* dk, float* dv, int B, int h, int w, int E,
                                   int heads, float scale, void* stream) {
  if (bad_shape(B, h, w, heads) || n_blocks(B, h, w) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(n_blocks(B, h, w));
  switch (E / H) {
#define LFT_HP_CASE(DHV)                                                      \
    case DHV: {                                                               \
      auto kernel = spa_attn_hp_bwd_kernel<DHV>;                              \
      LFT_SET_SMEM(kernel, Bwd<DHV>::BYTES);                                  \
      kernel<<<grid, Bwd<DHV>::NTB, Bwd<DHV>::BYTES, s>>>(q, k, v, dout, m, l, dq, dk, dv, \
                                                          h, w, scale);       \
      break;                                                                  \
    }
    LFT_HP_CASE(4)
    LFT_HP_CASE(8)
    LFT_HP_CASE(16)
#undef LFT_HP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
