// K10: tile-halo 5x5-window attention on projected q/k/v images, forward only.
//
// Replaces lft_tpu/kernels/local_attn.py:_windowed_attention_pallas (the
// Pallas TPU kernel _window_kernel, the JAX package's fallback for views too
// large for its per-view kernels). For every view b, 8 x 8 query tile, head hh
// of 8 and query (y, x) of the tile, over ALL (8 + 4)^2 = 144 keys of the
// tile's halo of q, k, v [B, h, w, E] (dh = E / 8):
//   s_j = (q * scale) . k_j + mask_j     mask_j = 0 where key j lies inside the
//                                        image and the query's 5x5 window,
//                                        -1e30 elsewhere
//   m = max_j s_j   e_j = exp(s_j - m)   out = (sum_j e_j v_j) / sum_j e_j
// the plain softmax of the TPU kernel (max, exp, sum, divide), not an online
// one. It is the function of K5, K6, K9 and K2.3 by another algorithm: those
// score the <= 25 window keys of a query (or skip the rest), this one scores
// the whole halo densely and lets the additive mask take 119 of the 144 keys
// out again, 5.8 times the window's products. A masked score is exactly -1e30
// in f32 (|s| << 1e22), its exp exactly 0, and a query's own pixel is always
// in its window, so no row is fully masked and the result equals the skipping
// kernels' up to the order of the sums. No backward: the TPU kernel has none.
//
// The TPU kernel is handed zero-padded copies of k and v and a mask tensor
// [tiles, 64, 144]. Here nothing is padded or materialised: the block stages
// the halo's full rows from the unpadded images with zeros outside the image
// (coalesced float4 loads, as K5 does), and a thread rebuilds its query's mask
// from two 12-bit row / column words. One block serves all heads of a tile:
// 512 threads = 64 queries x 8 heads, the 32 threads of a warp are queries of
// one head and read the same key row at the same time (a shared-memory
// broadcast). The first pass takes the row max, the second recomputes the
// score for exp, sum and the product with v: 144 x 3 dh FMA a (query, head)
// and no score buffer (64 x 144 x 8 scores would be 295 KB). Views tile
// exactly (h, w multiples of 8, the TPU gate); the tiles of all views lie
// along gridDim.x, so 64 x 64 views at B = 400 are 25,600 blocks.
//
// Bound on this card: the bytes. At [400, 32, 32, 128] it moves 4 x 210 MB
// (0.25 ms at 3.35 TB/s) and a minimal algorithm needs 4.9 GFLOP for the
// window pairs inside the image; the dense halo makes it 45 GFLOP on the FP32
// pipes, which is what the kernel's time follows.

#include "attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;               // heads
constexpr int QT = 8;              // query tile edge
constexpr int HL = QT + 2 * R;     // halo edge
constexpr int NQ = QT * QT, NH = HL * HL;
constexpr float NEG = -1e30f;      // the additive mask of lft_tpu's _halo_mask

template <int DH>
__global__ void __launch_bounds__(NQ * H)
    spa_attn_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int h, int w,
                         float scale) {
  constexpr int E = H * DH, LD = E + 4;
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);   // [NH][LD]
  float* VT = KT + NH * LD;
  const int ntw = w / QT, nth = h / QT;
  const int tile = blockIdx.x % (nth * ntw);
  const int y0 = (tile / ntw) * QT, x0 = (tile % ntw) * QT;
  const size_t view = static_cast<size_t>(blockIdx.x / (nth * ntw)) * h * w;
  stage_tile_halo<E, QT>(KT, k + view * E, E, 0, y0, x0, h, w, NQ * H);
  stage_tile_halo<E, QT>(VT, v + view * E, E, 0, y0, x0, h, w, NQ * H);
  __syncthreads();

  const int qi = threadIdx.x % NQ, hh = threadIdx.x / NQ;
  const int ly = qi / QT, lx = qi % QT;
  // bit j of rows / cols: halo row / column j is inside the image and within
  // R of the query's own row / column
  unsigned rows = 0, cols = 0;
#pragma unroll
  for (int j = 0; j < HL; ++j) {
    const int gy = y0 - R + j, gx = x0 - R + j;
    if (gy >= 0 && gy < h && abs(j - R - ly) <= R) rows |= 1u << j;
    if (gx >= 0 && gx < w && abs(j - R - lx) <= R) cols |= 1u << j;
  }
  const size_t off = (view + static_cast<size_t>(y0 + ly) * w + x0 + lx) * E + hh * DH;
  float qs[DH], o[DH];
  ldg<DH>(q + off, qs);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qs[d] *= scale;
    o[d] = 0.f;
  }

  float m = -CUDART_INF_F;
  for (int ky = 0; ky < HL; ++ky) {
    const unsigned row = (rows >> ky) & 1u ? cols : 0u;
    for (int kx = 0; kx < HL; ++kx) {
      float kr[DH];
      ld<DH>(KT + (ky * HL + kx) * LD + hh * DH, kr);
      const float s = dot<DH>(qs, kr) + ((row >> kx) & 1u ? 0.f : NEG);
      m = fmaxf(m, s);
    }
  }
  float l = 0.f;
  for (int ky = 0; ky < HL; ++ky) {
    const unsigned row = (rows >> ky) & 1u ? cols : 0u;
    for (int kx = 0; kx < HL; ++kx) {
      const int key = ky * HL + kx;
      float kr[DH], vr[DH];
      ld<DH>(KT + key * LD + hh * DH, kr);
      ld<DH>(VT + key * LD + hh * DH, vr);
      const float e = expf(dot<DH>(qs, kr) + ((row >> kx) & 1u ? 0.f : NEG) - m);
      l += e;
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(e, vr[d], o[d]);
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] *= inv;
  st<DH>(out + off, o);
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [B, h, w, E], E = 8 heads x {4, 8, 16}; h and w multiples of
// 8. Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int lft_spa_attn_tile(const float* q, const float* k, const float* v, float* out,
                                 int B, int h, int w, int E, int heads, float scale,
                                 void* stream) {
  const long long blocks = static_cast<long long>(B) * (h / QT) * (w / QT);
  if (heads != H || B < 1 || h < QT || w < QT || h % QT || w % QT || E % H ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(blocks);
  switch (E / H) {
#define LFT_TILE_CASE(DHV)                                                  \
    case DHV: {                                                             \
      auto kernel = spa_attn_tile_kernel<DHV>;                              \
      const size_t bytes = 2 * NH * (H * DHV + 4) * sizeof(float);          \
      LFT_SET_SMEM(kernel, bytes);                                          \
      kernel<<<grid, NQ * H, bytes, s>>>(q, k, v, out, h, w, scale);        \
      break;                                                                \
    }
    LFT_TILE_CASE(4)
    LFT_TILE_CASE(8)
    LFT_TILE_CASE(16)
#undef LFT_TILE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
