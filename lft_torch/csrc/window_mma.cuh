// K2.3's bf16-IO window attention on the tensor cores: the kernel of
// `spa_window_attn_bf16io` and `spa_window_attn_res_bf16io` (spa_block.cu),
// and of K5's `spa_attn_hp_bf16io` and `spa_attn_hp_res_bf16io`
// (spa_attn_hp.cu), which compute the same function on the same layout.
//
// The function (lft_tpu's window softmax with io = bf16,
// lft_tpu/kernels/spa_block.py:_kernel :154-192, and spa_attn_hp.py:251-272):
// q, k, v and attn bf16 [V, h, w, 8 DH], DH in {4, 8, 16}, any h and w. A
// query's scores are (q . k) scale over its 5 x 5 window, f32; m is its max
// over all 8 heads and the window's keys, a key outside the image scoring 0
// (lft_tpu's row max over its zero-padded halo); e = exp(s - m); l the sum
// of the unrounded e over the in-image keys; o the sum of bf16(e) v, and
// attn = bf16(o (1 / l)). STATS (the `_res` forms): also m and l f32 [V, h,
// w, 8], m in every head's slot, l the head's own (what K3.c bf16io and K5
// bwd bf16io read).
//
// Bound on this card at [400, 32, 32, 128]: q, k, v read once and attn
// written once in bf16, 0.42 GB, 0.125 ms at 3.35 TB/s; its 5.2 GFLOP of
// in-window products are nothing at the bf16 rate. The design before this
// one (window_attn.cuh: window_softmax_max_heads, 0.915 ms on an H100) widened
// each halo to f32 in shared memory by the threads' own loads, staged k
// twice and v once for each of the G = D / 32 head groups, and read ~9.4 GB
// of shared memory a launch on the FP32 pipes. This one:
// * Stages every head of a halo pixel once, bf16 as it lies: a block takes
//   one 8 x 8 query tile of a view and all 8 heads, and copies the 12 x 12
//   k halo (whole 2 D-byte pixel rows) by 16-byte cp.async, zero outside
//   the image (the halo's zero), in one group and the first half of the v
//   halo's channels (heads 0-3) in a second, so that the max pass runs while
//   v arrives; the second half (heads 4-7) takes the first's place once
//   heads 0-3 are done (`WM_VS` rounds: each v byte is still staged once).
//   The 16-byte chunks of a pixel are swizzled (`wm_unit`), so that
//   ldmatrix's eight rows (eight pixels of a halo row) hit eight different
//   bank groups.
// * Shared memory: 12 x 12 x 2 D bytes of k and half that of v
//   (55,296 at D = 128, 27,648 at D = 64, 13,824 at D = 32). A 16 x 16 tile's whole
//   halos would take 204,800 bytes and one block an SM, with nothing to
//   overlap its staging; an 8 x 8 tile's with v whole (73,728) let three
//   blocks share an SM, with v in two rounds four (4 x (55,296 + 1,024) <=
//   233,472 bytes): 16 warps an SM to hide one block's staging and the
//   products' and exps' latencies under the others' work. The halos'
//   overlap (2.25x of k, v for an interior tile) is read through L2.
// * The products on the tensor cores: a warp takes a 4 x 4 patch of queries,
//   the 16 rows of `mma.sync`, whose windows span an 8 x 8 key patch: one
//   key row is an n8 tile of the scores, so a head's scores are 8 MMAs
//   (m16n8k16 at DH = 16; m16n8k8 at 8; at 4 the k8 chunk of the head pair,
//   the other head's q zero), 39% of their entries inside a window (the
//   band structure of a 16-query row tile keeps 21%). The scores' C
//   fragments of two key rows are the A fragment of the product with v
//   (bf16(e) packed in registers: no shared memory), whose B comes from
//   the v halo by ldmatrix.trans: 4 k16 MMAs a head and n8 tile. q's A
//   fragments load once from device memory into registers for all heads.
//   The FP32 alternative (FMAs on unpacked bf16 pairs) would issue ~6,400
//   FMAs and ~3,200 unpacks a query and read ~3 GB of shared memory a
//   launch; here the FP32 pipes do only the softmax on the in-window
//   entries (the exps of entries no lane's query can reach are skipped at
//   compile time).
// * The max over heads without staging twice: pass 1 runs every head's
//   score MMAs from the resident k halo for the max alone, pass 2 runs them
//   again and the softmax and the product with v; the MMAs are cheap, the
//   halo is read from shared memory, not staged again.
// * Sums: a score is the tensor cores' sum of exact bf16 products (one k16
//   MMA, two k8 at DH = 8 and 4 over the head's own channels), times scale;
//   l sums a lane's in-window entries in key-row order (columns 2 q, then
//   2 q + 1), then the quad's four lanes pairwise (xor 1, then xor 2), so
//   the four lanes hold the same l bit for bit; o is the tensor cores' sum
//   over the key rows in pairs. These orders differ from the design before,
//   which summed a score's channels in four pairwise partial sums and l by
//   key rows of five; the backward (K3.c bf16io, K5 bwd bf16io) rebuilds p
//   from its own scores and this (m, l).
// Every output is written by one thread, no atomics: a call repeats bitwise.
#pragma once

#include "bf16mma.cuh"
#include "spa.cuh"

namespace lft {

constexpr int WM_T = 8;                 // query tile: 8 x 8 pixels of a view
constexpr int WM_P = 4;                 // a warp's patch: 4 x 4 queries, the MMA's 16 rows
constexpr int WM_H = WM_T + 2 * R;      // halo: 12 x 12 pixels
constexpr int WM_K = WM_P + 2 * R;      // a patch's keys: 8 x 8 pixels, a key row an n8 tile
constexpr int WM_NT = 32 * (WM_T / WM_P) * (WM_T / WM_P);   // 128 threads
constexpr int WM_VS = 2;                // rounds of the v halo: heads 0-3, then 4-7
constexpr int WM_BLOCKS = 4;            // blocks an SM

// Bytes of the k halo at pixel width D, of a round of the v halo, and of a
// block's shared memory.
template <int D>
struct WinMma {
  static constexpr int CH = D / 8;                  // 16-byte chunks of a pixel
  static constexpr int CHV = CH / WM_VS;            // ... of a v round's pixel
  static constexpr int HALO = WM_H * WM_H * D * 2;
  static constexpr int BYTES = HALO + HALO / WM_VS;
};
static_assert(WM_BLOCKS * (WinMma<128>::BYTES + 1024) <= 233472,
              "four blocks' halos must share an SM");

// The 16-byte unit that holds chunk c of halo pixel p (CH chunks a pixel):
// chunks swizzled by the pixel, so that chunk c of eight neighbouring
// pixels (from a multiple of 4) lies in eight different 16-byte bank groups
// (at 4 chunks a pixel by pixel pairs, at 2 by pixel quads).
template <int CH>
__device__ __forceinline__ int wm_unit(int p, int c) {
  if constexpr (CH >= 8)
    return p * CH + (c ^ (p & 7));
  else if constexpr (CH == 4)
    return p * CH + (c ^ ((p >> 1) & 3));
  else
    return p * CH + (c ^ ((p >> 2) & 1));
}

// One block a (view, 8 x 8 tile) item, items in launch order; warp j takes
// the tile's 4 x 4 patch (j / 2, j % 2). Lane (g, q) holds the patch's
// queries g and g + 8 (row-major in the patch: (g / 4, g % 4) and (g / 4 +
// 2, g % 4)) and, of each key row's n8 tile, key columns 2 q and 2 q + 1.
template <int DH, bool STATS>
__global__ void __launch_bounds__(WM_NT, WM_BLOCKS)
    spa_window_attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ attn,
                               float* __restrict__ m_out, float* __restrict__ l_out, int V,
                               int h, int w, float scale) {
  constexpr int H = 8, D = H * DH, CH = WinMma<D>::CH, CHV = WinMma<D>::CHV;
  constexpr int QA = DH == 16 ? 4 : 2;   // registers of a head's q fragment (k16, or k8)
  constexpr int NO = DH == 16 ? 2 : 1;   // n8 tiles of a head's product with v
  extern __shared__ __align__(16) float smem[];   // the type the other kernels of lft declare
  unsigned char* kh = reinterpret_cast<unsigned char*>(smem);
  unsigned char* vh = kh + WinMma<D>::HALO;
  const int ntx = (w + WM_T - 1) / WM_T, per_view = ((h + WM_T - 1) / WM_T) * ntx;
  const int view = blockIdx.x / per_view, tile = blockIdx.x % per_view;
  const int y0 = tile / ntx * WM_T, x0 = tile % ntx * WM_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int py = WM_P * (warp >> 1), px = WM_P * (warp & 1);   // the patch's corner in the tile

  // chunks c0 .. c0 + N - 1 of each halo pixel of src into dst (N chunks a
  // pixel), zero outside the image; one group
  auto stage = [&](const bf16* __restrict__ src, unsigned char* dst, auto n, int c0) {
    constexpr int N = decltype(n)::value;
    for (int i = threadIdx.x; i < WM_H * WM_H * N; i += WM_NT) {
      const int p = i / N, c = i % N;
      const int ky = y0 - R + p / WM_H, kx = x0 - R + p % WM_H;
      const bool ok = ky >= 0 && ky < h && kx >= 0 && kx < w;
      const size_t off =
          ok ? ((static_cast<size_t>(view) * h + ky) * w + kx) * D + 8 * (c0 + c) : 0;
      cp_async16v(dst + 16 * wm_unit<N>(p, c), src + off, ok);
    }
    cp_async_commit();
  };
  stage(k, kh, std::integral_constant<int, CH>{}, 0);    // the k halo, every head
  stage(v, vh, std::integral_constant<int, CHV>{}, 0);   // the v halo's first round

  // the lane's two queries (zero outside the image) as A fragments of every head
  const int qx = g & 3, qy = g >> 2;   // query g's place in the patch; g + 8 is (qy + 2, qx)
  const int x = x0 + px + qx;
  int y[2];
  bool in[2];
  uint32_t qa[H][QA];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    y[hh] = y0 + py + qy + 2 * hh;
    in[hh] = y[hh] < h && x < w;
    const unsigned* qp = reinterpret_cast<const unsigned*>(
        q + (in[hh] ? ((static_cast<size_t>(view) * h + y[hh]) * w + x) * D : 0));
    auto ld = [&](int c) { return in[hh] ? __ldg(qp + c / 2) : 0u; };
#pragma unroll
    for (int e = 0; e < H; ++e) {
      if constexpr (DH == 16) {
        qa[e][hh] = ld(16 * e + 2 * qd);
        qa[e][2 + hh] = ld(16 * e + 8 + 2 * qd);
      } else if constexpr (DH == 8) {
        qa[e][hh] = ld(8 * e + 2 * qd);
      } else {   // the head pair's chunk, the other head's channels zero
        qa[e][hh] = (qd >> 1) == (e & 1) ? ld(8 * (e / 2) + 2 * qd) : 0u;
      }
    }
  }

  // head e's raw scores q . k: s[r][2 hh + c] is query g + 8 hh against key
  // (row r, column 2 q + c) of the patch's 8 x 8 keys
  auto scores = [&](int e, float (&s)[WM_K][4]) {
#pragma unroll
    for (int r = 0; r < WM_K; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    if constexpr (DH == 16) {
#pragma unroll
      for (int r = 0; r < WM_K; r += 2) {   // matrices (row r + i / 2, k half i % 2)
        uint32_t b[4];
        const int p = (py + r + (lane >> 4)) * WM_H + px + (lane & 7);
        ldmatrix_x4(b, kh + 16 * wm_unit<CH>(p, 2 * e + ((lane >> 3) & 1)));
        mma_bf16(s[r], qa[e], b[0], b[1]);
        mma_bf16(s[r + 1], qa[e], b[2], b[3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < WM_K; r += 4) {   // matrices (row r + i)
        uint32_t b[4];
        const int p = (py + r + (lane >> 3)) * WM_H + px + (lane & 7);
        ldmatrix_x4(b, kh + 16 * wm_unit<CH>(p, DH == 8 ? e : e / 2));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_k8(s[r + j], qa[e], b[j]);
      }
    }
  };
  // whether key column 2 q + c lies in query column qx's window
  const bool cv[2] = {static_cast<unsigned>(2 * qd - qx) <= 4u,
                      static_cast<unsigned>(2 * qd + 1 - qx) <= 4u};
  // key row r lies in query g + 8 hh's window (rows qy + 2 hh .. + 4; rows
  // outside [2 hh, 5 + 2 hh] never do, for any lane)
  auto row_in = [&](int r, int hh) {
    return static_cast<unsigned>(r - qy - 2 * hh) <= 4u;
  };

  // pass 1: each query's max over its heads and window (out-of-image keys
  // score 0: their halo pixels are zero)
  cp_async_wait<1>();
  __syncthreads();
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int e = 0; e < H; ++e) {
    float s[WM_K][4];
    scores(e, s);
#pragma unroll
    for (int r = 0; r < WM_K; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (r < 2 * hh || r > 5 + 2 * hh) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (row_in(r, hh) && cv[c]) m[hh] = fmaxf(m[hh], s[r][2 * hh + c]);
      }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    m[hh] *= scale;   // scale > 0: the max of the scaled scores
  }

  // pass 2: the softmax and the product with v, head by head
  cp_async_wait<0>();
  __syncthreads();
  const int ky0 = y0 + py - R, kx0 = x0 + px - R + 2 * qd;   // the patch's key row 0, the lane's column
  const bool col_img[2] = {kx0 >= 0 && kx0 < w, kx0 + 1 >= 0 && kx0 + 1 < w};
#pragma unroll
  for (int e = 0; e < H; ++e) {
    if (e > 0 && e % (H / WM_VS) == 0) {   // the v halo's next round
      __syncthreads();
      stage(v, vh, std::integral_constant<int, CHV>{}, e / (H / WM_VS) * CHV);
      cp_async_wait<0>();
      __syncthreads();
    }
    float s[WM_K][4];
    scores(e, s);
    float l[2] = {0.f, 0.f};
    uint32_t pa[WM_K][2];   // bf16(e) of key row r, query g + 8 hh: the A fragments' pairs
#pragma unroll
    for (int r = 0; r < WM_K; ++r) {
      const bool row_img = ky0 + r >= 0 && ky0 + r < h;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p[2] = {0.f, 0.f};
        if (r >= 2 * hh && r <= 5 + 2 * hh) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (row_in(r, hh) && cv[c]) {
              const float ex = expf(s[r][2 * hh + c] * scale - m[hh]);
              if (row_img && col_img[c]) l[hh] += ex;
              p[c] = ex;
            }
        }
        pa[r][hh] = narrow2(p[0], p[1]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
    // k16 step t: key rows 2 t (k 0-7) and 2 t + 1 (k 8-15)
    auto pv = [&](int t, uint32_t b0, uint32_t b1, int n) {
      const uint32_t a[4] = {pa[2 * t][0], pa[2 * t][1], pa[2 * t + 1][0], pa[2 * t + 1][1]};
      mma_bf16(o[n], a, b0, b1);
    };
    if constexpr (DH == 16) {
#pragma unroll
      for (int t = 0; t < WM_K / 2; ++t) {   // matrices (row 2 t + i % 2, chunk 2 e + i / 2)
        uint32_t b[4];
        const int p = (py + 2 * t + ((lane >> 3) & 1)) * WM_H + px + (lane & 7);
        ldmatrix_x4_trans(b, vh + 16 * wm_unit<CHV>(p, (2 * e + (lane >> 4)) % CHV));
        pv(t, b[0], b[1], 0);
        pv(t, b[2], b[3], 1);
      }
    } else {
#pragma unroll
      for (int t = 0; t < WM_K / 2; t += 2) {   // matrices (row 2 t + i)
        uint32_t b[4];
        const int p = (py + 2 * t + (lane >> 3)) * WM_H + px + (lane & 7);
        ldmatrix_x4_trans(b, vh + 16 * wm_unit<CHV>(p, (DH == 8 ? e : e / 2) % CHV));
        pv(t, b[0], b[1], 0);
        pv(t + 1, b[2], b[3], 0);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!in[hh]) continue;
      const size_t pix = (static_cast<size_t>(view) * h + y[hh]) * w + x;
      const float inv = 1.f / l[hh];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = DH == 4 ? 8 * (e / 2) + 2 * qd : DH * e + 8 * n + 2 * qd;
        if (DH != 4 || (qd >> 1) == (e & 1))
          *reinterpret_cast<uint32_t*>(attn + pix * D + col) =
              narrow2(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
      }
      if constexpr (STATS) {
        if (qd == 0) {
          l_out[pix * H + e] = l[hh];
          m_out[pix * H + e] = m[hh];
        }
      }
    }
  }
}

// The launch: V * ceil(h / 8) * ceil(w / 8) blocks of WM_NT threads.
template <bool STATS>
int launch_window_mma(const bf16* q, const bf16* k, const bf16* v, bf16* attn, float* m,
                      float* l, int V, int h, int w, int D, int H, float scale,
                      cudaStream_t s) {
  if (H != 8 || V < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(V) * ((h + WM_T - 1) / WM_T) *
                          ((w + WM_T - 1) / WM_T);
  if (items > 0x7fffffffLL || static_cast<long long>(V) * h * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define LFT_WM_CASE(DV)                                                                     \
    case DV: {                                                                              \
      auto kernel = spa_window_attn_mma_kernel<DV / 8, STATS>;                              \
      LFT_SET_SMEM(kernel, WinMma<DV>::BYTES);                                              \
      kernel<<<static_cast<int>(items), WM_NT, WinMma<DV>::BYTES, s>>>(q, k, v, attn, m, l, \
                                                                       V, h, w, scale);     \
      break;                                                                                \
    }
    LFT_WM_CASE(32)
    LFT_WM_CASE(64)
    LFT_WM_CASE(128)
#undef LFT_WM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lft
