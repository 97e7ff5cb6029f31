// K2.3: the 5x5-window attention kernel of K2 (spa_block.cu, step 3),
// which K5's forward (spa_attn_hp.cu, `spa_attn_hp` and `spa_attn_hp_res`)
// launches too: the same function on the same layout, q, k, v and the
// output [V, h, w, 8 DH], m and l [V, h, w, 8] (pixel * 8 + head).
#pragma once

#include "spa.cuh"
#include "tf32.cuh"
#include "window_mma.cuh"

namespace lft {

// Replaces the window attention of lft_tpu/kernels/spa_block.py:_kernel
// (:154-192): per query the scores over its 5x5 window, out-of-image keys
// skipped (never scored), a softmax per head, the product with v; with
// STATS (training) also the softmax max m and sum l of exp(s - m) per query
// and head, [V, h, w, H], for the backward (K3.c).
// Bound: q, k, v read once and attn written once, 4 T D floats: at [400,
// 32, 32, 64] 0.84 GB, 0.2504 ms at 3.35 TB/s (with STATS at [100, 32, 32,
// 64] 0.0646 ms); its 5.2 GFLOP (0.08 ms on the FP32 pipes) bind nothing.
// The first design (one head of one 16 x 16 tile a block, one query a
// thread reading all 25 keys' k and v rows from shared memory) read 3.2 KB
// of shared memory a query and head, 10.5 GB at that shape: at the SMs'
// ~128 bytes a clock, ~0.35 ms, a floor above the bound, and its halo
// loads overlapped nothing. This design:
// * Head groups of 32 floats: a block takes the heads of one 128-byte line
//   of a pixel (2 at DH = 16, 4 at 8, 8 at 4) for one 16 x 16 query tile,
//   so k and v are read as whole lines. A thread owns 16 floats of the
//   group (one head at DH = 16, two at 8, four at 4) for WA_QY = 2 queries
//   down a column, and reads each key of the 6 x 5 keys their windows span
//   once, for every one of its queries whose window holds it: 15 key reads
//   a query where the first design took 25.
// * The block stages the 20 x 20 k/v halo of its group by cp.async (one
//   buffer of 20 x 20 pixels x (32 + 4) floats for k and v, 113 KB), loads
//   its q meanwhile, and two blocks share an SM (16 warps), so one block's
//   staging overlaps the other's work. A persistent block of 4 warps that
//   staged its next tile into a second buffer while computing (2.5x fewer
//   reads, 4 queries a thread) took 1.4x the time on an H100: with one warp
//   a scheduler nothing hid the shared-memory and FP32 latencies. The
//   halos' overlap (1.56x of k, v for an interior tile; 1.27x at 32 x 32
//   views, where the image borders clip them) is left to L2.
// * A two-pass softmax: a thread holds its queries' 25 scores of a head,
//   takes their max, then one exp a key and the sums l and o; 25 exps a
//   query where the first design's online softmax took 50, and no
//   rescaling of l and o by exp(m - m'), whose roundings cost l accuracy.
//   A score is four partial sums of its head's channels, added pairwise; l
//   the sums of the five key rows; o runs in key order (all held to the
//   plain version's tolerance and to float64).
// Every output is written by one thread, no atomics: a call repeats bitwise.
//
// IO = bf16 (`--dtype bfloat16` serving through the per-op branch: the
// bf16-IO instances of K9 `spa_attn_offset_bf16io` and K10
// `spa_attn_tile_bf16io`, spa_attn_hp.cu): lft_tpu's K9 and K10 kernels
// widen bf16 q, k, v to f32 and round the output once
// (local_attn_vjp.py:_fwd_kernel :48-116, local_attn.py:_window_kernel
// :44-80), and so does this instance: the halos staged by the threads' 8-byte
// loads widened to f32 (`copy4`; cp.async copies bytes), q widened as it
// loads, the f32 arithmetic above, attn rounded to bf16 as it is stored.
// NORM (with IO = bf16: K6 `spa_attn_mxu_bf16io`, lft_tpu's
// spa_attn.py:_fwd_kernel :72-116, which normalizes per head before the
// product): scores (q . k) scale from the unscaled q, m the head's own max,
// p = bf16(e / l), attn = the sum of p v, rounded once. Bound at [400, 32,
// 32, 128]: q, k, v read and attn written once in bf16, 0.42 GB, 0.125 ms
// (at [400, 64, 64, 128] 0.501 ms; at [400, 30, 30, 128] 0.110 ms).
constexpr int WA_TX = 16, WA_TY = 16;                 // query tile
constexpr int WA_QY = 2;                              // queries a thread, down a column
constexpr int WA_HX = WA_TX + 2 * R, WA_HY = WA_TY + 2 * R;   // k/v halo
constexpr int WA_G = 32;                              // floats of a head group (128 bytes)
constexpr int WA_S = 16;                              // floats of a thread's slice of it
constexpr int WA_LD = WA_G + 4;                       // halo pixel stride: float4 reads of
                                                      // 8 neighbouring pixels hit 32 banks
constexpr int WA_NT = WA_TX * (WA_TY / WA_QY) * (WA_G / WA_S);   // 256 threads
constexpr int WA_BUF = WA_HY * WA_HX * WA_LD;         // floats of a k (or v) halo
constexpr size_t WA_BYTES = 2 * static_cast<size_t>(WA_BUF) * sizeof(float);
static_assert(2 * (WA_BYTES + 1024) <= 233472, "two blocks' halos must share an SM");

// One block an item (view, 16 x 16 tile, head group), items in launch order.
template <int DH, bool STATS, bool NORM = false, class IO = float>
__global__ void __launch_bounds__(WA_NT, 2)
    spa_window_attn_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                           const IO* __restrict__ v, IO* __restrict__ attn,
                           float* __restrict__ m_out, float* __restrict__ l_out, int V,
                           int h, int w, float scale) {
  constexpr int H = 8, D = H * DH;
  constexpr int G = D / WA_G;       // head groups of a pixel
  constexpr int HT = WA_S / DH;     // heads of a thread's slice
  constexpr int KR = WA_QY + 2 * R;   // key rows of a thread's queries
  constexpr int KW = (2 * R + 1) * (2 * R + 1);   // keys of a window
  extern __shared__ __align__(16) float smem[];
  const int ntx = (w + WA_TX - 1) / WA_TX;
  const int per_view = ((h + WA_TY - 1) / WA_TY) * ntx * G;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, half = lane >> 4;    // the thread's column and slice
  const int ry = WA_QY * (threadIdx.x >> 5);     // its first query row in the tile
  const int i = blockIdx.x, tile = i % per_view / G;
  const int view = i / per_view, y0 = tile / ntx * WA_TY, x0 = tile % ntx * WA_TX, g = i % G;
  // the item's k and v halos, zero outside the image
  const float* buf = smem;
  for (int j = threadIdx.x; j < WA_HY * WA_HX * (WA_G / 4); j += WA_NT) {
    const int px = j / (WA_G / 4), c = 4 * (j % (WA_G / 4));
    const int ky = y0 - R + px / WA_HX, kx = x0 - R + px % WA_HX;
    const bool ok = ky >= 0 && ky < h && kx >= 0 && kx < w;
    const size_t off =
        ok ? ((static_cast<size_t>(view) * h + ky) * w + kx) * D + g * WA_G + c : 0;
    copy4(smem + px * WA_LD + c, k + off, ok);
    copy4(smem + WA_BUF + px * WA_LD + c, v + off, ok);
  }
  cp_async_commit();
  {
    const int x = x0 + tx;
    const size_t col = g * WA_G + half * WA_S;   // the slice's first channel
    const float qs = NORM ? 1.f : scale;         // q scaled before the product, but for NORM
    float qv[WA_QY][WA_S];
#pragma unroll
    for (int a = 0; a < WA_QY; ++a) {
      const int y = y0 + ry + a;
      const bool in = y < h && x < w;
      const IO* qp = q + ((static_cast<size_t>(view) * h + (in ? y : 0)) * w +
                          (in ? x : 0)) * D + col;
#pragma unroll
      for (int d = 0; d < WA_S; d += 4) {
        const float4 t = in ? ldg4(qp + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[a][d] = t.x * qs;
        qv[a][d + 1] = t.y * qs;
        qv[a][d + 2] = t.z * qs;
        qv[a][d + 3] = t.w * qs;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int e = 0; e < HT; ++e) {   // the heads of the thread's slice
      // query a's window, row-major: s[a][5 (key row - a) + dx]; -inf where
      // the key lies outside the image
      float s[WA_QY][KW];
#pragma unroll
      for (int a = 0; a < WA_QY; ++a)
#pragma unroll
        for (int j = 0; j < KW; ++j) s[a][j] = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < KR; ++r) {   // key row ry + r - 2 of the tile
        const int ky = y0 + ry + r - R;
        if (ky < 0 || ky >= h) continue;
        // the thread's key (r, dx) is halo pixel (ry + r, tx + dx)
        const float* kr = buf + ((ry + r) * WA_HX + tx) * WA_LD + half * WA_S + e * DH;
#pragma unroll
        for (int dx = 0; dx <= 2 * R; ++dx) {
          const int kx = x + dx - R;
          if (kx < 0 || kx >= w) continue;
          float kk[DH];
#pragma unroll
          for (int d = 0; d < DH; d += 4) {
            const float4 t = load4(kr + dx * WA_LD + d);
            kk[d] = t.x;
            kk[d + 1] = t.y;
            kk[d + 2] = t.z;
            kk[d + 3] = t.w;
          }
#pragma unroll
          for (int a = 0; a < WA_QY; ++a) {
            if (a < r - 2 * R || a > r) continue;
            float t[4] = {0.f, 0.f, 0.f, 0.f};   // four partial sums, added pairwise
#pragma unroll
            for (int d = 0; d < DH; ++d) t[d % 4] = fmaf(qv[a][e * DH + d], kk[d], t[d % 4]);
            const float sc = (t[0] + t[1]) + (t[2] + t[3]);
            s[a][(2 * R + 1) * (r - a) + dx] = NORM ? sc * scale : sc;
          }
        }
      }
      float m[WA_QY], l[WA_QY];
#pragma unroll
      for (int a = 0; a < WA_QY; ++a) {
        m[a] = s[a][0];
#pragma unroll
        for (int j = 1; j < KW; ++j) m[a] = fmaxf(m[a], s[a][j]);
        l[a] = 0.f;
#pragma unroll
        for (int j0 = 0; j0 < KW; j0 += 2 * R + 1) {   // a key row's sum, then the rows'
          float row = 0.f;
#pragma unroll
          for (int j = j0; j < j0 + 2 * R + 1; ++j) {
            s[a][j] = expf(s[a][j] - m[a]);
            row += s[a][j];
          }
          l[a] += row;
        }
        if constexpr (NORM) {   // p = bf16(e / l) before the product with v
#pragma unroll
          for (int j = 0; j < KW; ++j) s[a][j] = bf16_round(s[a][j] / l[a]);
        }
      }
      float o[WA_QY][DH];
#pragma unroll
      for (int a = 0; a < WA_QY; ++a)
#pragma unroll
        for (int d = 0; d < DH; ++d) o[a][d] = 0.f;
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int ky = y0 + ry + r - R;
        if (ky < 0 || ky >= h) continue;
        const float* vr = buf + WA_BUF + ((ry + r) * WA_HX + tx) * WA_LD + half * WA_S + e * DH;
#pragma unroll
        for (int dx = 0; dx <= 2 * R; ++dx) {
          const int kx = x + dx - R;
          if (kx < 0 || kx >= w) continue;
          float vv[DH];
#pragma unroll
          for (int d = 0; d < DH; d += 4) {
            const float4 t = load4(vr + dx * WA_LD + d);
            vv[d] = t.x;
            vv[d + 1] = t.y;
            vv[d + 2] = t.z;
            vv[d + 3] = t.w;
          }
#pragma unroll
          for (int a = 0; a < WA_QY; ++a) {
            if (a < r - 2 * R || a > r) continue;
            const float p = s[a][(2 * R + 1) * (r - a) + dx];
#pragma unroll
            for (int d = 0; d < DH; ++d) o[a][d] = fmaf(p, vv[d], o[a][d]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < WA_QY; ++a) {
        const int y = y0 + ry + a;
        if (y >= h || x >= w) continue;
        const size_t pix = (static_cast<size_t>(view) * h + y) * w + x;
        const float inv = NORM ? 1.f : 1.f / l[a];
#pragma unroll
        for (int d = 0; d < DH; d += 4)
          st4(attn + pix * D + col + e * DH + d,
              make_float4(o[a][d] * inv, o[a][d + 1] * inv, o[a][d + 2] * inv,
                          o[a][d + 3] * inv));
        if constexpr (STATS) {
          const size_t hd = pix * H + (col + e * DH) / DH;
          m_out[hd] = m[a];
          l_out[hd] = l[a];
        }
      }
    }
  }
}

// lft_tpu's window softmax (spa_block.py:_kernel :154-192) as its bf16-IO
// form computes it (window_mma.cuh), on f32 q, k, v: the scores f32 over
// the keys inside the image; e = exp(s - m) with m the query's max over
// EVERY head and its window's keys, a key outside the image scoring 0
// (lft_tpu's row max over its zero-padded halo), so that bf16(e) rounds as
// there; l the sum of the unrounded e (rows, then their sum, as above), o
// the sum of bf16(e) v in key order, attn = o (1 / l). A query's heads lie
// in all G head groups, so a block takes a (view, 16 x 16 tile) item and
// its groups twice: a first pass stages each group's k halo and takes every
// query's max over its heads (the two slices of a group in lanes 16 apart),
// a second stages k and v and runs the softmax. The threads, halos and
// shared memory are the f32 kernel's. The scores are (q . k) scale, as
// lft_tpu orders them.
// `spa_window_attn_bf16` (`--dtype mixed` serving under
// LFT_MM_HP_SITES=none; lft_tpu's K2 with mm_half, :141-192): f32 q, k, v
// rounded to bf16 as they are loaded (the `score` and `av` sites), the same
// softmax with e rounded through the product, attn f32; bound at [400, 32,
// 32, 128]: q, k, v, attn in f32, 0.84 GB, 0.250 ms. With STATS
// (`spa_window_attn_res_bf16`, `--dtype mixed` training under
// LFT_MM_HP_SITES=none: lft_tpu's K2 res with mm_half, :176-179, 346-348):
// also m and l [V, h, w, H] f32, m the query's max over its heads (and 0
// where its window leaves the image) in every head's slot, l the head's sum
// under it, and attn rounded to bf16 as it is stored (lft_tpu stores the
// residual at the `wo` site's dtype; K3.a reads it under either backward
// plan). SITES (`spa_window_attn[_res]_sites`, `--dtype mixed` under an
// LFT_MM_HP_SITES subset; lft_tpu's K2 with that plan, :144-190): each
// rounding as its site's bit of the mask `sites` says (tf32.cuh): q and k
// as they load where `score` rounds, v and e where `av` does, and with
// STATS the stored attn where `wo` does; the same two passes and m
// (lft_tpu's row max is the query's over its heads at every plan), so m and
// l are `_res_bf16`'s form. Bound: as `spa_window_attn_bf16`'s.
template <int DH, bool STATS, bool SITES = false>
__device__ __forceinline__ void window_softmax_max_heads(const float* __restrict__ q,
                                                         const float* __restrict__ k,
                                                         const float* __restrict__ v,
                                                         float* __restrict__ attn,
                                                         float* __restrict__ m_out,
                                                         float* __restrict__ l_out, int V,
                                                         int h, int w, float scale,
                                                         int sites = 0) {
  // what rounds: every operand but for SITES its site's bit
  const bool r_score = !SITES || (sites & S_SCORE), r_av = !SITES || (sites & S_AV),
             r_wo = !SITES || (sites & S_WO);
  constexpr int H = 8, D = H * DH;
  constexpr int G = D / WA_G;       // head groups of a pixel
  constexpr int HT = WA_S / DH;     // heads of a thread's slice
  constexpr int KR = WA_QY + 2 * R;   // key rows of a thread's queries
  constexpr int KW = (2 * R + 1) * (2 * R + 1);   // keys of a window
  extern __shared__ __align__(16) float smem[];
  const int ntx = (w + WA_TX - 1) / WA_TX;
  const int per_view = ((h + WA_TY - 1) / WA_TY) * ntx;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, half = lane >> 4;    // the thread's column and slice
  const int ry = WA_QY * (threadIdx.x >> 5);     // its first query row in the tile
  const int view = blockIdx.x / per_view, tile = blockIdx.x % per_view;
  const int y0 = tile / ntx * WA_TY, x0 = tile % ntx * WA_TX, x = x0 + tx;

  // group g's halo of src [V, h, w, D] into buf, zero outside the image
  // (f32 values rounded to bf16 where `r16`)
  auto stage = [&](const float* __restrict__ src, float* buf, int g, bool r16) {
    for (int j = threadIdx.x; j < WA_HY * WA_HX * (WA_G / 4); j += WA_NT) {
      const int px = j / (WA_G / 4), c = 4 * (j % (WA_G / 4));
      const int ky = y0 - R + px / WA_HX, kx = x0 - R + px % WA_HX;
      const bool ok = ky >= 0 && ky < h && kx >= 0 && kx < w;
      float4 t = ok ? ldg4(src + ((static_cast<size_t>(view) * h + ky) * w + kx) * D + g * WA_G + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      if (r16)
        t = make_float4(bf16_round(t.x), bf16_round(t.y), bf16_round(t.z), bf16_round(t.w));
      store4(buf + px * WA_LD + c, t);
    }
  };
  // the thread's slice of group g of its queries' q (zero outside the image)
  auto load_q = [&](int g, float (&qv)[WA_QY][WA_S]) {
#pragma unroll
    for (int a = 0; a < WA_QY; ++a) {
      const int y = y0 + ry + a;
      const bool in = y < h && x < w;
      const float* qp = q + ((static_cast<size_t>(view) * h + (in ? y : 0)) * w + (in ? x : 0)) * D +
                     g * WA_G + half * WA_S;
#pragma unroll
      for (int d = 0; d < WA_S; d += 4) {
        const float4 t = in ? ldg4(qp + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        const bool kept = !r_score;
        qv[a][d] = kept ? t.x : bf16_round(t.x);
        qv[a][d + 1] = kept ? t.y : bf16_round(t.y);
        qv[a][d + 2] = kept ? t.z : bf16_round(t.z);
        qv[a][d + 3] = kept ? t.w : bf16_round(t.w);
      }
    }
  };
  // head e of the slice: s[a][5 (key row - a) + dx], -inf outside the image
  auto scores = [&](const float (&qv)[WA_QY][WA_S], int e, float (&s)[WA_QY][KW]) {
#pragma unroll
    for (int a = 0; a < WA_QY; ++a)
#pragma unroll
      for (int j = 0; j < KW; ++j) s[a][j] = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const int ky = y0 + ry + r - R;
      if (ky < 0 || ky >= h) continue;
      const float* kr = smem + ((ry + r) * WA_HX + tx) * WA_LD + half * WA_S + e * DH;
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) {
        const int kx = x + dx - R;
        if (kx < 0 || kx >= w) continue;
#pragma unroll
        for (int a = 0; a < WA_QY; ++a) {
          if (a < r - 2 * R || a > r) continue;
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 0; d < DH; ++d)
            t[d % 4] = fmaf(qv[a][e * DH + d], kr[dx * WA_LD + d], t[d % 4]);
          s[a][(2 * R + 1) * (r - a) + dx] = ((t[0] + t[1]) + (t[2] + t[3])) * scale;
        }
      }
    }
  };

  float qv[WA_QY][WA_S], s[WA_QY][KW];
  float mq[WA_QY] = {-CUDART_INF_F, -CUDART_INF_F};
  for (int g = 0; g < G; ++g) {   // pass 1: each query's max over its heads
    __syncthreads();   // the previous group's halo is read
    stage(k, smem, g, r_score);
    load_q(g, qv);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < HT; ++e) {
      scores(qv, e, s);
#pragma unroll
      for (int a = 0; a < WA_QY; ++a)
#pragma unroll
        for (int j = 0; j < KW; ++j) mq[a] = fmaxf(mq[a], s[a][j]);
    }
  }
#pragma unroll
  for (int a = 0; a < WA_QY; ++a) {
    mq[a] = fmaxf(mq[a], __shfl_xor_sync(0xffffffffu, mq[a], 16));
    const int y = y0 + ry + a;
    if (y < R || y + R >= h || x < R || x + R >= w) mq[a] = fmaxf(mq[a], 0.f);
  }
  for (int g = 0; g < G; ++g) {   // pass 2: the softmax and the product with v
    __syncthreads();
    stage(k, smem, g, r_score);
    stage(v, smem + WA_BUF, g, r_av);
    load_q(g, qv);
    __syncthreads();
    const int col = g * WA_G + half * WA_S;
#pragma unroll
    for (int e = 0; e < HT; ++e) {
      scores(qv, e, s);
      float l[WA_QY];
#pragma unroll
      for (int a = 0; a < WA_QY; ++a) {
        l[a] = 0.f;
#pragma unroll
        for (int j0 = 0; j0 < KW; j0 += 2 * R + 1) {   // a key row's sum, then the rows'
          float row = 0.f;
#pragma unroll
          for (int j = j0; j < j0 + 2 * R + 1; ++j) {
            const float ex = expf(s[a][j] - mq[a]);
            row += ex;
            s[a][j] = r_av ? bf16_round(ex) : ex;
          }
          l[a] += row;
        }
      }
      float o[WA_QY][DH];
#pragma unroll
      for (int a = 0; a < WA_QY; ++a)
#pragma unroll
        for (int d = 0; d < DH; ++d) o[a][d] = 0.f;
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int ky = y0 + ry + r - R;
        if (ky < 0 || ky >= h) continue;
        const float* vr =
            smem + WA_BUF + ((ry + r) * WA_HX + tx) * WA_LD + half * WA_S + e * DH;
#pragma unroll
        for (int dx = 0; dx <= 2 * R; ++dx) {
          const int kx = x + dx - R;
          if (kx < 0 || kx >= w) continue;
#pragma unroll
          for (int a = 0; a < WA_QY; ++a) {
            if (a < r - 2 * R || a > r) continue;
            const float p = s[a][(2 * R + 1) * (r - a) + dx];
#pragma unroll
            for (int d = 0; d < DH; ++d) o[a][d] = fmaf(p, vr[dx * WA_LD + d], o[a][d]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < WA_QY; ++a) {
        const int y = y0 + ry + a;
        if (y >= h || x >= w) continue;
        const size_t pix = (static_cast<size_t>(view) * h + y) * w + x;
        const float inv = 1.f / l[a];
        // with STATS: attn holds bf16 values, as lft_tpu's residual
        auto out = [&](float t) {
          if constexpr (STATS)
            return r_wo ? bf16_round(t * inv) : t * inv;
          else
            return t * inv;
        };
#pragma unroll
        for (int d = 0; d < DH; d += 4)
          st4(attn + pix * D + col + e * DH + d,
              make_float4(out(o[a][d]), out(o[a][d + 1]), out(o[a][d + 2]), out(o[a][d + 3])));
        if constexpr (STATS) {
          const size_t hd = pix * H + (col + e * DH) / DH;
          m_out[hd] = mq[a];
          l_out[hd] = l[a];
        }
      }
    }
  }
}

// K2.3's bf16-operand form (`spa_window_attn_bf16`, `_res_bf16`): f32 in
// and out.
template <int DH, bool STATS = false>
__global__ void __launch_bounds__(WA_NT, 2)
    spa_window_attn_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ attn,
                                float* __restrict__ m_out, float* __restrict__ l_out, int V,
                                int h, int w, float scale) {
  window_softmax_max_heads<DH, STATS>(q, k, v, attn, m_out, l_out, V, h, w, scale);
}

// K2.3's site-subset form (`spa_window_attn_sites`, `_res_sites`): f32 in
// and out, the roundings as the mask `sites` says.
template <int DH, bool STATS = false>
__global__ void __launch_bounds__(WA_NT, 2)
    spa_window_attn_sites_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ attn,
                                 float* __restrict__ m_out, float* __restrict__ l_out, int V,
                                 int h, int w, float scale, int sites) {
  window_softmax_max_heads<DH, STATS, true>(q, k, v, attn, m_out, l_out, V, h, w, scale,
                                             sites);
}


}  // namespace lft
