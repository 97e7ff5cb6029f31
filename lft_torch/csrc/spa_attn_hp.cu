// K5: per-op 5x5-window attention on projected q/k/v images, forward and
// backward, on K2.3's window layout.
//
// Replaces lft_tpu/kernels/spa_attn_hp.py:_fwd / _vjp_bwd (the Pallas TPU
// kernels behind windowed_attention_headpacked) and three more TPU kernels
// of the same function, which launch these kernels under their own names:
// * lft_tpu/kernels/spa_attn.py:_fwd / _vjp_bwd (K6, kernels/spa_attn.py:
//   `spa_attn_mxu`, `_res`, `_bwd`), tile-dense: each query against its
//   tile's whole halo, masked keys adding exactly 0 (dense on this card it
//   scored ~10x the window's pairs);
// * lft_tpu/kernels/local_attn_vjp.py:_call_fwd / _vjp_bwd (K9,
//   kernels/local_attn_vjp.py: `spa_attn_offset`, `_res`, `_bwd`), an
//   online softmax over the 25 offsets, rescaled at each (50 exps a query
//   and head where the forward below takes 25), D from the saved output;
// * lft_tpu/kernels/local_attn.py:_windowed_attention_pallas (K10,
//   kernels/local_attn.py: `spa_attn_tile`, forward only), each 8 x 8 tile
//   against its 144-key halo under an additive -1e30 mask (5.8x the
//   window's products).
// For every view b, head hh of 8 and pixel (y, x) of q, k, v [B, h, w, E]
// (dh = E / 8), over the keys of the pixel's 5x5 window inside the image:
//   s_j = (q * scale) . k_j      out = sum_j softmax_j(s_j) v_j
// with m = max_j s_j and l = sum_j exp(s_j - m) per (pixel, head) as the
// residuals of the backward, which returns dq, dk, dv from (q, k, v, m, l,
// dout):  p_j = exp(s_j - m) / l,  dp_j = dout . v_j,  D = sum_j p_j dp_j,
//   ds_j = p_j (dp_j - D),  dq = scale sum_j ds_j k_j,
//   dk_j += ds_j (q * scale),  dv_j += p_j dout  (over the queries whose
// window holds j). The q/k/v/out projections stay outside (torch.matmul).
//
// The TPU kernel packs the heads into one wide matrix product (keys
// replicated per head behind channel masks, zero-pad keys scored and taken
// out of the denominator again). On this card the function is K2's window
// step (spa_block.cu step 3), with the same m/l layout (pixel * 8 + head).
//
// Forward (`spa_attn_hp`, with STATS `spa_attn_hp_res`): K2.3's kernel,
// spa_window_attn_kernel<DH, STATS> (window_attn.cuh), launched as K2 launches
// it. Bound: q, k, v read once and out written once: at [400, 32, 32, 128]
// 0.84 GB, 0.2504 ms at 3.35 TB/s (with STATS at [100, 32, 32, 128] 0.0646).
//
// Backward (`spa_attn_hp_bwd`; the fused SpaTrans backward's step c, K3.c
// `spa_window_attn_bwd`, launches it too, with dout = dattn and the (m, l)
// of K2.3 res): two kernels on K2.3's item, a 16 x 16 tile of
// one view times a head group, two blocks of 256 threads an SM, halos staged
// by cp.async, a window's scores held in registers. Every output element is
// written by one thread in a fixed order, no atomics: a call repeats bitwise.
// * Pass q (the query side, K2.3's skeleton: a 32-float group, its 20 x 20 k
//   and v halo, a thread 16 floats of 2 queries down a column). A thread
//   takes its two queries one after the other: 25 scores and 25 dp of one
//   query and head are 50 registers, two queries' with their q and dout
//   would not fit in 128. Per query and head: the 25 scores with the
//   forward's arithmetic (q scaled as the forward scales it, four partial
//   sums added pairwise), so s is the forward's bit for bit and the saved
//   (m, l) fit it; e_j = exp(s_j - m), dp_j = dout . v_j (the same four
//   partial sums); D = (sum_j e_j dp_j) / l in key order; dq = scale / l
//   sum_j e_j (dp_j - D) k_j (k read again from the halo). Writes dq and D
//   ([B, h, w, 8], a scratch of the launch).
// * Pass kv (the key side). A thread owns a key pixel and one head and
//   gathers over the <= 25 queries whose window holds it (the window is
//   symmetric): s = (q_o scale) . k_me with the forward's arithmetic, p =
//   exp(s - m_o) / l_o, ds = p (dout_o . v_me - D_o); dk = sum_o ds q_o
//   scale, dv = sum_o p dout_o. The block stages the 20 x 20 halo of q
//   (scaled in place once it has landed: the forward's product q * scale)
//   and dout for a pair of heads, and the pair's m, 1 / l and D ride in the
//   four pad floats of each halo pixel's rows (stride 2 dh + 4: float4 reads
//   of 8 neighbouring pixels hit 32 banks), so at dh = 16 the item is K2.3's
//   128-byte group and the block K2.3's 113 KB. Two heads an item at every
//   dh: at dh 4 and 8 a 32-float group holds 8 or 4 heads, whose 24 or 12
//   statistics a pixel would not fit beside the halos in half an SM.
// Bound: q, k, v, dout read and dq, dk, dv written once (m, l beside them):
// at [100, 32, 32, 128] 0.37 GB, 0.1115 ms at 3.35 TB/s; its ~5.3 GFLOP
// (10 dh a pair and head) take 0.08 ms on the FP32 pipes. The two passes
// move ~0.58 GB (each reads four images, pass kv also the halo's statistics),
// ~0.17 ms.
//
// BF (`lft_spa_attn_hp_bwd_bf16`: K3.c under `--dtype mixed`'s backward,
// lft_tpu/kernels/spa_block.py:_bwd_kernel :505-531): both passes round q,
// k, v and dout to bf16 on load (the halos in place once they have landed),
// score s = (q . k) scale as lft_tpu does, round ds = p (dp - D) scale (the
// scale inside) and p before their products, and take D = sum_j p_j dp_j
// from the rounded products, on the FP32 pipes as the f32 passes. The
// saved (m, l) are the f32 forward's, so p is not renormalised.
//
// SITES (`lft_spa_attn_hp_bwd_sites`: K3.c under an LFT_MM_HP_BWD_SITES
// subset that splits `score` from `av`): BF's arithmetic (s = (q . k)
// scale, D = sum_j p_j dp_j from the pass's own products, ds with the scale
// inside) with each rounding taken by the runtime mask `sites`: where
// `score` rounds (S_SCORE), q and k as they are staged and ds before its
// products; where `av` rounds (S_AV), v and dout as they are staged and p
// before dv. Nothing else rounds: D's products and sums are f32, as
// lft_tpu's D segment sum is (its `_seg` at the score site's precision,
// whose operands stay f32). The mask is the same in every thread (uniform
// branches). Bound as BF's.
//
// IO = bf16 (`lft_spa_attn_hp_bwd_bf16io`: K3.c under `--dtype bfloat16`
// training, lft_tpu's _bwd_kernel with io = bf16, :488-540): the BF passes
// on bf16 q, k, v, dout, their halos staged by the threads' 8-byte loads
// widened to f32 (cp.async copies bytes), with the (m, l) of K2.3 res's
// bf16-IO form (m each query's max over its heads, l each head's sum under
// it: p = exp(s - m) / l is lft_tpu's); dq, dk, dv summed in f32 and
// rounded to bf16 once, as they are stored. Bound at [100, 32, 32, 128]:
// q, k, v, dout in and dq, dk, dv out in bf16, m, l f32, 0.19 GB, 0.056 ms.
//
// bf16-IO forwards (`--dtype bfloat16` serving through the per-op branch,
// lft_tpu's per-op kernels on bf16 tensors; bf16 q, k, v and out, f32
// arithmetic): three families of rounding points, three instances.
// * Deferred, K5 (`lft_spa_attn_hp_bf16io`, counted `spa_attn_hp_bf16io`;
//   lft_tpu/kernels/spa_attn_hp.py:_fwd_kernel :222-280): the query's max
//   over every head and its window (pad keys score 0), bf16(e) into the
//   product, l from the unrounded e: K2's bf16 window step, so K2.3's
//   bf16-IO kernel (window_mma.cuh: spa_window_attn_mma_kernel), a (view,
//   8 x 8 tile) a block, every head, the products on the tensor cores.
// * Normalized, K6 (`lft_spa_attn_norm_bf16io`, `spa_attn_mxu_bf16io`;
//   spa_attn.py:_fwd_kernel :72-116): the per-head softmax, p = bf16(e / l)
//   before the product: spa_window_attn_kernel<DH, false, true, bf16>.
// * f32 inside, K9 and K10 (`lft_spa_attn_f32in_bf16io`,
//   `spa_attn_offset_bf16io` / `spa_attn_tile_bf16io`; local_attn_vjp.py:
//   _fwd_kernel :48-116, local_attn.py:_window_kernel :44-80): the f32
//   kernel on widened values, the output rounded once:
//   spa_window_attn_kernel<DH, false, false, bf16>.
// Bound at [400, 32, 32, 128]: q, k, v read and out written once in bf16,
// 0.42 GB, 0.1252 ms at 3.35 TB/s.
//
// bf16-IO training forms (`--dtype bfloat16` training through the per-op
// branch, counted `<family>_res_bf16io` and `_bwd_bf16io`):
// * the `_res` forms (`lft_spa_attn_{hp,norm,f32in}_res_bf16io`): the three
//   forwards above with STATS, m and l f32 in the layout of the family's
//   backward (deferred: the query's max over its heads in every head's
//   slot; normalized and f32 inside: each head's own max and sum);
// * K5's backward (`spa_attn_hp_bwd_bf16io`) is the IO = bf16 passes above,
//   the function of K3.c bf16io (lft_tpu/kernels/spa_attn_hp.py:_bwd_kernel
//   on bf16 tensors: p = e (1 / l));
// * K6's (`lft_spa_attn_norm_bwd_bf16io`, `spa_attn_mxu_bwd_bf16io`) the
//   same passes with DIV: p = e / l, as lft_tpu's K6 divides
//   (spa_attn.py:_bwd_kernel :120-180);
// * K9's (`lft_spa_attn_f32in_bwd_bf16io`, `spa_attn_offset_bwd_bf16io`) the
//   f32 passes on bf16 rows with DOUT: pass q takes D = dout . out per head
//   from the saved bf16 output (local_attn_vjp.py:_vjp_bwd :307), not from
//   the scores, which differ by the output's rounding; nothing is rounded
//   but dq, dk, dv, as they are stored.
// Bound of a backward at [100, 32, 32, 128]: q, k, v, dout in and dq, dk, dv
// out in bf16, m, l f32, 0.19 GB, 0.0567 ms at 3.35 TB/s (K9 reads out too:
// 0.0645 ms); its 3.0 GFLOP on the FP32 pipes 0.045 ms.

#include "attn.cuh"
#include "window_attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;       // heads
constexpr int KW = (2 * R + 1) * (2 * R + 1);   // keys of a window
constexpr int KV_HEADS = 2;                     // heads of a pass-kv item

// a . b as four partial sums over the channels, added pairwise: the
// forward's score arithmetic (window_attn.cuh), a first operand q * scale.
template <int DH>
__device__ __forceinline__ float dot4(const float* a, const float (&b)[DH]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DH; ++d) t[d % 4] = fmaf(a[d], b[d], t[d % 4]);
  return (t[0] + t[1]) + (t[2] + t[3]);
}

// ---- backward, pass q: dq and D --------------------------------------------
// One block an item (view, 16 x 16 tile, 32-float head group), items in
// K2.3's launch order.
// DIV: p = e / l (K6's bf16 form) where the others take e (1 / l); DOUT: D
// from the saved output, D = dout . out per head (K9's bf16 form), not from
// the scores. SITES: the header's, the roundings by `sites`.
template <int DH, bool BF = false, class IO = float, bool DIV = false, bool DOUT = false,
          bool SITES = false>
__global__ void __launch_bounds__(WA_NT, 2)
    spa_attn_hp_bwd_q_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                             const IO* __restrict__ v, const IO* __restrict__ dout,
                             const float* __restrict__ m_in, const float* __restrict__ l_in,
                             IO* __restrict__ dq_out, float* __restrict__ dsum_out, int h,
                             int w, float scale, const IO* __restrict__ out, int sites) {
  static_assert(BF || DOUT || !is_bf16<IO>,
                "bf16 IO takes the BF arithmetic, or f32 inside with D from the output");
  static_assert(!SITES || !(BF || DIV || DOUT || is_bf16<IO>), "a `_sites` instance is f32");
  constexpr bool SC = BF || SITES;   // s = (q . k) scale, ds with the scale inside
  const bool r_sc = SITES && (sites & S_SCORE) != 0, r_av = SITES && (sites & S_AV) != 0;
  constexpr int D = H * DH;
  constexpr int G = D / WA_G;       // head groups of a pixel
  constexpr int HT = WA_S / DH;     // heads of a thread's slice
  extern __shared__ __align__(16) float smem[];
  const int ntx = (w + WA_TX - 1) / WA_TX;
  const int per_view = ((h + WA_TY - 1) / WA_TY) * ntx * G;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, half = lane >> 4;    // the thread's column and slice
  const int ry = WA_QY * (threadIdx.x >> 5);     // its first query row in the tile
  const int i = blockIdx.x, tile = i % per_view / G;
  const int view = i / per_view, y0 = tile / ntx * WA_TY, x0 = tile % ntx * WA_TX, g = i % G;
  // the item's k and v halos, zero outside the image
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
  const int x = x0 + tx;
  const int col = g * WA_G + half * WA_S;   // the slice's first channel
#pragma unroll 1
  for (int a = 0; a < WA_QY; ++a) {
    const int y = y0 + ry + a;
    const bool in = y < h && x < w;
    const size_t pix = (static_cast<size_t>(view) * h + (in ? y : 0)) * w + (in ? x : 0);
    float qv[WA_S], gv[WA_S];   // the query's q (scaled as the forward scales it), dout
    float dh_out[HT] = {};      // DOUT: D of each head of the slice, dout . out
#pragma unroll
    for (int d = 0; d < WA_S; d += 4) {
      const float4 t = in ? ldg4(q + pix * D + col + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 u = in ? ldg4(dout + pix * D + col + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (DOUT) {
        const float4 o = in ? ldg4(out + pix * D + col + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        float& dd = dh_out[d / DH];
        dd = fmaf(u.x, o.x, dd);
        dd = fmaf(u.y, o.y, dd);
        dd = fmaf(u.z, o.z, dd);
        dd = fmaf(u.w, o.w, dd);
      }
      if constexpr (BF) {   // q unscaled: the score's scale comes after the product
        qv[d] = bf16_round(t.x);
        qv[d + 1] = bf16_round(t.y);
        qv[d + 2] = bf16_round(t.z);
        qv[d + 3] = bf16_round(t.w);
        gv[d] = bf16_round(u.x);
        gv[d + 1] = bf16_round(u.y);
        gv[d + 2] = bf16_round(u.z);
        gv[d + 3] = bf16_round(u.w);
        continue;
      }
      if constexpr (SITES) {   // q unscaled, rounded where `score` rounds; dout where `av` does
        qv[d] = r_sc ? bf16_round(t.x) : t.x;
        qv[d + 1] = r_sc ? bf16_round(t.y) : t.y;
        qv[d + 2] = r_sc ? bf16_round(t.z) : t.z;
        qv[d + 3] = r_sc ? bf16_round(t.w) : t.w;
        gv[d] = r_av ? bf16_round(u.x) : u.x;
        gv[d + 1] = r_av ? bf16_round(u.y) : u.y;
        gv[d + 2] = r_av ? bf16_round(u.z) : u.z;
        gv[d + 3] = r_av ? bf16_round(u.w) : u.w;
        continue;
      }
      qv[d] = t.x * scale;
      qv[d + 1] = t.y * scale;
      qv[d + 2] = t.z * scale;
      qv[d + 3] = t.w * scale;
      gv[d] = u.x;
      gv[d + 1] = u.y;
      gv[d + 2] = u.z;
      gv[d + 3] = u.w;
    }
    if (a == 0) {
      cp_async_wait<0>();
      if constexpr (BF) {   // the k and v halo chunks this thread copied, rounded in place
        for (int j = threadIdx.x; j < WA_HY * WA_HX * (WA_G / 4); j += WA_NT) {
          const int px = j / (WA_G / 4), c = 4 * (j % (WA_G / 4));
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            float* p = smem + b * WA_BUF + px * WA_LD + c;
            const float4 t = load4(p);
            store4(p, make_float4(bf16_round(t.x), bf16_round(t.y), bf16_round(t.z),
                                  bf16_round(t.w)));
          }
        }
      } else if constexpr (SITES) {   // k where `score` rounds, v where `av` does
        if (r_sc || r_av)
          for (int j = threadIdx.x; j < WA_HY * WA_HX * (WA_G / 4); j += WA_NT) {
            const int px = j / (WA_G / 4), c = 4 * (j % (WA_G / 4));
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              if (!(b == 0 ? r_sc : r_av)) continue;
              float* p = smem + b * WA_BUF + px * WA_LD + c;
              const float4 t = load4(p);
              store4(p, make_float4(bf16_round(t.x), bf16_round(t.y), bf16_round(t.z),
                                    bf16_round(t.w)));
            }
          }
      }
      __syncthreads();
    }
    if (!in) continue;   // no barrier follows
#pragma unroll
    for (int e = 0; e < HT; ++e) {   // the heads of the thread's slice
      const size_t hd = pix * H + (col + e * DH) / DH;
      const float m = __ldg(m_in + hd), lv = __ldg(l_in + hd), il = 1.f / lv;
      // the window row-major, s[5 dy + dx]: the forward's scores, -inf (and
      // dp 0) where the key lies outside the image
      float s[KW], dp[KW];
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        s[j] = -CUDART_INF_F;
        dp[j] = 0.f;
      }
#pragma unroll
      for (int r = 0; r <= 2 * R; ++r) {   // key row y + r - 2: halo row ry + a + r
        const int ky = y + r - R;
        if (ky < 0 || ky >= h) continue;
        const float* kr = smem + ((ry + a + r) * WA_HX + tx) * WA_LD + half * WA_S + e * DH;
#pragma unroll
        for (int dx = 0; dx <= 2 * R; ++dx) {
          const int kx = x + dx - R;
          if (kx < 0 || kx >= w) continue;
          float kk[DH], vv[DH];
          ld<DH>(kr + dx * WA_LD, kk);
          s[(2 * R + 1) * r + dx] = SC ? dot4<DH>(qv + e * DH, kk) * scale
                                       : dot4<DH>(qv + e * DH, kk);
          ld<DH>(kr + WA_BUF + dx * WA_LD, vv);
          dp[(2 * R + 1) * r + dx] = dot4<DH>(gv + e * DH, vv);
        }
      }
      float dsum = 0.f;   // sum_j e_j dp_j in key order (DIV: sum_j p_j dp_j)
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        s[j] = expf(s[j] - m);
        if constexpr (DIV) s[j] = s[j] / lv;
        if constexpr (!DOUT) dsum = fmaf(s[j], dp[j], dsum);
      }
      const float dd = DOUT ? dh_out[e] : DIV ? dsum : dsum * il;
#pragma unroll
      for (int j = 0; j < KW; ++j) {   // l ds_j; BF: ds_j rounded (SITES: where `score` rounds)
        if constexpr (SITES) {
          const float g = s[j] * il * (dp[j] - dd) * scale;
          dp[j] = r_sc ? bf16_round(g) : g;
          continue;
        }
        dp[j] = BF ? bf16_round((DIV ? s[j] : s[j] * il) * (dp[j] - dd) * scale)
                   : s[j] * (dp[j] - dd);
      }
      float dq[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] = 0.f;
#pragma unroll
      for (int r = 0; r <= 2 * R; ++r) {
        const int ky = y + r - R;
        if (ky < 0 || ky >= h) continue;
        const float* kr = smem + ((ry + a + r) * WA_HX + tx) * WA_LD + half * WA_S + e * DH;
#pragma unroll
        for (int dx = 0; dx <= 2 * R; ++dx) {
          const int kx = x + dx - R;
          if (kx < 0 || kx >= w) continue;
          float kk[DH];
          ld<DH>(kr + dx * WA_LD, kk);
          const float c = dp[(2 * R + 1) * r + dx];
#pragma unroll
          for (int d = 0; d < DH; ++d) dq[d] = fmaf(c, kk[d], dq[d]);
        }
      }
      const float f = SC ? 1.f : il * scale;
#pragma unroll
      for (int d = 0; d < DH; d += 4)
        st4(dq_out + pix * D + col + e * DH + d,
            make_float4(dq[d] * f, dq[d + 1] * f, dq[d + 2] * f, dq[d + 3] * f));
      dsum_out[hd] = dd;
    }
  }
}

// ---- backward, pass kv: dk and dv -----------------------------------------
// Shared memory of a pass-kv block: the q and dout halos of a head pair,
// pixel stride 2 DH + 4; q's row ends in (m, 1/l) of each head, dout's in
// the two heads' D.
template <int DH>
struct KvLayout {
  static constexpr int LD = KV_HEADS * DH + 4;
  static constexpr int BUF = WA_HY * WA_HX * LD;
  static constexpr size_t BYTES = 2 * static_cast<size_t>(BUF) * sizeof(float);
  static_assert(2 * (BYTES + 1024) <= 233472, "two blocks' halos must share an SM");
};

// One block an item (view, 16 x 16 tile, head pair), items in launch order;
// a thread owns the key pixels (ry, tx) and (ry + 1, tx) of the tile, one
// after the other, for head `e` of the pair. bf16 IO with the f32
// arithmetic (!BF) is K9's bf16 form; DIV: p = e / l (the row holds l).
// SITES: the header's, the roundings by `sites`.
template <int DH, bool BF = false, class IO = float, bool DIV = false, bool SITES = false>
__global__ void __launch_bounds__(WA_NT, 2)
    spa_attn_hp_bwd_kv_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                              const IO* __restrict__ v, const IO* __restrict__ dout,
                              const float* __restrict__ m_in, const float* __restrict__ l_in,
                              const float* __restrict__ dsum, IO* __restrict__ dk_out,
                              IO* __restrict__ dv_out, int h, int w, float scale, int sites) {
  static_assert(!SITES || !(BF || DIV || is_bf16<IO>), "a `_sites` instance is f32");
  constexpr bool SC = BF || SITES;   // s = (q . k) scale, ds with the scale inside
  const bool r_sc = SITES && (sites & S_SCORE) != 0, r_av = SITES && (sites & S_AV) != 0;
  using L = KvLayout<DH>;
  constexpr int D = H * DH, P = H / KV_HEADS, LD = L::LD, W = KV_HEADS * DH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [20 x 20][LD]: q * scale, m0, 1/l0, m1, 1/l1
  float* gs = smem + L::BUF;        // [20 x 20][LD]: dout, D0, D1
  const int ntx = (w + WA_TX - 1) / WA_TX;
  const int per_view = ((h + WA_TY - 1) / WA_TY) * ntx * P;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, e = lane >> 4;       // the thread's column and head of the pair
  const int ry = WA_QY * (threadIdx.x >> 5);     // its first key row in the tile
  const int i = blockIdx.x, tile = i % per_view / P;
  const int view = i / per_view, y0 = tile / ntx * WA_TY, x0 = tile % ntx * WA_TX, pr = i % P;
  for (int j = threadIdx.x; j < WA_HY * WA_HX * (W / 4); j += WA_NT) {
    const int px = j / (W / 4), c = 4 * (j % (W / 4));
    const int oy = y0 - R + px / WA_HX, ox = x0 - R + px % WA_HX;
    const bool ok = oy >= 0 && oy < h && ox >= 0 && ox < w;
    const size_t off =
        ok ? ((static_cast<size_t>(view) * h + oy) * w + ox) * D + pr * W + c : 0;
    copy4(qs + px * LD + c, q + off, ok);
    copy4(gs + px * LD + c, dout + off, ok);
  }
  cp_async_commit();
  for (int j = threadIdx.x; j < WA_HY * WA_HX * KV_HEADS; j += WA_NT) {
    const int px = j / KV_HEADS, hh = j % KV_HEADS;
    const int oy = y0 - R + px / WA_HX, ox = x0 - R + px % WA_HX;
    float mv = 0.f, il = 0.f, dd = 0.f;   // outside the image: never read
    if (oy >= 0 && oy < h && ox >= 0 && ox < w) {
      const size_t hd = ((static_cast<size_t>(view) * h + oy) * w + ox) * H + pr * KV_HEADS + hh;
      mv = __ldg(m_in + hd);
      il = DIV ? __ldg(l_in + hd) : 1.f / __ldg(l_in + hd);
      dd = __ldg(dsum + hd);
    }
    qs[px * LD + W + 2 * hh] = mv;
    qs[px * LD + W + 2 * hh + 1] = il;
    gs[px * LD + W + hh] = dd;
  }
  cp_async_wait<0>();
  // q * scale in place, over the chunks this thread copied (its own copies
  // have landed): the forward's operand; BF: q and dout rounded to bf16
  for (int j = threadIdx.x; j < WA_HY * WA_HX * (W / 4); j += WA_NT) {
    float* p = qs + j / (W / 4) * LD + 4 * (j % (W / 4));
    const float4 t = load4(p);
    if constexpr (BF) {
      float* g = gs + j / (W / 4) * LD + 4 * (j % (W / 4));
      const float4 u = load4(g);
      store4(p, make_float4(bf16_round(t.x), bf16_round(t.y), bf16_round(t.z),
                            bf16_round(t.w)));
      store4(g, make_float4(bf16_round(u.x), bf16_round(u.y), bf16_round(u.z),
                            bf16_round(u.w)));
    } else if constexpr (SITES) {   // q unscaled where `score` rounds, dout where `av` does
      if (r_sc)
        store4(p, make_float4(bf16_round(t.x), bf16_round(t.y), bf16_round(t.z),
                              bf16_round(t.w)));
      if (r_av) {
        float* g = gs + j / (W / 4) * LD + 4 * (j % (W / 4));
        const float4 u = load4(g);
        store4(g, make_float4(bf16_round(u.x), bf16_round(u.y), bf16_round(u.z),
                              bf16_round(u.w)));
      }
    } else {
      store4(p, make_float4(t.x * scale, t.y * scale, t.z * scale, t.w * scale));
    }
  }
  __syncthreads();

  const int x = x0 + tx;
#pragma unroll 1
  for (int a = 0; a < WA_QY; ++a) {
    const int y = y0 + ry + a;
    if (y >= h || x >= w) continue;   // no barrier follows
    const size_t off = ((static_cast<size_t>(view) * h + y) * w + x) * D + pr * W + e * DH;
    float km[DH], vm[DH], dk[DH], dv[DH];
    ldg<DH>(k + off, km);
    ldg<DH>(v + off, vm);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[d] = dv[d] = 0.f;
      if constexpr (BF) {
        km[d] = bf16_round(km[d]);
        vm[d] = bf16_round(vm[d]);
      }
      if constexpr (SITES) {
        if (r_sc) km[d] = bf16_round(km[d]);
        if (r_av) vm[d] = bf16_round(vm[d]);
      }
    }
#pragma unroll
    for (int r = 0; r <= 2 * R; ++r) {   // query row y + r - 2: halo row ry + a + r
      const int oy = y + r - R;
      if (oy < 0 || oy >= h) continue;
      const int row = ((ry + a + r) * WA_HX + tx) * LD;
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) {
        const int ox = x + dx - R;
        if (ox < 0 || ox >= w) continue;
        const float* qo = qs + row + dx * LD;
        const float* go = gs + row + dx * LD;
        float qq[DH], gg[DH];
        ld<DH>(qo + e * DH, qq);
        const float2 ml = *reinterpret_cast<const float2*>(qo + W + 2 * e);
        const float ex = expf((SC ? dot4<DH>(qq, km) * scale : dot4<DH>(qq, km)) - ml.x);
        const float p = DIV ? ex / ml.y : ex * ml.y;
        ld<DH>(go + e * DH, gg);
        float ds, pv;
        if constexpr (SITES) {
          ds = p * (dot4<DH>(gg, vm) - go[W + e]) * scale;
          ds = r_sc ? bf16_round(ds) : ds;
          pv = r_av ? bf16_round(p) : p;
        } else {
          ds = BF ? bf16_round(p * (dot4<DH>(gg, vm) - go[W + e]) * scale)
                  : p * (dot4<DH>(gg, vm) - go[W + e]);
          pv = BF ? bf16_round(p) : p;
        }
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dk[d] = fmaf(ds, qq[d], dk[d]);
          dv[d] = fmaf(pv, gg[d], dv[d]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      st4(dk_out + off + d, make_float4(dk[d], dk[d + 1], dk[d + 2], dk[d + 3]));
      st4(dv_out + off + d, make_float4(dv[d], dv[d + 1], dv[d + 2], dv[d + 3]));
    }
  }
}

inline bool bad_shape(int B, int h, int w, int E, int heads) {
  return heads != H || B < 1 || h < 1 || w < 1 || E % WA_G ||
         static_cast<long long>(B) * h * w > 0x7fffffffLL;
}

// blocks of a launch: (view, 16 x 16 tile, group) items, `groups` a pixel
inline long long n_items(int B, int h, int w, int groups) {
  return static_cast<long long>(B) * ((h + WA_TY - 1) / WA_TY) * ((w + WA_TX - 1) / WA_TX) *
         groups;
}

template <bool STATS>
int spa_attn_hp(const float* q, const float* k, const float* v, float* out, float* m, float* l,
                int B, int h, int w, int E, int heads, float scale, cudaStream_t s) {
  if (bad_shape(B, h, w, E, heads) || n_items(B, h, w, E / WA_G) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items(B, h, w, E / WA_G));
  switch (E / H) {
#define LFT_HP_CASE(DHV)                                                           \
    case DHV: {                                                                    \
      auto kernel = spa_window_attn_kernel<DHV, STATS>;                            \
      LFT_SET_SMEM(kernel, WA_BYTES);                                              \
      kernel<<<grid, WA_NT, WA_BYTES, s>>>(q, k, v, out, m, l, B, h, w, scale);     \
      break;                                                                       \
    }
    LFT_HP_CASE(4)
    LFT_HP_CASE(8)
    LFT_HP_CASE(16)
#undef LFT_HP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16-IO forwards (the header): NORM the normalized instance of the
// f32 kernel, else the f32-inside one; `deferred` K2.3's bf16-IO kernel
// (window_mma.cuh); STATS also writes m, l (the `_res` forms).
template <bool NORM, bool STATS = false>
int spa_attn_io(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* m, float* l,
                int B, int h, int w, int E, int heads, float scale, bool deferred,
                cudaStream_t s) {
  if (bad_shape(B, h, w, E, heads) || n_items(B, h, w, E / WA_G) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (deferred) return launch_window_mma<STATS>(q, k, v, out, m, l, B, h, w, E, heads, scale, s);
  const int grid = static_cast<int>(n_items(B, h, w, E / WA_G));
  switch (E / H) {
#define LFT_HP_CASE(DHV)                                                            \
    case DHV: {                                                                     \
      auto kernel = spa_window_attn_kernel<DHV, STATS, NORM, bf16>;                 \
      LFT_SET_SMEM(kernel, WA_BYTES);                                               \
      kernel<<<grid, WA_NT, WA_BYTES, s>>>(q, k, v, out, m, l, B, h, w, scale);      \
      break;                                                                        \
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

// The bf16-IO forwards (the header): q, k, v, out bf16 [B, h, w, E].
extern "C" int lft_spa_attn_hp_bf16io(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                      int B, int h, int w, int E, int heads, float scale,
                                      void* stream) {
  return spa_attn_io<false>(q, k, v, out, nullptr, nullptr, B, h, w, E, heads, scale, true,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_attn_norm_bf16io(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                        int B, int h, int w, int E, int heads, float scale,
                                        void* stream) {
  return spa_attn_io<true>(q, k, v, out, nullptr, nullptr, B, h, w, E, heads, scale, false,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_attn_f32in_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                         bf16* out, int B, int h, int w, int E, int heads,
                                         float scale, void* stream) {
  return spa_attn_io<false>(q, k, v, out, nullptr, nullptr, B, h, w, E, heads, scale, false,
                            static_cast<cudaStream_t>(stream));
}

// Their `_res` forms (the header): also m, l [B, h, w, 8] f32, each in the
// layout of its family's backward (deferred: the query's max over its
// heads in every head's slot; normalized and f32 inside: each head's own).
extern "C" int lft_spa_attn_hp_res_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                          bf16* out, float* m, float* l, int B, int h, int w,
                                          int E, int heads, float scale, void* stream) {
  return spa_attn_io<false, true>(q, k, v, out, m, l, B, h, w, E, heads, scale, true,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_attn_norm_res_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                            bf16* out, float* m, float* l, int B, int h, int w,
                                            int E, int heads, float scale, void* stream) {
  return spa_attn_io<true, true>(q, k, v, out, m, l, B, h, w, E, heads, scale, false,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int lft_spa_attn_f32in_res_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                             bf16* out, float* m, float* l, int B, int h, int w,
                                             int E, int heads, float scale, void* stream) {
  return spa_attn_io<false, true>(q, k, v, out, m, l, B, h, w, E, heads, scale, false,
                                  static_cast<cudaStream_t>(stream));
}

namespace {

template <bool BF, class IO = float, bool DIV = false, bool DOUT = false, bool SITES = false>
int hp_bwd(const named_t<IO>* q, const named_t<IO>* k, const named_t<IO>* v,
           const named_t<IO>* dout, const float* m, const float* l, float* dsum,
           named_t<IO>* dq, named_t<IO>* dk, named_t<IO>* dv, int B, int h, int w, int E,
           int heads, float scale, cudaStream_t s, const named_t<IO>* out = nullptr,
           int sites = 0) {
  if (bad_shape(B, h, w, E, heads) || n_items(B, h, w, H / KV_HEADS) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid_q = static_cast<int>(n_items(B, h, w, E / WA_G));
  const int grid_kv = static_cast<int>(n_items(B, h, w, H / KV_HEADS));
  switch (E / H) {
#define LFT_HP_CASE(DHV)                                                             \
    case DHV: {                                                                      \
      auto kq = spa_attn_hp_bwd_q_kernel<DHV, BF, IO, DIV, DOUT, SITES>;             \
      auto kkv = spa_attn_hp_bwd_kv_kernel<DHV, BF, IO, DIV, SITES>;                 \
      LFT_SET_SMEM(kq, WA_BYTES);                                                    \
      LFT_SET_SMEM(kkv, KvLayout<DHV>::BYTES);                                       \
      kq<<<grid_q, WA_NT, WA_BYTES, s>>>(q, k, v, dout, m, l, dq, dsum, h, w, scale, \
                                         out, sites);                                \
      kkv<<<grid_kv, WA_NT, KvLayout<DHV>::BYTES, s>>>(q, k, v, dout, m, l, dsum, dk, dv, \
                                                       h, w, scale, sites);          \
      break;                                                                         \
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

// dq, dk, dv [B, h, w, E] from q, k, v, dout [B, h, w, E] and m, l [B, h, w,
// 8]; dsum [B, h, w, 8] is the launch's scratch (pass q writes D there,
// pass kv reads it).
extern "C" int lft_spa_attn_hp_bwd(const float* q, const float* k, const float* v,
                                   const float* dout, const float* m, const float* l,
                                   float* dsum, float* dq, float* dk, float* dv, int B, int h,
                                   int w, int E, int heads, float scale, void* stream) {
  return hp_bwd<false>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, h, w, E, heads, scale,
                       static_cast<cudaStream_t>(stream));
}

// The passes' bf16-operand instances (K3.c under `--dtype mixed`, the
// header): the same arguments.
extern "C" int lft_spa_attn_hp_bwd_bf16(const float* q, const float* k, const float* v,
                                        const float* dout, const float* m, const float* l,
                                        float* dsum, float* dq, float* dk, float* dv, int B,
                                        int h, int w, int E, int heads, float scale,
                                        void* stream) {
  return hp_bwd<true>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, h, w, E, heads, scale,
                      static_cast<cudaStream_t>(stream));
}

// The passes' site-subset instances (K3.c under an LFT_MM_HP_BWD_SITES
// subset, the header): the same arguments and `sites`, the mask of the sites
// that round (tf32.cuh: S_SCORE, S_AV).
extern "C" int lft_spa_attn_hp_bwd_sites(const float* q, const float* k, const float* v,
                                         const float* dout, const float* m, const float* l,
                                         float* dsum, float* dq, float* dk, float* dv, int B,
                                         int h, int w, int E, int heads, float scale, int sites,
                                         void* stream) {
  return hp_bwd<false, float, false, false, true>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, h,
                                                  w, E, heads, scale,
                                                  static_cast<cudaStream_t>(stream), nullptr,
                                                  sites);
}

// The passes' bf16-IO instances (K3.c under `--dtype bfloat16` training,
// the header): q, k, v, dout and dq, dk, dv bf16; m, l and dsum f32.
extern "C" int lft_spa_attn_hp_bwd_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                          const bf16* dout, const float* m, const float* l,
                                          float* dsum, bf16* dq, bf16* dk, bf16* dv, int B,
                                          int h, int w, int E, int heads, float scale,
                                          void* stream) {
  return hp_bwd<true, bf16>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, h, w, E, heads, scale,
                            static_cast<cudaStream_t>(stream));
}

// K6's backward in bf16 IO (`spa_attn_mxu_bwd_bf16io`, the header): the
// bf16-IO passes with p = e / l (lft_tpu/kernels/spa_attn.py:_bwd_kernel
// :142-156 divides; K5's multiplies by 1 / l); the arguments of
// lft_spa_attn_hp_bwd_bf16io, with K6's (m, l) (each head's own max).
extern "C" int lft_spa_attn_norm_bwd_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                            const bf16* dout, const float* m, const float* l,
                                            float* dsum, bf16* dq, bf16* dk, bf16* dv, int B,
                                            int h, int w, int E, int heads, float scale,
                                            void* stream) {
  return hp_bwd<true, bf16, true>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, h, w, E, heads,
                                  scale, static_cast<cudaStream_t>(stream));
}

// K9's backward in bf16 IO (`spa_attn_offset_bwd_bf16io`, the header): the
// f32 passes on bf16 tensors (rows widened as they load, nothing rounded
// but dq, dk, dv as they are stored), D = dout . out per head from the
// saved bf16 output `out` [B, h, w, E] (lft_tpu/kernels/local_attn_vjp.py:
// _vjp_bwd :307), not from the scores.
extern "C" int lft_spa_attn_f32in_bwd_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                             const bf16* dout, const bf16* out, const float* m,
                                             const float* l, float* dsum, bf16* dq, bf16* dk,
                                             bf16* dv, int B, int h, int w, int E, int heads,
                                             float scale, void* stream) {
  return hp_bwd<false, bf16, false, true>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, h, w, E,
                                          heads, scale, static_cast<cudaStream_t>(stream), out);
}
