"""What sets the pace of the bf16 window attention (`csrc/window_mma.cuh`),
of K2.5's `_sites` kernels (`csrc/ffn_sites.cuh`), of K1's all-bf16 kernel
(`csrc/ang_bf16.cuh`), of K2.5's bf16-IO instance (`csrc/ffn_bf16.cuh` on
bf16 rows), of K1's `_sites` kernel (`csrc/ang_sites.cuh`) and of K2.1's
bf16 forms (`csrc/tok_bf16.cuh`) on the card: each timed beside variants
of its sources one text edit away, in turns in one process (as
`probe_wgrad`, `probe_k7`).

    python3 -m lft_torch.probe_variants [--targets window,ffn_sites,ang,ffn_io,ang_sites,tok_bf16] [--accuracy]

Each variant is a copy of this checkout's `csrc` with one edit, and a
small source that includes the kernel's header and exports its launcher
(`probe_window`, `probe_ffn_sites`, `probe_ang`, `probe_ffn_io`,
`probe_ang_sites`, `probe_tok`), built with the port's nvcc flags into
a temporary directory, all at once; an edit whose anchor is gone from the
source raises, and a variant that does not build is left out. Most
variants compute wrong values on purpose: each is timed, none is checked.

The window kernel at [400, 32, 32, 128] (K2.3 `spa_window_attn_bf16io`'s
launch) and with STATS at [100, 32, 32, 128]:

* `one_pass`: no first pass (m = 0: the cost of the max over heads);
* `no_exp`: e = s - m, no exp (the cost of the softmax's exps);
* `fast_exp`: `__expf` (ex2.approx) for `expf`;
* `no_pv`: no product with v (its ldmatrix.trans kept);
* `no_score_mma`: the scores' MMAs replaced by a use of their ldmatrix;
* `no_staging`: no copy of the k and v halos (the compute on whatever
  shared memory holds);
* `v_whole`: the v halo staged whole with k, three blocks an SM.

K2.5 `_sites` at [400, 32, 32, 64] under S1 (`lin` rounds) and S2 (`ffn`
rounds):

* `tf32x1`: every 3xTF32 product one TF32 pass (al bh and ah bl dropped,
  `rg_product_a`);
* `chain16`, `chain32`, `chain_all`: the 3xTF32 products' chains 16, 32
  or all of K long (`FS_CHAIN` 1, 2, 8; as is 4: 64 of K);
* `no_rows`: no load of xn2's rows (S1: no cp.async; S2: no load into the
  A fragments).

K1's all-bf16 kernel at [16384, 25, 64] in bf16 IO (`ang_block_bf16io`'s
launch) and in f32 IO (`ang_block_bf16`'s), the demo's shapes with random
weights:

* `no_attention`: no attention item (the cost of the whole attention);
* `no_max_pass`: no first pass (m = 0: the cost of the max over heads);
* `no_attn_mma`: the scores' and the product with v's MMAs replaced by a
  use of their operands;
* `no_exp`: e = its argument, no 2^x (the cost of the exps);
* `plain_expf`: e = expf(round(s scale) - m), each step rounded as the
  plain version rounds it, for the SFU's 2^x of one FMA;
* `flush_qkv`: q, k and v's k16 steps each into zeroed accumulators, then
  summed in f32 in K order (the tensor cores' accumulation left out);
* `ln_f64`: both LayerNorms in float64, rounded once to f32;
* `no_staging`: no copy of x's rows (the compute on whatever shared memory
  holds).

With `--accuracy`, the variants of ANG_EXACT (which compute the function)
are also run on bf16 inputs at C = 64 and 25, 81 and 121 views
(`_ang_accuracy`): out's distance from the plain version, and from float64
at the plain version's rounding points, as shares of the plain
bf16-vs-f32 distance.

K2.5 bf16io at [400, 32, 32, 64]:

* `no_rows`: no cp.async of xn2's rows;
* `no_x2`: no load of x2 for the residual.

K1's `_sites` kernel at [16384, 25, 64] under S1 and S2 (f32 IO, random
weights):

* `no_attention`, `no_max_pass`, `no_exp`: as K1's all-bf16 kernel's;
* `expf`: e = expf(round(s scale) - m) for the SFU's 2^x of one FMA (the
  cost of keeping the plain version's exp);
* `attn_tf32x1`: the attention's 3xTF32 MMAs one TF32 pass each;
* `tf32x1`: the 3xTF32 row products one TF32 pass (`tf3_product`,
  `tf3_qkv`);
* `no_prefetch`: no L2 prefetch of the next tile's x;
* `no_x`: no load of x (the LayerNorm's and the residual's);
* `no_ln`: no LayerNorm (LN1 and LN2);
* `no_put`: no store of q, k and v into shared memory;
* `no_tile_barrier`: no block barrier at a tile's start (where a hidden
  chunk lies over k and v);
* `no_out`: no store of out;
* `wait0`: each group of a 3xTF32 product (`tf3_product`) waited on
  before the next is issued;
* `no_tf3_mma`: no `wgmma` in the 3xTF32 products of `tf3_product` (a use
  of the fragments in their place; the ring's protocol kept).

K2.1's bf16 forms at [400, 32, 32, 64] in bf16 IO (`spa_tokenize_ln_bf16io`'s
launch) and f32 IO (`spa_tokenize_ln_bf16`'s):

* `no_band`: the next tile's band not read (its f32 units stored as zeros);
* `wait0`: each tap's products waited on before the next tap's fragments
  load (`wgmma_wait<0>`);
* `no_ln`: no LayerNorm (xn = tok + pe_tok);
* `no_mma`: no `wgmma` (a use of the fragments in its place);
* `no_ldmatrix`: no ldmatrix of the A fragments;
* `n128`: one m64n128k16 `wgmma` a k16 step for the two m64n64k16 parts;
* `no_io`: no token of a tile inside the image (no load of pe_tok, no
  store);
* `no_taps`: no tap (no fragment, no product, no staging of the next band
  in f32 IO);
* `no_stores`: no store of tok and xn.

Times are device times (`profile_scene.device_ms`) in the order as is,
variants, variants reversed, as is. Prints the card's name and power limit
first. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

_WINDOW_MAIN = r"""
#include "window_mma.cuh"
using namespace lft;
LFT_EXPORT_ERROR_STRING
extern "C" int probe_window(const bf16* q, const bf16* k, const bf16* v, bf16* attn, float* m,
                            float* l, int V, int h, int w, int D, float scale, int stats,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return stats ? launch_window_mma<true>(q, k, v, attn, m, l, V, h, w, D, 8, scale, s)
               : launch_window_mma<false>(q, k, v, attn, m, l, V, h, w, D, 8, scale, s);
}
"""

_FFN_MAIN = r"""
#include "ffn_sites.cuh"
using namespace lft;
LFT_EXPORT_ERROR_STRING
extern "C" int probe_ffn_sites(const float* xn2, const float* x2, const float* w1,
                               const float* w2, const float* wlin, float* wf, float* out, int T,
                               int sites, void* stream) {
  return launch_ffn_sites<64, false>(xn2, x2, w1, w2, wlin, wf, out, T, 1, 1, sites,
                                     static_cast<cudaStream_t>(stream));
}
"""

_ANG_MAIN = r"""
#include "ang_bf16.cuh"
using namespace lft;
LFT_EXPORT_ERROR_STRING
extern "C" int probe_ang(const void* x, const float* pe, const float* ln, const float* wq,
                         const float* wk, const float* wv, const float* wo, const float* w1,
                         const float* w2, float* wf, void* out, int N, int A2, float scale,
                         int bf16_io, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  bf16* wb = reinterpret_cast<bf16*>(wf);
  if (bf16_io)
    return launch_ang_bf16<64, false, bf16>(static_cast<const bf16*>(x), pe, ln, wq, wk, wv, wo,
                                            w1, w2, wb, static_cast<bf16*>(out), nullptr,
                                            nullptr, nullptr, N, A2, scale, s);
  return launch_ang_bf16<64, false, float>(static_cast<const float*>(x), pe, ln, wq, wk, wv, wo,
                                           w1, w2, wb, static_cast<float*>(out), nullptr, nullptr,
                                           nullptr, N, A2, scale, s);
}
"""

_FFN_IO_MAIN = r"""
#include "ffn_bf16.cuh"
using namespace lft;
LFT_EXPORT_ERROR_STRING
extern "C" int probe_ffn_io(const bf16* xn2, const bf16* x2, const float* w1, const float* w2,
                            const float* wlin, float* wf, bf16* out, int T, void* stream) {
  return launch_ffn_bf16<64, false, bf16>(xn2, x2, w1, w2, wlin, reinterpret_cast<bf16*>(wf),
                                          out, T, 1, 1, static_cast<cudaStream_t>(stream));
}
"""

_ANG_SITES_MAIN = r"""
#include "ang_sites.cuh"
using namespace lft;
LFT_EXPORT_ERROR_STRING
extern "C" int probe_ang_sites(const float* x, const float* pe, const float* ln, const float* wq,
                               const float* wk, const float* wv, const float* wo, const float* w1,
                               const float* w2, float* wf, float* out, int N, int A2, float scale,
                               int sites, void* stream) {
  return launch_ang_sites<64, false>(x, pe, ln, wq, wk, wv, wo, w1, w2, wf, out, nullptr, nullptr,
                                     nullptr, N, A2, scale, sites,
                                     static_cast<cudaStream_t>(stream));
}
"""

_TOK_MAIN = r"""
#include "tok_bf16.cuh"
using namespace lft;
LFT_EXPORT_ERROR_STRING
extern "C" int probe_tok(const void* x, const void* pe, const float* wu, float* wf,
                         const float* ln, void* tok, void* xn, int V, int h, int w, int r, int cw,
                         int bf16_io, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16_io)
    return launch_tok_bf16<64, false, bf16>(static_cast<const bf16*>(x), wu, wf,
                                            static_cast<const bf16*>(pe), ln,
                                            static_cast<bf16*>(tok), static_cast<bf16*>(xn), V,
                                            h, w, 1, r, cw, s);
  return launch_tok_bf16<64, false, float>(static_cast<const float*>(x), wu, wf,
                                           static_cast<const float*>(pe), ln,
                                           static_cast<float*>(tok), static_cast<float*>(xn), V,
                                           h, w, 1, r, cw, s);
}
"""

MAINS = {"window": _WINDOW_MAIN, "ffn_sites": _FFN_MAIN, "ang": _ANG_MAIN,
         "ffn_io": _FFN_IO_MAIN, "ang_sites": _ANG_SITES_MAIN, "tok_bf16": _TOK_MAIN}

_PASS1 = ("  cp_async_wait<1>();\n  __syncthreads();\n  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};",
          "  float m[2] = {0.f, 0.f};\n  if (V < 0) {\n  cp_async_wait<1>();\n  __syncthreads();")
_PASS1_END = ("    m[hh] *= scale;   // scale > 0: the max of the scaled scores\n  }\n",
              "    m[hh] *= scale;   // scale > 0: the max of the scaled scores\n  }\n  }\n")

_ANG_EXP = ("            s0[i] = key < A2 ? ex2(fmaf(s0[i], sl, -ml[i >> 1])) : 0.f;\n"
            "            s1[i] = key + 8 < A2 ? ex2(fmaf(s1[i], sl, -ml[i >> 1])) : 0.f;")
_ANG_EXP_AT = "template <int C>\nstruct AngBf16 {"
_LN64 = """template <int N>
__device__ __forceinline__ void quad_ln64(RgAcc<N>& v, const float* __restrict__ w,
                                          const float* __restrict__ b) {
  using P = RgParts<N>;
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    double s = 0.0;
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j)
        s += static_cast<double>(v[p][4 * j + 2 * h]) + v[p][4 * j + 2 * h + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const double mu = s / N;
    double qq = 0.0;
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const double d = v[p][4 * j + 2 * h + e] - mu;
          qq = fma(d, d, qq);
        }
    qq += __shfl_xor_sync(0xffffffffu, qq, 1);
    qq += __shfl_xor_sync(0xffffffffu, qq, 2);
    const double rstd = 1.0 / sqrt(qq / N + static_cast<double>(1e-5f));
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = p * P::NW + 8 * j + 2 * q + e;
          float& x = v[p][4 * j + 2 * h + e];
          x = static_cast<float>((x - mu) * rstd * __ldg(w + c) + __ldg(b + c));
        }
  }
}

"""
_ANG_LN64 = [("ang_bf16.cuh", _ANG_EXP_AT, _LN64 + _ANG_EXP_AT),
             ("ang_bf16.cuh", "      quad_ln<C>(xn, ln, ln + C);", "      quad_ln64<C>(xn, ln, ln + C);"),
             ("ang_bf16.cuh", "      quad_ln<C>(t, ln + 2 * C, ln + 3 * C);",
              "      quad_ln64<C>(t, ln + 2 * C, ln + 3 * C);")]
_ANG_QKV = """      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(va, xa[s], bf16_piece_desc<C>(ws, L::OFF_V, s, 0), s);
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(qa, na[s], bf16_piece_desc<C>(ws, L::OFF_Q, s, 0), s);
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(ka, na[s], bf16_piece_desc<C>(ws, L::OFF_K, s, 0), s);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(va);
      reg_fence(qa);
      reg_fence(ka);
"""
_ANG_QKV_FLUSH = """#pragma unroll
      for (int s = 0; s < KC; ++s) {
        float tv[C / 2], tq[C / 2], tk[C / 2];
        wgmma_fence();
        WgmmaBf<C>::mma(tv, xa[s], bf16_piece_desc<C>(ws, L::OFF_V, s, 0), 0);
        WgmmaBf<C>::mma(tq, na[s], bf16_piece_desc<C>(ws, L::OFF_Q, s, 0), 0);
        WgmmaBf<C>::mma(tk, na[s], bf16_piece_desc<C>(ws, L::OFF_K, s, 0), 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(tv);
        reg_fence(tq);
        reg_fence(tk);
#pragma unroll
        for (int e = 0; e < C / 2; ++e) {
          va[e] = s ? va[e] + tv[e] : tv[e];
          qa[e] = s ? qa[e] + tq[e] : tq[e];
          ka[e] = s ? ka[e] + tk[e] : tk[e];
        }
      }
"""

_SITES_EXP = ("          s0[i] = key < A2 ? ex2(fmaf(s0[i], sl, -ml[i >> 1])) : 0.f;\n"
              "          s1[i] = key + 8 < A2 ? ex2(fmaf(s1[i], sl, -ml[i >> 1])) : 0.f;")
_TF32X3 = ("      Wgmma<NW>::mma(sum[z], al[c & 1][u], dh, u || !first);\n"
           "      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dl, 1);\n"
           "      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dh, 1);\n",
           "      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dh, u || !first);\n")

# target -> variant -> [(file, anchor, replacement), ...]
VARIANTS = {
    "window": {
        "one_pass": [("window_mma.cuh",) + _PASS1, ("window_mma.cuh",) + _PASS1_END],
        "no_exp": [("window_mma.cuh", "const float ex = expf(s[r][2 * hh + c] * scale - m[hh]);",
                    "const float ex = s[r][2 * hh + c] * scale - m[hh];")],
        "fast_exp": [("window_mma.cuh", "const float ex = expf(s[r][2 * hh + c] * scale - m[hh]);",
                      "const float ex = __expf(s[r][2 * hh + c] * scale - m[hh]);")],
        "no_pv": [("window_mma.cuh", "      mma_bf16(o[n], a, b0, b1);\n",
                   "      o[n][0] += __uint_as_float((a[0] ^ b0 ^ b1) & 1u);\n")],
        "no_score_mma": [("window_mma.cuh",
                          "        mma_bf16(s[r], qa[e], b[0], b[1]);\n"
                          "        mma_bf16(s[r + 1], qa[e], b[2], b[3]);\n",
                          "        s[r][0] += __uint_as_float((qa[e][0] ^ b[0] ^ b[1]) & 1u);\n"
                          "        s[r + 1][0] += __uint_as_float((qa[e][1] ^ b[2] ^ b[3]) & 1u);\n")],
        "no_staging": [("window_mma.cuh", "  stage(k, kh, std::integral_constant<int, CH>{}, 0);",
                        "  cp_async_commit();"),
                       ("window_mma.cuh", "  stage(v, vh, std::integral_constant<int, CHV>{}, 0);",
                        "  cp_async_commit();"),
                       ("window_mma.cuh", "      stage(v, vh, std::integral_constant<int, CHV>{}, "
                        "e / (H / WM_VS) * CHV);", "")],
        "v_whole": [("window_mma.cuh", "constexpr int WM_VS = 2;", "constexpr int WM_VS = 1;"),
                    ("window_mma.cuh", "constexpr int WM_BLOCKS = 4;",
                     "constexpr int WM_BLOCKS = 3;")],
    },
    "ffn_sites": {
        "tf32x1": [("ffn_sites.cuh",) + _TF32X3],
        "chain16": [("ffn_sites.cuh", "constexpr int FS_CHAIN = 4;", "constexpr int FS_CHAIN = 1;")],
        "chain32": [("ffn_sites.cuh", "constexpr int FS_CHAIN = 4;", "constexpr int FS_CHAIN = 2;")],
        "chain_all": [("ffn_sites.cuh", "constexpr int FS_CHAIN = 4;", "constexpr int FS_CHAIN = 8;")],
        "no_rows": [("ffn_sites.cuh",
                     "    cp_async16(aw + r * (D + 4) + c, src + static_cast<size_t>(ok ? t0 + r : 0) "
                     "* D + c, ok);\n", "    (void)ok;\n"),
                    ("ffn_sites.cuh", "    const float2 a0 = ok0 ? ldg2(r0 + 16 * s) : z, "
                     "a1 = ok1 ? ldg2(r1 + 16 * s) : z;\n    const float2 a2 = ok0 ? ldg2(r0 + 16 * s "
                     "+ 8) : z, a3 = ok1 ? ldg2(r1 + 16 * s + 8) : z;\n",
                     "    const float2 a0 = make_float2(static_cast<float>(s), 1.f), a1 = a0, a2 = a0,"
                     " a3 = a0;\n    (void)r0;\n    (void)r1;\n")],
    },
    "ang": {
        "no_attention": [("ang_bf16.cuh", "    const int items = np * MT * NG;",
                          "    const int items = A2 < 0 ? np * MT * NG : 0;")],
        "no_max_pass": [("ang_bf16.cuh",
                         "      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};\n"
                         "      for (int k0 = 0; k0 < A2; k0 += 16) {",
                         "      float mx[2] = {0.f, 0.f};\n"
                         "      for (int k0 = 0; k0 < (A2 < 0 ? A2 : 0); k0 += 16) {")],
        "no_attn_mma": [("ang_bf16.cuh",
                         "      mma_bf16_k8(s0, qh, kb[2 * u]);\n"
                         "      mma_bf16_k8(s1, qh, kb[2 * u + 1]);\n",
                         "      s0[0] += __uint_as_float((qh[0] ^ kb[2 * u]) & 1u);\n"
                         "      s1[0] += __uint_as_float((qh[1] ^ kb[2 * u + 1]) & 1u);\n"),
                        ("ang_bf16.cuh",
                         "          mma_bf16(o[hh], pa, vb[2 * u], vb[2 * u + 1]);",
                         "          o[hh][0] += __uint_as_float((pa[0] ^ pa[3] ^ vb[2 * u] ^ "
                         "vb[2 * u + 1]) & 1u);")],
        "no_exp": [("ang_bf16.cuh", _ANG_EXP,
                    "            s0[i] = key < A2 ? fmaf(s0[i], sl, -ml[i >> 1]) : 0.f;\n"
                    "            s1[i] = key + 8 < A2 ? fmaf(s1[i], sl, -ml[i >> 1]) : 0.f;")],
        "plain_expf": [("ang_bf16.cuh", _ANG_EXP,
                        "            s0[i] = key < A2 ? expf(__fsub_rn(__fmul_rn(s0[i], scale), "
                        "m[i >> 1])) : 0.f;\n"
                        "            s1[i] = key + 8 < A2 ? expf(__fsub_rn(__fmul_rn(s1[i], scale), "
                        "m[i >> 1])) : 0.f;")],
        "no_staging": [("ang_bf16.cuh",
                        "      cp_async16v(dst + r * LDR + c, x + (ok ? row0 + wr + r : 0) * C + c, "
                        "ok);", "      (void)ok;")],
        "flush_qkv": [("ang_bf16.cuh", _ANG_QKV, _ANG_QKV_FLUSH)],
        "ln_f64": _ANG_LN64,
    },
    "ffn_io": {
        "no_rows": [("ffn_bf16.cuh",
                     "    cp_async16v(aw + r * (D + 8) + c, src + static_cast<size_t>(ok ? t0 + r : 0)"
                     " * D + c, ok);", "    (void)ok;")],
        "no_x2": [("ffn_bf16.cuh",
                   "        const float2 r = t < T ? ldg2(x2 + static_cast<size_t>(t) * D + 8 * j + 2 * q)"
                   "\n                               : make_float2(0.f, 0.f);",
                   "        const float2 r = make_float2(0.f, static_cast<float>(t));")],
    },
    "ang_sites": {
        "no_attention": [("ang_sites.cuh", "  const int items = np * MT * NG;",
                          "  const int items = A2 < 0 ? np * MT * NG : 0;")],
        "no_max_pass": [("ang_sites.cuh",
                         "    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};\n"
                         "    for (int k0 = 0; k0 < A2; k0 += 16) {",
                         "    float mx[2] = {0.f, 0.f};\n"
                         "    for (int k0 = 0; k0 < (A2 < 0 ? A2 : 0); k0 += 16) {")],
        "no_exp": [("ang_sites.cuh", _SITES_EXP,
                    "          s0[i] = key < A2 ? fmaf(s0[i], sl, -ml[i >> 1]) : 0.f;\n"
                    "          s1[i] = key + 8 < A2 ? fmaf(s1[i], sl, -ml[i >> 1]) : 0.f;")],
        "expf": [("ang_sites.cuh", _SITES_EXP,
                  "          s0[i] = key < A2 ? expf(__fsub_rn(__fmul_rn(s0[i], scale), "
                  "m[i >> 1])) : 0.f;\n"
                  "          s1[i] = key + 8 < A2 ? expf(__fsub_rn(__fmul_rn(s1[i], scale), "
                  "m[i >> 1])) : 0.f;")],
        "attn_tf32x1": [("ang_sites.cuh",
                         "    mma_tf32(c, al, bh[0], bh[1]);\n    mma_tf32(c, ah, bl[0], bl[1]);\n",
                         "    (void)al;\n    (void)bl;\n")],
        "tf32x1": [("ang_sites.cuh",
                    "    Wgmma<N>::mma(s0, al[b][0], h0, c > 0);\n"
                    "    Wgmma<N>::mma(s1, al[b][1], h1, c > 0);\n"
                    "    Wgmma<N>::mma(s0, ah[b][0], h0 + 2 * N, 1);\n"
                    "    Wgmma<N>::mma(s1, ah[b][1], h1 + 2 * N, 1);\n"
                    "    Wgmma<N>::mma(s0, ah[b][0], h0, 1);\n"
                    "    Wgmma<N>::mma(s1, ah[b][1], h1, 1);\n",
                    "    Wgmma<N>::mma(s0, ah[b][0], h0, c > 0);\n"
                    "    Wgmma<N>::mma(s1, ah[b][1], h1, c > 0);\n"),
                   ("ang_sites.cuh",
                    "    Wgmma<N>::mma(va, xl[b], dv, kk > 0);\n"
                    "    Wgmma<N>::mma(qa, nl[b], dq, kk > 0);\n"
                    "    Wgmma<N>::mma(ka, nl[b], dk, kk > 0);\n"
                    "    Wgmma<N>::mma(va, xh[b], dv + 2 * N, 1);\n"
                    "    Wgmma<N>::mma(qa, nh[b], dq + 2 * N, 1);\n"
                    "    Wgmma<N>::mma(ka, nh[b], dk + 2 * N, 1);\n"
                    "    Wgmma<N>::mma(va, xh[b], dv, 1);\n"
                    "    Wgmma<N>::mma(qa, nh[b], dq, 1);\n"
                    "    Wgmma<N>::mma(ka, nh[b], dk, 1);\n",
                    "    Wgmma<N>::mma(va, xh[b], dv, kk > 0);\n"
                    "    Wgmma<N>::mma(qa, nh[b], dq, kk > 0);\n"
                    "    Wgmma<N>::mma(ka, nh[b], dk, kk > 0);\n")],
        "no_prefetch": [("ang_sites.cuh", "      if (lane == 0 && nr > 0)",
                         "      if (lane == 0 && nr < 0)")],
        "no_tf3_mma": [("ang_sites.cuh",
                        "    Wgmma<N>::mma(s0, al[b][0], h0, c > 0);\n"
                        "    Wgmma<N>::mma(s1, al[b][1], h1, c > 0);\n"
                        "    Wgmma<N>::mma(s0, ah[b][0], h0 + 2 * N, 1);\n"
                        "    Wgmma<N>::mma(s1, ah[b][1], h1 + 2 * N, 1);\n"
                        "    Wgmma<N>::mma(s0, ah[b][0], h0, 1);\n"
                        "    Wgmma<N>::mma(s1, ah[b][1], h1, 1);\n",
                        "    s0[0] += __uint_as_float((al[b][0][0] ^ ah[b][1][3] ^ "
                        "static_cast<uint32_t>(h0)) & 1u);\n")],
        "no_x": [("ang_sites.cuh",
                  "      return wr + r < nrows ? ldg2(x + (row0 + wr + r) * C + c) : "
                  "make_float2(0.f, 0.f);",
                  "      return make_float2(static_cast<float>(r), static_cast<float>(c));")],
        "no_ln": [("ang_sites.cuh", "      quad_ln<C>(xn, ln, ln + C);", "      (void)ln;"),
                  ("ang_sites.cuh", "    quad_ln<C>(t, ln + 2 * C, ln + 3 * C);", "")],
        "no_put": [("ang_sites.cuh", "                     bool two) {",
                    "                     bool two) {\n        if (N > 0) return;")],
        "no_tile_barrier": [("ang_sites.cuh", "    if (p.hid_kv && it > 0) {",
                             "    if (p.hid_kv && it < 0) {")],
        "no_out": [("ang_sites.cuh", "    rg_store_rows16<C>(out, o, orow);", "    (void)orow;")],
        "wait0": [("ang_sites.cuh", "    if (c > 0) {\n      wgmma_wait<1>();",
                   "    if (c > 0) {\n      wgmma_wait<0>();")],
    },
    "tok_bf16": {
        "no_band": [("tok_bf16.cuh", "      if (next < tiles) stage_all(nxt, nview, ny0, nx0, 0);",
                     "      (void)nview;"),
                    ("tok_bf16.cuh",
                     "        urow[tap & 1] = next < tiles ? source(nview, ny0, nx0, u) : -1;",
                     "        urow[tap & 1] = -1;")],
        "wait0": [("tok_bf16.cuh", "      if (tap > 0) wgmma_wait<1>();",
                   "      if (tap > 0) wgmma_wait<0>();")],
        "no_ln": [("tok_bf16.cuh", "    quad_ln<D>(v, ln, ln + D);", "    (void)ln;")],
        "no_mma": [("tok_bf16.cuh",
                    "          WgmmaBf<NW>::mma(acc[p], af[tap & 1][s], bf16_piece_desc<D>(ws, tap * "
                    "C * D, s, p * NW),\n                           tap + s);",
                    "          acc[p][s] += __uint_as_float((af[tap & 1][s][0] ^ af[tap & 1][s][3]) & "
                    "1u);")],
        "no_ldmatrix": [("tok_bf16.cuh",
                         "      for (int s = 0; s < KS; ++s) ldmatrix_x4(af[b][s], arow + toff * LDB "
                         "+ 16 * s);",
                         "      for (int s = 0; s < KS; ++s) af[b][s][0] += toff;")],
        "no_io": [("tok_bf16.cuh",
                   "      t[e] = mm < ntok && y < h && xx < w ? view * hw + y * w + xx : -1;",
                   "      t[e] = y < -1 ? mm : -1;")],
        "no_taps": [("tok_bf16.cuh", "    for (int tap = 0; tap < 9; ++tap) {",
                     "    for (int tap = 0; tap < (V < 0 ? 9 : 0); ++tap) {")],
        "n128": [("tok_bf16.cuh", "constexpr int TOK_N = 64;", "constexpr int TOK_N = 128;")],
        "no_stores": [("tok_bf16.cuh", "    rg_store_rows16<D>(tok, v, rows);\n", ""),
                      ("tok_bf16.cuh", "    rg_store_rows16<D>(xn, v, rows);", "    (void)xn;")],
    },
}


def _sources(target: str) -> dict:
    """{variant: {file: text}} of the target's edited headers."""
    from lft_torch.kernels import _build as b
    out = {"as_is": {}}
    for name, edits in VARIANTS[target].items():
        files = {}
        for fn, anchor, new in edits:
            text = files.get(fn)
            if text is None:
                with open(os.path.join(b.SRC_DIR, fn)) as f:
                    text = f.read()
            if anchor not in text:
                raise AssertionError(f"probe_variants: the anchor of {target}/{name} is gone "
                                     f"from {fn}")
            files[fn] = text.replace(anchor, new)
        out[name] = files
    return out


def _build(tmp: str, target: str, name: str, files: dict) -> ctypes.CDLL:
    from lft_torch.kernels import _build as b
    d = os.path.join(tmp, f"{target}_{name}")
    shutil.copytree(b.SRC_DIR, d)
    for fn, text in files.items():
        with open(os.path.join(d, fn), "w") as f:
            f.write(text)
    src = os.path.join(d, "probe_main.cu")
    with open(src, "w") as f:
        f.write(MAINS[target])
    so = os.path.join(d, "libprobe.so")
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {target}/{name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    if target == "window":
        lib.probe_window.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    elif target == "ffn_sites":
        lib.probe_ffn_sites.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    elif target == "ang":
        lib.probe_ang.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
                                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    elif target == "ang_sites":
        lib.probe_ang_sites.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
                                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    elif target == "tok_bf16":
        lib.probe_tok.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    else:
        lib.probe_ffn_io.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    return lib


ANG_EXACT = ("as_is", "plain_expf", "flush_qkv", "ln_f64")


def _ang_accuracy(libs: dict, dev) -> None:
    """`--accuracy`: out of K1's all-bf16 kernel in bf16 IO and of each
    variant of ANG_EXACT at C = 64 on `chip_smoke.py`'s random weights, 4
    draws each at [256, 25], [64, 81] and [64, 121]: its L2 distance from
    the plain version as a share of the plain bf16-vs-f32 distance, and the
    distance from float64 at the plain version's rounding points
    (`ang_block.ang_block_bf16io_f64`) as the same share, the plain
    version's beside it."""
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels.rowgemm import ang_bf16_floats
    from lft_torch.ops.posenc import angular_position

    l2 = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    C, H = 64, 8
    wf = torch.empty(ang_bf16_floats(C), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for N, A2 in ((256, 25), (64, 81), (64, 121)):
        pe = torch.from_numpy(angular_position(A2, C)).to(dev)
        for seed in range(4):
            g = torch.Generator(device=dev).manual_seed(1000 * seed + A2)
            rnd = lambda *s_: torch.randn(*s_, device=dev, generator=g)
            w = {n: rnd(*s_) / s_[0] ** 0.5 for n, s_ in (
                ("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)),
                ("w1", (C, 2 * C)), ("w2", (2 * C, C)))}
            w["ln"] = torch.stack([1 + 0.2 * rnd(C), 0.2 * rnd(C), 1 + 0.2 * rnd(C), 0.2 * rnd(C)])
            wb = {n: t.bfloat16() for n, t in w.items()}
            w32 = {n: t.float() for n, t in wb.items()}
            x = rnd(N, A2, C).bfloat16()
            ref = ab.ang_block_bf16io_plain(x, pe, wb, H)
            gap = l2(ab.ang_block_plain(x.float(), pe, w32, H), ref)
            exact = ab.ang_block_bf16io_f64(x, pe, w32, H)
            to_plain, to_exact = {}, {"plain": l2(ref, exact) / gap}
            for n in (n for n in ANG_EXACT if n in libs):
                out = torch.empty_like(x)
                if libs[n].probe_ang(x.data_ptr(), pe.data_ptr(), w32["ln"].data_ptr(),
                                     *(w32[k].data_ptr() for k in ("wq", "wk", "wv", "wo", "w1",
                                                                   "w2")),
                                     wf.data_ptr(), out.data_ptr(), N, A2, (C // H) ** -0.5, 1,
                                     stream):
                    raise RuntimeError(f"probe_variants: ang/{n} failed to launch")
                to_plain[n], to_exact[n] = l2(out, ref) / gap, l2(out, exact) / gap
            print(f"K1's all-bf16 kernel (bfloat16 IO) at [{N}, {A2}, {C}], draw {seed}: out's "
                  "share of the plain bf16-vs-f32 distance from the plain version: "
                  + " ".join(f"{n} {v:.4f}" for n, v in to_plain.items())
                  + "; from float64 at the plain's rounding points: "
                  + " ".join(f"{n} {v:.4f}" for n, v in to_exact.items()), flush=True)


def _turns(fns: dict) -> dict:
    from lft_torch.profile_scene import device_ms
    order = list(fns) + list(fns)[::-1]
    t = {n: [] for n in fns}
    for n in order:
        t[n].append(device_ms(fns[n]))
    return t


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--targets", default=",".join(VARIANTS),
                    help="comma-separated: " + ", ".join(VARIANTS))
    ap.add_argument("--accuracy", action="store_true",
                    help="also K1's all-bf16 variants' distances from the plain version "
                         "and from float64 (needs the ang target)")
    a = ap.parse_args(argv)
    targets = set(a.targets.split(","))
    if a.accuracy and "ang" not in targets:
        ap.error("--accuracy needs the ang target")
    if targets - set(VARIANTS):
        ap.error(f"--targets takes {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from lft_torch.device import resolve_device
    from lft_torch.kernels import common
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels.rowgemm import (ang_bf16_floats, ang_sites_floats, ffn_out_bf16_floats,
                                           ffn_out_floats)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(0)
    jobs = [(t, n, f) for t in VARIANTS if t in targets for n, f in _sources(t).items()]
    with tempfile.TemporaryDirectory() as tmp:
        def build(job):
            try:
                return _build(tmp, *job)
            except RuntimeError as e:   # a variant that does not build is left out
                if job[1] == "as_is":
                    raise
                print(str(e)[-3000:], flush=True)
                return None

        with ThreadPoolExecutor(len(jobs)) as ex:
            built = list(ex.map(build, jobs))
        libs = {(t, n): lib for (t, n, _), lib in zip(jobs, built) if lib is not None}
        stream = lambda: torch.cuda.current_stream().cuda_stream

        if "window" in targets:
            for V, stats in ((400, 0), (100, 1)):
                q, k, v = (torch.randn(V, 32, 32, 128, device=dev, generator=g) * s_
                           for s_ in (1.5, 1.5, 1.0))
                q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
                out = torch.empty_like(q)
                m, l = (torch.empty(V, 32, 32, 8, device=dev) for _ in range(2))
                fns = {}
                for (t, n), lib in libs.items():
                    if t != "window":
                        continue
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(),
                            l.data_ptr(), V, 32, 32, 128, 0.25, stats)
                    fns[n] = lambda f=lib.probe_window, a=args: f(*a, stream())
                    if fns[n]():
                        raise RuntimeError(f"probe_variants: window/{n} failed to launch")
                torch.cuda.synchronize()
                t = _turns(fns)
                print(f"the window kernel at [{V}, 32, 32, 128]{' with STATS' if stats else ''}: "
                      + "; ".join(f"{n} {w[0]:.4f} / {w[1]:.4f} ms" for n, w in t.items()),
                      flush=True)
                del q, k, v, out

        if "ffn_sites" in targets:
            ws = {n: torch.randn(*s_, device=dev, generator=g) / s_[0] ** 0.5
                  for n, s_ in (("w1", (128, 256)), ("w2", (256, 128)), ("wlin", (128, 64)))}
            xn2, x2 = (torch.randn(400 * 1024, 128, device=dev, generator=g) for _ in range(2))
            out = torch.empty(400 * 1024, 64, device=dev)
            wf = torch.empty(ffn_out_floats(64), device=dev)
            for spec, kept in (("S1", "qk,score,ffn,aqkv,aav,wo"),
                               ("S2", "tok,v,av,lin,ascore,awo,affn")):
                mask = common.site_mask(common.mm_site_plan(True, frozenset(kept.split(","))),
                                        "spa_ffn_out")
                fns = {}
                for (t, n), lib in libs.items():
                    if t != "ffn_sites":
                        continue
                    args = (xn2.data_ptr(), x2.data_ptr(), ws["w1"].data_ptr(), ws["w2"].data_ptr(),
                            ws["wlin"].data_ptr(), wf.data_ptr(), out.data_ptr(), xn2.shape[0], mask)
                    fns[n] = lambda f=lib.probe_ffn_sites, a=args: f(*a, stream())
                    if fns[n]():
                        raise RuntimeError(f"probe_variants: ffn_sites/{n} failed to launch")
                torch.cuda.synchronize()
                t = _turns(fns)
                print(f"K2.5 `_sites` under {spec} at [400, 32, 32, 64]: "
                      + "; ".join(f"{n} {w[0]:.4f} / {w[1]:.4f} ms" for n, w in t.items()),
                      flush=True)
            del xn2, x2, out

        if "ang" in targets:
            C, A2 = 64, 25
            wa = {n: torch.randn(*s_, device=dev, generator=g) / s_[0] ** 0.5
                  for n, s_ in (("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)),
                                ("w1", (C, 2 * C)), ("w2", (2 * C, C)))}
            wa = {n: t.bfloat16().float() for n, t in wa.items()}
            ln = torch.stack([torch.ones(C, device=dev), torch.zeros(C, device=dev)] * 2)
            pe = torch.randn(A2, C, device=dev, generator=g)
            wf = torch.empty(ang_bf16_floats(C), device=dev)
            for io in (torch.bfloat16, torch.float32):
                x = torch.randn(16384, A2, C, device=dev, generator=g).to(io)
                out = torch.empty_like(x)
                fns = {}
                for (t, n), lib in libs.items():
                    if t != "ang":
                        continue
                    args = (x.data_ptr(), pe.data_ptr(), ln.data_ptr(),
                            *(wa[k].data_ptr() for k in ("wq", "wk", "wv", "wo", "w1", "w2")),
                            wf.data_ptr(), out.data_ptr(), 16384, A2, (C // 8) ** -0.5,
                            int(io == torch.bfloat16))
                    fns[n] = lambda f=lib.probe_ang, a=args: f(*a, stream())
                    if fns[n]():
                        raise RuntimeError(f"probe_variants: ang/{n} failed to launch")
                torch.cuda.synchronize()
                t = _turns(fns)
                print(f"K1's all-bf16 kernel ({str(io)[6:]} IO) at [16384, {A2}, {C}]: "
                      + "; ".join(f"{n} {w[0]:.4f} / {w[1]:.4f} ms" for n, w in t.items()),
                      flush=True)
                del x, out
            if a.accuracy:
                _ang_accuracy({n: lib for (t, n), lib in libs.items() if t == "ang"}, dev)

        if "ffn_io" in targets:
            ws = {n: (torch.randn(*s_, device=dev, generator=g) / s_[0] ** 0.5).bfloat16().float()
                  for n, s_ in (("w1", (128, 256)), ("w2", (256, 128)), ("wlin", (128, 64)))}
            xn2, x2 = (torch.randn(400 * 1024, 128, device=dev, generator=g).bfloat16()
                       for _ in range(2))
            out = torch.empty(400 * 1024, 64, device=dev, dtype=torch.bfloat16)
            wf = torch.empty(ffn_out_bf16_floats(64), device=dev)
            fns = {}
            for (t, n), lib in libs.items():
                if t != "ffn_io":
                    continue
                args = (xn2.data_ptr(), x2.data_ptr(), ws["w1"].data_ptr(), ws["w2"].data_ptr(),
                        ws["wlin"].data_ptr(), wf.data_ptr(), out.data_ptr(), xn2.shape[0])
                fns[n] = lambda f=lib.probe_ffn_io, a=args: f(*a, stream())
                if fns[n]():
                    raise RuntimeError(f"probe_variants: ffn_io/{n} failed to launch")
            torch.cuda.synchronize()
            t = _turns(fns)
            print("K2.5 bf16io at [400, 32, 32, 64]: "
                  + "; ".join(f"{n} {w[0]:.4f} / {w[1]:.4f} ms" for n, w in t.items()), flush=True)

        if "ang_sites" in targets:
            C, A2 = 64, 25
            wa = {n: torch.randn(*s_, device=dev, generator=g) / s_[0] ** 0.5
                  for n, s_ in (("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)),
                                ("w1", (C, 2 * C)), ("w2", (2 * C, C)))}
            ln = torch.stack([torch.ones(C, device=dev), torch.zeros(C, device=dev)] * 2)
            pe = torch.randn(A2, C, device=dev, generator=g)
            wf = torch.empty(ang_sites_floats(C), device=dev)
            x = torch.randn(16384, A2, C, device=dev, generator=g)
            out = torch.empty_like(x)
            for spec, kept in (("S1", "qk,score,ffn,aqkv,aav,wo"),
                               ("S2", "tok,v,av,lin,ascore,awo,affn")):
                mask = common.site_mask(common.mm_site_plan(True, frozenset(kept.split(","))),
                                        "ang_block")
                fns = {}
                for (t, n), lib in libs.items():
                    if t != "ang_sites":
                        continue
                    args = (x.data_ptr(), pe.data_ptr(), ln.data_ptr(),
                            *(wa[k].data_ptr() for k in ("wq", "wk", "wv", "wo", "w1", "w2")),
                            wf.data_ptr(), out.data_ptr(), 16384, A2, (C // 8) ** -0.5, mask)
                    fns[n] = lambda f=lib.probe_ang_sites, a=args: f(*a, stream())
                    if fns[n]():
                        raise RuntimeError(f"probe_variants: ang_sites/{n} failed to launch")
                torch.cuda.synchronize()
                t = _turns(fns)
                print(f"K1's `_sites` kernel under {spec} at [16384, {A2}, {C}]: "
                      + "; ".join(f"{n} {w[0]:.4f} / {w[1]:.4f} ms" for n, w in t.items()),
                      flush=True)
            del x, out

        if "tok_bf16" in targets:
            C, h, w = 64, 32, 32
            wu = torch.randn(9, C, 2 * C, device=dev, generator=g) / (3 * C ** 0.5)
            ln = torch.stack([torch.ones(2 * C, device=dev), torch.zeros(2 * C, device=dev)])
            wf = torch.empty(sb.tok_bf16_floats(C), device=dev)
            r, cw = sb.tok_bf16_tile(h, w, C)
            for io in (torch.bfloat16, torch.float32):
                x = torch.randn(400, h, w, C, device=dev, generator=g).to(io)
                pe = torch.randn(h, w, 2 * C, device=dev, generator=g).to(io)
                tok = torch.empty(400, h, w, 2 * C, device=dev, dtype=io)
                xn = torch.empty_like(tok)
                fns = {}
                for (t, n), lib in libs.items():
                    if t != "tok_bf16":
                        continue
                    args = (x.data_ptr(), pe.data_ptr(), wu.data_ptr(), wf.data_ptr(),
                            ln.data_ptr(), tok.data_ptr(), xn.data_ptr(), 400, h, w, r, cw,
                            int(io == torch.bfloat16))
                    fns[n] = lambda f=lib.probe_tok, a=args: f(*a, stream())
                    if fns[n]():
                        raise RuntimeError(f"probe_variants: tok_bf16/{n} failed to launch")
                torch.cuda.synchronize()
                t = _turns(fns)
                print(f"K2.1's bf16 form ({str(io)[6:]} IO) at [400, {h}, {w}, {C}]: "
                      + "; ".join(f"{n} {w_[0]:.4f} / {w_[1]:.4f} ms" for n, w_ in t.items()),
                      flush=True)
                del x, tok, xn
    return 0


if __name__ == "__main__":
    sys.exit(main())
