"""What sets the pace of the bf16 window attention (`csrc/window_mma.cuh`),
of K2.5's `_sites` kernels (`csrc/ffn_sites.cuh`), of K1's all-bf16 kernel
(`csrc/ang_bf16.cuh`) and of K2.5's bf16-IO instance (`csrc/ffn_bf16.cuh`
on bf16 rows) on the card: each timed beside variants of its sources one
text edit away, in turns in one process (as `probe_wgrad`, `probe_k7`).

    python3 -m lft_torch.probe_variants [--targets window,ffn_sites,ang,ffn_io] [--accuracy]

Each variant is a copy of this checkout's `csrc` with one edit, and a
small source that includes the kernel's header and exports its launcher
(`probe_window`, `probe_ffn_sites`, `probe_ang`, `probe_ffn_io`), built with the port's nvcc flags into
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

MAINS = {"window": _WINDOW_MAIN, "ffn_sites": _FFN_MAIN, "ang": _ANG_MAIN,
         "ffn_io": _FFN_IO_MAIN}

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
        "tf32x1": [("ffn_sites.cuh",
                    "      Wgmma<NW>::mma(sum[z], al[c & 1][u], dh, u || !first);\n"
                    "      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dl, 1);\n"
                    "      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dh, 1);\n",
                    "      Wgmma<NW>::mma(sum[z], ah[c & 1][u], dh, u || !first);\n")],
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
    from lft_torch.kernels.rowgemm import ang_bf16_floats, ffn_out_bf16_floats, ffn_out_floats

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
