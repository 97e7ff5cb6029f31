"""What sets the pace of the bf16 window attention (`csrc/window_mma.cuh`)
and of K2.5's `_sites` kernels (`csrc/ffn_sites.cuh`) on the card: each
timed beside variants of its sources one text edit away, in turns in one
process (as `probe_wgrad`, `probe_k7`).

    python3 -m lft_torch.probe_variants

Each variant is a copy of this checkout's `csrc` with one edit, and a
small source that includes the kernel's header and exports its launcher
(`probe_window`, `probe_ffn_sites`), built with the port's nvcc flags into
a temporary directory, all at once; an edit whose anchor is gone from the
source raises. The variants compute wrong values on purpose: each is timed,
none is checked.

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

_PASS1 = ("  cp_async_wait<1>();\n  __syncthreads();\n  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};",
          "  float m[2] = {0.f, 0.f};\n  if (V < 0) {\n  cp_async_wait<1>();\n  __syncthreads();")
_PASS1_END = ("    m[hh] *= scale;   // scale > 0: the max of the scaled scores\n  }\n",
              "    m[hh] *= scale;   // scale > 0: the max of the scaled scores\n  }\n  }\n")

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
        f.write(_WINDOW_MAIN if target == "window" else _FFN_MAIN)
    so = os.path.join(d, "libprobe.so")
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {target}/{name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    if target == "window":
        lib.probe_window.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    else:
        lib.probe_ffn_sites.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    return lib


def _turns(fns: dict) -> dict:
    from lft_torch.profile_scene import device_ms
    order = list(fns) + list(fns)[::-1]
    t = {n: [] for n in fns}
    for n in order:
        t[n].append(device_ms(fns[n]))
    return t


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from lft_torch.device import resolve_device
    from lft_torch.kernels import common
    from lft_torch.kernels.rowgemm import ffn_out_floats

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(0)
    jobs = [(t, n, f) for t in VARIANTS for n, f in _sources(t).items()]
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(jobs)) as ex:
            built = list(ex.map(lambda j: _build(tmp, *j), jobs))
        libs = {(t, n): lib for (t, n, _), lib in zip(jobs, built)}
        stream = lambda: torch.cuda.current_stream().cuda_stream

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
