"""Time this checkout's row-tile block kernels against another revision's,
in turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_blocks OTHER_SPA_BLOCK_CU OTHER_ANG_BLOCK_CU

The two sources are `spa_block.cu` and `ang_block.cu` of a revision whose
K2.5 and K1 already run on `rowgemm.cuh` (their C entries take the weight
scratch, as this checkout's do) while K2.2 and K2.4 still run on the FP32
pipes (no scratch): the port at commit 1dcb33f. Its C interfaces:
`lft_spa_qkv(xn, tok, wqk, wv, q, k, v, T, C, stream)`,
`lft_spa_outproj_ln(attn, tok, wo, ln, x2, xn2, T, C, stream)`,
`lft_spa_ffn_out(xn2, x2, w1, w2, wlin, wf, out, T, C, stream)`,
`lft_spa_ffn_out_pm(xn2, x2, w1, w2, wlin, wf, out, Bb, hw, A2, C, stream)`,
`lft_ang_block_fwd(x, pe, ln, wq, wk, wv, wo, w1, w2, wf, out, N, A2, C, H,
scale, stream)` and `lft_ang_block_fwd_res(..., wf, out, m, l, attn, N, A2,
C, H, scale, stream)`. Unpack the revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`) into a git-ignored directory, so that its
headers come with it. Each source is built with the port's nvcc flags into
a temporary directory.

With the demo checkpoint's block-0 weights, at the shapes of the main
paths: K2.2 `spa_qkv`, K2.4 `spa_outproj_ln` and K2.5 `spa_ffn_out` at
[400, 32, 32, 64] (a scene's chunk) and [100, 32, 32, 64] (a fused train
step), K11.5 `spa_ffn_out_pm` at [16, 32, 32, 25, 64], K1 `ang_block` at
[16384, 25, 64], K1 `ang_block_res` at [4096, 25, 64] and at [1024, 81,
64] (angRes 9). Both builds are checked against the plain version (the
forwards within 1e-4 max(1, max |plain|), the residual form within 5e-4
max |plain| per output) and for a bitwise repeat; their max error against
float64 (each output of K2.2 and K2.4, the block output of the others) is
printed beside the f32 plain version's (TF32 off); both are timed in device
time (`profile_scene.device_ms`) in the order other, this, this, other.
Beside K2.2, K2.4, K2.5 and K11.5 the cuBLAS f32 products of the same
function on the same memory are timed (K2.4's with its residual, as one
`addmm`, without LN2): context, not a yardstick, since no one PyTorch call
computes the step. Then K2 chained at [400, 32, 32, 64] and K11 chained at
[16, 32, 32, 25, 64], with steps 2 and 4 of either build and the other
steps of this checkout, in the same turns, each held to the plain chain:
the chain's device time and, within it, that of its step 5 (K2.5 or
K11.5), the step that reads what step 4 wrote. Prints the card's name and power limit first. Exits
non-zero without a card.

    python3 -m lft_torch.compare_blocks --ffn-bf16 OTHER_SPA_BLOCK_CU

(or the other checkout's built `libspa_block_<hash>.so`, loaded as it is)
times K2.5's `_bf16` instance alone (`spa_ffn_out_bf16`, `--dtype mixed`
under LFT_MM_HP_SITES=none) against the other revision's, whose C entries
`lft_spa_ffn_out_bf16(xn2, x2, w1, w2, wlin, wf, out, T, C, stream)` and
`lft_spa_ffn_out_pm_bf16(..., out, Bb, hw, A2, C, stream)` take a scratch
of `rowgemm.ffn_out_floats(C)` floats (the TF32 stream of commits 9453b3c
to 4761636): at [400, 32, 32, 64] and [100, 32, 32, 64], and K11.5's
`spa_ffn_out_pm_bf16` at [16, 32, 32, 25, 64], both
builds against the plain version under the plan `none` (L2-relative 1e-3
and 1/10 of its mixed-vs-f32 distance), a bitwise repeat, timed in device
time other, this, this, other beside the bound (0.52 GB of f32 rows at
3.35 TB/s at the larger shape) and the three cuBLAS bf16 products.

    python3 -m lft_torch.compare_blocks --ffn-sites OTHER_SPA_BLOCK_CU

likewise K2.5's `_sites` instance (`spa_ffn_out_sites`, `--dtype mixed`
under an LFT_MM_HP_SITES subset that rounds one of `ffn` and `lin`)
against the other revision's, whose C entries `lft_spa_ffn_out_sites(xn2,
x2, w1, w2, wlin, wf, out, T, C, sites, stream)` and
`lft_spa_ffn_out_pm_sites(..., out, Bb, hw, A2, C, sites, stream)` take a
scratch of `rowgemm.ffn_out_floats(C)` floats: under S1 (`ffn` f32, `lin`
rounded) and S2 (`ffn` rounded, `lin` f32) at [400, 32, 32, 64] and [100,
32, 32, 64], and K11.5's `spa_ffn_out_pm_sites` at [16, 32, 32, 25, 64];
both builds against the plain version under the subset (L2-relative 1e-3
and 1/10 of its mixed-vs-f32 distance), their max error against float64 of
the same rounded operands beside the plain version's, a bitwise repeat,
timed other, this, this, other beside the bound (S1: W1 and W2 as three
TF32 products at 495 TFLOP/s, Wlin at 989; S2: the rows' bytes).

    python3 -m lft_torch.compare_blocks --ang-bf16 OTHER_ANG_BLOCK_CU

(or the other checkout's built `libang_block_<hash>.so`) likewise K1's
bf16-operand forms (`--dtype mixed` under LFT_MM_HP_SITES=none), whose C
entries `lft_ang_block_fwd_bf16` and `lft_ang_block_fwd_res_bf16` have this
checkout's interface (a scratch of `rowgemm.ang_block_floats(C)` floats):
`ang_block_bf16` at [16384, 25, 64] and `ang_block_res_bf16` at [4096, 25,
64], the demo checkpoint's block-0 weights; both builds against the plain
version under the plan `none` (out and attn L2-relative 1e-3 and 1/10 of
its mixed-vs-f32 distance, m and l L2 1e-3), their max error of out
against float64 (the plan's plain version in float64) beside the plain
version's, a bitwise repeat, the `_res` form's out its forward's; timed
other, this, this, other beside the bound (x in and out f32 at 3.35
TB/s, or the six products and the attention at the bf16 rate, the larger)
and the six cuBLAS bf16 products. Then, at the card tests' shapes (C 16,
32, 64; 9, 25, 81 and 121 views; 5 and 37 pixels at 121) with block 1's
weights of `init_params`, and at C = 64 and 64 pixels of 81 and 121 views
with `chip_smoke.py`'s random weights (N(0, 1 / fan-in), LayerNorm affine 1
+- 0.2), each output of `ang_block_res_bf16io` of both builds as a share of
the plain bf16-vs-f32 distance, two seeds each: how far two designs summing
in other orders lie from the plain version, bf16 roundings that flip
included.

    python3 -m lft_torch.compare_blocks --ang-sites OTHER_ANG_BLOCK_CU

(or the other build's `libang_block_<hash>.so`) likewise K1's site-subset
forms, whose C entries `lft_ang_block_fwd_sites` and
`lft_ang_block_fwd_res_sites` have this checkout's interface (the other
build's scratch, `rowgemm.ang_block_floats(C)` floats at commit 7589e65, is
within this one's): `ang_block_sites` at [16384, 25, 64] and
`ang_block_res_sites` at [4096, 25, 64] under S1, S2 and M3 (`aqkv` and
`awo` round: the attention's scores and e v both f32), the demo
checkpoint's block-0 weights; both builds against the plain version under
the subset (out and attn L2-relative 1e-3 and 1/10 of the mixed-vs-f32
distance, m and l L2 1e-3), their max error of out against float64 at the
plain version's rounding points beside the plain version's, a bitwise
repeat, the `_res` form's out its forward's; timed other, this, this,
other beside the bound (the products at the bf16 rate where their site
rounds and as three TF32 products where not, or x in and out, the larger)
and the six cuBLAS products at their sites' precision (bf16 or f32, TF32
off).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ATOL = 1e-4     # forwards: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # the residual form: max |diff| <= 5e-4 max |plain|, per output


def _load_other(spa_src: str, ang_src: str, build_dir: str):
    """(qkv, outproj_ln, ffn_out, ang_block) of the other revision, with
    this checkout's wrappers' arguments."""
    import ctypes

    from lft_torch.kernels import _build
    from lft_torch.kernels.rowgemm import ang_block_floats, ffn_out_floats
    spa = _build.build_library(spa_src, build_dir, "other_spa_block")
    ang = _build.build_library(ang_src, build_dir, "other_ang_block")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    spa.lft_spa_qkv.argtypes = [P] * 7 + [I] * 2 + [P]
    spa.lft_spa_outproj_ln.argtypes = [P] * 6 + [I] * 2 + [P]
    spa.lft_spa_ffn_out.argtypes = [P] * 7 + [I] * 2 + [P]
    spa.lft_spa_ffn_out_pm.argtypes = [P] * 7 + [I] * 4 + [P]
    ang.lft_ang_block_fwd.argtypes = [P] * 11 + [I] * 4 + [F, P]
    ang.lft_ang_block_fwd_res.argtypes = [P] * 14 + [I] * 4 + [F, P]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def qkv(xn, tok, wts):
        D = tok.shape[-1]
        q, k, v = (torch.empty_like(tok) for _ in range(3))
        check(spa.lft_spa_qkv(xn.data_ptr(), tok.data_ptr(), wts["wqk"].data_ptr(),
                              wts["wv"].data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              tok.numel() // D, D // 2, stream()), "spa_qkv")
        return q, k, v

    def outproj_ln(attn, tok, wts):
        D = tok.shape[-1]
        x2, xn2 = torch.empty_like(tok), torch.empty_like(tok)
        check(spa.lft_spa_outproj_ln(attn.data_ptr(), tok.data_ptr(), wts["wo"].data_ptr(),
                                     wts["ln"].data_ptr(), x2.data_ptr(), xn2.data_ptr(),
                                     tok.numel() // D, D // 2, stream()), "spa_outproj_ln")
        return x2, xn2

    def ffn_out(xn2, x2, wts, views=None):
        *lead, D = x2.shape
        C = D // 2
        w = [wts[n].data_ptr() for n in ("w1", "w2", "wlin")]
        wf = torch.empty(ffn_out_floats(C), device=x2.device)
        if views is None:
            out = torch.empty(*lead, C, device=x2.device)
            check(spa.lft_spa_ffn_out(xn2.data_ptr(), x2.data_ptr(), *w, wf.data_ptr(),
                                      out.data_ptr(), x2.numel() // D, C, stream()),
                  "spa_ffn_out")
        else:
            V, h, w_ = lead
            out = torch.empty(V // views, h, w_, views, C, device=x2.device)
            check(spa.lft_spa_ffn_out_pm(xn2.data_ptr(), x2.data_ptr(), *w, wf.data_ptr(),
                                         out.data_ptr(), V // views, h * w_, views, C,
                                         stream()), "spa_ffn_out_pm")
        return out

    def ang_block(x, pe, wts, H, with_res=False):
        N, A2, C = x.shape
        out = torch.empty_like(x)
        wf = torch.empty(ang_block_floats(C), device=x.device)
        ptrs = [x.data_ptr(), pe.data_ptr(),
                *(wts[n].data_ptr() for n in ("ln", "wq", "wk", "wv", "wo", "w1", "w2")),
                wf.data_ptr(), out.data_ptr()]
        tail = (N, A2, C, H, float(C // H) ** -0.5, stream())
        if not with_res:
            check(ang.lft_ang_block_fwd(*ptrs, *tail), "ang_block")
            return out
        m = torch.empty(N, A2, H, device=x.device)
        l = torch.empty_like(m)
        attn = torch.empty_like(x)
        check(ang.lft_ang_block_fwd_res(*ptrs, m.data_ptr(), l.data_ptr(), attn.data_ptr(),
                                        *tail), "ang_block_res")
        return out, m, l, attn

    return qkv, outproj_ln, ffn_out, ang_block


def _err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def _tuple(t):
    return t if isinstance(t, tuple) else (t,)


def _ffn_bf16_main(other_spa: str) -> int:
    """`--ffn-bf16` (the module docstring)."""
    import ctypes

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels.common import mm_site_plan
    from lft_torch.kernels.rowgemm import ffn_out_floats
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    ws = sb.spa_weights(params, "altblock.0.spa_trans.")
    none = mm_site_plan(True, frozenset())
    C, h, w = 64, 32, 32
    D = 2 * C
    wsb = {k: v.to(torch.bfloat16) for k, v in ws.items()}
    g = torch.Generator(device=dev).manual_seed(0)
    l2 = lambda a_, b_: float((a_.double() - b_.double()).norm() / b_.double().norm())
    with tempfile.TemporaryDirectory() as tmp:
        spa = ctypes.CDLL(other_spa) if other_spa.endswith(".so") else \
            _build.build_library(other_spa, tmp, "other_spa_block")
        fn, fn_pm = spa.lft_spa_ffn_out_bf16, spa.lft_spa_ffn_out_pm_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn_pm.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def other(xn2, x2, views=None):
            wf = torch.empty(ffn_out_floats(C), device=dev)
            ptrs = (xn2.data_ptr(), x2.data_ptr(),
                    *(ws[n].data_ptr() for n in ("w1", "w2", "wlin")), wf.data_ptr())
            stream = torch.cuda.current_stream().cuda_stream
            if views is None:
                out = torch.empty(*x2.shape[:-1], C, device=dev)
                rc = fn(*ptrs, out.data_ptr(), x2.numel() // D, C, stream)
            else:
                V_, h_, w_ = x2.shape[:-1]
                out = torch.empty(V_ // views, h_, w_, views, C, device=dev)
                rc = fn_pm(*ptrs, out.data_ptr(), V_ // views, h_ * w_, views, C, stream)
            if rc:
                raise RuntimeError("the other spa_ffn_out[_pm]_bf16 failed to launch")
            return out

        for V, A2 in ((400, None), (100, None), (400, 25)):
            xn2 = torch.randn(V, h, w, D, device=dev, generator=g)
            x2 = torch.randn(V, h, w, D, device=dev, generator=g)
            ref = sb.ffn_out_plain(xn2, x2, ws, none)
            gap = l2(sb.ffn_out_plain(xn2, x2, ws), ref)
            if A2 is not None:
                ref = sb._to_pixel_major(ref, A2)
            builds = (lambda: other(xn2, x2, A2), lambda: sb.ffn_out(xn2, x2, ws, A2, plan=none))
            dist = []
            for f in builds:
                got = f()
                d = l2(got, ref)
                if not (d <= 1e-3 and d <= 0.1 * gap):
                    raise AssertionError(f"spa_ffn_out[_pm]_bf16 [{V}, {h}, {w}, {C}]: a build "
                                         f"is {d:.3e} from the plain version (gap {gap:.3e})")
                if not torch.equal(got, f()):
                    raise AssertionError("spa_ffn_out_bf16: a build does not repeat bitwise")
                dist.append(d / gap)
            t = [device_ms(builds[0]), device_ms(builds[1]), device_ms(builds[1]),
                 device_ms(builds[0])]
            xb, x2b = xn2.reshape(-1, D).bfloat16(), x2.reshape(-1, D).bfloat16()
            hid = torch.empty(xb.shape[0], 2 * D, device=dev, dtype=torch.bfloat16)
            lib = device_ms(lambda: (torch.mm(xb, wsb["w1"], out=hid), hid @ wsb["w2"],
                                     x2b @ wsb["wlin"]))
            bound = (2 * xn2.numel() + V * h * w * C) * 4 / 3.35e12 * 1e3
            what = (f"spa_ffn_out_bf16 [{V}, {h}, {w}, {C}]" if A2 is None else
                    f"spa_ffn_out_pm_bf16 [{V // A2}, {h}, {w}, {A2}, {C}]")
            print(f"{what}: other {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"this {t[1]:.4f} / {t[2]:.4f} ms, bound {bound:.4f} ms (bytes), its three "
                  f"cuBLAS bf16 products {lib:.4f} ms; L2 from the plain version as a share of "
                  f"its mixed-vs-f32 distance: other {dist[0]:.4f}, this {dist[1]:.4f}",
                  flush=True)
    return 0


def _ang_bf16_main(other_ang: str) -> int:
    """`--ang-bf16` (the module docstring)."""
    import ctypes

    from lft_torch.compare_bf16io import other_libraries
    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels.common import mm_site_plan
    from lft_torch.ops.posenc import angular_position
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    _build.build_all()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    w64 = {k: v.double() for k, v in wa.items()}
    wab = {k: v.to(torch.bfloat16) for k, v in wa.items()}
    none = mm_site_plan(True, frozenset())
    C, A2, H = 64, 25, 8
    pe = torch.from_numpy(angular_position(A2, C)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    l2 = lambda a_, b_: float((a_.double() - b_.double()).norm() / b_.double().norm())
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(other_ang) if other_ang.endswith(".so") else \
            _build.build_library(other_ang, tmp, "other_ang_block")
        for N, res in ((16384, False), (4096, True)):
            name = "ang_block_res_bf16" if res else "ang_block_bf16"
            x = torch.randn(N, A2, C, device=dev, generator=g)
            fn = lambda x=x, res=res: ab.ang_block(x, pe, wa, H, with_res=res, plan=none)
            ref = _tuple(ab.ang_block_plain(x, pe, wa, H, with_res=res, plan=none))
            ref32 = _tuple(ab.ang_block_plain(x, pe, wa, H, with_res=res))
            exact = ab.ang_block_plain(x.double(), pe.double(), w64, H, plan=none)
            fwd = ab.ang_block(x, pe, wa, H, plan=none) if res else None

            def other(fn=fn):
                with other_libraries({"ang_block": lib}):
                    return fn()
            dist, err = [], []
            for f in (other, fn):
                got = _tuple(f())
                ds = [l2(got[i], ref[i]) for i in range(len(got))]
                gaps = [l2(ref32[i], ref[i]) for i in range(len(got))]
                ok = all(ds[i] <= 1e-3 and (i in (1, 2) or ds[i] <= 0.1 * gaps[i])
                         for i in range(len(got)))
                if not ok or not all(torch.equal(a_, b_) for a_, b_ in zip(got, _tuple(f()))):
                    raise AssertionError(f"{name}: a build disagrees with the plain version or "
                                         f"does not repeat ({ds}, gaps {gaps})")
                if f is fn and res and not torch.equal(got[0], fwd):
                    raise AssertionError(f"{name}: out is not ang_block_bf16's")
                dist.append(ds[0] / gaps[0])
                err.append(_err(got[0], exact))
            err.append(_err(ref[0], exact))
            t = [device_ms(other), device_ms(fn), device_ms(fn), device_ms(other)]
            tok = x.reshape(-1, C).bfloat16()
            hid = torch.cat([tok, tok], 1)
            lib_ms = device_ms(lambda: [tok @ wab[n] for n in ("wq", "wk", "wv", "wo", "w1")]
                               + [hid @ wab["w2"]])
            T = N * A2
            io = 2 * T * C * 4 + (T * (2 * H + C) * 4 if res else 0)
            flops = 2 * T * 8 * C * C + 4 * T * A2 * C
            bound = max(io / 3.35e12, flops / 989e12) * 1e3
            print(f"{name} [{N}, {A2}, {C}]: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / "
                  f"{t[2]:.4f} ms (this / other {(t[1] + t[2]) / (t[0] + t[3]):.3f}), bound "
                  f"{bound:.4f} ms, its six cuBLAS bf16 products {lib_ms:.4f} ms; out's L2 from "
                  f"the plain version as a share of its mixed-vs-f32 distance: other "
                  f"{dist[0]:.4f}, this {dist[1]:.4f}; max |out - float64| other {err[0]:.3e}, "
                  f"this {err[1]:.3e}, plain {err[2]:.3e}", flush=True)
        _res_bf16io_distances(lib, dev)
    return 0


def _res_bf16io_distances(lib, dev) -> None:
    """`--ang-bf16`'s second part (the module docstring): out, m, l, attn of
    `ang_block_res_bf16io`, this build's and `lib`'s."""
    from lft_torch.compare_bf16io import other_libraries
    from lft_torch.config import Args
    from lft_torch.kernels import ang_block as ab
    from lft_torch.models import lft
    from lft_torch.ops.posenc import angular_position

    share = lambda a, r, r32: float((a.double() - r.double()).norm()
                                    / (r32.double() - r.double()).norm())

    def random_weights(C, g):
        rnd = lambda *s_: torch.randn(*s_, device=dev, generator=g)
        w = {n: rnd(*s_) / s_[0] ** 0.5 for n, s_ in (
            ("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)), ("w1", (C, 2 * C)),
            ("w2", (2 * C, C)))}
        w["ln"] = torch.stack([1 + 0.2 * rnd(C), 0.2 * rnd(C), 1 + 0.2 * rnd(C), 0.2 * rnd(C)])
        return {n: t.bfloat16() for n, t in w.items()}

    cases = [(C, A2, N, "init_params") for C in (16, 32, 64)
             for A2, N in ((9, 37), (25, 37), (81, 7), (121, 5), (121, 37))]
    cases += [(64, A2, 64, "random") for A2 in (81, 121)]
    for C, A2, N, kind in cases:
        if kind == "random":
            wb = random_weights(C, torch.Generator(device=dev).manual_seed(A2))
        else:
            p = {k: v.bfloat16() for k, v in lft.init_params(0, Args(channels=C, scale_factor=2),
                                                             device=dev).items()}
            wb = ab.ang_weights(p, "altblock.1.ang_trans.")
        w32 = {k: v.float() for k, v in wb.items()}
        pe = torch.from_numpy(angular_position(A2, C)).to(dev)
        for seed in range(2):
            g = torch.Generator(device=dev).manual_seed(C + A2 + 100 * seed)
            x = torch.randn(N, A2, C, device=dev, generator=g).bfloat16()
            ref = ab.ang_block_plain(x, pe, wb, 8, with_res=True)
            ref32 = ab.ang_block_plain(x.float(), pe, w32, 8, with_res=True)
            got = ab.ang_block(x, pe, wb, 8, with_res=True)
            with other_libraries({"ang_block": lib}):
                old = ab.ang_block(x, pe, wb, 8, with_res=True)
            print(f"ang_block_res_bf16io [{N}, {A2}, {C}] {kind} weights, seed {seed}: out, m, "
                  "l, attn as shares of the plain bf16-vs-f32 distance: other "
                  + " ".join(f"{share(a, r, r32):.3f}" for a, r, r32 in zip(old, ref, ref32))
                  + "; this "
                  + " ".join(f"{share(a, r, r32):.3f}" for a, r, r32 in zip(got, ref, ref32)),
                  flush=True)


ANG_MASKS = (("S1", "qk,score,ffn,aqkv,aav,wo"), ("S2", "tok,v,av,lin,ascore,awo,affn"),
             ("M3", "tok,qk,v,score,av,wo,ffn,lin,ascore,aav,affn"))


def _ang_sites_main(other_ang: str) -> int:
    """`--ang-sites` (the module docstring)."""
    import ctypes

    from lft_torch.compare_bf16io import other_libraries
    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels.common import mm_site_plan
    from lft_torch.ops.posenc import angular_position
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    _build.build_all()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    w64 = {k: v.double() for k, v in wa.items()}
    C, A2, H = 64, 25, 8
    pe = torch.from_numpy(angular_position(A2, C)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    l2 = lambda a_, b_: float((a_.double() - b_.double()).norm() / b_.double().norm())
    site_of = {"wv": "aqkv", "wq": "aqkv", "wk": "aqkv", "wo": "awo", "w1": "affn",
               "w2": "affn"}
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(other_ang) if other_ang.endswith(".so") else \
            _build.build_library(other_ang, tmp, "other_ang_block")
        for spec, kept in ANG_MASKS:
            plan = mm_site_plan(True, frozenset(kept.split(",")))
            for N, res in ((16384, False), (4096, True)):
                name = "ang_block_res_sites" if res else "ang_block_sites"
                x = torch.randn(N, A2, C, device=dev, generator=g)
                fn = lambda x=x, res=res: ab.ang_block(x, pe, wa, H, with_res=res, plan=plan)
                ref = _tuple(ab.ang_block_plain(x, pe, wa, H, with_res=res, plan=plan))
                ref32 = _tuple(ab.ang_block_plain(x, pe, wa, H, with_res=res))
                exact = ab.ang_block_plain(x.double(), pe.double(), w64, H, plan=plan)
                fwd = ab.ang_block(x, pe, wa, H, plan=plan) if res else None

                def other(fn=fn):
                    with other_libraries({"ang_block": lib}):
                        return fn()
                dist, err = [], []
                for f in (other, fn):
                    got = _tuple(f())
                    ds = [l2(got[i], ref[i]) for i in range(len(got))]
                    gaps = [l2(ref32[i], ref[i]) for i in range(len(got))]
                    ok = all(ds[i] <= 1e-3 and (i in (1, 2) or ds[i] <= 0.1 * gaps[i])
                             for i in range(len(got)))
                    if not ok or not all(torch.equal(a_, b_) for a_, b_ in zip(got, _tuple(f()))):
                        raise AssertionError(f"{name} {spec}: a build disagrees with the plain "
                                             f"version or does not repeat ({ds}, gaps {gaps})")
                    if f is fn and res and not torch.equal(got[0], fwd):
                        raise AssertionError(f"{name} {spec}: out is not ang_block_sites'")
                    dist.append(ds[0] / gaps[0])
                    err.append(_err(got[0], exact))
                err.append(_err(ref[0], exact))
                t = [device_ms(other), device_ms(fn), device_ms(fn), device_ms(other)]
                tok = x.reshape(-1, C)
                hid = torch.cat([tok, tok], 1)
                cast = lambda t_, n_: t_.bfloat16() if plan[site_of[n_]] else t_
                ws_ = {n_: cast(wa[n_], n_) for n_ in site_of}
                ins = {n_: cast(hid if n_ == "w2" else tok, n_) for n_ in site_of}
                lib_ms = device_ms(lambda: [ins[n_] @ ws_[n_] for n_ in site_of])
                T = N * A2
                io = 2 * T * C * 4 + (T * (2 * H + C) * 4 if res else 0)
                prods = {"aqkv": 3 * 2 * T * C * C, "awo": 2 * T * C * C,
                         "affn": 4 * 2 * T * C * C, "ascore": 2 * T * A2 * C,
                         "aav": 2 * T * A2 * C}
                ops = sum(f_ / (989e12 if plan[s_] else 495e12 / 3) for s_, f_ in prods.items())
                bound = max(io / 3.35e12, ops) * 1e3
                print(f"{name} {spec} [{N}, {A2}, {C}]: other {t[0]:.4f} / {t[3]:.4f} ms, this "
                      f"{t[1]:.4f} / {t[2]:.4f} ms (this / other "
                      f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}), bound {bound:.4f} ms "
                      f"({'bytes' if io / 3.35e12 >= ops else 'operations'}), its six cuBLAS "
                      f"products {lib_ms:.4f} ms; out's L2 from the plain version as a share of "
                      f"its mixed-vs-f32 distance: other {dist[0]:.4f}, this {dist[1]:.4f}; max "
                      f"|out - float64| other {err[0]:.3e}, this {err[1]:.3e}, plain "
                      f"{err[2]:.3e}", flush=True)
    return 0


def _ffn_sites_main(other_spa: str) -> int:
    """`--ffn-sites` (the module docstring)."""
    import ctypes

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels.common import mm_site_plan, site_mask
    from lft_torch.kernels.rowgemm import ffn_out_floats
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    ws = sb.spa_weights(params, "altblock.0.spa_trans.")
    w64 = {k: v.double() for k, v in ws.items()}
    C, h, w = 64, 32, 32
    D = 2 * C
    g = torch.Generator(device=dev).manual_seed(0)
    l2 = lambda a_, b_: float((a_.double() - b_.double()).norm() / b_.double().norm())
    with tempfile.TemporaryDirectory() as tmp:
        spa = ctypes.CDLL(other_spa) if other_spa.endswith(".so") else \
            _build.build_library(other_spa, tmp, "other_spa_block")
        fn, fn_pm = spa.lft_spa_ffn_out_sites, spa.lft_spa_ffn_out_pm_sites
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn_pm.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

        def other(xn2, x2, mask, views=None):
            wf = torch.empty(ffn_out_floats(C), device=dev)
            ptrs = (xn2.data_ptr(), x2.data_ptr(),
                    *(ws[n].data_ptr() for n in ("w1", "w2", "wlin")), wf.data_ptr())
            stream = torch.cuda.current_stream().cuda_stream
            if views is None:
                out = torch.empty(*x2.shape[:-1], C, device=dev)
                rc = fn(*ptrs, out.data_ptr(), x2.numel() // D, C, mask, stream)
            else:
                V_, h_, w_ = x2.shape[:-1]
                out = torch.empty(V_ // views, h_, w_, views, C, device=dev)
                rc = fn_pm(*ptrs, out.data_ptr(), V_ // views, h_ * w_, views, C, mask, stream)
            if rc:
                raise RuntimeError("the other spa_ffn_out[_pm]_sites failed to launch")
            return out

        for spec, kept in (("S1", "qk,score,ffn,aqkv,aav,wo"),
                           ("S2", "tok,v,av,lin,ascore,awo,affn")):
            plan = mm_site_plan(True, frozenset(kept.split(",")))
            mask = site_mask(plan, "spa_ffn_out")
            for V, A2 in ((400, None), (100, None), (400, 25)):
                xn2 = torch.randn(V, h, w, D, device=dev, generator=g)
                x2 = torch.randn(V, h, w, D, device=dev, generator=g)
                ref = sb.ffn_out_plain(xn2, x2, ws, plan)
                gap = l2(sb.ffn_out_plain(xn2, x2, ws), ref)
                exact = sb.ffn_out_plain(xn2.double(), x2.double(), w64, plan)
                if A2 is not None:
                    ref, exact = sb._to_pixel_major(ref, A2), sb._to_pixel_major(exact, A2)
                builds = (lambda: other(xn2, x2, mask, A2),
                          lambda: sb.ffn_out(xn2, x2, ws, A2, plan=plan))
                dist, err = [], []
                for f in builds:
                    got = f()
                    d = l2(got, ref)
                    if not (d <= 1e-3 and d <= 0.1 * gap):
                        raise AssertionError(f"spa_ffn_out[_pm]_sites {spec} [{V}, {h}, {w}, "
                                             f"{C}]: a build is {d:.3e} from the plain version "
                                             f"(gap {gap:.3e})")
                    if not torch.equal(got, f()):
                        raise AssertionError("spa_ffn_out_sites: a build does not repeat bitwise")
                    dist.append(d / gap)
                    err.append(_err(got, exact))
                t = [device_ms(builds[0]), device_ms(builds[1]), device_ms(builds[1]),
                     device_ms(builds[0])]
                T = V * h * w
                rows = (2 * xn2.numel() + T * C) * 4 / 3.35e12 * 1e3
                big, small = 2 * T * 4 * D * D, 2 * T * D * C     # W1 + W2, Wlin
                ops = (3 * big / 495e12 + small / 989e12 if spec == "S1" else
                       big / 989e12 + 3 * small / 495e12) * 1e3
                bound = max(rows, ops)
                what = (f"spa_ffn_out_sites {spec} [{V}, {h}, {w}, {C}]" if A2 is None else
                        f"spa_ffn_out_pm_sites {spec} [{V // A2}, {h}, {w}, {A2}, {C}]")
                print(f"{what}: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} "
                      f"ms, bound {bound:.4f} ms ({'bytes' if rows >= ops else 'operations'}); "
                      f"L2 from the plain version as a share of its mixed-vs-f32 distance: "
                      f"other {dist[0]:.4f}, this {dist[1]:.4f}; max |out - float64| other "
                      f"{err[0]:.3e}, this {err[1]:.3e}, plain {_err(ref, exact):.3e}",
                      flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_spa", help="path of the other revision's spa_block.cu")
    ap.add_argument("other_ang", nargs="?", help="path of the other revision's ang_block.cu")
    ap.add_argument("--ffn-bf16", action="store_true",
                    help="K2.5's `_bf16` instance alone against the other spa_block.cu's")
    ap.add_argument("--ffn-sites", action="store_true",
                    help="K2.5's `_sites` instance alone against the other spa_block.cu's")
    ap.add_argument("--ang-bf16", action="store_true",
                    help="K1's `_bf16` forms alone against the other ang_block.cu's (the one "
                         "path given)")
    ap.add_argument("--ang-sites", action="store_true",
                    help="K1's `_sites` forms alone against the other ang_block.cu's (the one "
                         "path given)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_blocks: no CUDA device is available", file=sys.stderr)
        return 1
    if a.ffn_bf16:
        return _ffn_bf16_main(a.other_spa)
    if a.ffn_sites:
        return _ffn_sites_main(a.other_spa)
    if a.ang_bf16:
        return _ang_bf16_main(a.other_spa)
    if a.ang_sites:
        return _ang_sites_main(a.other_spa)
    if a.other_ang is None:
        ap.error("OTHER_ANG_BLOCK_CU is needed without --ffn-bf16 or --ffn-sites")
    from lft_torch.device import resolve_device
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    ws = sb.spa_weights(params, "altblock.0.spa_trans.")
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    ws64 = {k: v.double() for k, v in ws.items()}
    wa64 = {k: v.double() for k, v in wa.items()}
    C, h, w, H = 64, 32, 32, 8
    D = 2 * C
    g = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        o_qkv, o_out, o_ffn, o_ang = _load_other(a.other_spa, a.other_ang, tmp)
        cases = []
        for V in (400, 100):
            xn, tok, attn = (torch.randn(V, h, w, D, device=dev, generator=g) for _ in range(3))
            ref = sb.qkv_plain(xn, tok, ws)
            cases.append((f"K2.2 spa_qkv {[V, h, w, C]}", ref,
                          sb.qkv_plain(xn.double(), tok.double(), ws64),
                          lambda xn=xn, tok=tok: o_qkv(xn, tok, ws),
                          lambda xn=xn, tok=tok: sb.qkv(xn, tok, ws),
                          ("its two cuBLAS f32 products",
                           lambda xn=xn, tok=tok: (xn @ ws["wqk"], tok @ ws["wv"])),
                          KERNEL_ATOL * max(1.0, max(float(r.abs().max()) for r in ref)), None))
            ref = sb.outproj_ln_plain(attn, tok, ws)
            cases.append((f"K2.4 spa_outproj_ln {[V, h, w, C]}", ref,
                          sb.outproj_ln_plain(attn.double(), tok.double(), ws64),
                          lambda attn=attn, tok=tok: o_out(attn, tok, ws),
                          lambda attn=attn, tok=tok: sb.outproj_ln(attn, tok, ws),
                          ("its cuBLAS f32 product with the residual (addmm, no LN2)",
                           lambda attn=attn, tok=tok: torch.addmm(
                               tok.reshape(-1, D), attn.reshape(-1, D), ws["wo"])),
                          KERNEL_ATOL * max(1.0, max(float(r.abs().max()) for r in ref)), None))
            del xn, tok, attn
        for V, A2 in ((400, None), (100, None), (400, 25)):
            xn2 = torch.randn(V, h, w, D, device=dev, generator=g)
            x2 = torch.randn(V, h, w, D, device=dev, generator=g)
            ref = sb.ffn_out_plain(xn2, x2, ws)
            exact = sb.ffn_out_plain(xn2.double(), x2.double(), ws64)
            if A2 is not None:
                ref, exact = sb._to_pixel_major(ref, A2), sb._to_pixel_major(exact, A2)
            hid = torch.relu(xn2 @ ws["w1"])
            y = hid @ ws["w2"] + x2
            name = ("K2.5 spa_ffn_out", [V, h, w, C]) if A2 is None else \
                ("K11.5 spa_ffn_out_pm", [V // A2, h, w, A2, C])
            cases.append((f"{name[0]} {name[1]}", (ref,), (exact,),
                          lambda xn2=xn2, x2=x2, A2=A2: o_ffn(xn2, x2, ws, A2),
                          lambda xn2=xn2, x2=x2, A2=A2: sb.ffn_out(xn2, x2, ws, A2),
                          ("its three cuBLAS f32 products",
                           lambda xn2=xn2, hid=hid, y=y: (xn2 @ ws["w1"], hid @ ws["w2"],
                                                          y @ ws["wlin"])),
                          KERNEL_ATOL * max(1.0, float(ref.abs().max())), None))
            del hid, y
        for N, A2, res in ((16384, 25, False), (4096, 25, True), (1024, 81, True)):
            x = torch.randn(N, A2, C, device=dev, generator=g)
            pe = torch.from_numpy(angular_position(A2, C)).to(dev)
            ref = _tuple(ab.ang_block_plain(x, pe, wa, H, with_res=res))
            exact = ab.ang_block_plain(x.double(), pe.double(), wa64, H)
            cases.append((f"K1 ang_block{'_res' if res else ''} {[N, A2, C]}", ref, (exact,),
                          lambda x=x, pe=pe, res=res: o_ang(x, pe, wa, H, res),
                          lambda x=x, pe=pe, res=res: ab.ang_block(x, pe, wa, H, with_res=res),
                          None, KERNEL_ATOL * max(1.0, float(ref[0].abs().max())),
                          TRAIN_REL if res else None))
        for what, ref, exact, other, this, lib, limit, rel in cases:
            e_f32 = [_err(r, e) for r, e in zip(ref, exact)]
            errs = []
            for fn in (other, this):
                got = _tuple(fn())
                for i, (u, v) in enumerate(zip(got, ref)):
                    lim = limit if rel is None else rel * float(v.abs().max())
                    diff = _err(u, v)
                    if not diff <= lim:
                        raise AssertionError(f"{what}: a build disagrees with the plain "
                                             f"version at output {i} ({diff:.3e} > {lim:.3e})")
                errs.append([_err(u, e) for u, e in zip(got, exact)])
                if not all(torch.equal(u, v) for u, v in zip(got, _tuple(fn()))):
                    raise AssertionError(f"{what}: a build does not repeat bitwise")
                del got
            t = [device_ms(other), device_ms(this), device_ms(this), device_ms(other)]
            lib_note = "" if lib is None else f", {lib[0]} {device_ms(lib[1]):.4f} ms"
            f64 = "; ".join(
                f"other {eo:.3e}, this {et:.3e}, f32 plain (TF32 off) {ep:.3e} "
                f"(this / plain {et / max(ep, 1e-30):.3f}x)"
                for eo, et, ep in zip(errs[0], errs[1], e_f32))
            print(f"{what}: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms"
                  f"{lib_note}; max |out - float64| per output: {f64}", flush=True)

        # K2 and K11 chained: steps 2 and 4 of either build, the rest this
        # checkout's
        spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev)
        pe_tok = unfold3x3_linear(spa_pe[None], ws["mlp"])[0].contiguous()
        xs = torch.randn(400, h, w, C, device=dev, generator=g)
        xp = torch.randn(16, h, w, 25, C, device=dev, generator=g)

        def chain(x, qkv, outproj, views):
            tok, xn = sb.tokenize_ln(x, pe_tok, ws, views is not None)
            q, k, v = qkv(xn, tok, ws)
            x2, xn2 = outproj(sb.window_attn(q, k, v, H, 5), tok, ws)
            return sb.ffn_out(xn2, x2, ws, views)

        for what, x, views, ref, step5 in (
                ("K2 chained", xs, None, sb.spa_block_plain(xs, pe_tok, ws, H, 5),
                 "spa_ffn_out_kernel<64, false>"),
                ("K11 chained", xp, 25,
                 sb._to_pixel_major(sb.spa_block_plain(sb._to_view_major(xp), pe_tok, ws, H, 5),
                                    25), "spa_ffn_out_kernel<64, true>")):
            other = lambda x=x, views=views: chain(x, o_qkv, o_out, views)
            this = lambda x=x, views=views: chain(x, sb.qkv, sb.outproj_ln, views)
            lim = KERNEL_ATOL * max(1.0, float(ref.abs().max()))
            for fn in (other, this):
                if not _err(fn(), ref) <= lim:
                    raise AssertionError(f"{what}: a build disagrees with the plain chain")
            t = [(device_ms(fn), device_ms(fn, kernel=step5)) for fn in (other, this, this, other)]
            print(f"{what} {list(x.shape)}: other {t[0][0]:.4f} / {t[3][0]:.4f} ms, this "
                  f"{t[1][0]:.4f} / {t[2][0]:.4f} ms; its step 5 within: other {t[0][1]:.4f} / "
                  f"{t[3][1]:.4f} ms, this {t[1][1]:.4f} / {t[2][1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
