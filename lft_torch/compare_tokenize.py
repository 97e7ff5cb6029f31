"""Time this checkout's tokenization kernels against another revision's, in
turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_tokenize OTHER_SPA_BLOCK_CU OTHER_SPA_BLOCK_BWD_CU

The two sources are `spa_block.cu` and `spa_block_bwd.cu` of a revision
whose tokenization kernels have the C interface the port had before its
3xTF32 kernels: `lft_spa_tokenize_ln(x, pe_tok, wu, ln, tok, xn, V, h, w, C,
stream)` and `lft_spa_tokenize_ln_pm(x, pe_tok, wu, ln, tok, xn, Bb, h, w,
A2, C, stream)` with wu [9, C, D], `lft_spa_tokenize_bwd(dtok, wuT, dx, T,
h, w, C, stream)` with wuT [9, D, C]; e.g. `git archive <commit>
lft_torch/csrc` unpacked into a git-ignored directory, so that their headers
come with them. Each is built with the port's nvcc flags into a temporary
directory.

At the shapes of the main paths, with the demo checkpoint's block-0
weights: K2.1 `spa_tokenize_ln` at [400, 32, 32, 64] (a scene's chunk) and
[100, 32, 32, 64] (a fused train step), K11.1 `spa_tokenize_ln_pm` at
[16, 32, 32, 25, 64], K3.e `spa_tokenize_bwd` at [100, 32, 32, 128]. Both
builds are checked against the plain version, their max error against
float64 (tok, dx) is printed beside the f32 plain version's (TF32 off), and
both are timed in device time (`profile_scene.device_ms`) in the order
other, this, this, other, beside one cuDNN convolution on the same memory:
`F.conv_transpose2d` for K3.e (the same function), `F.conv2d` for K2.1 and
K11.1 ("conv part only": the tokenization without the PE and LN1). Prints
the card's name and power limit first. Exits non-zero without a card.

    python3 -m lft_torch.compare_tokenize --bf16 OTHER_SPA_BLOCK_CU

(or the other checkout's built `libspa_block_<hash>.so`, loaded as it is)
times the bf16 forms alone against the other revision's, whose C entries
have this checkout's interface (`compare_bf16io.other_libraries`: a scratch
of 18 C D floats and `tok_tile`'s tiles, as `tap_conv_kernel`'s bf16
instances of commit 7589e65 take them): K2.1 `spa_tokenize_ln_bf16io` and
`spa_tokenize_ln_bf16` (under LFT_MM_HP_SITES=none) at [400, 32, 32, 64],
K11.1 `spa_tokenize_ln_pm_bf16io` and `spa_tokenize_ln_pm_bf16` at [16, 32,
32, 25, 64], the demo checkpoint's block-0 weights. Both builds against the
plain version (bf16 IO: L2 within 1/10 of the plain bf16-vs-f32 distance
and 1 bf16 ulp; f32 IO: L2-relative 1e-3 and 1/10 of the mixed-vs-f32
distance), a bitwise repeat, this build's pixel-major forms bit for bit its
view-major ones on the permuted copy; timed other, this, this, other beside
the bound (the bytes of x, pe_tok, tok and xn, or the taps' products at the
bf16 rate, the larger) and cuDNN's bf16 convolution (conv part only).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ATOL = 1e-4     # tok, xn: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # dx: max |diff| <= 5e-4 max |plain|


def _load_other(fwd_src: str, bwd_src: str, build_dir: str):
    """(tokenize_ln, tokenize_bwd) of the other revision, with this
    checkout's wrappers' arguments."""
    import ctypes

    from lft_torch.kernels import _build
    fwd = _build.build_library(fwd_src, build_dir, "other_spa_block")
    bwd = _build.build_library(bwd_src, build_dir, "other_spa_block_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    fwd.lft_spa_tokenize_ln.argtypes = [P] * 6 + [I] * 4 + [P]
    fwd.lft_spa_tokenize_ln_pm.argtypes = [P] * 6 + [I] * 5 + [P]
    bwd.lft_spa_tokenize_bwd.argtypes = [P] * 3 + [I] * 4 + [P]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def tokenize_ln(x, pe_tok, wts, pixel_major=False):
        dims = tuple(x.shape)
        Bb, h, w = dims[:3]
        V = Bb * (dims[3] if pixel_major else 1)
        D = pe_tok.shape[-1]
        tok = torch.empty(V, h, w, D, device=x.device)
        xn = torch.empty_like(tok)
        fn = fwd.lft_spa_tokenize_ln_pm if pixel_major else fwd.lft_spa_tokenize_ln
        if fn(x.data_ptr(), pe_tok.data_ptr(), wts["wu"].data_ptr(), wts["ln"].data_ptr(),
              tok.data_ptr(), xn.data_ptr(), *dims, stream()):
            raise RuntimeError("the other spa_tokenize_ln failed to launch")
        return tok, xn

    def tokenize_bwd(dtok, wts, wuT):
        V, h, w, D = dtok.shape
        dx = torch.empty(V, h, w, D // 2, device=dtok.device)
        if bwd.lft_spa_tokenize_bwd(dtok.data_ptr(), wuT.data_ptr(), dx.data_ptr(), V * h * w,
                                    h, w, D // 2, stream()):
            raise RuntimeError("the other spa_tokenize_bwd failed to launch")
        return dx

    return tokenize_ln, tokenize_bwd


def _err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def _bf16_main(other_spa: str) -> int:
    """`--bf16` (the module docstring)."""
    import ctypes

    import torch.nn.functional as F

    from lft_torch.compare_bf16io import other_libraries
    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels.common import mm_site_plan
    from lft_torch.ops.posenc import spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    _build.build_all()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
    wb = {k: v.bfloat16() for k, v in ws.items()}
    wb32 = {k: v.float() for k, v in wb.items()}
    none = mm_site_plan(True, frozenset())
    C, h, w, A2 = 64, 32, 32, 25
    D = 2 * C
    pe = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                          ws["mlp"])[0].contiguous()
    peb = pe.bfloat16()
    g = torch.Generator(device=dev).manual_seed(0)
    l2 = lambda a_, b_: float((a_.double() - b_.double()).norm() / b_.double().norm())
    ulps = lambda a_, b_: float((a_.float() - b_.float()).abs().max()) / 2.0 ** (
        int(torch.floor(torch.log2(b_.float().abs().max()))) - 7)
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(other_spa) if other_spa.endswith(".so") else \
            _build.build_library(other_spa, tmp, "other_spa_block")
        for name, shape, bio in (("spa_tokenize_ln_bf16io", (400, h, w, C), True),
                                 ("spa_tokenize_ln_bf16", (400, h, w, C), False),
                                 ("spa_tokenize_ln_pm_bf16io", (16, h, w, A2, C), True),
                                 ("spa_tokenize_ln_pm_bf16", (16, h, w, A2, C), False)):
            pm = len(shape) == 5
            x = torch.randn(*shape, device=dev, generator=g)
            x = x.bfloat16() if bio else x
            xv = sb._to_view_major(x).contiguous() if pm else x
            wts, p_, plan = (wb, peb, None) if bio else (ws, pe, none)
            fn = lambda x=x, wts=wts, p_=p_, plan=plan, pm=pm: sb.tokenize_ln(
                x, p_, wts, pixel_major=pm, plan=plan)
            ref = sb.tokenize_ln_plain(xv, p_, wts, plan=plan)
            ref32 = (sb.tokenize_ln_plain(xv.float(), p_.float(), wb32) if bio else
                     sb.tokenize_ln_plain(xv, p_, ws))

            def other(fn=fn):
                with other_libraries({"spa_block": lib}):
                    return fn()
            dist = []
            for f in (other, fn):
                got = f()
                ds = [l2(got[i], ref[i]) / l2(ref32[i], ref[i]) for i in range(2)]
                ok = all(d <= 0.1 for d in ds) and (
                    all(ulps(got[i], ref[i]) <= 1 for i in range(2)) if bio else
                    all(l2(got[i], ref[i]) <= 1e-3 for i in range(2)))
                if not ok or not all(torch.equal(a_, b_) for a_, b_ in zip(got, f())):
                    raise AssertionError(f"{name}: a build disagrees with the plain version or "
                                         f"does not repeat (shares {ds})")
                dist.append(ds)
            if pm:
                vm = sb.tokenize_ln(xv, p_, wts, plan=plan)
                if not all(torch.equal(a_, b_) for a_, b_ in zip(fn(), vm)):
                    raise AssertionError(f"{name}: not the view-major form's bit for bit")
            t = [device_ms(other), device_ms(fn), device_ms(fn), device_ms(other)]
            xb = xv.bfloat16().permute(0, 3, 1, 2)
            wc = ws["mlp"].reshape(D, C, 3, 3).bfloat16()
            lib_ms = device_ms(lambda: F.conv2d(xb, wc, padding=1))
            T = xv.numel() // C
            e = 2 if bio else 4
            nbytes = T * (C + 2 * D) * e + h * w * D * e
            flops = 2 * T * 9 * C * D
            bound = max(nbytes / 3.35e12, flops / 989e12) * 1e3
            print(f"{name} {list(shape)}: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / "
                  f"{t[2]:.4f} ms (this / other {(t[1] + t[2]) / (t[0] + t[3]):.3f}), bound "
                  f"{bound:.4f} ms ({'bytes' if nbytes / 3.35e12 >= flops / 989e12 else 'ops'}), "
                  f"cuDNN bf16 conv part only {lib_ms:.4f} ms; tok, xn L2 from the plain "
                  f"version as shares of its {'bf16' if bio else 'mixed'}-vs-f32 distance: "
                  f"other {dist[0][0]:.4f}, {dist[0][1]:.4f}; this {dist[1][0]:.4f}, "
                  f"{dist[1][1]:.4f}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_fwd", help="path of the other revision's spa_block.cu")
    ap.add_argument("other_bwd", nargs="?", help="path of the other revision's spa_block_bwd.cu")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 forms alone against the other spa_block.cu's (or built .so)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_tokenize: no CUDA device is available", file=sys.stderr)
        return 1
    if a.bf16:
        return _bf16_main(a.other_fwd)
    if a.other_bwd is None:
        ap.error("OTHER_SPA_BLOCK_BWD_CU is needed without --bf16")
    import torch.nn.functional as F

    from lft_torch.device import resolve_device
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.posenc import spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
    C, h, w = 64, 32, 32
    D = 2 * C
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                              ws["mlp"])[0].contiguous()
    w_nchw = ws["mlp"].reshape(D, C, 3, 3)
    wuT = ws["wu"].transpose(1, 2).contiguous()
    g = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        o_tok, o_bwd = _load_other(a.other_fwd, a.other_bwd, tmp)
        cases = []
        for shape in ((400, h, w, C), (100, h, w, C), (16, h, w, 25, C)):
            x = torch.randn(*shape, device=dev, generator=g)
            pm = len(shape) == 5
            xv = sb._to_view_major(x).contiguous() if pm else x
            ref = sb.tokenize_ln_plain(xv, pe_tok, ws)
            exact = unfold3x3_linear(xv.double(), ws["mlp"].double())
            x_nchw = xv.permute(0, 3, 1, 2)
            name = "K11.1 spa_tokenize_ln_pm" if pm else "K2.1 spa_tokenize_ln"
            cases.append((f"{name} {list(shape)}", ref, exact,
                          lambda x=x, pm=pm: o_tok(x, pe_tok, ws, pm),
                          lambda x=x, pm=pm: sb.tokenize_ln(x, pe_tok, ws, pm),
                          lambda x_nchw=x_nchw: F.conv2d(x_nchw, w_nchw, padding=1),
                          "conv part only (F.conv2d)", KERNEL_ATOL * max(1.0, float(
                              max(t.abs().max() for t in ref)))))
        dtok = torch.randn(100, h, w, D, device=dev, generator=g)
        ref = sb.tokenize_bwd_plain(dtok, ws)
        cases.append((f"K3.e spa_tokenize_bwd {list(dtok.shape)}", (ref,),
                      sb.tokenize_bwd_plain(dtok.double(), dict(mlp=ws["mlp"].double())),
                      lambda: (o_bwd(dtok, ws, wuT),), lambda: (sb.tokenize_bwd(dtok, ws),),
                      lambda d=dtok.permute(0, 3, 1, 2): F.conv_transpose2d(d, w_nchw, padding=1),
                      "F.conv_transpose2d", TRAIN_REL * float(ref.abs().max())))
        for what, ref, exact, other, this, lib, lib_name, limit in cases:
            e_f32 = _err(ref[0], exact)
            errs = []
            for fn in (other, this):
                got = fn()
                diff = max(_err(u, v) for u, v in zip(got, ref))
                if not diff <= limit:
                    raise AssertionError(f"{what}: a build disagrees with the plain version "
                                         f"({diff:.3e} > {limit:.3e})")
                errs.append(_err(got[0], exact))
                same = all(torch.equal(u, v) for u, v in zip(got, fn()))
                if not same:
                    raise AssertionError(f"{what}: a build does not repeat bitwise")
                del got
            t = [device_ms(other), device_ms(this), device_ms(this), device_ms(other)]
            t_lib = device_ms(lib)
            print(f"{what}: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms, "
                  f"{lib_name} {t_lib:.4f} ms; max |out - float64|: other {errs[0]:.3e}, "
                  f"this {errs[1]:.3e}, f32 plain (TF32 off) {e_f32:.3e} "
                  f"(this / plain {errs[1] / max(e_f32, 1e-30):.3f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
