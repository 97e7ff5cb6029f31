"""Time this checkout's `--dtype bfloat16` kernels against another
revision's, in turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_bf16io OTHER_CSRC_DIR

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory, so
that its headers come with it) whose `ang_block.cu`, `spa_block.cu`,
`ang_attn.cu`, `ang_attn_sweep.cu` and `spa_attn_hp.cu` have the same
`_bf16io` C interfaces as this checkout's. Both are built with the port's
nvcc flags into a temporary directory, and the port's own wrappers launch
either build (the other's libraries stand in for this checkout's while it
runs). On the main path's shapes (K1 [16384, 25, 64], K2 [400, 32, 32, 64],
the demo checkpoint's block-0 weights in bf16, each K2 step fed its plain
predecessor's output), each of the six fused `_bf16io` kernels, and on the
per-op train step's shapes (K7, K8 [4096, 25, 64], K5, K6, K9 [100, 32, 32,
128]) the ten `_res_bf16io` forms and `_bwd_bf16io` backwards of the per-op
branch (each backward fed its plain `_res` form's out, m, l), of the two
builds must agree bit for bit, and both are timed in device time
(`profile_scene.device_ms`) in the order other, this, this, other; a kernel
whose entry the other build lacks is timed in this build alone. Prints the
card's name and power limit first. Exits non-zero without a card, or if
the two builds' outputs differ.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def other_libraries(libs: dict):
    """The port's wrappers launch `libs` ({source name: CDLL}) while inside."""
    from lft_torch.kernels import _build
    saved = {n: _build._libs.get(n) for n in libs}
    for lib in libs.values():
        lib.lft_error_string.argtypes = [ctypes.c_int]
        lib.lft_error_string.restype = ctypes.c_char_p
    _build._libs.update(libs)
    try:
        yield
    finally:
        for n, lib in saved.items():
            if lib is None:
                _build._libs.pop(n, None)
            else:
                _build._libs[n] = lib


def cases(dev):
    """[(name, fn)]: each `_bf16io` kernel's wrapper call on the main path's
    shapes, its inputs made once."""
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.utils.checkpoint import load_checkpoint

    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
    g = torch.Generator(device=dev).manual_seed(0)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    N, V = 16 * h * w, 16 * A2
    wa = ab.ang_weights(pb, "altblock.0.ang_trans.")
    ws = sb.spa_weights(pb, "altblock.0.spa_trans.")
    x = torch.randn(N, A2, C, device=dev, generator=g).to(torch.bfloat16)
    pe = torch.from_numpy(angular_position(A2, C)).to(dev)
    xs = torch.randn(V, h, w, C, device=dev, generator=g).to(torch.bfloat16)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)
                              .to(torch.bfloat16)[None], ws["mlp"])[0].contiguous()
    tok, xn = sb.tokenize_ln_plain(xs, pe_tok, ws)
    q, k, v = sb.qkv_plain(xn, tok, ws)
    attn = sb.window_attn_plain(q, k, v, H, K)[0]
    x2, xn2 = sb.outproj_ln_plain(attn, tok, ws)
    return [("ang_block_bf16io", lambda: ab.ang_block(x, pe, wa, H)),
            ("spa_tokenize_ln_bf16io", lambda: sb.tokenize_ln(xs, pe_tok, ws)),
            ("spa_qkv_bf16io", lambda: sb.qkv(xn, tok, ws)),
            ("spa_window_attn_bf16io", lambda: sb.window_attn(q, k, v, H, K)),
            ("spa_outproj_ln_bf16io", lambda: sb.outproj_ln(attn, tok, ws)),
            ("spa_ffn_out_bf16io", lambda: sb.ffn_out(xn2, x2, ws))] + perop_train_cases(dev, g)


def perop_train_cases(dev, g):
    """[(name, fn)]: the per-op branch's ten `_res_bf16io` forms and
    `_bwd_bf16io` backwards on the train step's shapes."""
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.kernels import ang_attn_vjp as av
    from lft_torch.kernels import local_attn_vjp as lv
    from lft_torch.kernels import spa_attn as sa
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels.common import plain_versions

    H, K = 8, 5
    fams = [
        ("ang_attn", (4096, 25, 64), lambda q, k, v: am.ang_attn_fwd(q, k, v, H, True),
         lambda q, k, v, o, m, l, d: am.ang_attn_bwd(q, k, v, m, l, d, H)),
        ("ang_attn_sweep", (4096, 25, 64), lambda q, k, v: av.ang_attn_sweep_fwd(q, k, v, H, True),
         lambda q, k, v, o, m, l, d: av.ang_attn_sweep_bwd(q, k, v, o, m, l, d, H)),
        ("spa_attn_hp", (100, 32, 32, 128), lambda q, k, v: hp.spa_attn_hp_fwd(q, k, v, H, K, True),
         lambda q, k, v, o, m, l, d: hp.spa_attn_hp_bwd(q, k, v, m, l, d, H, K)),
        ("spa_attn_mxu", (100, 32, 32, 128),
         lambda q, k, v: sa.spa_attn_mxu_fwd(q, k, v, H, K, True),
         lambda q, k, v, o, m, l, d: sa.spa_attn_mxu_bwd(q, k, v, m, l, d, H, K)),
        ("spa_attn_offset", (100, 32, 32, 128),
         lambda q, k, v: lv.spa_attn_offset_fwd(q, k, v, H, K, True),
         lambda q, k, v, o, m, l, d: lv.spa_attn_offset_bwd(q, k, v, o, m, l, d, H, K)),
    ]
    out = []
    for base, shape, res_fn, bwd_fn in fams:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)
                         for _ in range(4))
        with plain_versions():
            res = res_fn(q, k, v)
        out += [(base + "_res_bf16io", lambda f=res_fn, a=(q, k, v): f(*a)),
                (base + "_bwd_bf16io", lambda f=bwd_fn, a=(q, k, v, *res, dout): f(*a))]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_bf16io: no CUDA device is available", file=sys.stderr)
        return 1
    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    _build.build_all()
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        other = {n: _build.build_library(os.path.join(a.other_csrc, f"{n}.cu"), tmp, n)
                 for n in ("ang_block", "spa_block", "ang_attn", "ang_attn_sweep", "spa_attn_hp")}
        for name, fn in cases(dev):
            got = fn()
            try:
                with other_libraries(other):
                    ref = fn()
            except AttributeError as e:      # an entry the other build does not have
                t1, t2 = device_ms(fn), device_ms(fn)
                print(f"{name}: the other build has no such entry ({e}); this {t1:.4f} / "
                      f"{t2:.4f} ms", flush=True)
                continue
            got, ref = (t if isinstance(t, tuple) else (t,) for t in (got, ref))
            same = all(torch.equal(x, y) for x, y in zip(got, ref))
            differ += not same
            with other_libraries(other):
                t0 = device_ms(fn)
            t1, t2 = device_ms(fn), device_ms(fn)
            with other_libraries(other):
                t3 = device_ms(fn)
            print(f"{name}: other {t0:.4f} / {t3:.4f} ms, this {t1:.4f} / {t2:.4f} ms (this / "
                  f"other {(t1 + t2) / (t0 + t3):.3f}); outputs bitwise equal: {same}",
                  flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
