"""Time this checkout's `--dtype bfloat16` kernels against another
revision's, in turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_bf16io OTHER_CSRC_DIR

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory, so
that its headers come with it), or is another checkout's built
`lft_torch/build` (its libraries are loaded as they are), whose
`ang_block.cu`, `spa_block.cu`, `ang_attn.cu`, `ang_attn_sweep.cu` and
`spa_attn_hp.cu` have the same
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

    python3 -m lft_torch.compare_bf16io OTHER_CSRC_DIR --redesigned NAMES [--only NAMES]

`--redesigned` (comma-separated launch names) holds a kernel that this
checkout redesigned, whose sums run in another order than the other
build's, to its plain version instead of to the other build: each output
(both builds') within 1/10 of the plain bf16-vs-f32 distance (L2) and 1
bf16 ulp of max |plain| (chip_smoke.py's BF16_GAP, BF16_ULPS), and its
first output's max error against float64 (the f32 plain attention on the
same bf16 values in float64) printed beside the plain version's; the times
in the same turns. The four window forms K2.3 `spa_window_attn_bf16io`
[400, 32, 32, 128] and `spa_window_attn_res_bf16io` [100, 32, 32, 128],
K5 `spa_attn_hp_bf16io` [400, 32, 32, 128] and `spa_attn_hp_res_bf16io`
[100, 32, 32, 128] (one kernel, `csrc/window_mma.cuh`) have such
references, and so do K1 `ang_block_bf16io` [16384, 25, 64] and
`ang_block_res_bf16io` [4096, 25, 64] (`csrc/ang_bf16.cuh`; the `_res`
form's out, attn, m and l each within 1/10 of its plain bf16-vs-f32
distance, out within 1 bf16 ulp and attn 4 (chip_smoke.py's BF16T_ULPS);
float64: the f32 block on the same bf16 values) and K2.5
`spa_ffn_out_bf16io` [400, 32, 32, 64] and K11.5 `spa_ffn_out_pm_bf16io`
[16, 32, 32, 25, 64] (`csrc/ffn_bf16.cuh`; float64: the f32 step on the
same values): `REDESIGNED`. `--only` times those launch names alone.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import math
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def other_libraries(libs: dict):
    """The port's wrappers launch `libs` ({source name: CDLL}) while inside.
    Their scratch for the weights is the larger, split stream's size for
    every instance: an older build's `_bf16io` and `_bf16` entries (K1, K2.5,
    K2.1 and K11.1) prepare that stream where this one's keep a bf16 copy;
    and K2.1's and K11.1's bf16 forms take `tok_tile`'s tiles, as the older
    build's `tap_conv_kernel` instances did (K1 `_sites`'s scratch here is
    larger than an older build's)."""
    from unittest import mock

    from lft_torch.kernels import _build
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels.rowgemm import ang_block_floats, ffn_out_floats
    saved = {n: _build._libs.get(n) for n in libs}
    for lib in libs.values():
        lib.lft_error_string.argtypes = [ctypes.c_int]
        lib.lft_error_string.restype = ctypes.c_char_p
    _build._libs.update(libs)
    try:
        with mock.patch.object(ab, "ang_bf16_floats", ang_block_floats), \
                mock.patch.object(sb, "ffn_out_bf16_floats", ffn_out_floats), \
                mock.patch.object(sb, "tok_bf16_floats", lambda C: 36 * C * C), \
                mock.patch.object(sb, "tok_bf16_tile", sb.tok_tile):
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
    from lft_torch.kernels import spa_attn_hp as hp
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
    qr, kr, vr = (torch.randn(100, h, w, 2 * C, device=dev, generator=g).to(torch.bfloat16)
                  for _ in range(3))
    xr = torch.randn(4096, A2, C, device=dev, generator=g).to(torch.bfloat16)
    return [("ang_block_bf16io", lambda: ab.ang_block(x, pe, wa, H)),
            ("ang_block_res_bf16io", lambda: ab.ang_block(xr, pe, wa, H, with_res=True)),
            ("spa_tokenize_ln_bf16io", lambda: sb.tokenize_ln(xs, pe_tok, ws)),
            ("spa_qkv_bf16io", lambda: sb.qkv(xn, tok, ws)),
            ("spa_window_attn_bf16io", lambda: sb.window_attn(q, k, v, H, K)),
            ("spa_window_attn_res_bf16io",
             lambda: sb.window_attn(qr, kr, vr, H, K, with_stats=True)),
            ("spa_attn_hp_bf16io", lambda: hp.spa_attn_hp_fwd(q, k, v, H, K)),
            ("spa_outproj_ln_bf16io", lambda: sb.outproj_ln(attn, tok, ws)),
            ("spa_ffn_out_bf16io", lambda: sb.ffn_out(xn2, x2, ws)),
            ("spa_ffn_out_pm_bf16io", lambda: sb.ffn_out(xn2, x2, ws, A2))] + perop_train_cases(dev, g)


def window_refs(fn):
    """(plain, plain on f32 values, float64) of a window form's call `fn`
    (`--redesigned`): the same call on the plain versions."""
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels.common import plain_versions

    calls = []
    real = sb.window_attn, hp.spa_attn_hp_fwd

    def grab(q, k, v, *a, **kw):
        calls.append((q, k, v, kw.get("with_stats", len(a) > 2 and a[2])))
        return None
    sb.window_attn = hp.spa_attn_hp_fwd = grab
    try:
        fn()
    finally:
        sb.window_attn, hp.spa_attn_hp_fwd = real
    (q, k, v, stats), = calls
    with plain_versions():
        plain = sb.window_attn_plain(q, k, v, 8, 5)
        plain32 = sb.window_attn_plain(q.float(), k.float(), v.float(), 8, 5)
    exact = hp.windowed_attention_headpacked_plain(q.double(), k.double(), v.double(), 8, 5)[0]
    pick = (lambda r: r) if stats else (lambda r: (r[0],))
    return pick(plain), pick(plain32), exact


def _grab(module, name: str, fn):
    """The arguments of the one call `fn()` makes to `module.name`."""
    calls = []
    real = getattr(module, name)
    setattr(module, name, lambda *a, **kw: calls.append((a, kw)))
    try:
        fn()
    finally:
        setattr(module, name, real)
    (args, kw), = calls
    return args, kw


def block_refs(name: str, fn):
    """(plain, plain on f32 values, float64 of the first output) of a K1 or
    K2.5 bf16-IO call `fn` (`--redesigned`): the same call on the plain
    versions, float64 the f32 function on the same bf16 values."""
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb

    f32 = lambda w: {k: v.float() for k, v in w.items()}
    f64 = lambda w: {k: v.double() for k, v in w.items()}
    if name.startswith("ang_block"):
        (x, pe, wa, H), kw = _grab(ab, "ang_block", fn)
        res = kw.get("with_res", False)
        tup = (lambda r: r) if res else (lambda r: (r,))
        return (tup(ab.ang_block_plain(x, pe, wa, H, res)),
                tup(ab.ang_block_plain(x.float(), pe, f32(wa), H, res)),
                ab.ang_block_plain(x.double(), pe.double(), f64(wa), H))
    (xn2, x2, ws, *views), _ = _grab(sb, "ffn_out", fn)
    pm = (lambda t: sb._to_pixel_major(t, views[0])) if views else (lambda t: t)
    return ((pm(sb.ffn_out_plain(xn2, x2, ws)),),
            (pm(sb.ffn_out_plain(xn2.float(), x2.float(), f32(ws))),),
            pm(sb.ffn_out_plain(xn2.double(), x2.double(), f64(ws))))


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


WINDOW_FORMS = ("spa_window_attn_bf16io", "spa_window_attn_res_bf16io", "spa_attn_hp_bf16io",
                "spa_attn_hp_res_bf16io")
BLOCK_FORMS = ("ang_block_bf16io", "ang_block_res_bf16io", "spa_ffn_out_bf16io",
               "spa_ffn_out_pm_bf16io")
REDESIGNED = WINDOW_FORMS + BLOCK_FORMS
BF16T_ULPS = 4.0   # chip_smoke.py: a training form's bf16 residual


def _bf16_dist(got, ref, ref32):
    """[(L2 from the plain version as a share of its bf16-vs-f32 distance,
    max |diff| in bf16 ulps of max |plain|)] an output."""
    out = []
    for a, r, r32 in zip(got, ref, ref32):
        a, r, r32 = a.double(), r.double(), r32.double()
        gap = float((r32 - r).norm() / r.norm())
        ulp = 2.0 ** (math.floor(math.log2(float(r.abs().max()))) - 7)
        out.append((float((a - r).norm() / r.norm()) / gap, float((a - r).abs().max()) / ulp))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc")
    ap.add_argument("--redesigned", default="",
                    help="launch names held to their plain versions, not to the other build")
    ap.add_argument("--only", default="", help="time these launch names alone")
    a = ap.parse_args(argv)
    redesigned = set(filter(None, a.redesigned.split(",")))
    only = set(filter(None, a.only.split(",")))
    if redesigned - set(REDESIGNED):
        ap.error(f"--redesigned takes {', '.join(REDESIGNED)}")
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
        names = ("ang_block", "spa_block", "ang_attn", "ang_attn_sweep", "spa_attn_hp")
        built = {f[3:].rsplit("_", 1)[0]: f for f in os.listdir(a.other_csrc)
                 if f.startswith("lib") and f.endswith(".so")}
        other = {n: ctypes.CDLL(os.path.join(a.other_csrc, built[n])) if built else
                 _build.build_library(os.path.join(a.other_csrc, f"{n}.cu"), tmp, n)
                 for n in names}
        for name, fn in cases(dev):
            if only and name not in only:
                continue
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
            if name in redesigned and name in BLOCK_FORMS:
                plain, plain32, exact = block_refs(name, fn)
                dist = [_bf16_dist(t, plain, plain32) for t in (ref, got)]
                # out within 1 ulp; a `_res` form's attn within BF16T_ULPS, m and l by L2 alone
                ulps = [1.0, math.inf, math.inf, BF16T_ULPS]
                ok = all(d <= 0.1 and u <= ulps[i] for t in dist for i, (d, u) in enumerate(t))
                err = [float((t[0].double() - exact).abs().max()) for t in (ref, got, plain)]
                again = fn()
                same = all(torch.equal(x, y) for x, y in
                           zip(got, again if isinstance(again, tuple) else (again,)))
                differ += not (ok and same)
                verdict = ("per output L2 from the plain version as a share of its bf16-vs-f32 "
                           "distance (limit 0.1) and max |diff| in bf16 ulps of max |plain| "
                           "(out 1, attn 4): other " + ", ".join(f"{d:.4f} / {u:.2f}"
                                                                 for d, u in dist[0])
                           + "; this " + ", ".join(f"{d:.4f} / {u:.2f}" for d, u in dist[1])
                           + f"; max |out - float64| other {err[0]:.3e}, this {err[1]:.3e}, "
                           f"plain {err[2]:.3e}; repeats bitwise: {same}")
            elif name in redesigned:
                plain, plain32, exact = window_refs(fn)
                dist = [_bf16_dist(t[:1], plain[:1], plain32[:1])[0] for t in (ref, got)]
                # m and l (the `_res` forms) against the plain version's
                stat = [max((float(((x.double() - y.double()).abs()
                                    / (y.double().abs() + 0.1)).max())
                             for x, y in zip(t[1:], plain[1:])), default=0.0) for t in (ref, got)]
                ok = all(d <= 0.1 and u <= 1.0 for d, u in dist) and max(stat) <= 1e-4
                err = [float((t[0].double() - exact).abs().max()) for t in (ref, got, plain)]
                again = fn()
                same = all(torch.equal(x, y) for x, y in
                           zip(got, again if isinstance(again, tuple) else (again,)))
                differ += not (ok and same)
                verdict = (f"attn: L2 from the plain version as a share of its bf16-vs-f32 "
                           f"distance other {dist[0][0]:.4f}, this {dist[1][0]:.4f} (limit 0.1), "
                           f"max |diff| other {dist[0][1]:.2f}, this {dist[1][1]:.2f} bf16 ulps "
                           f"of max |plain| (limit 1); max |attn - float64| other "
                           f"{err[0]:.3e}, this {err[1]:.3e}, plain {err[2]:.3e}; m, l max "
                           f"relative from the plain version's other {stat[0]:.2e}, this "
                           f"{stat[1]:.2e} (limit 1e-4, 1e-5 absolute near 0); repeats bitwise: {same}")
            else:
                same = all(torch.equal(x, y) for x, y in zip(got, ref))
                differ += not same
                verdict = f"outputs bitwise equal: {same}"
            with other_libraries(other):
                t0 = device_ms(fn)
            t1, t2 = device_ms(fn), device_ms(fn)
            with other_libraries(other):
                t3 = device_ms(fn)
            print(f"{name}: other {t0:.4f} / {t3:.4f} ms, this {t1:.4f} / {t2:.4f} ms (this / "
                  f"other {(t1 + t2) / (t0 + t3):.3f}); {verdict}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
