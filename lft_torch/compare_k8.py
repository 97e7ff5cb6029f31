"""Time this checkout's K8 kernels against another revision's, in turns in
one process, on one CUDA card.

    python3 -m lft_torch.compare_k8 OTHER_CSRC_DIR [--only-other]

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory, so
that its headers come with it): one whose K8 serves a pixel's (query, head)
pairs from up to five blocks that each stage all its key views, with an
online softmax key by key (the port at commit 56c8acd). Its C interfaces are
this checkout's: `lft_ang_attn_sweep(q, k, v, out, N, A2, C, heads, scale,
stream)`, `lft_ang_attn_sweep_res(q, k, v, out, m, l, ...)` and
`lft_ang_attn_sweep_bwd(q, k, v, dout, out, m, l, dq, dk, dv, N, A2, C,
heads, scale, stream)`, at every A2. Its `ang_attn_sweep.cu` and
`ang_attn.cu` are built with the port's nvcc flags into a temporary
directory; where its `attn.cuh` differs from this checkout's, so is every
other source of it that includes `attn.cuh`.

First the ptxas report of both builds: registers and spills of every kernel
of `ang_attn_sweep.cu` and of `ang_attn.cu` (K7's, which must match), and
K7's three outputs of both builds held bitwise equal at [4096, 25, 64]. Then,
on random q, k, v, dout, all three K8 forms at the shapes that run them:
`ang_attn_sweep` at [16384, 25, 64] (the `sweep` scene's chunk) and [9216,
144, 64] (the 12x12-view scene's), `_res` and `_bwd` at [4096, 25, 64] (the
`sweep` step's batch) and [2048, 144, 64] (the 12x12-view step's, batch 2),
all three at [1001, 169, 64]. Both builds against the plain version
(forwards within 1e-4 max(1, max |plain|), the backward within 5e-4 max
|plain| per output), each backward from its own forward's (out, m, l); this
build repeated bitwise; each output's max error against float64 (the
backward from the float64 forward's (out, m, l)) beside the f32 plain
version's (from its own). Both builds are timed in device time
(`profile_scene.device_ms`) in the order other, this, this, other, each
beside its bound (max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s): a forward 4 N
A2^2 C FLOP, a backward 10 N A2^2 C), and the forwards beside
`scaled_dot_product_attention` on the same heads. At [4096, 25, 64] this
build's backward launches K7's; the streamed backward of `ang_attn_sweep.cu`
is timed beside it in turns (K7, streamed, streamed, K7), and so are both
at A2 from 25 to 128 (~20.5 M pairs each: where K8's backward switches
from K7's kernel to its own, `ang_attn_vjp.K7_BWD_MAX`). With
`--only-other` only the other build is checked and timed (a parent's times
before a prediction). Prints the card's name and power limit first. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import filecmp
import os
import subprocess
import sys
import tempfile

import torch

from lft_torch.compare_bwd import _build_other, _err, _print_ptxas, _tuple
from lft_torch.compare_k7 import _attn_includers
from lft_torch.compare_k7 import _wrap_other as _wrap_other_k7

KERNEL_ATOL = 1e-4     # forwards: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # the backward: max |diff| <= 5e-4 max |plain|, per output
H = 8
FP32_FLOPS, HBM = 67e12, 3.35e12
CHUNK = 1024           # pixels a float64 reference takes at once


def _wrap_other(lib):
    """(fwd, bwd) of the other revision's K8, with this checkout's wrappers'
    arguments and outputs."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lft_ang_attn_sweep.argtypes = [P] * 4 + [I] * 4 + [F, P]
    lib.lft_ang_attn_sweep_res.argtypes = [P] * 6 + [I] * 4 + [F, P]
    lib.lft_ang_attn_sweep_bwd.argtypes = [P] * 10 + [I] * 4 + [F, P]

    def tail(q):
        N, A2, C = q.shape
        return N, A2, C, H, float(C // H) ** -0.5, torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def fwd(q, k, v, with_stats=False):
        out = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if not with_stats:
            check(lib.lft_ang_attn_sweep(*ptrs, *tail(q)), "ang_attn_sweep")
            return out
        m = torch.empty(*q.shape[:2], H, device=q.device)
        l = torch.empty_like(m)
        check(lib.lft_ang_attn_sweep_res(*ptrs, m.data_ptr(), l.data_ptr(), *tail(q)),
              "ang_attn_sweep_res")
        return out, m, l

    def bwd(q, k, v, out, m, l, dout):
        outs = tuple(torch.empty_like(q) for _ in range(3))
        check(lib.lft_ang_attn_sweep_bwd(*(t.data_ptr() for t in (q, k, v, dout, out, m, l,
                                                                  *outs)), *tail(q)),
              "ang_attn_sweep_bwd")
        return outs

    return fwd, bwd


def _by_pixels(fn, *ts):
    """fn over slices of CHUNK pixels, the outputs concatenated (a float64
    reference at a scene's size)."""
    parts = [_tuple(fn(*(t[i:i + CHUNK] for t in ts))) for i in range(0, ts[0].shape[0], CHUNK)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _bound(flops, nbytes):
    t_ops, t_mem = flops / FP32_FLOPS * 1e3, nbytes / HBM * 1e3
    return f"bound {max(t_ops, t_mem):.4f} ms ({'operations' if t_ops >= t_mem else 'bytes'})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", help="the other revision's lft_torch/csrc directory")
    ap.add_argument("--only-other", action="store_true",
                    help="check and time the other build alone")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k8: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.kernels import ang_attn_vjp as av
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(0)
    only = a.only_other
    with tempfile.TemporaryDirectory() as tmp:
        other, log = _build_other(os.path.join(a.other_csrc, "ang_attn_sweep.cu"), tmp,
                                  "other_ang_attn_sweep")
        o_fwd, o_bwd = _wrap_other(other)
        if not only:
            paths = _build.build_all()
            read = lambda n: open(paths[n] + ".log").read()
            _print_ptxas("ang_attn_sweep.cu", log, read("ang_attn_sweep"))
            k7, log7 = _build_other(os.path.join(a.other_csrc, "ang_attn.cu"), tmp,
                                    "other_ang_attn")
            _print_ptxas("ang_attn.cu", log7, read("ang_attn"))
            if filecmp.cmp(os.path.join(a.other_csrc, "attn.cuh"),
                           os.path.join(_build.SRC_DIR, "attn.cuh"), shallow=False):
                print("attn.cuh: the same in both revisions; no other source rebuilt", flush=True)
            else:
                for n in _attn_includers(a.other_csrc):
                    if n != "ang_attn_sweep":
                        _print_ptxas(f"{n}.cu", _build_other(os.path.join(a.other_csrc, f"{n}.cu"),
                                                             tmp, f"other_{n}")[1], read(n))
            # K7's outputs, both builds
            k7_fwd, k7_bwd = _wrap_other_k7(k7)
            q, k, v, dout = (torch.randn(4096, 25, 64, device=dev, generator=g) for _ in range(4))
            res_o, res_t = k7_fwd(q, k, v, True), am.ang_attn_fwd(q, k, v, H, True)
            same = torch.equal(k7_fwd(q, k, v), am.ang_attn_fwd(q, k, v, H))
            same &= all(torch.equal(x, y) for x, y in zip(res_o, res_t))
            same &= all(torch.equal(x, y) for x, y in zip(
                k7_bwd(q, k, v, *res_o[1:], dout), am.ang_attn_bwd(q, k, v, *res_t[1:], dout, H)))
            print(f"K7 (ang_attn.cu) at [4096, 25, 64]: ang_attn, ang_attn_res and ang_attn_bwd "
                  f"of both builds bitwise equal: {same}", flush=True)
            if not same:
                raise AssertionError("K7's outputs differ between the builds")
            del q, k, v, dout, res_o, res_t

        for N, A2, forms in ((16384, 25, ("fwd",)), (4096, 25, ("res", "bwd")),
                             (9216, 144, ("fwd",)), (2048, 144, ("res", "bwd")),
                             (1001, 169, ("fwd", "res", "bwd"))):
            shape = [N, A2, 64]
            q, k, v, dout = (torch.randn(*shape, device=dev, generator=g) for _ in range(4))
            ref = av.ang_attention_sweep_plain(q, k, v, H)
            res_o = o_fwd(q, k, v, True)
            res_t = None if only else av.ang_attn_sweep_fwd(q, k, v, H, True)
            ref_b = (av.ang_attention_sweep_bwd_plain(q, k, v, *ref, dout, H)
                     if "bwd" in forms else None)
            x64 = [t.double() for t in (q, k, v, dout)]
            e_fwd = _by_pixels(lambda *t: am.ang_attention_blockdiag_plain(*t, H), *x64[:3])
            e_bwd = (_by_pixels(lambda *t: av.ang_attention_sweep_bwd_plain(*t[:3], *t[4:], t[3],
                                                                            H), *x64, *e_fwd)
                     if "bwd" in forms else None)
            del x64
            heads = lambda t: t.reshape(N, A2, H, 8).transpose(1, 2)
            qh, kh, vh = heads(q), heads(k), heads(v)
            fl = 4 * N * A2 * A2 * 64
            io = 4 * q.numel() * 4
            cases = {
                "fwd": ("K8 ang_attn_sweep", ref[:1], lambda: o_fwd(q, k, v),
                        lambda: av.ang_attn_sweep_fwd(q, k, v, H), ("out",), KERNEL_ATOL,
                        e_fwd[:1], _bound(fl, io)),
                "res": ("K8 ang_attn_sweep_res", ref, lambda: o_fwd(q, k, v, True),
                        lambda: av.ang_attn_sweep_fwd(q, k, v, H, True), ("out", "m", "l"),
                        KERNEL_ATOL, e_fwd, _bound(fl, io + 2 * ref[1].numel() * 4)),
                "bwd": ("K8 ang_attn_sweep_bwd", ref_b, lambda: o_bwd(q, k, v, *res_o, dout),
                        lambda: av.ang_attn_sweep_bwd(q, k, v, *res_t, dout, H),
                        ("dq", "dk", "dv"), TRAIN_REL, e_bwd,
                        _bound(2.5 * fl, 2 * io + 2 * ref[1].numel() * 4))}
            for form in forms:
                what, want, fo, ft, names, tol, ex, bound = cases[form]
                errs = []
                for who, fn in (("other", fo),) + (() if only else (("this", ft),)):
                    got = _tuple(fn())
                    for n, u, r in zip(names, got, want):
                        lim = (tol * max(1.0, float(r.abs().max())) if tol == KERNEL_ATOL
                               else tol * float(r.abs().max()))
                        if not u.shape == r.shape or not _err(u, r) <= lim:
                            raise AssertionError(f"{what} {shape}: {who} disagrees with the "
                                                 f"plain version at {n} ({_err(u, r):.3e} > "
                                                 f"{lim:.3e})")
                    errs.append([_err(u, e) for u, e in zip(got, ex)])
                    del got
                e_f32 = [_err(r, e) for r, e in zip(want, ex)]
                lib = ""
                if form == "fwd":
                    lib = (f"; SDPA {device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)):.4f}"
                           f" ms")
                if only:
                    tm = [device_ms(fo), device_ms(fo)]
                    print(f"{what} {shape}: other {tm[0]:.4f} / {tm[1]:.4f} ms (device time), "
                          f"{bound}{lib}; max |out - float64|: "
                          + "; ".join(f"{n} other {eo:.3e}, f32 plain {ep:.3e}"
                                      for n, eo, ep in zip(names, errs[0], e_f32)), flush=True)
                    continue
                if not all(torch.equal(u, r) for u, r in zip(_tuple(ft()), _tuple(ft()))):
                    raise AssertionError(f"{what} {shape}: this build does not repeat bitwise")
                tm = [device_ms(fo), device_ms(ft), device_ms(ft), device_ms(fo)]
                print(f"{what} {shape}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / "
                      f"{tm[2]:.4f} ms (device time), {bound}{lib}; this repeats bitwise; "
                      "max |out - float64|: "
                      + "; ".join(f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} (this "
                                  f"/ plain {et / max(ep, 1e-30):.3f}x)"
                                  for n, eo, et, ep in zip(names, errs[0], errs[1], e_f32)),
                      flush=True)
                if form == "bwd" and A2 <= av.K7_BWD_MAX:
                    k7b = lambda: am.ang_attn_bwd(q, k, v, *res_t[1:], dout, H)
                    sw = lambda: av.sweep_bwd_launch(q, k, v, *res_t, dout, H)
                    got = sw()
                    for n, u, r in zip(names, got, want):
                        if not _err(u, r) <= TRAIN_REL * float(r.abs().max()):
                            raise AssertionError(f"streamed backward {shape} disagrees at {n}")
                    e_sw = [_err(u, e) for u, e in zip(got, ex)]
                    tb = [device_ms(k7b), device_ms(sw), device_ms(sw), device_ms(k7b)]
                    print(f"  at {shape} this build's backward is K7's ang_attn_bwd: {tb[0]:.4f} "
                          f"/ {tb[3]:.4f} ms; the streamed backward {tb[1]:.4f} / {tb[2]:.4f} ms "
                          f"(device time, in turns); streamed max |out - float64|: "
                          + "; ".join(f"{n} {e:.3e}" for n, e in zip(names, e_sw)), flush=True)
            del q, k, v, dout, ref, ref_b, res_o, res_t, e_fwd, e_bwd, cases, qh, kh, vh
            torch.cuda.empty_cache()
    if not only:
        # where K8's backward should stop launching K7's: both at K7's view
        # counts, ~20.5 M (query, key, head) pairs each, in turns
        for A2 in (25, 32, 33, 49, 64, 65, 81, 100, 128):
            N = round(4096 * 625 / (A2 * A2))
            q, k, v, dout = (torch.randn(N, A2, 64, device=dev, generator=g) for _ in range(4))
            res = av.ang_attn_sweep_fwd(q, k, v, H, True)
            k7b = lambda: am.ang_attn_bwd(q, k, v, *res[1:], dout, H)
            sw = lambda: av.sweep_bwd_launch(q, k, v, *res, dout, H)
            ref_b = av.ang_attention_sweep_bwd_plain(q, k, v, *res, dout, H)
            for n, u, r in zip(("dq", "dk", "dv"), sw(), ref_b):
                if not _err(u, r) <= TRAIN_REL * float(r.abs().max()):
                    raise AssertionError(f"streamed backward {[N, A2, 64]} disagrees at {n}")
            tb = [device_ms(k7b), device_ms(sw), device_ms(sw), device_ms(k7b)]
            print(f"backward at {[N, A2, 64]}: K7's ang_attn_bwd {tb[0]:.4f} / {tb[3]:.4f} ms, "
                  f"the streamed backward {tb[1]:.4f} / {tb[2]:.4f} ms (device time, in turns)",
                  flush=True)
            del q, k, v, dout, res, ref_b
    return 0


if __name__ == "__main__":
    sys.exit(main())
