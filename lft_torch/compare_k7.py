"""Time this checkout's K7 kernels against another revision's, in turns in
one process, on one CUDA card.

    python3 -m lft_torch.compare_k7 OTHER_CSRC_DIR

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory, so
that its headers come with it): one whose K7 takes one (pixel, head,
query) a thread with an online softmax key by key, and rebuilds each score
three times in its backward (the port at commit 4bda1cd). Its C interfaces
are this checkout's: `lft_ang_attn(q, k, v, out, N, A2, C, heads, scale,
stream)`, `lft_ang_attn_res(q, k, v, out, m, l, N, A2, C, heads, scale,
stream)` and `lft_ang_attn_bwd(q, k, v, dout, m, l, dq, dk, dv, N, A2, C,
heads, scale, stream)`. Its `ang_attn.cu` is built with the port's nvcc
flags into a temporary directory; where its `attn.cuh` differs from this
checkout's, so is every other source of it that includes `attn.cuh`.

First the ptxas report of both builds: registers and spills of every
kernel of `ang_attn.cu` (and, where `attn.cuh` differs, of every kernel of
the sources that include it, which must match where they did not change).
Then, on random q, k, v, dout: `ang_attn` at [16384, 25, 64] (a scene's
chunk), `ang_attn_res` and `ang_attn_bwd` at [4096, 25, 64] and [1024, 81,
64] (a train step's batch at 5x5 and 9x9 views). Both builds against the
plain version (forwards within 1e-4 max(1, max |plain|), the backward
within 5e-4 max |plain| per output), each backward from its own forward's
(m, l); this build repeated bitwise; each output's max error against
float64 (the backward from the float64 forward's (m, l)) beside the f32
plain version's (from its own). Both builds are timed in device time
(`profile_scene.device_ms`) in the order other, this, this, other. Prints
the card's name and power limit first. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import filecmp
import os
import re
import subprocess
import sys
import tempfile

import torch

from lft_torch.compare_bwd import _build_other, _err, _print_ptxas, _tuple

KERNEL_ATOL = 1e-4     # forwards: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # the backward: max |diff| <= 5e-4 max |plain|, per output
H = 8


def _wrap_other(lib):
    """(fwd, bwd) of the other revision's K7, with this checkout's wrappers'
    arguments and outputs."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lft_ang_attn.argtypes = [P] * 4 + [I] * 4 + [F, P]
    lib.lft_ang_attn_res.argtypes = [P] * 6 + [I] * 4 + [F, P]
    lib.lft_ang_attn_bwd.argtypes = [P] * 9 + [I] * 4 + [F, P]

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
            check(lib.lft_ang_attn(*ptrs, *tail(q)), "ang_attn")
            return out
        m = torch.empty(*q.shape[:2], H, device=q.device)
        l = torch.empty_like(m)
        check(lib.lft_ang_attn_res(*ptrs, m.data_ptr(), l.data_ptr(), *tail(q)), "ang_attn_res")
        return out, m, l

    def bwd(q, k, v, m, l, dout):
        outs = tuple(torch.empty_like(q) for _ in range(3))
        check(lib.lft_ang_attn_bwd(*(t.data_ptr() for t in (q, k, v, dout, m, l, *outs)),
                                   *tail(q)), "ang_attn_bwd")
        return outs

    return fwd, bwd


def _attn_includers(csrc: str) -> list:
    """The sources of a csrc directory that include attn.cuh, but for
    ang_attn.cu."""
    return sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu") and f != "ang_attn.cu"
                  and re.search(r'#include "attn\.cuh"', open(os.path.join(csrc, f)).read()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", help="the other revision's lft_torch/csrc directory")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k7: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    paths = _build.build_all()
    read = lambda n: open(paths[n] + ".log").read()
    g = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        other, log = _build_other(os.path.join(a.other_csrc, "ang_attn.cu"), tmp, "other_ang_attn")
        _print_ptxas("ang_attn.cu", log, read("ang_attn"))
        if filecmp.cmp(os.path.join(a.other_csrc, "attn.cuh"),
                       os.path.join(_build.SRC_DIR, "attn.cuh"), shallow=False):
            print("attn.cuh: the same in both revisions; no other source rebuilt", flush=True)
        else:
            for n in _attn_includers(a.other_csrc):
                _print_ptxas(f"{n}.cu", _build_other(os.path.join(a.other_csrc, f"{n}.cu"), tmp,
                                                     f"other_{n}")[1], read(n))
        o_fwd, o_bwd = _wrap_other(other)

        for N, A2, forms in ((16384, 25, ("fwd",)), (4096, 25, ("res", "bwd")),
                             (1024, 81, ("res", "bwd"))):
            shape = [N, A2, 64]
            q, k, v, dout = (torch.randn(*shape, device=dev, generator=g) for _ in range(4))
            ref = am.ang_attention_blockdiag_plain(q, k, v, H)
            res_o, res_t = o_fwd(q, k, v, True)[1:], am.ang_attn_fwd(q, k, v, H, True)[1:]
            ref_b = am.ang_attention_blockdiag_bwd_plain(q, k, v, *ref[1:], dout, H)
            x64 = [t.double() for t in (q, k, v, dout)]
            e_fwd = am.ang_attention_blockdiag_plain(*x64[:3], H)
            e_bwd = (am.ang_attention_blockdiag_bwd_plain(*x64[:3], *e_fwd[1:], x64[3], H)
                     if "bwd" in forms else None)
            del x64
            cases = {
                "fwd": ("K7 ang_attn", ref[:1], lambda: o_fwd(q, k, v),
                        lambda: am.ang_attn_fwd(q, k, v, H), ("out",), KERNEL_ATOL, e_fwd[:1]),
                "res": ("K7 ang_attn_res", ref, lambda: o_fwd(q, k, v, True),
                        lambda: am.ang_attn_fwd(q, k, v, H, True), ("out", "m", "l"),
                        KERNEL_ATOL, e_fwd),
                "bwd": ("K7 ang_attn_bwd", ref_b, lambda: o_bwd(q, k, v, *res_o, dout),
                        lambda: am.ang_attn_bwd(q, k, v, *res_t, dout, H), ("dq", "dk", "dv"),
                        TRAIN_REL, e_bwd)}
            for form in forms:
                what, want, fo, ft, names, tol, ex = cases[form]
                errs = []
                for who, fn in (("other", fo), ("this", ft)):
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
                if not all(torch.equal(u, r) for u, r in zip(_tuple(ft()), _tuple(ft()))):
                    raise AssertionError(f"{what} {shape}: this build does not repeat bitwise")
                tm = [device_ms(fo), device_ms(ft), device_ms(ft), device_ms(fo)]
                e_f32 = [_err(r, e) for r, e in zip(want, ex)]
                print(f"{what} {shape}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / "
                      f"{tm[2]:.4f} ms (device time); this repeats bitwise; max |out - float64|: "
                      + "; ".join(f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} (this "
                                  f"/ plain {et / max(ep, 1e-30):.3f}x)"
                                  for n, eo, et, ep in zip(names, errs[0], errs[1], e_f32)),
                      flush=True)
            del q, k, v, dout, ref, ref_b, res_o, res_t, e_fwd, e_bwd, cases
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
