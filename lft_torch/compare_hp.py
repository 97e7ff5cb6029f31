"""Time this checkout's K5 kernels against another revision's, in turns in
one process, on one CUDA card.

    python3 -m lft_torch.compare_hp OTHER_CSRC_DIR

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory,
so that its headers come with it): one whose K5 still takes all 8 heads of
an 8 x 8 tile a block, forward and backward (the port at commit a1cdee5).
Its C interfaces: `lft_spa_attn_hp(q, k, v, out, B, h, w, E, heads, scale,
stream)`, `lft_spa_attn_hp_res(q, k, v, out, m, l, B, h, w, E, heads,
scale, stream)` and `lft_spa_attn_hp_bwd(q, k, v, dout, m, l, dq, dk, dv,
B, h, w, E, heads, scale, stream)`. Its `spa_attn_hp.cu` and `spa_block.cu`
are built with the port's nvcc flags into a temporary directory.

First the ptxas report of both builds: registers and spills of every
kernel of `spa_block.cu` (all of them, K2.3 included, must match) and of
`spa_attn_hp.cu`, and K2.3's kernel as this `spa_attn_hp.cu` builds it
beside this `spa_block.cu`'s. Then, on random q, k, v, dout at [400, 32, 32,
128] (a scene's chunk) and [100, 32, 32, 128] (a train step's batch): K5,
K5 res and K5 bwd of both builds against the plain version (forwards within
1e-4 max(1, max |plain|), the backward within 5e-4 max |plain| per output),
this build's repeated bitwise and its forward held bitwise to K2.3's
`window_attn`; each backward from its own forward's (m, l). At [100, 32,
32, 128] each output's max error against float64 (from the float64
forward's (m, l)) is printed beside the f32 plain version's (from its own).
Both builds are timed in device time (`profile_scene.device_ms`) in the
order other, this, this, other, with this backward's two passes apart.
Prints the card's name and power limit first. Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from lft_torch.compare_bwd import _build_other, _err, _print_ptxas, ptxas_report

KERNEL_ATOL = 1e-4     # forwards: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # the backward: max |diff| <= 5e-4 max |plain|, per output


def _wrap_other(lib):
    """(fwd, bwd) of the other revision's K5, with this checkout's wrappers'
    arguments and outputs."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lft_spa_attn_hp.argtypes = [P] * 4 + [I] * 5 + [F, P]
    lib.lft_spa_attn_hp_res.argtypes = [P] * 6 + [I] * 5 + [F, P]
    lib.lft_spa_attn_hp_bwd.argtypes = [P] * 9 + [I] * 5 + [F, P]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def tail(q):
        B, h, w, E = q.shape
        return B, h, w, E, 8, float(E // 8) ** -0.5, stream()

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def fwd(q, k, v, with_stats=False):
        out = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if not with_stats:
            check(lib.lft_spa_attn_hp(*ptrs, *tail(q)), "spa_attn_hp")
            return out
        m = torch.empty(*q.shape[:3], 8, device=q.device)
        l = torch.empty_like(m)
        check(lib.lft_spa_attn_hp_res(*ptrs, m.data_ptr(), l.data_ptr(), *tail(q)),
              "spa_attn_hp_res")
        return out, m, l

    def bwd(q, k, v, m, l, dout):
        outs = tuple(torch.empty_like(q) for _ in range(3))
        check(lib.lft_spa_attn_hp_bwd(*(t.data_ptr() for t in (q, k, v, dout, m, l, *outs)),
                                      *tail(q)), "spa_attn_hp_bwd")
        return outs

    return fwd, bwd


def _tuple(t):
    return t if isinstance(t, tuple) else (t,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", help="the other revision's lft_torch/csrc directory")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_hp: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels import spa_block as sb
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    paths = _build.build_all()
    H, K = 8, 5
    g = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        other, hp_log = _build_other(os.path.join(a.other_csrc, "spa_attn_hp.cu"), tmp,
                                     "other_spa_attn_hp")
        spa_log = _build_other(os.path.join(a.other_csrc, "spa_block.cu"), tmp,
                               "other_spa_block")[1]
        read = lambda n: open(paths[n] + ".log").read()
        _print_ptxas("spa_block.cu", spa_log, read("spa_block"))
        _print_ptxas("spa_attn_hp.cu", hp_log, read("spa_attn_hp"))
        ours_hp, ours_spa = ptxas_report(read("spa_attn_hp")), ptxas_report(read("spa_block"))
        for name in sorted(n for n in ours_hp if "spa_window_attn_kernel" in n):
            same = "same" if ours_hp[name] == ours_spa.get(name) else "differs"
            print(f"ptxas K5's forward {name}: spa_attn_hp.cu {ours_hp[name]}, spa_block.cu "
                  f"{ours_spa.get(name)} (registers, spill stores, spill loads) [{same}]",
                  flush=True)
        o_fwd, o_bwd = _wrap_other(other)

        for V in (400, 100):
            shape = [V, 32, 32, 128]
            q, k, v, dout = (torch.randn(*shape, device=dev, generator=g) for _ in range(4))
            ref = hp.windowed_attention_headpacked_plain(q, k, v, H, K)
            res_o, res_t = o_fwd(q, k, v, True)[1:], hp.spa_attn_hp_fwd(q, k, v, H, K, True)[1:]
            ref_b = hp.windowed_attention_headpacked_bwd_plain(q, k, v, *ref[1:], dout, H, K)
            exact = None
            if V == 100:   # float64 (from the float64 forward's residuals)
                x64 = [t.double() for t in (q, k, v, dout)]
                e_fwd = hp.windowed_attention_headpacked_plain(*x64[:3], H, K)
                exact = (e_fwd, hp.windowed_attention_headpacked_bwd_plain(
                    *x64[:3], *e_fwd[1:], x64[3], H, K))
                del x64
            cases = [
                ("K5 spa_attn_hp", ref[:1], lambda: o_fwd(q, k, v),
                 lambda: hp.spa_attn_hp_fwd(q, k, v, H, K), ("out",), KERNEL_ATOL,
                 exact and exact[0][:1]),
                ("K5 spa_attn_hp_res", ref, lambda: o_fwd(q, k, v, True),
                 lambda: hp.spa_attn_hp_fwd(q, k, v, H, K, True), ("out", "m", "l"),
                 KERNEL_ATOL, exact and exact[0]),
                ("K5 spa_attn_hp_bwd", ref_b, lambda: o_bwd(q, k, v, *res_o, dout),
                 lambda: hp.spa_attn_hp_bwd(q, k, v, *res_t, dout, H, K), ("dq", "dk", "dv"),
                 TRAIN_REL, exact and exact[1])]
            same = torch.equal(hp.spa_attn_hp_fwd(q, k, v, H, K), sb.window_attn(q, k, v, H, K))
            print(f"K5 {shape}: forward bitwise equal to K2.3's window_attn: {same}", flush=True)
            if not same:
                raise AssertionError("K5's forward is not K2.3's bit for bit")
            for what, want, fo, ft, names, tol, ex in cases:
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
                    if ex is not None:
                        errs.append([_err(u, e) for u, e in zip(got, ex)])
                    del got
                if not all(torch.equal(u, r) for u, r in zip(_tuple(ft()), _tuple(ft()))):
                    raise AssertionError(f"{what} {shape}: this build does not repeat bitwise")
                tm = [device_ms(fo), device_ms(ft), device_ms(ft), device_ms(fo)]
                line = (f"{what} {shape}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this "
                        f"{tm[1]:.4f} / {tm[2]:.4f} ms (device time); this repeats bitwise")
                if what.endswith("bwd"):
                    line += (f"; this pass q {device_ms(ft, kernel='bwd_q_kernel'):.4f} ms, "
                             f"pass kv {device_ms(ft, kernel='bwd_kv_kernel'):.4f} ms")
                if ex is not None:
                    e_f32 = [_err(r, e) for r, e in zip(want, ex)]
                    line += "; max |out - float64|: " + "; ".join(
                        f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} (this / plain "
                        f"{et / max(ep, 1e-30):.3f}x)"
                        for n, eo, et, ep in zip(names, errs[0], errs[1], e_f32))
                print(line, flush=True)
            del q, k, v, dout, ref, ref_b, res_o, res_t, exact, cases
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
