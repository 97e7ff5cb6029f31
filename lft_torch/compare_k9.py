"""Time this checkout's K9 and K10 against another revision's, in turns in
one process, on one CUDA card.

    python3 -m lft_torch.compare_k9 OTHER_CSRC_DIR [--only-other]

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory, so
that its headers come with it): one with K9's and K10's own sources (the
port at commit 3d961ab). `spa_attn_offset.cu` gives a thread one (pixel,
head), its <= 25 neighbour rows read from device memory, an online softmax
rescaled at every offset, and a backward of a D kernel (D from `out`) and a
gather; `spa_attn_tile.cu` a block an 8 x 8 tile's 144 halo keys scored
densely under the -1e30 mask, in two passes. Their C interfaces:
`lft_spa_attn_offset(q, k, v, out, B, h, w, E, heads, scale, stream)`,
`lft_spa_attn_offset_res(q, k, v, out, m, l, ...)`,
`lft_spa_attn_offset_bwd(q, k, v, dout, out, m, l, dsum, dq, dk, dv, ...)`
and `lft_spa_attn_tile(q, k, v, out, ...)`. This checkout's K9 and K10
launch K5's kernels (`spa_attn_hp.cu`: K2.3's window kernel, K5 bwd's two
passes). The other's `spa_attn_offset.cu`, `spa_attn_tile.cu`,
`spa_attn_hp.cu` and `spa_block.cu` are built with the port's nvcc flags
into a temporary directory.

First the ptxas report of both builds: registers and spills of every kernel
of `spa_attn_hp.cu` and `spa_block.cu` (which must match: a mismatch makes
the exit code 1 after the timings) and of the other's two sources. Then, on
random q, k, v, dout: `spa_attn_offset` at [400, 32, 32, 128] and [400, 30,
30, 128] (a scene's chunk under `LFT_SPA_VARIANT=offset` and at patch 30),
`spa_attn_offset_res` and `spa_attn_offset_bwd` at [100, 32, 32, 128] and
[100, 30, 30, 128] (a train step's batch), `spa_attn_tile` at [400, 32, 32,
128] and [400, 64, 64, 128] (the `tile` scene's chunk, the patch-64
`offset` scene's). Both builds against the plain versions (forwards within
1e-4 max(1, max |plain|), the backward within 5e-4 max |plain| per output),
each backward from its own forward's (out, m, l); this build repeated
bitwise and equal to K5's wrappers bit for bit; each output's max error
against float64 (K9's plain version in float64; the backward from the
float64 forward's (out, m, l)) beside the f32 plain version's (from its
own). Both builds are timed in device time (`profile_scene.device_ms`) in
the order other, this, this, other, beside the bound (max(FLOPs / 67
TFLOP/s, bytes / 3.35 TB/s): 4 E FLOP a forward's in-image (query, key)
pair, 10 E a backward's; each input read and output written once, the
backward reading q, k, v, m, l, dout). With `--only-other` only the other
build is checked and timed (a parent's times before a prediction). Prints
the card's name and power limit first. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from lft_torch.compare_bwd import _build_other, _err, _print_ptxas, _tuple, ptxas_report

KERNEL_ATOL = 1e-4     # forwards: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # the backward: max |diff| <= 5e-4 max |plain|, per output
H, K = 8, 5
FP32_FLOPS, HBM = 67e12, 3.35e12


def _wrap_other(off, tile):
    """(K9 fwd, K9 bwd, K10) of the other revision, with this checkout's
    wrappers' arguments and outputs."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    off.lft_spa_attn_offset.argtypes = [P] * 4 + [I] * 5 + [F, P]
    off.lft_spa_attn_offset_res.argtypes = [P] * 6 + [I] * 5 + [F, P]
    off.lft_spa_attn_offset_bwd.argtypes = [P] * 11 + [I] * 5 + [F, P]
    tile.lft_spa_attn_tile.argtypes = [P] * 4 + [I] * 5 + [F, P]

    def tail(q):
        B, h, w, E = q.shape
        return B, h, w, E, H, float(E // H) ** -0.5, torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def fwd(q, k, v, with_stats=False):
        out = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if not with_stats:
            check(off.lft_spa_attn_offset(*ptrs, *tail(q)), "spa_attn_offset")
            return out
        m = torch.empty(*q.shape[:3], H, device=q.device)
        l = torch.empty_like(m)
        check(off.lft_spa_attn_offset_res(*ptrs, m.data_ptr(), l.data_ptr(), *tail(q)),
              "spa_attn_offset_res")
        return out, m, l

    def bwd(q, k, v, out, m, l, dout):
        dsum = torch.empty_like(m)
        grads = tuple(torch.empty_like(q) for _ in range(3))
        check(off.lft_spa_attn_offset_bwd(
            *(t.data_ptr() for t in (q, k, v, dout, out, m, l, dsum, *grads)), *tail(q)),
            "spa_attn_offset_bwd")
        return grads

    def k10(q, k, v):
        out = torch.empty_like(q)
        check(tile.lft_spa_attn_tile(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     *tail(q)), "spa_attn_tile")
        return out

    return fwd, bwd, k10


def _bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / FP32_FLOPS, nbytes / HBM) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", help="the other revision's lft_torch/csrc directory")
    ap.add_argument("--only-other", action="store_true",
                    help="check and time the other build alone")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k9: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import local_attn as la
    from lft_torch.kernels import local_attn_vjp as lv
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    only = a.only_other
    g = torch.Generator(device=dev).manual_seed(0)
    ptxas_same = True
    with tempfile.TemporaryDirectory() as tmp:
        names = ("spa_attn_offset", "spa_attn_tile") + (() if only else ("spa_attn_hp",
                                                                         "spa_block"))
        built = {n: _build_other(os.path.join(a.other_csrc, f"{n}.cu"), tmp, f"other_{n}")
                 for n in names}
        if not only:
            paths = _build.build_all()
            for n in ("spa_attn_hp", "spa_block"):
                this_log = open(paths[n] + ".log").read()
                _print_ptxas(f"{n}.cu", built[n][1], this_log)
                ptxas_same &= ptxas_report(built[n][1]) == ptxas_report(this_log)
        for n in ("spa_attn_offset", "spa_attn_tile"):
            _print_ptxas(f"{n}.cu (gone from this revision)", built[n][1], "")
        o_fwd, o_bwd, o_k10 = _wrap_other(built["spa_attn_offset"][0],
                                          built["spa_attn_tile"][0])

        for V, h, forms in ((400, 32, ("fwd", "tile")), (400, 30, ("fwd",)),
                            (400, 64, ("tile",)), (100, 32, ("res", "bwd")),
                            (100, 30, ("res", "bwd"))):
            shape = [V, h, h, 128]
            q, k, v, dout = (torch.randn(*shape, device=dev, generator=g) for _ in range(4))
            pairs = V * int(hp._window_valid(h, h, K).sum())
            img = q.numel() * 4
            stats = 2 * img // 16                  # m, l: 8 floats a pixel each
            ref = lv.windowed_attention_offset_plain(q, k, v, H, K)
            x64 = [t.double() for t in (q, k, v, dout)]
            e_fwd = lv.windowed_attention_offset_plain(*x64[:3], H, K)
            if "bwd" in forms:
                res_o = o_fwd(q, k, v, True)
                res_t = None if only else lv.spa_attn_offset_fwd(q, k, v, H, K, True)
                ref_b = lv.windowed_attention_offset_bwd_plain(q, k, v, *ref, dout, H, K)
                e_bwd = lv.windowed_attention_offset_bwd_plain(*x64[:3], *e_fwd, x64[3], H, K)
            del x64
            cases = {
                "fwd": ("K9 spa_attn_offset", ref[:1], lambda: o_fwd(q, k, v),
                        lambda: lv.spa_attn_offset_fwd(q, k, v, H, K),
                        lambda: hp.spa_attn_hp_fwd(q, k, v, H, K), ("out",), KERNEL_ATOL,
                        e_fwd[:1], _bound_ms(4 * 128 * pairs, 4 * img)),
                "res": ("K9 spa_attn_offset_res", ref, lambda: o_fwd(q, k, v, True),
                        lambda: lv.spa_attn_offset_fwd(q, k, v, H, K, True),
                        lambda: hp.spa_attn_hp_fwd(q, k, v, H, K, True), ("out", "m", "l"),
                        KERNEL_ATOL, e_fwd, _bound_ms(4 * 128 * pairs, 4 * img + stats))}
            if "tile" in forms:
                cases["tile"] = ("K10 spa_attn_tile", (la.windowed_attention_tile_plain(
                    q, k, v, H, K),), lambda: o_k10(q, k, v),
                    lambda: la.windowed_attention_tile(q, k, v, H, K),
                    lambda: hp.spa_attn_hp_fwd(q, k, v, H, K), ("out",), KERNEL_ATOL,
                    e_fwd[:1], _bound_ms(4 * 128 * pairs, 4 * img))
            if "bwd" in forms:
                cases["bwd"] = ("K9 spa_attn_offset_bwd", ref_b,
                                lambda: o_bwd(q, k, v, *res_o, dout),
                                lambda: lv.spa_attn_offset_bwd(q, k, v, None, *res_t[1:], dout,
                                                               H, K),
                                lambda: hp.spa_attn_hp_bwd(q, k, v, *res_t[1:], dout, H, K),
                                ("dq", "dk", "dv"), TRAIN_REL, e_bwd,
                                _bound_ms(10 * 128 * pairs, 7 * img + stats))
            for form in forms:
                what, want, fo, ft, f5, outs, tol, ex, bound = cases[form]
                who_fns = (("other", fo),) if only else (("other", fo), ("this", ft))
                errs = []
                for who, fn in who_fns:
                    got = _tuple(fn())
                    for n, u, r in zip(outs, got, want):
                        lim = (tol * max(1.0, float(r.abs().max())) if tol == KERNEL_ATOL
                               else tol * float(r.abs().max()))
                        if not u.shape == r.shape or not _err(u, r) <= lim:
                            raise AssertionError(f"{what} {shape}: {who} disagrees with the "
                                                 f"plain version at {n} ({_err(u, r):.3e} > "
                                                 f"{lim:.3e})")
                    errs.append([_err(u, e) for u, e in zip(got, ex)])
                    del got
                e_f32 = [_err(r, e) for r, e in zip(want, ex)]
                if only:
                    tm = [device_ms(fo), device_ms(fo)]
                    print(f"{what} {shape}: other {tm[0]:.4f} / {tm[1]:.4f} ms (device time; "
                          f"bound {bound:.4f}); max |out - float64|: "
                          + "; ".join(f"{n} other {eo:.3e}, f32 plain {ep:.3e}"
                                      for n, eo, ep in zip(outs, errs[0], e_f32)), flush=True)
                    continue
                first = _tuple(ft())
                if not all(torch.equal(u, r) for u, r in zip(first, _tuple(ft()))):
                    raise AssertionError(f"{what} {shape}: this build does not repeat bitwise")
                if not all(torch.equal(u, r) for u, r in zip(first, _tuple(f5()))):
                    raise AssertionError(f"{what} {shape}: this build is not K5's bit for bit")
                del first
                tm = [device_ms(fo), device_ms(ft), device_ms(ft), device_ms(fo)]
                print(f"{what} {shape}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / "
                      f"{tm[2]:.4f} ms (device time; bound {bound:.4f}); this repeats bitwise "
                      "and equals K5's; max |out - float64|: "
                      + "; ".join(f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} (this "
                                  f"/ plain {et / max(ep, 1e-30):.3f}x)"
                                  for n, eo, et, ep in zip(outs, errs[0], errs[1], e_f32)),
                      flush=True)
            del q, k, v, dout, ref, e_fwd, cases
            if "bwd" in forms:
                del res_o, res_t, ref_b, e_bwd
            torch.cuda.empty_cache()
    if not ptxas_same:
        print("compare_k9: the two builds' ptxas reports of spa_attn_hp.cu / spa_block.cu "
              "differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
