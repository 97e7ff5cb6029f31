"""Time this checkout's K6 against another revision's, in turns in one
process, on one CUDA card.

    python3 -m lft_torch.compare_k6 OTHER_CSRC_DIR

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory,
so that its headers come with it): one whose K6 is the tile-dense
`spa_attn_mxu.cu` (the port at commit d74422a), a block a (view, tile,
head) scoring every query of a `pick_tile` tile against its whole key
halo. Its C interfaces: `lft_spa_attn_mxu(q, k, v, out, B, h, w, E, heads,
th, tw, scale, stream)`, `lft_spa_attn_mxu_res(q, k, v, out, m, l, ...)`
and `lft_spa_attn_mxu_bwd(q, k, v, dout, m, l, dsum, dq, dk, dv, ...)`.
This checkout's K6 launches K5's kernels (`spa_attn_hp.cu`: K2.3's window
kernel, K5 bwd's two passes). The other's `spa_attn_mxu.cu`,
`spa_attn_hp.cu` and `spa_block.cu` are built with the port's nvcc flags
into a temporary directory.

First the ptxas report of both builds: registers and spills of every
kernel of `spa_attn_hp.cu` and `spa_block.cu` (K2.3's and K5 bwd's must
match) and of the other's `spa_attn_mxu.cu`. Then, on random q, k, v,
dout: `spa_attn_mxu` at [400, 32, 32, 128] and [400, 64, 64, 128] (a
scene's chunk at patch 32 and 64), `spa_attn_mxu_res` and
`spa_attn_mxu_bwd` at [100, 32, 32, 128] and [100, 64, 64, 128] (a train
step's batch). Both builds against K6's plain version (forwards within
1e-4 max(1, max |plain|), the backward within 5e-4 max |plain| per output),
each backward from its own forward's (m, l); this build repeated bitwise
and equal to K5's wrappers bit for bit; each output's max error against
float64 (the backward from the float64 forward's (m, l)) beside the f32
plain version's (from its own). Both builds are timed in device time
(`profile_scene.device_ms`) in the order other, this, this, other. Then
K5's forward (K2.3's kernel) and K5 bwd of both builds in turns at [400,
32, 32, 128], which this revision must leave as they were, and K6 against
K10 `spa_attn_tile` at [400, 64, 64, 128] in turns (K6, K10, K10, K6).
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

from lft_torch.compare_bwd import _build_other, _err, _print_ptxas, _tuple

KERNEL_ATOL = 1e-4     # forwards: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # the backward: max |diff| <= 5e-4 max |plain|, per output
H, K = 8, 5


def _wrap_other(mxu, hp):
    """(K6 fwd, K6 bwd, K5 fwd, K5 bwd) of the other revision, with this
    checkout's wrappers' arguments and outputs."""
    from lft_torch.kernels.spa_attn import pick_tile
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    mxu.lft_spa_attn_mxu.argtypes = [P] * 4 + [I] * 7 + [F, P]
    mxu.lft_spa_attn_mxu_res.argtypes = [P] * 6 + [I] * 7 + [F, P]
    mxu.lft_spa_attn_mxu_bwd.argtypes = [P] * 10 + [I] * 7 + [F, P]
    hp.lft_spa_attn_hp.argtypes = [P] * 4 + [I] * 5 + [F, P]
    hp.lft_spa_attn_hp_bwd.argtypes = [P] * 10 + [I] * 5 + [F, P]

    def tail(q, tiled):
        B, h, w, E = q.shape
        return (B, h, w, E, H, *(pick_tile(h, w) if tiled else ()), float(E // H) ** -0.5,
                torch.cuda.current_stream().cuda_stream)

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def fwd(q, k, v, with_stats=False):
        out = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if not with_stats:
            check(mxu.lft_spa_attn_mxu(*ptrs, *tail(q, True)), "spa_attn_mxu")
            return out
        m = torch.empty(*q.shape[:3], H, device=q.device)
        l = torch.empty_like(m)
        check(mxu.lft_spa_attn_mxu_res(*ptrs, m.data_ptr(), l.data_ptr(), *tail(q, True)),
              "spa_attn_mxu_res")
        return out, m, l

    def bwd(q, k, v, m, l, dout, lib=mxu, name="spa_attn_mxu_bwd", tiled=True):
        dsum = torch.empty_like(m)
        outs = tuple(torch.empty_like(q) for _ in range(3))
        check(getattr(lib, f"lft_{name}")(
            *(t.data_ptr() for t in (q, k, v, dout, m, l, dsum, *outs)), *tail(q, tiled)), name)
        return outs

    def hp_fwd(q, k, v):
        out = torch.empty_like(q)
        check(hp.lft_spa_attn_hp(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 *tail(q, False)), "spa_attn_hp")
        return out

    def hp_bwd(q, k, v, m, l, dout):
        return bwd(q, k, v, m, l, dout, hp, "spa_attn_hp_bwd", False)

    return fwd, bwd, hp_fwd, hp_bwd


def _turns(what: str, fo, ft) -> None:
    from lft_torch.profile_scene import device_ms
    tm = [device_ms(fo), device_ms(ft), device_ms(ft), device_ms(fo)]
    print(f"{what}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / {tm[2]:.4f} ms "
          f"(device time)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", help="the other revision's lft_torch/csrc directory")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k6: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import local_attn as la
    from lft_torch.kernels import spa_attn as sa
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    paths = _build.build_all()
    read = lambda n: open(paths[n] + ".log").read()
    g = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        built = {n: _build_other(os.path.join(a.other_csrc, f"{n}.cu"), tmp, f"other_{n}")
                 for n in ("spa_attn_mxu", "spa_attn_hp", "spa_block")}
        for n in ("spa_attn_hp", "spa_block"):
            _print_ptxas(f"{n}.cu", built[n][1], read(n))
        _print_ptxas("spa_attn_mxu.cu (gone from this revision)", built["spa_attn_mxu"][1], "")
        o_fwd, o_bwd, o_hp_fwd, o_hp_bwd = _wrap_other(built["spa_attn_mxu"][0],
                                                       built["spa_attn_hp"][0])

        for V, h, forms in ((400, 32, ("fwd",)), (400, 64, ("fwd",)), (100, 32, ("res", "bwd")),
                            (100, 64, ("res", "bwd"))):
            shape = [V, h, h, 128]
            q, k, v, dout = (torch.randn(*shape, device=dev, generator=g) for _ in range(4))
            ref = sa.windowed_attention_mxu_plain(q, k, v, H, K)
            x64 = [t.double() for t in (q, k, v, dout)]
            e_fwd = sa.windowed_attention_mxu_plain(*x64[:3], H, K)
            if "bwd" in forms:
                res_o, res_t = o_fwd(q, k, v, True)[1:], sa.spa_attn_mxu_fwd(q, k, v, H, K, True)[1:]
                ref_b = sa.windowed_attention_mxu_bwd_plain(q, k, v, *ref[1:], dout, H, K)
                e_bwd = sa.windowed_attention_mxu_bwd_plain(*x64[:3], *e_fwd[1:], x64[3], H, K)
            del x64
            cases = {
                "fwd": ("K6 spa_attn_mxu", ref[:1], lambda: o_fwd(q, k, v),
                        lambda: sa.spa_attn_mxu_fwd(q, k, v, H, K),
                        lambda: hp.spa_attn_hp_fwd(q, k, v, H, K), ("out",), KERNEL_ATOL,
                        e_fwd[:1]),
                "res": ("K6 spa_attn_mxu_res", ref, lambda: o_fwd(q, k, v, True),
                        lambda: sa.spa_attn_mxu_fwd(q, k, v, H, K, True),
                        lambda: hp.spa_attn_hp_fwd(q, k, v, H, K, True), ("out", "m", "l"),
                        KERNEL_ATOL, e_fwd)}
            if "bwd" in forms:
                cases["bwd"] = ("K6 spa_attn_mxu_bwd", ref_b,
                                lambda: o_bwd(q, k, v, *res_o, dout),
                                lambda: sa.spa_attn_mxu_bwd(q, k, v, *res_t, dout, H, K),
                                lambda: hp.spa_attn_hp_bwd(q, k, v, *res_t, dout, H, K),
                                ("dq", "dk", "dv"), TRAIN_REL, e_bwd)
            for form in forms:
                what, want, fo, ft, f5, names, tol, ex = cases[form]
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
                first = _tuple(ft())
                if not all(torch.equal(u, r) for u, r in zip(first, _tuple(ft()))):
                    raise AssertionError(f"{what} {shape}: this build does not repeat bitwise")
                if not all(torch.equal(u, r) for u, r in zip(first, _tuple(f5()))):
                    raise AssertionError(f"{what} {shape}: this build is not K5's bit for bit")
                del first
                tm = [device_ms(fo), device_ms(ft), device_ms(ft), device_ms(fo)]
                e_f32 = [_err(r, e) for r, e in zip(want, ex)]
                print(f"{what} {shape}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / "
                      f"{tm[2]:.4f} ms (device time); this repeats bitwise and equals K5's; "
                      "max |out - float64|: "
                      + "; ".join(f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} (this "
                                  f"/ plain {et / max(ep, 1e-30):.3f}x)"
                                  for n, eo, et, ep in zip(names, errs[0], errs[1], e_f32)),
                      flush=True)
            del q, k, v, dout, ref, e_fwd, cases
            if "bwd" in forms:
                del res_o, res_t, ref_b, e_bwd
            torch.cuda.empty_cache()

        # K2.3 (K5's forward) and K5 bwd, which this revision leaves as they were
        q, k, v, dout = (torch.randn(400, 32, 32, 128, device=dev, generator=g) for _ in range(4))
        _, m, l = hp.spa_attn_hp_fwd(q, k, v, H, K, True)
        if not (torch.equal(o_hp_fwd(q, k, v), hp.spa_attn_hp_fwd(q, k, v, H, K)) and all(
                torch.equal(u, r) for u, r in zip(o_hp_bwd(q, k, v, m, l, dout),
                                                  hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K)))):
            raise AssertionError("K5's kernels differ between the two builds")
        print("K5 [400, 32, 32, 128]: both builds' forward and backward equal bit for bit",
              flush=True)
        _turns("K5 spa_attn_hp (K2.3's kernel) [400, 32, 32, 128]", lambda: o_hp_fwd(q, k, v),
               lambda: hp.spa_attn_hp_fwd(q, k, v, H, K))
        _turns("K5 spa_attn_hp_bwd [400, 32, 32, 128]", lambda: o_hp_bwd(q, k, v, m, l, dout),
               lambda: hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K))
        del q, k, v, dout, m, l
        torch.cuda.empty_cache()

        # at 64x64 views: K6 (the dispatch's choice, lft_tpu's gate) against K10
        q, k, v = (torch.randn(400, 64, 64, 128, device=dev, generator=g) for _ in range(3))
        f6 = lambda: sa.spa_attn_mxu_fwd(q, k, v, H, K)
        f10 = lambda: la.windowed_attention_tile(q, k, v, H, K)
        tm = [device_ms(f6), device_ms(f10), device_ms(f10), device_ms(f6)]
        print(f"K6 against K10 [400, 64, 64, 128] (device time, K6, K10, K10, K6): K6 "
              f"{tm[0]:.4f} / {tm[3]:.4f} ms, K10 {tm[1]:.4f} / {tm[2]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
