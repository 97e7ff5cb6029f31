"""Time this checkout's K3.b and K3.c kernels against another revision's, in
turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_k3 OTHER_CSRC_DIR

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (`git
archive <commit> lft_torch/csrc`, unpacked into a git-ignored directory,
so that its headers come with it): one whose K3.b `spa_ln_qkv` still runs
its products on the FP32 pipes and whose K3.c `spa_window_attn_bwd` is one
kernel of one head of a 16 x 16 tile a block, reading attn (the port at
commit d798714). Its C interfaces, both in `spa_block_bwd.cu`:
`lft_spa_ln_qkv(tok, pe_tok, ln, wqk, wv, xn, q, k, v, T, hw, C, stream)`
and `lft_spa_window_attn_bwd(q, k, v, attn, dattn, m, l, dq, dk, dv, V, h,
w, D, H, scale, stream)`. Its `spa_block.cu`, `spa_block_bwd.cu` and
`spa_attn_hp.cu` are built with the port's nvcc flags into a temporary
directory.

First the ptxas report of both builds: registers and spills of every
kernel of the three sources, so that K2.2 (`spa_qkv_kernel<C, false>`),
K2.3, K5 and K3's other steps can be read unchanged. Then, with the demo
checkpoint's block-0 weights at a train step's [100, 32, 32, 64]: K3.b on
K2.1's tok (this build's outputs must equal K2.1's xn and K2.2's q, k, v
bit for bit), K3.c on those q, k, v with K2.3 res's (m, l) and attn and a
random dattn (this build's outputs must equal `spa_attn_hp_bwd`'s bit for
bit). Both builds are held to the plain version on the same inputs (5e-4
max |plain| per output) and to a bitwise repeat; each output's max error
against float64 is printed beside the f32 plain version's (K3.c each from
its own forward's (m, l)); both are timed in device time
(`profile_scene.device_ms`) in the order other, this, this, other. Then
the K3 chain (five steps, 8 wgrad, 3 colsum) from K2 res's residuals with
steps b and c of either build, the others this checkout's, held to the
plain chain, in the same turns: the chain's device time and that of steps
b and c within it. Prints the card's name and power limit first. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from lft_torch.compare_bwd import _build_other, _err, _print_ptxas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_REL = 5e-4       # a backward step: max |diff| <= 5e-4 max |plain|, per output
# the steps' kernels by trace name: this build's, the other's
STEP_KERNELS = {"this": ("spa_qkv_kernel", "spa_attn_hp_bwd"),
                "other": ("spa_ln_qkv_kernel", "spa_window_attn_bwd_kernel")}


def _wrap_other(bwd):
    """(ln_qkv, window_attn_bwd) of the other revision, with this checkout's
    wrappers' arguments and outputs."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bwd.lft_spa_ln_qkv.argtypes = [P] * 9 + [I] * 3 + [P]
    bwd.lft_spa_window_attn_bwd.argtypes = [P] * 10 + [I] * 5 + [F, P]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def ln_qkv(tok, pe_tok, wts):
        V, h, w, D = tok.shape
        outs = tuple(torch.empty_like(tok) for _ in range(4))
        check(bwd.lft_spa_ln_qkv(*(t.data_ptr() for t in (tok, pe_tok, wts["ln"], wts["wqk"],
                                                         wts["wv"], *outs)),
                                 V * h * w, h * w, D // 2, stream()), "spa_ln_qkv")
        return outs

    def window_attn_bwd(q, k, v, attn, dattn, m, l, num_heads, ksize):
        V, h, w, D = q.shape
        outs = tuple(torch.empty_like(q) for _ in range(3))
        check(bwd.lft_spa_window_attn_bwd(*(t.data_ptr() for t in (q, k, v, attn, dattn, m, l,
                                                                   *outs)),
                                          V, h, w, D, num_heads,
                                          float(D // num_heads) ** -0.5, stream()),
              "spa_window_attn_bwd")
        return outs

    return ln_qkv, window_attn_bwd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", help="the other revision's lft_torch/csrc directory")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k3: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.posenc import spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import device_ms
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    paths = _build.build_all()
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
    ws64 = {k: v.double() for k, v in ws.items()}
    V, h, w, C, H, K = 100, 32, 32, 64, 8, 5
    D = 2 * C
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, device=dev, generator=g)
    with tempfile.TemporaryDirectory() as tmp:
        logs = {}
        for n in ("spa_block", "spa_block_bwd", "spa_attn_hp"):
            lib, logs[n] = _build_other(os.path.join(a.other_csrc, f"{n}.cu"), tmp, f"other_{n}")
            if n == "spa_block_bwd":
                o_lnqkv, o_attn_bwd = _wrap_other(lib)
        for n, log in logs.items():
            # K2.2's kernel is spa_qkv_kernel<C, false> here, spa_qkv_kernel<C> before
            this_log = re.sub(r"(spa_qkv_kernelILi\d+E)Lb0E(E)", r"\1\2",
                              open(paths[n] + ".log").read())
            _print_ptxas(f"{n}.cu", log, this_log)

        xs = rand(V, h, w, C)
        pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                                  ws["mlp"])[0].contiguous()
        # K3.b on K2.1's tok
        tok, xn = sb.tokenize_ln(xs, pe_tok, ws)
        fwd = (xn, *sb.qkv(xn, tok, ws))
        same = all(torch.equal(u, r) for u, r in zip(sb.ln_qkv(tok, pe_tok, ws), fwd))
        print(f"K3.b [{V}, {h}, {w}, {C}]: this build's (xn, q, k, v) bitwise equal to K2.1's xn "
              f"and K2.2's (q, k, v): {same}", flush=True)
        if not same:
            raise AssertionError("this K3.b does not recompute the forward bit for bit")
        q, k, v = fwd[1:]
        del xn, fwd
        # K3.c on those q, k, v with K2.3 res's (m, l) and attn
        attn, m, l = sb.window_attn(q, k, v, H, K, with_stats=True)
        dattn = rand(V, h, w, D)
        c_args = (q, k, v, attn, dattn, m, l, H, K)
        same = all(torch.equal(u, r) for u, r in zip(sb.window_attn_bwd(*c_args),
                                                     hp.spa_attn_hp_bwd(q, k, v, m, l, dattn,
                                                                        H, K)))
        print(f"K3.c [{V}, {h}, {w}, {D}]: this build bitwise equal to spa_attn_hp_bwd: {same}",
              flush=True)
        if not same:
            raise AssertionError("this K3.c is not K5's backward bit for bit")
        x64 = [t.double() for t in (q, k, v)]
        a64, m64, l64 = sb.window_attn_plain(*x64, H, K)
        a_p, m_p, l_p = sb.window_attn_plain(q, k, v, H, K)
        cases = [
            (f"K3.b spa_ln_qkv [{V}, {h}, {w}, {C}]", sb.ln_qkv_plain(tok, pe_tok, ws),
             sb.ln_qkv_plain(tok.double(), pe_tok.double(), ws64),
             lambda: o_lnqkv(tok, pe_tok, ws), lambda: sb.ln_qkv(tok, pe_tok, ws),
             ("xn", "q", "k", "v")),
            (f"K3.c spa_window_attn_bwd [{V}, {h}, {w}, {D}]", sb.window_attn_bwd_plain(*c_args),
             sb.window_attn_bwd_plain(*x64, a64, dattn.double(), m64, l64, H, K),
             lambda: o_attn_bwd(*c_args), lambda: sb.window_attn_bwd(*c_args),
             ("dq", "dk", "dv"), sb.window_attn_bwd_plain(q, k, v, a_p, dattn, m_p, l_p, H, K))]
        del x64, a64, m64, l64, a_p, m_p, l_p
        for what, ref, exact, other, this, names, *own in cases:
            own = own[0] if own else ref   # the f32 plain version from its own forward
            e_f32 = [_err(r, e) for r, e in zip(own, exact)]
            errs = []
            for fn in (other, this):
                got = fn()
                for n, u, r in zip(names, got, ref):
                    lim = TRAIN_REL * float(r.abs().max())
                    if not u.shape == r.shape or not _err(u, r) <= lim:
                        raise AssertionError(f"{what}: a build disagrees with the plain version "
                                             f"at {n} ({_err(u, r):.3e} > {lim:.3e})")
                errs.append([_err(u, e) for u, e in zip(got, exact)])
                if not all(torch.equal(u, r) for u, r in zip(got, fn())):
                    raise AssertionError(f"{what}: a build does not repeat bitwise")
                del got
            tm = [device_ms(other), device_ms(this), device_ms(this), device_ms(other)]
            f64 = "; ".join(f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} "
                            f"(this / plain {et / max(ep, 1e-30):.3f}x)"
                            for n, eo, et, ep in zip(names, errs[0], errs[1], e_f32))
            print(f"{what}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / {tm[2]:.4f} ms "
                  f"(device time); both repeat bitwise; max |out - float64|: {f64}", flush=True)
        del cases, tok, q, k, v, attn, dattn, m, l, c_args

        # the K3 chain from K2 res's residuals, as in a train step
        _, tok, m, l, attn = sb.spa_block(xs, pe_tok, ws, H, K, with_res=True)
        dout = rand(V, h, w, C)
        hid = lambda f: f(attn, tok, dout, ws)[4]
        flips = ((hid(sb.ffn_out_bwd) > 0) != (hid(sb.ffn_out_bwd_plain) > 0)).any(-1)
        print(f"K3: {int(flips.sum())} tokens with a ReLU flip, given a zero cotangent",
              flush=True)
        dout[flips] = 0.0
        s_args = (xs, pe_tok, ws, tok, m, l, attn, dout, H, K)
        ref = sb.spa_block_bwd_plain(*s_args)

        def chain(b, c):
            steps = list(sb._KERNEL_STEPS)
            steps[1], steps[2] = b, c
            return lambda: sb._bwd(tuple(steps), *s_args)

        fns = {"other": chain(o_lnqkv, o_attn_bwd), "this": chain(sb.ln_qkv, sb.window_attn_bwd)}
        for who, fn in fns.items():
            for i, (u, r) in enumerate(zip(fn(), ref)):
                if not _err(u, r) <= TRAIN_REL * float(r.abs().max()) + 2e-9:
                    raise AssertionError(f"K3 chained: the {who} build disagrees with the plain "
                                         f"chain at output {i} ({_err(u, r):.3e})")
        t = [(who, device_ms(fns[who]), *(device_ms(fns[who], kernel=kn)
                                          for kn in STEP_KERNELS[who]))
             for who in ("other", "this", "this", "other")]
        print(f"K3 chained (5 steps + 8 wgrad + 3 colsum) [{V}, {h}, {w}, {C}]: "
              + ", ".join(f"{who} {tc:.4f} ms (step b {tb:.4f}, step c {tcc:.4f})"
                          for who, tc, tb, tcc in t)
              + " (device time, in turns; steps b and c by their main kernels)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
