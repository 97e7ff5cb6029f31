"""Time this checkout's K4 and K3.d kernels against another revision's, in
turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_angbwd OTHER_ANG_BLOCK_CU OTHER_SPA_BLOCK_BWD_CU \
        [--other-spa OTHER_SPA_BLOCK_CU]

The sources are `ang_block.cu` and `spa_block_bwd.cu` of a revision whose
K4 `ang_block_bwd` and K3.d `spa_qkv_ln_bwd` still run their products on
the FP32 pipes from transposed weight copies: the port at commit 345b0c6.
Its C interfaces: `lft_ang_block_bwd(x, pe, ln, wq, wk, wv, wo, w1, wqT,
wkT, wvT, woT, w1T, w2T, m, l, attn, dout, dx, xn, dq, dk, dv, dx2, xn2,
dpre, hid, ln_part, N, A2, C, H, scale, stream)` for A2 <= 64 (ln_part
[ceil(N / (64 / A2)), 4, C]), `lft_ang_block_bwd128(the same, then q, k,
v, dattn, dsum, N, A2, C, H, scale, stream)` beyond (ln_part [ceil(T / 64),
4, C]) and `lft_spa_qkv_ln_bwd(tok, pe_tok, dq, dk, dv, dx2, ln, wqT, wkT,
wvT, dtok, dtokpe, ln_part, T, hw, C, stream)` (ln_part [ceil(T / 64), 2,
D]). Unpack the revision's whole `lft_torch/csrc` (`git archive <commit>
lft_torch/csrc`) into a git-ignored directory, so that its headers come
with it. Each source is built with the port's nvcc flags into a temporary
directory.

First the ptxas report of both builds: registers and spills of every
kernel, for the kernels neither redesign touched to be read side by side
(with `--other-spa`, K2's `spa_block.cu` too, whose `rowgemm.cuh` changed).
Then, with the demo checkpoint's block-0 weights: K4 at [4096, 25, 64] (a
fused train step) and [1024, 81, 64] (an angRes-9 step), from K1 res's
residuals as in a train step, and K3.d at [100, 32, 32, 64] with the
block's own activations (ReLU flips between the versions given a zero
cotangent, as chip_smoke.py does). Both builds are checked against the
plain version on the same inputs (within 5e-4 max |plain| per output, the
LN sums summed over their rows) and for a bitwise repeat; their max error
against float64 is printed per output beside the f32 plain version's (TF32
off; for K4 the plain and the float64 backward each from its own
forward's residuals); both are
timed in device time (`profile_scene.device_ms`) in the order other, this,
this, other. Then the chains in the same turns, each held to its plain
chain: K4 + 6 wgrad + colsum at both shapes and the K3 chain (five steps,
8 wgrad, 3 colsum) with step d of either build: the chain's device time
and, for K3, that of step d within it. Prints the card's name and
power limit first. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from lft_torch.compare_bwd import _build_other, _err, _print_ptxas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_REL = 5e-4       # the backward step: max |diff| <= 5e-4 max |plain|, per output


def _wrap_other(ang, bwd):
    """(ang_block_bwd_ops, qkv_ln_bwd) of the other revision, with this
    checkout's wrappers' arguments and outputs (its LN sums one row a
    64-row block)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ang.lft_ang_block_bwd.argtypes = [P] * 28 + [I] * 4 + [F, P]
    ang.lft_ang_block_bwd128.argtypes = [P] * 33 + [I] * 4 + [F, P]
    bwd.lft_spa_qkv_ln_bwd.argtypes = [P] * 13 + [I] * 3 + [P]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    t = lambda m: m.t().contiguous()

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def ang_bwd_ops(x, pe, wts, m, l, attn, dout, num_heads):
        N, A2, C = x.shape
        T = N * A2
        wide = A2 > 64
        e = lambda *s: torch.empty(*s, device=x.device)
        blocks = -(-T // 64) if wide else -(-N // (64 // A2))
        ins = (x, pe, wts["ln"], wts["wq"], wts["wk"], wts["wv"], wts["wo"], wts["w1"],
               t(wts["wq"]), t(wts["wk"]), t(wts["wv"]), t(wts["wo"]), t(wts["w1"]),
               t(wts["w2"]), m, l, attn, dout)
        outs = (e(N, A2, C), e(T, C), e(T, C), e(T, C), e(T, C), e(T, C), e(T, C),
                e(T, 2 * C), e(T, 2 * C), e(blocks, 4, C))
        scratch = (e(T, C), e(T, C), e(T, C), e(T, C), e(T, num_heads)) if wide else ()
        fn = ang.lft_ang_block_bwd128 if wide else ang.lft_ang_block_bwd
        check(fn(*(u.data_ptr() for u in ins + outs + scratch), N, A2, C, num_heads,
                 float(C // num_heads) ** -0.5, stream()), "ang_block_bwd")
        return outs

    def qkv_ln_bwd(tok, pe_tok, dq, dk, dv, dx2, wts):
        V, h, w, D = tok.shape
        T = V * h * w
        ins = (tok, pe_tok, dq, dk, dv, dx2, wts["ln"], t(wts["wqk"][:, :D]),
               t(wts["wqk"][:, D:]), t(wts["wv"]))
        outs = (torch.empty_like(tok), torch.empty_like(tok),
                torch.empty(-(-T // 64), 2, D, device=tok.device))
        check(bwd.lft_spa_qkv_ln_bwd(*(u.data_ptr() for u in ins + outs), T, h * w, D // 2,
                                     stream()), "spa_qkv_ln_bwd")
        return outs

    return ang_bwd_ops, qkv_ln_bwd


def _summed(o):
    return (*o[:-1], o[-1].sum(0, keepdim=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_ang", help="path of the other revision's ang_block.cu")
    ap.add_argument("other_bwd", help="path of the other revision's spa_block_bwd.cu")
    ap.add_argument("--other-spa", help="path of the other revision's spa_block.cu (ptxas only)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_angbwd: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels.wgrad import colsum, wgrad
    from lft_torch.ops.posenc import angular_position, spatial_position
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
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    wa64 = {k: v.double() for k, v in wa.items()}
    ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
    ws64 = {k: v.double() for k, v in ws.items()}
    C, H, K = 64, 8, 5
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, device=dev, generator=g)
    with tempfile.TemporaryDirectory() as tmp:
        ang, ang_log = _build_other(a.other_ang, tmp, "other_ang_block")
        bwd, bwd_log = _build_other(a.other_bwd, tmp, "other_spa_block_bwd")
        read = lambda n: open(paths[n] + ".log").read()
        _print_ptxas("ang_block.cu", ang_log, read("ang_block"))
        _print_ptxas("spa_block_bwd.cu", bwd_log, read("spa_block_bwd"))
        if a.other_spa:
            _print_ptxas("spa_block.cu", _build_other(a.other_spa, tmp, "other_spa_block")[1],
                         read("spa_block"))
        o_ang_ops, o_qkv = _wrap_other(ang, bwd)

        # K4 from K1 res's residuals, as in a train step; against float64
        # each version from its own forward's (the softmax (m, l) fits the
        # scores of the forward that made it)
        cases, chains = [], []
        for N, A2 in ((4096, 25), (1024, 81)):
            x, dout = rand(N, A2, C), rand(N, A2, C)
            pe = torch.from_numpy(angular_position(A2, C)).to(dev)
            res_k = ab.ang_block(x, pe, wa, H, with_res=True)[1:]
            res_p = ab.ang_block_plain(x, pe, wa, H, with_res=True)[1:]
            res_e = ab.ang_block_plain(x.double(), pe.double(), wa64, H, with_res=True)[1:]
            exact = lambda d: ab.ang_block_bwd_ops_plain(x.double(), pe.double(), wa64, *res_e,
                                                         d.double(), H)
            hid_k = ab.ang_block_bwd_ops(x, pe, wa, *res_k, dout, H)[8] > 0
            flips = ((hid_k != (ab.ang_block_bwd_ops_plain(x, pe, wa, *res_p, dout, H)[8] > 0))
                     | (hid_k != (exact(dout)[8] > 0))).any(-1).reshape(N, A2)
            print(f"K4 {[N, A2, C]}: {int(flips.sum())} tokens with a ReLU flip, given a zero "
                  f"cotangent", flush=True)
            dout[flips] = 0.0
            args = (x, pe, wa, *res_k, dout, H)
            cases.append((f"K4 ang_block_bwd {[N, A2, C]}", ab.ang_block_bwd_ops_plain(*args),
                          ab.ang_block_bwd_ops_plain(x, pe, wa, *res_p, dout, H), exact(dout),
                          lambda args=args: o_ang_ops(*args),
                          lambda args=args: ab.ang_block_bwd_ops(*args),
                          ("dx", "xn", "dq", "dk", "dv", "dx2", "xn2", "dpre", "hid", "dln sums")))
            chains.append((f"K4 + 6 wgrad + colsum {[N, A2, C]}", ab.ang_block_bwd_plain(*args),
                           lambda args=args: ab._bwd(o_ang_ops, wgrad, colsum, *args),
                           lambda args=args: ab.ang_block_bwd(*args), None))

        # K3.d with the block's own activations at a train step's [100, 32, 32, 64]
        V, h, w = 100, 32, 32
        xs = rand(V, h, w, C)
        pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                                  ws["mlp"])[0].contiguous()
        _, tok, m, l, attn = sb.spa_block_plain(xs, pe_tok, ws, H, K, with_res=True)
        dout = rand(V, h, w, C)
        hid = lambda f: f(attn, tok, dout, ws)[4]
        flips = ((hid(sb.ffn_out_bwd) > 0) != (hid(sb.ffn_out_bwd_plain) > 0)).any(-1)
        print(f"K3: {int(flips.sum())} tokens with a ReLU flip, given a zero cotangent",
              flush=True)
        dout[flips] = 0.0
        dx2, dattn = sb.ffn_out_bwd_plain(attn, tok, dout, ws)[:2]
        _, q, k, v = sb.ln_qkv_plain(tok, pe_tok, ws)
        dq, dk, dv = sb.window_attn_bwd_plain(q, k, v, attn, dattn, m, l, H, K)
        del q, k, v, dattn
        d_args = (tok, pe_tok, dq, dk, dv, dx2)
        ref = sb.qkv_ln_bwd_plain(*d_args, ws)
        cases.append((f"K3.d spa_qkv_ln_bwd {[V, h, w, C]}", ref, ref,
                      sb.qkv_ln_bwd_plain(*(u.double() for u in d_args), ws64),
                      lambda: o_qkv(*d_args, ws), lambda: sb.qkv_ln_bwd(*d_args, ws),
                      ("dtok", "dtokpe", "dln1 sums")))
        steps = list(sb._KERNEL_STEPS)
        s_args = (xs, pe_tok, ws, tok, m, l, attn, dout, H, K)

        def k3_chain(step_d):
            steps[3] = step_d
            return sb._bwd(tuple(steps), *s_args)

        chains.append((f"K3 chained (5 steps + 8 wgrad + 3 colsum) {[V, h, w, C]}",
                       sb.spa_block_bwd_plain(*s_args), lambda: k3_chain(o_qkv),
                       lambda: k3_chain(sb.qkv_ln_bwd), "qkv_ln_bwd"))

        for what, ref, own, exact, other, this, names in cases:
            e_f32 = [_err(r, e) for r, e in zip(own, exact)]
            errs = []
            for fn in (other, this):
                got = _summed(fn())
                for i, (u, r) in enumerate(zip(got, ref)):
                    lim = TRAIN_REL * float(r.abs().max())
                    if not u.shape == r.shape or not _err(u, r) <= lim:
                        raise AssertionError(f"{what}: a build disagrees with the plain version "
                                             f"at {names[i]} ({_err(u, r):.3e} > {lim:.3e})")
                errs.append([_err(u, e) for u, e in zip(got, exact)])
                if not all(torch.equal(u, r) for u, r in zip(fn(), fn())):
                    raise AssertionError(f"{what}: a build does not repeat bitwise")
                del got
            tm = [device_ms(other), device_ms(this), device_ms(this), device_ms(other)]
            f64 = "; ".join(f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} "
                            f"(this / plain {et / max(ep, 1e-30):.3f}x)"
                            for n, eo, et, ep in zip(names, errs[0], errs[1], e_f32))
            print(f"{what}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / {tm[2]:.4f} ms"
                  f"; max |out - float64|: {f64}", flush=True)
        del cases

        for what, ref, other, this, kern in chains:
            for fn in (other, this):
                for i, (u, r) in enumerate(zip(fn(), ref)):
                    if not _err(u, r) <= TRAIN_REL * float(r.abs().max()) + 2e-9:
                        raise AssertionError(f"{what}: a build disagrees with the plain chain at "
                                             f"output {i} ({_err(u, r):.3e})")
            t = [(device_ms(fn), device_ms(fn, kernel=kern) if kern else None)
                 for fn in (other, this, this, other)]
            within = "" if kern is None else (
                f"; its step d within: other {t[0][1]:.4f} / {t[3][1]:.4f} ms, this "
                f"{t[1][1]:.4f} / {t[2][1]:.4f} ms")
            print(f"{what}: other {t[0][0]:.4f} / {t[3][0]:.4f} ms, this {t[1][0]:.4f} / "
                  f"{t[2][0]:.4f} ms{within}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
