"""Time this checkout's K3.a and K2.3 kernels against another revision's, in
turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_bwd OTHER_SPA_BLOCK_CU OTHER_SPA_BLOCK_BWD_CU \
        [--other-ang OTHER_ANG_BLOCK_CU]

The sources are `spa_block.cu` and `spa_block_bwd.cu` of a revision whose
K3.a `spa_ffn_out_bwd` still runs on the FP32 pipes (`gemm_acc`, 64-row
blocks, no weight scratch) and whose K2.3 `spa_window_attn[_res]` takes one
head of one 16 x 16 tile a block: the port at commit a215b91. Its C
interfaces: `lft_spa_ffn_out_bwd(attn, tok, dout, ln, wo, w1, w2, wlinT,
w2T, w1T, woT, dx2, dattn, y, dy, hid, dpre, xn2, ln_part, T, C, stream)`
with ln_part [ceil(T / 64), 2, D], `lft_spa_window_attn(q, k, v, attn, V,
h, w, D, H, scale, stream)` and `lft_spa_window_attn_res(q, k, v, attn, m,
l, V, h, w, D, H, scale, stream)`. Unpack the revision's whole
`lft_torch/csrc` (`git archive <commit> lft_torch/csrc`) into a git-ignored
directory, so that its headers come with it. Each source is built with the
port's nvcc flags into a temporary directory.

First the ptxas report of both builds: registers and spills of every
kernel, for the kernels neither redesign touched to be read side by side
(with `--other-ang`, K1's and K4's `ang_block.cu` too, whose shared
`rowgemm.cuh` changed). Then, with the demo checkpoint's block-0 weights
and the block's own activations (ReLU flips between the versions given a
zero cotangent, as chip_smoke.py does): K3.a at [100, 32, 32, 64] (a fused
train step), K2.3 at [400, 32, 32, 64] (a scene's chunk) and K2.3 res at
[100, 32, 32, 64]. Both builds are checked against the plain version (K3.a
within 5e-4 max |plain| per output, its LN2 sums summed over their rows;
K2.3 within 1e-4 max(1, max |plain|)) and for a bitwise repeat; their max
error against float64 is printed per output beside the f32 plain
version's (TF32 off); both are timed in device time
(`profile_scene.device_ms`) in the order other, this, this, other, beside
SDPA with a window mask for K2.3 (context: no port calls it). Then the K2
chain at [400, 32, 32, 64] and the K11 chain at [16, 32, 32, 25, 64] with
step 3 of either build, and the K3 chain (five steps, 8 wgrad, 3 colsum)
at [100, 32, 32, 64] with step a of either build, the other steps this
checkout's, in the same turns, each held to its plain chain: the chain's
device time and, within it, that of the swapped step. Prints the card's
name and power limit first. Exits non-zero without a card.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ATOL = 1e-4     # forwards: max |diff| <= 1e-4 max(1, max |plain|)
TRAIN_REL = 5e-4       # the backward step: max |diff| <= 5e-4 max |plain|, per output


def ptxas_report(log: str) -> dict:
    """{kernel: (registers, spill stores, spill loads)} from nvcc's -Xptxas
    -v output, kernels by demangled name (anonymous namespaces and `lft::`
    dropped, so a kernel that moved into a header keeps its name)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, [0, 0, 0])[0] = int(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True, text=True)
    plain = names.stdout.splitlines() if names.returncode == 0 else list(out)
    clean = lambda n: re.sub(r"\(anonymous namespace\)::|_GLOBAL__N_\w+::|\blft::", "",
                             n).split("(")[0]
    return {clean(p): tuple(v) for p, v in zip(plain, out.values())}


def _build_other(src: str, build_dir: str, name: str):
    """(library, ptxas output) of another revision's source."""
    from lft_torch.kernels import _build
    so = os.path.join(build_dir, f"lib{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.SRC_DIR, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(so), proc.stdout + proc.stderr


def _print_ptxas(what: str, other_log: str, this_log: str) -> None:
    a, b = ptxas_report(other_log), ptxas_report(this_log)
    for k in sorted(set(a) | set(b)):
        fmt = lambda r: "-" if r is None else f"{r[0]} registers, spills {r[1]}/{r[2]} B"
        same = "same" if a.get(k) == b.get(k) else "differs"
        print(f"ptxas {what} {k}: other {fmt(a.get(k))}; this {fmt(b.get(k))} [{same}]",
              flush=True)


def _wrap_other(spa, bwd):
    """(ffn_out_bwd, window_attn) of the other revision, with this
    checkout's wrappers' arguments and outputs (its LN2 sums one row a
    64-row block)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bwd.lft_spa_ffn_out_bwd.argtypes = [P] * 19 + [I] * 2 + [P]
    spa.lft_spa_window_attn.argtypes = [P] * 4 + [I] * 5 + [F, P]
    spa.lft_spa_window_attn_res.argtypes = [P] * 6 + [I] * 5 + [F, P]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc:
            raise RuntimeError(f"the other {what} failed to launch ({rc})")

    def ffn_out_bwd(attn, tok, dout, wts):
        from lft_torch.kernels.spa_block import _bwd_weights
        *lead, D = tok.shape
        T = tok.numel() // D
        wt = _bwd_weights(wts)
        e = lambda n: torch.empty(*lead, n, device=tok.device)
        outs = (e(D), e(D), e(D), e(D), e(2 * D), e(2 * D), e(D),
                torch.empty((T + 63) // 64, 2, D, device=tok.device))
        ins = (attn, tok, dout, wts["ln"], wts["wo"], wts["w1"], wts["w2"], wt["wlinT"],
               wt["w2T"], wt["w1T"], wt["woT"])
        check(bwd.lft_spa_ffn_out_bwd(*(t.data_ptr() for t in (*ins, *outs)), T, D // 2,
                                      stream()), "spa_ffn_out_bwd")
        return outs

    def window_attn(q, k, v, num_heads, ksize, with_stats=False):
        V, h, w, D = q.shape
        attn = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), attn.data_ptr()]
        tail = (V, h, w, D, num_heads, float(D // num_heads) ** -0.5, stream())
        if not with_stats:
            check(spa.lft_spa_window_attn(*ptrs, *tail), "spa_window_attn")
            return attn
        m = torch.empty(V, h, w, num_heads, device=q.device)
        l = torch.empty_like(m)
        check(spa.lft_spa_window_attn_res(*ptrs, m.data_ptr(), l.data_ptr(), *tail),
              "spa_window_attn_res")
        return attn, m, l

    return ffn_out_bwd, window_attn


def _err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def _tuple(t):
    return t if isinstance(t, tuple) else (t,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_spa", help="path of the other revision's spa_block.cu")
    ap.add_argument("other_bwd", help="path of the other revision's spa_block_bwd.cu")
    ap.add_argument("--other-ang", help="path of the other revision's ang_block.cu (ptxas only)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_bwd: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask
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
    C, h, w, H, K = 64, 32, 32, 8, 5
    D = 2 * C
    g = torch.Generator(device=dev).manual_seed(0)
    spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev)
    pe_tok = unfold3x3_linear(spa_pe[None], ws["mlp"])[0].contiguous()
    with tempfile.TemporaryDirectory() as tmp:
        spa, spa_log = _build_other(a.other_spa, tmp, "other_spa_block")
        bwd, bwd_log = _build_other(a.other_bwd, tmp, "other_spa_block_bwd")
        read = lambda n: open(paths[n] + ".log").read()
        _print_ptxas("spa_block.cu", spa_log, read("spa_block"))
        _print_ptxas("spa_block_bwd.cu", bwd_log, read("spa_block_bwd"))
        if a.other_ang:
            _print_ptxas("ang_block.cu", _build_other(a.other_ang, tmp, "other_ang_block")[1],
                         read("ang_block"))
        o_ffn_bwd, o_window = _wrap_other(spa, bwd)

        # the block's own activations: scene chunk [400, ...] and train batch [100, ...]
        acts = {}
        for V in (400, 100):
            xs = torch.randn(V, h, w, C, device=dev, generator=g)
            _, tok, m, l, attn = sb.spa_block_plain(xs, pe_tok, ws, H, K, with_res=True)
            _, q, k, v = sb.ln_qkv_plain(tok, pe_tok, ws)
            acts[V] = dict(xs=xs, tok=tok, m=m, l=l, attn=attn, q=q, k=k, v=v)
            del xs, tok, m, l, attn, q, k, v
        tr = acts[100]
        dout = torch.randn(100, h, w, C, device=dev, generator=g)
        hid = lambda f: f(tr["attn"], tr["tok"], dout, ws)[4]
        flips = ((hid(sb.ffn_out_bwd) > 0) != (hid(sb.ffn_out_bwd_plain) > 0)).any(-1)
        print(f"K3.a: {int(flips.sum())} tokens with a ReLU flip, given a zero cotangent",
              flush=True)
        dout[flips] = 0.0
        summed = lambda o: (*o[:-1], o[-1].sum(0, keepdim=True))
        cases = []
        ref = sb.ffn_out_bwd_plain(tr["attn"], tr["tok"], dout, ws)
        cases.append(("K3.a spa_ffn_out_bwd [100, 32, 32, 64]", ref,
                      sb.ffn_out_bwd_plain(tr["attn"].double(), tr["tok"].double(), dout.double(),
                                           ws64),
                      lambda: o_ffn_bwd(tr["attn"], tr["tok"], dout, ws),
                      lambda: sb.ffn_out_bwd(tr["attn"], tr["tok"], dout, ws), summed, None,
                      ("dx2", "dattn", "y", "dy", "hid", "dpre", "xn2", "dln2 sums")))
        for V, stats in ((400, False), (100, True)):
            t = acts[V]
            q, k, v = t["q"], t["k"], t["v"]
            ref = _tuple(sb.window_attn_plain(q, k, v, H, K) if stats else
                         sb.windowed_attention(q, k, v, H, K))
            exact = sb.window_attn_plain(q.double(), k.double(), v.double(), H, K)
            mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
            heads = lambda x, V=V: x.reshape(V, h * w, H, D // H).transpose(1, 2)
            cases.append((f"K2.3 spa_window_attn{'_res' if stats else ''} {[V, h, w, C]}", ref,
                          exact[:len(ref)],
                          lambda q=q, k=k, v=v, s=stats: o_window(q, k, v, H, K, s),
                          lambda q=q, k=k, v=v, s=stats: sb.window_attn(q, k, v, H, K, s),
                          lambda o: _tuple(o),
                          lambda q=q, k=k, v=v, hd=heads: F.scaled_dot_product_attention(
                              hd(q), hd(k), hd(v), attn_mask=mask),
                          ("attn", "m", "l")))
        for what, ref, exact, other, this, norm, lib, names in cases:
            e_f32 = [_err(r, e) for r, e in zip(ref, exact)]
            errs = []
            for fn in (other, this):
                got = norm(fn())
                for i, (u, r) in enumerate(zip(got, ref)):
                    lim = (TRAIN_REL * float(r.abs().max()) if what.startswith("K3")
                           else KERNEL_ATOL * max(1.0, float(r.abs().max())))
                    if not u.shape == r.shape or not _err(u, r) <= lim:
                        raise AssertionError(f"{what}: a build disagrees with the plain version "
                                             f"at {names[i]} ({_err(u, r):.3e} > {lim:.3e})")
                errs.append([_err(u, e) for u, e in zip(got, exact)])
                if not all(torch.equal(u, r) for u, r in zip(_tuple(fn()), _tuple(fn()))):
                    raise AssertionError(f"{what}: a build does not repeat bitwise")
                del got
            tm = [device_ms(other), device_ms(this), device_ms(this), device_ms(other)]
            lib_note = "" if lib is None else f", SDPA with a window mask {device_ms(lib, 5):.4f} ms"
            f64 = "; ".join(f"{n} other {eo:.3e}, this {et:.3e}, f32 plain {ep:.3e} "
                            f"(this / plain {et / max(ep, 1e-30):.3f}x)"
                            for n, eo, et, ep in zip(names, errs[0], errs[1], e_f32))
            print(f"{what}: other {tm[0]:.4f} / {tm[3]:.4f} ms, this {tm[1]:.4f} / {tm[2]:.4f} ms"
                  f"{lib_note}; max |out - float64|: {f64}", flush=True)

        # the chains, with the swapped step of either build
        sc = acts[400]
        xp = torch.randn(16, h, w, 25, C, device=dev, generator=g)

        def fwd_chain(x, window, views):
            tok, xn = sb.tokenize_ln(x, pe_tok, ws, views is not None)
            q, k, v = sb.qkv(xn, tok, ws)
            x2, xn2 = sb.outproj_ln(window(q, k, v, H, K), tok, ws)
            return sb.ffn_out(xn2, x2, ws, views)

        steps = list(sb._KERNEL_STEPS)
        chains = [("K2 chained", sc["xs"], None, sb.spa_block_plain(sc["xs"], pe_tok, ws, H, K),
                   "spa_window_attn_kernel", 1e-4),
                  ("K11 chained", xp, 25,
                   sb._to_pixel_major(sb.spa_block_plain(sb._to_view_major(xp), pe_tok, ws, H, K),
                                      25), "spa_window_attn_kernel", 1e-4)]
        for what, x, views, ref, step, tol in chains:
            other = lambda x=x, views=views: fwd_chain(x, o_window, views)
            this = lambda x=x, views=views: fwd_chain(x, sb.window_attn, views)
            lim = tol * max(1.0, float(ref.abs().max()))
            for fn in (other, this):
                if not _err(fn(), ref) <= lim:
                    raise AssertionError(f"{what}: a build disagrees with the plain chain")
            t = [(device_ms(fn), device_ms(fn, kernel=step)) for fn in (other, this, this, other)]
            print(f"{what} {list(x.shape)}: other {t[0][0]:.4f} / {t[3][0]:.4f} ms, this "
                  f"{t[1][0]:.4f} / {t[2][0]:.4f} ms; its step 3 within: other {t[0][1]:.4f} / "
                  f"{t[3][1]:.4f} ms, this {t[1][1]:.4f} / {t[2][1]:.4f} ms", flush=True)
        del sc, xp, chains

        args = (tr["xs"], pe_tok, ws, tr["tok"], tr["m"], tr["l"], tr["attn"], dout, H, K)
        ref = sb.spa_block_bwd_plain(*args)

        def bwd_chain(step_a):
            steps[0] = step_a
            return sb._bwd(tuple(steps), *args)

        other, this = (lambda: bwd_chain(o_ffn_bwd)), (lambda: bwd_chain(sb.ffn_out_bwd))
        for fn in (other, this):
            for i, (u, r) in enumerate(zip(fn(), ref)):
                if not _err(u, r) <= TRAIN_REL * float(r.abs().max()) + 2e-9:
                    raise AssertionError(f"K3 chained: a build disagrees with the plain chain at "
                                         f"output {i} ({_err(u, r):.3e})")
        t = [(device_ms(fn), device_ms(fn, kernel="spa_ffn_out_bwd_kernel"))
             for fn in (other, this, this, other)]
        print(f"K3 chained (5 steps + 8 wgrad + 3 colsum) [100, 32, 32, 64]: other "
              f"{t[0][0]:.4f} / {t[3][0]:.4f} ms, this {t[1][0]:.4f} / {t[2][0]:.4f} ms; its step "
              f"a within: other {t[0][1]:.4f} / {t[3][1]:.4f} ms, this {t[1][1]:.4f} / "
              f"{t[2][1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
