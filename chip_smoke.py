#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lft_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

1. builds the hand-written CUDA kernels from `lft_torch/csrc/` (nvcc,
   sm_90a, into `lft_torch/build/`) and prints their register/spill report;
2. loads the full-width 4x demo checkpoint (C=64, 5x5 views) onto the card;
3. makes two 5x5 scenes of 128x128 LR views from `--seed` (synthetic light
   fields, LR by Matlab-bicubic imresize);
4. runs `evaluate_dataset` (tiled SR, patch 32, stride 16, 16 patches per
   forward: 64 patches = 4 chunks a scene) with every launch counter at 0,
   and prints PSNR/SSIM of the model and of the bicubic skip alone;
5. runs the same scenes through the port's plain path on the card (the
   same forward with the blocks' plain PyTorch versions) and requires
   max |SR diff| <= 1e-3 and |dPSNR| <= 0.01 dB: the two sum f32 products
   in a different order, nothing more;
6. holds every kernel against its plain version at the shapes the main
   path gives it (K1 [16384, 25, 64], K2 [400, 32, 32, 64]) and times both
   with CUDA events (median after warm-up), beside the card's bound;
7. prints the `kernels` JSON line, the card's name and power limit, and
   last `{"ok": true, "device": {...}}`.

Every check raises; the script exits non-zero on any failure, without a
CUDA card, and when run outside the repository.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "examples", "synth_demo", "LFT_5x5_4x_synth3000.pth")
# Published dense rates without tensor cores (FP32 FLOP/s, memory B/s),
# keyed by a fragment of the card's name; an H100 SXM unless named.
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12)}
PEAK_SXM = (67e12, 3.35e12)
# per kernel: max |kernel - plain| <= KERNEL_ATOL * max(1, max |plain|); both sum
# the same f32 products in another order
KERNEL_ATOL = 1e-4


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for frag, p in PEAKS.items():
        if frag in name:
            return p
    return PEAK_SXM


def timed(fn, reps: int = 10, warmup: int = 2):
    """Median milliseconds of `fn()` over `reps` launches, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def max_err(got, ref):
    """(max |got - ref| over the outputs, whether every output is within
    KERNEL_ATOL * max(1, max |ref|))."""
    import torch
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    worst, ok = 0.0, True
    for g, r in zip(got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"bad kernel output: shape {tuple(g.shape)} vs {tuple(r.shape)}")
        err = float((g - r).abs().max())
        ok = ok and err <= KERNEL_ATOL * max(1.0, float(r.abs().max()))
        worst = max(worst, err)
    return worst, ok


def valid_window_pairs(h: int, w: int, r: int) -> int:
    """(query, key) pairs of a (2r+1)^2 window inside an h x w image."""
    cy = sum(min(y + r, h - 1) - max(y - r, 0) + 1 for y in range(h))
    cx = sum(min(x + r, w - 1) - max(x - r, 0) + 1 for x in range(w))
    return cy * cx


def kernel_checks(params, card: str, launches: dict, n_scenes: int, seed: int) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask, windowed_attention
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear

    flops_peak, bw_peak = peaks(card)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    D = 2 * C
    N = 16 * h * w              # pixels of one chunk of 16 patches
    V = 16 * A2                 # views of one chunk
    T = V * h * w

    def bound(flops, nbytes):
        t_ops, t_mem = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []

    def record(name, src, replaces, got, ref, fn_k, fn_p, flops, io, lib_fn=None):
        err, ok = max_err(got, ref)
        ms_k, ms_p = timed(fn_k), timed(fn_p)
        ms_l = timed(lib_fn) if lib_fn is not None else None
        b_ms, b_by = bound(flops, io)
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches[name], max_abs_err=err, ms=ms_k,
                         plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=ms_l))
        print(f"kernel {name}: max_abs_err {err:.3e} (limit {KERNEL_ATOL:g} x max|ref|) "
              f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), library {'-' if ms_l is None else f'{ms_l:.4f} ms'}, "
              f"launches {launches[name]} ({launches[name] / n_scenes:g}/scene)",
              flush=True)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"(max |diff| {err:.3e})")

    # K1 at [16384, 25, 64] with the checkpoint's block-0 weights
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    x = torch.randn(N, A2, C, device=dev, generator=g)
    pe = torch.from_numpy(angular_position(A2, C)).to(dev)
    got = ab.ang_block(x, pe, wa, H)
    ref = ab.ang_block_plain(x, pe, wa, H)
    fl = 2 * N * A2 * 8 * C * C + 4 * N * A2 * A2 * C
    io = nbytes(x, pe, got, *wa.values())
    record("ang_block", "lft_torch/csrc/ang_block.cu", "lft_tpu/kernels/ang_block.py:188",
           got, ref, lambda: ab.ang_block(x, pe, wa, H),
           lambda: ab.ang_block_plain(x, pe, wa, H), fl, io)

    # K2's five steps at [400, 32, 32, 64], each fed its plain predecessor's output
    ws = sb.spa_weights(params, "altblock.0.spa_trans.")
    xs = torch.randn(V, h, w, C, device=dev, generator=g)
    spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev)
    pe_tok = unfold3x3_linear(spa_pe[None], ws["mlp"])[0].contiguous()
    wbytes = lambda *k: sum(nbytes(ws[n]) for n in k)
    rep = "lft_tpu/kernels/spa_block.py:248"
    src = "lft_torch/csrc/spa_block.cu"

    tok, xn = sb.tokenize_ln_plain(xs, pe_tok, ws)
    record("spa_tokenize_ln", src, rep, sb.tokenize_ln(xs, pe_tok, ws), (tok, xn),
           lambda: sb.tokenize_ln(xs, pe_tok, ws),
           lambda: sb.tokenize_ln_plain(xs, pe_tok, ws),
           2 * T * 9 * C * D, nbytes(xs, pe_tok, tok, xn) + wbytes("wu", "ln"))

    q, k, v = sb.qkv_plain(xn, tok, ws)
    record("spa_qkv", src, rep, sb.qkv(xn, tok, ws), (q, k, v),
           lambda: sb.qkv(xn, tok, ws), lambda: sb.qkv_plain(xn, tok, ws),
           2 * T * D * 3 * D, nbytes(xn, tok, q, k, v) + wbytes("wqk", "wv"))

    attn = windowed_attention(q, k, v, H, K)
    pairs = V * valid_window_pairs(h, w, K // 2)
    mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
    heads = lambda t: t.reshape(V, h * w, H, D // H).transpose(1, 2)
    qh, kh, vh = heads(q), heads(k), heads(v)
    record("spa_window_attn", src, rep, sb.window_attn(q, k, v, H, K), attn,
           lambda: sb.window_attn(q, k, v, H, K),
           lambda: windowed_attention(q, k, v, H, K),
           4 * D * pairs, nbytes(q, k, v, attn),
           lib_fn=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))

    x2, xn2 = sb.outproj_ln_plain(attn, tok, ws)
    record("spa_outproj_ln", src, rep, sb.outproj_ln(attn, tok, ws), (x2, xn2),
           lambda: sb.outproj_ln(attn, tok, ws), lambda: sb.outproj_ln_plain(attn, tok, ws),
           2 * T * D * D, nbytes(attn, tok, x2, xn2) + wbytes("wo", "ln"))

    out = sb.ffn_out_plain(xn2, x2, ws)
    record("spa_ffn_out", src, rep, sb.ffn_out(xn2, x2, ws), out,
           lambda: sb.ffn_out(xn2, x2, ws), lambda: sb.ffn_out_plain(xn2, x2, ws),
           2 * T * (4 * D * D + D * C), nbytes(xn2, x2, out) + wbytes("w1", "w2", "wlin"))

    # the whole K2 block, kernels chained against plain chained
    got = sb.spa_block(xs, pe_tok, ws, H, K)
    err, ok = max_err(got, out)
    ms_k = timed(lambda: sb.spa_block(xs, pe_tok, ws, H, K))
    ms_p = timed(lambda: sb.spa_block_plain(xs, pe_tok, ws, H, K))
    print(f"block spa_trans (5 kernels chained): max_abs_err {err:.3e} "
          f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms", flush=True)
    if not ok:
        raise AssertionError(f"chained K2 disagrees with its plain version ({err:.3e})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import lft_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the lft_torch package is missing beside this script ({e})",
              file=sys.stderr)
        return 1
    import time

    import numpy as np
    from lft_torch.config import Args
    from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
    from lft_torch.device import resolve_device
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import LAUNCHES, build_all, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.ops.bicubic import bicubic_upscale_views
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.utils.checkpoint import load_checkpoint

    card = card_line()
    print(card, flush=True)
    dev = resolve_device()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    paths = build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for p in paths.values():
        with open(p + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "error" in line.lower():
                    print("  " + line.strip())

    params, _ = load_checkpoint(CKPT, device=dev)
    args = Args(angRes=5, scale_factor=4, channels=64, patch_size_for_test=32,
                stride_for_test=16, eval_batch=16)
    n_scenes = 2

    scenes = [lr_hr_pair(synth_lf_scene(5, 512, 512, seed=a.seed + i), 4)
              for i in range(n_scenes)]
    cache = ScenePipelineCache(forward, args, eval_batch=16)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    psnr, ssim, rows = evaluate_dataset(forward, params, args, scenes, cache=cache)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(LAUNCHES)
    print(f"SR model: PSNR {psnr:.6f} dB SSIM {ssim:.6f} over {n_scenes} scenes "
          f"({wall:.3f} s incl. first calls); per scene {rows}", flush=True)
    print(f"launches in the SR run: {counts}", flush=True)
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    bic = [cal_metrics(torch.from_numpy(hr).to(dev),
                       bicubic_upscale_views(torch.from_numpy(lr).to(dev), 5, 4), 5)
           for lr, hr in scenes]
    bic_psnr = float(np.mean([float(p) for p, _ in bic]))
    bic_ssim = float(np.mean([float(s) for _, s in bic]))
    print(f"bicubic skip alone: PSNR {bic_psnr:.6f} dB SSIM {bic_ssim:.6f}", flush=True)
    if not (math.isfinite(psnr) and psnr > bic_psnr):
        raise AssertionError(f"model PSNR {psnr} does not beat bicubic {bic_psnr}")

    plain = ScenePipelineCache(forward, args, eval_batch=16, plain_blocks=True)
    p_psnr, _, _ = evaluate_dataset(forward, params, args, scenes, cache=plain)
    worst = 0.0
    for lr, hr in scenes:
        lr_t = torch.from_numpy(lr).to(dev)
        sr_k, sr_p = cache(params, lr_t), plain(params, lr_t)
        if sr_k.shape != (lr.shape[0] * 4, lr.shape[1] * 4) \
                or not torch.isfinite(sr_k).all():
            raise AssertionError(f"bad SR mosaic {tuple(sr_k.shape)}")
        worst = max(worst, float((sr_k - sr_p).abs().max()))
    print(f"kernel path vs plain path on the card: max |SR diff| {worst:.3e} "
          f"(limit 1e-3), dPSNR {psnr - p_psnr:+.3e} dB (limit 0.01)", flush=True)
    if worst > 1e-3 or abs(psnr - p_psnr) > 0.01:
        raise AssertionError("kernel path disagrees with the plain path")

    rows = kernel_checks(params, card, counts, n_scenes, a.seed)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
