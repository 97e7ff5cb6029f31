"""Time and profile the train step on one CUDA card.

    python3 -m lft_torch.profile_train [--steps N] [--seed S] [--plain] [--unfused]
        [--ang-res A] [--batch B] [--dtype float32|mixed|bfloat16]
        [--matmul-precision default|high|highest]

The 4x recipe (runs/ref_recipe_s4): LFT at full width (C=64, 8 heads, 4
AltFilter blocks, 5x5 views) from the 4x demo checkpoint, Adam 2e-4,
batch 4 of 32x32-view patches made on the card by `synth_batch`
(`--ang-res` and `--batch` change the views and the batch: `--ang-res 12
--batch 2` is `chip_smoke.py`'s 12x12-view step, which the fused blocks'
gate sends to the per-op branch, K8 and K5, with or without `--unfused`):

* steady-state ms per train step (host clock around steps that end in
  `torch.cuda.synchronize()`, after two warm-up steps);
* a `torch.profiler` trace of one step: device time by kernel name, the
  device's busy time and its idle share of the wall time, and the device
  time of the weight-grad and column-sum reductions (`wgrad`, `colsum`).

`--dtype mixed` trains under lft_tpu's mixed plans: the fused backward's
products over bf16 operands (the `_bf16` instances of K3, K4 and `wgrad`;
with `--plain` their plain versions); `--matmul-precision high` turns TF32
on for the torch ops around the kernels. `--dtype bfloat16` trains the
bf16 model (lft_tpu's all-bf16 mode): the fused blocks' `_bf16io` kernels,
K1 res, K2 res, K4, K3 and `wgrad_bf16io` (with `--plain` their plain
versions), or with `--unfused` the per-op branch's `_res_bf16io` forms and
`_bwd_bf16io` backwards (K7 + K5, or the knobs' families), the master
weights and Adam state f32.
`--plain` trains through the blocks' plain PyTorch versions and backwards
instead of the kernels; `--unfused` trains the per-op branch
(`--train_fused false`): the attentions as the kernels K7 and K5 with their
kernel backwards, or with `--plain` as the tiled torch ops under autograd.
The environment variables `LFT_ANG_VARIANT=sweep` and
`LFT_SPA_VARIANT=offset|mxu` send that branch through K8, K9 or K6 instead
(`LFT_SPA_VARIANT=tile`, K10, is inference only: a train step under it
raises); the kernels a step launched are printed.
Prints the card's name and power limit first.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--ang-res", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="float32", choices=["float32", "mixed", "bfloat16"])
    ap.add_argument("--matmul-precision", default="default",
                    choices=["default", "high", "highest"])
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.device import matmul_precision, resolve_device
    from lft_torch.models.lft import forward
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.profile_scene import path_kw, report, variant_knobs
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device(None, matmul_precision(a))
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    kw, what = path_kw(a.plain, a.unfused)
    args = Args(angRes=a.ang_res, scale_factor=4, channels=64, batch_size=a.batch, lr=2e-4,
                train_fused="false" if a.unfused else "true",
                attention_impl=kw.get("attention_impl", "auto"), dtype=a.dtype,
                matmul_precision=a.matmul_precision)
    model = get_model(args)
    if a.plain and not a.unfused:
        model = dataclasses.replace(model, apply=functools.partial(forward, plain_blocks=True))
    for p in params.values():
        p.requires_grad_(True)
    step = make_train_step(model, make_optimizer(params, args, steps_per_epoch=1000), args)
    gen = torch.Generator(device=dev).manual_seed(a.seed)
    batches = [synth_batch(gen, batch=a.batch, ang_res=a.ang_res, patch=32, scale=4)
               for _ in range(a.steps + 3)]

    for lr, hr in batches[:2]:                 # warm-up
        reset_launches()
        step(params, lr, hr)
    torch.cuda.synchronize()
    print(f"variants {variant_knobs()}; kernel launches of one step: "
          f"{ {k: n for k, n in LAUNCHES.items() if n} }", flush=True)
    times = []
    for lr, hr in batches[2:-1]:
        t0 = time.perf_counter()
        step(params, lr, hr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    print(f"train step ({what}, batch {a.batch}, {a.ang_res}x{a.ang_res} views, 4x, C=64): "
          f"median {med * 1e3:.3f} ms over {len(times)} steps (all: "
          f"{[round(t * 1e3, 3) for t in times]})", flush=True)

    from torch.profiler import ProfilerActivity, profile
    lr, hr = batches[-1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, lr, hr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, "one step", top=25)
    names = ("wgrad_kernel", "wgrad_taps_kernel", "wgrad_bf16io_kernel",
             "wgrad_bf16io_taps_kernel", "colsum_kernel")
    red = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
           and any(n in e.key for n in names)]
    print(f"weight-grad and column-sum reductions (wgrad.cu) in the traced step: "
          f"{sum(e.device_time_total for e in red) / 1e3:.3f} ms device time, "
          f"{sum(e.count for e in red)} kernel launches", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
