"""Time and profile full-scene SR on one CUDA card.

    python3 -m lft_torch.profile_scene [--scenes N] [--seed S] [--plain]

Loads the full-width 4x demo checkpoint, makes `--scenes` synthetic 5x5
scenes of 128x128 LR views, and runs the tiled pipeline (patch 32, stride
16, 16 patches a forward) on the card:

* steady-state seconds per scene (host clock around work that ends in
  `torch.cuda.synchronize()`, after one warm-up scene) and HR SAI
  megapixels per second;
* a `torch.profiler` trace of one scene: device time by kernel name, the
  device's busy time and its idle share of the wall time.

`--plain` runs the blocks' plain PyTorch versions instead of the kernels.
Prints the card's name and power limit first. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plain", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_scene: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.config import Args
    from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
    from lft_torch.device import resolve_device
    from lft_torch.inference.tiled import ScenePipelineCache
    from lft_torch.models.lft import forward
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    params, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                             "LFT_5x5_4x_synth3000.pth"), device=dev)
    args = Args(angRes=5, scale_factor=4, channels=64, patch_size_for_test=32,
                stride_for_test=16, eval_batch=16)
    cache = ScenePipelineCache(forward, args, eval_batch=16, plain_blocks=a.plain)
    lrs = [torch.from_numpy(lr_hr_pair(synth_lf_scene(5, 512, 512, seed=a.seed + i), 4)[0])
           .to(dev) for i in range(a.scenes)]
    mpx = (lrs[0].shape[0] * 4) * (lrs[0].shape[1] * 4) / 1e6

    cache(params, lrs[0])                      # warm-up
    torch.cuda.synchronize()
    times = []
    for lr in lrs:
        t0 = time.perf_counter()
        cache(params, lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    print(f"scene SR ({'plain blocks' if a.plain else 'kernels'}): median "
          f"{med * 1e3:.2f} ms/scene over {len(times)} scenes (all: "
          f"{[round(t * 1e3, 2) for t in times]}), {mpx / med:.3f} HR MPx/s", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cache(params, lrs[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows) / 1e3
    if not rows:
        print("profile: no device time in the trace (not measured)")
        return 0
    print(f"profile of one scene: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / (wall * 1e3):.3f}")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / 1e3 / busy:5.1f}%  x{n:<4d} {key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
