"""Time and profile full-scene SR on one CUDA card.

    python3 -m lft_torch.profile_scene [--scenes N] [--seed S] [--plain] [--unfused]
        [--ang-res A] [--view V] [--patch P] [--dtype float32|mixed|bfloat16]
        [--matmul-precision default|high|highest]

Loads the full-width 4x demo checkpoint, makes `--scenes` synthetic A x A
scenes of V x V LR views (5x5 and 128x128 by default), and runs the tiled
pipeline (patch P, stride P / 2, 16 patches a forward; P = 32 by default)
on the card:

* steady-state seconds per scene (host clock around work that ends in
  `torch.cuda.synchronize()`, after one warm-up scene) and HR SAI
  megapixels per second;
* a `torch.profiler` trace of one scene: device time by kernel name, the
  device's busy time and its idle share of the wall time.

`--plain` runs the blocks' plain PyTorch versions instead of the kernels.
`--dtype mixed` runs lft_tpu's mixed plans (a forward at the default plan
is the f32 one; with `LFT_MM_HP_SITES=none` in the environment the fused
blocks' bf16-operand kernels, `kernels.MIXED_FWD`), `--dtype bfloat16` the bf16 model (the blocks' `_bf16io`
kernels; with `--unfused` the per-op forwards' `_bf16io` kernels);
`--matmul-precision high` turns TF32 on for the torch ops around the
kernels.
`--unfused` runs the per-op branch (`fused=False`): the attentions as the
kernels K7 and K5, or with `--plain` as the tiled torch ops. The environment
variables `LFT_ANG_VARIANT=sweep` and `LFT_SPA_VARIANT=offset|mxu|tile` send
that branch through K8, K9, K6 or K10 instead (`tile`, K10, is inference
only); the kernels a scene launched are printed. Past 11x11 views the
fused blocks' gate sends every call to the per-op branch (`--ang-res 12
--view 48`: K8 and K5, `chip_smoke.py`'s 12x12-view scene). At `--patch 64`
the views hold 4096 pixels: the per-op branch takes K6 there with no knob
set (`--unfused --patch 64`: K7 and K6, `chip_smoke.py`'s patch-64 scene).
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
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--ang-res", type=int, default=5)
    ap.add_argument("--view", type=int, default=128)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--dtype", default="float32", choices=["float32", "mixed", "bfloat16"])
    ap.add_argument("--matmul-precision", default="default",
                    choices=["default", "high", "highest"])
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_scene: no CUDA device is available", file=sys.stderr)
        return 1

    from lft_torch.config import Args
    from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
    from lft_torch.device import matmul_precision, resolve_device
    from lft_torch.inference.tiled import ScenePipelineCache
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.utils.checkpoint import load_checkpoint

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device(None, matmul_precision(a))
    params, _, _ = load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                                "LFT_5x5_4x_synth3000.pth"), device=dev)
    args = Args(angRes=a.ang_res, scale_factor=4, channels=64, patch_size_for_test=a.patch,
                stride_for_test=a.patch // 2, eval_batch=16, dtype=a.dtype,
                matmul_precision=a.matmul_precision)
    kw, what = path_kw(a.plain, a.unfused)
    cache = ScenePipelineCache(forward, args, eval_batch=16, **kw)
    hr_view = 4 * a.view
    lrs = [torch.from_numpy(lr_hr_pair(synth_lf_scene(a.ang_res, hr_view, hr_view,
                                                      seed=a.seed + i), 4)[0])
           .to(dev) for i in range(a.scenes)]
    mpx = (lrs[0].shape[0] * 4) * (lrs[0].shape[1] * 4) / 1e6

    reset_launches()
    cache(params, lrs[0])                      # warm-up
    torch.cuda.synchronize()
    print(f"variants {variant_knobs()}; kernel launches of one scene: "
          f"{ {k: n for k, n in LAUNCHES.items() if n} }", flush=True)
    times = []
    for lr in lrs:
        t0 = time.perf_counter()
        cache(params, lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    print(f"scene SR ({what}): median "
          f"{med * 1e3:.2f} ms/scene over {len(times)} scenes (all: "
          f"{[round(t * 1e3, 2) for t in times]}), {mpx / med:.3f} HR MPx/s", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cache(params, lrs[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, "one scene", top=20)
    return 0


def path_kw(plain: bool, unfused: bool):
    """(keywords of `forward`, a name) for the path the flags select."""
    if unfused:
        return (dict(fused=False, attention_impl="tiled" if plain else "pallas"),
                "unfused, tiled torch attention" if plain else "unfused, per-op kernels")
    return dict(plain_blocks=plain), "plain blocks" if plain else "kernels"


def variant_knobs() -> dict:
    """The per-op dispatchers' environment knobs as they are set."""
    return {k: os.environ.get(k, "unset") for k in ("LFT_ANG_VARIANT", "LFT_SPA_VARIANT")}


def report(prof, wall: float, what: str, top: int) -> None:
    """Device busy time and idle share of a traced window of `wall`
    seconds, and its `top` kernels by device time."""
    rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        print("profile: no device time in the trace (not measured)")
        return
    busy = sum(r[1] for r in rows) / 1e3
    print(f"profile of {what}: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / (wall * 1e3):.3f}")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / 1e3 / busy:5.1f}%  x{n:<4d} {key[:100]}")


def kernel_times(fn, reps: int = 20, kernel: str = "", tries: int = 3) -> dict:
    """{kernel name: (device ms a call, launches a call)} of `fn()` in a
    profiler trace of `reps` back-to-back calls after two warm-ups; with
    `kernel`, only the kernels whose name holds it. CUPTI now and then
    hands the profiler no kernel records for a whole trace, or only some of
    them (late in a long process: a kernel counted fewer times than the
    calls launch it, its time below its bound): such a trace is taken
    again, up to `tries` traces in all, and {} means none saw every
    launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        avgs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key
                and e.device_time_total > 0]
        lost = [e.key for e in avgs if e.count % reps]
        if avgs and not lost:
            return {e.key: (e.device_time_total / 1e3 / reps, e.count / reps) for e in avgs}
        if lost:
            print(f"kernel_times: a trace of {reps} calls lost launches of {lost[0][:60]!r}; "
                  f"traced again", flush=True)
    return {}


def device_ms(fn, reps: int = 20, kernel: str = "") -> float:
    """Device milliseconds of one `fn()`: the CUDA kernels' time in a
    profiler trace of `reps` back-to-back calls after two warm-ups, over
    `reps` (`kernel_times`, which traces again where CUPTI recorded
    nothing). The host's launch path is not in it, which at tens of
    microseconds a kernel would be in a CUDA-event time of one call. With
    `kernel`, only the kernels whose name holds it.

    If no trace saw every launch, the time is that of CUDA events around
    the `reps` calls (which holds the host's launch gaps too), and a line
    says so. A `kernel` filter has no such fallback and raises."""
    tries = 3
    rows = kernel_times(fn, reps, kernel, tries)
    if rows:
        return sum(ms for ms, _ in rows.values())
    if kernel:
        raise AssertionError(f"the profiler saw no device time of {kernel!r} in {tries} traces")
    ms = events_ms(fn, reps, warmup=0)
    print(f"device_ms: no trace of {tries} saw every launch; CUDA events over "
          f"{reps} back-to-back calls instead: {ms:.4f} ms a call", flush=True)
    return ms


def events_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Milliseconds of one `fn()` by CUDA events around `reps` back-to-back
    calls after `warmup` more: the card's time where each call keeps it
    busy longer than its launch takes the host (the host's gaps hide behind
    the queue), the host's otherwise."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int = 20, flush_mb: int = 512) -> float:
    """Median milliseconds of one `fn()` by CUDA events around it, each call
    after a `flush_mb` MB write that evicts the 50 MB L2, so that its inputs
    come from device memory. The write runs before the first event and takes
    the card longer (~0.2 ms) than the host takes to queue the call's
    launches behind it, so no host gap enters the time."""
    flush = torch.empty(flush_mb * 1024 * 1024 // 4, device="cuda")
    times = []
    for i in range(reps + 2):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


if __name__ == "__main__":
    sys.exit(main())
