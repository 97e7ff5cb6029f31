"""Configuration / CLI flags (counterpart of lft_tpu/config.py, without JAX).

The reference-compatible flags are the same; the TPU-only knobs
(`--platform`, `--compile_cache_dir`, `--train_remat`) are replaced by an
explicit `device` argument of the entry points (`cuda` unless the caller
asks for `cpu`, see lft_torch/device.py). The data-parallel flags are
lft_tpu's, with one departure: a rank is one process on one device
(lft_torch/parallel/), so under `--coordinator` `--num_devices` is unset
or equals `--num_processes` (`check_parallel_flags`).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


def _reference_bool(v) -> bool:
    """argparse `type=bool` semantics of the reference (option.py:8): any
    non-empty string is truthy."""
    if isinstance(v, bool):
        return v
    return bool(v)


@dataclasses.dataclass
class Args:
    # Reference-compatible flags (reference option.py:4-25)
    angRes: int = 5
    scale_factor: int = 4
    model_name: str = "LFT"
    channels: int = 64
    use_pre_pth: bool = False
    path_pre_pth: str = "./pth/LFT_5x5_4x_epoch_50_model.pth"
    data_name: str = "ALL"
    path_for_train: str = "./data_for_train/"
    path_for_test: str = "./data_for_test/"
    path_log: str = "./log/"
    patch_size_for_test: int = 32
    stride_for_test: int = 16
    batch_size: int = 4
    lr: float = 2e-4
    decay_rate: float = 0.0
    n_steps: int = 15
    gamma: float = 0.5
    epoch: int = 50
    num_workers: int = 2
    local_rank: int = 0

    # Port flags
    seed: int = 0                     # params, batch order and augmentation
    dtype: str = "float32"            # float32 | mixed: f32 activations, and
                                      # lft_tpu's per-site product plans in the
                                      # fused blocks (LFT_MM_HP_SITES, default
                                      # all f32; LFT_MM_HP_BWD_SITES, default
                                      # none: the fused backward's products
                                      # over bf16 operands) | bfloat16: bf16
                                      # activations and weights, inference
                                      # and training through the fused
                                      # blocks only (f32 master weights,
                                      # Adam state and checkpoints)
    matmul_precision: str = "default"  # default | high | highest: TF32 of the
                                      # torch ops around the kernels on the
                                      # card (high: on; the kernels ignore it)
    eval_batch: int = 16              # patches per forward in tiled eval
    scene_batch: int = 1              # same-shape scenes per pipeline call
    ckpt_format: str = "npz"          # npz (with Adam state) | pth (reference)
    lr_schedule: str = "step"         # step (reference StepLR) | cosine
    log_every: int = 0                # per-iteration log line every N (0: off)
    profile_dir: str = ""             # if set, the CLIs write a torch.profiler trace there
    attention_impl: str = "auto"      # auto | dense | tiled | pallas: the unfused
                                      # branch's attention; pallas = the per-op
                                      # kernels (K5-K10), auto = pallas on CUDA
                                      # where the kernels take the width
    train_fused: str = "auto"         # auto | true | false: train through the
                                      # fused blocks (K1-K4); auto = false
                                      # (lft_tpu's auto at float32), true
                                      # under bfloat16 and, on the card,
                                      # under mixed.
                                      # true on the CPU runs their plain
                                      # versions through the autograd Functions;
                                      # false trains the unfused per-op branch
    num_devices: Optional[int] = None  # data-parallel ranks (one process each)
    coordinator: str = ""             # multi-process: rendezvous host:port
    num_processes: int = 1            # multi-process: total process count
    process_id: int = 0               # multi-process: this process's rank


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lft_torch: LF image SR on CUDA")
    d = Args()
    p.add_argument("--angRes", type=int, default=d.angRes)
    p.add_argument("--scale_factor", type=int, default=d.scale_factor)
    p.add_argument("--model_name", type=str, default=d.model_name)
    p.add_argument("--channels", type=int, default=d.channels)
    p.add_argument("--use_pre_pth", type=_reference_bool, default=d.use_pre_pth)
    p.add_argument("--path_pre_pth", type=str, default=d.path_pre_pth)
    p.add_argument("--data_name", type=str, default=d.data_name)
    p.add_argument("--path_for_train", type=str, default=d.path_for_train)
    p.add_argument("--path_for_test", type=str, default=d.path_for_test)
    p.add_argument("--path_log", type=str, default=d.path_log)
    p.add_argument("--patch_size_for_test", type=int, default=d.patch_size_for_test)
    p.add_argument("--stride_for_test", type=int, default=d.stride_for_test)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--decay_rate", type=float, default=d.decay_rate)
    p.add_argument("--n_steps", type=int, default=d.n_steps)
    p.add_argument("--gamma", type=float, default=d.gamma)
    p.add_argument("--epoch", type=int, default=d.epoch)
    p.add_argument("--num_workers", type=int, default=d.num_workers)
    p.add_argument("--local_rank", dest="local_rank", type=int, default=d.local_rank)
    p.add_argument("--dtype", type=str, default=d.dtype,
                   choices=["float32", "bfloat16", "mixed"],
                   help="mixed = f32 activations with lft_tpu's per-site product plans "
                        "(LFT_MM_HP_SITES for the forward, default all f32; "
                        "LFT_MM_HP_BWD_SITES for the fused backward, default none: its "
                        "products over bf16 operands, f32 accumulation); bfloat16 = bf16 "
                        "activations and weights (lft_tpu's all-bf16 mode: the fused blocks' "
                        "bf16-IO kernels, the bicubic skip, loss and metrics f32); it serves and "
                        "trains the fused blocks (K1 res, K2 res, K4, K3 and the weight grads "
                        "in bf16 IO; the master weights, Adam state and checkpoints f32); "
                        "the unfused branch (--train_fused false, the data-parallel step) "
                        "raises NotImplementedError")
    p.add_argument("--matmul_precision", type=str, default=d.matmul_precision,
                   choices=["default", "high", "highest"],
                   help="on the card: high turns TF32 on for the torch matmuls and "
                        "convolutions around the kernels; default and highest keep it off")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--eval_batch", type=int, default=d.eval_batch)
    p.add_argument("--scene_batch", type=int, default=d.scene_batch)
    p.add_argument("--ckpt_format", type=str, default=d.ckpt_format, choices=["npz", "pth"])
    p.add_argument("--lr_schedule", type=str, default=d.lr_schedule,
                   choices=["step", "cosine"])
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--profile_dir", type=str, default=d.profile_dir,
                   help="write a torch.profiler trace (Chrome JSON) of the run here")
    p.add_argument("--attention_impl", type=str, default=d.attention_impl,
                   choices=["auto", "dense", "tiled", "pallas"])
    p.add_argument("--train_fused", type=str, default=d.train_fused,
                   choices=["auto", "true", "false"])
    p.add_argument("--num_devices", type=int, default=d.num_devices,
                   help="data-parallel ranks, one process on one card each: N > 1 "
                        "without --coordinator starts N local ranks (the global "
                        "--batch_size divides by N); with --coordinator unset or "
                        "equal to --num_processes")
    p.add_argument("--coordinator", type=str, default=d.coordinator,
                   help="multi-process training: rendezvous address host:port "
                        "(torch.distributed, tcp://host:port); every process "
                        "passes the same address")
    p.add_argument("--num_processes", type=int, default=d.num_processes,
                   help="multi-process training: total number of processes")
    p.add_argument("--process_id", type=int, default=d.process_id,
                   help="multi-process training: this process's index")
    return p


def check_parallel_flags(args) -> None:
    """A rank is one process on one device: under `--coordinator` the
    world is `--num_processes`, and `--num_devices` may only repeat it."""
    nd = getattr(args, "num_devices", None)
    if getattr(args, "coordinator", "") and nd is not None and nd != args.num_processes:
        raise ValueError(
            f"--num_devices {nd} with --coordinator must be unset or equal --num_processes "
            f"{args.num_processes}: lft_torch runs one process on one device a rank")


def parse_args(argv=None) -> Args:
    args = Args(**vars(build_parser().parse_args(argv)))
    check_parallel_flags(args)
    return args
