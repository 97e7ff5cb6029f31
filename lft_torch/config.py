"""Configuration / CLI flags (counterpart of lft_tpu/config.py, without JAX).

The reference-compatible flags are the same; the TPU-only knobs
(`--platform`, `--compile_cache_dir`, mesh and multi-host flags) are
replaced by an explicit `device` argument of the entry points (`cuda`
unless the caller asks for `cpu`, see lft_torch/device.py).
"""

from __future__ import annotations

import argparse
import dataclasses


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
    dtype: str = "float32"            # float32 only in this port
    eval_batch: int = 16              # patches per forward in tiled eval
    scene_batch: int = 1              # same-shape scenes per pipeline call


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
                   help="float32 only; the others raise NotImplementedError")
    p.add_argument("--eval_batch", type=int, default=d.eval_batch)
    p.add_argument("--scene_batch", type=int, default=d.scene_batch)
    return p


def parse_args(argv=None) -> Args:
    ns = build_parser().parse_args(argv)
    return Args(**vars(ns))
