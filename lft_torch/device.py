"""Device choice for the port's entry points.

Entry points run on `cuda` unless the caller passes `device="cpu"`. With no
card and no explicit CPU request they raise; they never fall back to the
CPU on their own. On the card the port sets the TF32 flags of the torch ops
around the hand-written kernels (cuBLAS matmuls and cuDNN convolutions) from
`--matmul_precision`: `default` and `highest` keep TF32 off, the port's f32
mode (the reference is f32 at HIGHEST precision,
lft_tpu/models/lft.py:276-282, and cuDNN convs default to TF32); `high`
turns it on, torch's own meaning of `high`. The hand-written kernels ignore
the flag. The flags are the process's: an entry point passes the run's
precision once; a call without one (the loaders') leaves them as the port
last set them, and the process's first call on the card sets `highest`. On
the CPU the flag changes nothing, as in lft_tpu on the CPU. Beside TF32 the
port turns cuBLAS's `allow_bf16_reduced_precision_reduction` off on the
card (torch's default lets a bf16 product's partial sums be reduced in bf16,
where lft_tpu's bf16 products accumulate in f32).
"""

from __future__ import annotations

import torch

PRECISIONS = ("default", "high", "highest")
DTYPES = ("float32", "mixed", "bfloat16")


_precision = None       # the precision the port last set on the card


def resolve_device(device=None, matmul_precision=None) -> torch.device:
    """`None` -> the first CUDA card (raises without one); otherwise the
    given device, validated. On the card a `matmul_precision` sets the TF32
    flags; without one they stay as the port last set them (module
    docstring)."""
    global _precision
    if matmul_precision is not None and matmul_precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}, got "
                         f"{matmul_precision!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lft_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        if matmul_precision is not None or _precision is None:
            _precision = matmul_precision or "highest"
            set_tf32(_precision == "high")
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"lft_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def set_tf32(on: bool) -> None:
    """TF32 for cuBLAS matmuls and cuDNN convolutions on the card, or full f32."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def matmul_precision(args) -> str:
    """`--matmul_precision` as a run takes it: `mixed` with `default` runs
    at `highest`, as lft_tpu/models/lft.py:276-282 resolves it (in this port
    both keep TF32 off); `bfloat16` keeps the flag as given, as there."""
    prec = getattr(args, "matmul_precision", "default") or "default"
    if str(getattr(args, "dtype", "float32")) == "mixed" and prec == "default":
        return "highest"
    return prec


def check_dtype(dtype: str) -> None:
    """The port computes `float32`, `mixed` (f32 activations, the fused
    backward's products over bf16 operands, lft_tpu's per-site plan) and
    `bfloat16` (bf16 activations and parameters, inference and training
    through the fused blocks; models/lft.py)."""
    if str(dtype) not in DTYPES:
        raise ValueError(f"lft_torch supports dtype {DTYPES}, got {dtype!r}")
