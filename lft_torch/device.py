"""Device choice for the port's entry points.

Entry points run on `cuda` unless the caller passes `device="cpu"`. With no
card and no explicit CPU request they raise; they never fall back to the
CPU on their own. Whenever the port runs on the card it turns TF32 off for
both matmuls and cuDNN convolutions: the reference is f32 at HIGHEST
precision (lft_tpu/models/lft.py:276-282), and cuDNN convs default to TF32.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the first CUDA card (raises without one); otherwise the
    given device, validated."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lft_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        use_f32_exact()
    elif dev.type != "cpu":
        raise ValueError(f"lft_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def use_f32_exact() -> None:
    """Full-f32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_dtype(dtype: str) -> None:
    """The port covers the f32 parity mode only."""
    if str(dtype) != "float32":
        raise NotImplementedError(
            f"lft_torch supports dtype='float32' only, got {dtype!r}: "
            "'bfloat16' and 'mixed' are queued as ROADMAP.md §1 item 9")
