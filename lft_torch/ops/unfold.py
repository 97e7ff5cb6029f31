"""Local-feature tokenization: unfold(3x3) + Linear == one 3x3 conv
(counterpart of lft_tpu/ops/unfold.py).

The torch `MLP.weight [out, C*9]` keeps unfold's feature order
`c*9 + ky*3 + kx`, so it reshapes to a conv kernel `[out, C, 3, 3]`.
Tensors are channels-last (NHWC), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_nhwc(x: torch.Tensor, w_torch: torch.Tensor) -> torch.Tensor:
    """'SAME' 2-D conv of [B, H, W, Cin] with a torch kernel [Cout, Cin, k, k]
    (odd k)."""
    pad = w_torch.shape[-1] // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), w_torch, padding=pad)
    return y.permute(0, 2, 3, 1)


def unfold3x3_linear(x: torch.Tensor, mlp_weight: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] x Linear weight [out, C*9] -> [B, h, w, out], equal to
    `Linear(unfold(x, k=3, pad=1))` in torch's patch order. The weight takes
    x's dtype, as lft_tpu's conv casts it. A bf16 x (under `--dtype
    bfloat16` the spatial PE's tokens, lft_tpu/models/lft.py:348, and the
    unfused branch's tokens) is summed in f32 over x and the weight's bf16
    values, the result rounded to bf16 once, on every device alike."""
    out_dim = mlp_weight.shape[0]
    C = mlp_weight.shape[1] // 9
    if x.dtype == torch.bfloat16:
        w = mlp_weight.to(torch.bfloat16).float().reshape(out_dim, C, 3, 3)
        return conv2d_nhwc(x.float(), w).to(torch.bfloat16)
    return conv2d_nhwc(x, mlp_weight.to(x.dtype).reshape(out_dim, C, 3, 3))
