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
    `Linear(unfold(x, k=3, pad=1))` in torch's patch order."""
    out_dim = mlp_weight.shape[0]
    C = mlp_weight.shape[1] // 9
    return conv2d_nhwc(x, mlp_weight.reshape(out_dim, C, 3, 3))
