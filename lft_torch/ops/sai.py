"""Sub-aperture-image (SAI) mosaic <-> view reshapes
(the part of lft_tpu/ops/sai.py that the inference path uses).

A light field of A x A views of h x w is stored as one [A*h, A*w] mosaic,
view (u, v) in block (u, v); folded view index `v = u*A + v`.
Channels-last: mosaic [..., A*h, A*w, C], views [..., A*A, h, w, C].
"""

from __future__ import annotations

import torch


def mosaic_to_views(x: torch.Tensor, ang_res: int) -> torch.Tensor:
    """[..., A*h, A*w, C] -> [..., A*A, h, w, C]."""
    *lead, H, W, C = x.shape
    a = ang_res
    h, w = H // a, W // a
    x = x.reshape(*lead, a, h, a, w, C).movedim(-3, -4)   # [..., a, a, h, w, C]
    return x.reshape(*lead, a * a, h, w, C)


def views_to_mosaic(x: torch.Tensor, ang_res: int) -> torch.Tensor:
    """[..., A*A, h, w, C] -> [..., A*h, A*w, C]."""
    *lead, aa, h, w, C = x.shape
    a = ang_res
    x = x.reshape(*lead, a, a, h, w, C).movedim(-4, -3)   # [..., a, h, a, w, C]
    return x.reshape(*lead, a * h, a * w, C)
