"""Per-op spatial attention: the dispatch of `attention_impl='pallas'`
(counterpart of lft_tpu/kernels/local_attn.py:130-179).

The JAX dispatcher chooses among four kernel families, and the port follows
it branch for branch: the hybrid (K5, or K9 and K6 where no all-heads
geometry exists) for a tileable view of at most 2048 pixels, the tile-dense
K6 for a larger tileable view, the offset sweep K9 for a small view no tile
divides. The tile-halo kernel K10 is still to port and its branch raises.
The one branch that holds no kernel in the JAX package either, the tiled XLA
op for views no 8x8 tile divides, goes to the port's tiled torch op.
"""

from __future__ import annotations

import os

from lft_torch.kernels import local_attn_vjp
from lft_torch.kernels.spa_attn import (local_attention_tile_mxu, pick_tile,
                                        windowed_attention_hybrid)

# The JAX gate of its per-view offset kernel, kept for the same dispatch.
_MAX_HW_OFFSET = 2048

SPA_VARIANTS = ("auto", "mxu", "offset", "tile")


def local_attention_pallas(qn, v, in_proj_weight, out_proj_weight, num_heads: int,
                           k: int = 5, t: int = 8, variant: str = "auto"):
    """Drop-in for `ops.attention.local_attention` on [B, h, w, E] token
    images through the port's kernels. variant: 'auto' resolves per
    geometry and context; 'mxu' | 'offset' | 'tile' force one family. The
    environment variable `LFT_SPA_VARIANT` overrides 'auto', as in the JAX
    package."""
    if variant == "auto":
        variant = os.environ.get("LFT_SPA_VARIANT", "auto")
    if variant not in SPA_VARIANTS:
        raise ValueError(f"unknown spatial attention variant {variant!r} "
                         f"(LFT_SPA_VARIANT?); valid: {SPA_VARIANTS}")
    B, h, w, E = qn.shape
    tileable = pick_tile(h, w) is not None and E % num_heads == 0
    if variant == "auto" and tileable and h * w <= _MAX_HW_OFFSET:
        return local_attention_tile_mxu(qn, v, in_proj_weight, out_proj_weight, num_heads, k,
                                        attention=windowed_attention_hybrid)
    if variant in ("auto", "mxu") and tileable:
        return local_attention_tile_mxu(qn, v, in_proj_weight, out_proj_weight, num_heads, k)
    use_offset = variant in ("auto", "offset") and h * w <= _MAX_HW_OFFSET
    if not use_offset and (h % t or w % t):
        from lft_torch.ops.attention import local_attention
        return local_attention(qn, v, in_proj_weight, out_proj_weight, num_heads, k=k,
                               impl="tiled")
    if use_offset:
        return local_attn_vjp.local_attention_pallas_ad(qn, v, in_proj_weight, out_proj_weight,
                                                        num_heads, k)
    raise NotImplementedError(
        f"window attention of {h}x{w} views with variant={variant!r} takes the tile-halo "
        "kernel K10 (lft_tpu/kernels/local_attn.py:_windowed_attention_pallas), which is "
        "still to port")
