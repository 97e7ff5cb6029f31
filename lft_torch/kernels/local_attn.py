"""Per-op spatial attention: the dispatch of `attention_impl='pallas'` and
the tile-halo kernel K10 (counterpart of lft_tpu/kernels/local_attn.py).

The JAX dispatcher chooses among four kernel families, and the port follows
it branch for branch: the hybrid (K5, or K9 and K6 where no all-heads
geometry exists) for a tileable view of at most 2048 pixels, K6 for a larger
tileable view, the offset sweep K9 for a small view no tile
divides, and the tile-halo kernel K10 where its variant is forced (`tile`) or
the offset variant meets a view of more than 2048 pixels that 8x8 tiles
divide. The one branch that holds no kernel in the JAX package either, the
tiled XLA op for views no 8x8 tile divides, goes to the port's tiled torch op.

`windowed_attention_tile(q, k, v, num_heads, ksize, t)` is K10: projected
[B, h, w, E] images -> the window attention's output. The JAX kernel scores
every t x t query tile against its whole (t + 2r)^2 key halo under the
additive mask of `ops.attention._halo_mask` and puts it through a plain
softmax, and so does the plain version below. It is the function of K5
(kernels/spa_attn_hp.py), so on a CUDA tensor K10 launches K5's forward
kernel (`lft_torch/csrc/spa_attn_hp.cu`, K2.3's window kernel of
`csrc/window_attn.cuh`), counted as `spa_attn_tile`: it scores only a
query's in-image window keys, whatever t is (a dense halo would score 5.8
times as many). t still has to divide the view, as lft_tpu's gate asks. On a
CPU tensor it runs the plain version. There is no fallback from one to the
other. K10 is forward-only, as in the JAX package, whose kernel has no VJP
and fails under `jax.grad`: when grad is needed the wrapper raises on any
device and names the variants that train.

bf16 q, k, v (`--dtype bfloat16` serving): lft_tpu's kernel (:44-80)
widens q, k and v to f32, scales q, takes the softmax in f32 and rounds the
output once. On the card `spa_attn_tile_bf16io` (K5's wrapper,
`spa_window_attn_kernel`'s bf16-IO instance, f32 inside: K9's bf16-IO
kernel), on the CPU the plain version on the widened values, rounded once.
"""

from __future__ import annotations

import os

import torch

from lft_torch.kernels import local_attn_vjp
from lft_torch.kernels.ang_block import _needs_grad
from lft_torch.kernels.common import io_kernel, mm, on_card
from lft_torch.kernels.spa_attn import (local_attention_tile_mxu, pick_tile,
                                        windowed_attention_hybrid)
from lft_torch.kernels.spa_attn_hp import spa_attn_hp_fwd
from lft_torch.ops.attention import windowed_attention

# The JAX gate of its per-view offset kernel, kept for the same dispatch.
_MAX_HW_OFFSET = 2048

SPA_VARIANTS = ("auto", "mxu", "offset", "tile")

TILE = 8           # the query tile edge of lft_tpu's K10 by default


def windowed_attention_tile_plain(q, k, v, num_heads: int, ksize: int = 5, t: int = TILE):
    """Plain version of K10: the tiled torch op at tile edge t (q scaled
    before the product, the additive -1e30 mask, softmax, times the halo's
    values: the JAX kernel's arithmetic)."""
    return windowed_attention(q, k, v, num_heads, ksize, impl="tiled", t=t)


def windowed_attention_tile(q, k, v, num_heads: int, ksize: int = 5, t: int = TILE):
    """K10 (`spa_attn_tile`) on projected [B, h, w, E] q/k/v, h and w
    multiples of t: K5's forward kernel for CUDA tensors, the plain version
    for CPU tensors. Inference only. bf16 tensors: `spa_attn_tile_bf16io`
    (module docstring)."""
    if _needs_grad(q, k, v):
        raise ValueError(
            "the tile-halo window attention K10 (variant 'tile', and 'offset' on views of more "
            f"than {_MAX_HW_OFFSET} pixels) is forward-only and cannot be differentiated; the "
            f"variants that train are 'auto', 'mxu' and, up to {_MAX_HW_OFFSET} pixels a view, "
            "'offset'")
    B, h, w, E = q.shape
    if h % t or w % t:
        raise ValueError(f"spa_attn_tile: {t}x{t} tiles do not divide ({h}, {w}) views")
    io_kernel("spa_attn_tile", q)
    if not on_card(q):
        if q.dtype == torch.bfloat16:
            return windowed_attention_tile_plain(q.float(), k.float(), v.float(), num_heads, ksize,
                                                 t).bfloat16()
        return windowed_attention_tile_plain(q, k, v, num_heads, ksize, t)
    return spa_attn_hp_fwd(q.contiguous(), k.contiguous(), v.contiguous(), num_heads, ksize,
                           kernel="spa_attn_tile")


def local_attention_pallas(qn, v, in_proj_weight, out_proj_weight, num_heads: int,
                           k: int = 5, t: int = TILE, variant: str = "auto"):
    """Drop-in for `ops.attention.local_attention` on [B, h, w, E] token
    images through the port's kernels. variant: 'auto' resolves per
    geometry and context; 'mxu' | 'offset' | 'tile' force one family
    ('tile' is inference only). The environment variable `LFT_SPA_VARIANT`
    overrides 'auto', as in the JAX package."""
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
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = windowed_attention_tile(mm(qn, wq.T), mm(qn, wk.T), mm(v, wv.T), num_heads, k, t)
    return mm(out, out_proj_weight.T)
