"""Per-op 5x5-window spatial attention: tile choice, the hybrid and the
projection wrapper (counterpart of lft_tpu/kernels/spa_attn.py).

The JAX module holds the tile-dense kernel K6 and a hybrid that picks a
kernel per context. The port has the hybrid's first choice, the all-heads
kernel K5 (kernels/spa_attn_hp.py), for the primal and for the training
pair; where the JAX package would take the offset sweep K9 (primal without
a head-packed geometry) or the tile-dense pair K6, the port raises and
names the kernel: both are still to port.
"""

from __future__ import annotations

from lft_torch.kernels.ang_block import _needs_grad
from lft_torch.kernels.spa_attn_hp import headpacked_applicable, windowed_attention_headpacked


def pick_tile(h: int, w: int):
    """Same outcome as lft_tpu.kernels.spa_attn.pick_tile: the rectangular
    query tile (th, tw) dividing (h, w), or None if only degenerate tilings
    exist. The port uses only whether one exists: it decides the dispatch."""
    for target in (128, 64, 32, 16, 8):
        for th in (8, 16, 4, 32, 64, 128, 2, 1):
            if th > target:
                continue
            tw = target // th
            if th * tw == target and h % th == 0 and w % tw == 0:
                return th, tw
    return None


def windowed_attention_mxu(q_img, k_img, v_img, num_heads: int, k: int):
    """The tile-dense kernel K6 and its backward: still to port."""
    B, h, w, E = q_img.shape
    raise NotImplementedError(
        f"window attention of {h}x{w} views (E={E}) takes the tile-dense kernel K6 "
        "(lft_tpu/kernels/spa_attn.py:windowed_attention_mxu), which is still to port")


def windowed_attention_hybrid(q_img, k_img, v_img, num_heads: int, k: int):
    """Window attention with the kernel chosen per context, as the JAX
    hybrid chooses off a TPU: K5 for the primal and for the training pair
    whenever `headpacked_applicable`; else K9 (primal) or K6 (training),
    which raise as still to port."""
    B, h, w, E = q_img.shape
    if headpacked_applicable(h, w, E, num_heads, k):
        return windowed_attention_headpacked(q_img, k_img, v_img, num_heads, k)
    if _needs_grad(q_img, k_img, v_img):
        return windowed_attention_mxu(q_img, k_img, v_img, num_heads, k)
    raise NotImplementedError(
        f"window attention of {h}x{w} views (E={E}, heads={num_heads}) has no head-packed "
        "geometry and takes the offset-sweep kernel K9 "
        "(lft_tpu/kernels/local_attn_vjp.py), which is still to port")


def local_attention_tile_mxu(qn, v, in_proj_weight, out_proj_weight, num_heads: int,
                             k: int = 5, attention=windowed_attention_mxu):
    """Drop-in for ops.attention.local_attention (q = k from `qn`, v raw;
    torch-packed projections): the projections as `torch.matmul`,
    `attention` for the window attention itself."""
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = attention(qn @ wq.T, qn @ wk.T, v @ wv.T, num_heads, k)
    return out @ out_proj_weight.T
