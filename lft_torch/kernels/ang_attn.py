"""Per-op angular attention: the dispatcher (counterpart of
lft_tpu/kernels/ang_attn.py).

Two trainable implementations, as in the JAX package:

* `ang_attn_mxu.ang_attention_mxu` (K7): every A2 <= 128, the default;
* the key-view sweep `ang_attn_vjp.ang_attention_pallas_ad` (K8): any A2,
  taken for angRes >= 12 and as the `sweep` variant.
"""

from __future__ import annotations

import os

from lft_torch.kernels.ang_attn_mxu import ang_attention_mxu, mxu_applicable
from lft_torch.kernels.ang_attn_vjp import ang_attention_pallas_ad

ANG_VARIANTS = ("mxu", "sweep")


def ang_attention_pallas(qn, v, in_proj_weight, out_proj_weight, num_heads: int,
                         variant: str | None = None):
    """The AngTrans attention (q = k from `qn`, v raw; torch-packed
    projections) on [..., A2, C] tokens through the port's kernels: K7 when
    the view count fits its gate, else K8, as the JAX dispatcher decides.
    `variant` 'sweep' forces K8; left None it is read from the environment
    variable `LFT_ANG_VARIANT` (default 'mxu'), as the JAX package reads it."""
    if variant is None:
        variant = os.environ.get("LFT_ANG_VARIANT", "mxu")
    if variant not in ANG_VARIANTS:
        raise ValueError(f"unknown angular attention variant {variant!r} "
                         f"(LFT_ANG_VARIANT?); valid: {ANG_VARIANTS}")
    if variant == "sweep" or not mxu_applicable(qn.shape[-2]):
        return ang_attention_pallas_ad(qn, v, in_proj_weight, out_proj_weight, num_heads)
    return ang_attention_mxu(qn, v, in_proj_weight, out_proj_weight, num_heads)
