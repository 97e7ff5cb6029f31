"""Per-op angular attention: the dispatcher (counterpart of
lft_tpu/kernels/ang_attn.py).

Two trainable implementations exist in the JAX package; the port has the
first:

* `ang_attn_mxu.ang_attention_mxu` (K7): every A2 <= 128, the default;
* the key-view sweep `ang_attn_vjp.ang_attention_pallas_ad` (K8): any A2,
  the fallback for angRes >= 12 and the `sweep` variant. Still to port; the
  dispatcher raises where the JAX package would pick it.
"""

from __future__ import annotations

from lft_torch.kernels.ang_attn_mxu import ang_attention_mxu, mxu_applicable

ANG_VARIANTS = ("mxu", "sweep")


def ang_attention_pallas(qn, v, in_proj_weight, out_proj_weight, num_heads: int,
                         variant: str = "mxu"):
    """The AngTrans attention (q = k from `qn`, v raw; torch-packed
    projections) on [..., A2, C] tokens through the port's kernels: K7 when
    the view count fits its gate, as the JAX dispatcher decides."""
    if variant not in ANG_VARIANTS:
        raise ValueError(f"unknown angular attention variant {variant!r}; "
                         f"valid: {ANG_VARIANTS}")
    A2 = qn.shape[-2]
    if variant == "sweep" or not mxu_applicable(A2):
        raise NotImplementedError(
            f"angular attention with variant={variant!r}, A2={A2} takes the key-view sweep "
            "kernel K8 (lft_tpu/kernels/ang_attn_vjp.py), which is still to port; K7 takes "
            "A2 <= 128")
    return ang_attention_mxu(qn, v, in_proj_weight, out_proj_weight, num_heads)
