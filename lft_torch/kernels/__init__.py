"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`LAUNCHES` counts each kernel's launches; `reset_launches()` zeroes them.
`FORWARD` names the kernels of the fused SR forward, `TRAINING` those that
only a fused train step launches, `PEROP` those of the unfused per-op branch's
default pair (K7, K5), `SWEEPS` those of its other families (K8, K9, K6),
`TAIL` the rest: K10 `spa_attn_tile`; `ang_block_bwd128`, the fused AngTrans
backward K4 counted at pixels of 65 to 128 views (the same kernels count as
`ang_block_bwd` at A2 <= 64); and K11's `spa_tokenize_ln_pm` and
`spa_ffn_out_pm`; `MIXED` the bf16-operand instances a fused train step
launches under `--dtype mixed` (K3's steps, K4, `wgrad`, each `_bf16`);
`BF16IO` the bf16-IO instances of K1 and K2's steps that an SR forward
launches under `--dtype bfloat16` (each `_bf16io`); `BF16TRAIN` those that
only a fused train step launches under `--dtype bfloat16` (K1 res, K2.3 res,
K4 in both forms, K3's five steps, `wgrad`, each `_bf16io`); `PEROP_BF16IO`
those of the per-op branch's forwards under `--dtype bfloat16` (K7, K8, K5,
K6, K9, K10, each `_bf16io`); `PEROP_BF16TRAIN` those only its train step
launches under `--dtype bfloat16` (the `_res` form and backward of K7, K8,
K5, K6, K9, each `_bf16io`); `MIXED_FWD` the bf16-operand instances of K1,
K2's five steps and K11's two that an SR forward launches under `--dtype
mixed` with LFT_MM_HP_SITES=none (each `_bf16`); `MIXED_TRAIN` those that
only a fused train step launches under it (K1 res, K2.3 res, each `_bf16`;
K4 in both forms as `_dp` under LFT_MM_HP_BWD_SITES=all); `MIXED_SITES`
the site-subset instances of K1 (both forms), K2.2, K2.3 (both forms), K2.5
and K11.5 under an LFT_MM_HP_SITES subset (each `_sites`); `MIXED_BWD_SITES`
those of K3.a-K3.d and K4 (both forms) under an LFT_MM_HP_BWD_SITES subset
(each `_sites`);
`TAIL_BF16IO` K11's two on bf16 tensors (each `_bf16io`).
"""

from lft_torch.kernels._build import (BF16IO, BF16TRAIN, FORWARD, LAUNCHES, MIXED,
                                      MIXED_BWD_SITES, MIXED_FWD, MIXED_SITES, MIXED_TRAIN, PEROP,
                                      PEROP_BF16IO, PEROP_BF16TRAIN, SWEEPS, TAIL, TAIL_BF16IO,
                                      TRAINING, build_all, reset_launches)

__all__ = ["BF16IO", "BF16TRAIN", "FORWARD", "LAUNCHES", "MIXED", "MIXED_BWD_SITES",
           "MIXED_FWD", "MIXED_SITES", "MIXED_TRAIN", "PEROP", "PEROP_BF16IO",
           "PEROP_BF16TRAIN", "SWEEPS", "TAIL", "TAIL_BF16IO", "TRAINING", "build_all",
           "reset_launches"]
