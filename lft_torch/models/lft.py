"""LFT: Light Field Transformer for LF image super-resolution, PyTorch
(counterpart of lft_tpu/models/lft.py).

Alternating angular transformers (MHSA over the A^2 view tokens of each
pixel) and spatial transformers (5x5-window MHSA over the pixels of each
view) on a 3x3-conv feature extractor, pixel-shuffle upsampling and a
per-view bicubic skip (reference model/LFT.py:8-266).

The forward is a function of a flat {state_dict name: tensor} dict, like
the JAX package's; `LFT` is an `nn.Module` with the reference's exact
submodule layout, so a reference `.pth` loads with `strict=True`, and its
`forward` calls the same function. Quirks kept for parity: q = k from
LayerNorm(token + PE) and v from the RAW token; the spatial PE goes
through the same unfold+MLP in every block; no biases in conv, linear or
attention; the final 3x3 conv runs on the whole SAI mosaic and crosses
view borders; dropout 0.

Two branches, as in the JAX package:
* fused (default on CUDA): each transformer block runs as the port's
  kernels, K1 `ang_trans_block_fused` and K2 `spa_trans_block_fused`;
  on a CPU tensor those dispatch to their plain versions. When grad mode
  is on and an input or weight requires grad, each block runs as its
  autograd Function (K1/K2 with residuals forward, K4/K3 backward);
  otherwise, as in inference, the residual-free kernels;
* unfused: LayerNorm, projections, FFN and residuals as plain torch ops
  around the two attentions, which `attention_impl` selects: `pallas`, the
  default on CUDA, runs them as the per-op kernels, each an autograd
  Function with a kernel backward, so the branch serves and trains on the
  card; `tiled`/`dense` are the plain reference (ops/attention.py), the
  default on the CPU. The kernels are chosen per geometry as the JAX
  package chooses them (kernels/ang_attn.py, kernels/local_attn.py): K7 for
  A2 <= 128 and the key-view sweep K8 beyond; K5 for 32x32 views, the
  tile-dense K6 for tileable views of more than 2048 pixels (64x64), the
  offset sweep K9 for small views no tile divides (30x30), and the
  forward-only tile-halo kernel K10 where `LFT_SPA_VARIANT=tile` forces it or
  `offset` meets a view of more than 2048 pixels. The branch is also where a
  geometry goes that fails a fused gate (angRes >= 12); every gated geometry
  trains fused (K4 has a form for A2 <= 64 and one for 64 < A2 <= 128).

`--dtype mixed` (lft_tpu/models/lft.py:267-286): f32 activations, with
lft_tpu's per-site product plans in the fused blocks, read once a call
(kernels/common.py): the forward's from LFT_MM_HP_SITES (default all f32,
so a `mixed` forward is the f32 one), the backward's from
LFT_MM_HP_BWD_SITES (default none: every product of K3 and K4 and their
weight grads over bf16 operands). On the card the backward's plan `none`
launches the kernels' bf16-operand instances and `all` the f32 ones; so
does the forward's where no gradient is needed (`none` under grad raises
before the first launch); other plans run on the plain versions only. The
unfused branch ignores the plan, as lft_tpu's does.

`--dtype bfloat16` (lft_tpu/models/lft.py:272-306, :447: lft_tpu's all-bf16
mode, -0.20 dB PSNR against f32 there): the parameters and the LR views are
cast to bf16, the conv stack, LeakyReLU, the residuals and the upsampler run
as torch ops in bf16, the blocks on bf16 tensors, the bicubic skip in f32,
and the output is the bf16 mosaic in f32 plus the skip. The branch is chosen
as for f32 (`resolve_bf16`): the fused blocks where their gates and (on the
card) widths take the geometry, their `_bf16io` instances on the card and
their plain versions on the CPU or with `plain_blocks=True`; elsewhere, and
with `fused=False`, the unfused branch as lft_tpu's computes it in bf16
(:358-372): LayerNorm op by op with every step rounded (`_layer_norm`), each
product and add rounded once, the PE cast to the activations' dtype, and the
attentions of `attention_impl`: the per-op kernels' `_bf16io` instances on
the card (`kernels._build.PEROP_BF16IO`), their plain versions on the CPU or
with `plain_blocks=True`, or the torch ops at lft_tpu's rounding points
(ops/attention.py: the tiled op's f32 mask promotes what follows it to f32,
as jnp promotes it). It trains through either branch as lft_tpu's trains
it: the fused one (lft_tpu/models/lft.py:332) with each block through its
autograd Function (K1 res / K2 res forward, K4 / K3 backward, all in bf16
IO, each weight gradient rounded once to bf16); the unfused one with its
torch ops (the op-by-op LayerNorm, the products, the casts) under torch's
autograd in bf16 and the attentions of `attention_impl` through their
autograd Functions (the per-op kernels' `_res` forms and backwards,
`kernels._build.PEROP_BF16TRAIN`, on the card; their plain versions on the
CPU or with `plain_blocks=True`; or the torch ops); in both the rest under
torch's autograd in bf16, the loss on the f32 SR, and the casts' backward
brings every gradient to the f32 parameters.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lft_torch.device import check_dtype, resolve_device
from lft_torch.kernels.ang_attn import ang_attention_pallas
from lft_torch.kernels.ang_block import (_needs_grad, ang_block_applicable,
                                         ang_block_trainable, ang_trans_block_fused,
                                         ang_trans_block_plain)
from lft_torch.kernels.common import (active, attention_route, kernels_take, mm,
                                      mm_hp_sites, mm_site_plan, plain_versions)
from lft_torch.kernels.spa_block import (spa_block_applicable, spa_trans_block_fused,
                                         spa_trans_block_plain)
from lft_torch.ops.attention import local_attention, multi_head_attention
from lft_torch.ops.bicubic import bicubic_upscale_views
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.sai import mosaic_to_views, views_to_mosaic
from lft_torch.ops.unfold import conv2d_nhwc, unfold3x3_linear
from lft_torch.registry import ModelDef, register_model
from lft_torch.utils.checkpoint import validate_params

LAYER_NUM = 4      # reference model/LFT.py:15
NUM_HEADS = 8      # reference model/LFT.py:19
KERNEL_FIELD = 3   # reference model/LFT.py:122
KERNEL_SEARCH = 5  # reference model/LFT.py:123
LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(channels: int, scale: int) -> Dict[str, tuple]:
    """state_dict name -> shape (reference model/LFT.py:23-44,118-214)."""
    C = channels
    D = 2 * C
    shapes: Dict[str, tuple] = {
        "conv_init0.0.weight": (C, 1, 1, 3, 3),
        "conv_init.0.weight": (C, C, 1, 3, 3),
        "conv_init.2.weight": (C, C, 1, 3, 3),
        "conv_init.4.weight": (C, C, 1, 3, 3),
    }
    for i in range(LAYER_NUM):
        a = f"altblock.{i}.ang_trans."
        shapes[a + "norm.weight"] = (C,)
        shapes[a + "norm.bias"] = (C,)
        shapes[a + "attention.in_proj_weight"] = (3 * C, C)
        shapes[a + "attention.out_proj.weight"] = (C, C)
        shapes[a + "feed_forward.0.weight"] = (C,)
        shapes[a + "feed_forward.0.bias"] = (C,)
        shapes[a + "feed_forward.1.weight"] = (2 * C, C)
        shapes[a + "feed_forward.4.weight"] = (C, 2 * C)
        s = f"altblock.{i}.spa_trans."
        shapes[s + "MLP.weight"] = (D, C * KERNEL_FIELD ** 2)
        shapes[s + "norm.weight"] = (D,)
        shapes[s + "norm.bias"] = (D,)
        shapes[s + "attention.in_proj_weight"] = (3 * D, D)
        shapes[s + "attention.out_proj.weight"] = (D, D)
        shapes[s + "feed_forward.0.weight"] = (D,)
        shapes[s + "feed_forward.0.bias"] = (D,)
        shapes[s + "feed_forward.1.weight"] = (2 * D, D)
        shapes[s + "feed_forward.4.weight"] = (D, 2 * D)
        shapes[s + "linear.0.weight"] = (C, D, 1, 1, 1)
    shapes["upsampling.0.weight"] = (C * scale ** 2, C, 1, 1)
    shapes["upsampling.3.weight"] = (1, C, 3, 3)
    return shapes


def _fan_in(name: str, shape: tuple) -> int:
    if name.endswith(("norm.weight", "norm.bias")) or "feed_forward.0." in name:
        return 0  # LayerNorm affine: weight 1, bias 0
    return int(np.prod(shape[1:]))


def init_params(seed: int, args, device=None) -> Dict[str, torch.Tensor]:
    """torch's effective init, from a numpy seed: every weight
    U(+-1/sqrt(fan_in)), LayerNorm affine (1, 0)."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in sorted(param_shapes(args.channels, args.scale_factor).items()):
        fan = _fan_in(name, shape)
        if fan == 0:
            val = np.zeros(shape) if name.endswith("bias") else np.ones(shape)
        else:
            bound = 1.0 / math.sqrt(fan)
            val = rng.uniform(-bound, bound, size=shape)
        params[name] = val.astype(np.float32)
    return params_from_numpy(params, device=device)


def params_from_numpy(d: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters (name -> array, the same names and
    layouts) -> the port's float32 tensors on `device` (cuda unless the
    caller passes 'cpu'). Validates names and shapes."""
    dev = resolve_device(device)
    C = int(np.shape(d["conv_init0.0.weight"])[0])
    S = int(round(math.sqrt(np.shape(d["upsampling.0.weight"])[0] / C)))
    validate_params({k: np.asarray(v) for k, v in d.items()}, param_shapes(C, S))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in d.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, w, b):
    """LayerNorm over the last axis, w and b in x's dtype. A bf16 x takes
    lft_tpu's op-by-op form (lft_tpu/models/lft.py:143-147) with each step
    rounded to bf16: the mean (summed in f32, rounded once), x - mu, its
    square, their mean, + eps (eps itself bf16), rsqrt, the product, then
    * weight and + bias."""
    if x.dtype != torch.bfloat16:
        return F.layer_norm(x, (x.shape[-1],), w.to(x.dtype), b.to(x.dtype), LN_EPS)
    bf = torch.bfloat16
    d = x - x.float().mean(-1, keepdim=True).to(bf)
    var = (d * d).float().mean(-1, keepdim=True).to(bf)
    eps = torch.tensor(LN_EPS, dtype=bf, device=x.device)
    return d * torch.rsqrt((var + eps).float()).to(bf) * w + b


def _leaky(x):
    if x.dtype == torch.bfloat16:
        # lft_tpu's `0.2 * x` on a bf16 array takes the slope in bf16 too
        # (0.2001953125); torch's leaky_relu would multiply by f32 0.2
        return torch.where(x >= 0, x, x * torch.tensor(0.2, dtype=x.dtype, device=x.device))
    return F.leaky_relu(x, 0.2)


def _conv3d_133(x, w_torch):
    """Per-view 3x3 conv: Conv3d k=(1,3,3) weight [O, I, 1, 3, 3] on
    [B*A2, h, w, I] (views folded into the batch)."""
    return conv2d_nhwc(x, w_torch[:, :, 0])


def _ffn(x, p, prefix):
    y = _layer_norm(x, p[prefix + "feed_forward.0.weight"], p[prefix + "feed_forward.0.bias"])
    y = torch.relu(mm(y, p[prefix + "feed_forward.1.weight"].T))
    return mm(y, p[prefix + "feed_forward.4.weight"].T)


def _ang_trans(x, p, prefix, ang_pe, impl="auto"):
    """Unfused angular transformer over [B, A2, h, w, C]; impl 'pallas'
    (and 'auto' on a CUDA tensor of a width the kernels take) runs the
    attention as the per-op kernel (`kernels.common.attention_route`)."""
    t = x.permute(0, 2, 3, 1, 4)                                   # [B, h, w, A2, C]
    tn = _layer_norm(t + ang_pe.to(t.dtype), p[prefix + "norm.weight"], p[prefix + "norm.bias"])
    w_in, w_out = p[prefix + "attention.in_proj_weight"], p[prefix + "attention.out_proj.weight"]
    if attention_route(impl, x.device.type, x.shape[-1]) == "pallas":
        t = ang_attention_pallas(tn, t, w_in, w_out, NUM_HEADS) + t
    else:
        t = multi_head_attention(tn, tn, t, w_in, w_out, NUM_HEADS) + t
    t = _ffn(t, p, prefix) + t
    return t.permute(0, 3, 1, 2, 4)


def _spa_trans(x, p, prefix, spa_pe, impl="auto"):
    """Unfused spatial transformer over [B, A2, h, w, C]; `impl` as in
    `ops.attention.local_attention`; the spatial PE in the tokens' dtype."""
    B, A2, h, w, C = x.shape
    img = x.reshape(B * A2, h, w, C)
    tok = unfold3x3_linear(img, p[prefix + "MLP.weight"])
    pe_tok = unfold3x3_linear(spa_pe[None].to(img.dtype), p[prefix + "MLP.weight"])
    tok_n = _layer_norm(tok + pe_tok, p[prefix + "norm.weight"], p[prefix + "norm.bias"])
    tok = local_attention(tok_n, tok, p[prefix + "attention.in_proj_weight"],
                          p[prefix + "attention.out_proj.weight"], NUM_HEADS,
                          k=KERNEL_SEARCH, impl=impl) + tok
    tok = _ffn(tok, p, prefix) + tok
    out = mm(tok, p[prefix + "linear.0.weight"][:, :, 0, 0, 0].T)
    return out.reshape(B, A2, h, w, C)


def resolve_fused(fused: bool, h: int, w: int, C: int, A2: int, device_type: str,
                  training: bool, plain_blocks: bool = False) -> bool:
    """Whether a forward that asks for the fused branch takes it: both
    blocks' gates must pass, and a forward that will be differentiated
    through the kernels also needs the backward kernels to take the
    geometry (`ang_block_trainable`: today every gated one, so training
    fuses wherever inference does). Everything else goes to the unfused
    branch, as in the JAX package (lft_tpu/models/lft.py:325-329). On CUDA
    the kernels must also take the width (`kernels_take`); lft_tpu's gates
    pass any C with 8 | 2C, so there the two packages differ."""
    if not (fused and spa_block_applicable(h, w, 2 * C, NUM_HEADS, KERNEL_SEARCH)
            and ang_block_applicable(A2)):
        return False
    if device_type == "cuda" and not plain_blocks and not kernels_take(C):
        return False
    return not training or plain_blocks or ang_block_trainable(A2, device_type)


def resolve_bf16(fused, h: int, w: int, C: int, A2: int, device_type: str,
                 plain_blocks: bool = False) -> bool:
    """The branch of a `--dtype bfloat16` forward: the fused one where
    `fused` is not False (None included, on every device) and
    `resolve_fused` takes the geometry and width; else the unfused one, as
    lft_tpu sends a geometry its fused gates refuse to its unfused branch
    (lft_tpu/models/lft.py:325-329, :358-372)."""
    return fused is not False and resolve_fused(True, h, w, C, A2, device_type, False,
                                                plain_blocks)


def forward(params: Dict[str, torch.Tensor], lr: torch.Tensor, args,
            fused=None, plain_blocks: bool = False, attention_impl=None) -> torch.Tensor:
    """SR forward: lr [B, 1, A*h, A*w] -> [B, 1, A*h*S, A*w*S] (NCHW, like
    the reference), on the device of `lr` and `params`.

    `fused=None` takes the fused branch on CUDA and the unfused one on the
    CPU (the JAX tiled pipeline likewise fuses on its accelerator); the
    fused branch needs `resolve_fused`. `plain_blocks=True` runs the
    fused branch through the blocks' plain versions on any device: the
    reference the card's kernels are held against (under `bfloat16` also
    the unfused branch's per-op attentions, `kernels.common.plain_versions`).
    `attention_impl` (default `args.attention_impl`) selects the unfused
    branch's attention: auto | dense | tiled | pallas. `args.dtype` `mixed`
    takes lft_tpu's site plans in the fused branch (module docstring),
    `bfloat16` bf16 inference and training through either branch
    (`resolve_bf16`, fused where the gates pass, `fused=None` included)."""
    dt = str(getattr(args, "dtype", "float32") or "float32")
    check_dtype(dt)
    bf16 = dt == "bfloat16"
    impl = attention_impl or getattr(args, "attention_impl", "auto") or "auto"
    A = args.angRes
    S = args.scale_factor
    C = args.channels
    B, _, H, W = lr.shape
    h, w = H // A, W // A
    dev = lr.device
    p = params

    lr = lr[:, 0].float()
    lr_up = bicubic_upscale_views(lr, A, S)                        # [B, H*S, W*S]
    x = mosaic_to_views(lr[..., None], A).reshape(B * A * A, h, w, 1)
    if bf16:                                   # lft_tpu/models/lft.py:306-307
        p = {k: v.to(torch.bfloat16) for k, v in params.items()}
        x = x.to(torch.bfloat16)

    x0 = _conv3d_133(x, p["conv_init0.0.weight"])
    y = _leaky(_conv3d_133(x0, p["conv_init.0.weight"]))
    y = _leaky(_conv3d_133(y, p["conv_init.2.weight"]))
    y = _leaky(_conv3d_133(y, p["conv_init.4.weight"]))
    buf = (y + x0).reshape(B, A * A, h, w, C)
    res = buf

    spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev)
    ang_pe = torch.from_numpy(angular_position(A * A, C)).to(dev)

    if bf16:
        fused = resolve_bf16(fused, h, w, C, A * A, dev.type, plain_blocks)
        if fused:
            spa_pe = spa_pe.to(torch.bfloat16)     # lft_tpu/models/lft.py:348
    else:
        if fused is None:
            fused = dev.type == "cuda" or plain_blocks
        fused = resolve_fused(fused, h, w, C, A * A, dev.type, _needs_grad(lr, *p.values()),
                              plain_blocks)

    if fused:
        ang_fn = ang_trans_block_plain if plain_blocks else ang_trans_block_fused
        spa_fn = spa_trans_block_plain if plain_blocks else spa_trans_block_fused
        plans = {}
        if dt == "mixed":   # the plans, read once for the whole call
            plans = dict(plan=active(mm_site_plan(True, mm_hp_sites())),
                         bwd_plan=active(mm_site_plan(True, mm_hp_sites("LFT_MM_HP_BWD_SITES",
                                                                        "none"))))
        for i in range(LAYER_NUM):
            t = buf.permute(0, 2, 3, 1, 4).reshape(B * h * w, A * A, C).contiguous()
            t = ang_fn(t, ang_pe, p, f"altblock.{i}.ang_trans.", NUM_HEADS, **plans)
            t = t.reshape(B, h, w, A * A, C).permute(0, 3, 1, 2, 4)
            s_pref = f"altblock.{i}.spa_trans."
            pe_tok = unfold3x3_linear(spa_pe[None], p[s_pref + "MLP.weight"])[0].contiguous()
            out = spa_fn(t.reshape(B * A * A, h, w, C).contiguous(), pe_tok, p, s_pref,
                         NUM_HEADS, KERNEL_SEARCH, **plans)
            buf = out.reshape(B, A * A, h, w, C)
    else:
        with plain_versions() if bf16 and plain_blocks else contextlib.nullcontext():
            for i in range(LAYER_NUM):
                buf = _ang_trans(buf, p, f"altblock.{i}.ang_trans.", ang_pe, impl)
                buf = _spa_trans(buf, p, f"altblock.{i}.spa_trans.", spa_pe, impl)
    buf = buf + res                                                # model/LFT.py:76

    # upsampling head (reference model/LFT.py:39-44, 80): 1x1 conv -> pixel
    # shuffle -> LeakyReLU -> 3x3 conv on the whole mosaic
    if bf16:
        m = _upsample_fold(views_to_mosaic(buf, A), p["upsampling.0.weight"],
                           p["upsampling.3.weight"], S)
        return m.float() + lr_up[:, None]
    m = views_to_mosaic(buf, A).permute(0, 3, 1, 2)                # [B, C, A*h, A*w]
    m = F.conv2d(m, p["upsampling.0.weight"])
    m = _leaky(F.pixel_shuffle(m, S))
    m = F.conv2d(m, p["upsampling.3.weight"], padding=1)           # [B, 1, H*S, W*S]
    return m + lr_up[:, None]


@functools.lru_cache(maxsize=None)
def _fold_index(C: int, S: int):
    """(rows, columns) of lft_tpu's Wfold (lft_tpu/models/lft.py:413-424):
    column (s9, i, j) of `U @ Wfold` holds the part of HR pixel (S y + i,
    S x + j)'s 3x3 conv that LR cell (y + cy, x + cx) gives, s9 = 3 (cy + 1)
    + cx + 1; row c S^2 + ip S + jp of U is channel c of that cell's
    subpixel (ip, jp). Entry n of each (i, j)'s block of 9 C holds tap n = c
    9 + 3 ky + kx of the conv weight, so the values are the weight repeated
    S^2 times (a broadcast, whose backward is a sum, not a scatter-add), and
    every (row, column) is set once."""
    S2 = S * S
    r, c = [], []
    for i in range(S):
        for j in range(S):
            for ch in range(C):
                for ky in range(3):
                    for kx in range(3):
                        cy, ip = divmod(i + ky - 1, S)
                        cx, jp = divmod(j + kx - 1, S)
                        s9 = (cy + 1) * 3 + (cx + 1)
                        r.append(ch * S2 + ip * S + jp)
                        c.append(s9 * S2 + i * S + j)
    return tuple(torch.tensor(a) for a in (r, c))


class _Repeat(torch.autograd.Function):
    """A flat w repeated n times, whose backward adds the n cotangents one at
    a time in w's dtype, in their order (as lft_tpu's scatter of w3 into
    Wfold adds its updates: in bf16 each sum rounded; torch's sum over an
    expanded axis would round the n once)."""

    @staticmethod
    def forward(ctx, w, n: int):
        ctx.n = n
        return w.reshape(1, -1).expand(n, -1).reshape(-1)

    @staticmethod
    def backward(ctx, g):
        g = g.reshape(ctx.n, -1)
        acc = g[0]
        for i in range(1, ctx.n):
            acc = acc + g[i]
        return acc, None


def _upsample_fold(m, w_up, w3, S: int):
    """The upsampler as lft_tpu's `fold` computes it (lft_tpu/models/lft.py:
    391-433), for `--dtype bfloat16`: m [B, H, W, C] (the mosaic: bf16, or
    f32 where the unfused branch's tiled attention promoted it; the weights
    take its dtype, as there; Wfold is built in w3's and cast) -> [B, 1, H
    S, W S]. U = leaky(m W_up^T) in LR layout; T = U Wfold, the 3x3
    conv's parts from each of the 9 neighbouring LR cells, each rounded to
    bf16; their sum over the cells, shifted, one bf16 addition at a time in
    lft_tpu's order; then the pixel shuffle. The same function as the NCHW
    form, which rounds the conv once and so skips roundings lft_tpu makes:
    with it the bf16 SR lay 0.876 of lft_tpu's bf16-vs-f32 distance from the
    f32 SR, with this form 0.984 (tests/test_torch_bf16.py, on the CPU).
    Under grad, Wfold's backward gathers its entries and adds each tap's S^2
    one at a time in lft_tpu's order (its scatter into Wfold, `_Repeat`),
    each sum rounded to w3's dtype: a train step repeats bitwise."""
    B, H, W, C = m.shape
    S2 = S * S
    rows, cols = _fold_index(C, S)
    wfold = torch.zeros(C * S2, 9 * S2, dtype=w3.dtype, device=m.device)
    wfold = wfold.index_put((rows.to(m.device), cols.to(m.device)),
                            _Repeat.apply(w3.reshape(-1), S2)).to(m.dtype)
    u = _leaky(m @ w_up[:, :, 0, 0].t().to(m.dtype))               # [B, H, W, S2 C]
    tp = F.pad(u @ wfold, (0, 0, 1, 1, 1, 1))                      # [B, H+2, W+2, 9 S2]
    o = 0
    for s9 in range(9):
        dy, dx = divmod(s9, 3)
        o = o + tp[:, dy:dy + H, dx:dx + W, s9 * S2:(s9 + 1) * S2]
    o = o.reshape(B, H, W, S, S).permute(0, 1, 3, 2, 4)
    return o.reshape(B, 1, H * S, W * S)


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """Plain L1 (reference model/LFT.py:269-277)."""
    return (sr - hr).abs().mean()


# ---------------------------------------------------------------------------
# nn.Module with the reference's state_dict layout
# ---------------------------------------------------------------------------

def _conv133(cin: int, cout: int) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, (1, 3, 3), padding=(0, 1, 1), bias=False)


class _AngTrans(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.norm = nn.LayerNorm(C)
        self.attention = nn.MultiheadAttention(C, NUM_HEADS, bias=False)
        self.feed_forward = nn.Sequential(
            nn.LayerNorm(C), nn.Linear(C, 2 * C, bias=False), nn.ReLU(),
            nn.Dropout(0.0), nn.Linear(2 * C, C, bias=False), nn.Dropout(0.0))


class _SpaTrans(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        D = 2 * C
        self.MLP = nn.Linear(C * KERNEL_FIELD ** 2, D, bias=False)
        self.norm = nn.LayerNorm(D)
        self.attention = nn.MultiheadAttention(D, NUM_HEADS, bias=False)
        self.feed_forward = nn.Sequential(
            nn.LayerNorm(D), nn.Linear(D, 2 * D, bias=False), nn.ReLU(),
            nn.Dropout(0.0), nn.Linear(2 * D, D, bias=False), nn.Dropout(0.0))
        self.linear = nn.Sequential(nn.Conv3d(D, C, 1, bias=False))


class _AltFilter(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.ang_trans = _AngTrans(C)
        self.spa_trans = _SpaTrans(C)


class LFT(nn.Module):
    """The reference model's module tree (same state_dict names and
    shapes); `forward(lr)` runs the functional forward on its parameters."""

    def __init__(self, args):
        super().__init__()
        C, S = args.channels, args.scale_factor
        self.args = args
        self.conv_init0 = nn.Sequential(_conv133(1, C))
        self.conv_init = nn.Sequential(
            _conv133(C, C), nn.LeakyReLU(0.2), _conv133(C, C), nn.LeakyReLU(0.2),
            _conv133(C, C), nn.LeakyReLU(0.2))
        self.altblock = nn.ModuleList(_AltFilter(C) for _ in range(LAYER_NUM))
        self.upsampling = nn.Sequential(
            nn.Conv2d(C, C * S * S, 1, bias=False), nn.PixelShuffle(S),
            nn.LeakyReLU(0.2), nn.Conv2d(C, 1, 3, padding=1, bias=False))

    def forward(self, lr: torch.Tensor, **kw) -> torch.Tensor:
        return forward(dict(self.named_parameters()), lr, self.args, **kw)


LFT_MODEL = register_model(ModelDef(name="LFT", init=init_params, apply=forward,
                                    loss=l1_loss, capabilities=frozenset({"fused"})))
