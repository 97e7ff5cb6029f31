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
  on a CPU tensor those dispatch to their plain versions;
* unfused: the per-op plain reference (ops/attention.py). On CUDA it would
  need the per-op kernels K5-K10, which are not ported yet, so it raises.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lft_torch.device import check_dtype, resolve_device
from lft_torch.kernels.ang_block import (ang_block_applicable, ang_trans_block_fused,
                                         ang_trans_block_plain)
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
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def _leaky(x):
    return F.leaky_relu(x, 0.2)


def _conv3d_133(x, w_torch):
    """Per-view 3x3 conv: Conv3d k=(1,3,3) weight [O, I, 1, 3, 3] on
    [B*A2, h, w, I] (views folded into the batch)."""
    return conv2d_nhwc(x, w_torch[:, :, 0])


def _ffn(x, p, prefix):
    y = _layer_norm(x, p[prefix + "feed_forward.0.weight"], p[prefix + "feed_forward.0.bias"])
    y = torch.relu(y @ p[prefix + "feed_forward.1.weight"].T)
    return y @ p[prefix + "feed_forward.4.weight"].T


def _ang_trans(x, p, prefix, ang_pe):
    """Unfused angular transformer over [B, A2, h, w, C]."""
    t = x.permute(0, 2, 3, 1, 4)                                   # [B, h, w, A2, C]
    tn = _layer_norm(t + ang_pe, p[prefix + "norm.weight"], p[prefix + "norm.bias"])
    t = multi_head_attention(tn, tn, t, p[prefix + "attention.in_proj_weight"],
                             p[prefix + "attention.out_proj.weight"], NUM_HEADS) + t
    t = _ffn(t, p, prefix) + t
    return t.permute(0, 3, 1, 2, 4)


def _spa_trans(x, p, prefix, spa_pe):
    """Unfused spatial transformer over [B, A2, h, w, C]."""
    B, A2, h, w, C = x.shape
    img = x.reshape(B * A2, h, w, C)
    tok = unfold3x3_linear(img, p[prefix + "MLP.weight"])
    pe_tok = unfold3x3_linear(spa_pe[None], p[prefix + "MLP.weight"])
    tok_n = _layer_norm(tok + pe_tok, p[prefix + "norm.weight"], p[prefix + "norm.bias"])
    tok = local_attention(tok_n, tok, p[prefix + "attention.in_proj_weight"],
                          p[prefix + "attention.out_proj.weight"], NUM_HEADS,
                          k=KERNEL_SEARCH) + tok
    tok = _ffn(tok, p, prefix) + tok
    out = tok @ p[prefix + "linear.0.weight"][:, :, 0, 0, 0].T
    return out.reshape(B, A2, h, w, C)


def forward(params: Dict[str, torch.Tensor], lr: torch.Tensor, args,
            fused=None, plain_blocks: bool = False) -> torch.Tensor:
    """SR forward: lr [B, 1, A*h, A*w] -> [B, 1, A*h*S, A*w*S] (NCHW, like
    the reference), on the device of `lr` and `params`.

    `fused=None` takes the fused branch on CUDA and the unfused one on the
    CPU (the JAX tiled pipeline likewise fuses on its accelerator); the
    fused branch needs both gates to pass. `plain_blocks=True` runs the
    fused branch through the blocks' plain versions on any device: the
    reference the card's kernels are held against."""
    check_dtype(getattr(args, "dtype", "float32"))
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

    x0 = _conv3d_133(x, p["conv_init0.0.weight"])
    y = _leaky(_conv3d_133(x0, p["conv_init.0.weight"]))
    y = _leaky(_conv3d_133(y, p["conv_init.2.weight"]))
    y = _leaky(_conv3d_133(y, p["conv_init.4.weight"]))
    buf = (y + x0).reshape(B, A * A, h, w, C)
    res = buf

    spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev)
    ang_pe = torch.from_numpy(angular_position(A * A, C)).to(dev)

    if fused is None:
        fused = dev.type == "cuda" or plain_blocks
    fused = fused and spa_block_applicable(h, w, 2 * C, NUM_HEADS, KERNEL_SEARCH) \
        and ang_block_applicable(A * A)

    if fused:
        ang_fn = ang_trans_block_plain if plain_blocks else ang_trans_block_fused
        spa_fn = spa_trans_block_plain if plain_blocks else spa_trans_block_fused
        for i in range(LAYER_NUM):
            t = buf.permute(0, 2, 3, 1, 4).reshape(B * h * w, A * A, C).contiguous()
            t = ang_fn(t, ang_pe, p, f"altblock.{i}.ang_trans.", NUM_HEADS)
            t = t.reshape(B, h, w, A * A, C).permute(0, 3, 1, 2, 4)
            s_pref = f"altblock.{i}.spa_trans."
            pe_tok = unfold3x3_linear(spa_pe[None], p[s_pref + "MLP.weight"])[0].contiguous()
            out = spa_fn(t.reshape(B * A * A, h, w, C).contiguous(), pe_tok, p, s_pref,
                         NUM_HEADS, KERNEL_SEARCH)
            buf = out.reshape(B, A * A, h, w, C)
    else:
        if dev.type == "cuda":
            raise NotImplementedError(
                "the unfused LFT branch on CUDA needs the per-op attention kernels "
                "K5-K10, queued as ROADMAP.md §1 item 10; this geometry fails the "
                f"fused-block gates (h={h}, w={w}, A2={A * A})")
        for i in range(LAYER_NUM):
            buf = _ang_trans(buf, p, f"altblock.{i}.ang_trans.", ang_pe)
            buf = _spa_trans(buf, p, f"altblock.{i}.spa_trans.", spa_pe)
    buf = buf + res                                                # model/LFT.py:76

    # upsampling head (reference model/LFT.py:39-44, 80): 1x1 conv -> pixel
    # shuffle -> LeakyReLU -> 3x3 conv on the whole mosaic
    m = views_to_mosaic(buf, A).permute(0, 3, 1, 2)                # [B, C, A*h, A*w]
    m = F.conv2d(m, p["upsampling.0.weight"])
    m = _leaky(F.pixel_shuffle(m, S))
    m = F.conv2d(m, p["upsampling.3.weight"], padding=1)           # [B, 1, H*S, W*S]
    return m + lr_up[:, None]


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
