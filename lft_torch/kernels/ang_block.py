"""K1: the fused AngTrans block (counterpart of lft_tpu/kernels/ang_block.py).

`ang_trans_block_fused` runs the whole block (reference model/LFT.py:
194-238) on pixel-major tokens [N, A2, C]: LN(x + ang_pe), q = k from the
normed tokens and v from the raw ones, 8-head attention over each pixel's
A2 view tokens, out-projection + residual, FFN + residual. On a CUDA tensor
it launches the hand-written kernel of `lft_torch/csrc/ang_block.cu`; on a
CPU tensor it runs `ang_trans_block_plain`, the same function in plain
PyTorch. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from lft_torch.kernels import _build
from lft_torch.ops.attention import attention_heads

LN_EPS = 1e-5
BLK = 128          # the JAX gate's key block: A2 <= 128 tokens per pixel
KERNEL_C = (16, 32, 64)


def ang_block_applicable(A2: int) -> bool:
    """Same outcome as lft_tpu.kernels.ang_block.ang_block_applicable."""
    return A2 <= BLK


def ang_weights(params, prefix: str) -> dict:
    """Param dict -> the block's weights in `x @ W` layouts, contiguous."""
    wq, wk, wv = params[prefix + "attention.in_proj_weight"].chunk(3, dim=0)
    t = lambda m: m.t().contiguous()
    return dict(
        ln=torch.stack([params[prefix + "norm.weight"], params[prefix + "norm.bias"],
                        params[prefix + "feed_forward.0.weight"],
                        params[prefix + "feed_forward.0.bias"]]).contiguous(),
        wq=t(wq), wk=t(wk), wv=t(wv),
        wo=t(params[prefix + "attention.out_proj.weight"]),
        w1=t(params[prefix + "feed_forward.1.weight"]),
        w2=t(params[prefix + "feed_forward.4.weight"]))


def _ln(x, w, b):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def ang_block_plain(x: torch.Tensor, ang_pe: torch.Tensor, wts: dict,
                    num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [N, A2, C] -> [N, A2, C]."""
    ln = wts["ln"]
    xn = _ln(x + ang_pe, ln[0], ln[1])
    a = attention_heads(xn @ wts["wq"], xn @ wts["wk"], x @ wts["wv"], num_heads)
    x2 = a @ wts["wo"] + x
    return torch.relu(_ln(x2, ln[2], ln[3]) @ wts["w1"]) @ wts["w2"] + x2


def ang_block(x: torch.Tensor, ang_pe: torch.Tensor, wts: dict,
              num_heads: int) -> torch.Tensor:
    """The block on [N, A2, C] tokens: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.device.type != "cuda":
        return ang_block_plain(x, ang_pe, wts, num_heads)
    N, A2, C = x.shape
    if C not in KERNEL_C or num_heads != 8 or not ang_block_applicable(A2):
        raise NotImplementedError(
            f"ang_block kernel takes C in {KERNEL_C}, 8 heads and A2 <= {BLK}; "
            f"got C={C}, heads={num_heads}, A2={A2}")
    if tuple(ang_pe.shape) != (A2, C):
        raise ValueError(f"ang_pe must be [{A2}, {C}], got {tuple(ang_pe.shape)}")
    w = wts
    _build.check_cuda_args("ang_block", x, ang_pe, w["ln"], w["wq"], w["wk"],
                           w["wv"], w["wo"], w["w1"], w["w2"])
    out = torch.empty_like(x)
    fn = _build.bind("ang_block", "lft_ang_block_fwd", 10,
                     (ctypes.c_int,) * 4 + (ctypes.c_float,))
    _build.launch("ang_block", "ang_block", fn, x.device,
                  x.data_ptr(), ang_pe.data_ptr(), w["ln"].data_ptr(),
                  w["wq"].data_ptr(), w["wk"].data_ptr(), w["wv"].data_ptr(),
                  w["wo"].data_ptr(), w["w1"].data_ptr(), w["w2"].data_ptr(),
                  out.data_ptr(), N, A2, C, num_heads,
                  float(C // num_heads) ** -0.5)
    return out


def ang_trans_block_plain(x, ang_pe, params, prefix: str, num_heads: int):
    """Plain version of `ang_trans_block_fused`, on any device."""
    return ang_block_plain(x, ang_pe, ang_weights(params, prefix), num_heads)


def ang_trans_block_fused(x, ang_pe, params, prefix: str, num_heads: int):
    """The whole AngTrans block on pixel-major tokens.

    x: [N, A2, C] (N = batch*h*w pixels); ang_pe: [A2, C]; params/prefix:
    the flat param dict and `altblock.{i}.ang_trans.`. Returns [N, A2, C]."""
    return ang_block(x, ang_pe, ang_weights(params, prefix), num_heads)
