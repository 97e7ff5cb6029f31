"""K2: the fused SpaTrans block (counterpart of lft_tpu/kernels/spa_block.py,
view-major form).

`spa_trans_block_fused` runs the whole block (reference model/LFT.py:
118-191) on view images [V, h, w, C] as five steps, each a hand-written
kernel of `lft_torch/csrc/spa_block.cu` on a CUDA tensor and its plain
PyTorch version on a CPU tensor:

  1 tokenize_ln     tok = unfold3x3(x) @ MLP;  xn = LN1(tok + pe_tok)
  2 qkv             q = xn Wq, k = xn Wk, v = tok Wv
  3 window_attn     5x5-window 8-head attention, out-of-image keys excluded
  4 outproj_ln      x2 = attn Wo + tok;  xn2 = LN2(x2)
  5 ffn_out         out = (relu(xn2 W1) W2 + x2) Wlin   (Token2SAI)

`spa_trans_block_plain` chains the five plain versions on any device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lft_torch.kernels import _build
from lft_torch.ops.attention import windowed_attention
from lft_torch.ops.unfold import unfold3x3_linear

LN_EPS = 1e-5
KERNEL_C = (16, 32, 64)

# The JAX gate's geometry limits (lft_tpu/kernels/spa_attn_hp.py:65-67):
# the port keeps their outcome, not their TPU meaning.
_MAX_NQ = 128
_MAX_WIDTH = 4096
_MAX_TILES = 64


@functools.lru_cache(maxsize=None)
def _hp_geometry_exists(h: int, w: int, num_heads: int, k: int) -> bool:
    """True iff lft_tpu's `pick_hp_geometry(h, w, num_heads, k)` finds a
    tile (its free search, without the LFT_HP_* overrides)."""
    r = k // 2
    g = int(np.gcd(num_heads, 128))
    align = int(np.lcm(128 // g, 16))
    for th in (d for d in range(1, h + 1) if h % d == 0):
        for tw in (d for d in range(1, w + 1) if w % d == 0):
            nq = th * tw
            n_tiles = (h // th) * (w // tw)
            nk = (th + 2 * r) * (tw + 2 * r)
            for kb in {-(-nk // align) * align, -(-nk // 128) * 128}:
                if (kb >= nk and kb % align == 0 and nq <= _MAX_NQ
                        and n_tiles <= _MAX_TILES and num_heads * kb <= _MAX_WIDTH):
                    return True
    return False


def spa_block_applicable(h: int, w: int, D: int, num_heads: int, k: int) -> bool:
    """Same outcome as lft_tpu.kernels.spa_block.spa_block_applicable."""
    if D % num_heads:
        return False
    return _hp_geometry_exists(h, w, num_heads, k)


def spa_weights(params, prefix: str) -> dict:
    """Param dict -> the block's weights in `x @ W` layouts, contiguous."""
    mlp = params[prefix + "MLP.weight"]                       # [D, C*9]
    D, C9 = mlp.shape
    C = C9 // 9
    wq, wk, wv = params[prefix + "attention.in_proj_weight"].chunk(3, dim=0)
    t = lambda m: m.t().contiguous()
    return dict(
        mlp=mlp,
        # torch unfold order c*9 + ky*3 + kx -> tap-major [9, C, D]
        wu=mlp.reshape(D, C, 9).permute(2, 1, 0).contiguous(),
        ln=torch.stack([params[prefix + "norm.weight"], params[prefix + "norm.bias"],
                        params[prefix + "feed_forward.0.weight"],
                        params[prefix + "feed_forward.0.bias"]]).contiguous(),
        wqk=torch.cat([wq.t(), wk.t()], dim=1).contiguous(),  # [D, 2D]
        wv=t(wv), wo=t(params[prefix + "attention.out_proj.weight"]),
        w1=t(params[prefix + "feed_forward.1.weight"]),
        w2=t(params[prefix + "feed_forward.4.weight"]),
        wlin=t(params[prefix + "linear.0.weight"][:, :, 0, 0, 0]))   # [D, C]


def _ln(x, w, b):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


# ---------------------------------------------------------- plain steps ---

def tokenize_ln_plain(x, pe_tok, wts):
    tok = unfold3x3_linear(x, wts["mlp"]).contiguous()
    return tok, _ln(tok + pe_tok, wts["ln"][0], wts["ln"][1])


def qkv_plain(xn, tok, wts):
    D = tok.shape[-1]
    qk = xn @ wts["wqk"]
    return qk[..., :D].contiguous(), qk[..., D:].contiguous(), tok @ wts["wv"]


def outproj_ln_plain(attn, tok, wts):
    x2 = attn @ wts["wo"] + tok
    return x2, _ln(x2, wts["ln"][2], wts["ln"][3])


def ffn_out_plain(xn2, x2, wts):
    y = torch.relu(xn2 @ wts["w1"]) @ wts["w2"] + x2
    return y @ wts["wlin"]


# ------------------------------------------------------ kernel wrappers ---

def _check_c(kernel: str, C: int) -> None:
    if C not in KERNEL_C:
        raise NotImplementedError(f"{kernel} kernel takes C in {KERNEL_C}, got C={C}")


def tokenize_ln(x, pe_tok, wts):
    """Step 1: x [V, h, w, C], pe_tok [h, w, D] -> (tok, xn) [V, h, w, D]."""
    if x.device.type != "cuda":
        return tokenize_ln_plain(x, pe_tok, wts)
    V, h, w, C = x.shape
    D = wts["wu"].shape[-1]
    _check_c("spa_tokenize_ln", C)
    if tuple(pe_tok.shape) != (h, w, D) or D != 2 * C:
        raise ValueError(f"spa_tokenize_ln: pe_tok {tuple(pe_tok.shape)} for x {tuple(x.shape)}")
    _build.check_cuda_args("spa_tokenize_ln", x, pe_tok, wts["wu"], wts["ln"])
    tok = torch.empty(V, h, w, D, device=x.device)
    xn = torch.empty_like(tok)
    fn = _build.bind("spa_block", "lft_spa_tokenize_ln", 6, (ctypes.c_int,) * 4)
    _build.launch("spa_block", "spa_tokenize_ln", fn, x.device, x.data_ptr(),
                  pe_tok.data_ptr(), wts["wu"].data_ptr(), wts["ln"].data_ptr(),
                  tok.data_ptr(), xn.data_ptr(), V, h, w, C)
    return tok, xn


def qkv(xn, tok, wts):
    """Step 2: (xn, tok) [V, h, w, D] -> (q, k, v) [V, h, w, D]."""
    if xn.device.type != "cuda":
        return qkv_plain(xn, tok, wts)
    D = tok.shape[-1]
    _check_c("spa_qkv", D // 2)
    _build.check_cuda_args("spa_qkv", xn, tok, wts["wqk"], wts["wv"])
    q, k, v = (torch.empty_like(tok) for _ in range(3))
    fn = _build.bind("spa_block", "lft_spa_qkv", 7, (ctypes.c_int,) * 2)
    _build.launch("spa_block", "spa_qkv", fn, xn.device, xn.data_ptr(), tok.data_ptr(),
                  wts["wqk"].data_ptr(), wts["wv"].data_ptr(), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), tok.numel() // D, D // 2)
    return q, k, v


def window_attn(q, k, v, num_heads: int, ksize: int):
    """Step 3: projected q/k/v [V, h, w, D] -> attention output [V, h, w, D]."""
    if q.device.type != "cuda":
        return windowed_attention(q, k, v, num_heads, ksize)
    V, h, w, D = q.shape
    if num_heads != 8 or ksize != 5 or D // num_heads not in (4, 8, 16) \
            or D % num_heads:
        raise NotImplementedError(
            "spa_window_attn kernel takes 8 heads of width 4, 8 or 16 and a 5x5 "
            f"window; got D={D}, heads={num_heads}, k={ksize}")
    _build.check_cuda_args("spa_window_attn", q, k, v)
    attn = torch.empty_like(q)
    fn = _build.bind("spa_block", "lft_spa_window_attn", 4,
                     (ctypes.c_int,) * 5 + (ctypes.c_float,))
    _build.launch("spa_block", "spa_window_attn", fn, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), attn.data_ptr(), V, h, w, D, num_heads,
                  float(D // num_heads) ** -0.5)
    return attn


def outproj_ln(attn, tok, wts):
    """Step 4: (attn, tok) [V, h, w, D] -> (x2, xn2) [V, h, w, D]."""
    if attn.device.type != "cuda":
        return outproj_ln_plain(attn, tok, wts)
    D = tok.shape[-1]
    _check_c("spa_outproj_ln", D // 2)
    _build.check_cuda_args("spa_outproj_ln", attn, tok, wts["wo"], wts["ln"])
    x2, xn2 = torch.empty_like(tok), torch.empty_like(tok)
    fn = _build.bind("spa_block", "lft_spa_outproj_ln", 6, (ctypes.c_int,) * 2)
    _build.launch("spa_block", "spa_outproj_ln", fn, attn.device, attn.data_ptr(),
                  tok.data_ptr(), wts["wo"].data_ptr(), wts["ln"].data_ptr(),
                  x2.data_ptr(), xn2.data_ptr(), tok.numel() // D, D // 2)
    return x2, xn2


def ffn_out(xn2, x2, wts):
    """Step 5: (xn2, x2) [V, h, w, D] -> block output [V, h, w, C]."""
    if xn2.device.type != "cuda":
        return ffn_out_plain(xn2, x2, wts)
    *lead, D = x2.shape
    C = D // 2
    _check_c("spa_ffn_out", C)
    _build.check_cuda_args("spa_ffn_out", xn2, x2, wts["w1"], wts["w2"], wts["wlin"])
    out = torch.empty(*lead, C, device=x2.device)
    fn = _build.bind("spa_block", "lft_spa_ffn_out", 6, (ctypes.c_int,) * 2)
    _build.launch("spa_block", "spa_ffn_out", fn, x2.device, xn2.data_ptr(),
                  x2.data_ptr(), wts["w1"].data_ptr(), wts["w2"].data_ptr(),
                  wts["wlin"].data_ptr(), out.data_ptr(), x2.numel() // D, C)
    return out


# --------------------------------------------------------------- blocks ---

def spa_block(x, pe_tok, wts, num_heads: int, k: int):
    tok, xn = tokenize_ln(x, pe_tok, wts)
    q, kk, v = qkv(xn, tok, wts)
    attn = window_attn(q, kk, v, num_heads, k)
    x2, xn2 = outproj_ln(attn, tok, wts)
    return ffn_out(xn2, x2, wts)


def spa_block_plain(x, pe_tok, wts, num_heads: int, k: int):
    tok, xn = tokenize_ln_plain(x, pe_tok, wts)
    q, kk, v = qkv_plain(xn, tok, wts)
    attn = windowed_attention(q, kk, v, num_heads, k)
    x2, xn2 = outproj_ln_plain(attn, tok, wts)
    return ffn_out_plain(xn2, x2, wts)


def spa_trans_block_plain(x, pe_tok, params, prefix: str, num_heads: int, k: int):
    """Plain version of `spa_trans_block_fused`, on any device."""
    return spa_block_plain(x, pe_tok, spa_weights(params, prefix), num_heads, k)


def spa_trans_block_fused(x, pe_tok, params, prefix: str, num_heads: int, k: int):
    """The whole SpaTrans block on view images.

    x: [V, h, w, C] (V = batch*A2 views); pe_tok: [h, w, D], the spatial PE
    through the same unfold+MLP (view-independent, computed outside);
    params/prefix: the flat param dict and `altblock.{i}.spa_trans.`.
    Returns [V, h, w, C]."""
    return spa_block(x, pe_tok, spa_weights(params, prefix), num_heads, k)
