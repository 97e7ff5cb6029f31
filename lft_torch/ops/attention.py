"""Multi-head attention ops, plain PyTorch (counterpart of
lft_tpu/ops/attention.py).

* Angular attention: full MHSA over the A^2 view tokens.
* Spatial attention: MHSA over the h*w pixel tokens restricted to a k x k
  window. `dense` applies the reference's static window mask to full
  attention (model/LFT.py:147-162); `tiled` runs query tiles against key
  halo blocks with an exact static mask, and never builds an (hw)^2 object.

These are the building blocks of the unfused forward and of the fused
kernels' plain versions. `local_attention(impl='pallas')` hands over to
the per-op kernel dispatch of `kernels/local_attn.py`. Weights follow
`nn.MultiheadAttention`: packed
`in_proj_weight [3E, E]` (rows Wq; Wk; Wv) and `out_proj.weight [E, E]`,
no biases.

On bf16 tensors (`--dtype bfloat16`'s unfused branch) every op rounds where
lft_tpu's XLA ops round on bf16 arrays (lft_tpu/ops/attention.py): the
scale is itself bf16 (`jnp.asarray(dh, bf16) ** -0.5`: 0.353515625 at
dh = 8), `q * scale` is rounded, each product sums in f32 and rounds once,
and the softmax rounds its `x - max`, its exp, its sum (taken in f32) and
its divide (`jax.nn.softmax`). Where a bf16 tensor meets an f32 one the
result is f32, as jnp promotes: the tiled op adds its f32 halo mask to the
bf16 scores (`local_attention_tiled`), so its softmax, output and
out-projection are f32, where the dense op casts its mask to the scores'
dtype (`multi_head_attention`) and stays bf16. Products of a promoted f32
activation and a bf16 weight run in f32 (`kernels.common.mm`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from lft_torch.kernels.common import attention_route, mm

NEG_INF = -1e30  # finite: no NaN from (-inf) - (-inf); every row has a key


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., T, E] -> [..., H, T, dh]."""
    *lead, T, E = x.shape
    return x.reshape(*lead, T, num_heads, E // num_heads).movedim(-2, -3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, T, dh] -> [..., T, E]."""
    *lead, H, T, dh = x.shape
    return x.movedim(-3, -2).reshape(*lead, T, H * dh)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis: torch's; on bf16 as `jax.nn.softmax`
    computes it on a bf16 array: x - max, its exp, their sum (in f32,
    rounded once) and the divide, each rounded to bf16."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=-1)
    e = torch.exp((x - x.amax(-1, keepdim=True)).float()).bfloat16()
    return (e.float() / e.float().sum(-1, keepdim=True).bfloat16().float()).bfloat16()


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, mask=None) -> torch.Tensor:
    """Softmax attention over the -2 axis of PROJECTED [..., T, E] q/k/v,
    heads split from E; `mask` is additive, broadcastable to
    [..., H, Tq, Tk] (an f32 mask promotes bf16 scores to f32). On bf16 q
    the scale is bf16 and q * scale rounded (module docstring)."""
    dh = q.shape[-1] // num_heads
    scale = float(dh) ** -0.5
    if q.dtype == torch.bfloat16:
        scale = torch.tensor(scale, dtype=torch.bfloat16, device=q.device)
    scores = mm(_split_heads(q, num_heads) * scale, _split_heads(k, num_heads).transpose(-1, -2))
    if mask is not None:
        scores = scores + mask
    return _merge_heads(mm(softmax(scores), _split_heads(v, num_heads)))


def multi_head_attention(q_in, k_in, v_in, in_proj_weight, out_proj_weight,
                         num_heads: int, mask=None) -> torch.Tensor:
    """torch-parity MHA over the -2 axis of [..., T, E] inputs; `mask` is
    cast to the scores' dtype, as lft_tpu casts it."""
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    q, k = mm(q_in, wq.T), mm(k_in, wk.T)
    if mask is not None:
        mask = mask.to(torch.promote_types(q.dtype, k.dtype))
    out = attention_heads(q, k, mm(v_in, wv.T), num_heads, mask)
    return mm(out, out_proj_weight.T)


@functools.lru_cache(maxsize=None)
def local_window_mask(h: int, w: int, k: int) -> np.ndarray:
    """Dense additive mask [(h w), (h w)]: 0 where the key lies in the
    query's k x k window, NEG_INF elsewhere (reference SpaTrans.gen_mask)."""
    r_lo = k // 2
    r_hi = k - r_lo - 1
    ii = np.arange(h)
    jj = np.arange(w)
    di = ii[:, None] - ii[None, :]
    dj = jj[:, None] - jj[None, :]
    ok_i = (di <= r_lo) & (-di <= r_hi)
    ok_j = (dj <= r_lo) & (-dj <= r_hi)
    ok = ok_i[:, None, :, None] & ok_j[None, :, None, :]
    return np.where(ok, 0.0, NEG_INF).astype(np.float32).reshape(h * w, h * w)


@functools.lru_cache(maxsize=None)
def _halo_mask(h: int, w: int, t: int, k: int) -> np.ndarray:
    """Additive mask [nth, ntw, t*t, (t+2r)^2] of tiled local attention:
    0 iff the halo key is inside the image and the query's window."""
    r = k // 2
    nth, ntw = h // t, w // t
    hl = t + 2 * r
    qi = np.arange(t)
    ki = np.arange(hl) - r
    ok_row = np.abs(qi[:, None] - ki[None, :]) <= r
    mask = np.full((nth, ntw, t, t, hl, hl), NEG_INF, dtype=np.float32)
    for ti in range(nth):
        gi = ti * t + ki
        in_i = (gi >= 0) & (gi < h)
        for tj in range(ntw):
            gj = tj * t + ki
            in_j = (gj >= 0) & (gj < w)
            ok = (ok_row[:, None, :, None] & ok_row[None, :, None, :]
                  & in_i[None, None, :, None] & in_j[None, None, None, :])
            mask[ti, tj] = np.where(ok, 0.0, NEG_INF)
    return mask.reshape(nth, ntw, t * t, hl * hl)


def _pick_tile(h: int, w: int):
    for t in (8, 16, 4, 32):
        if h % t == 0 and w % t == 0:
            return t
    return None


def _extract_halo(x: torch.Tensor, t: int, r: int) -> torch.Tensor:
    """[B, h, w, E] -> [B, nth, ntw, (t+2r)^2, E] overlapping halo blocks
    (zero outside the image)."""
    B, h, w, E = x.shape
    hl = t + 2 * r
    xp = F.pad(x, (0, 0, r, r, r, r))                       # [B, h+2r, w+2r, E]
    blocks = xp.unfold(1, hl, t).unfold(2, hl, t)           # [B, nth, ntw, E, hl, hl]
    nth, ntw = blocks.shape[1], blocks.shape[2]
    return blocks.reshape(B, nth, ntw, E, hl * hl).transpose(-1, -2)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int, ksize: int = 5, impl: str = "auto", t=None):
    """k x k-window attention of PROJECTED [B, h, w, E] q/k/v images; keys
    outside the image are excluded. impl: 'auto' | 'tiled' | 'dense' (the
    tiled op's mask is f32, the dense op's the scores' dtype, as in
    lft_tpu: on bf16 the tiled op returns f32); `t`
    fixes the tiled op's query tile edge, which must divide h and w (default:
    the first of 8, 16, 4, 32 that does)."""
    B, h, w, E = q.shape
    if t is None:
        t = _pick_tile(h, w)
    if impl == "tiled" or (impl == "auto" and t is not None):
        if t is None:
            raise ValueError(f"no valid tile size for ({h}, {w}); use impl='dense'")
        r = ksize // 2
        nth, ntw = h // t, w // t
        q_t = q.reshape(B, nth, t, ntw, t, E).transpose(2, 3)
        q_t = q_t.reshape(B, nth, ntw, t * t, E)
        mask = torch.from_numpy(_halo_mask(h, w, t, ksize)).to(q.device)
        out = attention_heads(q_t, _extract_halo(k, t, r), _extract_halo(v, t, r),
                              num_heads, mask[:, :, None])
        out = out.reshape(B, nth, ntw, t, t, E).transpose(2, 3)
        return out.reshape(B, h, w, E)
    mask = torch.from_numpy(local_window_mask(h, w, ksize)).to(q.device, q.dtype)
    out = attention_heads(q.reshape(B, h * w, E), k.reshape(B, h * w, E),
                          v.reshape(B, h * w, E), num_heads, mask)
    return out.reshape(B, h, w, E)


def local_attention(qn: torch.Tensor, v: torch.Tensor, in_proj_weight,
                    out_proj_weight, num_heads: int, k: int = 5,
                    impl: str = "auto") -> torch.Tensor:
    """Local-window spatial MHA over [B, h, w, E] token images: q = k from
    the normed tokens `qn`, v from the raw tokens (model/LFT.py:183-187).

    impl: 'auto' | 'dense' | 'tiled' | 'pallas'. 'pallas' is the per-op
    kernel dispatch (kernels/local_attn.py); 'auto' takes it for a CUDA
    tensor of a width the kernels take (E = 2C:
    `kernels.common.attention_route`), as the JAX package does on its
    accelerator, and the tiled or dense op otherwise."""
    E = qn.shape[-1]
    if impl == "auto" and E % num_heads == 0:
        impl = attention_route(impl, qn.device.type, E // 2)
    if impl == "pallas":
        from lft_torch.kernels.local_attn import local_attention_pallas
        return local_attention_pallas(qn, v, in_proj_weight, out_proj_weight,
                                      num_heads=num_heads, k=k)
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = windowed_attention(mm(qn, wq.T), mm(qn, wk.T), mm(v, wv.T), num_heads, k, impl)
    return mm(out, out_proj_weight.T)
