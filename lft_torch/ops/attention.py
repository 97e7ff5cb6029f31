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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from lft_torch.kernels.common import attention_route

NEG_INF = -1e30  # finite: no NaN from (-inf) - (-inf); every row has a key


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., T, E] -> [..., H, T, dh]."""
    *lead, T, E = x.shape
    return x.reshape(*lead, T, num_heads, E // num_heads).movedim(-2, -3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, T, dh] -> [..., T, E]."""
    *lead, H, T, dh = x.shape
    return x.movedim(-3, -2).reshape(*lead, T, H * dh)


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, mask=None) -> torch.Tensor:
    """Softmax attention over the -2 axis of PROJECTED [..., T, E] q/k/v,
    heads split from E; `mask` is additive, broadcastable to
    [..., H, Tq, Tk]."""
    dh = q.shape[-1] // num_heads
    q = _split_heads(q, num_heads) * float(dh) ** -0.5
    scores = q @ _split_heads(k, num_heads).transpose(-1, -2)
    if mask is not None:
        scores = scores + mask
    attn = torch.softmax(scores, dim=-1)
    return _merge_heads(attn @ _split_heads(v, num_heads))


def multi_head_attention(q_in, k_in, v_in, in_proj_weight, out_proj_weight,
                         num_heads: int, mask=None) -> torch.Tensor:
    """torch-parity MHA over the -2 axis of [..., T, E] inputs."""
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = attention_heads(q_in @ wq.T, k_in @ wk.T, v_in @ wv.T, num_heads,
                          mask)
    return out @ out_proj_weight.T


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
    outside the image are excluded. impl: 'auto' | 'tiled' | 'dense'; `t`
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
    mask = torch.from_numpy(local_window_mask(h, w, ksize)).to(q.device)
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
    out = windowed_attention(qn @ wq.T, qn @ wk.T, v @ wv.T, num_heads, k, impl)
    return out @ out_proj_weight.T
