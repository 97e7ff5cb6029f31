"""Per-op 5x5-window spatial attention: K6, the hybrid and the projection
wrapper (counterpart of lft_tpu/kernels/spa_attn.py).

`windowed_attention_mxu(q, k, v, num_heads, ksize)` maps projected
[B, h, w, E] images to the window attention's output: every pixel attends,
per head, to the keys of its 5x5 window that lie inside the image. The JAX
kernel computes it tile-dense: the view is cut into `pick_tile`'s th x tw
query tiles, each tile's queries are scored against its whole (th+4) x
(tw+4) key halo, masked (outside the window or the image: -1e30, which
contributes exactly 0) and put through a plain softmax. The plain versions
below do the same. It is the function of K5 (kernels/spa_attn_hp.py), so on
a CUDA tensor K6 launches K5's hand-written kernels
(`lft_torch/csrc/spa_attn_hp.cu`: the forward K2.3's window kernel of
`csrc/window_attn.cuh`, the backward K5's two passes), which take any h and
w, counted under K6's names; a dense design would score ~10x the window's
pairs. `pick_tile` still decides the dispatch (a view it cannot tile
raises `ValueError` on any device, as lft_tpu's does). On a CPU tensor it
runs the plain versions. There is no fallback from one to the other. The
JAX module's name is kept; the matrix unit it names is the TPU's.

Training: when grad mode is on and q, k or v requires grad it runs as
`SpaMxuFn`, whose forward also returns the per-(pixel, head) softmax max m
and denominator l (`spa_attn_mxu_res`) and saves only (q, k, v, m, l), as the
JAX package does; the backward (`spa_attn_mxu_bwd`) rebuilds the
probabilities from them and takes D from a * (dout v^T).

bf16 q, k, v (`--dtype bfloat16` serving): lft_tpu's kernel with io = bf16
(:72-116) normalizes per head: f32 scores (q . k) scale over the bf16
values, m the head's own max, p = bf16(e / l) before the product with v,
the f32 sum rounded once. On the card `spa_attn_mxu_bf16io` (K5's wrapper,
`spa_window_attn_kernel`'s normalized bf16-IO instance), on the CPU
`windowed_attention_mxu_bf16_plain`. Training in bf16: `spa_attn_mxu_res_bf16io`
(the same kernel writing each head's m and l) and `spa_attn_mxu_bwd_bf16io`
(lft_tpu's _bwd_kernel with io = bf16, :120-180: a = exp(s - m) / l and D =
sum a (dout . v) in f32, ds = bf16(a (dov - D) scale) and bf16(a) before
their products, dq rounded once, dk and dv summed over the halos in f32 and
rounded once: K5's bf16-IO passes with p = e / l); their plain versions
`windowed_attention_mxu_bf16_plain(with_stats=True)` and
`windowed_attention_mxu_bwd_bf16_plain` (float64 between the rounding
points).

`windowed_attention_hybrid` picks a kernel per context as the JAX hybrid does
off a TPU: the window kernel K5 for the primal and for the training pair
wherever `headpacked_applicable`; else the offset sweep K9 for the primal
and K6's pair for training.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from lft_torch.kernels import local_attn_vjp
from lft_torch.kernels.ang_block import _needs_grad
from lft_torch.kernels.common import bf16_round, io_kernel, mm, on_card, plain_if
from lft_torch.kernels.spa_attn_hp import (_check_shape, headpacked_applicable, spa_attn_hp_bwd,
                                           spa_attn_hp_fwd, windowed_attention_headpacked)

MASKED = -1e30     # the additive mask of a key outside the window or the image


def pick_tile(h: int, w: int):
    """Same outcome as lft_tpu.kernels.spa_attn.pick_tile: the rectangular
    query tile (th, tw) dividing (h, w), or None if only degenerate tilings
    exist. It decides the dispatch and the plain versions' tiles."""
    for target in (128, 64, 32, 16, 8):
        for th in (8, 16, 4, 32, 64, 128, 2, 1):
            if th > target:
                continue
            tw = target // th
            if th * tw == target and h % th == 0 and w % tw == 0:
                return th, tw
    return None


# --------------------------------------------------------- plain versions ---

@functools.lru_cache(maxsize=None)
def _tile_mask(th: int, tw: int, r: int, h: int, w: int) -> np.ndarray:
    """[n_tiles, th*tw, (th+2r)*(tw+2r)] bool: halo key j lies in the image
    and in the window of the tile's query i."""
    hl_w = tw + 2 * r
    qi = np.arange(th * tw)[:, None]
    ki = np.arange((th + 2 * r) * hl_w)[None, :]
    q_y, q_x = qi // tw, qi % tw
    k_y, k_x = ki // hl_w - r, ki % hl_w - r
    in_win = (np.abs(q_y - k_y) <= r) & (np.abs(q_x - k_x) <= r)
    tiles = [in_win & (ti * th + k_y >= 0) & (ti * th + k_y < h)
             & (tj * tw + k_x >= 0) & (tj * tw + k_x < w)
             for ti in range(h // th) for tj in range(w // tw)]
    return np.asarray(tiles)


def _to_tiles(t, th: int, tw: int, num_heads: int):
    """[B, h, w, H*d] -> [B, n_tiles, H, th*tw, d]."""
    B, h, w, E = t.shape
    t = t.reshape(B, h // th, th, w // tw, tw, num_heads, E // num_heads)
    return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, -1, num_heads, th * tw, E // num_heads)


def _from_tiles(t, h: int, w: int, th: int, tw: int):
    """Inverse of `_to_tiles`: [B, n_tiles, H, th*tw, d] -> [B, h, w, H*d]."""
    B, _, H, _, d = t.shape
    t = t.reshape(B, h // th, w // tw, H, th, tw, d)
    return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, h, w, H * d)


def _to_halos(t, th: int, tw: int, r: int, num_heads: int):
    """[B, h, w, E] -> [B, n_tiles, H, nk, dh]: every tile's zero-padded halo."""
    B, h, w, E = t.shape
    blocks = F.pad(t, (0, 0, r, r, r, r)).unfold(1, th + 2 * r, th).unfold(2, tw + 2 * r, tw)
    blocks = blocks.reshape(B, -1, num_heads, E // num_heads, (th + 2 * r) * (tw + 2 * r))
    return blocks.transpose(-1, -2)


def _add_halos(t, h: int, w: int, th: int, tw: int, r: int):
    """Adjoint of `_to_halos`: [B, n_tiles, H, nk, dh] -> [B, h, w, E], each
    key summed over the tiles whose halo holds it."""
    B, _, H, _, dh = t.shape
    t = t.reshape(B, h // th, w // tw, H, th + 2 * r, tw + 2 * r, dh).permute(0, 1, 2, 4, 5, 3, 6)
    out = t.new_zeros(B, h + 2 * r, w + 2 * r, H, dh)
    for ti in range(h // th):
        for tj in range(w // tw):
            out[:, ti * th:ti * th + th + 2 * r, tj * tw:tj * tw + tw + 2 * r] += t[:, ti, tj]
    return out[:, r:r + h, r:r + w].reshape(B, h, w, H * dh).contiguous()


def _tile_geometry(q, num_heads: int, ksize: int):
    B, h, w, E = q.shape
    tile = pick_tile(h, w)
    if tile is None or E % num_heads:
        raise ValueError(f"no valid query tile for ({h}, {w}), or {num_heads} heads do not "
                         f"divide E = {E}; use the offset or the tiled spatial attention")
    return tile, ksize // 2


def _view_chunks(B: int, per_view: int) -> int:
    """Views a plain pass takes at once, so that one dense [.., nq, nk] score
    tensor stays near 2^28 floats."""
    return max(1, min(B, (1 << 28) // per_view))


def _scores(q_t, k_t, mask, scale: float):
    return (q_t * scale) @ k_t.transpose(-1, -2) + mask


def windowed_attention_mxu_plain(q, k, v, num_heads: int, ksize: int):
    """Plain version of K6's forward with stats: per tile and head the dense
    masked scores, a plain softmax, a @ v. Returns (out, m, l), m and l
    [B, h, w, H] per pixel and head."""
    (th, tw), r = _tile_geometry(q, num_heads, ksize)
    B, h, w, E = q.shape
    H, scale = num_heads, float(E // num_heads) ** -0.5
    valid = torch.from_numpy(_tile_mask(th, tw, r, h, w)).to(q.device)[:, None]
    mask = torch.zeros(valid.shape, device=q.device).masked_fill(~valid, MASKED)
    outs, ms, ls = [], [], []
    step = _view_chunks(B, valid.numel() * H)
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        s = _scores(_to_tiles(q[sl], th, tw, H), _to_halos(k[sl], th, tw, r, H), mask, scale)
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(-1, keepdim=True)
        outs.append(_from_tiles((e / l) @ _to_halos(v[sl], th, tw, r, H), h, w, th, tw))
        ms.append(_from_tiles(m, h, w, th, tw))
        ls.append(_from_tiles(l, h, w, th, tw))
    return torch.cat(outs).contiguous(), torch.cat(ms).contiguous(), torch.cat(ls).contiguous()


def windowed_attention_mxu_bf16_plain(q, k, v, num_heads: int, ksize: int,
                                      with_stats: bool = False):
    """Plain version of K6's forward on bf16 q, k, v -> bf16 (module
    docstring): per tile and head the dense masked scores in f32, the
    head's softmax, p rounded to bf16, p @ v rounded once. with_stats:
    (out, m, l), m and l f32 [B, h, w, H], each head's max and sum."""
    (th, tw), r = _tile_geometry(q, num_heads, ksize)
    B, h, w, E = q.shape
    H, scale = num_heads, float(E // num_heads) ** -0.5
    valid = torch.from_numpy(_tile_mask(th, tw, r, h, w)).to(q.device)[:, None]
    mask = torch.zeros(valid.shape, device=q.device).masked_fill(~valid, MASKED)
    outs, ms, ls = [], [], []
    step = _view_chunks(B, valid.numel() * H)
    for b0 in range(0, B, step):
        qf, kf, vf = (t[b0:b0 + step].float() for t in (q, k, v))
        s = (_to_tiles(qf, th, tw, H) @ _to_halos(kf, th, tw, r, H).transpose(-1, -2)) * scale
        m = (s + mask).amax(-1, keepdim=True)
        e = torch.exp(s + mask - m)
        l = e.sum(-1, keepdim=True)
        p = bf16_round(e / l)
        outs.append(_from_tiles(p @ _to_halos(vf, th, tw, r, H), h, w, th, tw))
        ms.append(_from_tiles(m, h, w, th, tw))
        ls.append(_from_tiles(l, h, w, th, tw))
    out = torch.cat(outs).bfloat16().contiguous()
    return (out, torch.cat(ms).contiguous(), torch.cat(ls).contiguous()) if with_stats else out


def windowed_attention_mxu_bwd_plain(q, k, v, m, l, dout, num_heads: int, ksize: int):
    """Plain version of K6's backward: (dq, dk, dv) from (q, k, v, m, l,
    dout), the dense identities written out per tile (D = rowsum(a * dout
    v^T)), dk and dv summed over the tiles that share a key."""
    (th, tw), r = _tile_geometry(q, num_heads, ksize)
    B, h, w, E = q.shape
    H, scale = num_heads, float(E // num_heads) ** -0.5
    valid = torch.from_numpy(_tile_mask(th, tw, r, h, w)).to(q.device)[:, None]
    mask = torch.zeros(valid.shape, device=q.device).masked_fill(~valid, MASKED)
    grads = ([], [], [])
    step = _view_chunks(B, valid.numel() * H)
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        q_t, do_t = _to_tiles(q[sl], th, tw, H), _to_tiles(dout[sl], th, tw, H)
        k_t, v_t = _to_halos(k[sl], th, tw, r, H), _to_halos(v[sl], th, tw, r, H)
        m_t, l_t = _to_tiles(m[sl], th, tw, H), _to_tiles(l[sl], th, tw, H)
        a = torch.exp(_scores(q_t, k_t, mask, scale) - m_t) / l_t
        dov = do_t @ v_t.transpose(-1, -2)
        ds = a * (dov - (a * dov).sum(-1, keepdim=True)) * scale
        grads[0].append(_from_tiles(ds @ k_t, h, w, th, tw))
        grads[1].append(_add_halos(ds.transpose(-1, -2) @ q_t, h, w, th, tw, r))
        grads[2].append(_add_halos(a.transpose(-1, -2) @ do_t, h, w, th, tw, r))
    return tuple(torch.cat(g).contiguous() for g in grads)


def windowed_attention_mxu_bwd_bf16_plain(q, k, v, m, l, dout, num_heads: int, ksize: int):
    """Plain version of K6's backward on bf16 q, k, v, dout (module
    docstring): per tile and head in float64 between lft_tpu's rounding
    points, a = exp(s - m) / l, ds and a rounded to bf16 before their
    products, dq, dk, dv rounded once to bf16."""
    (th, tw), r = _tile_geometry(q, num_heads, ksize)
    B, h, w, E = q.shape
    H, scale = num_heads, float(torch.tensor(float(E // num_heads) ** -0.5))
    valid = torch.from_numpy(_tile_mask(th, tw, r, h, w)).to(q.device)[:, None]
    grads = ([], [], [])
    step = _view_chunks(B, valid.numel() * H)
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        f = lambda t: t[sl].double()
        q_t, do_t = _to_tiles(f(q), th, tw, H), _to_tiles(f(dout), th, tw, H)
        k_t, v_t = _to_halos(f(k), th, tw, r, H), _to_halos(f(v), th, tw, r, H)
        m_t, l_t = _to_tiles(f(m), th, tw, H), _to_tiles(f(l), th, tw, H)
        s = (q_t @ k_t.transpose(-1, -2)) * scale
        a = (torch.exp(s - m_t) / l_t).masked_fill(~valid, 0.0)
        dov = do_t @ v_t.transpose(-1, -2)
        ds = bf16_round(a * (dov - (a * dov).sum(-1, keepdim=True)) * scale)
        grads[0].append(_from_tiles(ds @ k_t, h, w, th, tw))
        grads[1].append(_add_halos(ds.transpose(-1, -2) @ q_t, h, w, th, tw, r))
        grads[2].append(_add_halos(bf16_round(a).transpose(-1, -2) @ do_t, h, w, th, tw, r))
    return tuple(torch.cat(g).bfloat16().contiguous() for g in grads)


# -------------------------------------------------------- kernel wrappers ---

def spa_attn_mxu_fwd(q, k, v, num_heads: int, ksize: int, with_stats: bool = False):
    """K6's forward: K5's forward kernel for CUDA tensors, counted as
    `spa_attn_mxu` (or `spa_attn_mxu_res` with stats), the plain version for
    CPU tensors. with_stats: (out, m, l), else out. bf16 tensors:
    `spa_attn_mxu_bf16io` (module docstring)."""
    name = io_kernel("spa_attn_mxu_res" if with_stats else "spa_attn_mxu", q)
    if not on_card(q):
        if q.dtype == torch.bfloat16:
            return windowed_attention_mxu_bf16_plain(q, k, v, num_heads, ksize, with_stats)
        out, m, l = windowed_attention_mxu_plain(q, k, v, num_heads, ksize)
        return (out, m, l) if with_stats else out
    _check_shape(name, q, num_heads, ksize)
    _tile_geometry(q, num_heads, ksize)
    return spa_attn_hp_fwd(q, k, v, num_heads, ksize, with_stats, kernel="spa_attn_mxu")


def spa_attn_mxu_bwd(q, k, v, m, l, dout, num_heads: int, ksize: int):
    """K6's backward: (dq, dk, dv) [B, h, w, E]; K5's two backward passes
    for CUDA tensors, counted as `spa_attn_mxu_bwd`. bf16 tensors:
    `spa_attn_mxu_bwd_bf16io` (module docstring)."""
    name = io_kernel("spa_attn_mxu_bwd", q)
    if not on_card(q):
        if q.dtype == torch.bfloat16:
            return windowed_attention_mxu_bwd_bf16_plain(q, k, v, m, l, dout, num_heads, ksize)
        return windowed_attention_mxu_bwd_plain(q, k, v, m, l, dout, num_heads, ksize)
    _check_shape(name, q, num_heads, ksize)
    _tile_geometry(q, num_heads, ksize)
    return spa_attn_hp_bwd(q, k, v, m, l, dout, num_heads, ksize, kernel="spa_attn_mxu_bwd")


class SpaMxuFn(torch.autograd.Function):
    """K6 with stats forward, K6's backward; saves (q, k, v, m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, ksize):
        out, m, l = spa_attn_mxu_fwd(q, k, v, num_heads, ksize, with_stats=True)
        ctx.save_for_backward(q, k, v, m, l)
        ctx.cfg, ctx.plain = (num_heads, ksize), not on_card(q)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l = ctx.saved_tensors
        with plain_if(ctx.plain):
            return (*spa_attn_mxu_bwd(q, k, v, m, l, dout.contiguous(), *ctx.cfg), None, None)


def windowed_attention_mxu(q_img, k_img, v_img, num_heads: int, k: int = 5):
    """Differentiable tile-dense window attention on projected [B, h, w, E]
    q/k/v; needs `pick_tile(h, w)`."""
    q, kk, v = q_img.contiguous(), k_img.contiguous(), v_img.contiguous()
    if _needs_grad(q, kk, v):
        return SpaMxuFn.apply(q, kk, v, num_heads, k)
    return spa_attn_mxu_fwd(q, kk, v, num_heads, k)


def windowed_attention_hybrid(q_img, k_img, v_img, num_heads: int, k: int):
    """Window attention with the kernel chosen per context, as the JAX
    hybrid chooses off a TPU (and on a TPU under bf16: lft_tpu's
    `_use_headpacked_pair`): K5 for the primal and for the training pair
    wherever `headpacked_applicable`; else K9 for the primal and K6 for the
    training pair. The pair is fixed for both directions (their (m, l)
    layouts differ). The caller ensures `pick_tile(h, w)` and h*w <= 2048."""
    B, h, w, E = q_img.shape
    if headpacked_applicable(h, w, E, num_heads, k):
        return windowed_attention_headpacked(q_img, k_img, v_img, num_heads, k)
    if _needs_grad(q_img, k_img, v_img):
        return windowed_attention_mxu(q_img, k_img, v_img, num_heads, k)
    return local_attn_vjp.windowed_attention(q_img, k_img, v_img, num_heads, k)


def local_attention_tile_mxu(qn, v, in_proj_weight, out_proj_weight, num_heads: int,
                             k: int = 5, attention=windowed_attention_mxu):
    """Drop-in for ops.attention.local_attention (q = k from `qn`, v raw;
    torch-packed projections): the projections as `torch.matmul`,
    `attention` for the window attention itself."""
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = attention(mm(qn, wq.T), mm(qn, wk.T), mm(v, wv.T), num_heads, k)
    return mm(out, out_proj_weight.T)
