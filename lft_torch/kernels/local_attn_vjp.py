"""K9: per-op 5x5-window attention as a sweep over the window's offsets, any
view size (counterpart of lft_tpu/kernels/local_attn_vjp.py).

`windowed_attention(q, k, v, num_heads, ksize)` maps projected [B, h, w, E]
images to the attention output [B, h, w, E]: every pixel attends, per head,
to the keys of its ksize x ksize window that lie inside the image (scale
(E / heads)^-0.5 inside). The JAX kernel computes it as an online softmax
over the window's offsets, and so do the plain versions below. It is the
function of K5 (kernels/spa_attn_hp.py), so on a CUDA tensor K9 launches
K5's hand-written kernels (`lft_torch/csrc/spa_attn_hp.cu`: the forward
K2.3's window kernel of `csrc/window_attn.cuh`, the backward K5's two
passes), which take any h and w, counted under K9's names. On a CPU tensor
it runs the plain versions. There is no fallback from one to the other.

Training: when grad mode is on and q, k or v requires grad it runs as
`SpaOffsetFn`, whose forward also returns the per-(pixel, head) softmax max m
and denominator l (`spa_attn_offset_res`) and saves (q, k, v, m, l), and the
output where the backward reads it: the plain backward takes
D = rowsum_head(dout * out) from it, as the JAX package does; on the card K5
bwd's pass q computes D itself (`spa_attn_offset_bwd`). All of it is f32
(the TPU backward streams k, v and dout as bf16 to fit its VMEM).

bf16 q, k, v (`--dtype bfloat16` serving): lft_tpu's kernel (:48-116)
widens q, k and v to f32, scales q, runs its online softmax in f32 and
rounds the output once. On the card `spa_attn_offset_bf16io` (K5's wrapper,
`spa_window_attn_kernel`'s bf16-IO instance, f32 inside), on the CPU the
plain version on the widened values, rounded once. Training in bf16: the
`_res` form (`spa_attn_offset_res_bf16io`, the same instance writing each
head's m and l) and the backward (`spa_attn_offset_bwd_bf16io`, lft_tpu's
_vjp_bwd on bf16 tensors, :282-341: f32 inside, nothing rounded but dq, dk
and dv, once, and D = rowsum_head(dout * out) over the SAVED BF16 OUTPUT,
:307, which differs from D formed from the scores by the output's
rounding); `SpaOffsetFn` saves the bf16 output on the card too, and K5's
passes take D from it (`lft_spa_attn_f32in_bwd_bf16io`). The plain
backward runs in float64 on the widened values and rounds once.

A channel count that the heads do not divide is refused with a ValueError:
the JAX kernel leaves the last E - heads * (E // heads) channels to no head
and returns NaN in them (0 / 0), and the model never makes such a shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lft_torch.kernels.ang_block import _needs_grad
from lft_torch.kernels.common import io_kernel, mm, on_card, plain_if
from lft_torch.kernels.spa_attn_hp import (_window_offsets, _window_valid, spa_attn_hp_bwd,
                                           spa_attn_hp_fwd)

M_INIT = -1e30     # the sweep's first running max and the score of an out-of-image offset


# --------------------------------------------------------- plain versions ---

def _padded_heads(t, r: int, num_heads: int):
    """[B, h, w, E] -> zero-padded [B, h + 2r, w + 2r, H, dh]."""
    B, h, w, E = t.shape
    return F.pad(t, (0, 0, r, r, r, r)).reshape(B, h + 2 * r, w + 2 * r, num_heads,
                                                E // num_heads)


def windowed_attention_offset_plain(q, k, v, num_heads: int, ksize: int):
    """Plain version of K9's forward: the online softmax over the window's
    offsets written out, an out-of-image offset scored M_INIT. Returns (out,
    m, l), m and l [B, h, w, H] per pixel and head."""
    B, h, w, E = q.shape
    r, H, dh = ksize // 2, num_heads, E // num_heads
    qh = q.reshape(B, h, w, H, dh) * float(dh) ** -0.5
    kp, vp = _padded_heads(k, r, H), _padded_heads(v, r, H)
    valid = torch.from_numpy(_window_valid(h, w, ksize)).to(q.device)
    m = qh.new_full((B, h, w, H), M_INIT)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for j, (dy, dx) in enumerate(_window_offsets(ksize)):
        ys, xs = slice(r + dy, r + dy + h), slice(r + dx, r + dx + w)
        s = (qh * kp[:, ys, xs]).sum(-1).masked_fill(~valid[:, :, j, None], M_INIT)
        m_new = torch.maximum(m, s)
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p
        acc = acc * corr[..., None] + p[..., None] * vp[:, ys, xs]
        m = m_new
    return (acc / l[..., None]).reshape(B, h, w, E).contiguous(), m, l


def windowed_attention_offset_bwd_plain(q, k, v, out, m, l, dout, num_heads: int, ksize: int):
    """Plain version of K9's backward: (dq, dk, dv) from (q, k, v, out, m, l,
    dout), the identities written out offset by offset; dk and dv collect in
    padded accumulators whose margins only ever receive zeros."""
    B, h, w, E = q.shape
    r, H, dh = ksize // 2, num_heads, E // num_heads
    scale = float(dh) ** -0.5
    qh = q.reshape(B, h, w, H, dh) * scale
    doh = dout.reshape(B, h, w, H, dh)
    kp, vp = _padded_heads(k, r, H), _padded_heads(v, r, H)
    valid = torch.from_numpy(_window_valid(h, w, ksize)).to(q.device)
    D = (doh * out.reshape(B, h, w, H, dh)).sum(-1)
    dq = torch.zeros_like(qh)
    dkp, dvp = torch.zeros_like(kp), torch.zeros_like(vp)
    for j, (dy, dx) in enumerate(_window_offsets(ksize)):
        ys, xs = slice(r + dy, r + dy + h), slice(r + dx, r + dx + w)
        s = (qh * kp[:, ys, xs]).sum(-1)
        a = (torch.exp(s - m) / l).masked_fill(~valid[:, :, j, None], 0.0)
        ds = a * ((doh * vp[:, ys, xs]).sum(-1) - D)
        dq += ds[..., None] * kp[:, ys, xs]
        dkp[:, ys, xs] += ds[..., None] * qh
        dvp[:, ys, xs] += a[..., None] * doh
    crop = lambda t: t[:, r:r + h, r:r + w].reshape(B, h, w, E).contiguous()
    return (dq * scale).reshape(B, h, w, E), crop(dkp), crop(dvp)


# -------------------------------------------------------- kernel wrappers ---

def _check_heads(kernel: str, q, num_heads: int) -> None:
    """On any device, before K5's kernel check (which K5's wrappers make)."""
    E = q.shape[-1]
    if E % num_heads:
        raise ValueError(
            f"{kernel}: {num_heads} heads do not divide E = {E}; the offset sweep would leave "
            f"the last {E - num_heads * (E // num_heads)} channels to no head")


def spa_attn_offset_fwd(q, k, v, num_heads: int, ksize: int, with_stats: bool = False):
    """K9's forward: K5's forward kernel for CUDA tensors, counted as
    `spa_attn_offset` (or `spa_attn_offset_res` with stats), the plain
    version for CPU tensors. with_stats: (out, m, l), else out. bf16
    tensors: `spa_attn_offset_bf16io` (module docstring)."""
    _check_heads("spa_attn_offset_res" if with_stats else "spa_attn_offset", q, num_heads)
    io_kernel("spa_attn_offset_res" if with_stats else "spa_attn_offset", q)
    if not on_card(q):
        if q.dtype == torch.bfloat16:
            out, m, l = windowed_attention_offset_plain(q.float(), k.float(), v.float(),
                                                        num_heads, ksize)
            return (out.bfloat16(), m, l) if with_stats else out.bfloat16()
        out, m, l = windowed_attention_offset_plain(q, k, v, num_heads, ksize)
        return (out, m, l) if with_stats else out
    return spa_attn_hp_fwd(q, k, v, num_heads, ksize, with_stats, kernel="spa_attn_offset")


def spa_attn_offset_bwd(q, k, v, out, m, l, dout, num_heads: int, ksize: int):
    """K9's backward: (dq, dk, dv) [B, h, w, E]; K5's two backward passes
    for CUDA tensors, counted as `spa_attn_offset_bwd`, which at f32 compute
    D themselves and do not read `out` (None will do there). bf16 tensors:
    `spa_attn_offset_bwd_bf16io`, D from the saved bf16 `out` (module
    docstring)."""
    _check_heads("spa_attn_offset_bwd", q, num_heads)
    io_kernel("spa_attn_offset_bwd", q)
    if not on_card(q):
        if q.dtype == torch.bfloat16:
            grads = windowed_attention_offset_bwd_plain(
                *(t.double() for t in (q, k, v, out, m, l, dout)), num_heads, ksize)
            return tuple(g.bfloat16() for g in grads)
        return windowed_attention_offset_bwd_plain(q, k, v, out, m, l, dout, num_heads, ksize)
    return spa_attn_hp_bwd(q, k, v, m, l, dout, num_heads, ksize, kernel="spa_attn_offset_bwd",
                           out=out)


class SpaOffsetFn(torch.autograd.Function):
    """K9 with stats forward, K9's backward; saves (q, k, v, m, l), and the
    output where the backward reads it: the plain backward, and the bf16
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, ksize):
        out, m, l = spa_attn_offset_fwd(q, k, v, num_heads, ksize, with_stats=True)
        ctx.plain = not on_card(q)
        ctx.save_for_backward(q, k, v, m, l,
                              out if ctx.plain or q.dtype == torch.bfloat16 else None)
        ctx.cfg = (num_heads, ksize)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l, out = ctx.saved_tensors
        with plain_if(ctx.plain):
            return (*spa_attn_offset_bwd(q, k, v, out, m, l, dout.contiguous(), *ctx.cfg),
                    None, None)


def windowed_attention(q, k, v, num_heads: int, ksize: int = 5):
    """Differentiable window attention on projected [B, h, w, E] q/k/v, any
    h and w."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        return SpaOffsetFn.apply(q, k, v, num_heads, ksize)
    return spa_attn_offset_fwd(q, k, v, num_heads, ksize)


def local_attention_pallas_ad(qn, v, in_proj_weight, out_proj_weight, num_heads: int,
                              k: int = 5):
    """Drop-in for ops.attention.local_attention (q = k from `qn`, v raw;
    torch-packed projections): the projections as `torch.matmul`, K9 for the
    window attention itself."""
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = windowed_attention(mm(qn, wq.T), mm(qn, wk.T), mm(v, wv.T), num_heads, k)
    return mm(out, out_proj_weight.T)
