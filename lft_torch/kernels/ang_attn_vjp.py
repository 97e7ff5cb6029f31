"""K8: per-op angular attention as a sweep over the key views, any view
count (counterpart of lft_tpu/kernels/ang_attn_vjp.py).

`ang_attention(q, k, v, num_heads)` is full multi-head attention over the A2
view tokens of each pixel, [N, A2, C] -> [N, A2, C], scale (C / heads)^-0.5
inside, computed as an online softmax over the key views. On a CUDA tensor it
launches the hand-written kernels of `lft_torch/csrc/ang_attn_sweep.cu`; on a
CPU tensor it runs the plain PyTorch versions below. There is no fallback from
one to the other.

Training: when grad mode is on and q, k or v requires grad it runs as
`AngSweepFn`, whose forward also returns the per-(token, head) softmax max m
and denominator l (`ang_attn_sweep_res`) and saves (q, k, v, out, m, l), as
the JAX package does; the backward (`ang_attn_sweep_bwd`) takes
D = rowsum_head(dout * out) from the saved output and rebuilds the
probabilities from (m, l).

`ang_attention_pallas_ad` is the AngTrans attention around it: the q/k/v and
out projections as `torch.matmul`, as the JAX package leaves them to XLA. The
JAX wrapper's pixel-pair packing (16 heads on 2C lanes) fills the TPU's lanes
and is not carried over; it computes the same function.
"""

from __future__ import annotations

import ctypes

import torch

from lft_torch.kernels import _build
from lft_torch.kernels.ang_block import _heads, _merge, _needs_grad
from lft_torch.kernels.common import KERNEL_C

M_INIT = -1e30     # the sweep's first running max, as in the JAX kernel


# --------------------------------------------------------- plain versions ---

def ang_attention_sweep_plain(q, k, v, num_heads: int):
    """Plain version of K8's forward: the online softmax over the key views
    written out. Returns (out [N, A2, C], m, l [N, A2, H])."""
    dh = q.shape[-1] // num_heads
    qh = _heads(q, num_heads) * float(dh) ** -0.5                 # [N, H, A2, dh]
    kh, vh = _heads(k, num_heads), _heads(v, num_heads)
    m = qh.new_full(qh.shape[:-1], M_INIT)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for b in range(q.shape[1]):
        s = (qh * kh[:, :, b:b + 1]).sum(-1)
        m_new = torch.maximum(m, s)
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p
        acc = acc * corr[..., None] + p[..., None] * vh[:, :, b:b + 1]
        m = m_new
    out = _merge(acc / l[..., None])
    return out.contiguous(), m.transpose(1, 2).contiguous(), l.transpose(1, 2).contiguous()


def ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, num_heads: int):
    """Plain version of K8's backward: (dq, dk, dv) from (q, k, v, out, m, l,
    dout), the identities written out (D from the saved output)."""
    H = num_heads
    scale = float(q.shape[-1] // H) ** -0.5
    qh = _heads(q, H) * scale
    kh, vh, doh = _heads(k, H), _heads(v, H), _heads(dout, H)
    a = torch.exp(qh @ kh.transpose(-1, -2) - m.transpose(1, 2)[..., None]) \
        / l.transpose(1, 2)[..., None]                            # [N, H, A2, A2]
    D = (doh * _heads(out, H)).sum(-1, keepdim=True)
    ds = a * (doh @ vh.transpose(-1, -2) - D)
    return (_merge(ds @ kh).contiguous() * scale, _merge(ds.transpose(-1, -2) @ qh).contiguous(),
            _merge(a.transpose(-1, -2) @ doh).contiguous())


# -------------------------------------------------------- kernel wrappers ---

def _check_shape(kernel: str, q, num_heads: int) -> None:
    if q.dim() != 3 or q.shape[-1] not in KERNEL_C or num_heads != 8:
        raise NotImplementedError(
            f"{kernel} kernel takes [N, A2, C] tokens with C in {KERNEL_C} and 8 heads; got "
            f"shape {tuple(q.shape)}, heads={num_heads}")


def ang_attn_sweep_fwd(q, k, v, num_heads: int, with_stats: bool = False):
    """K8's forward: the CUDA kernel for CUDA tensors (`ang_attn_sweep`, or
    `ang_attn_sweep_res` with stats), the plain version for CPU tensors.
    with_stats: (out, m, l), else out."""
    if q.device.type != "cuda":
        out, m, l = ang_attention_sweep_plain(q, k, v, num_heads)
        return (out, m, l) if with_stats else out
    name = "ang_attn_sweep_res" if with_stats else "ang_attn_sweep"
    _check_shape(name, q, num_heads)
    _build.check_cuda_args(name, q, k, v)
    N, A2, C = q.shape
    out = torch.empty_like(q)
    tail = (N, A2, C, num_heads, float(C // num_heads) ** -0.5)
    types = (ctypes.c_int,) * 4 + (ctypes.c_float,)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if not with_stats:
        fn = _build.bind("ang_attn_sweep", "lft_ang_attn_sweep", 4, types)
        _build.launch("ang_attn_sweep", name, fn, q.device, *ptrs, *tail)
        return out
    m = torch.empty(N, A2, num_heads, device=q.device)
    l = torch.empty_like(m)
    fn = _build.bind("ang_attn_sweep", "lft_ang_attn_sweep_res", 6, types)
    _build.launch("ang_attn_sweep", name, fn, q.device, *ptrs, m.data_ptr(), l.data_ptr(), *tail)
    return out, m, l


def ang_attn_sweep_bwd(q, k, v, out, m, l, dout, num_heads: int):
    """K8's backward (`ang_attn_sweep_bwd`): (dq, dk, dv) [N, A2, C]."""
    if q.device.type != "cuda":
        return ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, num_heads)
    _check_shape("ang_attn_sweep_bwd", q, num_heads)
    _build.check_cuda_args("ang_attn_sweep_bwd", q, k, v, dout, out, m, l)
    N, A2, C = q.shape
    grads = tuple(torch.empty_like(q) for _ in range(3))
    fn = _build.bind("ang_attn_sweep", "lft_ang_attn_sweep_bwd", 10,
                     (ctypes.c_int,) * 4 + (ctypes.c_float,))
    _build.launch("ang_attn_sweep", "ang_attn_sweep_bwd", fn, q.device,
                  *(t.data_ptr() for t in (q, k, v, dout, out, m, l, *grads)),
                  N, A2, C, num_heads, float(C // num_heads) ** -0.5)
    return grads


class AngSweepFn(torch.autograd.Function):
    """K8 with stats forward, K8's backward; saves (q, k, v, out, m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        out, m, l = ang_attn_sweep_fwd(q, k, v, num_heads, with_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        return (*ang_attn_sweep_bwd(q, k, v, out, m, l, dout.contiguous(), ctx.num_heads), None)


def ang_attention(q, k, v, num_heads: int):
    """Differentiable attention over the view axis of projected [N, A2, C]
    q/k/v, any A2."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        return AngSweepFn.apply(q, k, v, num_heads)
    return ang_attn_sweep_fwd(q, k, v, num_heads)


def ang_attention_pallas_ad(qn, v, in_proj_weight, out_proj_weight, num_heads: int):
    """Drop-in for the AngTrans MHSA (q = k from the normed tokens `qn`, v
    from the raw ones; torch-packed projections) on [..., A2, C] tokens."""
    *lead, A2, C = qn.shape
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = ang_attention((qn @ wq.T).reshape(-1, A2, C), (qn @ wk.T).reshape(-1, A2, C),
                        (v @ wv.T).reshape(-1, A2, C), num_heads)
    return out.reshape(*lead, A2, C) @ out_proj_weight.T
