"""K1/K4: the fused AngTrans block and its backward (counterpart of
lft_tpu/kernels/ang_block.py).

`ang_trans_block_fused` runs the whole block (reference model/LFT.py:
194-238) on pixel-major tokens [N, A2, C]: LN(x + ang_pe), q = k from the
normed tokens and v from the raw ones, 8-head attention over each pixel's
A2 view tokens, out-projection + residual, FFN + residual. On a CUDA tensor
it launches the hand-written kernels of `lft_torch/csrc/ang_block.cu`; on a
CPU tensor it runs the same functions in plain PyTorch. There is no
fallback from one to the other.

Training: when grad mode is on and an input or weight requires grad, the
block runs as `AngBlockFn`. Its forward is K1 "with residuals" (it also
returns the per-(token, head) softmax max m and denominator l, and the
attention output attn); its backward is K4, which recomputes xn, q, k, v,
x2, xn2 and the FFN hidden from x and the saved residuals, writes dx and the
per-token operands of every weight gradient, and leaves the weight gradients
to the deterministic `wgrad` reduction. K4 is three kernels for every
gated A2 (<= 128), so every gated geometry trains fused: a (token rows:
the recomputation, the FFN and LN2 backward, dattn = dx2 Woᵀ), b (the
attention backward, `ang_bwd_attn_pixels` whole pixels a block) and c
(K3.d's kernel at width C: the projections' and LN1's backward), q, k, v,
dattn and dsum passing through device memory. Steps a and c run their
products 3xTF32 on the tensor cores (`csrc/rowgemm.cuh`) in 128-row tiles
(`ang_bwd_tiles`), their weights split by the launch's first kernels into a
scratch of `rowgemm.ang_bwd_floats` floats. Its launches count as
`ang_block_bwd` at A2 <= 64 and as `ang_block_bwd128` beyond, so that a run
shows which geometry trained. The angular PE is a constant of the shapes:
its gradient is None.

`--dtype bfloat16`: a bf16 x runs K1 in bf16 IO, lft_tpu's K1 with `io` =
bf16, its rounding points listed at `ang_block_bf16io_plain`; on the card
the kernel's `ang_block_bf16io` instance. `--dtype mixed` under
LFT_MM_HP_SITES=none launches its bf16-operand instance `ang_block_bf16`
(f32 x and out, the products over bf16-rounded operands, lft_tpu's softmax
as in bf16 IO) and, training, `ang_block_res_bf16` (the same out; m the
token's max over its heads, l, attn f32 of bf16 values as lft_tpu stores
it), then K4 under the backward's own plan; under a site subset that rounds
some of K1's sites and not others, `ang_block[_res]_sites` (each product
bf16 or 3xTF32 as its site's bit of a runtime mask says, lft_tpu's
softmax; `csrc/ang_sites.cuh`);
likewise a backward subset that rounds some of K4's sites and not others
`ang_block_bwd[128]_sites`, and one that keeps them all f32 after a
forward that rounded `ang_block_bwd[128]_dp` (`common.card_bwd`).
Training under bf16 (lft_tpu's
custom VJP with `io` = bf16, ang_block.py:424-496): K1 res in bf16 IO
(`ang_block_res_bf16io`: m and l f32 as lft_tpu forms them, attn bf16), K4
in bf16 IO (`ang_block_bwd[128]_bf16io`: x, attn and dout bf16, every
operand it hands to `wgrad` bf16 but dx2, which stays f32; the rounding
points at `_ang_bwd_bf16io_plain`), `wgrad_bf16io`, and `AngBlockFn`
returns each weight gradient rounded once to bf16.
"""

from __future__ import annotations

import ctypes

import torch

from lft_torch.kernels import _build
from lft_torch.kernels.common import (KERNEL_C, active, bf16_round, card_bwd, fwd_kernel,
                                      io_kernel, no_plan, rd, rounds, site_mask)
from lft_torch.kernels.rowgemm import (RG_M, ang_bf16_floats, ang_block_floats, ang_bwd_floats,
                                      ang_sites_floats)
from lft_torch.kernels.wgrad import colsum, colsum_plain, wgrad, wgrad_plain
from lft_torch.ops.attention import attention_heads

LN_EPS = 1e-5
BLK = 128          # the JAX gate's key block: A2 <= 128 tokens per pixel
WEIGHTS = ("ln", "wq", "wk", "wv", "wo", "w1", "w2")


def ang_block_applicable(A2: int) -> bool:
    """Same outcome as lft_tpu.kernels.ang_block.ang_block_applicable."""
    return A2 <= BLK


def ang_block_trainable(A2: int, device_type: str) -> bool:
    """Whether the fused block can run FORWARD AND BACKWARD at this view
    count on this kind of device: on every device, wherever the gate passes
    (K4's kernels and their plain versions take every gated A2). A caller
    that trains sends a geometry that fails this to the unfused branch, as it
    sends one that fails `ang_block_applicable`."""
    return ang_block_applicable(A2)


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


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[N, A2, C] -> [N, H, A2, C/H]."""
    N, A2, C = t.shape
    return t.reshape(N, A2, num_heads, C // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[N, H, A2, dh] -> [N, A2, H*dh]."""
    N, H, A2, dh = t.shape
    return t.transpose(1, 2).reshape(N, A2, H * dh)


def ln_stats(x: torch.Tensor):
    """(xhat, rstd) of a LayerNorm over the last axis (biased variance)."""
    xc = x - x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    return xc * rstd, rstd


def ln_bwd(dxn, xhat, rstd, w):
    """Cotangent of the LayerNorm input, given that of its output."""
    dxh = dxn * w
    return rstd * (dxh - dxh.mean(-1, keepdim=True)
                   - xhat * (dxh * xhat).mean(-1, keepdim=True))


# ---------------------------------------------------------------- forward ---

def ang_block_plain(x: torch.Tensor, ang_pe: torch.Tensor, wts: dict,
                    num_heads: int, with_res: bool = False, plan=None):
    """Plain PyTorch version of K1: [N, A2, C] -> [N, A2, C]; with_res also
    returns m, l [N, A2, H] (per token and head: the softmax's row max and
    the sum of exp(s - m)) and attn [N, A2, C]. `plan`: `--dtype mixed`'s
    forward plan (kernels/common.py), followed as lft_tpu's K1 follows it.
    A bf16 x takes `ang_block_bf16io_plain`."""
    if x.dtype == torch.bfloat16:
        no_plan(plan, io_kernel("ang_block_res" if with_res else "ang_block", x))
        return ang_block_bf16io_plain(x, ang_pe, wts, num_heads, with_res)
    if active(plan) is not None:
        return _ang_block_planned(x, ang_pe, wts, num_heads, with_res, plan)
    ln = wts["ln"]
    xn = _ln(x + ang_pe, ln[0], ln[1])
    q, k, v = xn @ wts["wq"], xn @ wts["wk"], x @ wts["wv"]
    if with_res:
        dh = x.shape[-1] // num_heads
        s = (_heads(q, num_heads) * float(dh) ** -0.5) @ _heads(k, num_heads).transpose(-1, -2)
        m = s.amax(-1)                                        # [N, H, A2]
        e = torch.exp(s - m[..., None])
        l = e.sum(-1)
        a = _merge((e / l[..., None]) @ _heads(v, num_heads))
    else:
        a = attention_heads(q, k, v, num_heads)
    x2 = a @ wts["wo"] + x
    out = torch.relu(_ln(x2, ln[2], ln[3]) @ wts["w1"]) @ wts["w2"] + x2
    if not with_res:
        return out
    return (out, m.transpose(1, 2).contiguous(), l.transpose(1, 2).contiguous(),
            a.contiguous())


def ang_block_bf16io_plain(x, ang_pe, wts, num_heads: int, with_res: bool = False):
    """Plain version of K1 in bf16 IO: bf16 x [N, A2, C] -> bf16, at
    lft_tpu's rounding points (ang_block.py:_kernel :116-150 with io = bf16,
    the wrapper :194-213): xf = f32(x) + pe (the angular PE stays f32); xn =
    bf16(LN1(xf)) with the LN affine as f32; q = bf16(xn Wq), k = bf16(xn
    Wk), v = bf16(x Wv) from the raw x; f32 scores; e = exp(s - m) with m
    the token's max over every head and key (lft_tpu's row max), l the sum
    of the unrounded e, the product with v over bf16(e); attn = bf16(out *
    (1 / l)); x2 = bf16(bf16(attn Wo) + x); hid = bf16(relu(bf16(LN2(x2))
    W1)); out = bf16(bf16(hid W2) + x2). Every product's operands are bf16
    values (the weights rounded as lft_tpu casts them), summed in f32.
    with_res (lft_tpu's K1 res, :139-143): also m [N, A2, H] f32, the
    token's max over every head and key in each head's slot, l [N, A2, H]
    f32 (the sums of the unrounded e) and attn [N, A2, C] bf16."""
    B = bf16_round
    w = lambda n: B(wts[n].float())
    ln = wts["ln"].float()
    H = num_heads
    xf = x.float()
    xn = B(_ln(xf + ang_pe.float(), ln[0], ln[1]))
    q, k, v = B(xn @ w("wq")), B(xn @ w("wk")), B(xf @ w("wv"))
    s = (_heads(q, H) @ _heads(k, H).transpose(-1, -2)) * float(x.shape[-1] // H) ** -0.5
    m = s.amax(-1).amax(1, keepdim=True)                       # [N, 1, A2]
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)                                              # [N, H, A2]
    a = B(_merge((B(e) @ _heads(v, H)) * (1.0 / l)[..., None]))
    x2 = B(B(a @ w("wo")) + xf)
    hid = B(torch.relu(B(_ln(x2, ln[2], ln[3])) @ w("w1")))
    out = B(B(hid @ w("w2")) + x2).to(torch.bfloat16)
    if not with_res:
        return out
    return (out, m.expand(-1, H, -1).transpose(1, 2).contiguous(),
            l.transpose(1, 2).contiguous(), a.bfloat16())


def ang_block_bf16io_f64(x, ang_pe, wts, num_heads: int):
    """`ang_block_bf16io_plain`'s function in float64, rounded to bf16 at
    the same points (float64 of bf16 values): a yardstick for how far a
    version's f32 arithmetic lies from exact. Not on any path."""
    B = lambda t: t.to(torch.bfloat16).double()
    w = lambda n: B(wts[n].double())
    ln = wts["ln"].double()
    H = num_heads
    xf = x.double()
    xn = B(_ln(xf + ang_pe.double(), ln[0], ln[1]))
    q, k, v = B(xn @ w("wq")), B(xn @ w("wk")), B(xf @ w("wv"))
    s = (_heads(q, H) @ _heads(k, H).transpose(-1, -2)) * float(x.shape[-1] // H) ** -0.5
    e = torch.exp(s - s.amax(-1).amax(1, keepdim=True)[..., None])
    a = B(_merge((B(e) @ _heads(v, H)) / e.sum(-1)[..., None]))
    x2 = B(B(a @ w("wo")) + xf)
    hid = B(torch.relu(B(_ln(x2, ln[2], ln[3])) @ w("w1")))
    return B(B(hid @ w("w2")) + x2)


def _ang_block_planned(x, ang_pe, wts, num_heads, with_res, plan):
    """K1 under a mixed plan, in lft_tpu's order (ang_block.py:_kernel
    :110-152): each product's operands rounded where its site is, the
    softmax unnormalised through the e v product (e = exp(s - m) with m the
    token's max over every head, as lft_tpu's row max, so e rounds as
    there) and divided by l after. with_res: attn as lft_tpu stores it, at
    the `awo` site's dtype (ang_block.py:241-244), so bf16 values under a
    plan that rounds there."""
    R = lambda t, s: rd(t, plan, s)
    ln = wts["ln"]
    H = num_heads
    scale = float(x.shape[-1] // H) ** -0.5
    xn = _ln(x + ang_pe, ln[0], ln[1])
    q = R(xn, "aqkv") @ R(wts["wq"], "aqkv")
    k = R(xn, "aqkv") @ R(wts["wk"], "aqkv")
    v = R(x, "aqkv") @ R(wts["wv"], "aqkv")
    s = (_heads(R(q, "ascore"), H) @ _heads(R(k, "ascore"), H).transpose(-1, -2)) * scale
    m = s.amax(-1).amax(1, keepdim=True).expand(-1, H, -1)     # [N, H, A2]
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    a = _merge((R(e, "aav") @ _heads(R(v, "aav"), H)) / l[..., None])
    x2 = R(a, "awo") @ R(wts["wo"], "awo") + x
    hid = torch.relu(R(_ln(x2, ln[2], ln[3]), "affn") @ R(wts["w1"], "affn"))
    out = R(hid, "affn") @ R(wts["w2"], "affn") + x2
    if not with_res:
        return out
    return (out, m.transpose(1, 2).contiguous(), l.transpose(1, 2).contiguous(),
            R(a, "awo").contiguous())


def _check_kernel_shape(kernel: str, x, ang_pe, num_heads: int, max_a2: int) -> None:
    N, A2, C = x.shape
    if C not in KERNEL_C or num_heads != 8 or A2 > max_a2:
        raise NotImplementedError(
            f"{kernel} kernel takes C in {KERNEL_C}, 8 heads and A2 <= {max_a2}; "
            f"got C={C}, heads={num_heads}, A2={A2}")
    if tuple(ang_pe.shape) != (A2, C):
        raise ValueError(f"ang_pe must be [{A2}, {C}], got {tuple(ang_pe.shape)}")


def ang_block(x: torch.Tensor, ang_pe: torch.Tensor, wts: dict,
              num_heads: int, with_res: bool = False, plan=None):
    """K1 on [N, A2, C] tokens: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. with_res: (out, m, l, attn), counted as
    `ang_block_res`. On the card its six products run 3xTF32 on the tensor
    cores (`csrc/rowgemm.cuh`), the weights split by the launch's first
    kernel into a scratch of `rowgemm.ang_block_stream`'s layout. `plan`: a
    mixed forward plan; on the card `all` runs the f32 kernel and `none`
    `ang_block_bf16` (`common.fwd_kernel`), with_res `ang_block_res_bf16`
    (attn f32 of bf16 values); a subset that rounds some of K1's sites and
    not others `ang_block[_res]_sites` (the mask of its rounding sites,
    `common.site_mask`; attn rounded where `awo` rounds). A bf16 x
    launches `ang_block_bf16io` (bf16 in and out; the weights and LN
    affine as f32 tensors of bf16 values, the PE f32), with_res
    `ang_block_res_bf16io` (m, l f32, attn bf16). These four all-bf16 forms
    run one kernel (`csrc/ang_bf16.cuh`: bf16 `wgmma` on the weights rounded
    into `rowgemm.ang_bf16_stream`'s layout and held whole in shared memory,
    the attention on bf16 `mma.sync`); the `_sites` forms a kernel of their
    own (`csrc/ang_sites.cuh`: that design's bf16 products where their site
    rounds, 3xTF32 on the others split and streamed,
    `rowgemm.ang_sites_stream`; the attention bf16 or 3xTF32 by site)."""
    if x.device.type != "cuda":
        return ang_block_plain(x, ang_pe, wts, num_heads, with_res, plan)
    base = "ang_block_res" if with_res else "ang_block"
    name = fwd_kernel(base, x, plan)
    _check_kernel_shape(name, x, ang_pe, num_heads, BLK)
    N, A2, C = x.shape
    w = wts
    if x.dtype == torch.bfloat16:
        w = {n: wts[n].float().contiguous() for n in WEIGHTS}
        _build.check_cuda_args(name, x, dtype=torch.bfloat16)
        _build.check_cuda_args(name, ang_pe, *(w[n] for n in WEIGHTS))
    else:
        _build.check_cuda_args(name, x, ang_pe, *(w[n] for n in WEIGHTS))
    out = torch.empty_like(x)
    # scratch: the weights as the launch's first kernel prepares them (the
    # all-bf16 forms' bf16 copy, the `_sites` forms' bf16 copy and split
    # stream, the f32 forms' split stream)
    wf = torch.empty(ang_bf16_floats(C) if name.endswith(("_bf16io", "_bf16"))
                     else ang_sites_floats(C) if name.endswith("_sites")
                     else ang_block_floats(C), device=x.device)
    ptrs = [x.data_ptr(), ang_pe.data_ptr(), *(w[n].data_ptr() for n in WEIGHTS),
            wf.data_ptr(), out.data_ptr()]
    tail = (N, A2, C, num_heads, float(C // num_heads) ** -0.5)
    types = (ctypes.c_int,) * 4 + (ctypes.c_float,)
    if name.endswith("_sites"):
        tail, types = tail + (site_mask(plan, base),), types + (ctypes.c_int,)
    if not with_res:
        fn = _build.bind("ang_block", "lft_ang_block_fwd" + name[len("ang_block"):], 11, types)
        _build.launch("ang_block", name, fn, x.device, *ptrs, *tail)
        return out
    m = torch.empty(N, A2, num_heads, device=x.device)
    l = torch.empty_like(m)
    attn = torch.empty_like(x)
    fn = _build.bind("ang_block", "lft_ang_block_fwd" + name[len("ang_block"):], 14, types)
    _build.launch("ang_block", name, fn, x.device, *ptrs, m.data_ptr(),
                  l.data_ptr(), attn.data_ptr(), *tail)
    return out, m, l, attn


# --------------------------------------------------------------- backward ---

def ang_block_bwd_ops_plain(x, ang_pe, wts, m, l, attn, dout, num_heads: int, plan=None,
                            d_from_p: bool = False):
    """Plain version of the K4 kernel: recompute the block from x and the
    saved residuals, then backpropagate dout [N, A2, C]. Returns dx and the
    per-token operands of the weight gradients, each [T, *] with T = N*A2:
    (dx, xn, dq, dk, dv, dx2, xn2, dpre, hid, dln [1, 4, C]); dln holds
    the LayerNorm affine grads (LN1 w, b, LN2 w, b) summed over the tokens.
    `plan`: `--dtype mixed`'s backward plan, each product's operands rounded
    to bf16 where its site is, at lft_tpu's sites (ang_block.py:_bwd_kernel
    :304-382; the attention then in its order: scores from the rounded q
    and k, D = sum_j p_j dp_j, ds rounded with the scale in it). f32: D =
    dattn . attn, or with `d_from_p` (the forward rounded, so the saved attn
    is not this backward's sum p v) sum_j p_j dp_j, as lft_tpu forms it.
    A bf16 x (with bf16 attn and dout) takes `_ang_bwd_bf16io_plain`."""
    if x.dtype == torch.bfloat16:
        return _ang_bwd_bf16io_plain(x, ang_pe, wts, m, l, attn, dout, num_heads)
    R = lambda t, s: rd(t, plan, s)
    plan = active(plan)
    ln = wts["ln"]
    N, A2, C = x.shape
    H = num_heads
    scale = float(C // H) ** -0.5
    xhat1, rstd1 = ln_stats(x + ang_pe)
    xn = xhat1 * ln[0] + ln[1]
    q = R(xn, "aqkv") @ R(wts["wq"], "aqkv")
    k = R(xn, "aqkv") @ R(wts["wk"], "aqkv")
    v = R(x, "aqkv") @ R(wts["wv"], "aqkv")
    x2 = R(attn, "awo") @ R(wts["wo"], "awo") + x
    xhat2, rstd2 = ln_stats(x2)
    xn2 = xhat2 * ln[2] + ln[3]
    hid = torch.relu(R(xn2, "affn") @ R(wts["w1"], "affn"))

    dpre = torch.where(hid > 0, R(dout, "affn") @ R(wts["w2"], "affn").t(), 0.0)
    dxn2 = R(dpre, "affn") @ R(wts["w1"], "affn").t()
    dx2 = dout + ln_bwd(dxn2, xhat2, rstd2, ln[2])
    dattn = R(dx2, "awo") @ R(wts["wo"], "awo").t()
    # attention, per pixel and head, from the saved (m, l)
    m_, il = m.transpose(1, 2)[..., None], l.transpose(1, 2)[..., None]
    if plan is None:
        qh = _heads(q, H) * scale
        kh, vh, doh = _heads(k, H), _heads(v, H), _heads(dattn, H)
        p = torch.exp(qh @ kh.transpose(-1, -2) - m_) / il    # [N, H, A2, A2]
        dp = doh @ vh.transpose(-1, -2)
        if d_from_p:
            dsum = (p * dp).sum(-1, keepdim=True)
        else:
            dsum = (doh * _heads(attn, H)).sum(-1, keepdim=True)  # = sum_j p dp
        ds = p * (dp - dsum)
        dq = _merge(ds @ kh) * scale
    else:
        qh, kh = _heads(R(q, "ascore"), H), _heads(R(k, "ascore"), H)
        vh, doh = _heads(R(v, "aav"), H), _heads(R(dattn, "aav"), H)
        p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - m_) * (1.0 / il)
        dp = doh @ vh.transpose(-1, -2)
        ds = R(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale, "ascore")
        dq = _merge(ds @ kh)
        p = R(p, "aav")
    dk = _merge(ds.transpose(-1, -2) @ qh)
    dv = _merge(p.transpose(-1, -2) @ doh)
    dxn = R(dq, "aqkv") @ R(wts["wq"], "aqkv").t() + R(dk, "aqkv") @ R(wts["wk"], "aqkv").t()
    dx = dx2 + R(dv, "aqkv") @ R(wts["wv"], "aqkv").t() + ln_bwd(dxn, xhat1, rstd1, ln[0])
    cs = lambda t: t.reshape(-1, C).sum(0)
    dln = torch.stack([cs(dxn * xhat1), cs(dxn), cs(dxn2 * xhat2), cs(dxn2)])
    tok = lambda t: t.reshape(N * A2, -1)
    return (dx, tok(xn), tok(dq), tok(dk), tok(dv), tok(dx2), tok(xn2), tok(dpre),
            tok(hid), dln[None])


def _ang_bwd_bf16io_plain(x, ang_pe, wts, m, l, attn, dout, num_heads: int):
    """K4 in bf16 IO, lft_tpu's _bwd_kernel with io = bf16 (ang_block.py:
    305-394): x, attn, dout bf16, m and l f32 as K1 res saved them; every
    product over bf16 values, the weights rounded as lft_tpu casts them.
    Recomputed: xn = bf16(LN1(x + pe)), q = bf16(xn Wq), k = bf16(xn Wk), v =
    bf16(x Wv), x2 = bf16(bf16(attn Wo) + x), xn2 = bf16(LN2(x2)), pre = xn2
    W1, hid = bf16(relu(pre)). Backward: dpre = bf16((pre > 0) dout W2ᵀ),
    dxn2 = dpre W1ᵀ, dx2 = dout + LN2ᵀ(dxn2) (f32), dattn = bf16(bf16(dx2)
    Woᵀ); p = exp((q . k) scale - m) / l, dp = dattn . v, D = sum_j p_j dp_j,
    ds = bf16(p (dp - D) scale); dq = bf16(ds k), dk = bf16(dsᵀ q), dv =
    bf16(bf16(p)ᵀ dattn); dxn = dq Wqᵀ + dk Wkᵀ, dx = bf16((dx2 + dv Wvᵀ) +
    LN1ᵀ(dxn)). It computes in float64 between those points (its f32 results
    rounded to f32 once): lft_tpu's own f32 sums and LayerNorms (XLA on the
    CPU) lie within f32 rounding of exact, and where an f32 sum rounds to
    bf16 next, torch's f32 order turns a few values into the neighbouring
    bf16 value, which over a sum of such values (a weight gradient) leaves
    the result as much as 0.18 of lft_tpu's bf16-vs-f32 distance away
    (float64: 0.000; tests/test_torch_bf16train.py). Returns
    `ang_block_bwd_ops_plain`'s outputs: dx, xn, dq, dk, dv, xn2, dpre, hid
    bf16; dx2 and dln f32."""
    B = bf16_round
    w = lambda n: B(wts[n].double())
    ln = wts["ln"].double()
    N, A2, C = x.shape
    H = num_heads
    scale = float(C // H) ** -0.5
    xf, do = x.double(), dout.double()
    xhat1, rstd1 = ln_stats(xf + ang_pe.double())
    xn = B(xhat1 * ln[0] + ln[1])
    q, k, v = B(xn @ w("wq")), B(xn @ w("wk")), B(xf @ w("wv"))
    x2 = B(B(attn.double() @ w("wo")) + xf)
    xhat2, rstd2 = ln_stats(x2)
    xn2 = B(xhat2 * ln[2] + ln[3])
    pre = xn2 @ w("w1")
    hid = B(torch.relu(pre))
    dpre = B(torch.where(pre > 0, do @ w("w2").t(), 0.0))
    dxn2 = dpre @ w("w1").t()
    dx2 = (do + ln_bwd(dxn2, xhat2, rstd2, ln[2])).float().double()
    dattn = B(B(dx2) @ w("wo").t())
    qh, kh, vh, doh = _heads(q, H), _heads(k, H), _heads(v, H), _heads(dattn, H)
    p = (torch.exp((qh @ kh.transpose(-1, -2)) * scale - m.double().transpose(1, 2)[..., None])
         * (1.0 / l.double().transpose(1, 2))[..., None])
    dp = doh @ vh.transpose(-1, -2)
    ds = B(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale)
    dq, dk = B(_merge(ds @ kh)), B(_merge(ds.transpose(-1, -2) @ qh))
    dv = B(_merge(B(p).transpose(-1, -2) @ doh))
    dxn = dq @ w("wq").t() + dk @ w("wk").t()
    dx = B((dx2 + dv @ w("wv").t()) + ln_bwd(dxn, xhat1, rstd1, ln[0]))
    cs = lambda t: t.reshape(-1, C).sum(0)
    dln = torch.stack([cs(dxn * xhat1), cs(dxn), cs(dxn2 * xhat2), cs(dxn2)]).float()
    tok = lambda t: t.reshape(N * A2, -1)
    b = lambda t: tok(t).bfloat16()
    return (dx.bfloat16(), b(xn), b(dq), b(dk), b(dv), tok(dx2).float(), b(xn2), b(dpre),
            b(hid), dln[None])


def ang_bwd_tiles(T: int) -> int:
    """Rows of K4's LN partial sums: one a 128-row tile of steps a and c."""
    return -(-T // RG_M)


def ang_bwd_attn_pixels(A2: int) -> int:
    """Whole pixels a block of K4's step b: as many as fill its 256 threads
    (a thread a pixel, head and view), at least one (ang_block.cu:
    attn_pixels)."""
    return max(1, 256 // (8 * A2))


def ang_block_bwd_ops(x, ang_pe, wts, m, l, attn, dout, num_heads: int, plan=None,
                      d_from_p: bool = False):
    """The K4 kernels for CUDA tensors (counted as `ang_block_bwd` at A2 <=
    64, `ang_block_bwd128` beyond), the plain version for CPU tensors. Same
    outputs as `ang_block_bwd_ops_plain`, except that dln holds one partial
    sum per 128-row tile: [ang_bwd_tiles(T), 4, C]. Under a mixed plan that
    rounds every site the card launches the kernels' bf16-operand instances
    (`_bf16` after the name): each product of steps a and c one TF32 pass
    over bf16-rounded operands, step b's attention over rounded q, k, v,
    dattn, ds and p with D from those products (`csrc/ang_block.cu`). bf16
    x, attn and dout launch the bf16-IO instances (`_bf16io`; their outputs
    as `_ang_bwd_bf16io_plain`'s, bf16 but dx2 and dln). Under a plan that
    rounds some of its five sites and not others, the `_sites` instances
    (`_sites` after the name: each product of steps a and c BF or 3xTF32 as
    its site's bit of a runtime mask says, step b's roundings likewise).
    `d_from_p` (the forward rounded) with every K4 site f32 launches the
    `_dp` instance (step b forms D from its own p; the bf16-operand and
    site-subset instances always do): `common.card_bwd` names them all."""
    if x.device.type != "cuda":
        return ang_block_bwd_ops_plain(x, ang_pe, wts, m, l, attn, dout, num_heads, plan,
                                       d_from_p)
    N, A2, C = x.shape
    T = N * A2
    base = "ang_block_bwd128" if A2 > 64 else "ang_block_bwd"
    name = io_kernel(base, x)
    if x.dtype == torch.bfloat16:
        no_plan(plan, name)
    else:
        name += card_bwd(d_from_p, plan, base)
    _check_kernel_shape(name, x, ang_pe, num_heads, BLK)
    bio = x.dtype == torch.bfloat16
    w = {n: wts[n].float().contiguous() for n in WEIGHTS} if bio else wts
    ins = (x, ang_pe, *(w[n] for n in WEIGHTS), m, l, attn, dout)
    if bio:
        _build.check_cuda_args(name, x, attn, dout, dtype=torch.bfloat16)
        _build.check_cuda_args(name, ang_pe, *(w[n] for n in WEIGHTS), m, l)
    else:
        _build.check_cuda_args(name, *ins)
    dev = x.device
    e = lambda *s: torch.empty(*s, device=dev)
    eb = (lambda *s: torch.empty(*s, device=dev, dtype=torch.bfloat16)) if bio else e
    wf = e(ang_bwd_floats(C))   # scratch: the split weights of steps a and c
    outs = (eb(N, A2, C), eb(T, C), eb(T, C), eb(T, C), eb(T, C), e(T, C), eb(T, C),
            eb(T, 2 * C), eb(T, 2 * C), e(ang_bwd_tiles(T), 4, C))
    # what the three kernels hand on: q, k, v, dattn and dsum per token and head
    scratch = (e(T, C), e(T, C), e(T, C), e(T, C), e(T, num_heads))
    tail, types = (N, A2, C, num_heads, float(C // num_heads) ** -0.5), \
        (ctypes.c_int,) * 4 + (ctypes.c_float,)
    if name.endswith("_sites"):
        tail, types = tail + (site_mask(plan, base),), types + (ctypes.c_int,)
    # one C entry for both forms: `lft_ang_block_bwd` and the instance's suffix
    fn = _build.bind("ang_block", "lft_ang_block_bwd" + name[len(base):],
                     len(ins) + 1 + len(outs) + len(scratch), types)
    _build.launch("ang_block", name, fn, dev,
                  *(t.data_ptr() for t in ins + (wf,) + outs + scratch), *tail)
    return outs


def _bwd(ops, wg, cs, x, ang_pe, wts, m, l, attn, dout, num_heads, plan=None, d_from_p=False):
    plan = active(plan)
    kw = {} if plan is None else {"plan": plan}
    if d_from_p:
        kw["d_from_p"] = True
    dx, xn, dq, dk, dv, dx2, xn2, dpre, hid, dln = ops(x, ang_pe, wts, m, l, attn, dout,
                                                       num_heads, **kw)
    C = x.shape[-1]
    tok = lambda t: t.reshape(-1, C)
    # each weight grad over bf16 operands where its site rounds
    h = lambda site: {"half": True} if rounds(plan, site) else {}
    return (dx, cs(dln.reshape(dln.shape[0], -1)).reshape(4, C),
            wg(xn, dq, **h("aqkv")), wg(xn, dk, **h("aqkv")),
            wg(tok(x), dv, **h("aqkv")), wg(tok(attn), dx2, **h("awo")),
            wg(xn2, dpre, **h("affn")), wg(hid, tok(dout), **h("affn")))


def ang_block_bwd(x, ang_pe, wts, m, l, attn, dout, num_heads: int, plan=None,
                  d_from_p: bool = False):
    """The block's backward from x and the saved (m, l, attn): (dx,
    dln [4, C], dwq, dwk, dwv, dwo, dw1, dw2), weight grads in the `x @ W`
    layouts of `ang_weights`. K4, then `wgrad` and `colsum`; each takes its
    plain version for CPU tensors. `plan`: `--dtype mixed`'s backward plan;
    `d_from_p`: the forward rounded; the attention's D from its own p
    (`ang_block_bwd_ops_plain`, `common.card_bwd`)."""
    return _bwd(ang_block_bwd_ops, wgrad, colsum, x, ang_pe, wts, m, l, attn, dout,
                num_heads, plan, d_from_p)


def ang_block_bwd_plain(x, ang_pe, wts, m, l, attn, dout, num_heads: int, plan=None,
                        d_from_p: bool = False):
    """Plain version of `ang_block_bwd` (lft_tpu/kernels/ang_block.py:305-394
    in plain PyTorch), on any device."""
    return _bwd(ang_block_bwd_ops_plain, wgrad_plain, colsum_plain, x, ang_pe, wts, m, l,
                attn, dout, num_heads, plan, d_from_p)


class AngBlockFn(torch.autograd.Function):
    """K1 with residuals forward, K4 backward. Inputs: x [N, A2, C],
    ang_pe, the weights of `ang_weights` in WEIGHTS order, then the
    configuration, the mixed forward and backward plans among it (the
    backward's is kept in `ctx` for the backward). A bf16 x (with bf16
    weights) runs both in bf16 IO and returns bf16 gradients."""

    @staticmethod
    def forward(ctx, x, ang_pe, ln, wq, wk, wv, wo, w1, w2, num_heads, plain, plan, bwd_plan):
        wts = dict(zip(WEIGHTS, (ln, wq, wk, wv, wo, w1, w2)))
        fwd = ang_block_plain if plain else ang_block
        out, m, l, attn = fwd(x, ang_pe, wts, num_heads, with_res=True, plan=plan)
        ctx.save_for_backward(x, ang_pe, ln, wq, wk, wv, wo, w1, w2, m, l, attn)
        # d_from_p: the forward rounded, so the saved attn is not the backward's sum p v
        ctx.cfg = (num_heads, plain, bwd_plan, active(plan) is not None)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, ang_pe, *w, m, l, attn = ctx.saved_tensors
        num_heads, plain, bwd_plan, dp = ctx.cfg
        bwd = ang_block_bwd_plain if plain else ang_block_bwd
        dx, *dw = bwd(x, ang_pe, dict(zip(WEIGHTS, w)), m, l, attn, dout.contiguous(),
                      num_heads, bwd_plan, dp)
        if x.dtype == torch.bfloat16:   # lft_tpu's `c(dw, w)`: each f32 sum rounded once
            dw = [g.to(torch.bfloat16) for g in dw]
        return (dx, None, *dw, None, None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ang_trans_block_fused(x, ang_pe, params, prefix: str, num_heads: int,
                          plain: bool = False, plan=None, bwd_plan=None):
    """The whole AngTrans block on pixel-major tokens.

    x: [N, A2, C] (N = batch*h*w pixels); ang_pe: [A2, C]; params/prefix:
    the flat param dict and `altblock.{i}.ang_trans.`. Returns [N, A2, C].
    Differentiable through `AngBlockFn` when grad is needed; `plain=True`
    runs the plain versions on any device. `plan`, `bwd_plan`: the forward's
    and the backward's site plans under `--dtype mixed` (kernels/common.py;
    None: f32)."""
    wts = ang_weights(params, prefix)
    if _needs_grad(x, *wts.values()):
        return AngBlockFn.apply(x, ang_pe, *(wts[n] for n in WEIGHTS), num_heads, plain,
                                plan, bwd_plan)
    return (ang_block_plain if plain else ang_block)(x, ang_pe, wts, num_heads, plan=plan)


def ang_trans_block_plain(x, ang_pe, params, prefix: str, num_heads: int, plan=None,
                          bwd_plan=None):
    """Plain version of `ang_trans_block_fused`, on any device."""
    return ang_trans_block_fused(x, ang_pe, params, prefix, num_heads, plain=True, plan=plan,
                                 bwd_plan=bwd_plan)
