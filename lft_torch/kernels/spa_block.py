"""K2/K3: the fused SpaTrans block and its backward (counterpart of
lft_tpu/kernels/spa_block.py, view-major form).

`spa_trans_block_fused` runs the whole block (reference model/LFT.py:
118-191) on view images [V, h, w, C] as five steps, each a hand-written
kernel of `lft_torch/csrc/spa_block.cu` on a CUDA tensor and its plain
PyTorch version on a CPU tensor:

  1 tokenize_ln     tok = unfold3x3(x) @ MLP;  xn = LN1(tok + pe_tok)
  2 qkv             q = xn Wq, k = xn Wk, v = tok Wv
  3 window_attn     5x5-window 8-head attention, out-of-image keys excluded
  4 outproj_ln      x2 = attn Wo + tok;  xn2 = LN2(x2)
  5 ffn_out         out = (relu(xn2 W1) W2 + x2) Wlin   (Token2SAI)

Training runs the block as `SpaBlockFn`: the forward is the same chain with
the window step also writing its per-(query, head) softmax max m and
denominator l, and saves x, tok, m, l and attn. The backward (K3,
`lft_torch/csrc/spa_block_bwd.cu`) runs the chain in reverse:

  a ffn_out_bwd     recompute x2, xn2, hid, y from attn and tok; Token2SAI,
                    FFN and LN2 backward -> dx2, dattn = dx2 Woᵀ
  b ln_qkv          recompute xn = LN1(tok + pe_tok), q, k, v (step 2's
                    kernel with an LN1 prologue: the forward's bit for bit)
  c window_attn_bwd dq per query; dk, dv per key as a gather over the <= 25
                    queries whose window holds it (K5's backward,
                    `csrc/spa_attn_hp.cu`, under K3's name)
  d qkv_ln_bwd      dxn = dq Wqᵀ + dk Wkᵀ, LN1 backward, dtok
  e tokenize_bwd    dx as a gather over the 9 transposed taps

Steps 2, 4, 5, a, b and d run their products 3xTF32 on the tensor cores as
row-tile products (`wgmma`, `lft_torch/csrc/rowgemm.cuh`; their weights
prepared as `kernels/rowgemm.py` sets out; step d is K4's step c at width
2C, `csrc/rowbwd.cuh`). Steps 1 and e are one implicit GEMM,
`out[t] = sum_tap in[t + s_tap] B[tap]`, run 3xTF32 on the tensor cores
(`wgmma`, `lft_torch/csrc/tokenize.cuh`): a first kernel of the launch splits the
weights into TF32 hi/lo parts in the layout the second reads (`tap_weights`
in plain PyTorch), and the wrapper picks the block's rectangle of pixels
(`tok_tile`, a function of the shapes only). The weight, LayerNorm and PE
gradients are reduced by `wgrad`/`colsum` (kernels/wgrad.py). `pe_tok` gets
a real gradient: it carries MLP.weight.
`spa_trans_block_plain` runs the plain versions of all of it on any device.
Under `--dtype mixed` the plain versions follow lft_tpu's per-site plans
(kernels/common.py: each product's operands rounded to bf16 where its site
is), and on the card a plan that rounds every site launches the steps'
bf16-operand instances (`_bf16` after each name): the backward's default
plan K3's, the forward's LFT_MM_HP_SITES=none K2's five and K11's two (the
activations f32, only a product's operands rounded; the window step with
lft_tpu's softmax, `window_attn_plain`), in a train step the window step
with its (m, l) (`spa_window_attn_res_bf16`, attn stored as bf16 values)
and the backward under its own plan; tok stays f32. A forward plan that
rounds some of a step's sites and not others (an LFT_MM_HP_SITES subset)
launches its `_sites` instance, with the mask of its rounding sites: K2.2
(`qk`, `v`), K2.3 (`score`, `av`; the `_res` form also `wo`, where its attn
residual rounds), K2.5 and K11.5 (`ffn`, `lin`); a step whose sites all
round takes `_bf16`, one whose sites all stay f32 the f32 kernel
(`common.card_fwd`). A backward plan that splits a K3 step's sites (an
LFT_MM_HP_BWD_SITES subset) likewise launches its `_sites` instance
(`common.card_bwd`): K3.a (`wo`, `ffn`, `lin`), K3.b and K3.d (`qk`, `v`),
K3.c (`score`, `av`); K3.e computes `tok` alone.
`--dtype bfloat16`: bf16 x runs the five steps in bf16 IO, lft_tpu's K2
with `io` = bf16 (spa_block.py:_kernel :116-203): each plain step computes
in f32 from bf16 inputs and rounds at lft_tpu's points (listed at each), and
on the card each step launches its `_bf16io` instance, the buffers between
them bf16. Training under it (lft_tpu's custom VJP with `io` = bf16,
:593-693): the window step with its (m, l) (`spa_window_attn_res_bf16io`),
K3's five steps in bf16 IO (`_bf16io` after each name; what each hands on
is bf16 but dx2, dtokpe and the LN partial sums, which lft_tpu keeps f32),
`wgrad_bf16io`, and `SpaBlockFn` returns each weight gradient and dpe_tok
rounded once to bf16. K11 takes bf16 tensors too (`spa_tokenize_ln_pm_bf16io`,
`spa_ffn_out_pm_bf16io`).
Step 3's kernel (`csrc/window_attn.cuh`) is also K5's forward; the geometry
of it and of K5's two-pass backward is mirrored here (`window_items`,
`window_thread`, `window_smem`, `hp_kv_items`, `hp_kv_smem`,
`hp_thread_pixels`).

K11, `pixel_major=True` (counterpart of lft_tpu's `_fwd_call(pixel_major=
True)`): the same forward on a pixel-major buffer x [Bb, h, w, A2, C] ->
[Bb, h, w, A2, C], each (batch, view) plane read and written in place through
its stride. Only step 1 reads x and only step 5 writes the output, so those
two run as `spa_tokenize_ln_pm` and `spa_ffn_out_pm` around the unchanged
steps 2-4, and no view-major copy of the buffer is made. Inference only, as
in the JAX package: a call that needs grad raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lft_torch.kernels import _build
from lft_torch.kernels.ang_block import _needs_grad, ln_bwd, ln_stats
from lft_torch.kernels.common import (KERNEL_C, active, bf16_round, card_bwd, fwd_kernel,
                                      mm_site_plan, no_plan, rd, rounds, site_mask)
from lft_torch.kernels.rowgemm import (RG_M, bf16_piece, ffn_out_bf16_floats,
                                       ffn_out_bwd_floats, ffn_out_floats, outproj_floats, piece,
                                       qkv_floats, qkv_ln_bwd_floats, split_tf32)
from lft_torch.kernels.spa_attn_hp import (_gather_window, _hp_geometry_exists,
                                           _scatter_window, _window_probs, _window_valid,
                                           spa_attn_hp_bwd)
from lft_torch.kernels.wgrad import colsum, colsum_plain, wgrad, wgrad_plain
from lft_torch.ops.attention import windowed_attention
from lft_torch.ops.unfold import unfold3x3_linear

WEIGHTS = ("ln", "wu", "wqk", "wv", "wo", "w1", "w2", "wlin")

LN_EPS = 1e-5


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
#
# `plan`: `--dtype mixed`'s site plan of the forward or the backward
# (kernels/common.py), None in float32. Each product's operands are rounded
# where its site is, at lft_tpu's sites (spa_block.py:_kernel :117-215,
# _bwd_kernel :427-568); q, k, v and the other intermediates are handed on
# unrounded and rounded where a product reads them, as the kernels do.
#
# A bf16 input takes the step in bf16 IO (`--dtype bfloat16`, lft_tpu's
# _kernel with io = bf16): f32 arithmetic over bf16 values (the weights
# rounded to bf16 as lft_tpu casts them, `_bw`; the LN affine f32) and bf16
# outputs, rounded at lft_tpu's points, listed at each step.

def _bw(wts, name):
    """A weight as the bf16-IO steps take it: f32 of its bf16 rounding."""
    return bf16_round(wts[name].float())


def _tap_sum(x, wu):
    """sum over the 9 taps of the shifted, zero-padded x [V, h, w, C] times
    wu[tap] [C, D], in tap order as lft_tpu adds its 9 products (:128-137)."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = 0
    for t in range(9):
        out = out + xp[:, t // 3:t // 3 + h, t % 3:t % 3 + w, :] @ wu[t]
    return out


def tokenize_ln_plain(x, pe_tok, wts, plan=None):
    """bf16 IO: tok_f = the f32 9-tap sum (in lft_tpu's tap order: a sum in
    another order rounds to the neighbouring bf16 value now and then); tok =
    bf16(tok_f) and xn = bf16(LN1(tok_f + pe_tok)), LN1 from the unrounded
    tok_f (:128-142)."""
    if x.dtype == torch.bfloat16:
        no_plan(plan, "spa_tokenize_ln_bf16io")
        tok_f = _tap_sum(x.float(), _bw(wts, "wu"))
        ln = wts["ln"].float()
        return (tok_f.bfloat16(),
                _ln(tok_f + bf16_round(pe_tok.float()), ln[0], ln[1]).bfloat16())
    tok = unfold3x3_linear(rd(x, plan, "tok"), rd(wts["mlp"], plan, "tok")).contiguous()
    return tok, _ln(tok + pe_tok, wts["ln"][0], wts["ln"][1])


def qkv_plain(xn, tok, wts, plan=None):
    """bf16 IO: q, k = bf16(xn Wqk), v = bf16(tok Wv) (:143-147)."""
    D = tok.shape[-1]
    if xn.dtype == torch.bfloat16:
        no_plan(plan, "spa_qkv_bf16io")
        qk = xn.float() @ _bw(wts, "wqk")
        return (qk[..., :D].bfloat16(), qk[..., D:].bfloat16(),
                (tok.float() @ _bw(wts, "wv")).bfloat16())
    qk = rd(xn, plan, "qk") @ rd(wts["wqk"], plan, "qk")
    return (qk[..., :D].contiguous(), qk[..., D:].contiguous(),
            rd(tok, plan, "v") @ rd(wts["wv"], plan, "v"))


def outproj_ln_plain(attn, tok, wts, plan=None):
    """bf16 IO: x2 = bf16(bf16(attn Wo) + tok), xn2 = bf16(LN2(x2)) (:196-197)."""
    if attn.dtype == torch.bfloat16:
        no_plan(plan, "spa_outproj_ln_bf16io")
        x2 = bf16_round(bf16_round(attn.float() @ _bw(wts, "wo")) + tok.float())
        ln = wts["ln"].float()
        return x2.bfloat16(), _ln(x2, ln[2], ln[3]).bfloat16()
    x2 = rd(attn, plan, "wo") @ rd(wts["wo"], plan, "wo") + tok
    return x2, _ln(x2, wts["ln"][2], wts["ln"][3])


def ffn_out_plain(xn2, x2, wts, plan=None):
    """bf16 IO: hid = bf16(relu(xn2 W1)), y = bf16(bf16(hid W2) + x2), out =
    bf16(y Wlin) (:198-202)."""
    if xn2.dtype == torch.bfloat16:
        no_plan(plan, "spa_ffn_out_bf16io")
        B = bf16_round
        y = B(B(B(torch.relu(xn2.float() @ _bw(wts, "w1"))) @ _bw(wts, "w2")) + x2.float())
        return (y @ _bw(wts, "wlin")).bfloat16()
    R = lambda t, s: rd(t, plan, s)
    y = R(torch.relu(R(xn2, "ffn") @ R(wts["w1"], "ffn")), "ffn") @ R(wts["w2"], "ffn") + x2
    return R(y, "lin") @ R(wts["wlin"], "lin")


def _planned_scores(q, k, num_heads: int, ksize: int, plan):
    """lft_tpu's window scores under a mixed plan: (q . k_j) scale from q
    and k rounded at the score site, -inf outside the image; and the
    rounded heads of q [B, h, w, H, dh] and windows of k."""
    B, h, w, E = q.shape
    dh = E // num_heads
    qh = rd(q, plan, "score").reshape(B, h, w, num_heads, dh)
    kw = _gather_window(rd(k, plan, "score"), ksize).reshape(B, h, w, -1, num_heads, dh)
    s = torch.einsum("byxhd,byxjhd->byxjh", qh, kw) * float(dh) ** -0.5
    valid = torch.from_numpy(_window_valid(h, w, ksize)).to(q.device)[..., None]
    return s.masked_fill(~valid, float("-inf")), qh, kw


def window_attn_plain(q, k, v, num_heads: int, ksize: int, plan=None, res: bool = False):
    """Plain version of the window step with stats: (attn, m, l), m and l
    [V, h, w, H] per query and head. Under a mixed plan in lft_tpu's order:
    e = exp(s - m) rounded at the av site through the e v product, then
    divided by l; m is the query's max over every head and its window's
    keys, those outside the image scoring 0 (lft_tpu's row max over the
    zero-padded halo), so that e rounds as there. bf16 IO (bf16 q, k, v;
    :154-192): the same m and e, f32 scores over the keys inside the image,
    l the sum of the unrounded e, the product with v over bf16(e), attn =
    bf16(out * (1 / l)). res: attn as a train step's forward stores it,
    lft_tpu's residual at the `wo` site's dtype (:346-348): bf16 values
    under a plan that rounds there (the serving form leaves that rounding
    to step 4, as its kernel does)."""
    B, h, w, E = q.shape
    io = q.dtype == torch.bfloat16
    if io:
        no_plan(plan, "spa_window_attn_bf16io")
        q, k, v = q.float(), k.float(), v.float()
    if io or active(plan) is not None:
        s, _, _ = _planned_scores(q, k, num_heads, ksize, plan)
        pad = ~torch.from_numpy(_window_valid(h, w, ksize)).to(q.device).all(-1)
        m = s.amax((3, 4))
        m = torch.where(pad, m.clamp(min=0.0), m)[..., None].expand(-1, -1, -1, num_heads)
        e = torch.exp(s - m[:, :, :, None])
        l = e.sum(3)
        vw = _gather_window(rd(v, plan, "av"), ksize).reshape(B, h, w, -1, num_heads,
                                                               E // num_heads)
        o = torch.einsum("byxjh,byxjhd->byxhd", bf16_round(e) if io else rd(e, plan, "av"), vw)
        attn = (o * (1.0 / l)[..., None]).bfloat16() if io else o / l[..., None]
        if res:
            attn = rd(attn, plan, "wo")
        return attn.reshape(B, h, w, E).contiguous(), m.contiguous(), l.contiguous()
    p, _, m, l = _window_probs(q, k, num_heads, ksize)
    vw = _gather_window(v, ksize).reshape(B, h, w, -1, num_heads, E // num_heads)
    attn = torch.einsum("byxjh,byxjhd->byxhd", p, vw).reshape(B, h, w, E)
    return attn.contiguous(), m.contiguous(), l.contiguous()


# ----------------------------------------------------- plain backward steps ---

def ffn_out_bwd_plain(attn, tok, dout, wts, plan=None):
    """Plain version of step a: (dx2, dattn, y, dy, hid, dpre, xn2, dln2),
    dln2 [1, 2, D] = the LN2 affine grads summed over the tokens. bf16 IO
    (bf16 attn, tok, dout; lft_tpu's _bwd_kernel :448-482): x2 =
    bf16(bf16(attn Wo) + tok), xn2 = bf16(LN2(x2)), pre = xn2 W1, hid =
    bf16(relu(pre)), y = bf16(bf16(hid W2) + x2); dy = dout Wlinᵀ (f32),
    dpre = bf16((pre > 0) bf16(dy) W2ᵀ), dxn2 = dpre W1ᵀ, dx2 = dy +
    LN2ᵀ(dxn2) (f32: step d adds it into dtok), dattn = bf16(bf16(dx2)
    Woᵀ); dattn, y, dy, hid, dpre and xn2 out as bf16, dx2 and dln2 f32.
    The bf16-IO backward steps compute in float64 between lft_tpu's rounding
    points, their f32 results rounded to f32 once (K4's plain version,
    kernels/ang_block.py:_ang_bwd_bf16io_plain, says why)."""
    if attn.dtype == torch.bfloat16:
        return _ffn_out_bwd_bf16io(attn, tok, dout, wts)
    R = lambda t, s: rd(t, plan, s)
    ln = wts["ln"]
    D = tok.shape[-1]
    x2 = R(attn, "wo") @ R(wts["wo"], "wo") + tok
    xhat2, rstd2 = ln_stats(x2)
    xn2 = xhat2 * ln[2] + ln[3]
    hid = torch.relu(R(xn2, "ffn") @ R(wts["w1"], "ffn"))
    y = R(hid, "ffn") @ R(wts["w2"], "ffn") + x2
    dy = R(dout, "lin") @ R(wts["wlin"], "lin").t()
    dpre = torch.where(hid > 0, R(dy, "ffn") @ R(wts["w2"], "ffn").t(), 0.0)
    dxn2 = R(dpre, "ffn") @ R(wts["w1"], "ffn").t()
    dx2 = dy + ln_bwd(dxn2, xhat2, rstd2, ln[2])
    dln2 = torch.stack([(dxn2 * xhat2).reshape(-1, D).sum(0), dxn2.reshape(-1, D).sum(0)])
    return (dx2, R(dx2, "wo") @ R(wts["wo"], "wo").t(), y, dy, hid, dpre, xn2, dln2[None])


def _ffn_out_bwd_bf16io(attn, tok, dout, wts):
    B = bf16_round
    w = lambda n: _bw(wts, n).double()
    ln = wts["ln"].double()
    D = tok.shape[-1]
    x2 = B(B(attn.double() @ w("wo")) + tok.double())
    xhat2, rstd2 = ln_stats(x2)
    xn2 = B(xhat2 * ln[2] + ln[3])
    pre = xn2 @ w("w1")
    hid = B(torch.relu(pre))
    y = B(B(hid @ w("w2")) + x2)
    dy = (dout.double() @ w("wlin").t()).float().double()
    dpre = B(torch.where(pre > 0, B(dy) @ w("w2").t(), 0.0))
    dxn2 = dpre @ w("w1").t()
    dx2 = (dy + ln_bwd(dxn2, xhat2, rstd2, ln[2])).float()
    dln2 = torch.stack([(dxn2 * xhat2).reshape(-1, D).sum(0), dxn2.reshape(-1, D).sum(0)])
    b = lambda t: t.bfloat16()
    return (dx2, b(B(dx2.double()) @ w("wo").t()), b(y), b(dy), b(hid), b(dpre), b(xn2),
            dln2[None].float())


def ln_qkv_plain(tok, pe_tok, wts, plan=None):
    """Plain version of step b: (xn, q, k, v). bf16 IO (bf16 tok and
    pe_tok, :433-445): xn = bf16(LN1(tok + pe_tok)) from the saved bf16 tok,
    then `qkv_plain`'s bf16 IO."""
    if tok.dtype == torch.bfloat16:
        ln = wts["ln"].float()
        xn = _ln(tok.float() + pe_tok.float(), ln[0], ln[1]).bfloat16()
        return (xn, *qkv_plain(xn, tok, wts))
    xn = _ln(tok + pe_tok, wts["ln"][0], wts["ln"][1])
    return (xn, *qkv_plain(xn, tok, wts, plan))


def window_attn_bwd_plain(q, k, v, attn, dattn, m, l, num_heads: int, ksize: int, plan=None):
    """Plain version of step c: (dq, dk, dv) from the saved (m, l). Under a
    mixed plan in lft_tpu's order (spa_block.py:_bwd_kernel :505-531): the
    scores from q and k rounded at the score site, D = sum_j p_j dp_j from
    dattn and v rounded at the av site, ds rounded with the scale in it, p
    rounded for dv; `attn` is not read. bf16 IO (bf16 q, k, v, dattn; the
    (m, l) of the window step's bf16 form, :503-540): that order over the
    bf16 values, dq, dk, dv summed in f32 and rounded once to bf16. f32:
    D = dattn . attn, or with `attn` None sum_j p_j dp_j (as the kernel
    forms it, where the forward rounded)."""
    B, h, w, E = q.shape
    H, dh = num_heads, E // num_heads
    if q.dtype == torch.bfloat16:
        f = lambda t: t.double()
        grads = window_attn_bwd_plain(f(q), f(k), f(v), None, f(dattn), f(m), f(l), H, ksize,
                                      mm_site_plan(True, frozenset()))
        return tuple(g.bfloat16() for g in grads)
    if active(plan) is not None:
        s, qh, kw = _planned_scores(q, k, H, ksize, plan)
        p = torch.exp(s - m[:, :, :, None]) * (1.0 / l)[:, :, :, None]
        doh = rd(dattn, plan, "av").reshape(B, h, w, H, dh)
        vw = _gather_window(rd(v, plan, "av"), ksize).reshape(B, h, w, -1, H, dh)
        dp = torch.einsum("byxhd,byxjhd->byxjh", doh, vw)
        ds = rd(p * (dp - (p * dp).sum(3, keepdim=True)) * float(dh) ** -0.5, plan, "score")
        dq = torch.einsum("byxjh,byxjhd->byxhd", ds, kw)
        dkw = torch.einsum("byxjh,byxhd->byxjhd", ds, qh)
        dvw = torch.einsum("byxjh,byxhd->byxjhd", rd(p, plan, "av"), doh)
        return (dq.reshape(B, h, w, E).contiguous(),
                _scatter_window(dkw.reshape(B, h, w, -1, E), ksize),
                _scatter_window(dvw.reshape(B, h, w, -1, E), ksize))
    p, qh, _, _ = _window_probs(q, k, H, ksize, m, l)
    doh = dattn.reshape(B, h, w, H, dh)
    vw = _gather_window(v, ksize).reshape(B, h, w, -1, H, dh)
    kw = _gather_window(k, ksize).reshape(B, h, w, -1, H, dh)
    dp = torch.einsum("byxhd,byxjhd->byxjh", doh, vw)
    if attn is None:
        dsum = (p * dp).sum(3)
    else:
        dsum = (doh * attn.reshape(B, h, w, H, dh)).sum(-1)     # = sum_j p dp
    ds = p * (dp - dsum[:, :, :, None])
    dq = torch.einsum("byxjh,byxjhd->byxhd", ds, kw) * float(dh) ** -0.5
    dkw = torch.einsum("byxjh,byxhd->byxjhd", ds, qh)
    dvw = torch.einsum("byxjh,byxhd->byxjhd", p, doh)
    return (dq.reshape(B, h, w, E).contiguous(), _scatter_window(dkw.reshape(B, h, w, -1, E), ksize),
            _scatter_window(dvw.reshape(B, h, w, -1, E), ksize))


def qkv_ln_bwd_plain(tok, pe_tok, dq, dk, dv, dx2, wts, plan=None):
    """Plain version of step d: (dtok, dtokpe, dln1); dtokpe is the LN1
    input's cotangent (summed over views it is pe_tok's gradient), dln1
    [1, 2, D] the LN1 affine grads. bf16 IO (bf16 tok, pe_tok, dq, dk, dv;
    f32 dx2; :541-557): dxn = dq Wqᵀ + dk Wkᵀ over the bf16 values, dtokpe =
    LN1ᵀ(dxn) f32 (xhat from tok + pe_tok), dtok = bf16((dx2 + dv Wvᵀ) +
    dtokpe); dtokpe and dln1 f32."""
    R = lambda t, s: rd(t, plan, s)
    ln = wts["ln"]
    D = tok.shape[-1]
    if tok.dtype == torch.bfloat16:
        f = lambda t: t.double()
        ln = f(ln)
        xhat1, rstd1 = ln_stats(f(tok) + f(pe_tok))
        wqk = f(_bw(wts, "wqk"))
        dxn = f(dq) @ wqk[:, :D].t() + f(dk) @ wqk[:, D:].t()
        dtokpe = ln_bwd(dxn, xhat1, rstd1, ln[0]).float()
        dln1 = torch.stack([(dxn * xhat1).reshape(-1, D).sum(0), dxn.reshape(-1, D).sum(0)])
        dtok = (f(dx2) + f(dv) @ f(_bw(wts, "wv")).t()) + f(dtokpe)
        return dtok.bfloat16(), dtokpe, dln1[None].float()
    xhat1, rstd1 = ln_stats(tok + pe_tok)
    wqk = R(wts["wqk"], "qk")
    dxn = R(dq, "qk") @ wqk[:, :D].t() + R(dk, "qk") @ wqk[:, D:].t()
    dtokpe = ln_bwd(dxn, xhat1, rstd1, ln[0])
    dln1 = torch.stack([(dxn * xhat1).reshape(-1, D).sum(0), dxn.reshape(-1, D).sum(0)])
    return dx2 + R(dv, "v") @ R(wts["wv"], "v").t() + dtokpe, dtokpe, dln1[None]


def tokenize_bwd_plain(dtok, wts, plan=None):
    """Plain version of step e: dx [V, h, w, C], the transposed 3x3
    tokenization of dtok [V, h, w, D]. bf16 IO (:557-568): dx =
    bf16(the f32 9-tap sum over bf16 dtok and taps)."""
    D, C9 = wts["mlp"].shape
    if dtok.dtype == torch.bfloat16:
        dx = F.conv_transpose2d(dtok.double().permute(0, 3, 1, 2),
                                _bw(wts, "mlp").double().reshape(D, C9 // 9, 3, 3), padding=1)
        return dx.permute(0, 2, 3, 1).bfloat16().contiguous()
    dx = F.conv_transpose2d(rd(dtok, plan, "tok").permute(0, 3, 1, 2),
                            rd(wts["mlp"], plan, "tok").reshape(D, C9 // 9, 3, 3), padding=1)
    return dx.permute(0, 2, 3, 1).contiguous()


# ------------------------------------ tokenization geometry and weights ---

TOK_M = 128               # token rows of a tokenization block (8 warps)
TOK_STAGES = 3            # the weight ring: 3 stages of at most 32 KB
TOK_STAGE_FLOATS = 8192
TOK_SMEM_MAX = 232448     # shared memory a block can use on an H100


def tok_smem(r: int, cw: int, cin: int, cout: int, ln: bool) -> int:
    """Shared memory bytes of a tokenization block over r x cw pixels, in
    channels `cin`, out channels `cout`, with the LayerNorm epilogue or not
    (the forward's): the band of (r + 2) x (cw + 2) pixels at a row stride of
    cin + 4 floats and the weight ring, or the epilogue's [128, cout + 8]
    tile if larger (tokenize.cuh:TapConv::smem)."""
    kc = min(cin, TOK_STAGE_FLOATS // (2 * cout))
    main = ((r + 2) * (cw + 2) * (cin + 4) + TOK_STAGES * kc * cout * 2) * 4
    return max(main, TOK_M * (cout + 8) * 4 if ln else 0)


def _best_tile(h: int, w: int, fits, what: str):
    """The (r, cw) of r <= h rows x cw <= w columns, r cw <= 128, for which
    `fits(r, cw)`: the fewest tiles of the view, then the smallest band,
    then the widest rectangle."""
    best = None
    for cw in range(1, min(w, TOK_M) + 1):
        r = min(h, TOK_M // cw)
        while r >= 1 and not fits(r, cw):
            r -= 1
        if r < 1:
            continue
        key = (-(-h // r) * -(-w // cw), (r + 2) * (cw + 2), -cw)
        if best is None or key < best[0]:
            best = (key, (r, cw))
    if best is None:
        raise ValueError(f"no {what} tile fits an {h}x{w} view")
    return best[1]


@functools.lru_cache(maxsize=None)
def tok_tile(h: int, w: int, C: int):
    """(r, cw): the rectangle of r image rows x cw columns of one view that
    a block of the tokenization and of its transpose takes (r cw <= 128
    tokens), such that both fit in shared memory: the fewest blocks, then
    the smallest band, then the widest rectangle. A function of the shapes
    only."""
    return _best_tile(h, w, lambda r, cw: max(tok_smem(r, cw, C, 2 * C, True),
                                              tok_smem(r, cw, 2 * C, C, False)) <= TOK_SMEM_MAX,
                      f"tokenization (C={C})")


def tok_bf16_smem(r: int, cw: int, C: int) -> int:
    """Shared memory bytes of a block of K2.1's bf16 forms (tok_bf16.cuh:
    TokBf16::bytes): the taps in bf16, 9 C 2C values, and two bands of (r +
    2) x (cw + 2) pixels at a row stride of C + 8 bf16 values."""
    return 2 * 9 * C * 2 * C + 2 * (r + 2) * (cw + 2) * (C + 8) * 2


@functools.lru_cache(maxsize=None)
def tok_bf16_tile(h: int, w: int, C: int):
    """(r, cw) of the tiles of K2.1's and K11.1's bf16 forms, chosen as
    `tok_tile` chooses, where their shared memory fits (the launch's check).
    A function of the shapes only."""
    return _best_tile(h, w, lambda r, cw: tok_bf16_smem(r, cw, C) <= TOK_SMEM_MAX,
                      f"bf16 tokenization (C={C})")


def tok_bf16_floats(C: int) -> int:
    """f32 words of the scratch of K2.1's bf16 forms: TokBf16<C>::ELEMS = 9
    C 2C bf16 values, two a word."""
    return 9 * C * C


def tap_weights(wu: torch.Tensor, backward: bool = False) -> torch.Tensor:
    """Plain version of the kernels' weight preparation (tokenize.cuh:
    tap_weights_kernel, the first kernel of each launch), which the CPU
    tests emulate the kernels from. The B operand from wu [9, C, D]: B[tap] =
    wu[tap] [C, D] (forward), or wu[8 - tap]ᵀ [D, C] (backward: the taps
    mirrored), split into TF32 hi/lo and laid out as `wgmma` reads a K-major
    operand without swizzle, [9, K / 8, 2, 2, N / 8, 8, 4]: (tap, k8 step kk,
    hi or lo, k half kh, n8 tile j, row n, t) holds B[tap][8 kk + 4 kh + t]
    [8 j + n], so a k8 step's hi (or lo) is core matrices of 8 columns x 4 k
    (128 bytes each), N / 8 of them along N, then the second k half."""
    B = wu.flip(0).transpose(1, 2) if backward else wu
    K, N = B.shape[1:]
    return torch.stack([piece(b, split_tf32) for b in B]).reshape(9, K // 8, 2, 2, N // 8, 8, 4)


def tap_weights_bf16(wu: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight preparation of K2.1's bf16 forms
    (tok_bf16.cuh: tok_bf16_weights_kernel): wu [9, C, D] rounded to bf16,
    each tap a `rowgemm.bf16_piece` ([C / 16, 2, D / 8, 8, 8]), flat."""
    return torch.cat([bf16_piece(t.float()) for t in wu])


# ------------------------------------------------------ kernel wrappers ---

def _io_args(kernel: str, acts, wts: dict, names):
    """The checks of a launch: its activations `acts` in their IO dtype
    (bf16 for a `_bf16io` instance, else f32) and the weights `names` of
    `wts` as f32 (a bf16 weight as the f32 tensor of its values). Returns
    {name: weight}."""
    io = acts[0].dtype
    w = {n: wts[n].float().contiguous() if io == torch.bfloat16 else wts[n] for n in names}
    if io == torch.bfloat16:
        _build.check_cuda_args(kernel, *acts, dtype=io)
        _build.check_cuda_args(kernel, *w.values())
    else:
        _build.check_cuda_args(kernel, *acts, *w.values())
    return w


def _sites_tail(name: str, plan, kernel: str) -> tuple:
    """The trailing argument of a `_sites` launch, the mask of `kernel`'s
    sites that round under `plan` (`common.site_mask`); none for another
    instance."""
    return (site_mask(plan, kernel),) if name.endswith("_sites") else ()


def _check_c(kernel: str, C: int) -> None:
    if C not in KERNEL_C:
        raise NotImplementedError(f"{kernel} kernel takes C in {KERNEL_C}, got C={C}")


def _to_view_major(x):
    """[Bb, h, w, A2, C] -> a view-major copy [Bb * A2, h, w, C]."""
    Bb, h, w, A2, C = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(Bb * A2, h, w, C)


def _to_pixel_major(x, A2: int):
    """[Bb * A2, h, w, C] -> a pixel-major copy [Bb, h, w, A2, C]."""
    V, h, w, C = x.shape
    return x.reshape(V // A2, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()


def tokenize_ln(x, pe_tok, wts, pixel_major: bool = False, plan=None):
    """Step 1: x [V, h, w, C], pe_tok [h, w, D] -> (tok, xn) [V, h, w, D].
    pixel_major: x is [Bb, h, w, A2, C], V = Bb * A2, counted as
    `spa_tokenize_ln_pm`; tok and xn are view-major either way. On the card
    3xTF32 on the tensor cores (module docstring). `plan`: a mixed forward
    plan; on the card `all` runs the f32 kernel and one where `tok` rounds
    its bf16-operand instance `spa_tokenize_ln[_pm]_bf16` (x and wu rounded
    in the product), as for K2's other forward steps (`common.fwd_kernel`).
    A bf16 x launches `spa_tokenize_ln[_pm]_bf16io` (bf16 pe_tok, tok and
    xn). The bf16 forms run a kernel of their own (`csrc/tok_bf16.cuh`:
    the taps rounded into `tap_weights_bf16`'s layout and resident, bf16
    `wgmma` on a bf16 band, tiles of `tok_bf16_tile`)."""
    if x.device.type != "cuda":
        return tokenize_ln_plain(_to_view_major(x) if pixel_major else x, pe_tok, wts, plan)
    name = fwd_kernel("spa_tokenize_ln_pm" if pixel_major else "spa_tokenize_ln", x, plan)
    if pixel_major:
        Bb, h, w, A2, C = x.shape
        dims = (Bb, h, w, A2, C)
    else:
        Bb, h, w, C = x.shape
        A2, dims = 1, (Bb, h, w, C)
    D = wts["wu"].shape[-1]
    _check_c(name, C)
    if tuple(wts["wu"].shape) != (9, C, D) or tuple(pe_tok.shape) != (h, w, D) or D != 2 * C:
        raise ValueError(f"{name}: pe_tok {tuple(pe_tok.shape)} for x {tuple(x.shape)}")
    wk = _io_args(name, (x, pe_tok), wts, ("wu", "ln"))
    tok = torch.empty(Bb * A2, h, w, D, device=x.device, dtype=x.dtype)
    xn = torch.empty_like(tok)
    bf = name.endswith(("_bf16io", "_bf16"))
    # scratch: `tap_weights_bf16`' layout, or `tap_weights`'
    wf = torch.empty(tok_bf16_floats(C) if bf else 18 * C * D, device=x.device)
    fn = _build.bind("spa_block", "lft_" + name, 7, (ctypes.c_int,) * (len(dims) + 2))
    _build.launch("spa_block", name, fn, x.device, x.data_ptr(),
                  pe_tok.data_ptr(), wk["wu"].data_ptr(), wf.data_ptr(), wk["ln"].data_ptr(),
                  tok.data_ptr(), xn.data_ptr(), *dims,
                  *(tok_bf16_tile if bf else tok_tile)(h, w, C))
    return tok, xn


def qkv(xn, tok, wts, plan=None):
    """Step 2: (xn, tok) [V, h, w, D] -> (q, k, v) [V, h, w, D]. On the card
    its three products run 3xTF32 on the tensor cores (`csrc/rowgemm.cuh`),
    the weights split by the launch's first kernel into a scratch of
    `rowgemm.qkv_stream`'s layout. bf16 xn and tok launch `spa_qkv_bf16io`;
    the plan `none` `spa_qkv_bf16`."""
    if xn.device.type != "cuda":
        return qkv_plain(xn, tok, wts, plan)
    name = fwd_kernel("spa_qkv", xn, plan)
    sites = _sites_tail(name, plan, "spa_qkv")
    D = tok.shape[-1]
    _check_c(name, D // 2)
    if xn.shape != tok.shape or tuple(wts["wqk"].shape) != (D, 2 * D) \
            or tuple(wts["wv"].shape) != (D, D):
        raise ValueError(f"spa_qkv: wqk {tuple(wts['wqk'].shape)}, wv {tuple(wts['wv'].shape)} "
                         f"for xn {tuple(xn.shape)}, tok {tuple(tok.shape)}")
    wk = _io_args(name, (xn, tok), wts, ("wqk", "wv"))
    q, k, v = (torch.empty_like(tok) for _ in range(3))
    wf = torch.empty(qkv_floats(D // 2), device=tok.device)   # scratch: the split weights
    fn = _build.bind("spa_block", "lft_" + name, 8, (ctypes.c_int,) * (2 + len(sites)))
    _build.launch("spa_block", name, fn, xn.device, xn.data_ptr(), tok.data_ptr(),
                  wk["wqk"].data_ptr(), wk["wv"].data_ptr(), wf.data_ptr(), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), tok.numel() // D, D // 2, *sites)
    return q, k, v


# ------------------------------------------------ window step geometry ---

WA_TX = WA_TY = 16     # query tile of the window step (spa_block.cu: WA_TX, WA_TY)
WA_QY = 2              # queries a thread owns, down a column
WA_G = 32              # floats of a head group: one 128-byte line of a pixel
WA_S = 16              # floats of a thread's slice of the group
WA_NT = WA_TX * (WA_TY // WA_QY) * (WA_G // WA_S)   # threads of a block: 256
WA_RADIUS = 2          # the 5x5 window


def window_smem() -> int:
    """Shared memory of a window-step block: the k and v halos, (16 + 4)^2
    pixels at a stride of 32 + 4 floats (WA_BYTES); two blocks share an SM."""
    halo = (WA_TY + 2 * WA_RADIUS) * (WA_TX + 2 * WA_RADIUS) * (WA_G + 4)
    return 2 * halo * 4


def window_items(V: int, h: int, w: int, D: int):
    """The window step's blocks in launch order, (view, y0, x0, group): a 16
    x 16 query tile at (y0, x0) of one view times one head group of 32
    channels (spa_block.cu: spa_window_attn_kernel)."""
    ntx, nty, G = -(-w // WA_TX), -(-h // WA_TY), D // WA_G
    return [(i // (nty * ntx * G), (i % (nty * ntx * G) // G) // ntx * WA_TY,
             (i % (nty * ntx * G) // G) % ntx * WA_TX, i % G) for i in range(V * nty * ntx * G)]


def window_thread(tid: int):
    """(column, slice, first query row) in the tile of thread `tid` of the
    window step's 256: a warp is 16 columns x the group's two 16-float
    slices, and warp j owns query rows 2 j and 2 j + 1."""
    lane = tid % 32
    return lane % 16, lane // 16, WA_QY * (tid // 32)


# K5's backward (csrc/spa_attn_hp.cu): pass q takes K2.3's items
# (`window_items`), threads (`window_thread`: its two queries one after the
# other) and k/v halo (`window_smem`); pass kv takes a (view, 16 x 16 tile,
# head pair) item, whose q and dout halos carry the pair's m, 1/l and D in
# each pixel's four pad floats, and `window_thread`'s mapping with the slice
# a head of the pair: a thread takes two key pixels down a column.
HP_KV_HEADS = 2        # heads of a pass-kv item (spa_attn_hp.cu: KV_HEADS)


def hp_kv_smem(dh: int) -> int:
    """Shared memory of a pass-kv block: the q and dout halos of a head
    pair, (16 + 4)^2 pixels at a stride of 2 dh + 4 floats (KvLayout::BYTES);
    two blocks share an SM."""
    halo = (WA_TY + 2 * WA_RADIUS) * (WA_TX + 2 * WA_RADIUS) * (HP_KV_HEADS * dh + 4)
    return 2 * halo * 4


def hp_kv_items(V: int, h: int, w: int, num_heads: int = 8):
    """Pass kv's blocks in launch order, (view, y0, x0, pair): a 16 x 16 key
    tile at (y0, x0) of one view times heads 2 pair and 2 pair + 1."""
    ntx, nty, P = -(-w // WA_TX), -(-h // WA_TY), num_heads // HP_KV_HEADS
    return [(i // (nty * ntx * P), (i % (nty * ntx * P) // P) // ntx * WA_TY,
             (i % (nty * ntx * P) // P) % ntx * WA_TX, i % P) for i in range(V * nty * ntx * P)]


def hp_thread_pixels(tid: int):
    """The tile's (row, column) pixels of thread `tid` in either pass, in the
    order it takes them: its queries (pass q) or keys (pass kv)."""
    tx, _, ry = window_thread(tid)
    return [(ry + a, tx) for a in range(WA_QY)]


# The bf16-IO window kernel (csrc/window_mma.cuh: `spa_window_attn_bf16io`
# and its `_res` form, K5's `spa_attn_hp_bf16io` and `_res_bf16io`): a block
# takes an 8 x 8 query tile of one view and all heads (`window_mma_items`),
# its 12 x 12 k halo and, in WM_VS rounds of D / WM_VS channels, its v halo
# bf16 in shared memory (`window_mma_smem`, 16-byte chunks swizzled by
# `window_mma_unit`), four blocks an SM; warp j takes the tile's 4 x 4 patch
# (j // 2, j % 2), the 16 rows of `mma.sync`, and lane (g, q) its queries g
# and g + 8 (`window_mma_lane`).
WM_T = 8               # query tile
WM_P = 4               # a warp's patch of queries
WM_NT = 128            # threads of a block
WM_VS = 2              # rounds of the v halo
WM_BLOCKS = 4          # blocks an SM


def window_mma_smem(D: int) -> int:
    """Shared memory of a bf16-IO window block: the k halo, (8 + 4)^2 pixels
    of D bf16 values, and a round of the v halo, D / WM_VS values a pixel
    (WinMma<D>::BYTES)."""
    halo = (WM_T + 2 * WA_RADIUS) ** 2 * D * 2
    return halo + halo // WM_VS


def window_mma_items(V: int, h: int, w: int):
    """The bf16-IO window kernel's blocks in launch order, (view, y0, x0):
    an 8 x 8 query tile at (y0, x0) of one view."""
    ntx, nty = -(-w // WM_T), -(-h // WM_T)
    return [(i // (nty * ntx), i % (nty * ntx) // ntx * WM_T, i % (nty * ntx) % ntx * WM_T)
            for i in range(V * nty * ntx)]


def window_mma_lane(tid: int):
    """(patch row, patch column) in the tile of thread `tid`'s warp and the
    (row, column) in that patch of its two queries (g and g + 8 of the MMA's
    16 rows), with its key columns 2 q, 2 q + 1 of each 8-key row: ((py,
    px), [(qy, qx), (qy + 2, qx)], q)."""
    warp, lane = tid // 32, tid % 32
    g, q = lane // 4, lane % 4
    return ((WM_P * (warp // 2), WM_P * (warp % 2)), [(g // 4, g % 4), (g // 4 + 2, g % 4)], q)


def window_mma_unit(p: int, c: int, ch: int) -> int:
    """The 16-byte unit of a halo of `ch` chunks (8 channels each) a pixel
    that holds chunk c of halo pixel p (window_mma.cuh: wm_unit): D / 8 for
    the k halo, D / 8 / WM_VS for a round of the v halo."""
    if ch >= 8:
        return p * ch + (c ^ (p & 7))
    return p * ch + (c ^ ((p >> 1) & 3) if ch == 4 else c ^ ((p >> 2) & 1))


def _check_window(kernel: str, D: int, num_heads: int, ksize: int) -> None:
    if num_heads != 8 or ksize != 5 or D // num_heads not in (4, 8, 16) \
            or D % num_heads:
        raise NotImplementedError(
            f"{kernel} kernel takes 8 heads of width 4, 8 or 16 and a 5x5 "
            f"window; got D={D}, heads={num_heads}, k={ksize}")


def window_attn(q, k, v, num_heads: int, ksize: int, with_stats: bool = False, plan=None):
    """Step 3: projected q/k/v [V, h, w, D] -> attention output [V, h, w, D];
    with_stats: (attn, m, l), m and l [V, h, w, H], counted as
    `spa_window_attn_res`. On the card a block takes a (view, 16 x 16 tile,
    head group) item (`window_items`), its threads each 2 queries of a
    column and 16 channels (`window_thread`), two blocks an SM. bf16 q, k,
    v launch `spa_window_attn_bf16io` (`window_attn_plain`'s bf16 IO,
    `csrc/window_mma.cuh`: a block takes an 8 x 8 query tile and every head
    (`window_mma_items`), k and v staged once, bf16, the products on the
    tensor cores, a first pass of scores for each query's max over all its
    heads); with_stats `spa_window_attn_res_bf16io` (m, l f32: each query's
    max over its heads in every head's slot, and its heads' sums). The plan `none` launches
    `spa_window_attn_bf16` (f32 q, k, v rounded as they load, the bf16-IO
    kernel's softmax, attn f32); with_stats `spa_window_attn_res_bf16` (the
    same, m and l as the bf16-IO form's, attn f32 of bf16 values: the
    residual as lft_tpu stores it)."""
    if q.device.type != "cuda":
        if with_stats:
            return window_attn_plain(q, k, v, num_heads, ksize, plan, res=True)
        if active(plan) is not None or q.dtype == torch.bfloat16:
            return window_attn_plain(q, k, v, num_heads, ksize, plan)[0]
        return windowed_attention(q, k, v, num_heads, ksize)
    base = "spa_window_attn_res" if with_stats else "spa_window_attn"
    name = fwd_kernel(base, q, plan)
    V, h, w, D = q.shape
    _check_window(name, D, num_heads, ksize)
    _build.check_cuda_args(name, q, k, v, dtype=torch.bfloat16 if name.endswith("_bf16io")
                           else torch.float32)
    attn = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), attn.data_ptr()]
    sites = _sites_tail(name, plan, base)
    tail = (V, h, w, D, num_heads, float(D // num_heads) ** -0.5, *sites)
    types = (ctypes.c_int,) * 5 + (ctypes.c_float,) + (ctypes.c_int,) * len(sites)
    if not with_stats:
        fn = _build.bind("spa_block", "lft_" + name, 4, types)
        _build.launch("spa_block", name, fn, q.device, *ptrs, *tail)
        return attn
    m = torch.empty(V, h, w, num_heads, device=q.device)
    l = torch.empty_like(m)
    fn = _build.bind("spa_block", "lft_" + name, 6, types)
    _build.launch("spa_block", name, fn, q.device, *ptrs, m.data_ptr(), l.data_ptr(), *tail)
    return attn, m, l


def outproj_ln(attn, tok, wts, plan=None):
    """Step 4: (attn, tok) [V, h, w, D] -> (x2, xn2) [V, h, w, D]. On the card
    its product runs 3xTF32 on the tensor cores (`csrc/rowgemm.cuh`), Wo
    split by the launch's first kernel into a scratch of
    `rowgemm.outproj_stream`'s layout and held in shared memory, LN2 on the
    accumulators. bf16 attn and tok launch `spa_outproj_ln_bf16io`; the
    plan `none` `spa_outproj_ln_bf16`."""
    if attn.device.type != "cuda":
        return outproj_ln_plain(attn, tok, wts, plan)
    name = fwd_kernel("spa_outproj_ln", attn, plan)
    D = tok.shape[-1]
    _check_c(name, D // 2)
    if attn.shape != tok.shape or tuple(wts["wo"].shape) != (D, D):
        raise ValueError(f"spa_outproj_ln: wo {tuple(wts['wo'].shape)} for attn "
                         f"{tuple(attn.shape)}, tok {tuple(tok.shape)}")
    wk = _io_args(name, (attn, tok), wts, ("wo", "ln"))
    x2, xn2 = torch.empty_like(tok), torch.empty_like(tok)
    wf = torch.empty(outproj_floats(D // 2), device=tok.device)   # scratch: Wo split
    fn = _build.bind("spa_block", "lft_" + name, 7, (ctypes.c_int,) * 2)
    _build.launch("spa_block", name, fn, attn.device, attn.data_ptr(),
                  tok.data_ptr(), wk["wo"].data_ptr(), wk["ln"].data_ptr(), wf.data_ptr(),
                  x2.data_ptr(), xn2.data_ptr(), tok.numel() // D, D // 2)
    return x2, xn2


def ffn_out(xn2, x2, wts, views=None, plan=None):
    """Step 5: (xn2, x2) [V, h, w, D] -> block output [V, h, w, C]. With
    `views` = A2 the output is pixel-major [V / A2, h, w, A2, C], counted as
    `spa_ffn_out_pm`. On the card its three products run 3xTF32 on the
    tensor cores (`csrc/rowgemm.cuh`), the weights split by the launch's
    first kernel into a scratch of `rowgemm.ffn_out_stream`'s layout. The
    plan `none` launches `spa_ffn_out[_pm]_bf16` (bf16 `wgmma` on the
    weights rounded to bf16 into `rowgemm.ffn_out_bf16_stream`'s layout and
    held whole in shared memory, `csrc/ffn_bf16.cuh`), bf16 xn2 and x2
    `spa_ffn_out[_pm]_bf16io` (the same kernel on bf16 rows, bf16 out); a
    site subset that rounds one of `ffn`
    and `lin` `spa_ffn_out[_pm]_sites` (`csrc/ffn_sites.cuh`: the rounded
    products bf16 `wgmma`, the f32 ones 3xTF32, the weights prepared into
    `rowgemm.ffn_out_sites_stream`'s layout)."""
    if xn2.device.type != "cuda":
        out = ffn_out_plain(xn2, x2, wts, plan)
        return out if views is None else _to_pixel_major(out, views)
    *lead, D = x2.shape
    C = D // 2
    base = "spa_ffn_out" if views is None else "spa_ffn_out_pm"
    name = fwd_kernel(base, xn2, plan)
    sites = _sites_tail(name, plan, base)
    _check_c(name, C)
    wk = _io_args(name, (xn2, x2), wts, ("w1", "w2", "wlin"))
    if views is None:
        out = torch.empty(*lead, C, device=x2.device, dtype=x2.dtype)
        dims = (x2.numel() // D, C)
    else:
        V, h, w = lead
        out = torch.empty(V // views, h, w, views, C, device=x2.device, dtype=x2.dtype)
        dims = (V // views, h * w, views, C)
    if tuple(wts["w1"].shape) != (D, 2 * D) or tuple(wts["wlin"].shape) != (D, C):
        raise ValueError(f"{name}: w1 {tuple(wts['w1'].shape)}, wlin "
                         f"{tuple(wts['wlin'].shape)} for x2 {tuple(x2.shape)}")
    # scratch: the weights as the launch's first kernel prepares them (the
    # bf16 copy of `_bf16` and `_bf16io`, the others' split stream)
    wf = torch.empty(ffn_out_bf16_floats(C) if name.endswith(("_bf16", "_bf16io")) else
                     ffn_out_floats(C), device=x2.device)
    fn = _build.bind("spa_block", "lft_" + name, 7, (ctypes.c_int,) * (len(dims) + len(sites)))
    _build.launch("spa_block", name, fn, x2.device, xn2.data_ptr(),
                  x2.data_ptr(), wk["w1"].data_ptr(), wk["w2"].data_ptr(),
                  wk["wlin"].data_ptr(), wf.data_ptr(), out.data_ptr(), *dims, *sites)
    return out


# ------------------------------------------------- K3 kernel wrappers ---

def _bwd_weights(wts: dict) -> dict:
    """Transposed weights of step a's backward products (`dy Wᵀ`),
    contiguous (step d splits its transposes straight from wqk and wv)."""
    t = lambda m: m.t().contiguous()
    return dict(wlinT=t(wts["wlin"]), w2T=t(wts["w2"]), w1T=t(wts["w1"]), woT=t(wts["wo"]))


def _bwd_name(kernel: str, t: torch.Tensor, plan) -> str:
    """The launch name of backward step `kernel` for the IO dtype of `t`:
    its `_bf16io` instance for a bf16 t (no plan), else its f32, `_bf16` or
    `_sites` instance under the backward plan `plan` (`common.card_bwd`)."""
    if t.dtype == torch.bfloat16:
        no_plan(plan, kernel + "_bf16io")
        return kernel + "_bf16io"
    return kernel + card_bwd(False, plan, kernel)


def _launch(name: str, plan, ins, outs, ints, dev, bf=()):
    """One step's launch under its name `name` (C function `lft_<name>` and
    count; `_bwd_name`): a `_sites` instance also takes the mask of its
    rounding sites under the backward plan `plan`; a `_bf16io` one takes the
    inputs that `bf` names (by position) as bf16."""
    if name.endswith("_sites"):
        ints = (*ints, site_mask(plan, name[:-len("_sites")]))
    _build.check_cuda_args(name, *(t for i, t in enumerate(ins) if i not in bf))
    if bf:
        _build.check_cuda_args(name, *(ins[i] for i in bf), dtype=torch.bfloat16)
    fn = _build.bind("spa_block_bwd", "lft_" + name, len(ins) + len(outs),
                     (ctypes.c_int,) * len(ints))
    _build.launch("spa_block_bwd", name, fn, dev, *(t.data_ptr() for t in (*ins, *outs)), *ints)


def _f32(wts: dict, names) -> dict:
    """The weights `names` of a bf16-IO launch as f32 tensors of their
    values (as `_io_args` takes them)."""
    return {n: wts[n].float().contiguous() for n in names}


def ffn_out_bwd_tiles(T: int) -> int:
    """Rows of the LN partial sums of steps a (LN2) and d (LN1): one a
    128-row tile (RG_M)."""
    return -(-T // RG_M)


def ffn_out_bwd(attn, tok, dout, wts, plan=None):
    """Step a: (dx2, dattn, y, dy, hid, dpre, xn2, dln2); dln2 holds one
    partial sum per 128-row tile, [ffn_out_bwd_tiles(T), 2, D]. On the card
    its seven products run 3xTF32 on the tensor cores (`csrc/rowgemm.cuh`),
    the weights split by the launch's first kernels into a scratch of
    `rowgemm.ffn_out_bwd_stream`'s layout; under a mixed plan that rounds
    every site (`wo`, `ffn`, `lin`), one TF32 pass each over bf16-rounded
    operands (`spa_ffn_out_bwd_bf16`, the weights' bf16 parts in the same
    layout); under one that rounds some of them `spa_ffn_out_bwd_sites`
    (each product BF or 3xTF32 as its site says, `common.card_bwd`). bf16
    attn, tok and dout launch `spa_ffn_out_bwd_bf16io` (the plain
    version's bf16 IO: dx2 and dln2 f32, the other outputs bf16)."""
    if attn.device.type != "cuda":
        return ffn_out_bwd_plain(attn, tok, dout, wts, plan)
    name = _bwd_name("spa_ffn_out_bwd", attn, plan)
    bio = attn.dtype == torch.bfloat16
    if bio:
        wts = dict(wts, **_f32(wts, ("ln", "wo", "w1", "w2", "wlin")))
    *lead, D = tok.shape
    C = D // 2
    T = tok.numel() // D
    _check_c("spa_ffn_out_bwd", C)
    if attn.shape != tok.shape or tuple(dout.shape) != (*lead, C) \
            or tuple(wts["w1"].shape) != (D, 2 * D) or tuple(wts["wlin"].shape) != (D, C):
        raise ValueError(f"spa_ffn_out_bwd: attn {tuple(attn.shape)}, tok {tuple(tok.shape)}, "
                         f"dout {tuple(dout.shape)}, w1 {tuple(wts['w1'].shape)}, wlin "
                         f"{tuple(wts['wlin'].shape)}")
    wt = _bwd_weights(wts)
    e = lambda n: torch.empty(*lead, n, device=tok.device)
    eb = (lambda n: torch.empty(*lead, n, device=tok.device, dtype=torch.bfloat16)) if bio else e
    wf = torch.empty(ffn_out_bwd_floats(C), device=tok.device)   # scratch: the split weights
    outs = (e(D), eb(D), eb(D), eb(D), eb(2 * D), eb(2 * D), eb(D),
            torch.empty(ffn_out_bwd_tiles(T), 2, D, device=tok.device))
    _launch(name, plan, (attn, tok, dout, wts["ln"], wts["wo"], wts["w1"], wts["w2"],
                         wt["wlinT"], wt["w2T"], wt["w1T"], wt["woT"]), (wf, *outs), (T, C),
            tok.device, (0, 1, 2) if bio else ())
    return outs


def ln_qkv(tok, pe_tok, wts, plan=None):
    """Step b: recompute (xn, q, k, v) [V, h, w, D] from tok and pe_tok. On
    the card K2.2's kernel with an LN1 prologue (`csrc/spa_block.cu`:
    `spa_qkv_kernel<C, true>`): xn = LN1(tok + pe_tok) as K2.1 computes it,
    then q, k, v as K2.2 computes them, the weights split by the launch's
    first kernel into a scratch of `rowgemm.qkv_stream`'s layout. With tok
    from K2.1 all four are the forward's bit for bit. Under a mixed plan that
    rounds every site `spa_ln_qkv_bf16`: the products over bf16-rounded xn,
    tok and weights (q, k, v then differ from the f32 forward's); under one
    that rounds one of `qk` and `v`, `spa_ln_qkv_sites` (K2.2's `_sites`
    kernel with the LN1 prologue). bf16 tok
    and pe_tok launch `spa_ln_qkv_bf16io` (xn, q, k, v bf16; pe_tok, the LN
    affine and the weights passed as f32 tensors of their values)."""
    if tok.device.type != "cuda":
        return ln_qkv_plain(tok, pe_tok, wts, plan)
    name = _bwd_name("spa_ln_qkv", tok, plan)
    sites = _sites_tail(name, plan, "spa_ln_qkv")
    V, h, w, D = tok.shape
    _check_c("spa_ln_qkv", D // 2)
    if tuple(pe_tok.shape) != (h, w, D) or tuple(wts["wqk"].shape) != (D, 2 * D) \
            or tuple(wts["wv"].shape) != (D, D):
        raise ValueError(f"spa_ln_qkv: tok {tuple(tok.shape)}, pe_tok {tuple(pe_tok.shape)}, "
                         f"wqk {tuple(wts['wqk'].shape)}, wv {tuple(wts['wv'].shape)}")
    if tok.dtype == torch.bfloat16:
        _build.check_cuda_args(name, tok, pe_tok, dtype=torch.bfloat16)
        pe_tok = pe_tok.float()
        wts = dict(wts, **_f32(wts, ("ln", "wqk", "wv")))
    _build.check_cuda_args(name, *((tok,) if tok.dtype == torch.float32 else ()), pe_tok,
                           wts["ln"], wts["wqk"], wts["wv"])
    outs = tuple(torch.empty_like(tok) for _ in range(4))
    wf = torch.empty(qkv_floats(D // 2), device=tok.device)   # scratch: the split weights
    fn = _build.bind("spa_block", "lft_" + name, 10, (ctypes.c_int,) * (3 + len(sites)))
    _build.launch("spa_block", name, fn, tok.device,
                  *(t.data_ptr() for t in (tok, pe_tok, wts["ln"], wts["wqk"], wts["wv"], wf,
                                           *outs)), V * h * w, h * w, D // 2, *sites)
    return outs


def window_attn_bwd(q, k, v, attn, dattn, m, l, num_heads: int, ksize: int, plan=None):
    """Step c: (dq, dk, dv) [V, h, w, D] from the saved (m, l). On the card
    K5's backward (`spa_attn_hp.spa_attn_hp_bwd`: pass q, dq and D = sum_j
    p_j dp_j; pass kv, dk and dv) with dout = dattn, counted as
    `spa_window_attn_bwd`: `attn` is not read there (the plain version forms
    D from it). Under a mixed plan that rounds every site its bf16-operand
    instance, `spa_window_attn_bwd_bf16` (q, k, v, dattn rounded on load, ds
    and p before their products); under one that rounds one of `score` and
    `av`, `spa_window_attn_bwd_sites` (those roundings by the site's bit);
    bf16 q, k, v, dattn that instance on bf16 tensors,
    `spa_window_attn_bwd_bf16io` (dq, dk, dv bf16)."""
    if q.device.type != "cuda":
        return window_attn_bwd_plain(q, k, v, attn, dattn, m, l, num_heads, ksize, plan)
    name = _bwd_name("spa_window_attn_bwd", q, plan)
    sites = _sites_tail(name, plan, "spa_window_attn_bwd")
    _check_window(name, q.shape[-1], num_heads, ksize)
    return spa_attn_hp_bwd(q, k, v, m, l, dattn, num_heads, ksize, kernel=name,
                           half=name.endswith("_bf16"), sites=sites[0] if sites else None)


def qkv_ln_bwd(tok, pe_tok, dq, dk, dv, dx2, wts, plan=None):
    """Step d: (dtok, dtokpe, dln1); dln1 holds one partial sum per 128-row
    tile, [ffn_out_bwd_tiles(T), 2, D]. On the card its three products run
    3xTF32 on the tensor cores (`csrc/rowbwd.cuh`, one weight resident a
    pass at D = 128: `rowgemm.qkv_ln_bwd_passes`), Wqᵀ, Wkᵀ, Wvᵀ split
    straight from wqk and wv by the launch's first kernel into a scratch of
    `rowgemm.qkv_ln_bwd_stream`'s layout; `spa_qkv_ln_bwd_bf16` under a
    mixed plan that rounds `qk` and `v`, `spa_qkv_ln_bwd_sites` under one
    that rounds one of them. bf16 tok, pe_tok, dq, dk, dv (dx2
    f32) launch `spa_qkv_ln_bwd_bf16io` (dtok bf16; dtokpe, dln1 f32)."""
    if tok.device.type != "cuda":
        return qkv_ln_bwd_plain(tok, pe_tok, dq, dk, dv, dx2, wts, plan)
    name = _bwd_name("spa_qkv_ln_bwd", tok, plan)
    bio = tok.dtype == torch.bfloat16
    V, h, w, D = tok.shape
    T = V * h * w
    _check_c("spa_qkv_ln_bwd", D // 2)
    if not (dq.shape == dk.shape == dv.shape == dx2.shape == tok.shape) \
            or tuple(pe_tok.shape) != (h, w, D) or tuple(wts["wqk"].shape) != (D, 2 * D) \
            or tuple(wts["wv"].shape) != (D, D):
        raise ValueError(f"spa_qkv_ln_bwd: tok {tuple(tok.shape)}, pe_tok {tuple(pe_tok.shape)}, "
                         f"dq {tuple(dq.shape)}, wqk {tuple(wts['wqk'].shape)}")
    if bio:
        _build.check_cuda_args("spa_qkv_ln_bwd_bf16io", pe_tok, dtype=torch.bfloat16)
        pe_tok = pe_tok.float()
        wts = dict(wts, **_f32(wts, ("ln", "wqk", "wv")))
    wf = torch.empty(qkv_ln_bwd_floats(D), device=tok.device)   # scratch: Wqᵀ, Wkᵀ, Wvᵀ split
    outs = (torch.empty_like(tok), torch.empty(T, D, device=tok.device).view(tok.shape),
            torch.empty(ffn_out_bwd_tiles(T), 2, D, device=tok.device))
    _launch(name, plan, (tok, pe_tok, dq, dk, dv, dx2, wts["ln"], wts["wqk"], wts["wv"]),
            (wf, *outs), (T, h * w, D // 2), tok.device, (0, 2, 3, 4) if bio else ())
    return outs


def tokenize_bwd(dtok, wts, plan=None):
    """Step e: dx [V, h, w, C] = the 3x3 tokenization transposed, as a
    gather over the 9 taps (on the card 3xTF32 on the tensor cores;
    `spa_tokenize_bwd_bf16`, one TF32 pass over bf16-rounded dtok and taps,
    under a mixed plan that rounds `tok`, its one site; bf16 dtok launches
    `spa_tokenize_bwd_bf16io`, dx bf16)."""
    if dtok.device.type != "cuda":
        return tokenize_bwd_plain(dtok, wts, plan)
    name = _bwd_name("spa_tokenize_bwd", dtok, plan)
    bio = dtok.dtype == torch.bfloat16
    if bio:
        wts = dict(wts, wu=wts["wu"].float().contiguous())
    V, h, w, D = dtok.shape
    C = D // 2
    _check_c("spa_tokenize_bwd", C)
    if tuple(wts["wu"].shape) != (9, C, D):
        raise ValueError(f"spa_tokenize_bwd: wu {tuple(wts['wu'].shape)} for dtok "
                         f"{tuple(dtok.shape)}")
    dx = torch.empty(V, h, w, C, device=dtok.device, dtype=dtok.dtype)
    wf = torch.empty(18 * C * D, device=dtok.device)   # scratch: `tap_weights`' layout
    _launch(name, plan, (dtok, wts["wu"]), (wf, dx), (V * h * w, h, w, C, *tok_tile(h, w, C)),
            dtok.device, (0,) if bio else ())
    return dx


# --------------------------------------------------------------- blocks ---

def spa_block(x, pe_tok, wts, num_heads: int, k: int, with_res: bool = False,
              pixel_major: bool = False, plan=None):
    """K2 chained; with_res: (out, tok, m, l, attn). pixel_major (K11): x and
    out are [Bb, h, w, A2, C], the first and last step run in their `_pm`
    forms; without residuals. `plan`: a mixed forward plan (on the card
    `none` runs the `_bf16` steps). A bf16 x runs the bf16-IO steps."""
    tok, xn = tokenize_ln(x, pe_tok, wts, pixel_major, plan)
    q, kk, v = qkv(xn, tok, wts, plan)
    if with_res:
        attn, m, l = window_attn(q, kk, v, num_heads, k, with_stats=True, plan=plan)
    else:
        attn = window_attn(q, kk, v, num_heads, k, plan=plan)
    x2, xn2 = outproj_ln(attn, tok, wts, plan)
    out = ffn_out(xn2, x2, wts, x.shape[3] if pixel_major else None, plan)
    return (out, tok, m, l, attn) if with_res else out


def spa_block_plain(x, pe_tok, wts, num_heads: int, k: int, with_res: bool = False,
                    plan=None):
    tok, xn = tokenize_ln_plain(x, pe_tok, wts, plan)
    q, kk, v = qkv_plain(xn, tok, wts, plan)
    if with_res or active(plan) is not None or x.dtype == torch.bfloat16:
        attn, m, l = window_attn_plain(q, kk, v, num_heads, k, plan, res=with_res)
    else:
        attn = windowed_attention(q, kk, v, num_heads, k)
    x2, xn2 = outproj_ln_plain(attn, tok, wts, plan)
    out = ffn_out_plain(xn2, x2, wts, plan)
    return (out, tok, m, l, attn) if with_res else out


_KERNEL_STEPS = (ffn_out_bwd, ln_qkv, window_attn_bwd, qkv_ln_bwd, tokenize_bwd, wgrad,
                 colsum)
_PLAIN_STEPS = (ffn_out_bwd_plain, ln_qkv_plain, window_attn_bwd_plain, qkv_ln_bwd_plain,
                tokenize_bwd_plain, wgrad_plain, colsum_plain)


def spa_block_bwd(x, pe_tok, wts, tok, m, l, attn, dout, num_heads: int, k: int, plan=None,
                  d_from_p: bool = False):
    """K3: the block's backward from x and the saved (tok, m, l, attn).
    Returns (dx, dpe_tok [h, w, D], dln [4, D], dwu [9, C, D], dwqk, dwv,
    dwo, dw1, dw2, dwlin), weight grads in the layouts of `spa_weights`.
    Each step takes its plain version for CPU tensors. `plan`: `--dtype
    mixed`'s backward plan; `d_from_p`: the forward rounded, so step c forms
    D from its own p (the kernel always does)."""
    return _bwd(_KERNEL_STEPS, x, pe_tok, wts, tok, m, l, attn, dout, num_heads, k, plan,
                d_from_p)


def spa_block_bwd_plain(x, pe_tok, wts, tok, m, l, attn, dout, num_heads: int, k: int,
                        plan=None, d_from_p: bool = False):
    """Plain version of `spa_block_bwd` (lft_tpu/kernels/spa_block.py:427-568
    in plain PyTorch), on any device."""
    return _bwd(_PLAIN_STEPS, x, pe_tok, wts, tok, m, l, attn, dout, num_heads, k, plan,
                d_from_p)


def _bwd(steps, x, pe_tok, wts, tok, m, l, attn, dout, num_heads, k, plan=None,
         d_from_p=False):
    f_ffn, f_lnqkv, f_attn, f_qkvln, f_tok, wg, cs = steps
    V, h, w, C = x.shape
    D = 2 * C
    plan = active(plan)
    pl = {} if plan is None else {"plan": plan}
    dx2, dattn, y, dy, hid, dpre, xn2, dln2 = f_ffn(attn, tok, dout, wts, **pl)
    xn, q, kk, v = f_lnqkv(tok, pe_tok, wts, **pl)
    dq, dk, dv = f_attn(q, kk, v, None if d_from_p else attn, dattn, m, l, num_heads, k, **pl)
    dtok, dtokpe, dln1 = f_qkvln(tok, pe_tok, dq, dk, dv, dx2, wts, **pl)
    dx = f_tok(dtok, wts, **pl)
    r = lambda t: t.reshape(-1, t.shape[-1])
    rows = lambda t: cs(t.reshape(t.shape[0], -1))
    # each weight grad over bf16 operands where its site rounds
    hf = lambda site: {"half": True} if rounds(plan, site) else {}
    return (dx, rows(dtokpe).reshape(h, w, D),
            torch.cat([rows(dln1), rows(dln2)]).reshape(4, D),
            wg(r(x), r(dtok), image=(h, w), **hf("tok")),
            torch.cat([wg(r(xn), r(dq), **hf("qk")), wg(r(xn), r(dk), **hf("qk"))], dim=1),
            wg(r(tok), r(dv), **hf("v")), wg(r(attn), r(dx2), **hf("wo")),
            wg(r(xn2), r(dpre), **hf("ffn")), wg(r(hid), r(dy), **hf("ffn")),
            wg(r(y), r(dout), **hf("lin")))


def _with_mlp(wts: dict) -> dict:
    """The weights of WEIGHTS plus `mlp`, MLP.weight [D, C*9] rebuilt from wu."""
    wu = wts["wu"]
    return dict(wts, mlp=wu.permute(2, 1, 0).reshape(wu.shape[2], -1))


class SpaBlockFn(torch.autograd.Function):
    """K2 with residuals forward, K3 backward. Inputs: x [V, h, w, C],
    pe_tok [h, w, D], the weights of `spa_weights` in WEIGHTS order, then
    the configuration, the mixed forward and backward plans among it (the
    backward's is kept in `ctx` for the backward). A bf16 x (with bf16
    pe_tok and weights) runs both in bf16 IO and returns bf16 gradients."""

    @staticmethod
    def forward(ctx, x, pe_tok, ln, wu, wqk, wv, wo, w1, w2, wlin, num_heads, k, plain, plan,
                bwd_plan):
        wts = _with_mlp(dict(zip(WEIGHTS, (ln, wu, wqk, wv, wo, w1, w2, wlin))))
        fwd = spa_block_plain if plain else spa_block
        out, tok, m, l, attn = fwd(x, pe_tok, wts, num_heads, k, with_res=True, plan=plan)
        ctx.save_for_backward(x, pe_tok, ln, wu, wqk, wv, wo, w1, w2, wlin, tok, m, l, attn)
        # d_from_p: the forward rounded, so the saved attn is not the backward's sum p v
        ctx.cfg = (num_heads, k, plain, bwd_plan, active(plan) is not None)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, pe_tok, *w, tok, m, l, attn = ctx.saved_tensors
        num_heads, k, plain, bwd_plan, dp = ctx.cfg
        bwd = spa_block_bwd_plain if plain else spa_block_bwd
        grads = bwd(x, pe_tok, _with_mlp(dict(zip(WEIGHTS, w))), tok, m, l, attn,
                    dout.contiguous(), num_heads, k, bwd_plan, dp)
        if x.dtype == torch.bfloat16:   # lft_tpu's `c(g, t)`: each f32 sum rounded once
            grads = (grads[0], *(g.to(torch.bfloat16) for g in grads[1:]))
        return (*grads, None, None, None, None, None)


def spa_trans_block_fused(x, pe_tok, params, prefix: str, num_heads: int, k: int,
                          plain: bool = False, pixel_major: bool = False, plan=None,
                          bwd_plan=None):
    """The whole SpaTrans block on view images.

    x: [V, h, w, C] (V = batch*A2 views), or with `pixel_major=True` a
    [Bb, h, w, A2, C] pixel-major buffer whose (batch, view) planes are read
    and written through their stride (K11: no view-major copy is made);
    pe_tok: [h, w, D], the spatial PE through the same unfold+MLP
    (view-independent, computed outside); params/prefix: the flat param dict
    and `altblock.{i}.spa_trans.`. Returns the shape of x. The view-major
    form is differentiable through `SpaBlockFn` when grad is needed; the
    pixel-major form is inference-only and raises then. `plain=True` runs
    the plain versions on any device. `plan`, `bwd_plan`: the forward's and
    the backward's site plans under `--dtype mixed` (kernels/common.py;
    None: f32)."""
    wts = spa_weights(params, prefix)
    needs_grad = _needs_grad(x, pe_tok, *(wts[n] for n in WEIGHTS))
    if pixel_major:
        if needs_grad:
            raise ValueError("spa_trans_block_fused(pixel_major=True) is inference-only: the "
                             "pixel-major forward K11 has no backward; differentiate the "
                             "view-major form")
        if plain:
            out = spa_block_plain(_to_view_major(x), pe_tok, wts, num_heads, k, plan=plan)
            return _to_pixel_major(out, x.shape[3])
        return spa_block(x, pe_tok, wts, num_heads, k, pixel_major=True, plan=plan)
    if needs_grad:
        return SpaBlockFn.apply(x, pe_tok, *(wts[n] for n in WEIGHTS), num_heads, k, plain,
                                plan, bwd_plan)
    return (spa_block_plain if plain else spa_block)(x, pe_tok, wts, num_heads, k, plan=plan)


def spa_trans_block_plain(x, pe_tok, params, prefix: str, num_heads: int, k: int,
                          pixel_major: bool = False, plan=None, bwd_plan=None):
    """Plain version of `spa_trans_block_fused`, on any device."""
    return spa_trans_block_fused(x, pe_tok, params, prefix, num_heads, k, plain=True,
                                 pixel_major=pixel_major, plan=plan, bwd_plan=bwd_plan)
