"""K7: per-op angular attention on projected q/k/v (counterpart of
lft_tpu/kernels/ang_attn_mxu.py).

`ang_attention_blockdiag(q, k, v, num_heads)` is full multi-head attention
over the A2 view tokens of each pixel, [N, A2, C] -> [N, A2, C], scale
(C / heads)^-0.5 inside. On a CUDA tensor it launches the hand-written
kernels of `lft_torch/csrc/ang_attn.cu`; on a CPU tensor it runs the plain
PyTorch versions below. There is no fallback from one to the other.

Training: when grad mode is on and q, k or v requires grad it runs as
`AngAttnFn`, whose forward also returns the per-(token, head) softmax max m
and denominator l (`ang_attn_res`) and saves only (q, k, v, m, l); the
backward (`ang_attn_bwd`) rebuilds the probabilities from them.

`ang_attention_mxu` is the AngTrans attention around it: the q/k/v and out
projections as `torch.matmul`, as the JAX package leaves them to XLA. The
JAX module's name is kept; what made it "MXU" (keys replicated per head,
the block-diagonal mask over a group of pixels, pixel pairs) is the TPU's
and is not carried over. Its gate is: `mxu_applicable(A2)` iff A2 <= 128.

bf16 q, k, v (`--dtype bfloat16` serving): lft_tpu's kernel with io = bf16
(:106-142) defers its normalisation: scores (q . k) scale in f32, m each
token's max over EVERY head (its row-wide max), e = exp(s - m) rounded to
bf16 for the product with v, l the sum of the unrounded e, out = bf16(o (1
/ l)). On the card `ang_attn_bf16io` (`csrc/ang_attn.cu`), on the CPU
`ang_attention_blockdiag_bf16_plain`. Training in bf16: `ang_attn_res_bf16io`
(the same kernel writing m, the token's max over its heads in every head's
slot, and each head's l) and `ang_attn_bwd_bf16io` (lft_tpu's _bwd_kernel
with io = bf16, :148-192: s = (q . k) scale, a = exp(s - m) (1 / l) and D =
sum a (dout . v) in f32, ds = bf16(a (dov - D) scale) and bf16(a) before
their products, dq, dk, dv summed in f32 and rounded once: K7's backward
kernel on bf16 rows with those roundings); their plain versions
`ang_attention_blockdiag_bf16_plain(with_stats=True)` and
`ang_attention_blockdiag_bwd_bf16_plain` (float64 between the rounding
points).
"""

from __future__ import annotations

import ctypes

import torch

from lft_torch.kernels import _build
from lft_torch.kernels.ang_block import _heads, _merge, _needs_grad
from lft_torch.kernels.common import KERNEL_C, bf16_round, io_kernel, mm, on_card, plain_if

BLK = 128          # the gate's key block: A2 <= 128 view tokens per pixel

# The launch geometry of csrc/ang_attn.cu (`fwd_geo`, `bwd_geo`), mirrored
# for the tests: both kernels are persistent over tiles of P whole pixels.
H = 8
KB = 8             # keys a softmax chunk of the forward (K1's)
NT_MAX = 512       # threads a block at most
SMEM_TWO = 115712  # bytes a block when two share an SM: (228 KB - 2 x 1 KB) / 2
SMEM_MAX = 232448  # bytes a block at most
HOLD_MAX = 32      # the backward's query phase holds p and dp in registers up to 32 keys


def mxu_applicable(A2: int) -> bool:
    """Same outcome as lft_tpu.kernels.ang_attn_mxu.mxu_applicable."""
    return A2 <= BLK


def _round32(n: int) -> int:
    return (n + 31) // 32 * 32


def fwd_geometry(A2: int, C: int, stats: bool = True):
    """(pixels a tile, threads a block, shared bytes) of `ang_attn[_res]`: a
    thread takes two queries of one (pixel, head); the tile is the most
    pixels whose two stages of q, k, v and m, l fit two blocks on an SM,
    at most 512 threads."""
    qp = (A2 + 1) // 2
    row = lambda st: 6 * (C + 4) + (2 * H if st else 0)
    P = max(1, min(SMEM_TWO // (row(True) * 4) // A2, NT_MAX // (H * qp)))
    return P, _round32(P * H * qp), P * A2 * row(stats) * 4


def bwd_geometry(A2: int, C: int):
    """(pixels a tile, threads a block, stages, shared bytes) of
    `ang_attn_bwd`: a thread takes one (pixel, head, query) in the query
    phase and one (pixel, head, key) in the key phase, in as many rounds as
    512 threads need; two stages where they fit a block."""
    row = lambda nbuf: nbuf * (4 * (C + 4) + 2 * H) + 4 * H + C + 4
    P = max(1, min(SMEM_TWO // (row(2) * 4) // A2, NT_MAX // (H * A2)))
    nbuf = 2 if P * A2 * row(2) * 4 <= SMEM_MAX else 1
    items = P * H * A2
    rounds = -(-items // NT_MAX)
    return P, _round32(-(-items // rounds)), nbuf, P * A2 * row(nbuf) * 4


def tile_pixels(N: int, P: int, grid: int):
    """The pixel ranges each of `grid` persistent blocks takes, tile by tile
    (tiles blockIdx.x, blockIdx.x + gridDim.x, ...; a last tile ragged)."""
    tiles = -(-N // P)
    return [[range(t * P, min(N, (t + 1) * P)) for t in range(b, tiles, grid)]
            for b in range(min(grid, tiles))]


# --------------------------------------------------------- plain versions ---

def ang_attention_blockdiag_plain(q, k, v, num_heads: int):
    """Plain version of K7's forward with stats: (out [N, A2, C], m, l
    [N, A2, H]), m the row max of the scaled scores and l the sum of
    exp(s - m), per token and head."""
    dh = q.shape[-1] // num_heads
    s = (_heads(q, num_heads) * float(dh) ** -0.5) @ _heads(k, num_heads).transpose(-1, -2)
    m = s.amax(-1)                                            # [N, H, A2]
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    out = _merge((e / l[..., None]) @ _heads(v, num_heads))
    return out.contiguous(), m.transpose(1, 2).contiguous(), l.transpose(1, 2).contiguous()


def ang_attention_blockdiag_bf16_plain(q, k, v, num_heads: int, with_stats: bool = False):
    """Plain version of K7's forward on bf16 q, k, v [N, A2, C] -> bf16
    (module docstring): f32 arithmetic over the bf16 values, rounded at
    lft_tpu's points. with_stats: (out, m, l), m and l f32 [N, A2, H], m the
    token's max over its heads in every head's slot."""
    H = num_heads
    qf, kf, vf = (_heads(t.float(), H) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * float(q.shape[-1] // H) ** -0.5   # [N, H, A2, A2]
    m = s.amax(-1, keepdim=True).amax(1, keepdim=True)                  # [N, 1, A2, 1]
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    out = _merge((bf16_round(e) @ vf) * (1.0 / l)).bfloat16().contiguous()
    if not with_stats:
        return out
    return (out, m[:, 0, :, 0, None].expand(-1, -1, H).contiguous(),
            l[..., 0].transpose(1, 2).contiguous())


def ang_attention_blockdiag_bwd_plain(q, k, v, m, l, dout, num_heads: int):
    """Plain version of K7's backward: (dq, dk, dv) from (q, k, v, m, l,
    dout), the identities written out (ds = p (dp - sum_j p dp))."""
    H = num_heads
    scale = float(q.shape[-1] // H) ** -0.5
    qh = _heads(q, H) * scale
    kh, vh, doh = _heads(k, H), _heads(v, H), _heads(dout, H)
    p = torch.exp(qh @ kh.transpose(-1, -2) - m.transpose(1, 2)[..., None]) \
        / l.transpose(1, 2)[..., None]                        # [N, H, A2, A2]
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (_merge(ds @ kh).contiguous() * scale, _merge(ds.transpose(-1, -2) @ qh).contiguous(),
            _merge(p.transpose(-1, -2) @ doh).contiguous())


def ang_attention_blockdiag_bwd_bf16_plain(q, k, v, m, l, dout, num_heads: int):
    """Plain version of K7's backward on bf16 q, k, v, dout (module
    docstring): float64 between lft_tpu's rounding points, ds and a rounded
    to bf16 before their products, dq, dk, dv rounded once to bf16."""
    H = num_heads
    scale = float(torch.tensor(float(q.shape[-1] // H) ** -0.5))     # the f32 scale
    qh, kh, vh, doh = (_heads(t.double(), H) for t in (q, k, v, dout))
    a = torch.exp((qh @ kh.transpose(-1, -2)) * scale - m.double().transpose(1, 2)[..., None]) \
        * (1.0 / l.double().transpose(1, 2)[..., None])                # [N, H, A2, A2]
    dov = doh @ vh.transpose(-1, -2)
    ds = bf16_round(a * (dov - (a * dov).sum(-1, keepdim=True)) * scale)
    return tuple(_merge(g).bfloat16().contiguous() for g in (
        ds @ kh, ds.transpose(-1, -2) @ qh, bf16_round(a).transpose(-1, -2) @ doh))


# -------------------------------------------------------- kernel wrappers ---

def _check_shape(kernel: str, q, num_heads: int) -> None:
    if q.dim() != 3 or q.shape[-1] not in KERNEL_C or num_heads != 8 \
            or not mxu_applicable(q.shape[1]):
        raise NotImplementedError(
            f"{kernel} kernel takes [N, A2, C] tokens with C in {KERNEL_C}, 8 heads and "
            f"A2 <= {BLK}; got shape {tuple(q.shape)}, heads={num_heads}")


def ang_attn_fwd(q, k, v, num_heads: int, with_stats: bool = False, kernel: str = "ang_attn"):
    """K7's forward: the CUDA kernel for CUDA tensors (`ang_attn`, or
    `ang_attn_res` with stats), the plain version for CPU tensors.
    with_stats: (out, m, l), else out. `kernel`: the name the launch is
    counted under (K8 launches this kernel as `ang_attn_sweep` at A2 <= 128),
    `_res` appended with stats. bf16 tensors: `ang_attn_bf16io` (the
    deferred softmax, module docstring; `ang_attn_sweep_bf16io` launches the
    f32 kernel's bf16-IO instance: f32 inside, the output rounded once)."""
    name = io_kernel(kernel + "_res" if with_stats else kernel, q)
    bio = q.dtype == torch.bfloat16
    if not on_card(q):
        if bio:
            return ang_attention_blockdiag_bf16_plain(q, k, v, num_heads, with_stats)
        out, m, l = ang_attention_blockdiag_plain(q, k, v, num_heads)
        return (out, m, l) if with_stats else out
    _check_shape(name, q, num_heads)
    N, A2, C = q.shape
    out = torch.empty_like(q)
    tail = (N, A2, C, num_heads, float(C // num_heads) ** -0.5)
    types = (ctypes.c_int,) * 4 + (ctypes.c_float,)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    _build.check_cuda_args(name, q, k, v, dtype=q.dtype if bio else torch.float32)
    res = "_res" if with_stats else ""
    entry = ((f"lft_ang_attn{res}_bf16io" if kernel == "ang_attn" else
              f"lft_ang_attn_f32in{res}_bf16io") if bio else f"lft_ang_attn{res}")
    if not with_stats:
        _build.launch("ang_attn", name, _build.bind("ang_attn", entry, 4, types), q.device,
                      *ptrs, *tail)
        return out
    m = torch.empty(N, A2, num_heads, device=q.device)
    l = torch.empty_like(m)
    fn = _build.bind("ang_attn", entry, 6, types)
    _build.launch("ang_attn", name, fn, q.device, *ptrs, m.data_ptr(), l.data_ptr(), *tail)
    return out, m, l


def ang_attn_bwd(q, k, v, m, l, dout, num_heads: int, kernel: str = "ang_attn_bwd"):
    """K7's backward (`ang_attn_bwd`): (dq, dk, dv) [N, A2, C]. `kernel`: the
    name the launch is counted under (K8's f32 backward at A2 <= 32). bf16
    tensors: `ang_attn_bwd_bf16io` (module docstring)."""
    bio = q.dtype == torch.bfloat16
    kernel = io_kernel(kernel, q)
    if not on_card(q):
        if bio:
            return ang_attention_blockdiag_bwd_bf16_plain(q, k, v, m, l, dout, num_heads)
        return ang_attention_blockdiag_bwd_plain(q, k, v, m, l, dout, num_heads)
    _check_shape(kernel, q, num_heads)
    _build.check_cuda_args(kernel, q, k, v, dout, dtype=q.dtype if bio else torch.float32)
    _build.check_cuda_args(kernel, m, l)
    N, A2, C = q.shape
    outs = tuple(torch.empty_like(q) for _ in range(3))
    fn = _build.bind("ang_attn", "lft_ang_attn_bwd" + ("_bf16io" if bio else ""), 9,
                     (ctypes.c_int,) * 4 + (ctypes.c_float,))
    _build.launch("ang_attn", kernel, fn, q.device,
                  *(t.data_ptr() for t in (q, k, v, dout, m, l, *outs)),
                  N, A2, C, num_heads, float(C // num_heads) ** -0.5)
    return outs


class AngAttnFn(torch.autograd.Function):
    """K7 with stats forward, K7's backward; saves (q, k, v, m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        out, m, l = ang_attn_fwd(q, k, v, num_heads, with_stats=True)
        ctx.save_for_backward(q, k, v, m, l)
        ctx.num_heads, ctx.plain = num_heads, not on_card(q)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l = ctx.saved_tensors
        with plain_if(ctx.plain):
            return (*ang_attn_bwd(q, k, v, m, l, dout.contiguous(), ctx.num_heads), None)


def ang_attention_blockdiag(q, k, v, num_heads: int):
    """Differentiable attention over the view axis of projected [N, A2, C]
    q/k/v."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        return AngAttnFn.apply(q, k, v, num_heads)
    return ang_attn_fwd(q, k, v, num_heads)


def ang_attention_mxu(qn, v, in_proj_weight, out_proj_weight, num_heads: int):
    """Drop-in for the AngTrans MHSA (q = k from the normed tokens `qn`, v
    from the raw ones; torch-packed projections) on [..., A2, C] tokens.
    Requires `mxu_applicable(A2)`."""
    *lead, A2, C = qn.shape
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    out = ang_attention_blockdiag(mm(qn, wq.T).reshape(-1, A2, C),
                                  mm(qn, wk.T).reshape(-1, A2, C),
                                  mm(v, wv.T).reshape(-1, A2, C), num_heads)
    return mm(out.reshape(*lead, A2, C), out_proj_weight.T)
