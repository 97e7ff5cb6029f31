"""K8: per-op angular attention as a sweep over the key views, any view
count (counterpart of lft_tpu/kernels/ang_attn_vjp.py).

`ang_attention(q, k, v, num_heads)` is full multi-head attention over the A2
view tokens of each pixel, [N, A2, C] -> [N, A2, C], scale (C / heads)^-0.5
inside. On a CPU tensor it runs the plain PyTorch versions below (the JAX
kernel's online softmax over the key views). On a CUDA tensor it launches
hand-written kernels, counted under K8's names: the forward at A2 <= 128
K7's (`lft_torch/csrc/ang_attn.cu`, the same function; only
`LFT_ANG_VARIANT=sweep` sends such pixels here) and past 128 views that of
`lft_torch/csrc/ang_attn_sweep.cu`; the backward K7's up to 32 views and
`ang_attn_sweep.cu`'s from 33. There is no fallback from one to the other.

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

bf16 q, k, v (`--dtype bfloat16` serving): lft_tpu's kernel (:22-50) widens
q, k and v to f32, scales q, runs its online softmax in f32 and rounds the
output once. On the card `ang_attn_sweep_bf16io`: at A2 <= 128 K7's f32
kernel's bf16-IO instance, past 128 the streamed-key kernel's
(`lft_ang_attn_sweep_bf16io`), both f32 inside; on the CPU the plain
version on the widened values, rounded once. Training in bf16: the `_res`
form (`ang_attn_sweep_res_bf16io`: the same two instances writing each
head's m and l) and the backward (`ang_attn_sweep_bwd_bf16io`, lft_tpu's
_vjp_bwd on bf16 tensors, :54-87 and :145-167: f32 inside, nothing rounded
but dq, dk and dv, once, D = rowsum_head(dout * out) over the SAVED BF16
OUTPUT): the streamed-key backward's bf16-IO instance at every view count,
K7's backward (which forms D from its scores) never; the plain backward in
float64 on the widened values, rounded once.
"""

from __future__ import annotations

import ctypes

import torch

from lft_torch.kernels import _build
from lft_torch.kernels import ang_attn_mxu as am
from lft_torch.kernels.ang_block import _heads, _merge, _needs_grad
from lft_torch.kernels.common import KERNEL_C, io_kernel, mm, on_card, plain_if

M_INIT = -1e30     # the sweep's first running max, as in the JAX kernel

# The launch geometry of csrc/ang_attn_sweep.cu (`fwd_geo`, `bwd_geo`, the
# tile walk and the item maps), mirrored for the tests. Both kernels are
# persistent over tiles of one pixel's head group; the group's key (or query)
# rows pass through a ring of NS stages of KS rows.
H = 8
KS = 32            # key (or query) rows a stage
NS = 3             # stages of the ring
NT_TILE = 256      # items (query pairs or tokens x heads) a tile, where heads allow
NT_MAX = am.NT_MAX
SMEM_MAX = am.SMEM_MAX
# Up to 32 views the backward launches K7's `ang_attn_bwd` (which ignores
# out): there K7 holds p and dp in registers and runs faster; from 33 views
# the streamed backward is faster (`compare_k8`, in turns at 25-128 views).
K7_BWD_MAX = am.HOLD_MAX


def head_group(per_head: int, dh: int) -> int:
    """The most heads of a tile (8, 4, 2, 1) whose `per_head` items fit
    NT_TILE, at least 16 bytes of a row (2 heads at dh = 2)."""
    hg = H
    while hg > 1 and hg * per_head > NT_TILE:
        hg //= 2
    return max(hg, 4 // dh)


def fwd_geometry(A2: int, C: int, stats: bool = True):
    """(heads a tile HG, query pairs a tile, query blocks a pixel's group,
    threads, shared bytes) of `ang_attn_sweep[_res]` past 128 views: a
    thread takes two queries of one head; a tile is one pixel's HG heads and
    up to 2 x 512 / HG of its queries, with three stages of 32 key rows, two
    q buffers and (stats) m, l."""
    dh, qp = C // H, (A2 + 1) // 2
    hg = head_group(qp, dh)
    qbp = min(qp, NT_MAX // hg)
    ldw, qr = hg * dh + 4, 2 * qbp
    floats = NS * 2 * KS * ldw + 2 * qr * ldw + (2 * qr * hg if stats else 0)
    return hg, qbp, -(-qp // qbp), am._round32(hg * qbp), floats * 4


def bwd_geometry(A2: int, C: int):
    """(heads a tile HG, rounds a phase, threads, shared bytes) of
    `ang_attn_sweep_bwd`: a thread takes one (head, query) in the query phase
    and one (head, key) in the key phase, in as many rounds as 512 threads
    need (each streaming the stages again); three stages of 32 rows and a
    float4 {m, 1 / l, D, 0} a (query, head) of the tile."""
    dh = C // H
    hg = head_group(A2, dh)
    items = hg * A2
    rounds = -(-items // NT_MAX)
    floats = NS * 2 * KS * (hg * dh + 4) + 4 * hg * A2
    return hg, rounds, am._round32(-(-items // rounds)), floats * 4


def _chunk_rows(A2: int):
    return [range(c * KS, min(A2, c * KS + KS)) for c in range(-(-A2 // KS))]


def fwd_tiles(N: int, A2: int, C: int, grid: int):
    """The tiles each of `grid` persistent blocks of the forward takes, in
    order, as (pixel, heads, queries, staged key rows): tile t is query block
    t % NQB of head group t // NQB % (8 / HG) of pixel t // (NQB 8 / HG)."""
    hg, qbp, nqb, _, _ = fwd_geometry(A2, C)
    ng, qr = H // hg, 2 * qbp
    tiles, rows = N * ng * nqb, _chunk_rows(A2)
    return [[(t // (nqb * ng), range(t // nqb % ng * hg, t // nqb % ng * hg + hg),
              range(t % nqb * qr, min(A2, t % nqb * qr + qr)), rows)
             for t in range(b, tiles, grid)] for b in range(min(grid, tiles))]


def fwd_thread_items(A2: int, C: int, nq: int):
    """{thread: (head of the group, queries it writes)} of a forward tile of
    nq queries: pair pr = tid % QBP of head tid // QBP, queries 2 pr and 2 pr
    + 1 (a lone last query runs twice and is written once)."""
    hg, qbp, _, nt, _ = fwd_geometry(A2, C)
    items = {}
    for tid in range(nt):
        pr, hh = tid % qbp, tid // qbp
        if hh < hg and 2 * pr < nq:
            items[tid] = (hh, [2 * pr] + ([2 * pr + 1] if 2 * pr + 1 < nq else []))
    return items


def bwd_tiles(N: int, A2: int, C: int, grid: int):
    """The tiles each of `grid` persistent blocks of the backward takes, in
    order, as (pixel, heads, staged rows of the query phase (k, v), of the
    key phase (q, dout)): tile t is head group t % (8 / HG) of pixel
    t // (8 / HG); each phase streams the rows once a round."""
    hg, rounds, _, _ = bwd_geometry(A2, C)
    ng = H // hg
    rows = _chunk_rows(A2) * rounds
    return [[(t // ng, range(t % ng * hg, t % ng * hg + hg), rows, rows)
             for t in range(b, N * ng, grid)] for b in range(min(grid, N * ng))]


def bwd_thread_items(A2: int, C: int):
    """[(round, thread, head of the group, token)] of a backward tile: item
    r nt + tid is token item % A2 of head item // A2 (queries in the query
    phase, keys in the key phase)."""
    hg, rounds, nt, _ = bwd_geometry(A2, C)
    return [(r, tid, (r * nt + tid) // A2, (r * nt + tid) % A2)
            for r in range(rounds) for tid in range(nt) if (r * nt + tid) // A2 < hg]


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
    """K8's forward: for CUDA tensors `ang_attn_sweep` (or
    `ang_attn_sweep_res` with stats), K7's kernel at A2 <= 128 and the
    streamed-key kernel past it; the plain version for CPU tensors.
    with_stats: (out, m, l), else out. bf16 tensors: `ang_attn_sweep_bf16io`
    (module docstring)."""
    name = io_kernel("ang_attn_sweep_res" if with_stats else "ang_attn_sweep", q)
    if not on_card(q):
        if q.dtype == torch.bfloat16:
            out, m, l = ang_attention_sweep_plain(q.float(), k.float(), v.float(), num_heads)
            return (out.bfloat16(), m, l) if with_stats else out.bfloat16()
        out, m, l = ang_attention_sweep_plain(q, k, v, num_heads)
        return (out, m, l) if with_stats else out
    _check_shape(name, q, num_heads)
    if am.mxu_applicable(q.shape[1]):
        return am.ang_attn_fwd(q, k, v, num_heads, with_stats, kernel="ang_attn_sweep")
    bio = q.dtype == torch.bfloat16
    _build.check_cuda_args(name, q, k, v, dtype=q.dtype if bio else torch.float32)
    N, A2, C = q.shape
    out = torch.empty_like(q)
    tail = (N, A2, C, num_heads, float(C // num_heads) ** -0.5)
    types = (ctypes.c_int,) * 4 + (ctypes.c_float,)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if not with_stats:
        fn = _build.bind("ang_attn_sweep", "lft_" + name, 4, types)
        _build.launch("ang_attn_sweep", name, fn, q.device, *ptrs, *tail)
        return out
    m = torch.empty(N, A2, num_heads, device=q.device)
    l = torch.empty_like(m)
    fn = _build.bind("ang_attn_sweep", "lft_" + name, 6, types)
    _build.launch("ang_attn_sweep", name, fn, q.device, *ptrs, m.data_ptr(), l.data_ptr(), *tail)
    return out, m, l


def sweep_bwd_launch(q, k, v, out, m, l, dout, num_heads: int):
    """The streamed-key backward kernel (`lft_ang_attn_sweep_bwd`) at any A2,
    counted as `ang_attn_sweep_bwd`: (dq, dk, dv) [N, A2, C] of CUDA tensors;
    bf16 ones its bf16-IO instance, `ang_attn_sweep_bwd_bf16io`."""
    name = io_kernel("ang_attn_sweep_bwd", q)
    _check_shape(name, q, num_heads)
    _build.check_cuda_args(name, q, k, v, dout, out, dtype=q.dtype)
    _build.check_cuda_args(name, m, l)
    N, A2, C = q.shape
    grads = tuple(torch.empty_like(q) for _ in range(3))
    fn = _build.bind("ang_attn_sweep", "lft_" + name, 10,
                     (ctypes.c_int,) * 4 + (ctypes.c_float,))
    _build.launch("ang_attn_sweep", name, fn, q.device,
                  *(t.data_ptr() for t in (q, k, v, dout, out, m, l, *grads)),
                  N, A2, C, num_heads, float(C // num_heads) ** -0.5)
    return grads


def ang_attn_sweep_bwd(q, k, v, out, m, l, dout, num_heads: int):
    """K8's backward (`ang_attn_sweep_bwd`): (dq, dk, dv) [N, A2, C]; for
    CUDA tensors K7's backward kernel at A2 <= K7_BWD_MAX (from m, l; out
    unread), the streamed-key kernel beyond; the plain version for CPU
    tensors. bf16 tensors: the streamed-key kernel's bf16-IO instance at
    every A2 (D from the saved `out`; module docstring), their plain
    version in float64, rounded once."""
    bio = q.dtype == torch.bfloat16
    io_kernel("ang_attn_sweep_bwd", q)
    if not on_card(q):
        if bio:
            grads = ang_attention_sweep_bwd_plain(
                *(t.double() for t in (q, k, v, out, m, l, dout)), num_heads)
            return tuple(g.bfloat16() for g in grads)
        return ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, num_heads)
    _check_shape("ang_attn_sweep_bwd", q, num_heads)
    if q.shape[1] <= K7_BWD_MAX and not bio:
        return am.ang_attn_bwd(q, k, v, m, l, dout, num_heads, kernel="ang_attn_sweep_bwd")
    return sweep_bwd_launch(q, k, v, out, m, l, dout, num_heads)


class AngSweepFn(torch.autograd.Function):
    """K8 with stats forward, K8's backward; saves (q, k, v, out, m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        out, m, l = ang_attn_sweep_fwd(q, k, v, num_heads, with_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.num_heads, ctx.plain = num_heads, not on_card(q)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        with plain_if(ctx.plain):
            return (*ang_attn_sweep_bwd(q, k, v, out, m, l, dout.contiguous(), ctx.num_heads),
                    None)


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
    out = ang_attention(mm(qn, wq.T).reshape(-1, A2, C), mm(qn, wk.T).reshape(-1, A2, C),
                        mm(v, wv.T).reshape(-1, A2, C), num_heads)
    return mm(out.reshape(*lead, A2, C), out_proj_weight.T)
