"""K5: per-op 5x5-window attention of projected q/k/v images (counterpart
of lft_tpu/kernels/spa_attn_hp.py), on K2.3's window layout.

`windowed_attention_headpacked(q, k, v, num_heads, ksize)` maps projected
[B, h, w, E] images to the attention output [B, h, w, E]: every pixel
attends, per head, to the keys of its ksize x ksize window that lie inside
the image (scale (E / heads)^-0.5 inside). On a CUDA tensor it launches the
hand-written kernels of `lft_torch/csrc/spa_attn_hp.cu`; on a CPU tensor it
runs the plain PyTorch versions below. There is no fallback from one to the
other.

The forward is K2.3's kernel (`csrc/window_attn.cuh`, the fused SpaTrans
block's window step): a block takes a (view, 16 x 16 tile, 32-float head
group) item. The backward is two kernels in one launch: pass q (K2.3's
items: dq and D = sum_j p_j dp_j per pixel and head, into a scratch) and
pass kv (a (view, tile, head pair) item: dk, dv gathered over the queries
whose window holds a key). Their geometry is mirrored in
`kernels/spa_block.py` (`window_items`, `hp_kv_items`, ...).

Training: when grad mode is on and q, k or v requires grad it runs as
`SpaAttnHpFn`, whose forward also returns the per-(pixel, head) softmax max
m and denominator l (`spa_attn_hp_res`) and saves only (q, k, v, m, l); the
backward (`spa_attn_hp_bwd`) rebuilds the probabilities from them.

bf16 q, k, v (`--dtype bfloat16` serving): lft_tpu's kernel with io = bf16
(:222-280) defers its normalisation: f32 scores (q . k) scale, m each
query's max over EVERY head and its window's keys, in-window keys outside the
image scoring exactly 0 (its zero-padded halo: the npad correction
:251-262), e = exp(s - m) rounded to bf16 for the product with v, l the sum
of the unrounded e, out = bf16(o (1 / l)). That is the fused SpaTrans
block's bf16 window step, K2.3 bf16io: on the card `spa_attn_hp_bf16io`
launches its kernel (`window_attn.cuh:spa_window_attn_bf16io_kernel`), on
the CPU the plain version is its plain version (`spa_block.
window_attn_plain`). The same wrapper launches the bf16-IO instances of K6
(`spa_attn_mxu_bf16io`: lft_tpu's per-head softmax, p = bf16(e / l) before
the product) and of K9 and K10 (`spa_attn_offset_bf16io`,
`spa_attn_tile_bf16io`: f32 inside, the output rounded once) on
`spa_window_attn_kernel`'s IO-typed instances.

Training in bf16 (`--dtype bfloat16` through the per-op branch): each
family's `_res` form is its forward's kernel writing (m, l) f32 in the
layout its backward reads (`spa_attn_hp_res_bf16io`: K2.3 res bf16io's
kernel, m the query's max over its heads in every head's slot;
`spa_attn_mxu_res_bf16io` and `spa_attn_offset_res_bf16io`: each head's own
max and sum). The backwards: K5's (`spa_attn_hp_bwd_bf16io`) is K3.c
bf16io's passes, `lft_spa_attn_hp_bwd_bf16io` (lft_tpu's _vjp_bwd with io =
bf16, :464-527, is K3's window step backward: p = e (1 / l), D = sum_j p_j
dp_j in f32, ds = bf16(p (dp - D) scale) and bf16(p) before their products,
dq, dk, dv summed in f32 and rounded once); K6's (`spa_attn_mxu_bwd_bf16io`)
the same passes with p = e / l, as lft_tpu's K6 divides
(`lft_spa_attn_norm_bwd_bf16io`); K9's (`spa_attn_offset_bwd_bf16io`) the
f32 passes on bf16 tensors with D = dout . out from the saved bf16 output
(`lft_spa_attn_f32in_bwd_bf16io`). On the CPU, or inside
`common.plain_versions()`, their plain versions: K5's is K3.c's
(`spa_block.window_attn_bwd_plain`'s bf16 branch, float64 between the
rounding points).

`headpacked_applicable` decides the dispatch exactly as the JAX package's
does (its tile search is the TPU's; the port keeps its outcome, so both
packages send a geometry to the same kernel). The CUDA kernels themselves
take any h and w.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from lft_torch.kernels import _build
from lft_torch.kernels.ang_block import _needs_grad
from lft_torch.kernels.common import io_kernel, on_card, plain_if

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


def headpacked_applicable(h: int, w: int, E: int, num_heads: int, k: int) -> bool:
    """Same outcome as lft_tpu.kernels.spa_attn_hp.headpacked_applicable."""
    if E % num_heads:
        return False
    return _hp_geometry_exists(h, w, num_heads, k)


# --------------------------------------------------------- plain versions ---

def _window_offsets(ksize: int):
    r = ksize // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


@functools.lru_cache(maxsize=None)
def _window_valid(h: int, w: int, ksize: int) -> np.ndarray:
    """[h, w, k*k] bool: key offset j of the query at (y, x) lies in the image."""
    yy, xx = np.arange(h)[:, None], np.arange(w)[None, :]
    return np.stack([(yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)
                     for dy, dx in _window_offsets(ksize)], axis=-1)


def _gather_window(t: torch.Tensor, ksize: int) -> torch.Tensor:
    """[B, h, w, E] -> [B, h, w, k*k, E]: each pixel's window, zero outside."""
    r = ksize // 2
    B, h, w, E = t.shape
    tp = F.pad(t, (0, 0, r, r, r, r))
    return torch.stack([tp[:, r + dy:r + dy + h, r + dx:r + dx + w]
                        for dy, dx in _window_offsets(ksize)], dim=3)


def _scatter_window(tw: torch.Tensor, ksize: int) -> torch.Tensor:
    """Adjoint of `_gather_window`: [B, h, w, k*k, E] -> [B, h, w, E]."""
    r = ksize // 2
    B, h, w, _, E = tw.shape
    out = tw.new_zeros(B, h + 2 * r, w + 2 * r, E)
    for j, (dy, dx) in enumerate(_window_offsets(ksize)):
        out[:, r + dy:r + dy + h, r + dx:r + dx + w] += tw[:, :, :, j]
    return out[:, r:r + h, r:r + w].contiguous()


def _window_probs(q, k, num_heads: int, ksize: int, m=None, l=None):
    """Softmax probabilities [B, h, w, k*k, H] of the window attention and
    the scaled heads of q [B, h, w, H, dh]; from the saved (m, l) where
    given, else computed (then also returned)."""
    B, h, w, E = q.shape
    dh = E // num_heads
    qh = q.reshape(B, h, w, num_heads, dh) * float(dh) ** -0.5
    kw = _gather_window(k, ksize).reshape(B, h, w, -1, num_heads, dh)
    s = torch.einsum("byxhd,byxjhd->byxjh", qh, kw)
    valid = torch.from_numpy(_window_valid(h, w, ksize)).to(q.device)[..., None]
    s = s.masked_fill(~valid, float("-inf"))
    if m is None:
        m = s.amax(3)
        l = torch.exp(s - m[:, :, :, None]).sum(3)
    return torch.exp(s - m[:, :, :, None]) / l[:, :, :, None], qh, m, l


def windowed_attention_headpacked_plain(q, k, v, num_heads: int, ksize: int):
    """Plain version of K5's forward with stats: (out, m, l), m and l
    [B, h, w, H] per pixel and head."""
    B, h, w, E = q.shape
    p, _, m, l = _window_probs(q, k, num_heads, ksize)
    vw = _gather_window(v, ksize).reshape(B, h, w, -1, num_heads, E // num_heads)
    out = torch.einsum("byxjh,byxjhd->byxhd", p, vw).reshape(B, h, w, E)
    return out.contiguous(), m.contiguous(), l.contiguous()


def windowed_attention_headpacked_dsum_plain(q, k, v, m, l, dout, num_heads: int,
                                              ksize: int):
    """D = sum_j p_j dp_j [B, h, w, H] from (q, k, v, m, l, dout): what the
    backward's pass q writes beside dq."""
    B, h, w, E = q.shape
    p, _, _, _ = _window_probs(q, k, num_heads, ksize, m, l)
    vw = _gather_window(v, ksize).reshape(B, h, w, -1, num_heads, E // num_heads)
    dp = torch.einsum("byxhd,byxjhd->byxjh", dout.reshape(B, h, w, num_heads, -1), vw)
    return (p * dp).sum(3)


def windowed_attention_headpacked_bwd_plain(q, k, v, m, l, dout, num_heads: int, ksize: int):
    """Plain version of K5's backward: (dq, dk, dv) from (q, k, v, m, l,
    dout), the identities written out (ds = p (dp - sum_j p dp))."""
    B, h, w, E = q.shape
    H, dh = num_heads, E // num_heads
    p, qh, _, _ = _window_probs(q, k, H, ksize, m, l)
    doh = dout.reshape(B, h, w, H, dh)
    vw = _gather_window(v, ksize).reshape(B, h, w, -1, H, dh)
    kw = _gather_window(k, ksize).reshape(B, h, w, -1, H, dh)
    dp = torch.einsum("byxhd,byxjhd->byxjh", doh, vw)
    ds = p * (dp - (p * dp).sum(3, keepdim=True))
    dq = torch.einsum("byxjh,byxjhd->byxhd", ds, kw) * float(dh) ** -0.5
    dkw = torch.einsum("byxjh,byxhd->byxjhd", ds, qh)
    dvw = torch.einsum("byxjh,byxhd->byxjhd", p, doh)
    return (dq.reshape(B, h, w, E).contiguous(),
            _scatter_window(dkw.reshape(B, h, w, -1, E), ksize),
            _scatter_window(dvw.reshape(B, h, w, -1, E), ksize))


# -------------------------------------------------------- kernel wrappers ---

def _check_shape(kernel: str, q, num_heads: int, ksize: int) -> None:
    E = q.shape[-1]
    if q.dim() != 4 or num_heads != 8 or ksize != 5 or E % num_heads \
            or E // num_heads not in (4, 8, 16):
        raise NotImplementedError(
            f"{kernel} kernel takes [B, h, w, E] images, 8 heads of width 4, 8 or 16 and a "
            f"5x5 window; got shape {tuple(q.shape)}, heads={num_heads}, k={ksize}")


# The bf16-IO entries (`lft_spa_attn_<family>[_res|_bwd]_bf16io`) of each
# kernel that launches K5's wrappers: deferred (K5, K2.3 bf16io's kernels),
# normalized (K6) and f32 inside (K9, K10).
_BF16IO_FAMILY = {"spa_attn_hp": "hp", "spa_attn_mxu": "norm", "spa_attn_offset": "f32in",
                  "spa_attn_tile": "f32in", "spa_window_attn": "hp"}


def _family(kernel: str) -> str:
    return next(f for k, f in _BF16IO_FAMILY.items() if kernel.startswith(k))


def windowed_attention_headpacked_bf16_plain(q, k, v, num_heads: int, ksize: int,
                                             with_stats: bool = False):
    """Plain version of K5's forward on bf16 q, k, v -> bf16 (module
    docstring): K2.3's bf16 window step; with_stats (out, m, l), m the
    query's max over its heads in every head's slot."""
    from lft_torch.kernels.spa_block import window_attn_plain
    res = window_attn_plain(q, k, v, num_heads, ksize)
    return res if with_stats else res[0]


def spa_attn_hp_fwd(q, k, v, num_heads: int, ksize: int, with_stats: bool = False,
                    kernel: str = "spa_attn_hp"):
    """K5's forward: the CUDA kernel for CUDA tensors (`spa_attn_hp`, or
    `spa_attn_hp_res` with stats), the plain version for CPU tensors.
    with_stats: (out, m, l), else out. `kernel`: the name the launch is
    counted under, `_res` appended with stats (K6's forward launches it as
    `spa_attn_mxu`). bf16 tensors: the family's bf16-IO instance,
    `kernel + "_bf16io"` (module docstring)."""
    name = io_kernel(kernel + "_res" if with_stats else kernel, q)
    bio = q.dtype == torch.bfloat16
    if not on_card(q):
        if bio:
            return windowed_attention_headpacked_bf16_plain(q, k, v, num_heads, ksize,
                                                            with_stats)
        out, m, l = windowed_attention_headpacked_plain(q, k, v, num_heads, ksize)
        return (out, m, l) if with_stats else out
    _check_shape(name, q, num_heads, ksize)
    _build.check_cuda_args(name, q, k, v, dtype=q.dtype if bio else torch.float32)
    B, h, w, E = q.shape
    out = torch.empty_like(q)
    tail = (B, h, w, E, num_heads, float(E // num_heads) ** -0.5)
    types = (ctypes.c_int,) * 5 + (ctypes.c_float,)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    entry = (f"lft_spa_attn_{_family(kernel)}{'_res' if with_stats else ''}_bf16io" if bio
             else "lft_spa_attn_hp_res" if with_stats else "lft_spa_attn_hp")
    if not with_stats:
        _build.launch("spa_attn_hp", name, _build.bind("spa_attn_hp", entry, 4, types), q.device,
                      *ptrs, *tail)
        return out
    m = torch.empty(B, h, w, num_heads, device=q.device)
    l = torch.empty_like(m)
    fn = _build.bind("spa_attn_hp", entry, 6, types)
    _build.launch("spa_attn_hp", name, fn, q.device, *ptrs, m.data_ptr(), l.data_ptr(), *tail)
    return out, m, l


def spa_attn_hp_bwd(q, k, v, m, l, dout, num_heads: int, ksize: int, with_dsum: bool = False,
                    kernel: str = "spa_attn_hp_bwd", half: bool = False, out=None, sites=None):
    """K5's backward: (dq, dk, dv) [B, h, w, E]; with_dsum also D [B, h, w,
    H], the scratch pass q hands to pass kv. `kernel`: the name the launch
    is counted under (the fused SpaTrans backward's step c launches it as
    `spa_window_attn_bwd`, K6 and K9 under theirs). `half`: the passes'
    bf16-operand instance (`lft_spa_attn_hp_bwd_bf16`, which only K3.c's
    `--dtype mixed` form launches, on the card only: its plain version is
    `spa_block.window_attn_bwd_plain` under the plan); `sites`, a mask of
    `common.SITE_BITS` (`score`, `av`): their site-subset instance
    (`lft_spa_attn_hp_bwd_sites`, K3.c under an LFT_MM_HP_BWD_SITES subset,
    likewise on the card only). bf16 q, k, v and
    dout: `kernel`'s `_bf16io` instance (module docstring; K9's reads its
    saved bf16 output `out`), dq, dk, dv rounded to bf16 once; on the CPU or
    inside `plain_versions()` K5's plain version is
    `spa_block.window_attn_bwd_plain`'s bf16 branch."""
    bio = q.dtype == torch.bfloat16
    if bio and not kernel.endswith("_bf16io"):
        kernel = io_kernel(kernel, q)
    if (half or sites is not None) and q.device.type != "cuda":
        raise ValueError(f"{kernel}: the bf16-operand and site-subset instances run on the "
                         f"card only")
    if not on_card(q):
        if bio:
            from lft_torch.kernels.spa_block import window_attn_bwd_plain
            return window_attn_bwd_plain(q, k, v, None, dout, m, l, num_heads, ksize)
        grads = windowed_attention_headpacked_bwd_plain(q, k, v, m, l, dout, num_heads, ksize)
        if not with_dsum:
            return grads
        return (*grads, windowed_attention_headpacked_dsum_plain(q, k, v, m, l, dout, num_heads,
                                                                 ksize))
    _check_shape(kernel, q, num_heads, ksize)
    B, h, w, E = q.shape
    dsum = torch.empty(B, h, w, num_heads, device=q.device)
    outs = tuple(torch.empty_like(q) for _ in range(3))
    if bio:
        fam = _family(kernel)
        ins = (q, k, v, dout) + ((out,) if fam == "f32in" else ())
        _build.check_cuda_args(kernel, *ins, dtype=torch.bfloat16)
        _build.check_cuda_args(kernel, m, l)
        entry = f"lft_spa_attn_{fam}_bwd_bf16io"
    else:
        ins = (q, k, v, dout)
        _build.check_cuda_args(kernel, *ins, m, l)
        entry = "lft_spa_attn_hp_bwd" + ("_bf16" if half else "")
    tail, types = (B, h, w, E, num_heads, float(E // num_heads) ** -0.5), \
        (ctypes.c_int,) * 5 + (ctypes.c_float,)
    if sites is not None:
        entry, tail, types = entry + "_sites", tail + (sites,), types + (ctypes.c_int,)
    fn = _build.bind("spa_attn_hp", entry, len(ins) + 6, types)
    _build.launch("spa_attn_hp", kernel, fn, q.device,
                  *(t.data_ptr() for t in (*ins, m, l, dsum, *outs)), *tail)
    return (*outs, dsum) if with_dsum else outs


class SpaAttnHpFn(torch.autograd.Function):
    """K5 with stats forward, K5's backward; saves (q, k, v, m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, ksize):
        out, m, l = spa_attn_hp_fwd(q, k, v, num_heads, ksize, with_stats=True)
        ctx.save_for_backward(q, k, v, m, l)
        ctx.cfg, ctx.plain = (num_heads, ksize), not on_card(q)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l = ctx.saved_tensors
        with plain_if(ctx.plain):
            return (*spa_attn_hp_bwd(q, k, v, m, l, dout.contiguous(), *ctx.cfg), None, None)


def windowed_attention_headpacked(q, k, v, num_heads: int, ksize: int = 5):
    """Differentiable window attention on projected [B, h, w, E] q/k/v."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        return SpaAttnHpFn.apply(q, k, v, num_heads, ksize)
    return spa_attn_hp_fwd(q, k, v, num_heads, ksize)
