"""The 3x3 tokenization kernels on the tensor cores (K2.1 `spa_tokenize_ln`,
K11.1 `spa_tokenize_ln_pm`, K3.e `spa_tokenize_bwd`; `lft_torch/csrc/
tokenize.cuh`), on the CPU: their arithmetic, their tiles and their weights.

The CUDA kernel cannot run here; its scheme can. `_emulate` repeats the
kernel's arithmetic in plain PyTorch from the wrapper's own operand
(`spa_block.tap_weights`, unpacked from its core-matrix layout): every input
split into TF32 hi (cvt.rna's rounding) and lo (truncated, as the MMA reads
it), three 8-deep products al bh + ah bl + ah bh a k8 step, chains of 16 input
channels (two k8 steps) summed in their own accumulator, the chains added
in f32 in the kernel's order (tap, then channel). The tensor cores' own
rounding inside an MMA is not modelled: f32 sums here. Against float64 its
error must be at most twice that of the f32 convolution (the plain
version); one TF32 product misses that bound by far. The kernels are held to
the same bound on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_reduce import _split, _spread, _tf32

from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.common import KERNEL_C
from lft_torch.ops.unfold import unfold3x3_linear

CSRC = Path(sb.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unpack(wf: torch.Tensor):
    """tap_weights' layout [9, K/8, 2, 2, N/8, 8, 4] -> (hi, lo) [9, K, N]."""
    nine, kk, _, _, nj = wf.shape[:5]
    f = wf.permute(0, 2, 1, 3, 6, 4, 5).reshape(nine, 2, 8 * kk, 8 * nj)
    return f[:, 0], f[:, 1]


def _emulate(inp: torch.Tensor, wf: torch.Tensor, tf32_only: bool = False) -> torch.Tensor:
    """out[t] = sum_tap inp[t + s_tap] B[tap] in the kernel's arithmetic (see
    the module docstring); inp [V, h, w, K], zero outside each image. With
    tf32_only one TF32 product per term (the scheme without its tails)."""
    V, h, w, K = inp.shape
    bh, bl = _unpack(wf)
    N = bh.shape[-1]
    pad = F.pad(inp, (0, 0, 1, 1, 1, 1))
    ph, pl = _split(pad)
    if tf32_only:
        pl, bl = torch.zeros_like(pl), torch.zeros_like(bl)
    acc = torch.zeros(V * h * w, N)
    for tap in range(9):
        ky, kx = tap // 3, tap % 3
        ah = ph[:, ky:ky + h, kx:kx + w].reshape(-1, K)
        al = pl[:, ky:ky + h, kx:kx + w].reshape(-1, K)
        for c in range(0, K, 16):               # a chain: its own accumulator
            s = torch.zeros(V * h * w, N)
            for k in range(c, min(c + 16, K), 8):
                s = s + al[:, k:k + 8] @ bh[tap, k:k + 8]
                s = s + ah[:, k:k + 8] @ bl[tap, k:k + 8]
                s = s + ah[:, k:k + 8] @ bh[tap, k:k + 8]
            acc = acc + s
    return acc.reshape(V, h, w, N)


@pytest.mark.parametrize("C,h,w", [(16, 9, 7), (32, 12, 20), (64, 8, 30)])
@pytest.mark.parametrize("backward", [False, True])
def test_tokenize_3xtf32_scheme_keeps_f32_accuracy(C, h, w, backward):
    """Operands over six decades: the forward's tok and the backward's dx
    in the kernel's arithmetic are within twice the f32 convolution's error
    against float64; one TF32 product misses by more than 10x."""
    rng = np.random.RandomState(C + h + w + backward)
    D = 2 * C
    wu = torch.from_numpy(_spread(rng, (9, C, D)))
    wts = sb._with_mlp(dict(wu=wu))
    mlp64 = dict(mlp=wts["mlp"].double())
    if backward:
        inp = torch.from_numpy(_spread(rng, (3, h, w, D)))
        exact = sb.tokenize_bwd_plain(inp.double(), mlp64)
        f32 = sb.tokenize_bwd_plain(inp, wts)
    else:
        inp = torch.from_numpy(_spread(rng, (3, h, w, C)))
        exact = unfold3x3_linear(inp.double(), mlp64["mlp"])
        f32 = unfold3x3_linear(inp, wts["mlp"])
    wf = sb.tap_weights(wu, backward=backward)
    err = lambda t: float((t.double() - exact).abs().max())
    e_f32, e_3x, e_tf32 = err(f32), err(_emulate(inp, wf)), err(_emulate(inp, wf, True))
    assert e_3x <= 2 * e_f32, (e_3x, e_f32)
    assert e_tf32 > 10 * e_f32, (e_tf32, e_f32)


def test_weight_split_is_the_wgrad_split():
    """`split_tf32` is the split the wgrad scheme is tested with
    (test_torch_reduce._split): hi by cvt.rna's rounding, lo truncated."""
    a = torch.from_numpy(_spread(np.random.RandomState(3), (4096,)))
    hi, lo = sb.split_tf32(a)
    rh, rl = _split(a)
    assert torch.equal(hi, rh) and torch.equal(lo, rl) and torch.equal(hi, _tf32(a))


@pytest.mark.parametrize("C", KERNEL_C)
@pytest.mark.parametrize("backward", [False, True])
def test_tap_weights_core_matrix_layout(C, backward):
    """Entry (tap, kk, hi or lo, kh, j, n, t) holds that part of B[tap]
    [8 kk + 4 kh + t][8 j + n], with B[tap] = wu[tap] forward and wu[8 -
    tap]ᵀ backward: the K-major core matrices (8 columns x 4 k, 128 bytes)
    that the kernel's descriptors read, N / 8 apart by 128 bytes, the two k
    halves by N / 8 x 128."""
    D = 2 * C
    wu = torch.from_numpy(np.random.RandomState(C).randn(9, C, D).astype(np.float32))
    B = torch.stack([wu[8 - t].t() for t in range(9)]) if backward else wu
    K, N = B.shape[1:]
    wf = sb.tap_weights(wu, backward=backward)
    assert wf.shape == (9, K // 8, 2, 2, N // 8, 8, 4) and wf.is_contiguous()
    parts = torch.stack(_split(B), dim=1)                  # [9, 2, K, N]
    tap, kk, part, kh, j, n, t = np.meshgrid(*(np.arange(d) for d in wf.shape), indexing="ij")
    assert torch.equal(wf, parts[tap, part, 8 * kk + 4 * kh + t, 8 * j + n])
    # byte offsets of one k8 step's hi part: 16 bytes a row of a core matrix,
    # 128 a core matrix along N, N / 8 x 128 between the k halves
    step = wf[0, 0, 0].reshape(-1)
    assert torch.equal(step[(N // 8) * 32 + 1 * 4 + 2], wf[0, 0, 0, 1, 0, 1, 2])
    j = N // 8 - 1
    assert torch.equal(step[j * 32 + 5 * 4 + 1], wf[0, 0, 0, 0, j, 5, 1])


def _kernel_indexing(h, w, r, cw, V=2):
    """The kernel's token and band indexing for V views of h x w in tiles
    of r x cw (tokenize.cuh): per token row m of a block, its token (-1 if
    none) and, per tap, the band pixel it reads and that pixel's image
    position."""
    bw, ntok = cw + 2, r * cw
    txs = -(-w // cw)
    per_view = -(-h // r) * txs
    b = np.arange(V * per_view)[:, None]
    view, tile = b // per_view, b % per_view
    y0, x0 = (tile // txs) * r, (tile % txs) * cw
    m = np.arange(128)[None, :]
    y, x = y0 + m // cw, x0 + m % cw
    valid = (m < ntok) & (y < h) & (x < w)
    token = np.where(valid, view * h * w + y * w + x, -1)
    pix = np.where(m < ntok, (m // cw + 1) * bw + m % cw + 1, bw + 1)
    taps = [(ky - 1) * bw + (kx - 1) for ky in range(3) for kx in range(3)]
    band = pix[..., None] + np.array(taps)
    by, bx = y0[..., None] - 1 + band // bw, x0[..., None] - 1 + band % bw
    return token, valid, band, by, bx, (r + 2) * bw, y, x


@pytest.mark.parametrize("C", KERNEL_C)
def test_tok_tile_covers_every_token_once(C):
    """For every view of 1..64 x 1..64 pixels: r cw <= 128, every token of
    every view is written by exactly one block, every tap of every token
    reads a pixel of its block's band that is the tap's neighbour, the band
    stays in bounds (pad rows too), and both kernels fit in shared memory."""
    for h in range(1, 65):
        for w in range(1, 65):
            r, cw = sb.tok_tile(h, w, C)
            assert 1 <= r <= h and 1 <= cw <= w and r * cw <= sb.TOK_M, (h, w, r, cw)
            assert max(sb.tok_smem(r, cw, C, 2 * C, True),
                       sb.tok_smem(r, cw, 2 * C, C, False)) <= sb.TOK_SMEM_MAX, (h, w)
            token, valid, band, by, bx, P, y, x = _kernel_indexing(h, w, r, cw)
            counts = np.bincount(token[valid], minlength=2 * h * w)
            assert counts.shape == (2 * h * w,) and (counts == 1).all(), (h, w, r, cw)
            assert band.min() >= 0 and band.max() < P, (h, w)
            dy = np.repeat([-1, 0, 1], 3)
            dx = np.tile([-1, 0, 1], 3)
            v = valid[..., None].repeat(9, -1)
            assert (by[v] == (y[..., None] + dy)[v]).all() and (bx[v] == (x[..., None] + dx)[v]).all()


def test_tok_tile_main_shapes():
    """The main path's 32 x 32 views take 8 x 16 pixels a block (full tiles,
    one image row an m16 fragment); the shapes only decide, repeatably."""
    assert sb.tok_tile(32, 32, 64) == (8, 16)
    assert sb.tok_tile(32, 32, 64) == sb.tok_tile(32, 32, 64)
    assert sb.tok_tile(64, 64, 64) == (8, 16)


def test_python_geometry_mirrors_the_source():
    """tok_smem's constants are tokenize.cuh's."""
    src = (CSRC / "tokenize.cuh").read_text()
    for name, value in (("TOK_M", sb.TOK_M), ("TOK_STAGES", sb.TOK_STAGES),
                        ("TOK_STAGE_FLOATS", sb.TOK_STAGE_FLOATS),
                        ("TOK_SMEM_MAX", sb.TOK_SMEM_MAX)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "LDA = CIN + 4" in src and "LDO = COUT + 8" in src


def test_tokenize_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers are their plain versions, bit for bit."""
    rng = np.random.RandomState(1)
    C, h, w = 16, 5, 6
    wts = sb._with_mlp(dict(wu=torch.from_numpy(rng.randn(9, C, 2 * C).astype(np.float32)),
                            ln=torch.from_numpy(rng.randn(4, 2 * C).astype(np.float32))))
    x = torch.from_numpy(rng.randn(2, h, w, C).astype(np.float32))
    pe_tok = torch.from_numpy(rng.randn(h, w, 2 * C).astype(np.float32))
    dtok = torch.from_numpy(rng.randn(2, h, w, 2 * C).astype(np.float32))
    for got, ref in zip(sb.tokenize_ln(x, pe_tok, wts), sb.tokenize_ln_plain(x, pe_tok, wts)):
        assert torch.equal(got, ref)
    assert torch.equal(sb.tokenize_bwd(dtok, wts), sb.tokenize_bwd_plain(dtok, wts))
