"""The numerics and the split rules of the deterministic reductions
(`lft_torch/kernels/wgrad.py`, `lft_torch/csrc/wgrad.cu`), on the CPU.

The CUDA kernel cannot run here; its scheme can. `_wgrad_3xtf32` repeats
the kernel's arithmetic in plain PyTorch: every operand rounded into TF32
as `cvt.rna.tf32.f32` rounds (add 0x1000 to the bits, clear the low 13)
and the rest, a - hi, truncated as the MMA reads it, three products a_lo b_hi + a_hi b_lo +
a_hi b_hi per 8-token MMA step summed for each 32-token slab, the slabs'
sums added in f32 over each token slice (`splits`), and the slices'
partials added in the column-sum kernel's order (`colsum_cut`). The tensor
cores' own rounding inside an MMA is not modelled: f32 sums here. Against
float64 its error must be at most twice that of a plain f32 product: the
scheme keeps f32 accuracy, where one TF32 product would not. The kernel
itself is held to the same bound on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from lft_torch.kernels import wgrad
from lft_torch.ops.unfold import unfold3x3_linear


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as cvt.rna does: to nearest, ties away from zero."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(a: torch.Tensor) -> torch.Tensor:
    """What an MMA reads of an f32 operand: its top 19 bits."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(a: torch.Tensor):
    """The kernel's split: hi rounded (cvt.rna's rounding), lo = a - hi
    handed over as it is, so truncated by the MMA."""
    hi = _tf32(a)
    return hi, _trunc_tf32(a - hi)


def _colsum_order(a: torch.Tensor) -> torch.Tensor:
    """a.sum(0) in the column-sum kernel's order: the cluster's rank chunks
    in rank order, inside a chunk G row groups (rows in series), joined by
    a halving tree."""
    R = a.shape[0]
    lanes, size = wgrad.colsum_cut(R, a.shape[1])
    G = wgrad.CS_THREADS // lanes
    total = None
    for c in range(size):
        r0, r1 = R * c // size, R * (c + 1) // size
        g = [torch.zeros_like(a[0]) for _ in range(G)]
        for r in range(r0, r1):
            g[(r - r0) % G] = g[(r - r0) % G] + a[r]
        half = G // 2
        while half >= 1:
            g[:half] = [g[i] + g[i + half] for i in range(half)]
            half //= 2
        total = g[0] if total is None else total + g[0]
    return total


def _wgrad_3xtf32(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """xᵀ dy in the kernel's arithmetic (see the module docstring)."""
    T, K = x.shape
    N = dy.shape[1]
    S = wgrad.splits(T, K, N)
    xh, xl = _split(x)
    yh, yl = _split(dy)
    parts = []
    for s in range(S):
        t0, t1 = T * s // S, T * (s + 1) // S
        acc = torch.zeros(K, N)
        for b in range(t0, t1, 32):             # a staged slab: its own sums
            slab = torch.zeros(K, N)
            for t in range(b, min(b + 32, t1), 8):
                e = min(t + 8, t1)
                slab = slab + xl[t:e].t() @ yh[t:e]
                slab = slab + xh[t:e].t() @ yl[t:e]
                slab = slab + xh[t:e].t() @ yh[t:e]
            acc = acc + slab
        parts.append(acc)
    return _colsum_order(torch.stack(parts).reshape(S, -1)).reshape(K, N)


def _spread(rng, shape):
    """Normal values scaled by 10^u, u uniform in [-3, 3]: six decades."""
    return (rng.randn(*shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)


@pytest.mark.parametrize("K,N,seed", [(64, 64, 0), (32, 128, 1), (128, 32, 2), (64, 64, 3)])
def test_3xtf32_scheme_keeps_f32_accuracy(K, N, seed):
    """At T = 4096 with operands over six decades, the scheme's max error
    against float64 is at most twice that of an f32 matmul; one TF32
    product (the scheme without its tails) misses that bound by far."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(_spread(rng, (4096, K)))
    dy = torch.from_numpy(_spread(rng, (4096, N)))
    exact = x.double().t() @ dy.double()
    err = lambda t: float((t.double() - exact).abs().max())
    e_f32 = err(x.t() @ dy)
    e_3x = err(_wgrad_3xtf32(x, dy))
    e_tf32 = err(_tf32(x).t() @ _tf32(dy))
    assert e_3x <= 2 * e_f32, (e_3x, e_f32)
    assert e_tf32 > 10 * e_f32, (e_tf32, e_f32)


def test_tf32_rounding_is_cvt_rna():
    """Ties round away from zero, in magnitude, for both signs; the low 13
    bits are cleared; hi + lo is within 2^-21 of the f32 value."""
    one_ulp = 2.0 ** -10
    a = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4, 3.0])
    assert _tf32(a).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0]
    v = torch.from_numpy(np.random.RandomState(5).randn(1000).astype(np.float32))
    hi, lo = _split(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi.double() + lo.double()) - v.double()).abs().div(v.double().abs()).max()) \
        <= 2.0 ** -21


# the fused train step's products (T, K, N, taps) and ragged ones
SHAPES = [(102400, 64, 128, 9), (102400, 128, 128, 1), (102400, 128, 256, 1),
          (102400, 256, 128, 1), (102400, 128, 64, 1), (102400, 64, 64, 1), (82944, 64, 64, 1),
          (3001, 100, 36, 1), (7, 4, 4, 1), (189, 16, 32, 9)]


@pytest.mark.parametrize("T,K,N,taps", SHAPES)
def test_wgrad_split_is_a_function_of_the_shapes(T, K, N, taps):
    """S slices of at least ROWS tokens (or one), about one block an SM,
    the same on every call; the partials' column-sum cut likewise."""
    S = wgrad.splits(T, K, N, taps)
    assert S == wgrad.splits(T, K, N, taps)
    assert 1 <= S <= max(1, -(-T // wgrad.ROWS))
    (tk, tn), fill = wgrad.tile(N, taps)
    tiles = -(-K // tk) * -(-N // tn)
    assert S == 1 or S * tiles <= fill + tiles
    assert S * tiles >= min(fill, -(-T // wgrad.ROWS) * tiles)
    lanes, size = wgrad.colsum_cut(S, taps * K * N)
    assert lanes in (32, 64) and 1 <= size <= wgrad.CS_MAX
    assert (lanes, size) == wgrad.colsum_cut(S, taps * K * N)


@pytest.mark.parametrize("R,N", [(1600, 256), (2048, 256), (1296, 256), (100, 131072), (7, 5)])
def test_colsum_cut_and_order(R, N):
    """The cut is a function of (R, N), gives at least two rows a thread,
    and the kernel's order of additions equals a.sum(0) within f32
    rounding."""
    lanes, size = wgrad.colsum_cut(R, N)
    assert lanes in (32, 64) and 1 <= size <= wgrad.CS_MAX
    assert (lanes, size) == wgrad.colsum_cut(R, N)
    assert size == 1 or R // size >= 2 * wgrad.CS_THREADS // lanes
    a = torch.from_numpy(np.random.RandomState(R).randn(R, min(N, 512)).astype(np.float32))
    exact = a.double().sum(0)
    err = float((_colsum_order(a).double() - exact).abs().max())
    assert err <= 4 * float((a.sum(0).double() - exact).abs().max()) + 1e-6


@pytest.mark.parametrize("image", [None, (9, 7), (4, 12)])
def test_wgrad_plain_is_the_weight_gradient(image):
    """The plain versions are the functions they stand for: xᵀ dy and
    a.sum(0), and with image= the gradient of the 3x3 tokenization's
    weight (`unfold3x3_linear`, tap-major [9, K, N])."""
    rng = np.random.RandomState(9)
    h, w = image or (5, 6)
    x = torch.from_numpy(rng.randn(3 * h * w, 8).astype(np.float32))
    dy = torch.from_numpy(rng.randn(3 * h * w, 12).astype(np.float32))
    assert torch.equal(wgrad.colsum(dy), dy.sum(0))
    if image is None:
        assert torch.equal(wgrad.wgrad(x, dy), x.t() @ dy)
        return
    mlp = torch.zeros(12, 8 * 9, requires_grad=True)     # MLP.weight [D, C*9]
    out = unfold3x3_linear(x.reshape(3, h, w, 8), mlp)
    (out.reshape(-1, 12) * dy).sum().backward()
    ref = mlp.grad.reshape(12, 8, 9).permute(2, 1, 0)     # c*9 + tap -> [9, C, D]
    torch.testing.assert_close(wgrad.wgrad(x, dy, image), ref, atol=1e-4, rtol=1e-5)
