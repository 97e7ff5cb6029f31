"""Deterministic reductions over the token axis for the block backwards
(`lft_torch/csrc/wgrad.cu`).

Every weight gradient of K3 and K4 is Xᵀ·dY over a long token axis (T =
102,400 tokens at the training shape), and every LayerNorm affine grad and
the spatial PE's gradient is a column sum. The TPU backwards accumulated
them in constant-index output blocks across a sequential grid
(lft_tpu/kernels/ang_block.py:280-288, :396-402; spa_block.py:402-415,
:570-578); CUDA blocks run in no fixed order, so here each block writes a
partial sum over its slice of the token axis and a second pass adds the
partials in a fixed order. No atomics: a step is bitwise repeatable.

  wgrad(x [T, K], dy [T, N])            -> xᵀ dy [K, N]
  wgrad(x, dy, image=(h, w))            -> [9, K, N], tap t = (ky, kx):
      x shifted by (ky-1, kx-1) inside each h x w image, zero outside
      (the weight grad of the 3x3 tokenization, dwu)
  colsum(a [R, N])                      -> a.sum(0) [N]

The products run on the tensor cores as 3xTF32 (each f32 operand split
into two TF32 parts, three products accumulated in f32: f32 accuracy; see
the source). With `half=True` (`--dtype mixed`'s backward at a site that
rounds: lft_tpu's weight grads over bf16 operands) both operands are
rounded to bf16 and the product is one TF32 pass, accumulated in f32 in
the same order, counted as `wgrad_bf16`. A bf16 x (`--dtype bfloat16`
training: lft_tpu's weight grads over its bf16 operands) launches
`wgrad_bf16io`: x and dy bf16 in memory, or dy f32 (K3's and K4's dx2)
rounded to bf16 as it is loaded, bf16 products with f32 sums over the
slices of `bf16io_cut`, whose clusters of Z blocks add their partials in
shared memory before the column sum; an f32 result. On a CPU tensor each
takes its plain version; the `*_plain` functions run anywhere.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lft_torch.kernels import _build
from lft_torch.kernels.common import bf16_round

SMS = 132              # streaming multiprocessors of an H100
ROWS = 256             # least token rows of a slice
# (K, N) output tile of a block of the product and the blocks wanted: 8 warps
# over 128 x 128, one block an SM; for N <= 64, 2 warps over 64 x 64, two an
# SM; with image=, one warp a tap over 64 x 32, one an SM
TILE, SMALL_TILE, TAP_TILE = (128, 128), (64, 64), (64, 32)
# colsum: a block of 512 threads is `lanes` column lanes (a float4 each where
# N % 4 == 0) x 512 / lanes row groups; a cluster of at most 8 blocks (the
# portable maximum) splits the rows
CS_THREADS, CS_MAX = 512, 8
CS_FILL = 2 * SMS      # blocks wanted in flight
# wgrad_bf16io: tokens of a stage (one chain of 4 k16 MMAs), stages of its
# ring, blocks of a cluster that add their slices' partials in shared memory
# (pairs: at one block an SM an H100 holds 66 clusters of 2 at once, but
# only 30 of 4 or 15 of 8, 120 SMs, and a second wave of clusters doubled
# the time) and the most the kernels take (the portable maximum)
BIO_BT, BIO_STAGES, BIO_CLUSTER, BIO_CL_MAX = 64, 4, 2, 8


def tile(N: int, taps: int = 1):
    """((K, N) tile, blocks wanted) of the kernel that takes the product."""
    if taps == 9:
        return TAP_TILE, SMS
    return (TILE, SMS) if N > 64 else (SMALL_TILE, 2 * SMS)


def splits(T: int, K: int, N: int, taps: int = 1) -> int:
    """Token-axis slices S of a product: about the blocks wanted in all
    (`tile`), each slice of at least ROWS tokens. A function of the shapes
    only, so the order of every sum is fixed."""
    (tk, tn), fill = tile(N, taps)
    tiles = -(-K // tk) * -(-N // tn)
    return max(1, min(-(-T // ROWS), -(-fill // tiles)))


def bf16io_cut(T: int, K: int, N: int, taps: int = 1):
    """(S, Z) of a `wgrad_bf16io` product: S slices, `splits`' count cut
    down to a multiple of Z, in clusters of Z <= BIO_CLUSTER blocks that add
    their partials in rank order; S / Z partials go to the column sum (none
    where S = Z). A function of the shapes only, so the order of every sum
    is fixed."""
    s = splits(T, K, N, taps)
    z = min(BIO_CLUSTER, s)
    return s // z * z, z


def bf16io_smem(N: int, taps: int = 1, f32_dy: bool = False) -> int:
    """Shared memory of a `wgrad_bf16io` block (BioTile / BioTaps in the
    source): the ring of BIO_STAGES stages (X rows padded by 8 bf16 values,
    dY by 8 bf16 or 4 f32 ones; with taps three row bands of BIO_BT + 2
    tokens and a mask a token), or the block's f32 partial [rows][cols + 8]
    where that is larger; with taps a zero row of 64 bf16 values after
    them."""
    ye = 4 if f32_dy else 2
    if taps == 9:
        wn = TAP_TILE[1]
        stage = 3 * (BIO_BT + 2) * (64 + 8) * 2 + BIO_BT * (wn + (4 if f32_dy else 8)) * ye \
            + BIO_BT * 4
        return max(BIO_STAGES * stage, 9 * 64 * (wn + 8) * 4) + 64 * 2
    bm, bn = tile(N)[0]
    stage = BIO_BT * (bm + 8) * 2 + BIO_BT * (bn + (4 if f32_dy else 8)) * ye
    return max(BIO_STAGES * stage, bm * (bn + 8) * 4)


def colsum_cut(R: int, N: int):
    """(lanes, size) of a column sum of R rows and N columns: 32 column lanes
    a block (16 row groups) where the columns fill at most 64 lanes, else 64
    (8 row groups); clusters of `size` blocks that cut the rows into
    contiguous chunks, added in rank order: about CS_FILL blocks in all, at
    most CS_MAX, at least two rows a thread. A function of (R, N) only, so
    the order of every sum is fixed."""
    width = 4 if N % 4 == 0 else 1
    lanes = 32 if -(-N // width) <= 64 else 64
    col_blocks = -(-N // (lanes * width))
    size = max(1, min(-(-CS_FILL // col_blocks), CS_MAX, R // (2 * CS_THREADS // lanes)))
    return lanes, size


def _shifted(x_img: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    h, w = x_img.shape[1:3]
    return F.pad(x_img, (0, 0, 1, 1, 1, 1))[:, ky:ky + h, kx:kx + w]


def wgrad_plain(x: torch.Tensor, dy: torch.Tensor, image=None, half: bool = False) -> torch.Tensor:
    """Plain version of `wgrad`: f32 sums, over bf16 values where `half`;
    a bf16 x (`wgrad_bf16io`): its products with bf16(dy) summed in float64
    and rounded to f32 once (as the other bf16-IO backwards' plain versions
    sum, kernels/ang_block.py:_ang_bwd_bf16io_plain)."""
    bio = x.dtype == torch.bfloat16
    if bio:
        x, dy = x.double(), bf16_round(dy.double())
    if half:
        x, dy = bf16_round(x), bf16_round(dy)
    if image is None:
        out = x.t() @ dy
    else:
        h, w = image
        xi = x.reshape(-1, h, w, x.shape[-1])
        out = torch.stack([_shifted(xi, t // 3, t % 3).reshape(x.shape).t() @ dy
                           for t in range(9)])
    return out.float() if bio else out


def colsum_plain(a: torch.Tensor) -> torch.Tensor:
    return a.sum(0)


def wgrad(x: torch.Tensor, dy: torch.Tensor, image=None, half: bool = False) -> torch.Tensor:
    """xᵀ·dy over the token axis (see the module docstring): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. half: over bf16
    operands (`wgrad_bf16`); a bf16 x: `wgrad_bf16io` (dy bf16 or f32)."""
    if x.device.type != "cuda":
        return wgrad_plain(x, dy, image, half)
    (T, K), N = x.shape, dy.shape[1]
    if dy.shape[0] != T or K % 4 or N % 4:
        raise ValueError(f"wgrad: x {tuple(x.shape)} and dy {tuple(dy.shape)}")
    taps, (h, w) = (1, (0, 0)) if image is None else (9, image)
    if taps == 9 and T % (h * w):
        raise ValueError(f"wgrad: {T} tokens are not whole {h}x{w} images")
    bio = x.dtype == torch.bfloat16
    name = "wgrad_bf16io" if bio else "wgrad_bf16" if half else "wgrad"
    if bio:
        _build.check_cuda_args(name, x, dtype=torch.bfloat16)
        _build.check_cuda_args(name, dy, dtype=dy.dtype if dy.dtype == torch.bfloat16
                               else torch.float32)
    else:
        _build.check_cuda_args(name, x, dy)
    out = torch.empty(taps, K, N, device=x.device)
    if bio:
        if K % 8 or N % 8:
            raise ValueError(f"{name}: K {K} and N {N} must be multiples of 8")
        S, Z = bf16io_cut(T, K, N, taps)
        groups = S // Z
        part = torch.empty(groups, taps, K, N, device=x.device) if groups > 1 else out
        fn_name = "lft_" + name + ("_f32dy" if dy.dtype == torch.float32 else "")
        fn = _build.bind("wgrad", fn_name, 4, (ctypes.c_int,) * 9)
        _build.launch("wgrad", name, fn, x.device, x.data_ptr(), dy.data_ptr(),
                      part.data_ptr(), out.data_ptr(), T, K, N, S, Z,
                      *colsum_cut(groups, taps * K * N), h, w)
        return out[0] if image is None else out
    S = splits(T, K, N, taps)
    part = torch.empty(S, taps, K, N, device=x.device) if S > 1 else out
    fn = _build.bind("wgrad", "lft_" + name, 4, (ctypes.c_int,) * 8)
    _build.launch("wgrad", name, fn, x.device, x.data_ptr(), dy.data_ptr(),
                  part.data_ptr(), out.data_ptr(), T, K, N, S,
                  *colsum_cut(S, taps * K * N), h, w)
    return out[0] if image is None else out


def colsum(a: torch.Tensor) -> torch.Tensor:
    """a.sum(0) of a [R, N] tensor in a fixed order: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if a.device.type != "cuda":
        return colsum_plain(a)
    R, N = a.shape
    _build.check_cuda_args("colsum", a)
    out = torch.empty(N, device=a.device)
    fn = _build.bind("wgrad", "lft_colsum", 2, (ctypes.c_int,) * 4)
    _build.launch("wgrad", "colsum", fn, a.device, a.data_ptr(), out.data_ptr(), R, N,
                  *colsum_cut(R, N))
    return out
