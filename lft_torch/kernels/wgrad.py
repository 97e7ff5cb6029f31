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

On a CPU tensor each takes its plain version; the `*_plain` functions run
anywhere.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lft_torch.kernels import _build

_TILE = 64         # output tile edge of the first pass
_ROWS = 256        # least token rows per partial


def _splits(T: int, tiles: int, sms: int = 132) -> int:
    """Partial sums per output tile: about two blocks per SM in all, each
    over at least _ROWS tokens. A function of the shapes only, so the
    order of every sum is fixed."""
    return max(1, min(-(-T // _ROWS), -(-2 * sms // tiles)))


def _shifted(x_img: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    h, w = x_img.shape[1:3]
    return F.pad(x_img, (0, 0, 1, 1, 1, 1))[:, ky:ky + h, kx:kx + w]


def wgrad_plain(x: torch.Tensor, dy: torch.Tensor, image=None) -> torch.Tensor:
    """Plain version of `wgrad`."""
    if image is None:
        return x.t() @ dy
    h, w = image
    xi = x.reshape(-1, h, w, x.shape[-1])
    return torch.stack([_shifted(xi, t // 3, t % 3).reshape(x.shape).t() @ dy
                        for t in range(9)])


def colsum_plain(a: torch.Tensor) -> torch.Tensor:
    return a.sum(0)


def wgrad(x: torch.Tensor, dy: torch.Tensor, image=None) -> torch.Tensor:
    """xᵀ·dy over the token axis (see the module docstring): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type != "cuda":
        return wgrad_plain(x, dy, image)
    (T, K), N = x.shape, dy.shape[1]
    if dy.shape[0] != T or K % 4 or N % 4:
        raise ValueError(f"wgrad: x {tuple(x.shape)} and dy {tuple(dy.shape)}")
    taps, (h, w) = (1, (0, 0)) if image is None else (9, image)
    if taps == 9 and T % (h * w):
        raise ValueError(f"wgrad: {T} tokens are not whole {h}x{w} images")
    _build.check_cuda_args("wgrad", x, dy)
    tiles = taps * (-(-K // _TILE)) * (-(-N // _TILE))
    S = _splits(T, tiles)
    part = torch.empty(S, taps, K, N, device=x.device)
    out = torch.empty(taps, K, N, device=x.device)
    fn = _build.bind("wgrad", "lft_wgrad", 4, (ctypes.c_int,) * 6)
    _build.launch("wgrad", "wgrad", fn, x.device, x.data_ptr(), dy.data_ptr(),
                  part.data_ptr(), out.data_ptr(), T, K, N, S, h, w)
    return out[0] if image is None else out


def colsum(a: torch.Tensor) -> torch.Tensor:
    """a.sum(0) of a [R, N] tensor, rows added in order: the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if a.device.type != "cuda":
        return colsum_plain(a)
    R, N = a.shape
    _build.check_cuda_args("colsum", a)
    out = torch.empty(N, device=a.device)
    fn = _build.bind("wgrad", "lft_colsum", 2, (ctypes.c_int,) * 2)
    _build.launch("wgrad", "colsum", fn, a.device, a.data_ptr(), out.data_ptr(), R, N)
    return out
