"""Bicubic resampling as separable resize matrices
(counterpart of lft_tpu/ops/bicubic.py; the numpy builders are copies).

Two variants, not interchangeable:

* torch-style (`F.interpolate(mode='bicubic', align_corners=False)`, the
  reference's per-view skip, model/LFT.py:261): a = -0.75, half-pixel
  centres, border replicate, no antialiasing;
* Matlab-style `imresize`: a = -0.5, antialiasing when downscaling,
  symmetric boundary, renormalised taps. Used only to make LR inputs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    f = ((a + 2.0) * absx3 - (a + 3.0) * absx2 + 1.0) * (absx <= 1.0)
    f = f + (a * absx3 - 5.0 * a * absx2 + 8.0 * a * absx - 4.0 * a) \
        * ((absx > 1.0) & (absx <= 2.0))
    return f


@functools.lru_cache(maxsize=None)
def resize_matrix_torch(in_len: int, out_len: int) -> np.ndarray:
    """[out_len, in_len] float32 matrix of `F.interpolate(bicubic,
    align_corners=False)` along one dim."""
    scale = out_len / in_len
    a = -0.75
    W = np.zeros((out_len, in_len), dtype=np.float64)
    for i in range(out_len):
        src = (i + 0.5) / scale - 0.5
        i0 = math.floor(src)
        for k in range(-1, 3):
            idx = i0 + k
            w = _cubic_kernel(np.array(src - idx), a)
            idx = min(max(idx, 0), in_len - 1)
            W[i, idx] += float(w)
    return W.astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_matrix_matlab(in_len: int, out_len: int) -> np.ndarray:
    """[out_len, in_len] float32 matrix of Matlab `imresize` (bicubic)
    along one dim (reference utils/imresize.py:32-52)."""
    scale = out_len / in_len
    base = functools.partial(_cubic_kernel, a=-0.5)
    if scale < 1.0:
        kernel_fn = lambda x: scale * base(scale * np.asarray(x, dtype=np.float64))
        kernel_width = 4.0 / scale
    else:
        kernel_fn = lambda x: base(np.asarray(x, dtype=np.float64))
        kernel_width = 4.0
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    P = int(math.ceil(kernel_width)) + 2
    indices = (left[:, None] + np.arange(P)[None, :] - 1.0).astype(np.int64)
    weights = kernel_fn(u[:, None] - indices - 1.0)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    aux = np.concatenate([np.arange(in_len),
                          np.arange(in_len - 1, -1, -1)]).astype(np.int64)
    indices = aux[np.mod(indices, aux.size)]
    W = np.zeros((out_len, in_len), dtype=np.float64)
    for i in range(out_len):
        np.add.at(W[i], indices[i], weights[i])
    return W.astype(np.float32)


def imresize(img, scalar_scale=None, output_shape=None) -> np.ndarray:
    """Matlab-bicubic `imresize` of an [H, W] or [H, W, C] numpy array
    (float64 arithmetic, numpy in / numpy out)."""
    img = np.asarray(img)
    if scalar_scale is not None:
        out_h = int(math.ceil(scalar_scale * img.shape[0]))
        out_w = int(math.ceil(scalar_scale * img.shape[1]))
    elif output_shape is not None:
        out_h, out_w = int(output_shape[0]), int(output_shape[1])
    else:
        raise ValueError("scalar_scale OR output_shape must be given")
    Wh = resize_matrix_matlab(img.shape[0], out_h).astype(np.float64)
    Ww = resize_matrix_matlab(img.shape[1], out_w).astype(np.float64)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    out = np.einsum("ph,hwc->pwc", Wh, img.astype(np.float64))
    out = np.einsum("qw,pwc->pqc", Ww, out)
    return out[:, :, 0] if squeeze else out


def bicubic_upscale_views(mosaic: torch.Tensor, ang_res: int,
                          scale: int) -> torch.Tensor:
    """Per-view torch-bicubic x`scale` upscale of `[..., A*h, A*w]` SAI
    mosaics, always in float32 (lft_tpu/models/lft.py:304)."""
    *lead, H, W = mosaic.shape
    a = ang_res
    h, w = H // a, W // a
    dev = mosaic.device
    Wh = torch.from_numpy(resize_matrix_torch(h, h * scale)).to(dev)
    Ww = torch.from_numpy(resize_matrix_torch(w, w * scale)).to(dev)
    v = mosaic.float().reshape(*lead, a, h, a, w).movedim(-2, -3)   # [..., a, a, h, w]
    v = Wh @ v @ Ww.T
    v = v.movedim(-3, -2)                                          # [..., a, hS, a, wS]
    return v.reshape(*lead, H * scale, W * scale)
