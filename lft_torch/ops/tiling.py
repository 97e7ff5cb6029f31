"""Full-scene patch tiling: LFdivide / LFintegrate
(counterpart of lft_tpu/ops/tiling.py).

`lf_divide` mirror-pads every view by the halo `bdr = (patch - stride)//2`
(the reference's ImageExtend, utils/utils.py:126-138), zero-extends to the
window-covering extent `hE/wE`, and gathers all patches at once.
`lf_integrate` crops the central `stride` block of every SR patch and
reassembles them by reshape. Both are index arithmetic on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def tiling_grid(h0: int, w0: int, patch_size: int, stride: int) -> dict:
    """Tiling geometry (reference utils/utils.py:93-107):
    dict(bdr, h, w, numU, numV, hE, wE)."""
    bdr = (patch_size - stride) // 2
    h = h0 + 2 * bdr
    w = w0 + 2 * bdr
    numU = (h - patch_size) // stride + (2 if (h - patch_size) % stride else 1)
    numV = (w - patch_size) // stride + (2 if (w - patch_size) % stride else 1)
    hE = stride * (numU - 1) + patch_size
    wE = stride * (numV - 1) + patch_size
    return dict(bdr=bdr, h=h, w=w, numU=numU, numV=numV, hE=hE, wE=wE)


def _symmetric_index(n: int, bdr: int, total: int) -> np.ndarray:
    """Source index of each of `total` positions of a length-n axis padded
    symmetrically by `bdr` and then zero-extended; `n` marks a zero."""
    idx = np.pad(np.arange(n), (bdr, bdr), mode="symmetric")
    return np.concatenate([idx, np.full(total - idx.size, n)])


def image_extend(im: torch.Tensor, bdr: int) -> torch.Tensor:
    """Mirror-with-edge padding by `bdr` of the trailing two dims of
    [..., h, w] (requires bdr <= min(h, w))."""
    if bdr == 0:
        return im
    h, w = im.shape[-2:]
    iy = torch.from_numpy(np.pad(np.arange(h), bdr, mode="symmetric")).to(im.device)
    ix = torch.from_numpy(np.pad(np.arange(w), bdr, mode="symmetric")).to(im.device)
    return im.index_select(-2, iy).index_select(-1, ix)


def lf_divide(mosaic: torch.Tensor, ang_res: int, patch_size: int,
              stride: int) -> torch.Tensor:
    """[A*h0, A*w0] SAI mosaic -> [numU, numV, A*patch, A*patch] patch
    mosaics (reference LFdivide, utils/utils.py:91-123)."""
    H, W = mosaic.shape
    a = ang_res
    h0, w0 = H // a, W // a
    g = tiling_grid(h0, w0, patch_size, stride)
    numU, numV = g["numU"], g["numV"]
    views = mosaic.reshape(a, h0, a, w0).permute(0, 2, 1, 3)        # [a, a, h0, w0]
    views = torch.nn.functional.pad(views, (0, 1, 0, 1))           # zero row/col at h0/w0
    src_u = _symmetric_index(h0, g["bdr"], g["hE"])
    src_v = _symmetric_index(w0, g["bdr"], g["wE"])
    win_u = (np.arange(numU)[:, None] * stride + np.arange(patch_size)[None, :]).reshape(-1)
    win_v = (np.arange(numV)[:, None] * stride + np.arange(patch_size)[None, :]).reshape(-1)
    iu = torch.from_numpy(src_u[win_u]).to(mosaic.device)
    iv = torch.from_numpy(src_v[win_v]).to(mosaic.device)
    t = views.index_select(2, iu).index_select(3, iv)              # [a, a, numU*p, numV*p]
    t = t.reshape(a, a, numU, patch_size, numV, patch_size)
    t = t.permute(2, 4, 0, 3, 1, 5)                                # [numU, numV, a, p, a, p]
    return t.reshape(numU, numV, a * patch_size, a * patch_size)


def lf_integrate(patches: torch.Tensor, ang_res: int, patch_size: int,
                 stride: int, h0: int, w0: int) -> torch.Tensor:
    """[numU, numV, A*patch, A*patch] SR patches -> per-view output
    [A, A, h0, w0] (reference LFintegrate, utils/utils.py:141-157); the SR
    scale is already applied to patch_size/stride/h0/w0."""
    numU, numV, PH, PW = patches.shape
    a = ang_res
    bdr = (patch_size - stride) // 2
    p = PH // a
    v = patches.reshape(numU, numV, a, p, a, p)
    c = v[:, :, :, bdr:bdr + stride, :, bdr:bdr + stride]
    c = c.permute(2, 4, 0, 3, 1, 5)                                # [a, a, numU, s, numV, s]
    c = c.reshape(a, a, numU * stride, numV * stride)
    return c[:, :, :h0, :w0]


def views_4d_to_mosaic(views: torch.Tensor) -> torch.Tensor:
    """[A, A, h, w] -> [A*h, A*w] SAI mosaic."""
    a1, a2, h, w = views.shape
    return views.permute(0, 2, 1, 3).reshape(a1 * h, a2 * w)
