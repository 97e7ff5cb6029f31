"""PSNR / SSIM on the device, skimage semantics
(counterpart of lft_tpu/ops/metrics.py).

* PSNR: `data_range` 1.0 when the reference image is non-negative, else
  2.0 (skimage's float inference).
* SSIM: skimage `structural_similarity(gaussian_weights=True)` with its
  float `data_range` of 2.0: gaussian sigma 1.5, truncate 3.5 (11x11),
  sample covariance NP/(NP-1), symmetric boundary, K1 0.01, K2 0.03, mean
  over the image cropped by (win-1)//2.
* `cal_metrics`: per-view metrics averaged with the reference's
  positive-mask mean (utils/utils.py:85-86), from 2-D to 5-D inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def psnr(ref: torch.Tensor, test: torch.Tensor, data_range=None) -> torch.Tensor:
    """PSNR over the trailing two dims of [..., H, W] (one value per
    leading index)."""
    ref = ref.float()
    test = test.float()
    if data_range is None:
        mins = ref.amin(dim=(-2, -1))
        dr = torch.where(mins >= 0, 1.0, 2.0)
    else:
        dr = torch.full(ref.shape[:-2], float(data_range), device=ref.device)
    mse = ((ref - test) ** 2).mean(dim=(-2, -1))
    return 10.0 * torch.log10(dr * dr / mse)


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(sigma: float = 1.5, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * x * x / (sigma * sigma))
    return (phi / phi.sum()).astype(np.float32)


def _gaussian_filter2d(img: torch.Tensor, sigma: float, truncate: float):
    """Separable gaussian filter of [N, H, W], symmetric boundary. The two
    convolutions run in full f32 whatever the process's TF32 flag says, as
    lft_tpu's run at HIGHEST precision (lft_tpu/ops/metrics.py:88-94): SSIM's
    variance terms (uxx - ux^2) cancel almost completely, so a TF32 filter
    moves SSIM itself. The flag is restored afterwards."""
    k = torch.from_numpy(_gaussian_kernel1d(sigma, truncate)).to(img.device)
    r = (k.numel() - 1) // 2
    N, H, W = img.shape
    iy = torch.from_numpy(np.pad(np.arange(H), r, mode="symmetric")).to(img.device)
    ix = torch.from_numpy(np.pad(np.arange(W), r, mode="symmetric")).to(img.device)
    x = img.index_select(1, iy).index_select(2, ix)               # [N, H+2r, W+2r]
    kk = k.reshape(1, 1, -1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        # rows: correlate along H
        x = F.conv1d(x.transpose(1, 2).reshape(-1, 1, H + 2 * r), kk)
        x = x.reshape(N, W + 2 * r, H).transpose(1, 2)             # [N, H, W+2r]
        x = F.conv1d(x.reshape(-1, 1, W + 2 * r), kk)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return x.reshape(N, H, W)


def ssim(ref: torch.Tensor, test: torch.Tensor, data_range=None,
         sigma: float = 1.5, truncate: float = 3.5, K1: float = 0.01,
         K2: float = 0.03) -> torch.Tensor:
    """SSIM of [N, H, W] image pairs -> [N]."""
    ref = ref.float()
    test = test.float()
    dr = 2.0 if data_range is None else float(data_range)
    radius = int(truncate * sigma + 0.5)
    win = 2 * radius + 1
    NP = win * win
    cov_norm = NP / (NP - 1.0)
    filt = lambda t: _gaussian_filter2d(t, sigma, truncate)
    ux, uy = filt(ref), filt(test)
    uxx, uyy, uxy = filt(ref * ref), filt(test * test), filt(ref * test)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * dr) ** 2
    C2 = (K2 * dr) ** 2
    S = ((2.0 * ux * uy + C1) * (2.0 * vxy + C2)) \
        / ((ux * ux + uy * uy + C1) * (vx + vy + C2))
    pad = (win - 1) // 2
    return S[..., pad:-pad, pad:-pad].mean(dim=(-2, -1))


def _view_stack(label: torch.Tensor, out: torch.Tensor, a: int):
    """-> per-view stacks [N, h, w], one pair per (batch, u, v), from every
    form lft_tpu's cal_metrics takes (lft_tpu/ops/metrics.py:154-179): a
    [A*h, A*w] mosaic, [B, A*h, A*w] mosaics, a [B, C, H, W] batch (channel
    0; square, as the reference's view() assumes) or a [C, U, V, h, w]
    per-view tensor (channel 0)."""
    if label.ndim == 2:
        label, out = label[None], out[None]
    if label.ndim == 4:
        if label.shape[-2] != label.shape[-1]:
            raise ValueError(
                "4-D cal_metrics input must be square (the reference's "
                f"view() assumes H == W); got {tuple(label.shape)}")
        label, out = label[:, 0], out[:, 0]
    if label.ndim == 5:
        lv, ov = label[0], out[0]
        U, V, h, w = lv.shape
        return lv.reshape(U * V, h, w), ov.reshape(U * V, h, w)
    B, H, W = label.shape
    h, w = H // a, W // a
    split = lambda m: m.reshape(B, a, h, a, w).permute(0, 1, 3, 2, 4).reshape(B * a * a, h, w)
    return split(label), split(out)


def cal_metrics(label: torch.Tensor, out: torch.Tensor, ang_res: int,
                psnr_data_range=None, ssim_data_range=None):
    """Per-view PSNR/SSIM of SAI mosaics, averaged over views with the
    reference's positive-mask mean. Returns (psnr, ssim) 0-d tensors."""
    lv, ov = _view_stack(label, out, ang_res)
    p = psnr(lv, ov, psnr_data_range)
    s = ssim(lv, ov, ssim_data_range)
    psnr_mean = p.sum() / (p > 0).sum().clamp(min=1)
    ssim_mean = s.sum() / (s > 0).sum().clamp(min=1)
    return psnr_mean, ssim_mean
