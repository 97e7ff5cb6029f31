"""Synthetic light-field scenes (numpy, seeded; the scene generator of
lft_tpu/data/synth.py) and the Y conversion that makes LR/HR pairs of them.
"""

from __future__ import annotations

import numpy as np

from lft_torch.ops.bicubic import imresize

# ITU-R BT.601, Matlab coefficients (reference utils/utils.py:160-168)
_MAT = np.array([[65.481, 128.553, 24.966],
                 [-37.797, -74.203, 112.0],
                 [112.0, -93.786, -18.214]], dtype=np.float64)
_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def synth_lf_scene(ang_res: int = 5, height: int = 128, width: int = 128,
                   disparity: float = 1.0, seed: int = 0) -> np.ndarray:
    """[A, A, H, W, 3] float64 light field in [0, 1]: a band-limited
    texture shifted per view by (u, v) * disparity."""
    rng = np.random.RandomState(seed)
    pad = int(abs(disparity) * ang_res) + 2
    base = rng.rand(height + 2 * pad, width + 2 * pad, 3)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 5.0
    base = (base - base.min()) / (base.max() - base.min() + 1e-9)
    c = (ang_res - 1) / 2.0
    views = np.empty((ang_res, ang_res, height, width, 3))
    yy = np.arange(height) + pad
    xx = np.arange(width) + pad
    for u in range(ang_res):
        for v in range(ang_res):
            y0 = yy + int(round((u - c) * disparity))
            x0 = xx + int(round((v - c) * disparity))
            views[u, v] = base[np.ix_(y0, x0)]
    return views


def rgb_to_y(x: np.ndarray) -> np.ndarray:
    """[..., 3] RGB in [0, 1] -> [...] Y in [0, 1]."""
    return (x @ _MAT[0] + _OFFSET[0]) / 255.0


def lr_hr_pair(lf: np.ndarray, scale: int):
    """[A, A, H, W, 3] light field -> (lr [A*H/s, A*W/s], hr [A*H, A*W])
    float32 Y mosaics, LR by Matlab-bicubic `imresize` of each view."""
    y = rgb_to_y(lf)
    A, _, H, W = y.shape
    lr = np.stack([np.stack([imresize(y[u, v], output_shape=(H // scale, W // scale))
                             for v in range(A)]) for u in range(A)])
    mosaic = lambda t: t.transpose(0, 2, 1, 3).reshape(A * t.shape[2], A * t.shape[3])
    return mosaic(lr).astype(np.float32), mosaic(y).astype(np.float32)
