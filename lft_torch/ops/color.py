"""ITU-R BT.601 RGB <-> YCbCr with Matlab's coefficients (counterpart of
lft_tpu/ops/color.py; numpy arrays in [0, 1], channels last).

`ycbcr2rgb` is the reference's, verbatim: it subtracts the offsets after
the inverse product (reference utils/utils.py:171-183), which is not the
exact inverse of `rgb2ycbcr`. Only the data generator uses this module, and
only `rgb2ycbcr`.
"""

from __future__ import annotations

import numpy as np

_MAT = np.array(
    [[65.481, 128.553, 24.966],
     [-37.797, -74.203, 112.0],
     [112.0, -93.786, -18.214]], dtype=np.float64)
_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def rgb2ycbcr(x: np.ndarray) -> np.ndarray:
    """[..., 3] RGB in [0, 1] -> [..., 3] YCbCr in [0, 1], in `x.dtype`
    (reference utils/utils.py:160-168)."""
    mat = _MAT.T.astype(x.dtype)
    off = _OFFSET.astype(x.dtype)
    return (x @ mat + off) / x.dtype.type(255.0)


def ycbcr2rgb(x: np.ndarray) -> np.ndarray:
    """[..., 3] YCbCr in [0, 1] -> [..., 3] RGB, the reference's arithmetic
    (reference utils/utils.py:171-183)."""
    mat_inv = (np.linalg.inv(_MAT) * 255.0).T.astype(x.dtype)
    off = (_OFFSET / 255.0).astype(x.dtype)
    return x @ mat_inv - off
