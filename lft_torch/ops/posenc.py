"""Sinusoidal position encodings (numpy copy of lft_tpu/ops/posenc.py).

The reference's quirks (model/LFT.py:86-115) are kept: frequency grid
`T ** (2*floor(i/2)/D)`, the per-position vector is the CONCATENATION of
the even-index sines and the odd-index cosines, and several encoded dims
are averaged.
"""

from __future__ import annotations

import numpy as np


def position_encoding_1d(length: int, token_dim: int,
                         temperature: float = 10000.0) -> np.ndarray:
    """[length, token_dim] float32 encoding of one dimension."""
    i = np.arange(token_dim, dtype=np.float32)
    grid_dim = 2.0 * np.floor(i / 2.0) / float(token_dim)
    grid_dim = np.asarray(temperature, dtype=np.float32) ** grid_dim
    pos = np.arange(length, dtype=np.float32)[:, None] / grid_dim[None, :]
    out = np.concatenate([np.sin(pos[:, 0::2]), np.cos(pos[:, 1::2])], axis=1)
    return out.astype(np.float32)


def spatial_position(h: int, w: int, token_dim: int,
                     temperature: float = 10000.0) -> np.ndarray:
    """[h, w, token_dim]: the mean of the h- and w-dim encodings."""
    ph = position_encoding_1d(h, token_dim, temperature)
    pw = position_encoding_1d(w, token_dim, temperature)
    return ((ph[:, None, :] + pw[None, :, :]) / 2.0).astype(np.float32)


def angular_position(num_views: int, token_dim: int,
                     temperature: float = 10000.0) -> np.ndarray:
    """[num_views, token_dim]: one-dim encoding over the A^2 view axis."""
    return position_encoding_1d(num_views, token_dim, temperature)
