"""Synthetic light-field scenes (numpy, seeded; counterpart of
lft_tpu/data/synth.py): the scene generator, LR/HR pairs of its scenes,
`.mat` scene files and a ready-made `data_for_train/` + `data_for_test/`
h5 tree, so every stage runs with no outside data.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from lft_torch.data.generate import _downscale_views, _lf_to_y, _mosaic, _write_h5
from lft_torch.ops.bicubic import imresize
from lft_torch.ops.color import _MAT, _OFFSET


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


def write_synth_scene_mat(path: str, ang_res: int = 9, height: int = 128,
                          width: int = 128, seed: int = 0,
                          fmt: str = "v73", lf: np.ndarray = None) -> np.ndarray:
    """Write a .mat scene holding `LF[U, V, H, W, 3]` and return the array:
    `fmt='v73'` as HDF5, axis-reversed like Matlab's column-major writes;
    `fmt='classic'` as a v5 .mat through scipy. `data.generate.load_mat_lf`
    reads both."""
    if lf is None:
        lf = synth_lf_scene(ang_res, height, width, seed=seed)
    if fmt == "v73":
        import h5py
        with h5py.File(path, "w") as f:
            f.create_dataset("LF", data=np.transpose(lf, (4, 3, 2, 1, 0)))
    elif fmt == "classic":
        import scipy.io as sio
        sio.savemat(path, {"LF": lf})
    else:
        raise ValueError(f"unknown .mat fmt {fmt!r}")
    return lf


def make_synth_data(root: str, ang_res: int = 5, scale: int = 2, n_train: int = 8,
                    n_test: int = 2, train_patch: int = 32, test_hw: int = 64,
                    dataset_name: str = "SynthLF", seed: int = 0) -> dict:
    """Write `<root>/data_for_train/SR_{A}x{A}_{S}x/<dataset_name>/NNNNNN.h5`
    (`n_train` patches of `train_patch`^2 LR views) and
    `<root>/data_for_test/.../scene_NN.h5` (`n_test` scenes of `test_hw`^2
    LR views) in the generators' h5 layout. Returns the paths as the
    `path_for_train`, `path_for_test` and `data_name` flags."""
    train_dir = Path(root) / "data_for_train" / f"SR_{ang_res}x{ang_res}_{scale}x" / dataset_name
    test_dir = Path(root) / "data_for_test" / f"SR_{ang_res}x{ang_res}_{scale}x" / dataset_name
    train_dir.mkdir(parents=True, exist_ok=True)
    test_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n_train):
        hw = train_patch * scale
        y = _lf_to_y(synth_lf_scene(ang_res, hw, hw, seed=seed + i))
        _write_h5(str(train_dir / f"{i + 1:06d}.h5"), _mosaic(_downscale_views(y, scale)),
                  _mosaic(y))
    for i in range(n_test):
        hw = test_hw * scale
        y = _lf_to_y(synth_lf_scene(ang_res, hw, hw, seed=seed + 1000 + i))
        _write_h5(str(test_dir / f"scene_{i:02d}.h5"), _mosaic(_downscale_views(y, scale)),
                  _mosaic(y))
    return {"path_for_train": str(Path(root) / "data_for_train") + os.sep,
            "path_for_test": str(Path(root) / "data_for_test") + os.sep,
            "data_name": dataset_name}
