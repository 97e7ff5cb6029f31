"""Matlab-free data generation (counterpart of lft_tpu/data/generate.py,
numpy host code with the same arithmetic in the same order, so the files
equal the JAX package's).

The reference's two Matlab scripts (Generate_Data_for_Training.m,
Generate_Data_for_Test.m) in Python. The h5 files hold float32 `Lr_SAI_y`
and `Hr_SAI_y` in the column-major layout Matlab's h5write emits, so the
reference's loaders, which transpose (test) or do not (train), read them
as they read Matlab's (utils/utils_datasets.py:38-39, 87-90):

* the central `angRes x angRes` views: Matlab `0.5*(U-A+2) : 0.5*(U+A)`,
  1-based (Generate_Data_for_Training.m:38);
* Matlab `rgb2ycbcr` of each view on [0, 1] doubles, the Y channel;
* LR views by the Matlab-bicubic (a = -0.5, antialiased) downscale;
* training: HR patches of `factor * 32` at stride `patchsize / 2` over
  `1 : stride : H-patchsize+1`, one `%06d.h5` a patch;
* test: whole scenes with H, W floored to multiples of 4, one h5 a scene.

Scenes are `.mat` files holding a 5-D `LF[U, V, H, W, 3+]` (classic or
v7.3/HDF5); integer LFs are scaled to [0, 1] by their dtype's max. `h5py`
is imported by the functions that read or write HDF5, so the module
imports where it is missing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from lft_torch.ops.bicubic import resize_matrix_matlab
from lft_torch.ops.color import rgb2ycbcr


def load_mat_lf(path: str, var: str = "LF") -> np.ndarray:
    """The float64 `LF[U, V, H, W, C]` array of a .mat scene file. A v7.3
    file is HDF5 and stores Matlab's column-major array axis-reversed, so
    the axes are reversed back."""
    import h5py
    if h5py.is_hdf5(path):
        with h5py.File(path, "r") as f:
            lf = np.asarray(f[var])
            lf = np.transpose(lf, tuple(range(lf.ndim))[::-1])
    else:
        import scipy.io as sio
        lf = np.asarray(sio.loadmat(path)[var])
    if lf.ndim != 5:
        raise ValueError(f"{path}: expected 5-D LF array, got {lf.shape}")
    if np.issubdtype(lf.dtype, np.integer):
        lf = lf.astype(np.float64) / np.iinfo(lf.dtype).max
    else:
        lf = lf.astype(np.float64)
    return lf


def _central_views(lf: np.ndarray, ang_res: int) -> np.ndarray:
    """The central `ang_res x ang_res` views, RGB channels only."""
    U, V = lf.shape[:2]
    su, sv = (U - ang_res) // 2, (V - ang_res) // 2
    return lf[su:su + ang_res, sv:sv + ang_res, :, :, :3]


def _lf_to_y(lf: np.ndarray) -> np.ndarray:
    """[U, V, H, W, 3] RGB -> [U, V, H, W] Y (BT.601, [0, 1])."""
    return rgb2ycbcr(lf)[..., 0]


def _write_h5(path: str, lr: np.ndarray, hr: np.ndarray) -> None:
    """float32 datasets in Matlab h5write's column-major layout: h5py sees
    Matlab-written arrays transposed, so the transpose is stored."""
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset("Lr_SAI_y", data=lr.astype(np.float32).T)
        f.create_dataset("Hr_SAI_y", data=hr.astype(np.float32).T)


def _downscale_matlab(img: np.ndarray, factor: int) -> np.ndarray:
    """Antialiased Matlab-bicubic 1/factor downscale of [H, W] (float64)."""
    H, W = img.shape
    Wh = resize_matrix_matlab(H, H // factor).astype(np.float64)
    Ww = resize_matrix_matlab(W, W // factor).astype(np.float64)
    return Wh @ img @ Ww.T


def _mosaic(views_y: np.ndarray) -> np.ndarray:
    """[U, V, h, w] -> [U*h, V*w] SAI mosaic."""
    U, V, h, w = views_y.shape
    return views_y.transpose(0, 2, 1, 3).reshape(U * h, V * w)


def _downscale_views(y: np.ndarray, factor: int) -> np.ndarray:
    """[A, A, H, W] -> [A, A, H/factor, W/factor], view by view."""
    A = y.shape[0]
    return np.stack([np.stack([_downscale_matlab(y[u, v], factor) for v in range(A)])
                     for u in range(A)])


def list_scene_files(src_dir: str) -> list:
    return sorted(str(p) for p in Path(src_dir).iterdir() if p.suffix.lower() == ".mat")


def _dataset_names(src: Path, datasets: Optional[Iterable[str]]) -> list:
    return sorted(datasets) if datasets else sorted(p.name for p in src.iterdir() if p.is_dir())


def generate_training_data(src_data_path: str, save_root: str, ang_res: int = 5,
                           factor: int = 4, datasets: Optional[Iterable[str]] = None,
                           log=print) -> int:
    """Write `<save_root>/SR_{A}x{A}_{S}x/<dataset>/NNNNNN.h5` patch files
    from `<src>/<dataset>/training/*.mat` (reference
    Generate_Data_for_Training.m). Returns the number of patches."""
    patchsize = factor * 32
    stride = patchsize // 2
    src = Path(src_data_path)
    total = 0
    for name in _dataset_names(src, datasets):
        scene_dir = src / name / "training"
        if not scene_dir.is_dir():
            continue
        out_dir = Path(save_root) / f"SR_{ang_res}x{ang_res}_{factor}x" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        idx_save = 0
        for scene_path in list_scene_files(str(scene_dir)):
            y = _lf_to_y(_central_views(load_mat_lf(scene_path), ang_res))   # [A, A, H, W]
            _, _, H, W = y.shape
            n_scene = 0
            for h0 in range(0, H - patchsize + 1, stride):
                for w0 in range(0, W - patchsize + 1, stride):
                    hr_views = y[:, :, h0:h0 + patchsize, w0:w0 + patchsize]
                    idx_save += 1
                    n_scene += 1
                    _write_h5(str(out_dir / f"{idx_save:06d}.h5"),
                              _mosaic(_downscale_views(hr_views, factor)), _mosaic(hr_views))
            total += n_scene
            log(f"{name}/{Path(scene_path).stem}: {n_scene} training samples")
    return total


def generate_test_data(src_data_path: str, save_root: str, ang_res: int = 5,
                       factor: int = 4, datasets: Optional[Iterable[str]] = None,
                       log=print) -> int:
    """Write `<save_root>/SR_{A}x{A}_{S}x/<dataset>/<scene>.h5` whole-scene
    files from `<src>/<dataset>/test/*.mat` (reference
    Generate_Data_for_Test.m). Returns the number of scenes."""
    src = Path(src_data_path)
    total = 0
    for name in _dataset_names(src, datasets):
        scene_dir = src / name / "test"
        if not scene_dir.is_dir():
            continue
        out_dir = Path(save_root) / f"SR_{ang_res}x{ang_res}_{factor}x" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for scene_path in list_scene_files(str(scene_dir)):
            lf = load_mat_lf(scene_path)
            H, W = lf.shape[2] - lf.shape[2] % 4, lf.shape[3] - lf.shape[3] % 4
            y = _lf_to_y(_central_views(lf[:, :, :H, :W], ang_res))
            _write_h5(str(out_dir / f"{Path(scene_path).stem}.h5"),
                      _mosaic(_downscale_views(y, factor)), _mosaic(y))
            total += 1
            log(f"{name}/{Path(scene_path).stem}: 1 test sample")
    return total
