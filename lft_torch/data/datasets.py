"""The h5 data sets, the reference's augmentation and batch iteration
(counterpart of lft_tpu/data/datasets.py, numpy only).

* `augmentation` is the reference's 3-op mosaic augmentation
  (utils/utils_datasets.py:114-124).
* `TrainDataset` scans `data_for_train/SR_{A}x{A}_{S}x/<dataset>/*.h5` and
  reads `Lr_SAI_y`/`Hr_SAI_y` without transposing, as the reference's train
  loader does (utils/utils_datasets.py:14-47).
* `TestDataset` / `multi_test_sets` read whole test scenes and transpose
  them (1, 0) to undo the Matlab layout (utils/utils_datasets.py:50-98).
* `h5py` is imported when a file is read (`multi_test_sets` checks for it
  first), so the module imports where h5py is missing.
* `iterate_batches` yields shuffled fixed-shape numpy batches from a
  prefetching thread pool. A seeded dataset gets each item's augmentation
  rng from (epoch seed, index), so the batches do not depend on
  `num_workers` or thread timing, and match the JAX package's.
"""

from __future__ import annotations

import concurrent.futures as _fut
import os
import random
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _dataset_dir(root: str, ang_res: int, scale: int) -> str:
    return os.path.join(root, f"SR_{ang_res}x{ang_res}_{scale}x")


def _h5py():
    """The `h5py` module, or an error that says plainly that it is missing."""
    try:
        import h5py
    except ImportError as e:
        raise ModuleNotFoundError(
            "reading the h5 data sets needs h5py, which is not installed: install "
            "it, or pass in-memory sets from Python (lft_torch.test.evaluate_sets, "
            "lft_torch.train.main(dataset=...))", name="h5py") from e
    return h5py


def augmentation(data: np.ndarray, label: np.ndarray,
                 rng: Optional[random.Random] = None) -> Tuple[np.ndarray, np.ndarray]:
    """p=0.5 W-axis flip (reverses the view order v and the pixels w
    together), p=0.5 H-axis flip, p=0.5 transpose (swaps U<->V and H<->W)."""
    r = rng or random
    if r.random() < 0.5:
        data, label = data[:, ::-1], label[:, ::-1]
    if r.random() < 0.5:
        data, label = data[::-1, :], label[::-1, :]
    if r.random() < 0.5:
        data, label = data.transpose(1, 0), label.transpose(1, 0)
    return data, label


class TrainDataset:
    """The h5 training set (reference TrainSetDataLoader)."""

    def __init__(self, args, seed: Optional[int] = None):
        self.dataset_dir = _dataset_dir(args.path_for_train, args.angRes, args.scale_factor)
        names = (sorted(os.listdir(self.dataset_dir)) if args.data_name == "ALL"
                 else [args.data_name])
        self.file_list: List[str] = []
        for name in names:
            files = sorted(os.listdir(os.path.join(self.dataset_dir, name)))
            self.file_list.extend(os.path.join(name, f) for f in files)
        self.seed = seed
        self.rng = random.Random(seed) if seed is not None else None

    def __len__(self) -> int:
        return len(self.file_list)

    def item(self, index: int, rng: Optional[random.Random]):
        """(lr [1, H, W], hr [1, H S, W S]) float32, augmented with `rng`."""
        with _h5py().File(os.path.join(self.dataset_dir, self.file_list[index]), "r") as hf:
            data = np.array(hf.get("Lr_SAI_y"))
            label = np.array(hf.get("Hr_SAI_y"))
        data, label = augmentation(data, label, rng)
        return (np.ascontiguousarray(data, dtype=np.float32)[None],
                np.ascontiguousarray(label, dtype=np.float32)[None])

    def __getitem__(self, index: int):
        return self.item(index, self.rng)


class TestDataset:
    """The h5 scenes of one test set (reference TestSetDataLoader,
    utils/utils_datasets.py:67-98)."""

    def __init__(self, args, data_name: str):
        self.dataset_dir = _dataset_dir(args.path_for_test, args.angRes, args.scale_factor)
        files = sorted(os.listdir(os.path.join(self.dataset_dir, data_name)))
        self.file_list = [os.path.join(data_name, f) for f in files]

    def __len__(self) -> int:
        return len(self.file_list)

    def scene_name(self, index: int) -> str:
        return Path(self.file_list[index]).stem

    def scene_shape(self, index: int) -> Tuple[int, ...]:
        """The LR mosaic's shape from the h5 header alone, with no pixel read
        (`evaluate_dataset` groups same-shape scenes by it)."""
        with _h5py().File(os.path.join(self.dataset_dir, self.file_list[index]), "r") as hf:
            s = hf["Lr_SAI_y"].shape
        return (s[1], s[0])  # the (1, 0) transpose __getitem__ applies

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(lr [A h, A w], hr [A h S, A w S]) float32 mosaics."""
        with _h5py().File(os.path.join(self.dataset_dir, self.file_list[index]), "r") as hf:
            lr = np.array(hf.get("Lr_SAI_y"))
            hr = np.array(hf.get("Hr_SAI_y"))
        # undo Matlab's column-major storage (utils/utils_datasets.py:89-90)
        lr = np.ascontiguousarray(lr.transpose(1, 0), dtype=np.float32)
        hr = np.ascontiguousarray(hr.transpose(1, 0), dtype=np.float32)
        return lr, hr


def multi_test_sets(args) -> Tuple[List[str], List[TestDataset], int]:
    """One `TestDataset` per directory of `path_for_test/SR_{A}x{A}_{S}x/`
    (reference MultiTestSetDataLoader, utils/utils_datasets.py:50-64), or
    only `--data_name` where it names one. Returns (names, sets, scenes)."""
    _h5py()
    root = _dataset_dir(args.path_for_test, args.angRes, args.scale_factor)
    names = sorted(os.listdir(root))
    if args.data_name != "ALL" and args.data_name in names:
        names = [args.data_name]
    sets = [TestDataset(args, n) for n in names]
    return names, sets, sum(len(s) for s in sets)


def iterate_batches(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                    drop_last: bool = True,
                    num_workers: int = 2) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield `(data [B, 1, H, W], label [B, 1, H S, W S])` numpy batches,
    fetched by `num_workers` threads, one batch ahead of the consumer. A
    dataset with `item(index, rng)` and a `seed` gets the per-item rng
    random.Random(1_000_003 * seed + index); `seed` is already the epoch's
    (the trainer passes args.seed + epoch)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    n = len(order)
    nb = n // batch_size if drop_last else -(-n // batch_size)
    deterministic = hasattr(dataset, "item") and getattr(dataset, "seed", None) is not None

    def fetch(i: int):
        if deterministic:
            return dataset.item(int(i), random.Random(1_000_003 * seed + int(i)))
        return dataset[int(i)]

    def make_batch(bi: int):
        items = [fetch(i) for i in order[bi * batch_size:(bi + 1) * batch_size]]
        return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])

    if not num_workers or num_workers <= 0:
        for i in range(nb):
            yield make_batch(i)
        return
    with _fut.ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending = [ex.submit(make_batch, i) for i in range(min(2, nb))]
        nxt = len(pending)
        for _ in range(nb):
            fut = pending.pop(0)
            if nxt < nb:
                pending.append(ex.submit(make_batch, nxt))
                nxt += 1
            yield fut.result()
