"""The port's `evaluate_dataset` and `TestDataset` against lft_tpu's, on the
CPU, on a synthetic h5 test set written by lft_tpu's generator: the same
scene names (the h5 stems), PSNR/SSIM within 1e-4, each scene's pixels read
once, the sweep ordered by `scene_shape` (the h5 header) only when scenes
are batched. Small: C=8, 5x5 views of 16x16 and 20x20 LR pixels, patch 8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.data import datasets as j_data
from lft_tpu.data.generate import _downscale_matlab, _lf_to_y, _mosaic, _write_h5
from lft_tpu.data.synth import make_synth_data, synth_lf_scene
from lft_tpu.inference import tiled as j_tiled
from lft_tpu.models import lft as j_lft
from lft_torch.config import Args
from lft_torch.data import datasets
from lft_torch.inference import tiled
from lft_torch.models import lft

C = 8
KW = dict(angRes=5, scale_factor=2, channels=C, patch_size_for_test=8, stride_for_test=4,
          eval_batch=4)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def test_set(tmp_path_factory):
    """Two 16x16-view scenes (`scene_00`, `scene_01`) and, first by name, a
    20x20-view one (`a_wide`), so ordering by shape differs from dataset
    order."""
    root = tmp_path_factory.mktemp("evalset")
    paths = make_synth_data(str(root), ang_res=5, scale=2, n_train=0, n_test=2, test_hw=16,
                            seed=7)
    y = _lf_to_y(synth_lf_scene(5, 40, 40, seed=11))
    lr = np.stack([np.stack([_downscale_matlab(y[u, v], 2) for v in range(5)])
                   for u in range(5)])
    _write_h5(str(root / "data_for_test" / "SR_5x5_2x" / paths["data_name"] / "a_wide.h5"),
              _mosaic(lr), _mosaic(y))
    kw = dict(KW, path_for_test=paths["path_for_test"], data_name=paths["data_name"])
    rng = np.random.RandomState(3)
    np_p = {k: (rng.rand(*s).astype(np.float32) - 0.5) * (2.0 / np.sqrt(np.prod(s[1:])))
            if len(s) > 1 else np.ones(s, np.float32)
            for k, s in lft.param_shapes(C, 2).items()}
    return Args(**kw), JArgs(model_name="LFT", **kw), np_p


class Counting:
    """A `TestDataset` that records every pixel read and header read."""

    def __init__(self, ds, fail_at=None):
        self.ds, self.fail_at = ds, fail_at
        self.reads, self.shapes = [], []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.reads.append(i)
        if i == self.fail_at:
            raise OSError(f"unreadable scene {i}")
        return self.ds[i]

    def scene_name(self, i):
        return self.ds.scene_name(i)

    def scene_shape(self, i):
        self.shapes.append(i)
        return self.ds.scene_shape(i)


def test_test_sets_match_jax(test_set):
    args, jargs, _ = test_set
    names, sets, total = datasets.multi_test_sets(args)
    j_names, j_sets, j_total = j_data.multi_test_sets(jargs)
    assert (names, total) == (j_names, j_total) == (["SynthLF"], 3)
    ds, jds = sets[0], j_sets[0]
    for i in range(len(ds)):
        assert ds.scene_name(i) == jds.scene_name(i)
        assert ds.scene_shape(i) == jds.scene_shape(i)
        for a, b in zip(ds[i], jds[i]):
            assert a.dtype == np.float32 and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)
        assert ds[i][0].shape == ds.scene_shape(i)
    assert [ds.scene_name(i) for i in range(3)] == ["a_wide", "scene_00", "scene_01"]


@pytest.mark.parametrize("scene_batch", [1, 2])
def test_evaluate_dataset_matches_jax(test_set, scene_batch):
    args, jargs, np_p = test_set
    ds = datasets.multi_test_sets(args)[1][0]
    jds = j_data.multi_test_sets(jargs)[1][0]
    cache = tiled.ScenePipelineCache(lft.forward, args, eval_batch=4, scene_batch=scene_batch)
    jcache = j_tiled.ScenePipelineCache(j_lft.forward, jargs, eval_batch=4,
                                        scene_batch=scene_batch)
    p, s, rows = tiled.evaluate_dataset(lft.forward, lft.params_from_numpy(np_p, device="cpu"),
                                        args, ds, cache=cache)
    jp, js, jrows = j_tiled.evaluate_dataset(
        j_lft.forward, {k: jnp.asarray(v) for k, v in np_p.items()}, jargs, jds, cache=jcache)
    assert [r[0] for r in rows] == [r[0] for r in jrows] == ["a_wide", "scene_00", "scene_01"]
    for (_, a_p, a_s), (_, b_p, b_s) in zip(rows, jrows):
        assert abs(a_p - b_p) <= 1e-4 and abs(a_s - b_s) <= 1e-4
    assert abs(p - jp) <= 1e-4 and abs(s - js) <= 1e-4
    assert p == pytest.approx(np.mean([r[1] for r in rows]), abs=1e-12)


@pytest.mark.parametrize("scene_batch", [1, 2])
def test_evaluate_dataset_reads_each_scene_once(test_set, scene_batch):
    """One pixel read a scene, with or without prefetch; with scenes batched
    the sweep follows `scene_shape` (the two 16x16-view scenes together,
    then the wider one), unbatched it follows the dataset and reads no
    header; the rows come back in dataset order either way."""
    args, _, np_p = test_set
    params = lft.params_from_numpy(np_p, device="cpu")
    cache = tiled.ScenePipelineCache(lft.forward, args, eval_batch=4, scene_batch=scene_batch)
    ds = datasets.multi_test_sets(args)[1][0]
    results = []
    for prefetch in (True, False):
        counting = Counting(ds)
        results.append(tiled.evaluate_dataset(lft.forward, params, args, counting, cache=cache,
                                              prefetch=prefetch))
        assert sorted(counting.reads) == [0, 1, 2]
        if scene_batch == 1:
            assert counting.reads == [0, 1, 2] and counting.shapes == []
        else:
            assert counting.reads == [1, 2, 0] and sorted(counting.shapes) == [0, 1, 2]
    assert results[0] == results[1]
    assert [r[0] for r in results[0][2]] == ["a_wide", "scene_00", "scene_01"]
    # a caller's metrics replace PSNR/SSIM
    p, s, rows = tiled.evaluate_dataset(lft.forward, params, args, ds, cache=cache,
                                        metrics_fn=lambda hr, sr, a: (1.0, 0.5))
    assert (p, s) == (1.0, 0.5) and all(r[1:] == (1.0, 0.5) for r in rows)


def test_evaluate_dataset_raises_a_failed_read_and_joins_the_prefetch(test_set):
    args, _, np_p = test_set
    counting = Counting(datasets.multi_test_sets(args)[1][0], fail_at=1)
    with pytest.raises(OSError, match="unreadable scene 1"):
        tiled.evaluate_dataset(lft.forward, lft.params_from_numpy(np_p, device="cpu"), args,
                               counting)
    # the read of scene 1 ran on the prefetch thread, and nothing read past it
    assert counting.reads == [0, 1]
