"""The port's tiled scene pipeline and metrics against the JAX package's,
on the same scene and parameters (c16, 5x5 views, scale 2)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.inference import tiled as j_tiled
from lft_tpu.models import lft as j_lft
from lft_tpu.ops import metrics as j_metrics
from lft_torch.config import Args
from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
from lft_torch.inference import tiled
from lft_torch.models import lft
from lft_torch.ops import metrics


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(3)
    np_p = {k: (rng.rand(*s).astype(np.float32) - 0.5) * (2.0 / np.sqrt(np.prod(s[1:])))
            if len(s) > 1 else np.ones(s, np.float32)
            for k, s in lft.param_shapes(16, 2).items()}
    kw = dict(angRes=5, scale_factor=2, channels=16, patch_size_for_test=16,
              stride_for_test=8, eval_batch=4)
    scenes = [lr_hr_pair(synth_lf_scene(5, 40, 40, seed=s), 2) for s in (1, 2)]
    return np_p, JArgs(model_name="LFT", **kw), Args(**kw), scenes


def test_scene_sr_and_metrics_match_jax(setup):
    """20x20-view LR scene -> 9 patches at patch 16 / stride 8, run as two
    full chunks of 4 and a remainder chunk of 1."""
    np_p, jargs, args, scenes = setup
    lr, hr = scenes[0]
    h0 = lr.shape[0] // 5
    ref = j_tiled.make_scene_sr(j_lft.forward, jargs, h0, h0, eval_batch=4)(
        {k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(lr))
    params = lft.params_from_numpy(np_p, device="cpu")
    sr = tiled.make_scene_sr(lft.forward, args, h0, h0, eval_batch=4)(
        params, torch.from_numpy(lr))
    assert sr.shape == (lr.shape[0] * 2, lr.shape[1] * 2)
    assert float((sr - torch.from_numpy(np.array(ref))).abs().max()) <= 1e-4
    p, s = metrics.cal_metrics(torch.from_numpy(hr), sr, 5)
    jp, js = j_metrics.cal_metrics(jnp.asarray(hr), ref, 5)
    assert abs(float(p) - float(jp)) <= 1e-3
    assert abs(float(s) - float(js)) <= 1e-5
    # the fused branch through the plain blocks gives the same scene
    sr_f = tiled.make_scene_sr(lft.forward, args, h0, h0, eval_batch=4,
                               fused=True)(params, torch.from_numpy(lr))
    assert float((sr_f - sr).abs().max()) <= 1e-5


def test_evaluate_dataset_batches_scenes(setup):
    """Per-scene results are those of single-scene runs, whatever the
    scene batching."""
    np_p, _, args, scenes = setup
    params = lft.params_from_numpy(np_p, device="cpu")
    one = tiled.evaluate_dataset(lft.forward, params, args, scenes)
    cache = tiled.ScenePipelineCache(lft.forward, args, eval_batch=4, scene_batch=2)
    two = tiled.evaluate_dataset(lft.forward, params, args, scenes, cache=cache)
    assert len(one[2]) == 2 and [r[0] for r in one[2]] == ["0", "1"]
    for a, b in zip(one[2], two[2]):
        assert abs(a[1] - b[1]) < 1e-4 and abs(a[2] - b[2]) < 1e-6
    assert one[0] == pytest.approx(np.mean([r[1] for r in one[2]]))
    assert one[1] == pytest.approx(np.mean([r[2] for r in one[2]]))


def test_synth_scene_matches_jax_generator():
    from lft_tpu.data.generate import _lf_to_y
    from lft_tpu.data.synth import synth_lf_scene as j_synth
    lf = synth_lf_scene(5, 24, 20, seed=4)
    np.testing.assert_array_equal(lf, j_synth(5, 24, 20, seed=4))
    lr, hr = lr_hr_pair(lf, 2)
    y = _lf_to_y(lf)
    np.testing.assert_allclose(hr, y.transpose(0, 2, 1, 3).reshape(5 * 24, 5 * 20),
                               atol=1e-6)
    assert lr.shape == (5 * 12, 5 * 10) and lr.dtype == np.float32
