"""Repairs of the port's faults F1-F4 (ROADMAP §3), on the CPU.

* F1: a channel width the CUDA kernels are not built for (C = 48) takes the
  plain torch ops wherever the choice is automatic, and still equals
  lft_tpu's forward.
* F2: `--train_fused auto` trains the unfused branch at float32, as
  lft_tpu's auto does.
* F3: a resumed checkpoint is checked against `--channels` /
  `--scale_factor` before anything else, in both packages.
* F4: StepLR's learning rate equals optax's bit for bit at a gamma that is
  not a power of two.
"""

import os

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.models import lft as j_lft
from lft_tpu.training import optim as j_optim
from lft_tpu.training import trainer as j_trainer
from lft_torch.config import Args
from lft_torch.inference.tiled import ScenePipelineCache
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels.common import KERNEL_C, attention_route, kernels_take
from lft_torch.models import lft
from lft_torch.training import optim, trainer

DEMO = os.path.join(os.path.dirname(__file__), "..", "examples", "synth_demo")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_params(C, scale, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.rand(*s).astype(np.float32) - 0.5) * (2.0 / np.sqrt(max(np.prod(s[1:]), 1)))
            if len(s) > 1 else (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
            for k, s in lft.param_shapes(C, scale).items()}


# --------------------------------------------------------------------- F1 ---

@pytest.mark.parametrize("C", [16, 32, 48, 64, 96, 128])
def test_fused_branch_on_cuda_only_at_kernel_widths(C):
    """On CUDA the fused branch needs the kernels to take C; the plain
    blocks and the CPU (plain versions) take any gated width."""
    assert kernels_take(C) == (C in KERNEL_C)
    assert lft.resolve_fused(True, 32, 32, C, 25, "cuda", False) == kernels_take(C)
    assert lft.resolve_fused(True, 32, 32, C, 25, "cuda", True) == kernels_take(C)
    assert lft.resolve_fused(True, 32, 32, C, 25, "cuda", False, plain_blocks=True)
    assert lft.resolve_fused(True, 32, 32, C, 25, "cpu", False)


@pytest.mark.parametrize("impl,device_type,C,route", [
    ("auto", "cuda", 48, "auto"), ("auto", "cuda", 128, "auto"), ("auto", "cuda", 64, "pallas"),
    ("auto", "cuda", 16, "pallas"), ("auto", "cpu", 64, "auto"), ("pallas", "cuda", 48, "pallas"),
    ("tiled", "cuda", 64, "tiled")])
def test_attention_route(impl, device_type, C, route):
    """'auto' on CUDA at C = 48 takes the plain route ('auto': the tiled or
    dense torch op), as it does on the CPU; an explicit choice stays (the
    kernels raise at a width they do not take)."""
    assert attention_route(impl, device_type, C) == route


@pytest.mark.parametrize("fused", [False, True])
def test_c48_forward_matches_jax(fused):
    """A C = 48 forward on the CPU (unfused, and the fused branch's plain
    blocks) against lft_tpu's, 5x5 views of 16x16, scale 2: within 1e-4."""
    jargs = JArgs(angRes=5, scale_factor=2, channels=48, model_name="LFT")
    args = Args(angRes=5, scale_factor=2, channels=48)
    np_p = _np_params(48, 2, 11)
    lr = np.random.RandomState(12).rand(1, 1, 80, 80).astype(np.float32)
    ref = j_lft.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(lr), jargs,
                        remat=False)
    reset_launches()
    got = lft.forward(lft.params_from_numpy(np_p, device="cpu"), torch.from_numpy(lr), args,
                      fused=fused)
    assert not any(LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_c48_scene_pipeline_runs_plain():
    """The tiled scene pipeline at C = 48 equals the plain unfused forward
    patch by patch (the same path the card now takes)."""
    args = Args(angRes=5, scale_factor=2, channels=48, patch_size_for_test=16,
                stride_for_test=8, eval_batch=4)
    p = lft.params_from_numpy(_np_params(48, 2, 13), device="cpu")
    mosaic = torch.from_numpy(np.random.RandomState(14).rand(120, 120).astype(np.float32))
    sr = ScenePipelineCache(lft.forward, args)(p, mosaic)
    ref = ScenePipelineCache(lft.forward, args, fused=False, attention_impl="tiled")(p, mosaic)
    assert sr.shape == (240, 240) and torch.isfinite(sr).all()
    torch.testing.assert_close(sr, ref, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- F2 ---

@pytest.mark.parametrize("flag,fused", [("auto", False), ("true", True), ("false", False)])
def test_train_fused_auto_is_per_op_at_float32(flag, fused):
    """The choice reads only the device's type, so it is checked here for
    CUDA without a card; lft_tpu's auto is unfused at float32."""
    for dev in (torch.device("cuda"), torch.device("cpu")):
        assert trainer.train_fused(Args(train_fused=flag), dev) is fused


# --------------------------------------------------------------------- F3 ---

class _Patches:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def item(self, index, rng):
        raise AssertionError("training must not start from a checkpoint that does not fit")


def test_resume_checks_checkpoint_against_flags_in_both_packages():
    """The 2x demo checkpoint under `--scale_factor 4`: both packages raise
    a ValueError that names the upsampler's weight, before any step."""
    path = os.path.join(DEMO, "LFT_5x5_2x_synth1200.npz")
    kw = dict(angRes=5, scale_factor=4, channels=64, batch_size=1, epoch=1,
              use_pre_pth=True, path_pre_pth=path, num_workers=0)
    with pytest.raises(ValueError, match="upsampling.0.weight"):
        trainer.fit(Args(**kw), dataset=_Patches(2), device="cpu")
    with pytest.raises(ValueError, match="upsampling.0.weight"):
        j_trainer.fit(JArgs(**kw), dataset=_Patches(2))


# --------------------------------------------------------------------- F4 ---

def test_step_lr_matches_optax_at_gamma_0_3():
    """Adam + StepLR at gamma 0.3 over 3 decays (2 steps an epoch, a decay
    every epoch): the learning rate of every step equals the optax chain's
    bit for bit, and the parameters follow it as in test_torch_train."""
    kw = dict(lr=2e-4, gamma=0.3, n_steps=1, epoch=4, decay_rate=0.0, lr_schedule="step")
    sched = j_optim.step_lr_schedule(2e-4, 0.3, 1, 2)
    shapes = {"a.weight": (6, 5), "b.bias": (7,)}
    rng = np.random.RandomState(3)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in sorted(shapes.items())}
    tx = j_optim.make_optimizer(JArgs(**kw), steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in init.items()}
    opt = optim.make_optimizer(tp, Args(**kw), steps_per_epoch=2)
    for it in range(8):
        assert np.float32(opt.lr()) == np.asarray(sched(jnp.asarray(it, jnp.int32))), it
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in sorted(shapes.items())}
        upd, js = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, g in grads.items():
            tp[k].grad = torch.from_numpy(g)
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} step {it}")
    assert opt.count == 8
