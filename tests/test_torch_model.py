"""The port's LFT forward and checkpoint loading against the JAX package and
the goldens of the original torch reference."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.models import lft as j_lft
from lft_tpu.utils import checkpoint as j_ckpt
from lft_torch import get_model
from lft_torch.config import Args
from lft_torch.models import lft
from lft_torch.utils import checkpoint as ckpt

DEMO = os.path.join(os.path.dirname(__file__), "..", "examples", "synth_demo")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _golden_params(g):
    return {k[len("param."):]: g[k] for k in g.files if k.startswith("param.")}


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_reference_golden(goldens, fused):
    """Full width (C=64, 4x) against the original torch reference's output;
    fused=True runs the fused branch through the blocks' plain versions."""
    g = goldens("model_s4_c64.npz")
    a, s, c, h, w, b = (int(v) for v in g["meta"])
    args = Args(angRes=a, scale_factor=s, channels=c)
    params = lft.params_from_numpy(_golden_params(g), device="cpu")
    out = lft.forward(params, torch.from_numpy(g["x"]), args, fused=fused)
    diff = float(np.abs(out.numpy() - g["out"]).max())
    assert diff < 2e-5, diff


def test_fused_branch_matches_jax_forward():
    """The fused branch (plain block versions on the CPU) against the JAX
    unfused forward: c16, 5x5 views of 16x16, scale 2."""
    jargs = JArgs(angRes=5, scale_factor=2, channels=16, model_name="LFT")
    args = Args(angRes=5, scale_factor=2, channels=16)
    rng = np.random.RandomState(7)
    np_p = {k: (rng.rand(*s).astype(np.float32) - 0.5) * (2.0 / np.sqrt(max(np.prod(s[1:]), 1)))
            if len(s) > 1 else (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
            for k, s in lft.param_shapes(16, 2).items()}
    lr = rng.rand(2, 1, 80, 80).astype(np.float32)
    ref = j_lft.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(lr),
                        jargs, remat=False)
    got = lft.forward(lft.params_from_numpy(np_p, device="cpu"), torch.from_numpy(lr),
                      args, fused=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    unfused = lft.forward(lft.params_from_numpy(np_p, device="cpu"), torch.from_numpy(lr),
                          args, fused=False)
    np.testing.assert_allclose(unfused.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("name", ["LFT_5x5_4x_synth3000", "LFT_5x5_2x_synth1200"])
def test_checkpoints_load_like_jax(name):
    """.pth and .npz load to exactly the tensors lft_tpu's loader returns."""
    for ext in (".pth", ".npz"):
        path = os.path.join(DEMO, name + ext)
        ref, ref_epoch, ref_opt = j_ckpt.load_checkpoint(path)
        got, epoch, opt = ckpt.load_checkpoint(path, device="cpu")
        assert epoch == ref_epoch
        assert set(opt or {}) == set(ref_opt or {})
        for k in opt or {}:
            np.testing.assert_array_equal(opt[k], ref_opt[k], err_msg=k)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        direct = lft.params_from_numpy(ref, device="cpu")
        for k in ref:
            assert torch.equal(direct[k], got[k])


def test_module_state_dict_loads_reference_pth_strict():
    path = os.path.join(DEMO, "LFT_5x5_4x_synth3000.pth")
    sd = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
    m = lft.LFT(Args(channels=64, scale_factor=4))
    m.load_state_dict(sd, strict=True)
    assert set(m.state_dict()) == set(lft.param_shapes(64, 4))
    x = torch.rand(1, 1, 40, 40)
    with torch.no_grad():
        out = m(x)
    ref = lft.forward({k: v.float() for k, v in sd.items()}, x, m.args)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_params_from_numpy_validates():
    p = {k: np.zeros(s, np.float32) for k, s in lft.param_shapes(16, 2).items()}
    lft.params_from_numpy(p, device="cpu")
    bad = dict(p)
    bad["upsampling.3.weight"] = np.zeros((1, 16, 5, 5), np.float32)
    with pytest.raises(ValueError, match="upsampling.3.weight"):
        lft.params_from_numpy(bad, device="cpu")
    del bad["upsampling.3.weight"]
    with pytest.raises(ValueError, match="missing"):
        lft.params_from_numpy(bad, device="cpu")


def test_registry_and_init():
    args = Args(channels=16, scale_factor=2)
    model = get_model(args)
    p = model.init(0, args, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == lft.param_shapes(16, 2)
    assert float(p["altblock.0.ang_trans.norm.weight"].min()) == 1.0
    assert float(p["altblock.0.ang_trans.norm.bias"].abs().max()) == 0.0
    assert "fused" in model.capabilities
    out = model.apply(p, torch.zeros(1, 1, 40, 40), args)
    assert out.shape == (1, 1, 80, 80)
    assert torch.isfinite(model.loss(out, torch.zeros_like(out)))
    n = model.param_count(p)
    full = sum(int(np.prod(s)) for s in lft.param_shapes(64, 4).values())
    assert n > 0 and 1.14e6 < full < 1.18e6


def test_only_float32():
    """float32 and mixed run every branch; bfloat16 serves through every
    branch (the unfused one since ROADMAP item 9d) and trains through every
    branch (the unfused one since 9e): under grad its f32 output's gradient
    reaches every f32 parameter."""
    args = Args(channels=16, scale_factor=2, dtype="bfloat16")
    p = lft.init_params(0, Args(channels=16, scale_factor=2), device="cpu")
    out = lft.forward(p, torch.zeros(1, 1, 40, 40), args, fused=False)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    for t in p.values():
        t.requires_grad_(True)
    out = lft.forward(p, torch.rand(1, 1, 40, 40, generator=torch.Generator().manual_seed(0)),
                      args, fused=False)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.float32
               and torch.isfinite(t.grad).all() for t in p.values())
