"""lft_torch's fused blocks (K1 AngTrans, K2 SpaTrans) against the JAX
package's fused Pallas kernels, which run here in interpret mode (as
tests/test_kernels.py runs them). On the CPU the port's block wrappers run
their plain PyTorch versions; the CUDA kernels themselves are held against
those plain versions on the card (chip_smoke.py, tests/test_torch_cuda.py).
Tolerance: atol 2e-5, rtol 1e-4, the JAX package's own fused-vs-unfused
bound (tests/test_kernels.py:341-359)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.kernels import ang_block as j_ang
from lft_tpu.kernels import spa_block as j_spa
from lft_tpu.models import lft as j_lft
from lft_tpu.ops.posenc import angular_position, spatial_position
from lft_tpu.ops.unfold import unfold3x3_linear as j_unfold3x3_linear
from lft_torch.kernels import ang_block, spa_block
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.models.lft import params_from_numpy
from lft_torch.ops.unfold import unfold3x3_linear


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def c64_params():
    args = JArgs(angRes=5, scale_factor=2, channels=64, model_name="LFT")
    p = j_lft.init_params(jax.random.PRNGKey(0), args)
    np_p = {k: np.asarray(v) for k, v in p.items()}
    return np_p, params_from_numpy(np_p, device="cpu")


def _rand(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) - 0.5).astype(np.float32)


def test_ang_block_plain_matches_jax_fused(c64_params):
    np_p, t_p = c64_params
    N, A2, C = 128, 25, 64
    prefix = "altblock.2.ang_trans."
    x = _rand((N, A2, C), 70)
    pe = angular_position(A2, C)
    ref = j_ang.ang_trans_block_fused(jnp.asarray(x), jnp.asarray(pe),
                                      {k: jnp.asarray(v) for k, v in np_p.items()},
                                      prefix, 8)
    reset_launches()
    got = ang_block.ang_trans_block_fused(torch.from_numpy(x), torch.from_numpy(pe),
                                          t_p, prefix, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    plain = ang_block.ang_trans_block_plain(torch.from_numpy(x), torch.from_numpy(pe),
                                            t_p, prefix, 8)
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    assert LAUNCHES["ang_block"] == 0      # a CPU tensor never reaches the kernel


def test_spa_block_plain_matches_jax_fused(c64_params):
    np_p, t_p = c64_params
    B, h, w, C = 3, 16, 16, 64
    prefix = "altblock.1.spa_trans."
    x = _rand((B, h, w, C), 60)
    spa_pe = spatial_position(h, w, C)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    pe_tok_j = j_unfold3x3_linear(jnp.asarray(spa_pe)[None], jp[prefix + "MLP.weight"])[0]
    ref = j_spa.spa_trans_block_fused(jnp.asarray(x), pe_tok_j, jp, prefix, 8, 5)
    pe_tok = unfold3x3_linear(torch.from_numpy(spa_pe)[None],
                              t_p[prefix + "MLP.weight"])[0].contiguous()
    np.testing.assert_allclose(pe_tok.numpy(), np.asarray(pe_tok_j), atol=1e-5)
    reset_launches()
    got = spa_block.spa_trans_block_fused(torch.from_numpy(x), pe_tok, t_p, prefix, 8, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    assert sum(LAUNCHES.values()) == 0


def test_spa_steps_chain_equals_block(c64_params):
    """The five K2 step wrappers chained are the block, step by step."""
    _, t_p = c64_params
    prefix = "altblock.0.spa_trans."
    wts = spa_block.spa_weights(t_p, prefix)
    x = torch.from_numpy(_rand((2, 8, 8, 64), 5))
    pe_tok = torch.from_numpy(_rand((8, 8, 128), 6))
    tok, xn = spa_block.tokenize_ln(x, pe_tok, wts)
    assert tok.shape == xn.shape == (2, 8, 8, 128)
    q, k, v = spa_block.qkv(xn, tok, wts)
    attn = spa_block.window_attn(q, k, v, 8, 5)
    x2, xn2 = spa_block.outproj_ln(attn, tok, wts)
    out = spa_block.ffn_out(xn2, x2, wts)
    torch.testing.assert_close(out, spa_block.spa_block_plain(x, pe_tok, wts, 8, 5),
                               atol=0, rtol=0)
    assert out.shape == (2, 8, 8, 64)


def test_kernel_weight_layouts(c64_params):
    """wu is the tap-major [9, C, D] split of MLP.weight (torch unfold order
    c*9 + ky*3 + kx), as lft_tpu/kernels/spa_block.py:_prep builds it."""
    np_p, t_p = c64_params
    prefix = "altblock.3.spa_trans."
    ours = spa_block.spa_weights(t_p, prefix)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    ln, wu, wqk, wv, wo, w1, w2, wlin = j_spa._prep(jp, prefix)
    for name, ref in [("ln", ln), ("wu", wu), ("wqk", wqk), ("wv", wv), ("wo", wo),
                      ("w1", w1), ("w2", w2), ("wlin", wlin)]:
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(ref), err_msg=name)
        assert ours[name].is_contiguous()


@pytest.mark.parametrize("D,heads", [(32, 8), (128, 8), (30, 8), (64, 4)])
def test_spa_gate_matches_jax(D, heads):
    sizes = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 20, 24, 32, 40, 48, 64, 96, 128]
    for h in sizes:
        for w in (4, 16, 32, 33, 64, 128):
            for k in (3, 5):
                assert spa_block.spa_block_applicable(h, w, D, heads, k) == \
                    j_spa.spa_block_applicable(h, w, D, heads, k), (h, w, D, heads, k)


def test_ang_gate_matches_jax():
    for a2 in (1, 4, 9, 25, 49, 81, 121, 128, 129, 144, 169):
        assert ang_block.ang_block_applicable(a2) == j_ang.ang_block_applicable(a2)
