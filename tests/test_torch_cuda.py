"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one. The file imports neither JAX nor lft_tpu, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Shapes are small and ragged (a last block that is only partly filled) and
cover every channel width the kernels are built for.
"""

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, ang_block, reset_launches, spa_block
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position

TOL = dict(atol=1e-4, rtol=1e-4)   # the same f32 sums in another order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    from lft_torch.device import resolve_device
    return resolve_device("cuda")


def _params(C, dev, seed=0):
    return lft.init_params(seed, Args(channels=C, scale_factor=2), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
def test_ang_block_kernel(cuda_device, C):
    p = _params(C, cuda_device)
    wts = ang_block.ang_weights(p, "altblock.1.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C)
    x = torch.randn(37, 25, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(25, C)).to(cuda_device)
    reset_launches()
    got = ang_block.ang_block(x, pe, wts, 8)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_block"] == 1
    torch.testing.assert_close(got, ang_block.ang_block_plain(x, pe, wts, 8), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("C,h,w", [(16, 20, 12), (32, 9, 7), (64, 32, 32), (64, 17, 40)])
def test_spa_block_kernels(cuda_device, C, h, w):
    p = _params(C, cuda_device)
    wts = spa_block.spa_weights(p, "altblock.2.spa_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    x = torch.randn(3, h, w, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    reset_launches()
    got = spa_block.spa_block(x, pe_tok, wts, 8, 5)
    torch.cuda.synchronize()
    assert all(LAUNCHES[k] == 1 for k in LAUNCHES if k.startswith("spa_"))
    torch.testing.assert_close(got, spa_block.spa_block_plain(x, pe_tok, wts, 8, 5), **TOL)


@pytest.mark.cuda
def test_forward_kernels_match_plain_blocks(cuda_device):
    """The whole forward on the card: kernel blocks against plain blocks."""
    args = Args(channels=16, scale_factor=2)
    p = _params(16, cuda_device, seed=3)
    lr = torch.from_numpy(np.random.RandomState(0).rand(2, 1, 80, 80).astype(np.float32))
    lr = lr.to(cuda_device)
    got = lft.forward(p, lr, args)
    ref = lft.forward(p, lr, args, plain_blocks=True)
    torch.testing.assert_close(got, ref, **TOL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lft.forward(p, lr, args, fused=False)
