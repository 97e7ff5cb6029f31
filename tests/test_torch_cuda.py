"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one. The file imports neither JAX nor lft_tpu, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Shapes are small and ragged (a last block that is only partly filled) and
cover every channel width the kernels are built for. The backward kernels
are held to max |kernel - plain| <= 5e-4 max |plain| per output (the JAX
package's fused-vs-unfused gradient bound, tests/test_kernels.py:428).
"""

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import (FORWARD, LAUNCHES, PEROP, SWEEPS, TAIL, ang_attn_mxu,
                               ang_attn_vjp, ang_block, local_attn, local_attn_vjp,
                               reset_launches, spa_attn, spa_attn_hp, spa_block, wgrad)
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position
from lft_torch.ops.unfold import unfold3x3_linear

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
    assert all(LAUNCHES[k] == 1 for k in FORWARD if k.startswith("spa_"))
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
    # the unfused branch runs on the card through the per-op kernels
    reset_launches()
    unfused = lft.forward(p, lr, args, fused=False)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_attn"] == 4 and LAUNCHES["spa_attn_hp"] == 4
    assert not any(LAUNCHES[k] for k in FORWARD)
    torch.testing.assert_close(unfused, ref, **TOL)
    torch.testing.assert_close(unfused, lft.forward(p, lr, args, fused=False,
                                                    attention_impl="tiled"), **TOL)


def _close(got, ref, rel=5e-4):
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (i, g.shape, r.shape)
        err = float((g - r).abs().max())
        assert err <= rel * float(r.abs().max()) + 1e-9, (i, err, float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
def test_ang_block_res_and_bwd_kernels(cuda_device, C):
    p = _params(C, cuda_device, seed=C)
    wts = ang_block.ang_weights(p, "altblock.3.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C)
    x = torch.randn(37, 25, C, device=cuda_device, generator=g)
    dout = torch.randn(37, 25, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(25, C)).to(cuda_device)
    reset_launches()
    res = ang_block.ang_block(x, pe, wts, 8, with_res=True)
    ref = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_block_res"] == 1 and LAUNCHES["ang_block"] == 0
    _close(res, ref, 1e-4)
    _, m, l, attn = ref
    ops = ang_block.ang_block_bwd_ops(x, pe, wts, m, l, attn, dout, 8)
    ops_ref = ang_block.ang_block_bwd_ops_plain(x, pe, wts, m, l, attn, dout, 8)
    _close(ops[:-1], ops_ref[:-1])
    _close(ops[-1].sum(0, keepdim=True), ops_ref[-1])
    got = ang_block.ang_block_bwd(x, pe, wts, m, l, attn, dout, 8)
    torch.cuda.synchronize()
    _close(got, ang_block.ang_block_bwd_plain(x, pe, wts, m, l, attn, dout, 8))
    assert LAUNCHES["ang_block_bwd"] == 2 and LAUNCHES["wgrad"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("C,h,w", [(16, 20, 12), (32, 9, 7), (64, 32, 32), (64, 17, 40)])
def test_spa_res_and_bwd_kernels(cuda_device, C, h, w):
    """K2 with residuals and K3's steps against their plain versions; dout
    is zero on the tokens whose FFN ReLU is on in one version of step a and
    off in the other (ROADMAP §3, "ReLU and sign flips")."""
    p = _params(C, cuda_device, seed=h)
    wts = spa_block.spa_weights(p, "altblock.1.spa_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + w)
    x = torch.randn(3, h, w, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    dout = torch.randn(3, h, w, C, device=cuda_device, generator=g)
    res = spa_block.spa_block(x, pe_tok, wts, 8, 5, with_res=True)
    ref = spa_block.spa_block_plain(x, pe_tok, wts, 8, 5, with_res=True)
    _close(res, ref, 1e-4)
    _, tok, m, l, attn = ref
    dout = _calm_relu(dout, spa_block.ffn_out_bwd(attn, tok, dout, wts)[4],
                      spa_block.ffn_out_bwd_plain(attn, tok, dout, wts)[4])
    a = spa_block.ffn_out_bwd(attn, tok, dout, wts)
    a_ref = spa_block.ffn_out_bwd_plain(attn, tok, dout, wts)
    _close(a[:-1], a_ref[:-1])
    _close(a[-1].sum(0, keepdim=True), a_ref[-1])
    b_ref = spa_block.ln_qkv_plain(tok, pe_tok, wts)
    _close(spa_block.ln_qkv(tok, pe_tok, wts), b_ref, 1e-4)
    xn, q, k, v = b_ref
    dattn = a_ref[1]
    c_ref = spa_block.window_attn_bwd_plain(q, k, v, attn, dattn, m, l, 8, 5)
    _close(spa_block.window_attn_bwd(q, k, v, attn, dattn, m, l, 8, 5), c_ref)
    dq, dk, dv = c_ref
    d = spa_block.qkv_ln_bwd(tok, pe_tok, dq, dk, dv, a_ref[0], wts)
    d_ref = spa_block.qkv_ln_bwd_plain(tok, pe_tok, dq, dk, dv, a_ref[0], wts)
    _close(d[:-1], d_ref[:-1])
    _close(d[-1].sum(0, keepdim=True), d_ref[-1])
    wts_m = spa_block._with_mlp(wts)
    _close(spa_block.tokenize_bwd(d_ref[0], wts), spa_block.tokenize_bwd_plain(d_ref[0], wts_m))
    reset_launches()
    got = spa_block.spa_block_bwd(x, pe_tok, wts_m, tok, m, l, attn, dout, 8, 5)
    torch.cuda.synchronize()
    assert all(LAUNCHES[n] == 1 for n in ("spa_ffn_out_bwd", "spa_ln_qkv", "spa_window_attn_bwd",
                                          "spa_qkv_ln_bwd", "spa_tokenize_bwd"))
    _close(got, spa_block.spa_block_bwd_plain(x, pe_tok, wts_m, tok, m, l, attn, dout, 8, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("C,h,w", [(16, 20, 12), (32, 9, 7), (64, 32, 32), (64, 17, 40)])
def test_k3b_k3c_recompute_the_forward_bitwise(cuda_device, C, h, w):
    """K3.b from K2.1's tok (the kernel's): its (xn, q, k, v) equal K2.1's xn
    and K2.2's (q, k, v) bit for bit, one launch. K3.c on them with K2.3
    res's (m, l): (dq, dk, dv) equal `spa_attn_hp_bwd`'s bit for bit (it is
    K5's backward, one launch counted as `spa_window_attn_bwd`), repeat
    bitwise, and against float64 (from the float64 forward's (m, l)) are
    within twice the f32 plain version's error (from its own)."""
    p = _params(C, cuda_device, seed=h + 1)
    wts = spa_block.spa_weights(p, "altblock.2.spa_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + h + w)
    x = torch.randn(3, h, w, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    dattn = torch.randn(3, h, w, 2 * C, device=cuda_device, generator=g)
    tok, xn = spa_block.tokenize_ln(x, pe_tok, wts)
    fwd = (xn, *spa_block.qkv(xn, tok, wts))
    reset_launches()
    got = spa_block.ln_qkv(tok, pe_tok, wts)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_ln_qkv"] == 1 and sum(LAUNCHES.values()) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, fwd))
    _close(got, spa_block.ln_qkv_plain(tok, pe_tok, wts), 1e-4)
    q, k, v = got[1:]
    attn, m, l = spa_block.window_attn(q, k, v, 8, 5, with_stats=True)
    reset_launches()
    c = spa_block.window_attn_bwd(q, k, v, attn, dattn, m, l, 8, 5)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_window_attn_bwd"] == 1 and sum(LAUNCHES.values()) == 1
    assert all(torch.equal(a, b) for a, b in
               zip(c, spa_attn_hp.spa_attn_hp_bwd(q, k, v, m, l, dattn, 8, 5)))
    assert all(torch.equal(a, b) for a, b in
               zip(c, spa_block.window_attn_bwd(q, k, v, attn, dattn, m, l, 8, 5)))
    _close(c, spa_block.window_attn_bwd_plain(q, k, v, attn, dattn, m, l, 8, 5))
    a_p, m_p, l_p = spa_block.window_attn_plain(q, k, v, 8, 5)
    ref = spa_block.window_attn_bwd_plain(q, k, v, a_p, dattn, m_p, l_p, 8, 5)
    x64 = [t.double() for t in (q, k, v)]
    a64, m64, l64 = spa_block.window_attn_plain(*x64, 8, 5)
    exact = spa_block.window_attn_bwd_plain(*x64, a64, dattn.double(), m64, l64, 8, 5)
    for u, r, e in zip(c, ref, exact):
        err, err_f32, _ = _f64_err(u, r, e)
        assert err <= 2 * err_f32, (err, err_f32)


# every product of a fused 5x5 train step (batch 4, C = 64: T = 102,400; at
# angRes 9 T = 82,944), then ragged ones: T no slice or slab divides, K and N
# multiples of 4 but not of the 128 x 128 (64 x 32 with taps) tile
WGRAD_SHAPES = [(102400, 64, 128, (32, 32)), (102400, 128, 128, None),
                (102400, 128, 256, None), (102400, 256, 128, None), (102400, 128, 64, None),
                (102400, 64, 64, None), (102400, 64, 128, None), (82944, 64, 64, None),
                (1000, 64, 128, None), (4097, 256, 128, None), (3001, 100, 36, None),
                (777, 132, 260, None), (7, 4, 4, None), (3 * 9 * 7, 16, 32, (9, 7)),
                (2 * 32 * 32, 64, 128, (32, 32)), (5 * 17 * 40, 20, 44, (17, 40))]


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,N,image", WGRAD_SHAPES)
def test_wgrad_kernels(cuda_device, T, K, N, image):
    """Against the plain version (f32, TF32 off); against float64 no worse
    than twice the plain f32 product; bitwise repeatable."""
    g = torch.Generator(device=cuda_device).manual_seed(T + K + N)
    x = torch.randn(T, K, device=cuda_device, generator=g)
    dy = torch.randn(T, N, device=cuda_device, generator=g)
    reset_launches()
    got = wgrad.wgrad(x, dy, image)
    torch.cuda.synchronize()
    assert LAUNCHES["wgrad"] == 1
    ref = wgrad.wgrad_plain(x, dy, image)
    _close(got, ref, 1e-5)
    exact = wgrad.wgrad_plain(x.double(), dy.double(), image)
    err, err_f32 = (float((t.double() - exact).abs().max()) for t in (got, ref))
    assert err <= 2 * err_f32 + 1e-7 * float(exact.abs().max()), (err, err_f32)
    assert torch.equal(got, wgrad.wgrad(x, dy, image))


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(1600, 256), (2048, 256), (1296, 256), (100, 131072), (7, 5),
                                 (1000, 64), (33, 1030)])
def test_colsum_kernel(cuda_device, R, N):
    """The LayerNorm partial sums of K3 ([1600, 256]) and K4 ([2048, 256];
    [1296, 256] at angRes 9), the spatial PE grad ([100, 131072]), a scalar
    tail; bitwise repeatable."""
    g = torch.Generator(device=cuda_device).manual_seed(R + N)
    a = torch.randn(R, N, device=cuda_device, generator=g)
    reset_launches()
    got = wgrad.colsum(a)
    torch.cuda.synchronize()
    assert LAUNCHES["colsum"] == 1
    _close(got, wgrad.colsum_plain(a), 1e-5)
    assert torch.equal(got, wgrad.colsum(a))


@pytest.mark.cuda
def test_backward_kernels_repeat_bitwise(cuda_device):
    C = 64
    p = _params(C, cuda_device, seed=5)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    wa = ang_block.ang_weights(p, "altblock.0.ang_trans.")
    x = torch.randn(300, 25, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(25, C)).to(cuda_device)
    dout = torch.randn_like(x)
    _, m, l, attn = ang_block.ang_block(x, pe, wa, 8, with_res=True)
    a1 = ang_block.ang_block_bwd(x, pe, wa, m, l, attn, dout, 8)
    a2 = ang_block.ang_block_bwd(x, pe, wa, m, l, attn, dout, 8)
    assert all(torch.equal(u, v) for u, v in zip(a1, a2))
    ws = spa_block._with_mlp(spa_block.spa_weights(p, "altblock.0.spa_trans."))
    xs = torch.randn(6, 32, 32, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(32, 32, 2 * C, device=cuda_device, generator=g)
    ds = torch.randn_like(xs)
    _, tok, m, l, attn = spa_block.spa_block(xs, pe_tok, ws, 8, 5, with_res=True)
    s1 = spa_block.spa_block_bwd(xs, pe_tok, ws, tok, m, l, attn, ds, 8, 5)
    s2 = spa_block.spa_block_bwd(xs, pe_tok, ws, tok, m, l, attn, ds, 8, 5)
    assert all(torch.equal(u, v) for u, v in zip(s1, s2))


@pytest.mark.cuda
def test_model_grads_kernels_match_plain(cuda_device):
    """Gradients of the whole model through the kernels against the plain
    blocks, at C=16 and the 4x recipe's geometry (32x32-view patches)."""
    args = Args(channels=16, scale_factor=4)
    p = lft.init_params(4, args, device=cuda_device)
    for t in p.values():
        t.requires_grad_(True)
    rng = np.random.RandomState(1)
    lr = torch.from_numpy(rng.rand(2, 1, 160, 160).astype(np.float32)).to(cuda_device)
    hr = torch.from_numpy(rng.rand(2, 1, 640, 640).astype(np.float32)).to(cuda_device)

    def grads(plain):
        sr = lft.forward(p, lr, args, plain_blocks=plain)
        loss = ((sr - hr) * torch.cos(3.0 * (sr - hr))).mean()
        return torch.autograd.grad(loss, list(p.values()))

    reset_launches()
    got = grads(False)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_block_bwd"] == 4 and LAUNCHES["spa_tokenize_bwd"] == 4
    for name, g1, g2 in zip(p, got, grads(True)):
        err = float((g1 - g2).abs().max())
        assert err <= 5e-4 * float(g2.abs().max()) + 2e-9, (name, err)


class _Patches:
    """In-memory training set with `item(index, rng)`, like TrainDataset."""

    def __init__(self, n, seed=0):
        rng = np.random.RandomState(seed)
        self.lr = [rng.rand(160, 160).astype(np.float32) for _ in range(n)]
        self.hr = [rng.rand(640, 640).astype(np.float32) for _ in range(n)]
        self.seed = seed

    def __len__(self):
        return len(self.lr)

    def item(self, index, rng):
        from lft_torch.data.datasets import augmentation
        d, l = augmentation(self.lr[index], self.hr[index], rng)
        return np.ascontiguousarray(d)[None], np.ascontiguousarray(l)[None]


@pytest.mark.cuda
def test_fit_kill_resume_bitwise_on_card(cuda_device, tmp_path):
    """fit through the kernels for 2 epochs == 1 epoch, an npz save, a load
    and 1 more epoch: params and Adam state bit for bit on the card."""
    from lft_torch.training import trainer
    data = _Patches(4)
    base = dict(channels=16, scale_factor=4, batch_size=2, epoch=2, n_steps=1, num_workers=0,
                seed=3, train_fused="true")
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    full, hist = trainer.fit(Args(**base), dataset=data, checkpoints_dir=str(a))
    assert all(np.isfinite(h["loss"]) for h in hist)
    trainer.fit(Args(**dict(base, epoch=1)), dataset=data, checkpoints_dir=str(b))
    ck = trainer.checkpoint_path(str(b), Args(**base), 1)
    reset_launches()
    resumed, _ = trainer.fit(Args(**dict(base, use_pre_pth=True, path_pre_pth=ck)),
                             dataset=data, checkpoints_dir=str(b))
    assert LAUNCHES["ang_block_bwd"] == 2 * 4 and LAUNCHES["spa_tokenize_bwd"] == 2 * 4
    for k in full:
        assert torch.equal(full[k], resumed[k]), k
    za = np.load(trainer.checkpoint_path(str(a), Args(**base), 2))
    zb = np.load(trainer.checkpoint_path(str(b), Args(**base), 2))
    for f in za.files:
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)


# ------------------------------------------------ per-op kernels K7 and K5 ---

@pytest.mark.cuda
@pytest.mark.parametrize("C,N,A2", [(16, 37, 25), (32, 37, 25), (64, 37, 25), (64, 7, 81),
                                    (64, 3, 121), (32, 11, 9), (64, 1, 128), (16, 13, 1),
                                    (64, 9, 32), (32, 9, 33), (64, 5, 64), (64, 4, 65),
                                    (64, 4099, 25), (32, 2001, 33), (64, 700, 100)])
def test_ang_attn_kernels(cuda_device, C, N, A2):
    """K7 forward, forward with stats and backward against their plain
    versions: every channel width, ragged N, A2 up to the gate's 128 (the
    backward's register-held query phase up to 32 views, one stage past 85
    at C = 64), and N large enough that each persistent block takes several
    tiles. The backward runs from the plain forward's (m, l) (at one view
    from its own) and from the kernel's own `_res` outputs (the plain (m,
    l) fit only the plain scores). Both forwards and the backward repeat
    bitwise. Where a case has at least 900 tokens, every output's max error
    against float64 (the backward from the float64 forward's (m, l)) is at
    most twice the f32 plain version's (from its own)."""
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    q, k, v, dout = (torch.randn(N, A2, C, device=cuda_device, generator=g) for _ in range(4))
    ref = ang_attn_mxu.ang_attention_blockdiag_plain(q, k, v, 8)
    reset_launches()
    got_f = ang_attn_mxu.ang_attn_fwd(q, k, v, 8)
    _close(got_f, ref[0], 1e-4)
    got_r = ang_attn_mxu.ang_attn_fwd(q, k, v, 8, with_stats=True)
    _close(got_r, ref, 1e-4)
    # at one view p = 1 and dq = dk = 0 exactly, and an m one ulp off the
    # other version's score makes them ~1e-7: there each backward runs
    # from its own forward
    own_ml = got_r[1:] if A2 > 1 else ref[1:]
    _, m, l = ref if A2 > 1 else got_r
    got = ang_attn_mxu.ang_attn_bwd(q, k, v, m, l, dout, 8)
    torch.cuda.synchronize()
    assert [LAUNCHES[n] for n in PEROP[:3]] == [1, 1, 1]
    ref_b = ang_attn_mxu.ang_attention_blockdiag_bwd_plain(q, k, v, *ref[1:], dout, 8)
    _close(got, ref_b)
    again = ang_attn_mxu.ang_attn_bwd(q, k, v, m, l, dout, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got_f, ang_attn_mxu.ang_attn_fwd(q, k, v, 8))
    assert all(torch.equal(a, b)
               for a, b in zip(got_r, ang_attn_mxu.ang_attn_fwd(q, k, v, 8, with_stats=True)))
    assert torch.equal(got_f, got_r[0])
    # the backward from the kernel's own forward
    own = ang_attn_mxu.ang_attn_bwd(q, k, v, *got_r[1:], dout, 8)
    _close(own, ang_attn_mxu.ang_attention_blockdiag_bwd_plain(q, k, v, *own_ml, dout, 8))
    assert all(torch.equal(a, b)
               for a, b in zip(own, ang_attn_mxu.ang_attn_bwd(q, k, v, *got_r[1:], dout, 8)))
    if N * A2 < 900:
        return
    x64 = [t.double() for t in (q, k, v, dout)]
    e_fwd = ang_attn_mxu.ang_attention_blockdiag_plain(*x64[:3], 8)
    e_bwd = ang_attn_mxu.ang_attention_blockdiag_bwd_plain(*x64[:3], *e_fwd[1:], x64[3], 8)
    err = lambda a, e: float((a.double() - e).abs().max())
    for name, a, b, e in zip(("out", "m", "l", "dq", "dk", "dv"), (*got_r, *own), (*ref, *ref_b),
                             (*e_fwd, *e_bwd)):
        assert err(a, e) <= 2 * err(b, e), (name, err(a, e), err(b, e))


@pytest.mark.cuda
@pytest.mark.parametrize("C,h,w", [(16, 20, 12), (32, 9, 7), (64, 32, 32), (64, 17, 40),
                                   (64, 3, 2), (16, 30, 30), (32, 8, 101), (64, 30, 30),
                                   (64, 8, 101)])
def test_spa_attn_hp_kernels(cuda_device, C, h, w):
    """K5 forward, forward with stats and backward against their plain
    versions: every channel width, ragged tiles, views smaller than a tile.
    The forward is K2.3's window step bit for bit; the backward's pass q
    writes D = sum_j p_j dp_j beside dq, and a call repeats bitwise."""
    E = 2 * C
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    q, k, v, dout = (torch.randn(3, h, w, E, device=cuda_device, generator=g) for _ in range(4))
    ref = spa_attn_hp.windowed_attention_headpacked_plain(q, k, v, 8, 5)
    reset_launches()
    _close(spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5), ref[0], 1e-4)
    _close(spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5, with_stats=True), ref, 1e-4)
    _, m, l = ref
    got = spa_attn_hp.spa_attn_hp_bwd(q, k, v, m, l, dout, 8, 5, with_dsum=True)
    torch.cuda.synchronize()
    assert [LAUNCHES[n] for n in PEROP[3:]] == [1, 1, 1]
    _close(got[:3],
           spa_attn_hp.windowed_attention_headpacked_bwd_plain(q, k, v, m, l, dout, 8, 5))
    _close(got[3],
           spa_attn_hp.windowed_attention_headpacked_dsum_plain(q, k, v, m, l, dout, 8, 5), 1e-4)
    again = spa_attn_hp.spa_attn_hp_bwd(q, k, v, m, l, dout, 8, 5, with_dsum=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the same kernel as K2's window step, with the same m, l
    assert torch.equal(spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5),
                       spa_block.window_attn(q, k, v, 8, 5))
    got = spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5, with_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, spa_block.window_attn(q, k, v, 8, 5, True)))


@pytest.mark.cuda
def test_perop_wrappers_raise_on_card_instead_of_falling_back(cuda_device):
    from lft_torch.kernels.local_attn import local_attention_pallas
    g = torch.Generator(device=cuda_device).manual_seed(0)
    r = lambda *s: torch.randn(*s, device=cuda_device, generator=g)
    with pytest.raises(NotImplementedError, match="kernel takes"):
        ang_attn_mxu.ang_attn_fwd(r(2, 25, 24), r(2, 25, 24), r(2, 25, 24), 8)
    with pytest.raises(NotImplementedError, match="kernel takes"):
        ang_attn_vjp.ang_attn_sweep_fwd(r(2, 144, 24), r(2, 144, 24), r(2, 144, 24), 8)
    # K10 runs on the card, for inference only; it takes 8x8 tiles
    reset_launches()
    out = local_attention_pallas(r(1, 16, 16, 32), r(1, 16, 16, 32), r(96, 32), r(32, 32), 8,
                                 variant="tile")
    assert out.shape == (1, 16, 16, 32) and LAUNCHES["spa_attn_tile"] == 1
    with pytest.raises(ValueError, match="forward-only"):
        local_attention_pallas(r(1, 16, 16, 32), r(1, 16, 16, 32), r(96, 32).requires_grad_(),
                               r(32, 32), 8, variant="tile")
    # K10 launches K5's forward kernel, whose result does not depend on t
    q16 = r(1, 16, 16, 32)
    assert torch.equal(local_attn.windowed_attention_tile(q16, q16, q16, 8, 5, t=16),
                       local_attn.windowed_attention_tile(q16, q16, q16, 8, 5))
    with pytest.raises(ValueError, match="12x12 tiles do not divide"):
        local_attn.windowed_attention_tile(q16, q16, q16, 8, 5, t=12)
    with pytest.raises(NotImplementedError, match="kernel takes"):
        local_attn.windowed_attention_tile(r(1, 8, 8, 24), r(1, 8, 8, 24), r(1, 8, 8, 24), 8, 5)
    with pytest.raises(NotImplementedError, match="kernel takes"):
        spa_attn_hp.spa_attn_hp_fwd(r(1, 8, 8, 24), r(1, 8, 8, 24), r(1, 8, 8, 24), 8, 5)
    with pytest.raises(NotImplementedError, match="kernel takes"):
        spa_attn.spa_attn_mxu_fwd(r(1, 8, 8, 24), r(1, 8, 8, 24), r(1, 8, 8, 24), 8, 5)
    with pytest.raises(ValueError, match="no valid query tile"):
        spa_attn.spa_attn_mxu_fwd(r(1, 7, 7, 32), r(1, 7, 7, 32), r(1, 7, 7, 32), 8, 5)
    with pytest.raises(NotImplementedError, match="kernel takes"):
        local_attn_vjp.spa_attn_offset_fwd(r(1, 8, 8, 24), r(1, 8, 8, 24), r(1, 8, 8, 24), 8, 5)
    with pytest.raises(ValueError, match="do not divide"):
        local_attn_vjp.spa_attn_offset_fwd(r(1, 8, 8, 36), r(1, 8, 8, 36), r(1, 8, 8, 36), 8, 5)
    with pytest.raises(ValueError, match="contiguous"):
        local_attn_vjp.spa_attn_offset_fwd(*(r(1, 8, 32, 8).transpose(2, 3) for _ in range(3)),
                                           8, 5)


# ------------------------------------------ per-op kernels K8, K9 and K6 ---

@pytest.mark.cuda
@pytest.mark.parametrize("C,N,A2", [(16, 37, 25), (32, 37, 25), (64, 37, 25), (64, 7, 144),
                                    (64, 3, 169), (32, 11, 9), (64, 2, 400), (16, 1, 1),
                                    (64, 5, 128), (64, 5, 129), (32, 9, 129), (64, 4099, 144),
                                    (16, 3, 400), (32, 3, 400), (64, 11, 32), (64, 11, 33)])
def test_ang_attn_sweep_kernels(cuda_device, C, N, A2):
    """K8 forward, forward with stats and backward against their plain
    versions: every channel width, N that fills no group, view counts of
    one chunk, several chunks, both sides of K7's gate (128 | 129) and past
    it, both sides of the backward's switch from K7's kernel to its own (32
    | 33), N large enough that each persistent block takes several tiles. At
    A2 <= 128 both forwards are K7's bit for bit, and at A2 <= 32 the
    backward K7's. The backward runs from the
    plain forward's (out, m, l) (at one view from its own) and from the
    kernel's own `_res` outputs; both forwards and the backward repeat
    bitwise. Where a case has at least 900 tokens, every output's max error
    against float64 (the backward from the float64 forward's (out, m, l)) is
    at most twice the f32 plain version's (from its own)."""
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    q, k, v, dout = (torch.randn(N, A2, C, device=cuda_device, generator=g) for _ in range(4))
    ref = ang_attn_vjp.ang_attention_sweep_plain(q, k, v, 8)
    reset_launches()
    got_f = ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, 8)
    _close(got_f, ref[0], 1e-4)
    got_r = ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, 8, with_stats=True)
    _close(got_r, ref, 1e-4)
    # at one view p = 1 and dq = dk = 0 exactly, and an m one ulp off the
    # other version's score makes them ~1e-7: there each backward runs from
    # its own forward
    own_res = got_r if A2 > 1 else ref
    res = ref if A2 > 1 else got_r
    got = ang_attn_vjp.ang_attn_sweep_bwd(q, k, v, *res, dout, 8)
    torch.cuda.synchronize()
    assert [LAUNCHES[n] for n in SWEEPS[:3]] == [1, 1, 1]
    assert sum(LAUNCHES.values()) == 3
    ref_b = ang_attn_vjp.ang_attention_sweep_bwd_plain(q, k, v, *ref, dout, 8)
    _close(got, ref_b)
    again = ang_attn_vjp.ang_attn_sweep_bwd(q, k, v, *res, dout, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got_f, ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, 8))
    assert all(torch.equal(a, b)
               for a, b in zip(got_r, ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, 8, with_stats=True)))
    assert torch.equal(got_f, got_r[0])
    # the backward from the kernel's own forward
    own = ang_attn_vjp.ang_attn_sweep_bwd(q, k, v, *got_r, dout, 8)
    _close(own, ang_attn_vjp.ang_attention_sweep_bwd_plain(q, k, v, *own_res, dout, 8))
    assert all(torch.equal(a, b)
               for a, b in zip(own, ang_attn_vjp.ang_attn_sweep_bwd(q, k, v, *got_r, dout, 8)))
    if A2 <= 128:   # K7's kernels, bit for bit
        assert torch.equal(got_f, ang_attn_mxu.ang_attn_fwd(q, k, v, 8))
        assert all(torch.equal(a, b)
                   for a, b in zip(got_r, ang_attn_mxu.ang_attn_fwd(q, k, v, 8, with_stats=True)))
    if A2 <= ang_attn_vjp.K7_BWD_MAX:
        assert all(torch.equal(a, b)
                   for a, b in zip(own, ang_attn_mxu.ang_attn_bwd(q, k, v, *got_r[1:], dout, 8)))
    if N * A2 < 900:
        return
    x64 = [t.double() for t in (q, k, v, dout)]
    e_fwd = ang_attn_mxu.ang_attention_blockdiag_plain(*x64[:3], 8)
    e_bwd = ang_attn_vjp.ang_attention_sweep_bwd_plain(*x64[:3], *e_fwd, x64[3], 8)
    err = lambda a, e: float((a.double() - e).abs().max())
    for name, a, b, e in zip(("out", "m", "l", "dq", "dk", "dv"), (*got_r, *own), (*ref, *ref_b),
                             (*e_fwd, *e_bwd)):
        assert err(a, e) <= 2 * err(b, e), (name, err(a, e), err(b, e))


@pytest.mark.cuda
@pytest.mark.parametrize("C,h,w", [(16, 20, 12), (32, 9, 7), (64, 32, 32), (64, 30, 30),
                                   (64, 7, 7), (64, 8, 101), (64, 3, 2), (64, 1, 1)])
def test_spa_attn_offset_kernels(cuda_device, C, h, w):
    """K9 forward, forward with stats and backward against their plain
    versions: every channel width, views that no tile divides and views
    smaller than the window; each launch counted under K9's name, once; the
    backward repeats bit for bit and does not read the output; K9 launches
    K5's kernels, so every output equals K5's bit for bit, and `SpaOffsetFn`
    saves no output on the card."""
    E = 2 * C
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    q, k, v, dout = (torch.randn(3, h, w, E, device=cuda_device, generator=g) for _ in range(4))
    ref = local_attn_vjp.windowed_attention_offset_plain(q, k, v, 8, 5)
    reset_launches()
    fwd = local_attn_vjp.spa_attn_offset_fwd(q, k, v, 8, 5)
    _close(fwd, ref[0], 1e-4)
    res = local_attn_vjp.spa_attn_offset_fwd(q, k, v, 8, 5, with_stats=True)
    _close(res, ref, 1e-4)
    # the backward from its own forward's (m, l): at 1 x 1 views p = 1 and
    # dq = dk = 0 exactly only with the scores that made m
    out, m, l = res
    got = local_attn_vjp.spa_attn_offset_bwd(q, k, v, out, m, l, dout, 8, 5)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] for n in SWEEPS[3:6]} == \
        {"spa_attn_offset": 1, "spa_attn_offset_res": 1, "spa_attn_offset_bwd": 1}
    assert sum(LAUNCHES.values()) == 3
    _close(got, local_attn_vjp.windowed_attention_offset_bwd_plain(q, k, v, *ref, dout, 8, 5))
    again = local_attn_vjp.spa_attn_offset_bwd(q, k, v, None, m, l, dout, 8, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the same kernels as K5
    assert torch.equal(fwd, spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5))
    assert all(torch.equal(a, b)
               for a, b in zip(res, spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5, with_stats=True)))
    assert all(torch.equal(a, b)
               for a, b in zip(got, spa_attn_hp.spa_attn_hp_bwd(q, k, v, m, l, dout, 8, 5)))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = local_attn_vjp.windowed_attention(*ins, 8, 5)
    assert y.grad_fn.saved_tensors[5] is None
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(y, ins, dout), got))


@pytest.mark.cuda
@pytest.mark.parametrize("C,h,w,tile", [(16, 16, 16, (8, 16)), (32, 8, 101, (8, 1)),
                                        (64, 32, 32, (8, 16)), (64, 64, 64, (8, 16)),
                                        (16, 64, 64, (8, 16)), (64, 72, 40, (8, 8)),
                                        (64, 48, 40, (16, 8)), (64, 4, 32, (4, 32)),
                                        (32, 1, 128, (1, 128)), (64, 128, 1, (128, 1)),
                                        (64, 2, 4, (2, 4))])
def test_spa_attn_mxu_kernels(cuda_device, C, h, w, tile):
    """K6 forward, forward with stats and backward against their plain
    versions over `pick_tile`'s geometries: the usual 8x16, views over 2048
    pixels, partial 16x16 tiles (72x40), the one-column tile of a prime
    width, 1-pixel-wide views and the smallest tile; each launch counted
    under K6's name, once; the backward repeats bit for bit; K6 launches
    K5's kernels, so every output equals K5's bit for bit."""
    assert spa_attn.pick_tile(h, w) == tile
    E = 2 * C
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    q, k, v, dout = (torch.randn(3, h, w, E, device=cuda_device, generator=g) for _ in range(4))
    ref = spa_attn.windowed_attention_mxu_plain(q, k, v, 8, 5)
    reset_launches()
    fwd = spa_attn.spa_attn_mxu_fwd(q, k, v, 8, 5)
    _close(fwd, ref[0], 1e-4)
    res = spa_attn.spa_attn_mxu_fwd(q, k, v, 8, 5, with_stats=True)
    _close(res, ref, 1e-4)
    _, m, l = ref
    got = spa_attn.spa_attn_mxu_bwd(q, k, v, m, l, dout, 8, 5)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] for n in ("spa_attn_mxu", "spa_attn_mxu_res", "spa_attn_mxu_bwd")} \
        == {"spa_attn_mxu": 1, "spa_attn_mxu_res": 1, "spa_attn_mxu_bwd": 1}
    assert sum(LAUNCHES.values()) == 3
    _close(got, spa_attn.windowed_attention_mxu_bwd_plain(q, k, v, m, l, dout, 8, 5))
    again = spa_attn.spa_attn_mxu_bwd(q, k, v, m, l, dout, 8, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the same kernels as K5
    assert torch.equal(fwd, spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5))
    assert all(torch.equal(a, b)
               for a, b in zip(res, spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5, with_stats=True)))
    assert all(torch.equal(a, b)
               for a, b in zip(got, spa_attn_hp.spa_attn_hp_bwd(q, k, v, m, l, dout, 8, 5)))


@pytest.mark.cuda
@pytest.mark.parametrize("ang_res,view", [(5, 32), (9, 8)])
def test_unfused_grads_kernels_match_plain_and_repeat(cuda_device, monkeypatch, ang_res, view):
    """Gradients of the whole model through the per-op kernels against the
    same branch with the kernels' plain versions behind the same autograd
    Functions; the same backward twice is bitwise equal. At the recipe's
    geometry the bound is 5e-4 max |grad| + 2e-9, also against the plain
    unfused path (tiled torch attention). At angRes 9 a training forward
    that asks for the fused branch takes it (K1 with residuals and the
    128-row K4), and `fused=False` still trains through the per-op kernels;
    its small batch
    (10,368 tokens) is held to 1e-2 max |grad| + 1e-8 only: one FFN unit
    whose input lies within f32 rounding of 0 is on in one path and off in
    the other, and that one relu' jump moves a weight gradient by 3e-3 of
    its max (as much as two plain paths differ there). The kernels' own
    accuracy at A2 = 81 is `test_ang_attn_kernels`'s to hold."""
    args = Args(channels=16, scale_factor=2, angRes=ang_res)
    p = lft.init_params(4, args, device=cuda_device)
    for t in p.values():
        t.requires_grad_(True)
    rng = np.random.RandomState(1)
    n = ang_res * view
    lr = torch.from_numpy(rng.rand(2, 1, n, n).astype(np.float32)).to(cuda_device)
    hr = torch.from_numpy(rng.rand(2, 1, 2 * n, 2 * n).astype(np.float32)).to(cuda_device)
    torch.backends.cudnn.deterministic = True

    def grads(**kw):
        sr = lft.forward(p, lr, args, **kw)
        loss = ((sr - hr) * torch.cos(3.0 * (sr - hr))).mean()
        return torch.autograd.grad(loss, list(p.values()))

    reset_launches()
    got = grads(fused=False)
    torch.cuda.synchronize()
    assert [LAUNCHES[n] for n in PEROP] == [0, 4, 4, 0, 4, 4]
    assert not any(LAUNCHES[k] for k in FORWARD)
    assert all(torch.equal(a, b) for a, b in zip(got, grads(fused=False)))
    if ang_res == 5:
        for name, g1, g2 in zip(p, got, grads(fused=False, attention_impl="tiled")):
            err = float((g1 - g2).abs().max())
            assert err <= 5e-4 * float(g2.abs().max()) + 2e-9, (name, err)
    with monkeypatch.context() as mp:
        plain_a = ang_attn_mxu.ang_attention_blockdiag_plain
        plain_s = spa_attn_hp.windowed_attention_headpacked_plain
        mp.setattr(ang_attn_mxu, "ang_attn_fwd",
                   lambda q, k, v, h, with_stats=False: plain_a(q, k, v, h))
        mp.setattr(ang_attn_mxu, "ang_attn_bwd", ang_attn_mxu.ang_attention_blockdiag_bwd_plain)
        mp.setattr(spa_attn_hp, "spa_attn_hp_fwd",
                   lambda q, k, v, h, ks, with_stats=False: plain_s(q, k, v, h, ks))
        mp.setattr(spa_attn_hp, "spa_attn_hp_bwd",
                   spa_attn_hp.windowed_attention_headpacked_bwd_plain)
        reset_launches()
        ref = grads(fused=False)
        assert not any(LAUNCHES.values())
    rel, floor = (5e-4, 2e-9) if ang_res == 5 else (1e-2, 1e-8)
    for name, g1, g2 in zip(p, got, ref):
        err = float((g1 - g2).abs().max())
        assert err <= rel * float(g2.abs().max()) + floor, (name, err, float(g2.abs().max()))
    if ang_res == 9:
        reset_launches()
        auto = grads()
        torch.cuda.synchronize()
        assert LAUNCHES["ang_block_res"] == 4 and LAUNCHES["ang_block_bwd128"] == 4
        assert LAUNCHES["ang_block_bwd"] == 0 and not any(LAUNCHES[k] for k in PEROP)
        assert all(torch.equal(a, b) for a, b in zip(auto, grads()))
        for name, g1, g2 in zip(p, auto, grads(plain_blocks=True)):
            err = float((g1 - g2).abs().max())
            assert err <= rel * float(g2.abs().max()) + floor, (name, err, float(g2.abs().max()))
        with torch.no_grad():
            reset_launches()
            lft.forward(p, lr, args)
            assert LAUNCHES["ang_block"] == 4 and LAUNCHES["ang_attn"] == 0


@pytest.mark.cuda
def test_unfused_train_step_repeats_bitwise(cuda_device):
    """`--train_fused false` on the card: two steps from the same state and
    batch give the same loss and parameters bit for bit."""
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step
    args = Args(channels=32, scale_factor=4, batch_size=2, train_fused="false")
    model = get_model(args)
    init = lft.init_params(6, args, device=cuda_device)
    rng = np.random.RandomState(2)
    lr = torch.from_numpy(rng.rand(2, 1, 160, 160).astype(np.float32)).to(cuda_device)
    hr = torch.from_numpy(rng.rand(2, 1, 640, 640).astype(np.float32)).to(cuda_device)

    def one():
        p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
        step = make_train_step(model, make_optimizer(p, args, steps_per_epoch=10), args)
        loss, _, _ = step(p, lr, hr)
        return float(loss), p

    reset_launches()
    l1, p1 = one()
    torch.cuda.synchronize()
    assert [LAUNCHES[n] for n in PEROP] == [0, 4, 4, 0, 4, 4]
    l2, p2 = one()
    assert l1 == l2 and np.isfinite(l1)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


# ------------------------------- K10, the 128-row K4 and K11 (`TAIL`) ---

@pytest.mark.cuda
@pytest.mark.parametrize("C,B,h,w", [(16, 3, 16, 16), (32, 2, 8, 24), (64, 3, 32, 32),
                                     (64, 2, 64, 64), (64, 5, 8, 8), (32, 1, 40, 16)])
def test_spa_attn_tile_kernel(cuda_device, C, B, h, w):
    """K10 against its plain version: every head width, one-tile views (all
    four borders in one halo), non-square views, the 64x64 views it serves;
    counted once under K10's name; K10 launches K5's forward kernel, so it
    equals K5 and K9 bit for bit, at every tile edge that divides the view."""
    E = 2 * C
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    q, k, v = (torch.randn(B, h, w, E, device=cuda_device, generator=g) for _ in range(3))
    reset_launches()
    got = local_attn.windowed_attention_tile(q, k, v, 8, 5)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_attn_tile"] == 1 and sum(LAUNCHES.values()) == 1
    _close(got, local_attn.windowed_attention_tile_plain(q, k, v, 8, 5), 1e-4)
    assert torch.equal(got, spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5))
    assert torch.equal(got, local_attn_vjp.spa_attn_offset_fwd(q, k, v, 8, 5))
    assert torch.equal(got, local_attn.windowed_attention_tile(q, k, v, 8, 5))
    if h % 16 == 0 and w % 16 == 0:
        assert torch.equal(got, local_attn.windowed_attention_tile(q, k, v, 8, 5, t=16))


@pytest.mark.cuda
def test_spa_dispatch_reaches_tile_kernel_on_card(cuda_device):
    """`offset` on a 48x48 view (2304 pixels) and `tile` on a 32x32 one reach
    K10 with their projections, and equal the tiled torch op."""
    from lft_torch.ops.attention import local_attention
    g = torch.Generator(device=cuda_device).manual_seed(1)
    r = lambda *s: torch.randn(*s, device=cuda_device, generator=g)
    for hw, variant in ((48, "offset"), (32, "tile")):
        qn, v, wi, wo = r(2, hw, hw, 32), r(2, hw, hw, 32), r(96, 32) * 0.2, r(32, 32) * 0.2
        reset_launches()
        got = local_attn.local_attention_pallas(qn, v, wi, wo, 8, variant=variant)
        torch.cuda.synchronize()
        assert {k: c for k, c in LAUNCHES.items() if c} == {"spa_attn_tile": 1}
        _close(got, local_attention(qn, v, wi, wo, 8, impl="tiled"), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,N,A2", [(64, 7, 81), (64, 3, 121), (64, 5, 128), (32, 9, 100),
                                    (16, 6, 65), (64, 1, 81)])
def test_ang_block_bwd128_kernels(cuda_device, C, N, A2):
    """K4 for 64 < A2 <= 128 (its three kernels, counted as
    `ang_block_bwd128`) against its plain version from K1's residuals: every
    channel width, token counts that leave the last 128-row tile ragged;
    with `wgrad`/`colsum` the whole block backward; twice bit for bit."""
    p = _params(C, cuda_device, seed=A2)
    wts = ang_block.ang_weights(p, "altblock.2.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g)
    dout = torch.randn(N, A2, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    res = ang_block.ang_block(x, pe, wts, 8, with_res=True)
    ref = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True)
    _close(res, ref, 1e-4)
    _, m, l, attn = ref
    reset_launches()
    ops = ang_block.ang_block_bwd_ops(x, pe, wts, m, l, attn, dout, 8)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_block_bwd128"] == 1 and LAUNCHES["ang_block_bwd"] == 0
    assert ops[-1].shape == (-(-N * A2 // 128), 4, C)
    ops_ref = ang_block.ang_block_bwd_ops_plain(x, pe, wts, m, l, attn, dout, 8)
    _close(ops[:-1], ops_ref[:-1])
    _close(ops[-1].sum(0, keepdim=True), ops_ref[-1])
    got = ang_block.ang_block_bwd(x, pe, wts, m, l, attn, dout, 8)
    _close(got, ang_block.ang_block_bwd_plain(x, pe, wts, m, l, attn, dout, 8))
    again = ang_block.ang_block_bwd(x, pe, wts, m, l, attn, dout, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("C,Bb,h,w,A2", [(16, 2, 8, 8, 4), (32, 1, 9, 7, 25), (64, 2, 32, 32, 25),
                                         (64, 1, 17, 40, 9), (64, 3, 16, 16, 81)])
def test_spa_block_pixel_major_kernels(cuda_device, C, Bb, h, w, A2):
    """K11: the two `_pm` kernels against their plain versions, the chained
    block against its plain version and against view-major K2 on a permuted
    copy (the same arithmetic: bit for bit); a call that needs grad raises."""
    p = _params(C, cuda_device, seed=h)
    prefix = "altblock.1.spa_trans."
    wts = spa_block.spa_weights(p, prefix)
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    x = torch.randn(Bb, h, w, A2, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    xv = x.permute(0, 3, 1, 2, 4).reshape(Bb * A2, h, w, C).contiguous()
    tok, xn = spa_block.tokenize_ln_plain(xv, pe_tok, wts)
    _close(spa_block.tokenize_ln(x, pe_tok, wts, pixel_major=True), (tok, xn), 1e-4)
    x2, xn2 = torch.randn_like(tok), torch.randn_like(tok)
    ref = spa_block.ffn_out_plain(xn2, x2, wts).reshape(Bb, A2, h, w, C).permute(0, 2, 3, 1, 4)
    _close(spa_block.ffn_out(xn2, x2, wts, views=A2), ref.contiguous(), 1e-4)
    reset_launches()
    got = spa_block.spa_trans_block_fused(x, pe_tok, p, prefix, 8, 5, pixel_major=True)
    torch.cuda.synchronize()
    assert {k: c for k, c in LAUNCHES.items() if c} == dict.fromkeys(
        ("spa_tokenize_ln_pm", "spa_qkv", "spa_window_attn", "spa_outproj_ln", "spa_ffn_out_pm"), 1)
    assert got.shape == x.shape
    _close(got, spa_block.spa_trans_block_plain(x, pe_tok, p, prefix, 8, 5, pixel_major=True),
           1e-4)
    vm = spa_block.spa_trans_block_fused(xv, pe_tok, p, prefix, 8, 5)
    assert torch.equal(got, vm.reshape(Bb, A2, h, w, C).permute(0, 2, 3, 1, 4))
    with pytest.raises(ValueError, match="inference-only"):
        spa_block.spa_trans_block_fused(x.clone().requires_grad_(), pe_tok, p, prefix, 8, 5,
                                        pixel_major=True)
    assert set(TAIL) <= set(LAUNCHES)


# ------------------------------------- the tokenization on the tensor cores ---

def _f64_err(got, ref, exact):
    """(max |kernel - float64|, max |f32 plain - float64|, max |float64|)."""
    e = lambda t: float((t.double() - exact).abs().max())
    return e(got), e(ref), float(exact.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("C,h,w", [(64, 32, 32), (64, 17, 40), (32, 30, 30), (16, 64, 64)])
def test_tokenize_kernels_3xtf32(cuda_device, C, h, w):
    """K2.1 and K3.e run 3xTF32 on the tensor cores: tok and dx against
    float64 no worse than twice the f32 plain version's error (TF32 off),
    tok, xn and dx against the plain versions, one launch each, bitwise
    repeatable."""
    p = _params(C, cuda_device, seed=h + w)
    wts = spa_block._with_mlp(spa_block.spa_weights(p, "altblock.2.spa_trans."))
    g = torch.Generator(device=cuda_device).manual_seed(C * h + w)
    x = torch.randn(3, h, w, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    dtok = torch.randn(3, h, w, 2 * C, device=cuda_device, generator=g)
    reset_launches()
    tok, xn = spa_block.tokenize_ln(x, pe_tok, wts)
    dx = spa_block.tokenize_bwd(dtok, wts)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_tokenize_ln"] == 1 and LAUNCHES["spa_tokenize_bwd"] == 1
    tok_p, xn_p = spa_block.tokenize_ln_plain(x, pe_tok, wts)
    _close((tok, xn), (tok_p, xn_p), 1e-4)
    err, err_f32, top = _f64_err(tok, tok_p, unfold3x3_linear(x.double(), wts["mlp"].double()))
    assert err <= 2 * err_f32 + 1e-7 * top, (err, err_f32)
    dx_p = spa_block.tokenize_bwd_plain(dtok, wts)
    _close(dx, dx_p, 1e-4)
    err, err_f32, top = _f64_err(dx, dx_p, spa_block.tokenize_bwd_plain(
        dtok.double(), dict(mlp=wts["mlp"].double())))
    assert err <= 2 * err_f32 + 1e-7 * top, (err, err_f32)
    again = spa_block.tokenize_ln(x, pe_tok, wts)
    assert torch.equal(tok, again[0]) and torch.equal(xn, again[1])
    assert torch.equal(dx, spa_block.tokenize_bwd(dtok, wts))


@pytest.mark.cuda
@pytest.mark.parametrize("C,Bb,h,w,A2", [(64, 2, 32, 32, 25), (32, 1, 9, 7, 25), (16, 3, 30, 30, 4)])
def test_tokenize_pm_kernel_3xtf32(cuda_device, C, Bb, h, w, A2):
    """K11.1 on a pixel-major buffer: tok against float64 as K2.1, equal bit
    for bit to K2.1 on a view-major copy, bitwise repeatable."""
    p = _params(C, cuda_device, seed=A2)
    wts = spa_block._with_mlp(spa_block.spa_weights(p, "altblock.3.spa_trans."))
    g = torch.Generator(device=cuda_device).manual_seed(C + Bb + A2)
    x = torch.randn(Bb, h, w, A2, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    xv = x.permute(0, 3, 1, 2, 4).reshape(Bb * A2, h, w, C).contiguous()
    reset_launches()
    tok, xn = spa_block.tokenize_ln(x, pe_tok, wts, pixel_major=True)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_tokenize_ln_pm"] == 1 and LAUNCHES["spa_tokenize_ln"] == 0
    tok_p, xn_p = spa_block.tokenize_ln_plain(xv, pe_tok, wts)
    _close((tok, xn), (tok_p, xn_p), 1e-4)
    err, err_f32, top = _f64_err(tok, tok_p, unfold3x3_linear(xv.double(), wts["mlp"].double()))
    assert err <= 2 * err_f32 + 1e-7 * top, (err, err_f32)
    vm = spa_block.tokenize_ln(xv, pe_tok, wts)
    assert torch.equal(tok, vm[0]) and torch.equal(xn, vm[1])
    again = spa_block.tokenize_ln(x, pe_tok, wts, pixel_major=True)
    assert torch.equal(tok, again[0]) and torch.equal(xn, again[1])


# ------------------------------- the row-tile products on the tensor cores ---

@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w,A2", [(3, 9, 7, None), (4, 9, 7, 2), (20, 31, 33, None)])
def test_ffn_out_kernels_3xtf32(cuda_device, C, V, h, w, A2):
    """K2.5 (A2 None) and K11.5 run 3xTF32 on the tensor cores: against the
    plain version, against float64 within twice the f32 plain version's
    error (TF32 off), one launch, bitwise repeatable. T = V h w is no
    multiple of the 128-row tile, and at 20 x 31 x 33 blocks take two tiles
    each."""
    p = _params(C, cuda_device, seed=C + V)
    wts = spa_block.spa_weights(p, "altblock.1.spa_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C * V + h)
    xn2 = torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g)
    x2 = torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g)
    name = "spa_ffn_out" if A2 is None else "spa_ffn_out_pm"
    reset_launches()
    got = spa_block.ffn_out(xn2, x2, wts, A2)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    ref = spa_block.ffn_out_plain(xn2, x2, wts)
    exact = spa_block.ffn_out_plain(xn2.double(), x2.double(),
                                    {k: v.double() for k, v in wts.items()})
    if A2 is not None:
        ref, exact = spa_block._to_pixel_major(ref, A2), spa_block._to_pixel_major(exact, A2)
    torch.testing.assert_close(got, ref, **TOL)
    err, err_f32, _ = _f64_err(got, ref, exact)
    assert err <= 2 * err_f32, (err, err_f32)
    assert torch.equal(got, spa_block.ffn_out(xn2, x2, wts, A2))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(25, 37), (25, 703), (81, 150), (121, 140)])
def test_ang_block_kernels_3xtf32(cuda_device, C, A2, N):
    """K1 and its residual form run 3xTF32 on the tensor cores: against the
    plain versions (the forward within 1e-4, the residual form within 5e-4
    max |plain| per output), against float64 within twice the f32 plain
    version's error (TF32 off), one launch each, bitwise repeatable. The
    last tile is ragged at A2 = 25 (N % 5 != 0); at A2 = 81, 121 a tile is
    one pixel and pad rows; past 132 tiles blocks take several."""
    p = _params(C, cuda_device, seed=A2)
    wts = ang_block.ang_weights(p, "altblock.0.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + N)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    reset_launches()
    got = ang_block.ang_block(x, pe, wts, 8)
    res = ang_block.ang_block(x, pe, wts, 8, with_res=True)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_block"] == 1 and LAUNCHES["ang_block_res"] == 1
    ref = ang_block.ang_block_plain(x, pe, wts, 8)
    torch.testing.assert_close(got, ref, **TOL)
    _close(res, ang_block.ang_block_plain(x, pe, wts, 8, with_res=True))
    exact = ang_block.ang_block_plain(x.double(), pe.double(),
                                      {k: v.double() for k, v in wts.items()}, 8)
    for out in (got, res[0]):
        err, err_f32, _ = _f64_err(out, ref, exact)
        assert err <= 2 * err_f32, (err, err_f32)
    assert torch.equal(got, ang_block.ang_block(x, pe, wts, 8))
    again = ang_block.ang_block(x, pe, wts, 8, with_res=True)
    assert all(torch.equal(a, b) for a, b in zip(res, again))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (20, 31, 33)])
def test_qkv_outproj_kernels_3xtf32(cuda_device, C, V, h, w):
    """K2.2 and K2.4 run 3xTF32 on the tensor cores: q, k, v and x2, xn2
    against the plain versions (1e-4 max(1, max |plain|)), each against
    float64 within twice the f32 plain version's error (TF32 off), one
    launch each, bitwise repeatable. T = V h w is no multiple of the 128-row
    tile, and at 20 x 31 x 33 blocks take two tiles each."""
    p = _params(C, cuda_device, seed=C + V)
    wts = spa_block.spa_weights(p, "altblock.2.spa_trans.")
    w64 = {k: v.double() for k, v in wts.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C * V + w)
    xn, tok, attn = (torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g)
                     for _ in range(3))
    reset_launches()
    qkv = spa_block.qkv(xn, tok, wts)
    out = spa_block.outproj_ln(attn, tok, wts)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_qkv"] == 1 and LAUNCHES["spa_outproj_ln"] == 1
    assert sum(LAUNCHES.values()) == 2
    for got, ref, exact in ((qkv, spa_block.qkv_plain(xn, tok, wts),
                             spa_block.qkv_plain(xn.double(), tok.double(), w64)),
                            (out, spa_block.outproj_ln_plain(attn, tok, wts),
                             spa_block.outproj_ln_plain(attn.double(), tok.double(), w64))):
        for u, r, e in zip(got, ref, exact):
            torch.testing.assert_close(u, r, atol=1e-4 * max(1.0, float(r.abs().max())),
                                       rtol=0)
            err, err_f32, _ = _f64_err(u, r, e)
            assert err <= 2 * err_f32, (err, err_f32)
    assert all(torch.equal(a, b) for a, b in zip(qkv, spa_block.qkv(xn, tok, wts)))
    assert all(torch.equal(a, b) for a, b in zip(out, spa_block.outproj_ln(attn, tok, wts)))


@pytest.mark.cuda
def test_spa_chains_and_fused_grads_through_new_projections(cuda_device):
    """At C = 64: the K2 chain with residuals and the K11 chain against
    their plain versions, and the model's gradients through the fused
    blocks (K2.2 and K2.4 in SpaBlockFn's forward, 4 launches each) against
    the plain blocks."""
    C = 64
    p = _params(C, cuda_device, seed=8)
    prefix = "altblock.0.spa_trans."
    wts = spa_block.spa_weights(p, prefix)
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn(5, 32, 32, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(32, 32, 2 * C, device=cuda_device, generator=g)
    _close(spa_block.spa_block(x, pe_tok, wts, 8, 5, with_res=True),
           spa_block.spa_block_plain(x, pe_tok, wts, 8, 5, with_res=True), 1e-4)
    xp = torch.randn(2, 16, 16, 25, C, device=cuda_device, generator=g)
    pe16 = torch.randn(16, 16, 2 * C, device=cuda_device, generator=g)
    _close(spa_block.spa_trans_block_fused(xp, pe16, p, prefix, 8, 5, pixel_major=True),
           spa_block.spa_trans_block_plain(xp, pe16, p, prefix, 8, 5, pixel_major=True), 1e-4)

    args = Args(channels=C, scale_factor=2)
    for t in p.values():
        t.requires_grad_(True)
    rng = np.random.RandomState(2)
    lr = torch.from_numpy(rng.rand(1, 1, 160, 160).astype(np.float32)).to(cuda_device)
    hr = torch.from_numpy(rng.rand(1, 1, 320, 320).astype(np.float32)).to(cuda_device)

    def grads(plain):
        sr = lft.forward(p, lr, args, plain_blocks=plain)
        loss = ((sr - hr) * torch.cos(3.0 * (sr - hr))).mean()
        return torch.autograd.grad(loss, list(p.values()))

    reset_launches()
    got = grads(False)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_qkv"] == 4 and LAUNCHES["spa_outproj_ln"] == 4
    for name, g1, g2 in zip(p, got, grads(True)):
        err = float((g1 - g2).abs().max())
        assert err <= 5e-4 * float(g2.abs().max()) + 2e-9, (name, err)


def _calm_relu(dout, hid_k, hid_p):
    """dout with a zero cotangent on the tokens where an FFN ReLU is on in
    one version and off in the other (its input within f32 rounding of 0):
    dpre jumps there by design, not by the kernel's arithmetic."""
    flips = ((hid_k > 0) != (hid_p > 0)).reshape(-1, hid_k.shape[-1]).any(-1)
    assert int(flips.sum()) <= max(2, flips.numel() // 1000), int(flips.sum())
    dout = dout.clone()
    dout.reshape(-1, dout.shape[-1])[flips] = 0.0
    return dout


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (20, 31, 33)])
def test_ffn_out_bwd_kernel_3xtf32(cuda_device, C, V, h, w):
    """K3.a runs its seven products 3xTF32 on the tensor cores: every output
    against the plain version (5e-4 max |plain|, the LN2 sums summed over
    their per-tile rows), dx2, dattn, y, dy, xn2 and the LN2 sums against
    float64 within twice the f32 plain version's error (TF32 off) plus
    1e-7 max |float64| (as test_wgrad_kernels: at C = 16 dy is one 16-deep
    chain, and over T = 189 tokens the f32 product's max error is a small
    sample), one launch, one row of sums a 128-row tile, bitwise repeatable.
    T = V h w is no multiple of 128, and at 20 x 31 x 33 blocks take several
    tiles."""
    p = _params(C, cuda_device, seed=C + V)
    wts = spa_block.spa_weights(p, "altblock.1.spa_trans.")
    w64 = {k: v.double() for k, v in wts.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C * V + h)
    D = 2 * C
    attn = 0.3 * torch.randn(V, h, w, D, device=cuda_device, generator=g)
    tok = torch.randn(V, h, w, D, device=cuda_device, generator=g)
    dout = torch.randn(V, h, w, C, device=cuda_device, generator=g)
    dout = _calm_relu(dout, spa_block.ffn_out_bwd(attn, tok, dout, wts)[4],
                      spa_block.ffn_out_bwd_plain(attn, tok, dout, wts)[4])
    reset_launches()
    got = spa_block.ffn_out_bwd(attn, tok, dout, wts)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_ffn_out_bwd"] == 1 and sum(LAUNCHES.values()) == 1
    T = V * h * w
    assert got[-1].shape == (-(-T // 128), 2, D)
    ref = spa_block.ffn_out_bwd_plain(attn, tok, dout, wts)
    exact = spa_block.ffn_out_bwd_plain(attn.double(), tok.double(), dout.double(), w64)
    summed = lambda o: (*o[:-1], o[-1].sum(0, keepdim=True))
    _close(summed(got), ref)
    for i in (0, 1, 2, 3, 6, 7):
        err, err_f32, scale = _f64_err(summed(got)[i], ref[i], exact[i])
        assert err <= 2 * err_f32 + 1e-7 * scale, (i, err, err_f32)
    assert all(torch.equal(a, b) for a, b in zip(got, spa_block.ffn_out_bwd(attn, tok, dout, wts)))


@pytest.mark.cuda
@pytest.mark.parametrize("C,V,h,w", [(64, 5, 32, 32), (32, 3, 9, 7), (16, 4, 31, 33)])
def test_ffn_out_bwd_recomputes_the_forwards_xn2_bitwise(cuda_device, C, V, h, w):
    """K3.a recomputes x2 and xn2 with K2.4's own pass arithmetic: fed the
    same attn, tok and weights, its xn2 equals K2.4's bit for bit."""
    p = _params(C, cuda_device, seed=V)
    wts = spa_block.spa_weights(p, "altblock.0.spa_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    attn, tok = (torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g) for _ in range(2))
    dout = torch.randn(V, h, w, C, device=cuda_device, generator=g)
    _, xn2 = spa_block.outproj_ln(attn, tok, wts)
    assert torch.equal(spa_block.ffn_out_bwd(attn, tok, dout, wts)[6], xn2)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 8, 8), (2, 16, 16), (2, 30, 30), (3, 32, 32), (2, 17, 40)])
def test_window_attn_kernels(cuda_device, C, V, h, w):
    """K2.3 and K2.3 res: attn (and m, l) against the plain versions within
    1e-4 max(1, max |plain|), against float64 within twice the f32 plain
    version's error plus 1e-7 max |float64|, one launch each, bitwise
    repeatable."""
    g = torch.Generator(device=cuda_device).manual_seed(C + V * h + w)
    q, k, v = (torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g) for _ in range(3))
    reset_launches()
    got = spa_block.window_attn(q, k, v, 8, 5)
    res = spa_block.window_attn(q, k, v, 8, 5, with_stats=True)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_window_attn"] == 1 and LAUNCHES["spa_window_attn_res"] == 1
    ref = spa_block.window_attn_plain(q, k, v, 8, 5)
    exact = spa_block.window_attn_plain(q.double(), k.double(), v.double(), 8, 5)
    for u, r, e in zip((got, *res), (ref[0], *ref), (exact[0], *exact)):
        torch.testing.assert_close(u, r, atol=1e-4 * max(1.0, float(r.abs().max())), rtol=0)
        err, err_f32, scale = _f64_err(u, r, e)
        assert err <= 2 * err_f32 + 1e-7 * scale, (err, err_f32)
    assert torch.equal(got, res[0])
    assert torch.equal(got, spa_block.window_attn(q, k, v, 8, 5))
    assert all(torch.equal(a, b) for a, b in zip(res, spa_block.window_attn(q, k, v, 8, 5, True)))


@pytest.mark.cuda
def test_fused_grads_through_new_ffn_bwd_and_window_step(cuda_device, monkeypatch):
    """At C = 64 the model's gradients through the fused blocks, with K2.3
    res in SpaBlockFn's forward and K3.a in its backward (4 launches each),
    against the plain blocks, and a bitwise repeat (cuDNN held to its
    deterministic algorithms, as the trainer holds it)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    C = 64
    p = _params(C, cuda_device, seed=9)
    args = Args(channels=C, scale_factor=2)
    for t in p.values():
        t.requires_grad_(True)
    rng = np.random.RandomState(5)
    lr = torch.from_numpy(rng.rand(1, 1, 160, 160).astype(np.float32)).to(cuda_device)
    hr = torch.from_numpy(rng.rand(1, 1, 320, 320).astype(np.float32)).to(cuda_device)

    def grads(plain):
        sr = lft.forward(p, lr, args, plain_blocks=plain)
        loss = ((sr - hr) * torch.cos(3.0 * (sr - hr))).mean()
        return torch.autograd.grad(loss, list(p.values()))

    reset_launches()
    got = grads(False)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_ffn_out_bwd"] == 4 and LAUNCHES["spa_window_attn_res"] == 4
    for name, g1, g2 in zip(p, got, grads(True)):
        err = float((g1 - g2).abs().max())
        assert err <= 5e-4 * float(g2.abs().max()) + 2e-9, (name, err)
    assert all(torch.equal(a, b) for a, b in zip(got, grads(False)))


# ------------------------------------------ widths the kernels do not take ---

@pytest.mark.cuda
def test_c48_model_runs_plain_on_card(cuda_device):
    """A C = 48 model on the card: the forward, a tiled scene and a train
    step take the plain torch ops (no kernel launched) and equal the plain
    unfused path; an explicit request for a kernel still raises."""
    from lft_torch.inference.tiled import ScenePipelineCache
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step
    args = Args(channels=48, scale_factor=2, patch_size_for_test=16, stride_for_test=8,
                eval_batch=4, batch_size=2)
    p = _params(48, cuda_device, seed=4)
    rng = np.random.RandomState(1)
    lr = torch.from_numpy(rng.rand(2, 1, 80, 80).astype(np.float32)).to(cuda_device)
    mosaic = torch.from_numpy(rng.rand(120, 120).astype(np.float32)).to(cuda_device)
    reset_launches()
    got = lft.forward(p, lr, args)
    sr = ScenePipelineCache(lft.forward, args)(p, mosaic)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    step = make_train_step(get_model(args), make_optimizer(params, args, 10), args,
                           with_metrics=False)
    hr = torch.from_numpy(rng.rand(2, 1, 160, 160).astype(np.float32)).to(cuda_device)
    loss, _, _ = step(params, lr, hr)
    torch.cuda.synchronize()
    assert not any(LAUNCHES.values()), {k: n for k, n in LAUNCHES.items() if n}
    assert torch.isfinite(loss) and torch.isfinite(sr).all() and sr.shape == (240, 240)
    torch.testing.assert_close(got, lft.forward(p, lr, args, fused=False, attention_impl="tiled"),
                               **TOL)
    with pytest.raises(NotImplementedError):
        lft.forward(p, lr, args, fused=False, attention_impl="pallas")
    x = torch.randn(10, 25, 48, device=cuda_device)
    pe = torch.from_numpy(angular_position(25, 48)).to(cuda_device)
    with pytest.raises(NotImplementedError):
        ang_block.ang_trans_block_fused(x, pe, p, "altblock.0.ang_trans.", 8)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(4, 301), (25, 37), (64, 9), (81, 7), (128, 5)])
def test_ang_block_bwd_kernels_3xtf32(cuda_device, C, A2, N):
    """K4's steps a and c run their products 3xTF32 on the tensor cores: every
    output against float64 within twice the f32 plain version's error (TF32
    off) plus 1e-7 max |float64| (the LN sums summed over their per-tile
    rows; dout zero on the tokens of a ReLU flip), against the plain version
    on the same inputs within 5e-4 max |plain|, one launch (`ang_block_bwd`
    at A2 <= 64, `ang_block_bwd128` beyond), one row of LN sums a 128-row
    tile, bitwise repeatable. T = N A2 leaves the last tile ragged; at A2 = 4
    a block of step b takes 8 pixels. Each version takes the residuals m, l,
    attn of its own forward, as in a train step (K1 res for the kernel, the
    plain and the float64 forward for the others): the softmax (m, l) fits
    the scores of the forward that made it."""
    p = _params(C, cuda_device, seed=C + A2)
    wts = ang_block.ang_weights(p, "altblock.1.ang_trans.")
    w64 = {k: v.double() for k, v in wts.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C * A2 + N)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g)
    dout = torch.randn(N, A2, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    res_k = ang_block.ang_block(x, pe, wts, 8, with_res=True)[1:]
    res_p = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True)[1:]
    res_e = ang_block.ang_block_plain(x.double(), pe.double(), w64, 8, with_res=True)[1:]
    kern = lambda d: ang_block.ang_block_bwd_ops(x, pe, wts, *res_k, d, 8)
    plain = lambda d: ang_block.ang_block_bwd_ops_plain(x, pe, wts, *res_p, d, 8)
    f64 = lambda d: ang_block.ang_block_bwd_ops_plain(x.double(), pe.double(), w64, *res_e,
                                                      d.double(), 8)
    dout = _calm_relu(dout, kern(dout)[8], plain(dout)[8])
    dout = _calm_relu(dout, kern(dout)[8], f64(dout)[8])
    reset_launches()
    got = kern(dout)
    torch.cuda.synchronize()
    name = "ang_block_bwd128" if A2 > 64 else "ang_block_bwd"
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    assert got[-1].shape == (-(-N * A2 // 128), 4, C)
    summed = (*got[:-1], got[-1].sum(0, keepdim=True))
    _close(summed, ang_block.ang_block_bwd_ops_plain(x, pe, wts, *res_k, dout, 8))
    for i, (u, r, e) in enumerate(zip(summed, plain(dout), f64(dout))):
        err, err_f32, scale = _f64_err(u, r, e)
        assert err <= 2 * err_f32 + 1e-7 * scale, (i, err, err_f32)
    assert all(torch.equal(a, b) for a, b in zip(got, kern(dout)))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (20, 31, 33)])
def test_qkv_ln_bwd_kernel_3xtf32(cuda_device, C, V, h, w):
    """K3.d runs its three products 3xTF32 on the tensor cores (one pass at
    C <= 32, three at C = 64): dtok, dtokpe and the LN1 sums (summed over
    their per-tile rows) against float64 within twice the f32 plain
    version's error plus 1e-7 max |float64| and against the plain version
    within 5e-4 max |plain|, one launch, one row of sums a 128-row tile,
    bitwise repeatable."""
    p = _params(C, cuda_device, seed=C + w)
    wts = spa_block.spa_weights(p, "altblock.2.spa_trans.")
    w64 = {k: v.double() for k, v in wts.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C + V * h)
    D = 2 * C
    tok = torch.randn(V, h, w, D, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, D, device=cuda_device, generator=g)
    dq, dk, dv = (0.5 * torch.randn(V, h, w, D, device=cuda_device, generator=g) for _ in range(3))
    dx2 = torch.randn(V, h, w, D, device=cuda_device, generator=g)
    args = (tok, pe_tok, dq, dk, dv, dx2)
    reset_launches()
    got = spa_block.qkv_ln_bwd(*args, wts)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_qkv_ln_bwd"] == 1 and sum(LAUNCHES.values()) == 1
    assert got[-1].shape == (-(-V * h * w // 128), 2, D)
    ref = spa_block.qkv_ln_bwd_plain(*args, wts)
    exact = spa_block.qkv_ln_bwd_plain(*(t.double() for t in args), w64)
    summed = (*got[:-1], got[-1].sum(0, keepdim=True))
    _close(summed, ref)
    for i, (u, r, e) in enumerate(zip(summed, ref, exact)):
        err, err_f32, scale = _f64_err(u, r, e)
        assert err <= 2 * err_f32 + 1e-7 * scale, (i, err, err_f32)
    assert all(torch.equal(a, b) for a, b in zip(got, spa_block.qkv_ln_bwd(*args, wts)))


def _bf16_close(got, ref, ref32, gap=0.1, ulps=1.0):
    """A `_bf16io` kernel against its plain bf16 version: L2 within `gap` of
    the plain bf16-vs-f32 distance, every element within `ulps` bf16 ulps of
    max |plain| (an f32 sum in another order rounds to the neighbouring bf16
    value now and then; chip_smoke.py's BF16_GAP, BF16_ULPS)."""
    for g, r, r32 in zip(got, ref, ref32):
        assert g.dtype == r.dtype == torch.bfloat16 and g.shape == r.shape
        g, r, r32 = g.double(), r.double(), r32.double()
        d, d32 = float((g - r).norm() / r.norm()), float((r32 - r).norm() / r.norm())
        assert d <= gap * d32, (d, d32)
        ulp = 2.0 ** (np.floor(np.log2(float(r.abs().max()))) - 7)
        assert float((g - r).abs().max()) <= ulps * ulp


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(25, 37), (81, 7)])
def test_ang_block_bf16io_kernel(cuda_device, C, A2, N):
    pb = {k: v.bfloat16() for k, v in _params(C, cuda_device).items()}
    wts = ang_block.ang_weights(pb, "altblock.1.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g).bfloat16()
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    reset_launches()
    got = ang_block.ang_block(x, pe, wts, 8)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_block_bf16io"] == 1 and LAUNCHES["ang_block"] == 0
    ref32 = ang_block.ang_block_plain(x.float(), pe, {k: v.float() for k, v in wts.items()}, 8)
    _bf16_close((got,), (ang_block.ang_block_plain(x, pe, wts, 8),), (ref32,))
    assert torch.equal(got, ang_block.ang_block(x, pe, wts, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (2, 17, 40), (2, 32, 32)])
def test_spa_block_bf16io_kernels(cuda_device, C, V, h, w):
    """Each of K2's five `_bf16io` steps from its plain predecessor's bf16
    output, and the five chained."""
    pb = {k: v.bfloat16() for k, v in _params(C, cuda_device).items()}
    ws = spa_block.spa_weights(pb, "altblock.2.spa_trans.")
    ws32 = {k: v.float() for k, v in ws.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    x = torch.randn(V, h, w, C, device=cuda_device, generator=g).bfloat16()
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g).bfloat16()
    f = lambda ts: [t.float() for t in ts]
    reset_launches()
    steps = [(spa_block.tokenize_ln, spa_block.tokenize_ln_plain, (x, pe_tok))]
    tok, xn = spa_block.tokenize_ln_plain(x, pe_tok, ws)
    q, k, v = spa_block.qkv_plain(xn, tok, ws)
    attn = spa_block.window_attn_plain(q, k, v, 8, 5)[0]
    x2, xn2 = spa_block.outproj_ln_plain(attn, tok, ws)
    steps += [(spa_block.qkv, spa_block.qkv_plain, (xn, tok)),
              (spa_block.outproj_ln, spa_block.outproj_ln_plain, (attn, tok)),
              (spa_block.ffn_out, spa_block.ffn_out_plain, (xn2, x2))]
    for kern, plain, ins in steps:
        got = kern(*ins, ws)
        got = got if isinstance(got, tuple) else (got,)
        ref, ref32 = plain(*ins, ws), plain(*f(ins), ws32)
        _bf16_close(got, ref if isinstance(ref, tuple) else (ref,),
                    ref32 if isinstance(ref32, tuple) else (ref32,))
    got = spa_block.window_attn(q, k, v, 8, 5)
    _bf16_close((got,), (attn,), (spa_block.window_attn_plain(*f((q, k, v)), 8, 5)[0],))
    torch.cuda.synchronize()
    assert all(LAUNCHES[n + "_bf16io"] == 1 for n in FORWARD if n.startswith("spa_"))
    assert not any(LAUNCHES[n] for n in FORWARD)
    chained = spa_block.spa_block(x, pe_tok, ws, 8, 5)
    assert chained.dtype == torch.bfloat16 and torch.isfinite(chained.float()).all()


@pytest.mark.cuda
def test_bf16_forward_kernels_match_plain_blocks(cuda_device):
    """The bf16 forward on the card: the kernels' distance from the f32
    forward within 10% of the plain blocks' (tests/test_torch_bf16.py says
    why L2 between two bf16 forwards does not tell them apart), and only
    the `_bf16io` kernels launched."""
    from lft_torch.kernels import BF16IO
    args = Args(channels=16, scale_factor=2, dtype="bfloat16")
    p = _params(16, cuda_device, seed=3)
    lr = torch.from_numpy(np.random.RandomState(0).rand(2, 1, 80, 80).astype(np.float32))
    lr = lr.to(cuda_device)
    reset_launches()
    got = lft.forward(p, lr, args)
    torch.cuda.synchronize()
    assert all(LAUNCHES[n] == 4 for n in BF16IO)
    assert sum(LAUNCHES.values()) == 4 * len(BF16IO)
    ref = lft.forward(p, lr, args, plain_blocks=True)
    f32 = lft.forward(p, lr, Args(channels=16, scale_factor=2))
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    assert got.dtype == torch.float32 and abs(l2(got, f32) / l2(ref, f32) - 1) <= 0.1
    assert l2(got, ref) <= 1.5 * l2(ref, f32)


@pytest.mark.cuda
def test_bf16_raises_where_no_kernel_is_ported(cuda_device):
    """A bf16 tensor at K11's pixel-major launches takes their `_bf16io`
    instances (ROADMAP 9f); the per-op `_res` forms
    and backwards launch their `_bf16io` instances (9e); K10 under grad
    raises ValueError; a bf16-IO launcher given an f32 tensor raises
    TypeError; a width the kernels do not take runs the plain torch ops
    under bfloat16, launching nothing, and trains on them."""
    pb = {k: v.bfloat16() for k, v in _params(16, cuda_device).items()}
    wa = ang_block.ang_weights(pb, "altblock.0.ang_trans.")
    ws = spa_block.spa_weights(pb, "altblock.0.spa_trans.")
    x = torch.zeros(4, 25, 16, device=cuda_device, dtype=torch.bfloat16)
    pe = torch.from_numpy(angular_position(25, 16)).to(cuda_device)
    q_bf = torch.zeros(2, 8, 8, 32, device=cuda_device, dtype=torch.bfloat16)
    m_f = torch.ones(2, 8, 8, 8, device=cuda_device)
    reset_launches()
    grads = spa_attn_hp.spa_attn_hp_bwd(q_bf, q_bf, q_bf, m_f, m_f, q_bf, 8, 5)
    out = spa_attn_hp.spa_attn_hp_fwd(q_bf, q_bf, q_bf, 8, 5, with_stats=True)
    res = ang_attn_mxu.ang_attn_fwd(x, x, x, 8, with_stats=True)
    torch.cuda.synchronize()
    assert grads[0].dtype == out[0].dtype == res[0].dtype == torch.bfloat16
    assert (LAUNCHES["spa_attn_hp_bwd_bf16io"], LAUNCHES["spa_attn_hp_res_bf16io"],
            LAUNCHES["ang_attn_res_bf16io"]) == (1, 1, 1)
    with pytest.raises(ValueError, match="K10.*forward-only"):
        local_attn.windowed_attention_tile(q_bf.clone().requires_grad_(True), q_bf, q_bf, 8, 5, 8)
    xs = torch.zeros(1, 8, 8, 25, 16, device=cuda_device, dtype=torch.bfloat16)
    reset_launches()
    spa_block.tokenize_ln(xs, torch.zeros(8, 8, 32, device=cuda_device, dtype=torch.bfloat16), ws,
                          pixel_major=True)
    torch.cuda.synchronize()
    assert {k_: c for k_, c in LAUNCHES.items() if c} == {"spa_tokenize_ln_pm_bf16io": 1}
    q = torch.zeros(2, 8, 8, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="spa_attn_hp_bf16io"):
        spa_attn_hp.spa_attn_hp_fwd(q, q.float(), q, 8, 5)
    p48 = _params(48, cuda_device)
    reset_launches()
    with torch.no_grad():
        out = lft.forward(p48, torch.rand(1, 1, 40, 40, device=cuda_device),
                          Args(channels=48, scale_factor=2, dtype="bfloat16"))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and not any(LAUNCHES.values())
    for t in p48.values():
        t.requires_grad_(True)
    lft.forward(p48, torch.rand(1, 1, 40, 40, device=cuda_device),
                Args(channels=48, scale_factor=2, dtype="bfloat16")).sum().backward()
    torch.cuda.synchronize()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in p48.values())
    assert not any(LAUNCHES.values())


# ------------------------------------- `--dtype bfloat16` training kernels ---

def _bf16t_close(got, ref, ref32, gap=0.1, ulps=1.0, f32_rel=1e-4):
    """A bf16-training kernel against its plain bf16 version, per output:
    the dtype of the plain version's; L2 within `gap` of the plain
    bf16-vs-f32 distance and, where the plain version rounds to bf16, every
    element within `ulps` bf16 ulps of max |plain|; an output whose bf16 and
    f32 plain versions compute the same f32 arithmetic (dtokpe, an LN sum)
    within `f32_rel` L2-relative (chip_smoke.py's `bf16t_err`)."""
    for i, (g, r, r32) in enumerate(zip(got, ref, ref32)):
        assert g.dtype == r.dtype and g.shape == r.shape, (i, g.dtype, r.dtype)
        g, r, r32 = g.double(), r.double(), r32.double()
        nr = float(r.norm())
        d, d32 = float((g - r).norm()) / nr, float((r32 - r).norm()) / nr
        if d32 <= f32_rel:
            assert d <= f32_rel, (i, d, d32)
            continue
        assert d <= gap * d32, (i, d, d32)
        if got[i].dtype == torch.bfloat16:   # where the plain version rounds
            ulp = 2.0 ** (np.floor(np.log2(float(r.abs().max()))) - 7)
            assert float((g - r).abs().max()) <= ulps * ulp, i


def _calm_relu(dout, hid_k, hid_p):
    """dout with a zero cotangent on the tokens where an FFN ReLU is on in
    one version and off in the other (its input within rounding of 0: dpre
    jumps there by design; chip_smoke.py's `calm_relu`). They stay rare."""
    flips = ((hid_k > 0) != (hid_p > 0)).reshape(-1, hid_k.shape[-1]).any(-1)
    assert int(flips.sum()) <= max(2, 1e-3 * flips.numel())
    dout = dout.clone()
    dout.reshape(-1, dout.shape[-1])[flips] = 0
    return dout


def _bf16_params(C, dev, seed=0):
    return {k: v.bfloat16() for k, v in _params(C, dev, seed).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(25, 37), (81, 7)])
def test_ang_block_res_bf16io_kernel(cuda_device, C, A2, N):
    """K1 res in bf16 IO: out bit for bit `ang_block_bf16io`'s; m (one value
    a token), l and attn against the plain version (m and l move where q or
    k rounds to the neighbouring bf16 value); one launch under its name."""
    wts = ang_block.ang_weights(_bf16_params(C, cuda_device), "altblock.1.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g).bfloat16()
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    reset_launches()
    got = ang_block.ang_block(x, pe, wts, 8, with_res=True)
    torch.cuda.synchronize()
    assert LAUNCHES["ang_block_res_bf16io"] == 1 and sum(LAUNCHES.values()) == 1
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16]
    assert torch.equal(got[0], ang_block.ang_block(x, pe, wts, 8))
    assert torch.equal(got[1], got[1][..., :1].expand_as(got[1]))   # the token's max
    ref = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True)
    ref32 = ang_block.ang_block_plain(x.float(), pe, {k: v.float() for k, v in wts.items()}, 8,
                                      with_res=True)
    _bf16t_close(got, ref, ref32)
    assert all(torch.equal(a, b) for a, b in
               zip(got, ang_block.ang_block(x, pe, wts, 8, with_res=True)))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (2, 32, 32), (2, 17, 40)])
def test_window_attn_res_bf16io_kernel(cuda_device, C, V, h, w):
    """K2.3 res in bf16 IO: attn bit for bit `spa_window_attn_bf16io`'s;
    m (each query's max over its heads, 0 where the window leaves the
    image) and l against the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    q, k, v = (torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g).bfloat16()
               for _ in range(3))
    reset_launches()
    attn, m, l = spa_block.window_attn(q, k, v, 8, 5, with_stats=True)
    torch.cuda.synchronize()
    assert LAUNCHES["spa_window_attn_res_bf16io"] == 1 and sum(LAUNCHES.values()) == 1
    assert torch.equal(attn, spa_block.window_attn(q, k, v, 8, 5))
    ref = spa_block.window_attn_plain(q, k, v, 8, 5)
    torch.testing.assert_close(m, ref[1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, ref[2], atol=1e-5, rtol=1e-4)
    assert torch.equal(m, m[..., :1].expand_as(m))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(4, 301), (25, 37), (81, 7)])
def test_ang_block_bwd_bf16io_kernels(cuda_device, C, A2, N):
    """K4 in bf16 IO from the plain K1 res's bf16 residuals, every output
    against the plain version (bf16 but dx2 and the LN sums); counted as
    `ang_block_bwd_bf16io` (A2 <= 64) or `ang_block_bwd128_bf16io`; twice
    bit for bit."""
    wts = ang_block.ang_weights(_bf16_params(C, cuda_device, seed=A2), "altblock.2.ang_trans.")
    w32 = {k: v.float() for k, v in wts.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g).bfloat16()
    dout = torch.randn(N, A2, C, device=cuda_device, generator=g).bfloat16()
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    _, m, l, attn = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True)
    dout = _calm_relu(dout, ang_block.ang_block_bwd_ops(x, pe, wts, m, l, attn, dout, 8)[8],
                      ang_block.ang_block_bwd_ops_plain(x, pe, wts, m, l, attn, dout, 8)[8])
    reset_launches()
    got = ang_block.ang_block_bwd_ops(x, pe, wts, m, l, attn, dout, 8)
    torch.cuda.synchronize()
    name = "ang_block_bwd128_bf16io" if A2 > 64 else "ang_block_bwd_bf16io"
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    ref = ang_block.ang_block_bwd_ops_plain(x, pe, wts, m, l, attn, dout, 8)
    ref32 = ang_block.ang_block_bwd_ops_plain(x.float(), pe, w32, m, l, attn.float(),
                                              dout.float(), 8)
    got = (*got[:-1], got[-1].sum(0))
    ref, ref32 = ((*r[:-1], r[-1][0]) for r in (ref, ref32))
    _bf16t_close(got, ref, ref32)
    again = ang_block.ang_block_bwd_ops(x, pe, wts, m, l, attn, dout, 8)
    assert all(torch.equal(a, b) for a, b in zip(got[:-1], again[:-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (2, 32, 32), (2, 17, 40)])
def test_spa_block_bwd_bf16io_kernels(cuda_device, C, V, h, w):
    """K3's five steps in bf16 IO, each from its plain predecessor's output,
    against the plain version; each counted under its `_bf16io` name."""
    ws = spa_block._with_mlp(spa_block.spa_weights(_bf16_params(C, cuda_device, seed=h),
                                                   "altblock.2.spa_trans."))
    ws32 = {k: v.float() for k, v in ws.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C + h + w)
    x = torch.randn(V, h, w, C, device=cuda_device, generator=g).bfloat16()
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g).bfloat16()
    dout = torch.randn(V, h, w, C, device=cuda_device, generator=g).bfloat16()
    _, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, ws, 8, 5, with_res=True)
    dout = _calm_relu(dout, spa_block.ffn_out_bwd(attn, tok, dout, ws)[4],
                      spa_block.ffn_out_bwd_plain(attn, tok, dout, ws)[4])
    f = lambda t: t.float() if t.dtype == torch.bfloat16 else t
    summed = lambda r: (*r[:-1], r[-1].sum(0))
    reset_launches()

    def step(kern, plain, ins, sums=False):
        got, ref, ref32 = kern(*ins), plain(*ins), plain(*(f(t) for t in ins))
        got, ref, ref32 = ((r,) if isinstance(r, torch.Tensor) else tuple(r)
                           for r in (got, ref, ref32))
        if sums:
            got, ref, ref32 = summed(got), summed(ref), summed(ref32)
        _bf16t_close(got, ref, ref32)
        return ref

    a_ref = step(lambda *a: spa_block.ffn_out_bwd(*a, ws), lambda *a: spa_block.ffn_out_bwd_plain(
        *a, ws if a[0].dtype == torch.bfloat16 else ws32), (attn, tok, dout), sums=True)
    dx2, dattn = a_ref[0], a_ref[1]
    xn, q, k, v = step(lambda *a: spa_block.ln_qkv(*a, ws),
                       lambda *a: spa_block.ln_qkv_plain(
                           *a, ws if a[0].dtype == torch.bfloat16 else ws32), (tok, pe_tok))
    dq, dk, dv = step(lambda *a: spa_block.window_attn_bwd(*a, m, l, 8, 5),
                      lambda *a: spa_block.window_attn_bwd_plain(*a, m, l, 8, 5),
                      (q, k, v, attn, dattn))
    dtok = step(lambda *a: spa_block.qkv_ln_bwd(*a, ws),
                lambda *a: spa_block.qkv_ln_bwd_plain(
                    *a, ws if a[0].dtype == torch.bfloat16 else ws32),
                (tok, pe_tok, dq, dk, dv, dx2), sums=True)[0]
    step(lambda *a: spa_block.tokenize_bwd(*a, ws), lambda *a: spa_block.tokenize_bwd_plain(
        *a, ws if a[0].dtype == torch.bfloat16 else ws32), (dtok,))
    torch.cuda.synchronize()
    for n in ("spa_ffn_out_bwd", "spa_ln_qkv", "spa_window_attn_bwd", "spa_qkv_ln_bwd",
              "spa_tokenize_bwd"):
        assert LAUNCHES[n + "_bf16io"] == 1 and LAUNCHES[n] == LAUNCHES[n + "_bf16"] == 0, n


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,N,image", [(4096, 128, 128, None), (2048, 64, 128, None),
                                         (2048, 256, 128, None), (2100, 64, 128, (7, 10)),
                                         (6 * 32 * 32, 64, 128, (32, 32))])
@pytest.mark.parametrize("dy_f32", [False, True])
def test_wgrad_bf16io_kernel(cuda_device, T, K, N, image, dy_f32):
    """`wgrad_bf16io` on bf16 x and bf16 (or f32, rounded as it loads) dy:
    the plain version's f32 sums over the bf16 values within 1e-5 of its
    largest output, an f32 result, bitwise repeatable."""
    if dy_f32 and image is not None:
        pytest.skip("no product of the step takes an f32 dy with taps")
    g = torch.Generator(device=cuda_device).manual_seed(T + K + N)
    x = torch.randn(T, K, device=cuda_device, generator=g).bfloat16()
    dy = torch.randn(T, N, device=cuda_device, generator=g)
    dy = dy if dy_f32 else dy.bfloat16()
    reset_launches()
    got = wgrad.wgrad(x, dy, image)
    torch.cuda.synchronize()
    assert LAUNCHES["wgrad_bf16io"] == 1 and sum(LAUNCHES.values()) in (1, 2)
    ref = wgrad.wgrad_plain(x, dy, image)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, wgrad.wgrad(x, dy, image))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
def test_wgrad_bf16io_products_at_each_width(cuda_device, C):
    """`wgrad_bf16io` (bf16 `mma.sync` on `ldmatrix.trans` fragments, slices
    in clusters of two that add their partials in shared memory) at every
    product of a bf16 train step at width C: K3's (D = 2C) dw1, dwu (9
    taps), dwq, dw2, dwlin and dwo on an f32 dx2, K4's C x C weights, dw1,
    dw2 and dwo on an f32 dx2; 3 images of 23 x 31 tokens (T = 2139, no
    64-token stage or slice divides it) and the step's T = 102,400: within
    1e-5 of the plain version's largest output, an f32 result, one launch
    (and the column sum), bitwise on a repeat."""
    D = 2 * C
    g = torch.Generator(device=cuda_device).manual_seed(C)
    prods = [(D, 2 * D, False, False), (C, D, True, False), (D, D, False, False),
             (2 * D, D, False, False), (D, C, False, False), (D, D, False, True),
             (C, C, False, False), (C, 2 * C, False, False), (2 * C, C, False, False),
             (C, C, False, True)]
    for T, image in ((3 * 23 * 31, (23, 31)), (100 * 32 * 32, (32, 32))):
        for K, N, taps, dy_f32 in prods:
            x = torch.randn(T, K, device=cuda_device, generator=g).bfloat16()
            dy = torch.randn(T, N, device=cuda_device, generator=g)
            dy = dy if dy_f32 else dy.bfloat16()
            im = image if taps else None
            reset_launches()
            got = wgrad.wgrad(x, dy, im)
            torch.cuda.synchronize()
            assert LAUNCHES["wgrad_bf16io"] == 1 and sum(LAUNCHES.values()) in (1, 2)
            ref = wgrad.wgrad_plain(x, dy, im)
            assert got.dtype == torch.float32 and got.shape == ref.shape
            err = float((got - ref).abs().max())
            assert err <= 1e-5 * float(ref.abs().max()), (T, K, N, taps, dy_f32, err)
            assert torch.equal(got, wgrad.wgrad(x, dy, im))


@pytest.mark.cuda
def test_bf16_train_step_kernels_match_plain_blocks(cuda_device):
    """A `--dtype bfloat16` fused train step (C = 16, 2x) through the
    kernels against the same step through the plain blocks: the loss, the
    gradient's distance from the f32 step's within 10% of the plain step's
    and its L2 from the plain step's within 1.5 of that; only the bf16
    kernels launched (4 of each block kernel, 56 `wgrad_bf16io`); the master
    parameters and their gradients f32; bitwise repeatable."""
    import dataclasses
    import functools

    from lft_torch.kernels import BF16IO, BF16TRAIN
    from lft_torch.registry import get_model
    from lft_torch.training import optim, trainer
    args = Args(channels=16, scale_factor=2, dtype="bfloat16", batch_size=2)
    a32 = Args(channels=16, scale_factor=2, batch_size=2, train_fused="true")
    p0 = _params(16, cuda_device, seed=4)
    rs = np.random.RandomState(1)
    lr = torch.from_numpy(rs.rand(2, 1, 80, 80).astype(np.float32)).to(cuda_device)
    hr = torch.from_numpy(rs.rand(2, 1, 160, 160).astype(np.float32)).to(cuda_device)

    def step(a, plain=False):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        model = get_model(a)
        if plain:
            model = dataclasses.replace(model, apply=functools.partial(lft.forward,
                                                                       plain_blocks=True))
        fn = trainer.make_train_step(model, optim.make_optimizer(p, a, 10), a)
        loss = float(fn(p, lr, hr)[0])
        return loss, torch.cat([p[k].grad.reshape(-1) for k in sorted(p)]), p

    reset_launches()
    loss, gk, pk = step(args)
    torch.cuda.synchronize()
    bf_ = [n for n in BF16TRAIN if n not in ("ang_block_bwd128_bf16io", "wgrad_bf16io")]
    want = {n: 4 for n in bf_ + [n for n in BF16IO if n.startswith("spa_") and
                                 n != "spa_window_attn_bf16io"]}
    want.update(wgrad_bf16io=56, colsum=16)
    assert {k: v for k, v in LAUNCHES.items() if v} == want
    assert all(v.dtype == torch.float32 and v.grad.dtype == torch.float32 for v in pk.values())
    loss2, gk2, _ = step(args)
    assert loss2 == loss and torch.equal(gk, gk2)
    loss_p, gp, _ = step(args, plain=True)
    _, g32, _ = step(a32, plain=True)
    assert abs(loss - loss_p) <= 1e-3 * abs(loss_p)
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    gap = l2(gp, g32)
    assert abs(l2(gk, g32) / gap - 1) <= 0.1, (l2(gk, g32), gap)
    assert l2(gk, gp) <= 1.5 * gap


@pytest.mark.cuda
def test_bf16io_kernels_repeat_bitwise(cuda_device):
    """The bf16-IO kernels whose rows the warps widen themselves (K2.2,
    K2.4, K3.b, K3.d) and the bf16 K2 chain, 20 repeats each bit for bit: a
    row loader that left the weight copies uncommitted made the chain differ
    now and then (tests/test_torch_bf16train.py)."""
    ws = spa_block._with_mlp(spa_block.spa_weights(_bf16_params(64, cuda_device),
                                                   "altblock.0.spa_trans."))
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(50, 16, 16, 64, device=cuda_device, generator=g).bfloat16()
    pe_tok = torch.randn(16, 16, 128, device=cuda_device, generator=g).bfloat16()
    tok, xn = spa_block.tokenize_ln(x, pe_tok, ws)
    q, k, v = spa_block.qkv(xn, tok, ws)
    attn = spa_block.window_attn(q, k, v, 8, 5)
    dq = torch.randn_like(q.float()).bfloat16()
    dx2 = torch.randn_like(q.float())
    for fn in (lambda: spa_block.qkv(xn, tok, ws), lambda: spa_block.outproj_ln(attn, tok, ws),
               lambda: spa_block.ln_qkv(tok, pe_tok, ws),
               lambda: spa_block.qkv_ln_bwd(tok, pe_tok, dq, dq, dq, dx2, ws),
               lambda: (spa_block.spa_block(x, pe_tok, ws, 8, 5),)):
        first = fn()
        for _ in range(20):
            assert all(torch.equal(a, b) for a, b in zip(first, fn()))


@pytest.mark.cuda
def test_bf16_train_launchers_check_dtypes(cuda_device):
    """A bf16-training launcher given an activation of another dtype raises
    TypeError, naming its `_bf16io` instance; nothing is launched."""
    pb = _bf16_params(16, cuda_device)
    wa = ang_block.ang_weights(pb, "altblock.0.ang_trans.")
    ws = spa_block._with_mlp(spa_block.spa_weights(pb, "altblock.0.spa_trans."))
    x = torch.zeros(4, 25, 16, device=cuda_device, dtype=torch.bfloat16)
    m = torch.ones(4, 25, 8, device=cuda_device)
    pe = torch.from_numpy(angular_position(25, 16)).to(cuda_device)
    t = torch.zeros(2, 8, 8, 32, device=cuda_device, dtype=torch.bfloat16)
    reset_launches()
    with pytest.raises(TypeError, match="ang_block_bwd_bf16io"):
        ang_block.ang_block_bwd_ops(x, pe, wa, m, m, x.float(), x, 8)
    with pytest.raises(TypeError, match="spa_ffn_out_bwd_bf16io"):
        spa_block.ffn_out_bwd(t, t.float(), t[..., :16].contiguous(), ws)
    with pytest.raises(TypeError, match="spa_qkv_ln_bwd_bf16io"):
        spa_block.qkv_ln_bwd(t, t[0].contiguous(), t, t, t.float(), t.float(), ws)
    with pytest.raises(TypeError, match="wgrad_bf16io"):
        wgrad.wgrad(t.reshape(-1, 32), t.reshape(-1, 32).half())
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == 0


# --dtype bfloat16 through the unfused branch: the per-op forwards' bf16-IO
# instances, each held to its plain bf16 version (run on the card inside
# `kernels.common.plain_versions`) by L2 within 1/10 of the plain bf16-vs-f32
# distance and 1 bf16 ulp of max |plain| (an f32 sum in another order rounds
# to the neighbouring bf16 value now and then).
PEROP_BF16 = {
    "ang_attn_bf16io": lambda q, k, v: ang_attn_mxu.ang_attn_fwd(q, k, v, 8),
    "ang_attn_sweep_bf16io": lambda q, k, v: ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, 8),
    "spa_attn_hp_bf16io": lambda q, k, v: spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5),
    "spa_attn_mxu_bf16io": lambda q, k, v: spa_attn.spa_attn_mxu_fwd(q, k, v, 8, 5),
    "spa_attn_offset_bf16io": lambda q, k, v: local_attn_vjp.spa_attn_offset_fwd(q, k, v, 8, 5),
    "spa_attn_tile_bf16io": lambda q, k, v: local_attn.windowed_attention_tile(q, k, v, 8, 5, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PEROP_BF16))
@pytest.mark.parametrize("shape", [(37, 25, 16), (9, 81, 64), (5, 128, 32), (3, 144, 64),
                                   (3, 16, 16, 32), (2, 24, 40, 128), (2, 30, 30, 64)])
def test_perop_bf16io_kernels(cuda_device, name, shape):
    """Each per-op bf16-IO forward on bf16 tensors against its plain bf16
    version (bound above), one launch under its name, bitwise repeatable."""
    from lft_torch.kernels.common import plain_versions
    spatial = name.startswith("spa_")
    if spatial != (len(shape) == 4) or (name == "ang_attn_bf16io" and shape[1] > 128) \
            or (name in ("spa_attn_mxu_bf16io", "spa_attn_tile_bf16io") and shape[1] % 8):
        pytest.skip("a shape this kernel's dispatch never gives it")
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    q, k, v = (torch.randn(*shape, device=cuda_device, generator=g) * s for s in (1.5, 1.5, 1))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    fn = PEROP_BF16[name]
    reset_launches()
    got = fn(q, k, v)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {name: 1}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, fn(q, k, v))
    with plain_versions():
        plain, plain32 = fn(q, k, v), fn(q.float(), k.float(), v.float())
    _bf16_close((got,), (plain,), (plain32,))


@pytest.mark.cuda
@pytest.mark.parametrize("ang_res,view,spa,ang,want", [
    (5, 8, None, None, {"ang_attn_bf16io": 4, "spa_attn_hp_bf16io": 4}),
    (12, 8, None, None, {"ang_attn_sweep_bf16io": 4, "spa_attn_hp_bf16io": 4}),
    (5, 30, None, None, {"ang_attn_bf16io": 4, "spa_attn_offset_bf16io": 4}),
    (5, 64, None, None, {"ang_attn_bf16io": 4, "spa_attn_mxu_bf16io": 4}),
    (5, 16, "tile", "sweep", {"ang_attn_sweep_bf16io": 4, "spa_attn_tile_bf16io": 4})])
def test_bf16_unfused_forward_launches_perop_bf16io(cuda_device, monkeypatch, ang_res, view, spa,
                                                    ang, want):
    """A bf16 forward through the unfused branch (C = 16) launches only the
    per-op `_bf16io` kernels of its geometry, repeats bitwise, and lies as
    far from the f32 forward as the same forward through their plain
    versions (`plain_blocks=True`), within 10%."""
    for knob, val in (("LFT_SPA_VARIANT", spa), ("LFT_ANG_VARIANT", ang)):
        if val:
            monkeypatch.setenv(knob, val)
    p = _params(16, cuda_device, seed=2)
    args = Args(channels=16, scale_factor=2, dtype="bfloat16", angRes=ang_res)
    g = torch.Generator(device=cuda_device).manual_seed(view)
    lr = torch.rand(1, 1, ang_res * view, ang_res * view, device=cuda_device, generator=g)
    with torch.no_grad():
        reset_launches()
        got = lft.forward(p, lr, args, fused=False)
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == want
        assert torch.equal(got, lft.forward(p, lr, args, fused=False))
        plain = lft.forward(p, lr, args, fused=False, plain_blocks=True)
        f32 = lft.forward(p, lr, Args(channels=16, scale_factor=2, angRes=ang_res), fused=False)
    l2 = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    assert abs(l2(got, f32) / l2(plain, f32) - 1) <= 0.1
    assert l2(got, plain) <= 1.5 * l2(plain, f32)


# ------------------- `--dtype bfloat16` training through the per-op branch ---
#
# The `_res` forms and backwards of K5-K9 (`kernels.PEROP_BF16TRAIN`) against
# their plain bf16 versions on the card (inside `plain_versions()`), the plain
# f32 versions the yardstick, as chip_smoke.py step 26 holds them: per output
# L2 within 1/10 of the plain bf16-vs-f32 distance, 4 bf16 ulps of max
# |plain| (a rounded ds or p that rounds the other way moves a sum by its own
# ulp, as in K4: `BF16T_ULPS`), the f32 stats within 1e-4 L2.
PEROP_BF16_TRAIN = {
    # base name: (`_res` form, backward (q, k, v, out, m, l, dout))
    "ang_attn": (lambda q, k, v: ang_attn_mxu.ang_attn_fwd(q, k, v, 8, True),
                 lambda q, k, v, o, m, l, d: ang_attn_mxu.ang_attn_bwd(q, k, v, m, l, d, 8)),
    "ang_attn_sweep": (lambda q, k, v: ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, 8, True),
                       lambda q, k, v, o, m, l, d: ang_attn_vjp.ang_attn_sweep_bwd(
                           q, k, v, o, m, l, d, 8)),
    "spa_attn_hp": (lambda q, k, v: spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5, True),
                    lambda q, k, v, o, m, l, d: spa_attn_hp.spa_attn_hp_bwd(q, k, v, m, l, d, 8,
                                                                            5)),
    "spa_attn_mxu": (lambda q, k, v: spa_attn.spa_attn_mxu_fwd(q, k, v, 8, 5, True),
                     lambda q, k, v, o, m, l, d: spa_attn.spa_attn_mxu_bwd(q, k, v, m, l, d, 8,
                                                                           5)),
    "spa_attn_offset": (lambda q, k, v: local_attn_vjp.spa_attn_offset_fwd(q, k, v, 8, 5, True),
                        lambda q, k, v, o, m, l, d: local_attn_vjp.spa_attn_offset_bwd(
                            q, k, v, o, m, l, d, 8, 5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("base", list(PEROP_BF16_TRAIN))
@pytest.mark.parametrize("shape", [(37, 25, 16), (9, 81, 64), (5, 128, 32), (3, 144, 64),
                                   (3, 16, 16, 32), (2, 24, 40, 128), (2, 30, 30, 64)])
def test_perop_bf16train_kernels(cuda_device, base, shape):
    """Each per-op `_res_bf16io` form and `_bwd_bf16io` backward on bf16
    tensors against its plain bf16 version (the backward fed the plain
    `_res` form's out, m, l), one launch each under its name, bitwise
    repeatable; the `_res` form's out is the residual-free forward's."""
    from lft_torch.kernels.common import plain_versions
    spatial = base.startswith("spa_")
    if spatial != (len(shape) == 4) or (base == "ang_attn" and shape[1] > 128) \
            or (base == "spa_attn_mxu" and shape[1] % 8):
        pytest.skip("a shape this kernel's dispatch never gives it")
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape) + 24)
    q, k, v, dout = (torch.randn(*shape, device=cuda_device, generator=g) * s
                     for s in (1.5, 1.5, 1, 1))
    q, k, v, dout = q.bfloat16(), k.bfloat16(), v.bfloat16(), dout.bfloat16()
    res_fn, bwd_fn = PEROP_BF16_TRAIN[base]
    reset_launches()
    got = res_fn(q, k, v)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {base + "_res_bf16io": 1}
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    assert all(torch.equal(a, b) for a, b in zip(got, res_fn(q, k, v)))
    assert torch.equal(got[0], PEROP_BF16[base + "_bf16io"](q, k, v))
    with plain_versions():
        res, res32 = res_fn(q, k, v), res_fn(q.float(), k.float(), v.float())
    _bf16t_close(got, res, res32, ulps=1.0)
    reset_launches()
    grads = bwd_fn(q, k, v, *res, dout)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {base + "_bwd_bf16io": 1}
    assert all(t.dtype == torch.bfloat16 and t.shape == q.shape for t in grads)
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd_fn(q, k, v, *res, dout)))
    with plain_versions():
        plain = bwd_fn(q, k, v, *res, dout)
        plain32 = bwd_fn(q.float(), k.float(), v.float(), *res32, dout.float())
    _bf16t_close(grads, plain, plain32, ulps=4.0)


@pytest.mark.cuda
@pytest.mark.parametrize("ang_res,view,spa,ang,bases", [
    (5, 8, None, None, ("ang_attn", "spa_attn_hp")),
    (5, 8, "mxu", None, ("ang_attn", "spa_attn_mxu")),
    (5, 8, "offset", "sweep", ("ang_attn_sweep", "spa_attn_offset")),
    (12, 8, None, None, ("ang_attn_sweep", "spa_attn_hp"))])
def test_bf16_unfused_train_step_launches_perop_bf16train(cuda_device, monkeypatch, ang_res, view,
                                                          spa, ang, bases):
    """A `--dtype bfloat16 --train_fused false` step (C = 16) launches only
    the `_res_bf16io` and `_bwd_bf16io` instances of its geometry, 4 of
    each, repeats bitwise, keeps f32 master weights, and its gradient lies
    as far from the f32 plain step's as the same step through the plain
    versions (`plain_versions()`), within 15%: at C = 16 and batch 2 one
    step's ratio is a sample with a spread (1.10 under `mxu` on an H100;
    tests/test_torch_bf16perop_train.py's STEP_GAP_TOL); chip_smoke.py step
    26 holds the full-width step to 10%."""
    import dataclasses
    from lft_torch.kernels.common import plain_if
    from lft_torch.registry import get_model
    from lft_torch.training import optim, trainer
    for knob, val in (("LFT_SPA_VARIANT", spa), ("LFT_ANG_VARIANT", ang)):
        if val:
            monkeypatch.setenv(knob, val)
    p0 = _params(16, cuda_device, seed=3)
    args = Args(channels=16, scale_factor=2, dtype="bfloat16", angRes=ang_res, batch_size=2,
                train_fused="false")
    g = torch.Generator(device=cuda_device).manual_seed(view + ang_res)
    lr = torch.rand(2, 1, ang_res * view, ang_res * view, device=cuda_device, generator=g)
    hr = torch.rand(2, 1, 2 * ang_res * view, 2 * ang_res * view, device=cuda_device, generator=g)
    smooth = lambda sr, y: ((sr - y) * torch.cos(3.0 * (sr - y))).mean()

    def step(a, plain=False):
        p = {k_: v_.clone().requires_grad_(True) for k_, v_ in p0.items()}
        model = dataclasses.replace(get_model(a), loss=smooth)
        fn = trainer.make_train_step(model, optim.make_optimizer(p, a, 10), a, with_metrics=False)
        with plain_if(plain):
            loss = float(fn(p, lr, hr)[0])
        return loss, torch.cat([p[k_].grad.reshape(-1) for k_ in sorted(p)]), p

    reset_launches()
    loss, grad, p1 = step(args)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {f"{b}_{f}_bf16io": 4 for b in bases
                                                        for f in ("res", "bwd")}
    loss_b, grad_b, p1_b = step(args)
    assert loss == loss_b and torch.equal(grad, grad_b)
    assert all(torch.equal(p1[k_], p1_b[k_]) and p1[k_].dtype == torch.float32 for k_ in p1)
    reset_launches()
    _, g_p, _ = step(args, plain=True)
    _, g_f, _ = step(dataclasses.replace(args, dtype="float32"), plain=True)
    assert not any(LAUNCHES.values())
    l2 = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    assert abs(l2(grad, g_f) / l2(g_p, g_f) - 1) <= 0.15, l2(grad, g_f) / l2(g_p, g_f)
    assert l2(grad, g_p) <= 1.5 * l2(g_p, g_f)


# ----------------- the last forward forms: `_bf16` (plan none) and K11 bf16io ---

def _mixed_close(got, ref, ref32, rel=1e-3, gap=0.1):
    """A `--dtype mixed` bf16-operand instance against its plain version
    under the plan, per output: L2-relative `rel` and `gap` of the plain
    mixed-vs-f32 distance (chip_smoke.py's MIXED_REL, MIXED_GAP); an output
    the plan leaves f32 (the plain versions' bit for bit) `rel` alone."""
    for i, (g, r, r32) in enumerate(zip(got, ref, ref32)):
        assert g.dtype == r.dtype == torch.float32 and g.shape == r.shape, i
        g, r, r32 = g.double(), r.double(), r32.double()
        d, d32 = float((g - r).norm() / r.norm()), float((r32 - r).norm() / r.norm())
        assert d <= rel and (d <= gap * d32 or d32 == 0), (i, d, d32)


def _plan_none():
    from lft_torch.kernels import common
    return common.mm_site_plan(True, frozenset())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (2, 17, 40), (2, 32, 32)])
def test_spa_block_mixed_fwd_kernels(cuda_device, C, V, h, w):
    """Each of K2's five `_bf16` steps (LFT_MM_HP_SITES=none) from its plain
    predecessor's output under the plan, against its plain version, once
    each, bitwise on a repeat; the f32 kernels not launched."""
    plan = _plan_none()
    ws = spa_block._with_mlp(spa_block.spa_weights(_params(C, cuda_device), "altblock.2.spa_trans."))
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    x = torch.randn(V, h, w, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    tok, xn = spa_block.tokenize_ln_plain(x, pe_tok, ws, plan)
    q, k, v = spa_block.qkv_plain(xn, tok, ws, plan)
    attn = spa_block.window_attn_plain(q, k, v, 8, 5, plan)[0]
    x2, xn2 = spa_block.outproj_ln_plain(attn, tok, ws, plan)
    win = lambda *a, **kw: spa_block.window_attn(*a, 8, 5, **kw)
    win_p = lambda *a, **kw: spa_block.window_attn_plain(*a, 8, 5, **kw)[0]
    steps = [(spa_block.tokenize_ln, spa_block.tokenize_ln_plain, (x, pe_tok, ws)),
             (spa_block.qkv, spa_block.qkv_plain, (xn, tok, ws)),
             (win, win_p, (q, k, v)),
             (spa_block.outproj_ln, spa_block.outproj_ln_plain, (attn, tok, ws)),
             (spa_block.ffn_out, spa_block.ffn_out_plain, (xn2, x2, ws))]
    reset_launches()
    for kern, plain, ins in steps:
        tup = lambda o: o if isinstance(o, tuple) else (o,)
        got = tup(kern(*ins, plan=plan))
        _mixed_close(got, tup(plain(*ins, plan=plan)), tup(plain(*ins)))
        assert all(torch.equal(a, b) for a, b in zip(got, tup(kern(*ins, plan=plan))))
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        n + "_bf16": 2 for n in FORWARD if n.startswith("spa_")}


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
def test_spa_ffn_out_bf16_kernel(cuda_device, C):
    """K2.5's `_bf16` kernel (bf16 weights resident in shared memory, bf16
    `wgmma`) on the model's weights at T = 189, 3400 and 20480 tokens (a
    ragged last 128-row tile; 160 tiles, so a block walks more than one and
    prefetches the next one's rows): against the plain version under the
    plan `none` within the mixed bounds, one launch each, bitwise on a
    repeat; K11.5's `_pm_bf16` (the same kernel, the output pixel-major)
    bitwise the view-major output permuted; nothing else launched."""
    plan = _plan_none()
    ws = spa_block.spa_weights(_params(C, cuda_device, seed=C), "altblock.1.spa_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C)
    reset_launches()
    for V, h, w, A2 in ((3, 9, 7, 3), (5, 17, 40, 5), (20, 32, 32, 4)):
        xn2 = torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g)
        x2 = torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g)
        got = spa_block.ffn_out(xn2, x2, ws, plan=plan)
        assert got.shape == (V, h, w, C) and got.dtype == torch.float32
        _mixed_close((got,), (spa_block.ffn_out_plain(xn2, x2, ws, plan=plan),),
                     (spa_block.ffn_out_plain(xn2, x2, ws),))
        assert torch.equal(got, spa_block.ffn_out(xn2, x2, ws, plan=plan))
        pm = spa_block.ffn_out(xn2, x2, ws, views=A2, plan=plan)
        assert torch.equal(pm, got.reshape(V // A2, A2, h, w, C).permute(0, 2, 3, 1, 4))
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"spa_ffn_out_bf16": 6,
                                                        "spa_ffn_out_pm_bf16": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(25, 37), (81, 7), (4, 64)])
def test_ang_block_mixed_fwd_kernel(cuda_device, C, A2, N):
    plan = _plan_none()
    wts = ang_block.ang_weights(_params(C, cuda_device), "altblock.1.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    reset_launches()
    got = ang_block.ang_block(x, pe, wts, 8, plan=plan)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"ang_block_bf16": 1}
    _mixed_close((got,), (ang_block.ang_block_plain(x, pe, wts, 8, plan=plan),),
                 (ang_block.ang_block_plain(x, pe, wts, 8),))
    assert torch.equal(got, ang_block.ang_block(x, pe, wts, 8, plan=plan))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(25, 37), (81, 7), (4, 64)])
def test_ang_block_mixed_res_kernels(cuda_device, C, A2, N):
    """K1 res `_bf16` (LFT_MM_HP_SITES=none in a train step) against its
    plain version under the plan: out and attn as `_mixed_close`, attn of
    bf16 values, m and l within L2 1e-3 (q and k round in both), out K1
    `_bf16`'s bit for bit; then K4's `_dp` instance (D from its own p, for
    LFT_MM_HP_BWD_SITES=all) from those residuals against its plain version
    within 5e-4 of max |plain|; both repeat bitwise."""
    from lft_torch.kernels import common
    plan = _plan_none()
    wts = ang_block.ang_weights(_params(C, cuda_device), "altblock.1.ang_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C + A2 + 1)
    x = torch.randn(N, A2, C, device=cuda_device, generator=g)
    dout = torch.randn(N, A2, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    reset_launches()
    got = ang_block.ang_block(x, pe, wts, 8, with_res=True, plan=plan)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"ang_block_res_bf16": 1}
    ref = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True, plan=plan)
    ref32 = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True)
    _mixed_close((got[0], got[3]), (ref[0], ref[3]), (ref32[0], ref32[3]))
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    assert l2(got[1], ref[1]) <= 1e-3 and l2(got[2], ref[2]) <= 1e-3
    assert torch.equal(got[3], common.bf16_round(got[3]))
    assert torch.equal(got[0], ang_block.ang_block(x, pe, wts, 8, plan=plan))
    again = ang_block.ang_block(x, pe, wts, 8, with_res=True, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    reset_launches()
    ops = ang_block.ang_block_bwd_ops(x, pe, wts, *got[1:], dout, 8, d_from_p=True)
    torch.cuda.synchronize()
    name = "ang_block_bwd128_dp" if A2 > 64 else "ang_block_bwd_dp"
    assert {n: c for n, c in LAUNCHES.items() if c} == {name: 1}
    ops_ref = ang_block.ang_block_bwd_ops_plain(x, pe, wts, *got[1:], dout, 8, d_from_p=True)
    hid_flip = ((ops[8] > 0) != (ops_ref[8] > 0)).any(-1)
    assert int(hid_flip.sum()) <= max(1, 1e-3 * hid_flip.numel())
    keep = ~hid_flip.reshape(N, A2)
    for i in (0, 2, 3, 4):                     # dx, dq, dk, dv on tokens without a flip
        a, b = ops[i].reshape(N, A2, C)[keep], ops_ref[i].reshape(N, A2, C)[keep]
        assert float((a - b).abs().max()) <= 5e-4 * float(b.abs().max()), i
    again = ang_block.ang_block_bwd_ops(x, pe, wts, *got[1:], dout, 8, d_from_p=True)
    assert all(torch.equal(a, b) for a, b in zip(ops, again))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(3, 9, 7), (2, 17, 40), (2, 32, 32)])
def test_spa_window_attn_mixed_res_kernel(cuda_device, C, V, h, w):
    """K2.3 res `_bf16` against its plain version under the plan (`res`:
    attn as the residual stores it): attn as `_mixed_close` and bf16(the
    serving `spa_window_attn_bf16`'s attn) bit for bit, m and l within L2
    1e-3; a bitwise repeat."""
    from lft_torch.kernels import common
    plan = _plan_none()
    ws = spa_block._with_mlp(spa_block.spa_weights(_params(C, cuda_device),
                                                   "altblock.2.spa_trans."))
    g = torch.Generator(device=cuda_device).manual_seed(C + h + 1)
    x = torch.randn(V, h, w, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    tok, xn = spa_block.tokenize_ln_plain(x, pe_tok, ws, plan)
    q, k, v = spa_block.qkv_plain(xn, tok, ws, plan)
    reset_launches()
    got = spa_block.window_attn(q, k, v, 8, 5, with_stats=True, plan=plan)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"spa_window_attn_res_bf16": 1}
    ref = spa_block.window_attn_plain(q, k, v, 8, 5, plan, res=True)
    _mixed_close(got[:1], ref[:1], spa_block.window_attn_plain(q, k, v, 8, 5)[:1])
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    assert l2(got[1], ref[1]) <= 1e-3 and l2(got[2], ref[2]) <= 1e-3
    serve = spa_block.window_attn(q, k, v, 8, 5, plan=plan)
    assert torch.equal(got[0], common.bf16_round(serve))
    again = spa_block.window_attn(q, k, v, 8, 5, with_stats=True, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_ssim_ignores_the_tf32_flag(cuda_device):
    """SSIM (and PSNR) of a 5x5x32^2 pair under `--matmul_precision high`
    equal those under `highest` bit for bit: the SSIM filter runs with
    cuDNN's TF32 off whatever the flag (lft_tpu's at HIGHEST)."""
    from lft_torch import device as port_device
    from lft_torch.ops.metrics import cal_metrics
    g = torch.Generator(device=cuda_device).manual_seed(3)
    label = torch.rand(160, 160, device=cuda_device, generator=g)
    out = (label + 0.05 * torch.randn(160, 160, device=cuda_device, generator=g)).clamp(0, 1)
    try:
        port_device.resolve_device(cuda_device, "high")
        high = cal_metrics(label, out, 5)
        assert torch.backends.cudnn.allow_tf32
    finally:
        port_device.resolve_device(cuda_device, "highest")
    highest = cal_metrics(label, out, 5)
    assert all(torch.equal(a, b) for a, b in zip(high, highest))


@pytest.mark.cuda
@pytest.mark.parametrize("C,Bb,h,w,A2", [(16, 2, 8, 8, 4), (32, 1, 9, 7, 25), (64, 2, 32, 32, 25),
                                         (64, 1, 17, 40, 9)])
@pytest.mark.parametrize("form", ["bf16io", "bf16"])
def test_spa_block_pixel_major_last_forms(cuda_device, C, Bb, h, w, A2, form):
    """K11 on a bf16 buffer (`_pm_bf16io`) and on an f32 one under the plan
    `none` (`_pm_bf16`): the chain launches its five instances once each,
    equals view-major K2's same instances on a permuted copy bit for bit,
    and each `_pm` kernel holds to its plain version."""
    plan = _plan_none() if form == "bf16" else None
    p = _params(C, cuda_device, seed=h)
    if form == "bf16io":
        p = {k_: v_.bfloat16() for k_, v_ in p.items()}
    prefix = "altblock.1.spa_trans."
    ws = spa_block.spa_weights(p, prefix)
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    dt = torch.bfloat16 if form == "bf16io" else torch.float32
    x = torch.randn(Bb, h, w, A2, C, device=cuda_device, generator=g).to(dt)
    pe_tok = torch.randn(h, w, 2 * C, device=cuda_device, generator=g).to(dt)
    xv = x.permute(0, 3, 1, 2, 4).reshape(Bb * A2, h, w, C).contiguous()
    reset_launches()
    got = spa_block.spa_trans_block_fused(x, pe_tok, p, prefix, 8, 5, pixel_major=True, plan=plan)
    torch.cuda.synchronize()
    names = ("spa_tokenize_ln_pm", "spa_qkv", "spa_window_attn", "spa_outproj_ln", "spa_ffn_out_pm")
    assert {k_: c for k_, c in LAUNCHES.items() if c} == {f"{n}_{form}": 1 for n in names}
    assert got.shape == x.shape and got.dtype == dt
    vm = spa_block.spa_trans_block_fused(xv, pe_tok, p, prefix, 8, 5, plan=plan)
    assert torch.equal(got, vm.reshape(Bb, A2, h, w, C).permute(0, 2, 3, 1, 4))
    to_pm = lambda t: t.reshape(Bb, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()
    f32 = lambda ts: [t.float() for t in ts]
    ws32 = {k_: v_.float() for k_, v_ in ws.items()}
    tok, xn = spa_block.tokenize_ln_plain(xv, pe_tok, ws, plan)
    got_t = spa_block.tokenize_ln(x, pe_tok, ws, pixel_major=True, plan=plan)
    ref32_t = spa_block.tokenize_ln_plain(*f32((xv, pe_tok)), ws32)
    x2, xn2 = torch.randn_like(tok.float()).to(dt), torch.randn_like(tok.float()).to(dt)
    got_o = spa_block.ffn_out(xn2, x2, ws, views=A2, plan=plan)
    ref_o = to_pm(spa_block.ffn_out_plain(xn2, x2, ws, plan))
    ref32_o = to_pm(spa_block.ffn_out_plain(*f32((xn2, x2)), ws32))
    close = _bf16_close if form == "bf16io" else _mixed_close
    close(got_t, (tok, xn), ref32_t)
    close((got_o,), (ref_o,), (ref32_o,))


@pytest.mark.cuda
def test_mixed_none_forward_on_card(cuda_device, monkeypatch):
    """`--dtype mixed` under LFT_MM_HP_SITES=none on the card: the forward
    launches the six `_bf16` kernels 4 times each and nothing else, its
    distance from the f32 forward within 10% of the plain blocks' and its L2
    from theirs within 1.5 of it, bitwise on a repeat; under grad its
    forward launches K1 res's and K2.3 res's `_bf16` forms in place of K1's
    and K2.3's (ROADMAP 9g), and under a site subset of the backward plan it
    runs (ROADMAP 9h-b): the same forward launches, grad or not (the
    backward's `_sites` instances: test_mixed_bwd_sites_train_step_on_card)."""
    from lft_torch.kernels import MIXED_FWD, MIXED_TRAIN
    monkeypatch.setenv("LFT_MM_HP_SITES", "none")
    args = Args(channels=16, scale_factor=2, dtype="mixed")
    p = _params(16, cuda_device, seed=3)
    lr = torch.from_numpy(np.random.RandomState(0).rand(2, 1, 80, 80).astype(np.float32))
    lr = lr.to(cuda_device)
    reset_launches()
    with torch.no_grad():
        got = lft.forward(p, lr, args)
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == {n: 4 for n in MIXED_FWD[:6]}
        assert torch.equal(got, lft.forward(p, lr, args))
        ref = lft.forward(p, lr, args, plain_blocks=True)
        f32 = lft.forward(p, lr, Args(channels=16, scale_factor=2))
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    assert abs(l2(got, f32) / l2(ref, f32) - 1) <= 0.1, (l2(got, f32), l2(ref, f32))
    assert l2(got, ref) <= 1.5 * l2(ref, f32)
    pg = {k_: v_.clone().requires_grad_(True) for k_, v_ in p.items()}
    reset_launches()
    lft.forward(pg, lr, args)
    torch.cuda.synchronize()
    steps = [n for n in MIXED_FWD[:6] if n not in ("ang_block_bf16", "spa_window_attn_bf16")]
    assert {n: c for n, c in LAUNCHES.items() if c} == {n: 4 for n in
                                                        steps + list(MIXED_TRAIN[:2])}
    monkeypatch.setenv("LFT_MM_HP_BWD_SITES", "qk,ffn")
    reset_launches()
    with torch.no_grad():
        assert torch.equal(lft.forward(p, lr, args), got)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {n: 4 for n in MIXED_FWD[:6]}
    reset_launches()
    lft.forward(pg, lr, args)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {n: 4 for n in
                                                        steps + list(MIXED_TRAIN[:2])}


# --------------------------------------------- LFT_MM_HP_SITES subsets (9h) ---

# S1 keeps these sites f32 and rounds the rest; S2 is its complement
# (tests/_torch_sites_ref.py), so every `_sites` kernel's products split both
# ways between them.
SITES_S1 = "qk,score,ffn,aqkv,aav,wo"
SITES_S2 = "tok,v,av,lin,ascore,awo,affn"


def _plan_sites(spec):
    from lft_torch.kernels import common
    return common.mm_site_plan(True, frozenset(spec.split(",")))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [SITES_S1, SITES_S2])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_mixed_sites_kernels(cuda_device, C, spec):
    """Each `_sites` instance (K1 and K1 res, K2.2, K2.3 and K2.3 res, K2.5,
    K11.5) under the subset against its plain version, from the plain
    predecessor's output: `_mixed_close` per output (an output the plan
    leaves f32 within `rel` alone), m and l within L2 1e-3 as K1 res
    `_bf16`'s, attn of bf16 values exactly where `awo` / `wo` rounds; each
    launched once and bitwise on a repeat."""
    from lft_torch.kernels import MIXED_SITES, common
    plan = _plan_sites(spec)
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    g = torch.Generator(device=cuda_device).manual_seed(C + len(spec))
    wa = ang_block.ang_weights(_params(C, cuda_device), "altblock.1.ang_trans.")
    x = torch.randn(37, 25, C, device=cuda_device, generator=g)
    pe = torch.from_numpy(angular_position(25, C)).to(cuda_device)
    ws = spa_block._with_mlp(spa_block.spa_weights(_params(C, cuda_device), "altblock.2.spa_trans."))
    xs = torch.randn(2, 17, 40, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(17, 40, 2 * C, device=cuda_device, generator=g)
    tok, xn = spa_block.tokenize_ln_plain(xs, pe_tok, ws, plan)
    q, k, v = spa_block.qkv_plain(xn, tok, ws, plan)
    x2, xn2 = spa_block.outproj_ln_plain(spa_block.window_attn_plain(q, k, v, 8, 5, plan)[0],
                                         tok, ws, plan)
    win = lambda *a, plan=None: spa_block.window_attn(*a, 8, 5, plan=plan)
    win_p = lambda *a, plan=None: spa_block.window_attn_plain(*a, 8, 5, plan)[0]
    winr = lambda *a, plan=None: spa_block.window_attn(*a, 8, 5, with_stats=True, plan=plan)
    winr_p = lambda *a, plan=None: spa_block.window_attn_plain(*a, 8, 5, plan, res=True)
    angr = lambda *a, plan=None: ang_block.ang_block(*a, 8, with_res=True, plan=plan)
    angr_p = lambda *a, plan=None: ang_block.ang_block_plain(*a, 8, with_res=True, plan=plan)
    pm = lambda *a, plan=None: spa_block.ffn_out(*a, views=2, plan=plan)
    pm_p = lambda *a, plan=None: spa_block._to_pixel_major(spa_block.ffn_out_plain(*a, plan), 2)
    steps = {"ang_block_sites": (lambda *a, plan=None: ang_block.ang_block(*a, 8, plan=plan),
                                 lambda *a, plan=None: ang_block.ang_block_plain(*a, 8, plan=plan),
                                 (x, pe, wa)),
             "ang_block_res_sites": (angr, angr_p, (x, pe, wa)),
             "spa_qkv_sites": (spa_block.qkv, spa_block.qkv_plain, (xn, tok, ws)),
             "spa_window_attn_sites": (win, win_p, (q, k, v)),
             "spa_window_attn_res_sites": (winr, winr_p, (q, k, v)),
             "spa_ffn_out_sites": (spa_block.ffn_out, spa_block.ffn_out_plain, (xn2, x2, ws)),
             "spa_ffn_out_pm_sites": (pm, pm_p, (xn2, x2, ws))}
    assert set(steps) == set(MIXED_SITES)
    tup = lambda o: o if isinstance(o, tuple) else (o,)
    for name, (kern, plain, ins) in steps.items():
        reset_launches()
        got = tup(kern(*ins, plan=plan))
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == {name: 1}, name
        ref, ref32 = tup(plain(*ins, plan=plan)), tup(plain(*ins))
        outs, stats, attn = range(len(got)), (), None
        if name == "ang_block_res_sites":   # out, attn; m, l; attn at `awo`'s dtype
            outs, stats, attn, site = (0, 3), (1, 2), got[3], "awo"
        elif name == "spa_window_attn_res_sites":
            outs, stats, attn, site = (0,), (1, 2), got[0], "wo"
        _mixed_close(*(tuple(t[i] for i in outs) for t in (got, ref, ref32)))
        assert all(l2(got[i], ref[i]) <= 1e-3 for i in stats), name
        if attn is not None:
            assert torch.equal(attn, common.bf16_round(attn)) == plan[site], name
        assert all(torch.equal(a, b) for a, b in zip(got, tup(kern(*ins, plan=plan)))), name


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [SITES_S1, SITES_S2])
def test_mixed_sites_forward_on_card(cuda_device, monkeypatch, spec):
    """`--dtype mixed` under a site subset on the card: the forward launches
    each fused step's instance as `common.card_fwd` names it, 4 times each
    (under S1 the four `_sites` steps, K2.1 `_bf16` and K2.4 f32), its
    distance from the f32 forward within 10% of the plain blocks' and its
    L2 from theirs within 1.5 of it, bitwise on a repeat; under grad K1 res's
    and K2.3 res's `_sites` forms in place of K1's and K2.3's, with the
    backward plans `none` and `all`."""
    from lft_torch.kernels import common
    monkeypatch.setenv("LFT_MM_HP_SITES", spec)
    plan = _plan_sites(spec)
    args = Args(channels=16, scale_factor=2, dtype="mixed")
    p = _params(16, cuda_device, seed=3)
    lr = torch.from_numpy(np.random.RandomState(0).rand(2, 1, 80, 80).astype(np.float32))
    lr = lr.to(cuda_device)
    expect = lambda names: {n + common.card_fwd(plan, n): 4 for n in names}
    reset_launches()
    with torch.no_grad():
        got = lft.forward(p, lr, args)
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == expect(FORWARD)
        if spec == SITES_S1:
            assert expect(FORWARD) == {
                "ang_block_sites": 4, "spa_tokenize_ln_bf16": 4, "spa_qkv_sites": 4,
                "spa_window_attn_sites": 4, "spa_outproj_ln": 4, "spa_ffn_out_sites": 4}
        assert torch.equal(got, lft.forward(p, lr, args))
        ref = lft.forward(p, lr, args, plain_blocks=True)
        f32 = lft.forward(p, lr, Args(channels=16, scale_factor=2))
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    assert abs(l2(got, f32) / l2(ref, f32) - 1) <= 0.1, (l2(got, f32), l2(ref, f32))
    assert l2(got, ref) <= 1.5 * l2(ref, f32)
    train = ["ang_block_res" if n == "ang_block" else "spa_window_attn_res"
             if n == "spa_window_attn" else n for n in FORWARD]
    for bwd in ("none", "all"):
        monkeypatch.setenv("LFT_MM_HP_BWD_SITES", bwd)
        pg = {k_: v_.clone().requires_grad_(True) for k_, v_ in p.items()}
        reset_launches()
        out = lft.forward(pg, lr, args)
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == expect(train), bwd
        out.square().mean().backward()
        torch.cuda.synchronize()
        assert all(torch.isfinite(t.grad).all() for t in pg.values()), bwd


# ------------------------------------- LFT_MM_HP_BWD_SITES subsets (9h-b) ---

@pytest.mark.cuda
@pytest.mark.parametrize("spec", [SITES_S1, SITES_S2])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_mixed_bwd_sites_kernels(cuda_device, C, spec):
    """Each backward `_sites` instance (K3.a, K3.b, K3.c, K3.d, K4 at A2 = 25
    and 81) under the subset against its plain version, from the plain f32
    forward's residuals and the plain chain's inputs under the subset:
    `_mixed_close` per output (the LN partial sums summed), each launched
    once and bitwise on a repeat."""
    from lft_torch.kernels import MIXED_BWD_SITES
    plan = _plan_sites(spec)
    g = torch.Generator(device=cuda_device).manual_seed(C + 2 * len(spec))
    ws = spa_block._with_mlp(spa_block.spa_weights(_params(C, cuda_device), "altblock.2.spa_trans."))
    xs = torch.randn(2, 17, 40, C, device=cuda_device, generator=g)
    pe_tok = torch.randn(17, 40, 2 * C, device=cuda_device, generator=g)
    dout = torch.randn(2, 17, 40, C, device=cuda_device, generator=g)
    _, tok, m, l, attn = spa_block.spa_block_plain(xs, pe_tok, ws, 8, 5, with_res=True)
    dx2, dattn = spa_block.ffn_out_bwd_plain(attn, tok, dout, ws, plan)[:2]
    _, q, k, v = spa_block.ln_qkv_plain(tok, pe_tok, ws, plan)
    dq, dk, dv = spa_block.window_attn_bwd_plain(q, k, v, attn, dattn, m, l, 8, 5, plan)
    wa = ang_block.ang_weights(_params(C, cuda_device), "altblock.1.ang_trans.")
    k4 = {}
    for N, A2 in ((37, 25), (7, 81)):
        x = torch.randn(N, A2, C, device=cuda_device, generator=g)
        pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
        k4[A2] = (x, pe, wa, *ang_block.ang_block_plain(x, pe, wa, 8, with_res=True)[1:],
                  torch.randn(N, A2, C, device=cuda_device, generator=g), 8)
    summed = lambda o: (*o[:-1], o[-1].sum(0))
    steps = {"spa_ffn_out_bwd_sites": (spa_block.ffn_out_bwd, spa_block.ffn_out_bwd_plain,
                                       (attn, tok, dout, ws), True),
             "spa_ln_qkv_sites": (spa_block.ln_qkv, spa_block.ln_qkv_plain, (tok, pe_tok, ws),
                                  False),
             "spa_window_attn_bwd_sites": (spa_block.window_attn_bwd,
                                           spa_block.window_attn_bwd_plain,
                                           (q, k, v, attn, dattn, m, l, 8, 5), False),
             "spa_qkv_ln_bwd_sites": (spa_block.qkv_ln_bwd, spa_block.qkv_ln_bwd_plain,
                                      (tok, pe_tok, dq, dk, dv, dx2, ws), True),
             "ang_block_bwd_sites": (ang_block.ang_block_bwd_ops, ang_block.ang_block_bwd_ops_plain,
                                     k4[25], True),
             "ang_block_bwd128_sites": (ang_block.ang_block_bwd_ops,
                                        ang_block.ang_block_bwd_ops_plain, k4[81], True)}
    assert set(steps) == set(MIXED_BWD_SITES)
    for name, (kern, plain, ins, part) in steps.items():
        reset_launches()
        got = kern(*ins, plan=plan)
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == {name: 1}, name
        again = kern(*ins, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        ref, ref32 = plain(*ins, plan=plan), plain(*ins)
        if part:
            got = summed(got)
            ref, ref32 = ((*r[:-1], r[-1][0]) for r in (ref, ref32))
        _mixed_close(got, ref, ref32)


@pytest.mark.cuda
@pytest.mark.parametrize("fwd,bwd", [("none", SITES_S1), (SITES_S2, SITES_S2),
                                     ("none", "aqkv,ascore,aav,awo,affn")])
def test_mixed_bwd_sites_train_step_on_card(cuda_device, monkeypatch, fwd, bwd):
    """`--dtype mixed` training with both plans set on the card: a forward
    under grad and its backward launch each kernel as `common.card_plan`
    names it, 4 times each (K4 as `ang_block_bwd_dp` where the backward
    keeps K4's sites f32 after a forward under `none`), the gradients finite
    and their distance from the plain blocks' within 1.5 of the plain
    blocks' distance from the f32 gradients, and their own distance from the
    f32 gradients within 1 +- 0.1 of the plain blocks'."""
    from lft_torch.kernels import common
    monkeypatch.setenv("LFT_MM_HP_SITES", fwd)
    monkeypatch.setenv("LFT_MM_HP_BWD_SITES", bwd)
    plan = common.active(common.mm_site_plan(True, common.mm_hp_sites()))
    bplan = common.active(common.mm_site_plan(True, common.mm_hp_sites("LFT_MM_HP_BWD_SITES",
                                                                       "none")))
    names = common.card_plan(plan, bplan)
    args = Args(channels=16, scale_factor=2, dtype="mixed")
    p = _params(16, cuda_device, seed=3)
    lr = torch.from_numpy(np.random.RandomState(0).rand(2, 1, 80, 80).astype(np.float32))
    lr = lr.to(cuda_device)

    def grads(a, **kw):
        pg = {k_: v_.clone().requires_grad_(True) for k_, v_ in p.items()}
        lft.forward(pg, lr, a, **kw).square().mean().backward()
        torch.cuda.synchronize()
        return torch.cat([pg[k_].grad.reshape(-1) for k_ in sorted(pg)])

    reset_launches()
    g_k = grads(args)
    got = {n: c for n, c in LAUNCHES.items() if c}
    kinds = ("ang_block_res", "spa_tokenize_ln", "spa_qkv", "spa_window_attn_res",
             "spa_outproj_ln", "spa_ffn_out", "spa_ffn_out_bwd", "spa_ln_qkv",
             "spa_window_attn_bwd", "spa_qkv_ln_bwd", "spa_tokenize_bwd", "ang_block_bwd")
    assert all(got.get(names[k_]) == 4 for k_ in kinds), got
    if bwd.startswith("aqkv"):
        assert names["ang_block_bwd"] == "ang_block_bwd_dp"
    else:
        assert {names[k_] for k_ in kinds[6:] if k_ != "spa_tokenize_bwd"} == {
            k_ + "_sites" for k_ in kinds[6:] if k_ != "spa_tokenize_bwd"}
    g_p = grads(args, plain_blocks=True)
    g_f = grads(Args(channels=16, scale_factor=2))
    assert torch.isfinite(g_k).all()
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    assert l2(g_k, g_p) <= 1.5 * l2(g_p, g_f), (l2(g_k, g_p), l2(g_p, g_f))
    assert abs(l2(g_k, g_f) / l2(g_p, g_f) - 1) <= 0.1, (l2(g_k, g_f), l2(g_p, g_f))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", [(2, 8, 8), (1, 3, 2), (2, 1, 13), (3, 12, 20)])
def test_window_bf16io_mma_kernel_forms(cuda_device, C, V, h, w):
    """The bf16-IO window kernel on the tensor cores (csrc/window_mma.cuh),
    at every head width (DH = 4, 8, 16) and views no 8 x 8 tile divides or
    smaller than one: against the plain bf16 version (`_bf16_close`), m and
    l against its (m in every head's slot), and its four launch forms (K2.3
    `spa_window_attn[_res]_bf16io`, K5 `spa_attn_hp[_res]_bf16io`) bit for
    bit one another, each launched once under its own name."""
    g = torch.Generator(device=cuda_device).manual_seed(C + h + w)
    q, k, v = (torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g) * s
               for s in (1.5, 1.5, 1.0))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    forms = {"spa_window_attn_bf16io": lambda: (spa_block.window_attn(q, k, v, 8, 5),),
             "spa_window_attn_res_bf16io": lambda: spa_block.window_attn(q, k, v, 8, 5, True),
             "spa_attn_hp_bf16io": lambda: (spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5),),
             "spa_attn_hp_res_bf16io": lambda: spa_attn_hp.spa_attn_hp_fwd(q, k, v, 8, 5, True)}
    outs = {}
    for name, fn in forms.items():
        reset_launches()
        outs[name] = fn()
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == {name: 1}
    ref = spa_block.window_attn_plain(q, k, v, 8, 5)
    ref32 = spa_block.window_attn_plain(q.float(), k.float(), v.float(), 8, 5)[0]
    _bf16_close(outs["spa_window_attn_bf16io"], ref[:1], (ref32,))
    for name in ("spa_window_attn_res_bf16io", "spa_attn_hp_res_bf16io"):
        torch.testing.assert_close(outs[name][1], ref[1], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(outs[name][2], ref[2], atol=1e-5, rtol=1e-4)
    first = outs["spa_window_attn_res_bf16io"]
    assert all(torch.equal(a, b) for a, b in zip(outs["spa_attn_hp_res_bf16io"], first))
    assert all(torch.equal(o[0], first[0]) for o in outs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [SITES_S1, SITES_S2])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_ffn_out_sites_kernels_pm_and_masks(cuda_device, C, spec):
    """K2.5's `_sites` kernels (csrc/ffn_sites.cuh): K11.5's output is the
    view-major one's pixel-major bit for bit (so that K11 under the subset
    is K2's chain), a call repeats bitwise, and the C entry refuses a mask
    that rounds both or neither of `ffn` and `lin` (those take the `_bf16`
    or f32 instance) with cudaErrorInvalidValue."""
    import ctypes

    from lft_torch.kernels import _build, common
    from lft_torch.kernels.rowgemm import ffn_out_floats
    plan = _plan_sites(spec)
    ws = spa_block.spa_weights(_params(C, cuda_device), "altblock.2.spa_trans.")
    g = torch.Generator(device=cuda_device).manual_seed(C)
    xn2, x2 = (torch.randn(50, 9, 7, 2 * C, device=cuda_device, generator=g) for _ in range(2))
    got = spa_block.ffn_out(xn2, x2, ws, plan=plan)
    assert torch.equal(got, spa_block.ffn_out(xn2, x2, ws, plan=plan))
    assert torch.equal(spa_block.ffn_out(xn2, x2, ws, 25, plan=plan),
                       spa_block._to_pixel_major(got, 25))
    fn = _build.bind("spa_block", "lft_spa_ffn_out_sites", 7, (ctypes.c_int,) * 3)
    wf = torch.empty(ffn_out_floats(C), device=cuda_device)
    out = torch.empty_like(got)
    bits = common.SITE_BITS
    for mask in (0, bits["ffn"] | bits["lin"]):
        rc = fn(xn2.data_ptr(), x2.data_ptr(), *(ws[n].data_ptr() for n in ("w1", "w2", "wlin")),
                wf.data_ptr(), out.data_ptr(), xn2.numel() // (2 * C), C, mask,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 1   # cudaErrorInvalidValue


# ---- K1's all-bf16 forms and K2.5 bf16io on their bf16 tensor-core designs
# (csrc/ang_bf16.cuh, csrc/ffn_bf16.cuh)

@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(9, 37), (25, 37), (81, 64), (121, 64)])
def test_ang_bf16_kernel_forms(cuda_device, C, A2, N):
    """K1's four all-bf16 forms on one kernel (csrc/ang_bf16.cuh), at every
    width, pixels of 9-121 views and a last tile only partly filled (at 81
    and 121 views a tile is one pixel, its last rows empty; 64 pixels there,
    since at a few a single q, k or v value that rounds the other way in
    one version moves a few hundred of attn's bf16 roundings, and one draw
    would decide the share):
    `ang_block_bf16io` and `ang_block_res_bf16io` against the plain bf16
    version (`_bf16_close`, `_bf16t_close`), `ang_block_bf16` and
    `ang_block_res_bf16` against the plain version under the plan `none`
    (`_mixed_close`; m, l within L2 1e-3); each `_res` form's out bit for
    bit its forward's, m one value a token, every call repeating bitwise,
    one launch each under its name."""
    from lft_torch.kernels import common
    g = torch.Generator(device=cuda_device).manual_seed(C + A2)
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    wb = ang_block.ang_weights(_bf16_params(C, cuda_device), "altblock.1.ang_trans.")
    wf = ang_block.ang_weights(_params(C, cuda_device), "altblock.1.ang_trans.")
    x = torch.randn(N, A2, C, device=cuda_device, generator=g)
    xb = x.bfloat16()
    plan = _plan_none()
    reset_launches()
    fwd_b = ang_block.ang_block(xb, pe, wb, 8)
    res_b = ang_block.ang_block(xb, pe, wb, 8, with_res=True)
    fwd_f = ang_block.ang_block(x, pe, wf, 8, plan=plan)
    res_f = ang_block.ang_block(x, pe, wf, 8, with_res=True, plan=plan)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "ang_block_bf16io": 1, "ang_block_res_bf16io": 1, "ang_block_bf16": 1,
        "ang_block_res_bf16": 1}
    wb32 = {k: v.float() for k, v in wb.items()}
    _bf16_close((fwd_b,), (ang_block.ang_block_plain(xb, pe, wb, 8),),
                (ang_block.ang_block_plain(xb.float(), pe, wb32, 8),))
    _bf16t_close(res_b, ang_block.ang_block_plain(xb, pe, wb, 8, with_res=True),
                 ang_block.ang_block_plain(xb.float(), pe, wb32, 8, with_res=True))
    _mixed_close((fwd_f,), (ang_block.ang_block_plain(x, pe, wf, 8, plan=plan),),
                 (ang_block.ang_block_plain(x, pe, wf, 8),))
    ref = ang_block.ang_block_plain(x, pe, wf, 8, with_res=True, plan=plan)
    ref32 = ang_block.ang_block_plain(x, pe, wf, 8, with_res=True)
    _mixed_close((res_f[0], res_f[3]), (ref[0], ref[3]), (ref32[0], ref32[3]))
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    assert l2(res_f[1], ref[1]) <= 1e-3 and l2(res_f[2], ref[2]) <= 1e-3
    assert torch.equal(res_f[3], common.bf16_round(res_f[3]))
    for res, fwd in ((res_b, fwd_b), (res_f, fwd_f)):
        assert torch.equal(res[0], fwd)
        assert torch.equal(res[1], res[1][..., :1].expand_as(res[1]))   # the token's max
    assert torch.equal(fwd_b, ang_block.ang_block(xb, pe, wb, 8))
    assert torch.equal(fwd_f, ang_block.ang_block(x, pe, wf, 8, plan=plan))
    assert all(torch.equal(a, b) for a, b in
               zip(res_b, ang_block.ang_block(xb, pe, wb, 8, with_res=True)))
    assert all(torch.equal(a, b) for a, b in
               zip(res_f, ang_block.ang_block(x, pe, wf, 8, with_res=True, plan=plan)))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w,A2", [(3, 9, 7, 3), (50, 17, 23, 25), (20, 32, 32, 4)])
def test_ffn_out_bf16io_kernel(cuda_device, C, V, h, w, A2):
    """K2.5 and K11.5 in bf16 IO on the `_bf16` kernel with bf16 rows
    (csrc/ffn_bf16.cuh) at every width, on ragged token counts: against the
    plain bf16 version (`_bf16_close`), a bitwise repeat, K11.5's output
    K2.5's pixel-major copy bit for bit, one launch of each."""
    ws = spa_block.spa_weights(_bf16_params(C, cuda_device), "altblock.2.spa_trans.")
    ws32 = {k: v.float() for k, v in ws.items()}
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    xn2, x2 = (torch.randn(V, h, w, 2 * C, device=cuda_device, generator=g).bfloat16()
               for _ in range(2))
    reset_launches()
    got = spa_block.ffn_out(xn2, x2, ws)
    pm = spa_block.ffn_out(xn2, x2, ws, A2)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"spa_ffn_out_bf16io": 1,
                                                        "spa_ffn_out_pm_bf16io": 1}
    assert got.dtype == pm.dtype == torch.bfloat16 and got.shape == (V, h, w, C)
    _bf16_close((got,), (spa_block.ffn_out_plain(xn2, x2, ws),),
                (spa_block.ffn_out_plain(xn2.float(), x2.float(), ws32),))
    assert torch.equal(got, spa_block.ffn_out(xn2, x2, ws))
    assert torch.equal(pm, spa_block._to_pixel_major(got, A2))


# ---- K1's `_sites` forms and K2.1's / K11.1's bf16 forms on their bf16
# tensor-core designs (csrc/ang_sites.cuh, csrc/tok_bf16.cuh)

# a third K1 mask beside S1 and S2: `aqkv` and `awo` round, the attention's
# scores and e v both f32 (S1: bf16 scores, f32 e v; S2 the reverse)
SITES_M3 = "tok,qk,v,score,av,wo,ffn,lin,ascore,aav,affn"


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [SITES_S1, SITES_S2, SITES_M3])
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("A2,N", [(25, 37), (81, 64), (121, 64)])
def test_ang_sites_kernel_forms(cuda_device, C, A2, N, spec):
    """K1's `_sites` forms on one kernel (csrc/ang_sites.cuh) under S1, S2
    and M3 at every width and pixels of 25-121 views (a last tile partly
    filled; 64 pixels at 81 and 121 views, as test_ang_bf16_kernel_forms
    says why): `ang_block_sites` and `ang_block_res_sites` against the plain
    version under the subset, out and attn by `_mixed_close` below C = 64,
    and at every C no further from float64 at the plain version's rounding
    points than the plain version plus 1/10 of its mixed-vs-f32 distance (at
    C = 64 the plain version's own f32 error is a share of that distance:
    chip_smoke.py's `f64_err`); m, l within L2 1e-3, m one value a token,
    attn bf16 values exactly where `awo` rounds; the `_res` form's out bit
    for bit its forward's, every call repeating bitwise, one launch each."""
    from lft_torch.kernels import common
    plan = _plan_sites(spec)
    assert common.card_fwd(plan, "ang_block") == "_sites"
    g = torch.Generator(device=cuda_device).manual_seed(C + A2 + len(spec))
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    wa = ang_block.ang_weights(_params(C, cuda_device), "altblock.1.ang_trans.")
    x = torch.randn(N, A2, C, device=cuda_device, generator=g)
    reset_launches()
    fwd = ang_block.ang_block(x, pe, wa, 8, plan=plan)
    res = ang_block.ang_block(x, pe, wa, 8, with_res=True, plan=plan)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"ang_block_sites": 1,
                                                        "ang_block_res_sites": 1}
    ref = ang_block.ang_block_plain(x, pe, wa, 8, with_res=True, plan=plan)
    ref32 = ang_block.ang_block_plain(x, pe, wa, 8, with_res=True)
    exact = ang_block.ang_block_plain(x.double(), pe.double(),
                                      {k: v.double() for k, v in wa.items()}, 8, with_res=True,
                                      plan=plan)
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    if C < 64:
        _mixed_close((res[0], res[3]), (ref[0], ref[3]), (ref32[0], ref32[3]))
    for i in (0, 3):
        assert l2(res[i], exact[i]) <= l2(ref[i], exact[i]) + 0.1 * l2(ref32[i], ref[i]), i
        assert l2(res[i], ref[i]) <= 1e-3, i
    assert l2(res[1], ref[1]) <= 1e-3 and l2(res[2], ref[2]) <= 1e-3
    assert torch.equal(res[3], common.bf16_round(res[3])) == plan["awo"]
    assert torch.equal(res[0], fwd) and torch.equal(res[1], res[1][..., :1].expand_as(res[1]))
    assert torch.equal(fwd, ang_block.ang_block(x, pe, wa, 8, plan=plan))
    assert all(torch.equal(a, b) for a, b in
               zip(res, ang_block.ang_block(x, pe, wa, 8, with_res=True, plan=plan)))


@pytest.mark.cuda
def test_ang_sites_kernel_refuses_a_mask_without_a_split(cuda_device):
    """The `_sites` C entries take a mask that rounds some of K1's five
    sites and not others; none or all of them is refused
    (cudaErrorInvalidValue): those take the f32 and all-bf16 instances."""
    import ctypes

    from lft_torch.kernels import _build, common
    from lft_torch.kernels.rowgemm import ang_sites_floats
    C, A2 = 16, 25
    wa = ang_block.ang_weights(_params(C, cuda_device), "altblock.1.ang_trans.")
    x = torch.randn(5, A2, C, device=cuda_device)
    pe = torch.from_numpy(angular_position(A2, C)).to(cuda_device)
    out, wf = torch.empty_like(x), torch.empty(ang_sites_floats(C), device=cuda_device)
    fn = _build.library("ang_block").lft_ang_block_fwd_sites
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                   ctypes.c_void_p]
    every = sum(common.SITE_BITS[s] for s in ("aqkv", "ascore", "aav", "awo", "affn"))
    for mask in (0, every, common.SITE_BITS["tok"]):
        rc = fn(x.data_ptr(), pe.data_ptr(), *(wa[n].data_ptr() for n in ang_block.WEIGHTS),
                wf.data_ptr(), out.data_ptr(), 5, A2, C, 8, (C // 8) ** -0.5, mask,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 1, mask   # cudaErrorInvalidValue


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w,A2", [(6, 32, 32, 3), (4, 30, 30, 2), (2, 64, 64, 2)])
def test_tok_bf16_kernel_forms(cuda_device, C, V, h, w, A2):
    """K2.1's and K11.1's four bf16 forms on one kernel (csrc/tok_bf16.cuh)
    at every width and at 32 x 32, 30 x 30 and 64 x 64 views:
    `spa_tokenize_ln_bf16io` against the plain bf16 version (`_bf16_close`),
    `spa_tokenize_ln_bf16` against the plain version under the plan `none`
    (`_mixed_close`), the pixel-major forms bit for bit their view-major
    counterparts on the permuted copy; every call repeating bitwise, one
    launch each under its name."""
    g = torch.Generator(device=cuda_device).manual_seed(C + h)
    ws = spa_block._with_mlp(spa_block.spa_weights(_params(C, cuda_device),
                                                   "altblock.2.spa_trans."))
    wb = {k: v.bfloat16() for k, v in ws.items()}
    wb32 = {k: v.float() for k, v in wb.items()}
    x = torch.randn(V, h, w, C, device=cuda_device, generator=g)
    pe = torch.randn(h, w, 2 * C, device=cuda_device, generator=g)
    xb, peb = x.bfloat16(), pe.bfloat16()
    to_pm = lambda t: t.reshape(V // A2, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()
    plan = _plan_none()
    reset_launches()
    got_b = spa_block.tokenize_ln(xb, peb, wb)
    pm_b = spa_block.tokenize_ln(to_pm(xb), peb, wb, pixel_major=True)
    got_f = spa_block.tokenize_ln(x, pe, ws, plan=plan)
    pm_f = spa_block.tokenize_ln(to_pm(x), pe, ws, pixel_major=True, plan=plan)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "spa_tokenize_ln_bf16io": 1, "spa_tokenize_ln_pm_bf16io": 1, "spa_tokenize_ln_bf16": 1,
        "spa_tokenize_ln_pm_bf16": 1}
    _bf16_close(got_b, spa_block.tokenize_ln_plain(xb, peb, wb),
                spa_block.tokenize_ln_plain(xb.float(), peb.float(), wb32))
    _mixed_close(got_f, spa_block.tokenize_ln_plain(x, pe, ws, plan=plan),
                 spa_block.tokenize_ln_plain(x, pe, ws))
    for a, b in ((pm_b, got_b), (pm_f, got_f)):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert all(torch.equal(u, v) for u, v in zip(got_b, spa_block.tokenize_ln(xb, peb, wb)))
    assert all(torch.equal(u, v) for u, v in zip(got_f, spa_block.tokenize_ln(x, pe, ws,
                                                                              plan=plan)))
