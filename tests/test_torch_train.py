"""The port's training path against the JAX package, on the CPU.

* The block backwards (K4, K3) in their plain PyTorch versions against
  `jax.vjp` of lft_tpu's fused blocks, whose backward Pallas kernels run in
  interpret mode: each gradient within 5e-4 max |ref| (the JAX package's own
  fused-vs-unfused bound, tests/test_kernels.py:428).
* Each plain backward step against torch.autograd through its plain
  forward: 5e-5 max |ref| (the same f32 math, summed in another order).
* Whole-model gradients of the fused branch (plain blocks behind the
  autograd Functions) against `jax.grad` of lft_tpu's unfused forward, with
  the smooth loss of tests/test_kernels.py:446-461 and its bound
  5e-4 max |ref| + 2e-9.
* The optimizer against the optax chain, fed the same gradients, and
  checkpoint resume: bitwise in the port, and from a JAX-written `.npz`.
Sizes are small: C=16, 8x8 views, ragged pixel counts.
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.data import datasets as j_data
from lft_tpu.data import device_synth as j_synth
from lft_tpu.kernels.ang_block import ang_block_core
from lft_tpu.kernels.spa_block import spa_block_core
from lft_tpu.models import lft as j_lft
from lft_tpu.training import optim as j_optim
from lft_tpu.training import trainer as j_trainer
from lft_torch.config import Args, parse_args
from lft_torch.data import datasets, device_synth
from lft_torch.kernels import LAUNCHES, ang_block, reset_launches, spa_block, wgrad
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear
from lft_torch.training import optim, trainer
from lft_torch.utils import checkpoint

C = 16


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2 * scale).astype(np.float32)


def _np_params(seed, channels=C, scale=2):
    """Random params with LayerNorm affines away from (1, 0), so their
    gradients are tested in general position."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, scale).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


def _rel_close(got, ref, rel, floor=0.0, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + floor, (what, err, float(np.abs(ref).max()))


# ------------------------------------------------- block backwards vs JAX ---

def test_ang_block_bwd_plain_matches_jax_vjp(monkeypatch):
    """K4's plain version against jax.vjp of the fused block (N = 13 pixels
    in groups of 5, two groups a grid step: the JAX backward pads a ragged
    tail, the port masks it; small steps keep the interpret-mode trace
    short)."""
    monkeypatch.setenv("LFT_ANGB_GPS", "2")
    monkeypatch.setenv("LFT_ANGB_BWD_GPS", "2")
    p = lft.params_from_numpy(_np_params(1), device="cpu")
    wts = ang_block.ang_weights(p, "altblock.2.ang_trans.")
    N, A2 = 13, 25
    x, dout = _rand((N, A2, C), 2), _rand((N, A2, C), 3)
    pe = angular_position(A2, C)
    order = ang_block.WEIGHTS
    wn = [wts[n].numpy() for n in order]
    _, vjp = jax.vjp(lambda x_, *w: ang_block_core(x_, jnp.asarray(pe), *w, 8),
                     jnp.asarray(x), *map(jnp.asarray, wn))
    ref = vjp(jnp.asarray(dout))
    xt = torch.from_numpy(x)
    _, m, l, attn = ang_block.ang_block(xt, torch.from_numpy(pe), wts, 8, with_res=True)
    reset_launches()
    got = ang_block.ang_block_bwd(xt, torch.from_numpy(pe), wts, m, l, attn,
                                  torch.from_numpy(dout), 8)
    assert sum(LAUNCHES.values()) == 0
    for name, g, r in zip(("x",) + order, got, ref):
        _rel_close(g.numpy(), r, 5e-4, what=name)


def test_spa_block_bwd_plain_matches_jax_vjp():
    """K3's plain version against jax.vjp of the fused block, dpe_tok
    included (3 views of 8x8)."""
    p = lft.params_from_numpy(_np_params(4), device="cpu")
    prefix = "altblock.1.spa_trans."
    wts = spa_block.spa_weights(p, prefix)
    V, h, w = 3, 8, 8
    x, dout = _rand((V, h, w, C), 5), _rand((V, h, w, C), 6)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              p[prefix + "MLP.weight"])[0].contiguous()
    order = spa_block.WEIGHTS
    wn = [wts[n].numpy() for n in order]
    _, vjp = jax.vjp(lambda x_, pe_, *w_: spa_block_core(x_, pe_, *w_, 8, 5),
                     jnp.asarray(x), jnp.asarray(pe_tok.numpy()), *map(jnp.asarray, wn))
    ref = vjp(jnp.asarray(dout))
    xt = torch.from_numpy(x)
    _, tok, m, l, attn = spa_block.spa_block(xt, pe_tok, wts, 8, 5, with_res=True)
    got = spa_block.spa_block_bwd(xt, pe_tok, wts, tok, m, l, attn, torch.from_numpy(dout), 8, 5)
    for name, g, r in zip(("x", "pe_tok") + order, got, ref):
        _rel_close(g.numpy(), r, 5e-4, what=name)


# ------------------------------------- plain backwards vs torch.autograd ---

def _autograd_vjp(fn, inputs, cot):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    return torch.autograd.grad(outs, ins, cots, allow_unused=True)


@pytest.fixture(scope="module")
def spa_case():
    p = lft.params_from_numpy(_np_params(7), device="cpu")
    wts = spa_block.spa_weights(p, "altblock.0.spa_trans.")
    V, h, w, D = 2, 8, 6, 2 * C
    x = torch.from_numpy(_rand((V, h, w, C), 8))
    pe_tok = torch.from_numpy(_rand((h, w, D), 9, 0.5))
    out, tok, m, l, attn = spa_block.spa_block(x, pe_tok, wts, 8, 5, with_res=True)
    return dict(wts=wts, x=x, pe_tok=pe_tok, tok=tok, m=m, l=l, attn=attn,
                dout=torch.from_numpy(_rand((V, h, w, C), 10)),
                g=lambda s, seed: torch.from_numpy(_rand(s, seed)))


def test_ang_block_bwd_plain_matches_autograd():
    p = lft.params_from_numpy(_np_params(11), device="cpu")
    wts = ang_block.ang_weights(p, "altblock.0.ang_trans.")
    x, dout = torch.from_numpy(_rand((11, 9, C), 12)), torch.from_numpy(_rand((11, 9, C), 13))
    pe = torch.from_numpy(angular_position(9, C))
    order = ang_block.WEIGHTS
    ref = _autograd_vjp(lambda x_, *w: ang_block.ang_block_plain(x_, pe, dict(zip(order, w)), 8),
                        [x] + [wts[n] for n in order], dout)
    _, m, l, attn = ang_block.ang_block_plain(x, pe, wts, 8, with_res=True)
    got = ang_block.ang_block_bwd_plain(x, pe, wts, m, l, attn, dout, 8)
    for name, g, r in zip(("x",) + order, got, ref):
        _rel_close(g, r, 5e-5, what=name)


@pytest.mark.parametrize("step", ["ffn_out", "window_attn", "qkv_ln", "tokenize", "block"])
def test_spa_bwd_steps_plain_match_autograd(spa_case, step):
    s = spa_case
    wts, tok, attn = s["wts"], s["tok"], s["attn"]
    V, h, w, D = tok.shape
    wm = spa_block._with_mlp(wts)
    if step == "ffn_out":
        def fwd(attn_, tok_):
            x2, xn2 = spa_block.outproj_ln_plain(attn_, tok_, wts)
            return x2, spa_block.ffn_out_plain(xn2, x2, wts)
        # the residual x2 receives no cotangent of its own here
        ref = _autograd_vjp(fwd, [attn, tok], (torch.zeros_like(tok), s["dout"]))
        dx2, dattn, *_ = spa_block.ffn_out_bwd_plain(attn, tok, s["dout"], wts)
        _rel_close(dattn, ref[0], 5e-5, what="dattn")
        _rel_close(dx2, ref[1], 5e-5, what="dx2 (= dtok of the residual path)")
    elif step == "window_attn":
        _, q, k, v = spa_block.ln_qkv_plain(tok, s["pe_tok"], wts)
        g = s["g"]((V, h, w, D), 14)
        ref = _autograd_vjp(lambda q_, k_, v_: spa_block.windowed_attention(q_, k_, v_, 8, 5),
                            [q, k, v], g)
        got = spa_block.window_attn_bwd_plain(q, k, v, attn, g, s["m"], s["l"], 8, 5)
        for name, a, b in zip("qkv", got, ref):
            _rel_close(a, b, 5e-5, what=name)
    elif step == "qkv_ln":
        dq, dk, dv, dx2 = (s["g"]((V, h, w, D), 15 + i) for i in range(4))
        ref = _autograd_vjp(lambda t, pe: spa_block.ln_qkv_plain(t, pe, wts)[1:],
                            [tok, s["pe_tok"]], (dq, dk, dv))
        dtok, dtokpe, _ = spa_block.qkv_ln_bwd_plain(tok, s["pe_tok"], dq, dk, dv, dx2, wts)
        _rel_close(dtok - dx2, ref[0], 5e-5, what="dtok")
        _rel_close(dtokpe.sum(0), ref[1], 5e-5, what="dpe_tok")
    elif step == "tokenize":
        g = s["g"]((V, h, w, D), 19)
        ref = _autograd_vjp(lambda x_: spa_block.tokenize_ln_plain(x_, s["pe_tok"], wm)[0],
                            [s["x"]], g)
        _rel_close(spa_block.tokenize_bwd_plain(g, wm), ref[0], 5e-5, what="dx")
        dwu = wgrad.wgrad_plain(s["x"].reshape(-1, C), g.reshape(-1, D), image=(h, w))
        ref_w = _autograd_vjp(lambda wu: unfold3x3_linear(
            s["x"], wu.permute(2, 1, 0).reshape(D, -1)), [wts["wu"]], g)
        _rel_close(dwu, ref_w[0], 5e-5, what="dwu")
    else:
        order = spa_block.WEIGHTS
        ref = _autograd_vjp(
            lambda x_, pe, *w_: spa_block.spa_block_plain(
                x_, pe, spa_block._with_mlp(dict(zip(order, w_))), 8, 5),
            [s["x"], s["pe_tok"]] + [wts[n] for n in order], s["dout"])
        got = spa_block.spa_block_bwd_plain(s["x"], s["pe_tok"], wm, tok, s["m"], s["l"],
                                            attn, s["dout"], 8, 5)
        for name, a, b in zip(("x", "pe_tok") + order, got, ref):
            _rel_close(a, b, 5e-5, what=name)


def test_window_attn_stats_plain_match_softmax():
    """The stats variant's output equals the SR path's windowed attention,
    and exp(s - m) / l recovers its probabilities (they sum to one)."""
    g = lambda seed: torch.from_numpy(_rand((2, 7, 9, 32), seed))
    q, k, v = g(20), g(21), g(22)
    attn, m, l = spa_block.window_attn(q, k, v, 8, 5, with_stats=True)
    torch.testing.assert_close(attn, spa_block.windowed_attention(q, k, v, 8, 5),
                               atol=2e-6, rtol=1e-5)
    p, _, _, _ = spa_block._window_probs(q, k, 8, 5, m, l)
    torch.testing.assert_close(p.sum(3), torch.ones_like(m), atol=1e-6, rtol=0)
    assert m.shape == l.shape == (2, 7, 9, 8)


# ------------------------------------------------ whole-model gradients ---

def test_model_grads_fused_functions_match_jax():
    """The port's fused branch (plain K1/K3/K4 behind the autograd Functions)
    against jax.grad of lft_tpu's unfused forward, every parameter."""
    np_p = _np_params(23)
    x = _rand((1, 1, 40, 40), 24, 0.5) + 0.5
    y = _rand((1, 1, 80, 80), 25, 0.5) + 0.5
    jargs = JArgs(angRes=5, scale_factor=2, channels=C, model_name="LFT")

    def jloss(p):
        sr = j_lft.forward(p, jnp.asarray(x), jargs, remat=False, fused=False)
        return jnp.mean((sr - y) * jnp.cos(3.0 * (sr - y)))

    ref = jax.grad(jloss)({k: jnp.asarray(v) for k, v in np_p.items()})
    p = lft.params_from_numpy(np_p, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    sr = lft.forward(p, torch.from_numpy(x), Args(channels=C, scale_factor=2), fused=True)
    yt = torch.from_numpy(y)
    ((sr - yt) * torch.cos(3.0 * (sr - yt))).mean().backward()
    for k in np_p:
        _rel_close(p[k].grad.numpy(), ref[k], 5e-4, 2e-9, what=k)


# --------------------------------------------------------------- optimizer ---

@pytest.mark.parametrize("schedule,decay", [("step", 0.0), ("step", 1e-3), ("cosine", 0.0)])
def test_optimizer_matches_optax(schedule, decay):
    """20 steps with the same gradients into both, across a StepLR boundary
    (2 steps an epoch, gamma every 5 epochs)."""
    kw = dict(lr=2e-4, gamma=0.5, n_steps=5, epoch=10, decay_rate=decay,
              lr_schedule=schedule)
    shapes = {"a.weight": (6, 5), "b.bias": (7,), "c.w": (3, 2, 2)}
    init = {k: _rand(s, i) for i, (k, s) in enumerate(sorted(shapes.items()))}
    tx = j_optim.make_optimizer(JArgs(**kw), steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in init.items()}
    opt = optim.make_optimizer(tp, Args(**kw), steps_per_epoch=2)
    for it in range(20):
        grads = {k: _rand(s, 100 + it * 7 + i, 10.0 ** -(i + it % 3))
                 for i, (k, s) in enumerate(sorted(shapes.items()))}
        upd, js = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, g in grads.items():
            tp[k].grad = torch.from_numpy(g)
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} step {it}")
    flat = j_trainer.flatten_opt_state(js)
    ours = opt.state_flat()
    assert sorted(flat) == sorted(ours)
    for k in flat:
        # torch moves the moments by lerp, optax by b1 mu + (1 - b1) g: they
        # round differently, by a few f32 ulps of the moment's scale
        scale = float(np.abs(flat[k]).max())
        np.testing.assert_allclose(ours[k], flat[k], rtol=1e-5, atol=1e-5 * scale, err_msg=k)
        assert ours[k].dtype == flat[k].dtype, k


def test_opt_state_from_jax_flat_layout():
    params = {"b": torch.zeros(2, 3), "a": torch.zeros(4)}
    flat = {f"leaf{i:04d}": np.full(s, i, np.float32) for i, s in
            enumerate([(), (4,), (2, 3), (4,), (2, 3), ()])}
    st = optim.opt_state_from_jax_flat(flat, params)
    assert st["count"] == 0 and st["schedule_count"] == 5
    assert float(st["mu"]["a"][0]) == 1 and float(st["mu"]["b"][0, 0]) == 2
    assert float(st["nu"]["a"][0]) == 3 and float(st["nu"]["b"][0, 0]) == 4
    with pytest.raises(ValueError, match="leaves"):
        optim.opt_state_from_jax_flat({k: flat[k] for k in list(flat)[:-1]}, params)


# ---------------------------------------------------------- fit and resume ---

class _Patches:
    """In-memory training set: `item(index, rng)` with the reference's
    augmentation, as TrainDataset serves h5 patches."""

    def __init__(self, n, seed=0, a=5, patch=8, scale=2):
        rng = np.random.RandomState(100 + seed)
        self.lr = [rng.rand(a * patch, a * patch).astype(np.float32) for _ in range(n)]
        self.hr = [rng.rand(a * patch * scale, a * patch * scale).astype(np.float32)
                   for _ in range(n)]
        self.seed = seed

    def __len__(self):
        return len(self.lr)

    def item(self, index, rng):
        d, l = datasets.augmentation(self.lr[index], self.hr[index], rng)
        return (np.ascontiguousarray(d)[None], np.ascontiguousarray(l)[None])


def _fit_args(tmp, **kw):
    base = dict(channels=C, scale_factor=2, batch_size=2, epoch=2, n_steps=1, gamma=0.5,
                num_workers=0, seed=3, train_fused="true")
    base.update(kw)
    return Args(**base)


def test_fit_kill_resume_is_bitwise(tmp_path):
    """fit for 2 epochs == fit for 1, save, load and 1 more, in params and
    Adam state (the recipe's kill/resume check, runs/ref_recipe_s4)."""
    data = _Patches(4)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    full, hist = trainer.fit(_fit_args(a), dataset=data, checkpoints_dir=str(a), device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    trainer.fit(_fit_args(b, epoch=1), dataset=data, checkpoints_dir=str(b), device="cpu")
    ck = trainer.checkpoint_path(str(b), _fit_args(b), 1)
    resumed, _ = trainer.fit(_fit_args(b, use_pre_pth=True, path_pre_pth=ck), dataset=data,
                             checkpoints_dir=str(b), device="cpu")
    for k in full:
        assert torch.equal(full[k], resumed[k]), k
    za = np.load(trainer.checkpoint_path(str(a), _fit_args(a), 2))
    zb = np.load(trainer.checkpoint_path(str(b), _fit_args(b), 2))
    assert sorted(za.files) == sorted(zb.files)
    assert any(f.startswith("__opt__/") for f in za.files)
    for f in za.files:
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)


def test_pth_checkpoint_roundtrip_and_schedule_fast_forward(tmp_path):
    """A .pth epoch checkpoint loads as the reference's state_dict; resuming
    from it restarts the moments and fast-forwards the schedule."""
    data = _Patches(4)
    args = _fit_args(tmp_path, epoch=1, ckpt_format="pth")
    params, _ = trainer.fit(args, dataset=data, checkpoints_dir=str(tmp_path), device="cpu")
    path = trainer.checkpoint_path(str(tmp_path), args, 1)
    assert path.endswith("LFT_5x5_2x_epoch_01_model.pth")
    loaded, epoch, opt = checkpoint.load_checkpoint(path, device="cpu")
    assert epoch == 1 and opt is None
    for k in params:
        assert torch.equal(loaded[k], params[k].detach())
    m = lft.LFT(args)
    m.load_state_dict(torch.load(path, weights_only=False)["state_dict"], strict=True)
    for t in loaded.values():
        t.requires_grad_(True)
    opt = optim.make_optimizer(loaded, _fit_args(tmp_path, epoch=3), steps_per_epoch=2)
    opt.count = 1 * 2
    assert opt.lr() == pytest.approx(1e-4, rel=1e-6)     # gamma once after epoch 1


def test_resume_from_jax_checkpoint(tmp_path):
    """A checkpoint that lft_tpu's fit wrote (params and Adam moments after
    one epoch), resumed by the port's fit for one step, lands where
    lft_tpu's own second epoch does."""
    data = _Patches(2, seed=5)
    jargs = JArgs(angRes=5, scale_factor=2, channels=C, model_name="LFT", batch_size=2,
                  epoch=2, n_steps=1, gamma=0.5, num_workers=0, seed=5, train_remat=False)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    j_trainer.fit(jargs, dataset=data, checkpoints_dir=str(jdir))
    name = "LFT_5x5_2x_epoch_%02d_model.npz"
    z1 = np.load(jdir / (name % 1))
    assert any(f.startswith("__opt__/") for f in z1.files)
    args = _fit_args(tmp_path, epoch=2, seed=5, use_pre_pth=True,
                     path_pre_pth=str(jdir / (name % 1)), train_fused="false")
    got, _ = trainer.fit(args, dataset=data, checkpoints_dir=str(tmp_path), device="cpu")
    z2 = np.load(jdir / (name % 2))
    for k in got:
        # one Adam step of 1e-4 from the same state: the two packages' f32
        # gradients differ in their last bits, the updates by far less
        np.testing.assert_allclose(got[k].detach().numpy(), z2[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    ours = np.load(tmp_path / (name % 2))
    for f in z2.files:
        if f.startswith("__opt__/") and z2[f].ndim == 0:
            assert int(ours[f]) == int(z2[f]), f


# ------------------------------------------------------------------- data ---

def _jax_synth_from_noise(noise, a, patch, scale):
    """lft_tpu.data.device_synth.synth_batch with its uniform draw replaced
    by `noise` (jax.random.uniform patched for one eager call)."""
    orig = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape: jnp.asarray(noise)
        return j_synth.synth_batch.__wrapped__(None, batch=noise.shape[0], ang_res=a,
                                               patch=patch, scale=scale)
    finally:
        jax.random.uniform = orig


def test_synth_batch_matches_jax_with_the_same_noise():
    noise = np.random.RandomState(0).rand(2, 8 * 2 + 2 * 7, 8 * 2 + 2 * 7).astype(np.float32)
    lr, hr = device_synth.synth_batch(torch.Generator().manual_seed(0), batch=2, ang_res=5,
                                      patch=8, scale=2, noise=noise)
    assert lr.shape == (2, 1, 40, 40) and hr.shape == (2, 1, 80, 80)
    jl, jh = _jax_synth_from_noise(noise, 5, 8, 2)
    np.testing.assert_allclose(lr.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(hr.numpy(), np.asarray(jh), atol=1e-6)
    draw = lambda: device_synth.synth_batch(torch.Generator().manual_seed(0), batch=2,
                                            ang_res=5, patch=8, scale=2)[0]
    a, b = draw(), draw()
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("workers", [0, 2])
def test_iterate_batches_match_jax(workers):
    data = _Patches(5, seed=2)
    ours = list(datasets.iterate_batches(data, 2, seed=9, num_workers=workers))
    ref = list(j_data.iterate_batches(data, 2, seed=9, num_workers=workers))
    assert len(ours) == len(ref) == 2
    for (a, b), (c, d) in zip(ours, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_augmentation_matches_jax():
    lr, hr = _rand((10, 10), 1), _rand((20, 20), 2)
    for s in range(8):
        a = datasets.augmentation(lr, hr, random.Random(s))
        b = j_data.augmentation(lr, hr, random.Random(s))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_train_dataset_reads_h5_lazily(tmp_path):
    """The module imports without h5py; TrainDataset lists the reference's
    layout and reads an item like lft_tpu's."""
    h5py = pytest.importorskip("h5py")
    d = tmp_path / "SR_5x5_2x" / "Set"
    d.mkdir(parents=True)
    with h5py.File(d / "p0.h5", "w") as f:
        f["Lr_SAI_y"] = _rand((40, 40), 3)
        f["Hr_SAI_y"] = _rand((80, 80), 4)
    kw = dict(path_for_train=str(tmp_path), angRes=5, scale_factor=2, data_name="ALL")
    ours = datasets.TrainDataset(Args(**kw), seed=1)
    ref = j_data.TrainDataset(JArgs(**kw), seed=1)
    assert len(ours) == len(ref) == 1
    for a, b in zip(ours.item(0, random.Random(4)), ref.item(0, random.Random(4))):
        np.testing.assert_array_equal(a, b)


def test_training_flags():
    a = parse_args(["--seed", "7", "--ckpt_format", "pth", "--lr_schedule", "cosine",
                    "--log_every", "3", "--train_fused", "true"])
    assert (a.seed, a.ckpt_format, a.lr_schedule, a.log_every, a.train_fused) == \
        (7, "pth", "cosine", 3, "true")
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    # auto trains the unfused branch at float32 on every device, as lft_tpu's auto
    assert not trainer.train_fused(Args(), cpu) and not trainer.train_fused(Args(), cuda)
    assert trainer.train_fused(Args(train_fused="true"), cpu)
    assert not trainer.train_fused(Args(train_fused="false"), cuda)
    assert not hasattr(Args(), "train_remat")


def test_training_entry_points_take_cuda_unless_told(tmp_path):
    """fit runs on the card unless the caller passes device='cpu'; without
    a card it raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this test checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit(_fit_args(tmp_path, epoch=1), dataset=_Patches(2))
