"""The port's K8, K9 and K6 (the key-view sweep, the 25-offset sweep and the
tile-dense window attention) against the JAX package, on the CPU.

* Each family's plain PyTorch forward (out, m, l) against lft_tpu's Pallas
  kernel in interpret mode (`_fwd` / `_call_fwd`, as tests/test_kernels.py
  runs them): atol 2e-5 / rtol 1e-4, the same f32 math summed in another
  order. The statistics are compared after mapping lft_tpu's layouts
  ([Np*A2, H] in (chunk, view, pixel) order; [B*bands, rows*w, H];
  [B, tiles, nq, H]) onto the port's ([N, A2, H], [B, h, w, H]).
* Each plain backward against `jax.vjp` of `ang_attention`,
  `windowed_attention`, `windowed_attention_mxu` within 5e-4 max |ref| + 2e-9
  (the JAX package's own gradient bound), and against torch.autograd of a
  dense masked reference within 5e-5 max |ref|.
* With the projections (`ang_attention_pallas_ad`,
  `local_attention_pallas_ad`, `local_attention_tile_mxu`): value and all four
  gradients through the autograd Functions against jax.grad.
* The whole model (2 of the 4 AltFilter blocks, C = 16): unfused forward,
  gradients, one tiled scene (1e-4) and one `--train_fused false` step against
  lft_tpu with `attention_impl='pallas'`, under LFT_ANG_VARIANT=sweep +
  LFT_SPA_VARIANT=offset and under LFT_SPA_VARIANT=mxu, the knobs set for both
  packages; and a forward at angRes 12, which reaches K8 unforced.
Sizes are small: C = 16/32, views of 7 to 48 pixels, a few pixels or views.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.inference import tiled as j_tiled
from lft_tpu.kernels import ang_attn_mxu as j_mxu
from lft_tpu.kernels import ang_attn_vjp as j_sweep
from lft_tpu.kernels import local_attn_vjp as j_offset
from lft_tpu.kernels import spa_attn as j_spa
from lft_tpu.models import lft as j_lft
from lft_tpu.registry import get_model as j_get_model
from lft_tpu.training import optim as j_optim
from lft_tpu.training import trainer as j_trainer
from lft_torch.config import Args
from lft_torch.inference import tiled
from lft_torch.kernels import LAUNCHES, SWEEPS, ang_attn_vjp, local_attn, local_attn_vjp, spa_attn
from lft_torch.models import lft
from lft_torch.ops import attention
from lft_torch.registry import get_model
from lft_torch.training import optim, trainer

H = 8
FWD = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2 * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _grad_close(got, ref, what="", rel=5e-4, floor=2e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + floor, (what, err, float(np.abs(ref).max()))


def _autograd_vjp(fn, inputs, cot):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*ins), ins, cot)


def _dense_angular(q, k, v):
    return attention.attention_heads(q, k, v, H)


def _dense_window(q, k, v):
    return attention.windowed_attention(q, k, v, H, 5, impl="dense")


# ------------------------------------------------------------------- K8 ---

def _k8_stats(x, N, A2):
    """lft_tpu's [Np*A2, H] statistics, (chunk, view, pixel) order -> [N, A2, H]."""
    x = np.asarray(x)
    return x.reshape(-1, A2, j_sweep._CHUNK, H).transpose(0, 2, 1, 3).reshape(-1, A2, H)[:N]


K8_SHAPES = [(25, 7, 32), (144, 5, 16), (9, 37, 16)]   # N is never a multiple of 32


@pytest.mark.parametrize("A2,N,C", K8_SHAPES)
def test_k8_plain_forward_matches_jax(A2, N, C):
    q, k, v = (_rand((N, A2, C), 10 + i) for i in range(3))
    ref, m_ref, l_ref = j_sweep._fwd(*_j(q, k, v), H)
    out, m, l = ang_attn_vjp.ang_attention_sweep_plain(*_t(q, k, v), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(m.numpy(), _k8_stats(m_ref, N, A2), **FWD)
    np.testing.assert_allclose(l.numpy(), _k8_stats(l_ref, N, A2), **FWD)
    torch.testing.assert_close(ang_attn_vjp.ang_attention(*_t(q, k, v), H), out)
    torch.testing.assert_close(out, _dense_angular(*_t(q, k, v)), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("A2,N,C", K8_SHAPES)
def test_k8_plain_bwd_matches_jax_vjp(A2, N, C):
    q, k, v, dout = (_rand((N, A2, C), 20 + i) for i in range(4))
    _, vjp = jax.vjp(lambda *a: j_sweep.ang_attention(*a, H), *_j(q, k, v))
    ref = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = _t(q, k, v, dout)
    out, m, l = ang_attn_vjp.ang_attn_sweep_fwd(qt, kt, vt, H, with_stats=True)
    got = ang_attn_vjp.ang_attn_sweep_bwd(qt, kt, vt, out, m, l, dt, H)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g.numpy(), r, name)


def test_k8_plain_bwd_matches_autograd():
    q, k, v, dout = _t(*(_rand((6, 25, 32), 30 + i) for i in range(4)))
    ref = _autograd_vjp(_dense_angular, [q, k, v], dout)
    out, m, l = ang_attn_vjp.ang_attention_sweep_plain(q, k, v, H)
    got = ang_attn_vjp.ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, H)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g, r, name, rel=5e-5, floor=0.0)


@pytest.mark.parametrize("P", [6, 5], ids=["pairs-packed-in-jax", "odd"])
def test_ang_attention_pallas_ad_matches_jax(P):
    """The AngTrans attention with its projections, value and all four
    gradients through `AngSweepFn` against jax.grad through lft_tpu's custom
    VJP (with an even pixel count lft_tpu packs pixel pairs; the port has
    nothing to pack and computes the same function)."""
    A2, C = 25, 32
    qn, v = _rand((1, P, A2, C), 40), _rand((1, P, A2, C), 41)
    wi, wo = _rand((3 * C, C), 42, 0.2), _rand((C, C), 43, 0.2)
    ref = j_sweep.ang_attention_pallas_ad(*_j(qn, v, wi, wo), H)
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(j_sweep.ang_attention_pallas_ad(*a, H))),
                     argnums=(0, 1, 2, 3))(*_j(qn, v, wi, wo))
    ins = [t.requires_grad_(True) for t in _t(qn, v, wi, wo)]
    out = ang_attn_vjp.ang_attention_pallas_ad(*ins, H)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    got = torch.autograd.grad(torch.sin(out).sum(), ins)
    for name, g, r in zip(("dqn", "dv", "dwi", "dwo"), got, g_ref):
        _grad_close(g.numpy(), r, name)


# ------------------------------------------------------------------- K9 ---

K9_SHAPES = [(2, 7, 7, 32), (1, 8, 101, 32), (1, 32, 32, 32)]   # the last: 2 bands in JAX's backward


@pytest.mark.parametrize("B,h,w,E", K9_SHAPES)
def test_k9_plain_forward_matches_jax(B, h, w, E):
    q, k, v = (_rand((B, h, w, E), 50 + i) for i in range(3))
    ref, m_ref, l_ref = j_offset._fwd(*_j(q, k, v), H, 5)
    out, m, l = local_attn_vjp.windowed_attention_offset_plain(*_t(q, k, v), H, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref).reshape(B, h, w, H), **FWD)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref).reshape(B, h, w, H), **FWD)
    torch.testing.assert_close(local_attn_vjp.windowed_attention(*_t(q, k, v), H, 5), out)
    torch.testing.assert_close(out, _dense_window(*_t(q, k, v)), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("B,h,w,E", K9_SHAPES)
def test_k9_plain_bwd_matches_jax_vjp(B, h, w, E):
    if h * w > 512:
        assert j_offset._num_bands(h, w) == 2
    q, k, v, dout = (_rand((B, h, w, E), 60 + i) for i in range(4))
    _, vjp = jax.vjp(lambda *a: j_offset.windowed_attention(*a, H, 5), *_j(q, k, v))
    ref = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = _t(q, k, v, dout)
    out, m, l = local_attn_vjp.spa_attn_offset_fwd(qt, kt, vt, H, 5, with_stats=True)
    got = local_attn_vjp.spa_attn_offset_bwd(qt, kt, vt, out, m, l, dt, H, 5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g.numpy(), r, name)


def test_k9_plain_bwd_matches_autograd():
    q, k, v, dout = _t(*(_rand((2, 7, 9, 32), 70 + i) for i in range(4)))
    ref = _autograd_vjp(_dense_window, [q, k, v], dout)
    out, m, l = local_attn_vjp.windowed_attention_offset_plain(q, k, v, H, 5)
    got = local_attn_vjp.windowed_attention_offset_bwd_plain(q, k, v, out, m, l, dout, H, 5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g, r, name, rel=5e-5, floor=0.0)


def test_local_attention_pallas_ad_matches_jax():
    B, h, w, E = 1, 7, 9, 32
    qn, v = _rand((B, h, w, E), 80), _rand((B, h, w, E), 81)
    wi, wo = _rand((3 * E, E), 82, 0.1), _rand((E, E), 83, 0.1)
    fn = lambda *a: j_offset.local_attention_pallas_ad(*a, H, k=5)
    ref = fn(*_j(qn, v, wi, wo))
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=(0, 1, 2, 3))(
        *_j(qn, v, wi, wo))
    ins = [t.requires_grad_(True) for t in _t(qn, v, wi, wo)]
    out = local_attn_vjp.local_attention_pallas_ad(*ins, H, k=5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    got = torch.autograd.grad(torch.sin(out).sum(), ins)
    for name, g, r in zip(("dqn", "dv", "dwi", "dwo"), got, g_ref):
        _grad_close(g.numpy(), r, name)
    # the dispatch sends this view (no tile divides it) to the same function
    torch.testing.assert_close(local_attn.local_attention_pallas(*_t(qn, v, wi, wo), H, k=5),
                               out.detach())


def test_k9_refuses_heads_that_do_not_divide_the_channels():
    """A deliberate difference: with E = 36 and 8 heads lft_tpu's kernel
    leaves channels 32-35 to no head and returns NaN there (0 / 0); the port
    raises instead, on any device, and says why."""
    q, k, v = (_rand((1, 8, 8, 36), 90 + i) for i in range(3))
    ref = np.asarray(j_offset.windowed_attention(*_j(q, k, v), H, 5))
    assert np.isfinite(ref[..., :32]).all() and np.isnan(ref[..., 32:]).all()
    with pytest.raises(ValueError, match="8 heads do not divide E = 36"):
        local_attn_vjp.windowed_attention(*_t(q, k, v), H, 5)
    z = torch.zeros(1, 8, 8, 36)
    with pytest.raises(ValueError, match="do not divide"):     # where the dispatch sends it
        local_attn.local_attention_pallas(z, z, torch.zeros(108, 36), torch.zeros(36, 36), H)


# ------------------------------------------------------------------- K6 ---

def _k6_stats(x, h, w, tile):
    """lft_tpu's [B, tiles, nq, H] statistics -> [B, h, w, H]."""
    th, tw = tile
    x = np.asarray(x)
    return x.reshape(-1, h // th, w // tw, th, tw, H).transpose(0, 1, 3, 2, 4, 5).reshape(
        -1, h, w, H)


K6_SHAPES = [(2, 16, 16, 32, (8, 16)), (1, 8, 101, 32, (8, 1)), (1, 48, 48, 32, (8, 16))]


@pytest.mark.parametrize("B,h,w,E,tile", K6_SHAPES)
def test_k6_plain_forward_matches_jax(B, h, w, E, tile):
    assert spa_attn.pick_tile(h, w) == j_spa.pick_tile(h, w) == tile
    q, k, v = (_rand((B, h, w, E), 100 + i) for i in range(3))
    ref, m_ref, l_ref = j_spa._fwd(*_j(q, k, v), H, 5, with_stats=True)
    out, m, l = spa_attn.windowed_attention_mxu_plain(*_t(q, k, v), H, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(m.numpy(), _k6_stats(m_ref, h, w, tile), **FWD)
    np.testing.assert_allclose(l.numpy(), _k6_stats(l_ref, h, w, tile), **FWD)
    torch.testing.assert_close(spa_attn.windowed_attention_mxu(*_t(q, k, v), H, 5), out)
    torch.testing.assert_close(out, _dense_window(*_t(q, k, v)), atol=2e-6, rtol=1e-5)


# the one-column tile at a narrower prime width: lft_tpu's interpret-mode
# backward unrolls every tile and head of a view
K6_BWD_SHAPES = [K6_SHAPES[0], (1, 8, 29, 32, (8, 1)), K6_SHAPES[2]]


@pytest.mark.parametrize("B,h,w,E,tile", K6_BWD_SHAPES)
def test_k6_plain_bwd_matches_jax_vjp(B, h, w, E, tile):
    assert spa_attn.pick_tile(h, w) == tile
    q, k, v, dout = (_rand((B, h, w, E), 110 + i) for i in range(4))
    _, vjp = jax.vjp(lambda *a: j_spa.windowed_attention_mxu(*a, H, 5), *_j(q, k, v))
    ref = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = _t(q, k, v, dout)
    _, m, l = spa_attn.spa_attn_mxu_fwd(qt, kt, vt, H, 5, with_stats=True)
    got = spa_attn.spa_attn_mxu_bwd(qt, kt, vt, m, l, dt, H, 5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g.numpy(), r, name)


def test_k6_plain_bwd_matches_autograd():
    q, k, v, dout = _t(*(_rand((2, 16, 8, 32), 120 + i) for i in range(4)))
    ref = _autograd_vjp(_dense_window, [q, k, v], dout)
    _, m, l = spa_attn.windowed_attention_mxu_plain(q, k, v, H, 5)
    got = spa_attn.windowed_attention_mxu_bwd_plain(q, k, v, m, l, dout, H, 5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g, r, name, rel=5e-5, floor=0.0)
    with pytest.raises(ValueError, match="no valid query tile"):
        spa_attn.windowed_attention_mxu(*_t(*(_rand((1, 7, 7, 32), 0),) * 3), H, 5)


def test_local_attention_tile_mxu_matches_jax():
    B, h, w, E = 1, 16, 16, 32
    qn, v = _rand((B, h, w, E), 130), _rand((B, h, w, E), 131)
    wi, wo = _rand((3 * E, E), 132, 0.1), _rand((E, E), 133, 0.1)
    fn = lambda *a: j_spa.local_attention_tile_mxu(*a, H, 5)
    ref = fn(*_j(qn, v, wi, wo))
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=(0, 1, 2, 3))(
        *_j(qn, v, wi, wo))
    ins = [t.requires_grad_(True) for t in _t(qn, v, wi, wo)]
    out = spa_attn.local_attention_tile_mxu(*ins, H, 5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    got = torch.autograd.grad(torch.sin(out).sum(), ins)
    for name, g, r in zip(("dqn", "dv", "dwi", "dwo"), got, g_ref):
        _grad_close(g.numpy(), r, name)


# ------------------------------------------------------ the whole slice ---

KNOBS = [("sweep", "offset", ("K8", "K9")), (None, "mxu", ("K7", "K6"))]


@pytest.fixture(params=KNOBS, ids=["sweep+offset", "mxu"])
def variant(request, monkeypatch):
    """2 of the 4 AltFilter blocks in both packages, the dispatchers' two
    knobs set for both, and a record of the plain kernel versions the port
    runs. Yields (families expected, list of families that ran)."""
    ang, spa, expect = request.param
    monkeypatch.setattr(j_lft, "LAYER_NUM", 2)
    monkeypatch.setattr(lft, "LAYER_NUM", 2)
    monkeypatch.setattr(j_mxu, "GPS", 2)
    monkeypatch.delenv("LFT_ANG_VARIANT", raising=False)
    monkeypatch.delenv("LFT_SPA_VARIANT", raising=False)
    if ang:
        monkeypatch.setenv("LFT_ANG_VARIANT", ang)
    monkeypatch.setenv("LFT_SPA_VARIANT", spa)
    ran = []
    from lft_torch.kernels import ang_attn_mxu, spa_attn_hp
    for family, mod, name in (("K8", ang_attn_vjp, "ang_attn_sweep_fwd"),
                              ("K9", local_attn_vjp, "spa_attn_offset_fwd"),
                              ("K6", spa_attn, "spa_attn_mxu_fwd"),
                              ("K7", ang_attn_mxu, "ang_attn_fwd"),
                              ("K5", spa_attn_hp, "spa_attn_hp_fwd")):
        def spy(*a, _fn=getattr(mod, name), _family=family, **kw):
            ran.append(_family)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return expect, ran


def _np_params(seed, channels=16, scale=2):
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, scale).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


def test_unfused_forward_matches_jax(variant):
    expect, ran = variant
    np_p = _np_params(200)
    x = _rand((2, 1, 40, 40), 201, 0.5) + 0.5
    jargs = JArgs(angRes=5, scale_factor=2, channels=16, model_name="LFT")
    ref = j_lft.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(x), jargs,
                        attention_impl="pallas", fused=False)
    p = lft.params_from_numpy(np_p, device="cpu")
    got = lft.forward(p, torch.from_numpy(x), Args(channels=16, scale_factor=2), fused=False,
                      attention_impl="pallas")
    assert float((got - torch.from_numpy(np.array(ref))).abs().max()) <= 2e-5
    assert ran == list(expect) * 2                   # two blocks, angular then spatial
    assert not any(LAUNCHES[k] for k in SWEEPS)      # no wrapper counts a launch on the CPU


def test_unfused_grads_match_jax(variant):
    expect, ran = variant
    np_p = _np_params(202)
    x = _rand((1, 1, 40, 40), 203, 0.5) + 0.5
    y = _rand((1, 1, 80, 80), 204, 0.5) + 0.5
    jargs = JArgs(angRes=5, scale_factor=2, channels=16, model_name="LFT")

    def jloss(p):
        sr = j_lft.forward(p, jnp.asarray(x), jargs, remat=False, fused=False,
                           attention_impl="pallas")
        return jnp.mean((sr - y) * jnp.cos(3.0 * (sr - y)))

    ref = jax.grad(jloss)({k: jnp.asarray(v) for k, v in np_p.items()})
    p = lft.params_from_numpy(np_p, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    sr = lft.forward(p, torch.from_numpy(x), Args(channels=16, scale_factor=2), fused=False,
                     attention_impl="pallas")
    yt = torch.from_numpy(y)
    ((sr - yt) * torch.cos(3.0 * (sr - yt))).mean().backward()
    assert ran == list(expect) * 2
    for k in np_p:
        _grad_close(p[k].grad.numpy(), ref[k], k)


def test_scene_sr_unfused_matches_jax(variant):
    from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
    expect, ran = variant
    np_p = _np_params(205)
    kw = dict(angRes=5, scale_factor=2, channels=16, patch_size_for_test=8, stride_for_test=4,
              eval_batch=4)
    lr, _ = lr_hr_pair(synth_lf_scene(5, 24, 24, seed=1), 2)
    h0 = lr.shape[0] // 5
    ref = j_tiled.make_scene_sr(j_lft.forward, JArgs(model_name="LFT", attention_impl="pallas",
                                                     **kw), h0, h0, eval_batch=4)(
        {k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(lr))
    sr = tiled.make_scene_sr(lft.forward, Args(attention_impl="pallas", **kw), h0, h0,
                             eval_batch=4, fused=False)(
        lft.params_from_numpy(np_p, device="cpu"), torch.from_numpy(lr))
    assert sr.shape == (lr.shape[0] * 2, lr.shape[1] * 2)
    assert float((sr - torch.from_numpy(np.array(ref))).abs().max()) <= 1e-4
    assert set(ran) == set(expect)


def test_unfused_train_step_matches_jax(variant):
    """One `--train_fused false` Adam step through the Functions of the
    families the knobs select against lft_tpu's train step through the same
    families: the loss and every updated parameter (from a warm Adam state,
    as tests/test_torch_perop.py explains)."""
    expect, ran = variant
    np_p = _np_params(206)
    x = _rand((2, 1, 40, 40), 207, 0.5) + 0.5
    y = _rand((2, 1, 80, 80), 208, 0.5) + 0.5
    kw = dict(angRes=5, scale_factor=2, channels=16, batch_size=2, lr=2e-4, n_steps=15,
              gamma=0.5, epoch=2, train_fused="false", attention_impl="pallas")
    jargs = JArgs(model_name="LFT", train_remat=False, **kw)
    tx = j_optim.make_optimizer(jargs, steps_per_epoch=10)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    jstep = j_trainer.make_train_step(j_get_model(jargs), tx, jargs, with_metrics=False)
    flat = j_trainer.flatten_opt_state(tx.init(jp))
    n = len(np_p)
    for i, key in enumerate(sorted(flat)):
        if flat[key].ndim == 0:
            flat[key] = np.asarray(5, flat[key].dtype)
        elif i > n:
            flat[key] = np.full_like(flat[key], 1e-6)
    jp2, _, aux = jstep(jp, j_trainer.unflatten_opt_state(tx.init(jp), flat), jnp.asarray(x),
                        jnp.asarray(y))

    args = Args(**kw)
    p = lft.params_from_numpy(np_p, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    opt = optim.make_optimizer(p, args, 10)
    opt.load_state(optim.opt_state_from_jax_flat(flat, p))
    step = trainer.make_train_step(get_model(args), opt, args, with_metrics=False)
    loss, _, _ = step(p, torch.from_numpy(x), torch.from_numpy(y))
    assert ran == list(expect) * 2
    assert abs(float(loss) - float(aux["loss"])) <= 1e-5 * abs(float(aux["loss"]))
    for k in np_p:
        np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(jp2[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_forward_at_angres12_reaches_k8_unforced(monkeypatch):
    """A2 = 144 fails K7's gate and the fused gate in both packages: the
    forward that asks for the fused branch runs the unfused one, with K8 for
    the angular attention and the hybrid (K5) for the 8x8 views."""
    monkeypatch.setattr(j_lft, "LAYER_NUM", 2)
    monkeypatch.setattr(lft, "LAYER_NUM", 2)
    monkeypatch.delenv("LFT_ANG_VARIANT", raising=False)
    monkeypatch.delenv("LFT_SPA_VARIANT", raising=False)
    ran = []
    monkeypatch.setattr(ang_attn_vjp, "ang_attn_sweep_fwd",
                        lambda *a, _fn=ang_attn_vjp.ang_attn_sweep_fwd, **kw:
                        ran.append(a[0].shape[1]) or _fn(*a, **kw))
    np_p = _np_params(210)
    x = _rand((1, 1, 96, 96), 211, 0.5) + 0.5
    jargs = JArgs(angRes=12, scale_factor=2, channels=16, model_name="LFT")
    ref = j_lft.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(x), jargs,
                        attention_impl="pallas", fused=True)
    p = lft.params_from_numpy(np_p, device="cpu")
    got = lft.forward(p, torch.from_numpy(x), Args(angRes=12, channels=16, scale_factor=2),
                      fused=True, attention_impl="pallas")
    assert ran == [144, 144]
    assert got.shape == (1, 1, 192, 192)
    assert float((got - torch.from_numpy(np.array(ref))).abs().max()) <= 2e-5
