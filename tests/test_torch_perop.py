"""The port's unfused per-op branch against the JAX package, on the CPU.

* K7 (angular attention) and K5 (5x5-window attention) in their plain
  PyTorch versions against lft_tpu's Pallas kernels in interpret mode, as
  tests/test_kernels.py runs them: forward atol 2e-5 / rtol 1e-4 (the same
  f32 math summed in another order), dq/dk/dv against `jax.vjp` within
  5e-4 max |ref| + 2e-9 (the JAX package's own gradient bound).
* Each plain backward against torch.autograd of its plain forward: 5e-5
  max |ref| (the identities written out against autograd's).
* The dispatch against JAX's own: with every kernel entry of both packages
  replaced by a recorder, the port picks K5/K6/K7/K8/K9/K10 exactly where
  JAX does, and goes to the tiled op where JAX goes to its XLA tiled op.
* The slice as a whole: forward, gradients, a tiled scene and one train
  step of the unfused branch with `attention_impl='pallas'` against
  lft_tpu's, on the same parameters (2 of the 4 AltFilter blocks).
Sizes are small: C = 16/32, views of 8-16 pixels, odd pixel counts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.inference import tiled as j_tiled
from lft_tpu.kernels import ang_attn as j_ang
from lft_tpu.kernels import ang_attn_mxu as j_mxu
from lft_tpu.kernels import local_attn as j_local
from lft_tpu.kernels import local_attn_vjp as j_offset
from lft_tpu.kernels import spa_attn as j_spa
from lft_tpu.kernels import spa_attn_hp as j_hp
from lft_tpu.models import lft as j_lft
from lft_tpu.ops import attention as j_attention
from lft_tpu.registry import get_model as j_get_model
from lft_tpu.training import optim as j_optim
from lft_tpu.training import trainer as j_trainer
from lft_torch.config import Args, parse_args
from lft_torch.inference import tiled
from lft_torch.kernels import LAUNCHES, PEROP, ang_attn, ang_attn_mxu, ang_block
from lft_torch.kernels import local_attn, local_attn_vjp, reset_launches, spa_attn
from lft_torch.kernels import spa_attn_hp, spa_block
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


def _grad_close(got, ref, what="", rel=5e-4, floor=2e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + floor, (what, err, float(np.abs(ref).max()))


def _autograd_vjp(fn, inputs, cot):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*ins), ins, cot)


# --------------------------------------------------- K7 against lft_tpu ---

@pytest.fixture
def small_ang_steps(monkeypatch):
    """Two pixel groups a grid step keep lft_tpu's interpret-mode trace short."""
    monkeypatch.setattr(j_mxu, "GPS", 2)


@pytest.mark.parametrize("A2,N,C", [(9, 11, 16), (25, 7, 32), (49, 5, 16)])
def test_ang_k7_plain_forward_matches_jax(small_ang_steps, A2, N, C):
    """Odd N: lft_tpu pads the pixel groups and drops the pad, the port has
    no groups to pad."""
    q, k, v = (_rand((N, A2, C), 10 + i) for i in range(3))
    ref = j_mxu.ang_attention_blockdiag(*map(jnp.asarray, (q, k, v)), H)
    out, m, l = ang_attn_mxu.ang_attention_blockdiag_plain(*_t(q, k, v), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    assert m.shape == l.shape == (N, A2, H)
    torch.testing.assert_close(ang_attn_mxu.ang_attention_blockdiag(*_t(q, k, v), H), out)


@pytest.mark.parametrize("A2,N,C", [(9, 11, 16), (25, 7, 32), (49, 5, 16)])
def test_ang_k7_plain_bwd_matches_jax_vjp(small_ang_steps, A2, N, C):
    q, k, v, dout = (_rand((N, A2, C), 20 + i) for i in range(4))
    _, vjp = jax.vjp(lambda *a: j_mxu.ang_attention_blockdiag(*a, H), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = _t(q, k, v, dout)
    _, m, l = ang_attn_mxu.ang_attn_fwd(qt, kt, vt, H, with_stats=True)
    got = ang_attn_mxu.ang_attn_bwd(qt, kt, vt, m, l, dt, H)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g.numpy(), r, name)


def test_ang_k7_plain_bwd_matches_autograd():
    q, k, v, dout = _t(*(_rand((6, 25, 32), 30 + i) for i in range(4)))
    ref = _autograd_vjp(lambda *a: ang_attn_mxu.ang_attention_blockdiag_plain(*a, H)[0],
                        [q, k, v], dout)
    _, m, l = ang_attn_mxu.ang_attention_blockdiag_plain(q, k, v, H)
    got = ang_attn_mxu.ang_attention_blockdiag_bwd_plain(q, k, v, m, l, dout, H)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g, r, name, rel=5e-5, floor=0.0)


def test_ang_attention_mxu_with_projections_matches_jax(small_ang_steps):
    """The AngTrans attention with its projections, value and all four
    gradients through `AngAttnFn` against jax.grad through lft_tpu's custom
    VJP (even N: lft_tpu packs pixel pairs, the port has nothing to pack)."""
    B, P, A2, C = 1, 6, 25, 32
    qn, v = _rand((B, P, A2, C), 40), _rand((B, P, A2, C), 41)
    wi, wo = _rand((3 * C, C), 42, 0.2), _rand((C, C), 43, 0.2)
    ref = j_mxu.ang_attention_mxu(*map(jnp.asarray, (qn, v, wi, wo)), H)
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(j_mxu.ang_attention_mxu(*a, H))),
                     argnums=(0, 1, 2, 3))(*map(jnp.asarray, (qn, v, wi, wo)))
    ins = [t.requires_grad_(True) for t in _t(qn, v, wi, wo)]
    out = ang_attn.ang_attention_pallas(*ins, H)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    assert type(out.grad_fn).__name__ != "AngAttnFnBackward"   # the out projection is last
    got = torch.autograd.grad(torch.sin(out).sum(), ins)
    for name, g, r in zip(("dqn", "dv", "dwi", "dwo"), got, g_ref):
        _grad_close(g.numpy(), r, name)


# --------------------------------------------------- K5 against lft_tpu ---

@pytest.mark.parametrize("B,h,w,E", [(2, 8, 8, 32), (1, 8, 16, 64), (1, 16, 8, 32)])
def test_spa_k5_plain_forward_matches_jax(B, h, w, E):
    assert j_hp.headpacked_applicable(h, w, E, H, 5)
    q, k, v = (_rand((B, h, w, E), 50 + i) for i in range(3))
    ref = j_hp.windowed_attention_headpacked(*map(jnp.asarray, (q, k, v)), H, 5)
    out, m, l = spa_attn_hp.windowed_attention_headpacked_plain(*_t(q, k, v), H, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    assert m.shape == l.shape == (B, h, w, H)
    torch.testing.assert_close(spa_attn_hp.windowed_attention_headpacked(*_t(q, k, v), H, 5), out)
    # the function of K2's window step and of the tiled op
    torch.testing.assert_close(out, attention.windowed_attention(*_t(q, k, v), H, 5, "tiled"),
                               atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("B,h,w,E", [(2, 8, 8, 32), (1, 8, 16, 64)])
def test_spa_k5_plain_bwd_matches_jax_vjp(B, h, w, E):
    q, k, v, dout = (_rand((B, h, w, E), 60 + i) for i in range(4))
    _, vjp = jax.vjp(lambda *a: j_hp.windowed_attention_headpacked(*a, H, 5),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = _t(q, k, v, dout)
    _, m, l = spa_attn_hp.spa_attn_hp_fwd(qt, kt, vt, H, 5, with_stats=True)
    got = spa_attn_hp.spa_attn_hp_bwd(qt, kt, vt, m, l, dt, H, 5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g.numpy(), r, name)


def test_spa_k5_plain_bwd_matches_autograd():
    q, k, v, dout = _t(*(_rand((2, 7, 9, 32), 70 + i) for i in range(4)))   # ragged views
    ref = _autograd_vjp(lambda *a: spa_attn_hp.windowed_attention_headpacked_plain(*a, H, 5)[0],
                        [q, k, v], dout)
    out, m, l = spa_attn_hp.windowed_attention_headpacked_plain(q, k, v, H, 5)
    got = spa_attn_hp.windowed_attention_headpacked_bwd_plain(q, k, v, m, l, dout, H, 5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(g, r, name, rel=5e-5, floor=0.0)
    # K3's window step, which is given the forward's output, agrees
    for g, r in zip(got, spa_block.window_attn_bwd_plain(q, k, v, out, dout, m, l, H, 5)):
        _grad_close(g, r, "vs K3.c", rel=5e-5, floor=0.0)


def test_local_attention_pallas_matches_jax_hybrid():
    """impl='pallas' with its projections: value against lft_tpu's hybrid,
    gradients through `SpaAttnHpFn` against jax.grad through its head-packed
    pair (what `test_spa_hybrid_forward_and_grad` holds against XLA)."""
    B, h, w, E = 1, 16, 16, 64
    qn, v = _rand((B, h, w, E), 80), _rand((B, h, w, E), 81)
    wi, wo = _rand((3 * E, E), 82, 0.1), _rand((E, E), 83, 0.1)
    hyb = lambda *a: j_local.local_attention_pallas(*a, H, k=5)
    ref = hyb(*map(jnp.asarray, (qn, v, wi, wo)))
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(hyb(*a))), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (qn, v, wi, wo)))
    ins = [t.requires_grad_(True) for t in _t(qn, v, wi, wo)]
    out = attention.local_attention(*ins, H, k=5, impl="pallas")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    got = torch.autograd.grad(torch.sin(out).sum(), ins)
    for name, g, r in zip(("dqn", "dv", "dwi", "dwo"), got, g_ref):
        _grad_close(g.numpy(), r, name)


@pytest.mark.parametrize("training", [True, False], ids=["training-K6-pair", "primal-K9"])
def test_hybrid_without_headpacked_geometry(training):
    """A tileable view with no all-heads geometry (8x101): the hybrid runs
    the tile-dense pair K6 under autograd, chosen as lft_tpu's own predicate
    chooses off a TPU, and the offset sweep K9 for the primal. The primal is
    held against lft_tpu's hybrid (its K9 in interpret mode); the training
    pair against jax.grad of lft_tpu's dense XLA op, which its own tests hold
    K6 to (its interpret-mode K6 unrolls all 101 tiles of the view)."""
    B, h, w, E = 1, 8, 101, 32
    assert not j_hp.headpacked_applicable(h, w, E, H, 5) and j_spa.pick_tile(h, w) == (8, 1)
    assert not j_spa._use_headpacked_pair(jnp.zeros((B, h, w, E)), H, 5)
    qn, v = _rand((B, h, w, E), 84), _rand((B, h, w, E), 85)
    wi, wo = _rand((3 * E, E), 86, 0.1), _rand((E, E), 87, 0.1)
    ins = [t.requires_grad_(training) for t in _t(qn, v, wi, wo)]
    out = attention.local_attention(*ins, H, k=5, impl="pallas")
    if not training:
        ref = j_local.local_attention_pallas(*map(jnp.asarray, (qn, v, wi, wo)), H, k=5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
        return
    dense = lambda *a: j_attention.local_attention(*a, H, k=5, impl="dense")
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(dense(*map(jnp.asarray, (qn, v, wi, wo)))), **FWD)
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.sin(dense(*a))), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (qn, v, wi, wo)))
    nodes, seen = [out.grad_fn], set()
    while nodes:
        node = nodes.pop()
        seen.add(type(node).__name__)
        nodes += [f for f, _ in node.next_functions if f is not None]
    assert "SpaMxuFnBackward" in seen and "SpaAttnHpFnBackward" not in seen, seen
    got = torch.autograd.grad(torch.sin(out).sum(), ins)
    for name, g, r in zip(("dqn", "dv", "dwi", "dwo"), got, g_ref):
        _grad_close(g.numpy(), r, name)


# ------------------------------------------------------------- dispatch ---

def _jax_spatial_route(monkeypatch, h, w, E, heads, variant, training):
    """The kernel lft_tpu's dispatch reaches for this geometry, found by
    running it with every kernel entry replaced by a recorder."""
    hits = []

    def rec(name):
        def fake(q, *a, **kw):
            hits.append(name)
            return jnp.zeros(q.shape, q.dtype)
        return fake

    with monkeypatch.context() as mp:
        mp.setattr(j_hp, "windowed_attention_headpacked", rec("K5"))
        mp.setattr(j_offset, "windowed_attention", rec("K9"))
        mp.setattr(j_local, "_windowed_attention_pallas", rec("K10"))
        mp.setattr(j_attention, "local_attention", rec("tiled"))
        mp.setattr(j_spa.local_attention_tile_mxu, "__defaults__", (5, rec("K6")))
        z = jnp.zeros((1, h, w, E), jnp.float32)
        j_local.local_attention_pallas(z, z, jnp.zeros((3 * E, E)), jnp.zeros((E, E)), heads,
                                       k=5, variant=variant)
    assert len(hits) == 1, hits
    if training and hits[0] in ("K5", "K9") and variant == "auto" and h * w <= 2048 \
            and j_spa.pick_tile(h, w) is not None and E % heads == 0:
        # the hybrid's training pair, chosen by lft_tpu's own predicate
        return "K5" if j_spa._use_headpacked_pair(z, heads, 5) else "K6"
    return hits[0]


def _port_spatial_route(monkeypatch, h, w, E, heads, variant, training):
    hits = []

    def rec(name):
        def fake(q, *a, **kw):
            hits.append(name)
            return torch.zeros_like(q)
        return fake

    with monkeypatch.context() as mp:
        mp.setattr(spa_attn, "windowed_attention_headpacked", rec("K5"))
        mp.setattr(spa_attn, "windowed_attention_mxu", rec("K6"))
        mp.setattr(spa_attn.local_attention_tile_mxu, "__defaults__", (5, rec("K6")))
        mp.setattr(local_attn_vjp, "windowed_attention", rec("K9"))
        mp.setattr(local_attn, "windowed_attention_tile", rec("K10"))
        mp.setattr(attention, "local_attention", rec("tiled"))
        z = torch.zeros(1, h, w, E, requires_grad=training)
        local_attn.local_attention_pallas(z, z, torch.zeros(3 * E, E), torch.zeros(E, E),
                                          heads, k=5, variant=variant)
    assert len(hits) == 1, hits
    return hits[0]


SPATIAL_CASES = [
    # h, w, E, heads, variant, what lft_tpu reaches (primal, training)
    (32, 32, 128, 8, "auto", "K5", "K5"),
    (8, 8, 32, 8, "auto", "K5", "K5"),
    (16, 32, 64, 8, "auto", "K5", "K5"),
    (16, 16, 32, 4, "auto", "K5", "K5"),
    (8, 101, 128, 8, "auto", "K9", "K6"),      # tileable, no head-packed geometry
    (64, 64, 128, 8, "auto", "K6", "K6"),      # h*w > 2048
    (48, 48, 32, 8, "auto", "K6", "K6"),
    (32, 32, 128, 8, "mxu", "K6", "K6"),
    (32, 32, 128, 8, "offset", "K9", "K9"),
    (32, 32, 128, 8, "tile", "K10", "K10"),
    (48, 48, 32, 8, "tile", "K10", "K10"),
    (7, 7, 32, 8, "auto", "K9", "K9"),         # no tile, small enough for the offset sweep
    (16, 16, 36, 8, "auto", "K9", "K9"),       # E % heads != 0
    (7, 7, 32, 8, "tile", "tiled", "tiled"),
    (7, 7, 32, 8, "mxu", "tiled", "tiled"),
    (50, 50, 32, 8, "auto", "tiled", "tiled"),  # no tile, too large, not 8-divisible
    (50, 50, 32, 8, "offset", "tiled", "tiled"),
]


@pytest.mark.parametrize("training", [False, True], ids=["primal", "training"])
@pytest.mark.parametrize("h,w,E,heads,variant,primal,train", SPATIAL_CASES)
def test_spatial_dispatch_matches_jax(monkeypatch, h, w, E, heads, variant, primal, train,
                                      training):
    ref = _jax_spatial_route(monkeypatch, h, w, E, heads, variant, training)
    assert ref == (train if training else primal)
    assert _port_spatial_route(monkeypatch, h, w, E, heads, variant, training) == ref


@pytest.mark.parametrize("A2,variant,route", [(9, "mxu", "K7"), (25, "mxu", "K7"),
                                              (128, "mxu", "K7"), (144, "mxu", "K8"),
                                              (25, "sweep", "K8"), (169, "sweep", "K8")])
def test_angular_dispatch_matches_jax(monkeypatch, A2, variant, route):
    C = 16
    hits = []
    with monkeypatch.context() as mp:
        mp.setattr(j_ang, "ang_attention_mxu", lambda qn, *a: hits.append("K7") or qn)
        mp.setattr(j_ang, "ang_attention_pallas_ad", lambda qn, *a: hits.append("K8") or qn)
        mp.setenv("LFT_ANG_VARIANT", variant)
        z = jnp.zeros((2, A2, C))
        j_ang.ang_attention_pallas(z, z, jnp.zeros((3 * C, C)), jnp.zeros((C, C)), H)
    assert hits == [route]
    assert j_mxu.mxu_applicable(A2) == ang_attn_mxu.mxu_applicable(A2)
    z = torch.zeros(2, A2, C)
    args = (z, z, torch.zeros(3 * C, C), torch.zeros(C, C), H)
    for by_env in (False, True):
        taken = []
        with monkeypatch.context() as mp:
            mp.setattr(ang_attn, "ang_attention_mxu", lambda qn, *a: taken.append("K7") or qn)
            mp.setattr(ang_attn, "ang_attention_pallas_ad",
                       lambda qn, *a: taken.append("K8") or qn)
            if by_env:
                mp.setenv("LFT_ANG_VARIANT", variant)
                ang_attn.ang_attention_pallas(*args)
            else:
                # an explicit argument wins over the environment
                mp.setenv("LFT_ANG_VARIANT", "sweep" if variant == "mxu" else "mxu")
                ang_attn.ang_attention_pallas(*args, variant=variant)
        assert taken == [route], (by_env, taken)
    monkeypatch.delenv("LFT_ANG_VARIANT", raising=False)
    assert ang_attn.ang_attention_pallas(*args, variant=variant).shape == z.shape


def test_unknown_variant_raises(monkeypatch):
    """As tests/test_kernels.py:test_unknown_variant_raises expects of
    lft_tpu: a typo is an error, not another path, in the argument and in
    the environment knobs alike."""
    monkeypatch.delenv("LFT_ANG_VARIANT", raising=False)
    monkeypatch.delenv("LFT_SPA_VARIANT", raising=False)
    z = torch.zeros(1, 16, 16, 64)
    with pytest.raises(ValueError, match="unknown spatial attention"):
        local_attn.local_attention_pallas(z, z, torch.zeros(192, 64), torch.zeros(64, 64), H,
                                          variant="mxuu")
    a = torch.zeros(1, 25, 64)
    with pytest.raises(ValueError, match="unknown angular attention"):
        ang_attn.ang_attention_pallas(a, a, torch.zeros(192, 64), torch.zeros(64, 64), H,
                                      variant="sweeep")
    monkeypatch.setenv("LFT_SPA_VARIANT", "mxuu")
    with pytest.raises(ValueError, match="LFT_SPA_VARIANT"):
        local_attn.local_attention_pallas(z, z, torch.zeros(192, 64), torch.zeros(64, 64), H)
    with pytest.raises(ValueError, match="LFT_SPA_VARIANT"):
        j_local.local_attention_pallas(jnp.zeros((1, 16, 16, 64)), jnp.zeros((1, 16, 16, 64)),
                                       jnp.zeros((192, 64)), jnp.zeros((64, 64)), H)
    # an explicit variant wins over the knob
    assert local_attn.local_attention_pallas(z, z, torch.zeros(192, 64), torch.zeros(64, 64), H,
                                             variant="offset").shape == z.shape
    monkeypatch.delenv("LFT_SPA_VARIANT")
    monkeypatch.setenv("LFT_ANG_VARIANT", "sweeep")
    with pytest.raises(ValueError, match="LFT_ANG_VARIANT"):
        ang_attn.ang_attention_pallas(a, a, torch.zeros(192, 64), torch.zeros(64, 64), H)
    with pytest.raises(ValueError, match="LFT_ANG_VARIANT"):
        j_ang.ang_attention_pallas(jnp.zeros((1, 25, 64)), jnp.zeros((1, 25, 64)),
                                   jnp.zeros((192, 64)), jnp.zeros((64, 64)), H)
    assert local_attn.SPA_VARIANTS == j_local.SPA_VARIANTS


def test_gates_equal_jax_over_a_grid():
    for h in (1, 2, 5, 7, 8, 12, 16, 20, 32, 40, 50, 64, 101):
        for w in (1, 3, 8, 16, 24, 32, 48, 64, 101, 128):
            assert spa_attn.pick_tile(h, w) == j_spa.pick_tile(h, w), (h, w)
            for E, heads in ((128, 8), (32, 8), (36, 8), (32, 4)):
                assert spa_attn_hp.headpacked_applicable(h, w, E, heads, 5) == \
                    j_hp.headpacked_applicable(h, w, E, heads, 5), (h, w, E, heads)
    for A2 in (1, 25, 81, 121, 128, 129, 169):
        assert ang_attn_mxu.mxu_applicable(A2) == j_mxu.mxu_applicable(A2)
    assert spa_block._hp_geometry_exists is spa_attn_hp._hp_geometry_exists
    assert local_attn._MAX_HW_OFFSET == j_local._MAX_HW_OFFSET


def test_auto_means_the_plain_ops_on_the_cpu(monkeypatch):
    """`auto` takes the per-op kernels only for a CUDA tensor; and no
    wrapper counts a launch on the CPU."""
    def boom(*a, **kw):
        raise AssertionError("the per-op dispatch was taken for a CPU tensor")
    monkeypatch.setattr(local_attn, "local_attention_pallas", boom)
    monkeypatch.setattr(lft, "ang_attention_pallas", boom)
    args = Args(channels=16, scale_factor=2)
    p = lft.init_params(0, args, device="cpu")
    x = torch.from_numpy(_rand((1, 1, 40, 40), 90, 0.5) + 0.5)
    assert lft.forward(p, x, args).shape == (1, 1, 80, 80)
    monkeypatch.undo()
    reset_launches()
    lft.forward(p, x, args, attention_impl="pallas")
    assert set(PEROP) <= set(LAUNCHES) and not any(LAUNCHES.values())
    assert parse_args(["--attention_impl", "pallas"]).attention_impl == "pallas"
    assert Args().attention_impl == JArgs().attention_impl == "auto"


@pytest.mark.parametrize("ang_res,device,training,plain,expect", [
    (5, "cuda", True, False, True),      # the production geometry still trains fused
    (5, "cuda", False, False, True),
    (8, "cuda", True, False, True),      # A2 = 64: the last K4 takes
    (9, "cuda", False, False, True),     # inference at angRes 9-11 still fuses (K1)
    (9, "cuda", True, False, True),      # 64 < A2 <= 128: K4's three-kernel form
    (11, "cuda", True, False, True),
    (9, "cuda", True, True, True),       # the plain blocks take every gated A2
    (9, "cpu", True, False, True),
    (12, "cuda", False, False, False),   # A2 = 144 fails the gate itself
])
def test_resolve_fused_predicate(ang_res, device, training, plain, expect):
    A2 = ang_res * ang_res
    assert lft.resolve_fused(True, 32, 32, 64, A2, device, training, plain) is expect
    assert lft.resolve_fused(False, 32, 32, 64, A2, device, training, plain) is False
    assert ang_block.ang_block_trainable(A2, device) == (A2 <= 128)
    # a view no head-packed tile divides fails the spatial gate as before
    assert lft.resolve_fused(True, 8, 101, 64, 25, device, False) is False


# ------------------------------------------------------ the whole slice ---

@pytest.fixture
def two_blocks(monkeypatch, small_ang_steps):
    """2 of the 4 AltFilter blocks in both packages: the interpret-mode
    traces of lft_tpu's Pallas kernels stay short."""
    monkeypatch.setattr(j_lft, "LAYER_NUM", 2)
    monkeypatch.setattr(lft, "LAYER_NUM", 2)


def _np_params(seed, channels=16, scale=2):
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, scale).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


def test_unfused_forward_matches_jax_pallas(two_blocks):
    np_p = _np_params(100)
    x = _rand((2, 1, 40, 40), 101, 0.5) + 0.5
    jargs = JArgs(angRes=5, scale_factor=2, channels=16, model_name="LFT")
    ref = j_lft.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(x), jargs,
                        attention_impl="pallas", fused=False)
    p = lft.params_from_numpy(np_p, device="cpu")
    args = Args(channels=16, scale_factor=2)
    got = lft.forward(p, torch.from_numpy(x), args, fused=False, attention_impl="pallas")
    assert float((got - torch.from_numpy(np.array(ref))).abs().max()) <= 2e-5
    # the flag reaches the same path as the keyword
    args.attention_impl = "pallas"
    assert torch.equal(lft.forward(p, torch.from_numpy(x), args, fused=False), got)


def test_unfused_grads_match_jax_pallas(two_blocks):
    """Every parameter's gradient through `AngAttnFn`/`SpaAttnHpFn` (plain
    backwards) against jax.grad through lft_tpu's per-op custom VJPs."""
    np_p = _np_params(102)
    x = _rand((1, 1, 40, 40), 103, 0.5) + 0.5
    y = _rand((1, 1, 80, 80), 104, 0.5) + 0.5
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
    for k in np_p:
        _grad_close(p[k].grad.numpy(), ref[k], k)


def test_scene_sr_unfused_matches_jax(two_blocks):
    from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
    np_p = _np_params(105)
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


def test_unfused_train_step_matches_jax(two_blocks):
    """One `--train_fused false` Adam step through the per-op Functions
    against lft_tpu's train step through its per-op kernels: the loss and
    every updated parameter (an update of 2e-4 from the same state)."""
    np_p = _np_params(106)
    x = _rand((2, 1, 40, 40), 107, 0.5) + 0.5
    y = _rand((2, 1, 80, 80), 108, 0.5) + 0.5
    kw = dict(angRes=5, scale_factor=2, channels=16, batch_size=2, lr=2e-4, n_steps=15,
              gamma=0.5, epoch=2, train_fused="false", attention_impl="pallas")
    jargs = JArgs(model_name="LFT", train_remat=False, **kw)
    tx = j_optim.make_optimizer(jargs, steps_per_epoch=10)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    jstep = j_trainer.make_train_step(j_get_model(jargs), tx, jargs, with_metrics=False)
    # a warm Adam state carried into both (second moments of 1e-6, 5 steps
    # taken): from zero moments the first update is lr * g / (|g| + eps), which
    # turns f32 noise in a near-zero gradient into a visible share of the step
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
    assert abs(float(loss) - float(aux["loss"])) <= 1e-5 * abs(float(aux["loss"]))
    for k in np_p:
        np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(jp2[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    moved = [k for k in np_p if not np.array_equal(p[k].detach().numpy(), np_p[k])]
    # all but the attention pre-norms, whose small update is lost against values near 1
    assert len(moved) >= len(np_p) - 8, sorted(set(np_p) - set(moved))


def test_training_forward_at_angres9_takes_the_unfused_branch(monkeypatch):
    """The K4 gate end to end on the CPU. The backward kernels take every
    gated view count, so a 9x9-view forward that asks for the fused branch
    runs it under autograd as it does in inference; `--train_fused false` is
    what still trains such a geometry through the per-op branch (K7/K5), and
    a device whose backward did not take the view count would be sent there
    too (its answer patched in)."""
    calls = []
    monkeypatch.setattr(lft, "_ang_trans", lambda x, *a: calls.append("unfused") or x)
    monkeypatch.setattr(lft, "ang_trans_block_fused", lambda t, *a, **kw: calls.append("fused") or t)
    monkeypatch.setattr(lft, "LAYER_NUM", 1)
    args = Args(channels=16, scale_factor=2, angRes=9)
    p = lft.init_params(0, args, device="cpu")
    x = torch.from_numpy(_rand((1, 1, 72, 72), 109, 0.5) + 0.5)
    with torch.no_grad():
        lft.forward(p, x, args, fused=True)
    assert calls == ["fused"]
    for t in p.values():
        t.requires_grad_(True)
    lft.forward(p, x, args, fused=True)
    assert calls == ["fused", "fused"]
    # `--train_fused false` reaches the model as fused=False
    args_unfused = Args(channels=16, scale_factor=2, angRes=9, train_fused="false")
    assert trainer.train_fused(args_unfused, torch.device("cuda")) is False
    args_fused = Args(channels=16, scale_factor=2, angRes=9, train_fused="true")
    assert trainer.train_fused(args_fused, torch.device("cuda")) is True
    lft.forward(p, x, args, fused=trainer.train_fused(args_unfused, torch.device("cuda")))
    assert calls == ["fused", "fused", "unfused"]
    with monkeypatch.context() as mp:
        mp.setattr(lft, "ang_block_trainable", lambda A2, dev: A2 <= 64)
        lft.forward(p, x, args, fused=True)
        assert calls[3:] == ["unfused"]
        with torch.no_grad():
            lft.forward(p, x, args, fused=True)
        assert calls[4:] == ["fused"]
    args5 = Args(channels=16, scale_factor=2, angRes=5)
    p5 = {k: v.requires_grad_(True) for k, v in lft.init_params(0, args5, device="cpu").items()}
    lft.forward(p5, x[:, :, :40, :40], args5, fused=True)
    assert calls[5:] == ["fused"]
