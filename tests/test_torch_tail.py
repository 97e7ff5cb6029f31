"""The last three kernels of the port against the JAX package, on the CPU.

* K10 (tile-halo window attention, forward only) in its plain PyTorch
  version against lft_tpu's Pallas kernel in interpret mode, as
  tests/test_kernels.py runs it: forward atol 2e-5 / rtol 1e-4 (the same f32
  math summed in another order); against the port's own K5 and K9 plain
  versions (one function); through the dispatch with its projections, forced
  (`tile`) and as the large-view fallback of `offset`; a 2-block model forward
  under `LFT_SPA_VARIANT=tile` in both packages; and under grad, where both
  packages raise.
* K11 (the fused SpaTrans forward on a pixel-major buffer) in its plain
  version against lft_tpu's `spa_trans_block_fused(pixel_major=True)` in
  interpret mode, and against the port's view-major call on the permuted
  buffer; inference only.
* K4 for 64 < A2 <= 128: the plain backward against `jax.vjp` of lft_tpu's
  fused AngTrans block at A2 = 81 and 121 (5e-4 max |ref|, the JAX package's
  fused-vs-unfused gradient bound), the gate that now sends a training
  forward at angRes 9-11 to the fused branch, and a 2-block training forward
  at angRes 9 against `jax.grad` of lft_tpu's fused forward (5e-4 max |ref| +
  2e-9).
Sizes are small: C = 16, views of 8-48 pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.kernels import local_attn as j_local
from lft_tpu.kernels import spa_block as j_spa_block
from lft_tpu.kernels.ang_block import ang_block_core
from lft_tpu.models import lft as j_lft
from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, TAIL, ang_block, local_attn, local_attn_vjp
from lft_torch.kernels import reset_launches, spa_attn_hp, spa_block
from lft_torch.models import lft
from lft_torch.ops import attention
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

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


def _np_params(seed, channels=16, scale=2):
    """Random params with LayerNorm affines away from (1, 0)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, scale).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


# -------------------------------------------------- K10 against lft_tpu ---

@pytest.mark.parametrize("B,h,w,E", [(2, 16, 16, 128), (1, 8, 24, 32)])
def test_spa_k10_plain_forward_matches_jax(B, h, w, E):
    q, k, v = (_rand((B, h, w, E), 300 + i) for i in range(3))
    ref = j_local._windowed_attention_pallas(*_j(q, k, v), H, 5, 8)
    reset_launches()
    out = local_attn.windowed_attention_tile(*_t(q, k, v), H, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    assert torch.equal(out, local_attn.windowed_attention_tile_plain(*_t(q, k, v), H, 5))
    assert set(TAIL) <= set(LAUNCHES) and not any(LAUNCHES.values())
    # one function: the all-heads kernel K5 and the offset sweep K9
    for other in (spa_attn_hp.windowed_attention_headpacked_plain,
                  local_attn_vjp.windowed_attention_offset_plain):
        torch.testing.assert_close(out, other(*_t(q, k, v), H, 5)[0], atol=2e-6, rtol=1e-5)


def test_spa_k10_gate_and_tile():
    q = torch.zeros(1, 12, 16, 32)
    with pytest.raises(ValueError, match="do not divide"):
        local_attn.windowed_attention_tile(q, q, q, H, 5)
    # the plain version takes any tile that divides the view, the tiled op's default is 8
    a, b, c = _t(*(_rand((1, 16, 32, 32), 310 + i) for i in range(3)))
    t8 = local_attn.windowed_attention_tile(a, b, c, H, 5)
    assert torch.equal(t8, attention.windowed_attention(a, b, c, H, 5, "tiled"))
    torch.testing.assert_close(local_attn.windowed_attention_tile(a, b, c, H, 5, t=16), t8,
                               atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("hw,variant", [(16, "tile"), (48, "offset")],
                         ids=["tile-forced", "offset-large-view"])
def test_local_attention_pallas_reaches_k10_in_both_packages(monkeypatch, hw, variant):
    """With the projections: `tile` forces K10; `offset` on a 48x48 view
    (2304 > 2048 pixels, 8-divisible) falls back to it, in lft_tpu and in the
    port alike."""
    E = 32
    qn, v = _rand((1, hw, hw, E), 320), _rand((1, hw, hw, E), 321)
    wi, wo = _rand((3 * E, E), 322, 0.2), _rand((E, E), 323, 0.2)
    ran = []
    monkeypatch.setattr(j_local, "_windowed_attention_pallas",
                        lambda *a, _fn=j_local._windowed_attention_pallas:
                        ran.append("jax") or _fn(*a))
    monkeypatch.setattr(local_attn, "windowed_attention_tile",
                        lambda *a, _fn=local_attn.windowed_attention_tile:
                        ran.append("port") or _fn(*a))
    ref = j_local.local_attention_pallas(*_j(qn, v, wi, wo), H, k=5, variant=variant)
    out = local_attn.local_attention_pallas(*_t(qn, v, wi, wo), H, k=5, variant=variant)
    assert ran == ["jax", "port"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_forward_under_tile_variant_matches_jax(monkeypatch):
    """2 of the 4 AltFilter blocks, `LFT_SPA_VARIANT=tile` set for both
    packages: every spatial attention of the unfused forward is K10."""
    monkeypatch.setattr(j_lft, "LAYER_NUM", 2)
    monkeypatch.setattr(lft, "LAYER_NUM", 2)
    monkeypatch.delenv("LFT_ANG_VARIANT", raising=False)
    monkeypatch.setenv("LFT_SPA_VARIANT", "tile")
    ran = []
    monkeypatch.setattr(local_attn, "windowed_attention_tile",
                        lambda *a, _fn=local_attn.windowed_attention_tile:
                        ran.append(tuple(a[0].shape)) or _fn(*a))
    np_p = _np_params(330)
    x = _rand((2, 1, 40, 40), 331, 0.5) + 0.5
    jargs = JArgs(angRes=5, scale_factor=2, channels=16, model_name="LFT")
    ref = j_lft.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(x), jargs,
                        attention_impl="pallas", fused=False)
    p = lft.params_from_numpy(np_p, device="cpu")
    with torch.no_grad():
        got = lft.forward(p, torch.from_numpy(x), Args(channels=16, scale_factor=2), fused=False,
                          attention_impl="pallas")
    assert ran == [(50, 8, 8, 32)] * 2
    assert float((got - torch.from_numpy(np.array(ref))).abs().max()) <= 1e-4


def test_k10_is_forward_only_in_both_packages(monkeypatch):
    """lft_tpu gives its tile-halo kernel no VJP, and `jax.grad` through the
    interpret-mode `pallas_call` fails (ValueError: no reverse-mode rule). The
    port raises likewise when grad is needed, on any device, and names the
    variants that train; without grad the same call runs."""
    E = 32
    qn, v = _rand((1, 8, 8, E), 340), _rand((1, 8, 8, E), 341)
    wi, wo = _rand((3 * E, E), 342, 0.2), _rand((E, E), 343, 0.2)
    jf = lambda *a: jnp.sum(j_local.local_attention_pallas(*a, H, k=5, variant="tile"))
    with pytest.raises(ValueError, match="reverse-mode"):
        jax.grad(jf)(*_j(qn, v, wi, wo))
    ins = _t(qn, v, wi, wo)
    for needs in range(3):          # qn, v or the in-projection: the kernel's own inputs
        args = [t.clone().requires_grad_(i == needs) for i, t in enumerate(ins)]
        with pytest.raises(ValueError, match="forward-only.*'auto', 'mxu'"):
            local_attn.local_attention_pallas(*args, H, k=5, variant="tile")
        with torch.no_grad():
            assert local_attn.local_attention_pallas(*args, H, k=5,
                                                     variant="tile").shape == (1, 8, 8, E)
    # and a training forward of the model under the knob says so too
    monkeypatch.setenv("LFT_SPA_VARIANT", "tile")
    margs = Args(channels=16, scale_factor=2)
    p = {k: t.requires_grad_(True) for k, t in lft.init_params(0, margs, device="cpu").items()}
    x = torch.from_numpy(_rand((1, 1, 40, 40), 344, 0.5) + 0.5)
    with pytest.raises(ValueError, match="forward-only"):
        lft.forward(p, x, margs, fused=False, attention_impl="pallas")


# -------------------------------------------------- K11 against lft_tpu ---

def _spa_case(seed, Bb, h, w, A2, C=16):
    np_p = _np_params(seed, C)
    prefix = "altblock.1.spa_trans."
    x = _rand((Bb, h, w, A2, C), seed + 1)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              torch.from_numpy(np_p[prefix + "MLP.weight"]))[0].contiguous()
    return np_p, prefix, x, pe_tok


@pytest.mark.parametrize("Bb,h,w,A2", [(2, 8, 8, 4), (1, 16, 16, 25)])
def test_spa_k11_plain_matches_jax_pixel_major(Bb, h, w, A2):
    np_p, prefix, x, pe_tok = _spa_case(350 + A2, Bb, h, w, A2)
    ref = j_spa_block.spa_trans_block_fused(
        jnp.asarray(x), jnp.asarray(pe_tok.numpy()),
        {k: jnp.asarray(v) for k, v in np_p.items()}, prefix, H, 5, pixel_major=True)
    assert ref.shape == x.shape
    p = lft.params_from_numpy(np_p, device="cpu")
    xt = torch.from_numpy(x)
    reset_launches()
    with torch.no_grad():
        got = spa_block.spa_trans_block_fused(xt, pe_tok, p, prefix, H, 5, pixel_major=True)
        plain = spa_block.spa_trans_block_plain(xt, pe_tok, p, prefix, H, 5, pixel_major=True)
        vm = spa_block.spa_trans_block_plain(
            xt.permute(0, 3, 1, 2, 4).reshape(Bb * A2, h, w, 16), pe_tok, p, prefix, H, 5)
    assert not any(LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    assert got.shape == x.shape and torch.equal(got, plain)
    # the view-major block on the permuted buffer, permuted back: the same arithmetic
    assert torch.equal(got, vm.reshape(Bb, A2, h, w, 16).permute(0, 2, 3, 1, 4))


def test_spa_k11_is_inference_only_and_keeps_the_gate():
    np_p, prefix, x, pe_tok = _spa_case(360, 1, 8, 8, 4)
    p = lft.params_from_numpy(np_p, device="cpu")
    xt = torch.from_numpy(x)
    for plain in (False, True):
        with pytest.raises(ValueError, match="inference-only"):
            spa_block.spa_trans_block_fused(xt.clone().requires_grad_(True), pe_tok, p, prefix,
                                            H, 5, plain=plain, pixel_major=True)
        pg = dict(p, **{prefix + "norm.weight": p[prefix + "norm.weight"].clone()
                        .requires_grad_(True)})
        with pytest.raises(ValueError, match="inference-only"):
            spa_block.spa_trans_block_fused(xt, pe_tok, pg, prefix, H, 5, plain=plain,
                                            pixel_major=True)
        # the view-major form differentiates as before
        out = spa_block.spa_trans_block_fused(xt[:, :, :, 0], pe_tok, pg, prefix, H, 5,
                                              plain=plain)
        assert out.requires_grad
    for h in (1, 5, 8, 16, 30, 32, 64):
        for w in (8, 16, 30, 32, 101):
            assert spa_block.spa_block_applicable(h, w, 32, H, 5) == \
                j_spa_block.spa_block_applicable(h, w, 32, H, 5), (h, w)
    assert not spa_block.spa_block_applicable(8, 8, 36, H, 5)


# ----------------------------------------- K4 for 64 < A2 <= 128 vs JAX ---

@pytest.mark.parametrize("A2,N", [(81, 5), (121, 5), (81, 4)])
def test_ang_block_bwd_plain_matches_jax_vjp_past_64_views(monkeypatch, A2, N):
    """K4's plain version against jax.vjp of the fused block where a pixel
    has more than 64 view tokens (one pixel a group in lft_tpu; N = 5 leaves
    its two-group grid step ragged)."""
    monkeypatch.setenv("LFT_ANGB_GPS", "2")
    monkeypatch.setenv("LFT_ANGB_BWD_GPS", "2")
    C = 16
    p = lft.params_from_numpy(_np_params(370 + A2), device="cpu")
    wts = ang_block.ang_weights(p, "altblock.2.ang_trans.")
    x, dout = _rand((N, A2, C), 371), _rand((N, A2, C), 372)
    pe = angular_position(A2, C)
    order = ang_block.WEIGHTS
    _, vjp = jax.vjp(lambda x_, *w: ang_block_core(x_, jnp.asarray(pe), *w, H),
                     jnp.asarray(x), *(jnp.asarray(wts[n].numpy()) for n in order))
    ref = vjp(jnp.asarray(dout))
    xt, pet = torch.from_numpy(x), torch.from_numpy(pe)
    _, m, l, attn = ang_block.ang_block(xt, pet, wts, H, with_res=True)
    reset_launches()
    got = ang_block.ang_block_bwd(xt, pet, wts, m, l, attn, torch.from_numpy(dout), H)
    assert sum(LAUNCHES.values()) == 0
    for name, g, r in zip(("x",) + order, got, ref):
        _grad_close(g.numpy(), r, name, floor=0.0)


def test_training_forward_at_angres9_matches_jax_fused_grads(monkeypatch):
    """9x9 views: a training forward that asks for the fused branch takes it
    on every device (`resolve_fused`), and its gradients through the plain
    blocks behind the autograd Functions equal jax.grad of lft_tpu's fused
    forward, which trains this geometry fused too (2 of the 4 blocks)."""
    monkeypatch.setattr(j_lft, "LAYER_NUM", 2)
    monkeypatch.setattr(lft, "LAYER_NUM", 2)
    monkeypatch.setenv("LFT_ANGB_GPS", "2")
    monkeypatch.setenv("LFT_ANGB_BWD_GPS", "2")
    for dev in ("cuda", "cpu"):
        assert lft.resolve_fused(True, 8, 8, 16, 81, dev, training=True)
        assert ang_block.ang_block_trainable(121, dev)
        assert not ang_block.ang_block_trainable(144, dev)
    calls = []
    monkeypatch.setattr(lft, "ang_trans_block_plain",
                        lambda t, *a, _fn=lft.ang_trans_block_plain:
                        calls.append(t.shape[1]) or _fn(t, *a))
    np_p = _np_params(390)
    x = _rand((1, 1, 72, 72), 391, 0.5) + 0.5
    y = _rand((1, 1, 144, 144), 392, 0.5) + 0.5
    jargs = JArgs(angRes=9, scale_factor=2, channels=16, model_name="LFT")

    def jloss(p):
        sr = j_lft.forward(p, jnp.asarray(x), jargs, remat=False, fused=True)
        return jnp.mean((sr - y) * jnp.cos(3.0 * (sr - y)))

    ref = jax.grad(jloss)({k: jnp.asarray(v) for k, v in np_p.items()})
    p = lft.params_from_numpy(np_p, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    sr = lft.forward(p, torch.from_numpy(x), Args(angRes=9, channels=16, scale_factor=2),
                     fused=True, plain_blocks=True)
    yt = torch.from_numpy(y)
    ((sr - yt) * torch.cos(3.0 * (sr - yt))).mean().backward()
    assert calls == [81, 81]
    for k in np_p:
        _grad_close(p[k].grad.numpy(), ref[k], k)
