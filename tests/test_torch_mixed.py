"""`--dtype mixed` in the port against lft_tpu's, on the CPU.

lft_tpu's `mixed` keeps f32 activations and follows a per-site product plan
in its fused blocks: the forward's from LFT_MM_HP_SITES (default all f32),
the backward's from LFT_MM_HP_BWD_SITES (default none: both operands of
every product of K3 and K4 rounded to bf16, f32 accumulation). The port's
plain versions follow the same plans (lft_torch/kernels/common.py).

A path that quietly ran f32 lies within ~2% of `mixed`, so every comparison
holds the port to lft_tpu within L2-relative 1e-3 per output AND within
1/10 of lft_tpu's own mixed-vs-f32 distance on the same inputs. lft_tpu's
Pallas kernels run in interpret mode, as its own tests run them on the CPU.
Sizes are small: C = 16, 8x8 views, few pixels.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.config import parse_args as j_parse_args
from lft_tpu.kernels import common as j_common
from lft_tpu.kernels.ang_block import ang_block_core
from lft_tpu.kernels.spa_block import spa_block_core
from lft_tpu.models import lft as j_lft
from lft_tpu.registry import get_model as j_get_model
from lft_tpu.training import optim as j_optim
from lft_tpu.training import trainer as j_trainer
from lft_torch import device as port_device
from lft_torch.config import Args, parse_args
from lft_torch.kernels import LAUNCHES, ang_block, common, reset_launches, spa_block
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear
from lft_torch.registry import get_model
from lft_torch.training import optim, trainer

C = 16
H = 8
ENVS = ("LFT_MM_HP_SITES", "LFT_MM_HP_BWD_SITES")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _plans_unset(monkeypatch):
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)


def _rand(shape, seed, scale=1.0):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2 * scale).astype(np.float32)


def _np_params(seed, channels=C, scale=2):
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, scale).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _mixed_close(got, ref, ref_f32, what, rel=1e-3):
    """The port within `rel` L2-relative of lft_tpu's `mixed`, and within 1/10
    of lft_tpu's own mixed-vs-f32 distance: a path that ran f32 fails."""
    got, ref, ref_f32 = (np.asarray(t) for t in (got, ref, ref_f32))
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    d, gap = _l2(got, ref), _l2(ref_f32, ref)
    assert d <= rel, (what, d, gap)
    assert d <= 0.1 * gap, (what, d, gap)
    return d, gap


# ------------------------------------------------------- (a) the plans ---

@pytest.mark.parametrize("spec", [None, "all", "none", "", "qk,v,affn", " score , lin "])
@pytest.mark.parametrize("env", ENVS)
def test_site_plans_match_lft_tpu(monkeypatch, env, spec):
    if spec is not None:
        monkeypatch.setenv(env, spec)
    default = "none" if env == "LFT_MM_HP_BWD_SITES" else "all"
    sites = common.mm_hp_sites(env, default)
    assert sites == j_common.mm_hp_sites(env, default)
    assert common.MM_HP_ALL == j_common.MM_HP_ALL and common.MM_HP_DEFAULT == "all"
    for mm_half in (False, True):
        mdt, _ = j_common.mm_site_plan(mm_half, jnp.float32, sites)
        plan = common.mm_site_plan(mm_half, sites)
        assert plan == {s: mdt[s] == jnp.bfloat16 for s in j_common.MM_HP_ALL}


@pytest.mark.parametrize("env", ENVS)
def test_unknown_site_raises_in_both(monkeypatch, env):
    monkeypatch.setenv(env, "qk,vv")
    with pytest.raises(ValueError, match=r"unknown .* entries \['vv'\]"):
        common.mm_hp_sites(env)
    with pytest.raises(ValueError, match=r"unknown .* entries \['vv'\]"):
        j_common.mm_hp_sites(env)


# ------------------------------------------------- (b) K3 under mixed ---

@pytest.mark.parametrize("bwd_sites", [None, "qk,ffn"])
def test_spa_block_bwd_mixed_matches_jax_vjp(monkeypatch, bwd_sites):
    """K3's plain backward under the mixed plan against jax.vjp of lft_tpu's
    fused block with mm_half (interpret mode), every output, under the
    default backward plan and under one that keeps two sites f32."""
    if bwd_sites is not None:
        monkeypatch.setenv("LFT_MM_HP_BWD_SITES", bwd_sites)
    p = lft.params_from_numpy(_np_params(4), device="cpu")
    prefix = "altblock.1.spa_trans."
    wts = spa_block.spa_weights(p, prefix)
    V, h, w = 3, 8, 8
    x, dout = _rand((V, h, w, C), 5), _rand((V, h, w, C), 6)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              p[prefix + "MLP.weight"])[0].contiguous()
    wn = [jnp.asarray(wts[n].numpy()) for n in spa_block.WEIGHTS]

    def ref(mm_half):
        _, vjp = jax.vjp(lambda x_, pe_, *w_: spa_block_core(x_, pe_, *w_, H, 5, mm_half),
                         jnp.asarray(x), jnp.asarray(pe_tok.numpy()), *wn)
        return vjp(jnp.asarray(dout))

    ref_m, ref_f = ref(True), ref(False)
    plan = common.mm_site_plan(True, common.mm_hp_sites("LFT_MM_HP_BWD_SITES", "none"))
    xt = torch.from_numpy(x)
    _, tok, m, l, attn = spa_block.spa_block(xt, pe_tok, wts, H, 5, with_res=True)
    reset_launches()
    got = spa_block.spa_block_bwd(xt, pe_tok, wts, tok, m, l, attn, torch.from_numpy(dout), H,
                                  5, plan=plan)
    assert sum(LAUNCHES.values()) == 0
    for name, g, r, r32 in zip(("x", "pe_tok") + spa_block.WEIGHTS, got, ref_m, ref_f):
        _mixed_close(g.numpy(), r, r32, name)


# ------------------------------------------------- (c) K4 under mixed ---

@pytest.mark.parametrize("A2,N,bwd_sites", [(25, 13, None), (25, 13, "aqkv,affn"),
                                            (81, 5, None)])
def test_ang_block_bwd_mixed_matches_jax_vjp(monkeypatch, A2, N, bwd_sites):
    """K4's plain backward under the mixed plan against jax.vjp of lft_tpu's
    fused block with mm_half, at A2 = 25 and past 64 views (two pixel groups
    a grid step keep the interpret-mode trace short)."""
    monkeypatch.setenv("LFT_ANGB_GPS", "2")
    monkeypatch.setenv("LFT_ANGB_BWD_GPS", "2")
    if bwd_sites is not None:
        monkeypatch.setenv("LFT_MM_HP_BWD_SITES", bwd_sites)
    p = lft.params_from_numpy(_np_params(1 + A2), device="cpu")
    wts = ang_block.ang_weights(p, "altblock.2.ang_trans.")
    x, dout = _rand((N, A2, C), 2), _rand((N, A2, C), 3)
    pe = angular_position(A2, C)
    wn = [jnp.asarray(wts[n].numpy()) for n in ang_block.WEIGHTS]

    def ref(mm_half):
        _, vjp = jax.vjp(lambda x_, *w: ang_block_core(x_, jnp.asarray(pe), *w, H, mm_half),
                         jnp.asarray(x), *wn)
        return vjp(jnp.asarray(dout))

    ref_m, ref_f = ref(True), ref(False)
    plan = common.mm_site_plan(True, common.mm_hp_sites("LFT_MM_HP_BWD_SITES", "none"))
    xt, pet = torch.from_numpy(x), torch.from_numpy(pe)
    _, m, l, attn = ang_block.ang_block(xt, pet, wts, H, with_res=True)
    reset_launches()
    got = ang_block.ang_block_bwd(xt, pet, wts, m, l, attn, torch.from_numpy(dout), H,
                                  plan=plan)
    assert sum(LAUNCHES.values()) == 0
    for name, g, r, r32 in zip(("x",) + ang_block.WEIGHTS, got, ref_m, ref_f):
        _mixed_close(g.numpy(), r, r32, name)


# ----------------------------------------------- (d) K1/K2 forwards ---

def test_block_forwards_under_plan_none_match_jax(monkeypatch):
    """K1's and K2's plain forwards under LFT_MM_HP_SITES=none against
    lft_tpu's mm_half forwards, with the bounds of the backward's."""
    monkeypatch.setenv("LFT_MM_HP_SITES", "none")
    monkeypatch.setenv("LFT_ANGB_GPS", "2")
    plan = common.mm_site_plan(True, common.mm_hp_sites())
    p = lft.params_from_numpy(_np_params(30), device="cpu")
    wa = ang_block.ang_weights(p, "altblock.0.ang_trans.")
    N, A2 = 13, 25
    x = _rand((N, A2, C), 31)
    pe = angular_position(A2, C)
    wn = [jnp.asarray(wa[n].numpy()) for n in ang_block.WEIGHTS]
    ref = [ang_block_core(jnp.asarray(x), jnp.asarray(pe), *wn, H, mm) for mm in (True, False)]
    got = ang_block.ang_block_plain(torch.from_numpy(x), torch.from_numpy(pe), wa, H, plan=plan)
    _mixed_close(got.numpy(), ref[0], ref[1], "K1 out")

    prefix = "altblock.0.spa_trans."
    ws = spa_block.spa_weights(p, prefix)
    V, h, w = 3, 8, 8
    xs = _rand((V, h, w, C), 32)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              p[prefix + "MLP.weight"])[0].contiguous()
    wn = [jnp.asarray(ws[n].numpy()) for n in spa_block.WEIGHTS]
    ref = [spa_block_core(jnp.asarray(xs), jnp.asarray(pe_tok.numpy()), *wn, H, 5, mm)
           for mm in (True, False)]
    got = spa_block.spa_block_plain(torch.from_numpy(xs), pe_tok, spa_block._with_mlp(ws), H, 5,
                                    plan=plan)
    _mixed_close(got.numpy(), ref[0], ref[1], "K2 out")


def test_model_forward_default_plan_is_f32_and_matches_jax(monkeypatch):
    """Under the default forward plan (all f32) the port's mixed forward is
    its float32 forward bit for bit, and lft_tpu's mixed forward within 1e-4
    (2 of the 4 AltFilter blocks in both: lft_tpu's interpret-mode trace
    stays short)."""
    monkeypatch.setattr(j_lft, "LAYER_NUM", 2)
    monkeypatch.setattr(lft, "LAYER_NUM", 2)
    np_p = _np_params(40)
    x = _rand((1, 1, 40, 40), 41, 0.5) + 0.5
    p = lft.params_from_numpy(np_p, device="cpu")
    kw = dict(channels=C, scale_factor=2)
    with torch.no_grad():
        f32 = lft.forward(p, torch.from_numpy(x), Args(**kw), fused=True)
        mixed = lft.forward(p, torch.from_numpy(x), Args(dtype="mixed", **kw), fused=True)
    assert torch.equal(f32, mixed)
    ref = j_lft.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(x),
                        JArgs(model_name="LFT", dtype="mixed", **kw), remat=False, fused=True)
    assert float(np.abs(mixed.numpy() - np.asarray(ref)).max()) <= 1e-4


# --------------------------------------------- (e) a whole train step ---

def test_mixed_fused_train_step_matches_jax(monkeypatch):
    """One `--dtype mixed --train_fused true` Adam step through the plain
    blocks and backwards against lft_tpu's fused step (interpret mode), at
    the geometry of test_torch_train.py's whole-model gradient test (all 4
    AltFilter blocks, its smooth loss in both packages: under L1 a sign flip
    of sr - y moves a gradient by a whole step), from a warm Adam state: the
    loss; the update (every parameter's, as one vector) within 1e-3
    L2-relative of lft_tpu's and within 1/10 of lft_tpu's mixed-vs-f32
    update distance; each block's SpaTrans and AngTrans updates nearer
    lft_tpu's mixed ones than its f32 ones by half their distance (a K3 or
    K4 that ran f32 fails), and the parameters the plan does not reach
    within 1e-3; the step repeats bitwise. Each block's backward turns f32
    differences of its input into rounding flips (a value summed in another
    order rounding to the neighbouring bf16 value), so the port's distance
    grows toward the first block: 0.03-0.10 of the gap per block here, 0.06
    for the whole update."""
    monkeypatch.setenv("LFT_ANGB_GPS", "2")
    monkeypatch.setenv("LFT_ANGB_BWD_GPS", "2")
    np_p = _np_params(23)
    x = _rand((1, 1, 40, 40), 24, 0.5) + 0.5
    y = _rand((1, 1, 80, 80), 25, 0.5) + 0.5
    kw = dict(angRes=5, scale_factor=2, channels=C, batch_size=1, lr=2e-4, n_steps=15,
              gamma=0.5, epoch=2, train_fused="true")
    j_smooth = lambda sr, hr: jnp.mean((sr - hr) * jnp.cos(3.0 * (sr - hr)))
    smooth = lambda sr, hr: ((sr - hr) * torch.cos(3.0 * (sr - hr))).mean()

    def jstep(dtype):
        jargs = JArgs(model_name="LFT", train_remat=False, dtype=dtype, **kw)
        tx = j_optim.make_optimizer(jargs, steps_per_epoch=10)
        jp = {k: jnp.asarray(v) for k, v in np_p.items()}
        # a warm Adam state (second moments of 1e-6, 5 steps taken): from zero
        # moments the first update is lr g / (|g| + eps), f32 noise and all
        flat = j_trainer.flatten_opt_state(tx.init(jp))
        for i, key in enumerate(sorted(flat)):
            if flat[key].ndim == 0:
                flat[key] = np.asarray(5, flat[key].dtype)
            elif i > len(np_p):
                flat[key] = np.full_like(flat[key], 1e-6)
        model = dataclasses.replace(j_get_model(jargs), loss=j_smooth)
        step = j_trainer.make_train_step(model, tx, jargs, with_metrics=False)
        jp2, _, aux = step(jp, j_trainer.unflatten_opt_state(tx.init(jp), flat),
                           jnp.asarray(x), jnp.asarray(y))
        return {k: np.asarray(v) - np_p[k] for k, v in jp2.items()}, float(aux["loss"]), flat

    upd_m, loss_m, flat = jstep("mixed")
    upd_f, _, _ = jstep("float32")

    def step():
        args = Args(dtype="mixed", **kw)
        p = lft.params_from_numpy(np_p, device="cpu")
        for t in p.values():
            t.requires_grad_(True)
        opt = optim.make_optimizer(p, args, 10)
        opt.load_state(optim.opt_state_from_jax_flat(flat, p))
        model = dataclasses.replace(get_model(args), loss=smooth)
        loss, _, _ = trainer.make_train_step(model, opt, args, with_metrics=False)(
            p, torch.from_numpy(x), torch.from_numpy(y))
        return float(loss), {k: v.detach().clone() for k, v in p.items()}

    loss, p1 = step()
    loss_b, p2 = step()
    assert loss == loss_b and all(torch.equal(p1[k], p2[k]) for k in p1)
    assert abs(loss - loss_m) <= 1e-5 * abs(loss_m)
    got = {k: p1[k].numpy() - np_p[k] for k in np_p}
    cat = lambda u, ks: np.concatenate([u[k].ravel() for k in sorted(ks)])
    _mixed_close(cat(got, np_p), cat(upd_m, np_p), cat(upd_f, np_p), "the update")
    # updates equal in both of lft_tpu's dtypes: the upsampling head, which
    # the plan does not reach, and vectors of values near 1 here (the blocks'
    # LN1 affines, a bias) whose updates of ~1e-7 are lost to f32 rounding
    unreached = [k for k in np_p if np.array_equal(upd_m[k], upd_f[k])]
    assert {"upsampling.0.weight", "upsampling.3.weight"} <= set(unreached)
    assert _l2(cat(got, unreached), cat(upd_m, unreached)) <= 1e-3
    for blk in range(lft.LAYER_NUM):
        for trans in ("spa_trans", "ang_trans"):
            ks = [k for k in np_p if k.startswith(f"altblock.{blk}.{trans}.")
                  and k not in unreached]
            d = _l2(cat(got, ks), cat(upd_m, ks))
            assert d <= 0.5 * _l2(cat(upd_f, ks), cat(upd_m, ks)), (blk, trans, d)


# ------------------------------------------- (f) and (g): the flags ---

def test_train_fused_auto_under_mixed():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not trainer.train_fused(Args(dtype="mixed"), cpu)
    assert trainer.train_fused(Args(dtype="mixed"), cuda)
    assert not trainer.train_fused(Args(dtype="mixed", train_fused="false"), cuda)
    assert trainer.train_fused(Args(dtype="mixed", train_fused="true"), cpu)
    assert not trainer.train_fused(Args(), cpu) and not trainer.train_fused(Args(), cuda)


@pytest.mark.parametrize("prec", [None, "default", "high", "highest"])
def test_matmul_precision_flag(prec):
    """Parsed as lft_tpu parses it; on the CPU it leaves the TF32 flags as
    they are."""
    argv = [] if prec is None else ["--matmul_precision", prec]
    assert parse_args(argv).matmul_precision == j_parse_args(argv).matmul_precision
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        args = parse_args(argv + ["--dtype", "mixed"])
        assert port_device.resolve_device("cpu", port_device.matmul_precision(args)).type == "cpu"
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert port_device.matmul_precision(args) == ("highest" if prec in (None, "default")
                                                      else prec)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    with pytest.raises(SystemExit):
        parse_args(["--matmul_precision", "medium"])


def test_bfloat16_raises_and_card_plans():
    """bfloat16 under grad trains either branch (`fused=False` since ROADMAP
    item 9e) and takes no mixed plan. The card's instances under the plans
    (`card_plan`): every pair of plans runs, a backward subset too (ROADMAP
    item 9h-b: `card_bwd`)."""
    p = lft.init_params(0, Args(channels=C, scale_factor=2), device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    out = lft.forward(p, torch.zeros(1, 1, 40, 40), Args(channels=C, scale_factor=2,
                                                         dtype="bfloat16"), fused=False)
    out.sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.float32 for t in p.values())
    assert parse_args(["--dtype", "mixed"]).dtype == "mixed"
    plan = lambda sites: common.mm_site_plan(True, sites)
    half, f32 = plan(frozenset()), plan(common.MM_HP_ALL)
    assert common.card_plan(f32, half)["spa_qkv_ln_bwd"] == "spa_qkv_ln_bwd_bf16"
    assert common.card_plan(f32, f32)["ang_block_bwd"] == "ang_block_bwd"
    assert common.card_plan(None, None)["spa_ln_qkv"] == "spa_ln_qkv"
    assert common.card_plan(half, half)["ang_block_bwd"] == "ang_block_bwd_bf16"
    # a forward subset: `_build.MIXED_SITES`
    assert common.card_plan(plan(frozenset({"qk"})), half)["spa_qkv"] == "spa_qkv_sites"
    assert common.card_fwd(plan(frozenset({"qk"})), "spa_qkv") == "_sites"
    # a backward subset (`_build.MIXED_BWD_SITES`): qk f32, v rounded
    names = common.card_plan(f32, plan(frozenset({"qk", "ffn"})))
    assert names["spa_qkv_ln_bwd"] == "spa_qkv_ln_bwd_sites"
    assert names["spa_ln_qkv"] == "spa_ln_qkv_sites"
    assert names["spa_ffn_out_bwd"] == "spa_ffn_out_bwd_sites"
    assert names["spa_tokenize_bwd"] == "spa_tokenize_bwd_bf16"
    assert names["ang_block_bwd"] == "ang_block_bwd_bf16"
    assert common.card_bwd(False, half, "spa_ln_qkv") == "_bf16"
    assert common.card_bwd(False, None, "spa_ln_qkv") == "" == common.card_bwd(False, f32,
                                                                                "spa_ln_qkv")
    assert common.card_bwd(True, f32, "ang_block_bwd") == "_dp"
    assert common.card_bwd(False, plan(frozenset({"qk"})), "spa_ln_qkv") == "_sites"
    assert common.card_fwd(f32, "spa_qkv") == ""


def test_mixed_plans_are_read_per_call(monkeypatch):
    """The model reads the plans once a call: a changed variable takes
    effect at the next call, and a bad one raises there (fused branch)."""
    args = Args(channels=C, scale_factor=2, dtype="mixed")
    p = lft.init_params(0, args, device="cpu")
    x = torch.rand(1, 1, 40, 40, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = lft.forward(p, x, args, fused=True)
        monkeypatch.setenv("LFT_MM_HP_SITES", "none")
        b = lft.forward(p, x, args, fused=True)
        monkeypatch.setenv("LFT_MM_HP_SITES", "qk,bogus")
        with pytest.raises(ValueError, match="bogus"):
            lft.forward(p, x, args, fused=True)
        lft.forward(p, x, dataclasses.replace(args, dtype="float32"), fused=True)
    assert 0 < float((a - b).abs().max()) < 0.05
