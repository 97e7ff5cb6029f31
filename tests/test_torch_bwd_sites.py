"""`--dtype mixed` training under LFT_MM_HP_BWD_SITES site subsets in the
port against lft_tpu's, on the CPU: the plain K4 (at A2 = 25 and 81) and K3
under the backward subsets S1 and S2 (tests/_torch_sites_ref.py's
complementary pair: between them every `_sites` launch of the backward is
split both ways), after a forward under `all` and after one under S1, every
cotangent against jax.vjp of lft_tpu's fused blocks; a fused Adam step of
the whole model under (forward `none`, backward S1) and (forward S2,
backward S2); and the dispatch that names each backward launch's instance
on the card (`kernels.common.card_bwd`).

lft_tpu's outputs come from tests/_torch_bwd_sites_ref.py, processes of
their own with XLA's excess precision off (tests/_torch_bf16_ref.py says
why). The bounds are tests/test_torch_sites.py's:

* every cotangent: L2 within MIXED_REL of lft_tpu's and within MIXED_GAP of
  lft_tpu's mixed-vs-f32 distance for the plans (`_mixed_close`; within
  F32_L2 where the plans leave it f32);
* the step: the loss within STEP_L2 of lft_tpu's mixed-vs-f32 loss
  distance, the update within STEP_L2 of lft_tpu's mixed-vs-f32 update
  distance as one vector and STEP_BLOCK of it block by block, and a bitwise
  repeat.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import (LAUNCHES, MIXED_BWD_SITES, ang_block, common, reset_launches,
                               spa_block)
from lft_torch.kernels.spa_attn_hp import spa_attn_hp_bwd
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear
from lft_torch.registry import get_model
from lft_torch.training import optim, trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bwd_sites_ref as R  # noqa: E402

MIXED_REL, MIXED_GAP = 1e-3, 0.1
F32_L2 = 1e-5
STEP_L2, STEP_BLOCK = 0.5, 0.75
H = 8
PLANS = {s: common.mm_site_plan(True, frozenset(v.split(","))) for s, v in R.SUBSETS.items()}
FWD = {"all": None, "s1": PLANS["s1"]}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _plans(monkeypatch):
    monkeypatch.delenv("LFT_MM_HP_SITES", raising=False)
    monkeypatch.delenv("LFT_MM_HP_BWD_SITES", raising=False)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("bwd_sites")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(os.path.dirname(__file__), "_torch_bwd_sites_ref.py")
    procs = {part: subprocess.Popen([sys.executable, script, str(d / f"{part}.npz"), part],
                                    env=env) for part in R.PARTS}
    try:
        for part, proc in procs.items():
            assert proc.wait(timeout=600) == 0, part
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return {part: dict(np.load(d / f"{part}.npz")) for part in R.PARTS}


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _mixed_close(got, want, want32, what):
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d, gap = _l2(got, want), _l2(want32, want)
    # a cotangent whose products all stay f32 under the plans is f32
    assert d <= MIXED_REL and (d <= MIXED_GAP * gap or gap == 0 and d <= F32_L2), (what, d, gap)


# ------------------------------------------------------- (a) the blocks ---

def _k4(C, A2):
    d = R.k4_inputs(C, A2)
    wts = ang_block.ang_weights(lft.params_from_numpy(d["params"], device="cpu"), R.ANG_PREFIX)
    return (torch.from_numpy(d["x"]), torch.from_numpy(angular_position(A2, C)), wts,
            torch.from_numpy(d["dout"]))


def _k3(C, r):
    d = R.block_inputs(C)
    wts = spa_block._with_mlp(spa_block.spa_weights(lft.params_from_numpy(d["params"],
                                                                          device="cpu"),
                                                    R.SPA_PREFIX))
    h, w = R.K2_SHAPE[1:]
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              wts["mlp"])[0].contiguous()
    assert _l2(pe_tok.numpy(), r["petok"]) < 1e-6
    return torch.from_numpy(d["k2_x"]), pe_tok, wts, torch.from_numpy(d["k2_dout"])


@pytest.mark.parametrize("b", sorted(R.SUBSETS))
@pytest.mark.parametrize("f", sorted(R.FWD_PLANS))
@pytest.mark.parametrize("C", R.C_BLOCKS)
@pytest.mark.parametrize("A2", [25, 81])
def test_k4_under_bwd_subset_matches_lft_tpu(ref, A2, C, f, b):
    """K4's plain backward under the backward subset, from its forward's
    residuals under the forward plan (`all` or S1), against jax.vjp of
    lft_tpu's fused AngTrans block with mm_half under the same two plans:
    dx, the LN affine and every weight gradient; the wrapper on CPU tensors
    is the plain version and launches nothing."""
    r = ref[f"k4a{A2}_{C}"]
    x, pe, wts, dout = _k4(C, A2)
    _, m, l, attn = ang_block.ang_block_plain(x, pe, wts, H, with_res=True, plan=FWD[f])
    reset_launches()
    got = ang_block.ang_block_bwd(x, pe, wts, m, l, attn, dout, H, PLANS[b], FWD[f] is not None)
    assert not any(LAUNCHES.values())
    for i, g in enumerate(got):
        _mixed_close(g, r[f"{f}_{b}_{i}"], r[f"f32_{i}"], f"K4 #{i}")
    plain = ang_block.ang_block_bwd_plain(x, pe, wts, m, l, attn, dout, H, PLANS[b])
    assert all(torch.equal(a, b_) for a, b_ in zip(got, plain))


@pytest.mark.parametrize("b", sorted(R.SUBSETS))
@pytest.mark.parametrize("f", sorted(R.FWD_PLANS))
@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k3_under_bwd_subset_matches_lft_tpu(ref, C, f, b):
    """K3's plain backward under the backward subset, from its forward's
    residuals under the forward plan, against jax.vjp of lft_tpu's fused
    SpaTrans block with mm_half under the same two plans: dx, dpe_tok, the
    LN affine and every weight gradient; no launch."""
    r = ref[f"k3_{C}"]
    x, pe_tok, wts, dout = _k3(C, r)
    _, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, with_res=True,
                                                   plan=FWD[f])
    reset_launches()
    got = spa_block.spa_block_bwd(x, pe_tok, wts, tok, m, l, attn, dout, H, 5, PLANS[b],
                                  FWD[f] is not None)
    assert not any(LAUNCHES.values())
    for i, g in enumerate(got):
        _mixed_close(g, r[f"{f}_{b}_{i}"], r[f"f32_{i}"], f"K3 #{i}")


# ------------------------------------------------------- (b) the steps ---

@pytest.mark.parametrize("s", sorted(R.STEPS))
def test_fused_train_step_under_bwd_subset_matches_lft_tpu(ref, monkeypatch, s):
    """One `--dtype mixed --train_fused true` Adam step of the whole model
    with both plans set (forward `none` and backward S1; S2 and S2), the
    plain blocks and backwards on the CPU, against lft_tpu's fused step from
    the same warm Adam state under the smooth loss: the loss, the update as
    one vector and block by block (module docstring); no launch, and a
    bitwise repeat."""
    fwd, bwd = R.STEPS[s]
    monkeypatch.setenv("LFT_MM_HP_SITES", fwd)
    monkeypatch.setenv("LFT_MM_HP_BWD_SITES", bwd)
    rn, rf = ref[f"step_{s}"], ref["step_f32"]
    lr, hr, np_p = R.step_inputs()
    flat = {k[len("flat_"):]: v for k, v in rn.items() if k.startswith("flat_")}
    args = Args(dtype="mixed", **R.STEP)
    smooth = lambda sr, y: R.smooth_loss(sr, y, torch)

    def step():
        p = lft.params_from_numpy(np_p, device="cpu")
        for t in p.values():
            t.requires_grad_(True)
        opt = optim.make_optimizer(p, args, 10)
        opt.load_state(optim.opt_state_from_jax_flat(flat, p))
        model = dataclasses.replace(get_model(args), loss=smooth)
        loss, _, _ = trainer.make_train_step(model, opt, args, with_metrics=False)(
            p, torch.from_numpy(lr), torch.from_numpy(hr))
        return float(loss), {k: v.detach().clone() for k, v in p.items()}

    reset_launches()
    loss, p1 = step()
    assert not any(LAUNCHES.values())
    loss_b, p2 = step()
    assert loss == loss_b and all(torch.equal(p1[k], p2[k]) for k in p1)
    assert abs(loss - float(rn["loss"])) <= STEP_L2 * abs(float(rf["loss"]) - float(rn["loss"]))
    keys = sorted(np_p)
    upd = np.concatenate([(p1[k].numpy() - np_p[k]).ravel() for k in keys])
    gap = _l2(rf["update"], rn["update"])
    assert _l2(upd, rn["update"]) <= STEP_L2 * gap, (_l2(upd, rn["update"]), gap)
    offs = np.cumsum([0] + [np_p[k].size for k in keys])
    part = lambda u, ks: np.concatenate([u[offs[keys.index(k)]:offs[keys.index(k) + 1]]
                                         for k in ks])
    for blk in range(lft.LAYER_NUM):
        for trans in ("spa_trans", "ang_trans"):
            ks = [k for k in keys if k.startswith(f"altblock.{blk}.{trans}.")]
            d = _l2(part(upd, ks), part(rn["update"], ks))
            gap_b = _l2(part(rf["update"], ks), part(rn["update"], ks))
            assert d <= STEP_BLOCK * gap_b, (blk, trans, d, gap_b)


# ---------------------------------------------------- (c) the dispatch ---

# The instance of each backward launch on the card (ROADMAP 9h-b) under the
# backward plan, after a forward under `all` (and, last, under `none`).
_SPA = ("spa_ffn_out_bwd", "spa_ln_qkv", "spa_window_attn_bwd", "spa_qkv_ln_bwd",
        "spa_tokenize_bwd")
_K4 = ("ang_block_bwd", "ang_block_bwd128")
EXPECT = {
    # S1 rounds tok, v, av, lin, ascore, awo, affn
    "s1": dict(spa_ffn_out_bwd="_sites", spa_ln_qkv="_sites", spa_window_attn_bwd="_sites",
               spa_qkv_ln_bwd="_sites", spa_tokenize_bwd="_bf16", ang_block_bwd="_sites",
               ang_block_bwd128="_sites"),
    # S2 rounds qk, score, ffn, aqkv, aav, wo
    "s2": dict(spa_ffn_out_bwd="_sites", spa_ln_qkv="_sites", spa_window_attn_bwd="_sites",
               spa_qkv_ln_bwd="_sites", spa_tokenize_bwd="", ang_block_bwd="_sites",
               ang_block_bwd128="_sites"),
    "none": {k: "_bf16" for k in _SPA + _K4},
    "all": {k: "" for k in _SPA + _K4},
}
MASKS = {
    "s1": dict(spa_ffn_out_bwd=("lin",), spa_ln_qkv=("v",), spa_window_attn_bwd=("av",),
               spa_qkv_ln_bwd=("v",), ang_block_bwd=("ascore", "awo", "affn")),
    "s2": dict(spa_ffn_out_bwd=("wo", "ffn"), spa_ln_qkv=("qk",), spa_window_attn_bwd=("score",),
               spa_qkv_ln_bwd=("qk",), ang_block_bwd=("aqkv", "aav")),
}


@pytest.mark.parametrize("spec", ["s1", "s2", "none", "all"])
def test_bwd_dispatch(spec):
    """Under a backward plan each backward launch takes its f32 instance
    where none of its sites round, `_bf16` where all do and `_sites` where
    some do, with the mask of its rounding sites (csrc/tf32.cuh's bits);
    K3.e computes one site and never takes `_sites`; the names exist among
    the launch counts, and the `_sites` ones are `kernels.MIXED_BWD_SITES`."""
    bwd = PLANS.get(spec) or common.mm_site_plan(True, frozenset() if spec == "none"
                                                 else common.MM_HP_ALL)
    got = {k: common.card_bwd(False, bwd, k) for k in common.KERNEL_BWD_SITES}
    assert got == EXPECT[spec]
    names = {k + v for k, v in got.items()}
    assert names <= set(LAUNCHES)
    if spec in MASKS:
        assert {n for n in names if n.endswith("_sites")} == set(MIXED_BWD_SITES)
        for k, sites in MASKS[spec].items():
            assert common.site_mask(bwd, k) == sum(common.SITE_BITS[s] for s in sites)
        assert common.site_mask(bwd, "ang_block_bwd128") == common.site_mask(bwd, "ang_block_bwd")
        assert common.card_plan(FWD["s1"], bwd) == {
            **{k: k + common.card_fwd(FWD["s1"], k) for k in common.KERNEL_SITES},
            **{k: k + v for k, v in got.items()}}


def test_bwd_dispatch_k4_dp_after_a_rounded_forward():
    """A backward plan that keeps K4's five sites f32 and rounds every
    spatial one, after a forward under `none`: K4 takes `_dp` (its f32
    instance would form D = dattn . attn from the rounded forward's attn,
    not lft_tpu's D = sum_j p_j dp_j), K3's five steps `_bf16`; after a
    forward under `all` K4's f32 instance. The blocks' backwards pass the
    forward's rounding on (`d_from_p`), the bool `card_bwd` takes."""
    none = common.mm_site_plan(True, frozenset())
    bwd = common.mm_site_plan(True, frozenset({"aqkv", "ascore", "aav", "awo", "affn"}))
    names = common.card_plan(none, bwd)
    assert {k: names[k] for k in _K4} == {k: k + "_dp" for k in _K4}
    assert {k: names[k] for k in _SPA} == {k: k + "_bf16" for k in _SPA}
    assert all(common.card_bwd(False, bwd, k) == "" for k in _K4)
    assert all(common.card_bwd(True, bwd, k) == "_dp" for k in _K4)
    assert all(common.card_bwd(True, none, k) == "_bf16" for k in _K4)
    assert common.card_bwd(True, None, "ang_block_bwd") == "_dp"
    assert common.card_bwd(True, None, "spa_ln_qkv") == ""
    assert set(MIXED_BWD_SITES) <= set(LAUNCHES)


def test_sites_instances_run_on_the_card_only():
    """A `_sites` backward on CPU tensors is its plain version under the plan
    (the wrappers take the plain version for a CPU tensor), and K5's
    backward asked for its site-subset instance on a CPU tensor raises."""
    C, V, h, w = 16, 2, 8, 8
    g = torch.Generator().manual_seed(0)
    q, k, v, dattn = (torch.randn(V, h, w, 2 * C, generator=g) for _ in range(4))
    _, m, l = spa_block.window_attn_plain(q, k, v, H, 5, res=True)
    plan = PLANS["s1"]
    reset_launches()
    got = spa_block.window_attn_bwd(q, k, v, None, dattn, m, l, H, 5, plan)
    ref = spa_block.window_attn_bwd_plain(q, k, v, None, dattn, m, l, H, 5, plan)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)) and not any(LAUNCHES.values())
    with pytest.raises(ValueError, match="run on the card only"):
        spa_attn_hp_bwd(q, k, v, m, l, dattn, H, 5, kernel="spa_window_attn_bwd_sites",
                        sites=common.site_mask(plan, "spa_window_attn_bwd"))
