"""`--dtype mixed` under LFT_MM_HP_SITES site subsets in the port against
lft_tpu's, on the CPU: K1's and K2's forwards with and without the
residuals, the 2-block fused forward, the block VJPs under the backward plan
`all` and a fused Adam step (backward `none`), under the two complementary
subsets S1 and S2 of tests/_torch_sites_ref.py (between them every
product-site split of a `_sites` kernel goes both ways); then the dispatch
that sends each forward launch to its f32, `_bf16` or `_sites` instance on
the card (`kernels.common.card_fwd`).

lft_tpu's outputs come from tests/_torch_sites_ref.py, six processes of
their own with XLA's excess precision off (tests/_torch_bf16_ref.py says
why). The bounds are those of tests/test_torch_mixed_none_train.py (the
blocks, the VJPs and the step) and tests/test_torch_fwdforms.py (the
forward):

* every block output and gradient: L2 within MIXED_REL of lft_tpu's and
  within MIXED_GAP of lft_tpu's mixed-vs-f32 distance for the plan
  (`_mixed_close`; within F32_L2 where the plan leaves it f32); K2's out
  within K2_OUT_GAP of it, for the cause test_torch_mixed_none_train.py
  gives (torch's exp and f32 sums flip some bf16 roundings of e against
  XLA's, and the steps after carry them); m and l too (not that file's
  STATS_L2: where `score` rounds q and k after an f32 sum in torch's order,
  a flipped rounding moves a score, as measured for K2 under S2 at C = 64:
  m and l 2.5e-5 and 5.7e-5 from lft_tpu's, 0.016 of the distance); the
  port's own distance from its f32 form within SELF_GAP of lft_tpu's;
  attn holding bf16 values exactly where its residual's site (`awo` /
  `wo`) rounds; the f32 forms within F32_L2;
* the forward (2 of the 4 blocks): its distance from the port's f32
  forward within SELF_GAP of lft_tpu's, and its L2 from lft_tpu's within
  FWD_L2 of that distance;
* the step: as test_torch_mixed_none_train.py's (STEP_L2, STEP_BLOCK) and
  a bitwise repeat, but the loss within STEP_L2 of lft_tpu's S1-vs-f32
  loss distance: that file's relative 1e-4 is below what S1's flips allow,
  whose loss distance is itself only 2.5e-3 relative (the port's loss lay
  0.16 of it from lft_tpu's, measured; the 2-block forward 0.08).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import (LAUNCHES, MIXED_FWD, MIXED_SITES, ang_block, common,
                               reset_launches, spa_block)
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear
from lft_torch.registry import get_model
from lft_torch.training import optim, trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sites_ref as R  # noqa: E402

MIXED_REL, MIXED_GAP = 1e-3, 0.1
K2_OUT_GAP = 0.2
SELF_GAP = 0.1
F32_L2 = 1e-5
FWD_L2 = 0.5
STEP_L2, STEP_BLOCK = 0.5, 0.75
H = 8
PLANS = {s: common.mm_site_plan(True, frozenset(v.split(","))) for s, v in R.SUBSETS.items()}


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
    d = tmp_path_factory.mktemp("sites")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(os.path.dirname(__file__), "_torch_sites_ref.py")
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


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


def _mixed_close(got, want, want32, what, rel=MIXED_REL, gap_tol=MIXED_GAP):
    got = _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d, gap = _l2(got, want), _l2(want32, want)
    # an output whose sites all stay f32 under the plan (S2's tok) is f32
    assert d <= rel and (d <= gap_tol * gap or gap == 0 and d <= F32_L2), (what, d, gap)


def _self_gap(got, got32, want, want32, what):
    """The port's distance from its own f32 form within SELF_GAP of
    lft_tpu's for the same plan."""
    own, gap = _l2(_np(got), _np(got32)), _l2(want, want32)
    assert gap > 1e-5 and abs(own / gap - 1) <= SELF_GAP, (what, own, gap)


def _bf16_valued(t):
    return torch.equal(t, common.bf16_round(t))


def _k1(C):
    d = R.block_inputs(C)
    wts = ang_block.ang_weights(lft.params_from_numpy(d["params"], device="cpu"), R.ANG_PREFIX)
    return (torch.from_numpy(d["k1_x"]), torch.from_numpy(angular_position(R.K1_SHAPE[1], C)),
            wts, torch.from_numpy(d["k1_dout"]))


def _k2(C, r):
    d = R.block_inputs(C)
    p = lft.params_from_numpy(d["params"], device="cpu")
    wts = spa_block._with_mlp(spa_block.spa_weights(p, R.SPA_PREFIX))
    h, w = R.K2_SHAPE[1:]
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              wts["mlp"])[0].contiguous()
    assert _l2(pe_tok.numpy(), r[f"k2_{C}_petok"]) < 1e-6
    return torch.from_numpy(d["k2_x"]), pe_tok, wts, torch.from_numpy(d["k2_dout"])


def _ml(r, C, dt):
    """lft_tpu's K2 stats [V, 2, tiles, nq, H] -> (m, l), each [V, h, w, H]."""
    V, h, w = R.K2_SHAPE
    th, tw = (int(t) for t in r["k2_tile"])
    ml = r[f"k2_{C}_{dt}_ml"].reshape(V, 2, h // th, w // tw, th, tw, H)
    ml = ml.transpose(0, 1, 2, 4, 3, 5, 6).reshape(V, 2, h, w, H)
    return ml[:, 0], ml[:, 1]


# ------------------------------------------------------- (a) the blocks ---

@pytest.mark.parametrize("s", sorted(R.SUBSETS))
@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k1_under_subset_matches_lft_tpu(ref, C, s):
    """K1's plain forward under the subset, with the residuals and without,
    against lft_tpu's `_core_fwd(mm_half=True)` under it: out, attn (bf16
    values where `awo` rounds), m (the token's max over its heads in every
    slot) and l; its distance from the port's f32 K1 against lft_tpu's; the
    f32 forms; the wrapper on a CPU tensor is the plain version."""
    r, r32, plan = ref[f"blocks_{s}"], ref["blocks_s2"], PLANS[s]
    x, pe, wts, _ = _k1(C)
    got = ang_block.ang_block_plain(x, pe, wts, H, with_res=True, plan=plan)
    out, m, l, attn = got
    want = lambda n: (r[f"k1_{C}_mixed_{n}"], r32[f"k1_{C}_f32_{n}"])
    _mixed_close(out, *want("out"), "out")
    _mixed_close(attn, *want("attn"), "attn")
    for n, t in (("m", m), ("l", l)):
        _mixed_close(t, *want(n), n)
    assert _bf16_valued(attn) == plan["awo"] and torch.equal(m, m[..., :1].expand_as(m))
    fwd = ang_block.ang_block_plain(x, pe, wts, H, plan=plan)
    assert torch.equal(fwd, out)
    _mixed_close(fwd, r[f"k1_{C}_mixed_fwd"], r32[f"k1_{C}_f32_fwd"], "fwd")
    f32 = ang_block.ang_block_plain(x, pe, wts, H)
    assert _l2(f32.numpy(), r32[f"k1_{C}_f32_fwd"]) <= F32_L2
    _self_gap(fwd, f32, r[f"k1_{C}_mixed_fwd"], r32[f"k1_{C}_f32_fwd"], "K1")
    assert all(torch.equal(a, b) for a, b in zip(got, ang_block.ang_block(
        x, pe, wts, H, with_res=True, plan=plan)))
    assert torch.equal(fwd, ang_block.ang_block(x, pe, wts, H, plan=plan))


@pytest.mark.parametrize("s", sorted(R.SUBSETS))
@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k2_under_subset_matches_lft_tpu(ref, C, s):
    """K2's plain forward under the subset, with the residuals and without,
    against lft_tpu's `_fwd_call(mm_half=True)` under it, its per-tile stats
    taken to the port's [V, h, w, H]: out, tok (f32), attn (bf16 values
    where `wo` rounds), m (the query's max over its heads and pad keys) and
    l; K2's steps 4-5 from lft_tpu's own attn; the distance from the port's
    f32 K2 against lft_tpu's; the window step's CPU wrappers."""
    r, r32, plan = ref[f"blocks_{s}"], ref["blocks_s2"], PLANS[s]
    x, pe_tok, wts, _ = _k2(C, r)
    out, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, with_res=True,
                                                     plan=plan)
    want = lambda n: (r[f"k2_{C}_mixed_{n}"], r32[f"k2_{C}_f32_{n}"])
    for n, t in (("tok", tok), ("attn", attn)):
        _mixed_close(t, *want(n), n)
    _mixed_close(out, *want("out"), "out", gap_tol=K2_OUT_GAP)
    x2, xn2 = spa_block.outproj_ln_plain(torch.from_numpy(r[f"k2_{C}_mixed_attn"]), tok, wts,
                                         plan)
    _mixed_close(spa_block.ffn_out_plain(xn2, x2, wts, plan), *want("out"), "out from attn")
    (mn, ln), (m32, l32) = _ml(r, C, "mixed"), _ml(r32, C, "f32")
    _mixed_close(m, mn, m32, "m")
    _mixed_close(l, ln, l32, "l")
    assert tok.dtype == torch.float32 and _bf16_valued(attn) == plan["wo"]
    assert torch.equal(m, m[..., :1].expand_as(m))
    fwd = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, plan=plan)
    assert torch.equal(fwd, out)
    _mixed_close(fwd, r[f"k2_{C}_mixed_fwd"], r32[f"k2_{C}_f32_fwd"], "fwd", gap_tol=K2_OUT_GAP)
    f32 = spa_block.spa_block_plain(x, pe_tok, wts, H, 5)
    assert _l2(f32.numpy(), r32[f"k2_{C}_f32_fwd"]) <= F32_L2
    _self_gap(fwd, f32, r[f"k2_{C}_mixed_fwd"], r32[f"k2_{C}_f32_fwd"], "K2")
    q, k, v = spa_block.qkv_plain(*spa_block.tokenize_ln_plain(x, pe_tok, wts, plan)[::-1],
                                  wts, plan)
    got = spa_block.window_attn(q, k, v, H, 5, with_stats=True, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, (attn, m, l)))
    assert torch.equal(fwd, spa_block.spa_block(x, pe_tok, wts, H, 5, plan=plan))


# ------------------------------------------------------ (b) the forward ---

@pytest.mark.parametrize("s", sorted(R.SUBSETS))
def test_forward_under_subset_matches_lft_tpu(ref, monkeypatch, s):
    """The port's fused forward under `--dtype mixed` with the subset in
    LFT_MM_HP_SITES on the CPU (2 of the 4 blocks, as lft_tpu's in the
    reference process): its distance from its f32 forward is lft_tpu's
    within SELF_GAP, and it lies within FWD_L2 of that distance from
    lft_tpu's; no launch; the f32 forwards agree."""
    lr, p = R.fwd_inputs()
    tp = lft.params_from_numpy(p, device="cpu")
    monkeypatch.setattr(lft, "LAYER_NUM", R.FWD_LAYERS)
    monkeypatch.setenv("LFT_MM_HP_SITES", R.SUBSETS[s])
    x = torch.from_numpy(lr)
    reset_launches()
    with torch.no_grad():
        mixed = lft.forward(tp, x, Args(dtype="mixed", **R.FWD), fused=True)
        f32 = lft.forward(tp, x, Args(**R.FWD), fused=True)
    assert sum(LAUNCHES.values()) == 0 and mixed.dtype == torch.float32
    want, want32 = ref[f"fwd_{s}"]["fwd_mixed"], ref["fwd_s1"]["fwd_float32"]
    _self_gap(mixed, f32, want, want32, "forward")
    assert _l2(mixed.numpy(), want) <= FWD_L2 * _l2(want, want32)
    assert _l2(f32.numpy(), want32) < F32_L2


# --------------------------------------- (c) training: VJPs and a step ---

@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_block_vjps_under_s1_backward_all(ref, C):
    """Each block's backward under LFT_MM_HP_BWD_SITES=all from its forward's
    residuals under S1 (K4 and K3 f32, forming the attention's D from their
    own p: `common.card_bwd`'s `_dp`) against jax.vjp of lft_tpu's fused block with
    mm_half under the same two plans, every gradient."""
    r, r32, plan = ref["blocks_s1"], ref["blocks_s2"], PLANS["s1"]
    assert common.card_bwd(True, None, "ang_block_bwd") == "_dp"
    assert common.card_bwd(False, plan, "ang_block_bwd") == "_sites"
    x, pe, wts, dout = _k1(C)
    _, m, l, attn = ang_block.ang_block_plain(x, pe, wts, H, with_res=True, plan=plan)
    got = ang_block.ang_block_bwd(x, pe, wts, m, l, attn, dout, H, d_from_p=True)
    for i, g in enumerate(got):
        _mixed_close(g, r[f"k4_{C}_mixed_{i}"], r32[f"k4_{C}_f32_{i}"], f"K4 #{i}")
    x, pe_tok, wts, dout = _k2(C, r)
    _, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, with_res=True,
                                                   plan=plan)
    got = spa_block.spa_block_bwd(x, pe_tok, wts, tok, m, l, attn, dout, H, 5, d_from_p=True)
    for i, g in enumerate(got):
        _mixed_close(g, r[f"k3_{C}_mixed_{i}"], r32[f"k3_{C}_f32_{i}"], f"K3 #{i}")


def test_fused_train_step_under_s1_matches_lft_tpu(ref, monkeypatch):
    """One `--dtype mixed --train_fused true` Adam step of the whole model
    under S1 and the backward's default plan `none` (the plain blocks and
    backwards on the CPU) against lft_tpu's fused step, from the same warm
    Adam state under the smooth loss: the loss, the update as one vector
    and block by block (module docstring); no launch, and a bitwise
    repeat."""
    monkeypatch.setenv("LFT_MM_HP_SITES", R.SUBSETS["s1"])
    rn, rf = ref["step_s1"], ref["step_f32"]
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


# ------------------------------------------------------------ (d) gates ---

# The launch of each forward kernel on the card under S1 and S2 (ROADMAP 9h).
EXPECT = {
    "s1": dict(ang_block="ang_block_sites", ang_block_res="ang_block_res_sites",
               spa_tokenize_ln="spa_tokenize_ln_bf16",
               spa_tokenize_ln_pm="spa_tokenize_ln_pm_bf16", spa_qkv="spa_qkv_sites",
               spa_window_attn="spa_window_attn_sites",
               spa_window_attn_res="spa_window_attn_res_sites", spa_outproj_ln="spa_outproj_ln",
               spa_ffn_out="spa_ffn_out_sites", spa_ffn_out_pm="spa_ffn_out_pm_sites"),
    "s2": dict(ang_block="ang_block_sites", ang_block_res="ang_block_res_sites",
               spa_tokenize_ln="spa_tokenize_ln", spa_tokenize_ln_pm="spa_tokenize_ln_pm",
               spa_qkv="spa_qkv_sites", spa_window_attn="spa_window_attn_sites",
               spa_window_attn_res="spa_window_attn_res_sites",
               spa_outproj_ln="spa_outproj_ln_bf16", spa_ffn_out="spa_ffn_out_sites",
               spa_ffn_out_pm="spa_ffn_out_pm_sites"),
}


@pytest.mark.parametrize("s", sorted(R.SUBSETS))
def test_subset_dispatch(s):
    """Under a subset each forward launch takes its f32 instance where none
    of its sites round, `_bf16` where all do and `_sites` where some do, with
    the mask of its rounding sites (csrc/tf32.cuh's bits); the names exist
    among the launch counts."""
    plan, x = PLANS[s], torch.zeros(2, 4)
    got = {k: common.fwd_kernel(k, x, plan) for k in common.KERNEL_SITES}
    assert got == EXPECT[s]
    assert set(got.values()) <= set(LAUNCHES)
    assert {n for n in got.values() if n.endswith("_sites")} == set(MIXED_SITES)
    bits = common.SITE_BITS
    masks = {k: common.site_mask(plan, k) for k in common.KERNEL_SITES}
    if s == "s1":   # rounds tok, v, av, lin, ascore, awo, affn
        assert masks["ang_block"] == bits["ascore"] | bits["awo"] | bits["affn"]
        assert masks["spa_qkv"] == bits["v"] and masks["spa_window_attn"] == bits["av"]
        assert masks["spa_window_attn_res"] == bits["av"] and masks["spa_ffn_out"] == bits["lin"]
    else:           # rounds qk, score, ffn, aqkv, aav, wo
        assert masks["ang_block"] == masks["ang_block_res"] == bits["aqkv"] | bits["aav"]
        assert masks["spa_qkv"] == bits["qk"] and masks["spa_window_attn"] == bits["score"]
        assert masks["spa_window_attn_res"] == bits["score"] | bits["wo"]
        assert masks["spa_ffn_out"] == masks["spa_ffn_out_pm"] == bits["ffn"]
    assert sorted(bits.values()) == [1 << i for i in range(len(common.MM_HP_ALL))]


def test_plan_gates():
    """`all` and no plan take the f32 instances and `none` the `_bf16` ones
    (as at the parent: `kernels.MIXED_FWD` and K1 res, K2.3 res); the card
    takes every pair of forward and backward plans (`card_plan`), a backward
    subset too, each backward launch its f32, `_bf16`, `_sites` (ROADMAP
    item 9h-b) or, K4, `_dp` instance (tests/test_torch_bwd_sites.py holds
    the backward's names)."""
    x = torch.zeros(2, 4)
    half, f32 = common.mm_site_plan(True, frozenset()), common.mm_site_plan(True, common.MM_HP_ALL)
    for k in common.KERNEL_SITES:
        assert common.fwd_kernel(k, x, f32) == common.fwd_kernel(k, x, None) == k
        assert common.fwd_kernel(k, x, half) == k + "_bf16"
    assert {k + "_bf16" for k in common.KERNEL_SITES} <= set(MIXED_FWD) | {
        "ang_block_res_bf16", "spa_window_attn_res_bf16"}
    for fwd in (None, f32, half, *PLANS.values()):
        for bwd in (half, f32, *PLANS.values()):
            names = common.card_plan(fwd, bwd)
            assert set(names.values()) <= set(LAUNCHES), (fwd, bwd)
            assert all(names[k] == k + common.card_fwd(fwd, k) for k in common.KERNEL_SITES)
        assert all(v == k + "_bf16" for k, v in common.card_plan(fwd, half).items()
                   if k in common.KERNEL_BWD_SITES)
    some = common.card_plan(None, common.mm_site_plan(True, frozenset({"qk", "ffn"})))
    assert some["spa_ffn_out_bwd"] == "spa_ffn_out_bwd_sites"
    assert some["spa_ln_qkv"] == "spa_ln_qkv_sites"
    assert some["spa_qkv_ln_bwd"] == "spa_qkv_ln_bwd_sites"
    xb = torch.zeros(2, 4, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="a bf16 tensor runs no --dtype mixed plan"):
        common.fwd_kernel("spa_qkv", xb, PLANS["s1"])
