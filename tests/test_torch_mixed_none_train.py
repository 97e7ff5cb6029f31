"""`--dtype mixed` training under LFT_MM_HP_SITES=none in the port against
lft_tpu's, on the CPU: K1's and K2's `with_res` forwards under the plan
(the residuals a train step saves), the block backwards from them under the
backward plan `all`, a whole fused Adam step under the plan, and the gates
that send it to the card's kernels (`kernels.common`).

lft_tpu's outputs come from tests/_torch_mixed_none_ref.py, three processes
of their own with XLA's excess precision off (tests/_torch_bf16_ref.py says
why). The bounds:

* the residuals and the VJPs: test_torch_mixed.py's `_mixed_close` (L2
  1e-3 and 1/10 of lft_tpu's none-vs-f32 distance) for out, attn, tok and
  every gradient; m and l within L2 1e-5 of lft_tpu's (f32 sums of the same
  bf16-rounded scores); attn holds bf16 values (lft_tpu stores it at the
  `awo` / `wo` site's dtype) and m is the token's (K2: the query's, its pad
  keys scoring 0) max over its heads in every head's slot. K2's out is held
  to K2_OUT_GAP of the distance instead, and K2's steps 4-5 fed lft_tpu's
  own attn to 1/10: torch's exp and f32 sums flip bf16(e) and the stored
  attn's rounding against XLA's in 0.1% (C = 16) / 0.25% (C = 64) of its
  elements, 0.024 of the distance, and the out-projection and FFN sites
  carry the flips (and at C = 64 flip some of their own: 0.036 from
  lft_tpu's attn), to 0.026 / 0.120 of it in out (measured);
  test_torch_fwdforms.py's K11_GAP, for the same cause;
* the step: the loss within STEP_LOSS relative of lft_tpu's; the update as
  one vector within STEP_L2 of lft_tpu's none-vs-f32 distance from
  lft_tpu's (measured 0.38); each block's SpaTrans and AngTrans update
  within STEP_BLOCK of the distance between lft_tpu's `none` and f32
  updates from the `none` one (a block that ran f32 lies near 1). Half the
  distance, test_torch_mixed.py's bound for the backward plan alone, does
  not hold under `none`: the port's blocks lie 0.34-0.61 of it from
  lft_tpu's (0.61 at block 1's AngTrans), with no output of a block more
  than 1/10 off (the tests above): every product of the forward and the
  backward rounds its operands, so an f32 sum in torch's order that lands
  on the other side of a bf16 rounding boundary than XLA's flips a value,
  and four blocks each way carry the flips (PR 25's 2-block forward under
  `none`: 0.27 of its distance); a bitwise repeat.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, MIXED_TRAIN, ang_block, common, reset_launches, spa_block
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear
from lft_torch.registry import get_model
from lft_torch.training import optim, trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mixed_none_ref as R  # noqa: E402

MIXED_REL, MIXED_GAP = 1e-3, 0.1
STATS_L2 = 1e-5
K2_OUT_GAP = 0.2
STEP_LOSS, STEP_L2, STEP_BLOCK = 1e-4, 0.5, 0.75
H = 8
PLAN = common.mm_site_plan(True, frozenset())      # LFT_MM_HP_SITES=none


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _plans(monkeypatch):
    monkeypatch.setenv("LFT_MM_HP_SITES", "none")
    monkeypatch.delenv("LFT_MM_HP_BWD_SITES", raising=False)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed_none")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(os.path.dirname(__file__), "_torch_mixed_none_ref.py")
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


def _mixed_close(got, want, want32, what, rel=MIXED_REL, gap_tol=MIXED_GAP):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d, gap = _l2(got, want), _l2(want32, want)
    assert d <= rel and d <= gap_tol * gap, (what, d, gap)


def _stats_close(got, want, what):
    d = _l2(got.numpy(), want)
    assert d <= STATS_L2, (what, d)


def _k1(C):
    d = R.block_inputs(C)
    wts = ang_block.ang_weights(lft.params_from_numpy(d["params"], device="cpu"), R.ANG_PREFIX)
    return (torch.from_numpy(d["k1_x"]), torch.from_numpy(angular_position(R.K1_SHAPE[1], C)),
            wts, torch.from_numpy(d["k1_dout"]))


def _k2(C, ref):
    d = R.block_inputs(C)
    p = lft.params_from_numpy(d["params"], device="cpu")
    wts = spa_block._with_mlp(spa_block.spa_weights(p, R.SPA_PREFIX))
    h, w = R.K2_SHAPE[1:]
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              wts["mlp"])[0].contiguous()
    assert _l2(pe_tok.numpy(), ref[f"k2_{C}_petok"]) < 1e-6
    return torch.from_numpy(d["k2_x"]), pe_tok, wts, torch.from_numpy(d["k2_dout"])


def _ml(ref, C, dt):
    """lft_tpu's K2 stats [V, 2, tiles, nq, H] -> (m, l), each [V, h, w, H]."""
    V, h, w = R.K2_SHAPE
    th, tw = (int(t) for t in ref["k2_tile"])
    ml = ref[f"k2_{C}_{dt}_ml"].reshape(V, 2, h // th, w // tw, th, tw, H)
    ml = ml.transpose(0, 1, 2, 4, 3, 5, 6).reshape(V, 2, h, w, H)
    return ml[:, 0], ml[:, 1]


def _bf16_valued(t):
    return torch.equal(t, common.bf16_round(t))


# ------------------------------------------------- (i), (ii) residuals ---

@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k1_res_under_none_matches_lft_tpu(ref, C):
    """K1's plain `with_res` forward under the plan against lft_tpu's
    `_core_fwd(with_res=True, mm_half=True)`: out, m (the token's max over
    its heads in every slot), l, and attn of bf16 values; the wrapper on a
    CPU tensor is the plain version."""
    r = ref["blocks"]
    x, pe, wts, _ = _k1(C)
    got = ang_block.ang_block_plain(x, pe, wts, H, with_res=True, plan=PLAN)
    out, m, l, attn = got
    _mixed_close(out, r[f"k1_{C}_none_out"], r[f"k1_{C}_f32_out"], "out")
    _mixed_close(attn, r[f"k1_{C}_none_attn"], r[f"k1_{C}_f32_attn"], "attn")
    _stats_close(m, r[f"k1_{C}_none_m"], "m")
    _stats_close(l, r[f"k1_{C}_none_l"], "l")
    assert _bf16_valued(attn) and torch.equal(m, m[..., :1].expand_as(m))
    assert torch.equal(out, ang_block.ang_block_plain(x, pe, wts, H, plan=PLAN))
    assert all(torch.equal(a, b) for a, b in zip(got, ang_block.ang_block(
        x, pe, wts, H, with_res=True, plan=PLAN)))


@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k2_res_under_none_matches_lft_tpu(ref, C):
    """K2's plain `with_res` forward under the plan against lft_tpu's
    `_fwd_call(with_res=True, mm_half=True)`, its per-tile stats taken to
    the port's [V, h, w, H]: out, tok (f32), m (the query's max over its
    heads and pad keys), l, and attn of bf16 values; the window step's CPU
    wrapper with stats returns the same residuals."""
    r = ref["blocks"]
    x, pe_tok, wts, _ = _k2(C, r)
    out, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, with_res=True,
                                                     plan=PLAN)
    for n, t in (("tok", tok), ("attn", attn)):
        _mixed_close(t, r[f"k2_{C}_none_{n}"], r[f"k2_{C}_f32_{n}"], n)
    want, want32 = r[f"k2_{C}_none_out"], r[f"k2_{C}_f32_out"]
    _mixed_close(out, want, want32, "out", gap_tol=K2_OUT_GAP)
    x2, xn2 = spa_block.outproj_ln_plain(torch.from_numpy(r[f"k2_{C}_none_attn"]), tok, wts,
                                         PLAN)
    _mixed_close(spa_block.ffn_out_plain(xn2, x2, wts, PLAN), want, want32, "out from attn")
    (mn, ln), _ = _ml(r, C, "none"), _ml(r, C, "f32")
    _stats_close(m, mn, "m")
    _stats_close(l, ln, "l")
    assert tok.dtype == torch.float32 and _bf16_valued(attn) and not _bf16_valued(tok)
    assert torch.equal(m, m[..., :1].expand_as(m))
    assert torch.equal(out, spa_block.spa_block_plain(x, pe_tok, wts, H, 5, plan=PLAN))
    q, k, v = spa_block.qkv_plain(*spa_block.tokenize_ln_plain(x, pe_tok, wts, PLAN)[::-1],
                                  wts, PLAN)
    got = spa_block.window_attn(q, k, v, H, 5, with_stats=True, plan=PLAN)
    assert all(torch.equal(a, b) for a, b in zip(got, (attn, m, l)))


# ------------------------------------------- (iv) backward plan `all` ---

@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_block_vjps_forward_none_backward_all(ref, C):
    """Each block's backward under LFT_MM_HP_BWD_SITES=all from its forward's
    residuals under the plan `none` (K4 and K3 f32, reading bf16-valued
    attn as lft_tpu's f32 backward does, and forming the attention's D from
    their own p as lft_tpu's do: `common.card_bwd`'s `_dp`) against jax.vjp of
    lft_tpu's fused block with mm_half under the same two plans, every
    gradient."""
    r = ref["blocks"]
    x, pe, wts, dout = _k1(C)
    _, m, l, attn = ang_block.ang_block_plain(x, pe, wts, H, with_res=True, plan=PLAN)
    assert common.card_bwd(True, None, "ang_block_bwd") == "_dp"
    assert common.card_bwd(False, PLAN, "ang_block_bwd") == "_bf16"
    got = ang_block.ang_block_bwd(x, pe, wts, m, l, attn, dout, H, d_from_p=True)
    for i, g in enumerate(got):
        _mixed_close(g, r[f"k4_{C}_none_{i}"], r[f"k4_{C}_f32_{i}"], f"K4 #{i}")
    x, pe_tok, wts, dout = _k2(C, r)
    _, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, with_res=True,
                                                   plan=PLAN)
    got = spa_block.spa_block_bwd(x, pe_tok, wts, tok, m, l, attn, dout, H, 5, d_from_p=True)
    for i, g in enumerate(got):
        _mixed_close(g, r[f"k3_{C}_none_{i}"], r[f"k3_{C}_f32_{i}"], f"K3 #{i}")


# ------------------------------------------------- (iii) a whole step ---

def test_fused_train_step_under_none_matches_lft_tpu(ref):
    """One `--dtype mixed --train_fused true` Adam step of the whole model
    under LFT_MM_HP_SITES=none (the plain blocks and backwards on the CPU)
    against lft_tpu's fused step, from the same warm Adam state under the
    smooth loss (module docstring's bounds); no launch, and a bitwise
    repeat."""
    rn, rf = ref["step_none"], ref["step_f32"]
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
    assert abs(loss - float(rn["loss"])) <= STEP_LOSS * abs(float(rn["loss"]))
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


# ----------------------------------------------------------- (v) gates ---

def test_card_gates_let_none_train():
    """On the card the forward plan `none` passes under grad (its `_res`
    forms launch `kernels.MIXED_TRAIN`), a forward site subset too (its
    `_sites` forms, ROADMAP item 9h), and a site subset of the backward plan
    too (its backward launches' `_sites` forms, ROADMAP item 9h-b)."""
    f32 = common.mm_site_plan(True, common.MM_HP_ALL)
    some = common.mm_site_plan(True, frozenset({"score", "av"}))
    assert common.card_plan(PLAN, PLAN)["ang_block_res"] == "ang_block_res_bf16"
    assert common.card_plan(PLAN, f32)["ang_block_bwd128"] == "ang_block_bwd128_dp"
    x = torch.zeros(2, 4)
    assert common.fwd_kernel("ang_block_res", x, PLAN) == "ang_block_res_bf16"
    assert common.fwd_kernel("spa_window_attn_res", x, PLAN) == "spa_window_attn_res_bf16"
    assert common.card_plan(some, PLAN)["spa_window_attn_bwd"] == "spa_window_attn_bwd_bf16"
    assert common.fwd_kernel("spa_window_attn_res", x, some) == "spa_window_attn_res_sites"
    assert common.fwd_kernel("ang_block_res", x, some) == "ang_block_res_bf16"
    names = common.card_plan(PLAN, some)   # `score` and `av` f32, the rest rounded
    assert names["spa_window_attn_bwd"] == "spa_window_attn_bwd"
    assert names["spa_ffn_out_bwd"] == "spa_ffn_out_bwd_bf16"
    assert names["ang_block_bwd"] == "ang_block_bwd_bf16"
    assert MIXED_TRAIN == ("ang_block_res_bf16", "spa_window_attn_res_bf16", "ang_block_bwd_dp",
                           "ang_block_bwd128_dp")
    assert set(MIXED_TRAIN) <= set(LAUNCHES)
