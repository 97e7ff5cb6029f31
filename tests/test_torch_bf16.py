"""`--dtype bfloat16` in the port against lft_tpu's, on the CPU.

lft_tpu's bfloat16 runs its fused kernels on bf16 tensors: every product
over bf16 operands, every intermediate rounded to bf16 where it is stored or
added. The port's plain versions of K1 and K2 round at the same points
(lft_torch/kernels/ang_block.py:ang_block_bf16io_plain, spa_block.py's
steps); the card's `_bf16io` kernels are held to those plain versions by
chip_smoke.py. lft_tpu's outputs come from tests/_torch_bf16_ref.py, run in
a process of its own with XLA's excess precision off (its docstring says
why: with it on, the CPU interpret mode skips some of the kernels' bf16
roundings).

Two values that agree to f32 rounding can still round to neighbouring bf16
values, and a changed bf16 value changes every product it enters; so the
comparisons are L2 against lft_tpu's own bf16-vs-f32 distance on the same
inputs, which a path that skipped roundings or ran f32 does not meet:

* a block: within BLOCK_GAP (1/10) of that distance, and no element off by
  more than BLOCK_ULPS bf16 ulps of the output's largest magnitude
  (measured: K1 0.032 / 0.047, K2 0.013 / 0.096 at C = 16 / 64, the rest
  summed in another order than XLA sums it; at most 0.5 ulp);
* each rounding the port must keep, removed, moves a block past that bound
  (the f32 angular PE, LN1 from the unrounded tokens, l from the unrounded
  exps; measured 0.30-0.90);
* the whole forward (C = 16, 8x8 views, 4 blocks): over four blocks such
  neighbouring roundings no longer cancel, so the port's and lft_tpu's bf16
  SR lie as far apart as either lies from f32 (measured 1.19 of lft_tpu's
  distance; an f32 port: 1.0). What a port that skipped roundings changes is
  its own bf16-vs-f32 distance: it must be lft_tpu's within FWD_GAP_TOL
  (measured 0.984; with the upsampler in the NCHW form, one rounding where
  lft_tpu's `fold` rounds its nine partial sums, 0.876; f32: 0), and the
  SR within FWD_L2 (1.5) of lft_tpu's distance from lft_tpu's bf16 SR.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lft_torch import test as ptest
from lft_torch.config import Args, parse_args
from lft_torch.device import check_dtype
from lft_torch.kernels import (LAUNCHES, _build, ang_block, common, local_attn, reset_launches,
                               spa_block)
from lft_torch.kernels.common import bf16_round
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear
from lft_torch.parallel import mesh as pmesh
from lft_torch.training import optim, trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16_ref as R  # noqa: E402

BLOCK_GAP = 0.1
BLOCK_ULPS = 1.0
FWD_GAP_TOL = 0.1
FWD_L2 = 1.5
H = 8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bf16") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__), "_torch_bf16_ref.py"),
                    out], check=True, timeout=600, env=env)
    return dict(np.load(out))


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want|."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _k1(C, pe_round=False):
    d = R.inputs(C)
    pe = torch.from_numpy(angular_position(R.K1_SHAPE[1], C))
    p = {k: _bf(v) for k, v in d["params"].items()}
    if pe_round:
        pe = bf16_round(pe)
    return ang_block.ang_trans_block_fused(_bf(d["k1_x"]), pe, p, R.ANG_PREFIX, H)


def _k2_inputs(C):
    d = R.inputs(C)
    p = {k: _bf(v) for k, v in d["params"].items()}
    h, w = R.K2_SHAPE[1:]
    pe_tok = unfold3x3_linear(_bf(spatial_position(h, w, C))[None],
                              p[R.SPA_PREFIX + "MLP.weight"])[0].contiguous()
    return _bf(d["k2_x"]), pe_tok, p


def _gap(ref, key):
    return _l2(ref[f"{key}_bf16"], ref[f"{key}_f32"])


@pytest.mark.parametrize("C", R.C_BLOCKS)
@pytest.mark.parametrize("block", ["k1", "k2"])
def test_block_matches_lft_tpu_bf16(ref, block, C):
    reset_launches()
    if block == "k1":
        got = _k1(C)
    else:
        x, pe_tok, p = _k2_inputs(C)
        assert _ulps(pe_tok.float().numpy(), ref[f"k2_{C}_bf16_petok"]) <= BLOCK_ULPS
        got = spa_block.spa_trans_block_fused(x, pe_tok, p, R.SPA_PREFIX, H, 5)
    assert got.dtype == torch.bfloat16 and sum(LAUNCHES.values()) == 0
    want = ref[f"{block}_{C}_bf16"]
    d, gap = _l2(got.float().numpy(), want), _gap(ref, f"{block}_{C}")
    assert d <= BLOCK_GAP * gap, (d, gap, d / gap)
    assert _ulps(got.float().numpy(), want) <= BLOCK_ULPS


def _trap_pe(C):
    return _k1(C, pe_round=True)


def _trap_ln1(C):
    """K2 with LN1 taken from the rounded tokens."""
    x, pe_tok, p = _k2_inputs(C)
    wts = spa_block.spa_weights(p, R.SPA_PREFIX)
    tok, _ = spa_block.tokenize_ln_plain(x, pe_tok, wts)
    ln = wts["ln"].float()
    xn = spa_block._ln(tok.float() + pe_tok.float(), ln[0], ln[1]).bfloat16()
    q, k, v = spa_block.qkv_plain(xn, tok, wts)
    x2, xn2 = spa_block.outproj_ln_plain(spa_block.window_attn_plain(q, k, v, H, 5)[0], tok, wts)
    return spa_block.ffn_out_plain(xn2, x2, wts)


def _trap_l(C):
    """K1 with l summed over the rounded exps."""
    d = R.inputs(C)
    wts = ang_block.ang_weights({k: _bf(v) for k, v in d["params"].items()}, R.ANG_PREFIX)
    w = lambda n: bf16_round(wts[n].float())
    ln, x = wts["ln"].float(), torch.from_numpy(d["k1_x"])
    hd = ang_block._heads
    xn = bf16_round(ang_block._ln(x + torch.from_numpy(angular_position(R.K1_SHAPE[1], C)),
                                  ln[0], ln[1]))
    q, k, v = (bf16_round(t @ w(n)) for t, n in ((xn, "wq"), (xn, "wk"), (x, "wv")))
    s = (hd(q, H) @ hd(k, H).transpose(-1, -2)) * float(C // H) ** -0.5
    e = bf16_round(torch.exp(s - s.amax(-1).amax(1, keepdim=True)[..., None]))
    a = bf16_round(ang_block._merge((e @ hd(v, H)) * (1.0 / e.sum(-1))[..., None]))
    x2 = bf16_round(bf16_round(a @ w("wo")) + x)
    hid = bf16_round(torch.relu(bf16_round(ang_block._ln(x2, ln[2], ln[3])) @ w("w1")))
    return bf16_round(bf16_round(hid @ w("w2")) + x2)


@pytest.mark.parametrize("C", R.C_BLOCKS)
@pytest.mark.parametrize("trap,block", [("pe", "k1"), ("ln1", "k2"), ("l", "k1")])
def test_each_rounding_trap_shows(ref, trap, block, C):
    """Removing one of lft_tpu's rounding choices moves the block past the
    bound of test_block_matches_lft_tpu_bf16."""
    got = {"pe": _trap_pe, "ln1": _trap_ln1, "l": _trap_l}[trap](C)
    d = _l2(got.float().numpy(), ref[f"{block}_{C}_bf16"])
    assert d > 2 * BLOCK_GAP * _gap(ref, f"{block}_{C}")


def test_forward_matches_lft_tpu_bf16(ref):
    lr, p = R.fwd_inputs()
    tp = lft.params_from_numpy(p, device="cpu")
    x = torch.from_numpy(lr)
    with torch.no_grad():
        bf = lft.forward(tp, x, Args(dtype="bfloat16", **R.FWD), plain_blocks=True)
        again = lft.forward(tp, x, Args(dtype="bfloat16", **R.FWD))   # fused by default
        f32 = lft.forward(tp, x, Args(**R.FWD), fused=True)
    assert bf.dtype == torch.float32 and bf.shape == (1, 1, 80, 80)
    assert torch.equal(bf, again)
    gap = _l2(ref["fwd_bfloat16"], ref["fwd_float32"])
    own = _l2(bf.numpy(), f32.numpy())
    assert abs(own / gap - 1) <= FWD_GAP_TOL, own / gap
    assert _l2(bf.numpy(), ref["fwd_bfloat16"]) <= FWD_L2 * gap
    assert _l2(f32.numpy(), ref["fwd_float32"]) < 1e-5


def test_bf16_step_wrappers_chain_to_the_block():
    """The five K2 step wrappers on bf16 tensors chained are the bf16 block,
    each step's output bf16."""
    x, pe_tok, p = _k2_inputs(16)
    wts = spa_block.spa_weights(p, R.SPA_PREFIX)
    tok, xn = spa_block.tokenize_ln(x, pe_tok, wts)
    q, k, v = spa_block.qkv(xn, tok, wts)
    attn = spa_block.window_attn(q, k, v, H, 5)
    x2, xn2 = spa_block.outproj_ln(attn, tok, wts)
    out = spa_block.ffn_out(xn2, x2, wts)
    assert all(t.dtype == torch.bfloat16 for t in (tok, xn, q, k, v, attn, x2, xn2, out))
    assert torch.equal(out, spa_block.spa_block_plain(x, pe_tok, wts, H, 5))


def test_bf16_raises_where_nothing_is_ported():
    """Under bfloat16 the unfused branch trains (ROADMAP item 9e): a forward
    under grad with `fused=False`, a train step with `--train_fused false`
    and the data-parallel step build and run, and `--train_fused auto` is
    fused on the card and unfused on the CPU, as lft_tpu's auto; the per-op
    `_res` and backward launches route to their `_bf16io` forms, and so do
    K11's (item 9f). The tile-halo kernel K10 under grad raises ValueError;
    a bf16 tensor at an f32 launcher raises TypeError."""
    args = Args(channels=16, scale_factor=2, dtype="bfloat16")
    p = lft.init_params(0, args, device="cpu")
    x = torch.rand(1, 1, 40, 40, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.isfinite(lft.forward(p, x, args, fused=False)).all()
    for t in p.values():
        t.requires_grad_(True)
    lft.forward(p, x, args, fused=False).float().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.float32 for t in p.values())
    model = lft.LFT_MODEL
    opt = optim.make_optimizer(p, args, 10)
    y = torch.rand(1, 1, 80, 80, generator=torch.Generator().manual_seed(1))
    for step in (trainer.make_train_step(model, opt, Args(channels=16, scale_factor=2,
                                                          dtype="bfloat16", train_fused="false")),
                 trainer.make_train_step(model, opt, args, mesh=pmesh.get_mesh(device="cpu"))):
        assert np.isfinite(float(step(p, x, y)[0]))
    assert not trainer.train_fused(args, torch.device("cpu"))
    assert trainer.train_fused(args, torch.device("cuda"))
    assert trainer.train_fused(Args(dtype="bfloat16", train_fused="true"), torch.device("cpu"))
    trainer.make_train_step(model, opt, args)
    xb = torch.zeros(4, 25, 16, dtype=torch.bfloat16)
    assert common.io_kernel("spa_qkv", xb) == "spa_qkv_bf16io"
    assert common.io_kernel("ang_block_res", xb) == "ang_block_res_bf16io"
    assert common.io_kernel("spa_qkv", xb.float()) == "spa_qkv"
    for kernel in ("ang_attn", "ang_attn_sweep", "spa_attn_hp", "spa_attn_mxu", "spa_attn_offset",
                   "spa_attn_tile", "spa_attn_hp_res", "spa_attn_hp_bwd", "ang_attn_res",
                   "ang_attn_bwd", "ang_attn_sweep_res", "ang_attn_sweep_bwd",
                   "spa_attn_offset_res", "spa_attn_offset_bwd", "spa_attn_mxu_res",
                   "spa_attn_mxu_bwd"):
        assert common.io_kernel(kernel, xb) == kernel + "_bf16io"
    for kernel in ("spa_tokenize_ln_pm", "spa_ffn_out_pm"):
        assert common.io_kernel(kernel, xb) == kernel + "_bf16io"
    qb = torch.zeros(1, 16, 16, 32, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="K10.*forward-only"):
        local_attn.windowed_attention_tile(qb, qb, qb, 8, 5, 8)
    with pytest.raises(TypeError, match="spa_qkv: torch.float32 tensors only"):
        _build.check_cuda_args("spa_qkv", xb)
    with pytest.raises(TypeError, match="bfloat16 tensors only"):
        _build.check_cuda_args("spa_qkv_bf16io", xb.float(), dtype=torch.bfloat16)
    assert parse_args(["--dtype", "bfloat16"]).dtype == "bfloat16"
    check_dtype("bfloat16")
    with pytest.raises(ValueError):
        check_dtype("float16")


def test_test_cli_bf16_on_the_cpu(tmp_path):
    """`python -m lft_torch.test --dtype bfloat16` (its `main` on the CPU) on
    a small synthetic h5 set: PSNR/SSIM logged, beside the float32 run's
    (bf16 SR, not f32: the two differ, by little)."""
    from lft_tpu.data.synth import make_synth_data
    from lft_tpu.utils.checkpoint import save_checkpoint
    paths = make_synth_data(str(tmp_path / "data"), ang_res=5, scale=2, n_train=1, n_test=2,
                            train_patch=16, test_hw=32)
    _, p = R.fwd_inputs()
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, p, epoch=0)
    kw = dict(angRes=5, scale_factor=2, channels=16, eval_batch=4, path_pre_pth=ckpt,
              path_for_test=paths["path_for_test"], num_workers=0)
    res = {}
    for dt in ("bfloat16", "float32"):
        res[dt] = ptest.main(Args(dtype=dt, path_log=str(tmp_path / dt), **kw), device="cpu")
    (pb,), (sb,) = res["bfloat16"]
    (pf,), (sf,) = res["float32"]
    assert np.isfinite(pb) and np.isfinite(sb) and pb != pf
    assert abs(pb - pf) < 0.05 and abs(sb - sf) < 1e-3
    logs = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "bfloat16") for f in fs
            if f.endswith(".txt")]
    with open(logs[0]) as f:
        text = f.read()
    assert "Test on" in text and "Mean over datasets" in text
