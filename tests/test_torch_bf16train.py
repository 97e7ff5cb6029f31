"""`--dtype bfloat16` training in the port against lft_tpu's, on the CPU.

lft_tpu trains its fused blocks in bfloat16 through their custom VJPs with
`io` = bf16: K1 and K2 with their residuals, then K4 and K3, every product
over bf16 operands with f32 sums, every intermediate rounded to bf16 where
it is stored or cast, each weight gradient summed in f32 and rounded once.
The port's plain versions round at the same points (kernels/ang_block.py:
`_ang_bwd_bf16io_plain`, spa_block.py's `*_bwd_plain` steps); the card's
`_bf16io` kernels are held to those plain versions by chip_smoke.py and
tests/test_torch_cuda.py. lft_tpu's outputs come from
tests/_torch_bf16train_ref.py, run in a process of its own with XLA's excess
precision off (tests/_torch_bf16_ref.py says why).

Two values that agree to f32 rounding can still round to neighbouring bf16
values, so every comparison is L2 against lft_tpu's own bf16-vs-f32 distance
on the same inputs:

* the residual forms (out, m, l, attn; tok) and each block backward's
  outputs, fed lft_tpu's inputs and bf16 residuals: within GAP (1/10) of
  that distance, output by output;
* the whole model's gradient (C = 16, 2x, 8x8 views, all four AltFilter
  blocks) under a smooth loss: over four blocks the roundings decorrelate
  (a value summed in another order rounds to the neighbouring bf16 value,
  and every product downstream of it moves), so the port's bf16 gradient
  and lft_tpu's lie about as far apart as either lies from f32. What a port
  that skipped roundings changes is its own bf16-vs-f32 distance: it must
  be lft_tpu's within STEP_GAP_TOL, and the gradient within STEP_L2 of
  lft_tpu's distance from lft_tpu's bf16 gradient.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, ang_block, reset_launches, spa_block
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear
from lft_torch.registry import get_model
from lft_torch.training import optim, trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16_ref as R  # noqa: E402
import _torch_bf16train_ref as RT  # noqa: E402
from test_torch_train import _Patches  # noqa: E402

GAP = 0.1
STEP_GAP_TOL = 0.1
STEP_L2 = 1.5
H = 8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bf16train") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__),
                                                 "_torch_bf16train_ref.py"), out],
                   check=True, timeout=600, env=env)
    return dict(np.load(out))


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _close(got, ref, key):
    """got within GAP of lft_tpu's bf16-vs-f32 distance of output `key`."""
    want, gap = ref[key.format("bf16")], _l2(ref[key.format("bf16")], ref[key.format("f32")])
    d = _l2(got.float().numpy(), want)
    assert d <= GAP * gap, (key, d, gap, d / gap)


def _ml(ref, C, dt):
    """lft_tpu's K2 stats [V, 2, tiles, nq, H] -> (m, l), each [V, h, w, H]."""
    V, h, w = RT.K2_SHAPE
    th, tw = (int(t) for t in ref["k2_tile"])
    ml = ref[f"k2_{C}_{dt}_ml"].reshape(V, 2, h // th, w // tw, th, tw, H)
    ml = ml.transpose(0, 1, 2, 4, 3, 5, 6).reshape(V, 2, h, w, H)
    return ml[:, 0], ml[:, 1]


def _k1_inputs(C):
    d = R.inputs(C)
    p = {k: _bf(v) for k, v in d["params"].items()}
    return (_bf(d["k1_x"]), torch.from_numpy(angular_position(RT.K1_SHAPE[1], C)),
            ang_block.ang_weights(p, RT.ANG_PREFIX))


def _k2_inputs(C):
    d = R.inputs(C)
    p = {k: _bf(v) for k, v in d["params"].items()}
    h, w = RT.K2_SHAPE[1:]
    wts = spa_block._with_mlp(spa_block.spa_weights(p, RT.SPA_PREFIX))
    pe_tok = unfold3x3_linear(_bf(spatial_position(h, w, C))[None], wts["mlp"])[0].contiguous()
    return _bf(d["k2_x"]), pe_tok, wts


@pytest.mark.parametrize("C", RT.C_BLOCKS)
def test_k1_res_matches_lft_tpu(ref, C):
    """K1 res in bf16 IO (out, m, l bf16/f32 as lft_tpu's, attn bf16)
    against lft_tpu's `_vjp_fwd`; its out is the residual-free bf16
    forward's bit for bit."""
    x, pe, wts = _k1_inputs(C)
    got = ang_block.ang_block_plain(x, pe, wts, H, with_res=True)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16]
    assert torch.equal(got[0], ang_block.ang_block_plain(x, pe, wts, H))
    for n, t in zip(RT.K1_RES, got):
        _close(t, ref, f"k1_{C}_{{}}_{n}")


@pytest.mark.parametrize("C", RT.C_BLOCKS)
def test_k2_res_matches_lft_tpu(ref, C):
    """K2 res in bf16 IO (out, tok, m, l, attn) against lft_tpu's
    `_spa_vjp_fwd`, its stats taken to the port's [V, h, w, H] layout; out
    is the residual-free bf16 forward's bit for bit."""
    x, pe_tok, wts = _k2_inputs(C)
    assert _l2(pe_tok.float().numpy(), ref[f"k2_{C}_bf16_petok"]) == 0.0
    out, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, with_res=True)
    assert torch.equal(out, spa_block.spa_block_plain(x, pe_tok, wts, H, 5))
    assert tok.dtype == attn.dtype == torch.bfloat16 and m.dtype == l.dtype == torch.float32
    _close(out, ref, f"k2_{C}_{{}}_out")
    _close(tok, ref, f"k2_{C}_{{}}_tok")
    _close(attn, ref, f"k2_{C}_{{}}_attn")
    (mb, lb), (mf, lf) = _ml(ref, C, "bf16"), _ml(ref, C, "f32")
    for got, want, want32 in ((m, mb, mf), (l, lb, lf)):
        d, gap = _l2(got.numpy(), want), _l2(want, want32)
        assert d <= GAP * gap, (d, gap)


@pytest.mark.parametrize("C", RT.C_BLOCKS)
def test_k4_matches_lft_tpu(ref, C):
    """K4's plain bf16-IO backward, fed lft_tpu's inputs and bf16 residuals
    (m, l, attn), each output (dx; the LN affine and weight gradients,
    rounded once to bf16 as `AngBlockFn` returns them) against lft_tpu's
    `_vjp_bwd`."""
    x, pe, wts = _k1_inputs(C)
    m, l, attn = (torch.from_numpy(ref[f"k1_{C}_bf16_{n}"]) for n in ("m", "l", "attn"))
    dout = _bf(RT.couts(C)["k1"])
    got = ang_block.ang_block_bwd_plain(x, pe, wts, m, l, attn.bfloat16(), dout, H)
    assert got[0].dtype == torch.bfloat16
    names = [n for n in RT.K4_GRADS if n != "dpe"]
    for n, t in zip(names, got):
        _close(t.to(torch.bfloat16), ref, f"k4_{C}_{{}}_{n}")
    assert not ref[f"k4_{C}_bf16_dpe"].any()


@pytest.mark.parametrize("C", RT.C_BLOCKS)
def test_k3_matches_lft_tpu(ref, C):
    """K3's plain bf16-IO backward, fed lft_tpu's inputs and bf16 residuals
    (tok, ml, attn), each output (dx, dpe_tok and the weight gradients,
    rounded once to bf16 as `SpaBlockFn` returns them) against lft_tpu's
    `_spa_vjp_bwd`."""
    x, pe_tok, wts = _k2_inputs(C)
    tok, attn = (_bf(ref[f"k2_{C}_bf16_{n}"]) for n in ("tok", "attn"))
    m, l = (torch.from_numpy(np.ascontiguousarray(t)) for t in _ml(ref, C, "bf16"))
    dout = _bf(RT.couts(C)["k2"])
    got = spa_block.spa_block_bwd_plain(x, pe_tok, wts, tok, m, l, attn, dout, H, 5)
    assert got[0].dtype == torch.bfloat16
    for n, t in zip(RT.K3_GRADS, got):
        _close(t.to(torch.bfloat16), ref, f"k3_{C}_{{}}_{n}")


def test_bf16_block_functions_chain_their_steps():
    """The autograd Functions under bf16: K3's five step wrappers (the plain
    versions on CPU tensors) chained into the plain block backward, bit for
    bit; the blocks' gradients of x and of every weight bf16, the weights'
    rounded once from the f32 sums; no kernel launched."""
    x, pe_tok, wts = _k2_inputs(16)
    _, tok, m, l, attn = spa_block.spa_block_plain(x, pe_tok, wts, H, 5, with_res=True)
    dout = _bf(RT.couts(16)["k2"])
    reset_launches()
    chain = spa_block.spa_block_bwd(x, pe_tok, wts, tok, m, l, attn, dout, H, 5)
    plain = spa_block.spa_block_bwd_plain(x, pe_tok, wts, tok, m, l, attn, dout, H, 5)
    assert all(torch.equal(a, b) for a, b in zip(chain, plain))
    dx2, dattn, *_ = spa_block.ffn_out_bwd(attn, tok, dout, wts)
    assert dx2.dtype == torch.float32 and dattn.dtype == torch.bfloat16
    _, q, k, v = spa_block.ln_qkv(tok, pe_tok, wts)
    dq, dk, dv = spa_block.window_attn_bwd(q, k, v, attn, dattn, m, l, H, 5)
    dtok, dtokpe, _ = spa_block.qkv_ln_bwd(tok, pe_tok, dq, dk, dv, dx2, wts)
    assert dtok.dtype == torch.bfloat16 and dtokpe.dtype == torch.float32
    assert torch.equal(spa_block.tokenize_bwd(dtok, wts), chain[0])

    p = {k_: _bf(v_).requires_grad_(True) for k_, v_ in R.inputs(16)["params"].items()}
    xs = x.clone().requires_grad_(True)
    pe = pe_tok.clone().requires_grad_(True)
    spa_block.spa_trans_block_fused(xs, pe, p, RT.SPA_PREFIX, H, 5).float().mul(
        dout.float()).sum().backward()
    xa, pa, wa = _k1_inputs(16)
    xa.requires_grad_(True)
    ang_block.ang_trans_block_fused(xa, pa, p, RT.ANG_PREFIX, H).float().sum().backward()
    assert sum(LAUNCHES.values()) == 0
    assert xs.grad.dtype == pe.grad.dtype == xa.grad.dtype == torch.bfloat16
    assert torch.equal(xs.grad, chain[0]) and torch.equal(pe.grad, chain[1].bfloat16())
    used = [k_ for k_ in p if k_.startswith((RT.SPA_PREFIX, RT.ANG_PREFIX))]
    assert all(p[k_].grad is not None and p[k_].grad.dtype == torch.bfloat16 for k_ in used)


def _step(args, p0, x, y, loss=None, plain=False):
    """One train step from p0 (f32 master weights) through
    `make_train_step`; (loss, gradient as one vector, params after)."""
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    model = get_model(args)
    if loss is not None:
        model = dataclasses.replace(model, loss=loss)
    fn = trainer.make_train_step(model, optim.make_optimizer(p, args, 10), args,
                                 with_metrics=False)
    val = float(fn(p, x, y)[0])
    return val, torch.cat([p[k].grad.reshape(-1) for k in sorted(p)]), p


def test_fused_bf16_train_step_matches_lft_tpu(ref):
    """One `--dtype bfloat16 --train_fused true` Adam step of the whole model (C = 16, 2x, 8x8 views, 4 blocks) under the
    smooth loss: the loss; the gradient as one vector, its distance from the
    port's f32 step's within STEP_GAP_TOL of lft_tpu's own bf16-vs-f32
    distance, and within STEP_L2 of that distance from lft_tpu's bf16
    gradient; the master weights, their gradients and the update f32; the
    step repeats bitwise."""
    lr, hr, p_np = RT.train_inputs()
    x, y = torch.from_numpy(lr), torch.from_numpy(hr)
    p0 = lft.params_from_numpy(p_np, device="cpu")
    kw = dict(R.FWD, batch_size=1, lr=2e-4, n_steps=15, gamma=0.5, epoch=2)
    smooth = lambda sr, hr_: RT.smooth_loss(sr, hr_, torch)
    args = Args(dtype="bfloat16", train_fused="true", **kw)
    reset_launches()
    loss, g, p1 = _step(args, p0, x, y, smooth)
    assert sum(LAUNCHES.values()) == 0
    loss_b, g_b, p1_b = _step(args, p0, x, y, smooth)
    assert loss == loss_b and torch.equal(g, g_b)
    assert all(torch.equal(p1[k], p1_b[k]) for k in p1)
    assert all(t.dtype == torch.float32 and t.grad.dtype == torch.float32 for t in p1.values())
    assert all(torch.isfinite(t).all() and not torch.equal(t, p0[k]) for k, t in p1.items()
               if k in ("upsampling.0.weight", RT.SPA_PREFIX + "MLP.weight"))
    _, g32, _ = _step(Args(train_fused="true", **kw), p0, x, y, smooth)
    assert abs(loss - float(ref["loss_bfloat16"])) <= 1e-3 * abs(float(ref["loss_bfloat16"]))
    gap = _l2(ref["grad_bfloat16"], ref["grad_float32"])
    assert _l2(g32.numpy(), ref["grad_float32"]) < 1e-4
    own = _l2(g.numpy(), g32.numpy())
    assert abs(own / gap - 1) <= STEP_GAP_TOL, (own, gap, own / gap)
    assert _l2(g.numpy(), ref["grad_bfloat16"]) <= STEP_L2 * gap


def _overload(src: str, head: str) -> str:
    """The body of the function in `src` whose declaration starts `head`."""
    i = src.index(head)
    j = src.index("{", i)
    depth, k = 0, j
    while True:
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            return src[j:k + 1]
        k += 1


def test_bf16_row_loaders_commit_their_group():
    """The bf16 rows a warp widens into shared memory (K2.2, K2.4 and K3.b's
    `warp_rows`, K3.d and K4 c's `rows_async`) commit a cp.async group, as
    their f32 forms do: the caller's `cp_async_wait<0>` then also waits for
    the weight copies issued before them, which an uncommitted group leaves
    in flight (wait_group waits only for committed groups: K2.2's bf16-IO
    instance read its weights while they landed, and the bf16 K2 chain
    differed between repeats on the card). Their loads are coherent, not the
    read-only path: K3.b's pass k reads back the xn its pass q wrote."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "lft_torch", "csrc")
    with open(os.path.join(root, "spa_block.cu")) as f:
        spa = f.read()
    with open(os.path.join(root, "rowbwd.cuh")) as f:
        row = f.read()
    for body in (_overload(spa, "__device__ __forceinline__ void warp_rows(float* aw, const bf16*"),
                 _overload(row, "__device__ __forceinline__ void rows_async(float* aw, const bf16*")):
        assert "cp_async_commit();" in body and "ldcs4(" in body and "ldg4(" not in body


def test_train_cli_bf16_resumes_bitwise(tmp_path):
    """`python -m lft_torch.train --dtype bfloat16 --train_fused true` (its
    `main` on the CPU: the fused blocks' plain versions):
    an epoch of 2 steps writes an f32 checkpoint with the Adam state; a
    second epoch resumed from it ends on the uninterrupted run's parameters
    and Adam state bit for bit."""
    from lft_torch import train as ptrain
    data = _Patches(4)
    kw = dict(channels=16, scale_factor=2, batch_size=2, n_steps=1, gamma=0.5, num_workers=0,
              seed=3, dtype="bfloat16", train_fused="true", data_name="Synth")
    ck = "SR_5x5_2x/LFT/Synth/checkpoints/LFT_5x5_2x_epoch_%02d_model.npz"
    full, hist = ptrain.main(Args(path_log=str(tmp_path / "a"), epoch=2, **kw), device="cpu",
                             dataset=data)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    ptrain.main(Args(path_log=str(tmp_path / "b"), epoch=1, **kw), device="cpu", dataset=data)
    z1 = np.load(tmp_path / "b" / (ck % 1))
    assert all(z1[f].dtype == np.float32 for f in z1.files if not f.startswith("__")
               and z1[f].ndim > 0)
    resumed, _ = ptrain.main(Args(path_log=str(tmp_path / "b"), epoch=2, use_pre_pth=True,
                                  path_pre_pth=str(tmp_path / "b" / (ck % 1)), **kw),
                             device="cpu", dataset=data)
    assert all(torch.equal(full[k], resumed[k]) for k in full)
    za, zb = np.load(tmp_path / "a" / (ck % 2)), np.load(tmp_path / "b" / (ck % 2))
    assert sorted(za.files) == sorted(zb.files)
    assert any(f.startswith("__opt__/") for f in za.files)
    for f in za.files:
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
