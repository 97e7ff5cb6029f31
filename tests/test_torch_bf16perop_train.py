"""`--dtype bfloat16` training through the unfused per-op branch, in the port
against lft_tpu's, on the CPU.

lft_tpu trains its unfused branch in bfloat16 with its XLA ops on bf16
arrays under autodiff and its per-op Pallas kernels through their custom
VJPs on bf16 tensors. Those kernels' residual forms and backwards round at
two sets of points: rounded operands (K5, K6, K7: ds = bf16(a (dov - D)
scale) and bf16(a) before their products, dq, dk, dv summed in f32 and
rounded once; K6 forms a = e / l where K5 and K7 take e (1 / l)) and f32
inside (K8, K9: nothing rounded but dq, dk, dv, D from the saved bf16
output). The port's plain versions (what the card's `_bf16io` kernels are
held to by chip_smoke.py step 26) round at the same points, in float64
between them. lft_tpu's outputs come from
tests/_torch_bf16perop_train_ref.py, four processes of their own with XLA's
excess precision off (tests/_torch_bf16_ref.py says why).

Comparisons are L2 against lft_tpu's own bf16-vs-f32 distance on the same
inputs, as in tests/test_torch_bf16perop.py:

* each plain `_res` form (out bf16; m, l f32) and each plain backward (dq,
  dk, dv, fed lft_tpu's bf16 residuals) of K5-K9 at C = 16 and 64: within
  GAP (1/10) of that distance and ULPS (1) bf16 ulp of the output's largest
  magnitude (measured: at most 0.04 of the distance and 0.12 ulp). m and l
  are the same f32 arithmetic in lft_tpu's bf16 and f32 runs on bf16-valued
  inputs, so their distance is often 0: they are held within STAT_REL of
  lft_tpu's (f32 sums in another order: measured at most 1.7e-7);
* each rounding the port must keep, removed, moves its backward past that
  bound: K5 with ds left unrounded (1.15 of the distance in dq), K8 and K9
  with D taken from the scores instead of the saved bf16 output (0.97-1.04);
* a `--train_fused false` step of the whole model (C = 16, 4 blocks) under
  the smooth loss, at 5x5 and 12x12 views, `pallas` and `auto`, and the
  `mxu` and `sweep` + `offset` knobs: its gradient's distance from the
  port's f32 step within STEP_GAP_TOL of lft_tpu's bf16-vs-f32 distance,
  the six steps' pooled distance within POOLED_GAP_TOL of lft_tpu's, and
  the gradient within STEP_L2 of that distance from lft_tpu's bf16
  gradient. Once the kernels' roundings decorrelate the two packages'
  steps (L2 0.78-0.98 of the distance; the `auto` steps, on torch ops only,
  0.03-0.06), the ratio of one step's distances is a sample with a spread:
  the same `pallas` step at three seeds gave 0.97, 0.82 and 1.01, the
  `sweep` one 0.91, 0.90 and 0.93 (the ratios of the steps here:
  0.97-1.01, sweep 0.911); the pooled ratio, 0.978, holds the branch to
  10% as the fused step is held (tests/test_torch_bf16train.py). The `auto`
  steps,
  whose roundings stay correlated, are held closer: their gradient within
  AUTO_L2 of the distance from lft_tpu's (measured 0.03 and 0.06, 0.03-0.10
  over three seeds at 5x5; with the `fold` upsampler's weight gradient
  summed once per tap instead of one bf16 addition at a time as lft_tpu's
  scatter adds, 0.69-0.82).
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, ang_attn_mxu, ang_attn_vjp, local_attn_vjp
from lft_torch.kernels import reset_launches, spa_attn, spa_attn_hp, spa_block
from lft_torch.kernels.common import mm_site_plan
from lft_torch.models import lft
from lft_torch.parallel import mesh as pmesh
from lft_torch.registry import get_model
from lft_torch.training import optim, trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16perop_train_ref as R  # noqa: E402
from _torch_bf16train_ref import smooth_loss  # noqa: E402
from test_torch_train import _Patches  # noqa: E402

GAP = 0.1
ULPS = 1.0
STAT_REL = 1e-6
STEP_GAP_TOL = 0.15
POOLED_GAP_TOL = 0.1
STEP_L2 = 1.5
AUTO_L2 = 0.2
H = 8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16perop_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(os.path.dirname(__file__), "_torch_bf16perop_train_ref.py")
    procs = {part: subprocess.Popen([sys.executable, script, str(d / f"{part}.npz"), part],
                                    env=env) for part in R.PARTS}
    try:
        for part, proc in procs.items():
            assert proc.wait(timeout=600) == 0, part
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    out = {}
    for part in R.PARTS:
        out.update(np.load(d / f"{part}.npz"))
    return out


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want|."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _f(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(got, ref, key, stat=False):
    """got within GAP of lft_tpu's bf16-vs-f32 distance of output `key` (a
    bf16 output also within ULPS), or within STAT_REL of it (`stat`)."""
    want, gap = ref[key.format("bf16")], _l2(ref[key.format("bf16")], ref[key.format("f32")])
    d = _l2(got.float().numpy(), want)
    if stat:
        assert got.dtype == torch.float32 and d <= max(GAP * gap, STAT_REL), (key, d, gap)
        return
    assert got.dtype == torch.bfloat16, (key, got.dtype)
    assert d <= GAP * gap, (key, d, gap, d / gap)
    assert _ulps(got.float().numpy(), want) <= ULPS, key


RES_FNS = {
    "k5": lambda q, k, v: spa_attn_hp.spa_attn_hp_fwd(q, k, v, H, 5, with_stats=True),
    "k6": lambda q, k, v: spa_attn.spa_attn_mxu_fwd(q, k, v, H, 5, with_stats=True),
    "k7": lambda q, k, v: ang_attn_mxu.ang_attn_fwd(q, k, v, H, with_stats=True),
    "k8": lambda q, k, v: ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, H, with_stats=True),
    "k9": lambda q, k, v: local_attn_vjp.spa_attn_offset_fwd(q, k, v, H, 5, with_stats=True),
}
BWD_FNS = {
    "k5": lambda q, k, v, o, m, l, g: spa_attn_hp.spa_attn_hp_bwd(q, k, v, m, l, g, H, 5),
    "k6": lambda q, k, v, o, m, l, g: spa_attn.spa_attn_mxu_bwd(q, k, v, m, l, g, H, 5),
    "k7": lambda q, k, v, o, m, l, g: ang_attn_mxu.ang_attn_bwd(q, k, v, m, l, g, H),
    "k8": lambda q, k, v, o, m, l, g: ang_attn_vjp.ang_attn_sweep_bwd(q, k, v, o, m, l, g, H),
    "k9": lambda q, k, v, o, m, l, g: local_attn_vjp.spa_attn_offset_bwd(q, k, v, o, m, l, g,
                                                                         H, 5),
}


@pytest.mark.parametrize("name", list(R.KERNELS))
def test_res_plain_matches_lft_tpu(ref, name):
    """Each per-op kernel's plain `_res` form on bf16 tensors (what its
    wrapper runs on a CPU tensor) against lft_tpu's `_vjp_fwd`, the stats in
    the port's layout; its out is the residual-free bf16 forward's bit for
    bit; no kernel launched."""
    family = R.KERNELS[name][0]
    q, k, v, _ = (_bf(a) for a in R.kernel_inputs(name))
    reset_launches()
    out, m, l = RES_FNS[family](q, k, v)
    assert sum(LAUNCHES.values()) == 0
    assert out.shape == q.shape and m.shape == l.shape == (*q.shape[:-1], H)
    _close(out, ref, f"{name}_{{}}_out")
    _close(m, ref, f"{name}_{{}}_m", stat=True)
    _close(l, ref, f"{name}_{{}}_l", stat=True)
    no_stats = {"k5": lambda: spa_attn_hp.spa_attn_hp_fwd(q, k, v, H, 5),
                "k6": lambda: spa_attn.spa_attn_mxu_fwd(q, k, v, H, 5),
                "k7": lambda: ang_attn_mxu.ang_attn_fwd(q, k, v, H),
                "k8": lambda: ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, H),
                "k9": lambda: local_attn_vjp.spa_attn_offset_fwd(q, k, v, H, 5)}[family]
    assert torch.equal(out, no_stats())


def _residuals(ref, name):
    return (_bf(ref[f"{name}_bf16_out"]), _f(ref[f"{name}_bf16_m"]),
            _f(ref[f"{name}_bf16_l"]))


@pytest.mark.parametrize("name", list(R.KERNELS))
def test_bwd_plain_matches_lft_tpu(ref, name):
    """Each per-op kernel's plain backward on bf16 tensors, fed lft_tpu's
    inputs and bf16 residuals (out, m, l), against lft_tpu's `_vjp_bwd`:
    dq, dk, dv bf16, each within the bounds; no kernel launched."""
    family = R.KERNELS[name][0]
    q, k, v, dout = (_bf(a) for a in R.kernel_inputs(name))
    reset_launches()
    grads = BWD_FNS[family](q, k, v, *_residuals(ref, name), dout)
    assert sum(LAUNCHES.values()) == 0
    for n, g in zip(("dq", "dk", "dv"), grads):
        assert g.shape == q.shape
        _close(g, ref, f"{name}_{{}}_{n}")


def _trap_k5_ds(ref, name):
    """K5's backward with ds left unrounded (its p still rounded for dv)."""
    q, k, v, dout = (_bf(a).double() for a in R.kernel_inputs(name))
    _, m, l = _residuals(ref, name)
    grads = spa_block.window_attn_bwd_plain(q, k, v, None, dout, m.double(), l.double(), H, 5,
                                            mm_site_plan(True, frozenset({"score"})))
    return [g.bfloat16() for g in grads]


def _trap_d_from_scores(ref, name):
    """K8's or K9's backward with D from the scores (the unrounded output)
    in place of lft_tpu's saved bf16 output."""
    q, k, v, dout = (_bf(a).double() for a in R.kernel_inputs(name))
    _, m, l = (t.double() for t in _residuals(ref, name))
    if name.startswith("k9"):
        out = local_attn_vjp.windowed_attention_offset_plain(q, k, v, H, 5)[0]
        grads = local_attn_vjp.windowed_attention_offset_bwd_plain(q, k, v, out, m, l, dout, H, 5)
    else:
        out = ang_attn_vjp.ang_attention_sweep_plain(q, k, v, H)[0]
        grads = ang_attn_vjp.ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, H)
    return [g.bfloat16() for g in grads]


@pytest.mark.parametrize("name,trap", [("k5_16", _trap_k5_ds), ("k5_64", _trap_k5_ds),
                                       ("k8_16", _trap_d_from_scores),
                                       ("k8_144", _trap_d_from_scores),
                                       ("k9_16", _trap_d_from_scores),
                                       ("k9_64", _trap_d_from_scores)])
def test_each_backward_trap_shows(ref, name, trap):
    """Removing one of lft_tpu's backward rounding choices moves dq and dk
    past the bound of the test above: the bound tells them apart (at A2 =
    25 the f32 K8 backward on the card takes D from its scores: the bf16
    one must not)."""
    for n, g in zip(("dq", "dk"), trap(ref, name)):
        want = ref[f"{name}_bf16_{n}"]
        d = _l2(g.float().numpy(), want)
        assert d > GAP * _l2(want, ref[f"{name}_f32_{n}"]), (name, n)


@pytest.mark.parametrize("h,w,E", R.PAIRS)
def test_hybrid_pairs_as_lft_tpu_under_bf16(ref, monkeypatch, h, w, E):
    """Under bf16 and grad `windowed_attention_hybrid` takes K5's pair where
    lft_tpu's `_use_headpacked_pair` does, else K6's, for both directions."""
    took = []
    monkeypatch.setattr(spa_attn, "windowed_attention_headpacked",
                        lambda *a: took.append("k5") or a[0])
    monkeypatch.setattr(spa_attn, "windowed_attention_mxu", lambda *a: took.append("k6") or a[0])
    q = torch.zeros(1, h, w, E, dtype=torch.bfloat16, requires_grad=True)
    spa_attn.windowed_attention_hybrid(q, q, q, H, 5)
    assert took == ["k5" if bool(ref[f"pair_{h}x{w}x{E}"]) else "k6"]


def _step(args, p0, x, y, steps=1):
    """`steps` train steps from p0 (f32 master weights) through
    `make_train_step` under the smooth loss (the second through the first's
    warm Adam); (losses, the first step's gradient as one vector, params
    after, the optimizer)."""
    p = {k_: v_.clone().requires_grad_(True) for k_, v_ in p0.items()}
    model = dataclasses.replace(get_model(args), loss=lambda sr, hr: smooth_loss(sr, hr, torch))
    opt = optim.make_optimizer(p, args, 10)
    fn = trainer.make_train_step(model, opt, args, with_metrics=False)
    losses, g0 = [], None
    for _ in range(steps):
        losses.append(float(fn(p, x, y)[0]))
        if g0 is None:
            g0 = torch.cat([p[k_].grad.reshape(-1) for k_ in sorted(p)])
    return losses, g0, p, opt


@contextlib.contextmanager
def _knobs(spa, ang):
    old = {k_: os.environ.get(k_) for k_ in ("LFT_SPA_VARIANT", "LFT_ANG_VARIANT")}
    for k_, v_ in (("LFT_SPA_VARIANT", spa), ("LFT_ANG_VARIANT", ang)):
        os.environ.pop(k_, None)
        if v_:
            os.environ[k_] = v_
    try:
        yield
    finally:
        for k_, v_ in old.items():
            os.environ.pop(k_, None)
            if v_ is not None:
                os.environ[k_] = v_


def _step_args(name, impl, **kw):
    ang_res, _, C, _, _, _ = R.STEPS[name]
    return Args(angRes=ang_res, scale_factor=2, channels=C, batch_size=1, lr=2e-4, n_steps=15,
                gamma=0.5, epoch=2, train_fused="false", attention_impl=impl, **kw)


STEP_CASES = [(name, impl) for name, (_, _, _, _, _, impls) in R.STEPS.items() for impl in impls]


@pytest.fixture(scope="module")
def distances():
    """Each step's `_step_distances`, computed once a module."""
    return {}


def _step_distances(ref, memo, name, impl):
    """(own, gap, l2): the port's bf16 gradient's distance from its f32
    step's, lft_tpu's bf16-vs-f32 distance and the port's L2 from lft_tpu's
    bf16 gradient; kept in `memo`."""
    if (name, impl) in memo:
        return memo[name, impl]
    _, _, _, spa, ang, _ = R.STEPS[name]
    lr, hr, p_np = R.step_inputs(name)
    x, y = torch.from_numpy(lr), torch.from_numpy(hr)
    p0 = lft.params_from_numpy(p_np, device="cpu")
    with _knobs(spa, ang):
        _, g, _, _ = _step(_step_args(name, impl, dtype="bfloat16"), p0, x, y)
        _, g32, _, _ = _step(_step_args(name, impl), p0, x, y)
    key = f"{name}_{impl}"
    assert _l2(g32.numpy(), ref[f"{key}_float32_grad"]) < 1e-4
    gap = _l2(ref[f"{key}_bfloat16_grad"], ref[f"{key}_float32_grad"])
    memo[name, impl] = (_l2(g.numpy(), g32.numpy()), gap,
                        _l2(g.numpy(), ref[f"{key}_bfloat16_grad"]))
    return memo[name, impl]


@pytest.mark.parametrize("name,impl", STEP_CASES)
def test_unfused_bf16_step_matches_lft_tpu(ref, distances, name, impl):
    """One `--dtype bfloat16 --train_fused false` step of the whole model
    against lft_tpu's unfused bf16 step (the knobs set for both packages):
    the gradient within the bounds above, f32 master weights and gradients,
    and a second step through the warm Adam that repeats bitwise; no kernel
    launched."""
    _, _, _, spa, ang, _ = R.STEPS[name]
    own, gap, d = _step_distances(ref, distances, name, impl)
    assert abs(own / gap - 1) <= STEP_GAP_TOL, (own, gap, own / gap)
    assert d <= (AUTO_L2 if impl == "auto" else STEP_L2) * gap, (d, gap, d / gap)
    lr, hr, p_np = R.step_inputs(name)
    x, y = torch.from_numpy(lr), torch.from_numpy(hr)
    p0 = lft.params_from_numpy(p_np, device="cpu")
    args = _step_args(name, impl, dtype="bfloat16")
    reset_launches()
    with _knobs(spa, ang):
        losses, _, p2, opt = _step(args, p0, x, y, steps=2)
        again, _, p2b, _ = _step(args, p0, x, y, steps=2)
    assert sum(LAUNCHES.values()) == 0
    assert losses == again and all(np.isfinite(losses))
    assert all(torch.equal(p2[k_], p2b[k_]) for k_ in p2)
    assert all(t.dtype == torch.float32 and t.grad.dtype == torch.float32 for t in p2.values())
    assert all(v_.dtype == np.float32 for v_ in opt.state_flat().values() if v_.ndim)


def test_unfused_bf16_steps_pooled_gap(ref, distances):
    """Over the six steps together (each gradient over lft_tpu's bf16-vs-f32
    distance), the port's distance from f32 within POOLED_GAP_TOL of
    lft_tpu's."""
    own2 = gap2 = 0.0
    for name, impl in STEP_CASES:
        own, gap, _ = _step_distances(ref, distances, name, impl)
        own2, gap2 = own2 + (own / gap) ** 2, gap2 + 1.0
    assert abs(np.sqrt(own2 / gap2) - 1) <= POOLED_GAP_TOL, np.sqrt(own2 / gap2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dp_bf16_step_at_world_size_1_equals_make_train_step():
    """The data-parallel bf16 step (`parallel.mesh.make_dp_train_step`) at
    world size 1, without and with a gloo process group of one rank, equals
    `make_train_step(--train_fused false)` bit for bit: losses, gradients and
    params over two Adam steps."""
    lr, hr, p_np = R.step_inputs("s5")
    x, y = torch.from_numpy(lr), torch.from_numpy(hr)
    p0 = lft.params_from_numpy(p_np, device="cpu")
    args = _step_args("s5", "pallas", dtype="bfloat16")

    def run(mesh):
        p = {k_: v_.clone().requires_grad_(True) for k_, v_ in p0.items()}
        opt = optim.make_optimizer(p, args, 10)
        if mesh is None:
            fn = trainer.make_train_step(get_model(args), opt, args, with_metrics=True)
        else:
            fn = pmesh.make_dp_train_step(get_model(args), opt, args, mesh, with_metrics=True)
        outs = [tuple(float(t) for t in fn(p, x, y)) for _ in range(2)]
        return outs, {k_: (v_.detach().clone(), v_.grad.clone()) for k_, v_ in p.items()}

    ref_out, ref_p = run(None)
    assert not dist.is_initialized()
    got = [run(pmesh.get_mesh(device="cpu"))]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = pmesh.get_mesh(device="cpu")
        assert mesh.size == 1 and mesh.group is not None
        got.append(run(mesh))
    finally:
        dist.destroy_process_group()
    for outs, p in got:
        assert outs == ref_out
        assert all(torch.equal(p[k_][0], ref_p[k_][0]) and torch.equal(p[k_][1], ref_p[k_][1])
                   for k_ in ref_p)


def test_train_cli_bf16_unfused_resumes_bitwise(tmp_path):
    """`python -m lft_torch.train --dtype bfloat16 --train_fused false` (its
    `main` on the CPU): an epoch of 2 steps writes an f32 checkpoint with the
    Adam state; a second epoch resumed from it ends on the uninterrupted
    run's parameters and Adam state bit for bit; no kernel launched."""
    from lft_torch import train as ptrain
    data = _Patches(4)
    kw = dict(channels=16, scale_factor=2, batch_size=2, n_steps=1, gamma=0.5, num_workers=0,
              seed=3, dtype="bfloat16", train_fused="false", attention_impl="pallas",
              data_name="Synth")
    ck = "SR_5x5_2x/LFT/Synth/checkpoints/LFT_5x5_2x_epoch_%02d_model.npz"
    reset_launches()
    full, hist = ptrain.main(Args(path_log=str(tmp_path / "a"), epoch=2, **kw), device="cpu",
                             dataset=data)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    ptrain.main(Args(path_log=str(tmp_path / "b"), epoch=1, **kw), device="cpu", dataset=data)
    resumed, _ = ptrain.main(Args(path_log=str(tmp_path / "b"), epoch=2, use_pre_pth=True,
                                  path_pre_pth=str(tmp_path / "b" / (ck % 1)), **kw),
                             device="cpu", dataset=data)
    assert sum(LAUNCHES.values()) == 0
    assert all(torch.equal(full[k_], resumed[k_]) and full[k_].dtype == torch.float32
               for k_ in full)
    za, zb = np.load(tmp_path / "a" / (ck % 2)), np.load(tmp_path / "b" / (ck % 2))
    assert sorted(za.files) == sorted(zb.files)
    for f in za.files:
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
