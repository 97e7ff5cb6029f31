"""`--dtype bfloat16` through the unfused per-op branch, in the port against
lft_tpu's, on the CPU.

lft_tpu sends a geometry its fused gates refuse (and `fused=False`) to its
unfused branch, which under bfloat16 runs its XLA ops on bf16 arrays and
its per-op Pallas kernels on bf16 tensors. Those kernels round at three sets
of points: deferred (K5, K7: the token's max over every head, bf16(e) into
the product, l from the unrounded e), normalized (K6: per head, p = bf16(e
/ l)) and f32 inside (K8, K9, K10: the output rounded once). The port's
plain versions (the card's `_bf16io` kernels are held to them by
chip_smoke.py step 25) and its torch ops (ops/attention.py, the op-by-op
LayerNorm of models/lft.py) round at the same points. lft_tpu's outputs come
from tests/_torch_bf16perop_ref.py, three processes of their own with XLA's
excess precision off (tests/_torch_bf16_ref.py says why).

As in tests/test_torch_bf16.py the comparisons are L2 against lft_tpu's own
bf16-vs-f32 distance on the same inputs:

* each kernel's plain bf16 version and each op: within GAP (1/10) of that
  distance and ULPS (1) bf16 ulp of the output's largest magnitude
  (measured: 0 for every kernel but K5 at E = 128, 0.004, and the angular
  MHA, 0.006: torch's bf16 products sum in another order than XLA's);
* each rounding the port must keep, removed, moves its function past that
  bound (F.layer_norm for the op-by-op LayerNorm 1.08, torch.softmax for
  the rounded one 0.44, K5's deferred rounding in K6 1.35, p rounded in K9
  1.56 of the distance);
* a whole forward (C = 16, 4 blocks): its own bf16-vs-f32 distance within
  FWD_GAP_TOL (10%) of lft_tpu's, and its L2 from lft_tpu's bf16 SR within
  FWD_L2 (1.5) of that distance (measured 0.986-1.018 and up to 1.23: the
  roundings decorrelate over four blocks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lft_torch import test as ptest
from lft_torch.config import Args
from lft_torch.inference.tiled import make_scene_sr
from lft_torch.kernels import LAUNCHES, ang_attn_mxu, ang_attn_vjp, local_attn, local_attn_vjp
from lft_torch.kernels import reset_launches, spa_attn, spa_attn_hp, spa_block
from lft_torch.kernels.common import attention_route
from lft_torch.models import lft
from lft_torch.ops import attention as att
from lft_torch.ops.metrics import cal_metrics
from lft_torch.ops.unfold import unfold3x3_linear

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16perop_ref as R  # noqa: E402

GAP = 0.1
ULPS = 1.0
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
    d = tmp_path_factory.mktemp("bf16perop")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(os.path.dirname(__file__), "_torch_bf16perop_ref.py")
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
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _gap(ref, key):
    return _l2(ref[f"{key}_bf16"], ref[f"{key}_f32"])


def _np(t) -> np.ndarray:
    return t.float().numpy()


KERNEL_FNS = {
    "k5": lambda q, k, v: spa_attn_hp.spa_attn_hp_fwd(q, k, v, H, 5),
    "k6": lambda q, k, v: spa_attn.spa_attn_mxu_fwd(q, k, v, H, 5),
    "k7": lambda q, k, v: ang_attn_mxu.ang_attn_fwd(q, k, v, H),
    "k8": lambda q, k, v: ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, H),
    "k9": lambda q, k, v: local_attn_vjp.spa_attn_offset_fwd(q, k, v, H, 5),
    "k10": lambda q, k, v: local_attn.windowed_attention_tile(q, k, v, H, 5, 8),
}


@pytest.mark.parametrize("name", list(R.KERNELS))
def test_kernel_plain_matches_lft_tpu_bf16(ref, name):
    """Each per-op kernel's plain bf16 version (what its wrapper runs on a
    CPU tensor) against lft_tpu's interpret-mode kernel on bf16 tensors;
    K5's is K2.3's bf16 window step (the fused block's), which lft_tpu's K5
    computes too."""
    q, k, v = (_bf(a) for a in R.kernel_inputs(name))
    reset_launches()
    got = KERNEL_FNS[name.split("_")[0]](q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert sum(LAUNCHES.values()) == 0
    want, gap = ref[f"{name}_bf16"], _gap(ref, name)
    d = _l2(_np(got), want)
    assert d <= GAP * gap, (d, gap, d / gap)
    assert _ulps(_np(got), want) <= ULPS
    if name.startswith("k5"):
        assert torch.equal(got, spa_block.window_attn(q, k, v, H, 5))


def _op_inputs():
    return {key: _bf(a) for key, a in R.op_inputs().items()}


def _op(op: str, d: dict):
    if op == "ln":
        return lft._layer_norm(d["ln_x"], d["ln_w"], d["ln_b"])
    if op == "mha":
        return att.multi_head_attention(d["mha_qn"], d["mha_qn"], d["mha_v"], d["mha_win"],
                                        d["mha_wout"], H)
    if op in ("tiled", "dense"):
        return att.local_attention(d[f"{op}_qn"], d[f"{op}_v"], d["win_in"], d["win_out"], H, 5,
                                   impl=op)
    return unfold3x3_linear(d["unfold_x"], d["unfold_w"])


@pytest.mark.parametrize("op", ["ln", "mha", "tiled", "dense", "unfold"])
def test_op_matches_lft_tpu_bf16(ref, op):
    """The unfused branch's torch ops on bf16 tensors against lft_tpu's XLA
    ops on bf16 arrays, output dtype included (the tiled window attention's
    f32 mask promotes it to f32, as jnp does)."""
    got = _op(op, _op_inputs())
    assert str(got.dtype).replace("torch.", "") == str(ref[f"{op}_bf16_dtype"])
    want, gap = ref[f"{op}_bf16"], _gap(ref, op)
    d = _l2(_np(got), want)
    assert d <= GAP * gap, (d, gap, d / gap)
    assert _ulps(_np(got), want) <= ULPS


def _trap_ln():
    """LayerNorm rounded once (torch's) in place of lft_tpu's op by op."""
    d = _op_inputs()
    return F.layer_norm(d["ln_x"], (d["ln_x"].shape[-1],), d["ln_w"], d["ln_b"], lft.LN_EPS)


def _trap_softmax(monkeypatch):
    """The angular MHA with torch's softmax (rounded once) in place of
    jax.nn.softmax's rounded steps."""
    monkeypatch.setattr(att, "softmax", lambda x: torch.softmax(x, dim=-1))
    return _op("mha", _op_inputs())


def _trap_k6():
    """K6 with K5's deferred rounding (bf16(e) into the product, one max
    over every head) in place of its per-head p = bf16(e / l)."""
    return spa_attn_hp.spa_attn_hp_fwd(*(_bf(a) for a in R.kernel_inputs("k6")), H, 5)


def _trap_k9():
    """K9 with p rounded to bf16 before the product, where lft_tpu's K9
    keeps its softmax f32 inside."""
    q, k, v = (_bf(a).float() for a in R.kernel_inputs("k9"))
    B, h, w, E = q.shape
    p, _, _, _ = spa_attn_hp._window_probs(q, k, H, 5)
    vw = spa_attn_hp._gather_window(v, 5).reshape(B, h, w, -1, H, E // H)
    return torch.einsum("byxjh,byxjhd->byxhd", p.bfloat16().float(), vw).reshape(B, h, w, E)


@pytest.mark.parametrize("trap,key", [("ln", "ln"), ("softmax", "mha"), ("k6", "k6"),
                                      ("k9", "k9")])
def test_each_rounding_trap_shows(ref, monkeypatch, trap, key):
    """Removing one of lft_tpu's rounding choices moves the function past
    the bound of the tests above: the bound tells the choices apart."""
    got = {"ln": _trap_ln, "softmax": lambda: _trap_softmax(monkeypatch), "k6": _trap_k6,
           "k9": _trap_k9}[trap]()
    d = _l2(_np(got), ref[f"{key}_bf16"])
    assert d > GAP * _gap(ref, key), d / _gap(ref, key)


FWD_CASES = [(name, impl) for name, (_, _, _, _, impls) in R.FORWARDS.items() for impl in impls]


@pytest.mark.parametrize("name,impl", FWD_CASES)
def test_forward_matches_lft_tpu_bf16(ref, monkeypatch, name, impl):
    """A whole bf16 forward through the unfused branch (`fused=False`; at
    angRes 12 the fused gates refuse A2 = 144 anyway) with the per-op
    kernels' plain versions (`pallas`) or the torch ops (`auto` on the CPU),
    the variant knob set for both packages, against lft_tpu's."""
    ang_res, _, C, variant, _ = R.FORWARDS[name]
    if variant:
        monkeypatch.setenv("LFT_SPA_VARIANT", variant)
    lr, p = R.fwd_inputs(name)
    tp = lft.params_from_numpy(p, device="cpu")
    x = torch.from_numpy(lr)
    kw = dict(angRes=ang_res, scale_factor=2, channels=C)
    reset_launches()
    with torch.no_grad():
        bf = lft.forward(tp, x, Args(dtype="bfloat16", **kw), fused=False, attention_impl=impl)
        f32 = lft.forward(tp, x, Args(**kw), fused=False, attention_impl=impl)
    assert sum(LAUNCHES.values()) == 0
    assert bf.dtype == torch.float32 and bf.shape == f32.shape
    key = f"{name}_{impl}"
    gap = _l2(ref[f"{key}_bfloat16"], ref[f"{key}_float32"])
    own = _l2(bf.numpy(), f32.numpy())
    assert abs(own / gap - 1) <= FWD_GAP_TOL, own / gap
    assert _l2(bf.numpy(), ref[f"{key}_bfloat16"]) <= FWD_L2 * gap
    assert _l2(f32.numpy(), ref[f"{key}_float32"]) < 1e-5


def test_bf16_unfused_branch_is_chosen_where_lft_tpu_chooses_it():
    """`resolve_bf16`: the fused branch where the gates pass (`fused=None`
    and True), the unfused one for `fused=False`, angRes >= 12 and, on the
    card, a width the kernels do not take (whose attention then takes the
    plain torch ops); a default CPU forward at angRes 12 computes the
    unfused branch, and under grad trains it (ROADMAP 9e): the same f32
    output, a gradient for every parameter."""
    assert lft.resolve_bf16(None, 8, 8, 16, 25, "cpu") and lft.resolve_bf16(True, 8, 8, 64, 25,
                                                                             "cuda")
    assert lft.resolve_bf16(None, 8, 8, 48, 25, "cpu")
    assert not lft.resolve_bf16(False, 8, 8, 16, 25, "cpu")
    assert not lft.resolve_bf16(None, 8, 8, 16, 144, "cpu")
    assert not lft.resolve_bf16(None, 8, 8, 48, 25, "cuda")
    assert attention_route("auto", "cuda", 48) == "auto"
    args = Args(channels=16, scale_factor=2, dtype="bfloat16", angRes=12)
    p = lft.init_params(0, args, device="cpu")
    x = torch.rand(1, 1, 48, 48, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = lft.forward(p, x, args)
        b = lft.forward(p, x, args, fused=False)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    for t in p.values():
        t.requires_grad_(True)
    c = lft.forward(p, x, args)
    assert torch.equal(c.detach(), a)
    c.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in p.values())


def test_test_cli_bf16_on_an_unfused_geometry(tmp_path):
    """`python -m lft_torch.test --dtype bfloat16` (its `main` on the CPU) at
    angRes 12, which the fused gates refuse: it logs the PSNR/SSIM that
    `make_scene_sr` gives on the same scenes."""
    from lft_tpu.data.synth import make_synth_data
    from lft_tpu.utils.checkpoint import save_checkpoint
    from lft_torch.data.datasets import TestDataset
    paths = make_synth_data(str(tmp_path / "data"), ang_res=12, scale=2, n_train=1, n_test=2,
                            train_patch=8, test_hw=8)
    p = R.np_params(16, 2, 3)
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, p, epoch=0)
    args = Args(angRes=12, scale_factor=2, channels=16, eval_batch=4, path_pre_pth=ckpt,
                path_for_test=paths["path_for_test"], num_workers=0, dtype="bfloat16",
                patch_size_for_test=8, stride_for_test=4, path_log=str(tmp_path / "log"))
    (psnr,), (ssim,) = ptest.main(args, device="cpu")
    tp = lft.params_from_numpy(p, device="cpu")
    data = TestDataset(args, "SynthLF")
    ps, ss = [], []
    for i in range(len(data)):
        lr, hr = data[i]
        sr = make_scene_sr(lft.forward, args, lr.shape[0] // 12, lr.shape[1] // 12)(
            tp, torch.from_numpy(lr))
        pi, si = cal_metrics(torch.from_numpy(hr), sr, 12)
        ps.append(float(pi))
        ss.append(float(si))
    assert np.isfinite(psnr) and (psnr, ssim) == (float(np.mean(ps)), float(np.mean(ss)))
    logs = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "log") for f in fs
            if f.endswith(".txt")]
    with open(logs[0]) as f:
        text = f.read()
    assert "Test on" in text and "Mean over datasets" in text
