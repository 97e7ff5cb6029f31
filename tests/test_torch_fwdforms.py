"""The last forward forms of the fused blocks in the port against lft_tpu's,
on the CPU: K11 (`spa_trans_block_fused(pixel_major=True)`) on bf16
tensors and under LFT_MM_HP_SITES=none, and the whole fused forward under
`--dtype mixed` with LFT_MM_HP_SITES=none; then the gates that send these
forms to their kernels on the card (`kernels.common`).

lft_tpu's outputs come from tests/_torch_fwdforms_ref.py, a process of its
own with XLA's excess precision off (tests/_torch_bf16_ref.py says why). The
bounds are those of the blocks' own tests:

* K11 on bf16: L2 within K11_GAP of lft_tpu's bf16-vs-f32 distance, and
  test_torch_bf16.py's BLOCK_ULPS (every element within one bf16 ulp of
  the output's largest magnitude); and the pixel-major form bitwise the
  view-major bf16 block on a permuted copy. K11_GAP is twice that test's
  BLOCK_GAP, the bound its rounding traps must exceed: the plain bf16 K2
  block lies 0.013 / 0.096 of the distance from lft_tpu's at C = 16 / 64 on
  its 3 views, but 0.019-0.047 / 0.12-0.17 on K11's 50 views of 8x8 (four
  seeds): torch's exp and f32 sums flip bf16(e) in ~0.1% of the window
  step's outputs against XLA's, and the steps after it carry the flips
  (with lft_tpu's own window output they stay at 0.03);
* K11 under the plan: test_torch_mixed.py's `_mixed_close` (L2-relative
  1e-3 and 1/10 of lft_tpu's mixed-vs-f32 distance);
* the forward under the plan (2 of the 4 blocks, as test_torch_mixed.py
  runs lft_tpu's): its distance from the port's f32 forward within
  FWD_GAP_TOL of lft_tpu's mixed-vs-f32 distance, and its L2 from lft_tpu's
  mixed forward within FWD_L2 of that distance (measured 0.993 and 0.27).
  Only a product's operands round under `mixed` (the sums and the residual
  stream stay f32), so the two forwards stay closer than two bf16 forwards,
  which decorrelate (test_torch_bf16.py: 1.19 of the distance over four
  blocks); a forward that ran f32 has a ratio of 0.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, common, reset_launches, spa_block
from lft_torch.models import lft

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fwdforms_ref as R  # noqa: E402

K11_GAP = 0.2
BLOCK_ULPS = 1.0
MIXED_REL, MIXED_GAP = 1e-3, 0.1
FWD_GAP_TOL = 0.05
FWD_L2 = 0.5
H = 8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fwdforms") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__),
                                                 "_torch_fwdforms_ref.py"), out],
                   check=True, timeout=600, env=env)
    return dict(np.load(out))


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want|."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _plan_none():
    return common.mm_site_plan(True, frozenset())


def _to_vm(x):
    Bb, h, w, A2, C = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(Bb * A2, h, w, C).contiguous()


def _to_pm(t, A2):
    V, h, w, C = t.shape
    return t.reshape(V // A2, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()


# --------------------------------------------------------- (a) K11 on bf16 ---

@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k11_bf16_matches_lft_tpu(ref, C):
    """The port's K11 on a bf16 pixel-major buffer (its plain versions on
    the CPU) against lft_tpu's in interpret mode: a bf16 pixel-major tensor
    within K11_GAP / BLOCK_ULPS, no launch, and the view-major bf16 block
    on a permuted copy bit for bit."""
    d = R.k11_inputs(C)
    p = {k: _t(v, torch.bfloat16) for k, v in d["params_bf16"].items()}
    x = _t(d["x_bf16"], torch.bfloat16)
    pe_tok = _t(ref[f"k11_{C}_bf16_petok"], torch.bfloat16)
    reset_launches()
    got = spa_block.spa_trans_block_fused(x, pe_tok, p, R.SPA_PREFIX, H, 5, pixel_major=True)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert sum(LAUNCHES.values()) == 0
    want = ref[f"k11_{C}_bf16"]
    d_, gap = _l2(got.float().numpy(), want), _l2(want, ref[f"k11_{C}_f32"])
    assert d_ <= K11_GAP * gap, (d_, gap, d_ / gap)
    assert _ulps(got.float().numpy(), want) <= BLOCK_ULPS
    vm = spa_block.spa_trans_block_fused(_to_vm(x), pe_tok, p, R.SPA_PREFIX, H, 5)
    assert torch.equal(got, _to_pm(vm, x.shape[3]))
    assert torch.equal(got, spa_block.spa_trans_block_plain(x, pe_tok, p, R.SPA_PREFIX, H, 5,
                                                            pixel_major=True))


def test_k11_bf16_steps_keep_the_io_dtype():
    """K11's two steps on bf16 tensors (the wrappers' CPU path): tok and xn
    view-major bf16, the output pixel-major bf16 (as the card's launch
    allocates it), each its view-major step's bit for bit."""
    d = R.k11_inputs(16)
    p = {k: _t(v, torch.bfloat16) for k, v in d["params_bf16"].items()}
    ws = spa_block.spa_weights(p, R.SPA_PREFIX)
    x = _t(d["x_bf16"], torch.bfloat16)
    A2 = x.shape[3]
    pe_tok = torch.randn(8, 8, 32, generator=torch.Generator().manual_seed(0)).bfloat16()
    tok, xn = spa_block.tokenize_ln(x, pe_tok, ws, pixel_major=True)
    assert tok.dtype == xn.dtype == torch.bfloat16 and tok.shape == (2 * A2, 8, 8, 32)
    assert all(torch.equal(a, b) for a, b in zip((tok, xn),
                                                 spa_block.tokenize_ln(_to_vm(x), pe_tok, ws)))
    out = spa_block.ffn_out(xn, tok, ws, views=A2)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.equal(out, _to_pm(spa_block.ffn_out(xn, tok, ws), A2))


# ---------------------------------------------- (b) K11 under the plan none ---

@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k11_mixed_none_matches_lft_tpu(ref, C):
    """The port's K11 under LFT_MM_HP_SITES=none (plain versions, f32
    buffer) against lft_tpu's pixel-major `mm_half` form: L2-relative
    MIXED_REL and MIXED_GAP of lft_tpu's mixed-vs-f32 distance; f32 out."""
    d = R.k11_inputs(C)
    p = {k: _t(v) for k, v in d["params_f32"].items()}
    x, pe_tok = _t(d["x_f32"]), _t(ref[f"k11m_{C}_petok"])
    reset_launches()
    got = spa_block.spa_trans_block_fused(x, pe_tok, p, R.SPA_PREFIX, H, 5, pixel_major=True,
                                          plan=_plan_none())
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert sum(LAUNCHES.values()) == 0
    want = ref[f"k11m_{C}_mixed"]
    d_, gap = _l2(got.numpy(), want), _l2(ref[f"k11m_{C}_f32"], want)
    assert d_ <= MIXED_REL and d_ <= MIXED_GAP * gap, (d_, gap)
    f32 = spa_block.spa_trans_block_fused(x, pe_tok, p, R.SPA_PREFIX, H, 5, pixel_major=True)
    assert _l2(f32.numpy(), ref[f"k11m_{C}_f32"]) < 1e-5


# ------------------------------------------ (c) the forward under the plan ---

def test_forward_mixed_none_matches_lft_tpu(ref, monkeypatch):
    """The port's fused forward under `--dtype mixed` with
    LFT_MM_HP_SITES=none on the CPU (2 of the 4 blocks, as lft_tpu's in
    the reference process): its distance from its f32 forward is lft_tpu's
    mixed-vs-f32 distance within FWD_GAP_TOL, and it lies within FWD_L2 of
    that distance from lft_tpu's mixed SR; the f32 forwards agree."""
    lr, p = R.fwd_inputs()     # all 4 blocks' parameters, as the reference process draws them
    tp = lft.params_from_numpy(p, device="cpu")
    monkeypatch.setattr(lft, "LAYER_NUM", R.FWD_LAYERS)
    monkeypatch.setenv("LFT_MM_HP_SITES", "none")
    x = torch.from_numpy(lr)
    reset_launches()
    with torch.no_grad():
        mixed = lft.forward(tp, x, Args(dtype="mixed", **R.FWD), fused=True)
        f32 = lft.forward(tp, x, Args(**R.FWD), fused=True)
    assert sum(LAUNCHES.values()) == 0 and mixed.dtype == torch.float32
    gap = _l2(ref["fwd_mixed"], ref["fwd_float32"])
    own = _l2(mixed.numpy(), f32.numpy())
    assert gap > 1e-4 and abs(own / gap - 1) <= FWD_GAP_TOL, (own, gap)
    assert _l2(mixed.numpy(), ref["fwd_mixed"]) <= FWD_L2 * gap
    assert _l2(f32.numpy(), ref["fwd_float32"]) < 1e-5


# ------------------------------------------------------------- (d) gates ---

def test_forward_plan_gates():
    """On the card the forward plan `none` takes the `_bf16` instances, their
    `_res` forms included (ROADMAP item 9g), and a site subset takes each
    launch's `_sites` instance where it splits the launch's sites, else its
    `_bf16` or f32 one (ROADMAP item 9h; test_torch_sites.py holds the
    instances), and a backward subset takes each backward launch's `_sites`
    instance likewise (ROADMAP item 9h-b, `card_plan`: every pair of plans
    runs); `all` and no plan take the
    f32 kernels. K11's two launches take bf16 tensors (`_bf16io`); a bf16
    tensor takes no mixed plan."""
    plan = lambda sites: common.mm_site_plan(True, sites)
    half, f32, some = plan(frozenset()), plan(common.MM_HP_ALL), plan(frozenset({"qk", "lin"}))
    assert common.card_fwd(half, "spa_qkv") == "_bf16" and common.card_fwd(f32, "spa_qkv") == ""
    assert common.card_fwd(None, "spa_qkv") == ""
    assert common.card_plan(half, half)["spa_qkv"] == "spa_qkv_bf16"
    assert common.card_plan(half, f32)["ang_block_bwd"] == "ang_block_bwd_dp"
    assert common.card_plan(f32, half)["spa_qkv"] == "spa_qkv"
    assert common.card_plan(some, half)["spa_ffn_out"] == "spa_ffn_out_sites"
    assert common.card_plan(some, f32)["spa_ffn_out_bwd"] == "spa_ffn_out_bwd"
    names = common.card_plan(half, some)   # `lin` and `qk` f32, the rest rounded
    assert names["spa_ffn_out_bwd"] == "spa_ffn_out_bwd_sites"
    assert names["spa_ln_qkv"] == "spa_ln_qkv_sites" and names["spa_qkv"] == "spa_qkv_bf16"
    assert common.card_fwd(some, "spa_qkv") == "_sites" == common.card_fwd(some, "spa_ffn_out")
    assert common.card_fwd(some, "spa_tokenize_ln") == "_bf16"
    x32, xb = torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.bfloat16)
    for k in ("ang_block", "spa_tokenize_ln", "spa_qkv", "spa_window_attn", "spa_outproj_ln",
              "spa_ffn_out", "spa_tokenize_ln_pm", "spa_ffn_out_pm"):
        assert common.fwd_kernel(k, x32, half) == k + "_bf16"
        assert common.fwd_kernel(k, x32, f32) == common.fwd_kernel(k, x32, None) == k
        assert common.fwd_kernel(k, xb, None) == k + "_bf16io"
        with pytest.raises(NotImplementedError, match="a bf16 tensor runs no --dtype mixed plan"):
            common.fwd_kernel(k, xb, half)
    for k in ("spa_tokenize_ln_pm", "spa_ffn_out_pm"):
        assert common.io_kernel(k, xb) == k + "_bf16io" and common.io_kernel(k, x32) == k
    for k in ("ang_block_res", "spa_window_attn_res"):
        assert common.fwd_kernel(k, x32, half) == k + "_bf16"
        assert common.fwd_kernel(k, x32, f32) == k
    with pytest.raises(NotImplementedError, match="colsum: has no bf16-IO form"):
        common.io_kernel("colsum", xb)
    from lft_torch.kernels import MIXED_FWD, TAIL_BF16IO
    assert set(MIXED_FWD) | set(TAIL_BF16IO) <= set(LAUNCHES)
    assert len(MIXED_FWD) == 8 and len(TAIL_BF16IO) == 2


def test_plain_blocks_take_no_plan_on_bf16():
    """The bf16-IO plain versions refuse a mixed plan (the two dtypes
    exclude each other) instead of running one silently."""
    d = R.k11_inputs(16)
    p = {k: _t(v, torch.bfloat16) for k, v in d["params_bf16"].items()}
    ws = spa_block.spa_weights(p, R.SPA_PREFIX)
    x = _to_vm(_t(d["x_bf16"], torch.bfloat16))
    pe_tok = torch.zeros(8, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="spa_tokenize_ln_bf16io: a bf16 tensor"):
        spa_block.tokenize_ln(x, pe_tok, ws, plan=_plan_none())
