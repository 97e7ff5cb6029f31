"""K2.5's site-subset instance redesigned for the tensor cores
(`lft_torch/csrc/ffn_sites.cuh`: `spa_ffn_out_sites_ffn_kernel` where the
`ffn` site rounds and `lin` stays f32, `spa_ffn_out_sites_lin_kernel` where
`ffn` stays f32 and `lin` rounds; launched as K2.5 `spa_ffn_out_sites` and,
its output pixel-major, K11.5 `spa_ffn_out_pm_sites`), on the CPU: its
arithmetic from the wrapper's own weight preparation, its weight layout and
its geometry.

The CUDA kernels cannot run here; their schemes can. `_ffn_out_sites`
repeats them from `rowgemm.ffn_out_sites_stream` (unpacked from its
core-matrix layouts, the `sites_rows` order undone):

* `ffn` rounded (S2, `tok,v,av,lin,ascore,awo,affn` kept f32): xn2 rounded
  to bf16, the hidden layer in 64-column chunks, h = xn2 W1[:, c] and y +=
  bf16(relu(h)) W2[c, :] over bf16 weights, f32 sums over the whole K; y +
  x2 in f32; out = (y + x2) Wlin as three TF32 products (both operands
  split hi + lo, rounded to nearest), in chains of 16 `SITES_CHAIN` of K
  added in f32;
* `lin` rounded (S1, `qk,score,ffn,aqkv,aav,wo` kept f32): h and y += relu(h)
  W2[c, :] as three TF32 products in such chains; y + x2 in f32,
  rounded to bf16; out = bf16(y + x2) bf16(Wlin), f32 sums.

It must match the plain version under the subset (`ffn_out_plain`) within
the card test's bounds (tests/test_torch_cuda.py `_mixed_close`:
L2-relative 1e-3 and 1/10 of the plain mixed-vs-f32 distance), float64 of
the same rounded operands as closely as the plain version does, and, from
lft_tpu's own attention output, lft_tpu's `mm_half` K2 under the subset
(tests/_torch_sites_ref.py) within test_torch_sites.py's bounds. The tensor
cores' own rounding inside an MMA is not modelled: f32 sums here.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lft_torch.kernels import LAUNCHES, common, reset_launches
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_block as sb
from lft_torch.models import lft
from lft_torch.ops.posenc import spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sites_ref as R  # noqa: E402

CSRC = Path(sb.__file__).resolve().parent.parent / "csrc"
MIXED_REL, MIXED_GAP, K2_OUT_GAP = 1e-3, 0.1, 0.2   # test_torch_sites.py
PLANS = {s: common.mm_site_plan(True, frozenset(v.split(","))) for s, v in R.SUBSETS.items()}
FFN = {"s1": False, "s2": True}                     # whether the subset rounds `ffn`


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unpack_bf16(flat, K, N):
    """`rowgemm.bf16_piece`'s layout [K/16, 2, N/8, 8, 8] -> [K, N] (f32)."""
    return flat.reshape(K // 16, 2, N // 8, 8, 8).permute(0, 1, 4, 2, 3).reshape(K, N).float()


def _unpack_tf32(flat, K, N, sites=False):
    """`rowgemm.piece`'s layout [K/8, 2, 2, N/8, 8, 4] -> (hi, lo) [K, N],
    rows back in weight order where `sites` (`rowgemm.sites_piece`)."""
    f = flat.reshape(K // 8, 2, 2, N // 8, 8, 4).permute(1, 0, 2, 5, 3, 4).reshape(2, K, N)
    if sites:
        f = f[:, torch.argsort(torch.tensor(rg.sites_rows(K)))]
    return f[0], f[1]


def _weights(wts, ffn):
    """The kernel's weights from the wrapper's preparation: ffn (W1, W2
    bf16 values; Wlin hi, lo), else (W1 hi, lo and W2 hi, lo, chunk by
    chunk; Wlin bf16 values)."""
    D, C = wts["wlin"].shape
    a, b = rg.ffn_out_sites_stream(wts, ffn)
    if ffn:
        assert a.dtype == torch.bfloat16 and a.numel() == 4 * D * D
        return (_unpack_bf16(a[:2 * D * D], D, 2 * D), _unpack_bf16(a[2 * D * D:], 2 * D, D),
                _unpack_tf32(b, D, C, sites=True))
    assert a.dtype == torch.bfloat16 and a.numel() == D * C
    chunks, off = [], 0
    for _ in range(2 * D // 64):
        w1 = _unpack_tf32(b[off:off + 2 * D * 64], D, 64)
        w2 = _unpack_tf32(b[off + 2 * D * 64:off + 4 * D * 64], 64, D)
        chunks.append((w1, w2))
        off += 4 * D * 64
    assert off == b.numel()
    return chunks, _unpack_bf16(a, D, C)


def _tf32x3(a, hi, lo):
    """a @ (hi + lo) as three TF32 products (a split hi + lo, rounded to
    nearest), in chains of 16 SITES_CHAIN of K added in f32."""
    ah, al = rg.split_tf32_rn(a.contiguous())
    acc = torch.zeros(a.shape[0], hi.shape[1])
    for k in range(0, a.shape[1], 16 * rg.SITES_CHAIN):
        s = slice(k, k + 16 * rg.SITES_CHAIN)
        acc = acc + ((al[:, s] @ hi[s] + ah[:, s] @ lo[s]) + ah[:, s] @ hi[s])
    return acc


def _ffn_out_sites(xn2, x2, wts, ffn):
    """The `_sites` kernel of the case in plain PyTorch (the module
    docstring): [..., D] rows -> [..., C]."""
    D = wts["w1"].shape[0]
    lead = x2.shape[:-1]
    a, r = xn2.reshape(-1, D), x2.reshape(-1, D)
    y = torch.zeros(a.shape[0], D)
    if ffn:
        w1, w2, (lh, ll) = _weights(wts, True)
        ab = common.bf16_round(a)
        for c in range(0, 2 * D, 64):
            hid = common.bf16_round(torch.relu(ab @ w1[:, c:c + 64]))
            y = y + hid @ w2[c:c + 64]
        out = _tf32x3(y + r, lh, ll)
    else:
        chunks, wl = _weights(wts, False)
        for (h1, l1), (h2, l2) in chunks:
            y = y + _tf32x3(torch.relu(_tf32x3(a, h1, l1)), h2, l2)
        out = common.bf16_round(y + r) @ wl
    return out.reshape(*lead, -1)


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(C, seed, shape=(3, 9, 7)):
    rng = np.random.RandomState(seed)
    D = 2 * C
    w = lambda *s: torch.from_numpy((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32))
    wts = dict(w1=w(D, 2 * D), w2=w(2 * D, D), wlin=w(D, C))
    xn2 = torch.from_numpy(rng.randn(*shape, D).astype(np.float32))
    x2 = torch.from_numpy(rng.randn(*shape, D).astype(np.float32))
    return xn2, x2, wts


@pytest.mark.parametrize("s", sorted(R.SUBSETS))
@pytest.mark.parametrize("C", [16, 32, 64])
def test_ffn_sites_scheme_matches_the_plain_version(C, s):
    """The emulated kernel of the subset's case against `ffn_out_plain`
    under it: L2-relative MIXED_REL and MIXED_GAP of the plain
    mixed-vs-f32 distance; against float64 of the same rounded operands as
    close as the plain version, within 2x and 1e-6 relative."""
    xn2, x2, wts = _inputs(C, C + len(s))
    plan = PLANS[s]
    assert common.card_fwd(plan, "spa_ffn_out") == "_sites"
    assert common.site_mask(plan, "spa_ffn_out") == common.SITE_BITS["ffn" if FFN[s] else "lin"]
    got = _ffn_out_sites(xn2, x2, wts, FFN[s])
    ref = sb.ffn_out_plain(xn2, x2, wts, plan)
    gap = _l2(sb.ffn_out_plain(xn2, x2, wts), ref)
    d = _l2(got, ref)
    assert d <= MIXED_REL and d <= MIXED_GAP * gap, (d, gap)
    w64 = {k: v.double() for k, v in wts.items()}
    exact = sb.ffn_out_plain(xn2.double(), x2.double(), w64, plan)
    assert _l2(got, exact) <= 2 * _l2(ref, exact) + 1e-6


@pytest.fixture(scope="module")
def sref(tmp_path_factory):
    """lft_tpu's blocks under S1 and S2 (tests/_torch_sites_ref.py, its
    `blocks_s1` and `blocks_s2` parts, two processes at once)."""
    d = tmp_path_factory.mktemp("ffn_sites")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("LFT_MM_HP_SITES", None)
    env.pop("LFT_MM_HP_BWD_SITES", None)
    script = os.path.join(os.path.dirname(__file__), "_torch_sites_ref.py")
    parts = ("blocks_s1", "blocks_s2")
    procs = {p: subprocess.Popen([sys.executable, script, str(d / f"{p}.npz"), p], env=env)
             for p in parts}
    try:
        for p, proc in procs.items():
            assert proc.wait(timeout=600) == 0, p
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return {p: dict(np.load(d / f"{p}.npz")) for p in parts}


@pytest.mark.parametrize("s", sorted(R.SUBSETS))
@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_emulated_ffn_sites_in_k2_matches_lft_tpu(sref, C, s):
    """K2 under the subset with the emulated step 5, against lft_tpu's
    `_fwd_call(mm_half=True)` (test_torch_sites.py's bounds): from
    lft_tpu's own attention output (the plain step 4, then the emulated
    step 5) within MIXED_GAP of lft_tpu's mixed-vs-f32 distance, and the
    whole plain chain with the emulated step 5 within K2_OUT_GAP."""
    r, r32, plan = sref[f"blocks_{s}"], sref["blocks_s2"], PLANS[s]
    d = R.block_inputs(C)
    p = lft.params_from_numpy(d["params"], device="cpu")
    wts = sb._with_mlp(sb.spa_weights(p, R.SPA_PREFIX))
    h, w = R.K2_SHAPE[1:]
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              wts["mlp"])[0].contiguous()
    x = torch.from_numpy(d["k2_x"])
    tok, xn = sb.tokenize_ln_plain(x, pe_tok, wts, plan)
    want, want32 = r[f"k2_{C}_mixed_out"], r32[f"k2_{C}_f32_out"]
    gap = _l2(want32, want)
    x2, xn2 = sb.outproj_ln_plain(torch.from_numpy(r[f"k2_{C}_mixed_attn"]), tok, wts, plan)
    dist = _l2(_ffn_out_sites(xn2, x2, wts, FFN[s]).numpy(), want)
    assert dist <= MIXED_REL and dist <= MIXED_GAP * gap, (dist, gap)
    q, k, v = sb.qkv_plain(xn, tok, wts, plan)
    x2, xn2 = sb.outproj_ln_plain(sb.window_attn_plain(q, k, v, 8, 5, plan)[0], tok, wts, plan)
    fwd, fwd32 = r[f"k2_{C}_mixed_fwd"], r32[f"k2_{C}_f32_fwd"]
    dist = _l2(_ffn_out_sites(xn2, x2, wts, FFN[s]).numpy(), fwd)
    assert dist <= MIXED_REL and dist <= K2_OUT_GAP * _l2(fwd32, fwd), dist


@pytest.mark.parametrize("ffn", [True, False])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_ffn_sites_weight_layout(C, ffn):
    """`ffn_out_sites_stream` holds each weight where
    `ffn_sites_weights_kernel` writes it (its index formulas repeated
    here: bf16 pieces at (k16, k half, n8, n, k), TF32 pieces at (k8, hi or
    lo, k half, n8, n, k) of the logical row, which is the weight's row
    `sites_rows` names where the product's A comes from an accumulator:
    Wlin's where `ffn` rounds),
    and fills `ffn_out_sites_floats` words, within the scratch the wrapper
    gives it (`ffn_out_floats`)."""
    _, _, wts = _inputs(C, 7 + C, (1, 1, 1))
    D, HC = 2 * C, 64
    a, b = rg.ffn_out_sites_stream(wts, ffn)
    words = (a.numel() // 2 + b.numel()) if ffn else (b.numel() + a.numel() // 2)
    assert words == rg.ffn_out_sites_floats(C, ffn) <= rg.ffn_out_floats(C)
    lrow = lambda r_: 8 * (r_ // 8) + r_ % 8 % 2 * 4 + r_ % 8 // 2
    assert [lrow(k) for k in rg.sites_rows(16)] == list(range(16))

    def bf16_at(off, N, k, n):
        return off + ((k // 16 * 2 + k % 16 // 8) * (N // 8) + n // 8) * 64 + n % 8 * 8 + k % 8

    def tf32_at(off, N, k, n):
        return off + ((k // 8 * 4 + k % 8 // 4) * (N // 8) + n // 8) * 32 + n % 8 * 4 + k % 4

    def check_bf16(flat, off, W):
        K, N = W.shape
        k_, n_ = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
        at = bf16_at(off, N, k_, n_).reshape(-1)
        assert torch.equal(flat[at], W.bfloat16().reshape(-1))

    def check_tf32(flat, off, W, sites):
        K, N = W.shape
        k_, n_ = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
        kl = np.vectorize(lrow)(k_) if sites else k_
        at = tf32_at(off, N, kl, n_).reshape(-1)
        hi, lo = rg.split_tf32_rn(W.contiguous())
        assert torch.equal(flat[at], hi.reshape(-1))
        assert torch.equal(flat[at + 8 * N], lo.reshape(-1))

    if ffn:
        check_bf16(a, 0, wts["w1"])
        check_bf16(a, 2 * D * D, wts["w2"])
        check_tf32(b, 0, wts["wlin"], True)
    else:
        pw1 = pw2 = 2 * D * HC
        for c in range(2 * D // HC):
            check_tf32(b, c * (pw1 + pw2), wts["w1"][:, c * HC:(c + 1) * HC], False)
            check_tf32(b, c * (pw1 + pw2) + pw1, wts["w2"][c * HC:(c + 1) * HC], False)
        check_bf16(a, 0, wts["wlin"])


def test_ffn_sites_geometry_mirrors_the_source():
    """rowgemm.py's sizes of the `_sites` kernels are FfnSites's
    (ffn_sites.cuh), the row order its `ffn_sites_k` and the weight
    kernel's formulas; every width fits a block's shared memory, as the
    source's notes say at C = 64."""
    src = (CSRC / "ffn_sites.cuh").read_text()
    for line in ("HC = 64;", "OFF_W2 = 2 * D * D, LIN = 2 * D * D;",
                 "PW1 = 2 * D * HC, PW2 = 2 * HC * D;", "STREAM = NH * (PW1 + PW2);",
                 "FLOATS = FFN ? LIN + 2 * D * C : STREAM + D * C / 2;",
                 "WBYTES = FFN ? 4 * FLOATS : 2 * D * C;",
                 "ROWS = FFN ? 0 : RG_M * (LDX + LDH) * 4;",
                 "LDX = D + 4, LDH = HC + 4;",
                 "NS = FFN ? 0 : rg_slots(ROWS + WBYTES + 16 * 8);",
                 "BYTES = WBYTES + ROWS + NS * (RG_SF * 4 + 16);",
                 "return 8 * (k / 8) + 2 * (k % 4) + k % 8 / 4;",
                 "(k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 + k % 8",
                 "((k / 8) * 4 + k % 8 / 4) * (N / 8) + n / 8) * 32 +",
                 "if (T < 1 || ffn == lin) return static_cast<int>(cudaErrorInvalidValue);",
                 f"constexpr int FS_CHAIN = {rg.SITES_CHAIN};"):
        assert line in src, line
    for C in (16, 32, 64):
        for ffn in (True, False):
            assert 0 < rg.ffn_out_sites_smem(C, ffn) <= rg.RG_SMEM_MAX
    assert rg.ffn_out_sites_smem(64, True) == 196608 and "196,608" in src
    assert rg.ffn_out_sites_smem(64, False) == 217184 and "217,184" in src
    assert rg.ring_slots(128 * (132 + 68) * 4 + 2 * 128 * 64 + 128) == 6


def test_ffn_sites_launches_only_the_two_cases():
    """`card_fwd` names K2.5's and K11.5's `_sites` instances only where
    exactly one of `ffn` and `lin` rounds (the launcher refuses the other
    masks), and the old run-time-mask instance of the f32 kernel is gone."""
    for ffn_kept in (False, True):
        for lin_kept in (False, True):
            kept = frozenset(n for n, k in (("ffn", ffn_kept), ("lin", lin_kept)) if k)
            plan = common.mm_site_plan(True, kept)
            for kernel in ("spa_ffn_out", "spa_ffn_out_pm"):
                form = common.card_fwd(plan, kernel)
                assert (form == "_sites") == (ffn_kept != lin_kept), (kept, form)
    text = (CSRC / "spa_block.cu").read_text()
    assert "launch_ffn_sites<CC, false>" in text and "launch_ffn_sites<CC, true>" in text
    assert not re.search(r"spa_ffn_out_kernel<[^>]*SITES", text)


@pytest.mark.parametrize("s", sorted(R.SUBSETS))
def test_ffn_sites_wrapper_takes_the_plain_version_on_cpu(s):
    """On CPU tensors under the subset the wrapper is its plain version, bit
    for bit (view-major and pixel-major), and launches nothing."""
    xn2, x2, wts = _inputs(16, 1)
    plan = PLANS[s]
    reset_launches()
    ref = sb.ffn_out_plain(xn2, x2, wts, plan)
    assert torch.equal(sb.ffn_out(xn2, x2, wts, plan=plan), ref)
    assert torch.equal(sb.ffn_out(xn2, x2, wts, 3, plan=plan), sb._to_pixel_major(ref, 3))
    assert sum(LAUNCHES.values()) == 0
