"""K2.1's and K11.1's bf16 forms on bf16 tensor-core products (`lft_torch/
csrc/tok_bf16.cuh`: `tok_bf16_kernel`, launched as `spa_tokenize_ln_bf16io`,
`spa_tokenize_ln_pm_bf16io`, `spa_tokenize_ln_bf16` and
`spa_tokenize_ln_pm_bf16`), on the CPU: their arithmetic, their weight
layout and their geometry.

The CUDA kernel cannot run here; its scheme can. `_tok_bf16` repeats it from
the wrapper's own weight preparation (`spa_block.tap_weights_bf16`, unpacked
from its core-matrix layout) and tiles (`spa_block.tok_bf16_tile`): each
tile's band of (r + 2) x (cw + 2) pixels gathered as the kernel stages it
(bf16 values, zero outside the image, the pixel-major rows of K11 through
`pm_row`), the 128 rows of a tile reading the band at their token's pixel
plus the tap's offset (a row past the tile at pixel (1, 1)), the taps'
bf16 products summed in f32 in tap order (one chain over the whole K in the
kernel's accumulators); tok = the sums, xn = LN1(sums + pe_tok), both in the
IO type. It must
match the plain versions (`tokenize_ln_plain` on bf16 and under the plan
`none`) within the bounds the card holds the kernels to (chip_smoke.py's
BF16_GAP and BF16_ULPS; MIXED_REL and MIXED_GAP), float64 as closely, and,
in K2's and K11's chains, lft_tpu's bf16 blocks (`tests/_torch_bf16_ref.py
k2`) and its pixel-major blocks under `none` and on bf16
(`tests/_torch_fwdforms_ref.py k11`) within test_torch_bf16.py's and
test_torch_fwdforms.py's bounds. The tensor cores' own rounding inside an
MMA is not modelled: f32 sums here.
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
from lft_torch.ops.posenc import spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16_ref as RB  # noqa: E402
import _torch_fwdforms_ref as RF  # noqa: E402

CSRC = Path(sb.__file__).resolve().parent.parent / "csrc"
GAP, ULPS = 0.1, 1.0                     # chip_smoke.py: BF16_GAP, BF16_ULPS
MIXED_REL, MIXED_GAP = 1e-3, 0.1
K11_GAP = 0.2                            # test_torch_fwdforms.py
NONE = common.mm_site_plan(True, frozenset())   # LFT_MM_HP_SITES=none
VIEWS = ((32, 32), (30, 30), (64, 64), (8, 8), (17, 23), (3, 5), (128, 1), (1, 128))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _taps(wu):
    """[9, C, D] bf16 values (f32) from `tap_weights_bf16`, unpacked from
    `rowgemm.bf16_piece`'s layout."""
    _, C, D = wu.shape
    f = sb.tap_weights_bf16(wu)
    assert f.dtype == torch.bfloat16 and f.numel() == 2 * sb.tok_bf16_floats(C) == 9 * C * D
    return f.reshape(9, C // 16, 2, D // 8, 8, 8).permute(0, 1, 2, 5, 3, 4).reshape(
        9, C, D).float()


def _pm_row(t, hw, A2):
    """spa.cuh's pm_row: view-major token t -> its pixel-major row (the
    kernel's `source` forms it from the token's view and pixel)."""
    view = t // hw
    return ((view // A2) * hw + t % hw) * A2 + view % A2


def _tiles(V, h, w, r, cw):
    """Each tile of the kernel's walk: (view, y0, x0)."""
    txs, per_view = -(-w // cw), -(-h // r) * -(-w // cw)
    return [(t // per_view, (t % per_view) // txs * r, (t % per_view) % txs * cw)
            for t in range(V * per_view)]


def _tok_bf16(x, pe_tok, wts, A2=None):
    """The kernel in its arithmetic (the module docstring): x [V, h, w, C]
    or, with A2, pixel-major [V / A2, h, w, A2, C] -> (tok, xn) [V, h, w,
    D] in x's dtype."""
    io = x.dtype
    if A2 is None:
        V, h, w, C = x.shape
    else:
        Bb, h, w, A2_, C = x.shape
        V = Bb * A2_
    D, hw = 2 * C, h * w
    W = _taps(wts["wu"])
    ln = wts["ln"].float()
    rows = common.bf16_round(x.float()).reshape(-1, C)
    r, cw = sb.tok_bf16_tile(h, w, C)
    bw, ntok = cw + 2, r * cw
    tok, xn = torch.zeros(V * hw, D), torch.zeros(V * hw, D)
    m = torch.arange(rg.RG_M)
    pix = torch.where(m < ntok, (m // cw + 1) * bw + m % cw + 1, bw + 1)
    pe = pe_tok.float().reshape(hw, D)
    for view, y0, x0 in _tiles(V, h, w, r, cw):
        p = torch.arange((r + 2) * bw)
        y, xx = y0 - 1 + p // bw, x0 - 1 + p % bw
        inside = (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
        src = view * hw + y.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        if A2 is not None:
            src = _pm_row(src, hw, A2)
        band = torch.where(inside[:, None], rows[src], 0.0)
        acc = torch.zeros(rg.RG_M, D)
        for tap in range(9):
            acc = acc + band[pix + (tap // 3 - 1) * bw + (tap % 3 - 1)] @ W[tap]
        ty, tx = y0 + m // cw, x0 + m % cw
        ok = (m < ntok) & (ty < h) & (tx < w)
        t = (view * hw + ty * w + tx)[ok]
        tok[t] = acc[ok]
        xn[t] = torch.nn.functional.layer_norm(acc[ok] + pe[t % hw], (D,), ln[0], ln[1], 1e-5)
    return tok.reshape(V, h, w, D).to(io), xn.reshape(V, h, w, D).to(io)


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want) -> float:
    want = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


def _inputs(C, V, h, w, seed):
    """x [V, h, w, C], pe_tok [h, w, 2C] and the step's weights (wu, mlp, ln),
    f32 values that are not bf16 values."""
    g = torch.Generator().manual_seed(seed)
    D = 2 * C
    wu = torch.randn(9, C, D, generator=g) / (3 * C ** 0.5)
    ln = torch.stack([1 + 0.2 * torch.randn(D, generator=g), 0.2 * torch.randn(D, generator=g)])
    wts = sb._with_mlp({"wu": wu, "ln": ln})
    return torch.randn(V, h, w, C, generator=g), torch.randn(h, w, D, generator=g), wts


@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (30, 30)])
@pytest.mark.parametrize("C", [16, 32])
def test_tok_bf16_scheme_matches_the_plain_versions(C, hw):
    """bf16 IO: the emulated kernel against `tokenize_ln_plain` on bf16, tok
    and xn within GAP of the plain bf16-vs-f32 distance and ULPS bf16 ulps;
    f32 IO against the plain version under `none`, within MIXED_REL and
    MIXED_GAP of its mixed-vs-f32 distance; each as close to float64 (the
    same rounded operands) as the plain version, within a hundredth of that
    distance."""
    x, pe, wts = _inputs(C, 3, *hw, 10 * C + hw[0])
    xb, peb = x.bfloat16(), pe.bfloat16()
    wb = {k: v.bfloat16() for k, v in wts.items()}
    w32 = {k: v.float() for k, v in wb.items()}
    got = _tok_bf16(xb, peb, wb)
    ref = sb.tokenize_ln_plain(xb, peb, wb)
    ref32 = sb.tokenize_ln_plain(xb.float(), peb.float(), w32)
    for g_, r_, r32 in zip(got, ref, ref32):
        assert g_.dtype == torch.bfloat16 and g_.shape == r_.shape
        d, gap = _l2(g_.float(), r_.float()), _l2(r32, r_.float())
        assert d <= GAP * gap, (d, gap)
        assert _ulps(g_.float(), r_.float()) <= ULPS
    got = _tok_bf16(x, pe, wts)
    ref = sb.tokenize_ln_plain(x, pe, wts, plan=NONE)
    ref32 = sb.tokenize_ln_plain(x, pe, wts)
    B = lambda t: common.bf16_round(t).double()
    exact_tok = unfold3x3_linear(B(x), B(wts["mlp"]))
    exact = (exact_tok, torch.nn.functional.layer_norm(exact_tok + pe.double(), (2 * C,),
                                                       wts["ln"][0].double(),
                                                       wts["ln"][1].double(), 1e-5))
    for g_, r_, r32, e_ in zip(got, ref, ref32, exact):
        d, gap = _l2(g_, r_), _l2(r32, r_)
        assert g_.dtype == torch.float32 and d <= MIXED_REL and d <= MIXED_GAP * gap, (d, gap)
        assert _l2(g_, e_) <= _l2(r_, e_) + 0.01 * gap


@pytest.mark.parametrize("A2", [2, 5])
def test_tok_bf16_pixel_major_is_the_view_major_arithmetic(A2):
    """K11.1's forms: the emulated kernel on a pixel-major buffer gives the
    view-major one's outputs on the permuted copy bit for bit (only the
    band's row addressing differs), in both IO types."""
    C, h, w = 16, 7, 9
    x, pe, wts = _inputs(C, 2 * A2, h, w, A2)
    pm = x.reshape(2, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        vm = _tok_bf16(x.to(dt), pe.to(dt), wts)
        got = _tok_bf16(pm.to(dt), pe.to(dt), wts, A2=A2)
        assert all(torch.equal(a, b) for a, b in zip(got, vm))


@pytest.fixture(scope="module")
def tokref(tmp_path_factory):
    """lft_tpu's bf16 K2 blocks (tests/_torch_bf16_ref.py k2) and its K11
    blocks on bf16 and under `none` (tests/_torch_fwdforms_ref.py k11), two
    processes at once."""
    d = tmp_path_factory.mktemp("tok_bf16")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    here = os.path.dirname(__file__)
    procs = {n: subprocess.Popen([sys.executable, os.path.join(here, s), str(d / f"{n}.npz"),
                                  part], env=env)
             for n, s, part in (("k2", "_torch_bf16_ref.py", "k2"),
                                ("k11", "_torch_fwdforms_ref.py", "k11"))}
    try:
        for n, proc in procs.items():
            assert proc.wait(timeout=600) == 0, n
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return {n: dict(np.load(d / f"{n}.npz")) for n in procs}


def _emulated_step1(monkeypatch, calls):
    def tokenize_ln(x, pe_tok, wts, pixel_major=False, plan=None):
        calls.append(x.dtype)
        assert x.dtype == torch.bfloat16 or common.rounds(plan, "tok")
        return _tok_bf16(x, pe_tok, wts, A2=x.shape[3] if pixel_major else None)
    monkeypatch.setattr(sb, "tokenize_ln", tokenize_ln)


@pytest.mark.parametrize("C", RB.C_BLOCKS)
def test_k2_chain_with_emulated_step1_matches_lft_tpu(tokref, monkeypatch, C):
    """K2's plain bf16 steps 2-5 behind the emulated step 1, on
    test_torch_bf16.py's K2 inputs, against lft_tpu's bf16 block: within 1/10
    of lft_tpu's bf16-vs-f32 distance and 1 bf16 ulp (test_torch_bf16.py:
    BLOCK_GAP, BLOCK_ULPS)."""
    d = RB.inputs(C)
    p = {k: torch.from_numpy(np.ascontiguousarray(v)).bfloat16() for k, v in d["params"].items()}
    hh, ww = RB.K2_SHAPE[1:]
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(hh, ww, C)).bfloat16()[None],
                              p[RB.SPA_PREFIX + "MLP.weight"])[0].contiguous()
    x = torch.from_numpy(np.ascontiguousarray(d["k2_x"])).bfloat16()
    calls = []
    _emulated_step1(monkeypatch, calls)
    reset_launches()
    got = sb.spa_trans_block_fused(x, pe_tok, p, RB.SPA_PREFIX, 8, 5)
    assert calls and sum(LAUNCHES.values()) == 0
    r = tokref["k2"]
    want, gap = r[f"k2_{C}_bf16"], _l2(r[f"k2_{C}_bf16"], r[f"k2_{C}_f32"])
    assert _l2(got.float().numpy(), want) <= GAP * gap, (_l2(got.float().numpy(), want), gap)
    assert _ulps(got.float().numpy(), want) <= ULPS


@pytest.mark.parametrize("C", RF.C_BLOCKS)
def test_k11_chains_with_emulated_step1_match_lft_tpu(tokref, monkeypatch, C):
    """K11 (pixel-major) with the emulated step 1: on bf16 against lft_tpu's
    bf16 K11 within test_torch_fwdforms.py's K11_GAP and 1 bf16 ulp; under
    `none` on f32 against lft_tpu's `mm_half` K11 within MIXED_REL and
    MIXED_GAP of its mixed-vs-f32 distance."""
    d = RF.k11_inputs(C)
    r = tokref["k11"]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    calls = []
    _emulated_step1(monkeypatch, calls)
    p = {k: t(v, torch.bfloat16) for k, v in d["params_bf16"].items()}
    got = sb.spa_trans_block_fused(t(d["x_bf16"], torch.bfloat16),
                                   t(r[f"k11_{C}_bf16_petok"], torch.bfloat16), p,
                                   RF.SPA_PREFIX, 8, 5, pixel_major=True)
    want = r[f"k11_{C}_bf16"]
    dist, gap = _l2(got.float().numpy(), want), _l2(want, r[f"k11_{C}_f32"])
    assert dist <= K11_GAP * gap, (dist, gap)
    assert _ulps(got.float().numpy(), want) <= ULPS
    p = {k: t(v) for k, v in d["params_f32"].items()}
    got = sb.spa_trans_block_fused(t(d["x_f32"]), t(r[f"k11m_{C}_petok"]), p, RF.SPA_PREFIX, 8,
                                   5, pixel_major=True, plan=NONE)
    want = r[f"k11m_{C}_mixed"]
    dist, gap = _l2(got.numpy(), want), _l2(r[f"k11m_{C}_f32"], want)
    assert dist <= MIXED_REL and dist <= MIXED_GAP * gap, (dist, gap)
    assert calls == [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("C", [16, 32, 64])
def test_tap_weights_bf16_layout(C):
    """`tap_weights_bf16` holds each tap of wu rounded to bf16 at (tap, kk,
    kh, j, n, t) = wu[tap][16 kk + 8 kh + t][8 j + n], as
    `tok_bf16_weights_kernel` writes it (its index formula, repeated here)."""
    D = 2 * C
    wu = torch.randn(9, C, D, generator=torch.Generator().manual_seed(C))
    f = sb.tap_weights_bf16(wu)
    src = (CSRC / "tok_bf16.cuh").read_text()
    assert ("wb[tap * C * D + ((k / 16 * 2 + k % 16 / 8) * (D / 8) + n / 8) * 64 + n % 8 * 8 + "
            "k % 8] =") in src
    tap, k, n = np.meshgrid(np.arange(9), np.arange(C), np.arange(D), indexing="ij")
    at = tap * C * D + ((k // 16 * 2 + k % 16 // 8) * (D // 8) + n // 8) * 64 + n % 8 * 8 + k % 8
    assert torch.equal(f[at.reshape(-1)], wu.bfloat16().reshape(-1))
    assert sb.tok_bf16_floats(C) * 2 == f.numel() <= 2 * 18 * C * D


def test_tok_bf16_geometry_mirrors_the_source():
    """`tok_bf16_smem` is TokBf16::bytes (tok_bf16.cuh), the tile function's
    limits are the launch's, and the source's shared-memory example holds."""
    src = (CSRC / "tok_bf16.cuh").read_text()
    for line in ("LDB = C + 8;", "KS = C / 16;", "ELEMS = 9 * C * D;", "WBYTES = 2 * ELEMS;",
                 "return (r + 2) * (cw + 2) * LDB * 2;",
                 "return WBYTES + 2 * band_bytes(r, cw);",
                 "r * cw > RG_M ||\n      G::bytes(r, cw) > RG_SMEM_MAX)"):
        assert line in src, line
    assert sb.TOK_SMEM_MAX == rg.RG_SMEM_MAX
    assert "C = 64 with 8 x 16 tiles: 147,456 + 2 x 25,920 = 199,296 bytes" in src
    assert sb.tok_bf16_tile(32, 32, 64) == (8, 16) and sb.tok_bf16_smem(8, 16, 64) == 199296
    for C in (16, 32, 64):
        for h, w in VIEWS:
            r, cw = sb.tok_bf16_tile(h, w, C)
            assert r * cw <= rg.RG_M and r <= h and cw <= w
            assert sb.tok_bf16_smem(r, cw, C) <= rg.RG_SMEM_MAX


@pytest.mark.parametrize("hw", VIEWS)
def test_tok_bf16_tiles_cover_every_token_once(hw):
    """At every C, the tiles of the kernel's walk (decoded as the source
    decodes a tile index) and their rows m < r cw inside the image take each
    token of every view once; each row's band pixel plus any tap's offset
    stays in the band, and the band's pixels are the tile's rows and columns
    one past each side."""
    src = (CSRC / "tok_bf16.cuh").read_text()
    for line in ("y0 = (t / txs) * r;", "x0 = (t % txs) * cw;",
                 "return PM ? ((view / A2) * hw + y * w + xx) * A2 + view % A2 : view * hw + y * w + xx;",
                 "(m < ntok ? (m / cw + 1) * bw + m % cw + 1 : bw + 1) * LDB",
                 "const int toff = (tap / 3 - 1) * bw + (tap % 3 - 1);",
                 "t[e] = mm < ntok && y < h && xx < w ? view * hw + y * w + xx : -1;"):
        assert line in src, line
    h, w = hw
    V = 2
    for C in (16, 32, 64):
        r, cw = sb.tok_bf16_tile(h, w, C)
        bw, P = cw + 2, (r + 2) * (cw + 2)
        seen = np.zeros(V * h * w, int)
        for view, y0, x0 in _tiles(V, h, w, r, cw):
            for m in range(rg.RG_M):
                pix = (m // cw + 1) * bw + m % cw + 1 if m < r * cw else bw + 1
                for tap in range(9):
                    assert 0 <= pix + (tap // 3 - 1) * bw + (tap % 3 - 1) < P
                y, x = y0 + m // cw, x0 + m % cw
                if m < r * cw and y < h and x < w:
                    seen[view * h * w + y * w + x] += 1
        assert (seen == 1).all(), (hw, C)


def test_tok_bf16_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the four bf16 forms are their plain versions, bit for
    bit, and launch nothing."""
    x, pe, wts = _inputs(16, 4, 6, 5, 3)
    wb = {k: v.bfloat16() for k, v in wts.items()}
    pm = x.reshape(2, 2, 6, 5, 16).permute(0, 2, 3, 1, 4).contiguous()
    reset_launches()
    for xx, pp, ww, plan in ((x.bfloat16(), pe.bfloat16(), wb, None), (x, pe, wts, NONE)):
        want = sb.tokenize_ln_plain(xx, pp, ww, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(sb.tokenize_ln(xx, pp, ww, plan=plan), want))
        got = sb.tokenize_ln(pm.to(xx.dtype), pp, ww, pixel_major=True, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(LAUNCHES.values()) == 0


def test_tok_bf16_source_launches_every_c_entry():
    """The four C entries of the bf16 forms reach `launch_tok_bf16` with
    their PM and IO, at every C (LFT_DISPATCH_C), and the f32 forms stay on
    tap_conv_kernel, whose LayerNorm epilogue is f32 only."""
    src = (CSRC / "spa_block.cu").read_text()
    body = lambda n: src[src.index(f'extern "C" int {n}('):].split("\n}\n")[0]
    for name, call in (("lft_spa_tokenize_ln_bf16io", "tokenize_ln<false, bf16>("),
                       ("lft_spa_tokenize_ln_bf16", "tokenize_ln<false, float, true>("),
                       ("lft_spa_tokenize_ln_pm_bf16io", "tokenize_ln_pm<bf16>("),
                       ("lft_spa_tokenize_ln_pm_bf16", "tokenize_ln_pm<float, true>("),
                       ("lft_spa_tokenize_ln", "tokenize_ln<false>("),
                       ("lft_spa_tokenize_ln_pm", "tokenize_ln_pm<float>(")):
        assert call in body(name), name
    fn = src[src.index("int tokenize_ln(const IO* x"):].split("\n}\n")[0]
    assert "LFT_DISPATCH_C(C, {" in fn and "if constexpr (BF)" in fn
    assert "return launch_tok_bf16<CC, PM, IO>(" in fn
    assert "return launch_tap_conv<CC, 2 * CC, PM, true, false>(" in fn
    assert len(re.findall(r"launch_tok_bf16<", src)) == 1
    tok = (CSRC / "tokenize.cuh").read_text()
    assert 'static_assert(!LN || (!BF && !is_bf16<IO>), "the bf16 forwards run tok_bf16.cuh");' in tok
    common_src = (CSRC / "spa.cuh").read_text()
    assert all(f"case {c}: {{ constexpr int CC = {c};" in common_src for c in (16, 32, 64))
