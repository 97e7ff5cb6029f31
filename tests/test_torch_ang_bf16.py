"""K1's all-bf16 forms on bf16 tensor-core products (`lft_torch/csrc/
ang_bf16.cuh`: `ang_bf16_kernel`, launched as `ang_block_bf16io`,
`ang_block_res_bf16io`, `ang_block_bf16` and `ang_block_res_bf16`), on the
CPU: their arithmetic, their weight layout and their geometry.

The CUDA kernel cannot run here; its scheme can. `_ang_bf16` repeats it
from the wrapper's own weight preparation (`rowgemm.ang_bf16_stream`,
unpacked from its core-matrix layout): tiles of 128 token rows of whole
pixels, zero past a tile's pixels; xn = bf16(LN1(x + pe)), q, k, v =
bf16(xn Wq), bf16(xn Wk), bf16(bf16(x) Wv), each product's k16 steps
summed in f32 in K order; q, k, v with 16 zero rows past the tile; the
attention an item (pixel, 16 queries, head group) at a time over the
pixel's keys in steps of 16 (padding keys, rows of the next pixel or zero
rows, masked), scores the f32 sums of exact bf16 products per head times
scale, m the max over every head and valid key (the groups' maxima from a
first pass), e = 2^(s scale log2(e) - m log2(e)), l summed by each
lane of a quad over its keys in the kernel's order and then (l0 + l1) +
(l2 + l3), o the f32 sum of bf16(e) v, attn = bf16(o (1 / l)); then x2 =
bf16(bf16(attn Wo) + x) (bf16 IO) or attn Wo + x (f32 IO), the FFN in
hidden chunks of min(2C, 64) with hid = bf16(relu(bf16(LN2(x2)) W1)), out
= bf16(bf16(hid W2) + x2) or hid W2 + x2. It must match the plain
versions (`ang_block_bf16io_plain`, `_ang_block_planned` under the plan
`none`) within the bounds the card holds the kernel to (chip_smoke.py's
BF16_GAP and BF16_ULPS; MIXED_REL and MIXED_GAP), float64 as closely, and
lft_tpu's bf16 block (`tests/_torch_bf16_ref.py k1`) and its `with_res`
block under `none` (`tests/_torch_mixed_none_ref.py k1`) within
test_torch_bf16.py's and test_torch_mixed_none_train.py's bounds. The
tensor cores' own rounding inside an MMA is not modelled: f32 sums here.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import ang_block as ab
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels.common import bf16_round, mm_site_plan
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16_ref as RB  # noqa: E402
import _torch_mixed_none_ref as RN  # noqa: E402

CSRC = Path(ab.__file__).resolve().parent.parent / "csrc"
GAP, ULPS = 0.1, 1.0                     # chip_smoke.py: BF16_GAP, BF16_ULPS
MIXED_REL, MIXED_GAP, STATS_L2 = 1e-3, 0.1, 1e-5
LOG2E = 1.4426950408889634       # ang_bf16.cuh: kLog2e
H = 8
NONE = mm_site_plan(True, frozenset())   # LFT_MM_HP_SITES=none
A2S = (9, 25, 81, 121)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unpack(flat, K, N):
    """`rowgemm.bf16_piece`'s layout [K/16, 2, N/8, 8, 8] -> [K, N]."""
    return flat.reshape(K // 16, 2, N // 8, 8, 8).permute(0, 1, 4, 2, 3).reshape(K, N)


def _weights(wts):
    """Wv, Wq, Wk, Wo, W1, W2 (bf16 values, f32) from the launch's weight
    preparation."""
    C = wts["wq"].shape[0]
    f = rg.ang_bf16_stream(wts)
    assert f.dtype == torch.bfloat16 and f.numel() == 2 * rg.ang_bf16_floats(C)
    out, off = {}, 0
    for n in rg.ANG_BF16_ORDER:
        K, N = wts[n].shape
        out[n] = _unpack(f[off:off + K * N], K, N).float()
        off += K * N
    assert off == f.numel()
    return out


def _mm(a, b):
    """a @ b over bf16 values, summed in f32 over k16 steps in K order."""
    acc = torch.zeros(*a.shape[:-1], b.shape[1])
    for k in range(0, a.shape[-1], 16):
        acc = acc + a[..., k:k + 16] @ b[k:k + 16]
    return acc


def _ln(x, w, b):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def _ang_bf16(x, pe, wts, res=False):
    """K1's all-bf16 kernel in its arithmetic (the module docstring): bf16
    x [N, A2, C] runs the bf16-IO forms, f32 x the `none` forms."""
    B = bf16_round
    bio = x.dtype == torch.bfloat16
    W = _weights(wts)
    ln = wts["ln"].float()
    N, A2, C = x.shape
    P = rg.RG_M // A2
    tiles = -(-N // P)
    dh, MT = C // H, -(-A2 // 16)
    scale = float(dh) ** -0.5
    flat = x.float().reshape(N * A2, C)
    X = torch.zeros(tiles, rg.RG_M, C)
    nrows = [min(P, N - t * P) * A2 for t in range(tiles)]
    for t in range(tiles):
        X[t, :nrows[t]] = flat[t * P * A2:t * P * A2 + nrows[t]]
    xn = B(_ln(X + pe.float()[torch.arange(rg.RG_M) % A2], ln[0], ln[1]))
    pad = lambda t_: torch.cat([t_, torch.zeros(tiles, rg.ANG_BF16_ROWS - rg.RG_M, C)], 1)
    Q, K, V = (pad(B(_mm(a, W[n]))) for a, n in ((xn, "wq"), (xn, "wk"), (B(X), "wv")))
    heads = lambda t_: t_.reshape(tiles, t_.shape[1], H, dh).transpose(1, 2)
    AO = torch.zeros(tiles, rg.RG_M, C)
    m_out, l_out = torch.zeros(tiles, rg.RG_M, H), torch.zeros(tiles, rg.RG_M, H)
    valid = torch.arange(16 * MT) < A2
    for p in range(P):
        base = p * A2
        kh, vh = heads(K[:, base:base + 16 * MT]), heads(V[:, base:base + 16 * MT])
        for mt in range(MT):
            qh = heads(Q[:, base + 16 * mt:base + 16 * mt + 16])
            s = qh @ kh.transpose(-1, -2)                              # [tiles, H, 16, 16 MT]
            m = s.masked_fill(~valid, -torch.inf).amax(-1).amax(1) * scale   # [tiles, 16]
            e = torch.where(valid, torch.exp2(s * (scale * LOG2E) - (m * LOG2E)[:, None, :, None]),
                            0.0)
            # a lane q4's keys: k0 + 2 q4, k0 + 8 + 2 q4, k0 + 2 q4 + 1, k0 + 9 + 2 q4, ...
            lanes = e.reshape(tiles, H, 16, MT, 2, 4, 2)   # key = 16 ks + 8 half + 2 q4 + odd
            lq = torch.zeros(tiles, H, 16, 4)
            for ks in range(MT):
                for odd in range(2):
                    for half in range(2):
                        lq = lq + lanes[:, :, :, ks, half, :, odd]
            l = (lq[..., 0] + lq[..., 1]) + (lq[..., 2] + lq[..., 3])
            a = B((B(e) @ vh) * (1.0 / l)[..., None])           # [tiles, H, 16, dh]
            n = min(16, A2 - 16 * mt)
            rows = slice(base + 16 * mt, base + 16 * mt + n)
            AO[:, rows] = a.transpose(1, 2).reshape(tiles, 16, C)[:, :n]
            m_out[:, rows] = m[:, :n, None].expand(-1, -1, H)
            l_out[:, rows] = l.transpose(1, 2)[:, :n]
    x2 = _mm(AO, W["wo"])
    x2 = B(B(x2) + X) if bio else x2 + X
    xn2 = B(_ln(x2, ln[2], ln[3]))
    hc = min(2 * C, 64)
    y = torch.zeros(tiles, rg.RG_M, C)
    for c in range(0, 2 * C, hc):
        hid = B(torch.relu(_mm(xn2, W["w1"][:, c:c + hc])))
        for k in range(0, hc, 16):
            y = y + hid[..., k:k + 16] @ W["w2"][c + k:c + k + 16]
    out = B(B(y) + x2) if bio else y + x2
    take = lambda t_: torch.cat([t_[t, :nrows[t]] for t in range(tiles)]).reshape(N, A2, -1)
    io = torch.bfloat16 if bio else torch.float32
    if not res:
        return take(out).to(io)
    return take(out).to(io), take(m_out), take(l_out), take(AO).to(io)


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want) -> float:
    want = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


def _inputs(C, A2, seed):
    """x [N, A2, C] with a last tile partly filled, the PE and block 1's
    weights (f32 and bf16 values)."""
    P = rg.RG_M // A2
    N = 2 * P + 1 if P > 1 else 3
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, A2, C).astype(np.float32))
    p = lft.init_params(seed, Args(channels=C, scale_factor=2), device="cpu")
    wts = ab.ang_weights(p, "altblock.1.ang_trans.")
    wb = {k: v.bfloat16() for k, v in wts.items()}
    return x, torch.from_numpy(angular_position(A2, C)), wts, wb


@pytest.mark.parametrize("A2", A2S)
@pytest.mark.parametrize("C", [16, 32])
def test_ang_bf16_scheme_matches_the_plain_bf16io_version(C, A2):
    """bf16 IO: the emulated kernel against `ang_block_bf16io_plain`, out
    and attn within GAP of the plain bf16-vs-f32 distance and ULPS bf16
    ulps, m and l within 1e-5 / 1e-4 (m the token's max in every head's
    slot); the `_res` form's out the forward's; against float64 (the f32
    block on the same bf16 values) within (1 + GAP) of the plain version's
    distance."""
    x, pe, _, wb = _inputs(C, A2, C + A2)
    xb = x.bfloat16()
    got = _ang_bf16(xb, pe, wb, res=True)
    ref = ab.ang_block_plain(xb, pe, wb, H, with_res=True)
    w32 = {k: v.float() for k, v in wb.items()}
    ref32 = ab.ang_block_plain(xb.float(), pe, w32, H, with_res=True)
    for i in (0, 3):
        g, r, r32 = (t[i].float().numpy() for t in (got, ref, ref32))
        assert got[i].dtype == torch.bfloat16 and got[i].shape == ref[i].shape
        assert _l2(g, r) <= GAP * _l2(r32, r), (i, _l2(g, r), _l2(r32, r))
        assert _ulps(g, r) <= ULPS, i
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[2], ref[2], atol=1e-5, rtol=1e-4)
    assert torch.equal(got[0], _ang_bf16(xb, pe, wb))
    exact = ab.ang_block_plain(xb.double(), pe.double(), {k: v.double() for k, v in wb.items()}, H)
    d_got, d_ref = _l2(got[0].double(), exact), _l2(ref[0].double(), exact)
    assert d_got <= (1 + GAP) * d_ref, (d_got, d_ref)


@pytest.mark.parametrize("A2", A2S)
@pytest.mark.parametrize("C", [16, 32])
def test_ang_bf16_scheme_matches_the_plain_none_version(C, A2):
    """f32 IO (`ang_block[_res]_bf16`): the emulated kernel against the
    plain version under the plan `none`, out and attn L2-relative MIXED_REL
    and MIXED_GAP of the plain mixed-vs-f32 distance, attn bf16 values, m
    and l within STATS_L2; the `_res` form's out the forward's; against
    float64 (the plan's plain version in float64) as close as the plain
    version, within a hundredth of its mixed-vs-f32 distance (an e that
    rounds to the neighbouring bf16 value moves both by as much)."""
    x, pe, wts, _ = _inputs(C, A2, 7 * C + A2)
    got = _ang_bf16(x, pe, wts, res=True)
    ref = ab.ang_block_plain(x, pe, wts, H, with_res=True, plan=NONE)
    ref32 = ab.ang_block_plain(x, pe, wts, H, with_res=True)
    for i in (0, 3):
        d, gap = _l2(got[i], ref[i]), _l2(ref32[i], ref[i])
        assert got[i].dtype == torch.float32 and d <= MIXED_REL and d <= MIXED_GAP * gap, (i, d)
    assert torch.equal(got[3], bf16_round(got[3]))
    assert _l2(got[1], ref[1]) <= STATS_L2 and _l2(got[2], ref[2]) <= STATS_L2
    assert torch.equal(got[0], _ang_bf16(x, pe, wts))
    exact = ab.ang_block_plain(x.double(), pe.double(), {k: v.double() for k, v in wts.items()},
                               H, plan=NONE)
    assert _l2(got[0], exact) <= _l2(ref[0], exact) + 0.01 * _l2(ref32[0], ref[0])


def _random_weights(C, g):
    """chip_smoke.py's random block weights: N(0, 1 / fan-in), the
    LayerNorm affine 1 +- 0.2."""
    rnd = lambda *s_: torch.randn(*s_, generator=g)
    w = {n: rnd(*s_) / s_[0] ** 0.5 for n, s_ in (
        ("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)), ("w1", (C, 2 * C)),
        ("w2", (2 * C, C)))}
    w["ln"] = torch.stack([1 + 0.2 * rnd(C), 0.2 * rnd(C), 1 + 0.2 * rnd(C), 0.2 * rnd(C)])
    return w


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("A2", [81, 121])
def test_ang_bf16_scheme_at_the_main_width(A2, seed):
    """C = 64, the main path's width, at the view counts where a query sees
    the most keys, on random weights and 64 pixels (chip_smoke.py's width
    checks): in bf16 IO out within GAP of the plain bf16-vs-f32 distance
    and ULPS bf16 ulps of the plain version, and no further from float64 at
    the plain version's rounding points (`ang_block_bf16io_f64`)
    than (1 + GAP) times the plain version is; in f32 IO out within
    MIXED_REL and MIXED_GAP of the plain version under `none`."""
    C, N = 64, 64
    g = torch.Generator().manual_seed(1000 * seed + A2)
    wts = _random_weights(C, g)
    wb = {n: t.bfloat16() for n, t in wts.items()}
    w32 = {n: t.float() for n, t in wb.items()}
    x = torch.randn(N, A2, C, generator=g)
    pe = torch.from_numpy(angular_position(A2, C))
    xb = x.bfloat16()
    got = _ang_bf16(xb, pe, wb).float()
    ref = ab.ang_block_bf16io_plain(xb, pe, wb, H).float()
    gap = _l2(ab.ang_block_plain(xb.float(), pe, w32, H), ref)
    assert _l2(got, ref) <= GAP * gap, (_l2(got, ref), gap)
    assert _ulps(got, ref) <= ULPS
    exact = ab.ang_block_bf16io_f64(xb, pe, w32, H)
    assert _l2(got, exact) <= (1 + GAP) * _l2(ref, exact), (_l2(got, exact), _l2(ref, exact))
    got = _ang_bf16(x, pe, wts)
    ref = ab.ang_block_plain(x, pe, wts, H, plan=NONE)
    d = _l2(got, ref)
    assert d <= MIXED_REL and d <= MIXED_GAP * _l2(ab.ang_block_plain(x, pe, wts, H), ref), d


@pytest.fixture(scope="module")
def k1ref(tmp_path_factory):
    """lft_tpu's K1: bf16 (tests/_torch_bf16_ref.py k1) and `with_res`
    under `none` (tests/_torch_mixed_none_ref.py k1), two processes at
    once."""
    d = tmp_path_factory.mktemp("ang_bf16")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    here = os.path.dirname(__file__)
    procs = {n: subprocess.Popen([sys.executable, os.path.join(here, s), str(d / f"{n}.npz"),
                                  "k1"], env=env)
             for n, s in (("bf16", "_torch_bf16_ref.py"), ("none", "_torch_mixed_none_ref.py"))}
    try:
        for n, proc in procs.items():
            assert proc.wait(timeout=600) == 0, n
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return {n: dict(np.load(d / f"{n}.npz")) for n in procs}


@pytest.mark.parametrize("C", RB.C_BLOCKS)
def test_emulated_bf16io_block_matches_lft_tpu(k1ref, C):
    """The emulated kernel on test_torch_bf16.py's K1 inputs against lft_tpu's
    bf16 block: within 1/10 of lft_tpu's bf16-vs-f32 distance and 1 bf16 ulp
    (test_torch_bf16.py: BLOCK_GAP, BLOCK_ULPS)."""
    d = RB.inputs(C)
    p = {k: torch.from_numpy(np.ascontiguousarray(v)).bfloat16() for k, v in d["params"].items()}
    x = torch.from_numpy(np.ascontiguousarray(d["k1_x"])).bfloat16()
    pe = torch.from_numpy(angular_position(RB.K1_SHAPE[1], C))
    got = _ang_bf16(x, pe, ab.ang_weights(p, RB.ANG_PREFIX)).float().numpy()
    r = k1ref["bf16"]
    want, gap = r[f"k1_{C}_bf16"], _l2(r[f"k1_{C}_bf16"], r[f"k1_{C}_f32"])
    assert _l2(got, want) <= GAP * gap, (_l2(got, want), gap)
    assert _ulps(got, want) <= ULPS


@pytest.mark.parametrize("C", RN.C_BLOCKS)
def test_emulated_none_res_block_matches_lft_tpu(k1ref, C):
    """The emulated `_res` kernel in f32 IO on test_torch_mixed_none_train.py's
    K1 inputs against lft_tpu's `_core_fwd(with_res=True, mm_half=True)`
    under `none`: out and attn within MIXED_REL and MIXED_GAP of lft_tpu's
    mixed-vs-f32 distance, m and l within STATS_L2
    (test_torch_mixed_none_train.py's bounds)."""
    d = RN.block_inputs(C)
    wts = ab.ang_weights(lft.params_from_numpy(d["params"], device="cpu"), RN.ANG_PREFIX)
    x, pe = torch.from_numpy(d["k1_x"]), torch.from_numpy(angular_position(RN.K1_SHAPE[1], C))
    got = _ang_bf16(x, pe, wts, res=True)
    r = k1ref["none"]
    for i, n in enumerate(("out", "m", "l", "attn")):
        want = r[f"k1_{C}_none_{n}"]
        if n in ("m", "l"):
            assert _l2(got[i].numpy(), want) <= STATS_L2, n
            continue
        dist, gap = _l2(got[i].numpy(), want), _l2(r[f"k1_{C}_f32_{n}"], want)
        assert dist <= MIXED_REL and dist <= MIXED_GAP * gap, (n, dist, gap)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_ang_bf16_weight_layout(C):
    """`ang_bf16_stream` holds Wv, Wq, Wk, Wo, W1, W2 rounded to bf16, each
    at (kk, kh, j, n, t) = B[16 kk + 8 kh + t][8 j + n], at AngBf16's
    offsets, as `ang_bf16_weights_kernel` writes it (its index formula,
    repeated here); the scratch holds it."""
    _, _, wts, _ = _inputs(C, 25, C)
    f = rg.ang_bf16_stream(wts)
    assert f.numel() == 8 * C * C == 2 * rg.ang_bf16_floats(C) <= 2 * rg.ang_block_floats(C)
    off = 0
    for n, off_want in zip(rg.ANG_BF16_ORDER, (0, 1, 2, 3, 4, 6)):
        assert off == off_want * C * C
        B = wts[n]
        K, N = B.shape
        k_, n_ = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
        at = ((k_ // 16 * 2 + k_ % 16 // 8) * (N // 8) + n_ // 8) * 64 + n_ % 8 * 8 + k_ % 8
        assert torch.equal(f[off + at.reshape(-1)], B.bfloat16().reshape(-1))
        off += K * N


def test_ang_bf16_geometry_mirrors_the_source():
    """rowgemm.py's sizes of K1's all-bf16 kernel are AngBf16's
    (ang_bf16.cuh), the source's shared-memory table says them, and every
    width fits a block in either IO type."""
    src = (CSRC / "ang_bf16.cuh").read_text()
    for line in ("OFF_V = 0, OFF_Q = SQ, OFF_K = 2 * SQ, OFF_O = 3 * SQ;",
                 "OFF_1 = 4 * SQ, OFF_2 = 6 * SQ;", "ELEMS = 8 * SQ;", "LDR = C + 8;",
                 "ROWS = RG_M + 16;", "QKV = 3 * ROWS * LDR * 2;", "AO = RG_M * LDR * 2;",
                 "MHB = ROWS * NG * 4;", "NG = C / 16;",
                 "WBYTES + QKV + AO + MHB + 2 * RG_M * LDR * static_cast<int>(sizeof(IO));",
                 "HC = 2 * C < 64 ? 2 * C : 64;", "kLog2e = 1.4426950408889634f;",
                 "at = off + ((k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 "
                 "+ k % 8;"):
        assert line in src, line
    assert rg.ANG_BF16_ROWS == rg.RG_M + 16
    table = {16: "C = 16:", 32: "C = 32:", 64: "C = 64:"}
    for C, tag in table.items():
        b16, f32 = rg.ang_bf16_smem(C, True), rg.ang_bf16_smem(C, False)
        assert b16 < f32 <= rg.RG_SMEM_MAX
        line = src[src.index(tag):].split("\n//   C =")[0]
        assert f"{b16:,}" in line and f"{f32:,}" in line, (C, line)
    assert rg.ang_bf16_smem(64, False) == 222208 and rg.ang_bf16_smem(64, True) == 185344
    assert [rg.ang_bf16_groups(C) for C in (16, 32, 64)] == [1, 2, 4]


def test_ang_bf16_items_cover_every_query_and_key_once():
    """For every A2 of the gate (1-128) and every head-group count: the items
    (pixel, 16 queries, group) of a full tile, decoded as the source decodes
    them, take each of its P = 128 / A2 pixels' queries once a group; pass
    1 writes a query's maximum for a group from one item alone (valid rows
    only, so no two items write one slot); each key step of 16 stays within
    q, k, v's rows (the 16 zero rows past the tile included) and the steps
    take every key of the pixel once."""
    src = (CSRC / "ang_bf16.cuh").read_text()
    for line in ("grp = item % NG;", "base = item / NG / MT * A2;", "i0 = 16 * (item / NG % MT);",
                 "if (q4 == 0 && i0 + g + 8 * h < A2) MH[(base + i0 + g + 8 * h) * NG + grp] = mx[h];",
                 "const int items = np * MT * NG;"):
        assert line in src, line
    for NG in (1, 2, 4):
        for A2 in range(1, 129):
            P, MT = rg.RG_M // A2, -(-A2 // 16)
            seen = np.zeros((P * A2, NG), int)
            for item in range(P * MT * NG):
                grp, base, i0 = item % NG, item // NG // MT * A2, 16 * (item // NG % MT)
                for i in range(i0, min(i0 + 16, A2)):
                    seen[base + i, grp] += 1
                assert base + i0 + 15 < rg.ANG_BF16_ROWS
                keys = [k0 + j for k0 in range(0, A2, 16) for j in range(16) if k0 + j < A2]
                assert keys == list(range(A2)) and base + 16 * MT - 1 < rg.ANG_BF16_ROWS
            assert (seen == 1).all(), (A2, NG)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_ang_bf16_lanes_own_each_head_once(C):
    """The lanes' shares of a head (the source's `mine(e)` and its writer of
    m and l): of each chunk of 8 channels lane q4 holds channels 2 q4 and
    2 q4 + 1; each of a head's dh channels is written by exactly one lane of
    the quad, and m and l by exactly one; a k8 chunk's q of head e keeps
    head e's channels alone."""
    src = (CSRC / "ang_bf16.cuh").read_text()
    assert "auto mine = [&](int e) { return (2 * q4) / DH == e % HPC; };" in src
    assert "if (2 * q4 == e % HPC * DH) {" in src
    dh = C // H
    hpc = 8 // dh
    for e in range(H):
        chans = [8 * (e // hpc) + 2 * q4 + i for q4 in range(4) if (2 * q4) // dh == e % hpc
                 for i in range(2)]
        assert sorted(chans) == list(range(e * dh, (e + 1) * dh)), (e, chans)
        assert sum(2 * q4 == e % hpc * dh for q4 in range(4)) == 1


def test_ang_bf16_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the four all-bf16 forms are their plain versions, bit
    for bit, and launch nothing."""
    x, pe, wts, wb = _inputs(16, 25, 1)
    xb = x.bfloat16()
    reset_launches()
    assert torch.equal(ab.ang_block(xb, pe, wb, H), ab.ang_block_plain(xb, pe, wb, H))
    assert all(torch.equal(a, b) for a, b in zip(ab.ang_block(xb, pe, wb, H, with_res=True),
                                                 ab.ang_block_plain(xb, pe, wb, H, with_res=True)))
    assert torch.equal(ab.ang_block(x, pe, wts, H, plan=NONE),
                       ab.ang_block_plain(x, pe, wts, H, plan=NONE))
    assert all(torch.equal(a, b) for a, b in zip(
        ab.ang_block(x, pe, wts, H, with_res=True, plan=NONE),
        ab.ang_block_plain(x, pe, wts, H, with_res=True, plan=NONE)))
    assert sum(LAUNCHES.values()) == 0


def test_ang_bf16_source_launches_the_c_entries():
    """The four C entries of the all-bf16 forms launch ang_bf16.cuh's kernel
    with their RES and IO, and nothing else of ang_block.cu launches it."""
    src = (CSRC / "ang_block.cu").read_text()
    body = lambda n: src[src.index(f'extern "C" int {n}('):].split("\n}\n")[0]
    for name, args in (("lft_ang_block_fwd_bf16", "false, float"),
                       ("lft_ang_block_fwd_bf16io", "false, bf16"),
                       ("lft_ang_block_fwd_res_bf16io", "true, bf16"),
                       ("lft_ang_block_fwd_res_bf16", "true, float")):
        assert f"LFT_ANG_BF16({args}," in body(name), name
    assert len(re.findall(r"launch_ang_bf16<", src)) == 1


def test_probe_variants_anchors_are_in_the_sources():
    """Every variant of `probe_variants` (each one text edit of this
    checkout's sources) finds its anchors, and the accuracy mode's variants
    are variants of K1's kernel."""
    from lft_torch import probe_variants as pv
    for target in pv.VARIANTS:
        srcs = pv._sources(target)
        assert set(srcs) == {"as_is", *pv.VARIANTS[target]}
        for name, files in srcs.items():
            for fn, text in files.items():
                assert text != (CSRC / fn).read_text(), (target, name, fn)
    assert set(pv.ANG_EXACT) <= {"as_is", *pv.VARIANTS["ang"]}
