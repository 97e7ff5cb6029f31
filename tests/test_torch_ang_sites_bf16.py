"""K1's site-subset forms redesigned on ang_bf16.cuh's design (`lft_torch/
csrc/ang_sites.cuh`: `ang_sites_kernel`, launched as `ang_block_sites` and
`ang_block_res_sites` under an LFT_MM_HP_SITES subset that rounds some of
K1's five sites and not others), on the CPU: their arithmetic, their weight
layout and their geometry.

The CUDA kernel cannot run here; its scheme can. `_ang_sites` repeats it
from the wrapper's own weight preparation (`rowgemm.ang_sites_stream`: the
rounded weights unpacked from `bf16_piece`'s layout, the others' TF32 hi
and lo from `piece`'s, the `sites_rows` order undone) and layout
(`rowgemm.ang_sites_plan`), R(t) below being t rounded to bf16 where the
product's site rounds:

* tiles of 128 token rows of whole pixels, zero past a tile's pixels; xn =
  LN1(x + pe); v, q, k from R(x), R(xn): a rounded product over bf16 values
  with f32 sums, an f32 one as three TF32 products (both operands split hi +
  lo, rounded to nearest), in two chains, the even and the odd k8 steps,
  added in f32 (`tf3_product`), or in one chain where Wv, Wq and Wk are
  resident (`tf3_qkv`, the plan's `res`); q, k held rounded where `ascore`
  rounds, v where `aav` does;
* the attention an item (pixel, 16 queries, head group) at a time over the
  pixel's keys in steps of 16 (padding keys masked): scores per head, the
  f32 sums of exact bf16 products where `ascore` rounds, else three TF32
  products of q and k split; m the max over every head and valid key (the
  groups' maxima from a first pass) times scale; e = 2^(s scale log2(e) - m
  log2(e)); l summed by each lane of a quad over its keys in the kernel's
  order, then (l0 + l1) + (l2 + l3); o = bf16(e) bf16(v) with f32 sums where
  `aav` rounds, else three TF32 products of e and v split; a = o (1 / l),
  rounded where `awo` rounds;
* x2 = R(a) R(Wo) + x, LN2, then the FFN in hidden chunks of min(2C, 64):
  where `affn` rounds hid = bf16(relu(bf16(LN2(x2)) W1)) and y += hid W2
  over bf16 weights, else h = LN2(x2) W1 and y += relu(h) W2 as 3xTF32
  products; out = y + x2.

It must match the plain version under the plan (`_ang_block_planned`)
within the bounds the card holds the kernel to (chip_smoke.py's MIXED_REL
and MIXED_GAP), float64 at the plain version's rounding points as closely,
and lft_tpu's K1 under S1 and S2 (`tests/_torch_sites_ref.py k1_s1`,
`k1_s2`) within test_torch_sites.py's bounds, at C = 16 and 32 and under
S1, S2 and masks that take the attention's other two paths. The tensor
cores' own rounding inside an MMA is not modelled: f32 sums here.
"""

import itertools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lft_torch.config import Args
from lft_torch.kernels import LAUNCHES, common, reset_launches
from lft_torch.kernels import ang_block as ab
from lft_torch.kernels import rowgemm as rg
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sites_ref as R  # noqa: E402

CSRC = Path(ab.__file__).resolve().parent.parent / "csrc"
MIXED_REL, MIXED_GAP, STATS_L2 = 1e-3, 0.1, 1e-5   # chip_smoke.py; test_torch_ang_bf16.py
LOG2E = 1.4426950408889634                          # ang_bf16.cuh: kLog2e
H = 8
K1_SITES = ("aqkv", "ascore", "aav", "awo", "affn")
# the sites each mask rounds: S1 and S2 (tests/_torch_sites_ref.py), then
# the attention's two other paths (scores and e v both f32, both bf16)
ROUNDED = {"s1": ("ascore", "awo", "affn"), "s2": ("aqkv", "aav"),
           "m3": ("aqkv", "awo"), "m4": ("ascore", "aav")}


def _plan(rounded):
    return common.mm_site_plan(True, frozenset(common.MM_HP_ALL) - frozenset(rounded))


def _mask(rounded) -> int:
    return sum(common.SITE_BITS[s] for s in rounded)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unpack_bf16(flat, K, N):
    """`rowgemm.bf16_piece`'s layout [K/16, 2, N/8, 8, 8] -> [K, N] (f32)."""
    return flat.reshape(K // 16, 2, N // 8, 8, 8).permute(0, 1, 4, 2, 3).reshape(K, N).float()


def _unpack_tf32(flat, K, N, sites):
    """`rowgemm.piece`'s layout [K/8, 2, 2, N/8, 8, 4] -> (hi, lo) [K, N],
    rows back in weight order where `sites` (`rowgemm.sites_piece`)."""
    f = flat.reshape(K // 8, 2, 2, N // 8, 8, 4).permute(1, 0, 2, 5, 3, 4).reshape(2, K, N)
    if sites:
        f = f[:, torch.argsort(torch.tensor(rg.sites_rows(K)))]
    return f[0], f[1]


def _weights(wts, mask):
    """{name: ("bf", W) or ("tf", (hi, lo))} from the launch's weight
    preparation, W1 and W2 as lists of hidden chunks."""
    C = wts["wq"].shape[0]
    hc = rg.hidden_chunk(C)
    p = rg.ang_sites_plan(C, mask)
    bf, st = rg.ang_sites_stream(wts, mask)
    assert bf.dtype == torch.bfloat16 and 2 * p["wbytes"] >= 2 * bf.numel()
    assert st.numel() == p["stream"] and 4 * C * C + st.numel() <= rg.ang_sites_floats(C)
    out = {}
    for i, (n, site) in enumerate(rg.ANG_SITES_ORDER):
        K, N = wts[n].shape
        if mask & common.SITE_BITS[site]:
            W = _unpack_bf16(bf[p["bw"][i]:p["bw"][i] + K * N], K, N)
            out[n] = ("bf", W if n in ("wv", "wq", "wk", "wo") else
                      [W[:, j:j + hc] if n == "w1" else W[j:j + hc] for j in range(0, 2 * C, hc)])
        elif i < 4:
            out[n] = ("tf", _unpack_tf32(st[p["sw"][i]:p["sw"][i] + 2 * C * C], C, C, n != "wo"))
    if not mask & common.SITE_BITS["affn"]:
        at, w1, w2 = p["sw"][4], [], []
        for _ in range(2 * C // hc):
            w1.append(_unpack_tf32(st[at:at + 2 * C * hc], C, hc, not p["rows"]))
            w2.append(_unpack_tf32(st[at + 2 * C * hc:at + 4 * C * hc], hc, C, False))
            at += 4 * C * hc
        out["w1"], out["w2"] = ("tf", w1), ("tf", w2)
    return out


def _tf3(a, hi, lo, chains=2):
    """a @ (hi + lo) as three TF32 products (a split hi + lo, rounded to
    nearest) per k8 step: in two chains, the even and the odd k8 steps,
    added in f32 (`tf3_product`), or in one (`tf3_qkv`)."""
    ah, al = rg.split_tf32_rn(a.contiguous())
    sums = [torch.zeros(*a.shape[:-1], hi.shape[1]) for _ in range(chains)]
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        z = k // 8 % chains
        sums[z] = ((sums[z] + al[..., s] @ hi[s]) + ah[..., s] @ lo[s]) + ah[..., s] @ hi[s]
    return sums[0] + sums[1] if chains == 2 else sums[0]


def _product(a, w, chains=2):
    """A product as its site takes it: ("bf", W) over bf16 values, f32 sums;
    ("tf", (hi, lo)) 3xTF32 in `chains`."""
    kind, W = w
    return common.bf16_round(a) @ W if kind == "bf" else _tf3(a, *W, chains)


def _ln(x, w, b):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def _ang_sites(x, pe, wts, rounded, res=False):
    """The `_sites` kernel under the mask of `rounded` in its arithmetic (the
    module docstring): f32 x [N, A2, C] -> out (with res also m, l, attn)."""
    B = common.bf16_round
    rnd = lambda s: s in rounded
    W = _weights(wts, _mask(rounded))
    ln = wts["ln"].float()
    N, A2, C = x.shape
    P = rg.RG_M // A2
    tiles = -(-N // P)
    dh, MT = C // H, -(-A2 // 16)
    scale = float(dh) ** -0.5
    flat = x.reshape(N * A2, C)
    X = torch.zeros(tiles, rg.RG_M, C)
    nrows = [min(P, N - t * P) * A2 for t in range(tiles)]
    for t in range(tiles):
        X[t, :nrows[t]] = flat[t * P * A2:t * P * A2 + nrows[t]]
    xn = _ln(X + pe[torch.arange(rg.RG_M) % A2], ln[0], ln[1])
    pad = lambda t_: torch.cat([t_, torch.zeros(tiles, rg.ANG_BF16_ROWS - rg.RG_M, C)], 1)
    hold = lambda t_, s: B(t_) if rnd(s) else t_
    plan = rg.ang_sites_plan(C, _mask(rounded))
    qkv_chains = 1 if 0 <= plan["sw"][0] < plan["res"] else 2   # resident: tf3_qkv
    V = pad(hold(_product(X, W["wv"], qkv_chains), "aav"))
    Q, K = (pad(hold(_product(xn, W[n], qkv_chains), "ascore")) for n in ("wq", "wk"))
    heads = lambda t_: t_.reshape(tiles, t_.shape[1], H, dh).transpose(1, 2)
    split = lambda t_: rg.split_tf32_rn(t_.contiguous())
    AO = torch.zeros(tiles, rg.RG_M, C)
    m_out, l_out = torch.zeros(tiles, rg.RG_M, H), torch.zeros(tiles, rg.RG_M, H)
    valid = torch.arange(16 * MT) < A2
    for p in range(P):
        base = p * A2
        kh, vh = heads(K[:, base:base + 16 * MT]), heads(V[:, base:base + 16 * MT])
        for mt in range(MT):
            qh = heads(Q[:, base + 16 * mt:base + 16 * mt + 16])
            if rnd("ascore"):
                s = qh @ kh.transpose(-1, -2)                        # [tiles, H, 16, 16 MT]
            else:
                (q1, q0), (k1, k0) = split(qh), split(kh)
                s = (q0 @ k1.transpose(-1, -2) + q1 @ k0.transpose(-1, -2)) + \
                    q1 @ k1.transpose(-1, -2)
            m = s.masked_fill(~valid, -torch.inf).amax(-1).amax(1) * scale   # [tiles, 16]
            e = torch.where(valid, torch.exp2(s * (scale * LOG2E) - (m * LOG2E)[:, None, :, None]),
                            0.0)
            lanes = e.reshape(tiles, H, 16, MT, 2, 4, 2)   # key = 16 ks + 8 half + 2 q4 + odd
            lq = torch.zeros(tiles, H, 16, 4)
            for ks in range(MT):
                for odd in range(2):
                    for half in range(2):
                        lq = lq + lanes[:, :, :, ks, half, :, odd]
            l = (lq[..., 0] + lq[..., 1]) + (lq[..., 2] + lq[..., 3])
            if rnd("aav"):
                o = B(e) @ vh
            else:
                (e1, e0), (v1, v0) = split(e), split(vh)
                o = (e0 @ v1 + e1 @ v0) + e1 @ v1
            a = hold(o * (1.0 / l)[..., None], "awo")                  # [tiles, H, 16, dh]
            n = min(16, A2 - 16 * mt)
            rows = slice(base + 16 * mt, base + 16 * mt + n)
            AO[:, rows] = a.transpose(1, 2).reshape(tiles, 16, C)[:, :n]
            m_out[:, rows] = m[:, :n, None].expand(-1, -1, H)
            l_out[:, rows] = l.transpose(1, 2)[:, :n]
    x2 = _product(AO, W["wo"]) + X
    t2 = _ln(x2, ln[2], ln[3])
    y = torch.zeros(tiles, rg.RG_M, C)
    kind, w1 = W["w1"]
    for c in range(len(w1)):
        if kind == "bf":
            y = y + B(torch.relu(B(t2) @ w1[c])) @ W["w2"][1][c]
        else:
            y = y + _tf3(torch.relu(_tf3(t2, *w1[c])), *W["w2"][1][c])
    out = y + x2
    take = lambda t_: torch.cat([t_[t, :nrows[t]] for t in range(tiles)]).reshape(N, A2, -1)
    if not res:
        return take(out)
    return take(out), take(m_out), take(l_out), take(AO)


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _random_weights(C, g):
    """chip_smoke.py's random block weights: N(0, 1 / fan-in), the
    LayerNorm affine 1 +- 0.2."""
    rnd = lambda *s_: torch.randn(*s_, generator=g)
    w = {n: rnd(*s_) / s_[0] ** 0.5 for n, s_ in (
        ("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)), ("w1", (C, 2 * C)),
        ("w2", (2 * C, C)))}
    w["ln"] = torch.stack([1 + 0.2 * rnd(C), 0.2 * rnd(C), 1 + 0.2 * rnd(C), 0.2 * rnd(C)])
    return w


def _inputs(C, A2, seed):
    """x [N, A2, C] with a last tile partly filled (9 pixels at least: at 3
    one q, k or v value that rounds to the other bf16 neighbour in one
    version moves enough of a pixel's bf16 attn values to decide attn's
    share of the distance), the PE and block 1's weights."""
    P = rg.RG_M // A2
    N = max(2 * P + 1, 9)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, A2, C).astype(np.float32))
    p = lft.init_params(seed, Args(channels=C, scale_factor=2), device="cpu")
    return x, torch.from_numpy(angular_position(A2, C)), ab.ang_weights(p, "altblock.1.ang_trans.")


def _exact(x, pe, wts, plan):
    """The plain version's function in float64 at its own rounding points."""
    d = lambda t: t.double()
    return ab.ang_block_plain(d(x), d(pe), {k: d(v) for k, v in wts.items()}, H, plan=plan)


@pytest.mark.parametrize("s", sorted(ROUNDED))
@pytest.mark.parametrize("A2", [9, 25, 81])
@pytest.mark.parametrize("C", [16, 32])
def test_ang_sites_scheme_matches_the_plain_version(C, A2, s):
    """The emulated kernel against the plain version under the mask: out and
    attn within MIXED_REL and MIXED_GAP of the plain mixed-vs-f32 distance,
    attn bf16 values exactly where `awo` rounds, m (the token's max in every
    slot) and l within STATS_L2; the `_res` form's out the forward's; out no
    further from float64 at the plain version's rounding points than the
    plain version, plus MIXED_GAP of its mixed-vs-f32 distance (the card's
    limit: a value rounded to bf16 after an f32 product in another order
    takes the other neighbour now and then)."""
    plan = _plan(ROUNDED[s])
    x, pe, wts = _inputs(C, A2, C + A2)
    got = _ang_sites(x, pe, wts, ROUNDED[s], res=True)
    ref = ab.ang_block_plain(x, pe, wts, H, with_res=True, plan=plan)
    ref32 = ab.ang_block_plain(x, pe, wts, H, with_res=True)
    for i in (0, 3):
        d, gap = _l2(got[i], ref[i]), _l2(ref32[i], ref[i])
        assert d <= MIXED_REL and d <= MIXED_GAP * gap, (i, d, gap)
    assert torch.equal(got[3], common.bf16_round(got[3])) == plan["awo"]
    assert _l2(got[1], ref[1]) <= STATS_L2 and _l2(got[2], ref[2]) <= STATS_L2
    assert torch.equal(got[1], got[1][..., :1].expand_as(got[1]))
    assert torch.equal(got[0], _ang_sites(x, pe, wts, ROUNDED[s]))
    exact = _exact(x, pe, wts, plan)
    assert _l2(got[0], exact) <= _l2(ref[0], exact) + MIXED_GAP * _l2(ref32[0], ref[0])


@pytest.mark.parametrize("s", ["s1", "s2"])
@pytest.mark.parametrize("A2", [81, 121])
def test_ang_sites_scheme_at_the_main_width(A2, s):
    """C = 64, the main path's width, on random weights and 64 pixels of the
    view counts where a query sees the most keys (chip_smoke.py's width
    checks): out within MIXED_REL and MIXED_GAP of the plain version, and
    no further from float64 at its rounding points than the plain version
    plus MIXED_GAP of its mixed-vs-f32 distance (the card's limit)."""
    C, N = 64, 64
    g = torch.Generator().manual_seed(A2 + len(s))
    wts = _random_weights(C, g)
    x = torch.randn(N, A2, C, generator=g)
    pe = torch.from_numpy(angular_position(A2, C))
    plan = _plan(ROUNDED[s])
    got = _ang_sites(x, pe, wts, ROUNDED[s])
    ref = ab.ang_block_plain(x, pe, wts, H, plan=plan)
    gap = _l2(ab.ang_block_plain(x, pe, wts, H), ref)
    d = _l2(got, ref)
    assert d <= MIXED_REL and d <= MIXED_GAP * gap, (d, gap)
    exact = _exact(x, pe, wts, plan)
    assert _l2(got, exact) <= _l2(ref, exact) + MIXED_GAP * gap


def test_ang_sites_f32_sites_keep_f32_accuracy():
    """Where every product site stays f32 and only the attention's two sites
    round or neither (a mask rounding `awo` alone, the scores and e v 3xTF32),
    the emulated kernel lies as close to float64 at the plain version's
    rounding points as the f32 plain version does to float64, within twice:
    3xTF32's products and the SFU's exp keep f32 accuracy."""
    C, A2 = 32, 25
    x, pe, wts = _inputs(C, A2, 5)
    for rounded in (("awo",), ("aqkv",)):
        plan = _plan(rounded)
        exact = _exact(x, pe, wts, plan)
        got, ref = _ang_sites(x, pe, wts, rounded), ab.ang_block_plain(x, pe, wts, H, plan=plan)
        assert _l2(got, exact) <= 2 * _l2(ref, exact), (rounded, _l2(got, exact), _l2(ref, exact))


@pytest.fixture(scope="module")
def k1ref(tmp_path_factory):
    """lft_tpu's K1 under S1 and S2 and in f32 (tests/_torch_sites_ref.py
    k1_s1, k1_s2), two processes at once."""
    d = tmp_path_factory.mktemp("ang_sites")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(os.path.dirname(__file__), "_torch_sites_ref.py")
    procs = {s: subprocess.Popen([sys.executable, script, str(d / f"{s}.npz"), f"k1_{s}"],
                                 env=env) for s in ("s1", "s2")}
    try:
        for s, proc in procs.items():
            assert proc.wait(timeout=600) == 0, s
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return {s: dict(np.load(d / f"{s}.npz")) for s in procs}


@pytest.mark.parametrize("s", ["s1", "s2"])
@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_emulated_res_block_matches_lft_tpu(k1ref, C, s):
    """The emulated `_res` kernel on test_torch_sites.py's K1 inputs against
    lft_tpu's `_core_fwd(with_res=True, mm_half=True)` under the subset: out,
    attn, m and l within MIXED_REL and MIXED_GAP of lft_tpu's mixed-vs-f32
    distance (test_torch_sites.py's `_mixed_close`)."""
    d = R.block_inputs(C)
    wts = ab.ang_weights(lft.params_from_numpy(d["params"], device="cpu"), R.ANG_PREFIX)
    x, pe = torch.from_numpy(d["k1_x"]), torch.from_numpy(angular_position(R.K1_SHAPE[1], C))
    assert frozenset(R.SUBSETS[s].split(",")) & frozenset(K1_SITES) == \
        frozenset(K1_SITES) - frozenset(ROUNDED[s])
    got = _ang_sites(x, pe, wts, ROUNDED[s], res=True)
    r = k1ref[s]
    for i, n in enumerate(("out", "m", "l", "attn")):
        want = r[f"k1_{C}_mixed_{n}"]
        dist, gap = _l2(got[i].numpy(), want), _l2(r[f"k1_{C}_f32_{n}"], want)
        assert dist <= MIXED_REL and (dist <= MIXED_GAP * gap or gap == 0 and dist <= 1e-5), \
            (n, dist, gap)


@pytest.mark.parametrize("s", sorted(ROUNDED))
@pytest.mark.parametrize("C", [16, 32, 64])
def test_ang_sites_weight_layout(C, s):
    """`ang_sites_stream` holds the weights of the sites that round as
    bf16 (`ang_bf16_weights_kernel`'s index formula at the plan's compacted
    offsets) and the others split hi / lo at the plan's stream offsets, in
    `ffn_sites_k` row order where their product's A comes from an
    accumulator (Wv, Wq, Wk, W1) and as they are for Wo and W2, as
    `ang_sites_weights_kernel` writes them (its formulas, repeated here)."""
    src = (CSRC / "ang_sites.cuh").read_text()
    for line in ("wb[p.bw[which] + ((k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 + k % 8] =",
                 "off = p.sw[which], pn = C, kr = which == 3 ? k : lrow(k), nc = n;",
                 "off = p.sw[4] + n / HC * (L::PW1 + L::PW2), pn = HC, kr = p.rows ? k : lrow(k), "
                 "nc = n % HC;",
                 "off = p.sw[4] + k / HC * (L::PW1 + L::PW2) + L::PW1, pn = C, kr = k % HC, nc = n;",
                 "const int at = off + (((kr / 8) * 4 + kr % 8 / 4) * (pn / 8) + nc / 8) * 32 + "
                 "nc % 8 * 4 +\n                   kr % 4;",
                 "ws[at + 8 * pn] = __uint_as_float(lo);",
                 "auto lrow = [](int r) { return 8 * (r / 8) + r % 8 % 2 * 4 + r % 8 / 2; };"):
        assert line in src, line
    mask = _mask(ROUNDED[s])
    wts = _random_weights(C, torch.Generator().manual_seed(C))
    p = rg.ang_sites_plan(C, mask)
    bf, st = rg.ang_sites_stream(wts, mask)
    hc = rg.hidden_chunk(C)
    lrow = lambda r: 8 * (r // 8) + r % 8 % 2 * 4 + r % 8 // 2
    got_bf, got_st = torch.zeros(bf.numel(), dtype=torch.bfloat16), torch.zeros(st.numel())
    for which, (n, site) in enumerate(rg.ANG_SITES_ORDER):
        Wn = wts[n]
        K, N = Wn.shape
        k, c = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
        if mask & common.SITE_BITS[site]:
            at = p["bw"][which] + ((k // 16 * 2 + k % 16 // 8) * (N // 8) + c // 8) * 64 \
                + c % 8 * 8 + k % 8
            got_bf[torch.from_numpy(at.reshape(-1))] = Wn.bfloat16().reshape(-1)
            continue
        lr = np.vectorize(lrow)
        if which < 4:
            off, pn, kr, nc = p["sw"][which], C, (k if n == "wo" else lr(k)), c
        elif n == "w1":
            off, pn, kr, nc = (p["sw"][4] + c // hc * 4 * C * hc, hc, k if p["rows"] else lr(k),
                               c % hc)
        else:
            off, pn, kr, nc = p["sw"][4] + k // hc * 4 * C * hc + 2 * C * hc, C, k % hc, c
        at = torch.from_numpy((off + (((kr // 8) * 4 + kr % 8 // 4) * (pn // 8) + nc // 8) * 32
                               + nc % 8 * 4 + kr % 4).reshape(-1))
        hi, lo = rg.split_tf32_rn(Wn.contiguous())
        got_st[at], got_st[at + 8 * pn] = hi.reshape(-1), lo.reshape(-1)
    assert torch.equal(got_bf, bf) and torch.equal(got_st, st)


def test_ang_sites_plan_mirrors_the_source():
    """`rowgemm.ang_sites_plan` is `ang_sites_plan` (ang_sites.cuh), line for
    line where it places things; every one of the 30 masks that rounds some
    of K1's sites and not others fits a block at every C, with three ring
    slots or more where it streams; the header's figures hold."""
    src = (CSRC / "ang_sites.cuh").read_text()
    for line in ("ALIGN = 32 * (C > HC ? C : HC);", "BF_FLOATS = 4 * SQ;",
                 "FLOATS = BF_FLOATS + 16 * SQ + 6 * ALIGN;", "LDB = C + 8, LDF = C + 4, LDH = HC + 4;",
                 "p.sw[i] = mask & site[i] ? -1 : up(s, L::ALIGN);",
                 "if (!(mask & site[i])) s = p.sw[i] + (i < 4 ? L::PS : L::NH * (L::PW1 + L::PW2));",
                 "p.rows = !(mask & S_AFFN) && !qb && L::LDF == L::LDH;",
                 "p.hid_kv = !(mask & S_AFFN) && !p.rows;",
                 "const int hbytes = p.hid_kv ? RG_M * L::LDH * 4 : 0;",
                 "const int tiles = up(qbytes + kv + (qb != ob ? RG_M * (ob ? row16 : row32) : 0) +",
                 "const int group_end[3] = {end[2], end[3], end[4]};",
                 "const int streams_after = group_end[g] < s ? 3 * slot : 0;",
                 "if (p.rbase + 4 * group_end[g] + tiles + streams_after > RG_SMEM_MAX) break;",
                 "p.rb = up(p.res, L::ALIGN);", "p.wbytes = p.rbase + 4 * p.res;",
                 "p.hid = p.k;", "p.ao = qb == ob ? p.q : o;",
                 "if (qb != ob) o += RG_M * (ob ? row16 : row32);",
                 "p.ring = up(o + L::ROWS * L::NG * 4, 16);",
                 "p.ns = s == p.res ? 0 : left < 8 ? left : 8;",
                 "p.bytes = p.ring + p.ns * slot;",
                 "if (p.bytes > RG_SMEM_MAX || (p.stream > p.res && p.ns < 3))"):
        assert line in src, line
    for C in (16, 32, 64):
        for bits in itertools.product((0, 1), repeat=5):
            if sum(bits) in (0, 5):
                continue
            p = rg.ang_sites_plan(C, _mask(s for s, b in zip(K1_SITES, bits) if b))
            assert p["bytes"] <= rg.RG_SMEM_MAX, (C, bits)
            assert p["stream"] == p["res"] or p["ns"] >= 3, (C, bits)
            assert p["stream"] + 4 * C * C <= rg.ang_sites_floats(C)
    s1, s2 = (rg.ang_sites_plan(64, _mask(ROUNDED[s])) for s in ("s1", "s2"))
    assert (s1["bytes"], s1["ns"], s1["res"], s1["stream"]) == (222208, 0, 24576, 24576)
    assert (s2["bytes"], s2["ns"], s2["res"], s2["stream"]) == (224320, 4, 8192, 40960)
    assert "S1 222,208 bytes (Wv-Wk resident, no ring), S2 224,320 (Wo resident, 4" in src


def test_ang_sites_items_write_only_their_own_queries():
    """The attention's items are ang_bf16.cuh's (every query and key once,
    tests/test_torch_ang_bf16.py); pass 2's output may lie over q because an
    item writes the rows and channels of its own valid queries, whose q no
    other item reads as a valid query: per head group, the valid query rows
    of the items are disjoint and each written row is one the item read."""
    src = (CSRC / "ang_sites.cuh").read_text()
    for line in ("grp = item % NG;", "base = item / NG / MT * A2;", "i0 = 16 * (item / NG % MT);",
                 "if (i >= A2) continue;", "const int items = np * MT * NG;"):
        assert line in src, line
    for NG in (1, 2, 4):
        for A2 in range(1, 129):
            P, MT = rg.RG_M // A2, -(-A2 // 16)
            owner = {}
            for item in range(P * MT * NG):
                grp, base, i0 = item % NG, item // NG // MT * A2, 16 * (item // NG % MT)
                for i in range(i0, min(i0 + 16, A2)):
                    assert (base + i, grp) not in owner
                    owner[base + i, grp] = item
            assert len(owner) == P * A2 * NG


@pytest.mark.parametrize("C", [16, 32, 64])
def test_ang_sites_tf32_lanes_take_each_head_once(C):
    """The 3xTF32 scores' A fragments (channels q4 and q4 + 4 of a chunk of
    8, `mine_tf`) hold each of a head's dh channels in exactly one slot of
    the quad, and no other head's."""
    src = (CSRC / "ang_sites.cuh").read_text()
    assert "auto mine_tf = [&](int e, int c) { return c / DH == e % HPC; };" in src
    assert "const bool on = mine_tf(hh, q4 + 4 * (i >> 1));" in src
    dh = C // H
    hpc = 8 // dh
    for e in range(H):
        chans = [8 * (e // hpc) + q4 + 4 * (i >> 1) for q4 in range(4) for i in (0, 2)
                 if (q4 + 4 * (i >> 1)) // dh == e % hpc]
        assert sorted(chans) == list(range(e * dh, (e + 1) * dh)), (e, chans)


def test_ang_sites_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors both `_sites` forms are their plain versions, bit for
    bit, and launch nothing."""
    x, pe, wts = _inputs(16, 25, 1)
    reset_launches()
    for s in ROUNDED:
        plan = _plan(ROUNDED[s])
        assert common.card_fwd(plan, "ang_block") == "_sites"
        assert torch.equal(ab.ang_block(x, pe, wts, H, plan=plan),
                           ab.ang_block_plain(x, pe, wts, H, plan=plan))
        assert all(torch.equal(a, b) for a, b in zip(
            ab.ang_block(x, pe, wts, H, with_res=True, plan=plan),
            ab.ang_block_plain(x, pe, wts, H, with_res=True, plan=plan)))
    assert sum(LAUNCHES.values()) == 0


def test_ang_sites_source_launches_every_c_entry():
    """The two C entries of the `_sites` forms launch ang_sites.cuh's kernel
    with their RES at every C (LFT_DISPATCH_C), it refuses a mask that
    rounds none or all of K1's sites, and K1's f32 kernel has no `_sites`
    path left."""
    src = (CSRC / "ang_block.cu").read_text()
    body = lambda n: src[src.index(f'extern "C" int {n}('):].split("\n}\n")[0]
    assert "LFT_ANG_SITES(false, nullptr, nullptr, nullptr)" in body("lft_ang_block_fwd_sites")
    assert "LFT_ANG_SITES(true, m, l, attn)" in body("lft_ang_block_fwd_res_sites")
    macro = src[src.index("#define LFT_ANG_SITES"):].split("\n\n")[0]
    assert "LFT_DISPATCH_C(C, {" in macro and "launch_ang_sites<CC, RES>(" in macro
    assert len(re.findall(r"launch_ang_sites<", src)) == 1
    assert "SITES" not in src[src.index("template <int C, int H, bool RES>"):
                              src.index("// ---- K4: the block's backward")]
    hdr = (CSRC / "ang_sites.cuh").read_text()
    assert "if (mask == 0 || mask == ANG_SITES) return static_cast<int>(cudaErrorInvalidValue);" \
        in hdr
    assert "constexpr int ANG_SITES = S_AQKV | S_ASCORE | S_AAV | S_AWO | S_AFFN;" in hdr
