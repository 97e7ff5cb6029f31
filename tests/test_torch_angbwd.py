"""K4 `ang_block_bwd` (its token-row steps a and c) and K3.d `spa_qkv_ln_bwd`
on the tensor cores (`lft_torch/csrc/ang_block.cu` and `csrc/rowbwd.cuh` on
`csrc/rowgemm.cuh`), on the CPU: their arithmetic, their weight streams
and their geometry.

The CUDA kernels cannot run here; their scheme can, as in
tests/test_torch_rowgemm.py and tests/test_torch_ffnbwd.py, whose
`_product_tails_first` (every product of these kernels issues its tail
MMAs first) repeats a row-tile product's 3xTF32 arithmetic from the
wrappers' own weight preparation (`kernels/rowgemm.py:ang_bwd_tok_stream`,
`qkv_ln_bwd_stream`, unpacked from their core-matrix layout), tile by tile
of 128 rows with zero pad rows:

* `_ang_bwd_tok` (K4 a): xn = LN1(x + pe), q, k, v, x2 = attn Wo + x (x
  added to the finished product), xn2 = LN2(x2), per hidden chunk hid,
  dpre and dxn2, dx2 = dout + LN2ᵀ(dxn2), dattn = dx2 Woᵀ, dsum per head,
  one row of LN2 sums a tile.
* `_qkv_ln_bwd` (K3.d at width D, K4 c at width C): p = dq Wqᵀ, dxn = p +
  dk Wkᵀ (finished products added), d = LN1ᵀ(dxn), dx = (dx2 + dv Wvᵀ) +
  d, one row of LN1 sums a tile.

Against float64 each output's error must be at most twice that of the f32
plain version (the kernels are held to the same on the card,
tests/test_torch_cuda.py, chip_smoke.py), and the K4 chain (a and c
emulated, b, wgrad and colsum plain) and the K3 chain with the emulated
step d must match `jax.vjp` of lft_tpu's fused blocks (interpret mode)
within 5e-4 max |ref|, the bound of tests/test_torch_train.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ffnbwd import _product_tails_first
from test_torch_reduce import _tf32
from test_torch_rowgemm import _pad, _tiles, _unpack

from lft_tpu.kernels.ang_block import ang_block_core
from lft_tpu.kernels.spa_block import spa_block_core
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import ang_block as ab
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.common import KERNEL_C
from lft_torch.kernels.wgrad import colsum_plain, wgrad_plain
from lft_torch.models import lft
from lft_torch.ops.posenc import angular_position, spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

CSRC = Path(rg.__file__).resolve().parent.parent / "csrc"
H = 8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ln(t, w, b):
    return torch.nn.functional.layer_norm(t, (t.shape[-1],), w, b, ab.LN_EPS)


def _pe_rows(pe, r0, rows):
    """pe [period, W] for tokens r0 .. r0 + rows - 1: row t % period."""
    return pe[torch.arange(r0, r0 + rows) % pe.shape[0]]


# ------------------------------------------------------ the kernels' scheme ---

def _tok_pieces(wts):
    """{(name, chunk): (hi, lo)} of K4 step a's stream, cut at the layout's
    offsets."""
    layout, _ = rg.ang_bwd_tok_layout(wts["wq"].shape[0])
    stream = rg.ang_bwd_tok_stream(wts)
    return {(n, j): _unpack(stream[off:off + 2 * K * N], K, N) for n, j, K, N, off in layout}


TOK_OUTPUTS = ("xn", "q", "k", "v", "xn2", "hid", "dpre", "dx2", "dattn", "dsum", "dln2")


def _ang_bwd_tok(x, pe, attn, dout, wts, tf32_only=False):
    """K4 step a in its kernel's arithmetic: token rows x, attn, dout [T, C],
    pe [A2, C] -> {TOK_OUTPUTS}, dsum [T, 8], dln2 [tiles, 2, C]. Every
    product tails first, the recomputation's too."""
    T, C = x.shape
    hc = rg.hidden_chunk(C)
    p = _tok_pieces(wts)
    fwd = bwd = lambda a, b, acc=None: _product_tails_first(a, b, acc, tf32_only)
    ln = wts["ln"]
    outs = {n: [] for n in TOK_OUTPUTS}
    for r0, r1 in _tiles(T, rg.RG_M):
        n = r1 - r0
        xt, at, do = _pad(x, r0, r1), _pad(attn, r0, r1), _pad(dout, r0, r1)
        xn = _ln(xt + _pe_rows(pe, r0, rg.RG_M), ln[0], ln[1])
        v, q, k = fwd(xt, p["wv", None]), fwd(xn, p["wq", None]), fwd(xn, p["wk", None])
        x2 = fwd(at, p["wo", None]) + xt
        xhat, rstd = ab.ln_stats(x2)
        xn2 = xhat * ln[2] + ln[3]
        dxn, hid, dpre = None, [], []
        for j in range(2 * C // hc):
            h = fwd(xn2, p["w1", j])
            hid.append(torch.relu(h))
            dpre.append(torch.where(h > 0, bwd(do, p["w2T", j]), 0.0))
            dxn = bwd(dpre[-1], p["w1T", j], dxn)
        dx2 = do + ab.ln_bwd(dxn, xhat, rstd, ln[2])
        dattn = bwd(dx2, p["woT", None])
        dsum = (dattn * at).reshape(-1, H, C // H).sum(-1)
        for name, t in zip(TOK_OUTPUTS, (xn, q, k, v, xn2, torch.cat(hid, 1), torch.cat(dpre, 1),
                                         dx2, dattn, dsum)):
            outs[name].append(t[:n])
        outs["dln2"].append(torch.stack([(dxn * xhat)[:n].sum(0), dxn[:n].sum(0)])[None])
    return {n: torch.cat(v) for n, v in outs.items()}


def _tok_plain(x, pe, attn, dout, wts):
    """Step a's function in plain PyTorch, in the dtype of its inputs."""
    ln = wts["ln"]
    xhat1, _ = ab.ln_stats(x + _pe_rows(pe, 0, x.shape[0]).to(x.dtype))
    xn = xhat1 * ln[0] + ln[1]
    x2 = attn @ wts["wo"] + x
    xhat2, rstd2 = ab.ln_stats(x2)
    xn2 = xhat2 * ln[2] + ln[3]
    hid = torch.relu(xn2 @ wts["w1"])
    dpre = torch.where(hid > 0, dout @ wts["w2"].t(), 0.0)
    dxn2 = dpre @ wts["w1"].t()
    dx2 = dout + ab.ln_bwd(dxn2, xhat2, rstd2, ln[2])
    dattn = dx2 @ wts["wo"].t()
    C = x.shape[1]
    return dict(xn=xn, q=xn @ wts["wq"], k=xn @ wts["wk"], v=x @ wts["wv"], xn2=xn2, hid=hid,
                dpre=dpre, dx2=dx2, dattn=dattn, dsum=(dattn * attn).reshape(-1, H, C // H).sum(-1),
                dln2=torch.stack([(dxn2 * xhat2).sum(0), dxn2.sum(0)])[None])


def _qkv_ln_bwd(x, pe, dq, dk, dv, dx2, g, wq, wk, wv, tf32_only=False):
    """K3.d / K4 c in the kernel's arithmetic over token rows [T, W] (pe
    [period, W], token t's row t % period; g: LN1's weight; wq, wk, wv the
    forward's W x W weights) -> (dx, dxpe, dln [tiles, 2, W])."""
    T, W = x.shape
    stream = rg.qkv_ln_bwd_stream(wq, wk, wv)
    sq = 2 * W * W
    pq, pk, pv = (_unpack(stream[i * sq:(i + 1) * sq], W, W) for i in range(3))
    prod = lambda a, b: _product_tails_first(a, b, None, tf32_only)
    outs = [[], [], []]
    for r0, r1 in _tiles(T, rg.RG_M):
        n = r1 - r0
        dxn = prod(_pad(dq, r0, r1), pq) + prod(_pad(dk, r0, r1), pk)
        xhat, rstd = ab.ln_stats(_pad(x, r0, r1) + _pe_rows(pe, r0, rg.RG_M))
        d = ab.ln_bwd(dxn, xhat, rstd, g)
        dx = (_pad(dx2, r0, r1) + prod(_pad(dv, r0, r1), pv)) + d
        outs[0].append(dx[:n])
        outs[1].append(d[:n])
        outs[2].append(torch.stack([(dxn * xhat)[:n].sum(0), dxn[:n].sum(0)])[None])
    return tuple(torch.cat(o) for o in outs)


def _attn_bwd(q, k, v, dattn, dsum, m, l, N, A2):
    """K4 step b in plain PyTorch (the kernel runs it on the FP32 pipes)
    from step a's q, k, v, dattn, dsum: (dq, dk, dv) [T, C]."""
    C = q.shape[1]
    scale = float(C // H) ** -0.5
    heads = lambda t: ab._heads(t.reshape(N, A2, C), H)
    qh, kh, vh, doh = heads(q) * scale, heads(k), heads(v), heads(dattn)
    p = torch.exp(qh @ kh.transpose(-1, -2) - m.transpose(1, 2)[..., None]) \
        / l.transpose(1, 2)[..., None]
    ds = p * (doh @ vh.transpose(-1, -2) - dsum.reshape(N, A2, H).transpose(1, 2)[..., None])
    tok = lambda t: ab._merge(t).reshape(N * A2, C)
    return tok(ds @ kh) * scale, tok(ds.transpose(-1, -2) @ qh), tok(p.transpose(-1, -2) @ doh)


def _ang_bwd_ops(x, pe, wts, m, l, attn, dout, num_heads):
    """K4 with steps a and c emulated and step b plain: the outputs of
    `ang_block_bwd_ops`, dln [tiles, 4, C] (c's LN1 rows 0-1, a's LN2 rows
    2-3)."""
    N, A2, C = x.shape
    rows = lambda t: t.reshape(N * A2, C)
    a = _ang_bwd_tok(rows(x), pe, rows(attn), rows(dout), wts)
    dq, dk, dv = _attn_bwd(a["q"], a["k"], a["v"], a["dattn"], a["dsum"], m, l, N, A2)
    dx, _, dln1 = _qkv_ln_bwd(rows(x), pe, dq, dk, dv, a["dx2"], wts["ln"][0], wts["wq"],
                              wts["wk"], wts["wv"])
    return (dx.reshape(N, A2, C), a["xn"], dq, dk, dv, a["dx2"], a["xn2"], a["dpre"], a["hid"],
            torch.cat([dln1, a["dln2"]], 1))


# ----------------------------------------------------------------- inputs ---

def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _ang_weights(rng, C):
    """A block's scales: weights ~ fan_in^-1/2, LayerNorm affines near (1, 0)."""
    w = lambda k, n: k ** -0.5 * _rand(rng, k, n)
    return dict(wq=w(C, C), wk=w(C, C), wv=w(C, C), wo=w(C, C), w1=w(C, 2 * C), w2=w(2 * C, C),
                ln=torch.stack([1 + 0.1 * _rand(rng, C), 0.1 * _rand(rng, C),
                                1 + 0.1 * _rand(rng, C), 0.1 * _rand(rng, C)]))


def _calm(dout, *hids):
    """dout zero on the tokens where an FFN ReLU is on in one version and
    off in another (its input within rounding of 0): dpre jumps there by
    design, not by the arithmetic."""
    flips = torch.zeros(dout.shape[0], dtype=torch.bool)
    for h in hids[1:]:
        flips |= ((h > 0) != (hids[0] > 0)).any(-1)
    assert int(flips.sum()) <= 3, int(flips.sum())
    return torch.where(flips[:, None], 0.0, dout)


def _tok_case(C, seed, T=300, A2=25):
    rng = np.random.RandomState(seed)
    wts = _ang_weights(rng, C)
    x, attn, dout = _rand(rng, T, C), 0.3 * _rand(rng, T, C), _rand(rng, T, C)
    pe = torch.from_numpy(angular_position(A2, C))
    w64 = {k: v.double() for k, v in wts.items()}
    dout = _calm(dout, _ang_bwd_tok(x, pe, attn, dout, wts)["hid"],
                 _tok_plain(x, pe, attn, dout, wts)["hid"],
                 _tok_plain(x.double(), pe.double(), attn.double(), dout.double(), w64)["hid"])
    return wts, w64, x, pe, attn, dout


def _qkv_case(kind, C, seed, T=300):
    """Step d of K3 (width D = 2C, pe_tok over 10 x 12 pixels) or step c of
    K4 (width C, pe over 25 views), at a block's scales: (wts of
    qkv_ln_bwd_plain, x, pe, dq, dk, dv, dx2)."""
    rng = np.random.RandomState(seed)
    W = 2 * C if kind == "K3.d" else C
    period = 120 if kind == "K3.d" else 25
    w = lambda: W ** -0.5 * _rand(rng, W, W)
    wts = dict(wqk=torch.cat([w(), w()], 1), wv=w(),
               ln=torch.stack([1 + 0.1 * _rand(rng, W), 0.1 * _rand(rng, W)]))
    return (wts, _rand(rng, T, W), _rand(rng, period, W), 0.5 * _rand(rng, T, W),
            0.5 * _rand(rng, T, W), 0.5 * _rand(rng, T, W), _rand(rng, T, W))


def _qkv_plain(wts, x, pe, dq, dk, dv, dx2):
    """qkv_ln_bwd_plain over token rows, pe broadcast as t % period."""
    return sb.qkv_ln_bwd_plain(x, _pe_rows(pe, 0, x.shape[0]).to(x.dtype), dq, dk, dv, dx2, wts)


def _qkv_emulated(wts, x, pe, dq, dk, dv, dx2, tf32_only=False):
    W = x.shape[1]
    return _qkv_ln_bwd(x, pe, dq, dk, dv, dx2, wts["ln"][0], wts["wqk"][:, :W], wts["wqk"][:, W:],
                       wts["wv"], tf32_only)


# ------------------------------------------------------------ arithmetic ---

@pytest.mark.parametrize("C", KERNEL_C)
def test_ang_bwd_tok_3xtf32_scheme_keeps_f32_accuracy(C):
    """K4 step a's eleven products in the kernel's arithmetic at a block's
    scales, T = 300 (a ragged last tile): every output within twice the f32
    plain version's error against float64 (the LN2 sums over their per-tile
    rows), and within 5e-4 max |plain| of the plain version; with one TF32
    product a term dattn misses by more than 10x."""
    wts, w64, x, pe, attn, dout = _tok_case(C, C)
    got = _ang_bwd_tok(x, pe, attn, dout, wts)
    assert got["dln2"].shape == (3, 2, C)
    got["dln2"] = got["dln2"].sum(0, keepdim=True)
    ref = _tok_plain(x, pe, attn, dout, wts)
    exact = _tok_plain(x.double(), pe.double(), attn.double(), dout.double(), w64)
    for name in TOK_OUTPUTS:
        g, r, e = got[name], ref[name], exact[name]
        assert g.shape == r.shape, name
        e_3x, e_f32 = _err(g, e), _err(r, e)
        assert e_3x <= 2 * e_f32 + 1e-12, (name, e_3x, e_f32)
        assert _err(g, r.double()) <= 5e-4 * float(r.abs().max()), name
    tf32 = _ang_bwd_tok(x, pe, attn, dout, wts, tf32_only=True)
    assert _err(tf32["dattn"], exact["dattn"]) > 10 * _err(ref["dattn"], exact["dattn"])


QKV_CASES = [(kind, C) for kind in ("K3.d", "K4 c") for C in KERNEL_C]


@pytest.mark.parametrize("kind,C", QKV_CASES)
def test_qkv_ln_bwd_3xtf32_scheme_keeps_f32_accuracy(kind, C):
    """K3.d (width 2C) and K4's step c (width C), one kernel: its three
    products in the kernel's arithmetic at a block's scales, T = 300: dx,
    dxpe and the LN1 sums within twice the f32 plain version's error
    against float64 and within 5e-4 max |plain| of it; with one TF32
    product a term dx misses by more than 10x."""
    case = _qkv_case(kind, C, 7 * C + len(kind))
    got = list(_qkv_emulated(*case))
    assert got[2].shape == (3, 2, case[1].shape[1])
    got[2] = got[2].sum(0, keepdim=True)
    ref = _qkv_plain(*case)
    exact = _qkv_plain({k: v.double() for k, v in case[0].items()}, *(t.double() for t in case[1:]))
    for name, g, r, e in zip(("dx", "dxpe", "dln1"), got, ref, exact):
        assert g.shape == r.shape, name
        e_3x, e_f32 = _err(g, e), _err(r, e)
        assert e_3x <= 2 * e_f32 + 1e-12, (name, e_3x, e_f32)
        assert _err(g, r.double()) <= 5e-4 * float(r.abs().max()), name
    tf32 = _qkv_emulated(*case, tf32_only=True)
    assert _err(tf32[0], exact[0]) > 10 * _err(ref[0], exact[0])


@pytest.mark.parametrize("T", [1, 127, 128, 129, 700])
def test_ln_sums_one_row_a_tile(T):
    """K4 a's LN2 sums and the LN1 sums of K3.d / K4 c come as one row a
    128-row tile, ceil(T / 128) rows whatever the card (`ang_bwd_tiles`,
    `ffn_out_bwd_tiles`), and summed they are the plain version's."""
    tiles = -(-T // 128)
    assert ab.ang_bwd_tiles(T) == sb.ffn_out_bwd_tiles(T) == tiles
    wts, _, x, pe, attn, dout = _tok_case(16, T, T)
    got = _ang_bwd_tok(x, pe, attn, dout, wts)["dln2"]
    ref = _tok_plain(x, pe, attn, dout, wts)["dln2"]
    assert got.shape == (tiles, 2, 16)
    torch.testing.assert_close(got.sum(0, keepdim=True), ref,
                               atol=1e-5 * float(ref.abs().max()), rtol=0)
    case = _qkv_case("K3.d", 16, T, T)
    got = _qkv_emulated(*case)[2]
    ref = _qkv_plain(*case)[2]
    assert got.shape == (tiles, 2, 32)
    torch.testing.assert_close(got.sum(0, keepdim=True), ref,
                               atol=1e-5 * float(ref.abs().max()), rtol=0)


# -------------------------------------------------------------- streams ---

def _expect_pieces(stream, layout, mats, hc):
    """Each (name, chunk, K, N, off) piece of the stream holds its matrix's
    TF32 hi and lo (both rounded to nearest) at (kk, part, kh, j, n, t) =
    B[8 kk + 4 kh + t][8 j + n], starts at a multiple of its 16-of-K chain,
    and the pieces tile the stream without gaps."""
    used = torch.zeros(stream.numel(), dtype=torch.bool)
    for name, j, K, N, off in layout:
        B = mats[name]
        if j is not None:
            B = B[:, j * hc:(j + 1) * hc] if name in ("w1", "w2T") else B[j * hc:(j + 1) * hc]
        assert tuple(B.shape) == (K, N), name
        assert off % (32 * N) == 0 and rg.RG_SF % (32 * N) == 0
        f = stream[off:off + 2 * K * N].reshape(K // 8, 2, 2, N // 8, 8, 4)
        hi = _tf32(B.contiguous())
        parts = torch.stack([hi, _tf32(B - hi)])
        kk, part, kh, jj, n, t = np.meshgrid(*(np.arange(d) for d in f.shape), indexing="ij")
        assert torch.equal(f, parts[part, 8 * kk + 4 * kh + t, 8 * jj + n]), name
        assert not used[off:off + 2 * K * N].any()
        used[off:off + 2 * K * N] = True
    assert used.all()


@pytest.mark.parametrize("C", KERNEL_C)
def test_ang_bwd_tok_stream_core_matrix_layout(C):
    """K4 a's stream holds Wv, Wq, Wk, Wo, per hidden chunk W1[:, c],
    W2ᵀ[:, c] and W1ᵀ[c, :], then Woᵀ, each its matrix's hi and lo in the
    core-matrix layout, with no gap (22 C^2 floats); step c's Wqᵀ, Wkᵀ, Wvᵀ
    likewise, after it in K4's scratch."""
    rng = np.random.RandomState(60 + C)
    wts = _ang_weights(rng, C)
    hc = rg.hidden_chunk(C)
    layout, floats = rg.ang_bwd_tok_layout(C)
    stream = rg.ang_bwd_tok_stream(wts)
    assert stream.numel() == floats == rg.ang_bwd_tok_floats(C) == 22 * C * C
    mats = dict(wv=wts["wv"], wq=wts["wq"], wk=wts["wk"], wo=wts["wo"], w1=wts["w1"],
                w2T=wts["w2"].t(), w1T=wts["w1"].t(), woT=wts["wo"].t())
    _expect_pieces(stream, layout, mats, hc)
    nh = 2 * C // hc
    assert [n for n, *_ in layout] == ["wv", "wq", "wk", "wo"] + ["w1", "w2T", "w1T"] * nh + ["woT"]
    qkv = rg.qkv_ln_bwd_stream(wts["wq"], wts["wk"], wts["wv"])
    sq = 2 * C * C
    _expect_pieces(qkv, [("wqT", None, C, C, 0), ("wkT", None, C, C, sq), ("wvT", None, C, C, 2 * sq)],
                   dict(wqT=wts["wq"].t(), wkT=wts["wk"].t(), wvT=wts["wv"].t()), hc)
    assert rg.ang_bwd_floats(C) == floats + qkv.numel() == 28 * C * C
    assert rg.qkv_ln_bwd_floats(2 * C) == 6 * (2 * C) ** 2


def _rg_piece(src: torch.Tensor, off: int, ld: int, K: int, N: int, tr: int) -> torch.Tensor:
    """The K x N matrix rg_weights_kernel reads for RgPiece{src + off, ld, K,
    N, _, tr} from a weight's flat memory: B[k][n] = src[off + k ld + n], or
    with tr src[off + n ld + k]."""
    k, n = torch.meshgrid(torch.arange(K), torch.arange(N), indexing="ij")
    return src.reshape(-1)[off + (n * ld + k if tr else k * ld + n)]


@pytest.mark.parametrize("C", KERNEL_C)
def test_launch_pieces_read_the_streams_matrices(C):
    """The RgPiece lines of K4's and K3.d's launches (ang_block.cu,
    rowbwd.cuh, spa_block_bwd.cu), read as rg_weights_kernel reads them
    (`tr`: transposed from the forward's weight, no copy), are the matrices
    of `ang_bwd_tok_pieces` and `qkv_ln_bwd_stream`."""
    rng = np.random.RandomState(80 + C)
    wts = _ang_weights(rng, C)
    hc = rg.hidden_chunk(C)
    want = rg.ang_bwd_tok_pieces(wts)
    got = [_rg_piece(wts[n], 0, C, C, C, 0) for n in ("wv", "wq", "wk", "wo")]
    for j in range(2 * C // hc):
        got += [_rg_piece(wts["w1"], j * hc, 2 * C, C, hc, 0),
                _rg_piece(wts["w2"], j * hc * C, C, C, hc, 1),
                _rg_piece(wts["w1"], j * hc, 2 * C, hc, C, 1)]
    got.append(_rg_piece(wts["wo"], 0, C, C, C, 1))
    assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    D = 2 * C
    wqk, wv = _rand(rng, D, 2 * D), _rand(rng, D, D)
    assert torch.equal(torch.cat([rg.piece(_rg_piece(wqk, 0, 2 * D, D, D, 1)),
                                  rg.piece(_rg_piece(wqk, D, 2 * D, D, D, 1)),
                                  rg.piece(_rg_piece(wv, 0, D, D, D, 1))]),
                       rg.qkv_ln_bwd_stream(wqk[:, :D], wqk[:, D:], wv))
    src = (CSRC / "ang_block.cu").read_text()
    for line in ("RgPiece{wv, C, C, C, L::OFF_V, 0};", "RgPiece{wq, C, C, C, L::OFF_Q, 0};",
                 "RgPiece{wk, C, C, C, L::OFF_K, 0};", "RgPiece{wo, C, C, C, L::OFF_O, 0};",
                 "RgPiece{w1 + j * L::HC, 2 * C, C, L::HC, off, 0};",
                 "RgPiece{w2 + j * L::HC * C, C, C, L::HC, off + L::PC, 1};",
                 "RgPiece{w1 + j * L::HC, 2 * C, L::HC, C, off + 2 * L::PC, 1};",
                 "RgPiece{wo, C, C, C, L::OFF_OT, 1};",
                 "launch_qkv_ln_bwd<C, BF, IO>(a, wq, wk, C, wv, wf + L::FLOATS, s);"):
        assert line in src, line
    hdr = (CSRC / "rowbwd.cuh").read_text()
    for line in ("ps.p[0] = RgPiece{wq, ldqk, W, W, 0, 1};",
                 "ps.p[1] = RgPiece{wk, ldqk, W, W, Q::SQ, 1};",
                 "ps.p[2] = RgPiece{wv, W, W, W, 2 * Q::SQ, 1};"):
        assert line in hdr, line
    assert "launch_qkv_ln_bwd<D, BF, IO>(a, wqk, wqk + D, 2 * D, wv, wf, s);" in \
        (CSRC / "spa_block_bwd.cu").read_text()
    assert "(pc.tr ? static_cast<size_t>(n) * pc.ld + k" in (CSRC / "rowgemm.cuh").read_text()


# -------------------------------------------------------------- geometry ---

@pytest.mark.parametrize("C", KERNEL_C)
def test_smem_fits(C):
    """K4 a's rows, LN2 sums and at least five ring slots fit in a block's
    shared memory (232,448 bytes), 16-byte aligned; K3.d / K4 c hold all
    three weights and row tiles at W <= 64 (one pass) and one of each at W
    = 128 (three passes); step b's pixels fit at every A2 <= 128."""
    tiles = (rg.RG_M * (3 * (C + 4) + rg.hidden_chunk(C) + 4) + 16 * C) * 4
    slots = rg.ring_slots(tiles + 16 * 8)
    assert tiles % 16 == 0 and slots >= 5
    assert rg.ang_bwd_tok_smem(C) == tiles + slots * rg.RG_SF * 4 + 2 * slots * 8 <= rg.RG_SMEM_MAX
    for W in (C, 2 * C):
        passes = rg.qkv_ln_bwd_passes(W)
        held = 3 if passes == 1 else 1
        assert passes == (1 if W <= 64 else 3)
        assert rg.qkv_ln_bwd_smem(W) == (held * (2 * W * W + 128 * (W + 4)) + 16 * W) * 4
        assert rg.qkv_ln_bwd_smem(W) <= rg.RG_SMEM_MAX
    for A2 in range(1, 129):
        P = ab.ang_bwd_attn_pixels(A2)
        assert P >= 1 and (P == 1 or P * 8 * A2 <= 256) and (P + 1) * 8 * A2 > 256
        assert P * A2 * (4 * (C + 4) + 3 * 8) * 4 <= rg.RG_SMEM_MAX


def test_python_geometry_mirrors_the_source():
    """rowgemm.py's and ang_block.py's layout and sizes for K4 and K3.d are
    AngBwdTok's (ang_block.cu) and QkvLnBwd's (rowbwd.cuh); K4 a runs every
    product tails first (the recomputation's too), adds x to the finished
    product and takes K1's LayerNorms (quad_ln); K3.d and K4 c are one
    kernel; no product of either runs gemm_acc, and the one-kernel K4 of
    64-row blocks is gone."""
    ang = (CSRC / "ang_block.cu").read_text()
    for line in ("HC = 2 * C < 64 ? 2 * C : 64;", "SQ = 2 * C * C;", "PC = 2 * C * HC;",
                 "OFF_V = 0, OFF_Q = SQ, OFF_K = 2 * SQ, OFF_O = 3 * SQ, OFF_F = 4 * SQ;",
                 "OFF_OT = OFF_F + NH * 3 * PC;", "FLOATS = OFF_OT + SQ;",
                 "TILES = (RG_M * (3 * LD + LDH) + 16 * C) * 4;",
                 "NS = rg_slots(TILES + 16 * 8);",
                 "BYTES = TILES + static_cast<size_t>(NS) * RG_SF * 4 + 2 * NS * 8;",
                 "MbarRing<L::NS> ring;",
                 "off = L::OFF_F + j * 3 * L::PC;",
                 "rg_product<C, C, L::OFF_V, true, BF>(a, xw, LD, ring, st);",
                 "rg_product<C, C, L::OFF_Q, true, BF>(a, nw, LD, ring, st);",
                 "rg_product<C, C, L::OFF_K, true, BF>(a, nw, LD, ring, st);",
                 "rg_product<C, C, L::OFF_O, true, BF>(a, nw, LD, ring, st);",
                 "rg_product<C, HC, off, true, BF>(hc, nw, LD, ring, st);",
                 "rg_product<C, HC, off + L::PC, true, BF>(hc, dw, LD, ring, st);",
                 "rg_product<HC, C, off + 2 * L::PC, true, BF>(dxn, hw, LDH, ring, st);",
                 "rg_product<C, C, L::OFF_OT, true, BF>(a, xw, LD, ring, st);",
                 "quad_ln<C>(a, ln, ln + C);",
                 "quad_ln<C, true>(a, ln + 2 * C, ln + 3 * C, mu, rstd);",
                 "tile_ln_sums<C>(part, ln_part + static_cast<size_t>(tile) * 4 * C + 2 * C);",
                 "inline int attn_pixels(int A2) { return NT / (8 * A2) > 1 ? NT / (8 * A2) : 1; }",
                 "g.ln_part, A2, 4 * C, T};"):
        assert line in ang, line
    a = ang.split("ang_bwd_tok_kernel(", 1)[1].split("// b. P pixels", 1)[0]
    assert a.index("v0 = io_round<IO>(io_round<IO>(v0) + xv.x);") < a.index("quad_ln<C, true>")
    assert not re.search(r"rg_product<[^>]*[^e]>\(", a.replace(", BF>", ">")), \
        "every product of K4 a tails first"
    assert not re.search(r"\bgemm_acc\b", ang)
    assert "ang_block_bwd_kernel" not in ang and "lft_ang_block_bwd128" not in ang
    hdr = (CSRC / "rowbwd.cuh").read_text()
    for line in ("SQ = 2 * W * W;", "FLOATS = 3 * SQ;",
                 "ONE = (3 * SQ + 3 * RG_M * LDX + 16 * W) * 4 <= RG_SMEM_MAX;",
                 "BYTES = (NW * static_cast<size_t>(SQ) + NW * RG_M * LDX + 16 * W) * 4;",
                 "rg_product<W, W, 0, true, BF>(p, rw(0), LDX, wr, st);",
                 "rg_product<W, W, 0, true, BF>(acc, rw(S1), LDX, wr, st);",
                 "rg_product<W, W, 0, true, BF>(acc, rw(S2), LDX, wr, st);",
                 "acc[pp][i] = u.x + acc[pp][i];",
                 "stcs2(a.dx + at, (u.x + acc[pp][i]) + d.x, (u.y + acc[pp][i + 1]) + d.y);"):
        assert line in hdr, line
    assert not re.search(r"\bgemm_acc\b", hdr)
    bwd = (CSRC / "spa_block_bwd.cu").read_text()
    d = bwd.split("int qkv_ln_bwd(", 1)[1].split("template <bool BF>", 1)[0]
    assert "hw, 2 * D, T};" in d and not re.search(r"\bgemm_acc\b", d)
    assert "spa_qkv_ln_bwd_kernel" not in bwd
    assert not (CSRC / "bwd.cuh").exists()
    for C in KERNEL_C:
        hc = rg.hidden_chunk(C)
        assert rg.ang_bwd_tok_floats(C) == 4 * 2 * C * C + 3 * (2 * C // hc) * 2 * C * hc + 2 * C * C


# -------------------------------------------------------------- wrappers ---

def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors K4's and K3.d's wrappers are their plain versions, bit
    for bit, and launch nothing."""
    rng = np.random.RandomState(5)
    C, N, A2 = 16, 6, 25
    wts = _ang_weights(rng, C)
    x, dout = _rand(rng, N, A2, C), _rand(rng, N, A2, C)
    pe = torch.from_numpy(angular_position(A2, C))
    _, m, l, attn = ab.ang_block_plain(x, pe, wts, H, with_res=True)
    reset_launches()
    got = ab.ang_block_bwd_ops(x, pe, wts, m, l, attn, dout, H)
    ref = ab.ang_block_bwd_ops_plain(x, pe, wts, m, l, attn, dout, H)
    assert len(got) == len(ref) == 10 and all(torch.equal(u, v) for u, v in zip(got, ref))
    D = 2 * C
    wd = dict(wqk=_rand(rng, D, 2 * D), wv=_rand(rng, D, D), ln=_rand(rng, 4, D))
    tok, pe_tok = _rand(rng, 2, 5, 6, D), _rand(rng, 5, 6, D)
    g = [_rand(rng, 2, 5, 6, D) for _ in range(4)]
    got = sb.qkv_ln_bwd(tok, pe_tok, *g, wd)
    ref = sb.qkv_ln_bwd_plain(tok, pe_tok, *g, wd)
    assert len(got) == len(ref) == 3 and all(torch.equal(u, v) for u, v in zip(got, ref))
    assert sum(LAUNCHES.values()) == 0


# ---------------------------------------------------------- chains vs JAX ---

def _np_params(seed, channels):
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, 2).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


@pytest.mark.parametrize("A2,N", [(4, 37), (25, 13), (81, 5)])
def test_ang_bwd_chain_with_emulated_steps_matches_jax_vjp(monkeypatch, A2, N):
    """K4 with steps a and c emulated and step b, wgrad and colsum plain
    (`ang_block._bwd`) against jax.vjp of lft_tpu's fused AngTrans block
    (interpret mode), from K1's residuals: every gradient within 5e-4 max
    |ref| (tests/test_torch_train.py's bound); at A2 = 4 a block of step b
    takes 8 pixels, at 81 the old 128-row form's geometry."""
    monkeypatch.setenv("LFT_ANGB_GPS", "2")
    monkeypatch.setenv("LFT_ANGB_BWD_GPS", "2")
    C = 16
    p = lft.params_from_numpy(_np_params(11 + A2, C), device="cpu")
    wts = ab.ang_weights(p, "altblock.2.ang_trans.")
    rng = np.random.RandomState(A2)
    x = ((rng.rand(N, A2, C) - 0.5) * 2).astype(np.float32)
    dout = ((rng.rand(N, A2, C) - 0.5) * 2).astype(np.float32)
    pe = angular_position(A2, C)
    order = ab.WEIGHTS
    _, vjp = jax.vjp(lambda x_, *w: ang_block_core(x_, jnp.asarray(pe), *w, H), jnp.asarray(x),
                     *(jnp.asarray(wts[n].numpy()) for n in order))
    ref = vjp(jnp.asarray(dout))
    xt, pet = torch.from_numpy(x), torch.from_numpy(pe)
    _, m, l, attn = ab.ang_block_plain(xt, pet, wts, H, with_res=True)
    got = ab._bwd(_ang_bwd_ops, wgrad_plain, colsum_plain, xt, pet, wts, m, l, attn,
                  torch.from_numpy(dout), H)
    for name, g, r in zip(("x",) + order, got, ref):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 5e-4 * float(np.abs(r).max()), (name, err)


def _emulated_step_d(tok, pe_tok, dq, dk, dv, dx2, wts):
    D = tok.shape[-1]
    rows = lambda t: t.reshape(-1, D)
    dtok, dtokpe, dln1 = _qkv_ln_bwd(rows(tok), rows(pe_tok), rows(dq), rows(dk), rows(dv),
                                     rows(dx2), wts["ln"][0], wts["wqk"][:, :D], wts["wqk"][:, D:],
                                     wts["wv"])
    return dtok.reshape(tok.shape), dtokpe.reshape(tok.shape), dln1


@pytest.mark.parametrize("C,V,h,w", [(16, 3, 8, 8), (32, 2, 9, 7)])
def test_spa_bwd_chain_with_emulated_step_d_matches_jax_vjp(C, V, h, w):
    """K3 with the emulated step d and the other steps plain (K3.a-c, e,
    wgrad, colsum) against jax.vjp of lft_tpu's fused SpaTrans block
    (interpret mode): every gradient, dpe_tok included, within 5e-4 max
    |ref|."""
    np_p = _np_params(6 + C, C)
    p = lft.params_from_numpy(np_p, device="cpu")
    prefix = "altblock.1.spa_trans."
    wts = sb.spa_weights(p, prefix)
    rng = np.random.RandomState(C + w)
    x = ((rng.rand(V, h, w, C) - 0.5) * 2).astype(np.float32)
    dout = ((rng.rand(V, h, w, C) - 0.5) * 2).astype(np.float32)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              p[prefix + "MLP.weight"])[0].contiguous()
    order = sb.WEIGHTS
    _, vjp = jax.vjp(lambda x_, pe_, *w_: spa_block_core(x_, pe_, *w_, 8, 5), jnp.asarray(x),
                     jnp.asarray(pe_tok.numpy()), *(jnp.asarray(wts[n].numpy()) for n in order))
    ref = vjp(jnp.asarray(dout))
    xt = torch.from_numpy(x)
    _, tok, m, l, attn = sb.spa_block_plain(xt, pe_tok, wts, 8, 5, with_res=True)
    steps = (*sb._PLAIN_STEPS[:3], _emulated_step_d, *sb._PLAIN_STEPS[4:])
    got = sb._bwd(steps, xt, pe_tok, sb._with_mlp(wts), tok, m, l, attn, torch.from_numpy(dout),
                  8, 5)
    for name, g, r in zip(("x", "pe_tok") + order, got, ref):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 5e-4 * float(np.abs(r).max()), (name, err)
