"""The projection steps of the fused SpaTrans block on the tensor cores
(K2.2 `spa_qkv`, K2.4 `spa_outproj_ln`; `lft_torch/csrc/spa_block.cu` on
`csrc/rowgemm.cuh`), on the CPU: their arithmetic, their weight streams and
their geometry.

The CUDA kernels cannot run here; their scheme can, as in
tests/test_torch_rowgemm.py, whose `_product` repeats a row-tile product's
3xTF32 arithmetic from the wrapper's own weight preparation
(`kernels/rowgemm.py:qkv_stream`, `outproj_stream`). `_qkv` runs K2.2's
three products as the kernel's three passes, tile by tile of 128 rows with
zero pad rows; `_outproj_ln` adds tok to the finished product in f32, as
K2.4 does, then LN2.
Against float64 the emulation's error must be at most twice that of the f32
plain version, and the K2 chain with the emulated steps 2, 4 and 5 must
match lft_tpu's fused SpaTrans block (interpret mode) within 1e-4. The
kernels are held to the same bounds on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reduce import _spread, _tf32
from test_torch_rowgemm import _ffn_out, _pieces, _product, _tiles

from lft_tpu.config import Args as JArgs
from lft_tpu.kernels import spa_block as j_spa
from lft_tpu.models import lft as j_lft
from lft_tpu.ops.posenc import spatial_position
from lft_tpu.ops.unfold import unfold3x3_linear as j_unfold3x3_linear
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.common import KERNEL_C
from lft_torch.models.lft import params_from_numpy
from lft_torch.ops.unfold import unfold3x3_linear

CSRC = Path(rg.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rows(t, r0, r1):
    """Rows [r0, r1) of t in a 128-row tile, zero pad rows."""
    out = torch.zeros(rg.RG_M, t.shape[1])
    out[:r1 - r0] = t[r0:r1]
    return out


def _pass(a, p, tf32_only=False):
    """One pass of K2.2: a [T, D] rows times the piece p, tile by tile."""
    return torch.cat([_product(_rows(a, r0, r1), p, tf32_only=tf32_only)[:r1 - r0]
                      for r0, r1 in _tiles(a.shape[0], rg.RG_M)])


def _qkv(xn, tok, wts, tf32_only=False):
    """K2.2 in its kernel's arithmetic: [T, D] rows -> (q, k, v), one pass
    a weight."""
    D = tok.shape[1]
    pq, pk, pv = _pieces(rg.qkv_stream(wts), [(D, D)] * 3)
    return tuple(_pass(a, p, tf32_only) for a, p in ((xn, pq), (xn, pk), (tok, pv)))


def _outproj_ln(attn, tok, wts, tf32_only=False):
    """K2.4 in its kernel's arithmetic: [T, D] rows -> (x2, xn2)."""
    D = tok.shape[1]
    (po,) = _pieces(rg.outproj_stream(wts), [(D, D)])
    ln = wts["ln"]
    x2s, xn2s = [], []
    for r0, r1 in _tiles(tok.shape[0], rg.RG_M):
        x2 = _product(_rows(attn, r0, r1), po, tf32_only=tf32_only) + _rows(tok, r0, r1)
        xn2 = torch.nn.functional.layer_norm(x2, (D,), ln[2], ln[3], sb.LN_EPS)
        x2s.append(x2[:r1 - r0])
        xn2s.append(xn2[:r1 - r0])
    return torch.cat(x2s), torch.cat(xn2s)


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _spread_weights(rng, C):
    D = 2 * C
    return dict(wqk=torch.from_numpy(_spread(rng, (D, 2 * D))),
                wv=torch.from_numpy(_spread(rng, (D, D))),
                wo=torch.from_numpy(_spread(rng, (D, D))),
                ln=torch.stack([1 + 0.1 * _rand(rng, D), 0.1 * _rand(rng, D),
                                1 + 0.1 * _rand(rng, D), 0.1 * _rand(rng, D)]))


def _f64(wts):
    return {k: v.double() for k, v in wts.items()}


@pytest.mark.parametrize("C", KERNEL_C)
def test_qkv_3xtf32_scheme_keeps_f32_accuracy(C):
    """K2.2's three products in the kernel's arithmetic, operands over six
    decades, T = 300 (a ragged last tile): each of q, k, v within twice the
    f32 plain version's error against float64; one TF32 product misses by
    more than 10x."""
    rng = np.random.RandomState(C)
    D = 2 * C
    wts = _spread_weights(rng, C)
    xn, tok = (torch.from_numpy(_spread(rng, (300, D))) for _ in range(2))
    exact = sb.qkv_plain(xn.double(), tok.double(), _f64(wts))
    for got, f32, tf32, ex in zip(_qkv(xn, tok, wts), sb.qkv_plain(xn, tok, wts),
                                  _qkv(xn, tok, wts, tf32_only=True), exact):
        e_f32, e_3x, e_tf32 = _err(f32, ex), _err(got, ex), _err(tf32, ex)
        assert e_3x <= 2 * e_f32, (e_3x, e_f32)
        assert e_tf32 > 10 * e_f32, (e_tf32, e_f32)


@pytest.mark.parametrize("C", KERNEL_C)
@pytest.mark.parametrize("inputs", ["spread", "residual"])
def test_outproj_ln_3xtf32_scheme_keeps_f32_accuracy(C, inputs):
    """K2.4 in the kernel's arithmetic (tok added to the finished product,
    then LN2), T = 300: x2 and xn2 each within twice the f32 plain
    version's error against float64; one TF32 product misses by more than
    10x. Inputs: operands over six decades, or a block's own scales (attn
    Wo ~0.1 beside a residual tok ~3), where accumulators started from tok
    would round the sum at x2's scale once a chain (2.9x and 4.3x the plain
    error at C = 32 and 64; on the card 4.2x)."""
    rng = np.random.RandomState(10 + C)
    D = 2 * C
    wts = _spread_weights(rng, C)
    if inputs == "spread":
        attn, tok = (torch.from_numpy(_spread(rng, (300, D))) for _ in range(2))
    else:
        wts["wo"] = D ** -0.5 * _rand(rng, D, D)
        attn, tok = 0.1 * _rand(rng, 300, D), 3 * _rand(rng, 300, D)
    exact = sb.outproj_ln_plain(attn.double(), tok.double(), _f64(wts))
    for got, f32, tf32, ex in zip(_outproj_ln(attn, tok, wts), sb.outproj_ln_plain(attn, tok, wts),
                                  _outproj_ln(attn, tok, wts, tf32_only=True), exact):
        e_f32, e_3x, e_tf32 = _err(f32, ex), _err(got, ex), _err(tf32, ex)
        assert e_3x <= 2 * e_f32, (e_3x, e_f32)
        assert e_tf32 > 10 * e_f32, (e_tf32, e_f32)


@pytest.fixture(scope="module")
def c64_params():
    args = JArgs(angRes=5, scale_factor=2, channels=64, model_name="LFT")
    import jax
    p = j_lft.init_params(jax.random.PRNGKey(1), args)
    np_p = {k: np.asarray(v) for k, v in p.items()}
    return np_p, params_from_numpy(np_p, device="cpu")


def test_spa_chain_with_emulated_steps_2_4_5_matches_jax_fused(c64_params):
    """K2's step 1 and the window step (plain) with the emulated steps 2, 4
    and 5 against lft_tpu's fused SpaTrans block (Pallas, interpret mode)
    within 1e-4; 16 x 12 = 192 tokens leave a ragged last tile."""
    np_p, t_p = c64_params
    B, h, w, C = 1, 16, 12, 64
    D = 2 * C
    prefix = "altblock.3.spa_trans."
    x = (np.random.RandomState(61).rand(B, h, w, C) - 0.5).astype(np.float32)
    spa_pe = spatial_position(h, w, C)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    pe_tok_j = j_unfold3x3_linear(jnp.asarray(spa_pe)[None], jp[prefix + "MLP.weight"])[0]
    ref = j_spa.spa_trans_block_fused(jnp.asarray(x), pe_tok_j, jp, prefix, 8, 5)
    wts = sb.spa_weights(t_p, prefix)
    pe_tok = unfold3x3_linear(torch.from_numpy(spa_pe)[None], wts["mlp"])[0].contiguous()
    tok, xn = sb.tokenize_ln_plain(torch.from_numpy(x), pe_tok, wts)
    rows = lambda t: t.reshape(-1, D)
    img = lambda t: t.reshape(B, h, w, -1)
    q, k, v = (img(t) for t in _qkv(rows(xn), rows(tok), wts))
    attn = sb.window_attn(q, k, v, 8, 5)
    x2, xn2 = _outproj_ln(rows(attn), rows(tok), wts)
    got = img(_ffn_out(xn2, x2, wts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("C", KERNEL_C)
def test_proj_weight_streams_core_matrix_layout(C):
    """K2.2's stream holds Wq, Wk (the halves of wqk) and Wv, K2.4's Wo,
    each piece its weight's hi and lo (both rounded to nearest) at (kk,
    part, kh, j, n, t) = B[8 kk + 4 kh + t][8 j + n], at the kernels'
    scratch sizes."""
    rng = np.random.RandomState(30 + C)
    D = 2 * C
    wts = dict(wqk=_rand(rng, D, 2 * D), wv=_rand(rng, D, D), wo=_rand(rng, D, D))
    pieces = rg.qkv_pieces(wts["wqk"], wts["wv"])
    assert torch.equal(pieces[0], wts["wqk"][:, :D]) and torch.equal(pieces[1], wts["wqk"][:, D:])
    assert pieces[2] is wts["wv"] and len(pieces) == 3
    for stream, mats, floats in ((rg.qkv_stream(wts), pieces, rg.qkv_floats(C)),
                                 (rg.outproj_stream(wts), [wts["wo"]], rg.outproj_floats(C))):
        assert stream.numel() == floats
        off = 0
        for B in mats:
            f = stream[off:off + 2 * D * D].reshape(D // 8, 2, 2, D // 8, 8, 4)
            hi = _tf32(B)
            parts = torch.stack([hi, _tf32(B - hi)])
            kk, part, kh, j, n, t = np.meshgrid(*(np.arange(d) for d in f.shape), indexing="ij")
            assert torch.equal(f, parts[part, 8 * kk + 4 * kh + t, 8 * j + n])
            off += 2 * D * D
        assert off == floats


@pytest.mark.parametrize("C", KERNEL_C)
def test_proj_tiles_fit_and_copies_align(C):
    """Each piece of K2.2's stream starts at a multiple of its 16-of-K
    chunk (the product's static_assert) and is one pass's resident weight;
    a weight and a tile of rows fit in shared memory; the rows' cp.async
    copies are whole 16-byte units of a padded tile."""
    D = 2 * C
    assert D % 16 == 0 and D <= 128
    assert rg.qkv_floats(C) == 3 * rg.outproj_floats(C)
    for off in range(0, rg.qkv_floats(C), rg.outproj_floats(C)):
        assert off % (32 * D) == 0
    assert rg.proj_smem(C) <= rg.RG_SMEM_MAX
    assert (D * 4) % 16 == 0 and ((D + 4) * 4) % 16 == 0


def test_proj_python_geometry_mirrors_the_source():
    """rowgemm.py's sizes for K2.2 and K2.4 are RowProj's (spa_block.cu),
    the scratch offsets of K2.2's pieces are its passes', and the kernels
    no longer run gemm_acc."""
    spa = (CSRC / "spa_block.cu").read_text()
    for line in ("LDX = D + 4;", "SQ = 2 * D * D;",
                 "BYTES = (static_cast<size_t>(SQ) + RG_M * LDX) * 4;",
                 "ps.p[1] = RgPiece{wqk + L::D, 2 * L::D, L::D, L::D, L::SQ};",
                 "ps.p[2] = RgPiece{wv, L::D, L::D, L::D, 2 * L::SQ};",
                 "row_pass<C, false, NoRows, BF, IO>(xn, wf + SQ, k,",
                 "row_pass<C, false, NoRows, BF, IO>(tok, wf + 2 * SQ, v,",
                 "row_pass<C, true, NoRows, BF, IO>(attn, wf, x2, tok, ln + 2 * D, "
                 "ln + 3 * D, xn2,"):
        assert line in spa, line
    assert not re.search(r"\bgemm_acc\b", spa.split("namespace {", 1)[1])
    for C in KERNEL_C:
        D = 2 * C
        assert rg.outproj_floats(C) == 2 * D * D
        assert rg.proj_smem(C) == (2 * D * D + rg.RG_M * (D + 4)) * 4


def test_proj_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers are their plain versions, bit for bit,
    and launch nothing."""
    rng = np.random.RandomState(3)
    C = 16
    D = 2 * C
    wts = dict(wqk=_rand(rng, D, 2 * D), wv=_rand(rng, D, D), wo=_rand(rng, D, D),
               ln=_rand(rng, 4, D))
    a, tok = _rand(rng, 4, 5, 6, D), _rand(rng, 4, 5, 6, D)
    reset_launches()
    for got, ref in ((sb.qkv(a, tok, wts), sb.qkv_plain(a, tok, wts)),
                     (sb.outproj_ln(a, tok, wts), sb.outproj_ln_plain(a, tok, wts))):
        assert len(got) == len(ref) and all(torch.equal(u, v) for u, v in zip(got, ref))
    assert sum(LAUNCHES.values()) == 0
