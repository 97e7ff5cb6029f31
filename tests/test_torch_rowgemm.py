"""The row-tile product kernels on the tensor cores (K2.5 `spa_ffn_out`,
K11.5 `spa_ffn_out_pm`, K1 `ang_block`, `ang_block_res`; `lft_torch/csrc/
rowgemm.cuh`), on the CPU: their arithmetic, their weight streams and their
geometry.

The CUDA kernels cannot run here; their scheme can. `_product` repeats a
kernel product's arithmetic in plain PyTorch from the wrapper's own weight
preparation (`kernels/rowgemm.py`, unpacked from its core-matrix layout):
the token rows split into TF32 hi and lo, both rounded to nearest (as the
weights are), three 8-deep products al bh + ah bl + ah bh a k8 step, chains
of 16 of K (two k8 steps) summed in their own accumulator, the chains added
in f32 in K order. `_ffn_out` and `_ang_block` chain those products as the
kernels do (the hidden layer in 64-column chunks, the residuals added in
f32, LayerNorms and the attention in f32), tile by tile of 128 rows with
zero pad rows, so a ragged last tile is covered. The tensor cores' own
rounding inside an MMA is not modelled: f32 sums here. Against float64
the emulation's error must be at most twice that of the f32 plain version,
and the whole blocks with it must match lft_tpu's fused blocks (interpret
mode) within 1e-4. The kernels are held to the same bounds on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reduce import _spread, _tf32

from lft_tpu.config import Args as JArgs
from lft_tpu.kernels import ang_block as j_ang
from lft_tpu.kernels import spa_block as j_spa
from lft_tpu.models import lft as j_lft
from lft_tpu.ops.posenc import angular_position, spatial_position
from lft_tpu.ops.unfold import unfold3x3_linear as j_unfold3x3_linear
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import ang_block as ab
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.common import KERNEL_C
from lft_torch.models.lft import params_from_numpy
from lft_torch.ops.attention import attention_heads
from lft_torch.ops.unfold import unfold3x3_linear

CSRC = Path(rg.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unpack(flat: torch.Tensor, K: int, N: int):
    """`rowgemm.piece`'s layout [K/8, 2, 2, N/8, 8, 4] -> (hi, lo) [K, N]."""
    f = flat.reshape(K // 8, 2, 2, N // 8, 8, 4).permute(1, 0, 2, 5, 3, 4).reshape(2, K, N)
    return f[0], f[1]


def _pieces(stream: torch.Tensor, shapes):
    """The stream cut into its pieces' (hi, lo), in order; every float used."""
    out, off = [], 0
    for K, N in shapes:
        out.append(_unpack(stream[off:off + 2 * K * N], K, N))
        off += 2 * K * N
    assert off == stream.numel()
    return out


def _ffn_shapes(C):
    D = 2 * C
    hc = rg.hidden_chunk(D)
    return [(D, hc), (hc, D)] * (2 * D // hc) + [(D, C)]


def _ang_shapes(C):
    hc = rg.hidden_chunk(C)
    return [(C, C)] * 4 + [(C, hc), (hc, C)] * (2 * C // hc)


def _product(a, b, acc=None, tf32_only=False):
    """acc + a @ B in a kernel product's arithmetic (module docstring);
    b = (hi, lo) of B. With tf32_only one TF32 product per term."""
    bh, bl = b
    ah, al = rg.split_tf32_rn(a)
    if tf32_only:
        al, bl = torch.zeros_like(al), torch.zeros_like(bl)
    acc = torch.zeros(a.shape[0], bh.shape[1]) if acc is None else acc
    for c in range(0, a.shape[1], 16):       # a chain: its own accumulator
        s = torch.zeros_like(acc)
        for k in (c, c + 8):
            s = s + al[:, k:k + 8] @ bh[k:k + 8]
            s = s + ah[:, k:k + 8] @ bl[k:k + 8]
            s = s + ah[:, k:k + 8] @ bh[k:k + 8]
        acc = acc + s
    return acc


def _tiles(rows: int, step: int):
    """The kernels' tiles: [r0, r1) rows of `step` (whole pixels, or 128
    tokens), the last one ragged; `_pad` fills each to 128 rows."""
    return [(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)]


def _pad(t, r0, r1):
    out = torch.zeros(rg.RG_M, t.shape[1])
    out[:r1 - r0] = t[r0:r1]
    return out


def _ffn_out(xn2, x2, wts, tf32_only=False):
    """K2.5 in its kernel's arithmetic: [T, D] rows -> [T, C]."""
    C = wts["wlin"].shape[1]
    p = _pieces(rg.ffn_out_stream(wts), _ffn_shapes(C))
    out = []
    for r0, r1 in _tiles(x2.shape[0], rg.RG_M):
        y = None
        for j in range(0, len(p) - 1, 2):
            h = torch.relu(_product(_pad(xn2, r0, r1), p[j], tf32_only=tf32_only))
            y = _product(h, p[j + 1], y, tf32_only)
        y = y + _pad(x2, r0, r1)
        out.append(_product(y, p[-1], tf32_only=tf32_only)[:r1 - r0])
    return torch.cat(out)


def _ln(t, w, b):
    return torch.nn.functional.layer_norm(t, (t.shape[-1],), w, b, ab.LN_EPS)


def _ang_block(x, pe, wts, H):
    """K1 in its kernel's arithmetic: [N, A2, C] -> [N, A2, C]."""
    N, A2, C = x.shape
    pv, pq, pk, po, *ffn = _pieces(rg.ang_block_stream(wts), _ang_shapes(C))
    ln = wts["ln"]
    P = rg.RG_M // A2
    xt = x.reshape(N * A2, C)
    out = []
    for r0, r1 in _tiles(N * A2, P * A2):
        xs = _pad(xt, r0, r1)                 # pad rows: x = 0
        xn = _ln(xs + pe[torch.arange(rg.RG_M) % A2], ln[0], ln[1])
        v, q, k = _product(xs, pv), _product(xn, pq), _product(xn, pk)
        n = (r1 - r0) // A2
        a = torch.zeros_like(xs)
        heads = lambda t: t[:n * A2].reshape(n, A2, C)
        a[:n * A2] = attention_heads(heads(q), heads(k), heads(v), H).reshape(n * A2, C)
        x2 = _product(a, po) + xs
        xn2 = _ln(x2, ln[2], ln[3])
        y = None
        for j in range(0, len(ffn), 2):
            y = _product(torch.relu(_product(xn2, ffn[j])), ffn[j + 1], y)
        out.append((y + x2)[:r1 - r0])
    return torch.cat(out).reshape(N, A2, C)


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("C", KERNEL_C)
def test_ffn_out_3xtf32_scheme_keeps_f32_accuracy(C):
    """K2.5's three products in the kernel's arithmetic, operands over six
    decades, T = 300 (a ragged last tile): within twice the f32 plain
    version's error against float64; one TF32 product misses by more than
    10x."""
    rng = np.random.RandomState(C)
    D = 2 * C
    wts = dict(w1=torch.from_numpy(_spread(rng, (D, 2 * D))),
               w2=torch.from_numpy(_spread(rng, (2 * D, D))),
               wlin=torch.from_numpy(_spread(rng, (D, C))))
    xn2, x2 = (torch.from_numpy(_spread(rng, (300, D))) for _ in range(2))
    exact = sb.ffn_out_plain(xn2.double(), x2.double(), {k: v.double() for k, v in wts.items()})
    e_f32 = _err(sb.ffn_out_plain(xn2, x2, wts), exact)
    e_3x = _err(_ffn_out(xn2, x2, wts), exact)
    e_tf32 = _err(_ffn_out(xn2, x2, wts, tf32_only=True), exact)
    assert e_3x <= 2 * e_f32, (e_3x, e_f32)
    assert e_tf32 > 10 * e_f32, (e_tf32, e_f32)


@pytest.mark.parametrize("C", KERNEL_C)
@pytest.mark.parametrize("A2,N", [(25, 11), (81, 3), (121, 2)])
def test_ang_block_3xtf32_scheme_keeps_f32_accuracy(C, A2, N):
    """K1 in the kernel's arithmetic (N pixels: a ragged last tile of 5 at
    A2 = 25; tiles of one pixel and 47 or 7 pad rows beyond): within twice
    the f32 plain version's error against float64."""
    rng = np.random.RandomState(C + A2)
    H = 8
    s = C ** -0.5
    wts = dict(ln=torch.stack([1 + 0.1 * _rand(rng, C), 0.1 * _rand(rng, C),
                               1 + 0.1 * _rand(rng, C), 0.1 * _rand(rng, C)]),
               **{n: s * _rand(rng, C, C) for n in ("wq", "wk", "wv", "wo")},
               w1=s * _rand(rng, C, 2 * C), w2=(2 * C) ** -0.5 * _rand(rng, 2 * C, C))
    x = _rand(rng, N, A2, C)
    pe = torch.from_numpy(angular_position(A2, C))
    exact = ab.ang_block_plain(x.double(), pe.double(), {k: v.double() for k, v in wts.items()},
                               H)
    e_f32 = _err(ab.ang_block_plain(x, pe, wts, H), exact)
    e_3x = _err(_ang_block(x, pe, wts, H), exact)
    assert e_3x <= 2 * e_f32, (e_3x, e_f32)


@pytest.fixture(scope="module")
def c64_params():
    args = JArgs(angRes=5, scale_factor=2, channels=64, model_name="LFT")
    import jax
    p = j_lft.init_params(jax.random.PRNGKey(0), args)
    np_p = {k: np.asarray(v) for k, v in p.items()}
    return np_p, params_from_numpy(np_p, device="cpu")


def test_emulated_ang_block_matches_jax_fused(c64_params):
    """The emulated K1 against lft_tpu's fused AngTrans block (Pallas,
    interpret mode) within 1e-4, 37 pixels: a ragged last tile."""
    np_p, t_p = c64_params
    N, A2, C = 37, 25, 64
    prefix = "altblock.2.ang_trans."
    x = (np.random.RandomState(70).rand(N, A2, C) - 0.5).astype(np.float32)
    pe = angular_position(A2, C)
    ref = j_ang.ang_trans_block_fused(jnp.asarray(x), jnp.asarray(pe),
                                      {k: jnp.asarray(v) for k, v in np_p.items()}, prefix, 8)
    got = _ang_block(torch.from_numpy(x), torch.from_numpy(pe), ab.ang_weights(t_p, prefix), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_spa_chain_with_emulated_ffn_out_matches_jax_fused(c64_params):
    """K2's steps 1-4 (plain) and the emulated step 5 against lft_tpu's
    fused SpaTrans block (Pallas, interpret mode) within 1e-4."""
    np_p, t_p = c64_params
    B, h, w, C = 2, 16, 16, 64
    prefix = "altblock.1.spa_trans."
    x = (np.random.RandomState(60).rand(B, h, w, C) - 0.5).astype(np.float32)
    spa_pe = spatial_position(h, w, C)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    pe_tok_j = j_unfold3x3_linear(jnp.asarray(spa_pe)[None], jp[prefix + "MLP.weight"])[0]
    ref = j_spa.spa_trans_block_fused(jnp.asarray(x), pe_tok_j, jp, prefix, 8, 5)
    wts = sb.spa_weights(t_p, prefix)
    pe_tok = unfold3x3_linear(torch.from_numpy(spa_pe)[None], wts["mlp"])[0].contiguous()
    tok, xn = sb.tokenize_ln_plain(torch.from_numpy(x), pe_tok, wts)
    q, k, v = sb.qkv_plain(xn, tok, wts)
    x2, xn2 = sb.outproj_ln_plain(sb.window_attn(q, k, v, 8, 5), tok, wts)
    D = 2 * C
    got = _ffn_out(xn2.reshape(-1, D), x2.reshape(-1, D), wts).reshape(B, h, w, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("C", KERNEL_C)
def test_weight_streams_core_matrix_layout(C):
    """Each piece of a stream holds its weight's hi and lo (both rounded to
    nearest) at (kk, part, kh, j, n, t) = B[8 kk + 4 kh + t][8 j + n], in
    the order the kernels read them; the hi parts are the tokenization's
    (`tap_weights`) and the streams are the kernels' scratch sizes."""
    rng = np.random.RandomState(C)
    D = 2 * C
    w = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    ws = dict(w1=w(D, 2 * D), w2=w(2 * D, D), wlin=w(D, C))
    wa = dict(wq=w(C, C), wk=w(C, C), wv=w(C, C), wo=w(C, C), w1=w(C, 2 * C), w2=w(2 * C, C))
    for stream, mats, floats in (
            (rg.ffn_out_stream(ws), rg.ffn_out_pieces(ws["w1"], ws["w2"], ws["wlin"]),
             rg.ffn_out_floats(C)),
            (rg.ang_block_stream(wa), rg.ang_block_pieces(wa), rg.ang_block_floats(C))):
        assert stream.numel() == floats
        off = 0
        for B in mats:
            K, N = B.shape
            f = stream[off:off + 2 * K * N].reshape(K // 8, 2, 2, N // 8, 8, 4)
            hi = _tf32(B)
            parts = torch.stack([hi, _tf32(B - hi)])
            kk, part, kh, j, n, t = np.meshgrid(*(np.arange(d) for d in f.shape), indexing="ij")
            assert torch.equal(f, parts[part, 8 * kk + 4 * kh + t, 8 * j + n])
            taps = sb.tap_weights(B[None].expand(9, K, N).contiguous())
            assert torch.equal(f[:, 0], taps[0][:, 0])   # the hi parts
            off += 2 * K * N
        assert off == floats
    # stream order: W1[:, chunk], W2[chunk, :] per hidden chunk, then Wlin;
    # Wv, Wq, Wk, Wo, then the chunks
    hc = rg.hidden_chunk(D)
    got = rg.ffn_out_pieces(ws["w1"], ws["w2"], ws["wlin"])
    assert torch.equal(got[0], ws["w1"][:, :hc]) and torch.equal(got[1], ws["w2"][:hc])
    assert torch.equal(got[-1], ws["wlin"]) and len(got) == 2 * (2 * D // hc) + 1
    got = rg.ang_block_pieces(wa)
    assert [g.data_ptr() for g in got[:4]] == [wa[n].data_ptr() for n in ("wv", "wq", "wk", "wo")]


@pytest.mark.parametrize("C", KERNEL_C)
def test_chunks_never_straddle_a_stage(C):
    """Every piece starts at a multiple of its 16-of-K chunk (32 N floats)
    and a stage holds whole chunks: the kernels' static_asserts, and the
    ring is at least three slots beside the rows in shared memory."""
    for shapes in (_ffn_shapes(C), _ang_shapes(C)):
        off = 0
        for K, N in shapes:
            assert K % 16 == 0 and N % 16 == 0 and N <= 128
            assert off % (32 * N) == 0 and rg.RG_SF % (32 * N) == 0, (off, K, N)
            off += 2 * K * N
    for smem, tiles in ((rg.ffn_out_smem(C), rg.RG_M * (2 * C + 4 + rg.hidden_chunk(2 * C) + 4) * 4),
                        (rg.ang_block_smem(C), 4 * rg.RG_M * (C + 4) * 4)):
        assert smem <= rg.RG_SMEM_MAX and rg.ring_slots(tiles) >= 3
    # the hidden chunk over k and v in K1: 128 x (HC + 4) <= 2 x 128 x (C + 4)
    assert rg.hidden_chunk(C) + 4 <= 2 * (C + 4)


def test_python_geometry_mirrors_the_source():
    """rowgemm.py's constants and sizes are rowgemm.cuh's, FfnOut's
    (spa_block.cu) and AngLayout's (ang_block.cu)."""
    src = (CSRC / "rowgemm.cuh").read_text()
    for name, value in (("RG_M", rg.RG_M), ("RG_SF", rg.RG_SF), ("RG_SMEM_MAX", rg.RG_SMEM_MAX)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "< 8 ? (RG_SMEM_MAX - tile_bytes) / (RG_SF * 4)" in src
    spa = (CSRC / "spa_block.cu").read_text()
    for line in ("HC = 2 * D < 64 ? 2 * D : 64", "LDX = D + 4, LDH = HC + 4",
                 "W1 = 2 * D * HC, W2 = 2 * HC * D", "OFF_LIN = NH * (W1 + W2)",
                 "FLOATS = OFF_LIN + 2 * D * C", "TILES = RG_M * (LDX + LDH) * 4"):
        assert line in spa, line
    ang = (CSRC / "ang_block.cu").read_text()
    for line in ("LD = C + 4", "HC = 2 * C < 64 ? 2 * C : 64", "LDH = HC + 4",
                 "OFF_V = 0, OFF_Q = SQ, OFF_K = 2 * SQ, OFF_O = 3 * SQ, OFF_F = 4 * SQ",
                 "W1 = 2 * C * HC, W2 = 2 * HC * C", "FLOATS = OFF_F + NH * (W1 + W2)",
                 "TILES = 4 * TILE * 4"):
        assert line in ang, line
    for C in KERNEL_C:
        assert rg.ffn_out_floats(C) == 2 * (4 * (2 * C) ** 2 + 2 * C * C)
        assert rg.ang_block_floats(C) == 4 * 2 * C * C + 2 * (2 * C * C + 2 * C * C)


def test_rowgemm_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers are their plain versions, bit for bit,
    and launch nothing."""
    rng = np.random.RandomState(2)
    C, A2, N = 16, 25, 3
    D = 2 * C
    ws = dict(w1=_rand(rng, D, 2 * D), w2=_rand(rng, 2 * D, D), wlin=_rand(rng, D, C))
    wa = dict(ln=_rand(rng, 4, C), **{n: _rand(rng, C, C) for n in ("wq", "wk", "wv", "wo")},
              w1=_rand(rng, C, 2 * C), w2=_rand(rng, 2 * C, C))
    xn2, x2 = _rand(rng, 4, 5, 6, D), _rand(rng, 4, 5, 6, D)
    x, pe = _rand(rng, N, A2, C), _rand(rng, A2, C)
    reset_launches()
    assert torch.equal(sb.ffn_out(xn2, x2, ws), sb.ffn_out_plain(xn2, x2, ws))
    assert torch.equal(sb.ffn_out(xn2, x2, ws, 2),
                       sb._to_pixel_major(sb.ffn_out_plain(xn2, x2, ws), 2))
    assert torch.equal(ab.ang_block(x, pe, wa, 8), ab.ang_block_plain(x, pe, wa, 8))
    for got, ref in zip(ab.ang_block(x, pe, wa, 8, with_res=True),
                        ab.ang_block_plain(x, pe, wa, 8, with_res=True)):
        assert torch.equal(got, ref)
    assert sum(LAUNCHES.values()) == 0
