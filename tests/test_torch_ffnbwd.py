"""K3.a `spa_ffn_out_bwd` on the tensor cores (`lft_torch/csrc/
spa_block_bwd.cu` on `csrc/rowgemm.cuh`), on the CPU: its arithmetic, its
weight stream and its geometry.

The CUDA kernel cannot run here; its scheme can, as in
tests/test_torch_rowgemm.py, whose `_product` repeats a row-tile product's
3xTF32 arithmetic (the rows split into TF32 hi and lo rounded to nearest,
chains of 16 of K flushed into f32 in K order; here, past the x2 product,
each chain's tail products first, as the kernel issues them) from the
wrapper's own weight preparation (`kernels/rowgemm.py:ffn_out_bwd_stream`, unpacked from
its core-matrix layout). `_ffn_out_bwd` chains those products as the
kernel does, tile by tile of 128 rows with zero pad rows: x2 = attn Wo +
tok (tok added to the finished product) and LN2, then the forward's hidden
chunks (hid, y), y + x2, dy = dout Wlinᵀ, the backward's hidden chunks
(dpre from the forward's ReLU signs, dxn2), the LN2 backward in f32, dattn
= dx2 Woᵀ, and one row of LN2 sums a tile. Against float64 each output's
error must be at most twice that of the f32 plain version (the kernel is
held to the same on the card, tests/test_torch_cuda.py, chip_smoke.py),
and the K3 chain with the emulated step a must match `jax.vjp` of
lft_tpu's fused SpaTrans block (interpret mode) within 5e-4 max |ref|, the
bound of tests/test_torch_train.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reduce import _tf32
from test_torch_rowgemm import _pad, _product, _tiles, _unpack

from lft_tpu.kernels.spa_block import spa_block_core
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.ang_block import ln_stats
from lft_torch.kernels.common import KERNEL_C
from lft_torch.models import lft
from lft_torch.ops.posenc import spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

CSRC = Path(rg.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stream_pieces(wts):
    """{(name, chunk): (hi, lo)} of K3.a's stream, cut at the layout's
    offsets."""
    layout, _ = rg.ffn_out_bwd_layout(wts["wo"].shape[0] // 2)
    stream = rg.ffn_out_bwd_stream(wts)
    return {(n, j): _unpack(stream[off:off + 2 * K * N], K, N) for n, j, K, N, off in layout}


def _product_tails_first(a, b, acc=None, tf32_only=False):
    """`_product` with the MMAs of a chain in rg_product<..., true>'s order:
    al bh and ah bl of both k8 steps, then ah bh of both."""
    bh, bl = b
    ah, al = rg.split_tf32_rn(a)
    if tf32_only:
        al, bl = torch.zeros_like(al), torch.zeros_like(bl)
    acc = torch.zeros(a.shape[0], bh.shape[1]) if acc is None else acc
    for c in range(0, a.shape[1], 16):
        s = torch.zeros_like(acc)
        for k in (c, c + 8):
            s = s + al[:, k:k + 8] @ bh[k:k + 8]
            s = s + ah[:, k:k + 8] @ bl[k:k + 8]
        for k in (c, c + 8):
            s = s + ah[:, k:k + 8] @ bh[k:k + 8]
        acc = acc + s
    return acc


def _ffn_out_bwd(attn, tok, dout, wts, tf32_only=False):
    """K3.a in its kernel's arithmetic: [T, D], [T, D], [T, C] rows ->
    (dx2, dattn, y, dy, hid, dpre, xn2, dln2 [tiles, 2, D]). The x2 product
    in K2.4's order, the others tails first."""
    D = tok.shape[1]
    hc = rg.hidden_chunk(D)
    p = _stream_pieces(wts)
    prod = lambda a, b, acc=None: _product_tails_first(a, b, acc, tf32_only)
    ln = wts["ln"]
    outs = [[] for _ in range(8)]
    for r0, r1 in _tiles(tok.shape[0], rg.RG_M):
        n = r1 - r0
        x2 = _product(_pad(attn, r0, r1), p["wo", None], tf32_only=tf32_only) + _pad(tok, r0, r1)
        xhat, rstd = ln_stats(x2)
        xn2 = xhat * ln[2] + ln[3]
        y, on, hid = None, [], []
        for j in range(2 * D // hc):
            h = prod(xn2, p["w1", j])
            on.append(h > 0)
            hid.append(torch.relu(h))
            y = prod(hid[-1], p["w2", j], y)
        y = y + x2
        dy = prod(_pad(dout, r0, r1), p["wlinT", None])
        dxn, dpre = None, []
        for j in range(2 * D // hc):
            dpre.append(torch.where(on[j], prod(dy, p["w2T", j]), 0.0))
            dxn = prod(dpre[-1], p["w1T", j], dxn)
        dxn = torch.where(torch.arange(rg.RG_M)[:, None] < n, dxn, 0.0)
        dx2 = dy + sb.ln_bwd(dxn, xhat, rstd, ln[2])
        dattn = prod(dx2, p["woT", None])
        sums = torch.stack([(dxn * xhat)[:n].sum(0), dxn[:n].sum(0)])
        for o, t in zip(outs, (dx2, dattn, y, dy, torch.cat(hid, 1), torch.cat(dpre, 1), xn2)):
            o.append(t[:n])
        outs[7].append(sums[None])
    return (*(torch.cat(o) for o in outs[:7]), torch.cat(outs[7]))


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _weights(rng, C):
    """A block's scales: weights ~ fan_in^-1/2, LayerNorm affines near (1, 0)."""
    D = 2 * C
    return dict(wo=D ** -0.5 * _rand(rng, D, D), w1=D ** -0.5 * _rand(rng, D, 2 * D),
                w2=(2 * D) ** -0.5 * _rand(rng, 2 * D, D), wlin=D ** -0.5 * _rand(rng, D, C),
                ln=torch.stack([1 + 0.1 * _rand(rng, D), 0.1 * _rand(rng, D),
                                1 + 0.1 * _rand(rng, D), 0.1 * _rand(rng, D)]))


def _calm(dout, *hids):
    """dout zero on the tokens where an FFN ReLU is on in one version and
    off in another (its input within rounding of 0): dpre jumps there by
    design, not by the arithmetic."""
    flips = torch.zeros(dout.shape[0], dtype=torch.bool)
    for h in hids[1:]:
        flips |= ((h > 0) != (hids[0] > 0)).any(-1)
    assert int(flips.sum()) <= 3, int(flips.sum())
    return torch.where(flips[:, None], 0.0, dout)


def _case(C, seed, T=300):
    rng = np.random.RandomState(seed)
    D = 2 * C
    wts = _weights(rng, C)
    attn, tok, dout = 0.3 * _rand(rng, T, D), _rand(rng, T, D), _rand(rng, T, C)
    w64 = {k: v.double() for k, v in wts.items()}
    hid = lambda f, *a: f(*a)[4]
    dout = _calm(dout, hid(_ffn_out_bwd, attn, tok, dout, wts),
                 hid(sb.ffn_out_bwd_plain, attn, tok, dout, wts),
                 hid(sb.ffn_out_bwd_plain, attn.double(), tok.double(), dout.double(), w64))
    return wts, w64, attn, tok, dout


OUTPUTS = ("dx2", "dattn", "y", "dy", "hid", "dpre", "xn2", "dln2")


@pytest.mark.parametrize("C", KERNEL_C)
def test_ffn_out_bwd_3xtf32_scheme_keeps_f32_accuracy(C):
    """K3.a's seven products in the kernel's arithmetic at a block's scales,
    T = 300 (a ragged last tile): every output within twice the f32 plain
    version's error against float64 (the LN2 sums over their per-tile
    rows), and within 5e-4 max |plain| of the plain version; with one TF32
    product a term dattn misses by more than 10x."""
    wts, w64, attn, tok, dout = _case(C, C)
    got = list(_ffn_out_bwd(attn, tok, dout, wts))
    assert got[7].shape == (3, 2, 2 * C)
    got[7] = got[7].sum(0, keepdim=True)
    ref = sb.ffn_out_bwd_plain(attn, tok, dout, wts)
    exact = sb.ffn_out_bwd_plain(attn.double(), tok.double(), dout.double(), w64)
    for name, g, r, e in zip(OUTPUTS, got, ref, exact):
        assert g.shape == r.shape, name
        e_3x, e_f32 = _err(g, e), _err(r, e)
        assert e_3x <= 2 * e_f32 + 1e-12, (name, e_3x, e_f32)
        assert _err(g, r.double()) <= 5e-4 * float(r.abs().max()), name
    tf32 = _ffn_out_bwd(attn, tok, dout, wts, tf32_only=True)
    assert _err(tf32[1], exact[1]) > 10 * _err(ref[1], exact[1])


@pytest.mark.parametrize("T", [1, 127, 128, 129, 700])
def test_ffn_out_bwd_ln_sums_one_row_a_tile(T):
    """The LN2 sums come as one row a 128-row tile, ceil(T / 128) rows
    whatever the card, and summed they are the plain version's."""
    C = 16
    wts, _, attn, tok, dout = _case(C, T, T)
    got = _ffn_out_bwd(attn, tok, dout, wts)[7]
    assert got.shape == (sb.ffn_out_bwd_tiles(T), 2, 2 * C) == (-(-T // 128), 2, 2 * C)
    ref = sb.ffn_out_bwd_plain(attn, tok, dout, wts)[7]
    torch.testing.assert_close(got.sum(0, keepdim=True), ref, atol=1e-5 * float(ref.abs().max()),
                               rtol=0)


@pytest.mark.parametrize("C", KERNEL_C)
def test_ffn_out_bwd_stream_core_matrix_layout(C):
    """The stream holds Wo, per hidden chunk W1[:, c] and W2[c, :], Wlinᵀ,
    per chunk W2ᵀ[:, c] and W1ᵀ[c, :], Woᵀ, each piece its matrix's hi and lo
    (both rounded to nearest) at (kk, part, kh, j, n, t) = B[8 kk + 4 kh +
    t][8 j + n]; every piece starts at a multiple of its 16-of-K chain, no
    chain straddles a ring stage, and only the gap after Wlinᵀ is unused."""
    rng = np.random.RandomState(40 + C)
    wts = _weights(rng, C)
    D = 2 * C
    hc = rg.hidden_chunk(D)
    layout, floats = rg.ffn_out_bwd_layout(C)
    stream = rg.ffn_out_bwd_stream(wts)
    assert stream.numel() == floats == rg.ffn_out_bwd_floats(C)
    mats = dict(wo=wts["wo"], w1=wts["w1"], w2=wts["w2"], wlinT=wts["wlin"].t(),
                w2T=wts["w2"].t(), w1T=wts["w1"].t(), woT=wts["wo"].t())
    used = torch.zeros(floats, dtype=torch.bool)
    names = []
    for name, j, K, N, off in layout:
        B = mats[name]
        if j is not None:
            B = B[:, j * hc:(j + 1) * hc] if name in ("w1", "w2T") else B[j * hc:(j + 1) * hc]
        assert tuple(B.shape) == (K, N)
        assert off % (32 * N) == 0 and rg.RG_SF % (32 * N) == 0
        f = stream[off:off + 2 * K * N].reshape(K // 8, 2, 2, N // 8, 8, 4)
        hi = _tf32(B.contiguous())
        parts = torch.stack([hi, _tf32(B - hi)])
        kk, part, kh, jj, n, t = np.meshgrid(*(np.arange(d) for d in f.shape), indexing="ij")
        assert torch.equal(f, parts[part, 8 * kk + 4 * kh + t, 8 * jj + n])
        assert not used[off:off + 2 * K * N].any()
        used[off:off + 2 * K * N] = True
        names.append(name)
    nh = 2 * D // hc
    assert names == ["wo"] + ["w1", "w2"] * nh + ["wlinT"] + ["w2T", "w1T"] * nh + ["woT"]
    gap = int((~used).sum())
    assert gap == (1024 if C == 16 else 0) and not stream[~used].any()


@pytest.mark.parametrize("C", KERNEL_C)
def test_ffn_out_bwd_smem_fits(C):
    """The rows, the LN2 sums and at least the ring's three slots fit in a
    block's shared memory (232,448 bytes); the rows' float4 copies and the
    ring are 16-byte aligned."""
    D = 2 * C
    smem = rg.ffn_out_bwd_smem(C)
    assert smem <= rg.RG_SMEM_MAX
    hc = rg.hidden_chunk(D)
    tiles = (rg.RG_M * (D + 4 + hc + 4) + 16 * D + 2 * rg.RG_M + 2 * D // hc * 256) * 4
    slots = rg.ring_slots(tiles + 16 * 8)
    assert tiles % 128 == 0 and slots >= 7
    assert smem == tiles + slots * rg.RG_SF * 4 + 2 * slots * 8
    assert ((D + 4) * 4) % 16 == 0 and ((rg.hidden_chunk(D) + 4) * 4) % 16 == 0


def test_ffn_out_bwd_python_geometry_mirrors_the_source():
    """rowgemm.py's layout and sizes for K3.a are FfnOutBwd's
    (spa_block_bwd.cu), the kernel recomputes x2 and xn2 with K2.4's pass
    arithmetic (the product, + tok, quad_ln) and runs no gemm_acc."""
    src = (CSRC / "spa_block_bwd.cu").read_text()
    for line in ("HC = 2 * D < 64 ? 2 * D : 64;", "SQ = 2 * D * D;",
                 "PC = 2 * D * HC;", "ALIGN = 32 * (D > HC ? D : HC);",
                 "OFF_F = SQ;", "OFF_LIN = OFF_F + NH * 2 * PC;",
                 "(OFF_LIN + 2 * C * D + ALIGN - 1) / ALIGN * ALIGN;",
                 "OFF_OT = OFF_B + NH * 2 * PC;", "FLOATS = OFF_OT + SQ;",
                 "TILES = (RG_M * (LDX + LDH) + 8 * 2 * D + 2 * RG_M + NH * RG_NT) * 4;",
                 "NS = rg_slots(TILES + 16 * 8);",
                 "BYTES = TILES + static_cast<size_t>(NS) * RG_SF * 4 + 2 * NS * 8;",
                 "MbarRing<F::NS> ring;",
                 "rg_product<D, D, 0, false, BF>(a, xw, LDX, ring, st);",
                 "quad_ln<D, true>(a, g2, ln + 3 * D, mu, rstd);",
                 "rg_product<C, D, F::OFF_LIN, true, BF>(dy, hw16, LDH, ring, st);",
                 "rg_product<D, D, F::OFF_OT, true, BF>(da, xw, LDX, ring, st);",
                 "rg_product<F::D, F::HC, off, true, BF>(hc, xw, F::LDX, ring, st);",
                 "rg_product<F::HC, F::D, off + F::PC, true, BF>(y, hw16, F::LDH, ring, st);",
                 "rg_product<F::D, F::HC, off, true, BF>(dp, xw, F::LDX, ring, st);",
                 "rg_product<F::HC, F::D, off + F::PC, true, BF>(dxn, hw16, F::LDH, ring, st);"):
        assert line in src, line
    kernel = src.split("spa_ffn_out_bwd_kernel(", 1)[1].split("// ---- b:", 1)[0]
    assert not re.search(r"\bgemm_acc\b", kernel)
    # the same order as K2.4's row_pass<C, true>: + tok, put, then quad_ln
    assert (kernel.index("v0 = io_round<IO>(io_round<IO>(v0) + t.x);")
            < kernel.index("quad_ln<D, true>"))
    fwd = (CSRC / "spa_block.cu").read_text()
    assert ("row_pass<C, true, NoRows, BF, IO>(attn, wf, x2, tok, ln + 2 * D, "
            "ln + 3 * D, xn2,") in fwd
    for C in KERNEL_C:
        D = 2 * C
        hc = rg.hidden_chunk(D)
        layout, floats = rg.ffn_out_bwd_layout(C)
        off_b = -(-(2 * D * D + 8 * D * D + 2 * C * D) // (32 * max(D, hc))) * 32 * max(D, hc)
        assert floats == off_b + 8 * D * D + 2 * D * D


def test_ffn_out_bwd_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is its plain version, bit for bit, and
    launches nothing."""
    rng = np.random.RandomState(3)
    C = 16
    wts = _weights(rng, C)
    attn, tok, dout = _rand(rng, 2, 5, 6, 2 * C), _rand(rng, 2, 5, 6, 2 * C), _rand(rng, 2, 5, 6, C)
    reset_launches()
    got = sb.ffn_out_bwd(attn, tok, dout, wts)
    ref = sb.ffn_out_bwd_plain(attn, tok, dout, wts)
    assert len(got) == len(ref) == 8 and all(torch.equal(u, v) for u, v in zip(got, ref))
    assert sum(LAUNCHES.values()) == 0


def _np_params(seed, channels):
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, 2).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


def _emulated_step_a(attn, tok, dout, wts):
    rows = lambda t: t.reshape(-1, t.shape[-1])
    out = _ffn_out_bwd(rows(attn), rows(tok), rows(dout), wts)
    lead = attn.shape[:-1]
    return (*(t.reshape(*lead, t.shape[-1]) for t in out[:7]), out[7])


@pytest.mark.parametrize("C,V,h,w", [(16, 3, 8, 8), (32, 2, 9, 7)])
def test_spa_bwd_chain_with_emulated_step_a_matches_jax_vjp(C, V, h, w):
    """K3 with the emulated step a and the other steps plain (K3.b-e,
    wgrad, colsum) against jax.vjp of lft_tpu's fused SpaTrans block
    (interpret mode): every gradient, dpe_tok included, within 5e-4 max
    |ref| (tests/test_torch_train.py's bound)."""
    np_p = _np_params(4 + C, C)
    p = lft.params_from_numpy(np_p, device="cpu")
    prefix = "altblock.1.spa_trans."
    wts = sb.spa_weights(p, prefix)
    rng = np.random.RandomState(C + h)
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
    steps = (_emulated_step_a, *sb._PLAIN_STEPS[1:])
    got = sb._bwd(steps, xt, pe_tok, sb._with_mlp(wts), tok, m, l, attn, torch.from_numpy(dout),
                  8, 5)
    for name, g, r in zip(("x", "pe_tok") + order, got, ref):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 5e-4 * float(np.abs(r).max()), (name, err)
