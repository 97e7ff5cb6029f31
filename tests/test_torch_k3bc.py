"""K3.b `spa_ln_qkv` and K3.c `spa_window_attn_bwd`, steps b and c of the
fused SpaTrans backward, on the CPU: their arithmetic and the sources'
shape.

The CUDA kernels cannot run here. K3.b is K2.2's kernel with an LN1
prologue (`lft_torch/csrc/spa_block.cu`: `spa_qkv_kernel<C, true>`), so its
scheme is `RowLN`'s (common.cuh; `_row_ln` below) followed by K2.2's three
passes as tests/test_torch_proj.py's `_qkv` emulates them from the
wrapper's own weight stream (`kernels/rowgemm.py:qkv_stream`): against
float64 each of xn, q, k, v within twice the f32 plain version's error, and
within 1e-5 max |plain| of the plain version. K3.c launches K5's backward
(`csrc/spa_attn_hp.cu`), whose two passes tests/test_torch_hp.py's
`_bwd_emulated` repeats: the function, through both that emulation and the
port's plain `window_attn_bwd_plain`, matches `jax.vjp` of lft_tpu's
head-packed window attention (interpret mode) within 1e-4 with cotangent
dattn, and the K3 chain with the emulated steps b and c (the other steps
plain) matches `jax.vjp` of lft_tpu's fused SpaTrans block within 5e-4 max
|ref| (tests/test_torch_ffnbwd.py's bound). On the card the kernels are held
to the forward bit for bit (tests/test_torch_cuda.py, chip_smoke.py,
`compare_k3`).
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ffnbwd import _np_params
from test_torch_hp import _bwd_emulated, _fwd_stats_emulated
from test_torch_proj import _qkv

from lft_tpu.kernels import spa_attn_hp as j_hp
from lft_tpu.kernels.spa_block import spa_block_core
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_attn_hp as hp
from lft_torch.kernels import spa_block as sb
from lft_torch.models import lft
from lft_torch.ops.posenc import spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

CSRC = Path(rg.__file__).resolve().parent.parent / "csrc"
H, K = 8, 5
SHAPES = [(16, 3, 9, 7), (32, 2, 17, 40)]   # (C, views, h, w)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fma(a, b, c):
    """fmaf(a, b, c): one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def _row_ln(x, g, b):
    """RowLN<D> (common.cuh) in plain PyTorch over rows x [T, D]: lane l of
    a warp holds columns l + 32 e and sums them in e order, the warp adds
    the 32 sums by a butterfly (xor 16, 8, 4, 2, 1); mean = sum / D; the
    variance likewise from fmaf(d, d, .) of the deviations; then
    ((x - mean) rsqrt(var + 1e-5)) g + b, the last step one fmaf."""
    T, D = x.shape
    lanes = torch.arange(32)

    def warp_sum(parts):                      # [T, 32] -> [T]
        for o in (16, 8, 4, 2, 1):
            parts = parts + parts[:, lanes ^ o]
        return parts[:, 0]

    cols = x.reshape(T, D // 32, 32)          # [t, e, lane] = x[t, 32 e + lane]
    s = cols[:, 0]
    for e in range(1, D // 32):
        s = s + cols[:, e]
    mu = warp_sum(s) / D
    d = cols - mu[:, None, None]
    q = torch.zeros(T, 32)
    for e in range(D // 32):
        q = _fma(d[:, e], d[:, e], q)
    rstd = torch.rsqrt(warp_sum(q) / D + 1e-5)
    return _fma(d * rstd[:, None, None], g.reshape(D // 32, 32), b.reshape(D // 32, 32)
                ).reshape(T, D)


def _ln_qkv(tok, pe_tok, wts):
    """K3.b in its kernel's arithmetic: tok [V, h, w, D], pe_tok [h, w, D]
    -> (xn, q, k, v) rows [T, D]: the LN1 prologue on tok + pe_tok[t % hw],
    then K2.2's passes, q and k on xn, v on tok."""
    D = tok.shape[-1]
    rows = tok.reshape(-1, D)
    pe = pe_tok.reshape(-1, D)
    xn = _row_ln(rows + pe[torch.arange(rows.shape[0]) % pe.shape[0]], wts["ln"][0],
                 wts["ln"][1])
    return (xn, *_qkv(xn, rows, wts))


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))


def _weights(rng, C):
    D = 2 * C
    return dict(wqk=_rand(rng, D, 2 * D, scale=D ** -0.5), wv=_rand(rng, D, D, scale=D ** -0.5),
                ln=torch.stack([1 + 0.1 * _rand(rng, D), 0.1 * _rand(rng, D),
                                1 + 0.1 * _rand(rng, D), 0.1 * _rand(rng, D)]))


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


@pytest.mark.parametrize("C,V,h,w", SHAPES + [(64, 2, 8, 9)])
def test_ln_qkv_scheme_keeps_f32_accuracy(C, V, h, w):
    """K3.b's arithmetic (RowLN, then K2.2's three 3xTF32 passes; T = V h w
    leaves a ragged last tile): each of xn, q, k, v against float64 within
    twice the f32 plain version's error, and within 1e-5 max |plain| of
    `ln_qkv_plain`."""
    rng = np.random.RandomState(C + h)
    D = 2 * C
    wts = _weights(rng, C)
    tok, pe_tok = 3 * _rand(rng, V, h, w, D), _rand(rng, h, w, D)
    got = _ln_qkv(tok, pe_tok, wts)
    ref = [t.reshape(-1, D) for t in sb.ln_qkv_plain(tok, pe_tok, wts)]
    exact = [t.reshape(-1, D) for t in sb.ln_qkv_plain(
        tok.double(), pe_tok.double(), {k: v.double() for k, v in wts.items()})]
    for name, g, r, e in zip(("xn", "q", "k", "v"), got, ref, exact):
        assert _err(g, e) <= 2 * _err(r, e), (name, _err(g, e), _err(r, e))
        assert _err(g, r.double()) <= 1e-5 * float(r.abs().max()), name


@pytest.mark.parametrize("C,V,h,w", SHAPES)
def test_window_attn_bwd_matches_jax_vjp(C, V, h, w):
    """K3.c's function, with cotangent dattn, against jax.vjp of lft_tpu's
    `windowed_attention_headpacked` (interpret mode) within 1e-4: through
    the port's plain version (from the plain forward's attn, m, l) and
    through the emulated K5 backward (from the emulated K2.3 res's m, l)."""
    E = 2 * C
    assert j_hp.headpacked_applicable(h, w, E, H, K)
    rng = np.random.RandomState(E + h + w)
    q, k, v, dattn = (((rng.rand(V, h, w, E) - 0.5) * 2).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda *a: j_hp.windowed_attention_headpacked(*a, H, K),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dattn))
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dattn))
    attn, m, l = sb.window_attn_plain(qt, kt, vt, H, K)
    plain = sb.window_attn_bwd_plain(qt, kt, vt, attn, dt, m, l, H, K)
    emulated = _bwd_emulated(qt, kt, vt, *_fwd_stats_emulated(qt, kt), dt)[:3]
    for got in (plain, emulated):
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0, err_msg=name)


def _emulated_step_b(tok, pe_tok, wts):
    return tuple(t.reshape(tok.shape) for t in _ln_qkv(tok, pe_tok, wts))


def _emulated_step_c(q, k, v, attn, dattn, m, l, num_heads, ksize):
    assert (num_heads, ksize) == (H, K)
    return _bwd_emulated(q, k, v, m, l, dattn)[:3]


@pytest.mark.parametrize("C,V,h,w", SHAPES)
def test_spa_bwd_chain_with_emulated_steps_b_c_matches_jax_vjp(C, V, h, w):
    """K3 with the emulated steps b and c and the other steps plain (K3.a,
    K3.d, K3.e, wgrad, colsum) against jax.vjp of lft_tpu's fused SpaTrans
    block (interpret mode): every gradient, dpe_tok included, within 5e-4
    max |ref|."""
    np_p = _np_params(6 + C, C)
    p = lft.params_from_numpy(np_p, device="cpu")
    prefix = "altblock.2.spa_trans."
    wts = sb.spa_weights(p, prefix)
    rng = np.random.RandomState(C + w)
    x = ((rng.rand(V, h, w, C) - 0.5) * 2).astype(np.float32)
    dout = ((rng.rand(V, h, w, C) - 0.5) * 2).astype(np.float32)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C))[None],
                              p[prefix + "MLP.weight"])[0].contiguous()
    order = sb.WEIGHTS
    _, vjp = jax.vjp(lambda x_, pe_, *w_: spa_block_core(x_, pe_, *w_, H, K), jnp.asarray(x),
                     jnp.asarray(pe_tok.numpy()), *(jnp.asarray(wts[n].numpy()) for n in order))
    ref = vjp(jnp.asarray(dout))
    xt = torch.from_numpy(x)
    _, tok, m, l, attn = sb.spa_block_plain(xt, pe_tok, wts, H, K, with_res=True)
    steps = list(sb._PLAIN_STEPS)
    steps[1], steps[2] = _emulated_step_b, _emulated_step_c
    got = sb._bwd(tuple(steps), xt, pe_tok, sb._with_mlp(wts), tok, m, l, attn,
                  torch.from_numpy(dout), H, K)
    for name, g, r in zip(("x", "pe_tok") + order, got, ref):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 5e-4 * float(np.abs(r).max()), (name, err)


def test_k3bc_wrappers_plain_on_cpu_and_sources():
    """On CPU tensors both wrappers are their plain versions, bit for bit,
    and launch nothing. The sources: no old K3.c kernel and no FP32-pipe
    product left; K3.b's entry launches K2.2's kernel with the prologue at
    K2.2's geometry (RowProj's shared memory, the wrapper's scratch of
    `qkv_floats`, its three pieces); K3.c's wrapper launches K5's backward
    with its [V, h, w, H] D scratch, ten pointers as the entry takes them."""
    rng = np.random.RandomState(7)
    C, V, h, w = 16, 2, 9, 7
    D = 2 * C
    wts = _weights(rng, C)
    tok, pe_tok = _rand(rng, V, h, w, D), _rand(rng, h, w, D)
    q, k, v, attn, dattn = (_rand(rng, V, h, w, D) for _ in range(5))
    m, l = _rand(rng, V, h, w, H), 1 + _rand(rng, V, h, w, H).abs()
    reset_launches()
    for got, ref in ((sb.ln_qkv(tok, pe_tok, wts), sb.ln_qkv_plain(tok, pe_tok, wts)),
                     (sb.window_attn_bwd(q, k, v, attn, dattn, m, l, H, K),
                      sb.window_attn_bwd_plain(q, k, v, attn, dattn, m, l, H, K))):
        assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert sum(LAUNCHES.values()) == 0

    srcs = {p.name: p.read_text() for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for name, text in srcs.items():
        for gone in (r"\bspa_window_attn_bwd_kernel\b", r"\bgemm_acc\b", r"\bspa_ln_qkv_kernel\b",
                     r"\bload_rows\b"):
            assert not re.search(gone, text), (name, gone)
    for entry in ("lft_spa_window_attn_bwd", "lft_spa_ln_qkv"):
        assert f'extern "C" int {entry}(' not in srcs["spa_block_bwd.cu"], entry
    spa = srcs["spa_block.cu"]
    entry = spa.split('extern "C" int lft_spa_ln_qkv(', 1)[1].split("}", 1)[0]
    assert "return qkv<true>(nullptr, tok, wqk, wv, wf, q, k, v, T, C, pe_tok, ln, xn, hw," \
        in entry
    for line in ("auto kernel = spa_qkv_kernel<CC, LN1, BF, IO>;",
                 "LFT_SET_SMEM(kernel, L::BYTES);",
                 "row_pass<C, false, Ln1Rows<2 * C, IO>, BF, IO>(tok, wf, q, nullptr, nullptr, "
                 "nullptr,",
                 "if constexpr (LN1) ln1 = Ln1Rows<L::D, IO>{pe_tok, ln, xn_out, hw};",
                 "L::BYTES, s>>>(LN1 ? xn_out : xn, tok, wf, q,",
                 "RL::apply(v[r], ln, ln + D);"):
        assert line in spa, line
    assert "qkv_floats(D // 2)" in inspect.getsource(sb.ln_qkv)
    for C_ in (16, 32, 64):
        assert rg.qkv_floats(C_) == 3 * 2 * (2 * C_) ** 2
        assert rg.proj_smem(C_) <= rg.RG_SMEM_MAX
    assert 'name = _bwd_name("spa_window_attn_bwd", q, plan)' in inspect.getsource(
        sb.window_attn_bwd)
    assert 'half=name.endswith("_bf16"), sites=sites[0] if sites else None' in \
        inspect.getsource(sb.window_attn_bwd)
    c_src = inspect.getsource(hp.spa_attn_hp_bwd)
    for line in ('entry = f"lft_spa_attn_{fam}_bwd_bf16io"',
                 'entry = "lft_spa_attn_hp_bwd" + ("_bf16" if half else "")',
                 'fn = _build.bind("spa_attn_hp", entry, len(ins) + 6,'):
        assert line in c_src, line
    assert hp._family("spa_window_attn_bwd_bf16io") == "hp"
    assert "dsum = torch.empty(B, h, w, num_heads" in c_src
    assert '_build.launch("spa_attn_hp", kernel, fn' in c_src
    hp_entry = srcs["spa_attn_hp.cu"].split('extern "C" int lft_spa_attn_hp_bwd(', 1)[1]
    assert hp_entry.split(")", 1)[0].count("float*") == 10
