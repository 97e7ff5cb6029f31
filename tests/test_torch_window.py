"""K2.3 `spa_window_attn` (and its `_res` form) as redesigned for the H100
(`lft_torch/csrc/window_attn.cuh`, launched by `spa_block.cu`), on the CPU:
its geometry and its arithmetic.

The CUDA kernel cannot run here. Its geometry is mirrored in Python
(`kernels/spa_block.py`: `window_items`, `window_thread`, `window_smem`,
the constants WA_*), and this file holds that mirror to the source and
checks that it scores exactly each query's in-image 5x5 window, once, for
every head. `_window_emulated` repeats the kernel's arithmetic (a score as
four partial sums added pairwise, a two-pass softmax: the 25 scores' max
first, then one exp a key, l by key rows, o in key order): against float64 its error
must be at most twice that of the f32 plain version. The K2 chain with the emulated
window step matches lft_tpu's fused SpaTrans forward (interpret mode)
within 1e-4. The kernel is held to the same bounds on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.kernels import spa_block as j_spa
from lft_tpu.models import lft as j_lft
from lft_tpu.ops.posenc import spatial_position
from lft_tpu.ops.unfold import unfold3x3_linear as j_unfold3x3_linear
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.spa_attn_hp import _gather_window, _window_valid
from lft_torch.models.lft import params_from_numpy
from lft_torch.ops.attention import windowed_attention
from lft_torch.ops.unfold import unfold3x3_linear

CSRC = Path(sb.__file__).resolve().parent.parent / "csrc"
H, K, R = 8, 5, 2
SIZES = [8, 16, 30, 32]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scored_pairs(V, h, w, D):
    """Every (view, query y, x, key y, x, head) the kernel scores and
    stores, from the Python mirror of its geometry, as an int array; and
    the halo pixels its threads read, checked inside the 20 x 20 halo."""
    dh = D // H
    ht = sb.WA_S // dh
    items = np.array(sb.window_items(V, h, w, D))             # [I, 4] view, y0, x0, group
    thr = np.array([sb.window_thread(t) for t in range(sb.WA_NT)])  # column, slice, row
    out = []
    for a in range(sb.WA_QY):
        for r in range(sb.WA_QY + 2 * R):
            if not a <= r <= a + 2 * R:        # query a's window spans key rows a .. a + 4
                continue
            for dx in range(2 * R + 1):
                hy, hx = thr[:, 2] + r, thr[:, 0] + dx    # the halo pixel read
                assert hy.max() < sb.WA_TY + 2 * R and hx.max() < sb.WA_TX + 2 * R
                for e in range(ht):
                    view = items[:, None, 0]
                    y = items[:, None, 1] + thr[None, :, 2] + a
                    x = items[:, None, 2] + thr[None, :, 0]
                    ky = items[:, None, 1] - R + hy[None]   # the image pixel staged there
                    kx = items[:, None, 2] - R + hx[None]
                    head = (items[:, None, 3] * sb.WA_G + thr[None, :, 1] * sb.WA_S + e * dh) // dh
                    keep = (y < h) & (x < w) & (ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)
                    cols = [np.broadcast_to(c, keep.shape)[keep] for c in (view, y, x, ky, kx, head)]
                    out.append(np.stack(cols, 1))
    return np.concatenate(out)


def _window_pairs(V, h, w):
    """Every in-image (query, key) pair of the 5x5 window, for every head."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            ok = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
            for view in range(V):
                for head in range(H):
                    n = int(ok.sum())
                    out.append(np.stack([np.full(n, view), ys[ok], xs[ok], ys[ok] + dy,
                                         xs[ok] + dx, np.full(n, head)], 1))
    return np.concatenate(out)


@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("w", SIZES)
@pytest.mark.parametrize("dh", [4, 8, 16])
def test_window_geometry_scores_each_in_image_window_once(h, w, dh):
    """Over the launch's (view, tile, head group) items and each block's 256
    threads (2 queries of a column, 16 channels each), the pairs scored are
    exactly every query's in-image 5x5 window for every head, each once."""
    V, D = 2, 8 * dh
    got = _scored_pairs(V, h, w, D)
    want = _window_pairs(V, h, w)
    key = lambda a: np.ravel_multi_index(a.T, (V, h, w, h, w, H))
    g, t = np.sort(key(got)), np.sort(key(want))
    assert len(np.unique(g)) == len(g), "a pair is scored twice"
    assert np.array_equal(g, t)


def test_window_python_geometry_mirrors_the_source():
    """The constants and the item order of spa_window_attn_kernel
    (window_attn.cuh, included by spa_block.cu); two blocks' k/v halos fit
    in an SM's shared memory (228 KB, 1 KB a block reserved); the halo's
    pixel stride lets 8 neighbouring pixels' float4 reads hit 32 distinct
    banks."""
    assert '#include "window_attn.cuh"' in (CSRC / "spa_block.cu").read_text()
    src = (CSRC / "window_attn.cuh").read_text()
    for line in ("constexpr int WA_TX = 16, WA_TY = 16;", "constexpr int WA_QY = 2;",
                 "constexpr int WA_G = 32;", "constexpr int WA_S = 16;",
                 "constexpr int WA_LD = WA_G + 4;",
                 "constexpr int WA_NT = WA_TX * (WA_TY / WA_QY) * (WA_G / WA_S);",
                 "constexpr size_t WA_BYTES = 2 * static_cast<size_t>(WA_BUF) * sizeof(float);",
                 "__launch_bounds__(WA_NT, 2)",
                 "const int i = blockIdx.x, tile = i % per_view / G;",
                 "const int view = i / per_view, y0 = tile / ntx * WA_TY, x0 = tile % ntx * WA_TX, g = i % G;",
                 "const int tx = lane & 15, half = lane >> 4;",
                 "const int ry = WA_QY * (threadIdx.x >> 5);"):
        assert line in src, line
    assert (sb.WA_TX, sb.WA_TY, sb.WA_QY, sb.WA_G, sb.WA_S) == (16, 16, 2, 32, 16)
    assert sb.WA_TX * sb.WA_TY // sb.WA_QY * sb.WA_G // sb.WA_S == sb.WA_NT == 256
    assert sb.window_smem() == 115200 and 2 * (sb.window_smem() + 1024) <= 233472
    ld = sb.WA_G + 4
    banks = {(4 * (p * ld // 4)) % 32 for p in range(8)}
    assert banks == set(range(0, 32, 4)) and (ld * 4) % 16 == 0
    # the window's radius, which K2.3 and K5 take from spa.cuh
    assert "constexpr int R = 2;" in (CSRC / "spa.cuh").read_text()


def _window_emulated(q, k, v, num_heads=H):
    """The kernel's arithmetic in plain PyTorch: (attn, m, l). Per query and
    head its 25 scores (each four partial sums of the head's channels,
    added pairwise; out-of-image keys at -inf), their max m, one exp a key,
    l the sum of the five key rows' sums, o summed in key order, attn = o /
    l."""
    B, h, w, E = q.shape
    dh = E // num_heads
    qh = q.reshape(B, h, w, 1, num_heads, dh) * float(dh) ** -0.5
    kw = _gather_window(k, K).reshape(B, h, w, K * K, num_heads, dh)
    vw = _gather_window(v, K).reshape(B, h, w, K * K, num_heads, dh)
    prod = (qh * kw).reshape(B, h, w, K * K, num_heads, dh // 4, 4)
    t = prod[..., 0, :]
    for i in range(1, dh // 4):
        t = t + prod[..., i, :]
    s = (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3])
    valid = torch.from_numpy(_window_valid(h, w, K)).to(q.device)[..., None]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(3)
    e = torch.exp(s - m[:, :, :, None])
    l = torch.zeros_like(m)
    for j0 in range(0, K * K, K):
        row = e[:, :, :, j0]
        for j in range(j0 + 1, j0 + K):
            row = row + e[:, :, :, j]
        l = l + row
    o = torch.zeros(B, h, w, num_heads, dh, dtype=q.dtype)
    for j in range(K * K):
        o = o + e[:, :, :, j, :, None] * vw[:, :, :, j]
    return (o / l[..., None]).reshape(B, h, w, E), m, l


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


@pytest.mark.parametrize("C,h,w", [(16, 8, 8), (16, 30, 30), (32, 16, 16), (32, 17, 40),
                                   (64, 32, 32), (64, 30, 16)])
def test_window_row_softmax_keeps_f32_accuracy(C, h, w):
    """The kernel's two-pass softmax: attn, m and l within 1e-5 max(1, max
    |plain|) of the plain version, and against float64 within twice the
    plain version's error."""
    rng = np.random.RandomState(C + h + w)
    q, k, v = (torch.from_numpy(rng.randn(3, h, w, 2 * C).astype(np.float32)) for _ in range(3))
    got = _window_emulated(q, k, v)
    ref = sb.window_attn_plain(q, k, v, H, K)
    exact = sb.window_attn_plain(q.double(), k.double(), v.double(), H, K)
    for g, r, e in zip(got, ref, exact):
        assert _err(g, r.double()) <= 1e-5 * max(1.0, float(r.abs().max()))
        assert _err(g, e) <= 2 * _err(r, e) + 1e-7 * float(e.abs().max())


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for C in (16, 32, 64):
        p = j_lft.init_params(jax.random.PRNGKey(C), JArgs(angRes=5, scale_factor=2, channels=C,
                                                           model_name="LFT"))
        out[C] = {k: np.asarray(v) for k, v in p.items()}
    return out


@pytest.mark.parametrize("C,h,w", [(16, 8, 8), (16, 30, 30), (32, 16, 16), (64, 32, 32)])
def test_spa_chain_with_emulated_window_step_matches_jax_fused(jax_params, C, h, w):
    """K2 with the emulated window step (its other steps plain) against
    lft_tpu's fused SpaTrans block (Pallas, interpret mode) within 1e-4, at
    every head width (C 16, 32, 64: 4, 8, 16) and h, w in {8, 16, 30, 32};
    the plain window step likewise."""
    np_p = jax_params[C]
    prefix = "altblock.2.spa_trans."
    x = (np.random.RandomState(h + C).rand(2, h, w, C) - 0.5).astype(np.float32)
    spa_pe = spatial_position(h, w, C)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    pe_tok_j = j_unfold3x3_linear(jnp.asarray(spa_pe)[None], jp[prefix + "MLP.weight"])[0]
    ref = np.asarray(j_spa.spa_trans_block_fused(jnp.asarray(x), pe_tok_j, jp, prefix, H, K))
    wts = sb.spa_weights(params_from_numpy(np_p, device="cpu"), prefix)
    pe_tok = unfold3x3_linear(torch.from_numpy(spa_pe)[None], wts["mlp"])[0].contiguous()
    tok, xn = sb.tokenize_ln_plain(torch.from_numpy(x), pe_tok, wts)
    q, k, v = sb.qkv_plain(xn, tok, wts)
    for attn in (_window_emulated(q, k, v)[0], sb.window_attn(q, k, v, H, K)):
        out = sb.ffn_out_plain(*sb.outproj_ln_plain(attn, tok, wts)[::-1], wts)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_window_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is its plain version, bit for bit, with
    and without stats, and launches nothing."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 9, 7, 64).astype(np.float32)) for _ in range(3))
    reset_launches()
    assert torch.equal(sb.window_attn(q, k, v, H, K), windowed_attention(q, k, v, H, K))
    got = sb.window_attn(q, k, v, H, K, with_stats=True)
    ref = sb.window_attn_plain(q, k, v, H, K)
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert sum(LAUNCHES.values()) == 0
