"""K5 `spa_attn_hp` (forward, `_res`) and `spa_attn_hp_bwd` as redesigned
for the H100 on K2.3's window layout (`lft_torch/csrc/spa_attn_hp.cu`,
`csrc/window_attn.cuh`), on the CPU: geometry and arithmetic.

The CUDA kernels cannot run here. The forward is K2.3's kernel (its
geometry and arithmetic are held in tests/test_torch_window.py). The
backward's two passes are mirrored in Python (`kernels/spa_block.py`: pass
q on K2.3's `window_items` / `window_thread` / `window_smem`, pass kv on
`hp_kv_items` / `window_thread` / `hp_kv_smem`); this file holds that mirror
to the sources and checks that each pass scores every in-image (query,
key, head) pair of the 5x5 window once and stores each output pixel and
head once. `_bwd_emulated` repeats the kernels' arithmetic (scores as
four partial sums added pairwise, the forward's two-pass softmax
statistics, D in key order, the key side's gather): against float64 its
dq, dk and dv errors are at most twice those of the f32 plain version, and
it matches `jax.vjp` of lft_tpu's `windowed_attention_headpacked`
(interpret mode) within 1e-4. The kernels are held to the same bounds on
the card (tests/test_torch_cuda.py, chip_smoke.py, `compare_hp`).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lft_tpu.kernels import spa_attn_hp as j_hp
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import spa_attn_hp as hp
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.spa_attn_hp import _gather_window, _window_valid

CSRC = Path(sb.__file__).resolve().parent.parent / "csrc"
H, K, R = 8, 5, 2
HALO_Y, HALO_X = sb.WA_TY + 2 * R, sb.WA_TX + 2 * R
SIZES = [(8, 8), (16, 16), (30, 30), (32, 32), (3, 2), (17, 40), (8, 101)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- geometry ---

def test_hp_python_geometry_mirrors_the_sources():
    """The forward launches K2.3's kernel; the two passes' constants, item
    order, thread mapping and halo reads are those of the Python mirror;
    the old all-heads kernels are gone, and two blocks of each pass fit in
    an SM (228 KB, 1 KB a block reserved)."""
    hdr = (CSRC / "window_attn.cuh").read_text()
    src = (CSRC / "spa_attn_hp.cu").read_text()
    spa = (CSRC / "spa_block.cu").read_text()
    assert '#include "window_attn.cuh"' in src and '#include "window_attn.cuh"' in spa
    assert "spa_window_attn_kernel(" in hdr and "spa_window_attn_kernel(" not in spa
    for line in ("constexpr int WA_TX = 16, WA_TY = 16;", "constexpr int WA_QY = 2;",
                 "constexpr int WA_G = 32;", "constexpr int WA_S = 16;",
                 "constexpr int WA_NT = WA_TX * (WA_TY / WA_QY) * (WA_G / WA_S);"):
        assert line in hdr, line
    for line in ("constexpr int KV_HEADS = 2;",
                 "static constexpr int LD = KV_HEADS * DH + 4;",
                 "static constexpr size_t BYTES = 2 * static_cast<size_t>(BUF) * sizeof(float);",
                 # forward: K2.3's kernel over E / 32 groups
                 "auto kernel = spa_window_attn_kernel<DHV, STATS>;",
                 "const int grid = static_cast<int>(n_items(B, h, w, E / WA_G));",
                 # pass q: K2.3's items and threads, a query's key rows
                 "const int i = blockIdx.x, tile = i % per_view / G;",
                 "const int view = i / per_view, y0 = tile / ntx * WA_TY, x0 = tile % ntx * WA_TX, g = i % G;",
                 "const int tx = lane & 15, half = lane >> 4;",
                 "smem + ((ry + a + r) * WA_HX + tx) * WA_LD + half * WA_S + e * DH;",
                 # pass kv: head pairs
                 "const int grid_kv = static_cast<int>(n_items(B, h, w, H / KV_HEADS));",
                 "const int i = blockIdx.x, tile = i % per_view / P;",
                 "const int view = i / per_view, y0 = tile / ntx * WA_TY, x0 = tile % ntx * WA_TX, pr = i % P;",
                 "const int tx = lane & 15, e = lane >> 4;",
                 "const int row = ((ry + a + r) * WA_HX + tx) * LD;"):
        assert line in src, line
    assert src.count("const int ry = WA_QY * (threadIdx.x >> 5);") == 2
    assert src.count("__launch_bounds__(WA_NT, 2)") == 2
    assert "spa_attn_hp_kernel" not in src and "stage_tile_halo" not in src
    assert sb.HP_KV_HEADS == 2 and sb.window_smem() == sb.hp_kv_smem(16) == 115200
    for dh in (4, 8, 16):
        assert 2 * (sb.hp_kv_smem(dh) + 1024) <= 233472
        ld = sb.HP_KV_HEADS * dh + 4   # 8 neighbouring pixels' float4 reads: 32 banks
        assert {(ld * p) % 32 for p in range(8)} == set(range(0, 32, 4))
    assert [sb.hp_thread_pixels(t) for t in (0, 17, 255)] == [[(0, 0), (1, 0)], [(0, 1), (1, 1)],
                                                              [(14, 15), (15, 15)]]
    assert sb.window_thread(17) == (1, 1, 0)


def _window_pairs(V, h, w):
    """Every in-image (view, query y, x, key y, x, head) of the 5x5 window."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            ok = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
            n = int(ok.sum())
            for view in range(V):
                for head in range(H):
                    out.append(np.stack([np.full(n, view), ys[ok], xs[ok], ys[ok] + dy,
                                         xs[ok] + dx, np.full(n, head)], 1))
    return np.concatenate(out)


def _pass_pairs(which, V, h, w, dh):
    """(pairs, stores) of one pass from the Python mirror: every (view,
    query y, x, key y, x, head) it scores and every (view, y, x, head) it
    writes (dq and D, or dk and dv). A thread's pixels are the tile's
    (ry + a, tx); its 5x5 neighbours are halo pixels (ry + a + r, tx + dx),
    staged from the image at (y0 - 2, x0 - 2) + their halo position."""
    if which == "q":   # a 32-float group of heads, a thread 16 floats of it
        items = np.array(sb.window_items(V, h, w, H * dh))
        thr = np.array([sb.window_thread(t) for t in range(sb.WA_NT)])
        heads = [lambda it, th, e=e: (it[:, None, 3] * sb.WA_G + th[None, :, 1] * sb.WA_S
                                      + e * dh) // dh for e in range(sb.WA_S // dh)]
    else:              # a head pair, a thread one head of it
        items = np.array(sb.hp_kv_items(V, h, w, H))
        thr = np.array([sb.window_thread(t) for t in range(sb.WA_NT)])   # slice = head
        heads = [lambda it, th: it[:, None, 3] * sb.HP_KV_HEADS + th[None, :, 1]]
    pixels = np.array([sb.hp_thread_pixels(t) for t in range(sb.WA_NT)])   # [256, 2, (y, x)]
    pairs, stores = [], []
    for a in range(sb.WA_QY):
        py, px = pixels[:, a, 0], pixels[:, a, 1]
        assert np.array_equal(py, thr[:, 2] + a) and np.array_equal(px, thr[:, 0])
        view = items[:, None, 0]
        y, x = items[:, None, 1] + py[None], items[:, None, 2] + px[None]   # the thread's pixel
        own = (y < h) & (x < w)
        for head in heads:
            hd = np.broadcast_to(head(items, thr), own.shape)
            stores.append(np.stack([np.broadcast_to(c, own.shape)[own]
                                    for c in (view, y, x, hd)], 1))
            for r in range(2 * R + 1):
                for dx in range(2 * R + 1):
                    hy, hx = py + r, px + dx                     # the halo pixel read
                    assert hy.max() < HALO_Y and hx.max() < HALO_X
                    pix = hy * HALO_X + hx
                    ny = items[:, None, 1] - R + (pix // HALO_X)[None]   # staged from
                    nx = items[:, None, 2] - R + (pix % HALO_X)[None]
                    assert np.array_equal(ny, y + r - R) and np.array_equal(nx, x + dx - R)
                    keep = own & (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
                    q_yx, k_yx = ((y, x), (ny, nx)) if which == "q" else ((ny, nx), (y, x))
                    cols = (view, *q_yx, *k_yx, hd)
                    pairs.append(np.stack([np.broadcast_to(c, keep.shape)[keep] for c in cols],
                                          1))
    return np.concatenate(pairs), np.concatenate(stores)


@pytest.mark.parametrize("which", ["q", "kv"])
@pytest.mark.parametrize("dh", [4, 8, 16])
@pytest.mark.parametrize("h,w", SIZES)
def test_bwd_pass_scores_each_in_image_pair_once(which, dh, h, w):
    """Over the pass's items and each block's 256 threads, the (query, key,
    head) pairs scored are exactly the in-image 5x5 windows' pairs, each
    once (pass q from the query's side, pass kv from the key's), and every
    in-image pixel and head is stored exactly once."""
    V = 2
    pairs, stores = _pass_pairs(which, V, h, w, dh)
    key = lambda t, shape: np.sort(np.ravel_multi_index(t.T, shape))
    got, want = key(pairs, (V, h, w, h, w, H)), key(_window_pairs(V, h, w), (V, h, w, h, w, H))
    assert len(np.unique(got)) == len(got), "a pair is scored twice"
    assert np.array_equal(got, want)
    assert np.array_equal(key(stores, (V, h, w, H)), np.arange(V * h * w * H))


# ------------------------------------------------------------ arithmetic ---

def _dot4(a, b):
    """a . b over the last axis as the kernels sum it: channel d into
    partial sum d % 4, the four partial sums added pairwise."""
    prod = a * b
    t = prod.reshape(*prod.shape[:-1], -1, 4)
    acc = t[..., 0, :]
    for i in range(1, t.shape[-2]):
        acc = acc + t[..., i, :]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def _heads(t, num_heads=H):
    return t.reshape(*t.shape[:-1], num_heads, t.shape[-1] // num_heads)


def _fwd_stats_emulated(q, k):
    """(m, l) [B, h, w, H] as K2.3's kernel (K5 res) computes them: the 25
    scores' max, one exp a key, l the sum of the five key rows' sums."""
    B, h, w, E = q.shape
    scale = float(E // H) ** -0.5
    s = _dot4(_heads(q * scale)[:, :, :, None], _heads(_gather_window(k, K)))
    valid = torch.from_numpy(_window_valid(h, w, K))[..., None]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(3)
    e = torch.exp(s - m[:, :, :, None])
    l = torch.zeros_like(m)
    for j0 in range(0, K * K, K):
        row = e[:, :, :, j0]
        for j in range(j0 + 1, j0 + K):
            row = row + e[:, :, :, j]
        l = l + row
    return m, l


def _bwd_emulated(q, k, v, m, l, dout):
    """The two passes' arithmetic in plain PyTorch: (dq, dk, dv, D).

    Pass q, per query and head: the forward's 25 scores, e_j = exp(s_j -
    m), dp_j = dout . v_j, D = (sum_j e_j dp_j) / l in key order, dq =
    scale / l sum_j e_j (dp_j - D) k_j. Pass kv, per key and head, over the
    window's queries o in row-major order: s = (q_o scale) . k, p = exp(s -
    m_o) / l_o, ds = p (dout_o . v - D_o), dk = sum ds q_o scale, dv = sum p
    dout_o."""
    B, h, w, E = q.shape
    scale = float(E // H) ** -0.5
    valid = torch.from_numpy(_window_valid(h, w, K))[..., None]   # [h, w, 25, 1]
    il = 1.0 / l
    qs = q * scale
    # pass q
    kw, vw = _heads(_gather_window(k, K)), _heads(_gather_window(v, K))
    s = _dot4(_heads(qs)[:, :, :, None], kw).masked_fill(~valid, float("-inf"))
    e = torch.exp(s - m[:, :, :, None])
    dp = _dot4(_heads(dout)[:, :, :, None], vw).masked_fill(~valid, 0.0)
    dsum = torch.zeros_like(m)
    for j in range(K * K):
        dsum = dsum + e[:, :, :, j] * dp[:, :, :, j]
    dd = dsum * il
    c = e * (dp - dd[:, :, :, None])
    dq = torch.zeros_like(_heads(q))
    for j in range(K * K):
        dq = dq + c[:, :, :, j, :, None] * kw[:, :, :, j]
    dq = dq * (il * scale)[..., None]
    # pass kv: the window of a key holds the queries whose window holds it
    qw, gw = _heads(_gather_window(qs, K)), _heads(_gather_window(dout, K))
    mw, ilw, dw = (_gather_window(t, K) for t in (m, il, dd))
    p = (torch.exp(_dot4(qw, _heads(k)[:, :, :, None]) - mw) * ilw).masked_fill(~valid, 0.0)
    ds = p * (_dot4(gw, _heads(v)[:, :, :, None]) - dw)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for j in range(K * K):
        dk = dk + ds[:, :, :, j, :, None] * qw[:, :, :, j]
        dv = dv + p[:, :, :, j, :, None] * gw[:, :, :, j]
    return (dq.reshape(B, h, w, E), dk.reshape(B, h, w, E), dv.reshape(B, h, w, E), dd)


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


@pytest.mark.parametrize("C,h,w", [(16, 8, 8), (16, 30, 30), (32, 16, 16), (32, 17, 40),
                                   (64, 32, 32), (64, 30, 16)])
def test_bwd_emulated_keeps_f32_accuracy(C, h, w):
    """The two passes' arithmetic, from the emulated K5 res's (m, l): dq, dk
    and dv within 5e-4 max |plain| of the plain backward, and against
    float64 (from the float64 forward's (m, l)) within twice the error of
    the f32 plain version (from the f32 plain forward's); D within 1e-5
    max(1, max |D|) of the plain D."""
    rng = np.random.RandomState(C + h + w)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, h, w, 2 * C).astype(np.float32))
                     for _ in range(4))
    m, l = _fwd_stats_emulated(q, k)
    got = _bwd_emulated(q, k, v, m, l, dout)
    _, mp, lp = hp.windowed_attention_headpacked_plain(q, k, v, H, K)
    ref = hp.windowed_attention_headpacked_bwd_plain(q, k, v, mp, lp, dout, H, K)
    q64, k64, v64, d64 = (t.double() for t in (q, k, v, dout))
    _, m64, l64 = hp.windowed_attention_headpacked_plain(q64, k64, v64, H, K)
    exact = hp.windowed_attention_headpacked_bwd_plain(q64, k64, v64, m64, l64, d64, H, K)
    for name, g, r, x in zip(("dq", "dk", "dv"), got, ref, exact):
        assert _err(g, r.double()) <= 5e-4 * float(r.abs().max()), name
        assert _err(g, x) <= 2 * _err(r, x), (name, _err(g, x), _err(r, x))
    d_plain = hp.windowed_attention_headpacked_dsum_plain(q, k, v, mp, lp, dout, H, K)
    assert _err(got[3], d_plain.double()) <= 1e-5 * max(1.0, float(d_plain.abs().max()))


@pytest.mark.parametrize("B,h,w,E", [(2, 8, 8, 32), (1, 8, 16, 64), (1, 16, 8, 128)])
def test_bwd_emulated_matches_jax_vjp(B, h, w, E):
    """The emulated kernels (K5 res's (m, l), then the two passes) against
    jax.vjp of lft_tpu's head-packed window attention (Pallas, interpret
    mode) within 1e-4, at every head width."""
    assert j_hp.headpacked_applicable(h, w, E, H, K)
    rng = np.random.RandomState(E + h)
    q, k, v, dout = (((rng.rand(B, h, w, E) - 0.5) * 2).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda *a: j_hp.windowed_attention_headpacked(*a, H, K),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    got = _bwd_emulated(qt, kt, vt, *_fwd_stats_emulated(qt, kt), dt)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0, err_msg=name)


def test_hp_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors each wrapper is its plain version, bit for bit (the
    forward with and without stats, the backward with and without D), and
    launches nothing; under grad `SpaAttnHpFn` saves (q, k, v, m, l) and
    nothing more."""
    rng = np.random.RandomState(5)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 9, 7, 64).astype(np.float32))
                     for _ in range(4))
    reset_launches()
    out, m, l = hp.windowed_attention_headpacked_plain(q, k, v, H, K)
    assert torch.equal(hp.spa_attn_hp_fwd(q, k, v, H, K), out)
    got = hp.spa_attn_hp_fwd(q, k, v, H, K, with_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, (out, m, l)))
    ref = hp.windowed_attention_headpacked_bwd_plain(q, k, v, m, l, dout, H, K)
    assert all(torch.equal(a, b) for a, b in zip(hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K),
                                                 ref))
    got = hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K, with_dsum=True)
    assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(got[3], hp.windowed_attention_headpacked_dsum_plain(q, k, v, m, l, dout,
                                                                           H, K))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = hp.windowed_attention_headpacked(*ins, H, K)
    assert type(y.grad_fn).__name__ == "SpaAttnHpFnBackward"
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5 and all(torch.equal(a, b) for a, b in zip(saved, (q, k, v, m, l)))
    grads = torch.autograd.grad(y, ins, dout)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert sum(LAUNCHES.values()) == 0
