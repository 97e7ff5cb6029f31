"""K6 `spa_attn_mxu` (forward, `_res`) and `spa_attn_mxu_bwd` on K5's
window kernels (`lft_torch/csrc/spa_attn_hp.cu`, `csrc/window_attn.cuh`),
on the CPU.

On the card K6 launches K5's kernels under its own names, so it computes
K5's function: every pixel attends, per head, to the in-image keys of its
5x5 window. The JAX kernel computes it tile-dense over `pick_tile`'s tiles
with a -1e30 mask. This file holds, on K6's geometries (views over 2048
pixels, 72 x 40 with partial 16 x 16 tiles, a one-column tile of a prime
width, 1-pixel-wide views and a 2 x 4 view), K5's plain version against
K6's plain version and against lft_tpu's K6 (its Pallas kernels in
interpret mode, as tests/test_torch_sweeps.py runs them): out, m and l
within atol 2e-5 / rtol 1e-4 (the same f32 math summed in another order),
and the three backwards from the same (m, l), K5 plain's, within 2e-5 max
|ref| per output. lft_tpu's interpret-mode K6 traces every tile and head
of a view (35 s a forward at 8 x 101), so it runs where marked below;
tests/test_torch_sweeps.py holds it at 48 x 48 and 8 x 101 too. It also
checks that K5's launches (`window_items` for the forward and the
backward's pass q, `hp_kv_items` for pass kv) cover every pixel and head
group of those views exactly once, and that the dense K6 source is gone.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lft_tpu.kernels import spa_attn as j_spa
from lft_torch.kernels import LAUNCHES, SWEEPS, _build, reset_launches
from lft_torch.kernels import spa_attn as sa
from lft_torch.kernels import spa_attn_hp as hp
from lft_torch.kernels import spa_block as sb

H, K = 8, 5
FWD = dict(atol=2e-5, rtol=1e-4)
BWD_REL = 2e-5

# (h, w, E, pick_tile, lft_tpu's forward, lft_tpu's backward)
GEOMETRIES = [
    (48, 48, 32, (8, 16), False, False),
    (64, 64, 32, (8, 16), True, True),
    (72, 40, 64, (8, 8), True, False),
    (8, 101, 64, (8, 1), False, False),
    (1, 128, 128, (1, 128), True, True),
    (128, 1, 64, (128, 1), True, True),
    (2, 4, 128, (2, 4), True, True),
]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2).astype(np.float32)


def _from_tiles(x, h, w, tile):
    """lft_tpu's [B, tiles, nq, H] statistics -> [B, h, w, H]."""
    th, tw = tile
    return np.asarray(x).reshape(-1, h // th, w // tw, th, tw, H).transpose(
        0, 1, 3, 2, 4, 5).reshape(-1, h, w, H)


def _to_tiles(x, h, w, tile):
    """[B, h, w, H] -> lft_tpu's [B, tiles, nq, H]."""
    th, tw = tile
    return np.asarray(x).reshape(-1, h // th, th, w // tw, tw, H).transpose(
        0, 1, 3, 2, 4, 5).reshape(-1, (h // th) * (w // tw), th * tw, H)


def _bwd_close(got, ref, what):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, (what, name)
        err, top = float(np.abs(g - r).max()), float(np.abs(r).max())
        assert err <= BWD_REL * top, (what, name, err, top)


@pytest.mark.parametrize("h,w,E,tile,jax_fwd,jax_bwd", GEOMETRIES,
                         ids=[f"{g[0]}x{g[1]}" for g in GEOMETRIES])
def test_k6_is_k5s_function(h, w, E, tile, jax_fwd, jax_bwd):
    """K5's plain forward (out, m, l) equals K6's plain forward and, where
    marked, lft_tpu's interpret-mode K6; the backwards of K5 plain, K6 plain
    and (where marked) lft_tpu's K6, all from K5 plain's (m, l), agree."""
    assert sa.pick_tile(h, w) == j_spa.pick_tile(h, w) == tile
    B = 2 if h * w <= 1024 else 1
    q, k, v, dout = (_rand((B, h, w, E), 600 + i) for i in range(4))
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    want = hp.windowed_attention_headpacked_plain(qt, kt, vt, H, K)
    got6 = sa.windowed_attention_mxu_plain(qt, kt, vt, H, K)
    for name, g, r in zip(("out", "m", "l"), got6, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=f"K6 plain {name}", **FWD)
    if jax_fwd:
        out_j, m_j, l_j = j_spa._fwd(*map(jnp.asarray, (q, k, v)), H, K, with_stats=True)
        got_j = (np.asarray(out_j), _from_tiles(m_j, h, w, tile), _from_tiles(l_j, h, w, tile))
        for name, g, r in zip(("out", "m", "l"), got_j, want):
            np.testing.assert_allclose(g, r.numpy(), err_msg=f"lft_tpu K6 {name}", **FWD)

    _, m, l = want
    ref = hp.windowed_attention_headpacked_bwd_plain(qt, kt, vt, m, l, dt, H, K)
    _bwd_close(sa.windowed_attention_mxu_bwd_plain(qt, kt, vt, m, l, dt, H, K), ref, "K6 plain")
    if jax_bwd:
        res = (*map(jnp.asarray, (q, k, v)), jnp.asarray(_to_tiles(m, h, w, tile)),
               jnp.asarray(_to_tiles(l, h, w, tile)))
        _bwd_close(j_spa._vjp_bwd(H, K, res, jnp.asarray(dout)), ref, "lft_tpu K6")


def _covered(items, h, w, per_item):
    """[(view, y, x, group)] of every in-image pixel a list of (view, y0, x0,
    group) 16 x 16 tile items takes, `per_item` groups a pixel."""
    out = []
    for view, y0, x0, grp in items:
        ys, xs = np.meshgrid(np.arange(y0, min(y0 + sb.WA_TY, h)),
                             np.arange(x0, min(x0 + sb.WA_TX, w)), indexing="ij")
        n = ys.size
        out.append(np.stack([np.full(n, view), ys.ravel(), xs.ravel(), np.full(n, grp)], 1))
    got = np.concatenate(out)
    assert got[:, 3].max() < per_item
    return np.sort(np.ravel_multi_index(got.T, (int(got[:, 0].max()) + 1, h, w, per_item)))


@pytest.mark.parametrize("dh", [4, 8, 16])
@pytest.mark.parametrize("h,w", [g[:2] for g in GEOMETRIES],
                         ids=[f"{g[0]}x{g[1]}" for g in GEOMETRIES])
def test_k5_items_cover_k6_views_once(h, w, dh):
    """Over `window_items` (K2.3's forward and pass q: 32-float head groups)
    and `hp_kv_items` (pass kv: head pairs), every pixel of the view and
    every group or pair is taken exactly once, the tiles clipped to the
    image."""
    V = 2
    groups = H * dh // sb.WA_G
    fwd = _covered(sb.window_items(V, h, w, H * dh), h, w, groups)
    kv = _covered(sb.hp_kv_items(V, h, w, H), h, w, H // sb.HP_KV_HEADS)
    assert np.array_equal(fwd, np.arange(V * h * w * groups))
    assert np.array_equal(kv, np.arange(V * h * w * (H // sb.HP_KV_HEADS)))


def test_k6_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors K6's wrappers are its plain versions bit for bit and
    launch nothing; a view `pick_tile` cannot tile raises as lft_tpu's
    does. The dense K6 source is gone from the tree and the build, and
    K6's three launch names stay."""
    rng = np.random.RandomState(7)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 16, 8, 64).astype(np.float32))
                     for _ in range(4))
    reset_launches()
    out, m, l = sa.windowed_attention_mxu_plain(q, k, v, H, K)
    assert torch.equal(sa.spa_attn_mxu_fwd(q, k, v, H, K), out)
    assert all(torch.equal(a, b)
               for a, b in zip(sa.spa_attn_mxu_fwd(q, k, v, H, K, with_stats=True), (out, m, l)))
    ref = sa.windowed_attention_mxu_bwd_plain(q, k, v, m, l, dout, H, K)
    assert all(torch.equal(a, b)
               for a, b in zip(sa.spa_attn_mxu_bwd(q, k, v, m, l, dout, H, K), ref))
    assert sum(LAUNCHES.values()) == 0
    z = torch.zeros(1, 7, 7, 32)
    with pytest.raises(ValueError, match="no valid query tile"):
        sa.spa_attn_mxu_fwd(z, z, z, H, K)
    assert not (Path(_build.SRC_DIR) / "spa_attn_mxu.cu").exists()
    assert "spa_attn_mxu" not in _build.SOURCES
    assert SWEEPS[6:] == ("spa_attn_mxu", "spa_attn_mxu_res", "spa_attn_mxu_bwd")
