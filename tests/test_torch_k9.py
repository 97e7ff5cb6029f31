"""K9 `spa_attn_offset` (forward, `_res`), `spa_attn_offset_bwd` and K10
`spa_attn_tile` on K5's window kernels (`lft_torch/csrc/spa_attn_hp.cu`,
`csrc/window_attn.cuh`), on the CPU.

On the card K9 and K10 launch K5's kernels under their own names, so they
compute K5's function: every pixel attends, per head, to the in-image keys
of its 5x5 window. The JAX kernels compute it as an online softmax over the
25 offsets (K9) and as each t x t tile against its whole key halo under a
-1e30 mask (K10). This file holds, on K9's views (none of them tileable
but 20 x 12, and views smaller than the window) and K10's (t-divisible,
at t = 8 and 16), K5's plain version against K9's and K10's plain versions
and against lft_tpu's kernels (in interpret mode, as
tests/test_torch_sweeps.py runs them; lft_tpu's K10 only where its trace is
short): out, m and l within atol 2e-5 / rtol 1e-4 (the same f32 math summed
in another order), and the three backwards from the same (m, l), K5 plain's,
within 2e-5 max |ref| per output. tests/test_torch_sweeps.py holds K9 at 48 x
48 and 8 x 101 too. It also checks that K5's launches (`window_items` for
the forward and the backward's pass q, `hp_kv_items` for pass kv) cover every
pixel and head group of those views exactly once, that the wrappers take
their plain versions on CPU tensors, that the behaviours kept from lft_tpu
hold (K10 forward-only, K9 refusing heads that do not divide E), and that
K9's and K10's own CUDA sources are gone.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lft_tpu.kernels import local_attn as j_tile
from lft_tpu.kernels import local_attn_vjp as j_offset
from lft_torch.kernels import LAUNCHES, SWEEPS, TAIL, _build, reset_launches
from lft_torch.kernels import local_attn as la
from lft_torch.kernels import local_attn_vjp as lv
from lft_torch.kernels import spa_attn_hp as hp
from lft_torch.kernels import spa_block as sb

H, K = 8, 5
FWD = dict(atol=2e-5, rtol=1e-4)
BWD_REL = 2e-5

# (h, w, E): K9's views, every head width
K9_VIEWS = [(7, 7, 32), (9, 7, 64), (20, 12, 128), (3, 2, 64), (1, 1, 128), (30, 30, 32)]
# (h, w, E, t, lft_tpu's kernel): K10's views
K10_VIEWS = [(16, 16, 32, 8, True), (8, 24, 64, 8, True), (40, 16, 128, 8, True),
             (32, 16, 64, 16, True), (64, 64, 32, 8, False)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2).astype(np.float32)


def _bwd_close(got, ref, what):
    """Each output within BWD_REL max |ref|. An output that is 0 exactly (dq
    and dk of a 1 x 1 view, where p = 1 and so ds = 0; lft_tpu's D from
    `out` leaves ~1e-7 there) is held to BWD_REL of the largest output."""
    ref = [np.asarray(r) for r in ref]
    largest = max(float(np.abs(r).max()) for r in ref)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g = np.asarray(g)
        assert g.shape == r.shape, (what, name)
        err, top = float(np.abs(g - r).max()), float(np.abs(r).max()) or largest
        assert err <= BWD_REL * top, (what, name, err, top)


@pytest.mark.parametrize("h,w,E", K9_VIEWS, ids=[f"{v[0]}x{v[1]}" for v in K9_VIEWS])
def test_k9_is_k5s_function(h, w, E):
    """K5's plain forward (out, m, l) equals K9's plain forward and
    lft_tpu's interpret-mode K9; the backwards of K5 plain, K9 plain and
    lft_tpu's K9, all from K5 plain's (out, m, l), agree."""
    B = 1 if h * w > 512 else 2
    q, k, v, dout = (_rand((B, h, w, E), 700 + i) for i in range(4))
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    want = hp.windowed_attention_headpacked_plain(qt, kt, vt, H, K)
    got9 = lv.windowed_attention_offset_plain(qt, kt, vt, H, K)
    out_j, m_j, l_j = j_offset._fwd(*map(jnp.asarray, (q, k, v)), H, K)
    got_j = (np.asarray(out_j), np.asarray(m_j).reshape(B, h, w, H),
             np.asarray(l_j).reshape(B, h, w, H))
    for name, g9, gj, r in zip(("out", "m", "l"), got9, got_j, want):
        np.testing.assert_allclose(g9.numpy(), r.numpy(), err_msg=f"K9 plain {name}", **FWD)
        np.testing.assert_allclose(gj, r.numpy(), err_msg=f"lft_tpu K9 {name}", **FWD)

    out, m, l = want
    ref = hp.windowed_attention_headpacked_bwd_plain(qt, kt, vt, m, l, dt, H, K)
    _bwd_close(lv.windowed_attention_offset_bwd_plain(qt, kt, vt, out, m, l, dt, H, K), ref,
               "K9 plain")
    res = tuple(jnp.asarray(x.numpy() if torch.is_tensor(x) else x)
                for x in (q, k, v, out, m, l))
    _bwd_close(j_offset._vjp_bwd(H, K, res, jnp.asarray(dout)), ref, "lft_tpu K9")


@pytest.mark.parametrize("h,w,E,t,jax_fwd", K10_VIEWS,
                         ids=[f"{v[0]}x{v[1]}_t{v[3]}" for v in K10_VIEWS])
def test_k10_is_k5s_function(h, w, E, t, jax_fwd):
    """K5's plain forward equals K10's plain version at tile edge t and,
    where marked, lft_tpu's interpret-mode K10 at the same t: on the card K10
    launches K5's kernel whatever t is."""
    B = 1 if h * w > 512 else 2
    q, k, v = (_rand((B, h, w, E), 800 + i) for i in range(3))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    want = hp.windowed_attention_headpacked_plain(qt, kt, vt, H, K)[0].numpy()
    got = la.windowed_attention_tile_plain(qt, kt, vt, H, K, t)
    np.testing.assert_allclose(got.numpy(), want, err_msg="K10 plain", **FWD)
    if jax_fwd:
        ref = j_tile._windowed_attention_pallas(*map(jnp.asarray, (q, k, v)), H, K, t)
        np.testing.assert_allclose(np.asarray(ref), want, err_msg="lft_tpu K10", **FWD)


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


VIEWS = [v[:2] for v in K9_VIEWS] + [v[:2] for v in K10_VIEWS]


@pytest.mark.parametrize("dh", [4, 8, 16])
@pytest.mark.parametrize("h,w", VIEWS, ids=[f"{h}x{w}" for h, w in VIEWS])
def test_k5_items_cover_k9_and_k10_views_once(h, w, dh):
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


def test_k9_and_k10_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors K9's and K10's wrappers are their plain versions bit
    for bit and launch nothing; `SpaOffsetFn` saves the output there (the
    plain backward takes D from it) and its gradients are the plain
    backward's."""
    rng = np.random.RandomState(9)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 9, 7, 64).astype(np.float32))
                     for _ in range(4))
    reset_launches()
    out, m, l = lv.windowed_attention_offset_plain(q, k, v, H, K)
    assert torch.equal(lv.spa_attn_offset_fwd(q, k, v, H, K), out)
    assert all(torch.equal(a, b)
               for a, b in zip(lv.spa_attn_offset_fwd(q, k, v, H, K, with_stats=True),
                               (out, m, l)))
    ref = lv.windowed_attention_offset_bwd_plain(q, k, v, out, m, l, dout, H, K)
    assert all(torch.equal(a, b)
               for a, b in zip(lv.spa_attn_offset_bwd(q, k, v, out, m, l, dout, H, K), ref))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = lv.windowed_attention(*ins, H, K)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 6 and torch.equal(saved[5], out)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(y, ins, dout), ref))
    a, b, c = (torch.from_numpy(rng.randn(2, 16, 32, 64).astype(np.float32)) for _ in range(3))
    for t in (8, 16):
        assert torch.equal(la.windowed_attention_tile(a, b, c, H, K, t),
                           la.windowed_attention_tile_plain(a, b, c, H, K, t))
    assert sum(LAUNCHES.values()) == 0


def test_k9_and_k10_keep_lft_tpus_behaviour():
    """K10 raises under grad and where t does not divide the view; K9 raises
    where the heads do not divide E, on any device and before K5's kernel
    check."""
    z = torch.zeros(1, 16, 16, 32)
    with pytest.raises(ValueError, match="forward-only"):
        la.windowed_attention_tile(z.clone().requires_grad_(), z, z, H, K)
    with pytest.raises(ValueError, match="12x12 tiles do not divide"):
        la.windowed_attention_tile(z, z, z, H, K, t=12)
    z36 = torch.zeros(1, 8, 8, 36)
    for call in (lambda: lv.spa_attn_offset_fwd(z36, z36, z36, H, K),
                 lambda: lv.spa_attn_offset_fwd(z36, z36, z36, H, K, with_stats=True),
                 lambda: lv.spa_attn_offset_bwd(z36, z36, z36, z36, None, None, z36, H, K)):
        with pytest.raises(ValueError, match="8 heads do not divide E = 36"):
            call()


def test_k9_and_k10_sources_are_gone():
    """K9's and K10's own CUDA sources and K10's halo loader are gone from
    the tree and the build; their launch names stay."""
    csrc = Path(_build.SRC_DIR)
    for name in ("spa_attn_offset", "spa_attn_tile"):
        assert not (csrc / f"{name}.cu").exists()
        assert name not in _build.SOURCES
    assert not any("stage_tile_halo" in p.read_text()
                   for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))
    assert SWEEPS[3:6] == ("spa_attn_offset", "spa_attn_offset_res", "spa_attn_offset_bwd")
    assert TAIL[0] == "spa_attn_tile"
    assert set(SWEEPS + TAIL) <= set(LAUNCHES)
