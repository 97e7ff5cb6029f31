"""K8 `ang_attn_sweep` (forward, `_res`) and `ang_attn_sweep_bwd` as
redesigned for the H100, on the CPU: the plain versions, the geometry and
the arithmetic.

On the card K8 launches K7's kernels (`csrc/ang_attn.cu`) for its forward
at A2 <= 128 and its backward at A2 <= 32, and its own beyond
(`csrc/ang_attn_sweep.cu`: tiles of one pixel's head group, keys streamed
through three cp.async stages, K7's forward arithmetic, a backward with D
from the saved output). Those kernels cannot run here.
This file holds:

* K8's plain version against K7's plain version at A2 <= 128, the function
  both kernels compute there;
* K8's plain version against lft_tpu's `ang_attention` (Pallas, interpret
  mode) and its `jax.vjp` past 128 views;
* the launch geometry's Python mirror (`ang_attn_vjp.fwd_geometry`,
  `bwd_geometry`, `fwd_tiles`, `bwd_tiles`, the item maps) to the source,
  covering every (pixel, head, query) once and staging every key row once a
  (pixel, head) in one block;
* the kernels' arithmetic emulated in float32 (fmaf as a float64 product and
  sum rounded once) against float64: at most twice the error of the f32
  plain version, and against `jax.vjp` of lft_tpu's kernel within 1e-4;
* the wrappers' CPU path.
The kernels are held to the same bounds on the card (tests/test_torch_cuda.py,
chip_smoke.py, `compare_k8`).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lft_tpu.kernels import ang_attn_vjp as j_sweep
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import ang_attn_mxu as am
from lft_torch.kernels import ang_attn_vjp as av
from lft_torch.kernels.common import KERNEL_C

CSRC = Path(av.__file__).resolve().parent.parent / "csrc"
H = 8
FWD = dict(atol=2e-5, rtol=1e-4)   # the same f32 sums in another order (test_torch_sweeps.py)
PLAIN = 2e-6                       # K8 plain vs K7 plain: max |diff| <= 2e-6 max(1, max |K7|)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2).astype(np.float32)


def _grad_close(got, ref, what="", rel=5e-4, floor=2e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + floor, (what, err, float(np.abs(ref).max()))


def _k8_stats(x, N, A2):
    """lft_tpu's [Np*A2, H] statistics, (chunk, view, pixel) order -> [N, A2, H]."""
    x = np.asarray(x)
    return x.reshape(-1, A2, j_sweep._CHUNK, H).transpose(0, 2, 1, 3).reshape(-1, A2, H)[:N]


# --------------------------------------------------- the plain versions ---

@pytest.mark.parametrize("A2", [1, 25, 81, 128])
@pytest.mark.parametrize("C", KERNEL_C)
def test_k8_plain_matches_k7_plain(C, A2):
    """At A2 <= 128 K8 launches K7's forward kernels on the card: the two
    plain versions compute the same (out, m, l) there, and the same
    gradients from the same (out, m, l). Their scores differ by an ulp (an
    elementwise product summed against a matrix product), so m too is held
    to 2e-6 max(1, max |K7|), as out and l are."""
    rng = np.random.RandomState(C + A2)
    N = 13
    q, k, v, dout = (torch.from_numpy(rng.randn(N, A2, C).astype(np.float32)) for _ in range(4))
    got = av.ang_attention_sweep_plain(q, k, v, H)
    ref = am.ang_attention_blockdiag_plain(q, k, v, H)
    for name, g, r in zip(("out", "m", "l"), got, ref):
        assert g.shape == r.shape, name
        err = float((g - r).abs().max())
        assert err <= PLAIN * max(1.0, float(r.abs().max())), (name, err)
    if A2 == 1:
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    gb = av.ang_attention_sweep_bwd_plain(q, k, v, *ref, dout, H)
    rb = am.ang_attention_blockdiag_bwd_plain(q, k, v, *ref[1:], dout, H)
    for name, g, r in zip(("dq", "dk", "dv"), gb, rb):
        _grad_close(g, r, name, rel=1e-5, floor=1e-7)


@pytest.mark.parametrize("A2,N,C", [(129, 5, 16), (169, 3, 16)])
def test_k8_plain_matches_jax_past_128_views(A2, N, C):
    """Past K7's gate: K8's plain forward (out, m, l) against lft_tpu's
    Pallas kernel in interpret mode (FWD), and the plain backward from it
    against `jax.vjp` of `ang_attention` (5e-4 max |ref| + 2e-9); N is not a
    multiple of lft_tpu's 32-pixel chunk."""
    q, k, v, dout = (_rand((N, A2, C), 40 + A2 + i) for i in range(4))
    ref, m_ref, l_ref = j_sweep._fwd(*map(jnp.asarray, (q, k, v)), H)
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    out, m, l = av.ang_attn_sweep_fwd(qt, kt, vt, H, with_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(m.numpy(), _k8_stats(m_ref, N, A2), **FWD)
    np.testing.assert_allclose(l.numpy(), _k8_stats(l_ref, N, A2), **FWD)
    _, vjp = jax.vjp(lambda *a: j_sweep.ang_attention(*a, H), *map(jnp.asarray, (q, k, v)))
    for name, g, r in zip(("dq", "dk", "dv"), av.ang_attn_sweep_bwd(qt, kt, vt, out, m, l, dt, H),
                          vjp(jnp.asarray(dout))):
        _grad_close(g.numpy(), r, name)


# -------------------------------------------------------------- geometry ---

def test_k8_python_geometry_mirrors_the_source():
    """The constants, the tile rules, the tile walks and the item maps of
    csrc/ang_attn_sweep.cu are those of the Python mirror; no atomics."""
    src = (CSRC / "ang_attn_sweep.cu").read_text()
    for line in (
            "constexpr int KS = 32;", "constexpr int NS = 3;", "constexpr int NT_TILE = 256;",
            "while (hg > 1 && hg * per_head > NT_TILE) hg /= 2;",
            "return std::max(hg, 4 / DH);",
            "const int DH = C / H, QP = (A2 + 1) / 2, HG = head_group(QP, DH);",
            "const int QBP = std::min(QP, NT_MAX / HG), NQB = (QP + QBP - 1) / QBP;",
            "const size_t floats = NS * 2 * KS * LDW + 2 * QR * LDW + (stats ? 2 * QR * HG : 0);",
            "return {HG, QBP, NQB, round32(HG * QBP), floats * 4};",
            "const int DH = C / H, HG = head_group(A2, DH);",
            "const int items = HG * A2, rounds = (items + NT_MAX - 1) / NT_MAX;",
            "const size_t floats = NS * 2 * KS * (HG * DH + 4) + static_cast<size_t>(4) * HG * A2;",
            "return {HG, rounds, round32((items + rounds - 1) / rounds), floats * 4};",
            # the forward's tile walk, stream and item map
            "row0 = static_cast<size_t>(t / (NQB * NG)) * A2;",
            "col0 = t / NQB % NG * W;", "i0 = t % NQB * QR;", "nq = min(QR, A2 - i0);",
            "const int t = blockIdx.x + f / nc * gridDim.x, c = f % nc;",
            "const int pr = tid % QBP, hh = tid / QBP;",
            "const bool active = hh < HG && 2 * pr < nq;",
            "const int ia = 2 * pr, ib = min(ia + 1, nq - 1);",
            "for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {",
            # the backward's
            "const int t = blockIdx.x + f / (2 * RC) * gridDim.x, e = f % (2 * RC), c = e % nc;",
            "const size_t row0 = static_cast<size_t>(t / NG) * A2;",
            "const int col0 = t % NG * W;",
            "const int item = r * nt + tid, i = item % A2, hh = item / A2;",
            "const int item = r * nt + tid, j = item % A2, hh = item / A2;",
            "const bool active = hh < HG;",
            # A2 <= 128 is K7's in the forward
            "if (bad_shape(N, A2, C, heads) || A2 <= 128) return static_cast<int>(cudaErrorInvalidValue);"):
        assert line in src, line
    assert "atomicAdd" not in src and "atom." not in src
    assert (av.KS, av.NS, av.NT_TILE, av.NT_MAX) == (32, 3, 256, 512)
    assert av.K7_BWD_MAX == am.HOLD_MAX == 32
    shared = (CSRC / "ang_attn.cuh").read_text()
    assert "*grid = std::min(tiles, sms * per_sm);" in shared
    assert '#include "ang_attn.cuh"' in src and '#include "ang_attn.cuh"' in \
        (CSRC / "ang_attn.cu").read_text()


@pytest.mark.parametrize("C", KERNEL_C)
def test_k8_geometry_fits_the_block(C):
    """Past 128 views, for A2 up to 2048: each kernel's tile within 512
    threads and a block's shared memory; the forward's tile takes every
    query of a pixel's head group up to 1024 views (512 at dh = 2); the
    backward's phases one round while a head group's tokens fit 512 threads.
    At the 12x12 views of the scene and step (C = 64) two heads a forward
    tile and one a backward tile, 160 threads each."""
    for A2 in list(range(129, 420)) + [511, 512, 513, 1000, 1024, 1025, 2048]:
        for stats in (False, True):
            hg, qbp, nqb, nt, smem = av.fwd_geometry(A2, C, stats)
            assert hg in (1, 2) and hg * (C // H) >= 4 and H % hg == 0
            assert smem <= av.SMEM_MAX and nt <= av.NT_MAX and nt % 32 == 0
            assert hg * qbp <= nt < hg * qbp + 32 and qbp * nqb >= (A2 + 1) // 2
            assert (nqb == 1) == (A2 <= 2 * av.NT_MAX // max(1, 4 // (C // H)))
        hg, rounds, nt, smem = av.bwd_geometry(A2, C)
        assert hg * (C // H) >= 4 and smem <= av.SMEM_MAX and nt <= av.NT_MAX and nt % 32 == 0
        assert rounds * nt >= hg * A2 and (rounds == 1) == (hg * A2 <= av.NT_MAX)
    if C == 64:
        assert av.fwd_geometry(144, 64)[:4] == (2, 72, 1, 160)
        assert av.bwd_geometry(144, 64)[:3] == (1, 1, 160)


def _cover(rows, A2):
    """How often each of A2 rows is in a list of row ranges."""
    n = np.zeros(A2, np.uint8)
    for r in rows:
        n[r.start:r.stop] += 1
    return n


@pytest.mark.parametrize("N", [1, 7, 4099])
@pytest.mark.parametrize("A2", [129, 144, 169, 400])
def test_k8_forward_covers_every_item_once(A2, N):
    """The forward's persistent blocks (grids of one block to more blocks
    than tiles) take every (pixel, head, query) once: each (pixel, head
    group, query block) is one tile in one block, and the tile's threads
    write each (head, query) of it once. Each tile stages every key row of
    its heads once, so a (pixel, head)'s keys are staged once, in one block
    (one query block up to these view counts)."""
    for C in KERNEL_C:
        hg, qbp, nqb, nt, _ = av.fwd_geometry(A2, C)
        assert nqb == 1
        for nq in {min(A2, 2 * qbp)}:
            items = av.fwd_thread_items(A2, C, nq)
            seen = sorted((hh, i) for hh, qs in items.values() for i in qs)
            assert seen == [(hh, i) for hh in range(hg) for i in range(nq)]
        for grid in (1, 132, 10000):
            staged = np.zeros((N, H, A2), np.uint8)
            owner, last, cover = {}, None, None
            for b, block in enumerate(av.fwd_tiles(N, A2, C, grid)):
                for pix, heads, queries, rows in block:
                    assert len(heads) == hg and queries == range(A2)
                    for h in heads:
                        assert owner.setdefault((pix, h), b) == b
                    if rows is not last:
                        last, cover = rows, _cover(rows, A2)
                    staged[pix, heads.start:heads.stop] += cover
            assert len(owner) == N * H and (staged == 1).all(), (C, grid)


@pytest.mark.parametrize("N", [1, 7, 4099])
@pytest.mark.parametrize("A2", [129, 144, 169, 400])
def test_k8_backward_covers_every_item_once(A2, N):
    """The backward's blocks take every (pixel, head) once, as one tile in
    one block; a tile's items cover every (head, token) once in each phase;
    each phase stages the tile's rows (k, v; then q, dout) once a round, so
    once where a head group's tokens fit 512 threads (at dh = 2 and 400
    views two rounds of 2 heads)."""
    for C in KERNEL_C:
        hg, rounds, nt, _ = av.bwd_geometry(A2, C)
        assert rounds == (2 if (C, A2) == (16, 400) else 1)
        items = av.bwd_thread_items(A2, C)
        assert sorted((hh, i) for _, _, hh, i in items) == \
            [(hh, i) for hh in range(hg) for i in range(A2)]
        assert len({(r, tid) for r, tid, _, _ in items}) == len(items)
        for grid in (1, 132, 10000):
            staged = np.zeros((2, N, H, A2), np.uint8)
            owner, last, cover = {}, None, None
            for b, block in enumerate(av.bwd_tiles(N, A2, C, grid)):
                for pix, heads, key_rows, query_rows in block:
                    for h in heads:
                        assert owner.setdefault((pix, h), b) == b
                    if key_rows is not last:
                        last, cover = key_rows, _cover(key_rows, A2)
                    staged[0, pix, heads.start:heads.stop] += cover
                    staged[1, pix, heads.start:heads.stop] += _cover(query_rows, A2) \
                        if query_rows is not key_rows else cover
            assert len(owner) == N * H and (staged == rounds).all(), (C, grid)


# ------------------------------------------------------------ arithmetic ---

def _fma(a, b, c):
    """fmaf: the f32 product is exact in float64, the sum rounded once to
    float64 and then to float32 (a double rounding that seldom differs)."""
    return (a.double() * b.double() + c.double()).float()


def _dot(a, b):
    """One fmaf chain over the last axis from 0, as `dot<DH>` runs it."""
    s = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1])
    for d in range(a.shape[-1]):
        s = _fma(a[..., d], b[..., d], s)
    return s


def _heads(t):
    N, A2, C = t.shape
    return t.reshape(N, A2, H, C // H).transpose(1, 2)          # [N, H, A2, dh]


def _merge(t):
    N, _, A2, dh = t.shape
    return t.transpose(1, 2).reshape(N, A2, H * dh)


def _fwd_emulated(q, k, v):
    """(out, m, l) as `ang_attn_sweep_res` computes them (K7's arithmetic):
    s_ij = (q_i scale) . k_j (fmaf chain); keys in chunks of 8 (a stage of
    32 holds four): the chunk's max mc (with the running m), its sums from
    0 (lc += e, oc = fmaf(e, v_j, oc), e = exp(s - mc)), then one rescale
    l = fmaf(l, r, lc), o = fmaf(o, r, oc), r = exp(m - mc); out = o (1 / l)."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    scale = float(np.float32(qh.shape[-1] ** -0.5))
    s = _dot((qh * scale)[:, :, :, None], kh[:, :, None])
    A2 = q.shape[1]
    m = torch.full(s.shape[:-1], float("-inf"))
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(qh.shape)
    for j0 in range(0, A2, am.KB):
        mc = torch.maximum(m, s[..., j0:j0 + am.KB].amax(-1))
        lc, oc = torch.zeros(l.shape), torch.zeros(o.shape)
        for j in range(j0, min(j0 + am.KB, A2)):
            e = torch.exp(s[..., j] - mc)
            lc = lc + e
            oc = _fma(e[..., None], vh[:, :, j, None], oc)
        r = torch.exp(m - mc)
        l = _fma(l, r, lc)
        o = _fma(o, r[..., None], oc)
        m = mc
    out = o * (1.0 / l)[..., None]
    return _merge(out), m.transpose(1, 2).contiguous(), l.transpose(1, 2).contiguous()


def _chunked(term, n, shape):
    """sum_j a_j b_j as the kernels add: fmaf chains over chunks of 8 from
    0, the chunks' sums added in order. term(j) -> (a_j, b_j)."""
    total = torch.zeros(shape)
    for j0 in range(0, n, am.KB):
        c = torch.zeros(shape)
        for j in range(j0, min(j0 + am.KB, n)):
            c = _fma(*term(j), c)
        total = total + c
    return total


def _bwd_emulated(q, k, v, out, m, l, dout):
    """(dq, dk, dv) as `ang_attn_sweep_bwd` computes them from (out, m, l):
    D_i = dout_i . out_i (fmaf chain), q scaled once, p = exp(s - m)
    (1 / l), dp = dout_i . v_j, ds = p (dp - D); dq = scale sum_j ds k_j
    (query phase), dk = sum_i ds q_i scale and dv = sum_i p dout_i (key
    phase), every sum in chunks of 8; both phases build the same s, p, ds."""
    qh, kh, vh, gh, oh = _heads(q), _heads(k), _heads(v), _heads(dout), _heads(out)
    scale = float(np.float32(qh.shape[-1] ** -0.5))
    qs = qh * scale
    A2 = q.shape[1]
    mt, inv = m.transpose(1, 2), 1.0 / l.transpose(1, 2)         # [N, H, A2]
    D = _dot(gh, oh)
    p = torch.exp(_dot(qs[:, :, :, None], kh[:, :, None]) - mt[..., None]) * inv[..., None]
    ds = p * (_dot(gh[:, :, :, None], vh[:, :, None]) - D[..., None])
    dq = _chunked(lambda j: (ds[..., j, None], kh[:, :, j, None]), A2, qh.shape)
    dk = _chunked(lambda i: (ds[:, :, i, :, None], qs[:, :, i, None]), A2, qh.shape)
    dv = _chunked(lambda i: (p[:, :, i, :, None], gh[:, :, i, None]), A2, qh.shape)
    return _merge(dq * scale), _merge(dk), _merge(dv)


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


@pytest.mark.parametrize("C,N,A2", [(64, 3, 144), (16, 5, 169), (32, 2, 400)])
def test_k8_emulated_keeps_f32_accuracy(C, N, A2):
    """Past 128 views: the emulated forward's (out, m, l) and the emulated
    backward (from the emulated forward's own (out, m, l)) within 1e-4
    (forward) and 5e-4 max |plain| (backward) of K8's plain version, and
    against float64 (the backward from the float64 forward's (out, m, l))
    within twice the error of the f32 plain version (its backward from its
    own forward's)."""
    rng = np.random.RandomState(C + N + A2)
    q, k, v, dout = (torch.from_numpy(rng.randn(N, A2, C).astype(np.float32)) for _ in range(4))
    got = _fwd_emulated(q, k, v)
    ref = av.ang_attention_sweep_plain(q, k, v, H)
    got_b = _bwd_emulated(q, k, v, *got, dout)
    ref_b = av.ang_attention_sweep_bwd_plain(q, k, v, *ref, dout, H)
    x64 = [t.double() for t in (q, k, v, dout)]
    e_fwd = am.ang_attention_blockdiag_plain(*x64[:3], H)
    e_bwd = av.ang_attention_sweep_bwd_plain(*x64[:3], *e_fwd, x64[3], H)
    for name, g, r, x in zip(("out", "m", "l"), got, ref, e_fwd):
        assert _err(g, r.double()) <= 1e-4 * max(1.0, float(r.abs().max())), name
        assert _err(g, x) <= 2 * _err(r, x), (name, _err(g, x), _err(r, x))
    for name, g, r, x in zip(("dq", "dk", "dv"), got_b, ref_b, e_bwd):
        assert _err(g, r.double()) <= 5e-4 * float(r.abs().max()), name
        assert _err(g, x) <= 2 * _err(r, x), (name, _err(g, x), _err(r, x))


def test_k8_emulated_matches_jax():
    """The emulated kernels (the forward with stats, then the backward from
    its (out, m, l)) against lft_tpu's `ang_attention` (Pallas, interpret
    mode) and its `jax.vjp` within 1e-4, at 129 views and a ragged N."""
    N, A2, C = 3, 129, 16
    q, k, v, dout = (_rand((N, A2, C), 60 + i) for i in range(4))
    ref, vjp = jax.vjp(lambda *a: j_sweep.ang_attention(*a, H), *map(jnp.asarray, (q, k, v)))
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    out, m, l = _fwd_emulated(qt, kt, vt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), _bwd_emulated(qt, kt, vt, out, m, l, dt),
                          vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0, err_msg=name)


# ------------------------------------------------------------ CPU path ---

@pytest.mark.parametrize("A2", [25, 144])
def test_k8_wrappers_take_the_plain_version_on_cpu(A2):
    """On CPU tensors each wrapper is its plain version, bit for bit, and
    launches nothing, on both sides of K7's gate; under grad `AngSweepFn`
    saves (q, k, v, out, m, l), and its gradients are the plain backward's
    from them."""
    rng = np.random.RandomState(A2)
    q, k, v, dout = (torch.from_numpy(rng.randn(3, A2, 32).astype(np.float32)) for _ in range(4))
    reset_launches()
    out, m, l = av.ang_attention_sweep_plain(q, k, v, H)
    assert torch.equal(av.ang_attn_sweep_fwd(q, k, v, H), out)
    assert all(torch.equal(a, b) for a, b in zip(av.ang_attn_sweep_fwd(q, k, v, H, True),
                                                 (out, m, l)))
    ref = av.ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, H)
    assert all(torch.equal(a, b)
               for a, b in zip(av.ang_attn_sweep_bwd(q, k, v, out, m, l, dout, H), ref))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = av.ang_attention(*ins, H)
    assert type(y.grad_fn).__name__ == "AngSweepFnBackward"
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 6 and all(torch.equal(a, b) for a, b in zip(saved, (q, k, v, out, m, l)))
    grads = torch.autograd.grad(y, ins, dout)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert sum(LAUNCHES.values()) == 0
