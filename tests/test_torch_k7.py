"""K7 `ang_attn` (forward, `_res`) and `ang_attn_bwd` as redesigned for the
H100 (`lft_torch/csrc/ang_attn.cu`), on the CPU: geometry and arithmetic.

The CUDA kernels cannot run here. Their launch geometry is mirrored in
Python (`kernels/ang_attn_mxu.py`: `fwd_geometry`, `bwd_geometry`,
`tile_pixels`); this file holds that mirror to the source, and checks for
every A2 of the gate and every kernel width that a tile fits a block's
shared memory and that the persistent blocks take every pixel once.
`_fwd_emulated` and `_bwd_emulated` repeat the kernels' arithmetic in plain
float32 PyTorch (fmaf as a float64 product and sum rounded once): the
forward's scores as one fmaf chain over d from q scaled first, its softmax
in chunks of 8 keys (the chunk's sums from 0, then one rescale of the
running l and o); the backward's query phase (p = exp(s - m) * (1 / l),
dp, D, dq) and key phase (dk, dv gathered over the queries) on the same
rebuilt scores, every sum over keys or queries in chunks of 8. Against float64
their errors are at most twice those of the f32 plain version, and they
match lft_tpu's `ang_attention_blockdiag` (interpret mode, forward and
`jax.vjp`) within 1e-4. The kernels are held to the same bounds on the card
(tests/test_torch_cuda.py, chip_smoke.py, `compare_k7`).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lft_tpu.kernels import ang_attn_mxu as j_mxu
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import ang_attn_mxu as am
from lft_torch.kernels.common import KERNEL_C

CSRC = Path(am.__file__).resolve().parent.parent / "csrc"
H = 8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- geometry ---

def test_k7_python_geometry_mirrors_the_source():
    """The constants, the tile rules and the persistent tile walk of
    csrc/ang_attn.cu (with the helpers it shares with K8 in
    csrc/ang_attn.cuh) are those of the Python mirror."""
    src = (CSRC / "ang_attn.cu").read_text() + (CSRC / "ang_attn.cuh").read_text()
    for line in (
            "constexpr int KB = 8;", "constexpr int NT_MAX = 512;",
            "constexpr int SMEM_TWO = 115712;", "constexpr int SMEM_MAX = 232448;",
            "constexpr int HOLD_MAX = 32;",
            "inline int fwd_row_floats(int C, bool stats) { return 6 * (C + 4) + (stats ? 2 * H : 0); }",
            "inline int bwd_row_floats(int C, int nbuf) { return nbuf * (4 * (C + 4) + 2 * H) + 4 * H + C + 4; }",
            "const int P = std::max(1, std::min(SMEM_TWO / (fwd_row_floats(C, true) * 4) / A2,",
            "NT_MAX / (H * QP)));",
            "return {P, round32(P * H * QP), 2, static_cast<size_t>(P) * A2 * fwd_row_floats(C, stats) * 4};",
            "const int P = std::max(1, std::min(SMEM_TWO / (bwd_row_floats(C, 2) * 4) / A2,",
            "NT_MAX / (H * A2)));",
            "const int nbuf = static_cast<size_t>(P) * A2 * bwd_row_floats(C, 2) * 4 <= SMEM_MAX ? 2 : 1;",
            "const int items = P * H * A2, rounds = (items + NT_MAX - 1) / NT_MAX;",
            "return {P, round32((items + rounds - 1) / rounds), nbuf,",
            # the persistent walk and the item maps
            "for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {",
            "const int rows = min(P, N - tile * P) * A2;",
            "const int pr = tid % QP, hh = tid / QP % H, p = tid / (QP * H);",
            "const int i0 = 2 * pr, i1 = min(i0 + 1, A2 - 1);",
            "const int i = t % A2, hh = t / A2 % H, p = t / (A2 * H);",
            "const int j = t % A2, hh = t / A2 % H, p = t / (A2 * H);",
            "*grid = std::min(tiles, sms * per_sm);",
            "if (A2 <= HOLD_MAX) kernel = ang_attn_bwd_kernel<DHV, true, IO>;"):
        assert line in src, line
    assert (am.KB, am.NT_MAX, am.SMEM_TWO, am.SMEM_MAX, am.HOLD_MAX) == (8, 512, 115712, 232448,
                                                                          32)
    assert "atomicAdd" not in src and "atom." not in src


@pytest.mark.parametrize("C", KERNEL_C)
def test_k7_geometry_for_every_view_count(C):
    """For every A2 of the gate: a tile of P >= 1 whole pixels within a
    block's shared memory and 512 threads; the forward's items (pixel, head,
    query pair) one round, the backward's (pixel, head, token) at most two;
    past 64 views one pixel a tile. At A2 = 25 two blocks of each kernel
    fit on an SM."""
    for A2 in range(1, am.BLK + 1):
        for stats in (False, True):
            P, nt, smem = am.fwd_geometry(A2, C, stats)
            assert P >= 1 and smem <= am.SMEM_MAX and nt <= am.NT_MAX and nt % 32 == 0
            assert P * H * ((A2 + 1) // 2) <= nt < P * H * ((A2 + 1) // 2) + 32
            assert P == am.fwd_geometry(A2, C, True)[0]   # both forms tile alike
            assert smem == P * A2 * (6 * (C + 4) + (2 * H if stats else 0)) * 4
        Pb, ntb, nbuf, smem_b = am.bwd_geometry(A2, C)
        assert Pb >= 1 and smem_b <= am.SMEM_MAX and ntb <= am.NT_MAX and ntb % 32 == 0
        assert nbuf in (1, 2) and -(-Pb * H * A2 // ntb) <= 2
        if A2 > 64:
            assert P == Pb == 1
        if nbuf == 1:   # one stage only where two do not fit
            assert Pb * A2 * (2 * (4 * (C + 4) + 2 * H) + 4 * H + C + 4) * 4 > am.SMEM_MAX
    assert am.fwd_geometry(25, C)[2] <= am.SMEM_TWO and am.bwd_geometry(25, C)[3] <= am.SMEM_TWO
    if C == 64:   # the serving and training shape
        assert am.fwd_geometry(25, 64) == (2, 224, 84800)
        assert am.bwd_geometry(25, 64) == (1, 224, 2, 67600)
        assert am.bwd_geometry(81, 64) == (1, 352, 2, 219024)
        assert am.bwd_geometry(86, 64)[2] == 1


@pytest.mark.parametrize("N", [1, 7, 4099])
def test_k7_tiles_take_every_pixel_once(N):
    """The persistent blocks' tiles (blockIdx.x, blockIdx.x + gridDim.x,
    ...) hold every pixel of a ragged N exactly once, for each kernel's
    tile size and grids from one block to more blocks than tiles."""
    for A2 in (1, 4, 25, 33, 81, 128):
        for C in KERNEL_C:
            for P in {am.fwd_geometry(A2, C)[0], am.bwd_geometry(A2, C)[0]}:
                for grid in (1, 3, 132, 264, 10000):
                    seen = [n for block in am.tile_pixels(N, P, grid) for t in block for n in t]
                    assert sorted(seen) == list(range(N)), (A2, C, P, grid)
                    assert all(0 < len(t) <= P for block in am.tile_pixels(N, P, grid)
                               for t in block)


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


def _scores(qs, kh):
    return _dot(qs[:, :, :, None], kh[:, :, None])               # [N, H, i, j]


def _fwd_emulated(q, k, v):
    """(out, m, l) as `ang_attn_res` computes them: s_ij = (q_i scale) . k_j
    (fmaf chain), keys in chunks of 8: the chunk's max mc (with the running
    m), its sums from 0 (lc += e, oc = fmaf(e, v_j, oc), e = exp(s - mc)),
    then one rescale l = fmaf(l, r, lc), o = fmaf(o, r, oc), r = exp(m -
    mc); out = o (1 / l)."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    scale = float(np.float32(qh.shape[-1] ** -0.5))
    s = _scores(qh * scale, kh)
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


def _bwd_emulated(q, k, v, m, l, dout):
    """(dq, dk, dv) as `ang_attn_bwd` computes them from (m, l): q scaled
    once; p = exp(s - m) (1 / l), dp = dout_i . v_j (fmaf chains), D = sum_j
    p dp, ds = p (dp - D), dq = scale sum_j ds k_j (query phase), dk =
    sum_i ds q_i scale and dv = sum_i p dout_i (key phase), every sum in
    chunks of 8. Both phases rebuild the same s, p, ds."""
    qh, kh, vh, gh = _heads(q), _heads(k), _heads(v), _heads(dout)
    scale = float(np.float32(qh.shape[-1] ** -0.5))
    qs = qh * scale
    A2 = q.shape[1]
    mt, inv = m.transpose(1, 2), 1.0 / l.transpose(1, 2)         # [N, H, A2]
    p = torch.exp(_scores(qs, kh) - mt[..., None]) * inv[..., None]
    dp = _dot(gh[:, :, :, None], vh[:, :, None])
    dsum = _chunked(lambda j: (p[..., j], dp[..., j]), A2, mt.shape)
    ds = p * (dp - dsum[..., None])
    dq = _chunked(lambda j: (ds[..., j, None], kh[:, :, j, None]), A2, qh.shape)
    dk = _chunked(lambda i: (ds[:, :, i, :, None], qs[:, :, i, None]), A2, qh.shape)
    dv = _chunked(lambda i: (p[:, :, i, :, None], gh[:, :, i, None]), A2, qh.shape)
    return _merge(dq * scale), _merge(dk), _merge(dv)


def _err(t, exact) -> float:
    return float((t.double() - exact).abs().max())


@pytest.mark.parametrize("C,N,A2", [(16, 61, 25), (32, 37, 33), (64, 19, 25), (16, 13, 81),
                                    (64, 40, 81), (32, 40, 128)])
def test_k7_emulated_keeps_f32_accuracy(C, N, A2):
    """The emulated forward's (out, m, l) and the emulated backward (from
    the emulated forward's own (m, l)): within 1e-4 (forward) and 5e-4 max
    |plain| (backward) of the plain version, and against float64 (the
    backward from the float64 forward's (m, l)) within twice the error of
    the f32 plain version (its backward from its own forward's)."""
    rng = np.random.RandomState(C + N + A2)
    q, k, v, dout = (torch.from_numpy(rng.randn(N, A2, C).astype(np.float32)) for _ in range(4))
    got = _fwd_emulated(q, k, v)
    ref = am.ang_attention_blockdiag_plain(q, k, v, H)
    got_b = _bwd_emulated(q, k, v, *got[1:], dout)
    ref_b = am.ang_attention_blockdiag_bwd_plain(q, k, v, *ref[1:], dout, H)
    x64 = [t.double() for t in (q, k, v, dout)]
    e_fwd = am.ang_attention_blockdiag_plain(*x64[:3], H)
    e_bwd = am.ang_attention_blockdiag_bwd_plain(*x64[:3], *e_fwd[1:], x64[3], H)
    for name, g, r, x in zip(("out", "m", "l"), got, ref, e_fwd):
        assert _err(g, r.double()) <= 1e-4 * max(1.0, float(r.abs().max())), name
        assert _err(g, x) <= 2 * _err(r, x), (name, _err(g, x), _err(r, x))
    for name, g, r, x in zip(("dq", "dk", "dv"), got_b, ref_b, e_bwd):
        assert _err(g, r.double()) <= 5e-4 * float(r.abs().max()), name
        assert _err(g, x) <= 2 * _err(r, x), (name, _err(g, x), _err(r, x))


@pytest.fixture
def small_ang_steps(monkeypatch):
    """Two pixel groups a grid step keep lft_tpu's interpret-mode trace short."""
    monkeypatch.setattr(j_mxu, "GPS", 2)


@pytest.mark.parametrize("A2,N", [(4, 37), (25, 7), (33, 5), (81, 3)])
@pytest.mark.parametrize("C", [16, 32])
def test_k7_emulated_matches_jax(small_ang_steps, C, A2, N):
    """The emulated kernels (the forward with stats, then the backward from
    its (m, l)) against lft_tpu's `ang_attention_blockdiag` (Pallas,
    interpret mode) and its `jax.vjp` within 1e-4, ragged N."""
    rng = np.random.RandomState(C + A2)
    q, k, v, dout = (((rng.rand(N, A2, C) - 0.5) * 2).astype(np.float32) for _ in range(4))
    ref, vjp = jax.vjp(lambda *a: j_mxu.ang_attention_blockdiag(*a, H),
                       *map(jnp.asarray, (q, k, v)))
    ref_b = vjp(jnp.asarray(dout))
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    out, m, l = _fwd_emulated(qt, kt, vt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), _bwd_emulated(qt, kt, vt, m, l, dt), ref_b):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0, err_msg=name)


def test_k7_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors each wrapper is its plain version, bit for bit, and
    launches nothing; under grad `AngAttnFn` saves (q, k, v, m, l) and
    nothing more, and its gradients are the plain backward's."""
    rng = np.random.RandomState(7)
    q, k, v, dout = (torch.from_numpy(rng.randn(5, 25, 32).astype(np.float32)) for _ in range(4))
    reset_launches()
    out, m, l = am.ang_attention_blockdiag_plain(q, k, v, H)
    assert torch.equal(am.ang_attn_fwd(q, k, v, H), out)
    assert all(torch.equal(a, b) for a, b in zip(am.ang_attn_fwd(q, k, v, H, True), (out, m, l)))
    ref = am.ang_attention_blockdiag_bwd_plain(q, k, v, m, l, dout, H)
    assert all(torch.equal(a, b) for a, b in zip(am.ang_attn_bwd(q, k, v, m, l, dout, H), ref))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = am.ang_attention_blockdiag(*ins, H)
    assert type(y.grad_fn).__name__ == "AngAttnFnBackward"
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5 and all(torch.equal(a, b) for a, b in zip(saved, (q, k, v, m, l)))
    grads = torch.autograd.grad(y, ins, dout)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert sum(LAUNCHES.values()) == 0
