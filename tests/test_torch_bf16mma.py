"""The bf16 tensor-core designs of `wgrad_bf16io` (`lft_torch/csrc/
wgrad.cu`: `wgrad_bf16io_kernel`, `wgrad_bf16io_taps_kernel`) and of K2.5's
`_bf16` instance `spa_ffn_out_bf16` (`lft_torch/csrc/ffn_bf16.cuh`; K11.5's
`spa_ffn_out_pm_bf16` is the same kernel with its output pixel-major), on
the CPU: their arithmetic, their split and weight layout, their geometry.

The CUDA kernels cannot run here; their schemes can.

* `_wgrad_bf16io` repeats `wgrad_bf16io`'s arithmetic: x bf16 and dy
  rounded to bf16 (to nearest even, a bf16 dy as it is), exact products
  summed in f32 per k16 MMA (16 tokens), the four MMAs of a 64-token stage
  in their own accumulator (a chain), the chains added in f32 over each of
  `bf16io_cut`'s S slices, the Z slices of a cluster added in rank order,
  and the S / Z cluster sums in the column-sum kernel's order. Against
  float64 its error must stay within the bound the card holds the kernel
  to (tests/test_torch_cuda.py: 1e-5 of the largest output).
* `_ffn_out_bf16` repeats `spa_ffn_out_bf16`'s from the wrapper's own weight
  preparation (`rowgemm.ffn_out_bf16_stream`, unpacked from its core-matrix
  layout): xn2 rounded to bf16, each product's k16 steps summed in f32 in
  K order, the hidden layer in 64-column chunks (relu, then bf16), y = hid
  W2 + x2 in f32 rounded to bf16 for Wlin, out f32. It must match the plain
  version under the plan `none` (`ffn_out_plain`) and, in the K2 chain, the
  same bounds against lft_tpu's `mm_half` block as the plain chain
  (tests/test_torch_fwdforms.py: L2-relative 1e-3 and 1/10 of lft_tpu's
  mixed-vs-f32 distance).

The tensor cores' own rounding inside an MMA is not modelled: f32 sums
here. The kernels are held to the same bounds on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_reduce import _colsum_order

from lft_torch.compare_wgrad import STEP_PRODUCTS, STEP_TOKENS
from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels import wgrad as wg
from lft_torch.kernels.common import KERNEL_C, bf16_round, mm_site_plan

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fwdforms_ref as R  # noqa: E402

CSRC = Path(wg.__file__).resolve().parent.parent / "csrc"
CARD_REL = 1e-5              # tests/test_torch_cuda.py: test_wgrad_bf16io_kernel
MIXED_REL, MIXED_GAP = 1e-3, 0.1


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plan_none():
    return mm_site_plan(True, frozenset())


# ------------------------------------------------------------ wgrad_bf16io ---

def _shifted_rows(x, image, tap):
    """x [T, K] shifted by tap (ky - 1, kx - 1) inside each h x w image,
    zero outside (the rows `wgrad_bf16io_taps_kernel` reads a tap)."""
    h, w = image
    xi = torch.nn.functional.pad(x.reshape(-1, h, w, x.shape[1]), (0, 0, 1, 1, 1, 1))
    return xi[:, tap // 3:tap // 3 + h, tap % 3:tap % 3 + w].reshape(x.shape)


def _wgrad_bf16io(x, dy, image=None):
    """xᵀ dy in `wgrad_bf16io`'s arithmetic (the module docstring): [K, N],
    or [9, K, N] with image=."""
    T, K = x.shape
    N = dy.shape[1]
    taps = 1 if image is None else 9
    S, Z = wg.bf16io_cut(T, K, N, taps)
    xb = x.float()
    yb = bf16_round(dy.float())
    xs = [xb] if image is None else [_shifted_rows(xb, image, t) for t in range(9)]
    parts = []
    for s in range(S):
        t0, t1 = T * s // S, T * (s + 1) // S
        acc = torch.zeros(taps, K, N)
        for b in range(t0, t1, wg.BIO_BT):        # a stage: one chain
            chain = torch.zeros(taps, K, N)
            for t in range(b, min(b + wg.BIO_BT, t1), 16):
                e = min(t + 16, t1)
                chain = chain + torch.stack([xt[t:e].t() @ yb[t:e] for xt in xs])
            acc = acc + chain
        parts.append(acc)
    groups = []
    for c in range(S // Z):                       # a cluster's slices in rank order
        p = parts[c * Z]
        for r in range(1, Z):
            p = p + parts[c * Z + r]
        groups.append(p)
    out = groups[0] if len(groups) == 1 else \
        _colsum_order(torch.stack(groups).reshape(len(groups), -1)).reshape(taps, K, N)
    return out[0] if image is None else out


def _bf16_values(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("T,K,N,image,dy_f32", [
    (4096, 64, 64, None, False), (4100, 128, 256, None, False), (4100, 64, 64, None, True),
    (3001, 16, 32, None, False), (2100, 64, 128, (7, 10), False), (2048, 32, 64, (32, 32), False),
    (1230, 16, 32, (5, 6), True)])
def test_wgrad_bf16io_scheme_is_within_the_card_bound(T, K, N, image, dy_f32):
    """The emulated kernel against float64 within CARD_REL of the largest
    output, at T no slab or tile divides, K4's and dwu's widths, 9 taps and
    an f32 dy; its slices, clusters and column sum cover every token once
    (the plain version's f32 result equals it within the same bound)."""
    rng = np.random.RandomState(T + K + N)
    x = _bf16_values(rng, T, K)
    dy = torch.from_numpy(rng.randn(T, N).astype(np.float32))
    dy = dy if dy_f32 else dy.bfloat16()
    got = _wgrad_bf16io(x, dy, image)
    exact = wg.wgrad_plain(x.double(), bf16_round(dy.double()), image)
    scale = float(exact.abs().max())
    assert float((got.double() - exact).abs().max()) <= CARD_REL * scale
    plain = wg.wgrad_plain(x, dy, image)
    assert plain.dtype == torch.float32
    assert float((plain.double() - got.double()).abs().max()) <= CARD_REL * scale


# the fused step's 9 products at T = 102,400 (STEP_PRODUCTS, then K3's dwo
# on an f32 dx2): (S, Z) of `bf16io_cut`
PINNED = {"K3 dw1 = xn2ᵀ dpre": (66, 2), "K3 dwu (9 taps)": (32, 2),
          "K3 dwq, dwk, dwv, dwo": (132, 2), "K3 dw2": (66, 2), "K3 dwlin": (132, 2),
          "K4 dwq, dwk, dwv, dwo": (264, 2), "K4 dw1": (132, 2), "K4 dw2": (132, 2)}


@pytest.mark.parametrize("what,K,N,image", [(w, K, N, im) for w, K, N, im, _ in STEP_PRODUCTS]
                         + [("K3 dwo, dy = dx2 in f32", 128, 128, None)])
def test_wgrad_bf16io_split_at_the_step_shapes(what, K, N, image):
    """`bf16io_cut` at the step's shapes: pinned, S a multiple of Z, no more
    slices than `splits` (at least ROWS tokens each), the cut repeatable;
    the partials that reach device memory are S / Z, half the f32 kernel's
    S, or fewer."""
    taps = 1 if image is None else 9
    S, Z = wg.bf16io_cut(STEP_TOKENS, K, N, taps)
    assert (S, Z) == PINNED.get(what, (132, 2))
    assert (S, Z) == wg.bf16io_cut(STEP_TOKENS, K, N, taps)
    assert S % Z == 0 and 1 <= Z <= wg.BIO_CLUSTER and S <= wg.splits(STEP_TOKENS, K, N, taps)
    assert STEP_TOKENS // S >= wg.ROWS
    assert 2 * (S // Z) <= wg.splits(STEP_TOKENS, K, N, taps) + 1


def test_wgrad_bf16io_cut_small_shapes():
    """Fewer tokens than a cluster's worth: one slice, no cluster, no column
    sum; a handful: S = Z."""
    assert wg.bf16io_cut(7, 8, 8) == (1, 1)
    S, Z = wg.bf16io_cut(600, 8, 8)
    assert S == Z and S >= 1


def test_wgrad_bf16io_geometry_mirrors_the_source():
    """wgrad.py's constants are wgrad.cu's, and `bf16io_smem` is the shared
    memory of BioTile / BioTaps for every tile and dY type, within a block's
    232,448 bytes."""
    src = (CSRC / "wgrad.cu").read_text()
    assert f"constexpr int BIO_BT = {wg.BIO_BT};" in src
    assert f"constexpr int BIO_CL = {wg.BIO_CL_MAX};" in src and wg.BIO_CLUSTER <= wg.BIO_CL_MAX
    m = re.search(r"constexpr int BIO_STAGES = (\d+);", src)
    assert m and int(m.group(1)) == wg.BIO_STAGES
    for line in ("LDX = BM + 8;", "LDY = is_bf16<YT> ? BN + 8 : BN + 4;",
                 "STAGE = XS + BIO_BT * LDY * static_cast<int>(sizeof(YT));",
                 "LDR = BN + 8;", "HR = BIO_BT + 2;", "TLDX = WM + 8;",
                 "LDY = is_bf16<YT> ? WN + 8 : WN + 4;", "STAGE = XS + YS + BIO_BT * 4;",
                 "RED = 9 * WM * LDR * 4;", "SMEM = (RING > RED ? RING : RED) + WM * 2;"):
        assert line in src, line
    for N in (32, 64, 128, 256):
        for taps in (1, 9):
            for f32 in (False, True):
                assert 0 < wg.bf16io_smem(N, taps, f32) <= 232448
    assert wg.bf16io_smem(256, 1, False) == 4 * 64 * (136 * 2 + 136 * 2)
    assert wg.bf16io_smem(256, 1, True) == 4 * 64 * (136 * 2 + 132 * 4)
    assert wg.bf16io_smem(64, 9, False) == 4 * (3 * 66 * 72 * 2 + 64 * 40 * 2 + 256) + 128


def test_wgrad_bf16io_takes_the_plain_version_on_cpu():
    """On CPU tensors `wgrad` with a bf16 x is its plain version, bit for
    bit, and launches nothing."""
    rng = np.random.RandomState(3)
    x = _bf16_values(rng, 300, 16)
    dy = torch.from_numpy(rng.randn(300, 24).astype(np.float32))
    reset_launches()
    for d in (dy, dy.bfloat16()):
        assert torch.equal(wg.wgrad(x, d), wg.wgrad_plain(x, d))
    assert torch.equal(wg.wgrad(x, dy.bfloat16(), (10, 30)),
                       wg.wgrad_plain(x, dy.bfloat16(), (10, 30)))
    assert sum(LAUNCHES.values()) == 0


# ------------------------------------------------------ spa_ffn_out_bf16 ---

def _unpack_bf16(flat, K, N):
    """`rowgemm.bf16_piece`'s layout [K/16, 2, N/8, 8, 8] -> [K, N]."""
    return flat.reshape(K // 16, 2, N // 8, 8, 8).permute(0, 1, 4, 2, 3).reshape(K, N)


def _ffn_weights(wts):
    """W1, W2, Wlin (bf16 values, f32) from the launch's weight preparation."""
    D, C = wts["wlin"].shape
    f = rg.ffn_out_bf16_stream(wts)
    assert f.dtype == torch.bfloat16 and f.numel() == 2 * rg.ffn_out_bf16_floats(C)
    o2, ol = 2 * D * D, 4 * D * D
    return (_unpack_bf16(f[:o2], D, 2 * D).float(), _unpack_bf16(f[o2:ol], 2 * D, D).float(),
            _unpack_bf16(f[ol:], D, C).float())


def _product(a, b):
    """a @ b summed in f32 over k16 steps in K order, a rounded to bf16."""
    a = bf16_round(a)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16] @ b[k:k + 16]
    return acc


def _ffn_out_bf16(xn2, x2, wts):
    """K2.5 `_bf16` in its kernel's arithmetic (the module docstring):
    [..., D] rows -> [..., C]."""
    w1, w2, wlin = _ffn_weights(wts)
    D = w1.shape[0]
    lead = x2.shape[:-1]
    a, r = xn2.reshape(-1, D), x2.reshape(-1, D)
    y = torch.zeros(a.shape[0], D)
    for c in range(0, 2 * D, 64):                 # the hidden chunks
        hid = torch.relu(_product(a, w1[:, c:c + 64]))
        y = y + _product(hid, w2[c:c + 64])
    return _product(y + r, wlin).reshape(*lead, -1)


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ffn_inputs(C, seed, shape=(3, 9, 7)):
    rng = np.random.RandomState(seed)
    D = 2 * C
    w = lambda *s: torch.from_numpy((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32))
    wts = dict(w1=w(D, 2 * D), w2=w(2 * D, D), wlin=w(D, C))
    xn2 = torch.from_numpy(rng.randn(*shape, D).astype(np.float32))
    x2 = torch.from_numpy(rng.randn(*shape, D).astype(np.float32))
    return xn2, x2, wts


@pytest.mark.parametrize("C", KERNEL_C)
def test_ffn_out_bf16_scheme_matches_the_plain_version(C):
    """The emulated kernel against `ffn_out_plain` under the plan `none`
    (the same rounding points, f32 sums in another order): L2-relative
    MIXED_REL and MIXED_GAP of the plain mixed-vs-f32 distance, a relu
    input near 0 aside; against float64 of the same rounded operands as
    close as the plain version is."""
    xn2, x2, wts = _ffn_inputs(C, C)
    none = _plan_none()
    got = _ffn_out_bf16(xn2, x2, wts)
    ref = sb.ffn_out_plain(xn2, x2, wts, none)
    gap = _l2(sb.ffn_out_plain(xn2, x2, wts), ref)
    d = _l2(got, ref)
    assert d <= MIXED_REL and d <= MIXED_GAP * gap, (d, gap)
    w64 = {k: v.double() for k, v in wts.items()}
    exact = sb.ffn_out_plain(xn2.double(), x2.double(), w64, none)
    assert _l2(got, exact) <= 2 * _l2(ref, exact) + 1e-6


@pytest.fixture(scope="module")
def k11m(tmp_path_factory):
    """lft_tpu's K11 under LFT_MM_HP_SITES=none (tests/_torch_fwdforms_ref.py,
    its `k11` part only)."""
    out = str(tmp_path_factory.mktemp("bf16mma") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__),
                                                 "_torch_fwdforms_ref.py"), out, "k11"],
                   check=True, timeout=600, env=env)
    return dict(np.load(out))


@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k2_chain_with_emulated_ffn_out_bf16_matches_lft_tpu(k11m, C):
    """K2's plain steps 1-4 under the plan `none` and the emulated step 5,
    on test_torch_fwdforms.py's K11 inputs made view-major, against
    lft_tpu's `mm_half` block: L2-relative MIXED_REL and MIXED_GAP of
    lft_tpu's mixed-vs-f32 distance (test_torch_fwdforms.py's bound)."""
    d = R.k11_inputs(C)
    p = {k: torch.from_numpy(v) for k, v in d["params_f32"].items()}
    wts = sb.spa_weights(p, R.SPA_PREFIX)
    x = torch.from_numpy(d["x_f32"])
    A2 = x.shape[3]
    xv = sb._to_view_major(x)
    pe_tok = torch.from_numpy(k11m[f"k11m_{C}_petok"])
    none = _plan_none()
    tok, xn = sb.tokenize_ln_plain(xv, pe_tok, wts, none)
    q, k, v = sb.qkv_plain(xn, tok, wts, none)
    attn = sb.window_attn_plain(q, k, v, 8, 5, none)[0]
    x2, xn2 = sb.outproj_ln_plain(attn, tok, wts, none)
    got = sb._to_pixel_major(_ffn_out_bf16(xn2, x2, wts), A2)
    want = k11m[f"k11m_{C}_mixed"]
    d_, gap = _l2(got.numpy(), want), _l2(k11m[f"k11m_{C}_f32"], want)
    assert d_ <= MIXED_REL and d_ <= MIXED_GAP * gap, (d_, gap)


@pytest.mark.parametrize("C", KERNEL_C)
def test_ffn_out_bf16_weight_layout(C):
    """`bf16_piece` holds B rounded to bf16 at (kk, kh, j, n, t) = B[16 kk +
    8 kh + t][8 j + n], as `ffn_bf16_weights_kernel` writes it (its index
    formula, repeated here); the stream is W1, W2, Wlin whole, its size the
    scratch's."""
    _, _, wts = _ffn_inputs(C, 7 + C, (1, 1, 1))
    D = 2 * C
    f = rg.ffn_out_bf16_stream(wts)
    assert f.numel() == 4 * D * D + D * C == 2 * rg.ffn_out_bf16_floats(C)
    off = 0
    for name, (K, N) in (("w1", (D, 2 * D)), ("w2", (2 * D, D)), ("wlin", (D, C))):
        B = wts[name]
        piece = f[off:off + K * N].reshape(K // 16, 2, N // 8, 8, 8)
        kk, kh, j, n, t = np.meshgrid(*(np.arange(s) for s in piece.shape), indexing="ij")
        assert torch.equal(piece, B.bfloat16()[16 * kk + 8 * kh + t, 8 * j + n])
        k_, n_ = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
        at = ((k_ // 16 * 2 + k_ % 16 // 8) * (N // 8) + n_ // 8) * 64 + n_ % 8 * 8 + k_ % 8
        assert torch.equal(f[off + at.reshape(-1)], B.bfloat16().reshape(-1))
        off += K * N
    assert off == f.numel()


def test_ffn_out_bf16_geometry_mirrors_the_source():
    """rowgemm.py's sizes of K2.5's `_bf16` kernel are FfnBf16's
    (ffn_bf16.cuh) and its weight kernel's index formula; every width fits
    a block's shared memory, as the source's table says."""
    src = (CSRC / "ffn_bf16.cuh").read_text()
    for line in ("HC = 64;", "OFF_W2 = 2 * D * D, OFF_LIN = 4 * D * D;",
                 "ELEMS = OFF_LIN + D * C;", "WBYTES = 2 * ELEMS;", "LDX = D + 8;",
                 "BYTES = WBYTES + RG_M * LDX * 4;",
                 "at = off + ((k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 "
                 "+ k % 8;"):
        assert line in src, line
    for C in KERNEL_C:
        D = 2 * C
        assert rg.hidden_chunk(D) == 64
        smem = rg.ffn_out_bf16_smem(C)
        assert smem == 2 * (4 * D * D + D * C) + rg.RG_M * (D + 8) * 4 <= rg.RG_SMEM_MAX
        assert f"C = {C}:" in src and f"{smem:,} bytes" in src
    assert rg.ffn_out_bf16_smem(64) == 217088


def test_ffn_out_bf16_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors under the plan `none` the wrapper is its plain
    version, bit for bit, and launches nothing."""
    xn2, x2, wts = _ffn_inputs(16, 1)
    none = _plan_none()
    reset_launches()
    assert torch.equal(sb.ffn_out(xn2, x2, wts, plan=none), sb.ffn_out_plain(xn2, x2, wts, none))
    assert torch.equal(sb.ffn_out(xn2, x2, wts, 3, plan=none),
                       sb._to_pixel_major(sb.ffn_out_plain(xn2, x2, wts, none), 3))
    assert sum(LAUNCHES.values()) == 0
