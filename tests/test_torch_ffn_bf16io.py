"""K2.5's and K11.5's bf16-IO instances on the `_bf16` kernel with bf16 rows
(`lft_torch/csrc/ffn_bf16.cuh`: `spa_ffn_out_bf16_kernel<C, PM, bf16>`,
launched as `spa_ffn_out_bf16io` and `spa_ffn_out_pm_bf16io`), on the
CPU: their arithmetic, their weight layout, their rows and their geometry.

The CUDA kernel cannot run here; its scheme can. `_ffn_out_bf16io` repeats
it from the wrapper's own weight preparation (`rowgemm.ffn_out_bf16_stream`,
unpacked from its core-matrix layout): xn2 bf16 as it lies, each product's
k16 steps summed in f32 in K order, the hidden layer in chunks of 64
columns (relu, then bf16), y = bf16(bf16(hid W2) + x2), out = bf16(y Wlin).
It must match the plain version (`ffn_out_plain` on bf16 tensors) within
the bounds the card holds the kernel to (chip_smoke.py's BF16_GAP and
BF16_ULPS), float64 as closely, and, in the K2 chain, lft_tpu's bf16 block
(`tests/_torch_bf16_ref.py k2`) within test_torch_bf16.py's bounds. K11.5
writes each output row at `pm_row` (spa.cuh), so its output is K2.5's
pixel-major copy. The tensor cores' own rounding inside an MMA is not
modelled: f32 sums here.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import rowgemm as rg
from lft_torch.kernels import spa_block as sb
from lft_torch.kernels.common import bf16_round
from lft_torch.ops.posenc import spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16_ref as R  # noqa: E402

CSRC = Path(sb.__file__).resolve().parent.parent / "csrc"
GAP, ULPS = 0.1, 1.0          # chip_smoke.py: BF16_GAP, BF16_ULPS
SHAPES = [(3, 9, 7), (2, 17, 23), (1, 32, 32), (1, 3, 2)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unpack(flat, K, N):
    """`rowgemm.bf16_piece`'s layout [K/16, 2, N/8, 8, 8] -> [K, N]."""
    return flat.reshape(K // 16, 2, N // 8, 8, 8).permute(0, 1, 4, 2, 3).reshape(K, N)


def _product(a, b):
    """a @ b over bf16 values, summed in f32 over k16 steps in K order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16] @ b[k:k + 16]
    return acc


def _ffn_out_bf16io(xn2, x2, wts):
    """K2.5 bf16io in its kernel's arithmetic (the module docstring): bf16
    [..., D] rows -> bf16 [..., C]."""
    B = bf16_round
    D, C = wts["wlin"].shape
    f = rg.ffn_out_bf16_stream({k: v.float() for k, v in wts.items()})
    o2, ol = 2 * D * D, 4 * D * D
    w1, w2, wlin = (_unpack(f[:o2], D, 2 * D).float(), _unpack(f[o2:ol], 2 * D, D).float(),
                    _unpack(f[ol:], D, C).float())
    lead = x2.shape[:-1]
    a, r = xn2.float().reshape(-1, D), x2.float().reshape(-1, D)
    y = torch.zeros(a.shape[0], D)
    for c in range(0, 2 * D, 64):                 # the hidden chunks
        hid = B(torch.relu(_product(a, w1[:, c:c + 64])))
        for k in range(0, 64, 16):
            y = y + hid[:, k:k + 16] @ w2[c + k:c + k + 16]
    y = B(B(y) + r)
    return B(_product(y, wlin)).reshape(*lead, C).bfloat16()


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want) -> float:
    want = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


def _inputs(C, seed, shape):
    rng = np.random.RandomState(seed)
    D = 2 * C
    w = lambda *s: torch.from_numpy((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32))
    wts = {k: v.bfloat16() for k, v in dict(w1=w(D, 2 * D), w2=w(2 * D, D),
                                             wlin=w(D, C)).items()}
    xn2, x2 = (torch.from_numpy(rng.randn(*shape, D).astype(np.float32)).bfloat16()
               for _ in range(2))
    return xn2, x2, wts


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("C", [16, 32])
def test_ffn_out_bf16io_scheme_matches_the_plain_version(C, shape):
    """The emulated kernel against `ffn_out_plain` on bf16 tensors: within
    GAP of the plain bf16-vs-f32 distance and ULPS bf16 ulps; against
    float64 (the f32 step on the same bf16 values) within (1 + GAP) of the
    plain version's distance."""
    xn2, x2, wts = _inputs(C, C + shape[1], shape)
    got = _ffn_out_bf16io(xn2, x2, wts)
    ref = sb.ffn_out_plain(xn2, x2, wts)
    w32 = {k: v.float() for k, v in wts.items()}
    ref32 = sb.ffn_out_plain(xn2.float(), x2.float(), w32)
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    g, r = got.float().numpy(), ref.float().numpy()
    assert _l2(g, r) <= GAP * _l2(ref32.numpy(), r), (_l2(g, r), _l2(ref32.numpy(), r))
    assert _ulps(g, r) <= ULPS
    exact = sb.ffn_out_plain(xn2.double(), x2.double(), {k: v.double() for k, v in wts.items()})
    assert _l2(g, exact) <= (1 + GAP) * _l2(r, exact)


@pytest.fixture(scope="module")
def k2ref(tmp_path_factory):
    """lft_tpu's bf16 K2 blocks (tests/_torch_bf16_ref.py k2)."""
    out = str(tmp_path_factory.mktemp("ffn_bf16io") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__), "_torch_bf16_ref.py"),
                    out, "k2"], check=True, timeout=600, env=env)
    return dict(np.load(out))


@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k2_chain_with_emulated_ffn_out_matches_lft_tpu(k2ref, monkeypatch, C):
    """K2's plain bf16 steps 1-4 with the emulated step 5, on
    test_torch_bf16.py's K2 inputs, against lft_tpu's bf16 block: within
    1/10 of lft_tpu's bf16-vs-f32 distance and 1 bf16 ulp
    (test_torch_bf16.py: BLOCK_GAP, BLOCK_ULPS)."""
    d = R.inputs(C)
    p = {k_: torch.from_numpy(np.ascontiguousarray(v_)).bfloat16() for k_, v_ in d["params"].items()}
    hh, ww = R.K2_SHAPE[1:]
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(hh, ww, C)).bfloat16()[None],
                              p[R.SPA_PREFIX + "MLP.weight"])[0].contiguous()
    x = torch.from_numpy(np.ascontiguousarray(d["k2_x"])).bfloat16()
    calls = []

    def ffn_out(xn2, x2, wts, views=None, plan=None):
        calls.append(xn2.shape)
        assert views is None and plan is None
        return _ffn_out_bf16io(xn2, x2, wts)
    monkeypatch.setattr(sb, "ffn_out", ffn_out)
    reset_launches()
    got = sb.spa_trans_block_fused(x, pe_tok, p, R.SPA_PREFIX, 8, 5)
    assert calls and sum(LAUNCHES.values()) == 0
    want = k2ref[f"k2_{C}_bf16"]
    gap = _l2(want, k2ref[f"k2_{C}_f32"])
    dist = _l2(got.float().numpy(), want)
    assert dist <= GAP * gap, (dist, gap)
    assert _ulps(got.float().numpy(), want) <= ULPS


def _pm_row(t, hw, A2):
    """spa.cuh's pm_row: view-major token t -> its pixel-major row."""
    view = t // hw
    return ((view // A2) * hw + t % hw) * A2 + view % A2


@pytest.mark.parametrize("Bb,h,w,A2", [(2, 3, 5, 25), (1, 9, 7, 3), (3, 4, 4, 4)])
def test_ffn_out_pm_bf16io_rows_are_the_pixel_major_copy(Bb, h, w, A2):
    """K11.5 writes view-major row t at pm_row(t) (the source's formula,
    repeated here): the pixel-major copy `_to_pixel_major` makes of K2.5's
    output, every row once; the wrapper on CPU tensors is that copy."""
    src = (CSRC / "spa.cuh").read_text()
    assert "return ((view / A2) * hw + t % hw) * A2 + view % A2;" in src
    T = Bb * A2 * h * w
    rows = _pm_row(np.arange(T), h * w, A2)
    assert sorted(rows) == list(range(T))
    C = 16
    xn2, x2, wts = _inputs(C, 5, (Bb * A2, h, w))
    view_major = _ffn_out_bf16io(xn2, x2, wts)
    pm = torch.empty(T, C, dtype=torch.bfloat16)
    pm[torch.from_numpy(rows)] = view_major.reshape(T, C)
    assert torch.equal(pm.reshape(Bb, h, w, A2, C), sb._to_pixel_major(view_major, A2))
    reset_launches()
    assert torch.equal(sb.ffn_out(xn2, x2, wts, A2),
                       sb._to_pixel_major(sb.ffn_out_plain(xn2, x2, wts), A2))
    assert sum(LAUNCHES.values()) == 0


def _ldmatrix_x4(rows, lane_addr):
    """ldmatrix.x4 (non-transposed) on a [R, cols] b16 array: lane 8 i + r
    gives (row, col) of row r of matrix i; thread (g, q) receives elements
    (g, 2 q) and (g, 2 q + 1) of each matrix, as [32, 4, 2]."""
    out = np.zeros((32, 4, 2), rows.dtype)
    addr = [lane_addr(l) for l in range(32)]
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for i in range(4):
            r, c = addr[8 * i + g]
            out[lane, i] = rows[r, c + 2 * q:c + 2 * q + 2]
    return out


@pytest.mark.parametrize("C", [16, 32, 64])
def test_ffn_out_bf16io_fragments_and_banks(C):
    """The rows' ldmatrix (the source's addressing, repeated here) gives
    each lane the m16n8k16 A fragment of its k16 step (a0 (g, 2q), a1 (g +
    8, 2q), a2 (g, 2q + 8), a3 (g + 8, 2q + 8)); each 8-row matrix's rows
    at the stride of D + 8 bf16 values lie in 8 different 16-byte bank
    groups."""
    src = (CSRC / "ffn_bf16.cuh").read_text()
    assert "ldmatrix_x4(xa[s], xw + (lane & 15) * LDX + 16 * s + 8 * (lane >> 4));" in src
    D = 2 * C
    rows = np.arange(16 * D).reshape(16, D)
    for s in range(D // 16):
        got = _ldmatrix_x4(rows, lambda l: (l & 15, 16 * s + 8 * (l >> 4)))
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            want = [(g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8), (g + 8, 2 * q + 8)]
            for i, (r, c) in enumerate(want):
                assert list(got[lane, i]) == [rows[r, 16 * s + c], rows[r, 16 * s + c + 1]]
    stride = (D + 8) * 2
    for r0 in (0, 8):
        assert len({(r0 + r) * stride // 16 % 8 for r in range(8)}) == 8


def test_ffn_out_bf16io_geometry_mirrors_the_source():
    """rowgemm.py's size of the bf16-IO block is FfnBf16's BYTES16, the
    source's table says it, every width fits; spa_block.cu's bf16-IO
    entries launch the `_bf16` kernel with bf16 rows and its own step 5
    kernel is f32 only."""
    src = (CSRC / "ffn_bf16.cuh").read_text()
    assert "BYTES16 = WBYTES + RG_M * LDX * 2;" in src
    for C in (16, 32, 64):
        smem = rg.ffn_out_bf16io_smem(C)
        assert smem == rg.ffn_out_bf16_smem(C) - rg.RG_M * (2 * C + 8) * 2 <= rg.RG_SMEM_MAX
        line = src[src.index("Shared memory (`BYTES16`)"):].split(f"C = {C}:")[1].split("\n")[0]
        assert f"{smem:,} bytes" in line, (C, line)
    assert rg.ffn_out_bf16io_smem(64) == 182272
    spa = (CSRC / "spa_block.cu").read_text()
    for name, pm in (("lft_spa_ffn_out_bf16io", "false"), ("lft_spa_ffn_out_pm_bf16io", "true")):
        body = spa[spa.index(f'extern "C" int {name}('):].split("\n}\n")[0]
        assert f"launch_ffn_bf16<CC, {pm}, bf16>" in body, name
    assert "template <int C, bool PM>\n__global__ void __launch_bounds__(RG_NT, 1)\n" \
           "    spa_ffn_out_kernel(const float*" in spa


def test_ffn_out_bf16io_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the bf16-IO wrapper is its plain version, bit for bit,
    and launches nothing."""
    xn2, x2, wts = _inputs(16, 1, (3, 9, 7))
    reset_launches()
    assert torch.equal(sb.ffn_out(xn2, x2, wts), sb.ffn_out_plain(xn2, x2, wts))
    assert sum(LAUNCHES.values()) == 0
