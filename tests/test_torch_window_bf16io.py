"""The bf16-IO window attention on the tensor cores (`lft_torch/csrc/
window_mma.cuh`: `spa_window_attn_mma_kernel`, launched as K2.3
`spa_window_attn_bf16io` and `spa_window_attn_res_bf16io` and as K5
`spa_attn_hp_bf16io` and `spa_attn_hp_res_bf16io`), on the CPU: its
arithmetic, its staging and its geometry.

The CUDA kernel cannot run here; its scheme can. `_window_mma` repeats it:
the k and v halos staged bf16 as they lie, zero outside the image; a
query's raw scores the f32 sums of exact bf16 products (the tensor cores'
MMA), its m the max over all 8 heads and its window's keys (out-of-image
keys score 0, their halo pixels being zero) times scale; e = exp(s scale -
m); l summed by each lane of the quad over its two key columns in key-row
order and then over the quad pairwise, (l0 + l1) + (l2 + l3), the
in-image keys only; o the f32 sum of bf16(e) v; attn = bf16(o (1 / l)). It
must match the plain version (`window_attn_plain` on bf16 tensors) within
the bounds the card holds the kernel to (tests/test_torch_cuda.py
`_bf16_close`, chip_smoke.py's BF16_GAP and BF16_ULPS: 1/10 of the plain
bf16-vs-f32 distance, 1 bf16 ulp), float64 as closely as the plain version
does, and in the K2 chain lft_tpu's bf16 block within test_torch_bf16.py's
bounds. The tensor cores' own rounding inside an MMA is not modelled: f32
sums here.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lft_torch.kernels import LAUNCHES, reset_launches
from lft_torch.kernels import spa_attn_hp as hp
from lft_torch.kernels import spa_block as sb
from lft_torch.ops.posenc import spatial_position
from lft_torch.ops.unfold import unfold3x3_linear

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16_ref as R  # noqa: E402

CSRC = Path(sb.__file__).resolve().parent.parent / "csrc"
GAP, ULPS = 0.1, 1.0          # chip_smoke.py: BF16_GAP, BF16_ULPS
H, K = 8, 5
SHAPES = [(2, 8, 8), (3, 9, 7), (1, 17, 40), (2, 32, 32), (1, 3, 2)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lanes(w: int) -> torch.Tensor:
    """[w, 25]: the lane (q) of the quad that holds key offset j of a query
    in column x: key column kc = x % 4 + dx + 2 of the patch's 8 keys, lane
    kc // 2."""
    offs = hp._window_offsets(K)
    return torch.tensor([[(x % 4 + dx + 2) // 2 for _, dx in offs] for x in range(w)])


def _window_mma(q, k, v, res: bool = False):
    """`spa_window_attn_mma_kernel` in plain PyTorch (the module docstring):
    attn, or with res (attn, m, l)."""
    V, h, w, D = q.shape
    dh = D // H
    scale = float(dh) ** -0.5
    kw = hp._gather_window(k.float(), K).reshape(V, h, w, -1, H, dh)   # the zero halo
    vw = hp._gather_window(v.float(), K).reshape(V, h, w, -1, H, dh)
    s = torch.einsum("byxhd,byxjhd->byxjh", q.float().reshape(V, h, w, H, dh), kw)
    m = s.amax((3, 4)) * scale                          # every head, every window key
    e = torch.exp(s * scale - m[:, :, :, None, None])
    img = torch.from_numpy(hp._window_valid(h, w, K))[None, :, :, :, None]
    onehot = torch.nn.functional.one_hot(_lanes(w), 4).float()        # [w, 25, 4]
    part = torch.zeros(V, h, w, H, 4)
    for j in range(K * K):                              # key rows in order, then columns
        ej = torch.where(img[:, :, :, j], e[:, :, :, j], torch.zeros(()))
        part = part + ej[..., None] * onehot[None, None, :, j, None, :]
    l = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    p = e.bfloat16().float()
    o = torch.einsum("byxjh,byxjhd->byxhd", p, vw)
    attn = (o * (1.0 / l)[..., None]).reshape(V, h, w, D).bfloat16()
    if not res:
        return attn
    return attn, m[..., None].expand(-1, -1, -1, H).contiguous(), l


def _qkv(V, h, w, C, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn(V, h, w, 2 * C, generator=g) * s).bfloat16() for s in (1.5, 1.5, 1))


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want) -> float:
    want = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("V,h,w", SHAPES)
def test_window_mma_scheme_matches_the_plain_version(C, V, h, w):
    """The emulated kernel against the plain bf16 version: attn within GAP
    of the plain bf16-vs-f32 distance and ULPS bf16 ulps, m and l within
    the card test's 1e-5 / 1e-4 (m each query's max over its heads in every
    head's slot); against float64 (the f32 attention on the same values) as
    close as the plain version, within a tenth of a bf16 ulp more."""
    q, k, v = _qkv(V, h, w, C, C + h + w)
    got = _window_mma(q, k, v, res=True)
    ref = sb.window_attn_plain(q, k, v, H, K)
    ref32 = sb.window_attn_plain(q.float(), k.float(), v.float(), H, K)[0]
    a, r = got[0].float().numpy(), ref[0].float().numpy()
    assert got[0].dtype == torch.bfloat16 and got[0].shape == q.shape
    assert _l2(a, r) <= GAP * _l2(ref32.numpy(), r), (_l2(a, r), _l2(ref32.numpy(), r))
    assert _ulps(a, r) <= ULPS
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[2], ref[2], atol=1e-5, rtol=1e-4)
    exact = hp.windowed_attention_headpacked_plain(q.double(), k.double(), v.double(), H, K)[0]
    ulp = 2.0 ** (np.floor(np.log2(float(exact.abs().max()))) - 7)
    e_got = float((got[0].double() - exact).abs().max())
    e_ref = float((ref[0].double() - exact).abs().max())
    assert e_got <= e_ref + 0.1 * ulp, (e_got, e_ref)


@pytest.fixture(scope="module")
def k2ref(tmp_path_factory):
    """lft_tpu's bf16 blocks (tests/_torch_bf16_ref.py)."""
    out = str(tmp_path_factory.mktemp("window_bf16io") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(__file__), "_torch_bf16_ref.py"),
                    out], check=True, timeout=600, env=env)
    return dict(np.load(out))


@pytest.mark.parametrize("C", R.C_BLOCKS)
def test_k2_chain_with_emulated_window_matches_lft_tpu(k2ref, monkeypatch, C):
    """K2's plain bf16 steps with the emulated window step, on
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

    def window(q, k, v, num_heads, ksize, with_stats=False, plan=None):
        calls.append(q.shape)
        return _window_mma(q, k, v, with_stats)
    monkeypatch.setattr(sb, "window_attn", window)
    reset_launches()
    got = sb.spa_trans_block_fused(x, pe_tok, p, R.SPA_PREFIX, H, K)
    assert calls and sum(LAUNCHES.values()) == 0
    want = k2ref[f"k2_{C}_bf16"]
    gap = _l2(want, k2ref[f"k2_{C}_f32"])
    dist = _l2(got.float().numpy(), want)
    assert dist <= GAP * gap, (dist, gap)
    assert _ulps(got.float().numpy(), want) <= ULPS


@pytest.mark.parametrize("h,w", [(8, 8), (9, 7), (17, 40), (32, 32), (3, 2), (1, 13)])
def test_window_mma_items_take_every_query_once(h, w):
    """The blocks (`window_mma_items`), warps' patches and lanes
    (`window_mma_lane`) take every pixel of every view once; each query's
    25 window keys lie in its patch's 8 x 8 keys, in the tile's 12 x 12
    halo, and across the quad's lanes the kernel's band masks (key row r in
    [qy + 2 hh, qy + 2 hh + 4], never outside [2 hh, 5 + 2 hh]; key column 2
    q + c within qx .. qx + 4) select each of them exactly once."""
    V = 2
    items = sb.window_mma_items(V, h, w)
    assert len(items) == V * -(-h // sb.WM_T) * -(-w // sb.WM_T)
    seen = np.zeros((V, h, w), int)
    for view, y0, x0 in items:
        for tid in range(sb.WM_NT):
            (py, px), queries, qd = sb.window_mma_lane(tid)
            for hh, (qy, qx) in enumerate(queries):
                y, x = y0 + py + qy, x0 + px + qx
                picked = {(r, 2 * qd + c) for r in range(2 * hh, 6 + 2 * hh) for c in range(2)
                          if 0 <= r - qy <= 4 and 0 <= 2 * qd + c - qx <= 4}
                window = {(qy + 2 + dy, qx + 2 + dx) for dy, dx in hp._window_offsets(K)}
                assert picked == {key for key in window if key[1] // 2 == qd}
                assert all(0 <= r < 8 and 0 <= c < 8 and 0 <= py + r < 12 and 0 <= px + c < 12
                           for r, c in window)
                if y < h and x < w and qd == 0:
                    seen[view, y, x] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("D", [32, 64, 128])
def test_window_mma_geometry_mirrors_the_source(D):
    """spa_block.py's mirror is window_mma.cuh's: the tile, the patch, the
    threads, the v halo's rounds, four blocks an SM (their halos within an
    SM's 233,472 bytes at D = 128, each block's within 232,448), the
    swizzle; ldmatrix's eight rows (eight neighbouring halo pixels from a
    patch's key row) hit eight different 16-byte bank groups in the k halo
    and in a round of the v halo at every width."""
    src = (CSRC / "window_mma.cuh").read_text()
    for line in (f"WM_T = {sb.WM_T};", f"WM_P = {sb.WM_P};", f"WM_BLOCKS = {sb.WM_BLOCKS};",
                 f"WM_VS = {sb.WM_VS};", "WM_H = WM_T + 2 * R;", "WM_K = WM_P + 2 * R;",
                 "WM_NT = 32 * (WM_T / WM_P) * (WM_T / WM_P);", "CHV = CH / WM_VS;",
                 "HALO = WM_H * WM_H * D * 2;", "BYTES = HALO + HALO / WM_VS;",
                 "return p * CH + (c ^ (p & 7));", "return p * CH + (c ^ ((p >> 1) & 3));",
                 "return p * CH + (c ^ ((p >> 2) & 1));"):
        assert line in src, line
    assert sb.WM_NT == 32 * (sb.WM_T // sb.WM_P) ** 2
    smem = sb.window_mma_smem(D)
    assert smem <= 232448 and sb.WM_BLOCKS * (sb.window_mma_smem(128) + 1024) <= 233472
    assert f"{smem:,} at D = {D}" in src or f"{smem:,} at {D}" in src
    for ch in (D // 8, D // 8 // sb.WM_VS):
        units = sorted(sb.window_mma_unit(p, c, ch) for p in range(144) for c in range(ch))
        assert units == list(range(144 * ch))           # a permutation of the halo
        for py in (0, 4):
            for r in range(8):
                for px in (0, 4):
                    p0 = (py + r) * 12 + px
                    for c in range(ch):
                        banks = {sb.window_mma_unit(p0 + i, c, ch) % 8 for i in range(8)}
                        assert len(banks) == 8, (D, ch, p0, c)


def test_window_bf16io_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the window step and K5's forward (with and without
    stats) on bf16 are their plain version, bit for bit, and launch
    nothing."""
    q, k, v = _qkv(2, 9, 7, 16, 3)
    reset_launches()
    ref = sb.window_attn_plain(q, k, v, H, K)
    assert torch.equal(sb.window_attn(q, k, v, H, K), ref[0])
    assert all(torch.equal(a, b) for a, b in
               zip(sb.window_attn(q, k, v, H, K, with_stats=True), ref))
    assert torch.equal(hp.spa_attn_hp_fwd(q, k, v, H, K), ref[0])
    assert all(torch.equal(a, b) for a, b in zip(hp.spa_attn_hp_fwd(q, k, v, H, K, True), ref))
    assert sum(LAUNCHES.values()) == 0


def test_window_mma_launchers_take_every_width():
    """The C launcher dispatches D = 32, 64, 128 (DH = 4, 8, 16) to the
    kernel, and both sources that launch it route the bf16-IO forms there:
    no launch of the two-pass `window_softmax_max_heads` on bf16 is left."""
    src = (CSRC / "window_mma.cuh").read_text()
    assert re.findall(r"LFT_WM_CASE\((\d+)\)\n", src) == ["32", "64", "128"]
    for name in ("spa_block.cu", "spa_attn_hp.cu"):
        text = (CSRC / name).read_text()
        assert "launch_window_mma<" in text
        assert "spa_window_attn_bf16io_kernel" not in text
    assert "spa_window_attn_bf16io_kernel" not in (CSRC / "window_attn.cuh").read_text()
