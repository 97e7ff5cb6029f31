"""lft_torch ops against the goldens of the original torch reference and
against the JAX package's functions, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lft_tpu.ops import attention as j_attention
from lft_tpu.ops import bicubic as j_bicubic
from lft_tpu.ops import metrics as j_metrics
from lft_tpu.ops import posenc as j_posenc
from lft_tpu.ops import tiling as j_tiling
from lft_tpu.ops import unfold as j_unfold
from lft_torch.ops import attention, bicubic, metrics, posenc, tiling, unfold


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- posenc ---

def test_position_encodings(goldens):
    g = goldens("ops.npz")
    spa = posenc.spatial_position(6, 9, 16)
    np.testing.assert_allclose(spa.transpose(2, 0, 1)[None, :, None], g["pe_spa"], atol=1e-6)
    ang = posenc.angular_position(25, 16)
    np.testing.assert_allclose(ang.T[None, :, :, None, None], g["pe_ang"], atol=1e-6)
    np.testing.assert_array_equal(spa, j_posenc.spatial_position(6, 9, 16))
    np.testing.assert_array_equal(posenc.angular_position(25, 64),
                                  j_posenc.angular_position(25, 64))


# --------------------------------------------------------------- bicubic ---

@pytest.mark.parametrize("n_in,n_out", [(16, 32), (35, 140), (64, 16), (21, 17)])
def test_resize_matrices_match_jax(n_in, n_out):
    np.testing.assert_array_equal(bicubic.resize_matrix_torch(n_in, n_out),
                                  j_bicubic.resize_matrix_torch(n_in, n_out))
    np.testing.assert_array_equal(bicubic.resize_matrix_matlab(n_in, n_out),
                                  j_bicubic.resize_matrix_matlab(n_in, n_out))


def test_bicubic_skip_path(goldens):
    g = goldens("ops.npz")
    x = g["interp_x"]                                   # [2, 1, 35, 35]
    for key, s in [("interp_s2", 2), ("interp_s4", 4)]:
        ours = bicubic.bicubic_upscale_views(_t(x[:, 0]), 5, s).numpy()
        np.testing.assert_allclose(ours[:, None], g[key], atol=2e-6, rtol=1e-5)
        jax_out = np.asarray(j_bicubic.bicubic_upscale_views(jnp.asarray(x[:, 0]), 5, s))
        np.testing.assert_allclose(ours, jax_out, atol=2e-6, rtol=1e-5)


def test_matlab_imresize(goldens):
    g = goldens("imresize.npz")
    im = g["im"]
    np.testing.assert_allclose(bicubic.imresize(im, scalar_scale=0.5), g["down2"], atol=1e-10)
    np.testing.assert_allclose(bicubic.imresize(im, scalar_scale=0.25), g["down4"], atol=1e-10)
    np.testing.assert_allclose(bicubic.imresize(im, scalar_scale=2.0), g["up2"], atol=1e-10)
    np.testing.assert_allclose(bicubic.imresize(im, output_shape=(13, 11)),
                               g["shape_13x11"], atol=1e-10)


# ---------------------------------------------------------------- unfold ---

def test_unfold_linear_tokenization(goldens):
    g = goldens("ops.npz")
    x = g["unfold_x"].transpose(0, 2, 3, 1)             # [N, h, w, C]
    ours = unfold.unfold3x3_linear(_t(x), _t(g["unfold_w"])).numpy()
    N, h, w, out = ours.shape
    np.testing.assert_allclose(ours.reshape(N, h * w, out).transpose(1, 0, 2),
                               g["unfold_tok"], atol=1e-5)
    jax_out = np.asarray(j_unfold.unfold3x3_linear(jnp.asarray(x), jnp.asarray(g["unfold_w"])))
    np.testing.assert_allclose(ours, jax_out, atol=1e-5)


# ------------------------------------------------------------- attention ---

@pytest.mark.parametrize("masked", [False, True])
def test_mha_parity(goldens, masked):
    g = goldens("ops.npz")
    qn = _t(g["mha_qn"].transpose(1, 0, 2))
    v = _t(g["mha_v"].transpose(1, 0, 2))
    mask = None
    if masked:
        mask = _t(np.where(np.isfinite(g["mha_mask"]), 0.0,
                           attention.NEG_INF).astype(np.float32))
    out = attention.multi_head_attention(qn, qn, v, _t(g["mha_in_proj"]),
                                         _t(g["mha_out_proj"]), 4, mask=mask)
    key = "mha_out_mask" if masked else "mha_out_nomask"
    np.testing.assert_allclose(out.numpy().transpose(1, 0, 2), g[key], atol=1e-5)


@pytest.mark.parametrize("h,w,k", [(8, 8, 5), (6, 6, 3), (16, 12, 5)])
def test_local_window_mask_matches_jax(h, w, k):
    np.testing.assert_array_equal(attention.local_window_mask(h, w, k),
                                  j_attention.local_window_mask(h, w, k))


@pytest.mark.parametrize("impl", ["tiled", "dense"])
def test_local_attention_matches_jax(impl):
    B, h, w, E, H = 2, 16, 16, 32, 8
    qn, v = _rand((B, h, w, E), 1), _rand((B, h, w, E), 2)
    ipw, opw = _rand((3 * E, E), 3), _rand((E, E), 4)
    ours = attention.local_attention(_t(qn), _t(v), _t(ipw), _t(opw), H, 5, impl).numpy()
    ref = np.asarray(j_attention.local_attention(
        jnp.asarray(qn), jnp.asarray(v), jnp.asarray(ipw), jnp.asarray(opw), H, 5,
        impl=impl))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_windowed_attention_tiled_equals_dense():
    """The tiled form of the plain window attention (K2 step 3's plain
    version) against the dense masked form."""
    q, k, v = (_t(_rand((3, 16, 8, 32), s)) for s in (5, 6, 7))
    tiled = attention.windowed_attention(q, k, v, 8, 5, "tiled")
    dense = attention.windowed_attention(q, k, v, 8, 5, "dense")
    torch.testing.assert_close(tiled, dense, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------- tiling ---

def test_tiling_goldens(goldens):
    g = goldens("tiling.npz")
    np.testing.assert_array_equal(tiling.image_extend(_t(g["ext_im"]), 3).numpy(), g["ext_out"])
    a, h0, w0, patch, stride = (int(v) for v in g["div_meta"])
    div = tiling.lf_divide(_t(g["div_mosaic"]), a, patch, stride).numpy()
    np.testing.assert_array_equal(div, g["div_out"])
    out = tiling.lf_integrate(_t(g["div_out"]), a, patch, stride, h0, w0).numpy()
    np.testing.assert_array_equal(out, g["int_out"])


@pytest.mark.parametrize("h0,w0,patch,stride", [(21, 17, 8, 4), (16, 16, 16, 8),
                                                 (13, 9, 6, 2)])
def test_tiling_matches_jax(h0, w0, patch, stride):
    a = 3
    mos = _rand((a * h0, a * w0), 11)
    assert tiling.tiling_grid(h0, w0, patch, stride) == j_tiling.tiling_grid(h0, w0, patch, stride)
    div = tiling.lf_divide(_t(mos), a, patch, stride).numpy()
    np.testing.assert_array_equal(div, np.asarray(j_tiling.lf_divide(jnp.asarray(mos), a,
                                                                     patch, stride)))
    out = tiling.lf_integrate(_t(div), a, patch, stride, h0, w0)
    np.testing.assert_array_equal(
        tiling.views_4d_to_mosaic(out).numpy(),
        np.asarray(j_tiling.views_4d_to_mosaic(j_tiling.lf_integrate(
            jnp.asarray(div), a, patch, stride, h0, w0))))


# --------------------------------------------------------------- metrics ---

def test_cal_metrics_matches_jax():
    a, h, w = 5, 20, 24
    hr = np.random.RandomState(3).rand(a * h, a * w).astype(np.float32)
    sr = (hr + 0.05 * _rand(hr.shape, 4)).astype(np.float32)
    p, s = metrics.cal_metrics(_t(hr), _t(sr), a)
    jp, js = j_metrics.cal_metrics(jnp.asarray(hr), jnp.asarray(sr), a)
    assert abs(float(p) - float(jp)) < 1e-4
    assert abs(float(s) - float(js)) < 1e-5
    # the skimage data_range rule: 2.0 when the reference goes negative
    assert abs(float(metrics.psnr(_t(hr - 0.5), _t(sr - 0.5)))
               - float(j_metrics.psnr(jnp.asarray(hr - 0.5), jnp.asarray(sr - 0.5)))) < 1e-4
