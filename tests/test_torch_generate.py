"""The port's data generator (`lft_torch.data.generate`, `ops.color`,
`data.synth`'s writers and `python -m lft_torch.generate_data`) against
lft_tpu's, on the CPU: the same color arithmetic bit for bit, `.mat` scenes
of both formats read back, and the same h5 files, name for name and array
for array, from the same input (as tests/test_generate.py holds lft_tpu's
to the Matlab scripts' semantics).
"""

import contextlib
import filecmp
import io
import os

import numpy as np
import pytest

import generate_data as j_cli
from lft_tpu.data import generate as j_gen
from lft_tpu.data import synth as j_synth
from lft_tpu.ops import color as j_color
from lft_torch import generate_data as cli
from lft_torch.data import generate as gen
from lft_torch.data import synth
from lft_torch.ops import color

h5py = pytest.importorskip("h5py")


def _tree_arrays(root):
    """{relative path: (Lr_SAI_y, Hr_SAI_y)} of every h5 file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with h5py.File(os.path.join(d, f), "r") as hf:
                out[os.path.relpath(os.path.join(d, f), root)] = (
                    np.array(hf["Lr_SAI_y"]), np.array(hf["Hr_SAI_y"]))
    return out


def _assert_same_trees(ours, ref):
    """The same h5 files under both roots, arrays and bytes equal."""
    a, b = _tree_arrays(ours), _tree_arrays(ref)
    assert sorted(a) == sorted(b) and a
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert filecmp.cmp(os.path.join(ours, k), os.path.join(ref, k), shallow=False), k


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_color_matches_jax(dtype):
    x = np.random.RandomState(0).rand(3, 7, 3).astype(dtype)
    for ours, ref in ((color.rgb2ycbcr, j_color.rgb2ycbcr), (color.ycbcr2rgb, j_color.ycbcr2rgb)):
        got, want = ours(x), ref(x)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want)
    # the reference's ycbcr2rgb is not rgb2ycbcr's inverse: the offsets come
    # after the inverse product
    assert np.abs(color.ycbcr2rgb(color.rgb2ycbcr(x)) - x).max() > 0.1


@pytest.mark.parametrize("writer", ["lft_torch", "lft_tpu"])
@pytest.mark.parametrize("fmt", ["classic", "v73"])
def test_load_mat_lf_roundtrip(tmp_path, fmt, writer):
    write = synth.write_synth_scene_mat if writer == "lft_torch" else j_synth.write_synth_scene_mat
    path = str(tmp_path / f"scene_{fmt}.mat")
    lf = write(path, ang_res=5, height=24, width=20, seed=3, fmt=fmt)
    np.testing.assert_array_equal(lf, j_synth.synth_lf_scene(5, 24, 20, seed=3))
    loaded = gen.load_mat_lf(path)
    assert loaded.shape == (5, 5, 24, 20, 3) and loaded.dtype == np.float64
    np.testing.assert_array_equal(loaded, j_gen.load_mat_lf(path))
    np.testing.assert_allclose(loaded, lf, atol=1e-12)
    with pytest.raises(ValueError, match="unknown .mat fmt"):
        write(str(tmp_path / "x.mat"), ang_res=5, height=8, width=8, fmt="v5")


@pytest.mark.parametrize("int_dtype", [np.uint8, np.uint16])
def test_load_mat_lf_scales_integers(tmp_path, int_dtype):
    top = np.iinfo(int_dtype).max
    lf = (j_synth.synth_lf_scene(5, 16, 16, seed=1) * top).astype(int_dtype)
    path = str(tmp_path / "int.mat")
    with h5py.File(path, "w") as f:
        f.create_dataset("LF", data=np.transpose(lf, (4, 3, 2, 1, 0)))
    loaded = gen.load_mat_lf(path)
    assert loaded.dtype == np.float64
    np.testing.assert_array_equal(loaded, lf.astype(np.float64) / top)
    np.testing.assert_array_equal(loaded, j_gen.load_mat_lf(path))
    with h5py.File(path, "w") as f:
        f.create_dataset("LF", data=np.zeros((3, 4, 5, 6)))
    with pytest.raises(ValueError, match="expected 5-D"):
        gen.load_mat_lf(path)


def test_downscale_matlab_matches_goldens(goldens):
    """The reference's Matlab-bicubic imresize, recorded in goldens/imresize.npz."""
    g = goldens("imresize.npz")
    np.testing.assert_allclose(gen._downscale_matlab(g["im"], 2), g["down2"], atol=1e-10)
    np.testing.assert_allclose(gen._downscale_matlab(g["im"], 4), g["down4"], atol=1e-10)
    np.testing.assert_array_equal(gen._downscale_matlab(g["im"], 2),
                                  j_gen._downscale_matlab(g["im"], 2))


def _scene_tree(tmp_path, fmt, hw=(64, 68), ang_res=7):
    """<src>/SetA/{training,test}/scene_i.mat, as the generators expect."""
    src = tmp_path / "datasets"
    for si, (split, n) in enumerate((("training", 2), ("test", 2))):
        d = src / "SetA" / split
        d.mkdir(parents=True)
        for i in range(n):
            j_synth.write_synth_scene_mat(str(d / f"scene_{i}.mat"), ang_res=ang_res,
                                          height=hw[0] + 2 * i, width=hw[1] + i,
                                          seed=1000 * si + i, fmt=fmt)
    return str(src)


@pytest.mark.parametrize("fmt", ["classic", "v73"])
def test_generators_write_jax_files(tmp_path, fmt):
    """Training patches (one per 64x64-pixel window at factor 2, stride 32)
    and whole test scenes (floored to multiples of 4), from the same .mat
    scenes: the same files, their arrays equal bit for bit, the same log."""
    src = _scene_tree(tmp_path, fmt, hw=(96, 66))
    logs = {}
    for name, g in (("ours", gen), ("ref", j_gen)):
        lines = []
        n_train = g.generate_training_data(src, str(tmp_path / name / "train"), ang_res=5,
                                           factor=2, log=lines.append)
        n_test = g.generate_test_data(src, str(tmp_path / name / "test"), ang_res=5, factor=2,
                                      log=lines.append)
        logs[name] = (n_train, n_test, lines)
    assert logs["ours"] == logs["ref"]
    assert logs["ours"][:2] == (4, 2)     # 2 x 1 windows a scene at 96 (98) x 66 (67)
    _assert_same_trees(str(tmp_path / "ours"), str(tmp_path / "ref"))
    with h5py.File(tmp_path / "ours" / "test" / "SR_5x5_2x" / "SetA" / "scene_1.h5", "r") as f:
        assert f["Hr_SAI_y"].shape == (5 * 64, 5 * 96)    # 67 x 98 floored, stored transposed
    # a named subset, and a dataset without the split, are honoured alike
    assert gen.generate_test_data(src, str(tmp_path / "none"), 5, 2, datasets=["SetB"],
                                  log=print) == 0


def test_make_synth_data_matches_jax(tmp_path):
    kw = dict(ang_res=5, scale=2, n_train=3, n_test=2, train_patch=8, test_hw=12,
              dataset_name="SynthX", seed=4)
    ours = synth.make_synth_data(str(tmp_path / "ours"), **kw)
    ref = j_synth.make_synth_data(str(tmp_path / "ref"), **kw)
    assert ours == {k: v.replace(os.sep + "ref" + os.sep, os.sep + "ours" + os.sep)
                    if isinstance(v, str) else v for k, v in ref.items()}
    _assert_same_trees(str(tmp_path / "ours"), str(tmp_path / "ref"))
    assert os.path.exists(os.path.join(ours["path_for_test"], "SR_5x5_2x", "SynthX",
                                       "scene_01.h5"))


@pytest.mark.parametrize("mode", ["synth", "both"])
def test_generate_data_cli_matches_root(tmp_path, mode):
    """`python -m lft_torch.generate_data` against the root generate_data.py:
    the same files and the same printed lines."""
    src = _scene_tree(tmp_path, "classic", hw=(64, 64), ang_res=5)
    out = {}
    for name, main in (("ours", cli.main), ("ref", j_cli.main)):
        root = tmp_path / name
        argv = ["--mode", mode, "--angRes", "5", "--scale_factor", "2"]
        argv += (["--dst", str(root), "--n_train", "2", "--n_test", "1"] if mode == "synth" else
                 ["--src", src, "--dst_train", str(root / "dtr") + os.sep,
                  "--dst_test", str(root / "dte") + os.sep])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        out[name] = buf.getvalue().replace(str(root), "<dst>")
    assert out["ours"] == out["ref"] and out["ours"]
    _assert_same_trees(str(tmp_path / "ours"), str(tmp_path / "ref"))
