"""`python -m lft_torch.test` and `python -m lft_torch.train` against the
root test.py and train.py, run in process on the CPU on one synthetic h5
set (lft_tpu's `make_synth_data`: 4 training patches of 16x16 LR views,
2 test scenes of 32x32, scale 2) with one C=8 checkpoint written by
lft_tpu's `save_checkpoint`:

* the same log messages in the same order (timestamps and logger names
  stripped; numbers compared as numbers, PSNR/SSIM and losses within 1e-4,
  since a printed `%.2f` can round either side of a boundary; the
  `PARAMETER` line prints each package's own `Args` and is left out);
* the same experiment tree and checkpoint names, and checkpoints that
  resume across the two packages in both directions;
* `--profile_dir` traces, and a checkpoint of another width is refused.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.data.synth import make_synth_data
from lft_tpu.inference import tiled as j_tiled
from lft_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from lft_torch import test as ptest
from lft_torch import train as ptrain
from lft_torch.config import Args
from lft_torch.inference import tiled
from lft_torch.models import lft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 8
CKPT = "LFT_5x5_2x_epoch_%02d_model.npz"
PREFIX = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} - .+? - INFO - ", re.M)
NUMBER = re.compile(r"\d+\.\d+")


def _root_cli(name):
    """The repository root's test.py / train.py, loaded by path (a plain
    `import test` can find the standard library's `test` package)."""
    spec = importlib.util.spec_from_file_location(f"root_{name}_cli",
                                                  os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    paths = make_synth_data(str(root / "data"), ang_res=5, scale=2, n_train=4, n_test=2,
                            train_patch=16, test_hw=32)
    rng = np.random.RandomState(3)
    np_p = {k: (rng.rand(*s).astype(np.float32) - 0.5) * (2.0 / np.sqrt(np.prod(s[1:])))
            if len(s) > 1 else np.ones(s, np.float32)
            for k, s in lft.param_shapes(C, 2).items()}
    ckpt = str(root / "start.npz")
    j_save_checkpoint(ckpt, np_p, epoch=0)
    kw = dict(angRes=5, scale_factor=2, channels=C, batch_size=2, num_workers=0, epoch=1,
              eval_batch=4, use_pre_pth=True, path_pre_pth=ckpt, **paths)
    return root, kw


def _messages(path_log, subdir):
    """The log's messages, stripped of the timestamp and logger name."""
    with open(os.path.join(path_log, "SR_5x5_2x", "LFT", "SynthLF", subdir, "LFT.txt")) as f:
        return [m.rstrip("\n") for m in PREFIX.split(f.read())[1:]]


def _files(path_log):
    return sorted(os.path.relpath(os.path.join(d, f), path_log)
                  for d, _, fs in os.walk(path_log) for f in fs)


def _same_messages(ours, ref, skip=()):
    """Equal with every number masked; the numbers themselves within 1e-4
    (PSNR to 2 decimals and SSIM to 3 can differ by one printed unit)."""
    ours = [m for m in ours if not m.startswith(skip)]
    ref = [m for m in ref if not m.startswith(skip)]
    assert [NUMBER.sub("#", m) for m in ours] == [NUMBER.sub("#", m) for m in ref]
    for a, b in zip(ours, ref):
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            assert abs(float(x) - float(y)) <= 10.0 ** -len(x.split(".")[1]) + 1e-9, (a, b)


def test_test_cli_matches_root(env, monkeypatch):
    root, kw = env
    rows = {}

    def recording(module, key):
        inner = module.evaluate_dataset

        def run(*a, **k):
            out = inner(*a, **k)
            rows[key] = out
            return out
        monkeypatch.setattr(module, "evaluate_dataset", run)

    recording(j_tiled, "ref")
    recording(tiled, "ours")
    ref = _root_cli("test").main(JArgs(path_log=str(root / "test_ref"), **kw))
    ours = ptest.main(Args(path_log=str(root / "test_ours"), **kw), device="cpu")
    for a, b in zip(ours, ref):
        assert len(a) == len(b) == 1 and abs(a[0] - b[0]) <= 1e-4
    assert [r[0] for r in rows["ours"][2]] == [r[0] for r in rows["ref"][2]] == \
        ["scene_00", "scene_01"]
    for a, b in zip(rows["ours"][2], rows["ref"][2]):
        assert abs(a[1] - b[1]) <= 1e-4 and abs(a[2] - b[2]) <= 1e-4
    msgs = _messages(str(root / "test_ours"), "logs")
    _same_messages(msgs, _messages(str(root / "test_ref"), "logs"))
    assert msgs[0] == "\nLoad Test Dataset ..." and msgs[-1].startswith("Mean over datasets")
    assert "  SynthLF/scene_01: psnr/ssim %.2f/%.3f" % rows["ours"][2][1][1:] in msgs
    assert _files(str(root / "test_ours")) == _files(str(root / "test_ref"))


def test_train_cli_matches_root_and_resumes_across(env):
    """One epoch from the same checkpoint in each package: the same tree,
    log and checkpoint entries; then each package's epoch-1 file resumed by
    the other for epoch 2, and the two epoch-2 results close."""
    root, kw = env
    root_train = _root_cli("train")
    logs = {k: str(root / f"train_{k}") for k in ("ref", "ours", "ref2", "ours2")}
    _, j_hist = root_train.main(JArgs(path_log=logs["ref"], **kw))
    _, hist = ptrain.main(Args(path_log=logs["ours"], **kw), device="cpu")
    for a, b in zip(hist, j_hist):
        assert all(abs(a[k] - b[k]) <= 1e-4 for k in ("loss", "psnr", "ssim")), (a, b)
    assert _files(logs["ours"]) == _files(logs["ref"]) == [
        "SR_5x5_2x/LFT/SynthLF/checkpoints/" + CKPT % 1, "SR_5x5_2x/LFT/SynthLF/logs/LFT.txt"]
    msgs = _messages(logs["ours"], "logs")
    ref_msgs = [m.replace(logs["ref"], logs["ours"]) for m in _messages(logs["ref"], "logs")]
    # the epoch line's "(%.1fs)" is a time; the Args line each package's own
    strip = lambda ms: [re.sub(r" \(\d+\.\ds\)$", "", m) for m in ms]  # noqa: E731
    _same_messages(strip(msgs), strip(ref_msgs), skip=("Args(",))
    assert msgs[-1] == "Saving the epoch_01 model at %s" % os.path.join(
        logs["ours"], "SR_5x5_2x/LFT/SynthLF/checkpoints", CKPT % 1)

    ck = {k: os.path.join(logs[k], "SR_5x5_2x/LFT/SynthLF/checkpoints") for k in logs}
    z_ours, z_ref = np.load(os.path.join(ck["ours"], CKPT % 1)), \
        np.load(os.path.join(ck["ref"], CKPT % 1))
    assert sorted(z_ours.files) == sorted(z_ref.files)
    assert any(f.startswith("__opt__/") for f in z_ours.files)
    # each package resumes the other's epoch-1 file, Adam state and all
    root_train.main(JArgs(path_log=logs["ref2"], **dict(
        kw, epoch=2, path_pre_pth=os.path.join(ck["ours"], CKPT % 1))))
    ptrain.main(Args(path_log=logs["ours2"], **dict(
        kw, epoch=2, path_pre_pth=os.path.join(ck["ref"], CKPT % 1))), device="cpu")
    a, b = np.load(os.path.join(ck["ref2"], CKPT % 2)), np.load(os.path.join(ck["ours2"], CKPT % 2))
    assert sorted(os.listdir(ck["ref2"])) == sorted(os.listdir(ck["ours2"])) == [CKPT % 2]
    assert sorted(a.files) == sorted(b.files) and int(a["__epoch__"]) == int(b["__epoch__"]) == 2
    for f in a.files:
        if a[f].ndim == 0:           # the epoch and the Adam and schedule step counts
            assert int(a[f]) == int(b[f]), f
        else:
            # the packages' f32 gradients differ in their last bits (2.4e-7 at most on this set)
            np.testing.assert_allclose(a[f], b[f], rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("cli", ["test", "train"])
def test_profile_dir_writes_a_trace(env, cli):
    root, kw = env
    prof = root / f"trace_{cli}"
    args = Args(path_log=str(root / f"log_{cli}"), profile_dir=str(prof), **kw)
    (ptest if cli == "test" else ptrain).main(args, device="cpu")
    with open(prof / f"{cli}.pt.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("case", ["wider flags", "missing entry"])
def test_test_cli_refuses_a_checkpoint_of_another_width(env, case):
    root, kw = env
    if case == "wider flags":
        args, match = Args(path_log=str(root / "log_w"), **dict(kw, channels=16)), \
            r"shapes:\n    \S+: got \(8"
    else:
        z = dict(np.load(kw["path_pre_pth"]))
        z.pop("altblock.0.ang_trans.norm.bias")
        path = str(root / "missing.npz")
        np.savez(path, **z)
        args, match = Args(path_log=str(root / "log_m"), **dict(kw, path_pre_pth=path)), \
            r"missing: \[.altblock.0.ang_trans.norm.bias.\]"
    with pytest.raises(ValueError, match=match):
        ptest.main(args, device="cpu")


def test_clis_take_cuda_unless_told(env):
    if torch.cuda.is_available():
        pytest.skip("this test checks the behaviour without a CUDA card")
    root, kw = env
    for cli in (ptest, ptrain):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(Args(path_log=str(root / "log_cuda"), **kw))
