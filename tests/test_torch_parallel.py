"""The port's data parallelism (lft_torch/parallel/) on the CPU: two gloo
ranks, each its own process (tests/_torch_dp_rank.py), against the port's
single process and against lft_tpu.

* A DP step over 2 ranks equals the single-process step on the same global
  batch under SGD (|dloss| and max |dparam| <= 1e-6, tests/_dp_check.py's
  bounds), its averaged gradient is the mean of the two shares' gradients
  bit for bit, and it equals `jax.grad` of lft_tpu's loss
  on the global batch (5e-4 max |ref| + 2e-9, the unfused bound of
  tests/test_torch_perop.py). Adam steps leave both ranks' params bitwise
  equal, and a repeated run repeats bit for bit.
* `local_slice` is lft_tpu's.
* Sharded `make_scene_sr` over 2 ranks equals the unsharded pipeline
  within 1e-6, on a grid with an odd remainder chunk.
* The train CLI under `--coordinator` (2 processes) writes the
  single-process epoch checkpoint within 1e-6, from process 0 only
  (tests/test_pipeline.py:232-268's contract); `--num_devices 2` spawns and
  trains; the test CLI shards its sweep over 2 spawned ranks and over 2
  processes under `--coordinator`; a `--num_devices` other than
  `--num_processes` raises.
Sizes are tiny (angRes 3 or 5, C = 8, batch 4).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lft_tpu.config import Args as JArgs
from lft_tpu.models import lft as j_lft
from lft_tpu.parallel import distributed as j_dist
from lft_torch.config import Args, parse_args
from lft_torch.data.synth import lr_hr_pair, make_synth_data, synth_lf_scene
from lft_torch.inference.tiled import make_scene_sr
from lft_torch.models import lft
from lft_torch.ops.tiling import tiling_grid
from lft_torch.parallel import distributed, mesh
from lft_torch.registry import get_model
from lft_torch.training.optim import SGD
from lft_torch.training.trainer import make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
RANK = os.path.join(HERE, "_torch_dp_rank.py")
sys.path.insert(0, HERE)
import _torch_dp_rank as dp  # noqa: E402

TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(mode: str, d: str, world: int = 2):
    """Run `world` ranks of tests/_torch_dp_rank.py; their outputs."""
    port = _port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, RANK, mode, str(port), str(r), str(world), d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return outs


def _np_params(seed, channels=8, scale=2):
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(lft.param_shapes(channels, scale).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Inputs, and the two ranks' outputs of tests/_torch_dp_rank.py step."""
    d = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.RandomState(1)
    np_p = _np_params(0)
    data = rng.rand(4, 1, 24, 24).astype(np.float32)
    label = rng.rand(4, 1, 48, 48).astype(np.float32)
    lr, _ = lr_hr_pair(synth_lf_scene(3, 20, 20, seed=2), 2)   # a 3x3 patch grid
    np.savez(os.path.join(d, "inputs.npz"), data=data, label=label, lr=lr,
             **{f"p/{k}": v for k, v in np_p.items()})
    _ranks("step", d)
    ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(2)]
    return dict(params=np_p, data=data, label=label, lr=lr, ranks=ranks)


def test_dp_step_matches_single_process(two_ranks):
    """Two SGD steps over 2 ranks against the port's single-process
    `make_train_step` on the same global batch."""
    args = Args(**dp.ARGS)
    p = dp.fresh(two_ranks["params"])
    step = make_train_step(get_model(args), SGD(p, 0.1), args, with_metrics=False)
    x, y = torch.from_numpy(two_ranks["data"]), torch.from_numpy(two_ranks["label"])
    for _ in range(2):
        loss, _, _ = step(p, x, y)
    for r in two_ranks["ranks"]:
        assert abs(float(r["sgd_loss"]) - float(loss)) <= 1e-6
        for k, v in p.items():
            np.testing.assert_allclose(r[f"sgd/{k}"], v.detach().numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)


def test_dp_grad_is_the_mean_of_the_shares_grads(two_ranks):
    """The all-reduce adds nothing of its own: the DP step's averaged
    gradient is, bit for bit, the two ranks' shares' gradients taken in one
    process, summed and halved."""
    args = Args(**dp.ARGS)
    model = dataclasses.replace(get_model(args), loss=dp.smooth)
    halves = []
    for r in range(2):
        p = dp.fresh(two_ranks["params"])
        make_train_step(model, SGD(p, 0.1), args, with_metrics=False)(
            p, torch.from_numpy(two_ranks["data"][2 * r:2 * r + 2]),
            torch.from_numpy(two_ranks["label"][2 * r:2 * r + 2]))
        halves.append({k: v.grad for k, v in p.items()})
    for r in two_ranks["ranks"]:
        for k in two_ranks["params"]:
            assert np.array_equal(r[f"grad/{k}"], ((halves[0][k] + halves[1][k]) / 2).numpy()), k


def test_dp_grad_matches_jax_grad(two_ranks):
    """The DP step's averaged gradient against jax.grad of lft_tpu's
    single-device loss on the global batch (the smooth loss: the L1 loss's
    sign flips at residuals within f32 noise of 0 would set the result)."""
    x, y = two_ranks["data"], two_ranks["label"]
    jargs = JArgs(angRes=3, scale_factor=2, channels=8, model_name="LFT")

    def jloss(p):
        sr = j_lft.forward(p, jnp.asarray(x), jargs, remat=False, fused=False)
        return jnp.mean((sr - y) * jnp.cos(3.0 * (sr - y)))

    ref = jax.grad(jloss)({k: jnp.asarray(v) for k, v in two_ranks["params"].items()})
    for r in two_ranks["ranks"]:
        for k in two_ranks["params"]:
            got, want = r[f"grad/{k}"], np.asarray(ref[k])
            err = float(np.abs(got - want).max())
            assert err <= 5e-4 * float(np.abs(want).max()) + 2e-9, (k, err)


def test_dp_adam_ranks_bitwise_equal_and_repeatable(two_ranks):
    r0, r1 = two_ranks["ranks"]
    for k in two_ranks["params"]:
        assert np.array_equal(r0[f"adam0/{k}"], r1[f"adam0/{k}"]), k
        assert np.array_equal(r0[f"adam0/{k}"], r0[f"adam1/{k}"]), k
    moved = [k for k in two_ranks["params"]
             if not np.array_equal(r0[f"adam0/{k}"], two_ranks["params"][k])]
    assert len(moved) > len(two_ranks["params"]) // 2


def test_sharded_scene_sr_matches_unsharded(two_ranks):
    args = Args(**dp.ARGS)
    lr = two_ranks["lr"]
    h0 = lr.shape[0] // args.angRes
    g = tiling_grid(h0, h0, args.patch_size_for_test, args.stride_for_test)
    n = g["numU"] * g["numV"]
    assert n % args.eval_batch % 2 == 1, n   # an odd remainder chunk, padded by one
    ref = make_scene_sr(lft.forward, args, h0, h0)(dp.fresh(two_ranks["params"]),
                                                   torch.from_numpy(lr)).numpy()
    for r in two_ranks["ranks"]:
        assert r["sr"].shape == ref.shape
        assert float(np.abs(r["sr"] - ref).max()) <= 1e-6


@pytest.mark.parametrize("n,ok", [(4, True), (2, True), (3, False)])
def test_local_slice_matches_lft_tpu(n, ok):
    data = np.arange(4 * 3, dtype=np.float32).reshape(4, 1, 3)
    label = -data
    for pid in range(n):
        kw = dict(num_processes=n, process_id=pid)
        if ok:
            got = distributed.local_slice(Args(**kw), data, label)
            want = j_dist.local_slice(JArgs(**kw), data, label)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)
        else:
            with pytest.raises(ValueError, match="must divide by num_processes 3") as e:
                distributed.local_slice(Args(**kw), data, label)
            with pytest.raises(ValueError) as ej:
                j_dist.local_slice(JArgs(**kw), data, label)
            assert str(e.value) == str(ej.value)


def test_coordinator_training_matches_single_process(tmp_path):
    """The train CLI over 2 processes under --coordinator writes the single
    process's epoch checkpoint, and only process 0 writes one."""
    from lft_torch import train as train_cli
    d = str(tmp_path)
    make_synth_data(os.path.join(d, "data"), ang_res=5, scale=2, n_train=4, n_test=1,
                    train_patch=16, test_hw=32)
    outs = _ranks("train", d)
    root = os.path.join(d, "data")
    args = Args(**{**dp.ARGS, "angRes": 5, "epoch": 1},
                path_for_train=os.path.join(root, "data_for_train") + os.sep,
                path_for_test=os.path.join(root, "data_for_test") + os.sep,
                data_name="SynthLF", path_log=os.path.join(d, "single"))
    _, history = train_cli.main(args, device="cpu")
    ck = "SR_5x5_2x/LFT/SynthLF/checkpoints/LFT_5x5_2x_epoch_01_model.npz"
    assert not os.path.exists(os.path.join(d, "p1", ck)), "only process 0 writes checkpoints"
    a = np.load(os.path.join(d, "single", ck))
    b = np.load(os.path.join(d, "p0", ck))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(a[k], b[k]), k
    assert np.isfinite(history[0]["loss"]) and "process 0 loss" in outs[0]
    with open(os.path.join(d, "p0", "SR_5x5_2x/LFT/SynthLF/logs/LFT.txt")) as f:
        assert "the train step runs the unfused branch" in f.read()
    with open(os.path.join(d, "p1", "SR_5x5_2x/LFT/SynthLF/logs/LFT.txt")) as f:
        assert f.read() == ""


def test_num_devices_spawns_ranks_and_trains(tmp_path, monkeypatch):
    """`--num_devices 2` on the CPU: two spawned ranks train one epoch and
    rank 0's (params, history) come back; the same loss as one process."""
    from lft_torch import train as train_cli
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    paths = make_synth_data(str(tmp_path / "data"), ang_res=3, scale=2, n_train=4, n_test=1,
                            train_patch=8, test_hw=16)
    base = Args(**{**dp.ARGS, "epoch": 1}, **paths)
    p2, h2 = train_cli.main(dataclasses.replace(base, num_devices=2,
                                                path_log=str(tmp_path / "dp")), device="cpu")
    p1, h1 = train_cli.main(dataclasses.replace(base, path_log=str(tmp_path / "one")),
                            device="cpu")
    assert abs(h2[0]["loss"] - h1[0]["loss"]) <= 1e-6
    assert sorted(p2) == sorted(p1)
    ck = "SR_3x3_2x/LFT/SynthLF/checkpoints/LFT_3x3_2x_epoch_01_model.npz"
    assert os.path.exists(tmp_path / "dp" / ck)


def test_test_cli_num_devices_shards_the_sweep(tmp_path, monkeypatch):
    """`python -m lft_torch.test --num_devices 2` on the CPU: two spawned
    ranks split every chunk; the results are one process's, and only rank
    0 writes the log."""
    from lft_torch import test as test_cli
    from lft_torch.utils.checkpoint import save_checkpoint
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    paths = make_synth_data(str(tmp_path / "data"), ang_res=3, scale=2, n_train=1, n_test=2,
                            train_patch=8, test_hw=20)
    ck = str(tmp_path / "model.npz")
    save_checkpoint(ck, lft.params_from_numpy(_np_params(3), device="cpu"), 1)
    base = Args(**dp.ARGS, path_pre_pth=ck, **paths)
    one = test_cli.main(dataclasses.replace(base, path_log=str(tmp_path / "one")), device="cpu")
    two = test_cli.main(dataclasses.replace(base, num_devices=2, path_log=str(tmp_path / "two")),
                        device="cpu")
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-5)
    log = tmp_path / "two" / "SR_3x3_2x" / "LFT" / "SynthLF" / "logs" / "LFT.txt"
    lines = log.read_text().splitlines()
    assert sum("Sharded tiled inference over 2 ranks" in x for x in lines) == 1
    assert sum("Test on SynthLF" in x for x in lines) == 1


def test_test_cli_coordinator_shards_the_sweep(tmp_path):
    """The test CLI over 2 processes under --coordinator: one process's
    results on every process, and only process 0 writes the log."""
    from lft_torch import test as test_cli
    from lft_torch.utils.checkpoint import save_checkpoint
    d = str(tmp_path)
    paths = make_synth_data(os.path.join(d, "data"), ang_res=3, scale=2, n_train=1, n_test=2,
                            train_patch=8, test_hw=20)
    ck = os.path.join(d, "model.npz")
    save_checkpoint(ck, lft.params_from_numpy(_np_params(3), device="cpu"), 1)
    outs = _ranks("evaluate", d)
    one = test_cli.main(Args(**dp.ARGS, path_pre_pth=ck, path_log=os.path.join(d, "one"),
                             **paths), device="cpu")
    for r, out in enumerate(outs):
        line = next(x for x in out.splitlines() if x.startswith(f"process {r} results "))
        got = json.loads(line[len(f"process {r} results "):])
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-5)
    log = "SR_3x3_2x/LFT/SynthLF/logs/LFT.txt"
    with open(os.path.join(d, "p0", log)) as f:
        assert "Sharded tiled inference over 2 ranks" in f.read()
    with open(os.path.join(d, "p1", log)) as f:
        assert f.read() == ""


def test_parallel_flags_are_checked(monkeypatch):
    a = parse_args(["--num_devices", "4", "--batch_size", "8"])
    assert (a.num_devices, a.coordinator, a.num_processes, a.process_id) == (4, "", 1, 0)
    a = parse_args(["--coordinator", "h:1", "--num_processes", "2", "--process_id", "1"])
    assert (a.num_devices, a.coordinator, a.num_processes, a.process_id) == (None, "h:1", 2, 1)
    parse_args(["--coordinator", "h:1", "--num_processes", "2", "--num_devices", "2"])
    with pytest.raises(ValueError, match="--num_devices 3 .*--num_processes 2"):
        parse_args(["--coordinator", "h:1", "--num_processes", "2", "--num_devices", "3"])
    from lft_torch import test as test_cli
    from lft_torch import train as train_cli
    bad = Args(coordinator="localhost:1", num_processes=2, num_devices=4)
    with pytest.raises(ValueError, match="--num_devices 4"):
        train_cli.main(bad, device="cpu")
    with pytest.raises(ValueError, match="must divide by the 3"):
        train_cli.main(Args(num_devices=3, batch_size=4), device="cpu")
    # more ranks than cards: named before anything starts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for cli in (train_cli, test_cli):
        with pytest.raises(ValueError, match=r"torch.cuda.device_count\(\) is 1"):
            cli.main(Args(num_devices=2, batch_size=4))


def test_single_process_mesh():
    m = mesh.get_mesh(device="cpu")
    assert (m.rank, m.size, m.device.type, m.group) == (0, 1, "cpu", None)
    with pytest.raises(ValueError, match="num_devices 2"):
        mesh.get_mesh(2, device="cpu")
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    d, l = mesh.put_global_batch(m, x, -x)
    assert torch.equal(d, torch.from_numpy(x)) and torch.equal(l, torch.from_numpy(-x))
