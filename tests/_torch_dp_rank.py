"""One rank of the port's data-parallel checks on the CPU, as its own process
(tests/test_torch_parallel.py starts two). No JAX here: the parent compares.

    python tests/_torch_dp_rank.py step  <port> <rank> <world> <dir>
    python tests/_torch_dp_rank.py train <port> <rank> <world> <dir>
    python tests/_torch_dp_rank.py evaluate <port> <rank> <world> <dir>

`step` joins a gloo group of `world` ranks at localhost:<port>, reads
`<dir>/inputs.npz` (params `p/<name>`, the global batch `data`, `label`, an
LR mosaic `lr`) and writes `<dir>/rank<rank>.npz`:

* `sgd_loss`, `sgd/<name>`: the loss of the second of two DP steps under
  SGD(0.1), and the params after them (as tests/_dp_check.py);
* `grad/<name>`: the averaged gradient of one DP step under the smooth
  loss of tests/test_torch_train.py;
* `adam<i>/<name>`: the params after two DP Adam steps, twice from the same
  state (i = 0, 1);
* `sr`: `make_scene_sr` of `lr` with the chunks sharded over the ranks.

`train` runs `python -m lft_torch.train`'s `main` as process <rank> of
<world> under `--coordinator localhost:<port>` on the synthetic h5 set under
`<dir>/data`, logging under `<dir>/p<rank>`. `evaluate` runs `python -m
lft_torch.test`'s `main` so on the test scenes of that set with the
checkpoint `<dir>/model.npz`, and prints the PSNR and SSIM of every set
as JSON.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import dataclasses  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lft_torch.config import Args  # noqa: E402
from lft_torch.training.optim import SGD  # noqa: E402

ARGS = dict(angRes=3, scale_factor=2, channels=8, batch_size=4, lr=2e-4, n_steps=15,
            gamma=0.5, epoch=2, patch_size_for_test=8, stride_for_test=4, eval_batch=4,
            num_workers=0)


def smooth(sr, y):
    return ((sr - y) * torch.cos(3.0 * (sr - y))).mean()


def fresh(np_params):
    return {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in np_params.items()}


def step_mode(port, rank, world, d):
    from lft_torch.inference.tiled import make_scene_sr
    from lft_torch.models.lft import forward
    from lft_torch.parallel.distributed import init_group, rank_device
    from lft_torch.parallel.mesh import get_mesh, make_dp_train_step, put_global_batch
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer

    inp = np.load(os.path.join(d, "inputs.npz"))
    np_p = {k[2:]: inp[k] for k in inp.files if k.startswith("p/")}
    data, label = inp["data"], inp["label"]
    dev = rank_device(rank, "cpu")
    init_group(rank, world, f"localhost:{port}", dev)
    mesh = get_mesh(world, device="cpu")
    args = Args(**ARGS)
    model = get_model(args)
    out = {}

    p = fresh(np_p)
    step = make_dp_train_step(model, SGD(p, 0.1), args, mesh, with_metrics=False)
    for _ in range(2):
        loss, _, _ = step(p, *put_global_batch(mesh, data, label))
    out["sgd_loss"] = loss.numpy()
    out.update({f"sgd/{k}": v.detach().numpy() for k, v in p.items()})

    p = fresh(np_p)
    make_dp_train_step(dataclasses.replace(model, loss=smooth), SGD(p, 0.1), args, mesh,
                       with_metrics=False)(p, *put_global_batch(mesh, data, label))
    out.update({f"grad/{k}": v.grad.numpy() for k, v in p.items()})

    for i in range(2):
        p = fresh(np_p)
        step = make_dp_train_step(model, make_optimizer(p, args, steps_per_epoch=10), args,
                                  mesh)
        for _ in range(2):
            step(p, *put_global_batch(mesh, data, label))
        out.update({f"adam{i}/{k}": v.detach().numpy() for k, v in p.items()})

    lr = torch.from_numpy(inp["lr"])
    h0 = lr.shape[0] // args.angRes
    sr = make_scene_sr(forward, args, h0, h0, mesh=mesh)(fresh(np_p), lr)
    out["sr"] = sr.numpy()
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def train_mode(port, rank, world, d):
    from lft_torch import train as train_cli
    root = os.path.join(d, "data")
    args = Args(**{**ARGS, "angRes": 5, "epoch": 1},
                path_for_train=os.path.join(root, "data_for_train") + os.sep,
                path_for_test=os.path.join(root, "data_for_test") + os.sep,
                data_name="SynthLF", path_log=os.path.join(d, f"p{rank}"),
                coordinator=f"localhost:{port}", num_processes=world, process_id=rank)
    _, history = train_cli.main(args, device="cpu")
    print(f"process {rank} loss {history[0]['loss']:.6f}")


def evaluate_mode(port, rank, world, d):
    from lft_torch import test as test_cli
    root = os.path.join(d, "data")
    args = Args(**ARGS, path_pre_pth=os.path.join(d, "model.npz"),
                path_for_test=os.path.join(root, "data_for_test") + os.sep,
                data_name="SynthLF", path_log=os.path.join(d, f"p{rank}"),
                coordinator=f"localhost:{port}", num_processes=world, process_id=rank)
    psnr, ssim = test_cli.main(args, device="cpu")
    print(f"process {rank} results " + json.dumps([[float(x) for x in psnr],
                                                   [float(x) for x in ssim]]))


if __name__ == "__main__":
    torch.set_num_threads(2)
    mode, port, rank, world, d = sys.argv[1:6]
    {"step": step_mode, "train": train_mode, "evaluate": evaluate_mode}[mode](int(port), int(rank), int(world), d)
