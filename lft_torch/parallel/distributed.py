"""Processes and process groups of a data-parallel run (counterpart of
lft_tpu/parallel/distributed.py).

lft_tpu runs one process per host and extends its `('dp',)` mesh across
hosts with `jax.distributed`. In PyTorch's idiom every rank is one process
on one device: rank r of a host runs on `cuda:<r mod the card count>`
(or on the CPU when the caller passes `device="cpu"`), and the ranks join
one `torch.distributed` process group, `nccl` on CUDA and `gloo` on the
CPU. Two ways in:

* `--coordinator host:port --num_processes N --process_id I`: the user
  starts the N processes (on one host or several); `maybe_initialize`
  joins this one to the group at `tcp://host:port`;
* `--num_devices N` without a coordinator: `spawn_ranks` starts N local
  ranks itself, on a free localhost port.

Data contract (lft_tpu/parallel/distributed.py:12-17): the seeded input
pipeline is deterministic (each item's augmentation rng derives from
`(seed, epoch, index)`), so every rank materializes the SAME global batch
order and feeds only its own `1/world` slice (`local_slice`): no rank
sends data to another.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from lft_torch.config import check_parallel_flags
from lft_torch.device import resolve_device


def rank_device(rank: int, device=None) -> torch.device:
    """The device of rank `rank`: `device` where it names the CPU or a card
    by index, else `cuda:<rank mod the card count>`; made current and
    resolved (`lft_torch.device.resolve_device`, which raises without
    a card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_group(rank: int, world: int, address: str, device: torch.device,
               backend=None) -> None:
    """Join the default process group at `tcp://<address>`: `backend`, or
    nccl on a card and gloo on the CPU."""
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=f"tcp://{address}", world_size=world, rank=rank)


def maybe_initialize(args, device=None) -> bool:
    """Join this process to the run's process group iff `--coordinator` is
    set: rank `--process_id` of `--num_processes`, on `rank_device`. Call
    it before anything touches the device."""
    if not getattr(args, "coordinator", ""):
        return False
    check_parallel_flags(args)
    dev = rank_device(args.process_id, device)
    init_group(args.process_id, args.num_processes, args.coordinator, dev)
    return True


def local_slice(args, data: np.ndarray, label: np.ndarray):
    """This process's rows of a (deterministically shared) global batch."""
    return share_rows(data, label, args.process_id, getattr(args, "num_processes", 1) or 1)


def share_rows(data, label, rank: int, n: int):
    """Rows of share `rank` of `n` equal shares of a global batch."""
    if n <= 1:
        return data, label
    if data.shape[0] % n:
        raise ValueError(
            f"global batch {data.shape[0]} must divide by num_processes {n}")
    per = data.shape[0] // n
    return data[rank * per:(rank + 1) * per], label[rank * per:(rank + 1) * per]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, n: int, fn_args: tuple = (), device=None, timeout=None):
    """Run `fn(mesh, *fn_args)` on `n` local ranks, one spawned process each
    (rank r on `rank_device(r, device)`), joined by a process group on a
    free localhost port; returns rank 0's return value. A `device` that
    names one card by index puts every rank on it, and then the group is
    gloo (NCCL refuses two ranks on one card). `fn` and `fn_args`
    must pickle (`fn` a module-level function). The ranks inherit the
    environment (the `LFT_*` knobs) and count their own kernel launches. A
    rank that raises ends the run: the others are stopped and its error is
    raised here. With `timeout` (seconds), ranks still running after it
    are stopped and `TimeoutError` is raised."""
    import torch.multiprocessing as mp
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} CUDA cards, one each; "
                         f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    backend = "gloo" if dev.type == "cuda" and dev.index is not None and n > 1 else None
    with tempfile.TemporaryDirectory(prefix="lft_ranks_") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        ctx = mp.start_processes(_rank_main, nprocs=n, join=False, start_method="spawn",
                                 args=(n, _free_port(), device, backend, fn, fn_args, out))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=None if deadline is None else 1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        return torch.load(out, weights_only=False)


def _rank_main(rank: int, n: int, port: int, device, backend, fn, fn_args, out: str):
    from lft_torch.kernels import reset_launches
    from lft_torch.parallel.mesh import get_mesh
    dev = rank_device(rank, device)
    init_group(rank, n, f"localhost:{port}", dev, backend)
    try:
        reset_launches()
        result = fn(get_mesh(device=dev), *fn_args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()
