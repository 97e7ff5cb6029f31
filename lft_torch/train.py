"""Training CLI (counterpart of the root train.py).

    python -m lft_torch.train --model_name LFT --angRes 5 --scale_factor 2 --batch_size 8
    python -m lft_torch.train --model_name LFT --angRes 5 --scale_factor 4 --batch_size 4
    python -m lft_torch.train ... --num_devices 4
    python -m lft_torch.train ... --coordinator host:port --num_processes N --process_id I

Trains on the h5 patches under `--path_for_train` and writes a checkpoint
an epoch under `--path_log`, as train.py does; `--use_pre_pth` resumes
(an `.npz` exactly, with its Adam state). Runs on the CUDA card
(`device="cpu"` from Python for the plain PyTorch path). Reading the h5
set needs `h5py`; without it, pass `dataset=` from Python.

Data parallelism (lft_torch/parallel/), one process a device:
`--num_devices N` starts N local ranks, rank r on `cuda:r`;
`--coordinator host:port --num_processes N --process_id I` makes this
process rank I of N (the user starts every process, on one host or
several). `--batch_size` is the global batch and divides by the ranks;
each rank takes its slice of every batch, and only rank 0 logs and writes
checkpoints. The data-parallel step trains the unfused branch, as
lft_tpu's does (`--train_fused` is not read there).

`--dtype bfloat16` trains in bf16 through either branch (`--train_fused
auto` is fused under it on the card and unfused on the CPU, as lft_tpu's
auto): the fused blocks, on the card the `_bf16io` kernels of K1 res, K2
res, K4, K3 and `wgrad`; or with `--train_fused false` and in the
data-parallel step the unfused branch, on the card the per-op kernels'
`_res_bf16io` forms and `_bwd_bf16io` backwards (K5-K9); on the CPU their
plain versions. The master weights, the Adam state and the checkpoints stay
f32, so a resume is exact.
"""

from __future__ import annotations

import dataclasses
import functools


def main(args, device=None, dataset=None):
    """train.py's run. `dataset` is any object with `__len__` and
    `item(index, rng)` (and a `seed` for reproducible batches), a
    `TrainDataset(args, seed=args.seed)` by default. Returns (params,
    history of per-epoch means): rank 0's under `--num_devices N > 1`."""
    import torch.distributed as dist

    from lft_torch.parallel.distributed import maybe_initialize, spawn_ranks
    from lft_torch.parallel.mesh import get_mesh

    if maybe_initialize(args, device):   # before anything touches the device
        # the reference's (vestigial) local_rank gates the log and the
        # checkpoints (`Logger`, `fit`): rank 0 only
        args.local_rank = args.process_id
        try:
            return _run(args, dataset, get_mesh(device=device))
        finally:
            dist.destroy_process_group()
    if (args.num_devices or 1) > 1:
        _check_batch(args, args.num_devices)
        return spawn_ranks(_rank_run, args.num_devices, (args, dataset), device=device)
    return _run(args, dataset, get_mesh(device=device))


def _check_batch(args, ranks: int) -> None:
    if args.batch_size % ranks:
        raise ValueError(f"--batch_size {args.batch_size} must divide by the {ranks} "
                         f"data-parallel ranks")


def _rank_run(mesh, args, dataset):
    """One of `--num_devices` spawned ranks."""
    return _run(dataclasses.replace(args, local_rank=mesh.rank), dataset, mesh)


def _run(args, dataset, mesh):
    import torch.distributed as dist

    from lft_torch.data.datasets import TrainDataset
    from lft_torch.parallel.mesh import make_dp_step_builder, put_global_batch
    from lft_torch.training.trainer import fit
    from lft_torch.utils.logging import Logger, create_dir
    from lft_torch.utils.profiling import traced

    _check_batch(args, mesh.size)
    _, checkpoints_dir, log_dir = create_dir(args)
    logger = Logger(log_dir, args)

    logger.log_string("\nLoad Training Dataset ...")
    if dataset is None:
        dataset = TrainDataset(args, seed=args.seed)
    logger.log_string("The number of training data is: %d" % len(dataset))

    logger.log_string("\nModel Initial ...")
    logger.log_string("PARAMETER ...")
    logger.log_string(str(args))

    step_builder = put_batch = None
    if mesh.group is not None:
        logger.log_string(f"Data-parallel over {mesh.size} ranks ({dist.get_backend()}), one "
                          f"process a device: the train step runs the unfused branch, as "
                          f"lft_tpu's (--train_fused is not read)")
        step_builder = make_dp_step_builder(mesh)
        put_batch = functools.partial(put_global_batch, mesh)

    with traced(args.profile_dir if args.local_rank <= 0 else "", "train", mesh.device):
        logger.log_string("\nStart training...")
        return fit(args, logger=logger, dataset=dataset, checkpoints_dir=str(checkpoints_dir),
                   device=mesh.device, step_builder=step_builder, put_batch=put_batch)


if __name__ == "__main__":
    from lft_torch.config import parse_args
    main(parse_args())
