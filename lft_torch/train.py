"""Training CLI (counterpart of the root train.py, one process).

    python -m lft_torch.train --model_name LFT --angRes 5 --scale_factor 2 --batch_size 8
    python -m lft_torch.train --model_name LFT --angRes 5 --scale_factor 4 --batch_size 4

Trains on the h5 patches under `--path_for_train` and writes a checkpoint
an epoch under `--path_log`, as train.py does; `--use_pre_pth` resumes
(an `.npz` exactly, with its Adam state). Runs on the CUDA card
(`device="cpu"` from Python for the plain PyTorch path). Reading the h5
set needs `h5py`; without it, pass `dataset=` from Python.
"""

from __future__ import annotations


def main(args, device=None, dataset=None):
    """train.py's run. `dataset` is any object with `__len__` and
    `item(index, rng)` (and a `seed` for reproducible batches), a
    `TrainDataset(args, seed=args.seed)` by default. Returns (params,
    history of per-epoch means)."""
    from lft_torch.data.datasets import TrainDataset
    from lft_torch.device import resolve_device
    from lft_torch.training.trainer import fit
    from lft_torch.utils.logging import Logger, create_dir
    from lft_torch.utils.profiling import traced

    dev = resolve_device(device)
    _, checkpoints_dir, log_dir = create_dir(args)
    logger = Logger(log_dir, args)

    logger.log_string("\nLoad Training Dataset ...")
    if dataset is None:
        dataset = TrainDataset(args, seed=args.seed)
    logger.log_string("The number of training data is: %d" % len(dataset))

    logger.log_string("\nModel Initial ...")
    logger.log_string("PARAMETER ...")
    logger.log_string(str(args))

    with traced(args.profile_dir, "train", dev):
        logger.log_string("\nStart training...")
        return fit(args, logger=logger, dataset=dataset, checkpoints_dir=str(checkpoints_dir),
                   device=dev)


if __name__ == "__main__":
    from lft_torch.config import parse_args
    main(parse_args())
