"""Evaluation CLI (counterpart of the root test.py).

    python -m lft_torch.test --model_name LFT --angRes 5 --scale_factor 4 \\
        --path_pre_pth ./pth/LFT_5x5_4x_epoch_50_model.pth

Super-resolves every scene of every test set under `--path_for_test` with
the checkpoint `--path_pre_pth` (a reference `.pth` or an `.npz`), checked
against the flags' widths, and logs PSNR/SSIM a scene, a set and over the
sets, as test.py does. Runs on the CUDA card (`device="cpu"` from Python
for the plain PyTorch path). Reading the h5 sets needs `h5py`; without it,
call `evaluate_sets` with in-memory sets. `--num_devices N > 1` runs the
sweep over N local ranks, one process a card (lft_torch/parallel/), and
`--coordinator host:port --num_processes N --process_id I` makes this
process rank I of N: every scene's patch grid is split over the ranks, and
only rank 0 writes the log.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def main(args, device=None):
    """test.py's run: the experiment directories and log, the test sets of
    `args.path_for_test`, then `evaluate_sets`; as rank `--process_id` of
    `--num_processes` under `--coordinator`, or over `--num_devices` local
    ranks where that is more than 1 (rank 0's results). Returns (psnr per
    set, ssim per set)."""
    import torch.distributed as dist

    from lft_torch.parallel.distributed import maybe_initialize, spawn_ranks
    from lft_torch.parallel.mesh import get_mesh

    if maybe_initialize(args, device):
        try:
            return _rank_run(get_mesh(device=device), args)
        finally:
            dist.destroy_process_group()
    if (args.num_devices or 1) > 1:
        return spawn_ranks(_rank_run, args.num_devices, (args,), device=device)
    return _run(args, device)


def _rank_run(mesh, args):
    """One rank of the sweep: every chunk sharded; the log on rank 0 only
    (`Logger` reads `local_rank`)."""
    return _run(dataclasses.replace(args, local_rank=mesh.rank), mesh.device, mesh)


def _run(args, device, mesh=None):
    from lft_torch.data.datasets import multi_test_sets
    from lft_torch.utils.logging import Logger, create_dir

    _, _, log_dir = create_dir(args)
    logger = Logger(log_dir, args)
    logger.log_string("\nLoad Test Dataset ...")
    names, sets, total = multi_test_sets(args)
    logger.log_string("The number of test data is: %d" % total)
    return evaluate_sets(args, names, sets, logger, device=device, mesh=mesh)


def evaluate_sets(args, names, sets, logger, device=None, mesh=None):
    """The rest of test.py's run on given sets: each an object with
    `__len__`, `__getitem__` -> (lr, hr) mosaics and optionally
    `scene_name(i)` and `scene_shape(i)`, as `evaluate_dataset` takes.
    Loads and checks the checkpoint, sweeps the sets (under a
    `--profile_dir` trace) and logs the results. Returns (psnr per set,
    ssim per set). With a `mesh` (`parallel.mesh.Mesh`), every rank calls
    this on the same sets, on the mesh's device, and the pipeline splits
    each chunk over the ranks."""
    from lft_torch.device import matmul_precision, resolve_device
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.models.lft import param_shapes
    from lft_torch.registry import get_model
    from lft_torch.utils.checkpoint import load_checkpoint, validate_params
    from lft_torch.utils.profiling import traced

    dev = resolve_device(device if mesh is None else mesh.device, matmul_precision(args))
    logger.log_string("\nModel Initial ...")
    model = get_model(args)
    params, _, _ = load_checkpoint(args.path_pre_pth, device=dev)
    validate_params(params, param_shapes(args.channels, args.scale_factor))
    logger.log_string("Use pretrain model!")
    if mesh is not None and mesh.size > 1:
        logger.log_string(f"Sharded tiled inference over {mesh.size} ranks")
    cache = ScenePipelineCache(model.apply, args, eval_batch=args.eval_batch,
                               scene_batch=args.scene_batch, mesh=mesh)

    logger.log_string("\nStart test...")
    psnr_testset, ssim_testset = [], []
    with traced(args.profile_dir if args.local_rank <= 0 else "", "test", dev):
        for name, dataset in zip(names, sets):
            p, s, per_scene = evaluate_dataset(model.apply, params, args, dataset, cache=cache)
            psnr_testset.append(p)
            ssim_testset.append(s)
            for scene, sp, ss in per_scene:
                logger.log_string("  %s/%s: psnr/ssim %.2f/%.3f" % (name, scene, sp, ss))
            logger.log_string("Test on %s, psnr/ssim is %.2f/%.3f" % (name, p, s))
    if psnr_testset:
        logger.log_string("Mean over datasets: psnr/ssim is %.2f/%.3f"
                          % (float(np.mean(psnr_testset)), float(np.mean(ssim_testset))))
    return psnr_testset, ssim_testset


if __name__ == "__main__":
    from lft_torch.config import parse_args
    main(parse_args())
