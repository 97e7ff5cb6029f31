"""Training: the update step, the epoch loop, checkpoints and resume
(counterpart of lft_tpu/training/trainer.py).

Reference behaviour mirrored (reference train.py:86-138): per-epoch loop to
`args.epoch` over shuffled batches, L1 loss, per-iteration train PSNR/SSIM
(computed on the device), a checkpoint per epoch named
`<model>_<A>x<A>_<S>x_epoch_<NN>_model.{npz,pth}`, resume from
`--use_pre_pth`. As in the JAX package, an `.npz` also carries the Adam
moments and both step counts, so a resume is exact; a `.pth` resume starts
fresh moments with the schedule fast-forwarded to the checkpoint's epoch.

On the card the model trains, as lft_tpu does at float32, through the
unfused branch, whose two attentions are the per-op kernels (K7 and K5, or
K8, K9 and K6 where the geometry or the `LFT_ANG_VARIANT` / `LFT_SPA_VARIANT`
knobs send them) with kernel backwards (no atomics) and everything else
torch's own autograd; or with `--train_fused true`, and by default under
`--dtype mixed` or `bfloat16` (as lft_tpu's `auto` on its accelerator),
through the fused blocks, whose backwards are the hand-written K4/K3 kernels
with deterministic weight-gradient reductions (every geometry the fused
gates pass, up to 11x11 views). Under `--dtype bfloat16` the model computes
in bf16 (`models/lft.py`) through either branch, while the master
parameters, the Adam moments and the checkpoints stay f32. cuDNN is held to deterministic algorithms: the
same state and batch give the same update bit for bit.

Data parallelism lives in lft_torch/parallel/; as in lft_tpu, `fit` takes
the step as a pluggable (`step_builder`) and the move of a numpy batch to
the device (`put_batch`), so one and many ranks share the epoch loop.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from lft_torch.data.datasets import TrainDataset, iterate_batches
from lft_torch.device import matmul_precision, resolve_device
from lft_torch.ops.metrics import cal_metrics
from lft_torch.training.optim import make_optimizer, opt_state_from_jax_flat
from lft_torch.utils.checkpoint import (load_checkpoint, params_to_pth, save_checkpoint,
                                       validate_params)


def train_fused(args, device: torch.device) -> bool:
    """`--train_fused`: auto = the fused blocks on the card under `--dtype
    mixed` or `bfloat16`, the unfused branch otherwise, as lft_tpu's auto
    (lft_tpu/training/trainer.py:100-104: fused on its accelerator in
    bfloat16 or mixed; the card stands where the TPU stands). On CUDA the
    unfused branch runs the per-op kernels (`--attention_impl`). true trains
    the fused blocks: their kernels on CUDA, their plain versions through
    the autograd Functions on the CPU. A geometry the fused gates do not
    pass goes to the unfused branch whatever this says
    (`models.lft.resolve_fused`, `resolve_bf16`)."""
    tf = str(getattr(args, "train_fused", "auto")).lower()
    dt = str(getattr(args, "dtype", ""))
    if tf == "auto":
        return torch.device(device).type == "cuda" and dt in ("mixed", "bfloat16")
    return tf in ("true", "1", "yes")


def make_train_step(model, optimizer, args, with_metrics: bool = True,
                    mesh=None) -> Callable:
    """One update: `step(params, data, label) -> (loss, psnr, ssim)`, 0-d
    tensors on the device (psnr, ssim None without metrics). `params` are
    the optimizer's tensors, updated in place.

    With a `mesh` (`parallel.mesh.Mesh`), the data-parallel step: it trains
    the unfused branch whatever `--train_fused` says, as lft_tpu's does
    (lft_tpu/parallel/mesh.py:66), under `--dtype bfloat16` too; where the
    mesh has a process group, `data` and `label` are this rank's shard, the
    gradients are averaged over the ranks before the update and the results
    are means over them."""
    device = optimizer.params[0].device
    fused = mesh is None and train_fused(args, device)
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    kw = {"fused": fused} if "fused" in model.capabilities else {}
    reduce = mesh is not None and mesh.group is not None

    def step(params, data, label):
        optimizer.zero_grad()
        sr = model.apply(params, data, args, **kw)
        loss = model.loss(sr, label)
        loss.backward()
        if reduce:
            mesh.average_grads(params)
        optimizer.step()
        loss, psnr, ssim = loss.detach(), None, None
        if with_metrics:
            with torch.no_grad():
                psnr, ssim = cal_metrics(label[:, 0], sr.detach()[:, 0], args.angRes)
        if reduce:
            loss, psnr, ssim = mesh.average(loss, psnr, ssim)
        return loss, psnr, ssim

    return step


def train_epoch(step_fn, params, dataset, args, seed: int, device, log=None,
                put_batch=None) -> dict:
    """One epoch over shuffled fixed-shape batches; returns the means of
    loss, psnr and ssim. `--log_every N` logs every N iterations.
    `put_batch(data, label)` moves a numpy batch to the step's device
    (default: the whole batch to `device`)."""
    acc = []
    log_every = getattr(args, "log_every", 0) or 0
    for it, (data, label) in enumerate(iterate_batches(
            dataset, args.batch_size, shuffle=True, seed=seed, drop_last=True,
            num_workers=args.num_workers)):
        if put_batch is None:
            data, label = torch.from_numpy(data).to(device), torch.from_numpy(label).to(device)
        else:
            data, label = put_batch(data, label)
        out = step_fn(params, data, label)
        acc.append(out)
        if log_every and log is not None and (it + 1) % log_every == 0:
            log("  iter %d: loss %.5f psnr %.3f" % (
                it + 1, float(out[0]), float("nan") if out[1] is None else float(out[1])))
    if not acc:
        return {}
    means = {"loss": float(torch.stack([a[0] for a in acc]).mean())}
    if acc[0][1] is not None:
        means["psnr"] = float(torch.stack([a[1] for a in acc]).mean())
        means["ssim"] = float(torch.stack([a[2] for a in acc]).mean())
    return means


def checkpoint_path(checkpoints_dir: str, args, epoch: int) -> str:
    ext = "pth" if args.ckpt_format == "pth" else "npz"
    return os.path.join(checkpoints_dir, "%s_%dx%d_%dx_epoch_%02d_model.%s" % (
        args.model_name, args.angRes, args.angRes, args.scale_factor, epoch, ext))


def fit(args, logger=None, dataset=None, checkpoints_dir: Optional[str] = None,
        device=None, step_builder=None, put_batch=None):
    """A full training run (reference train.py:10-108). `dataset` is any
    object with `__len__` and `item(index, rng)`, a `TrainDataset` of
    `args.path_for_train` by default. Runs on `device` (cuda unless the
    caller passes 'cpu'). `step_builder(model, optimizer, args)` makes the
    step (`make_train_step` by default; `parallel.mesh.make_dp_step_builder`
    for data parallelism) and `put_batch` moves each batch to it
    (`train_epoch`). Returns (params, history of per-epoch means)."""
    from lft_torch.models.lft import param_shapes
    from lft_torch.registry import get_model
    log = logger.log_string if logger else print
    dev = resolve_device(device, matmul_precision(args))
    model = get_model(args)
    dataset = dataset if dataset is not None else TrainDataset(args, seed=args.seed)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)

    start_epoch, opt_flat = 0, None
    if args.use_pre_pth:
        params, start_epoch, opt_flat = load_checkpoint(args.path_pre_pth, device=dev)
        # the checkpoint against the run's flags (lft_tpu/training/trainer.py:182-184)
        validate_params(params, param_shapes(args.channels, args.scale_factor))
    else:
        params = model.init(args.seed, args, device=dev)
    for p in params.values():
        p.requires_grad_(True)
    optimizer = make_optimizer(params, args, steps_per_epoch)
    if args.use_pre_pth:
        if opt_flat:
            optimizer.load_state(opt_state_from_jax_flat(opt_flat, params))
        else:
            optimizer.count = start_epoch * steps_per_epoch
        log("Use pretrain model!")

    step_fn = (step_builder or make_train_step)(model, optimizer, args)
    history = []
    for epoch in range(start_epoch, args.epoch):
        t0 = time.time()
        means = train_epoch(step_fn, params, dataset, args, seed=args.seed + epoch,
                            device=dev, log=log, put_batch=put_batch)
        log("The %dth Train, loss is: %.5f, psnr is %.5f, ssim is %.5f (%.1fs)"
            % (epoch + 1, means.get("loss", float("nan")), means.get("psnr", float("nan")),
               means.get("ssim", float("nan")), time.time() - t0))
        history.append(means)
        if checkpoints_dir is not None and args.local_rank == 0:
            path = checkpoint_path(checkpoints_dir, args, epoch + 1)
            if args.ckpt_format == "pth":
                params_to_pth(params, path, epoch=epoch + 1)
            else:
                save_checkpoint(path, params, epoch + 1, optimizer.state_flat())
            log("Saving the epoch_%02d model at %s" % (epoch + 1, path))
    return params, history
