"""The data-parallel train step and the ranks it runs on (counterpart of
lft_tpu/parallel/mesh.py).

lft_tpu maps its train step over a `('dp',)` device mesh with `shard_map`
and `pmean`s the gradients. Here each rank is a process (parallel/
distributed.py), and the step is `trainer.make_train_step` given the
mesh: forward and backward on the rank's shard of the global batch, every
gradient copied in the fixed order of the parameters' names into one flat
f32 buffer, one `all_reduce(SUM)` of it, divided by the world size
(`Mesh.average_grads`), then the replicated Adam update. No bucketing by
the order gradients arrive and no DDP hooks: the same state and batch
give the same update bit for bit, on every rank.
Loss, PSNR and SSIM are averaged over the ranks in one more small
all-reduce, so the logs read as a single process's.

As in lft_tpu (mesh.py:66, `model.apply(params, data, args)` without
`fused=`), the data-parallel step trains the unfused branch, whatever
`--train_fused` says: on the card the per-op kernels K7 and K5 (or K8,
K9, K6 where the geometry or knobs send it) with their kernel backwards,
under `--dtype bfloat16` their `_bf16io` forms (`kernels.PEROP_BF16TRAIN`).
At world size 1 it is `make_train_step(--train_fused false)`'s step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lft_torch.device import resolve_device
from lft_torch.parallel.distributed import rank_device, share_rows
from lft_torch.training.trainer import make_train_step


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel run: its rank of `size`, its
    device and the process group (None for one process without a group)."""
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    def average_grads(self, params) -> None:
        """Every parameter's gradient replaced by its mean over the ranks:
        in sorted-name order into one flat f32 buffer, one
        `all_reduce(SUM)`, divided by the ranks, copied back."""
        grads = [params[n].grad for n in sorted(params)]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        # copied back, not left as views of `flat`: given views of one
        # buffer, Adam's foreach ops ran tensor by tensor (on an H100,
        # more than this copy costs)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])

    def average(self, *values):
        """The means over the ranks of 0-d tensors, in one all-reduce; a
        None stays None."""
        live = [v for v in values if v is not None]
        m = torch.stack(live)
        dist.all_reduce(m, group=self.group)
        it = iter((m / self.size).unbind())
        return tuple(None if v is None else next(it) for v in values)


def get_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """The run's ranks: the default process group where one is initialized
    (`num_devices`, if given, must equal its size), else this process
    alone. `device` as `distributed.rank_device` takes it."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"num_devices {num_devices} needs a process group of that many "
                             f"ranks (parallel.distributed)")
        return Mesh(0, 1, resolve_device(device))
    rank, size = dist.get_rank(), dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices {num_devices} != the process group's {size} ranks")
    return Mesh(rank, size, rank_device(rank, device), dist.group.WORLD)


def make_dp_train_step(model, optimizer, args, mesh: Mesh, with_metrics: bool = True):
    """The data-parallel update: `trainer.make_train_step` on `mesh`, whose
    `data` and `label` are this rank's shard of the global batch and whose
    results are means over the ranks. `params` (the optimizer's tensors,
    updated in place) are the same on every rank before and after."""
    return make_train_step(model, optimizer, args, with_metrics, mesh=mesh)


def make_dp_step_builder(mesh: Mesh):
    """Adapter for `lft_torch.training.trainer.fit(step_builder=...)`."""
    def builder(model, optimizer, args, with_metrics: bool = True):
        return make_dp_train_step(model, optimizer, args, mesh, with_metrics)
    return builder


def put_global_batch(mesh: Mesh, data: np.ndarray, label: np.ndarray):
    """A global numpy batch (the same on every rank) -> this rank's rows of
    it (`distributed.local_slice`'s) on its device."""
    d, l = share_rows(data, label, mesh.rank, mesh.size)
    return (torch.from_numpy(np.ascontiguousarray(d)).to(mesh.device),
            torch.from_numpy(np.ascontiguousarray(l)).to(mesh.device))
