"""Full-scene tiled super-resolution (counterpart of
lft_tpu/inference/tiled.py).

`lf_divide` cuts the scene into overlapping patch mosaics, the model runs
over them in chunks of `eval_batch` patches (a Python loop over the full
chunks plus one remainder chunk of the leftover patches: every patch the
model runs is a real one), and `lf_integrate` stitches the central crops.
On CUDA the model takes its fused branch (the port's kernels); the JAX
pipeline turns its fused branch on for the TPU the same way
(lft_tpu/inference/tiled.py:77-78). PyTorch runs eagerly, so there is no
compile to cache and no geometry bucketing; `ScenePipelineCache` keeps one
pipeline per scene geometry and batches same-shape scenes.

With a `mesh` of several ranks (lft_torch/parallel/) the patch axis of
every chunk is split over them, as lft_tpu shards it over 'dp'
(lft_tpu/inference/tiled.py:54-59, :81-82): each rank runs its share and
`all_gather_into_tensor` puts the chunk back together in patch order, so
every rank returns the whole SR mosaic.

`args` reaches the model with every chunk, `--dtype` with it: the `mixed`
plans are read by each model call (kernels/common.py), never kept in
`ScenePipelineCache`, so a changed plan never mixes two plans in one scene.
Under `bfloat16` the model picks its branch itself on every device
(`fused=None`, models/lft.py:resolve_bf16): the fused blocks where their
gates (and, on the card, the kernels' widths) take the geometry, the
unfused per-op branch elsewhere, as lft_tpu picks; the scene buffers, the
model's output and the metrics stay f32.
"""

from __future__ import annotations

import concurrent.futures as _fut
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from lft_torch.kernels.common import kernels_take
from lft_torch.ops.metrics import cal_metrics
from lft_torch.ops.tiling import lf_divide, lf_integrate, tiling_grid, views_4d_to_mosaic
from lft_torch.registry import capabilities_of


def make_scene_sr(model_apply, args, h0: int, w0: int,
                  eval_batch: Optional[int] = None, n_scenes: int = 1,
                  mesh=None, **apply_kw):
    """Build `scene_sr(params, lr [A*h0, A*w0]) -> sr [A*h0*S, A*w0*S]` for
    one scene geometry; with `n_scenes > 1` it maps [N, A*h0, A*w0] ->
    [N, A*h0*S, A*w0*S], the scenes' patch grids concatenated along the
    chunk axis. Extra keywords go to `model_apply` (for example
    `plain_blocks=True`). With a `mesh` (`parallel.mesh.Mesh`) of R > 1
    ranks, every rank calls `scene_sr` on the same scene: the chunk size is
    rounded down to a multiple of R, each chunk split evenly over the
    ranks (the remainder chunk zero-padded up to a multiple of R, the
    padding dropped after) and gathered back in patch order."""
    A = args.angRes
    S = args.scale_factor
    patch = args.patch_size_for_test
    stride = args.stride_for_test
    g = tiling_grid(h0, w0, patch, stride)
    n_patches = g["numU"] * g["numV"] * n_scenes
    eb = min(eval_batch or args.eval_batch, n_patches)
    ranks = mesh.size if mesh is not None else 1
    if ranks > 1:
        eb = max(eb // ranks, 1) * ranks  # a chunk splits evenly over the ranks
    # the counterpart of lft_tpu/inference/tiled.py:77-78: declared
    # capability, fused on the accelerator where the kernels take the width
    takes_fused = "fused" in capabilities_of(model_apply)
    fuse_cuda = kernels_take(args.channels)
    bf16 = str(getattr(args, "dtype", "float32")) == "bfloat16"

    @torch.no_grad()
    def scene_sr(params, lr_mosaic: torch.Tensor) -> torch.Tensor:
        lr_s = lr_mosaic if n_scenes > 1 else lr_mosaic[None]
        flat = torch.cat([lf_divide(m, A, patch, stride) for m in lr_s])
        flat = flat.reshape(n_patches, 1, A * patch, A * patch)
        kw = dict(apply_kw)
        if takes_fused:
            kw.setdefault("fused", None if bf16 else lr_mosaic.is_cuda and fuse_cuda)
        run = (lambda c: model_apply(params, c, args, **kw)) if ranks == 1 else \
            (lambda c: _sharded_chunk(model_apply, params, c, args, kw, mesh))
        outs = [run(flat[i:i + eb]) for i in range(0, n_patches, eb)]
        out = torch.cat(outs).reshape(n_scenes, g["numU"], g["numV"],
                                      A * patch * S, A * patch * S)
        mos = torch.stack([views_4d_to_mosaic(lf_integrate(
            o, A, patch * S, stride * S, h0 * S, w0 * S)) for o in out])
        return mos if n_scenes > 1 else mos[0]

    return scene_sr


def _sharded_chunk(model_apply, params, chunk, args, kw, mesh):
    """One chunk over the mesh's ranks: this rank's even share (the chunk
    zero-padded up to a multiple of the ranks), gathered in patch order;
    the padding dropped."""
    n = chunk.shape[0]
    pad = (-n) % mesh.size
    if pad:
        chunk = torch.cat([chunk, chunk.new_zeros((pad,) + tuple(chunk.shape[1:]))])
    per = chunk.shape[0] // mesh.size
    mine = model_apply(params, chunk[mesh.rank * per:(mesh.rank + 1) * per], args,
                       **kw).contiguous()
    whole = mine.new_empty((per * mesh.size,) + tuple(mine.shape[1:]))
    dist.all_gather_into_tensor(whole, mine, group=mesh.group)
    return whole[:n]


class ScenePipelineCache:
    """One `make_scene_sr` pipeline per (h0, w0, n_scenes); `run_batch`
    super-resolves a group of same-shape scenes through one pipeline call.
    `mesh` shards every pipeline's chunks over its ranks."""

    def __init__(self, model_apply, args, eval_batch: Optional[int] = None,
                 scene_batch: Optional[int] = None, mesh=None, **apply_kw):
        self.model_apply = model_apply
        self.args = args
        self.eval_batch = eval_batch
        self.scene_batch = max(scene_batch or getattr(args, "scene_batch", 1) or 1, 1)
        self.mesh = mesh
        self.apply_kw = apply_kw
        self._cache = {}

    def _pipeline(self, h0: int, w0: int, n: int = 1):
        key = (h0, w0, n)
        if key not in self._cache:
            self._cache[key] = make_scene_sr(self.model_apply, self.args, h0, w0,
                                             self.eval_batch, n_scenes=n, mesh=self.mesh,
                                             **self.apply_kw)
        return self._cache[key]

    def __call__(self, params, lr_mosaic: torch.Tensor) -> torch.Tensor:
        return self.run_batch(params, [lr_mosaic])[0]

    def run_batch(self, params, lr_mosaics) -> list:
        A = self.args.angRes
        shapes = {tuple(m.shape) for m in lr_mosaics}
        if len(shapes) != 1:
            raise ValueError(f"run_batch needs same-shape scenes, got {shapes}")
        H, W = lr_mosaics[0].shape
        n = len(lr_mosaics)
        pipe = self._pipeline(H // A, W // A, n)
        if n == 1:
            return [pipe(params, lr_mosaics[0])]
        return list(pipe(params, torch.stack(list(lr_mosaics))))


def evaluate_dataset(model_apply, params, args, dataset: Sequence,
                     cache: Optional[ScenePipelineCache] = None, metrics_fn=None, log=print,
                     prefetch: bool = True):
    """Tiled SR of every `(lr, hr)` mosaic pair of `dataset` plus per-scene
    PSNR/SSIM against hr (reference test.py:73-111), on the device of
    `params` (lft_tpu/inference/tiled.py:234-310). `dataset` is any object
    with `__len__` and `__getitem__` (numpy or tensors); a `scene_name(i)`
    names the scenes (else `str(i)`), and with `cache.scene_batch > 1` a
    `scene_shape(i)` (no pixel read) orders the sweep so same-shape scenes
    go through one pipeline call. No scene's pixels are read to order them.

    With `prefetch`, one background thread reads scene i+1 and moves it to
    the device while scene i runs. `metrics_fn(hr, sr, angRes) -> (psnr,
    ssim)` replaces `cal_metrics`; `log` is taken for lft_tpu's signature
    and logs nothing. Returns (psnr_mean, ssim_mean, [(name, psnr, ssim)])
    in dataset order."""
    dev = next(iter(params.values())).device
    cache = cache or ScenePipelineCache(model_apply, args,
                                        eval_batch=getattr(args, "eval_batch", None))
    metrics_fn = metrics_fn or cal_metrics
    n = len(dataset)
    sb = cache.scene_batch
    order = list(range(n))
    if sb > 1 and n > 1 and hasattr(dataset, "scene_shape"):
        order.sort(key=lambda i: (tuple(dataset.scene_shape(i)), i))

    def load(i):
        lr, hr = dataset[i]
        return (torch.as_tensor(lr, dtype=torch.float32, device=dev),
                torch.as_tensor(hr, dtype=torch.float32, device=dev))

    per_scene = {}
    pending = []  # [(i, lr, hr)]: a same-shape group awaiting one pipeline call

    def flush():
        if not pending:
            return
        srs = cache.run_batch(params, [lr for _, lr, _ in pending])
        for (i, _, hr), sr in zip(pending, srs):
            p, s = metrics_fn(hr, sr, args.angRes)
            name = dataset.scene_name(i) if hasattr(dataset, "scene_name") else str(i)
            per_scene[i] = (name, float(p), float(s))
        pending.clear()

    ex = _fut.ThreadPoolExecutor(max_workers=1) if (prefetch and n > 1) else None
    try:
        nxt = ex.submit(load, order[0]) if ex else None
        for pos, i in enumerate(order):
            lr, hr = nxt.result() if ex else load(i)
            if ex and pos + 1 < n:
                nxt = ex.submit(load, order[pos + 1])
            if pending and pending[-1][1].shape != lr.shape:
                flush()  # a shape change ends the group early
            pending.append((i, lr, hr))
            if len(pending) >= sb:
                flush()
        flush()
    finally:
        if ex:
            # join the worker, so no read outlives a sweep that raised;
            # cancel_futures drops a load not yet started
            ex.shutdown(wait=True, cancel_futures=True)
    rows = [per_scene[i] for i in range(n)]
    return float(np.mean([r[1] for r in rows])), float(np.mean([r[2] for r in rows])), rows
