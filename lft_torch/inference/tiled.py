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
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from lft_torch.ops.metrics import cal_metrics
from lft_torch.ops.tiling import lf_divide, lf_integrate, tiling_grid, views_4d_to_mosaic
from lft_torch.registry import capabilities_of


def make_scene_sr(model_apply, args, h0: int, w0: int,
                  eval_batch: Optional[int] = None, n_scenes: int = 1,
                  **apply_kw):
    """Build `scene_sr(params, lr [A*h0, A*w0]) -> sr [A*h0*S, A*w0*S]` for
    one scene geometry; with `n_scenes > 1` it maps [N, A*h0, A*w0] ->
    [N, A*h0*S, A*w0*S], the scenes' patch grids concatenated along the
    chunk axis. Extra keywords go to `model_apply` (for example
    `plain_blocks=True`)."""
    A = args.angRes
    S = args.scale_factor
    patch = args.patch_size_for_test
    stride = args.stride_for_test
    g = tiling_grid(h0, w0, patch, stride)
    n_patches = g["numU"] * g["numV"] * n_scenes
    eb = min(eval_batch or args.eval_batch, n_patches)
    # the counterpart of lft_tpu/inference/tiled.py:77-78: declared
    # capability, fused on the accelerator
    takes_fused = "fused" in capabilities_of(model_apply)

    @torch.no_grad()
    def scene_sr(params, lr_mosaic: torch.Tensor) -> torch.Tensor:
        lr_s = lr_mosaic if n_scenes > 1 else lr_mosaic[None]
        flat = torch.cat([lf_divide(m, A, patch, stride) for m in lr_s])
        flat = flat.reshape(n_patches, 1, A * patch, A * patch)
        kw = dict(apply_kw)
        if takes_fused:
            kw.setdefault("fused", lr_mosaic.is_cuda)
        outs = [model_apply(params, flat[i:i + eb], args, **kw)
                for i in range(0, n_patches, eb)]
        out = torch.cat(outs).reshape(n_scenes, g["numU"], g["numV"],
                                      A * patch * S, A * patch * S)
        mos = torch.stack([views_4d_to_mosaic(lf_integrate(
            o, A, patch * S, stride * S, h0 * S, w0 * S)) for o in out])
        return mos if n_scenes > 1 else mos[0]

    return scene_sr


class ScenePipelineCache:
    """One `make_scene_sr` pipeline per (h0, w0, n_scenes); `run_batch`
    super-resolves a group of same-shape scenes through one pipeline call."""

    def __init__(self, model_apply, args, eval_batch: Optional[int] = None,
                 scene_batch: Optional[int] = None, **apply_kw):
        self.model_apply = model_apply
        self.args = args
        self.eval_batch = eval_batch
        self.scene_batch = max(scene_batch or getattr(args, "scene_batch", 1) or 1, 1)
        self.apply_kw = apply_kw
        self._cache = {}

    def _pipeline(self, h0: int, w0: int, n: int = 1):
        key = (h0, w0, n)
        if key not in self._cache:
            self._cache[key] = make_scene_sr(self.model_apply, self.args, h0, w0,
                                             self.eval_batch, n_scenes=n,
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


def evaluate_dataset(model_apply, params, args,
                     dataset: Sequence, cache: Optional[ScenePipelineCache] = None):
    """Tiled SR of every `(lr, hr)` mosaic pair of `dataset` (numpy or
    tensors) plus per-scene PSNR/SSIM against hr (reference
    test.py:73-111), on the device of `params`. Same-shape scenes are
    swept together in groups of `cache.scene_batch`.
    Returns (psnr_mean, ssim_mean, [(name, psnr, ssim), ...])."""
    dev = next(iter(params.values())).device
    cache = cache or ScenePipelineCache(model_apply, args,
                                        eval_batch=getattr(args, "eval_batch", None))
    order = sorted(range(len(dataset)), key=lambda i: (tuple(np.shape(dataset[i][0])), i))
    per_scene = {}
    pending = []

    def flush():
        if not pending:
            return
        srs = cache.run_batch(params, [lr for _, lr, _ in pending])
        for (i, _, hr), sr in zip(pending, srs):
            p, s = cal_metrics(hr, sr, args.angRes)
            per_scene[i] = (str(i), float(p), float(s))
        pending.clear()

    for i in order:
        lr, hr = dataset[i]
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        hr = torch.as_tensor(hr, dtype=torch.float32, device=dev)
        if pending and pending[-1][1].shape != lr.shape:
            flush()
        pending.append((i, lr, hr))
        if len(pending) >= cache.scene_batch:
            flush()
    flush()
    rows = [per_scene[i] for i in range(len(dataset))]
    psnr = float(np.mean([r[1] for r in rows]))
    ssim = float(np.mean([r[2] for r in rows]))
    return psnr, ssim, rows
