"""Checkpoints: reference `.pth` and the JAX package's `.npz`
(counterpart of lft_tpu/utils/checkpoint.py).

Both formats carry the reference's exact state_dict names and layouts, so
loading is a dtype cast: a `.pth` is `{'epoch', 'state_dict'}` or a bare
state_dict (a DataParallel `module.` prefix is stripped); an `.npz` is a
flat name -> array file whose `__epoch__` entry holds the epoch and whose
`__opt__/leafNNNN` entries hold the optimizer state (training/optim.py), in
the same layout in both packages, so either resumes the other's run.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from lft_torch.device import resolve_device

_EPOCH_KEY = "__epoch__"
_OPT_PREFIX = "__opt__/"


def _strip_module_prefix(state_dict) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state_dict.items():
        name = k[len("module."):] if k.startswith("module.") else k
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        out[name] = np.asarray(arr, dtype=np.float32)
    return out


def load_numpy_params(path: str):
    """`.pth` or `.npz` -> ({name: float32 array}, epoch, optimizer leaves
    {leafNNNN: array} or None)."""
    if path.endswith((".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            return (_strip_module_prefix(ckpt["state_dict"]), int(ckpt.get("epoch", 0)),
                    None)
        return _strip_module_prefix(ckpt), 0, None
    params, opt, epoch = {}, {}, 0
    with np.load(path) as z:
        for k in z.files:
            if k == _EPOCH_KEY:
                epoch = int(z[k])
            elif k.startswith(_OPT_PREFIX):
                opt[k[len(_OPT_PREFIX):]] = z[k]
            else:
                params[k] = np.asarray(z[k], dtype=np.float32)
    return params, epoch, (opt or None)


def load_checkpoint(path: str, device=None):
    """Load a checkpoint as float32 tensors on `device` (cuda unless the
    caller passes 'cpu'). Returns (params, epoch, optimizer leaves or None;
    see `training.optim.opt_state_from_jax_flat`)."""
    from lft_torch.models.lft import params_from_numpy
    dev = resolve_device(device)
    params, epoch, opt = load_numpy_params(path)
    return params_from_numpy(params, device=dev), epoch, opt


def _to_numpy(params) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().astype(np.float32) if isinstance(v, torch.Tensor)
            else np.asarray(v, dtype=np.float32) for k, v in params.items()}


def save_checkpoint(path: str, params, epoch: int,
                    opt_state_flat: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a flat `.npz` (params, `__epoch__`, `__opt__/leafNNNN`),
    atomically through a temporary file."""
    payload = _to_numpy(params)
    payload[_EPOCH_KEY] = np.asarray(epoch, dtype=np.int64)
    for k, v in (opt_state_flat or {}).items():
        payload[_OPT_PREFIX + k] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def params_to_pth(params, path: str, epoch: int = 0) -> None:
    """A reference-compatible `{'epoch', 'state_dict'}` torch checkpoint."""
    state = OrderedDict((k, torch.from_numpy(v)) for k, v in _to_numpy(params).items())
    torch.save({"epoch": int(epoch), "state_dict": state}, path)


def validate_params(params, expected_shapes: Dict[str, tuple]) -> None:
    """Raise with a precise message on any missing, unexpected or
    mis-shaped entry."""
    missing = sorted(set(expected_shapes) - set(params))
    unexpected = sorted(set(params) - set(expected_shapes))
    bad = [f"{k}: got {tuple(params[k].shape)}, want {tuple(s)}"
           for k, s in expected_shapes.items()
           if k in params and tuple(params[k].shape) != tuple(s)]
    if missing or unexpected or bad:
        raise ValueError("checkpoint/param mismatch:\n"
                         + (f"  missing: {missing}\n" if missing else "")
                         + (f"  unexpected: {unexpected}\n" if unexpected else "")
                         + ("  shapes:\n    " + "\n    ".join(bad) if bad else ""))
