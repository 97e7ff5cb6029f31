"""Checkpoint loading: reference `.pth` and the JAX package's `.npz`
(counterpart of lft_tpu/utils/checkpoint.py).

Both formats carry the reference's exact state_dict names and layouts, so
loading is a dtype cast: a `.pth` is `{'epoch', 'state_dict'}` or a bare
state_dict (a DataParallel `module.` prefix is stripped); an `.npz` is a
flat name -> array file whose `__epoch__` entry holds the epoch and whose
`__opt__/` entries hold optimizer state (not used by inference).
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def load_numpy_params(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """`.pth` or `.npz` -> ({name: float32 array}, epoch)."""
    if path.endswith((".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            return _strip_module_prefix(ckpt["state_dict"]), int(ckpt.get("epoch", 0))
        return _strip_module_prefix(ckpt), 0
    params, epoch = {}, 0
    with np.load(path) as z:
        for k in z.files:
            if k == _EPOCH_KEY:
                epoch = int(z[k])
            elif not k.startswith(_OPT_PREFIX):
                params[k] = np.asarray(z[k], dtype=np.float32)
    return params, epoch


def load_checkpoint(path: str, device=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """Load a checkpoint as float32 tensors on `device` (cuda unless the
    caller passes 'cpu'). Returns (params, epoch)."""
    from lft_torch.models.lft import params_from_numpy
    dev = resolve_device(device)
    params, epoch = load_numpy_params(path)
    return params_from_numpy(params, device=dev), epoch


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
