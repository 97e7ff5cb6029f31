"""Model registry (counterpart of lft_tpu/registry.py).

A model registers a `ModelDef` under its name; callers look it up with
`get_model(args)`. The contract is functional, as in the JAX package:

  init(seed, args, device=None) -> flat {state_dict name: tensor}
  apply(params, lr, args, **kw) -> SR output
  loss(sr, hr) -> scalar tensor

`capabilities` declares the optional `apply` keywords a caller may pass
("fused", ...), so a second model never inherits LFT's fast-path flags.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

MODEL_REGISTRY: Dict[str, "ModelDef"] = {}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    init: Callable[..., Any]
    apply: Callable[..., Any]
    loss: Callable[..., Any]
    param_count: Callable[[Any], int] = lambda p: sum(int(v.numel()) for v in p.values())
    capabilities: frozenset = frozenset()


def register_model(model: ModelDef) -> ModelDef:
    MODEL_REGISTRY[model.name] = model
    return model


def capabilities_of(apply_fn) -> frozenset:
    """Capabilities declared by the registered model owning `apply_fn`
    (unwrapping `functools.partial` and `functools.wraps` chains); empty
    for unregistered callables."""
    seen = set()
    fn = apply_fn
    while id(fn) not in seen:
        seen.add(id(fn))
        for m in MODEL_REGISTRY.values():
            if m.apply is fn:
                return m.capabilities
        inner = getattr(fn, "func", None) or getattr(fn, "__wrapped__", None)
        if inner is None or not callable(inner):
            return frozenset()
        fn = inner
    return frozenset()


def get_model(args) -> ModelDef:
    name = args.model_name if hasattr(args, "model_name") else str(args)
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}") from None
