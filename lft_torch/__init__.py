"""lft_torch: LFT light-field super-resolution in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

A port of `lft_tpu` (JAX/Pallas on a TPU), which stays in the repository as
the reference. This package imports neither JAX nor `lft_tpu`.
"""

from lft_torch.models import lft as _lft  # noqa: F401  (registers "LFT")
from lft_torch.registry import MODEL_REGISTRY, ModelDef, get_model, register_model

__all__ = ["MODEL_REGISTRY", "ModelDef", "get_model", "register_model"]
