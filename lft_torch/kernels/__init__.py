"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`LAUNCHES` counts each kernel's launches; `reset_launches()` zeroes them.
"""

from lft_torch.kernels._build import LAUNCHES, build_all, reset_launches

__all__ = ["LAUNCHES", "build_all", "reset_launches"]
