"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`LAUNCHES` counts each kernel's launches; `reset_launches()` zeroes them.
`FORWARD` names the kernels of the SR forward, `TRAINING` those that only a
train step launches.
"""

from lft_torch.kernels._build import (FORWARD, LAUNCHES, TRAINING, build_all,
                                      reset_launches)

__all__ = ["FORWARD", "LAUNCHES", "TRAINING", "build_all", "reset_launches"]
