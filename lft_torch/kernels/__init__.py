"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`LAUNCHES` counts each kernel's launches; `reset_launches()` zeroes them.
`FORWARD` names the kernels of the fused SR forward, `TRAINING` those that
only a fused train step launches, `PEROP` those of the unfused per-op branch's
default pair (K7, K5), `SWEEPS` those of its other families (K8, K9, K6).
"""

from lft_torch.kernels._build import (FORWARD, LAUNCHES, PEROP, SWEEPS, TRAINING, build_all,
                                      reset_launches)

__all__ = ["FORWARD", "LAUNCHES", "PEROP", "SWEEPS", "TRAINING", "build_all", "reset_launches"]
