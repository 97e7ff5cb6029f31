"""What the port's hand-written kernels take, read by their wrappers and by
the model's dispatch.

The CUDA sources are built for C in `KERNEL_C` model channels: head widths
2, 4, 8 in the angular attention (C over 8 heads) and 4, 8, 16 in the
spatial one (2C over 8 heads). lft_tpu's Pallas kernels take any C with
8 | 2C. So where a choice is automatic (`attention_impl='auto'`, the fused
branch of a forward or train step on CUDA, the tiled scene pipeline), a
model of another width takes the plain torch ops: the unfused branch with
the tiled or dense torch attention, and no kernel is launched. An explicit
request for a kernel (`attention_impl='pallas'`, a block or kernel wrapper
called directly) still raises `NotImplementedError` at such a width.
"""

from __future__ import annotations

KERNEL_C = (16, 32, 64)


def kernels_take(C: int) -> bool:
    """Whether the port's kernels take a model of C channels."""
    return C in KERNEL_C


def attention_route(impl: str, device_type: str, C: int) -> str:
    """The unfused branch's attention implementation for a model of C
    channels on `device_type`: 'auto' becomes 'pallas' (the per-op kernels)
    on CUDA where `kernels_take(C)` and stays 'auto' (the tiled or dense
    torch op) otherwise; an explicit choice is kept."""
    if impl == "auto" and device_type == "cuda" and kernels_take(C):
        return "pallas"
    return impl
