"""Synthetic light-field training batches made on the device
(counterpart of lft_tpu/data/device_synth.py).

A smooth random texture per item, cropped per view at an integer disparity
shift (so the angular attention sees real parallax), and each view
downscaled with the Matlab-bicubic matrices the data generators use. No
host IO: for smoke training and timing a train step.
"""

from __future__ import annotations

import torch

from lft_torch.ops.bicubic import resize_matrix_matlab


def synth_batch(generator: torch.Generator, batch: int = 8, ang_res: int = 5,
                patch: int = 32, scale: int = 2, disparity: int = 1, noise=None):
    """(lr [B, 1, A patch, A patch], hr [B, 1, A patch S, A patch S]) float32
    SAI mosaics on the generator's device. `noise` [B, base, base] (base =
    patch S + 2 pad, pad = |disparity| A + 2), uniform in [0, 1), replaces
    the generator's draw: a test feeds the same numbers to both packages."""
    a, hp = ang_res, patch * scale
    c = (a - 1) / 2.0
    pad = int(abs(disparity) * a) + 2
    base = hp + 2 * pad
    dev = generator.device
    if noise is None:
        noise = torch.rand(batch, base, base, generator=generator, device=dev)
    else:
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
    for _ in range(3):  # band-limit with box blurs
        noise = (noise + torch.roll(noise, 1, 1) + torch.roll(noise, -1, 1)
                 + torch.roll(noise, 1, 2) + torch.roll(noise, -1, 2)) / 5.0
    noise = (noise - noise.min()) / (noise.max() - noise.min() + 1e-9)
    hr = torch.stack([torch.stack([
        noise[:, pad + round((u - c) * disparity):pad + round((u - c) * disparity) + hp,
              pad + round((v - c) * disparity):pad + round((v - c) * disparity) + hp]
        for v in range(a)], 1) for u in range(a)], 1)          # [B, a, a, hp, hp]
    wd = torch.from_numpy(resize_matrix_matlab(hp, patch)).to(dev)   # [patch, hp]
    lr = torch.einsum("ph,buvhw->buvpw", wd, hr)
    lr = torch.einsum("qw,buvpw->buvpq", wd, lr)

    def mosaic(x):
        B, u, v, h, w = x.shape
        return x.permute(0, 1, 3, 2, 4).reshape(B, 1, u * h, v * w).contiguous()

    return mosaic(lr), mosaic(hr)
