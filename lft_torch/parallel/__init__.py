"""Data parallelism: one process per device, joined by `torch.distributed`
(counterpart of lft_tpu/parallel/)."""
