"""`--profile_dir`: a `torch.profiler` trace of a CLI's main span."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def traced(profile_dir: str, name: str, device: torch.device):
    """Profile the body (host activity, and the card's with a CUDA
    `device`) and write `<profile_dir>/<name>.pt.trace.json` (Chrome trace
    JSON) when it ends. With an empty `profile_dir` it does nothing."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.pt.trace.json"))
