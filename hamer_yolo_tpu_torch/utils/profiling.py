"""Profiling (port of hamer_yolo_tpu/utils/profiling.py's ``trace``): a
torch.profiler trace of a block, written to a directory as a Chrome trace
(view it in Perfetto, chrome://tracing or TensorBoard's profiler plugin)."""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block: the host's ops and, where ``device`` is a CUDA
    device, the card's kernels; on exit the trace goes to
    ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
