"""Profiling hook (counterpart of irm_motion_planning_tpu/utils/profiling.py;
the reference's, ref: main.py:131-134): a region traced with
``torch.profiler``, the host and, with a card, its kernels, written as a
Chrome trace to ``log_dir/trace.json``."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
