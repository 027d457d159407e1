"""Measurement harness: warm-up excluded, mean and stddev over repeats
(counterpart of irm_motion_planning_tpu/utils/timing.py; the reference's
harness, ref: main.py:117-129).  Each timed call ends with
``torch.cuda.synchronize()`` when a card is present, so a time covers the
work the call queued on it."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch


@dataclass
class TimingReport:
    per_measurement_ms: List[float]
    mean_ms: float
    stddev_ms: float
    compile_ms: float   # the warm-up call (it builds the kernels on the card)

    def __str__(self) -> str:
        return (
            f"mean {self.mean_ms:.3f} ms, stddev {self.stddev_ms:.3f} ms "
            f"(warm-up {self.compile_ms:.0f} ms, "
            f"{len(self.per_measurement_ms)} measurements)"
        )


def sync() -> None:
    """Wait for the card's queued work (no-op without a card)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable[[], object], n_measurements: int = 1,
            n_times: int = 1, warmup: bool = True) -> TimingReport:
    """Time ``fn`` like the reference: per measurement run it ``n_times``
    and record the per-call average; report mean and stddev over the
    measurements."""
    compile_ms = 0.0
    if warmup:
        t0 = time.perf_counter()
        fn()
        sync()
        compile_ms = 1000 * (time.perf_counter() - t0)
    runtimes = []
    for _ in range(n_measurements):
        t0 = time.perf_counter()
        for _ in range(n_times):
            fn()
            sync()
        runtimes.append(1000 * (time.perf_counter() - t0) / n_times)
    return TimingReport(
        per_measurement_ms=runtimes,
        mean_ms=float(np.mean(runtimes)),
        stddev_ms=float(np.std(runtimes)),
        compile_ms=compile_ms,
    )
