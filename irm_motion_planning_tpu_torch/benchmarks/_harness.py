"""What the benchmark modules share: the device a run measures on, the
card's name and power limit beside its numbers, and the clocks (CUDA events,
or host clocks ended by ``torch.cuda.synchronize()``)."""

from __future__ import annotations

import sys
import time
from typing import Callable

import torch


def open_device(name: str, prog: str) -> torch.device:
    """The device ``--device`` names; without a card ``cuda`` exits 2 (no
    fallback to the CPU, which runs the plain versions)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (--device cpu runs the plain "
              f"versions)", file=sys.stderr)
        raise SystemExit(2)
    return dev


def card(dev: torch.device) -> dict:
    """``device`` and ``power_limit`` as nvidia-smi reports them, or "cpu"
    and None for a CPU run."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    from ..bench import gpu_name_and_power_limit

    name, power = gpu_name_and_power_limit()
    return {"device": name, "power_limit": power}


def platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_seconds(fn: Callable, dev: torch.device, repeats: int):
    """(least seconds of ``repeats`` calls of fn, fn's last result): one
    untimed call first (it builds the kernels), each timed call ended by a
    synchronize."""
    out = fn()
    sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def event_ms(fn: Callable, dev: torch.device):
    """(fn's result, milliseconds): by CUDA events around the call on the
    card, by the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)
