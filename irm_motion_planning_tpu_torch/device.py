"""Where the port's constructors build their tensors."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` when given, else the card.  Without a CUDA device the
    caller must ask for the CPU (``device="cpu"``): there is no silent
    fallback, because the CPU runs the plain versions, not the kernels."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: the port builds on the card by default; pass '
            'device="cpu" to build on the CPU (the plain versions)'
        )
    return torch.device("cuda")
