"""Products that give a lane of a batch the bits of the lane alone."""

from __future__ import annotations

import torch


def lane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``a`` (..., m, k) and a matrix ``b`` (k, n).  With
    leading axes on ``a`` the product runs as one batched product of the
    same (m, k) x (k, n) shape per lane, whose bits do not depend on how
    many lanes there are; ``a @ b`` would fold the lanes into the rows of
    one product, whose blocking (and so the bits of a row) does.  ``a`` is
    made contiguous: on the CPU a batched product of strided operands took
    another path at one lane than at two, with other bits."""
    if a.dim() == 2:
        return a @ b
    return torch.matmul(a.contiguous(), b.expand(a.shape[:-2] + b.shape))


def basis_matmul(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` for a matrix ``m`` (the basis) and ``x`` (..., k, n), one
    product per lane; ``x`` made contiguous as in :func:`lane_matmul`."""
    return m @ x.contiguous()
