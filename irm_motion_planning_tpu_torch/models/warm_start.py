"""The smoothstep warm start, ``solve(km, line @ mix_inv)``, with the JAX
package's bits on every device.

The Gram matrix ``km`` is conditioned near 1e15, so the warm start moves by
O(1) with any change in rounding: another LU, another order of the two
triangular solves, even one rounding more in the right-hand side.  JAX's
``init_alpha``, jitted on the CPU, is LAPACK's getrf for the factors and
BLAS's strsm (OpenBLAS, through scipy) for the two triangular solves, on
a right-hand side that XLA's CPU compiler forms with fused multiply-adds.
This module writes that arithmetic out as plain tensor operations, with no
LAPACK, cuSOLVER or BLAS solve, so the CPU and the card give the same
bits:

* the factors (:class:`Factors`, from a packed LU): JAX's own for the
  committed exports (``lu``, ``lu_perm`` in ``data/basis_T{T}_J{J}.npz``),
  scipy's ``lu_factor`` (the same getrf) of a built basis's ``km``
  (:func:`lu_factors`); models/rkhs.py keeps them per config and device;
* the right-hand side (:func:`rhs`): ``line = start + (goal - start) c``
  and its product with ``mix_inv`` as XLA's CPU code rounds them: one
  fused multiply-add per term (the product's terms in order of k from
  zero: measured at J = 1-40, 48, 64, 96 and 128, T = 24-449; at J = 256,
  T <= 50 XLA takes another order, not reproduced), except that at J = 3
  and 7 the last joint's line is a product and a sum rounded apart on the
  timesteps of XLA's vector loop (:func:`line_fused`);
* the solves: OpenBLAS's blocked order (:func:`forward`, :func:`backward`):
  panels of 448 rows, blocks of 16 rows, each block first subtracting the
  fused multiply-add chain over the rows solved before it (a GEMM micro
  kernel's accumulation), then substituting column by column inside the
  block with one fused multiply-add per entry, the diagonal applied as a
  product with its float32 reciprocal.

Every value is float32; each fused multiply-add is :func:`.xla_order.fma_`
(one ``addcmul`` from float64 factors, one launch per step).
tests/test_torch_warm_start.py holds the whole against JAX's jitted
``init_alpha`` bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .xla_order import VECTOR, fma_

# OpenBLAS's SkylakeX strsm: GEMM_Q rows per panel, GEMM_UNROLL_M rows per
# block (measured against scipy's strsm on this order, T = 50-1,400).
PANEL = 448
BLOCK = 16


class Factors(NamedTuple):
    """``km``'s LU factors on one device: ``lower`` the unit lower factor's
    multipliers with the sign of each entry's update in :func:`forward`
    (negative inside the diagonal block) and ``upper`` the upper factor,
    both float64 holding float32 values (the multiply-adds' operands);
    ``inv_diag`` the float32 reciprocals of the upper factor's diagonal;
    ``perm`` the row permutation (``P km = L U``)."""

    lower: torch.Tensor
    upper: torch.Tensor
    inv_diag: torch.Tensor
    perm: torch.Tensor


def _forward_blocks(p0: int, p1: int):
    """The row blocks of a forward panel [p0, p1), top down: whole blocks,
    then the remainder in halving pieces (OpenBLAS's trsm_kernel_LT)."""
    out, r = [], p0
    while r + BLOCK <= p1:
        out.append((r, r + BLOCK))
        r += BLOCK
    size = BLOCK >> 1
    while size:
        if (p1 - r) & size:
            out.append((r, r + size))
            r += size
        size >>= 1
    return out


def _backward_blocks(p0: int, p1: int):
    """The row blocks of a backward panel [p0, p1), bottom up: the
    remainder's pieces at the panel's foot in growing sizes, then whole
    blocks (OpenBLAS's trsm_kernel_LN)."""
    m, out, size = p1 - p0, [], 1
    while size < BLOCK:
        if m & size:
            top = p0 + (m & ~(size - 1)) - size
            out.append((top, top + size))
        size <<= 1
    top = p0 + (m & ~(BLOCK - 1)) - BLOCK
    while top >= p0:
        out.append((top, top + BLOCK))
        top -= BLOCK
    return out


def factors_from_lu(lu: np.ndarray, perm: np.ndarray, device) -> Factors:
    """:class:`Factors` on ``device`` from a packed float32 LU (getrf's
    layout) and its row permutation."""
    lu = np.asarray(lu, np.float32)
    n = lu.shape[0]
    lower = np.tril(lu, -1).astype(np.float64)
    block_of = np.empty(n, np.int64)
    for p0 in range(0, n, PANEL):
        for r0, r1 in _forward_blocks(p0, min(n, p0 + PANEL)):
            block_of[r0:r1] = r0
    lower[block_of[:, None] == block_of[None, :]] *= -1.0
    upper = np.triu(lu).astype(np.float64)
    inv_diag = np.float32(1) / np.diag(lu)
    return Factors(torch.tensor(lower, device=device),
                   torch.tensor(upper, device=device),
                   torch.tensor(inv_diag, device=device),
                   torch.tensor(np.asarray(perm, np.int64), device=device))


def lu_factors(km: np.ndarray):
    """getrf of float32 ``km`` as scipy's ``lu_factor`` runs it (the
    routine JAX's ``lu`` calls on the CPU): the packed factors and the row
    permutation that the pivots apply."""
    from scipy.linalg import lu_factor

    lu, piv = lu_factor(np.asarray(km, np.float32), check_finite=False)
    perm = np.arange(lu.shape[0])
    for i, p in enumerate(piv):
        perm[[i, p]] = perm[[p, i]]
    return lu, perm


def forward(f: Factors, b: torch.Tensor) -> torch.Tensor:
    """``L^-1 b`` for the unit lower factor, ``b`` (T, N) float32, in
    OpenBLAS's order: each block's rows start from the right-hand side
    minus the fused multiply-add chain over the rows solved before them in
    the panel (accumulated in ``w``), then substitute inside the block
    (``w`` holds their partial sums, and a row's is its unknown once the
    rows above it are done); rows past a panel take the chain over its
    rows off their right-hand side when it ends."""
    T = b.shape[0]
    rhs = b.clone()
    w = torch.zeros_like(b)
    for p0 in range(0, T, PANEL):
        p1 = min(T, p0 + PANEL)
        for r0, r1 in _forward_blocks(p0, p1):
            torch.sub(rhs[r0:r1], w[r0:r1], out=w[r0:r1])
            for i in range(r0, min(r1, T - 1)):
                fma_(w[i + 1:], f.lower[i + 1:, i, None], w[i])
        if p1 < T:
            rhs[p1:] -= w[p1:]
            w[p1:] = 0.0
    return w


def backward(f: Factors, y: torch.Tensor) -> torch.Tensor:
    """``U^-1 y`` for the upper factor in OpenBLAS's order: panels and
    blocks from the bottom; a block's rows start from their right-hand
    side minus the fused multiply-add chain over the panel's rows below
    it, in increasing row order, then substitute upward inside the block,
    each unknown its partial sum times the reciprocal of its diagonal; rows
    above a panel take the chain over its rows off their right-hand side
    when it ends."""
    T = y.shape[0]
    x = torch.empty_like(y)
    rhs = y.clone()
    for p1 in range(T, 0, -PANEL):
        p0 = max(0, p1 - PANEL)
        for r0, r1 in _backward_blocks(p0, p1):
            w = rhs[r0:r1].clone()
            if r1 < p1:
                acc = torch.zeros_like(w)
                for k in range(r1, p1):
                    fma_(acc, f.upper[r0:r1, k, None], x[k])
                w -= acc
            for i in range(r1 - 1, r0 - 1, -1):
                torch.mul(w[i - r0], f.inv_diag[i], out=x[i])
                if i > r0:
                    fma_(w[:i - r0], f.upper[r0:i, i, None], x[i], -1)
        if p0 > 0:
            acc = torch.zeros_like(rhs[:p0])
            for k in range(p0, p1):
                fma_(acc, f.upper[:p0, k, None], x[k])
            rhs[:p0] -= acc
    return x


def line_fused(T: int, J: int, device) -> torch.Tensor:
    """(T, J) bool: where XLA's CPU code forms the warm-start line
    ``start + (goal - start) c`` with one fused multiply-add (True) and
    where with a product and a sum rounded apart (False).  Measured against
    the line jitted alone and JAX's jitted ``init_alpha``: fused everywhere
    but at J = 3 and 7, whose last joint is rounded apart on the timesteps
    of the vector loop: the first ``8 (T // 8)`` from T = 32, the first
    ``4 (T // 4)`` at T = 16-31, none below (J = 3 at T = 8-459, J = 7 at
    T = 8-259); fused everywhere at every other J of 1-40, 48, 64, 96, 128
    and 256 (T = 50 and 200)."""
    fused = torch.ones(T, J, dtype=torch.bool, device=device)
    if J in (3, 7) and T >= 2 * VECTOR:
        width = VECTOR if T >= 4 * VECTOR else VECTOR // 2
        fused[:width * (T // width), J - 1] = False
    return fused


def rhs(start: torch.Tensor, goal: torch.Tensor, c: torch.Tensor,
        mix_inv: torch.Tensor) -> torch.Tensor:
    """``line @ mix_inv`` (..., T, J) as XLA's CPU code rounds it."""
    T, J = c.shape[0], mix_inv.shape[0]
    s = start[..., None, :]
    d = (goal - start)[..., None, :]
    c = c[:, None]
    line = torch.where(line_fused(T, J, start.device),
                       fma_(s.expand(d.shape[:-2] + (T, J)).clone(),
                            d.double(), c),
                       s + d * c)
    m = mix_inv.double()
    acc = torch.zeros_like(line)
    for k in range(J):
        fma_(acc, line[..., k, None], m[k])
    return acc


def init_alpha(f: Factors, basis, start: torch.Tensor,
               goal: torch.Tensor) -> torch.Tensor:
    """The warm start ``solve(km, line @ mix_inv)`` of every leading index
    of ``start``/``goal`` (..., J) -> (..., T, J) float32 with ``km``'s
    factors ``f``, JAX's jitted ``init_alpha``'s bits on any device."""
    b = rhs(start, goal, basis.c, basis.mix_inv)
    T, J = b.shape[-2:]
    lead = b.shape[:-2]
    cols = b.movedim(-2, 0).reshape(T, -1)[f.perm]
    x = backward(f, forward(f, cols))
    return x.reshape((T,) + lead + (J,)).movedim(0, -2)
