"""The JAX package's float32 arithmetic on the CPU, written out as plain
tensor operations so that the CPU and the card give its bits.

The single-scene solvers and the warm start are chaotic in the roundings of
their basis products: the coefficients are O(1e3-1e4) and the products
cancel them to O(1), so one product rounded another way moves a solve as
much as a change of scene.  XLA's CPU code, where the JAX package's
single-scene solve runs, rounds these products in a fixed order, with fused
multiply-adds; this module reproduces that order (measured against jax
0.9's CPU backend, tests/test_torch_xla_order.py):

* :func:`basis_product`, ``m @ x`` for a basis matrix ``m`` (M, K), K >= 4
  (XLA's runtime dot): four partial sums, term k going to sum ``k mod 4``,
  each a chain of fused multiply-adds from zero over the first
  ``4 (K // 4)`` terms; the four added as ``(s0 + s1) + (s2 + s3)``; the
  last ``K mod 4`` products, each rounded, summed in order and added last;
* :func:`mix_product`, ``a @ mix`` for the J x J mixing matrix: at J = 3
  (XLA's inlined loop, 8 rows to a vector) the first two columns as
  ``(p0 + p1) + p2`` of rounded products and the third as two fused
  multiply-adds on the vector rows, every column by fused multiply-adds on
  the remaining ``M mod 8`` rows; at J <= 2, and at J = 5 up to M = 80,
  one chain of fused multiply-adds; otherwise the runtime dot's order.

A fused multiply-add of float32 values is emulated by :func:`fma_`, one
``addcmul`` with an operand in float64: the product is exact there, and the
float64 sum is rounded to float32 on the store.  Where that float64 sum is
not exact and lies on a float32 midpoint it is rounded twice, and may land
one float32 ulp from a true fused multiply-add: 1 of the 5,990,169,600
chain steps of the sequential oracle on 128 of JAX's oracle scenes, whose
converged flags all stayed JAX's (tools/warm_start_crossing.py).  An exact
emulation (the sum's error term by TwoSum, the midpoint case corrected)
took some 16 operations a step, and made one warm start at T = 50 take
33.1 ms on an H100 against 4.8 ms with this one (tools/single_scene_timing.py).
Every value between the steps is a float32 value.
"""

from __future__ import annotations

import torch

_F64 = torch.float64
# XLA's runtime dot: partial sums; its inlined loops: rows per vector.
CHAINS = 4
VECTOR = 8


def fma_(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         value: float = 1.0) -> torch.Tensor:
    """``acc += value * a * b`` in place, float32 ``acc`` and float32 values
    in ``a``, ``b`` (one of them float64, broadcasting; ``value`` +-1): the
    product in float64, exact, then the sum rounded to float32 (see the
    module docstring for the one case this rounds twice)."""
    return acc.addcmul_(a, b, value=value)


def basis_product(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` for a float32 matrix ``m`` (M, K) and ``x`` (..., K, J),
    rounded as XLA's CPU runtime dot rounds it (K >= 4; see the module
    docstring); every lane's bits are its own.  The chains run with the
    rows innermost, (chain, J, lanes, M)."""
    M, K = m.shape
    J = x.shape[-1]
    lanes = x.reshape(-1, K, J)
    L = lanes.shape[0]
    S = K // CHAINS
    mt = m.to(_F64)[:, :S * CHAINS].T.reshape(S, CHAINS, 1, 1, M)
    xt = (lanes[:, :S * CHAINS, :].to(_F64).permute(1, 2, 0)
          .reshape(S, CHAINS, J, L, 1))
    acc = torch.zeros((CHAINS, J, L, M), dtype=torch.float32, device=x.device)
    for t in range(S):
        fma_(acc, mt[t], xt[t])
    out = (acc[0] + acc[1]) + (acc[2] + acc[3])
    mk = m.T[:, None, None, :]                  # (K, 1, 1, M)
    xk = lanes.permute(1, 2, 0)[..., None]      # (K, J, L, 1)
    tail = None
    for k in range(S * CHAINS, K):
        p = mk[k] * xk[k]
        tail = p if tail is None else tail + p
    if tail is not None:
        out = out + tail
    return out.permute(1, 2, 0).reshape(x.shape[:-2] + (M, J))


def _mix_chain(a: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """``a @ mix`` as one chain of fused multiply-adds from zero."""
    a64 = a.to(_F64)
    m64 = mix.to(_F64)
    acc = torch.zeros(a.shape[:-1] + mix.shape[1:], dtype=torch.float32,
                      device=a.device)
    for k in range(mix.shape[0]):
        fma_(acc, a64[..., k, None], m64[k])
    return acc


def mix_product(a: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """``a @ mix`` for ``a`` (..., M, J) and a float32 J x J matrix, rounded
    as XLA's CPU code rounds the JAX package's product with the mixing
    matrix (or its transpose): see the module docstring."""
    M, J = a.shape[-2:]
    if J >= 4 and not (J == 5 and M <= 80):
        return basis_product(mix.T, a.transpose(-1, -2)).transpose(-1, -2)
    fused = _mix_chain(a, mix)
    if J != 3:
        return fused
    p = [a[..., k, None] * mix[k] for k in range(3)]
    plain = (p[0] + p[1]) + p[2]
    rows = torch.arange(M, device=a.device)[:, None]
    cols = torch.arange(3, device=a.device)[None, :]
    take = (cols == 2) | (rows >= VECTOR * (M // VECTOR))
    return torch.where(take, fused, plain)
