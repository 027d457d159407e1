"""RKHS trajectory parametrization: the basis and its evaluation.

``traj = K @ alpha @ M`` with ``K`` the RBF Gram matrix over the T support
timesteps, ``alpha`` the (T, J) coefficients and ``M`` the (J, J) mixing
matrix; velocities come from the derivative Gram matrix.  The stacked
operator ``kv = [K; K']`` (2T, T) gives both in one product.

Where the basis comes from (``make_basis``).  The JAX package's basis of
the default config at T = 25, 50, 100, 150 and 200 (J = 3) is committed as
``irm_motion_planning_tpu_torch/data/basis_T{T}_J{J}.npz``
(``tools/export_torch_basis.py``); ``make_basis`` loads it when an export
matches every field of ``BASIS_KEYS``, so those configs run on JAX's bits.
Every other config is built here by ``build_basis``, op for op as the JAX
package's make_basis in float32, with ``mix`` drawn by a numpy port of
JAX's PRNG (``threefry``) and the warm-start coefficients ``init_u`` /
``init_w`` from a float32 LU with partial pivoting written out pivot by
pivot (no BLAS, no LAPACK).  The Gram matrix has condition number ~1e15,
so another LU path would move ``init_u``/``init_w`` by O(1); this one is
plain IEEE float32 arithmetic, each product and difference rounded once,
so one config gives the same bits on every machine (the CPU here and the
card's host).  The float32 solve is the implicit regularisation JAX's
make_basis relies on (a float64 fit gives huge-norm coefficients whose
float32 evaluation is garbage); the built basis fits the warm-start line
as well as JAX's (tests/test_torch_basis_build.py).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import PlannerConfig
from ..device import resolve
from . import threefry
from .lanes import basis_matmul, lane_matmul

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
# Config fields the basis depends on; the export records them.
BASIS_KEYS = ("n_timesteps", "rbf_variance", "mix_scale", "mix_seed", "n_joints")


def rbf_kernel(x1, x2, rbf_var: float) -> np.ndarray:
    """The Gaussian RBF kernel of float32 numpy arrays (ref:
    trajectory.py:14-15; JAX's models/rkhs.py ``rbf_kernel``):
    ``exp(-(x1 - x2)^2 / (2 rbf_var^2))`` in float32, ``rbf_var`` a Python
    float (weak-typed, as JAX's note asks) and the exponential correctly
    rounded (XLA's may differ by an ulp)."""
    d = np.asarray(x1, np.float32) - np.asarray(x2, np.float32)
    arg = -(d * d) / np.float32(2 * rbf_var**2)
    return np.exp(arg.astype(np.float64)).astype(np.float32)


def d_rbf_kernel(x1, x2, rbf_var: float) -> np.ndarray:
    """d/dx1 of :func:`rbf_kernel` (ref: trajectory.py:18-19):
    ``(x1 - x2) / rbf_var^2 * rbf_kernel(x1, x2, rbf_var)`` in float32."""
    d = np.asarray(x1, np.float32) - np.asarray(x2, np.float32)
    return (d / np.float32(rbf_var**2)) * rbf_kernel(x1, x2, rbf_var)


class Basis(NamedTuple):
    """The RKHS basis as fp32 tensors (see irm_motion_planning_tpu's Basis).

    t, c: (T,); km, dkm: (T, T); kv: (2T, T); mix, mix_inv: (J, J);
    init_u = km^-1 1 and init_w = km^-1 c: (T,)."""

    t: torch.Tensor
    c: torch.Tensor
    km: torch.Tensor
    dkm: torch.Tensor
    kv: torch.Tensor
    mix: torch.Tensor
    mix_inv: torch.Tensor
    init_u: torch.Tensor
    init_w: torch.Tensor

    def to(self, device) -> "Basis":
        return Basis(*(x.to(device) for x in self))


def basis_from_numpy(arrays, device=None) -> Basis:
    """Build a Basis from numpy arrays keyed by the Basis field names (for
    example the JAX package's basis converted with ``np.asarray``), on
    ``device``: the card by default (``device="cpu"`` for the CPU)."""
    device = resolve(device)
    return Basis(*(
        torch.tensor(np.asarray(arrays[name], dtype=np.float32),
                     device=device)
        for name in Basis._fields
    ))


def export_path(cfg: PlannerConfig) -> str:
    return os.path.join(
        _DATA_DIR, f"basis_T{cfg.n_timesteps}_J{cfg.n_joints}.npz"
    )


def _export(cfg: PlannerConfig):
    """The committed export's arrays when one matches every field of
    BASIS_KEYS, else None."""
    path = export_path(cfg)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if any(data[k].item() != getattr(cfg, k) for k in BASIS_KEYS):
            return None
        return {name: data[name] for name in Basis._fields}


def make_basis(cfg: PlannerConfig, device=None) -> Basis:
    """The RKHS basis of ``cfg`` on ``device``: the card by default
    (``device="cpu"`` for the CPU; without a CUDA device and without
    ``device`` it raises RuntimeError).  The committed export where one
    matches every field of BASIS_KEYS (JAX's own bits), else
    :func:`build_basis`."""
    device = resolve(device)
    arrays = _export(cfg)
    if arrays is None:
        return build_basis(cfg, device=device)
    return basis_from_numpy(arrays, device=device)


def _lu_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 b`` for float32 ``a`` (n, n) and ``b`` (n, k) on the CPU: LU
    with partial pivoting (the first row of the largest magnitude, as
    LAPACK's getrf picks it), one pivot at a time: the column of
    multipliers by division, then the trailing rows minus multiplier times
    pivot row, the product and the difference each rounded once; then the
    two triangular solves column by column.  Plain IEEE float32 operations
    only, so the bits depend on nothing but the inputs."""
    a = a.clone()
    b = b.clone()
    n = a.shape[0]
    for k in range(n):
        p = k + int(torch.argmax(a[k:, k].abs()))
        if p != k:
            a[[k, p]] = a[[p, k]]
            b[[k, p]] = b[[p, k]]
        mult = a[k + 1:, k] / a[k, k]
        a[k + 1:, k] = mult
        a[k + 1:, k + 1:] -= mult[:, None] * a[k, k + 1:][None, :]
    for j in range(n - 1):                      # L y = P b (unit diagonal)
        b[j + 1:] -= a[j + 1:, j, None] * b[j][None, :]
    for j in range(n - 1, -1, -1):              # U x = y
        b[j] = b[j] / a[j, j]
        b[:j] -= a[:j, j, None] * b[j][None, :]
    return b


_BUILT: dict = {}


def build_basis(cfg: PlannerConfig, device=None) -> Basis:
    """Build the basis of ``cfg`` on the CPU, op for op as the JAX package's
    make_basis (irm_motion_planning_tpu/models/rkhs.py) in float32, then
    move it to ``device`` (the card by default; ``device="cpu"`` for the
    CPU).

    ``t``: i (1 / (T - 1)) (JAX's linspace as XLA compiles it); ``c``,
    ``km``, ``dkm``, ``kv``: the same float32 operations in the same order
    (:func:`rbf_kernel`, :func:`d_rbf_kernel`); ``mix = I + mix_scale *
    normal(PRNGKey(mix_seed), (J, J))`` (:mod:`threefry`); ``mix_inv`` and
    ``init_u``/``init_w`` = ``km^-1 [1, c]`` by :func:`_lu_solve`.  The
    same config gives the same bits on any machine.  One build per config
    per process."""
    device = resolve(device)
    key = tuple(getattr(cfg, k) for k in BASIS_KEYS)
    if key not in _BUILT:
        _BUILT[key] = _build(cfg)
    return Basis(*(x.to(device) for x in _BUILT[key]))


def _build(cfg: PlannerConfig) -> Basis:
    f32 = np.float32
    T, J = cfg.n_timesteps, cfg.n_joints
    # JAX's linspace: i * (1 / (T - 1)) (XLA turns the division by the
    # constant into a product with its reciprocal), the last point 1.
    t = (np.arange(T, dtype=f32) * (f32(1) / f32(max(T - 1, 1)))).astype(f32)
    if T > 1:
        t[-1] = f32(1.0)
    t2 = t * t
    t4 = t2 * t2
    c = (f32(6) * (t * t4) - f32(15) * t4) + f32(10) * (t * t2)
    # km[i, j] = k(t_j, t_i), as JAX's meshgrid semantics.
    km = rbf_kernel(t[None, :], t[:, None], cfg.rbf_variance)
    dkm = d_rbf_kernel(t[None, :], t[:, None], cfg.rbf_variance)
    kv = np.concatenate((km, dkm), axis=0)
    mix = np.eye(J, dtype=f32) + f32(cfg.mix_scale) * threefry.normal(
        cfg.mix_seed, (J, J))
    tm = torch.from_numpy(mix)
    mix_inv = _lu_solve(tm, torch.eye(J, dtype=torch.float32))
    uw = _lu_solve(torch.from_numpy(km),
                   torch.from_numpy(np.stack([np.ones_like(c), c], axis=1)))
    out = [torch.from_numpy(np.ascontiguousarray(x))
           for x in (t, c, km, dkm, kv)]
    return Basis(*out, tm, mix_inv, uw[:, 0].contiguous(),
                 uw[:, 1].contiguous())


def evaluate(cfg: PlannerConfig, basis: Basis,
             alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trajectory and velocity at the support timesteps, ``(kv @ alpha) @
    mix`` left-associated like the reference.  alpha (..., T, J) -> two
    (..., T, J)."""
    both = lane_matmul(basis_matmul(basis.kv, alpha), basis.mix)
    T = cfg.n_timesteps
    return both[..., :T, :], both[..., T:, :]


def evaluate_position(cfg: PlannerConfig, basis: Basis,
                      alpha: torch.Tensor) -> torch.Tensor:
    """Trajectory positions only, ``(km @ alpha) @ mix``: (..., T, J)."""
    return lane_matmul(basis_matmul(basis.km, alpha), basis.mix)


def evaluate_at(cfg: PlannerConfig, basis: Basis, alpha: torch.Tensor,
                ts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trajectory and its velocity at arbitrary query times ``ts``
    (Q,) in [0, 1]: the cross Gram matrix between the query and support
    times applied to the same coefficients (the reference's ``eval_any``,
    ref: trajectory.py:68-70).  alpha (T, J) -> two (Q, J)."""
    var = cfg.rbf_variance
    diff = basis.t[None, :] - ts[:, None]          # t_support - t_query
    kq = torch.exp(-(diff ** 2) / (2 * var ** 2))
    dkq = diff / (var ** 2) * kq
    return (lane_matmul(kq @ alpha, basis.mix),
            lane_matmul(dkq @ alpha, basis.mix))


def init_alpha(cfg: PlannerConfig, basis: Basis, start: torch.Tensor,
               goal: torch.Tensor) -> torch.Tensor:
    """Warm-start coefficients: the least-squares fit of the quintic
    smoothstep line from start to goal (ref: trajectory.py:73-78), ``solve(
    km, line @ mix_inv)``, as the JAX package writes it.  start, goal
    (..., J) -> alpha (..., T, J).

    The Gram matrix is conditioned near 1e15, so alpha depends on the
    factorization (LAPACK's LU on the CPU, cuSOLVER's on the card) by far
    more than rounding; the trajectory it evaluates to stays on the line
    (tests/test_torch_grads.py holds the fit against JAX's)."""
    line = start[..., None, :] + (goal - start)[..., None, :] * basis.c[:, None]
    return torch.linalg.solve(basis.km, lane_matmul(line, basis.mix_inv))
