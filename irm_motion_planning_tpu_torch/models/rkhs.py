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
package's make_basis in float32, to its bits: ``exp`` as XLA's CPU code
computes it (``xla_order.exp``), ``mix`` drawn by a numpy port of JAX's
PRNG (``threefry``), and ``mix_inv`` and the warm-start coefficients
``init_u`` / ``init_w`` solved as ``jnp.linalg.solve`` solves them on the
CPU: LAPACK's getrf for the factors (scipy's, the routine JAX calls; the
card's host gives the same, chip_smoke.py phase 21 holds the digest) and
OpenBLAS strsm's order for the two triangular solves, written out in plain
float32 operations (``warm_start.forward``/``backward``).  The Gram matrix
has condition number ~1e15, so any other exp or LU path moves
``init_u``/``init_w`` by O(1) and, at T = 2,200, leaves warm starts from
which the solver converges nothing (tests/test_torch_basis_build.py holds
the build to JAX's basis bit for bit).  The float32 solve is the implicit
regularisation JAX's make_basis relies on (a float64 fit gives huge-norm
coefficients whose float32 evaluation is garbage).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import PlannerConfig
from ..device import resolve
from . import threefry, warm_start, xla_order
from .lanes import basis_matmul, lane_matmul

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
# Config fields the basis depends on; the export records them.
BASIS_KEYS = ("n_timesteps", "rbf_variance", "mix_scale", "mix_seed", "n_joints")


def rbf_kernel(x1, x2, rbf_var: float) -> np.ndarray:
    """The Gaussian RBF kernel of float32 numpy arrays (ref:
    trajectory.py:14-15; JAX's models/rkhs.py ``rbf_kernel``):
    ``exp(-(x1 - x2)^2 / (2 rbf_var^2))`` in float32, ``rbf_var`` a Python
    float (weak-typed, as JAX's note asks) and the exponential XLA's
    (``xla_order.exp``: it flushes to 0 below log(2^-126))."""
    d = np.asarray(x1, np.float32) - np.asarray(x2, np.float32)
    arg = -(d * d) / np.float32(2 * rbf_var**2)
    return xla_order.exp(torch.from_numpy(np.asarray(arg, np.float32))).numpy()


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


def _key(cfg: PlannerConfig) -> tuple:
    return tuple(getattr(cfg, k) for k in BASIS_KEYS)


def _export(cfg: PlannerConfig):
    """The committed export's arrays when one matches every field of
    BASIS_KEYS, else None: the Basis fields, and ``lu``/``lu_perm`` (JAX's
    LU factors of ``km``, for :func:`init_alpha`)."""
    path = export_path(cfg)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if any(data[k].item() != getattr(cfg, k) for k in BASIS_KEYS):
            return None
        return {name: data[name]
                for name in Basis._fields + ("lu", "lu_perm")}


# init_alpha's LU factors of km: packed on the host per config (the
# export's, or getrf's of a built basis), and as warm_start.Factors per
# config and device.
_LU: dict = {}
_FACTORS: dict = {}


def make_basis(cfg: PlannerConfig, device=None) -> Basis:
    """The RKHS basis of ``cfg`` on ``device``: the card by default
    (``device="cpu"`` for the CPU; without a CUDA device and without
    ``device`` it raises RuntimeError).  The committed export where one
    matches every field of BASIS_KEYS (JAX's own bits), else
    :func:`build_basis`.  It registers the warm start's LU factors of that
    ``km`` (:func:`init_alpha`): the export's (JAX's), else scipy's getrf
    of the built one on the host, JAX's routine."""
    device = resolve(device)
    key = _key(cfg)
    arrays = _export(cfg)
    if arrays is None:
        basis = build_basis(cfg, device=device)
        if key not in _LU:
            _LU[key] = warm_start.lu_factors(_BUILT[key].km.numpy())
        return basis
    _LU.setdefault(key, (arrays["lu"], arrays["lu_perm"]))
    return basis_from_numpy(arrays, device=device)


def _solve(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """``a^-1 b`` for float32 ``a`` (n, n) and ``b`` (n, k) as JAX's
    ``jnp.linalg.solve`` forms it on the CPU: getrf's factors, the rows of
    ``b`` permuted, then the unit lower and the upper triangular solves in
    OpenBLAS strsm's order (models/warm_start.py)."""
    f = warm_start.factors_from_lu(*warm_start.lu_factors(a), "cpu")
    rhs = torch.from_numpy(np.ascontiguousarray(b, np.float32))[f.perm]
    return warm_start.backward(f, warm_start.forward(f, rhs))


_BUILT: dict = {}


def build_basis(cfg: PlannerConfig, device=None) -> Basis:
    """Build the basis of ``cfg`` on the CPU, op for op as the JAX package's
    make_basis (irm_motion_planning_tpu/models/rkhs.py) in float32, then
    move it to ``device`` (the card by default; ``device="cpu"`` for the
    CPU).

    ``t``: i (1 / (T - 1)) (JAX's linspace as XLA compiles it); ``c``,
    ``km``, ``dkm``, ``kv``: the same float32 operations in the same order
    (:func:`rbf_kernel`, :func:`d_rbf_kernel`); ``mix = I + mix_scale *
    normal(PRNGKey(mix_seed), (J, J))`` (:mod:`threefry`); ``mix_inv`` =
    ``mix^-1 I`` and ``init_u``/``init_w`` = ``km^-1 [1, c]`` by
    :func:`_solve`.  One build per config per process."""
    device = resolve(device)
    key = _key(cfg)
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
    mix_inv = _solve(mix, np.eye(J, dtype=f32))
    uw = _solve(km, np.stack([np.ones_like(c), c], axis=1))
    out = [torch.from_numpy(np.ascontiguousarray(x))
           for x in (t, c, km, dkm, kv)]
    return Basis(*out, tm, mix_inv, uw[:, 0].contiguous(),
                 uw[:, 1].contiguous())


# How the basis products are rounded (``order``): one torch product per
# lane ("matmul"), or the JAX package's single-scene order on the CPU
# ("xla", models/xla_order.py: its bits on any device, at the cost of a
# few dozen elementwise operations per product).  Each maps to (the
# product with a basis matrix, the product with the mixing matrix).
PRODUCTS = {
    "matmul": (basis_matmul, lane_matmul),
    "xla": (xla_order.basis_product, xla_order.mix_product),
}


def evaluate(cfg: PlannerConfig, basis: Basis, alpha: torch.Tensor,
             order: str = "matmul") -> Tuple[torch.Tensor, torch.Tensor]:
    """Trajectory and velocity at the support timesteps, ``(kv @ alpha) @
    mix`` left-associated like the reference, the products rounded as
    ``order`` says (:data:`PRODUCTS`).  alpha (..., T, J) -> two
    (..., T, J)."""
    basis_product, mix_product = PRODUCTS[order]
    both = mix_product(basis_product(basis.kv, alpha), basis.mix)
    T = cfg.n_timesteps
    return both[..., :T, :], both[..., T:, :]


def evaluate_position(cfg: PlannerConfig, basis: Basis, alpha: torch.Tensor,
                      order: str = "matmul") -> torch.Tensor:
    """Trajectory positions only, ``(km @ alpha) @ mix``: (..., T, J)."""
    basis_product, mix_product = PRODUCTS[order]
    return mix_product(basis_product(basis.km, alpha), basis.mix)


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
    km, line @ mix_inv)`` as the JAX package writes it.  start, goal
    (..., J) -> alpha (..., T, J).

    The Gram matrix is conditioned near 1e15, so alpha depends on the
    factorization and on every rounding of the solve by far more than on
    the line: :mod:`.warm_start` computes it with JAX's factors and in the
    order of JAX's jitted ``init_alpha`` on the CPU, in plain tensor
    operations (no torch.linalg), so the CPU and the card give JAX's bits
    (tests/test_torch_warm_start.py).  The factors are those of
    ``make_basis(cfg)``'s ``km`` (moved to ``basis``'s device once), so
    ``basis`` is that basis."""
    device = basis.km.device
    key = _key(cfg)
    if (key, device) not in _FACTORS:
        if key not in _LU:
            make_basis(cfg, device="cpu")
        _FACTORS[key, device] = warm_start.factors_from_lu(*_LU[key], device)
    return warm_start.init_alpha(_FACTORS[key, device], basis, start, goal)
