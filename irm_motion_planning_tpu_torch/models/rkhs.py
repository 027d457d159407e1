"""RKHS trajectory parametrization: the basis and its evaluation.

``traj = K @ alpha @ M`` with ``K`` the RBF Gram matrix over the T support
timesteps, ``alpha`` the (T, J) coefficients and ``M`` the (J, J) mixing
matrix; velocities come from the derivative Gram matrix.  The stacked
operator ``kv = [K; K']`` (2T, T) gives both in one product.

The basis is NOT rebuilt in torch.  The Gram matrix has condition number
~1e15, so a different ``linspace``, exp or LU path moves the warm-start
coefficients ``init_u``/``init_w`` by O(1), and ``mix`` is a draw from JAX's
PRNG.  The basis of the default config at T = 25, 50, 100, 150 and 200 (the
sizes of benchmarks/problemsize.py) is exported from the JAX package by
``tools/export_torch_basis.py --sizes ...`` and committed as
``irm_motion_planning_tpu_torch/data/basis_T{T}_J{J}.npz``; ``make_basis``
loads it and refuses any config it was not exported for.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import PlannerConfig
from ..device import resolve

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
EXPORT_SCRIPT = "tools/export_torch_basis.py"
# Config fields the basis depends on; the export records them.
BASIS_KEYS = ("n_timesteps", "rbf_variance", "mix_scale", "mix_seed", "n_joints")


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


def make_basis(cfg: PlannerConfig, device=None) -> Basis:
    """Load the committed basis export for ``cfg`` onto ``device``: the
    card by default (``device="cpu"`` for the CPU; without a CUDA device
    and without ``device`` it raises RuntimeError).

    Raises ValueError when no export matches the config's basis fields;
    run ``python tools/export_torch_basis.py --sizes T`` to export one."""
    device = resolve(device)
    path = export_path(cfg)
    want = {k: getattr(cfg, k) for k in BASIS_KEYS}
    if not os.path.exists(path):
        raise ValueError(
            f"no basis export for {want} ({path} missing); export it with "
            f"`python {EXPORT_SCRIPT} --sizes {cfg.n_timesteps}`"
        )
    with np.load(path) as data:
        have = {k: data[k].item() for k in BASIS_KEYS}
        if have != want:
            raise ValueError(
                f"basis export {path} was made for {have}, not {want}; "
                f"export a matching one with `python {EXPORT_SCRIPT}` (the "
                f"default config's fields at each T of --sizes)"
            )
        return basis_from_numpy(data, device=device)


def evaluate(cfg: PlannerConfig, basis: Basis,
             alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trajectory and velocity at the support timesteps, ``(kv @ alpha) @
    mix`` left-associated like the reference.  alpha (T, J) -> two (T, J)."""
    both = (basis.kv @ alpha) @ basis.mix
    return both[: cfg.n_timesteps], both[cfg.n_timesteps:]
