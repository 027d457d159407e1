"""Results in the reference's file formats (counterpart of
irm_motion_planning_tpu/utils/io.py; ref: main.py:145-153):

* ``trajectory_result.txt``: the trajectory, (T, J) floats, np.savetxt;
* ``trajectory_series.txt``: per-iteration trajectories flattened to (n,
  T*J), np.savetxt;
* the solve npz: alpha and the stats under the JAX package's keys.

The files are written from float32 numpy arrays exactly as the JAX package
writes them, so either package reads the other's (tests/test_torch_cli.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import PlannerConfig
from ..models.rkhs import Basis, evaluate
from ..solvers.common import SolveResult, SolveStats


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_trajectory_result(path: str, cfg: PlannerConfig, basis: Basis,
                           alpha: torch.Tensor) -> np.ndarray:
    """Write the (T, J) trajectory of alpha in the reference's format."""
    arr = _np(evaluate(cfg, basis, alpha)[0])
    np.savetxt(path, arr)
    return arr


def load_trajectory_result(path: str) -> np.ndarray:
    return np.loadtxt(path)


def save_trajectory_series(path: str, cfg: PlannerConfig, basis: Basis,
                           alphas: Sequence[torch.Tensor]) -> np.ndarray:
    """Write the trajectories of ``alphas``, (n, T*J) flattened."""
    trajs = [_np(evaluate(cfg, basis, a)[0]) for a in alphas]
    arr = np.stack(trajs).reshape(len(trajs), -1)
    np.savetxt(path, arr)
    return arr


def save_series(path: str, series: Sequence[np.ndarray]) -> np.ndarray:
    """Write recorded trajectories (plain.plain_solve's series), (n, T*J)."""
    arr = np.stack(series).reshape(len(series), -1)
    np.savetxt(path, arr)
    return arr


def load_trajectory_series(path: str, cfg: PlannerConfig) -> np.ndarray:
    """Returns (n_iters, T, J)."""
    flat = np.loadtxt(path)
    if flat.ndim == 1:
        flat = flat[None]
    return flat.reshape(flat.shape[0], cfg.n_timesteps, cfg.n_joints)


def save_solve_npz(path: str, result: SolveResult) -> None:
    """alpha and the stats, one scene or a batch."""
    np.savez(
        path,
        alpha=_np(result.alpha),
        outer_iters=_np(result.stats.outer_iters),
        inner_iters=_np(result.stats.inner_iters),
        converged=_np(result.stats.converged),
        final_cost=_np(result.stats.final_cost),
    )


def load_solve_npz(path: str, device=None) -> SolveResult:
    """The SolveResult of a solve npz as tensors on ``device`` (the CPU by
    default)."""
    with np.load(path) as data:
        t = {k: torch.as_tensor(data[k], device=device) for k in data.files}
    return SolveResult(
        alpha=t["alpha"],
        stats=SolveStats(t["outer_iters"], t["inner_iters"], t["converged"],
                         t["final_cost"]),
    )
