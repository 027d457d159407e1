"""The batched single-scene engine: many scenes solved lane by lane
(counterpart of irm_motion_planning_tpu/solvers/batched.py, the JAX
package's ``vmap`` engine).

Every Scenario field carries a leading batch axis.  The per-scene math runs
on that axis (solvers/lanes.py) and the early-exit loops run on the host
until every lane is frozen, with per-lane freeze masks, so each lane's
result equals its solve alone (a batch of one), bit for bit
(tests/test_torch_solvers.py).
For throughput the fleet engine (solvers/fleet.py, lanes trailing, the
kernels) is the one to use.

The basis products are one torch product per lane here (:data:`ORDER`),
not the single-scene solvers' XLA order (models/xla_order.py): JAX's
``vmap`` engine batches them into products of other shapes, which XLA's
CPU code rounds in other orders, so XLA's single-scene order would not
give its bits; and on an H100 it ran this engine's 65,536 random scenes
at 1,381.5 solves/s against 3,272.8 with torch's products
(tools/single_scene_timing.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PlannerConfig
from ..models.rkhs import Basis
from ..ops.scenario import Scenario
from . import bls as _bls
from . import gd as _gd
from .common import SolveResult
from .lanes import solve_lanes

_INNER = {"bls": _bls.make_inner, "gd": _gd.make_inner}
# The basis products' rounding (models/rkhs.py PRODUCTS).
ORDER = "matmul"


def solve_batch(cfg: PlannerConfig, basis: Basis, scenarios: Scenario,
                alpha0: Optional[torch.Tensor] = None,
                solver: str = "bls") -> SolveResult:
    """Solve a batch of scenes (leading batch on every Scenario field);
    ``alpha0`` an optional (B, T, J) warm start, else each lane's smoothstep
    fit.  Returns a SolveResult with the same leading axis on every
    field."""
    if solver not in _INNER:
        raise ValueError(f"unknown solver {solver!r}")
    return solve_lanes(cfg, basis, scenarios, alpha0, _INNER[solver], ORDER)


def make_batched_solver(cfg: PlannerConfig, basis: Basis, solver: str = "bls"):
    """A solver bound to (cfg, basis): leading-batch Scenario ->
    SolveResult."""

    def run(scenarios: Scenario) -> SolveResult:
        return solve_batch(cfg, basis, scenarios, solver=solver)

    return run


def batch_summary(result: SolveResult) -> dict:
    """Fleet-level convergence statistics (reductions on the device)."""
    stats = result.stats
    return {
        "n": stats.converged.shape[0],
        "converged_fraction": stats.converged.float().mean(),
        "mean_inner_iters": stats.inner_iters.float().mean(),
        "mean_final_cost": stats.final_cost.mean(),
        "max_final_cost": stats.final_cost.max(),
    }
