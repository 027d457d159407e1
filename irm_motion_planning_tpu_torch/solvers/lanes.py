"""What the single-scene engines share (solvers/gd.py, solvers/bls.py):
scenes with the lanes LEADING, (B, ...), and the dual loop around a lane
engine.

The JAX package writes these engines for one scene and batches them with
``jax.vmap``, whose early-exit loops run while any lane is active and
freeze the finished ones.  Here the per-scene math runs on an explicit
leading batch axis (the cost functions of ops/costs.py take one), the loop
control stays on the host (solvers/common.py: stop once every lane is
frozen), and the freeze masks are viewed against the leading axis
(common.freeze_leading).  The basis products run per lane
(models/lanes.py), so a lane of a batch gives the bits of its solve alone,
and a single scene is a batch of one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import PlannerConfig
from ..models.rkhs import Basis, init_alpha
from ..ops.costs import Penalty, constraints_fulfilled
from ..ops.scenario import Scenario
from .common import SolveResult, SolveStats, freeze_leading, run_dual_loop


def lanes_of(x: torch.Tensor, dims: int) -> torch.Tensor:
    """A (B,) per-lane value viewed against (B, ...) with ``dims`` more
    axes."""
    return x.reshape(x.shape + (1,) * dims)


def solve_lanes(cfg: PlannerConfig, basis: Basis, scns: Scenario,
                alpha0: Optional[torch.Tensor],
                make_inner: Callable) -> SolveResult:
    """The penalty-method solve of every lane of ``scns`` (leading batch)
    from ``alpha0`` (B, T, J), or from the smoothstep fit
    (rkhs.init_alpha), with the inner minimizer ``make_inner(cfg, basis,
    scns)``."""
    if alpha0 is None:
        alpha0 = init_alpha(cfg, basis, scns.start, scns.goal)
    B = alpha0.shape[0]
    dev = alpha0.device
    penalty0 = Penalty(
        torch.full((B,), cfg.lambda_sg_constraint, dtype=torch.float32,
                   device=dev),
        torch.full((B,), cfg.lambda_jl_constraint, dtype=torch.float32,
                   device=dev),
    )
    return run_dual_loop(
        cfg, alpha0, make_inner(cfg, basis, scns),
        constraints_fn=lambda a: constraints_fulfilled(cfg, basis, scns, a),
        penalty0=penalty0, freeze=freeze_leading,
    )


def solve_one(cfg: PlannerConfig, basis: Basis, scn: Scenario,
              alpha0: Optional[torch.Tensor], make_inner: Callable
              ) -> SolveResult:
    """:func:`solve_lanes` of one scene (unbatched fields, alpha (T, J)) as
    a batch of one; scalar stats."""
    res = solve_lanes(cfg, basis, Scenario(*(x[None] for x in scn)),
                      None if alpha0 is None else alpha0[None], make_inner)
    return SolveResult(res.alpha[0], SolveStats(*(x[0] for x in res.stats)))
