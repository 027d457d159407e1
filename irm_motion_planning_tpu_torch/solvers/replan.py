"""Receding-horizon replanning with warm starts under a per-tick budget
(counterpart of irm_motion_planning_tpu/solvers/replan.py).

The reference replans one scene at 50 Hz on a CPU by keeping the
environment a runtime input (ref: README.md:25-26, blog-post.html:232).
Here:

* obstacles, start and goal change every tick; nothing is rebuilt (the
  kernel library is built once, at the first tick that launches one);
* each tick warm-starts from the previous tick's alpha (the smoothstep fit
  on the first tick and after :meth:`Replanner.reset`);
* each tick solves under capped horizons (``budget_outer`` rounds of at
  most ``budget_inner`` steps), trading optimality for a bounded tick;
* a fleet of arms replans in one call (``batched=True``).

Engines: ``"vmap"`` (solvers/batched.py, lane by lane; for one scene the
single-scene solver), ``"sequential"`` (the single-scene solver) and
``"fleet"`` (solvers/fleet.py on ``backend`` ``"xla"``, ``"pallas"`` or
``"fused"``; one scene is padded to 128 identical lanes, so on the card a
tick is one launch of the whole-solve kernel K1 whose lanes all equal lane
0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import PlannerConfig
from ..models.rkhs import init_alpha, make_basis
from ..ops.scenario import Scenario, replicate_scenario
from . import batched, bls, gd
from .common import SolveResult, SolveStats
from .fleet import fleet_solve

# Lanes of the single-scene fleet path: one scene replicated to a batch.
PAD_LANES = 128


@dataclasses.dataclass
class Replanner:
    """Stateful replanning driver around the stateless solvers.

    Args:
      cfg: base planner config; its iteration caps are replaced by the
        budgets for every tick, and its per-round inner schedule dropped.
      budget_outer / budget_inner: penalty rounds and inner steps per
        round of one tick.
      solver: ``"bls"`` or ``"gd"``.
      batched: plan a leading batch of scenes per tick.
      engine, backend: see the module docstring.
      device: where the basis lives (the card by default; ``"cpu"`` for the
        plain versions).

    After a single-scene tick on the fleet engine, ``last_padded`` holds
    the whole padded result (every lane equal to lane 0).
    """

    cfg: PlannerConfig
    budget_outer: int = 2
    budget_inner: int = 25
    solver: str = "bls"
    batched: bool = False
    engine: str = "vmap"
    backend: str = "xla"
    device: Optional[str] = None

    def __post_init__(self):
        if self.engine not in ("vmap", "fleet", "sequential"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.backend not in ("xla", "pallas", "fused"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.solver not in ("bls", "gd"):
            raise ValueError(f"unknown solver {self.solver!r}")
        # The tick budgets REPLACE any per-round inner schedule: a schedule
        # sized for the base config's rounds would not fit budget_outer.
        self.tick_cfg = self.cfg.replace(
            max_outer_iteration=min(self.budget_outer,
                                    self.cfg.max_outer_iteration),
            max_inner_iteration=self.budget_inner,
            inner_schedule=None,
        )
        self.basis = make_basis(self.tick_cfg, device=self.device)
        self._alpha: Optional[torch.Tensor] = None

    def _init(self, scn: Scenario) -> torch.Tensor:
        return init_alpha(self.tick_cfg, self.basis, scn.start, scn.goal)

    def _solve(self, scn: Scenario, alpha0: torch.Tensor) -> SolveResult:
        cfg, basis = self.tick_cfg, self.basis
        if self.batched:
            if self.engine == "fleet":
                return fleet_solve(cfg, basis, scn, alpha0,
                                   solver=self.solver, backend=self.backend)
            return batched.solve_batch(cfg, basis, scn, alpha0,
                                       solver=self.solver)
        if self.engine == "fleet":
            # One scene on the fleet engine, padded to PAD_LANES identical
            # lanes: one kernel launch, lane 0 the answer.
            res = fleet_solve(
                cfg, basis, replicate_scenario(scn, PAD_LANES),
                alpha0.expand((PAD_LANES,) + alpha0.shape),
                solver=self.solver, backend=self.backend)
            self.last_padded = res
            return SolveResult(res.alpha[0],
                               SolveStats(*(x[0] for x in res.stats)))
        solve = bls.solve if self.solver == "bls" else gd.solve
        return solve(cfg, basis, scn, alpha0)

    def reset(self) -> None:
        """Drop the warm start (the next tick refits the smoothstep init)."""
        self._alpha = None

    def plan(self, scn: Scenario) -> SolveResult:
        """One tick: solve ``scn`` warm-started from the previous tick's
        solution (the smoothstep fit on the first tick or after reset)."""
        alpha0 = self._alpha if self._alpha is not None else self._init(scn)
        result = self._solve(scn, alpha0)
        self._alpha = result.alpha
        return result

    def plan_rollout(self, scn_ticks: Scenario):
        """Replan a whole rollout: ``scn_ticks`` has a leading tick axis on
        every field ((ticks, ...) or (ticks, B, ...) when batched), the
        environment of each tick.  The ticks run on the host one after the
        other through the same calls as :meth:`plan`, the warm start staying
        on the device, so the result is the tick loop's bit for bit.
        Returns (the final alpha, the per-tick SolveStats stacked on the
        tick axis); the warm start persists for later ticks."""
        stats = []
        for k in range(scn_ticks.start.shape[0]):
            stats.append(self.plan(Scenario(*(x[k] for x in scn_ticks))).stats)
        return self._alpha, SolveStats(*(torch.stack(f) for f in zip(*stats)))
