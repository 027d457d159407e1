"""Cross-backend quality-distribution gate (the port of
benchmarks/quality.py).

Per-scene outcomes depend on the floating-point path (the early-stop
threshold 1e-3 sits below the cross-engine float32 noise), so backends are
compared by distribution: the same random scenes go through each backend,
and the converged fraction and the final-cost distribution are compared.

    python -m irm_motion_planning_tpu_torch.benchmarks.quality \\
        [--batch 32768] [--backends xla,pallas,fused] [--solver bls|gd] \\
        [--schedule] [--ladder-eval linearized|exact] [--device cuda|cpu]

The verdict is benchmarks/quality.py's, against the FIRST backend: the
converged fraction within ``max(tol_conv, min(0.15 base, 0.05))`` of the
first backend's ``base``, and the mean average cost within ``tol_cost``
relative.  (bench.py's paired gate, ``bench.gate_against``, scales its band
by the larger of the two fractions instead; each script keeps its own
formula.)  ``--recip-newton`` is accepted and changes nothing (the port's
kernels divide exactly); ``--exact-constraint-eval false`` raises under the
linearized ladder (the port always checks constraints on the exact
evaluation).  ``--max-obstacles``: the obstacle slots (16 by default, the
config's, as the JAX script; the scenes hold 11 obstacles either way).

Prints one JSON line per backend (stderr) and the verdict line (stdout),
the card's name and power limit beside it; exits 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from .. import (PlannerConfig, REFERENCE_INNER_SCHEDULE_BLS,
                REFERENCE_INNER_SCHEDULE_GD, make_basis)
from ..ops import fused_solve as fs
from ..ops.costs import constraint_report
from ..ops.scenario import random_scenarios
from ..solvers import fleet
from . import _harness

SCHEDULES = {"bls": REFERENCE_INNER_SCHEDULE_BLS,
             "gd": REFERENCE_INNER_SCHEDULE_GD}


def bool_flag(x) -> bool:
    return str(x).lower() == "true"


def quality_config(solver: str = "bls", inner: int = 15,
                   schedule: bool = False,
                   ladder_eval: str = "linearized",
                   exact_constraint_eval: bool = True,
                   max_obstacles: int = 16) -> PlannerConfig:
    """benchmarks/quality.py's config: the ladder, fixed iterations, the
    solver's per-round schedule (``schedule``) or ``inner`` steps in every
    round.  Raises for what the port does not run."""
    if schedule:
        sched = SCHEDULES[solver]
        sched_kw = dict(inner_schedule=sched, max_inner_iteration=max(sched))
    else:
        sched_kw = dict(max_inner_iteration=inner)
    cfg = PlannerConfig(bls_mode="ladder", fixed_iters=True,
                        ladder_eval=ladder_eval,
                        exact_constraint_eval=exact_constraint_eval,
                        max_obstacles=max_obstacles, **sched_kw)
    fs.solver_check(solver)(cfg)
    return cfg


def _percentile(x: torch.Tensor, p: float) -> float:
    return float(np.percentile(x.cpu().numpy(), p))


def summarize(cfg: PlannerConfig, basis, scns, res) -> dict:
    """Per-lane unpenalized quality of a fleet SolveResult over the
    leading-batch scenes ``scns``: the obstacle cost under both blend
    extremes (the reference's final report, ref: main.py:141-143), the
    endpoint error (the larger of the start and goal position errors of
    costs.constraint_report), the converged fraction, the exact constraint
    check of every lane's final alpha (fleet.fleet_constraints) and the
    phantom convergences (flag set, exact check failed)."""
    avg = fleet.unpenalized_cost(cfg, basis, scns, res.alpha, 0.0)
    mx = fleet.unpenalized_cost(cfg, basis, scns, res.alpha, 1.0)
    rep = constraint_report(cfg, basis, scns, res.alpha)
    err = torch.maximum(rep["start_pos_err"], rep["goal_pos_err"])
    conv = res.stats.converged
    ok_exact = fleet.fleet_constraints(cfg, basis, fleet.to_fleet(scns),
                                       fleet.alpha_to_fleet(res.alpha))
    phantom = conv & ~ok_exact

    def frac(x):
        return float(x.float().mean())

    return {
        "converged_frac": round(frac(conv), 4),
        "exact_converged_frac": round(frac(ok_exact), 4),
        "phantom_frac": round(frac(phantom), 5),
        "avg_cost_mean": round(float(avg.mean()), 4),
        "avg_cost_p50": round(_percentile(avg, 50), 4),
        "avg_cost_p90": round(_percentile(avg, 90), 4),
        "max_cost_mean": round(float(mx.mean()), 4),
        "max_cost_p90": round(_percentile(mx, 90), 4),
        "endpoint_err_p90": round(_percentile(err, 90), 5),
        "mean_inner_steps": round(float(
            res.stats.inner_iters.float().mean()), 1),
    }


def run_backends(cfg: PlannerConfig, basis, scns, backends, solver: str,
                 tag: Optional[dict] = None) -> dict:
    """Solve ``scns`` on each backend (fleet.make_fleet_solver) and
    summarize it; one JSON line per backend on stderr (``tag``'s fields
    first).  Returns the rows by backend."""
    dev = scns.start.device
    rows = {}
    for backend in backends:
        res = fleet.make_fleet_solver(cfg, basis, solver=solver,
                                      backend=backend)(scns)
        _harness.sync(dev)
        rows[backend] = summarize(cfg, basis, scns, res)
        print(json.dumps({**(tag or {}), "backend": backend,
                          **rows[backend]}), file=sys.stderr, flush=True)
    return rows


def gate(rows: dict, tol_conv: float = 0.02, tol_cost: float = 0.01) -> bool:
    """benchmarks/quality.py's verdict against the first backend's row."""
    names = list(rows)
    base = rows[names[0]]
    # The band scales with the converged population (boundary lanes flip
    # at the sharp eps thresholds in proportion to it), capped so that a
    # double-digit regression at high convergence fails.
    conv_bound = max(tol_conv, min(0.15 * base["converged_frac"], 0.05))
    ok = True
    for n in names[1:]:
        r = rows[n]
        if abs(r["converged_frac"] - base["converged_frac"]) > conv_bound:
            ok = False
        if abs(r["avg_cost_mean"] - base["avg_cost_mean"]) > (
                tol_cost * max(abs(base["avg_cost_mean"]), 1e-6)):
            ok = False
    return ok


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--backends", default="xla,pallas,fused")
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--inner", type=int, default=15)
    p.add_argument("--schedule", action="store_true",
                   help="the solver's per-round inner schedule "
                        "(REFERENCE_INNER_SCHEDULE_*) in place of a uniform "
                        "--inner budget")
    p.add_argument("--ladder-eval", choices=["linearized", "exact"],
                   default="linearized")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--recip-newton", type=bool_flag, default=True,
                   help="accepted for the JAX script's sake; no effect (the "
                        "port's kernels divide exactly)")
    p.add_argument("--exact-constraint-eval", type=bool_flag, default=True,
                   help="false raises under the linearized ladder")
    p.add_argument("--tol-conv", type=float, default=0.02,
                   help="absolute floor of the converged-fraction band "
                        "against the first backend (the band is max(tol, "
                        "min(0.15 base, 0.05)))")
    p.add_argument("--tol-cost", type=float, default=0.01,
                   help="relative mean-cost band against the first backend")
    p.add_argument("--max-obstacles", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (the measurement) or cpu (the plain versions)")
    return p


def run(argv=None) -> dict:
    """The gate as ``main`` runs it; returns the verdict line's fields."""
    args = parser().parse_args(argv)
    dev = _harness.open_device(args.device, "quality")
    cfg = quality_config(args.solver, args.inner, args.schedule,
                         args.ladder_eval, args.exact_constraint_eval,
                         args.max_obstacles)
    basis = make_basis(cfg, device=dev)
    scns = random_scenarios(cfg, torch.Generator().manual_seed(args.seed),
                            args.batch, device=dev)
    rows = run_backends(cfg, basis, scns, args.backends.split(","),
                        args.solver)
    return {
        "metric": "quality_distribution_gate",
        "batch": args.batch,
        "backends": rows,
        "pass": gate(rows, args.tol_conv, args.tol_cost),
        **_harness.card(dev),
    }


def main(argv=None) -> int:
    out = run(argv)
    print(json.dumps(out), flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
