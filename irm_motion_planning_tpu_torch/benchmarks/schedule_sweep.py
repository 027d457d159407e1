"""Inner-schedule sweep on the reference scene through K2, the per-round
kernel (the port of benchmarks/schedule_sweep.py).

K2 (ops/fused_solve.py ``fused_round``) takes the round's inner budget as
a plain kernel argument, and the rounds driver over it gives the
whole-solve kernel's results bit for bit, so every candidate schedule runs
on one build: one K2 launch per round, the penalty escalation on the host
(solvers/fleet.py ``after_round``, the driver's own bookkeeping).

    python -m irm_motion_planning_tpu_torch.benchmarks.schedule_sweep
    python -m irm_motion_planning_tpu_torch.benchmarks.schedule_sweep \\
        --schedules "48,8,4,32,64,16,8,8,8,8;48,8,4,32,80,24,8,8,8,8"

The config's ``max_inner_iteration`` is the largest budget of all the
candidates, as in the JAX script; ``--block-b`` is K2's lanes per CTA (0:
16).  One JSON line per candidate: the schedule, its total budget, the
live steps of lane 0, the solved scene's avg/max cost, its endpoint error
and the avg cost's gap to REFERENCE_FINAL_COST in percent; each line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import (PlannerConfig, REFERENCE_FINAL_COST, make_basis,
                reference_scenario, replicate_scenario, solution_quality)
from ..ops import fused_solve as fs
from ..solvers import fleet
from . import _harness

DEFAULT_BLS = [
    # shipped: the bench's REFERENCE_INNER_SCHEDULE_BLS
    (48, 8, 4, 32, 64, 16, 8, 8, 8, 8),
    # late-round budget variants (the late rounds pull the endpoint)
    (48, 8, 4, 32, 80, 16, 8, 8, 8, 8),
    (48, 8, 4, 32, 96, 24, 8, 8, 8, 8),
    (48, 8, 4, 32, 64, 32, 16, 8, 8, 8),
    (48, 8, 4, 32, 64, 16, 16, 16, 8, 8),
    (48, 8, 4, 40, 80, 24, 8, 8, 8, 8),
    (48, 8, 4, 24, 64, 16, 8, 8, 8, 8),
    (48, 8, 4, 32, 72, 20, 8, 8, 8, 8),
]


def sweep_config(max_budget: int, block_b: int = 0) -> PlannerConfig:
    """benchmarks/schedule_sweep.py's config: the ladder, fixed iterations,
    ``max_budget`` steps at most per round, 11 obstacle slots."""
    return PlannerConfig(bls_mode="ladder", fixed_iters=True,
                         max_inner_iteration=max_budget, max_obstacles=11,
                         pallas_block_b=block_b)


def run_schedule(cfg: PlannerConfig, basis, fsc, a0k, sched, block_b: int,
                 solver: str = "bls"):
    """The dual solve with the per-round budgets ``sched`` given from
    outside (``cfg`` stays fixed, so every candidate shares one build): one
    K2 launch per round from the round's learning rate (fused_solve
    .round_lr), the bookkeeping of the rounds driver between them.
    ``fsc``: the lane-trailing scenes (fleet.to_fleet); ``a0k``: the warm
    start (J, T, B); ``block_b``: lanes per CTA.  Returns (alpha (J, T, B),
    lane 0's accepted steps, the final Rounds state)."""
    cfg = cfg.replace(pallas_block_b=block_b)
    B = a0k.shape[-1]
    dev = a0k.device
    s = fleet.start_rounds(
        a0k, torch.full((1, B), cfg.lambda_sg_constraint, device=dev),
        torch.full((1, B), cfg.lambda_jl_constraint, device=dev))
    lanes = (fsc.start, fsc.goal, fsc.obstacles[:, 0], fsc.obstacles[:, 1],
             fsc.obstacle_weight)
    kvt = fs.memo("kvt", lambda m: m.T.contiguous(), basis.kv)
    for r, n_r in enumerate(sched):
        lr0 = torch.full((1, B), fs.round_lr(cfg, r, solver),
                         dtype=torch.float32, device=dev)
        out = fs.fused_round(cfg, basis.kv, kvt, basis.mix, s.alpha,
                             s.lam_sg, s.lam_jl, s.ful, lr0, int(n_r),
                             *(x.contiguous() for x in lanes), solver=solver)
        s = fleet.after_round(cfg, s, out)
    return s.alpha, float(s.total_inner[0, 0]), s


def candidate_row(cfg: PlannerConfig, basis, scn0, alpha, steps: float,
                  sched, solver: str = "bls") -> dict:
    """The JSON line of one candidate from its solve's alpha (J, T, B):
    lane 0's quality on the reference scene."""
    a0 = fleet.alpha_from_fleet(alpha.movedim(0, 1))[0]
    q = solution_quality(cfg, basis, scn0, a0)
    ref_avg, _ = REFERENCE_FINAL_COST[solver]
    return {
        "sched": list(sched), "total_budget": int(sum(sched)),
        "live_steps": round(steps, 0),
        "avg_cost": round(float(q["avg_cost"]), 4),
        "max_cost": round(float(q["max_cost"]), 4),
        "endpoint_err": round(float(q["endpoint_err"]), 5),
        "avg_gap_pct": round(100 * (float(q["avg_cost"]) / ref_avg - 1), 2),
    }


def run(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--block-b", type=int, default=0,
                   help="K2's lanes per CTA, 1-16 (0: 16)")
    p.add_argument("--schedules", default=None,
                   help="semicolon-separated comma lists; default: the "
                        "builtin BLS candidates")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _harness.open_device(args.device, "schedule_sweep")
    if args.schedules:
        cands = [tuple(int(x) for x in s.split(","))
                 for s in args.schedules.split(";")]
    else:
        cands = DEFAULT_BLS
    cfg = sweep_config(max(max(s) for s in cands), args.block_b)
    basis = make_basis(cfg, device=dev)
    scn0 = reference_scenario(cfg, device=dev)
    fsc = fleet.to_fleet(replicate_scenario(scn0, args.batch))
    a0k = fleet.fleet_init_alpha(cfg, basis, fsc).movedim(1, 0).contiguous()
    card = _harness.card(dev)
    rows = []
    for sched in cands:
        alpha, steps, _ = run_schedule(cfg, basis, fsc, a0k, sched,
                                       args.block_b, args.solver)
        rows.append({**candidate_row(cfg, basis, scn0, alpha, steps, sched,
                                     args.solver), **card})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
