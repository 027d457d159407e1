"""Certification of the exact BLS ladder against a stored oracle: the
engine phase of the repository's benchmarks/certify.py for its exact tier.

The oracle file (``certify_oracle_cpu2048.npz``, written by
``benchmarks/certify.py --phase oracle``; the oracle itself is not ported)
holds random scenes and, for each, the final avg/max unpenalized obstacle
cost and the converged flag of the reference's sequential BLS solver at the
bench's per-round schedule.  The port solves the same scenes with the exact
ladder and compares them scene by scene, conditioned on the outcome, as
certify.py does: the mean and median gaps on the scenes both sides
converged are held to certify.py's bounds, and the port's converged
fraction may fall at most CONV_SLACK below the oracle's.  certify.py
calibrates its bounds for an engine and an oracle on one platform; against
a CPU oracle a run on the card is informative.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import PlannerConfig, REFERENCE_INNER_SCHEDULE_BLS
from .models.rkhs import make_basis
from .ops.costs import Penalty
from .ops.scenario import Scenario
from .solvers import fleet

# benchmarks/certify.py's bounds for the exact tier: the both-converged mean
# gap (avg and max cost), the both-converged median gap, and the
# converged-fraction slack.
MEAN_BOUND = 0.0025
MEDIAN_BOUND = 0.001
CONV_SLACK = 0.06


def exact_config(data) -> PlannerConfig:
    """The engine configuration certify.py runs for the exact tier on the
    oracle ``data``: the oracle's obstacle slots and its stopping (the
    bench's per-round schedule, or early exit), lane compaction on the fused
    backend."""
    if str(data["stopping"]) == "schedule":
        sched = REFERENCE_INNER_SCHEDULE_BLS
        stop = dict(fixed_iters=True, inner_schedule=sched,
                    max_inner_iteration=max(sched))
    else:
        stop = dict(fixed_iters=False)
    return PlannerConfig(bls_mode="ladder",
                         max_obstacles=int(data["max_obstacles"]),
                         ladder_eval="exact", lane_compaction=True, **stop)


def scene_costs(cfg: PlannerConfig, basis, fsc: Scenario, alpha):
    """Each scene's final avg and max unpenalized obstacle cost (the
    reference's own report) of alpha (T, J, B), as float64 numpy."""
    zero = torch.zeros((), dtype=torch.float32, device=alpha.device)
    pen0 = Penalty(zero, zero)
    return tuple(
        fleet.fleet_cost(cfg.replace(lambda_max_cost=lam), basis, fsc, pen0,
                         alpha).double().cpu().numpy()
        for lam in (0.0, 1.0))


def gap_stats(ours, ref, mask) -> dict:
    """Paired per-scene relative gap statistics on the masked scenes
    (positive: worse than the oracle); 95% CI, normal approximation."""
    g = (ours[mask] - ref[mask]) / ref[mask]
    n = int(g.size)
    if n == 0:
        return {"n": 0}
    mean = float(g.mean())
    half = 1.96 * (float(g.std(ddof=1)) if n > 1 else 0.0) / np.sqrt(n)
    return {
        "n": n,
        "mean_gap": round(mean, 6),
        "ci95": [round(mean - half, 6), round(mean + half, 6)],
        "p50_gap": round(float(np.percentile(g, 50)), 6),
        "p90_gap": round(float(np.percentile(g, 90)), 6),
        "frac_better": round(float((g < 0).mean()), 4),
    }


def certify_exact(data, device) -> dict:
    """Solve the oracle's scenes with the exact ladder on the fused backend
    and compare them with the oracle: certify.py's row, with ``pass``."""
    cfg = exact_config(data)
    basis = make_basis(cfg, device=device)
    scns = Scenario(*(torch.as_tensor(np.asarray(data[k]), dtype=torch.float32,
                                      device=device)
                      for k in ("start", "goal", "obstacles",
                                "obstacle_weight")))
    res = fleet.fleet_solve(cfg, basis, scns, solver="bls", backend="fused")
    avg, mx = scene_costs(cfg, basis, fleet.to_fleet(scns),
                          fleet.alpha_to_fleet(res.alpha))
    ec = res.stats.converged.cpu().numpy()
    ref_avg, ref_mx, oc = data["avg"], data["max"], data["conv"]
    finite = (np.isfinite(avg) & np.isfinite(mx) & np.isfinite(ref_avg)
              & np.isfinite(ref_mx))
    classes = {
        "both_converged": finite & oc & ec,
        "neither_converged": finite & ~oc & ~ec,
        "engine_only_converged": finite & ~oc & ec,
        "oracle_only_converged": finite & oc & ~ec,
        "all": finite,
    }
    row = {
        "batch": int(data["batch"]), "stopping": str(data["stopping"]),
        "nonfinite_excluded": int((~finite).sum()),
        "oracle_converged_frac": round(float(oc.mean()), 4),
        "engine_converged_frac": round(float(ec.mean()), 4),
    }
    for name, mask in classes.items():
        row[name] = {"avg": gap_stats(avg, ref_avg, mask),
                     "max": gap_stats(mx, ref_mx, mask)}
    bc = row["both_converged"]
    row["pass"] = bool(
        ec.mean() >= oc.mean() - CONV_SLACK
        and all(bc[k].get("mean_gap", 1) <= MEAN_BOUND
                and abs(bc[k].get("p50_gap", 1)) <= MEDIAN_BOUND
                for k in ("avg", "max"))
    )
    return row
