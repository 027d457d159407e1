"""The ``lambda_max_cost`` ablation (the port of benchmarks/ablation.py):
the reference's published table (DevBlog blog-post.html:545-582) of the
final avg/max obstacle cost for lambda in {0, 0.25, 0.5, 0.75, 1.0}.

Each point is one single-scene solve of the reference scene
(solvers/bls.py or solvers/gd.py: the ladder BLS, early exit, the
config's defaults) with the blend weight ``lambda_max_cost``; the solved
trajectory's unpenalized avg and max cost (costs.solution_quality) stand
beside the reference's published values.

    python -m irm_motion_planning_tpu_torch.benchmarks.ablation \\
        [--solver bls|gd] [--device cuda|cpu]

``--max-inner-iteration`` / ``--max-outer-iteration`` cut the budget (the
config's 200 and 10 by default).  One JSON line per point, then the table,
the card's name and power limit beside it.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import (PlannerConfig, make_basis, reference_scenario,
                solution_quality)
from ..solvers import bls, gd
from . import _harness

# The reference's published table (blog-post.html:555-582): (avg, max).
REFERENCE_TABLE = {
    0.0: (1.75, 3.37),
    0.25: (1.64, 2.19),
    0.5: (1.69, 2.19),
    0.75: (1.73, 2.19),
    1.0: (1.82, 2.19),
}


def ablation_row(lam: float, solver: str = "bls", device="cuda",
                 alpha0=None, **budget) -> dict:
    """One point: the solve of the reference scene at ``lambda_max_cost =
    lam`` from ``alpha0`` (T, J) (None: the solver's smoothstep fit);
    ``budget``: PlannerConfig fields that cut it."""
    cfg = PlannerConfig(lambda_max_cost=lam, bls_mode="ladder", **budget)
    basis = make_basis(cfg, device=device)
    scn = reference_scenario(cfg, device=device)
    res = {"bls": bls, "gd": gd}[solver].solve(cfg, basis, scn, alpha0)
    q = solution_quality(cfg, basis, scn, res.alpha)
    ref_avg, ref_max = REFERENCE_TABLE[lam]
    return {
        "lambda_max_cost": lam,
        "avg_cost": round(float(q["avg_cost"]), 4),
        "max_cost": round(float(q["max_cost"]), 4),
        "reference_avg": ref_avg,
        "reference_max": ref_max,
    }


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--max-inner-iteration", type=int, default=None)
    p.add_argument("--max-outer-iteration", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _harness.open_device(args.device, "ablation")
    budget = {k: v for k, v in (
        ("max_inner_iteration", args.max_inner_iteration),
        ("max_outer_iteration", args.max_outer_iteration)) if v is not None}
    rows = []
    for lam in REFERENCE_TABLE:
        rows.append(ablation_row(lam, args.solver, dev, **budget))
        print(json.dumps(rows[-1]), flush=True)
    return {"metric": "lambda_max_cost_ablation", "rows": rows,
            **_harness.card(dev)}


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
