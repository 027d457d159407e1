"""Seed sweep of the cross-backend quality distribution (the port of
benchmarks/quality_sweep.py).

Runs quality.py's measurement at several seeds and reports, for each
backend against the first, the per-seed converged-fraction and mean-cost
deltas and whether the converged delta changes sign across seeds: a gap
whose sign flips is boundary-lane floating-point noise, one that keeps its
sign is a directional effect of a kernel's fp path.

    python -m irm_motion_planning_tpu_torch.benchmarks.quality_sweep \\
        [--seeds 0,1,2,3,4] [--batch 32768] [--backends xla,pallas,fused] \\
        [--solver bls|gd] [--device cuda|cpu]

The bench's per-round schedule always (``--schedule`` is accepted and on,
as in the JAX script).  One JSON line per seed and backend (stderr), the
sweep (stdout) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import make_basis
from ..ops.scenario import random_scenarios
from . import _harness
from .quality import SCHEDULES, quality_config, run_backends


def deltas(per_seed: list, backends: list) -> dict:
    """Each backend against the first, over the seeds' rows: the
    converged-fraction and mean-cost deltas per seed, their mean, and
    whether the converged delta takes both signs."""
    base = backends[0]
    out = {}
    for b in backends[1:]:
        dc = [r[b]["converged_frac"] - r[base]["converged_frac"]
              for r in per_seed]
        dm = [r[b]["avg_cost_mean"] - r[base]["avg_cost_mean"]
              for r in per_seed]
        out[f"{b}-{base}"] = {
            "converged_frac_delta_per_seed": [round(d, 4) for d in dc],
            "converged_frac_delta_mean": round(sum(dc) / len(dc), 4),
            "sign_flips": bool(min(dc) < 0 < max(dc)),
            "avg_cost_delta_per_seed": [round(d, 5) for d in dm],
        }
    return out


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="0,1,2,3,4")
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--backends", default="xla,pallas,fused")
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--schedule", action="store_true", default=True,
                   help="the bench's per-round schedule (always on)")
    p.add_argument("--max-obstacles", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _harness.open_device(args.device, "quality_sweep")
    cfg = quality_config(args.solver, schedule=True,
                         max_obstacles=args.max_obstacles)
    basis = make_basis(cfg, device=dev)
    backends = args.backends.split(",")
    per_seed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        scns = random_scenarios(cfg, torch.Generator().manual_seed(seed),
                                args.batch, device=dev)
        per_seed.append({"seed": seed, **run_backends(
            cfg, basis, scns, backends, args.solver, {"seed": seed})})
    return {
        "metric": "quality_seed_sweep",
        "batch": args.batch,
        "solver": args.solver,
        "schedule": list(SCHEDULES[args.solver]),
        "per_seed": per_seed,
        "deltas": deltas(per_seed, backends),
        **_harness.card(dev),
    }


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
