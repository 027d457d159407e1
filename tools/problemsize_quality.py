"""The bf16 plan against the plain ``xla`` engine at large T under the JAX
package's problem-size protocol, on the same random scenes.

    python tools/problemsize_quality.py [--T 2200] [--batch 2048] \\
        [--inner 15] [--seed 0] [--device cuda]

The protocol is benchmarks/problemsize.py's (the JAX package's): BLS with
the linearized ladder, ``fixed_iters`` with ``--inner`` steps in every one
of the ten penalty rounds (no per-round schedule), the config's default
``max_obstacles`` (16), ``pallas_block_b=0``.  JAX's record of it at T =
2,200 on 2,048 random scenes is PROBLEMSIZE_r05.json's
``T2200_quality_vs_xla_same_scenes``.  Here the port's random scenes of
``--seed`` go through ``fleet_solve(backend="fused")`` with
``bls_bf16_ladder=True`` (the bf16 plan, one K1 launch; past the float32
plans' ceiling) and through the ``xla`` engine.  Prints one JSON line: for
each engine its converged fraction, mean and 90th-percentile unpenalized
obstacle cost, phantom fraction and seconds (one run each, the build
included for fused), bench.py's paired gate of the bf16 plan against
``xla`` on every scene (bands and verdict), K1's launches and plan, and
the card's name and power limit.  ``--device cpu`` rehearses it on the
plain versions (use a small ``--T`` and ``--batch``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch import bench  # noqa: E402
from irm_motion_planning_tpu_torch.benchmarks import _harness  # noqa: E402
from irm_motion_planning_tpu_torch.ops import fused_solve as fs  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import fleet  # noqa: E402


def engine(cfg, basis, scns, res, seconds) -> dict:
    """One engine's quality fields on the scenes it solved."""
    conv = res.stats.converged
    ok = fleet.fleet_constraints(cfg, basis, fleet.to_fleet(scns),
                                 fleet.alpha_to_fleet(res.alpha))
    cost = fleet.unpenalized_cost(cfg, basis, scns, res.alpha).float()
    return {
        "converged": float(conv.float().mean()),
        "mean_obstacle_cost": float(cost.mean()),
        "p90_obstacle_cost": float(torch.quantile(cost.cpu(), 0.9)),
        "phantom": float((conv & ~ok).float().mean()),
        "seconds": seconds,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=2200)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--inner", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = _harness.open_device(a.device, "problemsize_quality")
    cfg = mt.PlannerConfig(n_timesteps=a.T, bls_mode="ladder",
                           fixed_iters=True, max_inner_iteration=a.inner,
                           pallas_block_b=0, bls_bf16_ladder=True)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(a.seed),
                               a.batch, device=dev)
    runs = {}
    for name in ("fused", "xla"):
        fs.fused_solve.launches = 0
        t0 = time.perf_counter()
        res = fleet.fleet_solve(cfg, basis, scns, backend=name)
        _harness.sync(dev)
        runs[name] = (res, time.perf_counter() - t0, fs.fused_solve.launches)
    fused, xla = (engine(cfg, basis, scns, r, s) for r, s, _ in runs.values())
    gate = bench.gate_against(cfg, basis, scns, runs["fused"][0], a.batch,
                              xla["converged"], xla["mean_obstacle_cost"])
    plan = fs.kernel_plan(cfg, cfg.max_obstacles)
    print(json.dumps({
        "metric": "problem_size_quality", "T": a.T, "batch": a.batch,
        "seed": a.seed, "inner_per_round": a.inner,
        "rounds": cfg.max_outer_iteration,
        "max_obstacles": cfg.max_obstacles,
        "plan": {"plan": plan["plan"], "bf16": bool(plan.get("bf16"))},
        "k1_launches": runs["fused"][2],
        "fused_bf16": fused, "xla": xla,
        "paired_gate": {"ok": gate["ok"],
                        "converged_band": gate["bands"]["converged"],
                        "cost_band": gate["bands"]["cost"]},
        **_harness.card(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
