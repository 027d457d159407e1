"""The fleet solve's wall time split into its stages (the port of
benchmarks/decompose.py): the layout (``to_fleet``), the smoothstep warm
start (``fleet_init_alpha``), the solve from that warm start
(``fleet_solve`` with ``alpha0``: the public path less the warm start) and
the whole solve (``make_fleet_solver``), on ``--backend``.

    python -m irm_motion_planning_tpu_torch.benchmarks.decompose \\
        [--batch 32768] [--backend fused|pallas|xla] [--inner 15] \\
        [--device cuda|cpu]

The reference scene replicated over ``--batch`` lanes, BLS on the ladder
with ``--inner`` fixed steps per round, ``--max-obstacles`` slots (16, the
config's, by default as in the JAX script).  Each stage: the least of
``--repeats`` calls after a warm-up, each ended by a synchronize.  One
JSON line with the JAX script's keys, the card's name and power limit
beside them.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import (PlannerConfig, make_basis, reference_scenario,
                replicate_scenario)
from ..solvers import fleet
from . import _harness


def decompose_config(inner: int = 15,
                     max_obstacles: int = 16) -> PlannerConfig:
    return PlannerConfig(bls_mode="ladder", fixed_iters=True,
                         max_inner_iteration=inner,
                         max_obstacles=max_obstacles)


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--backend", choices=["fused", "pallas", "xla"],
                   default="fused")
    p.add_argument("--inner", type=int, default=15)
    p.add_argument("--max-obstacles", type=int, default=16)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _harness.open_device(args.device, "decompose")
    cfg = decompose_config(args.inner, args.max_obstacles)
    basis = make_basis(cfg, device=dev)
    scns = replicate_scenario(reference_scenario(cfg, device=dev),
                              args.batch)

    def timed(fn):
        return _harness.best_seconds(fn, dev, args.repeats)

    t_layout, fsc = timed(lambda: fleet.to_fleet(scns))
    t_init, a0 = timed(lambda: fleet.fleet_init_alpha(cfg, basis, fsc))
    alpha0 = fleet.alpha_from_fleet(a0)
    t_solve, _ = timed(lambda: fleet.fleet_solve(
        cfg, basis, scns, alpha0=alpha0, solver="bls",
        backend=args.backend))
    run_full = fleet.make_fleet_solver(cfg, basis, backend=args.backend)
    t_full, _ = timed(lambda: run_full(scns))
    return {
        "metric": "fleet_solve_decomposition",
        "batch": args.batch,
        "backend": args.backend,
        "layout_ms": round(t_layout * 1e3, 2),
        "init_ms": round(t_init * 1e3, 2),
        "solve_minus_init_ms": round(t_solve * 1e3, 2),
        "full_ms": round(t_full * 1e3, 2),
        **_harness.card(dev),
    }


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
