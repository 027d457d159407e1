"""Headline benchmark of the port: BLS solves/s on one GPU, with bench.py's
quality gate.

    python -m irm_motion_planning_tpu_torch.bench [--batch N] [--repeats R]

Protocol (the repository's bench.py default, replicated-scene BLS mode):
the reference scene replicated over ``--batch`` lanes, the fused BLS solve
with the linearized ladder at the fixed per-round schedule
REFERENCE_INNER_SCHEDULE_BLS, ``max_obstacles=11``.  The first run (which
builds the kernel) is excluded; each timed run ends with
``torch.cuda.synchronize()``; the best of ``--repeats`` counts.  The gate is
bench.py's: avg/max unpenalized obstacle cost of the solved scene within
``--quality-tol`` of REFERENCE_FINAL_COST["bls"] and endpoint error below
eps_position.  Prints one JSON line (bench.py's keys plus ``device`` and
``power_limit``) and exits 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from . import (
    PlannerConfig, REFERENCE_FINAL_COST, REFERENCE_INNER_SCHEDULE_BLS,
    make_basis, reference_scenario, replicate_scenario, solution_quality,
)
from .solvers import fleet

# The reference's published flagship: 3.12 ms per BLS solve on a CPU
# (DevBlog blog-post.html:389).
REF_SOLVE_SECONDS = 3.12e-3


def gpu_name_and_power_limit():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in out.split(","))
    return name, power


def bench_config(max_obstacles: int = 11, block_b: int = 0) -> PlannerConfig:
    sched = REFERENCE_INNER_SCHEDULE_BLS
    return PlannerConfig(
        bls_mode="ladder", fixed_iters=True, inner_schedule=sched,
        max_inner_iteration=max(sched), max_obstacles=max_obstacles,
        pallas_block_b=block_b,
    )


def run_bench(batch: int = 1048576, repeats: int = 5, block_b: int = 0,
              max_obstacles: int = 11, quality_tol: float = 0.02,
              device: str = "cuda") -> dict:
    """Run the protocol; returns the JSON fields plus ``timing`` (seconds
    of the first run and of each timed run) and ``result`` (the solve)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs on a GPU")
    cfg = bench_config(max_obstacles, block_b)
    basis = make_basis(cfg, device=dev)
    scn0 = reference_scenario(cfg, device=dev)
    scns = replicate_scenario(scn0, batch)
    run = fleet.make_fleet_solver(cfg, basis)

    def run_to_completion():
        out = run(scns)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    t0 = time.perf_counter()
    warm = run_to_completion()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_to_completion()
        times.append(time.perf_counter() - t0)

    q = solution_quality(cfg, basis, scn0, warm.alpha[0])
    avg_cost, max_cost = float(q["avg_cost"]), float(q["max_cost"])
    endpoint_err = float(q["endpoint_err"])
    ref_avg, ref_max = REFERENCE_FINAL_COST["bls"]
    quality_ok = (
        avg_cost <= ref_avg * (1.0 + quality_tol)
        and max_cost <= ref_max * (1.0 + quality_tol)
        and endpoint_err < cfg.eps_position
    )
    best = min(times)
    solves_per_sec = batch / best
    if dev.type == "cuda":
        name, power = gpu_name_and_power_limit()
    else:
        name, power = "cpu", None
    return {
        # A CPU rehearsal never reports under the device metric's name.
        "metric": ("bls_solves_per_sec_per_chip" if dev.type == "cuda"
                   else "bls_solves_per_sec_cpu_rehearsal"),
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec * REF_SOLVE_SECONDS, 2),
        "quality_ok": bool(quality_ok),
        "avg_cost": round(avg_cost, 4),
        "max_cost": round(max_cost, 4),
        "ref_avg_cost": round(ref_avg, 4),
        "ref_max_cost": round(ref_max, 4),
        "endpoint_err": round(endpoint_err, 4),
        "device": name,
        "power_limit": power,
        "timing": {"first_s": first_s, "times_s": times, "batch": batch},
        "result": warm,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1048576)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--block-b", type=int, default=0,
                   help="lanes per CUDA block (0: the kernel's default)")
    p.add_argument("--max-obstacles", type=int, default=11)
    p.add_argument("--quality-tol", type=float, default=0.02)
    p.add_argument("--device", default="cuda",
                   help="cuda (the benchmark) or cpu (the plain version, "
                        "for rehearsal at a small batch)")
    args = p.parse_args(argv)
    out = run_bench(args.batch, args.repeats, args.block_b,
                    args.max_obstacles, args.quality_tol, args.device)
    timing = out.pop("timing")
    out.pop("result")
    print(json.dumps(out))
    best = min(timing["times_s"])
    print(
        f"# batch={args.batch} best={best * 1e3:.1f}ms "
        f"first(build+run)={timing['first_s']:.1f}s "
        f"per-solve={1e6 * best / args.batch:.3f}us device={out['device']} "
        f"power_limit={out['power_limit']} "
        f"quality[{'PASS' if out['quality_ok'] else 'FAIL'}]: "
        f"avg={out['avg_cost']} max={out['max_cost']} "
        f"endpoint={out['endpoint_err']} (gate: within {args.quality_tol:.0%} "
        f"of {out['ref_avg_cost']}/{out['ref_max_cost']}, endpoint < 0.01)",
        file=sys.stderr,
    )
    return 0 if out["quality_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
