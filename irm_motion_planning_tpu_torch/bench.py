"""Headline benchmark of the port: solves/s on one GPU, with bench.py's
quality gates.

    python -m irm_motion_planning_tpu_torch.bench [--batch N] [--repeats R]
    python -m irm_motion_planning_tpu_torch.bench --random-scenarios [--seed S]
    python -m irm_motion_planning_tpu_torch.bench --solver gd [--random-scenarios]
    python -m irm_motion_planning_tpu_torch.bench --solver gd --backend pallas
    python -m irm_motion_planning_tpu_torch.bench --ladder-eval exact [--random-scenarios]
    python -m irm_motion_planning_tpu_torch.bench --engine vmap [--inner N]

Protocol (the repository's bench.py): ``--engine`` fleet (the default:
lanes trailing, on ``--backend``) or vmap (the single-scene solver lane by
lane, solvers/batched.py; plain PyTorch, no kernel); ``--solver`` BLS (the
default, with the ladder tier ``--ladder-eval``: linearized, the default, or
exact) or GD at its fixed per-round schedule
(REFERENCE_INNER_SCHEDULE_BLS or _GD, or ``--inner`` steps in every
round; GD's learning rates follow the ``gd_lr`` schedule),
``max_obstacles=11``, 1,048,576 lanes, on
``--backend`` fused (the whole-solve kernels, K1 or per round K2, for
either solver; the default), pallas (the per-step kernels) or xla (the
plain engine).  The first run (which builds the kernels) is excluded; each
timed run ends with ``torch.cuda.synchronize()``; the best of ``--repeats``
counts.

* Replicated mode (the default): the reference scene on every lane.  The
  gate: avg/max unpenalized obstacle cost of the solved scene within
  ``--quality-tol`` of REFERENCE_FINAL_COST[solver] and endpoint error
  below eps_position (BLS, linearized ladder), 0.05 (BLS, exact ladder: it
  tracks the reference's own path, which ends at 0.046) or the reference
  GD's own 0.042 (GD).
* ``--random-scenarios``: every lane its own random scene (a
  ``torch.Generator`` seeded with ``--seed``), with lane compaction on by
  default on the fused backend (one kernel launch per penalty round, lanes
  re-sorted after round 0).  The gate is bench.py's paired one: the first
  ``--quality-check-lanes`` scenes are solved again by the plain ``xla``
  engine with the same solver (skipped when the measured run is the
  fleet engine's xla backend itself);
  the measured run must have no phantom convergence (converged but failing
  the exact constraint check; <= 2 lanes of boundary wobble), a converged
  fraction within max(0.02, min(0.15 max(conv), 0.05)) of the engine's and
  a mean unpenalized obstacle cost within 1% of it.

Prints one JSON line (bench.py's keys of the mode plus ``device`` and
``power_limit``) and exits 1 when the gate fails.  ``--device cpu`` runs the
plain versions as a rehearsal at a small batch, under its own metric name.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Optional

import torch

from . import (
    PlannerConfig, REFERENCE_FINAL_COST, REFERENCE_INNER_SCHEDULE_BLS,
    REFERENCE_INNER_SCHEDULE_GD, Scenario, make_basis, reference_scenario, replicate_scenario,
    solution_quality,
)
from .ops.scenario import random_scenarios as random_scenarios_fn
from .solvers import batched, fleet
from .solvers.common import SolveResult

# The reference's published flagships: 3.12 ms per BLS solve and 7.26 ms
# per GD solve on a CPU (DevBlog blog-post.html:389-390).
REF_SOLVE_SECONDS = {"bls": 3.12e-3, "gd": 7.26e-3}
SCHEDULES = {"bls": REFERENCE_INNER_SCHEDULE_BLS,
             "gd": REFERENCE_INNER_SCHEDULE_GD}
# Endpoint bound of the replicated-scene gate: BLS with the linearized
# ladder must meet eps_position; the exact ladder, which follows the
# reference's own path (its flagship ends at 0.046), 0.05; GD must end no
# more violated than the reference's own GD (0.042).  As bench.py sets them.
EXACT_ENDPOINT_BOUND = 0.05
GD_ENDPOINT_BOUND = 0.042


def gpu_name_and_power_limit():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in out.split(","))
    return name, power


def bench_config(max_obstacles: int = 11, block_b: int = 0,
                 solver: str = "bls", ladder_eval: str = "linearized",
                 n_timesteps: int = 50,
                 inner: Optional[int] = None) -> PlannerConfig:
    """The bench's config: the solver's per-round schedule, or ``inner``
    steps in every round (JAX bench.py --inner)."""
    if inner is not None:
        sched_kw = dict(max_inner_iteration=inner)
    else:
        sched = SCHEDULES[solver]
        sched_kw = dict(inner_schedule=sched, max_inner_iteration=max(sched))
    return PlannerConfig(
        bls_mode="ladder", fixed_iters=True, max_obstacles=max_obstacles,
        pallas_block_b=block_b, ladder_eval=ladder_eval,
        n_timesteps=n_timesteps, **sched_kw,
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def paired_gate(cfg: PlannerConfig, basis, scns, res, n_check: int,
                solver: str = "bls") -> dict:
    """bench.py's paired quality gate of a random-scenes run: the first
    ``n_check`` scenes solved again by the plain ``xla`` engine with the
    same solver (without compaction, a kernel-driver feature); phantom convergence on the exact
    constraint check, converged fraction and mean UNPENALIZED obstacle cost
    against the engine's.  (The penalized final cost carries each lane's
    final lambda, x10 per escalation, so its mean measures rounds run, not
    solution quality.)  Returns the JSON fields, ``ok``, the bands and the
    engine's seconds."""
    dev = res.alpha.device
    sub = Scenario(*(x[:n_check] for x in scns))
    t0 = time.perf_counter()
    ref = fleet.fleet_solve(cfg.replace(lane_compaction=False), basis, sub,
                            solver=solver, backend="xla")
    _sync(dev)
    xla_s = time.perf_counter() - t0
    ref_conv = float(ref.stats.converged.float().mean())
    ref_cost = mean_obstacle_cost(cfg, basis, sub, ref)
    return {**gate_against(cfg, basis, scns, res, n_check, ref_conv,
                           ref_cost), "xla_s": xla_s}


def mean_obstacle_cost(cfg: PlannerConfig, basis, scns, res) -> float:
    """The mean unpenalized obstacle cost of the solved scenes ``scns``."""
    return float(fleet.unpenalized_cost(cfg, basis, scns, res.alpha).mean())


def gate_against(cfg: PlannerConfig, basis, scns, res, n_check: int,
                 ref_conv: float, ref_cost: float) -> dict:
    """The paired gate (:func:`paired_gate`) of the first ``n_check`` lanes
    of ``res`` against the ``xla`` engine's converged fraction ``ref_conv``
    and mean unpenalized obstacle cost ``ref_cost`` on the same scenes (a
    run already made).  Returns the JSON fields, ``ok`` and the bands."""
    sub = Scenario(*(x[:n_check] for x in scns))
    head = SolveResult(res.alpha[:n_check],
                       type(res.stats)(*(x[:n_check] for x in res.stats)))
    conv = head.stats.converged
    ok_exact = fleet.fleet_constraints(cfg, basis, fleet.to_fleet(sub),
                                       fleet.alpha_to_fleet(head.alpha))
    phantom = float((conv & ~ok_exact).float().mean())
    sub_cost = mean_obstacle_cost(cfg, basis, sub, head)
    sub_conv = float(conv.float().mean())
    conv_band = max(0.02, min(0.15 * max(ref_conv, sub_conv), 0.05))
    cost_band = 0.01 * max(abs(ref_cost), 1e-6)
    ok = (phantom <= 2.0 / n_check
          and abs(sub_conv - ref_conv) <= conv_band
          and abs(sub_cost - ref_cost) <= cost_band)
    return {
        "fields": {
            "paired_check_lanes": n_check,
            "phantom_frac": round(phantom, 6),
            "xla_converged_frac": round(ref_conv, 4),
            "mean_obstacle_cost": round(sub_cost, 4),
            "xla_mean_obstacle_cost": round(ref_cost, 4),
        },
        "ok": bool(ok),
        "bands": {"converged": conv_band, "cost": cost_band,
                  "phantom": 2.0 / n_check, "check_converged_frac": sub_conv,
                  "xla_converged_frac": ref_conv,
                  "check_obstacle_cost": sub_cost, "xla_obstacle_cost": ref_cost},
    }


def run_bench(batch: int = 1048576, repeats: int = 5, block_b: int = 0,
              max_obstacles: int = 11, quality_tol: float = 0.02,
              device: str = "cuda", random_scenarios: bool = False,
              seed: int = 0, quality_check_lanes: int = 32768,
              lane_compaction: Optional[bool] = None, solver: str = "bls",
              backend: str = "fused", ladder_eval: str = "linearized",
              n_timesteps: int = 50, engine: str = "fleet",
              inner: Optional[int] = None) -> dict:
    """Run the protocol; returns the JSON fields plus ``timing`` (seconds
    of the first run, of each timed run and of the paired check's engine),
    ``gate`` (the paired gate's bands, random mode) and ``result`` (the
    solve).  ``n_timesteps``: T (the committed basis exports: 25, 50, 100,
    150, 200); the replicated mode's gate holds the reference's T = 50
    costs, so other T run in random mode.  ``engine``: ``"fleet"`` on
    ``backend``, or ``"vmap"`` (solvers/batched.py, plain PyTorch; the
    backend is not used); ``inner``: uniform inner steps per round in place
    of the schedule."""
    if engine not in ("fleet", "vmap"):
        raise ValueError(f"unknown engine {engine!r}")
    if n_timesteps != 50 and not random_scenarios:
        raise ValueError("the replicated-scene gate is the reference's at "
                         "T = 50; other T run with random scenes")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs on a GPU")
    if lane_compaction is None:
        lane_compaction = (random_scenarios and backend == "fused"
                           and engine == "fleet")
    cfg = bench_config(max_obstacles, block_b, solver, ladder_eval,
                       n_timesteps, inner).replace(
                           lane_compaction=lane_compaction)
    basis = make_basis(cfg, device=dev)
    if random_scenarios:
        scns = random_scenarios_fn(cfg, torch.Generator().manual_seed(seed),
                                   batch, device=dev)
    else:
        scn0 = reference_scenario(cfg, device=dev)
        scns = replicate_scenario(scn0, batch)
    if engine == "vmap":
        run = batched.make_batched_solver(cfg, basis, solver=solver)
    else:
        run = fleet.make_fleet_solver(cfg, basis, solver=solver,
                                      backend=backend)

    def run_to_completion():
        out = run(scns)
        _sync(dev)
        return out

    t0 = time.perf_counter()
    warm = run_to_completion()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_to_completion()
        times.append(time.perf_counter() - t0)

    timing = {"first_s": first_s, "times_s": times, "batch": batch}
    gate = None
    if random_scenarios:
        mean_cost = float(warm.stats.final_cost.mean())
        conv_frac = float(warm.stats.converged.float().mean())
        quality_ok = math.isfinite(mean_cost)
        quality = {
            "scenarios": "random",
            "converged_frac": round(conv_frac, 4),
            "mean_final_cost": round(mean_cost, 4),
        }
        n_check = min(batch, quality_check_lanes)
        if n_check and (backend != "xla" or engine == "vmap"):
            gate = paired_gate(cfg, basis, scns, warm, n_check, solver)
            quality_ok = quality_ok and gate["ok"]
            quality.update(gate["fields"])
            timing["xla_s"] = gate["xla_s"]
    else:
        q = solution_quality(cfg, basis, scn0, warm.alpha[0])
        avg_cost, max_cost = float(q["avg_cost"]), float(q["max_cost"])
        endpoint_err = float(q["endpoint_err"])
        ref_avg, ref_max = REFERENCE_FINAL_COST[solver]
        quality_ok = (
            avg_cost <= ref_avg * (1.0 + quality_tol)
            and max_cost <= ref_max * (1.0 + quality_tol)
            and endpoint_err < endpoint_bound(cfg, solver)
        )
        quality = {
            "avg_cost": round(avg_cost, 4),
            "max_cost": round(max_cost, 4),
            "ref_avg_cost": round(ref_avg, 4),
            "ref_max_cost": round(ref_max, 4),
            "endpoint_err": round(endpoint_err, 4),
        }
    best = min(times)
    solves_per_sec = batch / best
    if dev.type == "cuda":
        name, power = gpu_name_and_power_limit()
    else:
        name, power = "cpu", None
    return {
        # A CPU rehearsal never reports under the device metric's name.
        "metric": (f"{solver}_solves_per_sec_per_chip" if dev.type == "cuda"
                   else f"{solver}_solves_per_sec_cpu_rehearsal"),
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec * REF_SOLVE_SECONDS[solver], 2),
        "quality_ok": bool(quality_ok),
        **quality,
        "device": name,
        "power_limit": power,
        "timing": timing,
        "gate": gate,
        "result": warm,
    }


def endpoint_bound(cfg: PlannerConfig, solver: str) -> float:
    if solver == "gd":
        return GD_ENDPOINT_BOUND
    return (cfg.eps_position if cfg.ladder_eval == "linearized"
            else EXACT_ENDPOINT_BOUND)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1048576)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--engine", choices=["fleet", "vmap"], default="fleet",
                   help="fleet = lanes trailing, the kernels of --backend; "
                        "vmap = the single-scene solver lane by lane (plain "
                        "PyTorch)")
    p.add_argument("--inner", type=int, default=None,
                   help="UNIFORM fixed inner steps per penalty round in "
                        "place of the per-round schedule")
    p.add_argument("--ladder-eval", choices=["linearized", "exact"],
                   default="linearized",
                   help="BLS: Armijo candidates on the linearized trajectory "
                        "(the default) or through the basis (exact)")
    p.add_argument("--backend", choices=["fused", "pallas", "xla"],
                   default="fused",
                   help="fused = the whole-solve kernels (K1, or K2 per "
                        "round with lane compaction), pallas = the per-step "
                        "kernels, xla = the plain engine; each runs both "
                        "solvers")
    p.add_argument("--block-b", type=int, default=0,
                   help="fused backend: lanes (warps) per CTA, 1-16 (0: 16); "
                        "pallas backend: threads per CTA, one warp per lane, "
                        "32-512 in whole warps (0: 512)")
    p.add_argument("--max-obstacles", type=int, default=11)
    p.add_argument("--quality-tol", type=float, default=0.02)
    p.add_argument("--random-scenarios", action="store_true",
                   help="every lane its own random scene (heterogeneous "
                        "fleet), gated against the plain xla engine")
    p.add_argument("--seed", type=int, default=0,
                   help="random-scene seed (--random-scenarios only)")
    p.add_argument("--quality-check-lanes", type=int, default=32768,
                   help="random scenes: lanes the paired xla check solves "
                        "again (0: finiteness-only gate)")
    p.add_argument("--lane-compaction",
                   type=lambda x: str(x).lower() == "true", default=None,
                   help="per-round kernel launches with the lanes re-sorted "
                        "after round 0 (per-lane results unchanged; fused "
                        "backend only); default: on with --random-scenarios "
                        "on the fused backend")
    p.add_argument("--device", default="cuda",
                   help="cuda (the benchmark) or cpu (the plain versions, "
                        "for rehearsal at a small batch)")
    args = p.parse_args(argv)
    out = run_bench(args.batch, args.repeats, args.block_b,
                    args.max_obstacles, args.quality_tol, args.device,
                    args.random_scenarios, args.seed,
                    args.quality_check_lanes, args.lane_compaction,
                    args.solver, args.backend, args.ladder_eval,
                    engine=args.engine, inner=args.inner)
    timing = out.pop("timing")
    out.pop("result")
    out.pop("gate")
    print(json.dumps(out))
    best = min(timing["times_s"])
    if args.random_scenarios:
        verdict = (f"random scenes: converged_frac={out['converged_frac']} "
                   f"mean_final_cost={out['mean_final_cost']}")
        if "paired_check_lanes" in out:
            verdict += (
                f" | paired xla check on {out['paired_check_lanes']} lanes "
                f"({timing['xla_s']:.1f}s): conv vs {out['xla_converged_frac']}"
                f", obstacle cost {out['mean_obstacle_cost']} vs "
                f"{out['xla_mean_obstacle_cost']}, phantom_frac "
                f"{out['phantom_frac']}")
    else:
        bound = endpoint_bound(bench_config(ladder_eval=args.ladder_eval),
                               args.solver)
        verdict = (
            f"avg={out['avg_cost']} max={out['max_cost']} "
            f"endpoint={out['endpoint_err']} (gate: within "
            f"{args.quality_tol:.0%} of {out['ref_avg_cost']}/"
            f"{out['ref_max_cost']}, endpoint < {bound})")
    print(
        f"# batch={args.batch} best={best * 1e3:.1f}ms "
        f"first(build+run)={timing['first_s']:.1f}s "
        f"per-solve={1e6 * best / args.batch:.3f}us device={out['device']} "
        f"power_limit={out['power_limit']} "
        f"quality[{'PASS' if out['quality_ok'] else 'FAIL'}]: " + verdict,
        file=sys.stderr,
    )
    return 0 if out["quality_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
