"""Receding-horizon replanning benchmark of the port (counterpart of
benchmarks/replan.py).

The reference's headline capability is 50 Hz single-scene replanning on a
CPU (ref: DevBlog blog-post.html:232,350).  The protocol, as the JAX
benchmark's:

* ``PlannerConfig(bls_mode="ladder")``: 16 obstacle slots, early exit;
* 100 ticks of the reference scene with its obstacles drifting
  sinusoidally (runtime data, nothing is rebuilt);
* every tick warm-started from the last, under a budget of 2 rounds x 25
  inner steps (solvers/replan.Replanner);
* one scene, and a fleet of ``--batch`` (256) scenes replanned together.

The first tick is a warm-up and is not timed (it builds the kernels on the
card); every timed tick ends with ``torch.cuda.synchronize()``, so its time
is a latency.  ``--rollout true`` also times ``Replanner.plan_rollout``
(the ticks of a rollout handed over at once).  Prints one JSON line per
mode: Hz, ms per tick (mean, median, p99, the slowest and which tick) and
the mean final cost of the ticks.

    python -m irm_motion_planning_tpu_torch.benchmarks.replan [--ticks 100]
        [--batch 256] [--engine fleet|vmap] [--backend fused|pallas|xla]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import PlannerConfig, reference_scenario, replicate_scenario
from ..ops.scenario import Scenario
from ..solvers.replan import Replanner
from ..utils.timing import sync

REF_REPLAN_HZ = 50.0  # DevBlog blog-post.html:232,350
BUDGET_OUTER, BUDGET_INNER = 2, 25


def bench_config() -> PlannerConfig:
    return PlannerConfig(bls_mode="ladder")


def drift_obstacles(scn: Scenario, tick: int, amp: float = 0.15) -> Scenario:
    """The obstacles of tick ``tick``: a sinusoidal drift, a phase per
    obstacle (benchmarks/replan.py's)."""
    n = scn.obstacles.shape[-2]
    phase = np.arange(n)[:, None] * 0.7
    t = tick * 0.1
    delta = amp * np.stack(
        [np.sin(t + phase[:, 0]), np.cos(1.3 * t + phase[:, 0])], axis=-1
    ).astype(np.float32)
    delta = torch.as_tensor(delta, device=scn.obstacles.device)
    return scn._replace(obstacles=scn.obstacles + delta)


def stack_ticks(scn: Scenario, ticks: int) -> Scenario:
    """Ticks 1..ticks stacked on a leading tick axis."""
    per_tick = [drift_obstacles(scn, k) for k in range(1, ticks + 1)]
    return Scenario(*(torch.stack(xs) for xs in zip(*per_tick)))


def make_replanner(cfg, batched, engine, backend, device,
                   solver="bls") -> Replanner:
    return Replanner(cfg, budget_outer=BUDGET_OUTER,
                     budget_inner=BUDGET_INNER, solver=solver,
                     batched=batched, engine=engine, backend=backend,
                     device=device)


def summary(tick_s, costs) -> dict:
    ms = 1e3 * np.asarray(tick_s)
    return {
        "value": float(len(ms) / (ms.sum() / 1e3)), "unit": "Hz",
        "tick_ms": float(ms.mean()),
        "tick_ms_median": float(np.median(ms)),
        "tick_ms_p99": float(np.percentile(ms, 99)),
        "tick_ms_max": float(ms.max()),
        "slowest_tick": int(ms.argmax()) + 1,
        "mean_tick_cost": float(np.mean(costs)),
    }


def run_mode(cfg, scn, ticks, batched, engine="fleet", backend="fused",
             device=None, replanner=None):
    """The tick loop: one warm-up tick (tick 0), then ticks 1..ticks timed
    one by one.  Returns (summary fields, the replanner, the last result)."""
    rp = replanner or make_replanner(cfg, batched, engine, backend, device)
    rp.plan(drift_obstacles(scn, 0))
    sync()
    tick_s, costs = [], []
    res = None
    for k in range(1, ticks + 1):
        t0 = time.perf_counter()
        res = rp.plan(drift_obstacles(scn, k))
        sync()
        tick_s.append(time.perf_counter() - t0)
        costs.append(float(res.stats.final_cost.float().mean()))
    return summary(tick_s, costs), rp, res


def run_rollout(cfg, scn, ticks, batched, engine="fleet", backend="fused",
                device=None):
    """The whole rollout in one plan_rollout call, after a warm-up rollout
    and a reset (the same ticks, so the same work)."""
    rp = make_replanner(cfg, batched, engine, backend, device)
    scn_ticks = stack_ticks(scn, ticks)
    rp.plan_rollout(scn_ticks)
    sync()
    rp.reset()
    t0 = time.perf_counter()
    alpha, stats = rp.plan_rollout(scn_ticks)
    sync()
    dt = time.perf_counter() - t0
    return {"value": ticks / dt, "unit": "Hz", "tick_ms": 1e3 * dt / ticks,
            "mean_tick_cost": float(stats.final_cost.float().mean())}, alpha


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ticks", type=int, default=100)
    p.add_argument("--batch", type=int, default=256,
                   help="fleet size of the batched mode (0: skip it)")
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--engine", choices=["fleet", "vmap"], default="fleet",
                   help="fleet = the fleet engine (one scene padded to 128 "
                        "lanes); vmap = the single-scene solver")
    p.add_argument("--backend", choices=["fused", "pallas", "xla"],
                   default="fused",
                   help="the fleet engine's backend (fused: the whole-solve "
                        "kernel K1 on the card)")
    p.add_argument("--rollout", type=lambda x: str(x).lower() == "true",
                   default=True, help="also time plan_rollout")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs on a GPU "
                           "(--device cpu rehearses the plain versions)")

    cfg = bench_config()
    scn1 = reference_scenario(cfg, device=device)
    kw = dict(engine=args.engine, backend=args.backend, device=device)
    common = {"engine": args.engine, "backend": args.backend,
              "device": torch.cuda.get_device_name(0) if device == "cuda"
              else "cpu"}

    out, _, _ = run_mode(cfg, scn1, args.ticks, batched=False, **kw)
    print(json.dumps({"metric": "replan_rate_single_scene", **out,
                      "vs_reference_50hz": out["value"] / REF_REPLAN_HZ,
                      **common}))
    if args.rollout:
        out, _ = run_rollout(cfg, scn1, args.ticks, batched=False, **kw)
        print(json.dumps({"metric": "replan_rate_single_scene_rollout",
                          **out, "vs_reference_50hz":
                          out["value"] / REF_REPLAN_HZ, **common}))
    if args.batch > 0:
        scnB = replicate_scenario(scn1, args.batch)
        out, _, _ = run_mode(cfg, scnB, args.ticks, batched=True, **kw)
        print(json.dumps({"metric": "replan_rate_fleet", "batch": args.batch,
                          **out, "plans_per_sec": out["value"] * args.batch,
                          **common}))
        if args.rollout:
            out, _ = run_rollout(cfg, scnB, args.ticks, batched=True, **kw)
            print(json.dumps({"metric": "replan_rate_fleet_rollout",
                              "batch": args.batch, **out, "plans_per_sec":
                              out["value"] * args.batch, **common}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
