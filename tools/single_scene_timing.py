"""What the single-scene engines' warm start and basis products cost on
the card.

    python tools/single_scene_timing.py [--T 50,200,2048] [--scenes 2048] \\
        [--ticks 20] [--vmap 65536] [--device cuda]

Uses only the package's public entry points, so the same script times any
commit of the port (run it from that commit's root):

* ``init_alpha`` of one scene and of ``--scenes`` random scenes at each T
  (the committed exports at T = 50 and 200, any other T built by
  ``build_basis``), the best of three calls after one warm-up call;
* the replanner's first tick (``Replanner(engine="fleet",
  backend="fused")``, replan_bench's budgets: the warm start's
  ``init_alpha``, then one K1 launch) on a fresh replanner after a warm-up
  one, against the median of the ``--ticks`` ticks that follow (the
  reference scene, its obstacles drifting as in replan_bench);
* with ``--vmap N``: N random scenes at T = 50 under the bench's config
  (``bench.bench_config``: the ladder and the BLS schedule) through the
  ``vmap`` engine (``batched.solve_batch``) and through the single-scene
  solver's batch (``bls.solve_batch``), one run each after a warm-up on 256
  scenes: solves per second, converged fraction and peak device memory.

Prints the card's name and power limit, one line per measurement, then
one JSON line with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.getcwd() if os.path.isdir(
    os.path.join(os.getcwd(), "irm_motion_planning_tpu_torch")) else ROOT)

import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch import bench  # noqa: E402
from irm_motion_planning_tpu_torch.benchmarks import replan  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import batched, bls  # noqa: E402


def _ms(fn, dev, repeats=3):
    """fn() once to warm up, then the best of ``repeats`` timed calls (ms)."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def time_init_alpha(T, n, dev) -> dict:
    cfg = mt.PlannerConfig(n_timesteps=T)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), n,
                               device=dev)
    return {
        "one_ms": _ms(lambda: mt.init_alpha(cfg, basis, scns.start[0],
                                            scns.goal[0]), dev),
        "batch_ms": _ms(lambda: mt.init_alpha(cfg, basis, scns.start,
                                              scns.goal), dev),
        "scenes": n,
    }


def time_first_tick(T, ticks, dev) -> dict:
    cfg = replan.bench_config().replace(n_timesteps=T)
    scn = mt.reference_scenario(cfg, device=dev)
    warm = replan.make_replanner(cfg, False, "fleet", "fused", dev)
    warm.plan(replan.drift_obstacles(scn, 0))
    torch.cuda.synchronize(dev)
    rp = replan.make_replanner(cfg, False, "fleet", "fused", dev)
    tick_ms = []
    for k in range(ticks + 1):
        scn_k = replan.drift_obstacles(scn, k)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rp.plan(scn_k)
        torch.cuda.synchronize(dev)
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    return {"first_tick_ms": tick_ms[0],
            "median_tick_ms": float(np.median(tick_ms[1:]))}


def time_vmap(n, dev) -> dict:
    cfg = bench.bench_config()
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), n,
                               device=dev)
    small = mt.Scenario(*(x[:256] for x in scns))
    out = {}
    for name, solve in (("vmap_engine", batched.solve_batch),
                        ("bls_solve_batch", bls.solve_batch)):
        solve(cfg, basis, small)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = solve(cfg, basis, scns)
        torch.cuda.synchronize(dev)
        s = time.perf_counter() - t0
        out[name] = {
            "scenes": n, "s": s, "solves_per_sec": n / s,
            "converged": float(res.stats.converged.float().mean()),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", default="50,200,2048")
    ap.add_argument("--scenes", type=int, default=2048)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--vmap", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(f"card: {card[dev.index or 0] if card else 'unknown'}")
    result = {"card": card, "tree": os.getcwd(), "T": {}}
    for T in (int(t) for t in args.T.split(",")):
        t0 = time.perf_counter()
        row = {"init_alpha": time_init_alpha(T, args.scenes, dev),
               "replan": time_first_tick(T, args.ticks, dev)}
        ia, rp = row["init_alpha"], row["replan"]
        print(f"T={T}: init_alpha {ia['one_ms']:.3f} ms for one scene, "
              f"{ia['batch_ms']:.3f} ms for {ia['scenes']}; replanner first "
              f"tick {rp['first_tick_ms']:.3f} ms against a median tick of "
              f"{rp['median_tick_ms']:.3f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        result["T"][T] = row
    if args.vmap:
        result["vmap"] = time_vmap(args.vmap, dev)
        for name, row in result["vmap"].items():
            print(f"{name} at {row['scenes']} random scenes: "
                  f"{row['solves_per_sec']:.1f} solves/s ({row['s']:.2f} s),"
                  f" converged {row['converged']:.4f}, peak "
                  f"{row['peak_gib']:.3f} GiB", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
