"""Statistical certification of the final cost against the sequential BLS
oracle (the port of benchmarks/certify.py): both phases, both ladder tiers,
three backends.

The oracle is the port's sequential BLS solver (``bls_mode="sequential"``,
solvers/bls.py ``solve_batch``: every lane equals its solve alone, bit for
bit) on random scenes at the same iteration horizon as the engine: the
bench's per-round schedule (``--stopping schedule``, the default) or the
reference's own early exit (``early_exit``).  The engine phase solves the
oracle's scenes with each ladder tier (``--tiers exact,linearized``) on
``--backend`` (fused with lane compaction, as the JAX script runs it;
pallas; xla) and compares each scene's final avg/max unpenalized obstacle
cost with the oracle's, conditioned on the outcome:

  * the converged fraction may fall at most CONV_SLACK below the oracle's;
  * on the scenes both converged, the mean gap of avg and max cost within
    the tier's MEAN_BOUNDS and the median gap within its MEDIAN_BOUNDS;
  * the scenes neither converged, each side alone, and all scenes are
    reported for the record.

The bounds are benchmarks/certify.py's, calibrated for an oracle and an
engine on one platform: the port's oracle on the card against the card's
engine is the certification; the JAX package's stored oracles
(``certify_oracle_cpu2048.npz``, ``certify_oracle_tpu2048.npz``) are read
the same way and are informative (the port's sequential BLS does not give
the reference's bits: ROADMAP queue 3, fact 7).  The oracle file has JAX's
keys and dtypes, so either side's engine phase reads either side's oracle.

    # phase 1: the oracle (on the card by default, all scenes in one batch)
    python -m irm_motion_planning_tpu_torch.benchmarks.certify \\
        --phase oracle --batch 2048 --out certify_oracle.npz
    # phase 2: the engine against it
    python -m irm_motion_planning_tpu_torch.benchmarks.certify \\
        --phase engine --oracle certify_oracle.npz --backend fused \\
        --tiers exact,linearized

The engine phase exits 0 only if every tier passes.  ``--block-b``: lanes
per CTA on ``fused``, threads per CTA on ``pallas`` (0: each kernel's
default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import PlannerConfig, REFERENCE_INNER_SCHEDULE_BLS
from ..models.rkhs import make_basis
from ..ops.scenario import Scenario, random_scenarios
from ..solvers import bls, fleet
from . import _harness

# benchmarks/certify.py's bounds: the both-converged mean gap (avg and max
# cost) per tier, the both-converged median gap per tier, and the
# converged-fraction slack.
MEAN_BOUNDS = {"exact": 0.0025, "linearized": 0.02}
MEDIAN_BOUNDS = {"exact": 0.001, "linearized": 0.002}
CONV_SLACK = 0.06
SCENE_KEYS = ("start", "goal", "obstacles", "obstacle_weight")


def sched_kw(stopping: str) -> dict:
    """The iteration horizon: the bench's per-round BLS schedule, or the
    reference's early exit."""
    if stopping == "schedule":
        sched = REFERENCE_INNER_SCHEDULE_BLS
        return dict(fixed_iters=True, inner_schedule=sched,
                    max_inner_iteration=max(sched))
    return dict(fixed_iters=False)


def scene_costs(cfg: PlannerConfig, basis, scns: Scenario, alpha):
    """Each scene's final avg and max unpenalized obstacle cost (the
    reference's own report) of the solve alpha (B, T, J), as float64
    numpy."""
    return tuple(
        fleet.unpenalized_cost(cfg, basis, scns, alpha, lam)
        .double().cpu().numpy() for lam in (0.0, 1.0))


def oracle_config(max_obstacles: int = 11,
                  stopping: str = "schedule") -> PlannerConfig:
    """The oracle's configuration: the sequential BLS solver at the
    horizon ``stopping``."""
    return PlannerConfig(bls_mode="sequential", max_obstacles=max_obstacles,
                         **sched_kw(stopping))


def oracle_solve(cfg: PlannerConfig, basis, scns: Scenario,
                 chunk: int = 0) -> tuple:
    """(avg, max, conv) of the sequential BLS solve of every scene of
    ``scns`` (leading batch), in one batch or in chunks of ``chunk`` scenes
    with a progress line after each (each lane's result does not depend on
    its batch)."""
    batch = scns.start.shape[0]
    chunk = chunk or batch
    avg, mx, conv = [], [], []
    t0 = time.perf_counter()
    for i in range(0, batch, chunk):
        part = Scenario(*(x[i:i + chunk] for x in scns))
        res = bls.solve_batch(cfg, basis, part)
        a, m = scene_costs(cfg, basis, part, res.alpha)
        avg.append(a)
        mx.append(m)
        conv.append(res.stats.converged.cpu().numpy())
        if chunk < batch:
            el = time.perf_counter() - t0
            done = min(i + chunk, batch)
            print(f"# oracle {done}/{batch} ({el:.0f}s, {done / el:.1f} "
                  f"scenes/s)", file=sys.stderr, flush=True)
    return tuple(np.concatenate(x) for x in (avg, mx, conv))


def run_oracle(batch: int = 8192, seed: int = 0, max_obstacles: int = 11,
               stopping: str = "schedule", out: str = "certify_oracle.npz",
               device="cuda", progress: bool = False) -> dict:
    """The oracle phase: :func:`oracle_solve` of ``batch`` random scenes
    (seed ``seed``; with ``progress``, in chunks of 512); writes the oracle
    file ``out`` (JAX's keys and dtypes) and returns the JSON line's
    fields."""
    dev = torch.device(device)
    cfg = oracle_config(max_obstacles, stopping)
    basis = make_basis(cfg, device=dev)
    scns = random_scenarios(cfg, torch.Generator().manual_seed(seed), batch,
                            device=dev)
    t0 = time.perf_counter()
    avg, mx, conv = oracle_solve(cfg, basis, scns, 512 if progress else 0)
    elapsed = time.perf_counter() - t0
    np.savez(out, seed=seed, batch=batch, max_obstacles=max_obstacles,
             stopping=stopping, avg=avg, max=mx, conv=conv,
             **{k: getattr(scns, k).cpu().numpy() for k in SCENE_KEYS})
    return {
        "phase": "oracle", "batch": batch, "seed": seed,
        "stopping": stopping,
        "converged_frac": round(float(conv.mean()), 4),
        "avg_cost_mean": round(float(avg.mean()), 6),
        "max_cost_mean": round(float(mx.mean()), 6),
        "nonfinite": int((~np.isfinite(avg)).sum()),
        "elapsed_s": round(elapsed, 1),
        "out": out,
    }


def gap_stats(ours, ref, mask) -> dict:
    """Paired per-scene relative gap statistics on the masked scenes
    (positive: worse than the oracle); 95% CI, normal approximation."""
    g = (ours[mask] - ref[mask]) / ref[mask]
    n = int(g.size)
    if n == 0:
        return {"n": 0}
    mean = float(g.mean())
    sd = float(g.std(ddof=1)) if n > 1 else 0.0
    half = 1.96 * sd / np.sqrt(n)
    return {
        "n": n,
        "mean_gap": round(mean, 6),
        "ci95": [round(mean - half, 6), round(mean + half, 6)],
        "p50_gap": round(float(np.percentile(g, 50)), 6),
        "p90_gap": round(float(np.percentile(g, 90)), 6),
        "frac_better": round(float((g < 0).mean()), 4),
    }


def engine_config(data, tier: str, backend: str,
                  block_b: int = 0) -> PlannerConfig:
    """The engine configuration of ``tier`` on the oracle ``data``: its
    obstacle slots and its horizon, lane compaction on the fused backend."""
    return PlannerConfig(bls_mode="ladder",
                         max_obstacles=int(data["max_obstacles"]),
                         ladder_eval=tier, pallas_block_b=block_b,
                         lane_compaction=backend == "fused",
                         **sched_kw(str(data["stopping"])))


def oracle_scenes(data, device) -> Scenario:
    return Scenario(*(torch.as_tensor(np.asarray(data[k]),
                                      dtype=torch.float32, device=device)
                      for k in SCENE_KEYS))


def passes(tier: str, ec, oc, bc: dict) -> bool:
    """The pass rule: the converged fraction at most CONV_SLACK below the
    oracle's, and on the both-converged scenes the mean gaps (avg, max)
    within the tier's mean bound and the median gaps within its median
    bound (no such scene fails)."""
    return bool(
        ec.mean() >= oc.mean() - CONV_SLACK
        and bc["avg"].get("mean_gap", 1) <= MEAN_BOUNDS[tier]
        and bc["max"].get("mean_gap", 1) <= MEAN_BOUNDS[tier]
        and abs(bc["avg"].get("p50_gap", 1)) <= MEDIAN_BOUNDS[tier]
        and abs(bc["max"].get("p50_gap", 1)) <= MEDIAN_BOUNDS[tier]
    )


def engine_row(data, tier: str, backend: str = "fused", device="cuda",
               block_b: int = 0) -> dict:
    """Solve the oracle's scenes with the BLS ladder tier ``tier`` on
    ``backend`` and compare them with the oracle: certify.py's row of the
    tier, with ``pass``."""
    dev = torch.device(device)
    cfg = engine_config(data, tier, backend, block_b)
    basis = make_basis(cfg, device=dev)
    scns = oracle_scenes(data, dev)
    res = fleet.fleet_solve(cfg, basis, scns, solver="bls", backend=backend)
    avg, mx = scene_costs(cfg, basis, scns, res.alpha)
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
        "tier": tier, "backend": backend, "batch": int(data["batch"]),
        "stopping": str(data["stopping"]),
        "nonfinite_excluded": int((~finite).sum()),
        "oracle_converged_frac": round(float(oc.mean()), 4),
        "engine_converged_frac": round(float(ec.mean()), 4),
    }
    for name, mask in classes.items():
        row[name] = {"avg": gap_stats(avg, ref_avg, mask),
                     "max": gap_stats(mx, ref_mx, mask)}
    row["pass"] = passes(tier, ec, oc, row["both_converged"])
    return row


def certify_exact(data, device) -> dict:
    """The exact tier on the fused backend (with lane compaction) against
    the oracle ``data``: :func:`engine_row`'s row."""
    return engine_row(data, "exact", "fused", device)


def run_engine(oracle: str, backend: str = "fused",
               tiers=("exact", "linearized"), block_b: int = 0,
               device="cuda") -> dict:
    """The engine phase against the oracle file ``oracle``: one row per
    tier (each also printed to stderr) and the verdict line's fields."""
    dev = torch.device(device)
    data = np.load(oracle)
    rows, ok = {}, True
    for tier in tiers:
        rows[tier] = engine_row(data, tier, backend, dev, block_b)
        ok = ok and rows[tier]["pass"]
        print(json.dumps(rows[tier]), file=sys.stderr, flush=True)
    return {
        "metric": "final_cost_gap_certification",
        "oracle": "sequential BLS at the same iteration horizon "
                  f"({oracle})",
        "platform": _harness.platform(dev),
        "mean_bounds": MEAN_BOUNDS, "median_bounds": MEDIAN_BOUNDS,
        "tiers": rows,
        "pass": ok,
        **_harness.card(dev),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phase", choices=["oracle", "engine"], required=True)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-obstacles", type=int, default=11)
    p.add_argument("--out", default="certify_oracle.npz")
    p.add_argument("--oracle", default="certify_oracle.npz")
    p.add_argument("--backend", choices=["fused", "pallas", "xla"],
                   default="fused")
    p.add_argument("--tiers", default="exact,linearized")
    p.add_argument("--block-b", type=int, default=0,
                   help="fused: lanes per CTA (0: 16); pallas: threads per "
                        "CTA (0: 512)")
    p.add_argument("--stopping", choices=["schedule", "early_exit"],
                   default="schedule",
                   help="schedule: the bench's fixed per-round horizon (the "
                        "default); early_exit: the reference's own stopping")
    p.add_argument("--progress", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _harness.open_device(args.device, "certify")
    if args.phase == "oracle":
        out = run_oracle(args.batch, args.seed, args.max_obstacles,
                         args.stopping, args.out, dev, args.progress)
        print(json.dumps({**out, **_harness.card(dev)}), flush=True)
        return 0
    out = run_engine(args.oracle, args.backend, args.tiers.split(","),
                     args.block_b, dev)
    print(json.dumps(out), flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
