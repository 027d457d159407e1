"""Converged fractions of the four BLS engines on the same random scenes.

    JAX_PLATFORMS=cpu python tools/compare_converged.py [--T 200] \\
        [--scenes 512] [--chunk 64] [--ladder-eval linearized] [--seed 0]

On the CPU, with the bench's BLS schedule (REFERENCE_INNER_SCHEDULE_BLS,
``max_obstacles=11``) at T (a committed basis export) and the port's random
scenes of ``--seed``: the JAX package's fused kernel (interpreted, in chunks of
``--chunk`` lanes, ``recip_newton=True``) and its xla engine, and the
port's fused backend (the plain K1) and xla engine.  Prints the converged
count of each, per chunk and in all.  bench.py's paired gate holds a fused
run's converged fraction within max(0.02, min(0.15 max(conv), 0.05)) of
the xla engine's.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402

import irm_motion_planning_tpu as mp  # noqa: E402
from irm_motion_planning_tpu.solvers import fleet as jfleet  # noqa: E402
import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch import bench  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--scenes", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--ladder-eval", default="linearized")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    cfg = bench.bench_config(n_timesteps=a.T, ladder_eval=a.ladder_eval)
    jcfg = mp.PlannerConfig(
        n_timesteps=a.T, bls_mode="ladder", fixed_iters=True,
        inner_schedule=cfg.inner_schedule,
        max_inner_iteration=cfg.max_inner_iteration, max_obstacles=11,
        ladder_eval=a.ladder_eval, recip_newton=True, pallas_block_b=a.chunk)
    jb = mp.make_basis(jcfg)
    tb = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(a.seed),
                               a.scenes, device="cpu")
    names = ("JAX fused", "JAX xla", "port fused", "port xla")
    total = np.zeros(4, dtype=int)
    for lo in range(0, a.scenes, a.chunk):
        sub = mt.Scenario(*(x[lo:lo + a.chunk] for x in scns))
        js = mp.Scenario(*(jnp.asarray(x.numpy()) for x in sub))
        runs = (
            jfleet.fleet_solve(jcfg, jb, js, backend="fused", interpret=True),
            jfleet.fleet_solve(jcfg, jb, js, backend="xla"),
            tfleet.fleet_solve(cfg, tb, sub, backend="fused"),
            tfleet.fleet_solve(cfg, tb, sub, backend="xla"),
        )
        counts = [int(np.asarray(r.stats.converged).sum()) for r in runs]
        total += counts
        print(f"scenes {lo}-{lo + a.chunk - 1}: "
              + ", ".join(f"{n} {c}" for n, c in zip(names, counts)),
              flush=True)
    print(f"T={a.T} {a.ladder_eval}, {a.scenes} scenes of seed {a.seed}, "
          f"converged: "
          + ", ".join(f"{n} {c} ({c / a.scenes:.4f})"
                      for n, c in zip(names, total)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
