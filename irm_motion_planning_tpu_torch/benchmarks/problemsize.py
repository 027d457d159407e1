"""Problem-size scaling of the port: time per solve against the number of
support timesteps T (the port of benchmarks/problemsize.py).

    python -m irm_motion_planning_tpu_torch.benchmarks.problemsize \\
        [--sizes 25,50,100,150,200] [--batch 4096] [--repeats 5] \\
        [--solver bls|gd] [--backend xla|fused|pallas] [--inner 15] \\
        [--device cuda|cpu]

The reference's published scaling study (DevBlog blog-post.html:445-454:
linear to about 100 support points, then quadratic, as the T x T Gram
products take over).  For each T: the default config at that T with
``fixed_iters`` and ``--inner`` steps in each of the 10 penalty rounds, the
committed basis export of that T (``make_basis``; T = 25, 50, 100, 150 and
200 are committed), the reference scene replicated over ``--batch`` lanes,
one untimed run (which builds the kernels), then ``--repeats`` timed runs,
each ended by ``torch.cuda.synchronize()``; the best counts.

Prints one JSON line per size to stderr (``n_timesteps``, ``per_solve_us``,
``solves_per_sec``, ``compile_s``: the untimed first run, and ``launches``:
the kernel launches of the timed runs, K1 (``fused_solve``) and K2
(``fused_round``) on the fused backend, K3-K6 on the pallas backend, none on
xla; K1/K2's launch plan beside them) and a summary line to stdout.  On the
fused and pallas backends a T past the kernels' plan runs the xla engine
with a warning and no launch, as fleet_solve does; past the streamed
plan's ceiling the plan is the reach plan (``"plan": "reach"``).
``--device cpu`` runs
the plain versions, a rehearsal whose times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import (PlannerConfig, make_basis, reference_scenario,
               replicate_scenario)
from ..ops import fused_solve as fs
from ..ops import step_kernels as sk
from ..solvers import fleet

KERNELS = {
    "fused": (fs.fused_solve, fs.fused_round),
    "pallas": (sk.bls_inner_step, sk.gd_inner_step, sk.cost_grad_eval,
               sk.forward_eval),
    "xla": (),
}


def size_config(T: int, inner: int) -> PlannerConfig:
    """benchmarks/problemsize.py's config at T (its :58-61)."""
    return PlannerConfig(n_timesteps=T, bls_mode="ladder", fixed_iters=True,
                         max_inner_iteration=inner, pallas_block_b=0)


def run_size(T: int, batch: int, repeats: int, solver: str, backend: str,
             inner: int, device: torch.device) -> dict:
    """One point of the sweep: the JSON fields of its line."""
    cfg = size_config(T, inner)
    basis = make_basis(cfg, device=device)
    scns = replicate_scenario(reference_scenario(cfg, device=device), batch)
    run = fleet.make_fleet_solver(cfg, basis, solver=solver, backend=backend)

    def run_to_completion():
        out = run(scns)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return float(out.stats.final_cost.sum())

    t0 = time.perf_counter()
    run_to_completion()
    compile_s = time.perf_counter() - t0
    before = {k.__name__: k.launches for k in KERNELS[backend]}
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_to_completion()
        times.append(time.perf_counter() - t0)
    best = min(times)
    plan = fs.kernel_plan(cfg, cfg.max_obstacles, solver)
    return {
        "n_timesteps": T,
        "per_solve_us": round(1e6 * best / batch, 2),
        "solves_per_sec": round(batch / best, 1),
        "compile_s": round(compile_s, 1),
        "launches": {k.__name__: k.launches - before[k.__name__]
                     for k in KERNELS[backend]},
        "plan": plan and {"plan": plan["plan"], "lanes": plan["lanes"],
                          "warps": plan["warps"],
                          "smem_bytes": plan["total"]},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", default="25,50,100,150,200")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--backend", choices=["fused", "pallas", "xla"],
                   default="xla",
                   help="xla (the plain engine) by default, as "
                        "benchmarks/problemsize.py; fused = K1, pallas = "
                        "K3-K6")
    p.add_argument("--inner", type=int, default=15)
    p.add_argument("--device", default="cuda",
                   help="cuda (the measurement) or cpu (the plain versions, "
                        "a rehearsal at a small batch)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("problemsize: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for T in (int(s) for s in args.sizes.split(",")):
        rows.append(run_size(T, args.batch, args.repeats, args.solver,
                             args.backend, args.inner, device))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    summary = {
        "metric": "problem_size_scaling",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "batch": args.batch,
        "backend": args.backend,
        "points": rows,
    }
    if device.type == "cuda":
        from ..bench import gpu_name_and_power_limit

        summary["device"], summary["power_limit"] = gpu_name_and_power_limit()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
