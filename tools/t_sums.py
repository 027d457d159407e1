"""Time the plain versions' sums over T in three orders on one device.

    python tools/t_sums.py [--device cuda] [--T 200] [--batch 8192]

The plain K1 (``fused_solve_reference``, the linearized program) on
``--batch`` random scenes (seed 0) at 2 rounds x 6 steps, its loss's sums
over T (``fused_solve.t_sums``) taken three ways, each run twice in turns
(chain, sum0, rows, rows, sum0, chain), the best of each kept:

* ``rows``: the shipped order (``fused_solve.t_sums``), each lane's row
  made contiguous, padded with zeros to a multiple of 4 and summed by
  ``sum(-1)``, which does not depend on the lane's position;
* ``chain``: the kernels' order, each lane's sequential chain ((0 + x_0) +
  x_1) + ... (``fused_solve.chain_sum``: T elementwise adds of the K
  planes' lanes);
* ``sum0``: torch's ``sum(0)`` of each (T, B) plane, the order before,
  which blocks the lanes, so a lane's sum may depend on its position in
  the batch.

Prints one JSON line: the device, the card's name and power limit, the ms
of each and each one's ratio to ``sum0``, and whether each order gives a
permuted batch's losses bit for bit (the first 1,000 lanes reversed).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch.ops import fused_solve as fs  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import fleet  # noqa: E402

ORDERS = {
    "rows": fs.t_sums,
    "chain": lambda planes: fs.chain_sum(torch.stack(planes, dim=1)),
    "sum0": lambda planes: torch.stack([p.sum(0) for p in planes]),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--T", type=int, default=200)
    p.add_argument("--batch", type=int, default=8192)
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("t_sums: no CUDA device", file=sys.stderr)
        return 2
    cfg = mt.PlannerConfig(n_timesteps=a.T, max_outer_iteration=2,
                           max_inner_iteration=6, fixed_iters=True,
                           max_obstacles=11)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0),
                               a.batch, device=dev)
    args = fleet.fused_args(cfg, basis, scns)
    n = min(1000, a.batch)
    flip = torch.arange(n - 1, -1, -1, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(order, lanes=None):
        fs.t_sums = ORDERS[order]
        try:
            sub = args if lanes is None else args[:4] + tuple(
                x[..., lanes] for x in args[4:])
            sync()
            t0 = time.perf_counter()
            out = fs.fused_solve_reference(*sub)
            sync()
            return out, 1e3 * (time.perf_counter() - t0)
        finally:
            fs.t_sums = ORDERS["rows"]

    ms = {k: [] for k in ORDERS}
    for order in ("chain", "sum0", "rows", "rows", "sum0", "chain"):
        ms[order].append(run(order)[1])
    first = torch.arange(n, device=dev)
    free = {}
    for order in ORDERS:
        a_out = run(order, first)[0]
        b_out = run(order, first[flip])[0]
        free[order] = all(torch.equal(x[..., flip], y)
                          for x, y in zip(a_out, b_out))
    best = {k: min(v) for k, v in ms.items()}
    out = {"device": dev.type, "T": a.T, "batch": a.batch,
           "schedule": "2x6", "ms": best,
           "ratio_to_sum0": {k: v / best["sum0"] for k, v in best.items()},
           "position_free": free}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
