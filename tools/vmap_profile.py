"""Profile the batched single-scene engine (solvers/batched.py, bench
``--engine vmap``) on the card: one solve of random scenes at the bench
config with ``--inner`` steps per round under torch.profiler; prints the
wall time, the mean steps, the peak device memory and the operators by
device time and by host time.

    python tools/vmap_profile.py [--batch 65536] [--inner 2]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch import bench  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import batched  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=65536)
    p.add_argument("--inner", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    cfg = bench.bench_config(inner=a.inner)
    dev = torch.device("cuda")
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(a.seed),
                               a.batch, device=dev)
    batched.solve_batch(cfg, basis, mt.Scenario(*(x[:64] for x in scns)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        res = batched.solve_batch(cfg, basis, scns)
        torch.cuda.synchronize()
    print(f"{torch.cuda.get_device_name(0)}: batch {a.batch}, wall "
          f"{time.perf_counter() - t0:.3f} s, mean steps "
          f"{float(res.stats.inner_iters.float().mean()):.2f}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
