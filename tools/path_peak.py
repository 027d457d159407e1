"""The GD per-step path of one checkout: solves/s and peak device memory.

    python tools/path_peak.py LABEL      # from a checkout's root, on a card

Runs ``bench.run_bench`` at 1,048,576 lanes of the replicated reference
scene with ``--solver gd --backend pallas`` (one warm-up solve and two timed
ones) in the checkout it runs in (the package is imported from the current
directory), after resetting the peak-memory counter, and prints one JSON
line: the label, solves/s, the timed seconds, K4's launches, the peak
device memory and the gate's endpoint.  Two checkouts on one card, in
turns (parent, change, change, parent), compare their paths' speed and
memory.
"""

import json
import os
import sys

import torch


def main(label):
    sys.path.insert(0, os.getcwd())
    from irm_motion_planning_tpu_torch import bench
    from irm_motion_planning_tpu_torch.ops import step_kernels as sk

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sk.gd_inner_step.launches = 0
    out = bench.run_bench(batch=1048576, repeats=2, solver="gd",
                          backend="pallas")
    print(json.dumps({
        "tree": label,
        "solves_per_s": 1048576 / min(out["timing"]["times_s"]),
        "times_s": out["timing"]["times_s"],
        "k4_launches": sk.gd_inner_step.launches,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "endpoint": out["endpoint_err"], "quality_ok": out["quality_ok"]}),
        flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
