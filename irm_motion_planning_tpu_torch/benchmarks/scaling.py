"""Scaling sweep of the port: solves/s at 1, 2, 4, ... N devices, in one
process or many (the port of benchmarks/scaling.py).

    python -m irm_motion_planning_tpu_torch.benchmarks.scaling \\
        [--per-device 512] [--repeats 3] [--solver bls|gd] [--max-devices 0] \\
        [--engine fleet|vmap] [--backend xla|fused|pallas] [--device cuda|cpu]

    # one rank per host or card, the group formed over TCP:
    python -m irm_motion_planning_tpu_torch.benchmarks.scaling \\
        --coordinator host0:1234 \\
        --num-processes 4 --process-id $I

    # N fresh local processes that form one group and solve ONE global
    # batch (ranks that share a card use gloo; one card each, NCCL):
    python -m irm_motion_planning_tpu_torch.benchmarks.scaling --spawn 2 \\
        --per-device 16

For each device count: the config of benchmarks/scaling.py (ladder BLS or
GD, early exit, ``--max-inner-iteration``/``--max-outer-iteration``), the
reference scene replicated over ``--per-device`` lanes per device, solved by
``parallel.sharded.make_shard_map_solver`` on ``--engine``/``--backend``
with the fleet statistics reduced over the group; one untimed run (which
builds the kernels), then ``--repeats`` timed runs, each ended by a
synchronize of every local card and a host read of the reduced statistics;
the best counts.  Each process builds only its ``local_batch_slice`` of the
global batch.  In one process the sweep runs every power of two up to the
device count; across processes only the full mesh.  On the CPU
(``--device cpu``) a process's mesh holds ``--max-devices`` shards (0: 1),
which share its cores: the numbers check the harness, not a device.

Process 0 prints one JSON line per point to stderr and the sweep to stdout:
``metric: "scaling_sweep"``, ``platform``, ``processes``,
``per_device_batch``, ``points`` (devices, solves_per_sec,
efficiency_vs_linear), the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .. import (PlannerConfig, make_basis, reference_scenario,
               replicate_scenario)
from ..parallel import distributed as dist
from ..parallel import mesh as meshlib
from ..parallel import sharded

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def local_devices(device: str, max_devices: int) -> list:
    """This process's devices: in a group its own card (or CPU shards), in
    one process every card, each cut to ``max_devices`` (0: all)."""
    if device == "cpu":
        return ["cpu"] * max(1, max_devices)
    devs = list(meshlib.make_mesh().devices)
    return devs[:max_devices] if max_devices else devs


def measure(cfg, basis, devices, per_device, repeats, solver="bls",
            engine="fleet", backend="xla"):
    """Solves/s of the global batch on a mesh of ``devices`` per process."""
    mesh = meshlib.make_mesh(devices)
    batch = per_device * mesh.size
    if mesh.world_size > 1:
        # Each process builds ONLY its local slice of the global batch.
        sl = dist.local_batch_slice(batch)
        local = replicate_scenario(
            reference_scenario(cfg, device=mesh.devices[0]),
            sl.stop - sl.start)
        scns = dist.global_scenarios_from_local(mesh, local)
    else:
        scns = meshlib.shard_batch(mesh, replicate_scenario(
            reference_scenario(cfg, device=mesh.devices[0]), batch))
    run = sharded.make_shard_map_solver(cfg, basis, mesh, solver=solver,
                                        engine=engine, backend=backend)

    def run_to_completion():
        _, stats = run(scns)
        for d in set(mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return float(stats["mean_final_cost"])

    run_to_completion()  # kernel build + warm-up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_to_completion()
        times.append(time.perf_counter() - t0)
    return batch / min(times)


def spawn_local_group(n: int, argv, device: str, dist_backend) -> int:
    """N fresh interpreters of this module forming one group over
    127.0.0.1 (``distributed.run_local_ranks``).  The port comes from the
    launcher's pid, so concurrent launches do not collide.  The kernels
    are built once here, before the ranks start.  Ranks that share a card
    run gloo, named explicitly.  Process 0's output is the result, written
    when the ranks end; a rank that fails stops the others, and its
    errors are written too."""
    port = 20000 + os.getpid() % 20000
    extra = []
    if device == "cuda":
        from ..ops import _build

        _build.build()
        if dist_backend is None and n > torch.cuda.device_count():
            print(f"# {n} ranks share {torch.cuda.device_count()} card(s): "
                  f"--dist-backend gloo", file=sys.stderr)
            extra = ["--dist-backend", "gloo"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    ranks = dist.run_local_ranks(
        [[sys.executable, "-m",
          "irm_motion_planning_tpu_torch.benchmarks.scaling",
          "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
          "--process-id", str(i)] + extra + argv for i in range(n)],
        env=env)
    sys.stdout.write(ranks[0][1])
    sys.stderr.write(ranks[0][2])
    rc = 0
    for i, (code, _, err) in enumerate(ranks):
        if code and i:
            sys.stderr.write(f"# rank {i} exited {code}:\n{err}")
        rc = rc or code
    return rc


def _without_spawn(argv):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--spawn":
            skip = True
        elif not a.startswith("--spawn="):
            out.append(a)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--per-device", type=int, default=512)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--solver", choices=["bls", "gd"], default="bls")
    p.add_argument("--max-devices", type=int, default=0, help="0 = all")
    p.add_argument("--max-inner-iteration", type=int, default=200)
    p.add_argument("--max-outer-iteration", type=int, default=10)
    p.add_argument("--engine", choices=["fleet", "vmap"], default="fleet")
    p.add_argument("--backend", choices=["fused", "pallas", "xla"],
                   default="xla")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the cards) or cpu (CPU shards, the plain "
                        "versions: a rehearsal)")
    # Multi-process launch (parallel/distributed.py).
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (multi-process)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the group's backend (default: nccl on cards, gloo "
                        "on the CPU)")
    p.add_argument("--spawn", type=int, default=0,
                   help="spawn N local processes forming one group over "
                        "127.0.0.1 (clusterless validation)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the CPU")

    if args.spawn:
        argv = sys.argv[1:] if argv is None else list(argv)
        return spawn_local_group(args.spawn, _without_spawn(argv),
                                 args.device, args.dist_backend)

    dist.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend=args.dist_backend,
        device="cpu" if args.device == "cpu" else None)

    cfg = PlannerConfig(
        bls_mode="ladder",
        max_inner_iteration=args.max_inner_iteration,
        max_outer_iteration=args.max_outer_iteration,
    )
    devices = local_devices(args.device, args.max_devices)
    basis = make_basis(cfg, device=devices[0])
    if dist.process_count() > 1:
        # Every process takes part in every reduction, so only the full
        # mesh is measured.
        counts = [len(devices)]
    else:
        counts, n = [], 1
        while n <= len(devices):
            counts.append(n)
            n *= 2
        if counts[-1] != len(devices):
            counts.append(len(devices))

    lead = dist.process_index() == 0
    results, base_per_device = [], None
    for n in counts:
        sps = measure(cfg, basis, devices[:n], args.per_device, args.repeats,
                      args.solver, args.engine, args.backend)
        shards = n * dist.process_count()
        if base_per_device is None:
            base_per_device = sps / shards
        results.append({"devices": shards, "solves_per_sec": sps,
                        "efficiency_vs_linear":
                            sps / (base_per_device * shards)})
        if lead:
            print(json.dumps(results[-1]), file=sys.stderr, flush=True)

    if lead:
        name, power = "cpu", None
        if args.device == "cuda":
            from ..bench import gpu_name_and_power_limit

            name, power = gpu_name_and_power_limit()
        print(json.dumps({
            "metric": "scaling_sweep",
            "platform": "gpu" if args.device == "cuda" else "cpu",
            "processes": dist.process_count(),
            "per_device_batch": args.per_device,
            "engine": args.engine, "backend": args.backend,
            "device": name, "power_limit": power,
            "points": results,
        }), flush=True)
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
