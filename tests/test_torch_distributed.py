"""The port's multi-process runtime (irm_motion_planning_tpu_torch/parallel/
distributed.py): the cases of tests/test_distributed.py, with REAL
processes.

Two spawned processes form a gloo group over 127.0.0.1, two CPU shards
each (4 shards in all); each builds only its local_batch_slice of an
8-scene batch and runs the sharded fleet solver.  Checks: both ranks
report the same statistics, bit for bit; the union of their shards equals
the single-process per-shard solve, bit for bit; a launch that cannot form
the group fails loudly; with nothing configured the call is a no-op.
Every subprocess has its own timeout.

Run as ``python tests/test_torch_distributed.py worker RANK N PORT OUTDIR
CASE``, this file is the worker.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch.parallel import distributed as dist  # noqa: E402
from irm_motion_planning_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from irm_motion_planning_tpu_torch.parallel import sharded  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import fleet  # noqa: E402

BATCH = 8
SHARDS_PER_PROCESS = 2
WORKER_TIMEOUT = 120
LAUNCH_ENV = ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK", "LOCAL_RANK")


def config(case):
    """The backend and config of a case: ``fused-compaction`` is the fused
    backend with lane compaction (lanes re-sorted inside each shard)."""
    backend = case.split("-")[0]
    return backend, mt.PlannerConfig(
        n_timesteps=25, fixed_iters=True, max_inner_iteration=3,
        max_outer_iteration=2, max_bls_iteration=4,
        lane_compaction=case.endswith("compaction"))


def global_scenes(cfg):
    return mt.random_scenarios(cfg, torch.Generator().manual_seed(3), BATCH,
                               device="cpu")


def worker(rank, n, port, outdir, case):
    """One process of the group: its local slice only, the sharded fleet
    solver, its shards and the reduced statistics written to an npz."""
    torch.set_num_threads(1)
    assert dist.initialize_distributed(
        f"127.0.0.1:{port}", n, rank, initialization_timeout=60,
        backend="gloo", device="cpu")
    assert dist.process_count() == n and dist.process_index() == rank
    backend, cfg = config(case)
    mesh = meshlib.make_mesh(["cpu"] * SHARDS_PER_PROCESS)
    sl = dist.local_batch_slice(BATCH)
    local = mt.Scenario(*(x[sl] for x in global_scenes(cfg)))
    run = sharded.make_shard_map_solver(
        cfg, mt.make_basis(cfg, device="cpu"), mesh, engine="fleet",
        backend=backend)
    res, stats = run(dist.global_scenarios_from_local(mesh, local))
    out = {k: v.numpy() for k, v in stats.items()}
    for off, part in zip(res.offsets, res.parts):
        out[f"alpha_{off}"] = part.alpha.numpy()
        for name, x in zip(part.stats._fields, part.stats):
            out[f"{name}_{off}"] = x.numpy()
    np.savez(os.path.join(outdir, f"proc{rank}.npz"), **out)
    import torch.distributed as tdist

    tdist.destroy_process_group()


def clean_env():
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env["PYTHONPATH"] = REPO
    return env


def spawn(n, outdir, case):
    port = dist.free_port()
    return dist.run_local_ranks(
        [[sys.executable, os.path.abspath(__file__), "worker", str(i),
          str(n), str(port), str(outdir), case] for i in range(n)],
        timeout=WORKER_TIMEOUT, env=clean_env())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ["xla", "fused", "pallas",
                                  "fused-compaction"])
def test_two_process_group_matches_single_process(tmp_path, case):
    """Every fleet backend, and the fused one with lane compaction, crosses
    the process boundary (the kernels' plain versions on the CPU) over a
    2-process gloo group."""
    for rc, _, err in spawn(2, tmp_path, case):
        assert rc == 0, err[-3000:]
    d = [dict(np.load(tmp_path / f"proc{i}.npz")) for i in range(2)]
    # The reduced statistics: the same on both ranks, bit for bit.
    for k in sharded.STATS_KEYS:
        assert d[0][k].dtype == np.float32 and d[0][k] == d[1][k], k
    assert float(d[0]["n_total"]) == BATCH

    # The union of both processes' shards, in global order.
    offsets = sorted(int(k.split("_")[1]) for di in d for k in di
                     if k.startswith("alpha_"))
    per = BATCH // (2 * SHARDS_PER_PROCESS)
    assert offsets == list(range(0, BATCH, per))
    got = {name: np.concatenate([di[f"{name}_{o}"] for o in offsets
                                 for di in d if f"{name}_{o}" in di])
           for name in ("alpha",) + fleet.SolveStats._fields}

    # Single process: the same global batch, each shard solved alone.
    backend, cfg = config(case)
    basis = mt.make_basis(cfg, device="cpu")
    scns = global_scenes(cfg)
    want = sharded.concat([
        fleet.fleet_solve(cfg, basis, mt.Scenario(*(x[o:o + per]
                                                    for x in scns)),
                          backend=backend) for o in offsets])
    for name, x in zip(("alpha",) + fleet.SolveStats._fields,
                       (want.alpha, *want.stats)):
        np.testing.assert_array_equal(got[name], x.numpy(), err_msg=name)
    np.testing.assert_allclose(float(d[0]["mean_final_cost"]),
                               float(want.stats.final_cost.mean()),
                               rtol=1e-5)


def test_misconfigured_launch_fails_loudly():
    """A coordinator that cannot form the group (rank 0 of 2, no peer)
    raises once the timeout passes; it never reaches the code after."""
    out = subprocess.run(
        [sys.executable, "-c",
         "from irm_motion_planning_tpu_torch.parallel import distributed as d\n"
         "import sys\n"
         "try:\n"
         f"    d.initialize_distributed('127.0.0.1:{dist.free_port()}', "
         "num_processes=2, process_id=0, initialization_timeout=5, "
         "device='cpu')\n"
         "except Exception as e:\n"
         "    print(type(e).__name__, e)\n"
         "    sys.exit(42)\n"
         "print('REACHED_POST_INIT')\n"],
        env=clean_env(), timeout=30, capture_output=True, text=True)
    assert out.returncode == 42, out.stdout + out.stderr
    assert "REACHED_POST_INIT" not in out.stdout


def test_run_local_ranks_stops_the_group():
    """The launcher of a local group: a rank that fails stops its peers at
    once, with its output kept; a rank past the timeout is killed."""
    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    failing = [sys.executable, "-c",
               "import sys; print('out'); sys.exit('err')"]
    t0 = time.monotonic()
    ranks = dist.run_local_ranks([sleep, failing], timeout=30,
                                 env=clean_env())
    assert time.monotonic() - t0 < 20
    assert ranks[0][0] < 0
    assert ranks[1] == (1, "out\n", "err\n")
    (rc, _, _), = dist.run_local_ranks([sleep], timeout=1, env=clean_env())
    assert rc < 0


def test_no_coordinator_is_noop(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize_distributed(device="cpu") is False
    with pytest.raises(ValueError):
        dist.initialize_distributed(num_processes=2, process_id=0,
                                    device="cpu")


def test_no_hidden_fallback():
    """NCCL is never swapped for gloo: on a CPU device it raises before
    any group forms; two ranks on one card are found and named."""
    with pytest.raises(ValueError, match="nccl"):
        dist.initialize_distributed("127.0.0.1:1", 2, 0, backend="nccl",
                                    device="cpu")
    assert dist.duplicate_devices(["h/a", "h/b"]) == {}
    assert dist.duplicate_devices(["h/a", "h/a", "h/b"]) == {"h/a": [0, 1]}


def test_local_batch_slice():
    assert dist.local_batch_slice(8, n_processes=2, index=0) == slice(0, 4)
    assert dist.local_batch_slice(8, n_processes=2, index=1) == slice(4, 8)
    assert dist.local_batch_slice(8) == slice(0, 8)
    with pytest.raises(ValueError):
        dist.local_batch_slice(9, n_processes=2, index=0)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
           sys.argv[6])
