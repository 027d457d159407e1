"""The port's sharded solvers (irm_motion_planning_tpu_torch/parallel) on a
mesh of 8 CPU shards in one process: the cases of tests/test_sharding.py.

Exactness contract, as the JAX package's: sharding must not change the
math.  A sharded run equals the same solver run on each shard alone, bit
for bit, for every engine and backend (the kernels' plain versions here).
The kernels' backends (``fused``, ``pallas``) run each lane by itself, so
there the union of the shards also equals the whole batch solved at once;
the ``xla`` and ``vmap`` engines fold lanes into wider products, whose
bits may change with the batch width, and are held to the per-shard
solve only.  Against JAX's sharded fleet solver only the statistics are
compared (per-lane outcomes part across fp paths, ROADMAP fact 3).
"""

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.parallel import mesh as jmesh
from irm_motion_planning_tpu.parallel import sharded as jsharded

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.parallel import distributed as dist
from irm_motion_planning_tpu_torch.parallel import mesh as meshlib
from irm_motion_planning_tpu_torch.parallel import sharded
from irm_motion_planning_tpu_torch.solvers import batched, fleet

N_SHARDS = 8
BATCH = 16
# The statistics of the port's sharded fleet xla engine against JAX's on
# the same 64 scenes (T=25, 2 x 10 steps), measured over seeds 2-7:
# n_total and the converged fraction equal, the mean inner iterations
# within 1.5e-2 relative, the mean final cost within 9.1e-4, the max final
# cost within 1.1e-2; held to JAX's own test's 2e-2 (tests/test_sharding.py).
# (At 16 scenes the mean inner iterations parted by up to 3.1%: per-lane
# step counts are chaotic across fp paths, ROADMAP fact 3.)
JAX_STATS_RTOL = 2e-2
JAX_STATS_BATCH = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: many small operations, six parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg():
    return mt.PlannerConfig(n_timesteps=25, fixed_iters=True,
                            max_inner_iteration=10, max_outer_iteration=2)


@pytest.fixture(scope="module")
def basis(cfg):
    return mt.make_basis(cfg, device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return meshlib.make_mesh(["cpu"] * N_SHARDS)


def scenes(cfg, seed, batch=BATCH):
    return mt.random_scenarios(cfg, torch.Generator().manual_seed(seed),
                               batch, device="cpu")


def fields(res):
    return (res.alpha, *res.stats)


def assert_same(got, want):
    for name, x, y in zip(("alpha",) + type(got.stats)._fields,
                          fields(got), fields(want)):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def per_shard_local(solve, scns, n_shards=N_SHARDS):
    """Each shard solved alone, concatenated: the bitwise reference."""
    per = scns.start.shape[0] // n_shards
    return sharded.concat([
        solve(mt.Scenario(*(x[i:i + per] for x in scns)))
        for i in range(0, scns.start.shape[0], per)])


def test_mesh_and_shards(mesh, cfg):
    assert mesh.size == N_SHARDS and mesh.group is None
    assert mesh.axis_names == (meshlib.SCENARIO_AXIS,)
    scns = scenes(cfg, 0)
    a0 = torch.arange(BATCH * 3.0).reshape(BATCH, 1, 3)
    sh_scns, sh_a0 = meshlib.shard_batch(mesh, (scns, a0)).parts[3]
    assert torch.equal(sh_scns.goal, scns.goal[6:8])
    assert torch.equal(sh_a0, a0[6:8])
    sh = meshlib.shard_batch(mesh, scns)
    assert sh.offsets == tuple(range(0, BATCH, 2)) and sh.total == BATCH
    local = dist.global_scenarios_from_local(mesh, scns)
    assert local.offsets == sh.offsets
    with pytest.raises(ValueError):
        meshlib.shard_batch(mesh, scenes(cfg, 0, 12))
    copies = meshlib.replicated(mesh, mt.make_basis(cfg, device="cpu"))
    assert len(copies) == N_SHARDS


def test_sharded_solver_bitwise_matches_per_shard(cfg, basis, mesh):
    """The vmap engine per shard == each shard solved locally, bitwise."""
    scns = scenes(cfg, 0)
    res = sharded.make_sharded_solver(cfg, basis, mesh)(
        meshlib.shard_batch(mesh, scns))
    assert len(res.parts) == N_SHARDS
    want = per_shard_local(lambda s: batched.solve_batch(cfg, basis, s),
                           scns)
    assert_same(sharded.gather_local(res), want)


@pytest.mark.parametrize("backend,compaction", [
    ("xla", False), ("fused", False), ("pallas", False), ("fused", True)])
def test_shard_map_fleet_bitwise_matches_per_shard(cfg, basis, mesh, backend,
                                                   compaction):
    """The fleet engine per shard on each backend (the plain versions of
    the kernels on the CPU; lane compaction re-sorts lanes inside each
    shard only) == each shard solved locally, bitwise; on the kernels'
    backends also the whole batch solved at once."""
    c = cfg
    if compaction:
        c = cfg.replace(lane_compaction=True, inner_schedule=(3, 2),
                        max_inner_iteration=3)
    scns = scenes(c, 1)
    run = sharded.make_shard_map_solver(c, basis, mesh, engine="fleet",
                                        backend=backend)
    res, stats = run(meshlib.shard_batch(mesh, scns))
    assert int(stats["n_total"]) == BATCH
    got = sharded.gather_local(res)

    def solve(s):
        return fleet.fleet_solve(c, basis, s, backend=backend)

    assert_same(got, per_shard_local(solve, scns))
    if backend != "xla":
        assert_same(got, solve(scns))


def test_shard_map_collective_stats(cfg, basis, mesh):
    """The reduced statistics: n_total exact, and self-consistent with the
    gathered results (the float32 sums against torch's means)."""
    scns = scenes(cfg, 1)
    run = sharded.make_shard_map_solver(cfg, basis, mesh)
    res, stats = run(meshlib.shard_batch(mesh, scns))
    assert set(stats) == set(sharded.STATS_KEYS)
    assert all(v.dtype == torch.float32 for v in stats.values())
    assert int(stats["n_total"]) == BATCH
    got = batched.batch_summary(sharded.gather_local(res))
    for key in ("converged_fraction", "mean_inner_iters", "mean_final_cost"):
        np.testing.assert_allclose(float(stats[key]), float(got[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(stats["max_final_cost"]) == float(got["max_final_cost"])


def test_stats_against_jax(cfg, basis, mesh, cpu_devices):
    """The port's sharded fleet xla engine against JAX's
    make_shard_map_solver(engine="fleet", backend="xla") on the same
    scenes over 8 devices: the statistics within JAX_STATS_RTOL."""
    scns = scenes(cfg, 2, JAX_STATS_BATCH)
    _, stats = sharded.make_shard_map_solver(
        cfg, basis, mesh, engine="fleet", backend="xla")(
            meshlib.shard_batch(mesh, scns))
    jcfg = mp.PlannerConfig(n_timesteps=25, fixed_iters=True,
                            max_inner_iteration=10, max_outer_iteration=2)
    jm = jmesh.make_mesh(cpu_devices[:N_SHARDS])
    js = mp.Scenario(*(jax.numpy.asarray(x.numpy()) for x in scns))
    _, jstats = jsharded.make_shard_map_solver(
        jcfg, mp.make_basis(jcfg), jm, engine="fleet", backend="xla")(
            jmesh.shard_batch(jm, js))
    assert float(stats["n_total"]) == float(jstats["n_total"]) == \
        JAX_STATS_BATCH
    for key in sharded.STATS_KEYS[1:]:
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]),
                                   rtol=JAX_STATS_RTOL, err_msg=key)


def test_uneven_padding_helper():
    assert meshlib.pad_to_multiple(17, 8) == 24
    assert meshlib.pad_to_multiple(16, 8) == 16
