"""The replanner (solvers/replan.py) and the replanning benchmark's
protocol (benchmarks/replan.py) on the CPU: the cases of
tests/test_runtime.py's replanner tests, with two assertions changed.  The
JAX tests count one jit compile across ticks
(``_cache_size() == 1``); the port compiles nothing per tick (its kernel
library is built once, which chip_smoke.py checks on the card), so the
count has no counterpart here.  JAX's rollout, one ``lax.scan``, is held to
its tick loop within 2e-5; the port's rollout makes the tick loop's calls
in the same order, so it is held to it bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers.replan import Replanner as JReplanner

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.benchmarks import replan as replan_bench
from irm_motion_planning_tpu_torch.solvers.replan import PAD_LANES, Replanner

SHORT = dict(max_inner_iteration=30, max_outer_iteration=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: these tests run many small operations, which six
    parallel workers of multi-threaded torch slow several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = mt.PlannerConfig(**SHORT)
    return cfg, mt.reference_scenario(cfg, device="cpu")


def _cost(rp, scn, alpha):
    pen = mt.initial_penalty(rp.tick_cfg)
    return float(mt.total_cost(rp.tick_cfg, rp.basis, scn, pen, alpha))


def test_replanner_warm_start_and_moving_obstacles(setup):
    """Moving obstacles, warm-started ticks: a tick replanning the last
    scene warm converges in fewer inner steps than a fresh replanner cold,
    and lands no worse (within 2%, tests/test_runtime.py's bound)."""
    cfg, scn = setup
    rp = Replanner(cfg, budget_outer=2, budget_inner=15, device="cpu")
    rp.plan(scn)
    costs = []
    for k in range(3):
        moved = scn._replace(obstacles=scn.obstacles + 0.05 * (k + 1))
        costs.append(_cost(rp, moved, rp.plan(moved).alpha))
    assert all(np.isfinite(costs))
    moved = scn._replace(obstacles=scn.obstacles + 0.15)
    r_warm = rp.plan(moved)
    rp_cold = Replanner(cfg, budget_outer=2, budget_inner=15, device="cpu")
    r_cold = rp_cold.plan(moved)
    assert int(r_warm.stats.inner_iters) < int(r_cold.stats.inner_iters)
    assert _cost(rp, moved, r_warm.alpha) < _cost(rp_cold, moved,
                                                  r_cold.alpha) * 1.02


def test_replanner_reset_refits(setup):
    """After reset the next tick starts from the smoothstep fit again: the
    first tick's result is reproduced bit for bit."""
    cfg, scn = setup
    rp = Replanner(cfg, budget_outer=1, budget_inner=10, device="cpu")
    first = rp.plan(scn)
    rp.plan(scn)
    rp.reset()
    assert torch.equal(rp.plan(scn).alpha, first.alpha)


@pytest.mark.parametrize("engine", ["vmap", "fleet"])
def test_replanner_batched(setup, engine):
    cfg, scn = setup
    rp = Replanner(cfg, budget_outer=1, budget_inner=10, batched=True,
                   engine=engine, device="cpu")
    scns = mt.replicate_scenario(scn, 4)
    res = rp.plan(scns)
    assert res.alpha.shape == (4, cfg.n_timesteps, cfg.n_joints)
    res2 = rp.plan(scns)
    assert torch.isfinite(res2.stats.final_cost).all()


@pytest.mark.parametrize("backend", ["xla", "fused", "pallas"])
def test_replanner_single_scene_fleet_engine(setup, backend):
    """One scene on the fleet engine, padded to 128 lanes (on the card the
    fused backend is one K1 launch; here its plain version): every padded
    lane equals lane 0 bit for bit, and lane 0 is the answer."""
    cfg, scn = setup
    rp = Replanner(cfg, budget_outer=1, budget_inner=10, engine="fleet",
                   backend=backend, device="cpu")
    r1 = rp.plan(scn)
    assert r1.alpha.shape == (cfg.n_timesteps, cfg.n_joints)
    r2 = rp.plan(scn._replace(obstacles=scn.obstacles + 0.05))
    assert np.isfinite(float(r2.stats.final_cost))
    pad = rp.last_padded
    assert pad.alpha.shape[0] == PAD_LANES
    assert torch.equal(pad.alpha, r2.alpha.expand_as(pad.alpha))
    for f in pad.stats:
        assert bool((f == f[0]).all())


@pytest.mark.parametrize("engine,backend,batched", [
    ("fleet", "xla", False), ("fleet", "fused", False), ("vmap", "xla", False),
    ("fleet", "fused", True), ("vmap", "xla", True)])
def test_replanner_rollout_matches_tick_loop(setup, engine, backend, batched):
    """plan_rollout replays the host tick loop bit for bit: the same engine
    and ticks give the same final alpha and per-tick stats."""
    cfg, scn = setup
    if batched:
        scn = mt.replicate_scenario(scn, 3)
    ticks = [replan_bench.drift_obstacles(scn, k) for k in range(1, 4)]
    kw = dict(budget_outer=1, budget_inner=8, engine=engine, backend=backend,
              batched=batched, device="cpu")
    rp_loop = Replanner(cfg, **kw)
    loop = [rp_loop.plan(t) for t in ticks]
    rp_roll = Replanner(cfg, **kw)
    final, stats = rp_roll.plan_rollout(
        mt.Scenario(*(torch.stack(xs) for xs in zip(*ticks))))
    assert stats.final_cost.shape[0] == 3
    assert torch.equal(final, loop[-1].alpha)
    for k, r in enumerate(loop):
        for f, g in zip(stats, r.stats):
            assert torch.equal(f[k], g)


def test_replanner_against_jax(setup):
    """Three warm-started ticks of the reference scene with drifting
    obstacles, the port's replanner (vmap engine) beside JAX's: the final
    tick's penalized cost within 5% (the two fits of the warm start part by
    ~1e-3 in the trajectory and the solves are chaotic in it).  Measured:
    1.87879 against JAX's 1.88415 (-0.28%)."""
    cfg, scn = setup
    jcfg = mp.PlannerConfig(**SHORT)
    jscn = mp.reference_scenario(jcfg)
    rp = Replanner(cfg, budget_outer=2, budget_inner=15, device="cpu")
    jrp = JReplanner(jcfg, budget_outer=2, budget_inner=15)
    for k in range(3):
        t = replan_bench.drift_obstacles(scn, k)
        r = rp.plan(t)
        jr = jrp.plan(jscn._replace(obstacles=jax.numpy.asarray(
            t.obstacles.numpy())))
    jalpha = torch.tensor(np.asarray(jr.alpha))
    c, jc = _cost(rp, t, r.alpha), _cost(rp, t, jalpha)
    print(f"third tick's cost: port {c:.5f}, JAX {jc:.5f}")
    assert abs(c - jc) <= 0.05 * abs(jc)


def test_replan_bench_protocol_on_cpu():
    """replan_bench's tick loop and rollout at a CPU size: finite costs, a
    rate, and the rollout's final alpha the tick loop's bit for bit."""
    cfg = replan_bench.bench_config()
    scn = mt.reference_scenario(cfg, device="cpu")
    out, rp, res = replan_bench.run_mode(cfg, scn, 2, batched=False,
                                         engine="fleet", backend="fused",
                                         device="cpu")
    assert out["value"] > 0 and np.isfinite(out["mean_tick_cost"])
    assert out["tick_ms_p99"] >= out["tick_ms_median"] > 0
    rp2 = replan_bench.make_replanner(cfg, False, "fleet", "fused", "cpu")
    rp2.plan(replan_bench.drift_obstacles(scn, 0))
    final, _ = rp2.plan_rollout(replan_bench.stack_ticks(scn, 2))
    assert torch.equal(final, res.alpha)
