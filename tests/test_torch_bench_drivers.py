"""K2's drivers in the port's benchmarks (schedule_sweep.run_schedule,
hetero.run_policy) on the CPU, where K2 runs its plain version: each held
to K1's plain version (ops/fused_solve.py ``fused_solve_reference``) and to
the fleet engine's rounds driver bit for bit, per lane.

JAX's schedule_sweep.py and hetero.py call the Pallas kernels without
``interpret``, so they do not run on the CPU; these drivers are held to
the port's own whole-solve version instead, which the port's tests hold
to JAX's kernels (tests/test_torch_fused_solve.py).

Where a policy permutes the lanes, the final loss is held to 2 float32
ulps instead of bit for bit: the plain versions' sums over T
(``scalar_cost``'s ``sum(0)`` of a (T, B) plane) take another order on the
CPU for some lane positions when B is not a multiple of torch's blocking
(ROADMAP queue 3, fact 10: here 5 of 48 lanes 1-2 ulps apart, with alpha,
the counts and the flags bit for bit).  The kernels sum each lane's chain
alone, and chip_smoke.py holds the card's results bit for bit.
"""

import numpy as np
import pytest
import torch

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.benchmarks import hetero, schedule_sweep
from irm_motion_planning_tpu_torch.ops import fused_solve as fs
from irm_motion_planning_tpu_torch.solvers import fleet

SCHED = (5, 6)
SHORT = dict(bls_mode="ladder", fixed_iters=True, inner_schedule=SCHED,
             max_inner_iteration=max(SCHED), max_outer_iteration=len(SCHED),
             max_obstacles=11)
B = 48


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = mt.PlannerConfig(**SHORT)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(4), B,
                               device="cpu")
    args = fleet.fused_args(cfg, basis, scns)
    k1 = fleet.kernel_result(fs.fused_solve_reference(*args))
    return cfg, basis, scns, fleet.to_fleet(scns), args[4], k1


def same(a, b, loss_ulps=0):
    """Bit for bit, the final loss within ``loss_ulps`` float32 ulps."""
    *counts, loss = zip(a.stats, b.stats)
    ulp = torch.finfo(torch.float32).eps * loss[1].abs()
    return (torch.equal(a.alpha, b.alpha)
            and all(torch.equal(x, y) for x, y in counts)
            and bool(((loss[0] - loss[1]).abs() <= loss_ulps * ulp).all()))


def test_run_schedule_equals_the_whole_solve(setup):
    cfg, basis, _, fsc, a0k, k1 = setup
    alpha, steps, state = schedule_sweep.run_schedule(cfg, basis, fsc, a0k,
                                                      SCHED, 0)
    assert torch.equal(fleet.alpha_from_fleet(alpha.movedim(0, 1)), k1.alpha)
    assert torch.equal(state.total_inner[0].int(), k1.stats.inner_iters)
    assert torch.equal(state.ful[0] > 0.5, k1.stats.converged)
    assert steps == float(k1.stats.inner_iters[0])


def test_policy_none_equals_the_whole_solve(setup):
    cfg, basis, _, fsc, a0k, k1 = setup
    run = hetero.run_policy(cfg, basis, fsc, a0k, SCHED, 0, "none", False)
    assert same(run.result, k1)
    assert torch.equal(run.tot_steps.int(), k1.stats.inner_iters)
    assert run.ful_frac == float(k1.stats.converged.float().mean())


def test_steps_loss_is_the_shipped_compaction(setup):
    """``steps_loss`` is the fleet engine's ``lane_compaction=True`` sort
    (fleet.compaction_order), bit for bit after the permutation is
    undone."""
    cfg, basis, scns, fsc, a0k, k1 = setup
    run = hetero.run_policy(cfg, basis, fsc, a0k, SCHED, 0, "steps_loss",
                            False)
    shipped = fleet.fleet_solve(cfg.replace(lane_compaction=True), basis,
                                scns, backend="fused")
    assert same(run.result, shipped)
    assert same(run.result, k1, loss_ulps=2)


@pytest.mark.parametrize("policy,shrink", [("steps", False),
                                           ("steps_loss", True),
                                           ("none", True),
                                           ("oracle", False)])
def test_policies_give_each_lane_its_own_result(setup, policy, shrink):
    """Every policy and ``--shrink`` permute and cut the launched lanes;
    each lane's result is its own, bit for bit but the final loss (see the
    module's docstring; ``oracle``: ``none`` on the fleet presorted by a
    discovery run's steps, undone here)."""
    cfg, basis, _, fsc, a0k, k1 = setup
    if policy == "oracle":
        tot = hetero.run_policy(cfg, basis, fsc, a0k, SCHED, 0, "none",
                                False).tot_steps
        order = torch.argsort(tot, stable=True)
        pfsc, pa0k = hetero.presorted(fsc, a0k, order)
        run = hetero.run_policy(cfg, basis, pfsc, pa0k, SCHED, 0, "none",
                                shrink, time_rounds=True)
        inv = torch.argsort(order)
        got = type(run.result)(run.result.alpha[inv], type(
            run.result.stats)(*(x[inv] for x in run.result.stats)))
        assert not torch.equal(order, torch.arange(B))
    else:
        run = hetero.run_policy(cfg, basis, fsc, a0k, SCHED, 0, policy,
                                shrink, time_rounds=True)
        got = run.result
    assert same(got, k1, loss_ulps=2)
    assert [r["r"] for r in run.rounds] == [0, 1]
    launched = [r["launched"] for r in run.rounds]
    assert launched[0] == B
    if shrink:
        # The second launch holds round 0's live lanes, rounded up to CTAs
        # of 16 lanes.
        live = B * (1 - run.rounds[0]["ful_frac"])
        assert launched[1] == min(B, max(16, -(-round(live) // 16) * 16))
    assert all(r["tiles"] == -(-B // 16) for r in run.rounds)


def test_shipped_schedule_passes_the_reference_scene_gate():
    """The shipped schedule through K2's plain version on the reference
    scene, the sweep's config (max_inner_iteration the candidates' largest
    budget): avg/max cost within 2% of REFERENCE_FINAL_COST."""
    cfg = schedule_sweep.sweep_config(max(max(s) for s in
                                          schedule_sweep.DEFAULT_BLS))
    basis = mt.make_basis(cfg, device="cpu")
    scn0 = mt.reference_scenario(cfg, device="cpu")
    fsc = fleet.to_fleet(mt.replicate_scenario(scn0, 1))
    a0k = fleet.fleet_init_alpha(cfg, basis, fsc).movedim(1, 0).contiguous()
    sched = schedule_sweep.DEFAULT_BLS[0]
    assert sched == mt.REFERENCE_INNER_SCHEDULE_BLS
    alpha, steps, _ = schedule_sweep.run_schedule(cfg, basis, fsc, a0k,
                                                  sched, 0)
    row = schedule_sweep.candidate_row(cfg, basis, scn0, alpha, steps, sched)
    print(row)
    ref_avg, ref_max = mt.REFERENCE_FINAL_COST["bls"]
    assert row["avg_cost"] <= ref_avg * 1.02
    assert row["max_cost"] <= ref_max * 1.02
    assert row["total_budget"] == sum(sched) and row["live_steps"] > 0
    assert np.isfinite(row["endpoint_err"])
