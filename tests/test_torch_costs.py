"""The port's kinematics, cost terms and gate helpers against the JAX
package's, on the reference scene and 16 random scenes.

Inputs come from the JAX side as numpy arrays: the scenes from JAX's
``reference_scenario``/``random_scenarios``, the coefficients from the
warm start plus numpy noise (O(1e3) values that cancel like real ones).
"""

import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.models import robot as jrobot
from irm_motion_planning_tpu.ops import costs as jcosts
import jax

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.models import robot as trobot
from irm_motion_planning_tpu_torch.ops import costs as tcosts

N_RANDOM = 16
CFG = mp.PlannerConfig(max_obstacles=11)
TCFG = mt.PlannerConfig(max_obstacles=11)


@pytest.fixture(scope="module")
def cases():
    jb = mp.make_basis(CFG)
    tb = mt.make_basis(TCFG)
    rnd = mp.random_scenarios(CFG, jax.random.PRNGKey(3), N_RANDOM)
    scenes = [mp.reference_scenario(CFG)] + [
        jax.tree_util.tree_map(lambda x, i=i: x[i], rnd) for i in range(N_RANDOM)
    ]
    rng = np.random.default_rng(0)
    out = []
    for scn in scenes:
        a = np.asarray(mp.init_alpha(CFG, jb, scn.start, scn.goal))
        a = (a + rng.normal(0.0, 2.0, a.shape)).astype(np.float32)
        traj, vel = (np.asarray(x) for x in mp.evaluate(CFG, jb, a))
        tscn = mt.Scenario(*(torch.tensor(np.asarray(x)) for x in scn))
        out.append((scn, tscn, a, traj, vel))
    return jb, tb, out


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("i", range(N_RANDOM + 1))
def test_fk_and_terms_match_at_same_trajectory(cases, i):
    """Fed the same (traj, vel), the port's kinematics and five cost terms
    agree with JAX to fp32 rounding (measured <= 4e-7 relative)."""
    _, _, items = cases
    scn, tscn, _, traj, vel = items[i]
    np.testing.assert_allclose(
        trobot.fk(TCFG, _t(traj)).numpy(), np.asarray(jrobot.fk(CFG, traj)),
        rtol=1e-5, atol=1e-5)
    pairs = [
        (jcosts.trajectory_obstacle_cost(CFG, traj, scn),
         tcosts.trajectory_obstacle_cost(TCFG, _t(traj), tscn)),
        (jcosts.start_goal_cost(traj, scn.start, scn.goal),
         tcosts.start_goal_cost(_t(traj), tscn.start, tscn.goal)),
        (jcosts.start_goal_velocity_cost(vel),
         tcosts.start_goal_velocity_cost(_t(vel))),
        (jcosts.joint_position_limit_cost(CFG, traj),
         tcosts.joint_position_limit_cost(TCFG, _t(traj))),
        (jcosts.joint_velocity_limit_cost(CFG, vel),
         tcosts.joint_velocity_limit_cost(TCFG, _t(vel))),
    ]
    for k, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"term {k}")
    for name, args in (
        ("start_goal_position_ok", (traj[0], traj[-1], scn.start, scn.goal)),
        ("start_goal_velocity_ok", (vel[0], vel[-1])),
        ("joint_position_ok", (traj,)),
        ("joint_velocity_ok", (vel,)),
    ):
        want = bool(getattr(jrobot, name)(CFG, *args))
        got = bool(getattr(trobot, name)(TCFG, *(_t(a) for a in args)))
        assert got == want, name


@pytest.mark.parametrize("i", range(N_RANDOM + 1))
def test_total_cost_and_gate_helpers_match(cases, i):
    """Through the port's own evaluate.  Tolerance: the basis product
    cancels the O(1e3) coefficients to O(1) and sums in another order than
    JAX's, which moves the trajectory by up to ~5e-3 (measured 3e-3).
    Measured on these 17 scenes: total cost 6e-5 relative, the quality and
    report norms 1.3e-3 absolute."""
    jb, tb, items = cases
    scn, tscn, a, _, _ = items[i]
    ta = _t(a)
    pen = mp.initial_penalty(CFG)
    tpen = tcosts.initial_penalty(TCFG)
    np.testing.assert_allclose(
        tcosts.total_cost(TCFG, tb, tscn, tpen, ta).item(),
        float(mp.total_cost(CFG, jb, scn, pen, a)), rtol=1e-3)
    want = mp.solution_quality(CFG, jb, scn, a)
    got = tcosts.solution_quality(TCFG, tb, tscn, ta)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-2,
                                   atol=1e-2, err_msg=k)
    want = mp.constraint_report(CFG, jb, scn, a)
    got = tcosts.constraint_report(TCFG, tb, tscn, ta)
    assert set(got) == set(want)
    for k in want:
        if np.asarray(want[k]).dtype == bool:
            assert bool(got[k]) == bool(want[k]), k
        else:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=1e-2, atol=1e-2, err_msg=k)
    assert bool(tcosts.constraints_fulfilled(TCFG, tb, tscn, ta)) == bool(
        mp.constraints_fulfilled(CFG, jb, scn, a))


def test_scenario_helpers_match():
    cfg = mp.PlannerConfig()
    ref = mp.reference_scenario(cfg)
    got = mt.reference_scenario(mt.PlannerConfig())
    for w, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rep = mt.replicate_scenario(got, 5)
    jrep = mp.replicate_scenario(ref, 5)
    for w, g in zip(jrep, rep):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="max_obstacles"):
        mt.make_scenario(mt.PlannerConfig(max_obstacles=2), (0, 0, 0),
                         (1, 1, 1), [(0, 1), (1, 0), (2, 2)])


def test_random_scenarios_distribution():
    """Same distribution as JAX's generator (the draws themselves differ):
    box with a 10% margin, obstacles in the workspace square, the first
    n_obstacles slots live."""
    cfg = mt.PlannerConfig(max_obstacles=16)
    gen = torch.Generator().manual_seed(0)
    s = mt.random_scenarios(cfg, gen, 4096, n_obstacles=11)
    lo, hi = cfg.min_joint_position, cfg.max_joint_position
    m = 0.1 * (hi - lo)
    for x in (s.start, s.goal):
        assert x.shape == (4096, 3)
        assert float(x.min()) >= lo + m and float(x.max()) <= hi - m
        assert abs(float(x.mean()) - 0.5 * (lo + hi)) < 0.05
    assert s.obstacles.shape == (4096, 16, 2)
    assert float(s.obstacles.abs().max()) <= 3.5
    np.testing.assert_array_equal(s.obstacle_weight[0].numpy(),
                                  (np.arange(16) < 11).astype(np.float32))
    again = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), 4096,
                                n_obstacles=11)
    assert torch.equal(again.obstacles, s.obstacles)
