"""The port's analytic gradients, the autograd Function and the kinematics
and basis functions of this slice, against the JAX package's, torch's
autograd and finite differences (the cases of tests/test_grads.py and
tests/test_robot.py).

Inputs cross over as numpy: JAX's reference scene and basis (the port's
committed export equals it bit for bit), the warm start JAX fits, and
trajectories / coefficients drawn with numpy.  Where the JAX side
evaluates a basis product, the coefficients are O(1): at the warm start's
O(1e3) coefficients two fp paths part by ~1e-3 in the trajectory (the
products cancel them to O(1)), which would hide the gradients' agreement
behind the products' rounding.
"""

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.models import robot as jrobot
from irm_motion_planning_tpu.ops import costs as jcosts

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.models import robot as trobot
from irm_motion_planning_tpu_torch.models import rkhs as trkhs
from irm_motion_planning_tpu_torch.ops import costs as tcosts

CFG = mp.PlannerConfig()
TCFG = mt.PlannerConfig()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: these tests run many small operations, which six
    parallel workers of multi-threaded torch slow several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def setup():
    jb = mp.make_basis(CFG)
    scn = mp.reference_scenario(CFG)
    pen = mp.initial_penalty(CFG)
    alpha = np.asarray(jax.jit(lambda s, g: mp.init_alpha(CFG, jb, s, g))(
        scn.start, scn.goal))
    traj, vel = (np.asarray(x) for x in mp.evaluate(CFG, jb, alpha))
    tb = mt.make_basis(TCFG, device="cpu")
    tscn = mt.Scenario(*(_t(x) for x in scn))
    tpen = mt.initial_penalty(TCFG)
    small = np.random.default_rng(0).normal(0.0, 0.3, alpha.shape).astype(
        np.float32)
    return jb, scn, pen, alpha, traj, vel, tb, tscn, tpen, small


def _masked(traj, vel):
    """Trajectories with the limit losses' violation masks active."""
    traj = traj.copy()
    traj[10], traj[20] = 2.5, -1.5
    vel = vel.copy()
    vel[5] = 8.0
    return traj, vel


# Each trajectory-space gradient: (name, JAX fn, port fn, args builder).
TERM_GRADS = [
    ("obstacle", lambda tr, vl, s: jcosts.trajectory_obstacle_cost_g(CFG, tr, s),
     lambda tr, vl, s: tcosts.trajectory_obstacle_cost_g(TCFG, tr, s),
     lambda tr, vl, s: tcosts.trajectory_obstacle_cost(TCFG, tr, s), "traj"),
    ("start_goal", lambda tr, vl, s: jcosts.start_goal_cost_g(tr, s.start, s.goal),
     lambda tr, vl, s: tcosts.start_goal_cost_g(tr, s.start, s.goal),
     lambda tr, vl, s: tcosts.start_goal_cost(tr, s.start, s.goal), "traj"),
    ("start_goal_velocity", lambda tr, vl, s: jcosts.start_goal_velocity_cost_g(vl),
     lambda tr, vl, s: tcosts.start_goal_velocity_cost_g(vl),
     lambda tr, vl, s: tcosts.start_goal_velocity_cost(vl), "vel"),
    ("joint_position_limit",
     lambda tr, vl, s: jcosts.joint_position_limit_cost_g(CFG, tr),
     lambda tr, vl, s: tcosts.joint_position_limit_cost_g(TCFG, tr),
     lambda tr, vl, s: tcosts.joint_position_limit_cost(TCFG, tr), "traj"),
    ("joint_velocity_limit",
     lambda tr, vl, s: jcosts.joint_velocity_limit_cost_g(CFG, vl),
     lambda tr, vl, s: tcosts.joint_velocity_limit_cost_g(TCFG, vl),
     lambda tr, vl, s: tcosts.joint_velocity_limit_cost(TCFG, vl), "vel"),
]


@pytest.mark.parametrize("name,jfn,tfn,tcost,wrt", TERM_GRADS,
                         ids=[g[0] for g in TERM_GRADS])
def test_term_gradients(setup, name, jfn, tfn, tcost, wrt):
    """Each term's analytic gradient at the same (traj, vel), the limit
    masks active: against JAX's (measured 1.0e-7 relative for the
    obstacle term, 0 for the others; bound 1e-5) and against
    torch.autograd of the port's forward (measured <= 1.4e-7; bound 1e-4,
    as tests/test_grads.py holds JAX's to jax.grad)."""
    _, scn, _, _, traj, vel, _, tscn, _, _ = setup
    traj, vel = _masked(traj, vel)
    got = tfn(_t(traj), _t(vel), tscn)
    assert _rel(got, jfn(traj, vel, scn)) < 1e-5
    x = {"traj": _t(traj), "vel": _t(vel)}
    x[wrt].requires_grad_(True)
    auto, = torch.autograd.grad(tcost(x["traj"], x["vel"], tscn), x[wrt])
    assert _rel(got, auto) < 1e-4
    assert float(got.abs().max()) > 0


def test_obstacle_value_and_gradient(setup):
    """obstacle_cost_vg and blend_weights against JAX's at the warm start's
    end effector (measured 2.0e-7 and 1.5e-7 relative)."""
    _, scn, _, _, traj, _, _, tscn, _, _ = setup
    f = np.asarray(jrobot.fk(CFG, traj))
    jv, jg = jcosts.obstacle_cost_vg(f, scn.obstacles, scn.obstacle_weight)
    tv, tg = tcosts.obstacle_cost_vg(_t(f), tscn.obstacles,
                                     tscn.obstacle_weight)
    assert _rel(tv, jv) < 1e-6 and _rel(tg, jg) < 1e-5
    np.testing.assert_array_equal(
        tcosts.blend_weights(TCFG, tv).numpy(),
        np.asarray(jcosts.blend_weights(CFG, jv)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_total_grad_against_jax(setup, seed):
    """total_cost_grad and cost_and_grad at O(1) coefficients against
    JAX's (measured <= 3.1e-7 relative; bound 1e-4) and cost_and_grad's
    cost against total_cost's."""
    jb, scn, pen, _, _, _, tb, tscn, tpen, small = setup
    a = (small * (seed + 1)).astype(np.float32)
    jg = np.asarray(mp.total_cost_grad(CFG, jb, scn, pen, a))
    tg = mt.total_cost_grad(TCFG, tb, tscn, tpen, _t(a))
    assert _rel(tg, jg) < 1e-4
    c, g = mt.cost_and_grad(TCFG, tb, tscn, tpen, _t(a))
    jc, _ = mp.cost_and_grad(CFG, jb, scn, pen, a)
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-5)
    np.testing.assert_allclose(
        float(c), float(mt.total_cost(TCFG, tb, tscn, tpen, _t(a))), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), tg.numpy(), rtol=1e-5, atol=1e-7)


def test_total_grad_vs_autodiff(setup):
    """The analytic alpha-gradient against torch.autograd of
    total_cost_autodiff_only, at the warm start and at perturbed points
    (measured <= 3.8e-7 relative; bounds 1e-4 and 1e-3, tests/test_grads.py's)."""
    _, _, _, alpha, _, _, tb, tscn, tpen, _ = setup
    rng = np.random.default_rng(7)
    points = [(alpha, 1e-4)] + [
        ((alpha + 10.0 * rng.normal(size=alpha.shape)).astype(np.float32),
         1e-3) for _ in range(3)]
    for a, tol in points:
        x = _t(a).requires_grad_(True)
        auto, = torch.autograd.grad(
            tcosts.total_cost_autodiff_only(TCFG, tb, tscn, tpen, x), x)
        ana = mt.total_cost_grad(TCFG, tb, tscn, tpen, _t(a))
        assert _rel(ana, auto) < tol


def test_total_grad_vs_finite_differences(setup):
    """The analytic gradient in float64 against central differences of the
    total cost (float64 basis and scene; 24 random coordinates; bound 1e-5
    relative to the gradient's scale)."""
    _, _, _, _, _, _, tb, tscn, tpen, small = setup
    b64 = mt.Basis(*(x.double() for x in tb))
    s64 = mt.Scenario(*(x.double() for x in tscn))
    p64 = tcosts.Penalty(*(x.double() for x in tpen))
    a = torch.tensor(small, dtype=torch.float64)
    g = mt.total_cost_grad(TCFG, b64, s64, p64, a)
    rng = np.random.default_rng(5)
    eps = 1e-6
    scale = float(g.abs().max())
    for _ in range(24):
        t, j = int(rng.integers(TCFG.n_timesteps)), int(rng.integers(3))
        ap, am = a.clone(), a.clone()
        ap[t, j] += eps
        am[t, j] -= eps
        fd = (mt.total_cost(TCFG, b64, s64, p64, ap)
              - mt.total_cost(TCFG, b64, s64, p64, am)) / (2 * eps)
        assert abs(float(fd) - float(g[t, j])) <= 1e-5 * scale, (t, j)


def test_autograd_function_returns_analytic_grad(setup):
    """torch.autograd through total_cost runs the analytic backward:
    bit for bit total_cost_grad, per lane for a batch too; the forward's
    value is the plain one's."""
    _, _, _, alpha, _, _, tb, tscn, tpen, small = setup
    x = _t(alpha).requires_grad_(True)
    cost = mt.total_cost(TCFG, tb, tscn, tpen, x)
    g, = torch.autograd.grad(cost, x)
    assert torch.equal(g, mt.total_cost_grad(TCFG, tb, tscn, tpen, _t(alpha)))
    assert torch.equal(cost.detach(), tcosts.total_cost_autodiff_only(
        TCFG, tb, tscn, tpen, _t(alpha)))
    batch = torch.stack([_t(alpha), _t(small)]).requires_grad_(True)
    scns = mt.Scenario(*(x.expand((2,) + x.shape) for x in tscn))
    costs = mt.total_cost(TCFG, tb, scns, tpen, batch)
    gb, = torch.autograd.grad(costs, batch, torch.tensor([1.0, 2.0]))
    want = mt.total_cost_grad(TCFG, tb, scns, tpen, batch.detach())
    assert torch.equal(gb[0], want[0]) and torch.equal(gb[1], 2.0 * want[1])


def test_batched_costs_equal_each_lane_alone(setup):
    """The cost functions on a leading batch give each lane the bits of the
    lane alone (what the single-scene engines rely on)."""
    _, _, _, alpha, _, _, tb, tscn, tpen, small = setup
    rng = np.random.default_rng(3)
    lanes = [_t(alpha), _t(small), _t(alpha + rng.normal(size=alpha.shape))]
    batch = torch.stack(lanes)
    scns = mt.Scenario(*(x.expand((3,) + x.shape) for x in tscn))
    pen = tcosts.Penalty(*(p.expand(3) for p in tpen))
    cb, gb = mt.cost_and_grad(TCFG, tb, scns, pen, batch)
    for i, a in enumerate(lanes):
        one = mt.Scenario(*(x[None] for x in tscn))
        c1, g1 = mt.cost_and_grad(TCFG, tb, one, tcosts.Penalty(
            *(p[None] for p in tpen)), a[None])
        assert torch.equal(cb[i], c1[0]) and torch.equal(gb[i], g1[0])


def test_penalty_scaling_linear(setup):
    """The cost is affine in the penalty multipliers (at O(1) coefficients,
    where the start/goal term is O(1) and float32 resolves the steps)."""
    _, _, _, _, _, _, tb, tscn, _, small = setup
    c = [float(mt.total_cost(TCFG, tb, tscn, tcosts.Penalty(
        torch.tensor(float(k)), torch.tensor(0.0)), _t(small)))
        for k in (0, 1, 2)]
    np.testing.assert_allclose(c[2] - c[1], c[1] - c[0], rtol=1e-4)


def test_evaluate_at_and_position(setup):
    """evaluate_at at query times and evaluate_position against JAX's at
    O(1) coefficients (measured <= 3.1e-7 relative; bound 1e-5);
    evaluate_at at the support times is evaluate."""
    jb, _, _, _, _, _, tb, _, _, small = setup
    ts = np.linspace(0.0, 1.0, 37, dtype=np.float32)
    jp, jv = mp.evaluate_at(CFG, jb, small, ts)
    tp, tv = mt.evaluate_at(TCFG, tb, _t(small), _t(ts))
    assert _rel(tp, jp) < 1e-5 and _rel(tv, jv) < 1e-5
    from irm_motion_planning_tpu.models import rkhs as jrkhs
    assert _rel(trkhs.evaluate_position(TCFG, tb, _t(small)),
                jrkhs.evaluate_position(CFG, jb, small)) < 1e-5
    sp, sv = mt.evaluate_at(TCFG, tb, _t(small), tb.t)
    tr, vl = mt.evaluate(TCFG, tb, _t(small))
    assert _rel(sp, tr) < 1e-5 and _rel(sv, vl) < 1e-5


def test_init_alpha_fits_the_line(setup):
    """init_alpha as JAX writes it, held by the trajectory it evaluates to:
    the smoothstep line within 1e-2 (JAX's LU measured 1.6e-3 here, the
    port's LAPACK 2.9e-4), the two fits within 5e-3 of each other.  The
    coefficients themselves part by O(1e3) (the Gram matrix's condition
    number is ~1e15): printed, not bounded.  A batch of starts and goals
    is fitted lane by lane."""
    jb, scn, _, alpha, traj, _, tb, tscn, _, _ = setup
    ta = mt.init_alpha(TCFG, tb, tscn.start, tscn.goal)
    line = (tscn.start + (tscn.goal - tscn.start) * tb.c[:, None]).numpy()
    ttraj = mt.evaluate(TCFG, tb, ta)[0].numpy()
    fit_port = float(np.abs(ttraj - line).max())
    fit_jax = float(np.abs(traj - line).max())
    print(f"init_alpha line fit: port {fit_port:.3g}, JAX {fit_jax:.3g}; "
          f"alpha max |port - JAX| {np.abs(ta.numpy() - alpha).max():.4g} "
          f"of max |alpha| {np.abs(alpha).max():.4g}")
    assert fit_port < 1e-2 and fit_jax < 1e-2
    assert float(np.abs(ttraj - traj).max()) < 5e-3
    starts = torch.stack([tscn.start, tscn.goal])
    goals = torch.stack([tscn.goal, tscn.start])
    both = mt.init_alpha(TCFG, tb, starts, goals)
    assert torch.equal(both[0], ta)


def test_fk_joints_and_jacobian_against_jax():
    """fk_joint, fk_all_joints and jacobian against JAX's (bound 1e-5),
    fk_joint(J) equal to fk, fk_all_joints equal to fk_joint per joint."""
    q = np.random.default_rng(0).uniform(-1.0, 2.0, (7, 3)).astype(np.float32)
    tq = _t(q)
    for k in (1, 2, 3):
        np.testing.assert_allclose(trobot.fk_joint(TCFG, tq, k).numpy(),
                                   np.asarray(jrobot.fk_joint(CFG, q, k)),
                                   atol=1e-5)
    np.testing.assert_allclose(trobot.fk_all_joints(TCFG, tq).numpy(),
                               np.asarray(jrobot.fk_all_joints(CFG, q)),
                               atol=1e-5)
    np.testing.assert_allclose(trobot.jacobian(TCFG, tq).numpy(),
                               np.asarray(jrobot.jacobian(CFG, q)), atol=1e-5)
    np.testing.assert_allclose(trobot.fk_joint(TCFG, tq, 3).numpy(),
                               trobot.fk(TCFG, tq).numpy(), atol=1e-6)
    allj = trobot.fk_all_joints(TCFG, tq)
    for k in (1, 2, 3):
        np.testing.assert_allclose(allj[k - 1].numpy(),
                                   trobot.fk_joint(TCFG, tq, k).numpy(),
                                   atol=1e-5)


def test_jacobian_vs_autograd_and_finite_differences():
    """The analytic Jacobian against torch.autograd of the FK (rtol 1e-4,
    atol 1e-5) and against central differences (5e-3), as
    tests/test_robot.py holds JAX's."""
    q = torch.tensor(np.random.default_rng(3).uniform(-1.0, 2.0, (5, 3)),
                     dtype=torch.float32)
    jac = trobot.jacobian(TCFG, q)
    for t in range(5):
        auto = torch.autograd.functional.jacobian(
            lambda qt: trobot.fk(TCFG, qt[None])[:, 0], q[t])
        np.testing.assert_allclose(jac[:, t].numpy(), auto.numpy(),
                                   rtol=1e-4, atol=1e-5)
    eps = 1e-3
    for t in range(3):
        for j in range(3):
            qp, qm = q.clone(), q.clone()
            qp[t, j] += eps
            qm[t, j] -= eps
            fd = (trobot.fk(TCFG, qp)[:, t] - trobot.fk(TCFG, qm)[:, t]) / (
                2 * eps)
            np.testing.assert_allclose(jac[:, t, j].numpy(), fd.numpy(),
                                       atol=5e-3)


def test_generalized_joint_count_and_predicates():
    cfg5 = mt.PlannerConfig(n_joints=5, link_length=(1.0, 0.8, 0.6, 0.4, 0.2))
    q = torch.zeros((4, 5))
    np.testing.assert_allclose(trobot.fk(cfg5, q)[0].numpy(), 3.0, atol=1e-6)
    assert trobot.jacobian(cfg5, q).shape == (2, 4, 5)
    z, o = torch.zeros(3), torch.ones(3)
    assert bool(trobot.start_goal_position_ok(TCFG, z, o, z, o))
    assert not bool(trobot.start_goal_position_ok(TCFG, z, o, z + 0.02, o))
    assert bool(trobot.joint_position_ok(TCFG, torch.tensor([[0.0, 1.9, -0.9]])))
    assert not bool(trobot.joint_position_ok(TCFG, torch.tensor([[0.0, 2.1, 0.0]])))
    assert bool(trobot.joint_velocity_ok(TCFG, torch.tensor([[6.9, -6.9, 0.0]])))
    assert not bool(trobot.joint_velocity_ok(TCFG, torch.tensor([[7.1, 0.0, 0.0]])))
    both = torch.tensor([[[0.0, 1.9, -0.9]], [[0.0, 2.1, 0.0]]])
    assert trobot.joint_position_ok(TCFG, both).tolist() == [True, False]
