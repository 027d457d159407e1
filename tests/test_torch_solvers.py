"""The single-scene solvers (solvers/gd.py, solvers/bls.py) and their
batched engine (solvers/batched.py), against the JAX package's: the cases
of tests/test_solvers.py and tests/test_batched.py, the reference scene
against the goldens, and the batched engine against JAX's ``vmap`` engine
on random scenes as a distribution.

Whole solves are compared by quality, not bits: the port's basis products
and JAX's round apart at the warm start's O(1e3) coefficients, and the
solve is chaotic in them (ROADMAP fact 3).  Within the port, lanes are
compared bit for bit: a lane of a batch equals its solve alone.
"""

import os

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import batched as jbatched

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.solvers import batched, bls, gd

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# Short horizons keep the lockstep batch tests fast (tests/test_batched.py's).
SHORT = dict(max_inner_iteration=30, max_outer_iteration=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: these tests run many small operations, which six
    parallel workers of multi-threaded torch slow several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(x):
    return mt.Scenario(*(torch.tensor(np.asarray(f)) for f in x))


def _quality(cfg, basis, scn, alpha):
    pen0 = mt.Penalty(torch.tensor(0.0), torch.tensor(0.0))
    return float(mt.total_cost(cfg.replace(lambda_max_cost=0.0), basis, scn,
                               pen0, alpha))


@pytest.fixture(scope="module")
def ref():
    cfg = mt.PlannerConfig()
    return cfg, mt.make_basis(cfg, device="cpu"), mt.reference_scenario(
        cfg, device="cpu")


@pytest.mark.parametrize("name", ["bls", "gd"])
def test_reference_scene_against_golden(name):
    """The reference's flagship runs (sequential BLS, GD; the default
    config, the CLI's single-scene default) on the reference scene, held to
    tests/goldens/{bls,gd}_default.txt and REFERENCE_FINAL_COST.

    Measured (CPU): BLS avg/max +0.58%/+0.003% over the reference's final
    costs, endpoint 0.0241, trajectory within 0.041 of the golden; GD
    +0.68%/+0.52%, endpoint 0.0025, within 0.037.  BASELINE.json's gate
    (within 0.1%, lower passing) holds only for the reference's own fp
    path, which the JAX package reproduces bit for bit (tests/test_parity.py)
    and the port does not (its basis products round differently, and the
    solve is chaotic in them; JAX's own ladder path reads +0.53% here): the
    port misses it on avg (both) and max (GD), recorded in ROADMAP queue 3.
    Asserted: the bench's reference-scene gate (bench.py's --quality-tol,
    2%) and endpoint < 0.05; the 0.1% verdict is printed."""
    solver = {"bls": bls, "gd": gd}[name]
    cfg = mt.PlannerConfig(bls_mode="sequential")
    basis = mt.make_basis(cfg, device="cpu")
    scn = mt.reference_scenario(cfg, device="cpu")
    res = solver.solve(cfg, basis, scn)
    q = mt.solution_quality(cfg, basis, scn, res.alpha)
    avg, mx, ep = (float(q[k]) for k in ("avg_cost", "max_cost",
                                         "endpoint_err"))
    ref_avg, ref_max = mt.REFERENCE_FINAL_COST[name]
    golden = np.loadtxt(os.path.join(GOLDEN_DIR, f"{name}_default.txt"))
    traj = mt.evaluate(cfg, basis, res.alpha)[0].numpy()
    strict = avg <= ref_avg * 1.001 and mx <= ref_max * 1.001
    print(f"{name}: avg {avg:.5f} ({100 * (avg / ref_avg - 1):+.3f}%), max "
          f"{mx:.5f} ({100 * (mx / ref_max - 1):+.3f}%), endpoint {ep:.4f}, "
          f"max |traj - golden| {np.abs(traj - golden).max():.4f}, 0.1% gate "
          f"{'PASS' if strict else 'FAIL'}")
    assert avg <= ref_avg * 1.02 and mx <= ref_max * 1.02
    assert ep < 0.05
    assert res.stats.outer_iters.dtype == torch.int32
    assert 0 < int(res.stats.inner_iters)


@pytest.mark.parametrize("solver", [bls, gd], ids=["bls", "gd"])
def test_solver_descends_and_improves_constraints(ref, solver):
    """The solve lowers the penalized cost from the warm start, keeps the
    joint limits and ends within 0.05 of start and goal (the reference
    scene does not fully converge in 10 rounds; tests/test_solvers.py)."""
    cfg, basis, scn = ref
    a0 = mt.init_alpha(cfg, basis, scn.start, scn.goal)
    res = solver.solve(cfg, basis, scn, a0)
    pen = mt.initial_penalty(cfg)
    assert float(mt.total_cost(cfg, basis, scn, pen, res.alpha)) < float(
        mt.total_cost(cfg, basis, scn, pen, a0))
    assert int(res.stats.inner_iters) > 0
    rep = mt.constraint_report(cfg, basis, scn, res.alpha)
    assert bool(rep["limit_ok"]) and bool(rep["vel_limit_ok"])
    assert float(rep["start_pos_err"]) < 0.05
    assert float(rep["goal_pos_err"]) < 0.05


def test_converges_on_obstacle_free_scene():
    cfg = mt.PlannerConfig()
    basis = mt.make_basis(cfg, device="cpu")
    scn = mt.make_scenario(cfg, [0.0, 0.0, 0.0], [0.5, 0.3, 0.2],
                           np.zeros((0, 2)), device="cpu")
    res = bls.solve(cfg, basis, scn)
    assert bool(res.stats.converged)
    assert bool(mt.constraints_fulfilled(cfg, basis, scn, res.alpha))


def test_fixed_iters_matches_early_exit_gd():
    """The fixed horizon with frozen lanes reproduces the early exit: the
    same alpha bit for bit and the same step count."""
    cfg_w = mt.PlannerConfig(fixed_iters=False, max_inner_iteration=40,
                             max_outer_iteration=3)
    cfg_f = cfg_w.replace(fixed_iters=True)
    basis = mt.make_basis(cfg_w, device="cpu")
    scn = mt.reference_scenario(cfg_w, device="cpu")
    r_w = gd.solve(cfg_w, basis, scn)
    r_f = gd.solve(cfg_f, basis, scn)
    assert torch.equal(r_w.alpha, r_f.alpha)
    assert int(r_w.stats.inner_iters) == int(r_f.stats.inner_iters)


def test_ladder_equals_sequential_quality(ref):
    """The ladder enumerates the sequential search's trials; quality within
    5e-3 (tests/test_solvers.py's bound).  Measured: the same solve bit for
    bit (the port evaluates a rung with the bits of the trial alone)."""
    _, basis, scn = ref
    cfg_s = mt.PlannerConfig(bls_mode="sequential")
    cfg_l = mt.PlannerConfig(bls_mode="ladder")
    r_s = bls.solve(cfg_s, basis, scn)
    r_l = bls.solve(cfg_l, basis, scn)
    q_s = _quality(cfg_s, basis, scn, r_s.alpha)
    q_l = _quality(cfg_l, basis, scn, r_l.alpha)
    assert abs(q_s - q_l) / q_s < 5e-3


def test_runtime_environment_change(ref):
    """Moved obstacles are runtime data: the same solver gives a different
    answer without any rebuild."""
    cfg, basis, scn = ref
    r1 = bls.solve(cfg.replace(**SHORT), basis, scn)
    moved = scn._replace(obstacles=scn.obstacles + 0.25)
    r2 = bls.solve(cfg.replace(**SHORT), basis, moved)
    assert float((r1.alpha - r2.alpha).abs().max()) > 0


@pytest.fixture(scope="module")
def short():
    cfg = mt.PlannerConfig(**SHORT)
    return cfg, mt.make_basis(cfg, device="cpu")


def _random(cfg, seed, n):
    jcfg = mp.PlannerConfig(**SHORT)
    return _scene(mp.random_scenarios(jcfg, jax.random.PRNGKey(seed), n))


def test_identical_lanes_are_bitwise_identical(short, ref):
    cfg, basis = short
    batch = mt.replicate_scenario(ref[2], 4)
    res = batched.make_batched_solver(cfg, basis)(batch)
    for i in range(1, 4):
        assert torch.equal(res.alpha[0], res.alpha[i])
        assert int(res.stats.inner_iters[0]) == int(res.stats.inner_iters[i])


@pytest.mark.parametrize("solver,bls_mode", [
    ("bls", "ladder"), ("bls", "sequential"), ("gd", "ladder")])
def test_each_lane_equals_its_solve_alone(short, solver, bls_mode):
    """B = 3 random scenes (B equal to J, where a mask broadcast against the
    last axis would freeze joints instead of lanes): every lane's alpha and
    stats equal the scene solved alone, bit for bit."""
    cfg, basis = short
    cfg = cfg.replace(bls_mode=bls_mode)
    scns = _random(cfg, 1, 3)
    res = batched.solve_batch(cfg, basis, scns, solver=solver)
    one = {"bls": bls.solve, "gd": gd.solve}[solver]
    for i in range(3):
        alone = one(cfg, basis, mt.Scenario(*(x[i] for x in scns)))
        assert torch.equal(res.alpha[i], alone.alpha), i
        for f, g in zip(res.stats, alone.stats):
            assert torch.equal(f[i], g), i


def test_frozen_lanes_do_not_drift(short, ref):
    """A lane that converges early stays frozen while another keeps
    iterating: the easy lane of (easy, hard) equals the easy scene alone."""
    cfg, basis = short
    easy = mt.make_scenario(cfg, [0.0, 0.0, 0.0], [0.4, 0.2, 0.1],
                            np.zeros((0, 2)), device="cpu")
    both = mt.Scenario(*(torch.stack([a, b]) for a, b in zip(easy, ref[2])))
    res = batched.solve_batch(cfg, basis, both)
    alone = bls.solve(cfg, basis, easy)
    assert torch.equal(res.alpha[0], alone.alpha)
    assert bool(res.stats.converged[0])
    assert int(res.stats.inner_iters[1]) > int(res.stats.inner_iters[0])


def test_fixed_iters_batch_equals_early_exit_batch(short):
    cfg, basis = short
    scns = _random(cfg, 4, 4)
    r_w = batched.solve_batch(cfg, basis, scns)
    r_f = batched.solve_batch(cfg.replace(fixed_iters=True), basis, scns)
    assert torch.equal(r_w.alpha, r_f.alpha)
    assert torch.equal(r_w.stats.inner_iters, r_f.stats.inner_iters)


def test_batch_summary_and_gd_batched(short):
    cfg, basis = short
    scns = _random(cfg, 2, 8)
    s = batched.batch_summary(batched.make_batched_solver(cfg, basis)(scns))
    assert s["n"] == 8
    assert 0.0 <= float(s["converged_fraction"]) <= 1.0
    assert np.isfinite(float(s["mean_final_cost"]))
    res = batched.make_batched_solver(cfg, basis, solver="gd")(scns)
    assert res.alpha.shape == (8, cfg.n_timesteps, cfg.n_joints)
    assert torch.isfinite(res.stats.final_cost).all()


N_DIST = 128
DIST_CFG = dict(SHORT, bls_mode="ladder")


def test_batched_engine_against_jax_distribution():
    """The batched engine against JAX's ``vmap`` engine (batched.solve_batch)
    on the same 128 random scenes, 3 rounds x 30 steps: the converged
    fractions within 0.05 and the mean unpenalized obstacle costs within
    1% (bench.py's paired-gate bands).  Measured: converged 0.0312, as
    JAX's, obstacle cost 2.65630 against 2.65669 (-0.01%)."""
    jcfg = mp.PlannerConfig(**DIST_CFG)
    cfg = mt.PlannerConfig(**DIST_CFG)
    jscns = mp.random_scenarios(jcfg, jax.random.PRNGKey(5), N_DIST)
    jb = mp.make_basis(jcfg)
    jres = jax.jit(lambda s: jbatched.solve_batch(jcfg, jb, s))(jscns)
    basis = mt.make_basis(cfg, device="cpu")
    scns = _scene(jscns)
    res = batched.solve_batch(cfg, basis, scns)
    pen0 = mt.Penalty(torch.tensor(0.0), torch.tensor(0.0))

    def obstacle_cost(alpha):
        return float(mt.total_cost(cfg, basis, scns, pen0, alpha).mean())

    conv = float(res.stats.converged.float().mean())
    jconv = float(np.asarray(jres.stats.converged).mean())
    cost = obstacle_cost(res.alpha)
    jcost = obstacle_cost(torch.tensor(np.asarray(jres.alpha)))
    print(f"batched engine on {N_DIST} random scenes: converged {conv:.4f} "
          f"(JAX {jconv:.4f}), obstacle cost {cost:.5f} (JAX {jcost:.5f})")
    assert abs(conv - jconv) <= 0.05
    assert abs(cost - jcost) <= 0.01 * abs(jcost)
