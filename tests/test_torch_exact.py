"""The port's exact Armijo ladder (``ladder_eval="exact"``) against the JAX
package: one BLS step of the plain version against
``pallas_step.bls_inner_step``, the plain versions of the fused kernels
against ``pallas_step.fused_solve`` / ``fused_round``, all run interpreted
on the CPU, and the ``xla`` engine against JAX's; the exact tier on every
backend, the bench's exact mode, the bounds' counts and the default
backend; and, marked ``slow``, the tier's certification against the stored
oracle.

Inputs are made with numpy from a seed, or by JAX's ``random_scenarios``,
and handed to both sides as numpy arrays.  The JAX kernels run with
``recip_newton=True`` (their interpreted reciprocal is otherwise off by
4e-3; see test_torch_fused_solve.py).  An exact rung evaluates its candidate
alpha through the basis: from the warm start, whose O(1e4) coefficients the
forward product cancels to O(1), an ulp of the candidate becomes ~1e-3 of
its loss, near the 1e-3 stop threshold.  So whole solves agree on fewer
lanes than with the linearized ladder, and are compared as lane-agreement
fractions.
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.ops import pallas_step as ps
from irm_motion_planning_tpu.solvers import fleet as jfleet

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch import bench
from irm_motion_planning_tpu_torch.benchmarks import certify
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import roofline
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11, ladder_eval="exact")
B = 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fused_solve_reference against pallas_step.fused_solve(interpret=True) at
# SHORT on 128 random scenes: measured lane agreement 0.67 (PRNGKey(9)),
# 0.53-0.58 over PRNGKey(1..6); alpha within 1.4e-5 of the lane's scale on
# the agreeing lanes.
SOLVE_AGREEMENT_MIN = 0.50
# fused_round_reference against pallas_step.fused_round, one round of 4
# steps, a quarter of the lanes fulfilled, penalties x1/x10/x100 and four
# learning rates: 0.67 of the live lanes (seed 0), 0.65-0.78 over seeds
# 0..5, alpha within 3.9e-6 and the loss within 2.1e-2 relative on those.
ROUND_AGREEMENT_MIN = 0.60
# The xla engine against JAX's at SHORT on 128 random scenes, over
# PRNGKey(0..9): lane agreement 0.49-0.71 (0.55 at PRNGKey(3), 0.49 at
# PRNGKey(2), the test's keys), alpha within 1.7e-5 of the lane's scale on
# the agreeing lanes, the mean final loss within 0.07%.
XLA_AGREEMENT_MIN = 0.45


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's plain solves are small: one intra-op thread runs them as
    fast as many, and spares the cores the suite's other workers use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.tensor(np.asarray(x))


def _tscn(scns):
    return mt.Scenario(*(_t(x) for x in scns))


def _as_fused(res):
    """A SolveResult (either package) as the FusedSolve fields
    lane_agreement compares."""
    alpha = torch.tensor(np.asarray(res.alpha)).movedim(0, -1)  # (T, J, B)
    st = [torch.tensor(np.asarray(x)).to(torch.float32)[None]
          for x in (res.stats.final_cost, res.stats.converged,
                    res.stats.outer_iters, res.stats.inner_iters)]
    return tfs.FusedSolve(alpha.movedim(1, 0), *st)


@pytest.fixture(scope="module")
def setup():
    jcfg = mp.PlannerConfig(recip_newton=True, **SHORT)
    tcfg = mt.PlannerConfig(**SHORT)
    jb = mp.make_basis(jcfg)
    tb = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                              for k in jb._fields}, device="cpu")
    return jcfg, tcfg, jb, tb


def _kernel_inputs(jcfg, jb, seed):
    """fused_solve's inputs on 128 random scenes (numpy), and numpy state
    for a round: a quarter of the lanes fulfilled, penalties escalated
    x1/x10/x100, four BLS learning rates."""
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(seed), B)
    fs = jfleet.to_fleet(scns)
    a0 = np.asarray(jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, jb, fs), 1, 0))
    basis = [np.asarray(x) for x in (jb.kv, jb.kv.T, jb.mix)]
    lanes = [np.asarray(x) for x in (fs.start, fs.goal, fs.obstacles[:, 0, :],
                                     fs.obstacles[:, 1, :], fs.obstacle_weight)]
    rng = np.random.default_rng(seed)
    esc = rng.choice(np.array([1.0, 10.0, 100.0], np.float32), (1, B))
    return dict(
        basis=basis, a0=a0, lanes=lanes,
        lsg0=np.full((1, B), jcfg.lambda_sg_constraint, np.float32),
        ljl0=np.full((1, B), jcfg.lambda_jl_constraint, np.float32),
        lsg=(np.float32(jcfg.lambda_sg_constraint) * esc).astype(np.float32),
        ljl=(np.float32(jcfg.lambda_jl_constraint) * esc).astype(np.float32),
        ful=(rng.random((1, B)) < 0.25).astype(np.float32),
        lr=rng.choice(np.array([0.2, 0.1, 0.05, 0.3], np.float32), (1, B)),
    )


@pytest.mark.parametrize("start", ["moderate", "warm start"])
def test_exact_step_matches_jax(setup, start):
    """One exact BLS step (K3's plain version) against
    pallas_step.bls_inner_step(ladder_eval="exact", interpret=True) from
    JAX's evaluation of the same alpha, a quarter of the lanes frozen,
    penalties x1/x10/x100, mixed learning rates; frozen lanes pass through
    bit for bit on both sides.  Measured on the live lanes:

    - from a numpy-seeded alpha of moderate size: lr and stop flags equal on
      every lane, alpha 1.2e-7 of the lane's scale, traj 3.6e-7, vel
      1.9e-6, loss 4.2e-6 relative, the gradient within 1e-4 of the lane's
      scale on every lane;
    - from the warm start, whose coefficients the forward product cancels:
      lr and stop flags equal on 0.96 of the lanes, and there alpha 1.2e-7,
      traj 2.2e-3, vel 1.4e-2, loss 5.2e-3 relative; the gradient, pulled
      back from those planes, is not compared there."""
    jcfg, tcfg, jb, _ = setup
    d = _kernel_inputs(jcfg, jb, 9)
    rng = np.random.default_rng(3)
    frozen = (rng.random((1, B)) < 0.25).astype(np.float32)
    if start == "moderate":
        alpha = np.random.default_rng(4).normal(0, 0.15, (3, 50, B)).astype(
            np.float32)
    else:
        alpha = d["a0"]
    ev = ps.cost_grad_eval(jcfg, *d["basis"], alpha, d["lsg"], d["ljl"],
                           *d["lanes"], block_b=B, interpret=True)
    loss, grad, traj, vel = (np.asarray(x) for x in ev)
    ins = (alpha, grad, traj, vel, loss, d["lr"], frozen)
    want = [np.asarray(x) for x in ps.bls_inner_step(
        jcfg, *d["basis"], *ins, d["lsg"], d["ljl"], *d["lanes"], block_b=B,
        interpret=True)]
    before = sk.bls_inner_step.launches
    got = sk.bls_inner_step(tcfg, *map(_t, d["basis"]), *map(_t, ins),
                            _t(d["lsg"]), _t(d["ljl"]), *map(_t, d["lanes"]))
    assert sk.bls_inner_step.launches == before == 0
    got = [x.numpy() for x in got]
    fz = frozen[0] > 0.5
    for g, w, x in zip(got, want, ins):
        np.testing.assert_array_equal(g[..., fz], x[..., fz])
        np.testing.assert_array_equal(w[..., fz], x[..., fz])
    same = (got[5][0] == want[5][0]) & (got[6][0] == want[6][0]) & ~fz
    live = ~fz

    def lane_rel(k):
        scale = np.abs(want[k]).max(axis=(0, 1))
        return (np.abs(got[k] - want[k]).max(axis=(0, 1)) / scale)[same]

    err = dict(
        agree=float(same[live].mean()),
        alpha=lane_rel(0).max(),
        traj=np.abs(got[2] - want[2])[..., same].max(),
        vel=np.abs(got[3] - want[3])[..., same].max(),
        loss=np.abs(got[4][0][same] / want[4][0][same] - 1).max(),
        grad=float((lane_rel(1) <= 1e-4).mean()),
    )
    print(f"exact step from {start}: {err}")
    if start == "moderate":
        assert err["agree"] == 1.0 and err["grad"] == 1.0
        bounds = dict(alpha=1e-6, traj=1e-6, vel=1e-5, loss=2e-5)
    else:
        assert err["agree"] >= 0.9
        bounds = dict(alpha=1e-6, traj=1e-2, vel=5e-2, loss=2e-2)
    for k, bound in bounds.items():
        assert err[k] <= bound, (k, err[k])


def test_exact_fused_solve_matches_jax(setup):
    """The whole short solve (2 rounds x 6 steps) on 128 random scenes
    against pallas_step.fused_solve(ladder_eval="exact", interpret=True):
    SOLVE_AGREEMENT_MIN of the lanes end with equal counts and flags, alpha
    within ALPHA_REL_MAX of the lane's scale there; the mean final loss
    within 1%.  The wrapper runs the plain version on CPU tensors."""
    jcfg, tcfg, jb, _ = setup
    d = _kernel_inputs(jcfg, jb, 9)
    args = (*d["basis"], d["a0"], d["lsg0"], d["ljl0"], *d["lanes"])
    want = jax.tree_util.tree_map(
        np.asarray, ps.fused_solve(jcfg, *args, block_b=B, interpret=True))
    before = tfs.fused_solve.launches
    got = tfs.fused_solve(tcfg, *map(_t, args))
    assert tfs.fused_solve.launches == before == 0
    agree, rel = tfs.lane_agreement(want, got)
    wl, gl = float(want.final_loss.mean()), float(got.final_loss.mean())
    print(f"exact fused solve: lane agreement {agree:.4f}, alpha rel "
          f"{rel:.3g}; mean final loss {gl:.6f} against {wl:.6f}")
    assert agree >= SOLVE_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    assert abs(gl - wl) <= 0.01 * abs(wl)
    assert np.isfinite(got.alpha.numpy()).all()


def test_exact_fused_round_matches_jax(setup):
    """One round (n_r = 4) against pallas_step.fused_round(ladder_eval=
    "exact", interpret=True) on the outputs the caller reads: on the live
    lanes, ROUND_AGREEMENT_MIN agree on the step count and the constraint
    flag, alpha within 1e-5 of the lane's scale and the loss within 5e-2
    there (measured 3.7e-3, up to 2.1e-2 over seeds: the round's end loss
    is evaluated exactly near the warm start, whose coefficients cancel);
    fulfilled lanes pass through."""
    jcfg, tcfg, jb, _ = setup
    d = _kernel_inputs(jcfg, jb, 0)
    head = (*d["basis"], d["a0"], d["lsg"], d["ljl"], d["ful"], d["lr"])
    want = [np.asarray(x) for x in ps.fused_round(
        jcfg, *head, 4, *d["lanes"], block_b=B, interpret=True)]
    alpha, loss, ok, inner = (x.numpy() for x in tfs.fused_round(
        tcfg, *map(_t, head), 4, *map(_t, d["lanes"])))
    live = d["ful"][0] < 0.5
    same = live & (inner[0] == want[3][0]) & (ok[0] == want[2][0])
    scale = np.abs(want[0]).max(axis=(0, 1))
    rel = (np.abs(alpha - want[0]).max(axis=(0, 1)) / scale)[same]
    lrel = np.abs(loss[0][same] / want[1][0][same] - 1)
    agree = float(same[live].mean())
    print(f"exact round: live-lane agreement {agree:.4f}, alpha rel "
          f"{rel.max():.3g}, loss rel {lrel.max():.3g}")
    assert agree >= ROUND_AGREEMENT_MIN
    assert rel.max() <= 1e-5
    assert lrel.max() <= 5e-2
    np.testing.assert_array_equal(alpha[:, :, ~live], d["a0"][:, :, ~live])
    assert (inner[0][~live] == 0).all() and (want[3][0][~live] == 0).all()


def test_exact_xla_matches_jax(setup):
    """fleet_solve(backend="xla", ladder_eval="exact") against JAX's on 128
    random scenes at SHORT (PRNGKey(3)): XLA_AGREEMENT_MIN of the lanes,
    alpha within ALPHA_REL_MAX of the lane's scale there; the mean final
    loss within 1%."""
    _xla_against_jax(setup, 3)


def test_exact_xla_matches_jax_at_the_lowest_key(setup):
    """The same at PRNGKey(2), the lowest agreement of the ten keys
    measured."""
    _xla_against_jax(setup, 2)


def _xla_against_jax(setup, key):
    _, tcfg, jb, tb = setup
    jcfg = mp.PlannerConfig(**SHORT)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(key), B)
    want = jfleet.fleet_solve(jcfg, jb, scns, backend="xla")
    got = tfleet.fleet_solve(tcfg, tb, _tscn(scns), backend="xla")
    agree, rel = tfs.lane_agreement(_as_fused(want), _as_fused(got))
    wl = float(np.asarray(want.stats.final_cost).mean())
    gl = float(got.stats.final_cost.mean())
    print(f"exact xla: lane agreement {agree:.4f}, alpha rel {rel:.3g}; mean "
          f"final loss {gl:.6f} against {wl:.6f}")
    assert agree >= XLA_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    assert abs(gl - wl) <= 0.01 * abs(wl)
    assert torch.isfinite(got.stats.final_cost).all()


@pytest.fixture(scope="module")
def rounds_setup():
    """64 random scenes at 3 rounds (48/8/4 steps), long enough that some
    lanes converge, and the exact tier's fused solve of them."""
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(48, 8, 4),
                           max_inner_iteration=48, fixed_iters=True,
                           max_obstacles=11, ladder_eval="exact")
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(6), 64,
                               device="cpu")
    return cfg, basis, scns, tfleet.fleet_solve(cfg, basis, scns,
                                                backend="fused")


def _assert_solve_equal(a, b):
    assert torch.equal(a.alpha, b.alpha)
    for x, y in zip(a.stats, b.stats):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("path", ["pallas", "rounds", "compaction"])
def test_exact_tier_equal_on_the_kernel_paths(rounds_setup, path):
    """The exact tier's plain versions on the CPU: the per-step path (K5 at
    each round start, then K3 per step, no K6), the rounds driver over K2
    and the same with lane compaction each equal the whole-solve K1's plain
    version bit for bit, as the JAX package holds its own; the kernels are
    held to the same on the card (chip_smoke.py)."""
    cfg, basis, scns, want = rounds_setup
    assert 0 < float(want.stats.converged.float().mean()) < 1
    if path == "pallas":
        n6 = sk.forward_eval.launches
        got = tfleet.fleet_solve(cfg, basis, scns, backend="pallas")
        assert sk.forward_eval.launches == n6
    elif path == "rounds":
        got = tfleet._fused_rounds_solve(
            cfg, tfleet.fused_args(cfg, basis, scns)[1:])
    else:
        got = tfleet.fleet_solve(cfg.replace(lane_compaction=True), basis,
                                 scns, backend="fused")
    _assert_solve_equal(got, want)


def test_exact_tier_runs_the_xla_engine(rounds_setup):
    """The xla engine in the exact tier on the same scenes: finite results,
    and a converged fraction within 0.1 of the fused path's (their fp paths
    differ, so lanes part)."""
    cfg, basis, scns, fused = rounds_setup
    got = tfleet.fleet_solve(cfg, basis, scns, backend="xla")
    conv = [float(r.stats.converged.float().mean()) for r in (got, fused)]
    print(f"exact tier converged: xla {conv[0]:.4f}, fused {conv[1]:.4f}")
    assert torch.isfinite(got.stats.final_cost).all()
    assert abs(conv[0] - conv[1]) <= 0.1


def test_plain_exact_round_skips_the_end_of_round_forward(rounds_setup):
    """In the exact tier the round's carried (traj, vel) are the exact
    evaluation of its final alpha, bit for bit, so run_inner returns them
    without re-evaluating (as the JAX kernel skips it)."""
    cfg, basis, scns, _ = rounds_setup
    args = tfleet.fused_args(cfg, basis, scns)
    kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args[1:]
    B = a0.shape[-1]
    alpha, traj, vel, _, _ = tfs.run_inner(
        cfg, tfs.consts(cfg), kv, kvt, mix, start, goal,
        tfs.obs_ctx(ox, oy, ow), a0, lsg[0], ljl[0],
        torch.zeros(B, dtype=torch.bool), torch.full((B,), cfg.bls_lr_start),
        8, torch.zeros(B))
    t2, v2 = tfs.forward_planes(kv, mix, alpha)
    assert torch.equal(traj, t2) and torch.equal(vel, v2)


def test_backend_defaults_to_xla():
    """fleet_solve and make_fleet_solver default to the plain xla engine,
    as the JAX package's do (JAX solvers/fleet.py:912, :1037)."""
    for fn in (tfleet.fleet_solve, tfleet.make_fleet_solver):
        assert inspect.signature(fn).parameters["backend"].default == "xla"
    for fn in (jfleet.fleet_solve, jfleet.make_fleet_solver):
        assert inspect.signature(fn).parameters["backend"].default == "xla"
    cfg = mt.PlannerConfig(max_inner_iteration=2, max_outer_iteration=1,
                           fixed_iters=True, max_obstacles=11)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(1), 8,
                               device="cpu")
    n1 = tfs.fused_solve.launches
    _assert_solve_equal(tfleet.make_fleet_solver(cfg, basis)(scns),
                        tfleet.fleet_solve(cfg, basis, scns, backend="xla"))
    assert tfs.fused_solve.launches == n1
    # Compaction belongs to the fused backend: without backend= it raises,
    # as in the JAX package.
    with pytest.raises(ValueError, match="lane_compaction"):
        tfleet.fleet_solve(cfg.replace(lane_compaction=True), basis, scns)


def test_bench_exact_cpu_rehearsal(capsys):
    """bench --ladder-eval exact end to end on the plain path: the
    reference scene at B=2 over the full schedule, gated at endpoint < 0.05
    (JAX bench.py's bound for the exact ladder) and the costs within 2%.
    Measured: avg 1.6462, max 2.1965, endpoint 0.0099 (the accepted alpha
    and the rung candidates rounded once, as XLA forms them)."""
    rc = bench.main(["--device", "cpu", "--batch", "2", "--repeats", "1",
                     "--ladder-eval", "exact"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    print(out)
    assert rc == 0 and out["quality_ok"] is True
    assert out["endpoint_err"] < 0.05
    assert bench.endpoint_bound(bench.bench_config(ladder_eval="exact"),
                                "bls") == 0.05
    assert bench.endpoint_bound(bench.bench_config(), "bls") == 0.01


def test_roofline_counts_the_exact_ladder():
    """The exact tier's bounds: a rung adds the candidate and its forward to
    the linearized rung's FK, field and loss; a step drops the direction's
    forward and the hoist; the pull-back adds the loss; a round drops the
    end-of-round forward; K1 pays the round-start forward once per lane."""
    n = roofline.LaneOps.at(50, 3, 11)
    assert n.rung_exact - (n.rung - 4 * 3 * 50) == n.trial + n.forward
    assert n.step - n.step_exact == n.forward + 2 * 100 * 3 + 4 * 3 * 50
    tally = {"steps": torch.ones(4), "rungs": 2 * torch.ones(4),
             "pullbacks": torch.tensor([1.0, 1.0, 0.0, 1.0]),
             "rounds": torch.ones(4)}
    lin = roofline.fused_rounds(4, 50, 3, 11, tally, True)
    ex = roofline.fused_rounds(4, 50, 3, 11, tally, True, ladder_eval="exact")
    assert ex.bytes == lin.bytes
    assert ex.ops - lin.ops == (
        4 * (n.step_exact - n.step) + 8 * (n.rung_exact - n.rung)
        + 3 * n.loss - 4 * n.forward)
    # K1 evaluates alpha through the basis once per lane, at its first
    # round's start; K2 at every round's.
    many = dict(tally, rounds=3 * torch.ones(4))
    for tier in ("linearized", "exact"):
        k1, k2 = (roofline.fused_rounds(4, 50, 3, 11, many, whole, "bls", tier)
                  for whole in (True, False))
        assert k2.ops - k1.ops == 8 * n.forward
    k3 = roofline.bls_inner_step(4, 50, 3, 11, tally, ladder_eval="exact")
    assert k3.ops == 4 * (n.step_exact + 4) + 8 * (n.rung_exact + 4) + 3 * (
        n.cost + n.loss + n.grad)


@pytest.mark.slow
def test_exact_tier_certifies_against_the_cpu_oracle():
    """The exact tier (fused backend, lane compaction, the bench's per-round
    schedule) on the 2,048 scenes of certify_oracle_cpu2048.npz, against
    the reference's sequential solver's stored outcomes, under
    benchmarks/certify.py's statistics and bounds: both-converged mean gaps
    within 0.25% and medians within 0.1%, converged fraction no more than
    0.06 below the oracle's.  Measured on the CPU: converged 0.5542 against
    the oracle's 0.2979; both converged (581 scenes) mean gaps -0.145% (avg)
    and +0.065% (max), medians +0.006% and +0.014%."""
    data = np.load(os.path.join(ROOT, "certify_oracle_cpu2048.npz"))
    row = certify.certify_exact(data, torch.device("cpu"))
    bc = row["both_converged"]
    print(json.dumps(row))
    assert row["engine_converged_frac"] >= (row["oracle_converged_frac"]
                                            - certify.CONV_SLACK)
    for k in ("avg", "max"):
        assert bc[k]["mean_gap"] <= certify.MEAN_BOUNDS["exact"]
        assert abs(bc[k]["p50_gap"]) <= certify.MEDIAN_BOUNDS["exact"]
    assert row["pass"]
