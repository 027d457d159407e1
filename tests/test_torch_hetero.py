"""The port's heterogeneous-fleet path against the JAX package: the plain
``xla`` engine (batch-trailing math with rung axes, the rung-major BLS
ladder, the dual loop), the fused-round kernel's plain version, the rounds
driver with lane compaction, and the bench's random-scenes mode.

Inputs are made with numpy from a seed, or by JAX's ``random_scenarios`` and
passed across as numpy.  Single evaluations are compared element by
element; whole solves as lane-agreement fractions (a 1-ulp difference grows
about 4x per BLS step, see test_torch_fused_solve.py).  The JAX side of the
fused-round comparison runs with ``recip_newton=True``, as there.
"""

import json

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
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops.costs import Penalty
from irm_motion_planning_tpu_torch.solvers import common as tcommon
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11)
# The port's xla engine against JAX's at SHORT on 128 random scenes
# (PRNGKey(0..5)): 0.54-0.61 of lanes end with equal counts and flags,
# alpha within 1.7e-5 of the lane's scale on those lanes.
XLA_AGREEMENT_MIN = 0.50
# fused_round_reference against pallas_step.fused_round(interpret=True),
# one round of 4 steps on 128 random scenes with penalties escalated x1, x10
# or x100 and four learning rates: 0.87-0.91 of the live lanes agree over
# four seeds, alpha within 1e-6 and the loss within 6e-4 relative on those.
ROUND_AGREEMENT_MIN = 0.85


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


def _assert_solve_equal(a, b):
    assert torch.equal(a.alpha, b.alpha)
    for x, y in zip(a.stats, b.stats):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def bases():
    jb = mp.make_basis(mp.PlannerConfig())
    return jb, mt.make_basis(mt.PlannerConfig(), device="cpu")


@pytest.fixture(scope="module")
def evaluated(bases):
    """64 random scenes (JAX's), a numpy-seeded alpha that reaches the
    joint-limit masks, and JAX's evaluation of it."""
    jb, _ = bases
    cfg = mp.PlannerConfig(max_obstacles=11)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(11), 64)
    fs = jfleet.to_fleet(scns)
    alpha = np.random.default_rng(0).normal(0, 0.15, (50, 3, 64)).astype(np.float32)
    B = 64
    pen = mp.Penalty(jnp.full((B,), 0.5 * 10.0, jnp.float32),
                     jnp.full((B,), 0.1 * 100.0, jnp.float32))
    return cfg, scns, fs, alpha, pen


def test_fleet_cost_grad_eval_matches_jax(bases, evaluated):
    """Loss, gradient, traj and vel at a moderate alpha (no warm-start
    cancellation) with escalated penalties.  Measured: traj and vel equal,
    loss 1.2e-7 relative, grad 7.6e-6 absolute on values up to 353."""
    jb, tb = bases
    cfg, _, fs, alpha, pen = evaluated
    want = [np.asarray(x) for x in
            jfleet.fleet_cost_grad_eval(cfg, jb, fs, pen, alpha)]
    tcfg = mt.PlannerConfig(max_obstacles=11)
    got = tfleet.fleet_cost_grad_eval(tcfg, tb, mt.Scenario(*map(_t, fs)),
                                      Penalty(*map(_t, pen)), _t(alpha))
    loss, grad, traj, vel = (x.numpy() for x in got)
    assert ((traj > 1.96) | (traj < -0.98)).any()   # the masks are live
    np.testing.assert_allclose(traj, want[2], atol=1e-6)
    np.testing.assert_allclose(vel, want[3], atol=1e-5)
    np.testing.assert_allclose(loss, want[0], rtol=1e-6)
    np.testing.assert_allclose(grad, want[1], atol=1e-4)
    c2, g2 = tfleet.fleet_cost_and_grad(tcfg, tb, mt.Scenario(*map(_t, fs)),
                                        Penalty(*map(_t, pen)), _t(alpha))
    assert torch.equal(c2, got[0]) and torch.equal(g2, got[1])


def test_fleet_cost_from_traj_with_rung_axis_matches_jax(bases, evaluated):
    """Ladder candidates (T, J, n+1, B), built as the linearized ladder
    builds them, through the cost with the rung axis before the lanes.
    Measured: 1.2e-7 relative."""
    jb, _ = bases
    cfg, _, fs, alpha, pen = evaluated
    traj, vel = (np.asarray(x) for x in jfleet.fleet_evaluate(cfg, jb, alpha))
    d = np.random.default_rng(1).normal(0, 1, (2,) + traj.shape).astype(np.float32)
    lrs = np.concatenate([0.2 * 0.5 ** np.arange(20, dtype=np.float32),
                          [0.0]]).astype(np.float32)[:, None]      # (n+1, 1)
    ct = (traj[:, :, None] - lrs * d[0][:, :, None]).astype(np.float32)
    cv = (vel[:, :, None] - lrs * d[1][:, :, None]).astype(np.float32)
    want = np.asarray(jfleet.fleet_cost_from_traj(cfg, fs, pen, ct, cv))
    got = tfleet.fleet_cost_from_traj(
        mt.PlannerConfig(max_obstacles=11), mt.Scenario(*map(_t, fs)),
        Penalty(*map(_t, pen)), _t(ct), _t(cv))
    assert got.shape == want.shape == (21, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_blend_weights_tie_picks_first_argmax():
    """A tie for the maximum over T weights the FIRST maximal row, as
    jnp.argmax does."""
    cost_v = np.array([[1.0, 3.0, 2.0],
                       [4.0, 3.0, 2.0],
                       [0.5, 1.0, 2.0],
                       [4.0, 3.0, 1.0]], np.float32)          # (T=4, B=3)
    cfg = mt.PlannerConfig()
    got = tfleet._blend_weights(cfg, _t(cost_v)).numpy()
    want = np.asarray(jfleet._blend_weights(mp.PlannerConfig(), cost_v))
    np.testing.assert_array_equal(got, want)
    lam, mean_w = cfg.lambda_max_cost, (1.0 - cfg.lambda_max_cost) / 4
    assert got[:, 0].tolist() == pytest.approx(
        [mean_w, lam + mean_w, mean_w, mean_w])
    assert got[0, 1] == pytest.approx(lam + mean_w)
    assert got[0, 2] == pytest.approx(lam + mean_w)
    np.testing.assert_allclose(
        tfleet._blend(cfg, _t(cost_v)).numpy(),
        np.asarray(jfleet._blend(mp.PlannerConfig(), cost_v)), rtol=1e-7)


@pytest.mark.parametrize("case", ["one_step", "reference", "random"])
def test_xla_fleet_solve_matches_jax(bases, case):
    """fleet_solve(backend='xla') against JAX's backend='xla'.  One BLS
    step on 128 random scenes: every lane agrees, alpha within 2.7e-6 of
    the lane's scale (measured).  SHORT on the replicated reference scene: every lane
    agrees.  SHORT on 128 random scenes: XLA_AGREEMENT_MIN."""
    jb, tb = bases
    kw = dict(SHORT)
    if case == "one_step":
        kw.update(max_inner_iteration=1, max_outer_iteration=1)
    jcfg, tcfg = mp.PlannerConfig(**kw), mt.PlannerConfig(**kw)
    if case == "reference":
        scns = mp.replicate_scenario(mp.reference_scenario(jcfg), 128)
    else:
        scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(3), 128)
    want = jfleet.fleet_solve(jcfg, jb, scns, backend="xla")
    got = tfleet.fleet_solve(tcfg, tb, _tscn(scns), backend="xla")
    assert got.alpha.shape == (128, 50, 3)
    assert got.stats.inner_iters.dtype == torch.int32
    assert got.stats.outer_iters.dtype == torch.int32
    assert got.stats.converged.dtype == torch.bool
    agree, rel = tfs.lane_agreement(_as_fused(want), _as_fused(got))
    print(f"{case}: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= (XLA_AGREEMENT_MIN if case == "random" else 1.0)
    assert rel <= (1e-5 if case == "one_step" else tfs.ALPHA_REL_MAX)
    if case != "random":
        # The final loss is evaluated from alpha, whose O(1e4) warm-start
        # coefficients cancel in the forward product; measured 8.5e-3
        # relative after one step, 2.8e-4 on the reference scene.
        np.testing.assert_allclose(got.stats.final_cost.numpy(),
                                   np.asarray(want.stats.final_cost),
                                   rtol=2e-2)


def test_xla_inner_budget_caps_a_longer_schedule(bases):
    """A round whose schedule entry (8) exceeds max_inner_iteration (3):
    the budget-exhaustion term of the inner freeze stops every lane at 3
    steps in fixed_iters mode, as in JAX's engine."""
    jb, tb = bases
    kw = dict(max_inner_iteration=3, max_outer_iteration=1, fixed_iters=True,
              inner_schedule=(8,), max_obstacles=11)
    scns = mp.random_scenarios(mp.PlannerConfig(**kw), jax.random.PRNGKey(4), 32)
    want = jfleet.fleet_solve(mp.PlannerConfig(**kw), jb, scns, backend="xla")
    got = tfleet.fleet_solve(mt.PlannerConfig(**kw), tb, _tscn(scns),
                             backend="xla")
    assert int(got.stats.inner_iters.max()) == 3
    assert int(np.asarray(want.stats.inner_iters).max()) == 3


@pytest.mark.parametrize("fixed_iters", [True, False])
def test_run_dual_loop_freezes_exhausted_lanes(fixed_iters):
    """A lane whose outer budget is spent is frozen like a fulfilled one,
    in both loop modes: outer_step leaves it untouched while a live lane
    moves, and a whole loop with a scripted inner minimizer (alpha + 1, 2
    steps, loss = lambda_sg) stops every unfulfilled lane at
    max_outer_iteration rounds."""
    cfg = mt.PlannerConfig(max_outer_iteration=3, fixed_iters=fixed_iters)
    B = 4
    calls = []

    def inner_for(outer_iter, round_idx):
        calls.append(round_idx)

        def inner(alpha, pen):
            return alpha + 1.0, torch.full((B,), 2, dtype=torch.int32), pen.lambda_sg
        return inner

    def never(alpha):
        return torch.zeros(B, dtype=torch.bool)

    pen0 = Penalty(torch.full((B,), 0.5), torch.full((B,), 0.1))
    state = tcommon.OuterState(
        fulfilled=torch.tensor([False, False, True, False]),
        outer_iter=torch.tensor([3, 1, 1, 5], dtype=torch.int32),
        alpha=torch.zeros(2, B), penalty=pen0,
        total_inner=torch.zeros(B, dtype=torch.int32),
        final_loss=torch.full((B,), float("inf")),
    )
    nxt = tcommon.outer_step(cfg, state, inner_for, never, 0)
    moved = torch.tensor([False, True, False, False])
    assert torch.equal(nxt.outer_iter, torch.tensor([3, 2, 1, 5], dtype=torch.int32))
    assert torch.equal(nxt.alpha[0] != 0, moved)
    assert torch.equal(nxt.total_inner, 2 * moved.to(torch.int32))
    assert torch.equal(nxt.penalty.lambda_sg,
                       torch.where(moved, 5.0, 0.5).to(torch.float32))

    calls.clear()
    def fulfilled_after_one(alpha):
        return alpha[0] >= torch.tensor([1.0, 9.0, 9.0, 1.0])

    res = tcommon.run_dual_loop(cfg, torch.zeros(2, B), inner_for,
                                fulfilled_after_one, pen0)
    assert len(calls) == 3
    assert res.stats.converged.tolist() == [True, False, False, True]
    assert res.stats.outer_iters.tolist() == [0, 3, 3, 0]
    assert res.stats.inner_iters.tolist() == [2, 6, 6, 2]
    assert res.alpha[0].tolist() == [1.0, 3.0, 3.0, 1.0]
    # The last round's loss is the lambda it ran under: x10 per escalation.
    assert res.stats.final_cost.tolist() == pytest.approx([0.5, 50.0, 50.0, 0.5])


def test_inner_loop_bound():
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(5, 2, 7))
    assert [tcommon.inner_loop_bound(cfg, r) for r in (0, 1, 2, 9)] == [5, 2, 7, 7]
    assert tcommon.inner_loop_bound(cfg, None) == cfg.max_inner_iteration
    assert tcommon.inner_loop_bound(mt.PlannerConfig(), 1) == 200


@pytest.fixture(scope="module")
def round_inputs(bases):
    """One round's inputs on 128 random scenes: a quarter of the lanes
    fulfilled, penalties escalated x1/x10/x100, four learning rates."""
    jb, _ = bases
    jcfg = mp.PlannerConfig(recip_newton=True, **SHORT)
    rng = np.random.default_rng(0)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(20), 128)
    fs = jfleet.to_fleet(scns)
    a0 = np.asarray(jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, jb, fs), 1, 0))
    B = 128
    ful = (rng.random((1, B)) < 0.25).astype(np.float32)
    esc = rng.choice(np.array([1.0, 10.0, 100.0], np.float32), (1, B))
    lsg = (np.float32(jcfg.lambda_sg_constraint) * esc).astype(np.float32)
    ljl = (np.float32(jcfg.lambda_jl_constraint) * esc).astype(np.float32)
    lr0 = rng.choice(np.array([0.2, 0.1, 0.05, 0.3], np.float32), (1, B))
    head = ([np.asarray(x) for x in (jb.kv, jb.kv.T, jb.mix)]
            + [a0, lsg, ljl, ful, lr0])
    tail = [np.asarray(x) for x in (fs.start, fs.goal, fs.obstacles[:, 0, :],
                                    fs.obstacles[:, 1, :], fs.obstacle_weight)]
    return jcfg, head, tail


def test_fused_round_reference_matches_jax(round_inputs):
    """One round (n_r = 4) against pallas_step.fused_round(interpret=True),
    on the outputs the caller reads: on live lanes the step count, the
    constraint flag, alpha and the loss (ROUND_AGREEMENT_MIN of the lanes
    agree); fulfilled lanes pass through with no steps."""
    jcfg, head, tail = round_inputs
    n_r = 4
    want = [np.asarray(x) for x in
            ps.fused_round(jcfg, *head, n_r, *tail, block_b=128, interpret=True)]
    got = tfs.fused_round(mt.PlannerConfig(**SHORT), *map(_t, head), n_r,
                          *map(_t, tail))
    assert isinstance(got, tfs.FusedRound)
    alpha, loss, ok, inner = (x.numpy() for x in got)
    live = head[6][0] < 0.5
    same = (inner[0] == want[3][0]) & (ok[0] == want[2][0])
    agree = float(same[live].mean())
    scale = np.abs(want[0]).max(axis=(0, 1))
    rel = (np.abs(alpha - want[0]).max(axis=(0, 1)) / scale)[live & same]
    print(f"live-lane agreement {agree:.4f}, alpha rel {rel.max():.3g}")
    assert agree >= ROUND_AGREEMENT_MIN
    assert rel.max() <= 2e-6
    np.testing.assert_allclose(loss[0][live & same], want[1][0][live & same],
                               rtol=2e-3)
    a0 = head[3]
    np.testing.assert_array_equal(alpha[:, :, ~live], a0[:, :, ~live])
    np.testing.assert_array_equal(want[0][:, :, ~live], a0[:, :, ~live])
    assert (inner[0][~live] == 0).all() and (want[3][0][~live] == 0).all()
    # The port defines the don't-cares of fulfilled lanes: loss 0, ok 1.
    assert (loss[0][~live] == 0).all() and (ok[0][~live] == 1).all()


def test_fused_round_wrapper_checks(round_inputs):
    jcfg, head, tail = round_inputs
    args = [_t(x) for x in head]
    tcfg = mt.PlannerConfig(**SHORT)
    before = tfs.fused_round.launches
    got = tfs.fused_round(tcfg, *args, 2, *map(_t, tail))
    ref = tfs.fused_round_reference(tcfg, *args, 2, *map(_t, tail))
    assert tfs.fused_round.launches == before == 0   # CPU: the plain version
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    bad = list(args)
    bad[7] = bad[7][:, :1]                              # lr0
    with pytest.raises(ValueError, match="lr0 float32"):
        tfs.fused_round(tcfg, *bad, 2, *map(_t, tail))
    with pytest.raises(ValueError, match="n_r"):
        tfs.fused_round(tcfg, *args, -1, *map(_t, tail))
    # The bf16 tier runs under the linearized ladder (its plain version
    # here) and raises under the exact one.
    for x, y in zip(tfs.fused_round(tcfg, *args, 2, *map(_t, tail),
                                    bf16=True),
                    tfs.fused_round_reference(tcfg, *args, 2, *map(_t, tail),
                                              bf16=True)):
        assert torch.equal(x, y)
    with pytest.raises(NotImplementedError):
        tfs.fused_round(tcfg.replace(ladder_eval="exact",
                                     bls_bf16_ladder=True), *args, 2,
                        *map(_t, tail))
    # The exact ladder runs: the plain version of its own program.
    exact = tcfg.replace(ladder_eval="exact")
    for x, y in zip(tfs.fused_round(exact, *args, 2, *map(_t, tail)),
                    tfs.fused_round_reference(exact, *args, 2,
                                              *map(_t, tail))):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def rounds_setup():
    """256 random scenes at a 3-round schedule long enough that some lanes
    converge in rounds 1-2 (so compaction moves fulfilled lanes)."""
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(48, 8, 4),
                           max_inner_iteration=48, fixed_iters=True,
                           max_obstacles=11)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(6), 256,
                               device="cpu")
    args = tfleet.fused_args(cfg, basis, scns)
    return cfg, basis, scns, args, tfs.fused_solve(*args)


def test_rounds_driver_equals_fused_solve_bitwise(rounds_setup):
    """Without compaction the rounds driver over fused_round equals the
    whole-solve fused_solve bit for bit on the CPU (the round body is the
    same op sequence and the bookkeeping is op for op the kernel's)."""
    cfg, _, _, args, whole = rounds_setup
    got = tfleet._fused_rounds_solve(cfg, args[1:])
    _assert_solve_equal(got, tfleet.kernel_result(whole))
    assert 0 < float(whole.fulfilled.mean()) < 1


def test_compaction_keeps_per_lane_results(rounds_setup):
    """With compaction the lanes run permuted from round 1 on; after the
    un-permutation every field equals the uncompacted run's bit for bit on
    the CPU (the plain version's basis products give each lane's column the
    same arithmetic wherever it sits).  fleet_solve dispatches to the
    driver on cfg.lane_compaction."""
    cfg, basis, scns, args, _ = rounds_setup
    on = cfg.replace(lane_compaction=True)
    plain = tfleet._fused_rounds_solve(cfg, args[1:])
    compact = tfleet._fused_rounds_solve(on, args[1:])
    _assert_solve_equal(compact, plain)
    via_api = tfleet.fleet_solve(on, basis, scns, backend="fused")
    _assert_solve_equal(via_api, plain)


def test_compaction_order_matches_jnp_argsort():
    """The re-sort after round 0 on a state with ties (equal step counts and
    losses, fulfilled lanes, an infinite loss): the port's permutation
    equals jnp.argsort of JAX's key, computed as fleet.py:618-624 does."""
    rng = np.random.default_rng(5)
    B = 512
    ful = (rng.random((1, B)) < 0.3).astype(np.float32)
    floss = rng.choice(np.array([1.5, 2.25, 7.0, 40.0], np.float32), (1, B))
    floss[0, :4] = np.inf
    steps = rng.integers(0, 6, B).astype(np.float32)
    lo = jnp.where(jnp.isfinite(floss[0]), floss[0], 0.0)
    tie = (lo - lo.min()) / (lo.max() - lo.min() + 1e-9)
    key = jnp.where(ful[0] > 0.5, jnp.float32(jnp.inf),
                    steps + jnp.clip(tie, 0.0, 0.999))
    want = np.asarray(jnp.argsort(key))
    got = tfleet.compaction_order(_t(ful), _t(floss), _t(steps))
    assert len(np.unique(np.asarray(key))) < B // 4     # many ties
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bench_cpu_rehearsal(capsys):
    """The random-scenes mode end to end on the plain path at 128 lanes,
    the paired gate on all of them: it passes, and the JSON line carries
    bench.py's random-mode keys plus device and power_limit.  Measured
    (seed 1): converged 0.5156 against the xla engine's 0.5391 (band
    0.05), obstacle cost 2.5885 against 2.5870 (band 0.0259), phantom 0."""
    rc = bench.main(["--device", "cpu", "--random-scenarios", "--batch", "128",
                     "--repeats", "1", "--seed", "1",
                     "--quality-check-lanes", "128"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    print(out)
    assert rc == 0 and out["quality_ok"] is True
    assert list(out) == [
        "metric", "value", "unit", "vs_baseline", "quality_ok", "scenarios",
        "converged_frac", "mean_final_cost", "paired_check_lanes",
        "phantom_frac", "xla_converged_frac", "mean_obstacle_cost",
        "xla_mean_obstacle_cost", "device", "power_limit",
    ]
    assert out["metric"] == "bls_solves_per_sec_cpu_rehearsal"
    assert out["scenarios"] == "random" and out["paired_check_lanes"] == 128
    assert out["phantom_frac"] == 0.0
