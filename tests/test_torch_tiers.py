"""The kernel tiers of the fused solve (ops/fused_solve.py: the lean tier,
which runs the linearized program ``bls``, and the programs ``bls_ultra``
and ``bls_bf16`` of K1/K2) against the JAX package's
``pallas_step.fused_solve``/``fused_round`` with the same
``lean``/``ultra``/``bf16`` keywords, run interpreted on the CPU with
``recip_newton=True`` (the interpreted approximate reciprocal is off by
4e-3; see test_torch_fused_solve.py); how the tiers map onto the programs
for GD and the exact ladder; the launch planner's choice of the bf16 plan;
and ``fleet_solve``'s dispatch of it.

Short configs (T = 25, 16 lanes, 2 rounds x 4 steps) keep the file quick.
The tolerances are tighter than those of the JAX package's own tier tests
(tests/test_fleet_fused.py: alpha within rtol = atol = 1e-3 for lean,
0.05 for ultra and bf16, i.e. about 1 and 57 on these coefficients; at
most 1 or 2 fulfilled flags apart; equal step counts on >= 0.75 of the
lanes): alpha within an absolute ALPHA_TOL (K1) and ROUND_ALPHA_TOL (K2),
each about three times the difference measured here (seed 9, on
coefficients of scale 1.1e3): K1 3.5e-3 (lean), 2.0e-3 (ultra), 9.8e-3
(bf16); K2 1.8e-4, 1.8e-4, 3.7e-4; no fulfilled flag apart; equal step
counts on 0.94, 1.0 and 0.94 of the lanes.  A neighbouring tier fails
them (test_wrong_tier_fails): the bf16 tier against JAX's ultra or lean
and the reverse (K2 alpha 2.5e-3 apart; K1 steps equal on 0.69 of the
lanes).  Lean and ultra part by no more than the fp noise at this size
(the port's lean is 2.0e-3 from JAX's ultra); ultra's departure shows at
T = 200 (PERF.md section 7).

A lane of the bf16 tier that stops before its round ends keeps its stop
step's loss in the port (one warp per lane: the lane is its own tile); in
a JAX tile that still has live lanes it takes the baseline re-evaluated
on the rounded planes at each later step.  So K2's round loss is held to
one bfloat16 rounding (2^-8 relative; measured 2.9e-3).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.ops import pallas_step as ps
from irm_motion_planning_tpu.solvers import fleet as jfleet

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.models import rkhs
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SHORT = dict(n_timesteps=25, max_inner_iteration=4, max_outer_iteration=2,
             fixed_iters=True, max_obstacles=11)
B = 16
SEED = 9
TIERS = {"lean": dict(lean=True), "ultra": dict(lean=True, ultra=True),
         "bf16": dict(lean=True, ultra=True, bf16=True)}
# The program each tier runs.
PROGRAM = {"lean": "bls", "ultra": "bls_ultra", "bf16": "bls_bf16"}
# Alpha against JAX's, absolute (see the module docstring).
ALPHA_TOL = {"lean": 1e-2, "ultra": 6e-3, "bf16": 3e-2}
ROUND_ALPHA_TOL = {"lean": 6e-4, "ultra": 6e-4, "bf16": 1.2e-3}
FULFILLED_APART_MAX = 1
LOSS_REL = 2.0**-8
STEPS_EQUAL_MIN = 0.75


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain solves here are small: one intra-op thread runs them as
    fast as many, and spares the cores the suite's other workers use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def setup():
    jcfg = mp.PlannerConfig(recip_newton=True, **SHORT)
    tcfg = mt.PlannerConfig(**SHORT)
    basis = mp.make_basis(jcfg)
    fsc = jfleet.to_fleet(mp.random_scenarios(jcfg, jax.random.PRNGKey(SEED),
                                              B))
    a0 = jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, basis, fsc), 1, 0)
    args = (basis.kv, basis.kv.T, basis.mix, a0,
            jnp.full((1, B), jcfg.lambda_sg_constraint, jnp.float32),
            jnp.full((1, B), jcfg.lambda_jl_constraint, jnp.float32),
            fsc.start, fsc.goal, fsc.obstacles[:, 0, :],
            fsc.obstacles[:, 1, :], fsc.obstacle_weight)
    # One round's inputs: a quarter of the lanes fulfilled, penalties
    # escalated x1/x10/x100, four learning rates.
    rng = np.random.default_rng(SEED)
    ful = (rng.random((1, B)) < 0.25).astype(np.float32)
    esc = np.array([1.0, 10.0, 100.0], np.float32)[rng.integers(0, 3, (1, B))]
    lr0 = np.array([0.2, 0.1, 0.05, 0.3], np.float32)[
        rng.integers(0, 4, (1, B))]
    rargs = (*args[:4], args[4] * esc, args[5] * esc, jnp.asarray(ful),
             jnp.asarray(lr0), 4, *args[6:])
    return jcfg, tcfg, args, rargs


def _torch(args):
    return [x if isinstance(x, int) else _t(x) for x in args]


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's fused_solve and fused_round in each tier, interpreted: {tier:
    (K1, K2)}, each run once for the cases that hold the port to it."""
    jcfg, _, args, rargs = setup
    return {tier: (ps.fused_solve(jcfg, *args, solver="bls", block_b=B,
                                  interpret=True, **kw),
                   ps.fused_round(jcfg, *rargs, solver="bls", block_b=B,
                                  interpret=True, **kw))
            for tier, kw in TIERS.items()}


def _close(want, got, tier, label):
    """K1's solution in a tier against JAX's in ``tier``: alpha everywhere
    within ALPHA_TOL[tier], the fulfilled flags, and the step counts."""
    want, got = [_t(x) for x in want], list(got)
    dalpha = float((want[0] - got[0]).abs().max())
    apart = int((want[2] != got[2]).sum())
    same = float((want[-1] == got[-1]).float().mean())
    print(f"{label}: max |alpha| diff {dalpha:.3g} (scale "
          f"{float(want[0].abs().max()):.3g}), fulfilled apart {apart}, "
          f"equal step counts {same:.3f}")
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=ALPHA_TOL[tier])
    assert apart <= FULFILLED_APART_MAX
    assert same >= STEPS_EQUAL_MIN


def _round_close(want, got, live, tier, label):
    """K2's round in a tier against JAX's in ``tier``: alpha on every lane
    within ROUND_ALPHA_TOL[tier], and on the lanes that came in live the
    constraint flag, the step count and the round's loss (within LOSS_REL:
    see the module docstring)."""
    w = [_t(x) for x in want]
    dalpha = float((w[0] - got.alpha).abs().max())
    same = ((w[2] == got.ok) & (w[3] == got.inner))[0] | ~live
    loss_rel = ((w[1] - got.loss).abs() / w[1].abs())[0][live & same]
    print(f"{label}: max |alpha| diff {dalpha:.3g}, lanes agreeing "
          f"{float(same.float().mean()):.3f}, loss rel "
          f"{float(loss_rel.max()):.3g}")
    np.testing.assert_allclose(got.alpha.numpy(), w[0].numpy(), rtol=0,
                               atol=ROUND_ALPHA_TOL[tier])
    assert float(same.float().mean()) >= STEPS_EQUAL_MIN
    assert float(loss_rel.max()) <= LOSS_REL


@pytest.mark.parametrize("tier", list(TIERS))
def test_fused_solve_tier_matches_jax(setup, jax_runs, tier):
    """K1's plain version in each tier against JAX's fused_solve in the
    same tier, and the program that runs it."""
    _, tcfg, args, _ = setup
    kw = TIERS[tier]
    want = jax_runs[tier][0]
    got = tfs.fused_solve(tcfg, *_torch(args), **kw)
    assert tfs.program(tcfg, "bls", **kw) == PROGRAM[tier]
    _close(want, got, tier, f"K1 {tier}")
    agree, rel = tfs.lane_agreement(tfs.FusedSolve(*map(_t, want)), got)
    assert agree >= tfs.LANE_AGREEMENT_MIN and rel <= tfs.ALPHA_REL_MAX
    assert torch.isfinite(got.final_loss).all()


@pytest.mark.parametrize("tier", list(TIERS))
def test_fused_round_tier_matches_jax(setup, jax_runs, tier):
    """K2's plain version in each tier against JAX's fused_round in the
    same tier (_round_close)."""
    _, tcfg, _, rargs = setup
    got = tfs.fused_round(tcfg, *_torch(rargs), **TIERS[tier])
    _round_close(jax_runs[tier][1], got, _t(rargs[6])[0] < 0.5, tier,
                 f"K2 {tier}")


@pytest.mark.parametrize("kernel, ours, theirs", [
    ("K1", "lean", "bf16"), ("K2", "lean", "bf16"), ("K2", "ultra", "bf16"),
    ("K2", "bf16", "ultra"), ("K2", "bf16", "lean")])
def test_wrong_tier_fails(setup, jax_runs, kernel, ours, theirs):
    """The tolerances tell the tiers apart: the port's plain version in
    tier ``ours`` held to JAX's run in the neighbouring tier ``theirs``
    (under ``theirs``'s tolerances) fails."""
    _, tcfg, args, rargs = setup
    kw = TIERS[ours]
    with pytest.raises(AssertionError):
        if kernel == "K1":
            _close(jax_runs[theirs][0],
                   tfs.fused_solve(tcfg, *_torch(args), **kw), theirs,
                   f"K1 {ours} against JAX's {theirs}")
        else:
            _round_close(jax_runs[theirs][1],
                         tfs.fused_round(tcfg, *_torch(rargs), **kw),
                         _t(rargs[6])[0] < 0.5, theirs,
                         f"K2 {ours} against JAX's {theirs}")


def test_lean_is_the_carry_program_bit_for_bit(setup):
    """The port's lean tier recomputes the loss and FK that the linearized
    program carries from the accepted rung, from the same floats (the
    candidate is formed by the same operations; no contraction into FMAs),
    so its results are the linearized program's bit for bit, K1 and K2
    (in JAX the recompute differs by 1-2 ulp)."""
    _, tcfg, args, rargs = setup
    targs, trargs = _torch(args), _torch(rargs)
    for x, y in zip(tfs.fused_solve(tcfg, *targs, lean=True),
                    tfs.fused_solve(tcfg, *targs)):
        assert torch.equal(x, y)
    for x, y in zip(tfs.fused_round(tcfg, *trargs, lean=True),
                    tfs.fused_round(tcfg, *trargs)):
        assert torch.equal(x, y)


def test_gd_tiers_are_the_gd_program(setup):
    """GD carries no FK, evaluates its trial from alpha and holds no ladder
    planes, so every tier runs GD's one program (JAX's GD-ultra is bitwise
    its GD, tests/test_fleet_fused.py): K1-GD in the ultra (and bf16) tier
    is K1-GD bit for bit."""
    _, tcfg, args, _ = setup
    targs = _torch(args)
    want = tfs.fused_solve(tcfg, *targs, solver="gd")
    for kw in TIERS.values():
        assert tfs.program(tcfg, "gd", **kw) == "gd"
        for x, y in zip(tfs.fused_solve(tcfg, *targs, solver="gd", **kw),
                        want):
            assert torch.equal(x, y)


def test_exact_ladder_ultra_is_the_exact_program(setup):
    """JAX's exact ladder in the lean and ultra tiers is its exact program
    bit for bit (no FK carry; the carried evaluation is exact, so the
    step-start and round-end evaluations recompute the same floats): K2
    here.  The port maps both onto ``bls_exact`` and refuses bf16 there,
    as it refuses ``bls_bf16_ladder`` under the exact ladder."""
    jcfg, tcfg, _, rargs = setup
    jexact, texact = (c.replace(ladder_eval="exact") for c in (jcfg, tcfg))
    want = ps.fused_round(jexact, *rargs, solver="bls", block_b=B,
                          interpret=True)
    got = ps.fused_round(jexact, *rargs, solver="bls", block_b=B,
                         interpret=True, lean=True, ultra=True)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for kw in (TIERS["lean"], TIERS["ultra"]):
        assert tfs.program(texact, "bls", **kw) == "bls_exact"
    with pytest.raises(NotImplementedError):
        tfs.fused_round(texact, *_torch(rargs), bf16=True)
    with pytest.raises(NotImplementedError):
        tfs.fused_round(texact.replace(bls_bf16_ladder=True), *_torch(rargs))


def test_planner_selects_the_bf16_plan_only_past_the_f32_ceiling():
    """kernel_plan: no tier up to T = 2,156 (11 obstacles: the float32
    plans, the reach plan past T = 2,072), whatever the opt-in; past it the
    bf16 plan only with ``bls_bf16_ladder``, only for BLS with the
    linearized ladder, up to T = 2,636; None beyond, and without the
    opt-in.  GD and the exact ladder run their float32 reach plan to T =
    2,636, None beyond.  The ultra tier holds the f32 layout's bytes
    (nothing to drop), the bf16 streamed plan 24 bytes per timestep
    fewer."""
    on = mt.PlannerConfig(max_obstacles=11, bls_bf16_ladder=True)
    for T in (50, 200, 2072, 2156):
        for cfg in (on, on.replace(bls_bf16_ladder=False)):
            plan = tfs.kernel_plan(cfg.replace(n_timesteps=T), 11)
            assert plan is not None and not plan["bf16"]
    for T in (2157, 2200, 2636):
        cfg = on.replace(n_timesteps=T)
        plan = tfs.kernel_plan(cfg, 11)
        assert plan["bf16"] and plan["plan"] == "streamed"
        assert (plan["lanes"], plan["warps"]) == (1, tfs.STREAM_WARPS)
        for other in (tfs.kernel_plan(cfg, 11, "gd"), tfs.kernel_plan(
                cfg.replace(ladder_eval="exact", bls_bf16_ladder=False), 11)):
            assert other["plan"] == "reach" and not other["bf16"]
        assert tfs.kernel_plan(cfg.replace(bls_bf16_ladder=False), 11) is None
    past = on.replace(n_timesteps=2637)
    assert tfs.kernel_plan(past, 11) is None
    assert tfs.kernel_plan(past, 11, "gd") is None
    assert tfs.kernel_plan(past.replace(ladder_eval="exact",
                                        bls_bf16_ladder=False), 11) is None
    cfg = on.replace(n_timesteps=200)
    f32 = tfs.launch_plan(cfg, 11)
    assert tfs.launch_plan(cfg, 11, prog="bls_ultra") == f32
    half = tfs.launch_plan(cfg.replace(pallas_block_b=1), 11, prog="bls_bf16")
    one = tfs.launch_plan(cfg.replace(pallas_block_b=1), 11)
    assert one["total"] - half["total"] == 24 * 200
    assert half["bytes"]["ladder"] == 2 * 4 * 3 * 200
    # The resident plan holds the rounded values as float32: the same bytes.
    assert (tfs.launch_plan(cfg.replace(n_timesteps=50), 11, prog="bls_bf16")
            == tfs.launch_plan(cfg.replace(n_timesteps=50), 11))


# Past the f32 plans' ceiling (the linearized ladder's reach plan's, T =
# 2,157 at 11 obstacles), within the bf16 plan's.
PAST_F32 = 2160


def _basis_at(T):
    """The basis at a T without a committed export: the port's own build
    (models/rkhs.py build_basis, JAX's make_basis op for op)."""
    return rkhs.build_basis(mt.PlannerConfig(n_timesteps=T), device="cpu")


def test_fleet_solve_dispatches_the_bf16_plan():
    """fleet_solve past the f32 ceiling with ``bls_bf16_ladder``: the fused
    backend runs the bf16 tier (its plain version here, bit for bit); the
    per-step backend, which has no such tier, warns and runs the ``xla``
    engine, as JAX's does; without the opt-in the fused backend warns and
    runs ``xla`` too."""
    cfg = mt.PlannerConfig(n_timesteps=PAST_F32, max_inner_iteration=2,
                           max_outer_iteration=1, fixed_iters=True,
                           max_obstacles=11, bls_bf16_ladder=True)
    with pytest.raises(NotImplementedError):
        tfs.launch_plan(cfg, 11)
    assert tfs.kernel_plan(cfg, 11)["bf16"]
    basis = _basis_at(PAST_F32)
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device="cpu"), 2)
    fused = tfleet.fleet_solve(cfg, basis, scns, backend="fused")
    want = tfleet.kernel_result(tfs.fused_solve_reference(
        *tfleet.fused_args(cfg, basis, scns), bf16=True))
    assert torch.equal(fused.alpha, want.alpha)
    for x, y in zip(fused.stats, want.stats):
        assert torch.equal(x, y)
    assert torch.isfinite(fused.alpha).all()
    xla = tfleet.fleet_solve(cfg, basis, scns, backend="xla")
    for c, backend in ((cfg, "pallas"),
                       (cfg.replace(bls_bf16_ladder=False), "fused")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = tfleet.fleet_solve(c, basis, scns, backend=backend)
        assert any("falling back to backend='xla'" in str(w.message)
                   for w in caught)
        assert torch.equal(got.alpha, xla.alpha)
