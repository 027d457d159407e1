"""The kernels' reach against the JAX package's: the port's launch planner
(ops/fused_solve.py ``kernel_plan``, ``launch_plan``'s "reach" plan) held
to JAX's ``pallas_step.choose_kernel_plan`` on a grid of T, obstacle
counts, solvers and ladders; the reach plan's ceilings; the plans below
them unchanged; and ``fleet_solve``'s dispatch of the reach plan (the fused
backend runs K1/K2's plain versions on the CPU, the per-step backend warns
and runs ``xla``, as JAX's does at its lean and ultra plans).

The reach plan is the streamed body with the gradient pass recomputing the
FK tangents instead of keeping them in the direction planes: GD and the
exact ladder then hold no direction planes (one lane per CTA up to T =
2,636 at 11 obstacles), the linearized ladder holds the tile's gx/gy
planes in them (up to T = 2,156).  It computes the streamed plan's floats,
which the card holds bit for bit (chip_smoke.py phase 23); on the CPU the
kernels run their plain versions, which know no plan.
"""

import warnings

import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.ops import pallas_step as ps
from irm_motion_planning_tpu.solvers import fleet as jfleet

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import roofline
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SMEM_LIMIT = 232448
# JAX's planner at a batch of 4,096 lanes, on the grid of T it streams (T %
# 8 == 0: JAX's row blocks stay 8-aligned), for J = 3.
JAX_B = 4096
GRID_T = range(72, 2801, 8)
SOLVERS = (("gd", "linearized"), ("bls", "linearized"), ("bls", "exact"))
# Past the streamed plan's ceiling (T = 2,072 at 11 obstacles).
PAST_F32 = 2080
# JAX's xla engine against the port's plain K1-GD on the reference scene at
# 1 round x 2 steps of learning rate GD_LR, JAX's basis on both sides (at
# the default gd_lr, 2e-3, the stop test rejects the first trial at these
# T; at GD_LR both steps are accepted): alpha within GD_ALPHA_REL of the
# largest |alpha|, the final loss within GD_LOSS_RTOL (measured 2.4e-8 and
# 9.4e-6 at T = 2,080, 6.8e-8 and 1.06e-4 at 2,560: the warm start's O(1e3)
# coefficients cancel to O(1) in the basis products, whose sums over T
# XLA and torch order differently, so the loss parts by far more than
# alpha).
GD_LR = 1e-4
GD_ALPHA_REL = 2e-7
GD_LOSS_RTOL = 3e-4
ARMS = {5: (1.0, 0.8, 0.6, 0.4, 0.2), 7: (1.0, 0.9, 0.8, 0.7, 0.6, 0.5,
                                          0.4)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("O", [4, 11, 16])
@pytest.mark.parametrize("solver,ladder", SOLVERS)
def test_port_plans_a_kernel_wherever_jax_does(solver, ladder, O):
    """For T = 72-2,800 in steps of 8, the bf16 opt-in on and off: wherever
    JAX's choose_kernel_plan plans a kernel, the port's kernel_plan plans
    one, and wherever JAX's plan is float32 the port's is too (its
    ``bf16`` false).  JAX plans GD to T = 2,560 and BLS to 2,104 in
    float32 (its ultra tiers), then BLS with the opt-in in bfloat16 to
    2,320; the port plans GD and the exact ladder to 2,636 and the
    linearized ladder to 2,156 in float32, then the opt-in's bf16 plan."""
    for opt in (False, True):
        for T in GRID_T:
            kw = dict(n_timesteps=T, max_obstacles=O, ladder_eval=ladder,
                      bls_bf16_ladder=opt)
            want = ps.choose_kernel_plan(mp.PlannerConfig(**kw), T, JAX_B,
                                         solver=solver)
            got = tfs.kernel_plan(mt.PlannerConfig(**kw), O, solver)
            if want is None:
                continue
            assert got is not None, (T, opt)
            assert want.bf16 or not got["bf16"], (T, opt)


@pytest.mark.parametrize("prog,O,top,piece", [
    ("gd", 4, 2637, "buffer"), ("gd", 11, 2636, "buffer"),
    ("gd", 16, 2636, "buffer"), ("bls_exact", 11, 2636, "buffer"),
    ("bls", 4, 2158, "planes"), ("bls", 11, 2156, "planes"),
    ("bls", 16, 2156, "planes"), ("bls_ultra", 11, 2156, "planes")])
def test_reach_ceilings(prog, O, top, piece):
    """The reach plan's last T at J = 3: one lane fills the CTA, whose
    other warps help with its products, and K7's ring keeps a timestep per
    stage; one T past it no plan of the program fits, and the message names
    the largest piece (GD and the exact ladder: the buffer, their
    direction planes gone; the linearized ladder: the planes)."""
    cfg = mt.PlannerConfig(n_timesteps=top)
    plan = tfs.launch_plan(cfg, O, prog=prog)
    assert plan["plan"] == "reach" and not plan["bf16"]
    assert (plan["lanes"], plan["warps"]) == (1, tfs.STREAM_WARPS)
    assert plan["total"] == sum(plan["bytes"].values()) <= SMEM_LIMIT
    assert min(plan["ring"]["kv"]["stage_t"],
               plan["ring"]["kvt"]["stage_t"]) >= 1
    with pytest.raises(NotImplementedError, match=f"largest piece is {piece}"):
        tfs.launch_plan(cfg.replace(n_timesteps=top + 1), O, prog=prog)
    solver, ladder, _ = tfs.program_call(prog)
    if prog in ("gd", "bls_exact"):
        assert tfs.kernel_plan(cfg.replace(n_timesteps=top + 1,
                                           ladder_eval=ladder), O,
                               solver) is None


@pytest.mark.parametrize("J,prog,streamed,top", [
    (5, "gd", 1208, 1524), (5, "bls", 1208, 1218),
    (7, "gd", 965, 1259), (7, "bls", 965, 965)])
def test_reach_ceilings_of_other_arms(J, prog, streamed, top):
    """The ceilings at J = 5 and 7 (11 obstacles): the streamed plan's and
    the reach plan's.  GD's reach layout gains the direction planes'
    bytes (its ceiling is the bf16 plan's); the linearized ladder's gains
    the room's gx/gy planes less K7's smallest ring, which at J = 7 is
    nothing."""
    cfg = mt.PlannerConfig(n_joints=J, link_length=ARMS[J])
    for plan, last in (("streamed", streamed), ("reach", top)):
        assert tfs.launch_plan(cfg.replace(n_timesteps=last), 11, plan,
                               prog)["lanes"] == 1
        with pytest.raises(NotImplementedError):
            tfs.launch_plan(cfg.replace(n_timesteps=last + 1), 11, plan,
                            prog)
    print(f"J={J} {prog}: streamed to T={streamed}, reach to T={top}")


@pytest.mark.parametrize("T,plan,lanes,total", [
    (50, "resident", 16, 109168), (200, "streamed", 8, 232448),
    (2072, "streamed", 1, 232448)])
def test_plans_below_the_reach_are_unchanged(T, plan, lanes, total):
    """At T = 50, 200 and 2,072 (11 obstacles) every solver and ladder
    keeps the plan it had before the reach plan, piece for piece: the
    reach plan is selected only where the streamed one does not fit.  The
    reach plan may be asked for where both fit; it then differs only in the
    pieces it drops."""
    for solver, ladder in SOLVERS:
        for opt in (False, True):
            cfg = mt.PlannerConfig(n_timesteps=T, ladder_eval=ladder,
                                   bls_bf16_ladder=opt
                                   and ladder == "linearized")
            got = tfs.kernel_plan(cfg, 11, solver)
            assert (got["plan"], got["lanes"], got["total"]) == (
                plan, lanes, total)
            assert not got["bf16"]
            if T == 2072:
                assert got["bytes"] == {
                    "mix": 48, "control": 80, "room": 16576,
                    "planes": 99456, "buffer": 66304, "obstacles": 176,
                    "endpoints": 80, "state": 49728}
    if T > tfs.WARP_MAX_T:
        cfg = mt.PlannerConfig(n_timesteps=T)
        gd = tfs.launch_plan(cfg, 11, "reach", "gd")
        bls = tfs.launch_plan(cfg, 11, "reach", "bls")
        n, m = gd["lanes"], bls["lanes"]
        assert gd["bytes"]["planes"] == gd["bytes"]["state"] == 4 * 6 * T * n
        assert (bls["bytes"]["planes"], bls["bytes"]["state"]) == (
            4 * 12 * T * m, 4 * 6 * T * m)
        assert min(gd["lanes"], bls["lanes"]) >= lanes


def test_reach_plan_refusals():
    """The bf16 tier's program has no reach layout; an unknown plan
    raises; the per-step kernels' plans stay resident or streamed (past
    the streamed plan they raise: the reach plan is K1/K2's)."""
    from irm_motion_planning_tpu_torch.ops import step_kernels as sk

    cfg = mt.PlannerConfig(n_timesteps=PAST_F32)
    with pytest.raises(ValueError, match="float32 programs"):
        tfs.launch_plan(cfg, 11, "reach", "bls_bf16")
    with pytest.raises(ValueError, match="plan"):
        tfs.launch_plan(cfg, 11, "tiled")
    for plan_of in (sk.bls_step_plan, sk.gd_step_plan,
                    sk.cost_grad_eval_plan):
        with pytest.raises(NotImplementedError):
            plan_of(cfg, 11)
    assert sk.gd_step_plan(cfg.replace(n_timesteps=200), 11)["plan"] == (
        "streamed")


def test_bound_counts_the_gradient_pass_fk():
    """ops/roofline.py counts FK in the gradient pass (LaneOps.grad), as
    the reach layouts run it (recomputed from traj and vel), beside the
    cost pass's: K1-GD's bound at T = 2,400 holds it once per round and
    accepted step."""
    T, J, O, B = 2400, 3, 11, 64
    n = roofline.LaneOps.at(T, J, O)
    fk = T * (7 * J - 3)
    pull = 2 * T * (2 * T) * J + T * J * (2 * J - 1)
    assert n.grad == fk + T * (4 + 15 * J) + pull
    tally = {"rounds": 2.0 * B, "steps": 10.0 * B, "accepted": 8.0 * B}
    bound = roofline.fused_rounds(B, T, J, O, tally, True, "gd",
                                  streamed=True)
    assert bound.ops == (B * n.forward + 2 * B * (n.cost + n.loss + n.grad
                                                  + n.constraints)
                         + 10 * B * (n.trial + n.forward + n.cost + n.loss)
                         + 8 * B * n.grad)


@pytest.fixture(scope="module", params=[PAST_F32, 2560])
def gd_far(request):
    """GD past the streamed plan's ceiling: JAX's basis at T (through
    basis_from_numpy, so both packages hold the same bits), the reference
    scene on 2 lanes, 1 round x 2 steps at GD_LR, and JAX's xla engine's
    solve."""
    T = request.param
    kw = dict(n_timesteps=T, max_inner_iteration=2, max_outer_iteration=1,
              fixed_iters=True, max_obstacles=11, gd_lr=(GD_LR,))
    jcfg, cfg = mp.PlannerConfig(**kw), mt.PlannerConfig(**kw)
    jb = mp.make_basis(jcfg)
    basis = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                                 for k in jb._fields}, device="cpu")
    want = jfleet.fleet_solve(
        jcfg, jb, mp.replicate_scenario(mp.reference_scenario(jcfg), 2),
        solver="gd", backend="xla")
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device="cpu"), 2)
    return cfg, basis, scns, want


def test_fused_gd_runs_the_reach_plan(gd_far):
    """fleet_solve(solver="gd", backend="fused") past the streamed plan's
    ceiling: the reach plan, no warning, no launch on the CPU (K1-GD's
    plain version), held to JAX's xla engine on the same inputs (alpha
    within GD_ALPHA_REL of its scale, the loss within GD_LOSS_RTOL, the
    counts and flags equal; both steps accepted)."""
    cfg, basis, scns, want = gd_far
    plan = tfs.kernel_plan(cfg, 11, "gd")
    assert plan["plan"] == "reach" and plan["lanes"] == 1
    before = tfs.fused_solve.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tfleet.fleet_solve(cfg, basis, scns, solver="gd",
                                 backend="fused")
    assert tfs.fused_solve.launches == before
    ref = np.asarray(want.alpha)
    rel = float(np.abs(got.alpha.numpy() - ref).max() / np.abs(ref).max())
    print(f"T={cfg.n_timesteps}: alpha {rel:.3g} of its scale from JAX's xla")
    assert rel <= GD_ALPHA_REL
    *counts, loss = zip(got.stats, want.stats)
    for x, y in counts:
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_allclose(loss[0].numpy(), np.asarray(loss[1]),
                               rtol=GD_LOSS_RTOL)
    assert (got.stats.inner_iters == 2).all()


def test_pallas_falls_back_at_the_reach_plan(gd_far):
    """The per-step kernels have no reach layout: ``pallas`` warns and runs
    the xla engine there, bit for bit backend="xla" (JAX's per-step
    backend does the same at its lean and ultra plans)."""
    cfg, basis, scns, _ = gd_far
    xla = tfleet.fleet_solve(cfg, basis, scns, solver="gd", backend="xla")
    with pytest.warns(UserWarning, match="no reach layout"):
        got = tfleet.fleet_solve(cfg, basis, scns, solver="gd",
                                 backend="pallas")
    assert torch.equal(got.alpha, xla.alpha)
    for x, y in zip(got.stats, xla.stats):
        assert torch.equal(x, y)


def test_opt_in_takes_float32_where_jax_does():
    """At T = 2,080-2,104 (11 and 16 obstacles) JAX's planner runs float32
    with or without ``bls_bf16_ladder``; so does the port: the reach plan,
    ``bf16`` false, so fleet_solve's fused backend runs the linearized
    program, not the bf16 tier."""
    for O in (11, 16):
        for T in range(PAST_F32, 2105, 8):
            cfg = mt.PlannerConfig(n_timesteps=T, max_obstacles=O,
                                   bls_bf16_ladder=True)
            jplan = ps.choose_kernel_plan(
                mp.PlannerConfig(n_timesteps=T, max_obstacles=O,
                                 bls_bf16_ladder=True), T, JAX_B)
            plan = tfs.kernel_plan(cfg, O)
            assert not jplan.bf16 and jplan.ultra
            assert plan["plan"] == "reach" and not plan["bf16"]
