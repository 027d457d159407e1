"""Large T in the port: the committed basis exports for T = 25-200, the
kernels' launch plans beyond T = 64 (the streamed body of K1/K2, whose
basis products stream the basis through K7, and K3-K6 with the basis in
device memory), the fleet solver's fallback past the plans' ceiling, the
``xla`` engine at T = 100 and the port of benchmarks/problemsize.py.

The port's plain versions are held to JAX's kernels at T = 72 with the
streamed basis (``stream_rb`` 24 and 16: 16 leaves a remainder block of 8
rows), interpreted on the CPU, with ``recip_newton=True`` (the interpreted
approximate reciprocal is off by 4e-3; see test_torch_fused_solve.py).
JAX's streamed kernels equal its resident ones bit for bit
(tests/test_fleet_fused.py), and K7 computes the plain versions' basis
products row for row, so the tolerances are those of the resident
comparisons.  The kernels themselves run only on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py phase 17).
"""

import contextlib
import io
import json
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
from irm_motion_planning_tpu_torch.benchmarks import problemsize
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

T72 = 72
B = 32
SHORT = dict(max_inner_iteration=4, max_outer_iteration=1, fixed_iters=True,
             max_obstacles=11)
SMEM_LIMIT = 232448


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


def _as_fused(res):
    """A SolveResult (either package) as the FusedSolve fields
    lane_agreement compares."""
    alpha = torch.tensor(np.asarray(res.alpha)).movedim(0, -1)  # (T, J, B)
    st = [torch.tensor(np.asarray(x)).to(torch.float32)[None]
          for x in (res.stats.final_cost, res.stats.converged,
                    res.stats.outer_iters, res.stats.inner_iters)]
    return tfs.FusedSolve(alpha.movedim(1, 0), *st)


# --------------------------------------------------------------------------
# The basis exports.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T", [25, 100, 150, 200])
def test_export_is_bitwise_the_jax_basis(T):
    """The committed export at T equals JAX's basis bit for bit in all nine
    fields (a 1-ulp change of the Gram data moves the warm start by O(1))."""
    ref = mp.make_basis(mp.PlannerConfig(n_timesteps=T))
    got = mt.make_basis(mt.PlannerConfig(n_timesteps=T), device="cpu")
    for name in ref._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name)


@pytest.mark.parametrize("T", [72, 300])
def test_make_basis_refuses_a_t_without_export(T):
    """A T without a committed export (refused before the port built its
    own basis): make_basis builds it, and the built Gram pair is JAX's
    within an ulp or two (t and c exact, km 1 ulp, kv 2), so the streamed
    plan below evaluates the same operator."""
    got = mt.make_basis(mt.PlannerConfig(n_timesteps=T), device="cpu")
    ref = mp.make_basis(mp.PlannerConfig(n_timesteps=T))
    assert got.kv.shape == (2 * T, T)
    for name in ("t", "c", "mix"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name, tol in (("km", 1), ("kv", 2)):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=tol * np.finfo(np.float32).eps,
                                   atol=0)


# --------------------------------------------------------------------------
# The port against JAX at T = 72, through the streamed basis.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def t72():
    """JAX's basis at T = 72 (no export: it crosses as numpy), 32 random
    scenes, a moderate numpy-seeded alpha (no warm-start cancellation in
    the products) with JAX's evaluation of it, a quarter of the lanes
    frozen and mixed learning rates, all as numpy."""
    jcfg = mp.PlannerConfig(n_timesteps=T72, recip_newton=True, **SHORT)
    tcfg = mt.PlannerConfig(n_timesteps=T72, **SHORT)
    jb = mp.make_basis(jcfg)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(5), B)
    fs = jfleet.to_fleet(scns)
    a0 = np.asarray(jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, jb, fs), 1, 0))
    lsg = np.full((1, B), jcfg.lambda_sg_constraint, np.float32)
    ljl = np.full((1, B), jcfg.lambda_jl_constraint, np.float32)
    basis = [np.asarray(x) for x in (jb.kv, jb.kv.T, jb.mix)]
    lanes = [np.asarray(x) for x in (fs.start, fs.goal, fs.obstacles[:, 0, :],
                                     fs.obstacles[:, 1, :], fs.obstacle_weight)]
    rng = np.random.default_rng(3)
    alpha = np.random.default_rng(4).normal(0, 0.15, (3, T72, B)).astype(
        np.float32)
    ev = ps.cost_grad_eval(jcfg, *basis, alpha, lsg, ljl, *lanes, block_b=B,
                           stream_rb=24, interpret=True)
    return dict(
        jcfg=jcfg, tcfg=tcfg, basis=basis, a0=a0, lsg=lsg, ljl=ljl,
        tbasis=mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                                    for k in jb._fields}, device="cpu"),
        lanes=lanes, alpha=alpha, ev=[np.asarray(x) for x in ev],
        frozen=(rng.random((1, B)) < 0.25).astype(np.float32),
        bls_lr=rng.choice(np.array([0.2, 0.1, 0.05, 0.3], np.float32), (1, B)),
        gd_lr=rng.choice(np.array(jcfg.gd_lr[:2], np.float32), (1, B)))


def test_cost_grad_eval_at_t72_matches_jax_streamed(t72):
    """K5's plain version against pallas_step.cost_grad_eval with the basis
    streamed in 24-row blocks, element by element.  Measured: loss 2.0e-6
    relative, grad 4.6e-5 absolute on values up to 37, traj 2.4e-7, vel
    9.5e-7."""
    d = t72
    want = d["ev"]
    got = sk.cost_grad_eval(d["tcfg"], *map(_t, d["basis"]), _t(d["alpha"]),
                            _t(d["lsg"]), _t(d["ljl"]), *map(_t, d["lanes"]))
    loss, grad, traj, vel = (x.numpy() for x in got)
    np.testing.assert_allclose(loss, want[0], rtol=2e-5)
    np.testing.assert_allclose(grad, want[1], rtol=0, atol=5e-4)
    np.testing.assert_allclose(traj, want[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(vel, want[3], rtol=0, atol=1e-5)


# One step at T = 72 against JAX's streamed kernels, on the live lanes:
# alpha relative to the lane's scale, the rest absolute except the loss
# (relative).  Measured at the largest over the three programs: alpha
# 1.1e-7, traj 2.4e-7, vel 1.9e-6, loss 2.6e-6, grad 3.8e-5.
STEP72_BOUNDS = dict(alpha=1e-6, traj=1e-6, vel=1e-5, loss=2e-5, grad=5e-4)


@pytest.mark.parametrize("program,stream_rb", [
    ("bls", 16), ("bls_exact", 24), ("gd", 16)])
def test_one_step_at_t72_matches_jax_streamed(t72, program, stream_rb):
    """One K3 step (linearized and exact ladder) or K4 step, plain version
    against pallas_step.bls_inner_step / gd_inner_step with the streamed
    basis, from JAX's evaluation of the moderate alpha, a quarter of the
    lanes frozen: frozen lanes pass through bit for bit on both sides, lr
    and the stop flags are equal on every lane, and every other field is
    within STEP72_BOUNDS on the live lanes."""
    d = t72
    exact = program == "bls_exact"
    jcfg = d["jcfg"].replace(ladder_eval="exact") if exact else d["jcfg"]
    tcfg = d["tcfg"].replace(ladder_eval="exact") if exact else d["tcfg"]
    gd = program == "gd"
    lr = d["gd_lr"] if gd else d["bls_lr"]
    loss, grad, traj, vel = d["ev"]
    ins = (d["alpha"], grad, traj, vel, loss, lr, d["frozen"])
    fn = ps.gd_inner_step if gd else ps.bls_inner_step
    want = fn(jcfg, *d["basis"], *ins, d["lsg"], d["ljl"], *d["lanes"],
              block_b=B, stream_rb=stream_rb, interpret=True)
    want = [np.asarray(x) for x in want]
    tfn = sk.gd_inner_step if gd else sk.bls_inner_step
    got = tfn(tcfg, *map(_t, d["basis"]), *map(_t, ins), _t(d["lsg"]),
              _t(d["ljl"]), *map(_t, d["lanes"]))
    got = [x.numpy() for x in got]
    fz = d["frozen"][0] > 0.5
    for g, w, x in zip(got, want, ins):
        np.testing.assert_array_equal(g[..., fz], x[..., fz])
        np.testing.assert_array_equal(w[..., fz], x[..., fz])
    np.testing.assert_array_equal(got[5], want[5])                  # lr
    np.testing.assert_array_equal(got[6], want[6])                  # stop
    live = ~fz
    scale = np.abs(want[0]).max(axis=(0, 1))
    err = dict(
        alpha=(np.abs(got[0] - want[0]).max(axis=(0, 1)) / scale)[live].max(),
        traj=np.abs(got[2] - want[2])[..., live].max(),
        vel=np.abs(got[3] - want[3])[..., live].max(),
        loss=np.abs(got[4][0][live] / want[4][0][live] - 1).max(),
        grad=np.abs(got[1] - want[1])[..., live].max(),
    )
    print(f"{program}: {err}")
    for k, bound in STEP72_BOUNDS.items():
        assert err[k] <= bound, (k, err[k])


# fused_solve's plain version against JAX's streamed kernel at T = 72 on
# the 32 scenes at 1 round x 4 steps: the port-against-JAX bounds of the
# resident comparisons (BLS tfs.LANE_AGREEMENT_MIN, GD 0.80, as
# test_torch_fused_gd.py).  Measured: BLS 1.0, GD 1.0, exact ladder 0.969.
FUSED72_MIN = {"bls": tfs.LANE_AGREEMENT_MIN, "gd": 0.80,
               "bls_exact": tfs.LANE_AGREEMENT_MIN}


@pytest.mark.parametrize("program,stream_rb", [
    ("bls", 24), ("gd", 16), ("bls_exact", 16)])
def test_fused_solve_at_t72_matches_jax_streamed(t72, program, stream_rb):
    d = t72
    solver = "gd" if program == "gd" else "bls"
    ladder = "exact" if program == "bls_exact" else "linearized"
    kargs = (*d["basis"], d["a0"], d["lsg"], d["ljl"], *d["lanes"])
    r = ps.fused_solve(d["jcfg"].replace(ladder_eval=ladder), *kargs,
                       solver=solver, block_b=B, stream_rb=stream_rb,
                       interpret=True)
    want = tfs.FusedSolve(*map(_t, (r.alpha, r.final_loss, r.fulfilled,
                                    r.outer_iters, r.inner_iters)))
    tcfg = d["tcfg"].replace(ladder_eval=ladder)
    assert tfs.launch_plan(tcfg, 11)["plan"] == "streamed"
    got = tfs.fused_solve(tcfg, *map(_t, kargs), solver=solver)
    agree, rel = tfs.lane_agreement(want, got)
    print(f"{program}: lane agreement {agree:.4f}, alpha {rel:.3g}")
    assert agree >= FUSED72_MIN[program]
    assert rel <= tfs.ALPHA_REL_MAX


# --------------------------------------------------------------------------
# The launch plans.
# --------------------------------------------------------------------------


def test_streamed_plan_pieces_and_warps():
    """Streamed at T = 65, 72, 100, 200 and 1,000: per CTA mix, the control
    block and the room (the tile's gx/gy planes, 2T floats each, and the
    K7 ring, which takes the shared memory the lanes leave, at most 64 KB);
    per lane the resident body's pieces and the traj/vel planes (padded so
    the six planes end on 16 bytes); the pieces sum to the total, which
    fits; STREAM_WARPS warps per CTA; the lanes per CTA, one warp each, do
    not grow with T: the most (at most 15) that leave the ring 48 KB and
    run each basis product in one pass of K7's threads (15 up to T = 100, 8
    at T = 200), else the most that fit (2 at T = 1,000)."""
    lanes = []
    for T in (65, 72, 100, 200, 1000):
        plan = tfs.launch_plan(mt.PlannerConfig(n_timesteps=T), 11)
        w = plan["lanes"]
        rows = (T + 3) // 4 * 4
        assert plan["plan"] == "streamed"
        assert plan["warps"] == tfs.STREAM_WARPS == 16
        per_lane = {
            "planes": w * 4 * 12 * T, "buffer": w * 4 * 8 * rows,
            "obstacles": w * 4 * 44, "endpoints": w * 80,
            "state": w * 4 * ((18 * T + 3) // 4 * 4 - 12 * T),
        }
        left = SMEM_LIMIT - 128 - sum(per_lane.values())
        room = max(min(left, 65536) // 16 * 16, -(-2 * T * w // 4) * 16)
        assert plan["bytes"] == {"mix": 48, "control": 80, "room": room,
                                 **per_lane}
        assert plan["total"] == sum(plan["bytes"].values()) <= SMEM_LIMIT
        assert plan["ring"]["ring_bytes"] == room
        if T <= 200:
            assert room >= 48 * 1024
            assert plan["ring"]["kv"]["passes"] == 1
        lanes.append(w)
    assert lanes == sorted(lanes, reverse=True)
    assert lanes[2] == 15 and lanes[3] == 8 and lanes[4] == 2
    # One more lane at T = 200 would leave the ring less than 48 KB and
    # take the forward product in two passes.
    one = 18 * 200 + 8 * 200 + 44 + 20
    assert 4 * tfs.room_floats(200, 9, one) < 48 * 1024
    assert tfs.k7_row_block(400, 9) < 400
    # pallas_block_b caps the lanes of a streamed CTA.
    assert tfs.launch_plan(mt.PlannerConfig(n_timesteps=200,
                                            pallas_block_b=4), 11)["lanes"] == 4


@pytest.mark.parametrize("T", [50, 64])
def test_resident_plan_below_65(T):
    """Up to T = 64 the default plan is the resident one, the numbers of
    test_torch_launch_plan.py; the streamed plan may be asked for there
    (chip_smoke.py holds the two bodies equal bit for bit at T = 50)."""
    cfg = mt.PlannerConfig(n_timesteps=T)
    plan = tfs.launch_plan(cfg, 11)
    assert plan["plan"] == "resident" and plan["warps"] == 16
    assert plan["bytes"]["basis"] == 16 * T * T
    assert tfs.launch_plan(cfg, 11, "streamed")["plan"] == "streamed"
    with pytest.raises(ValueError, match="plan"):
        tfs.launch_plan(cfg, 11, "tiled")


def test_plans_refuse_what_they_cannot_hold():
    """Past the float32 plans' ceiling (the reach plan's at 11 obstacles: T
    = 2,157 for the linearized ladder, 2,637 for GD) one lane's state does
    not fit: NotImplementedError naming the largest piece; the resident
    plan, asked for past T = 64, names the streamed plan; the streamed one
    below T = 32 raises ValueError.  At the ceiling one lane fills the CTA,
    whose other warps help with its products."""
    for prog, solver, last, piece in (("bls", "bls", 2156, "planes"),
                                      ("gd", "gd", 2636, "buffer")):
        top = tfs.launch_plan(mt.PlannerConfig(n_timesteps=last), 11,
                              prog=prog)
        assert (top["plan"], top["lanes"], top["warps"]) == (
            "reach", 1, tfs.STREAM_WARPS)
        past = mt.PlannerConfig(n_timesteps=last + 1)
        with pytest.raises(NotImplementedError,
                           match=f"largest piece is {piece}"):
            tfs.launch_plan(past, 11, prog=prog)
        assert tfs.kernel_plan(past, 11, solver) is None
    with pytest.raises(NotImplementedError, match="streamed plan"):
        tfs.launch_plan(mt.PlannerConfig(n_timesteps=72), 11, "resident")
    with pytest.raises(ValueError, match="T >= 32"):
        tfs.launch_plan(mt.PlannerConfig(n_timesteps=25), 11, "streamed")


@pytest.mark.parametrize("kernel,prog", [
    ("bls_step_plan", "bls"), ("bls_step_plan", "bls_exact"),
    ("cost_grad_eval_plan", "bls")])
@pytest.mark.parametrize("T,threads,lanes,plan", [
    (50, 0, 16, "resident"), (50, 64, 2, "resident"),
    (50, 256, 8, "resident"), (100, 0, 15, "streamed"),
    (100, 128, 4, "streamed"), (200, 0, 8, "streamed"),
    (200, 64, 2, "streamed"), (200, 512, 8, "streamed")])
def test_step_kernels_plan(kernel, prog, T, threads, lanes, plan):
    """K3's and K5's lanes per CTA are ``pallas_block_b / 32`` (one warp
    per lane; the default 16) in K1's launch plan for their program (K3:
    the ladder tier's, K5: BLS's): the resident body at T = 50, the
    streamed one from T = 100, which takes as many of them as leave its K7
    ring 48 KB (15 at T = 100, 8 at T = 200).  The plan is K1's own, by
    piece, and fits a CTA; K5's is the same on both per-step paths."""
    cfg = mt.PlannerConfig(n_timesteps=T, pallas_block_b=threads,
                           ladder_eval="exact" if prog == "bls_exact"
                           else "linearized")
    got = getattr(sk, kernel)(cfg, 11)
    assert (got["lanes"], got["plan"]) == (lanes, plan)
    assert got == tfs.launch_plan(cfg.replace(pallas_block_b=threads // 32),
                                  11, prog=prog)
    assert got["total"] == sum(got["bytes"].values()) <= SMEM_LIMIT


def test_streamed_basis_layout():
    """The streamed body's basis (K7): each matrix transposed and cut into
    blocks of the ring's row-block rows, block after block, each block's
    rows contiguous per timestep and zero-padded to a whole block, so one
    ring stage is one contiguous copy."""
    kv = torch.arange(2 * 72 * 72, dtype=torch.float32).reshape(144, 72)
    ring = {"kv": {"row_block": 64}, "kvt": {"row_block": 64}}
    kvT, kvtT = tfs.streamed_basis(kv, kv.T.contiguous(), ring)
    assert kvT.shape == (3, 72, 64) and kvtT.shape == (2, 144, 64)
    flat = kvT.transpose(1, 2).reshape(192, 72)
    assert torch.equal(flat[:144], kv) and not flat[144:].any()
    flat = kvtT.transpose(1, 2).reshape(128, 144)
    assert torch.equal(flat[:72], kv.T) and not flat[72:].any()
    assert torch.equal(kvT[1, 5], kv[64:128, 5])


def test_streamed_basis_is_built_once_per_basis():
    """The streamed layout (and fused_args' transposed basis) is built once
    per basis, not at every launch, and again when the basis changes."""
    cfg = mt.PlannerConfig(n_timesteps=100)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), 2,
                               device="cpu")
    a1, a2 = (tfleet.fused_args(cfg, basis, scns) for _ in range(2))
    assert a1[2] is a2[2] and torch.equal(a1[2], basis.kv.T)
    ring = tfs.launch_plan(cfg, 11)["ring"]
    assert ring["kv"]["row_block"] == 200
    first = tfs.streamed_basis(a1[1], a1[2], ring)
    again = tfs.streamed_basis(a2[1], a2[2], ring)
    assert all(x is y for x, y in zip(first, again))
    kv = basis.kv.clone()
    before = tfs.streamed_basis(kv, a1[2], ring)
    kv.mul_(2.0)
    after = tfs.streamed_basis(kv, a1[2], ring)
    assert torch.equal(after[0][0, :, :200], kv.T)
    assert not torch.equal(before[0], after[0])


def test_streamed_bound_is_the_functions():
    """The streamed programs' bound is the function's (operations, the
    inputs read once); the design's per-lane basis reads from L2 are a
    diagnostic beside it: 8 T^2 bytes per basis product."""
    from irm_motion_planning_tpu_torch.ops import roofline

    T, B = 200, 1024
    tally = {"rounds": 3.0 * B, "steps": 40.0 * B, "rungs": 70.0 * B,
             "pullbacks": 38.0 * B, "accepted": 30.0 * B}
    for solver, ladder in (("bls", "linearized"), ("bls", "exact"),
                           ("gd", "linearized")):
        plain = roofline.fused_rounds(B, T, 3, 11, tally, True, solver,
                                      ladder)
        streamed = roofline.fused_rounds(B, T, 3, 11, tally, True, solver,
                                         ladder, streamed=True)
        assert (streamed.ms, streamed.by) == (plain.ms, plain.by)
        assert streamed.by == "operations" and plain.l2_bytes == 0.0
        products = roofline.fused_products(B, tally, True, solver, ladder)
        assert streamed.l2_bytes == products * 8 * T * T
        assert streamed.design_l2_ms > streamed.ms


def test_first_argmax_takes_the_earlier_timestep_of_a_tie():
    """The blend's lam_max goes to the first of equal largest costs, and
    blend_costs is the cost pass's per-timestep obstacle cost."""
    cost = torch.tensor([[1.0, 3.0], [2.0, 3.0], [2.0, 1.0]])
    assert tfs.first_argmax(cost).tolist() == [1, 0]
    cfg = mt.PlannerConfig(n_timesteps=100)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(1), 4,
                               device="cpu")
    args = tfleet.fused_args(cfg, basis, scns)
    traj, _ = tfs.forward_planes(args[1], args[3], args[4])
    c = tfs.consts(cfg)
    ee_x, ee_y, _, _ = tfs.fk_ee(c, traj)
    want = tfs.obstacle_cost_v(ee_x, ee_y, tfs.obs_ctx(*args[9:12]))
    assert torch.equal(tfs.blend_costs(cfg, traj, *args[9:12]), want)


# --------------------------------------------------------------------------
# The fleet solver's fallback.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[("bls", 2157), ("gd", 2637)])
def past_ceiling(request):
    """The first T no plan of the solver holds (the reach plan's ceiling
    plus one: BLS 2,157, GD 2,637), JAX's basis through basis_from_numpy,
    the reference scene on 2 lanes, 1 round x 2 steps."""
    solver, T = request.param
    jb = mp.make_basis(mp.PlannerConfig(n_timesteps=T))
    cfg = mt.PlannerConfig(n_timesteps=T, max_inner_iteration=2,
                           max_outer_iteration=1, fixed_iters=True,
                           max_obstacles=11)
    basis = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                                 for k in jb._fields}, device="cpu")
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device="cpu"), 2)
    want = tfleet.fleet_solve(cfg, basis, scns, solver=solver, backend="xla")
    return cfg, basis, scns, want, solver


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_kernel_backends_fall_back_past_the_ceiling(past_ceiling, backend):
    """Past the plans' ceiling fleet_solve warns with JAX's wording and runs
    the xla engine: the result equals backend="xla" bit for bit.  With lane
    compaction (fused only) the warning says it is dropped."""
    cfg, basis, scns, want, solver = past_ceiling
    cfgs = [cfg] + ([cfg.replace(lane_compaction=True)]
                    if backend == "fused" else [])
    for c in cfgs:
        match = "DROPPED" if c.lane_compaction else "falling back to backend='xla'"
        with pytest.warns(UserWarning, match=match):
            got = tfleet.fleet_solve(c, basis, scns, solver=solver,
                                     backend=backend)
        np.testing.assert_array_equal(got.alpha.numpy(), want.alpha.numpy())
        for x, y in zip(got.stats, want.stats):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_no_fallback_within_the_plans(t72):
    """At T = 72 the streamed plan holds: no warning, and on the CPU the
    fused backend runs the plain K1 (launching nothing)."""
    cfg = t72["tcfg"].replace(max_inner_iteration=1)
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device="cpu"), 2)
    before = tfs.fused_solve.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = tfleet.fleet_solve(cfg, t72["tbasis"], scns, backend="fused")
    assert tfs.fused_solve.launches == before
    assert torch.isfinite(res.alpha).all()


# --------------------------------------------------------------------------
# The xla engine at T = 100 and the problem-size sweep.
# --------------------------------------------------------------------------


def test_xla_engine_at_t100_matches_jax():
    """The port's xla engine on the T = 100 export against JAX's xla engine
    on its own basis: 64 random scenes at 2 rounds x 6 steps, lane
    agreement >= 0.50 (ROADMAP queue 3, fact 4: the float32 paths part on
    some lanes).  Measured 0.6875, 0.625 and 0.656 at PRNGKey(1), (2), (3);
    alpha within 4.2e-6 of the lane's scale on the agreeing lanes."""
    kw = dict(n_timesteps=100, max_inner_iteration=6, max_outer_iteration=2,
              fixed_iters=True, max_obstacles=11)
    jcfg, tcfg = mp.PlannerConfig(**kw), mt.PlannerConfig(**kw)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(1), 64)
    want = jfleet.fleet_solve(jcfg, mp.make_basis(jcfg), scns, backend="xla")
    got = tfleet.fleet_solve(tcfg, mt.make_basis(tcfg, device="cpu"),
                             mt.Scenario(*map(_t, scns)), backend="xla")
    agree, rel = tfs.lane_agreement(_as_fused(want), _as_fused(got))
    print(f"lane agreement {agree:.4f}, alpha {rel:.3g}")
    assert agree >= 0.50
    assert rel <= tfs.ALPHA_REL_MAX


def test_problemsize_rehearsal():
    """python -m irm_motion_planning_tpu_torch.benchmarks.problemsize on the
    CPU: one JSON line per size on stderr (with the launches, none on the
    CPU, and the launch plan) and the summary on stdout."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = problemsize.main(["--device", "cpu", "--sizes", "25,50",
                               "--batch", "4", "--repeats", "1", "--inner",
                               "2", "--backend", "fused"])
    assert rc == 0
    rows = [json.loads(x) for x in err.getvalue().splitlines()
            if x.startswith("{")]
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert [r["n_timesteps"] for r in rows] == [25, 50]
    assert summary["metric"] == "problem_size_scaling"
    assert summary["platform"] == "cpu" and summary["backend"] == "fused"
    assert summary["points"] == rows
    for r in rows:
        assert r["launches"] == {"fused_solve": 0, "fused_round": 0}
        assert r["plan"]["plan"] == "resident"
        assert r["solves_per_sec"] > 0
    assert problemsize.size_config(200, 15) == mt.PlannerConfig(
        n_timesteps=200, bls_mode="ladder", fixed_iters=True,
        max_inner_iteration=15, pallas_block_b=0)
