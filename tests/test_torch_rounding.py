"""How the port rounds the accepted alpha, against the JAX package.

XLA on the CPU forms ``a_fac * alpha - lr * g`` as one FMA,
``fma(a_fac, alpha, -(lr * g))``: the accepted alpha of its ``xla`` engine
(BLS in both ladder tiers, GD), the exact ladder's rung candidates and GD's
trial.  At T = 200 the warm start's coefficients are O(1e4), so the
product's rounding is of the size of a step, and a port that rounds twice
(product, then sum) parts from JAX on about a quarter of the coefficients
after one step.  The port rounds once (fused_solve.fma) in its ``xla``
engine, in the exact ladder's programs and in GD's (plain versions and
kernels alike); the linearized ladder's carry program (K1/K2, K3) keeps
two roundings, because one moves bench.py's reference scene past its strict
endpoint gate (PERF.md section 7).

Each test takes one step at T = 200 from identical numpy state on both
sides and counts the coefficients of alpha equal bit for bit on the lanes
that moved and took the same step: at least ONE_ROUNDING_MIN of them.
Measured 1.0 on every engine below with one rounding; 0.750-0.757 with two
(the rounding the port had before), which fails the bound.

The carry program's other expressions (the direction ``lambda_reg x + g``,
a rung's candidate and the accepted iterate ``x - lr d``) are held to JAX's
fused kernel plane by plane in test_carry_program_contractions: XLA
contracts the accepted alpha and the accepted iterate into FMAs; the port
keeps both rounded twice (PERF.md section 7 has the endpoint readings that
decide it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.ops import pallas_step as ps
from irm_motion_planning_tpu.ops.costs import Penalty as JPenalty
from irm_motion_planning_tpu.solvers import fleet as jfleet

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch import bench
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.ops.costs import Penalty
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

T = 200
B = 16
ONE_STEP = dict(n_timesteps=T, max_inner_iteration=1, max_outer_iteration=1,
                fixed_iters=False, max_obstacles=11)
ONE_ROUNDING_MIN = 0.99


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    """JAX's basis at T = 200 (the port's committed export equals it bit for
    bit), 16 random scenes and JAX's warm start, as numpy."""
    jcfg = mp.PlannerConfig(recip_newton=True, **ONE_STEP)
    jb = mp.make_basis(jcfg)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(11), B)
    fs = jfleet.to_fleet(scns)
    a0 = np.asarray(jfleet.fleet_init_alpha(jcfg, jb, fs))      # (T, J, B)
    return jcfg, jb, scns, fs, a0


def _bitwise_share(got, want, start, same):
    """The share of alpha's coefficients equal bit for bit on the lanes in
    ``same`` whose alpha moved (lane axis last), and how many lanes that
    is."""
    moved = same & (want != start).reshape(-1, want.shape[-1]).any(0)
    eq = (got == want)[..., moved]
    return float(eq.mean()) if eq.size else 0.0, int(moved.sum())


def _jax_evaluations(monkeypatch, jcfg, jb, jfs):
    """Route the port's xla engine's evaluations (fleet_cost_grad_eval,
    fleet_cost_and_grad, fleet_evaluate, fleet_cost_from_traj) through
    JAX's, jitted: at the warm start the two engines' basis products round
    apart (the O(1e4) coefficients cancel to O(1e-1) trajectories), which
    would hide the update's rounding behind different gradients."""
    def j(x):
        return jnp.asarray(x.numpy())

    def pen(p):
        return JPenalty(j(p.lambda_sg), j(p.lambda_jl))

    cge = jax.jit(lambda p, a: jfleet.fleet_cost_grad_eval(jcfg, jb, jfs, p, a))
    ev = jax.jit(lambda a: jfleet.fleet_evaluate(jcfg, jb, a))
    cft = jax.jit(lambda p, t, v: jfleet.fleet_cost_from_traj(jcfg, jfs, p, t,
                                                              v))
    monkeypatch.setattr(tfleet, "fleet_cost_grad_eval",
                        lambda c, b, s, p, a: tuple(map(_t, cge(pen(p), j(a)))))
    monkeypatch.setattr(tfleet, "fleet_cost_and_grad",
                        lambda c, b, s, p, a: tuple(map(_t, cge(pen(p),
                                                                j(a))[:2])))
    monkeypatch.setattr(tfleet, "fleet_evaluate",
                        lambda c, b, a: tuple(map(_t, ev(j(a)))))
    monkeypatch.setattr(tfleet, "fleet_cost_from_traj",
                        lambda c, s, p, t, v: _t(cft(pen(p), j(t), j(v))))


@pytest.mark.parametrize("solver,ladder", [
    ("bls", "linearized"), ("bls", "exact"), ("gd", "linearized")])
def test_xla_engine_rounds_the_accepted_alpha_as_xla(monkeypatch, scenes,
                                                     solver, ladder):
    """One inner step of the port's ``xla`` engine (make_bls_inner /
    make_gd_inner, its evaluations JAX's) against JAX's engine
    (_make_bls_inner / _make_gd_inner) from the warm start under the initial
    penalties: the new alpha equal bit for bit on at least ONE_ROUNDING_MIN
    of the coefficients of the lanes that moved by the same step (alpha
    within 1e-5 of the lane's scale: the same Armijo rung)."""
    jcfg, jb, scns, fs, a0 = scenes
    jcfg = jcfg.replace(ladder_eval=ladder)
    tcfg = mt.PlannerConfig(ladder_eval=ladder, **ONE_STEP)
    _jax_evaluations(monkeypatch, jcfg, jb, fs)
    outer = np.zeros(B, np.int32)
    jmake = (jfleet._make_gd_inner if solver == "gd"
             else jfleet._make_bls_inner)
    tmake = tfleet.make_gd_inner if solver == "gd" else tfleet.make_bls_inner
    lsg = np.full(B, jcfg.lambda_sg_constraint, np.float32)
    ljl = np.full(B, jcfg.lambda_jl_constraint, np.float32)
    want, wit, _ = jmake(jcfg, jb, fs)(jnp.asarray(outer))(
        jnp.asarray(a0), JPenalty(jnp.asarray(lsg), jnp.asarray(ljl)))
    want = np.asarray(want)
    tfsc = tfleet.to_fleet(mt.Scenario(*(_t(x) for x in scns)))
    got, git, _ = tmake(tcfg, mt.make_basis(tcfg, device="cpu"), tfsc)(_t(outer))(
        _t(a0), Penalty(_t(lsg), _t(ljl)))
    got = got.numpy()
    rel = np.abs(got - want).max(axis=(0, 1)) / np.abs(want).max(axis=(0, 1))
    same = (np.asarray(wit) == git.numpy()) & (rel <= 1e-5)
    share, lanes = _bitwise_share(got, want, a0, same)
    print(f"xla {solver} {ladder}: {share:.4f} of alpha bitwise JAX's on "
          f"{lanes} moved lanes ({int(same.sum())} of {B} took the same step)")
    assert lanes >= B // 2
    assert share >= ONE_ROUNDING_MIN


@pytest.fixture(scope="module")
def step_state(scenes):
    """JAX's evaluation of the warm start (kernel layout, as numpy) under
    the initial penalties, the learning rates and no lane frozen."""
    jcfg, jb, scns, fs, a0 = scenes
    alpha = np.ascontiguousarray(np.moveaxis(a0, 1, 0))          # (J, T, B)
    lsg = np.full((1, B), jcfg.lambda_sg_constraint, np.float32)
    ljl = np.full((1, B), jcfg.lambda_jl_constraint, np.float32)
    basis = [np.asarray(x) for x in (jb.kv, jb.kv.T, jb.mix)]
    lanes = [np.asarray(x) for x in (fs.start, fs.goal, fs.obstacles[:, 0, :],
                                     fs.obstacles[:, 1, :], fs.obstacle_weight)]
    ev = ps.cost_grad_eval(jcfg, *basis, alpha, lsg, ljl, *lanes, block_b=B,
                           stream_rb=40, interpret=True)
    loss, grad, traj, vel = (np.asarray(x) for x in ev)
    return dict(basis=basis, state=(alpha, grad, traj, vel, loss), lsg=lsg,
                ljl=ljl, lanes=lanes)


@pytest.mark.parametrize("program", ["bls_exact", "gd"])
def test_step_kernels_round_the_accepted_alpha_as_xla(scenes, step_state,
                                                      program):
    """One step of the per-step kernels' plain versions (K3 in the exact
    ladder, whose rung candidates and new alpha are one expression, and K4,
    whose trial is the new alpha) against pallas_step.bls_inner_step /
    gd_inner_step interpreted with the streamed basis, from JAX's
    evaluation of the warm start: the new alpha equal bit for bit on at
    least ONE_ROUNDING_MIN of the coefficients of the lanes that moved with
    the same learning rate and stop flag.  K1/K2 and the kernels run the
    same arithmetic (chip_smoke.py holds them bit for bit to these plain
    versions' paths)."""
    jcfg = scenes[0]
    d = step_state
    gd = program == "gd"
    jcfg = jcfg if gd else jcfg.replace(ladder_eval="exact")
    tcfg = mt.PlannerConfig(ladder_eval="linearized" if gd else "exact",
                            **ONE_STEP)
    lr = np.full((1, B), jcfg.gd_lr[0] if gd else 0.2, np.float32)
    frozen = np.zeros((1, B), np.float32)
    ins = (*d["state"], lr, frozen)
    fn = ps.gd_inner_step if gd else ps.bls_inner_step
    want = [np.asarray(x) for x in fn(
        jcfg, *d["basis"], *ins, d["lsg"], d["ljl"], *d["lanes"], block_b=B,
        stream_rb=40, interpret=True)]
    tfn = sk.gd_inner_step if gd else sk.bls_inner_step
    got = [x.numpy() for x in tfn(tcfg, *map(_t, d["basis"]), *map(_t, ins),
                                  _t(d["lsg"]), _t(d["ljl"]),
                                  *map(_t, d["lanes"]))]
    same = ((got[5] == want[5]) & (got[6] == want[6]))[0]
    share, lanes = _bitwise_share(got[0], want[0], ins[0], same)
    print(f"{program} step: {share:.4f} of alpha bitwise JAX's on {lanes} "
          f"moved lanes ({int(same.sum())} of {B} with the same lr and stop)")
    assert lanes >= 2
    assert share >= ONE_ROUNDING_MIN


def test_fma_rounds_once_and_two_roundings_twice():
    """fused_solve.fma is ``a b + c`` rounded once (numpy's float64 of the
    float32 operands, rounded to float32, agrees with it wherever float64
    holds the exact sum, as it does for these magnitudes);
    fused_solve.two_roundings rounds the product first."""
    rng = np.random.default_rng(0)
    a = (1 - rng.random(4096) * 1e-3).astype(np.float32)
    b = (rng.standard_normal(4096) * 1e4).astype(np.float32)
    c = (rng.standard_normal(4096) * 1e-2).astype(np.float32)
    once = tfs.fma(_t(a), _t(b), _t(c)).numpy()
    twice = tfs.two_roundings(_t(a), _t(b), _t(c)).numpy()
    exact = (a.astype(np.float64) * b + c).astype(np.float32)
    np.testing.assert_array_equal(once, exact)
    np.testing.assert_array_equal(twice, a * b + c)
    assert 0.1 < float((once != twice).mean()) < 0.5


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _mix_once(terms):
    """The mix combine as XLA contracts it: fma(x0, m0, x1 m1), then each
    later term fused into the sum."""
    (x0, m0), (x1, m1) = terms[:2]
    acc = tfs.fma(x0, m0, x1 * m1)
    for x, m in terms[2:]:
        acc = tfs.fma(x, m, acc)
    return acc


# The carry program's expressions that XLA may contract, each a list of the
# fused_solve helpers that form them with their one-rounding replacements
# (a b + c d as fma(a, b, c d), acc + a b as fma(a, b, acc); the same table
# as tools/compare_converged.py's, which runs whole solves with them).
CONTRACTIONS = {
    "dir": [("carry_direction",
             lambda lam, x, g: tfs.fma(_f32(lam), x, g))],
    "cand": [("rung_point", lambda x, lr, d: tfs.fma(-lr, d, x))],
    "nt": [("accepted_point", lambda x, lr, d: tfs.fma(-lr, d, x))],
    "alpha": [("two_roundings", tfs.fma)],
    "mix": [("mix_combine", _mix_once)],
    "field": [("field_q", lambda ox, oy: 0.5 + 0.5 * tfs.fma(ox, ox, oy * oy)),
              ("field_h", lambda ex, ey: 0.5 * tfs.fma(ex, ex, ey * ey)),
              ("field_dist", lambda h, q, ox, ex, oy, ey:
               (h + q) - tfs.fma(ox, ex, oy * ey)),
              ("field_sum", _mix_once),
              ("field_acc", _mix_once),
              ("field_grad", lambda co, e, csum: tfs.fma(-e, csum, co))],
    "sums": [("sum_pair", lambda a, b, c, d:
              tfs.fma(_f32(a), _f32(b), _f32(c) * _f32(d))),
             ("sum_add", lambda acc, a, b: tfs.fma(_f32(a), _f32(b), acc))],
}


def _contract(m, keys):
    """Round the expressions ``keys`` of CONTRACTIONS once (``m``: a
    monkeypatch context)."""
    for k in keys:
        for name, fn in CONTRACTIONS[k]:
            m.setattr(tfs, name, fn)


@pytest.fixture(scope="module")
def carry_step(scenes, step_state):
    """One linearized BLS step of JAX's fused kernel
    (pallas_step.bls_inner_step interpreted, recip_newton=True, the
    streamed basis) from JAX's evaluation of the warm start, learning rate
    0.2; and JAX's forward evaluation of the port's normalized gradient (the
    direction's basis product, fed to the port so that only the
    elementwise expressions can part)."""
    jcfg = scenes[0]
    d = step_state
    lr = np.full((1, B), 0.2, np.float32)
    frozen = np.zeros((1, B), np.float32)
    want = [np.asarray(x) for x in ps.bls_inner_step(
        jcfg, *d["basis"], *d["state"], lr, frozen, d["lsg"], d["ljl"],
        *d["lanes"], block_b=B, stream_rb=40, interpret=True)]
    g = _t(d["state"][1])
    g2 = tfs.chain_sum(tfs.chain_sum((g * g).transpose(0, 1)))
    ng = (g * (1.0 / torch.sqrt(g2))).numpy()
    gfe = [_t(x) for x in ps.forward_eval(jcfg, d["basis"][0], d["basis"][2],
                                          ng, block_b=B, stream_rb=40,
                                          interpret=True)]
    return want, gfe, lr


def _carry_shares(monkeypatch, step_state, carry_step, keys):
    """The port's plain carry step (fused_solve.bls_step, linearized, the
    FK carry off) with the expressions ``keys`` rounded once: the share of
    lanes with JAX's learning rate, and on those lanes the bitwise share of
    alpha, traj and vel after the step."""
    want, gfe, lr = carry_step
    d = step_state
    with monkeypatch.context() as m:
        _contract(m, keys)
        m.setattr(tfs, "forward_planes", lambda kv, mix, planes: gfe)
        cfg = mt.PlannerConfig(**ONE_STEP)
        alpha, grad, traj, vel, loss = map(_t, d["state"])
        kv, kvt, mix = map(_t, d["basis"])
        start, goal, ox, oy, ow = map(_t, d["lanes"])
        out = tfs.bls_step(cfg, tfs.consts(cfg), kv, kvt, mix, start, goal,
                           tfs.obs_ctx(ox, oy, ow), _t(d["lsg"][0]),
                           _t(d["ljl"][0]), alpha, grad, traj, vel, loss[0],
                           _t(lr[0]), torch.zeros(B, dtype=torch.bool))
    got = [x.numpy() for x in out]
    same = got[5] == want[5][0]
    return float(same.mean()), {
        name: float((got[i] == want[i])[..., same].mean())
        for name, i in (("alpha", 0), ("traj", 2), ("vel", 3))}


def test_carry_program_contractions(monkeypatch, step_state, carry_step):
    """Which expressions of the linearized carry program XLA contracts into
    FMAs: one step at T = 200 of the port's plain carry program (as
    shipped, and with each candidate rounded once) against JAX's fused
    kernel from the same state, every lane taking JAX's learning rate.
    Measured (16 random scenes): as shipped alpha 0.750, traj 0.895, vel
    0.680 of the coefficients bit for bit JAX's; the accepted alpha rounded
    once makes alpha 1.0; the accepted iterate ``x - lr d`` rounded once
    lifts traj to 0.911 and vel to 0.746 (the rest are the direction's
    planes, whose norm the two sides sum in different orders); the
    direction ``lambda_reg x + g`` (lambda_reg = 1e-4) and the rungs'
    candidates change none of them, nor do the evaluation's sums (the mix
    combine, the obstacle field, the cost sums: the step's direction
    product is JAX's here, and its rungs pick JAX's learning rate either
    way; test_evaluation_contractions measures them).  The port keeps all
    of them rounded twice: with the accepted alpha once the reference scene
    ends past the strict endpoint gate (test_carry_program_rounds_twice)."""
    lanes, shipped = _carry_shares(monkeypatch, step_state, carry_step, ())
    assert lanes == 1.0
    assert 0.6 < shipped["alpha"] < 0.9
    for keys in (("dir",), ("cand",), ("dir", "cand"), ("mix",), ("field",),
                 ("sums",), ("mix", "field", "sums")):
        assert _carry_shares(monkeypatch, step_state, carry_step,
                             keys) == (1.0, shipped), keys
    _, alpha_once = _carry_shares(monkeypatch, step_state, carry_step,
                                  ("alpha",))
    assert alpha_once["alpha"] >= ONE_ROUNDING_MIN
    assert (alpha_once["traj"], alpha_once["vel"]) == (shipped["traj"],
                                                       shipped["vel"])
    _, nt_once = _carry_shares(monkeypatch, step_state, carry_step, ("nt",))
    assert nt_once["alpha"] == shipped["alpha"]
    assert nt_once["traj"] > shipped["traj"] and nt_once["vel"] > shipped["vel"]
    print(f"carry step bitwise JAX's: shipped {shipped}, alpha once "
          f"{alpha_once}, iterate once {nt_once}")


def _jax_recip(s):
    """JAX's interpreted kernel reciprocal under recip_newton: 1 / s of s
    rounded to bfloat16 (pl.reciprocal(approx=True) as interpret mode runs
    it; XLA keeps the quotient in float32), refined by one Newton step whose
    ``2 - s r`` XLA contracts into an FMA."""
    r = 1.0 / s.to(torch.bfloat16).float()
    return r * tfs.fma(-s, r, _f32(2.0))


def _eval_shares(monkeypatch, scenes, keys, weight=1.0, lam=None,
                 recip=None):
    """JAX's fused evaluation (pallas_step.cost_grad_eval interpreted, the
    streamed basis) and the port's plain one (fused_solve.cost_grad_eval)
    with the expressions ``keys`` rounded once, on the T = 200 scenes at an
    alpha whose basis products are exact in any order (one coefficient
    +-2^k per joint and lane, so a product row is a basis entry scaled):
    the bitwise shares of loss (lanes) and traj.  ``weight`` scales the
    obstacle weights, ``lam`` replaces both penalties, ``recip`` the port's
    reciprocal."""
    jcfg, jb, scns, fsc, _ = scenes
    rng = np.random.default_rng(3)
    alpha = np.zeros((3, T, B), np.float32)
    for j in range(3):
        alpha[j, rng.integers(0, T, B), np.arange(B)] = (
            rng.choice([-1.0, 1.0], B) * 2.0 ** rng.integers(-3, 4, B))
    pen = [np.full((1, B), v, np.float32) for v in (
        (jcfg.lambda_sg_constraint, jcfg.lambda_jl_constraint)
        if lam is None else (lam, lam))]
    kv, kvt, mix = (np.asarray(x) for x in (jb.kv, jb.kv.T, jb.mix))
    lanes = [np.asarray(x) for x in (
        fsc.start, fsc.goal, fsc.obstacles[:, 0, :], fsc.obstacles[:, 1, :],
        fsc.obstacle_weight * weight)]
    want = [np.asarray(x) for x in ps.cost_grad_eval(
        jcfg, kv, kvt, mix, alpha, *pen, *lanes, block_b=B, stream_rb=40,
        interpret=True)]
    cfg = mt.PlannerConfig(**ONE_STEP)
    with monkeypatch.context() as m:
        _contract(m, keys)
        if recip is not None:
            m.setattr(tfs, "recip", recip)
        got = tfs.cost_grad_eval(
            cfg, tfs.consts(cfg), *map(_t, (kv, kvt, mix, alpha)),
            _t(lanes[0]), _t(lanes[1]), tfs.obs_ctx(*map(_t, lanes[2:])),
            _t(pen[0][0]), _t(pen[1][0]))
    return (float((got[0].numpy() == want[0][0]).mean()),
            float((got[2].numpy() == want[2]).mean()))


def test_evaluation_contractions(monkeypatch, scenes):
    """Which sums of the fused evaluation XLA contracts into FMAs, one site
    at a time, against JAX's interpreted kernel at T = 200 (16 random
    scenes, an alpha whose basis products are exact: _eval_shares).  The
    mix combine: traj 0.82 of the coefficients bit for bit as shipped, 1.0
    rounded as fma(x2, m2, fma(x0, m0, x1 m1)).  The cost sums (the obstacle
    weights zeroed, so the field is 0; the mix combine contracted): the
    loss of 0.75 of the lanes bit for bit as shipped, 1.0 with the sums
    contracted.  The obstacle field (the penalties zeroed, JAX's reciprocal
    mirrored, _jax_recip): 0.50 shipped, 0.69 with every plane of the field
    contracted, each of which is JAX's bit for bit alone
    (test_field_contractions); the loss still parts on the rest by what is
    no contraction: the FK's sin and cos, and the order of the sum over T.
    The port's reciprocal is 1 / s correctly rounded, which JAX's kernel
    never gives; the port keeps all of these rounded twice (PERF.md section
    7 has the endpoint and T = 200 readings of each set)."""
    _, traj = _eval_shares(monkeypatch, scenes, ())
    _, traj_once = _eval_shares(monkeypatch, scenes, ("mix",))
    assert traj < 0.9 and traj_once == 1.0
    sums = _eval_shares(monkeypatch, scenes, ("mix",), weight=0.0)[0]
    sums_once = _eval_shares(monkeypatch, scenes, ("mix", "sums"),
                             weight=0.0)[0]
    assert sums < 0.95 and sums_once == 1.0
    field = _eval_shares(monkeypatch, scenes, ("mix", "sums"), lam=0.0,
                         recip=_jax_recip)[0]
    field_once = _eval_shares(monkeypatch, scenes, ("mix", "sums", "field"),
                              lam=0.0, recip=_jax_recip)[0]
    assert max(field, field_once) < ONE_ROUNDING_MIN
    print(f"evaluation bitwise JAX's: traj {traj} shipped, {traj_once} with "
          f"the mix combine once; loss without the field {sums} shipped, "
          f"{sums_once} with the cost sums once; loss of the field alone "
          f"{field} shipped, {field_once} with it once")


FIELD_PLANES = ("q", "h", "s", "sum", "cv", "csum", "cox", "coy", "gx", "gy")


def _jax_field_planes(jcfg, ex, ey, ox, oy, ow):
    """The obstacle field of JAX's kernel (pallas_step._Body, interpreted,
    recip_newton) at given end-effector planes ex, ey (T, B) among the
    obstacles ox, oy, ow (O, B): the planes of FIELD_PLANES, each as the
    kernel forms it (the forward field and the gradient's cost_v are the
    same expression; s is obstacle 0's)."""
    from jax.experimental import pallas as pl

    (T, Bn), O = ex.shape, ox.shape[0]
    body = ps._Body(jcfg, T, jcfg.n_joints, O, Bn)

    def kernel(ex_ref, ey_ref, ox_ref, oy_ref, ow_ref, q_ref, h_ref, s_ref,
               sum_ref, cv_ref, csum_ref, cox_ref, coy_ref, gx_ref, gy_ref):
        ee_x, ee_y = ex_ref[:], ey_ref[:]
        obs = body.obs_ctx(ox_ref[:], oy_ref[:], ow_ref[:])
        sum_ref[:] = body.obstacle_cost_v(ee_x, ee_y, obs)
        oxx, oyy, q, ow8 = obs
        q_ref[:] = q
        # The gradient's accumulators, as _Body.cost_grad_from_traj forms
        # them (pallas_step.py:608-623).
        h = 0.5 * (ee_x * ee_x + ee_y * ee_y)
        h_ref[:] = h
        s_ref[:] = (h + q[0:1]) - (oxx[0:1] * ee_x + oyy[0:1] * ee_y)
        zero = jnp.zeros((T, Bn), jnp.float32)
        cost_v, csum, cox, coy = zero, zero, zero, zero
        for o in range(O):
            s = (h + q[o:o + 1]) - (oxx[o:o + 1] * ee_x + oyy[o:o + 1] * ee_y)
            inv = body.recip(s)
            winv = ow8[o:o + 1] * inv
            cost_v = cost_v + winv
            coef = winv * inv
            csum = csum + coef
            cox = cox + coef * oxx[o:o + 1]
            coy = coy + coef * oyy[o:o + 1]
        cv_ref[:], csum_ref[:], cox_ref[:], coy_ref[:] = cost_v, csum, cox, coy
        gx_ref[:] = cox - ee_x * csum
        gy_ref[:] = coy - ee_y * csum

    plane = jax.ShapeDtypeStruct((T, Bn), jnp.float32)
    shapes = [jax.ShapeDtypeStruct((O, Bn), jnp.float32)] + [plane] * 9
    outs = pl.pallas_call(kernel, out_shape=shapes, interpret=True)(
        ex, ey, ox, oy, ow)
    return dict(zip(FIELD_PLANES, (np.asarray(x) for x in outs)))


def _port_field_planes(want, ex, ey, ox, oy, ow):
    """The port's plain field (fused_solve's helpers as they stand) fed,
    plane by plane, JAX's own inputs of the plane (its q, h and the
    accumulators' terms at JAX's s), so that each plane is compared
    alone."""
    ex, ey, ox, oy, ow = map(_t, (ex, ey, ox, oy, ow))
    q, h = _t(want["q"]), _t(want["h"])
    ow8 = 0.8 * ow
    inv = [tfs.recip(tfs.field_dist(h, q[o], ox[o], ex, oy[o], ey))
           for o in range(ox.shape[0])]
    winv = [ow8[o] * r for o, r in enumerate(inv)]
    coef = [w * r for w, r in zip(winv, inv)]
    cox = tfs.field_acc([(c, ox[o]) for o, c in enumerate(coef)])
    coy = tfs.field_acc([(c, oy[o]) for o, c in enumerate(coef)])
    terms = list(zip(winv, inv))
    csum = tfs.field_acc(terms)
    got = {
        "q": tfs.field_q(ox, oy), "h": tfs.field_h(ex, ey),
        "s": tfs.field_dist(h, q[0], ox[0], ex, oy[0], ey),
        "sum": tfs.field_sum([(ow8[o], r) for o, r in enumerate(inv)]),
        "cv": tfs.field_sum([(ow8[o], r) for o, r in enumerate(inv)]),
        "csum": csum, "cox": cox, "coy": coy,
        "gx": tfs.field_grad(_t(want["cox"]), ex, _t(want["csum"])),
        "gy": tfs.field_grad(_t(want["coy"]), ey, _t(want["csum"])),
    }
    # The first pair the other way round: fma(a1, b1, a0 b0).
    got["csum_10"] = tfs.field_acc([terms[1], terms[0]] + terms[2:])
    return {k: float((v.numpy() == want[k.split("_")[0]]).mean())
            for k, v in got.items()}


def test_field_contractions(monkeypatch, scenes):
    """The obstacle field's planes, one at a time, against JAX's
    interpreted kernel (16 random scenes at T = 200, the end effector of
    the warm start's trajectory jittered; the port given JAX's
    reciprocal, _jax_recip, and each plane JAX's own inputs).  XLA
    contracts every one of them: q_o = 0.5 + 0.5 fma(ox, ox, oy oy); h and
    s as test_evaluation_contractions found; the field's sum over the
    obstacles and the accumulator co{x,y} as fma(a0, b0, a1 b1) and then
    each term fused into the sum; csum the same, but which product of its
    first pair XLA fuses depends on the fusion around it (this kernel
    fuses the first; one that also returns obstacle 0's reciprocal fuses
    the second, fma(a1, b1, a0 b0), and either order leaves the other 0.97
    of the plane JAX's); g{x,y} = fma(-e, csum, co).
    With all of them (CONTRACTIONS["field"]) every plane is JAX's bit for
    bit; as shipped none is.  What still parts the evaluation's loss from
    JAX's (test_evaluation_contractions) is no contraction: XLA's sin and
    cos differ from torch's on about 5% of arguments (the FK), and its sum
    over T adds in another order."""
    jcfg, jb, scns, fsc, a0 = scenes
    traj = np.asarray(jfleet.fleet_evaluate(jcfg, jb, a0)[0])
    traj = traj + np.random.default_rng(0).normal(
        0.0, 0.3, traj.shape).astype(np.float32)
    ang = np.cumsum(traj, axis=1)
    link = np.asarray(jcfg.link_length, np.float32)[None, :, None]
    ex = (np.cos(ang) * link).sum(1).astype(np.float32)
    ey = (np.sin(ang) * link).sum(1).astype(np.float32)
    ox, oy, ow = (np.asarray(x) for x in (
        fsc.obstacles[:, 0, :], fsc.obstacles[:, 1, :], fsc.obstacle_weight))
    want = _jax_field_planes(jcfg, ex, ey, ox, oy, ow)
    with monkeypatch.context() as m:
        m.setattr(tfs, "recip", _jax_recip)
        shipped = _port_field_planes(want, ex, ey, ox, oy, ow)
        _contract(m, ("field",))
        once = _port_field_planes(want, ex, ey, ox, oy, ow)
    print(f"field planes bitwise JAX's: shipped {shipped}, contracted {once}")
    assert max(once.pop("csum"), once.pop("csum_10")) == 1.0
    assert once == {k: 1.0 for k in FIELD_PLANES if k != "csum"}
    assert all(v < 1.0 for v in shipped.values())


def test_carry_program_rounds_twice(monkeypatch):
    """The linearized carry program (K1/K2-BLS, K3-linearized) keeps two
    roundings of the accepted alpha: with one, bench.py's reference scene
    ends past its strict endpoint gate (< 0.01, the main path's) on the
    plain path.  Measured (B=2, the bench schedule): endpoint 0.0095 as
    shipped, 0.0108 with one rounding."""
    shipped = bench.run_bench(batch=2, repeats=1, device="cpu")
    monkeypatch.setattr(tfs, "two_roundings", tfs.fma)
    once = bench.run_bench(batch=2, repeats=1, device="cpu")
    print(f"reference scene endpoint: {shipped['endpoint_err']} shipped, "
          f"{once['endpoint_err']} with one rounding")
    assert shipped["quality_ok"] and shipped["endpoint_err"] < 0.01
    assert once["endpoint_err"] >= 0.01
