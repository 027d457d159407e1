"""The port's per-step backend against the JAX package: the plain versions
of the per-step kernels (ops/step_kernels.py) against pallas_step's
``forward_eval``, ``cost_grad_eval``, ``bls_inner_step`` and
``gd_inner_step`` run interpreted on the CPU; the per-step driver
(``fleet_solve(backend="pallas")``, BLS and GD) and the plain GD engine
(``backend="xla", solver="gd"``) against JAX's; and the bench's per-step and
GD modes on the plain path.

Inputs are made with numpy from a seed, or by JAX's ``random_scenarios``,
and handed to both sides as numpy arrays.  The JAX side runs with
``recip_newton=True`` (its interpreted reciprocal is otherwise off by 4e-3;
see test_torch_fused_solve.py).  Single steps are compared element by
element; whole solves as lane-agreement fractions (a 1-ulp difference grows
about 4x per BLS step).
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
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11)
B = 128
# fleet_solve(backend="pallas") against JAX's (interpret=True) at SHORT on
# 128 random scenes (PRNGKey(9)): measured lane agreement (equal step
# counts, escalations and flags) BLS 0.7578, GD 0.8828; alpha within 2.7e-6
# (BLS) and 5.7e-7 (GD) of the lane's scale on the agreeing lanes.  Both
# flip stop decisions at the 1e-3 threshold; GD's trial is evaluated from
# alpha, whose warm-start coefficients cancel in the forward product
# (test_one_step_reference_matches_jax), so a GD lane's stop step moves by
# one on some lanes.  Over PRNGKey(1..4): BLS 0.625-0.703, GD 0.852-0.953,
# alpha within 1.9e-5 and 6.8e-7.
PALLAS_AGREEMENT_MIN = {"bls": tfs.LANE_AGREEMENT_MIN, "gd": 0.80}
# The plain GD engine against JAX's, same config and scenes: the same
# fractions as the per-step GD path (0.852-0.953 over PRNGKey(1..4) and 9);
# within the port the two GD paths agree on every lane (measured alpha
# within 2.3e-8 of the lane's scale, test_pallas_and_xla_gd_agree).
XLA_GD_AGREEMENT_MIN = 0.80


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
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(9), B)
    return jcfg, tcfg, jb, scns


@pytest.fixture(scope="module")
def step_inputs(setup):
    """One step's inputs on 128 random scenes: JAX's round-start evaluation
    at the warm start under penalties escalated x1/x10/x100, a quarter of
    the lanes frozen, four BLS learning rates (and the GD schedule's first
    two rates), all as numpy."""
    jcfg, _, jb, scns = setup
    rng = np.random.default_rng(3)
    fs = jfleet.to_fleet(scns)
    a0 = np.asarray(jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, jb, fs), 1, 0))
    esc = rng.choice(np.array([1.0, 10.0, 100.0], np.float32), (1, B))
    lsg = (np.float32(jcfg.lambda_sg_constraint) * esc).astype(np.float32)
    ljl = (np.float32(jcfg.lambda_jl_constraint) * esc).astype(np.float32)
    basis = [np.asarray(x) for x in (jb.kv, jb.kv.T, jb.mix)]
    lanes = [np.asarray(x) for x in (fs.start, fs.goal, fs.obstacles[:, 0, :],
                                     fs.obstacles[:, 1, :], fs.obstacle_weight)]
    ev = ps.cost_grad_eval(jcfg, *basis, a0, lsg, ljl, *lanes, block_b=B,
                           interpret=True)
    ev = [np.asarray(x) for x in ev]
    frozen = (rng.random((1, B)) < 0.25).astype(np.float32)
    bls_lr = rng.choice(np.array([0.2, 0.1, 0.05, 0.3], np.float32), (1, B))
    gd_lr = rng.choice(np.array(jcfg.gd_lr[:2], np.float32), (1, B))
    return dict(basis=basis, a0=a0, lsg=lsg, ljl=ljl, lanes=lanes, ev=ev,
                frozen=frozen, bls_lr=bls_lr, gd_lr=gd_lr)


@pytest.fixture(scope="module")
def moderate(setup, step_inputs):
    """A numpy-seeded alpha of moderate size (no warm-start cancellation in
    the forward product) that reaches the joint-limit masks."""
    return np.random.default_rng(4).normal(0, 0.15, (3, 50, B)).astype(np.float32)


@pytest.mark.parametrize("alpha", ["moderate", "warm start"])
def test_forward_eval_reference_matches_jax(setup, step_inputs, moderate,
                                            alpha):
    """K6's plain version against pallas_step.forward_eval, at a moderate
    alpha and at the warm start (O(1e4) coefficients cancelling to O(1)).
    Measured: traj 1.2e-7 and 2.4e-7, vel 1.4e-6 and 4.8e-7.  The wrapper
    runs the plain version on CPU tensors and launches nothing."""
    jcfg, tcfg, _, _ = setup
    d = step_inputs
    kv, _, mix = d["basis"]
    a = moderate if alpha == "moderate" else d["a0"]
    tol = (1e-6, 5e-6)
    want = ps.forward_eval(jcfg, kv, mix, a, block_b=B, interpret=True)
    before = sk.forward_eval.launches
    got = sk.forward_eval(tcfg, _t(kv), _t(mix), _t(a))
    assert sk.forward_eval.launches == before == 0
    assert isinstance(got, sk.PallasForward)
    np.testing.assert_allclose(got.traj.numpy(), np.asarray(want.traj),
                               atol=tol[0])
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               atol=tol[1])
    for x, y in zip(got, sk.forward_eval_reference(tcfg, _t(kv), _t(mix),
                                                   _t(a))):
        assert torch.equal(x, y)


def test_cost_grad_eval_reference_matches_jax(setup, step_inputs, moderate):
    """K5's plain version against pallas_step.cost_grad_eval at a moderate
    alpha (the joint-limit masks live) with penalties x1/x10/x100.
    Measured: loss 2.4e-6 relative, grad 4.9e-4 absolute on values up to
    3.7e3 (within 2e-6 of each value), traj/vel as K6's.  At the warm start
    traj and vel agree as closely, but on some lanes the blend's first
    argmax or a joint-limit mask sits at a near tie and the gradient takes
    the other side: only the loss is compared there, measured 5.0e-6
    relative."""
    jcfg, tcfg, _, _ = setup
    d = step_inputs
    for a, loss_rtol in ((d["a0"], 5e-5), (moderate, 1e-5)):
        want = ps.cost_grad_eval(jcfg, *d["basis"], a, d["lsg"], d["ljl"],
                                 *d["lanes"], block_b=B, interpret=True)
        want = [np.asarray(x) for x in want]
        got = sk.cost_grad_eval(tcfg, *map(_t, d["basis"]), _t(a),
                                _t(d["lsg"]), _t(d["ljl"]),
                                *map(_t, d["lanes"]))
        assert isinstance(got, sk.PallasEval)
        assert sk.cost_grad_eval.launches == 0
        loss, grad, traj, vel = (x.numpy() for x in got)
        np.testing.assert_allclose(loss, want[0], rtol=loss_rtol)
    assert ((traj > 1.96) | (traj < -0.98)).any()   # the masks are live
    np.testing.assert_allclose(grad, want[1], rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(traj, want[2], atol=1e-6)
    np.testing.assert_allclose(vel, want[3], atol=5e-6)


def _jax_state(d):
    return [d["a0"], *d["ev"][1:], d["ev"][0]]


# Bounds of one step against JAX's from each starting state, on the live
# lanes (measured in the comments of the test): alpha relative to the
# lane's scale, traj and vel absolute, the loss relative, and the share of
# lanes whose gradient is within 1e-4 of the lane's scale (the others have
# the blend's first argmax or a joint-limit mask on the other side of a
# near tie).
STEP_BOUNDS = {
    "moderate": dict(alpha=1e-6, traj=1e-6, vel=1e-5, loss=2e-5, grad=0.98),
    "warm start": dict(alpha=1e-6, traj=2e-2, vel=5e-2, loss=1e-2, grad=0.75),
}


@pytest.mark.parametrize("solver", ["bls", "gd"])
@pytest.mark.parametrize("start", ["moderate", "warm start"])
def test_one_step_reference_matches_jax(setup, step_inputs, moderate, solver,
                                        start):
    """One BLS (K3) or GD (K4) step's plain version against
    pallas_step.bls_inner_step / gd_inner_step (interpret=True) from JAX's
    evaluation of the same alpha, with a quarter of the lanes frozen,
    penalties x1/x10/x100 and mixed learning rates.  Frozen lanes pass
    through bit for bit on both sides; lr and the stop flags are equal on
    every lane.  From the warm start the GD trial's O(1e4) coefficients
    would part by an ulp under two roundings, which the forward product's
    cancellation turns into 2e-3 on traj; both sides round it once (an
    FMA), and the trials are equal.  Measured on the live lanes:

    - moderate, BLS (no lane stops): alpha 1.2e-7, traj 2.2e-7, vel 1.1e-6,
      loss 2.4e-6, gradient within 1e-4 on every lane;
    - moderate, GD (27 of 98 stop): alpha 0, traj 2.4e-7, vel 9.5e-7,
      loss 2.4e-6, gradient within 1e-4 on every lane;
    - warm start, BLS (3 stop): alpha 1.2e-7, traj 1.2e-7, vel 4.8e-7, loss
      6.3e-6, gradient within 1e-4 on 97 of 98 lanes (one at 1.4e-2: a
      near tie);
    - warm start, GD (46 stop): alpha 0, traj 2.4e-7, vel 2.4e-7, loss
      6.2e-6, gradient within 1e-4 on every lane (two roundings: traj
      2.1e-3, vel 1.7e-2, loss 3.5e-4, 0.79 of the lanes)."""
    jcfg, tcfg, _, _ = setup
    d = step_inputs
    if start == "warm start":
        alpha, grad, traj, vel, loss = _jax_state(d)
    else:
        ev = ps.cost_grad_eval(jcfg, *d["basis"], moderate, d["lsg"], d["ljl"],
                               *d["lanes"], block_b=B, interpret=True)
        alpha = moderate
        loss, grad, traj, vel = (np.asarray(x) for x in ev)
    lr = d["bls_lr"] if solver == "bls" else d["gd_lr"]
    fn = ps.bls_inner_step if solver == "bls" else ps.gd_inner_step
    want = fn(jcfg, *d["basis"], alpha, grad, traj, vel, loss, lr, d["frozen"],
              d["lsg"], d["ljl"], *d["lanes"], block_b=B, interpret=True)
    want = [np.asarray(x) for x in want]
    tfn = sk.bls_inner_step if solver == "bls" else sk.gd_inner_step
    args = [_t(x) for x in (*d["basis"], alpha, grad, traj, vel, loss, lr,
                            d["frozen"], d["lsg"], d["ljl"], *d["lanes"])]
    got = tfn(tcfg, *args)
    assert isinstance(got, sk.PallasStep) and tfn.launches == 0
    got = [x.numpy() for x in got]
    fz = d["frozen"][0] > 0.5
    ins = (alpha, grad, traj, vel, loss, lr, d["frozen"])
    for g, w, x in zip(got, want, ins):
        np.testing.assert_array_equal(g[..., fz], x[..., fz])
        np.testing.assert_array_equal(w[..., fz], x[..., fz])
    np.testing.assert_array_equal(got[5], want[5])                  # lr
    np.testing.assert_array_equal(got[6], want[6])                  # stop
    live = ~fz
    stops = int((got[6][0][live] > 0.5).sum())

    def lane_rel(k):
        scale = np.abs(want[k]).max(axis=(0, 1))
        return (np.abs(got[k] - want[k]).max(axis=(0, 1)) / scale)[live]

    err = dict(
        alpha=lane_rel(0).max(),
        traj=np.abs(got[2] - want[2])[..., live].max(),
        vel=np.abs(got[3] - want[3])[..., live].max(),
        loss=np.abs(got[4][0][live] / want[4][0][live] - 1).max(),
        grad=float((lane_rel(1) <= 1e-4).mean()),
    )
    print(f"{solver} from {start}: {stops} of {int(live.sum())} live lanes "
          f"stop; {err}")
    assert stops < live.sum()
    assert stops > 0 or (solver, start) == ("bls", "moderate")
    bound = STEP_BOUNDS[start]
    for k in ("alpha", "traj", "vel", "loss"):
        assert err[k] <= bound[k], (k, err[k])
    assert err["grad"] >= bound["grad"]


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_step_wrapper_out_updates_in_place(setup, step_inputs, solver):
    """With ``out`` set to the input state, the wrapper writes the new state
    into it (the driver's in-place mode); without ``out`` the inputs are
    left as they are.  Both give the plain version's values."""
    _, tcfg, _, _ = setup
    d = step_inputs
    lr = d["bls_lr"] if solver == "bls" else d["gd_lr"]
    state = [_t(x).clone() for x in (*_jax_state(d), lr, d["frozen"])]
    keep = [x.clone() for x in state]
    head = [_t(x) for x in d["basis"]]
    tail = [_t(x) for x in (d["lsg"], d["ljl"], *d["lanes"])]
    fn = sk.bls_inner_step if solver == "bls" else sk.gd_inner_step
    ref = fn(tcfg, *head, *state, *tail)
    for x, y in zip(state, keep):
        assert torch.equal(x, y)
    out = fn(tcfg, *head, *state, *tail, out=state)
    for o, x, r in zip(out, state, ref):
        assert o is x and torch.equal(x, r)
    with pytest.raises(ValueError, match="out tensors"):
        fn(tcfg, *head, *keep, *tail, out=[x[..., :2] for x in keep])


def test_step_wrappers_check_arguments(setup, step_inputs):
    _, tcfg, _, _ = setup
    d = step_inputs
    args = [_t(x) for x in (*d["basis"], *_jax_state(d), d["bls_lr"],
                            d["frozen"], d["lsg"], d["ljl"], *d["lanes"])]
    bad = list(args)
    bad[8] = bad[8][:, :1]
    with pytest.raises(ValueError, match="lr float32"):
        sk.bls_inner_step(tcfg, *bad)
    with pytest.raises(NotImplementedError):
        sk.bls_inner_step(tcfg.replace(ladder_eval="exact",
                                       bls_bf16_ladder=True), *args)
    with pytest.raises(NotImplementedError):
        sk.gd_inner_step(tcfg.replace(matmul_precision="default"), *args)
    # Both ladder tiers run, each the plain version of its own program.
    cfg = tcfg.replace(ladder_eval="exact")
    for x, y in zip(sk.bls_inner_step(cfg, *args),
                    sk.bls_inner_step_reference(cfg, *args)):
        assert torch.equal(x, y)
    # GD has no ladder: the ladder's modes do not concern it.
    sk.gd_inner_step(tcfg.replace(ladder_eval="exact"), *args)


def test_plain_gd_step_counts_its_work(setup, step_inputs):
    """fused_solve.gd_step's tally: every live lane steps once; the
    accepted ones are the live lanes whose stop test did not fire."""
    _, tcfg, _, _ = setup
    d = step_inputs
    tally = {}
    got = sk.gd_inner_step_reference(
        tcfg, *map(_t, d["basis"]), *map(_t, _jax_state(d)), _t(d["gd_lr"]),
        _t(d["frozen"]), _t(d["lsg"]), _t(d["ljl"]), *map(_t, d["lanes"]),
        tally=tally)
    live = _t(d["frozen"])[0] < 0.5
    assert torch.equal(tally["steps"], live.float())
    assert torch.equal(tally["accepted"],
                       (live & (got.minimized[0] < 0.5)).float())


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_pallas_fleet_solve_matches_jax(setup, solver):
    """fleet_solve(backend="pallas") against JAX's (interpret=True) at
    SHORT on 128 random scenes: lane agreement PALLAS_AGREEMENT_MIN, alpha
    within tfs.ALPHA_REL_MAX of the lane's scale on the agreeing lanes."""
    jcfg, tcfg, jb, scns = setup
    want = jfleet.fleet_solve(jcfg, jb, scns, solver=solver, backend="pallas",
                              interpret=True)
    tb = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                              for k in jb._fields}, device="cpu")
    got = tfleet.fleet_solve(tcfg, tb, _tscn(scns), solver=solver,
                             backend="pallas")
    assert got.alpha.shape == (B, 50, 3)
    assert got.stats.inner_iters.dtype == torch.int32
    assert got.stats.outer_iters.dtype == torch.int32
    assert got.stats.converged.dtype == torch.bool
    agree, rel = tfs.lane_agreement(_as_fused(want), _as_fused(got))
    print(f"{solver}: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= PALLAS_AGREEMENT_MIN[solver]
    assert rel <= tfs.ALPHA_REL_MAX
    assert torch.isfinite(got.stats.final_cost).all()


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_pallas_replicated_scene_lanes_identical(solver):
    """The reference scene on 64 lanes through the per-step driver: every
    lane ends equal to lane 0 bit for bit."""
    cfg = mt.PlannerConfig(**SHORT)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device="cpu"), 64)
    res = tfleet.fleet_solve(cfg, basis, scns, solver=solver, backend="pallas")
    assert torch.equal(res.alpha, res.alpha[:1].expand_as(res.alpha))
    for x in res.stats:
        assert torch.equal(x, x[:1].expand_as(x))
    assert int(res.stats.inner_iters[0]) > 0


def test_xla_gd_matches_jax(setup):
    """fleet_solve(backend="xla", solver="gd") against JAX's plain GD engine
    at SHORT on 128 random scenes: XLA_GD_AGREEMENT_MIN of the lanes, alpha
    within tfs.ALPHA_REL_MAX; on the agreeing lanes the final cost within
    2e-2 relative (the final loss cancels the warm start's O(1e4)
    coefficients, as in test_torch_hetero.py's xla test)."""
    _, tcfg, jb, scns = setup
    jcfg = mp.PlannerConfig(**SHORT)
    want = jfleet.fleet_solve(jcfg, jb, scns, solver="gd", backend="xla")
    tb = mt.make_basis(mt.PlannerConfig(), device="cpu")
    got = tfleet.fleet_solve(tcfg, tb, _tscn(scns), solver="gd", backend="xla")
    agree, rel = tfs.lane_agreement(_as_fused(want), _as_fused(got))
    print(f"xla gd: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= XLA_GD_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    same = ((got.stats.inner_iters.numpy() == np.asarray(want.stats.inner_iters))
            & (got.stats.outer_iters.numpy() == np.asarray(want.stats.outer_iters)))
    np.testing.assert_allclose(got.stats.final_cost.numpy()[same],
                               np.asarray(want.stats.final_cost)[same],
                               rtol=2e-2)


def test_pallas_and_xla_gd_agree(setup):
    """The per-step GD driver against the plain GD engine in the port, on
    the same scenes: the same lanes step, escalate and converge on nearly
    every lane (measured: all 128, alpha within 2.3e-8 of the lane's
    scale); XLA_GD_AGREEMENT_MIN, alpha within tfs.ALPHA_REL_MAX."""
    _, tcfg, jb, scns = setup
    tb = mt.make_basis(mt.PlannerConfig(), device="cpu")
    a = tfleet.fleet_solve(tcfg, tb, _tscn(scns), solver="gd", backend="pallas")
    b = tfleet.fleet_solve(tcfg, tb, _tscn(scns), solver="gd", backend="xla")
    agree, rel = tfs.lane_agreement(_as_fused(a), _as_fused(b))
    print(f"pallas vs xla gd: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= XLA_GD_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX


@pytest.mark.parametrize("flags,metric", [
    (["--backend", "pallas"], "bls_solves_per_sec_cpu_rehearsal"),
    (["--solver", "gd", "--backend", "pallas"],
     "gd_solves_per_sec_cpu_rehearsal"),
    (["--solver", "gd", "--backend", "xla"], "gd_solves_per_sec_cpu_rehearsal"),
])
def test_bench_cpu_rehearsal(capsys, flags, metric):
    """The bench's per-step and GD modes end to end on the plain path: the
    reference scene at B=2 over the solver's full schedule, under the
    solver's own gate (avg/max within 2% of REFERENCE_FINAL_COST[solver];
    endpoint < 0.01 for BLS, < 0.042 for GD).  Measured: BLS per-step avg
    1.6477, max 2.1965, endpoint 0.0095; GD avg 1.6667, max 2.2034,
    endpoint 0.0326 on both backends (GD's trial rounded once, as XLA
    forms it)."""
    rc = bench.main(["--device", "cpu", "--batch", "2", "--repeats", "1",
                     *flags])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    print(out)
    assert out["metric"] == metric
    assert rc == 0 and out["quality_ok"] is True
    assert out["device"] == "cpu" and out["power_limit"] is None


def test_bench_gd_random_scenes_gate_is_solver_aware(capsys):
    """GD on random scenes through the per-step backend: the paired gate
    solves the same scenes with the plain GD engine and passes."""
    rc = bench.main(["--device", "cpu", "--random-scenarios", "--batch", "64",
                     "--repeats", "1", "--seed", "2", "--solver", "gd",
                     "--backend", "pallas", "--quality-check-lanes", "64"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    print(out)
    assert rc == 0 and out["quality_ok"] is True
    assert out["paired_check_lanes"] == 64 and out["phantom_frac"] == 0.0


@pytest.mark.parametrize("make", [
    lambda cfg: mt.make_basis(cfg),
    lambda cfg: mt.basis_from_numpy(
        {k: np.zeros(2, np.float32) for k in mt.Basis._fields}),
    lambda cfg: mt.make_scenario(cfg, (0, 0, 0), (1, 1, 1), [(1, 1)]),
    lambda cfg: mt.reference_scenario(cfg),
    lambda cfg: mt.random_scenarios(cfg, torch.Generator().manual_seed(0), 2),
])
def test_constructors_default_to_the_card(monkeypatch, make):
    """Without ``device`` the constructors build on the card; with no CUDA
    device they raise, naming device="cpu", and never fall back; with
    ``device="cpu"`` they build on the CPU."""
    cfg = mt.PlannerConfig()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make(cfg)
    from irm_motion_planning_tpu_torch import device
    assert device.resolve("cpu") == torch.device("cpu")


def test_roofline_counts_the_k6_example():
    """The bound of K6 at 1,048,576 lanes, worked out by hand: alpha in,
    traj and vel out, 3 x 629 MB = 1.89 GB, 0.56 ms at 3.35 TB/s; 31.5 kFLOP
    per lane, 33 GFLOP, 0.49 ms at 67 TFLOP/s: bound by bytes."""
    from irm_motion_planning_tpu_torch.ops import roofline

    b = roofline.forward_eval(1048576, 50, 3)
    assert b.bytes == 3 * 1048576 * 600 + (2 * 50 * 50 + 9) * 4  # + kv, mix
    assert b.ops == 1048576 * 31500
    assert b.by == "bytes" and abs(b.ms - 0.5634) < 1e-3
    k5 = roofline.cost_grad_eval(1048576, 50, 3, 11)
    assert k5.by == "operations" and k5.ms > b.ms
    n = roofline.LaneOps.at(50, 3, 11)
    tally = {"steps": torch.ones(4), "rungs": 2 * torch.ones(4),
             "pullbacks": torch.tensor([1.0, 1.0, 0.0, 1.0]),
             "rounds": torch.ones(4), "accepted": torch.ones(4)}
    k3 = roofline.bls_inner_step(4, 50, 3, 11, tally)
    assert k3.ops == 4 * (n.step + 4) + 8 * (n.rung + 4) + 3 * (
        n.cost + n.loss + n.grad)
    assert roofline.gd_inner_step(4, 50, 3, 11, tally).ops > 0
    assert roofline.fused_rounds(4, 50, 3, 11, tally, True).ops > k3.ops


@pytest.mark.parametrize("ladder", ["linearized", "exact"])
def test_plain_k3_step_is_k1s_step(setup, step_inputs, ladder):
    """The plain K3 step (bls_inner_step_reference: no FK carry, the loss
    recomputed at the accepted iterate) gives the plain K1/K2 step's floats
    on the same state bit for bit, in both ladder tiers: fused_solve.
    bls_step as run_inner calls it (the linearized ladder with the FK
    carry, which keeps the accepted rung's loss).  The accepted candidate is
    formed by the rung's own operations, so the recompute gives the rung's
    floats; on the card K3 therefore runs K1's program of the warp body
    (csrc/step_kernels.cu)."""
    _, tcfg, _, _ = setup
    cfg = tcfg.replace(ladder_eval=ladder)
    d = step_inputs
    kv, kvt, mix = map(_t, d["basis"])
    loss, grad, traj, vel = map(_t, d["ev"])
    alpha, lsg, ljl, frozen, lr = map(_t, (d["a0"], d["lsg"], d["ljl"],
                                           d["frozen"], d["bls_lr"]))
    start, goal, ox, oy, ow = map(_t, d["lanes"])
    k3 = sk.bls_inner_step_reference(cfg, kv, kvt, mix, alpha, grad, traj,
                                     vel, loss, lr, frozen, lsg, ljl, start,
                                     goal, ox, oy, ow)
    c = tfs.consts(cfg)
    carry = {}
    if ladder == "linearized":
        _, _, px, py = tfs.fk_ee(c, traj)
        carry = dict(px=px, py=py)
    live = frozen[0] < 0.5
    k1 = tfs.bls_step(cfg, c, kv, kvt, mix, start, goal,
                      tfs.obs_ctx(ox, oy, ow), lsg[0], ljl[0], alpha, grad,
                      traj, vel, loss[0], lr[0], ~live, **carry)
    pulled = live & ~k1[6]
    assert int(pulled.sum()) >= B // 4
    new_min = torch.where(live, k1[6].to(torch.float32), frozen[0])
    for x, y in zip(k3, (*k1[:4], k1[4][None], k1[5][None], new_min[None])):
        assert torch.equal(x, y)


def test_per_step_bls_path_equals_fused_bls():
    """The linearized ladder's plain per-step path (backend="pallas" on the
    CPU: K5 at each round start, K3 per step, K6 before the constraint
    check) equals the plain K1 bit for bit, every count too, as the exact
    ladder's (test_torch_exact.py) and GD's (test_torch_fused_gd.py) do;
    chip_smoke.py holds the kernels to the same."""
    cfg = mt.PlannerConfig(max_outer_iteration=3, max_inner_iteration=8,
                           fixed_iters=True, max_obstacles=11)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(1), 64,
                               device="cpu")
    want = tfleet.fleet_solve(cfg, basis, scns, backend="fused")
    got = tfleet.fleet_solve(cfg, basis, scns, backend="pallas")
    assert 0 < float(want.stats.converged.float().mean()) < 1
    assert torch.equal(got.alpha, want.alpha)
    for x, y in zip(got.stats, want.stats):
        assert torch.equal(x, y)
