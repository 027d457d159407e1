"""The port's fused BLS solve (ops/fused_solve.py) against the JAX package's
Pallas kernels, run interpreted on the CPU as tests/test_fleet_fused.py runs
them.

The JAX side runs with ``recip_newton=True``: in interpret mode the TPU
kernel's approximate reciprocal carries a 4e-3 relative error (measured),
while the port divides exactly; the Newton step brings JAX's to ~1.4e-5.

Per-lane outcomes of whole solves are compared as agreement fractions: a
1-ulp difference in one step's state grows about 4x per BLS step (measured
on these scenes), so after a few steps lanes flip their Armijo or stop
decisions at the 1e-3 thresholds — the JAX package's own lean mode, a 1-2
ulp change, is held to 75% step-count agreement (test_fleet_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.ops import pallas_step as ps
from irm_motion_planning_tpu.solvers import fleet as jfleet

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs

SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11)


def _t(x):
    return torch.tensor(np.asarray(x))


def _kernel_args(cfg, basis, scns):
    fs = jfleet.to_fleet(scns)
    a0 = jnp.moveaxis(jfleet.fleet_init_alpha(cfg, basis, fs), 1, 0)
    B = a0.shape[-1]
    return (
        basis.kv, basis.kv.T, basis.mix, a0,
        jnp.full((1, B), cfg.lambda_sg_constraint, jnp.float32),
        jnp.full((1, B), cfg.lambda_jl_constraint, jnp.float32),
        fs.start, fs.goal,
        fs.obstacles[:, 0, :], fs.obstacles[:, 1, :], fs.obstacle_weight,
    )


@pytest.fixture(scope="module")
def setup():
    jcfg = mp.PlannerConfig(recip_newton=True, **SHORT)
    tcfg = mt.PlannerConfig(**SHORT)
    basis = mp.make_basis(jcfg)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(9), 128)
    return jcfg, tcfg, basis, scns


@pytest.fixture(scope="module")
def pieces(setup):
    """Inputs of the piece tests at B=16 and the JAX round-start eval."""
    jcfg, tcfg, basis, scns = setup
    args = _kernel_args(jcfg, basis,
                        jax.tree_util.tree_map(lambda x: x[:16], scns))
    ev = ps.cost_grad_eval(jcfg, *args, block_b=16, interpret=True)
    return args, jax.tree_util.tree_map(np.asarray, ev)


def test_forward_planes_matches(setup, pieces):
    """kv @ alpha per joint and the mix combine.  The product cancels the
    O(1e4) warm-start coefficients to O(1) and sums in another order than
    JAX's CPU dot: measured 3.8e-3 on traj, 1.9e-2 on vel."""
    args, ev = pieces
    traj, vel = tfs.forward_planes(_t(args[0]), _t(args[2]), _t(args[3]))
    np.testing.assert_allclose(traj.numpy(), ev.traj, atol=2e-2)
    np.testing.assert_allclose(vel.numpy(), ev.vel, atol=5e-2)


def test_round_start_eval_matches(setup, pieces):
    """Loss and gradient from the same (traj, vel) as the JAX kernel's:
    the FK, obstacle field, first-argmax blend, limit masks and the kvt
    pull-back.  Measured: loss 4.5e-6 relative (JAX's Newton reciprocal
    against exact division), grad 3e-5 absolute on values up to 4."""
    jcfg, tcfg, _, _ = setup
    args, ev = pieces
    kv, kvt, mix, a0, lsg, ljl, st, go, ox, oy, ow = (_t(x) for x in args)
    c = tfs.consts(tcfg)
    loss, grad, px, py = tfs.cost_grad_from_traj(
        tcfg, c, kvt, mix, _t(ev.traj), _t(ev.vel), st, go,
        tfs.obs_ctx(ox, oy, ow), lsg[0], ljl[0])
    np.testing.assert_allclose(loss.numpy(), ev.loss[0], rtol=5e-5)
    np.testing.assert_allclose(grad.numpy(), ev.grad, atol=2e-4)
    # The full eval (with the port's own forward) agrees as far as the
    # forward does.
    loss2, _, traj2, _, _, _ = tfs.cost_grad_eval(
        tcfg, c, kv, kvt, mix, a0, st, go, tfs.obs_ctx(ox, oy, ow),
        lsg[0], ljl[0])
    np.testing.assert_allclose(loss2.numpy(), ev.loss[0], rtol=1e-2)
    np.testing.assert_allclose(traj2.numpy(), ev.traj, atol=2e-2)


def test_one_bls_step_matches(setup, pieces):
    """One BLS step against bls_inner_step (which has no FK carry, so the
    port's step runs without it too), from the same state.  Measured:
    alpha 1.2e-7 relative, traj/vel 7e-7, grad 4e-5 absolute, loss 4e-6
    relative; the learning rates and stop flags are equal."""
    jcfg, tcfg, _, _ = setup
    args, ev = pieces
    kv, kvt, mix, a0, lsg, ljl, st, go, ox, oy, ow = args
    B = a0.shape[-1]
    lr = jnp.full((1, B), jcfg.bls_lr_start, jnp.float32)
    mn = jnp.zeros((1, B), jnp.float32)
    want = ps.bls_inner_step(jcfg, kv, kvt, mix, a0, ev.grad, ev.traj,
                             ev.vel, ev.loss, lr, mn, lsg, ljl, st, go, ox,
                             oy, ow, block_b=16, interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = tfs.bls_step(
        tcfg, tfs.consts(tcfg), _t(kv), _t(kvt), _t(mix), _t(st), _t(go),
        tfs.obs_ctx(_t(ox), _t(oy), _t(ow)), _t(lsg)[0], _t(ljl)[0],
        _t(a0), _t(ev.grad), _t(ev.traj), _t(ev.vel), _t(ev.loss)[0],
        _t(lr)[0], torch.zeros(B, dtype=torch.bool))
    alpha, grad, traj, vel, loss, new_lr, new_min = got
    np.testing.assert_allclose(alpha.numpy(), want.new_alpha, atol=1e-2,
                               rtol=1e-6)
    np.testing.assert_allclose(traj.numpy(), want.new_traj, atol=1e-5)
    np.testing.assert_allclose(vel.numpy(), want.new_vel, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want.new_grad, atol=2e-4)
    np.testing.assert_allclose(loss.numpy(), want.new_loss[0], rtol=5e-5)
    np.testing.assert_array_equal(new_lr.numpy(), want.new_lr[0])
    np.testing.assert_array_equal(new_min.numpy(), want.minimized[0] > 0.5)


def test_short_solve_matches_fused_kernel(setup):
    """The whole short solve on 128 random scenes against
    pallas_step.fused_solve(interpret=True).  Measured: 79.7% of lanes end
    with equal step counts and flags, their alpha within 1.9e-6 of the
    lane's scale; mean final loss within 4e-5 relative; no lane converges at this
    budget on either side."""
    jcfg, tcfg, basis, scns = setup
    args = _kernel_args(jcfg, basis, scns)
    want = ps.fused_solve(jcfg, *args, block_b=128, interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = tfs.fused_solve(tcfg, *(_t(x) for x in args))
    agree, rel = tfs.lane_agreement(want, got)
    print(f"lane agreement {agree:.4f}, alpha rel err on agreeing lanes "
          f"{rel:.3g}")
    assert agree >= tfs.LANE_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    assert abs(float(got.fulfilled.mean()) - float(want.fulfilled.mean())) <= 0.02
    wl, gl = float(want.final_loss.mean()), float(got.final_loss.mean())
    print(f"mean final loss {gl:.6f} against {wl:.6f}")
    assert abs(gl - wl) <= 0.01 * abs(wl), (gl, wl)
    assert np.isfinite(got.alpha.numpy()).all()


def test_wrapper_runs_plain_version_on_cpu(setup):
    jcfg, tcfg, basis, scns = setup
    args = [_t(x) for x in _kernel_args(
        jcfg, basis, jax.tree_util.tree_map(lambda x: x[:4], scns))]
    before = tfs.fused_solve.launches
    got = tfs.fused_solve(tcfg, *args)
    ref = tfs.fused_solve_reference(tcfg, *args)
    assert tfs.fused_solve.launches == before == 0
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert got.alpha.shape == (3, 50, 4)
    for f in got[1:]:
        assert f.shape == (1, 4) and f.dtype == torch.float32


@pytest.mark.parametrize("kw", [
    # The reference admits the bf16 tier under the exact ladder and then
    # compiles the unquantised kernel on a bf16-sized plan; the port refuses
    # the bf16 tier under either ladder.
    dict(ladder_eval="exact", bls_bf16_ladder=True),
    dict(matmul_precision="default"),
    dict(bls_bf16_ladder=True), dict(exact_constraint_eval=False),
])
def test_wrapper_rejects_modes_not_ported(setup, kw):
    jcfg, tcfg, basis, scns = setup
    args = [_t(x) for x in _kernel_args(
        jcfg, basis, jax.tree_util.tree_map(lambda x: x[:2], scns))]
    with pytest.raises(NotImplementedError):
        tfs.fused_solve(tcfg.replace(**kw), *args)


def test_wrapper_checks_shapes(setup):
    jcfg, tcfg, basis, scns = setup
    args = [_t(x) for x in _kernel_args(
        jcfg, basis, jax.tree_util.tree_map(lambda x: x[:2], scns))]
    args[4] = args[4][:, :1]
    with pytest.raises(ValueError, match="float32"):
        tfs.fused_solve(tcfg, *args)

