"""The port's plain linearized carry program in the arithmetic of the JAX
package's fused kernel as Pallas's interpreter runs it on the CPU
(tools/carry_replica.py) against that kernel, bit for bit.

The plain K1/K2 (fused_solve's plain versions, program ``bls``) round as
the CUDA kernels do.  JAX's fused kernel, interpreted, is compiled by XLA
into the CPU's arithmetic: the interpreter's approximate reciprocal and
its Newton step, glibc's sin and cos, the CPU's rsqrt estimate, XLA's tree
of sums over T, its runtime dot's order, the products it contracts into
fused multiply-adds.  With every one of those (``replica.ALL``) the port's
program is the kernel's lane by lane: no step of it computes anything
else.  So what parts the two programs' converged fractions at T = 200
(ROADMAP queue 3, fact 5) is the arithmetic, not the algorithm.

T = 200, 16 random scenes (seed 0), JAX's warm start and basis; the
kernel runs a tile of 16 lanes, so its dots take the four-chain order
(xla_order.lane_product); one torch thread.  The two tests that run the
kernel skip on a host whose rsqrt estimate or sinf/cosf are not the ones
xla_order writes out (tests/replica_host.py).
"""

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
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet
from replica_host import load_carry_replica, skip_unless_host

T = 200
B = 16
STEPS = (1, 2, 3, 5, 8)
replica = load_carry_replica()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def problem():
    """The bench's BLS config at T = 200 (JAX's with recip_newton, the
    interpreted kernel's tile of B lanes), JAX's basis, B random scenes,
    and the round's arguments: the kernel's in JAX's layout (JAX's warm
    start), the port's from them."""
    cfg = bench.bench_config(n_timesteps=T)
    jcfg = mp.PlannerConfig(
        n_timesteps=T, bls_mode="ladder", fixed_iters=True,
        inner_schedule=cfg.inner_schedule,
        max_inner_iteration=cfg.max_inner_iteration, max_obstacles=11,
        recip_newton=True, pallas_block_b=B)
    jb = mp.make_basis(jcfg)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), B,
                               device="cpu")
    fsc = jfleet.to_fleet(mp.Scenario(*(jnp.asarray(x.numpy())
                                        for x in scns)))
    a0 = jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, jb, fsc), 1, 0)
    ones = np.ones((1, B), np.float32)
    jargs = (jb.kv, jb.kv.T, jb.mix, a0,
             jcfg.lambda_sg_constraint * ones,
             jcfg.lambda_jl_constraint * ones, 0.0 * ones,
             jcfg.bls_lr_start * ones)
    lanes = (fsc.start, fsc.goal, fsc.obstacles[:, 0, :],
             fsc.obstacles[:, 1, :], fsc.obstacle_weight)
    return cfg, jcfg, scns, jargs, lanes, np.asarray(a0)


def _port_round(cfg, jargs, lanes, n_r, pieces):
    kv, kvt, mix, a0, lsg, ljl, ful, lr0 = map(_t, jargs)
    with replica.replica(pieces):
        return tfs.fused_round_reference(
            cfg, kv, kvt.contiguous(), mix, a0, lsg, ljl, ful, lr0, n_r,
            *map(_t, lanes))


def test_replica_round_is_the_interpreted_kernel(problem):
    """One penalty round of JAX's fused kernel (pallas_step.fused_round,
    interpreted, recip_newton) against the port's plain round in the
    replica's arithmetic, from the same warm start, after 1, 2, 3, 5 and 8
    inner steps: alpha, the loss, the constraint check and the step count
    of every lane bit for bit.  As shipped (no piece) the port parts from
    it at the first step on every lane."""
    skip_unless_host("rsqrt", "sincos")
    cfg, jcfg, _, jargs, lanes, _ = problem
    for n_r in STEPS:
        want = ps.fused_round(jcfg, *jargs, n_r, *lanes, solver="bls",
                              block_b=B, interpret=True)
        got = _port_round(cfg, jargs, lanes, n_r, replica.ALL)
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=(
                f"{name} after {n_r} steps"))
    shipped = _port_round(cfg, jargs, lanes, 1, ())
    want = ps.fused_round(jcfg, *jargs, 1, *lanes, solver="bls", block_b=B,
                          interpret=True)
    same = (_bits(shipped.alpha) == _bits(want.alpha)).all(axis=(0, 1))
    assert same.mean() < 0.5


def test_replica_warm_start_is_jaxs(problem):
    """The fleet's warm start in the replica (piece ``init``: ``start
    mix_inv`` as one chain of fused multiply-adds) is JAX's bit for bit;
    the port's own, torch's einsum on the lane-trailing scenes, is not."""
    cfg, _, scns, _, _, a0 = problem
    tb = mt.make_basis(cfg, device="cpu")
    with replica.replica(["init"]):
        got = tfleet.fused_args(cfg, tb, scns)[4]
    np.testing.assert_array_equal(_bits(got), _bits(a0))
    shipped = tfleet.fused_args(cfg, tb, scns)[4]
    assert (_bits(shipped) == _bits(a0)).mean() < 0.9


def test_replica_pieces_and_restore():
    """``parse`` reads a comma list (``all``, ``all-x``, ``none``); the
    context puts every helper back on exit, so the plain versions run as
    shipped again."""
    assert replica.parse("all") == replica.ALL
    assert replica.parse("all-recip") == tuple(
        p for p in replica.ALL if p != "recip")
    assert replica.parse("none") == ()
    assert replica.parse("recip,sincos,recip") == ("recip", "sincos")
    with pytest.raises(ValueError):
        replica.parse("sqrt")
    before = {n: getattr(tfs, n) for n in dir(tfs)}
    before_init = tfleet.fleet_init_alpha
    with replica.replica():
        assert tfs.recip is not before["recip"]
        assert tfleet.fleet_init_alpha is not before_init
    assert {n: getattr(tfs, n) for n in dir(tfs)} == before
    assert tfleet.fleet_init_alpha is before_init


def test_replica_solve_is_the_interpreted_kernel(problem):
    """The whole solve at the bench's schedule (ten rounds, 204 steps; JAX's
    pallas_step.fused_solve interpreted against the port's plain K1 in the
    replica's arithmetic, both from JAX's warm start): alpha, the final
    loss, the converged flags and the step counts of every lane bit for
    bit."""
    skip_unless_host("rsqrt", "sincos")
    cfg, jcfg, _, jargs, lanes, _ = problem
    kv, kvt, mix, a0, lsg, ljl = jargs[:6]
    want = ps.fused_solve(jcfg, kv, kvt, mix, a0, lsg, ljl, *lanes,
                          solver="bls", block_b=B, interpret=True)
    with replica.replica():
        got = tfs.fused_solve_reference(
            cfg, *map(_t, (kv, kvt, mix, a0, lsg, ljl)), *map(_t, lanes))
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
