"""The basis products in XLA's CPU order (models/xla_order.py) against the
JAX package's products jitted on the CPU, bit for bit, and the
single-scene engines that use them against JAX's single-scene solves.

XLA's CPU code rounds a product with a basis matrix (K >= 4) in a runtime
dot of four fused multiply-add chains, and the product with the J x J
mixing matrix in an inlined loop whose columns it fuses differently; the
port's ``order="xla"`` reproduces both, so its single-scene BLS and GD
give the reference's goldens bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.models import rkhs as jrkhs
from irm_motion_planning_tpu.ops import costs as jcosts

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.models import lanes, xla_order
from irm_motion_planning_tpu_torch.models import rkhs as trkhs
from irm_motion_planning_tpu_torch.ops import costs as tcosts
from irm_motion_planning_tpu_torch.solvers import bls, gd
from replica_host import skip_unless_host

HIGHEST = jax.lax.Precision.HIGHEST
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


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


@pytest.mark.parametrize("M,K,J", [
    (100, 50, 3), (50, 50, 3), (400, 200, 3), (50, 25, 3), (100, 49, 3),
    (100, 51, 3), (100, 53, 5), (200, 100, 7)])
def test_basis_product_is_xla_dot(M, K, J):
    """basis_product against ``jnp.matmul(m, x, precision=HIGHEST)``
    jitted on the CPU, 16 random lanes of O(1e3) coefficients, every
    remainder of K mod 4: bit for bit, and each lane its own bits."""
    rng = np.random.default_rng(M + K + J)
    m = rng.standard_normal((M, K)).astype(np.float32)
    x = (rng.standard_normal((16, K, J)) * 1e3).astype(np.float32)
    dot = jax.jit(lambda a, b: jnp.matmul(a, b, precision=HIGHEST))
    want = np.stack([np.asarray(dot(m, xi)) for xi in x])
    got = xla_order.basis_product(_t(m), _t(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(xla_order.basis_product(_t(m), _t(x[5]))), _bits(want[5]))


@pytest.mark.parametrize("M,J", [
    (100, 3), (50, 3), (400, 3), (100, 1), (100, 2), (50, 5), (100, 5),
    (60, 4), (100, 7)] + [(M, J) for J in (7, 9, 11, 12, 13, 14, 16, 32)
                          for M in (50, 400)] + [
    (100, 9), (200, 13), (51, 17), (100, 32), (200, 32), (64, 49),
    (100, 256)])
def test_mix_product_is_xla_dot(M, J):
    """mix_product against the product with a constant J x J matrix jitted
    on the CPU (the mixing matrix is a constant in JAX's solve): bit for
    bit, at the M of the single-scene engines at T = 50 and 200 (M = T, 2T)
    for the arms J = 7-32, each order of xla_order.mix_chains (one chain,
    two and four partial sums) and its M = 50/51 edge.  Measured at J = 3
    for M >= 32 (and 16-19, 24-27): below, XLA's loop takes other shapes
    and the rule does not hold (M = 8-15, 20-23, 28-31; no committed
    export has such a T)."""
    rng = np.random.default_rng(M * J)
    mix = (np.eye(J) + 0.15 * rng.standard_normal((J, J))).astype(np.float32)
    const = jnp.asarray(mix)
    dot = jax.jit(lambda a: jnp.matmul(a, const, precision=HIGHEST))
    a = (rng.standard_normal((16, M, J)) * 30).astype(np.float32)
    want = np.stack([np.asarray(dot(ai)) for ai in a])
    got = xla_order.mix_product(_t(a), _t(mix))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module")
def warm():
    """JAX's basis and 8 random scenes' warm starts (O(1e3-1e4))."""
    cfg = mp.PlannerConfig()
    jb = mp.make_basis(cfg)
    scns = mp.random_scenarios(cfg, jax.random.PRNGKey(2), 8)
    init = jax.jit(lambda s, g: mp.init_alpha(cfg, jb, s, g))
    a0 = np.stack([np.asarray(init(s, g))
                   for s, g in zip(scns.start, scns.goal)])
    return cfg, jb, scns, a0, mt.make_basis(mt.PlannerConfig(), device="cpu")


def test_evaluate_and_pull_back_are_jax_bit_for_bit(warm):
    """evaluate, evaluate_position and the gradient's pull-back under
    ``order="xla"`` against JAX's jitted functions at the warm starts:
    bit for bit (``"matmul"`` parts from them there)."""
    cfg, jb, _, a0, tb = warm
    tcfg = mt.PlannerConfig()
    ev = jax.jit(lambda a: jrkhs.evaluate(cfg, jb, a))
    pos = jax.jit(lambda a: jrkhs.evaluate_position(cfg, jb, a))
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2,) + a0.shape).astype(np.float32)
    pull = jax.jit(lambda p, v: jcosts._chain_to_alpha(cfg, jb, p, v))
    for i in range(a0.shape[0]):
        want = ev(a0[i])
        got = mt.evaluate(tcfg, tb, _t(a0[i]), "xla")
        for w, x in zip(want, got):
            np.testing.assert_array_equal(_bits(x), _bits(w))
        np.testing.assert_array_equal(
            _bits(trkhs.evaluate_position(tcfg, tb, _t(a0[i]), "xla")),
            _bits(pos(a0[i])))
        np.testing.assert_array_equal(
            _bits(tcosts._chain_to_alpha(tcfg, tb, _t(g[0, i]), _t(g[1, i]),
                                         "xla")),
            _bits(pull(g[0, i], g[1, i])))
    batch = mt.evaluate(tcfg, tb, _t(a0), "xla")[0]
    np.testing.assert_array_equal(_bits(batch[3]), _bits(ev(a0[3])[0]))
    assert not torch.equal(mt.evaluate(tcfg, tb, _t(a0), "matmul")[0], batch)


def test_matmul_order_is_the_torch_product(warm):
    """``order="matmul"`` (the default of the cost functions) is one torch
    product per lane, as before the XLA order existed."""
    _, _, _, a0, tb = warm
    tcfg = mt.PlannerConfig()
    both = lanes.lane_matmul(lanes.basis_matmul(tb.kv, _t(a0)), tb.mix)
    traj, vel = mt.evaluate(tcfg, tb, _t(a0))
    assert torch.equal(traj, both[:, :50]) and torch.equal(vel, both[:, 50:])


@pytest.mark.parametrize("name", ["bls", "gd"])
def test_single_scene_solve_gives_the_golden(name):
    """The reference's flagship runs (sequential BLS, GD; the default
    config) on the reference scene: the trajectory is
    tests/goldens/{name}_default.txt bit for bit (as float32), as the JAX
    package's is (tests/test_parity.py)."""
    cfg = mt.PlannerConfig(bls_mode="sequential")
    basis = mt.make_basis(cfg, device="cpu")
    scn = mt.reference_scenario(cfg, device="cpu")
    res = {"bls": bls, "gd": gd}[name].solve(cfg, basis, scn)
    traj = mt.evaluate(cfg, basis, res.alpha, "xla")[0].numpy()
    golden = np.loadtxt(os.path.join(GOLDEN_DIR, f"{name}_default.txt"))
    np.testing.assert_array_equal(_bits(traj), _bits(golden))


# The interpreted fused kernel's arithmetic (models/xla_order.py, the pieces
# of tools/carry_replica.py), each against JAX's CPU bits.


def _interp_recip_kernel(newton):
    """pallas_step._Body.recip in a kernel run by Pallas's interpreter."""
    from jax.experimental import pallas as pl
    from irm_motion_planning_tpu.ops import pallas_step as ps

    jcfg = mp.PlannerConfig(recip_newton=newton)
    body = ps._Body(jcfg, 8, 3, 1, 128)

    def kernel(s_ref, out_ref):
        out_ref[:] = body.recip(s_ref[:])

    return lambda s: np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(s.shape, jnp.float32),
        interpret=True)(s))


@pytest.mark.parametrize("newton", [False, True])
def test_interp_recip_is_the_interpreters(newton):
    """xla_order.interp_recip against the JAX kernel's reciprocal in the
    Pallas interpreter (pl.reciprocal(approx=True), with and without the
    Newton step): bit for bit on every input, 65,536 arguments over the
    obstacle field's range (s >= 0.5) and beyond.  Correctly rounded on few
    of them (measured 6.4% with the step)."""
    rng = np.random.default_rng(11)
    s = np.exp(rng.uniform(np.log(0.3), np.log(300.0), (512, 128))
               ).astype(np.float32)
    want = _interp_recip_kernel(newton)(s)
    got = xla_order.interp_recip(_t(s), newton)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    exact = _bits((1.0 / s.astype(np.float64)).astype(np.float32))
    assert (exact == _bits(want)).mean() < 0.1


def test_sin_cos_are_xlas():
    """xla_order.sin/cos against jnp.sin/cos jitted on the CPU (glibc's
    sinf/cosf): bit for bit on 300,000 arguments over |x| < 120 and at the
    branch points (|x| near 2^-12, 0.75 and multiples of pi/2).  torch's
    own differ on about 5% of them.  Skipped on a host whose libm is not
    glibc's (tests/replica_host.py)."""
    skip_unless_host("sincos")
    rng = np.random.default_rng(12)
    edges = np.concatenate([
        np.float32(2.0 ** -12) * np.float32([0.999, 1.0, 1.001]),
        np.float32([0.7499999, 0.75, 0.7500001]),
        (np.arange(1, 70) * (np.pi / 2)).astype(np.float32)])
    x = np.concatenate([rng.uniform(-12, 12, 200000),
                        rng.uniform(-119.9, 119.9, 100000),
                        edges, -edges]).astype(np.float32)
    for jf, tf, torch_f in ((jnp.sin, xla_order.sin, torch.sin),
                            (jnp.cos, xla_order.cos, torch.cos)):
        want = _bits(jax.jit(jf)(x))
        np.testing.assert_array_equal(_bits(tf(_t(x))), want)
        assert (_bits(torch_f(_t(x))) == want).mean() < 0.97
    with pytest.raises(ValueError):
        xla_order.sin(torch.tensor([xla_order.SINCOS_MAX]))


def test_rsqrt_is_xlas():
    """xla_order.rsqrt against jax.lax.rsqrt jitted on the CPU (the
    hardware estimate and two Newton steps): bit for bit on 400,000
    positive normal arguments over 2^-60 to 2^60; ``1 / sqrt`` in float32
    (the port's) agrees on fewer than 80% of them.  Skipped on a CPU whose
    estimate is not the one written out (tests/replica_host.py)."""
    skip_unless_host("rsqrt")
    rng = np.random.default_rng(13)
    x = np.exp(rng.uniform(-41, 41, 400000)).astype(np.float32)
    want = _bits(jax.jit(jax.lax.rsqrt)(x))
    np.testing.assert_array_equal(_bits(xla_order.rsqrt(_t(x))), want)
    assert (_bits(1.0 / torch.sqrt(_t(x))) == want).mean() < 0.8


@pytest.mark.parametrize("T,lanes", [
    (200, 64), (400, 64), (200, 16), (33, 64), (32, 8), (1025, 64),
    (2200, 64)])
def test_tree_sum_is_xlas_reduction(T, lanes):
    """xla_order.tree_sum against ``jnp.sum(x, axis=0)`` jitted on the CPU
    (XLA's tree of windows of 32 rows): bit for bit on the kernel's (T,
    lanes) and (2T, lanes) planes and across the window sizes."""
    rng = np.random.default_rng(T + lanes)
    x = (rng.standard_normal((T, lanes))
         * np.exp(rng.uniform(-5, 5, (T, lanes)))).astype(np.float32)
    want = jax.jit(lambda a: jnp.sum(a, axis=0))(x)
    np.testing.assert_array_equal(_bits(xla_order.tree_sum(_t(x))),
                                  _bits(want))


@pytest.mark.parametrize("M,K,N", [
    (200, 400, 64), (400, 200, 64), (200, 400, 128), (400, 200, 16),
    (200, 400, 16)])
def test_lane_product_is_xlas_dot(M, K, N):
    """xla_order.lane_product against ``jnp.dot(m, x, precision=HIGHEST)``
    jitted on the CPU at the fused kernel's shapes at T = 200: the
    pull-back (T x 2T) @ (2T x lanes) and the forward (2T x T) @ (T x
    lanes), in tiles of 64 and 128 lanes (one FMA chain) and 16 (four
    chains): bit for bit, three joints' planes at once; other widths are
    refused."""
    rng = np.random.default_rng(M + K + N)
    m = rng.standard_normal((M, K)).astype(np.float32)
    x = (rng.standard_normal((3, K, N)) * 1e3).astype(np.float32)
    dot = jax.jit(lambda a, b: jnp.dot(a, b, precision=HIGHEST))
    want = np.stack([np.asarray(dot(m, xi)) for xi in x])
    np.testing.assert_array_equal(
        _bits(xla_order.lane_product(_t(m), _t(x))), _bits(want))
    with pytest.raises(ValueError):
        xla_order.lane_product(_t(m), torch.zeros(K, 96))


def test_exp_is_xlas():
    """xla_order.exp against jnp.exp jitted on the CPU (Cephes' polynomial
    with fused multiply-adds, the subnormals flushed): bit for bit on
    400,000 arguments over [-300, 88], where a correctly rounded exp
    agrees on about 91% of them; the basis build's Gram matrices take it
    (tests/test_torch_basis_build.py)."""
    rng = np.random.default_rng(14)
    x = np.concatenate([rng.uniform(-87, 88, 200000),
                        rng.uniform(-2, 0, 150000),
                        rng.uniform(-300, -87, 50000)]).astype(np.float32)
    want = _bits(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(_bits(xla_order.exp(_t(x))), want)
    exact = _bits(np.exp(x.astype(np.float64)).astype(np.float32))
    assert (exact == want).mean() < 0.95
