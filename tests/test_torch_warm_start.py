"""The port's warm start (models/warm_start.py, ``rkhs.init_alpha``)
against the JAX package's, and the port's sequential oracle on JAX's
stored oracle scenes.

JAX's jitted ``init_alpha`` on the CPU is getrf's factors of ``km`` and
two strsm solves on a right-hand side XLA forms with fused multiply-adds;
the port writes the same arithmetic in plain tensor operations, so it
gives JAX's bits (here, and on the card: chip_smoke.py phase 22).  With
the basis products in XLA's order too (models/xla_order.py), the port's
sequential oracle reproduces JAX's stored oracle scene by scene.
"""

import numpy as np
import pytest
import scipy.linalg
import torch
from scipy.linalg import blas

import jax

import irm_motion_planning_tpu as mp

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.benchmarks import certify
from irm_motion_planning_tpu_torch.models import rkhs, warm_start, xla_order

ORACLE = "certify_oracle_cpu2048.npz"
ORACLE_SCENES = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.mark.parametrize("T", [25, 50, 100, 150, 200])
def test_export_holds_jax_lu_and_its_old_fields(T):
    """The committed export's ``lu``/``lu_perm`` are ``jax.lax.linalg.lu(
    km)`` bit for bit, and every Basis field is still JAX's basis bit for
    bit."""
    cfg = mp.PlannerConfig(n_timesteps=T)
    jb = mp.make_basis(cfg)
    lu, _, perm = jax.lax.linalg.lu(jb.km)
    with np.load(rkhs.export_path(mt.PlannerConfig(n_timesteps=T))) as data:
        np.testing.assert_array_equal(_bits(data["lu"]), _bits(lu))
        np.testing.assert_array_equal(data["lu_perm"], np.asarray(perm))
        for name in jb._fields:
            np.testing.assert_array_equal(
                _bits(data[name]), _bits(getattr(jb, name)), err_msg=name)


def test_built_basis_factors_are_getrf():
    """A config without an export: the warm start of a built basis solves
    with scipy's getrf of its km (the routine JAX's lu calls here), bit for
    bit scipy's and JAX's own factors of the same matrix."""
    cfg = mt.PlannerConfig(n_timesteps=30)
    assert rkhs._export(cfg) is None
    basis = mt.make_basis(cfg, device="cpu")
    km = basis.km.numpy()
    lu, perm = rkhs._LU[rkhs._key(cfg)]
    want, piv = scipy.linalg.lu_factor(km)
    np.testing.assert_array_equal(_bits(lu), _bits(want))
    jlu, jpiv, jperm = jax.lax.linalg.lu(km)
    np.testing.assert_array_equal(_bits(lu), _bits(jlu))
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    np.testing.assert_array_equal(piv, np.asarray(jpiv))


# The arms past the reference's three links whose warm start is held to
# JAX's bits, each J equal links of reach 3.0.  From J = 14 up the port's
# built mixing matrix is not JAX's (models/threefry.py's normal, a few
# ulps on some entries: test_built_mix_parts_from_jax_from_fourteen_links),
# so there the warm start is held with JAX's mix_inv in the port's basis.
ARMS = (7, 9, 11, 12, 13, 14, 16, 32)
JAX_MIX_FROM = 14


@pytest.mark.parametrize("T,n,J", [(50, 128, 3), (200, 32, 3)]
                         + [(T, 8, J) for J in ARMS for T in (50, 200)]
                         + [(20, 8, 3), (30, 8, 3), (30, 8, 7)])
def test_init_alpha_is_jax_bit_for_bit(T, n, J):
    """The port's init_alpha against JAX's jitted init_alpha on n random
    scenes: every bit equal (measured: all of them), as a batch, one
    scene, and with two leading axes.  At J = 3 and 7 the last joint's
    line is rounded apart on the vector loop's timesteps (4 wide at T =
    16-31, 8 from T = 32), fused at every other J (warm_start.line_fused);
    the product with mix_inv is one chain of fused multiply-adds at every
    J here."""
    arm = {} if J == 3 else dict(n_joints=J, link_length=(3.0 / J,) * J)
    jcfg = mp.PlannerConfig(n_timesteps=T, **arm)
    jb = mp.make_basis(jcfg)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(0), n)
    init = jax.jit(lambda s, g: mp.init_alpha(jcfg, jb, s, g))
    want = np.stack([np.asarray(init(s, g))
                     for s, g in zip(scns.start, scns.goal)])
    cfg = mt.PlannerConfig(n_timesteps=T, **arm)
    tb = mt.make_basis(cfg, device="cpu")
    if J >= JAX_MIX_FROM:
        tb = tb._replace(mix_inv=torch.tensor(np.asarray(jb.mix_inv)))
    start = torch.tensor(np.asarray(scns.start))
    goal = torch.tensor(np.asarray(scns.goal))
    got = mt.init_alpha(cfg, tb, start, goal)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(mt.init_alpha(cfg, tb, start[3], goal[3])), _bits(want[3]))
    two = mt.init_alpha(cfg, tb, start[:4].reshape(2, 2, -1),
                        goal[:4].reshape(2, 2, -1))
    assert two.shape == (2, 2, T, cfg.n_joints)
    np.testing.assert_array_equal(_bits(two.reshape(4, T, -1)),
                                  _bits(want[:4]))


@pytest.mark.parametrize("J", [13, 14, 16, 32])
def test_built_mix_parts_from_jax_from_fourteen_links(J):
    """The port's built mixing matrix (models/rkhs.py build_basis, its
    normal from models/threefry.py) against JAX's make_basis at T = 50: bit
    for bit up to J = 13 (measured at every J from 1), a few entries off
    from J = 14 up (measured: 1 of 196 at J = 14, 2 of 256 at J = 16, 6 of
    1,024 at J = 32), which moves most of mix_inv; the rest of the basis
    is JAX's.  The cause is the normal's log1p, correctly rounded here and
    XLA's own in JAX (threefry.py's docstring); ROADMAP queue 3 keeps it
    open."""
    arm = dict(n_joints=J, link_length=(3.0 / J,) * J)
    jb = mp.make_basis(mp.PlannerConfig(**arm))
    tb = mt.make_basis(mt.PlannerConfig(**arm), device="cpu")
    off = {name: int((_bits(getattr(tb, name))
                      != _bits(getattr(jb, name))).sum())
           for name in jb._fields}
    assert off.pop("mix") == {13: 0, 14: 1, 16: 2, 32: 6}[J]
    assert (off.pop("mix_inv") > 0) == (J >= JAX_MIX_FROM)
    assert off == dict.fromkeys(off, 0)


def test_init_alpha_calls_no_linear_algebra_library(monkeypatch):
    """No torch.linalg and no scipy solve: the warm start is plain tensor
    operations on the factors."""
    def refuse(*a, **k):
        raise AssertionError("a library solve was called")

    for name in ("solve", "solve_triangular", "lu_factor", "lu_solve",
                 "inv"):
        if hasattr(torch.linalg, name):
            monkeypatch.setattr(torch.linalg, name, refuse)
    monkeypatch.setattr(scipy.linalg, "lu_solve", refuse)
    monkeypatch.setattr(scipy.linalg, "solve_triangular", refuse)
    cfg = mt.PlannerConfig()
    tb = mt.make_basis(cfg, device="cpu")
    a = mt.init_alpha(cfg, tb, torch.zeros(3), torch.ones(3))
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("T", [50, 449, 1000])
def test_substitutions_are_strsm(T):
    """forward/backward against BLAS strsm (OpenBLAS, through scipy: the
    routine JAX's triangular solves call on the CPU), bit for bit, on
    random well-conditioned factors: one panel, and past the 448-row panel
    where the blocking changes."""
    rng = np.random.default_rng(T)
    lower = (np.tril(rng.standard_normal((T, T)), -1) * 0.1).astype(
        np.float32)
    upper = (np.triu(rng.standard_normal((T, T)), 1) * 0.05
             + np.diag(1.0 + rng.random(T))).astype(np.float32)
    b = rng.standard_normal((T, 3)).astype(np.float32)
    f = warm_start.factors_from_lu(lower + upper, np.arange(T), "cpu")
    y = warm_start.forward(f, torch.tensor(b)).numpy()
    want_y = blas.strsm(1.0, np.asfortranarray(lower + np.eye(T, dtype=np.float32)),
                        np.asfortranarray(b), side=0, lower=1, trans_a=0,
                        diag=1)
    np.testing.assert_array_equal(_bits(y), _bits(want_y))
    x = warm_start.backward(f, torch.tensor(b)).numpy()
    want_x = blas.strsm(1.0, np.asfortranarray(upper), np.asfortranarray(b),
                        side=0, lower=0, trans_a=0, diag=0)
    np.testing.assert_array_equal(_bits(x), _bits(want_x))


def test_fma_rounds_once_off_float32_midpoints():
    """xla_order.fma_ (the one multiply-add emulation of the warm start
    and the products) against exact rational arithmetic: random triples
    are rounded once, as a fused multiply-add rounds them; a sum that lands
    on a float32 midpoint in float64 without being exact is rounded twice
    (the documented case: 1 + 2^-22 where a fused multiply-add gives
    1 + 2^-23)."""
    from fractions import Fraction
    a = np.float32(3 * 2.0 ** -24 * (1 + 2.0 ** -18))
    b = np.float32(1 - 2.0 ** -18)
    acc = torch.tensor([1.0])
    xla_order.fma_(acc, torch.tensor([float(a)], dtype=torch.float64),
                   torch.tensor([b]))
    assert acc.item() == 1 + 2.0 ** -22
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(300).astype(np.float32)
               * np.float32(2.0) ** rng.integers(-20, 20, 300).astype(
                   np.float32) for _ in range(3))
    got = torch.tensor(c)
    xla_order.fma_(got, torch.tensor(a, dtype=torch.float64),
                   torch.tensor(b))
    got = got.numpy()
    for i in range(300):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        lo = np.float32(float(exact))
        # the float32 nearest the exact value, ties to even
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert got[i] == best, i


def test_port_oracle_on_jax_oracle_scenes():
    """The port's sequential oracle (certify.oracle_solve: bls.solve_batch,
    the products in XLA's order) on the first 128 scenes of JAX's stored
    CPU oracle, against the file's converged flags.  Measured: converged
    0.25, the file's 0.25, every scene's flag equal to JAX's; mean avg and
    max cost +0.0039% and -0.047% of the file's.  Asserted: within
    certify.py's CONV_SLACK and the mean costs within 0.1%."""
    data = dict(np.load(ORACLE))
    for k in certify.SCENE_KEYS:
        data[k] = data[k][:ORACLE_SCENES]
    cfg = certify.oracle_config(int(data["max_obstacles"]),
                                str(data["stopping"]))
    basis = mt.make_basis(cfg, device="cpu")
    avg, mx, conv = certify.oracle_solve(cfg, basis,
                                         certify.oracle_scenes(data, "cpu"))
    ref = data["conv"][:ORACLE_SCENES]
    rel_avg = avg.mean() / data["avg"][:ORACLE_SCENES].mean() - 1
    rel_max = mx.mean() / data["max"][:ORACLE_SCENES].mean() - 1
    print(f"port oracle on {ORACLE_SCENES} of {ORACLE}: converged "
          f"{conv.mean():.4f} (JAX {ref.mean():.4f}), flags agree "
          f"{(conv == ref).mean():.4f}, mean avg {rel_avg:+.3e}, mean max "
          f"{rel_max:+.3e}")
    assert np.isfinite(avg).all() and np.isfinite(mx).all()
    assert abs(conv.mean() - ref.mean()) <= certify.CONV_SLACK
    assert abs(rel_avg) <= 1e-3 and abs(rel_max) <= 1e-3
