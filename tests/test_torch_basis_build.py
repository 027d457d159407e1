"""The port's own basis build against the JAX package's make_basis.

``build_basis`` (irm_motion_planning_tpu_torch/models/rkhs.py) builds the
RKHS basis of any config op for op as irm_motion_planning_tpu/models/rkhs.py
does, in float32, with XLA's exp (models/xla_order.py), ``mix`` drawn by a
numpy port of JAX's PRNG (models/threefry.py) and ``mix_inv`` and the
warm-start coefficients solved as ``jnp.linalg.solve`` solves them
(getrf's factors, OpenBLAS strsm's order).  Held here: the PRNG's bits,
uniform and normal against ``jax.random``; every field against JAX's basis
at T = 25, 50, 72, 300, 2,200 and J = 2, 3, 5, bit for bit; the build at
an exported config against the export; the warm start's fit of the line
against JAX's own; the digest that chip_smoke.py holds the card machine's
build to; and the ``xla`` engine on the built basis against the export.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch import bench
from irm_motion_planning_tpu_torch.models import rkhs, threefry
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

# The arms of the tests: JAX's own 5-link test arm (tests/test_basis.py).
ARMS = {2: (1.5, 1.0), 3: (1.5, 1.0, 0.5), 5: (1.0, 0.8, 0.6, 0.4, 0.2),
        7: (1.0, 0.9, 0.8, 0.6, 0.4, 0.3, 0.2)}

# The normal of threefry.normal against jax.random.normal, J = 1-8 and
# seeds 0-3 (816 values): 7 differ, by at most 2 ulps (XLA's float32 log1p
# against the correctly rounded one under erfinv's polynomial).
NORMAL_ULPS = 2
NORMAL_DIFFER_MAX = 10
# sha256 of build_basis at T = 72, J = 5 (the nine fields' float32 bytes in
# Basis order); chip_smoke.py holds the card machine's build to the same.
DIGEST_T72_J5 = (
    "cf7fdf550bd39d52d120b69c3e83263b818721d7c288f0e1abf29705516f754b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ulps(a, b) -> int:
    """Largest distance in units of the last place between two float32
    arrays (on the ordered integer line, so across zero too)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max())


def configs(T, J, **kw):
    return (mp.PlannerConfig(n_timesteps=T, n_joints=J, link_length=ARMS[J],
                             **kw),
            mt.PlannerConfig(n_timesteps=T, n_joints=J, link_length=ARMS[J],
                             **kw))


def digest(basis) -> str:
    h = hashlib.sha256()
    for x in basis:
        h.update(np.ascontiguousarray(x.cpu().numpy(), np.float32).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# JAX's PRNG.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_threefry_matches_jax_random(seed):
    """The key, the threefry bits and the uniform on (-1, 1) equal JAX's
    bit for bit at J = 1-8; the normal too, but for a few values within
    NORMAL_ULPS."""
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(key)) == threefry.key(seed)
    lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
    differ = 0
    for J in range(1, 9):
        shape = (J, J)
        np.testing.assert_array_equal(
            threefry.random_bits(threefry.key(seed), shape),
            np.asarray(jax.random.bits(key, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            threefry.uniform(threefry.key(seed), shape, lo, 1.0),
            np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0)))
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = threefry.normal(seed, shape)
        assert ulps(got, want) <= NORMAL_ULPS
        differ += int((got != want).sum())
    assert differ <= NORMAL_DIFFER_MAX


# --------------------------------------------------------------------------
# The built basis against JAX's.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T,J", [
    (T, J) for T in (25, 50, 72, 300) for J in (2, 3, 5)] + [(2200, 3)])
def test_build_basis_matches_jax(T, J):
    """Field by field, bit for bit JAX's: km by XLA's exp, and mix_inv and
    init_u/init_w, the solution of a ~1e15-conditioned system that any
    other exp or LU moves by O(1), by getrf and OpenBLAS strsm's order."""
    jcfg, tcfg = configs(T, J)
    ref = mp.make_basis(jcfg)
    got = rkhs.build_basis(tcfg, device="cpu")
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for x in got:
        assert x.dtype == torch.float32 and torch.isfinite(x).all()


@pytest.mark.parametrize("T", [25, 50, 100, 150, 200])
def test_build_basis_at_an_export(T):
    """At an exported config make_basis loads the export (JAX's bits) and
    build_basis gives every field bit for bit the export's."""
    cfg = mt.PlannerConfig(n_timesteps=T)
    export = mt.make_basis(cfg, device="cpu")
    jax_basis = mp.make_basis(mp.PlannerConfig(n_timesteps=T))
    for name in export._fields:
        np.testing.assert_array_equal(getattr(export, name).numpy(),
                                      np.asarray(getattr(jax_basis, name)))
    built = rkhs.build_basis(cfg, device="cpu")
    for name in export._fields:
        assert torch.equal(getattr(built, name), getattr(export, name)), name


def _line_fit(b, start, goal) -> float:
    """Largest distance of the warm start's trajectory (fleet_init_alpha's
    coefficients, float32, evaluated in float64) from the smoothstep line."""
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    mi = np.asarray(b.mix_inv, np.float32)
    sm = (start @ mi).astype(np.float32)
    dm = ((goal - start) @ mi).astype(np.float32)
    u, w = np.asarray(b.init_u), np.asarray(b.init_w)
    alpha = (u[:, None] * sm[None] + w[:, None] * dm[None]).astype(np.float32)
    traj = f64(b.km) @ f64(alpha) @ f64(b.mix)
    line = f64(start)[None] + f64(goal - start)[None] * f64(b.c)[:, None]
    return float(np.abs(traj - line).max())


FIT_TS = (25, 50, 72, 100, 150, 200, 300)
# The largest fit of the built basis over FIT_TS (JAX's largest 5.95e-3, at
# T = 200; 1.18e-2 at T = 150 with the port's earlier LU).
FIT_MAX = 2e-2


def test_built_warm_start_fits_the_line():
    """The warm start of the built basis fits the smoothstep line as JAX's
    does.  At ~1e15 conditioning the fit of a float32 LU is a draw: the same
    LU on JAX's own Gram matrix gives 4.8e-4 to 1.8e-2 at T = 50 with four
    op orders (the port's own pivot-by-pivot LU, before it solved as JAX
    does, fit 0.28-7.6x JAX's at FIT_TS).  The median over FIT_TS is held
    to 2x JAX's median, and every fit to FIT_MAX; the build is JAX's bits
    now (test_build_basis_matches_jax), so the two are equal."""
    rng = np.random.default_rng(0)
    scenes = [(rng.uniform(-1.0, 2.0, 3).astype(np.float32),
               rng.uniform(-1.0, 2.0, 3).astype(np.float32))
              for _ in range(8)]
    ours, theirs = [], []
    for T in FIT_TS:
        jb = mp.make_basis(mp.PlannerConfig(n_timesteps=T))
        tb = rkhs.build_basis(mt.PlannerConfig(n_timesteps=T), device="cpu")
        ours.append(max(_line_fit(tb, s, g) for s, g in scenes))
        theirs.append(max(_line_fit(jb, s, g) for s, g in scenes))
    print("line fit by T", dict(zip(FIT_TS, zip(ours, theirs))))
    assert np.median(ours) <= 2 * np.median(theirs)
    assert max(ours) <= FIT_MAX


def test_build_basis_digest_is_pinned():
    """One config, one basis: build_basis at (T = 72, J = 5) has the pinned
    digest on this machine, and chip_smoke.py holds the card machine's
    build to the same; a rebuild in the process is the same object's
    bits."""
    _, cfg = configs(72, 5)
    basis = rkhs.build_basis(cfg, device="cpu")
    assert digest(basis) == DIGEST_T72_J5
    assert digest(rkhs._build(cfg)) == DIGEST_T72_J5


def test_make_basis_builds_where_no_export_matches():
    """make_basis: the export where every field of BASIS_KEYS matches, the
    build elsewhere (another T, J, kernel width or mix draw)."""
    cfg = mt.PlannerConfig(n_timesteps=50)
    assert rkhs._export(cfg) is not None
    for other in (cfg.replace(n_timesteps=72),
                  cfg.replace(n_joints=5, link_length=ARMS[5]),
                  cfg.replace(rbf_variance=0.2), cfg.replace(mix_seed=1)):
        assert rkhs._export(other) is None
        got = mt.make_basis(other, device="cpu")
        want = rkhs.build_basis(other, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_xla_engine_on_the_built_basis():
    """At T = 50 the xla engine on the built basis solves 256 random
    scenes as it does on the export: the paired gate's converged band,
    phantom 0 and cost within 1% (the basis is the export's bits)."""
    cfg = bench.bench_config(inner=6).replace(max_outer_iteration=3)
    export = mt.make_basis(cfg, device="cpu")
    built = rkhs.build_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), 256,
                               device="cpu")
    ref = tfleet.fleet_solve(cfg, export, scns, backend="xla")
    res = tfleet.fleet_solve(cfg, built, scns, backend="xla")
    ref_conv = float(ref.stats.converged.float().mean())
    ref_cost = bench.mean_obstacle_cost(cfg, export, scns, ref)
    gate = bench.gate_against(cfg, built, scns, res, 256, ref_conv, ref_cost)
    print("built against export", gate["bands"])
    assert gate["fields"]["phantom_frac"] == 0.0
    assert gate["ok"], gate
