"""The port at joint counts other than the reference arm's three.

The kernels take J at compile time (one library per J, ops/_build.py); on
the CPU the same wrappers run their plain versions, which are held here to
the JAX package's Pallas kernels run interpreted (``interpret=True``,
``recip_newton=True``, as tests/test_torch_fused_solve.py runs them) at J =
2, 5 and 7: JAX's own 5-link test arm (tests/test_basis.py) and a 2- and a
7-link arm, at T = 30 (the resident plan) and T = 72 (the streamed plan),
with short schedules (2 rounds x 6 steps).  JAX's basis crosses as numpy.
Also here: the launch plan's pieces against the layout formula at each J,
the parameter block's ctypes mirror against lane_body.cuh at each J, and
the ``xla`` fallback where no plan fits.
"""

import ctypes
import functools
import os
import re
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
from irm_motion_planning_tpu_torch import bench
from irm_motion_planning_tpu_torch.ops import _build
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet
from irm_motion_planning_tpu_torch.solvers.common import SolveResult

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "irm_motion_planning_tpu_torch", "csrc")
ARMS = {2: (1.5, 1.0), 5: (1.0, 0.8, 0.6, 0.4, 0.2),
        7: (1.0, 0.9, 0.8, 0.6, 0.4, 0.3, 0.2)}
SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11)
T30, T72 = 30, 72
B = 64
# K1/K2's lane agreement with JAX's kernels: the thresholds of
# tests/test_torch_fused_solve.py (BLS) and test_torch_fused_gd.py (GD).
AGREEMENT_MIN = {"bls": tfs.LANE_AGREEMENT_MIN, "gd": 0.80}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.tensor(np.asarray(x))


def _configs(J, T, **kw):
    kw = {**SHORT, "n_timesteps": T, "n_joints": J, "link_length": ARMS[J],
          **kw}
    return mp.PlannerConfig(recip_newton=True, **kw), mt.PlannerConfig(**kw)


@functools.lru_cache(maxsize=None)
def _inputs(J, T, n, seed=9):
    """JAX's basis and n random scenes at (J, T); the kernels' inputs at the
    warm start, a moderate numpy-seeded alpha (no warm-start cancellation
    in the products, the joint-limit masks live) with JAX's evaluation of
    it, a quarter of the lanes frozen, mixed learning rates; all numpy."""
    jcfg, tcfg = _configs(J, T)
    jb = mp.make_basis(jcfg)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(seed), n)
    fs = jfleet.to_fleet(scns)
    a0 = np.asarray(jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, jb, fs), 1, 0))
    rng = np.random.default_rng(3)
    esc = rng.choice(np.array([1.0, 10.0, 100.0], np.float32), (1, n))
    lsg = (np.float32(jcfg.lambda_sg_constraint) * esc).astype(np.float32)
    ljl = (np.float32(jcfg.lambda_jl_constraint) * esc).astype(np.float32)
    basis = [np.asarray(x) for x in (jb.kv, jb.kv.T, jb.mix)]
    lanes = [np.asarray(x) for x in (fs.start, fs.goal, fs.obstacles[:, 0, :],
                                     fs.obstacles[:, 1, :], fs.obstacle_weight)]
    alpha = np.random.default_rng(4).normal(0, 0.15, (J, T, n)).astype(
        np.float32)
    return dict(
        J=J, T=T, jcfg=jcfg, tcfg=tcfg, jb=jb, scns=scns, basis=basis, a0=a0,
        lsg=lsg, ljl=ljl, lanes=lanes, alpha=alpha,
        frozen=(rng.random((1, n)) < 0.25).astype(np.float32),
        bls_lr=rng.choice(np.array([0.2, 0.1, 0.05, 0.3], np.float32), (1, n)),
        gd_lr=rng.choice(np.array(jcfg.gd_lr[:2], np.float32), (1, n)))


@pytest.fixture(scope="module", params=sorted(ARMS))
def arm(request):
    return _inputs(request.param, T30, B)


@pytest.fixture(scope="module")
def arm72():
    return _inputs(5, T72, 16, seed=5)


def _eval(d, stream_rb=0):
    key = ("eval", stream_rb)
    if key not in d:
        d[key] = _jax_eval(d, stream_rb)
    return d[key]


def _jax_eval(d, stream_rb):
    kw = dict(stream_rb=stream_rb) if stream_rb else {}
    ev = ps.cost_grad_eval(d["jcfg"], *d["basis"], d["alpha"], d["lsg"],
                           d["ljl"], *d["lanes"], block_b=d["alpha"].shape[-1],
                           interpret=True, **kw)
    return [np.asarray(x) for x in ev]


# --------------------------------------------------------------------------
# K5, K6 and one K3/K4 step against JAX's, element by element.
# --------------------------------------------------------------------------

# Measured at J = 2, 5, 7 (T = 30) and 5, 7 (T = 72), the largest: K6
# traj 1.2e-7, vel 9.5e-7; K5 loss 2.9e-6 relative, traj 3.6e-7, vel
# 1.9e-6, grad 2.4e-4 absolute at T = 30 on values up to 2.2e3 and 4.9e-4
# at T = 72 on values up to 3.6e3 (the largest beyond 1e-4 + 2e-6 |grad|:
# 2.1e-4 on a value of 51 at T = 72).
EVAL_BOUNDS = dict(traj=1e-6, vel=1e-5, loss=2e-5)
GRAD_RTOL, GRAD_ATOL, GRAD_ATOL_72 = 2e-6, 1e-4, 5e-4


def test_forward_eval_matches_jax(arm):
    """K6's plain version against pallas_step.forward_eval at the moderate
    alpha, element by element."""
    d = arm
    kv, _, mix = d["basis"]
    want = ps.forward_eval(d["jcfg"], kv, mix, d["alpha"], block_b=B,
                           interpret=True)
    got = sk.forward_eval(d["tcfg"], _t(kv), _t(mix), _t(d["alpha"]))
    assert got.traj.shape == (d["J"], T30, B)
    np.testing.assert_allclose(got.traj.numpy(), np.asarray(want.traj),
                               rtol=0, atol=EVAL_BOUNDS["traj"])
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               rtol=0, atol=EVAL_BOUNDS["vel"])


def test_cost_grad_eval_matches_jax(arm):
    """K5's plain version against pallas_step.cost_grad_eval at the moderate
    alpha with penalties x1/x10/x100, element by element."""
    d = arm
    want = _eval(d)
    got = sk.cost_grad_eval(d["tcfg"], *map(_t, d["basis"]), _t(d["alpha"]),
                            _t(d["lsg"]), _t(d["ljl"]), *map(_t, d["lanes"]))
    loss, grad, traj, vel = (x.numpy() for x in got)
    np.testing.assert_allclose(loss, want[0], rtol=EVAL_BOUNDS["loss"])
    np.testing.assert_allclose(grad, want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(traj, want[2], rtol=0,
                               atol=EVAL_BOUNDS["traj"])
    np.testing.assert_allclose(vel, want[3], rtol=0, atol=EVAL_BOUNDS["vel"])


# One step: the share of the live lanes' alpha coefficients equal to JAX's
# to float32 resolution (within one epsilon of the lane's largest |alpha|),
# and alpha's largest difference relative to that scale.  Measured over J =
# 2, 5, 7 at T = 30 and 72: 0.9995-1.0 equal, 1.2e-7 at most; bit for bit,
# GD 1.0 of the coefficients (its accepted trial rounds once on both
# sides), the exact ladder 0.95-0.97, the linearized 0.71-0.72 (the
# normalized direction's ulps; 0.98-0.99 within 1 ulp).
STEP_EQUAL_MIN = 0.99
STEP_ALPHA_REL = 1e-6


def _one_step(d, program, stream_rb=0):
    exact = program == "bls_exact"
    jcfg = d["jcfg"].replace(ladder_eval="exact") if exact else d["jcfg"]
    tcfg = d["tcfg"].replace(ladder_eval="exact") if exact else d["tcfg"]
    gd = program == "gd"
    lr = d["gd_lr"] if gd else d["bls_lr"]
    loss, grad, traj, vel = _eval(d, stream_rb)
    ins = (d["alpha"], grad, traj, vel, loss, lr, d["frozen"])
    fn = ps.gd_inner_step if gd else ps.bls_inner_step
    kw = dict(stream_rb=stream_rb) if stream_rb else {}
    want = fn(jcfg, *d["basis"], *ins, d["lsg"], d["ljl"], *d["lanes"],
              block_b=d["alpha"].shape[-1], interpret=True, **kw)
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
    diff = (np.abs(got[0] - want[0]) / scale)[..., live]
    equal = float((diff <= np.finfo(np.float32).eps).mean())
    bitwise = float((got[0][..., live] == want[0][..., live]).mean())
    print(f"J={d['J']} T={d['T']} {program}: alpha equal {equal:.4f} "
          f"(bitwise {bitwise:.4f}), rel {diff.max():.3g}")
    assert equal >= STEP_EQUAL_MIN
    assert diff.max() <= STEP_ALPHA_REL
    if program == "gd":
        assert bitwise == 1.0


@pytest.mark.parametrize("program", ["bls", "gd"])
def test_one_step_matches_jax(arm, program):
    """One K3 step (the linearized ladder) or K4 step, plain version against
    pallas_step.bls_inner_step / gd_inner_step from JAX's evaluation of the
    moderate alpha, a quarter of the lanes frozen: frozen lanes pass through
    bit for bit on both sides, lr and the stop flags are equal on every
    lane, and STEP_EQUAL_MIN of the live lanes' coefficients are equal to
    float32 resolution (GD's bit for bit)."""
    _one_step(arm, program)


def test_exact_step_matches_jax():
    """One K3 step of the exact ladder on JAX's 5-link arm, as above."""
    _one_step(_inputs(5, T30, B), "bls_exact")


def test_streamed_eval_and_step_match_jax(arm72):
    """At T = 72, the streamed plan's T (JAX's kernels stream the basis in
    24- and 16-row blocks), on JAX's 5-link arm: K5 element by element and
    one K3 step, as above."""
    d = arm72
    want = _eval(d, stream_rb=24)
    got = sk.cost_grad_eval(d["tcfg"], *map(_t, d["basis"]), _t(d["alpha"]),
                            _t(d["lsg"]), _t(d["ljl"]), *map(_t, d["lanes"]))
    np.testing.assert_allclose(got.loss.numpy(), want[0],
                               rtol=EVAL_BOUNDS["loss"])
    np.testing.assert_allclose(got.grad.numpy(), want[1], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_72)
    np.testing.assert_allclose(got.vel.numpy(), want[3], rtol=0,
                               atol=EVAL_BOUNDS["vel"])
    assert tfs.launch_plan(d["tcfg"], 11)["plan"] == "streamed"
    _one_step(d, "bls", stream_rb=16)


# --------------------------------------------------------------------------
# K1 and K2 against JAX's, by lane agreement.
# --------------------------------------------------------------------------


def _kernel_args(d):
    n = d["a0"].shape[-1]
    return (*d["basis"], d["a0"],
            np.full((1, n), d["jcfg"].lambda_sg_constraint, np.float32),
            np.full((1, n), d["jcfg"].lambda_jl_constraint, np.float32),
            *d["lanes"])


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_short_solve_matches_jax(arm, solver):
    """K1's plain version against pallas_step.fused_solve (interpret) at 2
    rounds x 6 steps: lane agreement AGREEMENT_MIN[solver], alpha within
    ALPHA_REL_MAX of the lane's scale on the agreeing lanes, mean final
    loss within 1%."""
    d = arm
    args = _kernel_args(d)
    want = ps.fused_solve(d["jcfg"], *args, solver=solver, block_b=B,
                          interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = tfs.fused_solve(d["tcfg"], *map(_t, args), solver=solver)
    agree, rel = tfs.lane_agreement(want, got)
    wl, gl = float(want.final_loss.mean()), float(got.final_loss.mean())
    print(f"J={d['J']} K1-{solver}: agreement {agree:.4f}, alpha rel "
          f"{rel:.3g}; loss {gl:.6f} against {wl:.6f}")
    assert agree >= AGREEMENT_MIN[solver]
    assert rel <= tfs.ALPHA_REL_MAX
    assert abs(gl - wl) <= 0.01 * abs(wl)
    assert np.isfinite(got.alpha.numpy()).all()


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_round_matches_jax(arm, solver):
    """K2's plain version against pallas_step.fused_round (interpret), one
    round of 6 steps from the round-0 rate with a quarter of the lanes
    fulfilled (passed through on both sides): the live lanes' agreement of
    step counts and ok flags AGREEMENT_MIN[solver], alpha within
    ALPHA_REL_MAX on them."""
    d = arm
    kv, kvt, mix, a0, lsg, ljl, *lanes = _kernel_args(d)
    ful = d["frozen"]
    lr0 = np.full_like(ful, tfs.round_lr(d["tcfg"], 0, solver))
    rin = (kv, kvt, mix, a0, d["lsg"], d["ljl"], ful, lr0, *lanes)
    want = ps.fused_round(d["jcfg"], *rin[:8], 6, *rin[8:], solver=solver,
                          block_b=B, interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    trin = [_t(x) for x in rin]
    got = tfs.fused_round(d["tcfg"], *trin[:8], 6, *trin[8:], solver=solver)
    f = trin[6][0] > 0.5
    assert torch.equal(got.alpha[..., f], trin[3][..., f])
    live = ~f
    same = ((_t(want.inner) == got.inner) & (_t(want.ok) == got.ok))[0]
    agree = float(same[live].float().mean())
    scale = _t(want.alpha).abs().amax(dim=(0, 1))
    rel = float(((_t(want.alpha) - got.alpha).abs().amax(dim=(0, 1))
                 / scale)[same & live].max())
    print(f"J={d['J']} K2-{solver}: live agreement {agree:.4f}, alpha rel "
          f"{rel:.3g}")
    assert agree >= AGREEMENT_MIN[solver]
    assert rel <= tfs.ALPHA_REL_MAX


def test_fleet_solve_j5_matches_jax():
    """fleet_solve(backend="fused") at J = 5 (the plain K1 here) against
    JAX's fused backend (interpret) on 128 random scenes at 5 rounds x 20
    steps, as a distribution: converged fractions within bench.py's band,
    no phantom convergence on the exact check, mean unpenalized obstacle
    cost within 1%."""
    kw = dict(max_outer_iteration=5, max_inner_iteration=20)
    jcfg, tcfg = _configs(5, T30, **kw)
    jb = mp.make_basis(jcfg)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(5), 128)
    want = jfleet.fleet_solve(jcfg, jb, scns, backend="fused", interpret=True)
    tb = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                              for k in jb._fields}, device="cpu")
    tscns = mt.Scenario(*(_t(x) for x in scns))
    got = tfleet.fleet_solve(tcfg, tb, tscns, backend="fused")
    want_t = SolveResult(_t(want.alpha), type(got.stats)(
        *(_t(x) for x in want.stats)))
    ref_conv = float(want_t.stats.converged.float().mean())
    ref_cost = bench.mean_obstacle_cost(tcfg, tb, tscns, want_t)
    gate = bench.gate_against(tcfg, tb, tscns, got, 128, ref_conv, ref_cost)
    print("J=5 fleet_solve against JAX", gate["bands"])
    assert 0 < ref_conv < 1
    assert gate["fields"]["phantom_frac"] == 0.0
    assert gate["ok"], gate


# --------------------------------------------------------------------------
# The launch plan, the parameter block and the fallback.
# --------------------------------------------------------------------------


def _pad4(n):
    return -(-n // 4) * 4


@pytest.mark.parametrize("J", [2, 3, 5, 7])
@pytest.mark.parametrize("T", [50, 200])
def test_launch_plan_bytes_follow_j(T, J):
    """Every piece of K1/K2's shared memory against the layout formula of
    csrc/warp_body.cuh at J: mix J^2 padded to 4 floats, the endpoint block
    6 J + 2 padded to 4, the buffer max(2 J + 1, 2 pad4(J)) rows of T
    padded to 4 (8 at J = 3), the planes 4 J T (streamed: 6 J T padded to
    4), the CTA's control block 20 floats."""
    cfg = mt.PlannerConfig(n_timesteps=T, n_joints=J,
                           link_length=(1.0,) * J)
    lp = tfs.launch_plan(cfg, 11)
    f, rs = 4, _pad4(T)
    rows = max(2 * J + 1, 2 * _pad4(J))
    lanes = lp["lanes"]
    per_lane = {"planes": f * 4 * J * T, "buffer": f * rows * rs,
                "obstacles": f * 4 * 11, "endpoints": f * _pad4(6 * J + 2)}
    if lp["plan"] == "resident":
        want = {"basis": f * 4 * T * T, "mix": f * _pad4(J * J),
                **{k: lanes * v for k, v in per_lane.items()}}
    else:
        per_lane["state"] = f * (_pad4(6 * J * T) - 4 * J * T)
        room = lp["bytes"]["room"]
        want = {"mix": f * _pad4(J * J), "control": f * 20, "room": room,
                **{k: lanes * v for k, v in per_lane.items()}}
        assert room >= f * 2 * T * lanes
        assert room % 16 == 0
    assert lp["bytes"] == want
    assert lp["total"] == sum(want.values()) <= tfs.SMEM_PER_CTA_MAX
    if J == 3:
        assert rows == 8 and _pad4(6 * J + 2) == 20 and _pad4(J * J) == 12
    k6 = sk.forward_plan(cfg)
    assert k6["lanes"] == (64 if J <= 4 else 32)
    assert k6["bytes"]["alpha"] == f * 2 * J * 10 * k6["lanes"]
    assert k6["threads"] == (64 // 4) * (k6["lanes"] // (4 if J <= 4 else 2))


def _c_struct_fields(text, name):
    defines = dict(re.findall(r"^#define\s+(\w+)\s+(\d+)", text, re.M))
    body = re.search(r"struct\s+" + name + r"\s*\{(.*?)\};", text, re.S)
    body = re.sub(r"//[^\n]*", "", body.group(1))
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        for item in names.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*(?:\[(\w+)\])?\s*", item)
            n = m.group(2)
            fields.append((m.group(1), ctype,
                           int(defines.get(n, n)) if n else 1))
    return fields


@pytest.mark.parametrize("J", [1, 2, 5, 7, 15])
def test_params_mirror_matches_the_c_struct_at_each_j(J):
    """The ctypes mirror of J joints (fused_solve.params_type) declares
    struct FsParams's fields as lane_body.cuh compiles them under -DNJ=J
    (its default NJ replaced by J): the same order, types and lengths
    (link holds J floats), and the size and last-field offset the loader
    checks."""
    text = open(os.path.join(CSRC, "lane_body.cuh")).read()
    assert re.search(r"^#ifndef NJ\n#define NJ 3\n#endif", text, re.M)
    want = _c_struct_fields(re.sub(r"^#define NJ 3$", f"#define NJ {J}",
                                   text, flags=re.M), "FsParams")
    P = tfs.params_type(J)
    got = []
    for fname, ftype in P._fields_:
        count = getattr(ftype, "_length_", 1)
        base = ftype._type_ if hasattr(ftype, "_length_") else ftype
        got.append((fname, {ctypes.c_int: "int", ctypes.c_float: "float"}[
            base], count))
    assert got == want
    assert ("link", "float", J) in got
    size, last = _build.params_layout(J)
    assert size == 4 * sum(c for _, _, c in want)
    assert last == size - 4 * want[-1][2]
    cfg = mt.PlannerConfig(n_joints=J, link_length=tuple(
        0.5 + 0.1 * j for j in range(J)))
    p = tfs.kernel_params(cfg, 11, 8)
    assert isinstance(p, P) and len(p.link) == J
    assert list(p.link) == [float(np.float32(x)) for x in cfg.link_length]
    assert _build.library_path(J) != _build.library_path(3 if J != 3 else 5)
    assert f"-DNJ={J}" in _build.flags(J)


def test_fleet_solve_falls_back_where_no_plan_fits():
    """Where no launch plan fits at (T, J) (the 7-link arm past T = 965 at
    11 obstacles, where one lane's streamed state outgrows a CTA's shared
    memory; a 128-link arm at T = 50, where one lane's resident state
    does), fleet_solve(backend="fused" and "pallas") warns and runs the xla
    engine, bit for bit its result."""
    cfg = mt.PlannerConfig(n_timesteps=1000, n_joints=7,
                           link_length=ARMS[7], max_inner_iteration=2,
                           max_outer_iteration=1, fixed_iters=True,
                           max_obstacles=11)
    assert tfs.kernel_plan(cfg.replace(n_timesteps=960), 11) is not None
    assert tfs.kernel_plan(cfg, 11) is None
    with pytest.raises(NotImplementedError, match="J=7"):
        tfs.launch_plan(cfg, 11)
    wide = cfg.replace(n_timesteps=50, n_joints=128,
                       link_length=(0.2,) * 128)
    assert tfs.kernel_plan(wide, 11) is None
    for c in (cfg, wide):
        basis = mt.make_basis(c, device="cpu")
        scns = mt.random_scenarios(c, torch.Generator().manual_seed(0), 2,
                                   device="cpu")
        xla = tfleet.fleet_solve(c, basis, scns, backend="xla")
        for backend in ("fused", "pallas"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = tfleet.fleet_solve(c, basis, scns, backend=backend)
            assert any("falling back to backend='xla'" in str(w.message)
                       and f"J={c.n_joints}" in str(w.message)
                       for w in caught)
            assert torch.equal(got.alpha, xla.alpha)
