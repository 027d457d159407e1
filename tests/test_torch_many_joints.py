"""The port at arms of 16 and more joints (the kernels of csrc/wide/, J at
run time; ops/_build.py builds one library for every J >= 16).

On the CPU the wrappers run their plain versions, held here to the JAX
package's Pallas kernels run interpreted (``interpret=True``,
``recip_newton=True``, as tests/test_torch_joints.py runs them) on a 16-link
arm of the reference arm's reach (16 links of 0.1875) at T = 30, with
tests/test_torch_joints.py's numpy-seeded inputs (``_inputs``) and short
schedule (2 rounds x 6 steps): K6 and K5 element by element, one K3 and one
K4 step, K1-BLS and K2-GD by lane agreement.  One input set and one JAX
call per kernel, cached for the module.  Also here: the launch plan's
pieces at J = 16, 32 and 64 against the layout formula, the parameter
block's ctypes mirror against csrc/wide/wide_body.cuh's WParams, the
library's sources and flags, and the ``xla`` fallback at J = 128, T = 50,
where one lane's resident state does not fit and the warning names the
largest piece.

The whole file took 142 s on one torch thread of an 8-core Intel Xeon (JAX's
interpreted K1 and K2 most of it).
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
from irm_motion_planning_tpu_torch.ops import _build
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "irm_motion_planning_tpu_torch", "csrc")
REACH = 3.0  # the reference arm's reach: 1.5 + 1.0 + 0.5
J16, T30, B = 16, 30, 64
SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11)
# tests/test_torch_joints.py's bounds (K5/K6 element by element, one step,
# K1/K2 lane agreement).
EVAL_BOUNDS = dict(traj=1e-6, vel=1e-5, loss=2e-5)
GRAD_RTOL, GRAD_ATOL = 2e-6, 1e-4
STEP_EQUAL_MIN = 0.99
STEP_ALPHA_REL = 1e-6
AGREEMENT_MIN = {"bls": tfs.LANE_AGREEMENT_MIN, "gd": 0.80}


def arm(J):
    return (REACH / J,) * J


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.tensor(np.asarray(x))


def _configs(J, T, **kw):
    """JAX's config and the port's.  JAX's runs its Armijo ladder without
    unrolled rungs (``bls_ladder_unroll=0``: the same op sequence, its
    config says, and a third less of the interpreted kernels' compile at
    J = 16, which is most of this file's time)."""
    kw = {**SHORT, "n_timesteps": T, "n_joints": J, "link_length": arm(J),
          **kw}
    return (mp.PlannerConfig(recip_newton=True, bls_ladder_unroll=0, **kw),
            mt.PlannerConfig(**kw))


@functools.lru_cache(maxsize=None)
def _inputs(J=J16, T=T30, n=B, seed=9):
    """tests/test_torch_joints.py's _inputs at J: JAX's basis and n random
    scenes; the warm start, a moderate numpy-seeded alpha with JAX's
    evaluation of it, a quarter of the lanes frozen, mixed learning rates;
    all numpy."""
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
        J=J, T=T, jcfg=jcfg, tcfg=tcfg, basis=basis, a0=a0, lsg=lsg, ljl=ljl,
        lanes=lanes, alpha=alpha,
        frozen=(rng.random((1, n)) < 0.25).astype(np.float32),
        bls_lr=rng.choice(np.array([0.2, 0.1, 0.05, 0.3], np.float32), (1, n)),
        gd_lr=rng.choice(np.array(jcfg.gd_lr[:2], np.float32), (1, n)))


@functools.lru_cache(maxsize=None)
def _jax_eval():
    d = _inputs()
    ev = ps.cost_grad_eval(d["jcfg"], *d["basis"], d["alpha"], d["lsg"],
                           d["ljl"], *d["lanes"], block_b=B, interpret=True)
    return [np.asarray(x) for x in ev]


def _kernel_args(d):
    n = d["a0"].shape[-1]
    return (*d["basis"], d["a0"],
            np.full((1, n), d["jcfg"].lambda_sg_constraint, np.float32),
            np.full((1, n), d["jcfg"].lambda_jl_constraint, np.float32),
            *d["lanes"])


# --------------------------------------------------------------------------
# K5, K6 and one K3/K4 step against JAX's, element by element.
# --------------------------------------------------------------------------


def test_forward_eval_matches_jax_at_16_joints():
    """K6's plain version against pallas_step.forward_eval at the moderate
    alpha, element by element."""
    d = _inputs()
    kv, _, mix = d["basis"]
    want = ps.forward_eval(d["jcfg"], kv, mix, d["alpha"], block_b=B,
                           interpret=True)
    got = sk.forward_eval(d["tcfg"], _t(kv), _t(mix), _t(d["alpha"]))
    assert got.traj.shape == (J16, T30, B)
    np.testing.assert_allclose(got.traj.numpy(), np.asarray(want.traj),
                               rtol=0, atol=EVAL_BOUNDS["traj"])
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               rtol=0, atol=EVAL_BOUNDS["vel"])


def test_cost_grad_eval_matches_jax_at_16_joints():
    """K5's plain version against pallas_step.cost_grad_eval at the moderate
    alpha with penalties x1/x10/x100, element by element."""
    d = _inputs()
    want = _jax_eval()
    got = sk.cost_grad_eval(d["tcfg"], *map(_t, d["basis"]), _t(d["alpha"]),
                            _t(d["lsg"]), _t(d["ljl"]), *map(_t, d["lanes"]))
    loss, grad, traj, vel = (x.numpy() for x in got)
    np.testing.assert_allclose(loss, want[0], rtol=EVAL_BOUNDS["loss"])
    np.testing.assert_allclose(grad, want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(traj, want[2], rtol=0,
                               atol=EVAL_BOUNDS["traj"])
    np.testing.assert_allclose(vel, want[3], rtol=0, atol=EVAL_BOUNDS["vel"])


@pytest.mark.parametrize("program", ["bls", "gd"])
def test_one_step_matches_jax_at_16_joints(program):
    """One K3 step (the linearized ladder) or K4 step, plain version against
    pallas_step.bls_inner_step / gd_inner_step from JAX's evaluation of the
    moderate alpha, a quarter of the lanes frozen: frozen lanes pass through
    bit for bit on both sides, lr and the stop flags are equal on every
    lane, STEP_EQUAL_MIN of the live lanes' coefficients are equal to
    float32 resolution (GD's bit for bit)."""
    d = _inputs()
    gd = program == "gd"
    lr = d["gd_lr"] if gd else d["bls_lr"]
    loss, grad, traj, vel = _jax_eval()
    ins = (d["alpha"], grad, traj, vel, loss, lr, d["frozen"])
    fn = ps.gd_inner_step if gd else ps.bls_inner_step
    want = fn(d["jcfg"], *d["basis"], *ins, d["lsg"], d["ljl"], *d["lanes"],
              block_b=B, interpret=True)
    want = [np.asarray(x) for x in want]
    tfn = sk.gd_inner_step if gd else sk.bls_inner_step
    got = tfn(d["tcfg"], *map(_t, d["basis"]), *map(_t, ins), _t(d["lsg"]),
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
    print(f"J=16 {program}: alpha equal {equal:.4f} (bitwise {bitwise:.4f}), "
          f"rel {diff.max():.3g}")
    assert equal >= STEP_EQUAL_MIN
    assert diff.max() <= STEP_ALPHA_REL
    if gd:
        assert bitwise == 1.0


# --------------------------------------------------------------------------
# K1-BLS and K2-GD against JAX's, by lane agreement.
# --------------------------------------------------------------------------


def test_short_solve_matches_jax_at_16_joints():
    """K1-BLS's plain version against pallas_step.fused_solve (interpret)
    at 2 rounds x 6 steps: lane agreement AGREEMENT_MIN, alpha within
    ALPHA_REL_MAX of the lane's scale on the agreeing lanes, mean final
    loss within 1%."""
    d = _inputs()
    args = _kernel_args(d)
    want = ps.fused_solve(d["jcfg"], *args, solver="bls", block_b=B,
                          interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = tfs.fused_solve(d["tcfg"], *map(_t, args), solver="bls")
    agree, rel = tfs.lane_agreement(want, got)
    wl, gl = float(want.final_loss.mean()), float(got.final_loss.mean())
    print(f"J=16 K1-bls: agreement {agree:.4f}, alpha rel {rel:.3g}; loss "
          f"{gl:.6f} against {wl:.6f}")
    assert agree >= AGREEMENT_MIN["bls"]
    assert rel <= tfs.ALPHA_REL_MAX
    assert abs(gl - wl) <= 0.01 * abs(wl)
    assert np.isfinite(got.alpha.numpy()).all()


def test_round_matches_jax_at_16_joints():
    """K2-GD's plain version against pallas_step.fused_round (interpret),
    one round of 6 steps from the round-0 rate with a quarter of the lanes
    fulfilled (passed through on both sides): the live lanes' agreement of
    step counts and ok flags AGREEMENT_MIN, alpha within ALPHA_REL_MAX on
    them."""
    d = _inputs()
    kv, kvt, mix, a0, lsg, ljl, *lanes = _kernel_args(d)
    ful = d["frozen"]
    lr0 = np.full_like(ful, tfs.round_lr(d["tcfg"], 0, "gd"))
    rin = (kv, kvt, mix, a0, d["lsg"], d["ljl"], ful, lr0, *lanes)
    want = ps.fused_round(d["jcfg"], *rin[:8], 6, *rin[8:], solver="gd",
                          block_b=B, interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    trin = [_t(x) for x in rin]
    got = tfs.fused_round(d["tcfg"], *trin[:8], 6, *trin[8:], solver="gd")
    f = trin[6][0] > 0.5
    assert torch.equal(got.alpha[..., f], trin[3][..., f])
    live = ~f
    same = ((_t(want.inner) == got.inner) & (_t(want.ok) == got.ok))[0]
    agree = float(same[live].float().mean())
    scale = _t(want.alpha).abs().amax(dim=(0, 1))
    rel = float(((_t(want.alpha) - got.alpha).abs().amax(dim=(0, 1))
                 / scale)[same & live].max())
    print(f"J=16 K2-gd: live agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= AGREEMENT_MIN["gd"]
    assert rel <= tfs.ALPHA_REL_MAX


# --------------------------------------------------------------------------
# The launch plan, the parameter block, the library and the fallback.
# --------------------------------------------------------------------------


def _pad4(n):
    return -(-n // 4) * 4


@pytest.mark.parametrize("J,T,plan", [
    (16, 25, "resident"), (16, 50, "resident"), (32, 50, "resident"),
    (64, 50, "resident"), (16, 200, "streamed"), (32, 200, "streamed")])
def test_launch_plan_bytes_follow_wide_j(J, T, plan):
    """Every piece of K1/K2's shared memory at J >= 16 against the layout
    formula of csrc/wide/wide_body.cuh: tests/test_torch_joints.py's pieces,
    the CTA's link (J floats padded to 4) beside mix, and in the resident
    plan the warp's traj/vel and gx/gy planes (6 J T + 2 T padded to 4,
    less the four planes: ``state``); K6's tile a K6_JOINTS-joint stage and
    a J-float scratch column per thread."""
    cfg = mt.PlannerConfig(n_timesteps=T, n_joints=J, link_length=arm(J))
    lp = tfs.launch_plan(cfg, 11)
    assert lp["plan"] == plan and not lp["bf16"]
    f, rs = 4, _pad4(T)
    rows = max(2 * J + 1, 2 * _pad4(J))
    lanes = lp["lanes"]
    per_lane = {"planes": f * 4 * J * T, "buffer": f * rows * rs,
                "obstacles": f * 4 * 11, "endpoints": f * _pad4(6 * J + 2)}
    if plan == "resident":
        per_lane["state"] = f * (_pad4(6 * J * T + 2 * T) - 4 * J * T)
        want = {"basis": f * 4 * T * T, "mix": f * _pad4(J * J),
                "link": f * _pad4(J),
                **{k: lanes * v for k, v in per_lane.items()}}
    else:
        per_lane["state"] = f * (_pad4(6 * J * T) - 4 * J * T)
        room = lp["bytes"]["room"]
        want = {"mix": f * _pad4(J * J), "link": f * _pad4(J),
                "control": f * 20, "room": room,
                **{k: lanes * v for k, v in per_lane.items()}}
        assert room >= f * 2 * T * lanes and room % 16 == 0
        assert lp["ring"]["joint_blocks"] == -(-J // tfs.K7_JOINTS)
        assert min(lp["ring"]["kv"]["stage_t"],
                   lp["ring"]["kvt"]["stage_t"]) >= 1
    assert lp["bytes"] == want
    assert lp["total"] == sum(want.values()) <= tfs.SMEM_PER_CTA_MAX
    # One more lane would not fit (or the default's 16 are taken).
    more = sum(want.values()) + sum(per_lane.values())
    assert lanes == tfs.DEFAULT_WARPS or plan == "streamed" or (
        more > tfs.SMEM_PER_CTA_MAX)
    # The bf16 tier holds its planes as float32 at J >= 16: bls's plan.
    assert tfs.launch_plan(cfg, 11, prog="bls_bf16") == lp
    k6 = sk.forward_plan(cfg)
    assert k6["bytes"] == {"basis": f * 2 * 10 * 64,
                           "alpha": f * 2 * sk.K6_JOINTS * 10 * 32,
                           "scratch": f * J * 256}


@pytest.mark.parametrize("J,T,piece", [(128, 50, "planes"), (48, 200, "planes"),
                                       (16, 1000, "planes")])
def test_no_plan_names_the_largest_piece(J, T, piece):
    """Where one lane does not fit, every float32 program's plan raises
    NotImplementedError naming the largest piece, and kernel_plan gives
    none (GD and the exact ladder past their reach plan too)."""
    cfg = mt.PlannerConfig(n_timesteps=T, n_joints=J, link_length=arm(J))
    for solver, ladder in (("bls", "linearized"), ("bls", "exact"),
                           ("gd", "linearized")):
        c = cfg.replace(ladder_eval=ladder)
        assert tfs.kernel_plan(c, 11, solver) is None
        why = tfs.no_plan_reason(c, 11, solver)
        assert f"J={J}" in why and "largest piece is" in why
    assert f"largest piece is {piece}" in tfs.no_plan_reason(cfg, 11)


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


@pytest.mark.parametrize("J", [16, 32, 64])
def test_params_mirror_matches_the_wide_struct(J):
    """The ctypes mirror of J joints (fused_solve.params_type, one type for
    every J >= 16) declares csrc/wide/wide_body.cuh's WParams fields in
    its order, types and lengths: J, then link's WW_MAX_J (= MAX_J) slots,
    last.  Its size and last-field offset are what the wide library's
    fused_params_layout reports (1,404 and 380 bytes), and kernel_params
    fills J and link's first J slots, the rest zero."""
    text = open(os.path.join(CSRC, "wide", "wide_body.cuh")).read()
    want = _c_struct_fields(text, "WParams")
    assert [n for n, _, _ in want[-2:]] == ["J", "link"]
    assert want[-1][2] == tfs.MAX_J
    P = tfs.params_type(J)
    assert P is tfs.params_type(16)
    got = []
    for fname, ftype in P._fields_:
        count = getattr(ftype, "_length_", 1)
        base = ftype._type_ if hasattr(ftype, "_length_") else ftype
        got.append((fname, {ctypes.c_int: "int", ctypes.c_float: "float"}[
            base], count))
    assert got == want
    size, last = _build.params_layout(J)
    assert (size, last) == (4 * tfs.MAX_J + 380, 380)
    assert size == 4 * sum(n for _, _, n in want)
    p = tfs.kernel_params(mt.PlannerConfig(n_joints=J, link_length=arm(J)),
                          11, 8)
    assert isinstance(p, P) and p.J == J == tfs.params_joints(p)
    assert list(p.link[:J]) == [float(np.float32(REACH / J))] * J
    assert not any(p.link[J:])


def test_one_library_for_every_wide_j():
    """J >= 16 builds csrc/wide/*.cu once, without -DNJ, into one library
    path; J <= 15 keep their per-J libraries of csrc/*.cu."""
    wide = _build.sources(16)
    assert wide and all(os.path.dirname(s) == os.path.join(CSRC, "wide")
                        for s in wide)
    assert _build.sources(32) == _build.sources(64) == wide
    assert not set(wide) & set(_build.sources(15))
    assert (_build.library_path(16) == _build.library_path(32)
            == _build.library_path(128))
    assert "kernels_wide_" in _build.library_path(16)
    assert "kernels_J15_" in _build.library_path(15)
    assert not any(f.startswith("-DNJ") for f in _build.flags(16))
    assert "-DNJ=15" in _build.flags(15)
    with pytest.raises(NotImplementedError):
        _build.flags(tfs.MAX_J + 1)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_wide_arm_takes_the_kernels_path(backend):
    """At J = 16 and 32, T = 30, fleet_solve(backend="fused"|"pallas") plans
    the kernels and warns of no fallback; the per-step path's plain version
    equals the fused one's bit for bit."""
    for J in (16, 32):
        cfg = mt.PlannerConfig(n_timesteps=T30, n_joints=J,
                               link_length=arm(J), max_inner_iteration=3,
                               max_outer_iteration=2, fixed_iters=True,
                               max_obstacles=11)
        assert tfs.kernel_plan(cfg, 11)["plan"] == "resident"
        basis = mt.make_basis(cfg, device="cpu")
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), 4,
                                   device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = tfleet.fleet_solve(cfg, basis, scns, backend=backend)
            ref = tfleet.fleet_solve(cfg, basis, scns, backend="fused")
        assert torch.equal(got.alpha, ref.alpha)
        assert all(torch.equal(x, y) for x, y in zip(got.stats, ref.stats))
        assert torch.isfinite(got.alpha).all()


def test_fleet_solve_falls_back_at_128_joints():
    """At J = 128, T = 50 one lane's resident state does not fit a CTA:
    fleet_solve(backend="fused" and "pallas") warns, naming the piece of
    shared memory that does not fit, and runs the xla engine, bit for bit
    its result."""
    J = 128
    cfg = mt.PlannerConfig(n_timesteps=50, n_joints=J, link_length=arm(J),
                           max_inner_iteration=2, max_outer_iteration=1,
                           fixed_iters=True, max_obstacles=11)
    assert tfs.kernel_plan(cfg, 11) is None
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), 2,
                               device="cpu")
    xla = tfleet.fleet_solve(cfg, basis, scns, backend="xla")
    for backend in ("fused", "pallas"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = tfleet.fleet_solve(cfg, basis, scns, backend=backend)
        msgs = [str(w.message) for w in caught]
        assert any("falling back to backend='xla'" in m and "J=128" in m
                   and "the largest piece is planes" in m for m in msgs), msgs
        assert torch.equal(got.alpha, xla.alpha)
