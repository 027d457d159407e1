"""GD through the port's fused kernels (ops/fused_solve.py, solver="gd")
against the JAX package's Pallas kernels, run interpreted on the CPU as
tests/test_fleet_fused.py runs them, and against the port's own per-step
GD path; and the kernels' parameter block against its C declaration.

As in test_torch_fused_solve.py, the JAX side runs with
``recip_newton=True`` (closest to the port's exact division), and whole
solves are compared as lane-agreement fractions: per-lane outcomes of long
solves depend on the fp path.  GD is held to the per-step GD threshold of
tests/test_torch_step.py (0.80).
"""

import ctypes
import os
import re

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
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11)
# The per-step GD threshold (tests/test_torch_step.py): GD against JAX.
GD_AGREEMENT_MIN = 0.80
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "irm_motion_planning_tpu_torch", "csrc")


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
    args = _kernel_args(jcfg, basis, scns)
    return jcfg, tcfg, basis, scns, args


def _round_inputs(args, seed=0):
    """One round's inputs: a quarter of the lanes fulfilled, penalties
    escalated x1/x10/x100, the GD schedule's first four learning rates."""
    kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    B = a0.shape[-1]
    rng = np.random.default_rng(seed)
    ful = (rng.random((1, B)) < 0.25).astype(np.float32)
    esc = np.array([1.0, 10.0, 100.0], np.float32)[rng.integers(0, 3, (1, B))]
    lr0 = np.array(mt.PlannerConfig().gd_lr[:4], np.float32)[
        rng.integers(0, 4, (1, B))]
    return (kv, kvt, mix, a0, lsg * esc, ljl * esc, jnp.asarray(ful),
            jnp.asarray(lr0), start, goal, ox, oy, ow)


def test_short_gd_solve_matches_fused_kernel(setup):
    """K1-GD's plain version against pallas_step.fused_solve(solver="gd",
    interpret=True) on 128 random scenes at 2 rounds x 6 steps.  Measured:
    88.3% of lanes end with equal step counts, rounds and flags (88.3-93.8%
    over four seeds), their alpha within 5.7e-7 of the lane's scale; mean
    final loss within 5.5e-5 relative (at most 1.5e-4 over the seeds)."""
    jcfg, tcfg, _, _, args = setup
    want = ps.fused_solve(jcfg, *args, solver="gd", block_b=128,
                          interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = tfs.fused_solve(tcfg, *(_t(x) for x in args), solver="gd")
    agree, rel = tfs.lane_agreement(want, got)
    wl, gl = float(want.final_loss.mean()), float(got.final_loss.mean())
    print(f"GD K1: lane agreement {agree:.4f}, alpha rel {rel:.3g}; mean "
          f"final loss {gl:.6f} against {wl:.6f}")
    assert agree >= GD_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    assert abs(gl - wl) <= 0.01 * abs(wl), (gl, wl)
    assert np.isfinite(got.alpha.numpy()).all()


def test_gd_round_matches_fused_round_kernel(setup):
    """K2-GD's plain version against pallas_step.fused_round(solver="gd",
    interpret=True), one round of 6 steps on 128 random scenes with a
    quarter of the lanes fulfilled and four learning rates.  The fulfilled
    lanes pass through on both sides (alpha unchanged, no steps).
    Measured: every live lane with equal step counts and ok flags, alpha
    within 3.8e-7 of the lane's scale."""
    jcfg, tcfg, _, _, args = setup
    rin = _round_inputs(args)
    want = ps.fused_round(jcfg, *rin[:8], 6, *rin[8:], solver="gd",
                          block_b=128, interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    trin = [_t(x) for x in rin]
    got = tfs.fused_round(tcfg, *trin[:8], 6, *trin[8:], solver="gd")
    ful = trin[6][0] > 0.5
    assert torch.equal(got.alpha[..., ful], trin[3][..., ful])
    assert (got.inner[0, ful] == 0).all() and (got.ok[0, ful] == 1).all()
    live = ~ful
    same = ((_t(want.inner) == got.inner) & (_t(want.ok) == got.ok))[0]
    agree = float(same[live].float().mean())
    scale = _t(want.alpha).abs().amax(dim=(0, 1))
    rel = ((_t(want.alpha) - got.alpha).abs().amax(dim=(0, 1)) / scale)
    rel = float(rel[same & live].max())
    print(f"GD K2: live-lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= GD_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX


@pytest.fixture(scope="module")
def rounds_setup():
    """Five GD rounds (24/8/8/8/8 steps) on 96 random scenes: three lanes
    converge, two of them in round 4, so they pass through round 5."""
    cfg = mt.PlannerConfig(max_outer_iteration=5, inner_schedule=(24, 8, 8,
                                                                  8, 8),
                           max_inner_iteration=24, fixed_iters=True,
                           max_obstacles=11)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(4), 96,
                               device="cpu")
    k1 = tfs.fused_solve(*tfleet.fused_args(cfg, basis, scns), solver="gd")
    return cfg, basis, scns, tfleet.kernel_result(k1)


@pytest.mark.parametrize("compact", [False, True])
def test_gd_rounds_driver_equals_whole_solve(rounds_setup, compact):
    """The plain rounds driver (one fused_round per round, GD's per-round
    learning rate, one re-sort with compaction) equals the plain K1-GD bit
    for bit on every output field, lanes fulfilled early included."""
    cfg, basis, scns, want = rounds_setup
    assert int((want.stats.converged & (want.stats.outer_iters < 4)).sum()) > 0
    got = tfleet._fused_rounds_solve(cfg.replace(lane_compaction=compact),
                                     tfleet.fused_args(cfg, basis, scns)[1:],
                                     "gd")
    assert torch.equal(got.alpha, want.alpha)
    for x, y in zip(got.stats, want.stats):
        assert torch.equal(x, y)


def test_fused_gd_equals_per_step_gd(rounds_setup):
    """The plain fused GD against the plain per-step GD path
    (backend="pallas" on the CPU): alpha and every count equal, as the JAX
    package holds its own (tests/test_fleet_fused.py,
    test_fused_gd_matches_per_step).  Both run fused_solve.gd_step; the
    fused one takes round r's learning rate from the schedule, the per-step
    one the lane's gd_lr[outer_iter], equal on every live lane."""
    cfg, basis, scns, fused = rounds_setup
    step = tfleet.fleet_solve(cfg, basis, scns, solver="gd", backend="pallas")
    assert torch.equal(fused.alpha, step.alpha)
    for x, y in zip(fused.stats, step.stats):
        assert torch.equal(x, y)


def test_replicated_scene_gives_identical_gd_lanes(setup):
    """Every lane of the replicated reference scene ends bit for bit as
    lane 0 through K1-GD's plain version."""
    _, tcfg, _, _, _ = setup
    scn = mt.reference_scenario(tcfg, device="cpu")
    basis = mt.make_basis(tcfg, device="cpu")
    out = tfs.fused_solve(*tfleet.fused_args(
        tcfg, basis, mt.replicate_scenario(scn, 8)), solver="gd")
    for x in out:
        assert bool((x == x[..., :1]).all())


def test_fleet_solve_gd_fused_matches_jax(setup):
    """fleet_solve(solver="gd", backend="fused") against JAX's, interpreted,
    on 128 other random scenes (PRNGKey(5); JAX's fused backend takes a
    multiple of 128 lanes) at 2 rounds x 6 steps.  Measured: 88.3% of the
    lanes agree, alpha within 7.4e-7 of the lane's scale."""
    jcfg, tcfg, jb, _, _ = setup
    sub = mp.random_scenarios(jcfg, jax.random.PRNGKey(5), 128)
    tb = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                              for k in jb._fields}, device="cpu")
    want = jfleet.fleet_solve(jcfg, jb, sub, solver="gd", backend="fused",
                              interpret=True)
    got = tfleet.fleet_solve(tcfg, tb, mt.Scenario(*(_t(x) for x in sub)),
                             solver="gd", backend="fused")

    def as_fused(res):
        alpha = torch.tensor(np.asarray(res.alpha)).movedim(0, -1)
        st = [torch.tensor(np.asarray(x)).to(torch.float32)[None]
              for x in (res.stats.final_cost, res.stats.converged,
                        res.stats.outer_iters, res.stats.inner_iters)]
        return tfs.FusedSolve(alpha.movedim(1, 0), *st)

    agree, rel = tfs.lane_agreement(as_fused(want), as_fused(got))
    print(f"fleet_solve GD fused: lane agreement {agree:.4f}, alpha rel "
          f"{rel:.3g}")
    assert agree >= GD_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX


def test_gd_support_check_follows_the_solver(setup):
    """GD ignores the ladder options, as the JAX kernel does: the exact
    ladder and the bf16 tier run it, as its one program.  BLS runs either
    ladder tier, each its own program; the bf16 tier runs under the
    linearized ladder (its own program) and raises under the exact one.
    Both solvers refuse a precision other than full fp32."""
    _, tcfg, _, _, args = setup
    targs = [_t(x)[..., :2] if _t(x).dim() > 1 and _t(x).shape[-1] == 128
             else _t(x) for x in args]
    for kw in (dict(ladder_eval="exact"), dict(bls_bf16_ladder=True)):
        cfg = tcfg.replace(**kw)
        tfs.fused_solve(cfg, *targs, solver="gd")
        assert tfs.program(cfg, "gd") == "gd"
    exact = tcfg.replace(ladder_eval="exact")
    tfs.fused_solve(exact, *targs)
    assert [tfs.program(c, "bls") for c in (tcfg, exact)] == [
        "bls", "bls_exact"]
    bf16 = tcfg.replace(bls_bf16_ladder=True)
    for x, y in zip(tfs.fused_solve(bf16, *targs, bf16=True),
                    tfs.fused_solve_reference(tcfg, *targs, bf16=True)):
        assert torch.equal(x, y)
    assert tfs.program(bf16, "bls", bf16=True) == "bls_bf16"
    with pytest.raises(NotImplementedError):
        tfs.fused_solve(exact.replace(bls_bf16_ladder=True), *targs)
    for solver in ("bls", "gd"):
        with pytest.raises(NotImplementedError):
            tfs.fused_solve(tcfg.replace(matmul_precision="default"), *targs,
                            solver=solver)
    with pytest.raises(ValueError, match="solver"):
        tfs.fused_solve(tcfg, *targs, solver="adam")


def test_kernel_params_carry_the_gd_schedule():
    """gd_lr[r] of the parameter block is round r's GD learning rate, the
    schedule's last entry past its end, in float32."""
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(4, 4, 4),
                           fixed_iters=True)
    p = tfs.kernel_params(cfg, 11, 8)
    lrs = [float(np.float32(x)) for x in cfg.gd_lr]
    assert list(p.gd_lr[:len(lrs)]) == lrs
    assert all(x == lrs[-1] for x in p.gd_lr[len(lrs):])
    assert p.lr_start == float(np.float32(cfg.bls_lr_start))


def _c_struct_fields(path, name):
    """[(field, 'int' | 'float', count)] of ``struct name`` in a C header,
    in declaration order; ``count`` is the array length (1 for a scalar),
    resolving #define'd lengths from the same header."""
    text = open(path).read()
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


def test_params_mirror_matches_the_c_struct():
    """_Params (ctypes) declares struct FsParams's fields in the same order,
    with the same types and array lengths, and their size and last-field
    offset are the pair the library's fused_params_layout is checked
    against (ops/_build.py)."""
    want = _c_struct_fields(os.path.join(CSRC, "lane_body.cuh"), "FsParams")
    got = []
    for fname, ftype in tfs._Params._fields_:
        count = getattr(ftype, "_length_", 1)   # arrays have a length
        base = ftype._type_ if hasattr(ftype, "_length_") else ftype
        got.append((fname, {ctypes.c_int: "int", ctypes.c_float: "float"}[
            base], count))
    assert got == want
    assert want[-1][0] == "gd_lr"
    size, last = _build.params_layout()
    assert size == 4 * sum(c for _, _, c in want)
    assert last == size - 4 * want[-1][2]
    assert "offsetof(FsParams, gd_lr)" in open(
        os.path.join(CSRC, "fused_solve.cu")).read()
