"""The port's main-path slice against the JAX package: fleet_solve with the
fused backend, the fleet helpers, the benchmark schedule end to end on the
plain path, and the rule that the port never imports JAX.

As in test_torch_fused_solve.py, the JAX side runs with ``recip_newton=True``
(closest to the port's exact division), and whole solves are compared as
lane-agreement fractions (fp-path differences grow ~4x per BLS step).
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import fleet as jfleet

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch import bench
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops.costs import Penalty
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SHORT = dict(max_inner_iteration=6, max_outer_iteration=2, fixed_iters=True,
             max_obstacles=11)
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "irm_motion_planning_tpu_torch")


def _t(x):
    return torch.tensor(np.asarray(x))


def _tscn(scns):
    return mt.Scenario(*(_t(x) for x in scns))


def _as_fused(res):
    """A SolveResult as the FusedSolve fields lane_agreement compares."""
    alpha = torch.tensor(np.asarray(res.alpha)).movedim(0, -1)  # (T, J, B)
    st = [torch.tensor(np.asarray(x)).to(torch.float32)[None]
          for x in (res.stats.final_cost, res.stats.converged,
                    res.stats.outer_iters, res.stats.inner_iters)]
    return tfs.FusedSolve(alpha.movedim(1, 0), *st)


@pytest.fixture(scope="module")
def cfgs():
    return (mp.PlannerConfig(recip_newton=True, **SHORT),
            mt.PlannerConfig(**SHORT), mp.make_basis(mp.PlannerConfig()))


@pytest.mark.parametrize("scenes", ["reference", "random"])
def test_fleet_solve_matches_jax_fused(cfgs, scenes):
    """Port fleet_solve(backend='fused') against JAX's, interpreted, at the
    short config.  Measured: replicated reference scene, every lane equal
    to JAX's counts and flags, alpha within 3e-7 of the lane's scale;
    random scenes (PRNGKey(5)), 71% of lanes agree (62-77% over four
    seeds), alpha within 1.1e-6."""
    jcfg, tcfg, jb = cfgs
    tb = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                              for k in jb._fields}, device="cpu")
    if scenes == "reference":
        scns = mp.replicate_scenario(mp.reference_scenario(jcfg), 128)
    else:
        scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(5), 128)
    want = jfleet.fleet_solve(jcfg, jb, scns, backend="fused", interpret=True)
    got = tfleet.fleet_solve(tcfg, tb, _tscn(scns), backend="fused")
    assert got.alpha.shape == (128, 50, 3)
    assert got.stats.inner_iters.dtype == torch.int32
    assert got.stats.converged.dtype == torch.bool
    agree, rel = tfs.lane_agreement(_as_fused(want), _as_fused(got))
    print(f"{scenes}: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= (1.0 if scenes == "reference" else tfs.LANE_AGREEMENT_MIN)
    assert rel <= tfs.ALPHA_REL_MAX


def test_fleet_helpers_match_jax(cfgs):
    """to_fleet, fleet_init_alpha, fleet_cost and fleet_constraints on 64
    random scenes.  The warm start is two outer products with O(1e3)
    factors (measured 1.5e-3 abs on values up to 1.2e4); the costs at the
    same alpha, 2e-7 relative."""
    jcfg, tcfg, jb = cfgs
    tb = mt.make_basis(mt.PlannerConfig(), device="cpu")
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(2), 64)
    jfs = jfleet.to_fleet(scns)
    tfsc = tfleet.to_fleet(_tscn(scns))
    for w, g in zip(jfs, tfsc):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ja = np.asarray(jfleet.fleet_init_alpha(jcfg, jb, jfs))
    ta = tfleet.fleet_init_alpha(tcfg, tb, tfsc)
    np.testing.assert_allclose(ta.numpy(), ja, atol=2e-3, rtol=1e-6)
    pen = mp.initial_penalty(jcfg)
    np.testing.assert_allclose(
        tfleet.fleet_cost(tcfg, tb, tfsc, tfs_penalty(tcfg), _t(ja)).numpy(),
        np.asarray(jfleet.fleet_cost(jcfg, jb, jfs, pen, ja)), rtol=1e-5)
    np.testing.assert_array_equal(
        tfleet.fleet_constraints(tcfg, tb, tfsc, _t(ja)).numpy(),
        np.asarray(jfleet.fleet_constraints(jcfg, jb, jfs, ja)))
    np.testing.assert_array_equal(
        tfleet.alpha_from_fleet(tfleet.alpha_to_fleet(_t(ja))).numpy(), ja)


def tfs_penalty(cfg):
    return Penalty(torch.tensor(cfg.lambda_sg_constraint),
                   torch.tensor(cfg.lambda_jl_constraint))


def test_bench_schedule_on_plain_path():
    """The main path's full schedule (REFERENCE_INNER_SCHEDULE_BLS,
    max_obstacles=11) on the reference scene at B=8 through the port's
    plain path, with bench.py's cost gate and the loose endpoint bound
    (whether the endpoint lands under 0.01 depends on the fp path).
    Measured: avg 1.6477, max 2.1965, endpoint 0.0095."""
    out = bench.run_bench(batch=8, repeats=1, device="cpu")
    res = out["result"]
    print(f"bench schedule, plain path: avg {out['avg_cost']} max "
          f"{out['max_cost']} endpoint {out['endpoint_err']}")
    assert torch.isfinite(res.alpha).all()
    assert torch.isfinite(res.stats.final_cost).all()
    ref_avg, ref_max = mt.REFERENCE_FINAL_COST["bls"]
    assert out["avg_cost"] <= ref_avg * 1.02
    assert out["max_cost"] <= ref_max * 1.02
    assert out["endpoint_err"] < 0.05
    assert out["metric"] == "bls_solves_per_sec_cpu_rehearsal"
    # all lanes hold the same scene, so they end identical
    assert torch.equal(res.alpha[0], res.alpha[-1])


@pytest.mark.parametrize("kw,exc", [
    # The bf16 ladder tier quantises the linearized ladder's planes: under
    # the exact ladder the fused kernels refuse it (BLS; GD ignores the
    # ladder options).
    (dict(backend="fused", cfg=dict(ladder_eval="exact",
                                    bls_bf16_ladder=True)),
     NotImplementedError),
    # Under the linearized ladder the port always checks constraints on the
    # exact evaluation, on every kernel path.
    (dict(backend="pallas", cfg=dict(exact_constraint_eval=False)),
     NotImplementedError),
    (dict(backend="tpu"), ValueError),
])
def test_fleet_solve_rejects_modes_not_ported(kw, exc):
    kw = dict(kw)
    cfg = mt.PlannerConfig(**SHORT, **kw.pop("cfg", {}))
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device="cpu"), 2)
    with pytest.raises(exc):
        tfleet.fleet_solve(cfg, mt.make_basis(cfg, device="cpu"), scns, **kw)


@pytest.mark.parametrize("kw,exc", [
    (dict(bls_mode="sequential"), ValueError),
    # Compaction re-sorts lanes between kernel launches; as in JAX, asking
    # for it on the plain engine fails loudly.
    (dict(lane_compaction=True, backend="xla"), ValueError),
])
def test_fleet_solve_rejects_configs_not_ported(kw, exc):
    kw = dict(kw)
    backend = kw.pop("backend", "fused")
    cfg = mt.PlannerConfig(**SHORT, **kw)
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device="cpu"), 2)
    with pytest.raises(exc):
        tfleet.fleet_solve(cfg, mt.make_basis(cfg, device="cpu"), scns,
                           backend=backend)


def _imports_jax(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        if any(n == "jax" or n.startswith("jax.")
               or n.startswith("irm_motion_planning_tpu.")
               or n == "irm_motion_planning_tpu" for n in names):
            return True
    return False


def test_port_never_imports_jax():
    """Static check (the test process has jax imported already)."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 10
    offenders = [f for f in files if _imports_jax(f)]
    assert not offenders, offenders
    root = os.path.dirname(PKG)
    for script in ("chip_smoke.py",
                   os.path.join("tests", "test_torch_kernel_cuda.py")):
        assert not _imports_jax(os.path.join(root, script)), script
