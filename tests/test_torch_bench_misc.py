"""The port's decompose, ablation, roofline and epilogue modules
(irm_motion_planning_tpu_torch/benchmarks/) on the CPU, against the JAX
package's scripts where those run on the CPU (benchmarks/decompose.py with
``--backend xla``, benchmarks/ablation.py), and the phase-ablated builds'
flags (csrc/warp_body.cuh, ops/_build.py).

The ablation rows: each point is a single-scene BLS solve, where the port
and JAX part (ROADMAP queue 3, fact 7: the basis products round apart at
the warm start, and the warm start's float32 LU at ~1e15 conditioning moves
its coefficients by O(1)).  So JAX's warm start is crossed over as numpy,
and the budget is 2 rounds x 2 steps.  Measured (CPU, each point's avg and
max cost against JAX's): with JAX's warm start and eight torch threads at
most 1.55% apart at 2 x 2 steps, 3.2% at 2 x 5, 2.2% at 2 x 6, 2.0% at 2 x
10; at one torch thread 3.9% at 2 x 2; with each side's own warm start
13.3% at 2 x 2 and 16.5% at 2 x 5 (lambda 0.75).
"""

import contextlib
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.models import rkhs as jrkhs
from irm_motion_planning_tpu.solvers import bls as jbls

from irm_motion_planning_tpu_torch.benchmarks import (ablation, decompose,
                                                      epilogue, roofline)
from irm_motion_planning_tpu_torch.models import rkhs as trkhs
from irm_motion_planning_tpu_torch.ops import _build
from irm_motion_planning_tpu_torch.ops import roofline as ops_roofline

from jax_scripts import load_jax_script

ABLATION_BUDGET = dict(max_inner_iteration=2, max_outer_iteration=2)
# Each side's own fp-path variants move a point by up to 2.5% at this
# budget (JAX's point at lambda 0.25 when its solve folds the warm start in
# as a constant instead of taking it as an argument; the port's when it
# runs on one torch thread instead of eight), so the two packages' points
# are held to twice that, and the median of the ten gaps to 0.5%.
# Measured at one torch thread: 3.9% (lambda 0.25, avg), 2.3% (lambda 1,
# max), the other eight at most 0.25%, median 0.11%.
ABLATION_REL_TOL = 0.05
ABLATION_MEDIAN_TOL = 0.005


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _last_json(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        fn(*a)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_decompose_emits_jax_keys(monkeypatch):
    jdec = load_jax_script("decompose")
    monkeypatch.setattr(sys, "argv", ["decompose", "--batch", "4",
                                      "--backend", "xla", "--inner", "2"])
    want = _last_json(jdec.main)
    got = decompose.run(["--device", "cpu", "--batch", "4", "--backend",
                         "xla", "--inner", "2", "--repeats", "1"])
    assert set(want) <= set(got)
    assert got["metric"] == want["metric"] == "fleet_solve_decomposition"
    assert got["batch"] == 4 and got["backend"] == "xla"
    for k in ("layout_ms", "init_ms", "solve_minus_init_ms", "full_ms"):
        assert got[k] >= 0
    assert got["device"] == "cpu"


def test_ablation_rows_match_jax():
    """Each point of the port's table against JAX's at the same budget
    (benchmarks/ablation.py's config, solve and readout), both solves from
    one warm start, JAX's smoothstep fit passed to each as an argument,
    with the JAX script's table: every avg and max cost within
    ABLATION_REL_TOL, their median gap within ABLATION_MEDIAN_TOL (the
    module's docstring and the constants have why)."""
    jab = load_jax_script("ablation")
    assert ablation.REFERENCE_TABLE == jab.REFERENCE_TABLE
    pen0 = mp.Penalty(jax.numpy.float32(0), jax.numpy.float32(0))
    gaps = []
    for lam, (ref_avg, ref_max) in jab.REFERENCE_TABLE.items():
        jcfg = mp.PlannerConfig(lambda_max_cost=lam, bls_mode="ladder",
                                **ABLATION_BUDGET)
        jb = mp.make_basis(jcfg)
        scn = mp.reference_scenario(jcfg)
        a0 = jax.jit(lambda s: mp.init_alpha(jcfg, jb, s.start, s.goal))(scn)
        res = jax.jit(lambda s, a: jbls.solve(jcfg, jb, s, a))(scn, a0)
        want = [float(mp.total_cost(jcfg.replace(lambda_max_cost=x), jb, scn,
                                    pen0, res.alpha)) for x in (0.0, 1.0)]
        got = ablation.ablation_row(lam, "bls", "cpu",
                                    alpha0=torch.tensor(np.asarray(a0)),
                                    **ABLATION_BUDGET)
        assert list(got) == ["lambda_max_cost", "avg_cost", "max_cost",
                             "reference_avg", "reference_max"]
        assert (got["reference_avg"], got["reference_max"]) == (ref_avg,
                                                                 ref_max)
        gaps += [abs(got[k] / w - 1) for k, w in zip(("avg_cost",
                                                       "max_cost"), want)]
    print(gaps)
    assert max(gaps) <= ABLATION_REL_TOL
    assert float(np.median(gaps)) <= ABLATION_MEDIAN_TOL


def test_ablation_cli_rehearsal():
    with contextlib.redirect_stdout(io.StringIO()):
        out = ablation.run(["--device", "cpu", "--max-inner-iteration", "2",
                            "--max-outer-iteration", "1"])
    assert out["metric"] == "lambda_max_cost_ablation"
    assert len(out["rows"]) == 5 and out["device"] == "cpu"


def test_roofline_counts_are_ops_roofline():
    """The per-lane counts and bounds come from ops/roofline.py (no second
    count) at the H100's rates; the JAX script's TPU-unit keys are
    renamed."""
    B = 4
    out = roofline.run(["--device", "cpu", "--batch", str(B),
                        "--max-obstacles", "11"])
    ev = out["eval_kernel"]
    n = ops_roofline.LaneOps.at(50, 3, 11)
    bound = ops_roofline.cost_grad_eval(B, 50, 3, 11)
    assert ev["flops_per_lane"] == n.forward + n.cost + n.loss + n.grad
    assert ev["flops_per_lane"] * B == bound.ops
    assert ev["hbm_bound_ceiling_us"] == round(
        1e6 * bound.bytes / ops_roofline.BYTES_PER_S, 1)
    assert ev["counted_serial_speed_of_light_us"] == round(
        1e6 * bound.ops / ops_roofline.FP32_OPS_PER_S, 1)
    assert ev["arithmetic_intensity_flops_per_hbm_byte"] == round(
        bound.ops / bound.bytes, 1)
    assert out["peaks_assumed"] == {"fp32_tflops": 67.0, "hbm_tb_s": 3.35}
    assert out["metric"] == "roofline_cpu_rehearsal"
    for key in ("achieved_mxu_tflops", "achieved_vpu_tflops",
                "pct_of_mxu_highest_peak", "pct_of_vpu_peak",
                "mxu_flops_per_lane", "vpu_flops_per_lane"):
        assert key not in ev
    fused = out["fused_solve"]
    assert fused["live_steps"] > 0 and fused["bound_by"] == "operations"
    assert {"steps_per_sec_millions", "time_ms",
            "achieved_fp32_tflops", "pct_of_fp32_peak",
            "pct_of_bound"} <= set(fused)


ABLATE_FLAGS = ("WB_ABLATE_LADDER1", "WB_ABLATE_DIR_FORWARD", "WB_ABLATE_FK",
                "WB_ABLATE_OBSFIELD", "WB_ABLATE_PULLBACK")


def test_ablation_flags_are_build_flags_only():
    """Each flag sits in the warp body under an #ifdef; the default
    library's flags define none; each variant builds fused_solve.cu with
    its one flag into its own path under build/variants."""
    with open(os.path.join(_build.CSRC, "warp_body.cuh")) as f:
        body = f.read()
    for flag in ABLATE_FLAGS:
        assert f"#ifdef {flag}" in body or f"#ifndef {flag}" in body, flag
        assert not any(flag in x for x in _build.flags(3))
    assert sorted(epilogue.VARIANTS.values()) == sorted(ABLATE_FLAGS)
    paths = {_build.variant_path(3, (f,)) for f in ABLATE_FLAGS}
    assert len(paths) == 5 and _build.library_path(3) not in paths
    assert all(os.path.dirname(p) == _build.VARIANT_DIR for p in paths)
    assert _build.VARIANT_SOURCES == ("fused_solve.cu",)


def test_epilogue_cpu_rehearsal():
    """On the CPU only the plain version of the full program runs (the
    ablated builds are CUDA kernels), with JAX's keys."""
    with contextlib.redirect_stderr(io.StringIO()):
        out = epilogue.run(["--device", "cpu", "--batch", "2",
                            "--repeats", "1"])
    assert out["metric"] == "bls_step_phase_shares"
    assert list(out["times_ms"]) == ["full"] and out["share_of_step"] == {}
    work = out["plain_work_per_lane"]
    assert work["rungs"] >= work["steps"] > 0
    assert out["k1_work_per_lane"]["full"]["accepted_steps"] > 0


def test_rbf_kernels_match_jax():
    """rkhs.rbf_kernel / d_rbf_kernel against JAX's on float32 inputs
    (numpy, seed 0): bit for bit (XLA's exp, xla_order.exp), also where
    XLA's exp underflows and flushes the subnormals to zero."""
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-1, 2, 4096).astype(np.float32)
    x2 = rng.uniform(-1, 2, 4096).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    for var in (0.1, 0.2, 0.37):
        jk = np.asarray(jrkhs.rbf_kernel(x1, x2, var))
        jd = np.asarray(jrkhs.d_rbf_kernel(x1, x2, var))
        tk = trkhs.rbf_kernel(x1, x2, var)
        td = trkhs.d_rbf_kernel(x1, x2, var)
        assert tk.dtype == td.dtype == np.float32
        normal = np.abs(jk) >= tiny

        def ulps(a, b):
            return np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64))

        assert ulps(tk, jk).max() == 0 and ulps(td, jd).max() == 0
        assert (jk[~normal] == 0).all() and (tk[~normal] == 0).all()
