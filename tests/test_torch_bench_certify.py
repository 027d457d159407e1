"""The port's certification (irm_motion_planning_tpu_torch/benchmarks/
certify.py) against the JAX package's (benchmarks/certify.py, loaded by
file path), on the CPU: the oracle file's format both ways, the gap
statistics and the pass rule on fixed arrays, and the port's sequential
oracle against JAX's on the same 16 scenes.

The JAX oracle here is written by JAX's own ``run_oracle`` on 16 random
scenes at the bench's schedule.  The port's scenes are not JAX's for a
seed, so the comparison of the two oracles crosses JAX's scenes over as
numpy.  The port's sequential solver starts from JAX's warm start and
rounds the basis products in XLA's CPU order (models/warm_start.py,
models/xla_order.py), so it follows JAX's solve scene by scene; the two
oracles are compared as certify.py compares an engine with its oracle: by
converged fraction and mean cost.
"""

import argparse
import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.benchmarks import certify
from irm_motion_planning_tpu_torch.solvers.common import (SolveResult,
                                                          SolveStats)

from jax_scripts import load_jax_script

ORACLE_SCENES = 16
# The port's sequential oracle on JAX's 16 scenes (PRNGKey(0), the bench's
# schedule) against JAX's oracle on them, measured: converged 0.4375 as
# JAX's, mean avg cost -0.0022%, mean max cost +0.020% (before the port
# took JAX's warm start and XLA's product order: 0.8125 against 0.4375,
# +0.81% and +0.28%; ROADMAP queue 3, fact 9, closed).  The 128 scenes of
# certify_oracle_cpu2048.npz: tests/test_torch_warm_start.py.
COST_REL_TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jcert():
    return load_jax_script("certify")


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*a)


@pytest.fixture(scope="module")
def jax_oracle(jcert, tmp_path_factory):
    """JAX's oracle file: its run_oracle on ORACLE_SCENES random scenes at
    the bench's schedule."""
    out = str(tmp_path_factory.mktemp("jax") / "oracle.npz")
    _quiet(jcert.run_oracle, argparse.Namespace(
        batch=ORACLE_SCENES, seed=0, max_obstacles=11, stopping="schedule",
        out=out, progress=False))
    return out


@pytest.fixture(scope="module")
def port_oracle(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port") / "oracle.npz")
    row = certify.run_oracle(ORACLE_SCENES, 0, 11, "schedule", out, "cpu")
    return out, row


def test_oracle_file_has_jax_keys_and_dtypes(port_oracle, jax_oracle):
    out, row = port_oracle
    got, want = np.load(out), np.load(jax_oracle)
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    assert str(got["stopping"]) == "schedule" and int(got["batch"]) == 16
    assert row["phase"] == "oracle" and row["nonfinite"] == 0


def test_jax_engine_reads_the_port_oracle(port_oracle, jcert):
    """JAX's engine phase (xla backend) on the port's oracle file."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        jcert.run_engine(argparse.Namespace(
            oracle=port_oracle[0], tiers="linearized", block_b=128,
            backend="xla", interpret=False))
    verdict = json.loads(out.getvalue().strip().splitlines()[-1])
    row = verdict["tiers"]["linearized"]
    assert row["batch"] == ORACLE_SCENES
    assert row["all"]["avg"]["n"] == ORACLE_SCENES


def test_port_engine_reads_the_jax_oracle(jax_oracle):
    """The port's engine phase (xla backend, both tiers) on JAX's oracle
    file, with JAX's keys."""
    with contextlib.redirect_stderr(io.StringIO()):
        out = certify.run_engine(jax_oracle, "xla", ("exact", "linearized"),
                                 device="cpu")
    assert {"metric", "oracle", "platform", "mean_bounds", "median_bounds",
            "tiers", "pass"} <= set(out)
    assert out["platform"] == "cpu"
    for tier in ("exact", "linearized"):
        row = out["tiers"][tier]
        assert row["batch"] == ORACLE_SCENES and row["tier"] == tier
        assert row["all"]["avg"]["n"] + row["nonfinite_excluded"] == 16


# Fixed per-scene outcomes for the statistics and the pass rule: a
# non-finite engine cost, scenes in every outcome class, and gaps that pass
# the linearized tier's bounds but not the exact tier's.
FIXED_REF = np.array([1.0, 2.0, 1.5, 2.5, 1.2, 3.0, 2.2, 1.8, 1.1, 2.9])
FIXED_OURS = FIXED_REF * np.array([1.004, 0.997, 1.0008, np.nan, 1.03,
                                   0.99, 1.0015, 1.0015, 0.95, 1.1])
FIXED_OC = np.array([1, 1, 1, 0, 1, 0, 1, 1, 0, 0], bool)
FIXED_EC = np.array([1, 1, 1, 1, 0, 1, 1, 1, 0, 1], bool)


def test_gap_stats_match_jax(jcert):
    for mask in (FIXED_OC & FIXED_EC, ~FIXED_OC, np.isfinite(FIXED_OURS),
                 np.zeros(10, bool), np.arange(10) == 2):
        want = jcert._gap_stats(FIXED_OURS, FIXED_REF, mask)
        # As JSON: a class holding the non-finite scene gives NaN on both
        # sides, which compares unequal to itself.
        got = certify.gap_stats(FIXED_OURS, FIXED_REF, mask)
        assert json.dumps(got) == json.dumps(want)


def test_engine_row_and_pass_rule_match_jax(jcert, jax_oracle, monkeypatch):
    """The whole engine row, outcome classes and pass rule included, on
    FIXED outcomes: each side's solve and cost readout stubbed to hand back
    the fixed arrays (JAX's run through its own jit/vmap), then the two
    rows compared bit for bit, for both tiers."""
    data = dict(np.load(jax_oracle))
    n = FIXED_REF.size
    for k in ("start", "goal", "obstacles", "obstacle_weight"):
        data[k] = data[k][:n]
    data.update(batch=np.int64(n), avg=FIXED_REF, max=FIXED_REF * 1.25,
                conv=FIXED_OC)
    path = os.path.join(os.path.dirname(jax_oracle), "fixed.npz")
    np.savez(path, **data)
    costs = np.stack([FIXED_OURS, FIXED_OURS * 1.25], axis=1)[:, None, :]

    class JaxRun:
        def make_fleet_solver(self, *a, **k):
            stats = argparse.Namespace(converged=jnp.asarray(FIXED_EC))
            return lambda scns: argparse.Namespace(
                alpha=jnp.asarray(costs), stats=stats)

    monkeypatch.setattr(jcert, "fleet", JaxRun())
    monkeypatch.setattr(jcert, "_scene_costs",
                        lambda cfg, basis, s, a: (a[0, 0], a[0, 1]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        jcert.run_engine(argparse.Namespace(
            oracle=path, tiers="exact,linearized", block_b=128,
            backend="xla", interpret=False))
    want = json.loads(out.getvalue().strip().splitlines()[-1])["tiers"]

    def fleet_solve(cfg, basis, scns, solver, backend):
        z = torch.zeros(n)
        return SolveResult(torch.tensor(costs),
                           SolveStats(z, z, torch.tensor(FIXED_EC), z))

    monkeypatch.setattr(certify.fleet, "fleet_solve", fleet_solve)
    monkeypatch.setattr(certify, "scene_costs",
                        lambda cfg, basis, s, a: (a[:, 0, 0].numpy(),
                                                  a[:, 0, 1].numpy()))
    got = {tier: certify.engine_row(np.load(path), tier, "xla", "cpu")
           for tier in ("exact", "linearized")}
    assert json.loads(json.dumps(got)) == want
    assert got["linearized"]["pass"] and not got["exact"]["pass"]


def test_port_oracle_against_jax_oracle(jax_oracle):
    """The port's sequential BLS on JAX's 16 scenes (crossed over) against
    JAX's oracle on them: the converged fraction within certify.py's
    CONV_SLACK and the mean avg and max cost within 1% (measured: the same
    converged fraction, costs within 0.02%)."""
    data = np.load(jax_oracle)
    cfg = certify.oracle_config(int(data["max_obstacles"]),
                                str(data["stopping"]))
    basis = mt.make_basis(cfg, device="cpu")
    avg, mx, conv = certify.oracle_solve(cfg, basis,
                                         certify.oracle_scenes(data, "cpu"))
    gap = abs(conv.mean() - data["conv"].mean())
    print(json.dumps({
        "converged": [float(conv.mean()), float(data["conv"].mean())],
        "converged_within_conv_slack": bool(gap <= certify.CONV_SLACK),
        "avg_mean_rel": float(avg.mean() / data["avg"].mean() - 1),
        "max_mean_rel": float(mx.mean() / data["max"].mean() - 1)}))
    assert np.isfinite(avg).all() and np.isfinite(mx).all()
    assert gap <= certify.CONV_SLACK
    assert abs(avg.mean() / data["avg"].mean() - 1) <= COST_REL_TOL
    assert abs(mx.mean() / data["max"].mean() - 1) <= COST_REL_TOL
