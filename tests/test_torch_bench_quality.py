"""The port's quality gate and its seed sweep (irm_motion_planning_tpu_torch
/benchmarks/quality.py, quality_sweep.py) against the JAX package's
scripts (benchmarks/quality.py, quality_sweep.py, loaded by file path), on
the CPU.

``summarize`` is held to JAX's on the same solve: JAX's ``xla`` engine on
32 random scenes at a short budget, its alpha, scenes and stats crossed
over as numpy, so every field compares the two packages' readouts of one
trajectory.  The sweep's deltas and sign flips are held to the JAX
script's on canned per-seed rows (its solver and scenes stubbed out, its
own delta code run as it is).
"""

import contextlib
import io
import json
import sys

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import fleet as jfleet

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.benchmarks import quality, quality_sweep
from irm_motion_planning_tpu_torch.solvers.common import (SolveResult,
                                                          SolveStats)

from jax_scripts import load_jax_script

SHORT = dict(bls_mode="ladder", fixed_iters=True, max_inner_iteration=6,
             max_outer_iteration=2)
B = 32
# summarize on one crossed-over solve (32 scenes, 2 x 6 steps, PRNGKey(0)),
# measured: the fractions and mean inner steps equal; the rounded costs
# equal or one unit of their last place (1e-4) apart; endpoint_err_p90
# 0.16463 against 0.16466 (1.8e-4 relative).  Both sides evaluate the same
# alpha in float32 with the basis products summed in another order, and
# the endpoint rows are where the products cancel coefficients of O(1e3)
# down to O(1) (ROADMAP queue 3, fact 7: ~1e-4 relative); JAX rounds the
# same values to 4 or 5 decimals.
COST_TOL = 1.01e-4
ENDPOINT_REL_TOL = 3e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_quality():
    return load_jax_script("quality")


@pytest.fixture(scope="module")
def crossed(jax_quality):
    """JAX's xla solve of B random scenes and the same solve as the port's
    tensors."""
    jcfg = mp.PlannerConfig(**SHORT)
    jb = mp.make_basis(jcfg)
    scns = mp.random_scenarios(jcfg, jax.random.PRNGKey(0), B)
    res = jax.block_until_ready(
        jfleet.make_fleet_solver(jcfg, jb, backend="xla")(scns))
    want = jax_quality.summarize(jcfg, jb, scns, res)
    tcfg = mt.PlannerConfig(**SHORT)
    tb = mt.basis_from_numpy({k: np.asarray(getattr(jb, k))
                              for k in jb._fields}, device="cpu")
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    tscns = mt.Scenario(*(t(x) for x in scns))
    tres = SolveResult(t(res.alpha), SolveStats(*(t(x) for x in res.stats)))
    return want, quality.summarize(tcfg, tb, tscns, tres)


def test_summarize_matches_jax(crossed):
    want, got = crossed
    print(json.dumps({"jax": want, "port": got}))
    assert list(got) == list(want)
    for k in ("converged_frac", "exact_converged_frac", "phantom_frac",
              "mean_inner_steps"):
        assert got[k] == want[k], k
    for k in ("avg_cost_mean", "avg_cost_p50", "avg_cost_p90",
              "max_cost_mean", "max_cost_p90"):
        assert abs(got[k] - want[k]) <= COST_TOL, k
    assert abs(got["endpoint_err_p90"] - want["endpoint_err_p90"]) <= (
        ENDPOINT_REL_TOL * want["endpoint_err_p90"])


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_quality_gate_against_itself_emits_jax_keys(crossed):
    """``--backends xla,xla`` passes, with the JAX script's keys (and the
    card's beside them)."""
    rc, out = _run(quality.main, ["--device", "cpu", "--batch", "16",
                                  "--inner", "3", "--backends", "xla,xla"])
    assert rc == 0 and out["pass"] is True
    assert {"metric", "batch", "backends", "pass"} <= set(out)
    assert out["metric"] == "quality_distribution_gate"
    assert out["device"] == "cpu" and out["power_limit"] is None
    assert list(out["backends"]["xla"]) == list(crossed[0])


def test_quality_gate_across_the_plain_versions():
    """The kernels' plain versions against the port's xla engine at the
    bench's schedule: the converged fraction within the script's band and
    the mean cost within 1% (the gate passes)."""
    rc, out = _run(quality.main, ["--device", "cpu", "--batch", "32",
                                  "--schedule", "--max-obstacles", "11",
                                  "--backends", "xla,fused,pallas"])
    rows = out["backends"]
    print(json.dumps(rows))
    base = rows["xla"]
    band = max(0.02, min(0.15 * base["converged_frac"], 0.05))
    for b in ("fused", "pallas"):
        assert abs(rows[b]["converged_frac"] - base["converged_frac"]) <= band
        assert abs(rows[b]["avg_cost_mean"] / base["avg_cost_mean"] - 1) <= (
            0.01)
        assert rows[b]["phantom_frac"] == 0.0
    assert rc == 0 and out["pass"] is True


def test_quality_refuses_what_the_port_does_not_run():
    with pytest.raises(NotImplementedError):
        quality.quality_config(exact_constraint_eval=False)
    quality.quality_config(ladder_eval="exact", exact_constraint_eval=False)
    if not torch.cuda.is_available():
        # No card: the default device is refused, never replaced by the CPU.
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            quality.main(["--batch", "4"])
        assert e.value.code == 2


# Canned per-seed converged fractions and mean costs for the deltas: the
# first pair's delta changes sign across the seeds, the second's does not.
CANNED = {
    0: {"a": (0.50, 2.0), "b": (0.52, 2.01), "c": (0.55, 1.99)},
    1: {"a": (0.40, 2.1), "b": (0.37, 2.08), "c": (0.41, 2.1)},
    2: {"a": (0.45, 1.9), "b": (0.45, 1.9), "c": (0.47, 1.93)},
}


def _row(conv, cost):
    return {"converged_frac": conv, "avg_cost_mean": cost}


def test_sweep_deltas_match_jax(monkeypatch):
    """The port's deltas against the JAX script's own on the same rows:
    its solver, scenes and summarize stubbed to hand back CANNED."""
    jqs = load_jax_script("quality_sweep")
    calls = iter([(s, b) for s in CANNED for b in "abc"])

    class Runner:
        def make_fleet_solver(self, *a, **k):
            return lambda scns: 0

    monkeypatch.setattr(jqs, "fleet", Runner())
    monkeypatch.setattr(jqs.mp, "random_scenarios", lambda *a: None)
    monkeypatch.setattr(jqs.mp, "make_basis", lambda cfg: None)

    def summarize(*a):
        seed, b = next(calls)
        return _row(*CANNED[seed][b])

    monkeypatch.setattr(jqs, "summarize", summarize)
    monkeypatch.setattr(sys, "argv", ["quality_sweep", "--seeds", "0,1,2",
                                      "--backends", "a,b,c"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jqs.main() == 0
    want = json.loads(out.getvalue().strip().splitlines()[-1])["deltas"]
    per_seed = [{"seed": s, **{b: _row(*v) for b, v in CANNED[s].items()}}
                for s in CANNED]
    got = quality_sweep.deltas(per_seed, ["a", "b", "c"])
    assert got == want
    assert got["b-a"]["sign_flips"] and not got["c-a"]["sign_flips"]


def test_sweep_emits_jax_keys(crossed):
    out = quality_sweep.run(["--device", "cpu", "--seeds", "0,1",
                             "--batch", "8", "--backends", "xla,fused",
                             "--max-obstacles", "11"])
    assert {"metric", "batch", "solver", "schedule", "per_seed",
            "deltas"} <= set(out)
    assert out["metric"] == "quality_seed_sweep"
    assert [r["seed"] for r in out["per_seed"]] == [0, 1]
    assert list(out["per_seed"][0]["fused"]) == list(crossed[0])
    d = out["deltas"]["fused-xla"]
    assert set(d) == {"converged_frac_delta_per_seed",
                      "converged_frac_delta_mean", "sign_flips",
                      "avg_cost_delta_per_seed"}
    dc = d["converged_frac_delta_per_seed"]
    assert d["sign_flips"] == (min(dc) < 0 < max(dc))
