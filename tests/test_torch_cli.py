"""The port's CLI (irm_motion_planning_tpu_torch/cli.py) and the runtime
utilities under it (utils/io.py, utils/timing.py, solvers/plain.py) on the
CPU (``--device cpu``), the cases of tests/test_runtime.py's CLI, IO,
timing and plain-solver tests; the files each package writes read back by
the other's utils.io.

The CLI runs in-process through ``cli.main([...])`` in ``tmp_path``; one
case runs it as ``python -m``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
from irm_motion_planning_tpu.solvers import bls as jbls
from irm_motion_planning_tpu.utils import io as jio

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch import cli
from irm_motion_planning_tpu_torch.models import rkhs
from irm_motion_planning_tpu_torch.solvers import bls, plain
from irm_motion_planning_tpu_torch.utils import io as tio
from irm_motion_planning_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = dict(max_inner_iteration=30, max_outer_iteration=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: these tests run many small operations, which six
    parallel workers of multi-threaded torch slow several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _main(args, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return cli.main(["--device", "cpu"] + args)


def test_cli_single_solve(tmp_path, monkeypatch, capsys):
    assert _main(["--max-outer-iteration", "2", "--max-inner-iteration",
                  "20"], tmp_path, monkeypatch) == 0
    out = capsys.readouterr().out
    assert "result cost" in out and "took" in out
    arr = np.loadtxt(tmp_path / "trajectory_result.txt")
    assert arr.shape == (50, 3)


@pytest.mark.parametrize("engine,backend", [
    ("vmap", "xla"), ("fleet", "xla"), ("fleet", "fused"), ("fleet", "pallas")])
def test_cli_batched(tmp_path, monkeypatch, capsys, engine, backend):
    """--batch on each engine and fleet backend (the kernels' plain versions
    on the CPU)."""
    assert _main(["--batch", "4", "--engine", engine, "--backend", backend,
                  "--max-outer-iteration", "1", "--max-inner-iteration",
                  "10"], tmp_path, monkeypatch) == 0
    assert "batch 4" in capsys.readouterr().out


def test_cli_plain_loop_with_series(tmp_path, monkeypatch):
    """--jit-loop false --extended-vis true writes the series file; JAX's
    loader reads both files."""
    assert _main(["--jit-loop", "false", "--extended-vis", "true",
                  "--max-outer-iteration", "1", "--max-inner-iteration", "10",
                  "--optimizer-name", "gd"], tmp_path, monkeypatch) == 0
    cfg = mp.PlannerConfig()
    series = jio.load_trajectory_series(
        str(tmp_path / "trajectory_series.txt"), cfg)
    assert series.shape[1:] == (50, 3) and series.shape[0] >= 2
    traj = jio.load_trajectory_result(str(tmp_path / "trajectory_result.txt"))
    np.testing.assert_array_equal(series[-1], traj)


def test_cli_profiling_and_repeats(tmp_path, monkeypatch, capsys):
    """--profiling true writes torch.profiler's Chrome trace under
    ./torch-trace; --n-measurements 2 prints the mean and stddev."""
    assert _main(["--profiling", "true", "--n-measurements", "2",
                  "--max-outer-iteration", "1", "--max-inner-iteration", "3"],
                 tmp_path, monkeypatch) == 0
    assert "runtimes in ms: mean" in capsys.readouterr().out
    assert (tmp_path / "torch-trace" / "trace.json").stat().st_size > 0


def test_cli_rejects_fleet_sequential(tmp_path, monkeypatch, capsys):
    """--bls-mode sequential with --engine fleet exits 2 (the fleet engine
    is ladder-only; the flag is never silently ignored)."""
    assert _main(["--batch", "8", "--engine", "fleet", "--bls-mode",
                  "sequential", "--max-outer-iteration", "1",
                  "--max-inner-iteration", "2"], tmp_path, monkeypatch) == 2
    assert "sequential" in capsys.readouterr().err


def test_cli_rejects_schedule_without_fixed_iters(tmp_path, monkeypatch,
                                                  capsys):
    with pytest.raises(SystemExit) as e:
        _main(["--inner-schedule", "reference"], tmp_path, monkeypatch)
    assert e.value.code == 2
    assert "--fixed-iters" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--rbf-variance", "0.2"], ["--jac-gaussian-mean", "0.2"],
    ["--n-joints", "2", "--link-length", "1.5", "1.0", "--batch", "4",
     "--engine", "fleet", "--backend", "fused", "--random-scenarios",
     "true"]])
def test_cli_basis_flags_need_an_export(tmp_path, monkeypatch, flags):
    """A flag that changes a basis field (refused before the port built its
    own basis, for want of an export) runs on the basis make_basis builds
    for those fields: the solve exits 0 and writes a trajectory of the
    config's T and J.  The 2-link arm plans random scenes on the fleet
    engine (the reference scene is a 3-link arm's, in JAX's CLI too)."""
    calls = []
    real = rkhs.build_basis
    monkeypatch.setattr(rkhs, "build_basis",
                        lambda cfg, device=None: calls.append(cfg)
                        or real(cfg, device=device))
    assert _main(flags + ["--max-outer-iteration", "1",
                          "--max-inner-iteration", "3"],
                 tmp_path, monkeypatch) == 0
    assert calls, "make_basis did not build the flags' basis"
    J = 2 if "--n-joints" in flags else 3
    assert np.loadtxt(tmp_path / "trajectory_result.txt").shape == (50, J)


def test_cli_vmap_engine_honors_sequential(tmp_path, monkeypatch):
    assert _main(["--batch", "3", "--engine", "vmap", "--bls-mode",
                  "sequential", "--max-outer-iteration", "1",
                  "--max-inner-iteration", "2"], tmp_path, monkeypatch) == 0


def test_cli_flags_match_jax():
    """Every flag of the JAX CLI, with its default, except --platform,
    whose place --device takes."""
    from irm_motion_planning_tpu import cli as jcli

    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    jax_flags = flags(jcli.build_parser())
    port_flags = flags(cli.build_parser())
    assert jax_flags.pop("platform") == "auto"
    assert port_flags.pop("device") == "cuda"
    assert port_flags == jax_flags


def test_cli_module_runs(tmp_path):
    """``python -m irm_motion_planning_tpu_torch.cli`` as a user runs it."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "irm_motion_planning_tpu_torch.cli",
         "--device", "cpu", "--batch", "2", "--max-outer-iteration", "1",
         "--max-inner-iteration", "5"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "batch 2" in r.stdout
    assert (tmp_path / "trajectory_result.txt").exists()


@pytest.fixture(scope="module")
def short():
    cfg = mt.PlannerConfig(**SHORT)
    return (cfg, mt.make_basis(cfg, device="cpu"),
            mt.reference_scenario(cfg, device="cpu"))


def test_io_formats_cross_read(tmp_path, short):
    """The trajectory and series text files and the solve npz: what the
    port writes JAX's utils.io reads, value for value, and the other way
    round; the text is byte for byte what JAX writes for the same
    trajectory."""
    cfg, basis, scn = short
    alpha = mt.init_alpha(cfg, basis, scn.start, scn.goal)
    res = bls.solve(cfg, basis, scn)
    tpath, jpath = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    arr = tio.save_trajectory_result(tpath, cfg, basis, alpha)
    assert arr.shape == (cfg.n_timesteps, cfg.n_joints)
    np.testing.assert_array_equal(jio.load_trajectory_result(tpath), arr)
    np.savetxt(jpath, np.asarray(jax.numpy.asarray(arr)))
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    spath = str(tmp_path / "series.txt")
    tio.save_trajectory_series(spath, cfg, basis, [alpha, alpha * 1.1])
    jcfg = mp.PlannerConfig(**SHORT)
    assert jio.load_trajectory_series(spath, jcfg).shape == (2, 50, 3)
    npz = str(tmp_path / "port.npz")
    tio.save_solve_npz(npz, res)
    back = jio.load_solve_npz(npz)
    np.testing.assert_array_equal(np.asarray(back.alpha), res.alpha.numpy())
    for f, g in zip(back.stats, res.stats):
        assert np.asarray(f).dtype == g.numpy().dtype
        np.testing.assert_array_equal(np.asarray(f), g.numpy())
    jb = mp.make_basis(jcfg)
    jres = jax.jit(lambda s: jbls.solve(jcfg, jb, s))(
        mp.reference_scenario(jcfg))
    jnpz = str(tmp_path / "jax.npz")
    jio.save_solve_npz(jnpz, jres)
    mine = tio.load_solve_npz(jnpz)
    np.testing.assert_array_equal(mine.alpha.numpy(), np.asarray(jres.alpha))
    assert int(mine.stats.inner_iters) == int(jres.stats.inner_iters)
    assert mine.stats.converged.dtype == torch.bool


def test_timing_harness(short):
    cfg, basis, scn = short
    rep = timing.time_fn(lambda: bls.solve(cfg, basis, scn),
                         n_measurements=3, n_times=2)
    assert len(rep.per_measurement_ms) == 3
    assert rep.mean_ms > 0 and rep.stddev_ms >= 0 and rep.compile_ms > 0


def test_plain_solver_matches_engine_quality(short):
    """The Python-loop solver (--jit-loop false) reaches the engine's
    quality on the reference scene (within 5%, tests/test_runtime.py's
    bound)."""
    cfg, basis, scn = short
    r_eng = bls.solve(cfg, basis, scn)
    r_plain, series = plain.plain_solve(cfg, basis, scn, solver="bls")
    pen = mt.initial_penalty(cfg)
    c_e = float(mt.total_cost(cfg, basis, scn, pen, r_eng.alpha))
    c_p = float(mt.total_cost(cfg, basis, scn, pen, r_plain.alpha))
    assert abs(c_e - c_p) / abs(c_e) < 5e-2
    assert series is None


def test_plain_solver_records_series(short):
    cfg, basis, scn = short
    res, series = plain.plain_solve(cfg, basis, scn, solver="gd",
                                    record_series=True)
    assert series is not None and len(series) >= 2
    assert series[0].shape == (cfg.n_timesteps, cfg.n_joints)
    assert res.stats.inner_iters.dtype == torch.int32
