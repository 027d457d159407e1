"""The port's visualization (irm_motion_planning_tpu_torch/visualization)
against the JAX package's, under Agg: the cost grids element by element on
the reference scene, the four renders, and the CLI's four modes on files
the port's utils/io.py writes."""

import os

import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.utils import io as iolib

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from irm_motion_planning_tpu.visualization import plots as jplots  # noqa: E402

from irm_motion_planning_tpu_torch.visualization import (  # noqa: E402
    animate, cli as vis_cli, plots,
)

# The grids against JAX's on the reference scene, float32 both (measured
# at resolutions 21-81: within 2.3e-7 of each field's largest magnitude,
# a few ulp; about half the points bit for bit).
GRID_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = mt.PlannerConfig()
    scn = mt.reference_scenario(cfg, device="cpu")
    basis = mt.make_basis(cfg, device="cpu")
    alpha = mt.init_alpha(cfg, basis, scn.start, scn.goal)
    traj = mt.evaluate(cfg, basis, alpha)[0].numpy()
    return cfg, scn, traj


@pytest.mark.parametrize("grid", ["cost_grid", "cost_gradient_grid"])
def test_grids_against_jax(setup, grid):
    _, scn, _ = setup
    jscn = mp.reference_scenario(mp.PlannerConfig())
    xs, ys, got = getattr(plots, grid)(scn, resolution=41, device="cpu")
    jxs, jys, want = getattr(jplots, grid)(jscn, resolution=41)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - np.asarray(want)).max() / np.abs(want).max()
    assert err <= GRID_RTOL, err


def test_cost_grid_vectorized(setup):
    _, scn, _ = setup
    xs, ys, c = plots.cost_grid(scn, resolution=41, device="cpu")
    assert c.shape == (41, 41)
    assert np.isfinite(c).all() and (c > 0).all()
    assert c.max() > 3 * c.min()


def test_plot_result(tmp_path, setup):
    cfg, scn, traj = setup
    out = plots.plot_result(cfg, scn, traj, str(tmp_path / "r.png"),
                            device="cpu")
    assert os.path.getsize(out) > 10_000


def test_plot_environment_toggles(tmp_path, setup):
    """Each of the reference's toggles (ref: env_vis.py:45-52), flipped
    alone against the baseline, changes the figure."""
    cfg, scn, traj = setup
    base = plots.plot_environment(cfg, scn, str(tmp_path / "base.png"),
                                  trajectory=traj, device="cpu")
    base_bytes = open(base, "rb").read()
    assert len(base_bytes) > 10_000
    flips = {"show_legend": False, "show_sgb": False, "show_sg_robot": False,
             "show_obstacles": True, "show_straight_line": False,
             "show_final_ee": False, "show_final_robot": True,
             "show_gradient": True}
    for name, value in flips.items():
        out = plots.plot_environment(cfg, scn, str(tmp_path / f"{name}.png"),
                                     trajectory=traj, device="cpu",
                                     **{name: value})
        assert open(out, "rb").read() != base_bytes, f"{name} had no effect"


def test_animations(tmp_path, setup):
    cfg, scn, traj = setup
    out = animate.animate_robot_movement(cfg, scn, traj[::10],
                                         str(tmp_path / "m.gif"), fps=5,
                                         device="cpu")
    assert os.path.getsize(out) > 5_000
    series = np.stack([traj, traj * 0.9, traj * 0.8])
    out = animate.animate_series(cfg, scn, series, str(tmp_path / "s.gif"),
                                 fps=2, device="cpu")
    assert os.path.getsize(out) > 5_000


def test_vis_cli_modes(tmp_path, setup):
    """The CLI's four modes on the files utils/io.py writes (at T=25, the
    smallest committed basis, for short animations)."""
    _, scn, _ = setup
    cfg = mt.PlannerConfig(n_timesteps=25)
    basis = mt.make_basis(cfg, device="cpu")
    alpha = mt.init_alpha(cfg, basis, scn.start, scn.goal)
    result = tmp_path / "trajectory_result.txt"
    series = tmp_path / "trajectory_series.txt"
    iolib.save_trajectory_result(str(result), cfg, basis, alpha)
    iolib.save_trajectory_series(str(series), cfg, basis,
                                 [alpha, 0.9 * alpha])
    for mode, out, extra in (
            ("result", "r.png", []),
            ("env", "e.png", ["--vis-obstacles", "true",
                              "--vis-final-robot", "true",
                              "--vis-legend", "false"]),
            ("movement", "m.gif", []),
            ("series", "s.gif", [])):
        rc = vis_cli.main(["--device", "cpu", "--mode", mode,
                           "--n-timesteps", "25",
                           "--input", str(result),
                           "--series-input", str(series),
                           "--out", str(tmp_path / out)] + extra)
        assert rc == 0 and os.path.getsize(tmp_path / out) > 5_000, mode
