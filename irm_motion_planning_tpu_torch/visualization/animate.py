"""Animations: robot movement sweep and optimization-series evolution
(counterpart of irm_motion_planning_tpu/visualization/animate.py; ref:
visualization/visualize_robotmovement.py — the arm sweeping the final
trajectory to a GIF; visualize_series.py — how the trajectory evolves over
optimizer iterations, from trajectory_series.txt).
"""

from __future__ import annotations

import numpy as np

from ..config import PlannerConfig
from ..device import resolve
from ..ops.scenario import Scenario
from .plots import _fk, _plt, arm_polyline, draw_cost_contour


def animate_robot_movement(
    cfg: PlannerConfig,
    scn: Scenario,
    trajectory: np.ndarray,
    out_path: str = "trajectory_robotmovement.gif",
    fps: int = 20,
    device=None,
):
    """Animate the arm sweeping the final trajectory
    (ref: visualize_robotmovement.py:209-220, PillowWriter @ 20 fps)."""
    plt = _plt()
    from matplotlib.animation import FuncAnimation, PillowWriter

    dev = resolve(device)
    traj = np.asarray(trajectory)
    T = traj.shape[0]
    ee = _fk(cfg, traj, dev)

    fig, ax = plt.subplots(figsize=(7, 7))
    draw_cost_contour(ax, scn, device=dev)
    ax.plot(ee[0], ee[1], "w--", lw=1)
    (line,) = ax.plot([], [], "o-", color="tab:red", lw=3)
    ax.set_aspect("equal")

    def update(t):
        line.set_data(*arm_polyline(cfg, traj[t], dev))
        return (line,)

    anim = FuncAnimation(fig, update, frames=T, blit=True)
    anim.save(out_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return out_path


def animate_series(
    cfg: PlannerConfig,
    scn: Scenario,
    series: np.ndarray,
    out_path: str = "trajectory_series.gif",
    fps: int = 10,
    device=None,
):
    """Animate trajectory evolution across optimizer iterations
    (ref: visualize_series.py:211-232).  ``series``: (n_iters, T, J)."""
    plt = _plt()
    from matplotlib.animation import FuncAnimation, PillowWriter

    dev = resolve(device)
    series = np.asarray(series)
    n = series.shape[0]

    fig, ax = plt.subplots(figsize=(7, 7))
    draw_cost_contour(ax, scn, device=dev)
    (line,) = ax.plot([], [], "r-", lw=2)
    title = ax.set_title("")
    ax.set_aspect("equal")

    def update(i):
        ee = _fk(cfg, series[i], dev)
        line.set_data(ee[0], ee[1])
        title.set_text(f"iteration {i}/{n-1}")
        return (line, title)

    anim = FuncAnimation(fig, update, frames=n, blit=False)
    anim.save(out_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
