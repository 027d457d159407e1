"""Static visualization: workspace cost contours, environment, results
(counterpart of irm_motion_planning_tpu/visualization/plots.py).

* reads the reference's text formats (trajectory_result.txt,
  trajectory_series.txt; utils/io.py writes them),
* the cost contour grid is ONE batched evaluation of the port's
  ``obstacle_cost_v`` over the whole grid, on the card by default
  (``device="cpu"`` for the CPU),
* matplotlib is imported lazily with the Agg backend, inside the drawing
  functions only: the grids need no matplotlib.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import PlannerConfig
from ..device import resolve
from ..models import robot
from ..ops.costs import obstacle_cost_v, obstacle_cost_vg
from ..ops.scenario import Scenario


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _grid_points(extent: float, resolution: int, device):
    """The grid axes and its points (2, res*res) in float32 on ``device``."""
    xs = np.linspace(-extent, extent, resolution)
    ys = np.linspace(-extent, extent, resolution)
    gx, gy = np.meshgrid(xs, ys)
    pts = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()]),
                          dtype=torch.float32, device=device)
    return xs, ys, pts


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def cost_grid(scn: Scenario, extent: float = 4.0, resolution: int = 81,
              device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Workspace obstacle-cost field on a grid — one vectorized evaluation
    on ``device`` (the card by default).  Returns (xs, ys, cost[res, res])."""
    dev = resolve(device)
    xs, ys, pts = _grid_points(extent, resolution, dev)
    cost = obstacle_cost_v(pts, scn.obstacles.to(dev),
                           scn.obstacle_weight.to(dev))
    return xs, ys, _np(cost).reshape(resolution, resolution)


def cost_gradient_grid(scn: Scenario, extent: float = 4.0,
                       resolution: int = 21, device=None):
    """Negative cost-gradient field for quiver plots, (xs, ys, g[2, res,
    res]), on ``device`` (the card by default)."""
    dev = resolve(device)
    xs, ys, pts = _grid_points(extent, resolution, dev)
    _, grad = obstacle_cost_vg(pts, scn.obstacles.to(dev),
                               scn.obstacle_weight.to(dev))
    return xs, ys, -_np(grad).reshape(2, resolution, resolution)


def _fk(cfg: PlannerConfig, config, device) -> np.ndarray:
    """End-effector path (2, T) of joint configurations (T, J)."""
    return _np(robot.fk(cfg, torch.as_tensor(np.asarray(config),
                                             dtype=torch.float32,
                                             device=device)))


def draw_cost_contour(ax, scn: Scenario, extent: float = 4.0,
                      resolution: int = 81, show_obstacles: bool = True,
                      device=None):
    xs, ys, c = cost_grid(scn, extent, resolution, device)
    cf = ax.contourf(xs, ys, c, levels=20, cmap="viridis")
    if show_obstacles:
        live = _np(scn.obstacle_weight) > 0
        obs = _np(scn.obstacles)
        ax.scatter(obs[live, 0], obs[live, 1], c="red", marker="x", s=30,
                   label="obstacles")
    return cf


def arm_polyline(cfg: PlannerConfig, config, device=None):
    """The base and every joint of one arm pose at ``config`` (J,): (xs,
    ys) lists of J + 1 points."""
    pts = _np(robot.fk_all_joints(cfg, torch.as_tensor(
        np.asarray(config), dtype=torch.float32,
        device=resolve(device))[None, :]))                     # (J, 2, 1)
    return ([0.0] + [float(pts[k, 0, 0]) for k in range(cfg.n_joints)],
            [0.0] + [float(pts[k, 1, 0]) for k in range(cfg.n_joints)])


def draw_arm(ax, cfg: PlannerConfig, config: np.ndarray, device=None, **kw):
    """Draw one arm pose (all links) at joint configuration ``config`` (J,)."""
    ax.plot(*arm_polyline(cfg, config, device), marker="o", **kw)


def plot_environment(
    cfg: PlannerConfig,
    scn: Scenario,
    out_path: str = "environment.png",
    show_gradient: bool = False,
    trajectory: Optional[np.ndarray] = None,
    show_legend: bool = True,
    show_sgb: bool = True,
    show_sg_robot: bool = True,
    show_obstacles: bool = False,
    show_straight_line: bool = True,
    show_final_ee: bool = True,
    show_final_robot: bool = False,
    device=None,
):
    """Environment overview (ref: visualization/env_vis.py): cost contour
    with the reference's full toggle set (ref: env_vis.py:45-52 — legend /
    start-goal markers / start-goal arm poses / obstacle scatter / straight
    line / gradient quiver / final EE path / final arm poses)."""
    plt = _plt()
    dev = resolve(device)
    fig, ax = plt.subplots(figsize=(8, 8))
    draw_cost_contour(ax, scn, show_obstacles=show_obstacles, device=dev)
    if show_gradient:
        xs, ys, g = cost_gradient_grid(scn, device=dev)
        gx, gy = np.meshgrid(xs, ys)
        ax.quiver(gx, gy, g[0], g[1], color="white", alpha=0.6)
    start, goal = _np(scn.start), _np(scn.goal)
    start_ee = _fk(cfg, start[None, :], dev)[:, 0]
    goal_ee = _fk(cfg, goal[None, :], dev)[:, 0]
    if show_sgb:
        ax.scatter(*start_ee, c="lime", s=60, zorder=5, label="start")
        ax.scatter(*goal_ee, c="orange", s=60, zorder=5, label="goal")
    if show_straight_line:
        # The reference's "straight line" is straight in JOINT space — the
        # quintic-smoothstep interpolation the optimizer warm-starts from —
        # whose FK image is a curve in the workspace (ref: env_vis.py:169-174).
        t = np.linspace(0.0, 1.0, 50)
        c = (6 * t**5 - 15 * t**4 + 10 * t**3)[:, None]  # ref: trajectory.py:38
        line = start[None, :] + c * (goal - start)[None, :]
        ee_line = _fk(cfg, line, dev)
        ax.plot(ee_line[0], ee_line[1], "w--", lw=1, label="straight line")
    if show_sg_robot:
        draw_arm(ax, cfg, start, dev, color="lime", label="start pose")
        draw_arm(ax, cfg, goal, dev, color="orange", label="goal pose")
    if trajectory is not None:
        traj = np.asarray(trajectory)
        if show_final_ee:
            ee = _fk(cfg, traj, dev)
            ax.plot(ee[0], ee[1], "w-", lw=2, label="EE path")
        if show_final_robot:
            T = traj.shape[0]
            for t in range(0, T, max(1, T // 12)):
                draw_arm(ax, cfg, traj[t], dev, alpha=0.15 + 0.85 * t / T,
                         color="tab:cyan")
    ax.set_aspect("equal")
    if show_legend:
        ax.legend(loc="upper left")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_result(
    cfg: PlannerConfig,
    scn: Scenario,
    trajectory: np.ndarray,
    out_path: str = "result.png",
    device=None,
):
    """2x3 result figure (ref: visualization/visualization.py): contour +
    straight-line vs final EE path; arm poses over time; per-timestep
    obstacle cost; joint positions; finite-difference joint velocities."""
    plt = _plt()
    dev = resolve(device)
    traj = np.asarray(trajectory)
    T = traj.shape[0]
    ee = _fk(cfg, traj, dev)
    fig, axes = plt.subplots(2, 3, figsize=(18, 10))

    ax = axes[0, 0]
    draw_cost_contour(ax, scn, device=dev)
    start_ee = _fk(cfg, _np(scn.start)[None, :], dev)[:, 0]
    goal_ee = _fk(cfg, _np(scn.goal)[None, :], dev)[:, 0]
    ax.plot([start_ee[0], goal_ee[0]], [start_ee[1], goal_ee[1]],
            "w--", lw=1, label="straight line")
    ax.plot(ee[0], ee[1], "r-", lw=2, label="EE path")
    ax.scatter(*start_ee, c="lime", s=60, zorder=5, label="start")
    ax.scatter(*goal_ee, c="orange", s=60, zorder=5, label="goal")
    ax.set_aspect("equal")
    ax.set_title("workspace cost + EE path")
    ax.legend(loc="upper left", fontsize=8)

    ax = axes[0, 1]
    for t in range(0, T, max(1, T // 12)):
        draw_arm(ax, cfg, traj[t], dev, alpha=0.15 + 0.85 * t / T,
                 color="tab:blue")
    ax.set_aspect("equal")
    ax.set_title("arm poses over time")

    ax = axes[0, 2]
    cost_t = _np(obstacle_cost_v(
        torch.as_tensor(ee, device=dev), scn.obstacles.to(dev),
        scn.obstacle_weight.to(dev)))
    ax.plot(cost_t)
    ax.set_title("per-timestep obstacle cost")
    ax.set_xlabel("timestep")

    ax = axes[1, 0]
    for j in range(cfg.n_joints):
        ax.plot(traj[:, j], label=f"joint {j+1}")
    ax.axhline(cfg.max_joint_position, color="r", ls="--", lw=0.8)
    ax.axhline(cfg.min_joint_position, color="r", ls="--", lw=0.8)
    ax.set_title("joint positions")
    ax.legend(fontsize=8)

    ax = axes[1, 1]
    # finite-difference velocities like the reference
    # (ref: visualization/visualization.py:155)
    fd_vel = np.diff(traj, axis=0) * (T - 1)
    for j in range(cfg.n_joints):
        ax.plot(fd_vel[:, j], label=f"joint {j+1}")
    ax.axhline(cfg.max_joint_velocity, color="r", ls="--", lw=0.8)
    ax.axhline(-cfg.max_joint_velocity, color="r", ls="--", lw=0.8)
    ax.set_title("joint velocities (finite difference)")
    ax.legend(fontsize=8)

    ax = axes[1, 2]
    ax.axis("off")
    ax.text(0.02, 0.8, f"T={T}  J={cfg.n_joints}", fontsize=12)
    ax.text(0.02, 0.6, f"max |v| = {np.abs(fd_vel).max():.3f}", fontsize=12)
    ax.text(0.02, 0.4, f"max obstacle cost = {cost_t.max():.3f}", fontsize=12)

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
