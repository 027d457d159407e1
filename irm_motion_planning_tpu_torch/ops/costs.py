"""The five cost terms, the total penalized cost and the constraint checks
for a single scenario (counterpart of irm_motion_planning_tpu/ops/costs.py,
forward only: the fused solve kernel computes its own gradient).

Layouts: trajectory and velocity ``(T, J)``, workspace points ``(2, T)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PlannerConfig
from ..models import robot
from ..models.rkhs import Basis, evaluate
from .scenario import Scenario


class Penalty(NamedTuple):
    """Penalty-method multipliers (scalars, or (B,) per lane)."""

    lambda_sg: torch.Tensor
    lambda_jl: torch.Tensor


def initial_penalty(cfg: PlannerConfig, device=None) -> Penalty:
    return Penalty(
        torch.tensor(cfg.lambda_sg_constraint, dtype=torch.float32, device=device),
        torch.tensor(cfg.lambda_jl_constraint, dtype=torch.float32, device=device),
    )


def obstacle_cost_v(f: torch.Tensor, obstacles: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """Per-timestep obstacle repulsion ``sum_o w_o 0.8 / (0.5 + 0.5 |f_t -
    o|^2)``.  f (2, T), obstacles (O, 2), weight (O,) -> (T,)."""
    diff = f[:, :, None] - obstacles.T[:, None, :]      # (2, T, O)
    d2 = torch.sum(diff * diff, dim=0)                  # (T, O)
    per = 0.8 / (0.5 + 0.5 * d2)
    return torch.sum(per * weight, dim=1)


def trajectory_obstacle_cost(cfg: PlannerConfig, trajectory: torch.Tensor,
                             scn: Scenario) -> torch.Tensor:
    """Blended obstacle cost ``lam max_t + (1 - lam) mean_t`` of the
    end-effector path of a joint trajectory."""
    f = robot.fk(cfg, trajectory)
    cost_v = obstacle_cost_v(f, scn.obstacles, scn.obstacle_weight)
    lam = cfg.lambda_max_cost
    return lam * cost_v.max() + (1.0 - lam) * cost_v.mean()


def start_goal_cost(trajectory, start, goal):
    s, g = trajectory[0], trajectory[-1]
    return 0.5 * torch.sum((s - start) ** 2) + 0.5 * torch.sum((g - goal) ** 2)


def start_goal_velocity_cost(velocity):
    return 0.5 * torch.sum(velocity[0] ** 2) + 0.5 * torch.sum(velocity[-1] ** 2)


def _joint_pos_stats(cfg: PlannerConfig):
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    return mean, std


def joint_position_limit_cost(cfg: PlannerConfig, trajectory):
    """Quadratic barrier from the joint-box centre, counted only where the
    trajectory leaves the safety fraction of the box."""
    mean, std = _joint_pos_stats(cfg)
    loss = 0.5 * ((trajectory - mean) / std) ** 2
    if cfg.constraint_violating_dependant_loss:
        mask = (trajectory > cfg.joint_safety_limit * cfg.max_joint_position) | (
            trajectory < cfg.joint_safety_limit * cfg.min_joint_position
        )
        loss = torch.where(mask, loss, 0.0)
    return torch.sum(loss) / cfg.n_timesteps


def joint_velocity_limit_cost(cfg: PlannerConfig, velocity):
    loss = 0.5 * (velocity / cfg.max_joint_velocity) ** 2
    if cfg.constraint_violating_dependant_loss:
        mask = velocity.abs() > cfg.joint_safety_limit * cfg.max_joint_velocity
        loss = torch.where(mask, loss, 0.0)
    return torch.sum(loss) / cfg.n_timesteps


def total_cost(cfg: PlannerConfig, basis: Basis, scn: Scenario,
               penalty: Penalty, alpha: torch.Tensor) -> torch.Tensor:
    """Total penalized cost of coefficients alpha (T, J)."""
    trajectory, velocity = evaluate(cfg, basis, alpha)
    toc = trajectory_obstacle_cost(cfg, trajectory, scn)
    sgpc = start_goal_cost(trajectory, scn.start, scn.goal)
    sgvc = start_goal_velocity_cost(velocity)
    jpc = joint_position_limit_cost(cfg, trajectory)
    jvc = joint_velocity_limit_cost(cfg, velocity)
    return toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)


def constraints_fulfilled(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                          alpha: torch.Tensor) -> torch.Tensor:
    """True when all four hard constraints hold (ref: trajectory.py:129-137)."""
    return constraint_report(cfg, basis, scn, alpha)["all_ok"]


def constraint_report(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                      alpha: torch.Tensor) -> dict:
    """Per-constraint diagnostics with the measured norms."""
    trajectory, velocity = evaluate(cfg, basis, alpha)
    rep = {
        "start_pos_err": torch.linalg.norm(trajectory[0] - scn.start),
        "goal_pos_err": torch.linalg.norm(trajectory[-1] - scn.goal),
        "start_vel": torch.linalg.norm(velocity[0]),
        "goal_vel": torch.linalg.norm(velocity[-1]),
        "traj_max": trajectory.max(),
        "traj_min": trajectory.min(),
        "vel_abs_max": velocity.abs().max(),
        "pos_ok": robot.start_goal_position_ok(
            cfg, trajectory[0], trajectory[-1], scn.start, scn.goal
        ),
        "vel_ok": robot.start_goal_velocity_ok(cfg, velocity[0], velocity[-1]),
        "limit_ok": robot.joint_position_ok(cfg, trajectory),
        "vel_limit_ok": robot.joint_velocity_ok(cfg, velocity),
    }
    rep["all_ok"] = (
        rep["pos_ok"] & rep["vel_ok"] & rep["limit_ok"] & rep["vel_limit_ok"]
    )
    return rep


def solution_quality(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                     alpha: torch.Tensor) -> dict:
    """The quality-gate readout: unpenalized obstacle cost under both
    lambda_max extremes and the worst endpoint error; compare with
    config.REFERENCE_FINAL_COST."""
    zero = torch.zeros((), dtype=torch.float32, device=alpha.device)
    pen0 = Penalty(zero, zero)
    avg = total_cost(cfg.replace(lambda_max_cost=0.0), basis, scn, pen0, alpha)
    mx = total_cost(cfg.replace(lambda_max_cost=1.0), basis, scn, pen0, alpha)
    rep = constraint_report(cfg, basis, scn, alpha)
    return {
        "avg_cost": avg,
        "max_cost": mx,
        "endpoint_err": torch.maximum(rep["start_pos_err"], rep["goal_pos_err"]),
    }
