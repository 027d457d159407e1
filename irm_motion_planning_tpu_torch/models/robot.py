"""Planar n-link arm: forward kinematics and the hard-constraint predicates
(counterpart of irm_motion_planning_tpu/models/robot.py).

Layouts follow the JAX package: configurations ``(T, J)``, workspace points
``(2, T)``.
"""

from __future__ import annotations

import torch

from ..config import PlannerConfig


def link_lengths(cfg: PlannerConfig, device=None) -> torch.Tensor:
    return torch.tensor(cfg.link_length, dtype=torch.float32, device=device)


def fk(cfg: PlannerConfig, config: torch.Tensor) -> torch.Tensor:
    """End-effector xy per timestep: ``L @ [cos, sin](cumsum(theta))``.
    config (T, J) -> (2, T)."""
    c = torch.cumsum(config.reshape(-1, cfg.n_joints), dim=1)
    ll = link_lengths(cfg, config.device)
    return torch.stack((torch.cos(c) @ ll, torch.sin(c) @ ll))


def start_goal_position_ok(cfg: PlannerConfig, s, g, start_config, goal_config):
    start_ok = torch.linalg.norm(s - start_config) < cfg.eps_position
    goal_ok = torch.linalg.norm(g - goal_config) < cfg.eps_position
    return start_ok & goal_ok


def start_goal_velocity_ok(cfg: PlannerConfig, vs, vg):
    start_ok = torch.linalg.norm(vs) < cfg.eps_velocity
    goal_ok = torch.linalg.norm(vg) < cfg.eps_velocity
    return start_ok & goal_ok


def joint_position_ok(cfg: PlannerConfig, trajectory):
    return (trajectory.max() <= cfg.max_joint_position) & (
        trajectory.min() >= cfg.min_joint_position
    )


def joint_velocity_ok(cfg: PlannerConfig, joint_velocity):
    return joint_velocity.abs().max() <= cfg.max_joint_velocity
