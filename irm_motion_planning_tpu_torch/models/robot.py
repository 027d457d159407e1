"""Planar n-link arm: forward kinematics, the analytic workspace Jacobian
and the hard-constraint predicates (counterpart of
irm_motion_planning_tpu/models/robot.py).

Layouts follow the JAX package: configurations ``(T, J)``, workspace points
``(2, T)``, Jacobian ``(2, T, J)``; every function also takes leading batch
axes, ``(..., T, J)`` to ``(..., 2, T)``, and reduces only over its own
axes, so a lane of a batch is computed as the lane alone.
"""

from __future__ import annotations

import torch

from ..config import PlannerConfig
from .lanes import lane_matmul


def link_lengths(cfg: PlannerConfig, device=None) -> torch.Tensor:
    return torch.tensor(cfg.link_length, dtype=torch.float32, device=device)


def cumsum_joints(x: torch.Tensor) -> torch.Tensor:
    """The running sum over the last (joint) axis, ((x_0 + x_1) + x_2) ...,
    one add per joint: torch.cumsum over an innermost axis of a few
    entries runs a scan kernel per row on the card, which dominated the
    single-scene engines' steps at 65,536 lanes."""
    acc = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        acc.append(acc[-1] + x[..., j])
    return torch.stack(acc, dim=-1)


def _angles(cfg: PlannerConfig, config: torch.Tensor) -> torch.Tensor:
    """Cumulative joint angles (..., T, J): link i points at theta_1 + ... +
    theta_i."""
    return cumsum_joints(
        config.reshape(config.shape[:-2] + (-1, cfg.n_joints)))


def _weigh(x: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """``x @ ll``, (..., T, J) by the link lengths (J,) -> (..., T)."""
    if x.dim() == 2:
        return x @ ll
    return lane_matmul(x, ll[:, None])[..., 0]


def fk(cfg: PlannerConfig, config: torch.Tensor) -> torch.Tensor:
    """End-effector xy per timestep: ``L @ [cos, sin](cumsum(theta))``.
    config (..., T, J) -> (..., 2, T)."""
    c = _angles(cfg, config)
    ll = link_lengths(cfg, config.device).to(config.dtype)
    return torch.stack((_weigh(torch.cos(c), ll), _weigh(torch.sin(c), ll)),
                       dim=-2)


def fk_joint(cfg: PlannerConfig, config: torch.Tensor,
             joint_id: int) -> torch.Tensor:
    """Position of joint ``joint_id`` (1-based, the tip of link joint_id)
    per timestep.  (..., T, J) -> (..., 2, T)."""
    c = _angles(cfg, config)[..., :joint_id]
    ll = link_lengths(cfg, config.device).to(config.dtype)[:joint_id]
    return torch.stack((_weigh(torch.cos(c), ll), _weigh(torch.sin(c), ll)),
                       dim=-2)


def fk_all_joints(cfg: PlannerConfig, config: torch.Tensor) -> torch.Tensor:
    """Every joint's position in one pass: (..., T, J) -> (..., J, 2, T),
    entry k the tip of link k + 1."""
    c = _angles(cfg, config)
    ll = link_lengths(cfg, config.device).to(config.dtype)
    seg = torch.stack((torch.cos(c) * ll, torch.sin(c) * ll), dim=-3)
    return torch.movedim(cumsum_joints(seg), -1, -3)


def jacobian(cfg: PlannerConfig, config: torch.Tensor) -> torch.Tensor:
    """Analytic workspace Jacobian d(EE)/d(theta_j) per timestep,
    ``sum_{i >= j} L_i [-sin, cos](cumangle_i)`` (a reverse cumulative
    sum).  (..., T, J) -> (..., 2, T, J)."""
    c = _angles(cfg, config)
    ll = link_lengths(cfg, config.device).to(config.dtype)
    x = -ll * torch.sin(c)
    y = ll * torch.cos(c)
    rcx = x + x.sum(-1, keepdim=True) - cumsum_joints(x)
    rcy = y + y.sum(-1, keepdim=True) - cumsum_joints(y)
    return torch.stack((rcx, rcy), dim=-3)


# The predicates take one configuration (J,) per endpoint, or a leading
# batch of them, and return a bool per lane.


def start_goal_position_ok(cfg: PlannerConfig, s, g, start_config, goal_config):
    start_ok = torch.linalg.norm(s - start_config, dim=-1) < cfg.eps_position
    goal_ok = torch.linalg.norm(g - goal_config, dim=-1) < cfg.eps_position
    return start_ok & goal_ok


def start_goal_velocity_ok(cfg: PlannerConfig, vs, vg):
    start_ok = torch.linalg.norm(vs, dim=-1) < cfg.eps_velocity
    goal_ok = torch.linalg.norm(vg, dim=-1) < cfg.eps_velocity
    return start_ok & goal_ok


def joint_position_ok(cfg: PlannerConfig, trajectory):
    """trajectory (..., T, J)."""
    return (trajectory.amax(dim=(-2, -1)) <= cfg.max_joint_position) & (
        trajectory.amin(dim=(-2, -1)) >= cfg.min_joint_position
    )


def joint_velocity_ok(cfg: PlannerConfig, joint_velocity):
    """joint_velocity (..., T, J)."""
    return joint_velocity.abs().amax(dim=(-2, -1)) <= cfg.max_joint_velocity
