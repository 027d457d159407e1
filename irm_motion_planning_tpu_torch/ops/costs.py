"""The five cost terms, their hand-derived analytic gradients, the fused
cost and gradient, and the constraint checks (counterpart of
irm_motion_planning_tpu/ops/costs.py).

Layouts: trajectory and velocity ``(T, J)``, workspace points ``(2, T)``.
Every function also takes leading batch axes (trajectory ``(..., T, J)``,
the Scenario's fields ``(..., J)`` and ``(..., O, 2)``, penalties scalars or
``(...)``) and reduces only over a lane's own axes, so the single-scene
engines of solvers/ run a batch of scenes lane by lane.

The functions that evaluate the basis take ``order``, how the basis
products are rounded (models/rkhs.py ``PRODUCTS``): ``"matmul"`` by
default, ``"xla"`` in the single-scene solvers (the JAX package's bits).

``total_cost`` runs through :class:`TotalCost`, a ``torch.autograd.Function``
whose backward is the analytic gradient (the JAX package's ``custom_vjp``);
``total_cost_autodiff_only`` is the same forward without it, the oracle of
the gradient tests.  The gradients follow the reference exactly, its quirks
included: the first-argmax subgradient of the max-cost blend and the
violation-masked limit losses.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PlannerConfig
from ..models import robot
from ..models.lanes import basis_matmul, lane_matmul
from ..models.rkhs import PRODUCTS, Basis, evaluate
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


def _lanes(x: torch.Tensor, dims: int) -> torch.Tensor:
    """A per-lane value (...) viewed with ``dims`` trailing unit axes."""
    return x.reshape(x.shape + (1,) * dims) if torch.is_tensor(x) else x


# ---------------------------------------------------------------------------
# Obstacle (workspace) cost: inverse-quadratic repulsion summed over the
# obstacle set, cost_v[t] = sum_o w_o 0.8 / (0.5 + 0.5 |f_t - o|^2).
# ---------------------------------------------------------------------------


def _obstacle_diff(f: torch.Tensor, obstacles: torch.Tensor):
    """f (..., 2, T), obstacles (..., O, 2) -> (f - o) (..., 2, T, O)."""
    return f[..., :, :, None] - obstacles.transpose(-1, -2)[..., :, None, :]


def obstacle_cost_v(f: torch.Tensor, obstacles: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """Per-timestep obstacle repulsion.  f (..., 2, T), obstacles (..., O,
    2), weight (..., O) -> (..., T)."""
    diff = _obstacle_diff(f, obstacles)
    d2 = torch.sum(diff * diff, dim=-3)                 # (..., T, O)
    per = 0.8 / (0.5 + 0.5 * d2)
    return torch.sum(per * weight[..., None, :], dim=-1)


def obstacle_cost_vg(f: torch.Tensor, obstacles: torch.Tensor,
                     weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep obstacle cost and its gradient with respect to f:
    (cost_v (..., T), cost_g (..., 2, T)) (ref: environment.py:46-58)."""
    diff = _obstacle_diff(f, obstacles)
    d2 = torch.sum(diff * diff, dim=-3)
    inv = 1.0 / (0.5 + 0.5 * d2)
    cost_v = torch.sum(0.8 * inv * weight[..., None, :], dim=-1)
    # d per / d f = -0.8 (f - o) / (0.5 + 0.5 d2)^2
    cost_g = torch.sum((-0.8 * weight[..., None, None, :]) * diff
                       * (inv * inv)[..., None, :, :], dim=-1)
    return cost_v, cost_g


def blend_weights(cfg: PlannerConfig, cost_v: torch.Tensor) -> torch.Tensor:
    """Weights (..., T) of the max/mean blend's gradient: lambda_max on the
    FIRST argmax over T (torch.argmax returns the first, as jnp.argmax
    does), plus the mean's (1 - lambda_max) / T (ref: trajectory.py:97-105)."""
    T = cost_v.shape[-1]
    lam = cfg.lambda_max_cost
    rows = torch.arange(T, device=cost_v.device)
    onehot = (rows == cost_v.argmax(-1)[..., None]).to(cost_v.dtype)
    return lam * onehot + (1.0 - lam) / T


def trajectory_obstacle_cost(cfg: PlannerConfig, trajectory: torch.Tensor,
                             scn: Scenario) -> torch.Tensor:
    """Blended obstacle cost ``lam max_t + (1 - lam) mean_t`` of the
    end-effector path of a joint trajectory."""
    f = robot.fk(cfg, trajectory)
    cost_v = obstacle_cost_v(f, scn.obstacles, scn.obstacle_weight)
    lam = cfg.lambda_max_cost
    return lam * cost_v.amax(-1) + (1.0 - lam) * cost_v.mean(-1)


def trajectory_obstacle_cost_g(cfg: PlannerConfig, trajectory: torch.Tensor,
                               scn: Scenario) -> torch.Tensor:
    """Gradient of the blended obstacle cost with respect to the joint
    trajectory (..., T, J): the point gradient, blended, pulled back through
    the workspace Jacobian (ref: trajectory.py:91-126)."""
    f = robot.fk(cfg, trajectory)
    cost_v, cost_g = obstacle_cost_vg(f, scn.obstacles, scn.obstacle_weight)
    w = blend_weights(cfg, cost_v)
    jac = robot.jacobian(cfg, trajectory)
    return torch.einsum("...it,...itj->...tj", w[..., None, :] * cost_g, jac)


# ---------------------------------------------------------------------------
# Boundary (start/goal) costs (ref: trajectory.py:183-212).
# ---------------------------------------------------------------------------


def start_goal_cost(trajectory, start, goal):
    s, g = trajectory[..., 0, :], trajectory[..., -1, :]
    return (0.5 * torch.sum((s - start) ** 2, dim=-1)
            + 0.5 * torch.sum((g - goal) ** 2, dim=-1))


def start_goal_cost_g(trajectory, start, goal):
    grad = torch.zeros_like(trajectory)
    grad[..., 0, :] = trajectory[..., 0, :] - start
    grad[..., -1, :] = trajectory[..., -1, :] - goal
    return grad


def start_goal_velocity_cost(velocity):
    return (0.5 * torch.sum(velocity[..., 0, :] ** 2, dim=-1)
            + 0.5 * torch.sum(velocity[..., -1, :] ** 2, dim=-1))


def start_goal_velocity_cost_g(velocity):
    grad = torch.zeros_like(velocity)
    grad[..., 0, :] = velocity[..., 0, :]
    grad[..., -1, :] = velocity[..., -1, :]
    return grad


# ---------------------------------------------------------------------------
# Joint limit costs (ref: trajectory.py:215-268): a quadratic barrier from
# the joint-box centre, counted only where the trajectory leaves the safety
# fraction of the box.
# ---------------------------------------------------------------------------


def _joint_pos_stats(cfg: PlannerConfig):
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    return mean, std


def _position_violation_mask(cfg: PlannerConfig, trajectory):
    return (trajectory > cfg.joint_safety_limit * cfg.max_joint_position) | (
        trajectory < cfg.joint_safety_limit * cfg.min_joint_position
    )


def _velocity_violation_mask(cfg: PlannerConfig, velocity):
    return velocity.abs() > cfg.joint_safety_limit * cfg.max_joint_velocity


def joint_position_limit_cost(cfg: PlannerConfig, trajectory):
    mean, std = _joint_pos_stats(cfg)
    loss = 0.5 * ((trajectory - mean) / std) ** 2
    if cfg.constraint_violating_dependant_loss:
        loss = torch.where(_position_violation_mask(cfg, trajectory), loss, 0.0)
    return torch.sum(loss, dim=(-2, -1)) / cfg.n_timesteps


def joint_position_limit_cost_g(cfg: PlannerConfig, trajectory):
    mean, std = _joint_pos_stats(cfg)
    grad = (trajectory - mean) / (std * std)
    if cfg.constraint_violating_dependant_loss:
        grad = torch.where(_position_violation_mask(cfg, trajectory), grad, 0.0)
    return grad / cfg.n_timesteps


def joint_velocity_limit_cost(cfg: PlannerConfig, velocity):
    loss = 0.5 * (velocity / cfg.max_joint_velocity) ** 2
    if cfg.constraint_violating_dependant_loss:
        loss = torch.where(_velocity_violation_mask(cfg, velocity), loss, 0.0)
    return torch.sum(loss, dim=(-2, -1)) / cfg.n_timesteps


def joint_velocity_limit_cost_g(cfg: PlannerConfig, velocity):
    grad = velocity / (cfg.max_joint_velocity ** 2)
    if cfg.constraint_violating_dependant_loss:
        grad = torch.where(_velocity_violation_mask(cfg, velocity), grad, 0.0)
    return grad / cfg.n_timesteps


# ---------------------------------------------------------------------------
# Totals (ref: trajectory.py:271-297) and the fused cost and gradient.
# ---------------------------------------------------------------------------


def cost_from_traj(cfg: PlannerConfig, scn: Scenario, penalty: Penalty,
                   trajectory, velocity) -> torch.Tensor:
    """Total penalized cost of an evaluated (trajectory, velocity)."""
    toc = trajectory_obstacle_cost(cfg, trajectory, scn)
    sgpc = start_goal_cost(trajectory, scn.start, scn.goal)
    sgvc = start_goal_velocity_cost(velocity)
    jpc = joint_position_limit_cost(cfg, trajectory)
    jvc = joint_velocity_limit_cost(cfg, velocity)
    return toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)


def _raw_total_cost(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                    penalty: Penalty, alpha: torch.Tensor,
                    order: str = "matmul") -> torch.Tensor:
    trajectory, velocity = evaluate(cfg, basis, alpha, order)
    return cost_from_traj(cfg, scn, penalty, trajectory, velocity)


def _chain_to_alpha(cfg: PlannerConfig, basis: Basis, grad_pos, grad_vel,
                    order: str = "matmul"):
    """Pull position- and velocity-space gradients back to alpha, ``(km^T
    g_pos + dkm^T g_vel) mix^T`` (ref: trajectory.py:295): as one stacked
    (T, 2T) x (2T, J) product, or under ``order="xla"`` as XLA computes
    the JAX package's stacked product (its algebraic simplifier splits it
    at the stack into two (T, T) products and a sum)."""
    if order == "matmul":
        stacked = torch.cat((grad_pos, grad_vel), dim=-2)      # (..., 2T, J)
        return lane_matmul(basis_matmul(basis.kv.T, stacked), basis.mix.T)
    basis_product, mix_product = PRODUCTS[order]
    T = cfg.n_timesteps
    pulled = (basis_product(basis.kv[:T].T, grad_pos)
              + basis_product(basis.kv[T:].T, grad_vel))
    return mix_product(pulled, basis.mix.T)


def _grads_from_traj(cfg: PlannerConfig, scn: Scenario, penalty: Penalty,
                     trajectory, velocity, toc_g):
    """The position- and velocity-space gradients of the total cost."""
    lam_sg = _lanes(penalty.lambda_sg, 2)
    lam_jl = _lanes(penalty.lambda_jl, 2)
    sgp_g = start_goal_cost_g(trajectory, scn.start, scn.goal)
    sgv_g = start_goal_velocity_cost_g(velocity)
    jp_g = joint_position_limit_cost_g(cfg, trajectory)
    jv_g = joint_velocity_limit_cost_g(cfg, velocity)
    grad_pos = toc_g + lam_sg * sgp_g + lam_jl * jp_g
    grad_vel = lam_sg * sgv_g + lam_jl * jv_g
    return grad_pos, grad_vel


def total_cost_grad(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                    penalty: Penalty, alpha: torch.Tensor,
                    order: str = "matmul") -> torch.Tensor:
    """Analytic gradient of the total cost with respect to alpha
    (ref: trajectory.py:284-297)."""
    trajectory, velocity = evaluate(cfg, basis, alpha, order)
    toc_g = trajectory_obstacle_cost_g(cfg, trajectory, scn)
    return _chain_to_alpha(cfg, basis, *_grads_from_traj(
        cfg, scn, penalty, trajectory, velocity, toc_g), order)


def cost_and_grad(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                  penalty: Penalty, alpha: torch.Tensor,
                  order: str = "matmul") -> Tuple[torch.Tensor, torch.Tensor]:
    """The total cost and its analytic gradient from one forward pass (the
    basis product, the FK and the obstacle distances are shared): the hot
    function of every single-scene solver step."""
    trajectory, velocity = evaluate(cfg, basis, alpha, order)
    f = robot.fk(cfg, trajectory)
    cost_v, cost_g = obstacle_cost_vg(f, scn.obstacles, scn.obstacle_weight)
    lam = cfg.lambda_max_cost
    toc = lam * cost_v.amax(-1) + (1.0 - lam) * cost_v.mean(-1)
    w = blend_weights(cfg, cost_v)
    jac = robot.jacobian(cfg, trajectory)
    toc_g = torch.einsum("...it,...itj->...tj", w[..., None, :] * cost_g, jac)

    sgpc = start_goal_cost(trajectory, scn.start, scn.goal)
    sgvc = start_goal_velocity_cost(velocity)
    jpc = joint_position_limit_cost(cfg, trajectory)
    jvc = joint_velocity_limit_cost(cfg, velocity)
    cost = toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)
    grad = _chain_to_alpha(cfg, basis, *_grads_from_traj(
        cfg, scn, penalty, trajectory, velocity, toc_g), order)
    return cost, grad


class TotalCost(torch.autograd.Function):
    """The total cost with the analytic gradient as its backward (the JAX
    package's ``custom_vjp``, ops/costs.py:277-295): autograd users get
    the hand-derived gradient.  The gradient flows to alpha only; cfg,
    basis, scenario and penalty get none."""

    @staticmethod
    def forward(ctx, cfg, basis, scn, penalty, alpha, order):
        ctx.args = (cfg, basis, scn, penalty)
        ctx.order = order
        ctx.save_for_backward(alpha)
        return _raw_total_cost(cfg, basis, scn, penalty, alpha, order)

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        grad = total_cost_grad(*ctx.args, alpha.detach(), ctx.order)
        return None, None, None, None, _lanes(g, 2) * grad, None


def total_cost(cfg: PlannerConfig, basis: Basis, scn: Scenario,
               penalty: Penalty, alpha: torch.Tensor,
               order: str = "matmul") -> torch.Tensor:
    """Total penalized cost of coefficients alpha (..., T, J) (ref:
    trajectory.py:271-281).  Differentiable in alpha: its backward is
    :func:`total_cost_grad`."""
    return TotalCost.apply(cfg, basis, scn, penalty, alpha, order)


def total_cost_autodiff_only(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                             penalty: Penalty,
                             alpha: torch.Tensor) -> torch.Tensor:
    """The same forward as :func:`total_cost` without the analytic
    backward: autograd differentiates it op by op (the oracle of the
    gradient tests, as the reference checked its gradients against
    autodiff, ref: DevBlog blog-post.html:278)."""
    return _raw_total_cost(cfg, basis, scn, penalty, alpha)


# ---------------------------------------------------------------------------
# Constraint checking (ref: trajectory.py:129-180).
# ---------------------------------------------------------------------------


def constraints_fulfilled(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                          alpha: torch.Tensor,
                          order: str = "matmul") -> torch.Tensor:
    """True when all four hard constraints hold (ref: trajectory.py:129-137),
    per lane for a batch."""
    return constraint_report(cfg, basis, scn, alpha, order)["all_ok"]


def constraint_report(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                      alpha: torch.Tensor, order: str = "matmul") -> dict:
    """Per-constraint diagnostics with the measured norms."""
    trajectory, velocity = evaluate(cfg, basis, alpha, order)
    first, last = trajectory[..., 0, :], trajectory[..., -1, :]
    vfirst, vlast = velocity[..., 0, :], velocity[..., -1, :]
    rep = {
        "start_pos_err": torch.linalg.norm(first - scn.start, dim=-1),
        "goal_pos_err": torch.linalg.norm(last - scn.goal, dim=-1),
        "start_vel": torch.linalg.norm(vfirst, dim=-1),
        "goal_vel": torch.linalg.norm(vlast, dim=-1),
        "traj_max": trajectory.amax(dim=(-2, -1)),
        "traj_min": trajectory.amin(dim=(-2, -1)),
        "vel_abs_max": velocity.abs().amax(dim=(-2, -1)),
        "pos_ok": robot.start_goal_position_ok(cfg, first, last, scn.start,
                                               scn.goal),
        "vel_ok": robot.start_goal_velocity_ok(cfg, vfirst, vlast),
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
