"""Fleet solver: many scenes at once, lanes trailing (counterpart of
irm_motion_planning_tpu/solvers/fleet.py).

Only the fused BLS path is ported: ``fleet_solve(backend="fused")`` lays
the batch out lanes-trailing and runs the whole solve through
ops/fused_solve.py (the CUDA kernel on a GPU, its plain version on the CPU).
Layouts: alpha (T, J, B) in the fleet layout, (J, T, B) for the kernel,
(B, T, J) at the API.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PlannerConfig
from ..models import robot
from ..models.rkhs import Basis
from ..ops import fused_solve as fs
from ..ops.costs import Penalty
from ..ops.scenario import Scenario
from .common import SolveResult, SolveStats


def to_fleet(scns: Scenario) -> Scenario:
    """(B, ...) fields -> (..., B) fields."""
    return Scenario(*(torch.movedim(x, 0, -1) for x in scns))


def alpha_to_fleet(alpha: torch.Tensor) -> torch.Tensor:
    """(B, T, J) -> (T, J, B)."""
    return torch.movedim(alpha, 0, -1)


def alpha_from_fleet(alpha: torch.Tensor) -> torch.Tensor:
    """(T, J, B) -> (B, T, J)."""
    return torch.movedim(alpha, -1, 0)


def fleet_evaluate(cfg: PlannerConfig, basis: Basis, alpha: torch.Tensor):
    """alpha (T, J, B) -> (traj, vel), each (T, J, B), through one stacked
    product and the mix over the joint axis."""
    T, J, B = alpha.shape
    both = (basis.kv @ alpha.reshape(T, J * B)).reshape(2, T, J, B)
    both = torch.einsum("ktjb,ji->ktib", both, basis.mix)
    return both[0], both[1]


def fleet_init_alpha(cfg: PlannerConfig, basis: Basis,
                     scn: Scenario) -> torch.Tensor:
    """Smoothstep warm start for every lane: ``init_u (x) start mix^-1 +
    init_w (x) (goal - start) mix^-1``.  scn lanes trailing -> (T, J, B)."""
    sm = torch.einsum("jb,ji->ib", scn.start, basis.mix_inv)
    dm = torch.einsum("jb,ji->ib", scn.goal - scn.start, basis.mix_inv)
    return basis.init_u[:, None, None] * sm[None] + basis.init_w[:, None, None] * dm[None]


def _fk_ee(cfg: PlannerConfig, traj: torch.Tensor) -> torch.Tensor:
    """traj (T, J, B) -> end effector (2, T, B)."""
    c = torch.cumsum(traj, dim=1)
    ll = robot.link_lengths(cfg, traj.device)
    return torch.stack((torch.einsum("tjb,j->tb", torch.cos(c), ll),
                        torch.einsum("tjb,j->tb", torch.sin(c), ll)))


def fleet_cost(cfg: PlannerConfig, basis: Basis, scn: Scenario,
               penalty: Penalty, alpha: torch.Tensor) -> torch.Tensor:
    """Total penalized cost per lane (B,) of alpha (T, J, B); scn lanes
    trailing, penalty fields scalars or (B,)."""
    traj, vel = fleet_evaluate(cfg, basis, alpha)
    ee = _fk_ee(cfg, traj)                                     # (2, T, B)
    diff = ee[:, :, None] - scn.obstacles.movedim(1, 0)[:, None]  # (2, T, O, B)
    d2 = (diff * diff).sum(0)
    cost_v = (0.8 / (0.5 + 0.5 * d2) * scn.obstacle_weight).sum(1)  # (T, B)
    lam = cfg.lambda_max_cost
    toc = lam * cost_v.max(0).values + (1.0 - lam) * cost_v.mean(0)
    sgpc = 0.5 * (((traj[0] - scn.start) ** 2).sum(0)
                  + ((traj[-1] - scn.goal) ** 2).sum(0))
    sgvc = 0.5 * ((vel[0] ** 2).sum(0) + (vel[-1] ** 2).sum(0))
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    pl = 0.5 * ((traj - mean) / std) ** 2
    vl = 0.5 * (vel / cfg.max_joint_velocity) ** 2
    if cfg.constraint_violating_dependant_loss:
        jsl = cfg.joint_safety_limit
        pl = torch.where((traj > jsl * cfg.max_joint_position)
                         | (traj < jsl * cfg.min_joint_position), pl, 0.0)
        vl = torch.where(vel.abs() > jsl * cfg.max_joint_velocity, vl, 0.0)
    T = traj.shape[0]
    jpc, jvc = pl.sum((0, 1)) / T, vl.sum((0, 1)) / T
    return toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)


def fleet_constraints(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                      alpha: torch.Tensor) -> torch.Tensor:
    """Per-lane hard-constraint check (B,) bool on the exact evaluation of
    alpha (T, J, B) (ref: trajectory.py:129-137)."""
    traj, vel = fleet_evaluate(cfg, basis, alpha)
    pos_ok = (torch.linalg.norm(traj[0] - scn.start, dim=0) < cfg.eps_position) & (
        torch.linalg.norm(traj[-1] - scn.goal, dim=0) < cfg.eps_position
    )
    vel_ok = (torch.linalg.norm(vel[0], dim=0) < cfg.eps_velocity) & (
        torch.linalg.norm(vel[-1], dim=0) < cfg.eps_velocity
    )
    box_ok = (traj.amax(dim=(0, 1)) <= cfg.max_joint_position) & (
        traj.amin(dim=(0, 1)) >= cfg.min_joint_position
    )
    vbox_ok = vel.abs().amax(dim=(0, 1)) <= cfg.max_joint_velocity
    return pos_ok & vel_ok & box_ok & vbox_ok


def fused_args(cfg: PlannerConfig, basis: Basis, scenarios: Scenario,
               alpha0: Optional[torch.Tensor] = None) -> tuple:
    """The arguments of ops.fused_solve.fused_solve for a leading-batch
    Scenario: cfg, the basis pair and mix, the warm start in the kernel
    layout (J, T, B), the initial penalties and the lane-trailing scene."""
    fsc = to_fleet(scenarios)
    B = scenarios.start.shape[0]
    if alpha0 is None:
        a0 = fleet_init_alpha(cfg, basis, fsc)
    else:
        a0 = alpha_to_fleet(alpha0)
    dev = a0.device
    return (
        cfg, basis.kv, basis.kv.T.contiguous(), basis.mix,
        a0.movedim(1, 0).contiguous(),         # (T, J, B) -> (J, T, B)
        torch.full((1, B), cfg.lambda_sg_constraint, device=dev),
        torch.full((1, B), cfg.lambda_jl_constraint, device=dev),
        fsc.start.contiguous(), fsc.goal.contiguous(),
        fsc.obstacles[:, 0].contiguous(), fsc.obstacles[:, 1].contiguous(),
        fsc.obstacle_weight.contiguous(),
    )


def fleet_solve(cfg: PlannerConfig, basis: Basis, scenarios: Scenario,
                alpha0: Optional[torch.Tensor] = None, solver: str = "bls",
                backend: str = "fused") -> SolveResult:
    """Solve a batch of scenes (leading-batch Scenario) with the fused BLS
    solve; ``alpha0`` is an optional (B, T, J) warm start.  The device of
    the scenes decides where it runs.  Returns leading-batch results."""
    if backend != "fused":
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet: the 'xla'-equivalent "
            "engine is ROADMAP queue 1 #6, the per-step 'pallas' backend #12"
        )
    if solver != "bls":
        raise NotImplementedError(
            f"solver={solver!r} is not ported yet (ROADMAP queue 1 #9)"
        )
    if cfg.bls_mode == "sequential":
        raise ValueError(
            "bls_mode='sequential' is not supported by the fleet engine; "
            "use bls_mode='ladder' (same trial sequence)"
        )
    if cfg.lane_compaction:
        raise NotImplementedError(
            "lane_compaction is not ported yet (ROADMAP queue 1 #11)"
        )
    out = fs.fused_solve(*fused_args(cfg, basis, scenarios, alpha0))
    return SolveResult(
        alpha=alpha_from_fleet(out.alpha.movedim(0, 1)),
        stats=SolveStats(
            outer_iters=out.outer_iters[0].to(torch.int32),
            inner_iters=out.inner_iters[0].to(torch.int32),
            converged=out.fulfilled[0] > 0.5,
            final_cost=out.final_loss[0],
        ),
    )


def make_fleet_solver(cfg: PlannerConfig, basis: Basis, solver: str = "bls",
                      backend: str = "fused"):
    """A solver bound to (cfg, basis): leading-batch Scenario ->
    SolveResult."""

    def run(scenarios: Scenario) -> SolveResult:
        return fleet_solve(cfg, basis, scenarios, solver=solver,
                           backend=backend)

    return run
