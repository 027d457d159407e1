"""Fleet solver: many scenes at once, lanes trailing (counterpart of
irm_motion_planning_tpu/solvers/fleet.py).

Every tensor carries the scene lane as its LAST axis: alpha and trajectory
(T, J, B), end-effector points (2, T, B), obstacles (O, 2, B), lane state
(B,).  Line-search candidates add a rung axis before the lanes,
(T, J, n+1, B).  Three engines:

* ``backend="fused"``: the whole solve, BLS or GD, in one kernel launch
  (ops/fused_solve.py: the CUDA kernel on a GPU, its plain version on the
  CPU); with ``cfg.lane_compaction`` one launch per penalty round instead,
  with the lanes re-sorted after round 0 (:func:`_fused_rounds_solve`);
* ``backend="pallas"``: the per-step backend, BLS or GD: one kernel launch
  per inner step and one fused evaluation per penalty round
  (ops/step_kernels.py, driven by :func:`_pallas_solve`);
* ``backend="xla"`` (the default, as in the JAX package): the plain
  PyTorch engine, the counterpart of the JAX package's portable backend:
  :func:`run_dual_loop` around the rung-major BLS ladder of
  :func:`make_bls_inner` or the GD loop of :func:`make_gd_inner`.  It is
  the reference the bench's paired quality gate holds the kernels to.

BLS runs in either Armijo ladder tier (``cfg.ladder_eval``: linearized or
exact) on every backend.  The kernel backends run the launch plan of
ops/fused_solve.py (``launch_plan``: the basis resident in shared memory up
to T = 64, streamed from device memory beyond; every joint count J up to
15, one kernel library per J); past the float32 plans' ceiling (at 11
obstacles T = 2,073 for J = 3, 1,209 for J = 5, 966 for J = 7, where one
warp's lane state no longer fits in shared memory) BLS with the
linearized ladder and
``cfg.bls_bf16_ladder`` runs the bf16 tier's plan on ``backend="fused"``
(``kernel_plan``, up to T = 2,636); where no plan fits, or the plan is the
bf16 tier's and the backend the per-step one (which has no such tier),
``fleet_solve`` warns and runs the ``xla`` engine, as the JAX package does;
so it does past J = 15.

Layouts: alpha (T, J, B) in the fleet layout, (J, T, B) for the kernels,
(B, T, J) at the API.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PlannerConfig
from ..models import robot
from ..models.rkhs import Basis
from ..ops import fused_solve as fs
from ..ops import step_kernels as sk
from ..ops.costs import Penalty
from ..ops.scenario import Scenario
from .common import (
    SolveResult, SolveStats, inner_loop_bound, run_dual_loop, run_inner_loop,
)


def to_fleet(scns: Scenario) -> Scenario:
    """(B, ...) fields -> (..., B) fields."""
    return Scenario(*(torch.movedim(x, 0, -1) for x in scns))


def alpha_to_fleet(alpha: torch.Tensor) -> torch.Tensor:
    """(B, T, J) -> (T, J, B)."""
    return torch.movedim(alpha, 0, -1)


def alpha_from_fleet(alpha: torch.Tensor) -> torch.Tensor:
    """(T, J, B) -> (B, T, J)."""
    return torch.movedim(alpha, -1, 0)


# ---------------------------------------------------------------------------
# Batch-trailing math.  Trailing lane axes ...L are (B,) or (n+1, B).
# ---------------------------------------------------------------------------


def fleet_evaluate(cfg: PlannerConfig, basis: Basis, alpha: torch.Tensor):
    """alpha (T, J, ...L) -> (traj, vel), each (T, J, ...L), through one
    stacked product and the mix over the joint axis."""
    T, J = alpha.shape[:2]
    lanes = tuple(alpha.shape[2:])
    both = (basis.kv @ alpha.reshape(T, -1)).reshape((2, T, J) + lanes)
    both = torch.einsum("ktj...,ji->kti...", both, basis.mix)
    return both[0], both[1]


def fleet_init_alpha(cfg: PlannerConfig, basis: Basis,
                     scn: Scenario) -> torch.Tensor:
    """Smoothstep warm start for every lane: ``init_u (x) start mix^-1 +
    init_w (x) (goal - start) mix^-1``.  scn lanes trailing -> (T, J, B)."""
    sm = torch.einsum("jb,ji->ib", scn.start, basis.mix_inv)
    dm = torch.einsum("jb,ji->ib", scn.goal - scn.start, basis.mix_inv)
    return basis.init_u[:, None, None] * sm[None] + basis.init_w[:, None, None] * dm[None]


def _fk_ee(cfg: PlannerConfig, traj: torch.Tensor) -> torch.Tensor:
    """traj (T, J, ...L) -> end effector (2, T, ...L)."""
    c = torch.cumsum(traj, dim=1)
    ll = robot.link_lengths(cfg, traj.device)
    return torch.stack((torch.einsum("tj...,j->t...", torch.cos(c), ll),
                        torch.einsum("tj...,j->t...", torch.sin(c), ll)))


def _fk_ee_and_jac(cfg: PlannerConfig, traj: torch.Tensor):
    """traj (T, J, B) -> (end effector (2, T, B), Jacobian (2, T, J, B))."""
    c = torch.cumsum(traj, dim=1)
    ll = robot.link_lengths(cfg, traj.device)[None, :, None]
    sin, cos = torch.sin(c), torch.cos(c)
    ee = torch.stack(((cos * ll).sum(1), (sin * ll).sum(1)))
    x = -ll * sin
    y = ll * cos
    rcx = x + x.sum(1, keepdim=True) - torch.cumsum(x, dim=1)
    rcy = y + y.sum(1, keepdim=True) - torch.cumsum(y, dim=1)
    return ee, torch.stack((rcx, rcy))


def _obstacle_v(ee: torch.Tensor, obstacles: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """ee (2, T, ...L), obstacles (O, 2, B), weight (O, B) -> cost_v
    (T, ...L).  Rung axes sit before B, so B stays the minor axis."""
    extra = ee.dim() - 3
    O, B = weight.shape
    obs = obstacles.movedim(1, 0).reshape((2, 1, O) + (1,) * extra + (B,))
    w = weight.reshape((1, O) + (1,) * extra + (B,))
    diff = ee[:, :, None] - obs                       # (2, T, O, ...L)
    d2 = (diff * diff).sum(0)                         # (T, O, ...L)
    return (0.8 / (0.5 + 0.5 * d2) * w).sum(1)


def _obstacle_vg(ee: torch.Tensor, obstacles: torch.Tensor,
                 weight: torch.Tensor):
    """Value and gradient with respect to ee.  ee (2, T, B) -> ((T, B),
    (2, T, B))."""
    obs = obstacles.movedim(1, 0)[:, None]            # (2, 1, O, B)
    diff = ee[:, :, None] - obs                       # (2, T, O, B)
    d2 = (diff * diff).sum(0)
    inv = 1.0 / (0.5 + 0.5 * d2)
    cost_v = (0.8 * inv * weight[None]).sum(1)
    cost_g = ((-0.8 * weight[None, None]) * diff * (inv * inv)[None]).sum(2)
    return cost_v, cost_g


def _blend(cfg: PlannerConfig, cost_v: torch.Tensor) -> torch.Tensor:
    """cost_v (T, ...L) -> the max/mean blend (...L,) (ref:
    trajectory.py:85-87)."""
    lam = cfg.lambda_max_cost
    return lam * cost_v.amax(0) + (1.0 - lam) * cost_v.mean(0)


def _blend_weights(cfg: PlannerConfig, cost_v: torch.Tensor) -> torch.Tensor:
    """Gradient weights of the blend (T, B): lambda_max on the FIRST argmax
    over T, plus the mean's share.  torch.argmax returns the first maximal
    index, as jnp.argmax does."""
    T = cost_v.shape[0]
    lam = cfg.lambda_max_cost
    rows = torch.arange(T, device=cost_v.device).reshape(
        (T,) + (1,) * (cost_v.dim() - 1))
    onehot = (rows == cost_v.argmax(0)[None]).to(cost_v.dtype)
    return lam * onehot + (1.0 - lam) / T


def _limit_masks(cfg: PlannerConfig, traj, vel):
    pmask = (traj > cfg.joint_safety_limit * cfg.max_joint_position) | (
        traj < cfg.joint_safety_limit * cfg.min_joint_position
    )
    vmask = vel.abs() > cfg.joint_safety_limit * cfg.max_joint_velocity
    return pmask, vmask


def _limit_terms(cfg: PlannerConfig, traj, vel):
    """Joint position/velocity limit losses (...L,) (ref:
    trajectory.py:215-268)."""
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    pl = 0.5 * ((traj - mean) / std) ** 2
    vl = 0.5 * (vel / cfg.max_joint_velocity) ** 2
    if cfg.constraint_violating_dependant_loss:
        pmask, vmask = _limit_masks(cfg, traj, vel)
        pl = torch.where(pmask, pl, 0.0)
        vl = torch.where(vmask, vl, 0.0)
    T = traj.shape[0]
    return pl.sum((0, 1)) / T, vl.sum((0, 1)) / T


def _limit_grads(cfg: PlannerConfig, traj, vel):
    mean = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std = 0.5 * (cfg.max_joint_position - mean)
    pg = (traj - mean) / (std * std)
    vg = vel / (cfg.max_joint_velocity ** 2)
    if cfg.constraint_violating_dependant_loss:
        pmask, vmask = _limit_masks(cfg, traj, vel)
        pg = torch.where(pmask, pg, 0.0)
        vg = torch.where(vmask, vg, 0.0)
    T = traj.shape[0]
    return pg / T, vg / T


def _start_goal_terms(traj, vel, start, goal):
    sgpc = 0.5 * (((traj[0] - start) ** 2).sum(0)
                  + ((traj[-1] - goal) ** 2).sum(0))
    sgvc = 0.5 * ((vel[0] ** 2).sum(0) + (vel[-1] ** 2).sum(0))
    return sgpc, sgvc


def fleet_cost_from_traj(cfg: PlannerConfig, scn: Scenario, penalty: Penalty,
                         traj, vel) -> torch.Tensor:
    """Total penalized cost per lane (...L,) of an evaluated trajectory
    (T, J, ...L); penalty fields scalars or (B,), broadcast over rungs."""
    toc = _blend(cfg, _obstacle_v(_fk_ee(cfg, traj), scn.obstacles,
                                  scn.obstacle_weight))
    extra = traj.dim() - 3
    J, B = scn.start.shape
    start = scn.start.reshape((J,) + (1,) * extra + (B,))
    goal = scn.goal.reshape((J,) + (1,) * extra + (B,))
    sgpc, sgvc = _start_goal_terms(traj, vel, start, goal)
    jpc, jvc = _limit_terms(cfg, traj, vel)
    return toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)


def fleet_cost(cfg: PlannerConfig, basis: Basis, scn: Scenario,
               penalty: Penalty, alpha: torch.Tensor) -> torch.Tensor:
    """Total penalized cost per lane of alpha (T, J, ...L) -> (...L,)."""
    traj, vel = fleet_evaluate(cfg, basis, alpha)
    return fleet_cost_from_traj(cfg, scn, penalty, traj, vel)


def unpenalized_cost(cfg: PlannerConfig, basis: Basis, scenarios: Scenario,
                     alpha: torch.Tensor,
                     lambda_max_cost: Optional[float] = None) -> torch.Tensor:
    """Each scene's unpenalized obstacle cost, the reference's final report
    (ref: main.py:141-143; the penalties at 0), of the solve alpha (B, T, J)
    of the leading-batch ``scenarios``, under the blend ``lambda_max_cost``
    (None: cfg's; 0 the average cost, 1 the maximum) -> (B,).  The one
    readout of the bench's gate, the quality benchmarks and certify."""
    if lambda_max_cost is not None:
        cfg = cfg.replace(lambda_max_cost=lambda_max_cost)
    zero = torch.zeros((), dtype=torch.float32, device=alpha.device)
    return fleet_cost(cfg, basis, to_fleet(scenarios), Penalty(zero, zero),
                      alpha_to_fleet(alpha))


def fleet_cost_grad_eval(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                         penalty: Penalty, alpha: torch.Tensor):
    """Per-lane cost, analytic alpha-gradient and the evaluated (traj, vel)
    in one pass.  alpha (T, J, B) -> ((B,), (T, J, B), (T, J, B),
    (T, J, B))."""
    traj, vel = fleet_evaluate(cfg, basis, alpha)
    ee, jac = _fk_ee_and_jac(cfg, traj)
    cost_v, cost_g = _obstacle_vg(ee, scn.obstacles, scn.obstacle_weight)
    toc = _blend(cfg, cost_v)
    w = _blend_weights(cfg, cost_v)                          # (T, B)
    toc_g = torch.einsum("itb,itjb->tjb", w[None] * cost_g, jac)

    sgpc, sgvc = _start_goal_terms(traj, vel, scn.start, scn.goal)
    jpc, jvc = _limit_terms(cfg, traj, vel)
    cost = toc + penalty.lambda_sg * (sgpc + sgvc) + penalty.lambda_jl * (jpc + jvc)

    sgp_g = torch.zeros_like(traj)
    sgp_g[0] = traj[0] - scn.start
    sgp_g[-1] = traj[-1] - scn.goal
    sgv_g = torch.zeros_like(vel)
    sgv_g[0] = vel[0]
    sgv_g[-1] = vel[-1]
    jp_g, jv_g = _limit_grads(cfg, traj, vel)

    grad_pos = toc_g + penalty.lambda_sg * sgp_g + penalty.lambda_jl * jp_g
    grad_vel = penalty.lambda_sg * sgv_g + penalty.lambda_jl * jv_g
    stacked = torch.cat((grad_pos, grad_vel), dim=0)         # (2T, J, B)
    T, J, B = alpha.shape
    pulled = (basis.kv.T @ stacked.reshape(2 * T, J * B)).reshape(T, J, B)
    grad = torch.einsum("tib,ji->tjb", pulled, basis.mix)
    return cost, grad, traj, vel


def fleet_cost_and_grad(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                        penalty: Penalty, alpha: torch.Tensor):
    """Per-lane cost and analytic alpha-gradient.  alpha (T, J, B) ->
    ((B,), (T, J, B))."""
    cost, grad, _, _ = fleet_cost_grad_eval(cfg, basis, scn, penalty, alpha)
    return cost, grad


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


# ---------------------------------------------------------------------------
# The plain engine: the rung-major BLS inner loop.
# ---------------------------------------------------------------------------


class BlsInner(NamedTuple):
    minimized: torch.Tensor   # (B,) bool
    inner_iter: torch.Tensor  # (B,) int32
    alpha: torch.Tensor       # (T, J, B)
    bls_lr: torch.Tensor      # (B,)
    loss: torch.Tensor        # (B,)
    grad: torch.Tensor        # (T, J, B)
    traj: torch.Tensor        # (T, J, B), the evaluation at alpha
    vel: torch.Tensor         # (T, J, B)


def make_bls_inner(cfg: PlannerConfig, basis: Basis, scn: Scenario):
    """The BLS inner minimizer of the plain engine, as
    ``for_outer(outer_iter, round_idx) -> inner(alpha, penalty) -> (alpha,
    inner_iters, loss)`` (the factory :func:`run_dual_loop` takes).

    Each step evaluates all ``n = max_bls_iteration`` Armijo rungs at once,
    rung-major ``(T, J, n+1, B)``, and takes the first rung that passes.  In
    the ladder tier ``cfg.ladder_eval``: linearized, on the linearized
    trajectory (evaluation is linear in alpha: a rung's trajectory is ``(1 -
    lambda_reg lr) traj - lr eval(n_grad)``); exact, each rung's candidate
    alpha ``(1 - lambda_reg lr) alpha - lr n_grad`` through the basis (ref:
    optimizer_BLS.py:139).  Rung n is the
    zero-lr candidate, alpha itself, evaluated through the SAME path as the
    real rungs: its loss is the Armijo and stop baseline.  A baseline from
    another fp path (the carried loss) differs by ~1e-4 relative on this
    ill-conditioned parametrization, above the margin of small-lr rungs and
    the 1e-3 stop threshold, and flips near-threshold decisions (in the JAX
    package it took the converged fraction from the reference's 53% to
    77% on 256 random scenes).  The accepted alpha and the exact ladder's
    candidates ``a_fac alpha - lr n_grad`` are rounded once
    (fused_solve.fma), as XLA forms them on the CPU: at T=200 the
    coefficients are O(1e4) and two roundings part from JAX's engine by
    more than bench.py's converged band (PERF.md section 7)."""
    n = cfg.max_bls_iteration
    dev = basis.kv.device
    # float32 powers of beta_minus, as jnp.power computes them (exact for
    # the default 0.5).
    rungs = torch.pow(torch.tensor(cfg.bls_beta_minus, dtype=torch.float32,
                                   device=dev),
                      torch.arange(n, dtype=torch.float32, device=dev))
    lr_fail = float(np.float32(cfg.bls_beta_minus) ** np.float32(n))

    def raw_step(s: BlsInner, penalty: Penalty) -> BlsInner:
        gnorm = torch.sqrt((s.grad * s.grad).sum((0, 1)))          # (B,)
        n_grad = s.grad / gnorm
        # Reference quirk (optimizer_BLS.py:86): the sum over ALL (J, J)
        # entries of grad^T n_grad = sum_t rowsum(grad)_t rowsum(n_grad)_t.
        alpha_norm = (s.grad.sum(1) * n_grad.sum(1)).sum(0)
        lrs = rungs[:, None] * s.bls_lr[None]                      # (n, B)
        lrs_b = torch.cat([lrs, torch.zeros_like(lrs[:1])])        # (n+1, B)
        a_fac = 1.0 - cfg.lambda_reg * lrs_b
        if cfg.ladder_eval == "linearized":
            gtraj, gvel = fleet_evaluate(cfg, basis, n_grad)
            cand_traj = a_fac * s.traj[:, :, None] - lrs_b * gtraj[:, :, None]
            cand_vel = a_fac * s.vel[:, :, None] - lrs_b * gvel[:, :, None]
        else:
            cand_traj, cand_vel = fleet_evaluate(       # (T, J, n+1, B)
                cfg, basis, fs.fma(a_fac, s.alpha[:, :, None],
                                   -(lrs_b * n_grad[:, :, None])))
        cand_loss = fleet_cost_from_traj(cfg, scn, penalty, cand_traj,
                                         cand_vel)                  # (n+1, B)
        del cand_traj, cand_vel
        base_loss = cand_loss[n]
        required = base_loss[None] - cfg.bls_alpha * lrs * alpha_norm[None]
        ok = cand_loss[:n] <= required
        any_ok = ok.any(0)
        j = ok.to(torch.uint8).argmax(0)[None]       # first passing rung
        lr_sel = torch.gather(lrs, 0, j)[0]
        lr_eff = torch.where(any_ok, lr_sel, 0.0)    # rejected: no step
        new_alpha = fs.fma(1.0 - cfg.lambda_reg * lr_eff, s.alpha,
                           -(lr_eff * n_grad))
        sel_loss = torch.gather(cand_loss[:n], 0, j)[0]
        new_loss = torch.where(any_ok, sel_loss, base_loss)
        new_lr = torch.where(any_ok, lr_sel * cfg.bls_beta_plus,
                             s.bls_lr * lr_fail)
        stop = base_loss - new_loss < cfg.loop_loss_reduction
        next_loss, next_grad, next_traj, next_vel = fleet_cost_grad_eval(
            cfg, basis, scn, penalty, new_alpha
        )
        return BlsInner(
            minimized=stop,
            inner_iter=torch.where(stop, s.inner_iter, s.inner_iter + 1),
            alpha=new_alpha,
            bls_lr=new_lr,
            loss=torch.where(stop, new_loss, next_loss),
            grad=torch.where(stop, s.grad, next_grad),
            traj=next_traj,
            vel=next_vel,
        )

    def for_outer(outer_iter, round_idx=None):
        bound = inner_loop_bound(cfg, round_idx)

        def inner(alpha, penalty: Penalty):
            loss0, grad0, traj0, vel0 = fleet_cost_grad_eval(
                cfg, basis, scn, penalty, alpha
            )
            B = loss0.shape[0]
            s = BlsInner(
                minimized=torch.zeros(B, dtype=torch.bool, device=dev),
                inner_iter=torch.zeros(B, dtype=torch.int32, device=dev),
                alpha=alpha,
                bls_lr=torch.full((B,), cfg.bls_lr_start, dtype=torch.float32,
                                  device=dev),
                loss=loss0, grad=grad0, traj=traj0, vel=vel0,
            )
            s = run_inner_loop(cfg, s, bound, lambda s: raw_step(s, penalty))
            return s.alpha, s.inner_iter, s.loss

        return inner

    return for_outer


class GdInner(NamedTuple):
    minimized: torch.Tensor   # (B,) bool
    inner_iter: torch.Tensor  # (B,) int32
    alpha: torch.Tensor       # (T, J, B)
    loss: torch.Tensor        # (B,)
    grad: torch.Tensor        # (T, J, B)


def make_gd_inner(cfg: PlannerConfig, basis: Basis, scn: Scenario):
    """The GD inner minimizer of the plain engine (ref: optimizer_GD.py:
    184-194), in :func:`run_dual_loop`'s factory form.  The learning rate is
    per lane, ``gd_lr[clip(outer_iter)]`` (lanes can sit at different
    penalty rounds, ref: optimizer_GD.py:209); the stop test REJECTS the
    step; minimized and budget-exhausted lanes freeze.  The trial is
    rounded once (fused_solve.fma), as XLA forms it."""
    dev = basis.kv.device
    lr_schedule = torch.tensor(cfg.gd_lr, dtype=torch.float32, device=dev)
    last = len(cfg.gd_lr) - 1

    def for_outer(outer_iter, round_idx=None):
        lr = lr_schedule[torch.clip(outer_iter, 0, last).long()]     # (B,)
        bound = inner_loop_bound(cfg, round_idx)

        def raw_step(s: GdInner, penalty: Penalty) -> GdInner:
            new_alpha = fs.fma(1.0 - cfg.lambda_reg * lr, s.alpha,
                               -(lr * s.grad))
            new_loss, new_grad = fleet_cost_and_grad(cfg, basis, scn, penalty,
                                                     new_alpha)
            stop = s.loss - new_loss < cfg.loop_loss_reduction
            return GdInner(
                minimized=stop,
                inner_iter=torch.where(stop, s.inner_iter, s.inner_iter + 1),
                alpha=torch.where(stop, s.alpha, new_alpha),
                loss=torch.where(stop, s.loss, new_loss),
                grad=torch.where(stop, s.grad, new_grad),
            )

        def inner(alpha, penalty: Penalty):
            loss0, grad0 = fleet_cost_and_grad(cfg, basis, scn, penalty, alpha)
            B = loss0.shape[0]
            s = GdInner(
                minimized=torch.zeros(B, dtype=torch.bool, device=dev),
                inner_iter=torch.zeros(B, dtype=torch.int32, device=dev),
                alpha=alpha, loss=loss0, grad=grad0,
            )
            s = run_inner_loop(cfg, s, bound, lambda s: raw_step(s, penalty))
            return s.alpha, s.inner_iter, s.loss

        return inner

    return for_outer


# ---------------------------------------------------------------------------
# The kernel engines.
# ---------------------------------------------------------------------------


def fused_args(cfg: PlannerConfig, basis: Basis, scenarios: Scenario,
               alpha0: Optional[torch.Tensor] = None) -> tuple:
    """The arguments of ops.fused_solve.fused_solve for a leading-batch
    Scenario: cfg, the basis pair and mix, the warm start in the kernel
    layout (J, T, B), the initial penalties and the lane-trailing scene.
    The transposed basis is built once per basis (fused_solve.memo), so the
    streamed body's layout of the pair is too."""
    fsc = to_fleet(scenarios)
    B = scenarios.start.shape[0]
    if alpha0 is None:
        a0 = fleet_init_alpha(cfg, basis, fsc)
    else:
        a0 = alpha_to_fleet(alpha0)
    dev = a0.device
    return (
        cfg, basis.kv, fs.memo("kvt", lambda m: m.T.contiguous(), basis.kv),
        basis.mix,
        a0.movedim(1, 0).contiguous(),         # (T, J, B) -> (J, T, B)
        torch.full((1, B), cfg.lambda_sg_constraint, device=dev),
        torch.full((1, B), cfg.lambda_jl_constraint, device=dev),
        fsc.start.contiguous(), fsc.goal.contiguous(),
        fsc.obstacles[:, 0].contiguous(), fsc.obstacles[:, 1].contiguous(),
        fsc.obstacle_weight.contiguous(),
    )


def kernel_result(out: fs.FusedSolve) -> SolveResult:
    """SolveResult from the kernels' layout: alpha (J, T, B) and (1, B)
    fields."""
    return SolveResult(
        alpha=alpha_from_fleet(out.alpha.movedim(0, 1)),
        stats=SolveStats(
            outer_iters=out.outer_iters[0].to(torch.int32),
            inner_iters=out.inner_iters[0].to(torch.int32),
            converged=out.fulfilled[0] > 0.5,
            final_cost=out.final_loss[0],
        ),
    )


def compaction_order(ful: torch.Tensor, floss: torch.Tensor,
                     last_steps: torch.Tensor) -> torch.Tensor:
    """The lane order of the re-sort after round 0: ascending round-0
    accepted steps, ties broken by the round-0 loss scaled into [0, 0.999]
    (lexicographic on integer step counts), fulfilled lanes last.  ful and
    floss (1, B), last_steps (B,).  The sort is stable, as jnp.argsort is
    (torch's default is not), so equal keys keep JAX's order."""
    lo = torch.where(torch.isfinite(floss[0]), floss[0], 0.0)
    tie = (lo - lo.min()) / (lo.max() - lo.min() + 1e-9)
    key = torch.where(ful[0] > 0.5, float("inf"),
                      last_steps + torch.clip(tie, 0.0, 0.999))
    return torch.argsort(key, stable=True)


class Rounds(NamedTuple):
    """The rounds driver's per-lane state between K2 launches: alpha
    (J, T, B) and (1, B) fields.  ``floss``: the loss of the round in which
    the lane was fulfilled (inf while it is not)."""

    alpha: torch.Tensor
    lam_sg: torch.Tensor
    lam_jl: torch.Tensor
    ful: torch.Tensor
    outer: torch.Tensor
    total_inner: torch.Tensor
    floss: torch.Tensor


def start_rounds(alpha, lam_sg, lam_jl) -> Rounds:
    """The state before round 0: no lane fulfilled, nothing counted."""
    B = alpha.shape[-1]
    zeros = torch.zeros((1, B), dtype=torch.float32, device=alpha.device)
    return Rounds(alpha, lam_sg, lam_jl, zeros, zeros, zeros,
                  torch.full((1, B), float("inf"), device=alpha.device))


def after_round(cfg: PlannerConfig, s: Rounds, out: fs.FusedRound) -> Rounds:
    """The penalty bookkeeping after one K2 launch: op for op the
    whole-solve kernel's epilogue (the x10 escalation on the lanes that
    still fail)."""
    inc = float(cfg.lambda_constraint_increase)
    was = s.ful
    now = torch.maximum(was, out.ok)
    return Rounds(
        alpha=out.alpha,
        lam_sg=torch.where(now > 0.5, s.lam_sg, s.lam_sg * inc),
        lam_jl=torch.where(now > 0.5, s.lam_jl, s.lam_jl * inc),
        ful=now,
        outer=torch.where(now > 0.5, s.outer, s.outer + 1.0),
        total_inner=s.total_inner + out.inner,
        floss=torch.where(was > 0.5, s.floss, out.loss),
    )


def take_lanes(p: torch.Tensor, *xs) -> tuple:
    """Each of ``xs`` with its lanes (the last axis) in the order ``p``."""
    return tuple(x.index_select(-1, p) for x in xs)


def rounds_result(s: Rounds, perm: torch.Tensor) -> SolveResult:
    """The solve's result in the original lane order: lane i of ``s`` holds
    original lane ``perm[i]``."""
    inv = torch.argsort(perm)             # undo the composed permutation
    return kernel_result(fs.FusedSolve(*take_lanes(
        inv, s.alpha, s.floss, s.ful, s.outer, s.total_inner)))


def _fused_rounds_solve(cfg: PlannerConfig, kargs: tuple,
                        solver: str = "bls", plan: str = "",
                        **tier) -> SolveResult:
    """The solve of ``solver`` as one fused-round launch per penalty round
    (ops.fused_solve.fused_round), with the penalty bookkeeping between
    launches (:func:`after_round`) and, with ``cfg.lane_compaction``, one
    re-sort of the lanes before round 1.  ``kargs`` are :func:`fused_args`'
    (without cfg).  Each
    round starts every lane from the round's learning rate
    (fused_solve.round_lr: ``bls_lr_start``, or GD's ``gd_lr[min(r, len -
    1)]``), as the JAX package's rounds driver does.  ``plan``: K2's
    launch plan (fused_solve.launch_plan; empty: the default for T);
    ``tier``: K2's ``lean``/``ultra``/``bf16`` keywords.

    Why, in the JAX package: a tile of lanes runs until its slowest lane
    freezes, so sorting by round 0's accepted-step count (fulfilled lanes
    last) groups lanes that freeze together.  The kernel here runs one warp
    per lane and its warps draw lanes from a queue, so no lane waits for
    another and the sort only orders the queue; it stays because the JAX
    package has it, and PERF.md records what it costs.  One sort only,
    after round 0, as in the JAX package.

    Per-lane results are bitwise invariant under the permutation: every
    operation along the lane axis is per lane.  The bookkeeping is op for
    op the whole-solve kernel's epilogue, so without compaction the result
    equals ops.fused_solve.fused_solve's bit for bit."""
    kv, kvt, mix, alpha, lam_sg, lam_jl, start, goal, ox, oy, ow = kargs
    B = alpha.shape[-1]
    dev = alpha.device
    s = start_rounds(alpha, lam_sg, lam_jl)
    lanes = (start, goal, ox, oy, ow)
    perm = torch.arange(B, device=dev)   # lane i holds original lane perm[i]
    last_steps = s.ful[0]
    for r, n_r in enumerate(fs.inner_schedule(cfg)):
        if cfg.lane_compaction and r == 1:
            p = compaction_order(s.ful, s.floss, last_steps)
            s = Rounds(*take_lanes(p, *s))
            lanes = take_lanes(p, *lanes)
            perm, last_steps = take_lanes(p, perm, last_steps)
        lr0 = torch.full((1, B), fs.round_lr(cfg, r, solver),
                         dtype=torch.float32, device=dev)
        out = fs.fused_round(cfg, kv, kvt, mix, s.alpha, s.lam_sg, s.lam_jl,
                             s.ful, lr0, n_r, *lanes, solver=solver,
                             plan=plan, **tier)
        s = after_round(cfg, s, out)
        last_steps = out.inner[0]
    return rounds_result(s, perm)


def _pallas_solve(cfg: PlannerConfig, basis: Basis, scenarios: Scenario,
                  alpha0: Optional[torch.Tensor], solver: str) -> SolveResult:
    """The penalty-method dual loop over the per-step kernels (op for op
    irm_motion_planning_tpu/solvers/fleet.py::_pallas_solve): per round, the
    fused evaluation (K5) under the lane's penalties; the round's inner
    steps, one launch each of K3 (BLS in the ladder tier of ``cfg``,
    learning rate from bls_lr_start) or
    K4 (GD, the per-lane gd_lr[outer_iter]); for BLS with the linearized
    ladder the exact re-evaluation of (traj, vel) (K6), since the ladder's
    planes drift; the constraint check and the penalty escalation.  Lanes
    fulfilled in an earlier round enter minimized, so they pass through.

    The state lives in kernel layout (J, T, B) in buffers allocated once per
    solve (the kernels take no workspace: their scratch stays on chip); the
    step kernels update it in place.  A step
    counts where the lane was live before it and after it.  Frozen lanes
    pass through unchanged, so the driver stops launching steps once no
    lane of the round is live (one host check per step) and stops the rounds
    once every lane is fulfilled: the launches a solve makes depend on its
    lanes, up to ``sum(schedule)`` steps and one K5 (and K6) per round."""
    (kv, kvt, mix, a0, lam_sg, lam_jl, start, goal, ox, oy,
     ow) = fused_args(cfg, basis, scenarios, alpha0)[1:]
    B = a0.shape[-1]
    dev = a0.device
    gd = solver == "gd"
    step = "gd_inner_step" if gd else "bls_inner_step"
    exact_cc = (not gd and cfg.ladder_eval == "linearized"
                and cfg.exact_constraint_eval)
    gd_schedule = torch.tensor(cfg.gd_lr, dtype=torch.float32, device=dev)
    inc = float(cfg.lambda_constraint_increase)
    alpha = a0.clone()
    ev = sk.PallasEval(torch.empty((1, B), dtype=torch.float32, device=dev),
                       *(torch.empty_like(alpha) for _ in range(3)))
    fulfilled = torch.zeros(B, dtype=torch.bool, device=dev)
    outer_iter = torch.zeros(B, dtype=torch.int32, device=dev)
    total_inner = torch.zeros(B, dtype=torch.int32, device=dev)
    final_loss = torch.full((B,), float("inf"), device=dev)
    lanes = (lam_sg, lam_jl, start, goal, ox, oy, ow)

    def inner_round(round_idx):
        """One penalty round; returns (traj, vel, iters, loss)."""
        bound = inner_loop_bound(cfg, round_idx)
        sk.cost_grad_eval(cfg, kv, kvt, mix, alpha, *lanes, out=ev)
        if gd:
            lr = gd_schedule[torch.clip(outer_iter, 0, len(cfg.gd_lr) - 1)
                             .long()][None]
        else:
            lr = torch.full((1, B), cfg.bls_lr_start, dtype=torch.float32,
                            device=dev)
        state = sk.PallasStep(alpha, ev.grad, ev.traj, ev.vel, ev.loss, lr,
                              fulfilled.to(torch.float32)[None])
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(bound if cfg.fixed_iters else cfg.max_inner_iteration):
            live = state.minimized[0] < 0.5
            if not bool(live.any()):
                break
            getattr(sk, step)(cfg, kv, kvt, mix, *state, *lanes, out=state)
            iters += (live & (state.minimized[0] < 0.5)).to(torch.int32)
        traj, vel = state.new_traj, state.new_vel
        if exact_cc:
            traj, vel = sk.forward_eval(cfg, kv, mix, alpha, out=(traj, vel))
        return traj, vel, iters, state.new_loss[0]

    r = 0
    while (r < cfg.max_outer_iteration if cfg.fixed_iters else bool(
            ((outer_iter < cfg.max_outer_iteration) & ~fulfilled).any())):
        if bool(fulfilled.all()):
            break
        traj, vel, iters, loss = inner_round(r if cfg.fixed_iters else None)
        ok = fs.constraints_ok(cfg, traj, vel, start, goal)
        was = fulfilled
        now = was | ok
        outer_iter = torch.where(now, outer_iter, outer_iter + 1)
        lam_sg = torch.where(now, lam_sg, lam_sg * inc)
        lam_jl = torch.where(now, lam_jl, lam_jl * inc)
        lanes = (lam_sg, lam_jl) + lanes[2:]
        total_inner = total_inner + iters
        final_loss = torch.where(was, final_loss, loss)
        fulfilled = now
        r += 1
    return SolveResult(
        alpha=alpha_from_fleet(alpha.movedim(0, 1)),
        stats=SolveStats(outer_iters=outer_iter, inner_iters=total_inner,
                         converged=fulfilled, final_cost=final_loss),
    )


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def fleet_solve(cfg: PlannerConfig, basis: Basis, scenarios: Scenario,
                alpha0: Optional[torch.Tensor] = None, solver: str = "bls",
                backend: str = "xla") -> SolveResult:
    """Solve a batch of scenes (leading-batch Scenario); ``alpha0`` is an
    optional (B, T, J) warm start.  ``solver``: ``"bls"`` (in the ladder
    tier ``cfg.ladder_eval``) or ``"gd"``.  ``backend``: ``"xla"`` (the
    plain engine, the default, as in the JAX package), ``"fused"`` (the
    whole-solve kernels: one launch per solve, or one per round with
    ``cfg.lane_compaction``) or ``"pallas"`` (the per-step kernels); each
    runs both solvers and both ladder tiers.  Past the float32 plans'
    ceiling ``"fused"`` runs the bf16 tier's plan where ``cfg.bls_bf16_ladder``
    opts in (linearized BLS); it warns and runs ``"xla"`` where no plan
    fits, and ``"pallas"`` does so for the bf16 plan too.  The device of the
    scenes decides where it runs.  Returns leading-batch results."""
    if solver not in ("bls", "gd"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "bls" and cfg.bls_mode == "sequential":
        raise ValueError(
            "bls_mode='sequential' is not supported by the fleet engine; "
            "use bls_mode='ladder' (same trial sequence)"
        )
    if cfg.lane_compaction and backend != "fused":
        # Compaction re-sorts round-boundary state between kernel launches;
        # the other engines have none.  Never ignore it silently.
        raise ValueError(
            f"lane_compaction=True requires backend='fused' (got "
            f"{backend!r}); unset it or switch backends"
        )
    if backend not in ("fused", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    # The plans' ceiling (one lane's state per CTA) does not depend on the
    # lanes per CTA; for the per-step kernels pallas_block_b is threads per
    # CTA, which K1's plan would read as warps.
    plan = (fs.kernel_plan(cfg if backend == "fused"
                           else cfg.replace(pallas_block_b=0),
                           scenarios.obstacles.shape[-2], solver)
            if backend in ("fused", "pallas") else None)
    if backend in ("fused", "pallas") and (plan is None or (
            backend == "pallas" and plan["bf16"])):
        # No launch plan fits (even the streamed basis leaves too little
        # shared memory for one warp at this T and J, or J is past the
        # kernels' builds), or the plan is the bf16 tier's, which only K1/K2
        # have: the plain engine runs any size.
        import warnings

        B = scenarios.start.shape[0]
        J = cfg.n_joints
        why = ((f"the kernels take 1 <= J <= {fs.MAX_JOINTS} joints"
                if not 1 <= J <= fs.MAX_JOINTS else
                f"shared memory over the {fs.SMEM_PER_CTA_MAX}-byte cap per "
                f"CTA even with the streamed basis") if plan is None else
               "the per-step kernels have no bf16 ladder tier; use "
               "backend='fused' for it")
        warnings.warn(
            f"pallas backends infeasible for T={cfg.n_timesteps}, J={J}, "
            f"B={B} ({why}); falling back to backend='xla'"
            + (" — lane_compaction is DROPPED on this path (it is a "
               "fused-kernel driver feature)" if cfg.lane_compaction
               else ""),
            stacklevel=2,
        )
        backend = "xla"
        cfg = cfg.replace(lane_compaction=False)
    if backend == "pallas":
        fs.solver_check(solver)(cfg)
        return _pallas_solve(cfg, basis, scenarios, alpha0, solver)
    if backend == "xla":
        if cfg.matmul_precision != "highest":
            raise NotImplementedError(
                "only matmul_precision='highest' (full fp32) is implemented"
            )
        fsc = to_fleet(scenarios)
        a0 = (fleet_init_alpha(cfg, basis, fsc) if alpha0 is None
              else alpha_to_fleet(alpha0))
        B = a0.shape[-1]
        penalty0 = Penalty(
            torch.full((B,), cfg.lambda_sg_constraint, device=a0.device),
            torch.full((B,), cfg.lambda_jl_constraint, device=a0.device),
        )
        make_inner = make_gd_inner if solver == "gd" else make_bls_inner
        res = run_dual_loop(
            cfg, a0, make_inner(cfg, basis, fsc),
            constraints_fn=lambda a: fleet_constraints(cfg, basis, fsc, a),
            penalty0=penalty0,
        )
        return SolveResult(alpha=alpha_from_fleet(res.alpha), stats=res.stats)
    args = fused_args(cfg, basis, scenarios, alpha0)
    tier = {"bf16": plan["bf16"]}
    if cfg.lane_compaction:
        return _fused_rounds_solve(cfg, args[1:], solver, **tier)
    return kernel_result(fs.fused_solve(*args, solver=solver, **tier))


def make_fleet_solver(cfg: PlannerConfig, basis: Basis, solver: str = "bls",
                      backend: str = "xla"):
    """A solver bound to (cfg, basis): leading-batch Scenario ->
    SolveResult."""

    def run(scenarios: Scenario) -> SolveResult:
        return fleet_solve(cfg, basis, scenarios, solver=solver,
                           backend=backend)

    return run
