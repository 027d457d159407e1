"""The fused kernels and their plain PyTorch versions (counterparts of
``pallas_step.fused_solve`` and ``pallas_step.fused_round`` /
``_make_solve_kernel`` in irm_motion_planning_tpu/ops/pallas_step.py), for
both solvers: BLS (``solver="bls"``, either ladder tier) and GD
(``solver="gd"``).

A penalty round is: a fused cost/gradient evaluation, the inner loop to the
round's budget, and the hard-constraint check on the exact evaluation.  A
BLS step takes the normalized direction and the Armijo ladder, in one of
two tiers (``cfg.ladder_eval``).  Linearized: the ladder runs on the
linearized trajectory, the accepted rung's FK is carried into the gradient
pull-back, and the round ends with an exact re-evaluation of the trajectory
(the linearized carry drifts).  Exact: each rung's candidate alpha goes
through the basis, the accepted iterate is evaluated exactly with the loss
recomputed, and the round ends on that evaluation.  A GD step evaluates the
trial ``(1 - lambda_reg lr) alpha - lr grad`` exactly; the stop test
rejects it, and the round ends on its carried evaluation, which is already
exact.  ``fused_solve`` runs
every round of the whole penalty-method solve in one call, with the x10
penalty escalation on lanes that still fail (GD's learning rate per round
from ``gd_lr``); ``fused_round`` runs one round from a per-lane learning
rate and leaves the escalation to its caller (solvers/fleet.py, which
re-sorts lanes between rounds).

Layout: lanes trailing.  Per-joint planes are ``(J, T, B)``, per-lane
scalars ``(B,)`` inside and ``(1, B)`` at the public functions, obstacles
``(O, B)``.

The wrappers take the plain version for CPU tensors and launch the CUDA
kernels (csrc/fused_solve.cu: one warp per lane, the warp body in
csrc/warp_body.cuh, ``cfg.pallas_block_b`` lanes per CTA as
:func:`launch_plan` checks, a persistent grid over a lane queue) for CUDA
tensors; they never fall back.  The plain versions run all lanes in
lockstep with per-lane masks, so their per-lane results equal the kernels'
per-lane early exits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import PlannerConfig

# Most penalty rounds the kernel's parameter block holds.
MAX_ROUNDS = 32
# The solvers of the fused kernels.
SOLVERS = ("bls", "gd")
# Their compiled programs, by the index of their instantiation in
# csrc/fused_solve.cu (SOLVER_BLS = 0, SOLVER_GD = 1, SOLVER_BLS_EXACT = 2):
# BLS has one per ladder tier.
PROGRAMS = ("bls", "gd", "bls_exact")
# The warp-per-lane kernels (csrc/warp_body.cuh): lanes (warps) per CTA,
# ``cfg.pallas_block_b`` or DEFAULT_WARPS when it is 0, at most MAX_WARPS;
# two timesteps per thread, so at most WARP_MAX_T timesteps.
DEFAULT_WARPS = 16
MAX_WARPS = 16
WARP_MAX_T = 64
# Hopper's dynamic shared memory per block (opt-in).
SMEM_PER_CTA_MAX = 232448


class FusedSolve(NamedTuple):
    alpha: torch.Tensor        # (J, T, B)
    final_loss: torch.Tensor   # (1, B)
    fulfilled: torch.Tensor    # (1, B) f32 0/1
    outer_iters: torch.Tensor  # (1, B) f32
    inner_iters: torch.Tensor  # (1, B) f32


class FusedRound(NamedTuple):
    alpha: torch.Tensor        # (J, T, B)
    loss: torch.Tensor         # (1, B) end-of-round loss (0 on lanes that
    #                            came in fulfilled: mask with fulfilled)
    ok: torch.Tensor           # (1, B) f32 0/1 hard-constraint check (1 on
    #                            lanes that came in fulfilled)
    inner: torch.Tensor        # (1, B) f32 accepted steps this round


class Consts(NamedTuple):
    """Python-float constants of the kernel body, folded as the JAX kernel
    folds them (pallas_step._Body): by-constant divisions become multiplies
    by reciprocals, and sqrt(0.5) is folded into the limit-loss scales."""

    link: tuple
    mean_jp: float
    inv_std_jp_h: float
    inv_vmax_h: float
    inv_T: float
    inv_std2_T: float
    inv_vmax2_T: float


def consts(cfg: PlannerConfig) -> Consts:
    T = cfg.n_timesteps
    mean_jp = 0.5 * (cfg.max_joint_position + cfg.min_joint_position)
    std_jp = 0.5 * (cfg.max_joint_position - mean_jp)
    return Consts(
        link=tuple(float(l) for l in cfg.link_length),
        mean_jp=mean_jp,
        inv_std_jp_h=0.5**0.5 / std_jp,
        inv_vmax_h=0.5**0.5 / cfg.max_joint_velocity,
        inv_T=1.0 / T,
        inv_std2_T=1.0 / (std_jp * std_jp * T),
        inv_vmax2_T=1.0 / (cfg.max_joint_velocity * cfg.max_joint_velocity * T),
    )


def inner_schedule(cfg: PlannerConfig) -> list:
    """Inner-step budget of each penalty round: the schedule in fixed_iters
    mode, else max_inner_iteration (the lane's own stop test ends it)."""
    if cfg.inner_schedule is not None and cfg.fixed_iters:
        return [int(x) for x in cfg.inner_schedule]
    return [cfg.max_inner_iteration] * cfg.max_outer_iteration


# ---------------------------------------------------------------------------
# Plain PyTorch version, built from the pieces of pallas_step._Body.
# ---------------------------------------------------------------------------


def forward_planes(kv, mix, planes):
    """planes (J, T, B) -> (traj, vel) (J, T, B): ``kv @ plane_j`` for each
    joint, then the mix combine ``out_i = sum_j raw_j mix[j, i]``."""
    J, T = planes.shape[0], planes.shape[1]
    raw = torch.matmul(kv, planes)                      # (J, 2T, B)
    out = []
    for i in range(J):
        acc = raw[0] * mix[0, i]
        for j in range(1, J):
            acc = acc + raw[j] * mix[j, i]
        out.append(acc)
    out = torch.stack(out)
    return out[:, :T], out[:, T:]


def fk_ee(c: Consts, traj):
    """End-effector rollout.  Returns (ee_x, ee_y, px, py) with the per-link
    tangent terms px[j] = L_j cos(c_j), py[j] = L_j sin(c_j), c_j the
    cumulative joint angle."""
    J = traj.shape[0]
    ang = [traj[0]]
    for j in range(1, J):
        ang.append(ang[-1] + traj[j])
    px = torch.stack([c.link[j] * torch.cos(ang[j]) for j in range(J)])
    py = torch.stack([c.link[j] * torch.sin(ang[j]) for j in range(J)])
    ee_x, ee_y = px[0], py[0]
    for j in range(1, J):
        ee_x = ee_x + px[j]
        ee_y = ee_y + py[j]
    return ee_x, ee_y, px, py


def obs_ctx(ox, oy, ow):
    """Loop-invariant obstacle terms: q_o = 0.5 + 0.5 |o|^2 and 0.8 w_o."""
    return ox, oy, 0.5 + 0.5 * (ox * ox + oy * oy), 0.8 * ow


def obstacle_cost_v(ee_x, ee_y, obs):
    """Obstacle field in dot-product form: 0.5 |ee - o|^2 + 0.5 =
    (h + q_o) - (ox ee_x + oy ee_y), h = 0.5 |ee|^2.  (T, B) -> (T, B)."""
    ox, oy, q, ow8 = obs
    h = 0.5 * (ee_x * ee_x + ee_y * ee_y)
    acc = torch.zeros_like(ee_x)
    for o in range(ox.shape[0]):
        s = (h + q[o]) - (ox[o] * ee_x + oy[o] * ee_y)
        acc = acc + ow8[o] * (1.0 / s)
    return acc


def scalar_cost(cfg: PlannerConfig, c: Consts, traj, vel, cost_v, start, goal,
                lam_sg, lam_jl):
    """Penalized loss per lane (B,) from the evaluated planes and the
    per-timestep obstacle cost."""
    T, J = traj.shape[1], traj.shape[0]
    lam_max = cfg.lambda_max_cost
    toc = lam_max * cost_v.max(dim=0).values + ((1.0 - lam_max) / T) * cost_v.sum(0)
    sgpc = torch.zeros_like(toc)
    sgvc = torch.zeros_like(toc)
    jpc = torch.zeros_like(toc)
    jvc = torch.zeros_like(toc)
    for j in range(J):
        ds = traj[j, 0] - start[j]
        dg = traj[j, T - 1] - goal[j]
        sgpc = sgpc + 0.5 * (ds * ds + dg * dg)
        vs = vel[j, 0]
        vg = vel[j, T - 1]
        sgvc = sgvc + 0.5 * (vs * vs + vg * vg)
        zp = (traj[j] - c.mean_jp) * c.inv_std_jp_h
        pl_ = zp * zp
        zv = vel[j] * c.inv_vmax_h
        vl_ = zv * zv
        if cfg.constraint_violating_dependant_loss:
            pl_ = torch.where(_pos_mask(cfg, traj[j]), pl_, 0.0)
            vl_ = torch.where(_vel_mask(cfg, vel[j]), vl_, 0.0)
        jpc = jpc + pl_.sum(0) * c.inv_T
        jvc = jvc + vl_.sum(0) * c.inv_T
    return toc + lam_sg * (sgpc + sgvc) + lam_jl * (jpc + jvc)


def _pos_mask(cfg, x):
    return (x > cfg.joint_safety_limit * cfg.max_joint_position) | (
        x < cfg.joint_safety_limit * cfg.min_joint_position
    )


def _vel_mask(cfg, v):
    return v.abs() > cfg.joint_safety_limit * cfg.max_joint_velocity


def cost_grad_from_traj(cfg: PlannerConfig, c: Consts, kvt, mix, nt, nv,
                        start, goal, obs, lam_sg, lam_jl, fk=None,
                        skip_loss=False):
    """Loss and alpha-gradient at an evaluated (traj, vel).  ``fk``: the FK
    tangent planes (px, py) already evaluated at ``nt`` (the BLS FK carry);
    ``skip_loss``: do not recompute the loss.  Returns (loss (B,) or None,
    grad (J, T, B), px, py)."""
    J, T = nt.shape[0], nt.shape[1]
    lam_max = cfg.lambda_max_cost
    ox, oy, q, ow8 = obs
    if fk is None:
        ee_x, ee_y, px, py = fk_ee(c, nt)
    else:
        px, py = fk
        ee_x, ee_y = px[0], py[0]
        for j in range(1, J):
            ee_x = ee_x + px[j]
            ee_y = ee_y + py[j]

    # grad of the field = sum_o c_o (ee - o), c_o = -0.8 w_o / s_o^2, kept as
    # the factored sums csum = sum c_o and co{x,y} = sum c_o o.
    h = 0.5 * (ee_x * ee_x + ee_y * ee_y)
    cost_v = torch.zeros_like(ee_x)
    csum = torch.zeros_like(ee_x)
    cox = torch.zeros_like(ee_x)
    coy = torch.zeros_like(ee_x)
    for o in range(ox.shape[0]):
        s = (h + q[o]) - (ox[o] * ee_x + oy[o] * ee_y)
        inv = 1.0 / s
        winv = ow8[o] * inv
        cost_v = cost_v + winv
        coef = winv * inv
        csum = csum + coef
        cox = cox + coef * ox[o]
        coy = coy + coef * oy[o]
    gx = cox - ee_x * csum
    gy = coy - ee_y * csum

    # Blend weights: lam_max on the FIRST argmax over T, plus the mean.
    rows = torch.arange(T, device=nt.device)[:, None]
    cmax = cost_v.max(dim=0, keepdim=True).values
    first_max = torch.where(cost_v == cmax, rows, T).min(dim=0, keepdim=True).values
    wblend = lam_max * (rows == first_max).to(torch.float32) + (
        (1.0 - lam_max) / T
    )
    wgx = wblend * gx
    wgy = wblend * gy

    # Workspace Jacobian: suffix sums of the FK tangents rotated 90 degrees.
    jac_x, jac_y = [None] * J, [None] * J
    accx = torch.zeros_like(ee_x)
    accy = torch.zeros_like(ee_x)
    for j in range(J - 1, -1, -1):
        accx = accx + (-py[j])
        accy = accy + px[j]
        jac_x[j], jac_y[j] = accx, accy

    loss = None if skip_loss else scalar_cost(
        cfg, c, nt, nv, cost_v, start, goal, lam_sg, lam_jl
    )

    stacked = []
    for j in range(J):
        toc_g = wgx * jac_x[j] + wgy * jac_y[j]
        sgp = torch.zeros_like(ee_x)
        sgp[0] = nt[j, 0] - start[j]
        sgp[T - 1] = nt[j, T - 1] - goal[j]
        sgv = torch.zeros_like(ee_x)
        sgv[0] = nv[j, 0]
        sgv[T - 1] = nv[j, T - 1]
        jp = (nt[j] - c.mean_jp) * c.inv_std2_T
        jv = nv[j] * c.inv_vmax2_T
        if cfg.constraint_violating_dependant_loss:
            jp = torch.where(_pos_mask(cfg, nt[j]), jp, 0.0)
            jv = torch.where(_vel_mask(cfg, nv[j]), jv, 0.0)
        stacked.append(torch.cat([toc_g + lam_sg * sgp + lam_jl * jp,
                                  lam_sg * sgv + lam_jl * jv]))
    pulled = torch.matmul(kvt, torch.stack(stacked))   # (J, T, B)
    grad = []
    for j in range(J):
        acc = pulled[0] * mix[j, 0]
        for i in range(1, J):
            acc = acc + pulled[i] * mix[j, i]
        grad.append(acc)
    return loss, torch.stack(grad), px, py


def cost_grad_eval(cfg: PlannerConfig, c: Consts, kv, kvt, mix, alpha, start,
                   goal, obs, lam_sg, lam_jl):
    """Fused loss, gradient and evaluation at alpha (J, T, B).  Returns
    (loss (B,), grad, traj, vel, px, py)."""
    nt, nv = forward_planes(kv, mix, alpha)
    loss, grad, px, py = cost_grad_from_traj(
        cfg, c, kvt, mix, nt, nv, start, goal, obs, lam_sg, lam_jl
    )
    return loss, grad, nt, nv, px, py


def count_work(tally, key: str, lanes) -> None:
    """Add the lanes of the (B,) bool mask ``lanes`` to ``tally[key]`` (a
    per-lane float count) when a tally is kept.  The plain versions count
    the work each lane's kernel thread does (round starts, steps, ladder
    rungs, pull-backs), which the bounds in ops/roofline.py are made of."""
    if tally is not None:
        tally[key] = tally.get(key, 0.0) + lanes.to(torch.float32)


def bls_step(cfg: PlannerConfig, c: Consts, kv, kvt, mix, start, goal, obs,
             lam_sg, lam_jl, alpha, grad, traj, vel, loss, bls_lr, minimized,
             px=None, py=None, tally=None):
    """One BLS inner step for every lane (pallas_step._bls_step) in the
    ladder tier ``cfg.ladder_eval``.  ``minimized`` (B,) bool freezes lanes.

    Linearized: each rung's candidate is the linearized trajectory.  With
    ``px``/``py`` given, the accepted rung's FK planes are carried into the
    pull-back and its loss is reused; without them the loss is recomputed at
    the accepted iterate (the per-step kernel's mode).  Exact: each rung's
    candidate alpha ``(1 - lambda_reg lr_r) alpha - lr_r n_grad`` goes
    through the basis; the accepted iterate is evaluated exactly (also when
    the stop test fires) and, unless it fires, its loss and gradient are
    recomputed there; no FK carry (``px``/``py`` must be None).  ``tally``:
    see :func:`count_work`.  Returns (alpha, grad, traj, vel, loss, lr,
    minimized[, px, py])."""
    n = cfg.max_bls_iteration
    frozen = minimized
    exact = cfg.ladder_eval == "exact"
    carry_fk = px is not None
    if exact and carry_fk:
        raise ValueError("the exact ladder has no FK carry")
    count_work(tally, "steps", ~frozen)

    g2 = (grad * grad).sum(dim=1).sum(dim=0)
    inv_norm = 1.0 / torch.sqrt(g2)
    n_grad = grad * inv_norm
    # Reference quirk (optimizer_BLS.py:86): the sum over ALL (J, J) entries
    # of grad^T n_grad, i.e. sum_t rowsum(grad)_t rowsum(n_grad)_t.
    gsum = grad.sum(dim=0)
    alpha_norm = (gsum * (gsum * inv_norm)).sum(dim=0)

    if not exact:
        gtraj, gvel = forward_planes(kv, mix, n_grad)
        dir_t = cfg.lambda_reg * traj + gtraj
        dir_v = cfg.lambda_reg * vel + gvel

    found = torch.zeros_like(frozen)
    lr_best = torch.zeros_like(loss)
    loss_best = loss.clone()
    if carry_fk:
        cpx, cpy = px.clone(), py.clone()
    rung = np.float32(1.0)
    for k in range(n):
        # Lockstep: stop once every live lane has its first Armijo pass.
        if k > 0 and not bool((~found & ~frozen).any()):
            break
        lr_r = bls_lr * float(rung)
        count_work(tally, "rungs", ~found & ~frozen)
        if exact:
            cand_t, cand_v = forward_planes(
                kv, mix, (1.0 - cfg.lambda_reg * lr_r) * alpha - lr_r * n_grad)
        else:
            cand_t = traj - lr_r * dir_t
            cand_v = vel - lr_r * dir_v
        ee_x, ee_y, rpx, rpy = fk_ee(c, cand_t)
        cost_v = obstacle_cost_v(ee_x, ee_y, obs)
        closs = scalar_cost(cfg, c, cand_t, cand_v, cost_v, start, goal,
                            lam_sg, lam_jl)
        required = loss - cfg.bls_alpha * lr_r * alpha_norm
        ok = (closs <= required) & ~found
        found = found | ok
        lr_best = torch.where(ok, lr_r, lr_best)
        loss_best = torch.where(ok, closs, loss_best)
        if carry_fk:
            cpx = torch.where(ok, rpx, cpx)
            cpy = torch.where(ok, rpy, cpy)
        rung = np.float32(rung * np.float32(cfg.bls_beta_minus))

    lr_eff = torch.where(found, lr_best, 0.0)
    new_lr = torch.where(found, lr_best * cfg.bls_beta_plus,
                         bls_lr * (cfg.bls_beta_minus ** n))
    stop = (loss - loss_best) < cfg.loop_loss_reduction
    count_work(tally, "pullbacks", ~frozen & ~stop)

    a_fac = 1.0 - cfg.lambda_reg * lr_eff
    new_alpha = a_fac * alpha - lr_eff * n_grad
    if exact:
        nt, nv = forward_planes(kv, mix, new_alpha)
    else:
        nt = traj - lr_eff * dir_t
        nv = vel - lr_eff * dir_v
    if carry_fk:
        nloss, npx, npy = loss_best, cpx, cpy
        _, ngrad, _, _ = cost_grad_from_traj(
            cfg, c, kvt, mix, nt, nv, start, goal, obs, lam_sg, lam_jl,
            fk=(npx, npy), skip_loss=True,
        )
    else:
        nloss, ngrad, npx, npy = cost_grad_from_traj(
            cfg, c, kvt, mix, nt, nv, start, goal, obs, lam_sg, lam_jl
        )

    # The stop test does not reject the step: alpha, traj and vel move, the
    # gradient is kept, the loss becomes the accepted rung's.
    out = (
        torch.where(frozen, alpha, new_alpha),
        torch.where(frozen | stop, grad, ngrad),
        torch.where(frozen, traj, nt),
        torch.where(frozen, vel, nv),
        torch.where(frozen, loss, torch.where(stop, loss_best, nloss)),
        torch.where(frozen, bls_lr, new_lr),
        minimized | stop,
    )
    if carry_fk:
        out = out + (torch.where(frozen, px, npx), torch.where(frozen, py, npy))
    return out


def gd_step(cfg: PlannerConfig, c: Consts, kv, kvt, mix, start, goal, obs,
            lam_sg, lam_jl, alpha, grad, traj, vel, loss, lr, minimized,
            tally=None):
    """One GD inner step for every lane (pallas_step._gd_step): the trial
    ``(1 - lambda_reg lr) alpha - lr grad``, the fused evaluation at it, and
    the stop test, which REJECTS the trial (alpha, grad, traj, vel and loss
    keep their incoming values).  ``lr`` (B,) passes through; ``minimized``
    (B,) bool freezes lanes.  ``tally``: see :func:`count_work`.  Returns (alpha,
    grad, traj, vel, loss, lr, minimized)."""
    frozen = minimized
    a_fac = 1.0 - cfg.lambda_reg * lr
    trial = a_fac * alpha - lr * grad
    nloss, ngrad, nt, nv, _, _ = cost_grad_eval(
        cfg, c, kv, kvt, mix, trial, start, goal, obs, lam_sg, lam_jl
    )
    stop = (loss - nloss) < cfg.loop_loss_reduction
    keep = frozen | stop
    count_work(tally, "steps", ~frozen)
    count_work(tally, "accepted", ~keep)
    return (
        torch.where(keep, alpha, trial),
        torch.where(keep, grad, ngrad),
        torch.where(keep, traj, nt),
        torch.where(keep, vel, nv),
        torch.where(keep, loss, nloss),
        lr,
        minimized | stop,
    )


def constraints_ok(cfg: PlannerConfig, traj, vel, start, goal):
    """Per-lane hard-constraint check (B,) bool on evaluated planes."""
    T = traj.shape[1]
    ps = ((traj[:, 0] - start) ** 2).sum(0)
    pg = ((traj[:, T - 1] - goal) ** 2).sum(0)
    vs = (vel[:, 0] ** 2).sum(0)
    vg = (vel[:, T - 1] ** 2).sum(0)
    pos_ok = (torch.sqrt(ps) < cfg.eps_position) & (torch.sqrt(pg) < cfg.eps_position)
    vel_ok = (torch.sqrt(vs) < cfg.eps_velocity) & (torch.sqrt(vg) < cfg.eps_velocity)
    box_ok = (traj.amax(dim=(0, 1)) <= cfg.max_joint_position) & (
        traj.amin(dim=(0, 1)) >= cfg.min_joint_position
    )
    vbox_ok = vel.abs().amax(dim=(0, 1)) <= cfg.max_joint_velocity
    return pos_ok & vel_ok & box_ok & vbox_ok


def run_inner(cfg, c, kv, kvt, mix, start, goal, obs, alpha, lam_sg, lam_jl,
              minimized, lr, n_r, icnt, tally=None, solver="bls"):
    """Round-start fused evaluation and up to ``n_r`` steps of ``solver``
    from the per-lane learning rate ``lr`` (B,).  BLS with the linearized
    ladder (FK carry) then re-evaluates (traj, vel) exactly from the final
    alpha (its linearized carry drifts); GD's and the exact ladder's carried
    (traj, vel) are the exact evaluation of alpha already (an accepted
    iterate's, or the round start's), so re-evaluating would change nothing
    and, as in the JAX kernel, is skipped.  Shared by both plain versions,
    as pallas_step's run_inner serves both TPU kernels.  ``tally``: see
    :func:`count_work`.  Returns (alpha, traj, vel, loss, icnt)."""
    gd = _solver_is_gd(solver)
    linearized = not gd and cfg.ladder_eval == "linearized"
    count_work(tally, "rounds", ~minimized)
    loss, grad, traj, vel, px, py = cost_grad_eval(
        cfg, c, kv, kvt, mix, alpha, start, goal, obs, lam_sg, lam_jl
    )
    for _ in range(n_r):
        if not bool((~minimized).any()):
            break
        if gd:
            alpha, grad, traj, vel, loss, lr, new_min = gd_step(
                cfg, c, kv, kvt, mix, start, goal, obs, lam_sg, lam_jl,
                alpha, grad, traj, vel, loss, lr, minimized, tally=tally,
            )
        elif linearized:
            (alpha, grad, traj, vel, loss, lr, new_min, px, py) = bls_step(
                cfg, c, kv, kvt, mix, start, goal, obs, lam_sg, lam_jl,
                alpha, grad, traj, vel, loss, lr, minimized, px=px, py=py,
                tally=tally,
            )
        else:
            alpha, grad, traj, vel, loss, lr, new_min = bls_step(
                cfg, c, kv, kvt, mix, start, goal, obs, lam_sg, lam_jl,
                alpha, grad, traj, vel, loss, lr, minimized, tally=tally,
            )
        # A step counts when the lane was live before it and after it.
        icnt = icnt + (~minimized & ~new_min).to(torch.float32)
        minimized = new_min
    if linearized:
        traj, vel = forward_planes(kv, mix, alpha)
    return alpha, traj, vel, loss, icnt


def _solver_is_gd(solver: str) -> bool:
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    return solver == "gd"


def round_lr(cfg: PlannerConfig, r: int, solver: str) -> float:
    """Round r's learning rate at the round start: ``bls_lr_start`` for
    BLS; for GD the schedule's ``gd_lr[min(r, len(gd_lr) - 1)]``
    (pallas_step's per-round selection)."""
    if not _solver_is_gd(solver):
        return cfg.bls_lr_start
    return cfg.gd_lr[min(r, len(cfg.gd_lr) - 1)]


def fused_solve_reference(cfg: PlannerConfig, kv, kvt, mix, a0, lam_sg0,
                          lam_jl0, start, goal, ox, oy, ow, tally=None,
                          solver: str = "bls") -> FusedSolve:
    """Plain PyTorch version of the fused solve kernel; same arguments and
    outputs as :func:`fused_solve`.  ``tally``: see :func:`count_work`."""
    c = consts(cfg)
    obs = obs_ctx(ox, oy, ow)
    inc = float(cfg.lambda_constraint_increase)
    B = a0.shape[-1]
    alpha = a0.clone()
    lam_sg, lam_jl = lam_sg0.reshape(B).clone(), lam_jl0.reshape(B).clone()
    zeros = torch.zeros(B, dtype=torch.float32, device=a0.device)
    fulfilled = torch.zeros(B, dtype=torch.bool, device=a0.device)
    outer, icnt = zeros.clone(), zeros.clone()
    floss = torch.full_like(zeros, float("inf"))
    for r, n_r in enumerate(inner_schedule(cfg)):
        if bool(fulfilled.all()):
            break
        lr0 = torch.full_like(zeros, round_lr(cfg, r, solver))
        alpha, traj, vel, loss, icnt = run_inner(
            cfg, c, kv, kvt, mix, start, goal, obs, alpha, lam_sg, lam_jl,
            fulfilled, lr0, n_r, icnt, tally, solver,
        )
        now = fulfilled | constraints_ok(cfg, traj, vel, start, goal)
        floss = torch.where(fulfilled, floss, loss)
        outer = torch.where(now, outer, outer + 1.0)
        lam_sg = torch.where(now, lam_sg, lam_sg * inc)
        lam_jl = torch.where(now, lam_jl, lam_jl * inc)
        fulfilled = now
    return FusedSolve(alpha, floss[None], fulfilled.to(torch.float32)[None],
                      outer[None], icnt[None])


def fused_round_reference(cfg: PlannerConfig, kv, kvt, mix, alpha, lam_sg,
                          lam_jl, fulfilled, lr0, n_r: int, start, goal, ox,
                          oy, ow, tally=None,
                          solver: str = "bls") -> FusedRound:
    """Plain PyTorch version of the fused-round kernel; same arguments and
    outputs as :func:`fused_round`.  Lanes that come in fulfilled start
    minimized (alpha passes through, no step counts) and report loss 0 and
    ok 1, as the TPU kernel's skipped tiles do.  ``tally``: see
    :func:`count_work`."""
    c = consts(cfg)
    B = alpha.shape[-1]
    was = fulfilled.reshape(B) > 0.5
    icnt = torch.zeros(B, dtype=torch.float32, device=alpha.device)
    alpha, traj, vel, loss, icnt = run_inner(
        cfg, c, kv, kvt, mix, start, goal, obs_ctx(ox, oy, ow), alpha,
        lam_sg.reshape(B), lam_jl.reshape(B), was, lr0.reshape(B), int(n_r),
        icnt, tally, solver,
    )
    ok = constraints_ok(cfg, traj, vel, start, goal) | was
    return FusedRound(alpha, torch.where(was, 0.0, loss)[None],
                      ok.to(torch.float32)[None], icnt[None])


# ---------------------------------------------------------------------------
# The CUDA kernel: parameter block, launch plan, checks and launch.
# ---------------------------------------------------------------------------


def warps_per_cta(cfg: PlannerConfig) -> int:
    """Lanes (warps) per CTA of K1/K2: ``cfg.pallas_block_b``, or
    DEFAULT_WARPS when it is 0.  Raises ValueError outside 1..MAX_WARPS."""
    w = cfg.pallas_block_b or DEFAULT_WARPS
    if not 1 <= w <= MAX_WARPS:
        raise ValueError(
            f"fused kernels: pallas_block_b is lanes (warps) per CTA, 1.."
            f"{MAX_WARPS} (0: {DEFAULT_WARPS}), got {cfg.pallas_block_b}"
        )
    return w


def launch_plan(cfg: PlannerConfig, O: int) -> dict:
    """K1/K2's dynamic shared memory per CTA, by piece, in bytes (mirror of
    warp_smem_bytes in csrc/warp_body.cuh, which re-checks it): per CTA the
    basis pair transposed (2 x 2T x T) and mix (padded to 12 floats); per
    warp the planes alpha, grad, dir_t, dir_v (J x T each), the buffer (8
    reduction rows of T padded to a multiple of 4, which also holds a
    product's staged input and the stacked gradient, 2T float4), the
    obstacle terms (float4 each) and the endpoints (20 floats).  Returns
    {"warps", "bytes": {piece: bytes}, "total"}.  Raises ValueError for a
    lanes-per-CTA value the kernels cannot take, NotImplementedError for a
    T beyond the on-chip design."""
    warps = warps_per_cta(cfg)
    T, J = cfg.n_timesteps, cfg.n_joints
    f = 4
    rows = (T + 3) // 4 * 4
    pieces = {
        "basis": f * 4 * T * T,
        "mix": f * 12,
        "planes": warps * f * 4 * J * T,
        "buffer": warps * f * 8 * rows,
        "obstacles": warps * f * 4 * O,
        "endpoints": warps * f * 20,
    }
    total = sum(pieces.values())
    if T > WARP_MAX_T or total > SMEM_PER_CTA_MAX:
        raise NotImplementedError(
            f"T={T}: the fused kernels hold the basis (8 T^2 bytes) and the "
            f"lane state on chip for T <= {WARP_MAX_T} within "
            f"{SMEM_PER_CTA_MAX} bytes per CTA (this plan: {total}); a "
            f"streamed basis for large T is ROADMAP queue 1 #13"
        )
    return {"warps": warps, "bytes": pieces, "total": total}


def launch_shape(cfg: PlannerConfig, O: int, B: int, kernel: str,
                 solver: str = "bls") -> dict:
    """What the card makes of the launch plan of K1 (``kernel=
    "fused_solve"``) or K2 (``"fused_round"``) for ``solver`` (BLS: in the
    ladder tier of ``cfg``): CTAs per SM (the CUDA occupancy calculator,
    registers and shared memory), SMs, shared memory per CTA as the C side
    computes it, warps per SM.  Needs the card."""
    from ._build import load_library

    warps = launch_plan(cfg, O)["warps"]
    out = (ctypes.c_int * 3)()
    err = load_library().fused_launch_shape(
        kernel_params(cfg, O, B), warps,
        {"fused_solve": 0, "fused_round": 1}[kernel],
        program_index(cfg, solver), out)
    if err:
        raise RuntimeError(f"{kernel}: launch shape refused (CUDA error {err})")
    return {"ctas_per_sm": out[0], "sms": out[1], "smem": out[2],
            "warps_per_sm": out[0] * warps}


def program(cfg: PlannerConfig, solver: str) -> str:
    """The compiled program of K1/K2 that runs ``solver`` under ``cfg``:
    GD's, or BLS's of the ladder tier ``cfg.ladder_eval``."""
    if _solver_is_gd(solver):
        return "gd"
    return "bls" if cfg.ladder_eval == "linearized" else "bls_exact"


def program_index(cfg: PlannerConfig, solver: str) -> int:
    """The instantiation index in csrc/fused_solve.cu of :func:`program`."""
    return PROGRAMS.index(program(cfg, solver))


class _Params(ctypes.Structure):
    """Mirror of ``struct FsParams`` in csrc/lane_body.cuh (passed by
    value), field for field in the same order; ``_build.load_library``
    refuses a library whose struct size or last-field offset differ, and
    tests/test_torch_fused_gd.py holds the field lists equal.  Float fields
    hold the f32 roundings of the Python-float constants, as JAX's weak
    typing rounds them."""

    _fields_ = [
        ("T", ctypes.c_int), ("O", ctypes.c_int), ("B", ctypes.c_int),
        ("rounds", ctypes.c_int), ("n_bls", ctypes.c_int),
        ("masked", ctypes.c_int),
        ("sched", ctypes.c_int * MAX_ROUNDS),
        ("link", ctypes.c_float * 3),
        ("mean_jp", ctypes.c_float), ("inv_std_jp_h", ctypes.c_float),
        ("inv_vmax_h", ctypes.c_float), ("inv_T", ctypes.c_float),
        ("inv_std2_T", ctypes.c_float), ("inv_vmax2_T", ctypes.c_float),
        ("lam_max", ctypes.c_float), ("mean_w", ctypes.c_float),
        ("pos_hi", ctypes.c_float), ("pos_lo", ctypes.c_float),
        ("vel_hi", ctypes.c_float),
        ("lambda_reg", ctypes.c_float), ("bls_alpha", ctypes.c_float),
        ("beta_plus", ctypes.c_float), ("beta_minus", ctypes.c_float),
        ("lr_fail", ctypes.c_float), ("lr_start", ctypes.c_float),
        ("loss_red", ctypes.c_float), ("inc", ctypes.c_float),
        ("eps_pos", ctypes.c_float), ("eps_vel", ctypes.c_float),
        ("max_jp", ctypes.c_float), ("min_jp", ctypes.c_float),
        ("max_jv", ctypes.c_float),
        ("gd_lr", ctypes.c_float * MAX_ROUNDS),
    ]


def kernel_params(cfg: PlannerConfig, O: int, B: int,
                  schedule: bool = True) -> _Params:
    """The kernels' parameter block; ``schedule=False`` leaves the round
    schedule out (the per-step kernels run no rounds).  ``gd_lr[r]`` is GD's
    learning rate of round r (:func:`round_lr`) for every r the block
    holds."""
    c = consts(cfg)
    sched = inner_schedule(cfg) if schedule else []
    if len(sched) > MAX_ROUNDS:
        raise NotImplementedError(
            f"the CUDA kernel takes at most {MAX_ROUNDS} penalty rounds"
        )
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    T = cfg.n_timesteps
    jsl = cfg.joint_safety_limit
    p = _Params(
        T=T, O=O, B=B, rounds=len(sched), n_bls=cfg.max_bls_iteration,
        masked=int(cfg.constraint_violating_dependant_loss),
    )
    for r, n_r in enumerate(sched):
        p.sched[r] = n_r
    for r in range(MAX_ROUNDS):
        p.gd_lr[r] = f32(round_lr(cfg, r, "gd"))
    for j, l in enumerate(c.link):
        p.link[j] = f32(l)
    for name, value in (
        ("mean_jp", c.mean_jp), ("inv_std_jp_h", c.inv_std_jp_h),
        ("inv_vmax_h", c.inv_vmax_h), ("inv_T", c.inv_T),
        ("inv_std2_T", c.inv_std2_T), ("inv_vmax2_T", c.inv_vmax2_T),
        ("lam_max", cfg.lambda_max_cost),
        ("mean_w", (1.0 - cfg.lambda_max_cost) / T),
        ("pos_hi", jsl * cfg.max_joint_position),
        ("pos_lo", jsl * cfg.min_joint_position),
        ("vel_hi", jsl * cfg.max_joint_velocity),
        ("lambda_reg", cfg.lambda_reg), ("bls_alpha", cfg.bls_alpha),
        ("beta_plus", cfg.bls_beta_plus), ("beta_minus", cfg.bls_beta_minus),
        ("lr_fail", cfg.bls_beta_minus ** cfg.max_bls_iteration),
        ("lr_start", cfg.bls_lr_start),
        ("loss_red", cfg.loop_loss_reduction),
        ("inc", cfg.lambda_constraint_increase),
        ("eps_pos", cfg.eps_position), ("eps_vel", cfg.eps_velocity),
        ("max_jp", cfg.max_joint_position), ("min_jp", cfg.min_joint_position),
        ("max_jv", cfg.max_joint_velocity),
    ):
        setattr(p, name, f32(value))
    return p


def check_supported(cfg: PlannerConfig) -> None:
    """Raise NotImplementedError for the BLS modes this port does not run
    yet.  Both ladder tiers run.  ``exact_constraint_eval=False`` is a no-op
    under the exact ladder, whose carried evaluation is exact, as in the
    JAX kernel; under the linearized ladder it raises."""
    check_precision(cfg)
    if cfg.bls_bf16_ladder:
        raise NotImplementedError(
            "the bf16 ladder tier is not ported (ROADMAP queue 1 #2, large T)"
        )
    if cfg.ladder_eval == "linearized" and not cfg.exact_constraint_eval:
        raise NotImplementedError(
            "exact_constraint_eval=False is not ported; the port always "
            "checks constraints on the exact evaluation"
        )


def check_precision(cfg: PlannerConfig) -> None:
    """The check of the code without a ladder (GD, K4-K6): only the
    basis-product precision.  GD ignores the ladder options and always
    checks constraints on an exact evaluation, as the JAX kernels do."""
    if cfg.matmul_precision != "highest":
        raise NotImplementedError(
            "only matmul_precision='highest' (full fp32) is implemented"
        )


def solver_check(solver: str):
    """The support check of ``solver``'s code: :func:`check_supported` for
    BLS, :func:`check_precision` for GD."""
    return check_precision if _solver_is_gd(solver) else check_supported


def _check_args(name: str, cfg: PlannerConfig, named, lane_shape,
                supported=check_supported) -> str:
    """Check the float32 arguments ``named`` ((label, tensor) pairs whose
    shapes ``lane_shape(J, T, O, B)`` lists) share one device and match
    ``cfg``, and that ``supported(cfg)`` accepts the config; return the
    device type the call runs on."""
    supported(cfg)
    a = dict(named)
    J, T, B = a["alpha"].shape
    O = a["ox"].shape[0] if "ox" in a else 0
    dev = a["alpha"].device
    for (label, x), shape in zip(named, lane_shape(J, T, O, B)):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(
                f"{name} expects {label} float32 {shape}, got {x.dtype} "
                f"{tuple(x.shape)}"
            )
        if x.device != dev:
            raise ValueError(f"{name} arguments must share one device")
    if T != cfg.n_timesteps or J != cfg.n_joints:
        raise ValueError(f"{name}: alpha shape does not match cfg")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev.type


_LABELS = ("kv", "kvt", "mix", "alpha", "lam_sg", "lam_jl", "start", "goal",
           "ox", "oy", "ow")


def fused_solve(cfg: PlannerConfig, kv, kvt, mix, a0, lam_sg0, lam_jl0, start,
                goal, ox, oy, ow, *, solver: str = "bls",
                ctas: int = 0) -> FusedSolve:
    """The whole penalty-method solve of ``solver`` (``"bls"``, in the ladder
    tier ``cfg.ladder_eval``, or ``"gd"``; GD's round r starts from
    ``gd_lr[min(r, len(gd_lr) - 1)]``) for every lane.

    kv (2T, T), kvt (T, 2T), mix (J, J), a0 (J, T, B), lam_sg0/lam_jl0
    (1, B), start/goal (J, B), ox/oy/ow (O, B), all f32.  CPU tensors run
    :func:`fused_solve_reference`; CUDA tensors launch the kernel (one warp
    per lane, ``cfg.pallas_block_b`` lanes per CTA or DEFAULT_WARPS when it
    is 0, see :func:`launch_plan`) and raise if it cannot be built or
    launched.  ``ctas``: CTAs of the persistent grid (0: every CTA that
    fits on the card); per-lane results do not depend on it."""
    args = (kv, kvt, mix, a0, lam_sg0, lam_jl0, start, goal, ox, oy, ow)
    where = _check_args("fused_solve", cfg, tuple(zip(_LABELS, args)),
                        lambda J, T, O, B: (
                            (2 * T, T), (T, 2 * T), (J, J), (J, T, B),
                            (1, B), (1, B), (J, B), (J, B), (O, B), (O, B),
                            (O, B)), solver_check(solver))
    warps_per_cta(cfg)
    if where == "cpu":
        return fused_solve_reference(cfg, *args, solver=solver)
    kv, kvt, mix, a0, lam_sg0, lam_jl0, start, goal, ox, oy, ow = (
        x.contiguous() for x in args
    )
    alpha = a0.clone()
    outs = _launch("fused_solve", cfg, solver, alpha, 4, ctas, [],
                   [kv, kvt, mix, lam_sg0, lam_jl0, start, goal, ox, oy, ow])
    fused_solve.launches += 1
    return FusedSolve(alpha, *outs)


fused_solve.launches = 0


def fused_round(cfg: PlannerConfig, kv, kvt, mix, alpha, lam_sg, lam_jl,
                fulfilled, lr0, n_r: int, start, goal, ox, oy, ow, *,
                solver: str = "bls", ctas: int = 0) -> FusedRound:
    """ONE penalty round of ``solver`` for every lane: round-start fused
    evaluation under the lane's penalties, up to ``n_r`` steps from the
    lane's learning rate ``lr0`` (BLS adapts it from there; GD keeps it),
    the exact evaluation at the final alpha and the constraint check.  The
    penalty escalation is the caller's.  Lanes with ``fulfilled`` set pass
    through (alpha unchanged, no steps, loss 0, ok 1).

    alpha (J, T, B), lam_sg/lam_jl/fulfilled/lr0 (1, B), n_r a Python int,
    the rest as :func:`fused_solve`.  CPU tensors run
    :func:`fused_round_reference`; CUDA tensors launch the kernel (the
    budget is a plain kernel argument: every round shares one build; lanes
    per CTA and ``ctas`` as :func:`fused_solve`) and raise if it cannot be
    built or launched."""
    n_r = int(n_r)
    if n_r < 0:
        raise ValueError(f"fused_round: n_r must be >= 0, got {n_r}")
    args = (kv, kvt, mix, alpha, lam_sg, lam_jl, fulfilled, lr0, start, goal,
            ox, oy, ow)
    labels = _LABELS[:6] + ("fulfilled", "lr0") + _LABELS[6:]
    where = _check_args("fused_round", cfg, tuple(zip(labels, args)),
                        lambda J, T, O, B: (
                            (2 * T, T), (T, 2 * T), (J, J), (J, T, B),
                            (1, B), (1, B), (1, B), (1, B), (J, B), (J, B),
                            (O, B), (O, B), (O, B)), solver_check(solver))
    warps_per_cta(cfg)
    if where == "cpu":
        return fused_round_reference(cfg, kv, kvt, mix, alpha, lam_sg, lam_jl,
                                     fulfilled, lr0, n_r, start, goal, ox, oy,
                                     ow, solver=solver)
    (kv, kvt, mix, alpha, lam_sg, lam_jl, fulfilled, lr0, start, goal, ox, oy,
     ow) = (x.contiguous() for x in args)
    out_alpha = alpha.clone()
    outs = _launch("fused_round", cfg, solver, out_alpha, 3, ctas,
                   [ctypes.c_int(n_r)],
                   [kv, kvt, mix, lam_sg, lam_jl, fulfilled, lr0, start, goal,
                    ox, oy, ow])
    fused_round.launches += 1
    return FusedRound(out_alpha, *outs)


fused_round.launches = 0


def _launch(name: str, cfg: PlannerConfig, solver: str, alpha, n_out: int,
            ctas: int, scalars, inputs) -> list:
    """Launch ``<name>_launch`` of the kernel library on the current stream,
    the instantiation of ``solver``: the persistent grid (``ctas`` CTAs, 0:
    all that fit) over a lane queue zeroed here; ``alpha`` (J, T, B) is
    updated in place, ``n_out`` (1, B) outputs are returned.  Raises when
    the launch is refused."""
    from ._build import launch

    J, T, B = alpha.shape
    O = inputs[-1].shape[0]
    if J != 3:
        raise NotImplementedError("the CUDA kernels are built for J=3 joints")
    if ctas < 0:
        raise ValueError(f"{name}: ctas must be >= 0, got {ctas}")
    warps = launch_plan(cfg, O)["warps"]
    dev = alpha.device
    outs = [torch.empty((1, B), dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    launch(name, kernel_params(cfg, O, B), warps,
           [ctypes.c_int(program_index(cfg, solver)), ctypes.c_int(ctas),
            *scalars,
            *inputs, alpha, *outs, queue], dev)
    return outs


# Agreement of the port with the JAX kernel (the CPU tests): a 1-ulp
# difference grows about 4x per BLS step, so lanes flip Armijo/stop
# decisions at the 1e-3 thresholds and agreement is a fraction of lanes, not
# lane-for-lane equality.  Measured at the tests' short config (2 rounds x 6
# steps, 128 random scenes): 0.62-0.80 across four seeds.
LANE_AGREEMENT_MIN = 0.60
# The CUDA kernel against the plain version on the same card: the two paths
# round alike (no fast math, no fused multiply-adds outside the basis
# products), so their lanes part only late in a long solve.  Measured on an
# H100 (1,024 random scenes at the short configs, 16,384 at the full
# benchmark schedule): 1.0 at 1 round x 4 steps over six seeds, 0.997-1.0
# at 2 rounds x 6 steps, 0.883-0.891 at the full schedule over five seeds.
# The exact ladder's K1, K2 and K3 agree as closely: 1.0 at 1 round x 4
# steps on 1,000 random scenes, and one K3 step on every lane.
CARD_SHORT_AGREEMENT_MIN = 0.99
CARD_FULL_AGREEMENT_MIN = 0.87
ALPHA_REL_MAX = 1e-4


def lane_agreement(a: FusedSolve, b: FusedSolve):
    """(fraction of lanes with equal inner/outer counts and fulfilled flags,
    largest alpha difference on those lanes relative to the lane's largest
    |alpha|).  Fields may be numpy arrays or tensors on any device."""
    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else torch.tensor(np.asarray(x))

    f, g = [cpu(x) for x in a], [cpu(x) for x in b]
    same = ((f[4] == g[4]) & (f[3] == g[3]) & (f[2] == g[2]))[0]
    scale = f[0].abs().amax(dim=(0, 1))
    rel = ((f[0] - g[0]).abs().amax(dim=(0, 1)) / scale)[same]
    return float(same.float().mean()), float(rel.max()) if rel.numel() else 0.0
