"""The fused whole-solve BLS kernel and its plain PyTorch version
(counterpart of ``pallas_step.fused_solve`` / ``_make_solve_kernel`` in
irm_motion_planning_tpu/ops/pallas_step.py).

One call runs the whole penalty-method solve for every lane: per round a
fused cost/gradient evaluation, the inner BLS loop to the round's budget
(normalized direction, Armijo ladder on the linearized trajectory, FK carry
of the accepted rung, gradient pull-back), an exact re-evaluation of the
trajectory, the hard-constraint check and the x10 penalty escalation on
lanes that still fail.

Layout: lanes trailing.  Per-joint planes are ``(J, T, B)``, per-lane
scalars ``(B,)`` inside and ``(1, B)`` at the public functions, obstacles
``(O, B)``.

``fused_solve`` takes the plain version for CPU tensors and launches the
CUDA kernel (csrc/fused_solve.cu) for CUDA tensors; it never falls back.
The plain version runs all lanes in lockstep with per-lane masks, so its
per-lane results equal the kernel's per-lane early exits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import PlannerConfig

# Most penalty rounds the kernel's parameter block holds.
MAX_ROUNDS = 32
DEFAULT_BLOCK_B = 128


class FusedSolve(NamedTuple):
    alpha: torch.Tensor        # (J, T, B)
    final_loss: torch.Tensor   # (1, B)
    fulfilled: torch.Tensor    # (1, B) f32 0/1
    outer_iters: torch.Tensor  # (1, B) f32
    inner_iters: torch.Tensor  # (1, B) f32


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


def bls_step(cfg: PlannerConfig, c: Consts, kv, kvt, mix, start, goal, obs,
             lam_sg, lam_jl, alpha, grad, traj, vel, loss, bls_lr, minimized,
             px=None, py=None):
    """One BLS inner step for every lane (pallas_step._bls_step, linearized
    ladder).  ``minimized`` (B,) bool freezes lanes.  With ``px``/``py``
    given, the accepted rung's FK planes are carried into the pull-back and
    its loss is reused.  Returns (alpha, grad, traj, vel, loss, lr,
    minimized[, px, py])."""
    n = cfg.max_bls_iteration
    frozen = minimized
    carry_fk = px is not None

    g2 = (grad * grad).sum(dim=1).sum(dim=0)
    inv_norm = 1.0 / torch.sqrt(g2)
    n_grad = grad * inv_norm
    # Reference quirk (optimizer_BLS.py:86): the sum over ALL (J, J) entries
    # of grad^T n_grad, i.e. sum_t rowsum(grad)_t rowsum(n_grad)_t.
    gsum = grad.sum(dim=0)
    alpha_norm = (gsum * (gsum * inv_norm)).sum(dim=0)

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

    a_fac = 1.0 - cfg.lambda_reg * lr_eff
    new_alpha = a_fac * alpha - lr_eff * n_grad
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
              minimized, n_r, icnt):
    """Round-start fused evaluation, up to ``n_r`` BLS steps, then the exact
    re-evaluation of (traj, vel) from the final alpha.  Returns (alpha,
    traj, vel, loss, icnt)."""
    loss, grad, traj, vel, px, py = cost_grad_eval(
        cfg, c, kv, kvt, mix, alpha, start, goal, obs, lam_sg, lam_jl
    )
    lr = torch.full_like(loss, cfg.bls_lr_start)
    for _ in range(n_r):
        if not bool((~minimized).any()):
            break
        (alpha, grad, traj, vel, loss, lr, new_min, px, py) = bls_step(
            cfg, c, kv, kvt, mix, start, goal, obs, lam_sg, lam_jl,
            alpha, grad, traj, vel, loss, lr, minimized, px=px, py=py,
        )
        # A step counts when the lane was live before it and after it.
        icnt = icnt + (~minimized & ~new_min).to(torch.float32)
        minimized = new_min
    traj, vel = forward_planes(kv, mix, alpha)
    return alpha, traj, vel, loss, icnt


def fused_solve_reference(cfg: PlannerConfig, kv, kvt, mix, a0, lam_sg0,
                          lam_jl0, start, goal, ox, oy, ow) -> FusedSolve:
    """Plain PyTorch version of the fused solve kernel; same arguments and
    outputs as :func:`fused_solve`."""
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
    for n_r in inner_schedule(cfg):
        if bool(fulfilled.all()):
            break
        alpha, traj, vel, loss, icnt = run_inner(
            cfg, c, kv, kvt, mix, start, goal, obs, alpha, lam_sg, lam_jl,
            fulfilled, n_r, icnt,
        )
        now = fulfilled | constraints_ok(cfg, traj, vel, start, goal)
        floss = torch.where(fulfilled, floss, loss)
        outer = torch.where(now, outer, outer + 1.0)
        lam_sg = torch.where(now, lam_sg, lam_sg * inc)
        lam_jl = torch.where(now, lam_jl, lam_jl * inc)
        fulfilled = now
    return FusedSolve(alpha, floss[None], fulfilled.to(torch.float32)[None],
                      outer[None], icnt[None])


# ---------------------------------------------------------------------------
# The CUDA kernel: parameter block, checks and launch.
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of ``struct FsParams`` in csrc/fused_solve.cu (passed by
    value).  Float fields hold the f32 roundings of the Python-float
    constants, as JAX's weak typing rounds them."""

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
    ]


def kernel_params(cfg: PlannerConfig, O: int, B: int) -> _Params:
    c = consts(cfg)
    sched = inner_schedule(cfg)
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
    """Raise NotImplementedError for the modes this port does not run yet."""
    if cfg.ladder_eval != "linearized":
        raise NotImplementedError(
            "ladder_eval='exact' is not ported yet (ROADMAP queue 1 #10)"
        )
    if cfg.matmul_precision != "highest":
        raise NotImplementedError(
            "only matmul_precision='highest' (full fp32) is implemented"
        )
    if cfg.bls_bf16_ladder:
        raise NotImplementedError(
            "the bf16 ladder tier is not ported (ROADMAP queue 1 #13)"
        )
    if not cfg.exact_constraint_eval:
        raise NotImplementedError(
            "exact_constraint_eval=False is not ported; the port always "
            "checks constraints on the exact evaluation"
        )


def fused_solve(cfg: PlannerConfig, kv, kvt, mix, a0, lam_sg0, lam_jl0, start,
                goal, ox, oy, ow) -> FusedSolve:
    """The whole BLS penalty-method solve for every lane.

    kv (2T, T), kvt (T, 2T), mix (J, J), a0 (J, T, B), lam_sg0/lam_jl0
    (1, B), start/goal (J, B), ox/oy/ow (O, B), all f32.  CPU tensors run
    :func:`fused_solve_reference`; CUDA tensors launch the kernel
    (``cfg.pallas_block_b`` lanes per block, or 128 when it is 0) and raise
    if it cannot be built or launched."""
    check_supported(cfg)
    args = (kv, kvt, mix, a0, lam_sg0, lam_jl0, start, goal, ox, oy, ow)
    J, T, B = a0.shape
    O = ox.shape[0]
    shapes = ((2 * T, T), (T, 2 * T), (J, J), (J, T, B), (1, B), (1, B),
              (J, B), (J, B), (O, B), (O, B), (O, B))
    for x, shape in zip(args, shapes):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(
                f"fused_solve expects float32 {shape}, got {x.dtype} "
                f"{tuple(x.shape)}"
            )
        if x.device != a0.device:
            raise ValueError("fused_solve arguments must share one device")
    if T != cfg.n_timesteps or J != cfg.n_joints:
        raise ValueError("a0 shape does not match cfg")
    if a0.device.type == "cpu":
        return fused_solve_reference(cfg, *args)
    if a0.device.type != "cuda":
        raise ValueError(f"fused_solve runs on cpu or cuda, not {a0.device}")
    return _launch(cfg, args)


fused_solve.launches = 0


def _launch(cfg: PlannerConfig, args) -> FusedSolve:
    from ._build import load_library

    kv, kvt, mix, a0, lam_sg0, lam_jl0, start, goal, ox, oy, ow = (
        x.contiguous() for x in args
    )
    J, T, B = a0.shape
    O = ox.shape[0]
    if J != 3:
        raise NotImplementedError("the CUDA kernel is built for J=3 joints")
    bt = cfg.pallas_block_b or DEFAULT_BLOCK_B
    lib = load_library()
    dev = a0.device
    alpha = a0.clone()
    outs = [torch.empty((1, B), dtype=torch.float32, device=dev)
            for _ in range(4)]
    # Workspace: grad, traj, vel and the two direction planes (J, T, B),
    # then the obstacle-gradient planes gx, gy (T, B).
    work = torch.empty((5 * J + 2, T, B), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.fused_solve_launch(
            kernel_params(cfg, O, B), ctypes.c_int(bt),
            ptr(kv), ptr(kvt), ptr(mix), ptr(lam_sg0), ptr(lam_jl0),
            ptr(start), ptr(goal), ptr(ox), ptr(oy), ptr(ow),
            ptr(alpha), *(ptr(o) for o in outs), ptr(work),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"fused_solve kernel launch failed: CUDA error {err} "
            f"({lib.fused_solve_error_string(err).decode()})"
        )
    fused_solve.launches += 1
    return FusedSolve(alpha, *outs)


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
