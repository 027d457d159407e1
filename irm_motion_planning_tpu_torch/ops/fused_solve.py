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
exact.

The JAX kernel's tiers (``lean``, ``ultra``, ``bf16`` keywords, as
pallas_step's) give the linearized ladder two more programs: ultra drops
the FK carry (the loss is recomputed at the accepted iterate) and
evaluates alpha exactly at every step start, so the linearized drift never
builds up over a round; bf16 is ultra with the ladder planes (the
step-start evaluation and the direction) rounded to bfloat16 and the
Armijo/stop baseline evaluated like a rung, on those planes.  Lean, which
only drops the FK carry, is the linearized program here (:func:`program`),
and for GD and the exact ladder the tiers change nothing.
``fused_solve`` runs
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
csrc/warp_body.cuh, in the plan :func:`launch_plan` gives: the resident
body for T <= 64, the streamed one beyond, whose CTA runs a tile of lanes
in lockstep and streams the basis from device memory through K7 once per
tile and product; a persistent grid over a lane queue) for CUDA tensors,
from the kernel library of the arm's joint count J (ops/_build.py builds
one per J below WIDE_J and one for every J from WIDE_J up, csrc/wide/, at
the first launch; :func:`params_type` mirrors the parameter block); they
never fall back.  The plain versions run all
lanes in lockstep with per-lane masks, so their per-lane results equal the
kernels' per-lane early exits.  K7's plain version is the plain versions'
own basis products (:func:`forward_planes` and the pull-back in
:func:`cost_grad_from_traj`), whose rows it computes.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..config import PlannerConfig

# Most penalty rounds the kernel's parameter block holds.
MAX_ROUNDS = 32
# The solvers of the fused kernels.
SOLVERS = ("bls", "gd")
# Their compiled programs, by the index of their instantiation in
# csrc/fused_solve.cu (SOLVER_BLS = 0, SOLVER_GD = 1, SOLVER_BLS_EXACT = 2,
# SOLVER_BLS_ULTRA = 3, SOLVER_BLS_BF16 = 4): BLS has one per ladder tier,
# and the linearized ladder one per kernel tier that changes its floats
# (TIER_PROGRAMS, :func:`program`).
PROGRAMS = ("bls", "gd", "bls_exact", "bls_ultra", "bls_bf16")
SOLVER_PROGRAMS, TIER_PROGRAMS = PROGRAMS[:3], PROGRAMS[3:]
# The warp-per-lane kernels (csrc/warp_body.cuh): lanes (warps) per CTA,
# ``cfg.pallas_block_b`` or DEFAULT_WARPS when it is 0, at most MAX_WARPS.
# The resident body holds two timesteps per thread, so at most WARP_MAX_T
# timesteps; the streamed body at least one (STREAM_MIN_T).
DEFAULT_WARPS = 16
MAX_WARPS = 16
WARP_MAX_T = 64
STREAM_MIN_T = 32
# The launch plans: the resident body (the basis pair in shared memory),
# the streamed one (the basis in device memory, streamed by K7), or the
# streamed one in its reach layout (the float32 programs past the streamed
# layout's ceiling: FK recomputed in the gradient pass, GD and the exact
# ladder without the direction planes, the linearized ladder with the
# tile's gx/gy planes in them).
PLANS = ("resident", "streamed", "reach")
# The programs whose reach layout holds no direction planes.
REACH_NODIR = ("gd", "bls_exact")
# The joint counts J the kernels take.  Below WIDE_J each J has a library
# of its own, J a compile-time constant (csrc/lane_body.cuh); from WIDE_J up
# one library takes every J at run time (csrc/wide/), its parameter block
# holding at most MAX_J links.  What bounds J is the launch plan's shared
# memory (:func:`launch_plan`), as for T: mix alone (J^2 floats) outgrows a
# CTA from J = 242, so MAX_J never binds a plan.
WIDE_J = 16
MAX_J = 256
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
    raw = forward_product(kv, planes)                   # (J, 2T, B)
    out = []
    for i in range(J):
        out.append(mix_combine([(raw[j], mix[j, i]) for j in range(J)]))
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
    px = torch.stack([c.link[j] * fk_cos(ang[j]) for j in range(J)])
    py = torch.stack([c.link[j] * fk_sin(ang[j]) for j in range(J)])
    ee_x, ee_y = px[0], py[0]
    for j in range(1, J):
        ee_x = ee_x + px[j]
        ee_y = ee_y + py[j]
    return ee_x, ee_y, px, py


def obs_ctx(ox, oy, ow):
    """Loop-invariant obstacle terms: q_o = 0.5 + 0.5 |o|^2 and 0.8 w_o."""
    return ox, oy, field_q(ox, oy), 0.8 * ow


def obstacle_cost_v(ee_x, ee_y, obs):
    """Obstacle field in dot-product form: 0.5 |ee - o|^2 + 0.5 =
    (h + q_o) - (ox ee_x + oy ee_y), h = 0.5 |ee|^2.  (T, B) -> (T, B)."""
    ox, oy, q, ow8 = obs
    h = field_h(ee_x, ee_y)
    return field_sum([
        (ow8[o], recip(field_dist(h, q[o], ox[o], ee_x, oy[o], ee_y)))
        for o in range(ox.shape[0])])


def scalar_cost(cfg: PlannerConfig, c: Consts, traj, vel, cost_v, start, goal,
                lam_sg, lam_jl):
    """Penalized loss per lane (B,) from the evaluated planes and the
    per-timestep obstacle cost."""
    T, J = traj.shape[1], traj.shape[0]
    lam_max = cfg.lambda_max_cost
    pls, vls = [], []
    for j in range(J):
        zp = (traj[j] - c.mean_jp) * c.inv_std_jp_h
        pl_ = zp * zp
        zv = vel[j] * c.inv_vmax_h
        vl_ = zv * zv
        if cfg.constraint_violating_dependant_loss:
            pl_ = torch.where(_pos_mask(cfg, traj[j]), pl_, 0.0)
            vl_ = torch.where(_vel_mask(cfg, vel[j]), vl_, 0.0)
        pls.append(pl_)
        vls.append(vl_)
    sums = t_sums([cost_v, *pls, *vls])
    toc = sum_pair(lam_max, cost_v.max(dim=0).values, (1.0 - lam_max) / T,
                   sums[0])
    sgpc = torch.zeros_like(toc)
    sgvc = torch.zeros_like(toc)
    for j in range(J):
        ds = traj[j, 0] - start[j]
        dg = traj[j, T - 1] - goal[j]
        sgpc = sum_add(sgpc, 0.5, sum_pair(ds, ds, dg, dg))
        vs = vel[j, 0]
        vg = vel[j, T - 1]
        sgvc = sum_add(sgvc, 0.5, sum_pair(vs, vs, vg, vg))
    jpc = limit_sum([(sums[1 + j], c.inv_T) for j in range(J)])
    jvc = limit_sum([(sums[1 + J + j], c.inv_T) for j in range(J)])
    return sum_add(sum_add(toc, lam_sg, sgpc + sgvc), lam_jl, jpc + jvc)


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
    h = field_h(ee_x, ee_y)
    inv = [recip(field_dist(h, q[o], ox[o], ee_x, oy[o], ee_y))
           for o in range(ox.shape[0])]
    winv = [ow8[o] * r for o, r in enumerate(inv)]
    coef = [w * r for w, r in zip(winv, inv)]
    cost_v = field_sum([(ow8[o], r) for o, r in enumerate(inv)])
    csum = field_acc(list(zip(winv, inv)))
    cox = field_acc([(cf, ox[o]) for o, cf in enumerate(coef)])
    coy = field_acc([(cf, oy[o]) for o, cf in enumerate(coef)])
    del inv, winv, coef
    gx = field_grad(cox, ee_x, csum)
    gy = field_grad(coy, ee_y, csum)

    # Blend weights: lam_max on the FIRST argmax over T, plus the mean.
    rows = torch.arange(T, device=nt.device)[:, None]
    first_max = first_argmax(cost_v)[None]
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
    pulled = pullback_product(kvt, torch.stack(stacked))   # (J, T, B)
    grad = []
    for j in range(J):
        grad.append(mix_combine([(pulled[i], mix[j, i]) for i in range(J)]))
    return loss, torch.stack(grad), px, py


def first_argmax(cost_v):
    """The first timestep of each lane's largest cost (B,): where the blend
    puts lam_max (a tie goes to the earlier timestep)."""
    T = cost_v.shape[0]
    rows = torch.arange(T, device=cost_v.device)[:, None]
    cmax = cost_v.max(dim=0, keepdim=True).values
    return torch.where(cost_v == cmax, rows, T).min(dim=0).values


def blend_costs(cfg: PlannerConfig, traj, ox, oy, ow):
    """The obstacle cost per timestep (T, B) at the evaluated ``traj`` (J,
    T, B) among the obstacles ox/oy/ow (O, B), as the cost pass computes
    it; :func:`first_argmax` of it is where the blend puts lam_max."""
    ee_x, ee_y, _, _ = fk_ee(consts(cfg), traj)
    return obstacle_cost_v(ee_x, ee_y, obs_ctx(ox, oy, ow))


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


def fma(a, b, c):
    """``a b + c`` in float32 with one rounding, as CUDA's ``fmaf`` (the
    product is exact in float64; the float64 sum rounds again only where it
    needs more than 53 bits, a tie at float32 precision after that being
    rarer than 1 in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


def chain_sum(x):
    """The sum over the leading axis as one sequential chain, ((0 + x_0) +
    x_1) + ..., the order of the kernels' sums."""
    s = torch.zeros_like(x[0])
    for xi in x:
        s = s + xi
    return s


def t_sums(planes):
    """The sums over T of the (T, B) ``planes``, (K, B) for K planes, in an
    order that neither B nor a lane's position changes: each lane's row
    made contiguous, padded with zeros to a multiple of 4 (every row then
    starts 16-byte aligned, so a vectorized reduction reads each alike) and
    summed by ``sum(-1)``.  torch's ``sum(0)`` of a (T, B) plane blocks the
    lanes, so its order over T depended on where a lane lies (the loss of a
    permuted batch moved by an ulp).  The kernels' order, one sequential
    chain (:func:`chain_sum`), costs T launches a loss: tools/t_sums.py
    measured it 1.50x slower than ``sum(0)`` for the plain K1 on an NVIDIA
    H100 (T = 200, 8,192 lanes), this order 1.05x."""
    rows = torch.stack(planes).transpose(1, 2)
    pad = -rows.shape[-1] % 4
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    return rows.contiguous().sum(-1)


def step_sums(planes):
    """The sums over T of the (K, T, B) ``planes`` of a BLS step's
    direction scalars, (K, B): each a sequential chain over T
    (:func:`chain_sum`), the kernels' order."""
    return chain_sum(planes.transpose(0, 1))


def inv_sqrt(x):
    """The direction's ``1 / sqrt(|g|^2)``, two roundings, as the kernels
    form it."""
    return 1.0 / torch.sqrt(x)


def fk_cos(x):
    """The FK's cosine of a cumulative joint angle (torch's)."""
    return torch.cos(x)


def fk_sin(x):
    """The FK's sine of a cumulative joint angle (torch's)."""
    return torch.sin(x)


def forward_product(kv, planes):
    """The forward basis product ``kv @ plane_j`` for each joint, (J, 2T,
    B) (one torch product)."""
    return torch.matmul(kv, planes)


def pullback_product(kvt, planes):
    """The gradient's pull-back ``kvt @ plane_j`` for each joint, (J, T,
    B) (one torch product)."""
    return torch.matmul(kvt, planes)


def carry_rounds_once(J: int) -> bool:
    """Whether the linearized ladder's carry program (:func:`bls_step`,
    neither ultra nor exact) rounds its accepted alpha ``a_fac alpha -
    lr_eff n_grad`` once (:func:`fma`), as JAX's kernel does, at J joints:
    at every J but 3, in every launch plan and at every T; at J = 3 it
    rounds it twice (:func:`two_roundings`).  The kernels follow the same
    rule (csrc/warp_body.cuh ``WB_CARRY_FUSED``; csrc/wide/ rounds once).
    J = 3 is the exception because of bench.py's reference scene, a 3-link
    arm: rounded once, its endpoint moves past the strict gate of 0.01
    (0.0108 on the CPU, 0.014011 on an H100), and that endpoint is chaotic
    in the fp path (ROADMAP fact 2).  Elsewhere two roundings collapse the
    converged rate: on the bench schedule at T = 50, 256 random scenes
    (tools/compare_converged.py --port-only --n-joints J --two-roundings
    --one-rounding), the plain K1 converged at J = 15 0.0352 rounded twice
    against 0.1797 once and the xla engine's 0.1875 (ROADMAP queue 3 #1
    has every J from 4 to 15)."""
    return J != 3


def two_roundings(a, b, c):
    """``a b + c`` in float32 with the product rounded first, then the sum:
    the linearized carry program's accepted alpha (:func:`bls_step`)."""
    return a * b + c


def carry_direction(lam, x, g):
    """The linearized ladder's direction ``lam x + g``, the product rounded
    first, then the sum, as every kernel forms it (PERF.md section 7 has
    why the carry program keeps its expressions rounded twice)."""
    return lam * x + g


def rung_point(x, lr, d):
    """A rung's linearized candidate ``x - lr d``, rounded twice."""
    return x - lr * d


def accepted_point(x, lr, d):
    """The accepted linearized iterate ``x - lr d``, rounded twice."""
    return x - lr * d


# The sums of the evaluation, each formed as every kernel forms it: the
# product rounded, then the sum (PERF.md section 7 measures which of them
# XLA contracts into FMAs; tools/compare_converged.py --contract swaps
# their one-rounding forms in).


def mix_combine(terms):
    """The mix combine of one product row, ``sum_j x_j m_j`` over the
    (x_j, m_j) of ``terms`` in order, each product rounded, then added to
    the running sum (the forward product's rows and the pull-back's)."""
    acc = terms[0][0] * terms[0][1]
    for x, m in terms[1:]:
        acc = acc + x * m
    return acc


def recip(s):
    """The obstacle field's ``1 / s``, correctly rounded."""
    return 1.0 / s


def field_q(ox, oy):
    """The obstacle field's ``q_o = 0.5 + 0.5 (ox ox + oy oy)``."""
    return 0.5 + 0.5 * (ox * ox + oy * oy)


def field_h(ex, ey):
    """The obstacle field's ``h = 0.5 (ex ex + ey ey)``."""
    return 0.5 * (ex * ex + ey * ey)


def field_dist(h, q, ox, ex, oy, ey):
    """The obstacle field's ``s = (h + q) - (ox ex + oy ey)``."""
    return (h + q) - (ox * ex + oy * ey)


def _chain(terms):
    """``sum_o a_o b_o`` over the (a_o, b_o) of ``terms`` in order, from 0,
    each product rounded, then added to the running sum."""
    acc = torch.zeros_like(terms[0][1])
    for a, b in terms:
        acc = acc + a * b
    return acc


def field_sum(terms):
    """The obstacle field ``sum_o w_o r_o`` over (0.8 w_o, r_o = 1 / s_o):
    the cost per timestep, in the forward pass and the gradient's."""
    return _chain(terms)


def field_acc(terms):
    """A gradient accumulator of the field: ``csum = sum_o (w_o r_o) r_o``
    over (w_o r_o, r_o), or ``co = sum_o c_o o`` over (c_o, o), c_o = w_o
    r_o^2."""
    return _chain(terms)


def field_grad(co, e, csum):
    """The field's gradient ``co - e csum`` (ee - o weighted and summed)."""
    return co - e * csum


def sum_pair(a, b, c, d):
    """A cost sum's ``a b + c d``."""
    return a * b + c * d


def sum_add(acc, a, b):
    """A cost sum's ``acc + a b``."""
    return acc + a * b


def limit_sum(terms):
    """A cost sum over the joints, ``sum_j a_j b_j`` over the (a_j, b_j) of
    ``terms`` from 0 by :func:`sum_add` (the limit losses' means)."""
    acc = torch.zeros_like(terms[0][0])
    for a, b in terms:
        acc = sum_add(acc, a, b)
    return acc


def armijo_bound(loss, c, alpha_norm):
    """A rung's Armijo bound ``loss - c alpha_norm``, c = bls_alpha lr."""
    return loss - c * alpha_norm


def decay_factor(lam, lr):
    """The accepted step's ``1 - lambda_reg lr`` on alpha."""
    return 1.0 - lam * lr


def bf16_round(x):
    """x rounded to bfloat16 (round to nearest even) and back to float32:
    the values the bf16 tier's ladder planes hold (JAX's ``astype``)."""
    return x.to(torch.bfloat16).to(torch.float32)


def bls_step(cfg: PlannerConfig, c: Consts, kv, kvt, mix, start, goal, obs,
             lam_sg, lam_jl, alpha, grad, traj, vel, loss, bls_lr, minimized,
             px=None, py=None, tally=None, ultra=False, bf16=False):
    """One BLS inner step for every lane (pallas_step._bls_step) in the
    ladder tier ``cfg.ladder_eval``.  ``minimized`` (B,) bool freezes lanes.

    Linearized: each rung's candidate is the linearized trajectory.  With
    ``px``/``py`` given, the accepted rung's FK planes are carried into the
    pull-back and its loss is reused; without them the loss is recomputed at
    the accepted iterate (the ultra tiers' and the per-step kernel's mode).
    ``ultra``: (traj, vel) are first evaluated exactly from alpha (the
    incoming ones are not read).  ``bf16`` (ultra implied): that evaluation
    and the direction are rounded to bfloat16 (:func:`bf16_round`; the
    direction's ``lambda_reg x`` term with ``lambda_reg`` in bfloat16, as
    JAX's weak typing gives it), the rungs and the accepted iterate are
    formed from them in float32, and the Armijo/stop baseline is the
    zero-lr candidate evaluated like a rung; a frozen lane keeps its
    incoming loss.  The accepted alpha ``a_fac alpha - lr_eff n_grad`` is
    rounded once (:func:`fma`), as XLA contracts it on the CPU, in the
    ultra and bf16 tiers and the exact ladder: at large T alpha's
    coefficients are O(1e4) and their rounding is of the step's size (in
    the ultra tiers each step start evaluates it exactly, so a second
    rounding parts that evaluation from the linearized iterate whose loss is
    the next Armijo baseline, and stops lanes).  The linearized ladder's
    carry program rounds it once at every J but 3, where it rounds it
    twice (:func:`two_roundings`; :func:`carry_rounds_once` says why).
    Exact: each rung's candidate alpha ``(1 - lambda_reg lr_r) alpha -
    lr_r n_grad``, rounded once, goes through the basis; the
    accepted iterate is evaluated exactly (also when the stop test fires)
    and, unless it fires, its loss and gradient are recomputed there; no FK
    carry (``px``/``py`` must be None) and no tier (the tiers change
    nothing there).  ``tally``: see :func:`count_work`.  Returns (alpha,
    grad, traj, vel, loss, lr, minimized[, px, py])."""
    n = cfg.max_bls_iteration
    frozen = minimized
    exact = cfg.ladder_eval == "exact"
    carry_fk = px is not None
    ultra = ultra or bf16
    if exact and (carry_fk or ultra):
        raise ValueError("the exact ladder has no FK carry and no tier")
    if carry_fk and ultra:
        raise ValueError("the ultra and bf16 tiers have no FK carry")
    count_work(tally, "steps", ~frozen)

    if ultra:
        traj, vel = forward_planes(kv, mix, alpha)
        if bf16:
            traj, vel = bf16_round(traj), bf16_round(vel)
    # The direction's scalars as the kernels chain them (per joint over t,
    # then over the joints): a reduction in another order moves 1/|grad| by
    # an ulp, which at T=200 moves an O(1e4) coefficient of the new alpha by
    # one, and the exact evaluation turns that into 4e-3 on traj.
    g2 = chain_sum(step_sums(grad * grad))
    inv_norm = inv_sqrt(g2)
    n_grad = grad * inv_norm
    # Reference quirk (optimizer_BLS.py:86): the sum over ALL (J, J) entries
    # of grad^T n_grad, i.e. sum_t rowsum(grad)_t rowsum(n_grad)_t.
    gsum = chain_sum(grad)
    alpha_norm = step_sums((gsum * (gsum * inv_norm))[None])[0]

    if not exact:
        gtraj, gvel = forward_planes(kv, mix, n_grad)
        lam = float(bf16_round(torch.tensor(cfg.lambda_reg))) if bf16 \
            else cfg.lambda_reg
        dir_t = carry_direction(lam, traj, gtraj)
        dir_v = carry_direction(lam, vel, gvel)
        if bf16:
            dir_t, dir_v = bf16_round(dir_t), bf16_round(dir_v)

    loss_in = loss
    if bf16:
        ee_x, ee_y, _, _ = fk_ee(c, traj)
        loss = scalar_cost(cfg, c, traj, vel, obstacle_cost_v(ee_x, ee_y, obs),
                           start, goal, lam_sg, lam_jl)
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
                kv, mix, fma(1.0 - cfg.lambda_reg * lr_r, alpha,
                             -(lr_r * n_grad)))
        else:
            cand_t = rung_point(traj, lr_r, dir_t)
            cand_v = rung_point(vel, lr_r, dir_v)
        ee_x, ee_y, rpx, rpy = fk_ee(c, cand_t)
        cost_v = obstacle_cost_v(ee_x, ee_y, obs)
        closs = scalar_cost(cfg, c, cand_t, cand_v, cost_v, start, goal,
                            lam_sg, lam_jl)
        required = armijo_bound(loss, cfg.bls_alpha * lr_r, alpha_norm)
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

    once = ultra or exact or carry_rounds_once(alpha.shape[0])
    new_alpha = (fma if once else two_roundings)(
        decay_factor(cfg.lambda_reg, lr_eff), alpha, -(lr_eff * n_grad))
    if exact:
        nt, nv = forward_planes(kv, mix, new_alpha)
    else:
        nt = accepted_point(traj, lr_eff, dir_t)
        nv = accepted_point(vel, lr_eff, dir_v)
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
        torch.where(frozen, loss_in, torch.where(stop, loss_best, nloss)),
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
    ``(1 - lambda_reg lr) alpha - lr grad`` (rounded once, :func:`fma`, as
    XLA contracts it on the CPU), the fused evaluation at it, and
    the stop test, which REJECTS the trial (alpha, grad, traj, vel and loss
    keep their incoming values).  ``lr`` (B,) passes through; ``minimized``
    (B,) bool freezes lanes.  ``tally``: see :func:`count_work`.  Returns (alpha,
    grad, traj, vel, loss, lr, minimized)."""
    frozen = minimized
    trial = fma(1.0 - cfg.lambda_reg * lr, alpha, -(lr * grad))
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
              minimized, lr, n_r, icnt, tally=None, solver="bls", prog=""):
    """Round-start fused evaluation and up to ``n_r`` steps of ``solver``
    from the per-lane learning rate ``lr`` (B,), in the program ``prog`` of
    PROGRAMS (empty: :func:`program` of ``solver``).  The linearized
    ladder's programs then re-evaluate (traj, vel) exactly from the final
    alpha (their linearized iterate drifts; the ultra and bf16 tiers carry
    none); GD's and the exact ladder's carried (traj, vel) are the exact
    evaluation of alpha already (an accepted iterate's, or the round
    start's), so re-evaluating would change nothing and, as in the JAX
    kernel, is skipped.  Shared by both plain versions, as pallas_step's
    run_inner serves both TPU kernels.  ``tally``: see :func:`count_work`.
    Returns (alpha, traj, vel, loss, icnt)."""
    prog = prog or program(cfg, solver)
    gd = prog == "gd"
    linearized = prog not in ("gd", "bls_exact")
    carry_fk = prog == "bls"
    tier = dict(ultra=prog == "bls_ultra", bf16=prog == "bls_bf16")
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
        elif carry_fk:
            (alpha, grad, traj, vel, loss, lr, new_min, px, py) = bls_step(
                cfg, c, kv, kvt, mix, start, goal, obs, lam_sg, lam_jl,
                alpha, grad, traj, vel, loss, lr, minimized, px=px, py=py,
                tally=tally,
            )
        else:
            alpha, grad, traj, vel, loss, lr, new_min = bls_step(
                cfg, c, kv, kvt, mix, start, goal, obs, lam_sg, lam_jl,
                alpha, grad, traj, vel, loss, lr, minimized, tally=tally,
                **tier,
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
                          solver: str = "bls", lean: bool = False,
                          ultra: bool = False,
                          bf16: bool = False) -> FusedSolve:
    """Plain PyTorch version of the fused solve kernel; same arguments and
    outputs as :func:`fused_solve`.  ``tally``: see :func:`count_work`."""
    prog = program(cfg, solver, lean, ultra, bf16)
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
            fulfilled, lr0, n_r, icnt, tally, solver, prog,
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
                          oy, ow, tally=None, solver: str = "bls",
                          lean: bool = False, ultra: bool = False,
                          bf16: bool = False) -> FusedRound:
    """Plain PyTorch version of the fused-round kernel; same arguments and
    outputs as :func:`fused_round`.  Lanes that come in fulfilled start
    minimized (alpha passes through, no step counts) and report loss 0 and
    ok 1, as the TPU kernel's skipped tiles do.  ``tally``: see
    :func:`count_work`."""
    prog = program(cfg, solver, lean, ultra, bf16)
    c = consts(cfg)
    B = alpha.shape[-1]
    was = fulfilled.reshape(B) > 0.5
    icnt = torch.zeros(B, dtype=torch.float32, device=alpha.device)
    alpha, traj, vel, loss, icnt = run_inner(
        cfg, c, kv, kvt, mix, start, goal, obs_ctx(ox, oy, ow), alpha,
        lam_sg.reshape(B), lam_jl.reshape(B), was, lr0.reshape(B), int(n_r),
        icnt, tally, solver, prog,
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


# The streamed plan (csrc/warp_body.cuh): its CTA's warps (the tile's lanes,
# one warp each, helpers, and K7's producer last), K7's ring stages, the
# lanes and rows of a K7 thread's register block (the rows by J:
# :func:`k7_rows`), the most floats of the ring, the ring the plan keeps
# when it can (the lanes per CTA give way to it), and the CTA's control
# block besides mix and the room (the ring's mbarriers and the tile base).
STREAM_WARPS = 16
K7_STAGES = 2
K7_LANES = 2
K7_ROWS = 4
K7_ROWS_WIDE = 2
K7_SOLO_ROWS = 2
RING_CAP = 16384
RING_MIN_BYTES = 48 * 1024
CTL_FLOATS = 20
# At J >= WIDE_J a product's register block (K7's, and the resident body's
# rows) keeps the chains of K7_JOINTS joints a pass (csrc/wide/, WB_JB).
K7_JOINTS = 8


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def mix_floats(J: int) -> int:
    """The kernels' copy of mix in shared memory: J x J floats padded to 16
    bytes (WB_MIX_FLOATS; 12 at J = 3)."""
    return _pad4(J * J)


def end_floats(J: int) -> int:
    """A lane's endpoint block: start, goal, t0, tN, v0, vN (6 J floats)
    and two pad slots (a step's outcome, K7's flag), padded to 16 bytes
    (WB_LANE_FLOATS; 20 at J = 3)."""
    return _pad4(6 * J + 2)


def buffer_rows(J: int) -> int:
    """The rows of a lane's buffer (WB_ROWS; 8 at J = 3): the 2 J + 1 cost
    rows of a reduction, and the room of a staged product input or the
    stacked gradient, 2 T timesteps of J floats padded to whole float4."""
    return max(2 * J + 1, 2 * _pad4(J))


def link_floats(J: int) -> int:
    """The CTA's copy of the link lengths at J >= WIDE_J (csrc/wide/
    reads them from shared memory), padded to 16 bytes; none below."""
    return _pad4(J) if J >= WIDE_J else 0


def cta_bytes(J: int) -> int:
    """The streamed CTA's pieces besides the room: mix, link (J >=
    WIDE_J) and the control block (WB_CTA_FLOATS; 128 bytes at J = 3)."""
    return 4 * (mix_floats(J) + link_floats(J) + CTL_FLOATS)


def k7_rows(lanes: int, J: int = 3) -> int:
    """Rows of a K7 thread's register block (k7_rows, WB_K7_ROWS): K7_ROWS
    at J <= 4, K7_ROWS_WIDE beyond (its K7_ROWS x K7_LANES x J accumulators
    stay within the streamed body's registers), K7_SOLO_ROWS for one lane
    alone."""
    if lanes == 1:
        return K7_SOLO_ROWS
    return K7_ROWS if J <= 4 else K7_ROWS_WIDE


def k7_row_block(rows: int, lanes: int, J: int = 3) -> int:
    """K7's rows per pass (a row block of the basis in device memory) for a
    product of ``rows`` output rows on a tile of ``lanes`` lanes (mirror of
    k7_row_block): the consumer warps' threads split the lanes into blocks
    of K7_LANES and each block's rows among them, :func:`k7_rows`
    consecutive rows a thread; at most the rows, padded to a multiple of
    4."""
    blocks = -(-lanes // K7_LANES)
    units = 32 * (STREAM_WARPS - 1) // blocks
    return min(k7_rows(lanes, J) * units, _pad4(rows))


def room_floats(T: int, lanes: int, lane_floats: int, J: int = 3,
                planes: bool = True) -> int:
    """The CTA's room (mirror of ws_room_floats): the shared memory the
    lanes leave, at most RING_CAP floats, at least the tile's gx/gy planes
    (floats, a multiple of 4) where the room holds them (``planes``; the
    linearized ladder's reach layout holds them in the direction
    planes)."""
    left = max(SMEM_PER_CTA_MAX // 4 - cta_bytes(J) // 4
               - lanes * lane_floats, 0)
    room = min(left, RING_CAP) & ~3
    return max(room, _pad4(2 * T * lanes)) if planes else room


def k7_geometry(T: int, lanes: int, room: int, J: int = 3) -> dict:
    """K7's ring in a room of ``room`` floats for a tile of ``lanes`` lanes
    at T: the lane blocks; for each basis product, kv (2T rows, T
    timesteps) and kvt (T rows, 2T timesteps), the rows of a row block, the
    passes (row blocks) and the timesteps per ring stage (room / (K7_STAGES
    row block)); the ring's bytes (the whole room)."""
    out = {"lane_blocks": -(-lanes // K7_LANES), "ring_bytes": 4 * room}
    if J >= WIDE_J:
        # The register block holds K7_JOINTS joints: the ring streams each
        # row block once per block of joints.
        out["joint_blocks"] = -(-J // K7_JOINTS)
    for name, rows in (("kv", 2 * T), ("kvt", T)):
        rb = k7_row_block(rows, lanes, J)
        out[name] = {"row_block": rb, "passes": -(-rows // rb),
                     "stage_t": room // (K7_STAGES * rb)}
    return out


def launch_plan(cfg: PlannerConfig, O: int, plan: str = "",
                prog: str = "bls") -> dict:
    """K1/K2's dynamic shared memory per CTA, by piece, in bytes (mirror of
    warp_smem_bytes in csrc/warp_body.cuh, which re-checks it), in the
    ``plan`` of PLANS: by default ``"resident"`` for T <= WARP_MAX_T and
    ``"streamed"`` beyond, for the program ``prog`` of PROGRAMS.

    Every piece follows the joint count J = ``cfg.n_joints`` (the numbers
    in brackets are J = 3's); any J up to MAX_J has a plan where its pieces
    fit.  From J = WIDE_J up (csrc/wide/, J at run time) the CTA also holds
    ``link`` (J floats padded to 4), and the resident plan's warps hold the
    traj/vel and gx/gy planes (``state``: 6 J T + 2 T padded to 4, less
    the four planes) that the J <= 15 resident body keeps in registers;
    the streamed and reach layouts are the J <= 15 ones, and ``bls_bf16``
    holds its rounded planes as float32 there (its plans are ``bls``'s).  Resident: per CTA the basis pair transposed
    (2 x 2T x T) and mix (:func:`mix_floats`: J x J padded to 4 floats
    [12]); per warp (one per lane) the planes alpha, grad, dir_t, dir_v (J x
    T each), the buffer (:func:`buffer_rows` [8] rows of T padded to a
    multiple of 4, which also holds a product's staged input and the stacked
    gradient, 2T timesteps of J floats padded to whole float4), the obstacle
    terms (float4 each) and the endpoints (:func:`end_floats` [20]); the
    most lanes, at most ``cfg.pallas_block_b`` (0: DEFAULT_WARPS), that fit
    (every one of them up to J = 5; at J = 7 and T = 64, 14).

    Streamed: a CTA of STREAM_WARPS warps runs a tile of lanes in lockstep,
    one warp each; its other warps help with the basis products and its
    last is K7's producer.  Per CTA mix and the control block (K7's
    mbarriers, the tile's first lane: "control") and the room (the tile's
    gx/gy planes, 2T each, which the K7 ring takes whole during a product:
    :func:`room_floats`, :func:`k7_geometry`, "ring" in the result); per
    lane the same pieces as the resident plan's and the traj/vel planes
    ("state", padded so the six planes end on 16 bytes).  The lanes: the
    most, at most ``cfg.pallas_block_b`` (0: DEFAULT_WARPS) and
    STREAM_WARPS - 1, that leave the ring RING_MIN_BYTES and run each
    product in one pass of K7's threads, else the most that fit.  Every program but ``bls_bf16`` has this layout (the ultra
    tier holds the same planes: there is no FK plane to drop, and the
    ladder reads traj/vel at every rung).  The streamed plan of
    ``bls_bf16`` holds the ladder planes (traj, vel, dir_t, dir_v: 4 J T
    bfloat16; at the round start and end they hold the float32 traj/vel
    instead) beside the planes alpha and grad and no state plane, and its
    gradient pass recomputes FK instead of keeping the tangents: 24 bytes
    per timestep less at J = 3.  Its resident plan is the float32 one (the
    rounded values held as float32).

    Reach (the float32 programs only; by default where the streamed plan
    does not fit one lane): the streamed body with the gradient pass
    recomputing FK from (traj, vel) instead of keeping the tangents in the
    direction planes (the same floats, so each lane's result is the
    streamed plan's bit for bit).  ``gd`` and ``bls_exact``, which use the
    direction planes for nothing else, then hold none: the planes alpha
    and grad, the state planes traj and vel (24 bytes per timestep less at
    J = 3, the bf16 plan's bytes: one lane per CTA up to T = 2,636 at 11
    obstacles).  The linearized ladder's programs keep the streamed pieces
    and hold the tile's gx/gy planes in the direction planes, free from a
    step's accepted update to its next direction, so the room is the K7
    ring's alone (8 bytes per timestep less: up to T = 2,156).

    Returns {"plan", "lanes": lanes per CTA, "warps": the CTA's warps,
    "bytes": {piece: bytes}, "total", "ring": the K7 ring (streamed and
    reach), "bf16": the half-width layout}.  Raises ValueError for a
    lanes-per-CTA value, plan or program the kernels cannot take (the
    reach plan of ``bls_bf16``), NotImplementedError when the plan does not
    fit: a J past the parameter block's MAX_J, the resident plan past
    WARP_MAX_T (the message names the streamed plan), any plan when a
    single lane does not fit in a CTA's shared memory (the message names
    the largest piece)."""
    want = warps_per_cta(cfg)
    T, J = cfg.n_timesteps, cfg.n_joints
    if not 1 <= J <= MAX_J:
        raise NotImplementedError(
            f"J={J}: the kernels' parameter block holds 1 <= J <= {MAX_J} "
            f"joints")
    wide = J >= WIDE_J
    if plan not in PLANS + ("",):
        raise ValueError(f"launch plan {plan!r} is not one of {PLANS}")
    if prog not in PROGRAMS:
        raise ValueError(f"program {prog!r} is not one of {PROGRAMS}")
    if not plan and T > WARP_MAX_T and prog != "bls_bf16":
        try:
            return launch_plan(cfg, O, "streamed", prog)
        except NotImplementedError:
            return launch_plan(cfg, O, "reach", prog)
    plan = plan or ("resident" if T <= WARP_MAX_T else "streamed")
    if plan == "reach" and prog == "bls_bf16":
        raise ValueError("the reach plan holds the float32 programs; the "
                         "bf16 tier's streamed plan is its own")
    f = 4
    rows = (T + 3) // 4 * 4
    per_warp = {
        "planes": f * 4 * J * T,
        "buffer": f * buffer_rows(J) * rows,
        "obstacles": f * 4 * O,
        "endpoints": f * end_floats(J),
    }
    if plan == "resident":
        if T > WARP_MAX_T:
            raise NotImplementedError(
                f"T={T}: the resident plan holds two timesteps per thread "
                f"(T <= {WARP_MAX_T}) and the basis pair (16 T^2 bytes) in "
                f"shared memory; the streamed plan runs this T"
            )
        cta = {"basis": f * 4 * T * T, "mix": f * mix_floats(J)}
        if wide:
            cta["link"] = f * link_floats(J)
            per_warp["state"] = f * (_pad4(6 * J * T + 2 * T) - 4 * J * T)
        one = sum(per_warp.values())
        lanes = min(want, (SMEM_PER_CTA_MAX - sum(cta.values())) // one)
        if lanes < 1:
            big = max({**cta, **per_warp}.items(), key=lambda kv: kv[1])
            raise NotImplementedError(
                f"T={T}, J={J}: the resident plan needs "
                f"{sum(cta.values()) + one} bytes of shared memory per CTA "
                f"for one lane, more than {SMEM_PER_CTA_MAX}; the largest "
                f"piece is {big[0]} ({big[1]} bytes)"
            )
        pieces = {**cta, **{k: lanes * v for k, v in per_warp.items()}}
        return {"plan": plan, "lanes": lanes, "warps": lanes,
                "bytes": pieces, "total": sum(pieces.values()),
                "bf16": False}
    if T < STREAM_MIN_T:
        raise ValueError(
            f"T={T}: the streamed plan needs T >= {STREAM_MIN_T} (every "
            f"thread of a warp owns a timestep)")
    half = prog == "bls_bf16" and not wide
    per_lane = dict(per_warp)
    if half:
        per_lane["planes"] = f * 2 * J * T
        per_lane["ladder"] = f * 2 * J * T
    elif plan == "reach" and prog in REACH_NODIR:
        per_lane["planes"] = f * 2 * J * T
        per_lane["state"] = f * 2 * J * T
    else:
        per_lane["state"] = f * (_pad4(6 * J * T) - 4 * J * T)
    one = sum(per_lane.values())
    # The linearized ladder's reach layout holds the tile's gx/gy in the
    # direction planes.
    room_planes = not (plan == "reach" and prog not in REACH_NODIR)

    def layout(lanes):
        room = room_floats(T, lanes, one // f, J, room_planes)
        pieces = {"mix": f * mix_floats(J),
                  **({"link": f * link_floats(J)} if wide else {}),
                  "control": f * CTL_FLOATS, "room": f * room,
                  **{k: lanes * v for k, v in per_lane.items()}}
        ring = k7_geometry(T, lanes, room, J)
        fits = (sum(pieces.values()) <= SMEM_PER_CTA_MAX
                and min(ring["kv"]["stage_t"], ring["kvt"]["stage_t"]) >= 1)
        return pieces, ring, fits

    fit = [n for n in range(1, min(want, STREAM_WARPS - 1) + 1)
           if layout(n)[2]]
    if not fit:
        big = max(per_lane, key=per_lane.get)
        raise NotImplementedError(
            f"T={T}, J={J}: one lane's state does not fit in shared "
            f"memory in the {plan} plan of {prog}: "
            f"{one + (f * 2 * T if room_planes else 0)} bytes per lane, "
            f"{SMEM_PER_CTA_MAX - cta_bytes(J)} free per CTA; the largest "
            f"piece is {big} ({per_lane[big]} bytes)"
        )
    def roomy(n):
        ring = layout(n)[1]
        return (ring["ring_bytes"] >= RING_MIN_BYTES
                and ring["kv"]["passes"] == ring["kvt"]["passes"] == 1)

    lanes = max([n for n in fit if roomy(n)] or fit)
    pieces, ring, _ = layout(lanes)
    return {"plan": plan, "lanes": lanes, "warps": STREAM_WARPS,
            "bytes": pieces, "total": sum(pieces.values()), "ring": ring,
            "bf16": half}


def kernel_plan(cfg: PlannerConfig, O: int, solver: str = "bls"):
    """The launch plan the kernels run for ``solver`` under ``cfg``
    (:func:`launch_plan` of its float32 program: the resident or streamed
    plan, and past the streamed plan's ceiling, T = 2,072 at 11 obstacles,
    the reach plan, as JAX's choose_kernel_plan selects its lean and ultra
    layouts only where the full one cannot fit: GD and the exact ladder up
    to T = 2,636, the linearized ladder up to T = 2,156), or None where
    none fits; the fleet solver then runs its plain engine.  Past the
    float32 plans, BLS with the linearized ladder and
    ``cfg.bls_bf16_ladder`` (the opt-in, as JAX's choose_kernel_plan asks
    for it) gets the ``bls_bf16`` program's streamed plan while it fits (up
    to T = 2,636 at 11 obstacles); its ``"bf16"`` is then true.  The ultra
    tier frees no shared memory here, so no plan selects it."""
    try:
        return launch_plan(cfg, O, prog=program(cfg, solver))
    except NotImplementedError:
        pass
    if (not _solver_is_gd(solver) and cfg.ladder_eval == "linearized"
            and cfg.bls_bf16_ladder):
        try:
            return launch_plan(cfg, O, prog="bls_bf16")
        except NotImplementedError:
            pass
    return None


def no_plan_reason(cfg: PlannerConfig, O: int, solver: str = "bls") -> str:
    """Why :func:`kernel_plan` gives no plan: the NotImplementedError of
    the float32 program's :func:`launch_plan`, which names the piece of
    shared memory that does not fit; empty where a plan fits."""
    try:
        launch_plan(cfg, O, prog=program(cfg, solver))
    except NotImplementedError as e:
        return str(e)
    return ""


def launch_shape(cfg: PlannerConfig, O: int, B: int, kernel: str,
                 solver: str = "bls", plan: str = "", **tier) -> dict:
    """What the card makes of the launch plan (:func:`launch_plan`) of K1
    (``kernel="fused_solve"``) or K2 (``"fused_round"``) for ``solver``
    (BLS: in the ladder tier of ``cfg`` and the kernel tier of the
    ``lean``/``ultra``/``bf16`` keywords, :func:`program`): CTAs per SM (the
    CUDA occupancy calculator, registers and shared memory), SMs, shared
    memory per CTA and warps per CTA as the C side computes them, warps per
    SM.  Needs the card."""
    from ._build import load_library

    prog = program(cfg, solver, **tier)
    lp = launch_plan(cfg, O, plan, prog)
    out = (ctypes.c_int * 4)()
    err = load_library(cfg.n_joints).fused_launch_shape(
        kernel_params(cfg, O, B), lp["lanes"],
        {"fused_solve": 0, "fused_round": 1}[kernel],
        PROGRAMS.index(prog), PLANS.index(lp["plan"]), out)
    if err:
        raise RuntimeError(f"{kernel}: launch shape refused (CUDA error {err})")
    return {"ctas_per_sm": out[0], "sms": out[1], "smem": out[2],
            "warps_per_cta": out[3], "warps_per_sm": out[0] * out[3]}


_MEMO: dict = {}


def memo(name: str, fn, *xs):
    """``fn(*xs)``, built once for the same tensors: the last result under
    ``name`` is returned while every tensor of ``xs`` is the one it was built
    from and unchanged since (the same object at the same version)."""
    hit = _MEMO.get(name)
    versions = tuple(x._version for x in xs)
    if (hit is not None and len(hit[0]) == len(xs)
            and all(r() is x for r, x in zip(hit[0], xs))
            and hit[1] == versions):
        return hit[2]
    out = fn(*xs)
    _MEMO[name] = ([weakref.ref(x) for x in xs], versions, out)
    return out


def streamed_basis(kv, kvt, ring: dict):
    """The basis pair as the streamed body's K7 reads it from device
    memory, for the launch plan's ``ring`` (:func:`k7_geometry`): each
    matrix transposed and cut into blocks of its row-block rows, block
    after block, each block's rows contiguous per timestep and zero-padded
    to a whole block: M (rows, n_t) -> (blocks, n_t, row block), kv (2T, T)
    and kvt (T, 2T), so one ring stage (a run of timesteps of one block) is
    one contiguous copy (csrc/warp_body.cuh, k7_product).  Built once per
    basis pair and row blocks (:func:`memo`), not at every launch."""
    def blocked(m, rb):
        rows, n_t = m.shape
        blocks = -(-rows // rb)
        out = torch.zeros((blocks * rb, n_t), dtype=m.dtype, device=m.device)
        out[:rows] = m
        return out.reshape(blocks, rb, n_t).transpose(1, 2).contiguous()

    rb, rbt = ring["kv"]["row_block"], ring["kvt"]["row_block"]
    return memo(f"streamed_basis_{rb}_{rbt}",
                lambda a, b: (blocked(a, rb), blocked(b, rbt)), kv, kvt)


def k7_forward(cfg: PlannerConfig, kv, kvt, mix, alpha):
    """K7 alone: (traj, vel) = the forward evaluation of alpha (J, T, B),
    ``kv @ alpha_j`` with the mix combine, each (J, T, B), through the
    streamed body's product on the streamed launch plan's tiles of lanes
    (csrc/fused_solve.cu, k7_forward_kernel): the product K1/K2 run at
    T > 64, on its own for measurement.  Bit for bit K6's evaluation
    (step_kernels.forward_eval).  On the CPU: the plain version,
    :func:`forward_planes`."""
    if alpha.device.type != "cuda":
        return forward_planes(kv, mix, alpha)
    from ._build import launch

    J, T, B = alpha.shape
    O = cfg.max_obstacles
    lp = launch_plan(cfg, O, "streamed")
    kvT, _ = streamed_basis(kv, kvt, lp["ring"])
    traj = torch.empty_like(alpha)
    vel = torch.empty_like(alpha)
    queue = torch.zeros(1, dtype=torch.int32, device=alpha.device)
    launch("k7_forward", kernel_params(cfg, O, B), lp["lanes"],
           [kvT, mix, alpha.contiguous(), traj, vel, queue], alpha.device)
    k7_forward.launches += 1
    return traj, vel


k7_forward.launches = 0


def program(cfg: PlannerConfig, solver: str, lean: bool = False,
            ultra: bool = False, bf16: bool = False) -> str:
    """The compiled program of K1/K2 that runs ``solver`` under ``cfg`` in
    the tier the keywords ask for (pallas_step.fused_solve's ``lean``,
    ``ultra``, ``bf16``): GD's (the tiers change nothing: GD carries no FK,
    its trial evaluates from alpha and it holds no ladder planes; JAX's
    GD-ultra is bitwise its GD); the exact ladder's (lean and ultra change
    nothing: it carries no FK and its carried evaluation is exact, so JAX's
    exact-ultra is bitwise its exact; bf16 raises NotImplementedError, as
    ``cfg.bls_bf16_ladder`` does there); or the linearized ladder's:
    ``bls_bf16`` (ultra implied), ``bls_ultra`` or ``bls``, which is also
    the lean tier's (lean recomputes the loss and FK that ``bls`` carries
    from the accepted rung; the port forms that candidate with the rung's
    own operations, so the recompute gives the carried floats)."""
    if _solver_is_gd(solver):
        return "gd"
    if cfg.ladder_eval == "exact":
        if bf16:
            raise NotImplementedError(
                "the bf16 tier quantises the linearized ladder's planes; "
                "the exact ladder has none")
        return "bls_exact"
    if bf16:
        return "bls_bf16"
    if ultra:
        return "bls_ultra"
    return "bls"


def program_call(prog: str) -> tuple:
    """(solver, ladder_eval, tier keywords) that run the program ``prog`` of
    PROGRAMS (the inverse of :func:`program`)."""
    if prog not in PROGRAMS:
        raise ValueError(f"program {prog!r} is not one of {PROGRAMS}")
    if prog == "gd":
        return "gd", "linearized", {}
    if prog == "bls_exact":
        return "bls", "exact", {}
    return "bls", "linearized", ({prog[4:]: True} if prog != "bls" else {})


_PARAMS: dict = {}


def params_type(J: int = 3):
    """The ctypes mirror of the kernels' parameter block for the library of
    J joints (passed by value), field for field in the same order: below
    WIDE_J ``struct FsParams`` of csrc/lane_body.cuh (``link`` holds J
    floats after ``sched``), from WIDE_J up ``struct WParams`` of
    csrc/wide/wide_body.cuh (one type for every such J: ``J``, then ``link``
    in MAX_J slots, last).  ``_build.load_library`` refuses a library whose
    struct size or last-field offset differ, and tests/test_torch_fused_gd.py,
    tests/test_torch_joints.py and tests/test_torch_many_joints.py hold the
    field lists equal.  Float fields hold the f32 roundings of the
    Python-float constants, as JAX's weak typing rounds them."""
    key = "wide" if J >= WIDE_J else J
    if key not in _PARAMS:
        _PARAMS[key] = type(f"_Params{J if key == J else 'Wide'}",
                            (ctypes.Structure,),
                            {"_fields_": _params_fields(J)})
    return _PARAMS[key]


def params_joints(params) -> int:
    """The J of a parameter block (:func:`kernel_params`)."""
    return params.J if hasattr(params, "J") else len(params.link)


def _params_fields(J: int) -> list:
    head = [
        ("T", ctypes.c_int), ("O", ctypes.c_int), ("B", ctypes.c_int),
        ("rounds", ctypes.c_int), ("n_bls", ctypes.c_int),
        ("masked", ctypes.c_int),
        ("sched", ctypes.c_int * MAX_ROUNDS),
    ]
    tail = [
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
    if J >= WIDE_J:
        return head + tail + [("J", ctypes.c_int),
                              ("link", ctypes.c_float * MAX_J)]
    return head + [("link", ctypes.c_float * J)] + tail


# The reference arm's (J = 3) mirror.
_Params = params_type(3)


def kernel_params(cfg: PlannerConfig, O: int, B: int,
                  schedule: bool = True):
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
    p = params_type(cfg.n_joints)(
        T=T, O=O, B=B, rounds=len(sched), n_bls=cfg.max_bls_iteration,
        masked=int(cfg.constraint_violating_dependant_loss),
    )
    if cfg.n_joints >= WIDE_J:
        p.J = cfg.n_joints
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
    """Raise NotImplementedError for the BLS modes this port does not run.
    Both ladder tiers run.  ``bls_bf16_ladder`` (the opt-in to the bf16
    tier's plan past the f32 plans' ceiling, :func:`kernel_plan`) runs under
    the linearized ladder and raises under the exact one, which has no
    ladder planes to quantise (the JAX planner admits it there and then
    runs the unquantised kernel on a bf16-sized plan).
    ``exact_constraint_eval=False`` is a no-op under the exact ladder, whose
    carried evaluation is exact, as in the JAX kernel; under the linearized
    ladder it raises."""
    check_precision(cfg)
    if cfg.bls_bf16_ladder and cfg.ladder_eval == "exact":
        raise NotImplementedError(
            "bls_bf16_ladder quantises the linearized ladder's planes; the "
            "exact ladder has none"
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
                goal, ox, oy, ow, *, solver: str = "bls", ctas: int = 0,
                plan: str = "", lean: bool = False, ultra: bool = False,
                bf16: bool = False) -> FusedSolve:
    """The whole penalty-method solve of ``solver`` (``"bls"``, in the ladder
    tier ``cfg.ladder_eval``, or ``"gd"``; GD's round r starts from
    ``gd_lr[min(r, len(gd_lr) - 1)]``) for every lane, in the kernel tier
    ``lean``/``ultra``/``bf16`` asks for (pallas_step.fused_solve's
    keywords; :func:`program` says which program runs).

    kv (2T, T), kvt (T, 2T), mix (J, J), a0 (J, T, B), lam_sg0/lam_jl0
    (1, B), start/goal (J, B), ox/oy/ow (O, B), all f32.  CPU tensors run
    :func:`fused_solve_reference`; CUDA tensors launch the kernel (one warp
    per lane, ``cfg.pallas_block_b`` lanes per CTA or DEFAULT_WARPS when it
    is 0, see :func:`launch_plan`) and raise if it cannot be built or
    launched.  ``ctas``: CTAs of the persistent grid (0: every CTA that
    fits on the card); ``plan``: the launch plan, one of PLANS (empty: the
    one :func:`launch_plan` chooses for T).  Per-lane results depend on
    neither."""
    args = (kv, kvt, mix, a0, lam_sg0, lam_jl0, start, goal, ox, oy, ow)
    where = _check_args("fused_solve", cfg, tuple(zip(_LABELS, args)),
                        lambda J, T, O, B: (
                            (2 * T, T), (T, 2 * T), (J, J), (J, T, B),
                            (1, B), (1, B), (J, B), (J, B), (O, B), (O, B),
                            (O, B)), solver_check(solver))
    prog = program(cfg, solver, lean, ultra, bf16)
    launch_plan(cfg, ox.shape[0], plan, prog)
    if where == "cpu":
        return fused_solve_reference(cfg, *args, solver=solver, lean=lean,
                                     ultra=ultra, bf16=bf16)
    kv, kvt, mix, a0, lam_sg0, lam_jl0, start, goal, ox, oy, ow = (
        x.contiguous() for x in args
    )
    alpha = a0.clone()
    outs = _launch("fused_solve", cfg, prog, plan, alpha, 4, ctas, [],
                   [kv, kvt, mix, lam_sg0, lam_jl0, start, goal, ox, oy, ow])
    fused_solve.launches += 1
    return FusedSolve(alpha, *outs)


fused_solve.launches = 0


def fused_round(cfg: PlannerConfig, kv, kvt, mix, alpha, lam_sg, lam_jl,
                fulfilled, lr0, n_r: int, start, goal, ox, oy, ow, *,
                solver: str = "bls", ctas: int = 0, plan: str = "",
                lean: bool = False, ultra: bool = False,
                bf16: bool = False) -> FusedRound:
    """ONE penalty round of ``solver`` (in the kernel tier of ``lean``,
    ``ultra``, ``bf16``, as :func:`fused_solve`) for every lane: round-start fused
    evaluation under the lane's penalties, up to ``n_r`` steps from the
    lane's learning rate ``lr0`` (BLS adapts it from there; GD keeps it),
    the exact evaluation at the final alpha and the constraint check.  The
    penalty escalation is the caller's.  Lanes with ``fulfilled`` set pass
    through (alpha unchanged, no steps, loss 0, ok 1).

    alpha (J, T, B), lam_sg/lam_jl/fulfilled/lr0 (1, B), n_r a Python int,
    the rest as :func:`fused_solve`.  CPU tensors run
    :func:`fused_round_reference`; CUDA tensors launch the kernel (the
    budget is a plain kernel argument: every round shares one build; lanes
    per CTA, ``ctas`` and ``plan`` as :func:`fused_solve`) and raise if it
    cannot be built or launched."""
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
    prog = program(cfg, solver, lean, ultra, bf16)
    launch_plan(cfg, ox.shape[0], plan, prog)
    if where == "cpu":
        return fused_round_reference(cfg, kv, kvt, mix, alpha, lam_sg, lam_jl,
                                     fulfilled, lr0, n_r, start, goal, ox, oy,
                                     ow, solver=solver, lean=lean, ultra=ultra,
                                     bf16=bf16)
    (kv, kvt, mix, alpha, lam_sg, lam_jl, fulfilled, lr0, start, goal, ox, oy,
     ow) = (x.contiguous() for x in args)
    out_alpha = alpha.clone()
    outs = _launch("fused_round", cfg, prog, plan, out_alpha, 3, ctas,
                   [ctypes.c_int(n_r)],
                   [kv, kvt, mix, lam_sg, lam_jl, fulfilled, lr0, start, goal,
                    ox, oy, ow])
    fused_round.launches += 1
    return FusedRound(out_alpha, *outs)


fused_round.launches = 0


def _launch(name: str, cfg: PlannerConfig, prog: str, plan: str, alpha,
            n_out: int, ctas: int, scalars, inputs) -> list:
    """Launch ``<name>_launch`` of the kernel library on the current stream,
    the instantiation of the program ``prog`` in the body of the launch plan
    (:func:`launch_plan`; the streamed body takes the basis pair as
    :func:`streamed_basis` gives it for the plan's ring): the persistent grid (``ctas`` CTAs, 0:
    all that fit) over a lane queue zeroed here; ``alpha`` (J, T, B) is
    updated in place, ``n_out`` (1, B) outputs are returned.  Raises when
    the launch is refused."""
    from ._build import launch

    J, T, B = alpha.shape
    O = inputs[-1].shape[0]
    if ctas < 0:
        raise ValueError(f"{name}: ctas must be >= 0, got {ctas}")
    lp = launch_plan(cfg, O, plan, prog)
    body = PLANS.index(lp["plan"])
    if body:
        inputs = [*streamed_basis(inputs[0], inputs[1], lp["ring"]),
                  *inputs[2:]]
    dev = alpha.device
    outs = [torch.empty((1, B), dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    launch(name, kernel_params(cfg, O, B), lp["lanes"],
           [ctypes.c_int(PROGRAMS.index(prog)), ctypes.c_int(body),
            ctypes.c_int(ctas), *scalars,
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
