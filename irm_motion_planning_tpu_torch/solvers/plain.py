"""Python-loop solvers, one scene (counterpart of
irm_motion_planning_tpu/solvers/plain.py; the reference's ``--jit-loop
false`` paths, plain_optimize / dual_optimize, ref: optimizer_BLS.py:65-123,
optimizer_GD.py:100-169).

Every decision is taken on the host from the scalars of one cost
evaluation at a time, as the reference does; the updates are formed op by
op (two roundings), as the JAX package's eager loop forms them.  They can record the
trajectory after every accepted step, the series the visualization reads
(ref: main.py:150-153).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import PlannerConfig
from ..models.rkhs import Basis, evaluate, init_alpha
from ..ops.costs import Penalty, constraints_fulfilled, cost_and_grad, total_cost
from ..ops.scenario import Scenario
from .common import SolveResult, SolveStats


def plain_solve(cfg: PlannerConfig, basis: Basis, scn: Scenario,
                alpha0: Optional[torch.Tensor] = None, solver: str = "bls",
                record_series: bool = False
                ) -> Tuple[SolveResult, Optional[List[np.ndarray]]]:
    """The penalty-method solve of one scene in a Python loop.  Returns
    (result, series): series is the list of trajectories (T, J), the warm
    start's and one per accepted step, when ``record_series``."""
    if solver == "bls":
        return _plain_bls(cfg, basis, scn, alpha0, record_series)
    if solver == "gd":
        return _plain_gd(cfg, basis, scn, alpha0, record_series)
    raise ValueError(f"unknown solver {solver!r}")


def _finish(alpha, outer_iter, total_inner, fulfilled, loss) -> SolveResult:
    dev = alpha.device
    return SolveResult(
        alpha=alpha,
        stats=SolveStats(
            outer_iters=torch.tensor(outer_iter, dtype=torch.int32, device=dev),
            inner_iters=torch.tensor(total_inner, dtype=torch.int32,
                                     device=dev),
            converged=torch.tensor(fulfilled, device=dev),
            final_cost=torch.as_tensor(loss, dtype=torch.float32,
                                       device=dev).reshape(()),
        ),
    )


def _penalty(lam_sg: float, lam_jl: float, dev) -> Penalty:
    return Penalty(torch.tensor(lam_sg, dtype=torch.float32, device=dev),
                   torch.tensor(lam_jl, dtype=torch.float32, device=dev))


def _start(cfg, basis, scn, alpha0, record_series):
    alpha = (alpha0 if alpha0 is not None
             else init_alpha(cfg, basis, scn.start, scn.goal))
    series = ([evaluate(cfg, basis, alpha)[0].cpu().numpy()]
              if record_series else None)
    return alpha, series


def _plain_bls(cfg, basis, scn, alpha0, record_series):
    """(ref: optimizer_BLS.py:65-123)"""
    alpha, series = _start(cfg, basis, scn, alpha0, record_series)
    dev = alpha.device
    lam_sg, lam_jl = cfg.lambda_sg_constraint, cfg.lambda_jl_constraint
    total_inner, outer_iter, loss, fulfilled = 0, 0, float("inf"), False
    for outer_iter in range(cfg.max_outer_iteration):
        pen = _penalty(lam_sg, lam_jl, dev)
        bls_lr = cfg.bls_lr_start
        for _ in range(cfg.max_inner_iteration):
            loss, grad = cost_and_grad(cfg, basis, scn, pen, alpha)
            n_grad = grad / torch.linalg.norm(grad)
            # The reference's quirk: the sum over ALL (J, J) entries.
            alpha_norm = torch.sum(grad.T @ n_grad)
            new_loss = loss
            for _ in range(cfg.max_bls_iteration):
                new_alpha = ((1 - cfg.lambda_reg * bls_lr) * alpha
                             - bls_lr * n_grad)
                new_loss = total_cost(cfg, basis, scn, pen, new_alpha)
                required = loss - cfg.bls_alpha * bls_lr * alpha_norm
                if float(new_loss) > float(required):
                    bls_lr *= cfg.bls_beta_minus
                else:
                    alpha = new_alpha
                    bls_lr *= cfg.bls_beta_plus
                    break
            total_inner += 1
            if float(loss) - float(new_loss) < cfg.loop_loss_reduction:
                break
            if record_series:
                series.append(evaluate(cfg, basis, alpha)[0].cpu().numpy())
        fulfilled = bool(constraints_fulfilled(cfg, basis, scn, alpha))
        if fulfilled:
            break
        lam_sg *= cfg.lambda_constraint_increase
        lam_jl *= cfg.lambda_constraint_increase
    return _finish(alpha, outer_iter, total_inner, fulfilled, loss), series


def _plain_gd(cfg, basis, scn, alpha0, record_series):
    """(ref: optimizer_GD.py:122-169)"""
    alpha, series = _start(cfg, basis, scn, alpha0, record_series)
    dev = alpha.device
    lam_sg, lam_jl = cfg.lambda_sg_constraint, cfg.lambda_jl_constraint
    total_inner, outer_iter, fulfilled = 0, 0, False
    last_loss = float("inf")
    for outer_iter in range(cfg.max_outer_iteration):
        pen = _penalty(lam_sg, lam_jl, dev)
        lr = cfg.gd_lr[outer_iter]
        last_loss, grad = cost_and_grad(cfg, basis, scn, pen, alpha)
        for _ in range(cfg.max_inner_iteration):
            new_alpha = (1 - cfg.lambda_reg * lr) * alpha - lr * grad
            new_loss, new_grad = cost_and_grad(cfg, basis, scn, pen,
                                               new_alpha)
            if float(last_loss) - float(new_loss) < cfg.loop_loss_reduction:
                break
            alpha, grad, last_loss = new_alpha, new_grad, new_loss
            total_inner += 1
            if record_series:
                series.append(evaluate(cfg, basis, alpha)[0].cpu().numpy())
        fulfilled = bool(constraints_fulfilled(cfg, basis, scn, alpha))
        if fulfilled:
            break
        lam_sg *= cfg.lambda_constraint_increase
        lam_jl *= cfg.lambda_constraint_increase
    return _finish(alpha, outer_iter, total_inner, fulfilled,
                   last_loss), series
