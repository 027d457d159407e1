"""Backtracking line search (Armijo), one scene or a batch of them lane by
lane (counterpart of irm_motion_planning_tpu/solvers/bls.py; the batched
form is solvers/lanes.py's).

Per inner step (ref: optimizer_BLS.py:159-179): loss and gradient at alpha
(fused), ``n_grad = grad / |grad|``, ``alpha_norm = sum(grad^T n_grad)``
over ALL (J, J) entries (the reference's quirk, optimizer_BLS.py:86), then
a line search over ``alpha' = (1 - lambda_reg lr) alpha - lr n_grad``:
accept when ``new_loss <= loss - bls_alpha lr alpha_norm``, shrink lr by
beta_minus on a reject, grow it by beta_plus on the accept; the accepted
lr carries across inner steps and restarts at bls_lr_start each round.

Two executions of the search (``cfg.bls_mode``):

* ``"sequential"``: the reference's loop, one trial cost at a time until
  the first accept, with the exhausted lanes frozen per trial;
* ``"ladder"``: every rung ``lr beta_minus^j`` at once in one batched
  evaluation, the first passing rung taken.  The current iterate is
  evaluated in the SAME batched evaluation as the rungs and is the Armijo
  and stop baseline: on this ill-conditioned parametrization two fp paths
  differ by ~1e-4 relative on the same point, above the margin of
  small-lr rungs and the 1e-3 stop threshold (the JAX package measured 13%
  converged with a cross-path baseline against the reference's 53%).

Trials and rungs are formed with one rounding (fused_solve.fma), as XLA
forms them.  :func:`solve` and :func:`solve_batch` round the basis products
in XLA's CPU order (models/xla_order.py) under either search, so the CPU
and the card give the same bits; only the sequential search is also the
JAX package's bits (its single-scene solve), since the ladder's batch of
rungs is the port's own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PlannerConfig
from ..models.rkhs import Basis
from ..ops import fused_solve as fs
from ..ops.costs import Penalty, cost_and_grad, total_cost
from ..ops.scenario import Scenario
from .common import SolveResult, freeze_leading, inner_loop_bound, run_inner_loop
from .lanes import lanes_of, solve_lanes, solve_one


def _trial(cfg: PlannerConfig, alpha, n_grad, lr):
    """A trial step ``(1 - lambda_reg lr) alpha - lr n_grad`` (ref:
    optimizer_BLS.py:139); lr (B,) or (B, n)."""
    lr = lanes_of(lr, 2)
    return fs.fma(1.0 - cfg.lambda_reg * lr, alpha, -(lr * n_grad))


def _rungs(cfg: PlannerConfig, device) -> torch.Tensor:
    """float32 powers beta_minus^j, j < max_bls_iteration, as jnp.power
    forms them."""
    return torch.pow(
        torch.tensor(cfg.bls_beta_minus, dtype=torch.float32, device=device),
        torch.arange(cfg.max_bls_iteration, dtype=torch.float32,
                     device=device))


def _exhausted_factor(cfg: PlannerConfig) -> float:
    """The lr factor after max_bls_iteration rejects, beta_minus^n in
    float32 (ref: optimizer_BLS.py:144)."""
    return float(np.float32(cfg.bls_beta_minus)
                 ** np.float32(cfg.max_bls_iteration))


def _ladder_search(cfg: PlannerConfig, basis, scns, penalty, alpha, n_grad,
                   alpha_norm, loss, bls_lr, order):
    """All rungs in one batched evaluation; returns (alpha', bls_lr',
    new_loss, base_loss, trials), each per lane."""
    n = cfg.max_bls_iteration
    B = alpha.shape[0]
    ladder = bls_lr[:, None] * _rungs(cfg, alpha.device)[None]     # (B, n)
    cand = _trial(cfg, alpha[:, None], n_grad[:, None], ladder)   # (B,n,T,J)
    # The baseline, alpha itself, through the same evaluation.
    cand = torch.cat([cand, alpha[:, None]], dim=1)               # (B,n+1,..)
    rung_scns = Scenario(*(x[:, None] for x in scns))
    rung_pen = Penalty(*(lanes_of(p, 1) for p in penalty))
    cand_loss = total_cost(cfg, basis, rung_scns, rung_pen, cand,
                           order)                              # (B, n+1)
    base_loss = cand_loss[:, n]
    required = base_loss[:, None] - cfg.bls_alpha * ladder * alpha_norm[:, None]
    ok = cand_loss[:, :n] <= required
    any_ok = ok.any(1)
    j = ok.to(torch.uint8).argmax(1)            # the first passing rung
    lane = torch.arange(B, device=alpha.device)
    new_alpha = freeze_leading(any_ok, cand[lane, j], alpha)
    new_loss = torch.where(any_ok, cand_loss[lane, j], base_loss)
    new_lr = torch.where(any_ok, ladder[lane, j] * cfg.bls_beta_plus,
                         bls_lr * _exhausted_factor(cfg))
    trials = torch.where(any_ok, j, n).to(torch.int32)
    return new_alpha, new_lr, new_loss, base_loss, trials


class _BlsState(NamedTuple):
    obtained: torch.Tensor    # (B,) bool
    bls_iter: torch.Tensor    # (B,) int32
    bls_lr: torch.Tensor      # (B,)
    alpha: torch.Tensor       # (B, T, J)
    loss: torch.Tensor        # (B,)


def _sequential_search(cfg: PlannerConfig, basis, scns, penalty, alpha,
                       n_grad, alpha_norm, loss, bls_lr, order):
    """The reference's backtracking loop (ref: optimizer_BLS.py:130-150),
    one trial cost per iteration for every lane still searching; accepted
    AND exhausted lanes freeze (without the exhaustion term a lane past
    max_bls_iteration rejects would keep shrinking lr and could accept a
    step its search alone never tries)."""
    B = alpha.shape[0]
    s = _BlsState(
        obtained=torch.zeros(B, dtype=torch.bool, device=alpha.device),
        bls_iter=torch.zeros(B, dtype=torch.int32, device=alpha.device),
        bls_lr=bls_lr, alpha=alpha, loss=loss,
    )
    while True:
        done = s.obtained | (s.bls_iter >= cfg.max_bls_iteration)
        if bool(done.all()):
            break
        new_alpha = _trial(cfg, s.alpha, n_grad, s.bls_lr)
        new_loss = total_cost(cfg, basis, scns, penalty, new_alpha, order)
        required = loss - cfg.bls_alpha * s.bls_lr * alpha_norm
        reject = new_loss > required
        new = _BlsState(
            obtained=~reject,
            bls_iter=torch.where(reject, s.bls_iter + 1, s.bls_iter),
            bls_lr=torch.where(reject, s.bls_lr * cfg.bls_beta_minus,
                               s.bls_lr * cfg.bls_beta_plus),
            alpha=freeze_leading(reject, s.alpha, new_alpha),
            loss=torch.where(reject, s.loss, new_loss),
        )
        s = freeze_leading(done, s, new)
    return s.alpha, s.bls_lr, s.loss, loss, s.bls_iter


class _InnerState(NamedTuple):
    minimized: torch.Tensor   # (B,) bool
    inner_iter: torch.Tensor  # (B,) int32
    alpha: torch.Tensor       # (B, T, J)
    bls_lr: torch.Tensor      # (B,)
    loss: torch.Tensor        # (B,), at alpha
    grad: torch.Tensor        # (B, T, J), at alpha


def make_inner(cfg: PlannerConfig, basis: Basis, scns: Scenario,
               order: str):
    """The BLS inner minimizer of a batch of scenes (leading batch), in
    common.run_dual_loop's factory form, with the search of
    ``cfg.bls_mode`` and the basis products rounded as ``order`` says
    (models/rkhs.py ``PRODUCTS``)."""
    search = _ladder_search if cfg.bls_mode == "ladder" else _sequential_search
    dev = basis.kv.device

    def for_outer(outer_iter, round_idx=None):
        bound = inner_loop_bound(cfg, round_idx)

        def inner(alpha, penalty: Penalty):
            def step(s: _InnerState) -> _InnerState:
                gnorm = torch.linalg.norm(s.grad, dim=(-2, -1))
                n_grad = s.grad / lanes_of(gnorm, 2)
                # The reference's quirk: the sum over ALL (J, J) entries.
                alpha_norm = (s.grad.transpose(-1, -2).contiguous()
                              @ n_grad).sum((-2, -1))
                new_alpha, new_lr, new_loss, base_loss, _ = search(
                    cfg, basis, scns, penalty, s.alpha, n_grad, alpha_norm,
                    s.loss, s.bls_lr, order)
                # Stop when the whole search could not lower the loss by the
                # threshold (ref: optimizer_BLS.py:172-178), measured from
                # the search's own evaluation of the iterate.
                stop = base_loss - new_loss < cfg.loop_loss_reduction
                next_loss, next_grad = cost_and_grad(cfg, basis, scns,
                                                     penalty, new_alpha, order)
                return _InnerState(
                    minimized=stop,
                    inner_iter=torch.where(stop, s.inner_iter,
                                           s.inner_iter + 1),
                    alpha=new_alpha,
                    bls_lr=new_lr,
                    loss=torch.where(stop, new_loss, next_loss),
                    grad=freeze_leading(stop, s.grad, next_grad),
                )

            loss0, grad0 = cost_and_grad(cfg, basis, scns, penalty, alpha,
                                         order)
            B = alpha.shape[0]
            s = _InnerState(
                minimized=torch.zeros(B, dtype=torch.bool, device=dev),
                inner_iter=torch.zeros(B, dtype=torch.int32, device=dev),
                alpha=alpha,
                bls_lr=torch.full((B,), cfg.bls_lr_start, dtype=torch.float32,
                                  device=dev),
                loss=loss0, grad=grad0,
            )
            s = run_inner_loop(cfg, s, bound, step, freeze=freeze_leading)
            return s.alpha, s.inner_iter, s.loss

        return inner

    return for_outer


def solve_batch(cfg: PlannerConfig, basis: Basis, scns: Scenario,
                alpha0: Optional[torch.Tensor] = None) -> SolveResult:
    """BLS on every lane of ``scns`` (leading batch); alpha0 (B, T, J) or the
    smoothstep fit; the basis products in XLA's order (models/xla_order.py),
    the JAX package's single-scene solve's."""
    return solve_lanes(cfg, basis, scns, alpha0, make_inner)


def solve(cfg: PlannerConfig, basis: Basis, scn: Scenario,
          alpha0: Optional[torch.Tensor] = None) -> SolveResult:
    """The full BLS solve of one scene: the smoothstep warm start (or
    ``alpha0`` (T, J)) and the penalty-method dual loop (ref:
    optimizer_BLS.py:57-62)."""
    return solve_one(cfg, basis, scn, alpha0, make_inner)
