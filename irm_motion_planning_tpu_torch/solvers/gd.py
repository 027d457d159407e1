"""Gradient descent with a per-round learning-rate schedule, one scene or a
batch of them lane by lane (counterpart of
irm_motion_planning_tpu/solvers/gd.py; the batched form is solvers/lanes.py's).

The reference's dual optimize (ref: optimizer_GD.py:172-232): an inner
descent loop with the loss-reduction stop, inside the penalty loop with the
constraint check and the escalation of lambda.  Loss and gradient come from
one fused forward pass per step (ops/costs.cost_and_grad), and the state
carries them at the current iterate.

Update (ref: optimizer_GD.py:185): ``alpha' = (1 - lambda_reg lr) alpha -
lr grad``, formed with one rounding (fused_solve.fma) as XLA forms it.
Stop (ref: optimizer_GD.py:188-194): when ``last_loss - new_loss <
loop_loss_reduction``, REJECTING the trial step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import PlannerConfig
from ..models.rkhs import Basis
from ..ops import fused_solve as fs
from ..ops.costs import Penalty, cost_and_grad
from ..ops.scenario import Scenario
from .common import SolveResult, freeze_leading, inner_loop_bound, run_inner_loop
from .lanes import lanes_of, solve_lanes, solve_one


class _InnerState(NamedTuple):
    minimized: torch.Tensor   # (B,) bool
    inner_iter: torch.Tensor  # (B,) int32
    alpha: torch.Tensor       # (B, T, J)
    loss: torch.Tensor        # (B,), at alpha
    grad: torch.Tensor        # (B, T, J), at alpha


def make_inner(cfg: PlannerConfig, basis: Basis, scns: Scenario,
               order: str):
    """The GD inner minimizer of a batch of scenes (leading batch), in
    common.run_dual_loop's factory form, the basis products rounded as
    ``order`` says (models/rkhs.py ``PRODUCTS``).  The learning rate is per lane,
    ``gd_lr[outer_iter]`` (ref: optimizer_GD.py:209), clipped to the
    schedule for lanes already frozen; minimized and budget-exhausted lanes
    freeze (without the exhaustion term a capped lane would take steps it
    never gets alone)."""
    dev = basis.kv.device
    lr_schedule = torch.tensor(cfg.gd_lr, dtype=torch.float32, device=dev)
    last = len(cfg.gd_lr) - 1

    def for_outer(outer_iter, round_idx=None):
        lr = lanes_of(lr_schedule[torch.clip(outer_iter, 0, last).long()], 2)
        bound = inner_loop_bound(cfg, round_idx)

        def inner(alpha, penalty: Penalty):
            def step(s: _InnerState) -> _InnerState:
                new_alpha = fs.fma(1.0 - cfg.lambda_reg * lr, s.alpha,
                                   -(lr * s.grad))
                new_loss, new_grad = cost_and_grad(cfg, basis, scns, penalty,
                                                   new_alpha, order)
                stop = s.loss - new_loss < cfg.loop_loss_reduction
                return _InnerState(
                    minimized=stop,
                    inner_iter=torch.where(stop, s.inner_iter,
                                           s.inner_iter + 1),
                    alpha=freeze_leading(stop, s.alpha, new_alpha),
                    loss=torch.where(stop, s.loss, new_loss),
                    grad=freeze_leading(stop, s.grad, new_grad),
                )

            loss0, grad0 = cost_and_grad(cfg, basis, scns, penalty, alpha,
                                         order)
            B = alpha.shape[0]
            s = _InnerState(
                minimized=torch.zeros(B, dtype=torch.bool, device=dev),
                inner_iter=torch.zeros(B, dtype=torch.int32, device=dev),
                alpha=alpha, loss=loss0, grad=grad0,
            )
            s = run_inner_loop(cfg, s, bound, step, freeze=freeze_leading)
            return s.alpha, s.inner_iter, s.loss

        return inner

    return for_outer


def solve_batch(cfg: PlannerConfig, basis: Basis, scns: Scenario,
                alpha0: Optional[torch.Tensor] = None) -> SolveResult:
    """GD on every lane of ``scns`` (leading batch); alpha0 (B, T, J) or the
    smoothstep fit; the basis products in XLA's order (models/xla_order.py),
    the JAX package's single-scene solve's."""
    return solve_lanes(cfg, basis, scns, alpha0, make_inner)


def solve(cfg: PlannerConfig, basis: Basis, scn: Scenario,
          alpha0: Optional[torch.Tensor] = None) -> SolveResult:
    """The full GD solve of one scene: the smoothstep warm start (or
    ``alpha0`` (T, J)) and the penalty-method dual loop (ref:
    optimizer_GD.py:54-65)."""
    return solve_one(cfg, basis, scn, alpha0, make_inner)
