"""The least time an H100 could take for each kernel's work: its bound.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate,
and the operations it does on these inputs over the card's fp32 rate.
Where the work depends on the data (early exits, the ladder's rung count,
frozen lanes), the counts are what this run's data needs: the kernels'
own counts where they return them (rounds run, accepted steps) and the
plain versions' tallies of the rest (stop steps, ladder rungs) on the same
inputs (fused_solve.count_work).  A tally entry is a per-lane count tensor
or a number already summed over the lanes.

Operations are counted from the kernels' arithmetic per lane, a fused
multiply-add as two.  Each sine, cosine, division and square root counts
as ONE operation, and compares, selects and address arithmetic are not
counted, so the operation side is a lower bound as the byte side is.

Rates: the published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s
of HBM3, 67 TFLOP/s fp32 outside the tensor cores (TF32 is not used).
"""

from __future__ import annotations

from typing import NamedTuple

BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4


class Bound(NamedTuple):
    bytes: float
    ops: float

    @property
    def ms(self) -> float:
        return 1e3 * max(self.bytes / BYTES_PER_S, self.ops / FP32_OPS_PER_S)

    @property
    def by(self) -> str:
        return ("bytes" if self.bytes / BYTES_PER_S >= self.ops / FP32_OPS_PER_S
                else "operations")

    def __add__(self, other: "Bound") -> "Bound":
        return Bound(self.bytes + other.bytes, self.ops + other.ops)


class LaneOps(NamedTuple):
    """Operations per lane of the pieces of a lane's work at T timesteps, J
    joints and O obstacle slots.  The per-step kernels K3-K6 run them as the
    lane body (csrc/lane_body.cuh, one thread per lane), the fused kernels
    K1/K2 as the warp body (csrc/warp_body.cuh, one warp per lane); both
    run the same op sequence, so the counts serve both."""

    forward: int      # forward_planes: kv products and the mix combine
    rung: int         # rung_cost: candidate, FK, obstacle field, cost sums
    rung_exact: int   # the exact ladder's rung: candidate alpha, its
    #                   forward, FK, obstacle field, cost sums
    cost: int         # cost_pass: FK, field and its gradient, cost sums
    loss: int         # cost_total: the penalized loss from the sums
    grad: int         # grad_pass: pass B and the kvt pull-back
    step: int         # bls_step without the rungs and the pull-back
    step_exact: int   # the same, exact ladder: no direction forward
    trial: int        # gd_step's trial (1 - lambda_reg lr) alpha - lr grad
    constraints: int  # constraints_ok

    @classmethod
    def at(cls, T: int, J: int, O: int) -> "LaneOps":
        fk = T * (7 * J - 3)              # angles, sin+cos, tangents, sums
        sums = T * (2 + 7 * J)            # cost_add
        loss = 16 * J + 8
        forward = 2 * (2 * T) * T * J + (2 * T) * J * (2 * J - 1)
        pull = 2 * T * (2 * T) * J + T * J * (2 * J - 1)
        field = fk + T * (4 + 8 * O) + sums + loss
        trial = 3 * J * T + 2
        # norm and alpha_norm, n_grad, the accepted update of alpha
        step_exact = 2 * J * T + 2 + T * (J + 2) + J * T + 4 * J * T
        return cls(
            forward=forward,
            rung=T * 4 * J + field,
            rung_exact=trial + forward + field,
            cost=fk + T * (4 + 14 * O + 4) + sums,
            loss=loss,
            grad=fk + T * (4 + 2 * J + 13 * J) + pull,
            # and the direction's forward and its hoist, the accepted update
            # of traj and vel
            step=step_exact + forward + 2 * (2 * T) * J + 4 * J * T,
            step_exact=step_exact,
            trial=trial,
            constraints=8 * J * T,
        )


def _total(x) -> float:
    """A tally entry: a per-lane count tensor, or a number already summed."""
    return float(x.sum()) if hasattr(x, "sum") else float(x)


def _lane_bytes(T: int, J: int, O: int) -> dict:
    plane = J * T * F32
    return dict(plane=plane, scene=(2 * J + 3 * O) * F32, scalar=F32)


def _basis_bytes(T: int, J: int) -> float:
    return (4 * T * T + J * J) * F32


def forward_eval(B: int, T: int, J: int) -> Bound:
    """K6: alpha in, (traj, vel) out."""
    b = _lane_bytes(T, J, 0)
    return Bound(B * 3 * b["plane"] + (2 * T * T + J * J) * F32,
                 B * LaneOps.at(T, J, 0).forward)


def cost_grad_eval(B: int, T: int, J: int, O: int) -> Bound:
    """K5: alpha, penalties and the scene in; loss, grad, traj, vel out."""
    b, n = _lane_bytes(T, J, O), LaneOps.at(T, J, O)
    per_lane = b["plane"] + 2 * b["scalar"] + b["scene"] + 3 * b["plane"] + F32
    return Bound(B * per_lane + _basis_bytes(T, J),
                 B * (n.forward + n.cost + n.loss + n.grad))


def _bls_ops(n: LaneOps, ladder_eval: str) -> tuple:
    """(a step's fixed part, a rung) of BLS in the ladder tier, each with
    its 4 Armijo and stop operations."""
    if ladder_eval == "exact":
        return n.step_exact + 4, n.rung_exact + 4
    return n.step + 4, n.rung + 4


def bls_inner_step(B: int, T: int, J: int, O: int, tally: dict,
                   ladder_eval: str = "linearized") -> Bound:
    """K3 in place, from the plain version's tally on the same inputs (the
    kernel returns no rung count): every lane reads its frozen flag; a live
    lane reads the four state planes, loss, lr, penalties and scene and
    writes the state back; the steps that do not stop pay the pull-back
    with the loss.  Exact ladder: each rung evaluates its candidate through
    the basis, and the accepted rung's evaluation is the new iterate's (no
    further forward: the step without a passing rung, which re-evaluates,
    is not counted)."""
    b, n = _lane_bytes(T, J, O), LaneOps.at(T, J, O)
    steps, rungs, pulls = (_total(tally[k]) for k in
                           ("steps", "rungs", "pullbacks"))
    live_in = 4 * b["plane"] + 4 * b["scalar"] + b["scene"]
    live_out = 3 * b["plane"] + 3 * b["scalar"]
    byts = (B * F32 + steps * (live_in + live_out) + pulls * b["plane"]
            + _basis_bytes(T, J))
    step, rung = _bls_ops(n, ladder_eval)
    ops = steps * step + rungs * rung + pulls * (n.cost + n.loss + n.grad)
    return Bound(byts, ops)


def gd_inner_step(B: int, T: int, J: int, O: int, tally: dict) -> Bound:
    """K4 in place, from the plain version's tally: a live lane reads alpha,
    grad, loss, lr, penalties and scene and evaluates the trial; an accepted
    trial writes alpha, grad, traj, vel and loss and pays the pull-back; a
    stop writes the flag."""
    b, n = _lane_bytes(T, J, O), LaneOps.at(T, J, O)
    steps, acc = _total(tally["steps"]), _total(tally["accepted"])
    live_in = 2 * b["plane"] + 4 * b["scalar"] + b["scene"]
    byts = (B * F32 + steps * live_in + acc * (4 * b["plane"] + F32)
            + (steps - acc) * F32 + _basis_bytes(T, J))
    ops = steps * (n.trial + n.forward + n.cost + n.loss) + acc * n.grad
    return Bound(byts, ops)


def fused_rounds(B: int, T: int, J: int, O: int, tally: dict,
                 whole_solve: bool, solver: str = "bls",
                 ladder_eval: str = "linearized") -> Bound:
    """K1 (``whole_solve``: all rounds) or K2 (one round) of ``solver``,
    from the work counts of the run: each lane reads alpha, its penalties
    and scene and writes alpha and its per-lane results (K1 four, K2 three).

    Each round a lane runs pays the round-start cost pass with the loss and
    its pull-back, and the constraint check.  The round-start forward is paid
    once per lane by K1, whose later rounds start from the previous round's
    end evaluation, and once per round by K2, which starts from alpha.

    BLS (rounds, steps, rungs, pull-backs): each step its fixed part, each
    rung its cost, each step that does not stop the pull-back.  Linearized
    ladder: the end-of-round re-evaluation, and the pull-back reuses the
    accepted rung's loss (the FK carry).  Exact ladder: no re-evaluation
    (the carried evaluation is exact), each rung's candidate through the
    basis, and the pull-back recomputes the loss at the accepted rung's
    evaluation (a step without a passing rung, which re-evaluates, is not
    counted).

    GD (rounds, steps, accepted): no re-evaluation (the carried evaluation
    is exact); each step the trial, its forward and its cost pass with the
    loss; each accepted step the pull-back."""
    b, n = _lane_bytes(T, J, O), LaneOps.at(T, J, O)
    n_out = 4 if whole_solve else 3
    per_lane = (2 * b["plane"] + 4 * b["scalar"] + b["scene"]
                + n_out * b["scalar"])
    rounds = _total(tally["rounds"])
    starts = B if whole_solve else rounds
    ops = (starts * n.forward
           + rounds * (n.cost + n.loss + n.grad + n.constraints))
    if solver == "gd":
        steps, acc = (_total(tally[k]) for k in ("steps", "accepted"))
        ops += (steps * (n.trial + n.forward + n.cost + n.loss)
                + acc * n.grad)
    else:
        steps, rungs, pulls = (_total(tally[k]) for k in
                               ("steps", "rungs", "pullbacks"))
        exact = ladder_eval == "exact"
        step, rung = _bls_ops(n, ladder_eval)
        ops += ((0 if exact else rounds * n.forward)
                + steps * step + rungs * rung
                + pulls * (n.cost + n.grad + (n.loss if exact else 0)))
    return Bound(B * per_lane + _basis_bytes(T, J), ops)


def fused_round_launches(B: int, T: int, J: int, O: int, tally: dict,
                         live, solver: str = "bls",
                         ladder_eval: str = "linearized") -> Bound:
    """K2 over a whole solve, one launch per round, from the solve's work
    counts (as :func:`fused_rounds` for K2: the rounds driver runs K1's
    work, each round starting from alpha) and
    ``live``, the lanes each launch runs: every launch reads every lane's
    fulfilled flag and writes its three per-lane results; a live lane also
    reads alpha, its penalties, its learning rate and its scene and writes
    alpha; each launch reads the basis."""
    b = _lane_bytes(T, J, O)
    ops = fused_rounds(B, T, J, O, tally, False, solver, ladder_eval).ops
    byts = sum(B * 4 * b["scalar"] + n * (2 * b["plane"] + 3 * b["scalar"]
                                          + b["scene"]) + _basis_bytes(T, J)
               for n in live)
    return Bound(byts, ops)
