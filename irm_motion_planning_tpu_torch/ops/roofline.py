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

Where a kernel streams the basis (T past the resident plans: the streamed
body of K1/K2 and of K3-K5; K6 always), the bound stays the function's:
its inputs read once, the basis among them, and its operations.  What the
design streams beside that is a diagnostic, ``Bound.l2_bytes`` and
``Bound.design_l2_ms``: the basis (8 T^2 bytes per product) fits in the 50
MB L2 up to T = 2,500, so it comes from L2, not HBM; the streamed body
reads it once per basis product per tile of lanes (K7: a CTA's lanes run
in lockstep and share each product's stream, so the reads per lane fall by
the lanes per CTA; counted here from the lanes' products, the fewest the
tiles can run), K6 once per tile of 64 lanes.  The resident body stages
the basis once per CTA (none counted).  Those reads are a cost of the
design, not of the function, so they do not enter ``ms`` or ``by``.

Rates: the published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s
of HBM3, 67 TFLOP/s fp32 outside the tensor cores (TF32 is not used).  The
L2 rate of the diagnostic is measured, not published: chip_smoke.py (phase
17, the K7 line's ``l2_bytes_per_s``) reads an L2-resident 16 MiB buffer two
ways, timed with CUDA events: torch's copy of it into a second buffer, 200
copies replayed from one CUDA graph (read and write counted: 4.594 TB/s),
and one torch reduction over an expanded view that reads it 64 times
(10.076 TB/s; the SMs may share some of those reads in L1).
L2_BYTES_PER_S is the larger, so the design's L2 time stays a lower bound
of what its reads cost: NVIDIA H100 80GB HBM3, 700.00 W (my chip run, PR 7;
PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

from .fused_solve import TIER_PROGRAMS
from .step_kernels import K6_LANES

BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_BYTES_PER_S = 10.076e12
F32 = 4


class Bound(NamedTuple):
    bytes: float
    ops: float
    l2_bytes: float = 0.0   # the basis bytes a streamed design reads from L2

    @property
    def ms(self) -> float:
        """The function's bound: its bytes over HBM's rate or its
        operations over the fp32 rate, the larger."""
        return 1e3 * max(self.bytes / BYTES_PER_S, self.ops / FP32_OPS_PER_S)

    @property
    def by(self) -> str:
        return ("bytes" if self.bytes / BYTES_PER_S >= self.ops / FP32_OPS_PER_S
                else "operations")

    @property
    def design_l2_ms(self) -> float:
        """The design's basis reads over the L2 rate: a diagnostic, not
        part of the bound."""
        return 1e3 * self.l2_bytes / L2_BYTES_PER_S

    def __add__(self, other: "Bound") -> "Bound":
        return Bound(self.bytes + other.bytes, self.ops + other.ops,
                     self.l2_bytes + other.l2_bytes)


class LaneOps(NamedTuple):
    """Operations per lane of the pieces of a lane's work at T timesteps, J
    joints and O obstacle slots.  K1-K5 run them as the warp body
    (csrc/warp_body.cuh, one warp per lane), K6 as a tiled product; all run
    the same op sequence, so the counts serve each."""

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


def product_bytes(T: int) -> float:
    """The bytes of one basis product's operand: kv (2T, T) or kvt (T, 2T)."""
    return 2 * T * T * F32


def _streamed(products: float, T: int, streamed: bool,
              lanes_per_cta: int) -> float:
    """The streamed body's L2 bytes (the design's diagnostic): ``products``
    per-lane basis products, each read once per tile of ``lanes_per_cta``
    lanes (K7); none in the resident body, which stages the basis."""
    return products * product_bytes(T) / lanes_per_cta if streamed else 0.0


def forward_eval(B: int, T: int, J: int) -> Bound:
    """K6: alpha in, (traj, vel) out; the design reads the basis once per
    tile of K6_LANES lanes (step_kernels.forward_plan)."""
    b = _lane_bytes(T, J, 0)
    return Bound(B * 3 * b["plane"] + (2 * T * T + J * J) * F32,
                 B * LaneOps.at(T, J, 0).forward,
                 -(-B // K6_LANES) * product_bytes(T))


def cost_grad_eval(B: int, T: int, J: int, O: int, streamed: bool = False,
                   lanes_per_cta: int = 1) -> Bound:
    """K5: alpha, penalties and the scene in; loss, grad, traj, vel out.
    ``streamed``: the warp body streams the basis (a forward and a
    pull-back per lane), once per product and tile of ``lanes_per_cta``
    lanes."""
    b, n = _lane_bytes(T, J, O), LaneOps.at(T, J, O)
    per_lane = b["plane"] + 2 * b["scalar"] + b["scene"] + 3 * b["plane"] + F32
    return Bound(B * per_lane + _basis_bytes(T, J),
                 B * (n.forward + n.cost + n.loss + n.grad),
                 _streamed(2 * B, T, streamed, lanes_per_cta))


def _bls_ops(n: LaneOps, ladder_eval: str) -> tuple:
    """(a step's fixed part, a rung) of BLS in the ladder tier, each with
    its 4 Armijo and stop operations."""
    if ladder_eval == "exact":
        return n.step_exact + 4, n.rung_exact + 4
    return n.step + 4, n.rung + 4


def bls_inner_step(B: int, T: int, J: int, O: int, tally: dict,
                   ladder_eval: str = "linearized", streamed: bool = False,
                   lanes_per_cta: int = 1) -> Bound:
    """K3 in place, from the plain version's tally on the same inputs (the
    kernel returns no rung count): every lane reads its frozen flag; a live
    lane reads the four state planes, loss, lr, penalties and scene and
    writes the state back; the steps that do not stop pay the pull-back
    with the loss.  Exact ladder: each rung evaluates its candidate through
    the basis, and the accepted rung's evaluation is the new iterate's (no
    further forward: the step without a passing rung, which re-evaluates,
    is not counted).  ``streamed``: as :func:`cost_grad_eval`'s, for the
    step's products (the direction's forward or the exact rungs', and the
    pull-back)."""
    b, n = _lane_bytes(T, J, O), LaneOps.at(T, J, O)
    steps, rungs, pulls = (_total(tally[k]) for k in
                           ("steps", "rungs", "pullbacks"))
    live_in = 4 * b["plane"] + 4 * b["scalar"] + b["scene"]
    live_out = 3 * b["plane"] + 3 * b["scalar"]
    byts = (B * F32 + steps * (live_in + live_out) + pulls * b["plane"]
            + _basis_bytes(T, J))
    step, rung = _bls_ops(n, ladder_eval)
    ops = steps * step + rungs * rung + pulls * (n.cost + n.loss + n.grad)
    products = (rungs if ladder_eval == "exact" else steps) + pulls
    return Bound(byts, ops, _streamed(products, T, streamed, lanes_per_cta))


def gd_inner_step(B: int, T: int, J: int, O: int, tally: dict,
                  streamed: bool = False, lanes_per_cta: int = 1) -> Bound:
    """K4 in place, from the plain version's tally: a live lane reads alpha,
    grad, loss, lr, penalties and scene and evaluates the trial; an accepted
    trial writes alpha, grad, traj, vel and loss and pays the pull-back; a
    stop writes the flag.  ``streamed``: the warp body streams the basis,
    once per product and tile of ``lanes_per_cta`` lanes (K1's streamed
    body, K7)."""
    b, n = _lane_bytes(T, J, O), LaneOps.at(T, J, O)
    steps, acc = _total(tally["steps"]), _total(tally["accepted"])
    live_in = 2 * b["plane"] + 4 * b["scalar"] + b["scene"]
    byts = (B * F32 + steps * live_in + acc * (4 * b["plane"] + F32)
            + (steps - acc) * F32 + _basis_bytes(T, J))
    ops = steps * (n.trial + n.forward + n.cost + n.loss) + acc * n.grad
    return Bound(byts, ops, _streamed(steps + acc, T, streamed, lanes_per_cta))


def fused_products(B: int, tally: dict, whole_solve: bool,
                   solver: str = "bls",
                   ladder_eval: str = "linearized", prog: str = "") -> float:
    """The basis products (forward evaluations and pull-backs) of K1
    (``whole_solve``) or K2's rounds, summed over the lanes, from the same
    work counts as :func:`fused_rounds`: a round-start forward once per
    lane (K1) or per round (K2) and a pull-back per round; GD a forward per
    step and a pull-back per accepted step; BLS a pull-back per step that
    does not stop and, linearized, a direction forward per step (the ultra
    and bf16 programs ``prog`` a step-start forward too) and the
    end-of-round forward, exact, a forward per rung (a step without a
    passing rung, which re-evaluates, is not counted)."""
    rounds = _total(tally["rounds"])
    n = (B if whole_solve else rounds) + rounds
    if solver == "gd":
        return n + _total(tally["steps"]) + _total(tally["accepted"])
    n += _total(tally["pullbacks"])
    if ladder_eval == "exact":
        return n + _total(tally["rungs"])
    steps = _total(tally["steps"])
    return (n + rounds + steps
            + (steps if prog in TIER_PROGRAMS else 0))


def fused_rounds(B: int, T: int, J: int, O: int, tally: dict,
                 whole_solve: bool, solver: str = "bls",
                 ladder_eval: str = "linearized",
                 streamed: bool = False, prog: str = "",
                 lanes_per_cta: int = 1) -> Bound:
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
    counted).  The linearized ladder's kernel tiers (``prog``, a program
    of fused_solve.TIER_PROGRAMS): ultra recomputes the loss in the
    pull-back's cost pass and evaluates alpha exactly at each step's start
    (J basis products, a forward); bf16 also evaluates the baseline, the
    zero-lr candidate, as a rung.  Its half-width ladder planes live in
    shared memory, so the function's bytes do not change.

    GD (rounds, steps, accepted): no re-evaluation (the carried evaluation
    is exact); each step the trial, its forward and its cost pass with the
    loss; each accepted step the pull-back.

    ``streamed`` (the streamed body): ``l2_bytes``, the design's
    diagnostic, holds every basis product (:func:`fused_products`) reading
    the basis from L2 once per tile of ``lanes_per_cta`` lanes (K7, the
    launch plan's "lanes")."""
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
        recompute = exact or prog in TIER_PROGRAMS
        ops += ((0 if exact else rounds * n.forward)
                + steps * step + rungs * rung
                + pulls * (n.cost + n.grad + (n.loss if recompute else 0)))
        if prog in TIER_PROGRAMS:
            ops += steps * n.forward
        if prog == "bls_bf16":
            ops += steps * rung
    l2 = (fused_products(B, tally, whole_solve, solver, ladder_eval, prog)
          * product_bytes(T) / lanes_per_cta if streamed else 0.0)
    return Bound(B * per_lane + _basis_bytes(T, J), ops, l2)


def fused_round_launches(B: int, T: int, J: int, O: int, tally: dict,
                         live, solver: str = "bls",
                         ladder_eval: str = "linearized",
                         streamed: bool = False, prog: str = "",
                         lanes_per_cta: int = 1) -> Bound:
    """K2 over a whole solve, one launch per round, from the solve's work
    counts (as :func:`fused_rounds` for K2: the rounds driver runs K1's
    work, each round starting from alpha) and
    ``live``, the lanes each launch runs: every launch reads every lane's
    fulfilled flag and writes its three per-lane results; a live lane also
    reads alpha, its penalties, its learning rate and its scene and writes
    alpha; each launch reads the basis."""
    b = _lane_bytes(T, J, O)
    rounds = fused_rounds(B, T, J, O, tally, False, solver, ladder_eval,
                          streamed, prog, lanes_per_cta)
    byts = sum(B * 4 * b["scalar"] + n * (2 * b["plane"] + 3 * b["scalar"]
                                          + b["scene"]) + _basis_bytes(T, J)
               for n in live)
    return Bound(byts, rounds.ops, rounds.l2_bytes)


def plain_tally(ref, *args, **kw) -> dict:
    """The work tally (fused_solve.count_work) of the plain version ``ref``
    on ``args``, from a call of its own, so that no timed call keeps it."""
    tally = {}
    ref(*args, tally=tally, **kw)
    return tally


def kernel_counts(tally: dict, rounds: float, accepted: float,
                  solver: str = "bls") -> dict:
    """A whole-solve or round kernel's work counts for its bound: the rounds
    its lanes ran and the steps it accepted (each pays a pull-back) from the
    kernel's own outputs; the stop steps (BLS: and the ladder rungs) from
    the plain version's tally on the same inputs."""
    if solver == "gd":
        stops = float((tally["steps"] - tally["accepted"]).sum())
        return {"rounds": rounds, "steps": accepted + stops,
                "accepted": accepted}
    stops = float((tally["steps"] - tally["pullbacks"]).sum())
    return {"rounds": rounds, "steps": accepted + stops,
            "rungs": float(tally["rungs"].sum()), "pullbacks": accepted}
