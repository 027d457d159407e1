"""Heterogeneous-fleet (random-scene) lane-compaction experiments through
K2, one penalty round per launch (the port of benchmarks/hetero.py).

Drives K2 (ops/fused_solve.py ``fused_round``) one round at a time, with
the rounds driver's bookkeeping between launches (solvers/fleet.py
``after_round``), so that each round's sort and launch can be timed apart
(CUDA events) beside its live lanes and live tiles:

* ``none``: no re-sort (the whole-solve kernel's lane order);
* ``steps``: one re-sort before round 1 by round 0's accepted steps,
  fulfilled lanes last;
* ``steps_loss``: the same with round 0's loss as the tie-break within
  equal step counts: fleet.compaction_order, the SHIPPED
  ``cfg.lane_compaction`` policy of the port and of the JAX package's fleet
  driver (its solvers/fleet.py:618-624).  The JAX script's docstring calls
  ``steps`` the shipped policy; that is stale;
* ``oracle``: the fleet presorted by each lane's total accepted steps from
  an untimed run of ``none``, then ``none`` timed: the bound a causal
  policy can approach;
* ``--shrink``: also re-partition the lanes every round, live lanes first,
  and launch K2 over the live prefix only.  The port's kernels take any
  batch, so the prefix is rounded up to whole CTAs (``--block-b`` lanes
  each, 0: 16), not to a fixed multiple.

Per-lane results do not depend on the policy (every operation along the
lane axis is per lane): each lane gets its own result, bit for bit, in
another order.

    python -m irm_motion_planning_tpu_torch.benchmarks.hetero \\
        [--batch 524288] [--policies none,steps,steps_loss] [--shrink] \\
        [--repeats 3] [--rounds-detail] [--device cuda|cpu]

One JSON line per policy (stdout: solves/s, the fulfilled fraction, the
card's name and power limit) and with ``--rounds-detail`` one per round of
the best run (stderr: launched lanes, sort and round milliseconds, the
fulfilled fraction, live and all tiles).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import torch

from .. import PlannerConfig, REFERENCE_INNER_SCHEDULE_BLS, make_basis
from ..ops import fused_solve as fs
from ..ops.scenario import random_scenarios
from ..solvers import fleet
from ..solvers.common import SolveResult
from . import _harness

POLICIES = ("none", "steps", "steps_loss", "oracle")


class PolicyRun(NamedTuple):
    elapsed_s: float      # the solve's wall time, ended by a synchronize
    rounds: list          # per-round dicts (time_rounds), else empty
    ful_frac: float       # the fulfilled fraction at the end
    tot_steps: torch.Tensor  # (B,) accepted steps, in the ORIGINAL order
    result: SolveResult   # the solve, in the original lane order


def hetero_config(block_b: int = 0) -> PlannerConfig:
    """benchmarks/hetero.py's config: the bench's BLS schedule, 11 obstacle
    slots; ``block_b`` K2's lanes per CTA."""
    sched = REFERENCE_INNER_SCHEDULE_BLS
    return PlannerConfig(bls_mode="ladder", fixed_iters=True,
                         inner_schedule=sched, max_inner_iteration=max(sched),
                         max_obstacles=11, pallas_block_b=block_b)


class _RoundMarks:
    """Three marks per round (start, sorted, launched): CUDA events on the
    card, the host clock on the CPU."""

    def __init__(self, dev):
        self.events = ([torch.cuda.Event(enable_timing=True)
                        for _ in range(3)] if dev.type == "cuda" else None)
        self.host = [0.0] * 3

    def mark(self, i: int) -> None:
        if self.events is None:
            self.host[i] = time.perf_counter()
        else:
            self.events[i].record()

    def split_ms(self) -> tuple:
        """(sort ms, round ms), after a synchronize."""
        if self.events is None:
            h = self.host
            return 1e3 * (h[1] - h[0]), 1e3 * (h[2] - h[1])
        e = self.events
        return e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])


def run_policy(cfg: PlannerConfig, basis, fsc, a0k, sched, block_b: int,
               policy: str, shrink: bool, solver: str = "bls",
               time_rounds: bool = False) -> PolicyRun:
    """One full dual solve through K2, one launch per round of ``sched``,
    under ``policy`` (``none``, ``steps``, ``steps_loss``; ``oracle`` is
    ``none`` on a presorted fleet, see :func:`main`), with ``shrink``.
    ``fsc``: lane-trailing scenes (fleet.to_fleet); ``a0k``: the warm start
    (J, T, B); ``block_b``: K2's lanes per CTA.  ``time_rounds``: time each
    round's sort and launch (CUDA events; a host read of the fulfilled
    flags per round)."""
    if policy not in ("none", "steps", "steps_loss"):
        raise ValueError(f"run_policy: unknown policy {policy!r}")
    cfg = cfg.replace(pallas_block_b=block_b)
    tile = fs.warps_per_cta(cfg)
    B = a0k.shape[-1]
    dev = a0k.device
    kv = basis.kv
    kvt = fs.memo("kvt", lambda m: m.T.contiguous(), kv)
    s = fleet.start_rounds(
        a0k, torch.full((1, B), cfg.lambda_sg_constraint, device=dev),
        torch.full((1, B), cfg.lambda_jl_constraint, device=dev))
    lanes = tuple(x.contiguous() for x in (
        fsc.start, fsc.goal, fsc.obstacles[:, 0], fsc.obstacles[:, 1],
        fsc.obstacle_weight))
    perm = torch.arange(B, device=dev)   # lane i holds original lane perm[i]
    last_steps = s.ful[0]
    rounds = []
    marks = _RoundMarks(dev)
    t_start = time.perf_counter()
    for r, n_r in enumerate(sched):
        if time_rounds:
            marks.mark(0)
        order = None
        if policy != "none" and r == 1:
            if policy == "steps_loss":
                order = fleet.compaction_order(s.ful, s.floss, last_steps)
            else:
                key = torch.where(s.ful[0] > 0.5, float("inf"), last_steps)
                order = torch.argsort(key, stable=True)
        if order is not None:
            s = fleet.Rounds(*fleet.take_lanes(order, *s))
            lanes = fleet.take_lanes(order, *lanes)
            perm, last_steps = fleet.take_lanes(order, perm, last_steps)
        br = B
        if shrink and r >= 1:
            # Live lanes first (a stable sort), every round; K2 runs the
            # live prefix, rounded up to whole CTAs.
            order = torch.argsort(s.ful[0], stable=True)
            s = fleet.Rounds(*fleet.take_lanes(order, *s))
            lanes = fleet.take_lanes(order, *lanes)
            perm, last_steps = fleet.take_lanes(order, perm, last_steps)
            n_live = int((s.ful[0] < 0.5).sum())
            br = min(B, max(tile, -(-n_live // tile) * tile))
        if time_rounds:
            marks.mark(1)
        head = fleet.Rounds(*(x[..., :br] for x in s)) if br < B else s
        lr0 = torch.full((1, br), fs.round_lr(cfg, r, solver),
                         dtype=torch.float32, device=dev)
        out = fs.fused_round(cfg, kv, kvt, basis.mix, head.alpha, head.lam_sg,
                             head.lam_jl, head.ful, lr0, int(n_r),
                             *(x[..., :br].contiguous() for x in lanes),
                             solver=solver)
        if br < B:
            # The lanes past the prefix are fulfilled: K2 would pass them
            # through (alpha unchanged, loss 0, ok 1, no steps).
            rest = B - br
            pad = torch.zeros((1, rest), device=dev)
            out = fs.FusedRound(
                torch.cat([out.alpha, s.alpha[..., br:]], dim=-1),
                torch.cat([out.loss, pad], dim=-1),
                torch.cat([out.ok, pad + 1.0], dim=-1),
                torch.cat([out.inner, pad], dim=-1))
        s = fleet.after_round(cfg, s, out)
        last_steps = out.inner[0]
        if time_rounds:
            marks.mark(2)
            ful = s.ful[0].cpu()          # synchronizes
            t_sort, t_round = marks.split_ms()
            pad = -B % tile
            tiles = torch.cat([ful, torch.ones(pad)]).reshape(-1, tile)
            rounds.append({
                "r": r, "n_r": int(n_r), "launched": int(br),
                "t_sort_ms": round(t_sort, 3),
                "t_round_ms": round(t_round, 3),
                "ful_frac": round(float(ful.mean()), 4),
                "live_tiles": int((tiles.min(dim=1).values < 0.5).sum()),
                "tiles": int(tiles.shape[0]),
            })
    _harness.sync(dev)
    elapsed = time.perf_counter() - t_start
    inv = torch.argsort(perm)
    return PolicyRun(elapsed, rounds, float(s.ful.mean()),
                     s.total_inner[0].index_select(0, inv),
                     fleet.rounds_result(s, perm))


def presorted(fsc, a0k, order):
    """The scenes and warm start with their lanes in ``order``."""
    return (type(fsc)(*fleet.take_lanes(order, *fsc)),
            a0k.index_select(-1, order))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=524288)
    p.add_argument("--block-b", type=int, default=0,
                   help="K2's lanes per CTA, 1-16 (0: 16)")
    p.add_argument("--policies", default="none,steps,steps_loss")
    p.add_argument("--shrink", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--rounds-detail", action="store_true",
                   help="per-round decomposition (a host read per round)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for row, detail in run(args):
        print(json.dumps(row), flush=True)
        for d in detail:
            print(json.dumps(d), file=sys.stderr, flush=True)
    return 0


def run(args):
    """Yield (row, per-round rows) per policy of ``args`` (main's flags)."""
    dev = _harness.open_device(args.device, "hetero")
    cfg = hetero_config(args.block_b)
    sched = cfg.inner_schedule
    basis = make_basis(cfg, device=dev)
    scns = random_scenarios(cfg, torch.Generator().manual_seed(args.seed),
                            args.batch, device=dev)
    fsc = fleet.to_fleet(scns)
    a0k = fleet.fleet_init_alpha(cfg, basis, fsc).movedim(1, 0).contiguous()
    card = _harness.card(dev)
    for policy in args.policies.split(","):
        if policy not in POLICIES:
            raise ValueError(f"hetero: unknown policy {policy!r}")
        run_fsc, run_a0k, run_pol = fsc, a0k, policy
        if policy == "oracle":
            # The discovery run never shrinks: its steps come back in the
            # original order either way, and the work per lane is the same.
            tot = run_policy(cfg, basis, fsc, a0k, sched, args.block_b,
                             "none", shrink=False).tot_steps
            run_fsc, run_a0k = presorted(fsc, a0k,
                                         torch.argsort(tot, stable=True))
            run_pol = "none"
        run_policy(cfg, basis, run_fsc, run_a0k, sched, args.block_b,
                   run_pol, args.shrink)           # warm-up
        best = None
        for _ in range(args.repeats):
            got = run_policy(cfg, basis, run_fsc, run_a0k, sched,
                             args.block_b, run_pol, args.shrink,
                             time_rounds=args.rounds_detail)
            if best is None or got.elapsed_s < best.elapsed_s:
                best = got
        yield ({
            "policy": policy, "shrink": bool(args.shrink),
            "batch": args.batch,
            "block_b": fs.warps_per_cta(cfg),
            "solves_per_sec": round(args.batch / best.elapsed_s, 1),
            "ful_frac": round(best.ful_frac, 4),
            **card,
        }, best.rounds)


if __name__ == "__main__":
    sys.exit(main())
