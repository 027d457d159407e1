"""Roofline of the solver kernels on one H100 (the port of
benchmarks/roofline.py, re-based from the TPU v5e's units to the card's).

Counts the work of the fused cost/gradient evaluation K5 (ops/step_kernels
.py ``cost_grad_eval``: the body every solver step runs) per lane from the
port's own counts (ops/roofline.py: ``LaneOps``, ``cost_grad_eval``; no
second count here), times it at fleet width, and reports the achieved fp32
rate against the card's peak and against the kernel's bound; then times
the whole fused solve (K1) at the bench's schedule with its steps per
second and its bound (ops/roofline.py ``fused_rounds``, from K1's own
counts and the plain version's tally).

The rates are ops/roofline.py's: one H100 SXM's 67 TFLOP/s fp32 outside the
tensor cores (the basis products stay fp32 chains: TF32 would destroy
their cancellation) and 3.35 TB/s of HBM3.  The JAX script's keys that name
TPU units are renamed, not kept with new meanings: one achieved fp32
TFLOP/s and one share of the fp32 peak stand for its MXU and VPU rates and
shares; ``flops_per_lane`` for its MXU and VPU counts (every operation is
an fp32 operation on this card); ``peaks_assumed`` lists the two H100
rates.  Every other key keeps its JAX name.

    python -m irm_motion_planning_tpu_torch.benchmarks.roofline \\
        [--batch 32768] [--device cuda|cpu]

K5 runs CHAINED 64 times per timed call, each output's gradient (scaled by
1e-6) the next call's alpha, as the JAX script does; CUDA events around
the chain, best of 7 after a warm-up.  The solve: best of 7 host-clocked
runs, each ended by a synchronize.  ``--block-b``: K5's threads per CTA
(0: 512); ``--max-obstacles``: 16 (the config's) by default, as the JAX
script.  One JSON line, the card's name and power limit beside it (on the
CPU, the plain versions as a rehearsal, under another metric name).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import (PlannerConfig, REFERENCE_INNER_SCHEDULE_BLS, make_basis,
                reference_scenario, replicate_scenario)
from ..ops import fused_solve as fs
from ..ops import roofline
from ..ops import step_kernels as sk
from ..solvers import fleet
from . import _harness

CHAIN = 64          # K5 calls per timed chain
REPEATS = 7
TALLY_LANES = 4     # the plain tally's lanes (the replicated scene)


def eval_config(block_b: int = 0, max_obstacles: int = 16) -> PlannerConfig:
    return PlannerConfig(bls_mode="ladder", fixed_iters=True,
                         pallas_block_b=block_b,
                         max_obstacles=max_obstacles)


def solve_config(max_obstacles: int = 16) -> PlannerConfig:
    sched = REFERENCE_INNER_SCHEDULE_BLS
    return PlannerConfig(bls_mode="ladder", fixed_iters=True,
                         inner_schedule=sched, max_inner_iteration=max(sched),
                         max_obstacles=max_obstacles)


def eval_chain_ms(cfg: PlannerConfig, basis, scns, dev) -> float:
    """Milliseconds per K5 call, from chains of CHAIN calls (each output's
    gradient x 1e-6 the next alpha: data-dependent, nothing elided)."""
    args = fleet.fused_args(cfg, basis, scns)
    _, kv, kvt, mix, a0 = args[:5]
    B = a0.shape[-1]
    lam = torch.full((1, B), 0.5, device=dev)
    lanes = (lam, lam, *args[7:])

    def chain():
        a = a0
        for _ in range(CHAIN):
            a = sk.cost_grad_eval(cfg, kv, kvt, mix, a, *lanes).grad * 1e-6
        return a

    _harness.event_ms(chain, dev)
    return min(_harness.event_ms(chain, dev)[1]
               for _ in range(REPEATS)) / CHAIN


def rates(bound: roofline.Bound, ms: float) -> dict:
    """The achieved fp32 rate of the bound's operations in ``ms``, its
    share of the peak and the bound's share of ``ms``."""
    achieved = bound.ops / (1e-3 * ms)
    return {
        "achieved_fp32_tflops": round(achieved / 1e12, 3),
        "pct_of_fp32_peak": round(100 * achieved / roofline.FP32_OPS_PER_S,
                                  2),
        "bound_ms": round(bound.ms, 4),
        "bound_by": bound.by,
        "pct_of_bound": round(100 * bound.ms / ms, 2),
    }


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--block-b", type=int, default=0,
                   help="K5's threads per CTA, one warp per lane (0: 512)")
    p.add_argument("--max-obstacles", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _harness.open_device(args.device, "roofline")
    B = args.batch

    cfg = eval_config(args.block_b, args.max_obstacles)
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles
    basis = make_basis(cfg, device=dev)
    scns = replicate_scenario(reference_scenario(cfg, device=dev), B)
    t_eval = eval_chain_ms(cfg, basis, scns, dev)
    bound = roofline.cost_grad_eval(B, T, J, O)
    serial_s = bound.ops / roofline.FP32_OPS_PER_S
    eval_kernel = {
        "time_us_per_call": round(1e3 * t_eval, 1),
        "counted_serial_speed_of_light_us": round(1e6 * serial_s, 1),
        "pct_of_counted_speed_of_light": round(
            100 * 1e3 * serial_s / t_eval, 1),
        "flops_per_lane": round(bound.ops / B),
        "bytes_per_lane": round(bound.bytes / B, 1),
        **rates(bound, t_eval),
        "arithmetic_intensity_flops_per_hbm_byte": round(
            bound.ops / bound.bytes, 1),
        "hbm_bound_ceiling_us": round(
            1e6 * bound.bytes / roofline.BYTES_PER_S, 1),
    }

    # The whole solve at the bench's schedule (K1 on the fused backend).
    cfg_s = solve_config(args.max_obstacles)
    basis_s = make_basis(cfg_s, device=dev)
    scn0 = reference_scenario(cfg_s, device=dev)
    scns_s = replicate_scenario(scn0, B)
    run_solve = fleet.make_fleet_solver(cfg_s, basis_s, backend="fused")
    t_solve, res = _harness.best_seconds(lambda: run_solve(scns_s), dev,
                                         REPEATS)
    live_steps = int(res.stats.inner_iters[0])
    targs = fleet.fused_args(cfg_s, basis_s,
                             replicate_scenario(scn0, TALLY_LANES))
    sub = roofline.plain_tally(fs.fused_solve_reference, *targs)
    scale = B / TALLY_LANES
    work = roofline.kernel_counts(
        {k: v * scale for k, v in sub.items()},
        float((res.stats.outer_iters + res.stats.converged.int()).sum()),
        float(res.stats.inner_iters.sum()))
    solve_bound = roofline.fused_rounds(B, T, J, O, work, True)
    return {
        "metric": "roofline" if dev.type == "cuda"
                  else "roofline_cpu_rehearsal",
        "batch": B,
        "eval_kernel": eval_kernel,
        "fused_solve": {
            "live_steps": live_steps,
            "steps_per_sec_millions": round(live_steps * B / t_solve / 1e6,
                                            1),
            "time_ms": round(1e3 * t_solve, 1),
            **rates(solve_bound, 1e3 * t_solve),
        },
        "peaks_assumed": {
            "fp32_tflops": roofline.FP32_OPS_PER_S / 1e12,
            "hbm_tb_s": roofline.BYTES_PER_S / 1e12,
        },
        **_harness.card(dev),
    }


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
