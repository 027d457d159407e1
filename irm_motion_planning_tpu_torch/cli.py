"""Command-line interface of the PyTorch/CUDA port (counterpart of
irm_motion_planning_tpu/cli.py).

Flag-compatible with the reference CLI (ref: main.py:13-102) and with the
JAX package's: every flag has the same name and default, except that
``--device {cuda,cpu}`` (default cuda) takes the place of ``--platform``.
Without a CUDA device ``--device cuda`` fails; nothing falls back to the
CPU unasked.

Run:  python -m irm_motion_planning_tpu_torch.cli [--optimizer-name bls] ...
"""

from __future__ import annotations

import argparse
import sys


def _bool(x: str) -> bool:
    return str(x).lower() == "true"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="RKHS trajectory optimization on PyTorch/CUDA"
    )

    # --- Profiling / measurement (ref: main.py:17-24) ---
    p.add_argument("--profiling", type=_bool, default=False,
                   help="Wrap the timed region in torch.profiler (a Chrome "
                        "trace in ./torch-trace)")
    p.add_argument("--extended-vis", type=_bool, default=False,
                   help="Record per-iteration trajectory series (Python-loop solver)")
    p.add_argument("--n-measurements", type=int, default=1)
    p.add_argument("--n-times", type=int, default=1)

    # --- Optimizer options (ref: main.py:27-30) ---
    p.add_argument("--optimizer-name", choices=["gd", "bls"], default="bls")
    p.add_argument("--jit-loop", type=_bool, default=True,
                   help="The solver's own loop (True) or the Python loop "
                        "that decides on host scalars, the reference's "
                        "--jit-loop false (False)")

    # --- Trajectory parameters (ref: main.py:33-38) ---
    p.add_argument("--n-timesteps", type=float, default=50,
                   help="Support timesteps (float for reference compatibility)")
    p.add_argument("--rbf-variance", type=float, default=0.1)
    p.add_argument("--jac-gaussian-mean", type=float, default=0.15)

    # --- Minimization (ref: main.py:41-44) ---
    p.add_argument("--max-inner-iteration", type=int, default=200)
    p.add_argument("--loop-loss-reduction", type=float, default=1e-3)

    # --- Dual optimization (ref: main.py:47-60) ---
    p.add_argument("--max-outer-iteration", type=int, default=10)
    p.add_argument("--lambda-constraint-increase", type=int, default=10)
    p.add_argument("--lambda-sg-constraint", type=float, default=0.5)
    p.add_argument("--lambda-jl-constraint", type=float, default=0.1)
    p.add_argument("--eps-position", type=float, default=0.01)
    p.add_argument("--eps-velocity", type=float, default=0.01)

    # --- Loss (ref: main.py:63-70) ---
    p.add_argument("--lambda-max-cost", type=float, default=0.5)
    p.add_argument("--lambda-reg", type=float, default=1e-4)
    p.add_argument("--constraint-violating-dependant-loss", type=_bool, default=True)
    p.add_argument("--joint-safety-limit", type=float, default=0.98)

    # --- BLS (ref: main.py:73-82) ---
    p.add_argument("--max-bls-iteration", type=int, default=20)
    p.add_argument("--bls-lr-start", type=float, default=0.2)
    p.add_argument("--bls-alpha", type=float, default=0.01)
    p.add_argument("--bls-beta_plus", type=float, default=1.2)
    p.add_argument("--bls-beta_minus", type=float, default=0.5)

    # --- GD (ref: main.py:85-86) ---
    p.add_argument("--gd-lr", type=float, nargs="+",
                   default=[2e-3, 1e-4, 1e-5, 1e-6, 1e-7, 1e-8, 1e-8, 1e-8, 1e-8, 1e-8])

    # --- Robot (ref: main.py:89-98) ---
    p.add_argument("--n-joints", type=int, default=3)
    p.add_argument("--link-length", type=float, nargs="+", default=[1.5, 1.0, 0.5])
    p.add_argument("--max-joint-velocity", type=float, default=7)
    p.add_argument("--max-joint-position", type=float, default=2)
    p.add_argument("--min-joint-position", type=float, default=-1)

    # --- Extensions (no reference equivalent) ---
    p.add_argument("--batch", type=int, default=0,
                   help="Scenario batch size; 0 = single-scenario mode")
    p.add_argument("--random-scenarios", type=_bool, default=False,
                   help="With --batch: randomize start/goal/obstacles per lane")
    p.add_argument("--engine", choices=["fleet", "vmap"], default="fleet",
                   help="Batched engine: fleet (lanes trailing, the kernels) "
                        "or vmap (the single-scene solver lane by lane)")
    p.add_argument("--backend", choices=["fused", "pallas", "xla"], default="xla",
                   help="Fleet backend: fused (the whole-solve CUDA kernel), "
                        "pallas (the per-step CUDA kernels), xla (plain "
                        "PyTorch)")
    p.add_argument("--bls-mode", choices=["sequential", "ladder"], default=None,
                   help="Line search execution: reference-sequential or parallel "
                        "ladder.  Default: sequential (reference semantics) for "
                        "the single-scenario/vmap/plain paths, ladder for the "
                        "fleet engine (which is ladder-only; explicitly "
                        "requesting sequential there is an error)")
    p.add_argument("--fixed-iters", type=_bool, default=False,
                   help="Fixed-horizon masked loops (throughput mode)")
    p.add_argument("--inner-schedule", default=None,
                   help="Per-penalty-round inner-step budgets for "
                        "--fixed-iters, comma-separated (one per outer "
                        "round), or 'reference' for the measured "
                        "reference-scene schedule (bench.py's protocol; "
                        "see config.REFERENCE_INNER_SCHEDULE_*)")
    p.add_argument("--matmul-precision", choices=["default", "high", "highest"],
                   default="highest")
    p.add_argument("--ladder-eval", choices=["linearized", "exact"],
                   default="linearized",
                   help="How the fleet/kernel engines evaluate line-search "
                        "candidates: linearized (fastest; exact in real "
                        "arithmetic) or exact (through the basis GEMMs, the "
                        "reference's fp path; see config.ladder_eval)")
    p.add_argument("--max-obstacles", type=int, default=16,
                   help="Static obstacle-slot bound (zero-weight padding is "
                        "exact); 11 = exactly the reference scene's set, the "
                        "headline benchmark default")
    p.add_argument("--pallas-block-b", type=int, default=0,
                   help="fused backend: lanes (warps) per CTA, 1-16; pallas "
                        "backend: threads per CTA, 32-512 in whole warps (0: "
                        "the default plan; config.py has the GPU meaning)")
    p.add_argument("--recip-newton", type=_bool, default=False,
                   help="Accepted for the reference's flag set; no effect "
                        "(the CUDA kernels divide exactly)")
    p.add_argument("--lane-compaction", type=_bool, default=False,
                   help="Heterogeneous-fleet mode (backend fused): re-sort "
                        "lanes between penalty rounds so kernel tiles "
                        "freeze together (bitwise-equal per lane)")
    p.add_argument("--bls-bf16-ladder", type=_bool, default=False,
                   help="Opt-in bf16 ladder tier of the fused backend for "
                        "BLS past the float32 plans' ceiling "
                        "(config.bls_bf16_ladder)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the card: kernels on the fused/pallas "
                        "backends) or cpu (the plain versions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="trajectory_result.txt")
    p.add_argument("--series-output", default="trajectory_series.txt")
    return p


def resolve_bls_mode(args) -> str:
    """Context-dependent default (see --bls-mode help)."""
    if args.bls_mode is not None:
        return args.bls_mode
    if args.batch > 0 and args.engine == "fleet":
        return "ladder"
    return "sequential"


def resolve_inner_schedule(args):
    if getattr(args, "inner_schedule", None) is None:
        return None
    if not args.fixed_iters:
        # The schedule applies only in fixed_iters mode (config.py contract);
        # accepting-and-ignoring it would contradict the "no flag is silently
        # ignored" principle applied to --bls-mode.
        print(
            "error: --inner-schedule requires --fixed-iters true (the "
            "early-exit while_loop self-schedules its inner steps)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    from . import config as cfglib

    if args.inner_schedule == "reference":
        name = getattr(args, "optimizer_name", "bls")
        sched = {
            "bls": cfglib.REFERENCE_INNER_SCHEDULE_BLS,
            "gd": cfglib.REFERENCE_INNER_SCHEDULE_GD,
        }[name]
        if args.max_outer_iteration > len(sched):
            # Pad by repeating the last entry instead of surfacing an opaque
            # PlannerConfig length-mismatch traceback.
            sched = sched + sched[-1:] * (args.max_outer_iteration - len(sched))
        return sched[: args.max_outer_iteration]
    return tuple(int(x) for x in args.inner_schedule.split(","))


def config_from_args(args) -> "PlannerConfig":
    from .config import PlannerConfig

    return PlannerConfig(
        n_timesteps=int(args.n_timesteps),
        rbf_variance=args.rbf_variance,
        mix_scale=args.jac_gaussian_mean,
        n_joints=args.n_joints,
        link_length=tuple(args.link_length),
        max_joint_velocity=args.max_joint_velocity,
        max_joint_position=args.max_joint_position,
        min_joint_position=args.min_joint_position,
        lambda_max_cost=args.lambda_max_cost,
        lambda_reg=args.lambda_reg,
        constraint_violating_dependant_loss=args.constraint_violating_dependant_loss,
        joint_safety_limit=args.joint_safety_limit,
        eps_position=args.eps_position,
        eps_velocity=args.eps_velocity,
        max_outer_iteration=args.max_outer_iteration,
        lambda_constraint_increase=args.lambda_constraint_increase,
        lambda_sg_constraint=args.lambda_sg_constraint,
        lambda_jl_constraint=args.lambda_jl_constraint,
        max_inner_iteration=args.max_inner_iteration,
        loop_loss_reduction=args.loop_loss_reduction,
        max_bls_iteration=args.max_bls_iteration,
        bls_lr_start=args.bls_lr_start,
        bls_alpha=args.bls_alpha,
        bls_beta_plus=args.bls_beta_plus,
        bls_beta_minus=args.bls_beta_minus,
        gd_lr=tuple(args.gd_lr),
        bls_mode=resolve_bls_mode(args),
        fixed_iters=args.fixed_iters,
        inner_schedule=resolve_inner_schedule(args),
        matmul_precision=args.matmul_precision,
        ladder_eval=args.ladder_eval,
        max_obstacles=args.max_obstacles,
        pallas_block_b=args.pallas_block_b,
        recip_newton=args.recip_newton,
        bls_bf16_ladder=args.bls_bf16_ladder,
        lane_compaction=args.lane_compaction,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from . import (
        Penalty, constraint_report, init_alpha, make_basis,
        reference_scenario, replicate_scenario, total_cost,
    )
    from .device import resolve
    from .ops.scenario import random_scenarios
    from .solvers import batched, bls, gd, plain
    from .utils import io as iolib
    from .utils import profiling, timing

    device = resolve(args.device if args.device == "cpu" else None)
    cfg = config_from_args(args)
    basis = make_basis(cfg, device=device)
    scn = reference_scenario(cfg, device=device)

    series_holder = {}

    if args.batch > 0:
        if args.random_scenarios:
            scns = random_scenarios(
                cfg, torch.Generator().manual_seed(args.seed), args.batch,
                device=device)
        else:
            scns = replicate_scenario(scn, args.batch)
        if args.engine == "fleet":
            from .solvers import fleet

            if args.optimizer_name == "bls" and cfg.bls_mode == "sequential":
                # The fleet engine is ladder-only; the flag must not be
                # silently ignored.
                print(
                    "error: --bls-mode sequential is not supported by "
                    "--engine fleet; use --bls-mode ladder (identical trial "
                    "sequence, see solvers/bls.py) or --engine vmap",
                    file=sys.stderr,
                )
                return 2
            run_batch = fleet.make_fleet_solver(
                cfg, basis, solver=args.optimizer_name, backend=args.backend
            )
        else:
            run_batch = batched.make_batched_solver(
                cfg, basis, solver=args.optimizer_name
            )

        def run():
            return run_batch(scns)

    elif args.jit_loop:
        solver = {"bls": bls, "gd": gd}[args.optimizer_name]

        def run():
            a0 = init_alpha(cfg, basis, scn.start, scn.goal)
            return solver.solve(cfg, basis, scn, a0)

    else:
        def run():
            res, series = plain.plain_solve(
                cfg, basis, scn, solver=args.optimizer_name,
                record_series=args.extended_vis,
            )
            if series is not None:
                series_holder["series"] = series
            return res

    def timed_region():
        return timing.time_fn(
            run, n_measurements=args.n_measurements, n_times=args.n_times
        )

    if args.profiling:
        with profiling.trace():
            report = timed_region()
    else:
        report = timed_region()

    for ms in report.per_measurement_ms:
        print(f"took {ms} ms")
    if args.n_measurements > 1:
        print(
            f"runtimes in ms: mean {report.mean_ms} stddev {report.stddev_ms}"
        )

    result = run()
    timing.sync()

    if args.batch > 0:
        summary = batched.batch_summary(result)
        print(
            f"batch {summary['n']}: converged "
            f"{float(summary['converged_fraction']):.3f}, mean cost "
            f"{float(summary['mean_final_cost']):.4f}, mean inner iters "
            f"{float(summary['mean_inner_iters']):.1f}"
        )
        alpha = result.alpha[0]
        scn0 = type(scns)(*(x[0] for x in scns))
    else:
        alpha = result.alpha
        scn0 = scn

    zero = torch.zeros((), dtype=torch.float32, device=device)
    pen0 = Penalty(zero, zero)
    avg_cost = total_cost(
        cfg.replace(lambda_max_cost=0.0), basis, scn0, pen0, alpha
    )
    max_cost = total_cost(
        cfg.replace(lambda_max_cost=1.0), basis, scn0, pen0, alpha
    )
    report_c = constraint_report(cfg, basis, scn0, alpha)
    print(
        f"result cost: ( avg {float(avg_cost)} , max {float(max_cost)} ). "
        f"constraint fulfiled {bool(report_c['all_ok'])}"
    )
    for k in ("start_pos_err", "goal_pos_err", "start_vel", "goal_vel",
              "traj_max", "traj_min", "vel_abs_max"):
        print(f"  {k}: {float(report_c[k]):.5f}")

    iolib.save_trajectory_result(args.output, cfg, basis, alpha)
    if args.extended_vis and "series" in series_holder:
        arr = iolib.save_series(args.series_output, series_holder["series"])
        print(arr.shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
