"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from irm_motion_planning_tpu_torch/csrc
(K1, the whole solve, and K2, one penalty round, each for BLS in both
ladder tiers, in the linearized ladder's ultra and bf16 tiers, and
for GD; K3/K4, one BLS (both tiers) or GD inner step; K5,
the fused cost/gradient evaluation; K6, the forward evaluation), holds each
against its plain PyTorch version, and
drives the port's paths through them: the main path
(irm_motion_planning_tpu_torch.bench's default protocol: the reference
scene replicated over 1,048,576 lanes, one K1 launch), the
heterogeneous-fleet path (the bench's random-scenes mode: 1,048,576 random
scenes, one K2 launch per penalty round with lane compaction, gated against
the plain xla engine), the per-step backend (``--backend pallas``, BLS and
GD, K3-K6), GD on the fused backend (``--solver gd``, K1 and K2 with the
GD step), the exact ladder (``--ladder-eval exact``, K1, K2 and K3 with
the exact BLS step) and the kernel tiers of K1/K2 (``ultra``, ``bf16``;
``lean`` runs the linearized program; the bf16 plan past the f32 plans'
ceiling).  Phases:

1. device: the card's name and power limit, the kernel build; for K1 and
   K2 (one warp per lane, persistent grid), for each program (bls, gd,
   bls_exact and the tiers bls_ultra, bls_bf16), the registers
   and spills of each instantiation from the ptxas report (``fused_solve<gd,50,11>``: program, T, O; ``<bls,0,0>``
   the generic one), and from the launch plan the shared memory per CTA
   (which must equal the C side's) and the CTAs and warps per SM; the
   plans of K3 (both ladder tiers), K4 and K5 (K1's for their program, at
   T = 50, 100, 150 and 200, 16 and 2 lanes per CTA) and K6's tile, each
   against the C side;
2. K1 against plain, short horizon: 1,024 random scenes, 1 round x 4
   steps, lane agreement and alpha error on agreeing lanes; then the first
   1,000 of those lanes at 4, 8 and 16 lanes (warps) per CTA and on a
   one-CTA grid (one CTA's warps draw every lane from the queue), which
   must equal the full batch's lanes bit for bit;
3. K1 against plain, full schedule: 16,384 random scenes, converged
   fraction, mean unpenalized obstacle cost and the phantom-convergence
   rate from the exact constraint check, as bench.py gates random scenes,
   and the lane agreement;
4. the main path: solves/s, the K1 launch count, and the quality of the
   solved reference scene (avg/max cost within 2% of the reference's,
   endpoint error < 0.05; bench.py's strict endpoint < 0.01 is printed).
   Every lane of the replicated scene must equal lane 0 bit for bit, and the
   plain version's avg/max cost on the same inputs must lie within 1% of
   the kernel's; the main path's peak device memory;
5. K2 against plain, one round (n_r = 4): 1,024 random scenes, a quarter of
   the lanes fulfilled, penalties escalated x1/x10/x100, four learning
   rates; lane agreement and alpha error on the outputs the caller reads;
   then 1,000 of those lanes at 4/8/16 lanes per CTA and on a one-CTA
   grid, bit for bit the full batch's lanes;
6. the rounds driver against K1: 16,384 random scenes at the bench
   schedule, a warm-up run, then compaction off, on and off again; every
   output field must equal K1's bit for bit and each solve must launch K2
   ten times.  K2's time (the sum of its ten launches, compaction off: the
   second reading, with the warm-up's and the first beside it, each with
   its slowest launch and the host's time inside that call) and the plain
   version's on the same ten inputs;
7. the heterogeneous path: solves/s with compaction on (K2 launch count,
   the paired xla gate on 32,768 lanes with its values, bands and the xla
   engine's time; the gate must pass) and off (per-lane results must equal
   the compacted run's bit for bit), K2's time per solve, and K1's
   whole-solve time on the same scenes (which must equal the rounds
   driver's result bit for bit); compaction on against off in six pairs
   whose order alternates (median and range of the per-pair ratio); K1's
   bound there and K2's per solve, from
   K1's own counts and the plain version's tally on the first 65,536 of the
   scenes, scaled to the batch;
8. K5 and K6 against their plain versions: 1,024 random scenes (penalties
   x1/x10/x100), then the first 1,000 of them at 64/128/256 threads (K5:
   2/4/8 lanes per CTA), bit for bit the full batch's lanes; K6 bit for bit
   K5's traj/vel
   on the same alpha, and on 1,000 and 999 lanes (16- and 4-byte copies)
   bit for bit the full batch's; each timed at 1,048,576 lanes on the main
   path's inputs, K6 beside one torch.einsum of the same product and as a
   share of its bound, and held to the plain version (K6 to K5) there too;
9. K3 and K4 against their plain versions, one step from K5's state on the
   same 1,024 scenes, a quarter of the lanes frozen (bitwise unchanged),
   four learning rates: agreement of the stop flags and lr, and on the
   agreeing lanes every other field (alpha, loss, grad, traj, vel), the
   ragged batch bitwise (K3 at 2, 4 and 8 lanes per CTA, K4 at 1, 2, 5, 10
   and 16); each
   timed at 1,048,576 lanes from K5's state
   on the main path's inputs and held to the plain version there too;
10. the BLS per-step path (bench --backend pallas): the replicated scene at
   1,048,576 lanes (solves/s, launch counts, every lane equal to lane 0,
   the phase-4 gate and the strict verdict; K3, K5 and K6 time per solve;
   peak device memory), then 1,048,576 random scenes with the paired xla
   gate on 32,768 lanes, and K1-BLS on 16,384 random scenes bit for bit
   the per-step BLS path (K5 + K3 + K6);
11. the GD per-step path (bench --solver gd --backend pallas): the same,
   gated against REFERENCE_FINAL_COST["gd"] with endpoint < 0.05 (bench's
   strict 0.042 printed), and the paired gate against the GD xla engine;
12. K1-GD and K2-GD against their plain versions: K1-GD on 1,024 random
   scenes at 2 rounds x 6 steps (lane agreement, alpha error); K2-GD one
   round (n_r = 4) with a quarter of the lanes fulfilled (bitwise
   unchanged) and the GD schedule's first four learning rates; for both the
   first 1,000 lanes at 4/8/16 lanes per CTA and on one CTA, bit for bit
   the full batch's lanes;
13. the GD fused path (bench --solver gd): the replicated scene at
   1,048,576 lanes (solves/s, one K1 launch per solve and no K2 launch,
   every lane equal to lane 0, the GD gate with the strict verdict, peak
   device memory; K1-GD alone, its plain version and bound); K1-GD against
   the per-step GD path on 16,384 random scenes (bitwise, or lane
   agreement >= 0.99) and the GD rounds driver against K1-GD there
   (compaction off and on, bit for bit, ten K2-GD launches; K2-GD's ten
   rounds against their plain versions); 1,048,576 random scenes with
   compaction (the paired GD xla gate on 32,768 lanes must pass), then
   without, then K1-GD on the same scenes, all bitwise equal per lane;
   K2-GD's time per solve, and the GD bounds there;
14. K1-exact and K2-exact against their plain versions: K1-exact on 1,024
   random scenes at 2 rounds x 6 steps, K2-exact one round (n_r = 4) with a
   quarter of the lanes fulfilled (bitwise unchanged), lane agreement >=
   CARD_SHORT_AGREEMENT_MIN; for both the first 1,000 lanes at
   4/8/16 lanes per CTA and on one CTA, bit for bit the full batch's lanes;
15. K3-exact against its plain version, one step from K5's state on the
   same 1,024 scenes (a quarter frozen, bitwise unchanged), the ragged
   batch at 2/4/8 lanes per CTA bitwise, and at 1,048,576 lanes on
   the main path's inputs (timed, held to plain, bound);
16. the exact paths: K1-exact against the per-step exact path (K5 + K3-exact,
   no K6 launch) on 16,384 random scenes at the bench schedule, bit for
   bit; the exact rounds driver against K1-exact with compaction off and
   on (bitwise, ten K2-exact launches, K2-exact's ten rounds against their
   plain versions); ``bench --ladder-eval exact`` at 1M replicated (one K1
   launch per solve, the exact gate endpoint < 0.05, the strict 0.01
   reading printed, lanes equal lane 0, peak memory; K1-exact alone, its
   plain version and bound); 1M random scenes with compaction and the
   paired gate against the exact xla engine on 32,768 lanes, then K1-exact
   on the same scenes, bitwise equal; K2-exact's time per solve and the
   bounds there; and, for information, the certify statistics
   (irm_motion_planning_tpu_torch/benchmarks/certify.py) of the card's
   exact tier on
   the 2,048 scenes of certify_oracle_cpu2048.npz;
17. large T (the streamed body of K1/K2 and of K3-K5, whose CTA runs a
   tile of lanes in lockstep and each basis product through K7, the
   CTA-cooperative basis stream; K6 tiled): the L2 rate;
   streamed K1 and the rounds driver over streamed K2 bit for bit resident
   K1 at T=50 for each program; at T=200 K1 and K2 against plain with the
   ragged batch at tiles of 1, 2, 3, half, one fewer than and the plan's
   lanes and on one CTA (1,000 lanes leave ragged last tiles), K2's
   fulfilled lanes passed through in their tiles; K7 alone (one forward
   product at 65,536 lanes) bit for bit K6 and timed beside one
   torch.matmul; K3-K6 against plain with their ragged batch (K6 bit for
   bit K5); 65,536 random scenes
   per program (one K1
   launch per solve, the paired xla gate on 8,192 lanes, which holds the
   linearized ladder to its phantom and cost bands; K1's converged
   fraction against its plain version's on those lanes within bench.py's
   band, every program; K1's bound, the function's, beside the design's
   basis reads from L2; the rounds driver bitwise; the per-step path of
   every program bitwise); the linearized per-step path's launches; K3-K6
   timed at 65,536 lanes of the reference scene, and held to plain lane by
   lane on 65,536 random scenes (at most TIE_LANES_MAX lanes per kernel,
   each a tie of the blend's first argmax); the problemsize sweep, fused
   and xla, K1 launched at every size;
18. the kernel tiers of K1/K2 (the linearized ladder's ultra and bf16
   programs, csrc/fused_tiers.cu; the lean tier runs the linearized
   program): at T=50 (resident) K1 and K2 with ``lean=True`` bit for bit
   K1-BLS and K2-BLS, and each program's K1 and K2 against its plain
   version under phase 2's rule, the ragged batch at every grid shape and
   the streamed plan bit for bit; at T=200 (streamed; bf16 in the
   half-width layout) each program's K1 on phase 17's 65,536 random
   scenes, timed, held to its plain version's converged fraction and
   obstacle cost, to phantom 0 and to the cost band against phase 17's xla
   run, its converged fraction against xla printed, and K2 one round
   against plain; past the f32 plans' ceiling,
   fleet_solve(backend="fused", bls_bf16_ladder=True) at T=2,200 on 512
   random scenes (the basis make_basis builds at that T, timed) must take the
   planner's bf16 plan and launch K1 once, and is timed; K1 agrees with the
   plain version under phase 2's rule; without the opt-in it warns and
   runs xla;
19. the entry points above the fleet engine: ``init_alpha``'s fit of the
   smoothstep line on the card (cuSOLVER) beside the CPU's (at most
   INIT_FIT_MAX); the CLI in this process (``cli.main``): the single-scene
   default (sequential BLS, plain PyTorch on the card) and GD, each with
   its ms per solve, the bench's 2% gate and endpoint < 0.05 (the goldens'
   0.1% verdict printed), the plain loop's series file, and ``--batch
   65536 --engine fleet --backend fused`` (K1 launched, its instantiation
   printed); replan_bench's protocol on K1 (``Replanner(engine="fleet",
   backend="fused")``, 100 ticks of drifting obstacles, 2 rounds x 25
   steps, early exit): one scene padded to 128 lanes and a fleet of 256,
   ms per tick (median, p99) and Hz, one K1 launch per tick, every padded
   lane bit for bit lane 0, every tick within 1% of the plain version on
   lane 0's inputs (avg/max cost), the rollout bit for bit the tick loop,
   and no rebuild of the kernel library across the ticks; and ``bench
   --engine vmap --random-scenarios`` at 65,536 scenes (solves/s, peak
   device memory, the paired gate on 8,192 lanes: phantom and cost bands
   required, the converged band printed, ROADMAP fact 8);
20. the sharded path (irm_motion_planning_tpu_torch/parallel): a one-rank
   NCCL group (``initialize_distributed`` on 127.0.0.1) runs
   ``make_shard_map_solver(engine="fleet", backend="fused")`` on the main
   path's 1,048,576 replicated lanes (K1 launched; alpha and stats bit for
   bit phase 4's; the reduced statistics, on the card, against
   ``batch_summary``; solves/s beside phase 4's); two fresh processes of
   this script (``shard-worker``) share the card under an explicit gloo
   group, 524,288 of those lanes each (bit for bit phase 4's, the same
   statistics on both ranks, their combined solves/s), then 16,384 random
   scenes (2 x 8,192) on ``pallas`` and ``xla``, each rank's shard bit for
   bit the same shard solved locally here; NCCL asked for two ranks on the
   one card must raise; ``scaling.py --backend fused --repeats 2`` in one
   process and with ``--spawn 2`` (both JSON lines printed); and the
   visualization's ``cost_grid`` on the card against the CPU, without
   matplotlib;
21. any arm (K1-K7 built for other joint counts J; the libraries of J = 5
   and 7 build in the background from phase 1, their seconds and ptxas
   registers and spills printed): ``build_basis`` at (T=72, J=5) must give
   the sha256 tests/test_torch_basis_build.py pins (its CPU seconds at
   T = 50, 200 printed); on JAX's 5-link test arm at T=50, 1,048,576 random
   scenes through ``fleet_solve(backend="fused")`` (one K1 launch; solves/s,
   K1's time and bound) with the paired xla gate on 32,768 lanes
   (required), then with compaction (ten K2 launches, bit for bit K1), for
   BLS and GD; each kernel against its plain version on 65,536 random
   scenes (K1 and K2 at 1 round x 4 steps, K2-ultra and K2-bf16 one round,
   K3-K6 one step: >= 0.99; K6 bit for bit K5), the 999-lane ragged batch
   and three lanes alone bit for bit, the full schedule on 16,384 scenes (>=
   0.87) and the per-step paths there bit for bit K1; at T=200 (the
   streamed plan) 65,536 random scenes per program through K1 (converged
   within bench.py's band of the plain version's on 8,192 lanes; the
   paired gate required for exact and GD, printed for the linearized
   ladder) and K7 alone (bit for bit K6, beside one torch.matmul); the
   7-link arm at T=50: K1 against plain on 65,536 lanes and the paired
   gate; the CLI with ``--n-joints 5`` on the card;
22. the benchmarks (irm_motion_planning_tpu_torch/benchmarks/; T=50, J=3,
   11 obstacle slots; the five phase-ablated builds of K1 build in the
   background from phase 1, after the J = 5 and 7 libraries): the quality
   gate for BLS across xla, pallas and fused on 32,768 random scenes at the
   bench schedule (its verdict required), then GD (printed); the seed
   sweep over seeds 0-4 (per-seed deltas and sign flips); the port's
   sequential oracle on 2,048 random scenes on the card, then the engine
   phase of both ladder tiers on fused against it (on-platform) and against
   the JAX package's stored CPU and TPU oracles (informative), every row
   and verdict printed (the oracle file must load); the schedule sweep's
   eight candidates through K2, and the shipped schedule under the bench
   config, whose endpoint and alpha must be phase 4's K1 lane 0 bit for
   bit; hetero's four policies with and without ``--shrink`` at 1,048,576
   random scenes (solves/s, per-round decomposition); the epilogue shares
   of the five ablated builds at 1,048,576 replicated lanes (each build's
   time, registers, spills and K1's own work); decompose and roofline at
   32,768 and 1,048,576 lanes; the five ablation rows.  K1-K6 must each
   launch in the phase.

The kernels line gives for each kernel its launches on its path (K5, on
both per-step paths: the BLS path's, and ``launches_by_path``), its
largest error against the plain version, its time, the plain version's
(timed without the work tally), its bound (ops/roofline.py, from this
run's inputs and the plain versions' tallies of the data-dependent work,
each from an untimed call) and, for K6, one PyTorch call's time and its
share of the bound; K3-K6 their registers and spills, K3-K5 their plans'
occupancy.  K1 and
K2 also carry their time and bound at 1,048,576 random scenes (K2 per
solve; at 16,384 lanes K2's ``ms`` is its second reading and
``ms_first_reading`` and ``ms_warm_up`` the two before), their registers,
spills and occupancy, and K1 the main path's peak device memory; under
``gd`` the same numbers for their GD instantiations (phases 12-13), under
``exact`` K1's, K2's and K3's for the exact ladder (phases 14-16, with
their lane agreement), under ``streamed`` those at T=200 (phase 17), and
under ``tiers`` K1's and K2's numbers for each kernel tier's program (phase
18; K1-bf16 also past the f32 plans' ceiling), and under ``entry_points``
phase 19's numbers, under ``sharded`` phase 20's; every kernel under
``joints`` phase 21's by J (launches, ms, bound, ptxas registers and
spills, lane agreement), K1 also the built basis' digest and the libraries'
build seconds.  K7's line carries K1-BLS
at T=200 (the kernel it runs in) and K7 alone: ``ms_per_product``,
``matmul_ms`` (one torch.matmul of the same product), ``plain_ms_per_product``,
``l2_bytes_per_product`` (the design's: each row block once per tile) and
the plan's lanes, warps and ring.

Any failed phase exits non-zero.  It imports nothing of JAX.  The last line
is ``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_BATCH = 1048576
SHORT_BATCH = 1024
RAGGED_BATCH = 1000
ODD_BATCH = 999
FULL_BATCH = 16384
CHECK_LANES = 32768
TALLY_LANES = 65536
WARP_SHAPES = (4, 8, 16)
TIMED_LAUNCHES = 3
COMPACTION_PAIRS = 6
# Phase 17, large T: the problem size, the full-width batch with the paired
# gate's lanes and the plain tally's, the per-step path's batch, the
# problem-size sweep's batch, and the buffer, copies and reads that measure
# the L2 rate.
LARGE_T = 200
LARGE_BATCH = 65536
LARGE_CHECK = 8192
LARGE_TALLY = 8192
STEP_BATCH = 16384
SWEEP_BATCH = 4096
# Phase 18, the kernel tiers: the tally's lanes at T=200 (scaled, as phase
# 17's), and past the f32 plans' ceiling the T and batch of the bf16 plan.
TIER_TALLY = 2048
TIER_BIG_T = 2200
TIER_BIG_BATCH = 512
L2_COPY_BYTES = 16 << 20
L2_COPIES = 200
L2_READS = 64
T0 = time.perf_counter()


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(f"[{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


_PHASE = {"n": None, "t": T0}


def phase_clock(n):
    """Print the seconds of the phase that ends here and start phase n
    (None: the last phase ends)."""
    now = time.perf_counter()
    if _PHASE["n"] is not None:
        say(f"phase {_PHASE['n']} took {now - _PHASE['t']:.1f}s")
    _PHASE.update(n=n, t=now)


def timed(fn):
    """(result, milliseconds) of fn() on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def lanes_match_lane0(fields, dim):
    """Whether every lane of each tensor (lanes along ``dim``) equals lane
    0 bit for bit."""
    return all(bool((x == x.narrow(dim, 0, 1)).all()) for x in fields)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import irm_motion_planning_tpu_torch as mt
    from irm_motion_planning_tpu_torch import bench
    from irm_motion_planning_tpu_torch.ops import _build
    from irm_motion_planning_tpu_torch.ops import fused_solve as fs
    from irm_motion_planning_tpu_torch.ops import roofline
    from irm_motion_planning_tpu_torch.ops import step_kernels as sk
    from irm_motion_planning_tpu_torch.ops.costs import Penalty
    from irm_motion_planning_tpu_torch.solvers import fleet

    dev = torch.device("cuda", 0)
    # -- phase 1: device and build -------------------------------------
    phase_clock(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    # Phase 21's libraries (J = 5, 7) build while phases 2-20 run.
    joint_builds = start_joint_builds(_build)
    # Phase 22's phase-ablated K1 builds, after those.
    variant_builds = start_variant_builds(joint_builds)
    ptxas = ptxas_report(_build.builds.get(3, {}).get("log", ""))
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__} cuda {torch.version.cuda}; kernels built in "
        f"{build_s:.1f}s")
    occupancy = {}
    for prog in fs.PROGRAMS:
        # The program's solver, BLS's ladder tier and the kernel tier.
        solver, ladder, tier = fs.program_call(prog)
        bcfg = bench.bench_config(ladder_eval=ladder)
        for name in ("fused_solve", "fused_round"):
            plan = fs.launch_plan(bcfg, bcfg.max_obstacles, prog=prog)
            shape = fs.launch_shape(bcfg, bcfg.max_obstacles, MAIN_BATCH,
                                    name, solver, **tier)
            if shape["smem"] != plan["total"]:
                fail(f"phase 1: {name} launch plan {plan['total']} B of "
                     f"shared memory per CTA, the C side {shape['smem']} B")
            built = {k: v for k, v in ptxas.items()
                     if k.startswith(f"{name}<{prog},")}
            # The kernel tiers' programs have no specialised instantiation.
            want = 2 if prog in fs.TIER_PROGRAMS else 3
            if len(built) != want:
                fail(f"phase 1: no ptxas report of {name}<{prog},...> "
                     f"(specialised, generic and streamed): {sorted(ptxas)}")
            occupancy[name, prog] = {"ptxas": built, **shape,
                                     "warps_per_cta": plan["warps"],
                                     "smem_bytes": plan["bytes"]}
            say(f"phase 1 {name} (K{1 if name == 'fused_solve' else 2}, "
                f"{prog}): {plan['lanes']} lanes per CTA, {plan['warps']} "
                f"warps, shared "
                f"memory per CTA {plan['total']} B {plan['bytes']}, "
                f"{shape['ctas_per_sm']} CTAs and {shape['warps_per_sm']} "
                f"warps per SM on {shape['sms']} SMs; ptxas {built}")
            # The streamed plan at large T: plan and C side must agree (the
            # bf16 tier's also past the f32 plans' ceiling, at TIER_BIG_T).
            for size in (100, 150, 200) + (
                    (TIER_BIG_T,) if prog == "bls_bf16" else ()):
                lcfg = bcfg.replace(n_timesteps=size)
                lplan = fs.launch_plan(lcfg, bcfg.max_obstacles, prog=prog)
                lshape = fs.launch_shape(lcfg, bcfg.max_obstacles, MAIN_BATCH,
                                         name, solver, **tier)
                if lshape["smem"] != lplan["total"]:
                    fail(f"phase 1: {name} at T={size}: launch plan "
                         f"{lplan['total']} B per CTA, the C side "
                         f"{lshape['smem']} B")
                occupancy[name, prog][f"T{size}"] = {
                    **lshape, "plan": lplan["plan"],
                    "lanes_per_cta": lplan["lanes"],
                    "warps_per_cta": lplan["warps"],
                    "smem_bytes": lplan["bytes"],
                    "k7_ring": lplan.get("ring")}
                if lshape["warps_per_cta"] != lplan["warps"]:
                    fail(f"phase 1: {name} at T={size}: launch plan "
                         f"{lplan['warps']} warps per CTA, the C side "
                         f"{lshape['warps_per_cta']}")
                say(f"phase 1 {name} ({prog}) at T={size}: {lplan['plan']} "
                    f"plan, {lplan['lanes']} lanes and {lplan['warps']} warps "
                    f"per CTA, K7 ring {lplan.get('ring')}, "
                    f"{lplan['total']} B per CTA {lplan['bytes']}, "
                    f"{lshape['ctas_per_sm']} CTAs and "
                    f"{lshape['warps_per_sm']} warps per SM")
    say(f"phase 1 the kernel library (every csrc/*.cu, one nvcc each, in "
        f"parallel) built in {build_s:.1f}s; the kernel tiers' programs "
        f"{fs.TIER_PROGRAMS} from csrc/fused_tiers.cu")
    say(f"phase 1 K3-K6 ptxas "
        f"{ {k: v for k, v in ptxas.items() if not k.startswith('fused')} }")
    # K3 (each ladder tier), K4 and K5 (one warp per lane, K1's plan for
    # their program: the specialised, generic and streamed instantiations
    # each) and K6 (the tiled product): the plan and the C side must agree.
    for prefix in ("bls_step<bls,", "bls_step<bls_exact,", "gd_step<",
                   "cost_grad_eval<"):
        if len([k for k in ptxas if k.startswith(prefix)]) != 3:
            fail(f"phase 1: no ptxas report of {prefix}...> (specialised, "
                 f"generic and streamed): {sorted(ptxas)}")
    for name, key, solver, ladder in (
            ("bls_inner_step", "bls_inner_step", "bls", "linearized"),
            ("bls_inner_step", "bls_inner_step_exact", "bls", "exact"),
            ("gd_inner_step", "gd_inner_step", "gd", "linearized"),
            ("cost_grad_eval", "cost_grad_eval", "bls", "linearized")):
        plan_of = getattr(sk, name.replace("_inner", "") + "_plan")
        shape_of = getattr(sk, name.replace("_inner", "") + "_shape")
        occupancy[key] = {}
        for size in (50, 100, 150, LARGE_T):
            scfg = bench.bench_config(solver=solver, ladder_eval=ladder,
                                      n_timesteps=size)
            for bt in (0, 64):
                c = scfg.replace(pallas_block_b=bt)
                splan, sshape = plan_of(c, 11), shape_of(c, 11, MAIN_BATCH)
                if sshape["smem"] != splan["total"]:
                    fail(f"phase 1: {key} at T={size}, pallas_block_b {bt}: "
                         f"plan {splan['total']} B per CTA, the C side "
                         f"{sshape['smem']} B")
                occupancy[key][f"T{size}, pallas_block_b {bt}"] = {
                    **sshape, "plan": splan["plan"],
                    "lanes_per_cta": splan["lanes"],
                    "warps_per_cta": splan["warps"],
                    "smem_bytes": splan["bytes"]}
                say(f"phase 1 {key} at T={size}, pallas_block_b {bt}: "
                    f"{splan['plan']} plan, {splan['lanes']} lanes and "
                    f"{splan['warps']} warps per CTA, {splan['total']} B per "
                    f"CTA, {sshape['ctas_per_sm']} CTAs and "
                    f"{sshape['warps_per_sm']} warps per SM")
    fplan = sk.forward_plan(bench.bench_config())
    fshape = sk.forward_eval_shape()
    if (fshape["rows"], fshape["lanes"], fshape["tk"], fshape["threads"],
            fshape["smem"]) != (fplan["rows"], fplan["lanes"], fplan["tk"],
                                fplan["threads"], fplan["total"]):
        fail(f"phase 1: forward_eval's tile {fplan} differs from the C side's "
             f"{fshape}")
    occupancy["forward_eval"] = {**fshape, "smem_bytes": fplan["bytes"]}
    say(f"phase 1 forward_eval (K6) tile: {fplan['rows']} rows x "
        f"{fplan['lanes']} lanes per CTA, {fplan['tk']} timesteps per stage, "
        f"{fplan['threads']} threads, {fplan['total']} B of shared memory "
        f"{fplan['bytes']}, {fshape['ctas_per_sm']} CTAs per SM")

    def random_args(cfg, batch, seed):
        basis = mt.make_basis(cfg, device=dev)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(seed),
                                   batch, device=dev)
        return basis, scns, fleet.fused_args(cfg, basis, scns)

    # -- phase 2: kernel against plain, short horizon ------------------
    phase_clock(2)
    cfg = mt.PlannerConfig(max_outer_iteration=1, max_inner_iteration=4,
                           fixed_iters=True, max_obstacles=11)
    _, _, args = random_args(cfg, SHORT_BATCH, 0)
    k = fs.fused_solve(*args)
    torch.cuda.synchronize()
    p = fs.fused_solve_reference(*args)
    agree, rel = fs.lane_agreement(p, k)
    if agree < fs.CARD_SHORT_AGREEMENT_MIN or rel > fs.ALPHA_REL_MAX:
        fail(f"phase 2: kernel disagrees with the plain version (lane "
             f"agreement {agree:.4f}, alpha error {rel:.3g})")
    same = ((k.inner_iters == p.inner_iters) & (k.outer_iters == p.outer_iters)
            & (k.fulfilled == p.fulfilled))[0]
    max_abs_err = float((k.alpha - p.alpha).abs()[:, :, same].max())
    say(f"phase 2 short horizon ({SHORT_BATCH} random scenes, 1x4 steps): "
        f"lane agreement {agree:.4f} (bound >= "
        f"{fs.CARD_SHORT_AGREEMENT_MIN}), alpha error on agreeing lanes "
        f"{max_abs_err:.3g} abs, {rel:.3g} of the lane's scale (bound <= "
        f"{fs.ALPHA_REL_MAX})")
    # A ragged batch: per-lane results do not depend on how lanes are
    # grouped, so the first RAGGED_BATCH lanes must come out bit for bit as
    # in the full batch, whatever the block size and however many lanes of
    # the last block are masked.
    cut = [x[..., :RAGGED_BATCH] for x in args[4:]]
    p_cut = fs.fused_solve_reference(cfg, *args[1:4], *cut)
    for warps, ctas in grid_shapes():
        kr = fs.fused_solve(cfg.replace(pallas_block_b=warps), *args[1:4],
                            *cut, ctas=ctas)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                   for x, y in zip(kr, k)):
            fail(f"phase 2: {RAGGED_BATCH} lanes at {warps} lanes per CTA, "
                 f"{ctas or 'all'} CTAs differ from the same lanes of the "
                 f"{SHORT_BATCH}-lane run")
        agree_r, rel_r = fs.lane_agreement(p_cut, kr)
        if agree_r < fs.CARD_SHORT_AGREEMENT_MIN or rel_r > fs.ALPHA_REL_MAX:
            fail(f"phase 2: ragged batch at {warps} lanes per CTA disagrees "
                 f"with the plain version (lane agreement {agree_r:.4f}, "
                 f"alpha error {rel_r:.3g})")
    say(f"phase 2 ragged batch ({RAGGED_BATCH} lanes at {WARP_SHAPES} lanes "
        f"per CTA on the full grid, and on one CTA): bitwise equal to the "
        f"full batch's lanes; lane agreement with the plain version "
        f"{agree_r:.4f}")

    # -- phase 3: kernel against plain, full schedule ------------------
    phase_clock(3)
    cfg = bench.bench_config()
    basis, scns, args = random_args(cfg, FULL_BATCH, 1)
    k, k_ms = timed(lambda: fs.fused_solve(*args))
    p, p_ms = timed(lambda: fs.fused_solve_reference(*args))
    fsc = fleet.to_fleet(scns)
    zero = torch.zeros((), device=dev)

    def obstacle_cost(out):
        return float(fleet.fleet_cost(cfg, basis, fsc, Penalty(zero, zero),
                                      out.alpha.movedim(0, 1)).mean())

    k_conv = float(k.fulfilled.mean())
    p_conv = float(p.fulfilled.mean())
    k_cost, p_cost = obstacle_cost(k), obstacle_cost(p)
    exact_ok = fleet.fleet_constraints(cfg, basis, fsc, k.alpha.movedim(0, 1))
    phantom = float(((k.fulfilled[0] > 0.5) & ~exact_ok).float().mean())
    conv_band = max(0.02, min(0.15 * max(k_conv, p_conv), 0.05))
    agree3, _ = fs.lane_agreement(p, k)
    say(f"phase 3 full schedule ({FULL_BATCH} random scenes): converged "
        f"{k_conv:.4f} kernel vs {p_conv:.4f} plain (band {conv_band:.3f}); "
        f"mean obstacle cost {k_cost:.5f} vs {p_cost:.5f} (band 1%); "
        f"phantom {phantom:.2e} (bound {2.0 / FULL_BATCH:.2e}); lane "
        f"agreement {agree3:.4f} (bound >= {fs.CARD_FULL_AGREEMENT_MIN}); "
        f"kernel {k_ms:.1f} ms, plain {p_ms:.1f} ms")
    if not (abs(k_conv - p_conv) <= conv_band
            and agree3 >= fs.CARD_FULL_AGREEMENT_MIN
            and abs(k_cost - p_cost) <= 0.01 * abs(p_cost)
            and phantom <= 2.0 / FULL_BATCH
            and torch.isfinite(k.alpha).all()):
        fail("phase 3: kernel quality differs from the plain version's")

    # -- phase 4: the main path ----------------------------------------
    phase_clock(4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_solve.launches = 0
    out = bench.run_bench(batch=MAIN_BATCH, repeats=2)
    launches_k1 = fs.fused_solve.launches
    main_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    res, timing = out["result"], out["timing"]
    best = min(timing["times_s"])
    ref_avg, ref_max = mt.REFERENCE_FINAL_COST["bls"]
    finite = bool(torch.isfinite(res.alpha).all()
                  and torch.isfinite(res.stats.final_cost).all())
    say(f"phase 4 main path (reference scene x {MAIN_BATCH}): "
        f"{MAIN_BATCH / best:.1f} solves/s, {1e6 * best / MAIN_BATCH:.4f} "
        f"us/solve (best of {len(timing['times_s'])}: "
        f"{[round(t, 4) for t in timing['times_s']]} s), first run with "
        f"build {timing['first_s']:.2f}s, kernel build {build_s:.1f}s, "
        f"launches {launches_k1}; avg_cost {out['avg_cost']} max_cost "
        f"{out['max_cost']} endpoint_err {out['endpoint_err']}; peak device "
        f"memory {main_peak_gib:.3f} GiB; {out['device']}, "
        f"{out['power_limit']}")
    say(f"phase 4 strict bench.py verdict (endpoint < 0.01 and costs within "
        f"2%): {'PASS' if out['quality_ok'] else 'FAIL'}")
    if launches_k1 < 1:
        fail("phase 4: the main path did not launch the kernel")
    if not (finite and out["avg_cost"] <= ref_avg * 1.02
            and out["max_cost"] <= ref_max * 1.02
            and out["endpoint_err"] < 0.05):
        fail("phase 4: main-path output outside the quality bounds")
    # Every lane solves the same scene with the same code: all must equal
    # lane 0, so the lanes the quality readout does not score are held too.
    if not lanes_match_lane0((res.alpha, *res.stats), 0):
        fail("phase 4: the main path's lanes differ from lane 0")
    alpha0 = res.alpha[0].clone()
    stats0 = tuple(x[0].clone() for x in res.stats)
    main_sps = MAIN_BATCH / best

    # The kernel and its plain version on the main path's inputs.
    del out, res
    cfg = bench.bench_config()
    basis = mt.make_basis(cfg, device=dev)
    scn0 = mt.reference_scenario(cfg, device=dev)
    args = fleet.fused_args(cfg, basis, mt.replicate_scenario(scn0, MAIN_BATCH))
    k, main_ms = timed(lambda: fs.fused_solve(*args))
    if not (lanes_match_lane0(k, -1)
            and torch.equal(k.alpha[:, :, 0].T, alpha0)):
        fail("phase 4: the kernel's lanes differ from the main path's lane 0")
    kq = mt.solution_quality(cfg, basis, scn0, alpha0)
    k1_rounds = float((k.outer_iters + k.fulfilled).sum())
    k1_accepted = float(k.inner_iters.sum())
    del k
    p, main_plain_ms = timed(lambda: fs.fused_solve_reference(*args))
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles
    k1_bound = roofline.fused_rounds(
        MAIN_BATCH, T, J, O,
        roofline.kernel_counts(
            roofline.plain_tally(fs.fused_solve_reference, *args), k1_rounds,
            k1_accepted), True)
    pq = mt.solution_quality(cfg, basis, scn0, p.alpha[:, :, 0].T)
    gaps = [abs(float(pq[key]) - float(kq[key])) / float(kq[key])
            for key in ("avg_cost", "max_cost")]
    say(f"phase 4 kernel alone {main_ms:.1f} ms, plain version "
        f"{main_plain_ms:.1f} ms at batch {MAIN_BATCH}; every lane equals "
        f"lane 0; plain lane 0 avg/max {float(pq['avg_cost']):.5f}/"
        f"{float(pq['max_cost']):.5f} vs kernel {float(kq['avg_cost']):.5f}/"
        f"{float(kq['max_cost']):.5f} (gaps {gaps[0]:.2e}/{gaps[1]:.2e}, "
        f"bound 1e-2), plain endpoint_err {float(pq['endpoint_err']):.4f}")
    if not (torch.isfinite(p.alpha).all() and max(gaps) <= 0.01):
        fail("phase 4: the plain version's costs differ from the kernel's")

    del p, args
    torch.cuda.empty_cache()

    # -- phase 5: K2 against plain, one round -------------------------------
    phase_clock(5)
    cfg = mt.PlannerConfig(max_outer_iteration=1, max_inner_iteration=4,
                           fixed_iters=True, max_obstacles=11)
    _, _, args = random_args(cfg, SHORT_BATCH, 0)
    rargs = round_args(args, 4, seed=0)
    ful = rargs[7]
    k = fs.fused_round(*rargs)
    torch.cuda.synchronize()
    p = fs.fused_round_reference(*rargs)
    agree5, rel5, k2_abs_err = round_agreement(p, k, ful)
    say(f"phase 5 K2 one round ({SHORT_BATCH} random scenes, n_r 4, "
        f"{int((ful > 0.5).sum())} lanes fulfilled): lane agreement "
        f"{agree5:.4f} (bound >= {fs.CARD_SHORT_AGREEMENT_MIN}), alpha error "
        f"on agreeing lanes {k2_abs_err:.3g} abs, {rel5:.3g} of the lane's "
        f"scale (bound <= {fs.ALPHA_REL_MAX})")
    if agree5 < fs.CARD_SHORT_AGREEMENT_MIN or rel5 > fs.ALPHA_REL_MAX:
        fail("phase 5: K2 disagrees with its plain version")
    if not (torch.equal(k.alpha[:, :, ful[0] > 0.5], rargs[4][:, :, ful[0] > 0.5])
            and bool((k.inner[ful > 0.5] == 0).all())):
        fail("phase 5: K2 moved a lane that came in fulfilled")
    cut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x) and x.dim() > 1
           and x.shape[-1] == SHORT_BATCH else x for x in rargs]
    for warps, ctas in grid_shapes():
        kr = fs.fused_round(cut[0].replace(pallas_block_b=warps), *cut[1:],
                            ctas=ctas)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH]) for x, y in zip(kr, k)):
            fail(f"phase 5: {RAGGED_BATCH} lanes at {warps} lanes per CTA, "
                 f"{ctas or 'all'} CTAs differ from the same lanes of the "
                 f"{SHORT_BATCH}-lane run")
    say(f"phase 5 ragged batch ({RAGGED_BATCH} lanes at {WARP_SHAPES} lanes "
        f"per CTA on the full grid, and on one CTA): bitwise equal to the "
        f"full batch's lanes")

    # -- phase 6: the rounds driver against K1 ------------------------------
    phase_clock(6)
    cfg = bench.bench_config()
    _, _, args = random_args(cfg, FULL_BATCH, 2)
    k1 = fs.fused_solve(*args)
    want = fleet.kernel_result(k1)
    rounds = len(fs.inner_schedule(cfg))
    k2_ms, k2_ms_first, k2_plain_ms, k2_bound, k2_ms_warm = (
        rounds_driver_check(fs, fleet, roofline, cfg, args, want, "bls", 6,
                            "rounds driver", "K2"))
    del k1, want, args
    torch.cuda.empty_cache()

    # -- phase 7: the heterogeneous path ------------------------------------
    phase_clock(7)
    fs.fused_round.launches = 0
    fs.fused_solve.launches = 0
    with KernelTimer(fs, "fused_round") as timer:
        het = bench.run_bench(batch=MAIN_BATCH, repeats=2,
                              random_scenarios=True, seed=0,
                              quality_check_lanes=CHECK_LANES)
    het_launches = fs.fused_round.launches
    het_k1_launches = fs.fused_solve.launches
    times = het["timing"]["times_s"]
    gate = het["gate"]
    k2_solve_ms = timer.total_ms() / (1 + len(times))
    say(f"phase 7 heterogeneous path, compaction on ({MAIN_BATCH} random "
        f"scenes): {MAIN_BATCH / min(times):.1f} solves/s (best of "
        f"{[round(t, 4) for t in times]} s; first run "
        f"{het['timing']['first_s']:.2f} s), {het_launches} K2 launches, "
        f"{het_k1_launches} K1 launches; K2 {k2_solve_ms:.1f} ms per solve "
        f"(10 launches, CUDA events); converged {het['converged_frac']}, "
        f"mean final cost {het['mean_final_cost']}; {het['device']}, "
        f"{het['power_limit']}")
    b = gate["bands"]
    say(f"phase 7 paired xla gate on {CHECK_LANES} lanes (xla engine "
        f"{het['timing']['xla_s']:.2f} s): converged "
        f"{b['check_converged_frac']:.4f} vs xla {het['xla_converged_frac']} "
        f"(band {b['converged']:.4f}); obstacle cost "
        f"{b['check_obstacle_cost']:.5f} vs {b['xla_obstacle_cost']:.5f} "
        f"(band {b['cost']:.5f}); phantom {het['phantom_frac']} (bound "
        f"{b['phantom']:.2e}): {'PASS' if het['quality_ok'] else 'FAIL'}")
    if het_launches < 1:
        fail("phase 7: the heterogeneous path did not launch K2")
    # The gate's verdict fails the run after the other measurements.
    gate_ok = het["quality_ok"]
    res_on = het.pop("result")
    del het
    off = bench.run_bench(batch=MAIN_BATCH, repeats=2, random_scenarios=True,
                          seed=0, quality_check_lanes=0,
                          lane_compaction=False)
    res_off = off.pop("result")
    off_times = off["timing"]["times_s"]
    same = same_result(res_on, res_off)
    say(f"phase 7 compaction off: {MAIN_BATCH / min(off_times):.1f} solves/s "
        f"(best of {[round(t, 4) for t in off_times]} s); per-lane results "
        f"equal the compacted run's bit for bit: {same}")
    if not same:
        fail("phase 7: compaction changed per-lane results")
    del res_off
    cfg = bench.bench_config()
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0),
                               MAIN_BATCH, device=dev)
    args = fleet.fused_args(cfg, basis, scns)
    k1, k1_ms = timed(lambda: fs.fused_solve(*args))
    same = same_result(res_on, fleet.kernel_result(k1))
    say(f"phase 7 K1 whole solve on the same scenes: {k1_ms:.1f} ms "
        f"({MAIN_BATCH / k1_ms * 1e3:.1f} solves/s), equal to the rounds "
        f"driver's result bit for bit: {same}")
    if not same:
        fail("phase 7: K1 and the rounds driver differ")
    # Compaction's cost, as the bench times a solve, in COMPACTION_PAIRS
    # pairs whose order alternates (on, off / off, on / ...) on these scenes.
    runs = {c: fleet.make_fleet_solver(cfg.replace(lane_compaction=c), basis,
                                       backend="fused") for c in (True, False)}
    pair_s = {True: [], False: []}
    for i in range(COMPACTION_PAIRS):
        for c in ((True, False) if i % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            runs[c](scns)
            torch.cuda.synchronize()
            pair_s[c].append(time.perf_counter() - t0)
    ratios = sorted(on / off for on, off in zip(pair_s[True], pair_s[False]))
    say(f"phase 7 compaction in {COMPACTION_PAIRS} alternating pairs: on "
        f"median {statistics.median(pair_s[True]):.4f} s "
        f"{[round(t, 4) for t in pair_s[True]]}, off median "
        f"{statistics.median(pair_s[False]):.4f} s "
        f"{[round(t, 4) for t in pair_s[False]]}; on/off per pair median "
        f"{statistics.median(ratios):.4f}, range {ratios[0]:.4f}-"
        f"{ratios[-1]:.4f}")
    del runs
    # Bounds at the full width from K1's own counts (rounds run, accepted
    # steps) and the plain version's tally of stops and rungs on the first
    # TALLY_LANES scenes, scaled to the batch: K1's, and K2's over the ten
    # launches of a solve (the same work: the rounds driver equals K1).
    sub = roofline.plain_tally(fs.fused_solve_reference, cfg, *args[1:4],
                      *(x[..., :TALLY_LANES] for x in args[4:]))
    scale = MAIN_BATCH / TALLY_LANES
    tally = roofline.kernel_counts({k: v * scale for k, v in sub.items()},
                          float((k1.outer_iters + k1.fulfilled).sum()),
                          float(k1.inner_iters.sum()))
    k1_rand_bound = roofline.fused_rounds(MAIN_BATCH, T, J, O, tally, True)
    rounds_run = (k1.outer_iters + k1.fulfilled)[0]
    live = [float((rounds_run > r).sum()) for r in range(rounds)]
    k2_rand_bound = roofline.fused_round_launches(MAIN_BATCH, T, J, O, tally,
                                                  live)
    say(f"phase 7 bounds at {MAIN_BATCH} random scenes (plain tally on "
        f"{TALLY_LANES} lanes x {scale:g}): K1 {k1_rand_bound.ms:.1f} ms by "
        f"{k1_rand_bound.by}; K2 per solve ({rounds} launches, live lanes "
        f"{[int(x) for x in live]}) {k2_rand_bound.ms:.1f} ms by "
        f"{k2_rand_bound.by}; work {({k: round(v) for k, v in tally.items()})}")
    if not (torch.isfinite(res_on.alpha).all()
            and torch.isfinite(res_on.stats.final_cost).all()):
        fail("phase 7: non-finite output")
    if not gate_ok:
        fail("phase 7: the paired xla gate failed")
    del res_on, k1, args, scns
    torch.cuda.empty_cache()

    # -- phase 8: K5 and K6 against plain ------------------------------------
    phase_clock(8)
    cfg = mt.PlannerConfig(max_outer_iteration=1, max_inner_iteration=4,
                           fixed_iters=True, max_obstacles=11)
    _, _, args = random_args(cfg, SHORT_BATCH, 0)
    rargs = round_args(args, 4, seed=0)
    _, kv, kvt, mix, a0, _, _, start, goal, ox, oy, ow = args
    lsg, ljl, ful, lr0 = rargs[5:9]
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    ek = sk.cost_grad_eval(cfg, *eargs)
    fk = sk.forward_eval(cfg, kv, mix, a0)
    torch.cuda.synchronize()
    ep = sk.cost_grad_eval_reference(cfg, *eargs)
    fp = sk.forward_eval_reference(cfg, kv, mix, a0)
    k5_err = eval_errors(ek, ep)
    k6_abs_err = planes_error(fk, fp)
    say(f"phase 8 K5/K6 against plain ({SHORT_BATCH} random scenes, "
        f"penalties x1/x10/x100): K5 loss {k5_err['loss']:.3g} relative, "
        f"grad {k5_err['grad']:.3g} of the lane's scale, traj/vel "
        f"{k5_err['planes']:.3g} abs (bounds {EVAL_BOUNDS}); K6 traj/vel "
        f"{k6_abs_err:.3g} abs (bound {EVAL_BOUNDS['planes']})")
    if not (eval_ok(k5_err) and k6_abs_err <= EVAL_BOUNDS["planes"]):
        fail("phase 8: K5 or K6 disagrees with its plain version")
    k6_vs_k5(fk, ek, 8, SHORT_BATCH)
    cut = [x[..., :RAGGED_BATCH] if x.shape[-1] == SHORT_BATCH else x
           for x in eargs]
    for bt in (64, 128, 256):
        cb = cfg.replace(pallas_block_b=bt)
        er = sk.cost_grad_eval(cb, *cut)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH]) for x, y in zip(er, ek)):
            fail(f"phase 8: {RAGGED_BATCH} lanes at {bt} threads per CTA "
                 f"differ from the same lanes of the {SHORT_BATCH}-lane run")
    k6_ragged(sk, cfg, kv, mix, a0, fk, 8)
    say(f"phase 8 ragged batch ({RAGGED_BATCH} lanes at 64/128/256 threads: "
        f"2/4/8 lanes per CTA): K5 bitwise equal to the full batch's lanes")

    # The main path's inputs at full width: the replicated reference scene
    # at the warm start, under the bench's config.
    mcfg = bench.bench_config()
    basis = mt.make_basis(mcfg, device=dev)
    scn0 = mt.reference_scenario(mcfg, device=dev)
    margs = fleet.fused_args(mcfg, basis,
                             mt.replicate_scenario(scn0, MAIN_BATCH))[1:]
    mkv, mkvt, mmix, ma0, mlsg, mljl = margs[:6]
    mtail = margs[4:]
    meargs = (mkv, mkvt, mmix, ma0, *mtail)
    mev = sk.PallasEval(torch.empty_like(mlsg),
                        *(torch.empty_like(ma0) for _ in range(3)))
    k5_ms = best_ms(lambda: sk.cost_grad_eval(mcfg, *meargs, out=mev))
    k6_out = sk.PallasForward(torch.empty_like(ma0), torch.empty_like(ma0))
    k6_ms = best_ms(lambda: sk.forward_eval(mcfg, mkv, mmix, ma0, out=k6_out))
    k6_lib_ms = best_ms(lambda: torch.einsum("st,jtb,ji->isb", mkv, ma0, mmix))
    # The plain versions on the same inputs: a first call to compare with
    # the kernels' outputs (mev and k6_out hold the last timed launch's),
    # then a timed one.
    k5_full_err = eval_errors(mev, sk.cost_grad_eval_reference(mcfg, *meargs))
    _, k5_plain_ms = timed(lambda: sk.cost_grad_eval_reference(mcfg, *meargs))
    k6_full_err = planes_error(k6_out, sk.forward_eval_reference(mcfg, mkv,
                                                                 mmix, ma0))
    _, k6_plain_ms = timed(lambda: sk.forward_eval_reference(mcfg, mkv, mmix,
                                                             ma0))
    k5_bound = roofline.cost_grad_eval(MAIN_BATCH, T, J, O)
    k6_bound = roofline.forward_eval(MAIN_BATCH, T, J)
    say(f"phase 8 at {MAIN_BATCH} lanes (main path's inputs, best of "
        f"{TIMED_LAUNCHES}): K5 {k5_ms:.3f} ms (plain {k5_plain_ms:.1f} ms, "
        f"bound {k5_bound.ms:.3f} ms by {k5_bound.by}); K6 {k6_ms:.3f} ms "
        f"(plain {k6_plain_ms:.1f} ms, one torch.einsum {k6_lib_ms:.3f} ms, "
        f"bound {k6_bound.ms:.3f} ms by {k6_bound.by}: "
        f"{k6_bound.ms / k6_ms:.3f} of it)")
    k6_vs_k5(k6_out, mev, 8, MAIN_BATCH)
    say(f"phase 8 at {MAIN_BATCH} lanes against plain: K5 loss "
        f"{k5_full_err['loss']:.3g} relative, grad {k5_full_err['grad']:.3g} "
        f"of the lane's scale, traj/vel {k5_full_err['planes']:.3g} abs; K6 "
        f"traj/vel {k6_full_err:.3g} abs (bounds {EVAL_BOUNDS})")
    if not (eval_ok(k5_full_err) and k6_full_err <= EVAL_BOUNDS["planes"]):
        fail(f"phase 8: K5 or K6 disagrees with its plain version at "
             f"{MAIN_BATCH} lanes")
    k5_abs_err = max(k5_err["abs"], k5_full_err["abs"])
    k6_abs_err = max(k6_abs_err, k6_full_err)

    # -- phase 9: K3 and K4 against plain, one step --------------------------
    phase_clock(9)
    gd_lrs = torch.tensor(cfg.gd_lr[:4])[
        torch.randint(0, 4, (1, SHORT_BATCH),
                      generator=torch.Generator().manual_seed(1))].to(dev)
    step_abs_err = {}
    for name, lr in (("bls", lr0), ("gd", gd_lrs)):
        fn, ref = step_fns(sk, name)
        sargs = (kv, kvt, mix, a0, ek.grad, ek.traj, ek.vel, ek.loss, lr, ful,
                 lsg, ljl, start, goal, ox, oy, ow)
        k = fn(cfg, *sargs)
        torch.cuda.synchronize()
        p = ref(cfg, *sargs)
        frozen = ful[0] > 0.5
        if not all(torch.equal(x[..., frozen], y[..., frozen])
                   for x, y in zip(k, sargs[3:10])):
            fail(f"phase 9: {name} step moved a frozen lane")
        agree, err = step_errors(p, k)
        say(f"phase 9 {name} one step ({SHORT_BATCH} random scenes, "
            f"{int(frozen.sum())} frozen, {int((k.minimized - ful).sum())} "
            f"stop): frozen lanes bitwise unchanged; "
            f"{step_summary(agree, err)}")
        if not step_ok(agree, err):
            fail(f"phase 9: the {name} step disagrees with its plain version")
        step_abs_err[name] = err["abs"]
        cut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x)
               and x.shape[-1] == SHORT_BATCH else x for x in sargs]
        for bt in step_blocks(name):
            kr = fn(cfg.replace(pallas_block_b=bt), *cut)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                       for x, y in zip(kr, k)):
                fail(f"phase 9: {name}, {RAGGED_BATCH} lanes at {bt} threads "
                     f"per CTA differ from the full batch's")
    say(f"phase 9 ragged batch ({RAGGED_BATCH} lanes): K3 at "
        f"{[sk.bls_step_plan(cfg.replace(pallas_block_b=bt), 11)['lanes'] for bt in step_blocks('bls')]}"
        f", K4 at "
        f"{[sk.gd_step_plan(cfg.replace(pallas_block_b=bt), 11)['lanes'] for bt in step_blocks('gd')]}"
        f" lanes (warps) per CTA, bitwise equal to the full batch's lanes")
    del ek, fk, ep, fp, args, rargs, eargs, cut

    # Each step kernel at full width from K5's state (mev) on the main
    # path's inputs (round 0, step 0: every lane live), against its plain
    # version.
    mlive = torch.zeros_like(mlsg)
    step_time = {}
    for name, lr in (("bls", torch.full_like(mlsg, mcfg.bls_lr_start)),
                     ("gd", torch.full_like(mlsg, mcfg.gd_lr[0]))):
        fn, ref = step_fns(sk, name)
        state0 = (ma0, *mev[1:], mev.loss, lr, mlive)
        ms, step_plain_ms, tally, agree, err = full_width_step(
            fn, ref, mcfg, (mkv, mkvt, mmix), state0, mtail)
        bound = (roofline.bls_inner_step if name == "bls"
                 else roofline.gd_inner_step)(MAIN_BATCH, T, J, O, tally)
        step_time[name] = (ms, step_plain_ms, bound)
        say(f"phase 9 {name} step at {MAIN_BATCH} lanes (main path's inputs, "
            f"round 0 step 0, best of {TIMED_LAUNCHES}): {ms:.3f} ms, plain "
            f"{step_plain_ms:.1f} ms, bound {bound.ms:.3f} ms by {bound.by} "
            f"({', '.join(f'{k} {float(v.sum()):.0f}' for k, v in tally.items())}); "
            f"against plain: {step_summary(agree, err)}")
        if not step_ok(agree, err):
            fail(f"phase 9: the {name} step disagrees with its plain version "
                 f"at {MAIN_BATCH} lanes")
        step_abs_err[name] = max(step_abs_err[name], err["abs"])
        del state0, tally
    del mev, k6_out, margs, meargs, mtail, ma0
    torch.cuda.empty_cache()

    # -- phases 10 and 11: the per-step paths --------------------------------
    paths = {}
    for phase, solver in ((10, "bls"), (11, "gd")):
        phase_clock(phase)
        step = "bls_inner_step" if solver == "bls" else "gd_inner_step"
        names = [step, "cost_grad_eval"] + (["forward_eval"] if solver == "bls"
                                            else [])
        for n in names:
            getattr(sk, n).launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with KernelTimer(sk, *names) as timer:
            out = bench.run_bench(batch=MAIN_BATCH, repeats=2, solver=solver,
                                  backend="pallas")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches = {n: getattr(sk, n).launches for n in names}
        res, timing = out["result"], out["timing"]
        solves = 1 + len(timing["times_s"])
        per_solve = {n: timer.total_ms(n) / solves for n in names}
        best = min(timing["times_s"])
        ref_avg, ref_max = mt.REFERENCE_FINAL_COST[solver]
        strict = bench.endpoint_bound(bench.bench_config(), solver)
        say(f"phase {phase} {solver} per-step path (reference scene x "
            f"{MAIN_BATCH}): {MAIN_BATCH / best:.1f} solves/s, "
            f"{1e6 * best / MAIN_BATCH:.4f} us/solve (best of "
            f"{[round(t, 4) for t in timing['times_s']]} s; first run "
            f"{timing['first_s']:.2f} s); launches over {solves} solves "
            f"{launches}; kernel ms per solve "
            f"{ {n: round(v, 1) for n, v in per_solve.items()} }; avg_cost "
            f"{out['avg_cost']} max_cost {out['max_cost']} endpoint_err "
            f"{out['endpoint_err']}; peak device memory {peak_gib:.3f} GiB; "
            f"{out['device']}, {out['power_limit']}")
        say(f"phase {phase} strict bench.py verdict (endpoint < {strict} and "
            f"costs within 2%): {'PASS' if out['quality_ok'] else 'FAIL'}")
        if min(launches.values()) < 1:
            fail(f"phase {phase}: the {solver} per-step path did not launch "
                 f"every kernel: {launches}")
        finite = bool(torch.isfinite(res.alpha).all()
                      and torch.isfinite(res.stats.final_cost).all())
        if not (finite and out["avg_cost"] <= ref_avg * 1.02
                and out["max_cost"] <= ref_max * 1.02
                and out["endpoint_err"] < 0.05):
            fail(f"phase {phase}: {solver} per-step output outside the "
                 f"quality bounds")
        if not lanes_match_lane0((res.alpha, *res.stats), 0):
            fail(f"phase {phase}: the {solver} per-step lanes differ from "
                 f"lane 0")
        del out, res
        het = bench.run_bench(batch=MAIN_BATCH, repeats=1, solver=solver,
                              backend="pallas", random_scenarios=True, seed=0,
                              quality_check_lanes=CHECK_LANES)
        b = het["gate"]["bands"]
        say(f"phase {phase} {solver} per-step path on {MAIN_BATCH} random "
            f"scenes: {MAIN_BATCH / min(het['timing']['times_s']):.1f} "
            f"solves/s; converged {het['converged_frac']}; paired xla gate on "
            f"{CHECK_LANES} lanes (xla engine {het['timing']['xla_s']:.2f} s): "
            f"converged {b['check_converged_frac']:.4f} vs xla "
            f"{het['xla_converged_frac']} (band {b['converged']:.4f}); "
            f"obstacle cost {b['check_obstacle_cost']:.5f} vs "
            f"{b['xla_obstacle_cost']:.5f} (band {b['cost']:.5f}); phantom "
            f"{het['phantom_frac']} (bound {b['phantom']:.2e}): "
            f"{'PASS' if het['quality_ok'] else 'FAIL'}")
        if not het["quality_ok"]:
            fail(f"phase {phase}: the {solver} per-step paired xla gate "
                 f"failed")
        del het
        if solver == "bls":
            # K1-BLS against the per-step BLS path (K5 per round, K3 per
            # step, K6 per round) on FULL_BATCH random scenes at the bench's
            # schedule: the same carry program, bit for bit (phase 13 holds
            # GD's, phase 16 the exact ladder's).
            rcfg = bench.bench_config()
            rbasis, rscns, rargs = random_args(rcfg, FULL_BATCH, 1)
            want = fleet.kernel_result(fs.fused_solve(*rargs))
            n3 = sk.bls_inner_step.launches
            got = fleet.fleet_solve(rcfg, rbasis, rscns, backend="pallas")
            bitwise = same_result(got, want)
            say(f"phase 10 K1-BLS against the per-step BLS path (K5 + K3 + "
                f"K6) on {FULL_BATCH} random scenes: bitwise equal {bitwise} "
                f"({sk.bls_inner_step.launches - n3} K3 launches); converged "
                f"{float(want.stats.converged.float().mean()):.4f}")
            if not bitwise:
                fail("phase 10: K1-BLS and the per-step BLS path differ")
            del want, got, rargs, rscns
        torch.cuda.empty_cache()
        paths[solver] = (launches, per_solve, peak_gib)

    gd = gd_phases(mt, bench, fs, sk, roofline, fleet, dev, random_args,
                   occupancy)
    exact = exact_phases(mt, bench, fs, sk, roofline, fleet, dev, random_args,
                         occupancy)
    large, tier_inputs = large_t_phases(mt, bench, fs, sk, roofline, fleet,
                                        dev, ptxas)
    tiers = tier_phases(mt, bench, fs, roofline, fleet, dev, tier_inputs)
    entry = entry_point_phases(mt, fs, fleet, dev)
    shards = sharded_phase(mt, fs, fleet, dev, alpha0, stats0, main_sps)
    joints = joints_phase(mt, bench, fs, sk, roofline, fleet, dev,
                          joint_builds)
    benches = benchmarks_phase(mt, bench, fs, sk, roofline, fleet, dev,
                               variant_builds, alpha0)
    phase_clock(None)

    def at_j(*names):
        """Phase 21's entries of the kernel ``names`` (its programs), by
        J."""
        return {J: {n: joints[n][J] for n in names if J in joints.get(n, {})}
                for J in sorted({J for n in names for J in joints.get(n, {})})}

    bl = benches["launches"]
    kernels = [
        kernel_entry("fused_solve", "fused_solve.cu", 1606, launches_k1,
                     max_abs_err, main_ms, main_plain_ms, k1_bound,
                     ms_1M_random=k1_ms, bound_ms_1M_random=k1_rand_bound.ms,
                     main_path_peak_gib=main_peak_gib,
                     occupancy=occupancy["fused_solve", "bls"],
                     gd=gd["fused_solve"], exact=exact["fused_solve"],
                     streamed=large["fused_solve"],
                     tiers=tiers["fused_solve"], entry_points=entry,
                     sharded=shards,
                     joints=at_j("fused_solve", "fused_solve_gd",
                                 "fused_solve_exact"),
                     built_basis=joints["basis"], builds=joints["build"],
                     ablated=benches["ablated"],
                     launches_benchmarks=bl["fused_solve"]),
        kernel_entry("fused_round", "fused_solve.cu", 1674, het_launches,
                     k2_abs_err, k2_ms, k2_plain_ms, k2_bound,
                     ms_first_reading=k2_ms_first, ms_warm_up=k2_ms_warm,
                     ms_per_solve_1M_random=k2_solve_ms,
                     bound_ms_per_solve_1M_random=k2_rand_bound.ms,
                     occupancy=occupancy["fused_round", "bls"],
                     gd=gd["fused_round"], exact=exact["fused_round"],
                     streamed=large["fused_round"],
                     tiers=tiers["fused_round"],
                     joints=at_j("fused_round", "fused_round_gd"),
                     launches_benchmarks=bl["fused_round"]),
        kernel_entry("bls_inner_step", "step_kernels.cu", 1239,
                     paths["bls"][0]["bls_inner_step"], step_abs_err["bls"],
                     *step_time["bls"], exact=exact["bls_inner_step"],
                     streamed=large["bls_inner_step"],
                     ptxas={k: v for k, v in ptxas.items()
                            if k.startswith("bls_step")},
                     occupancy={
                         "linearized": occupancy["bls_inner_step"],
                         "exact": occupancy["bls_inner_step_exact"]},
                     path_peak_gib=paths["bls"][2],
                     joints=at_j("bls_inner_step"),
                     launches_benchmarks=bl["bls_inner_step"]),
        kernel_entry("gd_inner_step", "step_kernels.cu", 1083,
                     paths["gd"][0]["gd_inner_step"], step_abs_err["gd"],
                     *step_time["gd"], streamed=large["gd_inner_step"],
                     ptxas={k: v for k, v in ptxas.items()
                            if k.startswith("gd_step")},
                     occupancy=occupancy["gd_inner_step"],
                     path_peak_gib=paths["gd"][2],
                     joints=at_j("gd_inner_step"),
                     launches_benchmarks=bl["gd_inner_step"]),
        # K5 runs on both per-step paths: ``launches`` is the BLS path's
        # count, the GD path's stands beside it.
        kernel_entry("cost_grad_eval", "step_kernels.cu", 1821,
                     paths["bls"][0]["cost_grad_eval"], k5_abs_err, k5_ms,
                     k5_plain_ms, k5_bound, launches_by_path={
                         s: paths[s][0]["cost_grad_eval"] for s in paths},
                     streamed=large["cost_grad_eval"],
                     ptxas={k: v for k, v in ptxas.items()
                            if k.startswith("cost_grad_eval")},
                     occupancy=occupancy["cost_grad_eval"],
                     joints=at_j("cost_grad_eval"),
                     launches_benchmarks=bl["cost_grad_eval"]),
        kernel_entry("forward_eval", "step_kernels.cu", 1767,
                     paths["bls"][0]["forward_eval"], k6_abs_err, k6_ms,
                     k6_plain_ms, k6_bound, library_ms=k6_lib_ms,
                     streamed=large["forward_eval"],
                     ptxas={k: v for k, v in ptxas.items()
                            if k.startswith("forward_eval")},
                     occupancy=occupancy["forward_eval"],
                     fraction_of_bound=k6_bound.ms / k6_ms,
                     joints=at_j("forward_eval"),
                     launches_benchmarks=bl["forward_eval"]),
        {**large["k7"], "joints": at_j("k7")},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    if not all(math.isfinite(x) for e in kernels
               for d in (e, e.get("gd", e), e.get("exact", e),
                         e.get("streamed", e), *e.get("tiers", {}).values())
               for x in (d["ms"], d["plain_ms"], d["bound_ms"])):
        fail("kernel time not finite")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# Phase 19, the entry points above the fleet engine: the CLI's batch on
# the fused backend, the replanner's ticks and fleet, the vmap engine's
# batch and the paired check's lanes of its bench run.
CLI_BATCH = 65536
REPLAN_TICKS = 100
REPLAN_FLEET = 256
VMAP_BATCH = 65536
VMAP_CHECK = 8192
INIT_FIT_MAX = 1e-2


def k1_instantiation(fs, cfg, O):
    """The name of the K1 instantiation a launch at cfg with O obstacle
    slots runs (csrc/fused_solve.cu kernel_of, warp_body.cuh specialised)."""
    src = open(os.path.join(os.path.dirname(fs.__file__), "..", "csrc",
                            "warp_body.cuh")).read()
    spec_t = int(re.search(r"#define WB_SPEC_T (\d+)", src).group(1))
    spec_o = int(re.search(r"#define WB_SPEC_O (\d+)", src).group(1))
    prog = fs.program(cfg, "bls", False, False, False)
    if fs.launch_plan(cfg, O, prog=prog)["plan"] == "streamed":
        return f"fused_solve<{prog},0,0,streamed>"
    if (cfg.n_timesteps, O) == (spec_t, spec_o):
        return f"fused_solve<{prog},{spec_t},{spec_o}>"
    return f"fused_solve<{prog},0,0>"


def run_cli(cli, args):
    """cli.main(args) in this process: (exit code, stdout, stderr)."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, out.getvalue(), err.getvalue()


def cli_report(text):
    """The CLI's printed report: ms of the timed solve, avg/max cost and the
    endpoint error (the larger of the start and goal errors)."""
    ms = float(re.search(r"took ([0-9.e+-]+) ms", text).group(1))
    m = re.search(r"result cost: \( avg ([0-9.e+-]+) , max ([0-9.e+-]+) \)",
                  text)
    errs = [float(re.search(rf"{k}: ([0-9.e+-]+)", text).group(1))
            for k in ("start_pos_err", "goal_pos_err")]
    return ms, float(m.group(1)), float(m.group(2)), max(errs)


def entry_point_phases(mt, fs, fleet, dev):
    """Phase 19: the entry points above the fleet engine:
    init_alpha's fit on the card, the CLI (single scene BLS and GD, the
    plain loop with its series, a 65,536-scene batch on the fused backend),
    the replanner on K1 (replan_bench's protocol, single scene and a fleet
    of 256) and the bench's vmap engine at 65,536 random scenes.  Returns
    the numbers for K1's kernels-line entry."""
    import tempfile

    from irm_motion_planning_tpu_torch import bench, cli
    from irm_motion_planning_tpu_torch.benchmarks import (
        replan as replan_bench)
    from irm_motion_planning_tpu_torch.ops import _build

    phase_clock(19)
    out = {}
    # (a) init_alpha: the smoothstep line fitted through the ~1e15-
    # conditioned Gram matrix, on the card (cuSOLVER) and on the CPU
    # (LAPACK), held by the trajectory it evaluates to.
    cfg = mt.PlannerConfig()
    fit, alphas = {}, {}
    for where in ("cuda", "cpu"):
        basis = mt.make_basis(cfg, device=where)
        scn = mt.reference_scenario(cfg, device=where)
        a = mt.init_alpha(cfg, basis, scn.start, scn.goal)
        line = scn.start + (scn.goal - scn.start) * basis.c[:, None]
        fit[where] = float((mt.evaluate(cfg, basis, a)[0] - line).abs().max())
        alphas[where] = a.cpu()
    alpha_gap = float((alphas["cuda"] - alphas["cpu"]).abs().max())
    say(f"phase 19 init_alpha line fit max|evaluate(init_alpha) - line|: "
        f"card {fit['cuda']:.3e}, CPU {fit['cpu']:.3e} (JAX's LU 4.6e-3, "
        f"rank-2 3.3e-3; bound {INIT_FIT_MAX}); alpha card vs CPU max abs "
        f"{alpha_gap:.4g} of {float(alphas['cpu'].abs().max()):.4g}")
    if not fit["cuda"] <= INIT_FIT_MAX:
        fail(f"phase 19: init_alpha's fit on the card {fit['cuda']:.3e} "
             f"over {INIT_FIT_MAX}")
    out["init_alpha_fit"] = fit

    # (b) the CLI's single-scene default (sequential BLS, plain PyTorch on
    # the card), GD, and the plain loop with its series file.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out["cli"] = {}
    for name, extra in (("bls", []), ("gd", ["--optimizer-name", "gd"]),
                        ("plain_gd", ["--optimizer-name", "gd", "--jit-loop",
                                      "false", "--extended-vis", "true",
                                      "--max-outer-iteration", "2",
                                      "--max-inner-iteration", "50"])):
        files = ["--output", os.path.join(tmp, f"{name}.txt"),
                 "--series-output", os.path.join(tmp, f"{name}_series.txt")]
        rc, text, err = run_cli(cli, extra + files)
        if rc != 0:
            fail(f"phase 19: cli {' '.join(extra)} exited {rc}: {err[-500:]}")
        ms, avg, mx, ep = cli_report(text)
        traj = np.loadtxt(os.path.join(tmp, f"{name}.txt"))
        if traj.shape != (cfg.n_timesteps, cfg.n_joints) or not np.isfinite(
                traj).all():
            fail(f"phase 19: cli {name} wrote a trajectory of shape "
                 f"{traj.shape}")
        if name == "plain_gd":
            series = np.loadtxt(os.path.join(tmp, f"{name}_series.txt"))
            if series.ndim != 2 or series.shape[1] != traj.size or not (
                    series[-1].reshape(traj.shape) == traj).all():
                fail("phase 19: the plain loop's series file does not end "
                     "at its trajectory")
            say(f"phase 19 cli --jit-loop false (GD, 2 x 50): {ms:.1f} ms, "
                f"{series.shape[0]} trajectories in the series file")
            out["cli"][name] = {"ms": ms, "series": series.shape[0]}
            continue
        ref_avg, ref_max = mt.REFERENCE_FINAL_COST[name]
        strict = avg <= ref_avg * 1.001 and mx <= ref_max * 1.001
        say(f"phase 19 cli {name} single scene on the card: {ms:.1f} ms per "
            f"solve; avg/max {avg:.5f}/{mx:.5f} ({100 * (avg / ref_avg - 1):+.3f}"
            f"%/{100 * (mx / ref_max - 1):+.3f}% over the reference's), "
            f"endpoint {ep:.4f}; the goldens' 0.1% gate "
            f"{'PASS' if strict else 'FAIL'} (ROADMAP queue 3), the bench's "
            f"2% and endpoint < 0.05 required")
        if not (avg <= ref_avg * 1.02 and mx <= ref_max * 1.02 and ep < 0.05):
            fail(f"phase 19: cli {name} outside the bench's reference-scene "
                 f"gate")
        out["cli"][name] = {"ms": ms, "avg_cost": avg, "max_cost": mx,
                            "endpoint_err": ep, "strict_0.1pct": strict}

    # (c) the CLI's batch on the fleet engine's fused backend: K1 (the
    # CLI's default config: early exit, 16 obstacle slots).
    fs.fused_solve.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rc, text, err = run_cli(cli, [
        "--batch", str(CLI_BATCH), "--engine", "fleet", "--backend", "fused",
        "--output", os.path.join(tmp, "batch.txt")])
    launches = fs.fused_solve.launches
    if rc != 0:
        fail(f"phase 19: cli --batch exited {rc}: {err[-500:]}")
    ms, avg, mx, ep = cli_report(text)
    summary = re.search(r"batch \d+: .*", text).group(0)
    inst = k1_instantiation(fs, cfg, cfg.max_obstacles)
    say(f"phase 19 cli --batch {CLI_BATCH} --engine fleet --backend fused: "
        f"{ms:.1f} ms per solve ({CLI_BATCH / ms * 1e3:.1f} solves/s), K1 "
        f"launches {launches} ({inst}), {summary}; lane 0 avg/max "
        f"{avg:.5f}/{mx:.5f} endpoint {ep:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches < 1:
        fail("phase 19: the CLI's fused batch did not launch K1")
    if not (math.isfinite(avg) and math.isfinite(mx) and ep < 0.05):
        fail("phase 19: the CLI's fused batch output not finite or its "
             "endpoint over 0.05")
    out["cli"]["batch_fused"] = {"lanes": CLI_BATCH, "ms": ms,
                                 "launches": launches, "instantiation": inst}

    # (d) replan_bench's protocol on K1: 100 warm-started ticks of the
    # drifting reference scene, one scene (padded to 128 lanes) and a fleet
    # of 256; every tick's result held to the plain version on the same
    # inputs; the rollout bit for bit the tick loop; the library built once.
    rcfg = replan_bench.bench_config()
    scn1 = mt.reference_scenario(rcfg, device=dev)
    lib = _build.load_library()
    real_build, builds = _build.build, []
    _build.build = lambda *a, **k: builds.append(1) or real_build(*a, **k)
    out["replan"] = {}
    try:
        for mode, batched, scn in (
                ("single", False, scn1),
                ("fleet", True, mt.replicate_scenario(scn1, REPLAN_FLEET))):
            rp = replan_bench.make_replanner(rcfg, batched, "fleet", "fused",
                                             dev)
            tcfg, basis = rp.tick_cfg, rp.basis
            rp.plan(replan_bench.drift_obstacles(scn, 0))
            torch.cuda.synchronize()
            fs.fused_solve.launches = 0
            tick_s, costs, loop, plain_gap = [], [], [], 0.0
            for k in range(1, REPLAN_TICKS + 1):
                tick = replan_bench.drift_obstacles(scn, k)
                alpha0 = rp._alpha
                t0 = time.perf_counter()
                res = rp.plan(tick)
                torch.cuda.synchronize()
                tick_s.append(time.perf_counter() - t0)
                costs.append(float(res.stats.final_cost.float().mean()))
                loop.append(res)
                lanes = rp.last_padded if not batched else res
                if not lanes_match_lane0((lanes.alpha, *lanes.stats), 0):
                    fail(f"phase 19: replan {mode} tick {k}: the padded "
                         f"lanes differ from lane 0")
                # The plain version of the tick's kernel on lane 0's inputs.
                one = mt.Scenario(*((x[:1] if batched else x[None])
                                    for x in tick))
                a1 = alpha0[:1] if batched else alpha0[None]
                p = fleet.kernel_result(fs.fused_solve_reference(
                    *fleet.fused_args(tcfg, basis, one, a1)))
                s0 = mt.Scenario(*(x[0] for x in one))
                kq = mt.solution_quality(tcfg, basis, s0, lanes.alpha[0])
                pq = mt.solution_quality(tcfg, basis, s0, p.alpha[0])
                gap = max(abs(float(pq[q]) - float(kq[q])) / float(kq[q])
                          for q in ("avg_cost", "max_cost"))
                plain_gap = max(plain_gap, gap)
                if not gap <= 0.01:
                    fail(f"phase 19: replan {mode} tick {k}: the plain "
                         f"version's avg/max cost {gap:.2e} from the "
                         f"kernel's")
            launches = fs.fused_solve.launches
            summ = replan_bench.summary(tick_s, costs)
            if launches != REPLAN_TICKS:
                fail(f"phase 19: replan {mode}: {launches} K1 launches in "
                     f"{REPLAN_TICKS} ticks")
            # The rollout: a second replanner, the same warm-up tick, then
            # the ticks in one plan_rollout call.
            rp2 = replan_bench.make_replanner(rcfg, batched, "fleet", "fused",
                                              dev)
            rp2.plan(replan_bench.drift_obstacles(scn, 0))
            torch.cuda.synchronize()
            ticks = replan_bench.stack_ticks(scn, REPLAN_TICKS)
            t0 = time.perf_counter()
            final, stats = rp2.plan_rollout(ticks)
            torch.cuda.synchronize()
            roll_s = time.perf_counter() - t0
            if not (torch.equal(final, loop[-1].alpha) and all(
                    torch.equal(f[k], g) for k, r in enumerate(loop)
                    for f, g in zip(stats, r.stats))):
                fail(f"phase 19: replan {mode}: the rollout differs from the "
                     f"tick loop")
            entry = {**summ, "launches": launches,
                     "rollout_hz": REPLAN_TICKS / roll_s,
                     "rollout_tick_ms": 1e3 * roll_s / REPLAN_TICKS,
                     "plain_max_cost_gap": plain_gap,
                     "lanes": tick_lanes(batched, scn),
                     "instantiation": k1_instantiation(fs, tcfg,
                                                       tcfg.max_obstacles)}
            out["replan"][mode] = entry
            say(f"phase 19 replan {mode} ({entry['lanes']} lanes, "
                f"{entry['instantiation']}, early exit, 2 x 25): "
                f"{summ['value']:.1f} Hz, ms per tick median "
                f"{summ['tick_ms_median']:.3f} p99 {summ['tick_ms_p99']:.3f} "
                f"mean {summ['tick_ms']:.3f} slowest {summ['tick_ms_max']:.3f} "
                f"(tick {summ['slowest_tick']}); rollout "
                f"{entry['rollout_hz']:.1f}"
                f" Hz ({entry['rollout_tick_ms']:.3f} ms per tick), bit for "
                f"bit the tick loop; K1 launches {launches} in "
                f"{REPLAN_TICKS} ticks; padded lanes bit for bit lane 0; "
                f"plain version's avg/max within {plain_gap:.2e}; mean tick "
                f"cost {summ['mean_tick_cost']:.4f}")
    finally:
        _build.build = real_build
    if builds or _build.load_library() is not lib:
        fail(f"phase 19: the kernel library was built again during the "
             f"ticks ({len(builds)} builds)")
    say("phase 19 the kernel library was built once (phase 1), none during "
        "the ticks")

    # (e) the bench's vmap engine: the single-scene solver lane by lane
    # (plain PyTorch) at 65,536 random scenes, the bench schedule, with
    # the bench's paired gate.  Its phantom and cost bands are required;
    # its converged band is printed: the converged fraction of the
    # single-scene ladder (each rung through the basis) against the fleet
    # engine's is an fp-path-family property the reference has too (JAX's
    # vmap engine 0.402 against its fleet xla 0.523 on 256 random scenes on
    # the CPU; ROADMAP queue 3, fact 8).
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vb = bench.run_bench(batch=VMAP_BATCH, repeats=1, random_scenarios=True,
                         engine="vmap", quality_check_lanes=VMAP_CHECK)
    peak = torch.cuda.max_memory_allocated() / 2**30
    best = min(vb["timing"]["times_s"])
    bands = vb["gate"]["bands"]
    phantom_ok = vb["phantom_frac"] <= bands["phantom"]
    cost_ok = abs(bands["check_obstacle_cost"] - bands["xla_obstacle_cost"]
                  ) <= bands["cost"]
    conv_ok = abs(bands["check_converged_frac"] - bands["xla_converged_frac"]
                  ) <= bands["converged"]
    say(f"phase 19 bench --engine vmap --random-scenarios at {VMAP_BATCH}: "
        f"{VMAP_BATCH / best:.1f} solves/s ({best:.2f} s per solve, first "
        f"{vb['timing']['first_s']:.2f} s), peak device memory {peak:.3f} "
        f"GiB; paired gate on {VMAP_CHECK} lanes (the xla engine "
        f"{vb['timing']['xla_s']:.1f} s): phantom {vb['phantom_frac']} "
        f"{'PASS' if phantom_ok else 'FAIL'}, obstacle cost "
        f"{vb['mean_obstacle_cost']} against {vb['xla_mean_obstacle_cost']} "
        f"{'PASS' if cost_ok else 'FAIL'}, converged {vb['converged_frac']} "
        f"against {vb['xla_converged_frac']} (band "
        f"{bands['converged']:.3f}) {'PASS' if conv_ok else 'FAIL'} "
        f"(printed, fact 8)")
    if not (math.isfinite(vb["mean_final_cost"]) and phantom_ok and cost_ok):
        fail("phase 19: the vmap engine fails the bench's phantom or cost "
             "band")
    out["vmap"] = {"lanes": VMAP_BATCH, "solves_per_sec": VMAP_BATCH / best,
                   "peak_gib": peak, "converged": vb["converged_frac"],
                   "xla_converged": vb["xla_converged_frac"],
                   "converged_band_ok": conv_ok}
    return out


# Phase 20, the sharded path: the two-process run's ranks, the random
# scenes of its per-shard check, the timed repeats of a solve and of the
# statistics' reduction alone, the ranks' timeout (all of them together),
# the tolerance of the reduced means against torch's (a float32 sum over
# the shards divided by n against torch.mean's scaled sum) and of the cost
# grid on the card against the CPU (float32, sums in another order).
SHARD_RANKS = 2
SHARD_RANDOM = 16384
SHARD_RANDOM_CASES = ("pallas", "xla", "fused-compaction")
SHARD_REPEATS = 2
SHARD_STATS_REPEATS = 5
SHARD_TIMEOUT = 300
STATS_MEAN_RTOL = 1e-5
GRID_RTOL = 1e-6


def shard_case(cfg, case):
    """The backend and config of a random-scenes case of phase 20:
    ``fused-compaction`` is the fused backend with lane compaction (K2 per
    penalty round)."""
    return case.split("-")[0], cfg.replace(
        lane_compaction=case.endswith("compaction"))


def spawn_ranks(mode, outdir, n=SHARD_RANKS):
    """n fresh interpreters of this script as the ranks of one group
    (``shard-worker``, through ``distributed.run_local_ranks``); each
    writes its findings to outdir.  Returns their (exit code, stderr
    tail); ranks still running after SHARD_TIMEOUT are killed."""
    from irm_motion_planning_tpu_torch.parallel import distributed as dist

    port = dist.free_port()
    ranks = dist.run_local_ranks(
        [[sys.executable, os.path.abspath(__file__), "shard-worker", mode,
          str(i), str(n), str(port), outdir] for i in range(n)],
        timeout=SHARD_TIMEOUT)
    for _, out, _ in ranks:
        sys.stdout.write(out)
    return [(rc, err[-2000:]) for rc, _, err in ranks]


def stats_floats(stats):
    return {k: float(v) for k, v in stats.items()}


def timed_sharded(run, scns, barrier=None):
    """Best wall time of SHARD_REPEATS runs after a warm-up, each ended by
    a synchronize and a host read of the reduced statistics; with
    ``barrier`` the ranks start each run together."""
    res, stats = run(scns)
    times = []
    for _ in range(SHARD_REPEATS):
        if barrier:
            barrier()
        t0 = time.perf_counter()
        res, stats = run(scns)
        torch.cuda.synchronize()
        float(stats["n_total"])
        times.append(time.perf_counter() - t0)
    return res, stats, times


def timed_stats(sharded, mesh, parts, barrier=None):
    """Best wall time (ms) of SHARD_STATS_REPEATS reductions of the fleet
    statistics of solved shards (``sharded.fleet_stats``: the per-shard
    sums and max, the all_reduce SUM and MAX over the group, a host read),
    after one untimed; with ``barrier`` the ranks start each together."""
    times = []
    for _ in range(SHARD_STATS_REPEATS + 1):
        torch.cuda.synchronize()
        if barrier:
            barrier()
        t0 = time.perf_counter()
        float(sharded.fleet_stats(mesh, parts)["n_total"])
        times.append(time.perf_counter() - t0)
    return 1e3 * min(times[1:])


def shard_worker(argv):
    """One rank of phase 20's gloo group on the card (``python3
    chip_smoke.py shard-worker MODE RANK N PORT OUTDIR``).

    ``shards``: its half of the main path's replicated lanes on the fused
    backend (K1), timed in step with the other rank, every lane held to
    phase 4's lane 0 (alpha and stats, bit for bit), and the statistics'
    reduction timed alone; then its half of SHARD_RANDOM random scenes in
    each of SHARD_RANDOM_CASES, the shard's results and its kernels'
    launches written for the parent's per-shard check.  ``nccl-dup``: NCCL
    asked for two ranks on the one card must raise, naming it."""
    import irm_motion_planning_tpu_torch as mt
    from irm_motion_planning_tpu_torch import bench
    from irm_motion_planning_tpu_torch.ops import fused_solve as fs
    from irm_motion_planning_tpu_torch.ops import step_kernels as sk
    from irm_motion_planning_tpu_torch.parallel import distributed as dist
    from irm_motion_planning_tpu_torch.parallel import mesh as meshlib
    from irm_motion_planning_tpu_torch.parallel import sharded

    mode, rank, n, port, outdir = argv[0], int(argv[1]), int(argv[2]), \
        argv[3], argv[4]
    coord = f"127.0.0.1:{port}"
    if mode == "nccl-dup":
        try:
            dist.initialize_distributed(coord, n, rank,
                                        initialization_timeout=60)
        except RuntimeError as e:
            print(f"rank {rank}: {e}", flush=True)
            return 0 if "two ranks on one GPU" in str(e) else 1
        print(f"rank {rank}: NCCL formed a group of {n} ranks on one card",
              flush=True)
        return 1
    import torch.distributed as tdist

    dist.initialize_distributed(coord, n, rank, initialization_timeout=120,
                                backend="gloo")
    ref = torch.load(os.path.join(outdir, "ref.pt"))
    mesh = meshlib.make_mesh()
    cfg = bench.bench_config()
    basis = mt.make_basis(cfg)
    sl = dist.local_batch_slice(MAIN_BATCH)
    local = mt.replicate_scenario(mt.reference_scenario(cfg),
                                  sl.stop - sl.start)
    scns = dist.global_scenarios_from_local(mesh, local)
    run = sharded.make_shard_map_solver(cfg, basis, mesh, engine="fleet",
                                        backend="fused")
    fs.fused_solve.launches = 0
    res, stats, times = timed_sharded(run, scns, tdist.barrier)
    launches = fs.fused_solve.launches
    part = res.parts[0]
    a0 = ref["alpha0"].to(part.alpha.device)
    bits = torch.equal(part.alpha, a0.expand_as(part.alpha)) and all(
        torch.equal(x, x0.to(x.device).expand_as(x))
        for x, x0 in zip(part.stats, ref["stats0"]))
    out = {"fused": {"stats": stats_floats(stats), "times": times,
                     "launches": launches, "bitwise_phase4": bits,
                     "offsets": res.offsets, "stats_device": str(
                         stats["n_total"].device),
                     "stats_ms": timed_stats(sharded, mesh, res.parts,
                                             tdist.barrier)}}
    del res, part, scns, local
    rscns = mt.random_scenarios(cfg, torch.Generator().manual_seed(5),
                                SHARD_RANDOM)
    rsl = dist.local_batch_slice(SHARD_RANDOM)
    sh = dist.global_scenarios_from_local(
        mesh, mt.Scenario(*(x[rsl] for x in rscns)))
    for case in SHARD_RANDOM_CASES:
        backend, ccfg = shard_case(cfg, case)
        counters = ((fs.fused_solve, fs.fused_round) if backend == "fused"
                    else (sk.bls_inner_step, sk.cost_grad_eval,
                          sk.forward_eval))
        for k in counters:
            k.launches = 0
        res, stats = sharded.make_shard_map_solver(
            ccfg, basis, mesh, engine="fleet", backend=backend)(sh)
        out[case] = {
            "stats": stats_floats(stats), "offsets": res.offsets,
            "parts": [(p.alpha.cpu(), tuple(x.cpu() for x in p.stats))
                      for p in res.parts],
            "launches": {k.__name__: k.launches for k in counters}}
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    tdist.destroy_process_group()
    return 0


def sharded_phase(mt, fs, fleet, dev, alpha0, stats0, main_sps):
    """Phase 20: the sharded path (parallel/) on the card.  (a) A one-rank
    NCCL group drives make_shard_map_solver(engine="fleet",
    backend="fused") on the main path's lanes: alpha bit for bit phase 4's,
    the reduced statistics against batch_summary, solves/s beside phase
    4's.  (b) Two fresh processes under an explicit gloo group share the
    card, half the lanes each: bit for bit phase 4's, equal statistics on
    both ranks, their combined solves/s; and SHARD_RANDOM random scenes on
    pallas, xla and fused with lane compaction (K2), each rank's shards bit
    for bit the per-shard local solve.  In (a) and (b) the statistics'
    reduction is also timed alone.  NCCL asked for two ranks on the card
    raises.  (c) scaling.py
    on the fused backend, one process and --spawn 2.  (d) The cost grid of
    the visualization on the card against the CPU, with no matplotlib.
    Returns the numbers for K1's kernels-line entry (K2's launches under
    ``random_launches``)."""
    import tempfile

    import torch.distributed as tdist

    from irm_motion_planning_tpu_torch import bench
    from irm_motion_planning_tpu_torch.parallel import distributed as dist
    from irm_motion_planning_tpu_torch.parallel import mesh as meshlib
    from irm_motion_planning_tpu_torch.parallel import sharded
    from irm_motion_planning_tpu_torch.solvers import batched

    phase_clock(20)
    out = {}
    # (a) one rank, NCCL.
    if not dist.initialize_distributed(f"127.0.0.1:{dist.free_port()}", 1, 0,
                                       initialization_timeout=120):
        fail("phase 20: initialize_distributed formed no group")
    if tdist.get_backend() != "nccl":
        fail(f"phase 20: the one-rank group runs {tdist.get_backend()}, not "
             f"nccl")
    cfg = bench.bench_config()
    basis = mt.make_basis(cfg, device=dev)
    mesh = meshlib.make_mesh()
    scns = meshlib.shard_batch(mesh, mt.replicate_scenario(
        mt.reference_scenario(cfg, device=dev), MAIN_BATCH))
    run = sharded.make_shard_map_solver(cfg, basis, mesh, engine="fleet",
                                        backend="fused")
    fs.fused_solve.launches = 0
    res, stats, times = timed_sharded(run, scns)
    launches = fs.fused_solve.launches
    stats_ms = timed_stats(sharded, mesh, res.parts)
    part = res.parts[0]
    bits = torch.equal(part.alpha, alpha0.expand_as(part.alpha)) and all(
        torch.equal(x, x0.expand_as(x)) for x, x0 in zip(part.stats, stats0))
    summary = batched.batch_summary(part)
    st = stats_floats(stats)
    want = {"n_total": float(summary["n"]),
            **{k: float(summary[k]) for k in sharded.STATS_KEYS[1:]}}
    stats_ok = all(
        st[k] == want[k] if k in ("n_total", "converged_fraction",
                                  "max_final_cost")
        else abs(st[k] - want[k]) <= STATS_MEAN_RTOL * abs(want[k])
        for k in sharded.STATS_KEYS)
    sps = MAIN_BATCH / min(times)
    say(f"phase 20 one-rank NCCL group (backend {tdist.get_backend()}): "
        f"make_shard_map_solver(fleet, fused) on {MAIN_BATCH} replicated "
        f"lanes: {sps:.1f} solves/s (phase 4: {main_sps:.1f}, ratio "
        f"{sps / main_sps:.4f}; best of {[round(t, 4) for t in times]} s), "
        f"K1 launches {launches}; the statistics' reduction alone "
        f"{stats_ms:.4f} ms (best of {SHARD_STATS_REPEATS}); alpha and stats bit for bit phase 4's "
        f"{bits}; statistics on {stats['n_total'].device} {st} against "
        f"batch_summary {want} (means within {STATS_MEAN_RTOL:g}): "
        f"{'PASS' if stats_ok else 'FAIL'}")
    if launches < 1:
        fail("phase 20: the sharded main path did not launch K1")
    if not bits:
        fail("phase 20: the one-rank sharded run differs from phase 4's K1 "
             "result")
    if not stats_ok or stats["n_total"].device.type != "cuda":
        fail("phase 20: the NCCL group's statistics differ from "
             "batch_summary or left the card")
    out.update(launches=launches, solves_per_sec=sps,
               main_path_solves_per_sec=main_sps, stats=st,
               stats_reduction_ms=stats_ms)
    tdist.destroy_process_group()
    del res, part, scns, run
    torch.cuda.empty_cache()

    # (b) two processes on the card under gloo.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    torch.save({"alpha0": alpha0.cpu(),
                "stats0": tuple(x.cpu() for x in stats0)},
               os.path.join(tmp, "ref.pt"))
    for rc, err in spawn_ranks("shards", tmp):
        if rc != 0:
            fail(f"phase 20: a gloo rank exited {rc}: {err}")
    ranks = [torch.load(os.path.join(tmp, f"rank{i}.pt"))
             for i in range(SHARD_RANKS)]
    f0, f1 = ranks[0]["fused"], ranks[1]["fused"]
    wall = [max(t) for t in zip(f0["times"], f1["times"])]
    two_sps = MAIN_BATCH / min(wall)
    say(f"phase 20 {SHARD_RANKS} processes on the card, explicit gloo, "
        f"{MAIN_BATCH // SHARD_RANKS} lanes each (fused): combined "
        f"{two_sps:.1f} solves/s ({two_sps / sps:.4f} of one process; "
        f"slower rank per run {[round(t, 4) for t in wall]} s), K1 launches "
        f"per rank {[r['fused']['launches'] for r in ranks]}, offsets "
        f"{[r['fused']['offsets'] for r in ranks]}, statistics on "
        f"{f0['stats_device']}, their reduction alone per rank "
        f"{[round(r['fused']['stats_ms'], 4) for r in ranks]} ms; every lane bit for bit phase 4's "
        f"{[r['fused']['bitwise_phase4'] for r in ranks]}; statistics equal "
        f"on both ranks {f0['stats'] == f1['stats']} and to the one-rank "
        f"run's {f0['stats'] == st}")
    if not all(r["fused"]["bitwise_phase4"] and r["fused"]["launches"] >= 1
               for r in ranks):
        fail("phase 20: a gloo rank's lanes differ from phase 4's, or it did "
             "not launch K1")
    if not (f0["stats"] == f1["stats"] and f0["stats"]["n_total"] ==
            MAIN_BATCH):
        fail("phase 20: the ranks' statistics differ")
    out.update(two_process_solves_per_sec=two_sps,
               two_process_launches=[r["fused"]["launches"] for r in ranks],
               two_process_stats_reduction_ms=[r["fused"]["stats_ms"]
                                               for r in ranks])
    # The random scenes: each rank's shard against the same shard solved
    # locally in this process.
    rcfg = bench.bench_config()
    rscns = mt.random_scenarios(rcfg, torch.Generator().manual_seed(5),
                                SHARD_RANDOM, device=dev)
    must_launch = {"pallas": ("bls_inner_step", "cost_grad_eval",
                              "forward_eval"),
                   "xla": (), "fused-compaction": ("fused_round",)}
    for case in SHARD_RANDOM_CASES:
        backend, ccfg = shard_case(rcfg, case)
        got = [(o, p) for r in ranks
               for o, p in zip(r[case]["offsets"], r[case]["parts"])]
        per = SHARD_RANDOM // len(got)
        same = True
        for o, (alpha, stats_p) in got:
            want_p = fleet.fleet_solve(ccfg, basis, mt.Scenario(
                *(x[o:o + per] for x in rscns)), backend=backend)
            same = same and torch.equal(alpha, want_p.alpha.cpu()) and all(
                torch.equal(x, y.cpu()) for x, y in zip(stats_p,
                                                          want_p.stats))
        equal = ranks[0][case]["stats"] == ranks[1][case]["stats"]
        say(f"phase 20 {SHARD_RANDOM} random scenes ({SHARD_RANKS} x {per}) "
            f"on {case}: each rank's shard bit for bit the per-shard "
            f"local solve {same}; statistics equal on both ranks {equal} "
            f"{ranks[0][case]['stats']}; launches per rank "
            f"{[r[case]['launches'] for r in ranks]}")
        if not (same and equal):
            fail(f"phase 20: the {case} shards differ from the per-shard "
                 f"local solve, or the ranks' statistics differ")
        if any(r[case]["launches"][k] < 1 for r in ranks
               for k in must_launch[case]):
            fail(f"phase 20: a rank's {case} path did not launch "
                 f"{', '.join(must_launch[case])}")
    out["random_launches"] = {case: [r[case]["launches"] for r in ranks]
                              for case in SHARD_RANDOM_CASES}
    for rc, err in spawn_ranks("nccl-dup", tmp):
        if rc != 0:
            fail(f"phase 20: NCCL with two ranks on one card did not raise "
                 f"as it should (exit {rc}): {err}")
    say("phase 20 NCCL asked for two ranks on the one card: both ranks "
        "raised, naming the shared card")

    # (c) the scaling launcher, one process and two spawned.
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    out["scaling"] = []
    for extra in ([], ["--spawn", "2"]):
        cmd = [sys.executable, "-m",
               "irm_motion_planning_tpu_torch.benchmarks.scaling",
               "--backend", "fused", "--repeats", "2"] + extra
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True, timeout=SHARD_TIMEOUT)
        if proc.returncode != 0:
            fail(f"phase 20: {' '.join(cmd[2:])} exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        sweep = json.loads(line)
        say(f"phase 20 scaling.py {' '.join(cmd[3:])}: {line}")
        if sweep["metric"] != "scaling_sweep" or not all(
                math.isfinite(p["solves_per_sec"]) for p in sweep["points"]):
            fail("phase 20: scaling.py printed no sweep")
        out["scaling"].append(sweep)

    # (d) the visualization's cost grid on the card, without matplotlib.
    from irm_motion_planning_tpu_torch.visualization import plots

    scn = mt.reference_scenario(mt.PlannerConfig(), device=dev)
    _, _, card = plots.cost_grid(scn)
    _, _, cpu = plots.cost_grid(scn, device="cpu")
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    say(f"phase 20 visualization.plots.cost_grid (81 x 81) on the card "
        f"against the CPU: {err:.3g} of the largest cost (bound "
        f"{GRID_RTOL:g}); matplotlib imported "
        f"{'matplotlib' in sys.modules}")
    if not (err <= GRID_RTOL and np.isfinite(card).all()):
        fail("phase 20: the cost grid on the card differs from the CPU's")
    if "matplotlib" in sys.modules:
        fail("phase 20: the cost grid imported matplotlib")
    out["cost_grid_rel_err"] = err
    return out


# Phase 21, any arm: the joint counts beside the reference arm's three,
# JAX's own 5-link test arm (tests/test_basis.py) and a 7-link arm.  The
# batches: J=5's main path at full width and its paired check; the kernels
# against their plain versions; the full schedule against plain (cut from
# JOINT_LANES for the phase's time); the lanes solved alone; T=200's batch
# and the lanes of its paired check and plain comparison (cut from 8,192
# for the phase's time: the exact ladder's plain version and xla engine at
# T=200 take tens of seconds there); the tally's lanes.  The built basis'
# digest at (T=72, J=5), pinned by tests/test_torch_basis_build.py.
JOINT_ARMS = {5: (1.0, 0.8, 0.6, 0.4, 0.2),
              7: (1.0, 0.9, 0.8, 0.6, 0.4, 0.3, 0.2)}
JOINT_MAIN = 1048576
JOINT_CHECK = 32768
JOINT_TALLY = 8192
JOINT_LANES = 65536
JOINT_FULL = 16384
JOINT_ALONE = (0, 500, 998)
JOINT_LARGE = 65536
JOINT_LARGE_CHECK = 4096
JOINT7_CHECK = 8192
BASIS_T72_J5_SHA256 = (
    "c98422d34367636aa58151c0971106be7493d96e935f7726aecddf4221b68a63")


def start_joint_builds(_build):
    """Build the kernel libraries of JOINT_ARMS' joint counts (one nvcc per
    source, all started together) in threads, while phases 2-20 run;
    returns (threads, errors by J, start time).  The threads are not
    daemons: the interpreter waits for them (and their nvcc processes)
    before it exits, whatever phase ends the run."""
    import threading

    errors = {}

    def run(J):
        try:
            _build.build(J)
        except Exception as e:  # noqa: BLE001 -- reported in phase 21
            errors[J] = e

    threads = [threading.Thread(target=run, args=(J,)) for J in JOINT_ARMS]
    for t in threads:
        t.start()
    return threads, errors, time.perf_counter()


def arm_config(cfg, J):
    return cfg.replace(n_joints=J, link_length=JOINT_ARMS[J])


def joint_ptxas(report):
    """The ptxas lines of a J library by phase 21's kernel entries: K1/K2
    per program (``fused_solve`` and ``fused_round`` the linearized
    ladder's with its kernel tiers), K3-K6, K7 alone."""
    def of(*prefixes):
        return {k: v for k, v in report.items() if k.startswith(prefixes)}

    tiers = tuple(f"{k}<{p}," for k in ("fused_solve", "fused_round")
                  for p in ("bls", "bls_ultra", "bls_bf16"))
    return {"fused_solve": of(*tiers[:3]), "fused_round": of(*tiers[3:]),
            "fused_solve_gd": of("fused_solve<gd,"),
            "fused_round_gd": of("fused_round<gd,"),
            "fused_solve_exact": of("fused_solve<bls_exact,"),
            "bls_inner_step": of("bls_step<"),
            "gd_inner_step": of("gd_step<"),
            "cost_grad_eval": of("cost_grad_eval<"),
            "forward_eval": of("forward_eval<"), "k7": of("k7_forward")}


def joints_phase(mt, bench, fs, sk, roofline, fleet, dev, builds):
    """Phase 21: K1-K7 at J = 5 and 7 (the libraries built in the
    background since phase 1), the built basis and the CLI at J = 5.
    Returns {kernel: {J: entry}} for the kernels line."""
    import hashlib

    from irm_motion_planning_tpu_torch import cli
    from irm_motion_planning_tpu_torch.models import rkhs
    from irm_motion_planning_tpu_torch.ops import _build

    phase_clock(21)
    threads, errors, t_start = builds
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    if errors:
        fail(f"phase 21: the kernel build failed: {errors}")
    for J in JOINT_ARMS:
        _build.load_library(J)
    info = {J: _build.builds.get(J, {}) for J in JOINT_ARMS}
    ptx = {J: joint_ptxas(ptxas_report(info[J].get("log", "")))
           for J in JOINT_ARMS}
    say(f"phase 21 the J={'/'.join(map(str, JOINT_ARMS))} libraries: built "
        f"in {[round(info[J].get('seconds', 0.0), 1) for J in JOINT_ARMS]} s "
        f"each, in the background from phase 1 ({t0 - t_start:.1f} s ago); "
        f"waited {time.perf_counter() - t0:.1f} s here")
    for J in JOINT_ARMS:
        say(f"phase 21 J={J} ptxas {ptx[J]}")
    O = 11
    out = {}

    def put(name, J, **kw):
        out.setdefault(name, {}).setdefault(str(J), {}).update(kw)

    # (a) The built basis: one config, one basis, on this machine's CPU as
    # on the CPU of the test that pins the digest; its cost.
    c72 = arm_config(mt.PlannerConfig(n_timesteps=72), 5)
    h = hashlib.sha256()
    for x in rkhs.build_basis(c72, device="cpu"):
        h.update(np.ascontiguousarray(x.numpy(), np.float32).tobytes())
    build_s = {}
    for T in (50, 200):
        t1 = time.perf_counter()
        rkhs._build(mt.PlannerConfig(n_timesteps=T))
        build_s[T] = time.perf_counter() - t1
    say(f"phase 21 build_basis at (T=72, J=5): sha256 {h.hexdigest()} "
        f"(pinned {BASIS_T72_J5_SHA256}); CPU seconds at T=50 "
        f"{build_s[50]:.3f}, T=200 {build_s[200]:.3f}")
    if h.hexdigest() != BASIS_T72_J5_SHA256:
        fail("phase 21: build_basis gives other bits on this machine")

    # (b) J=5, T=50: the main path at full width, fleet_solve on the fused
    # backend (one K1 launch), its paired xla gate, and with compaction (K2,
    # a launch per round), bit for bit; BLS and GD.
    cfg5 = arm_config(bench.bench_config(), 5)
    basis5 = mt.make_basis(cfg5, device=dev)
    scns = mt.random_scenarios(cfg5, torch.Generator().manual_seed(0),
                               JOINT_MAIN, device=dev)
    gates_ok = True
    for solver in ("bls", "gd"):
        c = arm_config(bench.bench_config(solver=solver), 5)
        rounds = len(fs.inner_schedule(c))
        fleet.fleet_solve(c, basis5, mt.Scenario(*(x[:4096] for x in scns)),
                          solver=solver, backend="fused")
        fs.fused_solve.launches = fs.fused_round.launches = 0
        with KernelTimer(fs, "fused_solve") as timer:
            res, ms = timed(lambda: fleet.fleet_solve(
                c, basis5, scns, solver=solver, backend="fused"))
        k1_n, k1_ms = fs.fused_solve.launches, timer.total_ms()
        if k1_n != 1 or fs.fused_round.launches != 0:
            fail(f"phase 21: the J=5 main path ({solver}) launched K1 {k1_n}, "
                 f"K2 {fs.fused_round.launches} times")
        gate = bench.paired_gate(c, basis5, scns, res, JOINT_CHECK, solver)
        b = gate["bands"]
        fs.fused_solve.launches = fs.fused_round.launches = 0
        with KernelTimer(fs, "fused_round") as t2:
            res2 = fleet.fleet_solve(c.replace(lane_compaction=True), basis5,
                                     scns, solver=solver, backend="fused")
        k2_n, k2_ms = fs.fused_round.launches, t2.total_ms()
        same = same_result(res, res2)
        del res2
        args = fleet.fused_args(c, basis5, scns)
        sub = roofline.plain_tally(fs.fused_solve_reference, c, *args[1:4],
                          *(x[..., :JOINT_TALLY] for x in args[4:]),
                          solver=solver)
        scale = JOINT_MAIN / JOINT_TALLY
        ran = res.stats.outer_iters + res.stats.converged.int()
        tally = roofline.kernel_counts({k: v * scale for k, v in sub.items()},
                              float(ran.sum()),
                              float(res.stats.inner_iters.sum()), solver)
        b1 = roofline.fused_rounds(JOINT_MAIN, 50, 5, O, tally, True, solver)
        live = [float((ran > r).sum()) for r in range(rounds)]
        b2 = roofline.fused_round_launches(JOINT_MAIN, 50, 5, O, tally, live,
                                           solver)
        say(f"phase 21 J=5 main path ({solver}, {JOINT_MAIN} random scenes, "
            f"fleet_solve fused): {JOINT_MAIN / ms * 1e3:.1f} solves/s "
            f"({ms:.1f} ms), {k1_n} K1 launch {k1_ms:.1f} ms (bound "
            f"{b1.ms:.1f} ms by {b1.by}, {k1_ms / b1.ms:.2f}x); converged "
            f"{float(res.stats.converged.float().mean()):.4f}; paired xla "
            f"gate on {JOINT_CHECK} lanes: converged "
            f"{b['check_converged_frac']:.4f} vs {b['xla_converged_frac']:.4f}"
            f" (band {b['converged']:.4f}), obstacle cost "
            f"{b['check_obstacle_cost']:.5f} vs {b['xla_obstacle_cost']:.5f} "
            f"(band {b['cost']:.5f}), phantom {gate['fields']['phantom_frac']}"
            f" (bound {b['phantom']:.2e}): "
            f"{'PASS' if gate['ok'] else 'FAIL'}; with compaction {k2_n} K2 "
            f"launches, {k2_ms:.1f} ms per solve (bound {b2.ms:.1f}), bit for "
            f"bit K1's: {same}")
        gates_ok = gates_ok and gate["ok"]
        if k2_n != rounds or not same:
            fail(f"phase 21: the J=5 rounds driver ({solver}) launched K2 "
                 f"{k2_n} times or differs from K1")
        if not torch.isfinite(res.alpha).all():
            fail("phase 21: non-finite alpha on the J=5 main path")
        k1 = "fused_solve" if solver == "bls" else "fused_solve_gd"
        k2 = "fused_round" if solver == "bls" else "fused_round_gd"
        put(k1, 5, launches=k1_n, ms=k1_ms, bound_ms=b1.ms, bound_by=b1.by,
            lanes=JOINT_MAIN, solves_per_sec=JOINT_MAIN / ms * 1e3,
            gate_ok=gate["ok"])
        put(k2, 5, launches=k2_n, ms_per_solve=k2_ms, bound_ms=b2.ms,
            bound_by=b2.by, lanes=JOINT_MAIN)
        del res, args
        torch.cuda.empty_cache()
    del scns
    if not gates_ok:
        fail("phase 21: the J=5 paired xla gate failed")

    # (c) J=5, T=50: each kernel against its plain version on JOINT_LANES
    # random scenes: K1/K2 at 1 round x 4 steps, K3-K6 one step, the
    # tiers' round; the ragged batch and lanes alone bit for bit; the full
    # schedule on JOINT_FULL lanes; the per-step paths once each.
    short = arm_config(mt.PlannerConfig(
        max_outer_iteration=1, max_inner_iteration=4, fixed_iters=True,
        max_obstacles=O), 5)
    scn = mt.random_scenarios(short, torch.Generator().manual_seed(1),
                              JOINT_LANES, device=dev)
    args = fleet.fused_args(short, basis5, scn)
    for solver in ("bls", "gd"):
        k = fs.fused_solve(*args, solver=solver)
        p, p_ms = timed(lambda: fs.fused_solve_reference(*args, solver=solver))
        agree, rel = fs.lane_agreement(p, k)
        say(f"phase 21 J=5 K1-{solver} against plain ({JOINT_LANES} lanes, "
            f"1x4 steps): lane agreement {agree:.4f}, alpha {rel:.3g} of the "
            f"lane's scale; plain {p_ms:.1f} ms")
        if agree < fs.CARD_SHORT_AGREEMENT_MIN or rel > fs.ALPHA_REL_MAX:
            fail(f"phase 21: J=5 K1-{solver} disagrees with its plain version")
        put("fused_solve" if solver == "bls" else "fused_solve_gd", 5,
            lane_agreement_short=agree, max_abs_err=float(
                (k.alpha - p.alpha).abs().max()))
        if solver == "bls":
            kbls = k
    cut = [x[..., :ODD_BATCH] for x in args[4:]]
    if not all(torch.equal(x, y[..., :ODD_BATCH]) for x, y in zip(
            fs.fused_solve(short, *args[1:4], *cut), kbls)):
        fail(f"phase 21: J=5 K1 on {ODD_BATCH} lanes differs from the same "
             f"lanes of the {JOINT_LANES}-lane run")
    for i in JOINT_ALONE:
        one = fs.fused_solve(short, *args[1:4],
                             *(x[..., i:i + 1] for x in args[4:]))
        if not all(torch.equal(x, y[..., i:i + 1]) for x, y in zip(one, kbls)):
            fail(f"phase 21: J=5 K1 on lane {i} alone differs from the batch")
    say(f"phase 21 J=5 K1 on {ODD_BATCH} lanes and on lanes {JOINT_ALONE} "
        f"alone: bit for bit the {JOINT_LANES}-lane run's lanes")
    rargs = round_args(args, 4, 0)
    for tier in ("", "ultra", "bf16"):
        kw = {tier: True} if tier else {}
        k2 = fs.fused_round(*rargs, **kw)
        p2 = fs.fused_round_reference(*rargs, **kw)
        agree, rel, abs2 = round_agreement(p2, k2, rargs[7])
        say(f"phase 21 J=5 K2{'-' + tier if tier else ''} one round against "
            f"plain ({JOINT_LANES} lanes, n_r 4, a quarter fulfilled): lane "
            f"agreement {agree:.4f}, alpha {rel:.3g} of the lane's scale")
        if agree < fs.CARD_SHORT_AGREEMENT_MIN or rel > fs.ALPHA_REL_MAX:
            fail(f"phase 21: J=5 K2 {tier or 'bls'} disagrees with plain")
        put("fused_round", 5, **{f"lane_agreement_{tier or 'bls'}": agree})
    _, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    lanes = (lsg, ljl, start, goal, ox, oy, ow)
    ev = sk.cost_grad_eval(short, kv, kvt, mix, a0, *lanes)
    evp, k5_plain = timed(lambda: sk.cost_grad_eval_reference(
        short, kv, kvt, mix, a0, *lanes))
    err5 = eval_errors(ev, evp)
    k5_ms = best_ms(lambda: sk.cost_grad_eval(short, kv, kvt, mix, a0, *lanes))
    b5 = roofline.cost_grad_eval(JOINT_LANES, 50, 5, O)
    f6 = sk.forward_eval(short, kv, mix, a0)
    k6_same = torch.equal(f6.traj, ev.traj) and torch.equal(f6.vel, ev.vel)
    k6_ms = best_ms(lambda: sk.forward_eval(short, kv, mix, a0))
    _, k6_plain = timed(lambda: sk.forward_eval_reference(short, kv, mix, a0))
    b6 = roofline.forward_eval(JOINT_LANES, 50, 5)
    say(f"phase 21 J=5 K5 against plain ({JOINT_LANES} lanes): {err5}, "
        f"{k5_ms:.3f} ms (bound {b5.ms:.3f} by {b5.by}), plain "
        f"{k5_plain:.1f} ms; K6 bit for bit K5's traj/vel {k6_same}, "
        f"{k6_ms:.3f} ms (bound {b6.ms:.3f} by {b6.by}), plain "
        f"{k6_plain:.1f} ms")
    if not eval_ok(err5) or not k6_same:
        fail("phase 21: J=5 K5/K6 differ from their plain versions")
    put("cost_grad_eval", 5, ms=k5_ms, bound_ms=b5.ms, bound_by=b5.by,
        plain_ms=k5_plain, max_abs_err=err5["abs"], lanes=JOINT_LANES)
    put("forward_eval", 5, ms=k6_ms, bound_ms=b6.ms, bound_by=b6.by,
        plain_ms=k6_plain, max_abs_err=0.0, lanes=JOINT_LANES)
    ful = rargs[7]
    for name, key in (("bls", "bls_inner_step"), ("gd", "gd_inner_step")):
        fn, ref = step_fns(sk, name)
        lr = torch.full_like(lsg, fs.round_lr(short, 0, name))
        state0 = sk.PallasStep(a0, ev.grad, ev.traj, ev.vel, ev.loss, lr, ful)
        ms, plain_ms, tally, agree, err = full_width_step(
            fn, ref, short, (kv, kvt, mix), state0, lanes)
        bound = (roofline.bls_inner_step if name == "bls"
                 else roofline.gd_inner_step)(JOINT_LANES, 50, 5, O, tally)
        say(f"phase 21 J=5 {key} one step ({JOINT_LANES} lanes, a quarter "
            f"frozen): {step_summary(agree, err)}; {ms:.3f} ms (bound "
            f"{bound.ms:.3f} by {bound.by}), plain {plain_ms:.1f} ms")
        if not step_ok(agree, err):
            fail(f"phase 21: J=5 {key} disagrees with its plain version")
        put(key, 5, ms=ms, bound_ms=bound.ms, bound_by=bound.by,
            plain_ms=plain_ms, max_abs_err=err["abs"], lane_agreement=agree,
            lanes=JOINT_LANES)
    del args, rargs, ev, evp, f6, scn, kbls
    torch.cuda.empty_cache()
    # The full schedule, and the per-step paths bit for bit K1.
    scn = mt.random_scenarios(cfg5, torch.Generator().manual_seed(2),
                              JOINT_FULL, device=dev)
    for solver in ("bls", "gd"):
        c = arm_config(bench.bench_config(solver=solver), 5)
        fargs = fleet.fused_args(c, basis5, scn)
        k = fs.fused_solve(*fargs, solver=solver)
        p = fs.fused_solve_reference(*fargs, solver=solver)
        agree, rel = fs.lane_agreement(p, k)
        counts = {n: getattr(sk, n).launches for n in (
            "bls_inner_step", "gd_inner_step", "cost_grad_eval",
            "forward_eval")}
        for n in counts:
            getattr(sk, n).launches = 0
        per_step = fleet.fleet_solve(c, basis5, scn, solver=solver,
                                     backend="pallas")
        ran = {n: getattr(sk, n).launches for n in counts}
        same = same_result(per_step, fleet.kernel_result(k))
        say(f"phase 21 J=5 {solver} full schedule ({JOINT_FULL} random "
            f"scenes): K1 against plain lane agreement {agree:.4f} (bound >= "
            f"{fs.CARD_FULL_AGREEMENT_MIN}); the per-step path (launches "
            f"{ran}) bit for bit K1: {same}")
        want = {"cost_grad_eval": 1, "forward_eval": 1 if solver == "bls"
                else 0, "bls_inner_step": 1 if solver == "bls" else 0,
                "gd_inner_step": 1 if solver == "gd" else 0}
        if (agree < fs.CARD_FULL_AGREEMENT_MIN or not same
                or any(bool(ran[n]) != bool(w) for n, w in want.items())):
            fail(f"phase 21: J=5 {solver} full schedule or per-step path")
        for n in ran:
            if ran[n]:
                put(n, 5, **{f"launches_{solver}_path": ran[n]})
        put("fused_solve" if solver == "bls" else "fused_solve_gd", 5,
            lane_agreement_full=agree)
    del scn, fargs, k, p, per_step
    torch.cuda.empty_cache()

    # (d) J=5, T=200: the streamed plan (K7) on JOINT_LARGE random scenes,
    # K1 per program against plain and the xla engine; K7 alone.
    T = LARGE_T
    c200 = arm_config(bench.bench_config(n_timesteps=T), 5)
    basis200 = mt.make_basis(c200, device=dev)
    scn = mt.random_scenarios(c200, torch.Generator().manual_seed(0),
                              JOINT_LARGE, device=dev)
    head = mt.Scenario(*(x[:JOINT_LARGE_CHECK] for x in scn))
    for prog in ("bls", "bls_exact", "gd"):
        solver, ladder, _ = fs.program_call(prog)
        c = arm_config(bench.bench_config(solver=solver, ladder_eval=ladder,
                                          n_timesteps=T), 5)
        fs.fused_solve.launches = 0
        with KernelTimer(fs, "fused_solve") as timer:
            res = fleet.fleet_solve(c, basis200, scn, solver=solver,
                                    backend="fused")
        n1, ms = fs.fused_solve.launches, timer.total_ms()
        gate = bench.paired_gate(c, basis200, scn, res, JOINT_LARGE_CHECK,
                                 solver)
        hargs = fleet.fused_args(c, basis200, head)
        tally = {}
        p = fs.fused_solve_reference(*hargs, solver=solver, tally=tally)
        k_conv = float(res.stats.converged[:JOINT_LARGE_CHECK].float().mean())
        p_conv = float(p.fulfilled.mean())
        band = max(0.02, min(0.15 * max(k_conv, p_conv), 0.05))
        scale = JOINT_LARGE / JOINT_LARGE_CHECK
        ran = res.stats.outer_iters + res.stats.converged.int()
        lp = fs.launch_plan(c, O, prog=prog)
        bound = roofline.fused_rounds(
            JOINT_LARGE, T, 5, O,
            roofline.kernel_counts({k: v * scale for k, v in tally.items()},
                          float(ran.sum()), float(res.stats.inner_iters.sum()),
                          solver), True, solver, ladder, streamed=True,
            lanes_per_cta=lp["lanes"])
        b = gate["bands"]
        say(f"phase 21 J=5 T={T} K1-{prog} ({JOINT_LARGE} random scenes, "
            f"{lp['lanes']} lanes per CTA): {n1} launch, {ms:.1f} ms (bound "
            f"{bound.ms:.1f} by {bound.by}, the design's L2 reads "
            f"{bound.design_l2_ms:.1f} ms); converged {k_conv:.4f} vs plain "
            f"{p_conv:.4f} (band {band:.4f}) on {JOINT_LARGE_CHECK} lanes; "
            f"paired xla gate: converged {b['check_converged_frac']:.4f} vs "
            f"{b['xla_converged_frac']:.4f} (band {b['converged']:.4f}), cost"
            f" {b['check_obstacle_cost']:.5f} vs {b['xla_obstacle_cost']:.5f}"
            f", phantom {gate['fields']['phantom_frac']}: "
            f"{'PASS' if gate['ok'] else 'FAIL'}"
            f"{' (printed only: fact 5)' if prog == 'bls' else ''}")
        if (n1 != 1 or abs(k_conv - p_conv) > band
                or not torch.isfinite(res.alpha).all()
                or (prog != "bls" and not gate["ok"])):
            fail(f"phase 21: J=5 T={T} K1-{prog} failed its checks")
        put({"bls": "fused_solve", "gd": "fused_solve_gd",
             "bls_exact": "fused_solve_exact"}[prog], 5,
            **{f"T{T}": {"launches": n1, "ms": ms, "bound_ms": bound.ms,
                         "bound_by": bound.by, "lanes": JOINT_LARGE,
                         "gate_ok": gate["ok"]}})
        if prog == "bls":
            k7_launches = n1
        del res, p, hargs
    # K7 alone: one forward product, bit for bit K6, beside torch.matmul.
    _, kv, kvt, mix, a0, *_ = fleet.fused_args(c200, basis200, scn)
    t7 = fs.k7_forward(c200, kv, kvt, mix, a0)
    f6 = sk.forward_eval(c200, kv, mix, a0)
    k7_same = torch.equal(t7[0], f6.traj) and torch.equal(t7[1], f6.vel)
    k7_ms = best_ms(lambda: fs.k7_forward(c200, kv, kvt, mix, a0))
    _, k7_plain = timed(lambda: fs.forward_planes(kv, mix, a0))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    flat = a0.permute(1, 0, 2).reshape(T, 5 * JOINT_LARGE)
    k7_mm = best_ms(lambda: torch.matmul(kv, flat))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    b7 = roofline.forward_eval(JOINT_LARGE, T, 5)
    say(f"phase 21 J=5 K7 alone at T={T} ({JOINT_LARGE} lanes, "
        f"{fs.launch_plan(c200, O)['lanes']} lanes per CTA): {k7_ms:.3f} ms "
        f"per forward product, bit for bit K6 {k7_same}; one torch.matmul "
        f"(TF32 off) {k7_mm:.3f} ms; plain {k7_plain:.1f} ms; bound "
        f"{b7.ms:.3f} ms by {b7.by}")
    if not k7_same:
        fail("phase 21: J=5 K7 differs from K6")
    put("k7", 5, launches=k7_launches, ms_per_product=k7_ms, ms=k7_ms,
        bound_ms=b7.ms, bound_by=b7.by, plain_ms=k7_plain, library_ms=k7_mm,
        max_abs_err=0.0, lanes=JOINT_LARGE)
    del scn, head, a0, flat, t7, f6
    torch.cuda.empty_cache()

    # (e) J=7, T=50: K1-BLS against plain, and the paired gate.
    short7 = arm_config(short, 7)
    cfg7 = arm_config(bench.bench_config(), 7)
    basis7 = mt.make_basis(cfg7, device=dev)
    scn = mt.random_scenarios(cfg7, torch.Generator().manual_seed(0),
                              JOINT_LANES, device=dev)
    args = fleet.fused_args(short7, basis7, scn)
    k, k_ms = timed(lambda: fs.fused_solve(*args))
    p, p_ms = timed(lambda: fs.fused_solve_reference(*args))
    agree, rel = fs.lane_agreement(p, k)
    fs.fused_solve.launches = 0
    with KernelTimer(fs, "fused_solve") as timer:
        res = fleet.fleet_solve(cfg7, basis7, scn, backend="fused")
    n1, ms = fs.fused_solve.launches, timer.total_ms()
    gate = bench.paired_gate(cfg7, basis7, scn, res, JOINT7_CHECK)
    sub = roofline.plain_tally(fs.fused_solve_reference, cfg7,
                      *(x[..., :JOINT_TALLY] if i >= 3 else x for i, x in
                        enumerate(fleet.fused_args(cfg7, basis7, scn)[1:])))
    ran = res.stats.outer_iters + res.stats.converged.int()
    b1 = roofline.fused_rounds(
        JOINT_LANES, 50, 7, O,
        roofline.kernel_counts({kk: v * JOINT_LANES / JOINT_TALLY
                       for kk, v in sub.items()},
                      float(ran.sum()), float(res.stats.inner_iters.sum())),
        True)
    b = gate["bands"]
    say(f"phase 21 J=7 K1-BLS against plain ({JOINT_LANES} lanes, 1x4 "
        f"steps): lane agreement {agree:.4f}, alpha {rel:.3g}; kernel "
        f"{k_ms:.1f} ms, plain {p_ms:.1f} ms; the full schedule through "
        f"fleet_solve: {n1} K1 launch, {ms:.1f} ms (bound {b1.ms:.1f} by "
        f"{b1.by}), converged {float(res.stats.converged.float().mean()):.4f}"
        f"; paired xla gate on {JOINT7_CHECK} lanes: converged "
        f"{b['check_converged_frac']:.4f} vs {b['xla_converged_frac']:.4f} "
        f"(band {b['converged']:.4f}), cost {b['check_obstacle_cost']:.5f} "
        f"vs {b['xla_obstacle_cost']:.5f}, phantom "
        f"{gate['fields']['phantom_frac']}: {'PASS' if gate['ok'] else 'FAIL'}")
    if (agree < fs.CARD_SHORT_AGREEMENT_MIN or rel > fs.ALPHA_REL_MAX
            or n1 != 1 or not gate["ok"]):
        fail("phase 21: J=7 K1 failed its checks")
    put("fused_solve", 7, launches=n1, ms=ms, bound_ms=b1.ms, bound_by=b1.by,
        lanes=JOINT_LANES, plain_ms_short=p_ms, lane_agreement_short=agree,
        max_abs_err=float((k.alpha - p.alpha).abs().max()),
        gate_ok=gate["ok"])
    del scn, args, k, p, res
    torch.cuda.empty_cache()

    # (f) The CLI on the card with JAX's 5-link arm.
    fs.fused_solve.launches = 0
    rc, text, err = run_cli(cli, [
        "--n-joints", "5", "--link-length",
        *map(str, JOINT_ARMS[5]), "--batch", "65536", "--engine", "fleet",
        "--backend", "fused", "--random-scenarios", "true"])
    n_cli = fs.fused_solve.launches
    summary = re.search(r"batch \d+: converged [^\n]*", text)
    say(f"phase 21 CLI --n-joints 5 --batch 65536 --engine fleet --backend "
        f"fused --random-scenarios true: exit {rc}, {n_cli} K1 launches; "
        f"{summary.group(0) if summary else text[-300:]}")
    if rc != 0 or n_cli < 1:
        fail(f"phase 21: the J=5 CLI failed (exit {rc}): {err[-2000:]}")

    for J in JOINT_ARMS:
        for name, lines in ptx[J].items():
            # The kernels line keeps the largest registers and spill stores
            # over the kernel's instantiations (each printed above).
            put(name, J, registers=max(
                (v.get("registers", 0) for v in lines.values()), default=None),
                spill_stores=max((v.get("spill_stores", 0)
                                  for v in lines.values()), default=None))
        put("build", J, seconds=info[J].get("seconds"))
    out["basis"] = {"sha256_T72_J5": h.hexdigest(),
                    "build_seconds": {str(k): v for k, v in build_s.items()}}
    return out


# Phase 22, the benchmarks: the quality gate's and the seed sweep's scenes,
# the oracle's, hetero's and the epilogue's lanes, the lanes of decompose
# and roofline, and the time phase 22 aims to stay under (builds excluded).
BENCH_QUALITY = 32768
BENCH_SEEDS = "0,1,2,3,4"
BENCH_ORACLE = 2048
BENCH_HETERO = 1048576
BENCH_EPILOGUE = 1048576
BENCH_WIDTHS = (32768, 1048576)
BENCH_KERNELS = ("fused_solve", "fused_round", "bls_inner_step",
                 "gd_inner_step", "cost_grad_eval", "forward_eval")


def start_variant_builds(joint_builds):
    """Build the five phase-ablated K1 libraries (benchmarks/epilogue.py:
    fused_solve.cu with one WB_ABLATE_* flag each, one nvcc each, started
    together) in a thread, once phase 21's J = 5 and 7 builds are done, so
    that fewer compilers share the host at once; returns (thread, errors).
    The thread is not a daemon: the interpreter waits for it."""
    import threading

    from irm_motion_planning_tpu_torch.benchmarks import epilogue

    errors = {}

    def run():
        for t in joint_builds[0]:
            t.join()
        try:
            epilogue.build_variants(3)
        except Exception as e:  # noqa: BLE001 -- reported in phase 22
            errors["variants"] = e

    thread = threading.Thread(target=run)
    thread.start()
    return thread, errors


def quiet(fn, *a, **kw):
    """fn's result, its stdout and stderr lines kept from the log (the
    phase prints what it reads)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*a, **kw)


def benchmarks_phase(mt, bench, fs, sk, roofline, fleet, dev, builds, alpha0):
    """Phase 22: the port's benchmarks (irm_motion_planning_tpu_torch/
    benchmarks/) on the card, T=50, J=3, 11 obstacle slots.  Returns the
    ablated builds' entries for K1's line and each kernel's launches in the
    phase."""
    import argparse
    import tempfile

    from irm_motion_planning_tpu_torch.benchmarks import (
        ablation, certify, decompose, epilogue, hetero, quality,
        quality_sweep, roofline as broofline, schedule_sweep)

    phase_clock(22)
    t_phase = time.perf_counter()
    counters = {n: getattr(fs if n.startswith("fused") else sk, n)
                for n in BENCH_KERNELS}
    for k in counters.values():
        k.launches = 0
    o11 = ["--max-obstacles", "11"]

    # (a) The quality gate: BLS across the three backends (required), GD.
    for solver in ("bls", "gd"):
        t0 = time.perf_counter()
        q = quiet(quality.run, ["--batch", str(BENCH_QUALITY), "--schedule",
                                "--solver", solver, "--seed", "0",
                                "--backends", "xla,pallas,fused"] + o11)
        rows = {b: {k: r[k] for k in ("converged_frac", "phantom_frac",
                                      "avg_cost_mean", "max_cost_mean",
                                      "endpoint_err_p90",
                                      "mean_inner_steps")}
                for b, r in q["backends"].items()}
        say(f"phase 22 quality {solver} ({BENCH_QUALITY} random scenes, the "
            f"bench schedule, {time.perf_counter() - t0:.1f} s): {rows}; "
            f"verdict against xla {'PASS' if q['pass'] else 'FAIL'}"
            + ("" if solver == "bls" else " (printed only)"))
        if solver == "bls" and not q["pass"]:
            fail("phase 22: the BLS quality gate failed across xla, pallas "
                 "and fused")

    # (b) The seed sweep (queue 3: the paired gate's margins over seeds).
    t0 = time.perf_counter()
    sw = quiet(quality_sweep.run, ["--seeds", BENCH_SEEDS, "--batch",
                                   str(BENCH_QUALITY), "--backends",
                                   "xla,fused,pallas"] + o11)
    conv = {r["seed"]: {b: r[b]["converged_frac"] for b in
                        ("xla", "fused", "pallas")} for r in sw["per_seed"]}
    say(f"phase 22 quality_sweep seeds {BENCH_SEEDS} ({BENCH_QUALITY} "
        f"scenes each, {time.perf_counter() - t0:.1f} s): converged by seed "
        f"{conv}; deltas {sw['deltas']}")

    # (c) Certification: the port's oracle on the card, then the engine
    # phase of both tiers on fused against it (on-platform) and against the
    # JAX package's stored oracles (informative).
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "certify_oracle.npz")
        orow = certify.run_oracle(BENCH_ORACLE, 0, 11, "schedule", path, dev)
        say(f"phase 22 certify oracle (the port's sequential BLS on the "
            f"card, {BENCH_ORACLE} random scenes, the bench schedule): "
            f"converged {orow['converged_frac']}, mean avg/max cost "
            f"{orow['avg_cost_mean']}/{orow['max_cost_mean']}, nonfinite "
            f"{orow['nonfinite']}, {orow['elapsed_s']} s")
        certified = {}
        for label, oracle in (
                ("the port's oracle on the card (on-platform)", path),
                ("JAX's CPU oracle (informative)",
                 os.path.join(root, "certify_oracle_cpu2048.npz")),
                ("JAX's TPU oracle (informative)",
                 os.path.join(root, "certify_oracle_tpu2048.npz"))):
            try:
                ver = quiet(certify.run_engine, oracle, "fused",
                            ("exact", "linearized"), 0, dev)
            except (OSError, KeyError, ValueError) as e:
                if oracle == path:
                    fail(f"phase 22: the port's oracle file did not load in "
                         f"the engine phase: {e!r}")
                raise
            certified[label] = ver
            for tier, row in ver["tiers"].items():
                bc = row["both_converged"]
                say(f"phase 22 certify {tier} on fused against {label}: "
                    f"converged {row['engine_converged_frac']} vs the "
                    f"oracle's {row['oracle_converged_frac']} (slack "
                    f"{certify.CONV_SLACK}); both converged n="
                    f"{bc['avg']['n']}: mean gap avg "
                    f"{bc['avg'].get('mean_gap')} max "
                    f"{bc['max'].get('mean_gap')} (bound "
                    f"{certify.MEAN_BOUNDS[tier]}), median avg "
                    f"{bc['avg'].get('p50_gap')} max "
                    f"{bc['max'].get('p50_gap')} (bound "
                    f"{certify.MEDIAN_BOUNDS[tier]}); all scenes mean gap "
                    f"avg {row['all']['avg'].get('mean_gap')} max "
                    f"{row['all']['max'].get('mean_gap')}: "
                    f"{'PASS' if row['pass'] else 'FAIL'}")

    # (d) The schedule sweep through K2, then the shipped schedule under the
    # bench config, which must give phase 4's K1 lane 0 bit for bit.
    t0 = time.perf_counter()
    rows = quiet(schedule_sweep.run, [])
    for r in rows:
        say(f"phase 22 schedule_sweep {r['sched']}: budget "
            f"{r['total_budget']}, live steps {r['live_steps']}, avg/max "
            f"{r['avg_cost']}/{r['max_cost']}, endpoint {r['endpoint_err']}, "
            f"avg gap {r['avg_gap_pct']}%")
    bcfg = bench.bench_config()
    basis = mt.make_basis(bcfg, device=dev)
    scn0 = mt.reference_scenario(bcfg, device=dev)
    fsc = fleet.to_fleet(mt.replicate_scenario(scn0, 128))
    a0k = fleet.fleet_init_alpha(bcfg, basis, fsc).movedim(1, 0).contiguous()
    sched = mt.REFERENCE_INNER_SCHEDULE_BLS
    alpha, steps, _ = schedule_sweep.run_schedule(bcfg, basis, fsc, a0k,
                                                  sched, 0)
    lane0 = fleet.alpha_from_fleet(alpha.movedim(0, 1))[0]
    want = float(mt.solution_quality(bcfg, basis, scn0, alpha0)[
        "endpoint_err"])
    got = float(mt.solution_quality(bcfg, basis, scn0, lane0)[
        "endpoint_err"])
    sweep_row = next(r for r in rows if tuple(r["sched"]) == tuple(sched))
    same_alpha = torch.equal(lane0, alpha0)
    say(f"phase 22 the shipped schedule through K2 under the bench config: "
        f"endpoint {got!r} against phase 4's K1 {want!r}, alpha bit for bit "
        f"{same_alpha}; the sweep's own row (max_inner_iteration "
        f"{max(max(c) for c in schedule_sweep.DEFAULT_BLS)}) endpoint "
        f"{sweep_row['endpoint_err']} ({time.perf_counter() - t0:.1f} s)")
    if not (same_alpha and got == want):
        fail("phase 22: the shipped schedule through K2 is not phase 4's K1 "
             "lane 0 bit for bit")
    del alpha, a0k, fsc

    # (e) hetero: the compaction policies with and without --shrink.
    t0 = time.perf_counter()
    for shrink in (False, True):
        args = argparse.Namespace(
            batch=BENCH_HETERO, block_b=0, shrink=shrink, seed=0, repeats=3,
            policies="none,steps,steps_loss,oracle", rounds_detail=True,
            device="cuda")
        for row, detail in hetero.run(args):
            rounds = [(d["launched"], d["t_sort_ms"], d["t_round_ms"],
                       d["ful_frac"], d["live_tiles"]) for d in detail]
            say(f"phase 22 hetero {row['policy']} shrink {shrink}: "
                f"{row['solves_per_sec']} solves/s, fulfilled "
                f"{row['ful_frac']}; rounds (launched, sort ms, K2 ms, "
                f"fulfilled, live tiles) {rounds}")
        torch.cuda.empty_cache()
    say(f"phase 22 hetero took {time.perf_counter() - t0:.1f} s")

    # (f) The epilogue shares of the five ablated builds.
    thread, errors = builds
    thread.join()
    if errors:
        fail(f"phase 22: the ablated builds failed: {errors}")
    ep = quiet(epilogue.run, ["--batch", str(BENCH_EPILOGUE), "--repeats",
                              "4"])
    ablated = {}
    for name, flag in epilogue.VARIANTS.items():
        log = epilogue.variant_build(name)
        ablated[name] = {
            "flag": flag, "ms": ep["times_ms"][name],
            "share_of_step": ep["share_of_step"][name],
            "k1_work_per_lane": ep["k1_work_per_lane"][name],
            "build_s": log.get("seconds"),
            "ptxas": {k: v for k, v in ptxas_report(log.get("log", "")).items()
                      if k.startswith("fused_solve<bls,")}}
    say(f"phase 22 epilogue ({BENCH_EPILOGUE} replicated lanes, best of 4): "
        f"full {ep['times_ms']['full']} ms (again {ep['full_after_ms']}), "
        f"K1 work per lane {ep['k1_work_per_lane']['full']}, the plain "
        f"tally {ep['plain_work_per_lane']}")
    for name, a in ablated.items():
        say(f"phase 22 epilogue {name} ({a['flag']}): {a['ms']} ms, share "
            f"{a['share_of_step']}, K1 work per lane {a['k1_work_per_lane']},"
            f" built in {a['build_s']} s, ptxas {a['ptxas']}")
    ablated["full_ms"] = ep["times_ms"]["full"]
    ablated["full_after_ms"] = ep["full_after_ms"]

    # (g) decompose and roofline at two widths; (h) the ablation rows.
    for width in BENCH_WIDTHS:
        d = quiet(decompose.run, ["--batch", str(width), "--backend",
                                  "fused", "--repeats", "3"] + o11)
        r = quiet(broofline.run, ["--batch", str(width)] + o11)
        say(f"phase 22 decompose fused at {width}: layout {d['layout_ms']} "
            f"ms, init {d['init_ms']} ms, solve from alpha0 "
            f"{d['solve_minus_init_ms']} ms, full {d['full_ms']} ms")
        say(f"phase 22 roofline at {width}: K5 {r['eval_kernel']}; the "
            f"fused solve {r['fused_solve']}")
        torch.cuda.empty_cache()
    ab = quiet(ablation.run, [])
    table = [(x["lambda_max_cost"], x["avg_cost"], x["max_cost"],
              x["reference_avg"], x["reference_max"]) for x in ab["rows"]]
    say(f"phase 22 ablation (BLS, the reference scene, single-scene solves "
        f"on the card; lambda, avg, max, the reference's avg, max): "
        f"{table}")

    launches = {n: k.launches for n, k in counters.items()}
    say(f"phase 22 launches {launches}; {time.perf_counter() - t_phase:.1f} "
        f"s of benchmarks (builds excluded)")
    if min(launches.values()) < 1:
        fail(f"phase 22: a kernel was not launched: {launches}")
    return {"ablated": ablated, "launches": launches}


def tick_lanes(batched, scn):
    """Lanes one tick launches K1 on: the fleet's, or one scene padded."""
    from irm_motion_planning_tpu_torch.solvers.replan import PAD_LANES

    return int(scn.start.shape[0]) if batched else PAD_LANES


def gd_phases(mt, bench, fs, sk, roofline, fleet, dev, random_args,
              occupancy):
    """Phases 12 and 13, GD through the fused kernels; returns the "gd"
    entries of K1's and K2's lines in the kernels line."""
    cfg = bench.bench_config(solver="gd")
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles
    rounds = len(fs.inner_schedule(cfg))

    # -- phase 12: K1-GD and K2-GD against plain, short horizon ---------------
    phase_clock(12)
    scfg = mt.PlannerConfig(max_outer_iteration=2, max_inner_iteration=6,
                            fixed_iters=True, max_obstacles=11)
    _, _, args = random_args(scfg, SHORT_BATCH, 0)
    k = fs.fused_solve(*args, solver="gd")
    torch.cuda.synchronize()
    p = fs.fused_solve_reference(*args, solver="gd")
    agree, rel = fs.lane_agreement(p, k)
    same = ((k.inner_iters == p.inner_iters) & (k.outer_iters == p.outer_iters)
            & (k.fulfilled == p.fulfilled))[0]
    k1_abs_err = float((k.alpha - p.alpha).abs()[:, :, same].max())
    say(f"phase 12 K1-GD short horizon ({SHORT_BATCH} random scenes, 2x6 "
        f"steps): lane agreement {agree:.4f} (bound >= "
        f"{fs.CARD_SHORT_AGREEMENT_MIN}), alpha error on agreeing lanes "
        f"{k1_abs_err:.3g} abs, {rel:.3g} of the lane's scale (bound <= "
        f"{fs.ALPHA_REL_MAX}); {int((k.inner_iters - p.inner_iters).abs().sum())}"
        f" steps differ in all")
    if agree < fs.CARD_SHORT_AGREEMENT_MIN or rel > fs.ALPHA_REL_MAX:
        fail("phase 12: K1-GD disagrees with its plain version")
    cut = [x[..., :RAGGED_BATCH] for x in args[4:]]
    p_cut = fs.fused_solve_reference(scfg, *args[1:4], *cut, solver="gd")
    for warps, ctas in grid_shapes():
        kr = fs.fused_solve(scfg.replace(pallas_block_b=warps), *args[1:4],
                            *cut, solver="gd", ctas=ctas)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                   for x, y in zip(kr, k)):
            fail(f"phase 12: K1-GD, {RAGGED_BATCH} lanes at {warps} lanes "
                 f"per CTA, {ctas or 'all'} CTAs differ from the same lanes "
                 f"of the {SHORT_BATCH}-lane run")
        agree_r, rel_r = fs.lane_agreement(p_cut, kr)
        if agree_r < fs.CARD_SHORT_AGREEMENT_MIN or rel_r > fs.ALPHA_REL_MAX:
            fail(f"phase 12: K1-GD's ragged batch at {warps} lanes per CTA "
                 f"disagrees with the plain version ({agree_r:.4f}, "
                 f"{rel_r:.3g})")
    rargs = round_args(args, 4, seed=0, solver="gd")
    ful = rargs[7]
    k2 = fs.fused_round(*rargs, solver="gd")
    torch.cuda.synchronize()
    p2 = fs.fused_round_reference(*rargs, solver="gd")
    agree2, rel2, k2_abs_err = round_agreement(p2, k2, ful)
    say(f"phase 12 K2-GD one round ({SHORT_BATCH} random scenes, n_r 4, "
        f"{int((ful > 0.5).sum())} lanes fulfilled, learning rates "
        f"{list(scfg.gd_lr[:4])}): lane agreement {agree2:.4f}, alpha error "
        f"on agreeing lanes {k2_abs_err:.3g} abs, {rel2:.3g} of the lane's "
        f"scale")
    if agree2 < fs.CARD_SHORT_AGREEMENT_MIN or rel2 > fs.ALPHA_REL_MAX:
        fail("phase 12: K2-GD disagrees with its plain version")
    if not (torch.equal(k2.alpha[:, :, ful[0] > 0.5],
                        rargs[4][:, :, ful[0] > 0.5])
            and bool((k2.inner[ful > 0.5] == 0).all())):
        fail("phase 12: K2-GD moved a lane that came in fulfilled")
    cut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x) and x.dim() > 1
           and x.shape[-1] == SHORT_BATCH else x for x in rargs]
    for warps, ctas in grid_shapes():
        kr = fs.fused_round(cut[0].replace(pallas_block_b=warps), *cut[1:],
                            solver="gd", ctas=ctas)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                   for x, y in zip(kr, k2)):
            fail(f"phase 12: K2-GD, {RAGGED_BATCH} lanes at {warps} lanes "
                 f"per CTA, {ctas or 'all'} CTAs differ from the full batch's")
    say(f"phase 12 ragged batch ({RAGGED_BATCH} lanes at {WARP_SHAPES} lanes "
        f"per CTA on the full grid, and on one CTA): K1-GD and K2-GD bitwise "
        f"equal to the full batch's lanes; K1-GD lane agreement with the "
        f"plain version {agree_r:.4f}")
    del k, p, p_cut, k2, p2, args, rargs, cut

    # -- phase 13: the GD fused path -----------------------------------------
    phase_clock(13)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    fs.fused_solve.launches = 0
    fs.fused_round.launches = 0
    out = bench.run_bench(batch=MAIN_BATCH, repeats=2, solver="gd")
    launches_k1 = fs.fused_solve.launches
    k2_on_main = fs.fused_round.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    res, timing = out["result"], out["timing"]
    best = min(timing["times_s"])
    ref_avg, ref_max = mt.REFERENCE_FINAL_COST["gd"]
    strict = bench.endpoint_bound(cfg, "gd")
    say(f"phase 13 GD fused path (bench --solver gd, reference scene x "
        f"{MAIN_BATCH}): {MAIN_BATCH / best:.1f} solves/s, "
        f"{1e6 * best / MAIN_BATCH:.4f} us/solve (best of "
        f"{[round(t, 4) for t in timing['times_s']]} s; first run "
        f"{timing['first_s']:.2f} s), K1 launches {launches_k1}, K2 launches "
        f"{k2_on_main}; avg_cost {out['avg_cost']} max_cost "
        f"{out['max_cost']} endpoint_err {out['endpoint_err']}; peak device "
        f"memory {peak_gib:.3f} GiB ({held_gib:.3f} GiB held before the "
        f"run); {out['device']}, {out['power_limit']}")
    say(f"phase 13 strict bench.py verdict (endpoint < {strict} and costs "
        f"within 2%): {'PASS' if out['quality_ok'] else 'FAIL'}")
    if launches_k1 != 1 + len(timing["times_s"]) or k2_on_main:
        fail(f"phase 13: the GD fused path made {launches_k1} K1 and "
             f"{k2_on_main} K2 launches, not one K1 launch per solve")
    finite = bool(torch.isfinite(res.alpha).all()
                  and torch.isfinite(res.stats.final_cost).all())
    if not (finite and out["avg_cost"] <= ref_avg * 1.02
            and out["max_cost"] <= ref_max * 1.02
            and out["endpoint_err"] < 0.05):
        fail("phase 13: GD fused output outside the quality bounds")
    if not lanes_match_lane0((res.alpha, *res.stats), 0):
        fail("phase 13: the GD fused path's lanes differ from lane 0")
    alpha0 = res.alpha[0].clone()
    del out, res

    main_ms, main_plain_ms, k1_bound = replicated_k1(
        mt, fs, fleet, roofline, cfg, "gd", alpha0, dev, 13, "K1-GD")

    # K1-GD against the per-step GD path, and the rounds driver against
    # K1-GD (with K2-GD's ten rounds against their plain versions), on
    # FULL_BATCH random scenes at the bench's GD schedule.
    basis, scns, args = random_args(cfg, FULL_BATCH, 1)
    k1 = fs.fused_solve(*args, solver="gd")
    want = fleet.kernel_result(k1)
    step = fleet.fleet_solve(cfg, basis, scns, solver="gd", backend="pallas")
    bitwise = same_result(step, want)
    agree_s, _ = fs.lane_agreement(
        k1, fs.FusedSolve(step.alpha.movedim(0, -1).movedim(1, 0),
                          *(x.to(torch.float32)[None] for x in (
                              step.stats.final_cost, step.stats.converged,
                              step.stats.outer_iters,
                              step.stats.inner_iters))))
    say(f"phase 13 K1-GD against the per-step GD path (K5 + K4) on "
        f"{FULL_BATCH} random scenes: bitwise equal {bitwise}, lane "
        f"agreement {agree_s:.4f} (bound: bitwise, or >= "
        f"{fs.CARD_SHORT_AGREEMENT_MIN}); converged "
        f"{float(k1.fulfilled.mean()):.4f}")
    if not bitwise and agree_s < fs.CARD_SHORT_AGREEMENT_MIN:
        fail("phase 13: K1-GD and the per-step GD path disagree")
    k2_ms, k2_ms_first, k2_plain_ms, k2_bound, k2_ms_warm = (
        rounds_driver_check(fs, fleet, roofline, cfg, args, want, "gd", 13,
                            "GD rounds driver", "K2-GD"))
    del k1, want, step, args, scns
    torch.cuda.empty_cache()

    # The GD heterogeneous path: 1M random scenes, compaction on with the
    # paired GD xla gate, then off, then K1-GD on the same scenes.
    fs.fused_round.launches = 0
    fs.fused_solve.launches = 0
    with KernelTimer(fs, "fused_round") as timer:
        het = bench.run_bench(batch=MAIN_BATCH, repeats=2, solver="gd",
                              random_scenarios=True, seed=0,
                              quality_check_lanes=CHECK_LANES)
    het_launches = fs.fused_round.launches
    het_k1 = fs.fused_solve.launches
    times = het["timing"]["times_s"]
    k2_solve_ms = timer.total_ms() / (1 + len(times))
    b = het["gate"]["bands"]
    say(f"phase 13 GD heterogeneous path, compaction on ({MAIN_BATCH} random "
        f"scenes): {MAIN_BATCH / min(times):.1f} solves/s (best of "
        f"{[round(t, 4) for t in times]} s), {het_launches} K2-GD launches, "
        f"{het_k1} K1 launches; K2-GD {k2_solve_ms:.1f} ms per solve; "
        f"converged {het['converged_frac']}; paired GD xla gate on "
        f"{CHECK_LANES} lanes (xla engine {het['timing']['xla_s']:.2f} s): "
        f"converged {b['check_converged_frac']:.4f} vs xla "
        f"{het['xla_converged_frac']} (band {b['converged']:.4f}); obstacle "
        f"cost {b['check_obstacle_cost']:.5f} vs {b['xla_obstacle_cost']:.5f} "
        f"(band {b['cost']:.5f}); phantom {het['phantom_frac']} (bound "
        f"{b['phantom']:.2e}): {'PASS' if het['quality_ok'] else 'FAIL'}")
    if het_launches != rounds * (1 + len(times)):
        fail(f"phase 13: {het_launches} K2-GD launches on the GD "
             f"heterogeneous path, not {rounds} per solve")
    gate_ok = het["quality_ok"]
    res_on = het.pop("result")
    del het
    off = bench.run_bench(batch=MAIN_BATCH, repeats=2, solver="gd",
                          random_scenarios=True, seed=0,
                          quality_check_lanes=0, lane_compaction=False)
    res_off = off.pop("result")
    off_times = off["timing"]["times_s"]
    same_off = same_result(res_on, res_off)
    del res_off, off
    say(f"phase 13 GD compaction off: {MAIN_BATCH / min(off_times):.1f} "
        f"solves/s (best of {[round(t, 4) for t in off_times]} s), per-lane "
        f"results equal the compacted run's bit for bit: {same_off}")
    k1_rand_ms, same_k1, k1_rand_bound, k2_rand_bound = random_k1(
        mt, fs, fleet, roofline, cfg, "gd", res_on, dev, 13, "K1-GD")
    if not (same_off and same_k1):
        fail("phase 13: the GD rounds driver (compaction on/off) and K1-GD "
             "differ on the same scenes")
    if not (torch.isfinite(res_on.alpha).all()
            and torch.isfinite(res_on.stats.final_cost).all()):
        fail("phase 13: non-finite GD output")
    if not gate_ok:
        fail("phase 13: the paired GD xla gate failed")
    del res_on
    torch.cuda.empty_cache()

    def entry(launches, max_abs_err, ms, plain_ms, bound, occ, **extra):
        return {"launches": launches, "max_abs_err": max_abs_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound.ms,
                "bound_by": bound.by, "library_ms": None, **extra,
                "occupancy": occ}

    return {
        "fused_solve": entry(launches_k1, k1_abs_err, main_ms, main_plain_ms,
                             k1_bound, occupancy["fused_solve", "gd"],
                             ms_1M_random=k1_rand_ms,
                             bound_ms_1M_random=k1_rand_bound.ms,
                             main_path_peak_gib=peak_gib,
                             held_before_gib=held_gib),
        "fused_round": entry(het_launches, k2_abs_err, k2_ms, k2_plain_ms,
                             k2_bound, occupancy["fused_round", "gd"],
                             ms_first_reading=k2_ms_first,
                             ms_warm_up=k2_ms_warm,
                             ms_per_solve_1M_random=k2_solve_ms,
                             bound_ms_per_solve_1M_random=k2_rand_bound.ms),
    }


def exact_phases(mt, bench, fs, sk, roofline, fleet, dev, random_args,
                 occupancy):
    """Phases 14-16, BLS with the exact ladder through K1, K2 and K3;
    returns the "exact" entries of K1's, K2's and K3's lines in the kernels
    line."""
    cfg = bench.bench_config(ladder_eval="exact")
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles
    rounds = len(fs.inner_schedule(cfg))

    # -- phase 14: K1-exact and K2-exact against plain ------------------------
    phase_clock(14)
    scfg = mt.PlannerConfig(max_outer_iteration=2, max_inner_iteration=6,
                            fixed_iters=True, max_obstacles=11,
                            ladder_eval="exact")
    _, _, args = random_args(scfg, SHORT_BATCH, 0)
    k = fs.fused_solve(*args)
    torch.cuda.synchronize()
    p = fs.fused_solve_reference(*args)
    k1_agree, rel = fs.lane_agreement(p, k)
    same = ((k.inner_iters == p.inner_iters) & (k.outer_iters == p.outer_iters)
            & (k.fulfilled == p.fulfilled))[0]
    k1_abs_err = float((k.alpha - p.alpha).abs()[:, :, same].max())
    say(f"phase 14 K1-exact short horizon ({SHORT_BATCH} random scenes, 2x6 "
        f"steps): lane agreement {k1_agree:.4f} (bound >= "
        f"{fs.CARD_SHORT_AGREEMENT_MIN}), alpha error on agreeing lanes "
        f"{k1_abs_err:.3g} abs, {rel:.3g} of the lane's scale (bound <= "
        f"{fs.ALPHA_REL_MAX})")
    if k1_agree < fs.CARD_SHORT_AGREEMENT_MIN or rel > fs.ALPHA_REL_MAX:
        fail("phase 14: K1-exact disagrees with its plain version")
    cut = [x[..., :RAGGED_BATCH] for x in args[4:]]
    for warps, ctas in grid_shapes():
        kr = fs.fused_solve(scfg.replace(pallas_block_b=warps), *args[1:4],
                            *cut, ctas=ctas)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                   for x, y in zip(kr, k)):
            fail(f"phase 14: K1-exact, {RAGGED_BATCH} lanes at {warps} lanes "
                 f"per CTA, {ctas or 'all'} CTAs differ from the same lanes "
                 f"of the {SHORT_BATCH}-lane run")
    rargs = round_args(args, 4, seed=0)
    ful = rargs[7]
    k2 = fs.fused_round(*rargs)
    torch.cuda.synchronize()
    p2 = fs.fused_round_reference(*rargs)
    k2_agree, rel2, k2_abs_err = round_agreement(p2, k2, ful)
    say(f"phase 14 K2-exact one round ({SHORT_BATCH} random scenes, n_r 4, "
        f"{int((ful > 0.5).sum())} lanes fulfilled): lane agreement "
        f"{k2_agree:.4f}, alpha error on agreeing lanes {k2_abs_err:.3g} abs, "
        f"{rel2:.3g} of the lane's scale")
    if k2_agree < fs.CARD_SHORT_AGREEMENT_MIN or rel2 > fs.ALPHA_REL_MAX:
        fail("phase 14: K2-exact disagrees with its plain version")
    if not (torch.equal(k2.alpha[:, :, ful[0] > 0.5],
                        rargs[4][:, :, ful[0] > 0.5])
            and bool((k2.inner[ful > 0.5] == 0).all())):
        fail("phase 14: K2-exact moved a lane that came in fulfilled")
    rcut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x) and x.dim() > 1
            and x.shape[-1] == SHORT_BATCH else x for x in rargs]
    for warps, ctas in grid_shapes():
        kr = fs.fused_round(rcut[0].replace(pallas_block_b=warps), *rcut[1:],
                            ctas=ctas)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                   for x, y in zip(kr, k2)):
            fail(f"phase 14: K2-exact, {RAGGED_BATCH} lanes at {warps} lanes "
                 f"per CTA, {ctas or 'all'} CTAs differ from the full batch's")
    say(f"phase 14 ragged batch ({RAGGED_BATCH} lanes at {WARP_SHAPES} lanes "
        f"per CTA on the full grid, and on one CTA): K1-exact and K2-exact "
        f"bitwise equal to the full batch's lanes")

    # -- phase 15: K3-exact against plain, one step ---------------------------
    phase_clock(15)
    _, kv, kvt, mix, a0, _, _, start, goal, ox, oy, ow = args
    lsg, ljl, lr0 = rargs[5], rargs[6], rargs[8]
    ev = sk.cost_grad_eval(scfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox,
                           oy, ow)
    sargs = (kv, kvt, mix, a0, ev.grad, ev.traj, ev.vel, ev.loss, lr0, ful,
             lsg, ljl, start, goal, ox, oy, ow)
    ks = sk.bls_inner_step(scfg, *sargs)
    torch.cuda.synchronize()
    frozen = ful[0] > 0.5
    if not all(torch.equal(x[..., frozen], y[..., frozen])
               for x, y in zip(ks, sargs[3:10])):
        fail("phase 15: the exact step moved a frozen lane")
    k3_agree, err = step_errors(sk.bls_inner_step_reference(scfg, *sargs), ks)
    say(f"phase 15 K3-exact one step ({SHORT_BATCH} random scenes, "
        f"{int(frozen.sum())} frozen, {int((ks.minimized - ful).sum())} stop): "
        f"frozen lanes bitwise unchanged; {step_summary(k3_agree, err)}")
    if not step_ok(k3_agree, err):
        fail("phase 15: K3-exact disagrees with its plain version")
    k3_abs_err = err["abs"]
    scut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x)
            and x.shape[-1] == SHORT_BATCH else x for x in sargs]
    for bt in (64, 128, 256):
        kr = sk.bls_inner_step(scfg.replace(pallas_block_b=bt), *scut)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH]) for x, y in zip(kr, ks)):
            fail(f"phase 15: K3-exact, {RAGGED_BATCH} lanes at {bt} threads "
                 f"per CTA differ from the full batch's")
    say(f"phase 15 ragged batch ({RAGGED_BATCH} lanes at 64/128/256 threads: "
        f"2/4/8 lanes per CTA): K3-exact bitwise equal to the full batch's "
        f"lanes")
    del k, p, k2, p2, ks, ev, args, rargs, sargs, cut, rcut, scut

    # K3-exact at full width from K5's state on the main path's inputs
    # (round 0, step 0: every lane live).
    basis = mt.make_basis(cfg, device=dev)
    scn0 = mt.reference_scenario(cfg, device=dev)
    margs = fleet.fused_args(cfg, basis,
                             mt.replicate_scenario(scn0, MAIN_BATCH))[1:]
    mkv, mkvt, mmix, ma0, mlsg = margs[:5]
    mtail = margs[4:]
    mev = sk.cost_grad_eval(cfg, mkv, mkvt, mmix, ma0, *mtail)
    state0 = (ma0, *mev[1:], mev.loss, torch.full_like(mlsg, cfg.bls_lr_start),
              torch.zeros_like(mlsg))
    k3_ms, k3_plain_ms, tally, agree, err = full_width_step(
        sk.bls_inner_step, sk.bls_inner_step_reference, cfg,
        (mkv, mkvt, mmix), state0, mtail)
    k3_bound = roofline.bls_inner_step(MAIN_BATCH, T, J, O, tally, "exact")
    say(f"phase 15 K3-exact at {MAIN_BATCH} lanes (main path's inputs, round "
        f"0 step 0, best of {TIMED_LAUNCHES}): {k3_ms:.3f} ms, plain "
        f"{k3_plain_ms:.1f} ms, bound {k3_bound.ms:.3f} ms by {k3_bound.by} "
        f"({', '.join(f'{key} {float(v.sum()):.0f}' for key, v in tally.items())}); "
        f"against plain: {step_summary(agree, err)}")
    if not step_ok(agree, err):
        fail(f"phase 15: K3-exact disagrees with its plain version at "
             f"{MAIN_BATCH} lanes")
    k3_abs_err = max(k3_abs_err, err["abs"])
    del mev, state0, margs, mtail, ma0, tally
    torch.cuda.empty_cache()

    # -- phase 16: the exact paths --------------------------------------------
    phase_clock(16)
    # K1-exact against the per-step exact path (K5 per round, K3-exact per
    # step, no K6), and the rounds driver against K1-exact, on FULL_BATCH
    # random scenes at the bench's schedule.
    basis, scns, args = random_args(cfg, FULL_BATCH, 1)
    k1 = fs.fused_solve(*args)
    want = fleet.kernel_result(k1)
    for name in ("bls_inner_step", "cost_grad_eval", "forward_eval"):
        getattr(sk, name).launches = 0
    step = fleet.fleet_solve(cfg, basis, scns, backend="pallas")
    step_launches = {name: getattr(sk, name).launches
                     for name in ("bls_inner_step", "cost_grad_eval",
                                  "forward_eval")}
    bitwise = same_result(step, want)
    say(f"phase 16 K1-exact against the per-step exact path (K5 + K3-exact) "
        f"on {FULL_BATCH} random scenes: bitwise equal {bitwise}; per-step "
        f"launches {step_launches}; converged "
        f"{float(k1.fulfilled.mean()):.4f}")
    if not bitwise:
        fail("phase 16: K1-exact and the per-step exact path differ")
    if step_launches["forward_eval"] or not step_launches["bls_inner_step"]:
        fail(f"phase 16: the per-step exact path launched {step_launches}: "
             f"K3 every step and no K6")
    k2_ms, k2_ms_first, k2_plain_ms, k2_bound, k2_ms_warm = (
        rounds_driver_check(fs, fleet, roofline, cfg, args, want, "bls", 16,
                            "exact rounds driver", "K2-exact"))
    del k1, want, step, args, scns
    torch.cuda.empty_cache()

    # bench --ladder-eval exact: the replicated reference scene at full
    # width, one K1-exact launch per solve.
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    fs.fused_solve.launches = 0
    fs.fused_round.launches = 0
    out = bench.run_bench(batch=MAIN_BATCH, repeats=2, ladder_eval="exact")
    launches_k1 = fs.fused_solve.launches
    k2_on_main = fs.fused_round.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    res, timing = out["result"], out["timing"]
    best = min(timing["times_s"])
    ref_avg, ref_max = mt.REFERENCE_FINAL_COST["bls"]
    gate = bench.endpoint_bound(cfg, "bls")
    say(f"phase 16 exact path (bench --ladder-eval exact, reference scene x "
        f"{MAIN_BATCH}): {MAIN_BATCH / best:.1f} solves/s, "
        f"{1e6 * best / MAIN_BATCH:.4f} us/solve (best of "
        f"{[round(t, 4) for t in timing['times_s']]} s; first run "
        f"{timing['first_s']:.2f} s), K1 launches {launches_k1}, K2 launches "
        f"{k2_on_main}; avg_cost {out['avg_cost']} max_cost "
        f"{out['max_cost']} endpoint_err {out['endpoint_err']}; peak device "
        f"memory {peak_gib:.3f} GiB ({held_gib:.3f} GiB held before the "
        f"run); {out['device']}, {out['power_limit']}")
    say(f"phase 16 bench.py verdict for the exact ladder (endpoint < {gate} "
        f"and costs within 2%): {'PASS' if out['quality_ok'] else 'FAIL'}; "
        f"the strict endpoint reading (< {cfg.eps_position}, the linearized "
        f"ladder's gate): {out['endpoint_err']} "
        f"{'PASS' if out['endpoint_err'] < cfg.eps_position else 'FAIL'}")
    if launches_k1 != 1 + len(timing["times_s"]) or k2_on_main:
        fail(f"phase 16: the exact path made {launches_k1} K1 and "
             f"{k2_on_main} K2 launches, not one K1 launch per solve")
    finite = bool(torch.isfinite(res.alpha).all()
                  and torch.isfinite(res.stats.final_cost).all())
    if not (finite and out["quality_ok"] and out["avg_cost"] <= ref_avg * 1.02
            and out["max_cost"] <= ref_max * 1.02
            and out["endpoint_err"] < gate):
        fail("phase 16: exact output outside the quality bounds")
    if not lanes_match_lane0((res.alpha, *res.stats), 0):
        fail("phase 16: the exact path's lanes differ from lane 0")
    alpha0 = res.alpha[0].clone()
    del out, res

    main_ms, main_plain_ms, k1_bound = replicated_k1(
        mt, fs, fleet, roofline, cfg, "bls", alpha0, dev, 16, "K1-exact")

    # The exact heterogeneous path: 1M random scenes, compaction on with the
    # paired gate against the exact xla engine, then K1-exact on the same
    # scenes.
    fs.fused_round.launches = 0
    fs.fused_solve.launches = 0
    with KernelTimer(fs, "fused_round") as timer:
        het = bench.run_bench(batch=MAIN_BATCH, repeats=2, ladder_eval="exact",
                              random_scenarios=True, seed=0,
                              quality_check_lanes=CHECK_LANES)
    het_launches = fs.fused_round.launches
    het_k1 = fs.fused_solve.launches
    times = het["timing"]["times_s"]
    k2_solve_ms = timer.total_ms() / (1 + len(times))
    b = het["gate"]["bands"]
    say(f"phase 16 exact heterogeneous path, compaction on ({MAIN_BATCH} "
        f"random scenes): {MAIN_BATCH / min(times):.1f} solves/s (best of "
        f"{[round(t, 4) for t in times]} s), {het_launches} K2-exact "
        f"launches, {het_k1} K1 launches; K2-exact {k2_solve_ms:.1f} ms per "
        f"solve; converged {het['converged_frac']}; paired exact xla gate on "
        f"{CHECK_LANES} lanes (xla engine {het['timing']['xla_s']:.2f} s): "
        f"converged {b['check_converged_frac']:.4f} vs xla "
        f"{het['xla_converged_frac']} (band {b['converged']:.4f}); obstacle "
        f"cost {b['check_obstacle_cost']:.5f} vs {b['xla_obstacle_cost']:.5f} "
        f"(band {b['cost']:.5f}); phantom {het['phantom_frac']} (bound "
        f"{b['phantom']:.2e}): {'PASS' if het['quality_ok'] else 'FAIL'}")
    if het_launches != rounds * (1 + len(times)):
        fail(f"phase 16: {het_launches} K2-exact launches on the exact "
             f"heterogeneous path, not {rounds} per solve")
    gate_ok = het["quality_ok"]
    res_on = het.pop("result")
    del het
    k1_rand_ms, same_k1, k1_rand_bound, k2_rand_bound = random_k1(
        mt, fs, fleet, roofline, cfg, "bls", res_on, dev, 16, "K1-exact")
    if not same_k1:
        fail("phase 16: the exact rounds driver and K1-exact differ on the "
             "same scenes")
    if not (torch.isfinite(res_on.alpha).all()
            and torch.isfinite(res_on.stats.final_cost).all()):
        fail("phase 16: non-finite exact output")
    if not gate_ok:
        fail("phase 16: the paired exact xla gate failed")
    del res_on
    torch.cuda.empty_cache()

    # The certification statistics of the card's exact tier on the CPU
    # oracle's scenes, for information: certify.py calibrates its bounds
    # for an engine and an oracle on one platform.
    from irm_motion_planning_tpu_torch.benchmarks import certify

    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "certify_oracle_cpu2048.npz"))
    row = certify.certify_exact(data, dev)
    bc = row["both_converged"]
    say(f"phase 16 certify statistics of the card's exact tier on the CPU "
        f"oracle's {row['batch']} scenes (for information; on-platform "
        f"bounds mean {certify.MEAN_BOUNDS['exact']}, median "
        f"{certify.MEDIAN_BOUNDS['exact']}): "
        f"converged "
        f"{row['engine_converged_frac']} vs the oracle's "
        f"{row['oracle_converged_frac']}; both converged n={bc['avg']['n']}: "
        f"mean gap avg {bc['avg'].get('mean_gap')} max "
        f"{bc['max'].get('mean_gap')}, median avg {bc['avg'].get('p50_gap')} "
        f"max {bc['max'].get('p50_gap')}; all scenes mean gap avg "
        f"{row['all']['avg']['mean_gap']} max {row['all']['max']['mean_gap']};"
        f" on-platform verdict {'PASS' if row['pass'] else 'FAIL'}")

    def entry(launches, agreement, max_abs_err, ms, plain_ms, bound, **extra):
        return {"launches": launches, "lane_agreement": agreement,
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound.ms, "bound_by": bound.by,
                "library_ms": None, **extra}

    return {
        "fused_solve": entry(launches_k1, k1_agree, k1_abs_err, main_ms,
                             main_plain_ms, k1_bound,
                             ms_1M_random=k1_rand_ms,
                             bound_ms_1M_random=k1_rand_bound.ms,
                             main_path_peak_gib=peak_gib,
                             held_before_gib=held_gib,
                             occupancy=occupancy["fused_solve", "bls_exact"]),
        "fused_round": entry(het_launches, k2_agree, k2_abs_err, k2_ms,
                             k2_plain_ms, k2_bound,
                             ms_first_reading=k2_ms_first,
                             ms_warm_up=k2_ms_warm,
                             ms_per_solve_1M_random=k2_solve_ms,
                             bound_ms_per_solve_1M_random=k2_rand_bound.ms,
                             occupancy=occupancy["fused_round", "bls_exact"]),
        "bls_inner_step": entry(step_launches["bls_inner_step"], k3_agree,
                                k3_abs_err, k3_ms, k3_plain_ms, k3_bound),
    }


def large_t_phases(mt, bench, fs, sk, roofline, fleet, dev, ptxas):
    """Phase 17, large T: the streamed body of K1/K2 (K7) and K3-K6 with
    the basis in device memory.  Returns the "streamed" entries of K1-K6's
    lines and K7's line in the kernels line, and the inputs phase 18 reuses
    (the linearized ladder's scenes at T=200 and its paired gate's xla
    numbers)."""
    from irm_motion_planning_tpu_torch.benchmarks import problemsize

    phase_clock(17)
    T, J, O = LARGE_T, 3, 11
    out = {"programs": {}}

    # The L2 rate the streamed designs' basis reads divide by (a diagnostic
    # beside the bound: ops/roofline.py), two ways on an L2-resident 16 MiB
    # buffer: torch's copy of it into a second one (32 MiB in all),
    # L2_COPIES copies replayed from one CUDA graph (no host launch gaps),
    # read and write counted; and one reduction that reads it L2_READS
    # times (an expanded view, one launch).  roofline takes the larger: the
    # faster rate gives the lower time.
    src = torch.empty(L2_COPY_BYTES // 4, device=dev).uniform_()
    dst = torch.empty_like(src)
    dst.copy_(src)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(L2_COPIES):
            dst.copy_(src)
    graph.replay()
    _, ms = timed(graph.replay)
    copy_rate = 2 * L2_COPY_BYTES * L2_COPIES / (ms * 1e-3)
    wide = src.view(1, -1).expand(L2_READS, -1)
    wide.sum(dim=1)
    _, ms = timed(lambda: wide.sum(dim=1))
    read_rate = L2_COPY_BYTES * L2_READS / (ms * 1e-3)
    l2_rate = max(copy_rate, read_rate)
    del src, dst, graph, wide
    say(f"phase 17 L2 rate: copy {copy_rate / 1e12:.3f} TB/s ({L2_COPY_BYTES >> 20}"
        f" MiB x {L2_COPIES} from one CUDA graph), read {read_rate / 1e12:.3f}"
        f" TB/s (one reduction over {L2_READS} x {L2_COPY_BYTES >> 20} MiB); "
        f"ops/roofline.py divides by {roofline.L2_BYTES_PER_S / 1e12:.3f} TB/s")

    # Streamed against resident at T = 50: K1 in the streamed plan, and the
    # rounds driver over streamed K2 with compaction off and on, each bit
    # for bit resident K1, for every program.
    for prog in fs.SOLVER_PROGRAMS:
        solver = "gd" if prog == "gd" else "bls"
        cfg = bench.bench_config(
            solver=solver,
            ladder_eval="exact" if prog == "bls_exact" else "linearized")
        basis = mt.make_basis(cfg, device=dev)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(5),
                                   FULL_BATCH, device=dev)
        args = fleet.fused_args(cfg, basis, scns)
        k_res, ms_res = timed(lambda: fs.fused_solve(*args, solver=solver,
                                                     plan="resident"))
        k_str, ms_str = timed(lambda: fs.fused_solve(*args, solver=solver,
                                                     plan="streamed"))
        want = fleet.kernel_result(k_res)
        same = [same_result(want, fleet.kernel_result(k_str))]
        for compact in (False, True):
            same.append(same_result(want, fleet._fused_rounds_solve(
                cfg.replace(lane_compaction=compact), args[1:], solver,
                plan="streamed")))
        say(f"phase 17 T=50 {prog} ({FULL_BATCH} random scenes, bench "
            f"schedule): streamed K1 {ms_str:.1f} ms against resident "
            f"{ms_res:.1f} ms; bitwise equal to resident K1: streamed K1 "
            f"{same[0]}, rounds driver on streamed K2 compaction off "
            f"{same[1]}, on {same[2]}")
        if not all(same):
            fail(f"phase 17: the streamed {prog} programs differ from the "
                 f"resident ones at T=50")
        out["programs"][prog] = {"t50_streamed_ms": ms_str,
                                 "t50_resident_ms": ms_res}
        del k_res, k_str, want, args, scns
    torch.cuda.empty_cache()

    # T = 200, kernel against plain: K1 at 2 x 6 steps and K2 for one round
    # with a quarter of the lanes fulfilled, for each program; the ragged
    # batch at every lanes-per-CTA shape of the plan and on one CTA.
    scfg = mt.PlannerConfig(n_timesteps=T, max_outer_iteration=2,
                            max_inner_iteration=6, fixed_iters=True,
                            max_obstacles=O)
    plan = fs.launch_plan(scfg, O)
    # Tiles of 1-3 lanes, half the plan's, one fewer and the plan's: 1,000
    # lanes leave the last tile ragged at 3 and 7 (the plan's 8 - 1).
    lanes = plan["lanes"]
    shapes = sorted({1, 2, 3, lanes // 2, lanes - 1, lanes})
    basis = mt.make_basis(scfg, device=dev)
    scns = mt.random_scenarios(scfg, torch.Generator().manual_seed(6),
                               SHORT_BATCH, device=dev)
    args0 = fleet.fused_args(scfg, basis, scns)
    agreement, max_abs = {}, 0.0
    for prog in fs.SOLVER_PROGRAMS:
        solver = "gd" if prog == "gd" else "bls"
        c = scfg.replace(ladder_eval="exact" if prog == "bls_exact"
                         else "linearized")
        args = (c, *args0[1:])
        k = fs.fused_solve(*args, solver=solver)
        p = fs.fused_solve_reference(*args, solver=solver)
        agree, rel = fs.lane_agreement(p, k)
        same = ((k.inner_iters == p.inner_iters)
                & (k.outer_iters == p.outer_iters)
                & (k.fulfilled == p.fulfilled))[0]
        max_abs = max(max_abs, float((k.alpha - p.alpha).abs()[:, :, same]
                                     .max()))
        rargs = round_args(args, 4, seed=0, solver=solver)
        ful = rargs[7]
        k2 = fs.fused_round(*rargs, solver=solver)
        agree2, rel2, abs2 = round_agreement(
            fs.fused_round_reference(*rargs, solver=solver), k2, ful)
        max_abs = max(max_abs, abs2)
        agreement[prog] = min(agree, agree2)
        # The fulfilled lanes are masked in their tiles: each passes
        # through, alpha bit for bit, no step, loss 0 and ok 1.
        passed = ful[0] > 0.5
        through = (torch.equal(k2.alpha[..., passed], rargs[4][..., passed])
                   and bool((k2.inner[0, passed] == 0).all())
                   and bool((k2.loss[0, passed] == 0).all())
                   and bool((k2.ok[0, passed] == 1).all()))
        say(f"phase 17 T={T} {prog} against plain ({SHORT_BATCH} random "
            f"scenes, {lanes} lanes per CTA): K1 at 2x6 steps lane "
            f"agreement {agree:.4f}, alpha {rel:.3g} of the lane's scale; K2 "
            f"one round ({int(passed.sum())} fulfilled, passed through in "
            f"their tiles: {through}) {agree2:.4f}, "
            f"{rel2:.3g} (bounds >= {fs.CARD_SHORT_AGREEMENT_MIN}, <= "
            f"{fs.ALPHA_REL_MAX})")
        if (min(agree, agree2) < fs.CARD_SHORT_AGREEMENT_MIN
                or max(rel, rel2) > fs.ALPHA_REL_MAX or not through):
            fail(f"phase 17: streamed {prog} disagrees with its plain "
                 f"version at T={T}")
        cut = [x[..., :RAGGED_BATCH] for x in args[4:]]
        rcut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x) and x.dim() > 1
                and x.shape[-1] == SHORT_BATCH else x for x in rargs]
        for warps, ctas in [(w, 0) for w in shapes] + [(0, 1)]:
            cw = c.replace(pallas_block_b=warps)
            kr = fs.fused_solve(cw, *args[1:4], *cut, solver=solver,
                                ctas=ctas)
            k2r = fs.fused_round(cw, *rcut[1:], solver=solver, ctas=ctas)
            if not (all(torch.equal(x, y[..., :RAGGED_BATCH])
                        for x, y in zip(kr, k))
                    and all(torch.equal(x, y[..., :RAGGED_BATCH])
                            for x, y in zip(k2r, k2))):
                fail(f"phase 17: {prog} at T={T}, {RAGGED_BATCH} lanes at "
                     f"{warps} lanes per CTA, {ctas or 'all'} CTAs differ "
                     f"from the full batch's")
        del k, p, k2
    say(f"phase 17 T={T} ragged batch ({RAGGED_BATCH} lanes at {shapes} "
        f"lanes per CTA and on one CTA): K1 and K2 bitwise equal to the full "
        f"batch's lanes, every program")

    # K3-K6 at T = 200 (K3-K5 in the streamed body) against plain at 1,024
    # lanes, the ragged batch at 64/128/256 threads (2/4/8 lanes per CTA)
    # bitwise.
    if not all(plan(scfg, O)["plan"] == "streamed" for plan in (
            sk.bls_step_plan, sk.gd_step_plan, sk.cost_grad_eval_plan)):
        fail(f"phase 17: a per-step kernel's plan is not the streamed one at "
             f"T={T}")
    _, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args0
    rargs = round_args(args0, 4, seed=0)
    lsg, ljl, ful, lr0 = rargs[5:9]
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    ek = sk.cost_grad_eval(scfg, *eargs)
    fk = sk.forward_eval(scfg, kv, mix, a0)
    k5_err = eval_errors(ek, sk.cost_grad_eval_reference(scfg, *eargs))
    k6_err = planes_error(fk, sk.forward_eval_reference(scfg, kv, mix, a0))
    k6_vs_k5(fk, ek, 17, SHORT_BATCH)
    k6_ragged(sk, scfg, kv, mix, a0, fk, 17)
    gd_lrs = torch.tensor(scfg.gd_lr[:4])[
        torch.randint(0, 4, (1, SHORT_BATCH),
                      generator=torch.Generator().manual_seed(1))].to(dev)
    step_err = {}
    for name, lr, c in (("bls", lr0, scfg),
                        ("bls_exact", lr0, scfg.replace(ladder_eval="exact")),
                        ("gd", gd_lrs, scfg)):
        fn, ref = step_fns(sk, "gd" if name == "gd" else "bls")
        sargs = (kv, kvt, mix, a0, ek.grad, ek.traj, ek.vel, ek.loss, lr, ful,
                 lsg, ljl, start, goal, ox, oy, ow)
        ks = fn(c, *sargs)
        agree, err = step_errors(ref(c, *sargs), ks)
        step_err[name] = (agree, err)
        if not step_ok(agree, err):
            fail(f"phase 17: the {name} step disagrees with its plain "
                 f"version at T={T}: {step_summary(agree, err)}")
        cut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x)
               and x.shape[-1] == SHORT_BATCH else x for x in sargs]
        for bt in step_blocks("gd" if name == "gd" else "bls"):
            kr = fn(c.replace(pallas_block_b=bt), *cut)
            if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                       for x, y in zip(kr, ks)):
                fail(f"phase 17: {name} step at T={T}, {bt} threads per "
                     f"CTA differs from the full batch's")
    ecut = [x[..., :RAGGED_BATCH] if x.shape[-1] == SHORT_BATCH else x
            for x in eargs]
    for bt in (64, 128, 256):
        cb = scfg.replace(pallas_block_b=bt)
        er = sk.cost_grad_eval(cb, *ecut)
        if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                   for x, y in zip(er, ek)):
            fail(f"phase 17: K5 at T={T}, {bt} threads per CTA differs from "
                 f"the full batch's")
    say(f"phase 17 K3-K6 at T={T} (K3-K5 streamed) against plain "
        f"({SHORT_BATCH} random scenes): K5 loss {k5_err['loss']:.3g}, grad "
        f"{k5_err['grad']:.3g}, traj/vel {k5_err['planes']:.3g}; K6 "
        f"{k6_err:.3g} (bounds {EVAL_BOUNDS}); "
        + "; ".join(f"{n} step {step_summary(*e)}" for n, e in
                    step_err.items())
        + "; ragged batch at 64/128/256 threads (2/4/8 lanes per CTA; K4 "
          "also 1/5/10/16) bitwise")
    if not (eval_ok(k5_err) and k6_err <= EVAL_BOUNDS["planes"]):
        fail(f"phase 17: K5 or K6 disagrees with its plain version at T={T}")
    step_abs = {n: e[1]["abs"] for n, e in step_err.items()}
    del ek, fk, args0, rargs, eargs
    torch.cuda.empty_cache()

    # T = 200 at full width: LARGE_BATCH random scenes for each program, as
    # bench --random-scenarios without compaction runs them (one K1 launch
    # per solve), with the paired xla gate on LARGE_CHECK lanes; K1 alone,
    # its plain version on LARGE_TALLY lanes (K1's converged fraction held
    # to the plain version's within bench.py's band), its bound (the
    # function's) beside the design's L2 reads; the rounds driver with
    # compaction bit for bit against K1, K2's time per solve and bound.  The
    # gate holds GD and the exact ladder whole.  The linearized ladder it
    # holds to its phantom and cost bands; its converged band against xla
    # is printed, not held: at T = 200 the linearized fused algorithm
    # converges fewer lanes than the xla engine, which evaluates every step
    # exactly, in the JAX package too (its fused kernel, interpreted, 4.1-7.6
    # points under its xla engine on 512 scenes at each of four seeds:
    # tools/compare_converged.py), by more than the band (2 points at these
    # fractions).  ROADMAP queue 3, fact 5 records it.
    gates_ok = True
    for prog in fs.SOLVER_PROGRAMS:
        solver = "gd" if prog == "gd" else "bls"
        ladder = "exact" if prog == "bls_exact" else "linearized"
        cfg = bench.bench_config(solver=solver, ladder_eval=ladder,
                                 n_timesteps=T)
        rounds = len(fs.inner_schedule(cfg))
        fs.fused_solve.launches = 0
        run = bench.run_bench(batch=LARGE_BATCH, repeats=1, solver=solver,
                              ladder_eval=ladder, random_scenarios=True,
                              seed=0, quality_check_lanes=LARGE_CHECK,
                              lane_compaction=False, n_timesteps=T)
        launches = fs.fused_solve.launches
        b = run["gate"]["bands"]
        best = min(run["timing"]["times_s"])
        conv_ok = (abs(b["check_converged_frac"] - b["xla_converged_frac"])
                   <= b["converged"])
        held = (run["quality_ok"] if prog != "bls" else
                run["phantom_frac"] <= b["phantom"]
                and abs(b["check_obstacle_cost"] - b["xla_obstacle_cost"])
                <= b["cost"])
        gates_ok = gates_ok and held
        say(f"phase 17 T={T} {prog} ({LARGE_BATCH} random scenes, "
            f"bench --random-scenarios --lane-compaction false): "
            f"{LARGE_BATCH / best:.1f} solves/s ({best:.4f} s), {launches} K1 "
            f"launches; converged {run['converged_frac']}; paired xla gate on "
            f"{LARGE_CHECK} lanes (xla engine {run['timing']['xla_s']:.2f} "
            f"s): converged {b['check_converged_frac']:.4f} vs xla "
            f"{run['xla_converged_frac']} (band {b['converged']:.4f}); "
            f"obstacle cost {b['check_obstacle_cost']:.5f} vs "
            f"{b['xla_obstacle_cost']:.5f} (band {b['cost']:.5f}); phantom "
            f"{run['phantom_frac']} (bound {b['phantom']:.2e}): "
            f"{'PASS' if run['quality_ok'] else 'FAIL'}"
            + ("" if prog != "bls" else
               f" (held: phantom and cost {'PASS' if held else 'FAIL'}; "
               f"converged band {'PASS' if conv_ok else 'FAIL'}, printed)"))
        if launches != 1 + len(run["timing"]["times_s"]):
            fail(f"phase 17: {launches} K1 launches at T={T}, not one per "
                 f"solve")
        run_ok = run["quality_ok"]
        del run
        basis = mt.make_basis(cfg, device=dev)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0),
                                   LARGE_BATCH, device=dev)
        args = fleet.fused_args(cfg, basis, scns)
        k1, k1_ms = timed(lambda: fs.fused_solve(*args, solver=solver))
        want = fleet.kernel_result(k1)
        sub = (cfg, *args[1:4], *(x[..., :LARGE_TALLY] for x in args[4:]))
        p1, plain_ms = timed(lambda: fs.fused_solve_reference(*sub,
                                                              solver=solver))
        # K1's converged fraction against its plain version's on the same
        # LARGE_TALLY lanes, within bench.py's converged band.
        k_conv = float((k1.fulfilled[0, :LARGE_TALLY] > 0.5).float().mean())
        p_conv = float((p1.fulfilled[0] > 0.5).float().mean())
        plain_band = max(0.02, min(0.15 * max(k_conv, p_conv), 0.05))
        plain_conv_ok = abs(k_conv - p_conv) <= plain_band
        gates_ok = gates_ok and plain_conv_ok
        say(f"phase 17 T={T} {prog} K1 against its plain version on the "
            f"first {LARGE_TALLY} scenes: converged {k_conv:.4f} vs plain "
            f"{p_conv:.4f} (band {plain_band:.4f}): "
            f"{'PASS' if plain_conv_ok else 'FAIL'}")
        del p1
        scale = LARGE_BATCH / LARGE_TALLY
        tally = roofline.kernel_counts(
            {key: v * scale for key, v in roofline.plain_tally(
                fs.fused_solve_reference, *sub, solver=solver).items()},
            float((k1.outer_iters + k1.fulfilled).sum()),
            float(k1.inner_iters.sum()), solver)
        tile = fs.launch_plan(cfg, O, prog=prog)["lanes"]
        k1_bound = roofline.fused_rounds(LARGE_BATCH, T, J, O, tally, True,
                                         solver, ladder, streamed=True,
                                         lanes_per_cta=tile)
        with KernelTimer(fs, "fused_round") as timer:
            got = fleet._fused_rounds_solve(cfg.replace(lane_compaction=True),
                                            args[1:], solver)
        k2_ms = timer.total_ms()
        same = same_result(got, want)
        with plain_rounds(fs):
            _, k2_plain_ms = timed(lambda: fleet._fused_rounds_solve(
                cfg, sub[1:], solver))
        rounds_run = (k1.outer_iters + k1.fulfilled)[0]
        live = [float((rounds_run > r).sum()) for r in range(rounds)]
        k2_bound = roofline.fused_round_launches(LARGE_BATCH, T, J, O, tally,
                                                 live, solver, ladder,
                                                 streamed=True,
                                                 lanes_per_cta=tile)
        say(f"phase 17 T={T} {prog} K1 alone {k1_ms:.1f} ms "
            f"({1e3 * k1_ms / LARGE_BATCH:.3f} us per lane), plain version "
            f"{plain_ms:.1f} ms on {LARGE_TALLY} lanes; bound {k1_bound.ms:.1f} "
            f"ms by {k1_bound.by} (the function's; the design's basis reads "
            f"{k1_bound.l2_bytes / 1e9:.2f} GB, "
            f"{k1_bound.l2_bytes / LARGE_BATCH / 1e6:.2f} MB per lane, "
            f"{k1_bound.design_l2_ms:.1f} ms at the L2 rate); rounds driver "
            f"with compaction ({rounds} K2 launches, {k2_ms:.1f} ms in K2, "
            f"bound {k2_bound.ms:.1f} ms by {k2_bound.by}, the design's L2 "
            f"reads {k2_bound.design_l2_ms:.1f} ms; plain rounds "
            f"{k2_plain_ms:.1f} ms on "
            f"{LARGE_TALLY} lanes) bitwise equal to K1: {same}; work "
            f"{({key: round(v) for key, v in tally.items()})}")
        if not same:
            fail(f"phase 17: the rounds driver differs from K1 at T={T}")
        if not (torch.isfinite(k1.alpha).all()
                and torch.isfinite(k1.final_loss).all()):
            fail(f"phase 17: non-finite {prog} output at T={T}")
        out["programs"][prog].update(
            gate={"ok": run_ok, "converged_band_ok": conv_ok, "held": held,
                  "plain_converged": [k_conv, p_conv, plain_band]},
            k1_ms=k1_ms, k1_plain_ms=plain_ms, k1_bound=k1_bound,
            k2_ms=k2_ms, k2_plain_ms=k2_plain_ms, k2_bound=k2_bound,
            solves_per_s=LARGE_BATCH / best,
            agreement=agreement[prog], launches=launches, k2_launches=rounds)
        if prog == "bls":
            # Phase 18 runs the kernel tiers on these scenes and holds them
            # to this run's xla engine (the paired gate's lanes).
            out["tier_inputs"] = dict(
                cfg=cfg, basis=basis, scns=scns, args=args,
                xla_conv=b["xla_converged_frac"],
                xla_cost=b["xla_obstacle_cost"], k1_ms=k1_ms,
                k1_conv=b["check_converged_frac"], plain_conv=p_conv)
        # The per-step path on STEP_BATCH of the scenes equals K1 bit for
        # bit in every program (the same op sequence: the linearized
        # ladder's recomputed loss is the accepted rung's); the linearized
        # one's launches and kernel times go to the kernels line.
        n = STEP_BATCH
        scns_n = mt.Scenario(*(x[:n] for x in scns))
        names = (["cost_grad_eval",
                  "gd_inner_step" if prog == "gd" else "bls_inner_step"]
                 + (["forward_eval"] if prog == "bls" else []))
        for nm in names:
            getattr(sk, nm).launches = 0
        with KernelTimer(sk, *names) as st:
            step = fleet.fleet_solve(cfg, basis, scns_n, solver=solver,
                                     backend="pallas")
        k1n = fs.fused_solve(*fleet.fused_args(cfg, basis, scns_n),
                             solver=solver)
        same = same_result(step, fleet.kernel_result(k1n))
        counts = {nm: getattr(sk, nm).launches for nm in names}
        say(f"phase 17 T={T} {prog} per-step path on {n} of the scenes: "
            f"launches {counts}, kernel ms "
            f"{ {nm: round(st.total_ms(nm), 1) for nm in names} }; "
            f"bitwise equal to K1: {same}")
        if not same or min(counts.values()) < 1:
            fail(f"phase 17: the {prog} per-step path at T={T} differs "
                 f"from K1 or launched nothing")
        out["programs"][prog]["step"] = {
            nm: (counts[nm], st.total_ms(nm)) for nm in names}
        del step, k1n
        del k1, want, got, args, scns
        torch.cuda.empty_cache()
    if not gates_ok:
        fail(f"phase 17: a paired xla gate failed at T={T}")

    # The linearized per-step path at T = 200 (K5, K3, K6): its launch
    # counts and kernel times from the run above; then each per-step kernel
    # timed at LARGE_BATCH lanes on the main path's inputs at T = 200 (the
    # reference scene replicated, at the warm start, round 0 step 0), as
    # phase 9 times them at T = 50, and held to its plain version there.
    cfg = bench.bench_config(n_timesteps=T)
    basis = mt.make_basis(cfg, device=dev)
    step_launches = {nm: c for nm, (c, _) in
                     out["programs"]["bls"]["step"].items()}
    step_ms = {nm: ms for nm, (_, ms) in
               out["programs"]["bls"]["step"].items()}
    scns = mt.replicate_scenario(mt.reference_scenario(cfg, device=dev),
                                 LARGE_BATCH)
    _, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = fleet.fused_args(
        cfg, basis, scns)
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    ev = sk.PallasEval(torch.empty_like(lsg),
                       *(torch.empty_like(a0) for _ in range(3)))
    k5_ms = best_ms(lambda: sk.cost_grad_eval(cfg, *eargs, out=ev))
    _, k5_plain = timed(lambda: sk.cost_grad_eval_reference(cfg, *eargs))
    k6_out = sk.PallasForward(torch.empty_like(a0), torch.empty_like(a0))
    k6_ms = best_ms(lambda: sk.forward_eval(cfg, kv, mix, a0, out=k6_out))
    _, k6_plain = timed(lambda: sk.forward_eval_reference(cfg, kv, mix, a0))
    k6_lib = best_ms(lambda: torch.einsum("st,jtb,ji->isb", kv, a0, mix))
    k6_vs_k5(k6_out, ev, 17, LARGE_BATCH)
    # K7 alone (fused_solve.k7_forward): the forward product the streamed
    # programs run, on the plan's tiles of lanes, bit for bit K6 on the same
    # alpha; its time per product beside one torch.matmul of the same
    # (2T x T) by (T x J B) product (TF32 off) and the plain version, and
    # the design's L2 reads: the basis rows of each row block, once per tile.
    k7_out = fs.k7_forward(cfg, kv, kvt, mix, a0)
    k7_same = (torch.equal(k7_out[0], k6_out.traj)
               and torch.equal(k7_out[1], k6_out.vel))
    k7_ms = best_ms(lambda: fs.k7_forward(cfg, kv, kvt, mix, a0))
    _, k7_plain = timed(lambda: fs.forward_planes(kv, mix, a0))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    flat = a0.permute(1, 0, 2).reshape(T, J * LARGE_BATCH)
    k7_mm = best_ms(lambda: torch.matmul(kv, flat))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    kplan = fs.launch_plan(cfg, O)
    rb = kplan["ring"]["kv"]["row_block"]
    k7_l2 = (-(-LARGE_BATCH // kplan["lanes"]) * -(-2 * T // rb) * rb * T
             * 4)
    say(f"phase 17 K7 alone at T={T}, {LARGE_BATCH} lanes (one forward "
        f"product, {kplan['lanes']} lanes per CTA, row block {rb}, "
        f"{kplan['ring']['kv']['stage_t']} timesteps per stage): "
        f"{k7_ms:.3f} ms, bitwise K6 {k7_same}; K6 {k6_ms:.3f} ms; one "
        f"torch.matmul {k7_mm:.3f} ms; plain {k7_plain:.1f} ms; the design's "
        f"L2 reads {k7_l2 / 1e9:.3f} GB ({k7_l2 / LARGE_BATCH / 1e3:.1f} KB "
        f"per lane)")
    if not k7_same:
        fail(f"phase 17: K7 alone differs from K6 at T={T}")
    del k7_out, flat
    steps = {}
    for name, lr in (("bls", torch.full_like(lsg, cfg.bls_lr_start)),
                     ("gd", torch.full_like(lsg, cfg.gd_lr[0]))):
        fn, ref = step_fns(sk, name)
        ms, plain_ms, tally, agree, err = full_width_step(
            fn, ref, cfg, (kv, kvt, mix),
            (a0, *ev[1:], ev.loss, lr, torch.zeros_like(lsg)),
            (lsg, ljl, start, goal, ox, oy, ow))
        bound = (roofline.bls_inner_step(
                     LARGE_BATCH, T, J, O, tally, streamed=True,
                     lanes_per_cta=sk.bls_step_plan(cfg, O)["lanes"])
                 if name == "bls" else
                 roofline.gd_inner_step(
                     LARGE_BATCH, T, J, O, tally, streamed=True,
                     lanes_per_cta=sk.gd_step_plan(cfg, O)["lanes"]))
        if not step_ok(agree, err):
            fail(f"phase 17: the {name} step disagrees with its plain "
                 f"version at T={T}, {LARGE_BATCH} lanes: "
                 f"{step_summary(agree, err)}")
        steps[name] = (ms, plain_ms, bound, agree)
    k5_bound = roofline.cost_grad_eval(
        LARGE_BATCH, T, J, O, streamed=True,
        lanes_per_cta=sk.cost_grad_eval_plan(cfg, O)["lanes"])
    k6_bound = roofline.forward_eval(LARGE_BATCH, T, J)
    say(f"phase 17 T={T} per-step kernels at {LARGE_BATCH} lanes (reference "
        f"scene, round 0, step 0): K3 {steps['bls'][0]:.3f} ms (plain {steps['bls'][1]:.1f}, "
        f"bound {steps['bls'][2].ms:.3f} by {steps['bls'][2].by}); K4 "
        f"{steps['gd'][0]:.3f} ms (plain {steps['gd'][1]:.1f}, bound "
        f"{steps['gd'][2].ms:.3f} by {steps['gd'][2].by}); K5 {k5_ms:.3f} ms "
        f"(plain {k5_plain:.1f}, bound {k5_bound.ms:.3f} by {k5_bound.by}); "
        f"K6 {k6_ms:.3f} ms (plain {k6_plain:.1f}, one torch.einsum "
        f"{k6_lib:.3f}, bound {k6_bound.ms:.3f} by {k6_bound.by}: "
        f"{k6_bound.ms / k6_ms:.3f} of it)")
    del ev, k6_out, eargs, scns
    torch.cuda.empty_cache()
    ties = random_step_kernels(mt, fs, sk, fleet, cfg, basis, dev)

    # The sweep: problemsize's sizes at batch SWEEP_BATCH, the fused backend
    # (which must launch K1 at every size: no fallback) and the xla engine.
    sweep = {}
    for backend in ("fused", "xla"):
        for size in (25, 50, 100, 150, 200):
            row = problemsize.run_size(size, SWEEP_BATCH, 1, "bls", backend,
                                       15, dev)
            sweep.setdefault(size, {})[backend] = row
            if backend == "fused" and row["launches"]["fused_solve"] < 1:
                fail(f"phase 17: the fused sweep did not launch K1 at "
                     f"T={size}")
    say(f"phase 17 problemsize sweep (batch {SWEEP_BATCH}, bls, inner 15, "
        f"best of 1 after a first run): " + "; ".join(
            f"T={size} fused {r['fused']['per_solve_us']} us/solve "
            f"({r['fused']['plan']['plan']}, {r['fused']['launches']}) xla "
            f"{r['xla']['per_solve_us']} us/solve" for size, r in sweep.items()))

    def streamed(ms, bound, plain_ms, agree, **extra):
        return {"T": T, "ms": ms, "bound_ms": bound.ms, "bound_by": bound.by,
                "bytes": bound.l2_bytes, "design_l2_ms": bound.design_l2_ms,
                "plain_ms": plain_ms, "lane_agreement": agree, **extra}

    prg = out["programs"]
    bls = prg["bls"]
    k1_programs = {p: streamed(prg[p]["k1_ms"], prg[p]["k1_bound"],
                               prg[p]["k1_plain_ms"], prg[p]["agreement"],
                               lanes=LARGE_BATCH, plain_lanes=LARGE_TALLY,
                               solves_per_s=prg[p]["solves_per_s"],
                               t50_streamed_ms=prg[p]["t50_streamed_ms"],
                               t50_resident_ms=prg[p]["t50_resident_ms"])
                   for p in fs.SOLVER_PROGRAMS}
    entries = {
        "fused_solve": {**k1_programs["bls"], "programs": k1_programs,
                        "ptxas": {k: v for k, v in ptxas.items()
                                  if k.endswith(",streamed>")}},
        "fused_round": streamed(
            bls["k2_ms"], bls["k2_bound"], bls["k2_plain_ms"],
            bls["agreement"], plain_lanes=LARGE_TALLY,
            per_solve_lanes=LARGE_BATCH, launches=bls["k2_launches"],
            programs={p: {"ms": prg[p]["k2_ms"],
                          "bound_ms": prg[p]["k2_bound"].ms}
                      for p in fs.SOLVER_PROGRAMS}),
        "bls_inner_step": streamed(
            steps["bls"][0], steps["bls"][2], steps["bls"][1],
            steps["bls"][3], lanes=LARGE_BATCH,
            launches=step_launches["bls_inner_step"],
            max_abs_err=max(step_abs["bls"], step_abs["bls_exact"])),
        "gd_inner_step": streamed(
            steps["gd"][0], steps["gd"][2], steps["gd"][1], steps["gd"][3],
            lanes=LARGE_BATCH, launches=prg["gd"]["step"]["gd_inner_step"][0],
            max_abs_err=step_abs["gd"]),
        "cost_grad_eval": streamed(
            k5_ms, k5_bound, k5_plain, None, lanes=LARGE_BATCH,
            launches=step_launches["cost_grad_eval"],
            max_abs_err=k5_err["abs"]),
        "forward_eval": streamed(
            k6_ms, k6_bound, k6_plain, None, lanes=LARGE_BATCH,
            launches=step_launches["forward_eval"], max_abs_err=k6_err,
            library_ms=k6_lib, fraction_of_bound=k6_bound.ms / k6_ms),
    }
    entries["bls_inner_step"]["random"] = {
        "bls": ties["bls"], "bls_exact": ties["bls_exact"]}
    for name, key in (("gd_inner_step", "gd"),
                      ("cost_grad_eval", "cost_grad_eval"),
                      ("forward_eval", "forward_eval")):
        entries[name]["random"] = ties[key]
    # K7 runs inside the streamed programs of K1/K2: its line carries K1-BLS
    # at T = 200 (the kernel it runs in), the programs that run it and the
    # bytes each streams per solve.
    entries["k7"] = kernel_entry(
        "streamed_matmul", "warp_body.cuh", 419,
        sum(prg[p]["launches"] for p in fs.SOLVER_PROGRAMS), max_abs, bls["k1_ms"],
        bls["k1_plain_ms"], bls["k1_bound"],
        measured_as=f"K1-BLS at T={T}, {LARGE_BATCH} random scenes (plain on "
                    f"{LARGE_TALLY}): K7 has no launch of its own",
        paired_gate_t200={p: prg[p]["gate"] for p in fs.SOLVER_PROGRAMS},
        programs={p: {"K1_bytes_per_solve": prg[p]["k1_bound"].l2_bytes,
                      "K2_bytes_per_solve": prg[p]["k2_bound"].l2_bytes}
                  for p in fs.SOLVER_PROGRAMS},
        bitwise_resident_t50=True, l2_bytes_per_s=l2_rate,
        problem_size_sweep=sweep, lanes_per_cta=kplan["lanes"],
        warps_per_cta=kplan["warps"], ring=kplan["ring"],
        ms_per_product=k7_ms, matmul_ms=k7_mm,
        l2_bytes_per_product=k7_l2, plain_ms_per_product=k7_plain,
        product_bound_ms=k6_bound.ms, product_bitwise_k6=k7_same,
        product_lanes=LARGE_BATCH)
    return entries, out["tier_inputs"]


def result_agreement(fs, fleet, a, b):
    """fused_solve.lane_agreement of two SolveResults."""
    def fused(r):
        st = r.stats
        return fs.FusedSolve(r.alpha.movedim(0, -1).movedim(0, 1),
                             st.final_cost[None].float(),
                             st.converged[None].float(),
                             st.outer_iters[None].float(),
                             st.inner_iters[None].float())

    return fs.lane_agreement(fused(a), fused(b))


def tier_phases(mt, bench, fs, roofline, fleet, dev, large):
    """Phase 18, the kernel tiers of K1/K2 (the linearized ladder's ultra
    and bf16 programs; csrc/fused_tiers.cu).  (a) T=50, resident: K1 and K2
    with ``lean=True`` bit for bit K1-BLS and K2-BLS (the lean tier runs
    the linearized program: fused_solve.program); each program's K1 (1x4
    steps) and K2 (one round, a quarter of the lanes fulfilled) against its
    plain version on SHORT_BATCH random scenes under phase 2's rule, the ragged batch at every grid shape bit for bit, and
    the streamed plan bit for bit the resident one.  (b) T=200, streamed:
    each program's K1 on phase 17's LARGE_BATCH random scenes (bench
    schedule), timed, held on the paired gate's LARGE_CHECK lanes to phantom
    and cost against phase 17's xla engine run and to its plain version's
    converged fraction (bench.py's band), its converged fraction against
    xla printed (ROADMAP queue 3, fact 5); K2 one round on SHORT_BATCH
    scenes against plain.  (c) past the f32 plans' ceiling:
    fleet_solve(backend="fused", bls_bf16_ladder=True) at T=TIER_BIG_T on
    TIER_BIG_BATCH random scenes must take the bf16 streamed plan and
    launch K1, and is timed; K1 agrees with the plain version at 1x4 steps
    (phase 2's rule; the timed run's agreement is printed); without the
    opt-in it warns and runs xla.  Returns K1's and K2's "tiers" entries."""
    phase_clock(18)
    J, O = 3, 11
    k1s, k2s = {}, {}

    # (a) T = 50, the resident body.
    cfg = mt.PlannerConfig(max_outer_iteration=1, max_inner_iteration=4,
                           fixed_iters=True, max_obstacles=O)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0),
                               SHORT_BATCH, device=dev)
    args = fleet.fused_args(cfg, basis, scns)
    rargs = round_args(args, 4, seed=0)
    lean_is_bls = (
        all(torch.equal(x, y) for x, y in zip(
            fs.fused_solve(*args, lean=True), fs.fused_solve(*args)))
        and all(torch.equal(x, y) for x, y in zip(
            fs.fused_round(*rargs, lean=True), fs.fused_round(*rargs))))
    say(f"phase 18 T=50 lean ({SHORT_BATCH} random scenes): K1 and K2 with "
        f"lean=True bitwise K1-BLS and K2-BLS: {lean_is_bls}")
    if not lean_is_bls:
        fail("phase 18: the lean tier is not the linearized program")
    for prog in fs.TIER_PROGRAMS:
        _, _, kw = fs.program_call(prog)
        k = fs.fused_solve(*args, **kw)
        p = fs.fused_solve_reference(*args, **kw)
        agree, rel = fs.lane_agreement(p, k)
        k2 = fs.fused_round(*rargs, **kw)
        agree2, rel2, abs2 = round_agreement(
            fs.fused_round_reference(*rargs, **kw), k2, rargs[7])
        same = ((k.inner_iters == p.inner_iters)
                & (k.outer_iters == p.outer_iters)
                & (k.fulfilled == p.fulfilled))[0]
        max_abs = max(float((k.alpha - p.alpha).abs()[:, :, same].max()),
                      abs2)
        streamed = (all(torch.equal(x, y) for x, y in zip(
                        fs.fused_solve(*args, plan="streamed", **kw), k))
                    and all(torch.equal(x, y) for x, y in zip(
                        fs.fused_round(*rargs, plan="streamed", **kw), k2)))
        cut = [x[..., :RAGGED_BATCH] for x in args[4:]]
        rcut = [x[..., :RAGGED_BATCH] if torch.is_tensor(x) and x.dim() > 1
                and x.shape[-1] == SHORT_BATCH else x for x in rargs]
        ragged = all(
            all(torch.equal(x, y[..., :RAGGED_BATCH]) for x, y in zip(
                fs.fused_solve(cfg.replace(pallas_block_b=w), *args[1:4],
                               *cut, ctas=c, **kw), k))
            and all(torch.equal(x, y[..., :RAGGED_BATCH]) for x, y in zip(
                fs.fused_round(cfg.replace(pallas_block_b=w), *rcut[1:],
                               ctas=c, **kw), k2))
            for w, c in grid_shapes())
        say(f"phase 18 T=50 {prog} ({SHORT_BATCH} random scenes, resident): "
            f"K1 at 1x4 steps lane agreement {agree:.4f}, alpha {rel:.3g} of "
            f"the lane's scale; K2 one round "
            f"({int((rargs[7] > 0.5).sum())} fulfilled) {agree2:.4f}, "
            f"{rel2:.3g} (bounds >= {fs.CARD_SHORT_AGREEMENT_MIN}, <= "
            f"{fs.ALPHA_REL_MAX}); streamed plan bitwise the resident: "
            f"{streamed}; ragged batch at {grid_shapes()} bitwise: {ragged}")
        if (min(agree, agree2) < fs.CARD_SHORT_AGREEMENT_MIN
                or max(rel, rel2) > fs.ALPHA_REL_MAX
                or not (streamed and ragged)):
            fail(f"phase 18: {prog} disagrees with its plain version at T=50")
        k1s[prog] = {"t50": {"lane_agreement": agree, "max_abs_err": max_abs,
                             "streamed_bitwise": streamed}}
        k2s[prog] = {"t50": {"lane_agreement": agree2}}
        del k, p, k2
    del args, rargs, scns

    # (b) T = 200, the streamed body, on phase 17's scenes.
    cfg, basis, scns, args = (large[k] for k in ("cfg", "basis", "scns",
                                                  "args"))
    T = cfg.n_timesteps
    sub = (cfg, *args[1:4], *(x[..., :LARGE_TALLY] for x in args[4:]))
    tsub = (cfg, *args[1:4], *(x[..., :TIER_TALLY] for x in args[4:]))
    scfg = mt.PlannerConfig(n_timesteps=T, max_outer_iteration=2,
                            max_inner_iteration=6, fixed_iters=True,
                            max_obstacles=O)
    sscns = mt.random_scenarios(scfg, torch.Generator().manual_seed(6),
                                SHORT_BATCH, device=dev)
    srargs = round_args(fleet.fused_args(scfg, basis, sscns), 4, seed=0)
    gates_ok = True
    for prog in fs.TIER_PROGRAMS:
        _, _, kw = fs.program_call(prog)
        fs.fused_solve.launches = 0
        k1, ms = timed(lambda: fs.fused_solve(*args, **kw))
        launches = fs.fused_solve.launches
        gate = bench.gate_against(cfg, basis, scns, fleet.kernel_result(k1),
                                  LARGE_CHECK, large["xla_conv"],
                                  large["xla_cost"])
        b = gate["bands"]
        p1, plain_ms = timed(lambda: fs.fused_solve_reference(*sub, **kw))
        k_conv = float((k1.fulfilled[0, :LARGE_TALLY] > 0.5).float().mean())
        p_conv = float((p1.fulfilled[0] > 0.5).float().mean())
        band = max(0.02, min(0.15 * max(k_conv, p_conv), 0.05))
        # The gate's lanes are the plain version's (LARGE_CHECK ==
        # LARGE_TALLY): the kernel's obstacle cost there against the plain
        # version's, within the gate's 1% band, for every tier.
        p_cost = bench.mean_obstacle_cost(
            cfg, basis, mt.Scenario(*(x[:LARGE_TALLY] for x in scns)),
            fleet.kernel_result(p1))
        plain_cost_ok = (abs(b["check_obstacle_cost"] - p_cost)
                         <= 0.01 * abs(p_cost))
        xla_cost_ok = (abs(b["check_obstacle_cost"] - b["xla_obstacle_cost"])
                       <= b["cost"])
        held = (abs(k_conv - p_conv) <= band and plain_cost_ok
                and gate["fields"]["phantom_frac"] <= b["phantom"]
                and xla_cost_ok)
        conv_ok = (abs(b["check_converged_frac"] - b["xla_converged_frac"])
                   <= b["converged"])
        gates_ok = gates_ok and held
        del p1
        scale = LARGE_BATCH / TIER_TALLY
        tally = roofline.kernel_counts(
            {key: v * scale for key, v in roofline.plain_tally(
                fs.fused_solve_reference, *tsub, **kw).items()},
            float((k1.outer_iters + k1.fulfilled).sum()),
            float(k1.inner_iters.sum()))
        plan = fs.launch_plan(cfg, O, prog=prog)
        bound = roofline.fused_rounds(LARGE_BATCH, T, J, O, tally, True,
                                      streamed=True, prog=prog,
                                      lanes_per_cta=plan["lanes"])
        say(f"phase 18 T={T} {prog} K1 ({LARGE_BATCH} random scenes of phase "
            f"17, bench schedule, {plan['lanes']} lanes per CTA, "
            f"{plan['total']} B per CTA): {ms:.1f} ms "
            f"({1e3 * ms / LARGE_BATCH:.3f} us per lane; K1-BLS "
            f"{large['k1_ms']:.1f} ms), {launches} launch; plain version "
            f"{plain_ms:.1f} ms on {LARGE_TALLY} lanes; bound {bound.ms:.1f} "
            f"ms by {bound.by} (the design's L2 reads {bound.design_l2_ms:.1f}"
            f" ms); converged on the gate's {LARGE_CHECK} lanes "
            f"{b['check_converged_frac']:.4f} against the xla engine's "
            f"{b['xla_converged_frac']:.4f} (band {b['converged']:.4f}: "
            f"{'PASS' if conv_ok else 'FAIL'}, printed; K1-BLS "
            f"{large['k1_conv']:.4f}); against its plain version on the "
            f"first {LARGE_TALLY}: {k_conv:.4f} vs {p_conv:.4f} (band "
            f"{band:.4f}); phantom {gate['fields']['phantom_frac']}; obstacle "
            f"cost {b['check_obstacle_cost']:.5f} vs the plain version's "
            f"{p_cost:.5f} and the xla engine's {b['xla_obstacle_cost']:.5f} "
            f"(band {b['cost']:.5f}: {'PASS' if xla_cost_ok else 'FAIL'}): "
            f"{'PASS' if held else 'FAIL'}")
        if not (torch.isfinite(k1.alpha).all()
                and torch.isfinite(k1.final_loss).all()) or launches != 1:
            fail(f"phase 18: {prog} at T={T}: non-finite output or "
                 f"{launches} K1 launches")
        del k1
        # K2: one round at T = 200 on SHORT_BATCH scenes against plain.
        fs.fused_round.launches = 0
        k2, k2_ms = timed(lambda: fs.fused_round(*srargs, **kw))
        k2_launches = fs.fused_round.launches
        p2, k2_plain_ms = timed(lambda: fs.fused_round_reference(
            *srargs, **kw))
        plain_tally_k2 = roofline.plain_tally(fs.fused_round_reference,
                                              *srargs, **kw)
        agree2, rel2, abs2 = round_agreement(p2, k2, srargs[7])
        k2_bound = roofline.fused_rounds(
            SHORT_BATCH, T, J, O, roofline.kernel_counts(
                plain_tally_k2, float((srargs[7] < 0.5).sum()),
                float(k2.inner.sum())), False, streamed=True, prog=prog,
            lanes_per_cta=plan["lanes"])
        say(f"phase 18 T={T} {prog} K2 one round ({SHORT_BATCH} random "
            f"scenes, {int((srargs[7] > 0.5).sum())} fulfilled): lane "
            f"agreement {agree2:.4f}, alpha {rel2:.3g} of the lane's scale; "
            f"{k2_ms:.2f} ms, plain {k2_plain_ms:.1f} ms, bound "
            f"{k2_bound.ms:.3f} ms by {k2_bound.by}")
        if agree2 < fs.CARD_SHORT_AGREEMENT_MIN or rel2 > fs.ALPHA_REL_MAX:
            fail(f"phase 18: {prog} K2 disagrees with its plain version at "
                 f"T={T}")
        del k2, p2
        k1s[prog].update(
            name=f"fused_solve<{prog}>", launches=launches, ms=ms,
            plain_ms=plain_ms, bound_ms=bound.ms, bound_by=bound.by,
            library_ms=None, max_abs_err=k1s[prog]["t50"]["max_abs_err"],
            T=T, lanes=LARGE_BATCH, plain_lanes=LARGE_TALLY,
            design_l2_ms=bound.design_l2_ms, plan_bytes=plan["bytes"],
            warps_per_cta=plan["warps"],
            converged={"k1": b["check_converged_frac"],
                       "xla": b["xla_converged_frac"],
                       "band": b["converged"], "within_band": conv_ok,
                       "k1_bls": large["k1_conv"],
                       "plain": [k_conv, p_conv, band]},
            gate_held=held, phantom=gate["fields"]["phantom_frac"],
            obstacle_cost={"k1": b["check_obstacle_cost"], "plain": p_cost,
                           "xla": b["xla_obstacle_cost"], "band": b["cost"],
                           "xla_within_band": xla_cost_ok})
        k2s[prog].update(
            name=f"fused_round<{prog}>", launches=k2_launches, ms=k2_ms,
            plain_ms=k2_plain_ms, bound_ms=k2_bound.ms, bound_by=k2_bound.by,
            library_ms=None, max_abs_err=abs2, T=T, lanes=SHORT_BATCH,
            lane_agreement=agree2)
        torch.cuda.empty_cache()
    if not gates_ok:
        fail(f"phase 18: a kernel tier failed its gate at T={T}")
    del sscns, srargs

    # (c) Past the f32 plans' ceiling: the planner's bf16 plan through
    # fleet_solve, on the basis the port builds (make_basis: no export at
    # this T, so build_basis; its CPU seconds printed).
    big = mt.PlannerConfig(n_timesteps=TIER_BIG_T, max_outer_iteration=2,
                           max_inner_iteration=6, fixed_iters=True,
                           max_obstacles=O, bls_bf16_ladder=True)
    plan = fs.kernel_plan(big, O)
    if plan is None or not plan["bf16"] or plan["plan"] != "streamed":
        fail(f"phase 18: the planner did not choose the bf16 streamed plan at "
             f"T={TIER_BIG_T}: {plan}")
    t_basis = time.perf_counter()
    basis = mt.make_basis(big, device=dev)
    basis_s = time.perf_counter() - t_basis
    scns = mt.random_scenarios(big, torch.Generator().manual_seed(8),
                               TIER_BIG_BATCH, device=dev)
    fleet.fleet_solve(big, basis, mt.Scenario(*(x[:4] for x in scns)),
                      backend="fused")
    fs.fused_solve.launches = 0
    res, ms = timed(lambda: fleet.fleet_solve(big, basis, scns,
                                              backend="fused"))
    launches = fs.fused_solve.launches
    bargs = fleet.fused_args(big, basis, scns)
    p, plain_ms = timed(lambda: fs.fused_solve_reference(*bargs, bf16=True))
    agree_long, rel_long = result_agreement(fs, fleet, fleet.kernel_result(p),
                                            res)
    # Held under phase 2's rule (1 round x 4 steps): over 2 x 6 steps a
    # lane's fp-path chaos at this T parts a few lanes (printed).
    short = (big.replace(max_outer_iteration=1, max_inner_iteration=4),
             *bargs[1:])
    agree, rel = fs.lane_agreement(fs.fused_solve_reference(*short, bf16=True),
                                   fs.fused_solve(*short, bf16=True))
    tally = roofline.kernel_counts(
        roofline.plain_tally(fs.fused_solve_reference, *bargs, bf16=True),
        float((res.stats.outer_iters + res.stats.converged.int()).sum()),
        float(res.stats.inner_iters.sum()))
    bound = roofline.fused_rounds(TIER_BIG_BATCH, TIER_BIG_T, J, O, tally,
                                  True, streamed=True, prog="bls_bf16")
    import warnings

    before = fs.fused_solve.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xla, xla_ms = timed(lambda: fleet.fleet_solve(
            big.replace(bls_bf16_ladder=False), basis, scns,
            backend="fused"))
    warned = any("falling back to backend='xla'" in str(w.message)
                 for w in caught)
    finite = bool(torch.isfinite(res.alpha).all()
                  and torch.isfinite(res.stats.final_cost).all())
    say(f"phase 18 T={TIER_BIG_T} fleet_solve(backend='fused', "
        f"bls_bf16_ladder=True) on {TIER_BIG_BATCH} random scenes (2x6 "
        f"steps; make_basis built the basis in {basis_s:.2f} s): plan "
        f"{plan['plan']} "
        f"bf16 {plan['bf16']}, {plan['lanes']} lane per CTA (its "
        f"{plan['warps'] - 1} warps compute its products), "
        f"{plan['total']} B per CTA {plan['bytes']}; {launches} K1 launch, "
        f"{ms:.1f} ms; plain version {plain_ms:.1f} ms; lane agreement "
        f"{agree_long:.4f} (alpha {rel_long:.3g} of the lane's scale), at "
        f"1x4 steps {agree:.4f}, {rel:.3g} (bounds >= "
        f"{fs.CARD_SHORT_AGREEMENT_MIN}, <= {fs.ALPHA_REL_MAX}); bound "
        f"{bound.ms:.2f} ms by {bound.by} (the design's L2 reads "
        f"{bound.design_l2_ms:.1f} ms); converged "
        f"{float(res.stats.converged.float().mean()):.4f} vs the xla "
        f"engine's {float(xla.stats.converged.float().mean()):.4f}; without "
        f"the opt-in: warned {warned}, K1 launches "
        f"{fs.fused_solve.launches - before}, xla {xla_ms:.1f} ms")
    if (launches != 1 or not finite or agree < fs.CARD_SHORT_AGREEMENT_MIN
            or rel > fs.ALPHA_REL_MAX or not warned
            or fs.fused_solve.launches != before):
        fail(f"phase 18: the bf16 plan at T={TIER_BIG_T} failed")
    k1s["bls_bf16"]["past_f32_ceiling"] = {
        "T": TIER_BIG_T, "lanes": TIER_BIG_BATCH, "schedule": "2x6",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.ms,
        "bound_by": bound.by, "design_l2_ms": bound.design_l2_ms,
        "launches": launches, "lane_agreement": agree_long,
        "lane_agreement_1x4": agree, "alpha_rel": rel,
        "plan_bytes": plan["bytes"], "xla_ms": xla_ms,
        "converged": float(res.stats.converged.float().mean()),
        "xla_converged": float(xla.stats.converged.float().mean())}
    del basis, scns, res, p, xla, bargs
    torch.cuda.empty_cache()
    return {"fused_solve": k1s, "fused_round": k2s}


# K3-K6 at T = 200 on LARGE_BATCH random scenes, lane by lane against the
# plain version.  Two roundings let a lane part from it, and each parted
# lane must show which:
# - a tie of the blend's first argmax over T: two timesteps' obstacle
#   costs equal to rounding, so the kernel's trajectory and the plain
#   version's (which differ by ~1e-7) put lam_max = 0.8 of the blend's
#   weight on different timesteps and the gradient moves by O(1) of its
#   scale.  Shown by the first argmax at the kernel's trajectory differing
#   from the one at the plain version's, or by the plain version's two
#   largest costs lying within TIE_GAP_MAX (relative) of each other;
# - in the tiers that evaluate the new iterate exactly (the exact ladder,
#   GD), the new alpha's rounding (within ALPHA_REL_MAX of the plain
#   version's) carried through the basis: the warm start's O(1e4)
#   coefficients cancel to O(1), so a 1e-8 relative change of alpha moves
#   traj/vel by up to ~1e-3.  Shown by the plain evaluation of the kernel's
#   own new alpha (cost_grad_eval_reference) agreeing with the kernel's
#   loss, grad, traj and vel within EVAL_BOUNDS.
# Measured on an H100 at 65,536 random scenes (seed 0): K3 linearized 2
# lanes, both first-argmax flips at top-two gaps of 1.6e-7 and 6.7e-8; K3
# exact 43 lanes (traj/vel up to 4.3e-3 abs), 41 of them shown by the
# kernel's own alpha and 2 by gaps under 1e-5; K4, K5 and K6 none.
# Allowed per kernel: at most TIE_LANES_MAX ties and PARTED_LANES_MAX
# parted lanes in all, each shown (an exact-tier lane by its own alpha
# first).
TIE_LANES_MAX = 8
TIE_GAP_MAX = 1e-5
PARTED_LANES_MAX = LARGE_BATCH // 1000


def lane_misses(k, p):
    """(B,) bool: the lanes where the kernel's (loss, grad, traj, vel) part
    from the plain version's beyond EVAL_BOUNDS (NaN parts)."""
    (kl, kg, kt, kv), (pl, pg, pt, pv) = k, p
    loss = (kl - pl).abs()[0] / pl.abs()[0]
    grad = (kg - pg).abs().amax(dim=(0, 1)) / pg.abs().amax(dim=(0, 1))
    planes = torch.maximum((kt - pt).abs().amax(dim=(0, 1)),
                           (kv - pv).abs().amax(dim=(0, 1)))
    return ~((loss <= EVAL_BOUNDS["loss"]) & (grad <= EVAL_BOUNDS["grad"])
             & (planes <= EVAL_BOUNDS["planes"]))


def random_step_kernels(mt, fs, sk, fleet, cfg, basis, dev):
    """K5, K6, K3 (both tiers) and K4 at T = cfg.n_timesteps on LARGE_BATCH
    random scenes (seed 0, at the warm start, round 0, step 0), each held to
    its plain version on the card lane by lane: the steps' stop flags and lr
    on >= CARD_SHORT_AGREEMENT_MIN of the lanes and alpha within
    ALPHA_REL_MAX on those; every other field within EVAL_BOUNDS on every
    lane but the parted ones, each shown to be one of the two roundings
    above.  For each parted lane it prints the two argmax timesteps, their
    gap, whether the plain evaluation of the kernel's own alpha sides with
    the kernel, and whether the plain version on the CPU (another summation
    order) sides with the kernel or with the card's plain version.
    Returns, per kernel, the readings."""
    T = cfg.n_timesteps
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0),
                               LARGE_BATCH, device=dev)
    _, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = fleet.fused_args(
        cfg, basis, scns)
    del scns
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    ek = sk.cost_grad_eval(cfg, *eargs)
    out = {}

    def lanes_of(x, idx):
        return (x[..., idx] if torch.is_tensor(x)
                and x.shape[-1] == LARGE_BATCH else x)

    def hold(name, c, k, p, ref, args, fields, agree=None, alpha_rel=0.0,
             exact_eval=False):
        """Hold kernel result k to the card's plain p on ``fields`` (the
        (loss, grad, traj, vel) of each), lane by lane; a step (``agree``,
        its stop flag and lr agreement) on the lanes whose flag and lr
        agree; ``exact_eval``: the step evaluates its new alpha exactly."""
        kf, pf = fields(k), fields(p)
        miss = lane_misses(kf, pf)
        if agree is not None:
            miss &= ((k.minimized == p.minimized) & (k.new_lr == p.new_lr))[0]
        idx = miss.nonzero()[:, 0]
        lanes = []
        if len(idx):
            cf = fields(ref(c, *(lanes_of(x, idx).cpu() for x in args)))
            kc = [x[..., idx] for x in kf]
            pc = [x[..., idx] for x in pf]
            by_k = ~lane_misses([x.cpu() for x in kc], cf)
            by_p = ~lane_misses([x.cpu() for x in pc], cf)
            own = torch.zeros(len(idx), dtype=torch.bool, device=idx.device)
            if exact_eval:
                own = ~lane_misses(kc, sk.cost_grad_eval_reference(
                    c, kv, kvt, mix, k.new_alpha[..., idx],
                    *(lanes_of(x, idx) for x in eargs[4:])))
            obs = [x[:, idx] for x in (ox, oy, ow)]
            ck = fs.blend_costs(cfg, kc[2], *obs)
            cp = fs.blend_costs(cfg, pc[2], *obs)
            fk, fp = fs.first_argmax(ck), fs.first_argmax(cp)
            n = torch.arange(len(idx), device=idx.device)
            rest = cp.clone()
            rest[fp, n] = -math.inf
            gap = (cp[fp, n] - rest.max(dim=0).values) / cp[fp, n].abs()
            gerr = ((kc[1] - pc[1]).abs().amax(dim=(0, 1))
                    / pc[1].abs().amax(dim=(0, 1)))
            perr = torch.maximum((kc[2] - pc[2]).abs().amax(dim=(0, 1)),
                                 (kc[3] - pc[3]).abs().amax(dim=(0, 1)))
            for i in range(len(idx)):
                tie = bool(fk[i] != fp[i]) or float(gap[i]) <= TIE_GAP_MAX
                lanes.append({
                    "lane": int(idx[i]), "grad_err": float(gerr[i]),
                    "planes_abs": float(perr[i]),
                    "argmax_kernel_traj": int(fk[i]),
                    "argmax_plain_traj": int(fp[i]), "gap": float(gap[i]),
                    "own_alpha_sides_with_kernel": bool(own[i]),
                    "cpu_plain_sides_with": ("kernel" if by_k[i] else
                                             "card plain" if by_p[i]
                                             else "neither"),
                    "shown": ("own alpha" if own[i] else
                              "tie" if tie else None)})
        ties = sum(x["shown"] == "tie" for x in lanes)
        ok = (len(lanes) <= PARTED_LANES_MAX and ties <= TIE_LANES_MAX
              and all(x["shown"] for x in lanes)
              and (agree is None or agree >= fs.CARD_SHORT_AGREEMENT_MIN)
              and alpha_rel <= fs.ALPHA_REL_MAX)
        planes = max((x["planes_abs"] for x in lanes), default=0.0)
        say(f"phase 17 T={T} {name} on {LARGE_BATCH} random scenes against "
            f"plain: {len(lanes)} lanes out of {EVAL_BOUNDS} (at most "
            f"{PARTED_LANES_MAX}): {ties} first-argmax ties (at most "
            f"{TIE_LANES_MAX}), "
            f"{sum(x['shown'] == 'own alpha' for x in lanes)} shown by the "
            f"plain evaluation of the kernel's own alpha, "
            f"{sum(not x['shown'] for x in lanes)} not shown; on those lanes "
            f"traj/vel up to {planes:.3g} abs; the CPU's plain version sides "
            f"with the kernel on "
            f"{sum(x['cpu_plain_sides_with'] == 'kernel' for x in lanes)}, "
            f"the card plain on "
            f"{sum(x['cpu_plain_sides_with'] == 'card plain' for x in lanes)}"
            + ("" if agree is None else
               f"; stop flag and lr agree on {agree:.5f}, alpha "
               f"{alpha_rel:.3g} of the lane's scale")
            + "".join(f"; tie at lane {x['lane']}: grad {x['grad_err']:.3g} "
                      f"of its scale, first argmax {x['argmax_kernel_traj']} "
                      f"at the kernel's traj, {x['argmax_plain_traj']} at the "
                      f"plain version's, top-two gap {x['gap']:.3g}"
                      for x in lanes if x["shown"] == "tie")
            + "".join(f"; not shown at lane {x['lane']}: {x}"
                      for x in lanes if not x["shown"])
            + f": {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"phase 17: {name} parts from its plain version at T={T} on "
                 f"random scenes beyond the roundings shown")
        out[name] = {"lanes": LARGE_BATCH, "parted": lanes,
                     "stop_lr_agreement": agree, "alpha_rel": alpha_rel}

    hold("cost_grad_eval", cfg, ek, sk.cost_grad_eval_reference(cfg, *eargs),
         sk.cost_grad_eval_reference, eargs, tuple)
    fk6 = sk.forward_eval(cfg, kv, mix, a0)
    k6_vs_k5(fk6, ek, 17, LARGE_BATCH)
    k6_err = planes_error(fk6, sk.forward_eval_reference(cfg, kv, mix, a0))
    say(f"phase 17 T={T} forward_eval on {LARGE_BATCH} random scenes against "
        f"plain: traj/vel {k6_err:.3g} abs (bound {EVAL_BOUNDS['planes']})")
    if not k6_err <= EVAL_BOUNDS["planes"]:
        fail(f"phase 17: forward_eval disagrees with its plain version at "
             f"T={T} on random scenes")
    out["forward_eval"] = {"lanes": LARGE_BATCH, "planes_abs": k6_err}
    del fk6

    def step_fields(r):
        return (r.new_loss, r.new_grad, r.new_traj, r.new_vel)

    zero = torch.zeros_like(lsg)
    for name, solver, c, lr in (
            ("bls", "bls", cfg, torch.full_like(lsg, cfg.bls_lr_start)),
            ("bls_exact", "bls", cfg.replace(ladder_eval="exact"),
             torch.full_like(lsg, cfg.bls_lr_start)),
            ("gd", "gd", cfg, torch.full_like(lsg, cfg.gd_lr[0]))):
        fn, ref = step_fns(sk, solver)
        sargs = (kv, kvt, mix, a0, ek.grad, ek.traj, ek.vel, ek.loss, lr,
                 zero, lsg, ljl, start, goal, ox, oy, ow)
        k, p = fn(c, *sargs), ref(c, *sargs)
        agree, err = step_errors(p, k)
        hold(name, c, k, p, ref, sargs, step_fields, agree,
             float("inf") if err is None else err["alpha"],
             exact_eval=name != "bls")
        del k, p
    del ek, eargs
    torch.cuda.empty_cache()
    return out


class plain_rounds:
    """Within the block, the rounds driver's K2 calls run K2's plain
    version (fused_round_reference) on the same inputs: its time per solve
    beside the kernel's."""

    def __init__(self, fs):
        self.fs = fs

    def __enter__(self):
        self.orig = self.fs.fused_round
        ref = self.fs.fused_round_reference

        def plain(*a, plan="", **kw):
            return ref(*a, **kw)

        plain.launches = self.orig.launches
        self.fs.fused_round = plain
        return self

    def __exit__(self, *exc):
        self.fs.fused_round = self.orig
        return False


def replicated_k1(mt, fs, fleet, roofline, cfg, solver, alpha0, dev, phase,
                  label):
    """K1 of ``solver`` under ``cfg`` alone on the replicated main path's
    inputs at MAIN_BATCH lanes: every lane must equal the path's lane 0
    ``alpha0``; its plain version on the same inputs, whose lane 0 costs
    must lie within 1% of the kernel's; its bound from K1's own counts and
    the plain tally of the first TALLY_LANES lanes, scaled (every lane holds
    the same scene).  Returns (ms, plain_ms, bound)."""
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles
    basis = mt.make_basis(cfg, device=dev)
    scn0 = mt.reference_scenario(cfg, device=dev)
    args = fleet.fused_args(cfg, basis, mt.replicate_scenario(scn0, MAIN_BATCH))
    k, ms = timed(lambda: fs.fused_solve(*args, solver=solver))
    if not (lanes_match_lane0(k, -1)
            and torch.equal(k.alpha[:, :, 0].T, alpha0)):
        fail(f"phase {phase}: {label}'s lanes differ from the path's lane 0")
    kq = mt.solution_quality(cfg, basis, scn0, alpha0)
    rounds = float((k.outer_iters + k.fulfilled).sum())
    accepted = float(k.inner_iters.sum())
    del k
    p, plain_ms = timed(lambda: fs.fused_solve_reference(*args,
                                                         solver=solver))
    pq = mt.solution_quality(cfg, basis, scn0, p.alpha[:, :, 0].T)
    gaps = [abs(float(pq[key]) - float(kq[key])) / float(kq[key])
            for key in ("avg_cost", "max_cost")]
    del p
    sub = roofline.plain_tally(fs.fused_solve_reference, cfg, *args[1:4],
                      *(x[..., :TALLY_LANES] for x in args[4:]), solver=solver)
    scale = MAIN_BATCH / TALLY_LANES
    bound = roofline.fused_rounds(
        MAIN_BATCH, T, J, O,
        roofline.kernel_counts({key: v * scale for key, v in sub.items()},
                               rounds, accepted, solver),
        True, solver, cfg.ladder_eval)
    say(f"phase {phase} {label} alone {ms:.1f} ms, plain version "
        f"{plain_ms:.1f} ms at batch {MAIN_BATCH}; every lane equals lane 0; "
        f"plain lane 0 avg/max {float(pq['avg_cost']):.5f}/"
        f"{float(pq['max_cost']):.5f} vs kernel {float(kq['avg_cost']):.5f}/"
        f"{float(kq['max_cost']):.5f} (gaps {gaps[0]:.2e}/{gaps[1]:.2e}, "
        f"bound 1e-2), plain endpoint_err {float(pq['endpoint_err']):.4f}; "
        f"bound {bound.ms:.1f} ms by {bound.by} (rounds {rounds:.0f}, "
        f"accepted steps {accepted:.0f})")
    if max(gaps) > 0.01:
        fail(f"phase {phase}: the plain version's costs differ from "
             f"{label}'s")
    del args
    torch.cuda.empty_cache()
    return ms, plain_ms, bound


def rounds_driver_check(fs, fleet, roofline, cfg, args, want, solver, phase,
                        label, k2):
    """The rounds driver over K2 against K1's result ``want`` on the
    FULL_BATCH lanes of ``args`` (fused_solve's): a warm-up run, then
    compaction off, on and off again; every output field bit for bit, one
    K2 launch per round.  K2's time over the rounds (compaction off, CUDA
    events: the first reading and the second, taken after the compacted
    run; each run also prints its slowest launch and the host's
    milliseconds inside that call, which tell a host stall from a slow
    kernel), its plain version's on the first reading's inputs, their bound
    and the per-round lane agreement.  Returns (k2_ms: the second reading,
    k2_ms_first, k2_plain_ms, k2_bound, warm-up reading)."""
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles
    rounds = len(fs.inner_schedule(cfg))
    readings = []
    for i, compact in enumerate((False, False, True, False)):
        before = fs.fused_round.launches
        with KernelTimer(fs, "fused_round", capture=i == 1) as timer:
            got = fleet._fused_rounds_solve(
                cfg.replace(lane_compaction=compact), args[1:], solver)
            torch.cuda.synchronize()
        launched = fs.fused_round.launches - before
        same = same_result(got, want)
        slow_ms, slow_host = timer.slowest()
        say(f"phase {phase} {label}, {'warm-up, ' if i == 0 else ''}"
            f"compaction {'on' if compact else 'off'} ({FULL_BATCH} random "
            f"scenes): {launched} {k2} launches, {timer.total_ms():.1f} ms in "
            f"{k2} (slowest launch {slow_ms:.2f} ms, the host {slow_host:.2f} "
            f"ms inside that call; host {sum(timer.host['fused_round']):.2f} "
            f"ms inside all), bitwise equal to K1: {same}")
        if not same:
            fail(f"phase {phase}: the {label} differs from K1")
        if launched != rounds:
            fail(f"phase {phase}: {launched} {k2} launches, not {rounds}")
        if not compact:
            readings.append(timer.total_ms())
        if i == 1:
            k2_plain_ms, agreements = 0.0, []
            k2_bound = roofline.Bound(0.0, 0.0)
            for rin, rout in zip(timer.inputs, timer.outputs):
                rp, ms = timed(lambda: fs.fused_round_reference(
                    *rin, solver=solver))
                k2_plain_ms += ms
                k2_bound = k2_bound + roofline.fused_rounds(
                    FULL_BATCH, T, J, O,
                    roofline.kernel_counts(
                        roofline.plain_tally(fs.fused_round_reference, *rin,
                                             solver=solver),
                        float((rin[7] < 0.5).sum()),
                        float(rout.inner.sum()), solver), False,
                    solver, cfg.ladder_eval)
                agreements.append(round_agreement(rp, rout, rin[7])[0])
            say(f"phase {phase} {k2} {readings[1]:.1f} ms over {rounds} "
                f"launches, plain version {k2_plain_ms:.1f} ms on the same "
                f"inputs, bound {k2_bound.ms:.2f} ms by {k2_bound.by}; "
                f"per-round lane agreement "
                f"{[round(a, 4) for a in agreements]}")
            del timer.inputs[:], timer.outputs[:]
    say(f"phase {phase} {k2} over {rounds} launches, compaction off: warm-up "
        f"{readings[0]:.1f} ms, first reading {readings[1]:.1f} ms, second "
        f"{readings[2]:.1f} ms (reported)")
    return readings[2], readings[1], k2_plain_ms, k2_bound, readings[0]


def random_k1(mt, fs, fleet, roofline, cfg, solver, res_on, dev, phase,
              label):
    """K1 of ``solver`` under ``cfg`` on the MAIN_BATCH random scenes (seed
    0) of the bench's random mode, timed, and whether it equals the rounds
    driver's result ``res_on`` there bit for bit; the bounds of K1 and of
    K2 per solve on these scenes, from K1's own counts and the plain tally
    of the first TALLY_LANES scenes, scaled.  Returns (ms, equal, K1's
    bound, K2's bound)."""
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles
    rounds = len(fs.inner_schedule(cfg))
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0),
                               MAIN_BATCH, device=dev)
    args = fleet.fused_args(cfg, basis, scns)
    k1, ms = timed(lambda: fs.fused_solve(*args, solver=solver))
    same = same_result(res_on, fleet.kernel_result(k1))
    sub = roofline.plain_tally(fs.fused_solve_reference, cfg, *args[1:4],
                      *(x[..., :TALLY_LANES] for x in args[4:]), solver=solver)
    scale = MAIN_BATCH / TALLY_LANES
    tally = roofline.kernel_counts({key: v * scale for key, v in sub.items()},
                          float((k1.outer_iters + k1.fulfilled).sum()),
                          float(k1.inner_iters.sum()), solver)
    k1_bound = roofline.fused_rounds(MAIN_BATCH, T, J, O, tally, True, solver,
                                     cfg.ladder_eval)
    rounds_run = (k1.outer_iters + k1.fulfilled)[0]
    live = [float((rounds_run > r).sum()) for r in range(rounds)]
    k2_bound = roofline.fused_round_launches(MAIN_BATCH, T, J, O, tally, live,
                                             solver, cfg.ladder_eval)
    say(f"phase {phase} {label} on the same scenes {ms:.1f} ms, equal to the "
        f"rounds driver's result bit for bit: {same}; bounds at {MAIN_BATCH} "
        f"random scenes (plain tally on {TALLY_LANES} lanes x {scale:g}): K1 "
        f"{k1_bound.ms:.1f} ms by {k1_bound.by}; K2 per solve ({rounds} "
        f"launches, live lanes {[int(x) for x in live]}) {k2_bound.ms:.1f} ms "
        f"by {k2_bound.by}; work "
        f"{({key: round(v) for key, v in tally.items()})}")
    del k1, args, scns
    torch.cuda.empty_cache()
    return ms, same, k1_bound, k2_bound


def grid_shapes():
    """(lanes per CTA, CTAs) of the ragged checks: each of WARP_SHAPES on
    the full persistent grid, then the default on one CTA."""
    return [(w, 0) for w in WARP_SHAPES] + [(0, 1)]


def ptxas_report(log):
    """{kernel: {registers, spill_stores, spill_loads, stack}} from nvcc's
    ptxas report; K1/K2 as fused_solve<program,T,O> /
    fused_round<program,T,O> and K3 as bls_step<program,T,O> (program bls,
    gd or bls_exact; <program,0,0>: the generic instantiation;
    <program,0,0,streamed>: the streamed body); K4 as gd_step<T,O,body> and
    K5 as cost_grad_eval<T,O,body> (body 0 resident, 1 streamed; <0,0,...>
    the generic one), K6 as forward_eval<vec> (1: 16-byte copies)."""
    from irm_motion_planning_tpu_torch.ops import fused_solve as fs

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)_kernel"
                      r"(?:I((?:L[ib]\d+E)+)E)?", line)
        if m:
            name = m.group(1)
            if m.group(2) is not None:
                targs = re.findall(r"L[ib](\d+)E", m.group(2))
                if (name.startswith("fused_") or name == "bls_step") and len(
                        targs) == 4:
                    targs[0] = fs.PROGRAMS[int(targs[0])]
                    targs = targs[:3] + (["streamed"] if targs[3] == "1"
                                         else [])
                name += f"<{','.join(targs)}>"
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def same_result(a, b):
    """Whether two SolveResults are equal bit for bit in every field."""
    return torch.equal(a.alpha, b.alpha) and all(
        torch.equal(x, y) for x, y in zip(a.stats, b.stats))


def round_args(args, n_r, seed, solver="bls"):
    """fused_round's arguments from fused_solve's: a quarter of the lanes
    fulfilled, penalties escalated x1/x10/x100, four learning rates (BLS's,
    or the GD schedule's first four)."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    g = torch.Generator().manual_seed(seed)
    B = a0.shape[-1]
    dev = a0.device
    ful = (torch.rand((1, B), generator=g) < 0.25).float().to(dev)
    esc = torch.tensor([1.0, 10.0, 100.0])[
        torch.randint(0, 3, (1, B), generator=g)].to(dev)
    lrs = [0.2, 0.1, 0.05, 0.3] if solver == "bls" else list(cfg.gd_lr[:4])
    lr0 = torch.tensor(lrs)[torch.randint(0, 4, (1, B), generator=g)].to(dev)
    return (cfg, kv, kvt, mix, a0, lsg * esc, ljl * esc, ful, lr0, n_r, start,
            goal, ox, oy, ow)


def round_agreement(ref, got, ful):
    """(lane agreement, largest alpha error relative to the lane's scale,
    largest absolute alpha error) of two fused_round results on what the
    caller reads: step counts and flags of the lanes that came in live
    (fulfilled lanes' loss and ok are masked by the caller), alpha on the
    agreeing lanes."""
    live = ful[0] < 0.5
    same = ((ref.inner == got.inner) & (ref.ok == got.ok))[0] | ~live
    diff = (ref.alpha - got.alpha).abs().amax(dim=(0, 1))
    scale = ref.alpha.abs().amax(dim=(0, 1))
    return (float(same.float().mean()), float((diff / scale)[same].max()),
            float(diff[same].max()))


class KernelTimer:
    """Within the block, times every launch of the named wrappers of
    ``module`` with CUDA events, and the host's seconds inside each call
    (and, with ``capture``, keeps their inputs and outputs) by wrapping the
    module functions that the drivers look up at each call.  A wrapped
    function counts its launches on the module attribute, so the wrapper
    carries each count in and hands it back on exit."""

    def __init__(self, module, *names, capture: bool = False):
        self.module, self.names, self.capture = module, names, capture
        self.events = {n: [] for n in names}
        self.host = {n: [] for n in names}
        self.inputs, self.outputs = [], []

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n, orig in self.orig.items():
            setattr(self.module, n, self._wrap(n, orig))
        return self

    def _wrap(self, name, orig):
        def wrapped(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = orig(*a, **kw)
            end.record()
            self.host[name].append(1e3 * (time.perf_counter() - t0))
            self.events[name].append((start, end))
            if self.capture:
                self.inputs.append(a)
                self.outputs.append(out)
            return out

        wrapped.launches = orig.launches
        return wrapped

    def __exit__(self, *exc):
        for n, orig in self.orig.items():
            orig.launches = getattr(self.module, n).launches
            setattr(self.module, n, orig)
        return False

    def total_ms(self, name=None):
        return sum(self.launch_ms(name))

    def launch_ms(self, name=None):
        """Each launch's CUDA-event milliseconds."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[name or self.names[0]]]

    def slowest(self, name=None):
        """(event ms, host ms inside the call) of the slowest launch."""
        ms = self.launch_ms(name)
        i = max(range(len(ms)), key=ms.__getitem__)
        return ms[i], self.host[name or self.names[0]][i]


# Kernel against plain on the card for the evaluations: both run the same
# arithmetic (the plain basis products through cuBLAS in another summation
# order), so the warm start's O(1e4) coefficients cancelling to O(1) bound
# the planes' error; loss and gradient follow.  Measured at 1,000 random
# lanes on an H100: loss 9.5e-7 absolute, grad/traj/vel bitwise equal.
EVAL_BOUNDS = {"loss": 1e-5, "grad": 1e-4, "planes": 1e-3}


def eval_errors(k, p):
    """Errors of (loss, grad, traj, vel), a PallasEval's fields, against
    the plain version's: the loss relative, the gradient relative to the
    lane's scale, traj/vel absolute, and the largest absolute error of any
    field."""
    (kl, kg, kt, kv), (pl, pg, pt, pv) = k, p
    scale = pg.abs().amax(dim=(0, 1))
    return {
        "loss": float(((kl - pl).abs() / pl.abs()).max()),
        "grad": float(((kg - pg).abs().amax(dim=(0, 1)) / scale).max()),
        "planes": planes_error((kt, kv), (pt, pv)),
        "abs": max(float((x - y).abs().max()) for x, y in zip(k, p)),
    }


def eval_ok(err):
    return all(err[key] <= bound for key, bound in EVAL_BOUNDS.items())


def planes_error(k, p):
    """The largest absolute error of the planes ``k`` against ``p``."""
    return max(float((x - y).abs().max()) for x, y in zip(k, p))


def step_fns(sk, name):
    """The wrapper and the plain version of the BLS or GD step."""
    if name == "bls":
        return sk.bls_inner_step, sk.bls_inner_step_reference
    return sk.gd_inner_step, sk.gd_inner_step_reference


def step_errors(ref, got):
    """(fraction of lanes with equal stop flags and lr, errors of every
    other field on those lanes) of two PallasStep results: alpha relative to
    the lane's scale, the rest as :func:`eval_errors` has them, "abs" the
    largest absolute error of any field.  The errors are None when no lane
    agrees."""
    same = ((ref.minimized == got.minimized) & (ref.new_lr == got.new_lr))[0]
    if not bool(same.any()):
        return 0.0, None

    def on_same(s):
        return (s.new_loss[:, same],
                *(x[..., same] for x in (s.new_grad, s.new_traj, s.new_vel)))

    err = eval_errors(on_same(got), on_same(ref))
    diff = (ref.new_alpha - got.new_alpha).abs().amax(dim=(0, 1))[same]
    scale = ref.new_alpha.abs().amax(dim=(0, 1))[same]
    err["alpha"] = float((diff / scale).max())
    err["abs"] = max(err["abs"], float(diff.max()))
    return float(same.float().mean()), err


def step_ok(agree, err):
    from irm_motion_planning_tpu_torch.ops import fused_solve as fs

    return (err is not None and agree >= fs.CARD_SHORT_AGREEMENT_MIN
            and err["alpha"] <= fs.ALPHA_REL_MAX and eval_ok(err))


def step_summary(agree, err):
    from irm_motion_planning_tpu_torch.ops import fused_solve as fs

    if err is None:
        return "stop flag and lr agree on no lane"
    return (f"stop flag and lr agree on {agree:.4f} of the lanes (bound >= "
            f"{fs.CARD_SHORT_AGREEMENT_MIN}); on those lanes alpha "
            f"{err['alpha']:.3g} of the lane's scale (bound <= "
            f"{fs.ALPHA_REL_MAX}), loss {err['loss']:.3g} relative, grad "
            f"{err['grad']:.3g} of the lane's scale, traj/vel "
            f"{err['planes']:.3g} abs (bounds {EVAL_BOUNDS}), largest abs "
            f"error {err['abs']:.3g}")


def step_blocks(name):
    """``pallas_block_b`` values of the ragged checks, threads per CTA, one
    warp per lane: K3 at 2, 4 and 8 lanes per CTA, K4 at 1, 2, 5, 10 and
    16 (the streamed plan at T=200 takes at most 8)."""
    return (64, 128, 256) if name == "bls" else (32, 64, 160, 320, 512)


def full_width_step(fn, ref, cfg, head, state0, tail):
    """A step kernel ``fn`` (K3 or K4) at full width from ``state0``: the
    least CUDA-event time of TIMED_LAUNCHES launches, each from a copy of
    state0, in place; then its plain version ``ref`` on the same inputs, a
    first call with the work tally (for the comparison with the last
    launch's state and the bound) and a timed one without it.  Returns (ms,
    plain_ms, tally, lane agreement, errors) (see :func:`step_errors`)."""
    from irm_motion_planning_tpu_torch.ops import step_kernels as sk

    state = sk.PallasStep(*(x.clone() for x in state0))

    def launch():
        for x, y in zip(state, state0):
            x.copy_(y)
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        fn(cfg, *head, *state, *tail, out=state)
        end_ev.record()
        return start_ev, end_ev

    evs = [launch() for _ in range(TIMED_LAUNCHES)]
    torch.cuda.synchronize()
    ms = min(a.elapsed_time(b) for a, b in evs)

    def plain(**kw):
        return ref(cfg, *head, *state0, *tail, **kw)

    tally = {}
    agree, err = step_errors(plain(tally=tally), state)
    _, plain_ms = timed(plain)
    return ms, plain_ms, tally, agree, err


def k6_vs_k5(fk, ek, phase, lanes):
    """K6's (traj, vel) must be K5's on the same alpha bit for bit: both run
    the warp body's chains (K6 as a tiled product)."""
    if not (torch.equal(fk.traj, ek.traj) and torch.equal(fk.vel, ek.vel)):
        fail(f"phase {phase}: K6 differs from K5's traj/vel on the same "
             f"alpha ({lanes} lanes)")
    say(f"phase {phase} K6 bitwise equal to K5's traj/vel on the same alpha "
        f"({lanes} lanes)")


def k6_ragged(sk, cfg, kv, mix, a0, fk, phase):
    """K6 on the first RAGGED_BATCH lanes (16-byte copies) and the first
    ODD_BATCH (4-byte copies, B not a multiple of 4) of ``a0``: bit for bit
    the same lanes of the full batch's ``fk``."""
    for n in (RAGGED_BATCH, ODD_BATCH):
        got = sk.forward_eval(cfg, kv, mix, a0[..., :n].contiguous())
        if not all(torch.equal(x, y[..., :n]) for x, y in zip(got, fk)):
            fail(f"phase {phase}: K6 on {n} lanes differs from the same lanes "
                 f"of the full batch")
    say(f"phase {phase} K6 ragged batch ({RAGGED_BATCH} and {ODD_BATCH} lanes: "
        f"16-byte and 4-byte copies) bitwise equal to the full batch's lanes")


def best_ms(fn, reps=TIMED_LAUNCHES):
    """The least CUDA-event time of ``reps`` calls of fn, after a warm-up
    call."""
    fn()
    return min(timed(fn)[1] for _ in range(reps))


def kernel_entry(name, source, line, launches, max_abs_err, ms, plain_ms,
                 bound, library_ms=None, **extra):
    return {
        "name": name,
        "route": "cuda",
        "source": f"irm_motion_planning_tpu_torch/csrc/{source}",
        "replaces": f"irm_motion_planning_tpu/ops/pallas_step.py:{line}",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound.ms,
        "bound_by": bound.by,
        "library_ms": library_ms,
        **extra,
    }


if __name__ == "__main__":
    if sys.argv[1:2] == ["shard-worker"]:
        sys.exit(shard_worker(sys.argv[2:]))
    sys.exit(main())
