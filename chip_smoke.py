"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from irm_motion_planning_tpu_torch/csrc
(K1, the whole solve, and K2, one penalty round, each for BLS and for GD;
K3/K4, one BLS/GD inner step; K5, the fused cost/gradient evaluation; K6,
the forward evaluation), holds each against its plain PyTorch version, and
drives the port's paths through them: the main path
(irm_motion_planning_tpu_torch.bench's default protocol: the reference
scene replicated over 1,048,576 lanes, one K1 launch), the
heterogeneous-fleet path (the bench's random-scenes mode: 1,048,576 random
scenes, one K2 launch per penalty round with lane compaction, gated against
the plain xla engine), the per-step backend (``--backend pallas``, BLS and
GD, K3-K6) and GD on the fused backend (``--solver gd``, K1 and K2 with the
GD step).  Phases:

1. device: the card's name and power limit, the kernel build; for K1 and
   K2 (one warp per lane, persistent grid), for each solver, the registers
   and spills of each instantiation from the ptxas report
   (``fused_solve<gd,50,11>``: solver, T, O; ``<bls,0,0>`` the generic
   one), and from the launch plan the shared memory per CTA (which must
   equal the C side's) and the CTAs and warps per SM;
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
   schedule, compaction off and on; every output field must equal K1's bit
   for bit and each solve must launch K2 ten times.  K2's time (the sum of
   its ten launches) and the plain version's on the same ten inputs;
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
   x1/x10/x100), then the first 1,000 of them at 64/128/256 lanes per
   block, bit for bit the full batch's lanes; each timed at 1,048,576 lanes
   on the main path's inputs, K6 beside one torch.einsum of the same
   product, and held to the plain version there too;
9. K3 and K4 against their plain versions, one step from K5's state on the
   same 1,024 scenes, a quarter of the lanes frozen (bitwise unchanged),
   four learning rates: agreement of the stop flags and lr, and on the
   agreeing lanes every other field (alpha, loss, grad, traj, vel), the
   ragged block-size check; each timed at 1,048,576 lanes from K5's state
   on the main path's inputs and held to the plain version there too;
10. the BLS per-step path (bench --backend pallas): the replicated scene at
   1,048,576 lanes (solves/s, launch counts, every lane equal to lane 0,
   the phase-4 gate and the strict verdict; K3, K5 and K6 time per solve),
   then 1,048,576 random scenes with the paired xla gate on 32,768 lanes;
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
   K2-GD's time per solve, and the GD bounds there.

The kernels line gives for each kernel its launches on its path (K5, on
both per-step paths: the BLS path's, and ``launches_by_path``), its
largest error against the plain version, its time, the plain version's
(timed without the work tally), its bound (ops/roofline.py, from this
run's inputs and the plain versions' tallies of the data-dependent work,
each from an untimed call) and, for K6, one PyTorch call's time.  K1 and
K2 also carry their time and bound at 1,048,576 random scenes (K2 per
solve), their registers, spills and occupancy, and K1 the main path's
peak device memory; under ``gd`` the same numbers for their GD
instantiations (phases 12-13).

Any failed phase exits non-zero.  It imports nothing of JAX.  The last line
is ``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

MAIN_BATCH = 1048576
SHORT_BATCH = 1024
RAGGED_BATCH = 1000
FULL_BATCH = 16384
CHECK_LANES = 32768
TALLY_LANES = 65536
WARP_SHAPES = (4, 8, 16)
TIMED_LAUNCHES = 3
COMPACTION_PAIRS = 6
T0 = time.perf_counter()


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(f"[{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report((_build.build_info or {}).get("log", ""))
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__} cuda {torch.version.cuda}; kernels built in "
        f"{build_s:.1f}s")
    bcfg = bench.bench_config()
    occupancy = {}
    for solver in fs.SOLVERS:
        for name in ("fused_solve", "fused_round"):
            plan = fs.launch_plan(bcfg, bcfg.max_obstacles)
            shape = fs.launch_shape(bcfg, bcfg.max_obstacles, MAIN_BATCH,
                                    name, solver)
            if shape["smem"] != plan["total"]:
                fail(f"phase 1: {name} launch plan {plan['total']} B of "
                     f"shared memory per CTA, the C side {shape['smem']} B")
            built = {k: v for k, v in ptxas.items()
                     if k.startswith(f"{name}<{solver},")}
            if len(built) != 2:
                fail(f"phase 1: no ptxas report of {name}<{solver},...> "
                     f"(specialised and generic): {sorted(ptxas)}")
            occupancy[name, solver] = {"ptxas": built, **shape,
                                       "warps_per_cta": plan["warps"],
                                       "smem_bytes": plan["bytes"]}
            say(f"phase 1 {name} (K{1 if name == 'fused_solve' else 2}, "
                f"{solver}): {plan['warps']} lanes (warps) per CTA, shared "
                f"memory per CTA {plan['total']} B {plan['bytes']}, "
                f"{shape['ctas_per_sm']} CTAs and {shape['warps_per_sm']} "
                f"warps per SM on {shape['sms']} SMs; ptxas {built}")
    say(f"phase 1 K3-K6 ptxas "
        f"{ {k: v for k, v in ptxas.items() if not k.startswith('fused')} }")

    def random_args(cfg, batch, seed):
        basis = mt.make_basis(cfg, device=dev)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(seed),
                                   batch, device=dev)
        return basis, scns, fleet.fused_args(cfg, basis, scns)

    # -- phase 2: kernel against plain, short horizon ------------------
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
        kernel_counts(plain_tally(fs.fused_solve_reference, *args), k1_rounds,
                      k1_accepted), 4)
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
    cfg = bench.bench_config()
    _, _, args = random_args(cfg, FULL_BATCH, 2)
    k1 = fs.fused_solve(*args)
    want = fleet.kernel_result(k1)
    rounds = len(fs.inner_schedule(cfg))
    k2_ms = k2_plain_ms = None
    for compact in (False, True):
        before = fs.fused_round.launches
        with KernelTimer(fs, "fused_round", capture=not compact) as timer:
            got = fleet._fused_rounds_solve(
                cfg.replace(lane_compaction=compact), args[1:])
            torch.cuda.synchronize()
        launched = fs.fused_round.launches - before
        same = same_result(got, want)
        say(f"phase 6 rounds driver, compaction {'on' if compact else 'off'} "
            f"({FULL_BATCH} random scenes): {launched} K2 launches, "
            f"{timer.total_ms():.1f} ms in K2, bitwise equal to K1: {same}")
        if not same:
            fail("phase 6: the rounds driver differs from K1")
        if launched != rounds:
            fail(f"phase 6: {launched} K2 launches, not {rounds}")
        if not compact:
            k2_ms = timer.total_ms()
            k2_plain_ms, agreements = 0.0, []
            k2_bound = roofline.Bound(0.0, 0.0)
            for rin, rout in zip(timer.inputs, timer.outputs):
                rp, ms = timed(lambda: fs.fused_round_reference(*rin))
                k2_plain_ms += ms
                k2_bound = k2_bound + roofline.fused_rounds(
                    FULL_BATCH, T, J, O,
                    kernel_counts(plain_tally(fs.fused_round_reference, *rin),
                                  float((rin[7] < 0.5).sum()),
                                  float(rout.inner.sum())), 3)
                agreements.append(round_agreement(rp, rout, rin[7])[0])
            say(f"phase 6 K2 {k2_ms:.1f} ms over {rounds} launches, plain "
                f"version {k2_plain_ms:.1f} ms on the same inputs; per-round lane "
                f"agreement {[round(a, 4) for a in agreements]}")
            del timer.inputs[:], timer.outputs[:]
    del k1, want, got, args
    torch.cuda.empty_cache()

    # -- phase 7: the heterogeneous path ------------------------------------
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
    sub = plain_tally(fs.fused_solve_reference, cfg, *args[1:4],
                      *(x[..., :TALLY_LANES] for x in args[4:]))
    scale = MAIN_BATCH / TALLY_LANES
    tally = kernel_counts({k: v * scale for k, v in sub.items()},
                          float((k1.outer_iters + k1.fulfilled).sum()),
                          float(k1.inner_iters.sum()))
    k1_rand_bound = roofline.fused_rounds(MAIN_BATCH, T, J, O, tally, 4)
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
    cut = [x[..., :RAGGED_BATCH] if x.shape[-1] == SHORT_BATCH else x
           for x in eargs]
    for bt in (64, 128, 256):
        cb = cfg.replace(pallas_block_b=bt)
        er = sk.cost_grad_eval(cb, *cut)
        fr = sk.forward_eval(cb, kv, mix, cut[3])
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y[..., :RAGGED_BATCH]) for x, y in zip(er, ek))
                and all(torch.equal(x, y[..., :RAGGED_BATCH])
                        for x, y in zip(fr, fk))):
            fail(f"phase 8: {RAGGED_BATCH} lanes at {bt} lanes per block "
                 f"differ from the same lanes of the {SHORT_BATCH}-lane run")
    say(f"phase 8 ragged batch ({RAGGED_BATCH} lanes at 64/128/256 lanes per "
        f"block): K5 and K6 bitwise equal to the full batch's lanes")

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
    work = sk.workspace(J, T, MAIN_BATCH, dev, gd=True)
    mev = sk.PallasEval(torch.empty_like(mlsg),
                        *(torch.empty_like(ma0) for _ in range(3)))
    k5_ms = best_ms(lambda: sk.cost_grad_eval(mcfg, *meargs, out=mev,
                                              work=work))
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
        f"bound {k6_bound.ms:.3f} ms by {k6_bound.by})")
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
        for bt in (64, 128, 256):
            kr = fn(cfg.replace(pallas_block_b=bt), *cut)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                       for x, y in zip(kr, k)):
                fail(f"phase 9: {name}, {RAGGED_BATCH} lanes at {bt} lanes "
                     f"per block differ from the full batch's")
    say(f"phase 9 ragged batch ({RAGGED_BATCH} lanes at 64/128/256 lanes per "
        f"block): K3 and K4 bitwise equal to the full batch's lanes")
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
        state = sk.PallasStep(*(x.clone() for x in state0))

        def launch():
            for x, y in zip(state, state0):
                x.copy_(y)
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
            fn(mcfg, mkv, mkvt, mmix, *state, *mtail, out=state, work=work)
            end_ev.record()
            return start_ev, end_ev

        evs = [launch() for _ in range(TIMED_LAUNCHES)]
        torch.cuda.synchronize()
        ms = min(a.elapsed_time(b) for a, b in evs)

        # state holds one launch from state0.  The plain version on the
        # same inputs: a first call with the work tally, for the comparison
        # and the bound, then a timed one without it.
        def plain(**kw):
            return ref(mcfg, mkv, mkvt, mmix, *state0, *mtail, **kw)

        tally = {}
        agree, err = step_errors(plain(tally=tally), state)
        _, step_plain_ms = timed(plain)
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
        del state, state0, tally
    del mev, k6_out, work, margs, meargs, mtail, ma0
    torch.cuda.empty_cache()

    # -- phases 10 and 11: the per-step paths --------------------------------
    paths = {}
    for phase, solver in ((10, "bls"), (11, "gd")):
        step = "bls_inner_step" if solver == "bls" else "gd_inner_step"
        names = [step, "cost_grad_eval"] + (["forward_eval"] if solver == "bls"
                                            else [])
        for n in names:
            getattr(sk, n).launches = 0
        with KernelTimer(sk, *names) as timer:
            out = bench.run_bench(batch=MAIN_BATCH, repeats=2, solver=solver,
                                  backend="pallas")
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
            f"{out['endpoint_err']}; {out['device']}, {out['power_limit']}")
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
        torch.cuda.empty_cache()
        paths[solver] = (launches, per_solve)

    gd = gd_phases(mt, bench, fs, sk, roofline, fleet, dev, random_args,
                   occupancy)

    kernels = [
        kernel_entry("fused_solve", "fused_solve.cu", 1606, launches_k1,
                     max_abs_err, main_ms, main_plain_ms, k1_bound,
                     ms_1M_random=k1_ms, bound_ms_1M_random=k1_rand_bound.ms,
                     main_path_peak_gib=main_peak_gib,
                     occupancy=occupancy["fused_solve", "bls"],
                     gd=gd["fused_solve"]),
        kernel_entry("fused_round", "fused_solve.cu", 1674, het_launches,
                     k2_abs_err, k2_ms, k2_plain_ms, k2_bound,
                     ms_per_solve_1M_random=k2_solve_ms,
                     bound_ms_per_solve_1M_random=k2_rand_bound.ms,
                     occupancy=occupancy["fused_round", "bls"],
                     gd=gd["fused_round"]),
        kernel_entry("bls_inner_step", "step_kernels.cu", 1239,
                     paths["bls"][0]["bls_inner_step"], step_abs_err["bls"],
                     *step_time["bls"]),
        kernel_entry("gd_inner_step", "step_kernels.cu", 1083,
                     paths["gd"][0]["gd_inner_step"], step_abs_err["gd"],
                     *step_time["gd"]),
        # K5 runs on both per-step paths: ``launches`` is the BLS path's
        # count, the GD path's stands beside it.
        kernel_entry("cost_grad_eval", "step_kernels.cu", 1821,
                     paths["bls"][0]["cost_grad_eval"], k5_abs_err, k5_ms,
                     k5_plain_ms, k5_bound, launches_by_path={
                         s: paths[s][0]["cost_grad_eval"] for s in paths}),
        kernel_entry("forward_eval", "step_kernels.cu", 1767,
                     paths["bls"][0]["forward_eval"], k6_abs_err, k6_ms,
                     k6_plain_ms, k6_bound, library_ms=k6_lib_ms),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    if not all(math.isfinite(x) for e in kernels
               for d in (e, e.get("gd", e))
               for x in (d["ms"], d["plain_ms"], d["bound_ms"])):
        fail("kernel time not finite")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def gd_phases(mt, bench, fs, sk, roofline, fleet, dev, random_args,
              occupancy):
    """Phases 12 and 13, GD through the fused kernels; returns the "gd"
    entries of K1's and K2's lines in the kernels line."""
    cfg = bench.bench_config(solver="gd")
    T, J, O = cfg.n_timesteps, cfg.n_joints, cfg.max_obstacles

    # -- phase 12: K1-GD and K2-GD against plain, short horizon ---------------
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

    # K1-GD alone and its plain version on the main path's inputs.
    basis = mt.make_basis(cfg, device=dev)
    scn0 = mt.reference_scenario(cfg, device=dev)
    args = fleet.fused_args(cfg, basis, mt.replicate_scenario(scn0, MAIN_BATCH))
    k, main_ms = timed(lambda: fs.fused_solve(*args, solver="gd"))
    if not (lanes_match_lane0(k, -1)
            and torch.equal(k.alpha[:, :, 0].T, alpha0)):
        fail("phase 13: K1-GD's lanes differ from the GD path's lane 0")
    kq = mt.solution_quality(cfg, basis, scn0, alpha0)
    k1_rounds = float((k.outer_iters + k.fulfilled).sum())
    k1_accepted = float(k.inner_iters.sum())
    del k
    p, main_plain_ms = timed(lambda: fs.fused_solve_reference(*args,
                                                              solver="gd"))
    pq = mt.solution_quality(cfg, basis, scn0, p.alpha[:, :, 0].T)
    gaps = [abs(float(pq[key]) - float(kq[key])) / float(kq[key])
            for key in ("avg_cost", "max_cost")]
    del p
    # Every lane holds the same scene: the plain tally of the first
    # TALLY_LANES lanes, scaled, is the whole batch's.
    sub = plain_tally(fs.fused_solve_reference, cfg, *args[1:4],
                      *(x[..., :TALLY_LANES] for x in args[4:]), solver="gd")
    scale = MAIN_BATCH / TALLY_LANES
    k1_bound = roofline.fused_rounds(
        MAIN_BATCH, T, J, O,
        kernel_counts({key: v * scale for key, v in sub.items()}, k1_rounds,
                      k1_accepted, "gd"), 4, "gd")
    say(f"phase 13 K1-GD alone {main_ms:.1f} ms, plain version "
        f"{main_plain_ms:.1f} ms at batch {MAIN_BATCH}; every lane equals "
        f"lane 0; plain lane 0 avg/max {float(pq['avg_cost']):.5f}/"
        f"{float(pq['max_cost']):.5f} vs kernel {float(kq['avg_cost']):.5f}/"
        f"{float(kq['max_cost']):.5f} (gaps {gaps[0]:.2e}/{gaps[1]:.2e}, "
        f"bound 1e-2); bound {k1_bound.ms:.1f} ms by {k1_bound.by} (rounds "
        f"{k1_rounds:.0f}, accepted steps {k1_accepted:.0f})")
    if max(gaps) > 0.01:
        fail("phase 13: the plain GD version's costs differ from K1-GD's")
    del args
    torch.cuda.empty_cache()

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
    rounds = len(fs.inner_schedule(cfg))
    for compact in (False, True):
        before = fs.fused_round.launches
        with KernelTimer(fs, "fused_round", capture=not compact) as timer:
            got = fleet._fused_rounds_solve(
                cfg.replace(lane_compaction=compact), args[1:], "gd")
            torch.cuda.synchronize()
        launched = fs.fused_round.launches - before
        same = same_result(got, want)
        say(f"phase 13 GD rounds driver, compaction "
            f"{'on' if compact else 'off'} ({FULL_BATCH} random scenes): "
            f"{launched} K2-GD launches, {timer.total_ms():.1f} ms in K2, "
            f"bitwise equal to K1-GD: {same}")
        if not same:
            fail("phase 13: the GD rounds driver differs from K1-GD")
        if launched != rounds:
            fail(f"phase 13: {launched} K2-GD launches, not {rounds}")
        if not compact:
            k2_ms = timer.total_ms()
            k2_plain_ms, agreements = 0.0, []
            k2_bound = roofline.Bound(0.0, 0.0)
            for rin, rout in zip(timer.inputs, timer.outputs):
                rp, ms = timed(lambda: fs.fused_round_reference(
                    *rin, solver="gd"))
                k2_plain_ms += ms
                k2_bound = k2_bound + roofline.fused_rounds(
                    FULL_BATCH, T, J, O,
                    kernel_counts(plain_tally(fs.fused_round_reference, *rin,
                                              solver="gd"),
                                  float((rin[7] < 0.5).sum()),
                                  float(rout.inner.sum()), "gd"), 3, "gd")
                agreements.append(round_agreement(rp, rout, rin[7])[0])
            say(f"phase 13 K2-GD {k2_ms:.1f} ms over {rounds} launches, "
                f"plain version {k2_plain_ms:.1f} ms on the same inputs, "
                f"bound {k2_bound.ms:.2f} ms by {k2_bound.by}; per-round lane "
                f"agreement {[round(a, 4) for a in agreements]}")
            del timer.inputs[:], timer.outputs[:]
    del k1, want, got, step, args, scns
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
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0),
                               MAIN_BATCH, device=dev)
    args = fleet.fused_args(cfg, basis, scns)
    k1, k1_rand_ms = timed(lambda: fs.fused_solve(*args, solver="gd"))
    same_k1 = same_result(res_on, fleet.kernel_result(k1))
    say(f"phase 13 GD compaction off: {MAIN_BATCH / min(off_times):.1f} "
        f"solves/s (best of {[round(t, 4) for t in off_times]} s), per-lane "
        f"results equal the compacted run's bit for bit: {same_off}; K1-GD "
        f"on the same scenes {k1_rand_ms:.1f} ms, equal to the rounds "
        f"driver's bit for bit: {same_k1}")
    sub = plain_tally(fs.fused_solve_reference, cfg, *args[1:4],
                      *(x[..., :TALLY_LANES] for x in args[4:]), solver="gd")
    tally = kernel_counts({key: v * scale for key, v in sub.items()},
                          float((k1.outer_iters + k1.fulfilled).sum()),
                          float(k1.inner_iters.sum()), "gd")
    k1_rand_bound = roofline.fused_rounds(MAIN_BATCH, T, J, O, tally, 4, "gd")
    rounds_run = (k1.outer_iters + k1.fulfilled)[0]
    live = [float((rounds_run > r).sum()) for r in range(rounds)]
    k2_rand_bound = roofline.fused_round_launches(MAIN_BATCH, T, J, O, tally,
                                                  live, "gd")
    say(f"phase 13 GD bounds at {MAIN_BATCH} random scenes (plain tally on "
        f"{TALLY_LANES} lanes x {scale:g}): K1-GD {k1_rand_bound.ms:.1f} ms "
        f"by {k1_rand_bound.by}; K2-GD per solve ({rounds} launches, live "
        f"lanes {[int(x) for x in live]}) {k2_rand_bound.ms:.1f} ms by "
        f"{k2_rand_bound.by}; work {({key: round(v) for key, v in tally.items()})}")
    if not (same_off and same_k1):
        fail("phase 13: the GD rounds driver (compaction on/off) and K1-GD "
             "differ on the same scenes")
    if not (torch.isfinite(res_on.alpha).all()
            and torch.isfinite(res_on.stats.final_cost).all()):
        fail("phase 13: non-finite GD output")
    if not gate_ok:
        fail("phase 13: the paired GD xla gate failed")
    del res_on, k1, args, scns
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
                             ms_per_solve_1M_random=k2_solve_ms,
                             bound_ms_per_solve_1M_random=k2_rand_bound.ms),
    }


def grid_shapes():
    """(lanes per CTA, CTAs) of the ragged checks: each of WARP_SHAPES on
    the full persistent grid, then the default on one CTA."""
    return [(w, 0) for w in WARP_SHAPES] + [(0, 1)]


def ptxas_report(log):
    """{kernel: {registers, spill_stores, spill_loads, stack}} from nvcc's
    ptxas report; K1/K2 as fused_solve<solver,T,O> / fused_round<solver,T,O>
    (solver bls or gd; <solver,0,0>: the generic instantiation)."""
    from irm_motion_planning_tpu_torch.ops import fused_solve as fs

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)_kernel"
                      r"(?:I((?:L[ib]\d+E)+)E)?", line)
        if m:
            name = m.group(1)
            if m.group(2) is not None:
                targs = re.findall(r"L[ib](\d+)E", m.group(2))
                if name.startswith("fused_") and len(targs) == 3:
                    targs[0] = fs.SOLVERS[int(targs[0])]
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
    ``module`` with CUDA events (and, with ``capture``, keeps their inputs
    and outputs) by wrapping the module functions that the drivers look up
    at each call.  A wrapped function counts its launches on the module
    attribute, so the wrapper carries each count in and hands it back on
    exit."""

    def __init__(self, module, *names, capture: bool = False):
        self.module, self.names, self.capture = module, names, capture
        self.events = {n: [] for n in names}
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
            start.record()
            out = orig(*a, **kw)
            end.record()
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
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e)
                   for s, e in self.events[name or self.names[0]])


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


def plain_tally(ref, *args, **kw):
    """The work tally (fused_solve.count_work) of the plain version ``ref``
    on ``args``, from a call of its own, so that no timed call keeps it."""
    tally = {}
    ref(*args, tally=tally, **kw)
    return tally


def kernel_counts(tally, rounds, accepted, solver="bls"):
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
    sys.exit(main())
