"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from irm_motion_planning_tpu_torch/csrc
(K1, the whole BLS solve, and K2, one penalty round), holds each against
its plain PyTorch version, and drives the port's two paths through them:
the main path (irm_motion_planning_tpu_torch.bench's default protocol: the
reference scene replicated over 1,048,576 lanes, one K1 launch) and the
heterogeneous-fleet path (the bench's random-scenes mode: 1,048,576 random
scenes, one K2 launch per penalty round with lane compaction, gated against
the plain xla engine).  Phases:

1. device: the card's name and power limit, the kernel build;
2. K1 against plain, short horizon: 1,024 random scenes, 1 round x 4
   steps, lane agreement and alpha error on agreeing lanes; then the first
   1,000 of those lanes (a masked, ragged last block) at 64, 128 and 256
   lanes per block, which must equal the full batch's lanes bit for bit;
3. K1 against plain, full schedule: 16,384 random scenes, converged
   fraction, mean unpenalized obstacle cost and the phantom-convergence
   rate from the exact constraint check, as bench.py gates random scenes,
   and the lane agreement;
4. the main path: solves/s, the K1 launch count, and the quality of the
   solved reference scene (avg/max cost within 2% of the reference's,
   endpoint error < 0.05; bench.py's strict endpoint < 0.01 is printed).
   Every lane of the replicated scene must equal lane 0 bit for bit, and the
   plain version's avg/max cost on the same inputs must lie within 1% of
   the kernel's;
5. K2 against plain, one round (n_r = 4): 1,024 random scenes, a quarter of
   the lanes fulfilled, penalties escalated x1/x10/x100, four learning
   rates; lane agreement and alpha error on the outputs the caller reads;
   then 1,000 of those lanes at 64/128/256 lanes per block, bit for bit the
   full batch's lanes;
6. the rounds driver against K1: 16,384 random scenes at the bench
   schedule, compaction off and on; every output field must equal K1's bit
   for bit and each solve must launch K2 ten times.  K2's time (the sum of
   its ten launches) and the plain version's on the same ten inputs;
7. the heterogeneous path: solves/s with compaction on (K2 launch count,
   the paired xla gate on 32,768 lanes with its values, bands and the xla
   engine's time; the gate must pass) and off (per-lane results must equal
   the compacted run's bit for bit), K2's time per solve, and K1's
   whole-solve time on the same scenes (which must equal the rounds
   driver's result bit for bit).

Any failed phase exits non-zero.  It imports nothing of JAX.  The last line
is ``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

import json
import math
import subprocess
import sys
import time

import torch

MAIN_BATCH = 1048576
SHORT_BATCH = 1024
RAGGED_BATCH = 1000
FULL_BATCH = 16384
CHECK_LANES = 32768
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
    regs = [l.strip() for l in (_build.build_info or {}).get("log", "").splitlines()
            if "registers" in l]
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__} cuda {torch.version.cuda}; kernel built in "
        f"{build_s:.1f}s ({'; '.join(regs)})")

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
    for bt in (64, 128, 256):
        kr = fs.fused_solve(cfg.replace(pallas_block_b=bt), *args[1:4], *cut)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH])
                   for x, y in zip(kr, k)):
            fail(f"phase 2: {RAGGED_BATCH} lanes at {bt} lanes per block "
                 f"differ from the same lanes of the {SHORT_BATCH}-lane run")
        agree_r, rel_r = fs.lane_agreement(p_cut, kr)
        if agree_r < fs.CARD_SHORT_AGREEMENT_MIN or rel_r > fs.ALPHA_REL_MAX:
            fail(f"phase 2: ragged batch at {bt} lanes per block disagrees "
                 f"with the plain version (lane agreement {agree_r:.4f}, "
                 f"alpha error {rel_r:.3g})")
    say(f"phase 2 ragged batch ({RAGGED_BATCH} lanes; last block masked at "
        f"64/128/256 lanes per block): bitwise equal to the full batch's "
        f"lanes; lane agreement with the plain version {agree_r:.4f}")

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
    fs.fused_solve.launches = 0
    out = bench.run_bench(batch=MAIN_BATCH, repeats=2)
    launches = fs.fused_solve.launches
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
        f"launches {launches}; avg_cost {out['avg_cost']} max_cost "
        f"{out['max_cost']} endpoint_err {out['endpoint_err']}; "
        f"{out['device']}, {out['power_limit']}")
    say(f"phase 4 strict bench.py verdict (endpoint < 0.01 and costs within "
        f"2%): {'PASS' if out['quality_ok'] else 'FAIL'}")
    if launches < 1:
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
    del k
    p, main_plain_ms = timed(lambda: fs.fused_solve_reference(*args))
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
    for bt in (64, 128, 256):
        kr = fs.fused_round(cut[0].replace(pallas_block_b=bt), *cut[1:])
        torch.cuda.synchronize()
        if not all(torch.equal(x, y[..., :RAGGED_BATCH]) for x, y in zip(kr, k)):
            fail(f"phase 5: {RAGGED_BATCH} lanes at {bt} lanes per block "
                 f"differ from the same lanes of the {SHORT_BATCH}-lane run")
    say(f"phase 5 ragged batch ({RAGGED_BATCH} lanes at 64/128/256 lanes per "
        f"block): bitwise equal to the full batch's lanes")

    # -- phase 6: the rounds driver against K1 ------------------------------
    cfg = bench.bench_config()
    _, _, args = random_args(cfg, FULL_BATCH, 2)
    k1 = fs.fused_solve(*args)
    want = fleet.kernel_result(k1)
    rounds = len(fs.inner_schedule(cfg))
    k2_ms = plain_ms = None
    for compact in (False, True):
        before = fs.fused_round.launches
        with RoundTimer(capture=not compact) as timer:
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
            plain_ms, agreements = 0.0, []
            for rin, rout in zip(timer.inputs, timer.outputs):
                rp, ms = timed(lambda: fs.fused_round_reference(*rin))
                plain_ms += ms
                agreements.append(round_agreement(rp, rout, rin[7])[0])
            say(f"phase 6 K2 {k2_ms:.1f} ms over {rounds} launches, plain "
                f"version {plain_ms:.1f} ms on the same inputs; per-round lane "
                f"agreement {[round(a, 4) for a in agreements]}")
            del timer.inputs[:], timer.outputs[:]
    del k1, want, got, args
    torch.cuda.empty_cache()

    # -- phase 7: the heterogeneous path ------------------------------------
    fs.fused_round.launches = 0
    fs.fused_solve.launches = 0
    with RoundTimer(capture=False) as timer:
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
    if not (torch.isfinite(res_on.alpha).all()
            and torch.isfinite(res_on.stats.final_cost).all()):
        fail("phase 7: non-finite output")
    if not gate_ok:
        fail("phase 7: the paired xla gate failed")

    print(json.dumps({"kernels": [{
        "name": "fused_solve",
        "route": "cuda",
        "source": "irm_motion_planning_tpu_torch/csrc/fused_solve.cu",
        "replaces": "irm_motion_planning_tpu/ops/pallas_step.py:1606",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
    }, {
        "name": "fused_round",
        "route": "cuda",
        "source": "irm_motion_planning_tpu_torch/csrc/fused_solve.cu",
        "replaces": "irm_motion_planning_tpu/ops/pallas_step.py:1674",
        "launches": het_launches,
        "max_abs_err": k2_abs_err,
        "ms": k2_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    if not all(math.isfinite(x) for x in (main_ms, k2_ms, plain_ms)):
        fail("kernel time not finite")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def same_result(a, b):
    """Whether two SolveResults are equal bit for bit in every field."""
    return torch.equal(a.alpha, b.alpha) and all(
        torch.equal(x, y) for x, y in zip(a.stats, b.stats))


def round_args(args, n_r, seed):
    """fused_round's arguments from fused_solve's: a quarter of the lanes
    fulfilled, penalties escalated x1/x10/x100, four learning rates."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    g = torch.Generator().manual_seed(seed)
    B = a0.shape[-1]
    dev = a0.device
    ful = (torch.rand((1, B), generator=g) < 0.25).float().to(dev)
    esc = torch.tensor([1.0, 10.0, 100.0])[
        torch.randint(0, 3, (1, B), generator=g)].to(dev)
    lr0 = torch.tensor([0.2, 0.1, 0.05, 0.3])[
        torch.randint(0, 4, (1, B), generator=g)].to(dev)
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


class RoundTimer:
    """Within the block, times every fused_round launch with CUDA events
    (and, with ``capture``, keeps its inputs and outputs) by wrapping the
    module function that the rounds driver looks up at each call.  The
    wrapped function counts its launches on the module attribute, so the
    wrapper carries the count in and hands it back on exit."""

    def __init__(self, capture: bool):
        from irm_motion_planning_tpu_torch.ops import fused_solve as fs

        self.fs, self.capture = fs, capture
        self.events, self.inputs, self.outputs = [], [], []

    def __enter__(self):
        self.orig = orig = self.fs.fused_round

        def wrapped(*a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a)
            end.record()
            self.events.append((start, end))
            if self.capture:
                self.inputs.append(a)
                self.outputs.append(out)
            return out

        wrapped.launches = orig.launches
        self.fs.fused_round = wrapped
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.fs.fused_round.launches
        self.fs.fused_round = self.orig
        return False

    def total_ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


if __name__ == "__main__":
    sys.exit(main())
