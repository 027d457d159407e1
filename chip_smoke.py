"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from irm_motion_planning_tpu_torch/csrc,
holds it against its plain PyTorch version, and drives the port's main
path (irm_motion_planning_tpu_torch.bench's protocol: the reference scene
replicated over 1,048,576 lanes, the fused BLS solve at the benchmark
schedule) through the kernel.  Phases:

1. device: the card's name and power limit, the kernel build;
2. kernel against plain, short horizon: 1,024 random scenes, 1 round x 4
   steps, lane agreement and alpha error on agreeing lanes; then the first
   1,000 of those lanes (a masked, ragged last block) at 64, 128 and 256
   lanes per block, which must equal the full batch's lanes bit for bit;
3. kernel against plain, full schedule: 16,384 random scenes, converged
   fraction, mean unpenalized obstacle cost and the phantom-convergence
   rate from the exact constraint check, as bench.py gates random scenes,
   and the lane agreement;
4. the main path: solves/s, the launch count, and the quality of the
   solved reference scene (avg/max cost within 2% of the reference's,
   endpoint error < 0.05; bench.py's strict endpoint < 0.01 is printed).
   Every lane of the replicated scene must equal lane 0 bit for bit, and the
   plain version's avg/max cost on the same inputs must lie within 1% of
   the kernel's.

Any failed phase exits non-zero.  It imports nothing of JAX.  The last line
is ``{"ok": true, "device": {...}}``; the line before it lists the kernel.
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


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


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
    say(smi)
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
    out = bench.run_bench(batch=MAIN_BATCH, repeats=3)
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

    say(json.dumps({"kernels": [{
        "name": "fused_solve",
        "route": "cuda",
        "source": "irm_motion_planning_tpu_torch/csrc/fused_solve.cu",
        "replaces": "irm_motion_planning_tpu/ops/pallas_step.py:1606",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
    }]}))
    if not math.isfinite(main_ms):
        fail("kernel time not finite")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
