"""Hold the streamed body's CTA-cooperative K7 to its references and time it.

    python tools/k7_stream.py [--quick]

Builds the port's kernels and, on the card:

1. at T=50 with the streamed plan forced, K1 of every program at 1, 3, 8
   and 15 lanes per CTA bit for bit the resident K1 (1,024 random scenes,
   2 rounds x 6 steps), and K2 one round (a quarter of the lanes
   fulfilled) likewise;
2. at T=200, K1 of every program on 1,024 random scenes (2 x 6 steps)
   against its plain version (lane agreement, alpha error), and 999 of the
   lanes at 1, 2, 3, 7 and the plan's lanes per CTA and on one CTA bit for
   bit the full batch's; K2 one round against plain likewise; one K4 step
   (K1-GD's plan) against plain;
3. K7 alone (fused_solve.k7_forward) at T=200 on 65,536 lanes: bit for bit
   K6 (step_kernels.forward_eval), its time per product at the plan's
   lanes per CTA, beside K6's and one torch.matmul of the same (2T x T) by
   (T x J B) product (TF32 off);
4. (without ``--quick``) K1 of every program on 65,536 random scenes at
   T=200, the bench schedule, timed with CUDA events, with its converged
   fraction; the bf16 plan at T=2,200 on 512 random scenes (2 x 6 steps),
   timed beside the ``xla`` engine, and at 1 x 4 steps against its plain
   version.

Prints one line per reading and the card's name and power limit; exits
non-zero when a check fails.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch import bench  # noqa: E402
from irm_motion_planning_tpu_torch.ops import _build  # noqa: E402
from irm_motion_planning_tpu_torch.ops import fused_solve as fs  # noqa: E402
from irm_motion_planning_tpu_torch.ops import step_kernels as sk  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import fleet  # noqa: E402

T0 = time.perf_counter()


def say(msg):
    print(f"[{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def short_cfg(T, prog):
    solver, ladder, _ = fs.program_call(prog)
    return mt.PlannerConfig(n_timesteps=T, max_outer_iteration=2,
                            max_inner_iteration=6, fixed_iters=True,
                            max_obstacles=11, ladder_eval=ladder)


def equal(a, b, n=None):
    return all(torch.equal(x, y if n is None else y[..., :n])
               for x, y in zip(a, b))


def streamed_vs_resident(dev):
    for prog in fs.PROGRAMS:
        solver, _, tier = fs.program_call(prog)
        cfg = short_cfg(50, prog)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(5),
                                   1024, device=dev)
        args = fleet.fused_args(cfg, mt.make_basis(cfg, device=dev), scns)
        want = fs.fused_solve(*args, solver=solver, plan="resident", **tier)
        rargs = cs.round_args(args, 4, seed=0, solver=solver)
        want2 = fs.fused_round(*rargs, solver=solver, plan="resident", **tier)
        same = []
        for lanes in (1, 3, 8, 15):
            c = cfg.replace(pallas_block_b=lanes)
            got = fs.fused_solve(c, *args[1:], solver=solver,
                                 plan="streamed", **tier)
            got2 = fs.fused_round(c, *rargs[1:], solver=solver,
                                  plan="streamed", **tier)
            same.append(equal(got, want) and equal(got2, want2))
        say(f"T=50 {prog}: streamed K1/K2 bitwise resident at 1/3/8/15 lanes "
            f"per CTA: {same}")
        if not all(same):
            fail(f"T=50 {prog}: the streamed plan differs from the resident")


def large_vs_plain(dev):
    T = 200
    for prog in fs.PROGRAMS:
        solver, _, tier = fs.program_call(prog)
        cfg = short_cfg(T, prog)
        plan = fs.launch_plan(cfg, 11, prog=prog)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(6),
                                   1024, device=dev)
        args = fleet.fused_args(cfg, mt.make_basis(cfg, device=dev), scns)
        k = fs.fused_solve(*args, solver=solver, **tier)
        p = fs.fused_solve_reference(*args, solver=solver, **tier)
        agree, rel = fs.lane_agreement(p, k)
        rargs = cs.round_args(args, 4, seed=0, solver=solver)
        ful = rargs[7]
        k2 = fs.fused_round(*rargs, solver=solver, **tier)
        agree2, rel2, _ = cs.round_agreement(
            fs.fused_round_reference(*rargs, solver=solver, **tier), k2, ful)
        passed = ful[0] > 0.5
        through = (torch.equal(k2.alpha[..., passed], rargs[4][..., passed])
                   and bool((k2.inner[0, passed] == 0).all()))
        n = cs.ODD_BATCH
        cut = [x[..., :n] for x in args[4:]]
        rcut = [x[..., :n] if torch.is_tensor(x) and x.dim() > 1
                and x.shape[-1] == 1024 else x for x in rargs]
        ragged = []
        for lanes, ctas in ((1, 0), (2, 0), (3, 0), (7, 0),
                            (plan["lanes"], 0), (0, 1)):
            c = cfg.replace(pallas_block_b=lanes)
            kr = fs.fused_solve(c, *args[1:4], *cut, solver=solver,
                                ctas=ctas, **tier)
            k2r = fs.fused_round(c, *rcut[1:], solver=solver, ctas=ctas,
                                 **tier)
            ragged.append(equal(kr, k, n) and equal(k2r, k2, n))
        say(f"T={T} {prog} ({plan['lanes']} lanes per CTA): K1 vs plain "
            f"agreement {agree:.4f} rel {rel:.3g}; K2 {agree2:.4f} rel "
            f"{rel2:.3g}, fulfilled lanes passed through {through}; {n} "
            f"lanes at 1/2/3/7/{plan['lanes']} lanes and one CTA bitwise "
            f"{ragged}")
        if (min(agree, agree2) < fs.CARD_SHORT_AGREEMENT_MIN
                or max(rel, rel2) > fs.ALPHA_REL_MAX or not through
                or not all(ragged)):
            fail(f"T={T} {prog}: the streamed kernels disagree")
    # K4, one GD step in K1-GD's streamed plan.
    cfg = short_cfg(T, "gd")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(7), 1024,
                               device=dev)
    args = fleet.fused_args(cfg, mt.make_basis(cfg, device=dev), scns)
    _, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    ek = sk.cost_grad_eval(cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox,
                           oy, ow)
    lr = torch.full((1, 1024), cfg.gd_lr[0], device=dev)
    ful = (torch.rand((1, 1024), generator=torch.Generator().manual_seed(2))
           < 0.25).float().to(dev)
    sargs = (kv, kvt, mix, a0, ek.grad, ek.traj, ek.vel, ek.loss, lr, ful,
             lsg, ljl, start, goal, ox, oy, ow)
    fn, ref = cs.step_fns(sk, "gd")
    agree, err = cs.step_errors(ref(cfg, *sargs), fn(cfg, *sargs))
    say(f"T={T} K4 one GD step against plain: {cs.step_summary(agree, err)}")
    if not cs.step_ok(agree, err):
        fail("K4 disagrees with its plain version")


def k7_alone(dev):
    T, B = 200, 65536
    cfg = mt.PlannerConfig(n_timesteps=T, max_obstacles=11)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(8), B,
                               device=dev)
    _, kv, kvt, mix, a0, *_ = fleet.fused_args(cfg, basis, scns)
    want = sk.forward_eval(cfg, kv, mix, a0)
    plan = fs.launch_plan(cfg, 11)
    same = equal(fs.k7_forward(cfg, kv, kvt, mix, a0), want)
    ms = cs.best_ms(lambda: fs.k7_forward(cfg, kv, kvt, mix, a0))
    if not same:
        fail("K7 alone differs from K6")
    k6 = cs.best_ms(lambda: sk.forward_eval(cfg, kv, mix, a0))
    torch.backends.cuda.matmul.allow_tf32 = False
    x = a0.permute(1, 0, 2).reshape(T, -1)
    mm = cs.best_ms(lambda: torch.matmul(kv, x))
    say(f"K7 alone at T={T}, {B} lanes, one forward product: "
        f"{plan['lanes']} lanes per CTA {ms:.3f} ms (bitwise K6 {same}); K6 "
        f"{k6:.3f} ms; torch.matmul (2T x T) by (T x J B) {mm:.3f} ms")


def timings(dev):
    T, B = 200, 65536
    for prog in fs.PROGRAMS:
        solver, ladder, tier = fs.program_call(prog)
        cfg = bench.bench_config(solver=solver, ladder_eval=ladder).replace(
            n_timesteps=T)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(0), B,
                                   device=dev)
        args = fleet.fused_args(cfg, mt.make_basis(cfg, device=dev), scns)
        fs.fused_solve(*args, solver=solver, **tier)
        k, ms = cs.timed(lambda: fs.fused_solve(*args, solver=solver, **tier))
        say(f"T={T} {prog} K1 on {B} random scenes (bench schedule): "
            f"{ms:.1f} ms, converged {float(k.fulfilled.mean()):.4f}")
    T, B = cs.TIER_BIG_T, cs.TIER_BIG_BATCH
    basis = cs.harness_basis(mt, T, dev)
    for steps in ((1, 4), (2, 6)):
        cfg = mt.PlannerConfig(n_timesteps=T, max_outer_iteration=steps[0],
                               max_inner_iteration=steps[1], fixed_iters=True,
                               max_obstacles=11, bls_bf16_ladder=True)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(9), B,
                                   device=dev)
        args = fleet.fused_args(cfg, basis, scns)
        fs.fused_solve(*args, bf16=True)
        k, ms = cs.timed(lambda: fs.fused_solve(*args, bf16=True))
        line = f"T={T} bf16 plan {steps[0]}x{steps[1]} steps on {B} lanes: " \
               f"K1 {ms:.1f} ms"
        if steps == (1, 4):
            agree, rel = fs.lane_agreement(
                fs.fused_solve_reference(*args, bf16=True), k)
            line += f", against plain agreement {agree:.4f} rel {rel:.3g}"
            if agree < fs.CARD_SHORT_AGREEMENT_MIN:
                fail("the bf16 plan disagrees with its plain version")
        else:
            fleet.fleet_solve(cfg, basis, scns, backend="xla")
            _, xms = cs.timed(lambda: fleet.fleet_solve(cfg, basis, scns,
                                                        backend="xla"))
            line += f"; the xla engine {xms:.1f} ms"
        say(line)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load_library()
    log = _build.builds.get(3, {}).get("log", "")
    for name, r in cs.ptxas_report(log).items():
        if "streamed" in name or "k7" in name:
            print(f"    {name}: {r}", flush=True)
    say(f"built in {_build.builds.get(3, {}).get('seconds', 0):.1f}s")
    streamed_vs_resident(dev)
    large_vs_plain(dev)
    k7_alone(dev)
    if not a.quick:
        timings(dev)
    say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
