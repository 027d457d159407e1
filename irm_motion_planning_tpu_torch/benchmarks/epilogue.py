"""The BLS step's phase costs in K1, one phase removed at a time (the port
of benchmarks/epilogue.py).

Times K1 (ops/fused_solve.py ``fused_solve``, the linearized BLS program)
on the bench's config with one phase of the step ABLATED in a build of its
own: a compile-time flag of csrc/warp_body.cuh (ops/_build.py
``build_variant``), never a run-time switch.  Each ablated build gives
wrong results by design; the deltas are timing evidence only.

  * ladder1      (WB_ABLATE_LADDER1): the Armijo ladder capped at one
                 rung (removes rungs 2+: their FK, obstacle field and cost)
  * dir_forward  (WB_ABLATE_DIR_FORWARD): the direction's forward product
  * pullback     (WB_ABLATE_PULLBACK): the end-of-step cost and gradient
                 pass (FK, field gradient, the kvt pull-back)
  * fk           (WB_ABLATE_FK): the rungs' FK
  * obsfield     (WB_ABLATE_OBSFIELD): the rungs' obstacle field

Share of a phase = (t_full - t_ablated) / t_full.  Shares need not sum to
one.  A removed phase can change the work itself (an ablated ladder or a
stale gradient takes other steps), so each variant's own counts stand
beside its time: K1's rounds run and accepted steps per lane, from its
outputs; and the plain version's ladder rungs per step on the full
program, from its work tally (fused_solve.count_work).

    python -m irm_motion_planning_tpu_torch.benchmarks.epilogue \\
        [--batch 1048576] [--repeats 4] [--block-b 0] [--device cuda|cpu]

The five builds run in parallel (one nvcc each) before any timing.  K1 is
timed with CUDA events, best of ``--repeats`` after a warm-up, on the
reference scene replicated over ``--batch`` lanes (the main path's
width); ``--block-b``: lanes per CTA (0: 16).  One JSON line, the card's
name and power limit beside it.  ``--device cpu`` times the plain version
of the full program only (the ablated builds are CUDA kernels).
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor

from .. import make_basis, reference_scenario, replicate_scenario
from ..bench import bench_config
from ..ops import _build
from ..ops import fused_solve as fs
from ..ops import roofline
from ..solvers import fleet
from . import _harness

# JAX's _ABLATE values and the build flag of each, in the JAX script's
# order.
VARIANTS = {
    "ladder1": "WB_ABLATE_LADDER1",
    "dir_forward": "WB_ABLATE_DIR_FORWARD",
    "pullback": "WB_ABLATE_PULLBACK",
    "fk": "WB_ABLATE_FK",
    "obsfield": "WB_ABLATE_OBSFIELD",
}
TALLY_LANES = 4


def build_variants(J: int = 3, names=tuple(VARIANTS)) -> dict:
    """Build the ablated libraries of ``names`` at J in parallel (one
    nvcc each, started together); returns each one's path.  Raises when a
    build fails."""
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(_build.build_variant, J, (VARIANTS[n],))
                   for n in names}
        return {n: f.result() for n, f in futures.items()}


def variant_build(name: str, J: int = 3) -> dict:
    """What the build of ``name`` did in this process (seconds and nvcc's
    ptxas report), or an empty dict when it was built before."""
    return _build.builds.get((J, (VARIANTS[name],)), {})


def k1_counts(out: fs.FusedSolve) -> dict:
    """K1's own work per lane, from its outputs: rounds run and accepted
    steps (means over the lanes)."""
    return {"rounds": float((out.outer_iters + out.fulfilled).mean()),
            "accepted_steps": float(out.inner_iters.mean())}


def timed_k1(args: tuple, repeats: int, dev) -> tuple:
    """(least ms of ``repeats`` K1 launches after a warm-up, the last
    output)."""
    out, _ = _harness.event_ms(lambda: fs.fused_solve(*args), dev)
    best = float("inf")
    for _ in range(repeats):
        out, ms = _harness.event_ms(lambda: fs.fused_solve(*args), dev)
        best = min(best, ms)
    return best, out


def plain_rungs_per_step(cfg, basis, scn0, dev) -> dict:
    """The plain version's work on TALLY_LANES lanes of the replicated
    scene (every lane the same): its steps and ladder rungs per lane, and
    rungs per step."""
    args = fleet.fused_args(cfg, basis, replicate_scenario(scn0, TALLY_LANES))
    tally = roofline.plain_tally(fs.fused_solve_reference, *args)
    steps = float(tally["steps"].mean())
    rungs = float(tally["rungs"].mean())
    return {"steps": steps, "rungs": rungs,
            "rungs_per_step": rungs / steps if steps else 0.0}


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1048576)
    p.add_argument("--block-b", type=int, default=0,
                   help="K1's lanes per CTA, 1-16 (0: 16)")
    p.add_argument("--repeats", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = _harness.open_device(args.device, "epilogue")
    cfg = bench_config(block_b=args.block_b)
    on_card = dev.type == "cuda"
    if on_card:
        build_variants(cfg.n_joints)
    basis = make_basis(cfg, device=dev)
    scn0 = reference_scenario(cfg, device=dev)
    kargs = fleet.fused_args(cfg, basis,
                             replicate_scenario(scn0, args.batch))
    times, work = {}, {}
    times["full"], out = timed_k1(kargs, args.repeats, dev)
    work["full"] = k1_counts(out)
    del out
    for name, flag in (VARIANTS.items() if on_card else ()):
        with _build.variant(cfg.n_joints, (flag,)):
            times[name], out = timed_k1(kargs, args.repeats, dev)
        work[name] = k1_counts(out)
        del out
        print(f"# {name}: {times[name]:.1f} ms, {work[name]}",
              file=sys.stderr, flush=True)
    full_after, _ = timed_k1(kargs, args.repeats, dev)
    full = times["full"]
    return {
        "metric": "bls_step_phase_shares",
        "batch": args.batch,
        "block_b": fs.warps_per_cta(cfg),
        "times_ms": {k: round(v, 2) for k, v in times.items()},
        "share_of_step": {k: round((full - v) / full, 4)
                          for k, v in times.items() if k != "full"},
        "full_after_ms": round(full_after, 2),
        "k1_work_per_lane": work,
        "plain_work_per_lane": plain_rungs_per_step(cfg, basis, scn0, dev),
        "note": "share = (t_full - t_ablated)/t_full; the ablated builds "
                "give wrong results by design (timing evidence only)"
                + ("" if on_card else "; on the CPU the plain version of "
                   "the full program only"),
        **_harness.card(dev),
    }


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
