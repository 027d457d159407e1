"""Time compile-time variants of the fused kernels K1/K2 on the card.

    python tools/fused_variants.py [--T 50] [--batch N] [--quality] \
        NAME=FLAG[,FLAG...] ...

Builds ``irm_motion_planning_tpu_torch/csrc/fused_solve.cu`` for the reference
arm (J = 3; the library ops/_build.py builds at that J) (with
``fused_tiers.cu`` and ``fused_reach.cu``, whose kernel tiers and reach
layouts it launches) once per variant with
the given ``-D`` flags (each its own ``nvcc``, all started
together, beside the port's own build), prints each build's ptxas report
(registers, spills) and its launch shape, then runs K1-BLS of every variant
on the bench's inputs at T, twice each, timed with CUDA events, and says
whether its outputs equal the default build's bit for bit: at T=50 on
1,048,576 lanes of the replicated reference scene, then of random scenes
(seed 0); at another T (a committed basis export) on ``--batch`` (65,536 by
default) random scenes, in the plan the launch plan gives that T.  Each
variant runs in turn, the default build before and after.

With ``--quality`` each run also prints what its results are worth: on the
replicated reference scene bench.py's endpoint error (unrounded) and
avg/max cost of lane 0, on random scenes the converged fraction.

The flags the warp body reads: ``WB_MIN_CTAS=n`` (CTAs of 16 warps per SM
that ``__launch_bounds__`` asks registers for; 2 by default),
``WB_MAX_WARPS=n``, ``WB_TREE_SUMS`` (a phase-ablated build: the sums
over t by shuffle trees instead of the sequential chains; not bitwise) and
``WB_CARRY_ONE_ROUNDING`` (the linearized carry program's accepted alpha
rounded once at J = 3 too, the bench's arm, where the default build rounds
it twice: fused_solve.carry_rounds_once; every other J rounds it once in
every build; not bitwise).  Needs a CUDA card.
"""

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch import bench  # noqa: E402
from irm_motion_planning_tpu_torch.ops import _build  # noqa: E402
from irm_motion_planning_tpu_torch.ops import fused_solve as fs  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import fleet  # noqa: E402

T0 = time.perf_counter()


def say(msg):
    print(f"[{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


def timed(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def ptxas_lines(log):
    return [l.strip() for l in log.splitlines()
            if "registers" in l or "spill" in l or "Compiling entry" in l]


class Variant:
    def __init__(self, path, warps):
        self.lib = _build.bind(ctypes.CDLL(path), ("fused_solve_launch",))
        self.warps = warps

    @contextlib.contextmanager
    def loaded(self):
        """The wrappers launch this build's kernels within the block."""
        saved = _build._libs.get(3)
        _build._libs[3] = self.lib
        try:
            yield
        finally:
            if saved is None:
                _build._libs.pop(3)
            else:
                _build._libs[3] = saved

    def config(self, cfg):
        return cfg.replace(pallas_block_b=self.warps)

    def shape(self, cfg, O, B):
        with self.loaded():
            return fs.launch_shape(self.config(cfg), O, B, "fused_solve")

    def solve(self, args):
        with self.loaded():
            return fs.fused_solve(self.config(args[0]), *args[1:])


def compile_(srcs, flags, out):
    return subprocess.Popen(
        [_build._nvcc(), *_build.flags(3), "-shared", *flags, "-o", out,
         *srcs], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, what):
    out, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {what}:\n{err[-3000:]}")
    for line in ptxas_lines(out + err):
        print(f"  {what}: {line}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0,
                    help="lanes (0: 1,048,576 at T=50, else 65,536)")
    ap.add_argument("--quality", action="store_true",
                    help="print each run's endpoint error (replicated) or "
                         "converged fraction (random)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    srcs = [os.path.join(_build.CSRC, f)
            for f in ("fused_solve.cu", "fused_tiers.cu", "fused_reach.cu")]
    procs, warps = {}, {}
    for spec in a.variants:
        name, flags = spec.split("=", 1)
        flags = [f"-D{x}" for x in flags.split(",") if x]
        warps[name] = next((int(f.split("=")[1]) for f in flags
                            if f.startswith("-DWB_MAX_WARPS=")),
                           fs.DEFAULT_WARPS)
        procs[name] = compile_(srcs, flags,
                               os.path.join(out_dir, name + ".so"))
    try:
        for name, proc in procs.items():
            finish(proc, name)
    finally:  # no nvcc outlives a failed build
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    _build.load_library()
    if 3 in _build.builds:  # none when the library was already built
        for line in ptxas_lines(_build.builds[3]["log"]):
            print(f"  default: {line}")
    runs = {n: Variant(os.path.join(out_dir, n + ".so"), warps[n])
            for n in procs}
    say("built")

    cfg = bench.bench_config(n_timesteps=a.T)
    basis = mt.make_basis(cfg, device=dev)
    batch = a.batch or (1048576 if a.T == 50 else 65536)
    inputs = [(f"{batch} random", mt.random_scenarios(
        cfg, torch.Generator().manual_seed(0), batch, device=dev))]
    if a.T == 50:
        scn0 = mt.reference_scenario(cfg, device=dev)
        inputs.insert(0, (f"{batch} replicated",
                          mt.replicate_scenario(scn0, batch)))
    say(f"T={a.T}: {fs.launch_plan(cfg, cfg.max_obstacles)}")
    def worth(label, out):
        if not a.quality:
            return ""
        if "replicated" in label:
            q = bench.solution_quality(cfg, basis, scn0,
                                       fleet.kernel_result(out).alpha[0])
            return (f"; endpoint_err {float(q['endpoint_err']):.6f}, avg_cost "
                    f"{float(q['avg_cost']):.6f}, max_cost "
                    f"{float(q['max_cost']):.6f}")
        return f"; converged {float(out.fulfilled.mean()):.4f}"

    for label, scns in inputs:
        args = fleet.fused_args(cfg, basis, scns)
        ref, ms = timed(lambda: fs.fused_solve(*args))
        say(f"{label}: default build {ms:.1f} ms{worth(label, ref)}")
        for name, v in runs.items():
            for _ in range(2):
                out, ms = timed(lambda: v.solve(args))
                say(f"{label}: {name} {v.shape(cfg, 11, batch)} {ms:.1f} ms, "
                    f"bitwise {same(out, ref)}{worth(label, out)}")
                del out
        _, ms = timed(lambda: fs.fused_solve(*args))
        say(f"{label}: default build again {ms:.1f} ms")
        del ref, args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
