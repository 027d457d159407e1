"""Time compile-time variants of the fused kernels K1/K2 on the card.

    python tools/fused_variants.py NAME=FLAG[,FLAG...] ...

Builds ``irm_motion_planning_tpu_torch/csrc/fused_solve.cu`` once per
variant with the given ``-D`` flags (each its own ``nvcc``, all started
together, beside the port's own build), prints each build's ptxas report
(registers, spills) and its launch shape, then runs K1 of every variant on
the bench's 1,048,576-lane inputs (the BLS solver on the replicated
reference scene, then on random scenes, seed 0), twice each, timed with
CUDA events, and says whether its outputs equal the default build's bit for
bit.

The flags the warp body reads: ``WB_MIN_CTAS=n`` (CTAs of 16 warps per SM
that ``__launch_bounds__`` asks registers for; 2 by default),
``WB_MAX_WARPS=n`` and ``WB_TREE_SUMS`` (a phase-ablated build: the sums
over t by shuffle trees instead of the sequential chains; not bitwise).
Needs a CUDA card.
"""

import argparse
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


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptrs(*xs):
    return [ctypes.c_void_p(x.data_ptr()) for x in xs]


class Variant:
    def __init__(self, path, warps):
        self.lib = _build.bind(ctypes.CDLL(path), ("fused_solve_launch",))
        self.warps = warps

    def shape(self, cfg, O, B):
        out = (ctypes.c_int * 3)()
        err = self.lib.fused_launch_shape(fs.kernel_params(cfg, O, B),
                                          self.warps, 0,
                                          fs.solver_index("bls"), out)
        return {"err": err, "ctas_per_sm": out[0], "smem": out[2]}

    def solve(self, args):
        cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
        B = a0.shape[-1]
        alpha = a0.clone()
        outs = [torch.empty((1, B), device=a0.device) for _ in range(4)]
        queue = torch.zeros(1, dtype=torch.int32, device=a0.device)
        err = self.lib.fused_solve_launch(
            fs.kernel_params(cfg, ox.shape[0], B), self.warps,
            fs.solver_index("bls"), 0,
            *ptrs(kv, kvt, mix, lsg, ljl, start, goal, ox, oy, ow, alpha,
                  *outs, queue), stream())
        if err:
            raise RuntimeError(f"variant launch failed: {err}")
        return fs.FusedSolve(alpha, *outs)


def compile_(src, flags, out):
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *flags, "-o", out,
         src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, what):
    out, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {what}:\n{err[-3000:]}")
    for line in ptxas_lines(out + err):
        print(f"  {what}: {line}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
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
    src = os.path.join(_build.CSRC, "fused_solve.cu")
    procs, warps = {}, {}
    for spec in a.variants:
        name, flags = spec.split("=", 1)
        flags = [f"-D{x}" for x in flags.split(",") if x]
        warps[name] = next((int(f.split("=")[1]) for f in flags
                            if f.startswith("-DWB_MAX_WARPS=")),
                           fs.DEFAULT_WARPS)
        procs[name] = compile_(src, flags, os.path.join(out_dir, name + ".so"))
    try:
        for name, proc in procs.items():
            finish(proc, name)
    finally:  # no nvcc outlives a failed build
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    _build.load_library()
    if _build.build_info:  # None when the library was already built
        for line in ptxas_lines(_build.build_info["log"]):
            print(f"  default: {line}")
    runs = {n: Variant(os.path.join(out_dir, n + ".so"), warps[n])
            for n in procs}
    say("built")

    cfg = bench.bench_config()
    basis = mt.make_basis(cfg, device=dev)
    scn0 = mt.reference_scenario(cfg, device=dev)
    for label, scns in (
            ("1M replicated", mt.replicate_scenario(scn0, 1048576)),
            ("1M random", mt.random_scenarios(
                cfg, torch.Generator().manual_seed(0), 1048576, device=dev))):
        args = fleet.fused_args(cfg, basis, scns)
        ref, ms = timed(lambda: fs.fused_solve(*args))
        say(f"{label}: default build {ms:.1f} ms")
        for name, v in runs.items():
            for _ in range(2):
                out, ms = timed(lambda: v.solve(args))
                say(f"{label}: {name} {v.shape(cfg, 11, 1024)} {ms:.1f} ms, "
                    f"bitwise {same(out, ref)}")
                del out
        _, ms = timed(lambda: fs.fused_solve(*args))
        say(f"{label}: default build again {ms:.1f} ms")
        del ref, args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
