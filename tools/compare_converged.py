"""Converged fractions of the four engines on the same random scenes.

    JAX_PLATFORMS=cpu python tools/compare_converged.py [--T 200] \\
        [--scenes 512] [--chunk 64] [--solver bls] \\
        [--ladder-eval linearized] [--seed 0] \\
        [--tiers [lean,ultra,bf16]] [--port-only] [--two-roundings] \\
        [--one-rounding] [--contract dir,cand,nt,alpha,mix,field,sums] \\
        [--endpoint]

On the CPU, with the bench's schedule of ``--solver`` (BLS in the ladder
tier ``--ladder-eval``, or GD; ``max_obstacles=11``) at T (a committed
basis export) and the port's random scenes of ``--seed``: the JAX
package's fused kernel (interpreted, in chunks of ``--chunk`` lanes,
``recip_newton=True``) and its xla engine, and the port's fused backend
(the plain K1) and xla engine; with ``--tiers`` also JAX's fused kernel
and the port's plain K1 in the linearized ladder's kernel tiers (lean,
ultra, bf16); ``--port-only`` leaves the JAX engines out;
``--two-roundings`` also runs each of the port's engines with every
update the port forms with one rounding (fused_solve.fma, as XLA forms it
on the CPU: the accepted alpha ``a_fac alpha - lr g`` of the xla engine and
of every fused program but the linearized carry program, GD's trial, the
exact ladder's rung candidates) rounded twice instead (``a_fac alpha``
rounded, then the step subtracted: fused_solve.two_roundings);
``--one-rounding`` runs them with every update rounded once, the carry
program's accepted alpha too (PERF.md section 7); ``--contract`` runs the
port's fused engine with the named expressions of the linearized carry
program rounded once, as XLA contracts them into FMAs on the CPU (``dir``
the direction ``lambda_reg x + g``, fused_solve.carry_direction; ``cand``
a rung's candidate ``x - lr d``, rung_point; ``nt`` the accepted iterate,
accepted_point; ``alpha`` the accepted alpha, two_roundings; ``mix`` the
mix combine of the forward and pull-back products, mix_combine; ``field``
the obstacle field's h, s and sum, field_h/field_dist/field_add; ``sums``
the cost sums of scalar_cost, sum_pair/sum_add), each set a
comma list and the sets separated by ``/``; with ``--endpoint`` only the
bench's reference scene is solved instead (bench.run_bench on the CPU,
batch 2, the main path's plain version), as shipped and under each
``--contract`` set, and its endpoint error and strict verdict printed.
Prints the
converged count of each per chunk, and in all the converged fraction, the
mean accepted steps and the mean unpenalized obstacle cost (the paired
gate's cost, bench.mean_obstacle_cost).  bench.py's paired gate holds a
fused run's converged fraction within max(0.02, min(0.15 max(conv), 0.05)) of
the xla engine's.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402

import irm_motion_planning_tpu as mp  # noqa: E402
from irm_motion_planning_tpu.ops import pallas_step as ps  # noqa: E402
from irm_motion_planning_tpu.solvers import fleet as jfleet  # noqa: E402
import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch import bench  # noqa: E402
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet  # noqa: E402


def _t(x):
    return torch.tensor(np.asarray(x))


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _mix_once(terms):
    """The mix combine as XLA contracts it: fma(x0, m0, x1 m1), then each
    later term fused into the sum."""
    (x0, m0), (x1, m1) = terms[:2]
    acc = tfs.fma(x0, m0, x1 * m1)
    for x, m in terms[2:]:
        acc = tfs.fma(x, m, acc)
    return acc


# The carry program's expressions XLA may contract, each a list of the
# fused_solve helpers that form them with their one-rounding replacements
# (a b + c d as fma(a, b, c d), acc + a b as fma(a, b, acc): the forms
# XLA gives on the CPU, PERF.md section 7).
CONTRACTED = {
    "dir": [("carry_direction",
             lambda lam, x, g: tfs.fma(_f32(lam), x, g))],
    "cand": [("rung_point", lambda x, lr, d: tfs.fma(-lr, d, x))],
    "nt": [("accepted_point", lambda x, lr, d: tfs.fma(-lr, d, x))],
    "alpha": [("two_roundings", tfs.fma)],
    "mix": [("mix_combine", _mix_once)],
    "field": [("field_h", lambda ex, ey: 0.5 * tfs.fma(ex, ex, ey * ey)),
              ("field_dist", lambda h, q, ox, ex, oy, ey:
               (h + q) - tfs.fma(ox, ex, oy * ey)),
              ("field_add", lambda acc, w, r: tfs.fma(w, r, acc))],
    "sums": [("sum_pair", lambda a, b, c, d:
              tfs.fma(_f32(a), _f32(b), _f32(c) * _f32(d))),
             ("sum_add", lambda acc, a, b: tfs.fma(_f32(a), _f32(b), acc))],
}


class contracted:
    """The context in which the expressions ``keys`` of CONTRACTED are
    rounded once."""

    def __init__(self, keys):
        self.swaps = [pair for k in keys for pair in CONTRACTED[k]]

    def __enter__(self):
        self.saved = [(name, getattr(tfs, name)) for name, _ in self.swaps]
        for name, fn in self.swaps:
            setattr(tfs, name, fn)

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(tfs, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--scenes", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--solver", default="bls", choices=("bls", "gd"))
    ap.add_argument("--ladder-eval", default="linearized")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiers", nargs="?", const="lean,ultra,bf16", default="")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--two-roundings", action="store_true")
    ap.add_argument("--one-rounding", action="store_true")
    ap.add_argument("--contract", default="")
    ap.add_argument("--endpoint", action="store_true")
    a = ap.parse_args(argv)
    if a.solver == "gd" and a.tiers:
        ap.error("the kernel tiers are programs of BLS")
    cfg = bench.bench_config(solver=a.solver, n_timesteps=a.T,
                             ladder_eval=a.ladder_eval)
    jcfg = mp.PlannerConfig(
        n_timesteps=a.T, bls_mode="ladder", fixed_iters=True,
        inner_schedule=cfg.inner_schedule,
        max_inner_iteration=cfg.max_inner_iteration, max_obstacles=11,
        ladder_eval=a.ladder_eval, recip_newton=True, pallas_block_b=a.chunk)
    jb = mp.make_basis(jcfg)
    tb = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(a.seed),
                               a.scenes, device="cpu")
    names = ["JAX fused", "JAX xla", "port fused", "port xla"]
    tiers = tuple(t for t in a.tiers.split(",") if t)
    # The port's engines again with fused_solve's update arithmetic
    # replaced: (label, the function replaced, its replacement, tiers).
    variants = [v for v, on in (
        (("two roundings", "fma", tfs.two_roundings,
          ("",) + tuple(t for t in tiers if t != "lean")), a.two_roundings),
        (("one rounding", "two_roundings", tfs.fma, ("",)), a.one_rounding))
        if on]
    contracts = [tuple(k for k in c.split(",") if k)
                 for c in a.contract.split("/") if c]
    for keys in contracts:
        if not set(keys) <= set(CONTRACTED):
            ap.error(f"--contract takes {sorted(CONTRACTED)}, got {keys}")
    if a.endpoint:
        for keys in [()] + contracts:
            with contracted(keys):
                r = bench.run_bench(batch=2, repeats=1, device="cpu")
            print(f"reference scene, contract {'+'.join(keys) or 'none'}: "
                  f"endpoint {r['endpoint_err']}, avg/max cost "
                  f"{r['avg_cost']}/{r['max_cost']}, strict gate "
                  f"{'PASS' if r['quality_ok'] else 'FAIL'}", flush=True)
        return 0
    names = (names[2 * a.port_only:]
             + [f"JAX fused {t}" for t in tiers if not a.port_only]
             + [f"port fused {t}" for t in tiers]
             + [f"port {e}{' ' + t if t else ''} {label}"
                for label, _, _, ts in variants for t in ts
                for e in (("fused", "xla") if not t else ("fused",))]
             + [f"port fused contract {'+'.join(k) or 'none'}"
                for k in contracts])
    total = np.zeros(len(names), dtype=int)
    steps = np.zeros(len(names))
    costs = np.zeros(len(names))
    for lo in range(0, a.scenes, a.chunk):
        sub = mt.Scenario(*(x[lo:lo + a.chunk] for x in scns))
        js = mp.Scenario(*(jnp.asarray(x.numpy()) for x in sub))
        runs = [] if a.port_only else [
            jfleet.fleet_solve(jcfg, jb, js, solver=a.solver, backend="fused",
                               interpret=True),
            jfleet.fleet_solve(jcfg, jb, js, solver=a.solver, backend="xla"),
        ]

        def port(t):
            if t:
                return tfleet.kernel_result(tfs.fused_solve(
                    *tfleet.fused_args(cfg, tb, sub), **{t: True}))
            return [tfleet.fleet_solve(cfg, tb, sub, solver=a.solver,
                                       backend=e) for e in ("fused", "xla")]

        runs += port("")
        if tiers and not a.port_only:
            fsc = jfleet.to_fleet(js)
            n = fsc.start.shape[-1]
            ka = (jb.kv, jb.kv.T, jb.mix,
                  jnp.moveaxis(jfleet.fleet_init_alpha(jcfg, jb, fsc), 1, 0),
                  jnp.full((1, n), jcfg.lambda_sg_constraint, jnp.float32),
                  jnp.full((1, n), jcfg.lambda_jl_constraint, jnp.float32),
                  fsc.start, fsc.goal, fsc.obstacles[:, 0, :],
                  fsc.obstacles[:, 1, :], fsc.obstacle_weight)
            for t in tiers:
                r = ps.fused_solve(jcfg, *ka, solver="bls", block_b=n,
                                   interpret=True, lean=True,
                                   ultra=t != "lean", bf16=t == "bf16")
                runs.append(tfleet.SolveResult(
                    _t(r.alpha).permute(2, 1, 0), tfleet.SolveStats(
                    _t(r.outer_iters[0]), _t(r.inner_iters[0]),
                    _t(r.fulfilled[0] > 0.5), _t(r.final_loss[0]))))
        runs += [port(t) for t in tiers]
        for _, name, repl, ts in variants:
            orig = getattr(tfs, name)
            setattr(tfs, name, repl)
            try:
                for t in ts:
                    runs += port(t) if not t else [port(t)]
            finally:
                setattr(tfs, name, orig)
        for keys in contracts:
            with contracted(keys):
                runs.append(port("")[0])
        counts = [int(np.asarray(r.stats.converged).sum()) for r in runs]
        total += counts
        steps += [float(np.asarray(r.stats.inner_iters).sum()) for r in runs]
        costs += [len(sub.start) * bench.mean_obstacle_cost(
            cfg, tb, sub, tfleet.SolveResult(
                r.alpha if torch.is_tensor(r.alpha) else _t(r.alpha), None))
            for r in runs]
        print(f"scenes {lo}-{lo + a.chunk - 1}: "
              + ", ".join(f"{n} {c}" for n, c in zip(names, counts)),
              flush=True)
    what = "gd" if a.solver == "gd" else a.ladder_eval
    print(f"T={a.T} {what}, {a.scenes} scenes of seed {a.seed}, "
          f"converged (fraction; mean accepted steps; mean obstacle cost): "
          + ", ".join(f"{n} {c} ({c / a.scenes:.4f}; {st / a.scenes:.1f}; "
                      f"{co / a.scenes:.5f})"
                      for n, c, st, co in zip(names, total, steps, costs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
