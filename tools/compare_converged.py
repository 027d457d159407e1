"""Converged fractions of the four engines on the same random scenes.

    JAX_PLATFORMS=cpu python tools/compare_converged.py [--T 200] \\
        [--scenes 512] [--chunk 64] [--solver bls] \\
        [--ladder-eval linearized] [--seed 0] \\
        [--tiers [lean,ultra,bf16]] [--port-only] [--two-roundings] \\
        [--one-rounding] [--contract dir,cand,nt,alpha,mix,field,sums] \\
        [--replica none/all/all-recip/recip,sincos] \\
        [--endpoint] [--xla-only] [--rounds R] [--float64] \\
        [--n-joints J]

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
of every fused program but the linearized carry program at J = 3, GD's
trial, the
exact ladder's rung candidates) rounded twice instead (``a_fac alpha``
rounded, then the step subtracted: fused_solve.two_roundings);
``--one-rounding`` runs them with every update rounded once, the carry
program's accepted alpha at J = 3 too (PERF.md section 7); ``--contract`` runs the
port's fused engine with the named expressions of the linearized carry
program rounded once, as XLA contracts them into FMAs on the CPU (``dir``
the direction ``lambda_reg x + g``, fused_solve.carry_direction; ``cand``
a rung's candidate ``x - lr d``, rung_point; ``nt`` the accepted iterate,
accepted_point; ``alpha`` the accepted alpha, two_roundings; ``mix`` the
mix combine of the forward and pull-back products, mix_combine; ``field``
the obstacle field's q, h, s, its sum over the obstacles and the
gradient's accumulators, field_q/field_h/field_dist/field_sum/
field_acc/field_grad; ``sums``
the cost sums of scalar_cost, sum_pair/sum_add), each set a
comma list and the sets separated by ``/``; ``--replica`` runs the port's
fused engine (the plain K1, program bls) in the arithmetic of JAX's
interpreted fused kernel, as the sets of pieces name it
(tools/carry_replica.py: ``recip`` the interpreter's
reciprocal, ``sincos`` glibc's sin and cos, ``rsqrt`` XLA's, ``tsums``
XLA's sums over T, ``pullback`` and ``forward`` its dot's order,
``contract`` the products it fuses into FMAs but the accepted alpha's,
``alpha`` that one, ``init`` the warm start's product in its order;
``all``, ``all-x``, ``none`` = as shipped), and
prints beside each run the share of its converged flags equal to JAX's
fused kernel's (``all`` gives every lane's flag, alpha and loss bit for
bit: tests/test_torch_carry_replica.py); with ``--endpoint`` only the
bench's reference scene is solved instead (bench.run_bench on the CPU,
batch 2, the main path's plain version), as shipped and under each
``--contract`` and ``--replica`` set, and its endpoint error and strict
verdict printed.
``--n-joints J`` (with ``--port-only``) gives the arm J equal links of
the reference arm's reach, 3.0 (its basis built by make_basis): with
``--two-roundings --one-rounding`` it measures the carry program's
accepted alpha rounded twice and once at any J (the port ships one
rounding at every J but 3, two at 3: fused_solve.carry_rounds_once; so
at J != 3 the shipped run is the once column and ``--two-roundings`` the
twice one).
``--xla-only`` runs the two xla engines alone (JAX's and the port's, as
shipped: the accepted alpha rounded once); with it ``--rounds R`` cuts
the schedule to its first R penalty rounds, ``--inner N`` replaces the
schedule by N steps in every round (JAX's benchmarks/problemsize.py
protocol, with ``--max-obstacles 16``, its config's default);
``--float64`` runs those two
engines in float64 on the same scenes and the same basis (the float32
export widened; JAX with x64 on and its explicit float32 constants read as
float64, the port's one-rounding helper as a float64 multiply-add), which
separates the semantics from the fp path (ROADMAP queue 3, fact 4).  It
does so by patching the process's globals (``jnp.float32``, the port's
``fma`` and ``robot.link_lengths``, torch's default dtype), so it runs
alone, in a process of its own, as this command does.
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
import carry_replica as rp  # noqa: E402


def _t(x):
    return torch.tensor(np.asarray(x))


CONTRACTED = rp.CONTRACTED


def contracted(keys):
    """The context in which the expressions ``keys`` of CONTRACTED are
    rounded once."""
    return rp.replica((), [pair for k in keys for pair in CONTRACTED[k]])


def xla_engines(a) -> int:
    """``--xla-only`` / ``--float64``: JAX's xla engine and the port's on
    the same scenes, in float32 as shipped or both in float64."""
    import jax

    cfg = bench.bench_config(solver=a.solver, n_timesteps=a.T,
                             ladder_eval=a.ladder_eval, inner=a.inner,
                             max_obstacles=a.max_obstacles)
    if a.rounds:
        cfg = cfg.replace(max_outer_iteration=a.rounds,
                          inner_schedule=cfg.inner_schedule
                          and cfg.inner_schedule[:a.rounds])
    jcfg = mp.PlannerConfig(
        n_timesteps=a.T, bls_mode="ladder", fixed_iters=True,
        inner_schedule=cfg.inner_schedule,
        max_outer_iteration=cfg.max_outer_iteration,
        max_inner_iteration=cfg.max_inner_iteration,
        max_obstacles=a.max_obstacles, ladder_eval=a.ladder_eval)
    jb = mp.make_basis(jcfg)
    tb = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(a.seed),
                               a.scenes, device="cpu")
    if a.float64:
        # The float32 basis and scenes widened, so both engines solve the
        # same problem; then every float32 constant of either engine is a
        # float64 one.
        jax.config.update("jax_enable_x64", True)
        jb = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jb)
        jnp.float32 = jnp.float64
        torch.set_default_dtype(torch.float64)
        tb = mt.Basis(*(x.double() for x in tb))
        scns = mt.Scenario(*(x.double() for x in scns))
        tfs.fma = lambda x, y, z: x * y + z
        tfleet.robot.link_lengths = lambda c, device=None: torch.tensor(
            c.link_length, dtype=torch.float64, device=device)
    names = ("JAX xla", "port xla")
    total, steps = np.zeros(2, dtype=int), np.zeros(2)
    for lo in range(0, a.scenes, a.chunk):
        sub = mt.Scenario(*(x[lo:lo + a.chunk] for x in scns))
        js = mp.Scenario(*(jnp.asarray(x.numpy()) for x in sub))
        runs = [jfleet.fleet_solve(jcfg, jb, js, solver=a.solver,
                                   backend="xla"),
                tfleet.fleet_solve(cfg, tb, sub, solver=a.solver,
                                   backend="xla")]
        if a.float64 and {str(r.alpha.dtype).split(".")[-1]
                          for r in runs} != {"float64"}:
            raise RuntimeError("--float64: an engine returned float32")
        counts = [int(np.asarray(r.stats.converged).sum()) for r in runs]
        total += counts
        steps += [float(np.asarray(r.stats.inner_iters).sum()) for r in runs]
        print(f"scenes {lo}-{lo + a.chunk - 1}: "
              + ", ".join(f"{n} {c}" for n, c in zip(names, counts)),
              flush=True)
    print(f"T={a.T} {a.solver} {a.ladder_eval}, "
          f"{'float64' if a.float64 else 'float32'}, "
          f"{cfg.max_outer_iteration} rounds, {a.scenes} scenes of seed "
          f"{a.seed}, converged (fraction; mean accepted steps): "
          + ", ".join(f"{n} {c} ({c / a.scenes:.4f}; {st / a.scenes:.2f})"
                      for n, c, st in zip(names, total, steps)))
    return 0


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
    ap.add_argument("--replica", default="")
    ap.add_argument("--endpoint", action="store_true")
    ap.add_argument("--xla-only", action="store_true")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--inner", type=int, default=None)
    ap.add_argument("--max-obstacles", type=int, default=11)
    ap.add_argument("--n-joints", type=int, default=3)
    a = ap.parse_args(argv)
    if a.n_joints != 3 and not a.port_only:
        ap.error("--n-joints goes with --port-only")
    if a.rounds and not (a.float64 or a.xla_only):
        ap.error("--rounds cuts the schedule of --xla-only or --float64 only")
    if (a.inner or a.max_obstacles != 11) and not (a.float64 or a.xla_only):
        ap.error("--inner and --max-obstacles go with --xla-only or --float64")
    if a.float64 or a.xla_only:
        return xla_engines(a)
    if a.solver == "gd" and a.tiers:
        ap.error("the kernel tiers are programs of BLS")
    cfg = bench.bench_config(solver=a.solver, n_timesteps=a.T,
                             ladder_eval=a.ladder_eval)
    if a.n_joints != 3:
        cfg = cfg.replace(n_joints=a.n_joints,
                          link_length=(3.0 / a.n_joints,) * a.n_joints)
    jcfg = mp.PlannerConfig(
        n_timesteps=a.T, bls_mode="ladder", fixed_iters=True,
        inner_schedule=cfg.inner_schedule,
        max_inner_iteration=cfg.max_inner_iteration, max_obstacles=11,
        ladder_eval=a.ladder_eval, recip_newton=True, pallas_block_b=a.chunk)
    jb = None if a.port_only else mp.make_basis(jcfg)
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
    try:
        replicas = [rp.parse(r) for r in a.replica.split("/")] \
            if a.replica else []
    except ValueError as e:
        ap.error(str(e))
    if replicas and (a.solver != "bls" or a.ladder_eval != "linearized"):
        ap.error("--replica replicates the linearized carry program (bls)")
    if a.endpoint:
        sets = ([("contract", k, contracted(k)) for k in [()] + contracts]
                + [("replica", k, rp.replica(k)) for k in replicas])
        for what, keys, ctx in sets:
            with ctx:
                r = bench.run_bench(batch=2, repeats=1, device="cpu")
            print(f"reference scene, {what} {'+'.join(keys) or 'none'}: "
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
                for k in contracts]
             + [f"port fused replica {'+'.join(r) or 'none'}"
                for r in replicas])
    total = np.zeros(len(names), dtype=int)
    same = np.zeros(len(names), dtype=int)
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
        for pieces in replicas:
            with rp.replica(pieces):
                runs.append(tfleet.fleet_solve(cfg, tb, sub, solver=a.solver,
                                               backend="fused"))
        flags = [np.asarray(r.stats.converged) for r in runs]
        counts = [int(f.sum()) for f in flags]
        total += counts
        if not a.port_only:
            same += [int((f == flags[0]).sum()) for f in flags]
        steps += [float(np.asarray(r.stats.inner_iters).sum()) for r in runs]
        costs += [len(sub.start) * bench.mean_obstacle_cost(
            cfg, tb, sub, tfleet.SolveResult(
                r.alpha if torch.is_tensor(r.alpha) else _t(r.alpha), None))
            for r in runs]
        print(f"scenes {lo}-{lo + a.chunk - 1}: "
              + ", ".join(f"{n} {c}" for n, c in zip(names, counts)),
              flush=True)
    what = "gd" if a.solver == "gd" else a.ladder_eval
    agree = ["" if a.port_only else f"; JAX fused's flag {sm / a.scenes:.4f}"
             for sm in same]
    print(f"T={a.T} J={a.n_joints} {what}, {a.scenes} scenes of seed "
          f"{a.seed}, "
          f"converged (fraction; mean accepted steps; mean obstacle cost"
          f"{'' if a.port_only else '; the share of flags equal to JAX fused'}"
          f"): "
          + ", ".join(f"{n} {c} ({c / a.scenes:.4f}; {st / a.scenes:.1f}; "
                      f"{co / a.scenes:.5f}{ag})"
                      for n, c, st, co, ag in zip(names, total, steps, costs,
                                                  agree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
