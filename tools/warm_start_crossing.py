"""The sequential oracle's converged fraction with the warm starts and the
basis products crossed between the JAX package and the port.

    JAX_PLATFORMS=cpu python tools/warm_start_crossing.py [--scenes 128] \\
        [--oracle certify_oracle_cpu2048.npz] [--threads 1]

On the CPU, on the first ``--scenes`` scenes of JAX's stored CPU oracle
(certify.py's sequential BLS at the bench's schedule, T = 50, 11 obstacle
slots), each solver is started from each warm start:

* solvers: JAX's ``solvers/bls.py`` one scene per jit, as certify.py's
  oracle runs it; the port's BLS (``lanes.solve_lanes`` with
  ``bls.make_inner``) with the basis products in XLA's CPU order
  (``order="xla"``, ``bls.solve_batch``'s: the shipped oracle) and with
  one torch product each (``order="matmul"``, the products before);
* warm starts: JAX's jitted ``init_alpha``; the port's ``init_alpha``;
  ``torch.linalg.solve(km, line @ mix_inv)`` (LAPACK's solve, the port's
  warm start before).

Prints the table of converged fractions (rows the solvers, columns the
warm starts), each cell's per-scene agreement with the stored oracle's
converged flags, the share of each warm start's bits that equal JAX's, and
the rms error of the product ``kv @ alpha0`` against float64 under XLA's
CPU code, the port's XLA order and ``torch.matmul``; then one JSON line
with all of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import irm_motion_planning_tpu as mp  # noqa: E402
from irm_motion_planning_tpu.solvers import bls as jbls  # noqa: E402

import irm_motion_planning_tpu_torch as mt  # noqa: E402
from irm_motion_planning_tpu_torch.benchmarks import certify  # noqa: E402
from irm_motion_planning_tpu_torch.models import xla_order  # noqa: E402
from irm_motion_planning_tpu_torch.solvers import bls, lanes  # noqa: E402


def warm_starts(cfg, tcfg, jb, tb, data):
    """(name -> (B, T, J) float32 numpy) of the three warm starts."""
    start, goal = data["start"], data["goal"]
    init = jax.jit(lambda s, g: mp.init_alpha(cfg, jb, s, g))
    jax_a0 = np.stack([np.asarray(init(s, g)) for s, g in zip(start, goal)])
    ts, tg = torch.tensor(start), torch.tensor(goal)
    port_a0 = mt.init_alpha(tcfg, tb, ts, tg).numpy()
    line = ts[:, None, :] + (tg - ts)[:, None, :] * tb.c[:, None]
    lapack_a0 = torch.linalg.solve(tb.km, line @ tb.mix_inv).numpy()
    return {"jax": jax_a0, "port": port_a0, "lapack": lapack_a0}


def jax_converged(cfg, jb, data, a0) -> np.ndarray:
    solve = jax.jit(lambda s, a: jbls.solve(cfg, jb, s, a))
    conv = []
    for i in range(a0.shape[0]):
        scn = mp.Scenario(*(jnp.asarray(data[k][i])
                            for k in certify.SCENE_KEYS))
        conv.append(bool(solve(scn, jnp.asarray(a0[i])).stats.converged))
    return np.array(conv)


def port_converged(tcfg, tb, data, a0, order) -> np.ndarray:
    scns = certify.oracle_scenes(data, "cpu")
    res = lanes.solve_lanes(tcfg, tb, scns, torch.tensor(a0),
                            bls.make_inner, order)
    return res.stats.converged.numpy()


def product_rms(jb, tb, a0) -> dict:
    """rms of ``kv @ alpha0`` against float64 under each product."""
    kv = np.asarray(jb.kv)
    exact = np.einsum("ik,nkj->nij", kv.astype(np.float64),
                      a0.astype(np.float64))
    xla = jax.jit(lambda a: jnp.matmul(
        jb.kv, a, precision=jax.lax.Precision.HIGHEST))
    got = {
        "xla_cpu": np.stack([np.asarray(xla(a)) for a in a0]),
        "port_xla_order": xla_order.basis_product(
            tb.kv, torch.tensor(a0)).numpy(),
        "torch_matmul": (tb.kv @ torch.tensor(a0)).numpy(),
    }
    return {k: float(np.sqrt(((v - exact) ** 2).mean()))
            for k, v in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=128)
    ap.add_argument("--oracle",
                    default=os.path.join(ROOT, "certify_oracle_cpu2048.npz"))
    ap.add_argument("--threads", type=int, default=1,
                    help="torch threads (the port's results do not depend "
                         "on it)")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    full = np.load(args.oracle)
    n = args.scenes
    data = {k: full[k][:n] for k in certify.SCENE_KEYS}
    ref_conv = full["conv"][:n]
    mo, stopping = int(full["max_obstacles"]), str(full["stopping"])
    cfg = mp.PlannerConfig(bls_mode="sequential", max_obstacles=mo,
                           **certify.sched_kw(stopping))
    tcfg = certify.oracle_config(mo, stopping)
    jb = mp.make_basis(cfg)
    tb = mt.make_basis(tcfg, device="cpu")
    starts = warm_starts(cfg, tcfg, jb, tb, data)
    solvers = {
        "jax": lambda a0: jax_converged(cfg, jb, data, a0),
        "port_xla_order": lambda a0: port_converged(tcfg, tb, data, a0,
                                                    "xla"),
        "port_matmul": lambda a0: port_converged(tcfg, tb, data, a0,
                                                 "matmul"),
    }
    table, agree, seconds = {}, {}, {}
    for sname, run in solvers.items():
        for wname, a0 in starts.items():
            t0 = time.perf_counter()
            conv = run(a0)
            seconds[f"{sname}/{wname}"] = round(time.perf_counter() - t0, 1)
            table.setdefault(sname, {})[wname] = float(conv.mean())
            agree.setdefault(sname, {})[wname] = float(
                (conv == ref_conv).mean())
    bits = {w: float((a.view(np.int32) == starts["jax"].view(np.int32))
                     .mean()) for w, a in starts.items()}
    rms = {w: product_rms(jb, tb, a) for w, a in starts.items()}
    print(f"# {n} scenes of {os.path.basename(args.oracle)} (stored "
          f"converged {ref_conv.mean():.4f}); converged fraction "
          f"(agreement with the stored flags)")
    print(f"{'solver / warm start':<18}" + "".join(
        f"{w:>20}" for w in starts))
    for sname in solvers:
        print(f"{sname:<18}" + "".join(
            f"{table[sname][w]:>12.4f} ({agree[sname][w]:.3f})"
            for w in starts))
    print("bits equal to JAX's warm start: " + ", ".join(
        f"{w} {b:.4f}" for w, b in bits.items()))
    for w, r in rms.items():
        print(f"rms of kv @ alpha0 ({w}) against float64: " + ", ".join(
            f"{k} {v:.3g}" for k, v in r.items()))
    print(json.dumps({"scenes": n, "oracle_converged": float(ref_conv.mean()),
                      "converged": table, "agreement": agree,
                      "warm_start_bits_equal_jax": bits, "product_rms": rms,
                      "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
