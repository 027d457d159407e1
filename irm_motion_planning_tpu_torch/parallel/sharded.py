"""Sharded solvers: scene-axis parallelism over a mesh (counterpart of
irm_motion_planning_tpu/parallel/sharded.py).

The solve needs no communication (scenes are independent): each local
shard is solved on its own device by the same solver a single process
runs, so a shard's result equals that solver run on the shard alone, bit
for bit.  Only the fleet statistics cross shards and processes: sums and a
max in float32, reduced over the process's shards and then with
``all_reduce`` over the group, equal on every rank.

* :func:`make_sharded_solver` — the ``vmap`` engine
  (solvers/batched.solve_batch) on each shard.
* :func:`make_shard_map_solver` — ``engine="vmap"`` or ``engine="fleet"``
  (solvers/fleet.fleet_solve on ``backend``: the kernels on the card,
  their plain versions on the CPU), with the global statistics.

Shards run one after another on the host.  The fused backend without lane
compaction launches K1 once per shard with no host synchronisation, so
shards on several cards of one process overlap; the other drivers wait on
the host between launches, so their shards run in turn.
"""

from __future__ import annotations

import torch

from ..config import PlannerConfig
from ..models.rkhs import Basis
from ..solvers.batched import solve_batch
from .mesh import Mesh, Sharded, replicated, tree_map

STATS_KEYS = ("n_total", "converged_fraction", "mean_inner_iters",
              "mean_final_cost", "max_final_cost")


def _per_shard(mesh: Mesh, basis: Basis, solve):
    """``Sharded`` scenes -> the ``Sharded`` results of ``solve(basis,
    scenes)`` per shard."""
    bases = replicated(mesh, basis)

    def run(scenarios: Sharded) -> Sharded:
        parts = tuple(solve(b, s) for b, s in
                      zip(bases, scenarios.parts, strict=True))
        return Sharded(parts, scenarios.offsets, scenarios.total)

    return run


def make_sharded_solver(cfg: PlannerConfig, basis: Basis, mesh: Mesh,
                        solver: str = "bls"):
    """The batched single-scene solver on each shard: ``Sharded`` scenes
    (:func:`mesh.shard_batch`, ``distributed.global_scenarios_from_local``)
    -> ``Sharded`` SolveResults, each on its shard's device."""
    return _per_shard(mesh, basis, lambda b, s: solve_batch(
        cfg, b, s, solver=solver))


def _stats_device(mesh: Mesh) -> torch.device:
    """Where the statistics are reduced: the rank's card under NCCL, the
    CPU under gloo, the first local device in one process."""
    if mesh.group is None:
        return mesh.devices[0]
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fleet_stats(mesh: Mesh, results) -> dict:
    """The global fleet statistics of the local shards' SolveResults, in
    float32: per shard the sums (lanes, converged, inner iterations, final
    cost) and the max final cost; summed and maxed over the process's
    shards, then ``all_reduce`` (SUM, MAX) over the group.  Equal on every
    rank."""
    dev = _stats_device(mesh)
    n_local = sum(res.stats.converged.shape[0] for res in results)
    sums = torch.tensor([float(n_local), 0.0, 0.0, 0.0], dtype=torch.float32,
                        device=dev)
    peak = torch.full((1,), -float("inf"), dtype=torch.float32, device=dev)
    for res in results:
        st = res.stats
        part = torch.stack((st.converged.to(torch.float32).sum(),
                            st.inner_iters.to(torch.float32).sum(),
                            st.final_cost.to(torch.float32).sum()))
        sums[1:] += part.to(dev)
        peak = torch.maximum(peak, st.final_cost.to(torch.float32).max()
                             .reshape(1).to(dev))
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=mesh.group)
    n = sums[0]
    return {
        "n_total": n,
        "converged_fraction": sums[1] / n,
        "mean_inner_iters": sums[2] / n,
        "mean_final_cost": sums[3] / n,
        "max_final_cost": peak[0],
    }


def make_shard_map_solver(cfg: PlannerConfig, basis: Basis, mesh: Mesh,
                          solver: str = "bls", engine: str = "vmap",
                          backend: str = "xla"):
    """Each local shard solved on its device, then the global fleet
    statistics (:func:`fleet_stats`).  ``engine="fleet"`` runs
    ``fleet_solve`` on ``backend`` (``"fused"``: K1, or K2 per round with
    ``cfg.lane_compaction``; ``"pallas"``: the per-step kernels; ``"xla"``:
    the plain engine); the shard's device decides whether the kernels or
    their plain versions run.

    Returns ``Sharded scenes -> (Sharded SolveResults, stats dict)``."""
    if engine == "fleet":
        from ..solvers.fleet import fleet_solve

        def solve(b, s):
            return fleet_solve(cfg, b, s, solver=solver, backend=backend)
    elif engine == "vmap":
        def solve(b, s):
            return solve_batch(cfg, b, s, solver=solver)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    per_shard = _per_shard(mesh, basis, solve)

    def run(scenarios: Sharded):
        res = per_shard(scenarios)
        return res, fleet_stats(mesh, res.parts)

    return run


def concat(parts):
    """Pytrees of tensors (SolveResults, Scenarios) with one leading batch
    axis, concatenated along it in order."""
    first = parts[0]
    if torch.is_tensor(first):
        return torch.cat(parts)
    return type(first)(*(concat([p[i] for p in parts])
                         for i in range(len(first))))


def gather_local(sharded: Sharded, device=None):
    """This process's shards concatenated in global order, each moved to
    ``device`` first when given (shards on several devices need one)."""
    parts = sharded.parts
    if device is not None:
        parts = [tree_map(lambda x: x.to(device), p) for p in parts]
    return concat(parts)
