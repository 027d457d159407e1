"""Multi-process runtime: process-group launch and per-process shards
(counterpart of irm_motion_planning_tpu/parallel/distributed.py).

Each process calls :func:`initialize_distributed` once before it builds
its mesh, builds only its :func:`local_batch_slice` of the global scene
batch, places it on its devices (:func:`global_scenarios_from_local`: no
process ever holds the full batch) and runs the solvers of
:mod:`.sharded`; only the reduced fleet statistics cross processes, over
``torch.distributed`` (NCCL between cards, gloo on the CPU).

:func:`run_local_ranks` starts the ranks of a group on this host (with
:func:`free_port` for its coordinator): ``python -m
irm_motion_planning_tpu_torch.benchmarks.scaling --spawn N`` launches
through it, and so do ``tests/test_torch_distributed.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Optional

import torch

from ..device import resolve
from .mesh import Mesh, Sharded, _blocks, _leading, scenario_sharding

_COORD_ENV_VARS = ("COORDINATOR_ADDRESS",)


def _dist():
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    return dist


def _coordinator_from_env() -> Optional[str]:
    for var in _COORD_ENV_VARS:
        if os.environ.get(var):
            return os.environ[var]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def _rank_device(process_id: int, device=None) -> torch.device:
    """The device of a rank: ``device`` when it names one, else the card
    ``LOCAL_RANK`` (torchrun) or ``process_id`` modulo the visible cards."""
    dev = resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local % torch.cuda.device_count())


def duplicate_devices(ids) -> dict:
    """Of the ranks' device identities (one per rank, in rank order), those
    held by more than one rank: {identity: [ranks]}."""
    held = {}
    for rank, key in enumerate(ids):
        held.setdefault(key, []).append(rank)
    return {k: v for k, v in held.items() if len(v) > 1}


def _device_identity(dev: torch.device) -> str:
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else dev.index}"


def _check_one_rank_per_card(dist, dev: torch.device) -> None:
    """NCCL refuses two ranks on one GPU ("Duplicate GPU detected") at its
    first collective; find it here, over a gloo group, and raise."""
    gloo = dist.new_group(backend="gloo")
    ids = [None] * dist.get_world_size()
    dist.all_gather_object(ids, _device_identity(dev), group=gloo)
    dist.destroy_process_group(gloo)
    dup = duplicate_devices(ids)
    if dup:
        dist.destroy_process_group()
        raise RuntimeError(
            f"NCCL cannot run two ranks on one GPU: {dup} (device identity: "
            f"ranks); launch one rank per card, or pass backend='gloo' to "
            f"share a card")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
    force: bool = False,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Form the process group (``torch.distributed.init_process_group``
    with ``init_method="tcp://<coordinator_address>"``).

    Returns True when the group is (now or already) live.

    * Pass coordinator ``host:port``, ``num_processes`` and ``process_id``,
      or set ``COORDINATOR_ADDRESS`` (or torchrun's ``MASTER_ADDR`` and
      ``MASTER_PORT``) with ``WORLD_SIZE`` and ``RANK``; ``force=True``
      hands everything to ``init_method="env://"``.
    * ``backend``: ``"nccl"`` when the rank's device (``device``: the card
      by default: the card ``LOCAL_RANK`` or ``process_id`` picks) is a CUDA device, ``"gloo"`` on
      the CPU, unless named.  Under NCCL the rank's card is made current
      before the group forms, and two ranks on one card raise.
    * Multi-process intent is never dropped: a coordinator that cannot
      form the group raises once ``initialization_timeout`` seconds pass,
      and num_processes/process_id without a coordinator raise ValueError.
    * With nothing configured this is a no-op returning False (one
      process).
    """
    dist = _dist()
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = _coordinator_from_env()
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and not force:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "num_processes/process_id configured but no coordinator "
                "address; set COORDINATOR_ADDRESS (or MASTER_ADDR and "
                "MASTER_PORT), or pass coordinator_address= or force=True")
        return False
    if force:
        init_method, kw = "env://", {}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id (or WORLD_SIZE and RANK)")
        init_method = f"tcp://{coordinator_address}"
        kw = {"world_size": num_processes, "rank": process_id}
    dev = _rank_device(process_id or 0, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(backend=backend, init_method=init_method, **kw)
    if backend == "nccl":
        _check_one_rank_per_card(dist, dev)
    return True


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch: int, n_processes: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The slice of a global scene batch owned by this process.

    The global batch must divide evenly (pad with zero-weight scenes via
    ``mesh.pad_to_multiple`` otherwise)."""
    n = process_count() if n_processes is None else n_processes
    i = process_index() if index is None else index
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} must be a multiple of the process "
            f"count {n}"
        )
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def global_scenarios_from_local(mesh: Mesh, local) -> Sharded:
    """This process's shards of the global batch from its local slice (a
    leading-batch pytree: a Scenario, an alpha0, or a tuple of them): the
    slice split into one equal block per local device, each on its device,
    with its global offset.  No process holds the full batch, and no data
    crosses processes here."""
    n_local = _leading(local)
    if n_local % len(mesh.devices):
        raise ValueError(f"local batch {n_local} is not a multiple of the "
                         f"{len(mesh.devices)} local devices")
    first = scenario_sharding(mesh)[0] * (n_local // len(mesh.devices))
    return _blocks(mesh, local, first, len(mesh.devices),
                   n_local * mesh.world_size)


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now: a local group's
    coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_ranks(argvs, timeout: Optional[float] = None, env=None,
                    cwd=None) -> list:
    """Start one fresh process per argv (the ranks of one group on this
    host; never a fork of a process that holds a CUDA context), all at
    once, and wait for them.  When a rank fails, or ``timeout`` seconds
    pass, the ranks still running are killed, so no rank waits on a peer
    that is gone.  Each rank writes to temporary files (a pipe that nobody
    reads before the end would block it).  Returns (exit code, stdout,
    stderr) per rank; a killed rank's code is negative."""
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in argvs]
    procs = [subprocess.Popen(argv, stdout=out, stderr=err, env=env, cwd=cwd)
             for argv, (out, err) in zip(argvs, files, strict=True)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes) or (
                    deadline is not None and time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    ranks = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        ranks.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return ranks
