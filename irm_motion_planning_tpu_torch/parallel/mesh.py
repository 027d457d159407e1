"""Device mesh and sharding helpers (counterpart of
irm_motion_planning_tpu/parallel/mesh.py).

Scenes are independent, so the mesh has one data axis, ``"scenario"``,
over every shard of every process: a process holds its own devices in
order, and global shard ``rank * len(devices) + i`` lives on its device
``i`` (the order of JAX's ``NamedSharding(P("scenario"))`` over a mesh
whose devices are listed process by process).  PyTorch has no global
array: a sharded batch is this process's blocks, each on its device, with
each block's global offset (:class:`Sharded`).  The solve needs no
communication; only the fleet statistics cross processes (sharded.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..device import resolve

SCENARIO_AXIS = "scenario"


class Mesh(NamedTuple):
    """``devices``: this process's devices, in order; ``group``: the
    process group (None for one process); ``rank`` and ``world_size`` of
    this process in it."""

    devices: tuple
    group: object
    rank: int
    world_size: int

    @property
    def axis_names(self) -> tuple:
        return (SCENARIO_AXIS,)

    @property
    def size(self) -> int:
        """The number of shards over every process."""
        return self.world_size * len(self.devices)


class Sharded(NamedTuple):
    """This process's blocks of a batch sharded over the scenario axis:
    ``parts`` one pytree per local device (on it), ``offsets`` the global
    index of each block's first scene, ``total`` the global batch."""

    parts: tuple
    offsets: tuple
    total: int


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over this process's ``devices``; by default every CUDA
    device of the process, or in a process group the rank's own card (the
    one ``initialize_distributed`` made current).  Raises without a CUDA
    device unless devices are given (``devices=["cpu"] * n`` for n CPU
    shards)."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if devices is None:
        resolve()
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if live else [torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count())])
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if live:
        return Mesh(devices, dist.group.WORLD, dist.get_rank(),
                    dist.get_world_size())
    return Mesh(devices, None, 0, 1)


def tree_map(fn, tree):
    """``fn`` on every tensor of a pytree of tensors, NamedTuples and
    tuples; None stays None."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, x) for x in tree)
    raise TypeError(f"not a pytree of tensors: {type(tree).__name__}")


def _leading(tree) -> int:
    sizes = set()
    tree_map(lambda x: sizes.add(x.shape[0]), tree)
    if len(sizes) != 1:
        raise ValueError(f"leading batch sizes differ: {sorted(sizes)}")
    return sizes.pop()


def scenario_sharding(mesh: Mesh) -> tuple:
    """The global shard index of each local device: of a batch split into
    ``mesh.size`` equal blocks, block ``k`` lives on this process's device
    ``k - rank * len(devices)``."""
    n = len(mesh.devices)
    return tuple(mesh.rank * n + i for i in range(n))


def replicated(mesh: Mesh, tree) -> tuple:
    """A copy of ``tree`` (the Basis) on each local device."""
    return tuple(tree_map(lambda x, d=d: x.to(d), tree) for d in mesh.devices)


def _blocks(mesh: Mesh, tree, first: int, n_blocks: int, total: int):
    per = _leading(tree) // n_blocks
    parts = tuple(
        tree_map(lambda x, i=i, d=d: x[i * per:(i + 1) * per].to(d), tree)
        for i, d in enumerate(mesh.devices))
    return Sharded(parts, tuple(first + i * per
                                for i in range(len(mesh.devices))), total)


def shard_batch(mesh: Mesh, tree) -> Sharded:
    """Split a global leading-batch pytree (a Scenario, an alpha0, or a
    tuple of them) into ``mesh.size`` equal contiguous blocks and place
    this process's blocks on its devices.  Raises for a batch that does not
    divide (pad with zero-weight scenes: :func:`pad_to_multiple`)."""
    total = _leading(tree)
    if total % mesh.size:
        raise ValueError(f"batch {total} is not a multiple of the mesh's "
                         f"{mesh.size} shards")
    sub = scenario_sharding(mesh)[0] * (total // mesh.size)
    local = tree_map(
        lambda x: x[sub:sub + total // mesh.world_size], tree)
    return _blocks(mesh, local, sub, len(mesh.devices), total)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
