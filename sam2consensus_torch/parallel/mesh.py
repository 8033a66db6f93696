"""The device mesh of a sharded run: a list of torch devices a process.

Port of ``sam2consensus_tpu/parallel/mesh.py``.  The workload has two
parallel dimensions: ``dp``, data parallelism over reads (each shard counts
its rows into a local tensor, and one reduction sums them exactly), and
``sp``, the genome's position axis split into blocks.  The mesh stays 2-D,
``(dp, sp)`` from :func:`factor_mesh`, with its devices in row-major order:
shard ``(d, s)`` is ``devices[d * sp + s]``.  A phase that uses one
dimension treats the flattened ``("dp", "sp")`` order as one ring.

Each process drives the shards of its own device list, which may name one
device more than once: shards that share a device are the port's
counterpart of the reference's virtual CPU devices (the tests pass
``["cpu"] * 8``; one card can carry ``["cuda:0"] * 4``).  Without a process
group, or in a world of one, the calling process drives every shard, as the
reference's ``shard_map`` drives ``jax.devices()`` on one controller.

**Process-spanning.**  When ``torch.distributed``'s default group is
initialised with a world above 1 (the reference's ``jax.process_count() >
1``), the mesh is multi-controller: every process runs the same program on
the same host values with its own local devices, and the global device list
is the ranks' lists end to end, so rank ``r`` of a world of local lists of
``m`` devices owns flat indices ``r * m .. r * m + m - 1`` (the order of
``jax.devices()``).  The caller initialises the group, as the reference's
``tools/multihost_dryrun.py`` initialises ``jax.distributed``.  A shard the
process does not own has ``None`` for its device; :attr:`TorchMesh.local`
lists the flat indices it does own.  The collectives between shards are
``parallel.collectives``, which cross the process boundary where a group's
members do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class MeshCapacityError(ValueError):
    """Copy: typed up-front rejection of an unplaceable mesh request
    (``--shards`` over the devices the mesh can draw on, or with the host
    pileup), raised before any input is read.  A ``ValueError``, so every
    reject-with-reason path (the CLI's exit, serve admission) handles it."""


def process_group() -> Tuple[int, int]:
    """``(world size, rank)`` of ``torch.distributed``'s default group;
    ``(1, 0)`` when none is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def available_devices(local_devices: Sequence) -> int:
    """The global device count a mesh can draw on: the process's own list
    times the world size (every process passes a list of the same
    length)."""
    return len(local_devices) * process_group()[0]


def agree(value):
    """``value`` as rank 0 holds it, on every rank of a process-spanning
    group (one ``broadcast_object_list``); itself otherwise.  A decision
    that reads the clock or a link probe goes through it, so every rank
    routes the same rows."""
    world, _rank = process_group()
    if world == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def validate_shards(shards: int, n_available: Optional[int] = None,
                    pileup: Optional[str] = None) -> None:
    """Reject impossible ``--shards`` requests up front, typed (the
    reference's checks and messages, ``torch.distributed`` named where it
    names ``jax.distributed``); ``n_available`` is the global device count
    (:func:`available_devices` of ``TorchBackend``'s ``mesh_devices``)."""
    if shards is None or shards <= 1:
        return
    if pileup == "host":
        raise MeshCapacityError(
            "--pileup host accumulates on the single host; it does "
            "not compose with --shards")
    if n_available is None:
        n_available = 1
    if shards > n_available:
        raise MeshCapacityError(
            f"--shards {shards} exceeds the {n_available} available "
            f"device(s): shrink --shards, or widen the mesh "
            f"(more hosts via torch.distributed, or "
            f"--xla_force_host_platform_device_count on CPU)")


def factor_mesh(n: int) -> Tuple[int, int]:
    """Copy: split ``n`` devices into (dp, sp), preferring a balanced 2-D
    mesh."""
    sp = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            sp = cand
            break
    return n // sp, sp


class TorchMesh:
    """A ``(dp, sp)`` mesh over a list of torch devices, row-major: shard
    ``(d, s)`` is ``devices[d * shape["sp"] + s]``.  ``axis_names``,
    ``shape`` and ``size`` read as the reference's ``jax.sharding.Mesh``.
    ``owners[i]`` is the rank that owns shard ``i`` (all ``rank`` on one
    process); a shard another rank owns has device ``None``."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: Sequence, dp: int, sp: int,
                 owners: Optional[Sequence[int]] = None, rank: int = 0):
        if dp * sp != len(devices):
            raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} devices, "
                             f"got {len(devices)}")
        self.devices: List[Optional[torch.device]] = [
            None if d is None else torch.device(d) for d in devices]
        self.shape = {"dp": dp, "sp": sp}
        self.size = dp * sp
        self.rank = rank
        self.owners = list(owners) if owners is not None \
            else [rank] * self.size
        #: the flat indices this process owns, ascending
        self.local = [i for i, o in enumerate(self.owners) if o == rank]
        #: the shards live in more than one process
        self.spans = len(set(self.owners)) > 1

    def coords(self, i: int) -> Tuple[int, int]:
        """``(d, s)`` of the shard at flat index ``i``."""
        return divmod(i, self.shape["sp"])

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[self.local[0]]

    @property
    def cuda_devices(self) -> List[torch.device]:
        """The distinct CUDA devices of this process's shards, in
        first-use order."""
        seen: List[torch.device] = []
        for i in self.local:
            d = self.devices[i]
            if d.type == "cuda" and d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        return (f"TorchMesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"owners={self.owners})")


def make_mesh(n_devices: Optional[int], devices: Sequence) -> TorchMesh:
    """The ``(dp, sp)`` mesh over the first ``n_devices`` of the global
    device list (all of them when None); more than it holds is a
    :class:`MeshCapacityError` (the reference's text).  ``devices`` is this
    process's list; over a process group the global list is the ranks'
    lists end to end (module docstring), and a mesh that leaves a rank
    without a shard is refused."""
    devices = list(devices)
    world, rank = process_group()
    per = len(devices)
    n_global = per * world
    n = n_global if n_devices is None else n_devices
    if n > n_global:
        raise MeshCapacityError(f"requested {n} devices, have {n_global}")
    dp, sp = factor_mesh(n)
    if world == 1:
        return TorchMesh(devices[:n], dp, sp)
    owners = [i // per for i in range(n)]
    if owners[-1] != world - 1:
        raise MeshCapacityError(
            f"a {n}-shard mesh over {world} processes of {per} device(s) "
            f"each leaves a process without a shard: ask for more than "
            f"{(world - 1) * per} shards")
    return TorchMesh([devices[i - rank * per] if o == rank else None
                      for i, o in enumerate(owners)], dp, sp, owners, rank)
