"""The device mesh of a sharded run: one process, a list of torch devices.

Port of ``sam2consensus_tpu/parallel/mesh.py``.  The workload has two
parallel dimensions: ``dp``, data parallelism over reads (each shard counts
its rows into a local tensor, and one reduction sums them exactly), and
``sp``, the genome's position axis split into blocks.  The mesh stays 2-D,
``(dp, sp)`` from :func:`factor_mesh`, with its devices in row-major order:
shard ``(d, s)`` is ``devices[d * sp + s]``.  A phase that uses one
dimension treats the flattened ``("dp", "sp")`` order as one ring.

The mesh is single-controller: the calling process drives every shard, as
the reference's ``shard_map`` drives ``jax.devices()``.  Its devices are an
explicit list, which may name one device more than once: shards that share
a device are the port's counterpart of the reference's virtual CPU devices
(the tests pass ``["cpu"] * 8``; one card can carry ``["cuda:0"] * 4``).
The collectives between shards are ``parallel.collectives``.
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


def validate_shards(shards: int, n_available: Optional[int] = None,
                    pileup: Optional[str] = None) -> None:
    """Reject impossible ``--shards`` requests up front, typed (the
    reference's checks and messages); ``n_available`` is the length of
    the run's device list (``TorchBackend``'s ``mesh_devices``)."""
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
            f"(more hosts via jax.distributed, or "
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
    ``shape`` and ``size`` read as the reference's ``jax.sharding.Mesh``."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: Sequence, dp: int, sp: int):
        if dp * sp != len(devices):
            raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} devices, "
                             f"got {len(devices)}")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.shape = {"dp": dp, "sp": sp}
        self.size = dp * sp

    def coords(self, i: int) -> Tuple[int, int]:
        """``(d, s)`` of the shard at flat index ``i``."""
        return divmod(i, self.shape["sp"])

    @property
    def cuda_devices(self) -> List[torch.device]:
        """The distinct CUDA devices of the mesh, in first-use order."""
        seen: List[torch.device] = []
        for d in self.devices:
            if d.type == "cuda" and d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        return (f"TorchMesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int], devices: Sequence) -> TorchMesh:
    """The ``(dp, sp)`` mesh over the first ``n_devices`` of ``devices``
    (all of them when None); more than the list holds is a
    :class:`MeshCapacityError` (the reference's text)."""
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise MeshCapacityError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    dp, sp = factor_mesh(len(devices))
    return TorchMesh(devices, dp, sp)
