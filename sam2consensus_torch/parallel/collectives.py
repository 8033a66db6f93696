"""The collectives between the shards of a single-controller mesh.

The reference runs its sharded accumulators inside ``shard_map`` and moves
data between devices with XLA collectives (``lax.psum_scatter``,
``lax.psum``, ``lax.ppermute``).  Here one process holds a list of
per-shard tensors, in the mesh's flat order (``TorchMesh``: shard ``(d,
s)`` at ``d * sp + s``), and each collective is a loop of ``.to(target)``
and ``add_``: no copy at all between shards that share a device, and a
peer copy between cards.  Nothing reads a device value on the host, so a
collective never synchronises with it.

``axes`` names the mesh axes a collective runs over, in the order that
numbers its members, as in the reference: ``("dp", "sp")`` (``ALL``) is the
flattened ring; ``("sp", "dp")`` numbers a member ``s * dp + d``;
``("dp",)`` runs within each ``sp`` column.  The shards that share the
coordinates of the other axes form one group.

:func:`timing` measures the seconds each collective takes on the card with
CUDA events, for the chip's smoke run; off by default, and then free.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

#: both mesh axes flattened: every collective treats the mesh as one ring
ALL = ("dp", "sp")

_TIMING: Optional[Dict[str, list]] = None


def groups(mesh, axes: Sequence[str]) -> List[List[int]]:
    """The mesh's shards grouped for a collective over ``axes``: each
    group lists flat indices in member order (the flattened index over
    ``axes``, first axis slowest)."""
    axes = tuple(axes)
    other = [a for a in mesh.axis_names if a not in axes]
    out: Dict[tuple, list] = {}
    for i in range(mesh.size):
        c = dict(zip(mesh.axis_names, mesh.coords(i)))
        rank = 0
        for a in axes:
            rank = rank * mesh.shape[a] + c[a]
        out.setdefault(tuple(c[a] for a in other), []).append((rank, i))
    return [[i for _r, i in sorted(g)] for _k, g in sorted(out.items())]


@contextlib.contextmanager
def _timed(name: str, device: torch.device):
    if _TIMING is None or device.type != "cuda":
        yield
        return
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    try:
        yield
    finally:
        end.record(torch.cuda.current_stream(device))
        _TIMING.setdefault(name, []).append((start, end))


class Timing:
    """The collectives' seconds on the card, by name, from the CUDA events
    recorded while :func:`timing` was open (read after a synchronise)."""

    def __init__(self, events: Dict[str, list]):
        self._events = events

    def seconds(self) -> Dict[str, float]:
        for dev in range(torch.cuda.device_count()):
            torch.cuda.synchronize(dev)
        return {name: sum(s.elapsed_time(e) for s, e in pairs) / 1e3
                for name, pairs in self._events.items()}

    def counts(self) -> Dict[str, int]:
        return {name: len(pairs) for name, pairs in self._events.items()}


@contextlib.contextmanager
def timing():
    """Record each collective's CUDA events while open; yields a
    :class:`Timing`.  One at a time."""
    global _TIMING
    events: Dict[str, list] = {}
    _TIMING = events
    try:
        yield Timing(events)
    finally:
        _TIMING = None


def reduce_scatter(mesh, xs: Sequence[torch.Tensor],
                   axes: Sequence[str] = ALL,
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """``lax.psum_scatter(..., tiled=True)`` over ``axes``: the members of
    a group sum their tensors, and member ``j`` of ``g`` receives the
    ``j``-th of ``g`` equal pieces of the sum along dim 0, on its device.
    With ``out`` (one tensor a shard, of a piece's shape) the pieces are
    added into it in place and ``out`` is returned."""
    res: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in groups(mesh, axes):
        g = len(group)
        piece = xs[group[0]].shape[0] // g
        for j, dst in enumerate(group):
            dev = mesh.devices[dst]
            with _timed("reduce_scatter", dev):
                parts = [xs[m].narrow(0, j * piece, piece) for m in group]
                if out is None:
                    acc = parts[0].to(dev, copy=True)
                    parts = parts[1:]
                else:
                    acc = out[dst]
                for p in parts:
                    acc.add_(p.to(dev, non_blocking=True))
            res[dst] = acc
    return res


def all_reduce(mesh, xs: Sequence[torch.Tensor],
               axes: Sequence[str] = ALL) -> List[torch.Tensor]:
    """``lax.psum`` over ``axes``: every member of a group receives the
    sum of the group's tensors on its device.  The sum is made once, on
    the first member's device; members on that device share it (read
    it, do not write it)."""
    res: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in groups(mesh, axes):
        dev0 = mesh.devices[group[0]]
        with _timed("all_reduce", dev0):
            acc = xs[group[0]].to(dev0, copy=True)
            for m in group[1:]:
                acc.add_(xs[m].to(dev0, non_blocking=True))
        for m in group:
            res[m] = acc.to(mesh.devices[m], non_blocking=True)
    return res


def shift(mesh, xs: Sequence[torch.Tensor], axes: Sequence[str] = ALL,
          out: Optional[Sequence[torch.Tensor]] = None
          ) -> List[Optional[torch.Tensor]]:
    """The non-wrapping neighbour shift ``lax.ppermute(perm=[(i, i+1)])``
    over ``axes``: member ``i + 1`` of a group receives member ``i``'s
    tensor on its device; the first member receives nothing (None, the
    zeros of the reference's ppermute).  With ``out`` (one tensor a
    shard) the received tensor is added into the head of the member's
    ``out`` in place."""
    res: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in groups(mesh, axes):
        for src, dst in zip(group[:-1], group[1:]):
            dev = mesh.devices[dst]
            with _timed("shift", dev):
                res[dst] = xs[src].to(dev, non_blocking=True)
                if out is not None:
                    out[dst].narrow(0, 0, res[dst].shape[0]).add_(res[dst])
    return res
