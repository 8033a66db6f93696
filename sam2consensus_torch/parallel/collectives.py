"""The collectives between the shards of a mesh.

The reference runs its sharded accumulators inside ``shard_map`` and moves
data between devices with XLA collectives (``lax.psum_scatter``,
``lax.psum``, ``lax.ppermute``).  Here a process holds a list of per-shard
tensors, in the mesh's flat order (``TorchMesh``: shard ``(d, s)`` at ``d *
sp + s``; ``None`` where another process owns the shard), and each
collective first combines the members this process holds with a loop of
``.to(target)`` and ``add_``: no copy at all between shards that share a
device, and a peer copy between cards.  Nothing reads a device value on the
host, so a collective within one process never synchronises with it.

**Across processes.**  Where a group's members span ranks of the
process-spanning mesh (``TorchMesh.spans``), each rank then makes one
process-group call for all such groups of the collective:
``reduce_scatter_tensor`` (every rank's partial sums, laid out so that the
chunk a rank receives holds its own members' pieces), ``all_reduce`` or one
``batch_isend_irecv`` for the shift.  Every rank computes the same groups,
so every rank makes the same calls.  Under NCCL the CUDA tensors go to the
call as they are; under any other backend (gloo) a CUDA operand is staged
through page-locked host memory with one blocking copy a collective (the
one host synchronisation a staged collective makes), and the results go
back ``non_blocking``.

``axes`` names the mesh axes a collective runs over, in the order that
numbers its members, as in the reference: ``("dp", "sp")`` (``ALL``) is the
flattened ring; ``("sp", "dp")`` numbers a member ``s * dp + d``;
``("dp",)`` runs within each ``sp`` column.  The shards that share the
coordinates of the other axes form one group.

:func:`timing` measures the seconds each collective takes on the card with
CUDA events, and counts the staged ones, for the chip's smoke run; off by
default, and then free.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

#: both mesh axes flattened: every collective treats the mesh as one ring
ALL = ("dp", "sp")

_TIMING: Optional[Dict[str, list]] = None
_STAGED: Optional[Dict[str, int]] = None


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
    recorded while :func:`timing` was open (read after a synchronise), and
    ``staged``: the collectives that staged a CUDA operand through host
    memory (one host synchronisation each), by name."""

    def __init__(self, events: Dict[str, list], staged: Dict[str, int]):
        self._events = events
        self.staged = staged

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
    global _TIMING, _STAGED
    events: Dict[str, list] = {}
    staged: Dict[str, int] = {}
    _TIMING, _STAGED = events, staged
    try:
        yield Timing(events, staged)
    finally:
        _TIMING = _STAGED = None


# -- across processes ----------------------------------------------------------
def _spanning(mesh, groups_: List[List[int]]) -> List[List[int]]:
    """The groups whose members more than one rank owns."""
    if not mesh.spans:
        return []
    return [g for g in groups_ if len({mesh.owners[m] for m in g}) > 1]


def _mine(mesh, group: Sequence[int]) -> bool:
    return all(mesh.owners[m] == mesh.rank for m in group)


def _any_local(xs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    return next(x for x in xs if x is not None)


def _staged(dev: torch.device) -> bool:
    """A CUDA operand crosses a group other than NCCL's through
    page-locked host memory."""
    import torch.distributed as dist

    return dev.type == "cuda" and dist.get_backend() != "nccl"


def _stage(name: str, buf: torch.Tensor) -> torch.Tensor:
    """``buf`` as the process group takes it: under staging, a page-locked
    host copy made with one blocking copy (counted under ``name``)."""
    if not _staged(buf.device):
        return buf
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf)
    if _STAGED is not None:
        _STAGED[name] = _STAGED.get(name, 0) + 1
    return host


def _landing(shape, like: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Where a process-group call's results land: page-locked host memory
    under staging (so they go back ``non_blocking``), else ``dev``."""
    if _staged(dev):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=dev)


def _cross_reduce_scatter(mesh, xs, cross, out, res) -> None:
    """The spanning groups of :func:`reduce_scatter`: one
    ``reduce_scatter_tensor`` over the default group.  Rank ``k``'s chunk
    lists the pieces of every spanning group that its members receive
    (padded with zero pieces to the longest chunk); each rank fills every
    chunk with its own members' partial sums."""
    import torch.distributed as dist

    world = dist.get_world_size()
    ref = _any_local(xs)
    chunks: List[list] = [[] for _ in range(world)]
    for gi, g in enumerate(cross):
        for j, m in enumerate(g):
            chunks[mesh.owners[m]].append((gi, j))
    width = max(len(c) for c in chunks)
    piece = ref.shape[0] // len(cross[0])
    dev = mesh.first_device
    buf = torch.zeros((world * width * piece,) + tuple(ref.shape[1:]),
                      dtype=ref.dtype, device=dev)
    with _timed("reduce_scatter", dev):
        for k, chunk in enumerate(chunks):
            for t, (gi, j) in enumerate(chunk):
                slot = buf.narrow(0, (k * width + t) * piece, piece)
                for m in cross[gi]:
                    if mesh.owners[m] == mesh.rank:
                        slot.add_(xs[m].narrow(0, j * piece, piece).to(
                            dev, non_blocking=True))
        src = _stage("reduce_scatter", buf)
        got = _landing((width * piece,) + tuple(ref.shape[1:]), ref, dev)
        fn = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        fn(got, src)
        for t, (gi, j) in enumerate(chunks[mesh.rank]):
            dst = cross[gi][j]
            part = got.narrow(0, t * piece, piece).to(mesh.devices[dst],
                                                     non_blocking=True)
            if out is None:
                res[dst] = part
            else:
                out[dst].add_(part)
                res[dst] = out[dst]


def _cross_all_reduce(mesh, xs, cross, res) -> None:
    """The spanning groups of :func:`all_reduce`: one ``all_reduce`` of
    every spanning group's partial sum, stacked."""
    import torch.distributed as dist

    ref = _any_local(xs)
    dev = mesh.first_device
    buf = torch.zeros((len(cross),) + tuple(ref.shape), dtype=ref.dtype,
                      device=dev)
    with _timed("all_reduce", dev):
        for gi, g in enumerate(cross):
            for m in g:
                if mesh.owners[m] == mesh.rank:
                    buf[gi].add_(xs[m].to(dev, non_blocking=True))
        src = _stage("all_reduce", buf)
        dist.all_reduce(src)
        for gi, g in enumerate(cross):
            total = None
            for m in g:
                if mesh.owners[m] == mesh.rank:
                    if total is None:
                        total = src[gi].to(dev, non_blocking=True)
                    res[m] = total.to(mesh.devices[m], non_blocking=True)


def _cross_shift(mesh, xs, pairs, out, res) -> None:
    """The cross-rank pairs of :func:`shift`: one ``batch_isend_irecv``;
    a pair's message is tagged with the receiving shard's flat index."""
    import torch.distributed as dist

    sends = [(s, d) for s, d in pairs if mesh.owners[s] == mesh.rank]
    recvs = [(s, d) for s, d in pairs if mesh.owners[d] == mesh.rank]
    if not sends and not recvs:
        return
    ref = _any_local(xs)
    dev = mesh.first_device
    with _timed("shift", dev):
        ops = []
        if sends:
            src = _stage("shift", torch.stack(
                [xs[s].to(dev, non_blocking=True) for s, _d in sends]))
            ops += [dist.P2POp(dist.isend, src[k], mesh.owners[d], tag=d)
                    for k, (_s, d) in enumerate(sends)]
        if recvs:
            got = _landing((len(recvs),) + tuple(ref.shape), ref, dev)
            ops += [dist.P2POp(dist.irecv, got[k], mesh.owners[s], tag=d)
                    for k, (s, d) in enumerate(recvs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for k, (_s, d) in enumerate(recvs):
            res[d] = got[k].to(mesh.devices[d], non_blocking=True)
            if out is not None:
                out[d].narrow(0, 0, res[d].shape[0]).add_(res[d])


def all_gather(mesh, xs: Sequence[Optional[torch.Tensor]],
               order: Sequence[int]) -> List[torch.Tensor]:
    """Every shard of ``order``'s tensor on this rank's host, in that
    order, over a process-spanning mesh: each rank's own shards fetched
    with one copy (the one host synchronisation this collective makes),
    then one ``all_gather_into_tensor`` (its NCCL branch gathers on the
    card and fetches the result).  The shards' tensors share one shape."""
    import torch.distributed as dist

    mine = [i for i in order if mesh.owners[i] == mesh.rank]
    world = dist.get_world_size()
    per_rank = [[i for i in order if mesh.owners[i] == k]
                for k in range(world)]
    width = max(len(p) for p in per_rank)
    ref = xs[mine[0]]
    dev = mesh.first_device
    nccl = dist.get_backend() == "nccl"
    buf = torch.zeros((width,) + tuple(ref.shape), dtype=ref.dtype,
                      device=dev if nccl else "cpu")
    with _timed("all_gather", dev):
        local = torch.stack([xs[i].to(dev, non_blocking=True)
                             for i in mine])
        if not nccl and dev.type == "cuda" and _STAGED is not None:
            _STAGED["all_gather"] = _STAGED.get("all_gather", 0) + 1
        buf[: len(mine)] = local.to(buf.device)
        got = torch.empty((world * width,) + tuple(ref.shape),
                          dtype=ref.dtype, device=buf.device)
        fn = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        fn(got, buf)
        got = got.cpu()
    where = {i: k * width + t for k, p in enumerate(per_rank)
             for t, i in enumerate(p)}
    return [got[where[i]] for i in order]


def reduce_scatter(mesh, xs: Sequence[torch.Tensor],
                   axes: Sequence[str] = ALL,
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """``lax.psum_scatter(..., tiled=True)`` over ``axes``: the members of
    a group sum their tensors, and member ``j`` of ``g`` receives the
    ``j``-th of ``g`` equal pieces of the sum along dim 0, on its device.
    With ``out`` (one tensor a shard, of a piece's shape) the pieces are
    added into it in place and ``out`` is returned.  Members another rank
    owns get ``None``."""
    res: List[Optional[torch.Tensor]] = [None] * mesh.size
    all_groups = groups(mesh, axes)
    cross = _spanning(mesh, all_groups)
    if cross:
        _cross_reduce_scatter(mesh, xs, cross, out, res)
    for group in all_groups:
        if not _mine(mesh, group):
            continue
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
    it, do not write it).  Members another rank owns get ``None``."""
    res: List[Optional[torch.Tensor]] = [None] * mesh.size
    all_groups = groups(mesh, axes)
    cross = _spanning(mesh, all_groups)
    if cross:
        _cross_all_reduce(mesh, xs, cross, res)
    for group in all_groups:
        if not _mine(mesh, group):
            continue
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
    cross = []
    for group in groups(mesh, axes):
        for src, dst in zip(group[:-1], group[1:]):
            if mesh.owners[src] != mesh.owners[dst]:
                cross.append((src, dst))
                continue
            if mesh.owners[dst] != mesh.rank:
                continue
            dev = mesh.devices[dst]
            with _timed("shift", dev):
                res[dst] = xs[src].to(dev, non_blocking=True)
                if out is not None:
                    out[dst].narrow(0, 0, res[dst].shape[0]).add_(res[dst])
    if cross:
        _cross_shift(mesh, xs, cross, out, res)
    return res
