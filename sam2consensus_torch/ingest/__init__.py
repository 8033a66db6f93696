"""Sharded ingest: byte-range planning and the shared inflate pool.

Copy of ``sam2consensus_tpu/ingest/__init__.py`` (pinned by
``tests/test_torch_copies.py`` and ``tests/test_torch_parallel_decode.py``):

* :func:`plan_byte_shards` splits a record-oriented byte buffer into
  line-snapped ranges, so N decode workers
  (``encoder/parallel_decode.py``) own N disjoint ranges with no feed
  thread and no line straddling two workers.  A line belongs to the shard
  holding its first byte: an interior cut moves to one past the next
  newline at or after ``cut - 1``;
* :func:`shared_pool` is the process-wide inflate executor of the BGZF
  readers, sized by the run's ``--decode-threads``
  (``config.resolve_decode_threads``), the one thread budget shared by
  the shard workers, the BGZF stripes and the native vote.

The shard decoder's counters (``ingest_shards``, ``ingest_worker_sec``,
``ingest_fallback``, ``ingest_shard_retries``, ``ingest_demoted``,
``ingest_mode``) land in the run's ``stats.extra``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Tuple

#: default floor on shard size: below this, per-shard fixed costs
#: (encoder construction, thread spawn, final-slab padding) dominate and
#: the serial path is faster anyway
DEFAULT_MIN_SHARD_BYTES = 1 << 20


def snap_line_start(data, pos: int, start: int, end: int) -> int:
    """Advance ``pos`` to the nearest line start at or after it.

    ``data`` is any buffer with ``find`` (mmap, bytes).  The probe looks
    at ``pos - 1``: if that byte is a newline the cut already sits on a
    line start and stays; otherwise it moves one past the newline ending
    the line that holds ``pos``.  Returns ``end`` when no newline remains
    (the tail is one unterminated line of the previous shard).
    """
    if pos <= start:
        return start
    if pos >= end:
        return end
    nl = data.find(b"\n", pos - 1, end)
    return end if nl < 0 else nl + 1


def plan_byte_shards(data, start: int, end: int, n_shards: int,
                     min_bytes: int = DEFAULT_MIN_SHARD_BYTES
                     ) -> List[Tuple[int, int]]:
    """Line-snapped byte ranges ``[(lo, hi), ...]`` tiling
    ``data[start:end]`` exactly.

    At most ``n_shards`` ranges, each (before snapping) at least
    ``min_bytes`` long.  Ranges are disjoint, ordered and non-empty, and
    every line starts in exactly one range (a CRLF's ``\\r`` travels with
    its line, an unterminated tail belongs to the last range).  A range
    that snapping empties is dropped, so fewer ranges than asked for can
    come back, and none for an empty body.
    """
    size = end - start
    if size <= 0:
        return []
    n = max(1, min(int(n_shards), size // max(1, int(min_bytes)) or 1))
    bounds = _snap_bounds(data, start, end, n)
    ranges: List[Tuple[int, int]] = []
    prev = start
    for b in bounds[1:]:
        if b > prev:
            ranges.append((prev, b))
            prev = b
    return ranges


def _snap_bounds(data, start: int, end: int, n: int) -> List[int]:
    """All n+1 snapped boundaries, through the native one-pass snapper
    (``s2c_snap_shards``) when the decoder library loads; the Python loop
    below is its twin."""
    from .. import native

    lib = native.load()
    if lib is not None:
        import numpy as np

        buf = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        out = np.empty(n + 1, dtype=np.int64)
        lib.s2c_snap_shards(buf, start, end, n, out)
        return [int(b) for b in out]
    bounds = [start]
    for k in range(1, n):
        bounds.append(snap_line_start(data, start + (end - start) * k // n,
                                      start, end))
    bounds.append(end)
    return bounds


@dataclass
class ShardPlan:
    """A byte-sharded input: the backing buffer (an ``mmap`` of the file)
    and the line-snapped ranges the decode workers own; workers slice
    ``memoryview`` windows off it, zero-copy down to the C decoder."""

    data: object
    ranges: List[Tuple[int, int]] = field(default_factory=list)
    start: int = 0
    end: int = 0
    source: str = "mmap"

    @property
    def nbytes(self) -> int:
        return max(0, self.end - self.start)


_pool = None
_pool_workers = 0
_pool_lock = threading.Lock()


def shared_pool(threads: int):
    """The process-wide ingest executor, grown to at least ``threads``
    workers (never shrunk).  Returns None for ``threads <= 1``: serial
    callers stay poolless.  Only short tasks (BGZF stripe inflates)
    belong here."""
    global _pool, _pool_workers
    if threads <= 1:
        return None
    with _pool_lock:
        if _pool is None or _pool_workers < threads:
            from concurrent.futures import ThreadPoolExecutor

            old = _pool
            _pool = ThreadPoolExecutor(max_workers=int(threads),
                                       thread_name_prefix="s2c-ingest")
            _pool_workers = int(threads)
            if old is not None:
                # in-flight stripes finish on the old pool's threads;
                # new submissions land on the grown pool
                old.shutdown(wait=False)
        return _pool


def pool_submit(threads: int, fn, *args):
    """Submit a short task to the shared pool, safe against concurrent
    growth: a submit that lost the race to a pool retired by a larger
    budget retries on the current pool.  Callers must not cache the
    executor across submits."""
    while True:
        pool = shared_pool(threads)
        if pool is None:
            raise ValueError("pool_submit needs threads > 1")
        try:
            return pool.submit(fn, *args)
        except RuntimeError:
            # only a retired executor justifies a retry; if the refusing
            # pool is still the current one the error is real (e.g.
            # interpreter shutdown) and must propagate
            with _pool_lock:
                if _pool is pool:
                    raise
