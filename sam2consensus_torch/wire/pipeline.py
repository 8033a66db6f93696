"""Two staging slots around an accumulator's ``stage``, with the overlap
of staging and consumption measured.

Copy of ``StageSlots`` and ``intersect_sec`` from
``sam2consensus_tpu/wire/pipeline.py`` (pinned by
``tests/test_torch_copies.py``).  The decode prefetch thread
(``backends.torch_backend._Prefetcher``) stages each batch through
:meth:`StageSlots.run`: on CUDA that is ``PileupAccumulator.stage``, which
copies the batch's rows into a pinned slot and issues their host-to-device
copy on a side stream.  At most ``slots`` batches are staged and not yet
consumed: past that the producer blocks (backpressure), so staging never
runs unboundedly ahead of the consumer.

Overlap is measured, not assumed: the stager logs every staging interval,
the consumer every consume interval, and :meth:`StageSlots.overlap_sec`
reports their intersection (a serialized pipeline reports about 0; a
healthy one reports ``stage_sec`` about equal to ``overlap_sec``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Tuple

#: staging slots: slab N consuming + slab N+1 in flight
DEFAULT_SLOTS = 2


def intersect_sec(a: List[Tuple[float, float]],
                  b: List[Tuple[float, float]]) -> float:
    """Total overlap between two interval lists (merge sweep), as
    :meth:`StageSlots.overlap_sec` takes it (stage ∩ dispatch)."""
    a = sorted(a)
    b = sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


class StageSlots:
    """Two staging slots around an accumulator's ``stage``.

    Producer side (the decode prefetch thread) calls :meth:`acquire`,
    which blocks while every slot holds a staged, unconsumed batch
    (backpressure), then :meth:`run`, which stages the batch and, on a
    failure, releases the batch's slot and re-raises (the port's
    prefetcher then re-raises the error on the consumer; no batch goes on
    unstaged).  Consumer side calls :meth:`consumed` after dispatching
    each batch (releasing its slot) and :meth:`note_consume` with the
    dispatch interval.
    """

    def __init__(self, stage_fn: Callable, slots: int = DEFAULT_SLOTS):
        self.stage_fn = stage_fn
        self.slots = slots
        self._sem = threading.Semaphore(slots)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._held: set = set()
        self._stage_iv: List[Tuple[float, float]] = []
        self._consume_iv: List[Tuple[float, float]] = []
        self.backpressure_sec = 0.0

    # -- producer side (prefetch thread) --------------------------------
    def acquire(self, batch) -> bool:
        """Claim a staging slot for ``batch``, blocking under
        backpressure.  Split from :meth:`run` so that ``stage_sec``
        excludes the wait: backpressure is the consumer's dispatch time,
        already billed there.
        False = the consumer closed the slots."""
        t_wait = time.perf_counter()
        while not self._stop.is_set():
            if self._sem.acquire(timeout=0.05):
                self.backpressure_sec += time.perf_counter() - t_wait
                with self._lock:
                    self._held.add(id(batch))
                return True
        return False                    # consumer gone; drop staging

    def run(self, batch) -> None:
        """Stage an acquired batch.  A failure releases the batch's slot
        here and re-raises."""
        t0 = time.perf_counter()
        try:
            self.stage_fn(batch)
        except BaseException:
            self._release(batch)
            raise
        finally:
            with self._lock:
                self._stage_iv.append((t0, time.perf_counter()))

    def stage(self, batch) -> None:
        """acquire + run in one call (unit tests / simple callers)."""
        if self.acquire(batch):
            self.run(batch)

    # -- consumer side ---------------------------------------------------
    def consumed(self, batch) -> None:
        self._release(batch)

    def note_consume(self, t0: float, t1: float) -> None:
        with self._lock:
            self._consume_iv.append((t0, t1))

    def _release(self, batch) -> None:
        with self._lock:
            if id(batch) in self._held:
                self._held.discard(id(batch))
                self._sem.release()

    def close(self) -> None:
        """Unblock any backpressured producer (consumer exited)."""
        self._stop.set()

    # -- accounting ------------------------------------------------------
    def stage_sec(self) -> float:
        with self._lock:
            return sum(t1 - t0 for t0, t1 in self._stage_iv)

    def overlap_sec(self) -> float:
        """Exact seconds the staging thread's transfer work co-ran with
        the consumer's accumulate dispatches."""
        with self._lock:
            return intersect_sec(list(self._stage_iv),
                                 list(self._consume_iv))
