"""Graceful-degradation ladder for the device path.

Port of ``sam2consensus_tpu/resilience/ladder.py``: ``pileup_level``,
``demote_pileup``, ``demote_tail``, ``demote_tail_and_record``,
``split_batch``, ``ResilientDispatcher`` and the serve runner's job-level
rung (``job_rungs``, ``job_host_rung_config``, ``record_job_demotion``,
copies pinned by ``tests/test_torch_copies.py``), bound to the port's
accumulators (``ops.pileup.PileupAccumulator`` and
``HostPileupAccumulator``), with the reference's counters, gauges and
trace events (``resilience/demotion``, ``resilience/emergency_checkpoint``,
``resilience/capacity_split`` with the memory plane's
``capacity_actuals``).

Accumulation rungs (top = fastest, bottom = most survivable)::

    device kernel (K1, --pileup pallas; the MXU route, --pileup mxu; the
    │              tuner of a PileupAccumulator(strategy="auto") or of dp's
    │              pileup="auto"; a sharded accumulator's kernel)
      └─> device scatter  (the same accumulator: strategy "scatter", no
            │              tuner, wire "packed5"; the port's --pileup
            │              scatter; a sharded one keeps its layout, pileup
            │              "scatter")
            └─> host pileup  (HostPileupAccumulator.set_counts of
                              counts_host(); no device at all)

Tail rungs::

    device fused tail  ──>  host tail (the native C++ vote when the
                            library loads, else the fused tail on
                            device="cpu"; HostPileupAccumulator with
                            ``tail_device = "cpu"``)

Demotion protocol (:class:`ResilientDispatcher`, the backend's tail loop),
as in the reference: the failing unit (one width bucket, or one half of
a capacity split) has made no committed contribution; the accumulator
demotes; only the failed unit replays on the demoted rung, from the
batch's host rows (its staged device operands belong to the failing
rung and are dropped); an emergency checkpoint is written once the whole
batch has landed.

Where the port differs from the reference, because CUDA differs:

* a *sticky* CUDA error (``policy.is_sticky``: an illegal address, a
  launch failure, ...) poisons the context: every later CUDA call fails,
  ``counts_host`` and the emergency checkpoint's fetch included.  The
  ladder then demotes nothing and raises :class:`DemotionFailed` once,
  with the original error as its cause; the last periodic checkpoint is
  what survives.  A demotion that itself raises (a ``counts_host`` that
  cannot fetch) ends the same way;
* CUDA errors are asynchronous: the port's accumulate loop does not
  synchronise with the host, so a real kernel fault surfaces at a later
  call (the tail's fetch at the latest), not in the unit that caused it.
  The per-unit exactness below holds for faults raised before the
  enqueue: injected faults, launch-configuration errors and
  out-of-memory in the caching allocator.

Exactness note (the reference's): retries and demotions are exact for
every injected fault and for failures where the dispatch never
committed.  A real device failure that lands mid-unit can double-count
that unit's committed part on replay; ``--paranoid``'s invariants detect
exactly that, and the emergency checkpoint keeps the blast radius to one
bucket.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np

from .. import observability as obs
from . import faultinject
from .policy import DATA, PASSTHROUGH, RetryPolicy, classify, is_sticky

#: smallest bucket-row count a capacity split will produce; below this
#: an OOM is not a batch-size problem and demotion is the answer
MIN_SPLIT_ROWS = 8


class DemotionFailed(RuntimeError):
    """The ladder could not step down: the failure was a sticky CUDA
    error (the context is lost, so no rung that touches the card can run
    and the counts cannot be fetched), or the demotion itself raised.
    ``__cause__`` is the failure that asked for the demotion."""


def _record_demotion(stage: str, frm: str, to: str, reason: str,
                     checkpointed: bool) -> None:
    reg = obs.metrics()
    reg.add("resilience/demotions", 1)
    reg.add(f"resilience/demotions/{stage}", 1)
    reg.gauge(f"resilience/ladder/{stage}").set_info(
        {"from": frm, "to": to, "reason": reason,
         "emergency_checkpoint": bool(checkpointed)})
    obs.tracer().event("resilience/demotion", stage=stage,
                       **{"from": frm, "to": to}, reason=reason,
                       emergency_checkpoint=bool(checkpointed))


def _cannot_demote(stage: str, frm: str, exc: BaseException,
                   why: Optional[BaseException] = None) -> DemotionFailed:
    """The one error a failed demotion raises (``raise ... from exc``)."""
    if why is None:
        msg = (f"{stage}: a sticky CUDA error left the context unusable on "
               f"rung {frm!r}; nothing can be demoted or fetched "
               f"({type(exc).__name__}: {exc})")
    else:
        msg = (f"{stage}: demotion from rung {frm!r} failed "
               f"({type(why).__name__}: {why}) after "
               f"{type(exc).__name__}: {exc}")
    return DemotionFailed(msg)


def job_rungs(snapshot: dict) -> dict:
    """The degradation rungs a finished run ENDED on, read back from its
    registry snapshot's ``resilience/ladder/<stage>`` gauges — the
    serve-mode per-job isolation surface (sam2consensus_torch/serve): a
    warm server asserts the job AFTER a faulting one returns ``{}``
    here, i.e. the previous job's demotions never leaked.  Keys are the
    stages that demoted (``pileup``, ``tail``), values the rung landed
    on; an empty dict means the run never left the fast path."""
    rungs = {}
    for stage in ("pileup", "tail"):
        g = snapshot.get("gauges", {}).get(f"resilience/ladder/{stage}")
        if g is not None and g.get("info"):
            rungs[stage] = g["info"].get("to", "")
    return rungs


def job_host_rung_config(cfg):
    """The JOB-level demotion: a whole-job re-run pinned to the
    ladder's bottom rung (host pileup, plain packed5 wire, single
    shard).  Used by the serve watchdog after a hang — a wedged
    dispatch says nothing about WHICH device stage wedged, so the only
    rung known to avoid it is the one that never touches the device
    path at all — and by admission control to keep a degraded tenant's
    jobs off the fleet's device path (serve/admission.py)."""
    import dataclasses

    return dataclasses.replace(cfg, pileup="host", wire="packed5",
                               shards=1, shard_mode="auto")


def record_job_demotion(registry, reason: str) -> None:
    """Mark a registry (a serve job's) as having run on the job-level
    host rung, in the same ``resilience/ladder/pileup`` gauge shape
    :func:`job_rungs` reads — so a watchdog-retried or tenant-pinned
    job shows ``rungs == {"pileup": "host"}`` exactly like an in-run
    ladder demotion would."""
    registry.add("resilience/demotions", 1)
    registry.add("resilience/demotions/job", 1)
    registry.gauge("resilience/ladder/pileup").set_info(
        {"from": "device", "to": "host", "reason": reason,
         "emergency_checkpoint": False, "job_level": True})


def pileup_level(acc) -> str:
    """Name the accumulation rung ``acc`` currently sits on (a sharded
    accumulator's, ``parallel/*``, by its ``pileup``): the reference's
    names, ``device_scatter`` only without a tuner."""
    from ..ops.pileup import HostPileupAccumulator

    if isinstance(acc, HostPileupAccumulator):
        return "host"
    strat = getattr(acc, _strategy_attr(acc))
    if strat == "scatter" and getattr(acc, "_tuner", None) is None:
        return "device_scatter"
    return f"device_{strat}"


def _strategy_attr(acc) -> str:
    """The attribute naming a device accumulator's count strategy: a
    sharded one's ``pileup``, else ``strategy``."""
    return "strategy" if hasattr(acc, "strategy") else "pileup"


def demote_pileup(acc, total_len: int) -> Tuple[Optional[object], str]:
    """One rung down; returns ``(new_acc, level)`` or ``(None, "")``
    when already on the bottom rung (host)."""
    from ..ops.pileup import HostPileupAccumulator

    if isinstance(acc, HostPileupAccumulator):
        return None, ""
    # rung 1: pin the kernel off, the tuner with it.  The wire codec pins
    # off too: a failure at the wire_encode / decode boundary must cost ONE
    # rung.  A sharded accumulator keeps its layout and drops its kernel
    # (its ``pileup``)
    attr = _strategy_attr(acc)
    if getattr(acc, attr) != "scatter" \
            or getattr(acc, "_tuner", None) is not None \
            or acc.wire != "packed5":
        setattr(acc, attr, "scatter")
        acc._tuner = None
        acc.wire = "packed5"
        return acc, "device_scatter"
    # rung 2: off the device (a sharded accumulator's blocks gathered);
    # the counts are sum-decomposable state, exact at any unit boundary
    host = HostPileupAccumulator(total_len)
    host.set_counts(np.asarray(acc.counts_host(), dtype=np.int32))
    # the pre-demotion transfers happened: they stay in the run's bill
    host.account = acc.account
    return host, "host"


def demote_tail(acc, total_len: int):
    """Demote the TAIL off the device: host-committed counts, with the
    tail placed on the host's CPU (``tail_device``).  Returns the
    (possibly new) accumulator."""
    from ..ops.pileup import HostPileupAccumulator

    if not isinstance(acc, HostPileupAccumulator):
        host = HostPileupAccumulator(total_len)
        host.set_counts(np.asarray(acc.counts_host(), dtype=np.int32))
        host.account = acc.account
        acc = host
    acc.invalidate_upload()            # drop any device upload
    acc.tail_device = "cpu"
    return acc


def demote_tail_and_record(acc, total_len: int, exc: BaseException,
                           checkpoint_cb: Optional[Callable] = None):
    """Tail demotion with the recovery story recorded: emergency
    checkpoint FIRST (the accumulate phase is complete, so the counts are
    a consistent boundary), then the host tail.  Returns the (possibly
    new) accumulator; the caller re-runs the tail with injection
    suppressed (the host rung is the ladder's bottom).  A sticky error,
    or a demotion that raises, ends in :class:`DemotionFailed`."""
    frm = "host" if getattr(acc, "tail_device", None) == "cpu" else "device"
    if is_sticky(exc):
        raise _cannot_demote("tail", frm, exc) from exc
    checkpointed = False
    try:
        if checkpoint_cb is not None:
            checkpoint_cb(acc)
            checkpointed = True
            obs.metrics().add("resilience/emergency_checkpoints", 1)
            obs.tracer().event("resilience/emergency_checkpoint",
                               stage="tail", level="host")
        acc = demote_tail(acc, total_len)
    except BaseException as why:
        raise _cannot_demote("tail", frm, exc, why) from exc
    _record_demotion("tail", "device", "host",
                     f"{type(exc).__name__}: {exc}", checkpointed)
    return acc


def split_batch(batch):
    """Split a SegmentBatch's buckets in half row-wise (capacity/OOM
    recovery: the halves dispatch as two smaller slabs).  Staged device
    operands are dropped: they belong to the failing dispatch, and each
    half is shipped again from its host rows.  Returns a list of 1-2
    batches (1 when nothing is splittable)."""
    from ..encoder.events import SegmentBatch

    halves = ({}, {})
    splittable = False
    for w, (starts, codes) in batch.buckets.items():
        n = len(starts)
        if n >= 2 * MIN_SPLIT_ROWS:
            mid = n // 2
            halves[0][w] = (starts[:mid], codes[:mid])
            halves[1][w] = (starts[mid:], codes[mid:])
            splittable = True
        else:
            halves[0][w] = (starts, codes)
    if not splittable:
        return [batch]
    return [SegmentBatch(buckets=h, n_reads=0, n_events=0)
            for h in halves if h]


class ResilientDispatcher:
    """The accumulate loop's failure contract, in one place.

    ``add(acc, batch)`` dispatches one batch under the retry policy and
    returns the accumulator to use from now on (the same object, or the
    demoted one).  ``checkpoint_cb(acc)`` (when given) persists an
    emergency checkpoint at each demotion boundary; ``on_demote(acc)``
    lets the backend rebind the prefetch staging to the new accumulator.

    The RETRY/REPLAY UNIT matches the COMMIT UNIT: a batch is dispatched
    as one single-bucket sub-batch per width, and a capacity split's
    halves are each their own unit.  With no fault the dispatcher adds
    nothing that touches the card: ``add`` of a unit is the
    accumulator's own ``add``.
    """

    def __init__(self, policy: RetryPolicy, total_len: int,
                 checkpoint_cb: Optional[Callable] = None,
                 on_demote: Optional[Callable] = None):
        self.policy = policy
        self.total_len = total_len
        self.checkpoint_cb = checkpoint_cb
        self.on_demote = on_demote
        self.demotions = 0             # ladder steps taken this run
        self._acc = None
        self._pending: list = []

    # -- one dispatch attempt ------------------------------------------
    def _attempt(self, unit) -> None:
        from ..ops.pileup import HostPileupAccumulator

        if not isinstance(self._acc, HostPileupAccumulator):
            # the host rung carries no injection sites: it IS the
            # bottom of the ladder.  job_hang sits on the same device
            # boundary but SLEEPS instead of raising (a wedged
            # dispatch, faultinject.py) — the serve watchdog's prey.
            faultinject.fault_check("job_hang")
            faultinject.fault_check("accumulate")
        self._acc.add(unit)

    def _dispatch_unit(self, unit, depth: int = 0) -> None:
        """Policy-run one unit; CAPACITY splits it and recurses on the
        halves (each its own unit), persistent failure demotes and
        replays THIS unit only."""

        def on_capacity(exc):
            if depth >= 4:
                raise exc              # splitting isn't helping: persist
            parts = split_batch(unit)
            if len(parts) == 1:
                raise exc              # nothing left to split
            reg = obs.metrics()
            reg.add("resilience/capacity_splits", 1)
            # the capacity model's prediction beside the tracked, process
            # and device residency when the rung fired
            from ..observability import memplane

            actuals = memplane.capacity_actuals(
                getattr(self._acc, "device", None))
            reg.gauge("resilience/capacity_split").set_info(
                {"depth": depth, "error": f"{type(exc).__name__}: {exc}",
                 **actuals})
            obs.tracer().event("resilience/capacity_split", depth=depth,
                               error=f"{type(exc).__name__}: {exc}",
                               **{k: v for k, v in actuals.items()
                                  if v is not None})
            for part in parts:
                self._dispatch_unit(part, depth + 1)

        while True:
            try:
                self.policy.run(lambda: self._attempt(unit),
                                site="pileup", on_capacity=on_capacity)
                return
            except BaseException as exc:
                kind = classify(exc)
                if kind in (PASSTHROUGH, DATA) \
                        or self.policy.on_error != "fallback":
                    raise
                frm = pileup_level(self._acc)
                if is_sticky(exc):
                    raise _cannot_demote("pileup", frm, exc) from exc
                try:
                    new_acc, level = demote_pileup(self._acc,
                                                   self.total_len)
                except BaseException as why:
                    raise _cannot_demote("pileup", frm, exc, why) from exc
                if new_acc is None:
                    raise              # bottom rung already: truly fatal
                self._acc = new_acc
                if self.on_demote is not None:
                    self.on_demote(new_acc)
                self._pending.append((frm, level, exc))
                # replay ONLY this unit on the demoted rung, from its
                # host rows (the staged operands were for the old rung)
                unit.staged.clear()

    def _units(self, batch) -> list:
        """One single-bucket sub-batch per width, the commit unit of
        every accumulator's ``add`` (staged operands follow their
        bucket; the first unit carries the batch's read count).
        Fused, empty and single-bucket batches pass through whole."""
        from ..encoder.events import SegmentBatch

        if batch.accumulated or len(batch.buckets) <= 1:
            return [batch]
        units = []
        for w in sorted(batch.buckets):
            staged = {w: batch.staged[w]} if w in batch.staged else {}
            units.append(SegmentBatch(buckets={w: batch.buckets[w]},
                                      staged=staged,
                                      n_reads=0 if units else batch.n_reads))
        return units

    # -- public entry ---------------------------------------------------
    def add(self, acc, batch):
        """Dispatch ``batch``; returns the accumulator for the NEXT
        batch (demoted when the ladder stepped down).

        A failing replay after a demotion continues DOWN the ladder
        (kernel -> scatter -> host) until a rung absorbs the unit or the
        bottom rung itself fails.  The emergency checkpoint is written
        once per batch, after every unit has landed (the backend decodes
        serially whenever checkpointing is on, so the stream never reads
        ahead of the consumer).
        """
        self._acc = acc
        self._pending = []
        t0 = time.perf_counter()
        for unit in self._units(batch):
            self._dispatch_unit(unit)
        acc = self._acc
        if self._pending:
            self.demotions += len(self._pending)
            checkpointed = False
            if self.checkpoint_cb is not None:
                self.checkpoint_cb(acc)
                checkpointed = True
                obs.metrics().add("resilience/emergency_checkpoints", 1)
                obs.tracer().event("resilience/emergency_checkpoint",
                                   stage="pileup",
                                   level=self._pending[-1][1])
            for frm, level, exc in self._pending:
                _record_demotion("pileup", frm, level,
                                 f"{type(exc).__name__}: {exc}",
                                 checkpointed)
            obs.metrics().observe("resilience/demotion_sec",
                                  time.perf_counter() - t0)
        return acc
