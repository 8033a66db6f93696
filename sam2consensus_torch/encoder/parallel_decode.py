"""Sharded multi-core ingest: byte-range workers own the decode.

Copy of ``sam2consensus_tpu/encoder/parallel_decode.py``
(``ParallelFusedDecoder``, held equal to it by
``tests/test_torch_parallel_decode.py``), with its fault-injection site
(``ingest_decode_shard``, per fused shard attempt) and its run-wide
tolerant-decode sink, and its trace spans and registry counters
(``decode_shard`` / ``decode_worker`` spans on threads named
``decode-shard-<i>`` / ``decode-worker-<i>``, ``ingest/*`` and
``decode/worker_sec``, the ``ingest/mode`` gauge); the workers bind the
run's instruments (``observability.bind_run_to_thread``).  The same
counters also land in :attr:`ParallelFusedDecoder.counters`, which the
backend copies into ``stats.extra``.  One difference: in slab mode the last
worker to end puts an end marker on the hand-off queue, so the consumer
stops at once instead of at its next 0.1 s poll.

* the input is split once into record-aligned byte ranges
  (``ingest.plan_byte_shards``: mmap and line-boundary snapping, so every
  SAM line starts in exactly one shard);
* each worker owns a shard: it slices zero-copy ``memoryview`` windows
  off the map and runs the native decoder over them with the GIL
  released: no queue, no feed thread, no shared mutable state;
* counts land in per-worker partitions (the fused decoder's private
  uint8 shadow and int32 bank, ``NativeReadEncoder(private_counts=True)``)
  and merge into the run's one int32 tensor through ``s2c_merge_u8``,
  lock-serialised, only once that worker's shard succeeded;
* error parity with the serial path is structural: shards are disjoint
  and ordered, so the earliest shard's error is the earliest-offset
  error, and within a shard the worker's sequential decode meets its
  first error first.  Workers past a failed shard stop at their next
  window (the serial path would not have read further); workers before
  it run on, so that an earlier error still wins.  Decode errors (the
  replayed Python exception types) re-raise as they are, and so does a
  blown bad-record budget (a DATA-class error: a property of the input);
  anything else retries the shard once on a fresh encoder and then demotes
  the whole ingest to the serial rung (a fresh pass over the input against
  zeroed counts), counted as ``ingest_demoted``;
* tolerant decode: one run-wide sink shared by every worker encoder,
  partition-keyed (shard index on the shard rung, block index on the
  streaming rung), cleared whole on a shard retry and reset whole on a
  demotion, so its merged entries are stream order on every rung.

Two output modes share the machinery:

* **fused** (``counts`` given, the host-counts pileup): batches are
  counters-only; each worker holds its batches until its shard commits,
  so a retry or a demotion never counts twice, and the coordinator yields
  them all after the merge;
* **slab** (``counts=None``, the device pileup): workers emit row slabs
  into a bounded hand-off queue as they fill, and the consumer (the
  backend's prefetch thread, which stages them to the card) takes them
  while later shards are still decoding.  Addition commutes, so the order
  of batches across shards does not change the counts.

Inputs that cannot be byte-sharded (gzip streams, BGZF text, in-memory
handles) take the streaming rung, :meth:`ParallelFusedDecoder.encode_blocks`,
counted as ``ingest_fallback``.
"""

from __future__ import annotations

import mmap
import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np

from .. import observability as obs
from ..ingest import DEFAULT_MIN_SHARD_BYTES, ShardPlan, snap_line_start
from ..ingest.badrecords import is_data_error
from ..resilience.faultinject import fault_check
from .events import EncodeError, GenomeLayout, InsertionEvents, SegmentBatch
from .native_encoder import NativeReadEncoder, fused_direct_mode

#: decode-semantics exceptions (the replayed Python parser and encoder
#: errors, whose type and message equal the serial path's); everything
#: else is infrastructure and takes the retry / demote path
PARITY_ERRORS = (EncodeError, KeyError, IndexError, ValueError,
                 OverflowError, UnicodeDecodeError)

#: feed granularity inside a shard: line-snapped windows this size bound
#: how late a worker sees an earlier shard's failure
SHARD_BLOCK_BYTES = 1 << 23


class ParallelFusedDecoder:
    """Same surface as ``NativeReadEncoder`` for the backend's accumulate
    loop (``insertions``, ``n_reads``, ``n_skipped``, ``counts_fused``,
    ``encode_blocks``), plus the shard scheduler (``encode_input``,
    ``encode_shards``).  ``counts=None`` selects slab mode."""

    _DONE = object()

    #: the per-worker count partitions may take this much extra memory in
    #: all; on huge genomes the worker count is clamped to fit
    EXTRA_COUNTS_BUDGET = 512 << 20

    def __init__(self, layout: GenomeLayout,
                 counts: Optional[np.ndarray], n_threads: int,
                 maxdel: Optional[int] = 150,
                 strict: bool = True, on_lines=None, on_bytes=None,
                 segment_width: int = 0, bad_sink=None):
        self._segment_width = segment_width
        #: tolerant decode (--on-bad-record): ONE run-wide sink shared by
        #: every worker encoder.  Shard workers record into partition
        #: ``(shard_idx,)`` (cleared whole on a shard retry, reset whole
        #: on an ingest demotion), streaming workers re-key per block
        #: index; the sink's sorted-partition merge is stream order.
        self.bad_sink = bad_sink
        self.layout = layout
        self._counts = counts
        self.maxdel = maxdel
        self.strict = strict
        self._direct = False
        self._merge_lock = threading.Lock()
        if counts is None:
            self.n_threads = max(1, n_threads)
        else:
            # per extra worker: a uint8 shadow and an int32 bank (1.25x
            # the count tensor), or in direct mode (huge genomes) one
            # private int32 partition
            self._direct = fused_direct_mode(layout.total_len)
            if self._direct:
                extra_each = max(1, counts.nbytes)
            else:
                extra_each = max(1, (counts.nbytes * 5) // 4)
            cap = 1 + self.EXTRA_COUNTS_BUDGET // extra_each
            self.n_threads = max(1, min(n_threads, cap))
        #: fused mode: counting rides the workers' decode passes (batches
        #: are counters-only), so the backend runs no prefetch thread
        self.counts_fused = counts is not None
        self.insertions = InsertionEvents()
        self.n_reads = 0
        self.n_skipped = 0
        self._on_lines = on_lines
        self._on_bytes = on_bytes
        self._counter_lock = threading.Lock()
        #: the scheduler's counters (``stats.extra`` keys): shards decoded,
        #: summed worker wall seconds, inputs that took the streaming
        #: rung, shard retries, whole-ingest demotions, and the rung
        self.counters = {"ingest_shards": 0, "ingest_worker_sec": 0.0,
                         "ingest_fallback": 0, "ingest_shard_retries": 0,
                         "ingest_demoted": 0, "ingest_mode": {}}

    def _count(self, key: str, value) -> None:
        with self._counter_lock:
            self.counters[key] += value

    # ------------------------------------------------------------------
    def _private_for(self, idx: int) -> bool:
        """Shard-worker count-partition policy.  Shadow mode: every
        worker is private and merges its partition at its own stream end
        under the merge lock.  Direct mode (huge genomes): a private
        partition is a full int32 tensor, so worker 0 writes the shared
        tensor in place (its retry scrubs it) and the others fold after
        the join."""
        if self._counts is None:
            return False
        return not self._direct or idx > 0

    def _mk_encoder(self, st: dict, private: bool,
                    partition=(0,)) -> NativeReadEncoder:
        """A fresh worker encoder counting lines and bytes into ``st``."""

        def _tally(key):
            def cb(k):
                st[key] += k
            return cb

        return NativeReadEncoder(
            self.layout, maxdel=self.maxdel, strict=self.strict,
            accumulate_into=self._counts,
            on_lines=_tally("lines"), on_bytes=_tally("bytes"),
            segment_width=self._segment_width,
            private_counts=private and self._counts is not None,
            bad_sink=self.bad_sink, bad_partition=partition)

    def _finish(self, encoders: List[NativeReadEncoder],
                n_lines: int, n_bytes: int) -> None:
        """Commit the workers' results: counts merge (one writer at a
        time), insertion stores concatenate (grouping sorts by site key,
        so their order does not matter), counters total."""
        for enc in encoders:
            enc.merge_shadow()          # no-op for non-private/direct
            self.insertions.extend(enc.insertions)
            self.n_reads += enc.n_reads
            self.n_skipped += enc.n_skipped
        if self._on_lines is not None and n_lines:
            self._on_lines(n_lines)
        if self._on_bytes is not None and n_bytes:
            self._on_bytes(n_bytes)

    # -- rung selection ----------------------------------------------------
    def encode_input(self, stream,
                     min_shard_bytes: int = DEFAULT_MIN_SHARD_BYTES
                     ) -> Iterator[SegmentBatch]:
        """Decode ``stream`` (``io.sam.ReadStream``) on the best rung: byte
        shards when the input mmaps (plain files), else the streaming rung
        with ``ingest_fallback`` counted."""
        plan = None
        if self.n_threads > 1:
            plan = stream.shard_plan(self.n_threads,
                                     min_bytes=min_shard_bytes)
        if plan is not None and plan.ranges:
            return self.encode_shards(plan)
        reg = obs.metrics()
        if self.n_threads > 1:
            self._count("ingest_fallback", 1)
            reg.add("ingest/fallback", 1)
        self.counters["ingest_mode"] = {
            "rung": "stream", "threads": self.n_threads,
            "input": type(stream.handle).__name__,
            "fused": self.counts_fused}
        reg.gauge("ingest/mode").set_info(dict(self.counters["ingest_mode"]))
        return self.encode_blocks(stream.blocks(), stream=stream)

    # -- shard rung --------------------------------------------------------
    def encode_shards(self, plan: ShardPlan) -> Iterator[SegmentBatch]:
        """Decode a byte-sharded input (the ownership, merge and error
        protocol of the module docstring)."""
        ranges = list(plan.ranges)
        nw = min(self.n_threads, len(ranges))
        self.counters["ingest_mode"] = {
            "rung": "shards", "threads": nw, "shards": len(ranges),
            "bytes": plan.nbytes, "fused": self.counts_fused}
        self._count("ingest_shards", len(ranges))
        reg = obs.metrics()
        reg.gauge("ingest/mode").set_info(dict(self.counters["ingest_mode"]))
        reg.add("ingest/shards", len(ranges))
        if self.counts_fused:
            return self._run_shards_fused(plan, ranges, nw)
        return self._run_shards_slab(plan, ranges, nw)

    @staticmethod
    def _shard_blocks(data, lo: int, hi: int, shard_idx: int,
                      horizon: List[int], enc: NativeReadEncoder):
        """Zero-copy line-snapped windows of one shard.  Between windows
        the worker checks the error horizon: once a shard earlier than
        this one failed, nothing from here on can matter (the serial
        stream would have stopped there).  ``enc.block_base`` takes each
        window's absolute file offset before the yield, so a strict error
        carries the offset the serial rung would report."""
        try:
            # one readahead hint per shard: the map's pages would
            # otherwise fault one by one on this worker's thread
            lo_pg = lo & ~(mmap.PAGESIZE - 1)
            data.madvise(mmap.MADV_WILLNEED, lo_pg, hi - lo_pg)
        except (AttributeError, ValueError, OSError):
            pass
        pos = lo
        view = memoryview(data)
        while pos < hi:
            if horizon[0] < shard_idx:
                return
            end = snap_line_start(data, min(pos + SHARD_BLOCK_BYTES, hi),
                                  lo, hi)
            if end <= pos:      # one line longer than the window
                end = hi
            enc.block_base = pos
            yield view[pos:end]
            pos = end

    def _shard_work(self, st: dict, data, horizon: List[int],
                    hlock: threading.Lock, emit) -> None:
        """One worker: decode the owned shard in the C core.

        ``emit(batch)`` is the slab rung's queue put (fused mode holds the
        batches instead).  A decode error records ``(shard_idx, exc)`` and
        moves the horizon; any other failure retries once on a fresh
        encoder (the failed attempt's private partitions and held batches
        are dropped whole, so nothing counts twice) and then flags the
        shard for demotion."""
        shard_idx, (lo, hi) = st["idx"], st["range"]
        tr = obs.tracer()
        reg = obs.metrics()
        tr.name_thread(f"decode-shard-{shard_idx}")
        t0 = time.perf_counter()
        attempts = 0
        while True:
            attempts += 1
            held: List[SegmentBatch] = []
            st["lines"] = st["bytes"] = 0
            # attempt 1 uses the encoder the coordinator built; retries
            # build a fresh one
            enc = st.pop("enc0", None)
            try:
                if enc is None:
                    # inside the try: a retry's allocation failure is an
                    # infrastructure fault and takes the same protocol
                    enc = self._mk_encoder(st, self._private_for(shard_idx),
                                           partition=(shard_idx,))
                if self.counts_fused:
                    fault_check("ingest_decode_shard")
                for batch in enc.encode_blocks(
                        self._shard_blocks(data, lo, hi, shard_idx,
                                           horizon, enc)):
                    if self.counts_fused:
                        # counters-only: held until the shard commits
                        held.append(batch)
                    elif not emit(batch):
                        break           # consumer gone
                if self.counts_fused and not self._direct:
                    # shadow mode: fold this worker's partition now,
                    # lock-serialised, overlapping slower workers' decode.
                    # A later shard's demotion zeroes the shared tensor,
                    # so an early merge is never a corruption hazard.
                    with self._merge_lock:
                        enc.merge_shadow()
                st["enc"] = enc
                st["held"] = held
                break
            except PARITY_ERRORS as exc:
                st["error"] = (shard_idx, exc)
                with hlock:
                    horizon[0] = min(horizon[0], shard_idx)
                break
            except Exception as exc:
                if is_data_error(exc):
                    # the run's bad-record budget blew on this worker's
                    # records: a property of the input, never retried,
                    # never demoted (the serial rung would fail alike)
                    st["error"] = (shard_idx, exc)
                    with hlock:
                        horizon[0] = min(horizon[0], shard_idx)
                    break
                # infrastructure fault (an injected ingest_decode_shard,
                # MemoryError, an OS error, ...): retry the shard once on
                # a fresh encoder, then leave the decision to the
                # coordinator
                if (shard_idx == 0 and self._direct
                        and self._counts is not None):
                    # direct-mode worker 0 writes the shared tensor in
                    # place: scrub its partial contribution first
                    with self._merge_lock:
                        self._counts[:] = 0
                if attempts >= 2 or not self.counts_fused:
                    st["fault"] = exc
                    with hlock:
                        horizon[0] = min(horizon[0], shard_idx)
                    break
                if self.bad_sink is not None:
                    # the failed attempt's quarantine partition rolls back
                    # whole with its count partition: the fresh attempt
                    # records again, so nothing counts twice
                    self.bad_sink.clear_partition((shard_idx,))
                self._count("ingest_shard_retries", 1)
                reg.add("ingest/shard_retries", 1)
                tr.event("ingest/shard_retry", shard=shard_idx,
                         error=f"{type(exc).__name__}: {exc}")
        dt = time.perf_counter() - t0
        self._count("ingest_worker_sec", dt)
        tr.complete("decode_shard", t0, shard=shard_idx,
                    lines=st["lines"], bytes=st["bytes"])
        reg.add("decode/worker_sec", dt)
        reg.add("ingest/worker_sec", dt)

    def _spawn_shards(self, ranges, nw: int, data, emit, on_exit=None):
        """Start ``nw`` workers over the shards (a claim queue absorbs
        snap-size imbalance); returns ``(states, threads)``.  ``on_exit()``
        runs on each worker thread as it ends."""
        horizon = [len(ranges)]
        hlock = threading.Lock()
        states = [{"idx": i, "range": r, "lines": 0, "bytes": 0,
                   "enc": None, "held": [], "error": None, "fault": None}
                  for i, r in enumerate(ranges)]
        for st in states:
            # attempt-1 encoders built here, before any worker runs: their
            # allocations would otherwise contend for the GIL with the
            # other workers right at the start of the parallel phase
            st["enc0"] = self._mk_encoder(st, self._private_for(st["idx"]),
                                          partition=(st["idx"],))
        claims: "queue.Queue" = queue.Queue()
        for st in states:
            claims.put(st)
        run = obs.current_run()

        def runner():
            try:
                with obs.bind_run_to_thread(run):
                    while True:
                        try:
                            st = claims.get_nowait()
                        except queue.Empty:
                            return
                        self._shard_work(st, data, horizon, hlock, emit)
            finally:
                if on_exit is not None:
                    on_exit()

        threads = [threading.Thread(target=runner, daemon=True,
                                    name=f"decode-worker-{w}")
                   for w in range(nw)]
        for t in threads:
            t.start()
        return states, threads

    @staticmethod
    def _first_failure(states):
        """The stream-order-first failure ``(idx, kind, exc)``, or None.
        Shards are disjoint and ordered, so the smallest shard index is
        the earliest offset whichever worker met it."""
        failures = []
        for st in states:
            if st["error"] is not None:
                failures.append((st["error"][0], "error", st["error"][1]))
            if st["fault"] is not None:
                failures.append((st["idx"], "fault", st["fault"]))
        if not failures:
            return None
        failures.sort(key=lambda f: f[0])
        return failures[0]

    def _run_shards_fused(self, plan: ShardPlan, ranges, nw: int
                          ) -> Iterator[SegmentBatch]:
        states, threads = self._spawn_shards(ranges, nw, plan.data,
                                             emit=None)
        for t in threads:
            t.join()
        first = self._first_failure(states)
        if first is not None and first[1] == "error":
            # a decode error earlier than any fault: the serial path
            # would have raised it before reaching the faulted region
            raise first[2]
        if first is not None:
            # demotion: the serial rung over the whole input against
            # zeroed counts; nothing was yielded yet, so the fresh pass
            # is exactly the serial path
            self._count("ingest_demoted", 1)
            obs.metrics().add("ingest/demoted", 1)
            obs.tracer().event(
                "ingest/demoted",
                error=f"{type(first[2]).__name__}: {first[2]}")
            self._counts[:] = 0
            if self.bad_sink is not None:
                # the whole input replays on the serial rung: every shard
                # partition rolls back, so the fresh pass's records
                # (partition (0,)) are the only ones counted
                self.bad_sink.reset()
            st = {"lines": 0, "bytes": 0}
            enc = self._mk_encoder(st, private=False)
            enc.block_base = plan.start
            view = memoryview(plan.data)
            for batch in enc.encode_blocks(
                    iter([view[plan.start:plan.end]])):
                yield batch
            self._finish([enc], st["lines"], st["bytes"])
            return
        self._finish([st["enc"] for st in states],
                     sum(st["lines"] for st in states),
                     sum(st["bytes"] for st in states))
        for st in states:
            for batch in st["held"]:
                yield batch

    def _run_shards_slab(self, plan: ShardPlan, ranges, nw: int
                         ) -> Iterator[SegmentBatch]:
        out_q: "queue.Queue" = queue.Queue(maxsize=2 * nw)
        stop = threading.Event()

        def emit(batch) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(batch, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        running = [nw]
        lock = threading.Lock()

        def on_exit() -> None:
            # the last worker to end says so on the queue, so the consumer
            # learns it at once rather than at its next poll
            with lock:
                running[0] -= 1
                last = running[0] == 0
            if last:
                emit(self._DONE)

        states, threads = self._spawn_shards(ranges, nw, plan.data, emit,
                                             on_exit)

        def alive() -> bool:
            return any(t.is_alive() for t in threads)

        try:
            while True:
                try:
                    batch = out_q.get(timeout=0.1)
                except queue.Empty:
                    if not alive():
                        break
                    continue
                if batch is self._DONE:
                    break
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join()
        # drain anything emitted between the last get and the joins
        while True:
            try:
                batch = out_q.get_nowait()
            except queue.Empty:
                break
            if batch is not self._DONE:
                yield batch
        first = self._first_failure(states)
        if first is not None:
            # slab mode has no retry rung: emitted slabs may already be
            # counted on the device, so a clean replay is impossible
            raise first[2]
        self._finish([st["enc"] for st in states],
                     sum(st["lines"] for st in states),
                     sum(st["bytes"] for st in states))

    # -- streaming rung ----------------------------------------------------
    def encode_blocks(self, blocks, stream=None) -> Iterator[SegmentBatch]:
        """The queue-feed rung for inputs that cannot be byte-sharded: the
        stream's line-aligned blocks go round-robin into bounded
        per-worker queues; each worker takes its blocks in order, so the
        smallest failing block index is the stream's first bad line.
        Feeding stops at the first failure seen (the serial path would
        not have read further).  ``stream`` (when given) supplies each
        block's input offset (``ReadStream.block_offset``)."""
        workers: List[dict] = []
        for w in range(self.n_threads):
            st = {"idx": w, "q": queue.Queue(maxsize=2), "batches": [],
                  "error": None, "fault": None, "lines": 0, "bytes": 0,
                  "enc": None}
            st["enc"] = self._mk_encoder(st, private=w > 0)
            workers.append(st)

        def any_error() -> bool:
            return any(st["error"] is not None or st["fault"] is not None
                       for st in workers)

        run = obs.current_run()
        threads = [threading.Thread(target=self._stream_work,
                                    args=(st, run), daemon=True,
                                    name=f"decode-worker-{st['idx']}")
                   for st in workers]
        for t in threads:
            t.start()

        def tolerant_put(st, thread, item) -> bool:
            """Bounded put that gives up if the worker died."""
            while thread.is_alive():
                try:
                    st["q"].put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for idx, block in enumerate(blocks):
                if any_error():
                    break                 # serial parity: stop reading
                off = getattr(stream, "block_offset", None) \
                    if stream is not None else None
                w = idx % self.n_threads
                tolerant_put(workers[w], threads[w], (idx, block, off))
                # drain finished batches as they come, so the consumer's
                # stats tick while decoding continues
                for st in workers:
                    while st["batches"]:
                        yield st["batches"].pop(0)
        finally:
            for st, t in zip(workers, threads):
                tolerant_put(st, t, self._DONE)
            for t in threads:
                t.join()

        # error parity: smallest failing block index == first bad line
        errors = [st["error"] for st in workers if st["error"] is not None]
        if errors:
            errors.sort(key=lambda e: (e[0] is None, e[0]))
            raise errors[0][1]
        faults = [st["fault"] for st in workers if st["fault"] is not None]
        if faults:
            raise faults[0]

        self._finish([st["enc"] for st in workers],
                     sum(st["lines"] for st in workers),
                     sum(st["bytes"] for st in workers))
        for st in workers:
            for batch in st["batches"]:
                yield batch

    def _stream_work(self, st: dict, run) -> None:
        with obs.bind_run_to_thread(run):
            self._stream_decode(st)

    def _stream_decode(self, st: dict) -> None:
        enc: NativeReadEncoder = st["enc"]
        current_idx = [None]
        tr = obs.tracer()
        tr.name_thread(f"decode-worker-{st['idx']}")
        t0 = time.perf_counter()

        def feed():
            while True:
                item = st["q"].get()
                if item is self._DONE:
                    return
                current_idx[0] = item[0]
                # per-block re-key: quarantine partition = block index
                # (the sorted-partition merge is stream order)
                enc.bad_partition = (item[0],)
                enc.block_base = item[2]
                yield item[1]

        try:
            for batch in enc.encode_blocks(feed()):
                st["batches"].append(batch)
        except PARITY_ERRORS as exc:
            st["error"] = (current_idx[0], exc)
        except Exception as exc:
            if is_data_error(exc):
                # budget blown mid-block: input-shaped, takes the parity
                # path (smallest block index wins)
                st["error"] = (current_idx[0], exc)
            else:
                st["fault"] = exc
        dt = time.perf_counter() - t0
        self._count("ingest_worker_sec", dt)
        tr.complete("decode_worker", t0, worker=st["idx"],
                    lines=st["lines"], bytes=st["bytes"])
        obs.metrics().add("decode/worker_sec", dt)
