"""The PyTorch backend: one-shot, single-device SAM/BAM records -> FASTA.

Port of the single-device route of ``sam2consensus_tpu/backends/
jax_backend.py`` (``_run`` with its pileup-strategy choice, ``_make_encoder``
with its fused and parallel branches, the decode prefetch thread
``_Prefetcher`` with its stager, ``_tail_attempt``'s device and
host-accumulator branches with the tail placement, ``_unpack_tail``'s
dense branch, ``_native_vote`` and ``_assemble``):

1. the pileup strategy (``cfg.pileup``): ``pallas`` counts on the card
   (``ops.pileup.PileupAccumulator``, K1); ``host`` counts on the host
   (``ops.pileup.HostPileupAccumulator``); ``auto`` takes the host counts
   up to the genome length and the input bytes that
   :func:`ops.pileup.host_pileup_bound` gives;
2. host decode: a BAM stream's own encoder (``formats.bam``), or for SAM
   the C++ decoder (``encoder.native_encoder.NativeReadEncoder``, or with
   ``--decode-threads`` > 1 the shard-owned
   ``encoder.parallel_decode.ParallelFusedDecoder``) when its library
   loads and ``cfg.decoder`` is not ``py``, else the Python
   ``ReadEncoder``.  Under host counts the C++ pass counts as it decodes
   and the loop runs serially; otherwise a prefetch thread runs ahead of
   the pileup and, on CUDA, stages each batch's rows to the card
   (``PileupAccumulator.stage`` through ``wire.pipeline.StageSlots``);
3. the pileup: ``acc.add`` on the calling thread (the device pack and K1
   on CUDA; nothing left to do after a fused count);
4. one fused tail (``ops.fused.vote_packed*``; K2 or K3 on CUDA) into one
   packed uint8 buffer, fetched with one device-to-host copy; or, for host
   counts that the placement model (:func:`tail_placement`) keeps on the
   host, the native C++ vote (``ops.vote.vote_positions_native``) and the
   host insertion tail;
5. host unpack, insertion splice and FASTA render.

The output is byte-identical to ``--backend jax`` and ``--backend cpu`` of
the JAX package.  Phase wall times land in ``stats.extra`` (``decode_sec``
and ``stage_sec``, billed on the prefetch thread, so they overlap
``pileup_sec``; ``overlap_sec``, the staging seconds that ran while the
consumer was in ``add``; ``backpressure_sec``, the producer's waits for a
free staging slot; ``tail_sec``, ``assemble_sec``), with
``stats.extra["decoder"]`` naming the decoder that ran (``native`` or
``py``); on CUDA the pileup phase ends with a synchronize, so its time
includes the device work.  The priced decisions land there with their
inputs: ``pileup_path`` (with ``host_bound``, ``host_bytes_bound``,
``input_bytes`` and ``host_bound_reason`` under ``auto``),
``tail_device`` with ``tail_placement`` (``cpu_sec``, ``chip_sec``,
``rt_sec``, ``link_bps``, ...), and the decode thread policy
(``decode_threads``, ``decode_rung``) with the shard decoder's counters.

No decision is taken because something failed: ``--pileup host`` and
``--pileup pallas`` are obeyed as given, a device accumulator keeps its
whole tail on the device, and on CUDA nothing carries on on the CPU after
an error.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..config import RunConfig, resolve_decode_threads
from ..constants import NUM_SYMBOLS
from ..device import resolve_device
from .. import native
from ..encoder import native_encoder
from ..encoder.events import (GenomeLayout, ReadEncoder, group_insertions,
                              resolve_segment_width)
from ..encoder.parallel_decode import ParallelFusedDecoder
from ..formats.bgzf import BgzfReader, inflated_bytes
from ..io.fasta import FastaRecord
from ..io.sam import Contig, ReadStream, SamRecord
from ..ops import fused
from ..ops.insertions import insertion_tail_host
from ..ops.pileup import (HostPileupAccumulator, PileupAccumulator,
                          host_pileup_bound)
from ..ops.vote import device_fill_code, vote_positions_native
from ..wire.pipeline import StageSlots
from .base import BackendResult, BackendStats, format_header

INT32_MAX = (1 << 31) - 1

# The cost constants below were measured by ``perf/host_gate_sweep.py``
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit, with its 8-core host:
# the median of three runs on three machines
# (``perf/host_gate_sweep_pr7_run{1,2,3}.log``).
#: the link's round trip (a null kernel and a synchronise; 15.4-19.5 us)
#: and rate (the slower direction of pinned 1 MiB copies; 35.7-42.8 GB/s)
#: when the probe is off (``S2C_LINK_PROBE=0``) or there is no card
TAIL_RT_SEC_DEFAULT = 15.7e-6
TAIL_LINK_BPS_DEFAULT = 38.2e9
#: the fused tail's own cost on the card past the link (its launches and
#: the host-side steps around them), which the reference's one-dispatch
#: round trip stood for: the device tail's seconds at the sweep's
#: smallest genome (10 kbp; 2.74 and 2.88 ms, runs 2-3)
TAIL_CHIP_FIXED_SEC = 2.81e-3
#: positions a second of the plain PyTorch vote on the host's CPU (a tail
#: placed there without the native library; 10.6-22.7 M)
TAIL_CPU_POS_PER_SEC = 21.9e6
#: the native C++ vote (``s2c_vote``, one thread) a position (5.1-6.2 ns;
#: ``S2C_TAIL_NATIVE_NS`` overrides it), and each threshold past the
#: first (0.5-1.8 ns)
TAIL_NATIVE_NS_PER_POS = 5.7
TAIL_NATIVE_THR_NS = 0.6


def _probed_link(device=None):
    """``(rt_sec, bps)`` from the per-process probe of the card
    (``utils.linkprobe``), or None when probing is off
    (``S2C_LINK_PROBE=0``), the device is the CPU, or there is no card."""
    if os.environ.get("S2C_LINK_PROBE", "1") == "0":
        return None
    if device is not None and torch.device(device).type == "cpu":
        return None
    if not torch.cuda.is_available():
        return None
    from ..utils.linkprobe import probe_link

    probe = probe_link(None if device is None else torch.device(device))
    return probe.rt_sec, probe.bps


def _link_constants(device=None) -> tuple:
    """``(rt_sec, link_bps, source)`` for the placement model: the
    environment overrides (``S2C_TAIL_RT_MS``, ``S2C_TAIL_LINK_MBPS``),
    else the probe, else the card-measured defaults."""
    rt_env = os.environ.get("S2C_TAIL_RT_MS")
    bps_env = os.environ.get("S2C_TAIL_LINK_MBPS")
    rt = float(rt_env) / 1e3 if rt_env else None
    bps = float(bps_env) * 1e6 if bps_env else None
    source = "env"
    if rt is None or bps is None:
        probed = _probed_link(device)
        partial = (rt is None) != (bps is None)
        if probed is not None:
            source = "env+probed" if partial else "probed"
            rt = probed[0] if rt is None else rt
            bps = probed[1] if bps is None else bps
        else:
            source = "env+default" if partial else "default"
    rt = TAIL_RT_SEC_DEFAULT if rt is None else rt
    bps = TAIL_LINK_BPS_DEFAULT if bps is None else bps
    return rt, bps, source


def _fetch_sec(total_len: int, n_thresholds: int, link_bps: float) -> float:
    """Modelled device-to-host seconds of the tail's fetch: the dense
    ASCII encoding, one byte a position and threshold (the reference's
    ``_fetch_costs[None]``; the port ships no other encoding)."""
    return n_thresholds * total_len / link_bps


def tail_placement(total_len: int, n_thresholds: int, upload_bytes: int,
                   native_tail: bool, device=None) -> dict:
    """Where a host-counts tail runs, with the model's inputs: ``chosen``
    is ``"cpu"`` when the host's vote (the native C++ one when
    ``native_tail``, else the plain PyTorch one) beats the card's bill: the
    link's round trip, the tail's own fixed cost on the card, the counts
    upload and the dense fetch.  The reference bills one round trip for
    its one-dispatch tail; the port's tail is many launches, priced by
    ``TAIL_CHIP_FIXED_SEC`` (0 reproduces the reference's
    ``_tail_cpu_wins``).  A host vote cheaper than that fixed cost alone
    wins whatever the link, so the link is then not probed
    (``link_source`` ``"unpriced"``, ``chip_sec`` the fixed cost)."""
    if native_tail:
        cpu_sec = total_len * (
            float(os.environ.get("S2C_TAIL_NATIVE_NS")
                  or TAIL_NATIVE_NS_PER_POS)
            + TAIL_NATIVE_THR_NS * (n_thresholds - 1)) * 1e-9
    else:
        cpu_sec = total_len * n_thresholds / TAIL_CPU_POS_PER_SEC
    place = {"cpu_sec": cpu_sec, "fixed_sec": TAIL_CHIP_FIXED_SEC,
             "upload_bytes": int(upload_bytes), "total_len": int(total_len),
             "n_thresholds": int(n_thresholds),
             "native_tail": bool(native_tail)}
    if cpu_sec < TAIL_CHIP_FIXED_SEC:
        return dict(place, chosen="cpu", chip_sec=TAIL_CHIP_FIXED_SEC,
                    link_source="unpriced")
    rt_sec, link_bps, source = _link_constants(device)
    chip_sec = rt_sec + TAIL_CHIP_FIXED_SEC + upload_bytes / link_bps \
        + _fetch_sec(total_len, n_thresholds, link_bps)
    return dict(place, chosen="cpu" if cpu_sec < chip_sec else "device",
                chip_sec=chip_sec, rt_sec=rt_sec, link_bps=link_bps,
                link_source=source)


def _native_tail_possible() -> bool:
    """True when a tail placed on the host would run the native C++ vote:
    the library loads.  Shared by the host gate's bound and the placement
    model's rate."""
    return native.load() is not None


def _input_bytes(records, cap: int):
    """The input's decompressed bytes, where they are known without
    decoding it: a plain SAM file's body, or the blocks of a BGZF
    container (SAM text or BAM records; from each block's ISIZE field,
    counted only until they pass ``cap``).  None for a plain gzip stream
    or records in memory."""
    if isinstance(records, ReadStream):
        size = records.body_bytes_total()
        if size is not None:
            return size
    handle = getattr(records, "handle", None)
    if isinstance(handle, BgzfReader):
        return inflated_bytes(handle, cap)
    return None


def _timed(batches, stats: BackendStats):
    """Yield from ``batches`` on the calling thread, adding the time spent
    in the generator to ``stats.extra["decode_sec"]`` (the serial loop of
    a fused count, where decode and count are one pass)."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        finally:
            stats.extra["decode_sec"] += time.perf_counter() - t0
        yield batch


class _Prefetcher:
    """Bounded background decode and staging, ahead of the pileup.

    Copy of the JAX backend's ``_Prefetcher``.  The producer thread drains
    the encoder generator into a depth-2 queue, adding the time it spends
    in the generator to ``stats.extra["decode_sec"]``.  With a ``stager``
    (``wire.pipeline.StageSlots`` around ``PileupAccumulator.stage``) it
    then claims a staging slot for the batch (outside the stage clock:
    that wait is backpressure) and stages it: on CUDA the pinned copy, the
    host-to-device copy on a side stream and its event run here, on the
    producer.  Every other torch call stays on the consumer.  Exceptions,
    strict decode errors and staging failures alike, are re-raised in the
    consumer at the point of consumption with their type and message
    unchanged; unlike the reference, a batch whose staging failed is
    never delivered unstaged.  ``close()`` stops the producer when the
    consumer leaves early.
    """

    _DONE = object()

    def __init__(self, gen, stats: BackendStats, depth: int = 2,
                 stager=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._exc = None
        self._stats = stats
        self._stager = stager
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._work, args=(gen,), name="decode-prefetch",
            daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that aborts when the consumer called close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, gen) -> None:
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(gen)
                except StopIteration:
                    break
                finally:
                    self._stats.extra["decode_sec"] += \
                        time.perf_counter() - t0
                if self._stager is not None:
                    if not self._stager.acquire(batch):
                        return             # consumer gone; drop the rest
                    self._stager.run(batch)
                if not self._put(batch):
                    return                 # consumer gone; drop the rest
        except BaseException as exc:  # re-raised on the consumer side
            self._exc = exc
        self._put(self._DONE)

    def close(self) -> None:
        """Unblock and join the producer (consumer exited early)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)
        self._thread.join()

    def __iter__(self):
        while True:
            batch = self._q.get()
            if batch is self._DONE:
                self._thread.join()
                if self._exc is not None:
                    raise self._exc
                return
            yield batch


class TorchBackend:
    name = "torch"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def run(self, contigs: List[Contig], records: Iterable[SamRecord],
            cfg: RunConfig) -> BackendResult:
        stats = BackendStats()
        for key in ("decode_sec", "pileup_sec", "tail_sec", "assemble_sec",
                    "stage_sec", "overlap_sec", "backpressure_sec"):
            stats.extra[key] = 0.0
        layout = GenomeLayout(contigs)
        if layout.total_len == 0:
            return BackendResult(fastas={}, stats=stats)

        acc = self._make_accumulator(layout, records, cfg, stats)
        encoder, batches = self._make_encoder(layout, records, cfg, stats,
                                              acc)
        stats.extra["counts_fused"] = bool(getattr(encoder, "counts_fused",
                                                   False))
        stager = prefetch = None
        if stats.extra["counts_fused"]:
            # the count rides the decode pass: the loop only tallies, so
            # a prefetch thread would buy no overlap
            source = _timed(batches, stats)
        else:
            # staging is for the card: the CPU consumer ships its own rows
            if isinstance(acc, PileupAccumulator) \
                    and self.device.type == "cuda":
                stager = StageSlots(acc.stage)
            source = prefetch = _Prefetcher(batches, stats, stager=stager)
        try:
            for batch in source:
                t0 = time.perf_counter()
                acc.add(batch)
                t1 = time.perf_counter()
                stats.extra["pileup_sec"] += t1 - t0
                if stager is not None:
                    # K1's route is enqueued: release the batch's slot
                    stager.note_consume(t0, t1)
                    stager.consumed(batch)
                stats.aligned_bases += batch.n_events
        finally:
            # a consumer-side failure must not leave the decode thread
            # blocked on a full queue (or a backpressured staging slot)
            # holding the input stream open
            if stager is not None:
                stager.close()
            if prefetch is not None:
                prefetch.close()
        stats.extra.update(getattr(encoder, "counters", {}))
        if stager is not None:
            stats.extra["stage_sec"] = stager.stage_sec()
            stats.extra["overlap_sec"] = stager.overlap_sec()
            stats.extra["backpressure_sec"] = stager.backpressure_sec
        t0 = time.perf_counter()
        acc.sync()
        stats.extra["pileup_sec"] += time.perf_counter() - t0
        stats.reads_mapped = encoder.n_reads
        stats.reads_skipped = encoder.n_skipped

        t0 = time.perf_counter()
        syms, ins_syms, contig_sums, site_cov, ins, dash_counts = \
            self._tail(acc, cfg, layout, encoder, stats)
        stats.extra["tail_sec"] = time.perf_counter() - t0
        if isinstance(acc, HostPileupAccumulator):
            stats.extra["pileup"] = dict(acc.strategy_used)
            stats.extra["counts_uploads"] = acc.uploads
            stats.extra["counts_h2d_bytes"] = acc.bytes_h2d

        t0 = time.perf_counter()
        fastas = self._assemble(layout, syms, contig_sums, ins, ins_syms,
                                site_cov, cfg, stats, dash_counts=dash_counts)
        stats.extra["assemble_sec"] = time.perf_counter() - t0
        return BackendResult(fastas=fastas, stats=stats)

    def _make_accumulator(self, layout, records, cfg: RunConfig,
                          stats: BackendStats):
        """The pileup strategy (the JAX backend's choice in ``_run``):
        ``pallas`` the device accumulator, ``host`` the host counts,
        ``auto`` the host counts on a genome and an input within the
        gate's bounds (recorded with the input's size and the reason).
        An input whose size is not known without decoding it (a plain
        gzip stream, records in memory) goes to the card.  On the CPU
        device there is no link: with the native library the bounds
        vanish."""
        strategy = cfg.pileup
        if strategy not in ("auto", "pallas", "host"):
            raise ValueError(f"--pileup {strategy!r}: the port runs auto, "
                             f"pallas and host")
        host = strategy == "host"
        if strategy == "auto":
            bound, byte_bound, reason = host_pileup_bound(
                layout.total_len, _native_tail_possible(),
                link_free=self.device.type == "cpu")
            host = layout.total_len <= bound
            size = None
            if host and byte_bound is not None:
                size = _input_bytes(records, byte_bound)
                host = size is not None and size <= byte_bound
            stats.extra.update(host_bound=bound, host_bytes_bound=byte_bound,
                               input_bytes=size, host_bound_reason=reason)
        stats.extra["pileup_path"] = "host" if host else "device"
        if host:
            return HostPileupAccumulator(layout.total_len)
        return PileupAccumulator(layout.total_len, self.device)

    @staticmethod
    def _make_encoder(layout, records, cfg: RunConfig, stats: BackendStats,
                      acc=None):
        """Pick the host decode path (the JAX backend's ``_make_encoder``:
        a BAM stream's own encoder, else the parallel or the serial
        branch, counting as it decodes when ``acc`` holds host counts);
        returns ``(encoder, batch iterator)`` and records the choice in
        ``stats.extra`` (``decoder``; for the C++ SAM decoder also the
        thread policy ``decode_threads`` and the rung ``decode_rung``)."""
        fuse = isinstance(acc, HostPileupAccumulator)
        if hasattr(records, "make_encoder"):
            # binary formats (formats/bam.BamReadStream): the stream owns
            # its record decode and hands back the same surface
            enc, batches = records.make_encoder(layout, cfg, acc)
            stats.extra["decoder"] = "native" if isinstance(
                enc, native_encoder.NativeReadEncoder) else "py"
            return enc, batches
        seg_w = resolve_segment_width(cfg.segment_width)
        if isinstance(records, ReadStream) and cfg.decoder != "py":
            if native_encoder.available():
                stats.extra["decoder"] = "native"
                # one thread budget: the shard workers, the BGZF inflate
                # pool and the native vote
                threads = resolve_decode_threads(cfg)
                parallel = threads > 1
                stats.extra["decode_threads"] = threads if parallel else 1
                stats.extra["decode_rung"] = "fused" if fuse else "slab"
                counts = acc.counts_host() if fuse else None
                if parallel:
                    # shard-owned ingest: byte-range workers decode with
                    # the GIL released, into private count partitions
                    # (fused) or slabs for the stager (slab)
                    enc = ParallelFusedDecoder(
                        layout, counts, threads, maxdel=cfg.maxdel,
                        strict=cfg.strict, on_lines=records.add_lines,
                        on_bytes=records.add_bytes, segment_width=seg_w)
                    return enc, enc.encode_input(records)
                enc = native_encoder.NativeReadEncoder(
                    layout, maxdel=cfg.maxdel, strict=cfg.strict,
                    on_lines=records.add_lines, on_bytes=records.add_bytes,
                    accumulate_into=counts, segment_width=seg_w)
                return enc, enc.encode_blocks_from(records)
            if cfg.decoder == "native":
                raise RuntimeError("--decoder native requested but the C++ "
                                   f"decoder is unavailable: "
                                   f"{native.load_error()}")
        stats.extra["decoder"] = "py"
        enc = ReadEncoder(layout, maxdel=cfg.maxdel, strict=cfg.strict,
                          segment_width=seg_w)
        source = records.records() if isinstance(records, ReadStream) \
            else records
        return enc, enc.encode_segments(source, cfg.chunk_reads)

    def _tail(self, acc, cfg: RunConfig, layout, encoder, stats):
        """The tail: one fused device call and one device-to-host copy, or
        for host counts placed on the host the native vote.  Returns
        ``(syms, ins_syms, contig_sums, site_cov, ins, dash_counts)`` as
        host arrays."""
        ins = group_insertions(encoder.insertions, layout)
        n_thresholds = len(cfg.thresholds)
        tail_dev = self.device
        if isinstance(acc, HostPileupAccumulator):
            if self.device.type == "cpu":
                placement = {"chosen": "cpu", "link_free": True}
            else:
                placement = self._place_host_tail(acc, cfg, layout, stats)
            if placement["chosen"] == "cpu":
                tail_dev = torch.device("cpu")
            stats.extra["tail_placement"] = placement
        else:
            stats.extra["tail_placement"] = {"chosen": "device",
                                             "pileup": "device"}
        stats.extra["tail_device"] = tail_dev.type
        stats.extra["tail_native"] = False
        if tail_dev.type == "cpu" and isinstance(acc, HostPileupAccumulator) \
                and _native_tail_possible():
            stats.extra["tail_native"] = True
            out = self._native_tail(acc, cfg, layout, ins)
        else:
            counts = acc.counts_on(tail_dev) \
                if isinstance(acc, HostPileupAccumulator) else acc.counts
            out = self._device_tail(counts, tail_dev, cfg, layout, ins)
        syms, ins_syms, contig_sums, site_cov, dash_counts = out
        if stats.aligned_bases > INT32_MAX:
            # the packed per-contig sums are int32 and wrap once total
            # aligned bases pass 2^31: recompute them exactly in int64
            if isinstance(acc, HostPileupAccumulator):
                cov64 = torch.from_numpy(
                    acc.counts_host().sum(axis=-1, dtype=np.int64))
            else:
                cov64 = fused.coverage(acc.counts)
            contig_sums = fused.contig_sums_i64(
                cov64, torch.from_numpy(layout.offsets).to(cov64.device)
            ).cpu().numpy()
            stats.extra["contig_sums_int64"] = True
        return syms, ins_syms, contig_sums, site_cov, ins, dash_counts

    def _place_host_tail(self, acc, cfg: RunConfig, layout, stats) -> dict:
        """The placement of a host-counts tail on a CUDA run (the JAX
        backend's ``_cpu_tail_wins`` over its ``_tail_cpu_wins``, here
        :func:`tail_placement`): an optimistic bill first (a
        one-byte upload: the card's cost only grows with the real dtype,
        so a host win against it is decisive and skips the counts' max
        scan), then the real one."""
        native_ok = _native_tail_possible()
        cells = layout.total_len * NUM_SYMBOLS
        place = tail_placement(layout.total_len, len(cfg.thresholds),
                               cells, native_ok, self.device)
        if place["chosen"] != "cpu":
            place = tail_placement(layout.total_len, len(cfg.thresholds),
                                   cells * acc.wire_itemsize(), native_ok,
                                   self.device)
        return place

    @staticmethod
    def _native_tail(acc, cfg: RunConfig, layout, ins):
        """The host tail on the native library: the C++ position vote
        (FILL sentinels; the host render substitutes the fill), int64
        contig sums by ``s2c_cov_sums`` and the host insertion tail."""
        syms, cov = vote_positions_native(
            acc.counts_host(), cfg.thresholds, cfg.min_depth,
            threads=resolve_decode_threads(cfg))
        offs = np.ascontiguousarray(layout.offsets, dtype=np.int64)
        contig_sums = np.empty(len(offs) - 1, dtype=np.int64)
        native.load().s2c_cov_sums(cov, offs, len(offs) - 1, contig_sums)
        site_cov = ins_syms = None
        if ins is not None:
            k = len(ins["key_flat"])
            kp = fused.next_pow2(k + 1)
            cp = fused.next_pow2(ins["max_cols"])
            sk = np.full(kp, -1, dtype=np.int64)
            sk[:k] = ins["key_flat"]
            ncp = np.zeros(kp, dtype=np.int32)
            ncp[:k] = ins["n_cols"]
            site_cov_p = np.where(sk >= 0, cov[np.maximum(sk, 0)],
                                  0).astype(np.int32)
            site_cov = site_cov_p[:k].astype(np.int64)
            # pad events to a power of two; pad events count into the
            # sacrificial last site row (kp > k always)
            e = len(ins["ev_key"])
            ep = fused.next_pow2(max(e, 1))
            ev_key = np.full(ep, kp - 1, dtype=np.int32)
            ev_key[:e] = ins["ev_key"]
            ev_col = np.zeros(ep, dtype=np.int32)
            ev_col[:e] = ins["ev_col"]
            ev_code = np.zeros(ep, dtype=np.int32)
            ev_code[:e] = ins["ev_code"]
            ins_syms = insertion_tail_host(kp, cp, ev_key, ev_col, ev_code,
                                           site_cov_p, ncp, cfg.thresholds,
                                           k)                # [T, K, Cp]
        return syms, ins_syms, contig_sums, site_cov, None

    def _device_tail(self, counts, dev, cfg: RunConfig, layout, ins):
        """The fused tail on ``dev`` in one call and one device-to-host
        copy; ``counts`` (int32, or the narrowed host-counts upload) are
        widened inside the vote."""
        n_thresholds = len(cfg.thresholds)
        total_len = layout.total_len
        n_contigs = len(layout.names)
        offsets = torch.from_numpy(layout.offsets).to(dev)
        # the device epilogue substitutes a single-character fill inside
        # the vote and appends per-(threshold, contig) dash counts; other
        # fills keep the FILL sentinel and the host substitutes
        fill_code = device_fill_code(cfg.fill, "ascii")
        epilogue = fill_code is not None
        if ins is not None:
            k = len(ins["key_flat"])
            # pad sites and columns to powers of two, like the JAX tail:
            # pad sites have key -1 (coverage 0) and n_cols 0, so every pad
            # row votes FILL and the host slices it off
            kp = fused.next_pow2(k + 1)
            cp = fused.next_pow2(ins["max_cols"])
            sk = np.full(kp, -1, dtype=np.int64)
            sk[:k] = ins["key_flat"]
            ncp = np.zeros(kp, dtype=np.int32)
            ncp[:k] = ins["n_cols"]
            packed = fused.vote_packed(
                counts, cfg.thresholds, offsets,
                torch.from_numpy(sk).to(dev), torch.from_numpy(ncp).to(dev),
                torch.from_numpy(ins["ev_key"]).to(dev),
                torch.from_numpy(ins["ev_col"]).to(dev),
                torch.from_numpy(ins["ev_code"]).to(dev),
                cfg.min_depth, cp, fill_code or 0, epilogue)
            return self._unpack_tail(
                packed.cpu().numpy(), n_thresholds, total_len, kp, cp,
                n_contigs, k, epilogue=epilogue)
        out = fused.vote_packed_simple(
            counts, cfg.thresholds, offsets, cfg.min_depth,
            fill_code or 0, epilogue).cpu().numpy()
        split = n_thresholds * total_len
        syms = out[:split].reshape(n_thresholds, total_len)
        split2 = split + 4 * n_contigs
        contig_sums = fused.unpack_i32(out[split:split2], n_contigs)
        dash_counts = None
        if epilogue:
            dash_counts = fused.unpack_i32(
                out[split2:], n_thresholds * n_contigs).reshape(
                n_thresholds, n_contigs)
        return syms, None, contig_sums, None, dash_counts

    @staticmethod
    def _unpack_tail(out: np.ndarray, n_thresholds: int, total_len: int,
                     kp: int, cp: int, n_contigs: int, k: int,
                     epilogue: bool = False):
        """Split the packed tail buffer (dense ASCII layout)."""
        split1 = n_thresholds * total_len
        syms = out[:split1].reshape(n_thresholds, total_len)
        split2 = split1 + n_thresholds * kp * cp
        split3 = split2 + 4 * n_contigs
        split4 = split3 + 4 * kp
        ins_syms = out[split1:split2].reshape(
            n_thresholds, kp, cp)[:, :k, :]                   # [T, K, Cp]
        contig_sums = fused.unpack_i32(out[split2:split3], n_contigs)
        site_cov = fused.unpack_i32(out[split3:split4], kp)[:k]
        dash_counts = None
        if epilogue:
            dash_counts = fused.unpack_i32(
                out[split4:], n_thresholds * n_contigs).reshape(
                n_thresholds, n_contigs)
        return syms, ins_syms, contig_sums, site_cov, dash_counts

    def _assemble(self, layout, syms: np.ndarray, contig_sums: np.ndarray,
                  ins, ins_syms, site_cov, cfg: RunConfig,
                  stats: BackendStats,
                  dash_counts=None) -> Dict[str, List[FastaRecord]]:
        """Render FASTA records from the tail's outputs (copy of the JAX
        backend's ``_assemble`` without its native-library branch).

        ``dash_counts`` (device epilogue) means the symbols already carry
        the fill byte and the per-contig dash totals were reduced on
        device."""
        n_thresholds = syms.shape[0]
        fastas: Dict[str, List[FastaRecord]] = {}

        if ins is not None:
            # key_contig is sorted (group_insertions orders sites by
            # (contig, local)), so per-contig site ranges are one search
            _kc_bounds = np.searchsorted(
                ins["key_contig"], np.arange(len(layout.names) + 1))

        for ci, name in enumerate(layout.names):
            off = int(layout.offsets[ci])
            length = int(layout.lengths[ci])
            sumcov_base = int(contig_sums[ci])
            if sumcov_base == 0:
                continue  # zero-coverage prune (sam2consensus.py:334-340)

            # emittable insertion sites: local key within [0, length) and
            # site depth passing the gates (sam2consensus.py:356-385)
            site_rows = np.zeros(0, dtype=np.int64)
            if ins is not None:
                lo, hi = int(_kc_bounds[ci]), int(_kc_bounds[ci + 1])
                loc_all = ins["key_local"][lo:hi]
                keep = (loc_all >= 0) & (loc_all < length)
                site_rows = np.arange(lo, hi, dtype=np.int64)[keep]
                locs = loc_all[keep].astype(np.int64)
                sc = site_cov[site_rows]
                depth_ok = (sc > 0) & (sc >= cfg.min_depth)
                site_rows, locs = site_rows[depth_ok], locs[depth_ok]

            for t in range(n_thresholds):
                base = syms[t, off:off + length]
                if len(site_rows):
                    # splice each site's surviving columns after its base
                    # position (right-shift placement, quirk 3)
                    block = ins_syms[t, site_rows]             # [S, Cp]
                    nz = block != 0
                    lens = nz.sum(axis=1)
                    arr = np.insert(base, np.repeat(locs + 1, lens),
                                    block[nz])
                    sumcov = sumcov_base + int(
                        (site_cov[site_rows] * lens).sum())
                else:
                    arr = base
                    sumcov = sumcov_base

                if dash_counts is not None:
                    dashes = int(dash_counts[t, ci])
                    if len(site_rows):
                        dashes += int((block[nz] == ord("-")).sum())
                    seq = arr.tobytes().decode("latin-1")
                    stripped = len(seq) - dashes
                    if stripped == 0:
                        continue  # empty-sequence drop (:400-406)
                    header = format_header(cfg.prefix, cfg.thresholds[t],
                                           name, sumcov, seq,
                                           stripped_len=stripped)
                else:
                    # multi-char (or non-latin) fill: the plain-string path
                    seq = arr.tobytes().decode("latin-1").replace(
                        "\x00", cfg.fill)
                    if len(seq) - seq.count("-") == 0:
                        continue  # empty-sequence drop (:400-406)
                    header = format_header(cfg.prefix, cfg.thresholds[t],
                                           name, sumcov, seq)
                fastas.setdefault(name, []).append(FastaRecord(header, seq))
                stats.consensus_bases += len(seq)

        return fastas
