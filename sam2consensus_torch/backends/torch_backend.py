"""The PyTorch backend: one-shot, single-device SAM/BAM records -> FASTA.

Port of the single-device route of ``sam2consensus_tpu/backends/
jax_backend.py`` (``_run``, the serial branch of ``_make_encoder``, the
decode prefetch thread ``_Prefetcher`` with its stager, the device branch
of ``_tail_attempt``, ``_unpack_tail``'s dense branch and ``_assemble``):

1. host decode into segment rows: a BAM stream's own encoder
   (``formats.bam``), or for SAM the C++ decoder
   (``encoder.native_encoder.NativeReadEncoder``) over a ``ReadStream``'s
   raw blocks when its library loads and ``cfg.decoder`` is not ``py``,
   else the Python ``ReadEncoder``; either runs on a prefetch thread, a
   bounded queue ahead of the pileup, which on CUDA also stages each
   batch's rows to the card (``PileupAccumulator.stage`` through
   ``wire.pipeline.StageSlots``);
2. device pileup: ``PileupAccumulator.add`` (the device pack and K1 on
   CUDA), on the calling thread;
3. one fused tail (``ops.fused.vote_packed*``; K2 or K3 on CUDA) into one
   packed uint8 buffer, fetched with one device-to-host copy;
4. host unpack, insertion splice and FASTA render.

The output is byte-identical to ``--backend jax`` and ``--backend cpu`` of
the JAX package.  Phase wall times land in ``stats.extra`` (``decode_sec``
and ``stage_sec``, billed on the prefetch thread, so they overlap
``pileup_sec``; ``overlap_sec``, the staging seconds that ran while the
consumer was in ``add``; ``backpressure_sec``, the producer's waits for a
free staging slot; ``tail_sec``, ``assemble_sec``), with
``stats.extra["decoder"]`` naming the decoder that ran (``native`` or
``py``); on CUDA the pileup phase ends with a synchronize, so its time
includes the device work.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..config import RunConfig
from ..device import resolve_device
from .. import native
from ..encoder import native_encoder
from ..encoder.events import (GenomeLayout, ReadEncoder, group_insertions,
                              resolve_segment_width)
from ..io.fasta import FastaRecord
from ..io.sam import Contig, ReadStream, SamRecord
from ..ops import fused
from ..ops.pileup import PileupAccumulator
from ..ops.vote import device_fill_code
from ..wire.pipeline import StageSlots
from .base import BackendResult, BackendStats, format_header

INT32_MAX = (1 << 31) - 1


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

        encoder, batches = self._make_encoder(layout, records, cfg, stats)
        acc = PileupAccumulator(layout.total_len, self.device)
        # staging is for the card: the CPU consumer ships its own rows
        stager = StageSlots(acc.stage) if self.device.type == "cuda" \
            else None
        prefetch = _Prefetcher(batches, stats, stager=stager)
        try:
            for batch in prefetch:
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
            prefetch.close()
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

        t0 = time.perf_counter()
        fastas = self._assemble(layout, syms, contig_sums, ins, ins_syms,
                                site_cov, cfg, stats, dash_counts=dash_counts)
        stats.extra["assemble_sec"] = time.perf_counter() - t0
        return BackendResult(fastas=fastas, stats=stats)

    @staticmethod
    def _make_encoder(layout, records, cfg: RunConfig, stats: BackendStats):
        """Pick the host decode path (the JAX backend's ``_make_encoder``:
        a BAM stream's own encoder, else the serial branch); returns ``(encoder, batch iterator)`` and records the choice in
        ``stats.extra["decoder"]``."""
        if hasattr(records, "make_encoder"):
            # binary formats (formats/bam.BamReadStream): the stream owns
            # its record decode and hands back the same surface
            enc, batches = records.make_encoder(layout, cfg)
            stats.extra["decoder"] = "native" if isinstance(
                enc, native_encoder.NativeReadEncoder) else "py"
            return enc, batches
        seg_w = resolve_segment_width(cfg.segment_width)
        if isinstance(records, ReadStream) and cfg.decoder != "py":
            if native_encoder.available():
                stats.extra["decoder"] = "native"
                enc = native_encoder.NativeReadEncoder(
                    layout, maxdel=cfg.maxdel, strict=cfg.strict,
                    on_lines=records.add_lines, on_bytes=records.add_bytes,
                    segment_width=seg_w)
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
        """The fused tail in one device call and one device-to-host copy.
        Returns ``(syms, ins_syms, contig_sums, site_cov, ins,
        dash_counts)`` as host arrays."""
        dev = self.device
        n_thresholds = len(cfg.thresholds)
        total_len = layout.total_len
        n_contigs = len(layout.names)
        offsets = torch.from_numpy(layout.offsets).to(dev)
        # the device epilogue substitutes a single-character fill inside
        # the vote and appends per-(threshold, contig) dash counts; other
        # fills keep the FILL sentinel and the host substitutes
        fill_code = device_fill_code(cfg.fill, "ascii")
        epilogue = fill_code is not None
        ins = group_insertions(encoder.insertions, layout)
        site_cov = ins_syms = dash_counts = None
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
                acc.counts, cfg.thresholds, offsets,
                torch.from_numpy(sk).to(dev), torch.from_numpy(ncp).to(dev),
                torch.from_numpy(ins["ev_key"]).to(dev),
                torch.from_numpy(ins["ev_col"]).to(dev),
                torch.from_numpy(ins["ev_code"]).to(dev),
                cfg.min_depth, cp, fill_code or 0, epilogue)
            out = packed.cpu().numpy()
            (syms, ins_syms, contig_sums, site_cov,
             dash_counts) = self._unpack_tail(
                out, n_thresholds, total_len, kp, cp, n_contigs, k,
                epilogue=epilogue)
        else:
            out = fused.vote_packed_simple(
                acc.counts, cfg.thresholds, offsets, cfg.min_depth,
                fill_code or 0, epilogue).cpu().numpy()
            split = n_thresholds * total_len
            syms = out[:split].reshape(n_thresholds, total_len)
            split2 = split + 4 * n_contigs
            contig_sums = fused.unpack_i32(out[split:split2], n_contigs)
            if epilogue:
                dash_counts = fused.unpack_i32(
                    out[split2:], n_thresholds * n_contigs).reshape(
                    n_thresholds, n_contigs)
        if stats.aligned_bases > INT32_MAX:
            # the packed per-contig sums are int32 and wrap once total
            # aligned bases pass 2^31: recompute them exactly in int64
            contig_sums = fused.contig_sums_i64(
                fused.coverage(acc.counts), offsets).cpu().numpy()
            stats.extra["contig_sums_int64"] = True
        return syms, ins_syms, contig_sums, site_cov, ins, dash_counts

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
