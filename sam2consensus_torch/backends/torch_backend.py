"""The PyTorch backend: one-shot, single-device SAM records -> FASTA records.

Port of the single-device route of ``sam2consensus_tpu/backends/
jax_backend.py`` (``_run``, the device branch of ``_tail_attempt``,
``_unpack_tail``'s dense branch and ``_assemble``):

1. host decode: ``ReadEncoder.encode_segments`` into segment rows;
2. device pileup: ``PileupAccumulator.add`` (K1 on CUDA);
3. one fused tail (``ops.fused.vote_packed*``; K2 or K3 on CUDA) into one
   packed uint8 buffer, fetched with one device-to-host copy;
4. host unpack, insertion splice and FASTA render.

The output is byte-identical to ``--backend jax`` and ``--backend cpu`` of
the JAX package.  Phase wall times land in ``stats.extra`` (``decode_sec``,
``pileup_sec``, ``tail_sec``, ``assemble_sec``); on CUDA the pileup phase
ends with a synchronize, so its time includes the device work.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..config import RunConfig
from ..device import resolve_device
from ..encoder.events import (GenomeLayout, ReadEncoder, group_insertions,
                              resolve_segment_width)
from ..io.fasta import FastaRecord
from ..io.sam import Contig, ReadStream, SamRecord
from ..ops import fused
from ..ops.pileup import PileupAccumulator
from ..ops.vote import device_fill_code
from .base import BackendResult, BackendStats, format_header

INT32_MAX = (1 << 31) - 1


def _timed(it, stats: BackendStats, key: str):
    """Yield from ``it``, adding the time spent producing items to
    ``stats.extra[key]``."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            stats.extra[key] += time.perf_counter() - t0
            return
        stats.extra[key] += time.perf_counter() - t0
        yield item


class TorchBackend:
    name = "torch"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def run(self, contigs: List[Contig], records: Iterable[SamRecord],
            cfg: RunConfig) -> BackendResult:
        stats = BackendStats()
        for key in ("decode_sec", "pileup_sec", "tail_sec", "assemble_sec"):
            stats.extra[key] = 0.0
        layout = GenomeLayout(contigs)
        if layout.total_len == 0:
            return BackendResult(fastas={}, stats=stats)

        encoder = ReadEncoder(
            layout, maxdel=cfg.maxdel, strict=cfg.strict,
            segment_width=resolve_segment_width(cfg.segment_width))
        source = records.records() if isinstance(records, ReadStream) \
            else records
        acc = PileupAccumulator(layout.total_len, self.device)
        for batch in _timed(encoder.encode_segments(source, cfg.chunk_reads),
                            stats, "decode_sec"):
            t0 = time.perf_counter()
            acc.add(batch)
            stats.extra["pileup_sec"] += time.perf_counter() - t0
            stats.aligned_bases += batch.n_events
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
