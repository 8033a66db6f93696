"""Read -> tensor encoder: host-side CIGAR decode into scatter-ready segments.

Copy of the Python encoder of ``sam2consensus_tpu/encoder/events.py``
(pinned equal by ``tests/test_torch_copies.py``); the native decoder
(``encoder/native_encoder.py``) shares its batch and insertion stores and
replays the lines it cannot take through it.  Each read becomes one
contiguous reference-coordinate segment: a flat-genome start plus a uint8
code row (read bases for M/=/X, GAP for D/N/P runs, PAD_CODE for gap bases
dropped by the maxdel gate).  Semantics follow the reference CIGAR walker
(``sam2consensus.py:46-82,195-221``):

* I records an insertion event keyed by (contig, index of next ref base);
* S skips read bases, H is a no-op;
* POS-1 may be negative: local indices in [-reflen, 0) wrap Python-style,
  splitting the read into (at most) two segment rows.

The genome is one flat position axis, contigs concatenated at offsets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import BASE_TO_CODE, GAP, INVALID_SYMBOL, PAD_CODE
from ..core.cigar import split_ops
from ..io.sam import Contig, SamRecord

#: smallest segment-row bucket width
MIN_BUCKET_W = 32

#: auto-resolved long-read segment width: reads whose reference span exceeds
#: this split into W-wide rows at exact W boundaries (pileup addition
#: commutes, so the split is semantically free)
DEFAULT_SEGMENT_W = 4096


def resolve_segment_width(value: int) -> int:
    """``RunConfig.segment_width`` policy: 0 = auto (DEFAULT_SEGMENT_W),
    negative = segmentation off, positive = that width rounded up to a
    power of two (>= MIN_BUCKET_W)."""
    if value == 0:
        return DEFAULT_SEGMENT_W
    if value < 0:
        return 0
    return max(MIN_BUCKET_W, 1 << (int(value) - 1).bit_length())


class GenomeLayout:
    """Flat concatenated coordinate system over the declared contigs.

    Duplicate @SQ names follow the reference's dict-overwrite (last LN wins,
    first position in iteration order).
    """

    def __init__(self, contigs: Sequence[Contig]):
        lengths: Dict[str, int] = {}
        for c in contigs:
            lengths[c.name] = c.length
        self.names: List[str] = list(lengths)
        self.lengths = np.array([lengths[n] for n in self.names], dtype=np.int64)
        self.offsets = np.zeros(len(self.names) + 1, dtype=np.int64)
        np.cumsum(self.lengths, out=self.offsets[1:])
        self.total_len = int(self.offsets[-1])
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}


@dataclass
class SegmentBatch:
    """One host->device batch of per-read pileup segments.

    ``buckets`` maps row width W to ``(starts int32 [S], codes uint8 [S, W])``
    where row r adds one pileup event per column c with
    ``codes[r, c] != PAD_CODE`` at flat position ``starts[r] + c``.  S is
    padded to a power of two with all-PAD rows (start 0).
    """
    buckets: Dict[int, Tuple[np.ndarray, np.ndarray]]
    n_reads: int = 0
    n_events: int = 0          # countable (non-PAD) symbols in the batch
    #: True when the fused decode path already counted this batch's cells
    #: into the host count tensor (encoder/native_encoder.py): buckets are
    #: empty and consumers must not count them again
    accumulated: bool = False
    #: device-staged operands ``{w: ops.pileup.StagedRows or None}``
    #: placed on the decode prefetch thread (``PileupAccumulator.stage``;
    #: None for a bucket with no real row); empty on the CPU, where the
    #: consumer ships the rows itself
    staged: Dict[int, object] = field(default_factory=dict)


@dataclass
class InsertionEvents:
    """Raw insertion observations, grouped later by (contig, local position).

    Two storage forms coexist: per-read Python lists (the Python encoder
    appends one entry per I op) and bulk array chunks
    ``(contig int32, local int32, motif_len int32, motif_chars uint8)``
    appended by the native decoder.  ``to_arrays`` merges both; ordering
    between forms is irrelevant (grouping sorts by site key).
    """
    contig_ids: List[int] = field(default_factory=list)
    local_pos: List[int] = field(default_factory=list)
    motifs: List[str] = field(default_factory=list)
    array_chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
                       ] = field(default_factory=list)

    def extend(self, other: "InsertionEvents") -> None:
        self.contig_ids.extend(other.contig_ids)
        self.local_pos.extend(other.local_pos)
        self.motifs.extend(other.motifs)
        self.array_chunks.extend(other.array_chunks)

    def __len__(self) -> int:
        return len(self.motifs) + sum(len(c[0]) for c in self.array_chunks)

    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        """Merged ``(contig i64, local i64, motif_lens i64, motif_chars u8)``
        — motif_chars is raw ASCII, one motif after another."""
        contigs = [np.asarray(self.contig_ids, dtype=np.int64)]
        locals_ = [np.asarray(self.local_pos, dtype=np.int64)]
        mlens = [np.array([len(m) for m in self.motifs], dtype=np.int64)]
        chars = [np.frombuffer("".join(self.motifs).encode("ascii"),
                               dtype=np.uint8)]
        for c, l, ml, ch in self.array_chunks:
            contigs.append(c.astype(np.int64))
            locals_.append(l.astype(np.int64))
            mlens.append(ml.astype(np.int64))
            chars.append(ch)
        return (np.concatenate(contigs), np.concatenate(locals_),
                np.concatenate(mlens), np.concatenate(chars))


def render_record(rec) -> str:
    """Canonical raw-record rendering for quarantine sidecars when the
    original line/bytes are not in hand (parsed-record paths: the pure-
    python rung, the BAM slow lane): the four consensus-relevant fields
    as a minimal SAM-ish line.  Raw-line paths store the real line."""
    try:
        return (f"{rec.refname}\t{rec.pos + 1}\t{rec.cigar}\t{rec.seq}")
    except Exception:       # a record too broken to render still counts
        return repr(rec)


class EncodeError(ValueError):
    """Base for encoder-contract violations (strict errors raise the
    oracle's exact KeyError / IndexError instead)."""


def _bucket_width(span: int) -> int:
    return max(MIN_BUCKET_W, 1 << (span - 1).bit_length())


def pack_rows(rows: List[Tuple[int, np.ndarray]]) -> SegmentBatch:
    """Bucket (flat_start, code_row) pairs into padded SegmentBatch arrays."""
    by_w: Dict[int, Tuple[List[int], List[np.ndarray]]] = {}
    n_events = 0
    for start, row in rows:
        w = _bucket_width(len(row))
        starts, codes = by_w.setdefault(w, ([], []))
        starts.append(start)
        codes.append(row)
        n_events += len(row) - int((row == PAD_CODE).sum())
    buckets: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for w, (starts, code_rows) in by_w.items():
        s = len(starts)
        s_pad = max(1024, 1 << (s - 1).bit_length())
        mat = np.full((s_pad, w), PAD_CODE, dtype=np.uint8)
        for r, row in enumerate(code_rows):
            mat[r, : len(row)] = row
        st = np.zeros(s_pad, dtype=np.int32)
        st[:s] = starts
        buckets[w] = (st, mat)
    return SegmentBatch(buckets=buckets, n_events=n_events)


class ReadEncoder:
    """Streaming encoder: SamRecords in, SegmentBatches + InsertionEvents out."""

    def __init__(self, layout: GenomeLayout, maxdel: Optional[int] = 150,
                 strict: bool = True, segment_width: int = 0,
                 bad_sink=None, bad_partition=(0,)):
        self.layout = layout
        self.maxdel = maxdel
        self.strict = strict
        #: >0 = split rows wider than this at exact W boundaries; 0 = off.
        self.segment_width = segment_width
        #: tolerant decode (``--on-bad-record skip|quarantine``): a
        #: :class:`~..ingest.badrecords.QuarantineSink` shared run-wide.
        #: When set, :meth:`encode_segments` absorbs per-record failures
        #: into it instead of raising (or silently counting, in legacy
        #: permissive mode).  ``bad_partition`` keys this encoder's
        #: records in the sink's deterministic merge order.
        self.bad_sink = bad_sink
        self.bad_partition = tuple(bad_partition)
        self.n_reads = 0
        self.n_skipped = 0
        self.insertions = InsertionEvents()

    def encode_segments(self, records: Iterable[SamRecord],
                        chunk_reads: int = 262144) -> Iterator[SegmentBatch]:
        """Yield segment batches of at most ``chunk_reads`` reads each."""
        rows: List[Tuple[int, np.ndarray]] = []
        in_chunk = 0
        for rec in records:
            try:
                # encode_record validates fully before committing anything
                new_rows = self.encode_record(rec)
            except (EncodeError, KeyError, IndexError) as exc:
                if self.bad_sink is not None:
                    # tolerant decode: quarantine/count the record (the
                    # sink raises the budget error when it is spent)
                    self.bad_sink.record(render_record(rec), exc,
                                         partition=self.bad_partition)
                    self.n_skipped += 1
                    continue
                if self.strict:
                    raise
                self.n_skipped += 1
                continue
            rows.extend(new_rows)
            self.n_reads += 1
            in_chunk += 1
            if in_chunk >= chunk_reads:
                batch = pack_rows(rows)
                batch.n_reads = in_chunk
                rows, in_chunk = [], 0
                yield batch
        if rows or in_chunk:
            batch = pack_rows(rows)
            batch.n_reads = in_chunk
            yield batch

    def encode_record(self, rec: SamRecord) -> List[Tuple[int, np.ndarray]]:
        """Encode one record into (flat_start, code_row) segment rows.

        Raises the oracle's exact KeyError/IndexError (before any side
        effect) on contract violations; on success also appends the read's
        insertion events.
        """
        layout = self.layout
        ci = layout.index.get(rec.refname)
        if ci is None:
            raise KeyError(
                f"read mapped to unknown reference {rec.refname!r} "
                "(reference would KeyError here too)")
        reflen = int(layout.lengths[ci])
        offset = int(layout.offsets[ci])

        seq_codes = BASE_TO_CODE[
            np.frombuffer(rec.seq.encode("ascii"), dtype=np.uint8)]

        # The reference builds its aligned sequence by CONCATENATION, so a
        # short M op shifts later ops left and the span is the emitted
        # length; insertion keys follow the CLAIMED reference cursor.
        my_base: List[Tuple[int, np.ndarray]] = []    # (out_offset, codes)
        my_gaps: List[Tuple[int, int]] = []           # (out_offset, length)
        my_ins: List[Tuple[int, str]] = []
        rc = 0
        out = 0
        claim = rec.pos
        # pre-split ops ride with binary records (formats/bam.py), so the
        # BAM path never rebuilds or re-regexes CIGAR text
        ops = getattr(rec, "ops", None)
        if ops is None:
            ops = split_ops(rec.cigar)
        for length, op in ops:
            if op in "M=X":
                codes = seq_codes[rc:rc + length]
                my_base.append((out, codes))
                rc += length
                out += len(codes)
                claim += length
            elif op in "DNP":
                my_gaps.append((out, length))
                out += length
                claim += length
            elif op == "I":
                my_ins.append((claim, rec.seq[rc:rc + length]))
                rc += length
            elif op == "S":
                rc += length
            # H: no-op

        # validation: bounds incl. negative-wrap, alphabet.  A zero-span read
        # touches no position and is accepted at any POS.
        span = out
        if span > 0 and (rec.pos < -reflen or rec.pos + span > reflen):
            raise IndexError(
                f"read at pos {rec.pos} spans [{rec.pos}, {rec.pos + span})"
                f" outside reference {rec.refname!r} of length {reflen} "
                "(reference would IndexError here too)")

        def bad_alphabet():
            raise KeyError(
                f"read at pos {rec.pos} contains an out-of-alphabet base "
                "(input contract is uppercase ACGTN; the reference would "
                "KeyError here too, though for insertion motifs only "
                "later, in its reformat pass)")

        for _start, codes in my_base:
            if codes.size and codes.max() == INVALID_SYMBOL:
                bad_alphabet()
        for _local, motif in my_ins:
            mcodes = BASE_TO_CODE[
                np.frombuffer(motif.encode("ascii"), dtype=np.uint8)]
            if mcodes.size and mcodes.max() == INVALID_SYMBOL:
                bad_alphabet()

        for local, motif in my_ins:
            self.insertions.contig_ids.append(ci)
            self.insertions.local_pos.append(local)
            self.insertions.motifs.append(motif)
        if span == 0:
            return []

        if len(my_base) == 1 and not my_gaps:
            row = my_base[0][1]
        else:
            row = np.empty(span, dtype=np.uint8)
            for start, codes in my_base:
                row[start: start + len(codes)] = codes
            for start, length in my_gaps:
                row[start: start + length] = GAP

        # maxdel gate (sam2consensus.py:210-218): literal '-' in SEQ counts
        # too; when it trips, gap bases are skipped but positions advance
        n_gap_syms = int((row == GAP).sum())
        if self.maxdel is not None and n_gap_syms > self.maxdel:
            row = np.where(row == GAP, np.uint8(PAD_CODE), row)

        if rec.pos >= 0:
            return self._segmented(offset + rec.pos, row)
        neg = min(span, -rec.pos)          # bases in the wrapped tail
        out = self._segmented(offset + reflen + rec.pos, row[:neg])
        if span > neg:
            out.extend(self._segmented(offset, row[neg:]))
        return out

    def _segmented(self, start: int, row: np.ndarray
                   ) -> List[Tuple[int, np.ndarray]]:
        """Rows wider than ``segment_width`` split at exact W boundaries."""
        w = self.segment_width
        if w <= 0 or len(row) <= w:
            return [(start, row)] if len(row) else []
        return [(start + off, row[off:off + w])
                for off in range(0, len(row), w)]


def _expand_segments(starts: List[int], lengths: List[int]) -> np.ndarray:
    """Concatenate ``arange(start, start+len)`` for all segments, vectorized."""
    if not starts:
        return np.zeros(0, dtype=np.int64)
    starts_a = np.asarray(starts, dtype=np.int64)
    lens_a = np.asarray(lengths, dtype=np.int64)
    total = int(lens_a.sum())
    ends = np.cumsum(lens_a)
    idx = np.arange(total, dtype=np.int64)
    seg_base = np.repeat(ends - lens_a, lens_a)
    return idx - seg_base + np.repeat(starts_a, lens_a)


def group_insertions(events: InsertionEvents, layout: GenomeLayout):
    """Group raw insertion events into the dense per-key column table inputs.

    Returns ``None`` when there are no events, else a dict with
    ``key_contig``/``key_local`` int32 [K] (unique sites ordered by
    (contig, local)), ``key_flat`` int64 [K] (flat position, -1 for an
    end-of-contig site), ``max_cols``, ``n_cols`` int32 [K] and the
    per-(motif occurrence, column) events ``ev_key``/``ev_col``/``ev_code``
    int32 [E].
    """
    if len(events) == 0:
        return None
    contig, local, motif_lens, motif_chars = events.to_arrays()
    all_codes = BASE_TO_CODE[motif_chars]

    # composite sort key (contig, local); local may be negative, so bias it
    bias = 1 << 40
    composite = (contig << 41) + (local + bias)
    uniq, inverse = np.unique(composite, return_inverse=True)
    key_contig = (uniq >> 41).astype(np.int32)
    key_local = ((uniq & ((1 << 41) - 1)) - bias).astype(np.int32)

    n_cols = np.zeros(len(uniq), dtype=np.int64)
    np.maximum.at(n_cols, inverse, motif_lens)
    max_cols = int(n_cols.max())

    ev_key = np.repeat(inverse, motif_lens).astype(np.int32)
    ev_col = _expand_segments([0] * len(motif_lens),
                              list(motif_lens)).astype(np.int32)
    ev_code = all_codes.astype(np.int32)

    reflens = layout.lengths[key_contig]
    flat = layout.offsets[key_contig] + key_local
    key_flat = np.where(key_local < reflens, flat, -1).astype(np.int64)
    neg = key_local < 0
    if neg.any():
        key_flat = np.where(
            neg, layout.offsets[key_contig] + reflens + key_local, key_flat)

    return {
        "key_contig": key_contig,
        "key_local": key_local,
        "key_flat": key_flat,
        "max_cols": max_cols,
        "n_cols": n_cols.astype(np.int32),
        "ev_key": ev_key,
        "ev_col": ev_col,
        "ev_code": ev_code,
    }
