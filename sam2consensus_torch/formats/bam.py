"""BAM record decode: binary alignment records -> the encoder's segment rows.

Copy of ``sam2consensus_tpu/formats/bam.py`` (pinned by
``tests/test_torch_copies.py`` and ``tests/test_torch_formats.py``), with
its tolerant-decode hooks (``bad_sink``, ``on_bad``, ``collect_bad``,
``_absorb_record``) and its checkpoint-resume record skip
(``byte_offset``, ``skip_to``, ``skip_lines``).  One difference: the
native lane counts a replayed record's row in C (``_count_row``) where
the reference uses ``np.add.at``.

BAM (SAM spec §4) is the binary twin of SAM inside a BGZF container
(``formats/bgzf.py``): records carry CIGAR as packed ``u32`` ops and SEQ as
4-bit nibbles, so nothing here builds a SAM text line.  Records go straight
into the encoder's segment rows with the reference's RNAME/POS/CIGAR/SEQ
semantics (no FLAG/MAPQ filtering, ``sam2consensus.py:195-206``; a record
with zero CIGAR ops is the binary form of ``CIGAR == "*"`` and is skipped
the same way).  Two encoders:

* :class:`NativeBamEncoder`: the C++ record decoder (``s2c_decode_bam``)
  on the row path of ``encoder.native_encoder.NativeReadEncoder``, or on
  its fused host count under ``--pileup host``;
* :class:`BamSegmentEncoder` (``--decoder py``): a vectorized numpy fast
  lane for single-op ``M`` reads, and every other record replayed through
  the Python :class:`~..encoder.events.ReadEncoder`, which owns
  validation, the maxdel gate, insertion events and segmentation.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..constants import PAD_CODE
from ..core.cigar import BAM_OPS as CIGAR_OPS
from ..core.cigar import render_ops
from ..encoder.native_encoder import NativeReadEncoder, _count_row
from ..io.sam import Contig

BAM_MAGIC = b"BAM\x01"

#: BAM 4-bit seq nibble -> ASCII ("=ACMGRSVTWYHKDBN", spec table)
NIB_TO_CHAR = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8).copy()

#: BAM nibble -> consensus symbol code (constants.ALPHABET); anything
#: outside uppercase ACGTN is INVALID (255), which triggers the oracle's
#: exact strict-mode KeyError downstream — identical to how the same
#: character in SAM text would fail.
NIB_TO_CODE = np.full(16, 255, dtype=np.uint8)
NIB_TO_CODE[1] = 1   # A
NIB_TO_CODE[2] = 2   # C
NIB_TO_CODE[4] = 3   # G
NIB_TO_CODE[8] = 5   # T
NIB_TO_CODE[15] = 4  # N


class BamParseError(ValueError):
    """Structurally broken BAM payload (bad magic, impossible sizes)."""

    def __init__(self, msg: str, offset: int = -1):
        super().__init__(msg)
        self.offset = offset


@dataclass(frozen=True)
class BamRecord:
    """One mapped alignment, fields pre-split from the binary record.

    Quacks like :class:`~..io.sam.SamRecord` (``refname``/``pos``/
    ``cigar``/``seq``) for the oracle and the golden encoder, but carries
    ``ops`` pre-parsed so the encoder's binary fast path never rebuilds
    or re-regexes CIGAR text."""

    refname: str
    pos: int                              # 0-based leftmost position
    ops: Tuple[Tuple[int, str], ...]      # ((length, op), ...)
    seq: str

    @property
    def cigar(self) -> str:
        """CIGAR text, rendered on demand (oracle/walker compatibility)."""
        return render_ops(self.ops)


def read_bam_header(fh) -> Tuple[List[Contig], str]:
    """Parse the BAM header from a binary stream positioned at byte 0:
    magic, embedded SAM header text, and the binary reference table
    (the authoritative one — it is what refIDs index).  Returns
    (contigs, sam_header_text); the stream is left at the first
    alignment record."""
    magic = fh.read(4)
    if magic != BAM_MAGIC:
        raise BamParseError(
            f"not a BAM stream (magic {magic!r}, expected {BAM_MAGIC!r})")
    l_text = struct.unpack("<i", _read_exact(fh, 4, "l_text"))[0]
    if l_text < 0:
        raise BamParseError(f"negative header length {l_text}")
    text = _read_exact(fh, l_text, "header text").decode(
        "utf-8", errors="replace")
    n_ref = struct.unpack("<i", _read_exact(fh, 4, "n_ref"))[0]
    if n_ref < 0:
        raise BamParseError(f"negative reference count {n_ref}")
    contigs: List[Contig] = []
    for i in range(n_ref):
        l_name = struct.unpack("<i", _read_exact(fh, 4, "l_name"))[0]
        if not 0 < l_name <= 1 << 20:
            raise BamParseError(f"reference {i}: bad name length {l_name}")
        raw = _read_exact(fh, l_name, "ref name")
        name = raw.rstrip(b"\x00").decode("ascii", errors="replace")
        l_ref = struct.unpack("<i", _read_exact(fh, 4, "l_ref"))[0]
        contigs.append(Contig(name, l_ref))
    return contigs, text


def _read_exact(fh, n: int, what: str) -> bytes:
    data = fh.read(n)
    if len(data) != n:
        raise BamParseError(
            f"BAM stream truncated reading {what} "
            f"({len(data)}/{n} bytes)")
    return data


#: fixed BAM record prefix: block_size, refID, pos, l_read_name, mapq,
#: bin, n_cigar_op, flag, l_seq  (bin_mq_nl and flag_nc split into their
#: little-endian component fields)
_REC_FIXED = struct.Struct("<iiiBBHHHi")


class _RecordIndex:
    """Offsets + fixed fields for the complete records in one buffer.

    With ``collect_bad``, record-bounded structural damage (fields
    overrun a block_size whose extent IS known) becomes an index ENTRY
    flagged in ``bad`` (exception in ``bad_exc``) instead of a raise —
    keeping the index a faithful walk of the raw record stream, so
    checkpoint-resume record-count skips stay exact (the native lane's
    ``_skip_whole_records`` semantics).  Framing loss (block_size < 32)
    raises in every mode.
    """

    __slots__ = ("off", "refid", "pos", "l_rn", "n_cig", "l_seq",
                 "consumed", "n", "base", "bad", "bad_exc")

    def __init__(self, buf, base_offset: int, collect_bad: bool = False):
        off: List[int] = []
        refid: List[int] = []
        pos: List[int] = []
        l_rn: List[int] = []
        n_cig: List[int] = []
        l_seq: List[int] = []
        bad: List[bool] = []
        self.bad_exc: Dict[int, BamParseError] = {}
        p = 0
        size = len(buf)
        self.base = base_offset
        unpack = _REC_FIXED.unpack_from
        while p + 4 <= size:
            if p + 24 > size:
                break
            (block_size, rid, ps, lrn, _mapq, _bin, nc, _flag,
             lsq) = unpack(buf, p)
            if block_size < 32:
                raise BamParseError(
                    f"BAM record at offset {base_offset + p} claims "
                    f"block_size {block_size} (< 32)", base_offset + p)
            if p + 4 + block_size > size:
                break
            # fields must fit the record (the C lane's identical check,
            # decoder.cpp): without it a corrupt l_seq/n_cigar makes the
            # decode lanes read the NEXT record's bytes as SEQ
            is_bad = (lsq < 0 or 32 + lrn + 4 * nc + (lsq + 1) // 2 + lsq
                      > block_size)
            if is_bad:
                exc = BamParseError(
                    f"BAM record at offset {base_offset + p}: fields "
                    f"overrun the record (block_size {block_size}, "
                    f"l_read_name {lrn}, n_cigar {nc}, l_seq {lsq})",
                    base_offset + p)
                exc.rec_len = 4 + int(block_size)
                if not collect_bad:
                    raise exc
                self.bad_exc[len(off)] = exc
            off.append(p)
            refid.append(rid)
            pos.append(ps)
            l_rn.append(lrn)
            n_cig.append(nc)
            l_seq.append(lsq)
            bad.append(is_bad)
            p += 4 + block_size
        self.consumed = p
        self.n = len(off)
        self.off = np.asarray(off, dtype=np.int64)
        self.refid = np.asarray(refid, dtype=np.int64)
        self.pos = np.asarray(pos, dtype=np.int64)
        self.l_rn = np.asarray(l_rn, dtype=np.int64)
        self.n_cig = np.asarray(n_cig, dtype=np.int64)
        self.l_seq = np.asarray(l_seq, dtype=np.int64)
        self.bad = np.asarray(bad, dtype=bool)


def _gather(buf: np.ndarray, offs: np.ndarray, width: int) -> np.ndarray:
    """``buf[offs[i] : offs[i]+width]`` for all i, as an [n, width] array."""
    if len(offs) == 0:
        return np.zeros((0, width), dtype=np.uint8)
    return buf[offs[:, None] + np.arange(width, dtype=np.int64)[None, :]]


def decode_seq(buf: np.ndarray, seq_off: int, l_seq: int) -> str:
    """One record's SEQ as text (slow lane / oracle path)."""
    nb = (l_seq + 1) // 2
    packed = buf[seq_off:seq_off + nb]
    chars = np.empty(nb * 2, dtype=np.uint8)
    chars[0::2] = NIB_TO_CHAR[packed >> 4]
    chars[1::2] = NIB_TO_CHAR[packed & 0xF]
    return chars[:l_seq].tobytes().decode("ascii")


def decode_ops(buf: np.ndarray, cig_off: int,
               n_cig: int) -> Tuple[Tuple[int, str], ...]:
    """One record's CIGAR as ((length, op), ...) (slow lane path)."""
    raw = buf[cig_off:cig_off + 4 * n_cig]
    if len(raw) != 4 * n_cig:
        raise BamParseError(
            f"CIGAR runs past the record ({len(raw)}/{4 * n_cig} bytes)")
    arr = np.ascontiguousarray(raw).view("<u4")
    if len(arr):
        bad = int((arr & 0xF).max())
        if bad >= len(CIGAR_OPS):
            raise BamParseError(
                f"CIGAR op code {bad} outside MIDNSHP=X")
    return tuple((int(v >> 4), CIGAR_OPS[v & 0xF]) for v in arr)


class BamRecordReader:
    """Streaming BAM record iterator over an inflated byte source.

    ``source`` is any binary file-like already positioned past the BAM
    header (``read_bam_header``).  Iterates :class:`BamRecord` for
    mapped records (``n_cigar_op > 0``), counting EVERY record — the
    binary analogue of a SAM body line — through ``count_cb`` so
    progress totals match the text path's semantics."""

    CHUNK = 1 << 22

    def __init__(self, source, count_cb=None, bytes_cb=None):
        self._src = source
        self._count_cb = count_cb
        self._bytes_cb = bytes_cb

    def chunks(self) -> Iterator[Tuple[np.ndarray, "_RecordIndex"]]:
        """Yield (buffer, record-index) pairs spanning the whole stream;
        records never straddle a yielded buffer.  With ``on_bad`` set,
        record-bounded structural damage becomes flagged INDEX ENTRIES
        (``idx.bad``) — still counted, still skippable by position —
        instead of a raise."""
        pending = b""
        base = 0
        while True:
            data = self._src.read(self.CHUNK)
            if not data:
                if pending:
                    raise BamParseError(
                        f"BAM stream ends mid-record at offset {base} "
                        f"({len(pending)} dangling bytes)", base)
                return
            buf = pending + data if pending else data
            idx = _RecordIndex(buf, base,
                               collect_bad=self.on_bad is not None)
            if idx.consumed == 0 and len(buf) > self.CHUNK * 4:
                raise BamParseError(
                    f"BAM record at offset {base} larger than "
                    f"{len(buf)} bytes — corrupt block_size?", base)
            if idx.n:
                arr = np.frombuffer(buf, dtype=np.uint8,
                                    count=idx.consumed)
                if self._bytes_cb is not None:
                    self._bytes_cb(idx.consumed)
                yield arr, idx
            pending = buf[idx.consumed:]
            base += idx.consumed

    def __iter__(self) -> Iterator[BamRecord]:
        for buf, idx in self.chunks():
            cig_off = idx.off + 36 + idx.l_rn
            seq_off = cig_off + 4 * idx.n_cig
            for k in range(idx.n):
                if self._count_cb is not None:
                    self._count_cb(1)
                if idx.bad[k]:
                    # flagged at index time: fields overrun the record's
                    # block_size, so decoding would read the NEXT
                    # record's bytes — absorb the INDEX exception, never
                    # walk the entry (idx.bad is always all-False in
                    # strict mode: the index raised instead)
                    self.on_bad(int(idx.base + idx.off[k]),
                                idx.bad_exc[k])
                    continue
                if idx.n_cig[k] == 0:
                    continue                      # CIGAR "*" analogue
                try:
                    rec = record_at(buf, idx, k, int(cig_off[k]),
                                    int(seq_off[k]), self.refname_fn)
                except BamParseError as exc:
                    # bad CIGAR op / refID outside the table: bounded
                    # to this indexed record, so tolerant mode skips
                    # exactly it
                    if self.on_bad is not None:
                        self.on_bad(int(idx.base + idx.off[k]), exc)
                        continue
                    raise
                yield rec
            del buf

    #: patched by the owning stream: refid -> display name ("*" for -1)
    refname_fn = staticmethod(lambda refid: "*")

    #: tolerant hook: ``on_bad(abs_offset, exc)`` absorbs record-bounded
    #: damage (None = strict raise, the default)
    on_bad = None


def record_at(buf: np.ndarray, idx: "_RecordIndex", k: int,
              cig_off: int, seq_off: int, refname_fn) -> BamRecord:
    return BamRecord(
        refname=refname_fn(int(idx.refid[k])),
        pos=int(idx.pos[k]),
        ops=decode_ops(buf, cig_off, int(idx.n_cig[k])),
        seq=decode_seq(buf, seq_off, int(idx.l_seq[k])))


class BamReadStream:
    """BAM-side twin of :class:`~..io.sam.ReadStream`.

    Same counting surface (``n_lines``/``n_bytes``/``add_lines``/
    ``on_lines``) so the CLI's progress accounting and the backends'
    stats work unchanged; ``records()`` feeds the oracle / pure-python
    encoder, and ``make_encoder`` (consumed by
    ``JaxBackend._make_encoder``) builds the vectorized
    :class:`BamSegmentEncoder` over the raw record stream.  Checkpoint
    resume (``skip_to``) is a record-count skip — BGZF reads are
    re-inflated up to the resume point, in parallel on a pool host.
    """

    format = "bam"

    def __init__(self, handle, refnames: List[str], on_lines=None):
        self.handle = handle
        self.refnames = list(refnames)
        self.on_lines = on_lines
        self.n_lines = 0
        self.n_bytes = 0
        self._skip_records = 0

    def refname(self, refid: int) -> str:
        if refid < 0:
            return "*"
        if refid >= len(self.refnames):
            raise BamParseError(
                f"record refID {refid} outside the reference table "
                f"(n_ref={len(self.refnames)})")
        return self.refnames[refid]

    def add_lines(self, k: int) -> None:
        if k:
            self.n_lines += k
            if self.on_lines is not None:
                self.on_lines(self.n_lines)

    def add_bytes(self, k: int) -> None:
        if k:
            self.n_bytes += k

    def byte_offset(self) -> int:
        """Uncompressed BAM offset matching ``n_lines`` — not meaningful
        across the fast-lane batching, so checkpoint resume uses record
        counts (-1 = use ``skip_lines``)."""
        return -1

    def skip_to(self, byte_offset: int, k: int) -> str:
        self.skip_lines(k)
        return "lines" if k > 0 else "none"

    def skip_lines(self, k: int) -> None:
        """Arrange for the next ``records()`` / encoder pass to drop the
        first ``k`` records (they still count toward ``n_lines``)."""
        if k > 0:
            self._skip_records = k
            self.n_lines = 0

    def _reader(self) -> BamRecordReader:
        rd = BamRecordReader(self.handle, count_cb=self.add_lines,
                             bytes_cb=self.add_bytes)
        rd.refname_fn = self.refname
        return rd

    def records(self, on_bad=None) -> Iterator[BamRecord]:
        """Mapped records in file order (oracle / python-encoder lane).

        ``on_bad(raw, exc)``: tolerant hook matching the text
        ``ReadStream.records`` signature — record-bounded structural
        damage reports a rendered placeholder instead of raising."""
        skip = self._skip_records
        self._skip_records = 0
        rd = self._reader()
        if on_bad is not None:
            rd.on_bad = lambda abs_off, exc: on_bad(
                f"<bam record at offset {abs_off}>", exc)
        for rec in rd:
            if skip > 0:
                skip -= 1
                continue
            yield rec

    def make_encoder(self, layout, cfg, acc=None, bad_sink=None):
        """The jax backend's decode hook.

        Preferred path: the C++ binary record decoder
        (``native/decoder.cpp s2c_decode_bam`` via
        :class:`NativeBamEncoder`) — same slab protocol and fused
        host-counting as the native SAM text path, minus the text
        tokenization it never needed.  Falls back to the pure-python
        :class:`BamSegmentEncoder` (the portable semantics twin) when
        the native library is unavailable or ``--decoder py`` forces it.
        """
        from .. import native as _native
        from ..encoder.events import resolve_segment_width
        from ..ops.pileup import HostPileupAccumulator

        decoder = getattr(cfg, "decoder", "auto")
        lib = _native.load() if decoder != "py" else None
        if lib is not None and hasattr(lib, "s2c_decode_bam"):
            fuse = (isinstance(acc, HostPileupAccumulator)
                    and not getattr(cfg, "paranoid", False))
            enc = NativeBamEncoder(
                layout, self, maxdel=cfg.maxdel, strict=cfg.strict,
                segment_width=resolve_segment_width(
                    getattr(cfg, "segment_width", 0)),
                accumulate_into=acc.counts_host() if fuse else None,
                bad_sink=bad_sink)
            return enc, enc.encode_batches()
        if decoder == "native":
            raise RuntimeError(
                "--decoder native requested but the C++ decoder is "
                f"unavailable: {_native.load_error()}")
        enc = BamSegmentEncoder(
            layout, self, maxdel=cfg.maxdel, strict=cfg.strict,
            chunk_reads=getattr(cfg, "chunk_reads", 262144),
            segment_width=getattr(cfg, "segment_width", 0),
            bad_sink=bad_sink)
        return enc, enc.encode_batches()


class BamSegmentEncoder:
    """Vectorized BAM → :class:`SegmentBatch` encoder.

    The fast lane turns a whole chunk's single-op-M reads into segment
    rows with numpy gathers (no per-read python); everything else —
    indels, clips, wrapped POS, invalid nibbles, unknown refs — replays
    per record through the golden :class:`ReadEncoder`, which is the
    single owner of validation semantics, the maxdel gate, insertion
    events and long-read segmentation.  Output batches are
    bucket-compatible with the SAM paths, so every accumulator and
    wire codec downstream runs unchanged.
    """

    def __init__(self, layout, stream: BamReadStream,
                 maxdel: Optional[int] = 150, strict: bool = True,
                 chunk_reads: int = 262144, segment_width: int = 0,
                 bad_sink=None):
        from ..encoder.events import ReadEncoder, resolve_segment_width

        self.layout = layout
        self.stream = stream
        self.strict = strict
        self.chunk_reads = max(1, chunk_reads)
        #: tolerant decode: absorbed in _encode_slow (the replay lane
        #: every malformed record routes through; the fast lane's
        #: filters re-route to slow before anything could raise)
        self.bad_sink = bad_sink
        # config policy -> concrete width (0 = segmentation off)
        seg_w = resolve_segment_width(segment_width)
        self._py = ReadEncoder(layout, maxdel=maxdel, strict=strict,
                               segment_width=seg_w)
        self.insertions = self._py.insertions
        self._seg_w = seg_w
        # refid -> (flat offset, length) over the BAM reference table,
        # routed through the layout's name index so duplicate-name
        # semantics (last LN wins) match the SAM text path exactly
        offs = []
        lens = []
        for name in stream.refnames:
            ci = layout.index.get(name)
            if ci is None:          # dup name pruned — cannot happen for
                offs.append(-1)     # layout built from this same table,
                lens.append(-1)     # but stay total
            else:
                offs.append(int(layout.offsets[ci]))
                lens.append(int(layout.lengths[ci]))
        self._ref_off = np.asarray(offs, dtype=np.int64)
        self._ref_len = np.asarray(lens, dtype=np.int64)

    @property
    def n_reads(self) -> int:
        return self._py.n_reads

    @property
    def n_skipped(self) -> int:
        return self._py.n_skipped

    counts_fused = False

    def encode_batches(self):
        """Yield SegmentBatches of ≲``chunk_reads`` reads each."""
        skip = self.stream._skip_records
        self.stream._skip_records = 0

        mats: List[Tuple[np.ndarray, np.ndarray, int]] = []  # (starts, mat, n_real_cells)
        rows: List[Tuple[int, np.ndarray]] = []
        batch_reads = 0
        reader = self.stream._reader()
        if self.bad_sink is not None:
            reader.on_bad = self._absorb_record
        for buf, idx in reader.chunks():
            self.stream.add_lines(idx.n)
            lo = 0
            if skip > 0:
                lo = min(skip, idx.n)
                skip -= lo
            sel = np.arange(lo, idx.n, dtype=np.int64)
            if len(sel) == 0:
                continue
            bad = idx.bad[sel]
            if bad.any():
                # index-flagged structural damage (fields overrun the
                # record): absorb the INDEX exception and drop the entry
                # before the lane split — walking it would read the next
                # record's bytes as CIGAR/SEQ (strict mode never gets
                # here: the index raised at build time)
                for k in sel[bad]:
                    self._absorb_record(int(idx.base + idx.off[k]),
                                        idx.bad_exc[int(k)])
                sel = sel[~bad]
                if len(sel) == 0:
                    continue
            n_cig = idx.n_cig[sel]
            mapped = sel[n_cig > 0]          # CIGAR "*" analogue dropped
            if len(mapped) == 0:
                continue
            cig_off = idx.off[mapped] + 36 + idx.l_rn[mapped]
            seq_off = cig_off + 4 * idx.n_cig[mapped]

            fast, slow = self._split_fast(buf, idx, mapped, cig_off)
            if len(fast):
                f_sel = np.searchsorted(mapped, fast)
                n_rows, n_cells, extra_slow = self._encode_fast(
                    buf, idx, fast, seq_off[f_sel], mats)
                batch_reads += len(fast) - len(extra_slow)
                if len(extra_slow):
                    slow = np.sort(np.concatenate([slow, extra_slow]))
            for k in slow:
                ks = int(np.searchsorted(mapped, k))
                abs_off = int(idx.base + idx.off[k])
                try:
                    rec = record_at(buf, idx, int(k), int(cig_off[ks]),
                                    int(seq_off[ks]), self.stream.refname)
                except BamParseError as exc:
                    # bad CIGAR op / refID outside the table — bounded
                    # to this already-indexed (and already-counted)
                    # record
                    self._absorb_record(abs_off, exc)
                    continue
                if self._encode_slow(rec, rows, offset=abs_off):
                    batch_reads += 1
            if batch_reads >= self.chunk_reads:
                yield self._flush(mats, rows, batch_reads)
                mats, rows, batch_reads = [], [], 0
        if mats or rows or batch_reads:
            yield self._flush(mats, rows, batch_reads)

    # -- lanes -------------------------------------------------------------
    def _split_fast(self, buf, idx, mapped, cig_off):
        """Partition mapped record indices into (fast, slow) lanes."""
        n_cig = idx.n_cig[mapped]
        cand = n_cig == 1
        if cand.any():
            first = np.ascontiguousarray(
                _gather(buf, cig_off[cand], 4)).view("<u4").reshape(-1)
            op_m = (first & 0xF) == 0
            len_ok = (first >> 4) == idx.l_seq[mapped][cand]
            good = np.zeros(len(mapped), dtype=bool)
            good[np.nonzero(cand)[0]] = op_m & len_ok
        else:
            good = np.zeros(len(mapped), dtype=bool)
        refid = idx.refid[mapped]
        pos = idx.pos[mapped]
        in_table = (refid >= 0) & (refid < len(self._ref_off))
        good &= in_table
        if good.any():
            safe = np.clip(refid, 0, len(self._ref_len) - 1)
            rl = np.where(in_table, self._ref_len[safe], -1)
            good &= (pos >= 0) & (pos + idx.l_seq[mapped] <= rl) \
                & (idx.l_seq[mapped] > 0)
        return mapped[good], mapped[~good]

    def _encode_fast(self, buf, idx, fast, seq_off, mats):
        """Vectorized nibble decode for same-length groups; returns
        (rows_emitted, cells, indices re-routed to the slow lane)."""
        l_seq = idx.l_seq[fast]
        extra_slow: List[int] = []
        n_rows = n_cells = 0
        for L in np.unique(l_seq):
            grp = l_seq == L
            g_idx = fast[grp]
            nb = (int(L) + 1) // 2
            packed = _gather(buf, seq_off[grp], nb)
            codes = np.empty((len(g_idx), nb * 2), dtype=np.uint8)
            codes[:, 0::2] = NIB_TO_CODE[packed >> 4]
            codes[:, 1::2] = NIB_TO_CODE[packed & 0xF]
            codes = codes[:, :int(L)]
            bad = (codes == 255).any(axis=1)
            if bad.any():
                # invalid nibble → slow-lane replay raises the oracle's
                # exact KeyError (strict) / counts a skip (permissive)
                extra_slow.extend(int(i) for i in g_idx[bad])
                good = ~bad
                g_idx = g_idx[good]
                codes = codes[good]
                if len(g_idx) == 0:
                    continue
            starts = (self._ref_off[idx.refid[g_idx]]
                      + idx.pos[g_idx]).astype(np.int64)
            self._py.n_reads += len(g_idx)
            if self._seg_w and int(L) > self._seg_w:
                starts, codes = _segment_matrix(starts, codes,
                                                self._seg_w)
            mats.append((starts, codes, len(g_idx) * int(L)))
            n_rows += len(codes)
            n_cells += len(g_idx) * int(L)
        return n_rows, n_cells, np.asarray(sorted(extra_slow),
                                           dtype=np.int64)

    def _absorb_record(self, abs_off: int, exc: BaseException) -> None:
        """One record-bounded BAM failure (structural overrun, bad
        CIGAR op, refID outside the table): quarantine / skip /
        strict-raise — the python twin of the native lane's
        ``_fallback_record`` tolerance protocol."""
        from ..ingest.badrecords import mark_offset

        if self.bad_sink is not None:
            self.bad_sink.record(f"<bam record at offset {abs_off}>",
                                 exc, offset=abs_off)
            self._py.n_skipped += 1
            return
        # no sink: structural parse damage raises in BOTH modes —
        # legacy permissive mode tolerates encode-level contract errors
        # only, matching the native lane's _fallback_record
        mark_offset(exc, abs_off)
        raise exc

    def _encode_slow(self, rec: BamRecord,
                     rows: List[Tuple[int, np.ndarray]],
                     offset: Optional[int] = None) -> bool:
        from ..encoder.events import EncodeError, render_record
        from ..ingest.badrecords import mark_offset

        try:
            new_rows = self._py.encode_record(rec)
        except (EncodeError, KeyError, IndexError) as exc:
            if self.bad_sink is not None:
                self.bad_sink.record(render_record(rec), exc,
                                     offset=offset)
                self._py.n_skipped += 1
                return False
            if self.strict:
                mark_offset(exc, offset)
                raise
            self._py.n_skipped += 1
            return False
        rows.extend(new_rows)
        self._py.n_reads += 1
        return True

    # -- batch assembly ----------------------------------------------------
    def _flush(self, mats, rows, batch_reads):
        """Merge fast matrices + slow rows into one padded SegmentBatch
        (same bucket invariants as ``pack_rows``)."""
        from ..encoder.events import SegmentBatch, _bucket_width

        per_w = {}
        n_events = 0
        for starts, mat, cells in mats:
            per_w.setdefault(_bucket_width(mat.shape[1]),
                             []).append((starts, mat))
            n_events += cells
        for start, row in rows:
            w = _bucket_width(len(row))
            per_w.setdefault(w, []).append((start, row))
            n_events += len(row) - int((row == PAD_CODE).sum())

        buckets = {}
        for w, items in per_w.items():
            total = sum(len(it[0]) if isinstance(it[0], np.ndarray) else 1
                        for it in items)
            s_pad = max(1024, 1 << (total - 1).bit_length())
            mat = np.full((s_pad, w), PAD_CODE, dtype=np.uint8)
            st = np.zeros(s_pad, dtype=np.int32)
            r = 0
            for it in items:
                if isinstance(it[0], np.ndarray):
                    starts, m = it
                    st[r:r + len(starts)] = starts
                    mat[r:r + len(starts), : m.shape[1]] = m
                    r += len(starts)
                else:
                    start, row = it
                    st[r] = start
                    mat[r, : len(row)] = row
                    r += 1
            buckets[w] = (st, mat)
        return SegmentBatch(buckets=buckets, n_reads=batch_reads,
                            n_events=n_events)


class NativeBamEncoder(NativeReadEncoder):
    """C++ binary record decode: BGZF-inflated bytes → SegmentBatches.

    A :class:`~..encoder.native_encoder.NativeReadEncoder` whose byte
    feed is whole BAM records instead of text lines: slab persistence,
    width adaptation, fused uint8-shadow counting, the python twin and
    batch assembly are all inherited, with ``s2c_decode_bam`` doing the
    per-record work and three replay lanes handled here:

    * ``status 2`` (flagged record): the ONE record replays through the
      golden python encoder, so strict-mode exception type/message are
      oracle-identical (corrupt framing raises :class:`BamParseError`
      with the record offset);
    * overflow records (``span > width`` — the segmented long-read
      lane — and negative-POS wraps): replayed per record through the
      python twin, whose segmentation splits them into W-wide rows;
    * trailing partial record at stream end: :class:`BamParseError`
      (mid-record truncation, precise offset).
    """

    #: bytes pulled per read() from the (block-parallel) BGZF reader
    CHUNK = 1 << 22

    def __init__(self, layout, stream: BamReadStream,
                 maxdel: Optional[int] = 150, strict: bool = True,
                 segment_width: int = 0, accumulate_into=None,
                 bad_sink=None):
        super().__init__(layout, maxdel=maxdel, strict=strict,
                         on_lines=stream.add_lines,
                         on_bytes=stream.add_bytes,
                         accumulate_into=accumulate_into,
                         segment_width=segment_width,
                         bad_sink=bad_sink)
        self.stream = stream
        ci = []
        off = []
        ln = []
        for name in stream.refnames:
            k = layout.index.get(name)
            if k is None:       # unreachable for layouts built from this
                ci.append(-1)   # table; stay total
                off.append(0)
                ln.append(0)
            else:
                ci.append(int(k))
                off.append(int(layout.offsets[k]))
                ln.append(int(layout.lengths[k]))
        self._ref_ci = np.asarray(ci, dtype=np.int32)
        self._ref_off = np.asarray(off, dtype=np.int64)
        self._ref_lenv = np.asarray(ln, dtype=np.int64)

    def encode_batches(self) -> Iterator["SegmentBatch"]:
        self._probed = False
        self._new_slab()
        self._fallback_rows = []
        self._batch_reads = 0
        self._batch_events = 0

        ins_cap = 1 << 16
        chars_cap = 1 << 20
        ovf_cap = 4096
        out = np.zeros(16, dtype=np.int64)
        skip = self.stream._skip_records
        self.stream._skip_records = 0

        pending = b""
        src = self.stream.handle
        stream_off = 0          # absolute offset of `pending`'s start
        eof = False
        while not eof or pending:
            data_b = src.read(self.CHUNK)
            if not data_b:
                eof = True
                if not pending:
                    break
                buf = pending
            else:
                buf = pending + data_b if pending else data_b
            data = np.frombuffer(buf, dtype=np.uint8)
            offset = 0
            while offset < len(data):
                if skip > 0:
                    adv, skip = self._skip_whole_records(data, offset,
                                                         skip)
                    if adv == 0:
                        break               # need more bytes
                    offset += adv
                    continue
                chunk = data[offset:]
                ic = np.empty(ins_cap, dtype=np.int32)
                il = np.empty(ins_cap, dtype=np.int32)
                im = np.empty(ins_cap, dtype=np.int32)
                ich = np.empty(chars_cap, dtype=np.uint8)
                ovf = np.empty(ovf_cap, dtype=np.int64)

                fill = self._fill
                self._lib.s2c_decode_bam(
                    np.ascontiguousarray(chunk), len(chunk),
                    self._ref_ci, self._ref_off, self._ref_lenv,
                    len(self._ref_ci),
                    -1 if self.maxdel is None else self.maxdel,
                    self._c_strict,
                    self._slab_w,
                    self._starts[fill:], self._codes[fill:],
                    len(self._starts) - fill,
                    ic, il, im, ins_cap,
                    ich, chars_cap,
                    ovf, ovf_cap,
                    out,
                    self._acc_u8, self._acc_ovf, self._acc_len,
                    1 if self._acc_direct else 0)

                (n_rows, n_reads, n_skipped, consumed, n_ins, n_chars,
                 status, err_off, n_events, n_lines, n_overflow,
                 _max_span) = out[:12]
                self._banked += int(out[12])

                self._fill = 0 if self._acc is not None \
                    else fill + int(n_rows)
                if n_ins:
                    self.insertions.array_chunks.append(
                        (ic[:n_ins].copy(), il[:n_ins].copy(),
                         im[:n_ins].copy(), ich[:n_chars].copy()))
                self._py.n_reads += int(n_reads)
                self._py.n_skipped += int(n_skipped)
                self._batch_reads += int(n_reads)
                self._batch_events += int(n_events)
                self._count_lines(int(n_lines))

                for k in range(int(n_overflow)):
                    # negative-POS wrap lane: python replay (segmented
                    # there too; wide positive reads are segmented in C)
                    self._fallback_record(
                        data, int(ovf[k]) + offset,
                        flagged_at=stream_off + int(ovf[k]) + offset)
                if int(out[13]) + n_overflow > max(64, n_reads // 64):
                    # many segmented/wrapped reads: widen future slabs
                    # toward the cap so each read needs fewer rows
                    self.width = min(self._width_cap, self.width * 2)
                elif (not self._probed and n_reads > 256
                      and _max_span > 0 and not n_overflow):
                    self._probed = True
                    from ..encoder.events import (MIN_BUCKET_W,
                                                  _bucket_width)

                    self.width = min(self._width_cap,
                                     max(MIN_BUCKET_W,
                                         _bucket_width(int(_max_span))))

                offset += int(consumed)
                self._count_bytes(int(consumed))
                if status == 2:
                    rec_len = self._fallback_record(
                        data, offset, flagged_at=stream_off + offset,
                        c_reason=int(out[14]))
                    self._count_lines(1)
                    self._count_bytes(rec_len)
                    offset += rec_len
                elif status == 1:
                    # capacity: a segmented wide read may need MANY free
                    # rows (ceil(span/width), not <=2 like the text
                    # path), so any partially-filled slab flushes —
                    # growing the insertion buffers instead would spin
                    # forever against the row constraint
                    if self._fill > 0:
                        batch = self._flush()
                        if batch is not None:
                            yield batch
                    elif consumed == 0:
                        if ins_cap >= (1 << 22):
                            # empty slab, generous buffers, still stuck:
                            # one record wider than the whole slab —
                            # replay it through the python twin (its
                            # row list is unbounded)
                            rec_len = self._fallback_record(
                                data, offset,
                                flagged_at=stream_off + offset)
                            self._count_lines(1)
                            self._count_bytes(rec_len)
                            offset += rec_len
                        else:
                            ins_cap *= 2
                            chars_cap *= 2
                            ovf_cap *= 2
                elif consumed == 0 or offset >= len(data):
                    break                   # partial record: need bytes

            stream_off += offset
            pending = bytes(buf[offset:]) if offset < len(buf) else b""
            if len(pending) > self.CHUNK * 4:
                # same guard as the python twin: a "partial record" that
                # keeps growing past 4 chunks is a corrupt block_size,
                # not a long read — fail with the offset instead of
                # buffering the rest of the file quadratically
                raise BamParseError(
                    f"BAM record at offset {stream_off} larger than "
                    f"{len(pending)} bytes — corrupt block_size?",
                    stream_off)
            if eof and pending:
                raise BamParseError(
                    f"BAM stream ends mid-record at offset {stream_off} "
                    f"({len(pending)} dangling bytes)", stream_off)
            if self._acc is not None and self._batch_reads:
                batch = self._flush()
                if batch is not None:
                    yield batch

        self.merge_shadow()
        batch = self._flush()
        if batch is not None:
            yield batch

    # -- replay lanes ------------------------------------------------------
    def _record_at_offset(self, data: np.ndarray, off: int,
                          flagged_at: Optional[int] = None
                          ) -> Tuple[BamRecord, int]:
        """Parse ONE record at ``off`` for python replay; raises
        :class:`BamParseError` (with the stream offset when known) on
        structural damage — the same surface a pure-python decode of
        this record would hit."""
        where = off if flagged_at is None else flagged_at
        if off + 24 > len(data):
            raise BamParseError(
                f"BAM record at offset {where} truncated", where)
        (block_size, refid, pos, l_rn, _mapq, _bin, n_cig, _flag,
         l_seq) = _REC_FIXED.unpack_from(data, off)
        if block_size < 32 or off + 4 + block_size > len(data):
            raise BamParseError(
                f"BAM record at offset {where} claims block_size "
                f"{block_size} past the stream", where)
        # from here the record's extent IS known (4 + block_size): any
        # damage below is bounded to this one record, so tolerant mode
        # can skip exactly it — mark the errors with rec_len so
        # _fallback_record knows how far to advance
        rec_len = 4 + int(block_size)
        cig_off = off + 36 + l_rn
        seq_off = cig_off + 4 * n_cig
        try:
            if l_seq < 0 or 32 + l_rn + 4 * n_cig + (l_seq + 1) // 2 \
                    + l_seq > block_size:
                raise BamParseError(
                    f"BAM record at offset {where}: fields overrun the "
                    f"record (block_size {block_size}, l_read_name "
                    f"{l_rn}, n_cigar {n_cig}, l_seq {l_seq})", where)
            rec = BamRecord(
                refname=self.stream.refname(int(refid)),
                pos=int(pos),
                ops=decode_ops(data, cig_off, int(n_cig)),
                seq=decode_seq(data, seq_off, int(l_seq)))
        except BamParseError as exc:
            exc.rec_len = rec_len
            raise
        return rec, rec_len

    def _fallback_record(self, data: np.ndarray, off: int,
                         flagged_at: Optional[int] = None,
                         c_reason: int = 0) -> int:
        """Replay one record through the golden python encoder (error
        parity / wrap split / segmentation); returns the record's total
        byte length.

        The BAM rung's tolerance point: with a sink attached
        (``--on-bad-record skip|quarantine``), any record-bounded
        failure — a replay-raised oracle error, or structural damage
        whose extent is still known (``BamParseError.rec_len``) — is
        absorbed per record; framing loss (truncation, a block_size
        past the stream) stays job-level in every mode."""
        from ..encoder.events import EncodeError, render_record
        from ..ingest.badrecords import mark_offset

        sink = self.bad_sink
        where = off if flagged_at is None else flagged_at
        try:
            rec, rec_len = self._record_at_offset(data, off, flagged_at)
        except BamParseError as exc:
            bounded_len = getattr(exc, "rec_len", None)
            if sink is not None and bounded_len is not None:
                self._quarantine(
                    sink, f"<bam record at offset {where}>", exc,
                    where, c_reason)
                return bounded_len
            raise
        try:
            rows = self._py.encode_record(rec)
        except (EncodeError, KeyError, IndexError) as exc:
            if sink is not None:
                self._quarantine(sink, render_record(rec), exc,
                                 where, c_reason)
                return rec_len
            if self.strict:
                mark_offset(exc, where)
                raise
            self._py.n_skipped += 1
            return rec_len
        self._py.n_reads += 1
        self._batch_reads += 1
        for start_flat, row in rows:
            if self._acc is not None:
                self._batch_events += _count_row(
                    self._lib, self._acc, start_flat, row, self._acc_len)
            else:
                self._fallback_rows.append((start_flat, row))
                self._batch_events += (len(row)
                                       - int((row == PAD_CODE).sum()))
        return rec_len

    def _skip_whole_records(self, data: np.ndarray, off: int,
                            skip: int) -> Tuple[int, int]:
        """Checkpoint-resume record skipping: advance over up to
        ``skip`` complete records; returns (bytes advanced, skip left).
        Skipped records still count as lines."""
        adv = 0
        while skip > 0 and off + adv + 4 <= len(data):
            bs = int.from_bytes(
                bytes(data[off + adv:off + adv + 4]), "little",
                signed=True)
            if bs < 32 or off + adv + 4 + bs > len(data):
                break
            adv += 4 + bs
            skip -= 1
            self._count_lines(1)
        return adv, skip


# -- writer (fixtures / format-conversion tooling; pure stdlib) ------------
#: ASCII char -> BAM seq nibble (strict: only the 16 spec chars)
CHAR_TO_NIB = {chr(c): i for i, c in enumerate(NIB_TO_CHAR)}

_OP_TO_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}


def encode_bam_record(refid: int, pos: int, cigar: str, seq: str,
                      read_name: bytes = b"r") -> bytes:
    """One binary alignment record (no BGZF framing)."""
    from ..core.cigar import split_ops

    ops = [] if cigar == "*" else split_ops(cigar)
    seq_s = "" if seq == "*" else seq
    l_seq = len(seq_s)
    name = read_name + b"\x00"
    cig = b"".join(struct.pack("<I", (n << 4) | _OP_TO_CODE[op])
                   for n, op in ops)
    nibs = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq_s):
        try:
            v = CHAR_TO_NIB[ch]
        except KeyError:
            raise ValueError(
                f"SEQ char {ch!r} has no BAM nibble encoding") from None
        if i % 2 == 0:
            nibs[i // 2] |= v << 4
        else:
            nibs[i // 2] |= v
    qual = b"\xff" * l_seq           # 0xff = unavailable, like "*"
    body = (struct.pack("<iiBBHHHiiii", refid, pos, len(name), 0, 0,
                        len(ops), 0, l_seq, -1, -1, 0)
            + name + cig + bytes(nibs) + qual)
    return struct.pack("<i", len(body)) + body


def bam_payload(contigs, records, header_text: str = "") -> bytes:
    """The complete UNCOMPRESSED BAM stream (header + records).

    ``records`` iterates (refname, pos0, cigar, seq); refnames index the
    ``contigs`` table ((name, length) pairs or Contig objects)."""
    pairs = [(c.name, c.length) if isinstance(c, Contig) else tuple(c)
             for c in contigs]
    if not header_text:
        header_text = "".join(
            f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in pairs)
    text = header_text.encode("utf-8")
    out = [BAM_MAGIC, struct.pack("<i", len(text)), text,
           struct.pack("<i", len(pairs))]
    index = {}
    for i, (n, ln) in enumerate(pairs):
        raw = n.encode("ascii") + b"\x00"
        out.append(struct.pack("<i", len(raw)))
        out.append(raw)
        out.append(struct.pack("<i", ln))
        index.setdefault(n, i)
    for k, (refname, pos0, cigar, seq) in enumerate(records):
        refid = index[refname] if refname != "*" else -1
        out.append(encode_bam_record(refid, pos0, cigar, seq,
                                     read_name=b"r%d" % k))
    return b"".join(out)


def write_bam(contigs, records, path: str, level: int = 6) -> str:
    """Write a BGZF-framed BAM file (fixtures/bench conversion)."""
    from .bgzf import write_bgzf

    return write_bgzf(bam_payload(contigs, records), path, level=level)


def sam_text_to_records(text: str):
    """Parse SAM text into ``(contigs, [(refname, pos0, cigar, seq)])``
    — the shared conversion front end for :func:`sam_text_to_bam` and
    the fixture/bench tooling (one definition, so committed fixtures
    can never drift from what the bench converter produces).  EVERY
    body line is kept, mapped or not (CIGAR ``"*"`` becomes the zero-op
    record), so progress totals stay identical across containers."""
    from ..io.sam import parse_sq_line

    contigs = []
    records = []
    for line in text.splitlines():
        if line.startswith("@"):
            if line.startswith("@SQ"):
                contigs.append(parse_sq_line(line))
            continue
        if not line:
            continue
        f = line.split("\t")
        records.append((f[2].split()[0], int(f[3]) - 1, f[5], f[9]))
    return contigs, records


def sam_text_to_bam(text: str, path: str, level: int = 6) -> str:
    """Convert in-memory SAM text to a BAM file — the fixture/bench
    bridge (oracle reads the SAM, the system under test reads the BAM)."""
    contigs, records = sam_text_to_records(text)
    return write_bam(contigs, records, path, level=level)


def _segment_matrix(starts: np.ndarray, codes: np.ndarray,
                    seg_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split an [n, L] row matrix into [(n*ceil(L/W)), W] segments with
    starts advanced per segment — the fast-lane form of the encoder's
    long-read segmentation (pileup addition commutes, so splitting a
    row at any boundary is exact)."""
    n, L = codes.shape
    n_seg = -(-L // seg_w)
    pad_to = n_seg * seg_w
    if pad_to != L:
        padded = np.full((n, pad_to), PAD_CODE, dtype=np.uint8)
        padded[:, :L] = codes
        codes = padded
    seg_codes = codes.reshape(n * n_seg, seg_w)
    seg_starts = (starts[:, None]
                  + (np.arange(n_seg, dtype=np.int64) * seg_w)[None, :]
                  ).reshape(-1)
    # drop all-PAD tail segments (possible when L % seg_w leaves a
    # segment entirely past the read) — none exist here because the pad
    # is < seg_w by construction, but keep the invariant explicit
    return seg_starts, seg_codes
