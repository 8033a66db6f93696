"""Native-decode path: raw SAM text blocks -> SegmentBatch via the C++ core.

Copy of the row path of ``sam2consensus_tpu/encoder/native_encoder.py``
(``_line_end`` searches a growing window instead of a fixed 1 MiB one; it
finds the same newline).  It wraps ``native/decoder.cpp`` (ctypes) with
the orchestration the C side deliberately doesn't do:

* buffer sizing/growth and resume-after-capacity (the C call commits whole
  lines and reports consumed bytes);
* width adaptation: rows wider than the current bucket width W are reported
  as overflow lines, fall back to the Python encoder for this block, and
  double W for subsequent blocks when they stop being rare;
* error parity: a line the C decoder flags is REPLAYED through the Python
  parser/encoder, so the exception type and message are identical to the
  pure-Python path (and if the replay disagrees and succeeds — e.g. exotic
  int literals Python accepts — the read is committed via the Python
  fallback and decoding continues); a strict error carries the line's
  input offset (``ingest.badrecords.mark_offset``);
* merging native row matrices with Python-fallback rows into one
  power-of-two-padded SegmentBatch per slab.

The reference's fused host-count mode (the C pass counting straight into a
host pileup) is not ported: the port's pileup is on the device, so the C
call always runs with fused counting off.  Equivalence with the Python
encoder and with the reference's encoder is pinned by
``tests/test_torch_native.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .. import native
from ..constants import PAD_CODE
from ..ingest.badrecords import RECORD_ERRORS, mark_offset
from ..io.sam import iter_records
from .events import (EncodeError, GenomeLayout, MIN_BUCKET_W, ReadEncoder,
                     SegmentBatch, _bucket_width)


def available() -> bool:
    return native.load() is not None


def _line_end(data: np.ndarray, start: int) -> int:
    """Index of the newline ending the line at ``start`` (or end of data).

    The window doubles from 4 KiB, so the search costs about the line's own
    length.  (The reference scans a fixed 1 MiB window per call: on a
    long-read input every read is an overflow line that comes here, and
    those scans made its decode slower than the Python encoder's.)"""
    lo, step = start, 1 << 12
    while lo < len(data):
        hi = min(lo + step, len(data))
        nl = np.flatnonzero(data[lo:hi] == 10)
        if len(nl):
            return lo + int(nl[0])
        lo, step = hi, step * 2
    return len(data)


class NativeReadEncoder:
    """Streaming encoder over raw text blocks; same surface as ReadEncoder."""

    #: expanded cells per emitted slab (rows = SLAB_CELLS // width)
    SLAB_CELLS = 1 << 23
    #: the first slab's row width, before the span probe or overflow
    #: doubling adapts it
    FIRST_WIDTH = 256

    def __init__(self, layout: GenomeLayout, maxdel: Optional[int] = 150,
                 strict: bool = True, on_lines=None, on_bytes=None,
                 segment_width: int = 0):
        lib = native.load()
        if lib is None:  # pragma: no cover - callers check available()
            raise RuntimeError(f"native decoder unavailable: "
                               f"{native.load_error()}")
        self._lib = lib
        self.layout = layout
        self.maxdel = maxdel
        self.strict = strict
        self._c_strict = 1 if strict else 0
        #: absolute input offset of the block currently being decoded
        #: (set by ``encode_blocks_from``; None = offsets unknown): the
        #: base of the offsets strict errors carry
        self.block_base = None
        #: slab-width ceiling: with the segmented layout active, a long
        #: read is an overflow line that the python twin splits into
        #: <=segment_width rows, so the native slab never widens past W
        self._width_cap = segment_width if segment_width else 1 << 16
        self.width = min(self.FIRST_WIDTH, self._width_cap)
        self.on_lines = on_lines
        self.on_bytes = on_bytes
        # fused host counting off: zero-length dummies for the C call
        self._acc_u8 = np.zeros(6, dtype=np.uint8)
        self._acc_ovf = np.zeros(6, dtype=np.int32)
        # python twin for overflow/error-replay fallback; shares counters
        # and the insertion store so fallback reads land in the same place
        self._py = ReadEncoder(layout, maxdel=maxdel, strict=strict,
                               segment_width=segment_width)
        self.insertions = self._py.insertions

        names_blob = "".join(layout.names).encode("ascii")
        name_off = np.zeros(len(layout.names) + 1, dtype=np.int64)
        np.cumsum([len(n.encode("ascii")) for n in layout.names],
                  out=name_off[1:])
        self._names = names_blob
        self._name_off = name_off
        self._ctg_offset = layout.offsets[:-1].astype(np.int64).copy()
        self._ctg_len = layout.lengths.astype(np.int64).copy()

    @property
    def n_reads(self) -> int:
        return self._py.n_reads

    @property
    def n_skipped(self) -> int:
        return self._py.n_skipped

    def encode_blocks(self, blocks: Iterable[str]) -> Iterator[SegmentBatch]:
        """Yield SegmentBatches as fixed-size row slabs fill.

        Slabs persist across text blocks, so the steady state is one
        (rows, width) shape per run with near-zero row padding; only the
        final partial slab pads up to a power of two.
        """
        self._probed = False
        self._new_slab()
        self._fallback_rows: List[Tuple[int, np.ndarray]] = []
        self._batch_reads = 0
        self._batch_events = 0

        # insertion/overflow buffers, allocated once and reused across
        # calls (their contents are copied out per call below)
        ins_cap = 1 << 16
        chars_cap = 1 << 20
        ovf_cap = 4096
        out = np.zeros(16, dtype=np.int64)
        ic = np.empty(ins_cap, dtype=np.int32)
        il = np.empty(ins_cap, dtype=np.int32)
        im = np.empty(ins_cap, dtype=np.int32)
        ich = np.empty(chars_cap, dtype=np.uint8)
        ovf = np.empty(ovf_cap, dtype=np.int64)

        for text in blocks:
            if isinstance(text, str):
                text = text.encode("ascii")
            data = np.frombuffer(text, dtype=np.uint8)
            base = self.block_base
            offset = 0
            while offset < len(data):
                chunk = data[offset:]
                # the status==1/consumed==0 branch below doubles the caps
                # when a single line overruns the insertion buffers; the
                # arrays grow here before the retry call (the C decoder is
                # told the cap, so cap > len(array) would write past the
                # end)
                if len(ic) < ins_cap:
                    ic = np.empty(ins_cap, dtype=np.int32)
                    il = np.empty(ins_cap, dtype=np.int32)
                    im = np.empty(ins_cap, dtype=np.int32)
                if len(ich) < chars_cap:
                    ich = np.empty(chars_cap, dtype=np.uint8)
                if len(ovf) < ovf_cap:
                    ovf = np.empty(ovf_cap, dtype=np.int64)
                fill = self._fill
                self._lib.s2c_decode(
                    chunk, len(chunk),
                    self._names, self._name_off, len(self._ctg_len),
                    self._ctg_offset, self._ctg_len,
                    -1 if self.maxdel is None else self.maxdel,
                    self._c_strict,
                    self._slab_w,
                    self._starts[fill:], self._codes[fill:],
                    len(self._starts) - fill,
                    ic, il, im, ins_cap,
                    ich, chars_cap,
                    ovf, ovf_cap,
                    out,
                    self._acc_u8, self._acc_ovf, 0, 0)

                (n_rows, n_reads, n_skipped, consumed, n_ins, n_chars,
                 status, _err_off, n_events, n_lines, n_overflow,
                 _max_span) = out[:12]

                self._fill = fill + int(n_rows)
                if n_ins:
                    self.insertions.array_chunks.append(
                        (ic[:n_ins].copy(), il[:n_ins].copy(),
                         im[:n_ins].copy(), ich[:n_chars].copy()))
                self._py.n_reads += int(n_reads)
                self._py.n_skipped += int(n_skipped)
                self._batch_reads += int(n_reads)
                self._batch_events += int(n_events)
                self._count_lines(int(n_lines))

                # overflow lines (span > width): python fallback, whole read
                for k in range(int(n_overflow)):
                    self._fallback_line(
                        chunk, int(ovf[k]),
                        abs_off=None if base is None
                        else base + offset + int(ovf[k]))
                if n_overflow > max(64, n_reads // 64):
                    # widen future slabs; the current slab keeps its
                    # width.  Capped at the segmented layout's W, past
                    # which overflow reads come back segmented via the
                    # python twin instead of widening every slab.
                    self.width = min(self._width_cap, self.width * 2)
                elif (not self._probed and n_reads > 256 and _max_span > 0
                      and not n_overflow):
                    # one-shot shrink to the observed span profile:
                    # padding bytes are bytes on the host-to-device copy
                    self._probed = True
                    self.width = min(self._width_cap,
                                     max(MIN_BUCKET_W,
                                         _bucket_width(int(_max_span))))

                offset += int(consumed)
                self._count_bytes(int(consumed))
                if status == 2:
                    # flagged line: python replay for identical errors; if
                    # the replay succeeds instead (python being more lenient
                    # than the C parser), commit it via the fallback path
                    line_end = _line_end(data, offset)
                    self._fallback_line(
                        data, offset, line_end=line_end,
                        abs_off=None if base is None else base + offset)
                    self._count_lines(1)
                    self._count_bytes(min(line_end + 1, len(data)) - offset)
                    offset = line_end + 1
                elif status == 1:
                    if len(self._starts) - self._fill < 2:
                        # slab full: emit and start fresh
                        batch = self._flush()
                        if batch is not None:
                            yield batch
                    elif consumed == 0:
                        # a single line overran the insertion buffers
                        ins_cap *= 2
                        chars_cap *= 2
                        ovf_cap *= 2
                    # else: per-call insertion buffers were the constraint;
                    # they were copied out above, so just keep going

        batch = self._flush()
        if batch is not None:
            yield batch

    def encode_blocks_from(self, stream) -> Iterator[SegmentBatch]:
        """``encode_blocks`` over a ReadStream, tracking each block's
        absolute input offset (``stream.block_offset`` ->
        ``self.block_base``) so strict errors carry real file offsets."""
        def feed():
            for block in stream.blocks():
                self.block_base = stream.block_offset
                yield block

        return self.encode_blocks(feed())

    # ------------------------------------------------------------------
    def _new_slab(self) -> None:
        self._slab_w = self.width
        rows = max(1024, self.SLAB_CELLS // self._slab_w)
        self._starts = np.empty(rows, dtype=np.int32)
        self._codes = np.empty((rows, self._slab_w), dtype=np.uint8)
        self._fill = 0

    def _flush(self) -> Optional[SegmentBatch]:
        batch = self._build_batch(
            [(self._starts, self._codes, self._fill)] if self._fill else [],
            self._fallback_rows, self._batch_reads, self._batch_events)
        self._new_slab()
        self._fallback_rows = []
        self._batch_reads = 0
        self._batch_events = 0
        return batch

    def _count_lines(self, k: int) -> None:
        if self.on_lines is not None and k:
            self.on_lines(k)

    def _count_bytes(self, k: int) -> None:
        if self.on_bytes is not None and k > 0:
            self.on_bytes(k)

    def _fallback_line(self, data: np.ndarray, start: int,
                       line_end: Optional[int] = None,
                       abs_off: Optional[int] = None) -> None:
        """Encode one raw line via the Python path into the pending batch.

        A line the C decoder flagged (or a wide/overflow read) replays
        through the Python encoder; in strict mode any error the replay
        raises is the Python path's own, with the line's absolute input
        offset stamped on it (``s2c_offset``).
        """
        if line_end is None:
            line_end = _line_end(data, start)
        raw = bytes(data[start:min(line_end + 1, len(data))])
        try:
            # include the trailing newline so even an empty line replays
            # as the truthy "\n" string the pure-python path would have
            # seen; the record iterator raises IndexError on malformed
            # lines in every mode, exactly like the pure-python path
            line = raw.decode("ascii")
            recs = list(iter_records(iter(()), line))
        except RECORD_ERRORS as exc:
            mark_offset(exc, abs_off)
            raise
        for rec in recs:
            try:
                rows = self._py.encode_record(rec)
            except (EncodeError, KeyError, IndexError) as exc:
                if self.strict:
                    mark_offset(exc, abs_off)
                    raise
                self._py.n_skipped += 1
                continue
            self._py.n_reads += 1
            self._batch_reads += 1
            for start_flat, row in rows:
                self._fallback_rows.append((start_flat, row))
                self._batch_events += (len(row)
                                       - int((row == PAD_CODE).sum()))

    def _build_batch(self, native_parts, fallback_rows, n_reads, n_events
                     ) -> Optional[SegmentBatch]:
        """Merge native matrices + fallback rows into one padded batch.

        Common case (one native part per width, no fallback rows): the
        decode buffer is padded *in place* — only the pad tail is written,
        no bulk copy.
        """
        per_w: Dict[int, List] = {}
        for starts, codes, n in native_parts:
            per_w.setdefault(codes.shape[1], []).append((starts, codes, n))
        for start_flat, row in fallback_rows:
            w = _bucket_width(len(row))
            per_w.setdefault(w, []).append((start_flat, row))

        buckets: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for w, items in per_w.items():
            if len(items) == 1 and len(items[0]) == 3:
                starts, codes, n = items[0]
                s_pad = max(1024, 1 << (n - 1).bit_length())
                if s_pad <= len(starts):   # buffer big enough: pad in place
                    starts[n:s_pad] = 0
                    codes[n:s_pad] = PAD_CODE
                    buckets[w] = (starts[:s_pad], codes[:s_pad])
                    continue
            total = sum(it[2] if len(it) == 3 else 1 for it in items)
            s_pad = max(1024, 1 << (total - 1).bit_length())
            mat = np.full((s_pad, w), PAD_CODE, dtype=np.uint8)
            st = np.zeros(s_pad, dtype=np.int32)
            r = 0
            for it in items:
                if len(it) == 3:
                    starts, codes, n = it
                    st[r:r + n] = starts[:n]
                    mat[r:r + n] = codes[:n]
                    r += n
                else:
                    start_flat, row = it
                    st[r] = start_flat
                    mat[r, : len(row)] = row
                    r += 1
            buckets[w] = (st, mat)
        if not buckets and n_reads == 0:
            return None
        return SegmentBatch(buckets=buckets, n_reads=n_reads,
                            n_events=n_events)
