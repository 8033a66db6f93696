"""Streaming SAM input: copy of the SAM path of ``sam2consensus_tpu/io/sam.py``.

* gzip-or-plain opener keyed on the ``.gz`` suffix (reference
  ``sam2consensus.py:110-114``), in text or binary mode.  A BGZF
  ``.sam.gz`` is a series of gzip members, which ``gzip`` reads serially
  with the same bytes out;
* header pass reading ``@SQ`` lines positionally (``sam2consensus.py:160-172``);
* record pass keeping lines whose CIGAR is not ``"*"`` and using RNAME,
  0-based POS, CIGAR and SEQ (``sam2consensus.py:195-206``);
* :class:`ReadStream`, one pass over the body as parsed records (the
  Python encoder) or as raw blocks of whole lines (the native decoder).
"""

from __future__ import annotations

import gzip
import io
import mmap
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, TextIO, Tuple


def opener(filename: str, binary: bool = False):
    """Open plain or gzip SAM by suffix: ascii text, or a bytes handle
    with ``binary=True`` (the native decoder parses raw bytes; header
    lines are still ascii-decoded one by one in ``read_header``, and a
    non-ascii body byte surfaces as a decode error of the encoder)."""
    if filename.endswith(".gz"):
        raw = gzip.open(filename, "rb")
        if binary:
            return raw
        return io.TextIOWrapper(raw, encoding="ascii", errors="strict")
    if binary:
        return open(filename, "rb")
    return open(filename, "r", encoding="ascii", errors="strict")


@dataclass(frozen=True)
class Contig:
    """One ``@SQ`` header entry, in file order."""
    name: str
    length: int


@dataclass(frozen=True)
class SamRecord:
    """The four fields the consensus algorithm consumes."""
    refname: str
    pos: int          # 0-based leftmost reference position (POS - 1)
    cigar: str
    seq: str


def parse_sq_line(line: str) -> Contig:
    """Positional @SQ parse, faithful to sam2consensus.py:163-164."""
    fields = line.split("\t")
    name = fields[1].replace("SN:", "").split()[0]
    length = int(fields[2].replace("LN:", "").strip())
    return Contig(name, length)


def read_header(handle) -> Tuple[List[Contig], int, str]:
    """Consume header lines; return (contigs, header_line_count, first_body_line).

    ``first_body_line`` is the line that terminated the header ("" at EOF);
    the caller feeds it back into record iteration so one pass suffices.
    Accepts text or binary handles; ``first_body_line`` keeps the handle's
    type.
    """
    contigs: List[Contig] = []
    n_header = 0
    for line in handle:
        text = line.decode("ascii") if isinstance(line, bytes) else line
        if text.startswith("@"):
            n_header += 1
            if text.startswith("@SQ"):
                contigs.append(parse_sq_line(text))
        else:
            return contigs, n_header, line
    return contigs, n_header, ""


def iter_records(handle: TextIO, first_line: str = "") -> Iterator[SamRecord]:
    """Yield mapped records (CIGAR != "*"), skipping stray header lines.

    The CIGAR probe runs on the un-stripped field, like the reference: a
    6-field line ending ``"\\t*\\n"`` is not an unmapped skip and raises
    ``IndexError`` on the missing SEQ.
    """
    def make(line: str):
        if line.split("\t")[5] == "*":
            return None
        fields = line.rstrip("\n").split("\t")
        return SamRecord(refname=fields[2].split()[0], pos=int(fields[3]) - 1,
                         cigar=fields[5], seq=fields[9])

    if first_line and first_line[0] != "@":
        rec = make(first_line)
        if rec is not None:
            yield rec
    for line in handle:
        if line[0] != "@":
            rec = make(line)
            if rec is not None:
                yield rec


class ReadStream:
    """Single-pass source of SAM body content, as records OR text blocks.

    The Python encoder pulls parsed ``records()``; the native decoder pulls
    raw ``blocks()`` of whole lines and parses them in C++.  Both report
    consumed body lines through ``add_lines``, so the progress accounting
    (``sam2consensus.py:224-225``: every body line counts, unmapped and
    stray header lines included) is the same either way.
    """

    def __init__(self, handle: TextIO, first_line: str = "", on_lines=None):
        self.handle = handle
        self.first = first_line
        self.on_lines = on_lines
        self.n_lines = 0
        #: bytes of body content consumed so far (ascii input makes
        #: str-length == byte-length on text handles)
        self.n_bytes = 0
        # absolute offset of the body start, when the handle can report it:
        # binary handles (GzipFile too, in uncompressed offsets) keep tell()
        # accurate through read_header's line iteration; a TextIOWrapper
        # raises here ("telling position disabled")
        try:
            self._body_start = self.handle.tell() - len(first_line)
        except (AttributeError, OSError, ValueError):
            self._body_start = None
        #: absolute input offset of the most recent ``blocks()`` block
        #: (None when the handle cannot locate itself): the base of the
        #: offsets that strict decode errors carry
        self.block_offset: Optional[int] = None

    def add_lines(self, k: int) -> None:
        if k:
            self.n_lines += k
            if self.on_lines is not None:
                self.on_lines(self.n_lines)

    def add_bytes(self, k: int) -> None:
        if k:
            self.n_bytes += k

    def records(self) -> Iterator[SamRecord]:
        """Parsed mapped records, counting every body line."""
        def counted() -> Iterator[str]:
            for line in self.handle:
                self.add_lines(1)
                self.add_bytes(len(line))
                yield line.decode("ascii") if isinstance(line, bytes) \
                    else line

        first = self.first
        if isinstance(first, bytes):
            first = first.decode("ascii")
        if first:
            self.add_lines(1)
            self.add_bytes(len(first))
        yield from iter_records(counted(), first)

    def blocks(self, max_bytes: int = 1 << 23):
        """Raw blocks of whole lines, str or bytes per the handle's mode
        (line counting is the consumer's job via ``add_lines``: the native
        decoder counts in C++).

        A plain binary file is mmapped and yielded as line-aligned
        ``memoryview`` windows straight off the page cache (no per-block
        ``read()`` copy); gzip and text handles take the buffered path.

        ``block_offset`` is set before each yield to the absolute input
        offset of the block's first byte (uncompressed offsets on gzip
        handles, the same number a plain copy of the file would give), or
        ``None`` when the handle cannot locate itself.
        """
        pending = self.first
        self.first = ""
        mm = self._mmap_body()
        if mm is not None:
            if pending:
                self.block_offset = self._body_start
                yield pending.encode("ascii") \
                    if isinstance(pending, str) else pending
            pos = self.handle.tell()
            size = len(mm)
            mv = memoryview(mm)
            while pos < size:
                end = min(pos + max_bytes, size)
                if end < size:
                    nl = mm.rfind(b"\n", pos, end)
                    if nl < pos:
                        # one line longer than the window: extend to its
                        # terminating newline (or EOF)
                        nl = mm.find(b"\n", end)
                        end = size if nl < 0 else nl + 1
                    else:
                        end = nl + 1
                self.block_offset = pos
                yield mv[pos:end]
                pos = end
            # leave the handle where the content ended, as read() would
            self.handle.seek(size)
            return
        off = None if self._body_start is None \
            else self._body_start + self.n_bytes
        while True:
            chunk = self.handle.read(max_bytes)
            if not chunk:
                if pending:
                    self.block_offset = off
                    yield pending
                return
            if not isinstance(pending, type(chunk)):  # str first body line
                pending = pending.encode("ascii") if isinstance(pending, str) \
                    else pending.decode("ascii")
            newline = "\n" if isinstance(chunk, str) else b"\n"
            if not chunk.endswith(newline):
                chunk += self.handle.readline()
            block, pending = pending + chunk, chunk[:0]
            self.block_offset = off
            if off is not None:
                off += len(block)
            yield block

    def _is_plain_file(self) -> bool:
        """True for a plain uncompressed binary file handle (a gzip
        handle's fileno() and fstat see COMPRESSED bytes)."""
        h = self.handle
        return (isinstance(h, io.BufferedReader)
                and isinstance(getattr(h, "raw", None), io.FileIO))

    def body_bytes_total(self) -> Optional[int]:
        """Body size in bytes (header excluded) for plain uncompressed
        file handles; None for compressed/in-memory handles or when the
        body start could not be located."""
        if not self._is_plain_file() or self._body_start is None:
            return None
        try:
            st = os.fstat(self.handle.fileno())
        except (OSError, ValueError):
            return None
        return max(0, st.st_size - self._body_start)

    def _mmap_body(self):
        """An ACCESS_READ mmap of the whole file when the handle is a
        plain uncompressed binary file; None otherwise."""
        if not self._is_plain_file():
            return None
        try:
            return mmap.mmap(self.handle.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            return None                    # empty file, pipe, ...
