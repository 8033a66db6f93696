"""Streaming SAM input: copy of the text path of ``sam2consensus_tpu/io/sam.py``.

* gzip-or-plain opener keyed on the ``.gz`` suffix (reference
  ``sam2consensus.py:110-114``).  A BGZF ``.sam.gz`` is a series of gzip
  members, which ``gzip`` reads serially with the same bytes out;
* header pass reading ``@SQ`` lines positionally (``sam2consensus.py:160-172``);
* record pass keeping lines whose CIGAR is not ``"*"`` and using RNAME,
  0-based POS, CIGAR and SEQ (``sam2consensus.py:195-206``).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, TextIO, Tuple


def opener(filename: str):
    """Open plain or gzip SAM text (ascii) by suffix."""
    if filename.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(filename, "rb"), encoding="ascii",
                                errors="strict")
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
    """Single-pass source of SAM body records that counts every body line
    (the reference's progress accounting, ``sam2consensus.py:224-225``)."""

    def __init__(self, handle: TextIO, first_line: str = "", on_lines=None):
        self.handle = handle
        self.first = first_line
        self.on_lines = on_lines
        self.n_lines = 0

    def add_lines(self, k: int) -> None:
        if k:
            self.n_lines += k
            if self.on_lines is not None:
                self.on_lines(self.n_lines)

    def records(self) -> Iterator[SamRecord]:
        """Parsed mapped records, counting every body line."""
        def counted() -> Iterator[str]:
            for line in self.handle:
                self.add_lines(1)
                yield line

        if self.first:
            self.add_lines(1)
        yield from iter_records(counted(), self.first)
