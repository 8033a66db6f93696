"""A :class:`~.generate.Sample` as SAM text, as ``bwa mem`` writes it."""

from __future__ import annotations

import os

import numpy as np

from .generate import Sample
from .pack import digits, fixed, pack_rows, table

CHUNK = 65536
QNAME = b"A00817:211:HGV7KDSXY:1:"


def header(s: Sample) -> bytes:
    return (f"@HD\tVN:1.6\tSO:unsorted\n"
            f"@SQ\tSN:{s.contig}\tLN:{s.contig_len}\n"
            f"@RG\tID:{s.name}\tSM:{s.name}\tPL:ILLUMINA\n"
            f"@PG\tID:bwa\tPN:bwa\tVN:0.7.17-r1188\tCL:bwa mem -t 8 "
            f"ref.fa {s.name}_R1.fastq.gz {s.name}_R2.fastq.gz\n"
            ).encode("ascii")


def tags(s: Sample, lo: int, hi: int):
    """NM, AS and XS (bwa's edit distance, score and second-best score)."""
    nm = s.nm[lo:hi]
    score = np.maximum(0, s.seq.shape[1] - 5 * nm)
    xs = (s.pos[lo:hi] * 2654435761 >> 7) % (score // 3 + 1)
    return nm, score, xs


def write(s: Sample, path: str) -> int:
    """Write the SAM file; returns its size in bytes."""
    names, cidx = s.cigars, s.cigar_id
    ctab, clen = table([c.encode("ascii") for c in names])
    rname = s.contig.encode("ascii")
    size = 0
    with open(path, "wb") as fh:
        h = header(s)
        fh.write(h)
        size += len(h)
        for lo in range(0, s.n_reads, CHUNK):
            hi = min(s.n_reads, lo + CHUNK)
            n = hi - lo
            nm, score, xs = tags(s, lo, hi)
            k = cidx[lo:hi]
            body = pack_rows([
                QNAME, digits(s.tile[lo:hi]), b":", digits(s.x[lo:hi]), b":",
                digits(s.y[lo:hi]), b"\t", digits(s.flag[lo:hi]),
                b"\t" + rname + b"\t", digits(s.pos[lo:hi] + 1), b"\t60\t",
                (ctab[k], clen[k]), b"\t=\t", digits(s.mate_pos[lo:hi] + 1),
                b"\t", digits(s.tlen[lo:hi]), b"\t", fixed(s.seq[lo:hi]),
                b"\t", fixed(s.qual[lo:hi]), b"\tNM:i:", digits(nm),
                b"\tAS:i:", digits(score), b"\tXS:i:", digits(xs), b"\n"], n)
            fh.write(body)
            size += len(body)
        # on disk before the window opens, so no write-back of the inputs
        # runs under the measured window
        fh.flush()
        os.fsync(fh.fileno())
    return size
