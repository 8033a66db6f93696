"""The yardstick's arithmetic: published peaks of the card and the least
work a job asks of a kernel, counted from the job's own sizes."""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth (bytes/s) at the full
#: 700 W power limit; a share is stated against it, the card's own power
#: limit beside it
H100_HBM_BYTES_PER_S = 3.35e12
#: an int32 count lane, and the six lanes of a position (-ACGNT)
COUNT_BYTES = 4
LANES = 6
#: a read's start (int32) and each CIGAR operation (a BAM uint32)
START_BYTES = 4
CIGAR_OP_BYTES = 4


def k1_bytes(pileup_events: int, n_reads: int, cigar_ops: int,
             contig_len: int) -> int:
    """Bytes the pileup of one job moves at the least: each count update's
    one-byte base code read once, each read's start and CIGAR read once,
    and the job's ``[L, 6]`` int32 counts written once.  It prices the
    job, not the port's slabs: merging, splitting or replacing launches
    leaves it as it is."""
    return (pileup_events + n_reads * START_BYTES
            + cigar_ops * CIGAR_OP_BYTES + contig_len * LANES * COUNT_BYTES)


def bound_seconds(nbytes: int) -> float:
    return nbytes / H100_HBM_BYTES_PER_S
