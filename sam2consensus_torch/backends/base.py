"""Backend result types and the FASTA header: copies of
``sam2consensus_tpu/backends/base.py`` (``format_header`` pinned equal by
``tests/test_torch_copies.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..io.fasta import FastaRecord


@dataclass
class BackendStats:
    reads_mapped: int = 0
    reads_skipped: int = 0      # permissive-mode drops (strict=False only)
    aligned_bases: int = 0      # M/=/X + counted gap bases (pileup increments)
    consensus_bases: int = 0    # emitted consensus characters across outputs
    extra: Dict[str, float] = field(default_factory=dict)


@dataclass
class BackendResult:
    """Per-reference FASTA records, in contig file order, threshold order."""
    fastas: Dict[str, List[FastaRecord]]
    stats: BackendStats


def format_header(prefix: str, threshold: float, refname: str,
                  sumcov: int, seq: str, stripped_len=None) -> str:
    """FASTA header, field-for-field per sam2consensus.py:394-397.

    ``coverage`` is ``round(sumcov/len(seq), 2)`` rendered via ``str``;
    ``length`` strips only ``"-"`` so a non-gap fill char counts (quirk 10).
    """
    if stripped_len is None:
        stripped_len = len(seq.replace("-", ""))
    return (">" + prefix + "|c" + str(int(threshold * 100))
            + " reference:" + refname
            + " coverage:" + str(round(float(sumcov) / float(len(seq)), 2))
            + " length:" + str(stripped_len)
            + " consensus_threshold:" + str(int(threshold * 100)) + "%")
