"""Synthetic SAM fixtures: deterministic, code-defined, no binary blobs.

Copy of ``sam2consensus_tpu/utils/simulate.py`` (pinned equal by
``tests/test_torch_copies.py``), so ``chip_smoke.py`` makes its inputs
without the JAX package.

SURVEY.md §4 calls for a fixture generator covering the BASELINE.md config
shapes (single-contig phiX-like, many-contig target capture, deep
insertion-heavy amplicon).  Two levels:

* :func:`sam_text` — hand-specified records for unit tests;
* :func:`simulate` — a tiny read simulator over a random genome, emitting
  reads with substitutions, insertions, deletions and soft clips, for
  differential and benchmark corpora.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

_BASES = "ACGT"


def sam_text(contigs: Sequence[Tuple[str, int]],
             reads: Sequence[Tuple[str, int, str, str]],
             extra_header: Sequence[str] = ()) -> str:
    """Build SAM text from (name, length) contigs and (ref, pos1, cigar, seq)
    reads.  ``pos1`` is 1-based as in a real SAM file."""
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for name, length in contigs:
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    lines.extend(extra_header)
    for i, (ref, pos1, cigar, seq) in enumerate(reads):
        qual = "I" * len(seq) if seq != "*" else "*"
        lines.append(f"read{i}\t0\t{ref}\t{pos1}\t60\t{cigar}\t*\t0\t0\t{seq}\t{qual}")
    return "\n".join(lines) + "\n"


def write_sam(text: str, path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as fh:
            fh.write(text.encode("ascii"))
    else:
        with open(path, "w") as fh:
            fh.write(text)
    return path


@dataclass
class SimSpec:
    """Knobs for the read simulator (rates are per-read probabilities)."""
    n_contigs: int = 1
    contig_len: int = 5000
    n_reads: int = 5000
    read_len: int = 100
    sub_rate: float = 0.01        # per-base substitution probability
    n_rate: float = 0.001         # per-base N probability
    ins_read_rate: float = 0.05   # reads carrying one insertion
    del_read_rate: float = 0.05   # reads carrying one deletion
    softclip_rate: float = 0.05   # reads with a soft-clipped prefix
    max_indel: int = 5
    contig_len_jitter: float = 0.3
    seed: int = 0
    contig_prefix: str = "contig"
    #: long-read mode (ONT/PacBio-like): every read carries this many
    #: indel events spread across its length (alternating I/D), instead
    #: of the at-most-one event the short-read rates draw.  0 keeps the
    #: legacy single-event path (and its exact rng stream — existing
    #: seeds stay byte-stable).
    n_indels: int = 0


def simulate(spec: SimSpec) -> str:
    """Generate a deterministic SAM corpus; returns the SAM text."""
    rng = np.random.RandomState(spec.seed)
    # worst-case reference span a read can consume past its start
    # (n_indels > 0 may stack several D events; == max_indel for the
    # legacy path so existing seeds keep their exact streams)
    margin = spec.max_indel * (spec.n_indels if spec.n_indels > 0 else 1)
    contigs: List[Tuple[str, int]] = []
    genomes: List[np.ndarray] = []
    for i in range(spec.n_contigs):
        jitter = 1.0 + spec.contig_len_jitter * (rng.rand() - 0.5) * 2
        length = max(spec.read_len + margin + 2,
                     int(spec.contig_len * jitter))
        contigs.append((f"{spec.contig_prefix}{i:04d}", length))
        genomes.append(rng.randint(0, 4, size=length))

    reads: List[Tuple[str, int, str, str]] = []
    for _ in range(spec.n_reads):
        ci = int(rng.randint(0, spec.n_contigs))
        name, length = contigs[ci]
        genome = genomes[ci]
        rl = spec.read_len
        start = int(rng.randint(0, max(1, length - rl - margin)))

        cigar_parts: List[str] = []
        seq_parts: List[str] = []
        gpos = start

        def take_match(n):
            nonlocal gpos
            codes = genome[gpos:gpos + n].copy()
            sub = rng.rand(n) < spec.sub_rate
            codes[sub] = rng.randint(0, 4, size=int(sub.sum()))
            chars = np.array(list(_BASES))[codes]
            nmask = rng.rand(n) < spec.n_rate
            chars[nmask] = "N"
            seq_parts.append("".join(chars))
            cigar_parts.append(f"{n}M")
            gpos += n

        if rng.rand() < spec.softclip_rate:
            clip = int(rng.randint(1, 8))
            seq_parts.append("".join(_BASES[c] for c in rng.randint(0, 4, clip)))
            cigar_parts.append(f"{clip}S")

        if spec.n_indels > 0:
            # dense-indel long read: split the read into n_indels+1 match
            # chunks with an alternating I/D event between consecutive
            # chunks — the CIGAR shape that stresses the insertion table
            # and the segmented slab layout
            cuts = np.sort(rng.choice(np.arange(1, rl),
                                      size=min(spec.n_indels, rl - 1),
                                      replace=False))
            prev = 0
            for j, cut in enumerate(cuts):
                take_match(int(cut) - prev)
                k = int(rng.randint(1, spec.max_indel + 1))
                if j % 2 == 0:
                    seq_parts.append("".join(
                        _BASES[c] for c in rng.randint(0, 4, k)))
                    cigar_parts.append(f"{k}I")
                else:
                    cigar_parts.append(f"{k}D")
                    gpos += k
                prev = int(cut)
            take_match(rl - prev)
            reads.append((name, start + 1, "".join(cigar_parts),
                          "".join(seq_parts)))
            continue

        event = rng.rand()
        if event < spec.ins_read_rate:
            k = int(rng.randint(1, spec.max_indel + 1))
            split = int(rng.randint(1, rl))
            take_match(split)
            seq_parts.append("".join(_BASES[c] for c in rng.randint(0, 4, k)))
            cigar_parts.append(f"{k}I")
            take_match(rl - split)
        elif event < spec.ins_read_rate + spec.del_read_rate:
            k = int(rng.randint(1, spec.max_indel + 1))
            split = int(rng.randint(1, rl))
            take_match(split)
            cigar_parts.append(f"{k}D")
            gpos += k
            take_match(rl - split)
        else:
            take_match(rl)

        reads.append((name, start + 1, "".join(cigar_parts), "".join(seq_parts)))

    # sprinkle a few unmapped records (CIGAR "*"), skipped by the tool
    for _ in range(max(1, spec.n_reads // 500)):
        reads.append((contigs[0][0], 1, "*", "*"))

    return sam_text(contigs, reads)


# Shapes mirroring BASELINE.md's five benchmark configs, scaled for tests.
BASELINE_SPECS = {
    "phix_like": SimSpec(n_contigs=1, contig_len=5386, n_reads=5000,
                         read_len=100, seed=101, contig_prefix="phiX"),
    "target_capture": SimSpec(n_contigs=350, contig_len=1200, n_reads=40000,
                              read_len=100, seed=202, contig_prefix="gene"),
    "amplicon_deep": SimSpec(n_contigs=1, contig_len=400, n_reads=30000,
                             read_len=80, ins_read_rate=0.3, del_read_rate=0.2,
                             seed=303, contig_prefix="amplicon"),
}
