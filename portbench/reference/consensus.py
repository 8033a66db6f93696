"""The plain reference: sam2consensus.py's consensus, in NumPy.

Written from the tool's semantics, not from any code of the port: the
pileup over the alphabet ``-ACGNT`` with gaps and Ns counted into the
coverage; a read's gaps left out (its cursor still advancing) when it
holds more than ``maxdel`` gap bases; insertions keyed by the reference
index of the base that follows them, counted motif by motif into
columns whose gap lane is the position's coverage less the column's
bases (which may go negative); the greedy vote, where the groups of
equal counts are taken whole, largest first, while the running total
stays below ``threshold * coverage``; an insertion column emitted after
its position's base unless it votes a gap; positions without coverage,
or under the minimum depth, written as the fill character; a reference
with no coverage, or whose consensus holds nothing but gaps, writes no
record.

Each reference sequence (contig) is called on its own, as the tool calls
it: one ``{contig}__{name}.fasta`` a contig with a record, its header
giving that contig's coverage and length.  An insertion at a contig's
end, with no base of the contig after it, is not emitted.

Input: the reads as the benchmark made them (the contigs, each read's
contig and 0-based POS on it, CIGAR table and index, SEQ bytes), the same
records its SAM and BAM files hold.  Output: ``{file name: bytes}`` as the
tool writes them.

``count_cap`` and ``insertions`` exist for the controls
(``reference/controls.py``); the reference itself runs with neither.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ALPHABET = "-ACGNT"
_LANE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(ALPHABET):
    _LANE[ord(_c)] = _i
_CIGAR = re.compile(r"(\d+)([MIDNSHPX=])")
#: reads a step of the pileup takes at once (bounds its index arrays)
BLOCK_READS = 65536
#: pileup events gathered before one ``bincount`` adds them
FLUSH_EVENTS = 1 << 26
#: positions a step of the vote takes at once
BLOCK_POS = 262144

_IUPAC = {"A": "A", "C": "C", "G": "G", "T": "T", "AC": "M", "AG": "R",
          "AT": "W", "CG": "S", "CT": "Y", "GT": "K", "ACG": "V", "ACT": "H",
          "AGT": "D", "CGT": "B", "ACGT": "N"}


def _call(mask: int) -> str:
    """The character for a called set of lanes (bit i = ALPHABET[i])."""
    lanes = {ALPHABET[i] for i in range(6) if mask >> i & 1}
    nucs = "".join(sorted(lanes & set("ACGT")))
    if nucs == "ACGT":
        return "N"
    if nucs:
        return _IUPAC[nucs].lower() if lanes & {"-", "N"} else _IUPAC[nucs]
    if lanes == {"N"}:
        return "N"
    if lanes == {"-", "N"}:
        return "n"
    return "-"          # {"-"}, or nothing called


CALL = np.frombuffer("".join(_call(m) for m in range(64)).encode("ascii"),
                     dtype=np.uint8)


def vote(counts: np.ndarray, cutoff: np.ndarray) -> np.ndarray:
    """Called-lane masks: lane i is called when it is non-zero and the
    lanes counting strictly more than it add up to less than ``cutoff``
    (so equal counts go together, and the greedy walk stops at the first
    group that reaches the cutoff).  Where the largest lane alone reaches
    the cutoff, that is the lanes equal to it."""
    c = counts.astype(np.int64)
    bits = 1 << np.arange(6)
    top = c.max(1)
    masks = (((c == top[:, None]) & (c != 0)) * bits).sum(1)
    rest = np.nonzero(top < cutoff)[0]
    if rest.size:
        r = c[rest]
        above = np.zeros(r.shape, dtype=np.int64)
        for j in range(6):
            above += np.where(r[:, j:j + 1] > r, r[:, j:j + 1], 0)
        called = (r != 0) & (above < cutoff[rest, None])
        masks[rest] = (called * bits).sum(1)
    return masks


def _walk(cigar: str):
    """(kind, read offset, reference offset, length) of each CIGAR op."""
    out, r, q = [], 0, 0
    for n, op in _CIGAR.findall(cigar):
        n = int(n)
        if op in "M=X":
            out.append(("M", q, r, n))
            q += n
            r += n
        elif op in "DNP":
            out.append(("D", q, r, n))
            r += n
        elif op == "I":
            out.append(("I", q, r, n))
            q += n
        elif op == "S":
            q += n
    return out


def pileup(genome_len: int, pos: np.ndarray, cigars: Sequence[str],
           cigar_id: np.ndarray, seq: np.ndarray, maxdel: Optional[int],
           lo: np.ndarray, hi: np.ndarray):
    """``([L, 6] int64 counts, Counter of (position, motif))`` over the
    flat genome, ``pos`` on it.  Each read lies in ``[lo, hi)``, its
    contig's stretch of the flat genome; an insertion keyed at its
    contig's end is left out."""
    counts = np.zeros(genome_len * 6, dtype=np.int64)
    motifs: Counter = Counter()
    pending: List[np.ndarray] = []
    held = 0
    order = np.argsort(cigar_id, kind="stable")
    bounds = np.searchsorted(cigar_id[order], np.arange(len(cigars) + 1))
    for k, cig in enumerate(cigars):
        rows = order[bounds[k]:bounds[k + 1]]
        if rows.size == 0:
            continue
        ops = _walk(cig)
        gaps = sum(n for kind, _, _, n in ops if kind == "D")
        count_gaps = maxdel is None or gaps <= maxdel
        span = sum(n for kind, _, _, n in ops if kind in "MD")
        p0 = pos[rows]
        if span and ((p0 < lo[rows]).any()
                     or (p0 + span > hi[rows]).any()):
            raise IndexError(f"a read with CIGAR {cig} leaves its contig")
        for b in range(0, rows.size, BLOCK_READS):
            r = rows[b:b + BLOCK_READS]
            p = pos[r]
            p6 = p[:, None] * 6
            for kind, q, off, n in ops:
                if kind == "M":
                    lane = _LANE[seq[r, q:q + n]]
                    if (lane == 255).any():
                        raise KeyError("a base outside ACGTN")
                    idx = p6 + ((off + np.arange(n)) * 6)[None, :]
                    idx += lane
                elif kind == "D" and count_gaps:
                    idx = p6 + ((off + np.arange(n)) * 6)[None, :]
                elif kind == "I":
                    inside = p + off < hi[r]
                    for pi, m in zip((p + off)[inside].tolist(),
                                     seq[r[inside], q:q + n].tolist()):
                        motifs[(pi, bytes(m))] += 1
                    continue
                else:
                    continue
                pending.append(idx.ravel())
                held += idx.size
                if held >= FLUSH_EVENTS:
                    counts += np.bincount(np.concatenate(pending),
                                          minlength=counts.size)
                    pending, held = [], 0
    if pending:
        counts += np.bincount(np.concatenate(pending), minlength=counts.size)
    return counts.reshape(genome_len, 6), motifs


def insertion_columns(motifs: Counter, count_cap: Optional[int] = None):
    """``{position: [columns, 6] int64}`` of the motifs' bases (the gap
    lane is filled against coverage at the vote)."""
    cols: Dict[int, Dict[int, np.ndarray]] = {}
    for (p, m), k in motifs.items():
        table = cols.setdefault(p, {})
        for j, ch in enumerate(m):
            lanes = table.setdefault(j, np.zeros(6, dtype=np.int64))
            lanes[_LANE[ch]] += k
    out = {}
    for p, table in cols.items():
        arr = np.stack([table[j] for j in range(len(table))])
        if count_cap is not None:
            arr = np.minimum(arr, count_cap)
        out[p] = arr
    return out


#: a record: (threshold in percent, header coverage, length, sequence)
Record = Tuple[str, str, int, str]


def calls(contigs: Sequence[Tuple[str, int]], contig_id: np.ndarray, pos,
          cigars, cigar_id, seq, thresholds: List[float],
          min_depth: int = 1, fill: str = "-",
          maxdel: Optional[int] = 150, count_cap: Optional[int] = None,
          insertions: bool = True) -> Dict[str, List[Record]]:
    """Each contig's records, for the contigs that have one; ``pos`` is on
    each read's own contig (``contig_id``)."""
    lens = np.array([n for _, n in contigs], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    lo = offs[contig_id]
    hi = lo + lens[contig_id]
    total = int(lens.sum())
    counts, motifs = pileup(total, pos + lo, cigars, cigar_id, seq, maxdel,
                            lo, hi)
    if count_cap is not None:
        counts = np.minimum(counts, count_cap)
    cov = counts.sum(1)
    ins = insertion_columns(motifs, count_cap) if insertions else {}
    ins_pos = np.array(sorted(ins), dtype=np.int64)
    called = {}
    for t in thresholds:
        chars = np.full(total, ord(fill), dtype=np.uint8)
        for b in range(0, total, BLOCK_POS):
            c = counts[b:b + BLOCK_POS]
            cv = cov[b:b + BLOCK_POS]
            masks = vote(c, t * cv.astype(np.float64))
            ok = (cv > 0) & (cv >= min_depth)
            chars[b:b + BLOCK_POS][ok] = CALL[masks[ok]]
        called[t] = chars
    out: Dict[str, List[Record]] = {}
    for (contig, n), o in zip(contigs, offs.tolist()):
        if cov[o:o + n].sum() == 0:
            continue
        here = ins_pos[np.searchsorted(ins_pos, o):
                       np.searchsorted(ins_pos, o + n)]
        records = []
        for t in thresholds:
            sumcov = int(cov[o:o + n].sum())
            extra_at, extra = [], []
            for p in here.tolist():
                cv = int(cov[p])
                if cv == 0 or cv < min_depth:
                    continue
                cols = ins[p].copy()
                cols[:, 0] = cv - cols[:, 1:].sum(1)
                masks = vote(cols, np.full(cols.shape[0], t * float(cv)))
                for m in masks.tolist():
                    ch = CALL[m]
                    if ch == ord("-"):
                        continue
                    extra_at.append(p - o + 1)
                    extra.append(ch)
                    sumcov += cv
            s = np.insert(called[t][o:o + n],
                          np.array(extra_at, dtype=np.int64),
                          np.array(extra, dtype=np.uint8)).tobytes().decode()
            stripped = len(s) - s.count("-")
            if stripped == 0:
                continue
            records.append((str(int(t * 100)),
                            str(round(float(sumcov) / float(len(s)), 2)),
                            stripped, s))
        if records:
            out[contig] = records
    return out


def render(name: str, called: Dict[str, List[Record]]) -> Dict[str, bytes]:
    """The FASTA files of one sample named ``name``: ``{file name:
    bytes}``."""
    files = {}
    for contig, records in called.items():
        text = "\n".join(
            ">" + name + "|c" + pct + " reference:" + contig + " coverage:"
            + cov + " length:" + str(n) + " consensus_threshold:" + pct
            + "%\n" + s for pct, cov, n, s in records)
        files[f"{contig}__{name}.fasta"] = (text + "\n").encode()
    return files

