"""Cross-job slab packing: N small jobs' rows in ONE shared dispatch.

Copy of ``sam2consensus_tpu/serve/packing.py`` (pinned by
``tests/test_torch_copies.py``), over the port's own ``SegmentBatch`` and
``PAD_CODE``: a segment row is raw uint8 codes with ``PAD_CODE`` (255) in
its unused cells, packed into nibbles only on the card, so the all-PAD
test of ``_real_rows`` holds on the rows as the encoders emit them.

The pileup's job state is a flat ``[L, 6]`` count tensor and addition
commutes, so packing is exact by construction: each job gets a disjoint
offset window inside one combined position axis, every segment row's
flat start is shifted by its job's offset, and the combined tensor's
slice ``[off_j, off_j + L_j)`` is the count tensor job *j*'s own
accumulation would have produced, whatever order, batching or kernel
accumulated it.  The serve scheduler (``serve/scheduler.py``) rides N
queued small jobs through one dispatch sequence and still hands each job
the bytes of its own run.

This module is the pure layer: offset planning, slab merging, count
extraction, occupancy accounting.  No device work and no scheduling
policy.  Merged slabs pad their rows to a power of two with a floor of 8
(:func:`_pad_rows`); the accumulator's trim (``ops.pileup.real_rows``)
drops the pad rows again before anything crosses the link.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..constants import PAD_CODE
from ..encoder.events import SegmentBatch


@dataclass
class PackedMember:
    """One job's slot in a pack plan.  Planned from the HEADER's genome
    length alone (the scheduler probes headers at compose time), so the
    offset table exists before any member decodes — decode and dispatch
    can overlap in waves."""

    job_id: str
    total_len: int
    offset: int = 0            # flat-position base inside the combined axis
    n_events: int = 0          # countable cells this member contributed


@dataclass
class PackPlan:
    """Disjoint offset windows over one combined position axis.

    ``total_len`` is the combined genome length the shared accumulator
    allocates; member *j* owns positions ``[offset_j, offset_j + L_j)``.
    """

    members: List[PackedMember] = field(default_factory=list)
    total_len: int = 0
    # -- merge accounting (filled by merge_batches) -----------------------
    real_rows: int = 0
    padded_rows: int = 0
    merged_slabs: int = 0

    @property
    def occupancy(self) -> float:
        """Real rows / padded rows of the merged slabs (1.0 = no pad)."""
        return (self.real_rows / self.padded_rows) if self.padded_rows \
            else 0.0


def plan_pack(members: Sequence[Tuple[str, int]]) -> PackPlan:
    """Assign each ``(job_id, total_len)`` a disjoint offset window."""
    plan = PackPlan()
    off = 0
    for job_id, total_len in members:
        plan.members.append(PackedMember(job_id=job_id,
                                         total_len=int(total_len),
                                         offset=off))
        off += int(total_len)
    plan.total_len = off
    return plan


def _real_rows(starts: np.ndarray, codes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop all-PAD rows (the pow2 pad tail, plus any genuinely empty
    encoded row — both contribute zero counts).  Vectorized: one
    first-cell prefilter catches the contiguous pad tail cheaply, the
    full-row scan runs only over the candidates."""
    first = codes[:, 0] == PAD_CODE
    if not first.any():
        return starts, codes
    keep = ~(codes == PAD_CODE).all(axis=1)
    return starts[keep], codes[keep]


def _pad_rows(n: int) -> int:
    """Merged-slab row padding: pow2, floor 8 — the authoritative
    statement of the packing layer's row-padding contract (the module
    docstring defers here).  The accumulator's pad-tail trim re-rounds
    to pow2 of the REAL rows before dispatching anyway (ops/pileup.py
    ``add``), so the dispatch shapes stay on the same canonical grid
    the prewarm compiles — this pad only squares the host array."""
    return 1 << max(3, (max(1, n) - 1).bit_length())


def merge_batches(plan: PackPlan,
                  pairs: Sequence[Tuple[PackedMember,
                                        List[SegmentBatch]]],
                  max_cells: int = 1 << 24) -> List[SegmentBatch]:
    """Remap + merge members' decoded batches into shared slabs.

    ``pairs`` is any subset of the plan's members with their decoded
    batches — the scheduler merges in WAVES (whichever members have
    finished decoding) so dispatch overlaps the remaining decodes.  Per
    bucket width, each member's rows are compacted to real rows, their
    flat starts shifted by the member's offset, concatenated across the
    wave, and re-padded pow2; buckets whose merged row count would
    exceed ``max_cells / width`` split into several slabs (the same
    cell-budget discipline as ``ops.pileup.iter_row_slices``, applied
    at build time so a merged batch cannot pin unbounded host memory).

    Pileup addition commutes, so the merge is byte-exact: the combined
    tensor's member slices equal each member's own accumulation.
    Occupancy (real/padded rows) accumulates into ``plan``.
    """
    by_w: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = {}
    for member, batches in pairs:
        member_events = 0
        for batch in batches:
            if batch.accumulated or not batch.buckets:
                continue
            for w, (starts, codes) in batch.buckets.items():
                starts, codes = _real_rows(np.asarray(starts),
                                           np.asarray(codes))
                if not len(starts):
                    continue
                slist, clist = by_w.setdefault(w, ([], []))
                slist.append(starts.astype(np.int32)
                             + np.int32(member.offset))
                clist.append(codes)
            member_events += batch.n_events
        member.n_events = member_events

    merged: List[SegmentBatch] = []
    for w in sorted(by_w):
        slist, clist = by_w[w]
        starts = np.concatenate(slist) if len(slist) > 1 else slist[0]
        codes = np.concatenate(clist) if len(clist) > 1 else clist[0]
        # rows per slab under the cell budget: align down to 1024-row
        # stripes when the budget allows one, else take the exact row
        # budget (floor 1 row) — a wide bucket must never mint a slab
        # over ``max_cells`` just to reach the alignment stripe
        budget_rows = max(1, max_cells // int(w))
        step = budget_rows // 1024 * 1024 if budget_rows >= 1024 \
            else budget_rows
        for lo in range(0, len(starts), step):
            s = starts[lo:lo + step]
            c = codes[lo:lo + step]
            n = len(s)
            n_pad = _pad_rows(n)
            st = np.zeros(n_pad, dtype=np.int32)
            st[:n] = s
            mat = np.full((n_pad, int(w)), PAD_CODE, dtype=np.uint8)
            mat[:n] = c
            nev = int(n * w - int((c == PAD_CODE).sum()))
            merged.append(SegmentBatch(buckets={int(w): (st, mat)},
                                       n_events=nev))
            plan.real_rows += n
            plan.padded_rows += n_pad
            plan.merged_slabs += 1
    return merged


def extract_counts(plan: PackPlan, combined_counts: np.ndarray
                   ) -> List[np.ndarray]:
    """Slice each member's private count partition out of the combined
    tensor (ONE host fetch upstream, N views here).  Copies: a member's
    tail may narrow/re-upload its partition independently, and the
    combined buffer must stay immutable until every member extracted —
    the count-bank discipline (partitions merged/handed out only after
    the whole dispatch succeeded)."""
    return [extract_member(combined_counts, m) for m in plan.members]


def extract_member(combined_counts: np.ndarray, member: PackedMember
                   ) -> np.ndarray:
    """One member's private partition (a copy — the combined buffer
    stays immutable until every member extracted).  The ONE slicing
    definition, shared by :func:`extract_counts` and the scheduler's
    lazy per-member fallback path."""
    lo = member.offset
    return np.ascontiguousarray(
        combined_counts[lo:lo + member.total_len])


# -- shared-reference cohorts (layout dedup) --------------------------------
def reference_fingerprint(contigs: Iterable) -> str:
    """Order-sensitive fingerprint of a reference set: sha1 over the
    header's (name, length) pairs.  Two inputs with equal fingerprints
    declare byte-identical reference LAYOUTS — same contigs, same
    lengths, same order — which is exactly the condition under which a
    pack plan's offset table can be shared verbatim across jobs
    (offsets are cumulative lengths, nothing else).  Accepts Contig
    objects or plain ``(name, length)`` pairs."""
    import hashlib

    h = hashlib.sha1()
    for c in contigs:
        name = getattr(c, "name", None)
        if name is None:
            name, length = c
        else:
            length = c.length
        h.update(str(name).encode("utf-8", "replace"))
        h.update(b"\x00")
        h.update(str(int(length)).encode("ascii"))
        h.update(b"\x00")
    return h.hexdigest()[:16]


@dataclass
class PanelGeometry:
    """ONE canonical slab geometry for a shared-reference cohort.

    When every member of a batch targets the same reference panel
    (equal :func:`reference_fingerprint`, hence equal ``total_len``),
    the offset table degenerates to ``k * panel_len`` — so the
    geometry is planned ONCE and every subsequent wave reuses the
    cached table by prefix (a wave of ``n <= max_jobs`` members takes
    ``offsets[:n]``).  ``plans_built`` / ``reuses`` are the re-plan
    evidence the cohort bench gates on: after wave 1, ``plans_built``
    stays at 1 and every wave increments ``reuses``."""

    fingerprint: str
    panel_len: int
    max_jobs: int
    offsets: Tuple[int, ...] = ()
    plans_built: int = 0
    reuses: int = 0

    def __post_init__(self) -> None:
        if not self.offsets:
            self.offsets = tuple(k * int(self.panel_len)
                                 for k in range(int(self.max_jobs)))

    def plan_wave(self, job_ids: Sequence[str]) -> PackPlan:
        """A wave's :class:`PackPlan` from the cached offset table.

        Fresh :class:`PackedMember` objects each call (the scheduler
        mutates ``n_events`` per wave), but zero re-planning: offsets
        come straight from the table built at construction."""
        if len(job_ids) > self.max_jobs:
            raise ValueError(
                f"wave of {len(job_ids)} members exceeds the panel "
                f"geometry's {self.max_jobs}-job table")
        if self.plans_built:
            self.reuses += 1
        else:
            self.plans_built = 1
        plan = PackPlan(total_len=len(job_ids) * self.panel_len)
        for k, job_id in enumerate(job_ids):
            plan.members.append(PackedMember(job_id=job_id,
                                             total_len=self.panel_len,
                                             offset=self.offsets[k]))
        return plan
