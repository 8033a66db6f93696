"""Tolerant decode: per-record malformation handling with quarantine.

Copy of ``sam2consensus_tpu/ingest/badrecords.py`` (pinned by
``tests/test_torch_copies.py``: the sidecar bytes, the budget messages
and the reason taxonomy), with the memory plane's residency calls
(``memplane.adjust`` of the stored quarantine entries).  The sink's
finalizer takes no lock: it queues its release
(``memplane.defer_release``), which the plane applies at its next drain,
where the reference's finalizer adjusts the plane (and so takes the
registry's lock) from inside the garbage collector.

Every decode rung is strict-first-error by design — correct for byte
identity against the reference oracle, but wrong for a serving fleet:
one malformed record in a multi-GB upload kills the whole job, and a
retrying tenant burns capacity re-failing on the same byte.  This
module makes malformed input a *per-record* event, uniformly across
the four ingest rungs (serial C text, sharded zero-copy, streaming
gzip, native BAM):

* ``--on-bad-record fail`` (default) keeps today's byte-identity and
  strict first-error parity: nothing in this module engages.
* ``--on-bad-record skip`` drops the record and counts it
  (``ingest/bad_records``; per-reason sub-counters).
* ``--on-bad-record quarantine`` additionally captures the raw record
  plus a structured reason (the malformation taxonomy below) into a
  bounded sidecar file next to the run's outputs.
* ``--max-bad-records N|x%`` is the error budget that converts a
  rotten file back into a clean job-level failure — a typed
  :class:`BadRecordBudgetExceeded` carrying a precise summary, never a
  retry storm.

The tolerance point is the PYTHON replay layer shared by every rung:
the C decoders keep running in line/record-flagging mode (their clean
fast path is untouched, so tolerant-mode overhead on clean input is
~zero), the flagged record replays through the golden
:class:`~..encoder.events.ReadEncoder`, and the replay's exception —
whose type/message is the strict-mode contract — is classified and
absorbed here instead of raised.

Rung invariance: the sink is partition-keyed.  Serial rungs record
into partition ``(0,)``; the sharded rung's workers record into
``(shard_idx,)`` (cleared whole on a shard retry, dropped whole on an
ingest demotion — exactly the count-bank discipline); the streaming
rung tags each worker's records with the block index it is decoding.
``entries()`` merges partitions in sorted key order, which is stream
order on every rung, so a completed tolerant run yields the same
quarantine sequence no matter which rung decoded it.

Classification taxonomy (``reason`` in counters and sidecar entries):

========================  ==============================================
``bad_field_count``       line has too few tab fields / empty RNAME
``bad_pos``               POS field is not an integer
``bad_cigar``             CIGAR op/length invalid (BAM binary op codes;
                          text CIGARs are regex-scanned like the
                          reference, so garbage text ops drop silently)
``seq_cigar_mismatch``    SEQ/CIGAR length disagreement the replay
                          could not absorb
``unknown_reference``     RNAME/refID not in the header's table
``out_of_bounds_pos``     read span leaves the reference
``bad_alphabet``          out-of-contract base (SAM text char or BAM
                          seq nibble)
``non_ascii``             undecodable byte in a text record
``bad_bam_record``        BAM structural damage bounded to one record
                          (fields overrun the record's block_size)
``malformed``             anything else the strict path would raise
========================  ==============================================

Failures that cannot be bounded to one record — a corrupt BAM
block_size that loses framing, BGZF container damage, a malformed
header — stay job-level in every mode.
"""

from __future__ import annotations

import json
import os
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: sidecar entry cap (stored records; everything past it is counted
#: but not stored, and the summary says so) — env-overridable
DEFAULT_SIDECAR_MAX = 10_000

MODES = ("fail", "skip", "quarantine")

#: native decoder reason-code hints (decoder.cpp ``enum BadReason``,
#: surfaced in out[oErrReason]); observability-only — classification
#: authority stays with the python replay so the pure-python rung can
#: never disagree with the native ones
C_REASONS = {
    1: "bad_field_count",
    2: "bad_pos",
    3: "bad_cigar",
    4: "seq_cigar_mismatch",
    5: "unknown_reference",
    6: "out_of_bounds_pos",
    7: "bad_alphabet",
    8: "bad_bam_record",
}


#: exception types that bound to ONE record on the strict decode paths
#: (the replay layer's tolerant catch): parse-level IndexError/ValueError
#: from the positional field access, KeyError from the base alphabet,
#: UnicodeDecodeError from a non-ascii byte in a text line.  EncodeError
#: subclasses ValueError, so encode-level contract violations are
#: covered too.  Anything OUTSIDE this tuple — container damage, header
#: corruption, MemoryError — stays job-level in every mode.
RECORD_ERRORS = (ValueError, KeyError, IndexError, UnicodeDecodeError)


class BadRecordBudgetExceeded(RuntimeError):
    """The run's ``--max-bad-records`` budget is spent: the input is
    rotten, not merely blemished, and the job fails as a unit with a
    precise summary.

    ``data_error`` marks the DATA resilience class
    (``resilience/policy.py``): the failure is a property of the INPUT
    BYTES — retrying cannot fix it, demoting the ladder rung cannot fix
    it, and a serve tenant submitting it must not be pinned off the
    device path for it."""

    data_error = True
    budget_exhausted = True

    def __init__(self, msg: str, summary: Optional[dict] = None):
        super().__init__(msg)
        self.summary = summary or {}


def is_data_error(exc: BaseException) -> bool:
    """The DATA-class marker check (mirrors the ``transient`` marker
    protocol: an attribute, not an import, so low layers never cycle)."""
    return bool(getattr(exc, "data_error", False))


def classify_reason(exc: BaseException) -> str:
    """Map a strict-mode decode exception to its taxonomy reason.

    Works from the exception's type and the contract MESSAGES the
    encoders raise (which are themselves pinned by the oracle-parity
    tests), so the pure-python and native rungs classify identically.
    """
    if isinstance(exc, UnicodeDecodeError):
        return "non_ascii"
    msg = str(exc)
    if "unknown reference" in msg or "outside the reference table" in msg:
        return "unknown_reference"
    if "outside reference" in msg:
        return "out_of_bounds_pos"
    if "out-of-alphabet" in msg:
        return "bad_alphabet"
    if "BAM record" in msg or "CIGAR op code" in msg \
            or "CIGAR runs past" in msg:
        # record-bounded BAM damage (formats/bam.py BamParseError and
        # the binary-CIGAR decode errors)
        return "bad_cigar" if "CIGAR" in msg else "bad_bam_record"
    if isinstance(exc, ValueError) and ("invalid literal" in msg
                                        or "int()" in msg):
        return "bad_pos"
    if isinstance(exc, IndexError):
        # iter_records' positional field access: fields[5]/fields[9]/
        # RNAME .split()[0] on a short line
        return "bad_field_count"
    if isinstance(exc, KeyError):
        return "bad_alphabet"
    return "malformed"


@dataclass
class BadRecordPolicy:
    """The resolved ``--on-bad-record`` / ``--max-bad-records`` policy."""

    mode: str = "fail"
    max_bad: Optional[int] = None        # absolute budget (count >= N fails)
    max_pct: Optional[float] = None      # percent budget, checked at finish
    sidecar_path: Optional[str] = None
    sidecar_max: int = DEFAULT_SIDECAR_MAX

    @property
    def tolerant(self) -> bool:
        return self.mode in ("skip", "quarantine")


def parse_budget(spec: str) -> Tuple[Optional[int], Optional[float]]:
    """``--max-bad-records`` grammar: "" (no budget), ``N`` (absolute:
    the Nth bad record fails the job) or ``x%`` (fraction of all
    records processed, checked at stream end).  Raises ValueError on
    anything else."""
    spec = (spec or "").strip()
    if not spec:
        return None, None
    if spec.endswith("%"):
        try:
            pct = float(spec[:-1])
        except ValueError:
            raise ValueError(
                f"--max-bad-records: not a percentage: {spec!r}") from None
        if not 0 <= pct <= 100:
            raise ValueError(
                f"--max-bad-records percentage out of range: {spec!r}")
        return None, pct / 100.0
    try:
        n = int(spec)
    except ValueError:
        raise ValueError(
            f"--max-bad-records: not a count or percentage: "
            f"{spec!r}") from None
    if n < 0:
        raise ValueError(f"--max-bad-records must be >= 0: {spec!r}")
    return n, None


def policy_from_config(cfg) -> BadRecordPolicy:
    """Resolve the run's bad-record policy from a RunConfig (validated
    at CLI parse time; API callers get the same ValueError)."""
    mode = getattr(cfg, "on_bad_record", "fail") or "fail"
    if mode not in MODES:
        raise ValueError(
            f"on_bad_record={mode!r}: use one of {MODES}")
    max_bad, max_pct = parse_budget(getattr(cfg, "max_bad_records", ""))
    if (max_bad is not None or max_pct is not None) and mode == "fail":
        raise ValueError(
            "--max-bad-records needs a tolerant mode "
            "(--on-bad-record skip|quarantine)")
    sidecar = getattr(cfg, "quarantine_out", None)
    if sidecar and mode != "quarantine":
        raise ValueError(
            "--quarantine-out needs --on-bad-record quarantine "
            f"(got --on-bad-record {mode}): refusing to silently "
            "ignore the requested evidence sidecar")
    if mode == "quarantine" and not sidecar:
        out = getattr(cfg, "outfolder", "./") or "./"
        prefix = getattr(cfg, "prefix", "") or "quarantine"
        sidecar = os.path.join(out, f"{prefix}_quarantine.jsonl")
    try:
        sidecar_max = int(os.environ.get("S2C_QUARANTINE_MAX",
                                         str(DEFAULT_SIDECAR_MAX)))
    except ValueError:
        sidecar_max = DEFAULT_SIDECAR_MAX
    return BadRecordPolicy(mode=mode, max_bad=max_bad, max_pct=max_pct,
                           sidecar_path=sidecar if mode == "quarantine"
                           else None,
                           sidecar_max=max(0, sidecar_max))


def _entry_nbytes(entry: dict) -> int:
    """Approximate resident bytes of one stored quarantine entry (the
    record text dominates; 160 covers the dict/key overhead): the memory
    plane's sizing for the ``quarantine`` family."""
    return len(entry.get("record") or "") \
        + len(entry.get("error") or "") + 160


def _release_quarantine(cell: dict) -> None:
    """weakref finalizer: queue the release of whatever the sink still
    tracked when it was collected (module-level, so it holds no sink
    reference; takes no lock)."""
    from ..observability import memplane

    memplane.defer_release("quarantine", cell["bytes"])


class _Partition:
    """One partition's bad-record state: counts always, stored entries
    only in quarantine mode (the skip mode still needs exact per-
    partition counts so a shard retry can roll its attempt back)."""

    __slots__ = ("count", "reasons", "entries")

    def __init__(self):
        self.count = 0
        self.reasons: Dict[str, int] = {}
        self.entries: List[dict] = []


class QuarantineSink:
    """Thread-safe, partition-keyed collector of bad records.

    One sink per run, shared by every encoder the run builds (the
    shard scheduler's workers, their python replay twins, the BAM
    encoder).  ``record`` absorbs one bad record; the ABSOLUTE error
    budget is enforced here — the recording thread raises
    :class:`BadRecordBudgetExceeded` the moment the global count
    reaches the budget, on whichever rung it is, so a rotten file
    fails as early as the rung's ordering allows.  The PERCENT budget
    is enforced by :meth:`finish` once the total record count is
    known.
    """

    def __init__(self, policy: BadRecordPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self._parts: Dict[Tuple, _Partition] = {}
        self._sidecar_written: Optional[str] = None
        self._total = 0               # bad records across all partitions
        self._stored = 0              # entries held across all partitions
        self._hi: Optional[Tuple] = None   # cached max stored key
        self._hi_valid = True
        # residency accounting (observability/memplane.py): the cell
        # holds this sink's live quarantine bytes so the finalizer can
        # release exactly what is still tracked when the sink goes away
        self._mem_cell = {"bytes": 0}
        weakref.finalize(self, _release_quarantine, self._mem_cell)

    def _mem_adjust(self, delta: int) -> None:
        from ..observability import memplane

        self._mem_cell["bytes"] = max(0, self._mem_cell["bytes"] + delta)
        memplane.adjust("quarantine", delta)

    # -- recording ---------------------------------------------------------
    def record(self, raw, exc: BaseException,
               partition: Tuple = (0,), offset: Optional[int] = None,
               reason: Optional[str] = None) -> None:
        """Absorb one bad record.  ``raw`` is the record's raw bytes/str
        (text line or rendered BAM record); ``offset`` the input offset
        when the rung knows it.  Raises the budget error when the
        absolute budget is spent."""
        why = reason or classify_reason(exc)
        budget_hit = None
        with self._lock:
            part = self._parts.setdefault(tuple(partition), _Partition())
            part.count += 1
            self._total += 1
            part.reasons[why] = part.reasons.get(why, 0) + 1
            if self.policy.mode == "quarantine":
                if isinstance(raw, (bytes, bytearray, memoryview)):
                    raw = bytes(raw).decode("ascii",
                                            errors="backslashreplace")
                self._store(tuple(partition), part, {
                    "record": str(raw).rstrip("\r\n"),
                    "reason": why,
                    "error": f"{type(exc).__name__}: {exc}",
                    "offset": int(offset) if offset is not None else None,
                })
            if self.policy.max_bad is not None \
                    and self._total >= self.policy.max_bad:
                budget_hit = self._total
        if budget_hit is not None:
            err = BadRecordBudgetExceeded(
                f"bad-record budget exhausted: {budget_hit} bad "
                f"record(s) >= --max-bad-records {self.policy.max_bad} "
                f"(last: {why})", self.summary())
            err.sink = self      # abort bookkeeping finds the evidence
            raise err

    def _store(self, key: Tuple, part: _Partition, entry: dict) -> None:
        """Bounded, merge-order-correct storage (caller holds the lock).

        The sidecar wants the FIRST ``sidecar_max`` entries in merged
        partition order plus the knowledge that more existed, so the
        sink retains at most ``sidecar_max + 1`` entries across all
        partitions.  An entry whose partition key sorts after every
        stored entry while the window is already full can never make
        the sidecar — it is counted but not stored (that is what keeps
        a million-bad-record file from holding a million dicts).  An
        entry belonging BEFORE the window's tail is stored and the
        merge-order-last stored entry is evicted to keep the bound."""
        cap = self.policy.sidecar_max + 1
        if not self._hi_valid:
            self._hi = max((k for k, p in self._parts.items()
                            if p.entries), default=None)
            self._hi_valid = True
        if self._stored >= cap and self._hi is not None and key > self._hi:
            return                      # count-only: past the window
        part.entries.append(entry)
        self._stored += 1
        # residency accounting: the bounded sidecar window is the
        # quarantine mode's one real in-process allocation
        self._mem_adjust(_entry_nbytes(entry))
        if self._hi is None or key > self._hi:
            self._hi = key
        while self._stored > cap:
            hi_part = self._parts[self._hi]
            evicted = hi_part.entries.pop()  # merge-order-last stored
            self._mem_adjust(-_entry_nbytes(evicted))
            self._stored -= 1
            if not hi_part.entries:
                self._hi = max((k for k, p in self._parts.items()
                                if p.entries), default=None)

    def clear_partition(self, partition: Tuple) -> None:
        """Roll back one partition whole — a shard attempt that failed
        on an infrastructure fault retries against a clean slate, so
        nothing can double-count."""
        with self._lock:
            part = self._parts.pop(tuple(partition), None)
            if part is not None:
                self._total -= part.count
                self._stored -= len(part.entries)
                self._mem_adjust(-sum(_entry_nbytes(e)
                                      for e in part.entries))
                self._hi_valid = False

    def reset(self) -> None:
        """Roll back everything — the sharded ingest demoted to the
        serial rung against zeroed counts; the fresh pass re-records."""
        with self._lock:
            self._parts.clear()
            self._total = 0
            self._stored = 0
            self._mem_adjust(-self._mem_cell["bytes"])
            self._hi = None
            self._hi_valid = True

    # -- read side ---------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    def reason_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for p in self._parts.values():
                for why, n in p.reasons.items():
                    out[why] = out.get(why, 0) + n
            return dict(sorted(out.items()))

    def entries(self) -> List[dict]:
        """Quarantined entries merged deterministically: partitions in
        sorted key order (stream order on every rung), entries in
        decode order within each partition."""
        with self._lock:
            out: List[dict] = []
            for key in sorted(self._parts):
                out.extend(self._parts[key].entries)
            return out

    def summary(self) -> dict:
        entries = self.entries()
        n = self.count
        return {
            "mode": self.policy.mode,
            "bad_records": n,
            "quarantined": min(len(entries), self.policy.sidecar_max)
            if self.policy.mode == "quarantine" else 0,
            "truncated": len(entries) > self.policy.sidecar_max,
            "reasons": self.reason_counts(),
            "sidecar": self._sidecar_written,
        }

    # -- finish ------------------------------------------------------------
    def finish(self, total_records: int) -> dict:
        """End-of-stream bookkeeping: enforce the percent budget, write
        the sidecar (quarantine mode, when anything was caught), and
        return the summary.  Raises :class:`BadRecordBudgetExceeded`
        when the percent budget is blown — AFTER the sidecar write, so
        the failed job still leaves its evidence on disk."""
        n = self.count
        if self.policy.mode == "quarantine" and n \
                and self.policy.sidecar_path:
            self.write_sidecar(self.policy.sidecar_path)
        if self.policy.max_pct is not None and total_records > 0:
            frac = n / float(total_records)
            if frac > self.policy.max_pct:
                err = BadRecordBudgetExceeded(
                    f"bad-record budget exhausted: {n}/{total_records} "
                    f"records ({100.0 * frac:.2f}%) exceed "
                    f"--max-bad-records "
                    f"{100.0 * self.policy.max_pct:g}%", self.summary())
                err.sink = self
                raise err
        return self.summary()

    def write_sidecar(self, path: str) -> str:
        """Write the bounded sidecar (atomic tmp+replace, like every
        other artifact a prober may poll): a schema header line, one
        JSON object per stored record, and a trailing summary line."""
        entries = self.entries()
        stored = entries[: self.policy.sidecar_max]
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            # evidence tries hard to land: a sidecar path in a not-yet-
            # existing directory must not fail the job after a decode
            # that succeeded (nor vanish silently on a budget abort)
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps({"schema": "s2c-quarantine/1"}) + "\n")
            for k, e in enumerate(stored):
                fh.write(json.dumps({"seq": k, **e},
                                    ensure_ascii=False) + "\n")
            self._sidecar_written = os.path.abspath(path)
            fh.write(json.dumps({"summary": self.summary()},
                                ensure_ascii=False) + "\n")
        os.replace(tmp, path)
        return self._sidecar_written

    def publish(self, reg) -> None:
        """Counters into the run's registry: ``ingest/bad_records`` (+
        per-reason), ``quarantine/records``/``quarantine/truncated``,
        and the ``quarantine/summary`` gauge the manifest picks up."""
        n = self.count
        if n:
            reg.add("ingest/bad_records", n)
            for why, k in self.reason_counts().items():
                reg.add(f"ingest/bad_records/{why}", k)
        if self.policy.mode == "quarantine":
            s = self.summary()
            reg.add("quarantine/records", s["quarantined"])
            if s["truncated"]:
                reg.add("quarantine/truncated", 1)
        if n or self.policy.tolerant:
            reg.gauge("quarantine/summary").set_info(self.summary())


def abort_bookkeeping(exc: BaseException, reg) -> None:
    """Budget-abort evidence: called by the backends' run wrappers when
    a :class:`BadRecordBudgetExceeded` escapes the pipeline — whichever
    rung/thread raised it.  Writes the sidecar if quarantine mode never
    got to (the absolute budget aborts mid-decode, before ``finish``),
    publishes the counters into the run's registry so the manifest and
    ``--metrics-out`` carry the story, and refreshes the exception's
    summary with the final sidecar path."""
    sink = getattr(exc, "sink", None)
    if sink is None:
        return
    pol = sink.policy
    if pol.mode == "quarantine" and pol.sidecar_path \
            and sink._sidecar_written is None:
        try:
            sink.write_sidecar(pol.sidecar_path)
        except OSError:      # failed evidence write never masks the error
            pass
    if reg is not None:
        sink.publish(reg)
    exc.summary = sink.summary()


def sink_from_config(cfg) -> Optional[QuarantineSink]:
    """The run's sink, or None when ``--on-bad-record fail`` (the
    default): a None sink is the signal to every encoder that strict
    semantics apply unchanged."""
    policy = policy_from_config(cfg)
    if not policy.tolerant:
        return None
    return QuarantineSink(policy)


def mark_offset(exc: BaseException, offset: Optional[int]) -> BaseException:
    """Attach the input offset to a strict-mode decode error (attribute,
    not message — the message is oracle-parity contract).  First marker
    wins: the deepest frame knows the true offset."""
    if offset is not None and getattr(exc, "s2c_offset", None) is None:
        try:
            exc.s2c_offset = int(offset)
        except (AttributeError, TypeError):  # pragma: no cover - exotic exc
            pass
    return exc
