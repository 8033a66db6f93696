"""Crash-safe job journal: a serve queue that survives ``kill -9``.

Copy of ``sam2consensus_tpu/serve/journal.py`` (pinned by
``tests/test_torch_copies.py``): the same segments, events and replay,
and the same ``job_key`` for the same flags, so a journal written by one
package's server reads in the other's.

A runner without it keeps the queue in process memory — a crash mid-queue
lost every pending job and forgot which jobs already ran, so a naive
re-launch either dropped work or ran it twice.  The journal makes the
queue durable with the cheapest discipline that is actually
crash-safe on POSIX: an append-only sequence of single-event JSON
SEGMENTS, each written to a temp file, fsynced, and PUBLISHED with
``os.link`` — an O_EXCL-style rename that FAILS when the target
sequence number is already taken, which is what makes the journal safe
for MULTIPLE writer processes (the fleet, below): two workers racing
for segment N cannot tear or overwrite each other; exactly one wins N,
the loser re-scans and takes N+1.  A ``kill -9`` at any instant leaves
only whole events behind — there is no shared append file whose torn
last line needs heuristic repair, and replay order is the segment
sequence number, not mtime.

Event vocabulary (one JSON object per segment)::

    submitted     {job, key, filename, seq}
    started       {job, key, ckpt[, worker, tenant]}
    committed     {job, key, outputs: {path: fingerprint}, elapsed_sec
                   [, worker, tenant]}
    failed        {job, key, error}
    rejected      {job, key, reason}       # admission control audit
    resumed       {job, key, mode}         # restart bookkeeping (audit)
    claimed       {job, key, worker, expires_unix}   # fleet: lease open
    lease_renewed {key, worker, expires_unix}        # fleet: TTL push
    lease_expired {key, worker, reaper}              # fleet: lease reap
    session_open  {key, tenant, header_sha, refs}    # stream: session born
    wave_received {key, wave, sha, reads, bytes}     # stream: durable intent
    wave_absorbed {key, wave, sha, reads_total, digest
                   [, worker, claim_seq]}            # stream: counted once
    wave_rejected {key, wave, reason}                # stream: DATA-class audit
    session_stable{key, wave, digest, waves_stable}  # stream: read-until
    session_closed{key, worker, outputs, digest}     # stream: terminal

A job's IDENTITY (``key``) hashes its input path plus every config
field that changes the output bytes — so a restarted server given the
same queue recognizes its jobs even though Python object identity is
gone, while a changed threshold/outfolder reads as a different job.

Replay semantics (:meth:`JobJournal.replay`):

* a key whose last lifecycle event is ``committed`` AND whose recorded
  output files still match their fingerprints is SKIPPED on restart
  (zero duplicated jobs — the fingerprint is the audit, not trust);
* a key with ``started`` but no terminal event was IN FLIGHT when the
  process died: it re-runs, resuming from its per-job checkpoint dir
  (the emergency/periodic checkpoints) when one survived;
* everything else re-runs from scratch (zero lost jobs).

Claim/lease semantics (serve/fleet.py drives these; replay just keeps
the state machine):

* the FIRST ``claimed`` event for a key — in segment order, which the
  O_EXCL publication makes a total order — opens that key's lease;
  later ``claimed`` events while a lease is open are LOSING claims and
  are ignored (the loser observes this on replay and moves on);
* ``lease_renewed`` by the holding worker pushes ``expires_unix``;
* ``lease_expired`` (appended by a REAPER that observed the wall-clock
  expiry) closes the lease, so the next ``claimed`` can win — this is
  how a SIGKILL'd or frozen worker's in-flight job gets re-claimed;
* ``committed``/``failed`` close the lease terminally.

Streaming-session semantics (serve/session.py drives these; the
journal is again just the durable state machine):

* a SESSION is a journal entity whose key is its session id; it reuses
  the claim/lease trio above unchanged (the lease code is key-generic),
  so a SIGKILL'd worker's open session is reaped and stolen exactly
  like an in-flight job;
* ``wave_received`` is the durable INTENT — appended before any ingest
  work, carrying the wave body's sha256, so a steal replays exactly the
  waves whose intent exists but whose ``wave_absorbed`` does not;
* ``wave_absorbed`` is the exactly-once COMMIT of one wave into the
  session's count tensors.  It is lease-FENCED like ``committed``: once
  the session key has ever been claimed, an absorb not matching the
  open lease's (worker, claim_seq) lineage is VOID on replay — a zombie
  mid-wave when its lease was stolen cannot double-count the wave;
* ``wave_rejected`` audits a DATA-class wave (malformed body, torn
  spool detected by sha mismatch) — never absorbed, never retried;
* ``session_stable`` records the read-until verdict (consensus digest
  unchanged for N consecutive waves); ``session_closed`` is terminal
  and closes the lease like ``committed``.

Replay cursor/compaction: every ``checkpoint_every`` appends the
journal writes a ``checkpoint-NNNNNNNN.json`` summary segment — the
full :class:`ReplayState` as of segment N, built from a fresh disk
replay (never from a possibly-stale in-memory mirror).  ``replay()``
loads the newest readable checkpoint and applies only the segments
past it, so a long-lived fleet journal replays O(tail), not
O(lifetime); ``replay(full=True)`` ignores checkpoints (the audit path
that proves compacted replay == full replay), and :meth:`prune`
deletes the segments a checkpoint already covers.

The ``journal_write`` fault-injection site fires on every segment
append (resilience/faultinject.py; the serve runner checks it against
its queue-lifetime injector).  An append failure is surfaced to the
caller — the runner decides the policy (a failed COMMIT append leaves
the job to be re-verified-by-fingerprint on the next restart, which is
the safe direction: re-checking work is cheap, losing it is not).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("sam2consensus_torch.serve.journal")

SCHEMA = "s2c-journal/1"
CKPT_SCHEMA = "s2c-journal-checkpoint/1"

#: fields of RunConfig that change the OUTPUT BYTES of a job — the job
#: key hashes exactly these, so a re-queued job with a different
#: threshold/outfolder is a different job, while backend-side knobs
#: (pileup strategy, wire codec, retries) keep the same identity: they
#: must produce byte-identical outputs anyway
KEY_FIELDS = ("thresholds", "min_depth", "fill", "maxdel", "prefix",
              "nchar", "outfolder", "py2_compat", "strict")

#: lifecycle events; ``rejected``/``resumed`` are audit-only, the
#: ``claimed``/``lease_*`` trio is the fleet's work-stealing layer,
#: and the ``session_*``/``wave_*`` family is the streaming-session
#: materialized view (serve/session.py)
EVENTS = ("submitted", "started", "committed", "failed", "rejected",
          "resumed", "claimed", "lease_renewed", "lease_expired",
          "session_open", "wave_received", "wave_absorbed",
          "wave_rejected", "session_stable", "session_closed",
          "cohort_wave")
#: ``cohort_wave`` (serve/cohort.py) marks one manifest wave fully
#: finalized — the cohort driver's resume position.  Replay ignores it
#: for job state (member jobs carry their own per-job lifecycles; the
#: wave marker is an audit/progress record, not a commit fence).

#: default appends between checkpoint segments (S2C_JOURNAL_CKPT_EVERY
#: overrides; 0 disables).  Small enough that a busy fleet journal's
#: replay tail stays a few hundred segments, large enough that the
#: full-replay cost of writing one is paid rarely.
DEFAULT_CHECKPOINT_EVERY = 512

#: bounded retry for the O_EXCL segment-number race — each loss means
#: another writer PUBLISHED a segment, so 64 losses in a row would
#: need 64 concurrent appends landing between our rescans
_APPEND_ATTEMPTS = 64


def _session_view(st: "ReplayState", key: str) -> dict:
    """The (lazily created) replay view of one streaming session."""
    return st.sessions.setdefault(key, {
        "status": "open", "waves": {}, "absorbed": {},
        "absorb_counts": {}, "rejected": {}, "reads_total": 0,
        "digest": "", "stable": False, "stable_wave": None,
        "opened_t": 0.0, "last_wave_t": 0.0})


def effective_rejections(view: dict) -> set:
    """Wave numbers (string keys) of one session view whose rejection
    actually gates replay.

    A ``wave_rejected`` record is EFFECTIVE when the wave was never
    received at all (a pre-receive rejection — declared-sha mismatch,
    malformed body: there is nothing to replay) or when the rejection
    was journaled AFTER the wave's durable intent (a torn spool).  A
    rejection OLDER than the intent names a previous use of the wave
    number — honoring it would silently drop an ACKed-but-unabsorbed
    wave on crash recovery or steal with a clean audit, which is
    exactly the lost-reads failure the journal exists to make
    impossible.  The session layer no longer reuses wave numbers at
    all (rejections consume theirs), so this fence is the structural
    backstop for journals written before that rule."""
    out = set()
    waves = view.get("waves") or {}
    for w, rej in (view.get("rejected") or {}).items():
        rej_seq = int(rej.get("seq", 0)) if isinstance(rej, dict) else 0
        wave = waves.get(w)
        if wave is None or rej_seq > int(wave.get("seq", 0)):
            out.add(w)
    return out


def job_key(filename: str, config) -> str:
    """Stable identity of (input, output-relevant config)."""
    cfg = {f: getattr(config, f, None) for f in KEY_FIELDS}
    blob = json.dumps({"filename": os.path.abspath(filename), **cfg},
                      sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def file_sha256(path: str) -> Optional[str]:
    try:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        return "sha256:" + h.hexdigest()
    except OSError:
        return None


def file_fingerprint(path: str) -> Optional[dict]:
    """Commit-time output fingerprint: content hash PLUS the stat pair
    (size, mtime) that lets the resume-time verifier skip the re-hash
    when the file demonstrably never changed (see
    :meth:`JobJournal.verify_outputs`)."""
    sha = file_sha256(path)
    if sha is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    return {"sha256": sha, "size": st.st_size,
            "mtime": round(st.st_mtime, 6)}


@dataclass
class ReplayState:
    """What a restarted server knows about its queue."""

    #: key -> the committed event dict (outputs fingerprints inside)
    committed: Dict[str, dict] = field(default_factory=dict)
    #: key -> last failure reason (terminal in its process; re-run-able)
    failed: Dict[str, str] = field(default_factory=dict)
    #: keys started but never committed/failed — in flight at the crash
    inflight: Dict[str, dict] = field(default_factory=dict)
    #: per-key count of committed events across the whole journal — the
    #: duplication audit (anything > 1 means a job ran twice)
    commit_counts: Dict[str, int] = field(default_factory=dict)
    #: every key ever journaled as submitted (restart re-submits are
    #: deduped against this)
    submitted: set = field(default_factory=set)
    #: key -> the OPEN lease: {worker, claim_seq, expires_unix} — the
    #: winning claim per key (fleet mode; see the module docstring)
    claims: Dict[str, dict] = field(default_factory=dict)
    #: keys that have EVER been claimed — once a key's lifecycle uses
    #: leases, its commits are FENCED: a ``committed`` event must come
    #: from the holder of the key's open lease (worker + claim_seq) or
    #: it is void on replay.  This is what makes duplicated=0
    #: structural under split-brain: a zombie whose pending commit
    #: append lands AFTER the thief's commit is rejected by journal
    #: order, not by a racy pre-append check.
    claimed_ever: set = field(default_factory=set)
    #: key -> count of commit events VOIDED by the lease fence (a
    #: zombie's stale append) — forensic, not part of commit_counts
    stale_commits: Dict[str, int] = field(default_factory=dict)
    #: key -> tenant label, from started events that carried one (the
    #: journal-visible input to fleet-global admission accounting)
    tenants: Dict[str, str] = field(default_factory=dict)
    #: key -> wall time of the FIRST submitted event — the flight
    #: recorder's queue-wait epoch (observability/flight.py): journal-
    #: measured queue wait is started.t - submit_times[key], which
    #: survives restarts and steals where a process-local window epoch
    #: cannot
    submit_times: Dict[str, float] = field(default_factory=dict)
    #: key -> streaming-session view (serve/session.py): status,
    #: received waves (``waves``), effective absorbs (``absorbed``),
    #: per-wave absorb counts (the duplication audit — anything > 1
    #: means a wave was counted twice), rejected waves, cumulative
    #: read count, last consensus digest and the stability verdict.
    #: Wave numbers are STRING keys so the dict round-trips through
    #: JSON checkpoints unchanged.
    sessions: Dict[str, dict] = field(default_factory=dict)
    last_seq: int = 0
    events: int = 0
    corrupt_segments: int = 0

    # -- checkpoint (de)serialization ----------------------------------
    def to_blob(self) -> dict:
        return {"schema": CKPT_SCHEMA,
                "committed": self.committed, "failed": self.failed,
                "inflight": self.inflight,
                "commit_counts": self.commit_counts,
                "submitted": sorted(self.submitted),
                "claims": self.claims, "tenants": self.tenants,
                "claimed_ever": sorted(self.claimed_ever),
                "stale_commits": self.stale_commits,
                "submit_times": self.submit_times,
                "sessions": self.sessions,
                "last_seq": self.last_seq, "events": self.events,
                "corrupt_segments": self.corrupt_segments}

    @classmethod
    def from_blob(cls, blob: dict) -> "ReplayState":
        st = cls()
        st.committed = dict(blob.get("committed") or {})
        st.failed = dict(blob.get("failed") or {})
        st.inflight = dict(blob.get("inflight") or {})
        st.commit_counts = dict(blob.get("commit_counts") or {})
        st.submitted = set(blob.get("submitted") or ())
        st.claims = dict(blob.get("claims") or {})
        st.tenants = dict(blob.get("tenants") or {})
        st.claimed_ever = set(blob.get("claimed_ever") or ())
        st.stale_commits = dict(blob.get("stale_commits") or {})
        st.submit_times = dict(blob.get("submit_times") or {})
        st.sessions = dict(blob.get("sessions") or {})
        st.last_seq = int(blob.get("last_seq", 0))
        st.events = int(blob.get("events", 0))
        st.corrupt_segments = int(blob.get("corrupt_segments", 0))
        return st


class JobJournal:
    """Append-only journal over atomic single-event segments.

    Safe for CONCURRENT writer processes sharing ``root`` (the fleet):
    appends publish via ``os.link`` so a sequence-number race has
    exactly one winner, never a torn or overwritten segment.

    ``fault_cb`` (the serve runner's queue-lifetime injector hook) is
    called with site ``journal_write`` before every append.
    """

    def __init__(self, root: str,
                 fault_cb: Optional[Callable[[str], None]] = None,
                 checkpoint_every: Optional[int] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.fault_cb = fault_cb
        if checkpoint_every is None:
            try:
                checkpoint_every = int(os.environ.get(
                    "S2C_JOURNAL_CKPT_EVERY", DEFAULT_CHECKPOINT_EVERY))
            except ValueError:
                checkpoint_every = DEFAULT_CHECKPOINT_EVERY
        self.checkpoint_every = max(0, checkpoint_every)
        #: serializes THIS process's appends: the O_EXCL link already
        #: arbitrates across processes, but concurrent handler threads
        #: (the streaming front door) would otherwise race on _seq /
        #: the mirror and burn link-collision retries for nothing
        self._append_lock = threading.Lock()
        self._seq = self._max_seq() + 1
        #: in-memory mirror of ReplayState, maintained incrementally by
        #: append() so position() (called at every health publish) does
        #: not re-read the whole segment directory per job.  The mirror
        #: only sees THIS process's appends plus whatever the last
        #: replay() read — fleet coordination (serve/fleet.py) always
        #: arbitrates from a fresh replay(), never from the mirror.
        self._mirror: Optional[ReplayState] = None

    # -- segment mechanics -------------------------------------------------
    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.root, f"ev-{seq:08d}.json")

    def _ckpt_path(self, seq: int) -> str:
        return os.path.join(self.root, f"checkpoint-{seq:08d}.json")

    def _listing(self, prefix: str) -> List[Tuple[int, str]]:
        """(seq, path) for every ``<prefix>-NNNNNNNN.json`` in root,
        seq-sorted."""
        out: List[Tuple[int, str]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        head = prefix + "-"
        for n in names:
            if not (n.startswith(head) and n.endswith(".json")):
                continue
            try:
                out.append((int(n[len(head):-5]),
                            os.path.join(self.root, n)))
            except ValueError:
                continue
        out.sort()
        return out

    def _segments(self) -> List[str]:
        return [p for _, p in self._listing("ev")]

    def _max_seq(self) -> int:
        """Highest sequence number the journal knows about — segments
        AND checkpoints (after :meth:`prune` the checkpoint may be the
        only record of where the sequence got to)."""
        segs = self._listing("ev")
        ckpts = self._listing("checkpoint")
        top = 0
        if segs:
            top = max(top, segs[-1][0])
        if ckpts:
            top = max(top, ckpts[-1][0])
        return top

    def append(self, ev: str, **fields) -> int:
        """Durably record one event; returns its sequence number.

        tmp + fsync + ``os.link``: after this returns, the event
        survives ``kill -9``; if the process dies inside, the journal
        simply does not contain the event — never half of it.  The link
        (not a rename) is what makes MULTI-process appends safe: it
        fails with EEXIST when another writer already owns the target
        sequence number, and the loser retries on the next free one."""
        assert ev in EVENTS, ev
        if self.fault_cb is not None:
            self.fault_cb("journal_write")
        last_exc: Optional[BaseException] = None
        # one intra-process writer at a time (tmp-file names collide
        # per-pid, _seq/mirror updates stay coherent); cross-PROCESS
        # arbitration stays with the O_EXCL link below
        with self._append_lock:
            for _ in range(_APPEND_ATTEMPTS):
                seq = self._seq
                rec = {"schema": SCHEMA, "seq": seq, "ev": ev,
                       "t": round(time.time(), 3), **fields}
                path = self._seg_path(seq)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(rec, fh, sort_keys=True)
                    fh.write("\n")
                    fh.flush()
                    os.fsync(fh.fileno())
                try:
                    os.link(tmp, path)
                except FileExistsError as exc:
                    # another writer published this seq between our
                    # scan and our link: re-anchor past everything
                    # visible now
                    last_exc = exc
                    os.unlink(tmp)
                    self._seq = max(self._seq + 1, self._max_seq() + 1)
                    continue
                os.unlink(tmp)
                self._seq = seq + 1
                if self._mirror is not None:  # keep the mirror current
                    self._apply(self._mirror, rec)
                if self.checkpoint_every \
                        and seq % self.checkpoint_every == 0:
                    try:
                        self.write_checkpoint()
                    except Exception as exc:  # compaction is optional
                        logger.warning(
                            "journal checkpoint at seq %d failed "
                            "(%s: %s): replay stays O(lifetime)",
                            seq, type(exc).__name__, exc)
                return seq
        raise OSError(
            f"journal append lost the segment race {_APPEND_ATTEMPTS} "
            f"times in a row ({last_exc}) — is something flooding "
            f"{self.root}?")

    def events(self, from_seq: int = 0) -> List[dict]:
        """Every readable event with seq > ``from_seq`` in sequence
        order; corrupt/truncated segments (possible only from external
        damage — appends are atomic) are skipped with a warning, not
        raised.  A numbering GAP below the visible maximum triggers one
        re-list: a concurrent writer links segment N strictly before
        anyone can create N+1, but a directory scan racing both may
        catch the newer entry first."""
        listing = [(s, p) for s, p in self._listing("ev")
                   if s > from_seq]
        if listing:
            want = set(range(listing[0][0], listing[-1][0] + 1))
            have = {s for s, _ in listing}
            # a gap at the FRONT is expected after prune(); only
            # re-list for holes between visible segments
            if want - have:
                listing = [(s, p) for s, p in self._listing("ev")
                           if s > from_seq]
        out: List[dict] = []
        for _, p in listing:
            try:
                with open(p, encoding="utf-8") as fh:
                    out.append(json.load(fh))
            except Exception as exc:
                logger.warning("journal segment %s unreadable (%s: %s): "
                               "skipped", p, type(exc).__name__, exc)
                out.append({"ev": "_corrupt", "path": p})
        return out

    # -- replay ------------------------------------------------------------
    @staticmethod
    def _apply(st: ReplayState, rec: dict) -> None:
        """One event's state transition — shared by the full-disk replay
        and the incremental in-memory mirror, so they cannot drift."""
        ev = rec.get("ev")
        if ev == "_corrupt":
            st.corrupt_segments += 1
            return
        st.events += 1
        st.last_seq = max(st.last_seq, int(rec.get("seq", 0)))
        key = rec.get("key")
        if not key:
            return
        if ev == "submitted":
            st.submitted.add(key)
            if key not in st.submit_times:
                try:
                    st.submit_times[key] = float(rec.get("t", 0.0))
                except (TypeError, ValueError):
                    st.submit_times[key] = 0.0
            if rec.get("tenant"):
                st.tenants[key] = rec["tenant"]
        elif ev == "started":
            st.inflight[key] = rec
            st.failed.pop(key, None)
            if rec.get("tenant"):
                st.tenants[key] = rec["tenant"]
        elif ev == "committed":
            if key in st.claimed_ever:
                # lease fencing: once a key's lifecycle uses claims,
                # only the holder of its OPEN lease may commit.  A
                # zombie that passed its pre-append lease check, then
                # stalled past the TTL while a thief re-claimed,
                # re-ran and committed, lands its stale append HERE —
                # with no open claim (the thief's commit closed it) or
                # the wrong lineage — and is void: the thief's record
                # (whose output fingerprints describe the files
                # actually on disk) stays authoritative, and
                # duplicated=0 is structural.
                cur = st.claims.get(key)
                cs = rec.get("claim_seq")
                if cur is None or cur["worker"] != rec.get("worker") \
                        or (cs is not None
                            and cs != cur.get("claim_seq")):
                    st.stale_commits[key] = \
                        st.stale_commits.get(key, 0) + 1
                    return
            st.committed[key] = rec
            st.inflight.pop(key, None)
            st.failed.pop(key, None)
            st.claims.pop(key, None)
            st.commit_counts[key] = st.commit_counts.get(key, 0) + 1
        elif ev == "failed":
            st.failed[key] = str(rec.get("error", ""))
            st.inflight.pop(key, None)
            st.claims.pop(key, None)
        elif ev == "claimed":
            st.claimed_ever.add(key)
            # first live claim wins; later claims while a lease is open
            # are the LOSERS of the race (they observe this on replay)
            if key not in st.claims:
                st.claims[key] = {
                    "worker": rec.get("worker", ""),
                    "claim_seq": int(rec.get("seq", 0)),
                    "expires_unix": float(rec.get("expires_unix", 0.0)),
                    # last lease sign-of-life wall time: the epoch a
                    # thief's steal gap is measured from (flight.py)
                    "t": float(rec.get("t", 0.0))}
        elif ev == "lease_renewed":
            cur = st.claims.get(key)
            if cur is not None and cur["worker"] == rec.get("worker"):
                cur["expires_unix"] = float(rec.get("expires_unix", 0.0))
                cur["t"] = float(rec.get("t", 0.0))
        elif ev == "lease_expired":
            # effective only if the lease was genuinely expired when
            # the reap event was APPENDED — a renewal that published
            # first pushed expires_unix forward and voids a stale reap
            # (the reaper's subsequent claim then simply loses)
            cur = st.claims.get(key)
            if cur is not None and cur["worker"] == rec.get("worker") \
                    and float(rec.get("t", 0.0)) >= cur["expires_unix"]:
                del st.claims[key]
        elif ev == "session_open":
            s = _session_view(st, key)
            s["status"] = "open"
            s["opened_t"] = float(rec.get("t", 0.0))
            if rec.get("tenant"):
                st.tenants[key] = rec["tenant"]
        elif ev == "wave_received":
            s = _session_view(st, key)
            w = str(rec.get("wave"))
            # first intent wins: a duplicate intent append for a wave
            # number (a retried client racing its own ACK) is a no-op
            # on replay — the session layer never reuses numbers, so
            # a second intent can only be the same wave re-declared
            if w not in s["waves"]:
                s["waves"][w] = {"sha": rec.get("sha", ""),
                                 "reads": int(rec.get("reads", 0)),
                                 "seq": int(rec.get("seq", 0)),
                                 "t": float(rec.get("t", 0.0))}
            s["last_wave_t"] = float(rec.get("t", 0.0))
        elif ev == "wave_absorbed":
            if key in st.claimed_ever:
                # same lease fence as ``committed``: once a session's
                # lifecycle uses leases, only the open lease's holder
                # may absorb.  A zombie's stale absorb append (its
                # lease stolen mid-wave, the thief already replayed
                # the wave) is VOID — the count bank stays exact.
                cur = st.claims.get(key)
                cs = rec.get("claim_seq")
                if cur is None or cur["worker"] != rec.get("worker") \
                        or (cs is not None
                            and cs != cur.get("claim_seq")):
                    st.stale_commits[key] = \
                        st.stale_commits.get(key, 0) + 1
                    return
            s = _session_view(st, key)
            w = str(rec.get("wave"))
            s["absorbed"][w] = {"sha": rec.get("sha", ""),
                                "reads_total": int(
                                    rec.get("reads_total", 0)),
                                "worker": rec.get("worker", ""),
                                "t": float(rec.get("t", 0.0))}
            s["absorb_counts"][w] = s["absorb_counts"].get(w, 0) + 1
            s["reads_total"] = int(rec.get("reads_total",
                                           s["reads_total"]))
            if rec.get("digest"):
                s["digest"] = rec["digest"]
            # an absorb is NOT terminal: the lease stays open for the
            # next wave (unlike ``committed``, which closes it)
        elif ev == "wave_rejected":
            s = _session_view(st, key)
            # the seq records WHEN the rejection landed relative to
            # the wave's intent — recovery honors a rejection only
            # when it post-dates (or precedes any) wave_received for
            # the number (see effective_rejections)
            s["rejected"][str(rec.get("wave"))] = {
                "reason": str(rec.get("reason", "")),
                "seq": int(rec.get("seq", 0))}
        elif ev == "session_stable":
            s = _session_view(st, key)
            s["stable"] = True
            s["stable_wave"] = rec.get("wave")
            if rec.get("digest"):
                s["digest"] = rec["digest"]
        elif ev == "session_closed":
            s = _session_view(st, key)
            s["status"] = "closed"
            if rec.get("digest"):
                s["digest"] = rec["digest"]
            st.claims.pop(key, None)    # terminal, like committed

    # -- checkpoint / compaction -------------------------------------------
    def _latest_checkpoint(self) -> Tuple[int, Optional[ReplayState]]:
        """Newest READABLE checkpoint (seq, state); unreadable ones
        fall back to the next older, then to genesis (0, None)."""
        for seq, path in reversed(self._listing("checkpoint")):
            try:
                with open(path, encoding="utf-8") as fh:
                    blob = json.load(fh)
                if blob.get("schema") != CKPT_SCHEMA:
                    raise ValueError(f"schema {blob.get('schema')!r}")
                return seq, ReplayState.from_blob(blob)
            except Exception as exc:
                logger.warning("journal checkpoint %s unreadable "
                               "(%s: %s): falling back", path,
                               type(exc).__name__, exc)
        return 0, None

    def _replay_from_disk(self, full: bool = False) -> ReplayState:
        st = ReplayState()
        base = 0
        if not full:
            base, loaded = self._latest_checkpoint()
            if loaded is not None:
                st = loaded
            else:
                base = 0
        for rec in self.events(from_seq=base):
            self._apply(st, rec)
        return st

    def replay(self, full: bool = False) -> ReplayState:
        import copy

        st = self._replay_from_disk(full=full)
        # the mirror must be a SEPARATE copy: later appends update it
        # incrementally, and mutating the state just handed to the
        # caller would corrupt its view (the runner reads replay()
        # AFTER journaling the new queue as submitted)
        self._mirror = copy.deepcopy(st)
        return st

    def read_state(self, full: bool = False) -> ReplayState:
        """Replay WITHOUT refreshing the :meth:`position` mirror — the
        fleet's arbitration hot path (several reads per second per
        worker) skips the full-state deepcopy that :meth:`replay` pays
        to keep health reporting cheap."""
        return self._replay_from_disk(full=full)

    def write_checkpoint(self) -> Optional[str]:
        """Summarize the journal so far into a checkpoint segment.

        The state is rebuilt from DISK (newest checkpoint + tail) at
        write time — never from the in-memory mirror, which in a fleet
        misses other workers' appends.  Published with the same O_EXCL
        link as event segments; a concurrent writer checkpointing the
        same seq is absorbed (both built the same state)."""
        st = self._replay_from_disk()
        if st.last_seq <= 0:
            return None
        path = self._ckpt_path(st.last_seq)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(st.to_blob(), fh, sort_keys=True)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        try:
            os.link(tmp, path)
        except FileExistsError:
            pass                        # a peer already wrote this one
        os.unlink(tmp)
        return path

    def prune(self) -> int:
        """Delete event segments the newest checkpoint already covers
        (and all older checkpoints); returns the number of files
        removed.  Replay state is unchanged — the checkpoint IS the
        prefix — but ``replay(full=True)``/forensics lose the pruned
        tail, so pruning is explicit, never automatic."""
        base, loaded = self._latest_checkpoint()
        if loaded is None:
            return 0
        removed = 0
        for seq, path in self._listing("ev"):
            if seq <= base:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        for seq, path in self._listing("checkpoint"):
            if seq < base:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        return removed

    def verify_outputs(self, committed_rec: dict,
                       mode: str = "fast") -> bool:
        """True iff every output file the commit recorded still exists
        with its recorded fingerprint — the skip-on-restart gate.  A
        missing or drifted file re-runs the job (the journal is an
        audit trail, not a trust store).

        ``mode="fast"`` (default): a file whose (size, mtime) both
        match the commit-time stat is accepted WITHOUT re-hashing —
        resume over a large committed queue is O(stat), not O(bytes).
        Any stat drift falls through to the content hash, so a
        touched-but-identical file still verifies and a corrupted one
        still fails; ``mode="full"`` (``--verify-outputs full``)
        re-hashes everything unconditionally.  Legacy string
        fingerprints (``"sha256:..."``, pre-fleet commits) always
        re-hash."""
        outputs = committed_rec.get("outputs") or {}
        if not outputs:
            return False
        for path, want in outputs.items():
            # a null recorded fingerprint (commit-time hash failure)
            # must NOT match a null re-hash of a missing file —
            # unknown never verifies, the job re-runs
            if want is None:
                return False
            if isinstance(want, str):
                if file_sha256(path) != want:
                    return False
                continue
            try:
                st = os.stat(path)
            except OSError:
                return False
            if st.st_size != want.get("size"):
                return False            # content hash cannot match
            if mode != "full" \
                    and round(st.st_mtime, 6) == want.get("mtime"):
                continue                # demonstrably untouched
            if file_sha256(path) != want.get("sha256"):
                return False
        return True

    # -- per-job checkpoint homes ------------------------------------------
    def ckpt_dir(self, key: str) -> str:
        """The checkpoint home the runner assigns a journaled job
        (created lazily by the checkpoint writer)."""
        return os.path.join(self.root, "ckpt", key)

    def drop_ckpt(self, key: str) -> None:
        """A committed job's checkpoint is dead weight: remove it."""
        d = self.ckpt_dir(key)
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    # -- health / audit ----------------------------------------------------
    def position(self) -> dict:
        """The journal's place in the world, for health snapshots.
        Served from the in-memory mirror (one full replay at first use,
        incremental per append after) — health publishes happen at
        every job boundary, and re-reading the whole segment directory
        each time would grow per-job cost linearly with history.  In
        fleet mode the mirror may lag peers' appends between replays;
        the drain loop's frequent replay() keeps it near-fresh."""
        st = self._mirror if self._mirror is not None else self.replay()
        return {"root": self.root, "last_seq": st.last_seq,
                "events": st.events, "committed": len(st.committed),
                "inflight": len(st.inflight), "failed": len(st.failed),
                "claims": len(st.claims),
                "corrupt_segments": st.corrupt_segments}

    def audit(self, full: bool = False) -> dict:
        """Duplication/loss audit over the whole journal: per-key commit
        counts plus the set of keys ever submitted — the chaos-soak
        harness asserts ``max(commit_counts.values()) <= 1`` per cycle
        and ``submitted ⊆ committed`` at cycle end.  ``full=True``
        bypasses checkpoints (the compaction audit)."""
        st = self.replay(full=full)
        out = {"submitted": sorted(st.submitted),
               "commit_counts": dict(st.commit_counts),
               "duplicated": sorted(k for k, n in st.commit_counts.items()
                                    if n > 1),
               "lost": sorted(st.submitted - set(st.committed)),
               # commits VOIDED by the lease fence (zombie appends):
               # forensic — these are the protocol WORKING, not a
               # duplication
               "stale_commits": dict(st.stale_commits)}
        if st.sessions:
            # streaming sessions: the same 0-lost / 0-duplicated audit
            # at WAVE granularity — a rejected (DATA-class) wave is
            # accounted, never "lost".  Only EFFECTIVE rejections
            # excuse a wave (a stale rejection naming a later wave's
            # number must not launder that wave out of lost_waves)
            out["sessions"] = {}
            for key, s in sorted(st.sessions.items()):
                rej = effective_rejections(s)
                out["sessions"][key] = {
                    "waves": len(s["waves"]),
                    "absorbed": len(s["absorbed"]),
                    "duplicated_waves": sorted(
                        w for w, n in s["absorb_counts"].items()
                        if n > 1),
                    "lost_waves": sorted(
                        w for w in s["waves"]
                        if w not in s["absorbed"] and w not in rej),
                    "rejected_waves": sorted(s["rejected"]),
                    "reads_total": s["reads_total"],
                    "status": s["status"], "stable": s["stable"]}
        return out
