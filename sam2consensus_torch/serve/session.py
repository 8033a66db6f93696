"""Streaming consensus sessions: a journaled, crash-safe materialized view.

Port of ``sam2consensus_tpu/serve/session.py`` (held against it by
``tests/test_torch_session.py``: the same waves give the same digests,
outputs and journal events).  Where it differs: a wave's run takes its
seed and gives back its state through its own
:class:`~..backends.torch_backend.CountCapture` box (the runner's
``_plant_seed``), not through registers on the backend, and each wave's
step times and kernel launches are appended to ``waves.jsonl`` in the
session's directory (:data:`WAVE_LOG`).  On the card a wave seeds the
session's ``[L, 6]`` counts, counts its reads with K1 and runs the tail
(K2 or K3 where it has insertions); a re-vote of an absorbed wave counts
nothing, so only the tail runs.

Every job the serve stack ran before this module was a file that
already existed.  Real heavy-traffic consensus (live basecalling,
read-until adaptive sampling, surveillance feeds) streams reads for
hours against a fixed reference set — so this module promotes PR 12's
per-reference count cache from "warm state between jobs" to a
long-lived per-tenant SESSION whose count tensors are a continuously
updated materialized view over everything absorbed so far.

The unit of ingest is a WAVE: one POST body of SAM read lines against
the session's reference set.  A wave's lifecycle is a strict durability
order, and every crash window between two steps is safe by
construction:

1. the raw body is SPOOLED next to the journal (tmp + fsync + rename —
   a crash leaves either no spool or a whole spool);
2. a ``wave_received`` journal segment records the durable INTENT —
   wave number, body sha256, read count — BEFORE any ingest work.  A
   crash after (1) but before (2) simply never ACKs: the client
   re-sends;
3. the wave is ABSORBED exactly-once into the session's count tensors
   via the checkpoint-shaped seed/capture handoff the count cache
   already proved (one backend run per wave, ``source_id =
   "wave:<n>:<sha12>"``): the session's ``CheckpointState`` seeds the
   run, the wave's reads scatter on top, the vote re-runs, and the
   captured state is saved back ATOMICALLY as the session checkpoint.
   The state is self-fencing: ``sources`` lists every absorbed wave, so
   replaying a wave the checkpoint already covers is a structural no-op
   (the backend's duplicate-shard skip — zero decode, zero scatter,
   same vote);
4. a ``wave_absorbed`` segment commits the wave — sha, cumulative read
   count, the consensus digest, and (fleet mode) the worker + claim
   lineage that lets the journal's lease fence void a zombie's stale
   absorb.

The COUNT-BANK RULE from the cache governs failure: a fault mid-wave
(the ``session_wave_append`` site) invalidates the wave's partition
WHOLE — in-memory state is dropped, the next absorb re-seeds from the
last atomically-saved checkpoint, and the wave replays from its spool.
Nothing is ever half-counted.

Sessions are JOURNAL ENTITIES with the fleet's claim/lease semantics
(the lease machinery in serve/journal.py + serve/fleet.py is
key-generic): a SIGKILLed worker's open session is reaped and stolen
lease-and-all by a peer, which recovers by loading the newest session
checkpoint and replaying exactly the ``wave_received`` intents not yet
covered by ``wave_absorbed`` — 0 lost reads, 0 double-counted reads.
A torn spool (sha mismatch against the journaled intent) is rejected
with reason ``torn`` and surfaces on the session's ``resend`` list —
re-requested, never absorbed.

Wave numbers are NEVER reused, absorbed or rejected: a pre-receive
rejection (declared-sha mismatch, malformed body) consumes its wave
number too.  A ``wave_rejected`` record must uniquely name the wave it
voids — if a later valid wave reused the number, recovery would read
the old rejection as covering the new wave and silently drop ACKed
reads.  Journal replay adds a structural second fence (the rejection's
``seq`` must post-date the wave's intent to gate replay; see
``journal.effective_rejections``), so even a journal written before
this rule holds cannot lose a received wave to a stale rejection.

Early stability (the read-until loop): after every absorb the consensus
digest is compared to the previous wave's; ``stability_waves``
consecutive identical digests emit a ``session_stable`` journal event,
a ``session/stability_events`` counter and a ``stable: true`` field in
every subsequent wave ACK — the signal telling the client to stop
sequencing this target.

Re-vote without re-ingest: an on-demand (or debounced) re-vote runs the
backend with the session seed and an already-absorbed ``source_id`` —
the duplicate-shard skip decodes nothing, scatters nothing, and only
the vote tail runs.

The network front door lives in serve/stream_server.py; this module is
transport-agnostic (tools and tests drive a :class:`SessionManager`
directly).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from .. import observability as obs
from ..config import resolve_decode_threads
from ..formats import open_alignment_input
from ..io.fasta import write_outputs
from ..utils import checkpoint as uckpt
from . import journal as sjournal

logger = logging.getLogger("sam2consensus_torch.serve.session")

#: consecutive identical consensus digests before the stability verdict
DEFAULT_STABILITY_WAVES = 3
#: seconds a received wave may sit journaled-but-unabsorbed before the
#: next tick absorbs it (0 = absorb synchronously in the request)
DEFAULT_REVOTE_DEBOUNCE = 0.0
#: journaled-but-unabsorbed waves per session before 429 backpressure
DEFAULT_MAX_PENDING = 64
#: absorb attempts per wave before the wave is surfaced as a transient
#: failure to the client (the spool + intent survive for a later retry)
ABSORB_ATTEMPTS = 3
#: the per-wave record in each session's directory: one JSON line per
#: backend run (wave number, re-vote or not, the seed, K1 route, tail,
#: capture, checkpoint-save and journal-append seconds and the run's
#: kernel launches)
WAVE_LOG = "waves.jsonl"


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def consensus_digest(fastas) -> str:
    """Deterministic digest of a vote result — the stability signal and
    the fuzz harness's state-invariance oracle.  Hashes the consensus
    SEQUENCES per reference, deliberately NOT the FASTA headers: the
    header embeds the running coverage, which moves with every absorbed
    wave even when the called consensus has long converged — hashing it
    would make the read-until verdict structurally unreachable."""
    blob = json.dumps(
        [(ref, [r.seq for r in recs])
         for ref, recs in sorted(fastas.items())],
        sort_keys=True)
    return "sha256:" + sha256_hex(blob.encode("utf-8"))


class SessionError(Exception):
    """Typed session-layer failure: ``status`` is the HTTP status the
    front door answers with, ``reason`` the machine-readable label.
    DATA-class rejections (malformed waves) carry ``data_error`` so the
    policy layer never retries or demotes on them."""

    def __init__(self, status: int, reason: str, detail: str = "",
                 retry_after: Optional[float] = None):
        super().__init__(detail or reason)
        self.status = int(status)
        self.reason = reason
        self.retry_after = retry_after
        self.data_error = status == 422


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp + fsync + rename: the spool discipline — a crash leaves
    either no file or a whole file, never a torn one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _parse_header(header_text: str) -> List[str]:
    """Reference names from the session's SAM header; raises the
    DATA-class SessionError on a header with no usable @SQ line."""
    refs: List[str] = []
    for line in header_text.splitlines():
        if not line.startswith("@SQ"):
            continue
        name = None
        has_len = False
        for f in line.split("\t")[1:]:
            if f.startswith("SN:"):
                name = f[3:]
            elif f.startswith("LN:"):
                try:
                    has_len = int(f[3:]) > 0
                except ValueError:
                    has_len = False
        if name and has_len:
            refs.append(name)
    if not refs:
        raise SessionError(
            422, "bad_header",
            "session header carries no usable @SQ line (SN + LN)")
    return refs


def _count_reads(body: bytes) -> int:
    """Read-line count of a wave body; raises the DATA-class
    SessionError on a line that cannot be a SAM record (fewer than the
    11 mandatory fields).  This is the cheap structural gate — deep
    validation happens in the decoder under the session's bad-record
    policy; a blown budget there is the same DATA class."""
    reads = 0
    for ln, raw in enumerate(body.split(b"\n"), 1):
        if not raw or raw.startswith(b"@"):
            continue
        if raw.count(b"\t") < 10:
            raise SessionError(
                422, "malformed_wave",
                f"wave body line {ln} has "
                f"{raw.count(chr(9).encode()) + 1} fields, not a SAM "
                f"record (11+ expected)")
        reads += 1
    if reads == 0:
        raise SessionError(422, "empty_wave",
                           "wave body carries no read lines")
    return reads


def _load_state(state_dir: str) -> Optional[uckpt.CheckpointState]:
    """The session checkpoint, if present and intact.  The genome
    length is read from the file itself (the session's reference set is
    fixed at open, and the backend re-validates the seed's shape), so
    recovery needs no layout computation before its first absorb."""
    path = uckpt.path_for(state_dir)
    if not os.path.exists(path):
        return None
    try:
        import numpy as np

        with np.load(path, allow_pickle=False) as z:
            n = int(z["counts"].shape[0])
    except Exception:
        return uckpt.load(state_dir, 0)     # counted corrupt -> None
    return uckpt.load(state_dir, n)


@dataclasses.dataclass
class StreamSession:
    """In-memory face of one journaled session (the journal + spool
    directory are the durable truth; everything here is recoverable)."""

    sid: str
    tenant: str
    root: str                       # sessions/<sid>/
    header_text: str
    header_sha: str
    refs: List[str]
    wave_next: int = 1
    #: wave numbers journaled as received but not yet absorbed/rejected
    pending: List[int] = dataclasses.field(default_factory=list)
    #: wave -> {"sha", "reads", "bytes"} for every received wave
    waves: Dict[int, dict] = dataclasses.field(default_factory=dict)
    absorbed: set = dataclasses.field(default_factory=set)
    #: torn waves awaiting a client re-send (new wave number)
    resend: List[int] = dataclasses.field(default_factory=list)
    state: Optional[uckpt.CheckpointState] = None
    fastas: Optional[dict] = None
    reads_total: int = 0
    digest: str = ""
    prev_digest: str = ""
    stable_streak: int = 0
    stable: bool = False
    stable_wave: Optional[int] = None
    closed: bool = False
    stolen_from: str = ""
    #: the newest backend run's step times and launches (WAVE_LOG)
    last_run: Optional[dict] = None
    last_wave_mono: float = dataclasses.field(
        default_factory=time.monotonic)
    last_wave_unix: float = dataclasses.field(default_factory=time.time)
    #: serializes THIS session's wave lifecycle (receive/absorb/
    #: revote/close) — see SessionManager's concurrency contract
    lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    @property
    def state_dir(self) -> str:
        return os.path.join(self.root, "state")

    @property
    def out_dir(self) -> str:
        return os.path.join(self.root, "out")

    def header_path(self) -> str:
        return os.path.join(self.root, "header.sam")

    def body_path(self, wave: int) -> str:
        return os.path.join(self.root, f"wave-{wave:04d}.body.sam")

    def job_path(self, wave: int) -> str:
        return os.path.join(self.root, f"wave-{wave:04d}.job.sam")


class SessionManager:
    """All live sessions of one serve runner, plus the absorb engine.

    Concurrency contract — three lock planes, ordered so observability
    and other tenants never wait behind one session's absorb (a backend
    run can take seconds to minutes):

    * ``_lock`` (manager): guards the ``sessions`` map only — lookups,
      open/adopt inserts, close/zombie pops, gauge sweeps.  Held for
      microseconds, never across a journal replay or a backend run.
    * per-session ``StreamSession.lock``: serializes one session's
      wave lifecycle (receive -> absorb -> commit, revote, close), so
      a slow tenant's absorb blocks only its own session's ingest.
    * ``_backend_lock``: the execute section of :meth:`_run_wave`.
      Each run gets its own seed/capture box, but the runner's
      per-run hooks on the one backend (its prepared instruments,
      dispatch log and pending capture box) serve one run at a time,
      so backend runs still serialize — but ONLY the runs, not the
      spool/journal/ACK path, not :meth:`status`, not
      :meth:`health_summary`.

    Ordering: a thread holding a session lock may take the manager or
    backend lock; a thread holding the manager lock never waits on a
    session lock (no cycles).  :meth:`status` and
    :meth:`health_summary` read per-session fields WITHOUT the session
    lock — each field read is GIL-atomic, the snapshot is advisory
    observability, and taking the wave lock would reintroduce the
    absorb-blocks-every-prober stall this contract exists to prevent.

    Session mode owns the runner: no batch queue runs concurrently
    (the CLI enforces it)."""

    def __init__(self, runner, base_cfg,
                 stability_waves: int = DEFAULT_STABILITY_WAVES,
                 revote_debounce: float = DEFAULT_REVOTE_DEBOUNCE,
                 max_pending: int = DEFAULT_MAX_PENDING):
        if runner.journal is None:
            raise ValueError("streaming sessions require --journal: the "
                             "journal IS the session's durable state")
        self.runner = runner
        self.registry = runner.registry
        self.journal = runner.journal
        self.base_cfg = base_cfg
        self.stability_waves = max(1, int(stability_waves))
        self.revote_debounce = max(0.0, float(revote_debounce))
        self.max_pending = max(0, int(max_pending))
        self.sessions: Dict[str, StreamSession] = {}
        self._lock = threading.RLock()          # sessions-map guard
        self._backend_lock = threading.Lock()   # seed/execute/capture
        #: last orphan scan (monotonic); the scan replays the journal
        #: tail from disk, so it runs on its own cadence (a fraction
        #: of the lease TTL, like the fleet reap scan) instead of at
        #: every 10 Hz drain tick
        self._orphan_scan_mono = 0.0
        self.sessions_root = os.path.join(self.journal.root, "sessions")
        os.makedirs(self.sessions_root, exist_ok=True)

    # -- small helpers -----------------------------------------------------
    def _fleet(self):
        return getattr(self.runner, "fleet", None)

    def _get(self, sid: str) -> StreamSession:
        """Resolve a session WITHOUT taking its wave lock — callers
        that mutate re-check ``closed`` under ``sess.lock``."""
        with self._lock:
            sess = self.sessions.get(sid)
        if sess is None:
            # a client retargeting this worker right after its peer
            # died must not wait for the next steal tick: try a
            # one-shot adoption from the journal before 404ing
            sess = self._try_adopt(sid)
        if sess is None:
            raise SessionError(404, "unknown_session",
                               f"no open session {sid!r} on this worker")
        if sess.closed:
            raise SessionError(409, "session_closed",
                               f"session {sid} is closed")
        return sess

    def _check_open(self, sess: StreamSession) -> None:
        """Re-check under ``sess.lock``: a close/zombie-drop may have
        raced the lockless lookup in :meth:`_get`."""
        if sess.closed:
            raise SessionError(409, "session_closed",
                               f"session {sess.sid} is closed")

    def _try_adopt(self, sid: str) -> Optional[StreamSession]:
        """Adopt one journaled session on demand: after a restart (no
        fleet: the journal alone is authority) or a steal (fleet: only
        with a won lease — a live peer's session stays theirs)."""
        try:
            st = self.journal.read_state()
        except Exception:
            return None
        view = st.sessions.get(sid)
        if view is None or view.get("status") == "closed":
            return None
        fl = self._fleet()
        stolen_from = ""
        if fl is not None:
            cur = st.claims.get(sid)
            if cur is not None and cur["worker"] != fl.worker_id \
                    and time.time() < cur["expires_unix"]:
                return None             # live lease elsewhere
            if not fl.try_claim(sid, sid, st=st):
                return None
            if cur is not None and cur["worker"] != fl.worker_id:
                stolen_from = cur["worker"]
        return self._recover(sid, view,
                             tenant=st.tenants.get(sid, ""),
                             stolen_from=stolen_from)

    def _gauges(self) -> None:
        with self._lock:
            sessions = list(self.sessions.values())
        g = self.registry.gauge
        g("session/open").set(float(
            sum(1 for s in sessions if not s.closed)))
        g("session/pending_waves").set(float(
            sum(len(s.pending) for s in sessions)))

    def _append(self, ev: str, **fields) -> None:
        """Journal append via the runner's failure-absorbing wrapper
        for audit events; the DURABLE-INTENT appends (wave_received)
        must raise instead — a wave whose intent could not be journaled
        must not be ACKed."""
        self.runner._journal_append(ev, **fields)

    def _lease_fields(self, sid: str) -> dict:
        fl = self._fleet()
        if fl is None:
            return {}
        return {"worker": fl.worker_id,
                "claim_seq": fl.claim_seqs.get(sid)}

    def _confirm_lease(self, sess: StreamSession) -> None:
        """Fresh-replay confirmation that this worker still holds the
        session's lease — the same pre-commit discipline the fleet job
        path uses.  Losing it means a peer already stole the session
        mid-wave: this worker is the zombie and must drop its state
        (the thief's replay owns the wave now)."""
        fl = self._fleet()
        if fl is None:
            return
        if not fl.holds(sess.sid):
            with self._lock:
                self.sessions.pop(sess.sid, None)
            self._gauges()
            raise SessionError(
                409, "lease_lost",
                f"session {sess.sid} was stolen by a peer (this worker "
                f"stalled past its lease TTL); re-target the thief")

    # -- lifecycle ---------------------------------------------------------
    def open_session(self, header_text: str, tenant: str = "") -> dict:
        """Open a session against a reference set (a SAM header)."""
        refs = _parse_header(header_text)
        header_sha = sha256_hex(header_text.encode("utf-8"))
        with self._lock:
            n_live = len(self.sessions)
        sid = "s-" + sha256_hex(
            f"{header_sha}:{tenant}:{os.getpid()}:"
            f"{time.time():.6f}:{n_live}"
            .encode("utf-8"))[:12]
        root = os.path.join(self.sessions_root, sid)
        os.makedirs(root, exist_ok=True)
        os.makedirs(os.path.join(root, "state"), exist_ok=True)
        os.makedirs(os.path.join(root, "out"), exist_ok=True)
        _atomic_write_bytes(os.path.join(root, "header.sam"),
                            header_text.encode("utf-8"))
        sess = StreamSession(sid=sid, tenant=tenant, root=root,
                             header_text=header_text,
                             header_sha=header_sha, refs=refs)
        fl = self._fleet()
        if fl is not None and not fl.try_claim(sid, sid):
            raise SessionError(  # fresh sid: only a journal outage
                503, "lease_unavailable",
                f"could not open a lease for session {sid}")
        self.journal.append("session_open", key=sid, tenant=tenant,
                            header_sha=header_sha, refs=len(refs))
        with self._lock:
            self.sessions[sid] = sess
        self.registry.add("session/opened", 1)
        self._gauges()
        logger.info("session %s opened (%d reference(s), tenant=%r)",
                    sid, len(refs), tenant or "")
        return {"sid": sid, "refs": len(refs),
                "stability_waves": self.stability_waves}

    def receive_wave(self, sid: str, body: bytes,
                     declared_sha: Optional[str] = None) -> dict:
        """Spool + journal one wave; absorb synchronously unless the
        debounce window defers it to the next tick."""
        sess = self._get(sid)
        with sess.lock:
            self._check_open(sess)
            dec = self.runner.admission.price_wave(
                tenant=sess.tenant, body_bytes=len(body),
                pending_waves=len(sess.pending),
                max_pending=self.max_pending)
            if not dec.admitted:
                self.registry.add("session/waves_shed", 1)
                self.registry.add(
                    f"serve/admission_rejected/{dec.reason}", 1)
                raise SessionError(
                    429, dec.reason,
                    f"wave rejected ({dec.reason}): "
                    f"{len(sess.pending)} wave(s) pending",
                    retry_after=max(1.0, self.revote_debounce or 1.0))
            sha = sha256_hex(body)
            if declared_sha and declared_sha.removeprefix("sha256:") \
                    != sha:
                # the rejection CONSUMES its wave number (wave_next
                # advances): the journaled wave_rejected must never
                # name a number a later valid wave will reuse, or
                # recovery would drop that wave as rejected
                n = sess.wave_next
                sess.wave_next = n + 1
                self._reject_wave(sess, n, "sha_mismatch")
                raise SessionError(
                    422, "sha_mismatch",
                    f"declared body sha256 {declared_sha!r} does not "
                    f"match received bytes ({sha[:12]}…) — torn upload")
            try:
                reads = _count_reads(body)
            except SessionError as exc:
                n = sess.wave_next
                sess.wave_next = n + 1      # consumed, like sha_mismatch
                self._reject_wave(sess, n, exc.reason)
                raise
            n = sess.wave_next
            _atomic_write_bytes(sess.body_path(n), body)
            # the durable intent: this append RAISES on failure (no
            # ACK without a journaled wave) — unlike the audit appends
            self.journal.append("wave_received", key=sid, wave=n,
                                sha=sha, reads=reads, bytes=len(body))
            sess.wave_next = n + 1
            sess.waves[n] = {"sha": sha, "reads": reads,
                             "bytes": len(body)}
            sess.pending.append(n)
            sess.last_wave_mono = time.monotonic()
            sess.last_wave_unix = time.time()
            self.registry.add("session/waves", 1)
            self._gauges()
            if self.revote_debounce > 0:
                return {"sid": sid, "wave": n, "status": "pending",
                        "pending": len(sess.pending),
                        "reads_total": sess.reads_total,
                        "digest": sess.digest, "stable": sess.stable}
            self._absorb_pending(sess)
            return {"sid": sid, "wave": n, "status": "absorbed",
                    "reads_total": sess.reads_total,
                    "digest": sess.digest, "stable": sess.stable,
                    "stable_wave": sess.stable_wave}

    def revote(self, sid: str) -> dict:
        """On-demand re-vote over the absorbed state — zero decode,
        zero scatter (the duplicate-shard skip), only the vote tail."""
        sess = self._get(sid)
        with sess.lock:
            self._check_open(sess)
            self.runner._fault_check("session_revote")
            if sess.pending:
                self._absorb_pending(sess)
            if not sess.absorbed:
                raise SessionError(409, "no_absorbed_waves",
                                   f"session {sid} has absorbed no "
                                   f"waves yet — nothing to vote on")
            n = max(sess.absorbed)
            out = self._run_wave(sess, n, revote=True)
            sess.fastas = out.fastas
            sess.digest = consensus_digest(out.fastas)
            self._log_wave(sess)
            self.registry.add("session/revotes", 1)
            return {"sid": sid, "digest": sess.digest,
                    "reads_total": sess.reads_total,
                    "stable": sess.stable}

    def status(self, sid: str) -> dict:
        """Advisory snapshot, read WITHOUT the session's wave lock (a
        mid-absorb probe answers immediately; see the class
        docstring's concurrency contract)."""
        with self._lock:
            sess = self.sessions.get(sid)
        if sess is None:
            raise SessionError(404, "unknown_session",
                               f"no session {sid!r} on this worker")
        return {
            "sid": sid, "tenant": sess.tenant,
            "closed": sess.closed, "refs": len(sess.refs),
            "waves": len(sess.waves),
            "absorbed": len(sess.absorbed),
            "pending": sorted(list(sess.pending)),
            "resend": sorted(list(sess.resend)),
            "reads_total": sess.reads_total,
            "digest": sess.digest, "stable": sess.stable,
            "stable_wave": sess.stable_wave,
            "stolen_from": sess.stolen_from,
            "last_wave_age_sec": round(
                time.monotonic() - sess.last_wave_mono, 3)}

    def close_session(self, sid: str) -> dict:
        """Absorb the backlog, write the final FASTA outputs, journal
        the terminal event (closing the lease) and forget the session."""
        sess = self._get(sid)
        with sess.lock:
            self._check_open(sess)
            if sess.pending:
                self._absorb_pending(sess)
            outputs: Dict[str, Optional[dict]] = {}
            if sess.fastas is None and sess.absorbed:
                out = self._run_wave(sess, max(sess.absorbed),
                                     revote=True)
                sess.fastas = out.fastas
                sess.digest = consensus_digest(out.fastas)
                self._log_wave(sess)
            if sess.fastas is not None:
                cfg = self.base_cfg
                paths = write_outputs(
                    sess.fastas, sess.out_dir + os.sep,
                    cfg.prefix or sess.sid, cfg.nchar, cfg.thresholds,
                    echo=lambda *a, **k: None)
                outputs = {p: sjournal.file_fingerprint(p)
                           for p in paths}
            self._confirm_lease(sess)
            self._append("session_closed", key=sid, digest=sess.digest,
                         outputs=outputs, reads_total=sess.reads_total,
                         **self._lease_fields(sid))
            fl = self._fleet()
            if fl is not None:
                fl.held.pop(sid, None)      # terminal event closed it
                fl.claim_seqs.pop(sid, None)
            sess.closed = True
            with self._lock:
                self.sessions.pop(sid, None)
            self.registry.add("session/closed", 1)
            self._gauges()
            logger.info("session %s closed: %d wave(s), %d read(s), "
                        "digest %s", sid, len(sess.absorbed),
                        sess.reads_total, sess.digest[:19])
            return {"sid": sid, "digest": sess.digest,
                    "outputs": sorted(outputs),
                    "reads_total": sess.reads_total,
                    "waves": len(sess.absorbed),
                    "stable": sess.stable}

    # -- absorb engine -----------------------------------------------------
    def _reject_wave(self, sess: StreamSession, wave: int,
                     reason: str) -> None:
        """DATA-class wave rejection: journaled for the audit, counted,
        charged to the tenant's poison tally — never retried, never a
        rung demotion (the policy layer's DATA contract)."""
        self._append("wave_rejected", key=sess.sid, wave=wave,
                     reason=reason)
        self.registry.add("session/waves_rejected", 1)
        self.runner.admission.note_poison(sess.tenant)
        if wave in sess.pending:
            sess.pending.remove(wave)

    def _absorb_pending(self, sess: StreamSession) -> None:
        """Drain the session's pending waves IN ORDER, one backend run
        per wave (grouping is forbidden: a crash between group members
        must not change how reads partition into absorbs on replay).
        Caller holds ``sess.lock``."""
        while sess.pending:
            n = sess.pending[0]
            self._absorb_wave(sess, n)

    def _absorb_wave(self, sess: StreamSession, n: int) -> None:
        meta = sess.waves.get(n) or {}
        # spool integrity against the journaled intent: a torn/partial
        # spool is re-requested, never absorbed
        try:
            with open(sess.body_path(n), "rb") as fh:
                body = fh.read()
        except OSError:
            body = b""
        if sha256_hex(body) != meta.get("sha"):
            sess.pending.remove(n)
            sess.resend.append(n)
            self.registry.add("session/torn_waves", 1)
            self._append("wave_rejected", key=sess.sid, wave=n,
                         reason="torn")
            logger.warning("session %s wave %d spool is torn (sha "
                           "mismatch): re-requested, not absorbed",
                           sess.sid, n)
            return
        last_exc: Optional[BaseException] = None
        for attempt in range(ABSORB_ATTEMPTS):
            try:
                self.runner._fault_check("session_wave_append")
                out = self._run_wave(sess, n)
            except SessionError:
                raise
            except Exception as exc:
                from ..resilience.policy import classify

                last_exc = exc
                # count-bank rule: ANY fault mid-wave drops the
                # in-memory state whole; the next attempt re-seeds
                # from the last atomically-saved checkpoint and the
                # wave replays from its spool
                sess.state = None
                if classify(exc) == "data":
                    sess.pending.remove(n)
                    self._reject_wave(sess, n, f"data:{exc}")
                    raise SessionError(
                        422, "poison_wave",
                        f"wave {n} failed DATA-class: {exc}") from exc
                logger.warning(
                    "session %s wave %d absorb attempt %d/%d failed "
                    "(%s: %s)", sess.sid, n, attempt + 1,
                    ABSORB_ATTEMPTS, type(exc).__name__, exc)
                continue
            # -- success: commit the wave -----------------------------
            was_new = n not in sess.absorbed
            if was_new:
                sess.reads_total += int(meta.get("reads", 0))
                self.registry.add("session/reads_absorbed",
                                  int(meta.get("reads", 0)))
            sess.fastas = out.fastas
            digest = consensus_digest(out.fastas)
            self._confirm_lease(sess)
            t0 = time.perf_counter()
            self.journal.append(
                "wave_absorbed", key=sess.sid, wave=n,
                sha=meta.get("sha", ""), reads_total=sess.reads_total,
                digest=digest, **self._lease_fields(sess.sid))
            self._log_wave(sess, journal_sec=time.perf_counter() - t0)
            sess.absorbed.add(n)
            if n in sess.pending:
                sess.pending.remove(n)
            self.registry.add("session/waves_absorbed", 1)
            self._gauges()
            self._note_stability(sess, n, digest)
            return
        raise SessionError(
            503, "absorb_failed",
            f"wave {n} failed {ABSORB_ATTEMPTS} absorb attempts "
            f"({type(last_exc).__name__}: {last_exc}); the wave stays "
            f"journaled and will be retried", retry_after=1.0)

    def _note_stability(self, sess: StreamSession, n: int,
                        digest: str) -> None:
        if digest == sess.prev_digest:
            sess.stable_streak += 1
        else:
            sess.stable_streak = 1
        sess.prev_digest = digest
        sess.digest = digest
        if sess.stable_streak >= self.stability_waves \
                and not sess.stable:
            sess.stable = True
            sess.stable_wave = n
            self._append("session_stable", key=sess.sid, wave=n,
                         digest=digest,
                         waves_stable=sess.stable_streak)
            self.registry.add("session/stability_events", 1)
            logger.info("session %s consensus stable: digest unchanged "
                        "for %d wave(s) (read-until: stop sequencing)",
                        sess.sid, sess.stable_streak)

    def _run_wave(self, sess: StreamSession, n: int,
                  revote: bool = False):
        """One backend run: seed with the session state, absorb wave
        ``n`` (or skip-decode it on a re-vote of an absorbed wave),
        capture the new state back, save it atomically.  The seed and
        the captured state travel in this run's own
        :class:`~..backends.torch_backend.CountCapture` box, so a run
        the watchdog abandoned writes only its own box, never a later
        attempt's or the session's."""
        meta = sess.waves.get(n) or {}
        sha12 = str(meta.get("sha", ""))[:12]
        source_id = f"wave:{n}:{sha12}"
        job_path = sess.job_path(n)
        if not os.path.exists(job_path):
            with open(sess.body_path(n), "rb") as fh:
                body = fh.read()
            _atomic_write_bytes(
                job_path,
                sess.header_text.rstrip("\n").encode("utf-8") + b"\n"
                + body)
        cfg = dataclasses.replace(
            self.base_cfg, incremental=True, source_id=source_id,
            checkpoint_dir=None, trace_out=None, metrics_out=None,
            json_metrics=None, profile_dir=None,
            outfolder=sess.out_dir + os.sep)
        robs = obs.prepare_run(config=cfg)
        ai = open_alignment_input(job_path, "sam",
                                  threads=resolve_decode_threads(cfg))
        runner = self.runner
        job_id = f"{sess.sid}:w{n}" + (":revote" if revote else "")
        if sess.state is None:
            sess.state = _load_state(sess.state_dir)
        # one run at a time on the runner's backend hooks; the seed
        # and the capture are this run's own box
        with self._backend_lock:
            capture = runner._plant_seed(sess.state)
            dlog: List = []
            try:
                runner._next_capture = capture
                out = runner._execute(ai.contigs, ai.stream, cfg, robs,
                                      dlog, job_id)
            finally:
                runner._next_capture = None
                ai.close()
                try:
                    obs.finish_run(robs)
                except Exception:       # instruments are derived state
                    pass
                try:
                    runner.registry.fold(robs.registry, job_id=job_id,
                                         tenant=sess.tenant)
                except Exception:
                    runner.registry.add("telemetry/fold_failed", 1)
        result = capture.result
        save_sec = 0.0
        if result is not None and not revote:
            # the atomic save IS the count bank: a crash between here
            # and the wave_absorbed append replays the wave, and the
            # self-describing ``sources`` makes that replay a no-op.
            # A re-vote deliberately skips this — its captured state
            # would list the re-voted source twice.
            sess.state = result
            t0 = time.perf_counter()
            uckpt.save(sess.state_dir, result)
            save_sec = time.perf_counter() - t0
        extra = out.stats.extra
        counters = robs.registry.snapshot()["counters"]
        sess.last_run = {
            "wave": n, "revote": revote,
            "seed_sec": extra.get("count_seed_sec", 0.0),
            "pileup_sec": extra.get("pileup_sec", 0.0),
            "tail_sec": extra.get("tail_sec", 0.0),
            "capture_sec": extra.get("count_capture_sec", 0.0),
            "save_sec": save_sec,
            "duplicate": "incremental_duplicate" in extra,
            "launches": {k.rsplit("/", 1)[1]: int(v)
                         for k, v in counters.items()
                         if k.startswith("kernel/launches/")}}
        return out

    def _log_wave(self, sess: StreamSession,
                  journal_sec: float = 0.0) -> None:
        """Append the last run's record to the session's
        :data:`WAVE_LOG` (best effort: the record is evidence, never a
        reason to fail a wave)."""
        rec = dict(sess.last_run or {})
        if not rec:
            return
        rec["journal_sec"] = journal_sec
        try:
            with open(os.path.join(sess.root, WAVE_LOG), "a",
                      encoding="utf-8") as fh:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        except OSError as exc:
            logger.warning("session %s wave log write failed: %s",
                           sess.sid, exc)

    # -- drain / recovery --------------------------------------------------
    def tick(self) -> int:
        """One heartbeat: absorb debounce-expired waves and (on its
        own throttled cadence) adopt orphaned sessions (fleet mode).
        Returns absorbed-wave count — the drain loop's idleness
        signal."""
        absorbed = 0
        with self._lock:
            sessions = list(self.sessions.values())
        now = time.monotonic()
        for sess in sessions:
            if sess.closed or not sess.pending:
                continue
            if self.revote_debounce > 0 and \
                    now - sess.last_wave_mono < self.revote_debounce:
                continue
            with sess.lock:
                if sess.closed:
                    continue
                before = len(sess.absorbed)
                try:
                    self._absorb_pending(sess)
                except SessionError as exc:
                    logger.warning("session %s backlog drain: %s",
                                   sess.sid, exc)
                absorbed += len(sess.absorbed) - before
        fl = self._fleet()
        if fl is not None:
            # the orphan scan replays the journal tail from disk —
            # at the 10 Hz drain cadence that is 10 tail replays/sec
            # per worker for nothing, so it runs at the fleet reap
            # scan's throttle (a fraction of the lease TTL) instead;
            # recovery latency stays bounded by ~TTL + one scan period
            mono = time.monotonic()
            if mono - self._orphan_scan_mono >= max(0.25, fl.ttl / 4):
                self._orphan_scan_mono = mono
                absorbed += self._adopt_orphans()
        return absorbed

    def _adopt_orphans(self) -> int:
        """Steal abandoned sessions: any journal-open session this
        worker doesn't hold in memory whose lease is absent, expired,
        or our own (a restart under the same ``--worker-id``: the
        orphan must not wait for a client to happen to hit its sid) is
        claimed lease-and-all, recovered from its checkpoint + spool
        directory, and its uncovered waves replayed — the fleet's
        work-stealing protocol applied to session keys."""
        fl = self._fleet()
        st = self.journal.read_state()
        absorbed = 0
        now = time.time()
        with self._lock:
            have = set(self.sessions)
        for sid, view in sorted(st.sessions.items()):
            if view.get("status") == "closed" or sid in have:
                continue
            cur = st.claims.get(sid)
            # skip only a LIVE lease held by a PEER (mirrors
            # _try_adopt); our own lease — live or expired — over a
            # session we don't hold in memory is a restart's orphan,
            # and try_claim adopts it by renewal
            if cur is not None and cur["worker"] != fl.worker_id \
                    and now < cur["expires_unix"]:
                continue
            if not fl.try_claim(sid, sid, st=st):
                continue                # lost the steal race
            stolen_from = ""
            if cur is not None and cur["worker"] != fl.worker_id:
                stolen_from = cur["worker"]
            sess = self._recover(sid, view,
                                 tenant=st.tenants.get(sid, ""),
                                 stolen_from=stolen_from)
            if sess is None:
                continue
            with sess.lock:
                before = len(sess.absorbed)
                try:
                    self._absorb_pending(sess)
                except SessionError as exc:
                    logger.warning("stolen session %s replay: %s",
                                   sid, exc)
                absorbed += len(sess.absorbed) - before
        return absorbed

    def _recover(self, sid: str, view: dict, tenant: str = "",
                 stolen_from: str = "") -> Optional[StreamSession]:
        """Rebuild a session's in-memory face from the journal view +
        its on-disk directory; pending = received − absorbed −
        effectively-rejected (the exactly-once replay set).  Only an
        EFFECTIVE rejection gates replay — one journaled after the
        wave's intent, or for a wave never received at all; a stale
        rejection naming a number a later wave legitimately carries
        must not suppress that wave (journal.effective_rejections)."""
        root = os.path.join(self.sessions_root, sid)
        try:
            with open(os.path.join(root, "header.sam"),
                      encoding="utf-8") as fh:
                header_text = fh.read()
            refs = _parse_header(header_text)
        except (OSError, SessionError) as exc:
            logger.warning("session %s unrecoverable (header: %s) — "
                           "leaving it journaled", sid, exc)
            return None
        waves = {int(w): dict(m)
                 for w, m in (view.get("waves") or {}).items()}
        absorbed = {int(w) for w in (view.get("absorbed") or {})}
        rejected = {int(w)
                    for w in sjournal.effective_rejections(view)}
        pending = sorted(set(waves) - absorbed - rejected)
        sess = StreamSession(
            sid=sid, tenant=tenant,
            root=root, header_text=header_text,
            header_sha=sha256_hex(header_text.encode("utf-8")),
            refs=refs, waves=waves, absorbed=absorbed,
            pending=pending,
            reads_total=int(view.get("reads_total") or 0),
            digest=str(view.get("digest", "")),
            prev_digest=str(view.get("digest", "")),
            stable=bool(view.get("stable")),
            stable_wave=view.get("stable_wave"),
            stolen_from=stolen_from)
        # wave_next clears EVERY journaled number, rejected ones
        # included: reusing a rejected number would let its old
        # wave_rejected record void the next wave on a later recovery
        sess.wave_next = max(
            max(waves, default=0),
            max((int(w) for w in (view.get("rejected") or {})),
                default=0)) + 1
        with self._lock:
            existing = self.sessions.get(sid)
            if existing is not None:
                return existing     # a concurrent adopter won the race
            self.sessions[sid] = sess
        self.registry.add("session/recovered", 1)
        if stolen_from:
            self.registry.add("session/steals", 1)
        self._gauges()
        logger.info(
            "session %s adopted (%s): %d wave(s) received, %d absorbed,"
            " %d to replay", sid,
            f"stolen from {stolen_from}" if stolen_from else "recovered",
            len(waves), len(absorbed), len(pending))
        return sess

    # -- health ------------------------------------------------------------
    def health_summary(self) -> dict:
        """The ``sessions`` health-snapshot section (serve/health.py)
        and the s2c_top sessions line's data source.  Built WITHOUT
        any session's wave lock (the map lock is held only for the
        snapshot of the map itself): a mid-absorb health probe answers
        immediately, which is what lets health.py promise that nothing
        in this section blocks."""
        with self._lock:
            sessions = dict(self.sessions)
        now = time.monotonic()
        live = {sid: s for sid, s in sessions.items()
                if not s.closed}
        newest = max((s.last_wave_mono for s in live.values()),
                     default=None)
        return {
            "open": len(live),
            "waves_received": int(
                self.registry.value("session/waves")),
            "waves_absorbed": int(
                self.registry.value("session/waves_absorbed")),
            "waves_rejected": int(
                self.registry.value("session/waves_rejected")),
            "pending": sum(len(s.pending) for s in live.values()),
            "stable": sum(1 for s in live.values() if s.stable),
            "steals": int(self.registry.value("session/steals")),
            "last_wave_age_sec": round(now - newest, 3)
            if newest is not None else None,
            "sessions": {
                sid: {"tenant": s.tenant, "waves": len(s.waves),
                      "absorbed": len(s.absorbed),
                      "pending": len(s.pending),
                      "reads_total": s.reads_total,
                      "stable": s.stable,
                      "digest": s.digest[:19],
                      "last_wave_age_sec": round(
                          now - s.last_wave_mono, 3)}
                for sid, s in sorted(live.items())}}
