"""Fleet flight recorder: the journal as the spine of a distributed trace.

Copy of ``sam2consensus_tpu/observability/flight.py`` (pinned by
``tests/test_torch_copies.py``): the port's journal is the reference's,
so the same events assemble into the same tracks on either package.

Every observability plane before this one is scoped to ONE process —
per-job spans/metrics, the decision ledger, worker-labeled exposition,
the memory plane all see a job only while *their* worker holds it.
Since the fleet layer (serve/fleet.py) a job's real life is
distributed: submitted by one process, queued in the shared journal,
claimed (or stolen after a SIGKILL) by another, committed under a
fenced lease.  The journal's event stream already carries everything a
distributed trace needs — totally-ordered segments, wall-clock ``t``
per event, worker ids on every lease event — so this module turns a
replayed journal into:

* **per-job lifecycle tracks** (:func:`assemble`): one
  :class:`JobLifecycle` per journal key, with the raw event list and
  derived segments — queue wait, claim latency, run attempts, steal
  gaps (victim's last lease sign of life -> reap -> re-claim) — that
  tile the job's submit->terminal wall clock with no holes and no
  negative durations;
* **scheduler telemetry** (:func:`sched_metrics`): per-tenant
  ``queue_wait_sec`` / ``claim_latency_sec`` / ``steal_latency_sec``
  distributions, ``lease_churn``, and per-worker busy/occupancy
  fractions, all derived from journal timestamps — the measured
  substrate the elastic-fleet planner (ROADMAP item 3) prices
  placement against.  The serve runner derives the same numbers live
  (``sched/*`` registry families, the ``s2c_sched_*`` exposition);
  this module is the offline replay that audits them;
* **a Chrome/Perfetto trace** (:func:`chrome_events` via
  tools/fleet_trace.py): per-job tracks, lease renewals as instants,
  flow arrows tying each run segment to a per-worker occupancy lane,
  and (when per-worker ``--trace-out`` artifacts are supplied) each
  worker's in-process phase spans re-anchored from its
  ``perf_counter`` epoch onto the journal's wall clock and joined by
  ``trace_id`` — no guessing;
* **critical-path attribution** (:func:`critical_path`): per job the
  end-to-end decomposition (queue -> claim -> decode -> dispatch ->
  tail -> commit, including cross-process waits), aggregated into the
  "where does the wall go" report of ``fleet_trace --report``.

Trace-context propagation: a job's ``trace_id`` is its journal key
(:func:`trace_id` centralizes the derivation) — stable across
processes, restarts and steals because the key hashes the input path
plus the output-relevant config (serve/journal.job_key).  The runner
stamps it into each job's trace JSON (the ``s2c`` metadata block
export.write_chrome_trace emits), metrics JSONL (the ``sched/trace``
gauge info) and manifest (the ``lifecycle`` section), so cross-process
artifacts join on an identifier, not on filename heuristics.

Clock assumptions are the journal's own: events carry
``round(time.time(), 3)`` stamped at append time, and commit fencing
relies on ``rec.t >= expires_unix`` arbitration
(serve/journal.JobJournal._apply) — tests/test_flight.py pins both the
per-key timestamp monotonicity this module leans on and that
arbitration rule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: lifecycle events that sign a worker's liveness for a key — the
#: newest of these from the lease holder is the last proof of life a
#: steal gap is measured from
_LEASE_EVENTS = ("claimed", "lease_renewed", "started")

#: terminal events per key
_TERMINAL = ("committed", "failed")


def trace_id(key: str) -> str:
    """The ONE trace-context derivation: a job's trace id IS its
    journal key (serve/journal.job_key — sha256 over input path +
    output-relevant config, 16 hex chars).  Centralized so every
    stamping site (runner, manifest, exposition, assembler) derives it
    the same way; a future format change happens here only."""
    return str(key)


@dataclass
class Segment:
    """One horizontal slice of a per-job track: ``[t0, t1)`` wall
    seconds with a kind from the lifecycle vocabulary (``queue_wait``,
    ``claim_latency``, ``run``, ``steal_gap``, ``commit_wait``)."""

    kind: str
    t0: float
    t1: float
    worker: str = ""
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass
class JobLifecycle:
    """Everything the journal knows about one key's distributed life."""

    key: str
    job_id: str = ""
    tenant: str = ""
    filename: str = ""
    #: raw journal events for this key, in segment order
    events: List[dict] = field(default_factory=list)
    #: derived, gap-free track segments (submit -> terminal)
    segments: List[Segment] = field(default_factory=list)
    #: instant markers (lease renewals, reaps, resumes): (name, t, args)
    instants: List[Tuple[str, float, dict]] = field(default_factory=list)
    submitted_t: Optional[float] = None
    started_t: Optional[float] = None       # first started
    terminal_t: Optional[float] = None
    terminal_ev: str = ""                   # committed | failed | ""
    committed_worker: str = ""
    #: journal-measured scheduler numbers (None where not applicable)
    queue_wait_sec: Optional[float] = None
    claim_latency_sec: Optional[float] = None
    steal_latency_sec: Optional[float] = None
    lease_churn: int = 0
    renewals: int = 0
    steals: int = 0

    @property
    def tid(self) -> str:
        return trace_id(self.key)


def _t(rec: dict) -> float:
    try:
        return float(rec.get("t", 0.0))
    except (TypeError, ValueError):
        return 0.0


def assemble(events: List[dict]) -> Dict[str, JobLifecycle]:
    """Replay journal events into per-key lifecycle models.

    Mirrors the journal's own claim/lease state machine
    (serve/journal.JobJournal._apply) where it matters: the FIRST
    ``claimed`` while no lease is open wins; ``lease_expired`` is
    effective only under the ``rec.t >= expires_unix`` arbitration
    rule; a ``committed`` from other than the open lease's holder is a
    voided zombie append (recorded as an instant, never a terminal).
    Corrupt segments (``ev == "_corrupt"``) are skipped — the reader
    already warned.
    """
    jobs: Dict[str, JobLifecycle] = {}
    #: key -> the open lease {worker, claim_seq, expires_unix, t}
    claims: Dict[str, dict] = {}
    claimed_ever: set = set()
    for rec in events:
        ev = rec.get("ev")
        key = rec.get("key")
        if ev == "_corrupt" or not key:
            continue
        jl = jobs.get(key)
        if jl is None:
            jl = jobs[key] = JobLifecycle(key=key)
        if rec.get("job") and not jl.job_id:
            jl.job_id = str(rec["job"])
        if rec.get("tenant") and not jl.tenant:
            jl.tenant = str(rec["tenant"])
        jl.events.append(rec)
        t = _t(rec)
        worker = str(rec.get("worker", "") or "")
        if ev == "submitted":
            if jl.submitted_t is None:
                jl.submitted_t = t
            if rec.get("filename"):
                jl.filename = str(rec["filename"])
        elif ev == "started":
            if jl.started_t is None:
                jl.started_t = t
            cur = claims.get(key)
            if cur is not None and cur["worker"] == worker:
                cur["t"] = t
        elif ev == "claimed":
            claimed_ever.add(key)
            if key not in claims:
                claims[key] = {
                    "worker": worker,
                    "claim_seq": int(rec.get("seq", 0)),
                    "expires_unix": float(rec.get("expires_unix", 0.0)),
                    "t": t}
                jl.instants.append(("claim_won", t, {
                    "worker": worker, "seq": rec.get("seq")}))
            else:
                jl.lease_churn += 1
                jl.instants.append(("claim_lost", t, {
                    "worker": worker,
                    "holder": claims[key]["worker"]}))
        elif ev == "lease_renewed":
            cur = claims.get(key)
            if cur is not None and cur["worker"] == worker:
                cur["expires_unix"] = float(
                    rec.get("expires_unix", 0.0))
                cur["t"] = t
                jl.renewals += 1
                jl.instants.append(("lease_renewed", t,
                                    {"worker": worker}))
        elif ev == "lease_expired":
            cur = claims.get(key)
            # the arbitration clock assumption commit fencing relies
            # on: a reap is effective only when its append timestamp
            # sits at/after the lease's expiry — a renewal that
            # published first voids it (tests pin this)
            if cur is not None and cur["worker"] == worker \
                    and t >= cur["expires_unix"]:
                jl.lease_churn += 1
                jl.instants.append(("lease_reaped", t, {
                    "victim": worker,
                    "reaper": rec.get("reaper", ""),
                    "victim_last_t": cur.get("t"),
                    "expired_unix": cur.get("expires_unix")}))
                # the journal's own transition: the lease closes, the
                # key is re-claimable — the NEXT winning claim is the
                # steal (segment derivation measures its gap from the
                # victim's last sign of life)
                del claims[key]
            else:
                jl.instants.append(("lease_reap_void", t, {
                    "victim": worker,
                    "reaper": rec.get("reaper", "")}))
        elif ev in _TERMINAL:
            cur = claims.get(key)
            if ev == "committed" and key in claimed_ever:
                cs = rec.get("claim_seq")
                if cur is None or cur["worker"] != worker \
                        or (cs is not None
                            and cs != cur.get("claim_seq")):
                    # zombie append voided by the lease fence
                    jl.instants.append(("stale_commit", t,
                                        {"worker": worker}))
                    continue
            if jl.terminal_t is None:
                jl.terminal_t = t
                jl.terminal_ev = ev
                if ev == "committed":
                    jl.committed_worker = worker
            claims.pop(key, None)
        elif ev == "resumed":
            jl.instants.append(("resumed", t,
                                {"mode": rec.get("mode", "")}))
        elif ev == "rejected":
            jl.instants.append(("rejected", t,
                                {"reason": rec.get("reason", "")}))
    for jl in jobs.values():
        _derive_segments(jl)
    return jobs


def _derive_segments(jl: JobLifecycle) -> None:
    """Tile a job's submit->terminal wall clock into contiguous,
    non-negative segments.  The derivation walks the per-key event
    list (segment order == time order per key — pinned by tests) and
    closes the open segment at every transition, so the track is
    gap-free by construction even across a SIGKILL: the victim's
    silence is covered by the ``steal_gap`` segment from its last
    lease sign of life to the thief's re-claim."""
    segs: List[Segment] = []
    open_kind: Optional[str] = None
    open_t: Optional[float] = None
    open_worker = ""
    open_args: dict = {}

    def close(t: float) -> None:
        nonlocal open_kind, open_t
        if open_kind is None or open_t is None:
            return
        if t > open_t:
            segs.append(Segment(open_kind, open_t, t, open_worker,
                                dict(open_args)))
        open_kind = open_t = None

    claim_worker = ""
    claim_t: Optional[float] = None
    last_lease_t: Optional[float] = None
    n_claims = 0
    for rec in jl.events:
        ev = rec.get("ev")
        t = _t(rec)
        worker = str(rec.get("worker", "") or "")
        if ev == "submitted" and open_kind is None:
            open_kind, open_t = "queue_wait", t
            open_worker, open_args = "", {}
        elif ev == "claimed":
            won = any(name == "claim_won" and abs(it - t) < 5e-4
                      and args.get("seq") == rec.get("seq")
                      for name, it, args in jl.instants)
            if not won:
                continue
            n_claims += 1
            stolen = last_lease_t is not None
            close(t)
            if stolen:
                # re-label the just-closed wait as the steal gap the
                # fleet_soak bound measures (victim last sign of life
                # -> re-claim); keep its start where the victim went
                # silent when that is known
                if segs and segs[-1].kind == "queue_wait":
                    segs[-1].kind = "steal_gap"
                    segs[-1].args["victim_last_t"] = last_lease_t
                if jl.steal_latency_sec is None:
                    jl.steal_latency_sec = max(0.0, t - last_lease_t)
                jl.steals += 1
            else:
                if jl.claim_latency_sec is None \
                        and jl.submitted_t is not None:
                    jl.claim_latency_sec = max(0.0, t - jl.submitted_t)
            claim_worker = worker
            last_lease_t = t
            open_kind, open_t = "claim_latency", t
            open_worker, open_args = worker, {"claim_seq":
                                              rec.get("seq")}
        elif ev == "started":
            close(t)
            # serial (claim-free) journals go straight submitted ->
            # started: the closed segment was the whole queue wait
            open_kind, open_t = "run", t
            open_worker = worker or claim_worker
            open_args = {"attempt": n_claims or 1}
            if worker or claim_worker:
                last_lease_t = t
        elif ev == "lease_renewed" and worker == claim_worker:
            last_lease_t = t
        elif ev == "lease_expired":
            reaped = any(name == "lease_reaped" and abs(it - t) < 5e-4
                         for name, it, args in jl.instants)
            if not reaped:
                continue
            close(t)
            # between the reap and the re-claim the job is ownerless:
            # the steal gap's visible tail (its head — victim silence
            # before the reap — is re-labeled at re-claim time above)
            open_kind, open_t = "queue_wait", t
            open_worker, open_args = "", {"after_reap": True}
        elif ev in _TERMINAL:
            if ev == "committed" and any(
                    name == "stale_commit" and abs(it - t) < 5e-4
                    and args.get("worker") == worker
                    for name, it, args in jl.instants):
                continue         # voided zombie append (lease fence)
            close(t)
    if jl.submitted_t is not None and jl.started_t is not None:
        jl.queue_wait_sec = max(0.0, jl.started_t - jl.submitted_t)
    jl.segments = segs


def sched_metrics(jobs: Dict[str, JobLifecycle]) -> dict:
    """Fleet-aggregate scheduler telemetry from assembled lifecycles.

    Returns ``{"per_tenant": {tenant: {queue_wait_sec: [..],
    claim_latency_sec: [..], steal_latency_sec: [..]}},
    "lease_churn": int, "workers": {worker: {busy_sec, jobs,
    occupancy}}, "wall_sec": float}`` — the same vocabulary the
    runner's live ``sched/*`` families use, derived offline."""
    per_tenant: Dict[str, Dict[str, list]] = {}
    workers: Dict[str, dict] = {}
    churn = 0
    t_min = t_max = None
    for jl in jobs.values():
        tl = jl.tenant or "default"
        bucket = per_tenant.setdefault(tl, {
            "queue_wait_sec": [], "claim_latency_sec": [],
            "steal_latency_sec": []})
        if jl.queue_wait_sec is not None:
            bucket["queue_wait_sec"].append(jl.queue_wait_sec)
        if jl.claim_latency_sec is not None:
            bucket["claim_latency_sec"].append(jl.claim_latency_sec)
        if jl.steal_latency_sec is not None:
            bucket["steal_latency_sec"].append(jl.steal_latency_sec)
        churn += jl.lease_churn
        for seg in jl.segments:
            if t_min is None or seg.t0 < t_min:
                t_min = seg.t0
            if t_max is None or seg.t1 > t_max:
                t_max = seg.t1
            if seg.kind == "run" and seg.worker:
                w = workers.setdefault(seg.worker,
                                       {"busy_sec": 0.0, "jobs": 0})
                w["busy_sec"] += seg.dur
                w["jobs"] += 1
    wall = (t_max - t_min) if (t_min is not None
                               and t_max is not None) else 0.0
    for w in workers.values():
        w["busy_sec"] = round(w["busy_sec"], 6)
        w["occupancy"] = round(w["busy_sec"] / wall, 4) \
            if wall > 0 else 0.0
    return {"per_tenant": per_tenant, "lease_churn": churn,
            "workers": workers, "wall_sec": round(wall, 6)}


def session_wave_tracks(events: List[dict]) -> Dict[str, dict]:
    """Streaming-session wave tracks from raw journal events
    (serve/session.py's vocabulary: ``session_open`` /
    ``wave_received`` / ``wave_absorbed`` / ``wave_rejected`` /
    ``session_stable`` / ``session_closed``).

    Per session: one track entry per wave with its received->absorbed
    latency (the durable-intent-to-counted gap — a wave replayed after
    a steal shows the steal's takeover window here), the absorbing
    worker, any DATA-class rejection, plus session-level marks
    (opened/stable/closed) and the claim handoffs (``claimed`` events
    on the session key from successive workers — each handoff past the
    first is a steal or restart takeover).  Offline twin of the live
    ``s2c_session_*`` exposition family, same journal truth source as
    :func:`assemble`."""
    sessions: Dict[str, dict] = {}

    def _view(sid: str) -> dict:
        s = sessions.get(sid)
        if s is None:
            s = sessions[sid] = {
                "tenant": "", "opened_t": None, "closed_t": None,
                "stable_t": None, "stable_wave": None,
                "waves": {}, "handoffs": []}
        return s

    def _wave(s: dict, rec: dict) -> dict:
        n = int(rec.get("wave", 0))
        w = s["waves"].get(n)
        if w is None:
            w = s["waves"][n] = {
                "received_t": None, "absorbed_t": None,
                "absorb_latency_sec": None, "worker": "",
                "rejected": None, "sha": str(rec.get("sha", ""))}
        return w

    for rec in events:
        ev = rec.get("ev")
        sid = rec.get("key")
        if ev == "_corrupt" or not sid:
            continue
        t = _t(rec)
        if ev == "session_open":
            s = _view(sid)
            s["opened_t"] = t
            s["tenant"] = str(rec.get("tenant", "") or "")
        elif ev == "wave_received":
            w = _wave(_view(sid), rec)
            if w["received_t"] is None:     # first intent wins
                w["received_t"] = t
        elif ev == "wave_absorbed":
            w = _wave(_view(sid), rec)
            if w["absorbed_t"] is None:     # exactly-once: first wins
                w["absorbed_t"] = t
                w["worker"] = str(rec.get("worker", "") or "")
                if w["received_t"] is not None:
                    w["absorb_latency_sec"] = round(
                        t - w["received_t"], 6)
        elif ev == "wave_rejected":
            w = _wave(_view(sid), rec)
            w["rejected"] = str(rec.get("reason", "") or "rejected")
        elif ev == "session_stable":
            s = _view(sid)
            if s["stable_t"] is None:
                s["stable_t"] = t
                s["stable_wave"] = rec.get("wave")
        elif ev == "session_closed":
            _view(sid)["closed_t"] = t
        elif ev == "claimed" and sid in sessions:
            sessions[sid]["handoffs"].append(
                {"worker": str(rec.get("worker", "") or ""), "t": t})
    return sessions


# =========================================================================
# Chrome/Perfetto assembly
# =========================================================================
#: synthetic pid lanes in the assembled trace
PID_JOBS = 1
PID_WORKERS = 2
#: worker in-process traces get pids starting here (one per file)
PID_WORKER_TRACE0 = 10


def _us(t: float, t0: float) -> float:
    return round((t - t0) * 1e6, 1)


def chrome_events(jobs: Dict[str, JobLifecycle],
                  worker_traces: Optional[List[dict]] = None) -> list:
    """Assembled lifecycles (+ optional per-worker in-process traces)
    -> one Chrome trace-event list.

    Layout: pid 1 hosts one tid per job (thread-named
    ``job <job_id> [<trace_id>]``) carrying the lifecycle segments as
    ``ph: X`` spans and lease activity as ``ph: i`` instants; pid 2
    hosts one tid per worker (the occupancy lane) with that worker's
    run spans; ``ph: s``/``f`` flow arrows tie each job run span to
    its worker-lane twin, so Perfetto draws the hop a steal makes
    between lanes.  ``worker_traces`` entries are parsed ``--trace-out``
    blobs (dicts with ``traceEvents`` and the ``s2c`` metadata block:
    ``epoch_unix`` re-anchors their perf_counter microseconds onto the
    journal's wall clock; ``trace_id`` joins them to the right job)."""
    t0 = None
    for jl in jobs.values():
        for cand in (jl.submitted_t, jl.started_t):
            if cand is not None and (t0 is None or cand < t0):
                t0 = cand
        for seg in jl.segments:
            if t0 is None or seg.t0 < t0:
                t0 = seg.t0
    if t0 is None:
        t0 = 0.0
    events: list = []
    worker_tids: Dict[str, int] = {}

    def worker_tid(w: str) -> int:
        tid = worker_tids.get(w)
        if tid is None:
            tid = worker_tids[w] = len(worker_tids) + 1
            events.append({"ph": "M", "pid": PID_WORKERS, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"worker {w}"}})
        return tid

    events.append({"ph": "M", "pid": PID_JOBS, "tid": 0,
                   "name": "process_name",
                   "args": {"name": "fleet jobs"}})
    events.append({"ph": "M", "pid": PID_WORKERS, "tid": 0,
                   "name": "process_name",
                   "args": {"name": "workers"}})
    flow_id = 0
    for jid, (key, jl) in enumerate(sorted(jobs.items()), start=1):
        events.append({
            "ph": "M", "pid": PID_JOBS, "tid": jid,
            "name": "thread_name",
            "args": {"name": f"job {jl.job_id or key} [{jl.tid}]"}})
        for seg in jl.segments:
            ev = {"ph": "X", "pid": PID_JOBS, "tid": jid,
                  "name": seg.kind, "ts": _us(seg.t0, t0),
                  "dur": max(0.0, round(seg.dur * 1e6, 1)),
                  "args": {"trace_id": jl.tid,
                           **({"worker": seg.worker}
                              if seg.worker else {}),
                           **seg.args}}
            events.append(ev)
            if seg.kind == "run" and seg.worker:
                flow_id += 1
                wtid = worker_tid(seg.worker)
                events.append({
                    "ph": "X", "pid": PID_WORKERS, "tid": wtid,
                    "name": f"run {jl.job_id or key}",
                    "ts": _us(seg.t0, t0),
                    "dur": max(0.0, round(seg.dur * 1e6, 1)),
                    "args": {"trace_id": jl.tid}})
                # flow arrow: job track -> worker occupancy lane
                events.append({"ph": "s", "pid": PID_JOBS, "tid": jid,
                               "name": "placement", "cat": "sched",
                               "id": flow_id, "ts": _us(seg.t0, t0)})
                events.append({"ph": "f", "pid": PID_WORKERS,
                               "tid": wtid, "name": "placement",
                               "cat": "sched", "id": flow_id,
                               "ts": _us(seg.t0, t0), "bp": "e"})
        for name, t, args in jl.instants:
            events.append({"ph": "i", "pid": PID_JOBS, "tid": jid,
                           "name": name, "ts": _us(t, t0), "s": "t",
                           "args": {"trace_id": jl.tid, **args}})
    # per-worker in-process traces, re-anchored to wall clock
    by_trace_id = {jl.tid: jl for jl in jobs.values()}
    for n, blob in enumerate(worker_traces or []):
        meta = blob.get("s2c") or {}
        epoch = meta.get("epoch_unix")
        if epoch is None:
            continue                 # no wall anchor: cannot join
        pid = PID_WORKER_TRACE0 + n
        wname = meta.get("worker") or f"trace{n}"
        tid_joined = meta.get("trace_id", "")
        joined = by_trace_id.get(tid_joined)
        label = f"worker {wname} trace"
        if joined is not None:
            label += f" [job {joined.job_id or joined.key}]"
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": label}})
        for e in blob.get("traceEvents", []):
            if e.get("ph") not in ("X", "i", "M"):
                continue
            ne = dict(e)
            ne["pid"] = pid
            if "ts" in ne:
                ne["ts"] = round((float(epoch) - t0) * 1e6
                                 + float(ne["ts"]), 1)
            if tid_joined:
                args = dict(ne.get("args") or {})
                args.setdefault("trace_id", tid_joined)
                ne["args"] = args
            events.append(ne)
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return events


def validate(events: list) -> List[str]:
    """Structural lint over an assembled trace-event list; returns
    violations (empty = valid).  The acceptance bar: Perfetto-loadable
    shape, at least one per-job track, zero negative durations, zero
    orphaned events (every sample event sits on a thread-named
    track)."""
    errs: List[str] = []
    named: set = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            named.add((e.get("pid"), e.get("tid")))
    if not any(pid == PID_JOBS for pid, _ in named):
        errs.append("no per-job track (no thread_name under pid 1)")
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "s", "f"):
            errs.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        if "ts" not in e:
            errs.append(f"event {i}: missing ts")
        if ph == "X":
            dur = e.get("dur")
            if dur is None:
                errs.append(f"event {i}: complete event missing dur")
            elif float(dur) < 0:
                errs.append(f"event {i}: negative duration {dur}")
        if e.get("pid") in (PID_JOBS, PID_WORKERS) \
                and (e.get("pid"), e.get("tid")) not in named:
            # only the assembler's own synthetic lanes must be fully
            # thread-named; merged in-process traces legitimately
            # carry spans on unnamed (but still renderable) threads
            errs.append(
                f"event {i}: orphaned — pid/tid "
                f"({e.get('pid')}, {e.get('tid')}) has no thread_name")
    return errs


# =========================================================================
# critical-path attribution
# =========================================================================
#: the end-to-end decomposition buckets, in pipeline order.  queue /
#: claim / steal / commit come from the journal; decode / dispatch /
#: tail split the run segment using the job's phase counters when a
#: metrics artifact or manifest is joined, else the run stays whole.
PATH_BUCKETS = ("queue", "claim", "steal", "decode", "dispatch",
                "tail", "run_other", "commit")

#: phase/<name>_sec counters -> decomposition bucket (the SLO plane's
#: dispatch/vote grouping, telemetry.slo_phase_seconds)
_PHASE_BUCKET = {"decode": "decode", "stage": "dispatch",
                 "pileup_dispatch": "dispatch", "accumulate": "dispatch",
                 "vote": "tail", "insertions": "tail", "render": "tail"}


def critical_path(jl: JobLifecycle,
                  phase_sec: Optional[dict] = None) -> Dict[str, float]:
    """One job's end-to-end wall decomposition (seconds per bucket).

    ``phase_sec`` is the job's ``phase/<name>_sec`` counter dict (from
    its metrics JSONL or manifest ``phases`` section, joined by
    trace_id); when present the run segment is split into decode /
    dispatch / tail with the remainder as ``run_other``, capped so a
    counter overshoot can never make the decomposition exceed the
    measured run wall."""
    out = {b: 0.0 for b in PATH_BUCKETS}
    run_sec = 0.0
    last_run_end = None
    for seg in jl.segments:
        if seg.kind == "queue_wait":
            out["queue"] += seg.dur
        elif seg.kind == "claim_latency":
            out["claim"] += seg.dur
        elif seg.kind == "steal_gap":
            out["steal"] += seg.dur
        elif seg.kind == "run":
            run_sec += seg.dur
            last_run_end = seg.t1
    if jl.terminal_t is not None and last_run_end is not None \
            and jl.terminal_t > last_run_end:
        out["commit"] = jl.terminal_t - last_run_end
    if phase_sec:
        budget = run_sec
        for ph, bucket in _PHASE_BUCKET.items():
            sec = float(phase_sec.get(f"phase/{ph}_sec",
                                      phase_sec.get(ph, 0.0)) or 0.0)
            sec = min(sec, budget)
            out[bucket] += sec
            budget -= sec
        out["run_other"] = max(0.0, budget)
    else:
        out["run_other"] = run_sec
    return {k: round(v, 6) for k, v in out.items()}


def wall_report(jobs: Dict[str, JobLifecycle],
                phase_by_trace_id: Optional[dict] = None) -> dict:
    """The fleet-aggregate "where does the wall go" answer: per-bucket
    totals (and the per-job decompositions they sum), for
    ``fleet_trace --report``."""
    totals = {b: 0.0 for b in PATH_BUCKETS}
    per_job = {}
    for key, jl in sorted(jobs.items()):
        ph = (phase_by_trace_id or {}).get(jl.tid)
        d = critical_path(jl, ph)
        per_job[jl.job_id or key] = d
        for b, v in d.items():
            totals[b] += v
    total = sum(totals.values())
    return {"totals_sec": {b: round(v, 6) for b, v in totals.items()},
            "total_sec": round(total, 6),
            "pct": {b: round(100.0 * v / total, 2) if total > 0 else 0.0
                    for b, v in totals.items()},
            "per_job": per_job}
