"""Fleet coordination: N serve workers stealing work from one journal.

Copy of ``sam2consensus_tpu/serve/fleet.py`` (pinned by
``tests/test_torch_copies.py``).  It drives the port's journal and the
port's :class:`~.runner.ServeRunner`, whose fleet methods keep the
reference's names and shapes (``_run_claimed_entry``,
``_resolve_completed_elsewhere``, ``_resolve_failed_elsewhere``,
``note_fleet_burn``, ``telemetry_tick``).

ROADMAP item 2(b), scale-out half: every serve capability so far runs
inside exactly one worker process — one crash, one wedge, or one long
job stalls the whole queue.  This module turns the journal's existing
exactly-once machinery (atomic single-event segments, job-key
fingerprints, commit-time output discipline) into a fleet coordinator:
N ``s2c serve --journal DIR --worker-id W`` processes share ONE
journal as a work-stealing queue.

The protocol, built entirely from journal events (serve/journal.py):

* **claim** — before running a job, a worker appends a ``claimed``
  event.  Segment publication is O_EXCL-atomic, so concurrent claims
  for the same key land as distinct, totally-ordered segments; the
  FIRST one (while no lease is open) wins, and the loser observes the
  winner on the post-append replay and moves on.  A claim carries a
  wall-clock lease ``expires_unix = now + lease_ttl``;
* **renew** — the holding worker pushes its leases' expiry on the
  watchdog tick (``lease_renewed``, at half-TTL margin).  Renewal is
  process-liveness, deliberately not job-progress: a wedged DISPATCH
  inside a live worker is the in-process watchdog's job
  (``--stall-timeout`` fails it locally); the lease layer exists for
  workers that stop executing at all — SIGKILL, SIGSTOP, hardware;
* **reap + steal** — every worker's tick also scans peers' leases; one
  past its ``expires_unix`` gets a ``lease_expired`` event (effective
  only if no renewal published first — journal order arbitrates) and
  the reaper re-claims the job, resuming from the dead worker's
  per-job checkpoint when one survived.  The job fingerprint +
  commit-at-output-time discipline already make the re-run idempotent;
  the lease just bounds WHO may run it WHEN;
* **commit confirmation** — immediately before committing outputs, a
  worker re-replays and confirms it still holds the lease.  A worker
  whose lease was reaped (it was frozen, then woke) abandons its
  commit (``fleet/lease_lost``) — the thief owns the job's lifecycle.

Clocks: leases compare wall-clock across processes, so the fleet
assumes workers share a clock (same host, or NTP-bounded skew well
under the TTL).  Two processes with the SAME ``--worker-id`` are
operator error — the id IS the lease identity.

Fleet-global tenant state: ``started``/``committed`` events carry the
tenant, so admission evidence (per-tenant in-flight counts, SLO e2e
burn over committed ``elapsed_sec``) is computed from journal-visible
fleet state rather than one worker's private counters —
:meth:`FleetCoordinator.fleet_burn` / :meth:`seed_window_counts`.

The claim/lease machinery is deliberately KEY-GENERIC: a key is any
journal string, not only a job fingerprint.  Streaming sessions
(serve/session.py) lease their session ids through the same
``try_claim``/renew/reap protocol — a dead worker's open session is
stolen lease-and-all and its unabsorbed waves replayed — with one
asymmetry: a session's ``wave_absorbed`` commits are lease-fenced
like job commits but NOT terminal (the lease stays open until
``session_closed``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("sam2consensus_torch.serve.fleet")

#: default lease TTL seconds (``--lease-ttl`` / S2C_LEASE_TTL).  Long
#: enough that a healthy worker's renewal cadence (half-TTL, riding
#: the 0.1 s watchdog poll) has two orders of magnitude of margin;
#: short enough that a dead worker's job is re-claimed quickly —
#: recovery latency is bounded by ~TTL + one reap-scan period.
DEFAULT_LEASE_TTL = 30.0


def resolve_lease_ttl(lease_ttl: Optional[float]) -> float:
    if lease_ttl is None:
        raw = os.environ.get("S2C_LEASE_TTL", "")
        if raw:
            try:
                lease_ttl = float(raw)
            except ValueError:
                logger.warning("S2C_LEASE_TTL=%r is not a number: using "
                               "the %gs default", raw, DEFAULT_LEASE_TTL)
    ttl = DEFAULT_LEASE_TTL if lease_ttl is None else float(lease_ttl)
    if not ttl > 0:
        raise ValueError(f"--lease-ttl must be > 0, got {ttl!r}")
    return ttl


class FleetCoordinator:
    """One worker's view of the shared-journal fleet protocol.

    Owned by a :class:`~.runner.ServeRunner` with ``worker_id`` set;
    all journal arbitration happens on FRESH disk reads
    (``journal.read_state()`` — O(tail) thanks to journal checkpoints,
    and mirror-free so the hot path skips replay()'s deepcopy), never
    on the runner's incremental mirror, which cannot see peers'
    appends."""

    def __init__(self, journal, worker_id: str, lease_ttl: float,
                 registry, verify_mode: str = "fast"):
        self.journal = journal
        self.worker_id = worker_id
        self.ttl = float(lease_ttl)
        self.registry = registry
        self.verify_mode = verify_mode
        #: key -> expires_unix for leases THIS worker holds
        self.held: Dict[str, float] = {}
        #: key -> the winning claim's segment seq — the lease LINEAGE
        #: stamped into the commit event, which journal replay fences
        #: against the open claim (a zombie's stale commit is void)
        self.claim_seqs: Dict[str, int] = {}
        #: key -> monotonic time of the last successful renewal
        self.last_renew: Dict[str, float] = {}
        #: key -> wall time this worker WON the key's lease — the
        #: flight recorder's claim-latency epoch (claim_unix -
        #: journal submit time); consumed by the runner at finalize
        self.claim_unix: Dict[str, float] = {}
        #: key -> measured steal gap for leases this worker STOLE:
        #: victim's last lease sign of life (claims entry ``t``) ->
        #: our winning re-claim.  The per-job number fleet_soak's
        #: 2xTTL bound is asserted against, surfaced as
        #: ``sched/<tenant>/steal_latency`` at finalize.
        self.steal_gaps: Dict[str, float] = {}
        self.reaped = 0
        self._last_reap_scan = 0.0
        #: drain liveness backstop (see drain()): seconds of ZERO
        #: journal advance with jobs pending before the drain fails
        #: loudly — a healthy fleet renews within ttl/2, so 6 TTLs of
        #: silence means every append path is dead
        self.drain_stall_budget = max(60.0, 6 * self.ttl)

    # -- journal plumbing --------------------------------------------------
    def _append(self, ev: str, **fields) -> Optional[int]:
        """Append, absorbing write failures (the runner's discipline:
        a journal that cannot be written degrades coordination, never
        correctness — an unjournaled claim simply is not held)."""
        try:
            return self.journal.append(ev, **fields)
        except Exception as exc:
            self.registry.add("fleet/journal_write_failed", 1)
            logger.warning("fleet journal append %s failed (%s: %s)",
                           ev, type(exc).__name__, exc)
            return None

    # -- claims ------------------------------------------------------------
    def _claim_blocked(self, st, key: str,
                       reclaim_stale_failed: bool) -> bool:
        """True when ``key`` is terminal in ``st`` and must NOT be
        (re-)claimed: a HEALTHY commit (outputs verify — claiming
        would re-run and double-commit), or a failure that is not a
        stale pre-restart one the caller chose to retry.  A committed
        record whose outputs no longer verify is claimable: the
        re-run restores them (the serial restart path's contract)."""
        rec = st.committed.get(key)
        if rec is not None:
            return self.journal.verify_outputs(rec,
                                               mode=self.verify_mode)
        if key in st.failed:
            return not reclaim_stale_failed
        return False

    def try_claim(self, key: str, job_id: str, st=None,
                  reclaim_stale_failed: bool = False) -> bool:
        """Contend for ``key``; True iff this worker now holds its
        lease.  Sequence: early-outs on ``st`` (the caller's already-
        fresh view, e.g. the drain round's — saves an O(tail) replay
        per peer-held pending job per poll) -> fresh replay -> (reap
        if expired) -> append ``claimed`` -> re-replay to learn who
        won.  A key terminal in the fresh view is never claimable
        (see :meth:`_claim_blocked`): a peer's healthy commit landing
        between the caller's scan and this call must not let us
        re-run the job — a second commit is exactly the duplication
        the audit forbids."""
        if st is not None:
            now = time.time()
            cur = st.claims.get(key)
            if self._claim_blocked(st, key, reclaim_stale_failed):
                return False
            if cur is not None and cur["worker"] != self.worker_id \
                    and now < cur["expires_unix"]:
                return False            # live lease elsewhere
        try:
            st = self.journal.read_state()
        except Exception as exc:
            logger.warning("fleet claim replay failed (%s: %s)",
                           type(exc).__name__, exc)
            return False
        if self._claim_blocked(st, key, reclaim_stale_failed):
            return False                # went terminal since the scan
        now = time.time()
        cur = st.claims.get(key)
        stole = False
        if cur is not None:
            if cur["worker"] == self.worker_id \
                    and now < cur["expires_unix"]:
                # our own LIVE lease (a restart under the same
                # --worker-id): adopt by renewal — then CONFIRM, like
                # any claim: a peer may have legitimately reaped and
                # stolen it between our replay and the renewal append
                exp = now + self.ttl
                if self._append("lease_renewed", key=key,
                                worker=self.worker_id,
                                expires_unix=round(exp, 3)) is None:
                    return False
                try:
                    st = self.journal.read_state()
                except Exception:
                    return False
                cur = st.claims.get(key)
                if cur is not None \
                        and cur["worker"] == self.worker_id:
                    self.held[key] = exp
                    self.claim_seqs[key] = int(
                        cur.get("claim_seq", 0))
                    self.last_renew[key] = time.monotonic()
                    self.claim_unix[key] = now
                    self.registry.add("fleet/claims", 1)
                    return True
                self.registry.add("fleet/claim_lost", 1)
                self.registry.add("sched/lease_churn", 1)
                return False
            if cur["worker"] != self.worker_id \
                    and now < cur["expires_unix"]:
                return False            # live lease elsewhere
            # expired (a peer's, or a stale incarnation of our own
            # id): reap (journal order voids this if a renewal
            # published first), then contend for the re-claim
            self._append("lease_expired", key=key, worker=cur["worker"],
                         reaper=self.worker_id)
            self.reaped += 1
            self.registry.add("fleet/lease_reaped", 1)
            self.registry.add("sched/lease_churn", 1)
            stole = cur["worker"] != self.worker_id
            # the victim's last lease sign of life (claims entry
            # ``t``): the epoch the steal gap is measured from
            victim_last_t = float(cur.get(
                "t", cur["expires_unix"] - self.ttl))
        exp = now + self.ttl
        seq = self._append("claimed", key=key, job=job_id,
                           worker=self.worker_id,
                           expires_unix=round(exp, 3))
        if seq is None:
            return False                # never run a job we can't claim
        try:
            st = self.journal.read_state()
        except Exception:
            return False
        cur = st.claims.get(key)
        won = cur is not None and cur.get("claim_seq") == seq
        if won:
            self.held[key] = exp
            self.claim_seqs[key] = seq
            self.last_renew[key] = time.monotonic()
            self.claim_unix[key] = now
            self.registry.add("fleet/claims", 1)
            if stole:
                self.registry.add("fleet/steals", 1)
                self.steal_gaps[key] = max(0.0, now - victim_last_t)
        else:
            self.registry.add("fleet/claim_lost", 1)
            self.registry.add("sched/lease_churn", 1)
        return won

    def holds(self, key: str) -> bool:
        """Fresh-replay confirmation that this worker still owns the
        lease — called immediately before committing outputs.  False
        means the lease was reaped (we were presumed dead): the thief
        owns the job now, and our result must be abandoned."""
        try:
            st = self.journal.read_state()
        except Exception:
            return False
        cur = st.claims.get(key)
        ok = (cur is not None and cur["worker"] == self.worker_id
              and time.time() < cur["expires_unix"])
        if not ok:
            self.held.pop(key, None)
            self.claim_seqs.pop(key, None)
            self.last_renew.pop(key, None)
        return ok

    def renew_now(self, key: str) -> None:
        """Unconditionally push a held lease's expiry to now + TTL —
        called right before a potentially slow commit (output write +
        fingerprinting run with no watchdog ticks), so the commit
        window starts with a full TTL of margin."""
        if key not in self.held:
            return
        exp = time.time() + self.ttl
        if self._append("lease_renewed", key=key,
                        worker=self.worker_id,
                        expires_unix=round(exp, 3)) is not None:
            self.held[key] = exp
            self.last_renew[key] = time.monotonic()
            self.registry.add("fleet/lease_renewals", 1)

    def release(self, key: str) -> None:
        """Local bookkeeping after a terminal event (the journal-side
        lease is closed by the ``committed``/``failed`` event)."""
        self.held.pop(key, None)
        self.claim_seqs.pop(key, None)
        self.last_renew.pop(key, None)
        self.claim_unix.pop(key, None)
        self.steal_gaps.pop(key, None)

    # -- the watchdog-tick duties ------------------------------------------
    def tick(self) -> None:
        """Rides the runner's watchdog poll / telemetry tick: renew
        held leases at half-TTL margin; reap peers' expired leases on
        a throttled cadence (a replay per tick would be wasteful at
        the 0.1 s poll rate)."""
        now = time.time()
        for key, exp in list(self.held.items()):
            if exp - now < self.ttl / 2:
                nexp = now + self.ttl
                if self._append("lease_renewed", key=key,
                                worker=self.worker_id,
                                expires_unix=round(nexp, 3)) is not None:
                    self.held[key] = nexp
                    self.last_renew[key] = time.monotonic()
                    self.registry.add("fleet/lease_renewals", 1)
        mono = time.monotonic()
        if mono - self._last_reap_scan >= max(0.25, self.ttl / 4):
            self._last_reap_scan = mono
            try:
                st = self.journal.read_state()
            except Exception:
                return
            self.reap_expired(st)

    def reap_expired(self, st) -> int:
        """Append ``lease_expired`` for every PEER lease past its
        expiry in ``st``; returns the number reaped.  Reaping only
        frees the key — stealing is the subsequent claim."""
        now = time.time()
        n = 0
        for key, cur in list(st.claims.items()):
            if cur["worker"] != self.worker_id \
                    and now >= cur["expires_unix"]:
                self._append("lease_expired", key=key,
                             worker=cur["worker"],
                             reaper=self.worker_id)
                self.reaped += 1
                self.registry.add("fleet/lease_reaped", 1)
                self.registry.add("sched/lease_churn", 1)
                n += 1
                logger.warning(
                    "reaped expired lease: key %s held by worker %r "
                    "(%.1fs past TTL) — its job is re-claimable", key,
                    cur["worker"], now - cur["expires_unix"])
        return n

    # -- fleet-visible state -----------------------------------------------
    def lease_summary(self) -> dict:
        """The health snapshot's ``lease`` section."""
        now = time.time()
        mono = time.monotonic()
        reg = self.registry
        return {
            "ttl_sec": self.ttl,
            "held": {
                key: {
                    "expires_in_sec": round(exp - now, 3),
                    "last_renew_age_sec": round(
                        mono - self.last_renew.get(key, mono), 3),
                } for key, exp in sorted(self.held.items())},
            "reaped": self.reaped,
            "claims": int(reg.value("fleet/claims")),
            "claim_lost": int(reg.value("fleet/claim_lost")),
            "steals": int(reg.value("fleet/steals")),
            "lease_lost": int(reg.value("fleet/lease_lost")),
            "renewals": int(reg.value("fleet/lease_renewals")),
        }

    def fleet_burn(self, st, slo: Optional[dict]) -> Dict[str, int]:
        """Journal-visible SLO e2e burn per tenant: committed events
        whose recorded ``elapsed_sec`` beat the e2e objective — the
        fleet-global counterpart of each worker's private burn
        counters (a tenant cannot reset its burn by spreading slow
        jobs across workers)."""
        obj = (slo or {}).get("e2e")
        out: Dict[str, int] = {}
        if not obj:
            return out
        for key, rec in st.committed.items():
            if float(rec.get("elapsed_sec", 0.0)) > obj:
                t = rec.get("tenant") or st.tenants.get(key) or ""
                out[t] = out.get(t, 0) + 1
        return out

    def seed_window_counts(self, st, own_keys) -> Dict[str, int]:
        """Per-tenant counts of OTHER workers' journal-visible live
        jobs (submitted/started, not terminal, not ours) — seeded into
        the admission window so ``--tenant-quota`` holds against the
        fleet's queue, not just this worker's submission."""
        out: Dict[str, int] = {}
        own = set(own_keys)
        terminal = set(st.committed) | set(st.failed)
        for key in st.submitted:
            if key in own or key in terminal:
                continue
            t = st.tenants.get(key)
            if t:
                out[t] = out.get(t, 0) + 1
        return out

    # -- the work-stealing drain -------------------------------------------
    def drain(self, runner, plan, window_t0, replay, recovery_info):
        """Drain a planned queue cooperatively: claim-run entries this
        worker wins, observe peers' commits/failures for the rest, and
        steal expired leases until every entry is terminal.  Returns
        one JobResult per plan entry, in order."""
        results: Dict[int, object] = {}
        # fleet-global admission evidence (see the module docstring)
        burn = self.fleet_burn(replay, runner.slo)
        for t, n in burn.items():
            if n > runner.admission.slo_burn_by_tenant.get(t, 0):
                runner.admission.slo_burn_by_tenant[t] = n
        # windowed counterpart: feed peer-committed breaches into the
        # burn monitor WITH their commit stamps, so fleet-observed
        # burn decays out of the alert windows like local burn does
        # (getattr: bare stub runners in tests have no monitor)
        note = getattr(runner, "note_fleet_burn", None)
        if callable(note):
            note(replay)
        for i, entry in enumerate(plan):
            if entry["action"] in ("skip", "reject"):
                results[i] = runner._resolve_nonrun(entry, i)
        pending = {i for i, e in enumerate(plan)
                   if e["action"] == "run"}
        #: failures visible at PLAN time are a previous process's —
        #: re-runnable, exactly like the serial restart path (a
        #: failure during THIS drain is terminal for the run).  Each
        #: worker retries a stale failure at most once (``attempted``).
        stale_failed = set(replay.failed) if replay is not None \
            else set()
        attempted: set = set()
        poll = min(0.25, self.ttl / 5)
        #: liveness backstop: a healthy fleet ALWAYS advances the
        #: journal within half a TTL (renewals if nothing else), and a
        #: waiting worker's own reaps advance it too — so a static
        #: last_seq with jobs still pending means every append path is
        #: dead (disk full, permissions): fail LOUDLY instead of
        #: spinning forever
        stall_budget = self.drain_stall_budget
        last_seq_seen = -1
        last_advance = time.monotonic()
        while pending:
            try:
                st = self.journal.read_state()
            except Exception as exc:
                logger.warning("fleet drain replay failed (%s: %s)",
                               type(exc).__name__, exc)
                time.sleep(poll)
                continue
            if st.last_seq != last_seq_seen:
                last_seq_seen = st.last_seq
                last_advance = time.monotonic()
            elif time.monotonic() - last_advance > stall_budget:
                raise RuntimeError(
                    f"fleet drain stalled: {len(pending)} job(s) "
                    f"pending but the journal at {self.journal.root} "
                    f"has not advanced past seq {st.last_seq} for "
                    f"{stall_budget:.0f}s — every append path "
                    f"(claims, renewals, reaps; "
                    f"{int(self.registry.value('fleet/journal_write_failed'))}"
                    f" failed write(s) so far) appears dead.  Check "
                    f"disk space/permissions on the journal volume")
            self.reap_expired(st)
            progressed = False
            for i in sorted(pending):
                entry = plan[i]
                key = entry["key"]
                rec = st.committed.get(key)
                if rec is not None:
                    # terminal ONLY if the recorded outputs verify —
                    # a stale commit whose files drifted or vanished
                    # is exactly what the plan-time verify re-runs in
                    # serial mode, and fleet mode must too (otherwise
                    # corruption is reported as success forever)
                    if runner.journal.verify_outputs(
                            rec, mode=runner.verify_mode):
                        results[i] = \
                            runner._resolve_completed_elsewhere(
                                entry, i, rec)
                        pending.discard(i)
                        progressed = True
                        continue
                    logger.warning(
                        "job %s: journal commit exists but its "
                        "outputs no longer verify — re-claiming to "
                        "re-run", entry["job_id"])
                if key in st.failed and (key not in stale_failed
                                         or key in attempted):
                    results[i] = runner._resolve_failed_elsewhere(
                        entry, i, st.failed[key])
                    pending.discard(i)
                    progressed = True
                    continue
                if not self.try_claim(
                        key, entry["job_id"], st=st,
                        reclaim_stale_failed=(key in stale_failed
                                              and key not in attempted)):
                    continue
                attempted.add(key)
                res = runner._run_claimed_entry(entry, i, window_t0,
                                                recovery_info)
                self.release(key)
                results[i] = res
                pending.discard(i)
                progressed = True
                break           # a whole job ran: the round's view is
                # stale — re-replay before touching the rest
            if pending and not progressed:
                # nothing claimable this round: peers hold every
                # remaining lease.  Tick (renewals are vacuous here,
                # but the reap scan inside is how their deaths are
                # noticed) and wait.
                runner.telemetry_tick()
                time.sleep(poll)
        return [results[i] for i in range(len(plan))]
