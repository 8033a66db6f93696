"""Health/readiness snapshot of a serve runner.

Copy of ``sam2consensus_tpu/serve/health.py`` (pinned by
``tests/test_torch_copies.py``); the memory plane and the atomic writer
are the port's.  The sections of runner parts the port does not run yet
(cohorts, the mesh) are absent from its snapshots, as the reference's
are when those are off; the ``batch``, ``count_cache``, ``lease`` (fleet
mode) and ``sessions`` sections are filled.

One JSON-shaped answer to "is this server alive and where is it?" —
the thing an external prober, a fleet scheduler, or a human with a
wedged queue actually needs, assembled from state the runner already
keeps:

* queue depth and the in-flight job (id + how long it has been
  running);
* last-heartbeat age — the newest of job-start / dispatch-interval /
  job-end timestamps; a growing age with an in-flight job is the
  wedged-dispatch signature the watchdog acts on;
* per-tenant ladder rungs (admission control's isolation state);
* journal position (last seq, committed/inflight counts) when a
  journal is attached;
* lifetime job counts and the admission counters.

Exposure: ``s2c serve --health-out PATH`` rewrites the snapshot
atomically (tmp + ``os.replace``, so a reader never sees a torn file)
at queue start, after every job, and at queue end; the same snapshot
is embedded in each job's manifest ``serve`` section via the
``serve/health`` gauge.  Schema ``s2c-health/1``; consumers must
tolerate added keys.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

SCHEMA = "s2c-health/1"


@dataclass
class HealthState:
    """The runner-side mutable state snapshots are cut from.

    ``beat()`` timestamps use ``time.monotonic`` (ages must survive
    wall-clock jumps); ``started_unix`` is wall-clock for humans."""

    started_unix: float = field(default_factory=time.time)
    _started_mono: float = field(default_factory=time.monotonic)
    queue_depth: int = 0
    in_flight: Optional[str] = None
    in_flight_since: Optional[float] = None     # monotonic
    last_beat: float = field(default_factory=time.monotonic)

    def beat(self) -> None:
        self.last_beat = time.monotonic()

    def job_started(self, job_id: str) -> None:
        self.in_flight = job_id
        self.in_flight_since = time.monotonic()
        self.beat()

    def job_finished(self) -> None:
        self.in_flight = None
        self.in_flight_since = None
        self.beat()


def snapshot(runner) -> dict:
    """Cut a health snapshot from a :class:`~.runner.ServeRunner`."""
    h = runner.health
    now = time.monotonic()
    reg = runner.registry
    # single read before the None test: telemetry HTTP threads cut
    # snapshots concurrently with the main thread's job_finished()
    # clearing the field — a check-then-read pair would 500 a scrape
    # that races a job boundary
    since = h.in_flight_since
    snap = {
        "schema": SCHEMA,
        "created_unix": round(time.time(), 3),
        "uptime_sec": round(now - h._started_mono, 3),
        "queue_depth": h.queue_depth,
        "in_flight": h.in_flight,
        "in_flight_sec": round(now - since, 3)
        if since is not None else None,
        "last_heartbeat_age_sec": round(now - h.last_beat, 3),
        "jobs": {
            "run": int(reg.value("serve/jobs")),
            "failed": int(reg.value("serve/jobs_failed")),
            "resumed_skipped": int(reg.value("serve/resume_skipped")),
            "watchdog_timeouts": int(reg.value("serve/watchdog_timeouts")),
            "retries": int(reg.value("serve/job_retries")),
        },
        "admission": {
            "admitted": int(reg.value("serve/admission_admitted")),
            "rejected": int(reg.value("serve/admission_rejected")),
            "pinned": int(reg.value("serve/admission_pinned")),
            # poison submissions (DATA class: blown bad-record budgets);
            # counted per tenant WITHOUT device-rung demotion
            "poison": int(reg.value("serve/admission_poison")),
            # capacity sheds: predicted peak > --mem-budget
            # (observability/memplane.py) — queued-not-OOMed
            "capacity": int(reg.value("serve/admission_capacity")),
        },
        # tolerant decode across the queue + the last job's verdict
        # (per-job history rides each JobResult / job manifest)
        "bad_records": int(reg.value("serve/bad_records")),
        "last_job": getattr(runner, "last_job_badrec", None),
        "poison_by_tenant": dict(runner.admission.poison_by_tenant),
        "tenant_rungs": dict(runner.admission.tenant_rungs),
        "journal": runner.journal.position()
        if runner.journal is not None else None,
    }
    # fleet mode (serve/fleet.py): which worker this snapshot belongs
    # to, plus its lease book — held leases with renewal ages, the
    # reap/steal tallies.  tools/s2c_top.py --fleet merges N of these
    # into one view; a lease whose last_renew_age_sec approaches the
    # TTL is the about-to-be-reaped signature.
    if getattr(runner, "worker_id", ""):
        snap["worker_id"] = runner.worker_id
        fl = getattr(runner, "fleet", None)
        if fl is not None:
            snap["lease"] = fl.lease_summary()
    # fleet telemetry (observability/telemetry.py): the SLO burn and
    # the telemetry plane's own health, so a prober without a
    # Prometheus stack still sees objective breaches
    # continuous batching (serve/scheduler.py): current policy + the
    # last batch's shape, so an operator (or tools/s2c_top.py) sees the
    # packing state without a Prometheus stack
    sched = getattr(runner, "scheduler", None)
    if sched is not None and sched.enabled:
        g = reg.snapshot()["gauges"]
        snap["batch"] = {
            "mode": sched.mode,
            "max_jobs": sched.max_jobs,
            "window_ms": sched.window_ms,
            "batches": int(reg.value("batch/batches")),
            "packed_jobs": int(reg.value("batch/packed_jobs")),
            "demotions": int(reg.value("batch/demotions")),
            "last_size": int(g.get("batch/size", {}).get("value", 0)),
            "last_occupancy_pct": g.get("batch/occupancy_pct",
                                        {}).get("value", 0.0),
            "last_jobs_per_sec": g.get("batch/jobs_per_sec",
                                       {}).get("value", 0.0),
        }
    # flight recorder (observability/flight.py): journal-measured
    # scheduler telemetry — queue-wait / claim / steal summaries per
    # tenant ride the s2c_sched_* exposition; here the prober-visible
    # synopsis (occupancy, churn, last lifecycle) plus the telemetry
    # interval s2c_top --fleet uses to age-flag stale workers
    reg_snap = reg.snapshot()
    sched_hists = {name: entry for name, entry
                   in reg_snap["histograms"].items()
                   if name.startswith("sched/")}
    churn = reg.value("sched/lease_churn")
    occ = reg_snap["gauges"].get("sched/occupancy_ratio",
                                 {}).get("value", 0.0)
    snap["sched"] = {
        "telemetry_interval_sec": getattr(
            runner, "telemetry_interval", None),
        "occupancy_ratio": occ,
        "lease_churn": int(churn),
        "queue_wait": {
            name.split("/", 2)[1] or "default": {
                "count": entry["count"],
                "p50_sec": round(entry["p50"], 4),
                "p95_sec": round(entry["p95"], 4)}
            for name, entry in sorted(sched_hists.items())
            if name.endswith("/queue_wait")},
        "steals_measured": {
            name.split("/", 2)[1] or "default": {
                "count": entry["count"],
                "max_sec": round(entry["max"], 3)}
            for name, entry in sorted(sched_hists.items())
            if name.endswith("/steal_latency")},
    }
    # incremental consensus (serve/countcache.py): the per-reference
    # count cache's residency + hit/evict story, mirrored from the
    # s2c_cache_* exposition family for probers without a scraper
    cc = getattr(runner, "count_cache", None)
    if cc is not None:
        snap["count_cache"] = cc.stats()
    # streaming sessions (serve/session.py): open sessions, wave
    # absorb/reject tallies, stability verdicts and last-wave ages —
    # the prober's view of the live-ingest plane.  A session whose
    # last_wave_age_sec keeps growing while open is a stalled
    # basecaller, not a stalled server (the ingest endpoint answers
    # per request; nothing here blocks)
    smgr = getattr(runner, "sessions", None)
    if smgr is not None:
        snap["sessions"] = smgr.health_summary()
    # cohort serving (serve/cohort.py): manifest progress — waves
    # done/estimated, samples done/total, last wave's rate + occupancy
    # — the prober's (and s2c_top's) view of a streaming cohort.
    # Guarded like every optional section: a cohort mid-teardown must
    # never 500 a health scrape
    cohort = getattr(runner, "cohort", None)
    if cohort is not None:
        try:
            snap["cohort"] = cohort.health_summary()
        except Exception:
            pass
    slo_obj = getattr(runner, "slo", None)
    if slo_obj or reg.value("slo/violations"):
        # windowed burn read when the runner attached a monitor: a
        # breach that aged out of the slow window stops reading as
        # "burning" here (the lifetime dict never decayed)
        slo_burn = getattr(runner.admission, "slo_burn", None)
        snap["slo"] = {
            "objectives": dict(slo_obj or {}),
            "violations": int(reg.value("slo/violations")),
            "burn_by_tenant": dict(slo_burn()) if callable(slo_burn)
            else dict(getattr(
                runner.admission, "slo_burn_by_tenant", {})),
        }
    # burn-alert plane (observability/burn.py): per-tenant ok/warn/
    # page with the fast/slow window ratios behind the verdict — only
    # present once any job was scored against an objective
    burn = getattr(runner, "burn", None)
    if burn is not None:
        bsnap = burn.snapshot()
        if bsnap.get("tenants"):
            snap["burn"] = bsnap
    # rate-card plane (observability/ratecard.py): this worker's
    # learned throughput constants + confidence verdicts, and the
    # latest evidence-only fleet scale hint when one was computed
    card = getattr(runner, "ratecard", None)
    if card is not None:
        csnap = card.snapshot()
        if csnap.get("rates") or csnap.get("restarts"):
            snap["ratecard"] = csnap
    hint = getattr(runner, "last_scale_hint", None)
    if hint is not None:
        snap["scale_hint"] = dict(hint)
    # memory plane (observability/memplane.py): per-family live/peak +
    # process/device watermarks, so a prober (or tools/s2c_top.py)
    # sees residency without a Prometheus stack; the OOM-forensics
    # tally rides along when any dump was written
    from ..observability import memplane

    snap["memory"] = memplane.summary()
    # mesh plane (parallel/partition.py): topology of the active
    # sharded mesh + the admission-time capacity plan — only present
    # once a sharded accumulator ran or a mesh_shards verdict fired,
    # so single-host servers keep their old snapshot shape
    g = reg_snap["gauges"]
    if ("mesh/shards" in g or "mesh/planned_hosts" in g
            or runner.admission.mesh_hosts):
        shard_bytes = {
            name.rsplit("/", 1)[1]: int(value)
            for name, value in reg_snap["counters"].items()
            if name.startswith("mesh/shard_bytes/")}
        snap["mesh"] = {
            "hosts": int(g.get("mesh/hosts", {}).get("value", 1)),
            "shards": int(g.get("mesh/shards", {}).get("value", 0)),
            "mesh_hosts_capacity": int(runner.admission.mesh_hosts),
            "planned_hosts": int(g.get("mesh/planned_hosts",
                                       {}).get("value", 0)) or None,
            "admitted_mesh": int(reg.value("serve/admission_mesh")),
            "shard_bytes_by_host": shard_bytes,
            "gather_bytes": int(reg.value("mesh/gather_bytes")),
        }
    if runner.admission.mem_budget:
        snap["memory"]["mem_budget_mb"] = round(
            runner.admission.mem_budget / 1e6, 1)
    if reg.value("serve/oom_dumps"):
        snap["memory"]["oom_dumps"] = int(reg.value("serve/oom_dumps"))
        snap["memory"]["last_oom_dump"] = reg.info("serve/last_oom_dump")
    prof = getattr(runner, "profiler", None)
    if prof is not None and (prof.captures
                             or reg.value("telemetry/write_failed")):
        snap["telemetry"] = {
            "profile_captures": prof.captures,
            "last_profile": prof.last_path,
            "write_failed": int(reg.value("telemetry/write_failed")),
        }
    return snap


def write_health(path: str, snap: dict) -> None:
    """Atomic rewrite: a prober polling the file never reads half a
    snapshot.  Delegates to the ONE shared writer
    (:func:`~..observability.telemetry.atomic_write_text`) the
    exposition file and journal segments also use."""
    from ..observability.telemetry import atomic_write_text

    atomic_write_text(path, json.dumps(snap, indent=1,
                                       sort_keys=False) + "\n")
