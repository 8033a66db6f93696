"""Fleet telemetry plane: server-lifetime aggregation + exposition.

Copy of ``sam2consensus_tpu/observability/telemetry.py`` (pinned by
``tests/test_torch_copies.py``), with one change: the on-demand
profiler window is ``torch.profiler`` (CPU and CUDA activity) on a
CUDA server, where the reference opens ``jax.profiler`` on an
accelerator (:meth:`ProfilerCapture._try_device_window`).

Everything observability built so far is *per-job scoped* — each job
gets its own registry/trace/ledger/manifest, and the serve runner's
health snapshot is rewritten only at job boundaries.  That answers
"what did job 17 do" but not the operator questions a long-running
``s2c serve`` fleet actually gets paged on: *what is tenant X's p99
end-to-end latency this hour*, *is queue wait growing*, *is the
in-flight job making progress RIGHT NOW*.  This module is the layer
that answers them:

* :class:`AggregateRegistry` — a server-lifetime registry per-job
  registries **fold** into at job end: counters summed, gauges
  last-wins (stamped with the folding job + wall time), histograms
  merged through the existing decimating reservoir
  (:meth:`~.metrics.Histogram.merge`).  Live mid-job state (heartbeat
  age, in-flight job age) is written as gauges by the serve runner's
  watchdog tick, so a hung job is visible *while* it hangs;
* **SLO objectives** (:func:`parse_slo`) — ``e2e=5s,queue=1s`` /
  ``S2C_SLO`` over the serving phases ``queue_wait`` (alias
  ``queue``), ``decode``, ``dispatch``, ``vote``, ``e2e``.  The runner
  observes every finished job's per-phase latency into per-tenant
  histograms (``slo/<tenant>/<phase>``) and bumps the burn counters
  ``slo/violations/<tenant>/<phase>`` on breach — the counters ride
  into the health snapshot, the exposition, and each job's manifest
  ``serve.slo`` verdict;
* **OpenMetrics/Prometheus text exposition**
  (:func:`render_openmetrics`) — HELP/TYPE/label discipline over the
  aggregate snapshot, validated by :func:`lint_openmetrics` (promtool-
  style rules, incl. counter monotonicity across two scrapes).
  Written atomically on a time cadence (``--telemetry-out``) and
  served by the stdlib-only localhost endpoint
  (:class:`TelemetryServer`, ``--telemetry-port``: ``/metrics`` +
  ``/healthz`` from the same snapshot);
* **on-demand profiler capture** (:class:`ProfilerCapture`) — SIGUSR2
  or a ``capture_profile`` touch-file arms a bounded
  ``torch.profiler`` window on a CUDA server (pure-Python span/stack
  dump alone on cpu), written next to the journal, so a misbehaving
  production job can be profiled without restarting the server;
* **structured JSON logging** (:class:`JsonLogFormatter` +
  :func:`set_log_context`) — ``--log-format json``: every record
  carries job_id/tenant/rung/trace-span correlation IDs.

Failure semantics: the telemetry plane is strictly best-effort.  A
write failure degrades to the per-job manifests (counted
``telemetry/write_failed``, warned once per failure) and NEVER fails a
job — the exposition is derived state; the job's own registry/manifest
remain the durable record.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry

logger = logging.getLogger("sam2consensus_torch.observability.telemetry")

#: the serving phases SLO objectives can be set over, in pipeline
#: order.  ``queue_wait`` is submission-to-start wall time; ``decode``
#: / ``dispatch`` / ``vote`` map onto the canonical phase counters
#: (dispatch = pileup_dispatch + accumulate + stage, vote = vote +
#: insertions + render); ``e2e`` is the job's full wall clock.
SLO_PHASES = ("queue_wait", "decode", "dispatch", "vote", "e2e")

#: flag-grammar aliases -> canonical phase names
_SLO_ALIASES = {"queue": "queue_wait", "queue_wait": "queue_wait",
                "decode": "decode", "dispatch": "dispatch",
                "vote": "vote", "e2e": "e2e"}

#: default exposition rewrite cadence (seconds); S2C_TELEMETRY_INTERVAL
#: overrides.  One atomic rewrite of a few KB per tick — cheap enough
#: to ride the watchdog poll, slow enough to never matter.
DEFAULT_INTERVAL_S = 2.0

#: default bounded profiler-capture window (seconds);
#: S2C_PROFILE_CAPTURE_S overrides
DEFAULT_CAPTURE_S = 3.0

#: the touch-file name that arms a profiler capture (polled by the
#: serve runner's watchdog tick, consumed on arm)
CAPTURE_TOUCH_NAME = "capture_profile"


# =========================================================================
# SLO objectives
# =========================================================================
def parse_slo(spec: Optional[str]) -> Dict[str, float]:
    """``e2e=5s,queue=1s`` -> ``{"e2e": 5.0, "queue_wait": 1.0}``.

    Grammar: comma-separated ``<phase>=<number>[ms|s]`` (bare numbers
    are seconds).  Unknown phases and unparsable values raise
    ``ValueError`` — a typo'd objective must fail the server start,
    not silently never fire.  ``None``/empty falls back to ``S2C_SLO``
    then to no objectives at all.
    """
    raw = spec if spec else os.environ.get("S2C_SLO", "")
    out: Dict[str, float] = {}
    if not raw or not raw.strip():
        return out
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad SLO entry {part!r}: expected <phase>=<seconds>"
                f" (phases: {', '.join(sorted(set(_SLO_ALIASES)))})")
        name, _, val = part.partition("=")
        phase = _SLO_ALIASES.get(name.strip().lower())
        if phase is None:
            raise ValueError(
                f"unknown SLO phase {name.strip()!r} "
                f"(use one of: {', '.join(sorted(set(_SLO_ALIASES)))})")
        val = val.strip().lower()
        scale = 1.0
        if val.endswith("ms"):
            val, scale = val[:-2], 1e-3
        elif val.endswith("s"):
            val = val[:-1]
        try:
            sec = float(val) * scale
        except ValueError:
            raise ValueError(
                f"bad SLO value for {phase}: {part!r} "
                f"(expected e.g. {phase}=5s or {phase}=250ms)") from None
        if not sec > 0:
            raise ValueError(f"SLO objective must be > 0: {part!r}")
        out[phase] = sec
    return out


def slo_phase_seconds(counters: dict, elapsed_sec: float,
                      queue_wait_sec: float) -> Dict[str, float]:
    """Map one finished job's registry counters onto the SLO phases."""
    return {
        "queue_wait": max(0.0, queue_wait_sec),
        "decode": counters.get("phase/decode_sec", 0.0),
        "dispatch": (counters.get("phase/pileup_dispatch_sec", 0.0)
                     + counters.get("phase/accumulate_sec", 0.0)
                     + counters.get("phase/stage_sec", 0.0)),
        "vote": (counters.get("phase/vote_sec", 0.0)
                 + counters.get("phase/insertions_sec", 0.0)
                 + counters.get("phase/render_sec", 0.0)),
        "e2e": max(0.0, elapsed_sec),
    }


# =========================================================================
# Server-lifetime aggregation
# =========================================================================
class AggregateRegistry(MetricsRegistry):
    """A server-lifetime registry per-job registries fold into.

    Subclasses :class:`MetricsRegistry` so every existing reader (the
    health snapshot, ``registry.value``, the manifest) keeps working;
    adds :meth:`fold`, the job-end merge:

    * counters sum — EXCEPT the ``serve/`` and ``slo/`` families,
      which the runner owns at server scope already (folding its own
      mirrors back in would double-count every retry/overlap second);
    * gauges last-wins, info payload stamped with the folding job id
      and wall time so "whose value is this" survives aggregation;
    * histograms merge exactly on count/sum/min/max and fold their
      decimating reservoirs (:meth:`~.metrics.Histogram.merge`), so
      fleet-level percentiles stay meaningful.
    """

    #: counter families the serve runner already records at server
    #: scope — folding a job's copies would double-count
    # cache/: the count cache bills the server registry DIRECTLY
    # (serve/countcache.py gets/puts pass it) while each incremental
    # job's registry carries its own cache/{hits,misses} copy for the
    # per-job manifest — folding that copy would double-count the
    # server-lifetime family
    # mem/: the memory plane's per-registry PEAK ratchets are maxima,
    # not flows — summing per-job peaks would report jobs_folded x the
    # real footprint.  The watchdog-tick sampler
    # (observability/memplane.sample) publishes the server-lifetime
    # mem/* family into this registry directly instead.
    # fleet/: the claim/lease counters are runner-owned coordination
    # state (serve/fleet.py records them straight into the server
    # registry); a job registry carrying a copy would double-count
    # sched/: the flight recorder's scheduler telemetry (queue-wait /
    # claim / steal distributions, lease churn, occupancy) is likewise
    # runner-owned — derived from journal wall times at finalize, not
    # from anything a job's own registry could know.  The one sched/
    # name a JOB registry carries (the sched/trace info gauge stamping
    # trace_id into the metrics artifact) must not leak into the
    # server aggregate either: the last-folded job would overwrite it.
    # rate/ + burn/ + process/: the learned rate card, the windowed
    # burn plane and the start-time gauge are likewise runner-owned —
    # folded-in job registries never carry them, and a job that DID
    # (a test fixture, a future leak) must not overwrite the server's
    # card state or alerting state
    FOLD_SKIP_PREFIXES = ("serve/", "slo/", "telemetry/", "cache/",
                          "mem/", "fleet/", "sched/", "rate/",
                          "burn/", "process/")

    def fold(self, registry: MetricsRegistry, job_id: str = "",
             tenant: str = "") -> None:
        snap = registry.snapshot()
        now = round(time.time(), 3)
        for name, value in snap["counters"].items():
            if name.startswith(self.FOLD_SKIP_PREFIXES):
                continue
            self.add(name, value)
        for name, entry in snap["gauges"].items():
            if name.startswith(self.FOLD_SKIP_PREFIXES):
                continue
            g = self.gauge(name)
            g.set(entry["value"])
            info = dict(entry.get("info") or {})
            info["folded_from"] = job_id
            if tenant:
                info["tenant"] = tenant
            info["updated_unix"] = now
            g.set_info(info)
        # merge the actual reservoirs, not the snapshot summaries —
        # count/sum/min/max merge exactly, percentiles approximately
        # (the documented decimating-reservoir contract).  The name
        # list is copied under the SOURCE registry's lock: an
        # abandoned watchdog worker may still be recording into its
        # job's registry when the runner folds it, and an unlocked
        # dict iteration would crash the fold ("dictionary changed
        # size") — losing exactly the timed-out job's numbers
        with registry._lock:
            hist_items = list(registry._hists.items())
        for name, hist in hist_items:
            if name.startswith(self.FOLD_SKIP_PREFIXES):
                continue
            with self._lock:
                mine = self._hists.get(name)
                if mine is None:
                    from .metrics import Histogram

                    mine = self._hists[name] = Histogram()
                mine.merge(hist)
        self.add("telemetry/jobs_folded", 1)


# =========================================================================
# Atomic file writer (shared with serve/health.py)
# =========================================================================
def atomic_write_text(path: str, text: str) -> None:
    """tmp + fsync + ``os.replace``: a reader polling ``path`` never
    sees a torn file.  The ONE writer discipline behind the health
    snapshot, the exposition file, and the journal segments."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


# =========================================================================
# OpenMetrics / Prometheus text exposition
# =========================================================================
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: HELP strings for the families an operator will actually grep for;
#: everything else gets a generic registry-metric line
_HELP = {
    "s2c_phase_seconds_total": "Cumulative seconds per pipeline phase "
                               "across all folded jobs.",
    "s2c_slo_phase_seconds": "Per-tenant per-phase job latency "
                             "(merged decimating reservoir).",
    "s2c_slo_violations_total": "Jobs that breached the configured "
                                "latency objective, per tenant/phase.",
    "s2c_serve_jobs_total": "Jobs run by this server (lifetime).",
    "s2c_serve_jobs_failed_total": "Jobs that failed (lifetime).",
    "s2c_serve_heartbeat_age_sec": "Seconds since the last dispatch "
                                   "heartbeat (grows while a job "
                                   "hangs).",
    "s2c_serve_inflight_age_sec": "Age of the in-flight job (0 when "
                                  "idle).",
    "s2c_serve_queue_depth": "Jobs admitted and not yet finished.",
    "s2c_serve_up": "1 while the serve runner is alive.",
    "s2c_serve_uptime_sec": "Server lifetime in seconds.",
    "s2c_telemetry_profile_captures_total": "On-demand profiler "
                                            "captures taken.",
    "s2c_telemetry_jobs_folded_total": "Per-job registries folded into "
                                       "this server-lifetime "
                                       "aggregate.",
    "s2c_telemetry_write_failed_total": "Exposition/health writes that "
                                        "failed (telemetry degrades, "
                                        "jobs never fail).",
    # continuous batching (serve/scheduler.py): the s2c_batch_* family
    "s2c_batch_batches_total": "Packed batches executed (continuous "
                               "batching, --batch).",
    "s2c_batch_packed_jobs_total": "Jobs that rode a packed batch's "
                                   "shared dispatch.",
    "s2c_batch_demotions_total": "Batches demoted whole to the serial "
                                 "path (fault inside a packed phase).",
    "s2c_batch_tail_demotions_total": "Shared-tail failures demoted to "
                                      "per-member extraction tails.",
    "s2c_batch_pack_sec_total": "Cumulative non-dispatch shared-phase "
                                "seconds (merge/extract/fetch).",
    "s2c_batch_size": "Members in the most recent packed batch.",
    "s2c_batch_occupancy_pct": "Real rows / padded rows of the last "
                               "batch's merged slabs, percent.",
    "s2c_batch_jobs_per_sec": "Last batch's shared-phase throughput "
                              "(members / shared wall).",
    # cohort serving (serve/cohort.py): the s2c_cohort_* family —
    # manifest-streamed shared-panel waves
    "s2c_cohort_waves_done": "Cohort waves fully finalized (journal "
                             "cohort_wave markers written).",
    "s2c_cohort_waves_total": "Estimated total waves (done + remaining "
                              "at the last wave's size).",
    "s2c_cohort_samples_done": "Cohort members finished or resumed "
                               "from the journal.",
    "s2c_cohort_samples_total": "Members the manifest resolved to.",
    "s2c_cohort_jobs_per_sec": "Last wave's measured throughput "
                               "(ok members / wave wall).",
    "s2c_cohort_occupancy_pct": "Packed-slab occupancy of the last "
                                "wave's batch, percent.",
    "s2c_cohort_wave_wall_sec_total": "Cumulative wave wall seconds "
                                      "(cohort_wave decisions' "
                                      "measured denominator).",
    "s2c_cohort_wave_jobs_total": "Members that finished OK inside a "
                                  "packed cohort wave.",
    "s2c_cohort_resumed_skipped_total": "Members skipped at cohort "
                                        "start (journal-committed "
                                        "with verified outputs).",
    "s2c_cohort_prefetch_failed_total": "Wave-ahead header probes that "
                                        "failed (the wave re-probes "
                                        "inline).",
    "s2c_cohort_admission_trips_total": "Wave sizes rejected by "
                                        "admission and halved before "
                                        "dispatch.",
    "s2c_cohort_concordance_oracle_members_total":
        "Serially-run members back-filled into the concordance table "
        "via the CPU oracle accumulation.",
    "s2c_cohort_concordance_skipped_total":
        "Members whose counts reached neither the tap nor the oracle "
        "(absent from the concordance table).",
    # incremental consensus (serve/countcache.py): the s2c_cache_*
    # family — per-reference device-resident count cache
    "s2c_cache_entries": "References with warm count state resident "
                         "in the serve count cache.",
    "s2c_cache_resident_bytes": "Bytes of count+insertion state the "
                                "cache holds (LRU under "
                                "--count-cache).",
    "s2c_cache_hits_total": "Incremental jobs seeded from a warm "
                            "reference (paid only delta decode + "
                            "scatter + re-vote).",
    "s2c_cache_misses_total": "Incremental jobs that absorbed their "
                              "input cold (no warm entry).",
    "s2c_cache_evictions_total": "Entries evicted by the LRU byte "
                                 "budget.",
    "s2c_cache_evicted_bytes_total": "Bytes of warm count state "
                                     "evicted under the LRU budget "
                                     "(the silent-pressure signal: a "
                                     "growing rate means the budget "
                                     "is churning).",
    "s2c_cache_invalidated_total": "Entries dropped whole after a "
                                   "seeded job failed (the count-bank "
                                   "rule).",
    "s2c_cache_inserts_total": "Entries (re-)inserted at job commit.",
    # device-resident epilogue (ops/fused.py): where the render
    # epilogue ran per tail
    "s2c_epilogue_device_tails_total": "Tails whose fill substitution "
                                       "+ dash counts ran on device "
                                       "(fetched bytes are final "
                                       "FASTA).",
    "s2c_epilogue_host_tails_total": "Tails whose render epilogue ran "
                                     "host-side (sharded/native/"
                                     "unrepresentable fill).",
    # memory plane (observability/memplane.py): the s2c_mem_* family
    "s2c_mem_live_bytes": "Live tracked bytes per allocation family "
                          "(counts/staging/caches/... — see "
                          "observability/memplane.py).",
    "s2c_mem_peak_bytes": "Peak tracked bytes per allocation family "
                          "since this registry started.",
    "s2c_mem_live_tracked_bytes": "Live tracked bytes across all "
                                  "allocation families.",
    "s2c_mem_peak_tracked_bytes_total": "Peak-tracked-bytes ratchet "
                                        "(monotone; the capacity "
                                        "ledger decision's measured "
                                        "side).",
    "s2c_mem_rss_mb": "Process resident set size, MB (watermark "
                      "sampler on the watchdog/telemetry tick).",
    "s2c_mem_peak_rss_mb": "Process peak RSS, MB (ru_maxrss).",
    "s2c_mem_device_bytes_in_use": "Device bytes in use where the "
                                   "backend exposes memory_stats() "
                                   "(absent on CPU).",
    "s2c_mem_device_peak_bytes": "Device peak bytes in use where "
                                 "exposed.",
    "s2c_mem_oom_dumps_total": "CAPACITY-class failures that wrote a "
                               "mem_dump.json forensic record.",
    "s2c_serve_admission_capacity_total": "Jobs shed because their "
                                          "predicted peak exceeded "
                                          "--mem-budget (queued-not-"
                                          "OOMed).",
    "s2c_serve_admission_mesh_total": "Over-budget jobs admitted with "
                                      "a capacity-planned 'needs K "
                                      "hosts' mesh_shards verdict "
                                      "instead of being shed.",
    # mesh plane (parallel/partition.py): the s2c_mesh_* family —
    # topology + shard/gather traffic of the sharded count tensor
    "s2c_mesh_hosts": "Distinct processes owning the active mesh's "
                      "devices (1 on any single-controller mesh).",
    "s2c_mesh_shards": "Device count of the active ('dp','sp') mesh "
                       "(the count tensor's position shard count).",
    "s2c_mesh_planned_hosts": "Host count the admission-time "
                              "mesh_shards capacity plan chose for "
                              "the most recent over-budget job.",
    "s2c_mesh_shard_bytes_total": "Bytes THIS process shipped to its "
                                  "own devices' shards on a process-"
                                  "spanning mesh (host label = "
                                  "process index; counts never ride "
                                  "DCN on the way in).",
    "s2c_mesh_gather_bytes_total": "Bytes landed on this host by "
                                   "cross-process gathers "
                                   "(process_allgather tails: vote "
                                   "symbols and stats, never raw "
                                   "counts).",
    "s2c_serve_oom_dumps_total": "Serve jobs whose CAPACITY failure "
                                 "wrote a mem_dump.json next to the "
                                 "journal.",
    # fleet mode (serve/fleet.py): the s2c_fleet_* family — every
    # sample additionally carries a worker="<id>" label so
    # tools/s2c_top.py --fleet can merge N workers' expositions
    "s2c_fleet_claims_total": "Job leases this worker won (fleet "
                              "work-stealing over the shared "
                              "journal).",
    "s2c_fleet_claim_lost_total": "Claim races this worker lost to a "
                                  "peer (it moved on; the peer runs "
                                  "the job).",
    "s2c_fleet_steals_total": "Expired peer leases this worker reaped "
                              "AND re-claimed (dead/frozen worker's "
                              "job resumed from its checkpoint).",
    "s2c_fleet_lease_renewals_total": "Lease TTL renewals on the "
                                      "watchdog tick.",
    "s2c_fleet_lease_reaped_total": "Peer leases this worker marked "
                                    "expired (lease_expired events "
                                    "appended).",
    "s2c_fleet_lease_lost_total": "Jobs this worker finished but "
                                  "could NOT commit: its lease had "
                                  "been reaped mid-run (result "
                                  "abandoned, the thief commits).",
    "s2c_fleet_completed_elsewhere_total": "Queue entries resolved by "
                                           "a peer's journal commit "
                                           "(this worker never "
                                           "decoded a byte).",
    "s2c_fleet_failed_elsewhere_total": "Queue entries a peer "
                                        "journaled as failed "
                                        "(terminal, like a local "
                                        "failure).",
    "s2c_fleet_journal_write_failed_total": "Fleet journal appends "
                                            "that failed (an "
                                            "unjournaled claim is "
                                            "simply not held).",
    "s2c_fleet_leases_held": "Leases this worker currently holds.",
    # flight recorder (observability/flight.py): journal-measured
    # scheduler telemetry — the s2c_sched_* family
    "s2c_sched_seconds": "Journal-measured scheduler latency summary "
                         "per tenant: kind=queue_wait (submitted -> "
                         "started wall time, the SLO plane's "
                         "queue-wait truth source), kind="
                         "claim_latency (submitted -> this worker won "
                         "the lease), kind=steal_latency (victim's "
                         "last lease sign of life -> winning "
                         "re-claim; bounded by ~2x lease TTL).",
    "s2c_sched_lease_churn_total": "Lease-lifecycle turnover this "
                                   "worker observed: reaps it "
                                   "appended, claim races it lost, "
                                   "leases it lost mid-run. High "
                                   "churn with low steals means "
                                   "contention, not failure "
                                   "recovery.",
    "s2c_sched_occupancy_ratio": "Fraction of this worker's serve "
                                 "uptime spent running jobs "
                                 "(busy-seconds / uptime; the "
                                 "flight recorder's per-worker "
                                 "occupancy lane, live).",
    # streaming sessions (serve/session.py + serve/stream_server.py):
    # the s2c_session_* / s2c_ingest_* families — the live-ingest plane
    "s2c_session_opened_total": "Streaming sessions opened (lifetime).",
    "s2c_session_closed_total": "Streaming sessions closed cleanly "
                                "(final outputs written).",
    "s2c_session_waves_total": "Read waves journaled as received "
                               "(durable intent precedes the ACK).",
    "s2c_session_waves_absorbed_total": "Waves absorbed exactly once "
                                        "into session count state "
                                        "(wave_absorbed journaled, "
                                        "lease-fenced).",
    "s2c_session_waves_rejected_total": "Waves rejected DATA-class "
                                        "(malformed/poison/sha "
                                        "mismatch; quarantined, never "
                                        "retried).",
    "s2c_session_waves_shed_total": "Waves shed by admission "
                                    "backpressure (429 + Retry-After; "
                                    "pending backlog at its bound).",
    "s2c_session_torn_waves_total": "Spooled wave bodies whose hash no "
                                    "longer matched the journaled "
                                    "intent (re-requested, never "
                                    "absorbed).",
    "s2c_session_revotes_total": "Consensus re-votes over already-"
                                 "absorbed counts (zero re-ingest).",
    "s2c_session_stability_events_total": "Sessions whose consensus "
                                          "digest survived N "
                                          "consecutive waves unchanged "
                                          "(the read-until verdict).",
    "s2c_session_steals_total": "Orphaned sessions this worker stole "
                                "lease-and-all from a dead/frozen "
                                "peer (journaled waves replayed; "
                                "zero lost, zero double-counted).",
    "s2c_session_recovered_total": "Sessions rebuilt from journal "
                                   "replay (restart resume + fleet "
                                   "steals).",
    "s2c_session_reads_absorbed_total": "Reads absorbed across all "
                                        "sessions (lifetime).",
    "s2c_session_open": "Streaming sessions currently open on this "
                        "worker.",
    "s2c_session_pending_waves": "Journaled-but-unabsorbed waves "
                                 "across open sessions (the "
                                 "backpressure gauge).",
    "s2c_ingest_requests_total": "HTTP requests the ingest endpoint "
                                 "answered (lifetime).",
    "s2c_ingest_rejected_total": "Ingest requests rejected with a "
                                 "typed status (+ per-reason "
                                 "children).",
    "s2c_ingest_bytes_total": "Wave/header body bytes the ingest "
                              "endpoint accepted.",
    "s2c_ingest_slow_clients_total": "Requests killed by the "
                                     "per-request socket deadline "
                                     "(408; the handler thread is "
                                     "freed, never wedged).",
    # -- rate cards / burn alerts / scale hints ------------------------
    "s2c_rate": "Learned rate-card EWMA mean per rate key "
                "(observability/ratecard.py; served to decision "
                "sites only past the min-sample + staleness gates).",
    "s2c_rate_stddev": "Rate-card exponentially-weighted standard "
                       "deviation per rate key.",
    "s2c_rate_samples": "Rate-card observation count per rate key "
                        "(below the min-sample gate the key is not "
                        "served).",
    "s2c_rate_age_seconds": "Seconds since the rate key's last "
                            "observation (past S2C_LINK_CACHE_MAX_AGE "
                            "the key reads as stale and is not "
                            "served).",
    "s2c_rate_card": "Rate-card restart epoch (successful reloads of "
                     "the persisted card; the restart_epoch label's "
                     "source).",
    "s2c_rate_card_corrupt_total": "Persisted rate-card files that "
                                   "failed to parse and were read as "
                                   "absent (never fails a job).",
    "s2c_burn_rate": "Windowed SLO burn rate per tenant "
                     "(violated/evaluated objectives over the "
                     "trailing window; window=fast|slow).",
    "s2c_burn_alert_state": "Burn alert state per tenant "
                            "(0=ok 1=warn 2=page; hysteresis in "
                            "observability/burn.py).",
    "s2c_fleet_scale_hint": "Evidence-only fleet sizing hint: worker "
                            "delta (sign is the verdict — positive "
                            "scale-up, negative scale-down, 0 hold). "
                            "No actuation.",
    "s2c_process_start_time_seconds": "Unix time the serve process "
                                      "started (the OpenMetrics "
                                      "counter-reset detection "
                                      "convention).",
}


def _sanitize(name: str) -> str:
    out = "s2c_" + _SANITIZE_RE.sub("_", name)
    if not _NAME_RE.match(out):            # leading digit after prefix
        out = "s2c_" + _SANITIZE_RE.sub("_", "_" + name)
    return out


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return ("{" + ",".join(f'{k}="{_escape_label(v)}"'
                           for k, v in pairs) + "}")


class _Family:
    __slots__ = ("name", "ftype", "samples")

    def __init__(self, name: str, ftype: str):
        self.name = name
        self.ftype = ftype
        self.samples: List[Tuple[str, List[Tuple[str, str]], float]] = []

    def add(self, suffix: str, labels, value) -> None:
        self.samples.append((self.name + suffix, list(labels),
                             float(value)))


def render_openmetrics(snapshot: dict,
                       worker: Optional[str] = None,
                       restart_epoch: Optional[int] = None) -> str:
    """Registry snapshot -> Prometheus/OpenMetrics text exposition.

    Structured families get proper labels instead of path-encoded
    names: ``phase/<p>_sec`` counters -> ``s2c_phase_seconds_total
    {phase=...}``, ``slo/<tenant>/<phase>`` histograms ->
    ``s2c_slo_phase_seconds{tenant=,phase=,quantile=}`` summaries,
    ``slo/violations/<tenant>/<phase>`` ->
    ``s2c_slo_violations_total{tenant=,phase=}``.  Everything else is
    rendered flat under a sanitized ``s2c_`` name (counters suffixed
    ``_total``).  Output is sorted and deterministic; ends with
    ``# EOF``.

    ``worker`` (fleet mode, ``--worker-id``) stamps EVERY sample with
    a trailing ``worker="<id>"`` label, so N workers' expositions
    merge into one fleet view (``tools/s2c_top.py --fleet``, or any
    Prometheus scraping all of them) without sample collisions.
    ``restart_epoch`` (the rate card's reload count) rides along as a
    ``restart_epoch`` label: across a worker restart the labelset
    changes, so a scraper's monotonicity check sees a NEW series
    instead of a counter going backwards — counter resets become
    detectable instead of lint violations.
    """
    fams: Dict[str, _Family] = {}

    def fam(name: str, ftype: str) -> _Family:
        f = fams.get(name)
        if f is None:
            f = fams[name] = _Family(name, ftype)
        return f

    for name, value in snapshot.get("counters", {}).items():
        m = re.match(r"^phase/(.+)_sec$", name)
        if m:
            fam("s2c_phase_seconds_total", "counter").add(
                "", [("phase", m.group(1))], value)
            continue
        m = re.match(r"^slo/violations/([^/]*)/([^/]+)$", name)
        if m:
            fam("s2c_slo_violations_total", "counter").add(
                "", [("tenant", m.group(1) or "default"),
                     ("phase", m.group(2))], value)
            continue
        m = re.match(r"^mesh/shard_bytes/(\d+)$", name)
        if m:
            # per-host shard traffic: one labeled series per process
            # index instead of a sanitized name per host
            fam("s2c_mesh_shard_bytes_total", "counter").add(
                "", [("host", m.group(1))], value)
            continue
        n = _sanitize(name)
        if not n.endswith("_total"):
            n += "_total"
        fam(n, "counter").add("", [], value)
    for name, entry in snapshot.get("gauges", {}).items():
        # info payloads are manifest material, not exposition material;
        # only the scalar value ships
        m = re.match(r"^mem/(live|peak)_bytes/(.+)$", name)
        if m:
            # per-family residency gauges get a proper family label
            # instead of one sanitized series per allocation family
            fam(f"s2c_mem_{m.group(1)}_bytes", "gauge").add(
                "", [("family", m.group(2))], entry["value"])
            continue
        m = re.match(r"^rate/(mean|stddev|samples|age_seconds)/(.+)$",
                     name)
        if m:
            # rate-card estimators: one labeled family per statistic
            # instead of a sanitized series per rate key
            suffix = "" if m.group(1) == "mean" else f"_{m.group(1)}"
            fam(f"s2c_rate{suffix}", "gauge").add(
                "", [("key", m.group(2))], entry["value"])
            continue
        m = re.match(r"^burn/rate/([^/]*)/(fast|slow)$", name)
        if m:
            fam("s2c_burn_rate", "gauge").add(
                "", [("tenant", m.group(1) or "default"),
                     ("window", m.group(2))], entry["value"])
            continue
        m = re.match(r"^burn/state/([^/]*)$", name)
        if m:
            fam("s2c_burn_alert_state", "gauge").add(
                "", [("tenant", m.group(1) or "default")],
                entry["value"])
            continue
        fam(_sanitize(name), "gauge").add("", [], entry["value"])
    for name, entry in snapshot.get("histograms", {}).items():
        if name.startswith("burn/"):
            # the burn monitor's windowed rings are internal state —
            # the derived s2c_burn_rate/s2c_burn_alert_state gauges
            # are the exposition surface (a raw per-tenant summary
            # family here would be a series-per-tenant explosion)
            continue
        m = re.match(r"^sched/([^/]*)/([^/]+)$", name)
        if m:
            # flight-recorder scheduler distributions: kind is the
            # latency being measured (queue_wait / claim_latency /
            # steal_latency), tenant-labeled like the SLO families
            labels = [("tenant", m.group(1) or "default"),
                      ("kind", m.group(2))]
            f = fam("s2c_sched_seconds", "summary")
        elif (m := re.match(r"^slo/([^/]*)/([^/]+)$", name)):
            labels = [("tenant", m.group(1) or "default"),
                      ("phase", m.group(2))]
            f = fam("s2c_slo_phase_seconds", "summary")
        else:
            labels = []
            f = fam(_sanitize(name), "summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            f.add("", labels + [("quantile", q)], entry[key])
        f.add("_sum", labels, entry["sum"])
        f.add("_count", labels, entry["count"])

    wlabel = [("worker", worker)] if worker else []
    if restart_epoch is not None:
        wlabel = wlabel + [("restart_epoch", str(int(restart_epoch)))]
    lines: List[str] = []
    for name in sorted(fams):
        f = fams[name]
        help_txt = _HELP.get(name, f"sam2consensus-tpu registry metric "
                                   f"{name}.")
        lines.append(f"# HELP {name} "
                     + help_txt.replace("\\", r"\\").replace("\n", r"\n"))
        lines.append(f"# TYPE {name} {f.ftype}")
        for sname, labels, value in sorted(
                f.samples, key=lambda s: (s[0], s[1])):
            lines.append(
                f"{sname}{_labels(labels + wlabel)} {_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# -- exposition parsing + lint --------------------------------------------
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+\S+)?$")
_LABEL_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"(?P<v>(?:[^"\\]|\\.)*)"'
    r"\s*(?P<sep>,|$)")
_ESCAPE_RE = re.compile(r"\\(.)")


def parse_openmetrics(text: str) -> List[dict]:
    """Exposition text -> ``[{name, labels, value}, ...]`` sample rows
    (comments dropped).  The read side of :func:`render_openmetrics`
    used by tools/s2c_top.py; raises ``ValueError`` on a malformed
    sample line."""
    out = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        name, labels = _parse_sample(line, lineno)
        m = _SAMPLE_RE.match(line)
        out.append({"name": name, "labels": labels,
                    "value": float(m.group("value"))})
    return out


def _parse_sample(line: str, lineno: int):
    m = _SAMPLE_RE.match(line)
    if not m:
        raise ValueError(f"line {lineno}: unparsable sample {line!r}")
    labels: Dict[str, str] = {}
    raw = m.group("labels")
    if raw is not None:
        pos = 0
        while pos < len(raw):
            lm = _LABEL_RE.match(raw, pos)
            if not lm:
                raise ValueError(
                    f"line {lineno}: bad label syntax in {line!r}")
            val = lm.group("v")
            for esc in re.finditer(r"\\(.)", val):
                if esc.group(1) not in ('\\', '"', 'n'):
                    raise ValueError(
                        f"line {lineno}: invalid escape "
                        f"\\{esc.group(1)} in label value")
            labels[lm.group("k")] = _ESCAPE_RE.sub(
                lambda e: {"\\": "\\", '"': '"', "n": "\n"}[e.group(1)],
                val)
            pos = lm.end()
            if lm.group("sep") == "" and pos < len(raw):
                raise ValueError(
                    f"line {lineno}: trailing junk in labels {raw!r}")
    try:
        float(m.group("value"))
    except ValueError:
        raise ValueError(
            f"line {lineno}: non-numeric value in {line!r}") from None
    return m.group("name"), labels


def lint_openmetrics(text: str,
                     prev: Optional[str] = None) -> List[str]:
    """Promtool-style format lint; returns violations (empty = clean).

    Rules: metric/label name charset; label-value escaping; exactly
    one TYPE per family, declared before its samples; every sample
    belongs to a declared family (summary families own their ``_sum``/
    ``_count`` children); counter samples are finite, non-negative and
    ``_total``-suffixed; quantile labels in [0, 1]; no duplicate
    (name, labelset) sample; the exposition ends with ``# EOF``.  With
    ``prev`` (an earlier scrape of the same endpoint) counters must be
    monotone non-decreasing — the rule that catches a "counter" that
    is secretly a gauge.

    Restart-epoch rules: a ``restart_epoch`` label value must
    be a non-negative integer, and any exposition carrying one must
    also expose ``s2c_process_start_time_seconds`` — the two signals a
    scraper needs to tell a counter RESET (new epoch, new start time,
    fresh series) from a counter going backwards (same epoch: still a
    violation, and still caught by the ``prev`` check because the
    labelsets match).
    """
    errs: List[str] = []
    saw_restart_epoch = False
    saw_start_time = False
    types: Dict[str, str] = {}
    fam_sampled: set = set()
    seen: set = set()
    samples: Dict[Tuple[str, tuple], float] = {}
    lines = text.splitlines()
    for lineno, line in enumerate(lines, 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) < 4:
                    errs.append(f"line {lineno}: malformed TYPE line")
                    continue
                fname, ftype = parts[2], parts[3].strip()
                if not _NAME_RE.match(fname):
                    errs.append(f"line {lineno}: bad family name "
                                f"{fname!r}")
                if ftype not in ("counter", "gauge", "summary",
                                 "histogram", "untyped", "info"):
                    errs.append(f"line {lineno}: unknown TYPE {ftype!r}")
                if fname in types:
                    errs.append(f"line {lineno}: duplicate TYPE for "
                                f"family {fname!r}")
                elif fname in fam_sampled:
                    errs.append(f"line {lineno}: TYPE for {fname!r} "
                                f"after its samples")
                else:
                    types[fname] = ftype
            continue
        try:
            name, labels = _parse_sample(line, lineno)
        except ValueError as exc:
            errs.append(str(exc))
            continue
        value = float(_SAMPLE_RE.match(line).group("value"))
        for k in labels:
            if not _LABEL_NAME_RE.match(k):
                errs.append(f"line {lineno}: bad label name {k!r}")
        if name == "s2c_process_start_time_seconds":
            saw_start_time = True
        if "restart_epoch" in labels:
            saw_restart_epoch = True
            if not labels["restart_epoch"].isdigit():
                errs.append(
                    f"line {lineno}: restart_epoch label "
                    f"{labels['restart_epoch']!r} is not a "
                    f"non-negative integer")
        family = name
        if family not in types:
            for suffix in ("_sum", "_count"):
                base = name[:-len(suffix)] if name.endswith(suffix) \
                    else None
                if base and types.get(base) in ("summary", "histogram"):
                    family = base
                    break
        if family not in types:
            errs.append(f"line {lineno}: sample {name!r} has no "
                        f"preceding TYPE declaration")
        else:
            fam_sampled.add(family)
            ftype = types[family]
            if ftype == "counter":
                if not name.endswith("_total"):
                    errs.append(f"line {lineno}: counter sample "
                                f"{name!r} not suffixed _total")
                if not (value >= 0.0) or value != value \
                        or value == float("inf"):
                    errs.append(f"line {lineno}: counter {name!r} has "
                                f"non-finite/negative value {value}")
            if "quantile" in labels:
                try:
                    q = float(labels["quantile"])
                    if not 0.0 <= q <= 1.0:
                        raise ValueError
                except ValueError:
                    errs.append(f"line {lineno}: quantile label "
                                f"{labels['quantile']!r} outside [0,1]")
        key = (name, tuple(sorted(labels.items())))
        if key in seen:
            errs.append(f"line {lineno}: duplicate sample {name}"
                        f"{dict(labels)}")
        seen.add(key)
        samples[key] = value
    tail = [ln for ln in lines if ln.strip()]
    if not tail or tail[-1].strip() != "# EOF":
        errs.append("exposition does not end with # EOF")
    if saw_restart_epoch and not saw_start_time:
        errs.append("restart_epoch labels present without an "
                    "s2c_process_start_time_seconds sample (scrapers "
                    "cannot confirm the reset)")
    if prev is not None:
        prev_errs = []
        prev_samples: Dict[Tuple[str, tuple], float] = {}
        prev_types: Dict[str, str] = {}
        for lineno, line in enumerate(prev.splitlines(), 1):
            if line.startswith("# TYPE "):
                parts = line.split(None, 3)
                if len(parts) == 4:
                    prev_types[parts[2]] = parts[3].strip()
                continue
            if not line.strip() or line.startswith("#"):
                continue
            try:
                name, labels = _parse_sample(line, lineno)
                prev_samples[(name, tuple(sorted(labels.items())))] = \
                    float(_SAMPLE_RE.match(line).group("value"))
            except ValueError:
                prev_errs.append(f"prev scrape line {lineno} unparsable")
        errs.extend(prev_errs)
        for key, old in prev_samples.items():
            name = key[0]
            base = name[:-len("_count")] if name.endswith("_count") \
                else name
            ftype = prev_types.get(name) or prev_types.get(base)
            if ftype != "counter" and not (
                    name.endswith("_count")
                    and prev_types.get(base) in ("summary", "histogram")):
                continue
            new = samples.get(key)
            if new is not None and new < old:
                errs.append(
                    f"counter {name}{dict(key[1])} went backwards "
                    f"across scrapes ({old} -> {new})")
    return errs


# =========================================================================
# Localhost HTTP endpoint (/metrics + /healthz)
# =========================================================================
class TelemetryServer:
    """Stdlib-only localhost scrape endpoint.

    ``metrics_fn`` returns the exposition TEXT, ``health_fn`` the
    health dict — both are called per request, so a scrape always sees
    heartbeat-fresh gauges even between watchdog ticks.  Bound to
    127.0.0.1 only (telemetry is an operator surface, not a public
    one); ``port=0`` picks an ephemeral port (``.port`` holds the real
    one).  Runs on a daemon thread; :meth:`close` shuts it down.
    """

    def __init__(self, metrics_fn: Callable[[], str],
                 health_fn: Callable[[], dict], port: int = 0):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):           # noqa: N802 (stdlib name)
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = outer._metrics_fn().encode("utf-8")
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    elif self.path.split("?")[0] == "/healthz":
                        body = (json.dumps(outer._health_fn(),
                                           default=str) + "\n") \
                            .encode("utf-8")
                        ctype = "application/json; charset=utf-8"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:   # never kill the server
                    body = f"telemetry render failed: {exc}\n" \
                        .encode("utf-8")
                    self.send_response(500)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # scrapes are not stderr news
                pass

        self._metrics_fn = metrics_fn
        self._health_fn = health_fn
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="s2c-telemetry-http")
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


# =========================================================================
# On-demand profiler capture
# =========================================================================
_profiler_initialised = False


def _init_device_profiler() -> None:
    """Initialise the CUDA profiler on the calling thread, once.  Kineto
    initialises on its first use and only on the thread that registered
    it (the one that loaded torch); a window opened first on a side
    thread records no kernel.  So the first capture opens an empty
    window here, on the runner's own thread (which the runner calls
    :meth:`ProfilerCapture.capture` from), before the bounded window
    moves to its daemon thread."""
    global _profiler_initialised
    if _profiler_initialised:
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass
    _profiler_initialised = True


class ProfilerCapture:
    """Arm-and-capture: SIGUSR2 or a touch-file requests ONE bounded
    profile of whatever the server is doing right now.

    The serve runner polls :meth:`pending` from its watchdog tick and
    calls :meth:`capture` when armed — which means the capture runs
    precisely while a hung job is hanging, the case it exists for.  On
    a CUDA ``device`` it opens a bounded ``torch.profiler`` window (CPU
    and CUDA activity) on a daemon thread (a wedged dispatch cannot
    block it), and always writes a pure-Python dump: every live
    thread's stack plus the current tracer spans and a registry
    snapshot, which is exactly what "where is it stuck" needs.
    Artifacts land next to the journal (``profile_capture_<pid>_<n>/``:
    ``span_dump.json`` and, from the window, a
    ``<host>_<pid>.<ms>.pt.trace.json`` Chrome trace).
    """

    def __init__(self, out_dir: str,
                 duration_s: Optional[float] = None,
                 touch_dir: Optional[str] = None, device=None):
        self.out_dir = out_dir
        #: the server's torch device: a CUDA device opens the profiler
        #: window, anything else takes the span dump alone
        self.device = device
        #: the open window's thread (:meth:`join` waits for it)
        self.window: Optional[threading.Thread] = None
        try:
            self.duration_s = float(
                duration_s if duration_s is not None
                else os.environ.get("S2C_PROFILE_CAPTURE_S",
                                    DEFAULT_CAPTURE_S))
        except ValueError:
            self.duration_s = DEFAULT_CAPTURE_S
        self.touch_path = os.path.join(touch_dir or out_dir,
                                       CAPTURE_TOUCH_NAME)
        self.captures = 0
        self.last_path: Optional[str] = None
        self._armed = threading.Event()
        self._busy = threading.Lock()

    # -- triggers ---------------------------------------------------------
    def request(self) -> None:
        """Arm a capture (the SIGUSR2 handler and tests call this)."""
        self._armed.set()

    def install_signal(self) -> bool:
        """Install the SIGUSR2 handler (main thread only; best-effort —
        a non-main-thread or exotic-platform install failure leaves the
        touch-file trigger available)."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            signal.signal(signal.SIGUSR2, lambda *_: self.request())
            return True
        except (AttributeError, ValueError, OSError):
            return False

    def pending(self) -> bool:
        """True when a capture is armed; consumes the touch file."""
        if os.path.exists(self.touch_path):
            try:
                os.unlink(self.touch_path)
            except OSError:
                pass
            self._armed.set()
        return self._armed.is_set()

    # -- the capture ------------------------------------------------------
    def capture(self, tracer=None, registry=None,
                context: Optional[dict] = None) -> Optional[str]:
        """Take the armed capture; returns the artifact path (None when
        not armed or another capture is still in flight)."""
        if not self._armed.is_set():
            return None
        if not self._busy.acquire(blocking=False):
            return None                 # a window is already open
        try:
            self._armed.clear()
            self.captures += 1
            dest = os.path.join(
                self.out_dir, f"profile_capture_{os.getpid()}_"
                              f"{self.captures}")
            os.makedirs(dest, exist_ok=True)
            mode = self._try_device_window(dest)
            if mode is None:
                mode = "span_dump"
            self._span_dump(dest, tracer, registry, context, mode)
            self.last_path = dest
            logger.warning("profiler capture #%d (%s) written to %s",
                           self.captures, mode, dest)
            return dest
        except Exception as exc:        # capture must never fail a job
            logger.warning("profiler capture failed: %s: %s",
                           type(exc).__name__, exc)
            return None
        finally:
            self._busy.release()

    def _try_device_window(self, dest: str) -> Optional[str]:
        """Open a bounded ``torch.profiler`` window (CPU and CUDA
        activity) on a daemon thread when the server's device is CUDA;
        returns the mode string or None (-> the pure-Python dump alone).
        The window thread enqueues nothing and the job's thread never
        waits on it: CUPTI records the kernels the job launches from its
        own thread, and the trace is written when the window closes."""
        import socket

        import torch

        if self.device is None or torch.device(self.device).type != "cuda":
            return None
        _init_device_profiler()
        duration = self.duration_s

        def _window():
            from torch.profiler import ProfilerActivity, profile

            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    time.sleep(duration)
                name = (f"{socket.gethostname()}_{os.getpid()}."
                        f"{int(time.time() * 1000)}.pt.trace.json")
                tmp = os.path.join(dest, name + ".tmp")
                prof.export_chrome_trace(tmp)
                os.replace(tmp, os.path.join(dest, name))
            except Exception as exc:    # capture must never fail a job
                logger.warning("profiler window failed: %s: %s",
                               type(exc).__name__, exc)

        t = threading.Thread(target=_window, daemon=True,
                             name="s2c-profile-window")
        t.start()
        self.window = t
        return f"torch_profiler({duration:g}s)"

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for an open profiler window to close and write its
        trace (the serve runner's ``close`` calls this)."""
        t = self.window
        if t is not None and t.is_alive():
            t.join(timeout)

    def _span_dump(self, dest: str, tracer, registry,
                   context: Optional[dict], mode: str) -> None:
        """The always-available part: thread stacks + tracer spans +
        registry snapshot, one JSON file."""
        import sys
        import traceback

        stacks = {}
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            stacks[f"{names.get(tid, '?')}({tid})"] = \
                traceback.format_stack(frame)
        blob = {
            "schema": "s2c-profile-capture/1",
            "mode": mode,
            "created_unix": round(time.time(), 3),
            "pid": os.getpid(),
            "context": dict(context or {}),
            "threads": stacks,
            "spans": [
                {"name": s.name, "ts_us": s.ts_us, "dur_us": s.dur_us,
                 "tid": s.tid}
                for s in (tracer.drain() if tracer is not None else [])
            ][-500:],
            "metrics": registry.snapshot()
            if registry is not None else None,
        }
        atomic_write_text(os.path.join(dest, "span_dump.json"),
                          json.dumps(blob, indent=1, default=str) + "\n")


# =========================================================================
# Structured JSON logging + correlation context
# =========================================================================
_log_ctx = threading.local()


def set_log_context(**fields) -> None:
    """Set THIS thread's log-correlation fields (``job_id``,
    ``tenant``, ``rung``, ...); call with no arguments to clear.  The
    serve runner sets it on the main loop, the watchdog worker and the
    decode-ahead thread, so every record a job emits — from any of its
    threads — carries the same correlation IDs."""
    _log_ctx.fields = {k: v for k, v in fields.items()
                       if v not in (None, "")} or None


def get_log_context() -> dict:
    return dict(getattr(_log_ctx, "fields", None) or {})


class JsonLogFormatter(logging.Formatter):
    """One JSON object per record: ts/level/logger/msg plus the
    thread's correlation context and the innermost open trace span
    (``--log-format json``)."""

    def format(self, record: logging.LogRecord) -> str:
        from . import trace as _trace

        obj = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        obj.update(get_log_context())
        span = _trace.current_span_name()
        if span:
            obj["span"] = span
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, ensure_ascii=False, default=str)
