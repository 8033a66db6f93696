"""Admission control: a bounded queue that sheds load instead of dying.

Copy of ``sam2consensus_tpu/serve/admission.py`` (pinned by
``tests/test_torch_copies.py``).  The port's runner reads
``mesh_hosts`` from ``S2C_MESH_HOSTS``, as the reference's does.

ROADMAP item 2(b): at fleet scale the failure mode of an unbounded
queue is not slowness, it is an OOM'd server taking every queued job
with it — and the failure mode of shared tenancy is one tenant's
degraded jobs dragging the warm device path through retry/demotion
cycles for everyone.  This module makes both decisions explicit and
auditable:

* **bounded queue** — at most ``max_queue`` jobs are admitted per
  submission window (0 = unbounded); overflow is rejected with reason
  ``queue_full`` rather than silently buffered.  Rejection IS the
  backpressure signal: the submitter sees it immediately and can
  re-offer the job later, instead of discovering an hour later that
  the queue never drained;
* **per-tenant quotas** — at most ``tenant_quota`` admitted jobs per
  tenant per window (0 = unbounded), reason ``tenant_quota``: one
  tenant cannot occupy the whole queue;
* **degraded-tenant pinning** — a tenant whose previous job ended on a
  demoted ladder rung (``resilience.ladder.job_rungs``) gets its NEXT
  jobs admitted but PINNED to the host rung
  (``ladder.job_host_rung_config``): the jobs still run — byte
  identity is rung-independent — but they never touch the fleet's
  device path, so a tenant with a poisoned input or a cursed shape
  cannot demote the fleet.  A pinned job that completes cleanly clears
  the tenant back to the fast path (one good job is the probation).

Every decision is a counter: ``serve/admission_admitted``,
``serve/admission_rejected`` (+ ``/<reason>``), ``serve/admission_pinned``
— surfaced through ``publish_stats_extra`` and the manifest ``serve``
section like every other serve counter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

REASON_QUEUE_FULL = "queue_full"
REASON_TENANT_QUOTA = "tenant_quota"
#: capacity shed (``serve/admission_capacity``): the job's predicted
#: peak host+device bytes (observability/memplane.py capacity model,
#: priced from its header-probed genome length + config) exceeds the
#: server's ``--mem-budget`` — the job is queued-not-OOMed: rejection
#: is the backpressure signal, and the submitter re-offers it to a
#: host that fits (or after raising the budget) instead of discovering
#: the OOM post-mortem
REASON_CAPACITY = "capacity"
#: streaming-session backpressure (serve/stream_server.py): the
#: session's journaled-but-unabsorbed wave backlog is at its bound —
#: the wave is rejected with HTTP 429 + Retry-After instead of being
#: buffered without limit (reject-with-reason, never wedge)
REASON_BACKPRESSURE = "backpressure"


@dataclass
class Decision:
    """One spec's admission verdict.  Pinning is deliberately NOT part
    of this record: it is decided at JOB-START time via
    :meth:`AdmissionController.pin_rung`, so a tenant degraded by an
    earlier job of the same batch still pins the later ones."""

    admitted: bool
    reason: Optional[str] = None        # set iff rejected
    #: capacity-planned mesh scale-up verdict: the job's predicted
    #: peak exceeds one host's ``mem_budget`` but the memory plane's
    #: ``mesh_shards`` plan (observability/memplane.plan_mesh_shards)
    #: fits it on this many hosts — "this job needs K hosts", decided
    #: at admission time instead of discovered as an OOM.  None on
    #: single-host admits and on rejects.
    mesh_shards: Optional[int] = None


@dataclass
class AdmissionController:
    """Window-scoped bounds + queue-lifetime tenant state.

    ``admit`` is called per spec in submission order; ``open_window``
    resets the per-window counts (the serve runner opens one window per
    ``submit_jobs`` batch).  Tenant degradation state intentionally
    SURVIVES windows — that is the isolation story."""

    max_queue: int = 0
    tenant_quota: int = 0
    #: predicted-peak byte budget per job (0 = no capacity gate); see
    #: REASON_CAPACITY.  Parsed with the count-cache size grammar
    #: (``--mem-budget 4G`` / S2C_MEM_BUDGET).
    mem_budget: int = 0
    #: hosts the fleet can dedicate to ONE mesh-sharded job
    #: (S2C_MESH_HOSTS; 0 = no mesh scale-out — over-budget jobs shed
    #: as before).  When > 1, an over-budget job is priced by
    #: ``memplane.plan_mesh_shards`` and admitted with a "needs K
    #: hosts" verdict if its per-host peak fits the budget on
    #: K <= mesh_hosts hosts.
    mesh_hosts: int = 0
    _window_admitted: int = 0
    _window_by_tenant: Dict[str, int] = field(default_factory=dict)
    #: tenant -> rung its last degraded job landed on ("host"/"device_scatter")
    tenant_rungs: Dict[str, str] = field(default_factory=dict)
    #: tenant -> poison submissions (DATA-class failures: blown
    #: bad-record budgets).  Queue-lifetime, like tenant_rungs — but
    #: unlike a degradation rung it never pins anybody (see note_poison)
    poison_by_tenant: Dict[str, int] = field(default_factory=dict)
    #: tenant -> SLO objective breaches (observability/telemetry.py
    #: burn counters, fed by the serve runner per finished job).
    #: Queue-lifetime evidence for admission decisions: surfaced in
    #: the health snapshot and each job's manifest serve.slo verdict,
    #: the base for future burn-rate throttling — like poison, burning
    #: an objective never demotes a tenant's rung by itself (slow is
    #: not broken, and the breach may be the FLEET's queue, not the
    #: tenant's data)
    slo_burn_by_tenant: Dict[str, int] = field(default_factory=dict)
    #: windowed burn view (observability/burn.py BurnMonitor),
    #: attached by the serve runner.  ``slo_burn()`` reads through it
    #: so live consumers (batch priority, health) see breaches DECAY
    #: out of the window instead of the lifetime dict's
    #: breached-once-throttled-forever reads
    burn_monitor: Optional[object] = None

    def slo_burn(self, now: Optional[float] = None) -> Dict[str, int]:
        """Tenant -> recent (slow-window) SLO breach count.  The
        monitor is the truth for every tenant it has observed (so an
        aged-out breach reads as unburnt); lifetime-dict entries for
        tenants the monitor has never seen pass through (bare
        controllers in tests and tools, externally-seeded burn)."""
        mon = self.burn_monitor
        if mon is None:
            return dict(self.slo_burn_by_tenant)
        try:
            out = mon.burn_counts("slow", now=now)
            seen = set(mon.states())
        except Exception:
            return dict(self.slo_burn_by_tenant)
        for t, n in self.slo_burn_by_tenant.items():
            if t not in seen and n > 0:
                out[t] = n
        return out

    def open_window(self) -> None:
        self._window_admitted = 0
        self._window_by_tenant = {}

    def seed_window(self, counts: Dict[str, int]) -> None:
        """Pre-charge the freshly-opened window with jobs the rest of
        the FLEET already has live (journal-visible submitted-not-
        terminal keys of other workers, serve/fleet.py): per-tenant
        quotas then hold against the fleet's queue, not just this
        worker's submission."""
        for tenant, n in counts.items():
            if n <= 0:
                continue
            self._window_admitted += n
            self._window_by_tenant[tenant] = \
                self._window_by_tenant.get(tenant, 0) + n

    def admit(self, tenant: str = "",
              predicted_bytes: Optional[int] = None,
              shard_plan: Optional[dict] = None) -> Decision:
        """One spec's verdict.  ``predicted_bytes`` is the memory
        plane's capacity prediction for the job (None = unpriceable —
        header unreadable; admitted, the serial path surfaces the real
        error): a prediction over ``mem_budget`` sheds the job instead
        of letting it OOM the warm server — UNLESS ``shard_plan`` (the
        memory plane's ``mesh_shards`` verdict,
        ``observability.memplane.plan_mesh_shards``) says the job fits
        sharded across K > 1 hosts, in which case it is admitted with
        ``Decision.mesh_shards = K``: capacity planning replaces
        capacity shedding whenever the fleet has the hosts."""
        if self.max_queue and self._window_admitted >= self.max_queue:
            return Decision(False, reason=REASON_QUEUE_FULL)
        if (self.tenant_quota and tenant
                and self._window_by_tenant.get(tenant, 0)
                >= self.tenant_quota):
            return Decision(False, reason=REASON_TENANT_QUOTA)
        mesh_shards = None
        if (self.mem_budget and predicted_bytes is not None
                and predicted_bytes > self.mem_budget):
            if not (shard_plan and shard_plan.get("fits")
                    and int(shard_plan.get("hosts", 1)) > 1):
                return Decision(False, reason=REASON_CAPACITY)
            mesh_shards = int(shard_plan["hosts"])
        self._window_admitted += 1
        if tenant:
            self._window_by_tenant[tenant] = \
                self._window_by_tenant.get(tenant, 0) + 1
        return Decision(True, mesh_shards=mesh_shards)

    def price_wave(self, tenant: str = "", body_bytes: int = 0,
                   pending_waves: int = 0,
                   max_pending: int = 0) -> Decision:
        """One streaming wave's admission verdict (serve/session.py).

        Waves are NOT window-scoped jobs — a session absorbs thousands
        over its lifetime — so the queue/tenant window counters are
        left alone; the gates that matter here are the session's
        unabsorbed-wave backlog (``max_pending`` -> REASON_BACKPRESSURE,
        the 429 + Retry-After signal) and the same capacity plane the
        job path prices against: a wave whose body alone exceeds the
        server's ``--mem-budget`` could never be absorbed whole."""
        if max_pending and pending_waves >= max_pending:
            return Decision(False, reason=REASON_BACKPRESSURE)
        if self.mem_budget and body_bytes \
                and body_bytes > self.mem_budget:
            return Decision(False, reason=REASON_CAPACITY)
        return Decision(True)

    def price_cohort_wave(self, wave_jobs: int,
                          predicted_bytes: int = 0) -> Decision:
        """One cohort wave's capacity verdict (serve/cohort.py).

        Like :meth:`price_wave`, cohort waves are not window-scoped
        jobs — the queue/tenant window counters are untouched.  The
        single gate is the capacity plane: a wave whose predicted
        combined peak (``memplane.predict_job_peak_bytes`` over the
        wave's combined panel axis) exceeds ``--mem-budget`` would OOM
        the warm server mid-cohort.  The cohort driver SIZES waves so
        this verdict admits (``serve/cohort.size_wave`` binary-searches
        the largest fitting wave), then prices the chosen size here —
        so "no admission trips mid-cohort" is checked, not assumed."""
        if wave_jobs < 1:
            return Decision(False, reason=REASON_CAPACITY)
        if self.mem_budget and predicted_bytes \
                and predicted_bytes > self.mem_budget:
            return Decision(False, reason=REASON_CAPACITY)
        return Decision(True)

    def pin_rung(self, tenant: str) -> Optional[str]:
        """The rung a tenant's next job must run on (None = fast path).
        Consulted at JOB-START time, not admission time — a tenant
        degraded by job k must see job k+1 pinned even when both were
        admitted in the same batch."""
        return self.tenant_rungs.get(tenant) if tenant else None

    def note_poison(self, tenant: str) -> None:
        """Count one poison submission (a job failed DATA-class: blown
        bad-record budget / rotten upload) for the tenant.  Counting is
        ALL this does — a tenant whose data is garbage gets precise
        failure summaries, not a device-rung demotion: the fast path
        would fail the same input no slower, and pinning them to the
        host rung would punish their next (clean) job for their last
        (dirty) one.  The tally is the evidence base for future
        poison-rate throttling at admission time."""
        self.poison_by_tenant[tenant or ""] = \
            self.poison_by_tenant.get(tenant or "", 0) + 1

    def note_slo(self, tenant: str, n_violations: int = 1) -> None:
        """Count SLO objective breaches for the tenant (see
        ``slo_burn_by_tenant``)."""
        if n_violations > 0:
            self.slo_burn_by_tenant[tenant or ""] = \
                self.slo_burn_by_tenant.get(tenant or "", 0) \
                + int(n_violations)

    def note_result(self, tenant: str, rungs: dict, ok: bool,
                    was_pinned: bool) -> None:
        """Feed a finished job's outcome back into tenant state.

        A job that ended demoted marks its tenant degraded (its next
        jobs run pinned).  A PINNED job that completed cleanly is the
        probation pass: the tenant returns to the fast path.  Failed
        pinned jobs stay pinned — the bottom rung failing is not
        evidence the device path would fare better."""
        if not tenant:
            return
        if rungs and not was_pinned:
            # deepest rung wins the record: host < device_scatter
            rung = rungs.get("pileup") or rungs.get("tail") or "host"
            self.tenant_rungs[tenant] = rung
        elif was_pinned and ok:
            self.tenant_rungs.pop(tenant, None)
