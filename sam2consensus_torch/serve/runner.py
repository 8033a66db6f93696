"""The warm server behind ``serve`` and :func:`submit_jobs`.

Port of the serial queue of ``sam2consensus_tpu/serve/runner.py``.  One
:class:`~..backends.torch_backend.TorchBackend` lives for the server's
lifetime, on one card: the CUDA context, the kernel extension
(``kernels.build.extension``), the link probe and the IUPAC table are
paid once a server, not once a job.  Jobs run one after another through
the unchanged ``TorchBackend.run`` (K1, and K2 or K3 for a job with
insertions) while the next job's host decode runs ahead on a side
thread.  The load-bearing pieces:

* :class:`_DecodeAhead` decodes job N+1 (header and segment batches,
  through the backend's own ``_make_encoder``) on a daemon thread with
  job N+1's instruments thread-bound (``observability.
  bind_run_to_thread``), logging per-batch decode intervals.  It starts
  when job N's first pileup dispatch begins (the backend sets the
  ``serve_dispatch_gate`` the runner plants), or when job N ends
  without one, so it runs behind job N's device work and never races
  job N's own set-up and first decode for the host.  It stays on the
  host: no accumulator (``acc=None``), no staging, no torch call, so
  it never takes the pinned slots that job N's stager holds;
* the cross-job overlap join: after job N completes, its dispatch
  intervals (planted through the backend's ``serve_dispatch_log``) are
  intersected with job N+1's decode intervals
  (``wire.pipeline.intersect_sec``) and the result lands in job N+1's
  registry as ``serve/overlap_sec``.  An untraced dispatch is an
  enqueue, so these are enqueue intervals;
* prewarm: ``ops.pileup.prewarm_pileup`` over the layout's canonical
  slab shapes, on a thread behind the first job's decode, bound to the
  SERVER registry: it loads the kernel extension there (counted
  ``compile/persist_*``) and runs the pack and K1 once per shape over
  all-PAD rows (``compile/prewarm_shapes``); an ``--pileup mxu`` job's
  prewarm runs the MXU route instead, over one tile of eight all-PAD rows
  a shape.

The survivability layer, opt-in and orthogonal to the warm path, is the
reference's: the journal (``journal_dir``; per-job checkpoints, restart
skips committed jobs by output fingerprint and resumes the in-flight
one; decode-ahead off), the watchdog (``job_timeout`` /
``stall_timeout``; a wedged job is abandoned on its thread and fails
alone, or retries once on the host rung under ``--on-device-error
fallback``), admission control (``max_queue``, ``tenant_quota``,
``mem_budget``, degraded-tenant pinning) and the health snapshot; the
telemetry plane (the aggregate registry, OpenMetrics file and
endpoint, SLOs, burn alerts, the rate card and its scale hint, the
profiler capture).

Continuous batching (``batch`` / ``batch_window``, ``serve/scheduler.py``)
packs eligible small jobs into shared slabs that K1 counts in one dispatch
sequence on the card, and the per-reference count cache (``count_cache``,
``serve/countcache.py``) seeds each incremental job from the warm counts
of its reference and takes the job's final state back after it ended
whole.

Fleet mode (``worker_id`` / ``lease_ttl``, ``serve/fleet.py``) joins the
journal as one of N work-stealing workers: each job is claimed under a
lease before it runs, the watchdog tick renews and reaps leases, and a
commit is fenced by the lease (a worker whose lease was reaped never
commits, also when its abandoned attempt finishes later).

Where the port differs: the server runs on ``device`` (None = CUDA,
raising without it; the CPU only when the caller names it);
``persistent_cache`` names the kernel
build directory (there is no JIT cache); and the host-rung retry reads
the job's ``on_device_error`` only, not the reference's
``S2C_ON_DEVICE_ERROR``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .. import observability as obs
from ..config import RunConfig
from ..observability import ratecard as rcard
from ..observability import telemetry as stele
from ..observability.burn import BurnMonitor
from ..observability.metrics import MetricsRegistry
from . import health as shealth
from . import journal as sjournal
from .admission import AdmissionController

logger = logging.getLogger("sam2consensus_torch.serve")

#: decode-ahead batch cap: bounds the memory a pre-decoded job can pin
#: (each batch is ~chunk_reads rows).  Past the cap the remainder
#: decodes lazily inside the job's own run, exactly like a cold run.
DEFAULT_AHEAD_BATCHES = 64

#: watchdog poll period — cheap (a thread join with timeout), frequent
#: enough that a 1 s --job-timeout overshoots by at most ~10%
WATCHDOG_POLL_S = 0.1


def _ahead_batch_cap() -> int:
    try:
        return max(1, int(os.environ.get("S2C_SERVE_AHEAD_BATCHES",
                                         DEFAULT_AHEAD_BATCHES)))
    except ValueError:
        return DEFAULT_AHEAD_BATCHES


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        logger.warning("%s=%r is not a number: ignored", name, raw)
        return None


@dataclass
class JobSpec:
    """One consensus job: an input path plus its full RunConfig.

    ``config.backend`` is ignored (the server IS the torch backend);
    checkpoint mode is rejected — its contract is serial decode with
    stream-consistent snapshots, which serve-mode decode-ahead would
    break (journal mode manages per-job checkpoints itself, with
    decode-ahead off) — and an incremental job needs the count cache.
    ``tenant`` scopes admission
    quotas and degraded-tenant pinning ("" = untenanted)."""

    filename: str
    config: RunConfig = field(default_factory=lambda: RunConfig(
        backend="torch"))
    job_id: str = ""
    tenant: str = ""


@dataclass
class JobResult:
    """One job's outcome; the server returns one per submitted spec,
    in order, failed jobs included (``error`` set, ``fastas`` None)."""

    job_id: str
    filename: str
    fastas: Optional[dict] = None        # {reference: [FastaRecord]}
    stats: Optional[object] = None       # BackendStats
    error: Optional[str] = None
    elapsed_sec: float = 0.0
    #: 0-based submit order; job 0 pays whatever load the prewarm did
    #: not hide, jobs 1+ are the warm path
    index: int = 0
    #: per-job counter subset: serve/*, compile/*, resilience/*,
    #: fault/* and phase/*_sec — the amortization/isolation story
    metrics: dict = field(default_factory=dict)
    #: degradation rungs this job ended on ({} = never demoted)
    rungs: dict = field(default_factory=dict)
    manifest: Optional[dict] = None
    #: journal resume: True = skipped because a previous process
    #: committed this job and its outputs still fingerprint-match
    resumed: bool = False
    #: output files this job's commit wrote (journal mode only — the
    #: runner writes outputs there so commit == durably on disk)
    output_paths: List[str] = field(default_factory=list)
    #: admission verdict: None = admitted clean, "pinned:<rung>" =
    #: admitted on the tenant's demoted rung, else the reject reason
    admission: Optional[str] = None
    #: tolerant decode (--on-bad-record): malformed records this job
    #: skipped/quarantined (0 under the strict default)
    bad_records: int = 0
    #: entries captured to the job's quarantine sidecar
    quarantined: int = 0
    #: True = the job failed because its --max-bad-records budget blew
    #: (DATA class: failed fast, no retry, no rung demotion, tenant
    #: stays on the device path)
    budget_exhausted: bool = False
    #: the worker that committed this job (fleet mode; "" here)
    worker: str = ""

    @property
    def ok(self) -> bool:
        return self.error is None


class _PredecodedJob:
    """Records-carrier the backend consumes in place of a stream
    (``TorchBackend._make_encoder`` dispatches on ``is_predecoded``)."""

    is_predecoded = True

    def __init__(self, ahead: "_DecodeAhead"):
        self._ahead = ahead

    @property
    def encoder(self):
        return self._ahead.encoder

    @property
    def extra(self) -> dict:
        """The decode choices ``_make_encoder`` recorded on the ahead
        thread (``decoder``, ``decode_threads``, ``decode_rung``)."""
        return self._ahead.extra

    @property
    def n_lines(self) -> int:
        stream = self._ahead.stream
        return stream.n_lines if stream is not None else 0

    def batches(self):
        """Already-decoded batches first, then any live remainder; a
        decode error captured on the ahead thread re-raises HERE, at
        the point the cold streaming path would have hit it (same
        exception object, so type/message parity holds).  Each decoded
        batch leaves the carrier as it is handed over, so a finished job
        holds none of its batches (or their staged rows) past its
        run."""
        a = self._ahead
        while a.done_batches:
            yield a.done_batches.popleft()
        if a.error is not None:
            raise a.error
        if a.rest is not None:
            yield from a.rest


class _DecodeAhead:
    """Decode one job's input on a daemon thread, instruments bound.

    The thread waits on ``gate`` first: the previous job's first pileup
    dispatch sets it (:meth:`release` at that job's end otherwise), and
    :meth:`cancel` lets the thread exit without decoding.
    ``fault_cb`` is the runner's queue-lifetime injector hook — the
    ``serve_decode_ahead`` site fires per decoded batch (and before
    the header parse, so call 0 models a poisoned open)."""

    def __init__(self, backend, spec: JobSpec,
                 robs: "obs.RunObservability", cap: int,
                 fault_cb: Optional[Callable[[str], None]] = None):
        self.spec = spec
        self.robs = robs
        self.contigs = None
        self.stream = None
        self.encoder = None
        self.extra: dict = {}
        self.done_batches: collections.deque = collections.deque()
        self.rest = None
        self.error: Optional[BaseException] = None
        self._backend = backend
        self._cap = cap
        self._fault_cb = fault_cb
        self._lock = threading.Lock()
        self._intervals: List[Tuple[float, float]] = []
        #: start of the batch being decoded now (None between batches)
        self._open: Optional[float] = None
        self._handle = None
        self.gate = threading.Event()
        self._cancelled = False
        self.thread = threading.Thread(target=self._work, daemon=True,
                                       name="serve-decode-ahead")
        self.thread.start()

    def intervals(self) -> List[Tuple[float, float]]:
        """The decode intervals so far: the open and header parse, then
        one a batch; one still running counts up to now (the overlap
        join runs when the previous job ends, and a long-read input's
        one batch can still be decoding then).  Their count is the
        watchdog's progress."""
        now = time.perf_counter()
        with self._lock:
            out = list(self._intervals)
            if self._open is not None:
                out.append((self._open, now))
            return out

    def decode_sec(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.intervals())

    def release(self) -> None:
        """Start the decode now, if the previous job's first dispatch
        has not yet."""
        self.gate.set()

    def cancel(self) -> None:
        """Let a thread still waiting on the gate exit undecoded."""
        self._cancelled = True
        self.gate.set()

    def _work(self) -> None:
        from ..backends.base import BackendStats
        from ..config import resolve_decode_threads
        from ..encoder.events import GenomeLayout
        from ..formats import open_alignment_input
        from ..observability import memplane

        self.gate.wait()
        if self._cancelled:
            return
        with obs.bind_run_to_thread(self.robs):
            stele.set_log_context(job_id=self.spec.job_id,
                                  tenant=self.spec.tenant,
                                  thread="decode-ahead")
            reg = obs.metrics()
            tr = obs.tracer()
            tr.name_thread("serve-decode-ahead")
            try:
                if self._fault_cb is not None:
                    self._fault_cb("serve_decode_ahead")
                # the open, the header parse and the encoder's set-up are
                # this job's decode too: the first interval (a BAM's
                # BGZF set-up can outlast a short job before it)
                t_open = time.perf_counter()
                with self._lock:
                    self._open = t_open
                ai = open_alignment_input(
                    self.spec.filename,
                    getattr(self.spec.config, "input_format", "auto"),
                    threads=resolve_decode_threads(self.spec.config))
                self._handle = ai
                contigs, stream = ai.contigs, ai.stream
                layout = GenomeLayout(contigs)
                # acc=None: never the fused host-counting encoder — the
                # job's accumulator does not exist yet.  Same native/py
                # decode selection as a cold run otherwise.
                stats = BackendStats()
                encoder, gen = self._backend._make_encoder(
                    layout, stream, self.spec.config, stats, None)
                with self._lock:
                    self._open = None
                    self._intervals.append((t_open, time.perf_counter()))
                self.extra = stats.extra
                self.encoder = encoder
                self.stream = stream
                self.contigs = contigs
                while len(self.done_batches) < self._cap:
                    if self._fault_cb is not None:
                        self._fault_cb("serve_decode_ahead")
                    with tr.span("decode"):
                        t0 = time.perf_counter()
                        with self._lock:
                            self._open = t0
                        try:
                            batch = next(gen)
                        except StopIteration:
                            gen = None
                            break
                        finally:
                            with self._lock:
                                self._open = None
                        t1 = time.perf_counter()
                        reg.add("phase/decode_sec", t1 - t0)
                    with self._lock:
                        self._intervals.append((t0, t1))
                    self.done_batches.append(batch)
                    # residency: predecoded batches pin memory until
                    # job N+1 consumes them (memplane decode_ahead
                    # family; released when the batch is collected)
                    memplane.track_obj("decode_ahead", batch,
                                       memplane.batch_nbytes(batch))
                self.rest = gen
            except BaseException as exc:
                # surfaced to the job when it consumes past the decoded
                # prefix (_PredecodedJob.batches) — or immediately, when
                # even the header never parsed (contigs is None)
                self.error = exc
                with self._lock:
                    self._open = None

    def close(self) -> None:
        if self._handle is not None:
            try:
                self._handle.close()
            except OSError:
                pass


class ServeRunner:
    """A warm server: one backend on one device, many jobs.

    ``prewarm``: ``"auto"`` runs the first job's canonical slab shapes
    through the default pileup route on a background thread while that
    job decodes (explicit ``--pileup pallas|scatter`` jobs only — a job
    under ``--pileup auto`` may count on the host), ``"off"`` disables,
    and :meth:`prewarm` takes explicit shapes at any time.
    ``decode_ahead=False`` serializes jobs exactly like cold runs.
    ``persistent_cache`` keeps the kernel build directory
    (``kernels.build.BUILD_DIR``, reported as ``cache_dir``).
    ``device``: None = CUDA (``device.resolve_device``: a
    ``RuntimeError`` without it); the CPU only when named.
    ``mesh_devices``: the device list a sharded job's mesh draws on
    (``backends.torch_backend.mesh_device_list``); a job's ``--shards``
    over it is refused at admission (``MeshCapacityError``).

    Survivability knobs (all default-off; see the module docstring):
    ``journal_dir``, ``job_timeout``/``stall_timeout`` (env
    S2C_JOB_TIMEOUT / S2C_STALL_TIMEOUT when None), ``max_queue``,
    ``tenant_quota``, ``mem_budget`` (env S2C_MEM_BUDGET),
    ``health_out``, and ``fault_inject`` — the runner-scope injector
    spec for the serve-level sites (serve_decode_ahead /
    journal_write; env S2C_FAULT_INJECT when empty).
    ``verify_outputs`` ("fast"/"full") controls resume-time output
    verification (stat fast path vs full re-hash).

    Fleet mode (``worker_id``/``lease_ttl`` — serve/fleet.py; requires
    ``journal_dir``, excludes ``batch`` and ``count_cache``): this runner
    joins the journal as one of N work-stealing workers — submit_jobs
    arbitrates every entry through atomic claim/lease events instead of
    the serial loop.

    Continuous batching (``batch``: ``"off"``, ``"auto"`` or a job
    count; ``batch_window`` in milliseconds; ``serve/scheduler.py``) and
    the per-reference count cache (``count_cache``, a byte budget like
    ``"512M"``; env S2C_COUNT_CACHE when None; ``serve/countcache.py``)
    are the reference's.
    """

    def __init__(self, prewarm: str = "auto", decode_ahead: bool = True,
                 persistent_cache: bool = True,
                 echo: Optional[Callable] = None,
                 journal_dir: Optional[str] = None,
                 job_timeout: Optional[float] = None,
                 stall_timeout: Optional[float] = None,
                 max_queue: int = 0, tenant_quota: int = 0,
                 health_out: Optional[str] = None,
                 fault_inject: str = "",
                 telemetry_out: Optional[str] = None,
                 telemetry_port: Optional[int] = None,
                 telemetry_interval: Optional[float] = None,
                 slo=None,
                 profile_capture_dir: Optional[str] = None,
                 batch="off", batch_window: Optional[float] = None,
                 count_cache=None, mem_budget=None,
                 worker_id: str = "",
                 lease_ttl: Optional[float] = None,
                 verify_outputs: str = "fast",
                 device=None, mesh_devices=None):
        from ..backends.torch_backend import TorchBackend
        from ..kernels.build import BUILD_DIR
        from . import countcache as _ccache

        if prewarm not in ("auto", "off"):
            raise ValueError(f"prewarm={prewarm!r}: use 'auto' or 'off'")
        # capacity-priced admission (observability/memplane.py): a job
        # whose predicted peak exceeds the budget is shed with reason
        # "capacity" instead of being allowed to OOM the warm server.
        # Same size grammar as --count-cache; a typo fails the start.
        try:
            _mem_budget = _ccache.parse_budget(
                mem_budget if mem_budget is not None
                else os.environ.get("S2C_MEM_BUDGET"))
        except ValueError as exc:
            raise ValueError(str(exc).replace(
                "--count-cache", "--mem-budget")) from None
        if verify_outputs not in ("fast", "full"):
            raise ValueError(
                f"verify_outputs={verify_outputs!r}: use 'fast' "
                f"(skip-by-stat, re-hash on drift) or 'full' "
                f"(re-hash everything)")
        self.prewarm_mode = prewarm
        self.decode_ahead = decode_ahead
        self.echo = echo or (lambda *a, **k: None)
        self.backend = TorchBackend(device, mesh_devices)
        #: server-lifetime instruments (observability/telemetry.py
        #: AggregateRegistry): prewarm loads and launches land here
        #: (``compile/*``), the aggregate serve/* counters across the
        #: whole queue, and — folded in at every job end — each job's
        #: phase counters, gauges and histograms, plus the per-tenant
        #: SLO histograms
        self.registry = stele.AggregateRegistry()
        self.jobs_run = 0
        #: journal submit wall time per key (replay.submit_times for
        #: restarted queues, append time for fresh submissions) — the
        #: epoch the journal-measured queue wait counts from
        self._submit_unix: dict = {}
        #: accumulated run-attempt seconds — the live numerator of the
        #: sched/occupancy_ratio gauge (busy / uptime)
        self._busy_sec = 0.0
        self._prewarmed: set = set()
        self._prewarm_threads: list = []
        self._prewarm_stop = threading.Event()
        self.cache_dir = str(BUILD_DIR) if persistent_cache else None
        # -- survivability state --------------------------------------
        self.job_timeout = job_timeout if job_timeout is not None \
            else _env_float("S2C_JOB_TIMEOUT")
        self.stall_timeout = stall_timeout if stall_timeout is not None \
            else _env_float("S2C_STALL_TIMEOUT")
        # mesh scale-out capacity (hosts the fleet can dedicate to one
        # sharded job): the capacity gate plans instead of shedding, an
        # over-budget job admitted with a "needs K hosts" mesh_shards
        # verdict (observability/memplane.plan_mesh_shards)
        try:
            _mesh_hosts = int(os.environ.get("S2C_MESH_HOSTS", "0"))
        except ValueError:
            raise ValueError(
                "S2C_MESH_HOSTS must be an integer host count") from None
        self.admission = AdmissionController(
            max_queue=max_queue, tenant_quota=tenant_quota,
            mem_budget=_mem_budget, mesh_hosts=_mesh_hosts)
        # -- continuous batching (serve/scheduler.py) -----------------
        # a typo'd --batch must fail the server start, same discipline
        # as --slo / --fault-inject
        from .scheduler import BatchScheduler

        self.scheduler = BatchScheduler(self, batch=batch,
                                        window_ms=batch_window)
        #: the cohort driver's hooks (serve/cohort.py): the concordance
        #: tap each packed batch feeds its members' counts to, and the
        #: driver itself, whose progress the health snapshot reads
        self.count_tap = None
        self.cohort = None
        # -- incremental consensus (serve/countcache.py) ---------------
        # a typo'd budget fails the server start, same discipline as
        # --batch / --slo
        self.count_cache = _ccache.from_config(
            count_cache if count_cache is not None
            else os.environ.get("S2C_COUNT_CACHE"))
        self.health = shealth.HealthState()
        #: last finished job's tolerant-decode verdict, surfaced in the
        #: health snapshot (per-job history lives in each JobResult)
        self.last_job_badrec: Optional[dict] = None
        self.health_out = health_out
        self._fault = self._build_fault_injector(fault_inject)
        #: the next job's decode-ahead while the current job runs, and
        #: the gate the current job's first dispatch sets
        #: (``serve_dispatch_gate``; None when a packed batch runs
        #: between the two jobs and sets it instead)
        self._ahead: Optional[_DecodeAhead] = None
        self._ahead_gate = None
        #: the count-cache box of the attempt the next ``_execute``
        #: runs (``_plant_seed``; None for a job the cache does not see)
        self._next_capture = None
        self.verify_mode = verify_outputs
        self.journal: Optional[sjournal.JobJournal] = None
        if journal_dir:
            self.journal = sjournal.JobJournal(journal_dir,
                                               fault_cb=self._fault_check)
            if self.decode_ahead:
                # checkpoint consistency requires serial decode (the
                # stream offset snapshotted must match the batches
                # already committed to counts) — same contract that
                # makes the one-shot CLI serialize under
                # --checkpoint-dir.  Survivability buys it here.
                logger.info("journal mode: decode-ahead disabled "
                            "(per-job checkpoints need serial decode)")
                self.decode_ahead = False
        # -- fleet mode (serve/fleet.py): N workers, one journal -------
        from .fleet import FleetCoordinator, resolve_lease_ttl

        self.worker_id = str(worker_id or "")
        self.fleet: Optional[FleetCoordinator] = None
        if self.worker_id:
            if self.journal is None:
                raise ValueError(
                    "--worker-id requires --journal: the shared "
                    "journal IS the fleet's work-stealing queue")
            if self.scheduler.enabled:
                raise ValueError(
                    "--worker-id does not compose with --batch: "
                    "packed batches would need batch-level leases; "
                    "run fleet workers serial (the fleet IS the "
                    "parallelism)")
            if self.count_cache is not None:
                raise ValueError(
                    "--worker-id does not compose with --count-cache: "
                    "incremental jobs are already rejected on a "
                    "journaled server, so the cache could never be "
                    "consulted — configuring it would be a silent "
                    "no-op")
            ttl = resolve_lease_ttl(lease_ttl)
            self.fleet = FleetCoordinator(self.journal, self.worker_id,
                                          ttl, self.registry,
                                          verify_mode=self.verify_mode)
            self.registry.gauge("fleet/worker").set_info(
                {"worker": self.worker_id, "lease_ttl_sec": ttl})
            self._fleet_first_run_seen = False
            logger.info("fleet worker %r on journal %s (lease TTL "
                        "%gs)", self.worker_id, self.journal.root, ttl)
        # -- telemetry plane (observability/telemetry.py) --------------
        # strictly best-effort: every write path below degrades to the
        # per-job manifests (telemetry/write_failed counter + warning)
        # and never fails a job
        self.slo = dict(slo) if isinstance(slo, dict) \
            else stele.parse_slo(slo)
        self.telemetry_out = telemetry_out
        try:
            self.telemetry_interval = float(
                telemetry_interval if telemetry_interval is not None
                else os.environ.get("S2C_TELEMETRY_INTERVAL",
                                    stele.DEFAULT_INTERVAL_S))
        except ValueError:
            self.telemetry_interval = stele.DEFAULT_INTERVAL_S
        self._telemetry_last = 0.0
        #: profiler captures land next to the journal (the durable
        #: place an operator already looks), else next to the
        #: exposition file, else the cwd
        cap_dir = profile_capture_dir or \
            (self.journal.root if self.journal is not None else None) \
            or (os.path.dirname(telemetry_out) or "."
                if telemetry_out else ".")
        self.profiler = stele.ProfilerCapture(cap_dir,
                                              device=self.backend.device)
        self.profiler.install_signal()
        self.http: Optional[stele.TelemetryServer] = None
        if telemetry_port is not None:
            self.http = stele.TelemetryServer(
                self.render_telemetry, self.health_snapshot,
                port=telemetry_port)
            logger.info("telemetry endpoint on 127.0.0.1:%d "
                        "(/metrics, /healthz)", self.http.port)
        # -- evidence plane: rate card + burn monitor ------------------
        # the card learns per-worker throughput constants from finished
        # jobs; journaled servers persist it next to the journal so a
        # restart resumes with aged-but-confident estimates instead of
        # cold defaults.  A corrupt or stale card reads as absent (with
        # a counter) — it never fails a job.
        card_name = self.worker_id or "serve"
        if self.journal is not None:
            self.ratecard = rcard.RateCard.load(
                rcard.card_path(self.journal.root, card_name),
                worker=card_name, registry=self.registry)
        else:
            self.ratecard = rcard.RateCard(worker=card_name)
        rcard.install(self.ratecard)
        self.ratecard.publish(self.registry)
        self.registry.gauge("process/start_time_seconds").set(
            round(time.time(), 3))
        self.burn = BurnMonitor(self.registry)
        self.admission.burn_monitor = self.burn
        #: latest evidence-only scale hint (journaled servers); the
        #: drain episode tracker joins projected vs measured drain
        self.last_scale_hint: Optional[dict] = None
        self._drain_t0: Optional[float] = None
        self._drain_hint: Optional[dict] = None
        self._scale_hint_episodes = 0
        #: journal keys already fed to the burn monitor (local
        #: finalizes + fleet replay) — prevents double-counting when
        #: drain() replays this life's own commits
        self._burn_fed_keys: set = set()
        # a daemon thread killed mid-launch at interpreter exit can
        # abort the process from C++; close() stops the prewarm loop at
        # the next shape boundary and joins, so exit costs at most one
        # in-flight shape
        import atexit

        atexit.register(self.close)

    @staticmethod
    def _build_fault_injector(spec: str):
        from ..resilience.faultinject import FaultInjector, parse_spec

        spec = spec or os.environ.get("S2C_FAULT_INJECT", "")
        if not spec:
            return None
        try:
            rules = parse_spec(spec)
        except ValueError:
            # a malformed env spec is the backend's problem to report
            # (it validates per job); the runner-scope sites just stay
            # silent rather than double-raising
            return None
        seed = int(os.environ.get("S2C_FAULT_SEED", "0"))
        return FaultInjector(rules, seed=seed)

    def _fault_check(self, site: str) -> None:
        """Queue-lifetime injection for the serve-scope sites — call
        counts survive across jobs (the per-run injector resets per
        job, which would make ``journal_write:rpc:2`` meaningless)."""
        if self._fault is not None:
            self._fault.check(site)

    def close(self) -> None:
        """Stop background prewarm at the next shape boundary and wait
        for it, close the telemetry endpoint and an open profiler
        window; idempotent (also registered atexit — and unregistered
        here, so a closed runner is GC-able instead of pinned in the
        atexit table for the process lifetime)."""
        self._prewarm_stop.set()
        if getattr(self, "_ahead", None) is not None:
            self._ahead.cancel()        # a queue that raised mid-job
            self._ahead = None
        for t in self._prewarm_threads:
            if t.is_alive():
                t.join()
        self._prewarm_threads.clear()
        if self.http is not None:
            self.http.close()
            self.http = None
        profiler = getattr(self, "profiler", None)
        if profiler is not None:
            profiler.join()
        if getattr(self, "ratecard", None) is not None:
            if rcard.installed() is self.ratecard:
                rcard.install(None)
            try:
                self.ratecard.save()
            except Exception:
                pass
        import atexit

        try:
            atexit.unregister(self.close)
        except Exception:
            pass

    # -- prewarm ---------------------------------------------------------
    def prewarm(self, total_len: int, shapes, strategy: str = "pallas"
                ) -> int:
        """Run the default pileup route (or, ``strategy="mxu"``, the MXU
        route) for ``shapes`` (``(rows, width)`` pairs) against a genome
        of ``total_len`` positions, into the server's registry
        (``ops.pileup.prewarm_pileup``).  Idempotent per (total_len,
        shape, route)."""
        from ..ops.pileup import prewarm_pileup

        route = "mxu" if strategy == "mxu" else "pallas"
        todo = [s for s in shapes
                if (total_len, tuple(s), route) not in self._prewarmed]
        if not todo:
            return 0
        server_obs = obs.RunObservability(
            tracer=obs.tracer(), registry=self.registry,
            ledger=obs.DecisionLedger())
        with obs.bind_run_to_thread(server_obs):
            n = prewarm_pileup(total_len, todo, self.backend.device,
                               strategy=route)
        for s in todo:
            self._prewarmed.add((total_len, tuple(s), route))
        self.registry.add("compile/prewarm_shapes", n)
        logger.info("prewarmed %d pileup shape(s) for L=%d", n,
                    total_len)
        return n

    def _auto_prewarm(self, spec: JobSpec, total_len: int) -> None:
        """First-job prewarm, hidden behind its decode: the canonical
        shapes on a thread.  Device-pileup jobs only — a host-routed
        pileup launches no K1 to warm."""
        from ..encoder.events import resolve_segment_width
        from ..ops.pileup import canonical_slab_shapes

        if self.prewarm_mode != "auto":
            return
        if spec.config.pileup not in ("scatter", "pallas", "mxu"):
            # --pileup auto resolves per job inside the backend (host
            # vs device by the placement gate) — a host-routed job
            # launches nothing to warm, so auto-prewarm only engages
            # for explicitly device-pinned pileups.  Say so: a silent
            # no-op here reads as "prewarm is broken".
            logger.info(
                "prewarm skipped: --pileup %s (auto-prewarm engages "
                "for explicit device pileups scatter/pallas/mxu; use "
                "ServeRunner.prewarm() for manual shape control)",
                spec.config.pileup)
            return
        shapes = canonical_slab_shapes(
            total_len, chunk_reads=spec.config.chunk_reads,
            segment_width=resolve_segment_width(
                getattr(spec.config, "segment_width", 0)))

        def _worker():
            # one shape per prewarm() call so close() can stop the loop
            # at a shape boundary
            for shape in shapes:
                if self._prewarm_stop.is_set():
                    return
                self.prewarm(total_len, [shape], spec.config.pileup)

        t = threading.Thread(target=_worker, name="serve-prewarm",
                             daemon=True)
        t.start()
        self._prewarm_threads.append(t)

    # -- per-job export destinations -------------------------------------
    def _job_out(self, cfg_value: Optional[str], env_name: str,
                 jobnum: int) -> Optional[str]:
        """A job's metrics/trace destination.  An explicit per-job
        config value wins untouched; an ENV-derived base (S2C_*_OUT)
        is suffixed per job — without this, every serve job would
        resolve to the same env path inside prepare_run and overwrite
        the previous job's artifacts (mode 'w' exports).  ``jobnum``
        is the job's absolute number across the server's lifetime."""
        if cfg_value:
            return cfg_value
        env = os.environ.get(env_name)
        if env:
            return f"{env}.job{jobnum}"
        return None

    # -- job validation --------------------------------------------------
    def _validate(self, spec: JobSpec) -> None:
        # typed up-front checks (parallel.mesh.MeshCapacityError): a
        # --shards over the mesh's device list, or with the host pileup,
        # rejects at admission, not after the queue is journaled
        from ..parallel.mesh import available_devices, validate_shards

        validate_shards(spec.config.shards,
                        n_available=available_devices(
                            self.backend.mesh_devices),
                        pileup=spec.config.pileup)
        if self.journal is not None:
            # journal mode injects a per-job checkpoint_dir, and BAM
            # inputs do not support checkpoint resume yet — failing the
            # QUEUE up front beats journaling every such job failed
            # twice (first attempt + host-rung retry)
            fmt = getattr(spec.config, "input_format", "auto")
            if fmt == "auto" and os.path.exists(spec.filename):
                from ..formats import detect_format

                try:
                    fmt = detect_format(spec.filename)
                except OSError:
                    pass
            if fmt == "bam":
                raise ValueError(
                    f"--journal checkpoints every job, and BAM input "
                    f"{spec.filename!r} does not support checkpoint "
                    f"resume yet — convert it to SAM/SAM.gz or run the "
                    f"queue without --journal")
        if spec.config.checkpoint_dir:
            raise ValueError(
                "serve mode does not compose with --checkpoint-dir: "
                "checkpoints need serial decode with stream-consistent "
                "snapshots, which decode-ahead breaks; use --journal "
                "for crash-safe serving (the runner manages per-job "
                "checkpoints itself) or run checkpointed jobs through "
                "the one-shot CLI")
        if spec.config.incremental:
            # incremental IS a serve feature — but only through the
            # count cache (the checkpoint-file flavor needs serial
            # decode + a --checkpoint-dir, which serve rejects above)
            if self.count_cache is None:
                raise ValueError(
                    "incremental serve jobs need the per-reference "
                    "count cache: start the server with --count-cache "
                    "SIZE (e.g. 512M) or S2C_COUNT_CACHE")
            if self.journal is not None:
                raise ValueError(
                    "--journal injects a per-job checkpoint home, "
                    "which conflicts with count-cache seeding (two "
                    "sources of resumable state); run incremental "
                    "jobs on an unjournaled server")

    # -- health -----------------------------------------------------------
    def health_snapshot(self) -> dict:
        return shealth.snapshot(self)

    def _publish_health(self) -> None:
        if self.health_out:
            try:
                shealth.write_health(self.health_out,
                                     self.health_snapshot())
            except Exception as exc:
                self.registry.add("telemetry/write_failed", 1)
                logger.warning("health snapshot write failed: %s", exc)

    # -- telemetry plane ---------------------------------------------------
    def _update_live_gauges(self) -> None:
        """Refresh the heartbeat-aged liveness gauges from runner state
        — the mid-job signal that makes a hung job visible WHILE it
        hangs (the per-job registries only fold in at job end)."""
        h = self.health
        now = time.monotonic()
        reg = self.registry
        reg.gauge("serve/up").set(1.0)
        reg.gauge("serve/uptime_sec").set(
            round(now - h._started_mono, 3))
        reg.gauge("serve/queue_depth").set(float(h.queue_depth))
        reg.gauge("serve/heartbeat_age_sec").set(
            round(now - h.last_beat, 3))
        # single read before the None test: HTTP scrape threads call
        # this concurrently with job_finished() clearing the field
        since = h.in_flight_since
        reg.gauge("serve/inflight_age_sec").set(
            round(now - since, 3) if since is not None else 0.0)
        if self.fleet is not None:
            reg.gauge("fleet/leases_held").set(
                float(len(self.fleet.held)))
        # occupancy: fraction of serve uptime spent in run attempts
        uptime = now - h._started_mono
        reg.gauge("sched/occupancy_ratio").set(
            round(self._busy_sec / uptime, 4) if uptime > 0 else 0.0)

    def render_telemetry(self) -> str:
        """The OpenMetrics exposition over the server-lifetime
        aggregate, gauges refreshed first — an HTTP scrape between
        watchdog ticks still sees current heartbeat ages."""
        self._update_live_gauges()
        return stele.render_openmetrics(
            self.registry.snapshot(),
            worker=self.worker_id or None,
            restart_epoch=self.ratecard.restarts
            if self.worker_id else None)

    def telemetry_tick(self, force: bool = False) -> None:
        """One heartbeat of the telemetry plane, driven from the
        watchdog poll loop and (``force=True``) every job boundary:
        refresh liveness gauges, honor a pending profiler-capture
        request, and — on the configured cadence — atomically rewrite
        the exposition file AND the health snapshot (one shared
        writer, so ``--health-out`` is no longer frozen while a job
        hangs under ``--job-timeout``).  Host counters only: nothing
        here waits on the device.  Every failure degrades to the
        per-job manifests: counted, warned, never raised."""
        self._update_live_gauges()
        if self.fleet is not None:
            # lease duty cycle rides the same heartbeat: renew what we
            # hold, reap what peers abandoned (serve/fleet.py)
            self.fleet.tick()
        if self.profiler.pending():
            path = self.profiler.capture(
                tracer=obs.tracer(), registry=self.registry,
                context={"in_flight": self.health.in_flight,
                         "queue_depth": self.health.queue_depth})
            if path is not None:
                self.registry.add("telemetry/profile_captures", 1)
                self.registry.gauge("telemetry/last_profile").set_info(
                    {"path": path, "in_flight": self.health.in_flight})
        try:
            self.burn.tick()
        except Exception as exc:     # alerting is derived state
            logger.warning("burn tick failed: %s", exc)
        now = time.monotonic()
        if not force and now - self._telemetry_last \
                < self.telemetry_interval:
            return
        self._telemetry_last = now
        # rate-card cadence work: refresh the exported gauges, persist
        # the card (journaled servers), and recompute the evidence-only
        # scale hint.  All best-effort — the card never fails a job.
        try:
            self.ratecard.publish(self.registry)
            if self.ratecard.path:
                self.ratecard.save()
        except Exception as exc:
            self.registry.add("rate/card_write_failed", 1)
            logger.warning("rate card persist failed: %s", exc)
        if self.journal is not None:
            try:
                self._scale_hint_tick()
            except Exception as exc:
                logger.warning("scale hint tick failed: %s", exc)
        # low-rate watermark sampler (observability/memplane.py): rides
        # the telemetry cadence, so a mid-hang scrape of the exposition
        # or health file shows memory too (the device's allocator bytes
        # read from its statistics, no synchronisation)
        from ..observability import memplane

        memplane.sample(self.registry, device=self.backend.device)
        if self.telemetry_out:
            try:
                stele.atomic_write_text(self.telemetry_out,
                                        self.render_telemetry())
            except Exception as exc:
                self.registry.add("telemetry/write_failed", 1)
                logger.warning(
                    "telemetry exposition write failed (%s: %s) — "
                    "degrading to per-job manifests",
                    type(exc).__name__, exc)
        self._publish_health()

    # -- scale-hint evidence plane (observability/ratecard.py) -------------
    def _scale_hint_tick(self) -> None:
        """Recompute the evidence-only scale hint from every persisted
        rate card in the journal root (own card live, others read-only
        from disk), the burn plane's alert states, and the live queue
        depth.  Publishes ``fleet/scale_hint`` and tracks drain
        episodes: when the queue empties, the hint that opened the
        episode is joined against the measured drain time as a band=0
        ``scale_hint`` ledger decision.  No actuation."""
        import glob as _glob

        cards = [self.ratecard.snapshot()]
        own = os.path.basename(self.ratecard.path or "")
        for p in sorted(_glob.glob(os.path.join(
                self.journal.root, "ratecard-*.json"))):
            if os.path.basename(p) == own:
                continue
            peer = rcard.RateCard.load(p)
            if peer.restarts or peer.snapshot()["rates"]:
                cards.append(peer.snapshot())
        workers = max(1, len(cards)) if self.worker_id else 1
        hint = rcard.compute_scale_hint(
            cards, queue_depth=self.health.queue_depth,
            workers=workers, burn_states=self.burn.states())
        self.last_scale_hint = hint
        g = self.registry.gauge("fleet/scale_hint")
        g.set(float(hint["delta"]))
        g.set_info(hint)
        # drain-episode join: projected (at queue-open) vs measured
        now = time.monotonic()
        if self.health.queue_depth > 0 and self._drain_t0 is None \
                and hint.get("projected_drain_sec") is not None:
            self._drain_t0 = now
            self._drain_hint = hint
        elif self.health.queue_depth == 0 \
                and self._drain_t0 is not None:
            measured = now - self._drain_t0
            opened = self._drain_hint
            self._drain_t0 = None
            self._drain_hint = None
            if opened is not None:
                self._join_scale_hint(opened, measured)

    def _join_scale_hint(self, hint: dict, measured_sec: float) -> None:
        """Hindsight-join one drain episode: the hint's projected
        drain vs the wall-clock measured drain, as a band=0
        ``scale_hint`` decision in an episode-scoped ledger (the
        per-run ledgers finalize at backend end — an episode spans
        runs).  The residual gauges mirror into the server registry so
        the exposition carries them."""
        from ..observability.ledger import finalize as _finalize

        led = obs.DecisionLedger()
        led.record(
            "scale_hint", hint["verdict"], inputs=hint,
            predicted={"drain_sec": hint["projected_drain_sec"]},
            measured={"drain_sec": {
                "counters": ["fleet/drain_measured_sec"]}},
            band=0)
        ep = MetricsRegistry()
        ep.add("fleet/drain_measured_sec", round(measured_sec, 3))
        _finalize(led, ep)
        for name in ("residual/scale_hint", "residual/scale_hint/"
                     "drain_sec"):
            src = ep.gauge(name)
            dst = self.registry.gauge(name)
            dst.set(src.value)
            if getattr(src, "info", None):
                dst.set_info(dict(src.info))
        self._scale_hint_episodes += 1
        self.registry.add("fleet/drain_episodes", 1)
        self.registry.gauge("fleet/drain_measured_sec").set(
            round(measured_sec, 3))

    def note_fleet_burn(self, replay) -> None:
        """Feed peer-committed SLO breaches from a journal replay into
        the windowed burn monitor WITH their commit stamps — an old
        breach ages out of the fast/slow windows naturally, unlike the
        lifetime ``slo_burn_by_tenant`` dict it complements.  Keys this
        life already observed locally are skipped (no double count)."""
        obj = self.slo.get("e2e")
        if obj is None or replay is None:
            return
        for key, rec in getattr(replay, "committed", {}).items():
            if key in self._burn_fed_keys:
                continue
            self._burn_fed_keys.add(key)
            elapsed = rec.get("elapsed_sec")
            if elapsed is None:
                continue
            stamp = float(rec.get("t", 0.0)) or None
            try:
                self.burn.observe_job(
                    rec.get("tenant") or "default", evaluated=1,
                    violated=1 if float(elapsed) > obj else 0,
                    now=stamp)
            except Exception:
                continue

    def _telemetry_job_end(self, robs, res: JobResult, snap: dict,
                           tenant: str, queue_wait: float) -> None:
        """Job-boundary telemetry: fold the job's registry into the
        server-lifetime aggregate, observe its per-phase latency into
        the tenant's SLO histograms, burn violation counters, and feed
        the verdict into the job's manifest ``serve.slo`` section (the
        manifest file is rewritten in place when the job exported
        one)."""
        try:
            self.registry.fold(robs.registry, job_id=res.job_id,
                               tenant=tenant)
        except Exception as exc:     # aggregation is derived state
            self.registry.add("telemetry/fold_failed", 1)
            logger.warning("telemetry fold failed for %s: %s",
                           res.job_id, exc)
        phases = stele.slo_phase_seconds(snap["counters"],
                                         res.elapsed_sec, queue_wait)
        tlabel = tenant or "default"
        violated = []
        for ph, sec in phases.items():
            self.registry.observe(f"slo/{tlabel}/{ph}", sec)
            obj = self.slo.get(ph)
            if obj is not None and sec > obj:
                violated.append(ph)
                self.registry.add("slo/violations", 1)
                self.registry.add(f"slo/violations/{tlabel}/{ph}", 1)
        evaluated = [ph for ph in phases
                     if self.slo.get(ph) is not None]
        if evaluated:
            # windowed burn view: one observation per job under the
            # same label, stamped now — the fast/slow ratios the alert
            # state machine reads (observability/burn.py)
            try:
                self.burn.observe_job(tlabel, evaluated=len(evaluated),
                                      violated=len(violated))
            except Exception:
                pass
        if violated:
            # burn under the SAME label the exposition/manifest use
            # ("default" for untenanted jobs) so an operator can
            # cross-reference the two surfaces key-for-key
            self.admission.note_slo(tlabel, len(violated))
            logger.warning(
                "job %s breached SLO objective(s) %s "
                "(phases %s vs objectives %s)", res.job_id,
                ",".join(violated),
                {k: round(v, 3) for k, v in phases.items()}, self.slo)
        verdict = {
            "job": res.job_id, "tenant": tlabel,
            "phases_sec": {k: round(v, 4) for k, v in phases.items()},
            "objectives_sec": dict(self.slo),
            "violated": violated,
            "burn": {ph: int(self.registry.value(
                f"slo/violations/{tlabel}/{ph}"))
                for ph in stele.SLO_PHASES
                if self.registry.value(
                    f"slo/violations/{tlabel}/{ph}")},
        }
        self.registry.gauge("slo/last_job").set_info(verdict)
        if res.manifest is not None:
            res.manifest.setdefault("serve", {})["slo"] = verdict
            if robs.metrics_out:
                from ..observability import manifest as _manifest

                try:
                    _manifest.write_manifest(
                        _manifest.manifest_path_for(robs.metrics_out),
                        res.manifest)
                except Exception as exc:
                    self.registry.add("telemetry/write_failed", 1)
                    logger.warning("manifest slo rewrite failed: %s",
                                   exc)

    # -- trace context -----------------------------------------------------
    def _stamp_trace(self, robs, entry: dict) -> None:
        """Propagate the job's trace-context onto every artifact this
        run will export: ``trace_id`` (= the journal key) into the
        tracer's meta and the same identity as the ``sched/trace`` info
        gauge, so the metrics JSONL and the manifest carry it too.  The
        job id stands in for the key on a journal-less server."""
        from ..observability import flight

        key = entry.get("key")
        info = {"trace_id": flight.trace_id(key) if key
                else entry["job_id"],
                "key": key or "", "job": entry["job_id"]}
        if self.worker_id:
            info["worker"] = self.worker_id
        tr = getattr(robs, "tracer", None)
        if tr is not None and hasattr(tr, "meta"):
            tr.meta.update(info)
        robs.registry.gauge("sched/trace").set_info(info)

    def _sched_lifecycle(self, entry: dict, window_queue_wait: float):
        """The job's journal-measured lifecycle numbers, as stamped
        into its manifest ``lifecycle`` section.  Returns
        ``(lifecycle_dict, journal_queue_wait_or_None)`` — the journal
        number (started append wall time minus the key's FIRST
        submitted wall time) is the queue-wait truth source when a
        journal is present; the window-epoch measure rides along as
        ``window_queue_wait_sec`` so the two stay cross-checkable."""
        from ..observability import flight

        key = entry.get("key")
        lc: dict = {
            "trace_id": flight.trace_id(key) if key
            else entry["job_id"],
            "key": key or "",
            "worker": self.worker_id or "",
            "window_queue_wait_sec": round(
                max(0.0, window_queue_wait), 4)}
        sub = self._submit_unix.get(key) if key else None
        started = entry.get("started_unix")
        journal_qw = None
        if sub is not None:
            lc["submit_unix"] = sub
        if started is not None:
            lc["started_unix"] = started
        if sub is not None and started is not None:
            journal_qw = max(0.0, started - sub)
            lc["queue_wait_sec"] = round(journal_qw, 4)
        if self.fleet is not None and key:
            cu = self.fleet.claim_unix.get(key)
            if cu is not None and sub is not None:
                lc["claim_latency_sec"] = round(
                    max(0.0, cu - sub), 4)
            sg = self.fleet.steal_gaps.get(key)
            if sg is not None:
                lc["steal_latency_sec"] = round(sg, 4)
                lc["stolen"] = True
        return lc, journal_qw

    # -- journal helpers ---------------------------------------------------
    def _journal_append(self, ev: str, **fields) -> None:
        """Append, absorbing write failures: a journal that cannot be
        written must not kill the job whose work it records.  The safe
        direction is re-RUNNING work on restart (a missing commit means
        the job re-runs and re-fingerprints, byte-identical), never
        skipping it — so append failures degrade durability, not
        correctness, and they are loudly counted."""
        if self.journal is None:
            return
        try:
            self.journal.append(ev, **fields)
        except Exception as exc:
            self.registry.add("serve/journal_write_failed", 1)
            logger.warning("journal append %s failed (%s: %s): the job "
                           "will re-run on restart instead of resuming",
                           ev, type(exc).__name__, exc)

    # -- guarded execution (watchdog) --------------------------------------
    def _execute(self, contigs, records, cfg, robs,
                 dlog: List[Tuple[float, float]], job_id: str):
        """Run one job through the backend — directly when no watchdog
        is configured (zero extra threads), else on a monitored worker
        thread.

        The monitor enforces two independent bounds: total wall clock
        (``job_timeout`` -> JobDeadlineExceeded) and dispatch-heartbeat
        age (``stall_timeout`` -> HungDispatchError), the heartbeat
        being the newest dispatch-interval end in ``dlog`` — the log
        the runner already keeps for the overlap join.  The poll reads
        host state only.  On timeout the worker is ABANDONED (daemon):
        a wedged dispatch cannot be interrupted from Python, only
        disowned.  The abandoned thread keeps ITS job's instruments
        thread-bound (``bind_run_to_thread``) and its own accumulator,
        so if it ever wakes it records into its own registry and counts
        into its own tensor, never the next job's; its result lands in
        a box no one reads, so a fleet job it belonged to is never
        committed from it.  Fleet mode always takes the monitored path:
        the poll's ``telemetry_tick`` renews this worker's leases
        mid-job (no deadline is enforced unless one is set).  An incremental
        job's count-cache box (``_next_capture``, set by the caller just
        before this call) is taken here, on the runner's thread, and
        handed to the attempt's ``run`` as an argument, so an abandoned
        attempt writes only its own box."""
        from ..resilience.policy import (HungDispatchError,
                                         JobDeadlineExceeded)

        capture, self._next_capture = self._next_capture, None

        self.backend.serve_prepared_obs = robs
        self.backend.serve_dispatch_log = dlog
        self.backend.serve_dispatch_gate = self._ahead_gate
        try:
            if self.job_timeout is None and self.stall_timeout is None \
                    and self.fleet is None:
                return self.backend.run(contigs, records, cfg,
                                        count_capture=capture)

            box: list = []

            log_ctx = stele.get_log_context()

            def work():
                stele.set_log_context(**log_ctx)
                with obs.bind_run_to_thread(robs):
                    try:
                        box.append(("ok", self.backend.run(
                            contigs, records, cfg,
                            count_capture=capture)))
                    except BaseException as exc:
                        box.append(("exc", exc))

            t = threading.Thread(target=work, daemon=True,
                                 name=f"serve-job-{job_id}")
            start = time.perf_counter()
            beats_seen = 0
            t.start()
            while t.is_alive() and not box:
                t.join(WATCHDOG_POLL_S)
                if box:
                    break               # finished during the poll: a
                    # result beats a deadline that expired in the race
                # mid-job telemetry heartbeat: liveness gauges, the
                # exposition/health cadence writer, and profiler-
                # capture triggers all ride the watchdog poll — a hung
                # dispatch is visible (and profileable) WHILE it hangs
                self.telemetry_tick()
                now = time.perf_counter()
                last = dlog[-1][1] if dlog else start
                if len(dlog) > beats_seen:
                    # beat only on NEW dispatch completions — a wedged
                    # job's published heartbeat age must GROW (the
                    # signature health.py documents for probers)
                    beats_seen = len(dlog)
                    self.health.beat()
                if (self.job_timeout is not None
                        and now - start > self.job_timeout):
                    raise JobDeadlineExceeded(
                        f"job {job_id} exceeded its "
                        f"{self.job_timeout:.3g}s deadline "
                        f"({len(dlog)} dispatches completed)")
                if (self.stall_timeout is not None
                        and now - max(last, start) > self.stall_timeout):
                    raise HungDispatchError(
                        f"job {job_id}: no dispatch heartbeat for "
                        f"{now - max(last, start):.1f}s "
                        f"(stall budget {self.stall_timeout:.3g}s, "
                        f"{len(dlog)} dispatches completed)")
            if not box:
                t.join()
            tag, val = box[0]
            if tag == "exc":
                raise val
            return val
        finally:
            self.backend.serve_prepared_obs = None
            self.backend.serve_dispatch_log = None
            self.backend.serve_dispatch_gate = None

    def _join_ahead(self, ahead: "_DecodeAhead",
                    stall_t: Optional[float]) -> None:
        """Wait for a decode-ahead thread, declaring it wedged only
        when it stops MAKING PROGRESS (no new decoded batch) for
        ``stall_t`` — a large input decoding steadily is not a hang,
        however long it takes.  ``stall_t`` None = wait forever (no
        watchdog configured)."""
        if stall_t is None:
            ahead.thread.join()
            return
        last_n = -1
        last_progress = time.perf_counter()
        while ahead.thread.is_alive():
            ahead.thread.join(min(0.5, stall_t / 4))
            self.telemetry_tick()       # a wedged decode is mid-job too
            n = len(ahead.intervals())
            now = time.perf_counter()
            if n != last_n:
                last_n = n
                last_progress = now
            elif now - last_progress > stall_t:
                return                   # caller sees is_alive() == True

    def _note_timeout(self, robs, exc, server: bool = True) -> None:
        robs.registry.add("serve/watchdog_timeouts", 1)
        robs.registry.gauge("serve/watchdog").set_info(
            {"error": f"{type(exc).__name__}: {exc}",
             "job_timeout_s": self.job_timeout,
             "stall_timeout_s": self.stall_timeout})
        if server:               # once per timeout, not once per registry
            self.registry.add("serve/watchdog_timeouts", 1)

    def _prepare(self, cfg, jobnum: int, suffix: str = ""):
        """A job's instruments (``observability.prepare_run``) at its
        per-job export destinations."""
        def dest(value, env):
            p = self._job_out(value, env, jobnum)
            return f"{p}{suffix}" if p and suffix else p

        return obs.prepare_run(
            trace_out=dest(cfg.trace_out, "S2C_TRACE_OUT"),
            metrics_out=dest(cfg.metrics_out, "S2C_METRICS_OUT"),
            config=cfg)

    # -- the queue -------------------------------------------------------
    def submit_jobs(self, specs: List[JobSpec]) -> List[JobResult]:
        """Run the queue; returns one :class:`JobResult` per spec, in
        order.  The server survives failed jobs (their error rides the
        result) and stays warm afterwards for the next submit."""
        for spec in specs:
            self._validate(spec)

        # -- plan: admission + journal replay, before anything runs ---
        replay = self.journal.replay() if self.journal is not None \
            else None
        if self.fleet is None and replay is not None \
                and replay.claimed_ever:
            # commits on ever-claimed keys are lease-fenced: a
            # worker-less server's commits on them would be VOID on
            # replay (it can hold no lease) — refuse loudly instead
            # of running jobs whose commits silently never land
            raise ValueError(
                "this journal has fleet claim/lease history "
                f"({len(replay.claimed_ever)} claimed key(s)): "
                "restart with --worker-id so commits carry the lease "
                "lineage the journal now enforces")
        self.admission.open_window()
        if self.fleet is not None and replay is not None:
            # fleet-global quotas: peers' journal-visible live jobs
            # count against this window's per-tenant quota too
            self.admission.seed_window(self.fleet.seed_window_counts(
                replay, {sjournal.job_key(s.filename, s.config)
                         for s in specs}))
        jobs_base = self.jobs_run
        plan: List[dict] = []           # one entry per spec, in order
        n_skipped = 0
        inflight_resumed: List[str] = []
        for j, spec in enumerate(specs):
            jobnum = jobs_base + j
            job_id = spec.job_id or \
                f"job{jobnum}:{os.path.basename(spec.filename)}"
            key = sjournal.job_key(spec.filename, spec.config) \
                if self.journal is not None else None
            entry = {"spec": spec, "job_id": job_id, "key": key,
                     "jobnum": jobnum, "action": "run", "cfg": spec.config,
                     "admission": None, "resume_ckpt": False}
            if replay is not None and key in replay.committed \
                    and self.journal.verify_outputs(
                        replay.committed[key], mode=self.verify_mode):
                entry["action"] = "skip"
                entry["outputs"] = \
                    list(replay.committed[key].get("outputs", {}))
                n_skipped += 1
                plan.append(entry)
                continue
            # capacity signal (observability/memplane.py): only priced
            # when a --mem-budget is set — the header probe is the batch
            # scheduler's, whose handle a later pack/decode reuses
            predicted = None
            shard_plan = None
            if self.admission.mem_budget:
                total_len = self.scheduler._probe_total_len(entry)
                if total_len:
                    from ..observability import memplane

                    predicted = memplane.predict_job_peak_bytes(
                        total_len, spec.config)
                    entry["mem_predicted"] = predicted
                    if (predicted > self.admission.mem_budget
                            and self.admission.mesh_hosts > 1):
                        # the memory plane as planner: price the job per
                        # host across K hosts and admit it with a "needs
                        # K hosts" verdict when it fits the fleet, instead
                        # of shedding it (the mesh_shards decision records
                        # the choice and its alternatives); the job itself
                        # still runs on this server's mesh
                        shard_plan = memplane.plan_mesh_shards(
                            total_len, spec.config,
                            budget_bytes=self.admission.mem_budget,
                            max_hosts=self.admission.mesh_hosts)
                if not self.scheduler.enabled:
                    # without batching nothing downstream reuses the
                    # probe handle: close it now, or a wide submission
                    # holds one open file per probed spec
                    self._close_probe(entry)
            dec = self.admission.admit(spec.tenant,
                                       predicted_bytes=predicted,
                                       shard_plan=shard_plan)
            if dec.admitted and dec.mesh_shards:
                entry["mesh_shards"] = dec.mesh_shards
                self.registry.add("serve/admission_mesh", 1)
                self.registry.gauge("mesh/planned_hosts").set(
                    dec.mesh_shards)
            if not dec.admitted:
                entry["action"] = "reject"
                entry["admission"] = dec.reason
                if dec.reason == "capacity":
                    self.registry.add("serve/admission_capacity", 1)
                    self._close_probe(entry)
                plan.append(entry)
                continue
            cfg = spec.config
            if getattr(cfg, "on_bad_record", "fail") == "quarantine" \
                    and not getattr(cfg, "quarantine_out", None):
                # default sidecar naming keyed on the job's UNIQUE
                # server-lifetime number, not on outfolder+prefix: two
                # jobs over the same upload must never clobber each
                # other's evidence files.  An explicit --quarantine-out
                # wins untouched (the CLI already stamps its own .jobN).
                cfg = dataclasses.replace(cfg, quarantine_out=os.path.join(
                    cfg.outfolder or "./",
                    f"{cfg.prefix or 'quarantine'}_quarantine"
                    f".job{jobnum}.jsonl"))
            if self.journal is not None:
                cfg = dataclasses.replace(
                    cfg, checkpoint_dir=self.journal.ckpt_dir(key))
                if replay is not None and key in replay.inflight:
                    entry["resume_ckpt"] = True
                    inflight_resumed.append(job_id)
            entry["cfg"] = cfg
            plan.append(entry)

        # durable queue: every to-run job is journaled as submitted
        # BEFORE anything executes, so a crash during job 0 still
        # remembers the whole queue
        if self.journal is not None:
            already = replay.submitted if replay is not None else set()
            if replay is not None:
                # restarted queue: prior submissions keep their
                # ORIGINAL journal submit time — a job's queue wait
                # spans the crash, which is exactly the point of
                # measuring it from the journal instead of the window
                self._submit_unix.update(replay.submit_times)
            for entry in plan:
                if entry["action"] == "run" \
                        and entry["key"] not in already:
                    self._journal_append(
                        "submitted", job=entry["job_id"],
                        key=entry["key"],
                        filename=os.path.abspath(
                            entry["spec"].filename),
                        outfolder=entry["spec"].config.outfolder,
                        tenant=entry["spec"].tenant or "",
                        **({"mesh_shards": entry["mesh_shards"]}
                           if entry.get("mesh_shards") else {}))
                    # mirror of the append's own stamp (same clock,
                    # same 1 ms rounding) — saves a replay per job
                    self._submit_unix.setdefault(
                        entry["key"], round(time.time(), 3))
            for entry in plan:
                if entry["action"] == "skip":
                    self._journal_append("resumed", job=entry["job_id"],
                                         key=entry["key"],
                                         mode="skipped")
                elif entry["resume_ckpt"]:
                    self._journal_append("resumed", job=entry["job_id"],
                                         key=entry["key"],
                                         mode="inflight")
                elif entry["action"] == "reject":
                    self._journal_append("rejected", job=entry["job_id"],
                                         key=entry["key"],
                                         reason=entry["admission"])
        recovery_info = None
        if replay is not None and replay.events:
            recovery_info = {
                "resumed": True,
                "journal_last_seq": replay.last_seq,
                "committed_skipped": n_skipped,
                "inflight_resumed": inflight_resumed,
            }
            self.registry.gauge("serve/recovery").set_info(recovery_info)
            self.registry.add("serve/resume_skipped", n_skipped)
            self.registry.add("serve/resume_inflight",
                              len(inflight_resumed))

        self.health.queue_depth = sum(1 for e in plan
                                      if e["action"] == "run")
        #: queue-wait epoch: every job's SLO queue_wait is measured
        #: from here — the wall time a submission spent behind earlier
        #: jobs of its own window (a hung job inflates every
        #: successor's queue_wait, which is exactly the signal)
        window_t0 = time.perf_counter()
        self.telemetry_tick(force=True)

        # -- fleet mode (serve/fleet.py): claim/lease arbitration over
        #    the shared journal replaces the serial loop — this worker
        #    runs the entries whose leases it wins, observes peers'
        #    commits for the rest, and steals expired leases
        if self.fleet is not None:
            for e in plan:
                self._close_probe(e)
            try:
                return self.fleet.drain(self, plan, window_t0, replay,
                                        recovery_info)
            finally:
                self.scheduler.release_handles(plan)
                self.telemetry_tick(force=True)

        # -- continuous batching (serve/scheduler.py): compose packed
        #    batches over the eligible small jobs up front; the loop
        #    below runs each batch when it reaches the batch's first
        #    member and routes demoted members back through the serial
        #    path
        batch_results: dict = {}
        batch_by_first: dict = {}
        batched: set = set()
        if self.scheduler.enabled:
            for b in self.scheduler.compose(plan):
                batch_by_first[b.indices[0]] = b
                batched.update(b.indices)
            # entries probed but not packed must not leak their probe
            # handles (the packed ones are consumed by the decode phase)
            for j, e in enumerate(plan):
                if j not in batched:
                    self._close_probe(e)
            if batched:
                logger.info("continuous batching: %d job(s) in %d "
                            "batch(es)", len(batched),
                            len(batch_by_first))

        results: List[JobResult] = []
        try:
            self._drain(plan, results, batch_results, batch_by_first,
                        batched, replay, recovery_info, window_t0)
        finally:
            self.scheduler.release_handles(plan)  # no probe-handle leaks
        self.telemetry_tick(force=True)
        return results

    def _close_probe(self, entry: dict) -> None:
        """Close the header probe's handle left on ``entry``, if any."""
        ai = entry.pop("batch_handle", None)
        if ai is not None:
            ai.close()

    def _drain(self, plan: List[dict], results: List[JobResult],
               batch_results: dict, batch_by_first: dict, batched: set,
               replay, recovery_info, window_t0: float) -> None:
        """The queue's loop over the plan, in order: a packed batch at
        its first member (:meth:`BatchScheduler.run_batch`), else the
        serial path with decode-ahead of the next serial entry."""
        from ..config import resolve_decode_threads
        from ..formats import open_alignment_input
        from ..resilience import ladder as rladder
        from ..wire.pipeline import intersect_sec

        def after_batch(i: int, k: int) -> bool:
            """A packed batch runs between plan entries ``i`` and ``k``."""
            return any(j in batch_by_first for j in range(i + 1, k))

        ahead: Optional[_DecodeAhead] = None
        ahead_for: Optional[int] = None
        cap = _ahead_batch_cap()
        first_run_seen = False
        for i, entry in enumerate(plan):
            if i in batch_results:
                results.append(batch_results.pop(i))
                continue
            b = batch_by_first.pop(i, None)
            if b is not None:
                done, leftovers = self.scheduler.run_batch(
                    b, plan, window_t0,
                    gate=ahead.gate if ahead is not None else None)
                if ahead is not None:
                    # the batch dispatched (or was demoted): the next
                    # serial job's decode-ahead runs now at the latest
                    ahead.release()
                batch_results.update(done)
                for k in leftovers:
                    batched.discard(k)  # serial re-run when reached
                if i in batch_results:
                    results.append(batch_results.pop(i))
                    continue
                # i itself demoted: fall through to the serial path
            spec = entry["spec"]
            job_id = entry["job_id"]
            cfg = entry["cfg"]
            jobnum = entry["jobnum"]
            # -- non-running entries -----------------------------------
            if entry["action"] in ("skip", "reject"):
                results.append(self._resolve_nonrun(entry, i))
                continue
            self.registry.add("serve/admission_admitted", 1)
            # degraded-tenant isolation, decided at JOB-START time (a
            # tenant degraded by the previous job of this very batch
            # must already be pinned): the job runs, but on the rung
            # its tenant already proved it needs — never on the
            # device path
            rung = self.admission.pin_rung(spec.tenant)
            if rung is not None and cfg.pileup != "host":
                cfg = rladder.job_host_rung_config(cfg)
                entry["cfg"] = cfg
                entry["admission"] = f"pinned:{rung}"
            if entry["admission"]:       # pinned:<rung>
                self.registry.add("serve/admission_pinned", 1)
            # -- job context: from the decode-ahead thread, or inline --
            close_handle = None
            contigs = records = None
            header_err = None
            robs = None
            if ahead is not None and ahead_for == i:
                join_t = self.stall_timeout \
                    if self.stall_timeout is not None else self.job_timeout
                # the serving thread's wait for the next job's decode:
                # a leaf span (the card idles under it), outside
                # elapsed_sec
                with ahead.robs.tracer.span("ahead_wait"):
                    self._join_ahead(ahead, join_t)
                if ahead.thread.is_alive():
                    # the decode-ahead thread itself is wedged: disown
                    # it and fail only its job
                    from ..resilience.policy import HungDispatchError

                    header_err = HungDispatchError(
                        f"job {job_id}: decode-ahead thread made no "
                        f"progress within {join_t:.3g}s")
                    robs = ahead.robs
                    self._note_timeout(ahead.robs, header_err)
                    close_handle = ahead.close
                else:
                    robs = ahead.robs
                    contigs = ahead.contigs
                    records = _PredecodedJob(ahead)
                    header_err = ahead.error if contigs is None else None
                    close_handle = ahead.close
                self._ahead = None
            else:
                if ahead is not None:
                    ahead.cancel()       # stale (intervening skip/reject)
                    ahead.close()
                    self._ahead = None
                robs = self._prepare(cfg, jobnum)
                try:
                    # a batch demotion may have left this entry's probe
                    # handle open (header already parsed): resume from it
                    ai = entry.pop("batch_handle", None)
                    if ai is None:
                        ai = open_alignment_input(
                            spec.filename,
                            getattr(cfg, "input_format", "auto"),
                            threads=resolve_decode_threads(cfg))
                    close_handle = ai.close
                    contigs, records = ai.contigs, ai.stream
                except Exception as exc:
                    header_err = exc
            ahead = None
            ahead_for = None
            # trace-context onto this run's artifacts (works for the
            # decode-ahead robs too: its trace file is written at
            # finish_run, after this stamp)
            self._stamp_trace(robs, entry)
            if not first_run_seen and contigs is not None:
                from ..encoder.events import GenomeLayout

                self._auto_prewarm(spec, GenomeLayout(contigs).total_len)
            first_run_seen = True
            # -- launch the NEXT runnable job's decode-ahead -----------
            if self.decode_ahead:
                for k in range(i + 1, len(plan)):
                    if plan[k]["action"] == "run" and k not in batched:
                        nxt = plan[k]
                        ahead = _DecodeAhead(
                            self.backend, JobSpec(
                                filename=nxt["spec"].filename,
                                config=nxt["cfg"],
                                job_id=nxt["job_id"],
                                tenant=nxt["spec"].tenant),
                            self._prepare(nxt["cfg"], nxt["jobnum"]),
                            cap,
                            fault_cb=self._fault_check
                            if self._fault is not None else None)
                        ahead_for = k
                        self._ahead = ahead
                        self._ahead_gate = None if after_batch(i, k) \
                            else ahead.gate
                        break
            # -- run this job -----------------------------------------
            if recovery_info is not None:
                robs.registry.gauge("serve/recovery").set_info(
                    recovery_info)
            robs.registry.gauge("serve/health").set_info({
                "queue_depth": self.health.queue_depth,
                "in_flight": job_id,
                "tenant_rungs": dict(self.admission.tenant_rungs),
                **({"journal_last_seq": replay.last_seq}
                   if replay is not None else {})})
            res = JobResult(job_id=job_id, filename=spec.filename,
                            index=i, admission=entry["admission"])
            # incremental consensus: seed the job from the warm
            # per-reference count state (serve/countcache.py) and ask
            # the backend to hand back the final state for re-insertion
            cache_key = cache_seed = capture = None
            if header_err is None:
                cache_key, cache_seed, cfg = self._cache_begin(
                    spec, cfg, contigs, robs)
                entry["cfg"] = cfg
                if cache_key is not None:
                    capture = self._plant_seed(cache_seed)
            dlog: List[Tuple[float, float]] = []
            # log-correlation IDs for every record this job emits —
            # the watchdog worker and (already-bound) decode-ahead
            # threads inherit/set the same fields (--log-format json)
            stele.set_log_context(
                job_id=job_id, tenant=spec.tenant,
                rung=(entry["admission"] or cfg.pileup))
            self.health.job_started(job_id)
            self._journal_append("started", job=job_id,
                                 key=entry["key"],
                                 ckpt=cfg.checkpoint_dir or "")
            # mirror of the started append's wall stamp: the journal-
            # measured queue wait's right edge
            entry["started_unix"] = round(time.time(), 3)
            t0 = time.perf_counter()
            if header_err is not None:
                res.error = f"{type(header_err).__name__}: {header_err}"
                if close_handle is not None:
                    close_handle()
            else:
                out = None
                try:
                    self._next_capture = capture
                    out = self._execute(contigs, records, cfg, robs,
                                        dlog, job_id)
                except Exception as exc:
                    self._note_timeout_if_deadline(robs, exc)
                    self._note_poison(spec, exc, res)
                    self._note_capacity(spec, exc, robs)
                    retry_cfg = self._retry_config(cfg, exc)
                    if retry_cfg is not None:
                        if cache_key is not None:
                            # the host-rung retry runs against the SAME
                            # warm base (else its output would cover
                            # only the delta reads), in a box of its
                            # own: the first attempt, if abandoned, may
                            # still write its box
                            capture = self._plant_seed(cache_seed)
                        out, robs, res.error = self._retry_on_host_rung(
                            spec, retry_cfg, exc, jobnum, job_id,
                            capture)
                    else:
                        res.error = f"{type(exc).__name__}: {exc}"
                    if res.error is not None:
                        logger.warning("job %s failed: %s", job_id,
                                       res.error)
                finally:
                    if close_handle is not None:
                        close_handle()
                    # the job's decoded batches (and the rows they
                    # staged on the card) go with it
                    records = None
                if out is not None:
                    res.fastas, res.stats = out.fastas, out.stats
                    res.error = None
                if cache_key is not None:
                    self._cache_end(cache_key, out is not None, capture)
            self._ahead_gate = None
            if ahead is not None and not after_batch(i, ahead_for):
                # a job that never dispatched still lets the next decode
                # (a batch before the next serial job sets the gate at
                # its first shared dispatch instead)
                ahead.release()
            res.elapsed_sec = time.perf_counter() - t0
            self._finalize_job(entry, res, robs, spec,
                               queue_wait=t0 - window_t0)
            results.append(res)
            # -- cross-job overlap: bill it to the job whose decode
            #    was hidden (N+1), before that job runs ---------------
            if ahead is not None:
                ov = intersect_sec(ahead.intervals(), dlog)
                ahead.robs.registry.add("serve/overlap_sec", ov)
                ahead.robs.registry.add("serve/decode_ahead_sec",
                                        ahead.decode_sec())
                ahead.robs.registry.gauge("serve/overlap").set_info({
                    "overlap_sec": round(ov, 4),
                    "decode_ahead_sec": round(ahead.decode_sec(), 4),
                    "overlapped_job": job_id})
                self.registry.add("serve/overlap_sec", ov)

    # -- plan-entry resolution (shared: serial loop + fleet drain) ---------
    def _resolve_nonrun(self, entry: dict, i: int) -> JobResult:
        """A plan entry that never executes: journal-resumed skip or
        admission reject — one result, counters, echo, bookkeeping."""
        spec = entry["spec"]
        job_id = entry["job_id"]
        res = JobResult(job_id=job_id, filename=spec.filename, index=i)
        if entry["action"] == "skip":
            res.resumed = True
            res.output_paths = entry.get("outputs", [])
            res.metrics = {"serve/resume_skipped": 1}
            self.echo(f"[serve] {job_id}: resumed (committed in "
                      f"journal, outputs verified)")
        else:
            reason = entry["admission"]
            res.admission = reason
            detail = ""
            if reason == "capacity":
                detail = (
                    f": predicted peak "
                    f"{entry.get('mem_predicted', 0) / 1e6:.1f}"
                    f" MB > --mem-budget "
                    f"{self.admission.mem_budget / 1e6:.1f} MB"
                    f" — re-offer to a host that fits")
            res.error = f"admission rejected: {reason}{detail}"
            self.registry.add("serve/admission_rejected", 1)
            self.registry.add(
                f"serve/admission_rejected/{reason}", 1)
            self.echo(f"[serve] {job_id}: REJECTED "
                      f"({reason}{detail})")
        self.jobs_run += 1
        return res

    def _resolve_completed_elsewhere(self, entry: dict, i: int,
                                     rec: dict) -> JobResult:
        """Fleet: a peer's journal commit resolves this entry — the
        drain verified the recorded outputs before calling this (a
        drifted commit is re-claimed and re-run instead), so this
        worker never decodes a byte."""
        job_id = entry["job_id"]
        res = JobResult(job_id=job_id, filename=entry["spec"].filename,
                        index=i, resumed=True)
        res.worker = rec.get("worker", "")
        res.output_paths = list(rec.get("outputs") or {})
        res.metrics = {"fleet/completed_elsewhere": 1}
        # NOT serve/jobs: that family counts jobs THIS worker ran —
        # the peer already counted the run on its side
        self.registry.add("fleet/completed_elsewhere", 1)
        self.jobs_run += 1
        self.health.queue_depth = max(0, self.health.queue_depth - 1)
        self.echo(f"[serve] {job_id}: committed by worker "
                  f"{res.worker or '?'} in "
                  f"{rec.get('elapsed_sec', 0.0):.2f}s")
        return res

    def _resolve_failed_elsewhere(self, entry: dict, i: int,
                                  error: str) -> JobResult:
        """Fleet: a peer journaled this job failed — terminal for the
        queue run, exactly as a local failure would be."""
        job_id = entry["job_id"]
        res = JobResult(job_id=job_id, filename=entry["spec"].filename,
                        index=i)
        res.error = f"failed on another worker: {error}"
        self.registry.add("fleet/failed_elsewhere", 1)
        self.jobs_run += 1
        self.health.queue_depth = max(0, self.health.queue_depth - 1)
        self.echo(f"[serve] {job_id}: FAILED on another worker "
                  f"({error})")
        return res

    def _run_claimed_entry(self, entry: dict, i: int, window_t0: float,
                           recovery_info) -> JobResult:
        """Run one claim-won plan entry — the fleet drain's execution
        body: the serial loop's run path minus decode-ahead (journal
        mode already forces serial decode), batching and count-cache
        seeding (both refused with ``worker_id``), plus the lease fence
        before the commit.  The attempt always runs on the monitored
        path (:meth:`_execute`), so the leases renew while it runs; an
        attempt the watchdog abandoned leaves its result in a box no
        one reads, so a reaped lease's late CUDA work is never
        committed and never seeds the thief's run (which starts from
        the job's last durable checkpoint)."""
        from ..config import resolve_decode_threads
        from ..formats import open_alignment_input
        from ..resilience import ladder as rladder

        spec = entry["spec"]
        job_id = entry["job_id"]
        cfg = entry["cfg"]
        jobnum = entry["jobnum"]
        self.registry.add("serve/admission_admitted", 1)
        rung = self.admission.pin_rung(spec.tenant)
        if rung is not None and cfg.pileup != "host":
            cfg = rladder.job_host_rung_config(cfg)
            entry["cfg"] = cfg
            entry["admission"] = f"pinned:{rung}"
        if entry["admission"]:
            self.registry.add("serve/admission_pinned", 1)
        robs = self._prepare(cfg, jobnum)
        self._stamp_trace(robs, entry)
        close_handle = None
        contigs = records = None
        header_err = None
        try:
            ai = open_alignment_input(
                spec.filename, getattr(cfg, "input_format", "auto"),
                threads=resolve_decode_threads(cfg))
            close_handle = ai.close
            contigs, records = ai.contigs, ai.stream
        except Exception as exc:
            header_err = exc
        if contigs is not None and not self._fleet_first_run_seen:
            from ..encoder.events import GenomeLayout

            self._auto_prewarm(spec, GenomeLayout(contigs).total_len)
            self._fleet_first_run_seen = True
        if recovery_info is not None:
            robs.registry.gauge("serve/recovery").set_info(
                recovery_info)
        robs.registry.gauge("serve/health").set_info({
            "queue_depth": self.health.queue_depth,
            "in_flight": job_id, "worker": self.worker_id,
            "tenant_rungs": dict(self.admission.tenant_rungs)})
        res = JobResult(job_id=job_id, filename=spec.filename,
                        index=i, admission=entry["admission"])
        res.worker = self.worker_id
        dlog: List[Tuple[float, float]] = []
        stele.set_log_context(
            job_id=job_id, tenant=spec.tenant,
            rung=(entry["admission"] or cfg.pileup),
            worker=self.worker_id)
        self.health.job_started(job_id)
        self._journal_append("started", job=job_id, key=entry["key"],
                             ckpt=cfg.checkpoint_dir or "",
                             worker=self.worker_id,
                             tenant=spec.tenant or "")
        entry["started_unix"] = round(time.time(), 3)
        t0 = time.perf_counter()
        if header_err is not None:
            res.error = f"{type(header_err).__name__}: {header_err}"
            if close_handle is not None:
                close_handle()
        else:
            out = None
            try:
                out = self._execute(contigs, records, cfg, robs,
                                    dlog, job_id)
            except Exception as exc:
                self._note_timeout_if_deadline(robs, exc)
                self._note_poison(spec, exc, res)
                self._note_capacity(spec, exc, robs)
                retry_cfg = self._retry_config(cfg, exc)
                if retry_cfg is not None:
                    out, robs, res.error = self._retry_on_host_rung(
                        spec, retry_cfg, exc, jobnum, job_id)
                else:
                    res.error = f"{type(exc).__name__}: {exc}"
                if res.error is not None:
                    logger.warning("job %s failed: %s", job_id,
                                   res.error)
            finally:
                if close_handle is not None:
                    close_handle()
                records = None
            if out is not None:
                res.fastas, res.stats = out.fastas, out.stats
                res.error = None
        res.elapsed_sec = time.perf_counter() - t0
        # -- lease confirmation: only the live holder may journal -----
        # (ok AND failed outcomes: a woken zombie's "failed" append
        # would pop the thief's live claim and wreck ITS commit — the
        # thief owns the whole lifecycle once it re-claims)
        journal_lifecycle = True
        if not self.fleet.holds(entry["key"]):
            self.registry.add("fleet/lease_lost", 1)
            journal_lifecycle = False
            if res.ok:
                # abandon the result: no outputs, no journal events —
                # a second commit is exactly the duplication the
                # audit forbids
                res.fastas = None
                res.error = (
                    f"lease lost: worker {self.worker_id!r} held job "
                    f"{job_id} past its TTL and the lease was "
                    f"re-claimed by a peer; result abandoned (the "
                    f"re-claiming worker commits it)")
            else:
                res.error = (
                    f"{res.error} [lease lost mid-run: failure not "
                    f"journaled — the re-claiming worker owns the "
                    f"job's lifecycle]")
        self._finalize_job(entry, res, robs, spec,
                           queue_wait=t0 - window_t0,
                           journal_lifecycle=journal_lifecycle)
        return res

    def _finalize_job(self, entry: dict, res: JobResult, robs,
                      spec: JobSpec, queue_wait: float,
                      echo_suffix: str = "",
                      journal_lifecycle: bool = True) -> None:
        """Everything after a job's run attempt, as one ``finalize`` span
        (outside ``elapsed_sec``): a leaf on the serving thread but for the
        ``fasta_write`` of a journaled commit."""
        with obs.tracer().span("finalize"):
            self._finalize_job_body(entry, res, robs, spec, queue_wait,
                                    echo_suffix, journal_lifecycle)

    def _finalize_job_body(self, entry: dict, res: JobResult, robs,
                           spec: JobSpec, queue_wait: float,
                           echo_suffix: str = "",
                           journal_lifecycle: bool = True) -> None:
        """Everything after a job's run attempt, shared by the serial
        loop and the batch scheduler (serve/scheduler.py) so the two
        paths cannot drift: metrics subset + rung/manifest capture,
        journal commit/failed events (outputs durably on disk BEFORE the
        commit event), telemetry fold + per-tenant SLO verdict, the rate
        card, admission feedback, health bookkeeping, operator echo."""
        from ..io.fasta import write_outputs
        from ..resilience import ladder as rladder

        cfg = entry["cfg"]
        job_id = entry["job_id"]
        snap = robs.registry.snapshot()
        res.metrics = {
            k: v for k, v in snap["counters"].items()
            if k.startswith(("serve/", "compile/", "resilience/",
                             "fault/", "phase/", "ingest/",
                             "quarantine/", "cache/", "epilogue/",
                             "kernel/"))}
        res.bad_records = int(
            snap["counters"].get("ingest/bad_records", 0))
        res.quarantined = int(
            snap["counters"].get("quarantine/records", 0))
        if res.bad_records:
            # server-level aggregation for the health snapshot (the
            # per-job numbers live in each job's own registry)
            self.registry.add("serve/bad_records", res.bad_records)
        res.rungs = rladder.job_rungs(snap)
        res.manifest = obs.last_manifest() if res.ok else None
        if self.worker_id and res.manifest is not None:
            # which worker committed the job — stamped BEFORE the slo
            # rewrite below persists the manifest file
            res.manifest.setdefault("serve", {})["worker"] = \
                self.worker_id
        # journal-measured lifecycle (computed BEFORE the commit below
        # releases the fleet's claim bookkeeping) (stamped BEFORE the slo rewrite
        # persists the manifest).  When a journal is present its
        # wall-clock queue wait is the SLO truth source; the
        # window-epoch measure rides in the lifecycle section as the
        # cross-check.
        lifecycle, journal_qw = self._sched_lifecycle(entry, queue_wait)
        tlabel = spec.tenant or "default"
        if journal_qw is not None:
            self.registry.observe(f"sched/{tlabel}/queue_wait",
                                  journal_qw)
        if "claim_latency_sec" in lifecycle:
            self.registry.observe(f"sched/{tlabel}/claim_latency",
                                  lifecycle["claim_latency_sec"])
        if "steal_latency_sec" in lifecycle:
            self.registry.observe(f"sched/{tlabel}/steal_latency",
                                  lifecycle["steal_latency_sec"])
        self._busy_sec += max(0.0, res.elapsed_sec)
        if res.manifest is not None:
            res.manifest["lifecycle"] = lifecycle
        # -- commit: outputs durably on disk, then the journal -----
        if res.ok and res.fastas is not None \
                and self.journal is not None and journal_lifecycle:
            if self.fleet is not None:
                # the output write + fingerprint pass below runs with
                # no watchdog ticks (no renewals): start the commit
                # window with a full TTL of margin
                self.fleet.renew_now(entry["key"])
            try:
                res.output_paths = write_outputs(
                    res.fastas, cfg.outfolder, cfg.prefix,
                    cfg.nchar, cfg.thresholds, echo=self.echo)
                fps = {p: sjournal.file_fingerprint(p)
                       for p in res.output_paths}
            except Exception as exc:
                # a commit-time write failure (disk full, bad
                # outfolder) fails THIS job, never the queue — the
                # server's survive-failed-jobs contract holds at
                # the commit boundary too
                res.error = (f"output commit failed: "
                             f"{type(exc).__name__}: {exc}")
                res.fastas = None
                res.output_paths = []
                logger.warning("job %s: %s", job_id, res.error)
            else:
                if self.fleet is not None \
                        and not self.fleet.holds(entry["key"]):
                    # the write outlived even the renewed lease and a
                    # peer re-claimed: appending "committed" NOW would
                    # be the duplicate commit the audit forbids — the
                    # thief owns the lifecycle.  (The bytes on disk
                    # are identical to what the thief writes.)
                    self.registry.add("fleet/lease_lost", 1)
                    journal_lifecycle = False
                    res.output_paths = []
                    res.fastas = None
                    res.error = (
                        f"lease lost during commit: job {job_id}'s "
                        f"output write outlived the lease TTL and a "
                        f"peer re-claimed the job; commit abandoned "
                        f"(the re-claiming worker commits it)")
                    logger.warning("job %s: %s", job_id, res.error)
                else:
                    fence = {}
                    if self.fleet is not None:
                        # lease lineage: replay voids a commit whose
                        # (worker, claim_seq) does not match the open
                        # lease — the structural duplicate guard
                        cs = self.fleet.claim_seqs.get(entry["key"])
                        if cs is not None:
                            fence["claim_seq"] = cs
                    self._journal_append(
                        "committed", job=job_id, key=entry["key"],
                        outputs=fps,
                        elapsed_sec=round(res.elapsed_sec, 3),
                        worker=self.worker_id,
                        tenant=spec.tenant or "", **fence)
                    self.journal.drop_ckpt(entry["key"])
        if not res.ok and journal_lifecycle:
            self._journal_append("failed", job=job_id,
                                 key=entry["key"], error=res.error)
        # fold the job's registry into the server-lifetime
        # aggregate + per-tenant SLO verdict (never fails a job)
        self._telemetry_job_end(robs, res, snap, spec.tenant,
                                queue_wait=journal_qw
                                if journal_qw is not None
                                else queue_wait)
        # fold the job's measured throughput into the rate card
        # (observability/ratecard.py) — successful jobs only, so a
        # crash-looping input cannot poison the learned constants
        if res.ok:
            try:
                try:
                    in_bytes = os.path.getsize(spec.filename)
                except OSError:
                    in_bytes = 0
                self.ratecard.observe_job(
                    snap, res.elapsed_sec, input_bytes=in_bytes,
                    decode_cores=max(
                        1, int(getattr(cfg, "decode_threads", 1) or 1)),
                    packed=snap["counters"].get("serve/batched", 0) > 0,
                    lifecycle=lifecycle)
            except Exception as exc:
                logger.warning("rate card fold failed for %s: %s",
                               job_id, exc)
        if entry.get("key"):
            # this life observed the job's SLO verdict directly — a
            # later fleet replay must not feed it to the burn monitor
            # again
            self._burn_fed_keys.add(entry["key"])
        self.jobs_run += 1
        self.registry.add("serve/jobs", 1)
        if not res.ok:
            self.registry.add("serve/jobs_failed", 1)
        self.admission.note_result(
            spec.tenant, res.rungs, res.ok,
            was_pinned=bool(entry["admission"]
                            and str(entry["admission"]).startswith(
                                "pinned")))
        self.last_job_badrec = {
            "job": job_id,
            "bad_records": res.bad_records,
            "quarantined": res.quarantined,
            "budget_exhausted": res.budget_exhausted,
        }
        stele.set_log_context()     # job done: clear correlation
        self.health.job_finished()
        self.health.queue_depth = max(
            0, self.health.queue_depth - 1)
        self.telemetry_tick(force=True)
        self.echo(f"[serve] {job_id}: "
                  + (f"ok in {res.elapsed_sec:.2f}s"
                     if res.ok else f"FAILED ({res.error})")
                  + echo_suffix)

    # -- incremental consensus (serve/countcache.py) -----------------------
    @staticmethod
    def _plant_seed(seed):
        """Arm one attempt of a count-cache job: a fresh
        :class:`~..backends.torch_backend.CountCapture` that hands the
        run ``seed`` (None = cold absorb) and takes its final state
        back.  The box goes to the attempt's ``run`` as an argument, so
        an attempt the watchdog abandoned never writes another's."""
        from ..backends.torch_backend import CountCapture

        return CountCapture(seed)

    def _cache_begin(self, spec: JobSpec, cfg: RunConfig, contigs, robs):
        """Seed an incremental job from the warm per-reference state.

        Returns ``(key, seed, cfg)`` — key None for non-incremental
        jobs (cache off / flag off / header unread); cfg gains a
        default ``source_id`` (the input's absolute path, the one-shot
        CLI's convention) so duplicate-input detection works without
        per-job plumbing.  The warm/cold verdict is a priced ledger
        decision in the JOB's manifest: predicted decode seconds for
        THIS input's bytes, joined against the measured decode phase
        (band=0: the decode-threads decision owns enforcing the rate
        model; this one documents what the cache saved)."""
        if self.count_cache is None \
                or not getattr(cfg, "incremental", False) \
                or contigs is None:
            return None, None, cfg
        from . import countcache as ccache

        if not cfg.source_id:
            cfg = dataclasses.replace(
                cfg, source_id=os.path.abspath(spec.filename))
        key = ccache.reference_key(contigs, cfg, spec.tenant)
        seed = self.count_cache.get(key, self.registry)
        chosen = "warm" if seed is not None else "cold"
        # same (plural) counter names as the cache's server-lifetime
        # family, so a per-job manifest joins the s2c_cache_*
        # exposition key-for-key
        robs.registry.add(
            f"cache/{'hits' if seed is not None else 'misses'}", 1)
        try:
            size = os.path.getsize(spec.filename)
        except OSError:
            size = 0
        # decode rate by precedence: env override, learned rate card,
        # baked default — the ladder the decode_threads decision prices
        # from, stamped with the consultation's provenance
        if "S2C_DECODE_MBPS_PER_CORE" in os.environ:
            try:
                rate_mbps = float(
                    os.environ["S2C_DECODE_MBPS_PER_CORE"])
            except ValueError:
                rate_mbps = 330.0
            rc_prov = {"source": "env", "key": "decode_mbps_per_core"}
        else:
            rate_mbps, rc_prov = rcard.consult("decode_mbps_per_core",
                                               330.0)
        rate = rate_mbps * 1e6
        cstats = self.count_cache.stats()
        with obs.bind_run_to_thread(robs):
            obs.record_decision(
                "count_cache", chosen,
                inputs={"entries": cstats["entries"],
                        "resident_mb": cstats["resident_mb"],
                        "input_bytes": int(size),
                        "base_sources": len(seed.sources or [])
                        if seed is not None else 0,
                        "tenant": spec.tenant or ""},
                predicted={"sec": size / rate} if size else {},
                measured={"sec": {"counters": ["phase/decode_sec"]}},
                band=0, provenance=rc_prov)
        return key, seed, cfg

    def _cache_end(self, key: str, ok: bool, capture) -> None:
        """Commit or invalidate the job's entry — the count-bank rule:
        only a job that finished whole re-inserts its state (the state
        its last attempt wrote into ``capture``); ANY failure after
        seeding drops the entry entirely (a half-applied base must never
        seed the next job)."""
        result = capture.result if capture is not None else None
        if ok and result is not None:
            self.count_cache.put(key, result, self.registry)
        else:
            self.count_cache.invalidate(key, self.registry)

    def _note_capacity(self, spec: JobSpec, exc: BaseException,
                       robs) -> None:
        """OOM forensics (observability/memplane.py): a CAPACITY-class
        job failure writes ``mem_dump.json`` next to the journal (the
        durable place an operator already looks — the profiler-capture
        home otherwise).  The job still classifies and (under fallback)
        demotes exactly as before."""
        from ..observability import memplane

        if robs.registry.value("mem/oom_dumps"):
            # the backend already dumped next to the job's own metrics
            # artifact; count it server-side, don't write a second dump
            path = os.path.join(
                os.path.dirname(os.path.abspath(robs.metrics_out)),
                memplane.MEM_DUMP_NAME) if robs.metrics_out else None
        else:
            out_dir = self.journal.root if self.journal is not None \
                else self.profiler.out_dir
            path = memplane.dump_on_capacity(
                exc, out_dir, registry=robs.registry,
                context={"job_id": self.health.in_flight,
                         "tenant": spec.tenant})
        if path is not None:
            self.registry.add("serve/oom_dumps", 1)
            self.registry.gauge("serve/last_oom_dump").set_info(
                {"path": path, "job": self.health.in_flight,
                 "error": f"{type(exc).__name__}: {exc}"})

    def _note_poison(self, spec: JobSpec, exc: BaseException,
                     res: JobResult) -> None:
        """Poison-job accounting (DATA class — the input is rotten, not
        the server): count the submission per tenant
        (``serve/admission_poison``) WITHOUT touching the tenant's
        ladder rung."""
        from ..ingest.badrecords import is_data_error

        if not is_data_error(exc):
            return
        res.budget_exhausted = bool(
            getattr(exc, "budget_exhausted", False))
        self.registry.add("serve/admission_poison", 1)
        self.admission.note_poison(spec.tenant)

    # -- job-level ladder --------------------------------------------------
    def _retry_config(self, cfg: RunConfig,
                      exc: BaseException) -> Optional[RunConfig]:
        """The job-level demotion decision: a timed-out/hung/faulted
        job may re-run ONCE, pinned to the ladder's host rung — only
        under the job's ``--on-device-error fallback`` (the same opt-in
        the in-run ladder uses), only for device-shaped failures, and
        only when the job was not already on the host rung."""
        from ..resilience import ladder as rladder
        from ..resilience.policy import DATA, PASSTHROUGH, classify

        kind = classify(exc)
        if getattr(cfg, "on_device_error", "retry") != "fallback" \
                or kind in (PASSTHROUGH, DATA):
            # DATA (poison input): the host rung would re-decode the
            # same bytes and fail identically — fail fast with the
            # quarantine summary, keep the tenant on the fast path
            return None
        if cfg.pileup == "host":
            return None                 # already on the bottom rung
        return rladder.job_host_rung_config(cfg)

    def _retry_on_host_rung(self, spec: JobSpec, cfg: RunConfig,
                            exc: BaseException, jobnum: int,
                            job_id: str, capture=None):
        """Re-run a failed job pinned to the host rung, with fresh
        instruments (the abandoned attempt may still hold its own) and,
        for an incremental job, a fresh count-cache box (``capture``).
        Returns ``(result_or_None, robs, error_or_None)``."""
        from ..config import resolve_decode_threads
        from ..formats import open_alignment_input
        from ..resilience import ladder as rladder

        self.registry.add("serve/job_retries", 1)
        self.echo(f"[serve] {job_id}: retrying on the host rung "
                  f"after {type(exc).__name__}")
        # the abandoned first attempt may still write its exports
        # when/if it wakes — the retry must not race it on the same
        # paths
        robs = self._prepare(cfg, jobnum, suffix=".retry")
        robs.registry.add("serve/job_retries", 1)
        rladder.record_job_demotion(
            robs.registry, f"{type(exc).__name__}: {exc}")
        self._note_timeout_if_deadline(robs, exc, server=False)
        self._journal_append("started", job=job_id,
                             key=sjournal.job_key(spec.filename,
                                                  spec.config),
                             ckpt=cfg.checkpoint_dir or "",
                             retry=True)
        dlog: List[Tuple[float, float]] = []
        handle = None
        try:
            handle = open_alignment_input(
                spec.filename, getattr(cfg, "input_format", "auto"),
                threads=resolve_decode_threads(cfg))
            contigs, records = handle.contigs, handle.stream
            self._next_capture = capture
            out = self._execute(contigs, records, cfg, robs, dlog,
                                f"{job_id}#retry")
            return out, robs, None
        except Exception as exc2:
            return None, robs, (f"{type(exc).__name__}: {exc}; retry on "
                                f"host rung also failed: "
                                f"{type(exc2).__name__}: {exc2}")
        finally:
            if handle is not None:
                try:
                    handle.close()
                except OSError:
                    pass

    def _note_timeout_if_deadline(self, robs, exc,
                                  server: bool = True) -> None:
        from ..resilience.policy import (HungDispatchError,
                                         JobDeadlineExceeded)

        if isinstance(exc, (JobDeadlineExceeded, HungDispatchError)):
            self._note_timeout(robs, exc, server=server)


def submit_jobs(specs: List[JobSpec], **runner_kwargs) -> List[JobResult]:
    """One-call API: build a :class:`ServeRunner`, run the queue, return
    the results (the runner — and its warm state — is discarded; hold a
    ServeRunner yourself to amortize across submits)."""
    runner = ServeRunner(**runner_kwargs)
    try:
        return runner.submit_jobs(specs)
    finally:
        runner.close()                  # join prewarm + drop atexit ref
