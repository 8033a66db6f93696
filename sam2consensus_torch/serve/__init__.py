"""Warm-path serving: one persistent backend on one card across many jobs.

A one-shot run pays, per process, the CUDA context, the kernel
extension's load (``kernels.build.extension``), the link probe and the
device tables before its first slab.  :class:`ServeRunner` (the CLI's
``serve`` subcommand, :func:`submit_jobs` from Python) keeps one
:class:`~..backends.torch_backend.TorchBackend` alive across jobs and runs
them through its serial queue: job N+1's host decode runs ahead on a side
thread while job N's device work is in flight (``serve/overlap_sec``),
the first job's slab shapes are prewarmed behind its decode, and each job
gets its own registry, tracer, decision ledger, manifest, ladder and
fault-injection scope, so a fault demotes only its job.

The survivability layer is the reference's (``sam2consensus_tpu/serve``):
:mod:`.journal` (crash-safe resume), the watchdog (``--job-timeout``,
``--stall-timeout``), :mod:`.admission` (queue bound, tenant quotas,
``--mem-budget``, degraded-tenant pinning) and :mod:`.health`; with the
telemetry plane of ``observability/telemetry.py`` and the burn monitor.
Continuous batching (:mod:`.scheduler`, :mod:`.packing`: ``--batch``,
``--batch-window``) packs eligible small jobs into shared slabs that K1
counts in one dispatch sequence on the card; the per-reference count
cache (:mod:`.countcache`: ``--count-cache``, serve ``--incremental``)
seeds each incremental job from its reference's warm counts.  Fleet mode
(:mod:`.fleet`: ``--worker-id``, ``--lease-ttl``) drains one journaled
queue from N worker processes under claim leases; streaming sessions
(:mod:`.session`, :mod:`.stream_server`: ``--ingest-port``) absorb waves
of reads over HTTP, one backend run a wave.  Cohorts (:mod:`.cohort`:
``--cohort-manifest``, ``--cohort-wave``, ``--cohort-summary``) stream one
manifest of shared-panel samples through packed waves, with a
per-position call-concordance tally fed from the shared device counts.
"""

from .admission import AdmissionController
from .countcache import CountCache, parse_budget, reference_key
from .fleet import FleetCoordinator
from .health import snapshot as health_snapshot
from .journal import JobJournal, job_key
from .packing import (PackPlan, extract_counts, extract_member,
                      merge_batches, plan_pack)
from .runner import JobResult, JobSpec, ServeRunner, submit_jobs
from .scheduler import BatchScheduler, parse_batch_mode
from .session import SessionError, SessionManager, consensus_digest
from .stream_server import IngestServer

__all__ = ["JobSpec", "JobResult", "ServeRunner", "submit_jobs",
           "JobJournal", "job_key", "AdmissionController",
           "health_snapshot", "BatchScheduler", "parse_batch_mode",
           "PackPlan", "plan_pack", "merge_batches", "extract_counts",
           "extract_member", "CountCache", "parse_budget",
           "reference_key", "FleetCoordinator", "SessionManager",
           "SessionError", "IngestServer", "consensus_digest"]
