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
of reads over HTTP, one backend run a wave.  Cohorts are refused by name
until their slice lands.
"""

from .runner import JobResult, JobSpec, ServeRunner, submit_jobs

__all__ = ["JobSpec", "JobResult", "ServeRunner", "submit_jobs"]
