"""Tracing, metrics, the decision ledger and the run manifest.

Port of ``sam2consensus_tpu/observability/__init__.py`` (its one-shot
surface):

* :mod:`.trace` — thread-safe hierarchical spans (free when disabled,
  device-complete ``sync`` on exit);
* :mod:`.devtrace` — the bridge: every tracer here is a
  :class:`~.devtrace.DeviceTracer`, whose spans, while a
  ``torch.profiler`` window records, are also ``record_function`` ranges
  (``user_annotation`` events on the clock of the card's kernels), so the
  card's idle gaps in a profile are named after the host work under them;
* :mod:`.metrics` — the process-current registry of counters, gauges and
  histograms; the ``stats.extra`` keys are a view of it
  (:func:`publish_stats_extra`);
* :mod:`.ledger` — each priced gate's prediction joined against what
  the run measured (``residual/*``, ``drift/*``);
* :mod:`.export` and :mod:`.manifest` — the Chrome/Perfetto trace
  (``--trace-out``), the metrics JSONL (``--metrics-out``) and, beside
  it, the run manifest (``s2c-manifest/1``);
* :mod:`.memplane` — host and device byte accounting;
* :mod:`.ratecard`, :mod:`.jitcache`, :mod:`.telemetry` — the learned
  rates' provenance, the kernel build's cache counters, JSON logging.

Usage, backend side::

    robs = observability.start_run(trace_out=cfg.trace_out,
                                   metrics_out=cfg.metrics_out,
                                   config=cfg)
    try:
        with observability.tracer().span("decode"):
            ...
    finally:
        observability.finish_run(robs, meta={"backend": "torch"})

The leaf-span rule: no span that bridges encloses another on the same
thread in a served job's path, because a profile's reader names a gap
after the longest host event over it, and an enclosing span would name
every gap.  The serving thread's leaves are ``batch_wait`` (the wait for
a decoded batch, backends/torch_backend.py), ``pileup_dispatch``,
``tail``, ``render``, ``ahead_wait`` (the wait for the next job's
decode-ahead thread) and ``finalize`` (the runner's after-job work,
serve/runner.py), and ``fasta_write`` (io/fasta.py).  Two nestings stand
outside the served K1 path: ``fasta_write`` inside ``finalize`` on the
journaled commit path, and ``counts_upload`` inside ``tail`` on the host
pileup path.

Deep call sites (the accumulators, the link probe, the decoders) reach
the current run's instruments through :func:`tracer`, :func:`metrics`
and :func:`ledger`.  Between runs they fall back to process-wide
defaults (a disabled tracer, a throwaway registry and ledger), so
recording is always safe.  Worker threads of a run (the prefetch thread,
the parallel decoder's workers) bind the run with
:func:`bind_run_to_thread`.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from . import ledger as _ledger
from . import manifest as _manifest
from . import memplane as _memplane
from . import metrics as _metrics
from .devtrace import DeviceTracer
from .export import (read_metrics_jsonl, write_chrome_trace,
                     write_metrics_jsonl)
from .ledger import DecisionLedger, DecisionRecord
from .metrics import MetricsRegistry
from .trace import Tracer

__all__ = [
    "Tracer", "DeviceTracer", "MetricsRegistry", "RunObservability",
    "PHASES", "DecisionLedger", "DecisionRecord",
    "start_run", "finish_run", "prepare_run", "bind_run_to_thread",
    "current_run", "tracer", "metrics", "ledger",
    "record_decision", "finalize_decisions", "last_manifest",
    "publish_stats_extra", "configure_logging",
    "write_chrome_trace", "write_metrics_jsonl", "read_metrics_jsonl",
]

#: span/phase names in pipeline order: the phase vocabulary shared by the
#: tracer and the ``phase/<name>_sec`` counters
PHASES = ("decode", "stage", "pileup_dispatch", "accumulate",
          "insertions", "vote", "render")

#: the always-available fallback tracer; disabled, so every span call
#: outside a run is the shared no-op
_disabled_tracer = DeviceTracer(enabled=False)
_tracer_stack: List[Tracer] = [_disabled_tracer]
_stack_lock = threading.Lock()
_tracer_tls = threading.local()


def tracer() -> Tracer:
    """The current run's tracer (a disabled one between runs).  A
    thread-bound tracer (:func:`bind_run_to_thread`) wins over the
    process-current stack."""
    t = getattr(_tracer_tls, "tracer", None)
    return t if t is not None else _tracer_stack[-1]


def metrics() -> MetricsRegistry:
    """The current run's metrics registry (see metrics.current)."""
    return _metrics.current()


def ledger() -> DecisionLedger:
    """The current run's decision ledger (see ledger.current)."""
    return _ledger.current()


def record_decision(decision: str, chosen: str, **kwargs) -> DecisionRecord:
    """Register a model-driven decision into the current run's ledger
    (see :mod:`.ledger` for the record/measured-spec shapes)."""
    return _ledger.record(decision, chosen, **kwargs)


def finalize_decisions() -> List[DecisionRecord]:
    """Join the current run's ledger against its measured counters,
    emitting ``residual/*`` gauges and ``drift`` events (idempotent).
    The backend calls this at the end of a run BEFORE deriving the
    ``stats.extra`` view; ``finish_run`` re-checks for runs that died
    before reaching it."""
    return _ledger.finalize(_ledger.current(), _metrics.current(),
                            tracer())


#: the most recent finish_run's manifest
_last_manifest: List[Optional[dict]] = [None]


def last_manifest() -> Optional[dict]:
    """The manifest built by the most recent ``finish_run`` (None before
    any run completes)."""
    return _last_manifest[0]


@dataclass
class RunObservability:
    """Handle for one run's instruments + export destinations."""

    tracer: Tracer
    registry: MetricsRegistry
    trace_out: Optional[str] = None
    metrics_out: Optional[str] = None
    ledger: DecisionLedger = field(default_factory=DecisionLedger)
    config: Optional[dict] = None


def prepare_run(trace_out: Optional[str] = None,
                metrics_out: Optional[str] = None,
                enabled: Optional[bool] = None,
                config=None) -> RunObservability:
    """Build a run's instruments WITHOUT installing them as current.
    ``trace_out`` / ``metrics_out`` fall back to ``S2C_TRACE_OUT`` /
    ``S2C_METRICS_OUT``; the tracer is enabled iff a trace destination
    exists or ``enabled`` forces it."""
    trace_out = trace_out or os.environ.get("S2C_TRACE_OUT") or None
    metrics_out = metrics_out or os.environ.get("S2C_METRICS_OUT") or None
    if enabled is None:
        enabled = trace_out is not None
    if config is not None and not isinstance(config, dict):
        import dataclasses

        config = dataclasses.asdict(config) \
            if dataclasses.is_dataclass(config) else None
    return RunObservability(tracer=DeviceTracer(enabled=bool(enabled)),
                            registry=MetricsRegistry(),
                            trace_out=trace_out, metrics_out=metrics_out,
                            ledger=DecisionLedger(), config=config)


def start_run(trace_out: Optional[str] = None,
              metrics_out: Optional[str] = None,
              enabled: Optional[bool] = None,
              config=None,
              prepared: Optional[RunObservability] = None
              ) -> RunObservability:
    """Install a fresh tracer + registry + decision ledger as the
    process-current set (or ``prepared``, a :func:`prepare_run` handle).
    The registry always collects (a few locked adds a slab); the tracer
    records only when enabled.  ``config`` (a RunConfig or dict) is
    snapshotted into the run's manifest."""
    robs = prepared if prepared is not None else prepare_run(
        trace_out=trace_out, metrics_out=metrics_out, enabled=enabled,
        config=config)
    _metrics.push_run(robs.registry)
    _ledger.push_run(robs.ledger)
    with _stack_lock:
        _tracer_stack.append(robs.tracer)
    return robs


def current_run() -> RunObservability:
    """The calling thread's current instruments as one handle, for a
    worker thread to bind with :func:`bind_run_to_thread`."""
    return RunObservability(tracer=tracer(), registry=metrics(),
                            ledger=ledger())


class bind_run_to_thread:
    """Context manager routing THIS thread's ``tracer()`` /
    ``metrics()`` / ``ledger()`` to one run's instruments, whatever is
    process-current: the prefetch thread and the parallel decoder's
    workers record into the run that started them."""

    def __init__(self, robs: RunObservability):
        self._robs = robs

    def __enter__(self):
        _metrics.bind_thread(self._robs.registry)
        _ledger.bind_thread(self._robs.ledger)
        _tracer_tls.tracer = self._robs.tracer
        return self._robs

    def __exit__(self, *exc):
        _metrics.bind_thread(None)
        _ledger.bind_thread(None)
        _tracer_tls.tracer = None
        return False


def finish_run(obs: RunObservability, meta: Optional[dict] = None) -> None:
    """Uninstall the run's instruments, write any requested exports, and
    build the run's manifest (written beside ``--metrics-out``).  The
    memory plane's queued releases are applied first, outside any
    lock."""
    _memplane.drain_releases()
    _ledger.finalize(obs.ledger, obs.registry, obs.tracer)
    with _stack_lock:
        if len(_tracer_stack) > 1 and _tracer_stack[-1] is obs.tracer:
            _tracer_stack.pop()
        elif obs.tracer in _tracer_stack[1:]:
            _tracer_stack.remove(obs.tracer)
    _metrics.pop_run(obs.registry)
    _ledger.pop_run(obs.ledger)
    artifacts = {}
    if obs.trace_out:
        write_chrome_trace(obs.tracer, obs.trace_out)
        artifacts["trace"] = {"path": obs.trace_out,
                              "digest": _manifest.file_digest(
                                  obs.trace_out)}
    if obs.metrics_out:
        write_metrics_jsonl(obs.registry, obs.metrics_out, meta=meta)
        artifacts["metrics"] = {"path": obs.metrics_out,
                                "digest": _manifest.file_digest(
                                    obs.metrics_out)}
    man = _manifest.build_manifest(
        obs.registry, obs.ledger.records(), meta=meta,
        config=obs.config, artifacts=artifacts)
    _last_manifest[0] = man
    if obs.metrics_out:
        _manifest.write_manifest(
            _manifest.manifest_path_for(obs.metrics_out), man)


def publish_stats_extra(extra: dict) -> None:
    """The ``stats.extra`` view of the current registry: the reference's
    ``publish_stats_extra`` (``observability/__init__.py:242-323``), key
    for key, except that a key the port's backend already set is kept:
    its own phase seconds (``decode_sec``, ``stage_sec``), decisions
    (``pileup_path``, ``wire``) and decoder counters (``ingest_mode``)
    stay as they are, and the registry adds what they do not hold."""
    view: dict = {}
    snap = metrics().snapshot()
    for name, value in snap["counters"].items():
        if name.startswith("phase/") and name.endswith("_sec"):
            view[name[len("phase/"):]] = round(value, 4)
        elif name.startswith(("resilience/", "fault/", "checkpoint/")):
            view[name] = int(value)
        elif name.startswith(("wire/", "pipeline/", "drift/", "serve/",
                              "compile/", "format/", "ingest/",
                              "quarantine/", "slo/", "telemetry/",
                              "cache/", "epilogue/", "mem/")):
            view[name] = int(value) if float(value).is_integer() \
                else round(value, 4)
    for gauge_name, extra_key in (("dispatch/tail", "tail_dispatch"),
                                  ("dispatch/pileup", "pileup_path"),
                                  ("wire/codec", "wire"),
                                  ("pipeline/overlap", "pipeline"),
                                  ("format/input", "input_format"),
                                  ("ingest/mode", "ingest_mode"),
                                  ("serve/recovery", "serve_recovery"),
                                  ("serve/watchdog", "serve_watchdog"),
                                  ("quarantine/summary", "quarantine")):
        g = snap["gauges"].get(gauge_name)
        if g is not None and g.get("info"):
            view[extra_key] = g["info"]
    for name, g in snap["gauges"].items():
        if name.startswith("residual/") and name.count("/") == 2:
            view[name] = g["value"]
        elif name.startswith("mem/"):
            view[name] = int(g["value"]) \
                if float(g["value"]).is_integer() else g["value"]
    prss = snap["gauges"].get("mem/peak_rss_mb")
    if prss is not None:
        view["peak_rss_mb"] = prss["value"]
    for key, value in view.items():
        extra.setdefault(key, value)


def configure_logging(level: Optional[str],
                      log_format: str = "text") -> None:
    """Wire the package logger (``sam2consensus_torch``) to stderr
    (``--log-level`` / ``--log-format``).  ``log_format="json"`` swaps in
    :class:`~.telemetry.JsonLogFormatter` (one JSON object a record,
    with the thread's correlation context and the innermost open span)
    and implies level=info when no level was asked for."""
    if log_format not in ("text", "json"):
        raise SystemExit(f"error: unknown log format {log_format!r} "
                         "(use text|json)")
    if log_format == "json" and not level:
        level = "info"
    if not level:
        return
    lv = getattr(logging, level.upper(), None)
    if not isinstance(lv, int):
        raise SystemExit(f"error: unknown log level {level!r} "
                         "(use debug|info|warning|error)")
    logger = logging.getLogger("sam2consensus_torch")
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
    if log_format == "json":
        from .telemetry import JsonLogFormatter

        fmt: logging.Formatter = JsonLogFormatter()
    else:
        fmt = logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s")
    for h in logger.handlers:
        h.setFormatter(fmt)
    logger.setLevel(lv)
