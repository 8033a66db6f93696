"""The port's metrics plane: the run's registry and its ``stats.extra`` view.

Copy of the registry half of ``sam2consensus_tpu/observability``:
:func:`metrics` (the current run's :class:`~.metrics.MetricsRegistry`)
and the counters-and-gauges part of :func:`publish_stats_extra`.  The
failure handling (``resilience/``, ``utils/checkpoint``,
``ingest/badrecords``) counts into the registry under the reference's
names; ``TorchBackend.run`` pushes a fresh registry per run and publishes
it into ``stats.extra`` as ``JaxBackend.run`` does.

The reference's tracer, exports, decision ledger and memory plane are not
ported (ROADMAP: the observability slice), so no call site here emits a
tracer event, and no finalizer records into the registry.
"""

from __future__ import annotations

from . import metrics as _metrics
from .metrics import MetricsRegistry

__all__ = ["MetricsRegistry", "metrics", "publish_stats_extra"]


def metrics() -> MetricsRegistry:
    """The current run's registry (a process-wide one between runs)."""
    return _metrics.current()


def publish_stats_extra(extra: dict) -> None:
    """Copy of the reference's ``publish_stats_extra`` for the counters and
    gauges the port records: the recovery story (``resilience/*``,
    ``fault/*``, ``checkpoint/*``) as ints, the ingest, quarantine and
    container counters (``ingest/*``, ``quarantine/*``, ``format/*``) as
    ints or rounded floats, and the quarantine summary gauge as
    ``extra["quarantine"]``."""
    snap = metrics().snapshot()
    for name, value in snap["counters"].items():
        if name.startswith(("resilience/", "fault/", "checkpoint/")):
            extra[name] = int(value)
        elif name.startswith(("format/", "ingest/", "quarantine/")):
            extra[name] = int(value) if float(value).is_integer() \
                else round(value, 4)
    g = snap["gauges"].get("quarantine/summary")
    if g is not None and g.get("info"):
        extra["quarantine"] = g["info"]
