"""Process-wide metrics registry: counters, gauges, histograms.

Copy of ``sam2consensus_tpu/observability/metrics.py`` (pinned by
``tests/test_torch_copies.py``): the store that the port's failure
handling counts into (``resilience/*``, ``fault/*``, ``checkpoint/*``,
``ingest/bad_records/*``, ``quarantine/*``), and everything else the
run counts.  ``TorchBackend.run`` installs a fresh registry per run
(``observability.start_run``, which calls ``push_run``) and copies its
view into ``stats.extra`` (``observability.publish_stats_extra``).

Without the reference's serve-side views (``Windowed``,
``window_values``, ``Histogram.merge``).  Three instrument kinds:

* counters — monotonic float adds; seconds, bytes, reads, cells;
* gauges — last-write-wins value (``.set(v)``), with optional
  structured payload (``.set_info(dict)``) for decision records like
  the tail-placement model's inputs;
* histograms — bounded reservoir of observations; the snapshot reports
  count/sum/min/max and p50/p95/p99.

Thread-safety contract: mutate counters and histograms through the
REGISTRY methods — ``registry.add(name, n)`` / ``registry.observe(name,
v)`` — which hold the registry lock across the read-modify-write (the
decode prefetch thread and the consumer both add phase seconds).  The
``counter()`` / ``histogram()`` handle accessors are for reads and
single-writer use only: ``handle.add()`` is an unlocked ``+=``.  Gauge
``set``/``set_info`` are single-store writes and safe from any thread.

A process-wide *current* registry (``current()``) lets deep call sites
(ops/pileup dispatch, utils/linkprobe, the parallel accumulators)
record without threading a handle through every signature; the backend
swaps in a fresh registry per run (``push_run()`` / ``pop_run()``) so
per-run stats never bleed across the bench's warm/timed repetitions.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

#: histogram reservoir bound: big enough for per-slab observations over
#: any real run, small enough that a snapshot's sort is microseconds
HIST_CAP = 4096


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def add(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value", "info")

    def __init__(self):
        self.value = 0.0
        self.info: Optional[dict] = None

    def set(self, v: float) -> None:
        self.value = v

    def set_info(self, info: dict) -> None:
        """Attach a structured payload (decision inputs, chosen path)."""
        self.info = info


class Histogram:
    __slots__ = ("values", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.values) < HIST_CAP:
            self.values.append(v)
        else:
            # deterministic decimating reservoir: overwrite round-robin
            # so late observations still register without randomness
            self.values[self.count % HIST_CAP] = v

    def percentile(self, q: float) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        idx = min(len(s) - 1, int(q * (len(s) - 1) + 0.5))
        return s[idx]


class MetricsRegistry:
    """Thread-safe named instruments; see the module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def add(self, name: str, n: float = 1.0) -> None:
        """Locked read-modify-write counter add (safe across threads)."""
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            c.value += n

    def observe(self, name: str, v: float) -> None:
        """Locked histogram observe (safe across threads)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(v)

    def value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            c = self._counters.get(name)
            if c is not None:
                return c.value
            g = self._gauges.get(name)
            if g is not None:
                return g.value
            return default

    def info(self, name: str) -> Optional[dict]:
        """A gauge's structured payload (``set_info``), or None — the
        read side of decision/health records (serve health snapshots,
        the manifest's serve section) without snapshotting the whole
        registry."""
        with self._lock:
            g = self._gauges.get(name)
            return dict(g.info) if g is not None and g.info else None

    def snapshot(self) -> dict:
        """One JSON-shaped dict of every instrument's current state."""
        with self._lock:
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for name, c in self._counters.items():
                out["counters"][name] = c.value
            for name, g in self._gauges.items():
                entry: dict = {"value": g.value}
                if g.info is not None:
                    entry["info"] = g.info
                out["gauges"][name] = entry
            for name, h in self._hists.items():
                out["histograms"][name] = {
                    "count": h.count,
                    "sum": round(h.total, 9),
                    "min": h.vmin if h.count else 0.0,
                    "max": h.vmax if h.count else 0.0,
                    "p50": h.percentile(0.50),
                    "p95": h.percentile(0.95),
                    "p99": h.percentile(0.99),
                }
            return out


# -- process-current registry ---------------------------------------------
_process_registry = MetricsRegistry()
_current: List[MetricsRegistry] = [_process_registry]
_current_lock = threading.Lock()
#: thread-local OVERRIDE of the process-current registry: serve mode
#: (sam2consensus_tpu/serve) decodes job N+1 on a side thread while job
#: N's registry is process-current, and that thread's phase seconds
#: must land in job N+1's registry, not bleed into job N's
_tls = threading.local()


def current() -> MetricsRegistry:
    """The registry deep call sites record into (never None).  A
    thread-bound registry (:func:`bind_thread`) wins over the
    process-current stack."""
    reg = getattr(_tls, "registry", None)
    return reg if reg is not None else _current[-1]


def bind_thread(registry: Optional[MetricsRegistry]) -> None:
    """Route THIS thread's :func:`current` to ``registry`` (None
    unbinds).  Per-thread, so a serve decode-ahead thread records into
    its own job's registry while the main thread keeps the
    process-current one."""
    _tls.registry = registry


def push_run(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Install a fresh per-run registry as current; returns it."""
    reg = registry if registry is not None else MetricsRegistry()
    with _current_lock:
        _current.append(reg)
    return reg


def pop_run(registry: MetricsRegistry) -> None:
    """Uninstall a per-run registry (tolerates unbalanced exits)."""
    with _current_lock:
        if len(_current) > 1 and _current[-1] is registry:
            _current.pop()
        elif registry in _current[1:]:
            _current.remove(registry)
