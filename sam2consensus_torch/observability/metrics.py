"""Process-wide metrics registry: counters, gauges, histograms.

Copy of ``sam2consensus_tpu/observability/metrics.py`` (pinned by
``tests/test_torch_copies.py``): the store that the port's failure
handling counts into (``resilience/*``, ``fault/*``, ``checkpoint/*``,
``ingest/bad_records/*``, ``quarantine/*``), and everything else the
run counts.  ``TorchBackend.run`` installs a fresh registry per run
(``observability.start_run``, which calls ``push_run``) and copies its
view into ``stats.extra`` (``observability.publish_stats_extra``).

With the serve runner's views: ``Histogram.merge`` (the aggregate
registry's fold) and the stamped ``Windowed`` ring behind
``window_values`` (the burn monitor).  Three instrument kinds:

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

#: windowed-view ring bound: a (stamp, value) pair per observation —
#: at one serve job per second this holds >1 h of job-boundary
#: observations, which is exactly the slow burn window's horizon
WINDOW_CAP = 4096


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

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in: count/total/min/max merge
        EXACTLY; the bounded reservoir absorbs the other's samples
        through the same deterministic round-robin decimation
        ``observe`` uses — so fleet-level percentiles over merged
        per-job histograms stay meaningful (approximate past HIST_CAP,
        exact below it).  Used by the telemetry plane's
        server-lifetime :class:`~.telemetry.AggregateRegistry`."""
        if other.count == 0:
            return
        self.total += other.total
        if other.vmin < self.vmin:
            self.vmin = other.vmin
        if other.vmax > self.vmax:
            self.vmax = other.vmax
        for v in other.values:
            self.count += 1
            if len(self.values) < HIST_CAP:
                self.values.append(v)
            else:
                self.values[self.count % HIST_CAP] = v
        # observations the other reservoir itself decimated away still
        # count toward the merged count (sum/min/max already carry them)
        self.count += other.count - len(other.values)

    def percentile(self, q: float) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        idx = min(len(s) - 1, int(q * (len(s) - 1) + 0.5))
        return s[idx]


class Windowed:
    """Timestamped ring buffer: the WINDOWED view over a histogram's
    observation stream (the multi-window SLO burn plane's substrate,
    observability/burn.py).  Histograms deliberately forget WHEN an
    observation happened — fleet percentiles don't need it — but burn
    rates are meaningless without it: "violations per evaluated
    objective over the last 5 minutes" needs stamps.  Bounded like the
    reservoir (WINDOW_CAP ring, oldest overwritten), so a runaway
    queue cannot grow it; reads tolerate the wrap by filtering on
    stamp, not position."""

    __slots__ = ("items", "count")

    def __init__(self):
        self.items: List[tuple] = []     # (stamp_unix, value) ring
        self.count = 0

    def observe(self, v: float, stamp: float) -> None:
        if len(self.items) < WINDOW_CAP:
            self.items.append((stamp, v))
        else:
            self.items[self.count % WINDOW_CAP] = (stamp, v)
        self.count += 1

    def window(self, seconds: float, now: float) -> List[float]:
        """Values observed within the trailing ``seconds`` of ``now``
        (unsorted; the ring wraps out of stamp order past the cap)."""
        lo = now - seconds
        return [v for (t, v) in self.items if lo <= t <= now]


class MetricsRegistry:
    """Thread-safe named instruments; see the module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._windows: Dict[str, Windowed] = {}

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

    def observe(self, name: str, v: float,
                stamp: Optional[float] = None) -> None:
        """Histogram observe; with ``stamp`` (a wall time) the value
        ALSO lands in the name's windowed ring so burn-style trailing-
        window reads work (:meth:`window_values`).  Stampless
        observations stay windowless — one-shot runs pay nothing."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(v)
            if stamp is not None:
                w = self._windows.get(name)
                if w is None:
                    w = self._windows[name] = Windowed()
                w.observe(v, stamp)

    def window_values(self, name: str, seconds: float,
                      now: Optional[float] = None) -> List[float]:
        """The name's stamped observations within the trailing window
        (empty when never stamped) — the burn plane's read side."""
        import time as _time

        with self._lock:
            w = self._windows.get(name)
            if w is None:
                return []
            return w.window(seconds,
                            now if now is not None else _time.time())

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
#: (sam2consensus_torch/serve) decodes job N+1 on a side thread while job
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
