"""Thread-safe hierarchical span tracer with a zero-cost disabled mode.

Copy of ``sam2consensus_tpu/observability/trace.py`` (pinned by
``tests/test_torch_copies.py``).  The backend opens phase spans (decode ->
stage -> pileup dispatch -> accumulate -> insertions -> vote -> render),
the accumulators record per-slab child spans, and gate decisions attach
as structured instant events.  ``export.write_chrome_trace`` renders the
result as Chrome/Perfetto trace-event JSON.

Design constraints, in priority order:

* **disabled is free** — every hot path calls ``tracer.span(...)``
  unconditionally; when tracing is off the call returns one shared
  reusable null context manager without allocating (< 2% on a no-op
  body, pinned by ``tests/test_torch_observability.py``);
* **threads just work** — every span records its thread's ``tid`` and
  closed spans append to one shared (locked) list, so the decode
  prefetch thread and the parallel decode workers interleave safely;
  nesting is by timestamp containment within a ``tid``, which
  same-thread ``with`` blocks guarantee structurally;
* **device spans measure compute, not enqueue** — CUDA launches are
  asynchronous; ``span(..., sync=fn)`` runs ``fn`` *inside* the span
  just before taking the closing timestamp.  On CUDA the caller passes
  the accumulator's ``sync`` (a device synchronise); the tracer itself
  never touches torch.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class Span:
    """One closed span: wall-clock microseconds, Chrome-trace-shaped."""

    __slots__ = ("name", "ts_us", "dur_us", "tid", "args", "events")

    def __init__(self, name: str, ts_us: float, dur_us: float, tid: int,
                 args: Optional[dict] = None,
                 events: Optional[list] = None):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.args = args
        self.events = events      # [(name, ts_us, args), ...] instants


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def event(self, name: str, **args) -> None:
        pass

    def set_args(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()

#: per-thread stack of OPEN span names — the log-correlation surface
#: (observability/telemetry.JsonLogFormatter stamps the innermost open
#: span onto every record).  Maintained only by live spans, so the
#: disabled path stays allocation-free.
_span_tls = threading.local()


def current_span_name() -> Optional[str]:
    """The innermost open span on THIS thread (None outside any span
    or while tracing is disabled)."""
    stack = getattr(_span_tls, "stack", None)
    return stack[-1] if stack else None


class _LiveSpan:
    """An open span on one thread's stack."""

    __slots__ = ("_tracer", "_name", "_args", "_sync", "_t0_us",
                 "_events")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict],
                 sync: Optional[Callable[[], object]]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._sync = sync
        self._events: Optional[list] = None
        self._t0_us = 0.0

    def __enter__(self):
        stack = getattr(_span_tls, "stack", None)
        if stack is None:
            stack = _span_tls.stack = []
        stack.append(self._name)
        self._t0_us = (time.perf_counter() - self._tracer._epoch) * 1e6
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = getattr(_span_tls, "stack", None)
        if stack:
            stack.pop()
        if self._sync is not None and exc_type is None:
            # force device completion INSIDE the span so dur measures
            # compute; skipped when unwinding an exception (the device
            # state is undefined then and a sync could hang)
            self._sync()
        t1 = (time.perf_counter() - self._tracer._epoch) * 1e6
        self._tracer._record(Span(self._name, self._t0_us,
                                  t1 - self._t0_us,
                                  threading.get_ident(),
                                  self._args, self._events))
        return False

    def event(self, name: str, **args) -> None:
        """Attach a structured instant event to this span."""
        ts = (time.perf_counter() - self._tracer._epoch) * 1e6
        if self._events is None:
            self._events = []
        self._events.append((name, ts, args or None))

    def set_args(self, **args) -> None:
        """Merge key/values into the span's args (shown in Perfetto)."""
        if self._args is None:
            self._args = {}
        self._args.update(args)


class Tracer:
    """Collects closed spans; disabled by default (see module docstring)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._epoch = time.perf_counter()
        #: wall-clock instant of the perf_counter epoch above — the
        #: anchor the fleet flight recorder (observability/flight.py)
        #: uses to re-base this process's span microseconds onto the
        #: journal's wall clock when assembling a cross-process trace.
        #: Captured back-to-back with the perf_counter read; the
        #: microseconds of skew between the two reads is far below the
        #: journal's 1 ms timestamp granularity.
        self.epoch_unix = time.time()
        #: trace-context carried into the exported artifact
        #: (export.write_chrome_trace emits it as the ``s2c`` block):
        #: the serve runner stamps ``trace_id`` / ``key`` / ``worker``
        #: here so per-worker trace JSONs join the journal's per-job
        #: tracks without filename guessing.
        self.meta: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._thread_names: Dict[int, str] = {}

    # -- recording --------------------------------------------------------
    def span(self, name: str, sync: Optional[Callable] = None, **args):
        """Context manager timing ``name``; ``sync`` runs on exit inside
        the span (device completion).  Free when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, args or None, sync)

    def event(self, name: str, **args) -> None:
        """Top-level instant event (not attached to an open span)."""
        if not self.enabled:
            return
        ts = (time.perf_counter() - self._epoch) * 1e6
        self._record(Span(name, ts, -1.0, threading.get_ident(),
                          args or None, None))

    def complete(self, name: str, t0: float, t1: Optional[float] = None,
                 **args) -> None:
        """Record a span retroactively from ``time.perf_counter()``
        readings — for long straight-line sections where a ``with``
        block would force a 200-line reindent.  ``t0``/``t1`` are
        perf_counter seconds; ``t1`` defaults to now."""
        if not self.enabled:
            return
        if t1 is None:
            t1 = time.perf_counter()
        self._record(Span(name, (t0 - self._epoch) * 1e6,
                          (t1 - t0) * 1e6, threading.get_ident(),
                          args or None, None))

    def name_thread(self, name: str) -> None:
        """Label the calling thread in the exported trace metadata."""
        if not self.enabled:
            return
        with self._lock:
            self._thread_names[threading.get_ident()] = name

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    # -- reading ----------------------------------------------------------
    def drain(self) -> List[Span]:
        """All closed spans so far (snapshot; tracer keeps collecting)."""
        with self._lock:
            return list(self._spans)

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._thread_names)
