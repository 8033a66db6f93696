"""The port's tracer: the run's spans, and under a running ``torch.profiler``
the same spans on the device trace's clock.

:class:`DeviceTracer` is :class:`~.trace.Tracer` (the reference's copy,
left as it is) with one change to :meth:`~DeviceTracer.span`.  While a
profiler records, the span also opens ``torch.profiler.record_function``
of its name: the profile then holds a ``user_annotation`` event on the
profiler's clock, the clock of CUPTI's kernel and copy events, so a gap in
the card's timeline can be named after the host work under it.  The
profiler that is already running turns the bridge on; there is no flag of
its own.

* **profiler off, tracer disabled** — one read of
  ``torch.autograd.profiler._is_profiler_enabled`` and the shared
  ``_NULL_SPAN``, with no allocation (the reference's "disabled is free");
* **profiler on** — the ``record_function`` range encloses the run's span
  (or the null span when the tracer is disabled), its ``sync`` included,
  so both end after the device work the span waits for;
* ``complete()`` and ``event()`` are the reference's: they are recorded
  after the fact and cannot open a profiler range.

The flag is read from ``torch.autograd.profiler`` once torch is loaded
(no profiler runs before), so importing this module does not load torch.
A ``record_function`` on a thread the profiler does not record (a thread
started inside a default ``torch.profiler.profile`` window) records
nothing; the leaf spans that carry the serving thread's waits are
therefore on that thread (see :mod:`sam2consensus_torch.observability`).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from .trace import _NULL_SPAN, _LiveSpan, Tracer

#: ``torch.autograd.profiler`` once something has imported torch
_profiler_mod = None


def _loaded_profiler():
    """``torch.autograd.profiler`` if it is fully imported, else None
    (cached once found)."""
    global _profiler_mod
    mod = sys.modules.get("torch.autograd.profiler")
    if mod is not None and hasattr(mod, "record_function"):
        _profiler_mod = mod
        return mod
    return None


class _BridgedSpan:
    """A span under a running profiler: a ``record_function`` range
    around the run's span (a live one, or the null span)."""

    __slots__ = ("_range", "_inner")

    def __init__(self, name: str, inner):
        self._range = _profiler_mod.record_function(name)
        self._inner = inner

    def __enter__(self):
        self._range.__enter__()
        self._inner.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            self._inner.__exit__(exc_type, exc, tb)
        finally:
            self._range.__exit__(exc_type, exc, tb)
        return False

    def event(self, name: str, **args) -> None:
        self._inner.event(name, **args)

    def set_args(self, **args) -> None:
        self._inner.set_args(**args)


class DeviceTracer(Tracer):
    """The run's tracer, bridged onto the profiler's clock (module
    docstring)."""

    def span(self, name: str, sync: Optional[Callable] = None, **args):
        """Context manager timing ``name`` (``Tracer.span``); under a
        running profiler also a ``record_function`` range of ``name``.
        Free when the tracer is disabled and no profiler runs."""
        prof = _profiler_mod or _loaded_profiler()
        if prof is not None and prof._is_profiler_enabled:
            inner = (_LiveSpan(self, name, args or None, sync)
                     if self.enabled else _NULL_SPAN)
            return _BridgedSpan(name, inner)
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, args or None, sync)
