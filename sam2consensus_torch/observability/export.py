"""Exports: Chrome/Perfetto trace-event JSON and a JSONL metrics sink.

Copy of ``sam2consensus_tpu/observability/export.py`` (pinned by
``tests/test_torch_copies.py``), whose :func:`_json_default` also
serialises a 0-d ``torch.Tensor`` (its value) and a ``torch.device`` (its
name), which the port's span and gauge args may carry.

* ``write_chrome_trace``: the trace-event "JSON object format" —
  ``ph: "X"`` complete events with ``ts``/``dur`` in microseconds,
  ``ph: "i"`` instants for span events and gate decisions, plus
  ``thread_name`` metadata so the decode prefetch and parallel-decode
  worker threads are labelled.  Load via https://ui.perfetto.dev or
  chrome://tracing.
* ``write_metrics_jsonl``: one JSON object per line, one line per
  instrument (``{"kind": "counter"|"gauge"|"histogram", "name": ...,
  ...}``), preceded by one ``{"kind": "meta", ...}`` header line.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .metrics import MetricsRegistry
from .trace import Tracer


def chrome_trace_events(tracer: Tracer, pid: Optional[int] = None) -> list:
    """Tracer spans -> a list of Chrome trace-event dicts."""
    pid = os.getpid() if pid is None else pid
    events = []
    for tid, name in tracer.thread_names().items():
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    for s in tracer.drain():
        if s.dur_us < 0:
            ev = {"ph": "i", "name": s.name, "pid": pid, "tid": s.tid,
                  "ts": s.ts_us, "s": "t"}
            if s.args:
                ev["args"] = s.args
            events.append(ev)
            continue
        ev = {"ph": "X", "name": s.name, "pid": pid, "tid": s.tid,
              "ts": s.ts_us, "dur": s.dur_us}
        if s.args:
            ev["args"] = s.args
        events.append(ev)
        for ename, ets, eargs in (s.events or ()):
            iev = {"ph": "i", "name": ename, "pid": pid, "tid": s.tid,
                   "ts": ets, "s": "t"}
            if eargs:
                iev["args"] = eargs
            events.append(iev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


def _json_default(o):
    """Keep exports schema-valid whatever rides in span/gauge args:
    numpy scalars/arrays and 0-d torch tensors become their python
    values, a torch device its name, anything else its repr-ish
    string — an exotic arg must never turn a whole trace
    artifact into a crash."""
    try:
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:
        pass
    import sys

    torch = sys.modules.get("torch")
    if torch is not None:
        if isinstance(o, torch.Tensor) and o.dim() == 0:
            return o.item()
        if isinstance(o, torch.device):
            return str(o)
    return str(o)


def write_chrome_trace(tracer: Tracer, path: str) -> None:
    blob = {"traceEvents": chrome_trace_events(tracer),
            "displayTimeUnit": "ms",
            # trace-context block for the fleet flight recorder
            # (observability/flight.py): epoch_unix re-anchors this
            # process's perf_counter microseconds onto the journal's
            # wall clock; trace_id/key/worker (stamped by the serve
            # runner into tracer.meta) join this artifact to its
            # journal per-job track.  Perfetto ignores unknown
            # top-level keys, so the file stays loadable as-is.
            "s2c": {"epoch_unix": getattr(tracer, "epoch_unix", None),
                    **getattr(tracer, "meta", {})}}
    # explicit utf-8: ensure_ascii=False emits raw unicode, and a
    # C/POSIX-locale CI host must not turn a unicode span label into a
    # lost artifact
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(blob, fh, ensure_ascii=False, default=_json_default)
        fh.write("\n")


def write_metrics_jsonl(registry: MetricsRegistry, path: str,
                        meta: Optional[dict] = None) -> None:
    snap = registry.snapshot()
    with open(path, "w", encoding="utf-8") as fh:
        header = {"kind": "meta", "pid": os.getpid()}
        if meta:
            header.update(meta)
        fh.write(json.dumps(header, default=_json_default) + "\n")
        for name, value in snap["counters"].items():
            fh.write(json.dumps({"kind": "counter", "name": name,
                                 "value": value},
                                default=_json_default) + "\n")
        for name, entry in snap["gauges"].items():
            row = {"kind": "gauge", "name": name, "value": entry["value"]}
            if "info" in entry:
                row["info"] = entry["info"]
            fh.write(json.dumps(row, default=_json_default) + "\n")
        for name, entry in snap["histograms"].items():
            fh.write(json.dumps({"kind": "histogram", "name": name,
                                 **entry}, default=_json_default) + "\n")


def read_metrics_jsonl(path: str) -> list:
    """Parse a metrics JSONL sink back into a list of row dicts."""
    rows = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
