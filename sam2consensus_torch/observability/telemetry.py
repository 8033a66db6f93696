"""Structured JSON logging with correlation context, and the atomic writer.

Copy of the one-shot part of ``sam2consensus_tpu/observability/
telemetry.py`` (pinned by ``tests/test_torch_copies.py``):
:func:`set_log_context` / :func:`get_log_context`, :class:`JsonLogFormatter`
(``--log-format json``) and :func:`atomic_write_text` (the memory plane's
forensic dump).  The serve-side telemetry (aggregate registry,
OpenMetrics exposition, telemetry server, profiler capture, SLO parsing)
waits for the serve slice.
"""

from __future__ import annotations

import json
import logging
import os
import threading


def atomic_write_text(path: str, text: str) -> None:
    """tmp + fsync + ``os.replace``: a reader polling ``path`` never
    sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


_log_ctx = threading.local()


def set_log_context(**fields) -> None:
    """Set THIS thread's log-correlation fields (``job_id``,
    ``tenant``, ``rung``, ...); call with no arguments to clear."""
    _log_ctx.fields = {k: v for k, v in fields.items()
                       if v not in (None, "")} or None


def get_log_context() -> dict:
    return dict(getattr(_log_ctx, "fields", None) or {})


class JsonLogFormatter(logging.Formatter):
    """One JSON object per record: ts/level/logger/msg plus the
    thread's correlation context and the innermost open trace span
    (``--log-format json``)."""

    def format(self, record: logging.LogRecord) -> str:
        from . import trace as _trace

        obj = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        obj.update(get_log_context())
        span = _trace.current_span_name()
        if span:
            obj["span"] = span
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, ensure_ascii=False, default=str)
