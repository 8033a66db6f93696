"""Self-describing per-run manifest: every number traceable to its inputs.

Copy of ``sam2consensus_tpu/observability/manifest.py`` (the same schema
id and keys; pinned by ``tests/test_torch_copies.py``).  One JSON blob
written beside ``--metrics-out`` (``<metrics_out>.manifest.json``):

* the run config (the full RunConfig dataclass, JSON-shaped);
* every live ``S2C_*`` environment override, and the port's own
  environment (``CUDA_VISIBLE_DEVICES``, ``PYTORCH_CUDA_ALLOC_CONF``,
  ``TORCH_CUDA_ARCH_LIST``) in place of the reference's ``JAX_PLATFORMS``
  and ``XLA_FLAGS``;
* the link constants the placement models priced with, their source
  (probed / env / stale-cache / default) and measured-at age;
* every ledger decision with its prediction, measured outcome, residual
  and drift verdict (``observability/ledger.py``);
* the phase/wire counter summary, the memory plane's gauges and any
  drift events;
* ``git describe`` of the running tree and sha256 hashes of the trace
  and metrics artifacts the same run wrote.

``meta`` (from ``finish_run``) names the backend and the device: the
card's name (``torch.cuda.get_device_name``) or ``cpu``.  Schema id
``s2c-manifest/1``; consumers must tolerate added keys.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from typing import List, Optional

SCHEMA = "s2c-manifest/1"

#: env prefixes that are model/gate inputs — recorded verbatim so a
#: committed artifact shows every constant override that was live
_ENV_PREFIXES = ("S2C_",)
_ENV_EXACT = ("CUDA_VISIBLE_DEVICES", "PYTORCH_CUDA_ALLOC_CONF",
              "TORCH_CUDA_ARCH_LIST")

_git_cache: List[Optional[str]] = []


def git_describe() -> Optional[str]:
    """``git describe --always --dirty`` of the repo this package runs
    from (cached per process; None outside a work tree)."""
    if _git_cache:
        return _git_cache[0]
    out: Optional[str] = None
    try:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        r = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--tags"],
            capture_output=True, text=True, timeout=5, cwd=root)
        if r.returncode == 0:
            out = r.stdout.strip() or None
    except Exception:
        out = None
    _git_cache.append(out)
    return out


def env_overrides() -> dict:
    return {k: os.environ[k] for k in sorted(os.environ)
            if k.startswith(_ENV_PREFIXES) or k in _ENV_EXACT}


def file_digest(path: str) -> Optional[str]:
    try:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        return "sha256:" + h.hexdigest()
    except OSError:
        return None


def _link_section(snap: dict) -> dict:
    """Link-constant provenance: probe state (utils/linkprobe) plus the
    run's recorded link gauges."""
    from ..utils import linkprobe

    link = dict(linkprobe.link_info())
    for g in ("link/rt_sec", "link/bps", "link/stale", "link/stale_age",
              "link/probe_failed"):
        entry = snap["gauges"].get(g)
        if entry is not None:
            link[g.split("/", 1)[1]] = entry["value"]
    return link


def build_manifest(registry, ledger_records, meta: Optional[dict] = None,
                   config: Optional[dict] = None,
                   artifacts: Optional[dict] = None) -> dict:
    snap = registry.snapshot()
    counters = snap["counters"]
    phases = {k: round(v, 6) for k, v in counters.items()
              if k.startswith("phase/")}
    wire = {k: v for k, v in counters.items()
            if k.startswith(("wire/", "pipeline/"))}
    # serve-mode amortization story: cross-job overlap seconds plus the
    # jit/persistent compile-cache hit counters that prove the warm
    # path actually skipped work (empty dict for cold one-shot runs).
    # Structured serve gauges ride along — serve/health (the runner's
    # readiness snapshot at job start), serve/recovery (journal-resume
    # provenance: what a restarted queue skipped and resumed),
    # serve/watchdog (the deadline/stall verdict that abandoned a job)
    # slo/* (per-tenant objective burn counters) and telemetry/*
    # (exposition-writer health, profiler captures) ride the serve
    # section: the fleet-telemetry verdicts live next to the serve
    # counters they explain (observability/telemetry.py)
    serve = {k: v for k, v in counters.items()
             if k.startswith(("serve/", "compile/", "slo/",
                              "telemetry/"))}
    for name, g in snap["gauges"].items():
        if name.startswith(("serve/", "slo/", "telemetry/")) \
                and g.get("info"):
            serve[name] = g["info"]
    # tolerant-decode evidence: bad-record counts per taxonomy reason
    # plus the quarantine summary (mode, sidecar path, truncation) —
    # empty dict on clean strict runs
    ingest = {k: int(v) for k, v in counters.items()
              if k.startswith(("ingest/bad_records", "quarantine/"))}
    qg = snap["gauges"].get("quarantine/summary")
    if qg is not None and qg.get("info"):
        ingest["quarantine/summary"] = qg["info"]
    # streaming sessions (serve/session.py + serve/stream_server.py):
    # wave absorb/reject/steal tallies plus the front door's request
    # counters — the manifest's record of the live-ingest plane
    # (empty dict outside session mode).  ``ingest/bad_records*``
    # stays in the ingest section above: that family is the per-job
    # tolerant-decode taxonomy, not the network front door
    sessions = {k: v for k, v in counters.items()
                if k.startswith("session/")
                or (k.startswith("ingest/")
                    and not k.startswith("ingest/bad_records"))}
    for name, g in snap["gauges"].items():
        if name.startswith("session/"):
            sessions[name] = g["value"]
    # memory plane (observability/memplane.py): per-family live/peak
    # gauges, the peak-tracked ratchet, process/device watermarks and
    # any OOM-dump tally — the manifest answers "what did this run
    # actually pin" next to "how long did it take"
    memory: dict = {k: int(v) for k, v in counters.items()
                    if k.startswith("mem/")}
    for name, g in snap["gauges"].items():
        if name.startswith("mem/"):
            memory[name] = g["value"]
    decisions = []
    for rec in ledger_records:
        d = rec.to_dict() if hasattr(rec, "to_dict") else dict(rec)
        decisions.append(d)
    # flight-recorder lifecycle seed (observability/flight.py): the
    # sched/trace info gauge carries the job's trace-context
    # (trace_id = journal key) so a cold-written manifest already
    # joins the fleet trace; the serve runner's finalize then
    # overlays the full journal-measured ``lifecycle`` section
    # (queue wait, claim/steal latency, worker) on top of this.
    lifecycle: dict = {}
    tg = snap["gauges"].get("sched/trace")
    if tg is not None and tg.get("info"):
        lifecycle = dict(tg["info"])
    return {
        "schema": SCHEMA,
        "created_unix": round(time.time(), 3),
        "git": git_describe(),
        "meta": dict(meta or {}),
        "config": config,
        "env_overrides": env_overrides(),
        "link": _link_section(snap),
        "decisions": decisions,
        "phases": phases,
        "wire": wire,
        "serve": serve,
        "ingest": ingest,
        "sessions": sessions,
        "memory": memory,
        "lifecycle": lifecycle,
        "drift_events": int(counters.get("drift/events", 0)),
        "artifacts": dict(artifacts or {}),
    }


def manifest_path_for(metrics_out: str) -> str:
    """The manifest path derived from a ``--metrics-out`` destination."""
    return metrics_out + ".manifest.json"


def write_manifest(path: str, manifest: dict) -> None:
    from .export import _json_default

    with open(path, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=False,
                  default=_json_default)
        fh.write("\n")


def summarize(manifest: dict) -> dict:
    """The compact form bench rows embed: decisions + provenance, no
    full config/phase dump (those live in the row already)."""
    return {
        "schema": manifest["schema"],
        "git": manifest.get("git"),
        "env_overrides": manifest.get("env_overrides", {}),
        "link": manifest.get("link", {}),
        "decisions": [
            {k: d[k] for k in ("decision", "chosen", "predicted",
                               "measured", "residual", "drift")
             if k in d}
            for d in manifest.get("decisions", [])],
        "drift_events": manifest.get("drift_events", 0),
    }
