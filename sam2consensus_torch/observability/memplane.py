"""Memory plane: host and device byte accounting, watermarks, forensics.

The one-shot and serve parts of
``sam2consensus_tpu/observability/memplane.py`` (the process-spanning
mesh planner ``plan_mesh_shards`` is not ported yet); the copied functions
are pinned by ``tests/test_torch_copies.py``.

**Byte accounting.**  Every long-lived allocation family registers
through one choke point, :func:`adjust` (:func:`track` / :func:`release`,
or :func:`track_obj`, released when the object is collected):

====================  ====================================================
family                what it holds
====================  ====================================================
``counts``            the device accumulator's ``[L, 6]`` int32 counts
``counts_host``       the host-counts accumulator's counts
``wire_staging``      a batch's rows staged on the card (prefetch thread)
``insertion_table``   the insertion table and the padded event lanes
``quarantine``        the tolerant decode's stored sidecar window
``decode_ahead``      a serve job's batches decoded ahead of its run
====================  ====================================================

The plane keeps process-wide live/peak bytes per family and publishes
into the *current* metrics registry: ``mem/live_bytes/<family>`` /
``mem/peak_bytes/<family>`` gauges and the ``mem/peak_tracked_bytes``
ratchet counter.  The plane is pure accounting (``S2C_MEMPLANE=0`` turns
it off; the bytes a run computes are the same either way).

**The finalizer takes no lock.**  The reference's ``track_obj`` finalizer
calls ``adjust``, which takes the plane's lock and then the registry's
non-reentrant lock; a collection inside ``MetricsRegistry.gauge()`` then
deadlocks the thread on its own lock.  Here a finalizer only appends
``(family, bytes)`` to a deque (an atomic append, no Python lock), and
:func:`adjust`, :func:`sample`, :func:`summary` and the run's end
(``observability.finish_run``) apply the queued releases outside any
lock.  The numbers a run publishes are the reference's.

**Watermarks.**  :func:`sample` reads the process RSS, tracemalloc (only
when the caller already traces) and, on CUDA, the caching allocator's
``torch.cuda.memory_stats``: ``mem/rss_mb``, ``mem/peak_rss_mb``,
``mem/device_bytes_in_use`` and ``mem/device_peak_bytes`` (the
allocator's peak since the process started or since the caller's last
``torch.cuda.reset_peak_memory_stats``; nothing here resets it).

**Capacity model.**  :func:`predict_run_peak_bytes` prices a run's peak
from the port's own buffers: the ``[L, 6]`` int32 counts, two staged
slabs of the pinned ring, K1's plan of one slab, the tail's position
head and the insertion table.  :func:`record_capacity` registers it as
the ``capacity`` ledger decision, joined against ``mem/peak_tracked_bytes``
with an informational residual (band 0: the model is an upper bound).

**Forensics.**  :func:`dump_on_capacity` writes ``mem_dump.json`` (schema
``s2c-mem-dump/1``) next to ``--metrics-out`` when a failure classifies
CAPACITY (``resilience.policy``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional, Tuple

logger = logging.getLogger("sam2consensus_torch.observability.memplane")

#: the allocation families the port's call sites use (informational:
#: track() accepts any name)
FAMILIES = ("counts", "counts_host", "wire_staging", "insertion_table",
            "quarantine", "decode_ahead", "count_cache", "packed_batch")

MEM_DUMP_SCHEMA = "s2c-mem-dump/1"
MEM_DUMP_NAME = "mem_dump.json"

#: watermark history ring bound
HISTORY_CAP = 256


def enabled() -> bool:
    """The plane's on/off gate (``S2C_MEMPLANE``; default on), read live
    (one getenv an accounting event; events are per run, slab or entry,
    never per row)."""
    return os.environ.get("S2C_MEMPLANE", "1").lower() \
        not in ("0", "off", "false")


class _Plane:
    """Process-wide accounting state (families outlive runs)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live: Dict[str, int] = {}
        self.peak: Dict[str, int] = {}
        self.total_live = 0
        self.total_peak = 0
        self.history: deque = deque(maxlen=HISTORY_CAP)
        self.last_capacity: Optional[dict] = None
        self.last_sample: Optional[dict] = None


_plane = _Plane()
#: releases queued by finalizers, applied by :func:`drain_releases`
_released: deque = deque()


def _publish(family: str, live: int, total: int) -> None:
    """Mirror one adjustment into the CURRENT registry: live gauges are
    absolute (process-wide), peak gauges/counters ratchet per registry."""
    from .metrics import current as _current_registry

    reg = _current_registry()
    reg.gauge(f"mem/live_bytes/{family}").set(float(live))
    g = reg.gauge(f"mem/peak_bytes/{family}")
    if live > g.value:
        g.set(float(live))
    reg.gauge("mem/live_tracked_bytes").set(float(total))
    have = reg.value("mem/peak_tracked_bytes")
    if total > have:
        reg.add("mem/peak_tracked_bytes", total - have)


def _apply(family: str, delta: int) -> None:
    with _plane.lock:
        live = max(0, _plane.live.get(family, 0) + int(delta))
        _plane.live[family] = live
        if live > _plane.peak.get(family, 0):
            _plane.peak[family] = live
        _plane.total_live = max(0, _plane.total_live + int(delta))
        if _plane.total_live > _plane.total_peak:
            _plane.total_peak = _plane.total_live
        # lock order plane -> registry, used nowhere in the other
        # direction (finalizers take neither)
        _publish(family, live, _plane.total_live)


def drain_releases() -> None:
    """Apply the releases that finalizers queued.  Called outside any
    lock: by :func:`adjust`, :func:`sample`, :func:`summary` and the
    run's end."""
    while True:
        try:
            family, n = _released.popleft()
        except IndexError:
            return
        if enabled():
            _apply(family, -n)


def defer_release(family: str, nbytes: int) -> None:
    """The finalizer's half of :func:`track_obj` (and of the quarantine
    sink's): queue the release; take no lock, allocate nothing that can
    reach the registry.  The garbage collector may run this inside any
    allocation, including one made while a registry lock is held."""
    if nbytes > 0:
        _released.append((family, int(nbytes)))


def adjust(family: str, delta: int) -> None:
    """THE residency choke point: add ``delta`` bytes (negative =
    release) to ``family``'s live total and publish live/peak."""
    drain_releases()
    if delta == 0 or not enabled():
        return
    _apply(family, int(delta))


def track(family: str, nbytes: int) -> None:
    """Register ``nbytes`` of live residency under ``family``."""
    if nbytes > 0:
        adjust(family, int(nbytes))


def release(family: str, nbytes: int) -> None:
    """The matching release (callers with explicit lifecycles)."""
    if nbytes > 0:
        adjust(family, -int(nbytes))


def track_obj(family: str, obj, nbytes: int) -> None:
    """Track ``nbytes`` against ``obj``'s lifetime: released (queued by
    the finalizer, applied at the next drain) when the object is
    collected.  An object that cannot carry a weakref is counted toward
    the family peak and released at once."""
    if nbytes <= 0 or not enabled():
        return
    n = int(nbytes)
    track(family, n)
    try:
        weakref.finalize(obj, defer_release, family, n)
    except TypeError:
        adjust(family, -n)


def batch_nbytes(batch) -> int:
    """Resident bytes of one decoded SegmentBatch (bucket operands and
    any staged tensors)."""
    n = 0
    for starts, codes in getattr(batch, "buckets", {}).values():
        n += int(getattr(starts, "nbytes", 0))
        n += int(getattr(codes, "nbytes", 0))
    for staged in getattr(batch, "staged", {}).values():
        for t in getattr(staged, "operands", ()) or ():
            n += int(t.numel() * t.element_size())
    return n


# =========================================================================
# Watermarks
# =========================================================================
def rss_bytes() -> Tuple[int, int]:
    """(current, peak) process RSS in bytes: peak by
    ``resource.getrusage``, current by ``/proc/self/statm`` (0 where it
    does not exist)."""
    peak = 0
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        peak = int(ru) if sys.platform == "darwin" else int(ru) * 1024
    except Exception:
        pass
    cur = 0
    try:
        with open("/proc/self/statm") as fh:
            cur = int(fh.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE")
                                               if hasattr(os, "sysconf")
                                               else 4096)
    except Exception:
        pass
    return cur, peak


def device_memory_stats(device=None) -> Optional[dict]:
    """``{bytes_in_use, peak_bytes_in_use, bytes_limit}`` of a CUDA
    device from the caching allocator (``torch.cuda.memory_stats``:
    ``allocated_bytes.all.current`` and ``.peak``; the card's
    ``total_memory``).  None for a CPU ``device``, and in a process that
    has not initialised CUDA: the plane never initialises it."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        stats = torch.cuda.memory_stats(dev)
        limit = torch.cuda.get_device_properties(dev).total_memory
    except Exception:
        return None
    out = {}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak")):
        v = stats.get(src)
        if isinstance(v, (int, float)):
            out[key] = int(v)
    out["bytes_limit"] = int(limit)
    return out


def sample(registry=None, device=None) -> dict:
    """One watermark sample: RSS, tracemalloc (when tracing), the
    device's allocator bytes and the plane's tracked totals; appended to
    the history ring and published as ``mem/*`` gauges into ``registry``
    (default: the current registry)."""
    drain_releases()
    cur, peak = rss_bytes()
    with _plane.lock:
        tracked_live = _plane.total_live
        tracked_peak = _plane.total_peak
    s = {
        "unix": round(time.time(), 3),
        "rss_mb": round(cur / 1e6, 2),
        "peak_rss_mb": round(peak / 1e6, 2),
        "tracked_live_bytes": tracked_live,
        "tracked_peak_bytes": tracked_peak,
    }
    try:
        import tracemalloc

        if tracemalloc.is_tracing():
            traced, tpeak = tracemalloc.get_traced_memory()
            s["tracemalloc_mb"] = round(traced / 1e6, 2)
            s["tracemalloc_peak_mb"] = round(tpeak / 1e6, 2)
    except Exception:
        pass
    dev = device_memory_stats(device)
    if dev is not None:
        s["device_bytes_in_use"] = dev.get("bytes_in_use", 0)
        if "peak_bytes_in_use" in dev:
            s["device_peak_bytes"] = dev["peak_bytes_in_use"]
    with _plane.lock:
        _plane.history.append(s)
        _plane.last_sample = s
    if enabled():
        if registry is None:
            from .metrics import current as _current_registry

            registry = _current_registry()
        registry.gauge("mem/rss_mb").set(s["rss_mb"])
        registry.gauge("mem/peak_rss_mb").set(s["peak_rss_mb"])
        if "device_bytes_in_use" in s:
            registry.gauge("mem/device_bytes_in_use").set(
                float(s["device_bytes_in_use"]))
        if "device_peak_bytes" in s:
            registry.gauge("mem/device_peak_bytes").set(
                float(s["device_peak_bytes"]))
        # per-family live/peak into THIS registry too, under the plane
        # lock like _publish (the peak ratchets are read-then-write)
        with _plane.lock:
            for f in set(_plane.live) | set(_plane.peak):
                live = _plane.live.get(f, 0)
                registry.gauge(f"mem/live_bytes/{f}").set(float(live))
                g = registry.gauge(f"mem/peak_bytes/{f}")
                if live > g.value:
                    g.set(float(live))
            total_live = _plane.total_live
            registry.gauge("mem/live_tracked_bytes").set(
                float(total_live))
            have = registry.value("mem/peak_tracked_bytes")
            if total_live > have:
                registry.add("mem/peak_tracked_bytes",
                             total_live - have)
    return s


def history_tail(n: int = 64) -> list:
    """The newest ``n`` watermark samples (forensic dump tail)."""
    with _plane.lock:
        return list(_plane.history)[-n:]


def summary() -> dict:
    """Per-family live/peak plus the latest watermarks (sampled fresh
    when none exist yet)."""
    drain_releases()
    with _plane.lock:
        fams = {f: {"live_bytes": _plane.live.get(f, 0),
                    "peak_bytes": _plane.peak.get(f, 0)}
                for f in sorted(set(_plane.live) | set(_plane.peak))}
        totals = {"live_bytes": _plane.total_live,
                  "peak_bytes": _plane.total_peak}
        last = _plane.last_sample
    return {
        "families": fams,
        "tracked": totals,
        "watermarks": dict(last) if last is not None else sample(),
        "enabled": enabled(),
    }


# =========================================================================
# Capacity model
# =========================================================================
def predict_run_peak_bytes(total_len: int, n_thresholds: int = 1,
                           chunk_reads: int = 262144,
                           read_len: int = 150, segment_width: int = 0,
                           n_reads: Optional[int] = None,
                           host_counts: bool = False,
                           insertion_table_bytes: int = 0,
                           shards: int = 1
                           ) -> Tuple[int, Dict[str, int]]:
    """Predicted peak bytes of one run from the port's own buffers.

    Components: the ``[L, 6]`` int32 counts (on the card the tile-padded
    length, ``ops.pileup.padded_total_len``; on the host the genome's);
    for the device pileup two staged slabs of the pinned ring (real rows
    as they cross: int32 starts and uint8 codes, ``4 + W`` bytes a row)
    and K1's plan of one slab (the sorted int32 starts, the int64
    permutation and the nibble-packed rows); the tail's dense position
    head (one byte a position and threshold); and the insertion table
    with its padded event lanes, once the tail knows them.  A slab holds
    ``min(n_reads, chunk_reads)`` rows rounded up to a power of two, at
    the bucket width of ``read_len`` (capped by ``segment_width``).  A
    sharded run (``shards`` > 1) prices the counts ``shards`` times, as
    the reference does: the resident blocks and, under dp, each shard's
    full-length local tensor of a slab.
    """
    from ..constants import NUM_SYMBOLS
    from ..encoder.events import MIN_BUCKET_W
    from ..ops.pileup import padded_total_len, round_rows_pow2

    padded = padded_total_len(total_len)
    width = max(MIN_BUCKET_W, 1 << max(0, int(read_len) - 1).bit_length())
    if segment_width > 0:
        width = min(width, max(MIN_BUCKET_W, int(segment_width)))
    rows = round_rows_pow2(min(n_reads or chunk_reads, chunk_reads))
    components = {
        "counts_bytes": (total_len if host_counts else padded)
        * NUM_SYMBOLS * 4 * max(1, int(shards)),
        "staging_bytes": 0 if host_counts else 2 * rows * (4 + width),
        "plan_bytes": 0 if host_counts else rows * (4 + 8 + width // 2),
        "tail_bytes": max(1, int(n_thresholds)) * padded,
        "insertion_table_bytes": int(insertion_table_bytes),
    }
    components = {k: int(v) for k, v in components.items()}
    return sum(components.values()), components


def predict_job_peak_bytes(total_len: int, cfg) -> int:
    """Admission-side wrapper (the reference's): the prediction for one
    job from its header-probed genome length and its RunConfig
    (serve/runner.py ``--mem-budget``), over
    :func:`predict_run_peak_bytes`; a job pinned to ``--pileup host`` is
    priced with host counts."""
    total, _comp = predict_run_peak_bytes(
        total_len,
        n_thresholds=len(getattr(cfg, "thresholds", None) or [0.25]),
        chunk_reads=getattr(cfg, "chunk_reads", 262144),
        segment_width=max(0, getattr(cfg, "segment_width", 0)),
        host_counts=getattr(cfg, "pileup", "auto") == "host",
        shards=getattr(cfg, "shards", 1) or 1)
    return total


def record_capacity(total_len: int, n_thresholds: int,
                    chunk_reads: int = 262144, segment_width: int = 0,
                    n_reads: Optional[int] = None,
                    host_counts: bool = False,
                    insertion_table_bytes: int = 0,
                    budget_bytes: int = 0, shards: int = 1) -> dict:
    """Register the run's ``capacity`` ledger decision (predicted peak
    bytes joined against the measured ``mem/peak_tracked_bytes`` ratchet
    at finalize) and return the prediction record (also the forensic
    dump's ``capacity`` section).  Last-wins: the tail records it again
    once the insertion table's size is known."""
    from .. import observability as obs

    total, components = predict_run_peak_bytes(
        total_len, n_thresholds=n_thresholds, chunk_reads=chunk_reads,
        segment_width=segment_width, n_reads=n_reads,
        host_counts=host_counts,
        insertion_table_bytes=insertion_table_bytes, shards=shards)
    chosen = "unbudgeted"
    if budget_bytes:
        chosen = "over_budget" if total > budget_bytes \
            else "within_budget"
    inputs = {
        "total_len": int(total_len),
        "n_thresholds": int(n_thresholds),
        "chunk_reads": int(chunk_reads),
        "shards": int(max(1, shards)),
        "segment_width": int(segment_width),
        "host_counts": bool(host_counts),
        **({"budget_bytes": int(budget_bytes)} if budget_bytes else {}),
        **components,
    }
    record = {"predicted_bytes": int(total), "chosen": chosen,
              "inputs": inputs}
    with _plane.lock:
        _plane.last_capacity = record
    if enabled():
        # band=0: informational residual, the model is an upper bound
        from . import ratecard as _rc

        _ratio, _cap_prov = _rc.consult("capacity_residual_ratio", 1.0)
        obs.record_decision(
            "capacity", chosen, inputs=inputs,
            predicted={"bytes": float(total)},
            measured={"bytes": {"counters": ["mem/peak_tracked_bytes"]}},
            band=0, provenance=_cap_prov)
    return record


def capacity_actuals(device=None) -> dict:
    """Predicted-vs-actual snapshot for the OOM-split rung
    (``resilience/ladder.py``): the last capacity prediction next to the
    tracked, process and device residency at split time."""
    drain_releases()
    cur, peak = rss_bytes()
    with _plane.lock:
        cap = _plane.last_capacity
        out = {
            "predicted_bytes": (cap or {}).get("predicted_bytes"),
            "live_tracked_bytes": _plane.total_live,
            "peak_tracked_bytes": _plane.total_peak,
            "rss_mb": round(cur / 1e6, 2),
            "peak_rss_mb": round(peak / 1e6, 2),
        }
    dev = device_memory_stats(device)
    if dev is not None:
        out["device_bytes_in_use"] = dev.get("bytes_in_use", 0)
    return out


# =========================================================================
# OOM forensics
# =========================================================================
def write_mem_dump(out_dir: str, exc: Optional[BaseException] = None,
                   registry=None, context: Optional[dict] = None
                   ) -> Optional[str]:
    """Write ``mem_dump.json`` into ``out_dir``; returns the path.
    Never raises: forensics must not replace one failure with another."""
    try:
        from .metrics import current as _current_registry
        from .telemetry import atomic_write_text
        from .trace import current_span_name

        if registry is None:
            registry = _current_registry()
        classification = None
        if exc is not None:
            try:
                from ..resilience.policy import classify

                classification = classify(exc)
            except Exception:
                classification = None
        snap = registry.snapshot()
        mem_counters = {k: v for k, v in snap["counters"].items()
                        if k.startswith(("mem/", "cache/evicted"))}
        drain_releases()
        with _plane.lock:
            fams = {f: {"live_bytes": _plane.live.get(f, 0),
                        "peak_bytes": _plane.peak.get(f, 0)}
                    for f in sorted(set(_plane.live) | set(_plane.peak))}
            totals = {"live_bytes": _plane.total_live,
                      "peak_bytes": _plane.total_peak}
            capacity = dict(_plane.last_capacity) \
                if _plane.last_capacity else None
        blob = {
            "schema": MEM_DUMP_SCHEMA,
            "created_unix": round(time.time(), 3),
            "pid": os.getpid(),
            "error": ({
                "type": type(exc).__name__,
                "message": str(exc),
                "classification": classification,
            } if exc is not None else None),
            "families": fams,
            "tracked": totals,
            "watermarks": sample(registry=registry),
            "watermark_tail": history_tail(),
            "capacity": capacity,
            "registry_mem_counters": mem_counters,
            "open_span": current_span_name(),
            "context": dict(context or {}),
        }
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, MEM_DUMP_NAME)
        atomic_write_text(path, json.dumps(blob, indent=1, default=str)
                          + "\n")
        logger.warning("memory forensics written to %s (%s)", path,
                       blob["error"])
        return path
    except Exception as dump_exc:
        logger.warning("mem_dump write failed: %s: %s",
                       type(dump_exc).__name__, dump_exc)
        return None


def dump_on_capacity(exc: BaseException, out_dir: Optional[str],
                     registry=None,
                     context: Optional[dict] = None) -> Optional[str]:
    """The OOM hook: write the forensic dump iff ``exc`` classifies
    CAPACITY (``resilience.policy``) and a destination exists; counted
    ``mem/oom_dumps``."""
    if not enabled() or not out_dir:
        return None
    try:
        from ..resilience.policy import CAPACITY, classify

        if classify(exc) != CAPACITY:
            return None
    except Exception:
        return None
    path = write_mem_dump(out_dir, exc=exc, registry=registry,
                          context=context)
    if path is not None:
        from .metrics import current as _current_registry

        (registry or _current_registry()).add("mem/oom_dumps", 1)
    return path


def _reset_for_tests() -> None:
    """Zero the process-wide plane (tests only: families are
    process-lifetime in production)."""
    global _plane
    _plane = _Plane()
    _released.clear()
