"""Per-reference count cache: incremental consensus as a serving feature.

Copy of ``sam2consensus_tpu/serve/countcache.py`` (pinned by
``tests/test_torch_copies.py``).  The count tensor and the insertion log
are a job's entire resumable state (``utils/checkpoint.py``); a server
holding the cache keeps each reference set's accumulated
``CheckpointState`` resident across jobs, keyed by a fingerprint of the
reference layout, the count-relevant encode knobs and the tenant.  A
tenant streaming new reads against a warm reference (serve
``--incremental`` jobs) pays only the decode and count of the delta and
the re-vote, and the consensus is byte-identical to a cold run over the
concatenated inputs.

Residency: entries live in host memory, as ``CheckpointState``s whose
counts are numpy arrays.  A hit is uploaded once into the job's
accumulator (``TorchBackend``'s seed: ``set_counts``), and the job's final
state is fetched back once at its end (the capture), only while the cache
is armed for that job.  The budget (``--count-cache SIZE`` /
``S2C_COUNT_CACHE``) is host bytes, under strict LRU eviction.

The count-bank rule governs failure: an incremental job that fails after
seeding invalidates its entry whole, and a job (re-)inserts its entry only
after it finished whole.  An entry evicted while a job holds its seed is
harmless: the job owns the state by reference and re-inserts it, updated,
at its end.
"""

from __future__ import annotations

import hashlib
import logging
import re
import threading
from collections import OrderedDict
from typing import Optional

from ..observability import memplane

logger = logging.getLogger("sam2consensus_torch.serve.countcache")


def parse_budget(value) -> int:
    """``--count-cache`` grammar -> byte budget (0 = disabled).

    Accepts ``off``/``0``/empty (disabled) or a size with an optional
    K/M/G suffix (``512M``, ``2G``, ``1048576``).  Raises ValueError on
    anything else — a typo'd cache budget must fail the server start,
    not silently disable incremental serving."""
    if value is None:
        return 0
    v = str(value).strip().lower()
    if v in ("", "off", "0", "none"):
        return 0
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([kmg]?)b?", v)
    if not m:
        raise ValueError(
            f"--count-cache {value!r}: use 'off' or a byte budget like "
            f"'512M', '2G', '1048576'")
    mult = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[m.group(2)]
    n = int(float(m.group(1)) * mult)
    if n <= 0:
        return 0
    return n


#: RunConfig fields that change what the COUNT TENSOR holds for a given
#: input stream — two configs differing here must never share an entry.
#: Vote/render knobs (thresholds, min_depth, fill, prefix, nchar) are
#: deliberately absent: counts are pre-vote state, so a tenant can
#: re-vote a warm reference under new thresholds for free.
COUNT_KEY_FIELDS = ("maxdel", "strict", "py2_compat")


def reference_key(contigs, cfg, tenant: str = "") -> str:
    """Cache key: sha256 over the reference layout (names + lengths in
    declaration order), the count-relevant config, and the tenant —
    tenants never share count state (an entry holds one tenant's
    accumulated reads; leaking it across tenants would merge their
    consensus inputs)."""
    h = hashlib.sha256()
    h.update(tenant.encode("utf-8", "surrogateescape"))
    h.update(b"\x00")
    for c in contigs:
        h.update(str(c.name).encode("utf-8", "surrogateescape"))
        h.update(b"\x01")
        h.update(str(int(c.length)).encode("ascii"))
        h.update(b"\x02")
    for f in COUNT_KEY_FIELDS:
        h.update(f"{f}={getattr(cfg, f, None)!r};".encode("utf-8"))
    return h.hexdigest()


def entry_nbytes(state) -> int:
    """Resident bytes of one cached CheckpointState (counts + the
    insertion chunk arrays — the two unbounded payloads)."""
    n = int(state.counts.nbytes)
    for c, l, ml, ch in state.insertions.array_chunks:
        n += int(c.nbytes + l.nbytes + ml.nbytes + ch.nbytes)
    return n


class CountCache:
    """LRU byte-budgeted map ``reference_key -> CheckpointState``.

    Thread-safe (the serve runner's telemetry HTTP threads read stats
    concurrently with the job loop).  All mutations publish the
    ``cache/*`` counter/gauge family into the registry handed in —
    the serve runner passes its server-lifetime AggregateRegistry, so
    the exposition carries ``s2c_cache_*`` and tools/s2c_top.py can
    render the cache line without extra plumbing."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._entries: "OrderedDict[str, object]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.inserts = 0
        self.invalidated = 0

    # -- accounting --------------------------------------------------------
    def _publish(self, registry, prev_bytes: Optional[int] = None) -> None:
        if prev_bytes is not None:
            # residency accounting (observability/memplane.py): the
            # cache bills its byte delta into the count_cache family,
            # so warm entries show up in every memory surface
            memplane.adjust("count_cache", self._bytes - prev_bytes)
        if registry is None:
            return
        registry.gauge("cache/entries").set(float(len(self._entries)))
        registry.gauge("cache/resident_bytes").set(float(self._bytes))

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "resident_mb": round(self._bytes / 1e6, 3),
                "budget_mb": round(self.budget / 1e6, 3),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "evicted_mb": round(self.evicted_bytes / 1e6, 3),
                "inserts": self.inserts,
                "invalidated": self.invalidated,
            }

    # -- the map -----------------------------------------------------------
    def get(self, key: str, registry=None):
        """The warm state for ``key`` (LRU-touched), or None.  Counted
        as a hit/miss in both the cache and ``registry``."""
        with self._lock:
            state = self._entries.get(key)
            if state is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                if registry is not None:
                    registry.add("cache/hits", 1)
            else:
                self.misses += 1
                if registry is not None:
                    registry.add("cache/misses", 1)
            self._publish(registry)
            return state

    def put(self, key: str, state, registry=None) -> None:
        """(Re-)insert ``key`` as most-recently-used and evict LRU
        entries until the budget holds.  A state larger than the whole
        budget is not cached (it would evict everything for nothing)."""
        nbytes = entry_nbytes(state)
        with self._lock:
            prev = self._bytes
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= entry_nbytes(old)
            if nbytes > self.budget:
                if registry is not None:
                    registry.add("cache/oversize_skipped", 1)
                self._publish(registry, prev_bytes=prev)
                return
            self._entries[key] = state
            self._bytes += nbytes
            self.inserts += 1
            if registry is not None:
                registry.add("cache/inserts", 1)
            evicted = 0
            while self._bytes > self.budget and len(self._entries) > 1:
                _k, victim = self._entries.popitem(last=False)
                vbytes = entry_nbytes(victim)
                self._bytes -= vbytes
                self.evictions += 1
                self.evicted_bytes += vbytes
                evicted += vbytes
                if registry is not None:
                    registry.add("cache/evictions", 1)
                    # the silent-budget fix: eviction under pressure
                    # used to log nothing fleet-wide — the evicted
                    # BYTES now ride the exposition (s2c_cache_
                    # evicted_bytes_total), the health snapshot and
                    # the s2c_top memory line
                    registry.add("cache/evicted_bytes", vbytes)
            if evicted:
                logger.info(
                    "count cache evicted %.1f MB under the %.0f MB "
                    "budget (%d entr%s resident, %.1f MB)",
                    evicted / 1e6, self.budget / 1e6,
                    len(self._entries),
                    "y" if len(self._entries) == 1 else "ies",
                    self._bytes / 1e6)
            self._publish(registry, prev_bytes=prev)

    def invalidate(self, key: str, registry=None) -> bool:
        """Drop ``key`` whole — the count-bank rule's failure edge: a
        seeded job that failed may have observed (or half-applied)
        state the next job must not inherit."""
        with self._lock:
            prev = self._bytes
            state = self._entries.pop(key, None)
            if state is not None:
                self._bytes -= entry_nbytes(state)
                self.invalidated += 1
                if registry is not None:
                    registry.add("cache/invalidated", 1)
            self._publish(registry, prev_bytes=prev)
            return state is not None


def from_config(value) -> Optional[CountCache]:
    """``--count-cache``/S2C_COUNT_CACHE -> a CountCache or None."""
    budget = parse_budget(value)
    return CountCache(budget) if budget else None
