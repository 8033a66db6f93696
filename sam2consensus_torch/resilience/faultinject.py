"""Deterministic, seed-addressable fault injection for the device path.

Copy of ``sam2consensus_tpu/resilience/faultinject.py`` (pinned by
``tests/test_torch_copies.py``: the sites, the spec grammar, its errors
and the seeded coin); a firing rule counts ``fault/injected`` and
``fault/injected/<site>`` and emits a ``fault/injected`` trace event.
The port fires
``device_put``, ``pileup_dispatch``, ``accumulate``, ``vote``,
``insertion_build``, ``link_probe``, ``wire_encode``, ``bam_inflate``,
``ingest_decode_shard`` and ``mem_alloc`` at the places the reference
fires them, and the serve runner's sites: ``job_hang`` (beside
``accumulate`` in ``ladder.ResilientDispatcher._attempt``; a firing rule
SLEEPS ``S2C_FAULT_HANG_S`` seconds, default 3600, before it raises: a
wedged dispatch for the serve watchdog to notice), ``serve_decode_ahead``
(the runner's decode-ahead thread) and ``journal_write`` (a journal
segment append); the runner checks the last two against its
queue-lifetime injector.  The streaming-session sites (``session_*``,
``ingest_conn``) are in :data:`SITES` so a spec parses alike, and fire
nowhere until the port has sessions.

Faults raise exceptions that the policy layer (``policy.classify``) cannot
tell from the real failures they model: ``rpc`` (ConnectionError,
transient), ``timeout`` (TimeoutError, transient), ``oom`` (MemoryError
"RESOURCE_EXHAUSTED", capacity), ``fatal`` and ``trace`` (RuntimeError,
fatal).

Spec grammar (CLI ``--fault-inject`` or env ``S2C_FAULT_INJECT``;
comma-separated specs)::

    site:kind:after_n[:times]

* ``kind`` — ``rpc`` (ConnectionError, transient), ``timeout``
  (TimeoutError, transient), ``oom`` (MemoryError "RESOURCE_EXHAUSTED",
  capacity), ``fatal`` (RuntimeError, fatal), ``trace`` (RuntimeError
  modeling a kernel trace failure, fatal);
* ``after_n`` — integer: the first N calls to the site pass, the
  (N+1)-th fails; or ``pP`` (e.g. ``p0.05``): each call fails with
  probability P, decided by a seed-addressable hash of
  ``(seed, site, call_index)`` — deterministic run-to-run for a given
  ``S2C_FAULT_SEED`` (default 0);
* ``times`` — the rule's total fault budget: how many calls fail once
  triggered (counted specs default to 1; probabilistic specs default
  to unbounded); ``inf``/``*``/``-1`` = persistent (every matching
  call from then on), the shape that forces a ladder demotion.

Counting is per-site and per-:func:`configure` (the jax backend
configures the injector at run start, so bench warm/timed repetitions
and test runs each count from zero).  The ladder's demoted host rung
runs under :func:`suppress` — injection models DEVICE-path faults, and
the last rung is by construction host-side.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional

SITES = ("device_put", "pileup_dispatch", "accumulate", "vote",
         "insertion_build", "link_probe", "wire_encode",
         "serve_decode_ahead", "journal_write", "job_hang",
         "bam_inflate", "ingest_decode_shard", "mem_alloc",
         "session_wave_append", "session_revote", "ingest_conn")

KINDS = ("rpc", "timeout", "oom", "fatal", "trace")


#: how long a firing ``job_hang`` rule sleeps before raising (seconds);
#: far past any sane --job-timeout, so the watchdog always wins the race
DEFAULT_HANG_S = 3600.0


def _hang_seconds() -> float:
    try:
        return max(0.0, float(os.environ.get("S2C_FAULT_HANG_S",
                                             DEFAULT_HANG_S)))
    except ValueError:
        return DEFAULT_HANG_S


class InjectedFault(Exception):
    """Mixin marking an exception as injected (tests introspect it)."""

    site = ""
    kind = ""


class InjectedRpcError(InjectedFault, ConnectionError):
    """Models a dropped tunnel / RPC transport error (transient)."""


class InjectedTimeoutError(InjectedFault, TimeoutError):
    """Models a hung dispatch past its deadline (transient)."""


class InjectedOomError(InjectedFault, MemoryError):
    """Models device HBM exhaustion (capacity: split/halve and retry)."""


class InjectedFatalError(InjectedFault, RuntimeError):
    """Models a non-retryable device failure (ladder territory)."""


class InjectedTraceError(InjectedFault, RuntimeError):
    """Models a kernel trace/compile failure (fatal at kernel level)."""


_KIND_EXC = {
    "rpc": (InjectedRpcError, "injected: UNAVAILABLE: connection dropped"),
    "timeout": (InjectedTimeoutError,
                "injected: DEADLINE_EXCEEDED: dispatch timed out"),
    "oom": (InjectedOomError,
            "injected: RESOURCE_EXHAUSTED: out of memory allocating"),
    "fatal": (InjectedFatalError,
              "injected: INTERNAL: device core dumped"),
    "trace": (InjectedTraceError,
              "injected: Mosaic lowering failed while tracing kernel"),
}

PERSISTENT = -1


class _Rule:
    __slots__ = ("site", "kind", "after_n", "prob", "times", "fired")

    def __init__(self, site: str, kind: str, after_n: Optional[int],
                 prob: Optional[float], times: int):
        self.site = site
        self.kind = kind
        self.after_n = after_n
        self.prob = prob
        self.times = times
        self.fired = 0


def parse_spec(spec: str) -> List[_Rule]:
    """Parse a comma-separated fault spec; raises ValueError on nonsense
    (unknown site/kind, malformed counts) so a typo'd --fault-inject
    fails the run up front instead of silently injecting nothing."""
    rules: List[_Rule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (3, 4):
            raise ValueError(
                f"fault spec {part!r}: expected site:kind:after_n[:times]")
        site, kind, trigger = fields[0], fields[1], fields[2]
        if site not in SITES:
            raise ValueError(
                f"fault spec {part!r}: unknown site {site!r} "
                f"(use one of {', '.join(SITES)})")
        if kind not in KINDS:
            raise ValueError(
                f"fault spec {part!r}: unknown kind {kind!r} "
                f"(use one of {', '.join(KINDS)})")
        after_n: Optional[int] = None
        prob: Optional[float] = None
        if trigger.startswith("p"):
            try:
                prob = float(trigger[1:])
            except ValueError:
                raise ValueError(
                    f"fault spec {part!r}: bad probability {trigger!r} "
                    f"(use e.g. p0.05)") from None
            if not 0.0 <= prob <= 1.0:
                raise ValueError(
                    f"fault spec {part!r}: probability {prob} outside "
                    f"[0, 1]")
        else:
            try:
                after_n = int(trigger)
            except ValueError:
                raise ValueError(
                    f"fault spec {part!r}: bad after_n {trigger!r} "
                    f"(an integer call count, or pP for probabilistic)"
                ) from None
            if after_n < 0:
                raise ValueError(
                    f"fault spec {part!r}: after_n must be >= 0")
        # counted specs default to ONE fault; probabilistic specs keep
        # rolling their coin forever unless an explicit budget caps them
        times = PERSISTENT if prob is not None else 1
        if len(fields) == 4:
            t = fields[3]
            if t in ("inf", "*"):
                times = PERSISTENT
            else:
                try:
                    times = int(t)
                except ValueError:
                    raise ValueError(
                        f"fault spec {part!r}: bad times {t!r} "
                        f"(an integer, 'inf', or '*')") from None
                if times == -1:
                    times = PERSISTENT
                elif times < 1:
                    raise ValueError(
                        f"fault spec {part!r}: times must be >= 1, "
                        f"'inf', '*', or -1")
        rules.append(_Rule(site, kind, after_n, prob, times))
    return rules


class FaultInjector:
    """Seed-addressable injector over a parsed rule set.

    ``check(site)`` increments the site's call counter, evaluates every
    rule bound to the site in spec order, and raises the first match
    (recording ``fault/injected`` + ``fault/injected/<site>`` counters
    and a ``fault/injected`` tracer event first, so the recovery story
    is visible even when the fault is later swallowed by a retry).
    """

    def __init__(self, rules: List[_Rule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self._suppress = 0

    def _roll(self, site: str, n: int, prob: float) -> bool:
        """Deterministic per-call coin: crc32 of (seed, site, n)."""
        h = zlib.crc32(f"{self.seed}:{site}:{n}".encode())
        return (h / 0xFFFFFFFF) < prob

    def check(self, site: str) -> None:
        if self._suppress:
            return
        n = self.calls.get(site, 0)
        self.calls[site] = n + 1
        for rule in self.rules:
            if rule.site != site:
                continue
            budget = (rule.times == PERSISTENT
                      or rule.fired < rule.times)
            if rule.prob is not None:
                fire = budget and self._roll(site, n, rule.prob)
            else:
                fire = budget and n >= rule.after_n
            if not fire:
                continue
            rule.fired += 1
            self.injected[site] = self.injected.get(site, 0) + 1
            exc_cls, msg = _KIND_EXC[rule.kind]
            exc = exc_cls(f"{msg} (site={site}, call #{n})")
            exc.site = site
            exc.kind = rule.kind
            from .. import observability as obs

            reg = obs.metrics()
            reg.add("fault/injected", 1)
            reg.add(f"fault/injected/{site}", 1)
            hang = _hang_seconds() if site == "job_hang" else 0.0
            obs.tracer().event("fault/injected", site=site,
                               kind=rule.kind, call=n,
                               **({"hang_s": hang} if hang else {}))
            if hang:
                # the wedged-dispatch model: counters/trace record the
                # injection FIRST (the thread is about to stop making
                # progress), then the dispatch just... doesn't return.
                # The serve watchdog abandons the thread long before
                # the sleep expires; if it ever wakes, the kind's
                # exception surfaces like any other injected fault.
                import time

                time.sleep(hang)
            raise exc


#: process-current injector; None = injection inactive (the fast path —
#: one attribute load + is-None test per site call)
_injector: Optional[FaultInjector] = None


def configure(spec: Optional[str] = None,
              seed: Optional[int] = None) -> Optional[FaultInjector]:
    """Install (or clear) the process-current injector.

    ``spec`` falls back to env ``S2C_FAULT_INJECT``; an empty/absent
    spec clears the injector.  ``seed`` falls back to
    ``S2C_FAULT_SEED`` (default 0).  Returns the installed injector (or
    None).  Called by the jax backend at run start so call counters are
    per-run-deterministic.
    """
    global _injector
    if spec is None:
        spec = os.environ.get("S2C_FAULT_INJECT", "")
    if not spec:
        _injector = None
        return None
    if seed is None:
        seed = int(os.environ.get("S2C_FAULT_SEED", "0"))
    _injector = FaultInjector(parse_spec(spec), seed=seed)
    return _injector


def active() -> Optional[FaultInjector]:
    return _injector


def fault_check(site: str) -> None:
    """Site hook: no-op unless an injector is configured."""
    if _injector is not None:
        _injector.check(site)


class suppress:
    """Context manager exempting a region from injection — the ladder's
    demoted host rung runs under this (the injector models DEVICE-path
    faults; the last rung is host-side by construction).  Depth-counted,
    not thread-isolated: the only concurrent thread (decode prefetch)
    carries no injection sites."""

    def __enter__(self):
        if _injector is not None:
            _injector._suppress += 1
        return self

    def __exit__(self, *exc):
        if _injector is not None and _injector._suppress > 0:
            _injector._suppress -= 1
        return False


def _reset_for_tests() -> None:
    global _injector
    _injector = None
