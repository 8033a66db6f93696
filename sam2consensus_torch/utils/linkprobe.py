"""Startup probe of the host-to-card link, for the placement model.

Port of ``sam2consensus_tpu/utils/linkprobe.py`` in torch.  The tail
placement of a host-counts run (``backends/torch_backend.tail_placement``)
and the other link-priced gates price their decisions in round trips and
bytes on the link; this probe measures both once per process and device,
and only when a gate's choice depends on them
(``backends/torch_backend._decide_link``):

* the round trip: a null kernel (an add on 8 int32s) and a stream
  synchronise, best of 3 after a warm-up;
* the bandwidth: warmed 1 MiB copies between page-locked host memory and
  the card, best of 2 in each direction, with half a round trip taken off
  each; the slower direction is the one reported, because the model bills
  the counts upload and the output fetch with one rate.

``S2C_LINK_PROBE=0`` turns the probe off (the backend then prices with its
baked constants), and the ``S2C_TAIL_RT_MS`` / ``S2C_TAIL_LINK_MBPS``
overrides skip it.

Stale constants, as in the reference: the measurement runs on a watchdog
thread with a deadline (``S2C_LINK_PROBE_TIMEOUT_S``, default 20 s).  A
probe that hangs, or meets the ``link_probe`` fault-injection site, is
remembered as failed for the device and serves the last good constants
instead (:func:`_stale_constants`: this process's last measurement,
``stale-memory``, else the cache file's, ``stale-cache``), or None, and
the backend then prices with its baked constants.  A probe that raises
any other error is raised, not priced around.  The optional cross-process
cache (``S2C_LINK_CACHE``, a JSON path) is written atomically after each
measurement; a later process reads it before probing and, while it is
younger than ``S2C_LINK_CACHE_MAX_AGE`` (``observability.ratecard``),
takes its constants, stamped ``stale-cache``, and pays no probe.  A
corrupt cache file is counted (``link/cache_corrupt``) and ignored.
Without ``S2C_LINK_CACHE`` nothing is read or written.  Every served
value lands in the run's ``link/*`` gauges; :func:`link_info` gives its
provenance to the run manifest.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, NamedTuple, Optional, Set, Tuple

import torch

logger = logging.getLogger("sam2consensus_torch.utils.linkprobe")

#: probe transfer size: large enough that bandwidth dominates the round
#: trip after the correction
PROBE_BYTES = 1 << 20


class LinkProbe(NamedTuple):
    rt_sec: float       # null-kernel round trip
    h2d_bps: float      # pinned host-to-device bytes/s, RT-corrected
    d2h_bps: float      # pinned device-to-host bytes/s, RT-corrected

    @property
    def bps(self) -> float:
        """The slower direction: the rate the placement model bills."""
        return min(self.h2d_bps, self.d2h_bps)


_cached: Dict[torch.device, LinkProbe] = {}
#: devices whose probe failed (hung or met an injected fault)
_failed: Set[torch.device] = set()
#: the last SUCCESSFUL measurement this process took, surviving later
#: failures, and when (unix seconds)
_last_good: Optional[LinkProbe] = None
_last_good_at: Optional[float] = None
#: provenance of the constants last served, for the run manifest:
#: source is "probed" | "stale-memory" | "stale-cache" | None
_served: dict = {"source": None, "measured_at": None}


def cache_max_age() -> float:
    """``S2C_LINK_CACHE_MAX_AGE``: the one staleness bound, shared with
    the rate card (``observability.ratecard.max_age_sec``)."""
    from ..observability import ratecard as _rc

    return _rc.max_age_sec()


def _cache_file() -> Optional[str]:
    return os.environ.get("S2C_LINK_CACHE") or None


def _read_cache() -> Optional[Tuple[LinkProbe, Optional[float]]]:
    """``(probe, measured_at)`` from the cache file, or None when there
    is none.  A corrupt or truncated file reads as absent, with a
    ``link/cache_corrupt`` gauge, a trace event and a warning."""
    path = _cache_file()
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            blob = json.load(fh)
        rt, bps = float(blob["rt_sec"]), float(blob["bps"])
        at = blob.get("measured_at")
        probe = LinkProbe(rt, float(blob.get("h2d_bps", bps)),
                          float(blob.get("d2h_bps", bps)))
        return probe, (float(at) if at is not None else None)
    except Exception as exc:
        from .. import observability as obs

        obs.metrics().gauge("link/cache_corrupt").set(1.0)
        obs.tracer().event("link/cache_corrupt", path=path,
                           error=f"{type(exc).__name__}: {exc}")
        logger.warning(
            "link cache %s is corrupt/truncated (%s: %s): ignoring it",
            path, type(exc).__name__, exc)
        return None


def _write_cache(probe: LinkProbe) -> None:
    """Persist via tmp + ``os.replace``: a crash mid-write leaves the
    previous cache intact, never a truncated file."""
    path = _cache_file()
    if not path:
        return
    try:
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=d)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"rt_sec": probe.rt_sec, "bps": probe.bps,
                           "h2d_bps": probe.h2d_bps,
                           "d2h_bps": probe.d2h_bps,
                           "measured_at": time.time()}, fh)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError:
        pass


def _stale_constants() -> Optional[Tuple[LinkProbe, Optional[float], str]]:
    """``(probe, measured_at, source)`` of the last known-good constants
    (this process's first, then the cache file's), or None."""
    if _last_good is not None:
        return _last_good, _last_good_at, "stale-memory"
    cached = _read_cache()
    if cached is not None:
        return (*cached, "stale-cache")
    return None


def link_info() -> dict:
    """Provenance of the constants this process last served: source,
    measured-at and age (the manifest's link section)."""
    info = dict(_served)
    at = info.get("measured_at")
    if at is not None:
        info["age_sec"] = round(max(0.0, time.time() - at), 1)
    return info


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def probe_link(device=None) -> Optional[LinkProbe]:
    """The link of CUDA ``device`` (default: the current one): measured
    once per process and device, or the cache file's fresh constants;
    after a failed probe the stale constants or None (module
    docstring)."""
    global _last_good, _last_good_at
    from .. import observability as obs

    dev = _device(device)
    got = _cached.get(dev)
    if got is not None:
        _record_link(got)               # a fresh registry every run
        if _served["source"] is None:
            _served.update(source="probed", measured_at=_last_good_at)
        return got
    if dev in _failed:
        return _stale_fallback()
    cached = _read_cache()
    if cached is not None and cached[1] is not None \
            and time.time() - cached[1] <= cache_max_age():
        probe, at = cached
        _cached[dev] = probe
        obs.metrics().gauge("link/stale").set(1.0)
        _record_link(probe)
        _served.update(source="stale-cache", measured_at=at)
        return probe
    timeout = float(os.environ.get("S2C_LINK_PROBE_TIMEOUT_S", "20"))
    box: list = []
    with obs.tracer().span("link_probe") as sp:
        t = threading.Thread(target=_probe_into, args=(dev, box),
                             name="link-probe", daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive() or not box or box[0] is None:
            # hung (the thread is left blocked; it is a daemon) or an
            # injected fault
            _failed.add(dev)
            sp.set_args(failed=True)
            obs.metrics().gauge("link/probe_failed").set(1.0)
            return _stale_fallback()
        if isinstance(box[0], BaseException):
            raise box[0]
        got = _cached[dev] = box[0]
        sp.set_args(rt_sec=got.rt_sec, bps=got.bps)
    _last_good, _last_good_at = got, time.time()
    _write_cache(got)
    _record_link(got)
    _served.update(source="probed", measured_at=_last_good_at)
    return got


def _stale_fallback() -> Optional[LinkProbe]:
    """After a failed probe: the last known-good constants, marked stale
    in the run's registry (``link/stale``; ``link/stale_age`` and a
    warning when older than ``S2C_LINK_CACHE_MAX_AGE`` or of unknown
    age), or None: the backend then prices with its baked constants."""
    stale = _stale_constants()
    if stale is None:
        return None
    probe, measured_at, source = stale
    from .. import observability as obs

    reg = obs.metrics()
    reg.gauge("link/stale").set(1.0)
    age = time.time() - measured_at if measured_at is not None else None
    if age is None or age > cache_max_age():
        reg.gauge("link/stale_age").set(round(age, 1)
                                        if age is not None else -1.0)
        logger.warning(
            "link constants from %s are %s old (max age %.0f s): the "
            "placement model is pricing from a link that may no longer "
            "exist — re-probe or set S2C_TAIL_RT_MS / S2C_TAIL_LINK_MBPS",
            source,
            f"{age:.0f} s" if age is not None else "an unknown age",
            cache_max_age())
    obs.tracer().event("link/stale_constants", rt_sec=probe.rt_sec,
                       bps=probe.bps, age_sec=age)
    _record_link(probe)
    _served.update(source=source, measured_at=measured_at)
    return probe


def _record_link(probe: LinkProbe) -> None:
    """Publish the served constants into the CURRENT run's registry (and
    the installed rate card, where there is one)."""
    from .. import observability as obs
    from ..observability import ratecard as _rc

    reg = obs.metrics()
    reg.gauge("link/rt_sec").set(probe.rt_sec)
    reg.gauge("link/bps").set(probe.bps)
    card = _rc.installed()
    if card is not None:
        card.observe("link_rt_sec", probe.rt_sec)
        card.observe("link_bps", probe.bps)


def _probe_into(dev: torch.device, box: list) -> None:
    """The watchdog thread's body: None for an injected fault, the
    exception of any other failure (raised by the caller), else the
    measurement."""
    from ..resilience.faultinject import InjectedFault, fault_check

    try:
        fault_check("link_probe")
        box.append(_measure(dev))
    except InjectedFault:
        box.append(None)
    except BaseException as exc:
        box.append(exc)


def _reset_for_tests(drop_last_good: bool = True) -> None:
    global _last_good, _last_good_at
    _cached.clear()
    _failed.clear()
    _served.update(source=None, measured_at=None)
    if drop_last_good:
        _last_good = None
        _last_good_at = None


def _measure(dev: torch.device) -> LinkProbe:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        x = torch.zeros(8, dtype=torch.int32, device=dev)

        def round_trip():
            x.add_(1)
            stream.synchronize()

        round_trip()                    # loads the kernel
        rt = min(_timed(round_trip) for _ in range(3))

        host = torch.zeros(PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
        card = torch.empty(PROBE_BYTES, dtype=torch.uint8, device=dev)

        def h2d():
            card.copy_(host, non_blocking=True)
            stream.synchronize()

        def d2h():
            host.copy_(card, non_blocking=True)
            stream.synchronize()

        h2d()                           # first transfers discarded
        d2h()
        put = min(_timed(h2d) for _ in range(2))
        get = min(_timed(d2h) for _ in range(2))
    # clamp to sane bounds: a sub-microsecond round trip or a TB/s "link"
    # would make the model treat the link as free
    rt = float(min(max(rt, 1e-6), 10.0))

    def rate(sec):
        return float(min(max(PROBE_BYTES / max(sec - rt / 2, 1e-9), 1e5),
                         1e12))

    return LinkProbe(rt, rate(put), rate(get))


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
