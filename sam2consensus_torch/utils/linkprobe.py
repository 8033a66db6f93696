"""Startup probe of the host-to-card link, for the placement model.

Port of ``sam2consensus_tpu/utils/linkprobe.py`` in torch.  The tail
placement of a host-counts run (``backends/torch_backend.tail_placement``)
prices its decision in round trips and bytes on the link (the port's
host-counts gate does not read the link); this probe measures both once
per process and device, and only when the placement needs them:

* the round trip: a null kernel (an add on 8 int32s) and a stream
  synchronise, best of 3 after a warm-up;
* the bandwidth: warmed 1 MiB copies between page-locked host memory and
  the card, best of 2 in each direction, with half a round trip taken off
  each; the slower direction is the one reported, because the model bills
  the counts upload and the output fetch with one rate.

``S2C_LINK_PROBE=0`` turns the probe off (the backend then prices with its
baked constants), and the ``S2C_TAIL_RT_MS`` / ``S2C_TAIL_LINK_MBPS``
overrides skip it (``backends/torch_backend._link_constants``).  The
``link_probe`` fault-injection site fires first: an injected failure makes
:func:`probe_link` return None, remembered for the device, and the backend
then prices with its baked constants, as the reference falls back
(``sam2consensus_tpu/utils/linkprobe.py`` ``_probe_into``).  A real failure
of the probe is raised, not priced around.  The reference's stale-value
cache file, rate card and decision ledger are not ported.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Set

import torch

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
#: devices whose probe met an injected fault: priced with the defaults
_failed: Set[torch.device] = set()


def probe_link(device=None) -> Optional[LinkProbe]:
    """Measure the link of CUDA ``device`` (default: the current one),
    once per process and device; None when the ``link_probe`` fault site
    fired (remembered for the device)."""
    from .. import observability as obs
    from ..resilience.faultinject import InjectedFault, fault_check

    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    got = _cached.get(dev)
    if got is None:
        if dev in _failed:
            return None
        try:
            fault_check("link_probe")
        except InjectedFault:
            _failed.add(dev)
            obs.metrics().gauge("link/probe_failed").set(1.0)
            return None
        got = _cached[dev] = _measure(dev)
    return got


def _reset_for_tests() -> None:
    _cached.clear()
    _failed.clear()


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
