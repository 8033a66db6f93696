"""Resilience subsystem: the device path's failure contract.

Port of ``sam2consensus_tpu/resilience``: the count tensor is fully
sum-decomposable and checkpointable (``utils/checkpoint.py``), so no
mid-run device failure has to be terminal.

* :mod:`.policy` — exception classification (transient / capacity /
  fatal / passthrough / data), with torch's error shapes, and
  configurable retry with exponential backoff + deterministic jitter;
* :mod:`.ladder` — the graceful-degradation ladder: K1 -> device
  scatter -> host pileup for accumulation, and device tail -> host tail,
  demoting mid-run without losing accumulated counts and writing an
  emergency checkpoint at each demotion boundary;
* :mod:`.faultinject` — deterministic, seed-addressable fault injection
  (``--fault-inject site:kind:after_n[:times]`` / ``S2C_FAULT_INJECT``).

Every retry, demotion and emergency checkpoint is counted in the run's
metrics registry (``resilience/*`` and ``fault/*``), which lands in
``stats.extra``.

This module imports only :mod:`.policy` and :mod:`.faultinject`;
:mod:`.ladder` is imported as a submodule by its consumers to keep
``ops.pileup`` and ``resilience`` free of an import cycle.
"""

from __future__ import annotations

from . import faultinject, policy
from .faultinject import FaultInjector, fault_check
from .policy import (CAPACITY, FATAL, PASSTHROUGH, TRANSIENT, RetryPolicy,
                     RetriesExhausted, classify)

__all__ = [
    "faultinject", "policy", "FaultInjector", "fault_check",
    "RetryPolicy", "RetriesExhausted", "classify",
    "TRANSIENT", "CAPACITY", "FATAL", "PASSTHROUGH",
]
