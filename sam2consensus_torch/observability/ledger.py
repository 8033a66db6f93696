"""Decision ledger: model-vs-measured attribution for every priced gate.

Copy of ``sam2consensus_tpu/observability/ledger.py`` (pinned by
``tests/test_torch_copies.py``).  Each decision site of the one-shot run
(``link_constants``, ``tail_placement``, ``wire_codec``, ``capacity``,
``epilogue``, ``host_pileup_bound``, ``decode_threads``,
``longread_layout``) registers a structured :class:`DecisionRecord` —
``{decision, chosen, inputs, predicted, alternatives}`` plus a *measured
spec* naming the registry counters that will hold the decision's real
outcome once the run finishes.  At run end (:func:`finalize`, called by
``observability.finalize_decisions``) each record is joined against the
metrics registry: ``residual/<decision>/<key>`` gauges carry the
measured/predicted ratio, and a ``drift/<decision>`` event fires when the
residual leaves the band (``S2C_DRIFT_BAND``, default 4x either way;
``sec`` residuals under ``S2C_DRIFT_MIN_SEC`` never drift).

Records are per-run (pushed and popped with the run's registry) and
last-wins per decision name, so a gate consulted twice (the placement
model's optimistic-then-exact double call) leaves exactly one decisive
record.  Everything here is plain dict and float work on a handful of
records a run, never a slab.

Measured specs are one of two shapes, evaluated over the registry's
counter snapshot at finalize time:

* ``{"counters": [names]}`` — the sum of the named counters (absent
  counters contribute nothing; all absent -> no join);
* ``{"num": [names], "den": [names]}`` — a rate or ratio: sum(num) /
  sum(den).  No join when the denominator is 0 or the numerator sums to
  0 (no traffic, nothing to attribute); an optional ``"min_num"`` raises
  that floor.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("sam2consensus_torch.observability.ledger")

#: default drift band: residual (measured/predicted) outside
#: [1/band, band] raises a drift event (the reference's value).  4x is
#: deliberately generous, so a fired drift event means the constants are
#: wrong, not noisy.
DEFAULT_DRIFT_BAND = 4.0

#: seconds floor under which a "sec" residual never drifts: a model
#: that predicted 80 us and measured 900 us is pricing dispatch noise,
#: not a mis-route worth alarming on
DEFAULT_DRIFT_MIN_SEC = 0.02


def drift_band() -> float:
    """S2C_DRIFT_BAND (ratio, >= 1) or the default."""
    try:
        return max(1.0, float(os.environ.get("S2C_DRIFT_BAND",
                                             DEFAULT_DRIFT_BAND)))
    except ValueError:
        return DEFAULT_DRIFT_BAND


def drift_min_sec() -> float:
    try:
        return float(os.environ.get("S2C_DRIFT_MIN_SEC",
                                    DEFAULT_DRIFT_MIN_SEC))
    except ValueError:
        return DEFAULT_DRIFT_MIN_SEC


@dataclass
class DecisionRecord:
    """One model-driven decision + (after finalize) its real outcome."""

    decision: str                      # "tail_placement", "wire_codec", ...
    chosen: str
    inputs: dict = field(default_factory=dict)
    predicted: dict = field(default_factory=dict)   # {"sec"|"bps"|"ratio": v}
    alternatives: dict = field(default_factory=dict)  # {candidate: cost}
    measured_spec: Optional[dict] = None
    #: None -> the global S2C_DRIFT_BAND; 0/False -> residual is
    #: informational only, never raises drift (e.g. shard mode, whose
    #: model prices only the per-slab OVERHEAD delta between layouts,
    #: not the absolute slab time the registry measures)
    band: Optional[float] = None
    # -- filled by finalize() --
    measured: dict = field(default_factory=dict)
    residual: dict = field(default_factory=dict)
    drift: bool = False

    def to_dict(self) -> dict:
        out = {"decision": self.decision, "chosen": self.chosen,
               "inputs": dict(self.inputs),
               "predicted": dict(self.predicted),
               "alternatives": dict(self.alternatives),
               "measured": dict(self.measured),
               "residual": dict(self.residual),
               "drift": bool(self.drift)}
        return out


class DecisionLedger:
    """Per-run decision records, last-wins by decision name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[str, DecisionRecord] = {}
        self.finalized = False

    def record(self, decision: str, chosen: str,
               inputs: Optional[dict] = None,
               predicted: Optional[dict] = None,
               alternatives: Optional[dict] = None,
               measured: Optional[dict] = None,
               band: Optional[float] = None,
               provenance: Optional[dict] = None) -> DecisionRecord:
        """``provenance`` is the rate-card consultation stamp
        (observability/ratecard.py ``consult``): which source priced
        this decision's prediction inputs — learned (with sample count
        and age) or default.  It rides ``inputs["ratecard"]`` so the
        manifest's residual record answers "was the drift the MODEL's
        fault or the CONSTANT's fault" per decision."""
        merged = dict(inputs or {})
        if provenance:
            merged["ratecard"] = dict(provenance)
        rec = DecisionRecord(
            decision=decision, chosen=str(chosen),
            inputs=merged,
            predicted={k: float(v) for k, v in (predicted or {}).items()
                       if v is not None},
            alternatives={k: float(v)
                          for k, v in (alternatives or {}).items()
                          if v is not None},
            measured_spec=measured, band=band)
        with self._lock:
            self._records[decision] = rec
        return rec

    def get(self, decision: str) -> Optional[DecisionRecord]:
        with self._lock:
            return self._records.get(decision)

    def records(self) -> List[DecisionRecord]:
        with self._lock:
            return list(self._records.values())


# -- process-current ledger (mirrors metrics.current) ----------------------
_process_ledger = DecisionLedger()
_current: List[DecisionLedger] = [_process_ledger]
_current_lock = threading.Lock()
_tls = threading.local()


def current() -> DecisionLedger:
    led = getattr(_tls, "ledger", None)
    return led if led is not None else _current[-1]


def bind_thread(ledger: Optional[DecisionLedger]) -> None:
    """Thread-local override of :func:`current` (mirrors
    ``metrics.bind_thread``; the decode prefetch thread and the parallel
    decoder's workers)."""
    _tls.ledger = ledger


def push_run(ledger: Optional[DecisionLedger] = None) -> DecisionLedger:
    led = ledger if ledger is not None else DecisionLedger()
    with _current_lock:
        _current.append(led)
    return led


def pop_run(ledger: DecisionLedger) -> None:
    with _current_lock:
        if len(_current) > 1 and _current[-1] is ledger:
            _current.pop()
        elif ledger in _current[1:]:
            _current.remove(ledger)


def record(decision: str, chosen: str, **kwargs) -> DecisionRecord:
    """Register a decision into the current run's ledger (module-level
    convenience for deep call sites, like ``observability.metrics()``)."""
    return current().record(decision, chosen, **kwargs)


# -- the join --------------------------------------------------------------
def _eval_measured(spec, counters: dict) -> Optional[float]:
    """Evaluate one measured-spec entry over a counter snapshot."""
    if not isinstance(spec, dict):
        return None
    if "counters" in spec:
        names = [n for n in spec["counters"] if n in counters]
        if not names:
            return None
        return float(sum(counters[n] for n in names))
    if "num" in spec and "den" in spec:
        num = sum(counters.get(n, 0.0) for n in spec["num"])
        den = sum(counters.get(n, 0.0) for n in spec["den"])
        if den <= 0 or num <= 0 or num < spec.get("min_num", 0):
            return None
        return float(num) / float(den)
    return None


def finalize(ledger: DecisionLedger, registry, tracer=None
             ) -> List[DecisionRecord]:
    """Join every record against the registry's measured counters.

    Emits ``residual/<decision>/<key>`` gauges (measured/predicted
    ratio), a per-decision ``residual/<decision>`` info gauge carrying
    the full joined record, and — when a residual leaves the drift
    band — a ``drift/events`` counter bump, a ``drift/<decision>``
    gauge, a tracer instant event and a warning log.  Idempotent per
    ledger (the backend finalizes before publishing stats; finish_run
    re-checks for runs that never reached the backend's call)."""
    if ledger.finalized:
        return ledger.records()
    ledger.finalized = True
    snap = registry.snapshot()
    counters = snap["counters"]
    band_default = drift_band()
    min_sec = drift_min_sec()
    for rec in ledger.records():
        for key, spec in (rec.measured_spec or {}).items():
            m = _eval_measured(spec, counters)
            if m is None:
                continue
            rec.measured[key] = m
            p = rec.predicted.get(key)
            if p is None or p <= 0:
                continue
            rec.residual[key] = m / p
            registry.gauge(
                f"residual/{rec.decision}/{key}").set(round(m / p, 4))
        band = band_default if rec.band is None else rec.band
        if band:
            for key, ratio in rec.residual.items():
                if key == "sec" and max(
                        rec.measured.get("sec", 0.0),
                        rec.predicted.get("sec", 0.0)) < min_sec:
                    continue
                if ratio > band or ratio < 1.0 / band:
                    rec.drift = True
        info = rec.to_dict()
        info["band"] = band
        registry.gauge(f"residual/{rec.decision}").set_info(info)
        if rec.drift:
            registry.add("drift/events", 1)
            registry.gauge(f"drift/{rec.decision}").set_info(info)
            logger.warning(
                "drift: %s chose %r predicting %s but measured %s "
                "(residual %s outside band %.1fx) — the model's "
                "constants no longer describe this rig",
                rec.decision, rec.chosen, rec.predicted, rec.measured,
                {k: round(v, 3) for k, v in rec.residual.items()}, band)
            if tracer is not None:
                tracer.event(f"drift/{rec.decision}", **{
                    "chosen": rec.chosen,
                    **{f"predicted_{k}": v
                       for k, v in rec.predicted.items()},
                    **{f"measured_{k}": round(v, 6)
                       for k, v in rec.measured.items()}})
    return ledger.records()
