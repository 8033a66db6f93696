"""Multi-window SLO burn-rate alerting with hysteresis.

Copy of ``sam2consensus_tpu/observability/burn.py`` (pinned by
``tests/test_torch_copies.py``).

The serve plane's old burn signal was a raw counter
(``slo/violations`` and ``AdmissionController.slo_burn_by_tenant``):
monotone, never decaying, so a tenant that breached an hour ago looked
exactly as burnt as one breaching NOW — a transient blip and a
sustained outage were indistinguishable, and the number could only
grow.  This module replaces that read with the standard multi-window
construction:

* per finished job, the runner feeds (tenant, objectives evaluated,
  objectives violated) with the job's wall stamp into the metrics
  registry's windowed rings (``metrics.Windowed`` — the journal-
  measured queue wait is already inside the evaluated phases, so a
  breach caused by the FLEET's queue burns the same as one caused by
  the tenant's data);
* the **burn rate** per (tenant, window) is violated/evaluated over
  the trailing window — fast (~5 min) for detection, slow (~1 h) for
  sustained-ness;
* the **alert state machine** is ok -> warn -> page with hysteresis:
  warn needs the fast window burning AND a minimum violation count
  (one blip in an empty window is a ratio of 1.0 and must NOT alarm);
  page needs BOTH windows burning (the classic page condition: it is
  bad NOW and it has been bad long enough to spend real budget);
  de-escalation steps DOWN one level per quiet period
  (``clear_after`` seconds below the warn ratio), so a flapping tenant
  cannot ring the pager on every oscillation.

Surfaces: ``s2c_burn_rate{tenant,window}`` + ``s2c_burn_alert_state
{tenant}`` gauges (rendered by telemetry.render_openmetrics), the
health snapshot's ``burn`` section, tools/s2c_top.py alert lines, and
— via :meth:`BurnMonitor.burn_counts` — the windowed replacement for
``AdmissionController.slo_burn_by_tenant`` reads.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_PAGE = "page"
#: exposition encoding of the state gauge (s2c_burn_alert_state)
STATE_LEVELS = {STATE_OK: 0, STATE_WARN: 1, STATE_PAGE: 2}

DEFAULT_FAST_SEC = 300.0       # detection window (~5 min)
DEFAULT_SLOW_SEC = 3600.0      # sustained-ness window (~1 h)
DEFAULT_WARN_RATIO = 0.25      # fast-window violated/evaluated
DEFAULT_PAGE_RATIO = 0.5       # both windows at/over this -> page
DEFAULT_MIN_VIOLATIONS = 2     # blips below this never escalate
DEFAULT_CLEAR_SEC = 300.0      # quiet seconds per de-escalation step


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


class BurnMonitor:
    """Per-tenant multi-window burn over a registry's windowed rings.

    The monitor OWNS two windowed series per tenant —
    ``burn/<tenant>/evaluated`` and ``burn/<tenant>/violated`` (one
    observation per finished job, value = the count) — and derives
    rates, states and gauges from them on :meth:`tick`.  Stamps are
    caller-supplied wall times: the fleet path feeds journal-replay
    breaches with their COMMIT stamps, so a breach from an hour ago
    lands an hour old and decays exactly like a locally-observed one.
    """

    WINDOWS = ("fast", "slow")

    def __init__(self, registry, fast_sec: Optional[float] = None,
                 slow_sec: Optional[float] = None,
                 warn_ratio: Optional[float] = None,
                 page_ratio: Optional[float] = None,
                 min_violations: Optional[int] = None,
                 clear_sec: Optional[float] = None):
        self.registry = registry
        self.fast_sec = fast_sec if fast_sec is not None \
            else _envf("S2C_BURN_FAST_SEC", DEFAULT_FAST_SEC)
        self.slow_sec = slow_sec if slow_sec is not None \
            else _envf("S2C_BURN_SLOW_SEC", DEFAULT_SLOW_SEC)
        self.warn_ratio = warn_ratio if warn_ratio is not None \
            else _envf("S2C_BURN_WARN_RATIO", DEFAULT_WARN_RATIO)
        self.page_ratio = page_ratio if page_ratio is not None \
            else _envf("S2C_BURN_PAGE_RATIO", DEFAULT_PAGE_RATIO)
        self.min_violations = min_violations \
            if min_violations is not None \
            else int(_envf("S2C_BURN_MIN_VIOLATIONS",
                           DEFAULT_MIN_VIOLATIONS))
        self.clear_sec = clear_sec if clear_sec is not None \
            else _envf("S2C_BURN_CLEAR_SEC", DEFAULT_CLEAR_SEC)
        self._lock = threading.Lock()
        #: tenant -> {"state", "since_unix", "last_above", "last_step"}
        self._tenants: Dict[str, dict] = {}

    # -- feed ------------------------------------------------------------
    def observe_job(self, tenant: str, evaluated: int, violated: int,
                    now: Optional[float] = None) -> None:
        """One finished job's SLO verdict (evaluated objective count,
        violated count) under the tenant's exposition label."""
        t = tenant or "default"
        stamp = now if now is not None else time.time()
        if evaluated <= 0:
            return
        self.registry.observe(f"burn/{t}/evaluated", float(evaluated),
                              stamp=stamp)
        self.registry.observe(f"burn/{t}/violated",
                              float(max(0, violated)), stamp=stamp)
        with self._lock:
            self._tenants.setdefault(
                t, {"state": STATE_OK, "since_unix": stamp,
                    "last_above": 0.0, "last_step": 0.0})

    # -- rates -----------------------------------------------------------
    def _window_sec(self, window: str) -> float:
        return self.fast_sec if window == "fast" else self.slow_sec

    def counts(self, tenant: str, window: str = "fast",
               now: Optional[float] = None) -> Dict[str, float]:
        """(evaluated, violated) sums over the trailing window."""
        t = tenant or "default"
        sec = self._window_sec(window)
        now = now if now is not None else time.time()
        ev = sum(self.registry.window_values(
            f"burn/{t}/evaluated", sec, now))
        vi = sum(self.registry.window_values(
            f"burn/{t}/violated", sec, now))
        return {"evaluated": ev, "violated": vi}

    def rate(self, tenant: str, window: str = "fast",
             now: Optional[float] = None) -> float:
        """violated/evaluated over the window (0.0 when empty)."""
        c = self.counts(tenant, window, now)
        return c["violated"] / c["evaluated"] if c["evaluated"] > 0 \
            else 0.0

    def burn_counts(self, window: str = "slow",
                    now: Optional[float] = None) -> Dict[str, int]:
        """tenant -> violated-objective count within the window: the
        windowed replacement for the never-decaying
        ``slo_burn_by_tenant`` dict (zero-count tenants dropped, so a
        tenant whose last breach aged out reads as unburnt)."""
        out: Dict[str, int] = {}
        with self._lock:
            tenants = list(self._tenants)
        for t in tenants:
            n = int(self.counts(t, window, now)["violated"])
            if n > 0:
                out[t] = n
        return out

    # -- state machine ---------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Dict[str, str]:
        """Advance every tenant's alert state and refresh the burn
        gauge family; returns tenant -> state.  Escalation is
        immediate (a page-worthy burn pages on the next tick);
        de-escalation steps down ONE level per ``clear_sec`` of the
        fast window staying under the warn ratio — the hysteresis that
        keeps a flapping tenant from oscillating ok<->page."""
        now = now if now is not None else time.time()
        states: Dict[str, str] = {}
        with self._lock:
            tenants = list(self._tenants.items())
        for t, st in tenants:
            fast = self.counts(t, "fast", now)
            slow = self.counts(t, "slow", now)
            fr = fast["violated"] / fast["evaluated"] \
                if fast["evaluated"] > 0 else 0.0
            sr = slow["violated"] / slow["evaluated"] \
                if slow["evaluated"] > 0 else 0.0
            with self._lock:
                cur = st["state"]
                if fr >= self.warn_ratio \
                        and fast["violated"] >= self.min_violations:
                    st["last_above"] = now
                    want = STATE_WARN
                    if fr >= self.page_ratio \
                            and sr >= self.page_ratio:
                        want = STATE_PAGE
                    if STATE_LEVELS[want] > STATE_LEVELS[cur]:
                        st["state"], st["since_unix"] = want, now
                elif cur != STATE_OK:
                    quiet_since = max(st["last_above"],
                                      st["last_step"])
                    if now - quiet_since >= self.clear_sec:
                        lvl = STATE_LEVELS[cur] - 1
                        st["state"] = [STATE_OK, STATE_WARN][lvl] \
                            if lvl >= 0 else STATE_OK
                        st["since_unix"] = now
                        st["last_step"] = now
                states[t] = st["state"]
            self.registry.gauge(f"burn/rate/{t}/fast").set(
                round(fr, 6))
            self.registry.gauge(f"burn/rate/{t}/slow").set(
                round(sr, 6))
            g = self.registry.gauge(f"burn/state/{t}")
            g.set(float(STATE_LEVELS[states[t]]))
            g.set_info({"tenant": t, "state": states[t],
                        "fast_ratio": round(fr, 4),
                        "slow_ratio": round(sr, 4),
                        "since_unix": round(st["since_unix"], 3)})
        return states

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {t: st["state"]
                    for t, st in self._tenants.items()}

    # -- export ----------------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> dict:
        """Health-section view (``burn``): per-tenant windows, rates,
        state, and the knobs in force — the whole alerting surface in
        one probe-able dict."""
        now = now if now is not None else time.time()
        tenants: Dict[str, dict] = {}
        with self._lock:
            items = list(self._tenants.items())
        for t, st in items:
            fast = self.counts(t, "fast", now)
            slow = self.counts(t, "slow", now)
            tenants[t] = {
                "state": st["state"],
                "since_unix": round(st["since_unix"], 3),
                "fast": {"evaluated": int(fast["evaluated"]),
                         "violated": int(fast["violated"]),
                         "ratio": round(
                             fast["violated"] / fast["evaluated"], 4)
                         if fast["evaluated"] > 0 else 0.0},
                "slow": {"evaluated": int(slow["evaluated"]),
                         "violated": int(slow["violated"]),
                         "ratio": round(
                             slow["violated"] / slow["evaluated"], 4)
                         if slow["evaluated"] > 0 else 0.0},
            }
        return {
            "windows_sec": {"fast": self.fast_sec,
                            "slow": self.slow_sec},
            "thresholds": {"warn_ratio": self.warn_ratio,
                           "page_ratio": self.page_ratio,
                           "min_violations": self.min_violations,
                           "clear_sec": self.clear_sec},
            "tenants": tenants,
        }


def replay_burn(events: List[dict], slo: Optional[dict],
                registry=None, now: Optional[float] = None,
                **knobs) -> dict:
    """Hindsight burn verdicts over journal events — the
    tools/fleet_whatif.py scorer.  ``events`` are journal records
    (dicts with ``ev``/``t``/``tenant``/``elapsed_sec``); committed
    events are scored against the e2e objective exactly like
    ``FleetCoordinator.fleet_burn``, but WITH their wall stamps, so
    the returned monitor answers "who was burning at time T" instead
    of "who ever burned".  Returns ``{"states": ..., "monitor": ...,
    "snapshot": ...}``."""
    from .metrics import MetricsRegistry

    reg = registry if registry is not None else MetricsRegistry()
    mon = BurnMonitor(reg, **knobs)
    obj = (slo or {}).get("e2e")
    last_t = 0.0
    for rec in events:
        if rec.get("ev") != "committed" or obj is None:
            continue
        t = float(rec.get("t", 0.0))
        last_t = max(last_t, t)
        elapsed = float(rec.get("elapsed_sec", 0.0))
        mon.observe_job(rec.get("tenant") or "default",
                        evaluated=1,
                        violated=1 if elapsed > obj else 0, now=t)
    eval_now = now if now is not None else (last_t or time.time())
    states = mon.tick(eval_now)
    return {"states": states, "monitor": mon,
            "snapshot": mon.snapshot(eval_now)}
