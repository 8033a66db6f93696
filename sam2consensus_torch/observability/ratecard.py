"""Learned rate cards: the planner's evidence plane.

Copy of ``sam2consensus_tpu/observability/ratecard.py`` (pinned by
``tests/test_torch_copies.py``).  The serve runner installs a card that
learns from its finished jobs (persisted beside a journal at
:func:`card_path`) and computes the evidence-only scale hint
(:func:`compute_scale_hint` against :func:`drain_target_sec`).

* **estimator** — EWMA mean + EW variance + sample count + last-update
  wall age per rate key (:data:`RATE_KEYS`); a rate is only *served*
  once it clears the min-sample gate (``S2C_RATECARD_MIN_SAMPLES``) AND
  its age is under the staleness bound (:func:`max_age_sec`, the link
  cache's ``S2C_LINK_CACHE_MAX_AGE``: one aging mechanism for every
  learned constant);
* **persistence** — atomically saved (tmp + ``os.replace``) and
  reloaded with age stamps intact; a corrupt file reads as ABSENT with
  a counter (``rate/card_corrupt``);
* **consultation** — decision sites call :func:`consult` against the
  process-installed card (:func:`install`); the returned provenance
  stamp (source learned/default, n, age) rides the decision's ledger
  ``inputs``.  A one-shot run installs no card, so every consult serves
  the caller's default with ``{"source": "default", "key": ...}``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

SCHEMA = "s2c-ratecard/1"

#: the load-bearing rates the planner consults.  The card accepts any
#: key (forward compatibility: an old card file may carry keys a
#: newer build renamed), but these are the ones decision sites read.
RATE_KEYS = (
    "decode_mbps_per_core",     # input MB decoded per second per core
    "dispatch_cells_per_sec",   # pileup cells through dispatch+stage
    "vote_sec_per_mcell",       # consensus vote seconds per 1e6 cells
    "wire_bps",                 # achieved h2d wire bytes/sec
    "link_bps",                 # probed raw link bytes/sec (linkprobe)
    "link_rt_sec",              # probed link round-trip seconds
    "warm_jobs_per_sec",        # serial serve jobs/sec (1/elapsed)
    "packed_jobs_per_sec",      # batch-scheduler jobs/sec
    "cohort_jobs_per_sec",      # cohort-wave samples/sec (serve/cohort
                                # observes per wave; wave sizing
                                # consults it, falling back to the
                                # packed rate before wave 1)
    "steal_sec",                # lease-steal latency (expiry -> claim)
    "recovery_sec",             # steal latency + re-run wall seconds
    "capacity_residual_ratio",  # measured/predicted peak-bytes ratio
)

#: EWMA smoothing: ~last 6 observations dominate — fast enough to
#: track a thermal throttle, slow enough that one weird job cannot
#: repoint the card
DEFAULT_ALPHA = 0.3
#: min samples before an estimate is served to a decision site
DEFAULT_MIN_SAMPLES = 3
#: wire-byte floor under which a job's achieved bps says nothing about
#: the link
MIN_WIRE_BYTES = 1e6


def max_age_sec() -> float:
    """The ONE staleness bound for learned constants — the link
    cache's ``S2C_LINK_CACHE_MAX_AGE`` (seconds, default 7 days).
    ``utils/linkprobe.py`` delegates here, so the card and the link
    cache can never disagree about what "stale" means."""
    try:
        return float(os.environ.get("S2C_LINK_CACHE_MAX_AGE",
                                    7 * 86400))
    except ValueError:
        return 7 * 86400.0


def min_samples() -> int:
    try:
        return max(1, int(os.environ.get("S2C_RATECARD_MIN_SAMPLES",
                                         DEFAULT_MIN_SAMPLES)))
    except ValueError:
        return DEFAULT_MIN_SAMPLES


class RateEstimator:
    """One rate's online state: EWMA mean, EW variance (West's
    update), sample count, last-update wall time."""

    __slots__ = ("mean", "var", "n", "updated_unix")

    def __init__(self, mean: float = 0.0, var: float = 0.0,
                 n: int = 0, updated_unix: float = 0.0):
        self.mean = float(mean)
        self.var = float(var)
        self.n = int(n)
        self.updated_unix = float(updated_unix)

    def observe(self, x: float, now: Optional[float] = None,
                alpha: float = DEFAULT_ALPHA) -> None:
        x = float(x)
        if not math.isfinite(x) or x <= 0.0:
            return                      # rates are strictly positive
        if self.n == 0:
            self.mean, self.var = x, 0.0
        else:
            delta = x - self.mean
            self.mean += alpha * delta
            # EW variance: decays like the mean, so stddev tracks the
            # CURRENT spread, not the lifetime spread
            self.var = (1.0 - alpha) * (self.var
                                        + alpha * delta * delta)
        self.n += 1
        self.updated_unix = float(now if now is not None
                                  else time.time())

    def stddev(self) -> float:
        return math.sqrt(self.var) if self.var > 0.0 else 0.0

    def age_sec(self, now: Optional[float] = None) -> float:
        if not self.updated_unix:
            return float("inf")
        return max(0.0, (now if now is not None else time.time())
                   - self.updated_unix)

    def confident(self, now: Optional[float] = None,
                  n_min: Optional[int] = None) -> bool:
        """Served only past the min-sample gate and under the age
        bound — an estimate that is either young-in-samples or
        stale-in-wall-time falls back to the caller's default."""
        return (self.n >= (n_min if n_min is not None
                           else min_samples())
                and self.age_sec(now) <= max_age_sec())

    def to_dict(self) -> dict:
        return {"mean": self.mean, "var": self.var, "n": self.n,
                "updated_unix": round(self.updated_unix, 3)}

    @classmethod
    def from_dict(cls, d: dict) -> "RateEstimator":
        return cls(mean=float(d.get("mean", 0.0)),
                   var=float(d.get("var", 0.0)),
                   n=int(d.get("n", 0)),
                   updated_unix=float(d.get("updated_unix", 0.0)))


class RateCard:
    """One worker's learned rates + restart lineage; see module doc."""

    def __init__(self, worker: str = "", path: Optional[str] = None):
        self.worker = str(worker or "")
        self.path = path
        self.created_unix = time.time()
        #: successful reloads of a persisted card — the exposition's
        #: restart-epoch label (0 = first life)
        self.restarts = 0
        self._lock = threading.RLock()
        self._est: Dict[str, RateEstimator] = {}

    # -- observation ----------------------------------------------------
    def observe(self, key: str, value: float,
                now: Optional[float] = None) -> None:
        with self._lock:
            est = self._est.get(key)
            if est is None:
                est = self._est[key] = RateEstimator()
            est.observe(value, now=now)

    def observe_job(self, snapshot: dict, elapsed_sec: float,
                    input_bytes: int = 0, decode_cores: int = 1,
                    packed: bool = False,
                    lifecycle: Optional[dict] = None,
                    now: Optional[float] = None) -> Dict[str, float]:
        """Fold one finished job's registry snapshot into the card
        (the ``_finalize_job`` choke point).  Returns the rates
        actually observed (for tests/tools).  Guards: every rate needs
        a meaningful denominator — a sub-millisecond phase or a
        sub-megabyte wire bill observes nothing rather than a noise
        spike."""
        c = snapshot.get("counters", {})
        seen: Dict[str, float] = {}
        dec = float(c.get("phase/decode_sec", 0.0))
        if input_bytes > 0 and dec > 0.005:
            seen["decode_mbps_per_core"] = \
                input_bytes / 1e6 / dec / max(1, int(decode_cores))
        cells = float(c.get("pileup/cells", 0.0))
        disp = (float(c.get("phase/pileup_dispatch_sec", 0.0))
                + float(c.get("phase/accumulate_sec", 0.0))
                + float(c.get("phase/stage_sec", 0.0)))
        if cells > 0 and disp > 0.001:
            seen["dispatch_cells_per_sec"] = cells / disp
        vote = float(c.get("phase/vote_sec", 0.0))
        if cells >= 1e5 and vote > 0.001:
            seen["vote_sec_per_mcell"] = vote / (cells / 1e6)
        wire = float(c.get("wire/bytes", 0.0))
        wden = (float(c.get("phase/stage_sec", 0.0))
                + float(c.get("phase/pileup_dispatch_sec", 0.0)))
        if wire >= MIN_WIRE_BYTES and wden > 0.001:
            seen["wire_bps"] = wire / wden
        if elapsed_sec > 0.001:
            seen["packed_jobs_per_sec" if packed
                 else "warm_jobs_per_sec"] = 1.0 / elapsed_sec
        steal = (lifecycle or {}).get("steal_latency_sec")
        if steal is not None and steal > 0:
            seen["steal_sec"] = float(steal)
            # recovery = expiry-to-claim gap + the re-run itself: the
            # wall cost of losing a worker mid-job, the scale-hint
            # model's churn term
            seen["recovery_sec"] = float(steal) \
                + max(0.0, float(elapsed_sec))
        # capacity model quality: the ledger already joined this job's
        # measured peak against the predicted peak — learn the ratio,
        # so the capacity/mesh_shards provenance stamps can report how
        # tight the upper bound runs on THIS host
        cap = (snapshot.get("gauges", {})
               .get("residual/capacity/bytes") or {})
        if float(cap.get("value", 0.0)) > 0:
            seen["capacity_residual_ratio"] = float(cap["value"])
        for key, val in seen.items():
            self.observe(key, val, now=now)
        return seen

    # -- consultation ---------------------------------------------------
    def rate(self, key: str, default: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            est = self._est.get(key)
            if est is not None and est.confident(now):
                return est.mean
        return default

    def consult(self, key: str, default: float,
                now: Optional[float] = None) -> Tuple[float, dict]:
        """(value, provenance) — the provenance dict is the ledger
        ``inputs["ratecard"]`` stamp: which source priced the
        decision, with the evidence (n, age, spread) to audit it."""
        with self._lock:
            est = self._est.get(key)
            if est is not None and est.confident(now):
                return est.mean, {
                    "source": "learned", "key": key,
                    "n": est.n,
                    "age_sec": round(est.age_sec(now), 1),
                    "stddev": round(est.stddev(), 6),
                    "default": default,
                }
            prov = {"source": "default", "key": key}
            if est is not None:
                prov["n"] = est.n      # gated: young or stale
                if est.updated_unix:
                    prov["age_sec"] = round(est.age_sec(now), 1)
        return float(default), prov

    # -- persistence ----------------------------------------------------
    def to_blob(self, now: Optional[float] = None) -> dict:
        with self._lock:
            return {
                "schema": SCHEMA,
                "worker": self.worker,
                "created_unix": round(self.created_unix, 3),
                "saved_unix": round(now if now is not None
                                    else time.time(), 3),
                "restarts": self.restarts,
                "rates": {k: e.to_dict()
                          for k, e in sorted(self._est.items())},
            }

    def save(self, now: Optional[float] = None) -> None:
        """Atomic persist (tmp + ``os.replace``) — callers absorb
        failures (the telemetry plane's never-fail-a-job rule)."""
        if not self.path:
            return
        blob = self.to_blob(now)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(blob, fh, sort_keys=True, indent=1)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    @classmethod
    def load(cls, path: str, worker: str = "",
             registry=None) -> "RateCard":
        """Load-or-fresh: a missing file is a fresh card; a corrupt or
        schema-mismatched file reads as ABSENT with a counter
        (``rate/card_corrupt``) — never an exception, never a failed
        job.  A successful load bumps ``restarts`` (this process is a
        new life of a persisted card)."""
        card = cls(worker=worker, path=path)
        try:
            with open(path, encoding="utf-8") as fh:
                blob = json.load(fh)
            if blob.get("schema") != SCHEMA:
                raise ValueError(f"schema {blob.get('schema')!r}")
            card.created_unix = float(
                blob.get("created_unix", card.created_unix))
            card.restarts = int(blob.get("restarts", 0)) + 1
            for key, d in (blob.get("rates") or {}).items():
                card._est[str(key)] = RateEstimator.from_dict(d)
        except FileNotFoundError:
            pass
        except Exception:
            if registry is not None:
                try:
                    registry.add("rate/card_corrupt", 1)
                except Exception:
                    pass
            card._est.clear()
            card.restarts = 0
        return card

    # -- export ---------------------------------------------------------
    def publish(self, registry, now: Optional[float] = None) -> None:
        """Refresh the card's gauge family in ``registry`` — rendered
        as ``s2c_rate{key=...}`` (+ ``_stddev``/``_samples``/
        ``_age_seconds``) by the exposition."""
        with self._lock:
            items = list(self._est.items())
            restarts = self.restarts
        for key, est in items:
            registry.gauge(f"rate/mean/{key}").set(round(est.mean, 6))
            registry.gauge(f"rate/stddev/{key}").set(
                round(est.stddev(), 6))
            registry.gauge(f"rate/samples/{key}").set(float(est.n))
            registry.gauge(f"rate/age_seconds/{key}").set(
                round(est.age_sec(now), 1))
        g = registry.gauge("rate/card")
        g.set(float(restarts))
        g.set_info({"worker": self.worker, "restarts": restarts,
                    "path": self.path or "",
                    "max_age_sec": max_age_sec()})

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Health-section view: every estimator with its confidence
        verdict, so an operator sees WHY a rate is (not) being
        served."""
        with self._lock:
            return {
                "worker": self.worker,
                "restarts": self.restarts,
                "rates": {
                    k: {"mean": round(e.mean, 6),
                        "stddev": round(e.stddev(), 6),
                        "n": e.n,
                        "age_sec": round(e.age_sec(now), 1)
                        if e.updated_unix else None,
                        "confident": e.confident(now)}
                    for k, e in sorted(self._est.items())},
            }


# -- process-installed card (decision-site consultation) -------------------
_installed: Optional[RateCard] = None
_install_lock = threading.Lock()


def install(card: Optional[RateCard]) -> None:
    """Make ``card`` the process's consulted card (None uninstalls).
    The serve runner installs its worker card at startup; one-shot CLI
    runs have no card and every consult serves the default."""
    global _installed
    with _install_lock:
        _installed = card


def installed() -> Optional[RateCard]:
    return _installed


def consult(key: str, default: float,
            now: Optional[float] = None) -> Tuple[float, dict]:
    """Decision-site entry point: the installed card's learned rate
    when confident, else ``default`` — always with the provenance
    stamp for the decision's ledger inputs."""
    card = installed()
    if card is None:
        return float(default), {"source": "default", "key": key}
    return card.consult(key, default, now=now)


# -- scale-hint evidence API ------------------------------------------------
def drain_target_sec() -> float:
    """Queue-drain objective the hint plans against
    (S2C_SCALE_DRAIN_TARGET_SEC, default 600 s): a queue projected to
    drain slower than this argues for more workers."""
    try:
        return max(1.0, float(os.environ.get(
            "S2C_SCALE_DRAIN_TARGET_SEC", "600")))
    except ValueError:
        return 600.0


def compute_scale_hint(cards: List[dict], queue_depth: int,
                       workers: int,
                       burn_states: Optional[Dict[str, str]] = None,
                       target_sec: Optional[float] = None,
                       now: Optional[float] = None) -> dict:
    """Evidence-only fleet sizing verdict.

    ``cards`` are card snapshots (:meth:`RateCard.snapshot` dicts —
    the shape both live registries and the persisted JSON provide);
    ``queue_depth`` the journal's live (submitted-not-terminal) count;
    ``burn_states`` tenant -> ok/warn/page from the burn plane.
    Returns ``{verdict, delta, workers, queue_depth, jobs_per_sec,
    projected_drain_sec, target_sec, paging_tenants, reason}`` — the
    ``s2c_fleet_scale_hint`` gauge value is ``delta`` (sign IS the
    verdict), and the whole dict rides the health snapshot and the
    band=0 ``scale_hint`` ledger decision.  No actuation: ROADMAP
    item 3 consumes this."""
    target = target_sec if target_sec is not None else drain_target_sec()
    per_worker: List[float] = []
    for snap in cards:
        rates = (snap or {}).get("rates") or {}
        best = 0.0
        for key in ("warm_jobs_per_sec", "packed_jobs_per_sec"):
            ent = rates.get(key) or {}
            if ent.get("confident") and float(ent.get("mean", 0)) > 0:
                best = max(best, float(ent["mean"]))
        if best > 0:
            per_worker.append(best)
    paging = sorted(t for t, s in (burn_states or {}).items()
                    if s == "page")
    total_jps = sum(per_worker)
    mean_jps = (total_jps / len(per_worker)) if per_worker else 0.0
    hint = {
        "workers": int(workers),
        "queue_depth": int(queue_depth),
        "jobs_per_sec": round(total_jps, 6),
        "target_sec": round(target, 1),
        "paging_tenants": paging,
        "confident_cards": len(per_worker),
    }
    if not per_worker:
        # no card has cleared the confidence gate yet: refusing to
        # guess IS the evidence discipline
        hint.update(verdict="hold", delta=0,
                    projected_drain_sec=None,
                    reason="no_confident_rate")
        return hint
    drain = queue_depth / total_jps if total_jps > 0 else float("inf")
    hint["projected_drain_sec"] = round(drain, 1)
    needed = max(1, int(math.ceil(
        queue_depth / (mean_jps * target))) if queue_depth else 1)
    if paging:
        delta = max(1, needed - workers)
        hint.update(verdict="up", delta=int(delta),
                    reason="tenant_paging")
    elif drain > target and needed > workers:
        hint.update(verdict="up", delta=int(needed - workers),
                    reason="drain_over_target")
    elif workers > 1 and needed < workers and drain < 0.25 * target:
        hint.update(verdict="down", delta=int(needed - workers),
                    reason="headroom")
    else:
        hint.update(verdict="hold", delta=0, reason="in_band")
    return hint


def card_path(journal_root: str, worker: str) -> str:
    """Canonical per-worker card file next to the shared journal."""
    return os.path.join(journal_root, f"ratecard-{worker}.json")
