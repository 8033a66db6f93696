"""Cohort-scale serving: manifest-streamed waves over a shared panel.

Port of ``sam2consensus_tpu/serve/cohort.py``.  The batch scheduler
(``serve/scheduler.py``) packs whatever small jobs happen to be queued; a
COHORT is what target-capture users ship: hundreds to tens of thousands
of samples, every one aligned against the SAME reference panel.  That
sameness collapses the remaining per-job planning costs:

* **layout dedup**: equal :func:`~.packing.reference_fingerprint` implies
  an equal layout, so ONE :class:`~.packing.PanelGeometry` is planned
  before wave 1 and every wave reuses it (``batch/panel_plans`` == 1,
  ``batch/panel_reuses`` a wave);
* **one build footprint**: the canonical slab shapes of the combined
  panel axis (:func:`~..ops.pileup.canonical_panel_shapes`) are
  prewarmed once, before wave 1: the kernel extension's load and K1's
  all-PAD launches at each shape (``ServeRunner.prewarm``);
* **manifest streaming**: the cohort arrives as ONE manifest (a
  directory, a file list, or a JSONL listing); the driver slices it into
  packed waves, probes wave k+1's headers on a side thread while wave k
  dispatches (the scheduler's ``probe_cache``), and journals a
  ``cohort_wave`` marker per finished wave, so a restarted cohort resumes
  at the last committed wave;
* **occupancy-aware wave sizing**: each wave's size comes from the hard
  caps (combined length, ``--max-queue``, ``--mem-budget`` through the
  memory plane's predicted peak) and a learned packed rate
  (``cohort_jobs_per_sec`` x ``S2C_COHORT_WAVE_SEC``), priced as a
  ``cohort_wave`` ledger decision per wave.

Failure semantics are the scheduler's: a fault inside a wave's packed
phases demotes that wave's members whole to the serial path
(``batch/demotions``); the cohort keeps streaming, and a crash resumes
from the journal.

Outputs: per-sample FASTAs byte-identical to serial runs, plus a
per-position call-concordance summary.  The tally
(:class:`ConcordanceAccumulator`) is a tensor on the runner's device: on
the card the scheduler's count tap hands it each packed member's slice
of the shared device counts, read on the batch's stream behind its K1
launches, and the member's calls are made and added there, so no
member's counts cross to the host and the tap adds no host
synchronisation; the tally is fetched once, for the summary.  On the CPU
the tap slices the batch's combined fetch, as the reference's.  Members
that ran serially are back-filled from the host oracle
(:func:`oracle_member_counts`) and their host counts added to the same
tally.

The port has no JIT: the summary's ``jit_cache_hits`` /
``jit_cache_misses`` keep the reference's names but read the kernel
extension's build cache, ``compile/persist_hit`` / ``compile/persist_miss``
(``kernels/build.py``, ``observability/jitcache.py``): a miss is a load
that compiled.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import logging
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import observability as obs
from ..constants import NUM_SYMBOLS
from ..observability.ledger import finalize as ledger_finalize
from ..observability import ratecard as rcard
from . import packing

logger = logging.getLogger("sam2consensus_torch.serve.cohort")

#: manifest directory scan picks up exactly the container formats the
#: ingest layer sniffs (formats/)
MANIFEST_EXTS = (".sam", ".sam.gz", ".bam")

#: wave-duration target the rate-based sizing aims at: big enough to
#: amortize per-wave fixed costs, small enough that progress gauges
#: and the journal's wave markers stay live
DEFAULT_WAVE_SEC = 2.0


def _wave_sec() -> float:
    try:
        return max(0.1, float(os.environ.get("S2C_COHORT_WAVE_SEC",
                                             DEFAULT_WAVE_SEC)))
    except ValueError:
        return DEFAULT_WAVE_SEC


# -- manifest ---------------------------------------------------------------
def load_manifest(path: str) -> List[str]:
    """Resolve a cohort manifest to an ordered list of input paths.

    Three shapes, dispatched on what ``path`` is:

    * a **directory** — every ``*.sam`` / ``*.sam.gz`` / ``*.bam``
      directly inside it, sorted by name;
    * a **``.jsonl`` file** — one JSON object per line, each with a
      ``"path"`` key (the object-store-listing shape); relative paths
      resolve against the manifest's own directory;
    * any other **text file** — one path or glob per line, ``#``
      comments and blank lines skipped, globs expanded (sorted)
      relative to the manifest's directory.

    Raises ``ValueError`` on an empty resolution — a cohort of zero
    samples is a manifest bug, not a successful no-op."""
    out: List[str] = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith(MANIFEST_EXTS):
                out.append(os.path.join(path, name))
    elif path.endswith(".jsonl"):
        base = os.path.dirname(os.path.abspath(path))
        with open(path, "r", encoding="utf-8") as fh:
            for ln, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError as exc:
                    raise ValueError(
                        f"{path}:{ln}: not JSON ({exc})") from None
                p = row.get("path") if isinstance(row, dict) else None
                if not p:
                    raise ValueError(
                        f"{path}:{ln}: listing row has no 'path' key")
                out.append(p if os.path.isabs(p)
                           else os.path.join(base, p))
    else:
        base = os.path.dirname(os.path.abspath(path))
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line if os.path.isabs(line) \
                    else os.path.join(base, line)
                if any(ch in line for ch in "*?["):
                    out.extend(sorted(glob.glob(p)))
                else:
                    out.append(p)
    if not out:
        raise ValueError(
            f"cohort manifest {path!r} resolved to zero inputs")
    return out


# -- concordance ------------------------------------------------------------
class ConcordanceAccumulator:
    """Per-position call concordance across a shared-panel cohort.

    Each member contributes one modal CALL per panel position (argmax
    over its private ``[panel_len, 6]`` count partition, the first
    maximal lane on a tie; zero depth = the explicit no-call lane),
    accumulated into a ``[panel_len, 7]`` int64 tally held as a tensor on
    ``device`` (the cohort runner passes its backend's).  Concordance at
    a position is the modal-call fraction among members that made a call
    there (positions nobody called read 1.0 — absence of evidence is not
    discordance).  The summary's ``digest`` hashes the raw tally's
    int64 C-order bytes, the reference's, so "pinned vs CPU oracle" is
    one dict equality."""

    NO_CALL = NUM_SYMBOLS          # lane 6: zero-depth positions

    def __init__(self, panel_len: int, device=None):
        self.panel_len = int(panel_len)
        self.members = 0
        self.device = torch.device("cpu" if device is None else device)
        self._table = torch.zeros((self.panel_len, NUM_SYMBOLS + 1),
                                  dtype=torch.int64, device=self.device)
        self._ones = torch.ones((self.panel_len, 1), dtype=torch.int64,
                                device=self.device)

    def add_member(self, counts) -> None:
        """Add one member's calls: ``counts`` a ``[panel_len, 6]`` tensor
        (a slice of a batch's device counts, used where it lies) or
        array (copied to the tally's device).  Everything is enqueued on
        the current stream; nothing is read back."""
        if not isinstance(counts, torch.Tensor):
            counts = torch.from_numpy(np.ascontiguousarray(counts))
        if counts.shape[0] != self.panel_len:
            raise ValueError(
                f"member counts cover {counts.shape[0]} positions; "
                f"the cohort panel has {self.panel_len}")
        counts = counts.to(self.device)
        calls = torch.argmax(counts, dim=1)
        calls = torch.where(counts.sum(dim=1) > 0, calls, self.NO_CALL)
        self._table.scatter_add_(1, calls.unsqueeze(1), self._ones)
        self.members += 1

    def table(self) -> np.ndarray:
        """The tally fetched to the host (the one fetch)."""
        return self._table.cpu().numpy()

    def summary(self) -> dict:
        table = self.table()
        called = table[:, :NUM_SYMBOLS]
        ncalled = called.sum(axis=1)
        modal = called.max(axis=1)
        conc = np.where(ncalled > 0,
                        modal / np.maximum(ncalled, 1), 1.0)
        return {
            "schema": "s2c-cohort-concordance/1",
            "panel_len": self.panel_len,
            "members": int(self.members),
            "mean_concordance": round(float(conc.mean()), 6)
            if self.panel_len else 1.0,
            "min_concordance": round(float(conc.min()), 6)
            if self.panel_len else 1.0,
            "discordant_positions": int((conc < 1.0).sum()),
            "digest": hashlib.sha1(
                table.tobytes()).hexdigest()[:16],
        }


def oracle_member_counts(filename: str, cfg, backend=None) -> np.ndarray:
    """One member's ``[panel_len, 6]`` count array via the host oracle
    path: serial decode (the backend's ``_make_encoder``) + host
    accumulation (``HostPileupAccumulator``), no packing, no device.
    This is both the concordance pin's independent evidence source and
    the back-fill for members the packed path demoted to serial (their
    partitions never crossed the combined tensor, so the count tap
    never saw them).  ``backend=None`` builds a ``TorchBackend`` on the
    default device (``device.resolve_device``: CUDA); only the decode
    reads it."""
    from ..backends.base import BackendStats
    from ..config import resolve_decode_threads
    from ..encoder.events import GenomeLayout
    from ..formats import open_alignment_input
    from ..ops.pileup import HostPileupAccumulator

    if backend is None:
        from ..backends.torch_backend import TorchBackend
        from ..device import resolve_device

        backend = TorchBackend(resolve_device(None))
    robs = obs.prepare_run(config=None)
    ai = open_alignment_input(
        filename, getattr(cfg, "input_format", "auto"),
        threads=resolve_decode_threads(cfg))
    try:
        with obs.bind_run_to_thread(robs):
            layout = GenomeLayout(ai.contigs)
            acc = HostPileupAccumulator(layout.total_len)
            _encoder, gen = backend._make_encoder(layout, ai.stream,
                                                  cfg, BackendStats(), None)
            for batch in gen:
                acc.add(batch)
            return np.asarray(acc.counts_host())
    finally:
        ai.close()


# -- wave sizing ------------------------------------------------------------
def wave_cap(samples_left: int, panel_len: int, cfg, scheduler,
             admission) -> Tuple[int, dict]:
    """The HARD member cap any wave of this cohort must respect: the
    scheduler's combined-length cap, the admission window
    (``--max-queue``), and the largest wave whose predicted peak
    (:func:`~..observability.memplane.predict_job_peak_bytes` over
    ``W * panel_len``) fits ``--mem-budget`` (binary search; raises
    when even a 2-member wave cannot fit — a cohort that would trip
    admission mid-stream must fail at sizing time, not wave 40).

    Computed once up front to size the ONE canonical
    :class:`~.packing.PanelGeometry` (every wave is a prefix slice of
    it, so no wave can ever force a re-plan), then again per wave by
    :func:`size_wave` against the shrinking remainder."""
    panel_len = max(1, int(panel_len))
    len_cap = scheduler.max_combined_len // panel_len
    if len_cap < 2:
        raise ValueError(
            f"panel of {panel_len} positions: even 2 members exceed "
            f"the combined-length cap ({scheduler.max_combined_len}; "
            f"raise S2C_BATCH_MAX_LEN) — this cohort cannot pack")
    cap = min(len_cap, max(1, int(samples_left)))
    inputs: dict = {"samples_left": int(samples_left),
                    "panel_len": panel_len, "len_cap": len_cap}
    if admission.max_queue:
        cap = min(cap, admission.max_queue)
        inputs["queue_cap"] = admission.max_queue
    if admission.mem_budget:
        from ..observability import memplane

        lo, hi, best = 1, cap, 0
        while lo <= hi:
            mid = (lo + hi) // 2
            if memplane.predict_job_peak_bytes(
                    mid * panel_len, cfg) <= admission.mem_budget:
                best, lo = mid, mid + 1
            else:
                hi = mid - 1
        if best < 2 <= samples_left:
            raise ValueError(
                f"--mem-budget {admission.mem_budget}: predicted peak "
                f"of a 2-member wave over a {panel_len}-position panel "
                f"already exceeds the budget — raise the budget or "
                f"shrink the panel")
        cap = min(cap, max(1, best))
        inputs["mem_cap"] = best
    return cap, inputs


def size_wave(samples_left: int, panel_len: int, cfg, scheduler,
              admission, requested: int = 0, jps: float = 1.0,
              wave_sec: Optional[float] = None,
              rows_per_member: float = 0.0) -> Tuple[int, dict]:
    """Pick the next wave's member count; returns ``(W, inputs)`` with
    the sizing evidence for the ``cohort_wave`` ledger decision.

    Hard caps first (:func:`wave_cap`).  Within them, an explicit
    ``--cohort-wave N`` wins; otherwise the wave targets ``jps *
    wave_sec`` members (the learned packed rate × the wave duration
    target), floored at 2 — a wave of one cannot pack.  When the
    driver has learned ``rows_per_member`` from a finished wave, the
    rate target is then SNAPPED (±25%, still capped) to the candidate
    whose estimated slab row count sits closest under its pow2 pad
    boundary (:func:`~.packing._pad_rows`) — trading a slightly
    off-target wave for dispatch rows that are mostly real instead of
    pad, which is where a cohort's throughput actually goes."""
    wave_sec = _wave_sec() if wave_sec is None else float(wave_sec)
    cap, inputs = wave_cap(samples_left, panel_len, cfg, scheduler,
                           admission)
    if requested:
        w = min(int(requested), cap)
        inputs["requested"] = int(requested)
    else:
        target = max(2, int(round(max(0.1, jps) * wave_sec)))
        w = min(target, cap)
        inputs["rate_target"] = target
        inputs["wave_sec_target"] = wave_sec
        # pow2 snap only when MORE waves follow anyway: shrinking the
        # final wave below the remainder would mint extra waves, and a
        # wave's fixed costs always beat its pad rows' (the accumulator
        # trims the pad tail before dispatch — ops/pileup.py add)
        if rows_per_member > 0 and w >= 2 \
                and samples_left > int(math.ceil(w * 1.25)):
            lo_w = max(2, int(math.ceil(w * 0.75)))
            hi_w = max(lo_w, min(cap, int(math.ceil(w * 1.25))))
            best_w, best_occ = w, -1.0
            for cand in range(lo_w, hi_w + 1):
                rows = max(1, int(round(cand * rows_per_member)))
                occ = rows / packing._pad_rows(rows)
                if occ > best_occ + 1e-9 or (
                        abs(occ - best_occ) <= 1e-9
                        and abs(cand - w) < abs(best_w - w)):
                    best_w, best_occ = cand, occ
            w = best_w
            inputs["rows_per_member"] = round(rows_per_member, 2)
            inputs["occupancy_target_pct"] = round(100.0 * best_occ, 1)
    w = max(1, min(w, samples_left))
    if samples_left >= 2:
        w = max(2, w)
    inputs["wave_jobs"] = w
    return w, inputs


# -- the driver -------------------------------------------------------------
class CohortRunner:
    """Stream one manifest's samples through a ServeRunner in packed
    waves.  One instance per cohort submission; attach via
    ``CohortRunner(runner, ...).run()`` — the instance registers
    itself as ``runner.cohort`` so the health snapshot and
    ``tools/s2c_top.py`` see live progress."""

    def __init__(self, runner, paths: List[str], base_config,
                 wave: int = 0, tenant: str = "",
                 concordance: str = "on",
                 summary_out: Optional[str] = None,
                 echo: Optional[Callable] = None):
        sched = getattr(runner, "scheduler", None)
        if sched is None or not sched.enabled:
            raise ValueError(
                "cohort serving rides the batch scheduler: start the "
                "server with --batch auto (or --batch N)")
        if concordance not in ("on", "off"):
            raise ValueError(
                f"concordance={concordance!r}: use 'on' or 'off'")
        self.runner = runner
        self.sched = sched
        self.paths = list(paths)
        self.base_config = base_config
        self.requested_wave = max(0, int(wave or 0))
        self.tenant = tenant or ""
        self.summary_out = summary_out
        self.echo = echo or (lambda *a, **k: None)
        # -- progress state (health_summary reads these live) ----------
        self.samples_total = len(self.paths)
        self.samples_done = 0
        self.resumed = 0
        self.failed = 0
        self.waves_done = 0
        self.waves_total_est = 0
        self.panel_len = 0
        self.ref_fp = ""
        self.admission_trips = 0
        self.last_wave: dict = {}
        self.decisions: List[dict] = []
        self.results: List[object] = []
        self.concordance: Optional[ConcordanceAccumulator] = None
        #: bench/test seam: called as ``wave_hook(k)`` after wave ``k``
        #: fully finalizes (counters folded, journal marker written) —
        #: how the cohort bench snapshots plan/compile counters at wave
        #: boundaries without reaching into the wave loop
        self.wave_hook: Optional[Callable[[int], None]] = None
        self._want_concordance = concordance == "on"
        self._jps_ema: Optional[float] = None
        #: learned decoded rows per member (EMA over finished waves) —
        #: feeds size_wave's pow2 occupancy snapping
        self._rows_per_member: float = 0.0
        self._tapped: set = set()
        self._lock = threading.Lock()
        runner.cohort = self

    # -- pieces ------------------------------------------------------------
    def _spec(self, idx: int, path: str):
        from ..config import default_prefix
        from .runner import JobSpec

        cfg = self.base_config
        if not cfg.prefix:
            # per-sample default prefix (input basename), the same rule
            # the CLI applies per -i input — a shared-panel cohort's
            # outputs would otherwise all collapse onto one filename
            cfg = dataclasses.replace(cfg,
                                      prefix=default_prefix(path))
        return JobSpec(filename=path, config=cfg,
                       job_id=f"c{idx}:{os.path.basename(path)}",
                       tenant=self.tenant)

    def _prefilter_resumed(self) -> List[Tuple[int, str]]:
        """Journal-backed resume: drop samples whose jobs a previous
        process already committed (outputs still fingerprint-match), so
        a restarted cohort's waves contain only pending work — the
        resume position IS the last committed wave."""
        from . import journal as sjournal

        runner = self.runner
        if runner.journal is None:
            return list(enumerate(self.paths))
        replay = runner.journal.replay()
        left: List[Tuple[int, str]] = []
        for idx, path in enumerate(self.paths):
            key = sjournal.job_key(path, self._spec(idx, path).config)
            rec = replay.committed.get(key)
            if rec is not None and runner.journal.verify_outputs(
                    rec, mode=runner.verify_mode):
                self.resumed += 1
            else:
                left.append((idx, path))
        if self.resumed:
            runner.registry.add("cohort/resumed_skipped", self.resumed)
        return left

    def _probe_panel(self, path: str) -> None:
        """Header-probe the first pending sample for the cohort's panel
        geometry; the OPEN handle parks in the scheduler's probe cache
        so wave 1's compose reuses it (one header parse per member,
        cohort-wide)."""
        from ..config import resolve_decode_threads
        from ..encoder.events import GenomeLayout
        from ..formats import open_alignment_input

        ai = open_alignment_input(
            path, getattr(self.base_config, "input_format", "auto"),
            threads=resolve_decode_threads(self.base_config))
        try:
            layout = GenomeLayout(ai.contigs)
            self.panel_len = layout.total_len
            self.ref_fp = packing.reference_fingerprint(ai.contigs)
        except BaseException:
            ai.close()
            raise
        entry = {"batch_total_len": self.panel_len,
                 "batch_handle": ai, "batch_ref_fp": self.ref_fp}
        try:
            entry["batch_bytes"] = os.path.getsize(path)
        except OSError:
            pass
        self.sched.probe_cache[path] = entry
        if self.panel_len <= 0:
            raise ValueError(f"{path!r}: empty reference panel")
        if self.panel_len > self.sched.max_member_len:
            raise ValueError(
                f"panel of {self.panel_len} positions exceeds the "
                f"packable member cap ({self.sched.max_member_len}; "
                f"S2C_BATCH_MAX_MEMBER_LEN) — this cohort cannot pack")

    def _prefetch(self, batch_paths: List[str]) -> None:
        """Probe the NEXT wave's headers off-thread while the current
        wave decodes/dispatches, parking results (open handles
        included) in the scheduler's probe cache.  Failures are
        absorbed: the critical-path probe will re-open and surface the
        real error in the right job."""
        from ..config import resolve_decode_threads
        from ..encoder.events import GenomeLayout
        from ..formats import open_alignment_input

        for path in batch_paths:
            if path in self.sched.probe_cache:
                continue
            try:
                ai = open_alignment_input(
                    path,
                    getattr(self.base_config, "input_format", "auto"),
                    threads=resolve_decode_threads(self.base_config))
            except Exception:
                self.runner.registry.add("cohort/prefetch_failed", 1)
                continue
            try:
                entry = {
                    "batch_total_len": GenomeLayout(
                        ai.contigs).total_len,
                    "batch_handle": ai,
                    "batch_ref_fp": packing.reference_fingerprint(
                        ai.contigs),
                }
                try:
                    entry["batch_bytes"] = os.path.getsize(path)
                except OSError:
                    pass
                self.sched.probe_cache[path] = entry
            except Exception:
                ai.close()
                self.runner.registry.add("cohort/prefetch_failed", 1)

    def _drain_probe_cache(self) -> None:
        for path in list(self.sched.probe_cache):
            entry = self.sched.probe_cache.pop(path, None)
            ai = (entry or {}).get("batch_handle")
            if ai is not None:
                try:
                    ai.close()
                except Exception:
                    pass

    def _tap(self, job_id: str, counts) -> None:
        """Scheduler count tap: one member's private partition — a slice
        of the batch's shared device counts on the card, of its combined
        fetch on the CPU — or a back-filled member's host counts."""
        with self._lock:
            if self.concordance is not None:
                self.concordance.add_member(counts)
                self._tapped.add(job_id)

    def _prewarm(self, wave_jobs: int) -> int:
        """Prewarm the combined panel axis's canonical slab shapes ONCE,
        before wave 1 (``ServeRunner.prewarm``: the kernel extension's
        load and K1's all-PAD launches); the host accumulation rung
        launches no K1, so it skips."""
        if self.runner.prewarm_mode == "off" \
                or self.sched._accum_host_rung():
            return 0
        from ..encoder.events import resolve_segment_width
        from ..ops.pileup import canonical_panel_shapes

        shapes = canonical_panel_shapes(
            self.panel_len, wave_jobs,
            chunk_reads=self.base_config.chunk_reads,
            segment_width=resolve_segment_width(
                getattr(self.base_config, "segment_width", 0)))
        return self.runner.prewarm(self.panel_len * wave_jobs, shapes)

    def _consult_jps(self) -> Tuple[float, dict]:
        """The jobs/s estimate wave sizing prices against: the learned
        ``cohort_jobs_per_sec`` card when confident, else this run's
        own EMA, else (before wave 1) the packed-batch rate or the
        scheduler's shared-wall model."""
        if self._jps_ema is not None:
            default = self._jps_ema
        else:
            packed, _ = rcard.consult("packed_jobs_per_sec", 0.0)
            default = packed or self._heuristic_jps()
        val, prov = rcard.consult("cohort_jobs_per_sec", default)
        return max(0.1, float(val)), prov

    def _heuristic_jps(self) -> float:
        n = max(2, self.sched.max_jobs)
        first = self.sched.probe_cache.get(
            next(iter(self.sched.probe_cache), ""), {})
        bytes_total = n * int(first.get("batch_bytes") or 1 << 20)
        pred = self.sched._predict_wall(n, bytes_total,
                                        self.sched._accum_host_rung())
        return n / max(1e-6, pred)

    # -- the run -----------------------------------------------------------
    def run(self) -> dict:
        runner = self.runner
        reg = runner.registry
        t_run0 = time.perf_counter()
        left = self._prefilter_resumed()
        if self.resumed:
            self.echo(f"cohort: {self.resumed} sample(s) already "
                      "committed — resuming from the journal's last "
                      "committed wave")
        if not left:
            return self._summarize(t_run0)
        self._probe_panel(left[0][1])
        if self._want_concordance:
            self.concordance = ConcordanceAccumulator(
                self.panel_len, device=runner.backend.device)
            runner.count_tap = self._tap
        self.echo(f"cohort: {len(left)} pending sample(s) over a "
                  f"{self.panel_len}-position panel "
                  f"(fingerprint {self.ref_fp})")
        # ONE canonical slab geometry for the whole cohort, planned at
        # the hard wave cap: rate-sized waves vary in member count, and
        # a geometry sized to wave 0 would force the scheduler to
        # re-plan the first time a wave outgrew it.  Planned here, every
        # wave — whatever its size — is a prefix slice of this table
        # (``batch/panel_reuses`` per wave, ``batch/panel_plans`` == 1).
        cap, _ = wave_cap(len(left), self.panel_len, self.base_config,
                          self.sched, runner.admission)
        key = (self.ref_fp, self.panel_len)
        if self.sched._panel_geoms.get(key) is None \
                or self.sched._panel_geoms[key].max_jobs < cap:
            self.sched._panel_geoms[key] = packing.PanelGeometry(
                fingerprint=self.ref_fp, panel_len=self.panel_len,
                max_jobs=max(2, cap))
            reg.add("batch/panel_plans", 1)
        pos, k = 0, 0
        prefetcher: Optional[threading.Thread] = None
        prev_max_jobs, prev_mode = self.sched.max_jobs, self.sched.mode
        try:
            while pos < len(left):
                samples_left = len(left) - pos
                jps, prov = self._consult_jps()
                w, inputs = size_wave(
                    samples_left, self.panel_len, self.base_config,
                    self.sched, runner.admission,
                    requested=self.requested_wave, jps=jps,
                    rows_per_member=self._rows_per_member)
                predicted_bytes = 0
                if runner.admission.mem_budget:
                    from ..observability import memplane

                    predicted_bytes = memplane.predict_job_peak_bytes(
                        w * self.panel_len, self.base_config)
                dec = runner.admission.price_cohort_wave(
                    w, predicted_bytes)
                if not dec.admitted:
                    # sizing already honored every cap, so a reject
                    # here is model disagreement — halve and count it
                    # (the bench gates this counter at zero)
                    self.admission_trips += 1
                    reg.add("cohort/admission_trips", 1)
                    if w <= 2:
                        raise ValueError(
                            f"cohort wave of {w} rejected "
                            f"({dec.reason}) — nothing left to shrink")
                    w = max(2, w // 2)
                    inputs["halved_on"] = dec.reason
                if k == 0:
                    self._prewarm(w)
                wave_items = left[pos:pos + w]
                # overlap: probe wave k+1's headers while this wave
                # decodes/dispatches (join before ITS submit consumes
                # the cache, so entries are never half-written)
                if prefetcher is not None:
                    prefetcher.join()
                nxt = [p for _, p in left[pos + w:pos + 2 * w]]
                if nxt:
                    prefetcher = threading.Thread(
                        target=self._prefetch, args=(nxt,),
                        name="cohort-prefetch", daemon=True)
                    prefetcher.start()
                self.sched.max_jobs = max(2, w)
                self._run_wave(k, w, wave_items, inputs, jps, prov,
                               pos, left)
                pos += w
                k += 1
        finally:
            if prefetcher is not None:
                prefetcher.join()
            runner.count_tap = None
            self.sched.max_jobs, self.sched.mode = (prev_max_jobs,
                                                    prev_mode)
            self._drain_probe_cache()
        return self._summarize(t_run0)

    def _run_wave(self, k: int, w: int,
                  wave_items: List[Tuple[int, str]], inputs: dict,
                  jps: float, prov: dict, pos: int,
                  left: List[Tuple[int, str]]) -> None:
        from ..io.fasta import write_outputs

        runner = self.runner
        reg = runner.registry
        specs = [self._spec(i, p) for i, p in wave_items]
        wobs = obs.prepare_run(config=None)
        # informational (band=0) until the rate is learned: the first
        # wave carries cold start, and a default-priced prediction has
        # no calibration to hold a band against (the serve_batch
        # first-batch precedent)
        rec = wobs.ledger.record(
            "cohort_wave", str(w),
            inputs={**inputs, "wave": k,
                    "jobs_per_sec_est": round(jps, 3)},
            predicted={"sec": w / jps, "jobs_per_sec": jps},
            measured={"sec": {"counters": ["cohort/wave_wall_sec"]},
                      "jobs_per_sec": {
                          "num": ["cohort/wave_jobs"],
                          "den": ["cohort/wave_wall_sec"]}},
            provenance=prov,
            band=0 if (k == 0 or prov.get("source") != "learned")
            else None)
        t0 = time.perf_counter()
        results = runner.submit_jobs(specs)
        wall = max(1e-9, time.perf_counter() - t0)
        n_ok = sum(1 for r in results if r.ok)
        self.samples_done += n_ok
        self.failed += len(results) - n_ok
        self.results.extend(results)
        # concordance back-fill: members the packed path demoted ran
        # serially, so the count tap never saw their partitions — the
        # CPU oracle accumulation supplies them (same counts by the
        # byte-identity contract)
        if self.concordance is not None:
            for spec, r in zip(specs, results):
                if r.ok and not r.resumed \
                        and r.job_id not in self._tapped:
                    try:
                        self._tap(r.job_id, oracle_member_counts(
                            spec.filename, spec.config,
                            backend=runner.backend))
                        reg.add("cohort/concordance_oracle_members", 1)
                    except Exception:
                        reg.add("cohort/concordance_skipped", 1)
        # outputs: journal mode already wrote them at commit; otherwise
        # write per-sample FASTAs here (same writer the CLI uses)
        for spec, r in zip(specs, results):
            if r.ok and not r.resumed and not r.output_paths \
                    and r.fastas is not None:
                write_outputs(r.fastas, spec.config.outfolder,
                              spec.config.prefix, spec.config.nchar,
                              spec.config.thresholds,
                              echo=lambda *a, **kw: None)
        # join the wave's decision against its measured counters, fold
        # the wave-scope instruments into the server aggregate
        wobs.registry.add("cohort/wave_wall_sec", wall)
        wobs.registry.add("cohort/wave_jobs", n_ok)
        ledger_finalize(wobs.ledger, wobs.registry, wobs.tracer)
        self.decisions.append(rec.to_dict())
        try:
            reg.fold(wobs.registry, job_id=f"cohort-w{k}")
        except Exception:
            reg.add("telemetry/fold_failed", 1)
        measured_jps = n_ok / wall
        if n_ok:
            self._jps_ema = measured_jps if self._jps_ema is None \
                else 0.6 * self._jps_ema + 0.4 * measured_jps
            card = rcard.installed()
            if card is not None:
                card.observe("cohort_jobs_per_sec", measured_jps)
        runner._journal_append(
            "cohort_wave", wave=k, jobs=len(results), ok=n_ok,
            wall_sec=round(wall, 4),
            jobs_per_sec=round(measured_jps, 3),
            fingerprint=self.ref_fp)
        # -- live progress (health snapshot + s2c_top) -----------------
        self.waves_done += 1
        remaining = len(left) - pos - w
        self.waves_total_est = self.waves_done \
            + int(math.ceil(remaining / max(1, w)))
        snap_g = reg.snapshot()["gauges"]
        occ = snap_g.get("batch/occupancy_pct", {}).get("value", 0.0)
        rows = snap_g.get("batch/real_rows", {}).get("value", 0.0)
        if rows and results:
            rpm = rows / len(results)
            self._rows_per_member = rpm if not self._rows_per_member \
                else 0.6 * self._rows_per_member + 0.4 * rpm
        self.last_wave = {"wave": k, "jobs": len(results), "ok": n_ok,
                          "wall_sec": round(wall, 3),
                          "jobs_per_sec": round(measured_jps, 3),
                          "occupancy_pct": occ}
        reg.gauge("cohort/waves_done").set(float(self.waves_done))
        reg.gauge("cohort/waves_total").set(float(self.waves_total_est))
        reg.gauge("cohort/samples_done").set(
            float(self.samples_done + self.resumed))
        reg.gauge("cohort/samples_total").set(float(self.samples_total))
        reg.gauge("cohort/jobs_per_sec").set(round(measured_jps, 3))
        reg.gauge("cohort/occupancy_pct").set(occ)
        reg.gauge("cohort/progress").set_info(dict(self.last_wave))
        self.echo(f"cohort wave {k}: {n_ok}/{len(results)} ok in "
                  f"{wall:.2f}s ({measured_jps:.1f} jobs/s, "
                  f"occupancy {occ:.0f}%)")
        if self.wave_hook is not None:
            try:
                self.wave_hook(k)
            except Exception:
                pass

    # -- reporting ---------------------------------------------------------
    def health_summary(self) -> dict:
        """The health snapshot's ``cohort`` section (serve/health.py);
        cheap and lock-free — read by telemetry threads mid-wave."""
        return {
            "samples_total": self.samples_total,
            "samples_done": self.samples_done + self.resumed,
            "resumed": self.resumed,
            "failed": self.failed,
            "waves_done": self.waves_done,
            "waves_total_est": self.waves_total_est,
            "panel_len": self.panel_len,
            "reference_fingerprint": self.ref_fp,
            "admission_trips": self.admission_trips,
            "last_wave": dict(self.last_wave),
        }

    def _summarize(self, t_run0: float) -> dict:
        reg = self.runner.registry
        elapsed = max(1e-9, time.perf_counter() - t_run0)
        summary = {
            "schema": "s2c-cohort/1",
            "samples_total": self.samples_total,
            "samples_ok": self.samples_done,
            "resumed": self.resumed,
            "failed": self.failed,
            "waves": self.waves_done,
            "panel_len": self.panel_len,
            "reference_fingerprint": self.ref_fp,
            "panel_plans": int(reg.value("batch/panel_plans")),
            "panel_reuses": int(reg.value("batch/panel_reuses")),
            # no JIT in the port: the kernel extension's build cache
            "jit_cache_hits": int(reg.value("compile/persist_hit")),
            "jit_cache_misses": int(
                reg.value("compile/persist_miss")),
            "batch_demotions": int(reg.value("batch/demotions")),
            "admission_trips": self.admission_trips,
            "elapsed_sec": round(elapsed, 3),
            "jobs_per_sec": round(self.samples_done / elapsed, 3),
            "decisions": list(self.decisions),
            "concordance": self.concordance.summary()
            if self.concordance is not None else None,
        }
        if self.summary_out:
            from ..observability.telemetry import atomic_write_text

            try:
                atomic_write_text(self.summary_out,
                                  json.dumps(summary, indent=1,
                                             sort_keys=False) + "\n")
            except Exception as exc:
                reg.add("telemetry/write_failed", 1)
                logger.warning("cohort summary write failed: %s", exc)
        return summary
