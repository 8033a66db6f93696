"""Continuous batching: the cross-job slab-packing scheduler.

Port of ``sam2consensus_tpu/serve/scheduler.py``.  The warm server
(``serve/runner.py``) otherwise runs jobs one after another, each small
job owning the card for its own dispatch sequence.  This module drains the
admission queue, packs many small jobs' segment rows into shared slabs
(``serve/packing.py``) so N jobs ride ONE dispatch sequence, then runs
each job's tail and render through the cold run's own code
(``TorchBackend.run_from_counts`` / ``assemble_partition``): per-job byte
identity is structural, not asserted.

**The shared accumulator.**  On the card it is K1's
(``PileupAccumulator(total_len, device, "pallas", "packed5")``, recorded
as ``strategy: pallas`` in ``dispatch/pileup``): the merged slabs cross
the link through the accumulator's pinned slots and are counted by
``pileup_rows_kernel`` wave after wave, with no host synchronisation.
The counts then stay on the card: the shared tail (or a member's
extraction tail, over its slice of the device tensor) runs there, as a
serial K1 job's tail does, and only the tail's outputs are fetched.  The
reference takes its device scatter and fetches the combined counts; the
port's torch scatter is slower than K1's route on the card, and counts
are exact whichever route adds them, so the bytes do not depend on it.
On the CPU the reference's rule holds: the native host counts where the
library loads, else the scatter, and the tails read host counts.

**Composition policy** reads the signals the telemetry plane already
computes: a tenant burning an SLO objective
(``AdmissionController.slo_burn``) gets LATENCY (its job flushes the
batch at once), bulk tenants get THROUGHPUT (full slabs).  ``--batch
{off,auto,N}`` caps the members of a batch; ``S2C_BATCH_MAX_MEMBER_LEN``
and ``S2C_BATCH_MAX_LEN`` cap a member's and the batch's genome length.

**Eligibility**: ``--pileup auto|scatter`` only (an explicit host or
pallas pin is the user's placement decision, so such a job stays
serial), never ``--paranoid``, never incremental (a count-cache job seeds
its own accumulator), never a degraded tenant's pinned job, never an
explicitly checkpointed job.

**Failure discipline** (the count-bank rule): a member failing in its
own phase (decode, tail) fails alone; any fault in the packed phases
(merge, shared dispatch, the CPU's combined fetch) demotes the whole
batch — the shared tensor is discarded and every live member re-runs
through the serial path (``batch/demotions``); a crash mid-batch
replays only uncommitted members.  Every torch call of a batch runs on the batch's
thread (the runner's): the member decode pool stays on the host.

Every packed job's manifest carries the ``serve_batch`` ledger decision
and the ``serve/batch`` gauge; the server's registry the ``batch/*``
family.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import observability as obs
from ..observability import telemetry as stele
from . import packing

logger = logging.getLogger("sam2consensus_torch.serve.scheduler")

#: --batch auto: members per batch.  Eight is the committed bench
#: point (campaign serve_batch leg); override with S2C_BATCH_AUTO_JOBS.
DEFAULT_AUTO_JOBS = 8

#: default --batch-window: how long a filling batch may wait for more
#: eligible jobs before flushing (milliseconds).  Only meaningful for
#: live arrival streams; a pre-planned queue arrives all at once.
DEFAULT_WINDOW_MS = 50.0

#: a member packs only when its genome fits this many positions —
#: "small job" is a length statement (the oracle-noise-bound configs,
#: phix / target_capture class); big genomes keep the dedicated path
DEFAULT_MAX_MEMBER_LEN = 1 << 21
#: combined cap on the shared tensor (bounds the packed allocation)
DEFAULT_MAX_COMBINED_LEN = 1 << 23


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def parse_batch_mode(value) -> Tuple[str, int]:
    """``--batch {off,auto,N}`` -> ``(mode, max_jobs)``.

    ``off`` disables packing (max 1); ``auto`` packs up to the tuned
    default; an integer packs up to exactly N (N<=1 == off).  Raises
    ``ValueError`` on anything else — a typo'd batch policy must fail
    the server start, not silently serialize."""
    if value is None:
        return "off", 1
    v = str(value).strip().lower()
    if v in ("off", "0", ""):
        return "off", 1
    if v == "auto":
        return "auto", max(2, _env_int("S2C_BATCH_AUTO_JOBS",
                                       DEFAULT_AUTO_JOBS))
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"--batch {value!r}: use 'off', 'auto', or a job count")
    if n < 0:
        raise ValueError(f"--batch {value!r}: job count must be >= 0")
    return ("off", 1) if n <= 1 else ("fixed", n)


@dataclass
class Batch:
    """One composed batch: plan indices + why it flushed when it did."""

    indices: List[int] = field(default_factory=list)
    flush_reason: str = "drained"
    combined_len: int = 0


@dataclass
class _Member:
    """One member's execution state through the packed phases."""

    index: int
    entry: dict
    robs: object = None
    res: object = None
    layout: object = None
    contigs: object = None
    encoder: object = None
    batches: list = field(default_factory=list)
    cfg: object = None
    t0: float = 0.0
    failed: bool = False
    error: object = None
    pm: object = None           # this member's PackedMember slot
    ordinal: int = 0            # position within the batch's members
    #: decode-phase counter snapshot (phase/decode_sec, ingest/*,
    #: quarantine/*) — restored into rebuilt instruments when a
    #: shared-tail render fallback discards the originals
    decode_counters: dict = field(default_factory=dict)


class BatchScheduler:
    """Composes and executes packed batches for a ServeRunner."""

    def __init__(self, runner, batch="off", window_ms: Optional[float] = None):
        self.runner = runner
        self.mode, self.max_jobs = parse_batch_mode(batch)
        self.window_ms = DEFAULT_WINDOW_MS if window_ms is None \
            else float(window_ms)
        self.max_member_len = _env_int("S2C_BATCH_MAX_MEMBER_LEN",
                                       DEFAULT_MAX_MEMBER_LEN)
        self.max_combined_len = _env_int("S2C_BATCH_MAX_LEN",
                                         DEFAULT_MAX_COMBINED_LEN)
        self.batches_run = 0
        #: self-calibrating prediction rate (shared-phase seconds per
        #: input byte, EMA over finished batches) — the serve_batch
        #: ledger decision predicts from it; None until the first batch
        #: (which additionally bills the first-compile term)
        self._rate: Optional[float] = None
        #: shared-reference layout dedup (serve/packing.PanelGeometry):
        #: (header fingerprint, panel_len) -> the ONE canonical offset
        #: table a same-panel batch reuses.  The ``batch/panel_plans`` /
        #: ``batch/panel_reuses`` counters count the builds and hits.
        self._panel_geoms: Dict[Tuple[str, int],
                                packing.PanelGeometry] = {}
        #: cohort prefetch hand-off (serve/cohort.py): filename ->
        #: probe fields (total_len/handle/bytes/fingerprint) computed
        #: on the prefetch thread while the PREVIOUS wave dispatches —
        #: ``_probe_total_len`` consumes an entry instead of re-opening
        #: and re-sniffing the container on the critical path.
        self.probe_cache: Dict[str, dict] = {}
        #: the decode-ahead gate :meth:`run_batch` sets at its first
        #: shared dispatch
        self._gate = None

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    # -- eligibility -------------------------------------------------------
    def _probe_total_len(self, entry: dict) -> Optional[int]:
        """The job's genome length from its header (cached on the
        entry); None = unreadable here, which just means "not packable"
        — the serial path will surface the real error properly.  The
        OPEN handle is kept on the entry (``batch_handle``): each
        member's header parses exactly once — the decode phase resumes
        from it instead of re-opening and re-sniffing the container."""
        if "batch_total_len" in entry:
            return entry["batch_total_len"]
        pre = self.probe_cache.pop(entry["spec"].filename, None) \
            if self.probe_cache else None
        if pre is not None:
            entry.update(pre)
            return entry["batch_total_len"]
        total = None
        try:
            from ..config import resolve_decode_threads
            from ..encoder.events import GenomeLayout
            from ..formats import open_alignment_input

            ai = open_alignment_input(
                entry["spec"].filename,
                getattr(entry["cfg"], "input_format", "auto"),
                threads=resolve_decode_threads(entry["cfg"]))
            total = GenomeLayout(ai.contigs).total_len
            entry["batch_handle"] = ai
            # the fingerprint is free here (the contigs are parsed) and
            # is what lets run_batch reuse a same-panel offset table
            entry["batch_ref_fp"] = packing.reference_fingerprint(
                ai.contigs)
            try:
                entry["batch_bytes"] = os.path.getsize(
                    entry["spec"].filename)
            except OSError:
                pass
        except Exception:
            total = None
        entry["batch_total_len"] = total
        return total

    def release_handles(self, plan: List[dict]) -> None:
        """Close probe handles whose entries did not end up packed
        (runner calls this after composition so demoted/ineligible
        entries never leak an open file)."""
        for entry in plan:
            ai = entry.pop("batch_handle", None)
            if ai is not None:
                ai.close()

    def eligible(self, entry: dict) -> bool:
        """Static (config-level) packability; size is checked during
        composition so the header probe runs once per candidate."""
        if entry["action"] != "run":
            return False
        cfg = entry["cfg"]
        if getattr(cfg, "pileup", "auto") not in ("auto", "scatter"):
            return False
        if getattr(cfg, "paranoid", False):
            return False
        if getattr(cfg, "incremental", False):
            return False        # incremental consensus (count cache):
            # the job's accumulator seeds from warm per-reference
            # state — packing it into a shared tensor would merge
            # co-tenants' counts into its combined output
        if getattr(cfg, "checkpoint_dir", None) and self.runner.journal \
                is None:
            return False            # explicit checkpoint job (serve
            # rejects these anyway; journal-injected homes are fine —
            # packed members replay whole)
        tenant = entry["spec"].tenant
        if tenant and self.runner.admission.pin_rung(tenant) is not None:
            return False            # pinned = off the device path
        return True

    def _burning(self, tenant: str) -> bool:
        # windowed read when the runner attached a burn monitor: a
        # tenant whose last breach aged out of the slow window stops
        # pre-empting batch fills (the lifetime dict would flush-on-
        # burn forever after a single historical breach)
        adm = self.runner.admission
        slo_burn = getattr(adm, "slo_burn", None)
        burn = slo_burn() if callable(slo_burn) \
            else getattr(adm, "slo_burn_by_tenant", {})
        return bool(burn.get(tenant or "", 0))

    def compose(self, plan: List[dict],
                arrivals: Optional[List[float]] = None) -> List[Batch]:
        """Group the plan's eligible entries into batches, in order.

        ``arrivals`` (one monotonic timestamp per plan entry) models a
        live queue: an entry may join the filling batch only when it
        arrived within ``window_ms`` of the batch's first member —
        later arrivals start the next batch.  A pre-planned
        ``submit_jobs`` queue passes None (everything arrived "now").

        A batch flushes (``flush_reason``) when it is ``full`` (max
        jobs), ``len_cap`` (combined genome cap), ``window`` (an
        arrival fell outside the window), ``slo_burn`` (a member's
        tenant is burning its SLO objective — latency beats occupancy:
        the batch ships NOW rather than waiting to fill), or
        ``drained`` (no more eligible entries).  Single-member batches
        are dropped — the serial path IS a batch of one.
        """
        out: List[Batch] = []
        cur = Batch()
        cur_t0: Optional[float] = None

        def flush(reason: str) -> None:
            nonlocal cur, cur_t0
            if cur.indices:
                cur.flush_reason = reason
                out.append(cur)
            cur = Batch()
            cur_t0 = None

        for i, entry in enumerate(plan):
            if not self.eligible(entry):
                continue
            total = self._probe_total_len(entry)
            if total is None or total <= 0 \
                    or total > self.max_member_len:
                continue
            t = arrivals[i] if arrivals is not None else 0.0
            if cur.indices and arrivals is not None \
                    and (t - cur_t0) * 1e3 > self.window_ms:
                flush("window")
            if cur.indices \
                    and cur.combined_len + total > self.max_combined_len:
                flush("len_cap")
            if not cur.indices:
                cur_t0 = t
            cur.indices.append(i)
            cur.combined_len += total
            if self._burning(entry["spec"].tenant):
                # latency for the burning tenant: ship the batch as-is,
                # never hold its job hostage to occupancy or the window
                flush("slo_burn")
            elif len(cur.indices) >= self.max_jobs:
                flush("full")
        flush("drained")
        return [b for b in out if len(b.indices) >= 2]

    # -- execution ---------------------------------------------------------
    def run_batch(self, batch: Batch, plan: List[dict], window_t0: float,
                  gate=None) -> Tuple[Dict[int, object], List[int]]:
        """Execute one composed batch.

        Returns ``(finished, leftovers)``: ``finished`` maps plan index
        -> finalized JobResult (success, per-member failure, or
        decode-time failure); ``leftovers`` are indices that must
        re-run through the serial path because the packed phases
        demoted (``serve/batch_demotions``).  The runner's loop treats
        leftovers exactly like never-batched entries.  ``gate`` (the
        next serial job's decode-ahead gate, or None) is set at the
        batch's first shared dispatch."""
        self._gate = gate
        runner = self.runner
        finished: Dict[int, object] = {}
        members: List[_Member] = []
        for i in batch.indices:
            entry = plan[i]
            tenant = entry["spec"].tenant
            if tenant and runner.admission.pin_rung(tenant) is not None:
                # the tenant was degraded AFTER composition (an earlier
                # job of this very queue): honor the pin — serial path
                return self._demote_all(members, finished,
                                        batch.indices, "tenant_pinned")
            members.append(_Member(index=i, entry=entry))
        t_batch0 = time.perf_counter()
        queue_wait = max(0.0, t_batch0 - window_t0)
        first_batch = self.batches_run == 0
        bid = f"batch{self.batches_run}"
        runner.health.job_started(
            f"{bid}[{len(members)}:"
            f"{os.path.basename(members[0].entry['spec'].filename)}+]")
        for m in members:
            runner._journal_append(
                "started", job=m.entry["job_id"], key=m.entry["key"],
                ckpt="", packed=bid)
            # flight recorder: the journal-measured queue wait counts
            # to HERE (batch members start together)
            m.entry["started_unix"] = round(time.time(), 3)
        # admitted accounting happens where a job actually executes:
        # the serial loop counts its own entries, so packed members
        # count here (and are un-counted on a demotion hand-back — the
        # serial path will re-count them)
        runner.registry.add("serve/admission_admitted", len(members))

        # -- phases 1-3: decode ∥ pack ∥ dispatch, overlapped in waves.
        #    The pack plan's offset table comes from the compose-time
        #    header probes, so the shared accumulator exists BEFORE any
        #    member decodes; members decode concurrently on a small
        #    pool (the C text decoder releases the GIL) with their own
        #    instruments thread-bound, and whichever members have
        #    finished get their rows remapped + merged into shared
        #    slabs and dispatched WHILE the rest still decode — the
        #    packed path's own decode/dispatch pipeline, the cross-JOB
        #    analogue of the serial path's prefetcher.  Failure
        #    bookkeeping (journal, admission, fold) is deferred to THIS
        #    thread — those surfaces are not concurrent-safe.
        plan_pk = self._plan_members(members)
        for j, (m, pm) in enumerate(zip(members, plan_pk.members)):
            m.pm = pm
            m.ordinal = j
            m.cfg = dataclasses.replace(m.entry["cfg"],
                                        checkpoint_dir=None)
        batch_robs = obs.prepare_run(config=None)
        dlog: List[Tuple[float, float]] = []
        acc = counts = None
        bytes_total = sum(m.entry.get("batch_bytes") or 0
                          for m in members)
        predicted_wall = self._predict_wall(len(members), bytes_total,
                                            self._accum_host_rung())
        spec0 = getattr(members[0].cfg, "fault_inject", "") or None
        workers = max(1, min(len(members),
                             _env_int("S2C_BATCH_DECODE_WORKERS",
                                      os.cpu_count() or 1)))
        try:
            acc, strategy = self._shared_accumulator(plan_pk.total_len,
                                                     batch_robs)
            # wave size: how many decoded members accumulate before a
            # merged dispatch.  On the CPU the default is the whole batch
            # (the native accumulation already uses every core, so
            # overlapping decode with it just contends); on the card,
            # waves of ~2x the decode workers pipeline member decode
            # under the enqueued K1 launches.
            wave_min = _env_int("S2C_BATCH_WAVE_MIN", 0)
            if wave_min <= 0:
                wave_min = len(members) if self._link_free \
                    else max(2, workers)
            if workers > 1:
                from concurrent.futures import (FIRST_COMPLETED,
                                                ThreadPoolExecutor)
                from concurrent.futures import wait as _fwait

                with ThreadPoolExecutor(
                        max_workers=workers,
                        thread_name_prefix="serve-batch-decode") as ex:
                    futs = {ex.submit(self._decode_member, m, workers): m
                            for m in members}
                    pending: List[_Member] = []
                    while futs:
                        done, _ = _fwait(set(futs),
                                         return_when=FIRST_COMPLETED)
                        pending.extend(futs.pop(f) for f in done)
                        if len(pending) >= wave_min or not futs:
                            self._dispatch_wave(pending, plan_pk, acc,
                                                batch_robs, dlog,
                                                spec0)
                            pending = []
            else:
                for m in members:
                    self._decode_member(m)
                self._dispatch_wave(members, plan_pk, acc, batch_robs,
                                    dlog, spec0)
            if self._link_free:
                # the CPU routes: ONE combined host fetch for the whole
                # batch, as the reference's.  On the card the counts stay
                # there for the tails, with no synchronisation here
                with obs.bind_run_to_thread(batch_robs):
                    counts = acc.counts_host()
        except BaseException as exc:
            # the count-bank rule: a dispatch that did not complete
            # merges nothing — discard the shared tensor, demote every
            # live member to the serial path untouched
            logger.warning(
                "%s: packed dispatch failed (%s: %s) — demoting "
                "member(s) to the serial path", bid,
                type(exc).__name__, exc)
            runner.registry.add("batch/demotions", 1)
            runner.registry.gauge("serve/batch").set_info(
                {"batch": bid, "demoted": True,
                 "error": f"{type(exc).__name__}: {exc}"})
            for m in members:
                self._close_member(m)
            runner.health.job_finished()
            # every member (decode-failed ones included — they are not
            # in `finished`) re-runs through the serial loop, which
            # re-counts admission for the entries it executes
            runner.registry.add("serve/admission_admitted",
                                -len(members))
            return finished, [m.index for m in members
                              if not m.failed]
        for m in members:
            if m.failed:
                runner._note_poison(m.entry["spec"], m.error, m.res)
                m.res.error = f"{type(m.error).__name__}: {m.error}"
                runner._finalize_job(m.entry, m.res, m.robs,
                                     m.entry["spec"],
                                     queue_wait=queue_wait,
                                     echo_suffix=" [packed decode]")
        live = [m for m in members if not m.failed]
        if live and any(m.failed for m in members):
            # the failed members' finalize cleared in_flight; the live
            # remainder is still executing
            runner.health.job_started(f"{bid}[{len(live)} live]")
        tap = getattr(runner, "count_tap", None)
        if tap is not None:
            # cohort concordance feed (serve/cohort.py): each live
            # member's private partition — on the CPU sliced from the
            # combined fetch, on the card its slice of the shared device
            # counts (the extraction tail's), read on this thread's
            # stream behind the batch's K1 launches with no host
            # synchronisation.  Absorbed on failure: the tap is an
            # observer, never a reason a job fails.
            for m in live:
                try:
                    part = packing.extract_member(counts, m.pm) \
                        if counts is not None else \
                        acc.counts[m.pm.offset:m.pm.offset + m.pm.total_len]
                    tap(m.entry["job_id"], part)
                except Exception:
                    runner.registry.add("batch/tap_failed", 1)
        total_events = sum(mm.n_events for mm in plan_pk.members) or 1
        dispatch_sec = sum(t1 - t0 for t0, t1 in dlog)
        shared_wall = time.perf_counter() - t_batch0
        self._note_rate(shared_wall, bytes_total, len(members))
        # batch-scope counters -> server aggregate.  The dispatch
        # seconds are share-billed to the members below and reach the
        # aggregate through THEIR folds; zero the batch copy first or
        # the fleet's s2c_phase_seconds_total{phase="pileup_dispatch"}
        # would double-count every packed batch
        batch_robs.registry.add("phase/pileup_dispatch_sec",
                                -dispatch_sec)
        try:
            runner.registry.fold(batch_robs.registry, job_id=bid)
        except Exception:
            runner.registry.add("telemetry/fold_failed", 1)

        # -- server-lifetime batch gauges (the serve/batch family) -----
        n = len(live)
        reg = runner.registry
        reg.add("batch/batches", 1)
        reg.add("batch/packed_jobs", n)
        reg.add("batch/pack_sec", max(0.0, shared_wall - dispatch_sec))
        reg.gauge("batch/size").set(float(n))
        reg.gauge("batch/occupancy_pct").set(
            round(100.0 * plan_pk.occupancy, 2))
        # raw merge accounting: the cohort wave sizer reads real_rows to
        # learn rows-per-member, which its occupancy-aware wave sizing
        # snaps against pow2 pad boundaries (serve/cohort.py size_wave)
        reg.gauge("batch/real_rows").set(float(plan_pk.real_rows))
        reg.gauge("batch/padded_rows").set(float(plan_pk.padded_rows))
        reg.gauge("batch/jobs_per_sec").set(
            round(n / shared_wall, 3) if shared_wall > 0 else 0.0)
        binfo = {"batch": bid, "jobs": n,
                 "flush_reason": batch.flush_reason,
                 "occupancy": round(plan_pk.occupancy, 4),
                 "merged_slabs": plan_pk.merged_slabs,
                 "events": int(total_events),
                 "shared_wall_sec": round(shared_wall, 4),
                 "dispatch_sec": round(dispatch_sec, 4),
                 "strategy": strategy}
        reg.gauge("serve/batch").set_info(binfo)
        self.batches_run += 1

        # -- phase 4: the tail.  One SHARED tail over the combined
        #    tensor when every member votes under the same knobs
        #    (thresholds + min_depth — the only config the tail math
        #    reads; everything else is encode-time or render-time):
        #    the vote is per-position and insertion sites are keyed
        #    (contig, local), so each member's slice of the combined
        #    outputs is bit-for-bit its own tail's outputs.  Members
        #    with incompatible knobs, or any shared-tail failure, take
        #    the per-member extraction tail (run_from_counts) instead —
        #    same bytes either way, different amortization.  On the card
        #    both read the shared device counts (``counts`` is None).
        shared = None
        if len(live) > 1 and self._tail_compatible(live) \
                and os.environ.get("S2C_BATCH_SHARED_TAIL", "1") != "0":
            try:
                shared = self._shared_tail(members, live, plan_pk, acc,
                                           counts, batch_robs)
            except Exception as exc:
                runner.registry.add("batch/tail_demotions", 1)
                logger.warning(
                    "%s: shared tail failed (%s: %s) — per-member "
                    "extraction tails", bid, type(exc).__name__, exc)
        for m in live:
            pm = m.pm
            share = dispatch_sec * (pm.n_events / total_events)

            def bill(m=m, pm=pm, share=share):
                """Member batch accounting into the member's CURRENT
                instruments: the serve/batch counter family (the ledger
                decision's measured join reads them) plus the decision
                itself.  Re-applied when a shared-tail render fallback
                rebuilds the member's instruments."""
                r = m.robs.registry
                r.add("phase/pileup_dispatch_sec", share)
                r.add("serve/batched", 1)
                r.add("serve/batch_jobs", n)
                r.add("serve/batch_wall_sec", shared_wall)
                r.add("serve/batch_share_sec", share)
                r.gauge("serve/batch").set_info(
                    {**binfo, "share_sec": round(share, 4),
                     "events": pm.n_events})
                # rate-card cross-check (observability/ratecard.py):
                # the learned packed-jobs rate rides the inputs as
                # provenance — the scheduler's own shared-phase EMA
                # stays the prediction (it models THIS batch's shape;
                # the card models the fleet-visible average)
                from ..observability import ratecard as _rc

                _jps_rc, _jps_prov = _rc.consult(
                    "packed_jobs_per_sec", n / predicted_wall)
                with obs.bind_run_to_thread(m.robs):
                    obs.record_decision(
                        "serve_batch", str(n),
                        inputs={"mode": self.mode,
                                "flush_reason": batch.flush_reason,
                                "window_ms": self.window_ms,
                                "jobs": n,
                                "occupancy": round(plan_pk.occupancy,
                                                   4),
                                "events": int(total_events),
                                "predicted_jobs_per_sec": round(
                                    n / predicted_wall, 3)},
                        provenance=_jps_prov,
                        predicted={"sec": predicted_wall,
                                   "jobs_per_sec": n / predicted_wall},
                        measured={"sec": {"counters":
                                          ["serve/batch_wall_sec"]},
                                  "jobs_per_sec": {
                                      "num": ["serve/batch_jobs"],
                                      "den": ["serve/batch_wall_sec"]}},
                        # the server's first batch absorbs an
                        # unknowable share of process cold start:
                        # residual recorded, drift never fired on it
                        # (the shard_mode precedent); warm batches are
                        # band-enforced
                        band=0 if first_batch else None)

            bill()
            done_shared = False
            if shared is not None:
                done_shared = self._render_member(m, shared, t_batch0,
                                                  rebill=bill)
            if not done_shared:
                part = packing.extract_member(counts, pm) \
                    if counts is not None \
                    else acc.counts[pm.offset:pm.offset + pm.total_len]
                self._tail_member(m, part, pm, t_batch0)
            runner._finalize_job(
                m.entry, m.res, m.robs, m.entry["spec"],
                queue_wait=queue_wait,
                echo_suffix=f" [packed x{n}, {bid}]")
            finished[m.index] = m.res
            if m is not live[-1]:
                # _finalize_job cleared in_flight for ITS member; the
                # batch is still executing — re-assert so a tail that
                # wedges mid-batch stays visible to the health
                # snapshot/watchdog gauges (the PR-10 contract)
                runner.health.job_started(f"{bid}[{n - len(finished)}"
                                          f" remaining]")
        for m in members:
            if m.failed and m.index not in finished:
                finished[m.index] = m.res
        runner.health.job_finished()
        return finished, []

    def _plan_members(self, members: List[_Member]) -> packing.PackPlan:
        """Offset-plan a batch, deduplicating shared-reference layouts.

        When every member declares the same header fingerprint (hence
        the same panel length), the batch takes its offsets from the
        cached :class:`~.packing.PanelGeometry` table — planned once
        per (fingerprint, panel_len) and reused verbatim by every
        later same-panel batch/wave.  ``batch/panel_plans`` counts the
        builds and ``batch/panel_reuses`` the table hits: the cohort
        bench's zero-re-plans-after-wave-1 evidence.  Mixed-stranger
        batches keep the per-batch ``plan_pack`` path unchanged."""
        fps = {m.entry.get("batch_ref_fp") for m in members}
        lens = {m.entry["batch_total_len"] for m in members}
        if len(fps) == 1 and None not in fps and len(lens) == 1:
            key = (next(iter(fps)), int(next(iter(lens))))
            geom = self._panel_geoms.get(key)
            if geom is None or geom.max_jobs < len(members):
                geom = packing.PanelGeometry(
                    fingerprint=key[0], panel_len=key[1],
                    max_jobs=max(len(members), self.max_jobs))
                self._panel_geoms[key] = geom
                self.runner.registry.add("batch/panel_plans", 1)
            else:
                self.runner.registry.add("batch/panel_reuses", 1)
            return geom.plan_wave([m.entry["job_id"] for m in members])
        return packing.plan_pack(
            [(m.entry["job_id"], m.entry["batch_total_len"])
             for m in members])

    # -- phases ------------------------------------------------------------
    def _decode_member(self, m: _Member, sharers: int = 1) -> None:
        """Decode one member fully (bounded: members passed the size
        gate), instruments thread-bound so phase seconds, quarantine
        counters and strict errors all land in the member's own job.
        ``m.cfg`` was prepared by the caller with ``checkpoint_dir``
        stripped — packed members replay whole on a crash: the
        journal-injected per-job checkpoint home stays empty (serial
        decode with stream-consistent snapshots is the checkpoint
        contract, and the members are small by the eligibility gate).
        ``sharers``: the pool's workers, among which a member's
        host-sized decode workers divide the server's CPUs."""
        from ..backends.base import BackendStats
        from ..config import resolve_decode_threads
        from ..encoder.events import GenomeLayout
        from ..formats import open_alignment_input
        from ..ingest.badrecords import (BadRecordBudgetExceeded,
                                         abort_bookkeeping)
        from .runner import JobResult

        runner = self.runner
        entry = m.entry
        spec = entry["spec"]
        m.robs = obs.prepare_run(
            trace_out=runner._job_out(m.cfg.trace_out, "S2C_TRACE_OUT",
                                      entry["jobnum"]),
            metrics_out=runner._job_out(m.cfg.metrics_out,
                                        "S2C_METRICS_OUT",
                                        entry["jobnum"]),
            config=m.cfg)
        runner._stamp_trace(m.robs, entry)
        m.res = JobResult(job_id=entry["job_id"], filename=spec.filename,
                          index=m.index, admission=entry["admission"])
        m.t0 = time.perf_counter()
        handle = None
        with obs.bind_run_to_thread(m.robs):
            stele.set_log_context(job_id=entry["job_id"],
                                  tenant=spec.tenant, rung="packed")
            reg = obs.metrics()
            tr = obs.tracer()
            try:
                # the compose probe already opened + header-parsed this
                # input; resume from that handle instead of re-opening
                handle = entry.pop("batch_handle", None)
                if handle is None:
                    handle = open_alignment_input(
                        spec.filename,
                        getattr(m.cfg, "input_format", "auto"),
                        threads=resolve_decode_threads(m.cfg))
                m.contigs = handle.contigs
                m.layout = GenomeLayout(m.contigs)
                # acc=None: never the fused host count (the member's
                # rows go to the shared accumulator), and no torch call
                encoder, gen = runner.backend._make_encoder(
                    m.layout, handle.stream, m.cfg, BackendStats(), None,
                    sharers)
                m.encoder = encoder
                # decode clock starts AFTER open/encoder construction,
                # mirroring the serial path's _timed_iter discipline —
                # one-time costs (native library load, pool spin-up)
                # must not pollute the decode_threads ledger join
                td = time.perf_counter()
                with tr.span("decode"):
                    for batch in gen:
                        m.batches.append(batch)
                reg.add("phase/decode_sec", time.perf_counter() - td)
                rec = obs.ledger().get("decode_threads")
                if rec is not None:
                    # pool-concurrent member decode: the wall includes
                    # co-members' core contention, which the single-job
                    # thread model does not price — keep the residual
                    # in the manifest, never fire drift on it (band=0,
                    # the shard_mode precedent)
                    rec.band = 0
                bad_sink = getattr(encoder, "bad_sink", None)
                if bad_sink is not None:
                    total = int(getattr(handle.stream, "n_lines", 0) or 0)
                    if total <= 0:
                        total = encoder.n_reads + encoder.n_skipped
                    bad_sink.finish(total)
                    bad_sink.publish(reg)
                m.decode_counters = dict(
                    m.robs.registry.snapshot()["counters"])
            except BaseException as exc:
                if isinstance(exc, BadRecordBudgetExceeded):
                    abort_bookkeeping(exc, reg)
                m.failed = True
                m.error = exc       # finalized on the batch thread —
                # journal/admission/fold are not concurrent-safe
                m.res.elapsed_sec = time.perf_counter() - m.t0
            finally:
                if handle is not None:
                    handle.close()
                stele.set_log_context()

    def _accum_host_rung(self) -> bool:
        """True when the shared accumulation will route host-side (the
        CPU device with the native library — see
        :meth:`_shared_accumulator`): no kernel build to bill then."""
        from .. import native

        return self.runner.backend.device.type == "cpu" \
            and native.load() is not None

    def _shared_accumulator(self, total_len: int, batch_robs):
        """The batch's shared accumulator and its strategy name.

        On the card, K1's: ``PileupAccumulator(..., "pallas",
        "packed5")``, the merged slabs staged through its pinned slots
        and counted by ``pileup_rows_kernel`` with no host
        synchronisation; the tails read its counts there.  On the CPU
        (no link to amortize) the reference's placement: the native host
        counts where the library loads, else the scatter.  Counts are exact on
        every route, so the bytes do not depend on the choice."""
        from ..ops.pileup import HostPileupAccumulator, PileupAccumulator

        device = self.runner.backend.device
        self._link_free = device.type == "cpu"
        if self._accum_host_rung():
            strategy = "host"
        else:
            strategy = "scatter" if self._link_free else "pallas"
        with obs.bind_run_to_thread(batch_robs):
            acc = HostPileupAccumulator(total_len) if strategy == "host" \
                else PileupAccumulator(total_len, device, strategy,
                                       "packed5")
            batch_robs.registry.gauge("dispatch/pileup").set_info(
                {"path": "packed_shared", "strategy": strategy,
                 "total_len": int(total_len)})
        return acc, strategy

    def _predict_wall(self, n_members: int, bytes_total: int,
                      host_rung: bool) -> float:
        """The shared-phase wall the ledger decision predicts, at the
        moment the POLICY decides to pack: per-member fixed overhead +
        input bytes at the scheduler's self-calibrating rate (EMA over
        previous WARM batches' measured shared wall per byte, seeded by
        S2C_BATCH_SEC_PER_MB — the committed cpu-fallback artifact's
        rig measures ~0.1 s/MB; accelerator rigs tune via env).  The
        server's FIRST batch additionally bills a cold-start term
        (S2C_BATCH_COMPILE_SEC: first jit compiles on the device rung,
        native-library/first-touch warmup on the host rung) — and is
        recorded band=0 (informational), because how much of the
        process's cold start lands in it depends on what ran before."""
        fixed = float(os.environ.get("S2C_BATCH_MEMBER_SEC", "0.002"))
        seed_rate = float(os.environ.get("S2C_BATCH_SEC_PER_MB",
                                         "0.1")) / 1e6
        compile_sec = float(os.environ.get("S2C_BATCH_COMPILE_SEC",
                                           "0.5"))
        rate = self._rate if self._rate is not None else seed_rate
        pred = n_members * fixed + max(1, bytes_total) * rate
        if self.batches_run == 0:
            pred += compile_sec
        return pred

    def _note_rate(self, shared_wall: float, bytes_total: int,
                   n_members: int) -> None:
        """Fold one WARM batch's measured shared wall into the
        prediction rate.  The server's first batch is never folded —
        its wall carries an unknowable share of process cold start
        (first compiles, library loads, page cache), and seeding the
        EMA with it mis-prices every batch that follows.  The
        observation subtracts the per-member fixed term the prediction
        adds back, so the model cannot double-count it."""
        if self.batches_run == 0:
            return
        fixed = float(os.environ.get("S2C_BATCH_MEMBER_SEC", "0.002"))
        wall = shared_wall - n_members * fixed
        obs_rate = max(1e-12, wall) / max(1, bytes_total)
        self._rate = obs_rate if self._rate is None \
            else 0.6 * self._rate + 0.4 * obs_rate

    def _dispatch_wave(self, wave: List[_Member],
                       plan_pk: packing.PackPlan, acc, batch_robs,
                       dlog: List[Tuple[float, float]],
                       fault_spec) -> None:
        """Merge + dispatch the rows of whichever members just finished
        decoding — runs on the batch thread while other members still
        decode on the pool.  Dispatch cost lands in the batch-scope
        registry (folded into the server aggregate at batch end) and is
        share-billed to members by event count afterwards.  Any failure
        propagates to the caller's demotion path — nothing partial is
        ever handed to a member."""
        from ..resilience import faultinject

        runner = self.runner
        pairs = []
        for m in wave:
            if m.failed:
                continue
            if m.layout.total_len != m.pm.total_len:
                # the input's header changed between the compose probe
                # and the decode: this member's offsets are wrong — it
                # fails alone, its rows never reach the shared tensor
                m.failed = True
                m.error = RuntimeError(
                    "reference layout changed between admission and "
                    f"decode ({m.pm.total_len} -> "
                    f"{m.layout.total_len} positions)")
                continue
            pairs.append((m.pm, m.batches))
        if not pairs:
            return
        from ..ops.pileup import HostPileupAccumulator

        host_rung = isinstance(acc, HostPileupAccumulator)
        with obs.bind_run_to_thread(batch_robs):
            faultinject.configure(fault_spec)
            try:
                tr = obs.tracer()
                reg = obs.metrics()
                merged = packing.merge_batches(plan_pk, pairs)
                # residency: the combined tensors pin every member's
                # rows until the wave dispatches
                # (observability/memplane.py packed_batch family)
                from ..observability import memplane

                for mb in merged:
                    memplane.track_obj("packed_batch", mb,
                                       memplane.batch_nbytes(mb))
                for m in wave:
                    m.batches = []          # rows now live in the slabs
                if self._gate is not None:
                    # the next serial job's decode-ahead starts behind
                    # the batch's first shared dispatch
                    self._gate.set()
                    self._gate = None
                for mb in merged:
                    ta = time.perf_counter()
                    with tr.span("pileup_dispatch",
                                 n_events=mb.n_events):
                        if host_rung:
                            # the device accumulator checks this site
                            # itself; the host rung must stay
                            # injectable too (the demote-on-fault
                            # contract is rung-independent)
                            faultinject.fault_check("pileup_dispatch")
                        acc.add(mb)
                    tb = time.perf_counter()
                    reg.add("phase/pileup_dispatch_sec", tb - ta)
                    dlog.append((ta, tb))
                    runner.health.beat()
                    runner.telemetry_tick()
            finally:
                faultinject.configure("")

    @staticmethod
    def _tail_compatible(live: List[_Member]) -> bool:
        """True when every member's tail math reads the same knobs.
        ``thresholds`` and ``min_depth`` enter the vote, and ``fill``
        now enters the TAIL too (the device-resident epilogue
        substitutes the fill byte inside the vote's emit select —
        ``TorchBackend._device_tail``); maxdel / strict / py2-compat act at
        encode time (already per-member) and prefix / nchar at render
        time (per-member too).  Members with a different fill take the
        per-member extraction tail — same bytes, less amortization."""
        key = (tuple(live[0].cfg.thresholds), live[0].cfg.min_depth,
               live[0].cfg.fill)
        return all((tuple(m.cfg.thresholds), m.cfg.min_depth,
                    m.cfg.fill) == key for m in live)

    def _shared_tail(self, members: List[_Member], live: List[_Member],
                     plan_pk: packing.PackPlan, shared_acc, counts,
                     batch_robs) -> dict:
        """ONE post-accumulation tail over the whole packed batch.

        Builds a combined layout (member contigs under collision-proof
        ``b<k>::`` names — serving queues routinely carry the same
        reference in every job; a failed member's window keeps a
        placeholder contig so the offset table stays exactly the pack
        plan's), merges the members' insertion events with contig ids
        rebased into the combined index space, and runs the backend's
        ordinary ``_tail`` over the combined counts under the members'
        (shared) vote knobs: on the card over ``shared_acc`` itself (the
        tail stays there, as a serial K1 job's does), on the CPU over the
        fetched ``counts``.  Returns the combined outputs plus the
        per-ordinal contig bases ``base_ci`` the slicer uses.  Exact by
        construction: the vote is per-position, site keys are (contig,
        local), and per-contig sums follow contig boundaries — nothing
        in the tail mixes positions across member windows."""
        from ..backends.base import BackendStats
        from ..encoder.events import GenomeLayout, InsertionEvents
        from ..io.sam import Contig
        from ..ops.pileup import HostPileupAccumulator
        from ..resilience.policy import RetryPolicy

        comb_contigs: List[Contig] = []
        base_ci = [0]
        ins_comb = InsertionEvents()
        for k, m in enumerate(members):
            bias = base_ci[-1]
            if m.failed or m.layout is None:
                # zero-count placeholder window: pruned at render, but
                # it keeps every later member's offset/contig base true
                comb_contigs.append(Contig(name=f"b{k}::__failed__",
                                           length=int(m.pm.total_len)))
                base_ci.append(bias + 1)
                continue
            for name, length in zip(m.layout.names, m.layout.lengths):
                comb_contigs.append(Contig(name=f"b{k}::{name}",
                                           length=int(length)))
            base_ci.append(bias + len(m.layout.names))
            ev = m.encoder.insertions
            if len(ev):
                ins_comb.contig_ids.extend(c + bias
                                           for c in ev.contig_ids)
                ins_comb.local_pos.extend(ev.local_pos)
                ins_comb.motifs.extend(ev.motifs)
                for c, loc, ml, ch in ev.array_chunks:
                    ins_comb.array_chunks.append((c + bias, loc, ml, ch))
        comb_layout = GenomeLayout(comb_contigs)
        if comb_layout.total_len != plan_pk.total_len:
            raise RuntimeError(
                "combined layout length diverged from the pack plan "
                f"({comb_layout.total_len} != {plan_pk.total_len})")
        if counts is None:
            acc = shared_acc
        else:
            acc = HostPileupAccumulator(comb_layout.total_len)
            acc.set_counts(counts)

        carrier = SimpleNamespace(insertions=ins_comb)
        stats = BackendStats()
        stats.aligned_bases = sum(m.n_events for m in plan_pk.members)
        cfg0 = live[0].cfg
        backend = self.runner.backend
        policy = RetryPolicy.from_config(cfg0)
        t0 = time.perf_counter()
        with obs.bind_run_to_thread(batch_robs):
            (syms, ins_syms, contig_sums, site_cov, ins,
             dash_counts) = policy.run(
                lambda: backend._tail(acc, cfg0, comb_layout, carrier,
                                      stats),
                site="tail")
        return {
            "syms": np.asarray(syms),
            "ins_syms": None if ins_syms is None else
            np.asarray(ins_syms),
            "contig_sums": np.asarray(contig_sums),
            "site_cov": None if site_cov is None else
            np.asarray(site_cov),
            "ins": ins,
            # device-resident epilogue: per-(T, comb-contig) dash
            # totals slice per member exactly like contig_sums
            "dash_counts": None if dash_counts is None else
            np.asarray(dash_counts),
            "base_ci": base_ci,
            "total_len": comb_layout.total_len,
            "tail_sec": time.perf_counter() - t0,
            "placement": stats.extra.get("tail_placement", {}).get(
                "chosen"),
        }

    def _render_member(self, m: _Member, shared: dict,
                       t_batch0: float, rebill=None) -> bool:
        """Render one member from its slice of the shared tail outputs;
        returns False (caller falls back to the extraction tail) when
        the render fails for a reason worth retrying per-member."""
        runner = self.runner
        pm = m.pm
        off = pm.offset
        L = m.layout.total_len
        lo_ci = shared["base_ci"][m.ordinal]
        hi_ci = shared["base_ci"][m.ordinal + 1]
        syms_k = shared["syms"][:, off:off + L]
        contig_sums_k = shared["contig_sums"][lo_ci:hi_ci]
        dash_k = None if shared.get("dash_counts") is None \
            else shared["dash_counts"][:, lo_ci:hi_ci]
        ins = shared["ins"]
        ins_k = ins_syms_k = site_cov_k = None
        if ins is not None:
            kc = ins["key_contig"]
            lo = int(np.searchsorted(kc, lo_ci))
            hi = int(np.searchsorted(kc, hi_ci))
            if lo != hi:
                # key_contig is sorted by construction
                # (group_insertions), so a member's sites are one
                # contiguous row range; rebase contig ids into the
                # member's own index space
                ins_k = {"key_contig": (kc[lo:hi] - lo_ci),
                         "key_local": ins["key_local"][lo:hi]}
                ins_syms_k = shared["ins_syms"][:, lo:hi, :]
                site_cov_k = shared["site_cov"][lo:hi]
        # the member's share of the shared tail, into ITS vote phase
        m.robs.registry.add(
            "phase/vote_sec", shared["tail_sec"]
            * (L / max(1, shared["total_len"])))
        stele.set_log_context(job_id=m.entry["job_id"],
                              tenant=m.entry["spec"].tenant,
                              rung="packed")
        runner.backend.serve_prepared_obs = m.robs
        try:
            out = runner.backend.assemble_partition(
                m.contigs, m.cfg, syms_k, contig_sums_k, ins_k,
                ins_syms_k, site_cov_k,
                n_reads=m.encoder.n_reads,
                n_skipped=m.encoder.n_skipped,
                aligned_bases=pm.n_events,
                dash_counts=dash_k)
        except Exception as exc:
            runner.backend.serve_prepared_obs = None
            logger.warning("packed job %s: shared-tail render failed "
                           "(%s: %s) — extraction tail",
                           m.entry["job_id"], type(exc).__name__, exc)
            # the member's instruments were consumed by the failed
            # render run: rebuild them on the SAME export paths (the
            # fallback's finish_run overwrites the failed attempt's
            # files — no concurrent writer here, unlike the watchdog
            # retry), restore the decode-phase counters the job
            # already earned, and re-apply the batch accounting
            old = m.robs
            m.robs = obs.prepare_run(trace_out=old.trace_out,
                                     metrics_out=old.metrics_out,
                                     config=m.cfg)
            for key, val in m.decode_counters.items():
                m.robs.registry.add(key, val)
            if rebill is not None:
                rebill()
            return False
        finally:
            stele.set_log_context()
        m.res.fastas, m.res.stats = out.fastas, out.stats
        m.res.error = None
        m.res.elapsed_sec = time.perf_counter() - t_batch0
        return True

    def _tail_member(self, m: _Member, part: np.ndarray,
                     pm: packing.PackedMember, t_batch0: float) -> None:
        """One member's extraction tail: the cold-run tail/render over
        its private count partition, journaled/finalized by the caller."""
        runner = self.runner
        stele.set_log_context(job_id=m.entry["job_id"],
                              tenant=m.entry["spec"].tenant,
                              rung="packed")
        runner.backend.serve_prepared_obs = m.robs
        try:
            out = runner.backend.run_from_counts(
                m.contigs, m.cfg, part, m.encoder.insertions,
                n_reads=m.encoder.n_reads,
                n_skipped=m.encoder.n_skipped,
                aligned_bases=pm.n_events)
        except Exception as exc:
            runner._note_poison(m.entry["spec"], exc, m.res)
            m.res.error = f"{type(exc).__name__}: {exc}"
            logger.warning("packed job %s failed: %s",
                           m.entry["job_id"], m.res.error)
        else:
            m.res.fastas, m.res.stats = out.fastas, out.stats
            m.res.error = None
        finally:
            runner.backend.serve_prepared_obs = None
            stele.set_log_context()
        m.res.elapsed_sec = time.perf_counter() - t_batch0

    # -- helpers -----------------------------------------------------------
    def _close_member(self, m: _Member) -> None:
        m.batches = []
        m.encoder = None

    def _demote_all(self, members: List[_Member], finished: dict,
                    indices: List[int], reason: str):
        """Pre-execution demotion (nothing started yet): hand every
        index back to the serial path."""
        self.runner.registry.add("batch/demotions", 1)
        logger.info("batch demoted before dispatch (%s)", reason)
        done = {m.index for m in members if m.failed}
        return finished, [i for i in indices if i not in done]
