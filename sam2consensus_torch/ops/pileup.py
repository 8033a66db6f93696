"""Device pileup: segment rows accumulated into an ``[L, 6]`` int32 tensor.

Port of the single-device path of ``sam2consensus_tpu/ops/pileup.py``.
On CUDA each bucket of a batch is staged on the decode prefetch thread
(:meth:`PileupAccumulator.stage`): its real rows' starts and raw uint8
codes (or, under ``--wire delta8``, the encoded slab's lanes) go into a
pinned slot and cross to the card on a side stream.  The consumer's
stream waits on that copy's event (on the device, not the host), unpacks
a delta8 slab (``wire.device``) and counts: ``pallas`` packs the codes
into nibbles with torch ops (:func:`pack_codes`) and runs the histogram
kernel (K1, ``ops/pileup_kernel.py``), ``scatter`` runs
:func:`scatter_segments`.  On the CPU ``add`` runs the same steps on host
tensors, with K1's plain PyTorch version :func:`scatter_segments_packed`.
The count tensor is updated in place (no second ``[L, 6]`` buffer per
slab).

:class:`HostPileupAccumulator` is the other strategy (``--pileup host``):
the counts accumulate on the host, in the C++ decode pass itself
(``encoder.native_encoder``'s fused count) or by ``s2c_accumulate_rows``,
and cross to the card once, narrowed to the smallest dtype that holds
them.  :func:`host_pileup_bound` is the ``--pileup auto`` gate between
the two.  :func:`canonical_slab_shapes` and :func:`prewarm_pileup` are the
serve runner's prewarm (:func:`canonical_panel_shapes` a cohort's).

Fault-injection sites (``resilience.faultinject``) sit where the
reference places them: ``mem_alloc`` at the count tensor's allocation,
``device_put`` where rows or counts start to cross to the card (staging,
an unstaged batch's consumer-side shipping, the host counts' upload),
``pileup_dispatch`` at each ``add``, and ``wire_encode`` in the delta8
encode gate (``wire.encode_wire_slab``).  ``strategy`` and ``wire`` of a
live :class:`PileupAccumulator` may be switched between batches (the
degradation ladder's first rung), and :meth:`PileupAccumulator.counts_host`
fetches the counts for the second.

Observability, where the reference records it: each counted bucket is a
``slab`` span (``pileup/slab_sec/<strategy>``, ``pileup/slabs``), the
host counts' upload a ``counts_upload`` span, the link bytes
``wire/h2d_bytes`` and ``wire/d2h_bytes``, and the memory plane tracks
the ``counts``, ``counts_host`` and ``wire_staging`` families.
"""

from __future__ import annotations

import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import observability as obs
from ..constants import NUM_SYMBOLS, PAD_CODE
from ..encoder.events import MIN_BUCKET_W, SegmentBatch
from ..observability import memplane
from ..resilience.faultinject import fault_check

#: copy of ``sam2consensus_tpu/ops/mxu_pileup.TILE_POSITIONS``: the
#: position-axis padding unit of the count tensor
TILE_POSITIONS = 2048


def round_rows_grid(m: int) -> int:
    """Copy: round a row capacity up to an eighth-power-of-two grid."""
    m = max(8, int(m))
    shift = max(0, (m - 1).bit_length() - 4)
    return -(-m >> shift) << shift


def round_rows_pow2(m: int) -> int:
    """Copy: full power-of-two row-capacity rounding (floor 8)."""
    return 1 << max(3, (max(1, int(m)) - 1).bit_length())


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """Copy: ``[S, W]`` codes -> ``[S, ceil(W/2)]`` bytes, PAD -> 15, even
    columns in the low nibble; an odd width gains one PAD column."""
    nib = np.where(codes < NUM_SYMBOLS, codes, 15).astype(np.uint8)
    if nib.shape[1] % 2:
        nib = np.concatenate(
            [nib, np.full((len(nib), 1), 15, dtype=np.uint8)], axis=1)
    return nib[:, 0::2] | (nib[:, 1::2] << 4)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """:func:`pack_nibbles` in torch ops on the codes' device: uint8
    ``[S, W]`` -> ``[S, ceil(W/2)]``, PAD -> 15, even columns in the low
    nibble; an odd width gains one PAD column."""
    nib = torch.where(codes < NUM_SYMBOLS, codes, 15)
    if nib.shape[1] % 2:
        nib = torch.nn.functional.pad(nib, (0, 1), value=15)
    return nib[:, 0::2] | (nib[:, 1::2] << 4)


def padded_total_len(total_len: int) -> int:
    """Copy: the count tensor's position axis, whole tiles past total_len."""
    tile = TILE_POSITIONS
    return -(-(total_len + 1) // tile) * tile


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles` (PAD comes back as 15): uint8
    ``[S, W/2]`` -> ``[S, W]``."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)


def expand_segment_positions(starts: torch.Tensor, codes: torch.Tensor):
    """Flat ``(pos, code)`` int64 operands of every countable cell; PAD cells
    are dropped (the JAX version redirects them to a sacrificial row)."""
    w = codes.shape[1]
    pos = starts.long()[:, None] + torch.arange(w, device=codes.device)
    valid = codes < NUM_SYMBOLS
    return pos[valid], codes[valid].long()


def scatter_segments_packed(counts: torch.Tensor, starts: torch.Tensor,
                            packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``counts[start_r + j, code_r[j]] += 1``
    over nibble-packed rows, in place; returns ``counts``."""
    pos, code = expand_segment_positions(starts, unpack_nibbles(packed))
    ones = torch.ones(pos.shape, dtype=counts.dtype, device=counts.device)
    return counts.index_put_((pos, code), ones, accumulate=True)


#: copy: cap on expanded scatter cells (rows x width) a call, bounding the
#: int64 index temporary to 64 MB
SCATTER_CELL_BUDGET = 1 << 23


def iter_row_slices(n_rows: int, width: int, multiple_of: int = 1):
    """Copy: ``(lo, hi)`` row slices of at most SCATTER_CELL_BUDGET cells."""
    step = max(multiple_of, (SCATTER_CELL_BUDGET // width)
               // multiple_of * multiple_of)
    for lo in range(0, n_rows, step):
        yield lo, min(n_rows, lo + step)


class PileupAutoTuner:
    """Copy: the online-autotune state machine of ``--pileup auto`` in the
    reference (``PileupAccumulator(strategy="auto")`` and dp's
    ``pileup="auto"``).

    Protocol per slab: ``choose(n_rows, width)`` -> (strategy, timing);
    execute the slab; then call exactly one of ``report_skew()`` (the
    kernel's plan fell back) or ``complete(sec_per_cell)`` (the measured
    per-cell seconds iff ``timing`` was True, else no argument).  ``stats``
    is a dict once a winner is locked, else None."""

    MAX_SKEW_RETRIES = 3

    def __init__(self, min_cells: int = SCATTER_CELL_BUDGET >> 3,
                 kernel: str = "mxu"):
        self.STAGES = (("scatter", False), ("scatter", True),
                       (kernel, False), (kernel, True))
        self.kernel = kernel
        self.min_cells = min_cells
        self.times: dict = {}
        self.stats = None
        self._stage = 0
        self._warm_shape = None
        self._skew = 0
        self._chosen = "scatter"
        self._timing = False
        self._advance = False

    @property
    def winner(self):
        return self.times.get("winner")

    def _lock(self, winner: str, **extra) -> None:
        self.times["winner"] = winner
        self.stats = {
            "scatter_sec_per_mcell": round(
                self.times.get("scatter", 0.0) * 1e6, 5),
            f"{self.kernel}_sec_per_mcell": round(
                self.times.get(self.kernel, 0.0) * 1e6, 5),
            "winner": winner, **extra}

    def choose(self, n_rows: int, width: int):
        self._timing = self._advance = False
        if self.winner is not None:
            self._chosen = self.winner
        elif n_rows * width < self.min_cells:
            # tiny slab: timing would be noise, cost is negligible
            self._chosen = "scatter"
        else:
            self._chosen, is_timing_stage = self.STAGES[self._stage]
            shape = (n_rows, width)
            if not is_timing_stage:
                self._warm_shape = shape        # warm slab
                self._advance = True
            elif shape != self._warm_shape:
                # shape changed since the warm slab: re-warm, stay in
                # stage
                self._warm_shape = shape
            else:
                self._timing = self._advance = True
        return self._chosen, self._timing

    def report_skew(self) -> None:
        """The kernel plan fell back to scatter on this slab."""
        if self.winner is not None:
            return
        self._timing = self._advance = False
        self._skew += 1
        if self._skew >= self.MAX_SKEW_RETRIES:
            # persistent skew: settle for scatter
            self._lock("scatter", reason=f"{self.kernel}_skew")

    def complete(self, sec_per_cell=None) -> None:
        if self.winner is not None:
            return
        if self._timing:
            self.times[self._chosen] = sec_per_cell
            if "scatter" in self.times and self.kernel in self.times:
                self._lock(min(("scatter", self.kernel),
                               key=self.times.get))
        if self._advance:
            self._stage += 1


def run_tuned_slab(tuner, static_choice: str, n_rows: int, width: int,
                   plan_kernel, exec_kernel, exec_scatter, block) -> str:
    """Copy: one slab of the autotune protocol (the reference's shared
    driver of the single-device and dp accumulators).  ``plan_kernel() ->
    plan | None`` (None = skew), ``exec_kernel(plan)`` / ``exec_scatter()``
    run the slab, ``block()`` waits for it (only a timed tuner slab
    blocks).  Emits the per-slab ``slab`` span, ``pileup/slab_sec/<key>``,
    ``pileup/slabs`` and, once the tuner locks, the ``pileup/autotune``
    gauge.  Returns the strategy key actually used."""
    if tuner is not None:
        chosen, timing = tuner.choose(n_rows, width)
    else:
        chosen, timing = static_choice, False
    t0 = time.perf_counter()           # before host planning: the kernel
    plan = None                        # number must be end-to-end
    skewed = False
    if chosen != "scatter":
        plan = plan_kernel()
        if plan is None:               # skew (padding blowup): scatter
            skewed = True
            if tuner is not None:
                tuner.report_skew()
                timing = False
    if plan is not None:
        exec_kernel(plan)
        key = chosen
    else:
        exec_scatter()
        key = "scatter"
    if tuner is not None and not skewed:
        if timing:
            block()
            tuner.complete((time.perf_counter() - t0) / (n_rows * width))
        else:
            tuner.complete()
    dt = time.perf_counter() - t0
    obs.tracer().complete("slab", t0, strategy=key, n_rows=n_rows,
                          width=width, skewed=skewed, timed=timing)
    reg = obs.metrics()
    reg.observe(f"pileup/slab_sec/{key}", dt)
    reg.add("pileup/slabs", 1)
    if tuner is not None and tuner.stats is not None:
        reg.gauge("pileup/autotune").set_info(dict(tuner.stats))
    return key


def scatter_segments(counts: torch.Tensor, starts: torch.Tensor,
                     codes: torch.Tensor, sacrificial: int) -> torch.Tensor:
    """The ``--pileup scatter`` strategy, in place: one ``index_add_`` of
    ones over the flat cell index ``(start_r + j) * 6 + code_r[j]`` per
    slice of :func:`iter_row_slices`.  The reference's
    ``_scatter_segments_packed`` (an XLA scatter-add) in torch: PAD cells
    (any code past the alphabet: 255 raw, 15 unpacked) count into row
    ``sacrificial`` (inside the padded count tensor, never read), as
    there, instead of being filtered by a mask, which would synchronise
    with the host on CUDA.  ``codes`` uint8 ``[S, W]``; returns
    ``counts``."""
    w = codes.shape[1]
    flat = counts.view(-1)
    col = torch.arange(w, device=codes.device)
    for lo, hi in iter_row_slices(codes.shape[0], w):
        cd = codes[lo:hi]
        cell = (starts[lo:hi].long()[:, None] + col) * NUM_SYMBOLS + cd
        idx = torch.where(cd < NUM_SYMBOLS, cell, sacrificial * NUM_SYMBOLS)
        flat.index_add_(0, idx.reshape(-1),
                        torch.ones(idx.numel(), dtype=counts.dtype,
                                   device=counts.device))
    return counts


def canonical_slab_shapes(total_len: int, read_len: int = 150,
                          chunk_reads: int = 262144,
                          n_reads: Optional[int] = None,
                          segment_width: int = 0) -> list:
    """The (rows, width) scatter shapes a job over this genome layout is
    expected to dispatch — the serve-mode prewarm enumeration.

    Widths: the power-of-two bucket of ``read_len`` plus its double
    (deletion runs widen a read's reference span past its length;
    encoder/events._bucket_width), both clamped to ``segment_width``
    when the long-read segmented layout is active — segmentation bounds
    every row at W, so wider shapes can never be dispatched.  Rows: the
    power-of-two row paddings a chunk of ``min(n_reads, chunk_reads)``
    reads produces (the accumulator rounds the real row count to a
    power of two and ``iter_row_slices`` caps a slice at
    SCATTER_CELL_BUDGET cells), plus one level down for
    partially-filled tail chunks.  Deliberately a SMALL set — a handful
    of compiles hidden behind the first job's decode — not an
    exhaustive sweep; shapes outside it simply compile on first
    dispatch like today.
    """
    w0 = max(MIN_BUCKET_W, 1 << max(0, (max(1, read_len) - 1).bit_length()))
    widths = [w0, w0 * 2]
    if segment_width:
        widths = sorted({min(w, int(segment_width)) for w in widths})
    shapes = []
    for w in widths:
        step = max(1, SCATTER_CELL_BUDGET // w)
        if n_reads is not None:
            # per-job hint: the row paddings this job's chunks produce,
            # plus one level down for skipped-read shrink / tail chunks
            r_top = min(1 << max(3, (min(n_reads, chunk_reads) - 1)
                                 .bit_length()), step)
            levels = {r_top, max(8, r_top // 2)}
        else:
            # server startup: every power-of-two level a >=~1k-read job
            # can dispatch (the encoder's row floor is 1024; buckets
            # with fewer real rows compile cheaply on first touch)
            r_top = min(1 << max(3, (min(chunk_reads, 1 << 62) - 1)
                                 .bit_length()), step)
            levels = {1 << b for b in range(10, r_top.bit_length())}
            levels.add(r_top)
        for r in sorted(levels):
            shapes.append((int(r), int(w)))
    return sorted(set(shapes))


def canonical_panel_shapes(panel_len: int, wave_jobs: int,
                           read_len: int = 150,
                           chunk_reads: int = 262144,
                           n_reads: Optional[int] = None,
                           segment_width: int = 0) -> list:
    """The (rows, width) shapes a shared-reference COHORT wave dispatches:
    :func:`canonical_slab_shapes` over the combined panel axis
    (``panel_len * wave_jobs`` positions; per-member read counts sum
    across the wave).  The cohort driver (``serve/cohort.py``) prewarms
    this set once before wave 1 through :func:`prewarm_pileup`: the
    kernel extension's load and K1 at each shape, so wave 1 pays neither
    (the offset-table half of the dedup lives in
    ``serve/packing.PanelGeometry``)."""
    return canonical_slab_shapes(
        int(panel_len) * max(1, int(wave_jobs)),
        read_len=read_len, chunk_reads=chunk_reads,
        n_reads=None if n_reads is None
        else int(n_reads) * max(1, int(wave_jobs)),
        segment_width=segment_width)


def prewarm_pileup(total_len: int, shapes, device, counts=None,
                   strategy: str = "pallas") -> int:
    """The serve prewarm (the reference's ``prewarm_scatter``): there is
    no JIT to warm, so it loads the kernel extension
    (``kernels.build.extension``, counted ``compile/persist_*`` by
    ``observability.jitcache`` in the current registry: the serve runner
    binds its server registry) and runs the default device route, the
    nibble pack and K1 (:func:`pack_codes`,
    ``pileup_kernel.accumulate_rows``), once per ``(rows, width)`` in
    ``shapes`` over all-PAD rows at start 0, into a scratch count tensor
    of the job's padded length, which is then freed.  The operands are
    born on the device (no host copy) and nothing is read back, so the
    prewarm makes no host synchronisation.  PAD adds nothing to the
    counts (K1 skips code 15; the plain version drops PAD cells), so they
    stay zero.  ``counts``, a caller's ``[padded, 6]`` int32 tensor,
    takes the scratch tensor's place (a check that it stays zero).  On
    the CPU the plain version runs.  ``strategy="mxu"`` (an explicit
    ``--pileup mxu`` job's prewarm) runs the MXU route instead
    (``mxu_pileup.pileup_mxu_compact``) at each shape's width, over one
    tile of eight all-PAD rows: it loads cuBLAS and its workspace, and the
    rows one-hot to zero.  Returns the number of shapes launched."""
    from . import mxu_pileup
    from .pileup_kernel import accumulate_rows

    dev = torch.device(device)
    if dev.type == "cuda":
        from ..kernels.build import extension

        extension()
    if counts is None:
        counts = torch.zeros((padded_total_len(total_len), NUM_SYMBOLS),
                             dtype=torch.int32, device=dev)
    n = 0
    for rows, width in sorted(set((int(r), int(w)) for r, w in shapes)):
        if width % 2 or rows <= 0:
            continue
        if strategy == "mxu":
            rows = 8
        starts = torch.zeros(rows, dtype=torch.int32, device=dev)
        codes = torch.full((rows, width), PAD_CODE, dtype=torch.uint8,
                           device=dev)
        if strategy == "mxu":
            mxu_pileup.pileup_mxu_compact(
                counts, starts, codes,
                torch.arange(rows, dtype=torch.int32, device=dev),
                tile=mxu_pileup.TILE_POSITIONS, n_tiles=1,
                rows_per_tile=rows, width=width)
        else:
            accumulate_rows(counts, starts, pack_codes(codes))
        n += 1
    del counts
    return n


def real_rows(codes: np.ndarray) -> int:
    """Rows before the slab's all-PAD tail (the encoder pads a bucket's row
    count to a power of two with all-PAD rows at start 0)."""
    nz = np.nonzero(codes[:, 0] != PAD_CODE)[0]
    tail_lo = int(nz[-1]) + 1 if len(nz) else 0
    row_pad = (codes[tail_lo:] == PAD_CODE).all(axis=1)
    nz2 = np.nonzero(~row_pad)[0]
    return tail_lo + (int(nz2[-1]) + 1 if len(nz2) else 0)


class HostRows(NamedTuple):
    """One bucket's real rows as they cross the link: ``arrays`` (int32
    starts and raw uint8 codes, or a delta8 slab's lanes), ``meta`` (a
    delta8 slab's, else None); beside them, for the reference's slab
    protocol, ``n_rows`` (the rows it plans over: the real rows rounded up
    to a power of two within the bucket, PAD rows at start 0 past the real
    ones), ``starts`` (those rows' host starts), ``mxu`` (the MXU slot
    plan made on the host: None when not planned or skewed) and ``slot``
    (its slots of the real rows, which cross beside them)."""
    arrays: tuple
    meta: Optional[tuple]
    n_rows: int
    starts: np.ndarray
    mxu: Optional[object] = None
    slot: Optional[np.ndarray] = None


class StagedRows(NamedTuple):
    """One bucket's real rows on the card, as the prefetch thread staged
    them: ``operands``, the tensors that crossed (int32 starts ``[n]`` and
    raw uint8 codes ``[n, W]``, or a delta8 slab's six lanes), allocated
    on the copy stream; ``ready``, recorded there after the copies;
    ``meta``, a delta8 slab's ``(width, sentinel, u16)``
    (``wire.device.decode_slab``), None for raw rows; ``host``, the
    bucket's :class:`HostRows` (its planning fields), and ``slot``, the
    MXU slot vector on the card when the host planned one."""
    operands: tuple
    ready: torch.cuda.Event
    meta: Optional[tuple] = None
    host: Optional[HostRows] = None
    slot: Optional[torch.Tensor] = None


class _PinnedSlot:
    """Page-locked host buffers, one per array of a staged bucket, each
    grown to the largest it held and reused.  ``copied`` is the event of
    the last host-to-device copy that read them: the slot is written
    again only after that copy completed."""

    def __init__(self):
        self.buffers: list = []
        self.copied: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        """Block the calling host thread until the slot's last copy to
        the card has completed (then the slot may be written)."""
        if self.copied is not None:
            self.copied.synchronize()

    def fill(self, arrays) -> list:
        """Copy the numpy ``arrays`` in (after :meth:`wait`); returns the
        pinned views, of the arrays' dtypes and shapes."""
        views = []
        for i, a in enumerate(arrays):
            if i == len(self.buffers):
                self.buffers.append(torch.empty(0, dtype=torch.uint8,
                                                pin_memory=True))
            if self.buffers[i].numel() < a.nbytes:
                self.buffers[i] = torch.empty(a.nbytes, dtype=torch.uint8,
                                              pin_memory=True)
            src = torch.from_numpy(np.ascontiguousarray(a))
            view = self.buffers[i][:a.nbytes].view(src.dtype).view(a.shape)
            view.copy_(src)
            views.append(view)
        return views


class PileupAccumulator:
    """Streaming single-device accumulator of segment batches.

    ``strategy``: ``pallas`` packs each bucket's rows into nibbles and
    runs K1 (``ops.pileup_kernel.accumulate_rows``, its plain version on
    the CPU), ``scatter`` runs :func:`scatter_segments` on the raw codes,
    ``mxu`` the one-hot tile product (``ops.mxu_pileup``) over the slots
    the host planned (:func:`~.mxu_pileup.plan_slots` at the reference's
    ``max_blowup`` of 16 for an explicit ``mxu``), falling back to the
    scatter on a skewed slab, and ``auto`` the reference's online
    autotune (:class:`PileupAutoTuner`: scatter against K1 on a CUDA
    device, against the MXU route on the CPU), whose timed slabs wait for
    the card.  ``mxu`` and ``auto`` run the reference's slab protocol
    (:func:`run_tuned_slab`) over its row set: the real rows rounded up
    to a power of two (the PAD rows past the real ones plan into tile 0
    and count nothing, so only the real rows and their slots cross), and
    ``strategy_used`` gets the reference's ``mxu_blowup`` (the run's
    padded over real rows) and ``autotune`` keys.
    ``wire``: the rows cross as they are (``packed5``, the run's default
    codec; on the card they are packed there) or, under ``delta8``,
    canonicalised and encoded (``wire.codec``) and unpacked on the device
    (``wire.device.decode_slab``); a slab that would not shrink goes raw.
    A strategy that plans slots plans on the canonical rows, in the order
    the device decodes them.

    CUDA: :meth:`stage` (on the decode prefetch thread) trims, encodes,
    plans an explicit ``mxu`` bucket and ships each bucket (and its slots)
    through two pinned slots on a copy stream; :meth:`add` (on the
    consumer) waits for the copies on its own stream, unpacks a delta8
    slab and counts, with no host synchronisation outside ``auto``'s timed
    slabs.  An unstaged batch is staged by ``add`` itself first.  CPU:
    ``stage`` does nothing, and ``add`` runs the same steps on host
    tensors.  The count tensor is updated in place; ``counts`` is the
    ``[total_len, 6]`` view.  ``strategy_used`` counts
    ``<strategy>_w<W>`` a counted bucket and ``wire_delta8`` a delta8
    slab; ``account`` is the link bill.  ``strategy`` and ``wire`` are
    read per bucket, so the ladder can switch them on a live accumulator
    (and drop the tuner); :meth:`set_counts` seeds the counts (a
    checkpoint resume) and :meth:`counts_host` fetches them.
    """

    #: pinned slots, taken in turn by the staged buckets
    SLOTS = 2

    def __init__(self, total_len: int, device, strategy: str = "pallas",
                 wire: str = "packed5"):
        from ..wire import WireAccount

        if strategy not in ("pallas", "mxu", "scatter", "auto"):
            raise ValueError(f"pileup strategy {strategy!r}: the device "
                             f"accumulator runs pallas, mxu, scatter and "
                             f"auto")
        self.total_len = total_len
        self.device = torch.device(device)
        self.strategy = strategy
        self.wire = wire
        self.strategy_used: dict = {}
        self.account = WireAccount()
        self.padded_len = padded_total_len(total_len)
        # the MXU occupancy over the run (padded rows over real rows)
        self._mxu_rows_real = 0
        self._mxu_rows_padded = 0
        # the reference's tuner races scatter against its accelerator's
        # kernel: K1 on the card, the MXU route on the CPU
        self._tuner = PileupAutoTuner(
            kernel="pallas" if self.device.type == "cuda" else "mxu") \
            if strategy == "auto" else None
        # the count tensor's allocation boundary: an ``oom`` rule here
        # models memory exhaustion at allocation (CAPACITY)
        fault_check("mem_alloc")
        self._counts = torch.zeros((self.padded_len, NUM_SYMBOLS),
                                   dtype=torch.int32, device=self.device)
        memplane.track_obj("counts", self,
                           self.padded_len * NUM_SYMBOLS * 4)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(self.SLOTS)]
            self._next_slot = 0
            # held across a bucket's slot choice, wait, fill and ship: the
            # consumer stages too (a capacity split's halves, a replay
            # after a demotion, a batch delivered unstaged) while the
            # prefetch thread may be staging the next batch
            self._stage_lock = threading.Lock()

    def _plans_mxu(self) -> bool:
        """True when a bucket's count may need MXU slots (so its rows are
        planned on their canonical order)."""
        return self.strategy == "mxu" or \
            getattr(self._tuner, "kernel", None) == "mxu"

    def _plan_mxu(self, starts: np.ndarray, width: int):
        """The reference's ``plan_mxu``: slots over the planning rows, or
        None on skew (an explicit ``mxu`` tolerates a blowup of 16, the
        tuner the module's 4; the tuner's timing phase plans on the pow2
        grid)."""
        from . import mxu_pileup

        return mxu_pileup.plan_slots(
            np.asarray(starts), width, self.padded_len,
            mxu_pileup.TILE_POSITIONS,
            max_blowup=(16.0 if self.strategy == "mxu"
                        else mxu_pileup.MAX_BLOWUP),
            coarse=(self._tuner is not None and self._tuner.winner is None))

    def _host_rows(self, starts: np.ndarray, codes: np.ndarray
                   ) -> Optional[HostRows]:
        """A bucket's real rows as they cross the link (:class:`HostRows`),
        billed to ``account``; None when the bucket has no real row.  An
        explicit ``mxu`` bucket is planned here, on the host."""
        from ..wire import encode_wire_slab
        from ..wire.codec import canonicalize_rows
        from ..wire.device import wire_lane

        if self.wire == "delta8" and self._plans_mxu():
            # the slots index the rows in the order the device decodes
            # them (the reference plans after canonicalize_rows too)
            starts, codes = canonicalize_rows(starts, codes)
        n = real_rows(codes)
        if n == 0:
            return None
        n_rows = min(len(starts), round_rows_pow2(n))
        plan = self._plan_mxu(starts[:n_rows], codes.shape[1]) \
            if self.strategy == "mxu" else None
        host_starts = starts[:n_rows]
        starts, codes = starts[:n], codes[:n]
        slab = encode_wire_slab(self.wire, starts, codes, self.account)
        if slab is None:
            arrays, meta, codec = (starts, codes), None, "packed5"
        else:
            arrays = tuple(wire_lane(a) for a in slab.arrays())
            meta = (slab.width, slab.sentinel,
                    tuple(a.dtype == np.uint16 for a in
                          (slab.esc_delta, slab.trail, slab.esc_idx)))
            codec = "delta8"
        self.account.add(codec, sum(a.nbytes for a in arrays), n,
                         codes.shape[1])
        slot = None
        if plan is not None:
            slot = plan.slot[:n]
            self.account.add_operand(slot.nbytes)
        return HostRows(arrays, meta, n_rows, host_starts, plan, slot)

    def stage(self, batch: SegmentBatch) -> None:
        """Ship the batch's real rows to the card (CUDA only): trim (and
        encode under delta8, and plan an explicit ``mxu`` bucket's slots),
        copy into the next pinned slot, copy to the device
        ``non_blocking`` on the copy stream and record an event there; the
        results land in ``batch.staged`` (``None`` for a bucket with no
        real row).  Runs on the decode prefetch thread, or on the consumer
        for a batch that arrives unstaged (both at once, so a lock
        serialises the stagings: two threads never fill one slot)."""
        if self.device.type != "cuda":
            return
        fault_check("device_put")
        nbytes = 0
        with torch.cuda.device(self.device), self._stage_lock:
            for w, (starts, codes) in batch.buckets.items():
                rows = self._host_rows(starts, codes)
                if rows is None:
                    batch.staged[w] = None
                    continue
                slot = self._slots[self._next_slot]
                self._next_slot = (self._next_slot + 1) % len(self._slots)
                slot.wait()
                arrays = rows.arrays if rows.slot is None \
                    else (*rows.arrays, rows.slot)
                staged = self._ship(slot, slot.fill(arrays), rows.meta)
                ops = staged.operands
                batch.staged[w] = staged._replace(
                    operands=ops[:len(rows.arrays)], host=rows,
                    slot=None if rows.slot is None else ops[-1])
                nbytes += sum(a.nbytes for a in arrays)
        # the staged rows on the card, released with the batch
        memplane.track_obj("wire_staging", batch, nbytes)

    def _ship(self, slot: _PinnedSlot, pinned: list, meta) -> StagedRows:
        """Enqueue the pinned arrays' copies to the card on the copy
        stream and record their event (also the slot's ``copied``)."""
        with torch.cuda.stream(self._copy_stream):
            ops = tuple(t.to(self.device, non_blocking=True) for t in pinned)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        slot.copied = ready
        return StagedRows(ops, ready, meta)

    def add(self, batch: SegmentBatch) -> None:
        fault_check("pileup_dispatch")
        if self.device.type == "cuda":
            if batch.buckets and not batch.staged:
                self.stage(batch)
            stream = torch.cuda.current_stream(self.device)
            for _w, rows in sorted(batch.staged.items()):
                if rows is not None:
                    self._consume(rows, stream)
            return
        for _w, (starts, codes) in sorted(batch.buckets.items()):
            # the CPU consumer ships its own rows (no staging thread)
            fault_check("device_put")
            rows = self._host_rows(starts, codes)
            if rows is not None:
                self._count(tuple(map(torch.from_numpy, rows.arrays)),
                            rows.meta, rows, None if rows.slot is None
                            else torch.from_numpy(rows.slot))

    def _consume(self, rows: StagedRows, stream) -> None:
        """The consumer's part of a staged bucket: a device-side wait for
        its copies, then the unpack (delta8) and the count, all enqueued
        on ``stream`` with no host synchronisation."""
        stream.wait_event(rows.ready)
        # allocated on the copy stream, used here: the caching allocator
        # must not hand their memory out again before this stream is done
        for t in (*rows.operands, *(() if rows.slot is None
                                    else (rows.slot,))):
            t.record_stream(stream)
        self._count(rows.operands, rows.meta, rows.host, rows.slot)

    def _count(self, operands: tuple, meta, host: HostRows,
               slot: Optional[torch.Tensor]) -> None:
        """Count one bucket's rows: ``operands`` raw ``(starts, codes)``,
        or a delta8 slab's lanes with its ``meta``; ``host`` and ``slot``
        feed the slab protocol of ``mxu`` and ``auto``."""
        from ..wire.device import decode_slab
        from .pileup_kernel import accumulate_rows

        if meta is None:
            starts, codes = operands
        else:
            starts, codes = decode_slab(*operands, *meta)
            self._note("wire_delta8")
        if self.strategy in ("mxu", "auto"):
            self._count_tuned(starts, codes, host, slot)
            return
        t0 = time.perf_counter()
        if self.strategy == "scatter":
            scatter_segments(self._counts, starts, codes, self.total_len)
        else:
            accumulate_rows(self._counts, starts, pack_codes(codes))
        self._note(f"{self.strategy}_w{codes.shape[1]}")
        # the reference's per-slab records; on CUDA the span and the
        # histogram time the enqueue, not the device's count
        dt = time.perf_counter() - t0
        obs.tracer().complete("slab", t0, strategy=self.strategy,
                              n_rows=codes.shape[0], width=codes.shape[1])
        reg = obs.metrics()
        reg.observe(f"pileup/slab_sec/{self.strategy}", dt)
        reg.add("pileup/slabs", 1)

    def _count_tuned(self, starts: torch.Tensor, codes: torch.Tensor,
                     host: HostRows, slot: Optional[torch.Tensor]) -> None:
        """``mxu`` and ``auto``: one slab of the reference's protocol
        (:func:`run_tuned_slab`) over ``host.n_rows`` planning rows, of
        which the ``n`` real ones are counted."""
        from . import mxu_pileup
        from .pileup_kernel import accumulate_rows

        n, w = codes.shape
        kernel = self._tuner.kernel if self._tuner is not None \
            else self.strategy

        def plan_kernel():
            if kernel == "pallas":
                from ..parallel.base import kernel_width_ok

                return True if kernel_width_ok(w) else None
            if self._tuner is None:
                return host.mxu            # planned with the rows
            return self._plan_mxu(host.starts, w)

        def exec_kernel(plan):
            if kernel == "pallas":
                accumulate_rows(self._counts, starts, pack_codes(codes))
                return
            mxu_slot = slot if slot is not None else torch.as_tensor(
                plan.slot[:n], device=self.device)
            if self.strategy == "mxu" or (self._tuner is not None
                                          and self._tuner.winner == "mxu"):
                # the occupancy of the run's committed MXU slabs
                self._mxu_rows_real += n
                self._mxu_rows_padded += plan.n_tiles * plan.rows_per_tile
                self.strategy_used["mxu_blowup"] = round(
                    self._mxu_rows_padded / self._mxu_rows_real, 3)
            mxu_pileup.pileup_mxu_compact(
                self._counts, starts, codes, mxu_slot,
                tile=mxu_pileup.TILE_POSITIONS, n_tiles=plan.n_tiles,
                rows_per_tile=plan.rows_per_tile, width=w)

        def exec_scatter():
            scatter_segments(self._counts, starts, codes, self.total_len)

        key = run_tuned_slab(self._tuner, self.strategy, host.n_rows, w,
                             plan_kernel, exec_kernel, exec_scatter,
                             self.sync)
        if self._tuner is not None and self._tuner.stats is not None:
            self.strategy_used["autotune"] = self._tuner.stats
        self._note(f"{key}_w{w}")

    def _note(self, key: str) -> None:
        self.strategy_used[key] = self.strategy_used.get(key, 0) + 1

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counts_host(self) -> np.ndarray:
        """The counts fetched to the host, ``[total_len, 6]`` int32 (a
        device-to-host copy that waits for the enqueued counts: the
        ladder's host rung and checkpoint writes)."""
        out = self.counts.cpu().numpy()
        if self.device.type == "cuda":
            obs.metrics().add("wire/d2h_bytes", out.nbytes)
        return out

    def set_counts(self, counts) -> None:
        """Seed the counts (checkpoint resume): ``[total_len, 6]``, host
        counts or a tensor (a packed job's slice of its batch's device
        counts, copied on the device)."""
        if not isinstance(counts, torch.Tensor):
            counts = torch.from_numpy(
                np.ascontiguousarray(counts, dtype=np.int32))
        self._counts[: self.total_len].copy_(counts)

    @property
    def counts(self) -> torch.Tensor:
        """Valid counts, ``[total_len, 6]`` (tile pad rows dropped)."""
        return self._counts[: self.total_len]


# The gate's tables were measured by ``perf/host_gate_sweep.py`` on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, with its 8-core host: 100
# bp reads with qualities (2.32 bytes of SAM an aligned base), sorted and
# random order, 400 bp to 4.6 Mbp at 10x-10000x, nine runs on nine
# machines (``perf/host_gate_sweep_pr7_run{4..12}.log``, combined by the
# script's ``--combine`` into ``perf/host_gate_sweep_pr7_combined.log``).
# The host's count costs grow with the aligned bases and slow as the
# genome outgrows the host's caches, while the device pileup's costs past
# the decode are mostly fixed (5-10 ms): so the bound on the input's bytes
# (a proxy for its aligned bases) depends on the genome's length.  An
# entry is a length and the largest SAM body at which the median over the
# runs of the host counts' wall less the device pileup's was below zero in
# both read orders (below the smallest losing body, and no larger than the
# bound of a shorter genome that lost somewhere).
#: ``--pileup auto`` takes the host counts on a genome of at most
#: ``length`` positions whose input holds at most ``bytes`` decompressed
#: bytes, reading the first entry whose length covers the genome (a
#: shorter genome's count is no slower): up to 1 kbp 23.2 MB (the largest
#: measured; 400 bp won up to its largest, 9.28 MB, by 12-17 ms), 3 kbp
#: 20.9 MB (lost at 69.6 MB), 30 kbp 6.96 MB (10 kbp lost at 23.2 MB, by
#: +0.1 and +1.0 ms), 100 kbp 2.32 MB (lost at 23.2 MB); none past 100 kbp
#: (lost at 300 kbp and 10x, by +0.6 ms in random order)
HOST_PILEUP_NATIVE_BOUNDS = ((1_000, 23_200_000), (3_000, 20_880_000),
                             (30_000, 6_960_000), (100_000, 2_320_000))
#: the same without the native library (the Python decoder, the numpy
#: count walk, the tail on the card): empty, because the host counts lost
#: at every size measured (10-300 kbp at 10x and 100x, by 6 ms to 2.3 s;
#: ``perf/host_gate_sweep_pr7_run4.log``)
HOST_PILEUP_BOUNDS: tuple = ()


def host_pileup_bound(total_len: int, native_tail: bool = False,
                      link_free: bool = False):
    """``(max_len, max_bytes, reason)`` of the auto gate for a genome of
    ``total_len`` positions: ``--pileup auto`` takes the host counts when
    the genome has at most ``max_len`` positions and its input at most
    ``max_bytes`` decompressed bytes (``None``: no byte bound), and why.

    Port of ``sam2consensus_tpu/ops/pileup.host_pileup_max_len`` with the
    card's tables in place of its length bounds; the reason comes back
    beside the bounds (the reference records it in its decision ledger).
    ``native_tail`` (the backend's ``_native_tail_possible``) says the
    native library loads; ``link_free`` that the device is the host's
    CPU.  Reasons: ``env`` (``S2C_HOST_PILEUP_MAX_LEN``, a length bound
    alone, as in the reference), ``link_free`` (no link to bill: no
    bound), ``native_tail`` and ``default``.  Past a table's last length
    the bound is that length, with no bytes.
    """
    def _record(bound: int, max_bytes, reason: str):
        # the decision ledger: the gate's bounds and why (a threshold,
        # not a priced cost: no prediction, so no residual)
        obs.record_decision(
            "host_pileup_bound", str(bound),
            inputs={"reason": reason, "native_tail": bool(native_tail),
                    "link_free": bool(link_free), "max_bytes": max_bytes})
        return bound, max_bytes, reason

    env = os.environ.get("S2C_HOST_PILEUP_MAX_LEN")
    if env:
        try:
            return _record(int(env), None, "env")
        except ValueError:
            raise RuntimeError(
                f"S2C_HOST_PILEUP_MAX_LEN={env!r}: expected a plain "
                f"integer position count (e.g. 8388608)") from None
    if native_tail and link_free:
        return _record(1 << 62, None, "link_free")
    table = HOST_PILEUP_NATIVE_BOUNDS if native_tail else HOST_PILEUP_BOUNDS
    reason = "native_tail" if native_tail else "default"
    for max_len, max_bytes in table:
        if total_len <= max_len:
            return _record(max_len, max_bytes, reason)
    return _record((table[-1][0] if table else 0), 0, reason)


class HostPileupAccumulator:
    """Host-side counts: ship the count tensor, not the reads.

    Port of ``sam2consensus_tpu/ops/pileup.HostPileupAccumulator``.  The
    ``[L, 6]`` int32 counts live in host memory.  The fused decode path
    counts into them inside the C++ pass (batches arrive with
    ``accumulated=True`` and nothing to walk); other batches are walked by
    ``s2c_accumulate_rows`` (numpy without the library).  The tail reads
    them in place (:meth:`counts_host`, the native vote) or on a device
    (:meth:`counts_on`): on CUDA one pinned, ``non_blocking``
    host-to-device copy of the counts narrowed to the smallest dtype that
    holds ``max(counts)`` (uint8, uint16 or int32), which the tail widens
    on the card.
    """

    def __init__(self, total_len: int):
        from .. import native

        self.total_len = total_len
        self._counts = np.zeros((total_len, NUM_SYMBOLS), dtype=np.int32)
        memplane.track_obj("counts_host", self, self._counts.nbytes)
        self._lib = native.load()              # None -> numpy walk
        self._device_counts = None
        self._wire_itemsize = None
        self.strategy_used: dict = {"host": 0}
        #: bytes of counts copied to a card, and the number of copies
        self.bytes_h2d = 0
        self.uploads = 0
        #: ``"cpu"`` pins the tail to the host (the ladder's tail rung);
        #: None lets the placement model choose
        self.tail_device = None
        #: a demoted device accumulator's link bill (``wire.WireAccount``),
        #: carried so the pre-demotion transfers stay in the run's bill
        self.account = None

    def add(self, batch: SegmentBatch) -> None:
        self._device_counts = None
        self._wire_itemsize = None
        if batch.accumulated:
            # fused decode path: the C++ decoder already counted this
            # batch's rows; record that the fused path ran
            self.strategy_used["host_fused"] = (
                self.strategy_used.get("host_fused", 0) + 1)
            return
        flat = self._counts.reshape(-1)
        for w, (starts, codes) in sorted(batch.buckets.items()):
            t0 = time.perf_counter()
            if self._lib is not None:
                self._lib.s2c_accumulate_rows(
                    np.ascontiguousarray(starts),
                    np.ascontiguousarray(codes),
                    len(starts), w, flat, self.total_len)
            else:
                rows, cols = np.nonzero(codes < NUM_SYMBOLS)
                pos = starts[rows].astype(np.int64) + cols
                ok = (pos >= 0) & (pos < self.total_len)
                np.add.at(self._counts,
                          (pos[ok], codes[rows[ok], cols[ok]]), 1)
            self.strategy_used["host"] += 1
            obs.tracer().complete("slab", t0, strategy="host",
                                  n_rows=len(starts), width=w)
            obs.metrics().observe("pileup/slab_sec/host",
                                  time.perf_counter() - t0)

    def wire_itemsize(self) -> int:
        """Bytes a cell of the narrowed upload (a cached one-pass max):
        the tail placement prices the upload before it happens."""
        if self._wire_itemsize is None:
            m = int(self._counts.max(initial=0))
            self._wire_itemsize = 1 if m < (1 << 8) else \
                2 if m < (1 << 16) else 4
        return self._wire_itemsize

    def counts_on(self, device: torch.device) -> torch.Tensor:
        """The counts as a tensor on ``device``: the host buffer itself on
        the CPU; on CUDA one narrowed copy, made once and cached (staged
        through page-locked memory, copied ``non_blocking`` on the current
        stream)."""
        device = torch.device(device)
        if device.type == "cpu":
            return torch.from_numpy(self._counts)
        if self._device_counts is None:
            with obs.tracer().span("counts_upload"):
                fault_check("device_put")
                it = self.wire_itemsize()
                dtype = {1: torch.uint8, 2: torch.uint16,
                         4: torch.int32}[it]
                pinned = torch.empty(self._counts.shape, dtype=dtype,
                                     pin_memory=True)
                pinned.copy_(torch.from_numpy(self._counts))
                with torch.cuda.device(device):
                    self._device_counts = pinned.to(device,
                                                    non_blocking=True)
                self.strategy_used["host_wire_dtype"] = str(dtype).replace(
                    "torch.", "")
                self.bytes_h2d += pinned.nbytes
                self.uploads += 1
                obs.metrics().add("wire/h2d_bytes", pinned.nbytes)
        return self._device_counts

    def counts_host(self) -> np.ndarray:
        return self._counts

    def invalidate_upload(self) -> None:
        """Drop the cached device upload (the next ``counts_on`` copies
        again)."""
        self._device_counts = None

    def set_counts(self, counts) -> None:
        # in place: the fused decode path holds this buffer by reference
        self._counts[:] = np.asarray(counts, dtype=np.int32)
        self._device_counts = None
        self._wire_itemsize = None

    def sync(self) -> None:
        """Nothing to wait for: the counts are complete on the host."""
