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
the two.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import NUM_SYMBOLS, PAD_CODE
from ..encoder.events import SegmentBatch

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


def real_rows(codes: np.ndarray) -> int:
    """Rows before the slab's all-PAD tail (the encoder pads a bucket's row
    count to a power of two with all-PAD rows at start 0)."""
    nz = np.nonzero(codes[:, 0] != PAD_CODE)[0]
    tail_lo = int(nz[-1]) + 1 if len(nz) else 0
    row_pad = (codes[tail_lo:] == PAD_CODE).all(axis=1)
    nz2 = np.nonzero(~row_pad)[0]
    return tail_lo + (int(nz2[-1]) + 1 if len(nz2) else 0)


class StagedRows(NamedTuple):
    """One bucket's real rows on the card, as the prefetch thread staged
    them: ``operands``, the tensors that crossed (int32 starts ``[n]`` and
    raw uint8 codes ``[n, W]``, or a delta8 slab's six lanes), allocated
    on the copy stream; ``ready``, recorded there after the copies;
    ``meta``, a delta8 slab's ``(width, sentinel, u16)``
    (``wire.device.decode_slab``), None for raw rows."""
    operands: tuple
    ready: torch.cuda.Event
    meta: Optional[tuple] = None


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
    the CPU), ``scatter`` runs :func:`scatter_segments` on the raw codes.
    ``wire``: the rows cross as they are (``packed5``, the run's default
    codec; on the card they are packed there) or, under ``delta8``,
    canonicalised and encoded (``wire.codec``) and unpacked on the device
    (``wire.device.decode_slab``); a slab that would not shrink goes raw.

    CUDA: :meth:`stage` (on the decode prefetch thread) trims, encodes and
    ships each bucket through two pinned slots on a copy stream;
    :meth:`add` (on the consumer) waits for the copies on its own stream,
    unpacks a delta8 slab and counts, with no host synchronisation.  An
    unstaged batch is staged by ``add`` itself first.  CPU: ``stage`` does
    nothing, and ``add`` runs the same steps on host tensors.  The count
    tensor is updated in place; ``counts`` is the ``[total_len, 6]`` view.
    ``strategy_used`` counts ``<strategy>_w<W>`` a counted bucket and
    ``wire_delta8`` a delta8 slab; ``account`` is the link bill.
    """

    #: pinned slots, taken in turn by the staged buckets
    SLOTS = 2

    def __init__(self, total_len: int, device, strategy: str = "pallas",
                 wire: str = "packed5"):
        from ..wire import WireAccount

        if strategy not in ("pallas", "scatter"):
            raise ValueError(f"pileup strategy {strategy!r}: the device "
                             f"accumulator runs pallas and scatter")
        self.total_len = total_len
        self.device = torch.device(device)
        self.strategy = strategy
        self.wire = wire
        self.strategy_used: dict = {}
        self.account = WireAccount()
        self.padded_len = padded_total_len(total_len)
        self._counts = torch.zeros((self.padded_len, NUM_SYMBOLS),
                                   dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(self.SLOTS)]
            self._next_slot = 0

    def _host_rows(self, starts: np.ndarray, codes: np.ndarray):
        """A bucket's real rows as they cross the link, ``(arrays, meta)``
        (``StagedRows.meta``), billed to ``account``; None when the bucket
        has no real row."""
        from ..wire import encode_wire_slab
        from ..wire.device import wire_lane

        n = real_rows(codes)
        if n == 0:
            return None
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
        return arrays, meta

    def stage(self, batch: SegmentBatch) -> None:
        """Ship the batch's real rows to the card (CUDA only): trim (and
        encode under delta8), copy into the next pinned slot, copy to the
        device ``non_blocking`` on the copy stream and record an event
        there; the results land in ``batch.staged`` (``None`` for a bucket
        with no real row).  Runs on the decode prefetch thread."""
        if self.device.type != "cuda":
            return
        with torch.cuda.device(self.device):
            for w, (starts, codes) in batch.buckets.items():
                rows = self._host_rows(starts, codes)
                if rows is None:
                    batch.staged[w] = None
                    continue
                slot = self._slots[self._next_slot]
                self._next_slot = (self._next_slot + 1) % len(self._slots)
                slot.wait()
                batch.staged[w] = self._ship(slot, slot.fill(rows[0]),
                                             rows[1])

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
        if self.device.type == "cuda":
            if batch.buckets and not batch.staged:
                self.stage(batch)
            stream = torch.cuda.current_stream(self.device)
            for _w, rows in sorted(batch.staged.items()):
                if rows is not None:
                    self._consume(rows, stream)
            return
        for _w, (starts, codes) in sorted(batch.buckets.items()):
            rows = self._host_rows(starts, codes)
            if rows is not None:
                self._count(tuple(map(torch.from_numpy, rows[0])), rows[1])

    def _consume(self, rows: StagedRows, stream) -> None:
        """The consumer's part of a staged bucket: a device-side wait for
        its copies, then the unpack (delta8) and the count, all enqueued
        on ``stream`` with no host synchronisation."""
        stream.wait_event(rows.ready)
        # allocated on the copy stream, used here: the caching allocator
        # must not hand their memory out again before this stream is done
        for t in rows.operands:
            t.record_stream(stream)
        self._count(rows.operands, rows.meta)

    def _count(self, operands: tuple, meta) -> None:
        """Count one bucket's rows: ``operands`` raw ``(starts, codes)``,
        or a delta8 slab's lanes with its ``meta``."""
        from ..wire.device import decode_slab
        from .pileup_kernel import accumulate_rows

        if meta is None:
            starts, codes = operands
        else:
            starts, codes = decode_slab(*operands, *meta)
            self._note("wire_delta8")
        if self.strategy == "scatter":
            scatter_segments(self._counts, starts, codes, self.total_len)
        else:
            accumulate_rows(self._counts, starts, pack_codes(codes))
        self._note(f"{self.strategy}_w{codes.shape[1]}")

    def _note(self, key: str) -> None:
        self.strategy_used[key] = self.strategy_used.get(key, 0) + 1

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
    env = os.environ.get("S2C_HOST_PILEUP_MAX_LEN")
    if env:
        try:
            return int(env), None, "env"
        except ValueError:
            raise RuntimeError(
                f"S2C_HOST_PILEUP_MAX_LEN={env!r}: expected a plain "
                f"integer position count (e.g. 8388608)") from None
    if native_tail and link_free:
        return 1 << 62, None, "link_free"
    table = HOST_PILEUP_NATIVE_BOUNDS if native_tail else HOST_PILEUP_BOUNDS
    reason = "native_tail" if native_tail else "default"
    for max_len, max_bytes in table:
        if total_len <= max_len:
            return max_len, max_bytes, reason
    return (table[-1][0] if table else 0), 0, reason


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
        self._lib = native.load()              # None -> numpy walk
        self._device_counts = None
        self._wire_itemsize = None
        self.strategy_used: dict = {"host": 0}
        #: bytes of counts copied to a card, and the number of copies
        self.bytes_h2d = 0
        self.uploads = 0

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
            it = self.wire_itemsize()
            dtype = {1: torch.uint8, 2: torch.uint16, 4: torch.int32}[it]
            pinned = torch.empty(self._counts.shape, dtype=dtype,
                                 pin_memory=True)
            pinned.copy_(torch.from_numpy(self._counts))
            with torch.cuda.device(device):
                self._device_counts = pinned.to(device, non_blocking=True)
            self.strategy_used["host_wire_dtype"] = str(dtype).replace(
                "torch.", "")
            self.bytes_h2d += pinned.nbytes
            self.uploads += 1
        return self._device_counts

    def counts_host(self) -> np.ndarray:
        return self._counts

    def set_counts(self, counts) -> None:
        # in place: the fused decode path holds this buffer by reference
        self._counts[:] = np.asarray(counts, dtype=np.int32)
        self._device_counts = None
        self._wire_itemsize = None

    def sync(self) -> None:
        """Nothing to wait for: the counts are complete on the host."""
