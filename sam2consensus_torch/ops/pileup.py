"""Device pileup: segment rows accumulated into an ``[L, 6]`` int32 tensor.

Port of the single-device path of ``sam2consensus_tpu/ops/pileup.py``.
On CUDA each bucket of a batch is staged on the decode prefetch thread
(:meth:`PileupAccumulator.stage`): its real rows' starts and raw uint8
codes go into a pinned slot and cross to the card on a side stream.  The
consumer's stream waits on that copy's event (on the device, not the
host), packs the codes into nibbles with torch ops (:func:`pack_codes`)
and runs the histogram kernel (K1, ``ops/pileup_kernel.py``).  On the CPU
``add`` packs with numpy (:func:`pack_nibbles`) and runs K1's plain
PyTorch version :func:`scatter_segments_packed`.  The count tensor is
updated in place (no second ``[L, 6]`` buffer per slab).
"""

from __future__ import annotations

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
    them: ``starts`` int32 ``[n]`` and raw ``codes`` uint8 ``[n, W]``,
    allocated on the copy stream; ``ready`` is recorded there after the
    copies."""
    starts: torch.Tensor
    codes: torch.Tensor
    ready: torch.cuda.Event


class _PinnedSlot:
    """A page-locked host buffer pair, grown to the largest slab and
    reused.  ``copied`` is the event of the last host-to-device copy that
    read it: the slot is written again only after that copy completed."""

    def __init__(self):
        self.starts = torch.empty(0, dtype=torch.int32, pin_memory=True)
        self.codes = torch.empty(0, dtype=torch.uint8, pin_memory=True)
        self.copied: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        """Block the calling host thread until the slot's last copy to
        the card has completed (then the slot may be written)."""
        if self.copied is not None:
            self.copied.synchronize()

    def fill(self, starts: np.ndarray, codes: np.ndarray):
        """Copy ``starts`` [n] and ``codes`` [n, W] in (after
        :meth:`wait`); returns the pinned views."""
        n, w = codes.shape
        if self.starts.numel() < n:
            self.starts = torch.empty(n, dtype=torch.int32, pin_memory=True)
        if self.codes.numel() < n * w:
            self.codes = torch.empty(n * w, dtype=torch.uint8,
                                     pin_memory=True)
        st = self.starts[:n]
        cd = self.codes[:n * w].view(n, w)
        st.copy_(torch.from_numpy(starts))
        cd.copy_(torch.from_numpy(codes))
        return st, cd


class PileupAccumulator:
    """Streaming single-device accumulator of segment batches.

    CUDA: :meth:`stage` (on the decode prefetch thread) ships each
    bucket's real rows through two pinned slots on a copy stream, and
    :meth:`add` (on the consumer) waits for them on its own stream, packs
    them on the card and launches K1.  An unstaged batch is staged by
    ``add`` itself first.  CPU: ``stage`` does nothing, and ``add`` packs
    with numpy and runs K1's plain version
    (``ops.pileup_kernel.accumulate_rows`` picks by the tensor's device).
    ``counts`` is the ``[total_len, 6]`` view.
    """

    #: pinned slots, taken in turn by the staged buckets
    SLOTS = 2

    def __init__(self, total_len: int, device):
        self.total_len = total_len
        self.device = torch.device(device)
        self.padded_len = padded_total_len(total_len)
        self._counts = torch.zeros((self.padded_len, NUM_SYMBOLS),
                                   dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(self.SLOTS)]
            self._next_slot = 0

    def stage(self, batch: SegmentBatch) -> None:
        """Ship the batch's real rows to the card (CUDA only): trim, copy
        into the next pinned slot, copy to the device ``non_blocking`` on
        the copy stream and record an event there; the results land in
        ``batch.staged`` (``None`` for a bucket with no real row).  Runs on
        the decode prefetch thread."""
        if self.device.type != "cuda":
            return
        with torch.cuda.device(self.device):
            for w, (starts, codes) in batch.buckets.items():
                n = real_rows(codes)
                if n == 0:
                    batch.staged[w] = None
                    continue
                slot = self._slots[self._next_slot]
                self._next_slot = (self._next_slot + 1) % len(self._slots)
                slot.wait()
                batch.staged[w] = self._ship(slot, *slot.fill(starts[:n],
                                                              codes[:n]))

    def _ship(self, slot: _PinnedSlot, starts: torch.Tensor,
              codes: torch.Tensor) -> StagedRows:
        """Enqueue the pinned rows' copies to the card on the copy stream
        and record their event (also the slot's ``copied``)."""
        with torch.cuda.stream(self._copy_stream):
            d_starts = starts.to(self.device, non_blocking=True)
            d_codes = codes.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        slot.copied = ready
        return StagedRows(d_starts, d_codes, ready)

    def add(self, batch: SegmentBatch) -> None:
        from .pileup_kernel import accumulate_rows

        if self.device.type == "cuda":
            if batch.buckets and not batch.staged:
                self.stage(batch)
            stream = torch.cuda.current_stream(self.device)
            for _w, rows in sorted(batch.staged.items()):
                if rows is not None:
                    self._consume(rows, stream)
            return
        for _w, (starts, codes) in sorted(batch.buckets.items()):
            n = real_rows(codes)
            if n == 0:
                continue
            st = torch.from_numpy(np.ascontiguousarray(starts[:n]))
            pk = torch.from_numpy(pack_nibbles(codes[:n]))
            accumulate_rows(self._counts, st, pk)

    def _consume(self, rows: StagedRows, stream) -> None:
        """The consumer's part of a staged bucket: a device-side wait for
        its copies, then the device pack and the K1 route, all enqueued
        on ``stream`` with no host synchronisation."""
        from .pileup_kernel import accumulate_rows

        stream.wait_event(rows.ready)
        # allocated on the copy stream, used here: the caching allocator
        # must not hand their memory out again before this stream is done
        rows.starts.record_stream(stream)
        rows.codes.record_stream(stream)
        accumulate_rows(self._counts, rows.starts, pack_codes(rows.codes))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def counts(self) -> torch.Tensor:
        """Valid counts, ``[total_len, 6]`` (tile pad rows dropped)."""
        return self._counts[: self.total_len]
