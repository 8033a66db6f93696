"""Device pileup: segment rows accumulated into an ``[L, 6]`` int32 tensor.

Port of the single-device path of ``sam2consensus_tpu/ops/pileup.py``.
Rows (``encoder.events.SegmentBatch``) ship 4-bit packed (two codes per
byte); on CUDA each slab goes through the hand-written histogram kernel
(K1, ``ops/pileup_kernel.py``), on the CPU through its plain PyTorch
version :func:`scatter_segments_packed`.  The count tensor is updated in
place (no second ``[L, 6]`` buffer per slab).
"""

from __future__ import annotations

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


class PileupAccumulator:
    """Streaming single-device accumulator of segment batches.

    ``add`` ships each bucket's real rows (starts int32 + packed codes) to
    the device and accumulates them: K1 on CUDA, its plain version on the
    CPU (``ops.pileup_kernel.accumulate_rows`` picks by the tensor's
    device).  ``counts`` is the ``[total_len, 6]`` view.
    """

    def __init__(self, total_len: int, device):
        self.total_len = total_len
        self.device = torch.device(device)
        self.padded_len = padded_total_len(total_len)
        self._counts = torch.zeros((self.padded_len, NUM_SYMBOLS),
                                   dtype=torch.int32, device=self.device)

    def add(self, batch: SegmentBatch) -> None:
        from .pileup_kernel import accumulate_rows

        for _w, (starts, codes) in sorted(batch.buckets.items()):
            n = real_rows(codes)
            if n == 0:
                continue
            st = torch.from_numpy(np.ascontiguousarray(starts[:n])).to(
                self.device)
            pk = torch.from_numpy(pack_nibbles(codes[:n])).to(self.device)
            accumulate_rows(self._counts, st, pk)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def counts(self) -> torch.Tensor:
        """Valid counts, ``[total_len, 6]`` (tile pad rows dropped)."""
        return self._counts[: self.total_len]
