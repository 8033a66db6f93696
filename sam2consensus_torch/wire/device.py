"""Device-side ``delta8`` unpack as torch ops: wire lanes -> the rows the
stager would have shipped raw.

Port of ``_decode_chunk`` / ``_decode_to_packed`` of
``sam2consensus_tpu/wire/device.py``.  :func:`decode_slab` returns int32
starts ``[S]`` and raw uint8 codes ``[S, W]`` (PAD 255), the operands the
stager delivers under ``packed5``; the consumer then packs the nibbles
(``ops.pileup.pack_codes``) and runs the pileup, as for an uncompressed
slab.  The work, per chunk of ``R`` rows: a prefix sum of the deltas (the
escaped ones gathered from the escape lane by their running rank), a
2-bit expand of the ACGT planes, a column-vs-trailing-length mask that
restores the PAD tail, and a scatter of the non-ACGT cells.

Every shape comes from the lanes' shapes, nothing is read back, and the
escape scatter's pad entries (index ``R*W``) land in one sacrificial cell
past the rows rather than being filtered, so the unpack makes no host
synchronisation.  The uint16 lanes cross the link as int16 bits (torch's
uint16 has few CUDA ops) and are widened to int32 on the device here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import PAD_CODE
from ..ops.vote import device_lut
from .codec import DELTA_ESCAPE, WIRE2_TO_CODE


def wire_lane(lane: np.ndarray) -> np.ndarray:
    """The host array that crosses the link for one lane: uint16 lanes as
    their int16 bits (:func:`widen` undoes it on the device), the others
    as they are."""
    return lane.view(np.int16) if lane.dtype == np.uint16 else lane


def widen(lane: torch.Tensor, unsigned16: bool) -> torch.Tensor:
    """An integer lane as int32; ``unsigned16``: the lane holds uint16
    values as int16 bits."""
    wide = lane.to(torch.int32)
    return wide & 0xFFFF if unsigned16 else wide


def decode_slab(d8: torch.Tensor, esc_delta: torch.Tensor,
                trail: torch.Tensor, base2: torch.Tensor,
                esc_idx: torch.Tensor, esc_code: torch.Tensor, width: int,
                sentinel: int, u16: tuple = (False, False, False)):
    """Decode a slab's lanes (``codec.WireSlab.arrays()`` order, on one
    device) to ``(starts int32 [C*R], codes uint8 [C*R, width])``.
    ``u16`` says which of ``esc_delta``, ``trail`` and ``esc_idx`` hold
    uint16 values as int16 bits."""
    c, r = d8.shape
    dev = d8.device
    esc_delta = widen(esc_delta, u16[0])
    trail = widen(trail, u16[1])
    esc_idx = widen(esc_idx, u16[2])

    esc = d8 == DELTA_ESCAPE
    rank = torch.cumsum(esc.to(torch.int32), dim=1, dtype=torch.int32) - 1
    gathered = torch.gather(
        esc_delta, 1, rank.clamp(0, esc_delta.shape[1] - 1).long())
    delta = torch.where(esc, gathered, d8.to(torch.int32))
    starts = torch.cumsum(delta, dim=1, dtype=torch.int32)

    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
    two = (base2.unsqueeze(-1) >> shifts) & 3             # [C, R, Bq, 4]
    lane = device_lut(WIRE2_TO_CODE, dev)[two.reshape(c, r, -1)[:, :, :width].long()]
    if lane.shape[2] < width:
        # the planes are only as wide as the slab's longest payload
        lane = torch.nn.functional.pad(lane, (0, width - lane.shape[2]),
                                       value=PAD_CODE)
    nlen = torch.where(trail == sentinel, 0, width - trail)
    col = torch.arange(width, dtype=torch.int32, device=dev)
    codes = torch.where(col < nlen.unsqueeze(-1), lane, PAD_CODE)
    # non-ACGT cells; pad entries (index R*W) write the sacrificial cell
    flat = torch.nn.functional.pad(codes.reshape(c, r * width), (0, 1),
                                   value=PAD_CODE)
    flat.scatter_(1, esc_idx.long().clamp(max=r * width), esc_code)
    return (starts.reshape(-1),
            flat[:, :r * width].reshape(c * r, width))

