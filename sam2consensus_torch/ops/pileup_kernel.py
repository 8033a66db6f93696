"""K1 launch wrapper: the pileup histogram kernel (``csrc/pileup.cu``).

Replaces ``sam2consensus_tpu/ops/pallas_pileup.py``.  The plan keeps that
module's logic (``plan_rows``: counting-sort rows by position tile, a CSR
range of rows per tile) re-parameterised for the card:

* ``K1_TILE`` = 8192 positions: the block's int32 ``[TILE, 6]``
  shared histogram is 192 KiB of the 227 KiB a Hopper block may use (the
  TPU tile of 2^17 positions x 8 lanes is 4 MiB);
* a tile's rows are cut into work items of at most ``ITEM_BYTES`` packed
  bytes, one CUDA block each, so a deep tile (an amplicon) spreads over
  many SMs instead of one;
* the plan is built with torch ops on the rows' own device; the sorted
  order is a row gather (the JAX path's ``.at[rank].set``).

No ordered overhang carry and no width limit: a cell past its tile goes
straight to device memory (see the kernel's note).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.build import Kernel
from .pileup import scatter_segments_packed

#: positions per K1 tile (not ``ops.pileup.TILE_POSITIONS``, the count
#: tensor's padding unit)
K1_TILE = 8192
ITEM_BYTES = 1 << 16

K1 = Kernel("pileup_tiles", "pileup.cu")


class RowPlan(NamedTuple):
    """Tile-sorted row order plus one work item per block."""
    order: torch.Tensor      # [N] int64: sorted row r is input row order[r]
    item_tile: torch.Tensor  # [NI] int32 tile of each work item
    item_lo: torch.Tensor    # [NI] int32 first sorted row
    item_hi: torch.Tensor    # [NI] int32 end sorted row
    n_tiles: int


def plan_rows(starts: torch.Tensor, width_bytes: int, n_pos: int,
              tile: int = K1_TILE,
              item_bytes: int = ITEM_BYTES) -> RowPlan:
    """Counting-sort rows by tile; cut each tile's row range into items of
    at most ``item_bytes`` packed bytes (at least one row)."""
    dev = starts.device
    n_tiles = max(1, -(-n_pos // tile))
    tile_of = starts.long() // tile
    order = torch.argsort(tile_of, stable=True)
    per_tile = torch.bincount(tile_of, minlength=n_tiles)
    hi = per_tile.cumsum(0)
    lo = hi - per_tile
    rows_per_item = max(1, item_bytes // max(1, width_bytes))
    n_items = (per_tile + rows_per_item - 1) // rows_per_item
    item_tile = torch.repeat_interleave(
        torch.arange(len(per_tile), device=dev), n_items)
    first = (n_items.cumsum(0) - n_items)[item_tile]
    j = torch.arange(len(item_tile), device=dev) - first
    item_lo = lo[item_tile] + j * rows_per_item
    item_hi = torch.minimum(item_lo + rows_per_item, hi[item_tile])
    return RowPlan(order, item_tile.int(), item_lo.int(), item_hi.int(),
                   n_tiles)


def accumulate_rows(counts: torch.Tensor, starts: torch.Tensor,
                    packed: torch.Tensor) -> torch.Tensor:
    """``counts[start_r + j, code_r[j]] += 1`` over nibble-packed rows, in
    place; returns ``counts``.

    ``counts`` int32 ``[P, 6]``, ``starts`` int32 ``[N]`` (>= 0),
    ``packed`` uint8 ``[N, W/2]``.  On CUDA tensors this launches K1 (or
    raises); on CPU tensors it runs the plain version."""
    if counts.device.type == "cpu":
        return scatter_segments_packed(counts, starts, packed)
    if (counts.dtype != torch.int32 or counts.dim() != 2
            or counts.shape[1] != 6 or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int32 [P, 6] tensor")
    if starts.dtype != torch.int32 or packed.dtype != torch.uint8 \
            or packed.dim() != 2 or starts.shape[0] != packed.shape[0]:
        raise ValueError("starts must be int32 [N], packed uint8 [N, W/2]")
    if starts.device != counts.device or packed.device != counts.device:
        raise ValueError("counts, starts and packed must share a device")
    n, wb = packed.shape
    if n == 0 or wb == 0:
        return counts
    plan = plan_rows(starts, wb, counts.shape[0])
    st = starts.index_select(0, plan.order).contiguous()
    pk = packed.index_select(0, plan.order).contiguous()
    K1.launch(st, pk, plan.item_tile, plan.item_lo, plan.item_hi, K1_TILE,
              counts)
    return counts
