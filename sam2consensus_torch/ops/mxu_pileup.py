"""MXU pileup: the segment-row scatter recast as one-hot tile products.

Port of ``sam2consensus_tpu/ops/mxu_pileup.py`` (``--pileup mxu``).  The
host counting-sorts rows by position tile (``start // TP``) and gives each
row a slot in a layout where every tile holds ``E`` rows (:func:`plan_slots`);
on the device, per tile, two one-hot matrices ``M[r, d] = [loc_r == d]``
(``[E, TP]``) and ``C[r, j*6 + b] = [code_r[j] == b]`` (``[E, 6W]``) contract
over the rows, ``T = M^T @ C`` (``[TP, 6W]``), which is exactly
``T[d, j, b] = #{rows starting at d whose j-th cell is base b}``.  The
diagonal fold ``counts[d + j, b] += T[d, j, b]`` is the reshape trick of
:func:`_skew_fold`, and each tile's overhang (rows reach up to ``W - 1``
positions past their tile) is overlap-added into the next tile's range.

The host planning (:data:`TILE_POSITIONS`, :data:`MAX_BLOWUP`,
:data:`TILE_CHUNK`, :class:`TilePlan`, :func:`_plan_prelude`,
:func:`plan_tiles`, :class:`SlotPlan`, :func:`assign_slots`,
:func:`plan_slots`) is a copy, pinned by ``tests/test_torch_copies.py``,
pow2 ``coarse`` grid included, so that E, the blowup and the skew fallback
fall on the same slabs as in the reference.

The device part is torch.  The tile product is one ``torch.bmm`` over a
chunk of tiles on float32 one-hots: 0 and 1 are exact in float32 and in
TF32, and a product cell is at most ``E`` (< 2^24, held exactly by float32
accumulation), so the product is exact whatever the process's TF32 setting
(left as the caller set it); it is converted to int32 before the fold.
Half-precision one-hots would be wrong: cuBLAS returns them in their own
dtype, which holds integers exactly only up to 2,048 (fp16) or 256 (bf16).
The chunk of tiles is sized by a byte budget, :data:`MXU_BUDGET_BYTES`
(512 MiB of live one-hots, products and fold copies): one tile's product is
``TP * 6W * 4`` bytes (6.3 MB at W = 128), so the reference's fixed
32-tile chunk would hold 25.8 GB at 16,384-wide rows.  A row wider than a
tile is folded in column blocks of ``TP`` cells, and a tile of more rows
than the budget holds is multiplied in row blocks; neither changes a count.
The count tensor is updated in place, with no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import NUM_SYMBOLS, PAD_CODE

#: copy: positions a tile
TILE_POSITIONS = 2048

#: copy: fall back to scatter when per-tile padding would inflate rows this
#: much
MAX_BLOWUP = 4.0

#: copy: the reference's tiles a ``lax.map`` step (the port sizes its chunk
#: by :data:`MXU_BUDGET_BYTES` instead)
TILE_CHUNK = 32

#: the live bytes one step of :func:`_accumulate_tiles` may hold: the
#: chunk's one-hots, its float32 and int32 products and the fold's padded
#: copy
MXU_BUDGET_BYTES = 1 << 29


class TilePlan(NamedTuple):
    """Copy: host-side plan, rows tile-sorted and densely padded per tile."""
    loc: np.ndarray        # [NT*E] int32 tile-local starts, flat
    codes: np.ndarray      # [NT*E*W] uint8 code rows, flat (PAD-filled)
    n_tiles: int
    rows_per_tile: int     # E
    width: int
    blowup: float          # padded rows / real rows


def _plan_prelude(starts: np.ndarray, padded_len: int, tile: int,
                  max_blowup: float, rows_per_tile: Optional[int],
                  coarse: bool = False):
    """Copy: tile histogram, E selection and the blowup gate; ``(n_tiles,
    tile_of, per_tile, e, blowup)``, or None with no rows or past
    ``max_blowup`` (checked before any padded array is allocated)."""
    n = len(starts)
    if n == 0:
        return None
    n_tiles = max(1, -(-padded_len // tile))
    tile_of = starts // tile
    per_tile = np.bincount(tile_of, minlength=n_tiles)
    if rows_per_tile is None:
        # the fine eighth-power-of-two grid; ``coarse`` keeps the full
        # power-of-two grid (the autotuner's timing phase)
        from .pileup import round_rows_grid, round_rows_pow2

        e_fine = round_rows_grid(int(per_tile.max()))
        e = round_rows_pow2(e_fine) if coarse else e_fine
        # the gate and the reported blowup price the fine grid
        if n_tiles * e_fine / n > max_blowup:
            return None
        blowup = n_tiles * e_fine / n
    else:
        e = rows_per_tile
        if int(per_tile.max(initial=0)) > e:
            return None
        if n_tiles * e / n > max_blowup:
            return None
        blowup = n_tiles * e / n
    return n_tiles, tile_of, per_tile, e, blowup


def plan_tiles(starts: np.ndarray, codes: np.ndarray, padded_len: int,
               tile: int = TILE_POSITIONS,
               max_blowup: float = MAX_BLOWUP,
               rows_per_tile: Optional[int] = None) -> Optional[TilePlan]:
    """Copy: counting-sort rows by position tile into host-padded arrays
    (the padded-transfer layout; :func:`plan_slots` is the route's)."""
    pre = _plan_prelude(starts, padded_len, tile, max_blowup, rows_per_tile)
    if pre is None:
        return None
    n_tiles, tile_of, per_tile, e, blowup = pre
    n = len(starts)
    width = codes.shape[1]

    order = np.argsort(tile_of, kind="stable")
    s_sorted = starts[order]
    c_sorted = codes[order]
    loc = np.zeros(n_tiles * e, dtype=np.int32)
    cod = np.full((n_tiles * e, width), 255, dtype=np.uint8)
    hi = np.cumsum(per_tile)
    lo = hi - per_tile
    tile_sorted = tile_of[order]
    slot = tile_sorted * e + (np.arange(n) - lo[tile_sorted])
    loc[slot] = (s_sorted - tile_sorted * tile).astype(np.int32)
    cod[slot] = c_sorted
    return TilePlan(loc, cod.reshape(-1), n_tiles, e, width, blowup)


class SlotPlan(NamedTuple):
    """Copy: one int32 slot a row (the padded layout is built on the
    device, so the rows cross at their compact bytes plus 4 B a row)."""
    slot: np.ndarray       # [N] int32, unique: tile_of * E + rank-in-tile
    n_tiles: int
    rows_per_tile: int     # E
    width: int
    blowup: float          # device-side padded rows / real rows


def assign_slots(tile_of: np.ndarray, per_tile: np.ndarray,
                 e: int) -> np.ndarray:
    """Copy: rank each row within its tile, ``slot = tile_of * E + rank``."""
    n = len(tile_of)
    order = np.argsort(tile_of, kind="stable")
    hi = np.cumsum(per_tile)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - (hi - per_tile)[tile_of[order]]
    return (tile_of * e + rank).astype(np.int32)


def plan_slots(starts: np.ndarray, width: int, padded_len: int,
               tile: int = TILE_POSITIONS,
               max_blowup: float = MAX_BLOWUP,
               rows_per_tile: Optional[int] = None,
               coarse: bool = False) -> Optional[SlotPlan]:
    """Copy: each row's padded-layout slot (a counting sort, no copies);
    None on skew, as :func:`plan_tiles`."""
    pre = _plan_prelude(starts, padded_len, tile, max_blowup, rows_per_tile,
                        coarse)
    if pre is None:
        return None
    n_tiles, tile_of, per_tile, e, blowup = pre
    return SlotPlan(assign_slots(tile_of, per_tile, e),
                    n_tiles, e, width, blowup)


# -- the device part ------------------------------------------------------------
def _skew_fold(t4: torch.Tensor) -> torch.Tensor:
    """``[c, TP, W, 6]`` -> ``[c, TP + W, 6]``: ``out[q] = sum_j t[q - j,
    j]`` by the reshape trick (pad each j-plane by W, flatten, re-view
    shifted by one, sum the planes)."""
    c, tp, w, k = t4.shape
    a = torch.nn.functional.pad(t4.permute(0, 2, 1, 3), (0, 0, 0, w))
    m = tp + w                                          # a: [c, W, m, 6]
    d = a.reshape(c, w * m, k)[:, : w * (m - 1)].reshape(c, w, m - 1, k)
    out = d.sum(dim=1, dtype=t4.dtype)                  # [c, m - 1, 6]
    return torch.nn.functional.pad(out, (0, 0, 0, 1))


def _add_fold(counts: torch.Tensor, fold: torch.Tensor, t0: int, j0: int,
              tile: int) -> None:
    """``counts[t * tile + j0 + q] += fold[t - t0, q]`` for the chunk's
    tiles: each tile's first ``tile`` positions end to end, its overhang
    overlap-added into the next tile's; positions past ``counts`` are
    dropped (no valid cell reaches them)."""
    c, m, k = fold.shape
    out = fold.new_zeros(((c + 1) * tile, k))
    out[: c * tile] = fold[:, :tile].reshape(-1, k)
    out[tile:].view(c, tile, k)[:, : m - tile] += fold[:, tile:]
    lo = t0 * tile + j0
    n = min(out.shape[0], counts.shape[0] - lo)
    if n > 0:
        counts[lo: lo + n] += out[:n]


def _chunking(rows_per_tile: int, tile: int, block_w: int):
    """``(tiles a chunk, rows a block)`` within :data:`MXU_BUDGET_BYTES`:
    the float32 and boolean one-hots cost ``5 * (tile + 6 * block_w)``
    bytes a row, the float32 and int32 products and the fold's padded copy
    ``4 * (12 * tile * block_w + 6 * block_w * (tile + block_w))`` a
    tile."""
    per_row = 5 * (tile + NUM_SYMBOLS * block_w)
    per_tile = 4 * (2 * NUM_SYMBOLS * tile * block_w
                    + NUM_SYMBOLS * block_w * (tile + block_w))
    rows = min(rows_per_tile,
               max(8, (MXU_BUDGET_BYTES - per_tile) // per_row))
    chunk = max(1, MXU_BUDGET_BYTES // (per_tile + rows * per_row))
    return chunk, rows


def _accumulate_tiles(counts: torch.Tensor, loc: torch.Tensor,
                      cod: torch.Tensor, *, tile: int, n_tiles: int,
                      rows_per_tile: int, width: int) -> torch.Tensor:
    """The tile body of every layout, in place: ``loc`` ``[NT, E]``
    tile-local starts, ``cod`` ``[NT, E, W]`` code rows (any code past the
    alphabet one-hots to zero).  Position ``p`` of tile ``t`` lands on
    ``counts[t * tile + p]`` (cut at ``counts``' length)."""
    assert rows_per_tile < (1 << 24), (
        f"{rows_per_tile} rows a tile: float32 products are exact only "
        f"below 2^24")
    dev = counts.device
    d = torch.arange(tile, dtype=loc.dtype, device=dev)
    b6 = torch.arange(NUM_SYMBOLS, dtype=cod.dtype, device=dev)
    block_w = min(width, tile)
    chunk, rows = _chunking(rows_per_tile, tile, block_w)
    for t0 in range(0, n_tiles, chunk):
        t1 = min(n_tiles, t0 + chunk)
        for j0 in range(0, width, block_w):
            j1 = min(width, j0 + block_w)
            prod = None
            for r0 in range(0, rows_per_tile, rows):
                r1 = min(rows_per_tile, r0 + rows)
                m = (loc[t0:t1, r0:r1, None] == d).to(torch.float32)
                oh = (cod[t0:t1, r0:r1, j0:j1, None] == b6).to(
                    torch.float32).reshape(t1 - t0, r1 - r0, -1)
                if prod is None:
                    prod = torch.bmm(m.transpose(1, 2), oh)
                else:
                    prod.baddbmm_(m.transpose(1, 2), oh)
                del m, oh
            t4 = prod.to(torch.int32).view(t1 - t0, tile, j1 - j0,
                                           NUM_SYMBOLS)
            del prod
            _add_fold(counts, _skew_fold(t4), t0, j0, tile)
    return counts


def build_padded_layout(starts: torch.Tensor, codes: torch.Tensor,
                        slot: torch.Tensor, *, tile: int, n_tiles: int,
                        rows_per_tile: int, width: int):
    """Compact rows + slot -> ``(loc [NT, E] int32, cod [NT, E, W] uint8)``
    on the rows' device: one row scatter by slot; slots the rows do not
    fill stay PAD at start 0 and count nothing.  Slots may repeat only
    between identical all-PAD rows (the sharded routers' pad slots), so
    the scatter's order cannot change the layout.

    Only even widths may reach this layout, as in the reference: an odd
    (halo-split) row gains a PAD column under the nibble wire and would be
    mis-laid against ``width``."""
    assert width % 2 == 0, (
        f"MXU packed layout requires an even row width, got {width}: "
        f"odd (halo-split) rows unpack to width+1 and must stay on the "
        f"scatter path")
    e = rows_per_tile
    dev = starts.device
    slot = slot.long()
    tile_of = slot // e
    loc = torch.zeros(n_tiles * e, dtype=torch.int32, device=dev)
    loc.index_put_((slot,), (starts.long() - tile_of * tile).to(torch.int32))
    cod = torch.full((n_tiles * e, width), PAD_CODE, dtype=torch.uint8,
                     device=dev)
    cod.index_put_((slot,), codes)
    return loc.view(n_tiles, e), cod.view(n_tiles, e, width)


def pileup_mxu(counts: torch.Tensor, loc_flat: torch.Tensor,
               codes_flat: torch.Tensor, *, tile: int, n_tiles: int,
               rows_per_tile: int, width: int) -> torch.Tensor:
    """The padded-transfer layout (:class:`TilePlan`, flat operands),
    accumulated into ``counts`` in place; returns ``counts``."""
    loc = loc_flat.view(n_tiles, rows_per_tile)
    cod = codes_flat.view(n_tiles, rows_per_tile, width)
    return _accumulate_tiles(counts, loc, cod, tile=tile, n_tiles=n_tiles,
                             rows_per_tile=rows_per_tile, width=width)


def pileup_mxu_compact(counts: torch.Tensor, starts: torch.Tensor,
                       codes: torch.Tensor, slot: torch.Tensor, *, tile: int,
                       n_tiles: int, rows_per_tile: int,
                       width: int) -> torch.Tensor:
    """The compact layout (:class:`SlotPlan`): int32 starts ``[N]``, uint8
    codes ``[N, W]`` and slots ``[N]``, laid out on the device and
    accumulated into ``counts`` in place; returns ``counts``."""
    loc, cod = build_padded_layout(starts, codes, slot, tile=tile,
                                   n_tiles=n_tiles,
                                   rows_per_tile=rows_per_tile, width=width)
    return _accumulate_tiles(counts, loc, cod, tile=tile, n_tiles=n_tiles,
                             rows_per_tile=rows_per_tile, width=width)


def pileup_mxu_packed(counts: torch.Tensor, starts: torch.Tensor,
                      packed: torch.Tensor, slot: torch.Tensor, *, tile: int,
                      n_tiles: int, rows_per_tile: int,
                      width: int) -> torch.Tensor:
    """:func:`pileup_mxu_compact` over nibble-packed rows (uint8 ``[N,
    W/2]``): the unpacked PAD nibble (15) one-hots to zero as PAD does."""
    from .pileup import unpack_nibbles

    return pileup_mxu_compact(counts, starts, unpack_nibbles(packed), slot,
                              tile=tile, n_tiles=n_tiles,
                              rows_per_tile=rows_per_tile, width=width)
