"""Position-sharded pileup with halo exchange (long genomes).

Port of ``sam2consensus_tpu/parallel/sp.py``.  The data-parallel layout
holds a full-length local tensor a shard; here the position axis itself is
sharded.  Shard ``i`` owns block ``i`` of ``B = padded_len / n`` positions
and materialises only a small local tensor.  Rows wider than the halo
``H`` are split into halo-wide pieces first (exact: segment rows are
position-contiguous).  Two strategies, picked a bucket by the span of its
rows' starts, as in the reference:

* **window**, when the rows span a narrow window (coordinate-sorted
  input): rows split evenly over the shards (no routing), each shard
  scatters its run into ``[Wp + 1, 6]`` window coordinates, one
  ``all_reduce`` sums the windows, and each shard folds the slice of the
  sum that overlaps its block (the overlap is a range the host knows);
* **routed**, otherwise: each row goes to the shard owning its start (a
  counting sort into a dense ``[n, r]`` slot grid, ``base.route_to_slots``),
  each shard counts its slots in local coordinates ``[B + H + 1, 6]``,
  and one non-wrapping ``shift`` moves each shard's halo ``[B, B + H)`` to
  the next shard's block head.  The last shard's halo covers pad
  positions only, so dropping it is exact.

The routed count runs K1 (``ops.pileup_kernel.accumulate_rows`` over the
local tensor, which drops nothing a routed row can reach) under ``--pileup
pallas`` for the widths the reference's kernel route takes
(``base.kernel_width_ok``), else the torch scatter, whose PAD cells land in
the sacrificial row ``B + H`` past the halo.  The window strategy always
scatters.  ``rows_shipped`` / ``rows_real`` count the row slots sent
against the rows received.
"""

from __future__ import annotations

import time

import numpy as np

from ..constants import NUM_SYMBOLS, PAD_CODE, SP_WINDOW_CAP
from ..encoder.events import SegmentBatch
from ..ops.pileup import round_rows_grid
from .base import (ShardedCountsBase, block_for, count_rows,
                   kernel_width_ok, real_row_mask, record_slab,
                   route_to_slots, split_wide_rows)
from .collectives import ALL, all_reduce, shift

__all__ = ["PositionShardedConsensus", "block_for"]


class PositionShardedConsensus(ShardedCountsBase):
    """Streaming position-sharded accumulate over a ``TorchMesh``.
    ``strategy_used`` counts ``window_w<W>``, ``routed_w<W>`` (scatter) or
    ``routed_pallas_w<W>`` (K1) a bucket."""

    #: copy: the largest window the window strategy materialises a shard
    WINDOW_CAP = SP_WINDOW_CAP

    def __init__(self, mesh, total_len: int, halo: int = 1 << 16,
                 pileup: str = "scatter", wire: str = "packed5"):
        super().__init__(mesh, total_len, wire=wire)
        self.halo = halo
        if self.block < halo:
            raise ValueError(
                f"position block {self.block} smaller than halo {halo}: "
                "use the DP pipeline for genomes this small")
        self.pileup = "pallas" if pileup == "pallas" else "scatter"
        self.strategy_used: dict = {}
        self.rows_shipped = 0
        self.rows_real = 0

    def _note(self, key: str) -> None:
        self.strategy_used[key] = self.strategy_used.get(key, 0) + 1

    def _window_add(self, starts, codes, real, wlo: int, wp: int,
                    w: int) -> None:
        """The window strategy over one bucket (module docstring)."""
        # pad rows pinned to wlo keep the window index in range (their
        # cells are PAD)
        starts = np.where(real, starts, wlo).astype(np.int32)
        n_rows = -(-len(starts) // self.n) * self.n
        if n_rows != len(starts):
            starts = np.concatenate(
                [starts, np.full(n_rows - len(starts), wlo, np.int32)])
            codes = np.concatenate(
                [codes, np.full((n_rows - len(codes), w), PAD_CODE,
                                dtype=np.uint8)])
        rows = self.put_rows((starts - wlo).astype(np.int32), codes)
        self.rows_shipped += n_rows
        local = self.zeros(wp + 1)
        for i, (st, cd) in self.owned(rows):
            count_rows(local[i], st, cd, False, wp)
        win = all_reduce(self.mesh, [None if t is None else t[:wp]
                                     for t in local], ALL)
        for i, blk in self.owned(self.blocks):
            lo = i * self.block
            a, b = max(lo, wlo), min(lo + self.block, wlo + wp)
            if a < b:
                blk[a - lo:b - lo].add_(win[i][a - wlo:b - wlo])

    def _routed_add(self, starts, codes, w: int) -> str:
        """The routed strategy over one bucket's real rows; returns the
        strategy key."""
        block, halo, n = self.block, self.halo, self.n
        dev = starts // block
        per_dev = np.bincount(dev, minlength=n)
        r = round_rows_grid(int(per_dev.max(initial=1)))
        s_grid, c_grid = route_to_slots(dev, n, r, starts, codes,
                                        np.arange(n) * block)
        s_local = (s_grid - (np.arange(n) * block)[:, None]).astype(np.int32)
        kernel = self.pileup == "pallas" and kernel_width_ok(w)
        rows = self.put_rows(s_local.reshape(-1), c_grid.reshape(-1, w))
        self.rows_shipped += n * r
        local = self.zeros(block + halo + 1)
        for i, (st, cd) in self.owned(rows):
            count_rows(local[i], st, cd, kernel, block + halo)
        for i, blk in self.owned(self.blocks):
            blk.add_(local[i][:block])
        shift(self.mesh, [None if t is None else t[block:block + halo]
                          for t in local], ALL, out=self.blocks)
        return f"routed_pallas_w{w}" if kernel else f"routed_w{w}"

    def add(self, batch: SegmentBatch) -> None:
        from ..resilience.faultinject import fault_check

        fault_check("pileup_dispatch")
        for w, (starts, codes) in sorted(batch.buckets.items()):
            t0 = time.perf_counter()
            starts = np.asarray(starts)
            codes = np.asarray(codes)
            if self.wire == "delta8":
                from ..wire.codec import canonicalize_rows

                starts, codes = canonicalize_rows(starts, codes)
            if w > self.halo:
                starts, codes, w = split_wide_rows(
                    starts, codes, w, self.halo, self.padded_len)
            self.rows_real += len(starts)
            real = real_row_mask(starts, codes)
            if not real.any():
                continue               # nothing but pad rows
            wlo = int(starts[real].min())
            span = int(starts[real].max()) + w - wlo
            wp = 1 << max(10, (span - 1).bit_length())
            # the window's all_reduce moves wp * 24 bytes a shard: only
            # within a small multiple of the bucket's own row bytes
            dense_enough = wp * NUM_SYMBOLS * 4 <= 16 * len(starts) * w
            if dense_enough and wp <= min(self.WINDOW_CAP, self.padded_len):
                self._window_add(starts, codes, real, wlo, wp, w)
                key = f"window_w{w}"
            else:
                # the encoder's pad rows count nothing: route only real
                # rows (grid rounding bounds the shapes without them)
                key = self._routed_add(starts[real], codes[real], w)
            self._note(key)
            record_slab(key, t0, len(starts), w)
