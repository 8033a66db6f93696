"""The dp x sp product layout: read shards x position blocks on a 2-D mesh.

Port of ``sam2consensus_tpu/parallel/dpsp.py``.  Reads split evenly into
``n_dp`` runs, with no routing across dp; within each run, rows route among
only ``n_sp`` macro blocks of ``B_sp = padded_len / n_sp`` positions
(``base.route_to_slots``).  Shard ``(d, s)`` counts run ``d``'s rows for
macro block ``s`` into a local ``[B_sp + H + 1, 6]`` tensor (K1 under
``--pileup pallas`` for the widths the reference's kernel route takes, the
MXU route under ``--pileup mxu`` as sp's routed one, over
``base.mxu_grid_plans``, else the torch scatter); one ``shift`` over
``sp`` moves each halo to the
next macro block within its dp run; then one ``reduce_scatter`` over
``dp`` sums the runs and leaves shard ``(d, s)`` sub-block ``d`` of macro
block ``s``: global block ``s * n_dp + d``, the ``("sp", "dp")`` position
layout the base threads through the state and the tail.
"""

from __future__ import annotations

import time

import numpy as np

from ..encoder.events import SegmentBatch
from ..ops.pileup import round_rows_grid
from .base import (ShardedCountsBase, count_rows, kernel_width_ok,
                   mxu_grid_plans, real_row_mask, record_slab,
                   route_to_slots, split_wide_rows)
from .collectives import reduce_scatter, shift

__all__ = ["ProductShardedConsensus"]


class ProductShardedConsensus(ShardedCountsBase):
    """Streaming dp x sp accumulate over a 2-D ``TorchMesh``.
    ``strategy_used`` counts ``dpsp_w<W>`` (scatter), ``dpsp_pallas_w<W>``
    (K1) or ``dpsp_mxu_w<W>`` a bucket."""

    def __init__(self, mesh, total_len: int, halo: int = 1 << 16,
                 pileup: str = "scatter", wire: str = "packed5"):
        super().__init__(mesh, total_len, pos_axes=("sp", "dp"), wire=wire)
        self.n_dp = mesh.shape["dp"]
        self.n_sp = mesh.shape["sp"]
        if self.n_dp < 2 or self.n_sp < 2:
            raise ValueError(
                f"dp x sp product mode needs a true 2-D mesh, got "
                f"dp={self.n_dp} x sp={self.n_sp}; use --shard-mode dp "
                f"or sp on a 1-D mesh")
        self.halo = halo
        self.block_sp = self.padded_len // self.n_sp    # macro block
        if self.block_sp < halo:
            raise ValueError(
                f"macro position block {self.block_sp} smaller than halo "
                f"{halo}: use the DP pipeline for genomes this small")
        self.pileup = pileup if pileup in ("mxu", "pallas") else "scatter"
        self.strategy_used: dict = {}
        self.rows_shipped = 0
        self.rows_real = 0

    def add(self, batch: SegmentBatch) -> None:
        from ..resilience.faultinject import fault_check

        fault_check("pileup_dispatch")
        n_dp, n_sp, block_sp, halo = (self.n_dp, self.n_sp, self.block_sp,
                                      self.halo)
        for w, (starts, codes) in sorted(batch.buckets.items()):
            t0 = time.perf_counter()
            starts = np.asarray(starts)
            codes = np.asarray(codes)
            if self.wire == "delta8":
                from ..wire.codec import canonicalize_rows

                starts, codes = canonicalize_rows(starts, codes)
            if w > halo:
                starts, codes, w = split_wide_rows(
                    starts, codes, w, halo, self.padded_len)
            self.rows_real += len(starts)
            if self.pileup != "scatter":
                # the encoder's pad rows count nothing and would only
                # crowd shard (0, 0)
                keep = real_row_mask(starts, codes)
                if not keep.all():
                    starts, codes = starts[keep], codes[keep]
                if len(starts) == 0:
                    continue
            # dp: even contiguous runs; within each, a counting sort over
            # the n_sp macro blocks (the slot grid sized by the fullest
            # (run, block) pair on the eighth-power-of-two grid)
            n_rows = len(starts)
            per_dp = -(-n_rows // n_dp)
            macro = np.minimum(starts // block_sp, n_sp - 1)
            counts_dm = np.zeros((n_dp, n_sp), dtype=np.int64)
            for d in range(n_dp):
                lo, hi = d * per_dp, min((d + 1) * per_dp, n_rows)
                if lo < hi:
                    counts_dm[d] = np.bincount(macro[lo:hi],
                                               minlength=n_sp)
            r = round_rows_grid(int(counts_dm.max(initial=1)))
            pins = np.arange(n_sp, dtype=np.int32) * block_sp
            s_routed = np.empty((n_dp, n_sp, r), dtype=np.int32)
            c_routed = np.empty((n_dp, n_sp, r, w), dtype=np.uint8)
            for d in range(n_dp):
                lo, hi = d * per_dp, min((d + 1) * per_dp, n_rows)
                s_routed[d], c_routed[d] = route_to_slots(
                    macro[lo:hi], n_sp, r, starts[lo:hi], codes[lo:hi],
                    pins)
            # flat shard order (d, s) is the grid's own order
            s_local = (s_routed - pins[None, :, None]).astype(
                np.int32).reshape(self.n, r)
            c_local = c_routed.reshape(self.n, r, w)
            local = self.zeros(block_sp + halo + 1)
            plans = mxu_grid_plans(s_local, counts_dm.reshape(-1), w,
                                   block_sp + halo + 1) \
                if self.pileup == "mxu" else None
            if plans is not None:
                self.mxu_count(local, plans, s_local, c_local, w)
                key = f"dpsp_mxu_w{w}"
            else:
                kernel = self.pileup == "pallas" and kernel_width_ok(w)
                rows = self.put_rows(s_local.reshape(-1),
                                     c_local.reshape(-1, w))
                for i, (st, cd) in self.owned(rows):
                    count_rows(local[i], st, cd, kernel, block_sp + halo)
                key = f"dpsp_pallas_w{w}" if kernel else f"dpsp_w{w}"
            self.rows_shipped += self.n * r
            acc = [None if t is None else t[:block_sp] for t in local]
            shift(self.mesh, [None if t is None else
                              t[block_sp:block_sp + halo] for t in local],
                  ("sp",), out=acc)
            reduce_scatter(self.mesh, acc, ("dp",), out=self.blocks)
            self.strategy_used[key] = self.strategy_used.get(key, 0) + 1
            record_slab(key, t0, len(starts), w)
