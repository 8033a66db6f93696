"""Data-parallel sharded pileup: full-length local counts, reduce-scatter.

Port of ``sam2consensus_tpu/parallel/dp.py``.  The count tensor is a sum
of per-read contributions, so data parallelism plus one reduction is
exact.  Each bucket of a batch splits into ``n`` even runs of rows (padded
with all-PAD rows at start 0), run ``i`` to shard ``i``
(``ShardedCountsBase.put_rows``); each shard counts its run into a
full-length local ``[padded_len, 6]`` tensor (global starts), and one
``reduce_scatter`` over the flattened ring both sums the locals and leaves
each shard its own block, added into its resident counts.  On a
process-spanning mesh every process splits the same rows the same way and
ships and counts only its own shards' runs.  The vote then
runs on the blocks (``ShardedCountsBase.vote``).

``pileup`` picks each shard's count: ``pallas`` and ``auto`` run K1
(``ops.pileup_kernel.accumulate_rows``; on the CPU its plain version), as
the port's single-device ``auto`` does on the card (the reference's
``auto`` runs ``PileupAutoTuner``, which the port does not have yet);
``scatter`` runs the torch scatter.  A width the reference's kernel route
refuses (``base.kernel_width_ok``) rides the scatter under every choice.
``mxu`` is refused by name.
"""

from __future__ import annotations

import time

import numpy as np

from ..constants import PAD_CODE
from ..encoder.events import SegmentBatch
from .base import (ShardedCountsBase, count_rows, kernel_width_ok,
                   record_slab)
from .collectives import ALL, reduce_scatter

__all__ = ["ShardedConsensus", "ALL"]


class ShardedConsensus(ShardedCountsBase):
    """Streaming data-parallel accumulate over a ``TorchMesh``.
    ``strategy_used`` counts ``<pallas|scatter>_w<W>`` a bucket."""

    def __init__(self, mesh, total_len: int, pileup: str = "auto",
                 wire: str = "packed5"):
        super().__init__(mesh, total_len, wire=wire)
        if pileup == "mxu":
            raise ValueError("--pileup mxu: not supported by the torch "
                             "backend yet")
        if pileup not in ("auto", "pallas", "scatter"):
            raise ValueError(f"dp pileup {pileup!r}: use auto, pallas or "
                             f"scatter")
        self.pileup = pileup
        self.strategy_used: dict = {}

    def add(self, batch: SegmentBatch) -> None:
        from ..resilience.faultinject import fault_check
        from ..wire.codec import canonicalize_rows

        fault_check("pileup_dispatch")
        for w, (starts, codes) in sorted(batch.buckets.items()):
            t0 = time.perf_counter()
            starts = np.asarray(starts)
            codes = np.asarray(codes)
            if self.wire == "delta8":
                # canonical (sorted) rows keep each shard's delta chain
                # uint8-tight
                starts, codes = canonicalize_rows(starts, codes)
            n_rows = len(starts)
            target = -(-n_rows // self.n) * self.n
            if target != n_rows:
                starts = np.concatenate(
                    [starts, np.zeros(target - n_rows, dtype=np.int32)])
                codes = np.concatenate(
                    [codes, np.full((target - n_rows, w), PAD_CODE,
                                    dtype=np.uint8)])
            kernel = self.pileup != "scatter" and kernel_width_ok(w)
            key = "pallas" if kernel else "scatter"
            rows = self.put_rows(starts.astype(np.int32), codes)
            local = self.zeros(self.padded_len)
            for i, (st, cd) in self.owned(rows):
                count_rows(local[i], st, cd, kernel, self.total_len)
            reduce_scatter(self.mesh, local, ALL, out=self.blocks)
            record_slab(key, t0, n_rows, w)
            key = f"{key}_w{w}"
            self.strategy_used[key] = self.strategy_used.get(key, 0) + 1
