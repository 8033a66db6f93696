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

``pileup`` picks each shard's count: ``pallas`` runs K1
(``ops.pileup_kernel.accumulate_rows``; on the CPU its plain version),
``scatter`` the torch scatter, ``mxu`` the MXU route (``ops.mxu_pileup``)
over slots the host plans for each run with one E (the reference's
``_plan_mxu``: on a process-spanning mesh every process derives E and the
skew verdict from every run's histogram, and assigns the slots of its own
runs only), and ``auto`` the reference's online autotune
(``ops.pileup.PileupAutoTuner`` through ``run_tuned_slab``: scatter
against K1 on a mesh of CUDA devices, against the MXU route on the CPU).
A width the reference's kernel route refuses (``base.kernel_width_ok``)
and an MXU plan that skews ride the scatter.  Whatever the route, a
bucket makes the same one ``reduce_scatter``.
"""

from __future__ import annotations

import time

import numpy as np

from ..constants import PAD_CODE
from ..encoder.events import SegmentBatch
from ..ops import mxu_pileup
from ..ops.pileup import (PileupAutoTuner, round_rows_grid,
                          round_rows_pow2, run_tuned_slab)
from .base import (ShardedCountsBase, count_mxu, count_rows,
                   kernel_width_ok, record_slab)
from .collectives import ALL, reduce_scatter

__all__ = ["ShardedConsensus", "ALL"]


class ShardedConsensus(ShardedCountsBase):
    """Streaming data-parallel accumulate over a ``TorchMesh``.
    ``strategy_used`` counts ``<pallas|mxu|scatter>_w<W>`` a bucket, and
    ``autotune`` once the tuner locks."""

    def __init__(self, mesh, total_len: int, pileup: str = "auto",
                 wire: str = "packed5"):
        super().__init__(mesh, total_len, wire=wire)
        if pileup not in ("auto", "pallas", "mxu", "scatter"):
            raise ValueError(f"dp pileup {pileup!r}: use auto, pallas, mxu "
                             f"or scatter")
        self.pileup = pileup
        self.strategy_used: dict = {}
        self._tuner = PileupAutoTuner(
            kernel="pallas" if mesh.cuda_devices else "mxu") \
            if pileup == "auto" else None
        self._tile = mxu_pileup.TILE_POSITIONS
        self._n_tiles = -(-self.padded_len // self._tile)

    def _pad(self, starts: np.ndarray, codes: np.ndarray):
        """The rows padded to a multiple of ``n`` with all-PAD rows at
        start 0 (they count nothing)."""
        n_rows, w = codes.shape
        target = -(-n_rows // self.n) * self.n
        if target != n_rows:
            starts = np.concatenate(
                [starts, np.zeros(target - n_rows, dtype=starts.dtype)])
            codes = np.concatenate(
                [codes, np.full((target - n_rows, w), PAD_CODE,
                                dtype=np.uint8)])
        return starts, codes

    def _reduce(self, starts: np.ndarray, codes: np.ndarray, count) -> None:
        """Ship the (padded) rows, ``count(i, local, starts, codes)`` each
        owned shard's run into its full-length local, and reduce-scatter
        the locals into the blocks."""
        rows = self.put_rows(starts.astype(np.int32), codes)
        local = self.zeros(self.padded_len)
        for i, (st, cd) in self.owned(rows):
            count(i, local[i], st, cd)
        reduce_scatter(self.mesh, local, ALL, out=self.blocks)

    def _plan_mxu(self, starts: np.ndarray, codes: np.ndarray):
        """The reference's ``_plan_mxu``: ``(starts, codes, slots, E)``, the
        rows padded and split into one run a shard, slot-planned with a
        common E; None on skew.  E and the verdict come from every run's
        histogram; only this process's runs get slots."""
        total = len(starts)
        if total == 0:
            return None
        starts, codes = self._pad(starts, codes)
        per = len(starts) // self.n
        bounds = [(i * per, (i + 1) * per) for i in range(self.n)]
        hists = []
        for lo, hi in bounds:
            tile_of = starts[lo:hi] // self._tile
            hists.append((tile_of, np.bincount(tile_of,
                                               minlength=self._n_tiles)))
        emax = max(int(pt.max(initial=1)) for _t, pt in hists)
        e_fine = round_rows_grid(emax)
        e = e_fine
        if self._tuner is not None and self._tuner.winner is None:
            # autotune timing phase: the pow2 grid (see _plan_prelude)
            e = round_rows_pow2(e_fine)
        # gate on the fine-grid economics (same rule as _plan_prelude)
        if self.n * self._n_tiles * e_fine / total > mxu_pileup.MAX_BLOWUP:
            return None
        slots = np.zeros(per * self.n, dtype=np.int32)
        for i in self.mesh.local:
            (lo, hi), (tile_of, per_tile) = bounds[i], hists[i]
            slots[lo:hi] = mxu_pileup.assign_slots(tile_of, per_tile, e)
        return starts, codes, slots, e

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
            if self.pileup in ("pallas", "scatter"):
                kernel = self.pileup == "pallas" and kernel_width_ok(w)
                self._reduce(*self._pad(starts, codes),
                             lambda _i, local, st, cd, k=kernel:
                             count_rows(local, st, cd, k, self.total_len))
                key = "pallas" if kernel else "scatter"
                record_slab(key, t0, n_rows, w)
            else:
                key = self._tuned_add(starts, codes, w)
            key = f"{key}_w{w}"
            self.strategy_used[key] = self.strategy_used.get(key, 0) + 1

    def _tuned_add(self, starts: np.ndarray, codes: np.ndarray,
                   w: int) -> str:
        """``mxu`` and ``auto``: one slab of the reference's protocol;
        returns the strategy key."""
        kernel = self._tuner.kernel if self._tuner is not None \
            else self.pileup

        def plan_kernel():
            if kernel == "mxu":
                return self._plan_mxu(starts, codes)
            return True if len(starts) and kernel_width_ok(w) else None

        def exec_kernel(plan):
            if kernel != "mxu":
                self._reduce(*self._pad(starts, codes),
                             lambda _i, local, st, cd:
                             count_rows(local, st, cd, True,
                                        self.total_len))
                return
            p_starts, p_codes, slots, e = plan
            slot = self.put_slots(slots)
            self._reduce(p_starts, p_codes,
                         lambda i, local, st, cd:
                         count_mxu(local, st, cd, slot[i], self._n_tiles,
                                   e))

        def exec_scatter():
            self._reduce(*self._pad(starts, codes),
                         lambda _i, local, st, cd:
                         count_rows(local, st, cd, False, self.total_len))

        key = run_tuned_slab(self._tuner, self.pileup, len(starts), w,
                             plan_kernel, exec_kernel, exec_scatter,
                             self.sync)
        if self._tuner is not None and self._tuner.stats is not None:
            self.strategy_used["autotune"] = self._tuner.stats
        return key
