"""Shared machinery of the sharded accumulators (dp, sp and dpsp).

Port of ``sam2consensus_tpu/parallel/base.py``.  Every layout keeps the
count tensor position-sharded: shard ``i`` holds one ``[block, 6]`` int32
block on its device, the block the layout's ``pos_axes`` assign it
(``("dp", "sp")``: block ``i``; dpsp's ``("sp", "dp")``: shard ``(d, s)``
holds block ``s * dp + d``).  They share the state (``counts_host``,
``restore``), the row shipping (:meth:`ShardedCountsBase.put_rows`) and
the tail's position work (``vote`` and ``tail_stats`` on the resident
blocks); only the accumulation differs.  On a process-spanning mesh each
process holds the blocks of its own shards (``None`` for the others'),
ships and counts only its own shards' rows, and the collectives cross the
process boundary; ``counts_host`` and the vote return the global value on
every process, as the reference's do.

The host helpers (:func:`block_for`, :func:`split_wide_rows`,
:func:`real_row_mask`, :func:`route_to_slots`, :func:`record_slab`) are
copies, pinned by ``tests/test_torch_copies.py``.  The reference's
``plan_mxu_grids`` belongs to the MXU pileup, which the port does not run
yet.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import NUM_SYMBOLS, PAD_CODE
from .collectives import ALL, all_reduce
from .partition import (make_shard_and_gather_fns, match_partition_rules,
                        partition_rules, publish_mesh_gauges)

#: copy of ``sam2consensus_tpu/ops/pallas_pileup.TILE_POSITIONS``: the
#: reference's kernel serves widths whose overhang fits half a tile
PALLAS_TILE_POSITIONS = 1 << 17


def kernel_width_ok(w: int) -> bool:
    """The widths the reference's sharded kernel routes take (an even
    width whose 128-lane overhang fits half a tile); any other width rides
    the scatter, here as there, so the routes and K1's launches match."""
    return w % 2 == 0 and -(-w // 128) * 128 * 2 <= PALLAS_TILE_POSITIONS


def record_slab(key: str, t0: float, n_rows: int, width: int) -> None:
    """Copy: per-slab observability for the sharded routers: a ``slab``
    span, a ``pileup/slab_sec/<key>`` sample and ``pileup/slabs`` (the
    shard-mode decision's measured per-slab join divides
    ``phase/pileup_dispatch_sec`` by it).  On CUDA the seconds are the
    enqueue."""
    from .. import observability as obs

    obs.tracer().complete("slab", t0, strategy=key, n_rows=n_rows,
                          width=width)
    reg = obs.metrics()
    reg.observe(f"pileup/slab_sec/{key}", time.perf_counter() - t0)
    reg.add("pileup/slabs", 1)


def block_for(total_len: int, n_devices: int) -> int:
    """Copy: rows of the position axis each shard owns (+1 covers the
    scatter's sacrificial row inside the pad)."""
    return -(-(total_len + 1) // n_devices)


def split_wide_rows(starts: np.ndarray, codes: np.ndarray, w: int,
                    halo: int, padded_len: int):
    """Copy: split rows wider than the halo into halo-width pieces (exact:
    segment rows are position-contiguous); trailing all-PAD pieces clamp
    their starts into the pad.  Returns ``(starts, codes, halo)``."""
    k = -(-w // halo)
    wp = k * halo
    if wp != w:
        codes = np.concatenate(
            [codes, np.full((len(codes), wp - w), PAD_CODE,
                            dtype=np.uint8)], axis=1)
    starts = (starts[:, None]
              + (np.arange(k) * halo)[None, :]).reshape(-1)
    starts = np.minimum(starts, padded_len - 1).astype(np.int32)
    return starts, codes.reshape(-1, halo), halo


def real_row_mask(starts: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Copy: True for real rows, False for the encoder's pad rows (all-PAD
    rows at start 0); for planning only, never for correctness."""
    real = np.ones(len(starts), dtype=bool)
    zero = np.nonzero(starts == 0)[0]
    if len(zero):
        real[zero[(codes[zero] == PAD_CODE).all(axis=1)]] = False
    return real


def route_to_slots(targets: np.ndarray, n_targets: int, r: int,
                   starts: np.ndarray, codes: np.ndarray,
                   pin_starts: np.ndarray):
    """Copy: counting-sort rows into an ``[n_targets, r]`` slot grid;
    unfilled slots carry ``pin_starts[target]`` and all-PAD codes.
    Returns ``(s_grid [n_targets, r] int32, c_grid [n_targets, r, w]
    uint8)``."""
    w = codes.shape[1]
    order = np.argsort(targets, kind="stable")
    t_sorted = targets[order]
    per = np.bincount(t_sorted, minlength=n_targets)
    s_grid = np.broadcast_to(
        pin_starts.astype(np.int32)[:, None], (n_targets, r)).copy()
    c_grid = np.full((n_targets, r, w), PAD_CODE, dtype=np.uint8)
    hi = np.cumsum(per)
    flat = (t_sorted * r
            + (np.arange(len(targets)) - (hi - per)[t_sorted]))
    s_grid.reshape(-1)[flat] = starts[order]
    c_grid.reshape(-1, w)[flat] = codes[order]
    return s_grid, c_grid


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host, billed ``wire/d2h_bytes`` when it crossed
    from a card."""
    from .. import observability as obs

    out = t.cpu().numpy()
    if t.device.type == "cuda":
        obs.metrics().add("wire/d2h_bytes", out.nbytes)
    return out


def count_rows(local: torch.Tensor, starts: torch.Tensor,
               codes: torch.Tensor, kernel: bool,
               sacrificial: int) -> None:
    """Count one shard's rows into ``local`` in place: K1 over the
    nibble-packed codes (``ops.pileup_kernel.accumulate_rows``; its plain
    version on the CPU) when ``kernel``, else the torch scatter, whose
    PAD cells land in row ``sacrificial``.  ``starts`` are in ``local``'s
    coordinates; a valid cell always falls inside it."""
    from ..ops.pileup import pack_codes, scatter_segments
    from ..ops.pileup_kernel import accumulate_rows

    if kernel:
        accumulate_rows(local, starts, pack_codes(codes))
    else:
        scatter_segments(local, starts, codes, sacrificial)


class ShardedCountsBase:
    """Position-sharded count state, row shipping and the tail's position
    work, whatever the layout (``pos_axes``, as in the reference).

    ``wire``: the run's row codec; under ``delta8`` a slice's rows are
    encoded in ``n`` chunks, one a shard, and each shard decodes its own
    chunk on its device.  ``account`` is the link bill
    (``wire.WireAccount``).  The blocks are allocated on first use and
    tracked once by the memory plane (``counts``: every shard's block,
    billed once)."""

    def __init__(self, mesh, total_len: int,
                 pos_axes: Tuple[str, str] = ALL, wire: str = "packed5"):
        from ..wire import WireAccount

        self.mesh = mesh
        self.n = mesh.size
        self.pos_axes = tuple(pos_axes)
        self.total_len = total_len
        self.block = block_for(total_len, self.n)
        self.padded_len = self.block * self.n
        self.wire = wire
        self.account = WireAccount()
        self._blocks = None
        self.partition_specs = match_partition_rules(
            partition_rules(self.pos_axes), {
                "counts": np.zeros((0, NUM_SYMBOLS), np.int32),
                "row_starts": np.zeros(0, np.int32),
                "row_codes": np.zeros((0, 0), np.uint8),
                "wire_lane": np.zeros(0, np.uint8),
                "vote_syms": np.zeros((0, 0), np.uint8),
                "thresholds": np.zeros(0, np.float64),
                "contig_offsets": np.zeros(0, np.int32),
                "site_keys": np.zeros(0, np.int32),
                "contig_sums": np.zeros(0, np.int32),
                "site_cov": np.zeros(0, np.int32),
            })
        self._shard_fns, self._gather_fns = make_shard_and_gather_fns(
            mesh, self.partition_specs)
        publish_mesh_gauges(mesh)

    def block_index(self, i: int) -> int:
        """The global position block shard ``i`` holds."""
        d, s = self.mesh.coords(i)
        if self.pos_axes == ALL:
            return i
        return s * self.mesh.shape["dp"] + d

    # -- rows --------------------------------------------------------------
    def put_rows(self, starts: np.ndarray, codes: np.ndarray
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Ship one slice's rows in ``n`` equal runs, run ``i`` to shard
        ``i``: ``[(starts int32 [R], codes uint8 [R, W])]`` on the shards'
        devices (``None`` for a shard another process owns: each process
        ships only its own shards' runs).  Under ``delta8`` the slice is
        encoded in ``n`` chunks and each shard unpacks its own
        (``wire.device.decode_slab``); a slice whose encoding would not
        shrink ships raw, counted in the account."""
        from ..wire import encode_wire_slab
        from ..wire.device import decode_slab, wire_lane

        n_rows, w = codes.shape
        slab = encode_wire_slab(self.wire, starts, codes, self.account,
                                chunks=self.n)
        if slab is None:
            starts = np.ascontiguousarray(starts, dtype=np.int32)
            nbytes = starts.nbytes + codes.nbytes
            self.account.add("packed5", nbytes, n_rows, w)
            return [None if st is None else (st, cd) for st, cd in zip(
                self._shard_fns["row_starts"](starts),
                self._shard_fns["row_codes"](codes))]
        lanes = [self._shard_fns["wire_lane"](wire_lane(a))
                 for a in slab.arrays()]
        u16 = tuple(a.dtype == np.uint16 for a in
                    (slab.esc_delta, slab.trail, slab.esc_idx))
        nbytes = sum(a.nbytes for a in slab.arrays())
        self.account.add("delta8", nbytes, n_rows, w)
        return [decode_slab(*(lane[i] for lane in lanes), slab.width,
                            slab.sentinel, u16) if i in self.mesh.local
                else None for i in range(self.n)]

    def zeros(self, length: int) -> List[Optional[torch.Tensor]]:
        """One ``[length, 6]`` int32 zero tensor a shard, on its device
        (``None`` for a shard another process owns)."""
        return [None if dev is None else
                torch.zeros((length, NUM_SYMBOLS), dtype=torch.int32,
                            device=dev) for dev in self.mesh.devices]

    def owned(self, xs: Sequence) -> List[Tuple[int, object]]:
        """``(i, xs[i])`` for each shard ``i`` this process owns."""
        return [(i, xs[i]) for i in self.mesh.local]

    def sync(self) -> None:
        """Wait for every enqueued count (the traced run's barrier)."""
        for dev in self.mesh.cuda_devices:
            torch.cuda.synchronize(dev)

    # -- state -------------------------------------------------------------
    @property
    def blocks(self) -> List[torch.Tensor]:
        """The ``[block, 6]`` int32 count blocks, one a shard, in the
        mesh's flat order (shard ``i`` holds block :meth:`block_index`;
        ``None`` where another process owns the shard)."""
        if self._blocks is None:
            self._blocks = self.zeros(self.block)
            self._track_counts()
        return self._blocks

    def counts_host(self) -> np.ndarray:
        """The valid counts on the host, ``[total_len, 6]`` int32 (every
        process's blocks: a collective on a process-spanning mesh)."""
        return self._gather_fns["counts"](self.blocks)[: self.total_len]

    def restore(self, counts) -> None:
        """Load checkpointed counts (``[total_len, 6]``), re-sharded."""
        padded = np.zeros((self.padded_len, NUM_SYMBOLS), dtype=np.int32)
        padded[: self.total_len] = np.asarray(counts)
        self._blocks = self._shard_fns["counts"](padded)
        self._track_counts()

    def _track_counts(self) -> None:
        """The count blocks on the memory plane, once an accumulator,
        released with it: this process's fraction of the padded tensor (its
        own shards' blocks; the whole tensor on one process), the unit the
        ``mesh_shards`` planner prices a host in (the reference's
        ``_track_counts``)."""
        if not getattr(self, "_mem_tracked", False):
            self._mem_tracked = True
            from ..observability import memplane

            frac = len(self.mesh.local) / max(1, self.n)
            memplane.track_obj("counts", self,
                               int(self.padded_len * NUM_SYMBOLS * 4 * frac))

    # -- the tail's position work ------------------------------------------
    def vote(self, thresholds: Sequence[float], min_depth: int,
             fill_code: Optional[int] = None,
             offsets: Optional[np.ndarray] = None):
        """The position vote on the resident blocks, no communication
        (``ops.vote.vote_block`` a block); host symbols ``[T,
        total_len]`` with the FILL sentinel.  With ``fill_code`` (the
        device epilogue, ``ops.vote.device_fill_code``) the unemitted
        positions carry the fill itself, and with ``offsets`` the vote
        also returns the per-(threshold, contig) ``'-'`` totals ``[T, C]``
        (int64, on the host): each block's prefix sums at the contig
        offsets, then one ``all_reduce``."""
        from ..ops.vote import FILL_SENTINEL, vote_block

        code = FILL_SENTINEL if fill_code is None else fill_code
        syms: List[Optional[torch.Tensor]] = [None] * self.n
        for i, blk in self.owned(self.blocks):
            syms[i] = vote_block(blk, thresholds, min_depth, "ascii",
                                 code)[0]
        host = self._gather_fns["vote_syms"](syms)[:, : self.total_len]
        if offsets is None:
            return host
        offs = self._shard_fns["contig_offsets"](
            np.asarray(offsets, dtype=np.int64))
        parts: List[Optional[torch.Tensor]] = [None] * self.n
        for i, blk_syms in self.owned(syms):
            lo = self.block_index(i) * self.block
            dash = (blk_syms == ord("-")).to(torch.int64)
            prefix = torch.cat([dash.new_zeros((dash.shape[0], 1)),
                                dash.cumsum(1)], dim=1)
            parts[i] = prefix[:, (offs[i] - lo).clamp(0, self.block)]
        total = all_reduce(self.mesh, parts, ALL)[self.mesh.local[0]]
        return host, to_host(total[:, 1:] - total[:, :-1])

    def tail_stats(self, offsets: np.ndarray, site_keys: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-contig coverage sums ``[C]`` and per-site coverage ``[K]``
        without moving the coverage off the shards: each shard's prefix
        sums at the contig offsets and its owned sites' coverage, then one
        ``all_reduce``.  Returns int32 tensors on this process's first
        device (the sums wrap modulo 2^32, as the reference's int32
        psum)."""
        n_off = len(offsets)
        if len(site_keys) == 0:
            site_keys = np.full(1, -1, dtype=np.int32)
        offs = self._shard_fns["contig_offsets"](
            np.asarray(offsets, dtype=np.int64))
        keys = self._shard_fns["site_keys"](
            np.asarray(site_keys, dtype=np.int64))
        parts: List[Optional[torch.Tensor]] = [None] * self.n
        for i, blk in self.owned(self.blocks):
            lo = self.block_index(i) * self.block
            cov = blk.sum(dim=-1, dtype=torch.int64)
            prefix = torch.cat([cov.new_zeros(1), cov.cumsum(0)])
            part = prefix[(offs[i] - lo).clamp(0, self.block)]
            owned = (keys[i] >= lo) & (keys[i] < lo + self.block)
            local = torch.where(
                owned, cov[(keys[i] - lo).clamp(0, self.block - 1)], 0)
            parts[i] = torch.cat([part, local])
        total = all_reduce(self.mesh, parts, ALL)[self.mesh.local[0]]
        contig_sums = (total[1:n_off] - total[: n_off - 1]).to(torch.int32)
        return contig_sums, total[n_off:].to(torch.int32)
