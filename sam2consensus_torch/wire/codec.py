"""Host-side ``delta8`` slab codec: what crosses the link under ``--wire``.

Copy of ``sam2consensus_tpu/wire/codec.py`` (pinned by
``tests/test_torch_copies.py`` and ``tests/test_torch_wire.py``), numpy
only.  A segment-row slab is ``(starts int32 [S], codes uint8 [S, W])``.
The reference's ``packed5`` wire moves ``4 + W/2`` bytes a row (int32
starts and 4-bit code nibbles); the port's ships the raw rows, ``4 + W``
bytes a row, and packs them on the card.  ``delta8`` exploits three
regularities of real slabs:

* starts are near-sorted (and :func:`canonicalize_rows` sorts them), so
  consecutive deltas ride one uint8 each; 255 marks an escape whose exact
  delta rides the uint16 or int32 escape lane;
* rows are mostly ACGT: A/C/G/T (codes 1/2/3/5) ride 2-bit planes, and
  gap, N and interior-PAD cells ride sparse (cell index, code) escapes;
* a row's trailing PAD is one count in the uint8/uint16/int32 trail lane,
  whose dtype maximum is the all-PAD-row sentinel.

:func:`encode_slab` refuses (:func:`worthwhile` False) a slab that would
not shrink; the caller then ships the rows as they are, per slab.  The
device unpack is :func:`.device.decode_slab`.

The run-level choice, :func:`resolve_codec`, prices the bytes a cell that
delta8 saves against the raw rows by the link, against the codec's host
encode and device unpack per cell.  Unlike the reference, the
port reads no ``S2C_WIRE*`` environment override: ``--wire`` is the
interface, and the costs are module constants measured on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..constants import PAD_CODE

#: wire codecs, by self-describing header id
CODECS = ("packed5", "delta8")

#: escape marker in the uint8 delta lane
DELTA_ESCAPE = 255

#: 2-bit wire value -> count-lane code (A=1, C=2, G=3, T=5)
WIRE2_TO_CODE = np.array([1, 2, 3, 5], dtype=np.uint8)

#: count-lane code -> 2-bit wire value (non-ACGT cells escape)
CODE_TO_WIRE2 = np.zeros(256, dtype=np.uint8)
CODE_TO_WIRE2[[1, 2, 3, 5]] = np.arange(4, dtype=np.uint8)

#: True for codes the 2-bit primary lane can carry
IS_ACGT = np.zeros(256, dtype=bool)
IS_ACGT[[1, 2, 3, 5]] = True

#: trailing-pad lane dtypes, narrowest first; the max value of each is
#: the "whole row is PAD" sentinel
_TRAIL_DTYPES = (np.uint8, np.uint16, np.int32)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@dataclass
class WireSlab:
    """One encoded slab and its self-describing header (copy).

    Lanes (``C`` chunks of ``R`` rows): ``d8`` uint8 ``[C, R]`` start
    deltas (255 = escape); ``esc_delta`` uint16/int32 ``[C, Ep]`` the
    escaped rows' exact deltas; ``trail`` uint8/uint16/int32 ``[C, R]``
    trailing-PAD cells a row (the dtype max: an all-PAD row); ``base2``
    uint8 ``[C, R, ceil(Wq/4)]`` 2-bit ACGT planes; ``esc_idx``
    uint16/int32 ``[C, Ec]`` chunk-local flat indices ``r*W + c`` of
    non-ACGT cells (pad entries ``R*W``); ``esc_code`` uint8 ``[C, Ec]``
    their codes.
    """

    codec: str
    n_rows: int
    width: int
    chunks: int
    sentinel: int
    d8: np.ndarray
    esc_delta: np.ndarray
    trail: np.ndarray
    base2: np.ndarray
    esc_idx: np.ndarray
    esc_code: np.ndarray
    n_esc_rows: int
    n_esc_cells: int

    def header(self) -> np.ndarray:
        """The slab's header (codec id, shape, escape counts)."""
        return np.array(
            [CODECS.index(self.codec), self.n_rows, self.width,
             self.chunks, self.esc_delta.shape[1], self.esc_idx.shape[1],
             self.sentinel, self.n_esc_rows, self.n_esc_cells],
            dtype=np.int32)

    def arrays(self) -> Tuple[np.ndarray, ...]:
        """The device-bound lanes, in decode-argument order."""
        return (self.d8, self.esc_delta, self.trail, self.base2,
                self.esc_idx, self.esc_code)

    @property
    def wire_bytes(self) -> int:
        """Exact bytes this slab puts on the link (lanes + header)."""
        return (sum(a.nbytes for a in self.arrays())
                + self.header().nbytes)


def packed5_slab_bytes(n_rows: int, width: int) -> int:
    """Wire bytes of the packed-lane format for the same slab."""
    return n_rows * (4 + (width + 1) // 2)


def encode_slab(starts: np.ndarray, codes: np.ndarray,
                chunks: int = 1) -> Optional[WireSlab]:
    """Encode one slab; ``None`` when the shape cannot chunk evenly.
    ``decode_slab_host(encode_slab(s, c)) == (s, c)`` for every uint8 code
    matrix and non-negative int32 starts."""
    S, W = codes.shape
    if S == 0 or chunks < 1 or S % chunks:
        return None
    R = S // chunks

    # -- start deltas ----------------------------------------------------
    s64 = np.ascontiguousarray(starts, dtype=np.int64).reshape(chunks, R)
    prev = np.roll(s64, 1, axis=1)
    prev[:, 0] = 0                       # chain restarts at each chunk
    delta = s64 - prev
    esc_row = (delta < 0) | (delta >= DELTA_ESCAPE)
    n_esc_rows = int(esc_row.sum())
    ep = _pow2(max(1, int(esc_row.sum(axis=1).max(initial=1))))
    # uint16 escapes when every escaped delta fits, int32 for negative or
    # huge jumps
    esc_vals = delta[esc_row]
    esc_dt = np.uint16 if (len(esc_vals) == 0
                           or (esc_vals.min(initial=0) >= 0
                               and esc_vals.max(initial=0) < (1 << 16))
                           ) else np.int32
    esc_delta = np.zeros((chunks, ep), dtype=esc_dt)
    ci, ri = np.nonzero(esc_row)
    if len(ci):
        k = (np.cumsum(esc_row, axis=1) - 1)[ci, ri]
        esc_delta[ci, k] = delta[ci, ri].astype(esc_dt)
    d8 = np.where(esc_row, DELTA_ESCAPE, delta).astype(np.uint8)

    # -- trailing-pad lane ----------------------------------------------
    nonpad = codes != PAD_CODE
    anyrow = nonpad.any(axis=1)
    nlen = np.where(anyrow, W - nonpad[:, ::-1].argmax(axis=1), 0)
    trail_real = W - nlen
    max_trail = int(trail_real[anyrow].max(initial=0))
    for dt in _TRAIL_DTYPES:
        sentinel = int(np.iinfo(dt).max)
        if max_trail < sentinel:
            break
    trail = np.where(anyrow, trail_real, sentinel).astype(dt) \
        .reshape(chunks, R)

    # -- 2-bit ACGT planes ----------------------------------------------
    # only as wide as the longest row payload, on a sixteenth-pow2 grid
    wire2 = CODE_TO_WIRE2[codes]
    lane_bytes = max(1, -(-int(nlen.max(initial=0)) // 4))
    shift = max(0, (lane_bytes - 1).bit_length() - 4)
    lane_bytes = -(-lane_bytes >> shift) << shift
    wq = min(-(-W // 4), lane_bytes) * 4
    if wq < W:
        wire2 = wire2[:, :wq]
    elif wq != W:
        wire2 = np.concatenate(
            [wire2, np.zeros((S, wq - W), dtype=np.uint8)], axis=1)
    q = wire2.reshape(S, wq // 4, 4)
    base2 = (q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4)
             | (q[:, :, 3] << 6)).astype(np.uint8).reshape(chunks, R,
                                                           wq // 4)

    # -- cell escapes (non-ACGT within the row payload) ------------------
    cols = np.arange(W)
    escm = (cols[None, :] < nlen[:, None]) & ~IS_ACGT[codes]
    n_esc_cells = int(escm.sum())
    rg, cg = np.nonzero(escm)
    ci2 = rg // R
    per_chunk = np.bincount(ci2, minlength=chunks)
    ec = _pow2(max(1, int(per_chunk.max(initial=1))))
    idx_dt = np.uint16 if R * W <= np.iinfo(np.uint16).max else np.int32
    esc_idx = np.full((chunks, ec), R * W, dtype=idx_dt)
    esc_code = np.zeros((chunks, ec), dtype=np.uint8)
    if len(rg):
        offs = np.concatenate([[0], np.cumsum(per_chunk)])[ci2]
        kk = np.arange(len(rg)) - offs
        esc_idx[ci2, kk] = ((rg % R) * W + cg).astype(idx_dt)
        esc_code[ci2, kk] = codes[rg, cg]

    return WireSlab(codec="delta8", n_rows=S, width=W, chunks=chunks,
                    sentinel=sentinel, d8=d8, esc_delta=esc_delta,
                    trail=trail, base2=base2, esc_idx=esc_idx,
                    esc_code=esc_code, n_esc_rows=n_esc_rows,
                    n_esc_cells=n_esc_cells)


def canonicalize_rows(starts: np.ndarray,
                      codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Stable-sort a slab's real rows by start (the trailing all-PAD rows
    stay a suffix); already-sorted slabs come back untouched.  The pileup
    is order-invariant, and sorted rows keep the deltas in uint8."""
    s = np.asarray(starts)
    c = np.asarray(codes)
    nonpad = (c != PAD_CODE).any(axis=1)
    nz = np.nonzero(nonpad)[0]
    n_real = int(nz[-1]) + 1 if len(nz) else 0
    pre = s[:n_real]
    if len(pre) > 1 and np.any(pre[1:] < pre[:-1]):
        order = np.argsort(pre, kind="stable")
        s = s.copy()
        c = c.copy()
        s[:n_real] = pre[order]
        c[:n_real] = c[:n_real][order]
    return s, c


def worthwhile(slab: WireSlab) -> bool:
    """True when the encoded slab beats the packed5 lanes."""
    return slab.wire_bytes < packed5_slab_bytes(slab.n_rows, slab.width)


def decode_slab_host(slab: WireSlab) -> Tuple[np.ndarray, np.ndarray]:
    """Exact numpy inverse of :func:`encode_slab`."""
    C, R = slab.d8.shape
    W = slab.width
    esc = slab.d8 == DELTA_ESCAPE
    rank = np.cumsum(esc, axis=1) - 1
    ci = np.arange(C)[:, None]
    delta = np.where(
        esc, slab.esc_delta[ci, np.clip(rank, 0, slab.esc_delta.shape[1]
                                        - 1)],
        slab.d8.astype(np.int64))
    starts = np.cumsum(delta, axis=1).reshape(-1).astype(np.int32)

    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    two = (slab.base2.reshape(C * R, -1)[:, :, None] >> shifts) & 3
    lane = WIRE2_TO_CODE[two.reshape(C * R, -1)[:, :W]]
    codes = np.full((C * R, W), PAD_CODE, dtype=np.uint8)
    codes[:, :lane.shape[1]] = lane
    nlen = np.where(slab.trail == slab.sentinel, 0,
                    W - slab.trail.astype(np.int64)).reshape(-1)
    codes[np.arange(W)[None, :] >= nlen[:, None]] = PAD_CODE
    flat = codes.reshape(C, R * W)
    idx = slab.esc_idx.astype(np.int64)
    ok = idx < R * W
    cc, kk = np.nonzero(ok)
    flat[cc, idx[cc, kk]] = slab.esc_code[cc, kk]
    return starts, flat.reshape(C * R, W)


# -- run-level codec choice ---------------------------------------------

#: modelled wire bytes saved a pileup cell by delta8 against packed5 at the
#: representative slab shape (W = 128, ~100 bp reads: 68 B -> ~34 B a row);
#: the reference's model, kept for :func:`modeled_wire_ratio`.  The port
#: prices :data:`ROWS_SAVED_BYTES_PER_CELL` instead
SAVED_BYTES_PER_CELL = 0.25

#: packed5 wire bytes a cell at that shape
_PACKED5_BPC = 68.0 / 128.0

# Measured by ``perf/gate_constants.py`` on an NVIDIA H100 80GB HBM3 at
# 700 W with its host: the mean of two runs' medians over
# ``ecoli_scale``'s three slabs (``perf/gate_constants_pr8_run1.log``,
# ``perf/gate_constants_pr8_run2.log``; PERF.md §5).
#: the device unpack's ns a cell (lanes -> starts and raw codes;
#: 0.050-0.101 a slab)
WIRE_DEV_NS = 0.0595
#: the host's canonicalise and encode ns a cell (on the staging thread;
#: priced at full cost; 14.8-23.6 a slab)
WIRE_HOST_NS = 19.0
#: the wire bytes delta8 saves a cell against the raw rows the port ships
#: otherwise (int32 starts and uint8 codes, ``4 + W`` bytes a row), over
#: the three slabs (0.78-0.89 a slab): a byte count, the same in every run
#: (``perf/gate_constants_pr8_run3.log`` to ``..._run5.log``)
ROWS_SAVED_BYTES_PER_CELL = 0.8233


def modeled_wire_ratio(codec: str) -> float:
    """The reference's modelled compression ratio (packed5-equivalent
    bytes / shipped bytes) for ``codec``; the port's gate prices
    :data:`ROWS_SAVED_BYTES_PER_CELL` instead."""
    if codec != "delta8":
        return 1.0
    return _PACKED5_BPC / max(_PACKED5_BPC - SAVED_BYTES_PER_CELL, 1e-9)


def wire_auto_cutoff_bps() -> float:
    """Link rate below which ``--wire auto`` picks delta8: the rate at
    which the bytes it saves a cell (:data:`ROWS_SAVED_BYTES_PER_CELL`)
    cross in the encode and unpack time of a cell."""
    return ROWS_SAVED_BYTES_PER_CELL / ((WIRE_DEV_NS + WIRE_HOST_NS) * 1e-9)


def resolve_codec(mode: str, link_bps: Optional[float],
                  link_free: bool = False) -> Tuple[str, str]:
    """``(codec, reason)`` for one run: the ``--wire`` decision.  Explicit
    modes win; ``auto`` ships packed5 on a link-free device and otherwise
    prices ``link_bps`` against :func:`wire_auto_cutoff_bps`."""
    if mode not in ("auto",) + CODECS:
        raise ValueError(
            f"--wire {mode!r}: use auto|{'|'.join(CODECS)}")
    if mode != "auto":
        return mode, "forced"
    if link_free:
        return "packed5", "link_free"
    if link_bps is not None and link_bps < wire_auto_cutoff_bps():
        return "delta8", "slow_link"
    return "packed5", "fast_link"
