"""The threshold consensus vote as a closed-form per-position reduction.

Port of ``sam2consensus_tpu/ops/vote.py`` (XLA code there, plain torch ops
here, and :func:`vote_positions_native`, the C++ vote of a tail placed on
the host).  The reference's greedy caller (``sam2consensus.py:359-367``) has an
exact per-lane closed form:

    lane i is included  <=>  c_i != 0  AND  S_i < t * cov,
    where S_i = sum of c_j over lanes j with c_j > c_i.

The called set becomes a 6-bit mask (bit i = ALPHABET[i]) mapped through
the 64-entry IUPAC LUT.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..constants import IUPAC_MASK_LUT, SYM32_ASCII
from .cutoff import exact_cutoff

#: copy: 64-entry LUT mapping the called-set mask to the 5-bit symbol code
IUPAC_MASK_LUT5 = np.array(
    [{int(b): i for i, b in enumerate(SYM32_ASCII)}[int(v)]
     for v in IUPAC_MASK_LUT], dtype=np.uint8)

#: output byte marking "fill this position on host" (cov==0 or
#: cov<min_depth); never collides with real output chars (all >= ord('-')).
FILL_SENTINEL = 0


def device_fill_code(fill: str, sym_space: str = "ascii"):
    """Copy: the device epilogue's fill substitution code, or None when the
    fill cannot be substituted on device (multi-character or non-latin
    fills; in ``code5`` also fills outside the 32-symbol vote alphabet)."""
    if len(fill) != 1 or ord(fill) > 255:
        return None
    if sym_space == "code5":
        hits = np.nonzero(SYM32_ASCII == ord(fill))[0]
        return int(hits[0]) if len(hits) else None
    return ord(fill)


def threshold_luts(thresholds: Sequence[float], max_cov: int) -> np.ndarray:
    """Copy: integer cutoffs ``lut[t, cov] = ceil(float64(t)*cov)`` as int32,
    the independent host oracle of :func:`ops.cutoff.exact_cutoff`."""
    t = np.asarray(thresholds, dtype=np.float64)[:, None]
    cov = np.arange(max_cov + 1, dtype=np.float64)[None, :]
    prod = t * cov
    lut = np.ceil(prod)
    if lut.max() > np.iinfo(np.int32).max:
        raise OverflowError("threshold*coverage exceeds int32")
    return lut.astype(np.int32)


#: device copies of the LUTs, one per (table, device), made on first use
_DEVICE_LUTS = {}


def device_lut(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """The uint8 LUT ``table`` on ``device``, copied there once and reused:
    a pageable host-to-device copy on every call would wait for the host."""
    key = (table.tobytes(), torch.device(device))
    lut = _DEVICE_LUTS.get(key)
    if lut is None:
        lut = torch.as_tensor(table, dtype=torch.uint8).to(device)
        _DEVICE_LUTS[key] = lut
    return lut


def iupac_select(mask: torch.Tensor, table=IUPAC_MASK_LUT) -> torch.Tensor:
    """Map 6-bit called-set masks to output bytes (a 64-entry LUT gather)."""
    return device_lut(table, mask.device)[mask.long()]


def emit_gate(cov: torch.Tensor, min_depth: int) -> torch.Tensor:
    """Positions the reference emits a real character for:
    ``cov > 0 and cov >= min_depth``."""
    return (cov > 0) & (cov >= min_depth)


def strictly_greater_sums(counts: torch.Tensor) -> torch.Tensor:
    """``S[..., i] = sum_j counts[..., j] * (counts[..., j] > counts[..., i])``
    in int32, one donor lane at a time (``[..., 6]`` temporaries instead of
    the ``[..., 6, 6]`` broadcast)."""
    sgs = torch.zeros_like(counts)
    for j in range(counts.shape[-1]):
        cj = counts[..., j:j + 1]
        sgs += torch.where(cj > counts, cj, 0)
    return sgs


def called_masks(counts: torch.Tensor, sgs: torch.Tensor,
                 cutoff: torch.Tensor) -> torch.Tensor:
    """6-bit masks of the lanes with ``c_i != 0 and S_i < cutoff``;
    ``cutoff`` broadcasts against ``counts[..., 0]``."""
    bits = (1 << torch.arange(counts.shape[-1], dtype=torch.int32,
                              device=counts.device))
    included = (counts != 0) & (sgs < cutoff.unsqueeze(-1))
    return torch.where(included, bits, 0).sum(dim=-1, dtype=torch.int32)


def vote_block(counts: torch.Tensor, thresholds: Sequence[float],
               min_depth: int, sym_space: str = "ascii",
               fill_code: int = FILL_SENTINEL
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vote every position for every threshold.

    Args:
      counts: ``[L, 6]`` pileup counts (int32, or uint8/uint16 widened here).
      thresholds: the float thresholds (float64 on both sides of the
        comparison, as in the reference).
      min_depth: minimum depth gate.
      sym_space: ``"ascii"`` (output bytes) or ``"code5"`` (5-bit codes in
        ``constants.SYM32_ASCII`` order).
      fill_code: what unemitted positions carry — FILL_SENTINEL (the host
        substitutes later) or a :func:`device_fill_code` value.

    Returns:
      syms uint8 ``[T, L]`` and cov int32 ``[L]``.
    """
    table = IUPAC_MASK_LUT if sym_space == "ascii" else IUPAC_MASK_LUT5
    counts = counts.to(torch.int32)
    cov = counts.sum(dim=-1, dtype=torch.int32)
    sgs = strictly_greater_sums(counts)
    emit = emit_gate(cov, min_depth)
    rows = []
    for t in thresholds:
        mask = called_masks(counts, sgs, exact_cutoff(cov, t))
        rows.append(torch.where(emit, iupac_select(mask, table), fill_code))
    if not rows:
        return (torch.empty((0, counts.shape[0]), dtype=torch.uint8,
                            device=counts.device), cov)
    return torch.stack(rows), cov


def vote_positions_native(counts: np.ndarray, thresholds: Sequence[float],
                          min_depth: int, threads: int = 1):
    """Copy: the C++ vote over host-resident counts (``s2c_vote``), or None
    when the native library is unavailable.

    The same closed form and 64-entry mask LUT as :func:`vote_block`; the
    float64 ``ceil(t * cov)`` cutoff is computed directly.  Position ranges
    split across ``threads`` workers (below 1M positions the C side stays
    serial).  Returns ``(syms uint8 [T, L] with FILL_SENTINEL, cov int32
    [L])``.
    """
    from .. import native

    lib = native.load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    length = counts.shape[0]
    n_thr = len(thresholds)
    syms = np.empty(n_thr * length, np.uint8)
    cov = np.empty(length, np.int32)
    lib.s2c_vote(counts.reshape(-1), length,
                 np.asarray(thresholds, np.float64), n_thr, min_depth,
                 IUPAC_MASK_LUT, syms, cov, max(1, threads))
    return syms.reshape(n_thr, length), cov
