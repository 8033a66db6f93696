"""Insertion-table construction and vote: the plain PyTorch versions.

Port of ``sam2consensus_tpu/ops/insertions.py``.  Each insertion site is a
"mini-alignment of motifs" (``sam2consensus.py:256-311``): per site, columns
up to the longest motif; per column, base counts; then the gap lane is
completed as ``coverage[site] - sum(column counts)`` — which may go
negative (quirk 4) — and the greedy vote runs with the SITE's cutoff
(``:369-385``).

:func:`build_insertion_table` is the plain version of the table kernel
(K3, ``ops/insertion_kernel.py``); :func:`vote_insertions` after it is the
plain version of the fused table + vote kernel (K2).
:func:`insertion_tail_host` is the whole insertion tail on the host, for a
tail placed there: the C++ ``s2c_ins_table`` and ``s2c_ins_vote``, or their
numpy twins without the library.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .cutoff import exact_cutoff
from .vote import FILL_SENTINEL, called_masks, iupac_select, \
    strictly_greater_sums


def build_insertion_table(n_keys: int, n_cols: int, ev_key: torch.Tensor,
                          ev_col: torch.Tensor,
                          ev_code: torch.Tensor) -> torch.Tensor:
    """Scatter-add one count per event into an int32 ``[K, C, 6]`` table."""
    table = torch.zeros((n_keys, n_cols, 6), dtype=torch.int32,
                        device=ev_key.device)
    ones = torch.ones(ev_key.shape, dtype=torch.int32, device=ev_key.device)
    return table.index_put_((ev_key.long(), ev_col.long(), ev_code.long()),
                            ones, accumulate=True)


def vote_insertions(table: torch.Tensor, site_cov: torch.Tensor,
                    n_cols: torch.Tensor,
                    thresholds: Sequence[float]) -> torch.Tensor:
    """Vote every insertion column for every threshold.

    Args:
      table: int32 ``[K, C, 6]`` raw base counts.
      site_cov: int32 ``[K]`` coverage at each site's reference position
        (0 for end-of-contig and pad sites).
      n_cols: int32 ``[K]`` valid column count per site (longest motif).
      thresholds: float thresholds.

    Returns:
      uint8 ``[T, K, C]``: output byte per column; FILL_SENTINEL where the
      column is past ``n_cols`` or the call is ``-`` (sam2consensus.py:381-382).
    """
    site_cov = site_cov.to(torch.int32)
    completed = table.clone()
    completed[:, :, 0] = site_cov[:, None] - table.sum(dim=-1,
                                                       dtype=torch.int32)
    sgs = strictly_greater_sums(completed)
    cols = torch.arange(table.shape[1], device=table.device)
    valid = cols[None, :] < n_cols[:, None]
    rows = []
    for t in thresholds:
        cutoff = exact_cutoff(site_cov, t)[:, None].expand(table.shape[:2])
        syms = iupac_select(called_masks(completed, sgs, cutoff))
        skip = (syms == ord("-")) | ~valid
        rows.append(torch.where(skip, FILL_SENTINEL, syms))
    return torch.stack(rows)


def insertion_tail_host(kp: int, cp: int, ev_key: np.ndarray,
                        ev_col: np.ndarray, ev_code: np.ndarray,
                        site_cov: np.ndarray, n_cols: np.ndarray,
                        thresholds, k_valid: int) -> np.ndarray:
    """Copy: the whole insertion tail (table build and vote) on the host,
    for a tail placed on the CPU with the native vote: the C++ twin when
    the library loads, the numpy twins otherwise.  Returns uint8
    ``[T, k_valid, cp]``."""
    from .. import native

    lib = native.load()
    if lib is not None and k_valid > 0:
        from ..constants import IUPAC_MASK_LUT

        table = np.zeros(kp * cp * 6, dtype=np.int32)
        lib.s2c_ins_table(
            np.ascontiguousarray(ev_key, np.int32),
            np.ascontiguousarray(ev_col, np.int32),
            np.ascontiguousarray(ev_code, np.int32),
            len(ev_key), table, cp)
        out = np.empty(len(thresholds) * k_valid * cp, dtype=np.uint8)
        lib.s2c_ins_vote(
            table, k_valid, cp,
            np.ascontiguousarray(site_cov[:k_valid], np.int32),
            np.ascontiguousarray(n_cols[:k_valid], np.int32),
            np.asarray(thresholds, np.float64), len(thresholds),
            IUPAC_MASK_LUT, out)
        return out.reshape(len(thresholds), k_valid, cp)
    table = build_insertion_table_host(kp, cp, ev_key, ev_col, ev_code)
    return vote_insertions_host(table[:k_valid], site_cov[:k_valid],
                                n_cols[:k_valid], thresholds)


def build_insertion_table_host(kp: int, cp: int, ev_key: np.ndarray,
                               ev_col: np.ndarray,
                               ev_code: np.ndarray) -> np.ndarray:
    """Copy: numpy twin of :func:`build_insertion_table`, one bincount
    over the flattened event indices."""
    idx = (ev_key.astype(np.int64) * cp + ev_col) * 6 + ev_code
    return np.bincount(idx, minlength=kp * cp * 6).astype(
        np.int32).reshape(kp, cp, 6)


def vote_insertions_host(table: np.ndarray, site_cov: np.ndarray,
                         n_cols: np.ndarray, thresholds) -> np.ndarray:
    """Copy: numpy twin of :func:`vote_insertions` (the same greedy
    semantics; the host has float64, so ``ceil(t * cov)`` is computed
    directly)."""
    from ..constants import IUPAC_MASK_LUT as _lut

    k, cp = table.shape[0], table.shape[1]
    completed = table.copy()
    completed[:, :, 0] = site_cov[:, None] - table.sum(axis=-1)  # quirk 4
    sgs = np.zeros(completed.shape, dtype=np.int32)       # [K, C, 6]
    for j in range(6):
        cj = completed[:, :, j:j + 1]
        sgs += cj * (cj > completed)
    nonzero = completed != 0
    bits = (1 << np.arange(6, dtype=np.int32))
    valid = np.arange(cp, dtype=np.int32)[None, :] < n_cols[:, None]
    out = np.empty((len(thresholds), k, cp), dtype=np.uint8)
    cov64 = site_cov.astype(np.float64)
    for ti, t in enumerate(thresholds):
        cutoff = np.ceil(np.float64(t) * cov64)           # [K]
        included = nonzero & (sgs < cutoff[:, None, None])
        mask = (included * bits).sum(axis=-1)             # [K, C]
        syms = _lut[mask]
        skip = (syms == ord("-")) | ~valid
        out[ti] = np.where(skip, np.uint8(FILL_SENTINEL), syms)
    return out
