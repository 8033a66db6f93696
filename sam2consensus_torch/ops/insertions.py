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
"""

from __future__ import annotations

from typing import Sequence

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
    fill = torch.tensor(FILL_SENTINEL, dtype=torch.uint8, device=table.device)
    rows = []
    for t in thresholds:
        cutoff = exact_cutoff(site_cov, t)[:, None].expand(table.shape[:2])
        syms = iupac_select(called_masks(completed, sgs, cutoff))
        skip = (syms == ord("-")) | ~valid
        rows.append(torch.where(skip, fill, syms))
    return torch.stack(rows)
