"""The pipeline tail in one packed buffer: vote + insertion table + stats.

Port of the dense-ASCII route of ``sam2consensus_tpu/ops/fused.py``.  The
whole post-accumulation tail produces ONE uint8 buffer, fetched with one
device-to-host copy:

    [ syms T*L | insertion syms T*Kp*Cp | contig cov sums C*4 | site cov Kp*4
      | dash counts T*C*4 (device epilogue only) ]

byte-identical to the JAX functions for the same inputs
(``tests/test_torch_ops.py``).  The insertion vote runs in K2, straight
from the events, when the padded column count ``cp`` is at most
``FUSED_VOTE_MAX_CP``; else in K3 (after ``plan_events``) and the torch
vote (the JAX split at ``ops/fused.py:333-342``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .insertion_kernel import (FUSED_VOTE_MAX_CP, build_insertion_table_kernel,
                               plan_events, vote_insertions_fused)
from .insertions import vote_insertions
from .vote import vote_block


def next_pow2(n: int) -> int:
    """Copy."""
    return 1 << max(0, (n - 1)).bit_length()


_CAP_BUCKET = 1 << 20


def pad_cap(n: int) -> int:
    """Copy: power of two below 1 MiB, then the next multiple of 1 MiB."""
    if n <= _CAP_BUCKET:
        return next_pow2(n)
    return -(-n // _CAP_BUCKET) * _CAP_BUCKET


def unpack_i32(buf, n: int):
    """Copy: host inverse of :func:`_bytes_of_i32` (numpy uint8 slice)."""
    b = np.asarray(buf, dtype=np.uint8).reshape(n, 4).astype(np.uint32)
    out = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return out.astype(np.int64)


def coverage(counts: torch.Tensor) -> torch.Tensor:
    """Per-position depth ``[L]`` int32 — gaps and Ns count (quirk 5)."""
    return counts.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def _bytes_of_i32(x: torch.Tensor) -> torch.Tensor:
    """Little-endian byte split of an int32 vector -> uint8 ``[n*4]``."""
    x = x.to(torch.int32)
    parts = [((x >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(-1)


def _tail_stats(cov: torch.Tensor, offsets: torch.Tensor,
                site_keys: torch.Tensor):
    """(contig_sums int32 [C], site_cov int32 [Kp]) from resident coverage.
    The sums wrap modulo 2^32 like the JAX int32 cumsum; the backend
    recomputes them in int64 when total aligned bases pass 2^31."""
    contig_sums = contig_sums_i64(cov, offsets).to(torch.int32)
    safe = site_keys.long().clamp(min=0)
    site_cov = torch.where(site_keys >= 0, cov[safe], 0).to(torch.int32)
    return contig_sums, site_cov


def contig_sums_i64(cov: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Exact int64 per-contig coverage sums."""
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=cov.device),
                        cov.to(torch.int64).cumsum(0)])
    return prefix[offsets[1:]] - prefix[offsets[:-1]]


def contig_dash_counts(syms: torch.Tensor, offsets: torch.Tensor,
                       dash_code: int) -> torch.Tensor:
    """Per-(threshold, contig) ``'-'`` totals of the post-fill symbols,
    int32 ``[T, C]`` (the device epilogue's stripped-length math)."""
    is_dash = (syms == dash_code).to(torch.int64)
    prefix = torch.cat([torch.zeros((syms.shape[0], 1), dtype=torch.int64,
                                    device=syms.device),
                        is_dash.cumsum(1)], dim=1)
    return (prefix[:, offsets[1:]] - prefix[:, offsets[:-1]]).to(torch.int32)


def _epilogue_sections(syms, offsets, epilogue: bool) -> list:
    if not epilogue:
        return []
    return [_bytes_of_i32(contig_dash_counts(syms, offsets,
                                             ord("-")).reshape(-1))]


def vote_packed_simple(counts: torch.Tensor, thresholds: Sequence[float],
                       offsets: torch.Tensor, min_depth: int,
                       fill_code: int = 0,
                       epilogue: bool = False) -> torch.Tensor:
    """No-insertion tail: position vote + contig sums, one packed buffer."""
    syms, cov = vote_block(counts, thresholds, min_depth, "ascii", fill_code)
    contig_sums, _ = _tail_stats(
        cov, offsets, torch.full((1,), -1, dtype=torch.int32,
                                 device=cov.device))
    return torch.cat([syms.reshape(-1), _bytes_of_i32(contig_sums)]
                     + _epilogue_sections(syms, offsets, epilogue))


def vote_packed(counts: torch.Tensor, thresholds: Sequence[float],
                offsets: torch.Tensor, site_keys: torch.Tensor,
                n_cols: torch.Tensor, ev_key: torch.Tensor,
                ev_col: torch.Tensor, ev_code: torch.Tensor,
                min_depth: int, cp: int, fill_code: int = 0,
                epilogue: bool = False) -> torch.Tensor:
    """Position vote + insertion table + insertion vote + stats, packed.

    ``site_keys``/``n_cols`` are the padded ``[Kp]`` site arrays (flat
    position, -1 for end-of-contig and pad sites); ``cp`` is the padded
    column count; events key into ``[0, Kp)``."""
    syms, cov = vote_block(counts, thresholds, min_depth, "ascii", fill_code)
    contig_sums, site_cov = _tail_stats(cov, offsets, site_keys)
    if cp <= FUSED_VOTE_MAX_CP:
        ins_syms = vote_insertions_fused(ev_key, ev_col, ev_code, site_cov,
                                         n_cols, cp, thresholds)
    else:
        table = build_insertion_table_kernel(
            plan_events(ev_key, ev_col, ev_code, site_keys.shape[0], cp))
        ins_syms = vote_insertions(table, site_cov, n_cols, thresholds)
    return torch.cat([syms.reshape(-1), ins_syms.reshape(-1),
                      _bytes_of_i32(contig_sums), _bytes_of_i32(site_cov)]
                     + _epilogue_sections(syms, offsets, epilogue))
