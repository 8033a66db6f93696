"""The pipeline tail in one packed buffer: vote + insertion table + stats.

Port of ``sam2consensus_tpu/ops/fused.py``.  The whole post-accumulation
tail produces ONE uint8 buffer, fetched with one device-to-host copy:

    [ position head | insertion syms T*Kp*Cp | contig cov sums C*4
      | site cov Kp*4 | dash counts T*C*4 (device epilogue only) ]

where the position head is one of three encodings (``out_enc``,
:func:`_syms_head`): dense ASCII ``T*L`` (``None``); sparse, an emit
bitmask ``ceil(L/8)`` and ``T*cap`` characters compacted to the emitted
positions (an int ``cap``); or packed5, a nibble plane ``T*ceil(L/2)`` and
a high-bit plane ``T*ceil(L/8)`` of the vote's 5-bit codes (``"packed5"``).
The buffers are byte-identical to the JAX functions for the same inputs
(``tests/test_torch_ops.py``, ``tests/test_torch_encodings.py``).

The insertion vote runs in the kernels (:func:`vote_packed`: K2 when the
padded column count ``cp`` is at most ``FUSED_VOTE_MAX_CP``, else K3 and
the torch vote, the JAX split at ``ops/fused.py:333-342``) or, under
``--insertion-kernel scatter``, in the torch scatter and vote
(:func:`vote_packed_scatter`).  All take the events straight, unsorted,
and no route synchronises with the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .insertion_kernel import (FUSED_VOTE_MAX_CP, build_insertion_table_kernel,
                               vote_insertions_fused)
from .insertions import build_insertion_table, vote_insertions
from .vote import emit_gate, vote_block


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


def _pack_bits_le(mask: torch.Tensor) -> torch.Tensor:
    """Bool ``[L]`` -> uint8 ``[ceil(L/8)]``, little bit order (the host
    inverse is ``np.unpackbits(..., bitorder="little")``)."""
    m = mask.to(torch.int32)
    pad = (-m.shape[0]) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    bit = torch.arange(8, dtype=torch.int32, device=m.device)
    return (m.reshape(-1, 8) << bit).sum(dim=1).to(torch.uint8)


def _sparse_syms(syms: torch.Tensor, emit: torch.Tensor, cap: int):
    """The per-threshold symbols compacted to the emitted positions: the
    emit bitmask (threshold-independent) and ``[T, cap]`` characters.  The
    compaction is a scatter into ``cap + 1`` columns, whose last one takes
    every unemitted position, then a slice (a mask index would
    synchronise)."""
    bits = _pack_bits_le(emit)
    idx = torch.cumsum(emit.to(torch.int32), dim=0, dtype=torch.int32) - 1
    tgt = torch.where(emit, idx, cap).clamp(max=cap).long()
    compact = torch.zeros((syms.shape[0], cap + 1), dtype=torch.uint8,
                          device=syms.device)
    compact.scatter_(1, tgt.expand(syms.shape[0], -1), syms)
    return bits, compact[:, :cap]


def _pack5_planes(code5: torch.Tensor):
    """``[T, L]`` 5-bit symbol codes -> a nibble plane ``[T, ceil(L/2)]``
    (even positions in the low nibble) and a high-bit plane
    ``[T, ceil(L/8)]`` (little bit order): 0.625 bytes a character."""
    c = code5.to(torch.int32)
    t, length = c.shape
    pad = (-length) % 8
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
    pairs = (c & 15).reshape(t, -1, 2)
    nibs = (pairs[..., 0] | (pairs[..., 1] << 4)).to(torch.uint8)
    bit = torch.arange(8, dtype=torch.int32, device=c.device)
    hbits = ((c >> 4).reshape(t, -1, 8) << bit).sum(dim=-1).to(torch.uint8)
    return nibs[:, :(length + 1) // 2], hbits[:, :(length + 7) // 8]


def sym_space(out_enc) -> str:
    """Copy: the vote's symbol space for a tail encoding: packed5 votes in
    5-bit codes (``ops.vote.IUPAC_MASK_LUT5``), dense and sparse in
    ASCII."""
    return "code5" if out_enc == "packed5" else "ascii"


def dash_code(out_enc) -> int:
    """Copy: ``'-'`` in the vote's symbol space (1 in code5)."""
    return 1 if out_enc == "packed5" else ord("-")


def _syms_head(syms, cov, min_depth: int, out_enc) -> list:
    """The position-symbol section of the packed buffer: ``None`` dense
    ``[T*L]``; an int, sparse (emit bitmask + characters compacted to that
    capacity); ``"packed5"``, the 5-bit planes (``syms`` in code5)."""
    if out_enc is None:
        return [syms.reshape(-1)]
    if out_enc == "packed5":
        return [p.reshape(-1) for p in _pack5_planes(syms)]
    bits, compact = _sparse_syms(syms, emit_gate(cov, min_depth), out_enc)
    return [bits, compact.reshape(-1)]


def _epilogue_sections(syms, offsets, out_enc, epilogue: bool) -> list:
    if not epilogue:
        return []
    return [_bytes_of_i32(contig_dash_counts(syms, offsets,
                                             dash_code(out_enc)).reshape(-1))]


def vote_packed_simple(counts: torch.Tensor, thresholds: Sequence[float],
                       offsets: torch.Tensor, min_depth: int,
                       fill_code: int = 0, epilogue: bool = False,
                       out_enc=None) -> torch.Tensor:
    """No-insertion tail: position vote + contig sums, one packed buffer;
    ``out_enc`` the position head's encoding (:func:`_syms_head`)."""
    syms, cov = vote_block(counts, thresholds, min_depth, sym_space(out_enc),
                           fill_code)
    contig_sums, _ = _tail_stats(
        cov, offsets, torch.full((1,), -1, dtype=torch.int32,
                                 device=cov.device))
    return torch.cat(_syms_head(syms, cov, min_depth, out_enc)
                     + [_bytes_of_i32(contig_sums)]
                     + _epilogue_sections(syms, offsets, out_enc, epilogue))


def vote_packed(counts: torch.Tensor, thresholds: Sequence[float],
                offsets: torch.Tensor, site_keys: torch.Tensor,
                n_cols: torch.Tensor, ev_key: torch.Tensor,
                ev_col: torch.Tensor, ev_code: torch.Tensor,
                min_depth: int, cp: int, fill_code: int = 0,
                epilogue: bool = False, out_enc=None) -> torch.Tensor:
    """Position vote + insertion table + insertion vote + stats, packed,
    with the insertion kernels (the reference's
    ``_vote_packed_pallas_body``): K2 up to ``FUSED_VOTE_MAX_CP`` padded
    columns, else K3 and the torch vote.

    ``site_keys``/``n_cols`` are the padded ``[Kp]`` site arrays (flat
    position, -1 for end-of-contig and pad sites); ``cp`` is the padded
    column count; events key into ``[0, Kp)``; ``out_enc`` the position
    head's encoding."""
    def table_vote(site_cov):
        if cp <= FUSED_VOTE_MAX_CP:
            return vote_insertions_fused(ev_key, ev_col, ev_code, site_cov,
                                         n_cols, cp, thresholds)
        table = build_insertion_table_kernel(ev_key, ev_col, ev_code,
                                             site_keys.shape[0], cp)
        return vote_insertions(table, site_cov, n_cols, thresholds)

    return _packed_with_insertions(counts, thresholds, offsets, site_keys,
                                   min_depth, fill_code, epilogue, out_enc,
                                   table_vote)


def vote_packed_scatter(counts: torch.Tensor, thresholds: Sequence[float],
                        offsets: torch.Tensor, site_keys: torch.Tensor,
                        n_cols: torch.Tensor, ev_key: torch.Tensor,
                        ev_col: torch.Tensor, ev_code: torch.Tensor,
                        min_depth: int, cp: int, fill_code: int = 0,
                        epilogue: bool = False,
                        out_enc=None) -> torch.Tensor:
    """:func:`vote_packed` with the table by the torch scatter
    (``ops.insertions.build_insertion_table``) and the torch vote: the
    ``--insertion-kernel scatter`` route (the reference's
    ``_vote_packed_body``)."""
    def table_vote(site_cov):
        table = build_insertion_table(site_keys.shape[0], cp, ev_key, ev_col,
                                      ev_code)
        return vote_insertions(table, site_cov, n_cols, thresholds)

    return _packed_with_insertions(counts, thresholds, offsets, site_keys,
                                   min_depth, fill_code, epilogue, out_enc,
                                   table_vote)


def _packed_with_insertions(counts, thresholds, offsets, site_keys,
                            min_depth, fill_code, epilogue, out_enc,
                            table_vote) -> torch.Tensor:
    syms, cov = vote_block(counts, thresholds, min_depth, sym_space(out_enc),
                           fill_code)
    contig_sums, site_cov = _tail_stats(cov, offsets, site_keys)
    ins_syms = table_vote(site_cov)
    return torch.cat(_syms_head(syms, cov, min_depth, out_enc)
                     + [ins_syms.reshape(-1), _bytes_of_i32(contig_sums),
                        _bytes_of_i32(site_cov)]
                     + _epilogue_sections(syms, offsets, out_enc, epilogue))
