"""The flagship "model": pileup + threshold vote as one forward step.

Port of ``sam2consensus_tpu/models/consensus.py``.  There is no neural
network in this workload; the model is the consensus caller itself.
:func:`make_consensus_model` closes over the genome's length and returns a
module whose forward

    forward(starts, codes, thresholds) -> (syms, cov)

expands one batch of segment rows (flat-genome start + uint8 code row,
``encoder.events.SegmentBatch``), scatter-adds them into a fresh
``[L + 1, 6]`` int32 count tensor (``index_put_`` with ``accumulate``, as
the reference's ``.at[].add``; PAD cells and cells past the genome land in
the sacrificial row ``L``, which is dropped) and votes every position for
every threshold (``ops.vote.vote_block``).  It is torch ops, like the
reference's XLA step: the one-shot and serve paths decompose the same two
operations (``ops/pileup.py``, ``parallel/``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..constants import NUM_SYMBOLS
from ..ops.vote import vote_block


class ConsensusModel(nn.Module):
    """Pileup and vote of one batch over a genome of ``total_len``."""

    def __init__(self, total_len: int, min_depth: int = 1):
        super().__init__()
        self.total_len = total_len
        self.min_depth = min_depth

    def forward(self, starts: torch.Tensor, codes: torch.Tensor,
                thresholds: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = codes.shape[1]
        pos = starts.long()[:, None] + torch.arange(w, device=codes.device)
        valid = (codes < NUM_SYMBOLS) & (pos <= self.total_len)
        pos = torch.where(valid, pos, self.total_len).reshape(-1)
        code = torch.where(valid, codes.long(), 0).reshape(-1)
        counts = torch.zeros((self.total_len + 1, NUM_SYMBOLS),
                             dtype=torch.int32, device=codes.device)
        counts.index_put_((pos, code), torch.ones_like(pos, dtype=torch.int32),
                          accumulate=True)
        return vote_block(counts[:-1], thresholds, self.min_depth)


def make_consensus_model(total_len: int, min_depth: int = 1) -> nn.Module:
    """The forward step for a genome of ``total_len`` (the reference's
    ``make_consensus_model``)."""
    return ConsensusModel(total_len, min_depth)
