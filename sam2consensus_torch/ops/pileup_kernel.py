"""K1 launch wrapper: the pileup histogram kernel (``csrc/pileup.cu``).

Replaces ``sam2consensus_tpu/ops/pallas_pileup.py``.  The TPU plan
(counting-sort rows by position tile, a CSR range of rows per tile) exists
because a TPU grid step owns one tile in VMEM.  On the card the plan is
:func:`plan_rows`: one device sort of the starts, whose permutation the
kernel reads in place of a row gather.  The kernel's entry point sizes its
grid from the row count, the row width and the SM count, so nothing is read
back to the host and the route (:func:`accumulate_rows`) never
synchronises.  The block geometry (shared window, stage, rows a block)
lives in the kernel's source alone (see its note).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.build import Kernel
from .pileup import scatter_segments_packed

K1 = Kernel("pileup_rows", "pileup.cu")


class RowPlan(NamedTuple):
    """Rows sorted by start, on their device."""
    starts: torch.Tensor     # [N] int32, ascending
    order: torch.Tensor      # [N] int64: sorted row r is input row order[r]


def plan_rows(starts: torch.Tensor) -> RowPlan:
    """Sort the rows by start on their device."""
    sorted_starts, order = torch.sort(starts)
    return RowPlan(sorted_starts, order)


def accumulate_rows(counts: torch.Tensor, starts: torch.Tensor,
                    packed: torch.Tensor) -> torch.Tensor:
    """``counts[start_r + j, code_r[j]] += 1`` over nibble-packed rows, in
    place; returns ``counts``.

    ``counts`` int32 ``[P, 6]``, ``starts`` int32 ``[N]`` (>= 0),
    ``packed`` uint8 ``[N, W/2]``.  On CUDA tensors this launches K1 (or
    raises) with no host synchronisation; on CPU tensors it runs the plain
    version."""
    if counts.device.type == "cpu":
        return scatter_segments_packed(counts, starts, packed)
    if (counts.dtype != torch.int32 or counts.dim() != 2
            or counts.shape[1] != 6 or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int32 [P, 6] tensor")
    if starts.dtype != torch.int32 or packed.dtype != torch.uint8 \
            or packed.dim() != 2 or starts.shape[0] != packed.shape[0]:
        raise ValueError("starts must be int32 [N], packed uint8 [N, W/2]")
    if starts.device != counts.device or packed.device != counts.device:
        raise ValueError("counts, starts and packed must share a device")
    if packed.numel() == 0:
        return counts
    plan = plan_rows(starts)
    K1.launch(plan.starts, plan.order, packed.contiguous(), counts)
    return counts
