"""K2 and K3 launch wrappers: the insertion kernels (``csrc/insertion.cu``).

Replaces ``sam2consensus_tpu/ops/pallas_insertion.py``.  The plan keeps
``plan_events``' logic (events sorted by site key, a CSR event range per
key) re-parameterised for the card's blocking: one CUDA block per
(key, chunk of ``COL_CHUNK`` columns) instead of 128 keys x all columns
per TPU block.

* K2, :func:`vote_insertions_fused`: the fused table + vote, returning
  uint8 ``[T, kp, cp]`` in the contract of the JAX
  ``vote_insertions_fused`` (FILL_SENTINEL for ``-`` calls and for columns
  past ``n_cols``);
* K3, :func:`build_insertion_table_kernel`: the table only, int32
  ``[kp, cp, 6]`` in the contract of ``build_insertion_table_pallas``.

On CPU tensors both run their plain versions from ``ops/insertions.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..constants import IUPAC_MASK_LUT, NUM_SYMBOLS
from ..kernels.build import Kernel
from .insertions import build_insertion_table, vote_insertions

#: columns per CUDA block: a [512, 6] int32 shared table is 12 KiB
COL_CHUNK = 512

#: copy of ``pallas_insertion.FUSED_VOTE_MAX_CP``: the fused vote serves
#: tables up to this many (padded) columns, the table kernel + torch vote
#: wider ones (the same split as ``ops/fused.py:333-342``)
FUSED_VOTE_MAX_CP = 512

K3 = Kernel("insertion_table", "insertion.cu")
K2 = Kernel("insertion_vote", "insertion.cu")


class EventPlan(NamedTuple):
    """Key-sorted events and the CSR event range of every key."""
    key: torch.Tensor        # [E] int32, ascending
    cc: torch.Tensor         # [E] int32 col * 6 + code
    key_ptr: torch.Tensor    # [kp + 1] int32
    kp: int                  # keys (table rows)
    cp: int                  # columns


def plan_events(ev_key: torch.Tensor, ev_col: torch.Tensor,
                ev_code: torch.Tensor, n_keys: int, cp: int) -> EventPlan:
    """Sort events by key (stable) and build the per-key CSR offsets."""
    order = torch.argsort(ev_key.long(), stable=True)
    key = ev_key.index_select(0, order).int()
    cc = (ev_col.index_select(0, order).int() * NUM_SYMBOLS
          + ev_code.index_select(0, order).int())
    per_key = torch.bincount(key.long(), minlength=n_keys)
    if len(per_key) != n_keys:
        raise ValueError(f"event keys must lie in [0, {n_keys})")
    key_ptr = torch.zeros(n_keys + 1, dtype=torch.int32, device=key.device)
    key_ptr[1:] = per_key.cumsum(0)
    return EventPlan(key.contiguous(), cc.contiguous(), key_ptr, n_keys, cp)


def _plain_table(plan: EventPlan) -> torch.Tensor:
    return build_insertion_table(plan.kp, plan.cp, plan.key,
                                 plan.cc // NUM_SYMBOLS,
                                 plan.cc % NUM_SYMBOLS)


def build_insertion_table_kernel(plan: EventPlan) -> torch.Tensor:
    """K3: the int32 ``[kp, cp, 6]`` insertion count table."""
    if plan.key.device.type == "cpu":
        return _plain_table(plan)
    out = torch.empty((plan.kp, plan.cp, NUM_SYMBOLS), dtype=torch.int32,
                      device=plan.key.device)
    if plan.kp and plan.cp:
        K3.launch(plan.key_ptr, plan.cc, min(COL_CHUNK, plan.cp), out)
    return out


_LUTS = {}


def _lut(device) -> torch.Tensor:
    lut = _LUTS.get(device)
    if lut is None:
        lut = torch.as_tensor(IUPAC_MASK_LUT, dtype=torch.uint8).to(device)
        _LUTS[device] = lut
    return lut


def vote_insertions_fused(plan: EventPlan, site_cov: torch.Tensor,
                          n_cols: torch.Tensor,
                          thresholds: Sequence[float]) -> torch.Tensor:
    """K2: table + vote in one kernel; uint8 ``[T, kp, cp]``.

    ``site_cov`` and ``n_cols`` are int32 ``[kp]`` on the plan's device."""
    dev = plan.key.device
    if dev.type == "cpu":
        return vote_insertions(_plain_table(plan), site_cov, n_cols,
                               thresholds)
    site_cov = site_cov.to(torch.int32).contiguous()
    n_cols = n_cols.to(torch.int32).contiguous()
    if site_cov.shape != (plan.kp,) or n_cols.shape != (plan.kp,) \
            or site_cov.device != dev or n_cols.device != dev:
        raise ValueError(f"site_cov and n_cols must be [{plan.kp}] on {dev}")
    thr = torch.tensor([float(t) for t in thresholds], dtype=torch.float64,
                       device=dev)
    out = torch.empty((len(thr), plan.kp, plan.cp), dtype=torch.uint8,
                      device=dev)
    if plan.kp and plan.cp and len(thr):
        K2.launch(plan.key_ptr, plan.cc, site_cov, n_cols, thr, _lut(dev),
                  min(COL_CHUNK, plan.cp), out)
    return out
