"""K2 and K3 launch wrappers: the insertion kernels (``csrc/insertion.cu``).

Replaces ``sam2consensus_tpu/ops/pallas_insertion.py``.

* K2, :func:`vote_insertions_fused`: the fused table + vote from the tail's
  events as they come, unsorted: no plan, no host synchronisation and no
  host-to-device copy (the thresholds and the IUPAC LUT travel in the
  launch's parameters).  Returns uint8 ``[T, kp, cp]`` in the contract of
  the JAX ``vote_insertions_fused`` (FILL_SENTINEL for ``-`` calls and for
  columns past ``n_cols``);
* K3, :func:`build_insertion_table_kernel`: the table only, int32
  ``[kp, cp, 6]`` in the contract of ``build_insertion_table_pallas``,
  from :func:`plan_events` (``plan_events``' logic: events sorted by site
  key, a CSR event range per key; one CUDA block per (key, chunk of
  ``COL_CHUNK`` columns) instead of 128 keys x all columns per TPU block).

On CPU tensors both run their plain versions from ``ops/insertions.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..constants import IUPAC_MASK_LUT, NUM_SYMBOLS
from ..kernels.build import Kernel
from .insertions import build_insertion_table, vote_insertions

#: columns per K3 block: a [512, 6] int32 shared table is 12 KiB
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


#: the IUPAC LUT as the K2 entry point takes it (by value)
_LUT = IUPAC_MASK_LUT.astype("uint8").tobytes()


def _int32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def vote_insertions_fused(ev_key: torch.Tensor, ev_col: torch.Tensor,
                          ev_code: torch.Tensor, site_cov: torch.Tensor,
                          n_cols: torch.Tensor, cp: int,
                          thresholds: Sequence[float]) -> torch.Tensor:
    """K2: table + vote of unsorted events; uint8 ``[T, kp, cp]``.

    ``ev_*`` are ``[E]`` (site key in ``[0, kp)``, column in ``[0, cp)``,
    code in ``[0, 6)``); ``site_cov`` and ``n_cols`` are ``[kp]``, all on one
    device.  Integer tensors of another type are converted on the device."""
    kp = site_cov.shape[0]
    dev = site_cov.device
    if dev.type == "cpu":
        table = build_insertion_table(kp, cp, ev_key, ev_col, ev_code)
        return vote_insertions(table, site_cov, n_cols, thresholds)
    ev = [_int32(t) for t in (ev_key, ev_col, ev_code)]
    site_cov, n_cols = _int32(site_cov), _int32(n_cols)
    if n_cols.shape != (kp,) or any(t.device != dev for t in ev + [n_cols]):
        raise ValueError(f"n_cols must be [{kp}] and every input on {dev}")
    out = torch.empty((len(thresholds), kp, cp), dtype=torch.uint8,
                      device=dev)
    if out.numel():
        table = torch.empty((kp, cp, NUM_SYMBOLS), dtype=torch.int32,
                            device=dev)
        K2.launch(*ev, site_cov, n_cols, [float(t) for t in thresholds],
                  _LUT, table, out)
    return out
