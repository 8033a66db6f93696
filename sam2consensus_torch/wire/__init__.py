"""The row wire: the ``delta8`` codec (:mod:`.codec`), its device unpack
(:mod:`.device`), the staging slots (:mod:`.pipeline`), and the run's
link bill (:class:`WireAccount`).

The account is the port's form of the reference's ``account_h2d``,
``account_wire`` and ``wire/fallback_slabs`` metrics
(``sam2consensus_tpu/wire/__init__.py``, ``ops/pileup.py``): the backend
copies it into ``stats.extra`` (:meth:`WireAccount.extra`), and each slab
also lands in the run's registry under the reference's names
(``wire/bytes``, ``wire/raw_bytes``, ``wire/slabs/<codec>``,
``wire/h2d_bytes``, ``wire/fallback_slabs``).
"""

from __future__ import annotations

import numpy as np

from .codec import (canonicalize_rows, encode_slab, packed5_slab_bytes,
                    worthwhile)


class WireAccount:
    """One run's rows on the link: ``bytes`` that crossed; beside them
    ``rows_bytes``, what the raw rows would have shipped (int32 starts and
    uint8 codes, ``4 + W`` bytes a row, the port's ``packed5`` wire), and
    ``packed5_bytes``, their packed5-equivalent
    (``codec.packed5_slab_bytes``, the reference's raw bill); the slabs
    shipped under each codec, and the delta8 slabs that ``worthwhile``
    refused (shipped raw instead).  Written by the thread that stages."""

    def __init__(self):
        self.bytes = 0
        self.rows_bytes = 0
        self.packed5_bytes = 0
        self.slabs: dict = {}
        self.fallback_slabs = 0

    def add(self, codec: str, nbytes: int, n_rows: int, width: int) -> None:
        from .. import observability as obs

        raw = packed5_slab_bytes(n_rows, width)
        self.bytes += int(nbytes)
        self.rows_bytes += n_rows * (4 + width)
        self.packed5_bytes += raw
        self.slabs[codec] = self.slabs.get(codec, 0) + 1
        reg = obs.metrics()
        reg.add("wire/bytes", int(nbytes))
        reg.add("wire/raw_bytes", raw)
        reg.add(f"wire/slabs/{codec}", 1)
        reg.add("wire/h2d_bytes", int(nbytes))

    def add_operand(self, nbytes: int) -> None:
        """A kernel operand that crossed beside the rows (the MXU slot
        vector): host-to-device bytes, not row-wire bytes."""
        from .. import observability as obs

        self.bytes += int(nbytes)
        obs.metrics().add("wire/h2d_bytes", int(nbytes))

    def extra(self) -> dict:
        """The ``stats.extra`` keys: ``h2d_bytes``, ``wire_rows_bytes``,
        ``wire_packed5_bytes``, ``wire_slabs`` and
        ``wire_fallback_slabs``."""
        return {"h2d_bytes": self.bytes, "wire_rows_bytes": self.rows_bytes,
                "wire_packed5_bytes": self.packed5_bytes,
                "wire_slabs": dict(self.slabs),
                "wire_fallback_slabs": self.fallback_slabs}


def encode_wire_slab(wire: str, starts: np.ndarray, codes: np.ndarray,
                     account: WireAccount, chunks: int = 1):
    """The delta8 encode gate (the reference's ``encode_wire_slab``): the
    canonical (sorted) rows encoded, or ``None`` to ship the rows raw
    (codec off, a slab that does not split into ``chunks``, or an encoded
    slab that would not shrink: counted in ``account.fallback_slabs``).
    ``chunks`` > 1 encodes ``chunks`` equal runs of rows, each its own
    delta chain, in place: a sharded accumulator's rows are already
    canonical and each run belongs to one shard, which decodes its own
    chunk.  The ``wire_encode`` fault site fires here, on whichever
    thread is encoding (the staging thread, or the consumer for an
    unstaged batch)."""
    if wire != "delta8":
        return None
    from ..resilience.faultinject import fault_check

    fault_check("wire_encode")
    if chunks == 1:
        starts, codes = canonicalize_rows(starts, codes)
    slab = encode_slab(starts, codes, chunks=chunks)
    if slab is None or not worthwhile(slab):
        from .. import observability as obs

        account.fallback_slabs += 1
        obs.metrics().add("wire/fallback_slabs", 1)
        return None
    return slab
