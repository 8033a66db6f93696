"""The row wire: the ``delta8`` codec (:mod:`.codec`), its device unpack
(:mod:`.device`), the staging slots (:mod:`.pipeline`), and the run's
link bill (:class:`WireAccount`).

The account is the port's form of the reference's ``account_h2d``,
``account_wire`` and ``wire/fallback_slabs`` metrics
(``sam2consensus_tpu/wire/__init__.py``, ``ops/pileup.py``): the backend
copies it into ``stats.extra`` (:meth:`WireAccount.extra`).
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
        self.bytes += int(nbytes)
        self.rows_bytes += n_rows * (4 + width)
        self.packed5_bytes += packed5_slab_bytes(n_rows, width)
        self.slabs[codec] = self.slabs.get(codec, 0) + 1

    def extra(self) -> dict:
        """The ``stats.extra`` keys: ``h2d_bytes``, ``wire_rows_bytes``,
        ``wire_packed5_bytes``, ``wire_slabs`` and
        ``wire_fallback_slabs``."""
        return {"h2d_bytes": self.bytes, "wire_rows_bytes": self.rows_bytes,
                "wire_packed5_bytes": self.packed5_bytes,
                "wire_slabs": dict(self.slabs),
                "wire_fallback_slabs": self.fallback_slabs}


def encode_wire_slab(wire: str, starts: np.ndarray, codes: np.ndarray,
                     account: WireAccount):
    """The delta8 encode gate (the reference's ``encode_wire_slab``): the
    canonical (sorted) rows encoded, or ``None`` to ship the rows raw
    (codec off, or an encoded slab that would not shrink: counted in
    ``account.fallback_slabs``)."""
    if wire != "delta8":
        return None
    slab = encode_slab(*canonicalize_rows(starts, codes))
    if slab is None or not worthwhile(slab):
        account.fallback_slabs += 1
        return None
    return slab
