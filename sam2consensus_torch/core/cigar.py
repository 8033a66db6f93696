"""CIGAR ops: copies of ``split_ops``, ``BAM_OPS`` and ``render_ops`` from
``sam2consensus_tpu/core/cigar.py``.

Ops are parsed with the reference's regex (``parsecigar``,
``sam2consensus.py:46-82``), so malformed CIGAR text degrades the same way
(unmatched trailing garbage is silently ignored).
"""

from __future__ import annotations

import re
from typing import List, Tuple

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHPX=]{1})")

#: BAM binary op order (SAM spec §4.2: ``op = cigar_u32 & 0xF`` indexes
#: this string), shared by the BAM decoder, the BAM writer and the C++
#: record parser's mirror table (decoder.cpp kOpChr)
BAM_OPS = "MIDNSHP=X"


def render_ops(ops) -> str:
    """((length, op), ...) -> CIGAR text (``"*"`` for the empty tuple),
    the inverse of :func:`split_ops` for in-contract op lists."""
    if not ops:
        return "*"
    return "".join(f"{n}{op}" for n, op in ops)


def split_ops(cigarstring: str) -> List[Tuple[int, str]]:
    """Parse a CIGAR string into (length, op) pairs via the spec regex."""
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigarstring)]
