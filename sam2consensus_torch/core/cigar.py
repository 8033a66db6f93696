"""CIGAR op parsing: copy of ``split_ops`` from ``sam2consensus_tpu/core/cigar.py``.

Ops are parsed with the reference's regex (``parsecigar``,
``sam2consensus.py:46-82``), so malformed CIGAR text degrades the same way
(unmatched trailing garbage is silently ignored).
"""

from __future__ import annotations

import re
from typing import List, Tuple

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHPX=]{1})")


def split_ops(cigarstring: str) -> List[Tuple[int, str]]:
    """Parse a CIGAR string into (length, op) pairs via the spec regex."""
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigarstring)]
