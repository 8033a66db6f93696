"""The ``--mem-budget`` size grammar.

Copy of ``parse_budget`` from ``sam2consensus_tpu/serve/countcache.py``
(pinned by ``tests/test_torch_copies.py``), which the serve runner reads
``--mem-budget`` / ``S2C_MEM_BUDGET`` with.  The per-reference count cache
itself (``--count-cache``, serve ``--incremental``) comes with its own
slice; the runner refuses both by name until then.
"""

from __future__ import annotations

import re


def parse_budget(value) -> int:
    """``--count-cache`` grammar -> byte budget (0 = disabled).

    Accepts ``off``/``0``/empty (disabled) or a size with an optional
    K/M/G suffix (``512M``, ``2G``, ``1048576``).  Raises ValueError on
    anything else — a typo'd cache budget must fail the server start,
    not silently disable incremental serving."""
    if value is None:
        return 0
    v = str(value).strip().lower()
    if v in ("", "off", "0", "none"):
        return 0
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([kmg]?)b?", v)
    if not m:
        raise ValueError(
            f"--count-cache {value!r}: use 'off' or a byte budget like "
            f"'512M', '2G', '1048576'")
    mult = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[m.group(2)]
    n = int(float(m.group(1)) * mult)
    if n <= 0:
        return 0
    return n
