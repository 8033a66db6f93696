"""Shared constants: the consensus alphabet and the IUPAC ambiguity mapping.

Copy of ``sam2consensus_tpu/constants.py`` (pinned equal by
``tests/test_torch_copies.py``).  The reference hard-codes a 6-symbol
per-position count alphabet (reference ``sam2consensus.py:167``) and a literal
ambiguity dictionary (``sam2consensus.py:317-329``); both are derived here:

* ``ALPHABET`` is the 6 symbols in ASCII-sorted order, so a symbol index
  doubles as a bit position in the 6-bit called-set mask of the vote.
* ``AMB`` maps every non-empty called subset to its output character: the
  nucleotide part picks the IUPAC code, ``ACGT`` (with or without ``-``/``N``)
  is ``N``, and the code is lowercased when ``-`` or ``N`` joins the set.
"""

from __future__ import annotations

import numpy as np

#: Count-lane alphabet in ASCII-sorted order; index == bit position in masks.
ALPHABET = "-ACGNT"
GAP, A, C, G, N, T = range(6)
NUM_SYMBOLS = 6

#: Standard IUPAC codes keyed by frozenset of nucleotides.
_IUPAC_CORE = {
    frozenset("A"): "A", frozenset("C"): "C", frozenset("G"): "G",
    frozenset("T"): "T",
    frozenset("AC"): "M", frozenset("AG"): "R", frozenset("AT"): "W",
    frozenset("CG"): "S", frozenset("CT"): "Y", frozenset("GT"): "K",
    frozenset("ACG"): "V", frozenset("ACT"): "H", frozenset("AGT"): "D",
    frozenset("CGT"): "B", frozenset("ACGT"): "N",
}


def _call_for_subset(subset: frozenset) -> str:
    """Output character for a called set of symbols (subset of ALPHABET)."""
    nucs = subset & frozenset("ACGT")
    if nucs == frozenset("ACGT"):
        return "N"
    if nucs:
        code = _IUPAC_CORE[nucs]
        if subset & frozenset("-N"):
            return code.lower()
        return code
    if subset == frozenset("-"):
        return "-"
    if subset == frozenset("N"):
        return "N"
    if subset == frozenset("-N"):
        return "n"
    # Empty set: unreachable from the callers; gap keeps the LUT total.
    return "-"


def build_amb_table() -> dict:
    """Ambiguity dict keyed like the reference: sorted-concatenated subset."""
    table = {}
    for mask in range(1, 1 << NUM_SYMBOLS):
        subset = frozenset(ALPHABET[i] for i in range(NUM_SYMBOLS) if mask & (1 << i))
        key = "".join(sorted(subset))
        table[key] = _call_for_subset(subset)
    return table


#: ``AMB["".join(sorted(called_symbols))] -> output char``.
AMB = build_amb_table()

#: 64-entry uint8 LUT: 6-bit called-set mask (bit i == ALPHABET[i]) -> ASCII.
IUPAC_MASK_LUT = np.zeros(1 << NUM_SYMBOLS, dtype=np.uint8)
for _mask in range(1 << NUM_SYMBOLS):
    _subset = frozenset(ALPHABET[i] for i in range(NUM_SYMBOLS) if _mask & (1 << i))
    IUPAC_MASK_LUT[_mask] = ord(_call_for_subset(_subset))

#: 256-entry uint8 LUT: ASCII base -> symbol index; 255 marks invalid input.
INVALID_SYMBOL = 255
BASE_TO_CODE = np.full(256, INVALID_SYMBOL, dtype=np.uint8)
for _i, _ch in enumerate(ALPHABET):
    BASE_TO_CODE[ord(_ch)] = _i

#: Symbol index -> ASCII, for rendering.
CODE_TO_BASE = np.frombuffer(ALPHABET.encode("ascii"), dtype=np.uint8).copy()

#: Padding code in segment rows: a row position that adds no pileup event.
PAD_CODE = 255

#: copy: the largest position window the sp window strategy materialises
#: a shard (``parallel.sp``), shared with the cost model (``parallel.auto``)
SP_WINDOW_CAP = 1 << 21

#: The 32 distinct bytes the vote can emit (FILL sentinel 0 first).
SYM32_ASCII = np.frombuffer(
    b"\x00-ACGTNMRWSYKVHD" + b"Bacgtnmrwsykvhdb", dtype=np.uint8).copy()
assert len(SYM32_ASCII) == 32 and len(set(SYM32_ASCII)) == 32
