"""Exact threshold cutoffs: ``ceil(fl64(t) * cov)`` as int32.

Port of ``sam2consensus_tpu/ops/cutoff.py``.  The reference's greedy vote
compares an integer running total against the Python float product
``t * coverage`` (``sam2consensus.py:359-367``), and for integer S
``S < t*cov  <=>  S < ceil(fl64(t*cov))``.  The TPU has no float64, so the
JAX package rebuilds that product with int32 limb arithmetic; Hopper and
the CPU both have IEEE float64, so here the product is one float64 multiply
(round to nearest even, exactly numpy's) followed by ``ceil`` and a clamp to
``[0, 2^31-1]`` — the clamp keeps ``S < cutoff`` for every achievable S.
The insertion kernel (``csrc/insertion.cu``) computes the same expression
with ``__dmul_rn``; ``tests/test_torch_ops.py`` pins this function against
the JAX one and ``threshold_luts``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

LIMB = 14
MASK = (1 << LIMB) - 1
INT32_MAX = (1 << 31) - 1


def encode_thresholds(thresholds: Sequence[float]) -> np.ndarray:
    """Copy of the reference's threshold packing: int32 ``[T, 5]``, four
    14-bit mantissa limbs + e with ``t = M * 2^(e-53)`` exactly.  The port
    keeps it for threshold validation and for the tests that feed the JAX
    functions; its own cutoffs take the float64 thresholds directly."""
    rows = []
    for t in thresholds:
        t = float(t)
        if not (t > 0.0) or not math.isfinite(t):
            raise ValueError(f"threshold must be a positive finite float, "
                             f"got {t!r}")
        frac, e = math.frexp(t)
        m = int(frac * (1 << 53))
        rows.append([m & MASK, (m >> LIMB) & MASK, (m >> (2 * LIMB)) & MASK,
                     (m >> (3 * LIMB)) & MASK, e - 53])
    return np.asarray(rows, dtype=np.int32)


def exact_cutoff(cov: torch.Tensor, t: float) -> torch.Tensor:
    """``ceil(fl64(t * cov))`` clamped to ``[0, 2^31-1]``, int32, same shape
    and device as ``cov`` (any integer dtype, values in ``[0, 2^31)``)."""
    prod = cov.to(torch.float64) * float(t)
    return torch.ceil(prod).clamp_(0, INT32_MAX).to(torch.int32)
