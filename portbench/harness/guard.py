"""The port's runs load neither JAX nor the JAX package: the modules a
run holds, compared by whole top-level name."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sam2consensus_tpu"})


def forbidden(modules=None) -> List[str]:
    names = {m.split(".", 1)[0] for m in list(modules if modules is not None
                                             else sys.modules)}
    return sorted(names & FORBIDDEN)
