"""Kernel-build cache instrumentation: a reused build is counted, not assumed.

The port's counterpart of ``sam2consensus_tpu/observability/jitcache.py``.
The reference counts JAX's persistent compilation cache
(``compile/persist_hit`` / ``compile/persist_miss``, one per XLA compile
that consulted it).  The port compiles its kernels once per build
directory (``kernels/build.extension``: one
``torch.utils.cpp_extension.load`` into ``build/torch_kernels/``), so the
same two counters count that load: ``compile/persist_hit`` when an
up-to-date extension was loaded without invoking ``nvcc``,
``compile/persist_miss`` when the load compiled.  They land in the
registry of the run that first launched a kernel in the process.

The reference's ``S2C_JIT_CACHE`` has no counterpart (the build
directory is fixed), and its ``note_trace`` / ``counted_call`` count JAX
retraces, which eager PyTorch does not have.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from .metrics import current as _current_registry


def _mtime(path: str) -> Optional[float]:
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return None


def counted_load(load: Callable[[], object], artifact: str):
    """Run ``load()`` (a build-or-load of ``artifact``, the extension's
    shared library) and count it: a hit when the library existed before
    and the load left it untouched, a miss when the load wrote it."""
    before = _mtime(artifact)
    module = load()
    after = _mtime(artifact)
    hit = before is not None and before == after
    _current_registry().add(
        "compile/persist_hit" if hit else "compile/persist_miss", 1)
    return module
