"""The process-wide inflate pool of the BGZF readers.

Copy of ``shared_pool`` and ``pool_submit`` from
``sam2consensus_tpu/ingest/__init__.py`` (pinned by
``tests/test_torch_copies.py``).  Every ``formats.bgzf.BgzfReader`` with
``threads > 1`` inflates its stripes on this one pool, sized by the run's
``--decode-threads`` (``config.resolve_decode_threads``).  The byte-shard
planner of the reference's sharded decoder is not ported.
"""

from __future__ import annotations

import threading

_pool = None
_pool_workers = 0
_pool_lock = threading.Lock()


def shared_pool(threads: int):
    """The process-wide ingest executor, grown to at least ``threads``
    workers (never shrunk).  Returns None for ``threads <= 1``: serial
    callers stay poolless.  Only short tasks (BGZF stripe inflates)
    belong here."""
    global _pool, _pool_workers
    if threads <= 1:
        return None
    with _pool_lock:
        if _pool is None or _pool_workers < threads:
            from concurrent.futures import ThreadPoolExecutor

            old = _pool
            _pool = ThreadPoolExecutor(max_workers=int(threads),
                                       thread_name_prefix="s2c-ingest")
            _pool_workers = int(threads)
            if old is not None:
                # in-flight stripes finish on the old pool's threads;
                # new submissions land on the grown pool
                old.shutdown(wait=False)
        return _pool


def pool_submit(threads: int, fn, *args):
    """Submit a short task to the shared pool, safe against concurrent
    growth: a submit that lost the race to a pool retired by a larger
    budget retries on the current pool.  Callers must not cache the
    executor across submits."""
    while True:
        pool = shared_pool(threads)
        if pool is None:
            raise ValueError("pool_submit needs threads > 1")
        try:
            return pool.submit(fn, *args)
        except RuntimeError:
            # only a retired executor justifies a retry; if the refusing
            # pool is still the current one the error is real (e.g.
            # interpreter shutdown) and must propagate
            with _pool_lock:
                if _pool is pool:
                    raise
