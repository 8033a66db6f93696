"""The port's prefetch stager on the CPU: ``wire.pipeline.StageSlots``
(backpressure, ``close()``, the overlap measurement, pinned against the
JAX package's copy), the device nibble pack against ``pack_nibbles``, and
the prefetch thread's handling of a staging failure (re-raised on the
consumer, no batch delivered unstaged)."""

import threading
import time

import numpy as np
import pytest
import torch

from sam2consensus_torch.backends.base import BackendStats
from sam2consensus_torch.backends.torch_backend import _Prefetcher
from sam2consensus_torch.constants import PAD_CODE
from sam2consensus_torch.encoder.events import SegmentBatch
from sam2consensus_torch.ops.pileup import (PileupAccumulator, pack_codes,
                                            pack_nibbles)
from sam2consensus_torch.wire.pipeline import StageSlots, intersect_sec
from sam2consensus_tpu.wire.pipeline import intersect_sec as r_intersect_sec

JOIN_S = 10.0


def _batch(k: int) -> SegmentBatch:
    codes = np.full((1024, 32), PAD_CODE, np.uint8)
    codes[:3, :5] = k % 5
    starts = np.zeros(1024, np.int32)
    starts[:3] = [k, k + 1, k + 2]
    return SegmentBatch(buckets={32: (starts, codes)}, n_reads=3,
                        n_events=15)


@pytest.mark.parametrize("w", [1, 2, 31, 32, 33, 256, 257])
def test_pack_codes_equals_pack_nibbles(w):
    rng = np.random.default_rng(w)
    codes = rng.integers(0, 6, (40, w)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.2] = PAD_CODE
    codes[3] = PAD_CODE                                # a whole PAD row
    got = pack_codes(torch.from_numpy(codes))
    want = pack_nibbles(codes)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("a,b", [
    ([(0.0, 1.0)], [(0.5, 2.0)]),
    ([(0.0, 1.0), (2.0, 3.0)], [(0.5, 2.5)]),
    ([(0.0, 1.0)], [(1.0, 2.0)]),
    ([], [(0.0, 1.0)]),
    ([(0.0, 10.0)], [(1.0, 2.0), (3.0, 4.0), (9.5, 11.0)]),
])
def test_intersect_sec(a, b):
    assert intersect_sec(a, b) == r_intersect_sec(a, b)


def test_backpressure_blocks_the_third_batch():
    slots = StageSlots(lambda batch: None, slots=2)
    batches = [_batch(k) for k in range(3)]
    staged = []

    def producer():
        for b in batches:
            slots.stage(b)
            staged.append(b)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    deadline = time.perf_counter() + JOIN_S
    while len(staged) < 2 and time.perf_counter() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert len(staged) == 2            # both slots held: the third waits
    slots.consumed(batches[0])
    t.join(JOIN_S)
    assert not t.is_alive() and len(staged) == 3
    assert slots.backpressure_sec >= 0.15


def test_close_unblocks_a_waiting_producer():
    slots = StageSlots(lambda batch: None, slots=1)
    slots.stage(_batch(0))
    got = []
    t = threading.Thread(target=lambda: got.append(slots.acquire(_batch(1))),
                         daemon=True)
    t.start()
    time.sleep(0.1)
    assert t.is_alive()
    slots.close()
    t.join(JOIN_S)
    assert not t.is_alive() and got == [False]


def test_overlap_sec_measures_stage_under_consume():
    slots = StageSlots(lambda batch: time.sleep(0.05))
    t0 = time.perf_counter()
    slots.stage(_batch(0))                     # inside a consume interval
    slots.note_consume(t0, time.perf_counter())
    slots.stage(_batch(1))                     # outside every interval
    assert slots.stage_sec() >= 0.1
    ov = slots.overlap_sec()
    assert 0.045 <= ov <= slots.stage_sec() - 0.045


def test_staging_failure_surfaces_on_the_consumer():
    """The second batch's staging raises: the consumer gets the first
    batch, then the same exception object; the failed batch is never
    delivered, and the producer stops."""
    calls = []

    def stage(batch):
        calls.append(batch.n_reads)
        if len(calls) == 2:
            raise ValueError("staging slot broke at batch 2")

    stats = BackendStats()
    stats.extra["decode_sec"] = 0.0
    slots = StageSlots(stage)
    prefetch = _Prefetcher(iter([_batch(k) for k in range(5)]), stats,
                           stager=slots)
    seen = []
    with pytest.raises(ValueError, match="staging slot broke at batch 2"):
        for batch in prefetch:
            seen.append(batch)
            slots.consumed(batch)
    prefetch.close()
    assert len(seen) == 1 and len(calls) == 2
    assert not prefetch._thread.is_alive()


def test_consumer_failure_unblocks_a_staging_producer():
    slots = StageSlots(lambda batch: None, slots=1)
    stats = BackendStats()
    stats.extra["decode_sec"] = 0.0
    prefetch = _Prefetcher(iter([_batch(k) for k in range(50)]), stats,
                           stager=slots)
    with pytest.raises(RuntimeError):
        for _batch_ in prefetch:
            raise RuntimeError("consumer failed")   # never consumed()
    slots.close()
    t0 = time.perf_counter()
    prefetch.close()
    assert not prefetch._thread.is_alive()
    assert time.perf_counter() - t0 < JOIN_S


def test_cpu_accumulator_stages_nothing():
    acc = PileupAccumulator(64, "cpu")
    batch = _batch(7)
    acc.stage(batch)
    assert batch.staged == {}
    acc.add(batch)
    want = torch.zeros((64, 6), dtype=torch.int32)
    for s in (7, 8, 9):
        want[s:s + 5, 2] += 1
    assert torch.equal(acc.counts, want)
