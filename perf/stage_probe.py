#!/usr/bin/env python3
"""Where the prefetch stager's host time goes, on one CUDA card.

    python3 perf/stage_probe.py

``PileupAccumulator.stage`` (``sam2consensus_torch/ops/pileup.py``) does,
per slab: a wait for the pinned slot's last copy, a copy of the rows into
the slot (growing it on first use), and the enqueue of two
``non_blocking`` host-to-device copies on a side stream.  This script
times each step with the host clock at ``ecoli_scale``'s native slab
shapes (32,768 x 256, then 65,536 x 128, uint8): the pinned allocations
alone, the copy into an already pinned buffer, and the enqueue on a fresh
side stream (new device memory) against the same enqueue once the
caching allocator holds a freed block of that stream.  Then it runs the
staging steps one by one on a producer thread beside a consumer thread,
three rounds on fresh accumulators (see :func:`pipeline`), and stages
three slabs through two ``PileupAccumulator`` objects in turn (no kernel
runs: the staged rows are dropped, not counted), printing each ``stage``
call's seconds.  Every line carries the card's name and power
limit; with no card the script exits 1.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SLABS = [(32768, 256), (65536, 128), (65536, 128)]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def clock(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def pipeline(name, dev, host, rng) -> None:
    """The staging steps of ``PileupAccumulator.stage`` one by one, on a
    producer thread, with a consumer thread doing the consumer's part
    (event wait, ``record_stream``, device pack) as the backend does;
    three rounds, each with a fresh accumulator (a fresh copy stream), as
    three runs of one process would.  Prints per slab the slot wait, the
    slot copy, each host-to-device enqueue and the device segments the
    caching allocator had to add (``cudaMalloc`` calls) during it."""
    import queue
    import threading

    from sam2consensus_torch.ops.pileup import (PileupAccumulator,
                                                pack_codes, real_rows)

    def segments():
        return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)

    for rnd in range(3):
        acc = PileupAccumulator(4_601_856, dev)
        q = queue.Queue(maxsize=2)
        lines = []

        def producer():
            for k, (n, w) in enumerate(SLABS):
                starts = np.sort(rng.integers(0, 4_600_000, n)).astype(
                    np.int32)
                codes = host[k]
                t0 = time.perf_counter()
                n = real_rows(codes)
                slot = acc._slots[k % len(acc._slots)]
                t1 = time.perf_counter()
                slot.wait()
                t2 = time.perf_counter()
                st, cd = slot.fill(starts[:n], codes[:n])
                seg0 = segments()
                t3 = time.perf_counter()
                with torch.cuda.stream(acc._copy_stream):
                    d_st = st.to(dev, non_blocking=True)
                    t4 = time.perf_counter()
                    d_cd = cd.to(dev, non_blocking=True)
                    t5 = time.perf_counter()
                    ready = torch.cuda.Event()
                    ready.record(acc._copy_stream)
                slot.copied = ready
                t6 = time.perf_counter()
                lines.append(
                    f"[{name}] round {rnd} slab {k} ({n} x {w}): real_rows "
                    f"{(t1 - t0) * 1e3:.3f} ms, slot wait "
                    f"{(t2 - t1) * 1e3:.3f}, slot copy {(t3 - t2) * 1e3:.3f}"
                    f", H2D enqueue starts {(t4 - t3) * 1e3:.3f} codes "
                    f"{(t5 - t4) * 1e3:.3f}, event {(t6 - t5) * 1e3:.3f}; "
                    f"new device segments {segments() - seg0}")
                q.put((d_st, d_cd, ready))
            q.put(None)

        t = threading.Thread(target=producer, name="decode-prefetch")
        t.start()
        stream = torch.cuda.current_stream(dev)
        while (item := q.get()) is not None:
            d_st, d_cd, ready = item
            stream.wait_event(ready)
            d_st.record_stream(stream)
            d_cd.record_stream(stream)
            pack_codes(d_cd)
            del d_st, d_cd, item
        t.join()
        torch.cuda.synchronize()
        print("\n".join(lines))


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_probe: no CUDA card", file=sys.stderr)
        return 1
    from sam2consensus_torch.encoder.events import SegmentBatch
    from sam2consensus_torch.ops.pileup import PileupAccumulator

    name = card() + (f" CUDA_MODULE_LOADING="
                     f"{os.environ['CUDA_MODULE_LOADING']}"
                     if "CUDA_MODULE_LOADING" in os.environ else "")
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)                 # context up front
    print(name)
    rng = np.random.default_rng(0)
    host = [rng.integers(0, 6, (n, w)).astype(np.uint8) for n, w in SLABS]

    for k, (n, w) in enumerate(SLABS[:2]):
        sec, pinned = clock(lambda: torch.empty(n * w, dtype=torch.uint8,
                                                pin_memory=True))
        print(f"[{name}] pinned alloc {n * w} B: {sec * 1e3:.3f} ms")
        for rep in range(2):
            sec, _ = clock(lambda: pinned[:n * w].view(n, w).copy_(
                torch.from_numpy(host[k])))
            print(f"[{name}] copy {n * w} B into pinned (rep {rep}): "
                  f"{sec * 1e3:.3f} ms")

    pinned = torch.empty(SLABS[0][0] * SLABS[0][1], dtype=torch.uint8,
                         pin_memory=True)
    stream = torch.cuda.Stream(dev)
    for what in ("fresh stream, new device block", "same stream, block "
                 "freed and cached", "same stream, block freed and cached"):
        with torch.cuda.stream(stream):
            sec, d = clock(lambda: pinned.to(dev, non_blocking=True))
        torch.cuda.synchronize()
        print(f"[{name}] H2D enqueue {pinned.numel()} B ({what}): "
              f"{sec * 1e3:.3f} ms")
        del d

    pipeline(name, dev, host, rng)
    for rep in range(2):
        acc = PileupAccumulator(4_601_856, dev)
        for k, (n, w) in enumerate(SLABS):
            starts = np.sort(rng.integers(0, 4_600_000, n)).astype(np.int32)
            batch = SegmentBatch(buckets={w: (starts, host[k])}, n_reads=n)
            sec, _ = clock(lambda: acc.stage(batch))
            print(f"[{name}] accumulator {rep} stage slab {k} ({n} x {w}): "
                  f"{sec * 1e3:.3f} ms")
        torch.cuda.synchronize()
        del batch
    return 0


if __name__ == "__main__":
    sys.exit(main())
