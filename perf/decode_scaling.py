"""How the SAM decode scales with worker threads on this host.

One sample of each benchmark cell (``portbench/traffic`` from the cell's
configuration, seed ``--seed``, sample 0) decoded by the serial native
encoder (``NativeReadEncoder``) and by the byte-shard rung of
``ParallelFusedDecoder`` in slab mode (``counts=None``, the device
pileup's rung) at each worker count of ``--workers``.  Each count runs
alone, and beside a thread that copies 64 MB slabs into pinned
memory as the stager does (on torch's intra-op threads, and once more
on one of them).  Reported per configuration: the median wall
over ``--reps`` decodes, MB/s of SAM body, the summed worker seconds
(``ingest_worker_sec``), the wall a batch, and the copier's GB/s.

    python perf/decode_scaling.py [--cells artic_deep.sam,ecoli_wgs.sam]
        [--seed 2100000021] [--workers 1,2,3,4,6] [--reps 5]
        [--out chiprun_out/decode_scaling.log]

Samples are kept under ``build/decode_scaling/``.  On a machine without
CUDA the copier copies into ordinary memory.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SLAB_BYTES = 64 << 20


def card_stamp(torch) -> str:
    cores = os.cpu_count()
    try:
        usable = len(os.sched_getaffinity(0))
    except AttributeError:
        usable = cores
    host = f"{cores} host cores, {usable} usable"
    if not torch.cuda.is_available():
        return f"no CUDA device | torch {torch.__version__} | {host}"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = torch.cuda.get_device_name(0)
    return (f"{out} | torch {torch.__version__} cuda {torch.version.cuda}"
            f" | {host}")


def make_sample(cell_name: str, seed: int):
    from portbench.harness import manifest
    from portbench.traffic import pool

    cell = manifest.cell(cell_name)
    folder = os.path.join(ROOT, "build", "decode_scaling",
                          f"{cell_name}-{seed}")
    path = os.path.join(folder, "sample.txt")
    if os.path.exists(path):
        with open(path) as fh:
            return fh.read().strip()
    os.makedirs(folder, exist_ok=True)
    s = pool.make_sample(cell.config, cell.traffic, seed, 0, folder)
    with open(path, "w") as fh:
        fh.write(s.path)
    return s.path


class Copier:
    """A thread that copies a 64 MB slab into pinned memory until
    stopped, as the stager's host-to-pinned copy does."""

    def __init__(self, src, dst):
        self.src, self.dst = src, dst
        self.stop = threading.Event()
        self.copied = 0
        self.seconds = 0.0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        t0 = time.perf_counter()
        while not self.stop.is_set():
            self.dst.copy_(self.src)
            self.copied += SLAB_BYTES
        self.seconds = time.perf_counter() - t0

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)


def decode_once(path: str, workers: int):
    """One decode of ``path``: ``workers`` 0 = the serial encoder, else
    the shard rung in slab mode.  Returns (wall, body bytes, batches,
    worker seconds, workers used)."""
    from sam2consensus_torch.encoder.events import GenomeLayout
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder
    from sam2consensus_torch.encoder.parallel_decode import \
        ParallelFusedDecoder
    from sam2consensus_torch.formats import open_alignment_input
    from sam2consensus_torch.ingest import ShardPlan

    ai = open_alignment_input(path, "auto", threads=1)
    try:
        stream = ai.stream
        layout = GenomeLayout(ai.contigs)
        body = stream.body_bytes_total()
        t0 = time.perf_counter()
        if workers == 0:
            enc = NativeReadEncoder(layout, on_lines=stream.add_lines,
                                    on_bytes=stream.add_bytes)
            batches = enc.encode_blocks_from(stream)
        else:
            enc = ParallelFusedDecoder(layout, None, workers,
                                       on_lines=stream.add_lines,
                                       on_bytes=stream.add_bytes)
            if workers == 1:
                # one shard over the whole body: the rung's own cost
                p = stream.shard_plan(2)
                batches = enc.encode_shards(ShardPlan(
                    data=p.data, ranges=[(p.start, p.end)], start=p.start,
                    end=p.end))
            else:
                batches = enc.encode_input(stream)
        n = 0
        for _ in batches:
            n += 1
        wall = time.perf_counter() - t0
        wsec = enc.counters["ingest_worker_sec"] if workers else wall
        used = enc.counters["ingest_mode"].get("threads", workers) \
            if workers else 1
        return wall, body, n, wsec, used
    finally:
        ai.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perf/decode_scaling.py")
    p.add_argument("--cells", default="artic_deep.sam,ecoli_wgs.sam")
    p.add_argument("--seed", type=int, default=2100000021)
    p.add_argument("--workers", default="1,2,3,4,6")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "decode_scaling.log"))
    args = p.parse_args(argv)

    import torch

    from sam2consensus_torch import native

    if native.load() is None:
        print(f"the native decoder did not build: {native.load_error()}",
              file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    say(card_stamp(torch))
    card = lines[0].split(" | ")[0]
    intra = torch.get_num_threads()
    src = torch.randint(0, 255, (SLAB_BYTES,), dtype=torch.uint8)
    dst = torch.empty(SLAB_BYTES, dtype=torch.uint8,
                      pin_memory=torch.cuda.is_available())
    counts = [0] + [int(w) for w in args.workers.split(",")]
    for cell in args.cells.split(","):
        t0 = time.perf_counter()
        path = make_sample(cell, args.seed)
        size = os.path.getsize(path)
        say(f"{cell} seed {args.seed} sample 0: {size} B "
            f"({time.perf_counter() - t0:.1f} s to make or find)")
        decode_once(path, 0)            # page cache and library warm
        # the copier's copy_ runs on torch's intra-op threads, as the
        # stager's does; the last condition holds it to one
        for beside, threads in ((False, intra), (True, intra), (True, 1)):
            torch.set_num_threads(threads)
            res = {w: [] for w in counts}
            copied = []
            for _ in range(args.reps):
                for w in counts:
                    if beside:
                        with Copier(src, dst) as c:
                            res[w].append(decode_once(path, w))
                        copied.append(c.copied / max(c.seconds, 1e-9))
                    else:
                        res[w].append(decode_once(path, w))
            torch.set_num_threads(intra)
            tag = (f"beside a pinned copier on {threads} intra-op "
                   f"thread(s)" if beside else "alone")
            if copied:
                tag += (f" (copier median "
                        f"{statistics.median(copied) / 1e9:.2f} GB/s)")
            say(f"  {tag}:")
            base = statistics.median(r[0] for r in res[0])
            for w in counts:
                walls = [r[0] for r in res[w]]
                wall = statistics.median(walls)
                body, nb = res[w][0][1], res[w][0][2]
                wsec = statistics.median(r[3] for r in res[w])
                name = "serial" if w == 0 else f"shards x{w}"
                say(f"    {name:<10} [{card}] wall "
                    f"{wall:.4f} s (runs "
                    + ", ".join(f"{x:.4f}" for x in walls)
                    + f") {body / wall / 1e6:.1f} MB/s, x{base / wall:.2f} "
                    f"of serial, worker-s {wsec:.4f}, {nb} batches, "
                    f"{wall / max(nb, 1) * 1e3:.2f} ms a batch, "
                    f"{res[w][0][4]} workers used")
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
