"""A cell's pool: its distinct samples, written as SAM files and kept.

Each sample is made and written in a worker process of its own (spawned,
so it imports NumPy and this package and nothing of the program); what
comes back is what the rest of the run needs of it: the file, its size,
the work it holds, and its recipe, from which :func:`reads` draws the
same reads again for the reference after the window.

A pool is kept under ``<cache>/<seed>-<key>``, where ``key`` digests the
configuration and the mix: a later run of the same cell and seed finds
its files and writes nothing.  At most :data:`KEEP` pools are kept a
cell, the least recently used going first."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import re
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional

import numpy as np

from . import generate, sam

_OPS = re.compile(r"(\d+)([MIDNSHPX=])")
#: pools kept a cell (a set of the driver's runs uses six seeds)
KEEP = 8
#: the pool's record, written last: a folder without it is no pool
META = "pool.json"


@dataclasses.dataclass
class PoolSample:
    """One written sample: its file and the work it holds."""

    name: str
    path: str
    file_bytes: int
    n_reads: int
    aligned_bases: int      # read bases on M/=/X operations
    pileup_events: int      # aligned bases and gap bases: count updates
    cigar_ops: int          # CIGAR operations over all reads
    contig: str
    contig_len: int
    index: int
    seconds: dict           # the worker's: drawing the reads, the file
    recipe: Optional[tuple] = None  # (config, mix, seed): see reads()


def work_of(s: generate.Sample):
    """(aligned bases, pileup events, CIGAR operations) of a sample."""
    m = np.zeros(len(s.cigars), dtype=np.int64)
    d = np.zeros(len(s.cigars), dtype=np.int64)
    ops = np.zeros(len(s.cigars), dtype=np.int64)
    for k, c in enumerate(s.cigars):
        for n, op in _OPS.findall(c):
            ops[k] += 1
            if op in "M=X":
                m[k] += int(n)
            elif op in "DNP":
                d[k] += int(n)
    per = np.bincount(s.cigar_id, minlength=len(s.cigars))
    return (int((per * m).sum()), int((per * (m + d)).sum()),
            int((per * ops).sum()))


def make_sample(cfg: dict, traffic: dict, seed: int, index: int,
                folder: str) -> PoolSample:
    t0 = time.perf_counter()
    s = generate.sample(cfg, traffic, seed, index)
    path = os.path.join(folder, f"{s.name}.sam")
    t1 = time.perf_counter()
    size = sam.write(s, path)
    m, ev, ops = work_of(s)
    return PoolSample(name=s.name, path=path, file_bytes=size,
                      n_reads=s.n_reads, aligned_bases=m, pileup_events=ev,
                      cigar_ops=ops, contig=s.contig,
                      contig_len=s.contig_len, index=index,
                      seconds={"reads": t1 - t0,
                               "file": time.perf_counter() - t1},
                      recipe=(cfg, traffic, seed))


def reads(s: PoolSample) -> generate.Sample:
    """The sample's reads, drawn again from its recipe: the records its
    file holds."""
    cfg, traffic, seed = s.recipe
    return generate.sample(cfg, traffic, seed, s.index)


def key(cfg: dict, traffic: dict) -> str:
    return hashlib.sha256(json.dumps([cfg, traffic], sort_keys=True)
                          .encode()).hexdigest()[:12]


def _load(folder: str, recipe: tuple) -> List[PoolSample]:
    with open(os.path.join(folder, META)) as fh:
        rows = json.load(fh)
    out = []
    for r in rows:
        r["path"] = os.path.join(folder, r["path"])
        out.append(PoolSample(**r, recipe=recipe))
    return out


def _evict(cache: str) -> None:
    kept = sorted((e for e in os.scandir(cache) if e.is_dir()
                   and os.path.exists(os.path.join(e.path, META))),
                  key=lambda e: e.stat().st_mtime, reverse=True)
    for e in kept[KEEP:]:
        shutil.rmtree(e.path, ignore_errors=True)


def start(cfg: dict, traffic: dict, seed: int, cache: str,
          workers: Optional[int] = None) -> Callable[[], List[PoolSample]]:
    """Begin making the pool, or find it kept; returns a callable that
    waits for it and gives the samples in order (and has stopped every
    worker).  The callable's ``cached`` says whether the pool was kept."""
    recipe = (cfg, traffic, seed)
    folder = os.path.join(cache, f"{seed}-{key(cfg, traffic)}")
    if os.path.exists(os.path.join(folder, META)):
        os.utime(folder)
        done = _load(folder, recipe)

        def kept() -> List[PoolSample]:
            return done
        kept.cached = True
        return kept
    part = folder + ".part"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    n = int(traffic["pool"])
    workers = min(n, workers or os.cpu_count() or 1)
    ex = ProcessPoolExecutor(workers,
                             mp_context=multiprocessing.get_context("spawn"))
    futs = [ex.submit(make_sample, cfg, traffic, seed, i, part)
            for i in range(n)]

    def wait() -> List[PoolSample]:
        try:
            done = [f.result() for f in futs]
        finally:
            ex.shutdown(wait=True, cancel_futures=True)
        rows = []
        for s in done:
            row = dataclasses.asdict(s)
            del row["recipe"]
            row["path"] = os.path.basename(s.path)
            rows.append(row)
        with open(os.path.join(part, META), "w") as fh:
            json.dump(rows, fh)
            fh.flush()
            os.fsync(fh.fileno())
        try:
            os.rename(part, folder)
        except OSError:         # another run kept the same pool first
            shutil.rmtree(part, ignore_errors=True)
        _evict(cache)
        return _load(folder, recipe)
    wait.cached = False
    return wait
