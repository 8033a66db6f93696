#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``sam2consensus_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1;
2. build the CUDA kernels (``csrc/``, one ``torch.utils.cpp_extension.load``)
   and, started beside it, one ``nvcc -Xptxas=-v`` per kernel source, whose
   report of each kernel's registers, shared memory and spills is printed,
   and the native SAM decoder (``native/decoder.cpp``, g++ on a thread);
3-5. every kernel against its plain PyTorch version on the card, exact
   equality (integer data, tolerance 0): K1 pileup histogram, K2 fused
   insertion table + vote (and its time on one hot key), K3 insertion
   table (dropped out-of-range events, a hot key, a ragged tail; and its
   time at 50 keys x 1300 columns);
6-7. the main path through ``cli.main`` on CUDA with ``--decoder native``
   (every run must report ``decoder=native``: no fallback may hide the
   decoder) and ``--pileup pallas`` unless said otherwise, with the
   launch counts set to 0 just before and read just after: the
   ``formats_*`` fixtures (``.sam``, BGZF ``.sam.gz`` and
   ``.bam`` under ``--format auto``, byte-identical to
   ``*.expected.fasta``; each BAM run must launch K1), a small
   wide-insertion input (1024 padded columns), ``longread_sv`` (10 kb
   reads over a 120 kb contig that carries a shared 6,000-base insertion:
   512 sites x 8192 padded columns, ~1.2 M insertion events, the K3 route)
   and two of ``bench.py``'s configurations at full size — ``ecoli_scale``
   (4.6 Mbp, 150,000 x 100 bp reads) and ``amplicon_deep`` (400 bp,
   100,000 x 80 bp reads, deep insertions) — each byte-identical to the
   port's CPU run under ``--decoder py`` (so across decoder and device at
   once), with both runs' decode seconds side by side and the pileup
   split by the thread that runs each step: the producer's trim, pinned
   slot wait and copy and host-to-device enqueue, the consumer's event
   wait, device pack and K1 route, and the stager's ``stage_sec``,
   ``overlap_sec`` and ``backpressure_sec`` (fatal if the trim or a copy
   ran on the consumer, or numpy packed anything).  ``ecoli_scale`` is
   also written as BAM by the port's writer and run on CUDA at
   ``--decode-threads`` 1 and 0 and on the CPU under ``--decoder py``:
   all byte-identical to the SAM run, decode seconds and MB/s printed.
   Each full-size input (and the BAM) also runs under ``--pileup host``
   (no K1, the fused C++ count; when the tail goes to the card one counts
   upload and the insertion kernels the ``pallas`` run's tail launched,
   when it stays on the host no upload and no K2 or K3) and ``--pileup
   auto`` (the gate's bounds, the input's bytes and the reason, and the
   tail placement with its inputs printed), byte-identical to the CPU
   run; ``ecoli_scale`` at ``--decode-threads`` 1, 4 and 0 under
   ``pallas`` and ``host`` (the sharded rung with more than one shard
   when threads > 1; decode, worker seconds and shards printed);
   ``longread_sv`` at ``--segment-width -1`` beside the default (no line
   may replay in Python at -1).  Each default run prints its device-side
   decisions (row wire, tail encoding, insertion route, bytes shipped and
   fetched) and must take wire packed5 without probing the link.  The
   device-side choices run on CUDA beside it, each byte-identical to that
   input's default run: ``ecoli_scale`` at ``--wire delta8`` (delta8 slabs
   counted, fewer bytes shipped than their packed5-equivalent, K1
   launched) and ``--pileup scatter`` (no K1); ``amplicon_deep`` and
   ``longread_sv`` at ``--insertion-kernel scatter`` (no K2 or K3) and
   ``pallas`` (the kernel of the table's width); ``S2C_TAIL_ENCODING``
   ``sparse`` and ``packed5`` on all three.  Every kernel must have
   launched in that window.  Then the link probe's round trip and H2D /
   D2H rates, and the native vote's ns a position at ``ecoli_scale``'s L
   for T = 1 and 2;
8. under ``torch.cuda.set_sync_debug_mode("error")``, once each: the K1,
   K2 and K3 routes at the largest main-path shapes, the staged K1 route
   (``PileupAccumulator.add`` of a batch staged as the prefetch thread
   stages it: event wait, device pack, K1), the same rows staged under
   ``delta8`` (event wait, device unpack, pack, K1) and for the scatter
   strategy, each counting what the K1 route counts, the whole tail
   (``fused.vote_packed``) on the arguments ``longread_sv`` (K3 and the
   torch vote) and ``amplicon_deep`` (K2) gave it, its sparse and packed5
   heads there and on ``ecoli_scale``'s tail, and the host-count route on
   both (the narrowed counts' pinned upload and the tail; its output must
   equal the int32 tail's).  A host synchronisation in any of them is
   fatal; the ``--insertion-kernel scatter`` tail (``index_put_``) is
   reported, not required;
   then the device-side choices at the main path's shapes, CUDA events:
   the delta8 unpack of the K1 slab (host encode beside it; lanes against
   packed5 and raw bytes), the scatter strategy against K1's route on it,
   the three position heads alone at ``ecoli_scale`` and in the whole
   tails of ``amplicon_deep`` and ``longread_sv`` (bytes beside), the
   insertion routes, and the gates' constants;
9. the C++ decoder (``NativeReadEncoder``) against the Python
   ``ReadEncoder`` on ``ecoli_scale`` and ``longread_sv`` at full size:
   pileup counts of the batches, reads, skipped, events, lines and every
   array of ``group_insertions`` equal; a difference is fatal.

Then each kernel is held against its plain version once more at the
largest shapes the main path gave it (fresh outputs, exact; a difference
is fatal) and timed there with CUDA events: the kernel alone (and its
device time from ``torch.profiler``, which holds no host time, divided by
the launches the profiler recorded), its route (what the main path pays:
plan, if any, and wrapper), its plain version,
one PyTorch library call where one computes the same function (K1: one
``torch.bincount`` of the flat cell index, also timed with the
expansion; K3: ``index_put_``), and its
bound (bytes over the HBM rate or operations over the CUDA-core rate, the
larger).  The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": ...}``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
#: H100 SXM data-sheet peaks: HBM3 bytes/s, and the non-tensor-core
#: 32-bit rate (67 TFLOP/s float32) taken for the kernels' integer work
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
#: ``ecoli_scale``'s genome length (``bench.py:178-181``)
ECOLI_LEN = 4_600_000


def fail(msg: str) -> None:
    print("chip_smoke FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def ptxas_reports(tmp: str) -> list:
    """Starts one ``nvcc -Xptxas=-v -c`` per kernel source, with the
    extension's target and flags, into ``tmp``; returns ``[(source,
    process)]`` (their reports give registers, shared memory and spills)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from sam2consensus_torch.kernels import build

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    return [(src, subprocess.Popen(
        [nvcc, *build.CUDA_FLAGS, "-Xptxas=-v", "-c", str(build.CSRC / src),
         "-o", os.path.join(tmp, src + ".o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for src in build.SOURCES if src.endswith(".cu")]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        fail(f"nvidia-smi: {exc}")
    return out[0].strip() if out else "unknown"


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def last_launch(kernel):
    """Yields a list that holds the arguments of ``kernel``'s latest launch
    (an instance attribute shadows ``Kernel.launch`` for the duration)."""
    seen = []

    def launch(*args):
        seen[:] = [args]
        type(kernel).launch(kernel, *args)

    kernel.launch = launch
    try:
        yield seen
    finally:
        del kernel.launch


def kernel_ms(kernel, call, reps: int) -> float:
    """Mean time of the kernel alone: ``call()`` (a wrapper call) gives one
    launch's arguments, then ``reps`` back-to-back calls of the entry point
    on them are timed with CUDA events.  No wrapper work is included, and
    these calls are not counted as launches."""
    with last_launch(kernel) as seen:
        call()
    if not seen:
        fail(f"{kernel.name}: the wrapper call launched nothing")
    fn, args = kernel.function(), seen[0]
    return time_ms(lambda: fn(*args), reps)


def device_ms(kernel, call, reps: int) -> float:
    """Device time of one entry-point call on one launch's arguments, from
    ``torch.profiler`` over ``reps`` calls: the mean CUDA time of the
    kernel function's launches the profiler recorded (a profile may miss
    some; the count is printed, and none recorded is fatal), plus the mean
    time of the memsets, where the entry point makes one a call (K3).
    Unlike :func:`kernel_ms` it holds no host time."""
    from torch.profiler import ProfilerActivity, profile

    with last_launch(kernel) as seen:
        call()
    fn, args = kernel.function(), seen[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def mean_ms(match):
        hits = [e for e in events if match(e.key)]
        n = sum(e.count for e in hits)
        return (sum(e.device_time_total for e in hits) / n / 1e3 if n
                else 0.0), n

    ms, n = mean_ms(lambda key: kernel.name + "_kernel" in key)
    set_ms, n_set = mean_ms(lambda key: key.startswith("Memset"))
    print(f"    {kernel.name}: profiler recorded {n} launches and {n_set} "
          f"memsets ({set_ms:.4f} ms each) of {reps} calls")
    if not n:
        fail(f"{kernel.name}: the profiler recorded no launch")
    return ms + set_ms


@contextlib.contextmanager
def launch_events(kernels):
    """Records a CUDA event pair around every entry-point call the launches
    of ``kernels`` make (each instance's ``function`` is shadowed for the
    duration); yields ``{name: [(start, end), ...]}``."""
    events = {k.name: [] for k in kernels}
    for k in kernels:
        def timed(*args, _raw=k.function(), _ev=events[k.name]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            made = _raw(*args)
            end.record()
            _ev.append((start, end))
            return made

        k.function = lambda _timed=timed: _timed
    try:
        yield events
    finally:
        for k in kernels:
            del k.function


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def kernel_define(source: str, name: str) -> int:
    """An integer ``#define`` of one of the kernels' sources."""
    import re

    from sam2consensus_torch.kernels import build

    text = (build.CSRC / source).read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


# -- phase 3: K1 ------------------------------------------------------------
def check_k1(rng, dev) -> int:
    from sam2consensus_torch.ops.pileup import (pack_nibbles,
                                                scatter_segments_packed)
    from sam2consensus_torch.ops.pileup_kernel import accumulate_rows

    tp = kernel_define("pileup.cu", "K1_WINDOW")     # the shared window
    worst = 0
    # widths below, at and above the window (rows wider than it), widths
    # whose rows take byte loads (33 and 40 columns: not a multiple of 16
    # bytes), rows that straddle window-sized steps, one deep pile, PAD
    # cells and PAD rows
    for w in (32, 33, 40, 128, tp, 2 * tp, 16384):
        n_pos = 24 * tp + w + 77
        starts = list(rng.integers(0, n_pos - w, 3000))
        for t in range(1, 20):
            starts += [t * tp - 1, t * tp - w // 2, t * tp - w, t * tp]
        starts += [16 * tp + 100] * 2500           # duplicates: a deep pile
        starts = np.asarray([s for s in starts if s >= 0], dtype=np.int32)
        codes = rng.integers(0, 6, (len(starts), w)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.15] = 255   # PAD cells
        codes[:7] = 255                               # whole PAD rows
        st = torch.from_numpy(starts).to(dev)
        pk = torch.from_numpy(pack_nibbles(codes)).to(dev)
        got = accumulate_rows(torch.zeros((n_pos, 6), dtype=torch.int32,
                                          device=dev), st, pk)
        want = scatter_segments_packed(
            torch.zeros((n_pos, 6), dtype=torch.int32, device=dev), st, pk)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"  K1 w={w}: rows={len(starts)} n_pos={n_pos} "
              f"cells={int((codes < 6).sum())} max_abs_err={err}")
        if err:
            fail(f"K1 differs from its plain version at width {w}")
        worst = max(worst, err)
    return worst


# -- phases 4-5: K2, K3 -----------------------------------------------------
def _events(rng, k, c, e, hot=None):
    key = rng.integers(0, k, e)
    if hot is not None:
        key[: e // 2] = hot
    col = rng.integers(0, c, e)
    code = rng.integers(0, 6, e)
    return key, col, code


def check_k2(rng, dev, card: str) -> int:
    from sam2consensus_torch.ops.insertion_kernel import (
        K2, vote_insertions_fused)
    from sam2consensus_torch.ops.insertions import (build_insertion_table,
                                                    vote_insertions)

    cases = [  # (name, k, cp, e, thresholds, hot key, cov scale)
        ("random", 300, 8, 5000, [0.25], None, 3),
        ("hot_key", 64, 16, 40000, [0.25, 0.5, 0.75], 17, 3),
        ("chunk_edge", 257, 512, 20000, [0.25, 0.75, 1.0], None, 3),
        ("negative_gap", 128, 4, 8000, [0.1, 0.5, 0.9], None, 0),
        ("two_launches", 64, 8, 6000, [i / 20 for i in range(1, 20)], None,
         3),
    ]
    worst = 0
    for name, k, cp, e, thr, hot, scale in cases:
        key, col, code = _events(rng, k, cp, e, hot)
        if name == "chunk_edge":
            col[:200] = cp - 1
        tk = [torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (key, col, code)]
        table = build_insertion_table(k, cp, *tk)
        total = table.sum(dim=(1, 2))
        # scale 0: site coverage below the column sums -> negative gap lanes
        site_cov = (total * scale // 2 if scale
                    else total // (3 * cp)).int()
        n_cols = torch.from_numpy(rng.integers(0, cp + 1, k).astype(
            np.int32)).to(dev)
        got = vote_insertions_fused(*tk, site_cov, n_cols, cp, thr)
        want = vote_insertions(table, site_cov, n_cols, thr)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"  K2 {name}: k={k} cp={cp} events={e} T={len(thr)} "
              f"max_abs_err={err}")
        if err:
            fail(f"K2 differs from its plain version ({name})")
        worst = max(worst, err)
        if hot is not None:
            args = (*tk, site_cov, n_cols, cp, thr)
            ms = kernel_ms(K2, lambda: vote_insertions_fused(*args), 20)
            route = time_ms(lambda: vote_insertions_fused(*args), 20)
            plain = time_ms(lambda: vote_insertions(
                build_insertion_table(k, cp, *tk), site_cov, n_cols, thr), 5)
            print(f"  K2 {name} [{card}]: {e // 2} events on key {hot}: "
                  f"kernel={ms:.4f} ms route={route:.4f} ms "
                  f"plain={plain:.4f} ms")
    return worst


def check_k3(rng, dev, card: str) -> int:
    from sam2consensus_torch.ops.insertion_kernel import (
        K3, build_insertion_table_kernel)
    from sam2consensus_torch.ops.insertions import build_insertion_table

    worst = 0
    cases = [  # (name, k, cp, events, hot key)
        ("random", 50, 1300, 60000, 1), ("few_keys", 3, 2048, 20000, 1),
        ("ragged_tail", 7, 600, 256 * 9 + 77, None),
        ("out_of_range", 40, 1024, 30000, None)]
    for name, k, cp, e, hot in cases:
        key, col, code = _events(rng, k, cp, e, hot)
        col[:100] = 511
        col[100:200] = 512
        keep = np.ones(e, bool)
        if name == "out_of_range":     # the kernel drops these events
            key[:50], col[50:100], code[100:150] = k, -1, 6
            keep[:150] = False
        tk = [torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (key, col, code)]
        got = build_insertion_table_kernel(*tk, k, cp)
        want = build_insertion_table(k, cp, *(t[torch.from_numpy(keep).to(
            dev)] for t in tk))
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"  K3 {name}: k={k} cp={cp} events={e} max_abs_err={err}")
        if err:
            fail(f"K3 differs from its plain version ({name})")
        worst = max(worst, err)
        if name == "random":
            ms = kernel_ms(K3, lambda: build_insertion_table_kernel(
                *tk, k, cp), 20)
            route = time_ms(lambda: build_insertion_table_kernel(*tk, k, cp),
                            20)
            plain = time_ms(lambda: build_insertion_table(k, cp, *tk), 5)
            lib = time_ms(lambda: index_put_table(k, cp, *tk), 5)
            print(f"  K3 [{card}]: k={k} cp={cp} events={e}: kernel="
                  f"{ms:.4f} ms route={route:.4f} ms plain="
                  f"{plain:.4f} ms index_put_={lib:.4f} ms")
    return worst


def index_put_table(k, cp, key, col, code) -> torch.Tensor:
    """The insertion table as one PyTorch library call (K3's library_ms)."""
    ones = torch.ones(key.shape, dtype=torch.int32, device=key.device)
    return torch.zeros((k, cp, 6), dtype=torch.int32,
                       device=key.device).index_put_(
        (key.long(), col.long(), code.long()), ones, accumulate=True)


# -- phases 6-7: the main path ----------------------------------------------
class Capture:
    """Records, per kernel wrapper, the call with the largest input that
    phase 7's runs of its inputs at their defaults made (and the input it
    came from), so the kernel can be timed afterwards at those shapes; the
    variant runs (``--pileup``, ``--decode-threads``, ``--segment-width``)
    record nothing.  ``key`` may name ``{input}``: one record per
    input."""

    def __init__(self):
        self.calls = {}
        self.stats = []
        self.input = None

    def wrap(self, module, attr, key, size_of):
        orig = getattr(module, attr)

        def wrapper(*args):
            if self.input is not None:
                size = size_of(*args)
                at = key.format(input=self.input)
                if size > self.calls.get(at, (-1, None, None))[0]:
                    self.calls[at] = (size, args, self.input)
            return orig(*args)

        setattr(module, attr, wrapper)


def run_cli(argv, device) -> float:
    t0 = time.perf_counter()
    from sam2consensus_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, device=device)
    if rc != 0:
        fail(f"cli.main {argv} returned {rc}")
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def read_dir(path: str) -> str:
    return "".join(open(os.path.join(path, f)).read()
                   for f in sorted(os.listdir(path)))


@contextlib.contextmanager
def pileup_split():
    """Host-clock seconds of the pileup's steps while the block runs, on
    the thread that runs each.  The producer (the decode prefetch
    thread): ``real_rows``, the delta8 canonicalise and encode
    (``encode``), the wait for a pinned slot's last copy (``slot_wait``),
    the copy into the slot (``slot_copy``), and the enqueue of the
    host-to-device copies and their event on the copy stream
    (``h2d_enqueue``).  The consumer: ``PileupAccumulator.add``
    (``add``), of which the delta8 unpack (``unpack``), the device pack
    (``pack``) and the count (``route``: K1's ``accumulate_rows``, the
    device sort and the launch, or ``scatter_segments``, enqueued); the
    rest of ``add`` is the device-side event wait and ``record_stream``.
    ``sync`` is the wait for the last kernel.  Also counts the calls of
    ``real_rows`` and ``pack_nibbles`` per thread, and the bytes the
    staged copies moved.  Yields the sums."""
    import threading

    from sam2consensus_torch.ops import pileup, pileup_kernel

    from sam2consensus_torch import wire
    from sam2consensus_torch.wire import device as wire_device

    sec = dict.fromkeys(("real_rows", "encode", "slot_wait", "slot_copy",
                         "h2d_enqueue", "add", "unpack", "pack", "route",
                         "sync", "h2d_bytes"), 0)
    calls = {}
    saved = []
    for obj, attr, key in ((pileup, "real_rows", "real_rows"),
                           (wire, "encode_wire_slab", "encode"),
                           (wire_device, "decode_slab", "unpack"),
                           (pileup, "scatter_segments", "route"),
                           (pileup, "pack_nibbles", "pack_nibbles"),
                           (pileup._PinnedSlot, "wait", "slot_wait"),
                           (pileup._PinnedSlot, "fill", "slot_copy"),
                           (pileup.PileupAccumulator, "_ship",
                            "h2d_enqueue"),
                           (pileup, "pack_codes", "pack"),
                           (pileup_kernel, "accumulate_rows", "route"),
                           (pileup.PileupAccumulator, "add", "add"),
                           (pileup.PileupAccumulator, "sync", "sync")):
        orig = getattr(obj, attr)

        def timed(*args, _orig=orig, _key=key):
            thread = threading.current_thread().name
            calls[(_key, thread)] = calls.get((_key, thread), 0) + 1
            if _key == "h2d_enqueue":
                sec["h2d_bytes"] += sum(t.nbytes for t in args[2])
            t0 = time.perf_counter()
            try:
                return _orig(*args)
            finally:
                sec[_key] = sec.get(_key, 0) + time.perf_counter() - t0

        saved.append((obj, attr, orig))
        setattr(obj, attr, timed)
    try:
        yield sec, calls
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)


def print_split(sec: dict, calls: dict, st) -> None:
    """Prints the pileup split of one CUDA run; fails unless the trim,
    the slot copy and the host-to-device copies ran on the producer and
    no numpy packing ran at all."""
    on = {}
    for (key, thread), n in calls.items():
        on.setdefault(key, {})[thread] = n
    print(f"    pileup split, producer: real_rows={sec['real_rows']:.4f}s "
          f"encode={sec['encode']:.4f}s slot_wait={sec['slot_wait']:.4f}s "
          f"slot_copy={sec['slot_copy']:.4f}s "
          f"h2d_enqueue={sec['h2d_enqueue']:.4f}s ({sec['h2d_bytes']} B); "
          f"stage_sec={st.extra['stage_sec']:.4f}s "
          f"overlap_sec={st.extra['overlap_sec']:.4f}s "
          f"backpressure_sec={st.extra['backpressure_sec']:.4f}s")
    wait = sec["add"] - sec["unpack"] - sec["pack"] - sec["route"]
    print(f"    pileup split, consumer: add={sec['add']:.4f}s = "
          f"event_wait+record_stream={wait:.4f}s "
          f"device_unpack={sec['unpack']:.4f}s "
          f"device_pack={sec['pack']:.4f}s "
          f"count_route_enqueue={sec['route']:.4f}s; "
          f"sync_wait={sec['sync']:.4f}s; calls by thread: {on}")
    for key in ("real_rows", "encode", "slot_copy", "h2d_enqueue"):
        if set(on.get(key, {})) - {"decode-prefetch"}:
            fail(f"{key} ran off the producer thread: {on[key]}")
    if "pack_nibbles" in on:
        fail(f"numpy pack_nibbles ran in a CUDA run: {on['pack_nibbles']}")


def longread_sv(seed: int = 11, glen: int = 120_000, rlen: int = 10_000,
                sv_len: int = 6_000, carriers: int = 190, cut: int = 20,
                sites: int = 510, background: int = 400) -> str:
    """SAM text of long reads (ONT/PacBio-like, ``rlen`` bases) over one
    ``glen``-base contig whose sample carries an ``sv_len``-base insertion
    (a transposon or another SV) in the middle: ``carriers`` reads hold it
    whole (every 40th with one substituted base), ``cut`` more hold a
    prefix of it, and ``background`` reads spread over the contig carry
    1-4-base insertions at up to ``sites`` other positions (at most two
    reads a site).  With the defaults: 512 padded sites x 8192 padded
    columns, ~1.2 M insertion events."""
    from sam2consensus_torch.utils.simulate import sam_text

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def bases(n):
        return acgt[rng.integers(0, 4, n)].tobytes().decode()

    genome, motif, sv_at = bases(glen), bases(sv_len), glen // 2
    reads = []
    for i in range(carriers + cut):
        ins = motif if i < carriers else motif[:rng.integers(sv_len // 10,
                                                             sv_len)]
        if i % 40 == 7:
            j = int(rng.integers(len(ins)))
            ins = ins[:j] + "ACGT"[("ACGT".index(ins[j]) + 1) % 4] \
                + ins[j + 1:]
        left = int(rng.integers(rlen // 10, rlen - rlen // 10))
        start, right = sv_at - left, rlen - left
        reads.append(("sv", start + 1, f"{left}M{len(ins)}I{right}M",
                      genome[start:sv_at] + ins + genome[sv_at:sv_at + right]))
    starts = rng.integers(0, glen - rlen, background)
    away = np.abs(np.arange(glen) - sv_at) > 100
    away[:100] = away[-100:] = False
    carried = [[] for _ in starts]
    for p in rng.choice(np.nonzero(away)[0], sites, replace=False):
        cover = np.nonzero((starts < p) & (starts + rlen > p))[0]
        for r in rng.choice(cover, min(2, len(cover)), replace=False):
            carried[r].append(int(p))
    for s, at_sites in zip(starts.tolist(), carried):
        cigar, seq, at = [], [], s
        for p in sorted(at_sites):
            ins = bases(int(rng.integers(1, 5)))
            cigar += [f"{p - at}M", f"{len(ins)}I"]
            seq += [genome[at:p], ins]
            at = p
        cigar.append(f"{s + rlen - at}M")
        seq.append(genome[at:s + rlen])
        reads.append(("sv", s + 1, "".join(cigar), "".join(seq)))
    reads.sort(key=lambda r: r[1])
    return sam_text([("sv", glen)], reads)


def decoder_of(cap: Capture, want: str) -> str:
    """The decoder the latest run reported; anything but ``want`` is fatal."""
    got = cap.stats[-1].extra.get("decoder")
    if got != want:
        fail(f"the run took decoder={got}, not {want}")
    return got


def main_path(tmp: str, card: str, cap: Capture) -> dict:
    """Phases 6-7; returns the paths of phase 7's inputs by name."""
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.utils.simulate import (SimSpec, sam_text,
                                                    simulate, write_sam)

    from sam2consensus_torch.ops.pileup_kernel import K1

    kernels = all_kernels()
    print("phase 6: formats fixtures (SAM, BGZF SAM, BAM) through cli.main "
          "on CUDA, --format auto")
    for fam in ("short", "longread", "adversarial"):
        with open(os.path.join(DATA, f"formats_{fam}.expected.fasta")) as fh:
            expected = fh.read()
        for ext in (".sam", ".sam.gz", ".bam"):
            out = os.path.join(tmp, f"fmt_{fam}{ext}")
            k1_before = K1.launches
            sec = run_cli(["-i", os.path.join(DATA, f"formats_{fam}{ext}"),
                           "-o", out, "-p", "fixture", "--format", "auto",
                           "--decoder", "native", "--pileup", "pallas"],
                          None)
            same = read_dir(out) == expected
            print(f"  formats_{fam}{ext}: decoder="
                  f"{decoder_of(cap, 'native')} byte-identical={same} "
                  f"K1 launches={K1.launches - k1_before} wall={sec:.3f}s")
            if not same:
                fail(f"formats_{fam}{ext} differs from its expected FASTA")
            if K1.launches == k1_before:
                fail(f"formats_{fam}{ext}: the run launched no K1")

    print(f"phase 7: full-size inputs, CUDA vs the port on CPU [{card}]")
    rng = np.random.RandomState(7)
    motif = "".join("ACGT"[i] for i in rng.randint(0, 4, 600))
    genome = "".join("ACGT"[i] for i in rng.randint(0, 4, 2000))
    reads = [("wide", 1 + 10 * i, "50M600I50M",
              genome[10 * i:10 * i + 50] + motif
              + genome[10 * i + 50:10 * i + 100]) for i in range(40)]
    inputs = [
        ("wide_insertion", sam_text([("wide", 2000)], reads),
         ["-c", "0.25,0.75"]),
        ("longread_sv", longread_sv(), ["-c", "0.25,0.75"]),
        ("ecoli_scale", None, ["-c", "0.25"]),
        ("amplicon_deep", None, ["-c", "0.25", "-m", "10"]),
    ]
    specs = {
        "ecoli_scale": SimSpec(n_contigs=1, contig_len=ECOLI_LEN,
                               n_reads=150000, read_len=100,
                               contig_len_jitter=0.0, seed=404,
                               contig_prefix="ecoli"),
        "amplicon_deep": SimSpec(n_contigs=1, contig_len=400, n_reads=100000,
                                 read_len=80, ins_read_rate=0.3,
                                 del_read_rate=0.2, seed=303,
                                 contig_prefix="amplicon"),
    }
    paths = {}
    for name, text, flags in inputs:
        t0 = time.perf_counter()
        if text is None:
            text = simulate(specs[name])
        path = paths[name] = write_sam(text, os.path.join(tmp, f"{name}.sam"))
        print(f"  {name}: input {len(text) / 1e6:.1f} MB made in "
              f"{time.perf_counter() - t0:.1f}s")
        before = {k.name: k.launches for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        n_stats = len(cap.stats)
        cap.input = name
        with launch_events(kernels) as events, \
                pileup_split() as (split, calls), probes() as probed:
            wall = run_cli(["-i", path, "-o",
                            os.path.join(tmp, name + "_cuda"), *flags,
                            "--decoder", "native", "--pileup", "pallas"],
                           None)
        st = cap.stats[n_stats]
        decoder_of(cap, "native")
        cap.input = None
        default_decisions(name, st.extra, probed[0], card)
        ev = {n: sum(s.elapsed_time(e) for s, e in pairs)
              for n, pairs in events.items()}
        launched = {k.name: k.launches - before[k.name] for k in kernels}
        mem = torch.cuda.max_memory_allocated() / 2**20
        cpu_wall = run_cli(["-i", path, "-o", os.path.join(tmp, name + "_cpu"),
                            *flags, "--decoder", "py", "--pileup", "pallas"],
                           "cpu")
        decoder_of(cap, "py")
        cpu_decode = cap.stats[-1].extra["decode_sec"]
        same = read_dir(os.path.join(tmp, name + "_cuda")) == \
            read_dir(os.path.join(tmp, name + "_cpu"))
        print(f"  {name} [{card}]: decoder=native on cuda, py on cpu: "
              f"decode native={st.extra['decode_sec']:.3f}s "
              f"py={cpu_decode:.3f}s")
        print(f"  {name} [{card}]: cuda wall={wall:.3f}s cpu wall="
              f"{cpu_wall:.3f}s byte-identical={same} reads="
              f"{st.reads_mapped} aligned_bases={st.aligned_bases} "
              f"max_memory_allocated={mem:.1f} MiB")
        if f"tail:{name}" in cap.calls:
            args = cap.calls[f"tail:{name}"][1]
            print(f"    insertion tail: sites={args[3].numel()} "
                  f"cols={args[9]} events={args[5].numel()}")
        for phase, names in (("decode", ()), ("pileup", ("pileup_rows",)),
                             ("tail", ("insertion_vote", "insertion_table")),
                             ("assemble", ())):
            kern = " ".join(f"{n}: {ev[n]:.3f} ms x{launched[n]}"
                            for n in names) or "no kernel"
            print(f"    {phase}: wall={st.extra[phase + '_sec']:.3f}s "
                  f"{kern}")
        print_split(split, calls, st)
        if not same:
            fail(f"{name}: CUDA output differs from the CPU run")
        want = read_dir(os.path.join(tmp, name + "_cpu"))
        tail_kernels = {n for n in ("insertion_vote", "insertion_table")
                        if launched[n]}
        strategy_runs(tmp, card, cap, name, path, flags, want, tail_kernels)
        if name in ("ecoli_scale", "amplicon_deep", "longread_sv"):
            choice_runs(tmp, card, cap, name, path, flags, want,
                        tail_kernels, st.extra)
        if name == "ecoli_scale":
            bam_runs(tmp, card, cap, text, path, flags, tail_kernels)
            thread_runs(tmp, card, cap, path, flags, want)
        if name == "longread_sv":
            width_runs(tmp, card, cap, path, flags, want)
    return paths


@contextlib.contextmanager
def probes():
    """Counts the link probes the backend asks for while the block runs
    (``torch_backend._probed_link``; yields a one-element list)."""
    from sam2consensus_torch.backends import torch_backend

    seen = [0]
    orig = torch_backend._probed_link

    def counted(*args, **kwargs):
        seen[0] += 1
        return orig(*args, **kwargs)

    torch_backend._probed_link = counted
    try:
        yield seen
    finally:
        torch_backend._probed_link = orig


def default_decisions(name: str, extra: dict, probed: int, card: str) -> None:
    """Prints a default (``--pileup pallas``) run's device-side decisions:
    the row wire, the tail's encoding and insertion route, the fetched
    bytes and the link probes; fails unless the wire is packed5, a tail
    with insertions took the kernels and the run probed nothing."""
    wire, enc = extra["wire"], extra["tail_encoding"]
    print(f"    decisions [{card}]: wire={wire['chosen']} ({wire['reason']}, "
          f"link {wire.get('link_source')}) encoding={enc['chosen']} "
          f"(link {enc.get('link_source')}) insertion_kernel="
          f"{extra.get('insertion_kernel')} fetch={extra['tail_fetch_bytes']}"
          f" B h2d={extra['h2d_bytes']} B (raw rows "
          f"{extra['wire_rows_bytes']} B, packed5-equivalent "
          f"{extra['wire_packed5_bytes']} B) pileup={extra['pileup']} "
          f"link probes={probed}")
    if wire["chosen"] != "packed5" or probed \
            or extra.get("insertion_kernel", "pallas") != "pallas":
        fail(f"{name}: the default run took wire {wire['chosen']} and "
             f"insertion route {extra.get('insertion_kernel')} and probed "
             f"the link {probed} times")


def choice_runs(tmp: str, card: str, cap: Capture, name: str, path: str,
                flags: list, want: str, tail_kernels: set,
                default: dict) -> None:
    """Phase 7's device-side choices on one full-size input, on CUDA,
    each byte-identical to the CPU run (the default CUDA run's bytes):
    ``ecoli_scale`` at ``--wire delta8`` (delta8 slabs counted, fewer
    bytes shipped than their packed5-equivalent, K1 launched) and at
    ``--pileup scatter`` (no K1); ``amplicon_deep`` and ``longread_sv`` at
    ``--insertion-kernel scatter`` (no K2 or K3) and ``pallas`` (the
    kernel of the table's width); and ``S2C_TAIL_ENCODING`` ``sparse`` and
    ``packed5`` on all three (the fetched bytes beside the default's)."""
    from sam2consensus_torch.kernels.build import all_kernels

    kernels = {k.name: k for k in all_kernels()}
    runs = []
    if name == "ecoli_scale":
        runs += [("--wire delta8", ["--wire", "delta8"], None),
                 ("--pileup scatter", [], None)]
    else:
        runs += [(f"--insertion-kernel {ik}", ["--insertion-kernel", ik],
                  None) for ik in ("scatter", "pallas")]
    runs += [(f"S2C_TAIL_ENCODING={enc}", [], enc)
             for enc in ("sparse", "packed5")]
    for label, extra_flags, enc in runs:
        out = os.path.join(tmp, f"{name}_{label.split()[-1].split('=')[-1]}")
        pileup = "scatter" if label == "--pileup scatter" else "pallas"
        before = {n: k.launches for n, k in kernels.items()}
        if enc:
            os.environ["S2C_TAIL_ENCODING"] = enc
        try:
            wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                            "native", "--pileup", pileup, *extra_flags],
                           None)
        finally:
            os.environ.pop("S2C_TAIL_ENCODING", None)
        e = cap.stats[-1].extra
        ran = {n: k.launches - before[n] for n, k in kernels.items()}
        same = read_dir(out) == want
        print(f"  {name} {label} [{card}]: wire={e['wire']['chosen']} "
              f"pileup={e['pileup']} h2d={e['h2d_bytes']} B "
              f"(raw rows {e['wire_rows_bytes']} B, packed5-equivalent "
              f"{e['wire_packed5_bytes']} B, default run "
              f"{default['h2d_bytes']} B) encoding="
              f"{e['tail_encoding']['chosen']} fetch={e['tail_fetch_bytes']}"
              f" B (default {default['tail_fetch_bytes']} B) "
              f"insertion_kernel={e.get('insertion_kernel')} "
              f"launches={ran} pileup_sec={e['pileup_sec']:.4f}s "
              f"tail={e['tail_sec']:.4f}s wall={wall:.3f}s "
              f"byte-identical={same}")
        if not same:
            fail(f"{name} {label}: output differs from the default run")
        k1 = ran["pileup_rows"]
        tail_ran = {n for n in ("insertion_vote", "insertion_table")
                    if ran[n]}
        if label == "--wire delta8":
            if not e["pileup"].get("wire_delta8") or not k1 \
                    or e["h2d_bytes"] >= e["wire_packed5_bytes"]:
                fail(f"{name} {label}: {e['pileup']}, {k1} K1 launches, "
                     f"{e['h2d_bytes']} B shipped against "
                     f"{e['wire_packed5_bytes']} B packed5-equivalent")
        elif label == "--pileup scatter":
            if k1 or not any(k.startswith("scatter_w") for k in e["pileup"]):
                fail(f"{name} {label}: {k1} K1 launches, {e['pileup']}")
        elif label.startswith("--insertion-kernel"):
            ik = extra_flags[1]
            cols = cap.calls[f"tail:{name}"][1][9]
            expect = set() if ik == "scatter" else {
                "insertion_vote" if cols <= 512 else "insertion_table"}
            if tail_ran != expect or e["insertion_kernel"] != ik:
                fail(f"{name} {label}: launched {sorted(tail_ran)}, route "
                     f"{e['insertion_kernel']}")
        elif e["tail_encoding"]["chosen"] != enc or tail_ran != tail_kernels:
            fail(f"{name} {label}: encoding {e['tail_encoding']}, launched "
                 f"{sorted(tail_ran)} against {sorted(tail_kernels)}")


def placement_of(extra: dict) -> str:
    """The tail placement of a run, with the model's inputs."""
    place = extra.get("tail_placement", {})
    keys = ("cpu_sec", "chip_sec", "rt_sec", "link_bps", "upload_bytes")
    inputs = " ".join(f"{k}={place[k]:.6g}" for k in keys if k in place)
    other = {k: v for k, v in place.items()
             if k not in keys and k not in ("chosen", "total_len",
                                            "n_thresholds")}
    return (f"tail_device={extra.get('tail_device')} native_tail="
            f"{extra.get('tail_native')} placement={place.get('chosen')} "
            f"{inputs} {other}")


def strategy_runs(tmp: str, card: str, cap: Capture, name: str, path: str,
                  flags: list, want: str, tail_kernels: set) -> None:
    """Phase 7's ``--pileup host`` and ``--pileup auto`` runs of one input
    on CUDA: byte-identical to the CPU run; a host-counts run launches no
    K1, counts in the C++ decode pass (``counts_fused``) and uploads its
    counts once exactly when its tail runs on the card, and its tail
    launches the insertion kernels the device run's tail launched
    (``tail_kernels``, as the insertion width selects them) when it runs
    on the card and none when it runs on the host; the gate's and the
    placement's decisions are printed with their inputs."""
    from sam2consensus_torch.kernels.build import all_kernels

    kernels = {k.name: k for k in all_kernels()}
    for pileup in ("host", "auto"):
        out = os.path.join(tmp, f"{name}_{pileup}")
        before = {n: k.launches for n, k in kernels.items()}
        wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                        "native", "--pileup", pileup], None)
        decoder_of(cap, "native")
        e = cap.stats[-1].extra
        host = e["pileup_path"] == "host"
        same = read_dir(out) == want
        ran = {n: k.launches - before[n] for n, k in kernels.items()}
        gate = (f"bound={e['host_bound']} bytes_bound="
                f"{e['host_bytes_bound']} input_bytes={e['input_bytes']} "
                f"reason={e['host_bound_reason']} "
                if pileup == "auto" else "")
        print(f"  {name} --pileup {pileup} [{card}]: path={e['pileup_path']} "
              f"{gate}launches={ran} counts_fused={e['counts_fused']} "
              f"pileup={e.get('pileup')} uploads={e.get('counts_uploads')} "
              f"({e.get('counts_h2d_bytes')} B) decode={e['decode_sec']:.3f}s "
              f"tail={e['tail_sec']:.3f}s wall={wall:.3f}s "
              f"byte-identical={same}")
        print(f"    {placement_of(e)}")
        if not same:
            fail(f"{name} --pileup {pileup}: output differs from the CPU run")
        if pileup == "host" and not host:
            fail(f"{name}: --pileup host took the device path")
        if host:
            card_tail = e["tail_device"] == "cuda"
            k1 = ran["pileup_rows"]
            if k1 or not e["counts_fused"] \
                    or e["counts_uploads"] != int(card_tail):
                fail(f"{name} --pileup {pileup}: host counts launched "
                     f"{k1} K1, counts_fused={e['counts_fused']}, "
                     f"{e['counts_uploads']} uploads for a "
                     f"{e['tail_device']} tail")
            tail_ran = {n for n in ("insertion_vote", "insertion_table")
                        if ran[n]}
            if tail_ran != (tail_kernels if card_tail else set()):
                fail(f"{name} --pileup {pileup}: a {e['tail_device']} "
                     f"tail launched {sorted(tail_ran)}, the device run's "
                     f"{sorted(tail_kernels)}")
        elif not ran["pileup_rows"]:
            fail(f"{name} --pileup auto took the device path and launched "
                 f"no K1")


def thread_runs(tmp: str, card: str, cap: Capture, path: str, flags: list,
                want: str) -> None:
    """``ecoli_scale`` at ``--decode-threads`` 1, 4 and 0 under ``--pileup
    pallas`` (slab mode, on the stager) and ``--pileup host`` (fused mode):
    byte-identical, and the sharded rung with more than one shard whenever
    threads > 1."""
    for pileup in ("pallas", "host"):
        for threads in ("1", "4", "0"):
            out = os.path.join(tmp, f"ecoli_t{threads}_{pileup}")
            wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                            "native", "--pileup", pileup, "--decode-threads",
                            threads], None)
            e = cap.stats[-1].extra
            mode = e.get("ingest_mode", {})
            shards = e.get("ingest_shards", 0)
            same = read_dir(out) == want
            print(f"  ecoli_scale --pileup {pileup} --decode-threads "
                  f"{threads} [{card}]: threads={e['decode_threads']} "
                  f"rung={mode.get('rung', 'serial')} shards={shards} "
                  f"decode_sec={e['decode_sec']:.4f}s worker_sec="
                  f"{e.get('ingest_worker_sec', 0.0):.4f}s "
                  f"pileup={e['pileup_sec']:.4f}s wall={wall:.3f}s "
                  f"byte-identical={same}")
            if not same:
                fail(f"ecoli_scale --decode-threads {threads} --pileup "
                     f"{pileup}: output differs")
            if threads != "1" and (mode.get("rung") != "shards"
                                   or shards <= 1):
                fail(f"ecoli_scale --decode-threads {threads}: not the "
                     f"sharded rung with more than one shard ({mode})")


def width_runs(tmp: str, card: str, cap: Capture, path: str, flags: list,
               want: str) -> None:
    """``longread_sv`` at ``--segment-width -1`` beside the default: the
    lines replayed through the Python encoder (none may at -1) and those
    the C decoder took one by one, and both runs' decode seconds."""
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder

    seen = {"replayed": 0, "native": 0}
    replay = NativeReadEncoder._fallback_line
    single = NativeReadEncoder._native_line

    def counted_replay(self, *args, **kwargs):
        seen["replayed"] += 1
        return replay(self, *args, **kwargs)

    def counted_single(self, *args, **kwargs):
        took = single(self, *args, **kwargs)
        seen["native"] += bool(took)
        return took

    NativeReadEncoder._fallback_line = counted_replay
    NativeReadEncoder._native_line = counted_single
    try:
        for width in ("0", "-1"):
            seen.update(replayed=0, native=0)
            out = os.path.join(tmp, f"longread_w{width}")
            wall = run_cli(["-i", path, "-o", out, *flags, "--decoder",
                            "native", "--pileup", "pallas",
                            "--segment-width", width], None)
            e = cap.stats[-1].extra
            same = read_dir(out) == want
            print(f"  longread_sv --segment-width {width} [{card}]: lines "
                  f"replayed in python={seen['replayed']} decoded natively "
                  f"one by one={seen['native']} decode_sec="
                  f"{e['decode_sec']:.4f}s pileup={e['pileup_sec']:.4f}s "
                  f"wall={wall:.3f}s byte-identical={same}")
            if not same:
                fail(f"longread_sv --segment-width {width}: output differs")
            if width == "-1" and seen["replayed"]:
                fail("longread_sv --segment-width -1 replayed lines in "
                     "python")
    finally:
        NativeReadEncoder._fallback_line = replay
        NativeReadEncoder._native_line = single


def host_rates(cap: Capture, card: str) -> None:
    """The link probe's numbers and the native vote's ns a position at
    ``ecoli_scale``'s L (the counts of its run) for T = 1 and T = 2, one
    thread (``--decode-threads 1``), best of 3."""
    from sam2consensus_torch.ops.vote import vote_positions_native
    from sam2consensus_torch.utils.linkprobe import probe_link

    p = probe_link()
    print(f"  link probe [{card}]: round trip {p.rt_sec * 1e3:.4f} ms, "
          f"H2D {p.h2d_bps / 1e9:.3f} GB/s, D2H {p.d2h_bps / 1e9:.3f} GB/s "
          f"(pinned 1 MiB; the model bills {p.bps / 1e9:.3f} GB/s)")
    _, (counts, _s, _p), src = cap.calls["K1"]
    host = np.ascontiguousarray(counts[:ECOLI_LEN].cpu().numpy())
    length = len(host)
    for thresholds in ([0.25], [0.25, 0.75]):
        best = min(_host_sec(lambda: vote_positions_native(
            host, thresholds, 1, threads=1)) for _ in range(3))
        print(f"  native vote [{card}]: {src} L={length} "
              f"T={len(thresholds)}: {best * 1e3:.3f} ms, "
              f"{best / length * 1e9:.3f} ns a position")


def _host_sec(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bam_runs(tmp: str, card: str, cap: Capture, text: str, sam_path: str,
             flags: list, tail_kernels: set) -> None:
    """Phase 7's BAM input: ``ecoli_scale`` written as BAM by the port's
    writer, run on CUDA (``--decoder native`` at ``--decode-threads`` 1
    and 0) and on the CPU (``--decoder py``); every output must equal the
    others and the SAM run's."""
    from sam2consensus_torch.formats.bam import sam_text_to_bam
    from sam2consensus_torch.formats.bgzf import BgzfReader
    from sam2consensus_torch.ops.pileup_kernel import K1

    t0 = time.perf_counter()
    bam = sam_text_to_bam(text, os.path.join(tmp, "ecoli_scale.bam"))
    with BgzfReader(bam) as reader:
        inflated = len(reader.read())
    print(f"  ecoli_scale.bam: {os.path.getsize(bam)} B on disk, {inflated} "
          f"B inflated, written in {time.perf_counter() - t0:.1f}s")
    want = read_dir(os.path.join(tmp, "ecoli_scale_cuda"))
    for device, threads, decoder in ((None, "1", "native"),
                                     (None, "0", "native"),
                                     ("cpu", "1", "py")):
        out = os.path.join(tmp, f"ecoli_bam_{device}_{threads}")
        k1_before = K1.launches
        wall = run_cli(["-i", bam, "-o", out, *flags, "--decode-threads",
                        threads, "--decoder", decoder, "--pileup", "pallas"],
                       device)
        decoder_of(cap, decoder)
        st = cap.stats[-1]
        dec = st.extra["decode_sec"]
        same = read_dir(out) == want
        print(f"  ecoli_scale.bam [{card}] on {device or 'cuda'} "
              f"--decode-threads {threads} --decoder {decoder}: decode="
              f"{dec:.3f}s ({inflated / dec / 1e6:.1f} MB/s inflated, "
              f"{os.path.getsize(bam) / dec / 1e6:.1f} MB/s on disk) "
              f"wall={wall:.3f}s pileup={st.extra['pileup_sec']:.3f}s "
              f"stage_sec={st.extra['stage_sec']:.4f}s "
              f"overlap_sec={st.extra['overlap_sec']:.4f}s "
              f"backpressure_sec={st.extra['backpressure_sec']:.4f}s "
              f"byte-identical to the SAM run={same}")
        if not same:
            fail(f"ecoli_scale.bam on {device or 'cuda'} (threads "
                 f"{threads}) differs from the SAM run")
        if device is None and K1.launches == k1_before:
            fail("ecoli_scale.bam: the CUDA run launched no K1")
    strategy_runs(tmp, card, cap, "ecoli_scale.bam", bam, flags, want,
                  tail_kernels)


# -- phase 8: no host synchronisation in the routes and the tails ----------
def sync_free(cap: Capture) -> None:
    from sam2consensus_torch.ops import fused
    from sam2consensus_torch.ops.pileup import HostPileupAccumulator
    from sam2consensus_torch.ops import insertion_kernel as ik
    from sam2consensus_torch.ops import pileup_kernel as pk

    _, (counts, starts, packed), _ = cap.calls["K1"]
    k2_args, k3_args = cap.calls["K2"][1], cap.calls["K3"][1]
    scratch = torch.zeros_like(counts)
    # the staged route: the same rows as a batch of raw codes, staged as
    # the prefetch thread stages them (outside the check: the producer
    # may wait on the host); the consumer's add (event wait, device pack,
    # K1 route) runs under it
    acc, batch = staged_batch(counts, starts, packed)
    acc.stage(batch)
    # the same rows staged under delta8 (canonicalised and encoded on the
    # host) and for the scatter strategy
    acc8, batch8 = staged_batch(counts, starts, packed, wire="delta8")
    acc8.stage(batch8)
    acc_sc, batch_sc = staged_batch(counts, starts, packed,
                                    strategy="scatter")
    acc_sc.stage(batch_sc)
    if not acc8.account.slabs.get("delta8"):
        fail(f"the staged delta8 slab went raw: {acc8.account.extra()}")
    # the position head's other encodings on each captured tail
    heads = {}
    for name in ("ecoli_scale", "amplicon_deep", "longread_sv"):
        args = cap.calls["tail:" + name][1]
        cap_ = fused.pad_cap(args[0].shape[0] + 1)
        for enc, out_enc in (("sparse", cap_), ("packed5", "packed5")):
            heads[f"{enc} tail on {name}"] = \
                lambda args=args, out_enc=out_enc: fused.vote_packed(
                    *args[:12], out_enc)
    # the host-count route: counts as the fused decode leaves them on the
    # host (set outside the check); the upload and the tail run under it
    host_accs, host_tails = {}, {}
    for name in ("amplicon_deep", "longread_sv"):
        dense = cap.calls["tail:" + name][1][0]
        host_accs[name] = HostPileupAccumulator(dense.shape[0])
        host_accs[name].set_counts(dense.cpu().numpy())
    torch.cuda.synchronize()
    for what, route in (
            ("K1 route", lambda: pk.accumulate_rows(scratch, starts, packed)),
            ("staged K1 route (PileupAccumulator.add: event wait, device "
             "pack, K1)", lambda: acc.add(batch)),
            ("staged delta8 route (PileupAccumulator.add: event wait, "
             "device unpack, device pack, K1)", lambda: acc8.add(batch8)),
            ("staged scatter strategy (PileupAccumulator.add: event wait, "
             "scatter_segments)", lambda: acc_sc.add(batch_sc)),
            *heads.items(),
            ("K2 route", lambda: ik.vote_insertions_fused(*k2_args)),
            ("K3 route", lambda: ik.build_insertion_table_kernel(*k3_args)),
            *((f"vote_packed on {name}'s tail (cols="
               f"{cap.calls['tail:' + name][1][9]})",
               lambda name=name: fused.vote_packed(
                   *cap.calls["tail:" + name][1]))
              for name in ("longread_sv", "amplicon_deep")),
            *((f"host-count route on {name}'s tail (the narrowed counts' "
               f"pinned upload, then vote_packed; "
               f"{'K3' if name == 'longread_sv' else 'K2'})",
               lambda name=name: host_tails.__setitem__(
                   name, fused.vote_packed(
                       host_accs[name].counts_on(counts.device),
                       *cap.calls["tail:" + name][1][1:])))
              for name in ("amplicon_deep", "longread_sv"))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            route()
        except RuntimeError as exc:
            fail(f"{what} synchronised with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  {what} under set_sync_debug_mode('error'): "
              f"no host synchronisation")
    for what, other in (("staged route", acc), ("staged delta8 route", acc8),
                        ("staged scatter strategy", acc_sc)):
        err = max_err(other.counts, scratch[:other.total_len])
        print(f"  {what} counts vs the K1 route on the same rows: "
              f"max_abs_err={err}")
        if err:
            fail(f"the {what}'s counts differ from the K1 route's")
    # not required sync-free: the insertion table by index_put_
    for name in ("amplicon_deep", "longread_sv"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fused.vote_packed_scatter(*cap.calls["tail:" + name][1])
            synced = "no host synchronisation"
        except RuntimeError as exc:
            synced = f"synchronises ({str(exc).splitlines()[0]})"
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  the --insertion-kernel scatter tail on {name}: {synced}")
    for name, got in host_tails.items():
        want = fused.vote_packed(*cap.calls["tail:" + name][1])
        err = max_err(got, want)
        print(f"  host-count route on {name}: upload dtype "
              f"{host_accs[name].strategy_used['host_wire_dtype']} "
              f"({host_accs[name].bytes_h2d} B), packed tail vs the int32 "
              f"route's: max_abs_err={err}")
        if err:
            fail(f"the host-count route's tail differs on {name}")


def staged_batch(counts, starts, packed, strategy="pallas", wire="packed5"):
    """A CUDA ``PileupAccumulator`` over ``counts``' positions (with the
    given strategy and wire) and a ``SegmentBatch`` holding the rows
    ``(starts, packed)`` as raw codes (PAD 255), as the decoder hands them
    over."""
    from sam2consensus_torch.encoder.events import SegmentBatch
    from sam2consensus_torch.ops.pileup import (PileupAccumulator,
                                                unpack_nibbles)

    codes = unpack_nibbles(packed).cpu().numpy()
    codes[codes == 15] = 255
    acc = PileupAccumulator(counts.shape[0] - 1, counts.device, strategy,
                            wire)
    batch = SegmentBatch(buckets={codes.shape[1]: (
        starts.cpu().numpy(), codes)}, n_reads=len(codes))
    return acc, batch


# -- the device-side choices at the main path's shapes ----------------------
def choice_timing(cap: Capture, card: str) -> None:
    """Times the run's device-side choices with CUDA events (mean of 20
    calls after a warm-up): the delta8 unpack of the K1 slab (and its
    host encode, host clock) with its bytes against packed5 and the raw
    rows; the scatter strategy against K1's route on the same rows; the
    position head's three encodings on ``ecoli_scale``'s counts (the
    no-insertion tail) and in the whole tails of ``amplicon_deep`` (K2)
    and ``longread_sv`` (K3), with their fetched bytes, beside the
    ``--insertion-kernel scatter`` tail; then the constants the gates
    read."""
    from sam2consensus_torch.backends import torch_backend as tb
    from sam2consensus_torch.ops import fused
    from sam2consensus_torch.ops import pileup as pl
    from sam2consensus_torch.ops.pileup_kernel import accumulate_rows
    from sam2consensus_torch.wire import WireAccount, codec, encode_wire_slab
    from sam2consensus_torch.wire.device import decode_slab, wire_lane

    _, (counts, starts, packed), src = cap.calls["K1"]
    codes = pl.unpack_nibbles(packed)
    codes = torch.where(codes == 15, 255, codes)
    n, w = codes.shape
    host_s, host_c = starts.cpu().numpy(), codes.cpu().numpy()
    enc_sec = min(_host_sec(lambda: encode_wire_slab(
        "delta8", host_s, host_c, WireAccount())) for _ in range(3))
    slab = encode_wire_slab("delta8", host_s, host_c, WireAccount())
    if slab is None:
        fail(f"{src}'s K1 slab did not take delta8")
    lanes = [torch.from_numpy(np.ascontiguousarray(wire_lane(a))).to(
        counts.device) for a in slab.arrays()]
    meta = (slab.width, slab.sentinel, tuple(
        a.dtype == np.uint16 for a in (slab.esc_delta, slab.trail,
                                       slab.esc_idx)))
    unpack = time_ms(lambda: decode_slab(*lanes, *meta), 20)
    lane_bytes = sum(a.nbytes for a in slab.arrays())
    raw = codec.packed5_slab_bytes(n, w)
    print(f"  delta8 on {src}'s K1 slab ({n} x {w}) [{card}]: host encode "
          f"{enc_sec * 1e3:.3f} ms ({enc_sec / (n * w) * 1e9:.4f} ns a "
          f"cell), device unpack {unpack:.4f} ms ({unpack * 1e6 / (n * w):.4f}"
          f" ns a cell); lanes {lane_bytes} B against packed5 {raw} B and "
          f"the raw rows {n * (4 + w)} B (saved "
          f"{(n * (4 + w) - lane_bytes) / (n * w):.4f} B a cell against the "
          f"raw rows, priced at {codec.ROWS_SAVED_BYTES_PER_CELL}; "
          f"{(raw - lane_bytes) / (n * w):.4f} against packed5, the "
          f"reference's {codec.SAVED_BYTES_PER_CELL})")
    scratch = torch.zeros_like(counts)
    k1 = time_ms(lambda: accumulate_rows(scratch, starts,
                                         pl.pack_codes(codes)), 20)
    sc = time_ms(lambda: pl.scatter_segments(scratch, starts, codes,
                                             counts.shape[0] - 1), 20)
    print(f"  pileup strategies on that slab [{card}]: K1 route (device "
          f"pack + K1) {k1:.4f} ms, scatter {sc:.4f} ms ({sc / k1:.2f}x)")

    def heads(label, call, length):
        cap_ = fused.pad_cap(length + 1)
        parts = []
        for enc, out_enc in (("dense", None), ("sparse", cap_),
                             ("packed5", "packed5")):
            ms = time_ms(lambda: call(out_enc), 10)
            parts.append(f"{enc} {ms:.4f} ms {call(out_enc).numel()} B")
        print(f"  {label} [{card}]: " + ", ".join(parts))

    args = cap.calls["tail:ecoli_scale"][1]
    heads(f"position head alone on ecoli_scale (L={args[0].shape[0]})",
          lambda out_enc: fused.vote_packed_simple(
              args[0], args[1], args[2], args[8], 0, False, out_enc),
          args[0].shape[0])
    for name in ("amplicon_deep", "longread_sv"):
        args = cap.calls["tail:" + name][1]
        heads(f"whole tail on {name} (L={args[0].shape[0]}, "
              f"{args[3].numel()} sites x {args[9]} cols)",
              lambda out_enc, args=args: fused.vote_packed(*args[:12],
                                                           out_enc),
              args[0].shape[0])
        kern = time_ms(lambda: fused.vote_packed(*args), 10)
        scat = time_ms(lambda: fused.vote_packed_scatter(*args), 10)
        print(f"  insertion routes in {name}'s dense tail [{card}]: "
              f"kernels {kern:.4f} ms, scatter {scat:.4f} ms")
    print(f"  the gates' constants [{card}]: WIRE_HOST_NS="
          f"{codec.WIRE_HOST_NS} WIRE_DEV_NS={codec.WIRE_DEV_NS} (--wire "
          f"auto below {codec.wire_auto_cutoff_bps() / 1e6:.1f} MB/s) "
          f"SPARSE_NS_PER_POS={tb.SPARSE_NS_PER_POS} P5_HOST_NS_PER_CHAR="
          f"{tb.P5_HOST_NS_PER_CHAR} P5_DEV_NS_PER_CHAR="
          f"{tb.P5_DEV_NS_PER_CHAR} ROWS_SAVED_BYTES_PER_CELL="
          f"{codec.ROWS_SAVED_BYTES_PER_CELL} LINK_BPS_FLOOR="
          f"{tb.LINK_BPS_FLOOR / 1e9:.1f} GB/s LINK_RT_SEC_CEIL="
          f"{tb.LINK_RT_SEC_CEIL * 1e6:.1f} us")


# -- phase 9: the C++ decoder against the Python encoder --------------------
def drain(encoder, batches, total_len: int):
    """Pileup counts ``[L, 6]`` and events of ``batches``, with the seconds
    spent inside the encoder (the counting is not timed)."""
    counts = np.zeros((total_len + 1) * 6, np.int64)
    n_events, sec = 0, 0.0
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        sec += time.perf_counter() - t0
        if batch is None:
            break
        n_events += batch.n_events
        for starts, codes in batch.buckets.values():
            rows, cols = np.nonzero(codes != 255)
            counts += np.bincount((starts[rows].astype(np.int64) + cols) * 6
                                  + codes[rows, cols], minlength=len(counts))
    return counts.reshape(-1, 6)[:-1], n_events, sec


def encoder_parity(paths: dict, card: str) -> None:
    from sam2consensus_torch.encoder.events import (GenomeLayout, ReadEncoder,
                                                    group_insertions,
                                                    resolve_segment_width)
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder
    from sam2consensus_torch.io.sam import ReadStream, opener, read_header

    seg_w = resolve_segment_width(0)
    for name in ("ecoli_scale", "longread_sv"):
        got = {}
        for kind in ("native", "py"):
            with opener(paths[name], binary=True) as handle:
                contigs, _n, first = read_header(handle)
                stream = ReadStream(handle, first)
                body = stream.body_bytes_total()
                layout = GenomeLayout(contigs)
                if kind == "native":
                    enc = NativeReadEncoder(
                        layout, on_lines=stream.add_lines,
                        on_bytes=stream.add_bytes, segment_width=seg_w)
                    batches = enc.encode_blocks_from(stream)
                else:
                    enc = ReadEncoder(layout, segment_width=seg_w)
                    batches = enc.encode_segments(stream.records())
                counts, n_events, sec = drain(enc, batches, layout.total_len)
            got[kind] = (counts, enc.n_reads, enc.n_skipped, n_events,
                         stream.n_lines,
                         group_insertions(enc.insertions, layout))
            print(f"  {name} {kind} [{card}]: decode={sec:.3f}s "
                  f"({body / sec / 1e6:.1f} MB/s of {body} B) reads="
                  f"{enc.n_reads} skipped={enc.n_skipped} events={n_events} "
                  f"lines={stream.n_lines} insertion events="
                  f"{len(enc.insertions)}")
        (c1, *rest1, g1), (c2, *rest2, g2) = got["native"], got["py"]
        same = np.array_equal(c1, c2) and rest1 == rest2 and (
            g1 is None and g2 is None or g1 is not None and g2 is not None
            and sorted(g1) == sorted(g2)
            and all(np.array_equal(g1[k], g2[k]) for k in g1))
        print(f"  {name}: native == py (counts {int(c1.sum())} cells, "
              f"reads, skipped, events, lines, insertion groups): {same}")
        if not same:
            fail(f"{name}: NativeReadEncoder differs from ReadEncoder")


def compare(kid: str, got: torch.Tensor, want: torch.Tensor) -> int:
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err:
        fail(f"{kid} differs from its plain version at the main-path shapes")
    return err


def measure(cap: Capture, launches: dict, errs: dict) -> list:
    """Hold each kernel against its plain version once more at the largest
    main-path shapes it was given (fresh outputs, exact), then time there:
    the kernel alone, its route (what the main path pays), the plain
    version and, where one exists, one library call."""
    from sam2consensus_torch.ops import insertion_kernel as ik
    from sam2consensus_torch.ops import pileup_kernel as pk
    from sam2consensus_torch.ops.insertions import (build_insertion_table,
                                                    vote_insertions)
    from sam2consensus_torch.ops.pileup import (expand_segment_positions,
                                                scatter_segments_packed,
                                                unpack_nibbles)

    rows = []
    # K1 at the largest slab; the timed calls accumulate into scratch
    _, (counts, starts, packed), src_k1 = cap.calls["K1"]
    n, wb = packed.shape
    want = scatter_segments_packed(torch.zeros_like(counts), starts, packed)
    err = compare("K1", pk.accumulate_rows(torch.zeros_like(counts), starts,
                                           packed), want)
    covered = int((want != 0).any(dim=1).sum())
    cells = int(want.sum())
    # the library call: one torch.bincount of the flat cell index, on the
    # expanded operands alone and again with the expansion
    pos, code = expand_segment_positions(starts, unpack_nibbles(packed))
    flat = pos * 6 + code
    size = counts.numel()
    lib_err = compare("K1 (torch.bincount)", torch.bincount(
        flat, minlength=size).view(counts.shape).to(torch.int32), want)
    lib_ms = time_ms(lambda: torch.bincount(flat, minlength=size), 10)

    def expanded_bincount():
        p, c = expand_segment_positions(starts, unpack_nibbles(packed))
        return torch.bincount(p * 6 + c, minlength=size)

    lib_full_ms = time_ms(expanded_bincount, 10)
    print(f"  K1 library: torch.bincount(pos * 6 + code) on the expanded "
          f"operands ({flat.numel()} cells) {lib_ms:.4f} ms, with the "
          f"expansion {lib_full_ms:.4f} ms, max_abs_err={lib_err}")
    del want, pos, code, flat
    scratch = torch.zeros_like(counts)
    ms = kernel_ms(pk.K1, lambda: pk.accumulate_rows(scratch, starts, packed),
                   20)
    dev_ms = device_ms(pk.K1, lambda: pk.accumulate_rows(scratch, starts,
                                                         packed), 20)
    route = time_ms(lambda: pk.accumulate_rows(scratch, starts, packed), 20)
    plain = time_ms(lambda: scatter_segments_packed(scratch, starts, packed),
                    5)
    # rows and starts read once; counts read and written once where the
    # rows cover it (24 B a position)
    nbytes = n * (4 + wb) + 2 * covered * 6 * 4
    rows.append(("K1", pk.K1, "csrc/pileup.cu",
                 "sam2consensus_tpu/ops/pallas_pileup.py:86", err, ms, dev_ms,
                 route, plain, lib_ms, nbytes, 10 * cells,
                 f"{src_k1}: rows={n} width={2 * wb} L={counts.shape[0]} "
                 f"covered={covered} cells={cells}"))

    # K2 at its largest table; the route starts from the events the tail
    # hands over, unsorted, as does the plain version
    _, args, src_k2 = cap.calls["K2"]
    ev_key, ev_col, ev_code, site_cov, n_cols, cp, thr = args
    kp = site_cov.numel()

    def plain_vote():
        return vote_insertions(
            build_insertion_table(kp, cp, ev_key, ev_col, ev_code),
            site_cov, n_cols, thr)

    err = compare("K2", ik.vote_insertions_fused(*args), plain_vote())
    ms = kernel_ms(ik.K2, lambda: ik.vote_insertions_fused(*args), 20)
    dev_ms = device_ms(ik.K2, lambda: ik.vote_insertions_fused(*args), 20)
    route = time_ms(lambda: ik.vote_insertions_fused(*args), 20)
    plain = time_ms(plain_vote, 5)
    e = ev_key.numel()
    nbytes = e * 3 * 4 + 2 * kp * 4 + len(thr) * kp * cp
    ops = e * 4 + kp * cp * (80 + 12 * len(thr))
    rows.append(("K2", ik.K2, "csrc/insertion.cu",
                 "sam2consensus_tpu/ops/pallas_insertion.py:173", err, ms,
                 dev_ms, route, plain, None, nbytes, ops,
                 f"{src_k2}: keys={kp} cols={cp} events={e} T={len(thr)}"))

    # K3 at its largest table (longread_sv's wide tail); the route starts
    # from the events the tail hands over, unsorted, as does the plain version
    _, args, src_k3 = cap.calls["K3"]
    ev, kp, cp = args[:3], args[3], args[4]
    err = compare("K3", ik.build_insertion_table_kernel(*args),
                  build_insertion_table(kp, cp, *ev))
    lib_before = time_ms(lambda: index_put_table(kp, cp, *ev), 10)
    ms = kernel_ms(ik.K3, lambda: ik.build_insertion_table_kernel(*args), 20)
    dev_ms = device_ms(ik.K3, lambda: ik.build_insertion_table_kernel(*args),
                       20)
    route = time_ms(lambda: ik.build_insertion_table_kernel(*args), 20)
    plain = time_ms(lambda: build_insertion_table(kp, cp, *ev), 5)
    lib = time_ms(lambda: index_put_table(kp, cp, *ev), 10)
    print(f"  K3 index_put_ before / after the kernel: {lib_before:.4f} / "
          f"{lib:.4f} ms")
    e = ev[0].numel()
    # the table written once (the memset's bytes) and 12 B an event read
    nbytes = e * 3 * 4 + kp * cp * 6 * 4
    rows.append(("K3", ik.K3, "csrc/insertion.cu",
                 "sam2consensus_tpu/ops/pallas_insertion.py:75", err, ms,
                 dev_ms, route, plain, min(lib_before, lib), nbytes, 4 * e,
                 f"{src_k3}: keys={kp} cols={cp} events={e}"))

    out = []
    for (kid, kern, src, replaces, err, ms, dev_ms, route, plain, lib, nbytes,
         ops, shape) in rows:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CORE_OPS_PER_S * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  {kid} {kern.name}: {shape} max_abs_err={err} kernel="
              f"{ms:.4f} ms (device {dev_ms:.4f} ms) route={route:.4f} ms "
              f"plain={plain:.4f} ms "
              f"(plain/route {plain / route:.1f}x) library="
              f"{'n/a' if lib is None else f'{lib:.4f} ms'} bound="
              f"{max(t_bytes, t_ops):.4f} ms ({bound_by}, {nbytes} B)")
        out.append({"name": kern.name, "route": "cuda", "source":
                    "sam2consensus_torch/" + src, "replaces": replaces,
                    "launches": launches[kern.name],
                    "max_abs_err": max(errs[kid], err), "ms": ms,
                    "device_ms": dev_ms,
                    "route_ms": route, "plain_ms": plain,
                    "bound_ms": max(t_bytes, t_ops), "bound_by": bound_by,
                    "library_ms": lib})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
             "card")
    from concurrent.futures import ThreadPoolExecutor

    from sam2consensus_torch import native
    from sam2consensus_torch.kernels import build
    from sam2consensus_torch.ops import fused, pileup_kernel
    from sam2consensus_torch.backends.torch_backend import TorchBackend

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    print("phase 2: build")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(1) as pool:
        reports = ptxas_reports(tmp)

        def build_decoder():
            lib = native.load()
            return lib, time.perf_counter() - t0

        decoder = pool.submit(build_decoder)
        try:
            ext = build.extension()
            print(f"  built {ext.__name__} from {list(build.SOURCES)} in "
                  f"{time.perf_counter() - t0:.1f}s")
            lib, sec = decoder.result(timeout=900)
            if lib is None:
                fail(f"the native decoder did not build: "
                     f"{native.load_error()}")
            print(f"  built {os.path.relpath(lib._name, REPO)} from "
                  f"{os.path.relpath(native.SRC, REPO)} in {sec:.1f}s")
            for src, proc in reports:
                out, _ = proc.communicate(timeout=900)
                if proc.returncode != 0:
                    fail(f"nvcc -Xptxas=-v {src} failed:\n{out}")
                print(f"  ptxas {src}:")
                for line in out.splitlines():
                    if "spill" in line or "ptxas info" in line and any(
                            k in line for k in ("Used", "Compiling")):
                        print("    " + line.split(" : ")[-1].strip())
        finally:
            for _src, proc in reports:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    rng = np.random.default_rng(2024)
    print("phase 3: K1 vs plain")
    errs = {"K1": check_k1(rng, dev)}
    print("phase 4: K2 vs plain")
    errs["K2"] = check_k2(rng, dev, card)
    print("phase 5: K3 vs plain")
    errs["K3"] = check_k3(rng, dev, card)

    cap = Capture()
    # sizes of CUDA calls only: the CPU reference runs call the same
    # wrappers (and take their plain versions)
    cap.wrap(pileup_kernel, "accumulate_rows", "K1",
             lambda counts, starts, packed:
             packed.numel() if counts.is_cuda else -1)
    cap.wrap(fused, "vote_insertions_fused", "K2",
             lambda ev_key, ev_col, ev_code, site_cov, n_cols, cp, thr:
             site_cov.numel() * cp + ev_key.numel()
             if ev_key.is_cuda else -1)
    cap.wrap(fused, "build_insertion_table_kernel", "K3",
             lambda ev_key, ev_col, ev_code, kp, cp:
             kp * cp + ev_key.numel() if ev_key.is_cuda else -1)
    cap.wrap(fused, "vote_packed", "tail:{input}",
             lambda counts, *rest: 0 if counts.is_cuda else -1)
    orig_run = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig_run(self, *args, **kwargs)
        cap.stats.append(result.stats)
        return result

    TorchBackend.run = run

    kernels = build.all_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launches(kernels)
        paths = main_path(tmp, card, cap)
        launches = {k.name: k.launches for k in kernels}
        print(f"main-path launches: {launches}")
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")

        print(f"host rates [{card}]")
        host_rates(cap, card)

        print("phase 8: the K1, K2 and K3 routes, the staged K1, delta8 "
              "and scatter routes, every tail encoding and the host-count "
              "route make no host synchronisation")
        sync_free(cap)

        print(f"the device-side choices at the main path's shapes [{card}]")
        choice_timing(cap, card)

        print(f"phase 9: NativeReadEncoder vs ReadEncoder at full size "
              f"[{card}]")
        encoder_parity(paths, card)

    print(f"kernel timing at main-path shapes [{card}]")
    report = measure(cap, launches, errs)
    print(f"total {time.perf_counter() - t_start:.1f}s [{card}]")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
