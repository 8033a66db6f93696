#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``sam2consensus_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1;
2. build the CUDA kernels (``csrc/``, one ``torch.utils.cpp_extension.load``)
   and, started beside it, one ``nvcc -Xptxas=-v`` per kernel source, whose
   report of each kernel's registers, shared memory and spills is printed;
3-5. every kernel against its plain PyTorch version on the card, exact
   equality (integer data, tolerance 0): K1 pileup histogram, K2 fused
   insertion table + vote (and its time on one hot key), K3 insertion
   table (and its time at 50 keys x 1300 columns);
6-7. the main path through ``cli.main`` on CUDA, with the launch counts
   set to 0 just before and read just after: the ``formats_*`` fixtures
   (``.sam``/``.sam.gz``, byte-identical to ``*.expected.fasta``), a wide
   insertion input (padded columns > 512, the K3 route), and two of
   ``bench.py``'s configurations at full size — ``ecoli_scale`` (4.6 Mbp,
   150,000 x 100 bp reads) and ``amplicon_deep`` (400 bp, 100,000 x 80 bp
   reads, deep insertions) — each byte-identical to the port's CPU run,
   with the pileup phase split into its host steps.  Every kernel must have
   launched in that window;
8. the K1 and K2 routes once each at the largest main-path shapes under
   ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation in
   either is fatal.

Then each kernel is held against its plain version once more at the
largest shapes the main path gave it (fresh outputs, exact; a difference
is fatal) and timed there with CUDA events: the kernel alone (and its
device time from ``torch.profiler``, which holds no host time), its route
(what the main path pays: plan, if any, and wrapper), its plain version,
one PyTorch library call where one computes the same function, and its
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
    """Mean device time of the kernel alone (``torch.profiler``'s CUDA time
    of the kernel function(s) the entry point launches), over ``reps``
    entry-point calls on one launch's arguments: unlike :func:`kernel_ms`
    it holds no host time.  0.0 when the profiler sees no device work."""
    from torch.profiler import ProfilerActivity, profile

    with last_launch(kernel) as seen:
        call()
    fn, args = kernel.function(), seen[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if kernel.name + "_kernel" in e.key)
    return total / reps / 1e3


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
        K3, build_insertion_table_kernel, plan_events)
    from sam2consensus_torch.ops.insertions import build_insertion_table

    worst = 0
    for k, cp, e in ((50, 1300, 60000), (3, 2048, 20000)):
        key, col, code = _events(rng, k, cp, e, hot=1)
        col[:100] = 511
        col[100:200] = 512
        tk = [torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (key, col, code)]
        got = build_insertion_table_kernel(plan_events(*tk, k, cp))
        want = build_insertion_table(k, cp, *tk)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"  K3: k={k} cp={cp} events={e} max_abs_err={err}")
        if err:
            fail("K3 differs from its plain version")
        worst = max(worst, err)
        if k == 50:
            ms = kernel_ms(K3, lambda: build_insertion_table_kernel(
                plan_events(*tk, k, cp)), 20)
            route = time_ms(lambda: build_insertion_table_kernel(
                plan_events(*tk, k, cp)), 20)
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
    """Records, per kernel wrapper, the call with the largest input the main
    path made, so the kernel can be timed afterwards at those shapes."""

    def __init__(self):
        self.calls = {}
        self.stats = []

    def wrap(self, module, attr, key, size_of):
        orig = getattr(module, attr)

        def wrapper(*args):
            size = size_of(*args)
            if size > self.calls.get(key, (-1, None))[0]:
                self.calls[key] = (size, args)
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
    """Host-clock seconds of the pileup phase's steps while the block runs:
    ``real_rows`` and ``pack_nibbles`` (numpy on the host), the K1 route
    (``accumulate_rows``: the device sort and the launch, enqueued), the
    rest of ``PileupAccumulator.add`` (mostly its two pageable
    host-to-device copies, which also wait for the work queued before
    them), and ``sync`` (the wait for the last kernel).  Yields the sums
    and the bytes the copies moved."""
    from sam2consensus_torch.ops import pileup, pileup_kernel

    sec = dict.fromkeys(("add", "real_rows", "pack_nibbles", "route", "sync",
                         "h2d_bytes"), 0)
    saved = []
    for obj, attr, key in ((pileup, "real_rows", "real_rows"),
                           (pileup, "pack_nibbles", "pack_nibbles"),
                           (pileup_kernel, "accumulate_rows", "route"),
                           (pileup.PileupAccumulator, "add", "add"),
                           (pileup.PileupAccumulator, "sync", "sync")):
        orig = getattr(obj, attr)

        def timed(*args, _orig=orig, _key=key):
            if _key == "route":
                sec["h2d_bytes"] += args[1].nbytes + args[2].nbytes
            t0 = time.perf_counter()
            try:
                return _orig(*args)
            finally:
                sec[_key] += time.perf_counter() - t0

        saved.append((obj, attr, orig))
        setattr(obj, attr, timed)
    try:
        yield sec
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)


def main_path(tmp: str, card: str, cap: Capture) -> None:
    from sam2consensus_torch.kernels.build import all_kernels
    from sam2consensus_torch.utils.simulate import (SimSpec, sam_text,
                                                    simulate, write_sam)

    kernels = all_kernels()
    print("phase 6: formats fixtures through cli.main on CUDA")
    for fam in ("short", "longread", "adversarial"):
        with open(os.path.join(DATA, f"formats_{fam}.expected.fasta")) as fh:
            expected = fh.read()
        for ext in (".sam", ".sam.gz"):
            out = os.path.join(tmp, f"fmt_{fam}{ext}")
            sec = run_cli(["-i", os.path.join(DATA, f"formats_{fam}{ext}"),
                           "-o", out, "-p", "fixture"], None)
            same = read_dir(out) == expected
            print(f"  formats_{fam}{ext}: byte-identical={same} "
                  f"wall={sec:.3f}s")
            if not same:
                fail(f"formats_{fam}{ext} differs from its expected FASTA")

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
        ("ecoli_scale", None, ["-c", "0.25"]),
        ("amplicon_deep", None, ["-c", "0.25", "-m", "10"]),
    ]
    specs = {
        "ecoli_scale": SimSpec(n_contigs=1, contig_len=4_600_000,
                               n_reads=150000, read_len=100,
                               contig_len_jitter=0.0, seed=404,
                               contig_prefix="ecoli"),
        "amplicon_deep": SimSpec(n_contigs=1, contig_len=400, n_reads=100000,
                                 read_len=80, ins_read_rate=0.3,
                                 del_read_rate=0.2, seed=303,
                                 contig_prefix="amplicon"),
    }
    for name, text, flags in inputs:
        t0 = time.perf_counter()
        if text is None:
            text = simulate(specs[name])
        path = write_sam(text, os.path.join(tmp, f"{name}.sam"))
        print(f"  {name}: input {len(text) / 1e6:.1f} MB made in "
              f"{time.perf_counter() - t0:.1f}s")
        before = {k.name: k.launches for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        n_stats = len(cap.stats)
        with launch_events(kernels) as events, pileup_split() as split:
            wall = run_cli(["-i", path, "-o",
                            os.path.join(tmp, name + "_cuda"), *flags], None)
        st = cap.stats[n_stats]
        ev = {n: sum(s.elapsed_time(e) for s, e in pairs)
              for n, pairs in events.items()}
        launched = {k.name: k.launches - before[k.name] for k in kernels}
        mem = torch.cuda.max_memory_allocated() / 2**20
        cpu_wall = run_cli(["-i", path, "-o", os.path.join(tmp, name + "_cpu"),
                            *flags], "cpu")
        same = read_dir(os.path.join(tmp, name + "_cuda")) == \
            read_dir(os.path.join(tmp, name + "_cpu"))
        print(f"  {name} [{card}]: cuda wall={wall:.3f}s cpu wall="
              f"{cpu_wall:.3f}s byte-identical={same} reads="
              f"{st.reads_mapped} aligned_bases={st.aligned_bases} "
              f"max_memory_allocated={mem:.1f} MiB")
        for phase, names in (("decode", ()), ("pileup", ("pileup_rows",)),
                             ("tail", ("insertion_vote", "insertion_table")),
                             ("assemble", ())):
            kern = " ".join(f"{n}: {ev[n]:.3f} ms x{launched[n]}"
                            for n in names) or "no kernel"
            print(f"    {phase}: wall={st.extra[phase + '_sec']:.3f}s "
                  f"{kern}")
        copies = split["add"] - split["real_rows"] - split["pack_nibbles"] \
            - split["route"]
        print(f"    pileup split: real_rows={split['real_rows']:.4f}s "
              f"pack_nibbles={split['pack_nibbles']:.4f}s "
              f"h2d_copies={copies:.4f}s ({split['h2d_bytes']} B) "
              f"k1_route_enqueue={split['route']:.4f}s "
              f"sync_wait={split['sync']:.4f}s")
        if not same:
            fail(f"{name}: CUDA output differs from the CPU run")


# -- phase 8: no host synchronisation in the K1 and K2 routes ---------------
def sync_free(cap: Capture) -> None:
    from sam2consensus_torch.ops import insertion_kernel as ik
    from sam2consensus_torch.ops import pileup_kernel as pk

    _, (counts, starts, packed) = cap.calls["K1"]
    _, k2_args = cap.calls["K2"]
    scratch = torch.zeros_like(counts)
    torch.cuda.synchronize()
    for kid, route in (
            ("K1", lambda: pk.accumulate_rows(scratch, starts, packed)),
            ("K2", lambda: ik.vote_insertions_fused(*k2_args))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            route()
        except RuntimeError as exc:
            fail(f"the {kid} route synchronised with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  {kid} route under set_sync_debug_mode('error'): "
              f"no host synchronisation")


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
    from sam2consensus_torch.ops.pileup import scatter_segments_packed

    rows = []
    # K1 at the largest slab; the timed calls accumulate into scratch
    _, (counts, starts, packed) = cap.calls["K1"]
    n, wb = packed.shape
    want = scatter_segments_packed(torch.zeros_like(counts), starts, packed)
    err = compare("K1", pk.accumulate_rows(torch.zeros_like(counts), starts,
                                           packed), want)
    covered = int((want != 0).any(dim=1).sum())
    cells = int(want.sum())
    del want
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
                 route, plain, None, nbytes, 10 * cells,
                 f"rows={n} width={2 * wb} L={counts.shape[0]} "
                 f"covered={covered} cells={cells}"))

    # K2 at its largest table; the route starts from the events the tail
    # hands over, unsorted, as does the plain version
    _, args = cap.calls["K2"]
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
                 f"keys={kp} cols={cp} events={e} T={len(thr)}"))

    # K3 at its largest table (the wide-insertion route)
    _, (plan,) = cap.calls["K3"]
    ev = (plan.key, plan.cc // 6, plan.cc % 6)
    err = compare("K3", ik.build_insertion_table_kernel(plan),
                  build_insertion_table(plan.kp, plan.cp, *ev))
    ms = kernel_ms(ik.K3, lambda: ik.build_insertion_table_kernel(plan), 20)
    dev_ms = device_ms(ik.K3, lambda: ik.build_insertion_table_kernel(plan),
                       20)
    route = time_ms(lambda: ik.build_insertion_table_kernel(
        ik.plan_events(*ev, plan.kp, plan.cp)), 20)
    plain = time_ms(lambda: build_insertion_table(plan.kp, plan.cp, *ev), 5)
    lib = time_ms(lambda: index_put_table(plan.kp, plan.cp, *ev), 5)
    e = plan.key.numel()
    nbytes = e * 4 + (plan.kp + 1) * 4 + plan.kp * plan.cp * 6 * 4
    rows.append(("K3", ik.K3, "csrc/insertion.cu",
                 "sam2consensus_tpu/ops/pallas_insertion.py:75", err, ms,
                 dev_ms, route, plain, lib, nbytes, 4 * e,
                 f"keys={plan.kp} cols={plan.cp} events={e}"))

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
    with tempfile.TemporaryDirectory() as tmp:
        reports = ptxas_reports(tmp)
        try:
            ext = build.extension()
            print(f"  built {ext.__name__} from {list(build.SOURCES)} in "
                  f"{time.perf_counter() - t0:.1f}s")
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
             lambda plan: plan.kp * plan.cp + plan.key.numel()
             if plan.key.is_cuda else -1)
    orig_run = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig_run(self, *args, **kwargs)
        cap.stats.append(result.stats)
        return result

    TorchBackend.run = run

    kernels = build.all_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launches(kernels)
        main_path(tmp, card, cap)
        launches = {k.name: k.launches for k in kernels}
    print(f"main-path launches: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    print("phase 8: the K1 and K2 routes make no host synchronisation")
    sync_free(cap)

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
