#!/usr/bin/env python3
"""Host counts against the device pileup on one CUDA card, by genome
length and depth.

    python3 perf/host_gate_sweep.py [--lengths 1000,...] [--depths 10,...]
                                    [--max-bases 1e8] [--orders sorted,random]
                                    [--nolib-lengths ...] [--nolib-depths ...]
                                    [--thread-inputs 4600000x50,...]
                                    [--threads 1,4,8] [--reps 3] [--out DIR]

Sets the port's host-counts gate and its placement costs from the card
(``ops/pileup.py`` ``HOST_PILEUP_NATIVE_BOUNDS`` and
``HOST_PILEUP_BOUNDS``; ``backends/torch_backend.py`` ``TAIL_*``).
Each input is one contig with 100 bp reads at uniform positions
(coordinate-sorted, as ``samtools sort`` leaves an alignment, or in random
order), 1% substituted, with Phred 20-40 quality strings, made with numpy
from a seed.  Each run is ``cli.main`` on the card, in turns, ``--reps``
times each; walls are host clock around a run ending in a synchronize
(medians).

1. The grid: every length at every depth up to ``--max-bases`` aligned
   bases, both orders, in the modes

   * ``pallas``: the device pileup (K1) and the device tail;
   * ``host``: host counts in the C++ decode pass, tail where the
     placement model puts it;
   * at the first depth only, ``host-cuda`` and ``host-cpu``: host counts
     with the tail forced onto the card (the counts upload and the fused
     tail) or onto the host (the native vote), by replacing the placement.

   Host counts cost the host about 2 ns an aligned base; the device
   pileup's costs past the decode are mostly fixed, and the host's
   count slows as the genome outgrows the host's caches.  So the gate is
   a table of genome lengths, each with the largest SAM body size at
   which ``host`` beat ``pallas`` in every order (below the smallest
   losing one at that length, and no larger than a shorter length's).
   The printed table is this run's; ``--combine LOG ...`` prints the one
   of several runs' logs together (a case wins when, in every order, the
   median over the runs of host's wall less pallas's is below zero).
2. Without the native library (``native.load`` replaced by one that
   finds none: the Python decoder, the numpy count walk, the tail on the
   card), ``pallas`` against ``host`` at ``--nolib-lengths`` x
   ``--nolib-depths``, sorted order: the other table.
3. The parallel decoder: each ``--thread-inputs`` entry (``LENGTHxDEPTH``,
   sorted) under ``pallas`` (slab mode) and ``host`` (fused mode) at each
   of ``--threads``: walls, decode and summed worker seconds, shards.
4. The placement model's rates (when the grid holds 4.6 Mbp, sorted, at
   the first depth): the link probe's round trip and slower direction,
   the native vote's ns a position (T = 1 and 2, one thread), the plain
   PyTorch vote's positions a second on the CPU, and the fused count's
   extra ns an aligned base (serial decode with and without it); the
   device tail's own seconds (``host-cuda``'s tail at the smallest
   genome); and the probe's own wall in a fresh process (three
   processes, each timing its first ``probe_link()`` after its CUDA
   context is up).

The last line is one JSON object with every number; each printed line
carries the card's name and power limit.  Exits 1 without CUDA, and 1 if
any two modes' outputs differ.
"""

import argparse
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: mode -> (--pileup, forced tail side or None)
MODES = {"pallas": ("pallas", None), "host": ("host", None),
         "host-cuda": ("host", "device"), "host-cpu": ("host", "cpu")}
READ_LEN = 100


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def header_line(length: int) -> bytes:
    return f"@SQ\tSN:g\tLN:{length}\n".encode()


def write_input(path: str, length: int, depth: int, seed: int,
                sort: bool = True) -> int:
    """One ``length``-base contig and ``length * depth / 100`` reads of
    100 bases at uniform positions (in coordinate order when ``sort``),
    1% substituted, with Phred 20-40 qualities; POS zero-padded to nine
    digits so every line has one width.  Returns the read count."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, length).astype(np.uint8)
    n = max(1, length * depth // READ_LEN)
    starts = rng.integers(0, length - READ_LEN + 1, n)
    if sort:
        starts.sort()
    head = b"r\t0\tg\t"
    mid = b"\t60\t100M\t*\t0\t0\t"
    width = len(head) + 9 + len(mid) + 2 * READ_LEN + 2
    with open(path, "wb") as fh:
        fh.write(header_line(length))
        for lo in range(0, n, 1 << 20):
            m = min(n - lo, 1 << 20)
            pos = starts[lo:lo + m]
            codes = genome[pos[:, None] + np.arange(READ_LEN)]
            sub = rng.random(codes.shape) < 0.01
            codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
            lines = np.empty((m, width), np.uint8)
            at = 0
            for part in (head, "pos", mid, "seq", b"\t", "qual", b"\n"):
                if part == "pos":           # 1-based POS, nine digits
                    p = pos + 1
                    for d in range(8, -1, -1):
                        lines[:, at + d] = 48 + p % 10
                        p //= 10
                    at += 9
                elif part == "seq":
                    lines[:, at:at + READ_LEN] = acgt[codes]
                    at += READ_LEN
                elif part == "qual":        # '5'..'I': Phred 20-40
                    lines[:, at:at + READ_LEN] = rng.integers(
                        53, 74, (m, READ_LEN), dtype=np.uint8)
                    at += READ_LEN
                else:
                    lines[:, at:at + len(part)] = np.frombuffer(part,
                                                                np.uint8)
                    at += len(part)
            fh.write(lines.tobytes())
    return n


@contextlib.contextmanager
def forced_tail(side):
    """Replace the tail placement of host-counts runs by ``side``."""
    from sam2consensus_torch.backends.torch_backend import TorchBackend

    orig = TorchBackend._place_host_tail
    if side is not None:
        TorchBackend._place_host_tail = \
            lambda self, *a, **k: {"chosen": side, "forced": side}
    try:
        yield
    finally:
        TorchBackend._place_host_tail = orig


@contextlib.contextmanager
def without_library():
    """Runs as on a host where the native library does not load."""
    from sam2consensus_torch import native

    orig = native.load
    native.load = lambda: None
    try:
        yield
    finally:
        native.load = orig


def run(path: str, mode: str, out: str, extra_args=()) -> float:
    from sam2consensus_torch import cli

    pileup, side = MODES[mode]
    with forced_tail(side):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-i", path, "-o", out, "--pileup", pileup,
                      *extra_args], device=None)
        torch.cuda.synchronize()
        return time.perf_counter() - t0


def median(xs):
    return float(np.median(xs))


def read_out(path: str) -> str:
    return "".join(open(os.path.join(path, f)).read()
                   for f in sorted(os.listdir(path)))


def sweep_case(tmp, path, modes, reps, stats, card, label, extra_args=()):
    """``modes`` in turns, ``reps`` times each, on one input: a row of
    medians and each run's numbers.  None when the outputs differ."""
    walls = {m: [] for m in modes}
    tails = {m: [] for m in modes}
    last = {}
    for rep in range(reps):
        for mode in modes[rep % len(modes):] + modes[:rep % len(modes)]:
            walls[mode].append(run(path, mode, os.path.join(
                tmp, f"o_{mode}"), extra_args))
            last[mode] = stats[-1].extra
            tails[mode].append(stats[-1].extra["tail_sec"])
    outs = {m: read_out(os.path.join(tmp, f"o_{m}")) for m in modes}
    if len(set(outs.values())) != 1:
        print(f"  {label}: OUTPUTS DIFFER across modes", file=sys.stderr)
        return None
    row = {}
    for mode in modes:
        e = last[mode]
        row[mode] = {
            "wall": median(walls[mode]), "walls": walls[mode],
            "decode": e["decode_sec"], "pileup": e["pileup_sec"],
            "tail": median(tails[mode]), "tails": tails[mode],
            "assemble": e["assemble_sec"],
            "decoder": e.get("decoder"),
            "tail_device": e.get("tail_device"),
            "uploads": e.get("counts_uploads"),
            "dtype": (e.get("pileup") or {}).get("host_wire_dtype"),
            "shards": e.get("ingest_shards", 0),
            "worker_sec": e.get("ingest_worker_sec", 0.0),
            "placement": {k: v for k, v in
                          e.get("tail_placement", {}).items()
                          if k in ("chosen", "cpu_sec", "chip_sec")}}
        print(f"  {label} {mode:9s} [{card}]: wall "
              f"{row[mode]['wall']:.4f}s (runs "
              f"{', '.join(f'{w:.4f}' for w in walls[mode])}) "
              f"decode {e['decode_sec']:.4f}s ({e.get('decoder')}) pileup "
              f"{e['pileup_sec']:.4f}s tail {row[mode]['tail']:.4f}s "
              f"({e.get('tail_device')}, uploads "
              f"{e.get('counts_uploads')}, {row[mode]['dtype']}) "
              f"assemble {e['assemble_sec']:.4f}s")
    return row


def make(tmp, length, depth, seed, order, card):
    path = os.path.join(tmp, f"g{length}_{depth}x_{order}.sam")
    t0 = time.perf_counter()
    n = write_input(path, length, depth, seed, sort=order == "sorted")
    body = os.path.getsize(path) - len(header_line(length))
    print(f"L={length} {depth}x {order}: {n} reads, {body} B of body, "
          f"made in {time.perf_counter() - t0:.1f}s [{card}]")
    return path, n, body


def bounds(rows, mode="host"):
    """The gate's table from the rows of one or more runs.  A case (a
    length at a depth) is a host win when, in every read order, the
    median over the runs of ``mode``'s wall less ``pallas``'s is below
    zero.  For each length in turn: the largest body size that won,
    below the smallest losing one at that length and no larger than the
    bound of a shorter length that lost somewhere; the table ends before
    the first length with no win, and keeps an entry only where the next
    one allows fewer bytes.
    Returns ``(table, cases)``, each case ``[length, depth, body bytes,
    won, {order: median margin in seconds}]``."""
    margins, body = {}, {}
    for r in rows:
        key = (r["length"], r["depth"])
        margins.setdefault(key, {}).setdefault(r["order"], []).append(
            r[mode]["wall"] - r["pallas"]["wall"])
        body[key] = r["body_bytes"]
    cases = {k: {o: median(v) for o, v in m.items()}
             for k, m in margins.items()}
    won = {k: all(v < 0 for v in m.values()) for k, m in cases.items()}
    table, crossed = [], []
    for length in sorted({k[0] for k in cases}):
        at = [(body[k], won[k]) for k in cases if k[0] == length]
        loss = min((b for b, w in at if not w), default=None)
        wins = [b for b, w in at if w and (loss is None or b < loss)]
        if not wins:
            break
        # a longer genome is allowed no more bytes than a shorter one
        # whose crossover was measured
        table.append([length, min([max(wins)] + crossed)])
        if loss is not None:
            crossed.append(table[-1][1])
    table = [e for i, e in enumerate(table)
             if i + 1 == len(table) or table[i + 1][1] < e[1]]
    return table, sorted([list(k) + [body[k], won[k], cases[k]]
                          for k in cases])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lengths", default="1000,3000,10000,30000,100000,"
                                         "300000,1000000,4600000")
    ap.add_argument("--depths", default="10,100,300,1000,3000,10000")
    ap.add_argument("--max-bases", type=float, default=1e8)
    ap.add_argument("--orders", default="sorted,random")
    ap.add_argument("--nolib-lengths", default="10000,100000,300000")
    ap.add_argument("--nolib-depths", default="10,100")
    ap.add_argument("--thread-inputs", default="4600000x50,40000000x10")
    ap.add_argument("--threads", default="1,4,8")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="scratch directory (default: a temporary one)")
    ap.add_argument("--combine", nargs="+", metavar="LOG",
                    help="print the gate tables of these runs' logs "
                         "together and exit (no card needed)")
    args = ap.parse_args()
    if args.combine:
        return combine(args.combine)
    if not torch.cuda.is_available():
        print("host_gate_sweep: no CUDA card", file=sys.stderr)
        return 1
    from sam2consensus_torch.backends.torch_backend import TorchBackend

    card = card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{os.cpu_count()} host cores")
    lengths = [int(x) for x in args.lengths.split(",")]
    depths = [int(x) for x in args.depths.split(",")]
    orders = args.orders.split(",")
    stats, accs = [], []
    orig_run, orig_acc = TorchBackend.run, TorchBackend._make_accumulator

    def run_hook(self, *a, **k):
        result = orig_run(self, *a, **k)
        stats.append(result.stats)
        return result

    def acc_hook(self, *a, **k):
        acc = orig_acc(self, *a, **k)
        if hasattr(acc, "counts_host"):     # the last host counts
            accs[:] = [acc]
        return acc

    TorchBackend.run = run_hook
    TorchBackend._make_accumulator = acc_hook
    report = {"card": card}
    seed = args.seed
    with tempfile.TemporaryDirectory(dir=args.out) as tmp:
        # 1. the grid
        rows = []
        warm = True
        for depth in depths:
            modes = list(MODES) if depth == depths[0] else ["pallas", "host"]
            for length in lengths:
                if length * depth > args.max_bases:
                    continue
                for order in orders:
                    seed += 1
                    path, n, body = make(tmp, length, depth, seed, order,
                                         card)
                    if warm:            # builds, kernel loads, the probe
                        for mode in MODES:
                            run(path, mode, os.path.join(tmp, "warm"))
                        warm = False
                    row = sweep_case(tmp, path, modes, args.reps, stats,
                                     card, f"L={length} {depth}x {order}")
                    if row is None:
                        return 1
                    row.update(length=length, depth=depth, order=order,
                               reads=n, body_bytes=body,
                               aligned_bases=stats[-1].aligned_bases)
                    rows.append(row)
                    if length == 4_600_000 and order == "sorted" \
                            and depth == depths[0]:
                        report["rates"] = rates(path, accs[0], card)
                    os.unlink(path)
        report["rows"] = rows
        # 2. without the native library
        nolib = []
        for depth in [int(x) for x in args.nolib_depths.split(",") if x]:
            for length in [int(x) for x in args.nolib_lengths.split(",")
                           if x]:
                seed += 1
                path, n, body = make(tmp, length, depth, seed, "sorted",
                                     card)
                with without_library():
                    row = sweep_case(tmp, path, ["pallas", "host"],
                                     args.reps, stats, card,
                                     f"no library L={length} {depth}x")
                if row is None:
                    return 1
                row.update(length=length, depth=depth, order="sorted",
                           reads=n, body_bytes=body,
                           aligned_bases=stats[-1].aligned_bases)
                nolib.append(row)
                os.unlink(path)
        report["nolib_rows"] = nolib
        # 3. the parallel decoder
        threads = []
        for spec in [x for x in args.thread_inputs.split(",") if x]:
            length, depth = (int(v) for v in spec.split("x"))
            seed += 1
            path, n, body = make(tmp, length, depth, seed, "sorted", card)
            for mode in ("pallas", "host"):
                for t in args.threads.split(","):
                    row = sweep_case(
                        tmp, path, [mode], args.reps, stats, card,
                        f"L={length} {depth}x --decode-threads {t}",
                        ["--decode-threads", t])
                    r = row[mode]
                    threads.append({
                        "length": length, "depth": depth, "mode": mode,
                        "threads": int(t), "wall": r["wall"],
                        "walls": r["walls"], "decode": r["decode"],
                        "worker_sec": r["worker_sec"],
                        "shards": r["shards"], "pileup": r["pileup"],
                        "tail": r["tail"]})
                    print(f"    threads={t} {mode}: shards {r['shards']} "
                          f"worker_sec {r['worker_sec']:.4f}s [{card}]")
            os.unlink(path)
        report["thread_rows"] = threads
    if "rates" not in report:
        print(f"no 4.6 Mbp sorted case at the first depth: no rates "
              f"[{card}]")
    report["probe_fresh_sec"] = probe_fresh(card)

    # the device tail's own cost: its seconds at the smallest genome, where
    # the counts upload and the fetch are a few kB
    small = [r for r in rows if r["length"] == min(lengths)
             and "host-cuda" in r]
    report["tail_fixed_sec"] = median([t for r in small
                                       for t in r["host-cuda"]["tails"]])
    print(f"device tail at L={min(lengths)} [{card}]: "
          f"{report['tail_fixed_sec'] * 1e3:.3f} ms (median of "
          f"{sum(len(r['host-cuda']['tails']) for r in small)} runs)")
    for key, got_rows in (("native_gate", rows), ("nolib_gate", nolib)):
        table, cases = bounds(got_rows)
        report[key] = {"table": table, "cases": cases}
        print(f"{key} [{card}]: (length, largest body in bytes) at which "
              f"host beat pallas in every order: {table}")
        print_cases(cases, card)
    print(json.dumps(report))
    return 0


def print_cases(cases, card: str) -> None:
    for length, depth, body, won, margin in cases:
        ms = ", ".join(f"{o} {m * 1e3:+.1f} ms"
                       for o, m in sorted(margin.items()))
        print(f"    L={length} {depth}x {body} B: "
              f"{'host' if won else 'pallas'} (host - pallas: {ms}) "
              f"[{card}]")


def combine(logs) -> int:
    """The gate tables of several runs together, from the JSON object on
    the last line of each log."""
    reports = [json.loads(open(p).read().strip().splitlines()[-1])
               for p in logs]
    for key in ("rows", "nolib_rows"):
        rows = [r for rep in reports for r in rep.get(key, [])]
        if rows:
            table, cases = bounds(rows)
            print(f"{key} of {len(reports)} runs ({', '.join(logs)}): "
                  f"{table}")
            print_cases(cases, reports[0]["card"])
    return 0


def probe_fresh(card: str) -> list:
    """The link probe's wall in fresh processes: each brings its CUDA
    context up (as a run has by then), then times its first
    ``probe_link()``, the import included."""
    code = ("import time, torch\n"
            "torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
            "t0 = time.perf_counter()\n"
            "from sam2consensus_torch.utils.linkprobe import probe_link\n"
            "p = probe_link()\n"
            "print(time.perf_counter() - t0, p.rt_sec, p.bps)\n")
    out = []
    for _ in range(3):
        got = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout.split()
        sec, rt, bps = (float(v) for v in got[-3:])
        out.append(sec)
        print(f"  probe in a fresh process [{card}]: {sec * 1e3:.3f} ms "
              f"(round trip {rt * 1e3:.4f} ms, {bps / 1e9:.3f} GB/s)")
    return out


def rates(path: str, acc, card: str) -> dict:
    """The placement model's rates on this card and host."""
    from sam2consensus_torch.encoder.events import GenomeLayout
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder
    from sam2consensus_torch.io.sam import ReadStream, opener, read_header
    from sam2consensus_torch.ops import fused
    from sam2consensus_torch.ops.vote import vote_positions_native
    from sam2consensus_torch.utils.linkprobe import probe_link

    out = {}
    p = probe_link()
    out["link"] = {"rt_sec": p.rt_sec, "h2d_bps": p.h2d_bps,
                   "d2h_bps": p.d2h_bps, "bps": p.bps}
    print(f"  link probe [{card}]: round trip {p.rt_sec * 1e3:.4f} ms, H2D "
          f"{p.h2d_bps / 1e9:.3f} GB/s, D2H {p.d2h_bps / 1e9:.3f} GB/s")
    counts = acc.counts_host()
    length = len(counts)
    vote = {}
    for t in (1, 2):
        thr = [0.25, 0.75][:t]
        sec = min(_sec(lambda: vote_positions_native(counts, thr, 1,
                                                     threads=1))
                  for _ in range(3))
        vote[t] = sec / length * 1e9
        print(f"  native vote [{card}]: L={length} T={t}: {sec * 1e3:.3f} "
              f"ms, {vote[t]:.4f} ns a position")
    out["native_ns"] = vote[1]
    out["native_thr_ns"] = vote[2] - vote[1]
    part = torch.from_numpy(counts[:1_000_000])
    offsets = torch.tensor([0, len(part)])
    sec = min(_sec(lambda: fused.vote_packed_simple(part, [0.25], offsets,
                                                    1, 0, False))
              for _ in range(3))
    out["cpu_mpos_s"] = len(part) / sec / 1e6
    print(f"  plain PyTorch vote on the CPU [{card}]: L={len(part)} T=1: "
          f"{sec * 1e3:.3f} ms, {out['cpu_mpos_s']:.3f} M positions a second")
    decode = {}
    for fused_count in (False, True):
        best, bases = None, 0
        for _ in range(3):
            with opener(path, binary=True) as handle:
                contigs, _n, first = read_header(handle)
                layout = GenomeLayout(contigs)
                into = np.zeros((layout.total_len, 6), np.int32) \
                    if fused_count else None
                enc = NativeReadEncoder(layout, accumulate_into=into)
                stream = ReadStream(handle, first)
                t0 = time.perf_counter()
                bases = sum(b.n_events for b in enc.encode_blocks_from(stream))
                sec = time.perf_counter() - t0
            best = sec if best is None else min(best, sec)
        decode[fused_count] = (best, bases)
        print(f"  serial C++ decode [{card}]: fused count={fused_count}: "
              f"{best:.4f}s for {bases} aligned bases")
    count_ns = (decode[True][0] - decode[False][0]) / decode[True][1] * 1e9
    out["fused_count_ns_per_base"] = count_ns
    print(f"  fused count [{card}]: {count_ns:.4f} ns an aligned base")
    return out


def _sec(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())
