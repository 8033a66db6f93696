#!/usr/bin/env python3
"""The cost constants of the port's device-side choices, measured on one
CUDA card.

    python3 perf/gate_constants.py [--reps 20] [--events 1e3,...]

Sets ``wire/codec.py`` ``WIRE_DEV_NS`` / ``WIRE_HOST_NS`` /
``ROWS_SAVED_BYTES_PER_CELL`` and ``backends/torch_backend.py``
``SPARSE_NS_PER_POS``, ``P5_HOST_NS_PER_CHAR`` and ``P5_DEV_NS_PER_CHAR``,
and checks the rule of ``--insertion-kernel auto`` (the kernels for every
tail on the card).  Inputs are made from seeds with numpy and
``utils.simulate``.

1. The row wire, on the slabs of ``ecoli_scale`` (4.6 Mbp, 150,000 x
   100 bp reads, seed 404, as ``chip_smoke.py`` makes it) decoded by the
   C++ decoder: per slab the host's canonicalise + encode
   (``wire.encode_wire_slab``, host clock), the device unpack
   (``wire.device.decode_slab`` on the lanes, CUDA events), the lanes'
   bytes against the packed5-equivalent and against the raw rows the
   stager ships, and the pileup's two strategies on the same rows (K1's
   route ``pack_codes`` + ``accumulate_rows`` against ``scatter_segments``).
   The ns a cell divide by the slab's real cells (rows x width);
   ROWS_SAVED_BYTES_PER_CELL is the raw rows' bytes less the lanes', over
   all slabs, a cell.
2. The tail's position head on the card at ``ecoli_scale``'s counts and
   at a sparse 40 Mbp genome (10,000 x 100 bp reads), T = 1 and 2: the
   dense, sparse and packed5 ``vote_packed_simple`` (CUDA events), the
   fetch of each buffer (host clock, pinned-free ``.cpu()`` as the tail
   does it) and the host expansion of the sparse and packed5 heads.
   SPARSE_NS_PER_POS is the sparse head's device time past dense plus
   its expansion, a position; P5_DEV_NS_PER_CHAR the packed5 head's
   device time past dense, and P5_HOST_NS_PER_CHAR its expansion, a
   character.
3. The insertion routes over event counts: the kernels (K2 at 512 sites x
   8 columns, K3 and the torch vote at 512 x 8192) against the torch
   scatter and vote on the same unsorted events, T = 1 (CUDA events,
   each route from the events to the voted symbols).  Prints whether the
   kernels won at every count at both shapes, and their smallest lead.

Every printed line carries the card's name and power limit; the last line
is one JSON object with every number.  Exits 1 without CUDA, and 1 if a
decode or a route differs from its reference.
"""

import argparse
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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event ms of ``fn()`` over ``reps`` calls after a warm-up."""
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


def host_sec(fn, reps: int) -> float:
    """Best host-clock seconds of ``fn()`` over ``reps`` calls."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def fail(msg: str) -> None:
    print("gate_constants FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def slabs_of(path: str) -> tuple:
    """The C++ decoder's slabs of a SAM file (real rows only) and the
    genome length."""
    from sam2consensus_torch.encoder.events import (GenomeLayout,
                                                    resolve_segment_width)
    from sam2consensus_torch.encoder.native_encoder import NativeReadEncoder
    from sam2consensus_torch.io.sam import ReadStream, opener, read_header
    from sam2consensus_torch.ops.pileup import real_rows

    out = []
    with opener(path, binary=True) as handle:
        contigs, _n, first = read_header(handle)
        stream = ReadStream(handle, first)
        layout = GenomeLayout(contigs)
        enc = NativeReadEncoder(layout, segment_width=resolve_segment_width(0))
        for batch in enc.encode_blocks_from(stream):
            for starts, codes in batch.buckets.values():
                n = real_rows(codes)
                if n:
                    out.append((np.ascontiguousarray(starts[:n]),
                                np.ascontiguousarray(codes[:n])))
    return out, layout.total_len


def wire_phase(slabs, total_len: int, reps: int, card: str) -> dict:
    from sam2consensus_torch.ops.pileup import (pack_codes, padded_total_len,
                                                scatter_segments)
    from sam2consensus_torch.ops.pileup_kernel import accumulate_rows
    from sam2consensus_torch.wire import WireAccount, encode_wire_slab
    from sam2consensus_torch.wire.codec import (canonicalize_rows,
                                                packed5_slab_bytes)
    from sam2consensus_torch.wire.device import decode_slab, wire_lane

    dev = torch.device("cuda")
    rows = []
    counts = torch.zeros((padded_total_len(total_len), 6), dtype=torch.int32,
                         device=dev)
    for i, (starts, codes) in enumerate(slabs):
        n, w = codes.shape
        acct = WireAccount()
        host = host_sec(lambda: encode_wire_slab("delta8", starts, codes,
                                                 acct), 3)
        slab = encode_wire_slab("delta8", starts, codes, WireAccount())
        raw = packed5_slab_bytes(n, w)
        if slab is None:
            print(f"  slab {i} [{card}]: {n} x {w}: delta8 refused")
            continue
        lanes = [torch.from_numpy(np.ascontiguousarray(wire_lane(a))).to(dev)
                 for a in slab.arrays()]
        meta = (slab.width, slab.sentinel,
                tuple(a.dtype == np.uint16 for a in
                      (slab.esc_delta, slab.trail, slab.esc_idx)))
        got_s, got_c = decode_slab(*lanes, *meta)
        want_s, want_c = canonicalize_rows(starts, codes)
        if not (np.array_equal(got_s.cpu().numpy(), want_s)
                and np.array_equal(got_c.cpu().numpy(), want_c)):
            fail(f"slab {i}: the device unpack differs from the rows")
        dev_ms = cuda_ms(lambda: decode_slab(*lanes, *meta), reps)
        st = torch.from_numpy(starts).to(dev)
        cd = torch.from_numpy(codes).to(dev)
        k1_ms = cuda_ms(lambda: accumulate_rows(counts, st, pack_codes(cd)),
                        reps)
        sc_ms = cuda_ms(lambda: scatter_segments(counts, st, cd, total_len),
                        reps)
        lane_bytes = sum(a.nbytes for a in slab.arrays())
        cells = n * w
        rows.append({"rows": n, "width": w, "cells": cells,
                     "lane_bytes": lane_bytes, "packed5_bytes": raw,
                     "raw_bytes": starts.nbytes + codes.nbytes,
                     "host_ns": host / cells * 1e9,
                     "dev_ms": dev_ms, "dev_ns": dev_ms * 1e6 / cells,
                     "k1_route_ms": k1_ms, "scatter_ms": sc_ms})
        print(f"  slab {i} [{card}]: {n} x {w}: lanes {lane_bytes} B "
              f"(packed5 {raw} B, raw rows {starts.nbytes + codes.nbytes} "
              f"B; saved {(raw - lane_bytes) / cells:.4f} B a cell) encode "
              f"{host * 1e3:.3f} ms ({host / cells * 1e9:.3f} ns a cell) "
              f"unpack {dev_ms:.4f} ms ({dev_ms * 1e6 / cells:.4f} ns a "
              f"cell); K1 route {k1_ms:.4f} ms, scatter {sc_ms:.4f} ms")
    if not rows:
        fail("no slab took delta8")
    med = {k: float(np.median([r[k] for r in rows]))
           for k in ("host_ns", "dev_ns", "dev_ms", "k1_route_ms",
                     "scatter_ms")}
    cells = sum(r["cells"] for r in rows)
    saved = sum(r["packed5_bytes"] - r["lane_bytes"] for r in rows) / cells
    rows_saved = sum(r["raw_bytes"] - r["lane_bytes"] for r in rows) / cells
    print(f"  wire [{card}]: medians over {len(rows)} slabs: encode "
          f"{med['host_ns']:.4f} ns a cell, unpack {med['dev_ns']:.4f} ns a "
          f"cell ({med['dev_ms']:.4f} ms a slab); saved {rows_saved:.4f} B a "
          f"cell against the raw rows, {saved:.4f} against packed5; K1 "
          f"route {med['k1_route_ms']:.4f} ms against scatter "
          f"{med['scatter_ms']:.4f} ms a slab")
    return {"slabs": rows, "median": med, "saved_bytes_per_cell": saved,
            "rows_saved_bytes_per_cell": rows_saved}


def head_phase(counts_by_name: dict, reps: int, card: str) -> dict:
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.ops import fused

    out = {}
    for name, (counts, aligned) in counts_by_name.items():
        length = counts.shape[0]
        offsets = torch.tensor([0, length], dtype=torch.int64,
                               device=counts.device)
        cap = fused.pad_cap(min(length, aligned) + 1)
        for thresholds in ([0.25], [0.25, 0.75]):
            t = len(thresholds)
            row = {}
            bufs = {}
            for enc, out_enc in (("dense", None), ("sparse", cap),
                                 ("packed5", "packed5")):
                def tail(out_enc=out_enc):
                    return fused.vote_packed_simple(counts, thresholds,
                                                    offsets, 1, 0, False,
                                                    out_enc)

                ms = cuda_ms(tail, reps)
                buf = tail()
                torch.cuda.synchronize()
                fetch = host_sec(lambda: buf.cpu(), 5)
                bufs[enc] = host = buf.cpu().numpy()
                expand = 0.0
                if enc == "sparse":
                    expand = host_sec(lambda: TorchBackend._expand_sparse(
                        host, t, length, cap), 3)
                    syms = TorchBackend._expand_sparse(host, t, length,
                                                       cap)[0]
                elif enc == "packed5":
                    expand = host_sec(lambda: TorchBackend._expand_packed5(
                        host, t, length), 3)
                    syms = TorchBackend._expand_packed5(host, t, length)[0]
                else:
                    syms = host[:t * length].reshape(t, length)
                bufs[enc + "_syms"] = syms
                row[enc] = {"dev_ms": ms, "fetch_ms": fetch * 1e3,
                            "expand_ms": expand * 1e3, "bytes": buf.numel()}
            for enc in ("sparse", "packed5"):
                if not np.array_equal(bufs[enc + "_syms"],
                                      bufs["dense_syms"]):
                    fail(f"{name} T={t}: the {enc} head expands to other "
                         f"symbols than dense")
            d, s, p = row["dense"], row["sparse"], row["packed5"]
            row["sparse_ns_per_pos"] = ((s["dev_ms"] - d["dev_ms"])
                                        + s["expand_ms"]) * 1e6 / length
            row["p5_dev_ns_per_char"] = (p["dev_ms"] - d["dev_ms"]) * 1e6 \
                / (t * length)
            row["p5_host_ns_per_char"] = p["expand_ms"] * 1e6 / (t * length)
            out[f"{name}_T{t}"] = row
            print(f"  head {name} L={length} T={t} cap={cap} [{card}]: "
                  + " ".join(f"{e}: device {row[e]['dev_ms']:.4f} ms fetch "
                             f"{row[e]['fetch_ms']:.4f} ms expand "
                             f"{row[e]['expand_ms']:.4f} ms "
                             f"({row[e]['bytes']} B);"
                             for e in ("dense", "sparse", "packed5"))
                  + f" sparse {row['sparse_ns_per_pos']:.4f} ns a position,"
                  f" packed5 device {row['p5_dev_ns_per_char']:.4f} + host "
                  f"{row['p5_host_ns_per_char']:.4f} ns a character")
    return out


def insertion_phase(events: list, reps: int, card: str) -> dict:
    from sam2consensus_torch.ops import fused
    from sam2consensus_torch.ops.insertion_kernel import (
        build_insertion_table_kernel, vote_insertions_fused)
    from sam2consensus_torch.ops.insertions import (build_insertion_table,
                                                    vote_insertions)

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    out = {}
    for kp, cp in ((512, 8), (512, 8192)):
        n_cols = torch.from_numpy(rng.integers(1, cp + 1, kp).astype(
            np.int32)).to(dev)
        for e in events:
            ev = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
                rng.integers(0, kp - 1, e), rng.integers(0, cp, e),
                rng.integers(0, 6, e))]
            site_cov = (torch.bincount(ev[0].long(), minlength=kp)
                        // max(1, cp // 4) + 1).int()
            thr = [0.25]

            def kernels():
                if cp <= fused.FUSED_VOTE_MAX_CP:
                    return vote_insertions_fused(*ev, site_cov, n_cols, cp,
                                                 thr)
                return vote_insertions(build_insertion_table_kernel(
                    *ev, kp, cp), site_cov, n_cols, thr)

            def scatter():
                return vote_insertions(build_insertion_table(kp, cp, *ev),
                                       site_cov, n_cols, thr)

            if not torch.equal(kernels(), scatter()):
                fail(f"insertion routes differ at {kp} x {cp}, {e} events")
            k_ms = cuda_ms(kernels, reps)
            s_ms = cuda_ms(scatter, reps)
            out[f"{kp}x{cp}_{e}"] = {"kernels_ms": k_ms, "scatter_ms": s_ms}
            print(f"  insertions {kp} x {cp}, {e} events [{card}]: kernels "
                  f"{k_ms:.4f} ms, scatter {s_ms:.4f} ms "
                  f"({s_ms / k_ms:.2f}x)")
    won = [e for e in events
           if all(out[f"{kp}x{cp}_{e}"]["kernels_ms"]
                  < out[f"{kp}x{cp}_{e}"]["scatter_ms"]
                  for kp, cp in ((512, 8), (512, 8192)))]
    lead = min(c["scatter_ms"] / c["kernels_ms"] for c in out.values())
    everywhere = won == events
    print(f"  insertion routes [{card}]: the kernels won at both shapes at "
          f"{won}; at every count: {everywhere}; smallest lead {lead:.2f}x")
    return {"cases": out, "won": won, "won_everywhere": everywhere,
            "smallest_lead": lead}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--events", default="1,10,100,1000,10000,100000,"
                                        "1000000,4000000,16000000,64000000")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA card")
    from sam2consensus_torch.kernels import build
    from sam2consensus_torch.ops.pileup import padded_total_len
    from sam2consensus_torch.ops.pileup_kernel import accumulate_rows
    from sam2consensus_torch.ops.pileup import pack_codes
    from sam2consensus_torch.utils.simulate import SimSpec, simulate, write_sam

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    build.extension()
    print(f"built the kernels in {time.perf_counter() - t0:.1f}s")
    result = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, spec in (
                ("ecoli_scale", SimSpec(n_contigs=1, contig_len=4_600_000,
                                        n_reads=150000, read_len=100,
                                        contig_len_jitter=0.0, seed=404,
                                        contig_prefix="ecoli")),
                ("sparse_40m", SimSpec(n_contigs=1, contig_len=40_000_000,
                                       n_reads=10000, read_len=100,
                                       contig_len_jitter=0.0, seed=405,
                                       contig_prefix="sparse"))):
            paths[name] = write_sam(simulate(spec),
                                    os.path.join(tmp, name + ".sam"))
        print(f"phase 1: the row wire at ecoli_scale's slabs [{card}]")
        slabs, total_len = slabs_of(paths["ecoli_scale"])
        result["wire"] = wire_phase(slabs, total_len, args.reps, card)
        print(f"phase 2: the tail's position head [{card}]")
        counts_by_name = {}
        for name in paths:
            slabs, total_len = slabs_of(paths[name])
            counts = torch.zeros((padded_total_len(total_len), 6),
                                 dtype=torch.int32, device="cuda")
            aligned = 0
            for starts, codes in slabs:
                cd = torch.from_numpy(codes).cuda()
                accumulate_rows(counts, torch.from_numpy(starts).cuda(),
                                pack_codes(cd))
                aligned += int((codes < 6).sum())
            counts_by_name[name] = (counts[:total_len], aligned)
        result["head"] = head_phase(counts_by_name, args.reps, card)
    print(f"phase 3: the insertion routes [{card}]")
    result["insertions"] = insertion_phase(
        [int(float(e)) for e in args.events.split(",")], max(5, args.reps // 4),
        card)
    heads = result["head"].values()
    result["constants"] = {
        "WIRE_HOST_NS": result["wire"]["median"]["host_ns"],
        "WIRE_DEV_NS": result["wire"]["median"]["dev_ns"],
        "ROWS_SAVED_BYTES_PER_CELL":
            result["wire"]["rows_saved_bytes_per_cell"],
        "SPARSE_NS_PER_POS": float(np.median(
            [h["sparse_ns_per_pos"] for h in heads])),
        "P5_DEV_NS_PER_CHAR": float(np.median(
            [h["p5_dev_ns_per_char"] for h in heads])),
        "P5_HOST_NS_PER_CHAR": float(np.median(
            [h["p5_host_ns_per_char"] for h in heads])),
        "INS_KERNELS_WON_EVERYWHERE":
            result["insertions"]["won_everywhere"]}
    print(f"constants [{card}]: {result['constants']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
