"""Command-line interface of the PyTorch port.

Drop-in compatible with the reference CLI (reference
``sam2consensus.py:87-104``): the eight flags ``-i -c -n -o -p -m -f -d``
keep their names, defaults and post-processing (``:108-138``), plus the
reference package's one-shot flags ``--py2-compat``, ``--permissive``,
``--segment-width``, ``--quiet``, ``--format``, ``--pileup``, ``--wire``,
``--insertion-kernel``, ``--decode-threads``, ``--decoder`` and
``--chunk-reads``, and its failure-handling flags ``--on-bad-record``,
``--max-bad-records``, ``--quarantine-out``, ``--checkpoint-dir``,
``--checkpoint-every``, ``--incremental``, ``--paranoid``, ``--retries``,
``--retry-backoff``, ``--on-device-error`` and ``--fault-inject`` (with
the environment settings ``S2C_FAULT_INJECT``, ``S2C_FAULT_SEED`` and
``S2C_QUARANTINE_MAX``; the reference's ``S2C_ON_DEVICE_ERROR`` and
``S2C_ATTEMPT_DEADLINE_S`` are not read), and its observability flags
``--trace-out``, ``--metrics-out`` (with the run manifest beside it),
``--json-metrics``, ``--profile-dir``, ``--log-level`` and
``--log-format`` (with ``S2C_TRACE_OUT`` and ``S2C_METRICS_OUT``);
the progress messages match.  ``--profile-dir`` wraps the run in
``torch.profiler`` (CPU activity, and on CUDA the card's: a profile of a
CUDA run that holds no CUDA kernel fails the run, naming CUPTI) and
writes its Chrome trace into the directory.  Input is SAM, gzip or
BGZF SAM, or BAM, sniffed by magic bytes
(``formats.open_alignment_input``).  The run goes
to CUDA and raises without it; ``main``'s ``device`` argument is the only
way to choose another device.

    python -m sam2consensus_torch.cli -i reads.bam -o out
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional

from .config import RunConfig, default_prefix, normalize_outfolder
from .io.fasta import write_outputs


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags (parsing copied from
    ``sam2consensus_tpu/cli.build_parser``)."""
    p = argparse.ArgumentParser(
        prog="sam2consensus-torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", "--input", dest="filename", required=True,
                   help="alignment file: SAM (optionally gzip/BGZF-"
                        "compressed) or BAM; need not be sorted "
                        "(format sniffed by magic bytes, see --format)")
    p.add_argument("-c", "--consensus-thresholds", dest="thresholds",
                   type=str, default="0.25",
                   help="comma-separated consensus threshold(s), e.g. 0.25,0.75; default=0.25")
    p.add_argument("-n", dest="n", type=int, default=0,
                   help="wrap FASTA sequences every n characters; default=no wrapping")
    p.add_argument("-o", "--outfolder", dest="outfolder", default="./",
                   help="output folder; default=current folder")
    p.add_argument("-p", "--prefix", dest="prefix", default="",
                   help="output name prefix; default=input filename without extension")
    p.add_argument("-m", "--min-depth", dest="min_depth", type=int, default=1,
                   help="minimum depth to call a consensus base; default=1")
    p.add_argument("-f", "--fill", dest="fill", default="-",
                   help="padding character for uncovered regions; default=-")
    # default=None is the "not supplied" sentinel resolved to 150 in
    # config_from_args, so --py2-compat can detect an explicit -d
    p.add_argument("-d", "--maxdel", dest="maxdel", type=int, default=None,
                   help="ignore deletions longer than this; default=150")
    p.add_argument("--segment-width", dest="segment_width", type=int,
                   default=0,
                   help="long-read segmented slab layout: reads whose "
                        "reference span exceeds this split into "
                        "W-wide segment rows (byte-exact; pileup "
                        "addition commutes) instead of widening the "
                        "slab bucket toward the span. 0 = auto "
                        "(4096), negative = off, positive = explicit "
                        "width (rounded up to a power of two)")
    p.add_argument("--py2-compat", action="store_true",
                   help="reproduce the reference's Python-2 maxdel quirk: any "
                        "explicit -d value disables deletion filtering")
    p.add_argument("--permissive", action="store_true",
                   help="skip-and-count malformed/out-of-contract records "
                        "instead of erroring like the reference")
    p.add_argument("--on-bad-record", dest="on_bad_record",
                   choices=["fail", "skip", "quarantine"], default="fail",
                   help="per-record malformation policy "
                        "(ingest/badrecords.py): fail (default; strict "
                        "reference semantics — first bad record kills the "
                        "job with a typed error carrying the file offset), "
                        "skip (drop + count as ingest/bad_records with a "
                        "per-reason taxonomy), quarantine (skip + write "
                        "the raw record and classified reason to a "
                        "bounded JSONL sidecar).  Identical consensus "
                        "bytes on every decode rung (serial/sharded/"
                        "streaming/BAM)")
    p.add_argument("--max-bad-records", dest="max_bad_records", default="",
                   help="error budget for tolerant modes: N (absolute — "
                        "the Nth bad record fails the job immediately) or "
                        "x%% (fraction of all records, checked at stream "
                        "end).  A blown budget is a clean job-level "
                        "failure with a precise summary (DATA resilience "
                        "class: never retried, never demotes a rung, "
                        "never pins a serve tenant)")
    p.add_argument("--quarantine-out", dest="quarantine_out", default=None,
                   help="quarantine sidecar path (s2c-quarantine/1 JSONL; "
                        "default <outfolder>/<prefix>_quarantine.jsonl); "
                        "bounded by S2C_QUARANTINE_MAX stored records")
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress output")
    p.add_argument("--json-metrics", dest="json_metrics", default=None,
                   help="write run metrics as JSON to this path "
                        "('-' = stdout)")
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="write a torch.profiler trace (CPU activity, and "
                        "the card's kernels on CUDA) to this directory")
    p.add_argument("--trace-out", dest="trace_out", default=None,
                   help="write a Chrome/Perfetto trace-event JSON of the "
                        "run's span tree (decode/stage/pileup dispatch/"
                        "accumulate/vote/insertions/render, device spans "
                        "closed under a device barrier) to this path; "
                        "open at https://ui.perfetto.dev")
    p.add_argument("--metrics-out", dest="metrics_out", default=None,
                   help="write the run's metrics registry (phase seconds, "
                        "wire bytes, dispatch decisions, histograms with "
                        "p50/p95/p99) as JSONL to this path")
    p.add_argument("--log-level", dest="log_level", default=None,
                   choices=["debug", "info", "warning", "error"],
                   help="enable package logging to stderr at this level")
    p.add_argument("--log-format", dest="log_format",
                   choices=["text", "json"], default="text",
                   help="log record shape: text (default) or json — "
                        "one JSON object per record carrying "
                        "job_id/tenant/rung and the innermost open "
                        "trace span as correlation IDs "
                        "(observability/telemetry.py; json implies "
                        "--log-level info when none is given)")
    # NOTE: long-form only — the reference already owns -f for --fill
    p.add_argument("--format", dest="input_format",
                   choices=["auto", "sam", "sam.gz", "bam"],
                   default="auto",
                   help="input format: auto (default) sniffs magic bytes "
                        "— plain SAM, gzip SAM, BGZF SAM (htslib .sam.gz; "
                        "inflated block-parallel on --decode-threads "
                        "workers) or BAM (block-parallel BGZF + binary "
                        "record decode, no SAM text materialized)")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None,
                   help="persist count-tensor checkpoints here and resume "
                        "from them if present")
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=2_000_000,
                   help="reads between checkpoint writes; default=2000000")
    p.add_argument("--incremental", action="store_true",
                   help="treat the checkpoint as an accumulated base: a new "
                        "input file ADDS its reads on top (and the final "
                        "state is persisted for the next shard) instead of "
                        "resuming the same file; requires --checkpoint-dir")
    p.add_argument("--paranoid", action="store_true",
                   help="re-validate device inputs and outputs every batch "
                        "(index bounds, symbol codes, count invariants)")
    p.add_argument("--pileup", choices=["auto", "pallas", "scatter", "host"],
                   default="auto",
                   help="pileup strategy: pallas (the CUDA histogram "
                        "kernel over the decoded rows), scatter (a torch "
                        "index_add_ of the rows' cells), host (count in "
                        "native code as the reads decode, ship the count "
                        "tensor once; the tail then runs where the "
                        "link-priced placement model says), or auto "
                        "(default: host counts on genomes up to the "
                        "bound measured on the card, else pallas; on "
                        "the CPU device, with the native library, host "
                        "counts at every genome size)")
    p.add_argument("--wire", choices=["auto", "packed5", "delta8"],
                   default="auto",
                   help="host->device row wire codec: packed5 (the rows "
                        "as decoded: int32 starts and the code bytes, "
                        "packed into nibbles on the card), delta8 "
                        "(delta-compressed starts with an escape lane, "
                        "2-bit ACGT planes and trailing-pad elision, "
                        "unpacked on the card into the same rows, so the "
                        "counts are identical), or auto (default: delta8 "
                        "on a link slower than the encode and unpack "
                        "cost, packed5 otherwise and on the CPU device)")
    p.add_argument("--insertion-kernel", dest="ins_kernel",
                   choices=["auto", "scatter", "pallas"], default="auto",
                   help="insertion table and vote on the card: the torch "
                        "scatter and vote, or the CUDA kernels (the fused "
                        "table + vote, or the table kernel and the torch "
                        "vote for wide tables). auto (default) takes the "
                        "kernels for a card tail inside the event-count "
                        "window measured on the card, scatter otherwise")
    p.add_argument("--decode-threads", dest="decode_threads", type=int,
                   default=1,
                   help="host worker threads (multi-core hosts; 0 = auto, "
                        "all cores): the shard-owned parallel SAM "
                        "decode (fused host counts, or slabs for the "
                        "device pileup), the BGZF block inflate AND the "
                        "native C++ tail vote's position ranges")
    p.add_argument("--decoder", choices=["auto", "native", "py"],
                   default="auto",
                   help="host SAM decode path: the C++ decoder when "
                        "available (auto), required (native), or pure "
                        "python (py)")
    p.add_argument("--chunk-reads", dest="chunk_reads", type=int,
                   default=262144,
                   help="reads per host->device batch of the python "
                        "decoder")
    # --- resilience (resilience/) ---
    p.add_argument("--retries", type=int, default=3,
                   help="transient device-failure re-attempts per dispatch "
                        "(RPC/link/timeout errors; exponential backoff + "
                        "seeded jitter); default=3")
    p.add_argument("--retry-backoff", dest="retry_backoff", type=float,
                   default=0.25,
                   help="base backoff seconds between retries (doubles per "
                        "attempt, capped at 8 s); default=0.25")
    p.add_argument("--on-device-error", dest="on_device_error",
                   choices=["fail", "retry", "fallback"], default="retry",
                   help="mid-run device failure policy: fail (raise "
                        "immediately), retry (transient errors retry, OOM "
                        "splits the slab, then raise), or fallback (after "
                        "retries, step down the degradation ladder — device "
                        "kernel -> scatter -> host pileup, device tail -> "
                        "host tail — writing an emergency checkpoint at "
                        "each demotion; counts are never lost). "
                        "default=retry")
    p.add_argument("--fault-inject", dest="fault_inject", default="",
                   help="deterministic fault injection for the device path "
                        "(tests/chaos): comma-separated "
                        "site:kind:after_n[:times] specs — sites "
                        "device_put|pileup_dispatch|accumulate|vote|"
                        "insertion_build|link_probe|wire_encode|"
                        "serve_decode_ahead|journal_write|job_hang, kinds "
                        "rpc|timeout|oom|"
                        "fatal|trace, after_n an integer call count or "
                        "pP probability (seeded by S2C_FAULT_SEED), times "
                        "an integer or inf. job_hang SLEEPS "
                        "S2C_FAULT_HANG_S before raising (a wedged "
                        "dispatch); serve_decode_ahead/journal_write are "
                        "serve-runner-scope sites. Env S2C_FAULT_INJECT "
                        "also activates it")
    return p


def config_from_args(args: argparse.Namespace) -> RunConfig:
    """Post-processing copied from ``sam2consensus_tpu/cli.config_from_args``
    for these flags, including the clean ``-c`` rejection and the up-front
    validation of the bad-record policy, ``--incremental`` and
    ``--fault-inject`` (the reference's ``config_from_args`` and
    ``main``)."""
    try:
        thresholds = [float(i) for i in args.thresholds.split(",")]
    except ValueError:
        raise SystemExit(
            f"error: could not parse consensus thresholds {args.thresholds!r}"
            " (expected comma-separated numbers, e.g. 0.25,0.75)") from None
    if not all(math.isfinite(t) and 0 < t <= 100 for t in thresholds):
        raise SystemExit(
            "error: consensus thresholds must be finite, > 0 and <= 100, "
            f"got {args.thresholds}")
    prefix = args.prefix if args.prefix != "" else default_prefix(args.filename)
    # --on-bad-record / --max-bad-records / --quarantine-out cross-checks
    # fail the run at parse time, through the one authority that API
    # callers meet at run start
    from .ingest.badrecords import policy_from_config

    try:
        policy_from_config(args)
    except ValueError as exc:
        raise SystemExit(f"error: {exc}") from None
    if args.incremental and not args.checkpoint_dir:
        raise SystemExit("--incremental requires --checkpoint-dir")
    if args.fault_inject:
        # a typo'd spec must fail the run, not silently inject nothing
        from .resilience.faultinject import parse_spec

        try:
            parse_spec(args.fault_inject)
        except ValueError as exc:
            raise SystemExit(f"error: {exc}") from None
    if args.maxdel is None:
        maxdel: Optional[int] = 150
    elif args.py2_compat:
        # quirk 1: a user-supplied -d under Python 2 compares as a string
        # and the gate is then always open
        maxdel = None
    else:
        maxdel = args.maxdel
    return RunConfig(
        thresholds=thresholds,
        min_depth=args.min_depth,
        fill=args.fill,
        maxdel=maxdel,
        prefix=prefix,
        nchar=args.n,
        outfolder=normalize_outfolder(args.outfolder),
        backend="torch",
        strict=not args.permissive,
        py2_compat=args.py2_compat,
        input_format=args.input_format,
        segment_width=args.segment_width,
        decoder=args.decoder,
        pileup=args.pileup,
        wire=args.wire,
        ins_kernel=args.ins_kernel,
        decode_threads=args.decode_threads,
        chunk_reads=args.chunk_reads,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        paranoid=args.paranoid,
        incremental=args.incremental,
        source_id=os.path.abspath(args.filename),
        retries=args.retries,
        retry_backoff=args.retry_backoff,
        on_device_error=args.on_device_error,
        fault_inject=args.fault_inject,
        on_bad_record=args.on_bad_record,
        max_bad_records=args.max_bad_records,
        quarantine_out=args.quarantine_out,
        json_metrics=args.json_metrics,
        profile_dir=args.profile_dir,
        trace_out=args.trace_out,
        metrics_out=args.metrics_out,
        log_level=args.log_level,
        log_format=args.log_format,
    )


def profiled(profile_dir: str, device, run):
    """``run()`` under ``torch.profiler`` (CPU activity, and the card's
    on a CUDA ``device``), its Chrome trace written into ``profile_dir``
    as ``<host>_<pid>.<ms>.pt.trace.json``; returns ``run()``'s result.
    A CUDA profile that holds no kernel event (CUPTI recorded nothing)
    raises instead of leaving an empty device profile."""
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        result = run()
        if cuda:
            torch.cuda.synchronize(device)
    name = (f"{socket.gethostname()}_{os.getpid()}."
            f"{int(time.time() * 1000)}.pt.trace.json")
    path = os.path.join(profile_dir, name)
    tmp = path + ".tmp"
    prof.export_chrome_trace(tmp)
    if cuda:
        with open(tmp, encoding="utf-8") as fh:
            events = json.load(fh).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in events):
            os.unlink(tmp)
            raise RuntimeError(
                "--profile-dir: the profiler recorded no CUDA kernel on "
                f"{torch.cuda.get_device_name(device)}: CUPTI tracing is "
                "unavailable or failed in this process; no device "
                "profile was written")
    os.replace(tmp, path)
    return result


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the CLI; ``device`` as in ``device.resolve_device`` (None = CUDA,
    raising without it)."""
    from .backends.torch_backend import TorchBackend
    from .config import resolve_decode_threads
    from .formats import open_alignment_input
    from .ingest.badrecords import BadRecordBudgetExceeded

    from . import observability

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    echo = (lambda *a, **k: None) if args.quiet else print
    observability.configure_logging(cfg.log_level, cfg.log_format)
    backend = TorchBackend(device)
    t0 = time.perf_counter()

    echo("\nProcessing file " + args.filename + ":\n")
    progress = [0]

    def on_lines(total: int) -> None:
        for k in range(progress[0] // 500000 + 1, total // 500000 + 1):
            echo(str(k * 500000) + " reads processed.")
        progress[0] = total

    # one open call for every container: format sniffed or forced, BGZF
    # blocks inflated on the decode-threads pool, BAM records decoded
    # binary; text SAM as bytes, which the native decoder parses raw
    ai = open_alignment_input(args.filename, cfg.input_format,
                              on_lines=on_lines,
                              threads=resolve_decode_threads(cfg))
    try:
        echo("SAM header processed, " + str(len(ai.contigs))
             + " references found.\n")
        stream = ai.stream
        if cfg.profile_dir:
            result = profiled(cfg.profile_dir, backend.device,
                              lambda: backend.run(ai.contigs, stream, cfg))
        else:
            result = backend.run(ai.contigs, stream, cfg)
    except BadRecordBudgetExceeded as exc:
        # rotten input: a clean job-level failure with the precise
        # summary (counts per reason + sidecar path), not a traceback
        s = exc.summary
        lines = [f"error: {exc}"]
        if s.get("reasons"):
            lines.append("  reasons: " + ", ".join(
                f"{why}={n}" for why, n in s["reasons"].items()))
        if s.get("sidecar"):
            lines.append(f"  quarantine sidecar: {s['sidecar']}")
        raise SystemExit("\n".join(lines)) from None
    finally:
        ai.close()
    echo("A total of " + str(stream.n_lines) + " reads were processed, out of "
         "which, " + str(result.stats.reads_mapped) + " reads were mapped.\n")
    n_bad = result.stats.extra.get("bad_records", 0)
    if n_bad:
        msg = (f"{n_bad} malformed record(s) "
               + ("quarantined" if cfg.on_bad_record == "quarantine"
                  else "skipped") + f" (--on-bad-record {cfg.on_bad_record})")
        sidecar = result.stats.extra.get("quarantine_sidecar")
        if sidecar:
            msg += f"; sidecar: {sidecar}"
        echo(msg + "\n")
    write_outputs(result.fastas, cfg.outfolder, cfg.prefix, cfg.nchar,
                  cfg.thresholds, echo=echo)
    echo("Done.\n")
    if cfg.metrics_out:
        from .observability.manifest import manifest_path_for

        echo("Run manifest written to "
             + manifest_path_for(cfg.metrics_out) + "\n")
    elapsed = time.perf_counter() - t0
    if cfg.json_metrics:
        from .observability.export import _json_default

        metrics = {
            "backend": cfg.backend,
            "reads_mapped": result.stats.reads_mapped,
            "reads_skipped": result.stats.reads_skipped,
            "aligned_bases": result.stats.aligned_bases,
            "consensus_bases": result.stats.consensus_bases,
            "references": len(ai.contigs),
            "references_with_output": len(result.fastas),
            "elapsed_sec": elapsed,
            "consensus_bases_per_sec":
                result.stats.consensus_bases / elapsed if elapsed > 0 else 0.0,
            **result.stats.extra,
        }
        blob = json.dumps(metrics, default=_json_default)
        if cfg.json_metrics == "-":
            print(blob)
        else:
            with open(cfg.json_metrics, "w") as fh:
                fh.write(blob + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
