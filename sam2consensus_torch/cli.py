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
way to choose another device.  ``serve`` runs many inputs through one
warm server (:func:`serve_main`, ``serve.ServeRunner``): a queue of
``-i`` inputs, one of N fleet workers on a shared ``--journal``
(``--worker-id``), or streaming sessions behind ``--ingest-port``.

    python -m sam2consensus_torch.cli -i reads.bam -o out
    python -m sam2consensus_torch.cli serve -i a.sam -i b.bam -o out
    python -m sam2consensus_torch.cli serve -i a.sam -i b.sam -o out \
        --journal J --worker-id w0
    python -m sam2consensus_torch.cli serve --ingest-port 0 --journal J
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
    p.add_argument("--pileup",
                   choices=["auto", "pallas", "mxu", "scatter", "host"],
                   default="auto",
                   help="pileup strategy: pallas (the CUDA histogram "
                        "kernel over the decoded rows), mxu (one-hot "
                        "matrix products over position tiles, a cuBLAS "
                        "product a chunk of tiles, and a diagonal fold; "
                        "falls back to scatter on a slab of skewed "
                        "coverage), scatter (a torch "
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
    p.add_argument("--shard-mode", dest="shard_mode",
                   choices=["auto", "dp", "sp", "dpsp"], default="auto",
                   help="sharded accumulator layout: full-length local "
                        "counts + reduce-scatter (dp), position-sharded "
                        "blocks with halo exchange for huge genomes (sp), "
                        "or the dp x sp product on a 2-D mesh (dpsp; "
                        "needs both mesh axes > 1); auto prices all "
                        "three from the first decoded slab's shape and "
                        "the mesh (sam2consensus_torch/parallel/auto.py)")
    p.add_argument("--shards", type=int, default=0,
                   help="shards of the count tensor over the mesh's "
                        "devices (every CUDA device of the host, or the "
                        "caller's mesh_devices); 0 = all of them")
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
        shards=args.shards,
        shard_mode=args.shard_mode,
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


def build_serve_parser() -> argparse.ArgumentParser:
    """The ``serve`` subcommand's surface: many ``-i`` inputs sharing one
    flag set, run through a persistent warm backend (``serve/``).  Every
    flag of ``sam2consensus_tpu/cli.build_serve_parser`` parses, with
    its dest, default and choices, and runs."""
    p = argparse.ArgumentParser(
        prog="sam2consensus-torch serve",
        description="persistent multi-job serving: one warm torch "
                    "backend on one card across every input (prewarm + "
                    "cross-job pipelining); outputs per job like N "
                    "one-shot runs")
    p.add_argument("-i", "--input", dest="inputs", action="append",
                   default=None,
                   help="SAM input (repeatable; one job per input, run "
                        "in order).  Required unless --ingest-port "
                        "starts a streaming-session server instead")
    p.add_argument("-c", "--consensus-thresholds", dest="thresholds",
                   type=str, default="0.25")
    p.add_argument("-n", dest="n", type=int, default=0)
    p.add_argument("-o", "--outfolder", dest="outfolder", default="./")
    p.add_argument("-m", "--min-depth", dest="min_depth", type=int,
                   default=1)
    p.add_argument("-f", "--fill", dest="fill", default="-")
    p.add_argument("-d", "--maxdel", dest="maxdel", type=int, default=None)
    p.add_argument("--py2-compat", action="store_true")
    p.add_argument("--permissive", action="store_true")
    p.add_argument("--on-bad-record", dest="on_bad_record",
                   choices=["fail", "skip", "quarantine"], default="fail",
                   help="per-record malformation policy shared by every "
                        "job (see the one-shot CLI); a blown "
                        "--max-bad-records budget fails ONLY that job "
                        "(DATA class: no retry, no rung demotion, no "
                        "tenant pinning) while the queue keeps draining "
                        "warm")
    p.add_argument("--max-bad-records", dest="max_bad_records", default="",
                   help="per-job bad-record error budget: N or x%%")
    p.add_argument("--quarantine-out", dest="quarantine_out", default=None,
                   help="quarantine sidecar base path: job k writes "
                        "<base>.job<k>.jsonl (default per-job "
                        "<outfolder>/<prefix>_quarantine.jsonl)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--format", dest="input_format",
                   choices=["auto", "sam", "sam.gz", "bam"],
                   default="auto")
    p.add_argument("--segment-width", dest="segment_width", type=int,
                   default=0)
    p.add_argument("--pileup",
                   choices=["auto", "pallas", "mxu", "scatter", "host"],
                   default="auto")
    p.add_argument("--wire", choices=["auto", "packed5", "delta8"],
                   default="auto")
    p.add_argument("--insertion-kernel", dest="ins_kernel",
                   choices=["auto", "scatter", "pallas"], default="auto")
    p.add_argument("--decode-threads", dest="decode_threads", type=int,
                   default=None,
                   help="as the one-shot flag (0 = all cores); not given, "
                        "a plain SAM file of 2 MiB or more decodes on "
                        "min(4, (usable CPUs - 2) // jobs decoding at "
                        "once) shard workers, serial below 2")
    p.add_argument("--decoder", choices=["auto", "native", "py"],
                   default="auto")
    p.add_argument("--shard-mode", dest="shard_mode",
                   choices=["auto", "dp", "sp", "dpsp"], default="auto")
    p.add_argument("--shards", type=int, default=0)
    p.add_argument("--chunk-reads", dest="chunk_reads", type=int,
                   default=262144)
    p.add_argument("--retries", type=int, default=3)
    p.add_argument("--retry-backoff", dest="retry_backoff", type=float,
                   default=0.25)
    p.add_argument("--on-device-error", dest="on_device_error",
                   choices=["fail", "retry", "fallback"], default="retry")
    p.add_argument("--fault-inject", dest="fault_inject", default="")
    p.add_argument("--log-level", dest="log_level", default=None,
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--metrics-out", dest="metrics_out", default=None,
                   help="per-job metrics JSONL base path: job k writes "
                        "<base>.job<k>.jsonl (+ its .manifest.json)")
    p.add_argument("--trace-out", dest="trace_out", default=None,
                   help="per-job trace base path: job k writes "
                        "<base>.job<k>.json")
    p.add_argument("--prewarm", choices=["auto", "off"], default="auto",
                   help="load the kernels and run the layout's "
                        "canonical slab shapes through the pileup route "
                        "behind the first job's decode (auto; engages "
                        "for explicitly device-pinned pileups — "
                        "--pileup scatter/pallas — since --pileup auto "
                        "may route host-side where there is nothing to "
                        "warm)")
    p.add_argument("--no-decode-ahead", dest="decode_ahead",
                   action="store_false",
                   help="disable cross-job pipelining (job N+1's host "
                        "decode normally overlaps job N's device work)")
    # --- continuous batching (serve/scheduler.py) ---
    p.add_argument("--batch", dest="batch", default="off",
                   help="continuous batching: pack up to N eligible "
                        "small jobs (--pileup auto/scatter, genome <= "
                        "S2C_BATCH_MAX_MEMBER_LEN positions) into "
                        "shared slabs riding ONE device dispatch "
                        "sequence, with per-job count partitions "
                        "extracted for byte-identical per-job outputs. "
                        "off (default) | auto (tuned batch size, env "
                        "S2C_BATCH_AUTO_JOBS) | N.  A tenant burning "
                        "its --slo objective flushes the filling batch "
                        "immediately (latency over occupancy); any "
                        "fault inside a packed phase demotes only that "
                        "batch back to the serial path")
    p.add_argument("--batch-window", dest="batch_window", type=float,
                   default=None,
                   help="max milliseconds a filling batch waits for "
                        "more eligible jobs before flushing (default "
                        "50; live-arrival queues only — a pre-planned "
                        "queue arrives at once)")
    # --- cohort serving (serve/cohort.py) ---
    p.add_argument("--cohort-manifest", dest="cohort_manifest",
                   default=None,
                   help="cohort mode: stream EVERY sample named by "
                        "this manifest (a directory of .sam/.sam.gz/"
                        ".bam files, a text file of paths/globs, or a "
                        ".jsonl object-store-style listing with a "
                        "'path' per row) through packed shared-panel "
                        "waves — one submission, not N.  Implies "
                        "--batch auto unless --batch is set; the "
                        "shared reference layout is planned once and "
                        "reused every wave, wave size follows the "
                        "learned packed rate under --mem-budget/"
                        "--max-queue caps, and --journal resumes an "
                        "interrupted cohort at its last committed "
                        "wave.  Does not compose with -i/--input or "
                        "--ingest-port")
    p.add_argument("--cohort-wave", dest="cohort_wave", type=int,
                   default=0,
                   help="fixed cohort wave size (members per packed "
                        "wave); 0 (default) sizes waves from the "
                        "learned cohort_jobs_per_sec rate card x "
                        "S2C_COHORT_WAVE_SEC, clamped to the length/"
                        "queue/memory caps")
    p.add_argument("--cohort-summary", dest="cohort_summary",
                   default=None,
                   help="write the cohort summary JSON (waves, "
                        "panel-plan reuse evidence, per-wave "
                        "cohort_wave decisions, per-position call "
                        "concordance) to this path")
    # --- incremental consensus (serve/countcache.py) ---
    p.add_argument("--count-cache", dest="count_cache", default=None,
                   help="per-reference count cache byte budget (e.g. "
                        "'512M', '2G'; 'off' disables; env "
                        "S2C_COUNT_CACHE).  Keeps each reference "
                        "set's accumulated count tensor + insertion "
                        "log resident across jobs (LRU under the "
                        "budget) so an --incremental job against a "
                        "warm reference pays only delta decode + "
                        "scatter + re-vote — byte-identical to a cold "
                        "run over the concatenated inputs")
    p.add_argument("--incremental", action="store_true",
                   help="treat every input as an incremental shard "
                        "against its reference's warm count state "
                        "(requires --count-cache): outputs cover ALL "
                        "reads absorbed for that reference so far, "
                        "and re-submitting an already-absorbed input "
                        "adds nothing (keyed by absolute path)")
    # --- survivability (serve/{journal,health,admission}.py) ---
    p.add_argument("--journal", dest="journal", default=None,
                   help="crash-safe job journal directory: every job's "
                        "lifecycle is durably recorded (atomic "
                        "tmp+rename segments) and each job gets a "
                        "per-job checkpoint home there, so a killed "
                        "server restarted with the SAME command resumes "
                        "the queue — committed jobs are skipped by "
                        "output fingerprint, the in-flight job resumes "
                        "from its checkpoint; zero lost, zero "
                        "duplicated jobs.  Implies --no-decode-ahead "
                        "(checkpoints need serial decode).  Outputs are "
                        "written per job at commit time, not at queue "
                        "end")
    p.add_argument("--worker-id", dest="worker_id", default="",
                   help="fleet mode (sam2consensus_torch/serve/fleet.py; "
                        "requires --journal): join the journal as a "
                        "work-stealing worker under this UNIQUE id — "
                        "N processes launched with the same --journal "
                        "and the same inputs share the queue: each job "
                        "is claimed (atomic journal event, first "
                        "writer wins) before it runs, leases carry a "
                        "TTL renewed while the worker lives, and a "
                        "dead/frozen worker's expired lease is reaped "
                        "by a peer which re-claims the job from its "
                        "checkpoint — zero lost, zero duplicated.  Two "
                        "live processes sharing one id is operator "
                        "error (the id IS the lease identity)")
    p.add_argument("--lease-ttl", dest="lease_ttl", type=float,
                   default=None,
                   help="fleet lease TTL seconds (env S2C_LEASE_TTL, "
                        "default 30): a worker silent this long is "
                        "presumed dead and its in-flight job becomes "
                        "re-claimable; recovery latency is ~TTL + one "
                        "reap-scan period, so smaller = faster "
                        "takeover, larger = more tolerance for "
                        "stop-the-world pauses.  Renewals ride the "
                        "0.1 s watchdog poll at half-TTL margin")
    p.add_argument("--verify-outputs", dest="verify_outputs",
                   choices=["fast", "full"], default="fast",
                   help="journal-resume output verification: fast "
                        "(default) accepts a committed file whose "
                        "size+mtime still match the commit-time stat "
                        "and re-hashes only on drift — resume over a "
                        "large committed queue is O(stat); full "
                        "re-hashes every committed output "
                        "unconditionally")
    # --- streaming sessions (serve/{session,stream_server}.py) ---
    p.add_argument("--ingest-port", dest="ingest_port", type=int,
                   default=None,
                   help="streaming-session mode (requires --journal; "
                        "serve/stream_server.py): serve the live wave "
                        "ingest API on 127.0.0.1:PORT (0 = ephemeral, "
                        "logged at startup) instead of draining a "
                        "fixed -i queue.  Sessions are journal "
                        "entities under claim/lease semantics: a "
                        "killed worker's open sessions are stolen by "
                        "a peer sharing the journal, replaying every "
                        "journaled-but-unabsorbed wave — zero lost, "
                        "zero double-counted reads")
    p.add_argument("--stability-waves", dest="stability_waves",
                   type=int, default=3,
                   help="consecutive waves the consensus digest must "
                        "survive unchanged before the session emits "
                        "its stability verdict (the read-until "
                        "signal; default 3, must be >= 1)")
    p.add_argument("--revote-debounce", dest="revote_debounce",
                   type=float, default=0.0,
                   help="seconds to coalesce arriving waves before "
                        "re-voting (default 0 = re-vote on every "
                        "wave; must be >= 0).  Debounced waves are "
                        "journaled + ACKed 202 immediately and "
                        "absorbed in arrival order on the cadence")
    p.add_argument("--ingest-max-body", dest="ingest_max_body",
                   type=int, default=None,
                   help="max wave body bytes the ingest endpoint "
                        "accepts (default 64 MiB); larger uploads "
                        "answer 413 before buffering")
    p.add_argument("--ingest-timeout", dest="ingest_timeout",
                   type=float, default=None,
                   help="per-request socket deadline seconds on the "
                        "ingest endpoint (default 10); a client "
                        "silent this long mid-body answers 408 and "
                        "frees the handler thread")
    p.add_argument("--ingest-max-pending", dest="ingest_max_pending",
                   type=int, default=None,
                   help="per-session journaled-but-unabsorbed wave "
                        "bound (default 64): a session at its bound "
                        "answers 429 + Retry-After (admission "
                        "backpressure) instead of buffering without "
                        "limit")
    p.add_argument("--job-timeout", dest="job_timeout", type=float,
                   default=None,
                   help="per-job wall-clock deadline in seconds "
                        "(env S2C_JOB_TIMEOUT): a job that overruns is "
                        "abandoned and failed (under --on-device-error "
                        "fallback it retries once on the ladder's host "
                        "rung) while the server keeps draining the "
                        "queue")
    p.add_argument("--stall-timeout", dest="stall_timeout", type=float,
                   default=None,
                   help="hung-dispatch watchdog in seconds (env "
                        "S2C_STALL_TIMEOUT): fail the in-flight job "
                        "when no device dispatch completes for this "
                        "long — catches a wedged dispatch or a "
                        "stuck decode thread long before a generous "
                        "--job-timeout would.  Set it ABOVE the "
                        "worst-case cold kernel build (a build is "
                        "silence to this watchdog; the build directory "
                        "and --prewarm keep that off warm servers)")
    p.add_argument("--checkpoint-every", dest="checkpoint_every",
                   type=int, default=2_000_000,
                   help="journal mode: reads between a job's periodic "
                        "checkpoint writes (bounds how much of the "
                        "in-flight job a kill -9 re-runs); "
                        "default=2000000")
    p.add_argument("--max-queue", dest="max_queue", type=int, default=0,
                   help="admission control: max jobs admitted per "
                        "submission (0 = unbounded); overflow is "
                        "rejected with reason queue_full "
                        "(serve/admission_* counters)")
    p.add_argument("--tenant", dest="tenant", default="",
                   help="tenant label for every job of this invocation "
                        "(admission quotas + degraded-tenant isolation; "
                        "the API sets it per JobSpec)")
    p.add_argument("--tenant-quota", dest="tenant_quota", type=int,
                   default=0,
                   help="admission control: max admitted jobs per "
                        "tenant per submission (0 = unbounded)")
    p.add_argument("--mem-budget", dest="mem_budget", default=None,
                   help="capacity-priced admission (observability/"
                        "memplane.py): a job whose predicted peak "
                        "host+device bytes (from its header-probed "
                        "genome length, threshold grid and slab "
                        "geometry) exceeds this budget is shed with "
                        "reason 'capacity' instead of OOMing the warm "
                        "server.  Size grammar like --count-cache "
                        "('4G', '512M'); 'off'/unset disables; env "
                        "S2C_MEM_BUDGET")
    p.add_argument("--health-out", dest="health_out", default=None,
                   help="write an atomic health/readiness snapshot "
                        "(queue depth, in-flight job, heartbeat age, "
                        "tenant rungs, journal position, SLO burn) to "
                        "this path — rewritten at every job boundary "
                        "AND on the watchdog heartbeat cadence, so it "
                        "stays fresh while a job hangs")
    # --- telemetry plane (observability/telemetry.py) ---
    p.add_argument("--telemetry-out", dest="telemetry_out", default=None,
                   help="write the server-lifetime OpenMetrics/"
                        "Prometheus text exposition (folded per-job "
                        "counters, per-tenant SLO summaries, "
                        "heartbeat-aged liveness gauges) to this path, "
                        "rewritten atomically on the telemetry "
                        "cadence — scrapeable with a plain file read, "
                        "no agent required")
    p.add_argument("--telemetry-port", dest="telemetry_port", type=int,
                   default=None,
                   help="serve /metrics (OpenMetrics text) and "
                        "/healthz (the health snapshot JSON) on "
                        "127.0.0.1:PORT via a stdlib-only endpoint "
                        "(0 = ephemeral port, logged at startup); "
                        "scrapes compute fresh heartbeat ages per "
                        "request")
    p.add_argument("--telemetry-interval", dest="telemetry_interval",
                   type=float, default=None,
                   help="seconds between exposition/health rewrites "
                        "(default 2.0; env S2C_TELEMETRY_INTERVAL); "
                        "the same cadence drives the mid-hang health "
                        "refresh")
    p.add_argument("--slo", dest="slo", default=None,
                   help="per-phase latency objectives, e.g. "
                        "'e2e=5s,queue=1s' (phases: queue|queue_wait, "
                        "decode, dispatch, vote, e2e; values in s or "
                        "ms; env S2C_SLO).  Breaches burn "
                        "slo/violations/<tenant>/<phase> counters "
                        "surfaced in the exposition, the health "
                        "snapshot and each job's manifest serve.slo "
                        "verdict")
    p.add_argument("--profile-capture-dir", dest="profile_capture_dir",
                   default=None,
                   help="where on-demand profiler captures land "
                        "(default: the journal dir, else next to "
                        "--telemetry-out).  Arm a capture with "
                        "SIGUSR2 or by touching <dir>/capture_profile "
                        "— a bounded torch.profiler window on a CUDA "
                        "server (pure-Python span/stack dump on cpu) "
                        "taken WHILE the current job runs, no restart "
                        "needed")
    p.add_argument("--log-format", dest="log_format",
                   choices=["text", "json"], default="text",
                   help="log record shape (see the one-shot CLI); "
                        "json records carry job_id/tenant/rung/span "
                        "correlation IDs across every serve thread")
    # shared-flag defaults config_from_args expects but serve never
    # exposes (one-shot-only features)
    p.set_defaults(backend="torch", prefix="", profile_dir=None,
                   json_metrics=None, checkpoint_dir=None,
                   paranoid=False, filename="")
    return p


def validate_mesh_shards(shards: int, pileup: str, device=None,
                         mesh_devices=None) -> None:
    """The reference's up-front ``--shards`` checks, before any input is
    read or a server warms: ``--pileup host`` does not compose, and more
    shards than the mesh's devices (``backends.torch_backend.
    mesh_device_list``, times the world size of an initialised process
    group) is the ``MeshCapacityError`` text.  Exits."""
    if pileup == "host" and shards > 1:
        raise SystemExit("--pileup host accumulates on the single host; "
                         "it does not compose with --shards")
    if shards > 1:
        from .backends.torch_backend import mesh_device_list
        from .device import resolve_device
        from .parallel.mesh import (MeshCapacityError, available_devices,
                                    validate_shards)

        devices = mesh_device_list(resolve_device(device), mesh_devices)
        try:
            validate_shards(shards, n_available=available_devices(devices),
                            pileup=pileup)
        except MeshCapacityError as exc:
            raise SystemExit(f"error: {exc}") from None


def _serve_sessions(args: argparse.Namespace, echo, device=None,
                    mesh_devices=None) -> int:
    """``serve --journal DIR --ingest-port P``: host streaming consensus
    sessions behind the live ingest endpoint (``serve.stream_server``)
    on ``device`` until told to stop (SIGTERM / SIGINT) — there is no
    fixed queue to drain.  Open sessions survive the stop: their
    journaled waves are replayed by whichever worker (this one
    restarted, or a fleet peer) claims them next."""
    import copy
    import logging
    import signal

    from .serve import ServeRunner
    from .serve.session import DEFAULT_MAX_PENDING, SessionManager
    from .serve.stream_server import (DEFAULT_MAX_BODY,
                                      DEFAULT_TIMEOUT_S, IngestServer)

    base_args = copy.copy(args)
    base_args.filename = ""             # per-session prefix, not per-job
    base_args.prefix = ""
    base_cfg = config_from_args(base_args)

    runner = ServeRunner(prewarm=args.prewarm,
                         decode_ahead=args.decode_ahead, echo=echo,
                         journal_dir=args.journal,
                         job_timeout=args.job_timeout,
                         stall_timeout=args.stall_timeout,
                         max_queue=args.max_queue,
                         tenant_quota=args.tenant_quota,
                         health_out=args.health_out,
                         fault_inject=args.fault_inject,
                         telemetry_out=args.telemetry_out,
                         telemetry_port=args.telemetry_port,
                         telemetry_interval=args.telemetry_interval,
                         slo=args.slo,
                         profile_capture_dir=args.profile_capture_dir,
                         mem_budget=args.mem_budget,
                         worker_id=args.worker_id,
                         lease_ttl=args.lease_ttl,
                         verify_outputs=args.verify_outputs,
                         device=device, mesh_devices=mesh_devices)
    server = None
    try:
        manager = SessionManager(
            runner, base_cfg,
            stability_waves=args.stability_waves,
            revote_debounce=args.revote_debounce,
            max_pending=(args.ingest_max_pending
                         if args.ingest_max_pending is not None
                         else DEFAULT_MAX_PENDING))
        runner.sessions = manager       # health snapshot `sessions` gate
        server = IngestServer(
            manager, port=args.ingest_port,
            max_body=(args.ingest_max_body
                      if args.ingest_max_body is not None
                      else DEFAULT_MAX_BODY),
            timeout=(args.ingest_timeout
                     if args.ingest_timeout is not None
                     else DEFAULT_TIMEOUT_S))
        echo(f"\nStreaming sessions on 127.0.0.1:{server.port} "
             f"[{runner.backend.device}]"
             + (f" as fleet worker {args.worker_id!r}"
                if args.worker_id else "")
             + f" (journal: {runner.journal.root})\n")
        stop = {"flag": False}

        def _stop(signum, frame):
            stop["flag"] = True

        prev = signal.signal(signal.SIGTERM, _stop)
        try:
            while not stop["flag"]:
                try:
                    manager.tick()
                    runner.telemetry_tick()
                except Exception as exc:  # the loop must outlive anything
                    logging.getLogger("sam2consensus_torch.serve").warning(
                        "session tick failed (%s: %s)",
                        type(exc).__name__, exc)
                time.sleep(0.1)
        except KeyboardInterrupt:
            pass
        finally:
            signal.signal(signal.SIGTERM, prev)
    finally:
        if server is not None:
            server.close()
        runner.close()
    echo(f"Ingest stopped; {len(manager.sessions)} open session(s) "
         f"remain journaled for takeover.\n")
    return 0


def _serve_cohort(args: argparse.Namespace, echo, device=None,
                  mesh_devices=None) -> int:
    """``serve --cohort-manifest M``: stream one manifest's samples
    through packed shared-panel waves (``serve.cohort.CohortRunner``) on
    ``device``; ``--batch off`` means ``auto`` here.  Exit 0 iff every
    sample succeeded (resumed samples count as succeeded — the journal
    already proved their outputs)."""
    import copy
    import sys as _sys

    from .serve import ServeRunner
    from .serve.cohort import CohortRunner, load_manifest

    try:
        paths = load_manifest(args.cohort_manifest)
    except (OSError, ValueError) as exc:
        raise SystemExit(f"error: {exc}") from None
    base_args = copy.copy(args)
    base_args.filename = ""             # per-sample prefix, not per-job
    base_args.prefix = ""
    base_cfg = config_from_args(base_args)

    runner = ServeRunner(prewarm=args.prewarm,
                         decode_ahead=args.decode_ahead, echo=echo,
                         journal_dir=args.journal,
                         job_timeout=args.job_timeout,
                         stall_timeout=args.stall_timeout,
                         max_queue=args.max_queue,
                         tenant_quota=args.tenant_quota,
                         health_out=args.health_out,
                         fault_inject=args.fault_inject,
                         telemetry_out=args.telemetry_out,
                         telemetry_port=args.telemetry_port,
                         telemetry_interval=args.telemetry_interval,
                         slo=args.slo,
                         profile_capture_dir=args.profile_capture_dir,
                         batch=args.batch if args.batch != "off"
                         else "auto",
                         batch_window=args.batch_window,
                         mem_budget=args.mem_budget,
                         verify_outputs=args.verify_outputs,
                         device=device, mesh_devices=mesh_devices)
    echo(f"\nCohort of {len(paths)} sample(s) from "
         f"{args.cohort_manifest} [{runner.backend.device}]"
         + (f" (kernel build: {runner.cache_dir})" if runner.cache_dir
            else "")
         + (f" (journal: {runner.journal.root})" if runner.journal
            else "") + "\n")
    try:
        cohort = CohortRunner(runner, paths, base_cfg,
                              wave=args.cohort_wave,
                              tenant=args.tenant,
                              summary_out=args.cohort_summary,
                              echo=echo)
        summary = cohort.run()
    finally:
        runner.close()
    for res in cohort.results:
        if not res.ok:
            print(f"job {res.job_id} FAILED: {res.error}",
                  file=_sys.stderr)
    conc = summary.get("concordance") or {}
    echo(f"Cohort done: {summary['samples_ok']} ok + "
         f"{summary['resumed']} resumed / {summary['samples_total']} "
         f"sample(s) in {summary['waves']} wave(s), "
         f"{summary['jobs_per_sec']} jobs/s"
         + (f", mean concordance {conc['mean_concordance']}"
            if conc else "") + ".\n")
    if args.cohort_summary:
        echo(f"Cohort summary at {args.cohort_summary}")
    return 1 if summary["failed"] else 0


def serve_main(argv: List[str], device=None, mesh_devices=None) -> int:
    """``serve -i a.sam -i b.bam [...]``: run every input through one
    warm server (``serve.ServeRunner``) on ``device`` (as in
    ``device.resolve_device``: None = CUDA, raising without it), with
    ``mesh_devices`` the device list of sharded jobs
    (``backends.torch_backend.mesh_device_list``); exit 0 iff every job
    succeeded.  ``--shards`` is checked against that list before the
    server warms (:func:`validate_mesh_shards`).  ``--worker-id`` joins
    a fleet on the shared ``--journal``; ``--ingest-port`` serves
    streaming sessions instead of a queue (:func:`_serve_sessions`),
    ``--cohort-manifest`` a cohort (:func:`_serve_cohort`).  The
    reference's ``serve_main``, with its up-front checks (``--slo``,
    ``--batch``, ``--count-cache``, ``--mem-budget``, ``--incremental``
    without the cache or under ``--journal``, the fleet's, the sessions'
    and the cohort's cross-checks, ``--fault-inject``, an input or a
    session port)."""
    import copy

    from . import observability
    from .serve import JobSpec, ServeRunner

    args = build_serve_parser().parse_args(argv)
    echo = (lambda *a, **k: None) if args.quiet else print
    observability.configure_logging(args.log_level, args.log_format)
    # the one-shot run's --shards checks, before the server warms (a
    # late failure on the first admitted job is a worse error surface)
    validate_mesh_shards(args.shards, args.pileup, device, mesh_devices)
    # a typo'd SLO objective must fail the server start, not silently
    # never fire (same up-front discipline as --fault-inject)
    from .observability.telemetry import parse_slo
    from .serve.countcache import parse_budget
    from .serve.scheduler import parse_batch_mode

    try:
        parse_slo(args.slo)
    except ValueError as exc:
        raise SystemExit(f"error: {exc}") from None
    try:
        parse_batch_mode(args.batch)
    except ValueError as exc:
        raise SystemExit(f"error: {exc}") from None
    try:
        cache_on = parse_budget(
            args.count_cache if args.count_cache is not None
            else os.environ.get("S2C_COUNT_CACHE")) > 0
    except ValueError as exc:
        raise SystemExit(f"error: {exc}") from None
    try:
        parse_budget(args.mem_budget if args.mem_budget is not None
                     else os.environ.get("S2C_MEM_BUDGET"))
    except ValueError as exc:
        raise SystemExit("error: " + str(exc).replace(
            "--count-cache", "--mem-budget")) from None
    if args.incremental and not cache_on:
        raise SystemExit(
            "error: --incremental serve jobs need --count-cache SIZE "
            "(or S2C_COUNT_CACHE) — the warm per-reference count state "
            "lives there")
    if args.incremental and args.journal:
        raise SystemExit(
            "error: --incremental does not compose with --journal "
            "(the journal injects per-job checkpoint homes, a second "
            "source of resumable state)")
    if args.worker_id and not args.journal:
        raise SystemExit(
            "error: --worker-id requires --journal (the shared "
            "journal IS the fleet's work-stealing queue)")
    if args.worker_id and args.batch != "off":
        raise SystemExit(
            "error: --worker-id does not compose with --batch "
            "(packed batches would need batch-level leases; the "
            "fleet IS the parallelism)")
    if args.worker_id and cache_on:
        raise SystemExit(
            "error: --worker-id does not compose with --count-cache "
            "(incremental jobs are rejected on a journaled server, "
            "so the cache would be a silent no-op)")
    if args.lease_ttl is not None and not args.lease_ttl > 0:
        raise SystemExit("error: --lease-ttl must be > 0")
    # --- streaming-session cross-checks: a typo'd session flag must
    # fail the server start, not surface as a deep mid-wave error
    session_mode = args.ingest_port is not None
    # --- cohort cross-checks (serve/cohort.py): same fail-the-start
    # discipline — a cohort flag combination that cannot work must
    # reject before the server warms, not mid-manifest
    cohort_mode = args.cohort_manifest is not None
    if cohort_mode and session_mode:
        raise SystemExit(
            "error: --cohort-manifest does not compose with "
            "--ingest-port (a cohort is a pre-planned manifest; "
            "sessions are a live wave stream)")
    if cohort_mode and args.inputs:
        raise SystemExit(
            "error: --cohort-manifest does not compose with "
            "-i/--input (the manifest IS the input list — one "
            "submission for the whole cohort)")
    if cohort_mode and args.worker_id:
        raise SystemExit(
            "error: --cohort-manifest does not compose with "
            "--worker-id (cohort waves ride packed batches, which "
            "fleet workers exclude; shard cohorts by manifest "
            "instead)")
    if cohort_mode and args.incremental:
        raise SystemExit(
            "error: --cohort-manifest does not compose with "
            "--incremental (incremental jobs are ineligible for "
            "packing, so every wave would serialize)")
    if cohort_mode and args.batch.strip().lower() in ("0", "1"):
        raise SystemExit(
            "error: --cohort-manifest needs packed waves: use "
            "--batch auto or --batch N with N >= 2 (or omit --batch "
            "— cohort mode defaults it to auto)")
    if args.cohort_wave < 0 or args.cohort_wave == 1:
        raise SystemExit(
            "error: --cohort-wave must be 0 (rate-sized) or >= 2 "
            "(a wave of one cannot pack)")
    if session_mode and not args.journal:
        raise SystemExit(
            "error: --ingest-port requires --journal (sessions are "
            "journal entities — the durable wave intent log IS the "
            "crash-safety story)")
    if session_mode and args.inputs:
        raise SystemExit(
            "error: --ingest-port does not compose with -i/--input "
            "(waves arrive over the ingest API, not a fixed queue)")
    if not session_mode and not cohort_mode and not args.inputs:
        raise SystemExit(
            "error: at least one -i/--input is required (or "
            "--ingest-port to serve streaming sessions, or "
            "--cohort-manifest to serve a cohort)")
    if session_mode and args.batch != "off":
        raise SystemExit(
            "error: --ingest-port does not compose with --batch "
            "(waves of one session must absorb serially in arrival "
            "order; packed batches would break the count-bank rule)")
    if session_mode and args.incremental:
        raise SystemExit(
            "error: --ingest-port does not compose with --incremental "
            "(sessions ARE the incremental path — per-wave "
            "checkpoint-seeded absorption, journal-fenced)")
    if session_mode and cache_on:
        raise SystemExit(
            "error: --ingest-port does not compose with --count-cache "
            "(session count state lives in per-session checkpoint "
            "homes under the journal, not the LRU cache)")
    if args.stability_waves < 1:
        raise SystemExit("error: --stability-waves must be >= 1")
    if args.revote_debounce < 0:
        raise SystemExit("error: --revote-debounce must be >= 0")
    if args.ingest_max_body is not None and args.ingest_max_body <= 0:
        raise SystemExit("error: --ingest-max-body must be > 0")
    if args.ingest_timeout is not None and not args.ingest_timeout > 0:
        raise SystemExit("error: --ingest-timeout must be > 0")
    if args.ingest_max_pending is not None \
            and args.ingest_max_pending < 1:
        raise SystemExit("error: --ingest-max-pending must be >= 1")
    if args.fault_inject:
        from .resilience.faultinject import parse_spec

        try:
            parse_spec(args.fault_inject)
        except ValueError as exc:
            raise SystemExit(f"error: {exc}") from None

    if session_mode:
        return _serve_sessions(args, echo, device=device,
                               mesh_devices=mesh_devices)
    if cohort_mode:
        return _serve_cohort(args, echo, device=device,
                             mesh_devices=mesh_devices)

    specs = []
    for k, path in enumerate(args.inputs):
        job_args = copy.copy(args)
        job_args.filename = path
        job_args.prefix = ""            # per-job default: input basename
        if args.metrics_out:
            job_args.metrics_out = f"{args.metrics_out}.job{k}.jsonl"
        if args.trace_out:
            job_args.trace_out = f"{args.trace_out}.job{k}.json"
        if args.quarantine_out:
            # per-job sidecars, same .jobN discipline as metrics/trace
            # (N jobs sharing one sidecar would interleave evidence)
            job_args.quarantine_out = f"{args.quarantine_out}.job{k}.jsonl"
        cfg = config_from_args(job_args)
        if cfg.on_bad_record == "quarantine" and not cfg.quarantine_out:
            # the DEFAULT sidecar derives from prefix = input basename,
            # so two jobs over the same upload would clobber each
            # other's evidence — stamp the job index into the default
            cfg.quarantine_out = os.path.join(
                cfg.outfolder,
                f"{cfg.prefix}_quarantine.job{k}.jsonl")
        specs.append(JobSpec(filename=path, config=cfg,
                             job_id=f"job{k}:{os.path.basename(path)}",
                             tenant=args.tenant))

    runner = ServeRunner(prewarm=args.prewarm,
                         decode_ahead=args.decode_ahead, echo=echo,
                         journal_dir=args.journal,
                         job_timeout=args.job_timeout,
                         stall_timeout=args.stall_timeout,
                         max_queue=args.max_queue,
                         tenant_quota=args.tenant_quota,
                         health_out=args.health_out,
                         fault_inject=args.fault_inject,
                         telemetry_out=args.telemetry_out,
                         telemetry_port=args.telemetry_port,
                         telemetry_interval=args.telemetry_interval,
                         slo=args.slo,
                         profile_capture_dir=args.profile_capture_dir,
                         batch=args.batch,
                         batch_window=args.batch_window,
                         count_cache=args.count_cache,
                         mem_budget=args.mem_budget,
                         worker_id=args.worker_id,
                         lease_ttl=args.lease_ttl,
                         verify_outputs=args.verify_outputs,
                         device=device, mesh_devices=mesh_devices)
    try:
        echo(f"\nServing {len(specs)} job(s) on one warm backend "
             f"[{runner.backend.device}]"
             + (f" as fleet worker {args.worker_id!r}"
                if args.worker_id else "")
             + (f" (kernel build: {runner.cache_dir})" if runner.cache_dir
                else "")
             + (f" (journal: {runner.journal.root})" if runner.journal
                else "") + "\n")
        results = runner.submit_jobs(specs)
    finally:
        runner.close()
    failed = 0
    for spec, res in zip(specs, results):
        if not res.ok:
            failed += 1
            print(f"job {res.job_id} FAILED: {res.error}",
                  file=sys.stderr)
            continue
        if res.resumed or res.output_paths:
            # journal mode: the runner wrote (or a previous process
            # already committed) this job's outputs at commit time
            continue
        write_outputs(res.fastas, spec.config.outfolder,
                      spec.config.prefix, spec.config.nchar,
                      spec.config.thresholds, echo=echo)
        if spec.config.metrics_out:
            from .observability.manifest import manifest_path_for

            echo("Run manifest written to "
                 + manifest_path_for(spec.config.metrics_out) + "\n")
    ov = runner.registry.value("serve/overlap_sec")
    if args.health_out:
        echo(f"Health snapshot at {args.health_out}")
    if args.telemetry_out:
        echo(f"Telemetry exposition at {args.telemetry_out}")
    nv = int(runner.registry.value("slo/violations"))
    if nv:
        echo(f"SLO: {nv} objective breach(es) — see slo/violations/* "
             f"in the exposition / health snapshot")
    echo(f"Done: {len(results) - failed}/{len(results)} job(s) ok, "
         f"cross-job overlap {ov:.3f}s.\n")
    return 1 if failed else 0


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


def main(argv: Optional[List[str]] = None, device=None,
         mesh_devices=None) -> int:
    """Run the CLI (``argv[0] == "serve"``: :func:`serve_main`);
    ``device`` as in ``device.resolve_device`` (None = CUDA, raising
    without it); ``mesh_devices`` the device list a ``--shards`` run's
    mesh draws on (``backends.torch_backend.mesh_device_list``: by
    default every CUDA device of the host; a list may repeat a device).
    There is no flag or environment setting for it."""
    from .backends.torch_backend import TorchBackend
    from .config import resolve_decode_threads
    from .formats import open_alignment_input
    from .ingest.badrecords import BadRecordBudgetExceeded

    from . import observability

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:], device=device,
                          mesh_devices=mesh_devices)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    validate_mesh_shards(cfg.shards, cfg.pileup, device, mesh_devices)
    if cfg.incremental and not cfg.checkpoint_dir:
        raise SystemExit("--incremental requires --checkpoint-dir")
    echo = (lambda *a, **k: None) if args.quiet else print
    observability.configure_logging(cfg.log_level, cfg.log_format)
    backend = TorchBackend(device, mesh_devices)
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
