"""Command-line interface of the PyTorch port.

Drop-in compatible with the reference CLI (reference
``sam2consensus.py:87-104``): the eight flags ``-i -c -n -o -p -m -f -d``
keep their names, defaults and post-processing (``:108-138``), plus the
reference package's one-shot flags ``--py2-compat``, ``--permissive``,
``--segment-width``, ``--quiet``, ``--format``, ``--pileup``, ``--wire``,
``--insertion-kernel``, ``--decode-threads``, ``--decoder`` and
``--chunk-reads``; the progress messages match.  Input is SAM, gzip or
BGZF SAM, or BAM, sniffed by magic bytes
(``formats.open_alignment_input``).  The run goes
to CUDA and raises without it; ``main``'s ``device`` argument is the only
way to choose another device.

    python -m sam2consensus_torch.cli -i reads.bam -o out
"""

from __future__ import annotations

import argparse
import math
import sys
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
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress output")
    # NOTE: long-form only — the reference already owns -f for --fill
    p.add_argument("--format", dest="input_format",
                   choices=["auto", "sam", "sam.gz", "bam"],
                   default="auto",
                   help="input format: auto (default) sniffs magic bytes "
                        "— plain SAM, gzip SAM, BGZF SAM (htslib .sam.gz; "
                        "inflated block-parallel on --decode-threads "
                        "workers) or BAM (block-parallel BGZF + binary "
                        "record decode, no SAM text materialized)")
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
    return p


def config_from_args(args: argparse.Namespace) -> RunConfig:
    """Post-processing copied from ``sam2consensus_tpu/cli.config_from_args``
    for these flags, including the clean ``-c`` rejection."""
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
    )


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the CLI; ``device`` as in ``device.resolve_device`` (None = CUDA,
    raising without it)."""
    from .backends.torch_backend import TorchBackend
    from .config import resolve_decode_threads
    from .formats import open_alignment_input

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    backend = TorchBackend(device)
    echo = (lambda *a, **k: None) if args.quiet else print

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
        result = backend.run(ai.contigs, stream, cfg)
    finally:
        ai.close()
    echo("A total of " + str(stream.n_lines) + " reads were processed, out of "
         "which, " + str(result.stats.reads_mapped) + " reads were mapped.\n")
    write_outputs(result.fastas, cfg.outfolder, cfg.prefix, cfg.nchar,
                  cfg.thresholds, echo=echo)
    echo("Done.\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
