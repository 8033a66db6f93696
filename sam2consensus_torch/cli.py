"""Command-line interface of the PyTorch port.

Drop-in compatible with the reference CLI (reference
``sam2consensus.py:87-104``): the eight flags ``-i -c -n -o -p -m -f -d``
keep their names, defaults and post-processing (``:108-138``), plus
``--py2-compat``; the progress messages match.  Input is SAM or gzip SAM
(``.gz`` suffix).  The run goes to CUDA and raises without it; ``main``'s
``device`` argument is the only way to choose another device.

    python -m sam2consensus_torch.cli -i reads.sam -o out
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
                   help="SAM file, optionally gzip-compressed (.gz)")
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
    p.add_argument("--py2-compat", action="store_true",
                   help="reproduce the reference's Python-2 maxdel quirk: any "
                        "explicit -d value disables deletion filtering")
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
        py2_compat=args.py2_compat,
    )


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the CLI; ``device`` as in ``device.resolve_device`` (None = CUDA,
    raising without it)."""
    from .backends.torch_backend import TorchBackend
    from .io.sam import ReadStream, opener, read_header

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    backend = TorchBackend(device)
    echo = print

    echo("\nProcessing file " + args.filename + ":\n")
    progress = [0]

    def on_lines(total: int) -> None:
        for k in range(progress[0] // 500000 + 1, total // 500000 + 1):
            echo(str(k * 500000) + " reads processed.")
        progress[0] = total

    with opener(args.filename) as handle:
        contigs, _n_header, first = read_header(handle)
        echo("SAM header processed, " + str(len(contigs))
             + " references found.\n")
        stream = ReadStream(handle, first, on_lines=on_lines)
        result = backend.run(contigs, stream, cfg)
    echo("A total of " + str(stream.n_lines) + " reads were processed, out of "
         "which, " + str(result.stats.reads_mapped) + " reads were mapped.\n")
    write_outputs(result.fastas, cfg.outfolder, cfg.prefix, cfg.nchar,
                  cfg.thresholds, echo=echo)
    echo("Done.\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
