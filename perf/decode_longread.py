#!/usr/bin/env python3
"""Host decode of the long-read input (``chip_smoke.longread_sv``) by the
port's two decoders: seconds spent in the encoder, drained directly and
through the backend's prefetch thread, on whatever host runs it (no card
is used; the numbers say nothing of the card).

    python3 perf/decode_longread.py [--small] [--fixed-window] [--profile]

``--small`` cuts the input to 186 reads (60 carriers of the insertion, 6
with a prefix of it, 120 background reads); ``--fixed-window`` swaps in
the reference's line-end search (a fixed 1 MiB window per call, a copy of
``sam2consensus_tpu/encoder/native_encoder._line_end``) to show what the
port's growing window saves; ``--profile`` prints the top entries of a
cProfile of one native decode (which adds its own cost).
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from sam2consensus_torch.backends import torch_backend as tb  # noqa: E402
from sam2consensus_torch.config import RunConfig  # noqa: E402
from sam2consensus_torch.encoder import native_encoder  # noqa: E402
from sam2consensus_torch.encoder.events import GenomeLayout  # noqa: E402
from sam2consensus_torch.io.sam import (ReadStream, opener,  # noqa: E402
                                        read_header)
from sam2consensus_torch.utils.simulate import write_sam  # noqa: E402


def fixed_window_line_end(data: np.ndarray, start: int) -> int:
    """The reference's search: a fixed 1 MiB window per call."""
    seg = data[start:start + (1 << 20)]
    nl = np.nonzero(seg == 10)[0]
    if len(nl):
        return start + int(nl[0])
    if start + len(seg) < len(data):
        nl = np.nonzero(data[start:] == 10)[0]
        return start + int(nl[0]) if len(nl) else len(data)
    return len(data)


def decode(path: str, decoder: str, threaded: bool, profile=None) -> float:
    """Seconds spent in the encoder's batch generator."""
    with opener(path, binary=True) as handle:
        contigs, _n, first = read_header(handle)
        stats = tb.BackendStats()
        stats.extra["decode_sec"] = 0.0
        _enc, batches = tb.TorchBackend._make_encoder(
            GenomeLayout(contigs), ReadStream(handle, first),
            RunConfig(decoder=decoder), stats)
        if stats.extra["decoder"] != decoder:
            raise SystemExit(f"asked for {decoder}, ran "
                             f"{stats.extra['decoder']}")
        if threaded:
            for _ in tb._Prefetcher(batches, stats):
                pass
            return stats.extra["decode_sec"]
        t0 = time.perf_counter()
        if profile is not None:
            profile.enable()
        for _ in batches:
            pass
        if profile is not None:
            profile.disable()
        return time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--small", action="store_true")
    p.add_argument("--fixed-window", action="store_true")
    p.add_argument("--profile", action="store_true")
    args = p.parse_args()
    if args.fixed_window:
        native_encoder._line_end = fixed_window_line_end
    kw = dict(carriers=60, cut=6, background=120, sites=150) \
        if args.small else {}
    text = chip_smoke.longread_sv(**kw)
    print(f"host: {os.cpu_count()} cpus; input {len(text)} B "
          f"({'small' if args.small else 'full'} longread_sv); line end: "
          f"{'fixed 1 MiB window' if args.fixed_window else 'growing'}")
    with tempfile.TemporaryDirectory() as tmp:
        path = write_sam(text, os.path.join(tmp, "longread_sv.sam"))
        for decoder, threaded in [("native", False), ("native", True),
                                  ("py", False), ("py", True)] * 2:
            sec = decode(path, decoder, threaded)
            print(f"  {decoder:6s} {'prefetch' if threaded else 'direct'}: "
                  f"decode={sec:.3f}s")
        if args.profile:
            prof = cProfile.Profile()
            sec = decode(path, "native", False, prof)
            print(f"  native direct under cProfile: {sec:.3f}s")
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(
                "tottime").print_stats(5)
            print(out.getvalue().replace(REPO + os.sep, ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
