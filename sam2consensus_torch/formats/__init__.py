"""Input formats: one open call for every alignment container.

Copy of ``FormatError``, ``AlignmentInput``, ``detect_format``,
``sibling_sam``, ``open_alignment_input`` and ``_bgzf_open_failed`` from
``sam2consensus_tpu/formats/__init__.py`` (pinned by
``tests/test_torch_copies.py``), with the reference's ``format/input``
gauge, set in the registry that is current at open time (the CLI opens
its input before the run, as the reference's does), and its
``format/bgzf_corrupt`` and ``format/fallback`` counters; the
``bam_inflate`` fault-injection site reaches the BGZF reader as there.
``open_alignment_input(path, fmt="auto")``
returns an :class:`AlignmentInput` whose ``contigs``/``stream`` pair goes
into ``TorchBackend.run(contigs, stream, cfg)``.

==========  ==============================================================
``sam``     plain SAM text (``io/sam.py``: mmapped blocks into the C++
            decoder)
``sam.gz``  gzip SAM, sniffed per file, not per suffix: an htslib
            ``.sam.gz`` is BGZF, whose blocks inflate on the
            ``--decode-threads`` pool (``formats/bgzf.py``) with ordered
            reassembly; plain single-member gzip keeps the serial stream
``bam``     BGZF container + binary records (``formats/bam.py``)
==========  ==============================================================

A BGZF container whose open-time block scan fails (missing EOF marker,
mid-block EOF, bad header) falls back to a same-stem sibling SAM
(``x.bam`` -> ``x.sam``/``x.sam.gz``, ``x.sam.gz`` -> ``x.sam``) where one
exists, and otherwise raises with the block offset.  That is the
reference's input semantics (the same bytes are read), not a device
fallback.
"""

from __future__ import annotations

import gzip
import logging
import os
from dataclasses import dataclass
from typing import List, Optional

from ..io.sam import Contig, ReadStream, read_header
from . import bgzf as _bgzf

FORMATS = ("auto", "sam", "sam.gz", "bam")

#: gzip magic (any flavor)
_GZ_MAGIC = b"\x1f\x8b"


class FormatError(ValueError):
    """Input does not match the requested/detected format."""


@dataclass
class AlignmentInput:
    """An opened alignment source, backend-ready.

    ``stream`` is a :class:`~..io.sam.ReadStream` (SAM flavors) or
    :class:`~.bam.BamReadStream` (BAM).  ``format`` is the RESOLVED format
    (``sam`` / ``sam.gz`` / ``sam.bgzf`` / ``bam``); ``fallback_from``
    records a corrupt-container fallback's original path."""

    path: str
    format: str
    contigs: List[Contig]
    stream: object
    handle: object = None
    fallback_from: Optional[str] = None

    def close(self) -> None:
        h = self.handle
        if h is not None:
            try:
                h.close()
            except OSError:
                pass


def detect_format(path: str) -> str:
    """Resolve a file's on-disk format by magic bytes, not suffix:
    ``sam`` | ``sam.gz`` (plain gzip) | ``sam.bgzf`` | ``bam``."""
    with open(path, "rb") as fh:
        head = fh.read(64)
    if head[:2] != _GZ_MAGIC:
        return "sam"
    if not _bgzf.sniff_bgzf(head):
        return "sam.gz"
    # BGZF: BAM iff the first inflated bytes open with the BAM magic
    with open(path, "rb") as fh:
        try:
            bsize = _bgzf._block_bsize(head, 0)
            first = _bgzf.inflate_block(fh.read(bsize), 0)
        except _bgzf.BgzfError:
            # damaged first block: defer to the opener, which runs the
            # full scan and owns the fallback path; the suffix is the
            # best remaining hint
            return "bam" if path.endswith(".bam") else "sam.bgzf"
    return "bam" if first[:4] == b"BAM\x01" else "sam.bgzf"


def sibling_sam(path: str) -> Optional[str]:
    """A same-stem plain/gzip SAM next to ``path``, if one exists: the
    text fallback target for a damaged binary container."""
    stem = path
    for ext in (".bam", ".gz"):
        if stem.endswith(ext):
            stem = stem[: -len(ext)]
    if stem.endswith(".sam.bgzf"):
        stem = stem[: -len(".bgzf")]
    candidates = []
    if not stem.endswith(".sam"):
        candidates.append(stem + ".sam")
    else:
        candidates.append(stem)
    candidates.append(stem + ".gz" if stem.endswith(".sam")
                      else stem + ".sam.gz")
    for cand in candidates:
        if cand != path and os.path.exists(cand):
            return cand
    return None


def _metrics():
    from .. import observability as obs

    return obs.metrics()


def _fault_check(site: str) -> None:
    from ..resilience.faultinject import fault_check

    fault_check(site)


def open_alignment_input(path: str, fmt: str = "auto", on_lines=None,
                         threads: int = 1,
                         fallback: bool = True) -> AlignmentInput:
    """Open ``path`` as ``fmt`` (``auto`` sniffs magic bytes) and return
    the backend-ready (contigs, stream) pair.

    ``threads`` sizes the BGZF inflate pool (callers pass the resolved
    ``--decode-threads``).  Text SAM is opened in bytes mode, which both
    decoders take (the reference's ``binary=False`` text mode is not
    copied).  ``fallback=False`` disables the corrupt-container
    sibling-SAM fallback."""
    if fmt not in FORMATS:
        raise FormatError(
            f"unknown input format {fmt!r} (use one of {FORMATS})")
    resolved = detect_format(path) if fmt == "auto" else fmt

    if resolved == "bam":
        try:
            reader = _bgzf.BgzfReader(path, threads=threads,
                                      fault_check=_fault_check,
                                      metrics=_metrics())
        except _bgzf.BgzfError as exc:
            return _bgzf_open_failed(path, on_lines, threads, fallback,
                                     exc)
        from .bam import BamReadStream, read_bam_header

        try:
            contigs, _text = read_bam_header(reader)
        except Exception:
            # the reader owns an fd: a damaged BAM header must not leak it
            reader.close()
            raise
        stream = BamReadStream(reader, [c.name for c in contigs],
                               on_lines=on_lines)
        _metrics().gauge("format/input").set_info(
            {"path": path, "format": "bam",
             "blocks": len(reader.blocks), "threads": threads})
        return AlignmentInput(path=path, format="bam", contigs=contigs,
                              stream=stream, handle=reader)

    if resolved in ("sam.gz", "sam.bgzf"):
        bgzf_file = resolved == "sam.bgzf" or (
            fmt == "sam.gz" and _bgzf.is_bgzf(path))
        if bgzf_file:
            try:
                handle = _bgzf.BgzfReader(path, threads=threads,
                                          fault_check=_fault_check,
                                          metrics=_metrics())
            except _bgzf.BgzfError as exc:
                return _bgzf_open_failed(path, on_lines, threads, fallback,
                                         exc)
            resolved = "sam.bgzf"
        else:
            handle = gzip.open(path, "rb")
            resolved = "sam.gz"
        try:
            contigs, _n, first = read_header(handle)
        except Exception:
            handle.close()      # see the bam branch: no fd leak
            raise
        _metrics().gauge("format/input").set_info(
            {"path": path, "format": resolved, "threads": threads})
        return AlignmentInput(
            path=path, format=resolved, contigs=contigs,
            stream=ReadStream(handle, first, on_lines=on_lines),
            handle=handle)

    # plain SAM text
    if resolved != "sam":  # pragma: no cover - FORMATS exhausts above
        raise FormatError(f"unhandled format {resolved!r}")
    handle = open(path, "rb")
    try:
        contigs, _n, first = read_header(handle)
    except Exception:
        handle.close()
        raise
    _metrics().gauge("format/input").set_info({"path": path, "format": "sam"})
    return AlignmentInput(
        path=path, format="sam", contigs=contigs,
        stream=ReadStream(handle, first, on_lines=on_lines),
        handle=handle)


def _bgzf_open_failed(path, on_lines, threads, fallback,
                      exc) -> AlignmentInput:
    """A BGZF container failed its open-time scan: take the sibling SAM
    where one exists, else re-raise with the block offset."""
    reg = _metrics()
    reg.add("format/bgzf_corrupt")
    sib = sibling_sam(path) if fallback else None
    if sib is None:
        raise exc
    reg.add("format/fallback")
    reg.gauge("format/input").set_info(
        {"path": sib, "format": "fallback", "fallback_from": path,
         "error": f"{type(exc).__name__}: {exc}"})
    logging.getLogger("sam2consensus_torch.formats").warning(
        "damaged BGZF container %s (%s); falling back to sibling %s",
        path, exc, sib)
    out = open_alignment_input(sib, "auto", on_lines=on_lines,
                               threads=threads, fallback=False)
    out.fallback_from = path
    return out
