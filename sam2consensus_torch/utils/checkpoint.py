"""Checkpoint/resume for the streaming consensus job.

Copy of ``sam2consensus_tpu/utils/checkpoint.py`` (pinned by
``tests/test_torch_copies.py``), with its ``checkpoint/corrupt`` counter
and trace event: the ``.npz`` file is the same file (the same keys, ``meta`` layout, crc32 ``digest``
and atomic rename), so a checkpoint written by either package resumes in
the other.

SURVEY.md §5: the count tensor IS the entire job state and is
sum-decomposable, so a checkpoint is just ``[total_len, 6]`` counts plus
the insertion event log and the number of input lines already consumed —
a killed run resumes by loading the arrays and skipping that many body
lines (the reference has nothing comparable: two full passes, all state in
RAM, ``sam2consensus.py:149,180``).

Checkpoints are written at batch boundaries, where the pipeline guarantees
every decoded line's contribution is either in the count tensor or the
insertion log (nothing in flight).  Files are plain ``.npz`` written via a
temp file + atomic rename, so a crash mid-write leaves the previous
checkpoint intact.

Integrity: the payload arrays carry a ``zlib.crc32`` digest (``digest``
entry) computed over their raw bytes at save time.  ``load`` verifies
it — and treats ANY unreadable checkpoint (truncated/corrupt npz,
digest mismatch) as absent-with-warning (``checkpoint/corrupt``
counter) instead of raising: a corrupt checkpoint mid-resume must cost
a from-scratch re-run, never wedge the job that was trying to recover.
A checkpoint whose shape doesn't match the input still raises — that is
a *wrong input* contract error, not corruption.
"""

from __future__ import annotations

import logging
import os
import tempfile
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..encoder.events import InsertionEvents

logger = logging.getLogger("sam2consensus_torch.utils.checkpoint")

_FILE = "sam2consensus_ckpt.npz"


@dataclass
class CheckpointState:
    counts: np.ndarray           # [total_len, 6] int32
    lines_consumed: int
    reads_mapped: int
    reads_skipped: int
    aligned_bases: int
    insertions: InsertionEvents
    #: identity of the in-flight input the line offset refers to; an
    #: --incremental run whose input differs treats the checkpoint as an
    #: accumulated base and starts the new file from line 0
    source: str = ""
    #: identities of inputs FULLY absorbed into counts; an --incremental
    #: run whose input is listed here is a duplicate and adds nothing
    sources: list = None
    #: absolute byte offset in the (uncompressed) input matching
    #: lines_consumed; resume seeks here in O(1) instead of re-reading
    #: the consumed lines.  -1 = unknown (non-seekable stream): resume
    #: falls back to the line-skipping loop.
    byte_offset: int = -1
    #: widest segment-row bucket the encoder emitted so far (0 =
    #: unknown/old checkpoint); a resumed sharded run sizes its sp/dpsp
    #: halo from this instead of re-observing (round-4 verdict #5)
    max_row_width: int = 0


def path_for(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, _FILE)


def _payload_digest(arrays) -> int:
    """crc32 over the payload arrays' raw bytes, in a fixed order —
    cheap (~100 MB/s-class) next to the npz compression that follows,
    and enough to catch the failure this guards: a torn/bit-rotted file
    served as a resume base."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc & 0xFFFFFFFF


def save(checkpoint_dir: str, state: CheckpointState) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    ic, il, im, ich = state.insertions.to_arrays()
    counts = state.counts.astype(np.int32)
    meta = np.array([state.lines_consumed, state.reads_mapped,
                     state.reads_skipped, state.aligned_bases,
                     state.byte_offset, state.max_row_width],
                    dtype=np.int64)
    ins_contig = ic.astype(np.int32)
    ins_local = il.astype(np.int32)
    ins_mlen = im.astype(np.int32)
    ins_chars = ich.astype(np.uint8)
    source = np.frombuffer(state.source.encode("utf-8"), dtype=np.uint8)
    sources = np.frombuffer(
        "\n".join(state.sources or []).encode("utf-8"), dtype=np.uint8)
    digest = _payload_digest((counts, meta, ins_contig, ins_local,
                              ins_mlen, ins_chars, source, sources))
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=checkpoint_dir)
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(
                fh,
                counts=counts,
                meta=meta,
                ins_contig=ins_contig,
                ins_local=ins_local,
                ins_mlen=ins_mlen,
                ins_chars=ins_chars,
                source=source,
                sources=sources,
                digest=np.array([digest], dtype=np.uint32))
        os.replace(tmp, path_for(checkpoint_dir))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _corrupt(path: str, why: str) -> None:
    """Record + warn: the checkpoint is unusable and will be ignored."""
    from .. import observability as obs

    obs.metrics().add("checkpoint/corrupt", 1)
    obs.tracer().event("checkpoint/corrupt", path=path, reason=why)
    logger.warning(
        "checkpoint at %s is unusable (%s): resuming from scratch — the "
        "corrupt file is left in place for forensics and will be "
        "overwritten by the next checkpoint write", path, why)


def load(checkpoint_dir: str, total_len: int) -> Optional[CheckpointState]:
    """Load the checkpoint if present, intact, and shape-compatible.

    Returns None when absent — or when the file is corrupt/truncated or
    its crc32 digest mismatches (counted ``checkpoint/corrupt``, warned;
    the run resumes from scratch).  A shape mismatch still raises: that
    is a wrong-input error the user must see, not damage to absorb."""
    p = path_for(checkpoint_dir)
    if not os.path.exists(p):
        return None
    try:
        z = np.load(p, allow_pickle=False)
    except Exception as exc:            # zipfile/npz corruption shapes vary
        _corrupt(p, f"unreadable npz: {type(exc).__name__}: {exc}")
        return None
    with z:
        try:
            counts = z["counts"]
            meta = z["meta"]
            payload = (counts.astype(np.int32), meta,
                       z["ins_contig"].astype(np.int32),
                       z["ins_local"].astype(np.int32),
                       z["ins_mlen"].astype(np.int32),
                       z["ins_chars"].astype(np.uint8),
                       z["source"] if "source" in z.files
                       else np.zeros(0, np.uint8),
                       z["sources"] if "sources" in z.files
                       else np.zeros(0, np.uint8))
        except Exception as exc:        # truncated member / missing key
            _corrupt(p, f"truncated payload: {type(exc).__name__}: {exc}")
            return None
        if "digest" in z.files:
            want = int(z["digest"][0])
            got = _payload_digest(payload)
            if got != want:
                _corrupt(p, f"digest mismatch (crc32 {got:#010x} != "
                            f"recorded {want:#010x})")
                return None
        # pre-digest checkpoints (older writers) load undigested
        if counts.shape != (total_len, 6):
            raise ValueError(
                f"checkpoint at {p} is for a genome of length "
                f"{counts.shape[0]}, not {total_len} — wrong input file?")
        ins = InsertionEvents()
        if len(z["ins_contig"]):
            ins.array_chunks.append(
                (z["ins_contig"], z["ins_local"], z["ins_mlen"],
                 z["ins_chars"]))
        source = bytes(z["source"]).decode("utf-8") \
            if "source" in z.files else ""
        blob = bytes(z["sources"]).decode("utf-8") \
            if "sources" in z.files else ""
        sources = [s for s in blob.split("\n") if s]
        return CheckpointState(
            counts=counts, lines_consumed=int(meta[0]),
            reads_mapped=int(meta[1]), reads_skipped=int(meta[2]),
            aligned_bases=int(meta[3]), insertions=ins, source=source,
            sources=sources,
            byte_offset=int(meta[4]) if len(meta) > 4 else -1,
            max_row_width=int(meta[5]) if len(meta) > 5 else 0)
