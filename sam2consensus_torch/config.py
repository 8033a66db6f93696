"""Run configuration.

Copy of ``RunConfig``, ``resolve_decode_threads``, ``default_prefix`` and
``normalize_outfolder`` from ``sam2consensus_tpu/config.py`` (field names
kept, pinned by ``tests/test_torch_copies.py``; ``normalize_outfolder``
tolerates a folder a concurrent fleet worker makes first).  One
extension: ``decode_threads=None``, the serve parser's default, sizes a
job's decode workers from the host (:func:`host_decode_workers`).  The
port honours ``thresholds, min_depth, fill, maxdel, prefix, nchar, outfolder, strict,
py2_compat, input_format, segment_width, decoder, pileup (auto, pallas,
scatter or host), wire, decode_threads, ins_kernel, chunk_reads``; the other fields exist so a config
built for the reference reads the same here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

from .ingest import DEFAULT_MIN_SHARD_BYTES


@dataclass
class RunConfig:
    """Everything a backend needs to turn records into FASTA records.

    ``maxdel=None`` disables the deletion gate (gaps always counted), which
    is what the reference's Python-2 quirk does for any user-supplied ``-d``;
    ``--py2-compat`` maps a user-supplied ``-d`` to ``None``.
    """

    thresholds: List[float] = field(default_factory=lambda: [0.25])
    min_depth: int = 1
    fill: str = "-"
    maxdel: Optional[int] = 150
    prefix: str = ""
    nchar: int = 0
    outfolder: str = "./"
    backend: str = "cpu"
    # --- non-reference extensions ---
    strict: bool = True
    py2_compat: bool = False
    input_format: str = "auto"
    segment_width: int = 0       # 0 = auto (DEFAULT_SEGMENT_W), <0 = off
    decoder: str = "auto"
    pileup: str = "auto"
    wire: str = "auto"
    #: None (serve's default) = sized from the host and the input
    decode_threads: Optional[int] = 1
    ins_kernel: str = "auto"
    shard_mode: str = "auto"
    incremental: bool = False
    source_id: str = ""
    retries: int = 3
    retry_backoff: float = 0.25
    on_device_error: str = "retry"
    fault_inject: str = ""
    chunk_reads: int = 262144    # reads per host->device batch
    profile_dir: Optional[str] = None
    json_metrics: Optional[str] = None
    trace_out: Optional[str] = None
    metrics_out: Optional[str] = None
    log_level: Optional[str] = None
    log_format: str = "text"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 2_000_000
    paranoid: bool = False
    shards: int = 0
    on_bad_record: str = "fail"
    max_bad_records: str = ""
    quarantine_out: Optional[str] = None

    @staticmethod
    def threshold_labels(thresholds: List[float]) -> List[str]:
        """Percent labels, matching ``int(t*100)`` (sam2consensus.py:394)."""
        return [str(int(t * 100)) for t in thresholds]


#: the most decode workers the host-sized policy gives a job, from the
#: byte-shard rung on the card's host (8 cores, NVIDIA H100 80GB HBM3;
#: ``perf/decode_scaling_pr21_run1.log`` and ``_run2.log``): alone, 4
#: workers decode 2.6-3.0x as fast as one, and 6 move that by -3% to
#: +33%; beside a pinned copy on torch's 8 intra-op threads, as the
#: stager's, 4 read 0.88-0.97x of one and 6 read 0.71-1.00x.  So 4: the
#: smaller sample's knee, and the safer count beside the stager (PR 7's
#: ``perf/host_gate_sweep_pr7_run4.log`` found the knee at 4 of 1/4/8)
SERVE_DECODE_CAP = 4

#: threads a warm server keeps busy beside the decode workers: the
#: serving thread and the prefetch (stager) thread
SERVE_BUSY_THREADS = 2


def usable_cpus() -> int:
    """The CPUs this process may run on (its affinity), else the host's."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def host_decode_workers(body_bytes: Optional[int],
                        cpus: Optional[int] = None,
                        sharers: int = 1) -> int:
    """Decode workers for a job whose ``--decode-threads`` was not given:
    ``min(SERVE_DECODE_CAP, (cpus - SERVE_BUSY_THREADS) // sharers)``,
    and 1 (the serial decoder) below 2.  ``body_bytes`` None is an input
    that does not byte-shard (gzip, BGZF, in memory), and a body under
    two shards' minimum does not split: both serial; the shard plan
    takes fewer workers on a short body.  ``sharers`` is the number of
    jobs decoding at once on the server's CPUs (a packed batch's member
    pool)."""
    if body_bytes is None or body_bytes < 2 * DEFAULT_MIN_SHARD_BYTES:
        return 1
    cpus = usable_cpus() if cpus is None else cpus
    n = min(SERVE_DECODE_CAP,
            (cpus - SERVE_BUSY_THREADS) // max(1, sharers))
    return n if n >= 2 else 1


def resolve_decode_threads(cfg, body_bytes: Optional[int] = None,
                           sharers: int = 1) -> int:
    """``--decode-threads`` with 0 = auto (all cores): one policy shared by
    the shard workers of the parallel SAM decoder
    (``encoder/parallel_decode.py``), the native vote's position ranges
    (``ops.vote.vote_positions_native``) and the BGZF inflate pool
    (``formats/bgzf.py`` on ``ingest.shared_pool``).  The sharded
    decoder's ``EXTRA_COUNTS_BUDGET`` clamps its workers on huge genomes.
    None (not given, serve's default) is :func:`host_decode_workers` over
    ``body_bytes``, the plain file's SAM body (1 where the caller knows
    none), and ``sharers``.  The reference's ``S2C_DECODE_THREADS_CAP``
    environment cap is not copied."""
    threads = getattr(cfg, "decode_threads", 1)
    if threads is None:
        return host_decode_workers(body_bytes, sharers=sharers)
    if threads == 0:
        threads = os.cpu_count() or 1
    return max(1, threads)


def default_prefix(filename: str) -> str:
    """Input basename up to the first dot (sam2consensus.py:121-124)."""
    return "".join(filename.split("/")[-1]).split(".")[0]


def normalize_outfolder(outfolder: str) -> str:
    """rstrip slash + ensure exists + trailing slash (sam2consensus.py:127-130).
    ``exist_ok``: fleet workers sharing ``-o`` make it at once (the
    reference's exists-then-create lets the second one raise)."""
    out = outfolder.rstrip("/")
    if out == "":
        out = "/"
    if not os.path.exists(out):
        os.makedirs(out, exist_ok=True)
    return out + "/"
