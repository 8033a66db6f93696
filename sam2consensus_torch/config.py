"""Run configuration.

Copy of ``RunConfig``, ``resolve_decode_threads``, ``default_prefix`` and
``normalize_outfolder`` from ``sam2consensus_tpu/config.py`` (field names
kept, pinned by ``tests/test_torch_copies.py``).  The port honours
``thresholds, min_depth, fill, maxdel, prefix, nchar, outfolder, strict,
py2_compat, input_format, segment_width, decoder, pileup (auto, pallas,
scatter or host), wire, decode_threads, ins_kernel, chunk_reads``; the other fields exist so a config
built for the reference reads the same here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional


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
    decode_threads: int = 1
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


def resolve_decode_threads(cfg) -> int:
    """``--decode-threads`` with 0 = auto (all cores): one policy shared by
    the shard workers of the parallel SAM decoder
    (``encoder/parallel_decode.py``), the native vote's position ranges
    (``ops.vote.vote_positions_native``) and the BGZF inflate pool
    (``formats/bgzf.py`` on ``ingest.shared_pool``).  The sharded
    decoder's ``EXTRA_COUNTS_BUDGET`` clamps its workers on huge genomes.
    The reference's ``S2C_DECODE_THREADS_CAP`` environment cap is not
    copied."""
    threads = getattr(cfg, "decode_threads", 1)
    if threads == 0:
        threads = os.cpu_count() or 1
    return max(1, threads)


def default_prefix(filename: str) -> str:
    """Input basename up to the first dot (sam2consensus.py:121-124)."""
    return "".join(filename.split("/")[-1]).split(".")[0]


def normalize_outfolder(outfolder: str) -> str:
    """rstrip slash + ensure exists + trailing slash (sam2consensus.py:127-130)."""
    out = outfolder.rstrip("/")
    if out == "":
        out = "/"
    if not os.path.exists(out):
        os.makedirs(out)
    return out + "/"
