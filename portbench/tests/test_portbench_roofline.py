"""K1's work, counted from a job's own sizes: each count update's base
code, each read's start and CIGAR, and the ``[L, 6]`` int32 counts."""

import re

import numpy as np
import pytest

from portbench.harness import roofline
from portbench.traffic import generate, pool
from portbench.tests.test_portbench_traffic import config


def test_k1_bytes_by_hand():
    # 10 reads of 150M over a 1,000 bp contig: 1,500 codes, 10 starts,
    # 10 CIGAR operations, 6,000 count lanes
    assert roofline.k1_bytes(1500, 10, 10, 1000) == \
        1500 + 10 * 4 + 10 * 4 + 1000 * 6 * 4
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)


def test_work_of_counts_every_read():
    cfg = config("sarscov2_artic_v3")
    s = generate.sample(cfg, {"reads_per_sample": 5000}, 3, 0)
    m = d = ops = 0
    for k in s.cigar_id.tolist():
        for n, op in re.findall(r"(\d+)([MIDNSHPX=])", s.cigars[k]):
            ops += 1
            m += int(n) if op == "M" else 0
            d += int(n) if op == "D" else 0
    assert pool.work_of(s) == (m, m + d, ops)


def test_pileup_events_are_the_ports_counted_cells(tmp_path):
    """The events the bound prices are the cells the port counts
    (``stats.aligned_bases``: M bases and counted gaps)."""
    from sam2consensus_torch.cli import build_serve_parser, config_from_args
    from sam2consensus_torch.serve.runner import JobSpec, ServeRunner

    cfg = config("sarscov2_artic_v3")
    s = pool.make_sample(cfg, {"reads_per_sample": 8000}, 9, 0,
                         str(tmp_path))
    args = build_serve_parser().parse_args(
        ["-i", s.path, "-o", str(tmp_path / "o"), "--pileup", "pallas"])
    args.filename, args.prefix = s.path, ""
    runner = ServeRunner(device="cpu")
    try:
        res, = runner.submit_jobs([JobSpec(s.path, config_from_args(args))])
    finally:
        runner.close()
    assert res.stats.aligned_bases == s.pileup_events
    assert s.aligned_bases < s.pileup_events
    assert np.isclose(s.aligned_bases / s.n_reads, 150, rtol=0.2)
