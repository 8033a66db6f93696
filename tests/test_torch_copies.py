"""The port's copies of jax-free code equal their originals.

``sam2consensus_torch`` imports nothing from ``sam2consensus_tpu``; the
helpers it needs are copies, each pinned here against the original on the
same inputs (values, shapes and dtypes; behaviour on fixtures where the
copy is code rather than data).
"""

import dataclasses
import io
import os

import numpy as np
import pytest

from sam2consensus_torch import config as t_config
from sam2consensus_torch import constants as t_const
from sam2consensus_torch.backends import base as t_base
from sam2consensus_torch.core import cigar as t_cigar
from sam2consensus_torch.encoder import events as t_events
from sam2consensus_torch.io import fasta as t_fasta
from sam2consensus_torch.io import sam as t_sam
from sam2consensus_torch.ops import cutoff as t_cutoff
from sam2consensus_torch.ops import fused as t_fused
from sam2consensus_torch.ops import insertion_kernel as t_ik
from sam2consensus_torch.ops import pileup as t_pileup
from sam2consensus_torch.ops import vote as t_vote
from sam2consensus_torch.utils import simulate as t_sim
from sam2consensus_tpu import config as r_config
from sam2consensus_tpu import constants as r_const
from sam2consensus_tpu.backends import base as r_base
from sam2consensus_tpu.core import cigar as r_cigar
from sam2consensus_tpu.encoder import events as r_events
from sam2consensus_tpu.io import fasta as r_fasta
from sam2consensus_tpu.io import sam as r_sam
from sam2consensus_tpu.ops import cutoff as r_cutoff
from sam2consensus_tpu.ops import fused as r_fused
from sam2consensus_tpu.ops import mxu_pileup as r_mxu
from sam2consensus_tpu.ops import pallas_insertion as r_pi
from sam2consensus_tpu.ops import pileup as r_pileup
from sam2consensus_tpu.ops import vote as r_vote
from sam2consensus_tpu.utils import simulate as r_sim

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = [f"formats_{fam}{ext}" for fam in ("short", "longread",
                                                "adversarial")
            for ext in (".sam", ".sam.gz", ".plain.sam.gz")]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", [
    "ALPHABET", "NUM_SYMBOLS", "IUPAC_MASK_LUT", "INVALID_SYMBOL",
    "BASE_TO_CODE", "CODE_TO_BASE", "PAD_CODE", "SYM32_ASCII", "AMB", "GAP"])
def test_constants(name):
    got, want = getattr(t_const, name), getattr(r_const, name)
    if isinstance(want, np.ndarray):
        _same(got, want)
    else:
        assert got == want


def test_run_config_fields_and_defaults():
    def spec(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else f.default_factory()) for f in dataclasses.fields(cls)]

    assert spec(t_config.RunConfig) == spec(r_config.RunConfig)
    assert t_config.RunConfig.threshold_labels([0.25, 1.0]) == \
        r_config.RunConfig.threshold_labels([0.25, 1.0])


@pytest.mark.parametrize("path", ["a/b/reads.sam.gz", "x.y", "plain", "./d.e.f"])
def test_default_prefix(path):
    assert t_config.default_prefix(path) == r_config.default_prefix(path)


def test_normalize_outfolder(tmp_path):
    for sub in ("o1", "o2/", "o3//"):
        p = str(tmp_path / sub)
        assert t_config.normalize_outfolder(p) == \
            r_config.normalize_outfolder(p)
        assert os.path.isdir(p.rstrip("/"))


@pytest.mark.parametrize("cig", ["10M", "2S3M1I2M2D1M2H", "5=1X3N2P", "*",
                                 "3M2Q1M", ""])
def test_split_ops(cig):
    assert t_cigar.split_ops(cig) == r_cigar.split_ops(cig)


def _records(sam, path):
    handle = sam.opener(os.path.join(DATA, path))
    try:
        contigs, n, first = sam.read_header(handle)
        recs = [tuple(dataclasses.astuple(r))
                for r in sam.iter_records(handle, first)]
    finally:
        handle.close()
    return [tuple(dataclasses.astuple(c)) for c in contigs], n, recs


@pytest.mark.parametrize("path", FIXTURES)
def test_sam_reader(path):
    assert _records(t_sam, path) == _records(r_sam, path)


@pytest.mark.parametrize("path", FIXTURES[:3])
def test_read_stream_counts_lines(path):
    counts = []
    for sam in (t_sam, r_sam):
        handle = sam.opener(os.path.join(DATA, path))
        _c, _n, first = sam.read_header(handle)
        stream = sam.ReadStream(handle, first)
        recs = [dataclasses.astuple(r) for r in stream.records()]
        counts.append((stream.n_lines, recs))
        handle.close()
    assert counts[0] == counts[1]


def test_fasta_render_and_write(tmp_path):
    recs_t = [t_fasta.FastaRecord(">a|c25", "ACGT-" * 7),
              t_fasta.FastaRecord(">a|c75", "N" * 11)]
    recs_r = [r_fasta.FastaRecord(r.header, r.seq) for r in recs_t]
    for nchar in (0, 3, 80):
        assert t_fasta.render_file(recs_t, nchar) == \
            r_fasta.render_file(recs_r, nchar)
    out = []
    for mod, recs, sub in ((t_fasta, recs_t, "t"), (r_fasta, recs_r, "r")):
        d = tmp_path / sub
        d.mkdir()
        msgs = []
        paths = mod.write_outputs({"a": recs, "b": recs[:1]}, str(d) + "/",
                                  "pre", 4, [0.25, 0.75], echo=msgs.append)
        out.append(([open(p).read() for p in paths],
                    [m.replace(str(d), "") for m in msgs]))
    assert out[0] == out[1]


def test_format_header():
    for args in (("p", 0.25, "ref", 1234, "AC-GT"),
                 ("", 1.0, "r", 0, "----"), ("x", 0.333, "c", 7, "NNN")):
        assert t_base.format_header(*args) == r_base.format_header(*args)


def _encode(ev, text, seg_w, chunk):
    handle = io.StringIO(text)
    contigs, _n, first = r_sam.read_header(handle)
    recs = list(r_sam.iter_records(handle, first))
    layout = ev.GenomeLayout(contigs)        # reads .name / .length only
    enc = ev.ReadEncoder(layout, maxdel=3, strict=False, segment_width=seg_w)
    batches = [(b.n_reads, b.n_events,
                {w: (s.copy(), c.copy()) for w, (s, c) in b.buckets.items()})
               for b in enc.encode_segments(recs, chunk)]
    ins = ev.group_insertions(enc.insertions, layout)
    return enc, batches, ins, layout


def _corpus():
    text = t_sim.simulate(t_sim.SimSpec(
        n_contigs=3, contig_len=300, n_reads=400, read_len=60,
        ins_read_rate=0.3, del_read_rate=0.2, seed=5))
    extra = t_sim.sam_text([("w", 50), ("v", 9000)], [
        ("w", 0, "3M2I2M", "ACGGTAC"),          # negative POS wraps
        ("w", 48, "2M", "AC"), ("w", 1, "6M2I2M", "ACGGT"),
        ("w", 1, "2M", "ac"), ("zz", 1, "2M", "AC"),   # skipped (permissive)
        ("v", 1, "8200M", "A" * 8200),          # segmented long read
        ("w", 3, "1M4D1M", "A-"),
    ])
    return [text, extra]


@pytest.mark.parametrize("seg_w,chunk", [(0, 100), (-1, 1000), (64, 7)])
def test_read_encoder_rows_and_insertions(seg_w, chunk):
    for text in _corpus():
        got = _encode(t_events, text, t_events.resolve_segment_width(seg_w),
                      chunk)
        want = _encode(r_events, text, r_events.resolve_segment_width(seg_w),
                       chunk)
        assert (got[0].n_reads, got[0].n_skipped) == \
            (want[0].n_reads, want[0].n_skipped)
        assert len(got[1]) == len(want[1])
        for (n1, e1, b1), (n2, e2, b2) in zip(got[1], want[1]):
            assert (n1, e1, sorted(b1)) == (n2, e2, sorted(b2))
            for w in b1:
                _same(b1[w][0], b2[w][0])
                _same(b1[w][1], b2[w][1])
        assert got[0].insertions.motifs == want[0].insertions.motifs
        assert got[0].insertions.local_pos == want[0].insertions.local_pos
        assert got[0].insertions.contig_ids == want[0].insertions.contig_ids
        assert sorted(got[2]) == sorted(want[2])
        for key in want[2]:
            if isinstance(want[2][key], np.ndarray):
                _same(got[2][key], want[2][key])
            else:
                assert got[2][key] == want[2][key]
        _same(got[3].offsets, want[3].offsets)


@pytest.mark.parametrize("value", [0, -5, 1, 33, 100, 4096, 5000])
def test_resolve_segment_width(value):
    assert t_events.resolve_segment_width(value) == \
        r_events.resolve_segment_width(value)


def test_pileup_helpers():
    rng = np.random.default_rng(3)
    for w in (32, 33, 128):
        codes = rng.integers(0, 6, (17, w)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.3] = 255
        _same(t_pileup.pack_nibbles(codes), r_pileup.pack_nibbles(codes))
    for m in (0, 1, 7, 8, 9, 16, 17, 100, 1000, 12345):
        assert t_pileup.round_rows_grid(m) == r_pileup.round_rows_grid(m)
        assert t_pileup.round_rows_pow2(m) == r_pileup.round_rows_pow2(m)
    for n in (0, 1, 2047, 2048, 4_600_000):
        assert t_pileup.padded_total_len(n) == r_pileup.padded_total_len(n)
    assert t_pileup.TILE_POSITIONS == r_mxu.TILE_POSITIONS


def test_threshold_and_vote_helpers():
    ts = [0.25, 1 / 3, 0.999999, 1.0, 5e-324, 2.5]
    _same(t_cutoff.encode_thresholds(ts), r_cutoff.encode_thresholds(ts))
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            t_cutoff.encode_thresholds([bad])
    _same(t_vote.threshold_luts([0.25, 0.7], 5000),
          r_vote.threshold_luts([0.25, 0.7], 5000))
    _same(t_vote.IUPAC_MASK_LUT5, r_vote.IUPAC_MASK_LUT5)
    assert t_vote.FILL_SENTINEL == r_vote.FILL_SENTINEL
    for fill in ("-", "N", "?", "\x00", "ab", "Ā", "b"):
        for space in ("ascii", "code5"):
            assert t_vote.device_fill_code(fill, space) == \
                r_vote.device_fill_code(fill, space)


def test_fused_helpers():
    for n in (0, 1, 2, 3, 1000, 1 << 20, (1 << 20) + 1, 5_000_000):
        assert t_fused.next_pow2(n) == r_fused.next_pow2(n)
        assert t_fused.pad_cap(n) == r_fused.pad_cap(n)
    buf = np.random.default_rng(1).integers(0, 256, 40).astype(np.uint8)
    _same(t_fused.unpack_i32(buf, 10), r_fused.unpack_i32(buf, 10))
    assert t_ik.FUSED_VOTE_MAX_CP == r_pi.FUSED_VOTE_MAX_CP


def test_simulate(tmp_path):
    assert [f.name for f in dataclasses.fields(t_sim.SimSpec)] == \
        [f.name for f in dataclasses.fields(r_sim.SimSpec)]
    assert {k: dataclasses.asdict(v) for k, v in t_sim.BASELINE_SPECS.items()} \
        == {k: dataclasses.asdict(v) for k, v in r_sim.BASELINE_SPECS.items()}
    for kw in ({"n_reads": 300, "contig_len": 500, "seed": 3},
               {"n_reads": 50, "contig_len": 2000, "n_indels": 4, "seed": 9}):
        assert t_sim.simulate(t_sim.SimSpec(**kw)) == \
            r_sim.simulate(r_sim.SimSpec(**kw))
    text = t_sim.sam_text([("r", 5)], [("r", 1, "2M", "AC")], ["@CO\tx"])
    assert text == r_sim.sam_text([("r", 5)], [("r", 1, "2M", "AC")],
                                  ["@CO\tx"])
    p1 = t_sim.write_sam(text, str(tmp_path / "a.sam.gz"))
    p2 = r_sim.write_sam(text, str(tmp_path / "b.sam.gz"))
    import gzip

    assert gzip.open(p1).read() == gzip.open(p2).read()
