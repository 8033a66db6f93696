"""The port's copies of jax-free code equal their originals.

``sam2consensus_torch`` imports nothing from ``sam2consensus_tpu``; the
helpers it needs are copies, each pinned here against the original on the
same inputs (values, shapes and dtypes; behaviour on fixtures where the
copy is code rather than data).
"""

import dataclasses
import io
import os
import time

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


def _blocks(sam, path, max_bytes):
    handle = sam.opener(os.path.join(DATA, path), binary=True)
    try:
        contigs, _n, first = sam.read_header(handle)
        stream = sam.ReadStream(handle, first)
        total = stream.body_bytes_total()
        blocks = [(bytes(b), stream.block_offset)
                  for b in stream.blocks(max_bytes=max_bytes)]
    finally:
        handle.close()
    return [dataclasses.astuple(c) for c in contigs], total, blocks


@pytest.mark.parametrize("path", FIXTURES)
def test_read_stream_blocks(path):
    """Binary handles: the same header, body size and body bytes as the
    reference reader, in blocks of whole lines whose offsets chain; on a
    plain file the very same blocks (mmap windows)."""
    got = _blocks(t_sam, path, 4096)
    want = _blocks(r_sam, path, 4096)
    assert got[:2] == want[:2]
    blocks = got[2]
    body = b"".join(b for b, _ in blocks)
    assert len(blocks) > 1
    assert body == b"".join(b for b, _ in want[2])
    assert all(b.endswith(b"\n") for b, _ in blocks[:-1])
    offsets = [off for _, off in blocks]
    assert offsets == [offsets[0] + sum(len(b) for b, _ in blocks[:i])
                       for i in range(len(blocks))]
    if path.endswith(".sam"):
        assert got == want and got[1] == len(body)


@pytest.mark.parametrize("path", FIXTURES[:3])
def test_read_stream_records_from_bytes(path):
    out = []
    for sam in (t_sam, r_sam):
        handle = sam.opener(os.path.join(DATA, path), binary=True)
        _c, _n, first = sam.read_header(handle)
        stream = sam.ReadStream(handle, first)
        recs = [dataclasses.astuple(r) for r in stream.records()]
        out.append((stream.n_lines, stream.n_bytes, recs))
        handle.close()
    assert out[0] == out[1]
    assert out[0][2] == _records(t_sam, path)[2]


def test_insertion_events_merge():
    """Python-list and array-chunk insertions merge like the reference's."""
    stores = []
    for ev in (t_events, r_events):
        a = ev.InsertionEvents([0, 1], [5, -2], ["AC", "G"])
        b = ev.InsertionEvents([2], [7], ["TTT"])
        b.array_chunks.append((np.array([1, 0], np.int32),
                               np.array([3, 9], np.int32),
                               np.array([2, 1], np.int32),
                               np.frombuffer(b"GAT", np.uint8).copy()))
        a.extend(b)
        stores.append((len(a), a.to_arrays()))
    assert stores[0][0] == stores[1][0] == 5
    for x, y in zip(stores[0][1], stores[1][1]):
        _same(x, y)


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


@pytest.mark.parametrize("name", [
    "TILE_POSITIONS", "MAX_BLOWUP", "TILE_CHUNK"])
def test_mxu_constants(name):
    from sam2consensus_torch.ops import mxu_pileup as t_mxu

    assert getattr(t_mxu, name) == getattr(r_mxu, name)


@pytest.mark.parametrize("attr", [
    "TilePlan", "_plan_prelude", "plan_tiles", "SlotPlan", "assign_slots",
    "plan_slots"])
def test_mxu_planner_copies(attr):
    """The MXU pileup's host planning is the reference's code."""
    from sam2consensus_torch.ops import mxu_pileup as t_mxu

    assert _src(getattr(t_mxu, attr), "sam2consensus_torch") == \
        _src(getattr(r_mxu, attr), "sam2consensus_tpu")


@pytest.mark.parametrize("attr", ["PileupAutoTuner", "run_tuned_slab"])
def test_autotune_copies(attr):
    """The autotuner's state machine and its shared slab driver are the
    reference's code."""
    assert _src(getattr(t_pileup, attr), "sam2consensus_torch") == \
        _src(getattr(r_pileup, attr), "sam2consensus_tpu")


def test_plan_mxu_grids_copy():
    from sam2consensus_torch.parallel import base as t_pbase
    from sam2consensus_tpu.parallel import base as r_pbase

    assert _src(t_pbase.plan_mxu_grids, "sam2consensus_torch") == \
        _src(r_pbase.plan_mxu_grids, "sam2consensus_tpu")


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
    for out_enc in (None, 1024, "packed5"):
        assert t_fused.sym_space(out_enc) == r_fused._sym_space(out_enc)
        assert t_fused.dash_code(out_enc) == r_fused._dash_code(out_enc)


def test_wire_codec_constants_and_encode():
    """The codec's lane constants, and ``encode_slab`` on an unsorted
    slab with escapes, field by field."""
    from sam2consensus_torch.wire import codec as t_codec
    from sam2consensus_tpu.wire import codec as r_codec

    for name in ("CODECS", "DELTA_ESCAPE", "SAVED_BYTES_PER_CELL"):
        assert getattr(t_codec, name) == getattr(r_codec, name)
    for name in ("WIRE2_TO_CODE", "CODE_TO_WIRE2", "IS_ACGT"):
        _same(getattr(t_codec, name), getattr(r_codec, name))
    rng = np.random.default_rng(12)
    starts = rng.integers(0, 1 << 18, 96).astype(np.int32)
    codes = rng.choice(np.array([0, 1, 2, 3, 4, 5, 255], np.uint8),
                       (96, 64), p=[.02, .24, .24, .24, .02, .24, 0])
    codes[:, 50:] = 255
    for chunks in (1, 2, 3):
        got = t_codec.encode_slab(starts, codes, chunks)
        want = r_codec.encode_slab(starts, codes, chunks)
        if want is None:
            assert got is None
            continue
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                _same(a, b)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("mode", ["auto", "packed5", "delta8"])
def test_wire_resolve_codec(monkeypatch, mode):
    """``resolve_codec`` with the port's constants set to the reference's
    defaults (its saving a cell priced against packed5 in place of the
    port's against the raw rows) and none of the reference's environment
    overrides."""
    from sam2consensus_torch.wire import codec as t_codec
    from sam2consensus_tpu.wire import codec as r_codec

    for key in ("S2C_WIRE", "S2C_WIRE_DEV_NS", "S2C_WIRE_HOST_NS",
                "S2C_WIRE_SAVED_BPC"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(t_codec, "WIRE_DEV_NS", 1.5)
    monkeypatch.setattr(t_codec, "WIRE_HOST_NS", 2.0)
    monkeypatch.setattr(t_codec, "ROWS_SAVED_BYTES_PER_CELL",
                        r_codec.SAVED_BYTES_PER_CELL)
    for link_free in (False, True):
        for bps in (None, 1e6, 71e6, 72e6, 38.2e9):
            assert t_codec.resolve_codec(mode, bps, link_free) == \
                r_codec.resolve_codec(mode, bps, link_free)


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


# -- BAM and BGZF input, the stager ------------------------------------------
BAMS = [f"formats_{fam}.bam" for fam in ("short", "longread", "adversarial")]


def test_cigar_bam_helpers():
    assert t_cigar.BAM_OPS == r_cigar.BAM_OPS
    for ops in ((), ((5, "M"),), ((2, "S"), (3, "M"), (1, "I"), (0, "D"),
                                  (7, "="), (1, "X"), (2, "H"))):
        assert t_cigar.render_ops(ops) == r_cigar.render_ops(ops)


def test_encoder_helpers():
    assert t_events.MIN_BUCKET_W == r_events.MIN_BUCKET_W
    for span in (1, 31, 32, 33, 100, 4096, 4097):
        assert t_events._bucket_width(span) == r_events._bucket_width(span)
    assert issubclass(t_events.EncodeError, ValueError)
    assert t_events.EncodeError.__mro__[1:] == r_events.EncodeError.__mro__[1:]
    for line in ("@SQ\tSN:chr1\tLN:100", "@SQ\tSN:a b\tLN: 7\n",
                 "@SQ\tSN:x\tLN:0\tAS:y"):
        assert dataclasses.astuple(t_sam.parse_sq_line(line)) == \
            dataclasses.astuple(r_sam.parse_sq_line(line))


def test_resolve_decode_threads(monkeypatch):
    monkeypatch.delenv("S2C_DECODE_THREADS_CAP", raising=False)
    for n in (0, 1, 3, -2):
        cfg = t_config.RunConfig(decode_threads=n)
        assert t_config.resolve_decode_threads(cfg) == \
            r_config.resolve_decode_threads(cfg)


def test_shared_pool():
    from sam2consensus_torch import ingest as t_ingest

    assert t_ingest.shared_pool(1) is None
    pool = t_ingest.shared_pool(2)           # the process-wide pool, >= 2
    n = t_ingest._pool_workers
    assert t_ingest.shared_pool(2) is pool and t_ingest.shared_pool(n) is pool
    assert t_ingest.pool_submit(n + 1, lambda a, b: a * b, 6, 7).result() \
        == 42
    assert t_ingest.shared_pool(2) is not pool        # grown, never shrunk
    assert t_ingest._pool_workers == n + 1
    with pytest.raises(ValueError):
        t_ingest.pool_submit(1, print)


@pytest.mark.parametrize("path", FIXTURES[1::3] + BAMS)
def test_bgzf_blocks(path):
    from sam2consensus_torch.formats import bgzf as t_bgzf
    from sam2consensus_tpu.formats import bgzf as r_bgzf

    full = os.path.join(DATA, path)
    assert t_bgzf.is_bgzf(full) == r_bgzf.is_bgzf(full)
    with open(full, "rb") as fh:
        data = fh.read()
    for head in (data[:64], data[:17], b"\x1f\x8b\x08\x04" + b"\x00" * 60):
        assert t_bgzf.sniff_bgzf(head) == r_bgzf.sniff_bgzf(head)
    blocks = t_bgzf.scan_blocks(io.BytesIO(data))
    assert blocks == r_bgzf.scan_blocks(io.BytesIO(data))
    for off, n in blocks[:3] + blocks[-1:]:
        assert t_bgzf.inflate_block(data[off:off + n], off) == \
            r_bgzf.inflate_block(data[off:off + n], off)
    assert (t_bgzf.BGZF_EOF, t_bgzf.MAX_BLOCK_UDATA) == \
        (r_bgzf.BGZF_EOF, r_bgzf.MAX_BLOCK_UDATA)


def test_bgzf_writers(tmp_path):
    from sam2consensus_torch.formats import bgzf as t_bgzf
    from sam2consensus_tpu.formats import bgzf as r_bgzf

    data = bytes(np.random.default_rng(5).integers(0, 4, 200_000)
                 .astype(np.uint8) + 65)
    for level in (1, 6):
        assert t_bgzf.compress_block(data[:65280], level) == \
            r_bgzf.compress_block(data[:65280], level)
    p1 = t_bgzf.write_bgzf(data, str(tmp_path / "t.gz"), block_udata=9000)
    p2 = r_bgzf.write_bgzf(data, str(tmp_path / "r.gz"), block_udata=9000)
    assert open(p1, "rb").read() == open(p2, "rb").read()


@pytest.mark.parametrize("path", BAMS)
def test_bam_header_and_field_decoders(path):
    from sam2consensus_torch.formats import bam as t_bam
    from sam2consensus_torch.formats import bgzf as t_bgzf
    from sam2consensus_tpu.formats import bam as r_bam

    for name in ("BAM_MAGIC", "NIB_TO_CHAR", "NIB_TO_CODE", "CHAR_TO_NIB"):
        got, want = getattr(t_bam, name), getattr(r_bam, name)
        if isinstance(want, np.ndarray):
            _same(got, want)
        else:
            assert got == want
    reader = t_bgzf.BgzfReader(os.path.join(DATA, path))
    try:
        data = reader.read()
    finally:
        reader.close()
    hdr = io.BytesIO(data)
    contigs, text = t_bam.read_bam_header(hdr)
    hdr2 = io.BytesIO(data)
    r_contigs, r_text = r_bam.read_bam_header(hdr2)
    assert [dataclasses.astuple(c) for c in contigs] == \
        [dataclasses.astuple(c) for c in r_contigs] and text == r_text
    buf = np.frombuffer(data, np.uint8)
    t_idx = t_bam._RecordIndex(buf[hdr.tell():], 0)
    r_idx = r_bam._RecordIndex(buf[hdr2.tell():], 0)
    for name in ("off", "refid", "pos", "l_rn", "n_cig", "l_seq"):
        _same(getattr(t_idx, name), getattr(r_idx, name))
    assert (t_idx.n, t_idx.consumed) == (r_idx.n, r_idx.consumed)
    body = buf[hdr.tell():]
    for k in range(0, t_idx.n, max(1, t_idx.n // 25)):
        cig = int(t_idx.off[k] + 36 + t_idx.l_rn[k])
        seq = cig + 4 * int(t_idx.n_cig[k])
        assert t_bam.decode_ops(body, cig, int(t_idx.n_cig[k])) == \
            r_bam.decode_ops(body, cig, int(r_idx.n_cig[k]))
        assert t_bam.decode_seq(body, seq, int(t_idx.l_seq[k])) == \
            r_bam.decode_seq(body, seq, int(r_idx.l_seq[k]))


@pytest.mark.parametrize("path", FIXTURES[::3])
def test_bam_writers(path, tmp_path):
    from sam2consensus_torch.formats import bam as t_bam
    from sam2consensus_tpu.formats import bam as r_bam

    with open(os.path.join(DATA, path)) as fh:
        text = fh.read()
    got, want = t_bam.sam_text_to_records(text), \
        r_bam.sam_text_to_records(text)
    assert got[1] == want[1]
    assert [dataclasses.astuple(c) for c in got[0]] == \
        [dataclasses.astuple(c) for c in want[0]]
    assert t_bam.bam_payload(*got) == r_bam.bam_payload(*want)
    assert t_bam.encode_bam_record(2, 9, "3S4M1I2D", "ACGTNAC=") == \
        r_bam.encode_bam_record(2, 9, "3S4M1I2D", "ACGTNAC=")
    p1 = t_bam.sam_text_to_bam(text, str(tmp_path / "t.bam"))
    p2 = r_bam.sam_text_to_bam(text, str(tmp_path / "r.bam"))
    assert open(p1, "rb").read() == open(p2, "rb").read()
    codes = np.random.default_rng(2).integers(0, 6, (9, 150)).astype(np.uint8)
    starts = np.arange(9, dtype=np.int64) * 1000
    for a, b in zip(t_bam._segment_matrix(starts, codes, 64),
                    r_bam._segment_matrix(starts, codes, 64)):
        _same(a, b)


def test_formats_helpers(tmp_path):
    from sam2consensus_torch import formats as t_formats
    from sam2consensus_tpu import formats as r_formats

    assert t_formats.FORMATS == r_formats.FORMATS
    for name in ("x.bam", "x.sam.gz", "x.sam", "y.sam.bgzf", "z.gz"):
        (tmp_path / name).write_bytes(b"")
    for name in ("x.bam", "x.sam.gz", "y.sam.bgzf.gz", "z.gz", "w.bam",
                 "x.sam"):
        p = str(tmp_path / name)
        assert t_formats.sibling_sam(p) == r_formats.sibling_sam(p)


def test_stage_slots_defaults():
    from sam2consensus_torch.wire import pipeline as t_pipe
    from sam2consensus_tpu.wire import pipeline as r_pipe

    assert t_pipe.DEFAULT_SLOTS == r_pipe.DEFAULT_SLOTS
    assert [n for n in dir(t_pipe.StageSlots) if not n.startswith("__")] \
        == [n for n in dir(r_pipe.StageSlots) if not n.startswith("__")]


def test_segment_batch_fields():
    """The batch carries the fused count's ``accumulated`` flag; ``staged``
    holds the port's own staged operands."""
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(t_events.SegmentBatch)[:4] == \
        spec(r_events.SegmentBatch)[:4]
    assert [f.name for f in dataclasses.fields(t_events.SegmentBatch)] == \
        [f.name for f in dataclasses.fields(r_events.SegmentBatch)]


@pytest.mark.parametrize("total_len,env", [(1000, None), ((1 << 23) - 1, None),
                                           (1 << 23, None), (1000, "1"),
                                           (1000, "1001")])
def test_fused_direct_mode(monkeypatch, total_len, env):
    from sam2consensus_torch.encoder import native_encoder as t_nat
    from sam2consensus_tpu.encoder import native_encoder as r_nat

    # the reference reads its threshold from the environment, the port
    # from a module constant: pin both to the same number
    if env is None:
        monkeypatch.delenv("S2C_FUSED_DIRECT_MIN_LEN", raising=False)
    else:
        monkeypatch.setenv("S2C_FUSED_DIRECT_MIN_LEN", env)
        monkeypatch.setattr(t_nat, "FUSED_DIRECT_MIN_LEN", int(env))
    assert t_nat.fused_direct_mode(total_len) == \
        r_nat.fused_direct_mode(total_len)


@pytest.mark.parametrize("name", [
    "s2c_decode", "s2c_decode_bam", "s2c_accumulate_rows", "s2c_ins_table",
    "s2c_ins_vote", "s2c_merge_u8", "s2c_snap_shards", "s2c_cov_sums",
    "s2c_finalize", "s2c_vote"])
def test_native_bindings(name):
    """Every export the port calls is bound with the reference's C
    signature."""
    from sam2consensus_torch import native as t_native
    from sam2consensus_tpu import native as r_native

    t_lib, r_lib = t_native.load(), r_native.load()
    if t_lib is None or r_lib is None:
        pytest.skip("the native library does not build here")

    def sig(lib):
        fn = getattr(lib, name)
        return fn.restype, [(getattr(a, "_dtype_", None),
                             getattr(a, "__name__", None))
                            for a in fn.argtypes]

    assert sig(t_lib) == sig(r_lib)


# -- the failure-handling copies -------------------------------------------
def test_faultinject_tables():
    from sam2consensus_torch.resilience import faultinject as t_fi
    from sam2consensus_tpu.resilience import faultinject as r_fi

    assert t_fi.SITES == r_fi.SITES and t_fi.KINDS == r_fi.KINDS
    assert t_fi.PERSISTENT == r_fi.PERSISTENT
    for kind in r_fi.KINDS:
        t_cls, t_msg = t_fi._KIND_EXC[kind]
        r_cls, r_msg = r_fi._KIND_EXC[kind]
        assert t_msg == r_msg
        assert [c.__name__ for c in t_cls.__mro__] \
            == [c.__name__ for c in r_cls.__mro__]


@pytest.mark.parametrize("spec", [
    "pileup_dispatch:rpc:3:2, vote:fatal:0:inf", "vote:rpc:p0.25",
    "accumulate:oom:0:*", "bam_inflate:timeout:7:-1", "mem_alloc:trace:1"])
def test_parse_spec_rules(spec):
    from sam2consensus_torch.resilience import faultinject as t_fi
    from sam2consensus_tpu.resilience import faultinject as r_fi

    def rules(mod):
        return [(r.site, r.kind, r.after_n, r.prob, r.times)
                for r in mod.parse_spec(spec)]

    assert rules(t_fi) == rules(r_fi)


def test_policy_tables():
    from sam2consensus_torch.resilience import policy as t_pol
    from sam2consensus_tpu.resilience import policy as r_pol

    for name in ("TRANSIENT", "CAPACITY", "FATAL", "PASSTHROUGH", "DATA",
                 "_TRANSIENT_STATUS"):
        assert getattr(t_pol, name) == getattr(r_pol, name)
    assert t_pol._TRANSIENT_RE.pattern == r_pol._TRANSIENT_RE.pattern
    assert t_pol._CAPACITY_RE.pattern == r_pol._CAPACITY_RE.pattern
    assert t_pol._PASSTHROUGH_TYPES == r_pol._PASSTHROUGH_TYPES
    for kw in (dict(), dict(retries=0, on_error="fail"),
               dict(retries=5, backoff=0.5, on_error="fallback")):
        a, b = t_pol.RetryPolicy(**kw), r_pol.RetryPolicy(**kw)
        assert (a.retries, a.backoff, a.max_backoff, a.jitter, a.on_error) \
            == (b.retries, b.backoff, b.max_backoff, b.jitter, b.on_error)


def test_policy_from_config_env(monkeypatch):
    from sam2consensus_torch.resilience import policy as t_pol
    from sam2consensus_tpu.resilience import policy as r_pol

    """The seed comes from S2C_FAULT_SEED as in the reference; the port
    reads neither S2C_ON_DEVICE_ERROR nor S2C_ATTEMPT_DEADLINE_S, so the
    configured mode stands and no attempt runs on a watchdog thread."""
    monkeypatch.setenv("S2C_ON_DEVICE_ERROR", "fallback")
    monkeypatch.setenv("S2C_ATTEMPT_DEADLINE_S", "2.5")
    monkeypatch.setenv("S2C_FAULT_SEED", "9")
    a = t_pol.RetryPolicy.from_config(
        t_config.RunConfig(retries=4, on_device_error="fail"))
    b = r_pol.RetryPolicy.from_config(
        r_config.RunConfig(retries=4, on_device_error="retry"))
    assert (a.on_error, a.retries, b.on_error) == ("fail", 0, "fallback")
    a = t_pol.RetryPolicy.from_config(t_config.RunConfig(retries=4))
    assert not hasattr(a, "deadline_s")
    assert (a.retries, a.seed, [a.delay(i) for i in range(4)]) == \
        (b.retries, b.seed, [b.delay(i) for i in range(4)])


def test_checkpoint_constants():
    from sam2consensus_torch.utils import checkpoint as t_ck
    from sam2consensus_tpu.utils import checkpoint as r_ck

    assert t_ck._FILE == r_ck._FILE
    assert t_ck.path_for("d") == r_ck.path_for("d")
    arrays = (np.arange(12, dtype=np.int32), np.zeros(3, np.uint8))
    assert t_ck._payload_digest(arrays) == r_ck._payload_digest(arrays)
    assert [f.name for f in dataclasses.fields(t_ck.CheckpointState)] == \
        [f.name for f in dataclasses.fields(r_ck.CheckpointState)]


@pytest.mark.parametrize("exc", [
    UnicodeDecodeError("ascii", b"\xff", 0, 1, "bad"),
    KeyError("unknown reference 'x'"), ValueError("outside reference"),
    KeyError("'!' out-of-alphabet"), ValueError("BAM record at offset 3"),
    ValueError("bad CIGAR op code 12"), ValueError("invalid literal for int"),
    IndexError("list index out of range"), KeyError("Z"),
    RuntimeError("other")], ids=lambda e: type(e).__name__ + str(e)[:12])
def test_classify_reason(exc):
    from sam2consensus_torch.ingest import badrecords as t_bad
    from sam2consensus_tpu.ingest import badrecords as r_bad

    assert t_bad.classify_reason(exc) == r_bad.classify_reason(exc)


def test_badrecords_tables():
    from sam2consensus_torch.ingest import badrecords as t_bad
    from sam2consensus_tpu.ingest import badrecords as r_bad

    assert t_bad.MODES == r_bad.MODES
    assert t_bad.C_REASONS == r_bad.C_REASONS
    assert t_bad.RECORD_ERRORS == r_bad.RECORD_ERRORS
    assert t_bad.DEFAULT_SIDECAR_MAX == r_bad.DEFAULT_SIDECAR_MAX
    for spec in ("", "7", "2.5%", "0"):
        assert t_bad.parse_budget(spec) == r_bad.parse_budget(spec)


def _fill_sink(bad, tmp_path, tag, sidecar_max):
    pol = bad.BadRecordPolicy(mode="quarantine", max_pct=0.5,
                              sidecar_path=str(tmp_path / tag / "q.jsonl"),
                              sidecar_max=sidecar_max)
    sink = bad.QuarantineSink(pol)
    for k in range(12):
        sink.record(f"line{k}\tx\n", KeyError(f"'{k}'"),
                    partition=(k % 3,), offset=10 * k)
    sink.clear_partition((2,))
    summary = sink.finish(100)
    text = open(tmp_path / tag / "q.jsonl").read().replace(
        str(tmp_path / tag), "<d>")
    return summary["bad_records"], summary["truncated"], text


@pytest.mark.parametrize("sidecar_max", [3, 100])
def test_quarantine_sink_sidecar_bytes(tmp_path, sidecar_max):
    from sam2consensus_torch.ingest import badrecords as t_bad
    from sam2consensus_tpu.ingest import badrecords as r_bad

    assert _fill_sink(t_bad, tmp_path, "t", sidecar_max) == \
        _fill_sink(r_bad, tmp_path, "r", sidecar_max)


def test_metrics_registry():
    import importlib

    # the packages' ``metrics()`` functions shadow the submodule's name
    t_m = importlib.import_module("sam2consensus_torch.observability.metrics")
    r_m = importlib.import_module("sam2consensus_tpu.observability.metrics")
    snaps = []
    for mod in (t_m, r_m):
        reg = mod.MetricsRegistry()
        reg.add("a/b", 2)
        reg.add("a/b", 3)
        reg.gauge("g").set(4.5)
        reg.gauge("g").set_info({"x": 1})
        for v in range(50):
            reg.observe("h", v * 0.5)
        snaps.append((reg.snapshot(), reg.value("a/b"), reg.info("g")))
    assert snaps[0] == snaps[1]


def test_cli_failure_flags():
    """The eleven failure-handling flags: the reference's names, dests,
    defaults, choices, types and help (the port's checkpoint help drops
    the reference's "(jax backend)", and its --on-device-error help the
    S2C_ON_DEVICE_ERROR override, which the port does not read)."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    flags = ("--on-bad-record", "--max-bad-records", "--quarantine-out",
             "--checkpoint-dir", "--checkpoint-every", "--incremental",
             "--paranoid", "--retries", "--retry-backoff",
             "--on-device-error", "--fault-inject")

    def table(parser):
        acts = {s: a for a in parser._actions for s in a.option_strings}
        return [(f, acts[f].dest, acts[f].default, acts[f].choices,
                 acts[f].type, acts[f].nargs,
                 acts[f].help.replace(" (jax backend)", "").replace(
                     " Env S2C_ON_DEVICE_ERROR overrides.", ""))
                for f in flags]

    assert table(t_cli.build_parser()) == table(r_cli.build_parser())


# -- observability (the tracer, exports, ledger, manifest, memory plane,
# -- rate card, logging, link probe, kernel-build cache) -------------------
def _obs_modules(name):
    import importlib

    return tuple(importlib.import_module(f"{pkg}.observability.{name}")
                 for pkg in ("sam2consensus_torch", "sam2consensus_tpu"))


def test_cli_observability_flags():
    """The six observability flags: the reference's names, dests,
    defaults, choices and help (``--profile-dir`` names torch.profiler,
    not jax.profiler)."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    flags = ("--json-metrics", "--profile-dir", "--trace-out",
             "--metrics-out", "--log-level", "--log-format")

    def table(parser):
        acts = {s: a for a in parser._actions for s in a.option_strings}
        rows = []
        for f in flags:
            a = acts[f]
            help_ = a.help
            if f == "--profile-dir":
                help_ = "profiler" in help_ and "directory" in help_
            rows.append((f, a.dest, a.default, a.choices, a.type, help_))
        return rows

    assert table(t_cli.build_parser()) == table(r_cli.build_parser())


def test_trace_copy():
    t_tr, r_tr = _obs_modules("trace")
    assert t_tr.Span.__slots__ == r_tr.Span.__slots__
    pub = {n for n in dir(r_tr.Tracer) if not n.startswith("__")}
    assert pub == {n for n in dir(t_tr.Tracer) if not n.startswith("__")}


def _record(trace_mod):
    tr = trace_mod.Tracer(enabled=True)
    tr.name_thread("main")
    with tr.span("outer", k=1) as sp:
        sp.event("inside", x=np.int64(2))
        with tr.span("inner"):
            pass
    tr.event("top", chosen="cpu")
    tr.complete("done", time.perf_counter() - 0.001, rows=3)
    return tr


def test_export_copy():
    t_ex, r_ex = _obs_modules("export")
    t_tr, r_tr = _obs_modules("trace")

    def shape(events):
        return [(e["ph"], e["name"], e.get("args"), e.get("s"))
                for e in events]

    got = t_ex.chrome_trace_events(_record(t_tr), pid=1)
    want = r_ex.chrome_trace_events(_record(r_tr), pid=1)
    assert sorted(map(repr, shape(got))) == sorted(map(repr, shape(want)))
    for value in (np.int32(3), np.float64(0.5), np.arange(3), object):
        got, want = t_ex._json_default(value), r_ex._json_default(value)
        assert got == want or (value is object and isinstance(got, str))


@pytest.mark.parametrize("spec,counters", [
    ({"counters": ["a", "b"]}, {"a": 1.0, "b": 2.0}),
    ({"counters": ["z"]}, {"a": 1.0}),
    ({"num": ["a"], "den": ["b"]}, {"a": 6.0, "b": 2.0}),
    ({"num": ["a"], "den": ["b"]}, {"a": 6.0}),
    ({"num": ["a"], "den": ["b"], "min_num": 10}, {"a": 6.0, "b": 2.0}),
    ("bad", {}),
])
def test_ledger_eval_measured(spec, counters):
    t_l, r_l = _obs_modules("ledger")
    assert t_l._eval_measured(spec, counters) == \
        r_l._eval_measured(spec, counters)


def test_ledger_copy(monkeypatch):
    t_l, r_l = _obs_modules("ledger")
    for name in ("DEFAULT_DRIFT_BAND", "DEFAULT_DRIFT_MIN_SEC"):
        assert getattr(t_l, name) == getattr(r_l, name)
    for band in ("0.5", "3", "x"):
        monkeypatch.setenv("S2C_DRIFT_BAND", band)
        monkeypatch.setenv("S2C_DRIFT_MIN_SEC", band)
        assert t_l.drift_band() == r_l.drift_band()
        assert t_l.drift_min_sec() == r_l.drift_min_sec()
    monkeypatch.delenv("S2C_DRIFT_BAND")
    monkeypatch.delenv("S2C_DRIFT_MIN_SEC")
    out = []
    for led_mod, obs_pkg in ((t_l, "sam2consensus_torch"),
                             (r_l, "sam2consensus_tpu")):
        import importlib

        m = importlib.import_module(f"{obs_pkg}.observability.metrics")
        reg = m.MetricsRegistry()
        reg.add("phase/vote_sec", 0.5)
        reg.add("wire/bytes", 9e6)
        reg.add("phase/stage_sec", 1.0)
        led = led_mod.DecisionLedger()
        led.record("tail_placement", "cpu", inputs={"n": 1},
                   predicted={"sec": 0.1, "none": None},
                   alternatives={"cpu": 0.1},
                   measured={"sec": {"counters": ["phase/vote_sec"]}},
                   provenance={"source": "default", "key": "k"})
        led.record("link_constants", "probed", predicted={"bps": 1e6},
                   measured={"bps": {"num": ["wire/bytes"],
                                     "den": ["phase/stage_sec"]}}, band=0)
        recs = led_mod.finalize(led, reg)
        snap = reg.snapshot()
        out.append(([r.to_dict() for r in recs], snap))
    assert out[0] == out[1]


def test_manifest_copy():
    t_m, r_m = _obs_modules("manifest")
    assert t_m.SCHEMA == r_m.SCHEMA and t_m._ENV_PREFIXES == \
        r_m._ENV_PREFIXES
    assert t_m._ENV_EXACT == ("CUDA_VISIBLE_DEVICES",
                              "PYTORCH_CUDA_ALLOC_CONF",
                              "TORCH_CUDA_ARCH_LIST")
    assert t_m.manifest_path_for("a/m.jsonl") == \
        r_m.manifest_path_for("a/m.jsonl")
    t_met, r_met = _obs_modules("metrics")
    mans = []
    for man, met in ((t_m, t_met), (r_m, r_met)):
        reg = met.MetricsRegistry()
        reg.add("phase/decode_sec", 0.25)
        reg.add("wire/bytes", 10)
        reg.add("mem/peak_tracked_bytes", 99)
        reg.add("ingest/bad_records", 2)
        reg.add("drift/events", 1)
        reg.gauge("mem/rss_mb").set(5.0)
        reg.gauge("quarantine/summary").set_info({"mode": "skip"})
        m = man.build_manifest(reg, [], meta={"backend": "x"},
                               config={"a": 1}, artifacts={})
        for key in ("created_unix", "git", "env_overrides", "link"):
            m.pop(key)
        mans.append(m)
    assert mans[0] == mans[1]


def test_telemetry_copy(tmp_path):
    import logging

    t_t, r_t = _obs_modules("telemetry")
    t_tr, r_tr = _obs_modules("trace")
    for tel in (t_t, r_t):
        p = tmp_path / f"{tel.__name__}.txt"
        tel.atomic_write_text(str(p), "x\ny")
        assert p.read_text() == "x\ny"
    rec = logging.LogRecord("lg", logging.WARNING, __file__, 1, "m %s",
                            ("a",), None)
    lines = []
    for tel, tr in ((t_t, t_tr), (r_t, r_tr)):
        tel.set_log_context(job_id="j", tenant=None)
        try:
            with tr.Tracer(enabled=True).span("s"):
                lines.append(tel.JsonLogFormatter().format(rec))
            assert tel.get_log_context() == {"job_id": "j"}
        finally:
            tel.set_log_context()
    assert lines[0] == lines[1]


def test_ratecard_copy():
    t_rc, r_rc = _obs_modules("ratecard")
    for name in ("SCHEMA", "RATE_KEYS", "DEFAULT_ALPHA",
                 "DEFAULT_MIN_SAMPLES", "MIN_WIRE_BYTES"):
        assert getattr(t_rc, name) == getattr(r_rc, name)
    assert t_rc.max_age_sec() == r_rc.max_age_sec()
    assert t_rc.min_samples() == r_rc.min_samples()
    snap = {"counters": {"phase/decode_sec": 0.5, "pileup/cells": 2e6,
                         "phase/pileup_dispatch_sec": 0.1,
                         "phase/vote_sec": 0.2, "wire/bytes": 5e6,
                         "phase/stage_sec": 0.05},
            "gauges": {"residual/capacity/bytes": {"value": 0.4}}}
    out = []
    for rc in (t_rc, r_rc):
        card = rc.RateCard(worker="w")
        card.created_unix = 0.0
        seen = card.observe_job(snap, 2.0, input_bytes=int(1e8),
                                decode_cores=2, now=100.0)
        for x in (3.0, -1.0, float("nan"), 5.0):
            card.observe("link_bps", x, now=101.0)
        out.append((seen, card.to_blob(now=102.0), card.snapshot(now=102.0),
                    card.consult("link_bps", 1.0, now=102.0)))
    assert out[0] == out[1]


def test_memplane_copy():
    t_mp, r_mp = _obs_modules("memplane")
    for name in ("MEM_DUMP_SCHEMA", "MEM_DUMP_NAME", "HISTORY_CAP"):
        assert getattr(t_mp, name) == getattr(r_mp, name)
    assert set(t_mp.FAMILIES) <= set(r_mp.FAMILIES)
    batch = t_events.SegmentBatch(
        buckets={32: (np.zeros(4, np.int32), np.zeros((4, 32), np.uint8))})
    assert t_mp.batch_nbytes(batch) == r_mp.batch_nbytes(batch) == 144
    cur, peak = t_mp.rss_bytes()
    assert cur >= 0 and peak > 0
    for mod in (t_mp, r_mp):
        mod._reset_for_tests()
    assert set(t_mp.summary()) == set(r_mp.summary())
    for mod in (t_mp, r_mp):
        mod._reset_for_tests()


@pytest.mark.parametrize("total_len", [1_000, 200_000, 4_600_000])
def test_plan_mesh_shards_copy(monkeypatch, total_len):
    """``plan_mesh_shards`` over one table of components (the reference's
    capacity model's, both modules' ``predict_run_peak_bytes`` replaced by
    it): the same plan at every budget between, below and above the
    per-host figures and at every host cap."""
    t_mp, r_mp = _obs_modules("memplane")
    _total, comp = r_mp.predict_run_peak_bytes(total_len)

    def model(*_a, **_k):
        return sum(comp.values()), dict(comp)

    monkeypatch.setattr(t_mp, "predict_run_peak_bytes", model)
    monkeypatch.setattr(r_mp, "predict_run_peak_bytes", model)
    probe = r_mp.plan_mesh_shards(total_len, None, max_hosts=4,
                                  record=False)
    alt = sorted(probe["alternatives"].values())
    budgets = [0, 1, *(int(a) for a in alt), *(int(a) + 1 for a in alt),
               1 << 40]
    for budget in budgets:
        for hosts in (0, 1, 2, 4):
            assert t_mp.plan_mesh_shards(total_len, None, budget, hosts,
                                         record=False) == \
                r_mp.plan_mesh_shards(total_len, None, budget, hosts,
                                      record=False)


def test_linkprobe_copy(monkeypatch):
    from sam2consensus_torch.utils import linkprobe as t_lp
    from sam2consensus_tpu.utils import linkprobe as r_lp

    assert t_lp.PROBE_BYTES == r_lp.PROBE_BYTES
    for age in (None, "60"):
        if age is None:
            monkeypatch.delenv("S2C_LINK_CACHE_MAX_AGE", raising=False)
        else:
            monkeypatch.setenv("S2C_LINK_CACHE_MAX_AGE", age)
        assert t_lp.cache_max_age() == r_lp.cache_max_age()
    t_lp._reset_for_tests()
    r_lp._reset_for_tests()
    assert t_lp.link_info() == r_lp.link_info()


def test_jitcache_counter_names():
    t_jc, r_jc = _obs_modules("jitcache")
    assert set(r_jc._EVENT_COUNTERS.values()) == {
        "compile/persist_hit", "compile/persist_miss"}


def test_publish_stats_extra_copy():
    """The port's view equals the reference's on a registry that holds
    every family, when the backend set none of the keys itself."""
    from sam2consensus_torch import observability as t_obs
    from sam2consensus_tpu import observability as r_obs

    extras = []
    for obs in (t_obs, r_obs):
        robs = obs.start_run()
        try:
            reg = obs.metrics()
            for name, v in (("phase/decode_sec", 0.123456),
                            ("resilience/retries", 2.0),
                            ("wire/bytes", 10.0), ("wire/ratio", 0.12345),
                            ("mem/peak_tracked_bytes", 7.0),
                            ("reads/mapped", 3.0)):
                reg.add(name, v)
            reg.gauge("dispatch/pileup").set_info({"path": "device"})
            reg.gauge("residual/wire_codec/ratio").set(0.5)
            reg.gauge("residual/wire_codec").set_info({"x": 1})
            reg.gauge("mem/peak_rss_mb").set(12.5)
            reg.gauge("mem/live_bytes/counts").set(4.0)
            extra = {}
            obs.publish_stats_extra(extra)
            extras.append(extra)
        finally:
            obs.finish_run(robs)
    assert extras[0] == extras[1]
    kept = {"pileup_path": "host", "decode_sec": 9.0}
    from sam2consensus_torch import observability as t_obs

    robs = t_obs.start_run()
    try:
        t_obs.metrics().add("phase/decode_sec", 1.0)
        t_obs.metrics().gauge("dispatch/pileup").set_info({"path": "d"})
        t_obs.publish_stats_extra(kept)
    finally:
        t_obs.finish_run(robs)
    assert kept == {"pileup_path": "host", "decode_sec": 9.0}


@pytest.mark.parametrize("level,fmt", [("loud", "text"), (None, "xml")])
def test_configure_logging_errors(level, fmt):
    from sam2consensus_torch import observability as t_obs
    from sam2consensus_tpu import observability as r_obs

    msgs = []
    for obs in (t_obs, r_obs):
        with pytest.raises(SystemExit) as exc:
            obs.configure_logging(level, fmt)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------- serve --
def _code(source: str) -> str:
    """The code of ``source``: its syntax tree without docstrings (the
    copies' prose may name their place in the port; comments are not in
    the tree)."""
    import ast
    import textwrap

    tree = ast.parse(textwrap.dedent(source))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def _body(module, pkg):
    """A module's code, the package renamed."""
    import inspect

    return _code(inspect.getsource(module).replace(pkg, "PKG"))


def _src(obj, pkg):
    import inspect

    return _code(inspect.getsource(obj).replace(pkg, "PKG"))


def _pair(name):
    import importlib

    return tuple(importlib.import_module(f"{pkg}.{name}")
                 for pkg in ("sam2consensus_torch", "sam2consensus_tpu"))


@pytest.mark.parametrize("name", ["serve.admission", "serve.health",
                                  "serve.journal", "serve.packing",
                                  "serve.countcache", "observability.burn",
                                  "observability.metrics", "serve.fleet",
                                  "serve.stream_server",
                                  "observability.flight"])
def test_verbatim_serve_copies(name):
    """Copied whole: the code is the original's, the package name and
    the docstrings aside."""
    t_mod, r_mod = _pair(name)
    assert _body(t_mod, "sam2consensus_torch") == \
        _body(r_mod, "sam2consensus_tpu")


@pytest.mark.parametrize("name,attrs", [
    ("observability.ratecard", ["drain_target_sec", "compute_scale_hint",
                                "card_path"]),
    ("observability.flight", ["trace_id"]),
    ("serve.countcache", ["parse_budget"]),
    ("serve.scheduler", ["parse_batch_mode", "BatchScheduler.compose",
                         "BatchScheduler.eligible",
                         "BatchScheduler.release_handles",
                         "BatchScheduler._burning",
                         "BatchScheduler._plan_members",
                         "BatchScheduler._predict_wall",
                         "BatchScheduler._note_rate",
                         "BatchScheduler._tail_compatible",
                         "BatchScheduler._render_member",
                         "BatchScheduler._tail_member",
                         "BatchScheduler._demote_all"]),
    ("ops.pileup", ["canonical_slab_shapes", "padded_total_len"]),
    ("serve.cohort", ["_wave_sec", "load_manifest", "wave_cap",
                      "size_wave", "CohortRunner.__init__",
                      "CohortRunner._spec",
                      "CohortRunner._prefilter_resumed",
                      "CohortRunner._drain_probe_cache",
                      "CohortRunner._prewarm",
                      "CohortRunner._consult_jps",
                      "CohortRunner._heuristic_jps",
                      "CohortRunner._run_wave",
                      "CohortRunner.health_summary"]),
    ("resilience.ladder", ["job_rungs", "job_host_rung_config",
                           "record_job_demotion"]),
    ("resilience.faultinject", ["_hang_seconds", "FaultInjector.check"]),
    ("resilience.policy", ["JobDeadlineExceeded", "HungDispatchError"]),
])
def test_serve_function_copies(name, attrs):
    t_mod, r_mod = _pair(name)
    for attr in attrs:
        t_obj, r_obj = t_mod, r_mod
        for part in attr.split("."):
            t_obj, r_obj = getattr(t_obj, part), getattr(r_obj, part)
        if name == "ops.pileup" and attr == "padded_total_len":
            # the port reads the tile from its own constant, not from
            # the JAX package's mxu_pileup: compare values
            for n in (0, 1, 2047, 2048, 4_600_000):
                assert t_obj(n) == r_obj(n)
            continue
        assert _src(t_obj, "sam2consensus_torch") == \
            _src(r_obj, "sam2consensus_tpu"), attr


#: the telemetry copy's deliberate differences, all in ProfilerCapture:
#: its window is torch.profiler on a CUDA device (``device``, ``window``,
#: ``_try_device_window``, ``join``; the reference's ``_try_jax_window``
#: opens jax.profiler), and the class docstring says so
TELEMETRY_DIFFS = {"ProfilerCapture.__init__", "ProfilerCapture.capture",
                   "ProfilerCapture._try_device_window",
                   "ProfilerCapture.join", "_init_device_profiler"}


def test_telemetry_serve_copy():
    import inspect

    t_tel, r_tel = _pair("observability.telemetry")
    names = [n for n, obj in vars(r_tel).items()
             if (inspect.isfunction(obj) or inspect.isclass(obj))
             and getattr(obj, "__module__", "") == r_tel.__name__]
    assert {"parse_slo", "slo_phase_seconds", "AggregateRegistry",
            "render_openmetrics", "parse_openmetrics", "lint_openmetrics",
            "TelemetryServer", "ProfilerCapture"} <= set(names)
    for n in names:
        if n == "ProfilerCapture":
            continue
        assert _src(getattr(t_tel, n), "sam2consensus_torch") == \
            _src(getattr(r_tel, n), "sam2consensus_tpu"), n
    for n in ("SLO_PHASES", "_SLO_ALIASES", "DEFAULT_INTERVAL_S",
              "DEFAULT_CAPTURE_S", "CAPTURE_TOUCH_NAME", "_HELP"):
        assert getattr(t_tel, n) == getattr(r_tel, n), n
    t_cls, r_cls = t_tel.ProfilerCapture, r_tel.ProfilerCapture
    for n in set(vars(r_cls)) - {"__init__", "capture", "_try_jax_window",
                                 "__doc__"}:
        if inspect.isfunction(vars(r_cls)[n]):
            assert _src(vars(t_cls)[n], "sam2consensus_torch") == \
                _src(vars(r_cls)[n], "sam2consensus_tpu"), n
    assert _src(t_cls.capture, "sam2consensus_torch") == _src(
        r_cls.capture, "sam2consensus_tpu").replace(
        "_try_jax_window", "_try_device_window")
    extra = {f"ProfilerCapture.{n}" for n in set(vars(t_cls))
             - set(vars(r_cls))} | {n for n in vars(t_tel)
                                    if n not in vars(r_tel)
                                    and callable(getattr(t_tel, n))}
    assert extra <= TELEMETRY_DIFFS


@pytest.mark.parametrize("value", [None, "", "off", "0", "512M", "2g",
                                   "1048576", "1.5k", "0.1", "lots", "-3"])
def test_parse_budget_equals_reference(value):
    t_cc, r_cc = _pair("serve.countcache")

    def outcome(mod):
        try:
            return mod.parse_budget(value)
        except ValueError as exc:
            return str(exc)

    assert outcome(t_cc) == outcome(r_cc)


def test_job_ladder_helpers_equal_reference():
    t_l, r_l = _pair("resilience.ladder")
    t_m, r_m = _pair("observability.metrics")
    for cfg_t, cfg_r in ((t_config.RunConfig(pileup="pallas",
                                             wire="delta8"),
                          r_config.RunConfig(pileup="pallas",
                                             wire="delta8")),
                         (t_config.RunConfig(), r_config.RunConfig())):
        assert dataclasses.asdict(t_l.job_host_rung_config(cfg_t)) == \
            dataclasses.asdict(r_l.job_host_rung_config(cfg_r))
    snaps = []
    for ladder, met in ((t_l, t_m), (r_l, r_m)):
        reg = met.MetricsRegistry()
        assert ladder.job_rungs(reg.snapshot()) == {}
        ladder.record_job_demotion(reg, "HungDispatchError: x")
        snaps.append((reg.snapshot(), ladder.job_rungs(reg.snapshot())))
    assert snaps[0] == snaps[1]
    assert snaps[0][1] == {"pileup": "host"}


def test_canonical_slab_shapes_equal_reference():
    for total_len in (400, 120_000, 4_600_000):
        for kw in ({}, dict(read_len=100, segment_width=4096),
                   dict(n_reads=1000, chunk_reads=4096),
                   dict(read_len=10_000, segment_width=16384)):
            assert t_pileup.canonical_slab_shapes(total_len, **kw) == \
                r_pileup.canonical_slab_shapes(total_len, **kw)


def test_predict_job_peak_bytes_wraps_the_port_model():
    """The admission wrapper prices a job with the port's own capacity
    model (``predict_run_peak_bytes``: the port's buffers, not the
    reference's XLA operands), from the same config fields the
    reference's wrapper reads."""
    from sam2consensus_torch.observability import memplane

    cfg = t_config.RunConfig(thresholds=[0.25, 0.75], chunk_reads=4096,
                             segment_width=512)
    want, _ = memplane.predict_run_peak_bytes(
        1_000_000, n_thresholds=2, chunk_reads=4096, segment_width=512)
    assert memplane.predict_job_peak_bytes(1_000_000, cfg) == want
    host = dataclasses.replace(cfg, pileup="host")
    want_host, _ = memplane.predict_run_peak_bytes(
        1_000_000, n_thresholds=2, chunk_reads=4096, segment_width=512,
        host_counts=True)
    assert memplane.predict_job_peak_bytes(1_000_000, host) == want_host
    assert "decode_ahead" in memplane.FAMILIES


def test_cli_serve_flags():
    """Every flag of the reference's serve parser parses in the port's,
    with its dest, default, choices and type (the port's own defaults
    aside: ``backend``, and ``--decode-threads``, None: a served job's
    decode workers sized from the host), and runs: the MXU pileup, fleet
    mode, the session flags, the cohort flags and the sharding flags;
    nothing is refused by name."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    def table(parser, own=None):
        return sorted((s, a.dest, own.get(s, a.default) if own
                       else a.default, a.choices, a.type,
                       a.nargs, type(a).__name__)
                      for a in parser._actions for s in a.option_strings)

    t_p, r_p = t_cli.build_serve_parser(), r_cli.build_serve_parser()
    assert table(t_p) == table(r_p, own={"--decode-threads": None})
    t_def, r_def = dict(t_p._defaults), dict(r_p._defaults)
    assert t_def.pop("backend") == "torch" and r_def.pop("backend") == "jax"
    assert t_def == r_def
    assert not hasattr(t_cli, "UNPORTED_SERVE_FLAGS")


def _cache_state(mod, n_rows, tag):
    """A ``CheckpointState`` of ``mod``'s package: ``n_rows`` positions
    of counts and one insertion chunk."""
    import importlib

    pkg = mod.__name__.split(".")[0]
    ckpt = importlib.import_module(f"{pkg}.utils.checkpoint")
    ev = importlib.import_module(f"{pkg}.encoder.events")
    ins = ev.InsertionEvents()
    ins.array_chunks.append((np.zeros(3, np.int32), np.ones(3, np.int32),
                             np.ones(3, np.int32), np.zeros(3, np.uint8)))
    return ckpt.CheckpointState(
        counts=np.zeros((n_rows, 6), np.int32), lines_consumed=0,
        reads_mapped=0, reads_skipped=0, aligned_bases=0, insertions=ins,
        source="", sources=[tag])


def test_count_cache_bookkeeping_equals_reference():
    """The same puts, gets and invalidations on both packages' caches
    (LRU order, eviction under the budget, an oversize entry refused)
    leave equal stats and registries; ``reference_key`` and
    ``entry_nbytes`` agree on the same inputs."""
    t_cc, r_cc = _pair("serve.countcache")
    t_m, r_m = _pair("observability.metrics")
    outs = []
    for cc, met in ((t_cc, t_m), (r_cc, r_m)):
        reg = met.MetricsRegistry()
        cache = cc.CountCache(cc.parse_budget("40K"))
        seen = []
        for op, key, rows in (("put", "a", 600), ("put", "b", 600),
                              ("get", "a", 0), ("put", "c", 600),
                              ("get", "b", 0), ("put", "huge", 5000),
                              ("get", "c", 0), ("inv", "a", 0),
                              ("inv", "a", 0), ("get", "z", 0)):
            if op == "put":
                cache.put(key, _cache_state(cc, rows, key), reg)
            elif op == "get":
                got = cache.get(key, reg)
                seen.append(None if got is None else got.sources)
            else:
                seen.append(cache.invalidate(key, reg))
        outs.append((cache.stats(), list(cache._entries), seen,
                     reg.snapshot()["counters"],
                     cc.entry_nbytes(_cache_state(cc, 600, "x"))))
    assert outs[0] == outs[1]
    assert outs[0][0]["evictions"] >= 1
    cfgs = (t_config.RunConfig(), r_config.RunConfig())
    for kw in ({}, {"maxdel": 3}, {"py2_compat": True},
               {"thresholds": [0.5], "fill": "N"}):
        cfg_t, cfg_r = (dataclasses.replace(c, **kw) for c in cfgs)
        for tenant in ("", "t1"):
            contigs_t = [t_sam.Contig("c1", 100), t_sam.Contig("c2", 250)]
            contigs_r = [r_sam.Contig("c1", 100), r_sam.Contig("c2", 250)]
            assert t_cc.reference_key(contigs_t, cfg_t, tenant) == \
                r_cc.reference_key(contigs_r, cfg_r, tenant)


# -- sharding (parallel/) -----------------------------------------------------
def test_parallel_auto_copy():
    """The shard-mode model is copied whole (the port picks the layout the
    reference picks on the same input)."""
    t_mod, r_mod = _pair("parallel.auto")
    assert _body(t_mod, "sam2consensus_torch") == \
        _body(r_mod, "sam2consensus_tpu")


@pytest.mark.parametrize("name,attrs", [
    ("parallel.mesh", ["factor_mesh"]),
    ("parallel.base", ["block_for", "split_wide_rows", "real_row_mask",
                       "route_to_slots", "record_slab"]),
])
def test_parallel_function_copies(name, attrs):
    t_mod, r_mod = _pair(name)
    for attr in attrs:
        assert _src(getattr(t_mod, attr), "sam2consensus_torch") == \
            _src(getattr(r_mod, attr), "sam2consensus_tpu"), attr


def test_parallel_constants_and_names():
    """``SP_WINDOW_CAP``, ``SP_HALO``, the kernel route's tile, the wire's
    row-bytes model and the partition table's names and regexes."""
    from sam2consensus_torch.backends import torch_backend as t_be
    from sam2consensus_torch.parallel import base as t_pbase
    from sam2consensus_torch.parallel import partition as t_part
    from sam2consensus_torch.wire import codec as t_codec
    from sam2consensus_tpu.backends import jax_backend as r_be
    from sam2consensus_tpu.ops import pallas_pileup as r_pp
    from sam2consensus_tpu.parallel import partition as r_part
    from sam2consensus_tpu.wire import codec as r_codec

    assert t_const.SP_WINDOW_CAP == r_const.SP_WINDOW_CAP
    assert t_be.SP_HALO == r_be.SP_HALO
    assert t_pbase.PALLAS_TILE_POSITIONS == r_pp.TILE_POSITIONS
    for pos in (("dp", "sp"), ("sp", "dp")):
        assert [p for p, _ in t_part.partition_rules(pos)] == \
            [p for p, _ in r_part.partition_rules(pos)]
    for w in (1, 7, 64, 100, 4096):
        for codec in ("packed5", "delta8"):
            assert t_codec.row_bytes_estimate(w, codec) == \
                r_codec.row_bytes_estimate(w, codec)
