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
