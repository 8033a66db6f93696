"""BAM and BGZF input of the port, on the CPU.

The port's CLI (``device="cpu"``) renders every ``formats_*`` fixture
(BAM, BGZF ``.sam.gz``, plain-gzip ``.plain.sam.gz``) to its pinned
``.expected.fasta`` bytes under both decoders and both ways of naming the
format; the port's BAM encoders give the JAX package's batches and
insertion events on the same BAM; BGZF inflates the same bytes on one
thread and on a pool; and broken input raises the JAX package's exception
type and message.  None of this starts a JAX computation.
"""

import contextlib
import io
import os
import struct

import numpy as np
import pytest

from sam2consensus_torch import cli as t_cli
from sam2consensus_torch import native as t_native
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.encoder.events import GenomeLayout as TLayout
from sam2consensus_torch.formats import bam as t_bam
from sam2consensus_torch.formats import bgzf as t_bgzf
from sam2consensus_torch.formats import open_alignment_input as t_open
from sam2consensus_tpu.encoder.events import GenomeLayout as RLayout
from sam2consensus_tpu.formats import bam as r_bam
from sam2consensus_tpu.formats import bgzf as r_bgzf
from sam2consensus_tpu.formats import open_alignment_input as r_open

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FAMILIES = ("short", "longread", "adversarial")
CONTAINERS = {".bam": "bam", ".sam.gz": "sam.gz", ".plain.sam.gz": "sam.gz"}


def _expected(fam):
    with open(os.path.join(DATA, f"formats_{fam}.expected.fasta")) as fh:
        return fh.read()


def _render(tmp_path, argv, pileup="pallas"):
    """The port's CLI on the CPU; returns (FASTA text, stats).  The CPU
    device is link-free, so ``--pileup auto`` would take the host counts:
    the default pins ``pallas``, the device accumulator's plain path."""
    ran = []
    orig = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig(self, *args, **kwargs)
        ran.append(result.stats)
        return result

    out = str(tmp_path / "out")
    TorchBackend.run = run
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert t_cli.main(argv + ["-o", out, "-p", "fixture",
                                      "--pileup", pileup],
                              device="cpu") == 0
    finally:
        TorchBackend.run = orig
    text = "".join(open(os.path.join(out, f)).read()
                   for f in sorted(os.listdir(out)))
    return text, ran[-1]


@pytest.mark.parametrize("decoder", ["native", "py"])
@pytest.mark.parametrize("forced", [False, True], ids=["auto", "forced"])
@pytest.mark.parametrize("ext", list(CONTAINERS))
@pytest.mark.parametrize("fam", FAMILIES)
def test_cli_renders_expected(tmp_path, fam, ext, forced, decoder):
    argv = ["-i", os.path.join(DATA, f"formats_{fam}{ext}"),
            "--decoder", decoder]
    if forced:
        argv += ["--format", CONTAINERS[ext]]
    text, stats = _render(tmp_path, argv)
    assert text == _expected(fam)
    assert stats.extra["decoder"] == decoder
    # staging is for the card: a CPU run stages nothing
    assert stats.extra["stage_sec"] == 0.0


@pytest.mark.parametrize("decoder", ["native", "py"])
@pytest.mark.parametrize("pileup", ["host", "auto"])
@pytest.mark.parametrize("ext", list(CONTAINERS))
@pytest.mark.parametrize("fam", FAMILIES)
def test_cli_renders_expected_pileup(tmp_path, fam, ext, pileup, decoder):
    """Every container under host counts: the fused C++ count (the native
    BAM and SAM decoders) or ``s2c_accumulate_rows`` (``--decoder py``),
    and the native tail."""
    text, stats = _render(tmp_path, [
        "-i", os.path.join(DATA, f"formats_{fam}{ext}"),
        "--decoder", decoder], pileup=pileup)
    assert text == _expected(fam)
    assert stats.extra["decoder"] == decoder
    assert stats.extra["pileup_path"] == "host"
    assert stats.extra["counts_fused"] == (decoder == "native")
    assert stats.extra["tail_native"] is True


@pytest.mark.parametrize("threads", ["0", "3"])
def test_cli_decode_threads(tmp_path, threads):
    text, _ = _render(tmp_path, [
        "-i", os.path.join(DATA, "formats_longread.bam"),
        "--decode-threads", threads])
    assert text == _expected("longread")


def test_cli_counts_bam_records(capsys, tmp_path):
    with open(os.path.join(DATA, "formats_short.sam")) as fh:
        n_body = sum(1 for line in fh if not line.startswith("@"))
    t_cli.main(["-i", os.path.join(DATA, "formats_short.bam"), "-o",
                str(tmp_path / "o"), "--pileup", "pallas"], device="cpu")
    assert f"A total of {n_body} reads were processed" in \
        capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["--format", "cram"], "invalid choice: 'cram'"),
    (["--decode-threads", "two"], "invalid int value: 'two'"),
])
def test_cli_parse_errors(capsys, argv, needle):
    from sam2consensus_tpu import cli as r_cli

    msgs = []
    for parser in (t_cli.build_parser(), r_cli.build_parser()):
        with pytest.raises(SystemExit) as exc:
            parser.parse_args(["-i", "x.bam", *argv])
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1])
    assert needle in msgs[0]
    assert msgs[0].split(": error: ")[1] == msgs[1].split(": error: ")[1]


def _open_pair(path):
    t_r = t_bgzf.BgzfReader(path)
    r_r = r_bgzf.BgzfReader(path)
    t_c, _ = t_bam.read_bam_header(t_r)
    r_c, _ = r_bam.read_bam_header(r_r)
    assert [(c.name, c.length) for c in t_c] == \
        [(c.name, c.length) for c in r_c]
    return (t_bam.BamReadStream(t_r, [c.name for c in t_c]), t_c,
            r_bam.BamReadStream(r_r, [c.name for c in r_c]), r_c)


def _drain(enc, batches):
    out = []
    for b in batches:
        out.append((b.n_reads, b.n_events,
                    [(w, b.buckets[w][0].copy(), b.buckets[w][1].copy())
                     for w in sorted(b.buckets)]))
    return out, enc.n_reads, enc.n_skipped, \
        [np.asarray(a) for a in enc.insertions.to_arrays()]


def _same(got, want):
    (gb, gr, gs, gi), (wb, wr, ws, wi) = got, want
    assert (gr, gs) == (wr, ws)
    assert len(gb) == len(wb)
    for (n1, e1, k1), (n2, e2, k2) in zip(gb, wb):
        assert (n1, e1) == (n2, e2)
        assert [w for w, *_ in k1] == [w for w, *_ in k2]
        for (_w, s1, c1), (_w2, s2, c2) in zip(k1, k2):
            assert s1.dtype == s2.dtype and np.array_equal(s1, s2)
            assert c1.dtype == c2.dtype and np.array_equal(c1, c2)
    for a, b in zip(gi, wi):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["native", "py"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_bam_encoders_match_reference(fam, kind):
    path = os.path.join(DATA, f"formats_{fam}.bam")
    t_st, t_c, r_st, r_c = _open_pair(path)
    if kind == "native":
        t_enc = t_bam.NativeBamEncoder(TLayout(t_c), t_st, segment_width=64)
        r_enc = r_bam.NativeBamEncoder(RLayout(r_c), r_st, segment_width=64)
    else:
        t_enc = t_bam.BamSegmentEncoder(TLayout(t_c), t_st, chunk_reads=100,
                                        segment_width=64)
        r_enc = r_bam.BamSegmentEncoder(RLayout(r_c), r_st, chunk_reads=100,
                                        segment_width=64)
    got = _drain(t_enc, t_enc.encode_batches())
    want = _drain(r_enc, r_enc.encode_batches())
    _same(got, want)
    assert t_st.n_lines == r_st.n_lines and t_st.n_bytes == r_st.n_bytes


@pytest.mark.parametrize("fam", FAMILIES)
def test_bam_records_match_reference(fam):
    t_st, _, r_st, _ = _open_pair(os.path.join(DATA, f"formats_{fam}.bam"))
    t_recs = [(r.refname, r.pos, r.ops, r.seq, r.cigar)
              for r in t_st.records()]
    r_recs = [(r.refname, r.pos, r.ops, r.seq, r.cigar)
              for r in r_st.records()]
    assert t_recs == r_recs and t_st.n_lines == r_st.n_lines


@pytest.mark.parametrize("fam", FAMILIES)
def test_bgzf_threads_same_bytes(fam):
    path = os.path.join(DATA, f"formats_{fam}.sam.gz")
    one = t_bgzf.BgzfReader(path, threads=1)
    pool = t_bgzf.BgzfReader(path, threads=3)
    try:
        a, b = one.read(), pool.read()
    finally:
        one.close()
        pool.close()
    import gzip

    with gzip.open(path, "rb") as fh:
        assert a == b == fh.read()


def _bgzf_bytes(tmp_path, payload=b"@SQ\tSN:c\tLN:10\n" * 5000):
    path = str(tmp_path / "x.sam.gz")
    t_bgzf.write_bgzf(payload, path, block_udata=4096)
    with open(path, "rb") as fh:
        return path, fh.read()


def _raises_alike(t_fn, r_fn):
    """Both callables raise: same exception type name and message."""
    with pytest.raises(Exception) as t_exc:
        t_fn()
    with pytest.raises(Exception) as r_exc:
        r_fn()
    assert type(t_exc.value).__name__ == type(r_exc.value).__name__
    assert str(t_exc.value) == str(r_exc.value)
    return t_exc.value


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


@pytest.mark.parametrize("damage", ["no_eof", "mid_block", "bad_magic",
                                    "empty"])
def test_bgzf_open_errors(tmp_path, damage):
    _path, data = _bgzf_bytes(tmp_path)
    second = t_bgzf.scan_blocks(io.BytesIO(data))[1][0]
    data = {"no_eof": data[:-len(t_bgzf.BGZF_EOF)],
            "mid_block": data[:-len(t_bgzf.BGZF_EOF) - 100],
            "bad_magic": data[:second] + b"XXXX" + data[second + 4:],
            "empty": b""}[damage]
    path = _write(tmp_path, "d.sam.gz", data)
    exc = _raises_alike(lambda: t_bgzf.BgzfReader(path),
                        lambda: r_bgzf.BgzfReader(path))
    assert isinstance(exc, t_bgzf.BgzfError)


def test_bgzf_corrupt_block_mid_stream(tmp_path):
    _path, data = _bgzf_bytes(tmp_path)
    raw = bytearray(data)
    off, length = t_bgzf.scan_blocks(io.BytesIO(data))[2]
    raw[off + length - 8] ^= 0xFF          # the block's CRC32
    path = _write(tmp_path, "c.sam.gz", bytes(raw))
    exc = _raises_alike(lambda: t_bgzf.BgzfReader(path, threads=3).read(),
                        lambda: r_bgzf.BgzfReader(path, threads=3).read())
    assert isinstance(exc, t_bgzf.BgzfCorruptBlock) and exc.offset == off


def _bam_with(records, contigs=(("c", 100),)):
    return t_bam.bam_payload(list(contigs), records)


@pytest.mark.parametrize("case", ["ref_outside_table", "out_of_bounds",
                                  "bad_nibble", "truncated", "bad_magic"])
@pytest.mark.parametrize("decoder", ["native", "py"])
def test_bam_errors_match_reference(tmp_path, case, decoder):
    good = ("c", 3, "5M", "ACGTA")
    payload = {
        "ref_outside_table": _bam_with([good])
        + t_bam.encode_bam_record(5, 1, "3M", "ACG"),
        "out_of_bounds": _bam_with([good, ("c", 98, "5M", "ACGTA")]),
        "bad_nibble": _bam_with([good, ("c", 10, "4M", "ACRT")]),
        "truncated": _bam_with([good, good])[:-7],
        "bad_magic": b"BAM\x02" + _bam_with([good])[4:],
    }[case]
    path = str(tmp_path / "e.bam")
    t_bgzf.write_bgzf(payload, path)

    def port():
        ai = t_open(path, "bam")
        cfg = t_cli.config_from_args(t_cli.build_parser().parse_args(
            ["-i", path, "--decoder", decoder]))
        enc, batches = ai.stream.make_encoder(TLayout(ai.contigs), cfg)
        list(batches)

    def ref():
        reader = r_bgzf.BgzfReader(path)
        contigs, _ = r_bam.read_bam_header(reader)
        st = r_bam.BamReadStream(reader, [c.name for c in contigs])
        cls = r_bam.NativeBamEncoder if decoder == "native" else \
            r_bam.BamSegmentEncoder
        list(cls(RLayout(contigs), st).encode_batches())

    _raises_alike(port, ref)


def test_unknown_format_rejected():
    path = os.path.join(DATA, "formats_short.bam")
    _raises_alike(lambda: t_open(path, "cram"), lambda: r_open(path, "cram"))


@pytest.mark.parametrize("name", [f"formats_{f}{e}" for f in FAMILIES
                                  for e in (".bam", ".sam.gz",
                                            ".plain.sam.gz", ".sam")])
def test_detect_format(name):
    from sam2consensus_torch.formats import detect_format as t_detect
    from sam2consensus_tpu.formats import detect_format as r_detect

    path = os.path.join(DATA, name)
    assert t_detect(path) == r_detect(path)


def test_damaged_bam_falls_back_to_sibling(tmp_path):
    import shutil

    src = os.path.join(DATA, "formats_short")
    with open(src + ".bam", "rb") as fh:
        data = fh.read()
    _write(tmp_path, "formats_short.bam", data[:-len(t_bgzf.BGZF_EOF)])
    shutil.copy(src + ".sam", tmp_path / "formats_short.sam")
    text, _ = _render(tmp_path, ["-i", str(tmp_path / "formats_short.bam")])
    assert text == _expected("short")


def test_native_requested_without_bam_decoder(monkeypatch):
    """``--decoder native`` raises where the library lacks
    ``s2c_decode_bam``; nothing carries on with the Python encoder."""
    lib = t_native.load()
    assert lib is not None

    class NoBam:
        def __getattr__(self, name):
            if name == "s2c_decode_bam":
                raise AttributeError(name)
            return getattr(lib, name)

    monkeypatch.setattr(t_native, "load", lambda: NoBam())
    with pytest.raises(RuntimeError, match="--decoder native requested"):
        with contextlib.redirect_stdout(io.StringIO()):
            t_cli.main(["-i", os.path.join(DATA, "formats_short.bam"),
                        "-o", "unused", "--decoder", "native"], device="cpu")


def test_bam_record_field_overrun_raises():
    rec = bytearray(t_bam.encode_bam_record(0, 3, "5M", "ACGTA"))
    struct.pack_into("<i", rec, 4 + 16, 9999)        # l_seq past the record
    buf = bytes(rec)
    with pytest.raises(t_bam.BamParseError, match="overrun") as t_exc:
        t_bam._RecordIndex(buf, 0)
    with pytest.raises(r_bam.BamParseError) as r_exc:
        r_bam._RecordIndex(buf, 0)
    assert str(t_exc.value) == str(r_exc.value)
