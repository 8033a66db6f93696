"""The port's C++ SAM decoder path against the Python encoder and the JAX
package's native encoder.

* the copies: ``native/decoder.cpp`` byte for byte (sha256), the loader's
  compile flags and ISA fingerprint, ``RECORD_ERRORS``;
* ``NativeReadEncoder`` on the row-path cases of ``tests/test_native.py``:
  pileup counts, reads, skipped, events and ``group_insertions`` equal to
  the port's ``ReadEncoder``, and every batch (bucket widths, starts,
  codes) equal to the JAX package's ``NativeReadEncoder``; strict errors
  with the same type, message and input offset;
* ``TorchBackend``'s choice of decoder (``--decoder auto|native|py``) when
  the library cannot be built, and strict errors through the decode
  prefetch thread.

Every case runs on the CPU in well under a second; the library is built
once per process (about 3 s with g++).
"""

import contextlib
import gc
import hashlib
import io
import os
import shutil

import numpy as np
import pytest

from sam2consensus_torch import cli as t_cli
from sam2consensus_torch import native as t_native
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.encoder import events as t_events
from sam2consensus_torch.encoder import native_encoder as t_nat
from sam2consensus_torch.ingest import badrecords as t_bad
from sam2consensus_torch.io import sam as t_sam
from sam2consensus_tpu import native as r_native
from sam2consensus_tpu.backends.cpu import CpuBackend
from sam2consensus_tpu.config import RunConfig as RConfig
from sam2consensus_tpu.encoder import events as r_events
from sam2consensus_tpu.encoder import native_encoder as r_nat
from sam2consensus_tpu.ingest import badrecords as r_bad
from sam2consensus_tpu.io import sam as r_sam
from sam2consensus_tpu.utils.simulate import SimSpec, sam_text, simulate


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """Collect after each test, outside any lock, so that no unreachable
    JAX-package object built here is finalised later inside the JAX
    metrics registry's lock (a deadlock in that package, not the port's)."""
    yield
    gc.collect()


@pytest.fixture
def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the C++ decoder cannot be built")


# -- the copies -------------------------------------------------------------
def test_decoder_source_is_a_byte_copy():
    def digest(path):
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    assert digest(t_native.SRC) == digest(os.path.join(
        os.path.dirname(r_native.__file__), "decoder.cpp"))


def test_loader_flags_and_record_errors():
    assert t_native._FLAGS == r_native._FLAGS
    assert t_native._cpu_fingerprint() == r_native._cpu_fingerprint()
    assert t_bad.RECORD_ERRORS == r_bad.RECORD_ERRORS
    err = KeyError("x")
    t_bad.mark_offset(err, 17)
    t_bad.mark_offset(err, 99)                  # first marker wins
    assert err.s2c_offset == 17
    assert t_bad.mark_offset(ValueError(), None).__dict__ == {}


def test_library_builds_outside_the_package(needs_gxx):
    lib = t_native.load()
    assert lib is not None, t_native.load_error()
    assert os.path.dirname(lib._name) == str(t_native.BUILD_DIR)
    assert not [n for n in os.listdir(os.path.dirname(t_native.SRC))
                if n.endswith(".so")]


# -- the encoders -----------------------------------------------------------
def _stream(sam, text, handle_kind, tmp_path):
    """``(contigs, ReadStream)`` over ``text`` through a str handle, a bytes
    handle (buffered blocks) or a plain file (mmap blocks)."""
    if handle_kind == "text":
        handle = io.StringIO(text)
    elif handle_kind == "bytes":
        handle = io.BytesIO(text.encode("ascii"))
    else:
        path = tmp_path / f"in_{sam.__name__.split('.')[0]}.sam"
        path.write_text(text)
        handle = sam.opener(str(path), binary=True)
    contigs, _n, first = sam.read_header(handle)
    return contigs, sam.ReadStream(handle, first)


def _encode(pkg, kind, text, tmp_path, handle="text", block_bytes=1 << 23,
            **kw):
    """Encode ``text`` with ``pkg``'s (``"t"`` port, ``"r"`` JAX) native or
    Python encoder; returns ``(layout, encoder, batches, stream)``."""
    sam, events, nat = (t_sam, t_events, t_nat) if pkg == "t" \
        else (r_sam, r_events, r_nat)
    contigs, stream = _stream(sam, text, handle, tmp_path)
    layout = events.GenomeLayout(contigs)
    try:
        if kind == "native":
            enc = nat.NativeReadEncoder(layout, on_lines=stream.add_lines,
                                        **kw)

            def feed():       # encode_blocks_from, at block_bytes
                for block in stream.blocks(max_bytes=block_bytes):
                    enc.block_base = stream.block_offset
                    yield block

            batches = [_copy(b) for b in enc.encode_blocks(feed())]
        else:
            enc = events.ReadEncoder(layout, **kw)
            batches = [_copy(b) for b in
                       enc.encode_segments(stream.records(), 10 ** 9)]
    finally:
        stream.handle.close()
    return layout, enc, batches, stream


def _copy(batch):
    return (batch.n_reads, batch.n_events,
            {w: (s.copy(), c.copy()) for w, (s, c) in batch.buckets.items()})


def _counts(batches, total_len):
    counts = np.zeros((total_len + 1) * 6, np.int64)
    for _n, _e, buckets in batches:
        for starts, codes in buckets.values():
            rows, cols = np.nonzero(codes != 255)
            flat = (starts[rows].astype(np.int64) + cols) * 6 \
                + codes[rows, cols]
            counts += np.bincount(flat, minlength=len(counts))
    return counts.reshape(-1, 6)[:-1]


def _same_groups(a, b):
    if a is None:
        assert b is None
        return
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def _assert_equivalent(text, tmp_path, handle="text", block_bytes=1 << 23,
                       **kw):
    """The port's native encoder equals the port's Python encoder (counts,
    reads, skipped, events, insertion groups) and the JAX package's native
    encoder (every batch, reads, skipped, insertion groups, lines)."""
    layout, py, pb, _ = _encode("t", "py", text, tmp_path, handle, **kw)
    _, nat, nb, ns = _encode("t", "native", text, tmp_path, handle,
                             block_bytes, **kw)
    r_layout, ref, rb, rs = _encode("r", "native", text, tmp_path, handle,
                                    block_bytes, **kw)
    np.testing.assert_array_equal(_counts(pb, layout.total_len),
                                  _counts(nb, layout.total_len))
    assert (py.n_reads, py.n_skipped) == (nat.n_reads, nat.n_skipped)
    assert sum(b[1] for b in pb) == sum(b[1] for b in nb)
    groups = t_events.group_insertions(nat.insertions, layout)
    _same_groups(t_events.group_insertions(py.insertions, layout), groups)

    assert (nat.n_reads, nat.n_skipped) == (ref.n_reads, ref.n_skipped)
    assert ns.n_lines == rs.n_lines
    assert len(nb) == len(rb)
    for (n1, e1, b1), (n2, e2, b2) in zip(nb, rb):
        assert (n1, e1, sorted(b1)) == (n2, e2, sorted(b2))
        for w in b1:
            for x, y in zip(b1[w], b2[w]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    _same_groups(groups, r_events.group_insertions(ref.insertions, r_layout))
    return py, nat


def _quirk_text():
    reads = [
        ("r", 1, "4M", "ACGT"), ("r", 1, "*", "AAAA"),
        ("r", 3, "2M3D2M", "ACGT"), ("r", 3, "2M3N2M", "ACGT"),
        ("r", 3, "2M3P2M", "ACGT"), ("r", 5, "2S3M1H", "NNACG"),
        ("r", 2, "2M2I2M", "ACGTAC"), ("r", 1, "3M", "A-G"),
        ("r", 39, "2M2I", "ACGT"), ("r", 1, "2I2M", "ACGT"),
        ("r", 9, "5M", "ACGTA"), ("r2", 1, "6M", "ACGTAC"),
        ("r", 4, "10M11D5M", "ACGTACGTACGTACG"),
    ]
    return sam_text([("r", 40), ("r2", 30)], reads)


def _stray_text():
    base = sam_text([("s", 25)], [("s", 1, "5M", "ACGTA")])
    return base + "@CO stray comment line\n" + sam_text(
        [], [("s", 3, "5M", "TTTTT")]).split("\n", 1)[0] + "\n"


def _op_cache_text(n_ops):
    pairs = (n_ops - 1) // 2
    cigar = "".join(["1M1I"] * pairs)
    cigar += "2M" if (n_ops - 1) % 2 == 0 else ""
    rlen = pairs * 2 + (2 if (n_ops - 1) % 2 == 0 else 0)
    return sam_text([("r", 400)], [("r", 3, cigar,
                                    ("ACGT" * (rlen // 4 + 1))[:rlen])])


_CORPUS = simulate(SimSpec(n_contigs=7, contig_len=400, n_reads=3000,
                           read_len=70, ins_read_rate=0.2,
                           del_read_rate=0.2, seed=3))
_GIANT = ("ACGT" * 330_000)[:1_300_000]          # > 1 MiB insertion

# (id, SAM text, encoder keywords, block bytes): the row-path cases of
# tests/test_native.py
CASES = [
    ("corpus", _CORPUS, {}, 1 << 23),
    ("tiny_blocks", simulate(SimSpec(
        n_contigs=3, contig_len=200, n_reads=800, read_len=40,
        ins_read_rate=0.3, del_read_rate=0.3, seed=4)), {}, 1 << 12),
    *((f"quirks_maxdel_{m}", _quirk_text(), {"maxdel": m}, 1 << 23)
      for m in (150, 10, 0, None)),
    ("negative_pos_wrap", sam_text([("w", 30)], [
        ("w", 0, "4M", "ACGT"), ("w", -3, "8M", "ACGTACGT"),
        ("w", 0, "2I3M", "GGACG")]), {}, 1 << 23),
    ("stray_header_lines", _stray_text(), {}, 1 << 23),
    ("width_overflow", sam_text([("b", 1000)], [("b", 1, "50M", "A" * 50)]
                                * 300 + [("b", 1, "10M900D10M",
                                          "ACGTACGTACGTACGTACGT")]),
     {"maxdel": None}, 1 << 23),
    ("giant_insertion", sam_text([("g", 400)], [
        ("g", 1, "30M", "C" * 30),
        ("g", 5, f"1M{len(_GIANT)}I1M", "A" + _GIANT + "T"),
        ("g", 11, "20M", "G" * 20)]), {}, 1 << 23),
    ("permissive_skips", sam_text([("p", 12)], [
        ("p", 1, "4M", "ACGT"), ("p", 1, "4M", "ACXT"),
        ("p", 11, "4M", "ACGT"), ("x", 1, "4M", "ACGT"),
        ("p", 2, "4M", "TTTT")]), {"strict": False}, 1 << 23),
    ("star_seq", sam_text([("s", 14)], [
        ("s", 3, "4M", "*"), ("s", 3, "1S2M4D", "*"),
        ("s", 3, "2S2I4D", "*"), ("s", 13, "2S1M", "*"),
        ("s", 2, "6M", "ACGTAC")]), {"strict": False}, 1 << 23),
    *((f"op_cache_{n}", _op_cache_text(n), {}, 1 << 23)
      for n in (31, 32, 33, 64)),
    ("segmented_long_reads", sam_text([("v", 9000)], [
        ("v", 1, "8200M", "A" * 8200), ("v", 5, "30M", "C" * 30)] * 3),
     {"segment_width": 4096}, 1 << 23),
]


#: (reads, skipped) that a case must come to, beyond the agreement
READS = {"width_overflow": (301, 0), "giant_insertion": (3, 0),
         "permissive_skips": (2, 3), "star_seq": (4, 1)}


@pytest.mark.parametrize("name,text,kw,block_bytes", CASES,
                         ids=[c[0] for c in CASES])
def test_native_encoder_equivalence(needs_gxx, tmp_path, name, text, kw,
                                    block_bytes):
    py, nat = _assert_equivalent(text, tmp_path, block_bytes=block_bytes,
                                 **kw)
    assert len(nat.insertions) == len(py.insertions)
    if name in READS:
        assert (nat.n_reads, nat.n_skipped) == READS[name]


@pytest.mark.parametrize("handle", ["bytes", "file"])
def test_native_encoder_binary_handles(needs_gxx, tmp_path, handle):
    """Bytes handles (buffered blocks) and plain files (mmap windows), at
    4 KiB blocks, give the same batches as the text handle."""
    _assert_equivalent(_CORPUS, tmp_path, handle=handle, block_bytes=4096)


@pytest.mark.parametrize("sizes", [[0], [3, 4095], [4096, 1], [5000, 9],
                                   [20000], [70000, 2]])
def test_line_end(sizes):
    """The growing-window search finds the first newline, as a plain
    ``bytes.find`` does, across window edges and without a last one."""
    text = b"".join(b"A" * n + b"\n" for n in sizes) + b"TAIL"
    data = np.frombuffer(text, np.uint8)
    for start in [0] + [i + 1 for i, c in enumerate(text) if c == 10]:
        want = text.find(b"\n", start)
        assert t_nat._line_end(data, start) == (len(text) if want < 0
                                                else want)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("record", [
    ("e", 1, "4M", "ACXT"),            # bad base
    ("e", 8, "4M", "ACGT"),            # out of bounds
    ("e", 1, "4M4I", "ACGTACZT"),      # bad motif
    ("q", 1, "4M", "ACGT"),            # unknown reference
], ids=["bad_base", "out_of_bounds", "bad_motif", "unknown_ref"])
def test_strict_error_parity(needs_gxx, tmp_path, record):
    text = sam_text([("e", 10)], [("e", 2, "3M", "ACG"), record])
    py = _error(lambda: _encode("t", "py", text, tmp_path))
    nat = _error(lambda: _encode("t", "native", text, tmp_path,
                                 handle="file"))
    ref = _error(lambda: _encode("r", "native", text, tmp_path,
                                 handle="file"))
    assert type(py) is type(nat) is type(ref)
    assert str(py) == str(nat) == str(ref)
    # the input offset of the failing (last) line
    last = text.splitlines(keepends=True)[-1]
    assert nat.s2c_offset == ref.s2c_offset == len(text) - len(last)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("bad", [
    "too\tfew\tfields\n", "\n",
    "r\t0\tm\tnotanint\t60\t4M\t*\t0\t0\tACGT\tIIII\n",
], ids=["few_fields", "empty_line", "bad_pos"])
def test_malformed_line_errors(needs_gxx, tmp_path, bad, strict):
    text = sam_text([("m", 10)], [("m", 1, "4M", "ACGT")]) + bad
    py = _error(lambda: _encode("t", "py", text, tmp_path, strict=strict))
    nat = _error(lambda: _encode("t", "native", text, tmp_path,
                                 strict=strict))
    ref = _error(lambda: _encode("r", "native", text, tmp_path,
                                 strict=strict))
    assert type(py) is type(nat) is type(ref)
    assert str(nat) == str(ref)


def test_star_seq_strict_error(needs_gxx, tmp_path):
    text = dict((c[0], c[1]) for c in CASES)["star_seq"]
    py = _error(lambda: _encode("t", "py", text, tmp_path))
    nat = _error(lambda: _encode("t", "native", text, tmp_path))
    assert type(py) is type(nat) is KeyError and str(py) == str(nat)


# -- the backend's choice of decoder and the prefetch thread ----------------
def _run_backend(text, tmp_path, **cfg):
    """``TorchBackend.run`` on the CPU with the device accumulator
    (``pileup="pallas"``: on the link-free CPU ``auto`` takes host
    counts, and these tests watch the row path; the insertion kernels'
    plain versions, which ``auto`` leaves for the scatter there)."""
    contigs, stream = _stream(t_sam, text, "file", tmp_path)
    try:
        res = TorchBackend("cpu").run(contigs, stream,
                                      TConfig(prefix="p", pileup="pallas",
                                              ins_kernel="pallas",
                                              **cfg))
    finally:
        stream.handle.close()
    return res, stream


@pytest.mark.parametrize("decoder", ["auto", "native", "py"])
def test_backend_records_its_decoder(needs_gxx, tmp_path, decoder):
    """Line accounting is the same through either decoder, and the run
    says which one it took."""
    text = simulate(SimSpec(n_contigs=2, contig_len=150, n_reads=300,
                            read_len=30, seed=13))
    body = [ln for ln in text.splitlines() if not ln.startswith("@")]
    res, stream = _run_backend(text, tmp_path, decoder=decoder)
    assert res.stats.extra["decoder"] == ("py" if decoder == "py"
                                          else "native")
    assert stream.n_lines == len(body)
    assert res.stats.reads_mapped == sum(ln.split("\t")[5] != "*"
                                         for ln in body)


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """The loader as it is on a host whose compiler cannot run."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_lib_err", None)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_native, "CXX", str(tmp_path / "no-such-g++"))


def test_decoder_native_without_library_raises(broken_compiler, tmp_path):
    sam = str(tmp_path / "x.sam")
    with open(sam, "w") as fh:
        fh.write(sam_text([("r", 10)], [("r", 1, "4M", "ACGT")]))
    with pytest.raises(RuntimeError) as info:
        with contextlib.redirect_stdout(io.StringIO()):
            t_cli.main(["-i", sam, "-o", str(tmp_path / "o"),
                        "--decoder", "native"], device="cpu")
    assert t_native.load() is None and "no-such-g++" in t_native.load_error()
    # the JAX backend's message, word for word
    assert str(info.value) == ("--decoder native requested but the C++ "
                               "decoder is unavailable: "
                               f"{t_native.load_error()}")
    assert not list((tmp_path / "o").glob("*.fasta"))


def test_decoder_auto_without_library_runs_python(broken_compiler, tmp_path):
    text = sam_text([("r", 10)], [("r", 1, "4M", "ACGT")])
    res, stream = _run_backend(text, tmp_path, decoder="auto")
    assert res.stats.extra["decoder"] == "py"
    assert t_native.load() is None
    assert res.stats.reads_mapped == 1 and stream.n_lines == 1


@pytest.mark.parametrize("decoder", ["native", "py"])
def test_strict_error_mid_file_through_prefetch(needs_gxx, tmp_path,
                                                decoder):
    """An error after several batches were consumed reaches the caller
    through the prefetch thread with the serial path's type and message;
    the CLI then writes no FASTA."""
    body = simulate(SimSpec(n_contigs=1, contig_len=2000, n_reads=5000,
                            read_len=60, seed=21))
    lines = body.splitlines(keepends=True)
    at = len(lines) * 4 // 5
    lines.insert(at, "bad\t0\tcontig_0\t5\t60\t4M\t*\t0\t0\tACXT\tIIII\n")
    text = "".join(lines)
    sam = str(tmp_path / "mid.sam")
    with open(sam, "w") as fh:
        fh.write(text)

    with pytest.raises(KeyError) as want:
        handle = io.StringIO(text)
        contigs, _n, first = r_sam.read_header(handle)
        CpuBackend().run(contigs, r_sam.iter_records(handle, first),
                         RConfig(prefix="p"))
    batches = []
    orig = TorchBackend.run

    def run(self, contigs, records, cfg):
        cfg.chunk_reads = 1000       # several Python batches before it
        return orig(self, contigs, records, cfg)

    from sam2consensus_torch.ops import pileup

    add = pileup.PileupAccumulator.add

    def counted_add(self, batch):
        batches.append(batch.n_reads)
        return add(self, batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TorchBackend, "run", run)
        mp.setattr(t_nat.NativeReadEncoder, "SLAB_CELLS", 1 << 16)
        mp.setattr(pileup.PileupAccumulator, "add", counted_add)
        with pytest.raises(KeyError) as got:
            with contextlib.redirect_stdout(io.StringIO()):
                t_cli.main(["-i", sam, "-o", str(tmp_path / "o"),
                            "--decoder", decoder, "--pileup", "pallas",
                            "--insertion-kernel", "pallas"],
                           device="cpu")
    assert str(got.value) == str(want.value)
    assert len(batches) >= 2
    assert not list((tmp_path / "o").glob("*.fasta"))
    if decoder == "native":
        assert got.value.s2c_offset == len("".join(lines[:at]))


def _prefetch_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "decode-prefetch"]


@pytest.mark.parametrize("decoder", ["native", "py"])
def test_prefetch_under_fast_thread_switching(needs_gxx, tmp_path, decoder):
    """Many small batches, the interpreter switching threads every
    microsecond: the same counts as a serial drain, the decode time billed,
    and the producer gone afterwards."""
    import sys

    from sam2consensus_torch.backends import torch_backend

    text = simulate(SimSpec(n_contigs=2, contig_len=500, n_reads=4000,
                            read_len=40, ins_read_rate=0.2, seed=17))
    contigs, stream = _stream(t_sam, text, "file", tmp_path)
    layout = t_events.GenomeLayout(contigs)
    enc, batches = TorchBackend._make_encoder(
        layout, stream, TConfig(decoder=decoder, chunk_reads=64),
        torch_backend.BackendStats())
    serial = _counts([_copy(b) for b in batches], layout.total_len)
    stream.handle.close()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_nat.NativeReadEncoder, "SLAB_CELLS", 1 << 14)
            contigs, stream = _stream(t_sam, text, "file", tmp_path)
            stats = torch_backend.BackendStats()
            stats.extra["decode_sec"] = 0.0
            _, batches = TorchBackend._make_encoder(
                layout, stream, TConfig(decoder=decoder, chunk_reads=64),
                stats)
            got = []
            for b in torch_backend._Prefetcher(batches, stats):
                got.append(_copy(b))
            stream.handle.close()
    finally:
        sys.setswitchinterval(interval)
    assert len(got) >= 4          # native slabs hold at least 1024 rows
    np.testing.assert_array_equal(_counts(got, layout.total_len), serial)
    assert stats.extra["decode_sec"] > 0
    assert not _prefetch_threads()


def test_consumer_failure_stops_the_producer(needs_gxx, tmp_path):
    """A failure in the pileup (the consumer) propagates as it is, and the
    decode thread is stopped and joined before the run returns."""
    from sam2consensus_torch.ops import pileup

    text = simulate(SimSpec(n_contigs=1, contig_len=2000, n_reads=6000,
                            read_len=60, seed=23))
    calls = []

    def failing_add(self, batch):
        calls.append(batch.n_reads)
        if len(calls) == 2:
            raise RuntimeError("device lost")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_nat.NativeReadEncoder, "SLAB_CELLS", 1 << 14)
        mp.setattr(pileup.PileupAccumulator, "add", failing_add)
        with pytest.raises(RuntimeError, match="device lost"):
            _run_backend(text, tmp_path, decoder="native")
    assert len(calls) == 2
    assert not _prefetch_threads()


@pytest.mark.parametrize("seg_w,native_lines", [(-1, True), (0, False)])
def test_overflow_lines_decode_natively_without_segments(
        needs_gxx, tmp_path, monkeypatch, seg_w, native_lines):
    """Reads wider than the slab: with the segmented layout off
    (``--segment-width -1``) the C decoder takes each one at a width that
    holds it and nothing replays in python; under the default layout they
    replay (and segment) there.  The counts, reads, events and insertion
    groups equal the python encoder's and the JAX package's either way."""
    from sam2consensus_torch.encoder.events import resolve_segment_width

    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 30000))
    reads = []
    for i in range(40):
        s = int(rng.integers(0, 20000))
        n = int(rng.integers(5000, 9000))
        reads.append(("g", s + 1, f"{n // 2}M3I{n - n // 2}M",
                      genome[s:s + n // 2] + "TTT" + genome[s + n // 2:s + n]))
    text = sam_text([("g", 30000)], reads)
    replays = []
    fallback = t_nat.NativeReadEncoder._fallback_line

    def counted(self, *args, **kwargs):
        replays.append(args[1])
        return fallback(self, *args, **kwargs)

    monkeypatch.setattr(t_nat.NativeReadEncoder, "_fallback_line", counted)
    kw = {"segment_width": resolve_segment_width(seg_w)}
    layout, py, pb, _ = _encode("t", "py", text, tmp_path, "file", **kw)
    _, nat, nb, ns = _encode("t", "native", text, tmp_path, "file", **kw)
    r_layout, ref, rb, rs = _encode("r", "native", text, tmp_path, "file",
                                    **kw)
    assert (len(replays) == 0) == native_lines
    want = _counts(pb, layout.total_len)
    np.testing.assert_array_equal(_counts(nb, layout.total_len), want)
    np.testing.assert_array_equal(_counts(rb, layout.total_len), want)
    assert nat.n_reads == py.n_reads == ref.n_reads == 40
    assert sum(b[1] for b in nb) == sum(b[1] for b in pb)
    assert ns.n_lines == rs.n_lines
    groups = t_events.group_insertions(nat.insertions, layout)
    _same_groups(t_events.group_insertions(py.insertions, layout), groups)
    _same_groups(groups, r_events.group_insertions(ref.insertions, r_layout))
    # the fused host count takes the same lines the same way
    replays.clear()
    counts = np.zeros((layout.total_len, 6), dtype=np.int32)
    _, fused, fb, _ = _encode("t", "native", text, tmp_path, "file",
                              accumulate_into=counts, **kw)
    assert (len(replays) == 0) == native_lines
    np.testing.assert_array_equal(counts, want)
    assert fused.n_reads == 40 and all(not b[2] for b in fb)
