"""The port's checkpoints, resume, ``--incremental`` and ``--paranoid``
against the JAX package's, on the CPU.

The ``.npz`` file is the same file in both packages (keys, ``meta``,
crc32 ``digest``), so a checkpoint written by one resumes in the other to
identical FASTA; a crashed run resumes byte-identically; the three
``--incremental`` cases of ``tests/test_checkpoint.py`` hold on the port.
"""

import gc
import io

import numpy as np
import pytest

from sam2consensus_torch.backends.base import BackendStats
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.encoder.events import GenomeLayout
from sam2consensus_torch.encoder.events import InsertionEvents as TIns
from sam2consensus_torch.encoder.events import SegmentBatch
from sam2consensus_torch.io.fasta import render_file as t_render
from sam2consensus_torch.io.sam import ReadStream as TReadStream
from sam2consensus_torch.io.sam import read_header as t_read_header
from sam2consensus_torch.observability.metrics import pop_run, push_run
from sam2consensus_torch.utils import checkpoint as t_ckpt
from sam2consensus_tpu.backends.cpu import CpuBackend
from sam2consensus_tpu.backends.jax_backend import JaxBackend
from sam2consensus_tpu.config import RunConfig as RConfig
from sam2consensus_tpu.encoder.events import InsertionEvents as RIns
from sam2consensus_tpu.io.fasta import render_file as r_render
from sam2consensus_tpu.io.sam import ReadStream as RReadStream
from sam2consensus_tpu.io.sam import read_header as r_read_header
from sam2consensus_tpu.utils import checkpoint as r_ckpt
from sam2consensus_tpu.utils.simulate import SimSpec, simulate

TEXT = simulate(SimSpec(n_contigs=4, contig_len=220, n_reads=600,
                        read_len=44, ins_read_rate=0.15, del_read_rate=0.15,
                        seed=17))
TOTAL_LEN = GenomeLayout(t_read_header(io.StringIO(TEXT))[0]).total_len


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """No automatic collection during a test: one inside the JAX
    package's registry lock can run a finalizer that takes the same lock
    (ROADMAP §C 2).  Collect after the test instead, outside any lock."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


class _CrashingHandle:
    """A handle that dies after ``limit`` lines."""

    def __init__(self, handle, limit):
        self.handle = handle
        self.limit = limit
        self.count = 0

    def __iter__(self):
        for line in self.handle:
            self.count += 1
            if self.count > self.limit:
                raise RuntimeError("injected crash")
            yield line

    def readline(self):
        return self.handle.readline()

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        return self.handle.seek(pos)


def _cfg(**kw):
    base = dict(prefix="ck", thresholds=[0.25, 0.75], decoder="py",
                chunk_reads=64)
    base.update(kw)
    return base


def run_port(text=TEXT, handle_wrapper=None, **kw):
    handle = io.StringIO(text)
    contigs, _n, first = t_read_header(handle)
    if handle_wrapper is not None:
        handle = handle_wrapper(handle)
    stream = TReadStream(handle, first)
    res = TorchBackend("cpu").run(contigs, stream,
                                  TConfig(backend="torch", **_cfg(**kw)))
    return ({n: t_render(r, 0) for n, r in res.fastas.items()}, res.stats,
            stream)


def run_jax(text=TEXT, handle_wrapper=None, **kw):
    handle = io.StringIO(text)
    contigs, _n, first = r_read_header(handle)
    if handle_wrapper is not None:
        handle = handle_wrapper(handle)
    stream = RReadStream(handle, first)
    res = JaxBackend().run(contigs, stream,
                           RConfig(backend="jax", shards=1, **_cfg(**kw)))
    return ({n: r_render(r, 0) for n, r in res.fastas.items()}, res.stats,
            stream)


def oracle(text=TEXT, thresholds=(0.25, 0.75)):
    handle = io.StringIO(text)
    contigs, _n, first = r_read_header(handle)
    res = CpuBackend().run(contigs, RReadStream(handle, first),
                           RConfig(prefix="ck", thresholds=list(thresholds)))
    return {n: r_render(r, 0) for n, r in res.fastas.items()}


# --------------------------------------------------------- the file --
def _state(mod, ins_mod):
    ins = ins_mod()
    ins.contig_ids += [0, 1]
    ins.local_pos += [5, 7]
    ins.motifs += ["AC", "GGT"]
    return mod.CheckpointState(
        counts=np.arange(60, dtype=np.int32).reshape(10, 6),
        lines_consumed=123, reads_mapped=40, reads_skipped=2,
        aligned_bases=555, insertions=ins, source="/a.sam",
        sources=["/x.sam", "/y.sam"], byte_offset=4567, max_row_width=64)


def test_roundtrip(tmp_path):
    t_ckpt.save(str(tmp_path), _state(t_ckpt, TIns))
    got = t_ckpt.load(str(tmp_path), 10)
    want = _state(t_ckpt, TIns)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got.lines_consumed, got.reads_mapped, got.reads_skipped,
            got.aligned_bases, got.source, got.sources, got.byte_offset,
            got.max_row_width) == (123, 40, 2, 555, "/a.sam",
                                   ["/x.sam", "/y.sam"], 4567, 64)
    for x, y in zip(got.insertions.to_arrays(), want.insertions.to_arrays()):
        np.testing.assert_array_equal(x, y)


def test_same_file_as_reference(tmp_path):
    """The same keys, dtypes and values (the digest included) from both
    writers, and each package loads the other's file."""
    t_ckpt.save(str(tmp_path / "t"), _state(t_ckpt, TIns))
    r_ckpt.save(str(tmp_path / "r"), _state(r_ckpt, RIns))
    with np.load(t_ckpt.path_for(str(tmp_path / "t"))) as zt, \
            np.load(r_ckpt.path_for(str(tmp_path / "r"))) as zr:
        assert sorted(zt.files) == sorted(zr.files)
        for k in zt.files:
            assert zt[k].dtype == zr[k].dtype
            np.testing.assert_array_equal(zt[k], zr[k])
    a = t_ckpt.load(str(tmp_path / "r"), 10)
    b = r_ckpt.load(str(tmp_path / "t"), 10)
    assert a.lines_consumed == b.lines_consumed == 123
    assert a.sources == b.sources


def test_load_missing_and_wrong_genome(tmp_path):
    assert t_ckpt.load(str(tmp_path), 10) is None
    t_ckpt.save(str(tmp_path), _state(t_ckpt, TIns))
    with pytest.raises(ValueError, match="genome of length 10"):
        t_ckpt.load(str(tmp_path), 11)


def test_truncated_checkpoint_loads_as_absent_with_counter(tmp_path):
    t_ckpt.save(str(tmp_path), _state(t_ckpt, TIns))
    p = t_ckpt.path_for(str(tmp_path))
    blob = open(p, "rb").read()
    with open(p, "wb") as fh:
        fh.write(blob[:len(blob) // 2])
    reg = push_run()
    try:
        assert t_ckpt.load(str(tmp_path), 10) is None
        assert reg.value("checkpoint/corrupt") == 1
    finally:
        pop_run(reg)


def test_digest_mismatch_loads_as_absent(tmp_path):
    t_ckpt.save(str(tmp_path), _state(t_ckpt, TIns))
    p = t_ckpt.path_for(str(tmp_path))
    with np.load(p) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["counts"] = arrays["counts"].copy()
    arrays["counts"][0, 0] += 1
    with open(p, "wb") as fh:
        np.savez(fh, **arrays)
    reg = push_run()
    try:
        assert t_ckpt.load(str(tmp_path), 10) is None
        assert reg.value("checkpoint/corrupt") == 1
    finally:
        pop_run(reg)


# ---------------------------------------------------- crash + resume --
@pytest.mark.parametrize("pileup", ["pallas", "host"])
def test_crash_resume_byte_identical(tmp_path, pileup):
    ck = str(tmp_path)
    with pytest.raises(RuntimeError, match="injected crash"):
        run_port(handle_wrapper=lambda h: _CrashingHandle(h, 400),
                 pileup=pileup, checkpoint_dir=ck, checkpoint_every=64)
    state = t_ckpt.load(ck, TOTAL_LEN)
    assert state is not None and state.lines_consumed > 0
    got, stats, stream = run_port(pileup=pileup, checkpoint_dir=ck,
                                  checkpoint_every=64)
    fresh, fresh_stats, _s = run_port(pileup=pileup)
    assert got == fresh == oracle()
    assert stats.extra["resumed_from_line"] == state.lines_consumed
    assert stats.extra["resume_mode"] == "seek"
    assert stats.reads_mapped == fresh_stats.reads_mapped
    assert stats.aligned_bases == fresh_stats.aligned_bases
    assert stream.n_lines == sum(1 for ln in TEXT.splitlines()
                                 if ln and not ln.startswith("@"))
    assert t_ckpt.load(ck, TOTAL_LEN) is None     # a finished run's goes


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_resumes_across_packages(tmp_path, writer, reader):
    """A checkpoint the JAX backend wrote resumes in the port, and the
    reverse, to identical FASTA."""
    ck = str(tmp_path)
    run_w = run_jax if writer == "jax" else run_port
    run_r = run_jax if reader == "jax" else run_port
    with pytest.raises(RuntimeError, match="injected crash"):
        run_w(handle_wrapper=lambda h: _CrashingHandle(h, 300),
              checkpoint_dir=ck, checkpoint_every=64)
    state = t_ckpt.load(ck, TOTAL_LEN)
    assert state is not None and state.lines_consumed > 0
    got, stats, _s = run_r(checkpoint_dir=ck, checkpoint_every=64,
                           pileup="pallas", decoder="native")
    assert got == oracle()
    assert stats.extra["resumed_from_line"] == state.lines_consumed


def test_checkpoint_stats_equal_jax(tmp_path):
    got, t_stats, _s = run_port(checkpoint_dir=str(tmp_path / "t"),
                                checkpoint_every=64, pileup="pallas")
    want, r_stats, _s = run_jax(checkpoint_dir=str(tmp_path / "r"),
                                checkpoint_every=64, pileup="pallas")
    assert got == want
    assert t_stats.extra["checkpoints_written"] \
        == r_stats.extra["checkpoints_written"] > 1


# -------------------------------------------------------- incremental --
def _shards(seed, n_reads, contig_len, cut):
    combined = simulate(SimSpec(n_contigs=3, contig_len=contig_len,
                                n_reads=n_reads, read_len=40,
                                ins_read_rate=0.2, max_indel=3, seed=seed))
    lines = combined.splitlines(keepends=True)
    header = [ln for ln in lines if ln.startswith("@")]
    body = [ln for ln in lines if not ln.startswith("@")]
    return (combined, "".join(header + body[:cut]),
            "".join(header + body[cut:]))


def test_incremental_two_shards_equal_one_run(tmp_path):
    combined, text_a, text_b = _shards(71, 550, 200, 300)
    ck = str(tmp_path / "ck")
    kw = dict(checkpoint_dir=ck, incremental=True, pileup="pallas")
    run_port(text=text_a, source_id="a", **kw)
    out_two, _st, _s = run_port(text=text_b, source_id="b", **kw)
    assert out_two == oracle(combined)
    out_again, st, _s = run_port(text=text_b, source_id="b", **kw)
    assert out_again == out_two
    assert st.extra["incremental_duplicate"] == "b"


def test_incremental_rerun_of_older_shard_adds_nothing(tmp_path):
    combined, text_a, text_b = _shards(72, 500, 180, 250)
    ck = str(tmp_path / "ck")
    kw = dict(checkpoint_dir=ck, incremental=True)
    run_port(text=text_a, source_id="a", **kw)
    out_ab, _st, _s = run_port(text=text_b, source_id="b", **kw)
    assert out_ab == oracle(combined)
    out_dup, stats, _s = run_port(text=text_a, source_id="a", **kw)
    assert stats.extra["incremental_duplicate"] == "a"
    assert out_dup == out_ab
    out_b_again, _st, _s = run_port(text=text_b, source_id="b", **kw)
    assert out_b_again == out_ab


def test_incremental_rejects_stacking_on_crashed_shard(tmp_path):
    ck = str(tmp_path / "ck")
    kw = dict(thresholds=[0.25], checkpoint_dir=ck, checkpoint_every=64,
              incremental=True)
    run_port(source_id="a", **kw)
    with pytest.raises(RuntimeError, match="injected crash"):
        run_port(source_id="b",
                 handle_wrapper=lambda h: _CrashingHandle(h, 400), **kw)
    with pytest.raises(RuntimeError, match="partially absorbed"):
        run_port(source_id="c", **kw)
    with pytest.raises(RuntimeError, match="partially absorbed"):
        run_port(source_id="a", **kw)
    _out_b, st_b, _s = run_port(source_id="b", **kw)
    assert "resumed_from_line" in st_b.extra
    _out_c, st_c, _s = run_port(source_id="c", **kw)
    assert sorted(st_c.extra["incremental_base"]) == ["a", "b"]


def test_incremental_file_equals_jax(tmp_path):
    """Two shards through each package: the final checkpoints hold the
    same counts, insertion log and absorbed sources."""
    _combined, text_a, text_b = _shards(73, 400, 160, 200)
    for tag, run in (("t", run_port), ("r", run_jax)):
        for src, text in (("a", text_a), ("b", text_b)):
            run(text=text, checkpoint_dir=str(tmp_path / tag),
                incremental=True, source_id=src)
    total = GenomeLayout(t_read_header(io.StringIO(text_a))[0]).total_len
    a = t_ckpt.load(str(tmp_path / "t"), total)
    b = r_ckpt.load(str(tmp_path / "r"), total)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert (a.sources, a.reads_mapped, a.aligned_bases) \
        == (b.sources, b.reads_mapped, b.aligned_bases)
    for x, y in zip(a.insertions.to_arrays(), b.insertions.to_arrays()):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))


def test_incremental_needs_a_source_id(tmp_path):
    with pytest.raises(RuntimeError, match="source_id"):
        run_port(checkpoint_dir=str(tmp_path), incremental=True)


def test_checkpoint_refuses_bam(tmp_path):
    from sam2consensus_torch.formats import open_alignment_input
    from sam2consensus_torch.formats.bam import sam_text_to_bam

    bam = sam_text_to_bam(TEXT, str(tmp_path / "x.bam"))
    ai = open_alignment_input(bam)
    try:
        with pytest.raises(RuntimeError, match="BAM inputs do not"):
            TorchBackend("cpu").run(ai.contigs, ai.stream, TConfig(
                checkpoint_dir=str(tmp_path / "ck")))
    finally:
        ai.close()


# ------------------------------------------------------------ paranoid --
@pytest.mark.parametrize("pileup", ["pallas", "host"])
def test_paranoid_clean_run(pileup):
    plain, _st, _s = run_port(pileup=pileup)
    got, stats, _s = run_port(pileup=pileup, paranoid=True)
    want, r_stats, _s = run_jax(pileup=pileup, paranoid=True)
    assert got == plain == want
    assert stats.extra["paranoid_result_ok"] is True
    assert stats.extra["paranoid_batches"] \
        == r_stats.extra["paranoid_batches"] >= 1


def test_paranoid_catches_corrupt_batch():
    bad = SegmentBatch(buckets={32: (np.array([10_000], dtype=np.int32),
                                     np.full((1, 32), 1, dtype=np.uint8))},
                       n_reads=1, n_events=32)
    with pytest.raises(RuntimeError, match="paranoid: scatter position") \
            as t_err:
        TorchBackend._paranoid_batch(bad, total_len=100,
                                     stats=BackendStats())
    with pytest.raises(RuntimeError) as r_err:
        JaxBackend()._paranoid_batch(bad, total_len=100,
                                     stats=BackendStats())
    assert str(t_err.value) == str(r_err.value)
    codes = np.full((1, 32), 9, dtype=np.uint8)
    bad2 = SegmentBatch(buckets={32: (np.array([0], np.int32), codes)})
    with pytest.raises(RuntimeError, match="32 invalid symbol codes"):
        TorchBackend._paranoid_batch(bad2, total_len=100,
                                     stats=BackendStats())


def test_paranoid_catches_a_double_count():
    """A unit counted twice (what a replay after a device failure that
    landed mid-unit would do on the card) fails the result check."""
    from sam2consensus_torch.ops.pileup import PileupAccumulator

    counted = []
    orig_add = PileupAccumulator.add

    def add_twice(self, batch):
        orig_add(self, batch)
        if not counted:
            counted.append(1)
            orig_add(self, batch)

    PileupAccumulator.add = add_twice
    try:
        with pytest.raises(RuntimeError, match="paranoid: device event"):
            run_port(pileup="pallas", paranoid=True)
    finally:
        PileupAccumulator.add = orig_add
