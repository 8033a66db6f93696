"""Host counts, the native tail and the priced gates against the JAX
package's, on the CPU.

* ``HostPileupAccumulator``: counts (row walk, numpy walk, fused decode)
  and ``wire_itemsize`` at maxima 255, 256, 65,535 and 65,536 equal the
  JAX accumulator's; the fused tail takes the narrowed counts;
* the gate ``host_pileup_bound``: its override and link-free branches
  equal the JAX ``host_pileup_max_len``; its measured tables, the input
  sizes it reads (``_input_bytes`` of each format) and the backend's
  decision on them;
* the placement ``tail_placement`` equals the JAX ``_tail_cpu_wins`` over
  a grid, and ``_fetch_costs`` and ``_native_tail_possible`` theirs, with
  the cost constants pinned (the shared environment overrides, the
  port's module constants and the JAX module's set to the same numbers;
  the port's own fixed tail cost set to 0, the reference's model), so
  both packages price with the same inputs;
* ``vote_positions_native`` and ``insertion_tail_host`` equal the JAX
  functions exactly;
* the backend records its decisions in ``stats.extra``; the CPU device is
  link-free and probes nothing.
"""

import gc
import io

import numpy as np
import pytest
import torch

from sam2consensus_torch.backends import torch_backend as tb
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.encoder.events import GenomeLayout as TLayout
from sam2consensus_torch.encoder.events import ReadEncoder as TEncoder
from sam2consensus_torch.encoder.native_encoder import \
    NativeReadEncoder as TNative
from sam2consensus_torch.io import sam as t_sam
from sam2consensus_torch.ops import fused as t_fused
from sam2consensus_torch.ops import insertions as t_ins
from sam2consensus_torch.ops import pileup as t_pileup
from sam2consensus_torch.ops import vote as t_vote
from sam2consensus_tpu.backends import jax_backend as jb
from sam2consensus_tpu.config import RunConfig as RConfig
from sam2consensus_tpu.encoder.events import GenomeLayout as RLayout
from sam2consensus_tpu.encoder.events import ReadEncoder as REncoder
from sam2consensus_tpu.io import sam as r_sam
from sam2consensus_tpu.ops import insertions as r_ins
from sam2consensus_tpu.ops import pileup as r_pileup
from sam2consensus_tpu.ops import vote as r_vote
from sam2consensus_tpu.utils.simulate import SimSpec, sam_text, simulate


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """Collect after each test, outside any lock (ROADMAP §C 2)."""
    yield
    gc.collect()


#: one set of cost constants both packages price with: the port's
#: environment overrides, and the module constants it has no override for
PINNED_ENV = {"S2C_TAIL_RT_MS": "0.05", "S2C_TAIL_LINK_MBPS": "12000",
              "S2C_TAIL_NATIVE_NS": "4.5"}
PINNED = {"TAIL_NATIVE_THR_NS": 0.75, "TAIL_CPU_POS_PER_SEC": 9e6,
          "P5_HOST_NS_PER_CHAR": 5.5, "P5_DEV_NS_PER_CHAR": 2.0,
          "SPARSE_NS_PER_POS": 20.0}


@pytest.fixture
def pinned(monkeypatch):
    # the first two only the reference reads
    for key in ("S2C_TAIL_DEVICE", "S2C_TAIL_ENCODING", "S2C_LINK_PROBE",
                "S2C_HOST_PILEUP_MAX_LEN"):
        monkeypatch.delenv(key, raising=False)
    for key, value in PINNED_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(jb, "TAIL_NATIVE_NS_PER_POS",
                        float(PINNED_ENV["S2C_TAIL_NATIVE_NS"]))
    for attr, value in PINNED.items():
        monkeypatch.setattr(tb, attr, value)
        monkeypatch.setattr(jb, attr, value)
    monkeypatch.setattr(tb, "TAIL_CHIP_FIXED_SEC", 0.0)
    return monkeypatch


def _cpu_wins(*args) -> bool:
    return tb.tail_placement(*args)["chosen"] == "cpu"


# -- the accumulator ---------------------------------------------------------
def _chunks(text):
    """The Python encoder's batches of ``text``, for both packages."""
    out = []
    for sam, layout_cls, enc_cls in ((t_sam, TLayout, TEncoder),
                                     (r_sam, RLayout, REncoder)):
        handle = io.StringIO(text)
        contigs, _n, first = sam.read_header(handle)
        layout = layout_cls(contigs)
        enc = enc_cls(layout)
        out.append((layout, list(enc.encode_segments(
            sam.iter_records(handle, first), chunk_reads=64))))
    return out


TEXT = simulate(SimSpec(n_contigs=4, contig_len=250, n_reads=700,
                        read_len=50, ins_read_rate=0.1, del_read_rate=0.1,
                        seed=41))


@pytest.mark.parametrize("walk", ["native", "numpy"])
def test_host_counts_equal_reference(walk):
    (t_layout, t_chunks), (r_layout, r_chunks) = _chunks(TEXT)
    got = t_pileup.HostPileupAccumulator(t_layout.total_len)
    want = r_pileup.HostPileupAccumulator(r_layout.total_len)
    if walk == "numpy":
        got._lib = want._lib = None
    for tc, rc in zip(t_chunks, r_chunks):
        got.add(tc)
        want.add(rc)
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert got.strategy_used == want.strategy_used
    # the CPU tensor is the host buffer itself
    view = got.counts_on("cpu")
    assert view.dtype == torch.int32 and \
        view.data_ptr() == got.counts_host().ctypes.data


def test_fused_decode_counts_equal_row_walk(tmp_path):
    path = tmp_path / "in.sam"
    path.write_text(TEXT)
    (t_layout, t_chunks), _ = _chunks(TEXT)
    walked = t_pileup.HostPileupAccumulator(t_layout.total_len)
    for c in t_chunks:
        walked.add(c)
    acc = t_pileup.HostPileupAccumulator(t_layout.total_len)
    with t_sam.opener(str(path), binary=True) as handle:
        contigs, _n, first = t_sam.read_header(handle)
        stream = t_sam.ReadStream(handle, first)
        enc = TNative(TLayout(contigs), accumulate_into=acc.counts_host())
        assert enc.counts_fused
        for batch in enc.encode_blocks_from(stream):
            assert batch.accumulated and not batch.buckets
            acc.add(batch)
    np.testing.assert_array_equal(acc.counts_host(), walked.counts_host())
    assert acc.strategy_used["host_fused"] >= 1


@pytest.mark.parametrize("peak,itemsize", [(255, 1), (256, 2), (65535, 2),
                                           (65536, 4)])
def test_wire_itemsize_equals_reference(peak, itemsize):
    counts = np.random.default_rng(5).integers(0, 7, (64, 6)).astype(
        np.int32)
    counts[3, 2] = peak
    got = t_pileup.HostPileupAccumulator(64)
    want = r_pileup.HostPileupAccumulator(64)
    got.set_counts(counts)
    want.set_counts(counts)
    assert got.wire_itemsize() == want.wire_itemsize() == itemsize
    np.testing.assert_array_equal(got.counts_host(), counts)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int32])
def test_fused_tail_takes_narrowed_counts(dtype):
    """The tail widens uint8 / uint16 counts itself: the same packed
    buffer as from int32 counts."""
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 200, (300, 6)).astype(np.int32)
    counts[rng.random(300) < 0.2] = 0
    wide = torch.from_numpy(counts)
    narrow = torch.empty(wide.shape, dtype=dtype)
    narrow.copy_(wide)
    offsets = torch.tensor([0, 120, 300])
    args = ([0.25, 0.75], offsets)
    for fn, extra in ((t_fused.vote_packed_simple, (2, 0, False)),
                      (t_fused.vote_packed_simple, (1, ord("-"), True))):
        assert torch.equal(fn(narrow, *args, *extra), fn(wide, *args, *extra))
    sk = torch.tensor([5, 130, -1, -1])
    nc = torch.tensor([2, 3, 0, 0], dtype=torch.int32)
    ev = [torch.tensor(v, dtype=torch.int32) for v in
          ([0, 0, 1, 1, 1], [0, 1, 0, 1, 2], [1, 2, 3, 4, 1])]
    assert torch.equal(
        t_fused.vote_packed(narrow, *args, sk, nc, *ev, 1, 4, 0, False),
        t_fused.vote_packed(wide, *args, sk, nc, *ev, 1, 4, 0, False))


# -- the gates ---------------------------------------------------------------
@pytest.mark.parametrize("native_tail", [False, True])
@pytest.mark.parametrize("link_free", [False, True])
def test_host_pileup_bound_equals_reference(monkeypatch, native_tail,
                                           link_free):
    """The override and the link-free branch equal the reference's; the
    measured bounds are the port's own tables."""
    args = (native_tail, link_free)
    monkeypatch.setenv("S2C_HOST_PILEUP_MAX_LEN", "123456")
    assert t_pileup.host_pileup_bound(1, *args) == (123456, None, "env")
    assert r_pileup.host_pileup_max_len(*args) == 123456
    monkeypatch.delenv("S2C_HOST_PILEUP_MAX_LEN")
    got = t_pileup.host_pileup_bound(1, *args)       # the first entry
    if native_tail and link_free:
        # the no-bound branch rests on no measured constant
        assert got == (1 << 62, None, "link_free")
        assert r_pileup.host_pileup_max_len(*args) == 1 << 62
    elif native_tail:
        assert got == (*t_pileup.HOST_PILEUP_NATIVE_BOUNDS[0], "native_tail")
    else:
        assert got == (0, 0, "default")


@pytest.mark.parametrize("total_len,want", [
    (5, (10, 100)), (10, (10, 100)), (11, (30, 50)), (30, (30, 50)),
    (31, (30, 0))])
def test_host_pileup_bound_reads_the_table(monkeypatch, total_len, want):
    """The first entry whose length covers the genome gives its byte
    bound; past the last one, no input fits."""
    monkeypatch.delenv("S2C_HOST_PILEUP_MAX_LEN", raising=False)
    monkeypatch.setattr(t_pileup, "HOST_PILEUP_NATIVE_BOUNDS",
                        ((10, 100), (30, 50)))
    assert t_pileup.host_pileup_bound(total_len, True) == \
        (*want, "native_tail")


def test_host_pileup_bound_rejects_a_bad_override(monkeypatch):
    monkeypatch.setenv("S2C_HOST_PILEUP_MAX_LEN", "8M")
    with pytest.raises(RuntimeError, match="plain integer"):
        t_pileup.host_pileup_bound(1000)


GRID = [(total_len, n_thr, itemsize, aligned)
        for total_len in (400, 50_000, 4_600_000, 40_000_000)
        for n_thr in (1, 3)
        for itemsize in (1, 2, 4)
        for aligned in (0, 1000, 10 ** 8)]


@pytest.mark.parametrize("native_tail", [False, True])
@pytest.mark.parametrize("link_mbps", ["40", "12000"])
def test_tail_placement_and_fetch_costs_equal_reference(pinned, native_tail,
                                                        link_mbps):
    pinned.setenv("S2C_TAIL_LINK_MBPS", link_mbps)
    bps = float(link_mbps) * 1e6
    for total_len, n_thr, itemsize, aligned in GRID:
        upload = total_len * 6 * itemsize
        got = _cpu_wins(total_len, n_thr, upload, native_tail, None,
                        aligned)
        assert got == jb._tail_cpu_wins(total_len, n_thr, upload,
                                        native_tail, aligned), \
            (total_len, n_thr, itemsize, aligned)
        cap = t_fused.pad_cap(min(total_len, aligned) + 1) \
            if aligned else None
        assert tb.sparse_capacity(total_len, aligned) == cap
        assert tb._fetch_costs(total_len, n_thr, cap, bps) == \
            jb._fetch_costs(total_len, n_thr, cap, bps)
        place = tb.tail_placement(total_len, n_thr, upload, native_tail,
                                  None, aligned)
        assert place["link_source"] == "env"
        assert (place["cpu_sec"] < place["chip_sec"]) == got


def test_fixed_tail_cost_moves_the_crossover(pinned):
    """The port's fixed term (its tail is many launches, not one
    dispatch) keeps more tails on the host; 0 is the reference's model."""
    args = (200_000, 1, 200_000 * 6, True)
    assert not _cpu_wins(*args) and not jb._tail_cpu_wins(*args)
    pinned.setattr(tb, "TAIL_CHIP_FIXED_SEC", 4.5e-3)
    assert _cpu_wins(*args)
    place = tb.tail_placement(*args)
    assert place["fixed_sec"] == pytest.approx(4.5e-3)
    assert place["chip_sec"] > place["cpu_sec"] > 0


def test_a_host_vote_under_the_fixed_cost_is_not_priced(pinned):
    """A host vote cheaper than the card's fixed cost alone wins whatever
    the link, and one dearer than the card's bill at the worst link
    (``LINK_RT_SEC_CEIL``, ``LINK_BPS_FLOOR``) loses whatever the link:
    neither probes nor reads it.  Only a vote between the two does."""
    for key in ("S2C_TAIL_RT_MS", "S2C_TAIL_LINK_MBPS"):
        pinned.delenv(key)
    pinned.setattr(tb, "TAIL_CHIP_FIXED_SEC", 2e-3)

    def no_probe(device=None):
        raise AssertionError("the link was probed")

    pinned.setattr(tb, "_probed_link", no_probe)
    place = tb.tail_placement(100_000, 2, 600_000, True)     # 0.53 ms
    assert place["chosen"] == "cpu"
    assert place["link_source"] == "bounded"
    assert "chip_sec" not in place and "link_bps" not in place
    place = tb.tail_placement(1_000_000, 2, 6_000_000, True)  # 5.25 ms
    assert place["chosen"] == "device"
    assert place["link_source"] == "bounded"
    with pytest.raises(AssertionError, match="probed"):
        tb.tail_placement(400_000, 2, 2_400_000, True)       # 2.1 ms


def test_unpriced_encodings_are_left_out(pinned):
    """The card's bill takes the cheapest fetch it can price: without the
    run's aligned bases the sparse head is left out (as in the
    reference), and with them a sparse genome's bill is the sparse
    fetch."""
    pinned.setenv("S2C_TAIL_LINK_MBPS", "40")
    bps = 40e6
    costs = tb._fetch_costs(4_000_000, 2, None, bps)
    assert sorted(map(str, costs)) == ["None", "packed5"]
    assert costs[None] == 8_000_000 / bps > costs["packed5"]
    place = tb.tail_placement(4_000_000, 2, 24_000_000, True)
    assert place["chip_sec"] == pytest.approx(
        5e-5 + 24_000_000 / bps + min(costs.values()))
    cap = tb.sparse_capacity(4_000_000, 1000)
    sparse = tb._fetch_costs(4_000_000, 2, cap, bps)[cap]
    assert sparse < min(costs.values())
    place = tb.tail_placement(4_000_000, 2, 24_000_000, True, None, 1000)
    assert place["chip_sec"] == pytest.approx(5e-5 + 24_000_000 / bps
                                              + sparse)


@pytest.mark.parametrize("library", [True, False], ids=["loaded", "missing"])
@pytest.mark.parametrize("has_insertions", [True, False])
@pytest.mark.parametrize("encoding", [None, "auto", "packed5"])
@pytest.mark.parametrize("ins_kernel", ["auto", "scatter", "pallas"])
def test_native_tail_possible_equals_reference(monkeypatch, library,
                                               has_insertions, encoding,
                                               ins_kernel):
    """A forced tail encoding and ``--insertion-kernel pallas`` (with
    insertions) keep the tail off the native vote, as in the reference."""
    from sam2consensus_torch import native as t_native
    from sam2consensus_tpu import native as r_native

    monkeypatch.delenv("S2C_TAIL_DEVICE", raising=False)  # the reference's
    if encoding is None:
        monkeypatch.delenv("S2C_TAIL_ENCODING", raising=False)
    else:
        monkeypatch.setenv("S2C_TAIL_ENCODING", encoding)
    if not library:
        monkeypatch.setattr(t_native, "load", lambda: None)
        monkeypatch.setattr(r_native, "load", lambda: None)
    got = tb._native_tail_possible(TConfig(ins_kernel=ins_kernel),
                                   has_insertions)
    assert got == jb._native_tail_possible(RConfig(ins_kernel=ins_kernel),
                                           has_insertions)
    assert got == (library and encoding != "packed5"
                   and not (has_insertions and ins_kernel == "pallas"))


def test_link_constants_without_a_card(monkeypatch):
    """The CPU device and ``S2C_LINK_PROBE=0`` probe nothing; an override
    is named as such."""
    for key in ("S2C_TAIL_RT_MS", "S2C_TAIL_LINK_MBPS", "S2C_LINK_PROBE"):
        monkeypatch.delenv(key, raising=False)
    assert tb._probed_link("cpu") is None
    monkeypatch.setenv("S2C_LINK_PROBE", "0")
    assert tb._probed_link() is None
    assert tb._link_constants() == (tb.TAIL_RT_SEC_DEFAULT,
                                    tb.TAIL_LINK_BPS_DEFAULT, "default")
    monkeypatch.setenv("S2C_TAIL_LINK_MBPS", "250")
    assert tb._link_constants() == (tb.TAIL_RT_SEC_DEFAULT, 250e6,
                                    "env+default")
    monkeypatch.setenv("S2C_TAIL_RT_MS", "2")
    assert tb._link_constants() == (2e-3, 250e6, "env")


def _inputs(tmp_path):
    """One small alignment as plain SAM, gzip SAM, BGZF SAM and BAM, each
    opened as the CLI opens it; and the SAM body's bytes."""
    from sam2consensus_torch.formats import bam as t_bam
    from sam2consensus_torch.formats import bgzf as t_bgzf

    text = TEXT.encode()
    body = len(text) - len(b"".join(
        line for line in text.splitlines(keepends=True)
        if line.startswith(b"@")))
    paths = {"sam": tmp_path / "a.sam", "sam.gz": tmp_path / "a.sam.gz",
             "sam.bgzf": tmp_path / "a.bgzf.sam.gz", "bam": tmp_path / "a.bam"}
    paths["sam"].write_bytes(text)
    import gzip

    paths["sam.gz"].write_bytes(gzip.compress(text))
    t_bgzf.write_bgzf(text, str(paths["sam.bgzf"]))
    with io.StringIO(TEXT) as handle:
        contigs, _n, first = t_sam.read_header(handle)
        t_bam.write_bam(contigs, [
            (r.refname, r.pos, r.cigar, r.seq)
            for r in t_sam.iter_records(handle, first)], str(paths["bam"]))
    return paths, body


def test_input_bytes_of_each_format(tmp_path):
    """The gate's size of an input: a plain SAM file's body, a BGZF
    container's inflated bytes (counted only until they pass the cap),
    nothing for a plain gzip stream or records in memory."""
    from sam2consensus_torch.formats import open_alignment_input
    from sam2consensus_torch.formats.bgzf import BgzfReader, inflated_bytes

    paths, body = _inputs(tmp_path)
    sizes = {}
    for fmt, path in paths.items():
        got = open_alignment_input(str(path))
        try:
            assert got.format == fmt
            sizes[fmt] = tb._input_bytes(got.stream, 1 << 40)
            if fmt in ("sam.bgzf", "bam"):
                assert tb._input_bytes(got.stream, 10) < sizes[fmt]
        finally:
            got.handle.close()
    assert sizes["sam"] == sizes["sam.bgzf"] - (len(TEXT.encode()) - body)
    assert sizes["sam"] == body and sizes["sam.gz"] is None
    whole = BgzfReader(str(paths["bam"]))
    assert sizes["bam"] == inflated_bytes(whole) == len(whole.read())
    assert tb._input_bytes(iter([]), 1 << 40) is None
    # a container with no file descriptor reads its ISIZE fields too
    mem = BgzfReader(io.BytesIO(paths["sam.bgzf"].read_bytes()))
    assert inflated_bytes(mem) == len(TEXT.encode())


@pytest.mark.parametrize("case,path", [
    ("fits", "host"), ("too_many_bytes", "device"),
    ("too_long", "device"), ("size_unknown", "device"),
    ("env_length_only", "host")])
def test_auto_gate_prices_length_and_bytes(tmp_path, monkeypatch, case,
                                           path):
    """On a device with a link, ``--pileup auto`` takes the host counts
    only for a genome within the length bound whose input is known to
    fit the byte bound; ``S2C_HOST_PILEUP_MAX_LEN`` is a length bound
    alone, as in the reference."""
    from sam2consensus_torch.formats import open_alignment_input

    paths, body = _inputs(tmp_path)
    got = open_alignment_input(str(paths["sam.gz" if case == "size_unknown"
                                         else "sam"]))
    layout = TLayout(got.contigs)
    monkeypatch.delenv("S2C_HOST_PILEUP_MAX_LEN", raising=False)
    monkeypatch.setattr(t_pileup, "HOST_PILEUP_NATIVE_BOUNDS", (
        (layout.total_len - (case == "too_long"),
         body - (case in ("too_many_bytes", "env_length_only"))),))
    if case == "env_length_only":
        monkeypatch.setenv("S2C_HOST_PILEUP_MAX_LEN", str(layout.total_len))
    # a device with a link, whose accumulator this test does not need
    monkeypatch.setattr(tb, "PileupAccumulator", lambda *a: "device")
    backend = TorchBackend("cpu")
    backend.device = torch.device("meta")
    stats = tb.BackendStats()
    try:
        acc = backend._make_accumulator(layout, got.stream,
                                        TConfig(pileup="auto"), stats)
    finally:
        got.handle.close()
    assert stats.extra["pileup_path"] == path
    assert (acc == "device") == (path == "device")
    extra = stats.extra
    if case == "env_length_only":
        assert (extra["host_bytes_bound"], extra["input_bytes"],
                extra["host_bound_reason"]) == (None, None, "env")
    else:
        assert extra["host_bound_reason"] == "native_tail"
        assert extra["input_bytes"] == (
            None if case in ("too_long", "size_unknown") else body)


# -- the native tail ---------------------------------------------------------
@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("min_depth", [1, 4])
def test_vote_positions_native_equals_reference(threads, min_depth):
    rng = np.random.default_rng(17)
    counts = rng.integers(0, 9, (5000, 6)).astype(np.int32)
    counts[rng.random(5000) < 0.3] = 0
    counts[rng.random(5000) < 0.1, 0] = 40
    thresholds = [0.1, 0.25, 0.5, 0.75, 1.0]
    got = t_vote.vote_positions_native(counts, thresholds, min_depth,
                                       threads=threads)
    want = r_vote.vote_positions_native(counts, thresholds, min_depth,
                                        threads=threads)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_insertion_tail_host_equals_reference(monkeypatch, native):
    from sam2consensus_torch import native as t_native
    from sam2consensus_tpu import native as r_native

    if not native:
        monkeypatch.setattr(t_native, "load", lambda: None)
        monkeypatch.setattr(r_native, "load", lambda: None)
    rng = np.random.default_rng(23)
    k, kp, cp, e = 13, 16, 8, 600
    ev_key = rng.integers(0, k, e).astype(np.int32)
    ev_col = rng.integers(0, cp, e).astype(np.int32)
    ev_code = rng.integers(1, 6, e).astype(np.int32)
    site_cov = rng.integers(0, 80, kp).astype(np.int32)
    n_cols = rng.integers(0, cp + 1, kp).astype(np.int32)
    thresholds = [0.25, 0.5, 0.9]
    got = t_ins.insertion_tail_host(kp, cp, ev_key, ev_col, ev_code,
                                    site_cov, n_cols, thresholds, k)
    want = r_ins.insertion_tail_host(kp, cp, ev_key, ev_col, ev_code,
                                     site_cov, n_cols, thresholds, k)
    assert got.dtype == want.dtype and got.shape == (3, k, cp)
    np.testing.assert_array_equal(got, want)


# -- the backend -------------------------------------------------------------
def _run(text, **cfg):
    handle = io.StringIO(text)
    contigs, _n, first = t_sam.read_header(handle)
    res = TorchBackend("cpu").run(contigs, t_sam.iter_records(handle, first),
                                  TConfig(prefix="p", **cfg))
    return {n: [(r.header, r.seq) for r in recs]
            for n, recs in res.fastas.items()}, res.stats.extra


INS_TEXT = sam_text([("r", 40)], [
    ("r", 1, "10M2I10M", "ACGTACGTACGGACGTACGTAC"),
    ("r", 3, "8M3I8M", "GTACGTACTTTGTACGTAC"),
    ("r", 1, "30M", "ACGTACGTAC" * 3)])


@pytest.mark.parametrize("text", [TEXT, INS_TEXT], ids=["sim", "ins"])
@pytest.mark.parametrize("fill", ["-", "N", "?!"])
def test_backend_host_paths_equal_device_path(monkeypatch, text, fill):
    """On the CPU device: the host counts with the native tail, with the
    plain PyTorch tail (the native library ruled out of the tail) and the
    device accumulator give the same records; each run records its
    decisions.  Records in memory have no known size: without the native
    tail, ``auto`` takes the device accumulator."""
    want, extra = _run(text, pileup="pallas", ins_kernel="pallas",
                       fill=fill, min_depth=2, thresholds=[0.25, 0.75])
    assert extra["pileup_path"] == "device"
    assert extra["tail_placement"] == {"chosen": "device",
                                       "pileup": "device"}
    for pileup in ("auto", "host"):
        got, extra = _run(text, pileup=pileup, fill=fill, min_depth=2,
                          thresholds=[0.25, 0.75])
        assert got == want
        assert extra["pileup_path"] == "host"
        assert extra["tail_device"] == "cpu" and extra["tail_native"]
        assert extra["tail_placement"] == {"chosen": "cpu",
                                           "link_free": True}
        if pileup == "auto":
            assert (extra["host_bound"], extra["host_bound_reason"]) == \
                (1 << 62, "link_free")
    monkeypatch.setattr(tb, "_native_tail_possible", lambda *args: False)
    got, extra = _run(text, pileup="host", fill=fill, min_depth=2,
                      thresholds=[0.25, 0.75])
    assert got == want
    assert extra["pileup_path"] == "host" and not extra["tail_native"]
    assert extra["counts_uploads"] == 0
    got, extra = _run(text, pileup="auto", fill=fill, min_depth=2,
                      thresholds=[0.25, 0.75])
    assert got == want
    assert (extra["host_bound_reason"], extra["input_bytes"],
            extra["pileup_path"]) == ("default", None, "device")


def test_backend_rejects_an_unported_strategy():
    with pytest.raises(ValueError, match="auto, pallas, scatter and host"):
        _run(TEXT, pileup="mxu")
