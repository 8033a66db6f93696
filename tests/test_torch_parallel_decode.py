"""The shard-owned parallel decoder and its byte-shard planner against the
JAX package's, on the CPU.

* ``ingest.plan_byte_shards`` / ``snap_line_start`` / ``ShardPlan`` and
  ``ReadStream.shard_plan`` equal the reference's on the same bytes;
* ``ParallelFusedDecoder`` at 2-3 threads and a small minimum shard size
  (passed as an argument): in fused mode its counts equal the serial fused
  pass and the JAX decoder's, in slab mode its batches sum to the same
  counts; reads, skips, insertion groups, lines and bytes equal;
* a malformed line in the second shard raises the serial path's type and
  message; a gzip input takes the streaming rung; an infrastructure fault
  retries its shard once, then demotes the ingest to the serial rung.

Every decode runs on a helper thread joined with a timeout, and every
decode worker is gone after each test.
"""

import gc
import gzip
import io
import threading

import numpy as np
import pytest

from sam2consensus_torch import ingest as t_ingest
from sam2consensus_torch.encoder import native_encoder as t_nat
from sam2consensus_torch.encoder import parallel_decode as t_pd
from sam2consensus_torch.encoder.events import GenomeLayout as TLayout
from sam2consensus_torch.encoder.events import \
    group_insertions as t_group
from sam2consensus_torch.encoder.native_encoder import \
    NativeReadEncoder as TNative
from sam2consensus_torch.io import sam as t_sam
from sam2consensus_tpu import ingest as r_ingest
from sam2consensus_tpu.encoder import parallel_decode as r_pd
from sam2consensus_tpu.encoder.events import GenomeLayout as RLayout
from sam2consensus_tpu.encoder.events import group_insertions as r_group
from sam2consensus_tpu.io import sam as r_sam
from sam2consensus_tpu.utils.simulate import SimSpec, simulate

#: seconds any one decode may take before the test fails
LIMIT = 60


@pytest.fixture(autouse=True)
def _threads_joined():
    """After each test: no decode worker left running (each joined with a
    timeout), then JAX-package garbage collected outside any lock."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("decode-worker"):
            t.join(timeout=LIMIT)
            assert not t.is_alive(), t.name
    gc.collect()


def _bounded(fn):
    """Run ``fn`` on a helper thread, joined with a timeout; returns its
    result or re-raises its exception."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as exc:   # handed to the caller below
            box["exc"] = exc

    t = threading.Thread(target=target, name="bounded-decode", daemon=True)
    t.start()
    t.join(timeout=LIMIT)
    assert not t.is_alive(), "decode did not finish in time"
    if "exc" in box:
        raise box["exc"]
    return box["value"]


def _write(tmp_path, text, name="in.sam"):
    path = str(tmp_path / name)
    with open(path, "w", newline="") as fh:
        fh.write(text)
    return path


def _text(seed=61, n_reads=1500, **kw):
    spec = dict(n_contigs=4, contig_len=300, n_reads=n_reads, read_len=60,
                ins_read_rate=0.2, del_read_rate=0.2, seed=seed)
    spec.update(kw)
    return simulate(SimSpec(**spec))


def _run(pkg, path, n_threads, fused=True, min_bytes=1):
    """Decode ``path`` with ``pkg``'s (``"t"`` port, ``"r"`` JAX)
    ``ParallelFusedDecoder``; returns ``(counts, decoder, events, stream,
    layout)``.  Slab-mode batches are counted with numpy."""
    sam, pd, layout_cls = (t_sam, t_pd, TLayout) if pkg == "t" \
        else (r_sam, r_pd, RLayout)

    def work():
        handle = sam.opener(path, binary=True)
        try:
            contigs, _n, first = sam.read_header(handle)
            layout = layout_cls(contigs)
            counts = np.zeros((layout.total_len, 6), dtype=np.int32)
            stream = sam.ReadStream(handle, first)
            dec = pd.ParallelFusedDecoder(
                layout, counts if fused else None, n_threads,
                on_lines=stream.add_lines, on_bytes=stream.add_bytes)
            events = 0
            flat = counts.reshape(-1)
            for batch in dec.encode_input(stream, min_shard_bytes=min_bytes):
                events += batch.n_events
                assert batch.accumulated == fused
                for starts, codes in batch.buckets.values():
                    rows, cols = np.nonzero(codes < 6)
                    idx = (starts[rows].astype(np.int64) + cols) * 6 \
                        + codes[rows, cols]
                    flat += np.bincount(idx, minlength=len(flat)).astype(
                        np.int32)
            return counts, dec, events, stream, layout
        finally:
            handle.close()

    return _bounded(work)


def _serial(path):
    """The port's serial fused pass: ``(counts, encoder, stream)``."""
    def work():
        handle = t_sam.opener(path, binary=True)
        try:
            contigs, _n, first = t_sam.read_header(handle)
            layout = TLayout(contigs)
            counts = np.zeros((layout.total_len, 6), dtype=np.int32)
            stream = t_sam.ReadStream(handle, first)
            enc = TNative(layout, accumulate_into=counts,
                          on_lines=stream.add_lines,
                          on_bytes=stream.add_bytes)
            for _ in enc.encode_blocks_from(stream):
                pass
            return counts, enc, stream
        finally:
            handle.close()

    return _bounded(work)


def _same_groups(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _assert_equal_to_serial_and_reference(path, n_threads, fused=True):
    counts, enc, sstream = _serial(path)
    got, dec, _ev, stream, layout = _run("t", path, n_threads, fused)
    ref, rdec, _rev, rstream, rlayout = _run("r", path, n_threads, fused)
    np.testing.assert_array_equal(got, counts)
    np.testing.assert_array_equal(got, ref)
    assert (dec.n_reads, dec.n_skipped) == (enc.n_reads, enc.n_skipped) \
        == (rdec.n_reads, rdec.n_skipped)
    assert (stream.n_lines, stream.n_bytes) \
        == (sstream.n_lines, sstream.n_bytes) \
        == (rstream.n_lines, rstream.n_bytes)
    _same_groups(t_group(dec.insertions, layout),
                 t_group(enc.insertions, layout))
    _same_groups(t_group(dec.insertions, layout),
                 r_group(rdec.insertions, rlayout))
    return dec


# -- the planner -------------------------------------------------------------
def _bodies():
    body = b"".join(b"line%d\tx\n" % i for i in range(200))
    crlf = body.replace(b"\n", b"\r\n")
    return {"lf": b"@hdr\n" + body, "crlf": b"@hdr\r\n" + crlf,
            "truncated": b"@hdr\n" + body[:-1],
            "one_long_line": b"@hdr\n" + b"x" * 5000 + b"\nshort\n"}


@pytest.mark.parametrize("kind", list(_bodies()))
def test_plan_byte_shards_equals_reference(kind):
    data = _bodies()[kind]
    start = data.index(b"\n") + 1
    for n in (1, 2, 3, 7, 50, 500):
        for min_bytes in (1, 64, t_ingest.DEFAULT_MIN_SHARD_BYTES):
            got = t_ingest.plan_byte_shards(data, start, len(data), n,
                                            min_bytes=min_bytes)
            assert got == r_ingest.plan_byte_shards(
                data, start, len(data), n, min_bytes=min_bytes)
            # the ranges tile the body; each starts on a line start
            assert got[0][0] == start and got[-1][1] == len(data)
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
            assert all(data[lo - 1:lo] == b"\n" for lo, _hi in got[1:])
    for pos in range(start, len(data) + 1, 37):
        assert t_ingest.snap_line_start(data, pos, start, len(data)) == \
            r_ingest.snap_line_start(data, pos, start, len(data))
    assert t_ingest.DEFAULT_MIN_SHARD_BYTES == r_ingest.DEFAULT_MIN_SHARD_BYTES
    assert t_ingest.plan_byte_shards(data, 10, 10, 4) == []


def test_snap_bounds_native_equals_python_twin(monkeypatch):
    from sam2consensus_torch import native

    data = _bodies()["crlf"]
    want = {n: t_ingest._snap_bounds(data, 6, len(data), n)
            for n in (1, 2, 5, 9)}
    monkeypatch.setattr(native, "load", lambda: None)
    assert {n: t_ingest._snap_bounds(data, 6, len(data), n)
            for n in want} == want


def test_shard_plan_equals_reference(tmp_path):
    text = _text(n_reads=300)
    path = _write(tmp_path, text)
    plans = []
    for sam in (t_sam, r_sam):
        with sam.opener(path, binary=True) as handle:
            _c, _n, first = sam.read_header(handle)
            stream = sam.ReadStream(handle, first)
            assert stream.shard_plan(1) is None
            plan = stream.shard_plan(3, min_bytes=1)
            plans.append((plan.ranges, plan.start, plan.end, plan.nbytes,
                          plan.source, bytes(plan.data[plan.start:])))
            assert stream.first == "" or stream.first == b""
    assert plans[0] == plans[1]
    assert len(plans[0][0]) == 3
    # gzip and in-memory handles cannot be byte-sharded
    gz = str(tmp_path / "in.sam.gz")
    with gzip.open(gz, "wt") as fh:
        fh.write(text)
    with t_sam.opener(gz, binary=True) as handle:
        _c, _n, first = t_sam.read_header(handle)
        assert t_sam.ReadStream(handle, first).shard_plan(3) is None
    handle = io.BytesIO(text.encode())
    _c, _n, first = t_sam.read_header(handle)
    assert t_sam.ReadStream(handle, first).shard_plan(3) is None


# -- the decoder -------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "slab"])
@pytest.mark.parametrize("n_threads", [2, 3])
def test_shards_equal_serial_and_reference(tmp_path, n_threads, fused):
    """min_bytes=1 gives one shard per thread, so every cut falls
    mid-line and snapping owns the reads that straddle it."""
    path = _write(tmp_path, _text())
    dec = _assert_equal_to_serial_and_reference(path, n_threads, fused)
    assert dec.counters["ingest_mode"] == {
        "rung": "shards", "threads": n_threads, "shards": n_threads,
        "bytes": dec.counters["ingest_mode"]["bytes"], "fused": fused}
    assert dec.counters["ingest_shards"] == n_threads
    assert dec.counters["ingest_worker_sec"] > 0
    assert dec.counters["ingest_fallback"] == 0


def test_direct_mode_equals_serial_and_reference(tmp_path, monkeypatch):
    """The huge-genome count (int32 straight, private int32 partitions),
    forced onto a small genome through the direct-mode threshold."""
    monkeypatch.setenv("S2C_FUSED_DIRECT_MIN_LEN", "1")   # the reference
    monkeypatch.setattr(t_nat, "FUSED_DIRECT_MIN_LEN", 1)
    path = _write(tmp_path, _text(seed=71, n_reads=1000))
    _assert_equal_to_serial_and_reference(path, 3)


@pytest.mark.parametrize("kind", ["crlf_truncated", "few_records"])
def test_edge_inputs_equal_serial(tmp_path, kind):
    if kind == "crlf_truncated":
        text = _text(seed=62, n_reads=300).replace("\n", "\r\n")[:-2]
    else:
        text = _text(seed=63, n_reads=3)
    path = _write(tmp_path, text)
    _assert_equal_to_serial_and_reference(path, 3)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "slab"])
def test_error_in_second_shard_is_the_serial_error(tmp_path, fused):
    """Two malformed lines, in the second and the third shard: the
    earlier one's exception surfaces, with the serial path's type and
    message (and the JAX decoder's)."""
    lines = _text(seed=65, n_reads=600).splitlines(keepends=True)
    third = len(lines) // 3
    lines.insert(third + 5, "broken\tline\n")
    lines.insert(2 * third + 5, "also\tbroken\tbut\tlater\n")
    path = _write(tmp_path, "".join(lines))
    with pytest.raises(Exception) as serial:
        _serial(path)
    for pkg in ("t", "r"):
        with pytest.raises(type(serial.value)) as got:
            _run(pkg, path, 3, fused)
        assert str(got.value) == str(serial.value)


def test_gzip_takes_the_streaming_rung(tmp_path):
    text = _text(seed=66)
    plain = _write(tmp_path, text)
    gz = str(tmp_path / "in.sam.gz")
    with gzip.open(gz, "wt") as fh:
        fh.write(text)
    counts, enc, _s = _serial(plain)
    got, dec, _ev, stream, _layout = _run("t", gz, 2)
    ref, rdec, _rev, _rs, _rl = _run("r", gz, 2)
    np.testing.assert_array_equal(got, counts)
    np.testing.assert_array_equal(got, ref)
    assert dec.n_reads == enc.n_reads == rdec.n_reads
    assert dec.counters["ingest_mode"]["rung"] == "stream"
    assert dec.counters["ingest_fallback"] == 1
    assert dec.counters["ingest_shards"] == 0


def _faulty_shard(monkeypatch, shard, times):
    """Make ``shard``'s window feed raise MemoryError ``times`` times."""
    orig = t_pd.ParallelFusedDecoder._shard_blocks
    left = [times]

    def blocks(data, lo, hi, shard_idx, horizon, enc):
        if shard_idx == shard and left[0] > 0:
            left[0] -= 1
            raise MemoryError("injected shard fault")
        yield from orig(data, lo, hi, shard_idx, horizon, enc)

    monkeypatch.setattr(t_pd.ParallelFusedDecoder, "_shard_blocks",
                        staticmethod(blocks))


def test_shard_fault_retries_once(tmp_path, monkeypatch):
    path = _write(tmp_path, _text(seed=67))
    counts, enc, _s = _serial(path)
    _faulty_shard(monkeypatch, shard=1, times=1)
    got, dec, _ev, stream, _l = _run("t", path, 3)
    np.testing.assert_array_equal(got, counts)
    assert dec.n_reads == enc.n_reads
    assert dec.counters["ingest_shard_retries"] == 1
    assert dec.counters["ingest_demoted"] == 0


def test_persistent_shard_fault_demotes_to_serial(tmp_path, monkeypatch):
    path = _write(tmp_path, _text(seed=68))
    counts, enc, sstream = _serial(path)
    _faulty_shard(monkeypatch, shard=1, times=2)
    got, dec, _ev, stream, _l = _run("t", path, 3)
    np.testing.assert_array_equal(got, counts)
    assert (dec.n_reads, stream.n_lines) == (enc.n_reads, sstream.n_lines)
    assert dec.counters["ingest_shard_retries"] == 1
    assert dec.counters["ingest_demoted"] == 1


def test_slab_mode_fault_is_raised(tmp_path, monkeypatch):
    """Slab mode has no retry: its slabs may be counted already."""
    path = _write(tmp_path, _text(seed=69))
    _faulty_shard(monkeypatch, shard=1, times=1)
    with pytest.raises(MemoryError, match="injected"):
        _run("t", path, 3, fused=False)


@pytest.mark.parametrize("budget", [0, 20_000, 1 << 29])
def test_extra_counts_budget_clamps_workers(monkeypatch, budget):
    layout_t = TLayout([t_sam.Contig("c", 1000)])
    layout_r = RLayout([r_sam.Contig("c", 1000)])
    counts = np.zeros((1000, 6), dtype=np.int32)
    monkeypatch.setattr(t_pd.ParallelFusedDecoder, "EXTRA_COUNTS_BUDGET",
                        budget)
    monkeypatch.setattr(r_pd.ParallelFusedDecoder, "EXTRA_COUNTS_BUDGET",
                        budget)
    for threads in (1, 4, 16):
        got = t_pd.ParallelFusedDecoder(layout_t, counts, threads).n_threads
        want = r_pd.ParallelFusedDecoder(layout_r, counts, threads).n_threads
        assert got == want
        assert t_pd.ParallelFusedDecoder(layout_t, None, threads).n_threads \
            == threads


def test_constants_equal_reference():
    assert t_pd.ParallelFusedDecoder.EXTRA_COUNTS_BUDGET == \
        r_pd.ParallelFusedDecoder.EXTRA_COUNTS_BUDGET
    assert t_pd.SHARD_BLOCK_BYTES == r_pd.SHARD_BLOCK_BYTES
    # the port's EncodeError is its own class of the same name
    assert [e.__name__ for e in t_pd.PARITY_ERRORS] == \
        [e.__name__ for e in r_pd.PARITY_ERRORS]
