"""The port's tolerant decode (``--on-bad-record``) against the JAX
package's, on the CPU.

The rung matrix of ``tests/test_badrecords.py`` on the port: the committed
fixture families with injected malformed records, decoded by the Python
decoder, the native serial decoder, the sharded decoder at 2 threads (and
the streaming rung on gzip) and BAM (native and Python lanes), in ``skip``
and ``quarantine``: the same FASTA as the JAX backend (and as the pinned
clean fixture), the same ``bad_records``, the same sidecar bytes.  Budget
failures carry the same messages; the strict default is unchanged; the
CLI's validation errors match.
"""

import gc
import gzip
import json
import os

import pytest

from sam2consensus_torch import native as t_native
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.formats import open_alignment_input as t_open
from sam2consensus_torch.ingest import badrecords as t_bad
from sam2consensus_torch.io.fasta import render_file as t_render
from sam2consensus_tpu.backends.jax_backend import JaxBackend
from sam2consensus_tpu.config import RunConfig as RConfig
from sam2consensus_tpu.formats import open_alignment_input as r_open
from sam2consensus_tpu.formats.bam import sam_text_to_bam
from sam2consensus_tpu.ingest import badrecords as r_bad
from sam2consensus_tpu.io.fasta import render_file as r_render

DATA = os.path.join(os.path.dirname(__file__), "data")
FAMILIES = ("formats_short", "formats_longread", "formats_adversarial")
HAVE_NATIVE = t_native.load() is not None
needs_native = pytest.mark.skipif(not HAVE_NATIVE,
                                  reason="native decoder unavailable")


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


def _refs(text):
    out = []
    for ln in text.splitlines():
        if ln.startswith("@SQ"):
            name = length = None
            for f in ln.split("\t"):
                if f.startswith("SN:"):
                    name = f[3:].strip()
                elif f.startswith("LN:"):
                    length = int(f[3:])
            out.append((name, length or 0))
    return out


def make_dirty(text, bam_safe=False):
    """The reference test's dirt (its whole reason taxonomy), at
    deterministic positions spread through the body."""
    name, ln = _refs(text)[0]
    dirt = [(f"oobA\t0\t{name}\t{ln * 2 + 7}\t60\t8M\t*\t0\t0\t"
             "ACGTACGT\t*\n", "out_of_bounds_pos"),
            (f"oobB\t0\t{name}\t{ln + 1}\t60\t4M\t*\t0\t0\tACGT\t*\n",
             "out_of_bounds_pos")]
    if not bam_safe:
        dirt += [
            ("junk\tline\n", "bad_field_count"),
            (f"badpos\t0\t{name}\txx\t60\t4M\t*\t0\t0\tACGT\t*\n",
             "bad_pos"),
            ("noref\t0\tNOSUCHREF\t5\t60\t4M\t*\t0\t0\tACGT\t*\n",
             "unknown_reference"),
            (f"badalpha\t0\t{name}\t1\t60\t4M\t*\t0\t0\tAC!T\t*\n",
             "bad_alphabet")]
    lines = text.splitlines(keepends=True)
    body = [i for i, x in enumerate(lines) if not x.startswith("@")]
    spots = [body[(k * len(body)) // len(dirt)] for k in range(len(dirt))]
    order = sorted(zip(spots, dirt), key=lambda t: t[0])
    for spot, (line, _why) in reversed(order):
        lines.insert(spot, line)
    return "".join(lines), [(x.rstrip("\n"), why) for _s, (x, why) in order]


def _expected(family):
    with open(os.path.join(DATA, f"{family}.expected.fasta")) as fh:
        return fh.read()


def run_port(path, fmt="auto", **kw):
    ai = t_open(path, fmt)
    try:
        res = TorchBackend("cpu").run(ai.contigs, ai.stream,
                                      TConfig(prefix="fixture", **kw))
    finally:
        ai.close()
    return "".join(t_render(res.fastas[c.name], 0) for c in ai.contigs
                   if c.name in res.fastas), res


def run_jax(path, fmt="auto", **kw):
    ai = r_open(path, fmt, binary=True)
    try:
        res = JaxBackend().run(ai.contigs, ai.stream,
                               RConfig(prefix="fixture", shards=1, **kw))
    finally:
        ai.close()
    return "".join(r_render(res.fastas[c.name], 0) for c in ai.contigs
                   if c.name in res.fastas), res


def _sidecar(path, tmp_dir):
    """The sidecar's bytes with its own directory written out of them
    (the summary line names the file's absolute path)."""
    with open(path) as fh:
        return fh.read().replace(str(tmp_dir), "<dir>")


def _entries(path):
    head, *rows = [json.loads(x) for x in open(path)]
    assert head == {"schema": "s2c-quarantine/1"}
    return [(e["record"], e["reason"]) for e in rows[:-1]], \
        rows[-1]["summary"]


def _dirty_files(family, tmp_path):
    text = open(os.path.join(DATA, f"{family}.sam")).read()
    dirty, entries = make_dirty(text)
    sam = str(tmp_path / f"{family}.dirty.sam")
    with open(sam, "w") as fh:
        fh.write(dirty)
    gz = str(tmp_path / f"{family}.dirty.sam.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(dirty.encode("ascii"))
    return sam, gz, entries


TEXT_CELLS = {
    "py": ("sam", dict(decoder="py")),
    "serial": ("sam", dict(decode_threads=1)),
    "serial_pallas": ("sam", dict(decode_threads=1, pileup="pallas")),
    "shard": ("sam", dict(decode_threads=2)),
    "shard_pallas": ("sam", dict(decode_threads=2, pileup="pallas")),
    "stream": ("gz", dict(decode_threads=2)),
}


@needs_native
@pytest.mark.parametrize("mode", ["skip", "quarantine"])
@pytest.mark.parametrize("cell", sorted(TEXT_CELLS))
@pytest.mark.parametrize("family", FAMILIES)
def test_text_rung_matrix(family, cell, mode, tmp_path):
    sam, gz, entries = _dirty_files(family, tmp_path)
    which, extra = TEXT_CELLS[cell]
    path = sam if which == "sam" else gz
    outs = {}
    for tag, run in (("t", run_port), ("r", run_jax)):
        (tmp_path / tag).mkdir()
        side = str(tmp_path / tag / "q.jsonl")
        kw = dict(on_bad_record=mode, **extra)
        if mode == "quarantine":
            kw["quarantine_out"] = side
        out, res = run(path, **kw)
        outs[tag] = (out, res.stats.extra["bad_records"],
                     _sidecar(side, tmp_path / tag)
                     if mode == "quarantine" else None)
        assert "quarantine_sidecar" in res.stats.extra \
            or mode == "skip"
    assert outs["t"] == outs["r"]
    assert outs["t"][0] == _expected(family)
    assert outs["t"][1] == len(entries)
    if mode == "quarantine" and cell != "py":
        # raw-line rungs store the lines themselves, in stream order
        got, _summary = _entries(str(tmp_path / "t" / "q.jsonl"))
        assert got == entries


@needs_native
@pytest.mark.parametrize("decoder", ["native", "py"])
@pytest.mark.parametrize("family", FAMILIES)
def test_bam_rung_matrix(family, decoder, tmp_path):
    text = open(os.path.join(DATA, f"{family}.sam")).read()
    dirty, entries = make_dirty(text, bam_safe=True)
    bam = sam_text_to_bam(dirty, str(tmp_path / f"{family}.dirty.bam"))
    outs = {}
    for tag, run in (("t", run_port), ("r", run_jax)):
        (tmp_path / tag).mkdir()
        side = str(tmp_path / tag / "q.jsonl")
        out, res = run(bam, fmt="bam", on_bad_record="quarantine",
                       quarantine_out=side, decoder=decoder)
        outs[tag] = (out, res.stats.extra["bad_records"],
                     _sidecar(side, tmp_path / tag))
    assert outs["t"] == outs["r"]
    assert outs["t"][0] == _expected(family)
    got, _summary = _entries(str(tmp_path / "t" / "q.jsonl"))
    assert sorted(why for _r, why in got) \
        == sorted(why for _l, why in entries)


@needs_native
def test_sidecar_same_across_rungs(tmp_path):
    """The raw-line rungs write the same sidecar bytes."""
    sam, gz, _entries_ = _dirty_files("formats_short", tmp_path)
    sides = {}
    for rung, path, extra in (("serial", sam, dict(decode_threads=1)),
                              ("shard", sam, dict(decode_threads=2)),
                              ("stream", gz, dict(decode_threads=2))):
        side = tmp_path / rung / "q.jsonl"
        side.parent.mkdir()
        run_port(path, on_bad_record="quarantine", quarantine_out=str(side),
                 **extra)
        sides[rung] = _sidecar(str(side), side.parent)
    assert sides["serial"] == sides["shard"] == sides["stream"]


@needs_native
@pytest.mark.parametrize("pileup", ["pallas", "host"])
def test_sidecar_same_across_many_shards(tmp_path, monkeypatch, pileup):
    """Shards small enough that the input splits many ways: the sharded
    rung's sidecar (partitions keyed by shard, merged in stream order)
    is the serial rung's, byte for byte."""
    from sam2consensus_torch.encoder.parallel_decode import \
        ParallelFusedDecoder

    monkeypatch.setattr(ParallelFusedDecoder.encode_input, "__defaults__",
                        (2048,))
    sam, _gz, entries = _dirty_files("formats_short", tmp_path)
    sides = {}
    for threads in ("1", "4"):
        side = tmp_path / threads / "q.jsonl"
        side.parent.mkdir()
        _out, res = run_port(sam, on_bad_record="quarantine",
                             quarantine_out=str(side), pileup=pileup,
                             decode_threads=int(threads))
        sides[threads] = _sidecar(str(side), side.parent)
    assert res.stats.extra["ingest_mode"]["shards"] > 2
    assert sides["1"] == sides["4"]
    assert _entries(str(tmp_path / "4" / "q.jsonl"))[0] == entries


@needs_native
def test_strict_default_is_unchanged(tmp_path):
    """``--on-bad-record fail``: the first bad record ends the run with the
    JAX backend's error type, message and input offset, on every rung."""
    sam, gz, entries = _dirty_files("formats_short", tmp_path)
    want_off = open(sam).read().index(entries[0][0])
    errs = {}
    for rung, path, extra in (("py", sam, dict(decoder="py")),
                              ("serial", sam, dict(decode_threads=1)),
                              ("shard", sam, dict(decode_threads=2)),
                              ("stream", gz, dict(decode_threads=2))):
        for tag, run in (("t", run_port), ("r", run_jax)):
            with pytest.raises((ValueError, KeyError, IndexError)) as ei:
                run(path, **extra)
            errs[rung, tag] = (type(ei.value).__name__, str(ei.value),
                               getattr(ei.value, "s2c_offset", None))
    for rung in ("py", "serial", "shard", "stream"):
        assert errs[rung, "t"] == errs[rung, "r"]
    assert errs["serial", "t"][2] == want_off


@needs_native
@pytest.mark.parametrize("budget,extra", [
    ("2", dict(decode_threads=1)), ("3", dict(decode_threads=2)),
    ("0.1%", dict(decode_threads=1)), ("1%", dict(decoder="py"))])
def test_budget_failure_equals_jax(budget, extra, tmp_path):
    sam, _gz, _entries = _dirty_files("formats_short", tmp_path)
    msgs = {}
    for tag, run in (("t", run_port), ("r", run_jax)):
        (tmp_path / tag).mkdir()
        side = str(tmp_path / tag / "q.jsonl")
        with pytest.raises(Exception) as ei:
            run(sam, on_bad_record="quarantine", quarantine_out=side,
                max_bad_records=budget, **extra)
        assert type(ei.value).__name__ == "BadRecordBudgetExceeded"
        assert ei.value.data_error
        summary = dict(ei.value.summary)
        summary["sidecar"] = str(summary["sidecar"]).replace(
            str(tmp_path / tag), "<dir>")
        msgs[tag] = (str(ei.value), summary, _sidecar(side, tmp_path / tag))
    assert msgs["t"] == msgs["r"]


@needs_native
def test_budget_boundary(tmp_path):
    sam, _gz, entries = _dirty_files("formats_short", tmp_path)
    n = len(entries)
    out, res = run_port(sam, on_bad_record="skip",
                        max_bad_records=str(n + 1))
    assert out == _expected("formats_short")
    assert res.stats.extra["bad_records"] == n
    with pytest.raises(t_bad.BadRecordBudgetExceeded):
        run_port(sam, on_bad_record="skip", max_bad_records=str(n))


@needs_native
def test_poison_input_never_retries_or_demotes(tmp_path):
    """A blown budget is DATA: under ``fallback`` the run fails as it is,
    with no retry and no demotion."""
    sam, _gz, _entries = _dirty_files("formats_short", tmp_path)
    with pytest.raises(t_bad.BadRecordBudgetExceeded):
        run_port(sam, on_bad_record="skip", max_bad_records="1",
                 pileup="pallas", on_device_error="fallback",
                 decode_threads=1)


def test_counters_and_summary_published(tmp_path):
    sam, _gz, entries = _dirty_files("formats_short", tmp_path)
    _out, t_res = run_port(sam, on_bad_record="skip", decoder="py")
    _out, r_res = run_jax(sam, on_bad_record="skip", decoder="py")

    def keys(extra):
        return {k: v for k, v in extra.items()
                if k.startswith(("ingest/bad_records", "quarantine"))}

    assert keys(t_res.stats.extra) == keys(r_res.stats.extra)
    assert t_res.stats.extra["ingest/bad_records"] == len(entries)


# ---------------------------------------------------------- policy --
@pytest.mark.parametrize("kw", [
    dict(on_bad_record="bogus"), dict(max_bad_records="5"),
    dict(on_bad_record="skip", max_bad_records="x"),
    dict(on_bad_record="skip", max_bad_records="120%"),
    dict(on_bad_record="skip", max_bad_records="-1"),
    dict(on_bad_record="skip", quarantine_out="q.jsonl")])
def test_policy_errors_equal_reference(kw):
    with pytest.raises(ValueError) as t_err:
        t_bad.policy_from_config(TConfig(**kw))
    with pytest.raises(ValueError) as r_err:
        r_bad.policy_from_config(RConfig(**kw))
    assert str(t_err.value) == str(r_err.value)


@pytest.mark.parametrize("argv", [
    ["--max-bad-records", "5"],
    ["--on-bad-record", "skip", "--max-bad-records", "abc"],
    ["--on-bad-record", "skip", "--quarantine-out", "q.jsonl"],
    ["--fault-inject", "bogus:rpc:0"],
    ["--incremental"]])
def test_cli_validation_errors_equal_reference(argv, tmp_path):
    from sam2consensus_torch.cli import main as t_main
    from sam2consensus_tpu.cli import main as r_main

    sam = os.path.join(DATA, "formats_short.sam")
    base = ["-i", sam, "-o", str(tmp_path / "out"), "--quiet"]
    with pytest.raises(SystemExit) as t_exit:
        t_main(base + argv, device="cpu")
    with pytest.raises(SystemExit) as r_exit:
        r_main(base + ["--backend", "jax"] + argv)
    assert str(t_exit.value.code) == str(r_exit.value.code)


@needs_native
def test_cli_quarantine_end_to_end(tmp_path, capsys):
    from sam2consensus_torch.cli import main as t_main

    sam, _gz, entries = _dirty_files("formats_short", tmp_path)
    out = tmp_path / "out"
    assert t_main(["-i", sam, "-o", str(out), "-p", "fixture",
                   "--on-bad-record", "quarantine"], device="cpu") == 0
    said = capsys.readouterr().out
    assert f"{len(entries)} malformed record(s) quarantined" in said
    got, summary = _entries(str(out / "fixture_quarantine.jsonl"))
    assert got == entries and summary["bad_records"] == len(entries)
    with pytest.raises(SystemExit, match="bad-record budget exhausted"):
        t_main(["-i", sam, "-o", str(out), "--quiet",
                "--on-bad-record", "skip", "--max-bad-records", "2"],
               device="cpu")


# --------------------------------------------- non-ASCII wide read --
def _wide_non_ascii(tmp_path):
    """``formats_longread.sam`` with one QUAL byte of ``read3`` (3,037
    bases, wider than the slab, so an overflow line) set to 0xFF: every
    reference route rejects the byte (ROADMAP §C 3)."""
    raw = open(os.path.join(DATA, "formats_longread.sam"), "rb").read()
    lines = raw.split(b"\n")
    k = next(i for i, ln in enumerate(lines) if ln.startswith(b"read3\t"))
    fields = lines[k].split(b"\t")
    qual = bytearray(fields[10])
    qual[100] = 0xFF
    fields[10] = bytes(qual)
    lines[k] = b"\t".join(fields)
    dirty = b"\n".join(lines)
    sam = str(tmp_path / "wide.sam")
    with open(sam, "wb") as fh:
        fh.write(dirty)
    gz = str(tmp_path / "wide.sam.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(dirty)
    return sam, gz


@needs_native
@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("container", ["sam", "gz"])
@pytest.mark.parametrize("mode", ["fail", "skip", "quarantine"])
def test_wide_non_ascii_read_equals_reference(mode, container, threads,
                                              tmp_path):
    """A wide read with a byte >= 0x80 outside SEQ: the native decoder
    replays it through the Python fallback, so strict mode raises the
    reference's error, ``skip`` drops the read and ``quarantine`` writes
    the reference's sidecar (reason ``non_ascii``)."""
    sam, gz = _wide_non_ascii(tmp_path)
    path = sam if container == "sam" else gz
    outs = {}
    for tag, run in (("t", run_port), ("r", run_jax)):
        (tmp_path / tag).mkdir()
        side = str(tmp_path / tag / "q.jsonl")
        kw = dict(decoder="native", decode_threads=threads,
                  on_bad_record=mode)
        if mode == "quarantine":
            kw["quarantine_out"] = side
        try:
            out, res = run(path, **kw)
        except Exception as exc:            # noqa: BLE001 - compared below
            outs[tag] = (type(exc).__name__,)
            continue
        outs[tag] = (None, out, res.stats.extra.get("bad_records"),
                     _sidecar(side, tmp_path / tag)
                     if mode == "quarantine" else None)
    assert outs["t"] == outs["r"]
    if mode == "fail":
        assert outs["t"] == ("UnicodeDecodeError",)
    else:
        assert outs["t"][2] == 1
    if mode == "quarantine":
        got, _summary = _entries(str(tmp_path / "t" / "q.jsonl"))
        assert [why for _r, why in got] == ["non_ascii"]
