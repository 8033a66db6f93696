"""End to end on the CPU: the port's CLI (``device="cpu"``), under each
decoder (``--decoder native`` and ``py``), byte-identical to the JAX
package's CLI under ``--backend cpu`` (the golden oracle) and ``--backend
jax``, on the single-device corpus of ``tests/test_differential.py``, and
to the pinned ``formats_*`` FASTAs.

The CPU device is link-free, so ``--pileup auto`` takes the host counts
and the native tail there, and ``--insertion-kernel auto`` the torch
scatter.  The tests that hold the plain versions of the kernels end to
end therefore pin ``--pileup pallas --insertion-kernel pallas``
(:data:`PLAIN`); the ``host`` and
``auto`` cases run beside them, and the one-shot flags (``--permissive``,
``--segment-width``, ``--chunk-reads``, ``--quiet``, ``--pileup``,
``--decode-threads``) are held against the reference here too."""

import contextlib
import gc
import importlib.util
import io
import os

import numpy as np
import pytest

from sam2consensus_torch import cli as t_cli
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.io.fasta import render_file
from sam2consensus_torch.io.sam import iter_records, read_header
from sam2consensus_tpu import cli as r_cli
from sam2consensus_tpu.backends.cpu import CpuBackend
from sam2consensus_tpu.config import RunConfig as RConfig
from sam2consensus_tpu.utils.simulate import (BASELINE_SPECS, SimSpec,
                                              sam_text, simulate)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")


def _differential_corpus():
    spec = importlib.util.spec_from_file_location(
        "_torch_differential_corpus", os.path.join(HERE,
                                                   "test_differential.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HANDCRAFTED


HANDCRAFTED = _differential_corpus()
DECODERS = ["native", "py"]
#: the flags that run the plain versions of K1, K2 and K3 on the CPU
PLAIN = ["--pileup", "pallas", "--insertion-kernel", "pallas"]


def _pinned(pileup: str) -> list:
    """``--pileup pileup``, with the kernels' insertion route under
    ``pallas`` (:data:`PLAIN`)."""
    return PLAIN if pileup == "pallas" else ["--pileup", pileup]


#: reference CLI runs so far, and the tests whose only JAX-package work is
#: a reference run through ``_references`` (cached per case)
_REFERENCE_RUNS = [0]
_CACHED_REFERENCES = {"test_cli_byte_identical",
                      "test_cli_byte_identical_pileup"}


@pytest.fixture(autouse=True)
def _collect_jax_garbage(request):
    """Collect after each test that built JAX-package objects, outside any
    lock, so that none of them is finalised later inside the JAX metrics
    registry's lock (a deadlock in that package, not the port's).  A test
    that only ran the port against cached references built none."""
    before = _REFERENCE_RUNS[0]
    yield
    if request.function.__name__ not in _CACHED_REFERENCES \
            or _REFERENCE_RUNS[0] != before:
        gc.collect()


@pytest.fixture(scope="module")
def references():
    """The reference CLIs' outputs per case, made once for both decoders."""
    return {}


@pytest.fixture
def decoder_ran(monkeypatch):
    """The ``stats.extra["decoder"]`` of every port run in the test."""
    ran = []
    orig = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig(self, *args, **kwargs)
        ran.append(result.stats.extra.get("decoder"))
        return result

    monkeypatch.setattr(TorchBackend, "run", run)
    return ran


def _sim(name, **kw):
    return simulate(SimSpec(**{**BASELINE_SPECS[name].__dict__, **kw}))


def _wide_insertion(at: int = 600):
    """A 1,200-base contig and one 700-base insertion after base ``at``,
    carried by six reads (one cut short at 400 bases, one with a
    substituted base), beside short insertions: 1,024 padded columns,
    wider than the fused vote serves, so the tail takes the table kernel
    and the torch vote.  ``at`` = 1200 puts the insertion at the contig's
    end (a site with no reference position)."""
    rng = np.random.RandomState(5)
    genome = "".join("ACGT"[i] for i in rng.randint(0, 4, 1200))
    motif = "".join("ACGT"[i] for i in rng.randint(0, 4, 700))
    reads = [("wide", 1 + 20 * i, "100M", genome[20 * i:20 * i + 100])
             for i in range(56)]
    for i, ins in enumerate([motif] * 4 + [motif[:400],
                             motif[:50] + "ACGT"[motif[50] == "A"]
                             + motif[51:]]):
        s = at - 80 + 10 * i
        tail = genome[at:at + 100]
        reads.append(("wide", s + 1, f"{at - s}M{len(ins)}I"
                      + (f"{len(tail)}M" if tail else ""),
                      genome[s:at] + ins + tail))
    for s in (100, 300, 900):
        reads.append(("wide", s - 29, "30M3I30M",
                      genome[s - 30:s] + "GGA" + genome[s:s + 30]))
    return sam_text([("wide", 1200)], reads)


# (name, SAM text, CLI flags): the CLI-expressible cases of
# tests/test_differential.py
CASES = [(f"{n}", HANDCRAFTED[n], []) for n in sorted(HANDCRAFTED)]
CASES += [(f"{n}_multi", HANDCRAFTED[n], ["-c", "0.25,0.5,0.75,1.0"])
          for n in sorted(HANDCRAFTED)]
CASES += [
    ("phix_like", _sim("phix_like", n_reads=800, contig_len=800),
     ["-c", "0.25,0.5,0.75"]),
    ("target_capture", _sim("target_capture", n_contigs=25, n_reads=1500,
                            contig_len=300), ["-c", "0.25,0.75"]),
    ("amplicon_deep", _sim("amplicon_deep", n_reads=3000, contig_len=200),
     ["-c", "0.25,0.5", "-m", "10"]),
    ("min_depth_fill_N", simulate(SimSpec(n_contigs=3, contig_len=150,
                                          n_reads=120, read_len=40, seed=9)),
     ["-m", "3", "-f", "N"]),
    ("min_depth_fill_multichar", simulate(SimSpec(
        n_contigs=3, contig_len=150, n_reads=120, read_len=40, seed=9)),
     ["-m", "2", "-f", "?!"]),
    ("maxdel_2", simulate(SimSpec(n_contigs=2, contig_len=200, n_reads=300,
                                  read_len=50, del_read_rate=0.5,
                                  max_indel=5, seed=11)), ["-d", "2"]),
    ("maxdel_py2", simulate(SimSpec(n_contigs=2, contig_len=200, n_reads=300,
                                    read_len=50, del_read_rate=0.5,
                                    max_indel=5, seed=11)),
     ["-d", "2", "--py2-compat"]),
    ("maxdel_0", simulate(SimSpec(n_contigs=2, contig_len=200, n_reads=300,
                                  read_len=50, del_read_rate=0.5,
                                  max_indel=5, seed=11)), ["-d", "0"]),
    ("wrapping", HANDCRAFTED["multi_contig"], ["-n", "3"]),
    ("odd_thresholds", simulate(SimSpec(n_contigs=2, contig_len=120,
                                        n_reads=600, read_len=30, seed=13)),
     ["-c", "0.1,0.3,0.33,0.66,0.9,1.0"]),
    ("literal_dash", sam_text([("r", 4)], [("r", 1, "4M", "A--T"),
                                           ("r", 1, "4M", "ACGT")]),
     ["-c", "0.25,0.75", "-d", "1"]),
    ("short_seq", sam_text([("r", 6)], [
        ("r", 1, "10M", "AC"), ("r", 1, "4M2D", "GG"),
        ("r", 1, "6M", "TTTTTT")]), ["-c", "0.25,0.75"]),
    ("zero_span", sam_text([("r", 4)], [("r", 9, "2S", "TT"),
                                        ("r", 9, "3H", "*"),
                                        ("r", 1, "4M", "ACGT")]), []),
    ("short_seq_insertion_key", sam_text([("r", 20)], [
        ("r", 1, "6M2I2M", "ACGGT"), ("r", 1, "20M", "A" * 20)]), []),
    ("wide_insertion", _wide_insertion(), ["-c", "0.25,0.75"]),
    ("wide_insertion_at_contig_end", _wide_insertion(1200),
     ["-c", "0.25,0.75"]),
    ("trailing_empty_contig", sam_text(
        [("a", 3), ("mid0", 0), ("b", 4), ("z", 0)],
        [("a", 1, "3M", "ACG"), ("b", 1, "4M", "TTTT"),
         ("b", 4, "1M", "T")]), []),
]


def _run(main, path, out, flags, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = main(["-i", path, "-o", out, "-p", "p", *flags], **kw)
    assert rc == 0
    files = sorted(os.listdir(out))
    return ({f: open(os.path.join(out, f), "rb").read() for f in files},
            log.getvalue())


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("name,text,flags", CASES, ids=[c[0] for c in CASES])
def test_cli_byte_identical(tmp_path, references, decoder_ran, name, text,
                            flags, decoder):
    path = str(tmp_path / f"{name}.sam")
    with open(path, "w") as fh:
        fh.write(text)
    got, log = _run(t_cli.main, path, str(tmp_path / "torch"),
                    flags + ["--decoder", decoder] + PLAIN, device="cpu")
    assert decoder_ran == [decoder]
    want_cpu, want_jax, log_cpu = _references(references, tmp_path, name,
                                              path, flags)
    assert got == want_cpu
    assert got == want_jax
    assert log.replace(str(tmp_path / "torch"), "").replace(
        str(tmp_path), "") == log_cpu


def _references(references, tmp_path, name, path, flags):
    """The reference CLIs' ``(cpu, jax, cpu log)`` for a case, made once."""
    if name not in references:
        _REFERENCE_RUNS[0] += 1
        want_cpu, log_cpu = _run(r_cli.main, path, str(tmp_path / "cpu"),
                                 flags + ["--backend", "cpu"])
        want_jax, _ = _run(r_cli.main, path, str(tmp_path / "jax"),
                           flags + ["--backend", "jax"])
        references[name] = (want_cpu, want_jax, log_cpu.replace(
            str(tmp_path / "cpu"), "").replace(str(tmp_path), ""))
    return references[name]


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("pileup", ["host", "auto"])
@pytest.mark.parametrize("name,text,flags", CASES, ids=[c[0] for c in CASES])
def test_cli_byte_identical_pileup(tmp_path, references, decoder_ran, name,
                                   text, flags, pileup, decoder):
    """The same corpus under host counts (``host``, and ``auto``, which
    takes them on the link-free CPU device): the native tail, or the
    numpy walk of ``s2c_accumulate_rows`` under ``--decoder py``."""
    path = str(tmp_path / f"{name}.sam")
    with open(path, "w") as fh:
        fh.write(text)
    got, log = _run(t_cli.main, path, str(tmp_path / "torch"),
                    flags + ["--decoder", decoder, "--pileup", pileup],
                    device="cpu")
    assert decoder_ran == [decoder]
    want_cpu, want_jax, log_cpu = _references(references, tmp_path, name,
                                              path, flags)
    assert got == want_cpu
    assert got == want_jax
    assert log.replace(str(tmp_path / "torch"), "").replace(
        str(tmp_path), "") == log_cpu


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("fam", ["short", "longread", "adversarial"])
@pytest.mark.parametrize("ext", [".sam", ".sam.gz", ".plain.sam.gz"])
def test_formats_fixtures(tmp_path, decoder_ran, fam, ext, decoder):
    got, _ = _run(t_cli.main, os.path.join(DATA, f"formats_{fam}{ext}"),
                  str(tmp_path / "o"), ["--decoder", decoder] + PLAIN,
                  device="cpu")
    assert decoder_ran == [decoder]
    with open(os.path.join(DATA, f"formats_{fam}.expected.fasta"),
              "rb") as fh:
        expected = fh.read().replace(b">fixture|", b">p|")
    assert b"".join(got[f] for f in sorted(got)) == expected


def _rendered(backend, text, tcfg):
    handle = io.StringIO(text)
    contigs, _n, first = read_header(handle)
    res = backend.run(contigs, iter_records(handle, first), tcfg)
    return {n: render_file(r, tcfg.nchar) for n, r in res.fastas.items()}


@pytest.mark.parametrize("text", [
    sam_text([("r", 4)], [("other", 1, "2M", "AC"), ("r", 3, "4M", "ACGT"),
                          ("r", 1, "2M", "ac"), ("r", 1, "3M", "ACG")]),
    sam_text([("r", 6)], [("r", 1, "2M2I2M", "AAxxGG")]),
])
def test_permissive_mode_identical(text):
    got = _rendered(TorchBackend("cpu"), text,
                    TConfig(prefix="p", strict=False, pileup="pallas",
                            ins_kernel="pallas"))
    want = _rendered(CpuBackend(), text, RConfig(prefix="p", strict=False))
    assert got == want


@pytest.mark.parametrize("record,exc", [
    (("other", 1, "2M", "AC"), KeyError),
    (("r", 5, "3M", "ACG"), IndexError),
    (("r", 1, "2M", "ac"), KeyError),
    (("r", 1, "2M2I2M", "AAxxGG"), KeyError),
])
def test_strict_errors_match_oracle(record, exc):
    text = sam_text([("r", 6)], [record])
    with pytest.raises(exc) as e_torch:
        _rendered(TorchBackend("cpu"), text, TConfig(
            prefix="p", pileup="pallas", ins_kernel="pallas"))
    with pytest.raises(exc) as e_cpu:
        _rendered(CpuBackend(), text, RConfig(prefix="p"))
    assert str(e_torch.value) == str(e_cpu.value)


def test_bad_threshold_rejected_cleanly(tmp_path):
    sam = os.path.join(DATA, "formats_short.sam")
    for bad in ("abc", "0", "-0.5", "nan", "inf"):
        with pytest.raises(SystemExit) as e:
            t_cli.main(["-i", sam, "-o", str(tmp_path), "-c", bad],
                       device="cpu")
        assert "error:" in str(e.value.code)


# -- the one-shot flags ------------------------------------------------------
NEW_FLAGS = ("permissive", "segment_width", "chunk_reads", "quiet", "pileup",
             "decode_threads")


def test_new_flags_defaults_equal_the_reference():
    t_args = t_cli.build_parser().parse_args(["-i", "x.sam"])
    r_args = r_cli.build_parser().parse_args(["-i", "x.sam"])
    for flag in NEW_FLAGS:
        assert getattr(t_args, flag) == getattr(r_args, flag), flag
    t_cfg = t_cli.config_from_args(t_args)
    r_cfg = r_cli.config_from_args(r_args)
    for field in ("strict", "segment_width", "chunk_reads", "pileup",
                  "decode_threads"):
        assert getattr(t_cfg, field) == getattr(r_cfg, field), field


@pytest.mark.parametrize("argv", [
    ["--segment-width", "wide"], ["--segment-width", "1.5"],
    ["--chunk-reads", "many"], ["--decode-threads", "two"],
    ["--quiet", "yes"], ["--permissive", "1"], ["--pileup"],
])
def test_new_flags_parse_errors_equal_the_reference(capsys, argv):
    msgs = []
    for parser in (t_cli.build_parser(), r_cli.build_parser()):
        with pytest.raises(SystemExit) as exc:
            parser.parse_args(["-i", "x.sam", *argv])
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1])
    assert msgs[0].split(": error: ")[1] == msgs[1].split(": error: ")[1]


@pytest.mark.parametrize("value", ["bogus", "mxu"])
def test_pileup_rejects_what_the_port_lacks(capsys, value):
    """``mxu`` is queued in the port: its parser names the strategies it
    runs, in the reference's order."""
    with pytest.raises(SystemExit) as exc:
        t_cli.build_parser().parse_args(["-i", "x.sam", "--pileup", value])
    assert exc.value.code == 2
    msg = capsys.readouterr().err.splitlines()[-1]
    assert f"argument --pileup: invalid choice: '{value}'" in msg
    choices = msg.split("(choose from ")[1]
    assert [c.strip(" ')") for c in choices.split(",")] == \
        ["auto", "pallas", "scatter", "host"]


def _ref_pair(tmp_path, path, flags, tag):
    want_cpu, _ = _run(r_cli.main, path, str(tmp_path / f"cpu_{tag}"),
                       flags + ["--backend", "cpu"])
    want_jax, _ = _run(r_cli.main, path, str(tmp_path / f"jax_{tag}"),
                       flags + ["--backend", "jax"])
    assert want_cpu == want_jax
    return want_cpu


OUT_OF_CONTRACT = sam_text([("r", 30)], [
    ("r", 1, "10M", "ACGTACGTAC"), ("other", 1, "2M", "AC"),
    ("r", 25, "10M", "ACGTACGTAC"), ("r", 3, "4M2I4M", "ACGTxxACGT"),
    ("r", 5, "8M", "ACGTACGT")])


@pytest.mark.parametrize("pileup", ["pallas", "host"])
def test_permissive_flag(tmp_path, pileup):
    path = str(tmp_path / "bad.sam")
    with open(path, "w") as fh:
        fh.write(OUT_OF_CONTRACT)
    want = _ref_pair(tmp_path, path, ["--permissive"], "perm")
    got, _ = _run(t_cli.main, path, str(tmp_path / "t"),
                  ["--permissive"] + _pinned(pileup), device="cpu")
    assert got == want
    with pytest.raises(KeyError) as t_exc:
        _run(t_cli.main, path, str(tmp_path / "t2"), ["--pileup", pileup],
             device="cpu")
    with pytest.raises(KeyError) as r_exc:
        _run(r_cli.main, path, str(tmp_path / "r2"), ["--backend", "cpu"])
    assert str(t_exc.value) == str(r_exc.value)


@pytest.mark.parametrize("width", ["-1", "0", "64"])
def test_segment_width_flag(tmp_path, decoder_ran, width):
    """Reads of 150-300 bases against 64-wide segments (and the layout
    off, and its default): the same bytes as the reference."""
    text = simulate(SimSpec(n_contigs=2, contig_len=1500, n_reads=300,
                            read_len=200, ins_read_rate=0.2,
                            del_read_rate=0.2, seed=31))
    path = str(tmp_path / "long.sam")
    with open(path, "w") as fh:
        fh.write(text)
    flags = ["--segment-width", width, "-c", "0.25,0.75"]
    want = _ref_pair(tmp_path, path, flags, "seg")
    for pileup in ("pallas", "host"):
        got, _ = _run(t_cli.main, path, str(tmp_path / f"t_{pileup}"),
                      flags + _pinned(pileup), device="cpu")
        assert got == want
    assert decoder_ran == ["native", "native"]


def test_chunk_reads_flag(tmp_path, monkeypatch):
    from sam2consensus_torch.ops import pileup

    sizes = []
    add = pileup.PileupAccumulator.add

    def counted_add(self, batch):
        sizes.append(batch.n_reads)
        return add(self, batch)

    monkeypatch.setattr(pileup.PileupAccumulator, "add", counted_add)
    text = simulate(SimSpec(n_contigs=1, contig_len=400, n_reads=50,
                            read_len=40, seed=33))
    path = str(tmp_path / "c.sam")
    with open(path, "w") as fh:
        fh.write(text)
    flags = ["--chunk-reads", "7", "--decoder", "py"]
    want = _ref_pair(tmp_path, path, flags[:2], "chunk")
    got, _ = _run(t_cli.main, path, str(tmp_path / "t"),
                  flags + PLAIN, device="cpu")
    assert got == want
    assert sizes and max(sizes) == 7 and sum(sizes) == 50


def test_quiet_prints_nothing(tmp_path, capsys):
    path = os.path.join(DATA, "formats_short.sam")
    assert t_cli.main(["-i", path, "-o", str(tmp_path / "t"), "--quiet"],
                      device="cpu") == 0
    assert capsys.readouterr().out == ""
    assert r_cli.main(["-i", path, "-o", str(tmp_path / "r"), "--quiet"]) \
        == 0
    assert capsys.readouterr().out == ""
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "r"))


@pytest.fixture(scope="module")
def sharded_input(tmp_path_factory):
    """A SAM of about 2.5 MB (two byte shards at the default 1 MiB shard
    floor), its BAM twin, and the reference CLIs' FASTA of it."""
    from sam2consensus_torch.formats.bam import sam_text_to_bam

    tmp = tmp_path_factory.mktemp("sharded")
    text = simulate(SimSpec(n_contigs=2, contig_len=6000, n_reads=9000,
                            read_len=100, ins_read_rate=0.1,
                            del_read_rate=0.1, seed=37))
    sam = str(tmp / "s.sam")
    with open(sam, "w") as fh:
        fh.write(text)
    bam = sam_text_to_bam(text, str(tmp / "s.bam"))
    flags = ["-c", "0.25,0.75"]
    want = _ref_pair(tmp, sam, flags, "sharded")
    assert _ref_pair(tmp, bam, flags, "sharded_bam") == want
    return sam, bam, flags, want


@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("threads", ["1", "2"])
@pytest.mark.parametrize("pileup", ["auto", "pallas", "host"])
def test_pileup_and_decode_threads(tmp_path, sharded_input, decoder_ran,
                                   monkeypatch, pileup, threads, fmt):
    sam, bam, flags, want = sharded_input
    stats = []
    orig = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig(self, *args, **kwargs)
        stats.append(result.stats.extra)
        return result

    monkeypatch.setattr(TorchBackend, "run", run)
    got, _ = _run(t_cli.main, sam if fmt == "sam" else bam,
                  str(tmp_path / "t"),
                  flags + _pinned(pileup) + ["--decode-threads", threads],
                  device="cpu")
    assert got == want
    extra = stats[-1]
    assert extra["pileup_path"] == ("device" if pileup == "pallas"
                                    else "host")
    assert extra["counts_fused"] == (pileup != "pallas")
    assert extra["tail_device"] == "cpu"
    assert extra["tail_native"] == (pileup != "pallas")
    if fmt == "sam" and threads == "2":
        assert extra["ingest_mode"]["rung"] == "shards"
        assert extra["ingest_shards"] == 2
        assert extra["decode_rung"] == ("slab" if pileup == "pallas"
                                        else "fused")
