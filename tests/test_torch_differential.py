"""End to end on the CPU: the port's CLI (``device="cpu"``), under each
decoder (``--decoder native`` and ``py``), byte-identical to the JAX
package's CLI under ``--backend cpu`` (the golden oracle) and ``--backend
jax``, on the single-device corpus of ``tests/test_differential.py``, and
to the pinned ``formats_*`` FASTAs."""

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


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """Collect after each test, outside any lock, so that no unreachable
    JAX-package object built here is finalised later inside the JAX
    metrics registry's lock (a deadlock in that package, not the port's)."""
    yield
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
                    flags + ["--decoder", decoder], device="cpu")
    assert decoder_ran == [decoder]
    if name not in references:
        want_cpu, log_cpu = _run(r_cli.main, path, str(tmp_path / "cpu"),
                                 flags + ["--backend", "cpu"])
        want_jax, _ = _run(r_cli.main, path, str(tmp_path / "jax"),
                           flags + ["--backend", "jax"])
        references[name] = (want_cpu, want_jax, log_cpu.replace(
            str(tmp_path / "cpu"), "").replace(str(tmp_path), ""))
    want_cpu, want_jax, log_cpu = references[name]
    assert got == want_cpu
    assert got == want_jax
    assert log.replace(str(tmp_path / "torch"), "").replace(
        str(tmp_path), "") == log_cpu


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("fam", ["short", "longread", "adversarial"])
@pytest.mark.parametrize("ext", [".sam", ".sam.gz", ".plain.sam.gz"])
def test_formats_fixtures(tmp_path, decoder_ran, fam, ext, decoder):
    got, _ = _run(t_cli.main, os.path.join(DATA, f"formats_{fam}{ext}"),
                  str(tmp_path / "o"), ["--decoder", decoder], device="cpu")
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
                    TConfig(prefix="p", strict=False))
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
        _rendered(TorchBackend("cpu"), text, TConfig(prefix="p"))
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
