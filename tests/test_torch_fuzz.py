"""Seeded ingest mutants through the port and the JAX package, on the CPU.

The mutants come from the reference fuzzer's own mutator
(``tools/fuzz_ingest.mutate_text``, imported here, not edited) over its
trimmed fixture corpus, the long-read family included so that wide
(slab-overflow) reads are mutated too.  Each mutant runs through
``TorchBackend("cpu")`` and ``JaxBackend`` with the same decoder, the same
bad-record mode, the same decode threads and the same container (plain
or gzip SAM).  The outcome type, every FASTA, the bad-record count and
the quarantine sidecar (its directory written out of it) must agree.
"""

import gc
import gzip
import importlib.util
import os
import random

import pytest

from test_torch_badrecords import HAVE_NATIVE, run_jax, run_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "fuzz_ingest", os.path.join(ROOT, "tools", "fuzz_ingest.py"))
fuzz_ingest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fuzz_ingest)

SEED = 20611
PER_CELL = 80          # mutants per (decoder, mode) cell: 480 in all
MODES = ("fail", "skip", "quarantine")
DECODERS = ("native", "py")


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """No automatic collection during a test: the JAX package's quarantine
    sinks carry memplane finalizers that deadlock inside its registry lock
    (ROADMAP §C 2).  Collect after the test instead."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _mutants(decoder, mode):
    """``PER_CELL`` (flavor, bytes, threads, container) mutants, seeded by
    the cell so every cell sees its own draw over the whole corpus."""
    corpus = fuzz_ingest.load_corpus(smoke=False)
    rng = random.Random(f"{SEED}-{decoder}-{mode}")
    out = []
    for k in range(PER_CELL):
        _stem, text = corpus[k % len(corpus)]
        flavor, mut = fuzz_ingest.mutate_text(
            rng, text, fuzz_ingest.corpus_refs(text))
        out.append((flavor, mut.encode("latin-1"), 1 + (k // 2) % 2,
                    ("sam", "gz")[k % 2]))
    return out


def _outcome(run, path, side, mode, decoder, threads, out_dir):
    kw = dict(decoder=decoder, decode_threads=threads, on_bad_record=mode)
    if mode == "quarantine":
        kw["quarantine_out"] = side
    try:
        fasta, res = run(path, **kw)
    except Exception as exc:                # noqa: BLE001 - compared
        return (type(exc).__name__,)
    sidecar = None
    if mode == "quarantine" and os.path.exists(side):
        with open(side) as fh:
            sidecar = fh.read().replace(str(out_dir), "<dir>")
    return (None, fasta, res.stats.extra.get("bad_records"), sidecar)


@pytest.mark.skipif(not HAVE_NATIVE, reason="native decoder unavailable")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("decoder", DECODERS)
def test_mutants_agree_with_reference(decoder, mode, tmp_path):
    diverged = []
    flavors = set()
    for k, (flavor, data, threads, container) in enumerate(
            _mutants(decoder, mode)):
        flavors.add(flavor)
        path = str(tmp_path / f"m{k}.sam")
        if container == "gz":
            path += ".gz"
            with gzip.open(path, "wb") as fh:
                fh.write(data)
        else:
            with open(path, "wb") as fh:
                fh.write(data)
        got = {}
        for tag, run in (("t", run_port), ("r", run_jax)):
            out_dir = tmp_path / f"{tag}{k}"
            out_dir.mkdir()
            got[tag] = _outcome(run, path, str(out_dir / "q.jsonl"), mode,
                                decoder, threads, out_dir)
        if got["t"] != got["r"]:
            diverged.append((k, flavor, threads, container,
                             got["t"][0], got["r"][0]))
        os.remove(path)
    assert not diverged, diverged
    assert len(flavors) >= 6
