"""Whole runs of ``run.py`` on the CPU at a small size (the harness's look
for a card skipped): the result line, the modules it leaves loaded, and
``correct`` coming out false when the timed path is broken underneath."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench.harness import manifest

SMALL = dict(reads_per_sample=6000, pool=2, queue_jobs=2)
GENOME = 150_000


def shrink(flags=None):
    """``manifest.cell`` at the tests' size: a shorter genome and a
    smaller pool, and ``flags`` in place of the configuration's."""
    real = manifest.cell

    def small(name):
        c = real(name)
        c.traffic = dict(c.traffic, **SMALL)
        g = c.config["genome"]
        g["length"] = min(g["length"], GENOME)
        if flags:
            c.config["flags"] = list(flags)
        return c
    return small


REHEARSE = """
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench.harness import guard, manifest
from portbench.harness.main import run
from portbench.tests.test_portbench_run import shrink
manifest.cell = shrink()
rc = run({argv!r}, t, device="cpu")
print(json.dumps({{"rc": rc, "forbidden": guard.forbidden(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def rehearse(cell, trace, tmp_path, seconds=1.0):
    code = REHEARSE.format(root=manifest.ROOT, argv=[
        "--workload", cell, "--seed", str(2 ** 32 + 5 + trace), "--seconds",
        str(seconds), "--trace", str(trace)])
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), out.stderr


@pytest.mark.parametrize("cell,trace", [("ecoli_wgs.sam", 0),
                                        ("ecoli_wgs.sam", 1),
                                        ("artic_deep.sam", 0)])
def test_cpu_rehearsal(cell, trace, tmp_path):
    result, tail, err = rehearse(cell, trace, tmp_path)
    assert tail["rc"] == 0
    assert tail["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "sam2consensus_tpu"} & set(
        tail["top"])
    assert "sam2consensus_torch" in tail["top"]
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    cellinfo = manifest.cell(cell)
    want = {m["name"] for m in (cellinfo.per_layer if trace
                                else cellinfo.end_to_end)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert m["value"] > 0
    # the checks are the last lines of standard error
    last = err.strip().splitlines()[-3:]
    assert [ln.split()[1] for ln in last] == list(result["checks"])
    assert os.listdir(tmp_path) == []


def test_control_is_not_correct(monkeypatch):
    """The cell's control in the port's place, judged as a run is judged
    (``portbench/control.py``): ``correct`` comes out false."""
    sys.path.insert(0, manifest.HERE)
    import control

    monkeypatch.setattr(manifest, "cell", shrink())
    got = control.readings("ecoli_wgs.sam", 2 ** 31 + 21)
    assert got["control"] == "insertions_dropped"
    assert got["correct"] is False
    assert got["checks"]["wrong_jobs"]["value"] == got["samples"]
    assert got["checks"]["wrong_files"]["value"] == got["samples"]


def test_pool_is_kept(monkeypatch):
    """A second run of a cell and seed finds its pool kept: the same
    files, nothing made."""
    from portbench.harness.main import pool_cache
    from portbench.traffic import pool

    monkeypatch.setattr(manifest, "cell", shrink())
    c = manifest.cell("ecoli_wgs.sam")
    seed = 2 ** 31 + 22
    first = pool.start(c.config, c.traffic, seed, pool_cache(c.name))()
    again = pool.start(c.config, c.traffic, seed, pool_cache(c.name))
    assert again.cached
    kept = again()
    assert [s.path for s in kept] == [s.path for s in first]
    assert [s.aligned_bases for s in kept] == [s.aligned_bases
                                               for s in first]
    assert all(os.path.getsize(s.path) == s.file_bytes for s in kept)


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(manifest.HERE, "run.py"),
         "--workload", "ecoli_wgs.sam", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=manifest.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ecoli_wgs.sam",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def broken_run(monkeypatch, capsys, cell="ecoli_wgs.sam", flags=None):
    from portbench.harness.main import run

    monkeypatch.setattr(manifest, "cell", shrink(flags))
    rc = run(["--workload", cell, "--seed", str(2 ** 31 + 3), "--seconds",
              "0.5", "--trace", "0"], time.perf_counter(), device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_fault_an_answer_altered(monkeypatch, capsys):
    """One consensus character changed where the port renders it."""
    from sam2consensus_torch.backends.torch_backend import TorchBackend

    real = TorchBackend._assemble

    def altered(self, *a, **k):
        fastas = real(self, *a, **k)
        for recs in fastas.values():
            r = recs[0]
            i = r.seq.find("A")
            r.seq = r.seq[:i] + "C" + r.seq[i + 1:]
        return fastas

    monkeypatch.setattr(TorchBackend, "_assemble", altered)
    result = broken_run(monkeypatch, capsys)
    assert result["correct"] is False
    assert result["checks"]["wrong_jobs"]["value"] == result["attempted"]


def test_fault_the_state_unchanged(monkeypatch, capsys):
    """The pileup's step leaves the counts as they were (the plain K1
    route, which the card's K1 stands in for on the CPU)."""
    from sam2consensus_torch.ops.pileup import PileupAccumulator

    monkeypatch.setattr(PileupAccumulator, "add", lambda self, batch: None)
    result = broken_run(monkeypatch, capsys,
                        flags=["-c", "0.25", "--pileup", "pallas"])
    assert result["correct"] is False
    assert result["checks"]["wrong_jobs"]["value"] > 0


def test_fault_half_the_batch_left_out(monkeypatch, capsys):
    """Every other row of each batch dropped before the pileup counts it."""
    from sam2consensus_torch.constants import PAD_CODE
    from sam2consensus_torch.ops.pileup import PileupAccumulator

    real = PileupAccumulator.add

    def half(self, batch):
        for w, (starts, codes) in batch.buckets.items():
            codes = np.array(codes)
            codes[1::2] = PAD_CODE
            batch.buckets[w] = (starts, codes)
        batch.staged = {}
        return real(self, batch)

    monkeypatch.setattr(PileupAccumulator, "add", half)
    result = broken_run(monkeypatch, capsys,
                        flags=["-c", "0.25", "--pileup", "pallas"])
    assert result["correct"] is False
    assert result["checks"]["wrong_jobs"]["value"] > 0


@pytest.mark.card
def test_one_short_run_on_the_card(tmp_path):
    """A short real run on the card (skips without one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(manifest.HERE, "run.py"),
         "--workload", "ecoli_wgs.sam", "--seed", str(2 ** 31 + 77),
         "--seconds", "3", "--trace", "1"], capture_output=True, text=True,
        cwd=manifest.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
