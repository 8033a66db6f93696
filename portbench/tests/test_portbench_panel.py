"""Contigs and the capture library: each single-contig configuration's
pool and reference files as the harness made them before it knew panels
(digests pinned from it, ``parent_pools.json``), and a capture panel's
contigs, reads, SAM, calls and controls."""

import dataclasses
import gc
import hashlib
import json
import os
import re
import sys

import numpy as np
import pytest

from portbench.harness import manifest
from portbench.tests.test_portbench_run import (PANEL, PANEL_MIX,
                                                panel_config,
                                                reference_files, with_panel)
from portbench.tests.test_portbench_traffic import config
from portbench.traffic import generate, pool, sam

PINNED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "parent_pools.json")
CONTROLS = ("counts_float16", "insertions_dropped")
_OPS = re.compile(r"(\d+)([MIDNSHPX=])")
#: the largest indel the draft panel draws (a longer clip is an overhang)
MAX_INDEL = 9


@pytest.fixture(autouse=True)
def _no_collection():
    """No automatic collection during a test (ROADMAP §C 2)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("name", ["sarscov2_artic_v3", "ecoli_k12_wgs"])
def test_single_contig_pools_are_unchanged(name, tmp_path):
    """The pool key, SAM bytes, ``PoolSample`` fields and the reference's
    files (and each control's) of a small pool at fixed seeds."""
    with open(PINNED) as fh:
        pin = json.load(fh)[name]
    length = pin["genome_length"]
    cfg = config(name, **({"length": length} if length else {}))
    assert pool.key(cfg, pin["mix"]) == pin["key"]
    for row in pin["samples"]:
        s = pool.make_sample(cfg, pin["mix"], row["seed"], row["index"],
                             str(tmp_path))
        with open(s.path, "rb") as fh:
            assert sha(fh.read()) == row["sam"], row["seed"]
        fields = dataclasses.asdict(s)
        for k in ("path", "seconds", "recipe"):
            del fields[k]
        assert fields == row["fields"]
        files = {k: sha(v) for k, v in reference_files(s, cfg["flags"])
                 .items()}
        for ctl in CONTROLS:
            files.update({ctl + ":" + k: sha(v) for k, v in
                          reference_files(s, cfg["flags"], ctl).items()})
        assert files == row["ref"]


def test_panel_contigs_from_the_seed():
    cfg = panel_config()
    tigs = generate.contigs(cfg)
    assert tigs == generate.contigs(panel_config())
    dist = cfg["genome"]["contig_length"]
    lens = np.array([n for _, n in tigs])
    assert len(tigs) == 353 == len({n for n, _ in tigs})
    assert tigs[0][0] == "A353_000" and tigs[-1][0] == "A353_352"
    assert dist["min"] <= lens.min() and lens.max() <= dist["max"]
    assert 0.8 < np.median(lens) / dist["median"] < 1.2
    assert generate.genome(cfg).shape == (lens.sum(),)


def parsed(cfg, mix, seed, tmp_path):
    s = generate.sample(cfg, mix, seed, 0)
    path = str(tmp_path / "panel.sam")
    sam.write(s, path)
    with open(path) as fh:
        lines = fh.read().splitlines()
    head = [ln.split("\t") for ln in lines if ln.startswith("@SQ")]
    body = [ln.split("\t") for ln in lines if not ln.startswith("@")]
    return s, {f[1][3:]: int(f[2][3:]) for f in head}, head, body


def spans(cigar):
    ops = _OPS.findall(cigar)
    lead = int(ops[0][0]) if ops[0][1] == "S" else 0
    trail = int(ops[-1][0]) if ops[-1][1] == "S" else 0
    ref = sum(int(n) for n, op in ops if op in "MD")
    return lead, trail, ref


def test_panel_reads_stay_on_their_contig(tmp_path):
    """One ``@SQ`` a contig; each read's RNAME its own contig, its mate on
    the same (``=``), its aligned part inside the contig."""
    cfg = panel_config(**PANEL)
    s, lengths, head, body = parsed(cfg, PANEL_MIX, 2 ** 31 + 41, tmp_path)
    assert [(f[1][3:], int(f[2][3:])) for f in head] == s.contigs
    assert len(head) == PANEL["genome"]["contigs"]
    assert len(body) == PANEL_MIX["reads_per_sample"]
    names = [n for n, _ in s.contigs]
    assert [f[2] for f in body] == [names[k] for k in s.contig_id.tolist()]
    assert {f[6] for f in body} == {"="}
    on = set()
    for f in body:
        _, _, ref = spans(f[5])
        pos = int(f[3])
        assert 1 <= pos and pos - 1 + ref <= lengths[f[2]], f[:6]
        on.add(f[2])
    # reads on most loci (a few are not recovered)
    assert len(on) >= len(s.contigs) - cfg["library"]["unrecovered_max"]


def test_panel_overhang_clips_at_locus_ends(tmp_path):
    """A clip longer than any indel is a read reaching past a locus's end
    into flanking sequence: it starts the read at the locus's first base
    or ends it at the last (or the one before)."""
    cfg = panel_config(**PANEL)
    _, lengths, _, body = parsed(cfg, PANEL_MIX, 2 ** 31 + 43, tmp_path)
    left = right = 0
    for f in body:
        lead, trail, ref = spans(f[5])
        pos = int(f[3])
        if lead > MAX_INDEL:
            assert pos == 1, f[:6]
            left += 1
        if trail > MAX_INDEL:
            # a read's extra base (an indel error) pushes its last base
            # on the locus into the clip
            assert 0 <= lengths[f[2]] - (pos - 1 + ref) <= 1, f[:6]
            right += 1
        assert lead + trail <= cfg["library"]["overhang_max"] * 2
    assert left > 0.02 * len(body) and right > 0.02 * len(body)


def test_panel_reference_writes_a_file_a_called_contig(tmp_path):
    """One ``{contig}__{name}.fasta`` for each contig with a record, none
    for a locus with no reads; each header names its contig and gives its
    own coverage and length."""
    cfg = panel_config(PANEL["genome"], dict(unrecovered_max=8))
    p = pool.make_sample(cfg, PANEL_MIX, 2 ** 31 + 47, 1, str(tmp_path))
    s = pool.reads(p)
    files = reference_files(p, cfg["flags"])
    read = {s.contigs[k][0] for k in np.unique(s.contig_id).tolist()}
    assert {f.split("__")[0] for f in files} == read
    assert len(read) < len(s.contigs)
    assert all(f.endswith(f"__{p.name}.fasta") for f in files)
    for name, data in files.items():
        contig = name.split("__")[0]
        header, seq = data.decode().splitlines()
        assert header.startswith(f">{p.name}|c25 reference:{contig} ")
        assert f" length:{len(seq) - seq.count('-')} " in header
    assert p.contig == "Angiosperms353"
    assert p.contig_len == sum(n for _, n in s.contigs)


#: the capture panel at which each control departs: called insertions on
#: the tests' panel; lanes past 2,048 on short loci at depth
CONTROL_PANELS = {
    "insertions_dropped": (PANEL["genome"], PANEL_MIX),
    "counts_float16": (dict(PANEL["genome"], contig_length=dict(
        median=160, sigma=0.2, min=150, max=300)),
        dict(reads_per_sample=40000, pool=2, queue_jobs=2)),
}


@pytest.mark.parametrize("control", CONTROLS)
def test_panel_controls_are_not_correct(control, monkeypatch):
    """Each control in the port's place over a panel's pool, judged as a
    run is judged (``portbench/control.py``): ``correct`` comes out
    false, every sample wrong."""
    sys.path.insert(0, manifest.HERE)
    import control as ctl

    genome, mix = CONTROL_PANELS[control]
    panel = with_panel()

    def cell(name):
        c = panel(name)
        c.config = panel_config(genome, PANEL["library"])
        c.traffic = dict(c.traffic, **mix)
        return c
    monkeypatch.setattr(manifest, "cell", cell)
    got = ctl.readings("panel.jobs", 2 ** 31 + 53, control)
    assert got["correct"] is False
    assert got["checks"]["wrong_jobs"]["value"] == got["samples"]
    assert got["checks"]["wrong_files"]["value"] == got["samples"]
