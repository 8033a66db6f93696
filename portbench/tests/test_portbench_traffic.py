"""The generator: deterministic per seed, realistic in its records, and
sized so that the deep cell passes the port's host gate and lanes past
2,048."""

import json
import os

import numpy as np
import pytest

from portbench.harness import manifest
from portbench.traffic import generate, pool, sam

CONFIGS = os.path.join(manifest.HERE, "configs")


def config(name, **genome):
    with open(os.path.join(CONFIGS, name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["genome"].update(genome)
    return cfg


def sam_bytes(cfg, traffic, seed, index, tmp_path):
    path = str(tmp_path / f"s{seed}_{index}.sam")
    sam.write(generate.sample(cfg, traffic, seed, index), path)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name,length", [("sarscov2_artic_v3", None),
                                         ("ecoli_k12_wgs", 200_000)])
def test_same_seed_same_bytes(name, length, tmp_path):
    cfg = config(name, **({"length": length} if length else {}))
    mix = {"reads_per_sample": 4000}
    seed = 2 ** 31 + 12345
    a = sam_bytes(cfg, mix, seed, 3, tmp_path)
    assert a == sam_bytes(cfg, mix, seed, 3, tmp_path)
    assert a != sam_bytes(cfg, mix, seed + 1, 3, tmp_path)
    assert a != sam_bytes(cfg, mix, seed, 4, tmp_path)


def test_records_look_like_bwa(tmp_path):
    cfg = config("sarscov2_artic_v3")
    text = sam_bytes(cfg, {"reads_per_sample": 6000}, 77, 0,
                     tmp_path).decode()
    body = [ln.split("\t") for ln in text.splitlines()
            if not ln.startswith("@")]
    assert len(body) == 6000
    quals = "".join(f[10] for f in body)
    assert set(quals) <= set("#-8F") and len(set(quals)) >= 3
    assert all(f[11].startswith("NM:i:") and f[12].startswith("AS:i:")
               for f in body)
    cigars = {f[5] for f in body}
    assert "22S128M" in cigars and "128M22S" in cigars
    assert any("I" in c for c in cigars) and any("D" in c for c in cigars)
    assert {f[1] for f in body} == {"99", "147"}
    assert all(len(f[9]) == 150 == len(f[10]) for f in body)


def test_deep_sample_passes_the_host_gate(tmp_path):
    """The deep ARTIC sample is over the port's byte bound for a 29,903 bp
    genome, so K1 counts it on the card."""
    from sam2consensus_torch.ops.pileup import HOST_PILEUP_NATIVE_BOUNDS

    cfg = config("sarscov2_artic_v3")
    bound = next(b for n, b in HOST_PILEUP_NATIVE_BOUNDS
                 if cfg["genome"]["length"] <= n)
    s = pool.make_sample(cfg, {"reads_per_sample": 250000}, 5, 0,
                         str(tmp_path))
    assert s.file_bytes > bound


def test_deep_sample_passes_2048_in_a_lane(tmp_path):
    """The deep cell's control needs lanes past 2,048: the amplicon
    peaks give them."""
    from portbench.reference import consensus as rc

    cfg = config("sarscov2_artic_v3")
    p = pool.make_sample(cfg, {"reads_per_sample": 250000}, 11, 0,
                         str(tmp_path))
    s = pool.reads(p)
    counts, _ = rc.pileup(s.contig_len, s.pos, s.cigars, s.cigar_id, s.seq,
                          150)
    assert counts.max() > 2048
    assert 1000 < counts.sum(1).mean() < 1500
