"""The plain reference against the port's CPU run, at a small size: both
read the same SAM files, the port through its
warm server on every pileup route the CPU has; and each control differs
from the reference where its cell needs it to."""

import json
import os

import pytest

from portbench.harness import judge, manifest
from portbench.reference import consensus as rc
from portbench.reference import controls, flags
from portbench.traffic import pool

SIZES = [("sarscov2_artic_v3", None, 20000),
         ("sarscov2_artic_v3", None, 3000),
         ("ecoli_k12_wgs", 200_000, 6000),
         ("ecoli_k12_wgs", 200_000, 12000)]


def config(name, length):
    with open(os.path.join(manifest.HERE, "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    if length:
        cfg["genome"]["length"] = length
    return cfg


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each size's two samples through one CPU ServeRunner, under
    ``--pileup auto`` (host counts on the CPU) and ``pallas`` (the plain
    K1)."""
    from sam2consensus_torch.cli import build_serve_parser, config_from_args
    from sam2consensus_torch.serve.runner import JobSpec, ServeRunner

    tmp = tmp_path_factory.mktemp("served")
    cases, specs = [], []
    for name, length, reads in SIZES:
        cfg = config(name, length)
        mix = {"reads_per_sample": reads}
        for i in range(2):
            folder = tmp / f"{name}_{reads}_{i}"
            folder.mkdir()
            s = pool.make_sample(cfg, mix, 2 ** 32 + 17, i, str(folder))
            for route in ("auto", "pallas"):
                args = build_serve_parser().parse_args(
                    ["-i", s.path, "-o", str(folder / route),
                     *cfg["flags"], "--pileup", route])
                args.filename, args.prefix = s.path, ""
                specs.append(JobSpec(s.path, config_from_args(args)))
                cases.append((s, cfg, route))
    runner = ServeRunner(device="cpu")
    try:
        results = runner.submit_jobs(specs)
    finally:
        runner.close()
    return cases, specs, results


def test_reference_equals_the_port(served):
    cases, specs, results = served
    assert len(results) == 16
    for (s, cfg, route), spec, res in zip(cases, specs, results):
        assert res.ok, res.error
        got = judge.render(res.fastas, spec.config.prefix)
        want = judge.expected(s, cfg["flags"])
        assert got == want, (s.path, route)
        assert want, s.path


def test_outputs_hold_insertions_and_ambiguity(served):
    cases, _, _ = served
    s, cfg, _ = cases[0]
    fasta = judge.expected(s, cfg["flags"])
    seq = list(fasta.values())[0].decode().split("\n")[1]
    # the 9 bp insertion outweighs the 6 bp deletion
    assert len(seq) == s.contig_len + 9
    assert set(seq) - set("ACGT-")


@pytest.mark.parametrize("control,cap", [("counts_float16", 4),
                                         ("insertions_dropped", None)])
def test_controls_change_the_bytes(served, control, cap):
    """A control over the same reads is not the reference: the counts cap
    (at 4 here, where the samples are shallow; the deep cell's 2,048 is
    reached by ``test_deep_sample_passes_2048_in_a_lane``) and the dropped
    insertions each change every sample's bytes."""
    cases, _, _ = served
    for s, cfg, _ in cases[::2]:
        opts = flags.parse(cfg["flags"])
        opts.update(controls.CONTROLS[control])
        if cap:
            opts["count_cap"] = cap
        r = pool.reads(s)
        ctl = rc.consensus(r.name, r.contig, r.contig_len, r.pos, r.cigars,
                           r.cigar_id, r.seq, **opts)
        assert ctl != judge.expected(s, cfg["flags"]), (s.path, control)
