"""The served decode's worker count, sized from the host.

A served job whose ``--decode-threads`` was not given decodes a plain SAM
file of two shards or more on the byte-shard rung with
``min(SERVE_DECODE_CAP, (usable CPUs - SERVE_BUSY_THREADS) // sharers)``
workers (``config.host_decode_workers``; ``sharers`` is a packed batch's
member pool), the queue's first job inline and the others on the
decode-ahead thread; gzip, BAM, ``--checkpoint-dir``, ``--paranoid`` and
a process-spanning mesh stay serial, an explicit ``--decode-threads``
keeps its meaning, and the one-shot CLI still defaults to one thread.  A served
queue writes the bytes of its serial decode and of the JAX package's
``--backend cpu`` oracle; a strict decode error in a decode-ahead job
reads as the serial one; ``stats.extra["decode_threads"]``, the
``ingest/mode`` gauge and ``serve/ahead_shard_jobs`` say what ran.
"""

import gc
import gzip
import os
import threading

import pytest

from sam2consensus_torch import config as t_config
from sam2consensus_torch.config import RunConfig as TConfig

MIB = 1 << 20
#: bodies of 2.1-2.6 MiB: two shard workers under the policy
N_READS = 9500


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Eight usable CPUs whatever the host has; no automatic collection
    (as ``test_torch_serve.py``); no decode thread left behind."""
    monkeypatch.setattr(t_config, "usable_cpus", lambda: 8)
    monkeypatch.setenv("S2C_JIT_CACHE", "")
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()
    for t in threading.enumerate():
        if t.name.startswith(("decode-worker-", "serve-decode-ahead")):
            t.join(timeout=5)
            assert not t.is_alive(), t.name


def _sim(folder, name, seed, n_reads=N_READS):
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    text = simulate(SimSpec(n_contigs=1, contig_len=4000, n_reads=n_reads,
                            read_len=100, contig_len_jitter=0.0, seed=seed,
                            ins_read_rate=0.2, contig_prefix="pol"))
    path = os.path.join(str(folder), name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


@pytest.fixture(scope="module")
def queue4(tmp_path_factory):
    """Four plain SAM files with insertions, each body over 2 MiB."""
    folder = tmp_path_factory.mktemp("queue4")
    paths = [_sim(folder, f"q{k}.sam", 70 + k) for k in range(4)]
    for p in paths:
        assert 2 * MIB < os.path.getsize(p) < 3 * MIB
    return paths


def _runner():
    from sam2consensus_torch.serve import ServeRunner

    return ServeRunner(prewarm="off", device="cpu")


def _submit(paths, **cfg):
    from sam2consensus_torch.serve import JobSpec

    r = _runner()
    try:
        results = r.submit_jobs([JobSpec(p, TConfig(**cfg)) for p in paths])
    finally:
        r.close()
    return r, results


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


def _read_dir(path):
    return {f: _read(os.path.join(path, f), "rb")
            for f in sorted(os.listdir(path))}


# -- the policy ----------------------------------------------------------------
@pytest.mark.parametrize("cpus,sharers,body,want", [
    (1, 1, 64 * MIB, 1), (2, 1, 64 * MIB, 1), (3, 1, 64 * MIB, 1),
    (4, 1, 64 * MIB, 2), (8, 1, 64 * MIB, 4), (64, 1, 64 * MIB, 4),
    (8, 2, 64 * MIB, 3), (8, 3, 64 * MIB, 2), (8, 4, 64 * MIB, 1),
    (64, 8, 64 * MIB, 4), (6, 2, 64 * MIB, 2),
    (8, 1, 2 * MIB - 1, 1), (8, 1, 2 * MIB, 4), (8, 1, 3 * MIB, 4),
    (8, 1, 0, 1), (8, 1, None, 1)])
def test_policy_worker_count(cpus, sharers, body, want):
    assert t_config.host_decode_workers(body, cpus, sharers) == want


@pytest.mark.parametrize("affinity,want", [
    (1, 1), (2, 1), (3, 1), (8, 4), (64, 4)])
def test_policy_reads_the_affinity(monkeypatch, affinity, want):
    monkeypatch.undo()          # the real usable_cpus
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(affinity)), raising=False)
    assert t_config.usable_cpus() == affinity
    assert t_config.host_decode_workers(64 * MIB) == want
    monkeypatch.delattr(os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: affinity)
    assert t_config.usable_cpus() == affinity


@pytest.mark.parametrize("flag,want", [("1", 1), ("3", 3),
                                       ("0", os.cpu_count())])
def test_explicit_decode_threads_is_honoured(flag, want):
    from sam2consensus_torch.cli import build_serve_parser, config_from_args

    args = build_serve_parser().parse_args(
        ["-i", "x.sam", "-o", "out", "--decode-threads", flag])
    args.filename, args.prefix = "x.sam", ""
    cfg = config_from_args(args)
    assert cfg.decode_threads == int(flag)
    for body in (None, 0, 64 * MIB):
        assert t_config.resolve_decode_threads(cfg, body) == want


def test_defaults_one_shot_one_and_serve_sized():
    from sam2consensus_torch.cli import build_parser, build_serve_parser

    assert build_parser().parse_args(["-i", "x.sam"]).decode_threads == 1
    assert TConfig().decode_threads == 1
    served = build_serve_parser().parse_args(["-i", "x.sam", "-o", "o"])
    assert served.decode_threads is None
    cfg = TConfig(decode_threads=None)
    assert t_config.resolve_decode_threads(cfg) == 1    # no body known
    assert t_config.resolve_decode_threads(cfg, 64 * MIB) == 4


# -- what stays serial ---------------------------------------------------------
@pytest.mark.parametrize("case", ["gzip", "bam", "checkpoint", "paranoid"])
def test_inputs_and_modes_that_stay_serial(tmp_path, queue4, case):
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.formats import open_alignment_input

    path = queue4[0]
    text = _read(path)
    if case == "gzip":
        path = str(tmp_path / "in.sam.gz")
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    elif case == "bam":
        from sam2consensus_torch.formats.bam import sam_text_to_bam

        path = sam_text_to_bam(text, str(tmp_path / "in.bam"))
    if case == "checkpoint":
        # serve refuses checkpoint jobs: the backend, as a served job
        # would reach it
        cfg = TConfig(backend="torch", decode_threads=None,
                      checkpoint_dir=str(tmp_path / "ck"))
        ai = open_alignment_input(path, "auto")
        try:
            extra = TorchBackend("cpu").run(ai.contigs, ai.stream,
                                            cfg).stats.extra
        finally:
            ai.close()
    else:
        _r, (res,) = _submit([path], decode_threads=None,
                             paranoid=case == "paranoid")
        assert res.ok, res.error
        extra = res.stats.extra
    assert extra.get("decode_threads", 1) == 1
    assert extra.get("ingest_mode", {}).get("rung") != "shards"


# -- a served queue ------------------------------------------------------------
def test_served_queue_equals_serial_and_cpu_oracle(tmp_path, monkeypatch,
                                                   queue4):
    from sam2consensus_torch import cli
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_tpu import cli as r_cli

    seen = []
    orig = TorchBackend.run

    def run(self, *args, **kwargs):
        result = orig(self, *args, **kwargs)
        seen.append(result.stats.extra)
        return result

    monkeypatch.setattr(TorchBackend, "run", run)
    flags = ["-c", "0.25,0.75"]
    inputs = sum((["-i", p] for p in queue4), [])
    outs = {}
    for name, extra in (("sized", []), ("serial", ["--decode-threads", "1"])):
        seen.clear()
        out = str(tmp_path / name)
        assert cli.main(["serve", *inputs, "-o", out, "--quiet", *flags,
                         *extra], device="cpu") == 0
        outs[name] = _read_dir(out)
        want = 2 if name == "sized" else 1
        assert [e["decode_threads"] for e in seen] == [want] * 4
    oracle = str(tmp_path / "oracle")
    for p in queue4:
        assert r_cli.main(["-i", p, "-o", oracle, "--backend", "cpu",
                           "--quiet", *flags]) == 0
    assert len(outs["sized"]) == 4
    assert outs["sized"] == outs["serial"] == _read_dir(oracle)


def test_strict_error_in_a_decode_ahead_job_reads_as_serial(tmp_path):
    good = _sim(tmp_path, "good.sam", 80)
    lines = _read(_sim(tmp_path, "src.sam", 81)).splitlines(keepends=True)
    # both in the second of the two shards; the earlier one wins
    lines.insert(len(lines) * 3 // 4, "broken\tline\n")
    lines.insert(len(lines) * 7 // 8, "also\tbroken\tbut\tlater\n")
    bad = str(tmp_path / "bad.sam")
    with open(bad, "w") as fh:
        fh.write("".join(lines))
    errors = {}
    for threads in (None, 1):
        _r, results = _submit([good, bad, good], decode_threads=threads)
        assert [x.ok for x in results] == [True, False, True]
        errors[threads] = results[1].error
        used = results[1].metrics.get("serve/ahead_shard_jobs", 0)
        assert used == (1 if threads is None else 0)
    assert errors[None] == errors[1]
    assert errors[1].startswith(("KeyError", "IndexError", "ValueError",
                                 "EncodeError"))


def test_counters_report_the_workers_used(queue4):
    r, results = _submit(queue4, decode_threads=None, pileup="pallas")
    assert [x.ok for x in results] == [True] * 4
    for k, res in enumerate(results):
        extra = res.stats.extra
        assert extra["decode_threads"] == 2
        assert extra["decode_rung"] == "slab"
        assert extra["ingest_mode"]["rung"] == "shards"
        assert extra["ingest_mode"]["threads"] == 2
        assert res.metrics.get("serve/ahead_shard_jobs", 0) == \
            (0 if k == 0 else 1)
    assert r.registry.value("serve/ahead_shard_jobs") == 3


@pytest.mark.parametrize("mode,pool,want", [
    ("batch", 2, 2), ("batch", 4, 1), ("count-cache", 2, 2),
    ("cohort", 2, 2)])
def test_other_served_modes_equal_their_serial_decode(tmp_path, monkeypatch,
                                                      queue4, mode, pool,
                                                      want):
    """Packed batches, the count cache and cohorts run the same policy
    through ``_make_encoder``: their bytes are their serial decode's.  A
    packed batch's members decode ``pool`` at once and divide the CPUs:
    8 - 2 over a pool of 2 is 3 workers each (2 on these two-shard
    bodies), over a pool of 4 one, the serial decoder."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.backends.torch_backend import TorchBackend

    monkeypatch.setenv("S2C_BATCH_DECODE_WORKERS", str(pool))
    seen = []
    orig = TorchBackend._make_encoder

    def spy(layout, records, cfg, stats, acc=None, sharers=1):
        out = orig(layout, records, cfg, stats, acc, sharers)
        seen.append(stats.extra.get("decode_threads", 1))
        return out

    monkeypatch.setattr(TorchBackend, "_make_encoder", staticmethod(spy))
    args = {"batch": ["--batch", "auto", "--batch-window", "50"],
            "count-cache": ["--count-cache", "2G", "--incremental"],
            "cohort": ["--cohort-manifest", os.path.dirname(queue4[0])]}
    inputs = [] if mode == "cohort" else sum((["-i", p] for p in queue4), [])
    outs = {}
    for name, extra in (("sized", []), ("serial", ["--decode-threads", "1"])):
        seen.clear()
        out = str(tmp_path / name)
        assert cli.main(["serve", *inputs, "-o", out, "--quiet", "-c", "0.25",
                         *args[mode], *extra], device="cpu") == 0
        outs[name] = _read_dir(out)
        assert set(seen) == {want if name == "sized" else 1}, seen
    assert len(outs["sized"]) == 4
    assert outs["sized"] == outs["serial"]


@pytest.mark.parametrize("shards,want", [(0, 1), (2, 1), (1, 2)])
def test_decode_ahead_job_under_a_spanning_mesh_stays_serial(
        monkeypatch, queue4, shards, want):
    """Over a process group of two ranks an ahead job, decoded before its
    run resolves ``--shards``, keeps the serial decoder unless its
    ``--shards`` is 1: every rank must decode the same batches."""
    from sam2consensus_torch import observability as obs
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.encoder.parallel_decode import \
        ParallelFusedDecoder
    from sam2consensus_torch.parallel import mesh
    from sam2consensus_torch.serve import JobSpec
    from sam2consensus_torch.serve.runner import _DecodeAhead

    monkeypatch.setattr(mesh, "process_group", lambda: (2, 0))
    cfg = TConfig(decode_threads=None, shards=shards)
    ahead = _DecodeAhead(TorchBackend("cpu"), JobSpec(queue4[1], cfg),
                         obs.prepare_run(config=cfg), cap=1)
    try:
        ahead.release()
        ahead.thread.join(timeout=10)
        assert not ahead.thread.is_alive()
        assert ahead.error is None, ahead.error
        assert ahead.extra["decode_threads"] == want
        assert isinstance(ahead.encoder, ParallelFusedDecoder) == \
            (want > 1)
        assert ahead.robs.registry.value("serve/ahead_shard_jobs") == \
            (1 if want > 1 else 0)
        for _batch in ahead.rest or ():
            pass
    finally:
        ahead.close()
