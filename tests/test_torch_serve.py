"""The port's warm server on the CPU, held against the JAX package.

``ServeRunner(device="cpu")`` and ``cli.main(["serve", ...],
device="cpu")``: a served queue writes the FASTA bytes of ``--backend
jax`` one-shot runs of the same inputs (plain, gzip and BAM SAM, two
thresholds, ``--py2-compat``; with and without decode-ahead), publishes
``serve/overlap_sec`` on the jobs it decoded ahead, demotes only a
faulting job, survives a failed job, refuses checkpoint jobs, incremental
jobs without the count cache and every serve flag the port does not run
yet by name, runs the batching and count-cache options it does run (each
queue's bytes equal to the JAX package's ``ServeRunner`` on the same
queue and flags), and without a named device needs CUDA.  The prewarm runs the pileup route over all-PAD
rows without counting anything.  Admission control (queue bound, tenant
quota, ``--mem-budget``, degraded-tenant pinning) and the decode-ahead
fault site behave as the reference's.
"""

import gc
import gzip
import os

import pytest
import torch

from sam2consensus_torch.config import RunConfig as TConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture(autouse=True)
def _collect_jax_garbage(monkeypatch):
    """No automatic collection during a test (the JAX package's registry
    lock and memplane finalizers deadlock, ROADMAP §C 2), and no JAX
    persistent compilation cache (its config is process-global)."""
    monkeypatch.setenv("S2C_JIT_CACHE", "")
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def sim(tmp, name, seed, contig_len=3000, n_reads=1200, gz=False, **kw):
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    text = simulate(SimSpec(n_contigs=1, contig_len=contig_len,
                            n_reads=n_reads, read_len=100,
                            contig_len_jitter=0.0, seed=seed,
                            contig_prefix="srv", **kw))
    path = os.path.join(str(tmp), name)
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(text.encode("ascii"))
    else:
        with open(path, "w") as fh:
            fh.write(text)
    return path


def runner(**kw):
    from sam2consensus_torch.serve import ServeRunner

    kw.setdefault("prewarm", "off")
    kw.setdefault("device", "cpu")
    return ServeRunner(**kw)


def rendered(result):
    from sam2consensus_torch.io.fasta import render_file

    return {n: render_file(r, 0) for n, r in result.fastas.items()}


def jax_cold(path, cfg=None, **kw):
    """One independent ``--backend jax`` run (fresh backend), rendered."""
    from sam2consensus_tpu.backends.jax_backend import JaxBackend
    from sam2consensus_tpu.config import RunConfig
    from sam2consensus_tpu.formats import open_alignment_input
    from sam2consensus_tpu.io.fasta import render_file

    fields = dict(backend="jax", shards=1, pileup="scatter")
    if cfg is not None:
        fields.update(thresholds=cfg.thresholds, maxdel=cfg.maxdel,
                      py2_compat=cfg.py2_compat, prefix=cfg.prefix,
                      min_depth=cfg.min_depth)
    fields.update(kw)
    ai = open_alignment_input(path, "auto", binary=True)
    try:
        res = JaxBackend().run(ai.contigs, ai.stream, RunConfig(**fields))
    finally:
        ai.close()
    return {n: render_file(r, 0) for n, r in res.fastas.items()}


def read_dir(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def jax_cli_dir(paths, out, extra=()):
    """``--backend jax`` one-shot CLI runs of ``paths`` into ``out``."""
    from sam2consensus_tpu import cli as r_cli

    for p in paths:
        assert r_cli.main(["-i", p, "-o", out, "--backend", "jax",
                           "--quiet", *extra]) == 0
    return read_dir(out)


# -- the CLI: a served queue IS N one-shot runs ------------------------------
@pytest.mark.parametrize("ahead", ["decode-ahead", "no-decode-ahead"])
def test_served_queue_equals_jax_one_shot(tmp_path, ahead):
    from sam2consensus_torch import cli
    from sam2consensus_tpu.formats.bam import sam_text_to_bam

    a = sim(tmp_path, "a.sam", 11)
    b = sim(tmp_path, "b.sam.gz", 12, gz=True)
    c = sam_text_to_bam(open(sim(tmp_path, "c_src.sam", 13)).read(),
                        str(tmp_path / "c.bam"))
    inputs = [a, b, c, os.path.join(DATA, "formats_longread.sam")]
    flags = ["-c", "0.25,0.75"]
    out = str(tmp_path / "served")
    argv = ["serve", *sum((["-i", p] for p in inputs), []), "-o", out,
            "--quiet", "--pileup", "pallas", *flags]
    if ahead == "no-decode-ahead":
        argv.append("--no-decode-ahead")
    assert cli.main(argv, device="cpu") == 0
    assert read_dir(out) == jax_cli_dir(inputs, str(tmp_path / "cold"),
                                        flags)


def test_served_py2_compat_equals_jax(tmp_path):
    from sam2consensus_torch import cli

    paths = [sim(tmp_path, f"p{k}.sam", 21 + k, del_read_rate=0.3)
             for k in range(2)]
    flags = ["-d", "2", "--py2-compat", "-m", "2"]
    out = str(tmp_path / "served")
    assert cli.main(["serve", "-i", paths[0], "-i", paths[1], "-o", out,
                     "--quiet", *flags], device="cpu") == 0
    assert read_dir(out) == jax_cli_dir(paths, str(tmp_path / "cold"),
                                        flags)


def test_serve_cli_end_to_end_metrics(tmp_path):
    import json

    from sam2consensus_torch import cli

    a = sim(tmp_path, "cli_a.sam", 90)
    b = sim(tmp_path, "cli_b.sam.gz", 91, gz=True)
    out = str(tmp_path / "out")
    mbase = str(tmp_path / "metrics")
    assert cli.main(["serve", "-i", a, "-i", b, "-o", out, "--pileup",
                     "pallas", "--quiet", "--metrics-out", mbase],
                    device="cpu") == 0
    for k in (0, 1):
        assert os.path.exists(f"{mbase}.job{k}.jsonl")
        man = json.load(open(f"{mbase}.job{k}.jsonl.manifest.json"))
        assert man["schema"] == "s2c-manifest/1"
        assert man["lifecycle"]["trace_id"].startswith(f"job{k}:")
        if k > 0:
            assert "serve/overlap_sec" in man["serve"]


# -- the API -------------------------------------------------------------------
def test_api_queue_equals_jax_cold(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    jobs = [
        (sim(tmp_path, "a.sam", 31), TConfig(pileup="pallas", prefix="a")),
        (sim(tmp_path, "b.sam.gz", 32, gz=True),
         TConfig(pileup="scatter", prefix="b", thresholds=[0.25, 0.75])),
        (sim(tmp_path, "c.sam", 33), TConfig(pileup="host", prefix="c")),
        (sim(tmp_path, "d.sam", 34, ins_read_rate=0.3),
         TConfig(pileup="auto", prefix="d", decode_threads=2)),
    ]
    r = runner()
    try:
        results = r.submit_jobs([JobSpec(p, c) for p, c in jobs])
    finally:
        r.close()
    assert [x.ok for x in results] == [True] * len(jobs)
    for (path, cfg), res in zip(jobs, results):
        assert rendered(res) == jax_cold(path, cfg), path
    assert r.registry.value("serve/jobs") == len(jobs)


def test_overlap_metric_published(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"o{k}.sam", 40 + k) for k in range(3)]
    r = runner()
    try:
        results = r.submit_jobs([JobSpec(p, TConfig(pileup="pallas"))
                                 for p in paths])
    finally:
        r.close()
    assert all(x.ok for x in results)
    # job 1 was never decoded ahead; jobs 2+ carry the measured
    # cross-job intersection (>= 0: a tiny job can decode before the
    # previous job dispatches)
    assert "serve/overlap_sec" not in results[0].metrics
    for res in results[1:]:
        assert res.metrics["serve/overlap_sec"] >= 0.0
        assert res.metrics["serve/decode_ahead_sec"] > 0.0
        assert res.stats.extra["decoder"] in ("native", "py")


@pytest.mark.parametrize("pileup", ["pallas", "host"])
def test_decode_ahead_waits_for_previous_first_dispatch(tmp_path,
                                                        monkeypatch,
                                                        pileup):
    import sam2consensus_torch.serve.runner as srunner
    from sam2consensus_torch.serve import JobSpec

    aheads, dlogs = [], []
    orig_init = srunner._DecodeAhead.__init__
    orig_execute = srunner.ServeRunner._execute

    def init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        aheads.append(self)

    def execute(self, contigs, records, cfg, robs, dlog, job_id):
        dlogs.append(dlog)
        return orig_execute(self, contigs, records, cfg, robs, dlog, job_id)

    monkeypatch.setattr(srunner._DecodeAhead, "__init__", init)
    monkeypatch.setattr(srunner.ServeRunner, "_execute", execute)
    paths = [sim(tmp_path, f"w{k}.sam", 80 + k) for k in range(3)]
    r = runner()
    try:
        results = r.submit_jobs([JobSpec(p, TConfig(pileup=pileup))
                                 for p in paths])
    finally:
        r.close()
    assert all(x.ok for x in results)
    assert len(aheads) == 2 and len(dlogs) == 3
    # job k+1's decode (its open first) begins no earlier than job k's
    # first pileup dispatch
    for ahead, dlog in zip(aheads, dlogs):
        assert dlog and ahead.intervals()
        assert ahead.intervals()[0][0] >= dlog[0][0]


def test_midqueue_fault_demotes_only_that_job(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"f{k}.sam", 60 + k) for k in range(3)]
    faulty = TConfig(pileup="pallas",
                     fault_inject="pileup_dispatch:rpc:0:inf",
                     on_device_error="fallback", retries=1,
                     retry_backoff=0.01)
    cfgs = [TConfig(pileup="pallas"), faulty, TConfig(pileup="pallas")]
    r = runner()
    try:
        results = r.submit_jobs([JobSpec(p, c)
                                 for p, c in zip(paths, cfgs)])
    finally:
        r.close()
    assert [x.ok for x in results] == [True, True, True]
    assert results[1].metrics.get("resilience/demotions", 0) >= 1
    assert results[1].rungs.get("pileup") == "host"
    for k in range(3):
        assert rendered(results[k]) == jax_cold(paths[k])
    # the NEXT job never saw the demotion
    assert results[2].metrics.get("resilience/demotions", 0) == 0
    assert results[2].rungs == {}
    assert "pileup_ladder" not in results[2].stats.extra


def test_failed_job_does_not_kill_the_server(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    good = sim(tmp_path, "g.sam", 70)
    cfg = TConfig(pileup="pallas")
    r = runner()
    try:
        results = r.submit_jobs([
            JobSpec(good, cfg),
            JobSpec(str(tmp_path / "missing.sam"), cfg),
            JobSpec(good, cfg)])
    finally:
        r.close()
    assert [x.ok for x in results] == [True, False, True]
    assert "FileNotFoundError" in results[1].error
    assert rendered(results[2]) == jax_cold(good)
    assert r.registry.value("serve/jobs_failed") == 1


@pytest.mark.parametrize("cfg,match", [
    (dict(checkpoint_dir="ck"), "checkpoint"),
    (dict(incremental=True), "incremental serve jobs need the "
                             "per-reference count cache"),
    (dict(shards=2), r"--shards 2 exceeds the 1 available device\(s\)"),
    (dict(shard_mode="dp"), None),
    (dict(pileup="mxu"), "--pileup mxu: not supported by the torch"),
])
def test_serve_rejects_jobs_up_front(tmp_path, cfg, match):
    """A job the server cannot run is refused at admission, before
    anything is journaled or decoded.  ``shards=2`` over the server's
    one-device mesh is the reference's ``MeshCapacityError``;
    ``shard_mode="dp"`` at one shard is admitted and runs as a
    single-device job (``match`` None)."""
    from sam2consensus_torch.serve import JobSpec

    path = sim(tmp_path, "r.sam", 80)
    if "checkpoint_dir" in cfg:
        cfg = dict(checkpoint_dir=str(tmp_path / "ck"))
    r = runner()
    try:
        if match is None:
            (res,) = r.submit_jobs([JobSpec(path, TConfig(**cfg))])
            assert res.ok and r.registry.value("serve/jobs") == 1
            assert rendered(res) == jax_cold(path, TConfig(**cfg), **cfg)
            return
        with pytest.raises(ValueError, match=match):
            r.submit_jobs([JobSpec(path, TConfig(**cfg))])
        assert r.registry.value("serve/jobs") == 0
    finally:
        r.close()


def test_env_metrics_out_suffixed_per_job(tmp_path, monkeypatch):
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"e{k}.sam", 85 + k) for k in range(2)]
    base = str(tmp_path / "envm.jsonl")
    monkeypatch.setenv("S2C_METRICS_OUT", base)
    r = runner()
    try:
        results = r.submit_jobs([JobSpec(p, TConfig(pileup="pallas"))
                                 for p in paths])
    finally:
        r.close()
    assert all(x.ok for x in results)
    assert os.path.exists(base + ".job0")
    assert os.path.exists(base + ".job1")
    assert not os.path.exists(base)


# -- refusals and the device policy ------------------------------------------
UNPORTED = [
    (["--shards", "2"], "--shards 2"),
    (["--shard-mode", "dp"], "--shard-mode dp"),
    (["--pileup", "mxu"], "--pileup mxu"),
]


@pytest.mark.parametrize("argv,named", UNPORTED,
                         ids=[u[0][0] + "=" + u[0][-1] for u in UNPORTED])
def test_unported_serve_flag_refused_by_name(tmp_path, argv, named):
    """``--pileup mxu`` is refused by name at server start.  The sharding
    flags run now: ``--shards 2`` over the one-device CPU mesh fails the
    start with the reference's ``MeshCapacityError`` text, and
    ``--shard-mode dp`` serves a job byte-identical to ``--backend
    jax``'s one-shot run."""
    from sam2consensus_torch import cli
    from sam2consensus_tpu.parallel import mesh as r_mesh

    if argv[0] == "--shard-mode":
        path = sim(tmp_path, "x.sam", 81)
        assert cli.main(["serve", "-i", path, "-o", str(tmp_path / "o"),
                         "--quiet", *argv], device="cpu") == 0
        assert read_dir(str(tmp_path / "o")) == jax_cli_dir(
            [path], str(tmp_path / "ref"), extra=argv)
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "-i", str(tmp_path / "x.sam"), "-o",
                  str(tmp_path / "o"), "--quiet", *argv], device="cpu")
    if argv[0] == "--shards":
        with pytest.raises(r_mesh.MeshCapacityError) as want:
            r_mesh.validate_shards(2, n_available=1)
        # torch.distributed named where the reference names
        # jax.distributed
        assert str(exc.value.code) == "error: " + str(want.value).replace(
            "jax.distributed", "torch.distributed")
        return
    assert str(exc.value.code) == (f"error: {named}: not supported by "
                                   f"the torch backend yet")


@pytest.mark.parametrize("env,value", [("S2C_MESH_HOSTS", "2")])
def test_unported_serve_env_refused_by_name(tmp_path, monkeypatch, env,
                                            value):
    """``S2C_MESH_HOSTS``, once refused by name, now runs as the
    reference's: the server reads it into admission's ``mesh_hosts``, a
    ``serve`` run under it writes the reference's files, and a value that
    is not an integer fails the start with the reference's text."""
    from sam2consensus_torch import cli
    from sam2consensus_tpu.serve import ServeRunner as RServeRunner

    monkeypatch.setenv(env, value)
    r = runner()
    try:
        assert r.admission.mesh_hosts == int(value)
    finally:
        r.close()
    path = sim(tmp_path, "x.sam", 81)
    assert cli.main(["serve", "-i", path, "-o", str(tmp_path / "o"),
                     "--quiet"], device="cpu") == 0
    assert read_dir(str(tmp_path / "o")) == jax_cli_dir(
        [path], str(tmp_path / "ref"))
    monkeypatch.setenv(env, "lots")
    with pytest.raises(ValueError) as got:
        runner()
    monkeypatch.setenv("S2C_JIT_CACHE", "")
    with pytest.raises(ValueError) as want:
        RServeRunner(prewarm="off", persistent_cache=False)
    assert str(got.value) == str(want.value)


# -- the batching and count-cache options now run -----------------------------
def small(tmp, name, seed):
    return sim(tmp, name, seed, contig_len=1500, n_reads=400)


def jax_serve_dir(argv, out):
    """The JAX package's ``serve`` over the same argv into ``out``."""
    from sam2consensus_tpu import cli as r_cli

    assert r_cli.main(["serve", *argv, "-o", out, "--quiet"]) == 0
    return read_dir(out)


PORTED = [["--batch", "4"], ["--batch", "auto"], ["--batch-window", "20"],
          ["--count-cache", "512M"], ["--count-cache", "64M",
                                      "--incremental"],
          ["--worker-id", "w1", "--journal", "{j}"], ["--lease-ttl", "5"],
          ["--ingest-port", "0", "--journal", "{j}"],
          ["--stability-waves", "5"], ["--revote-debounce", "1"],
          ["--ingest-max-body", "100"], ["--ingest-timeout", "3"],
          ["--ingest-max-pending", "4"]]


def _session_through_cli(tmp_path, paths, argv):
    """``serve --ingest-port`` on this thread; a client thread opens a
    session over ``paths[0]``'s header, posts each input's reads as one
    wave, closes it and interrupts the server.  Returns the session's
    outputs (reference -> FASTA text) and the server's exit code."""
    import _thread
    import http.client
    import json
    import socket
    import threading
    import time

    from sam2consensus_torch import cli

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    argv = [a if a != "0" or argv[i - 1] != "--ingest-port" else str(port)
            for i, a in enumerate(argv)]
    texts = [open(p).read() for p in paths]
    header = "".join(ln for ln in texts[0].splitlines(True)
                     if ln.startswith("@"))
    waves = ["".join(ln for ln in t.splitlines(True)
                     if not ln.startswith("@")).encode() for t in texts]
    got = {}

    def post(path, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("POST", path, body=body,
                         headers={"Content-Length": str(len(body))})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def client():
        try:
            for _ in range(300):
                try:
                    st, doc = post("/session/open", header.encode())
                    break
                except OSError:
                    time.sleep(0.05)
            sid = doc["sid"]
            got["waves"] = [post(f"/session/{sid}/wave", w)[0]
                            for w in waves]
            st, doc = post(f"/session/{sid}/close")
            got["close"] = st
            got["outputs"] = {os.path.basename(p).split("__")[0]:
                              open(p).read() for p in doc["outputs"]}
        finally:
            _thread.interrupt_main()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    rc = cli.main(["serve", *argv, "--quiet"], device="cpu")
    t.join(30)
    assert got.get("waves") == [200] * len(paths) and got["close"] == 200
    return got["outputs"], rc


@pytest.mark.parametrize("argv", PORTED, ids=[" ".join(a) for a in PORTED])
def test_ported_serve_flag_runs_a_job(tmp_path, argv):
    """Each option the refusal list no longer names starts a server
    and runs its jobs, with the JAX package's serve bytes (a session
    server: the JAX package's one-shot bytes over every posted read)."""
    from sam2consensus_torch import cli

    paths = [small(tmp_path, f"p{k}.sam", 95 + k) for k in range(2)]
    inputs = sum((["-i", p] for p in paths), [])
    out = str(tmp_path / "o")
    if "--ingest-port" in argv:
        argv = [a.replace("{j}", str(tmp_path / "j")) for a in argv]
        outputs, rc = _session_through_cli(tmp_path, paths, argv)
        assert rc == 0
        both = str(tmp_path / "both.sam")
        with open(both, "w") as fh:
            fh.write(open(paths[0]).read())
            fh.writelines(ln for ln in open(paths[1])
                          if not ln.startswith("@"))
        assert outputs == jax_cold(both, TConfig(prefix=""))
        return
    t_argv = [a.replace("{j}", str(tmp_path / "j_t")) for a in argv]
    r_argv = [a.replace("{j}", str(tmp_path / "j_r")) for a in argv]
    assert cli.main(["serve", *inputs, "-o", out, "--quiet", *t_argv],
                    device="cpu") == 0
    assert read_dir(out) == jax_serve_dir([*inputs, *r_argv],
                                          str(tmp_path / "ref"))


def test_count_cache_env_runs_incremental_jobs(tmp_path, monkeypatch):
    """``S2C_COUNT_CACHE`` arms the cache of the CLI's server and of
    a ``ServeRunner`` built in code: incremental jobs run, the second
    on the first's warm counts."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.serve import JobSpec

    monkeypatch.setenv("S2C_COUNT_CACHE", "1G")
    inputs = sum((["-i", small(tmp_path, f"e{k}.sam", 97 + k)]
                  for k in range(2)), [])
    out = str(tmp_path / "o")
    assert cli.main(["serve", *inputs, "-o", out, "--quiet",
                     "--incremental"], device="cpu") == 0
    assert read_dir(out) == jax_serve_dir([*inputs, "--incremental"],
                                          str(tmp_path / "ref"))
    r = runner()
    try:
        assert r.count_cache is not None and r.count_cache.budget == 1 << 30
        res = r.submit_jobs([JobSpec(inputs[1], TConfig(incremental=True))])
    finally:
        r.close()
    assert res[0].ok and res[0].metrics.get("cache/misses") == 1


@pytest.mark.parametrize("kw", [dict(batch="2"), dict(batch_window=5.0),
                                dict(count_cache="64M"),
                                dict(worker_id="w", journal_dir="{j}"),
                                dict(lease_ttl=3.0)],
                         ids=["batch", "batch_window", "count_cache",
                              "worker_id", "lease_ttl"])
def test_ported_runner_options_run_jobs(tmp_path, kw):
    """The runner's ``batch``, ``batch_window``, ``count_cache``,
    ``worker_id`` and ``lease_ttl`` start a server whose jobs equal
    independent ``--backend jax`` runs (``batch="2"`` packs them; a
    fleet worker commits each job into its output folder)."""
    from sam2consensus_torch.serve import JobSpec

    kw = {k: str(tmp_path / "j") if v == "{j}" else v
          for k, v in kw.items()}
    paths = [small(tmp_path, f"k{k}.sam", 100 + k) for k in range(2)]
    cfgs = [TConfig() for _ in paths]
    if "journal_dir" in kw:
        os.makedirs(tmp_path / "o")
        cfgs = [TConfig(outfolder=str(tmp_path / "o") + os.sep,
                        prefix=f"k{k}") for k in range(2)]
    r = runner(**kw)
    try:
        results = r.submit_jobs([JobSpec(p, c)
                                 for p, c in zip(paths, cfgs)])
    finally:
        r.close()
    assert all(x.ok for x in results), [x.error for x in results]
    for path, cfg, res in zip(paths, cfgs, results):
        assert rendered(res) == jax_cold(path, cfg)
    packed = r.registry.value("batch/packed_jobs")
    assert packed == (2 if kw.get("batch") == "2" else 0)


@pytest.mark.parametrize("argv", [
    ["--fault-inject", "nonsense//"], ["--slo", "e2e=fast"],
    ["--mem-budget", "lots"]])
def test_serve_cli_start_checks_equal_reference(tmp_path, argv):
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    base = ["serve", "-i", str(tmp_path / "x.sam"), "--quiet"]
    with pytest.raises(SystemExit) as t_exit:
        t_cli.main(base + argv, device="cpu")
    with pytest.raises(SystemExit) as r_exit:
        r_cli.main(base + argv)
    assert str(t_exit.value.code) == str(r_exit.value.code)


def test_serve_cli_needs_an_input():
    from sam2consensus_torch import cli

    with pytest.raises(SystemExit, match="at least one -i/--input"):
        cli.main(["serve", "--quiet"], device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
def test_server_needs_cuda_unless_cpu_is_named(tmp_path):
    from sam2consensus_torch import cli
    from sam2consensus_torch.serve import ServeRunner, submit_jobs

    with pytest.raises(RuntimeError, match="CUDA"):
        ServeRunner()
    with pytest.raises(RuntimeError, match="CUDA"):
        submit_jobs([])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "-i", sim(tmp_path, "x.sam", 1), "-o",
                  str(tmp_path / "o"), "--quiet"])


# -- prewarm ------------------------------------------------------------------
def test_prewarm_of_all_pad_rows_counts_nothing():
    from sam2consensus_torch.ops.pileup import (canonical_slab_shapes,
                                                padded_total_len,
                                                prewarm_pileup)

    total_len = 5000
    shapes = canonical_slab_shapes(total_len, read_len=100,
                                   chunk_reads=4096)
    counts = torch.zeros((padded_total_len(total_len), 6),
                         dtype=torch.int32)
    assert prewarm_pileup(total_len, shapes, "cpu", counts=counts) \
        == len(shapes)
    assert int(counts.abs().sum()) == 0


def test_runner_prewarm_counts_shapes_in_server_registry(tmp_path):
    from sam2consensus_torch.ops.pileup import canonical_slab_shapes
    from sam2consensus_torch.serve import JobSpec

    path = sim(tmp_path, "p.sam", 31, contig_len=7777)
    r = runner()
    try:
        shapes = canonical_slab_shapes(7777, read_len=100, n_reads=1200)
        assert r.prewarm(7777, shapes) == len(shapes)
        assert r.prewarm(7777, shapes) == 0            # idempotent
        assert r.registry.value("compile/prewarm_shapes") == len(shapes)
        [res] = r.submit_jobs([JobSpec(path, TConfig(pileup="pallas"))])
    finally:
        r.close()
    assert res.ok and rendered(res) == jax_cold(path)
    assert not any(k.startswith("compile/prewarm") for k in res.metrics)


@pytest.mark.parametrize("pileup,engaged", [("pallas", True),
                                            ("scatter", True),
                                            ("auto", False),
                                            ("host", False)])
def test_auto_prewarm_engages_for_explicit_device_pileup(tmp_path, pileup,
                                                         engaged):
    from sam2consensus_torch.serve import JobSpec

    path = sim(tmp_path, "w.sam", 32)
    r = runner(prewarm="auto")
    try:
        [res] = r.submit_jobs([JobSpec(path, TConfig(pileup=pileup))])
        for t in list(r._prewarm_threads):
            t.join(timeout=30)
    finally:
        r.close()
    assert res.ok
    assert (r.registry.value("compile/prewarm_shapes") > 0) == engaged


# -- admission ------------------------------------------------------------------
def test_admission_queue_bound_and_tenant_quota(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    path = sim(tmp_path, "q.sam", 100)
    cfg = TConfig(pileup="pallas")
    r = runner(max_queue=3, tenant_quota=2)
    try:
        res = r.submit_jobs([JobSpec(path, cfg, tenant="a"),
                             JobSpec(path, cfg, tenant="a"),
                             JobSpec(path, cfg, tenant="a"),
                             JobSpec(path, cfg, tenant="b"),
                             JobSpec(path, cfg, tenant="b")])
    finally:
        r.close()
    assert [x.ok for x in res] == [True, True, False, True, False]
    assert res[2].admission == "tenant_quota"
    assert res[4].admission == "queue_full"
    assert "admission rejected: tenant_quota" in res[2].error
    assert r.registry.value("serve/admission_rejected") == 2
    assert r.registry.value("serve/admission_admitted") == 3
    snap = r.health_snapshot()
    assert snap["admission"]["rejected"] == 2


def test_mem_budget_sheds_by_capacity(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    small = sim(tmp_path, "s.sam", 101, contig_len=2000)
    big = sim(tmp_path, "b.sam", 102, contig_len=400_000, n_reads=200)
    # the port's model prices a slab of --chunk-reads rows: ~173 MB for
    # the small genome, ~183 MB for the large one
    r = runner(mem_budget="170M")
    try:
        res = r.submit_jobs([JobSpec(small, TConfig(pileup="pallas")),
                             JobSpec(big, TConfig(pileup="pallas"))])
    finally:
        r.close()
    assert [x.ok for x in res] == [True, False]
    assert res[1].admission == "capacity"
    assert "predicted peak" in res[1].error
    assert r.registry.value("serve/admission_capacity") == 1


def test_degraded_tenant_pinned_to_host_rung(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"t{k}.sam", 110 + k) for k in range(3)]
    faulty = TConfig(pileup="pallas",
                     fault_inject="pileup_dispatch:rpc:0:inf",
                     on_device_error="fallback", retries=1,
                     retry_backoff=0.01)
    r = runner()
    try:
        res = r.submit_jobs([
            JobSpec(paths[0], faulty, tenant="cursed"),
            JobSpec(paths[1], TConfig(pileup="pallas"), tenant="cursed"),
            JobSpec(paths[2], TConfig(pileup="pallas"), tenant="fine")])
    finally:
        r.close()
    assert [x.ok for x in res] == [True, True, True]
    assert res[1].admission == "pinned:host"
    assert res[1].stats.extra["pileup_path"] == "host"
    assert res[2].admission is None and res[2].rungs == {}
    # one good pinned job is the probation: the tenant is released
    assert r.admission.tenant_rungs == {}
    for k in range(3):
        assert rendered(res[k]) == jax_cold(paths[k])


def test_decode_ahead_fault_fails_only_its_job(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"d{k}.sam", 120 + k) for k in range(3)]
    # call 0 is job 2's open (job 1 never decodes ahead)
    r = runner(fault_inject="serve_decode_ahead:rpc:0:1")
    try:
        res = r.submit_jobs([JobSpec(p, TConfig(pileup="pallas"))
                             for p in paths])
    finally:
        r.close()
    assert [x.ok for x in res] == [True, False, True]
    assert "InjectedRpcError" in res[1].error
    assert rendered(res[2]) == jax_cold(paths[2])
