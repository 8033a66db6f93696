"""The port's serve survivability on the CPU, held against the JAX package.

The journal (``serve/journal.py``, a pinned copy): the same event
sequence as the reference runner's for the same queue, the same
``job_key`` for the same flags (so a journal written by one package's
server reads in the other's), a restart that skips committed jobs by
output fingerprint, and a SIGKILL mid-queue followed by a resume that is
byte-identical with no job lost or run twice.  The kill window cannot be
missed: job 2 hangs on a ``job_hang`` fault while job 1 is committed.
The watchdog: a wedged dispatch (``job_hang``) fails only its job, or
retries it once on the host rung under ``--on-device-error fallback``; a
journal that cannot be written degrades durability only; the health
snapshot has the reference's keys.
"""

import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.serve import journal as t_journal
from sam2consensus_tpu.serve import journal as r_journal
from test_torch_serve import jax_cold, read_dir, rendered, runner, sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _collect_jax_garbage(monkeypatch):
    """No automatic collection during a test (ROADMAP §C 2); no JAX
    persistent compilation cache."""
    monkeypatch.setenv("S2C_JIT_CACHE", "")
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _join_abandoned(before, timeout=60.0):
    """Wait for the job threads this test's watchdog abandoned (each
    wakes from its short ``job_hang`` sleep and finishes its own run),
    so nothing of theirs outlives the test; ``before`` holds the threads
    alive when it began (another test file's may still sleep)."""
    for t in threading.enumerate():
        if t.name.startswith("serve-job-") and t not in before:
            t.join(timeout)
            assert not t.is_alive(), t.name


def _ref_runner(**kw):
    from sam2consensus_tpu.serve import ServeRunner

    kw.setdefault("prewarm", "off")
    kw.setdefault("persistent_cache", False)
    return ServeRunner(**kw)


# -- job keys and the journal ---------------------------------------------------
@pytest.mark.parametrize("fields", [
    {}, dict(thresholds=[0.25, 0.75]), dict(min_depth=3, fill="N"),
    dict(maxdel=None, py2_compat=True), dict(prefix="p", nchar=60),
    dict(strict=False), dict(outfolder="/tmp/x/"),
    dict(pileup="host", fault_inject="job_hang:timeout:0:1", retries=0)])
def test_job_key_equals_reference(fields):
    from sam2consensus_tpu.config import RunConfig as RConfig

    assert t_journal.job_key("a/b.sam", TConfig(**fields)) == \
        r_journal.job_key("a/b.sam", RConfig(**fields))
    # backend-side knobs keep the identity
    assert t_journal.job_key("a/b.sam", TConfig(**fields)) == \
        t_journal.job_key("a/b.sam", TConfig(**dict(fields,
                                                     wire="delta8")))


def _events(jdir):
    return [(e["ev"], e.get("job"), e.get("key"), e.get("mode"),
             e.get("reason"), os.path.basename(e.get("ckpt") or ""))
            for e in t_journal.JobJournal(jdir).events()]


def test_journal_event_sequence_equals_reference(tmp_path):
    """The same queue (a good job, a missing input, a rejected job over
    the queue bound, a good job) through the reference's journaled runner
    and the port's, into one output folder: the same events with the
    same job ids and keys, the same FASTA bytes, and a restart of the
    port over the reference's journal skips its committed jobs."""
    from sam2consensus_torch.serve import JobSpec as TSpec
    from sam2consensus_tpu.config import RunConfig as RConfig
    from sam2consensus_tpu.serve import JobSpec as RSpec

    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    a = sim(tmp_path, "a.sam", 201)
    b = sim(tmp_path, "b.sam", 202)
    queue = [(a, "a"), (str(tmp_path / "missing.sam"), "m"), (b, "b"),
             (a, "c")]
    rdir, tdir = str(tmp_path / "rj"), str(tmp_path / "tj")
    r = _ref_runner(journal_dir=rdir, max_queue=3)
    try:
        r_res = r.submit_jobs([RSpec(p, RConfig(
            backend="jax", shards=1, pileup="scatter", outfolder=out,
            prefix=pre)) for p, pre in queue])
    finally:
        r.close()
    want = read_dir(out)
    t = runner(journal_dir=tdir, max_queue=3)
    try:
        t_res = t.submit_jobs([TSpec(p, TConfig(
            pileup="pallas", outfolder=out, prefix=pre))
            for p, pre in queue])
    finally:
        t.close()
    assert [x.ok for x in t_res] == [x.ok for x in r_res] \
        == [True, False, True, False]
    assert [x.admission for x in t_res] == [None, None, None, "queue_full"]
    assert _events(tdir) == _events(rdir)
    assert read_dir(out) == want
    assert [sorted(x.output_paths) for x in t_res] == \
        [sorted(x.output_paths) for x in r_res]
    # a journal written by the reference resumes in the port
    t2 = runner(journal_dir=rdir)
    try:
        res = t2.submit_jobs([TSpec(a, TConfig(pileup="pallas",
                                               outfolder=out, prefix="a"))])
    finally:
        t2.close()
    assert res[0].ok and res[0].resumed


def test_restart_over_completed_journal_skips_everything(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    path = sim(tmp_path, "s.sam", 77)
    jdir = str(tmp_path / "j")
    os.makedirs(str(tmp_path / "o"))
    cfg = TConfig(pileup="pallas", outfolder=str(tmp_path / "o") + "/")
    results = []
    for _ in range(3):
        r = runner(journal_dir=jdir)
        try:
            [res] = r.submit_jobs([JobSpec(path, cfg)])
        finally:
            r.close()
        results.append((res, r.registry.value("serve/resume_skipped")))
        if len(results) == 2:
            # drifted output re-runs instead of trusting the journal
            with open(results[0][0].output_paths[0], "a") as fh:
                fh.write("tampered\n")
    (a, _), (b, skipped), (c, _) = results
    assert a.ok and a.output_paths and not a.resumed
    assert b.ok and b.resumed and b.fastas is None and skipped == 1
    assert c.ok and not c.resumed
    # the re-run after the drift is a second commit of the key, by design
    audit = t_journal.JobJournal(jdir).audit()
    assert audit["lost"] == []


def test_journal_refuses_bam_up_front(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    r = runner(journal_dir=str(tmp_path / "j"))
    try:
        with pytest.raises(ValueError, match="BAM input"):
            r.submit_jobs([JobSpec(os.path.join(
                REPO, "tests", "data", "formats_short.bam"), TConfig())])
    finally:
        r.close()


def test_journal_write_fault_degrades_durability_only(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    path = sim(tmp_path, "w.sam", 90)
    os.makedirs(str(tmp_path / "o"))
    cfg = TConfig(pileup="pallas", outfolder=str(tmp_path / "o") + "/")
    # every append fails: the job still runs and commits its outputs
    r = runner(journal_dir=str(tmp_path / "j"),
               fault_inject="journal_write:rpc:0:inf")
    try:
        [res] = r.submit_jobs([JobSpec(path, cfg)])
    finally:
        r.close()
    assert res.ok and res.output_paths
    assert r.registry.value("serve/journal_write_failed") >= 3
    assert rendered(res) == jax_cold(path)


# -- the watchdog -------------------------------------------------------------
def test_hung_dispatch_costs_exactly_one_job(tmp_path, monkeypatch):
    """A wedged dispatch (``job_hang`` sleeping past the stall budget)
    fails ONLY its job; the next job runs on the device rung."""
    from sam2consensus_torch.serve import JobSpec

    monkeypatch.setenv("S2C_FAULT_HANG_S", "4")
    before = set(threading.enumerate())
    paths = [sim(tmp_path, f"h{i}.sam", 400 + i) for i in range(3)]
    hang = TConfig(pileup="pallas", fault_inject="job_hang:timeout:0:1")
    cfgs = [TConfig(pileup="pallas"), hang, TConfig(pileup="pallas")]
    r = runner(stall_timeout=1.5)
    try:
        res = r.submit_jobs([JobSpec(p, c) for p, c in zip(paths, cfgs)])
    finally:
        r.close()
        _join_abandoned(before)
    assert [x.ok for x in res] == [True, False, True]
    assert "HungDispatchError" in res[1].error
    assert res[1].metrics.get("serve/watchdog_timeouts") == 1
    assert r.registry.value("serve/watchdog_timeouts") == 1
    assert res[2].rungs == {}
    assert res[2].metrics.get("resilience/demotions", 0) == 0
    for k in (0, 2):
        assert rendered(res[k]) == jax_cold(paths[k])
    snap = r.health_snapshot()
    assert snap["jobs"]["watchdog_timeouts"] == 1
    assert snap["in_flight"] is None


def test_hung_job_retries_on_host_rung_under_fallback(tmp_path,
                                                      monkeypatch):
    from sam2consensus_torch.serve import JobSpec

    monkeypatch.setenv("S2C_FAULT_HANG_S", "5")
    before = set(threading.enumerate())
    paths = [sim(tmp_path, f"r{i}.sam", 410 + i) for i in range(2)]
    hang = TConfig(pileup="pallas", fault_inject="job_hang:timeout:0:1",
                   on_device_error="fallback")
    r = runner(job_timeout=2.5)
    try:
        res = r.submit_jobs([JobSpec(paths[0], hang),
                             JobSpec(paths[1], TConfig(pileup="pallas"))])
    finally:
        r.close()
        _join_abandoned(before)
    assert [x.ok for x in res] == [True, True]
    assert res[0].rungs == {"pileup": "host"}
    assert res[0].metrics.get("serve/job_retries") == 1
    assert res[0].stats.extra["pileup_path"] == "host"
    assert r.registry.value("serve/job_retries") == 1
    # the next job starts back on K1's route
    assert res[1].rungs == {}
    assert res[1].stats.extra["pileup"] == {"pallas_w128": 1} \
        or all(k.startswith("pallas_") for k in res[1].stats.extra["pileup"])
    for k in range(2):
        assert rendered(res[k]) == jax_cold(paths[k])


def test_job_timeout_env_fallback(monkeypatch):
    monkeypatch.setenv("S2C_JOB_TIMEOUT", "7.5")
    monkeypatch.setenv("S2C_STALL_TIMEOUT", "2")
    r = runner()
    try:
        assert (r.job_timeout, r.stall_timeout) == (7.5, 2.0)
    finally:
        r.close()


# -- health ---------------------------------------------------------------------
def test_health_snapshot_keys_equal_reference(tmp_path):
    from sam2consensus_torch.serve import JobSpec as TSpec
    from sam2consensus_tpu.config import RunConfig as RConfig
    from sam2consensus_tpu.serve import JobSpec as RSpec

    path = sim(tmp_path, "k.sam", 300)
    snaps = {}
    for tag in ("t", "r"):
        hpath = str(tmp_path / f"{tag}_health.json")
        kw = dict(journal_dir=str(tmp_path / f"{tag}j"), health_out=hpath,
                  slo="e2e=60s")
        out = str(tmp_path / f"{tag}o") + "/"
        os.makedirs(out)
        if tag == "t":
            srv = runner(**kw)
            spec = TSpec(path, TConfig(pileup="pallas", outfolder=out))
        else:
            srv = _ref_runner(**kw)
            spec = RSpec(path, RConfig(backend="jax", shards=1,
                                       pileup="scatter", outfolder=out))
        try:
            [res] = srv.submit_jobs([spec])
        finally:
            srv.close()
        assert res.ok
        snaps[tag] = json.load(open(hpath))
    t, r = snaps["t"], snaps["r"]
    assert t["schema"] == r["schema"] == "s2c-health/1"
    assert set(t) == set(r)
    for section in ("jobs", "admission", "journal", "sched", "slo"):
        assert set(t[section]) == set(r[section]), section
    assert t["jobs"] == r["jobs"]
    assert dict(t["journal"], root=None) == dict(r["journal"], root=None)


# -- SIGKILL mid-queue and resume -----------------------------------------------
_DRIVER = r"""
import os, sys
from sam2consensus_torch.config import RunConfig, default_prefix
from sam2consensus_torch.serve import JobSpec, ServeRunner
inputs, out, jdir, hang = sys.argv[1:4], sys.argv[4], sys.argv[5], sys.argv[6]
specs = [JobSpec(p, RunConfig(outfolder=out + "/", pileup="pallas",
                              prefix=default_prefix(p),
                              fault_inject="job_hang:timeout:0:1"
                              if hang == "1" and k == 1 else ""))
         for k, p in enumerate(inputs)]
runner = ServeRunner(journal_dir=jdir, prewarm="off", device="cpu")
try:
    results = runner.submit_jobs(specs)
finally:
    runner.close()
sys.exit(0 if all(r.ok for r in results) else 1)
"""


def _journal_state(jdir):
    """(committed jobs, started jobs) from the journal's segments."""
    if not os.path.isdir(jdir):
        return set(), set()
    evs = t_journal.JobJournal(jdir).events()
    return ({e["job"] for e in evs if e["ev"] == "committed"},
            {e["job"] for e in evs if e["ev"] == "started"})


def test_sigkill_midqueue_resume_byte_identical(tmp_path):
    """A journaled server is SIGKILLed while job 2 hangs (job 1
    committed); a restart without the fault skips job 1 by fingerprint,
    resumes job 2 and commits job 3: byte-identical to ``--backend jax``
    one-shot runs, none lost, none run twice."""
    from test_torch_serve import jax_cli_dir

    inputs = [sim(tmp_path, f"k{i}.sam", 300 + i) for i in range(3)]
    outdir, jdir = str(tmp_path / "out"), str(tmp_path / "j")
    os.makedirs(outdir)
    env = dict(os.environ, S2C_FAULT_HANG_S="3600",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cmd = [sys.executable, "-c", _DRIVER, *inputs, outdir, jdir]
    proc = subprocess.Popen(cmd + ["1"], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            committed, started = _journal_state(jdir)
            if len(committed) == 1 and len(started) == 2:
                break
            time.sleep(0.05)
        committed, started = _journal_state(jdir)
        assert proc.poll() is None, "the server ended before the window"
        assert len(committed) == 1 and len(started) == 2
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    r2 = subprocess.run(cmd + ["0"], env=env, capture_output=True,
                        text=True, timeout=120)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert read_dir(outdir) == jax_cli_dir(inputs, str(tmp_path / "cold"))
    jn = t_journal.JobJournal(jdir)
    audit = jn.audit()
    assert audit["lost"] == [] and audit["duplicated"] == []
    assert len(audit["commit_counts"]) == 3
    modes = [(e["job"], e.get("mode")) for e in jn.events()
             if e["ev"] == "resumed"]
    assert modes == [("job0:k0.sam", "skipped"),
                     ("job1:k1.sam", "inflight")]


_EXIT_DRIVER = r"""
import sys
from sam2consensus_torch.config import RunConfig
from sam2consensus_torch.serve import JobSpec, ServeRunner
runner = ServeRunner(prewarm="off", stall_timeout=0.5, device="cpu")
try:
    res = runner.submit_jobs([JobSpec(sys.argv[1], RunConfig(
        pileup="pallas", fault_inject="job_hang:timeout:0:1"))])
finally:
    runner.close()
print("failed" if not res[0].ok else "ok", flush=True)
"""


def test_exit_with_a_job_asleep_in_job_hang(tmp_path):
    """The interpreter exits cleanly (exit 0, at once) while the job the
    watchdog abandoned still sleeps in ``job_hang`` on its daemon
    thread."""
    path = sim(tmp_path, "x.sam", 500)
    env = dict(os.environ, S2C_FAULT_HANG_S="3600",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", _EXIT_DRIVER, path], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "failed"
    assert time.monotonic() - t0 < 60
