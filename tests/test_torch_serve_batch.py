"""Continuous batching in the port (``serve/scheduler.py``,
``serve/packing.py``) on the CPU, held against the JAX package.

Each case of ``tests/test_serve_batch.py`` runs on the port's
``ServeRunner(device="cpu")``, its FASTA bytes held against the JAX
package's own ``ServeRunner`` (``--backend jax``) or one-shot runs of the
same inputs (tolerance: exact): the packed-vs-serial identity matrix at
``--batch 1|4|8``, packed vs independent cold runs, a dispatch fault
demoting only its batch, a member decode failure failing alone, SIGKILL
mid-batch and journal resume, the composition policy (burning tenant,
window, pinned tenant, oversize member), unique quarantine sidecars, the
exposition family and health, the decision's residual joins, and
decode-ahead never taking a batched entry.  Beside them: merged slabs
through the plain K1 give each member its own counts, the shared
accumulator's route (the native host counts or the scatter on the CPU,
K1 on the card), the card's tails over the device counts and the port's batch and incremental benchmarks at tiny
sizes.
"""

import gc
import gzip
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sam2consensus_torch.config import RunConfig as TConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _sim(tmp, name, seed, contig_len=3000, n_reads=600, n_contigs=1,
         gz=False, **kw):
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    spec = SimSpec(n_contigs=n_contigs, contig_len=contig_len,
                   n_reads=n_reads, read_len=100, contig_len_jitter=0.0,
                   seed=seed, contig_prefix=f"bt{seed}", **kw)
    path = os.path.join(str(tmp), name)
    text = simulate(spec)
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(text.encode("ascii"))
    else:
        with open(path, "w") as fh:
            fh.write(text)
    return path


def _runner(**kw):
    from sam2consensus_torch.serve import ServeRunner

    kw.setdefault("prewarm", "off")
    kw.setdefault("device", "cpu")
    return ServeRunner(**kw)


def _jax_runner(**kw):
    from sam2consensus_tpu.serve import ServeRunner

    kw.setdefault("prewarm", "off")
    kw.setdefault("persistent_cache", False)
    return ServeRunner(**kw)


def _rendered(res):
    from sam2consensus_torch.io.fasta import render_file

    return {n: render_file(r, 0) for n, r in res.fastas.items()}


def _jax_rendered(res):
    from sam2consensus_tpu.io.fasta import render_file

    return {n: render_file(r, 0) for n, r in res.fastas.items()}


def _specs(jobs, jax=False):
    """``JobSpec``s of either package over ``(path, job_id, cfg fields)``."""
    if jax:
        from sam2consensus_tpu.config import RunConfig
        from sam2consensus_tpu.serve import JobSpec
    else:
        from sam2consensus_torch.config import RunConfig
        from sam2consensus_torch.serve import JobSpec
    base = {"backend": "jax"} if jax else {}
    return [JobSpec(filename=p, config=RunConfig(**base, **kw), job_id=jid,
                    tenant=tenant)
            for p, jid, kw, tenant in jobs]


def _run(jobs, jax=False, **kw):
    """The queue through either package's ``ServeRunner``; returns the
    results (rendered where ok) and the runner."""
    r = _jax_runner(**kw) if jax else _runner(**kw)
    try:
        results = r.submit_jobs(_specs(jobs, jax))
    finally:
        r.close()
    render = _jax_rendered if jax else _rendered
    return [render(x) if x.ok else None for x in results], results, r


def _family(tmp):
    """The small-job fixture families of the reference's matrix, one
    queue: short/deep phix-class, multi-contig target-capture class, a
    gzip container, a py2-compat job, and a pair with other thresholds
    (tail-incompatible with the rest: the per-member extraction tail)."""
    jobs = []
    for k, (name, seed, kw, cfg_kw) in enumerate([
            ("phix0.sam", 11, {}, {}),
            ("phix1.sam", 12, {"n_reads": 900}, {}),
            ("cap0.sam", 13, {"n_contigs": 6, "contig_len": 700}, {}),
            ("cap1.sam", 14, {"n_contigs": 4, "contig_len": 900}, {}),
            ("gz0.sam.gz", 15, {"gz": True}, {}),
            ("py2.sam", 16, {}, {"py2_compat": True, "maxdel": None}),
            ("thr0.sam", 17, {}, {"thresholds": [0.25, 0.5]}),
            ("thr1.sam", 18, {}, {"thresholds": [0.25, 0.5]}),
    ]):
        jobs.append((_sim(tmp, name, seed, **kw), f"fam{k}", cfg_kw, ""))
    return jobs


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """The family queue and the JAX package's packed serve of it."""
    gc.disable()
    try:
        jobs = _family(tmp_path_factory.mktemp("family"))
        want, results, _r = _run(jobs, jax=True, batch="8")
        assert all(x.ok for x in results)
        return jobs, want
    finally:
        gc.enable()


# -- policy parsing ----------------------------------------------------------
@pytest.mark.parametrize("value", ["off", None, "0", "1", "6", "auto",
                                   "many", "-3"])
def test_parse_batch_mode(value):
    from sam2consensus_torch.serve.scheduler import parse_batch_mode as t
    from sam2consensus_tpu.serve.scheduler import parse_batch_mode as r

    def outcome(fn):
        try:
            return fn(value)
        except ValueError as exc:
            return str(exc)

    assert outcome(t) == outcome(r)
    if value == "auto":
        assert t(value)[0] == "auto" and t(value)[1] >= 2


def test_serve_cli_rejects_bad_batch():
    from sam2consensus_torch import cli
    from sam2consensus_tpu import cli as r_cli

    with pytest.raises(SystemExit) as t_exit:
        cli.serve_main(["-i", "x.sam", "--batch", "bogus"], device="cpu")
    with pytest.raises(SystemExit) as r_exit:
        r_cli.serve_main(["-i", "x.sam", "--batch", "bogus"])
    assert str(t_exit.value.code) == str(r_exit.value.code)


# -- the byte-identity matrix -------------------------------------------------
@pytest.mark.parametrize("batch", ["1", "4", "8"])
def test_packed_vs_serial_byte_identity_matrix(family, batch):
    """Every fixture family through batch sizes 1/4/8 equals the port's
    serial path and the JAX package's packed serve byte for byte; packed
    jobs carry the serve_batch decision in their manifest and the
    serve/batch counters in their metrics."""
    jobs, want = family
    serial, s_res, _ = _run(jobs, batch="off")
    packed, p_res, rp = _run(jobs, batch=batch)
    assert all(x.ok for x in s_res), [x.error for x in s_res]
    assert all(x.ok for x in p_res), [x.error for x in p_res]
    assert packed == serial == want
    n_packed = rp.registry.value("batch/packed_jobs")
    if batch == "1":
        assert n_packed == 0                  # 1 == off
        return
    assert n_packed >= 2
    for res in p_res:
        if not res.metrics.get("serve/batched"):
            continue
        assert res.metrics.get("serve/batch_jobs", 0) >= 2
        assert res.metrics.get("serve/batch_wall_sec", 0) > 0
        decisions = [d for d in (res.manifest or {}).get(
            "decisions", []) if d.get("decision") == "serve_batch"]
        assert decisions, f"{res.job_id}: no serve_batch decision"
        d = decisions[0]
        assert d["measured"].get("jobs_per_sec", 0) > 0
        assert "occupancy" in d["inputs"]


def test_packed_matches_independent_cold_runs(family):
    """Packed outputs equal fresh cold ``--backend jax`` runs (not just
    the warm serial path)."""
    from test_torch_serve import jax_cold

    jobs = family[0][:4]
    packed, results, _ = _run(jobs, batch="4")
    assert all(x.ok for x in results)
    for (path, _jid, kw, _t), got in zip(jobs, packed):
        assert got == jax_cold(path, TConfig(**kw))


# -- resilience ---------------------------------------------------------------
def test_fault_in_packed_dispatch_demotes_batch_only(tmp_path):
    """A fault injected inside the packed dispatch discards the shared
    tensor and re-runs every member through the serial path: outputs
    equal the JAX package's serve of the same queue, demotion counted."""
    paths = [_sim(tmp_path, f"f{i}.sam", 40 + i) for i in range(4)]
    # the scheduler configures the packed dispatch's injector from the
    # FIRST member's spec; one counted rpc fault fires in the dispatch
    jobs = [(p, f"f{k}", {"fault_inject": "pileup_dispatch:rpc:0:1"}
             if k == 0 else {}, "") for k, p in enumerate(paths)]
    want, w_res, _ = _run(jobs, jax=True, batch="4")
    got, g_res, rp = _run(jobs, batch="4")
    assert rp.registry.value("batch/demotions") == 1
    assert rp.registry.value("batch/packed_jobs") == 0
    assert all(r.ok for r in g_res), [r.error for r in g_res]
    assert all(r.ok for r in w_res)
    assert got == want


def _poison(src, dst):
    """``src`` with its first record's position far out of bounds."""
    with open(src) as fh:
        lines = fh.read().splitlines()
    body = [ln for ln in lines if not ln.startswith("@")]
    hdr = [ln for ln in lines if ln.startswith("@")]
    f = body[0].split("\t")
    f[3] = "999999"
    return hdr, "\t".join(f), body


def test_member_decode_failure_fails_alone(tmp_path):
    """A poison member (strict decode error) fails alone, with the JAX
    package's error type; co-members stay packed, their bytes the JAX
    package's."""
    paths = [_sim(tmp_path, f"p{i}.sam", 50 + i) for i in range(3)]
    bad = os.path.join(str(tmp_path), "bad.sam")
    hdr, rec, body = _poison(paths[1], bad)
    with open(bad, "w") as fh:
        fh.write("\n".join(hdr + [rec] + body[1:]) + "\n")
    jobs = [(paths[0], "ok0", {}, ""), (bad, "poison", {}, ""),
            (paths[2], "ok1", {}, "")]
    want, w_res, _ = _run(jobs, jax=True, batch="3")
    got, g_res, rp = _run(jobs, batch="3")
    assert [r.ok for r in g_res] == [True, False, True]
    assert g_res[1].error.split(":")[0] == w_res[1].error.split(":")[0]
    assert "IndexError" in g_res[1].error
    assert got[0] == want[0] and got[2] == want[2]
    assert rp.registry.value("batch/packed_jobs") == 2


# -- SIGKILL mid-batch under a journal ----------------------------------------
_BATCH_SERVER = r"""
import sys
from sam2consensus_torch.config import RunConfig, default_prefix
from sam2consensus_torch.serve import JobSpec, ServeRunner
from sam2consensus_torch.serve import scheduler
inputs, out, jdir, hang = sys.argv[1:7], sys.argv[7], sys.argv[8], sys.argv[9]
if hang == "1":
    # the second batch's shared dispatch never returns: the kill lands
    # with batch 1 committed and batch 2 journaled as started
    orig = scheduler.BatchScheduler._dispatch_wave

    def wave(self, *args, **kwargs):
        if self.batches_run >= 1:
            import time
            time.sleep(3600)
        return orig(self, *args, **kwargs)

    scheduler.BatchScheduler._dispatch_wave = wave
specs = [JobSpec(p, RunConfig(outfolder=out + "/", prefix=default_prefix(p)))
         for p in inputs]
runner = ServeRunner(journal_dir=jdir, prewarm="off", batch="3",
                     device="cpu")
try:
    results = runner.submit_jobs(specs)
finally:
    runner.close()
sys.exit(0 if all(r.ok for r in results) else 1)
"""


def test_sigkill_mid_batch_journal_resume(tmp_path):
    """SIGKILL a journaled batched queue with its first batch committed
    and its second in flight; the restarted server replays ONLY the
    uncommitted members — zero lost, zero duplicated — and the outputs
    equal ``--backend jax`` one-shot runs."""
    from sam2consensus_torch.serve import journal as t_journal
    from test_torch_serve import jax_cli_dir

    inputs = [_sim(tmp_path, f"k{i}.sam", 300 + i) for i in range(6)]
    outdir, jdir = str(tmp_path / "out"), str(tmp_path / "j")
    os.makedirs(outdir)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-c", _BATCH_SERVER, *inputs, outdir, jdir]

    def state():
        if not os.path.isdir(jdir):
            return set(), set()
        evs = t_journal.JobJournal(jdir).events()
        return ({e["job"] for e in evs if e["ev"] == "committed"},
                {e["job"] for e in evs if e["ev"] == "started"})

    proc = subprocess.Popen(cmd + ["1"], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            committed, started = state()
            if len(committed) == 3 and len(started) == 6:
                break
            time.sleep(0.05)
        committed, started = state()
        assert proc.poll() is None, "the server ended before the window"
        assert len(committed) == 3 and len(started) == 6
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    r2 = subprocess.run(cmd + ["0"], env=env, capture_output=True,
                        text=True, timeout=120)
    assert r2.returncode == 0, r2.stderr[-2000:]
    files = {f: open(os.path.join(outdir, f), "rb").read()
             for f in sorted(os.listdir(outdir))}
    assert files == jax_cli_dir(inputs, str(tmp_path / "cold"))
    jn = t_journal.JobJournal(jdir)
    audit = jn.audit()
    assert audit["duplicated"] == []        # committed members NOT rerun
    assert audit["lost"] == []
    assert len(audit["commit_counts"]) == 6
    packed = [e for e in jn.events() if e["ev"] == "started"
              and e.get("packed")]
    assert len(packed) == 9                 # 3 + 3 killed + 3 replayed


# -- composition policy -------------------------------------------------------
def _plan_entry(i, tenant="", total_len=3000, nbytes=10_000, jax=False):
    if jax:
        from sam2consensus_tpu.config import RunConfig
        from sam2consensus_tpu.serve import JobSpec
    else:
        from sam2consensus_torch.config import RunConfig
        from sam2consensus_torch.serve import JobSpec
    spec = JobSpec(filename=f"/nonexistent/j{i}.sam",
                   config=RunConfig(backend="jax") if jax else RunConfig(),
                   job_id=f"c{i}", tenant=tenant)
    return {"spec": spec, "job_id": spec.job_id, "key": None,
            "jobnum": i, "action": "run", "cfg": spec.config,
            "admission": None, "resume_ckpt": False,
            "batch_total_len": total_len, "batch_bytes": nbytes}


def _compose(entries, setup=None, arrivals=None, **kw):
    """Both packages' compose over the same plan: ``[(indices,
    flush_reason), ...]`` each."""
    out = []
    for jax in (False, True):
        r = _jax_runner(**kw) if jax else _runner(**kw)
        try:
            if setup is not None:
                setup(r)
            plan = [_plan_entry(*a, jax=jax, **k) for a, k in entries]
            out.append([(b.indices, b.flush_reason)
                        for b in r.scheduler.compose(plan,
                                                     arrivals=arrivals)])
        finally:
            r.close()
    assert out[0] == out[1]
    return out[0]


def test_burning_tenant_flushes_without_window():
    """A tenant with SLO burn gets LATENCY: its job flushes the filling
    batch at once (flush_reason slo_burn)."""
    def burn(r):
        r.admission.slo_burn_by_tenant["hot"] = 2

    got = _compose([((0,), {}), ((1,), {}), ((2,), {"tenant": "hot"}),
                    ((3,), {}), ((4,), {})], setup=burn,
                   arrivals=[0.0] * 5, batch="8", batch_window=10_000.0)
    assert got == [([0, 1, 2], "slo_burn"), ([3, 4], "drained")]


def test_window_bounds_batch_composition():
    """An arrival outside --batch-window starts the next batch."""
    got = _compose([((i,), {}) for i in range(4)],
                   arrivals=[0.0, 0.010, 0.200, 0.205], batch="8",
                   batch_window=50.0)
    assert got == [([0, 1], "window"), ([2, 3], "drained")]


def test_pinned_tenant_not_batchable():
    def pin(r):
        r.admission.tenant_rungs["deg"] = "host"

    got = _compose([((0,), {}), ((1,), {"tenant": "deg"}), ((2,), {})],
                   setup=pin, batch="8")
    assert got == [([0, 2], "drained")]


def test_oversize_member_not_batchable():
    got = _compose([((0,), {}), ((1,), {"total_len": 1 << 30}),
                    ((2,), {})], batch="8")
    assert got == [([0, 2], "drained")]


# -- sidecar naming under packed execution ------------------------------------
def test_default_quarantine_sidecars_unique_per_packed_job(tmp_path):
    """Two packed jobs over the SAME upload in quarantine mode get
    distinct default sidecars (``.job<N>``), with the JAX package's
    names and bytes."""
    good = _sim(tmp_path, "q.sam", 60)
    bad = os.path.join(str(tmp_path), "qbad.sam")
    hdr, rec, body = _poison(good, bad)
    with open(bad, "w") as fh:
        fh.write("\n".join(hdr + [rec] + body) + "\n")
    dirs = []
    for jax in (False, True):
        out = str(tmp_path / ("jax" if jax else "port"))
        os.makedirs(out)
        kw = dict(on_bad_record="quarantine", outfolder=out + "/",
                  prefix="same")
        rendered, results, _ = _run([(bad, "qa", kw, ""),
                                     (bad, "qb", kw, "")], jax=jax,
                                    batch="2")
        assert all(res.ok for res in results), [r.error for r in results]
        assert all(res.quarantined == 1 for res in results)
        dirs.append((rendered, sorted(f for f in os.listdir(out)
                                      if "quarantine" in f)))
    assert dirs[0] == dirs[1]
    assert dirs[0][1] == ["same_quarantine.job0.jsonl",
                          "same_quarantine.job1.jsonl"]


# -- observability surfaces ---------------------------------------------------
def test_batch_exposition_family_and_health(tmp_path):
    """The s2c_batch_* family renders lint-clean, the health snapshot
    carries the batch section (keys as the JAX package's) and
    tools/s2c_top.py renders the batching line."""
    import importlib.util

    from sam2consensus_torch.observability.telemetry import (
        lint_openmetrics, parse_openmetrics)

    paths = [_sim(tmp_path, f"e{i}.sam", 70 + i) for i in range(4)]
    jobs = [(p, f"e{k}", {}, "") for k, p in enumerate(paths)]
    want, _w, rj = _run(jobs, jax=True, batch="4")
    got, results, r = _run(jobs, batch="4")
    assert all(res.ok for res in results) and got == want
    text = r.render_telemetry()
    assert lint_openmetrics(text) == []
    samples = parse_openmetrics(text)
    names = {s["name"] for s in samples}
    assert {"s2c_batch_size", "s2c_batch_occupancy_pct",
            "s2c_batch_jobs_per_sec", "s2c_batch_batches_total",
            "s2c_batch_packed_jobs_total"} <= names
    snap = r.health_snapshot()
    assert set(snap["batch"]) == set(rj.health_snapshot()["batch"])
    assert snap["batch"]["batches"] == 1
    assert snap["batch"]["packed_jobs"] == 4
    assert snap["batch"]["last_size"] == 4
    assert 0 < snap["batch"]["last_occupancy_pct"] <= 100
    spec = importlib.util.spec_from_file_location(
        "s2c_top", os.path.join(REPO, "tools", "s2c_top.py"))
    top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(top)
    assert any("batching:" in ln for ln in top.render(snap, samples))


def test_batch_decision_residual_joins(tmp_path):
    """The serve_batch ledger decision joins its measured counters: a
    second (warm) batch's residual uses the rate calibrated on the
    first."""
    paths = [_sim(tmp_path, f"d{i}.sam", 80 + i) for i in range(4)]
    jobs = [(p, f"d{k}", {}, "") for k, p in enumerate(paths)]
    r = _runner(batch="4")
    try:
        r.submit_jobs(_specs(jobs))             # calibration batch
        results = r.submit_jobs(_specs(jobs))
    finally:
        r.close()
    d = [x for x in (results[0].manifest or {}).get("decisions", [])
         if x["decision"] == "serve_batch"][0]
    assert d["measured"]["sec"] > 0
    assert d["residual"]["sec"] > 0
    assert d["residual"]["jobs_per_sec"] > 0


def test_decode_ahead_skips_batched_entries(tmp_path, monkeypatch):
    """A mixed queue (batched smalls + an ineligible host-pinned job)
    equals the JAX package's serve of it; decode-ahead never takes a
    batched entry, and the serial job after the batch starts its
    decode-ahead no earlier than the batch's first shared dispatch."""
    import sam2consensus_torch.serve.runner as srunner
    from sam2consensus_torch.serve import scheduler

    paths = [_sim(tmp_path, f"m{i}.sam", 90 + i) for i in range(3)]
    big = _sim(tmp_path, "host.sam", 99)
    tail = _sim(tmp_path, "tail.sam", 98)
    jobs = [(big, "mhost", {"pileup": "host"}, ""),   # ineligible pin
            (paths[0], "m0", {}, ""), (paths[1], "m1", {}, ""),
            (paths[2], "m2", {}, ""),
            (tail, "mtail", {"pileup": "pallas"}, "")]
    aheads, waves = [], []
    orig_init = srunner._DecodeAhead.__init__
    orig_wave = scheduler.BatchScheduler._dispatch_wave

    def init(self, backend, spec, *args, **kwargs):
        orig_init(self, backend, spec, *args, **kwargs)
        aheads.append((spec.job_id, self))

    def wave(self, *args, **kwargs):
        waves.append(time.perf_counter())
        return orig_wave(self, *args, **kwargs)

    monkeypatch.setattr(srunner._DecodeAhead, "__init__", init)
    monkeypatch.setattr(scheduler.BatchScheduler, "_dispatch_wave", wave)
    want, _w, _ = _run(jobs, jax=True, batch="8")
    got, results, rp = _run(jobs, batch="8")
    assert all(r.ok for r in results), [r.error for r in results]
    assert got == want
    assert rp.registry.value("batch/packed_jobs") == 3
    # the host job decodes ahead the next SERIAL job, past the batch,
    # and that decode waits for the batch's first shared dispatch
    assert [jid for jid, _a in aheads] == ["mtail"]
    assert aheads[0][1].intervals()[0][0] >= waves[0]


# -- the packing layer and the shared accumulator -----------------------------
def test_merged_slabs_through_plain_k1_extract_each_member():
    """Members of different lengths (with all-PAD rows and pad tails)
    merged into shared slabs and counted by K1's plain version
    (``scatter_segments_packed`` over nibble-packed rows): each member's
    extracted partition equals its own accumulation, exactly."""
    from sam2consensus_torch.constants import PAD_CODE
    from sam2consensus_torch.encoder.events import SegmentBatch
    from sam2consensus_torch.ops.pileup import (pack_nibbles,
                                                scatter_segments_packed)
    from sam2consensus_torch.serve import packing

    rng = np.random.default_rng(7)

    def member(total_len, n_rows, width):
        starts = rng.integers(0, total_len - width, n_rows).astype(np.int32)
        codes = rng.integers(0, 6, (n_rows, width)).astype(np.uint8)
        codes[rng.random((n_rows, width)) < 0.3] = PAD_CODE
        codes[::5] = PAD_CODE                    # all-PAD rows
        n_pad = packing._pad_rows(n_rows)
        st = np.zeros(n_pad, np.int32)
        st[:n_rows] = starts
        mat = np.full((n_pad, width), PAD_CODE, np.uint8)
        mat[:n_rows] = codes
        nev = int((codes != PAD_CODE).sum())
        return SegmentBatch(buckets={width: (st, mat)}, n_events=nev)

    def count(total_len, batches):
        counts = torch.zeros((total_len + 1, 6), dtype=torch.int32)
        for b in batches:
            for _w, (st, mat) in b.buckets.items():
                scatter_segments_packed(
                    counts, torch.from_numpy(st),
                    torch.from_numpy(pack_nibbles(mat)))
        return counts[:total_len].numpy()

    specs = [("a", 400, [(37, 32), (9, 64)]), ("b", 1500, [(200, 32)]),
             ("c", 90, [(3, 16), (12, 32)]), ("d", 2600, [(64, 64)])]
    plan = packing.plan_pack([(j, n) for j, n, _b in specs])
    pairs, own = [], []
    for (_jid, n, rows), pm in zip(specs, plan.members):
        batches = [member(n, r, w) for r, w in rows]
        own.append(count(n, batches))
        pairs.append((pm, batches))
    # two waves, as the scheduler merges them
    merged = packing.merge_batches(plan, pairs[:2]) + \
        packing.merge_batches(plan, pairs[2:], max_cells=1 << 10)
    combined = count(plan.total_len, merged)
    assert plan.merged_slabs == len(merged) > 2
    assert 0 < plan.occupancy <= 1
    for pm, want in zip(plan.members, own):
        got = packing.extract_member(combined, pm)
        assert got.shape == want.shape and np.array_equal(got, want)
        assert pm.n_events == int(want.sum())


def test_shared_accumulator_route(monkeypatch):
    """The shared accumulator: the native host counts on the CPU where
    the library loads, else the scatter; on a CUDA device K1's
    ``PileupAccumulator(total_len, device, "pallas", "packed5")``."""
    from sam2consensus_torch import native
    from sam2consensus_torch import observability as obs
    from sam2consensus_torch.ops import pileup

    made = []

    class Recorder:
        def __init__(self, *args):
            made.append(args)

    r = _runner(batch="4")
    try:
        robs = obs.prepare_run()
        sched = r.scheduler
        if native.load() is not None:
            acc, strategy = sched._shared_accumulator(100, robs)
            assert strategy == "host"
            assert isinstance(acc, pileup.HostPileupAccumulator)
        monkeypatch.setattr(native, "load", lambda: None)
        acc, strategy = sched._shared_accumulator(100, robs)
        assert strategy == "scatter" and acc.strategy == "scatter"
        monkeypatch.setattr(pileup, "PileupAccumulator", Recorder)
        monkeypatch.setattr(r.backend, "device", torch.device("cuda"))
        _acc, strategy = sched._shared_accumulator(100, robs)
        assert strategy == "pallas"
        assert made == [(100, torch.device("cuda"), "pallas", "packed5")]
        info = robs.registry.snapshot()["gauges"]["dispatch/pileup"]["info"]
        assert info["strategy"] == "pallas"
    finally:
        r.close()


@pytest.mark.parametrize("shared_tail", ["1", "0"])
def test_device_counts_feed_the_tails(family, monkeypatch, shared_tail):
    """The card's branch of a packed batch, forced on the CPU with K1's
    plain version as the shared accumulator: the counts are never
    fetched; the shared tail runs over the shared accumulator itself
    (``tail_placement`` device, as a serial K1 job's), and with the
    shared tail off each member's extraction tail reads its slice of the
    count tensor.  Each job's bytes are the JAX package's."""
    from sam2consensus_torch.ops import pileup
    from sam2consensus_torch.serve import scheduler

    seen = {"fetches": 0, "placements": [], "parts": []}
    cls = scheduler.BatchScheduler
    orig_tail, orig_member = cls._shared_tail, cls._tail_member

    def shared_accumulator(self, total_len, batch_robs):
        self._link_free = False
        return pileup.PileupAccumulator(total_len, torch.device("cpu"),
                                        "pallas", "packed5"), "pallas"

    def placed_tail(self, *args, **kwargs):
        out = orig_tail(self, *args, **kwargs)
        seen["placements"].append(out["placement"])
        return out

    def tail_member(self, m, part, *args, **kwargs):
        seen["parts"].append(type(part))
        return orig_member(self, m, part, *args, **kwargs)

    def counts_host(self):
        seen["fetches"] += 1
        return self.counts.cpu().numpy()

    monkeypatch.setenv("S2C_BATCH_SHARED_TAIL", shared_tail)
    monkeypatch.setattr(cls, "_shared_accumulator", shared_accumulator)
    monkeypatch.setattr(cls, "_shared_tail", placed_tail)
    monkeypatch.setattr(cls, "_tail_member", tail_member)
    monkeypatch.setattr(pileup.PileupAccumulator, "counts_host",
                        counts_host)
    jobs, want = family
    got, results, r = _run(jobs[:6], batch="8")
    assert all(x.ok for x in results), [x.error for x in results]
    assert got == want[:6]
    assert r.registry.value("batch/packed_jobs") == 6
    assert seen["fetches"] == 0
    if shared_tail == "1":
        assert seen["placements"] == ["device"] and not seen["parts"]
    else:
        assert not seen["placements"]
        assert seen["parts"] == [torch.Tensor] * 6


def test_scatter_rung_packed_equals_serial(tmp_path, monkeypatch):
    """Without the native library the packed batch counts with the
    scatter: the bytes still equal the port's serial path."""
    from sam2consensus_torch.serve import scheduler

    paths = [_sim(tmp_path, f"s{i}.sam", 110 + i, n_reads=300)
             for i in range(3)]
    jobs = [(p, f"s{k}", {}, "") for k, p in enumerate(paths)]
    serial, _s, _ = _run(jobs, batch="off")
    monkeypatch.setattr(scheduler.BatchScheduler, "_accum_host_rung",
                        lambda self: False)
    packed, results, r = _run(jobs, batch="3")
    assert all(x.ok for x in results) and packed == serial
    info = r.registry.snapshot()["gauges"]["serve/batch"]["info"]
    assert info["strategy"] == "scatter"


def test_port_benchmarks_at_tiny_size():
    """``run_serve_batch_bench`` and ``run_incremental_bench`` run on
    the CPU at tiny sizes and find their sides byte-identical."""
    from sam2consensus_torch.serve import benchmark

    b = benchmark.run_serve_batch_bench(n_jobs=3, n_reads=48,
                                        contig_len=600, passes=1,
                                        device="cpu")["summary"]
    assert b["identical"] is True and b["batch"]["jobs"] == 3
    assert b["warm_packed_jobs_per_sec"] > 0
    i = benchmark.run_incremental_bench(n_reads=300, contig_len=900,
                                        passes=1, device="cpu")["summary"]
    assert i["identical"] is True and i["cache"]["hits"] >= 1
    assert i["incr_cost_ratio"] > 0
