"""The port's per-reference count cache (``serve/countcache.py``) and serve
``--incremental`` jobs on the CPU, held against the JAX package.

Each case of ``tests/test_countcache.py`` runs on the port's
``ServeRunner(device="cpu")``; every incremental job's FASTA bytes are
held against the JAX package's ``ServeRunner`` on the same queue and
config (``--backend jax``; tolerance: exact): cold absorb, warm delta
and duplicate re-submit equal to a cold run over the concatenated input,
LRU eviction and re-ingest, a failed incremental job invalidating its
entry, the up-front rejections, and incremental jobs never packed.  The
seed reaches the device accumulator's route too (``--pileup pallas``:
K1's plain version on the CPU), and a host-rung retry runs on the same
warm base.
"""

import gc
import os

import numpy as np
import pytest

from sam2consensus_torch.serve import countcache


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


# -- units -------------------------------------------------------------------
def test_parse_budget_grammar():
    from sam2consensus_tpu.serve import countcache as r_cc

    pb = countcache.parse_budget
    assert pb(None) == 0
    assert pb("off") == 0
    assert pb("0") == 0
    assert pb("1048576") == 1 << 20
    assert pb("512M") == 512 << 20
    assert pb("2g") == 2 << 30
    assert pb("1.5K") == 1536
    for bad in ("lots", "12Q", "-5", "3 M"):
        with pytest.raises(ValueError) as t_exc:
            pb(bad)
        with pytest.raises(ValueError) as r_exc:
            r_cc.parse_budget(bad)
        assert str(t_exc.value) == str(r_exc.value)


def _state(nbytes, tag="s"):
    from sam2consensus_torch.encoder.events import InsertionEvents
    from sam2consensus_torch.utils.checkpoint import CheckpointState

    counts = np.zeros((max(1, nbytes // 24), 6), np.int32)
    return CheckpointState(counts=counts, lines_consumed=0,
                           reads_mapped=0, reads_skipped=0,
                           aligned_bases=0, insertions=InsertionEvents(),
                           source="", sources=[tag])


def test_lru_eviction_under_budget():
    cache = countcache.CountCache(10_000)
    cache.put("a", _state(4_000, "a"))
    cache.put("b", _state(4_000, "b"))
    assert cache.stats()["entries"] == 2
    assert cache.get("a") is not None        # touch: b becomes LRU
    cache.put("c", _state(4_000, "c"))       # evicts b
    assert cache.get("b") is None
    assert cache.get("a") is not None
    assert cache.get("c") is not None
    s = cache.stats()
    assert s["evictions"] == 1 and s["entries"] == 2
    # an entry larger than the whole budget is refused, nothing evicted
    cache.put("huge", _state(50_000, "huge"))
    assert cache.get("huge") is None
    assert cache.stats()["entries"] == 2
    # invalidation drops whole
    assert cache.invalidate("a") is True
    assert cache.invalidate("a") is False
    assert cache.stats()["invalidated"] == 1


def test_reference_key_sensitivity():
    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.io.sam import Contig
    from sam2consensus_tpu.config import RunConfig as RConfig
    from sam2consensus_tpu.io.sam import Contig as RContig
    from sam2consensus_tpu.serve import countcache as r_cc

    ref = [Contig("c1", 100), Contig("c2", 200)]
    cfg = RunConfig()
    k0 = countcache.reference_key(ref, cfg, "")
    assert k0 == r_cc.reference_key([RContig("c1", 100),
                                     RContig("c2", 200)],
                                    RConfig(backend="jax"), "")
    # vote/render knobs do NOT key (counts are pre-vote state)
    assert countcache.reference_key(
        ref, RunConfig(thresholds=[0.5], fill="N", min_depth=9), "") == k0
    # layout, tenant, and count-relevant encode knobs DO
    assert countcache.reference_key(
        [Contig("c1", 100), Contig("c2", 201)], cfg, "") != k0
    assert countcache.reference_key(ref, cfg, "tenant_a") != k0
    assert countcache.reference_key(ref, RunConfig(maxdel=3), "") != k0


# -- serve integration --------------------------------------------------------
@pytest.fixture(scope="module")
def shard_files(tmp_path_factory):
    """Two read shards over ONE reference layout + their concatenation,
    plus a second reference's input (for eviction pressure)."""
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    tmp = tmp_path_factory.mktemp("incr")
    kw = dict(n_contigs=2, contig_len=1500, read_len=60,
              contig_len_jitter=0.0, ins_read_rate=0.2,
              del_read_rate=0.2, contig_prefix="ref")
    ta = simulate(SimSpec(n_reads=2400, seed=11, **kw))
    tb = simulate(SimSpec(n_reads=240, seed=99, **kw))
    tr2 = simulate(SimSpec(n_contigs=1, contig_len=900, n_reads=800,
                           read_len=60, contig_len_jitter=0.0, seed=5,
                           contig_prefix="other"))
    paths = {}
    for name, text in (("a", ta), ("b", tb), ("r2", tr2)):
        p = tmp / f"{name}.sam"
        p.write_text(text)
        paths[name] = str(p)
    la, lb = ta.splitlines(True), tb.splitlines(True)
    hdr = [ln for ln in la if ln.startswith("@")]
    body = [ln for ln in la if not ln.startswith("@")] \
        + [ln for ln in lb if not ln.startswith("@")]
    p = tmp / "combined.sam"
    p.write_text("".join(hdr + body))
    paths["combined"] = str(p)
    return paths


def _queue(jobs, jax=False, runner_kw=None, keep=False):
    """``jobs`` (``(path, incremental, job_id, cfg fields)``) through
    either package's ``ServeRunner`` on the CPU; returns the rendered
    outputs (None for a failed job), the results and the runner (closed
    unless ``keep``)."""
    if jax:
        from sam2consensus_tpu.config import RunConfig
        from sam2consensus_tpu.io.fasta import render_file
        from sam2consensus_tpu.serve import JobSpec, ServeRunner

        base = dict(backend="jax")
        kw = dict(persistent_cache=False)
    else:
        from sam2consensus_torch.config import RunConfig
        from sam2consensus_torch.io.fasta import render_file
        from sam2consensus_torch.serve import JobSpec, ServeRunner

        base = {}
        kw = dict(device="cpu")
    kw.update(runner_kw or {})
    r = ServeRunner(prewarm="off", **kw)
    try:
        results = r.submit_jobs([
            JobSpec(filename=p, job_id=jid, config=RunConfig(
                prefix="t", thresholds=[0.25, 0.5], incremental=inc,
                **base, **cfg))
            for p, inc, jid, cfg in jobs])
    finally:
        if not keep:
            r.close()
    rendered = [{n: render_file(v, 0) for n, v in x.fastas.items()}
                if x.ok else None for x in results]
    return rendered, results, r


def test_serve_incremental_warm_equals_cold(shard_files):
    """The acceptance matrix in one queue: cold absorb (miss), warm
    delta shard (hit, == cold-combined), duplicate re-submit (no-op,
    == cold-combined), every output the JAX package's; counters,
    decision, health, exposition and the s2c_top line carry the cache
    story."""
    import importlib.util

    from sam2consensus_torch.observability.telemetry import (
        lint_openmetrics, parse_openmetrics)

    jobs = [(shard_files["a"], True, "A", {}),
            (shard_files["b"], True, "B", {}),
            (shard_files["b"], True, "Bdup", {}),
            (shard_files["combined"], False, "COLD", {})]
    want, _w, rj = _queue(jobs, jax=True, runner_kw={"count_cache": "64M"})
    got, res, r = _queue(jobs, runner_kw={"count_cache": "64M"}, keep=True)
    try:
        assert all(x.ok for x in res), [x.error for x in res]
        assert got == want
        assert got[1] == got[3] and got[2] == got[3]
        assert res[0].metrics.get("cache/misses") == 1
        assert res[1].metrics.get("cache/hits") == 1
        assert res[2].metrics.get("cache/hits") == 1
        assert res[2].stats.extra.get("incremental_duplicate") \
            == os.path.abspath(shard_files["b"])
        assert res[1].stats.extra["count_seed_sec"] >= 0
        assert res[1].stats.extra["count_capture_sec"] >= 0
        recs = {d["decision"]: d for d in res[1].manifest["decisions"]}
        assert recs["count_cache"]["chosen"] == "warm"
        assert recs["count_cache"]["inputs"]["entries"] == 1
        snap = r.health_snapshot()
        assert snap["count_cache"] == rj.health_snapshot()["count_cache"]
        assert snap["count_cache"]["hits"] == 2
        assert snap["count_cache"]["entries"] == 1
        text = r.render_telemetry()
        assert lint_openmetrics(text) == []
        samples = parse_openmetrics(text)
        by_name = {s["name"]: s["value"] for s in samples}
        assert by_name["s2c_cache_hits_total"] == 2
        assert by_name["s2c_cache_entries"] == 1
        spec = importlib.util.spec_from_file_location(
            "s2c_top", os.path.join(os.path.dirname(__file__), "..",
                                    "tools", "s2c_top.py"))
        top = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(top)
        frame = "\n".join(top.render(snap, samples))
        assert "count cache: 1 entry" in frame
        assert "2 hits" in frame
    finally:
        r.close()


def test_eviction_under_pressure_reingest_identity(shard_files):
    """Budget fits ONE entry: alternating references evict each other,
    and a re-ingested (evicted) reference's cold re-absorb equals its
    original cached run and the JAX package's."""
    jobs = [(shard_files["a"], True, "r1_first", {}),
            (shard_files["r2"], True, "r2", {}),
            (shard_files["a"], True, "r1_again", {})]
    want, _w, _rj = _queue(jobs, jax=True, runner_kw={"count_cache": "80K"})
    got, res, r = _queue(jobs, runner_kw={"count_cache": "80K"})
    assert all(x.ok for x in res), [x.error for x in res]
    assert got == want
    s = r.count_cache.stats()
    assert s["evictions"] >= 1, s
    assert res[2].metrics.get("cache/misses") == 1
    assert got[2] == got[0]


def test_failed_incremental_invalidates_entry(shard_files, tmp_path):
    """The count-bank rule's failure edge: a poison delta shard fails
    its job AND drops the reference's warm entry whole; the next
    submission re-absorbs from scratch, as the JAX package's does."""
    bad = tmp_path / "bad.sam"
    hdr = "".join(ln for ln in open(shard_files["a"])
                  if ln.startswith("@"))
    bad.write_text(hdr + "r1\t0\tref0000\t5\t60\t10M\t*\t0\t0\t"
                   "ACGTACGTAZ\t*\n")
    jobs = [(shard_files["a"], True, "A", {}), (str(bad), True, "BAD", {})]
    _want, w_res, _rj = _queue(jobs, jax=True,
                               runner_kw={"count_cache": "64M"})
    got, res, r = _queue(jobs, runner_kw={"count_cache": "64M"}, keep=True)
    try:
        assert res[0].ok and not res[1].ok and not w_res[1].ok
        assert res[1].error.split(":")[0] == w_res[1].error.split(":")[0]
        s = r.count_cache.stats()
        assert s["entries"] == 0
        assert s["invalidated"] == 1
        from sam2consensus_torch.config import RunConfig
        from sam2consensus_torch.serve import JobSpec

        res2 = r.submit_jobs([JobSpec(
            filename=shard_files["a"], job_id="A2", config=RunConfig(
                prefix="t", thresholds=[0.25, 0.5], incremental=True))])
    finally:
        r.close()
    assert res2[0].ok
    assert res2[0].metrics.get("cache/misses") == 1
    from sam2consensus_torch.io.fasta import render_file

    assert {n: render_file(v, 0) for n, v in res2[0].fastas.items()} \
        == got[0]


def test_serve_validate_rejections(shard_files, tmp_path):
    from sam2consensus_torch import cli
    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.serve import JobSpec, ServeRunner

    job = JobSpec(filename=shard_files["a"],
                  config=RunConfig(incremental=True))
    # incremental without the cache: rejected with a pointer
    r = ServeRunner(prewarm="off", device="cpu")
    try:
        with pytest.raises(ValueError, match="count-cache"):
            r.submit_jobs([job])
    finally:
        r.close()
    # incremental + journal: two sources of resumable state
    r = ServeRunner(prewarm="off", device="cpu", count_cache="8M",
                    journal_dir=str(tmp_path / "j"))
    try:
        with pytest.raises(ValueError, match="journal"):
            r.submit_jobs([job])
    finally:
        r.close()
    # a typo'd budget fails the server start
    with pytest.raises(ValueError, match="count-cache"):
        ServeRunner(prewarm="off", device="cpu", count_cache="lots")
    # the CLI's up-front checks, as the reference's
    from sam2consensus_tpu import cli as r_cli

    for argv in (["--incremental"],
                 ["--incremental", "--count-cache", "8M", "--journal",
                  str(tmp_path / "j2")],
                 ["--count-cache", "lots"]):
        base = ["-i", shard_files["a"], "--quiet", *argv]
        with pytest.raises(SystemExit) as t_exit:
            cli.serve_main(base, device="cpu")
        with pytest.raises(SystemExit) as r_exit:
            r_cli.serve_main(base)
        assert str(t_exit.value.code) == str(r_exit.value.code)


def test_incremental_jobs_never_pack(shard_files):
    """Continuous batching must not pack an incremental job — its
    accumulator seeds from warm state no shared tensor holds."""
    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.serve import JobSpec, ServeRunner

    r = ServeRunner(prewarm="off", device="cpu", count_cache="64M",
                    batch="4")
    try:
        inc = RunConfig(incremental=True)
        entry = {"action": "run", "cfg": inc,
                 "spec": JobSpec(filename=shard_files["a"], config=inc)}
        assert not r.scheduler.eligible(entry)
        plain = RunConfig()
        entry2 = {"action": "run", "cfg": plain,
                  "spec": JobSpec(filename=shard_files["a"], config=plain)}
        assert r.scheduler.eligible(entry2)
    finally:
        r.close()


# -- the seed on the device accumulator, the host-rung retry ------------------
def test_seed_through_device_accumulator(shard_files):
    """Under ``--pileup pallas`` the warm counts are uploaded into the
    device accumulator (K1's plain version on the CPU) and the delta is
    counted on top: the JAX package's bytes."""
    jobs = [(shard_files["a"], True, "A", {"pileup": "pallas"}),
            (shard_files["b"], True, "B", {"pileup": "pallas"}),
            (shard_files["combined"], False, "COLD", {"pileup": "pallas"})]
    want, _w, _rj = _queue(jobs, jax=True, runner_kw={"count_cache": "64M"})
    got, res, _r = _queue(jobs, runner_kw={"count_cache": "64M"})
    assert all(x.ok for x in res), [x.error for x in res]
    assert got == want and got[1] == got[2]
    assert res[1].stats.extra["incremental_base"] == \
        [os.path.abspath(shard_files["a"])]


def test_abandoned_attempt_never_writes_the_next_jobs_state(
        shard_files, monkeypatch):
    """An incremental job the watchdog abandoned (B) finishes its run
    only after the next incremental job on the same reference (C) was
    seeded and started: B writes its own capture box, never C's.  C
    absorbs ``a`` cold (B's failure dropped the entry), so the cached
    state is ``a``'s alone, and D (``a`` once more) is a duplicate with
    C's bytes, the JAX package's cold run over ``a``.  Were B's final
    state (``a`` + ``b``) cached under C's key, D would absorb ``a``
    again, and its bytes would differ."""
    import threading

    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.config import RunConfig
    from test_torch_serve import jax_cold
    from test_torch_survivability import _join_abandoned

    real_run = TorchBackend.run
    calls = []
    release, b_done = threading.Event(), threading.Event()

    def run(self, contigs, records, cfg, count_capture=None):
        calls.append(cfg.source_id)
        n = len(calls)
        if n == 2:                       # B: wedged until C has started
            release.wait(60)
            try:
                return real_run(self, contigs, records, cfg,
                                count_capture=count_capture)
            finally:
                b_done.set()
        if n == 3:                       # C, seeded: now B wakes and ends
            release.set()
            assert b_done.wait(60)
        return real_run(self, contigs, records, cfg,
                        count_capture=count_capture)

    monkeypatch.setattr(TorchBackend, "run", run)
    before = set(threading.enumerate())
    jobs = [(shard_files["a"], True, "A", {}),
            (shard_files["b"], True, "B", {}),
            (shard_files["a"], True, "C", {}),
            (shard_files["a"], True, "D", {})]
    try:
        got, res, r = _queue(jobs, runner_kw={"count_cache": "64M",
                                              "job_timeout": 2.0})
    finally:
        release.set()
        _join_abandoned(before)
    assert b_done.is_set() and len(calls) == 4
    assert [x.ok for x in res] == [True, False, True, True], \
        [x.error for x in res]
    assert "JobDeadlineExceeded" in res[1].error
    assert res[3].stats.extra.get("incremental_duplicate") \
        == os.path.abspath(shard_files["a"])
    want = jax_cold(shard_files["a"],
                    RunConfig(prefix="t", thresholds=[0.25, 0.5]))
    assert got[2] == got[3] == want
    s = r.count_cache.stats()
    assert s["entries"] == 1 and s["invalidated"] == 1


def test_host_rung_retry_keeps_the_warm_base(shard_files, monkeypatch):
    """A warm job that hangs past ``job_timeout`` under
    ``--on-device-error fallback`` retries on the host rung against the
    SAME warm base (the seed planted again): its output still covers the
    base reads — a ``--backend jax`` run over the concatenated input —
    and its final state is cached."""
    import threading

    from sam2consensus_torch.config import RunConfig
    from test_torch_serve import jax_cold
    from test_torch_survivability import _join_abandoned

    monkeypatch.setenv("S2C_FAULT_HANG_S", "3")
    before = set(threading.enumerate())
    hang = {"pileup": "pallas", "on_device_error": "fallback",
            "fault_inject": "job_hang:timeout:0:1"}
    jobs = [(shard_files["a"], True, "A", {"pileup": "pallas"}),
            (shard_files["b"], True, "B", hang)]
    try:
        got, res, r = _queue(jobs, runner_kw={"count_cache": "64M",
                                              "job_timeout": 1.5})
    finally:
        _join_abandoned(before)
    assert all(x.ok for x in res), [x.error for x in res]
    assert res[1].metrics.get("serve/job_retries") == 1
    assert res[1].rungs == {"pileup": "host"}
    assert got[1] == jax_cold(shard_files["combined"],
                              RunConfig(prefix="t", thresholds=[0.25, 0.5]))
    s = r.count_cache.stats()
    assert s["entries"] == 1 and s["invalidated"] == 0
