"""Cohort serving in the port (``serve/cohort.py``) on the CPU, held
against the JAX package's ``sam2consensus_tpu/serve/cohort.py``.

Each cohort case of ``tests/test_cohort.py`` is run through both
packages on the same numpy-seeded inputs and compared exactly
(tolerance: none): manifest loading, the wave caps and the wave sizer's
``(W, inputs)``, the concordance tally's summary and digest (with ties and
zero-depth rows), a 10-member cohort at ``--cohort-wave 4`` (FASTA bytes,
wave sizes, one panel plan, the summary's keys, the digest, the health
snapshot through ``tools/s2c_top``), the journal resume, the batch
scheduler requirement, the CLI's seven refusals and one ``cli.main`` run
against the JAX package's ``serve_main``.  Beside them, the port's own
parts: the card's branch of the count tap (the shared accumulator's
device slices, forced on the CPU through K1's plain version), a failed
tap counted, the tap and the probe cache released after a failed wave,
the prewarm's shapes, the host oracle and the cohort benchmark at a tiny
size.
"""

import gc
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("sam2consensus_torch", "sam2consensus_tpu")


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


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _sim_member(tmp, k, n_reads=48, contig_len=900):
    """One cohort member: one reference layout (same contig name and
    length, so one fingerprint), reads differing by seed."""
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    spec = SimSpec(n_contigs=1, contig_len=contig_len, n_reads=n_reads,
                   read_len=100, contig_len_jitter=0.0,
                   seed=30_000 + k, contig_prefix="cohtest")
    path = os.path.join(str(tmp), f"coh_{k:03d}.sam")
    with open(path, "w") as fh:
        fh.write(simulate(spec))
    return path


def _runner(pkg, **kw):
    from importlib import import_module

    kw.setdefault("prewarm", "off")
    kw.setdefault("echo", lambda *a, **k: None)
    if pkg == PKGS[0]:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("persistent_cache", False)
    return import_module(f"{pkg}.serve").ServeRunner(**kw)


def _config(pkg, **kw):
    cfg = _mod(pkg, "config")
    if pkg == PKGS[1]:
        kw["backend"] = "jax"
    return cfg.RunConfig(**kw)


def _rendered(pkg, res):
    render_file = _mod(pkg, "io.fasta").render_file
    return {n: render_file(r, 0) for n, r in res.fastas.items()}


def _both(fn):
    """``fn(pkg)`` for the port and the JAX package: each outcome, or
    the exception's type and message."""
    out = []
    for pkg in PKGS:
        try:
            out.append(("ok", fn(pkg)))
        except Exception as exc:   # compared across the packages
            out.append((type(exc).__name__, str(exc)))
    return out


# -- manifest loading ------------------------------------------------------
def _manifest_dir(tmp):
    for name in ("b.sam", "a.sam", "c.bam", "d.sam.gz", "skip.txt"):
        (tmp / name).write_text("")
    return str(tmp)


def _manifest_jsonl(tmp):
    man = tmp / "listing.jsonl"
    man.write_text(json.dumps({"path": "x.sam"}) + "\n"
                   + json.dumps({"path": "/abs/y.sam"}) + "\n")
    return str(man)


def _manifest_jsonl_no_path(tmp):
    man = tmp / "nopath.jsonl"
    man.write_text(json.dumps({"size": 3}) + "\n")
    return str(man)


def _manifest_jsonl_bad(tmp):
    man = tmp / "bad.jsonl"
    man.write_text("{not json\n")
    return str(man)


def _manifest_text(tmp):
    for name in ("g1.sam", "g2.sam", "one.sam"):
        (tmp / name).write_text("")
    man = tmp / "manifest.txt"
    man.write_text("# cohort members\n\none.sam\ng*.sam\n")
    return str(man)


def _manifest_empty_text(tmp):
    (tmp / "empty.txt").write_text("# nothing\n")
    return str(tmp / "empty.txt")


def _manifest_empty_dir(tmp):
    os.mkdir(tmp / "emptydir")
    return str(tmp / "emptydir")


@pytest.mark.parametrize("make,want", [
    (_manifest_dir, ["a.sam", "b.sam", "c.bam", "d.sam.gz"]),
    (_manifest_jsonl, ["x.sam", "y.sam"]),
    (_manifest_jsonl_no_path, "no 'path' key"),
    (_manifest_jsonl_bad, "not JSON"),
    (_manifest_text, ["one.sam", "g1.sam", "g2.sam"]),
    (_manifest_empty_text, "zero inputs"),
    (_manifest_empty_dir, "zero inputs"),
], ids=["directory", "jsonl", "jsonl-no-path", "jsonl-not-json",
        "text-globs", "empty-text", "empty-dir"])
def test_load_manifest_equals_reference(tmp_path, make, want):
    path = make(tmp_path)
    got = _both(lambda pkg: _mod(pkg, "serve.cohort").load_manifest(path))
    assert got[0] == got[1]
    if isinstance(want, list):
        assert got[0][0] == "ok"
        assert [os.path.basename(p) for p in got[0][1]] == want
    else:
        assert got[0][0] == "ValueError" and want in got[0][1]


# -- wave sizing -----------------------------------------------------------
def _sched(max_combined_len=1_000_000):
    return types.SimpleNamespace(max_combined_len=max_combined_len)


def _admission(max_queue=0, mem_budget=0):
    return types.SimpleNamespace(max_queue=max_queue,
                                 mem_budget=mem_budget)


@pytest.mark.parametrize("args,kw", [
    ((100, 100, None, _sched(1000), _admission()), {}),
    ((100, 100, None, _sched(1000), _admission(max_queue=4)), {}),
    ((3, 100, None, _sched(1000), _admission()), {}),
    ((100, 80, None, _sched(100), _admission()), {}),
    ((100, 100, None, _sched(), _admission(mem_budget=5_000)), {"mem": 1}),
    ((100, 100, None, _sched(), _admission(mem_budget=1_500)), {"mem": 1}),
    ((1, 100, None, _sched(), _admission(mem_budget=500)), {"mem": 1}),
], ids=["len-cap", "queue-cap", "remainder", "cannot-pack", "mem-search",
        "mem-too-small", "mem-single"])
def test_wave_cap_equals_reference(monkeypatch, args, kw):
    """The length and queue caps, and the ``--mem-budget`` binary search
    under one linear peak model in both packages (W members x 100
    positions -> W * 1000 bytes)."""
    if kw.get("mem"):
        for pkg in PKGS:
            monkeypatch.setattr(_mod(pkg, "observability.memplane"),
                                "predict_job_peak_bytes",
                                lambda total_len, cfg: total_len * 10)
    got = _both(lambda pkg: _mod(pkg, "serve.cohort").wave_cap(*args))
    assert got[0] == got[1]


@pytest.mark.parametrize("args,kw", [
    ((100, 100), dict(jps=5.0, wave_sec=2.0)),
    ((100, 100), dict(jps=0.1, wave_sec=2.0)),
    ((100, 100), dict(requested=64, sched=1000)),
    ((3, 100), dict(requested=8)),
    ((100, 100), dict(jps=5.0, wave_sec=2.0, rows_per_member=16.0)),
    ((11, 100), dict(jps=5.0, wave_sec=2.0, rows_per_member=16.0)),
    ((400, 420_000), dict(jps=40.0, wave_sec=2.0, sched=1 << 23,
                          rows_per_member=1000.0)),
    ((48, 420_000), dict(requested=16, sched=1 << 23)),
    ((1, 100), dict(jps=5.0, wave_sec=2.0)),
    ((100, 100), dict(jps=3.7, wave_sec=None, queue=6)),
], ids=["rate-target", "floor-2", "requested-clamped", "remainder",
        "pow2-snap", "final-wave-no-snap", "panel-len-cap", "panel-wave-16",
        "single", "env-wave-sec"])
def test_size_wave_equals_reference(monkeypatch, args, kw):
    """``size_wave``'s ``(W, inputs)``: the rate target and its floor,
    the explicit wave clamped to the caps and the remainder, the pow2
    snap and the final-wave rule, compared as dicts."""
    monkeypatch.setenv("S2C_COHORT_WAVE_SEC", "1.5")
    kw = dict(kw)
    sched = _sched(kw.pop("sched", 1_000_000))
    adm = _admission(max_queue=kw.pop("queue", 0))
    got = _both(lambda pkg: _mod(pkg, "serve.cohort").size_wave(
        *args, None, sched, adm, **kw))
    assert got[0] == got[1] and got[0][0] == "ok"


def test_wave_sec_env_equals_reference(monkeypatch):
    for value in ("", "0.01", "3.5", "x"):
        monkeypatch.setenv("S2C_COHORT_WAVE_SEC", value)
        got = _both(lambda pkg: _mod(pkg, "serve.cohort")._wave_sec())
        assert got[0] == got[1]


def test_canonical_panel_shapes_equal_reference():
    for panel_len, wave in ((1400, 4), (420_000, 19), (900, 1)):
        for kw in ({}, dict(read_len=100, chunk_reads=4096),
                   dict(n_reads=1000, segment_width=4096)):
            got = _both(lambda pkg: _mod(pkg, "ops.pileup")
                        .canonical_panel_shapes(panel_len, wave, **kw))
            assert got[0] == got[1] and got[0][0] == "ok"


# -- concordance -----------------------------------------------------------
def _tally_members(seed, panel_len=257, n_members=9):
    """Counts with many ties (small values) and zero-depth rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_members):
        c = rng.integers(0, 3, size=(panel_len, 6)).astype(np.int32)
        c[rng.random(panel_len) < 0.2] = 0
        out.append(c)
    return out


def _handmade_members():
    a = np.zeros((3, 6), dtype=np.int64)
    a[0, 1] = 5
    a[1, 2] = 4
    b = np.zeros((3, 6), dtype=np.int64)
    b[0, 1] = 2
    b[1, 3] = 9
    return [a, b]


@pytest.mark.parametrize("members", [
    _handmade_members(), _tally_members(1), _tally_members(2),
    _tally_members(3, panel_len=64, n_members=30)],
    ids=["handmade", "ties-1", "ties-2", "ties-many-members"])
@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["array", "tensor"])
def test_concordance_summary_equals_reference(members, as_tensor):
    """Summary and digest equal the reference's on counts with ties (the
    first maximal lane wins) and zero-depth rows, whether the port is
    handed arrays or tensors; the tally equals the reference's table."""
    from sam2consensus_torch.serve.cohort import ConcordanceAccumulator
    from sam2consensus_tpu.serve import cohort as r_cohort

    panel_len = members[0].shape[0]
    t_acc = ConcordanceAccumulator(panel_len)
    r_acc = r_cohort.ConcordanceAccumulator(panel_len)
    for c in members:
        t_acc.add_member(torch.from_numpy(c) if as_tensor else c)
        r_acc.add_member(c)
    assert t_acc.summary() == r_acc.summary()
    assert np.array_equal(t_acc.table(), r_acc._table)
    assert t_acc.table().dtype == np.int64
    with pytest.raises(ValueError, match="positions"):
        t_acc.add_member(np.zeros((panel_len + 1, 6), dtype=np.int64))


def test_concordance_tally_stays_on_its_device(monkeypatch):
    """A tensor member is used where it lies: the tally's ops never
    fetch it (no ``.cpu``/``.numpy`` on the member), and the one fetch
    is :meth:`table` at the summary."""
    from sam2consensus_torch.serve.cohort import ConcordanceAccumulator

    members = _tally_members(7, panel_len=50, n_members=3)
    acc = ConcordanceAccumulator(50, device="cpu")
    fetched = []
    orig_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        fetched.append(tuple(self.shape))
        return orig_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    for c in members:
        acc.add_member(torch.from_numpy(c))
    assert fetched == []
    acc.summary()
    assert fetched == [(50, 7)]


# -- end-to-end ------------------------------------------------------------
def _cohort_run(pkg, paths, out, wave, **runner_kw):
    """One cohort through ``pkg``'s ``CohortRunner``; returns the summary,
    the rendered outputs by file, the health snapshot and the registry's
    merge gauges."""
    cohort_mod = _mod(pkg, "serve.cohort")
    cfg = _config(pkg, prefix="", outfolder=out)
    r = _runner(pkg, batch="auto", **runner_kw)
    try:
        cohort = cohort_mod.CohortRunner(r, paths, cfg, wave=wave)
        assert r.cohort is cohort
        summary = cohort.run()
        health = r.health_snapshot()
        gauges = r.registry.snapshot()["gauges"]
        assert r.count_tap is None
    finally:
        r.close()
    outs = {res.filename: _rendered(pkg, res) for res in cohort.results
            if res.ok}
    return summary, outs, health, gauges, cohort


def test_cohort_multiwave_equals_reference(tmp_path):
    """A 10-member cohort at ``--cohort-wave 4``: every member's bytes
    are the JAX package's and the port's serial runner's, waves [4, 4,
    2], one panel plan, the summary's keys and the concordance summary
    (digest included) equal the reference's, and the health snapshot's
    cohort section renders in ``tools/s2c_top``."""
    paths = [_sim_member(tmp_path, k) for k in range(10)]
    t_sum, t_out, health, gauges, cohort = _cohort_run(
        PKGS[0], paths, str(tmp_path / "out_t"), 4)
    r_sum, r_out, r_health, _g, _c = _cohort_run(
        PKGS[1], paths, str(tmp_path / "out_r"), 4)

    from sam2consensus_torch.config import RunConfig, default_prefix
    from sam2consensus_torch.serve import JobSpec

    rs = _runner(PKGS[0], batch="off")
    try:
        serial = rs.submit_jobs(
            [JobSpec(filename=p, config=RunConfig(
                prefix=default_prefix(p),
                outfolder=str(tmp_path / "out_s")), job_id=f"s{k}")
             for k, p in enumerate(paths)])
    finally:
        rs.close()
    assert t_sum["samples_ok"] == 10 and t_sum["failed"] == 0
    assert t_sum["waves"] == 3
    assert t_sum["panel_plans"] == 1 and t_sum["panel_reuses"] >= 3
    decisions = t_sum["decisions"]
    assert [d["inputs"]["wave_jobs"] for d in decisions] == [4, 4, 2]
    assert [d["inputs"]["wave_jobs"] for d in r_sum["decisions"]] == \
        [4, 4, 2]
    assert all(d["decision"] == "cohort_wave" for d in decisions)
    assert list(t_sum) == list(r_sum)
    assert [sorted(d) for d in decisions] == \
        [sorted(d) for d in r_sum["decisions"]]
    for key in ("samples_total", "samples_ok", "resumed", "failed",
                "waves", "panel_len", "reference_fingerprint",
                "panel_plans", "panel_reuses", "batch_demotions",
                "admission_trips", "concordance"):
        assert t_sum[key] == r_sum[key], key
    assert t_sum["concordance"]["members"] == 10
    assert t_out == r_out
    for p, rser in zip(paths, serial):
        assert rser.ok and t_out[p] == _rendered(PKGS[0], rser)
    real = gauges.get("batch/real_rows", {}).get("value", 0.0)
    padded = gauges.get("batch/padded_rows", {}).get("value", 0.0)
    assert 0 < real <= padded
    assert cohort.last_wave["occupancy_pct"] > 0
    assert health["cohort"] == {**r_health["cohort"],
                                "last_wave": health["cohort"]["last_wave"]}
    assert sorted(health["cohort"]["last_wave"]) == \
        sorted(r_health["cohort"]["last_wave"])
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import s2c_top
    finally:
        sys.path.pop(0)
    cline = [ln for ln in s2c_top.render(health, [])
             if ln.startswith("cohort:")]
    assert cline and "wave 3/3" in cline[0] and "samples 10/10" in cline[0]


def _journal_events(jdir):
    events = []
    for name in sorted(os.listdir(jdir)):
        if name.startswith("ev-") and name.endswith(".json"):
            with open(os.path.join(jdir, name)) as fh:
                events.append(json.load(fh))
    return events


def test_cohort_resumes_from_journal_as_reference(tmp_path):
    """Half the cohort under a journal, then the full manifest on a
    fresh runner: the committed members are skipped and only the rest
    run, in both packages, with the same journal markers."""
    paths = [_sim_member(tmp_path, k, n_reads=32, contig_len=600)
             for k in range(6)]
    got = {}
    for pkg in PKGS:
        jdir = str(tmp_path / f"journal_{pkg}")
        cohort_mod = _mod(pkg, "serve.cohort")
        cfg = _config(pkg, prefix="", outfolder=str(tmp_path / f"o_{pkg}"))
        r1 = _runner(pkg, batch="auto", journal_dir=jdir)
        try:
            cohort_mod.CohortRunner(r1, paths[:3], cfg, wave=3).run()
        finally:
            r1.close()
        r2 = _runner(pkg, batch="auto", journal_dir=jdir)
        try:
            summary = cohort_mod.CohortRunner(r2, paths, cfg, wave=3).run()
        finally:
            r2.close()
        waves = [e for e in _journal_events(jdir)
                 if e.get("ev") == "cohort_wave"]
        got[pkg] = ({k: summary[k] for k in ("resumed", "samples_ok",
                                             "failed", "waves")},
                    [(e["jobs"], e["ok"], e["fingerprint"]) for e in waves],
                    summary["concordance"])
    assert got[PKGS[0]] == got[PKGS[1]]
    assert got[PKGS[0]][0] == {"resumed": 3, "samples_ok": 3, "failed": 0,
                               "waves": 1}
    assert len(got[PKGS[0]][1]) == 2


def test_cohort_requires_batch_scheduler(tmp_path):
    p = _sim_member(tmp_path, 0)
    for pkg in PKGS:
        r = _runner(pkg, batch="off")
        try:
            with pytest.raises(ValueError, match="--batch"):
                _mod(pkg, "serve.cohort").CohortRunner(
                    r, [p], _config(pkg))
        finally:
            r.close()


# -- CLI -------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--cohort-manifest", "m.txt", "-i", "x.sam"],
    ["--cohort-manifest", "m.txt", "--batch", "0"],
    ["--cohort-manifest", "m.txt", "--batch", "1"],
    ["--cohort-manifest", "m.txt", "--worker-id", "w1", "--journal", "j"],
    ["--cohort-manifest", "m.txt", "--ingest-port", "0", "--journal", "j"],
    ["--cohort-manifest", "m.txt", "--cohort-wave", "1"],
    ["-i", "x.sam", "--cohort-wave", "-2"],
], ids=["inputs", "batch-0", "batch-1", "worker-id", "ingest-port",
        "wave-1", "wave-negative"])
def test_serve_cli_rejects_bad_cohort_combos(argv):
    """The port refuses each combination at start with the reference's
    message."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    with pytest.raises(SystemExit) as t_exc:
        t_cli.main(["serve", "--quiet", *argv], device="cpu")
    with pytest.raises(SystemExit) as r_exc:
        r_cli.serve_main(["--quiet", *argv])
    assert str(t_exc.value.code).startswith("error: ")
    assert t_exc.value.code == r_exc.value.code


def test_serve_cli_incremental_cohort_refused(monkeypatch):
    """``--incremental`` with a cohort fails the start as the
    reference's does (the cache's own check comes first there too)."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    monkeypatch.setenv("S2C_COUNT_CACHE", "1G")
    argv = ["--quiet", "--cohort-manifest", "m.txt", "--incremental"]
    with pytest.raises(SystemExit) as t_exc:
        t_cli.main(["serve", *argv], device="cpu")
    with pytest.raises(SystemExit) as r_exc:
        r_cli.serve_main(argv)
    assert t_exc.value.code == r_exc.value.code
    assert "--incremental" in str(t_exc.value.code)


def test_serve_cli_cohort_equals_reference(tmp_path):
    """``cli.main(["serve", "--cohort-manifest", ...], device="cpu")``
    writes the JAX package's ``serve_main`` outputs, byte for byte, and
    a summary with its keys, waves and concordance."""
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_torch.utils.simulate import SimSpec, simulate
    from sam2consensus_tpu import cli as r_cli

    mdir = tmp_path / "members"
    mdir.mkdir()
    for k in range(5):
        (mdir / f"s{k}.sam").write_text(simulate(SimSpec(
            n_contigs=2, contig_len=700, n_reads=60, read_len=100,
            contig_len_jitter=0.0, seed=500 + k, contig_prefix="pan")))
    out_t, out_r = tmp_path / "out_t", tmp_path / "out_r"
    common = ["--cohort-manifest", str(mdir), "--cohort-wave", "2",
              "--quiet"]
    assert t_cli.main(["serve", *common, "-o", str(out_t),
                       "--cohort-summary", str(tmp_path / "t.json")],
                      device="cpu") == 0
    assert r_cli.serve_main([*common, "-o", str(out_r), "--cohort-summary",
                             str(tmp_path / "r.json")]) == 0
    names = sorted(os.listdir(out_t))
    assert len(names) == 10 and names == sorted(os.listdir(out_r))
    for name in names:
        assert (out_t / name).read_bytes() == (out_r / name).read_bytes()
    t_sum = json.loads((tmp_path / "t.json").read_text())
    r_sum = json.loads((tmp_path / "r.json").read_text())
    assert list(t_sum) == list(r_sum)
    assert t_sum["concordance"] == r_sum["concordance"]
    assert [d["inputs"]["wave_jobs"] for d in t_sum["decisions"]] == \
        [d["inputs"]["wave_jobs"] for d in r_sum["decisions"]] == [2, 2, 1]


# -- the port's own parts --------------------------------------------------
def _device_branch(monkeypatch, seen):
    """Force the card's branch of a packed batch on the CPU: K1's plain
    version as the shared accumulator, ``_link_free`` False, so the
    counts are never fetched and the tap gets the device slices."""
    from sam2consensus_torch.ops import pileup
    from sam2consensus_torch.serve import scheduler

    def shared_accumulator(self, total_len, batch_robs):
        self._link_free = False
        return pileup.PileupAccumulator(total_len, torch.device("cpu"),
                                        "pallas", "packed5"), "pallas"

    def counts_host(self):
        seen["fetches"] += 1
        return self.counts.cpu().numpy()

    monkeypatch.setattr(scheduler.BatchScheduler, "_shared_accumulator",
                        shared_accumulator)
    monkeypatch.setattr(pileup.PileupAccumulator, "counts_host",
                        counts_host)


def test_device_counts_feed_the_tap(tmp_path, monkeypatch):
    """The card's branch: each packed member's tap input is its slice of
    the shared accumulator's count tensor (a view, not a copy), the
    counts are never fetched, nothing is back-filled, and the digest and
    the bytes equal the JAX package's."""
    from sam2consensus_torch.serve import cohort as t_cohort

    seen = {"fetches": 0, "parts": []}
    _device_branch(monkeypatch, seen)
    orig_tap = t_cohort.CohortRunner._tap

    def tap(self, job_id, counts):
        seen["parts"].append((type(counts), counts._base is not None
                              if isinstance(counts, torch.Tensor) else None))
        return orig_tap(self, job_id, counts)

    monkeypatch.setattr(t_cohort.CohortRunner, "_tap", tap)
    paths = [_sim_member(tmp_path, k) for k in range(8)]
    t_sum, t_out, _h, _g, _c = _cohort_run(PKGS[0], paths,
                                           str(tmp_path / "o_t"), 4)
    r_sum, r_out, _h, _g, _c = _cohort_run(PKGS[1], paths,
                                           str(tmp_path / "o_r"), 4)
    assert seen["fetches"] == 0
    assert seen["parts"] == [(torch.Tensor, True)] * 8
    assert t_sum["concordance"] == r_sum["concordance"]
    assert t_out == r_out


def test_failed_tap_is_counted_and_backfilled(tmp_path, monkeypatch):
    """A tap that raises is counted (``batch/tap_failed``) and the job
    still succeeds; its member is back-filled from the host oracle,
    counted too, so the digest still equals the reference's."""
    from sam2consensus_torch.serve import cohort as t_cohort

    calls = {"n": 0}
    orig_add = t_cohort.ConcordanceAccumulator.add_member

    def add_member(self, counts):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("tap broke")
        return orig_add(self, counts)

    monkeypatch.setattr(t_cohort.ConcordanceAccumulator, "add_member",
                        add_member)
    paths = [_sim_member(tmp_path, k) for k in range(4)]
    cfg = _config(PKGS[0], prefix="", outfolder=str(tmp_path / "o"))
    r = _runner(PKGS[0], batch="auto")
    try:
        summary = t_cohort.CohortRunner(r, paths, cfg, wave=4).run()
        failed = r.registry.value("batch/tap_failed")
        oracle = r.registry.value("cohort/concordance_oracle_members")
    finally:
        r.close()
    r_sum, _o, _h, _g, _c = _cohort_run(PKGS[1], paths,
                                        str(tmp_path / "o_r"), 4)
    assert summary["samples_ok"] == 4
    assert failed == 1 and oracle == 1
    assert summary["concordance"] == r_sum["concordance"]


def test_failed_wave_resets_tap_and_closes_probe_handles(tmp_path,
                                                         monkeypatch):
    """A wave that raises leaves no tap on the runner (a later plain
    batch must not feed the tally) and no open probe handle: every
    handle the prefetch parked is closed."""
    from sam2consensus_torch.serve import cohort as t_cohort

    paths = [_sim_member(tmp_path, k, n_reads=16) for k in range(6)]
    closed, opened = [], []
    orig_prefetch = t_cohort.CohortRunner._prefetch

    def prefetch(self, batch_paths):
        orig_prefetch(self, batch_paths)
        for path in batch_paths:
            ai = self.sched.probe_cache.get(path, {}).get("batch_handle")
            if ai is not None:
                opened.append(path)
                orig_close = ai.close

                def close(orig_close=orig_close, path=path):
                    closed.append(path)
                    return orig_close()

                ai.close = close

    def run_wave(self, k, *args, **kwargs):
        raise RuntimeError("wave broke")

    monkeypatch.setattr(t_cohort.CohortRunner, "_prefetch", prefetch)
    monkeypatch.setattr(t_cohort.CohortRunner, "_run_wave", run_wave)
    cfg = _config(PKGS[0], prefix="", outfolder=str(tmp_path / "o"))
    r = _runner(PKGS[0], batch="auto")
    try:
        max_jobs = r.scheduler.max_jobs
        cohort = t_cohort.CohortRunner(r, paths, cfg, wave=3)
        with pytest.raises(RuntimeError, match="wave broke"):
            cohort.run()
        assert r.count_tap is None
        assert r.scheduler.probe_cache == {}
        assert r.scheduler.max_jobs == max_jobs
    finally:
        r.close()
    # wave 2's members, probed while wave 1 ran
    assert opened == paths[3:6]
    assert sorted(closed) == sorted(opened)


def test_prewarm_shapes_off_the_host_rung(tmp_path, monkeypatch):
    """Off the host accumulation rung the cohort prewarms the combined
    panel axis's canonical shapes once, before wave 1; on it (the CPU
    with the native library) nothing is prewarmed."""
    from sam2consensus_torch import native
    from sam2consensus_torch.ops.pileup import canonical_panel_shapes
    from sam2consensus_torch.serve import cohort as t_cohort
    from sam2consensus_torch.serve import scheduler

    paths = [_sim_member(tmp_path, k, n_reads=16) for k in range(5)]
    calls = []
    for host_rung in (True, False):
        if native.load() is None and host_rung:
            continue
        monkeypatch.setattr(scheduler.BatchScheduler, "_accum_host_rung",
                            lambda self, h=host_rung: h)
        cfg = _config(PKGS[0], prefix="",
                      outfolder=str(tmp_path / f"o{host_rung}"))
        r = _runner(PKGS[0], batch="auto", prewarm="auto")
        monkeypatch.setattr(r, "prewarm",
                            lambda total_len, shapes, h=host_rung:
                            calls.append((h, total_len, shapes)) or 0)
        try:
            summary = t_cohort.CohortRunner(r, paths, cfg, wave=2).run()
        finally:
            r.close()
        assert summary["samples_ok"] == 5
    want = canonical_panel_shapes(900, 2, chunk_reads=cfg.chunk_reads)
    assert calls == [(False, 900 * 2, want)]


def test_oracle_member_counts_equal_reference(tmp_path):
    """The host oracle's counts equal the JAX package's oracle on the
    same member; without a backend it builds one on the default device
    (CUDA), never quietly on the CPU."""
    from sam2consensus_torch.backends.torch_backend import TorchBackend
    from sam2consensus_torch.serve import cohort as t_cohort
    from sam2consensus_tpu.serve import cohort as r_cohort

    p = _sim_member(tmp_path, 3)
    got = t_cohort.oracle_member_counts(
        p, _config(PKGS[0]), backend=TorchBackend("cpu"))
    want = r_cohort.oracle_member_counts(p, _config(PKGS[1]))
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cohort.oracle_member_counts(p, _config(PKGS[0]))


def test_cohort_bench_at_tiny_size():
    """``run_cohort_bench`` on the CPU at a tiny size: its sides are
    byte-identical, the concordance pin holds, one plan and no new
    build after wave 1."""
    from sam2consensus_torch.serve import benchmark

    s = benchmark.run_cohort_bench(n_samples=12, n_reads=24,
                                   contig_len=600, wave=4, spot_checks=4,
                                   pin_members=6, stranger_batch=4,
                                   device="cpu")["summary"]
    assert s["identical"] is True and s["concordance_pinned"] is True
    assert s["replans_after_wave1"] == 0
    assert s["new_compiles_after_wave1"] == 0
    assert s["samples_ok"] == 12 and s["waves"] == 3
    assert s["panel_plans"] == 1
