"""The port's observability against the JAX package's, on the CPU.

* The tracer, the exports and the decision ledger: one test body over
  both packages (``PKGS``), the reference's unit tests of
  ``tests/test_observability.py`` on each.
* The one-shot run under ``--trace-out``, ``--metrics-out`` and
  ``--json-metrics``: the ``formats_*`` fixtures (SAM, BGZF SAM, BAM) and
  one seeded input with insertions through ``--backend jax --shards 1``
  (JAX on the CPU, the single-device path, Pallas in interpret mode) and
  the port's CLI (``device="cpu"``, ``--pileup pallas``).  The FASTA
  bytes are equal; the manifest's schema and keys, the span names, the
  counter and gauge names of the families that ``publish_stats_extra``
  carries and the ledger's decision names are equal exactly, but for the
  names listed in ``JAX_ONLY`` / ``PORT_ONLY``, each with its reason, and
  the drift verdicts, which depend on the seconds measured; ``chosen`` is
  equal for the decisions made from the same inputs.
* The recovery trace events (``resilience/*``, ``fault/*``,
  ``checkpoint/*``) of fault runs, equal to the reference's.
* ``--log-format json``, ``--profile-dir`` on the CPU, the memory
  plane's lock-free finalizer (the reference's deadlock, ROADMAP §C 2),
  the link probe's stale cache, the rate card, the kernel build's cache
  counters, and the ``RunConfig`` fields that the port now runs.
"""

import contextlib
import gc
import io
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from sam2consensus_torch import cli as t_cli
from sam2consensus_torch import observability as t_obs
from sam2consensus_torch.backends.torch_backend import TorchBackend
from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.io.sam import ReadStream as TReadStream
from sam2consensus_torch.io.sam import read_header as t_read_header
from sam2consensus_torch.observability import export as t_export
from sam2consensus_torch.observability import jitcache as t_jitcache
from sam2consensus_torch.observability import memplane as t_mem
from sam2consensus_torch.observability import ratecard as t_rc
from sam2consensus_torch.observability import telemetry as t_tel
from sam2consensus_torch.observability import trace as t_trace
from sam2consensus_torch.observability.metrics import \
    MetricsRegistry as TRegistry
from sam2consensus_torch.utils import linkprobe as t_lp
from sam2consensus_torch.utils.simulate import SimSpec, simulate
from sam2consensus_tpu import cli as r_cli
from sam2consensus_tpu import observability as r_obs
from sam2consensus_tpu.observability import export as r_export
from sam2consensus_tpu.observability import memplane as r_mem
from sam2consensus_tpu.observability import ratecard as r_rc
from sam2consensus_tpu.observability import telemetry as r_tel
from sam2consensus_tpu.observability import trace as r_trace
from sam2consensus_tpu.observability.metrics import \
    MetricsRegistry as RRegistry

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

#: (package, its trace module, its export module, its registry class)
PKGS = {"ref": (r_obs, r_trace, r_export, RRegistry),
        "port": (t_obs, t_trace, t_export, TRegistry)}


@pytest.fixture(autouse=True)
def _collect_jax_garbage():
    """Collect after each test, outside any lock: the JAX package's
    memory-plane finalizers must not run inside its registry lock
    (ROADMAP §C 2)."""
    yield
    gc.collect()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- tracer ----------------------------------------------------------------
def test_span_nesting_and_ordering(pkg):
    tr = pkg[1].Tracer(enabled=True)
    with tr.span("outer", kind="phase"):
        time.sleep(0.002)
        with tr.span("inner"):
            time.sleep(0.001)
    spans = {s.name: s for s in tr.drain()}
    outer, inner = spans["outer"], spans["inner"]
    assert [s.name for s in tr.drain()] == ["inner", "outer"]
    assert outer.ts_us <= inner.ts_us
    assert inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us + 1.0
    assert outer.args == {"kind": "phase"}


def test_span_events_and_args(pkg):
    tr = pkg[1].Tracer(enabled=True)
    with tr.span("phase") as sp:
        sp.event("decision", chosen="cpu", cpu_sec=0.1)
        sp.set_args(rows=7)
    (s,) = tr.drain()
    assert s.args == {"rows": 7}
    (name, ts, args) = s.events[0]
    assert name == "decision" and args["chosen"] == "cpu"
    assert s.ts_us <= ts <= s.ts_us + s.dur_us


def test_span_sync_runs_inside_span(pkg):
    tr = pkg[1].Tracer(enabled=True)
    ran = []
    with tr.span("device", sync=lambda: (time.sleep(0.003),
                                         ran.append(True))):
        pass
    (s,) = tr.drain()
    assert ran == [True]
    assert s.dur_us >= 2000


def test_span_sync_skipped_on_exception(pkg):
    tr = pkg[1].Tracer(enabled=True)
    ran = []
    with pytest.raises(KeyError):
        with tr.span("device", sync=lambda: ran.append(True)):
            raise KeyError("x")
    assert ran == [] and [s.name for s in tr.drain()] == ["device"]


def test_tracer_thread_safety(pkg):
    tr = pkg[1].Tracer(enabled=True)
    gate = threading.Barrier(4)

    def work(i):
        gate.wait()
        for k in range(50):
            with tr.span(f"t{i}", k=k):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = tr.drain()
    assert len(spans) == 200
    assert len({s.tid for s in spans}) == 4
    for name in ("t0", "t1", "t2", "t3"):
        assert sum(1 for s in spans if s.name == name) == 50


def test_disabled_tracer_is_noop_and_cheap(pkg):
    tr = pkg[1].Tracer(enabled=False)
    with tr.span("x") as sp:
        sp.event("e", a=1)
        sp.set_args(b=2)
    tr.event("top")
    tr.complete("c", time.perf_counter())
    tr.name_thread("n")
    assert tr.drain() == [] and tr.thread_names() == {}
    assert tr.span("a") is tr.span("b")          # one shared no-op
    n = 50_000

    def loop_span():
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("hot"):
                pass
        return time.perf_counter() - t0

    def loop_empty():
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        return time.perf_counter() - t0

    per_call = (min(loop_span() for _ in range(5))
                - min(loop_empty() for _ in range(5))) / n
    assert per_call < 2e-6, \
        f"disabled span costs {per_call * 1e9:.0f}ns/call (budget 2000)"


def test_current_span_name_tracks_open_spans(pkg):
    tr = pkg[1].Tracer(enabled=True)
    assert pkg[1].current_span_name() is None
    with tr.span("outer"):
        with tr.span("inner"):
            assert pkg[1].current_span_name() == "inner"
        assert pkg[1].current_span_name() == "outer"
    assert pkg[1].current_span_name() is None


# -- run scope -------------------------------------------------------------
def test_run_scope_push_pop(pkg):
    obs = pkg[0]
    base = obs.metrics()
    robs = obs.start_run()
    assert obs.metrics() is robs.registry and obs.metrics() is not base
    obs.metrics().add("phase/x_sec", 1.0)
    extra = {}
    obs.publish_stats_extra(extra)
    assert extra["x_sec"] == 1.0
    obs.finish_run(robs)
    assert obs.metrics() is base
    assert not obs.tracer().enabled


def test_bind_run_to_thread(pkg):
    obs = pkg[0]
    robs = obs.prepare_run(enabled=True)
    seen = []

    def work():
        with obs.bind_run_to_thread(robs):
            obs.metrics().add("phase/bound_sec", 2.0)
            with obs.tracer().span("bound"):
                pass
            obs.record_decision("bound", "yes")
            seen.append(obs.metrics() is robs.registry)
        seen.append(obs.metrics() is robs.registry)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [True, False]
    assert robs.registry.value("phase/bound_sec") == 2.0
    assert [s.name for s in robs.tracer.drain()] == ["bound"]
    assert robs.ledger.get("bound").chosen == "yes"


def test_env_destinations(pkg, tmp_path, monkeypatch):
    """``S2C_TRACE_OUT`` / ``S2C_METRICS_OUT`` stand in for the flags and
    turn the tracer on."""
    obs = pkg[0]
    monkeypatch.setenv("S2C_TRACE_OUT", str(tmp_path / "t.json"))
    monkeypatch.setenv("S2C_METRICS_OUT", str(tmp_path / "m.jsonl"))
    robs = obs.start_run()
    assert obs.tracer().enabled
    with obs.tracer().span("decode"):
        obs.metrics().add("phase/decode_sec", 0.5)
    obs.finish_run(robs, meta={"backend": "test"})
    names = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert names == {"decode"}
    rows = obs.read_metrics_jsonl(str(tmp_path / "m.jsonl"))
    assert rows[0] == {"kind": "meta", "pid": os.getpid(),
                       "backend": "test"}
    man = json.loads((tmp_path / "m.jsonl.manifest.json").read_text())
    assert man["schema"] == "s2c-manifest/1"
    assert man["artifacts"]["trace"]["digest"].startswith("sha256:")
    assert obs.last_manifest()["phases"] == {"phase/decode_sec": 0.5}


# -- exports ---------------------------------------------------------------
def test_chrome_trace_event_format(pkg, tmp_path):
    obs, trace = pkg[0], pkg[1]
    tr = trace.Tracer(enabled=True)
    tr.name_thread("main-test")
    with tr.span("outer"):
        with tr.span("inner", rows=3) as sp:
            sp.event("marker", x=1)
    path = tmp_path / "trace.json"
    obs.write_chrome_trace(tr, str(path))
    events = json.loads(path.read_text())["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in complete} == {"outer", "inner"}
    for e in complete:
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        assert e["dur"] >= 0 and "pid" in e and "tid" in e
    assert any(e["name"] == "marker" and e["args"] == {"x": 1}
               for e in events if e["ph"] == "i")
    assert any(e["args"]["name"] == "main-test"
               for e in events if e["ph"] == "M")
    ts = [e.get("ts", 0.0) for e in events]
    assert ts == sorted(ts)


def test_metrics_jsonl_roundtrip(pkg, tmp_path):
    obs, registry = pkg[0], pkg[3]
    reg = registry()
    reg.add("phase/vote_sec", 0.25)
    reg.gauge("dispatch/tail").set_info({"chosen": "device"})
    reg.observe("pileup/slab_sec/scatter", 0.1)
    path = tmp_path / "m.jsonl"
    obs.write_metrics_jsonl(reg, str(path), meta={"backend": "x"})
    rows = obs.read_metrics_jsonl(str(path))
    assert rows[0]["kind"] == "meta" and rows[0]["backend"] == "x"
    assert {r["kind"] for r in rows} == {"meta", "counter", "gauge",
                                         "histogram"}
    gauge = next(r for r in rows if r["kind"] == "gauge")
    assert gauge["info"] == {"chosen": "device"}


def test_export_empty_registry_and_tracer(pkg, tmp_path):
    obs, trace, _e, registry = pkg
    mpath = tmp_path / "empty.jsonl"
    obs.write_metrics_jsonl(registry(), str(mpath))
    rows = obs.read_metrics_jsonl(str(mpath))
    assert len(rows) == 1 and rows[0]["kind"] == "meta"
    tpath = tmp_path / "empty.json"
    obs.write_chrome_trace(trace.Tracer(enabled=True), str(tpath))
    assert json.loads(tpath.read_text())["traceEvents"] == []


def test_export_unicode_span_labels(pkg, tmp_path):
    obs, trace = pkg[0], pkg[1]
    tr = trace.Tracer(enabled=True)
    tr.name_thread("décode-λ")
    with tr.span("φάση/vote", note="naïve—çedilla"):
        pass
    tr.event("drift/σ", chosen="gén")
    path = tmp_path / "uni.json"
    obs.write_chrome_trace(tr, str(path))
    blob = json.loads(path.read_text(encoding="utf-8"))
    names = {e["name"] for e in blob["traceEvents"]}
    assert "φάση/vote" in names and "drift/σ" in names


def test_export_numpy_args_serializable(pkg, tmp_path):
    obs, trace, _e, registry = pkg
    tr = trace.Tracer(enabled=True)
    with tr.span("s", n=np.int64(7), f=np.float32(0.5)):
        pass
    reg = registry()
    reg.gauge("g").set_info({"rows": np.int32(3), "arr": np.arange(2)})
    obs.write_chrome_trace(tr, str(tmp_path / "t.json"))
    obs.write_metrics_jsonl(reg, str(tmp_path / "m.jsonl"))
    blob = json.loads((tmp_path / "t.json").read_text())
    (span,) = [e for e in blob["traceEvents"] if e["ph"] == "X"]
    assert span["args"]["n"] == 7
    g = next(r for r in obs.read_metrics_jsonl(str(tmp_path / "m.jsonl"))
             if r["kind"] == "gauge")
    assert g["info"]["rows"] == 3 and g["info"]["arr"] == [0, 1]


def test_export_torch_args_serializable(tmp_path):
    """The port's span and gauge args may carry a 0-d tensor or a
    device."""
    tr = t_trace.Tracer(enabled=True)
    with tr.span("s", n=torch.tensor(5), dev=torch.device("cpu")):
        pass
    t_obs.write_chrome_trace(tr, str(tmp_path / "t.json"))
    (span,) = [e for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"] if e["ph"] == "X"]
    assert span["args"] == {"n": 5, "dev": "cpu"}
    assert t_export._json_default(torch.tensor(2.5)) == 2.5


# -- decision ledger -------------------------------------------------------
def test_ledger_residual_join_and_gauges(pkg):
    obs = pkg[0]
    robs = obs.start_run()
    try:
        obs.record_decision(
            "tail_placement", "cpu", inputs={"total_len": 1000},
            predicted={"sec": 0.10},
            alternatives={"cpu": 0.10, "device": 0.30},
            measured={"sec": {"counters": ["phase/vote_sec"]}})
        obs.metrics().add("phase/vote_sec", 0.12)
        (rec,) = [r for r in obs.finalize_decisions()
                  if r.decision == "tail_placement"]
        assert rec.measured["sec"] == pytest.approx(0.12)
        assert rec.residual["sec"] == pytest.approx(1.2)
        assert not rec.drift
        snap = robs.registry.snapshot()
        assert snap["gauges"]["residual/tail_placement/sec"]["value"] \
            == pytest.approx(1.2)
        info = snap["gauges"]["residual/tail_placement"]["info"]
        assert info["chosen"] == "cpu" and info["drift"] is False
        assert "drift/events" not in snap["counters"]
    finally:
        obs.finish_run(robs)


def test_ledger_drift_fires_outside_band(pkg):
    obs = pkg[0]
    robs = obs.start_run(enabled=True)
    try:
        obs.record_decision(
            "link_constants", "default", predicted={"bps": 40e6},
            measured={"bps": {"num": ["wire/bytes"],
                              "den": ["phase/stage_sec"]}})
        obs.metrics().add("wire/bytes", 4e6)
        obs.metrics().add("phase/stage_sec", 1.0)
        (rec,) = [r for r in obs.finalize_decisions()
                  if r.decision == "link_constants"]
        assert rec.residual["bps"] == pytest.approx(0.1) and rec.drift
        snap = robs.registry.snapshot()
        assert snap["counters"]["drift/events"] == 1
        assert "drift/link_constants" in snap["gauges"]
        assert [s.name for s in robs.tracer.drain()] == \
            ["drift/link_constants"]
        extra = {}
        obs.publish_stats_extra(extra)
        assert extra["drift/events"] == 1
        assert extra["residual/link_constants/bps"] == pytest.approx(0.1)
    finally:
        obs.finish_run(robs)


def test_ledger_drift_respects_sec_floor_and_band_zero(pkg):
    obs = pkg[0]
    robs = obs.start_run()
    try:
        obs.record_decision(
            "tiny", "x", predicted={"sec": 1e-5},
            measured={"sec": {"counters": ["phase/a_sec"]}})
        obs.metrics().add("phase/a_sec", 1e-3)
        obs.record_decision(
            "informational", "y", predicted={"sec": 0.1},
            measured={"sec": {"counters": ["phase/b_sec"]}}, band=0)
        obs.metrics().add("phase/b_sec", 100.0)
        recs = {r.decision: r for r in obs.finalize_decisions()}
        assert not recs["tiny"].drift
        assert recs["informational"].residual["sec"] == pytest.approx(
            1000.0)
        assert not recs["informational"].drift
        assert "drift/events" not in robs.registry.snapshot()["counters"]
    finally:
        obs.finish_run(robs)


def test_ledger_last_wins_and_missing_measurements(pkg):
    obs = pkg[0]
    robs = obs.start_run()
    try:
        obs.record_decision("d", "first", predicted={"sec": 1.0})
        obs.record_decision(
            "d", "second", predicted={"sec": 2.0},
            measured={"sec": {"counters": ["phase/never_sec"]},
                      "bps": {"num": ["wire/bytes"],
                              "den": ["phase/zero_sec"]}})
        (rec,) = [r for r in obs.finalize_decisions() if r.decision == "d"]
        assert rec.chosen == "second"
        assert rec.measured == {} and rec.residual == {} and not rec.drift
    finally:
        obs.finish_run(robs)


def test_ledger_zero_traffic_and_min_num_never_drift(pkg):
    obs = pkg[0]
    robs = obs.start_run()
    try:
        obs.record_decision(
            "link_constants", "default", predicted={"bps": 40e6},
            measured={"bps": {"num": ["wire/bytes"],
                              "den": ["phase/pileup_dispatch_sec"]}})
        obs.metrics().add("phase/pileup_dispatch_sec", 3.0)
        obs.record_decision(
            "wire_codec", "delta8", predicted={"bps": 40e6},
            measured={"bps": {"num": ["wire/bytes2"],
                              "den": ["phase/stage_sec"],
                              "min_num": 8e6}})
        obs.metrics().add("wire/bytes2", 2e6)
        obs.metrics().add("phase/stage_sec", 5.0)
        recs = {r.decision: r for r in obs.finalize_decisions()}
        assert recs["link_constants"].measured == {}
        assert recs["wire_codec"].measured == {}
        assert not recs["link_constants"].drift
        assert not recs["wire_codec"].drift
    finally:
        obs.finish_run(robs)


@pytest.mark.parametrize("band,min_sec,drift", [
    ("2", "0.02", True), ("16", "0.02", False), ("2", "10", False),
    ("oops", "0.02", True)])
def test_ledger_drift_knobs(pkg, monkeypatch, band, min_sec, drift):
    """``S2C_DRIFT_BAND`` and ``S2C_DRIFT_MIN_SEC``: a 5x residual on a
    0.5 s prediction drifts under a band of 2 (and the default 4, which
    a malformed value falls back to), not under 16 nor under a 10 s
    floor."""
    obs = pkg[0]
    monkeypatch.setenv("S2C_DRIFT_BAND", band)
    monkeypatch.setenv("S2C_DRIFT_MIN_SEC", min_sec)
    robs = obs.start_run()
    try:
        obs.record_decision(
            "d", "x", predicted={"sec": 0.5},
            measured={"sec": {"counters": ["phase/d_sec"]}})
        obs.metrics().add("phase/d_sec", 2.5)
        (rec,) = obs.finalize_decisions()
        assert rec.residual["sec"] == pytest.approx(5.0)
        assert rec.drift is drift
    finally:
        obs.finish_run(robs)


def test_ledger_provenance_rides_inputs(pkg):
    obs = pkg[0]
    rc = r_rc if obs is r_obs else t_rc
    _v, prov = rc.consult("link_bps", 1e9)
    assert prov == {"source": "default", "key": "link_bps"}
    robs = obs.start_run()
    try:
        rec = obs.record_decision("d", "x", inputs={"a": 1},
                                  provenance=prov)
        assert rec.inputs == {"a": 1, "ratecard": prov}
    finally:
        obs.finish_run(robs)


# -- the one-shot run against --backend jax --------------------------------
#: counter and gauge names (of the families ``publish_stats_extra``
#: carries), span names and decision names that ``--backend jax`` records
#: on the CPU and the port's CPU run does not, each with its reason
JAX_ONLY = {
    # the reference stages rows on its prefetch thread on the CPU too;
    # the port stages on CUDA only (the CPU consumer ships its own rows)
    "stage": "staging is CUDA-only in the port",
    "phase/stage_sec": "staging is CUDA-only in the port",
    "pipeline/overlap_sec": "staging is CUDA-only in the port",
    "pipeline/backpressure_sec": "staging is CUDA-only in the port",
    "pipeline/overlap": "staging is CUDA-only in the port",
    "mem/live_bytes/wire_staging": "staging is CUDA-only in the port",
    "mem/peak_bytes/wire_staging": "staging is CUDA-only in the port",
    # XLA's persistent compilation cache; the port counts its kernel
    # build instead, which the CPU device never makes
    "compile/persist_miss": "no kernel build on the CPU device",
    "compile/persist_hit": "no kernel build on the CPU device",
    # the reference prices its link-free CPU tail's encoding from the
    # link constants; the port ships dense from a link-free tail without
    # consulting them (torch_backend.tail_encoding)
    "link_constants": "the port's link-free tail consults no link",
    "residual/link_constants": "the port's link-free tail consults no link",
}
#: names of the port's run that the reference's CPU run does not record
PORT_ONLY = {
    # the reference's link-free CPU tail is the native C++ vote (host
    # epilogue); the port's CPU device accumulator runs the fused tail's
    # plain versions, whose epilogue is on the (CPU) device
    "epilogue/device_tails": "the fused tail's epilogue on the CPU",
}
#: and the reverse, for the same reason
JAX_ONLY["epilogue/host_tails"] = "the reference's CPU tail is native"

#: counter prefixes and gauge names/prefixes ``publish_stats_extra``
#: carries (sam2consensus_tpu/observability/__init__.py:242-323)
PUBLISHED_COUNTERS = ("phase/", "resilience/", "fault/", "checkpoint/",
                      "wire/", "pipeline/", "drift/", "serve/", "compile/",
                      "format/", "ingest/", "quarantine/", "slo/",
                      "telemetry/", "cache/", "epilogue/", "mem/")
PUBLISHED_GAUGES = ("dispatch/tail", "dispatch/pileup", "wire/codec",
                    "pipeline/overlap", "format/input", "ingest/mode",
                    "serve/recovery", "serve/watchdog", "quarantine/summary")


def _published(rows) -> set:
    names = set()
    for r in rows:
        name = r.get("name", "")
        if r["kind"] == "counter" and name.startswith(PUBLISHED_COUNTERS):
            names.add(name)
        elif r["kind"] == "gauge" and (
                name in PUBLISHED_GAUGES or name.startswith("mem/")
                or name.startswith("residual/")):
            names.add(name)
    return names


def _gen_sam(tmp) -> str:
    path = os.path.join(tmp, "gen.sam")
    with open(path, "w") as fh:
        fh.write(simulate(SimSpec(n_contigs=2, contig_len=400, n_reads=300,
                                  read_len=50, ins_read_rate=0.2,
                                  del_read_rate=0.1, seed=11)))
    return path


INPUTS = ["formats_short.sam", "formats_longread.sam",
          "formats_adversarial.sam", "formats_short.bam",
          "formats_longread.sam.gz", "gen.sam"]


def _observed_run(main, path, out, flags, **kw) -> dict:
    """One CLI run with the three artifacts; returns them with the FASTA
    bytes."""
    os.makedirs(out)
    art = {k: os.path.join(out, k) for k in ("t.json", "m.jsonl", "j.json")}
    argv = ["-i", path, "-o", out + "/fa", "-p", "p", "--trace-out",
            art["t.json"], "--metrics-out", art["m.jsonl"],
            "--json-metrics", art["j.json"], *flags]
    with contextlib.redirect_stdout(io.StringIO()) as log:
        assert main(argv, **kw) == 0
    fa = out + "/fa"
    return {
        "fasta": {f: open(os.path.join(fa, f), "rb").read()
                  for f in sorted(os.listdir(fa))},
        "trace": json.load(open(art["t.json"])),
        "rows": t_obs.read_metrics_jsonl(art["m.jsonl"]),
        "manifest": json.load(open(art["m.jsonl"] + ".manifest.json")),
        "json": json.load(open(art["j.json"])),
        "log": log.getvalue(),
    }


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """``{input: (reference run, port run)}``: ``--backend jax --pileup
    pallas`` and the port's ``--pileup pallas`` on the CPU, each under
    fresh memory planes (families are process-wide)."""
    tmp = str(tmp_path_factory.mktemp("obs"))
    gen = _gen_sam(tmp)
    out = {}
    for name in INPUTS:
        path = gen if name == "gen.sam" else os.path.join(DATA, name)
        r_mem._reset_for_tests()
        t_mem._reset_for_tests()
        ref = _observed_run(r_cli.main, path, f"{tmp}/{name}.r",
                            ["--backend", "jax", "--shards", "1",
                             "--pileup", "pallas"])
        port = _observed_run(t_cli.main, path, f"{tmp}/{name}.t",
                             ["--pileup", "pallas"], device="cpu")
        out[name] = (ref, port)
        gc.collect()
    return out


#: names whose presence depends on the seconds a run measured, not on
#: what it ran: a drift verdict (its event, counter and gauge) fires when
#: a decision's measured/predicted residual leaves the band
TIMING_DEPENDENT = ("drift/",)


def _names_equal(ref: set, port: set) -> None:
    ref = {n for n in ref if not n.startswith(TIMING_DEPENDENT)}
    port = {n for n in port if not n.startswith(TIMING_DEPENDENT)}
    assert ref - port <= set(JAX_ONLY), ref - port - set(JAX_ONLY)
    assert port - ref <= set(PORT_ONLY), port - ref - set(PORT_ONLY)


@pytest.mark.parametrize("name", INPUTS)
def test_run_fasta_equal(pairs, name):
    ref, port = pairs[name]
    assert port["fasta"] == ref["fasta"] and port["fasta"]


@pytest.mark.parametrize("name", INPUTS)
def test_run_manifest_schema(pairs, name):
    ref, port = pairs[name]
    rm, tm = ref["manifest"], port["manifest"]
    assert tm["schema"] == rm["schema"] == "s2c-manifest/1"
    assert list(tm) == list(rm)
    assert tm["meta"] == {"backend": "torch", "device": "cpu"}
    assert set(tm["config"]) == set(rm["config"])
    assert tm["config"]["trace_out"] and tm["config"]["backend"] == "torch"
    assert set(tm["artifacts"]) == {"trace", "metrics"}
    assert {"source", "measured_at"} <= set(tm["link"]) \
        and {"source", "measured_at"} <= set(rm["link"])
    # the manifest's decisions are the ledger's, in the reference's shape
    for d in tm["decisions"]:
        assert list(d) == list(rm["decisions"][0])


@pytest.mark.parametrize("name", INPUTS)
def test_run_span_names(pairs, name):
    ref, port = pairs[name]

    def names(run):
        return {e["name"] for e in run["trace"]["traceEvents"]}

    _names_equal(names(ref), names(port))
    events = port["trace"]["traceEvents"]
    # every phase span, once for accumulate and its barrier
    complete = [e["name"] for e in events if e["ph"] == "X"]
    for phase in ("decode", "pileup_dispatch", "accumulate", "insertions",
                  "vote", "render", "accumulate_sync"):
        assert phase in complete
    assert complete.count("accumulate") == 1
    assert complete.count("accumulate_sync") == 1
    # the prefetch thread is named, and its decode spans carry its tid
    threads = {e["tid"]: e["args"]["name"] for e in events
               if e["ph"] == "M"}
    assert "decode-prefetch" in threads.values()
    pf = next(t for t, n in threads.items() if n == "decode-prefetch")
    assert any(e["name"] == "decode" and e["tid"] == pf for e in events)
    # one pileup_dispatch span a batch, and the counted slabs under them
    n_slabs = sum(1 for e in events if e["name"] == "slab")
    counters = {r["name"]: r["value"] for r in port["rows"]
                if r["kind"] == "counter"}
    assert n_slabs == counters["pileup/slabs"]


@pytest.mark.parametrize("name", INPUTS)
def test_run_metric_names(pairs, name):
    ref, port = pairs[name]
    _names_equal(_published(ref["rows"]), _published(port["rows"]))
    assert port["rows"][0]["backend"] == "torch"


@pytest.mark.parametrize("name", INPUTS)
def test_run_decisions(pairs, name):
    ref, port = pairs[name]
    rd = {d["decision"]: d for d in ref["manifest"]["decisions"]}
    td = {d["decision"]: d for d in port["manifest"]["decisions"]}
    _names_equal(set(rd), set(td))
    for decision in ("decode_threads", "wire_codec", "longread_layout"):
        if decision in rd:            # decode_threads: SAM text only
            assert td[decision]["chosen"] == rd[decision]["chosen"]
    assert set(td["capacity"]["inputs"]) >= {"total_len", "counts_bytes",
                                             "staging_bytes",
                                             "tail_bytes"}


@pytest.mark.parametrize("name", INPUTS)
def test_run_json_metrics(pairs, name):
    ref, port = pairs[name]
    rj, tj = ref["json"], port["json"]
    assert tj["backend"] == "torch" and rj["backend"] == "jax"
    for key in ("reads_mapped", "reads_skipped", "aligned_bases",
                "consensus_bases", "references", "references_with_output"):
        assert tj[key] == rj[key]
    # the registry's view beside the port's own keys, which win
    assert tj["pileup_path"] == "device"
    assert tj["accumulate_sec"] >= 0 and tj["render_sec"] >= 0
    assert tj["mem/peak_bytes/counts"] > 0
    assert "Run manifest written to " in port["log"]


def test_run_epilogue_host_counts(tmp_path):
    """Under ``--pileup host`` both CPU tails are the native vote, and
    the ``epilogue`` decision (made from the same inputs) is equal."""
    path = _gen_sam(str(tmp_path))
    r_mem._reset_for_tests()
    ref = _observed_run(r_cli.main, path, str(tmp_path / "r"),
                        ["--backend", "jax", "--shards", "1",
                         "--pileup", "host"])
    port = _observed_run(t_cli.main, path, str(tmp_path / "t"),
                         ["--pileup", "host"], device="cpu")
    assert port["fasta"] == ref["fasta"]
    rd = {d["decision"]: d for d in ref["manifest"]["decisions"]}
    td = {d["decision"]: d for d in port["manifest"]["decisions"]}
    assert td["epilogue"]["chosen"] == rd["epilogue"]["chosen"] == "host"
    assert td["tail_placement"]["chosen"] == "cpu"


def test_profile_dir_writes_cpu_profile(tmp_path):
    out = tmp_path / "o"
    argv = ["-i", os.path.join(DATA, "formats_short.sam"), "-o", str(out),
            "--pileup", "pallas", "--profile-dir", str(tmp_path / "prof"),
            "--quiet"]
    assert t_cli.main(argv, device="cpu") == 0
    (name,) = os.listdir(tmp_path / "prof")
    assert name.endswith(".pt.trace.json")
    events = json.load(open(tmp_path / "prof" / name))["traceEvents"]
    assert events and not any(e.get("cat") == "kernel" for e in events)


# -- --log-format json -----------------------------------------------------
@contextlib.contextmanager
def _captured_logger(obs, logger_name):
    logger = logging.getLogger(logger_name)
    saved = (list(logger.handlers), logger.level)
    logger.handlers = []
    try:
        obs.configure_logging(None, "json")
        buf = io.StringIO()
        logger.handlers[0].setStream(buf)
        yield logger, buf
    finally:
        logger.handlers, logger.level = saved[0], saved[1]


def test_log_format_json():
    """One JSON object a record, with the reference's fields: ts, level,
    logger, msg, the thread's log context and the innermost open span."""
    lines = {}
    for tag, obs, trace, tel, name in (
            ("ref", r_obs, r_trace, r_tel, "sam2consensus_tpu"),
            ("port", t_obs, t_trace, t_tel, "sam2consensus_torch")):
        with _captured_logger(obs, name) as (logger, buf):
            assert logger.level == logging.INFO
            tel.set_log_context(job_id="j1", tenant="", rung="host")
            try:
                with trace.Tracer(enabled=True).span("vote"):
                    logging.getLogger(name + ".x").info("hello %d", 3)
                logging.getLogger(name + ".x").debug("dropped")
            finally:
                tel.set_log_context()
        (line,) = buf.getvalue().splitlines()
        lines[tag] = json.loads(line)
    for tag, obj in lines.items():
        assert list(obj) == ["ts", "level", "logger", "msg", "job_id",
                             "rung", "span"]
        assert obj["msg"] == "hello 3" and obj["span"] == "vote"
        assert obj["level"] == "info" and obj["job_id"] == "j1"
    assert lines["port"]["logger"] == "sam2consensus_torch.x"


def test_log_flags_through_cli(tmp_path):
    """The CLI configures the port's logger from ``--log-level`` /
    ``--log-format``; a bad ``--log-format`` is refused at parse time."""
    logger = logging.getLogger("sam2consensus_torch")
    saved = (list(logger.handlers), logger.level)
    try:
        argv = ["-i", os.path.join(DATA, "formats_short.sam"),
                "-o", str(tmp_path / "o"), "--quiet", "--pileup", "pallas",
                "--log-level", "warning", "--log-format", "json"]
        assert t_cli.main(argv, device="cpu") == 0
        assert logger.level == logging.WARNING
        assert isinstance(logger.handlers[0].formatter,
                          t_tel.JsonLogFormatter)
    finally:
        logger.handlers, logger.level = saved[0], saved[1]
    with pytest.raises(SystemExit):
        t_cli.build_parser().parse_args(["-i", "x", "--log-format", "xml"])


# -- the memory plane ------------------------------------------------------
def _bound_run():
    """A run whose registry the test can lock, installed as current."""
    reg = TRegistry()
    return t_obs.start_run(prepared=t_obs.RunObservability(
        tracer=t_trace.Tracer(), registry=reg)), reg


def test_memplane_finalizer_takes_no_lock():
    """ROADMAP §C 2: a finalizer of a ``track_obj``-tracked tensor that
    runs while the thread holds the registry's lock returns at once (the
    reference's takes the same lock and deadlocks); its bytes are
    released at the next drain."""
    t_mem._reset_for_tests()
    robs, reg = _bound_run()
    done = threading.Event()
    try:
        holder = [torch.zeros(1000, dtype=torch.int32)]
        t_mem.track_obj("counts", holder[0], 4000)
        assert t_mem.summary()["families"]["counts"]["live_bytes"] == 4000

        class Dropper:
            """Drops the tracked tensor's last reference: its finalizer
            runs right there, inside the lock."""

            def __del__(self):
                holder.clear()

        def work():
            with reg._lock:
                d = Dropper()
                del d
            done.set()

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(timeout=10)
        assert done.is_set(), "the finalizer deadlocked on the lock"
        assert list(t_mem._released) == [("counts", 4000)]   # queued
        t_mem.adjust("counts", 0)                            # drained
        assert not t_mem._released
        fam = t_mem.summary()["families"]["counts"]
        assert fam == {"live_bytes": 0, "peak_bytes": 4000}
        assert reg.snapshot()["gauges"]["mem/live_bytes/counts"][
            "value"] == 0.0
    finally:
        t_obs.finish_run(robs)
        t_mem._reset_for_tests()


def test_memplane_gc_inside_gauge(monkeypatch):
    """The reference's hang exactly: a collection inside
    ``MetricsRegistry.gauge()`` (its allocation, under the registry's
    non-reentrant lock) frees a tracked tensor held by a reference
    cycle.  The port's finalizer only queues the release."""
    import sys

    # the module, not the package's ``metrics()`` accessor of that name
    t_metrics = sys.modules["sam2consensus_torch.observability.metrics"]
    t_mem._reset_for_tests()
    robs, reg = _bound_run()
    under_lock = []

    class CollectingGauge(t_metrics.Gauge):
        __slots__ = ()

        def __init__(self):
            gc.collect()              # the allocation's collection
            super().__init__()

    monkeypatch.setattr(t_metrics, "Gauge", CollectingGauge)
    done = threading.Event()

    def work():
        cycle = [torch.zeros(10)]
        cycle.append(cycle)
        t_mem.track_obj("insertion_table", cycle[0], 40)
        import weakref

        weakref.finalize(cycle[0],
                         lambda: under_lock.append(reg._lock.locked()))
        del cycle
        reg.gauge("allocates/under/the/lock")
        done.set()

    gc.disable()
    try:
        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(timeout=10)
        assert done.is_set(), "the finalizer deadlocked inside gauge()"
        assert under_lock == [True]
        assert list(t_mem._released) == [("insertion_table", 40)]
        t_mem.sample(device=torch.device("cpu"))          # drains
        assert t_mem.summary()["families"]["insertion_table"] == {
            "live_bytes": 0, "peak_bytes": 40}
    finally:
        gc.enable()
        t_obs.finish_run(robs)
        t_mem._reset_for_tests()


@pytest.mark.parametrize("mem", [r_mem, t_mem], ids=["ref", "port"])
def test_memplane_track_release_publishes(mem):
    """track/release publish the same live/peak gauges and ratchet in
    both packages (no finalizers involved)."""
    mem._reset_for_tests()
    reg_mod = r_obs if mem is r_mem else t_obs
    robs = reg_mod.start_run()
    try:
        mem.track("counts", 1000)
        mem.track("wire_staging", 500)
        mem.release("wire_staging", 500)
        mem.track("wire_staging", 200)
        snap = robs.registry.snapshot()
        g = {k: v["value"] for k, v in snap["gauges"].items()}
        assert g["mem/live_bytes/counts"] == 1000.0
        assert g["mem/peak_bytes/wire_staging"] == 500.0
        assert g["mem/live_bytes/wire_staging"] == 200.0
        assert g["mem/live_tracked_bytes"] == 1200.0
        assert snap["counters"]["mem/peak_tracked_bytes"] == 1500.0
    finally:
        reg_mod.finish_run(robs)
        mem._reset_for_tests()


def test_memplane_disabled(monkeypatch):
    """``S2C_MEMPLANE=0``: nothing tracked, nothing published."""
    t_mem._reset_for_tests()
    monkeypatch.setenv("S2C_MEMPLANE", "0")
    robs = t_obs.start_run()
    try:
        t_mem.track("counts", 1000)
        t_mem.sample(device=torch.device("cpu"))
        t_mem.record_capacity(1000, 1)
        snap = robs.registry.snapshot()
        assert not any(k.startswith("mem/") for k in snap["gauges"])
        assert robs.ledger.get("capacity") is None
    finally:
        t_obs.finish_run(robs)
        t_mem._reset_for_tests()


def test_memplane_device_stats_cpu():
    """No device statistics for the CPU, and none read from a process
    that has not initialised CUDA."""
    assert t_mem.device_memory_stats(torch.device("cpu")) is None
    if not torch.cuda.is_initialized():
        assert t_mem.device_memory_stats() is None
    s = t_mem.sample(registry=TRegistry(), device=torch.device("cpu"))
    assert "device_bytes_in_use" not in s and s["peak_rss_mb"] > 0


def test_capacity_prediction_components():
    from sam2consensus_torch.ops.pileup import padded_total_len

    total, comp = t_mem.predict_run_peak_bytes(
        10_000, n_thresholds=2, chunk_reads=1000, read_len=100)
    padded = padded_total_len(10_000)
    assert comp == {"counts_bytes": padded * 24,
                    "staging_bytes": 2 * 1024 * (4 + 128),
                    "plan_bytes": 1024 * (12 + 64),
                    "tail_bytes": 2 * padded,
                    "insertion_table_bytes": 0}
    assert total == sum(comp.values())
    host, hcomp = t_mem.predict_run_peak_bytes(
        10_000, host_counts=True, insertion_table_bytes=96)
    assert hcomp["counts_bytes"] == 10_000 * 24
    assert hcomp["staging_bytes"] == hcomp["plan_bytes"] == 0
    assert host == 10_000 * 24 + padded + 96


def test_dump_on_capacity(tmp_path):
    t_mem._reset_for_tests()
    robs = t_obs.start_run()
    try:
        t_mem.record_capacity(5000, 1)
        oom = RuntimeError("CUDA out of memory. Tried to allocate 2 GiB")
        path = t_mem.dump_on_capacity(oom, str(tmp_path),
                                      context={"backend": "torch"})
        assert path == str(tmp_path / "mem_dump.json")
        blob = json.load(open(path))
        assert blob["schema"] == "s2c-mem-dump/1"
        assert blob["error"]["classification"] == "capacity"
        assert blob["capacity"]["predicted_bytes"] > 0
        assert robs.registry.value("mem/oom_dumps") == 1
        assert t_mem.dump_on_capacity(ValueError("x"), str(tmp_path / "n")) \
            is None
    finally:
        t_obs.finish_run(robs)
        t_mem._reset_for_tests()


# -- the link probe's stale cache ------------------------------------------
@pytest.fixture
def link_cache(tmp_path, monkeypatch):
    path = tmp_path / "link.json"
    monkeypatch.setenv("S2C_LINK_CACHE", str(path))
    t_lp._reset_for_tests()
    yield path
    t_lp._reset_for_tests()


def test_link_cache_read_back_stale(link_cache):
    """A written cache is read back by a fresh probe state as
    ``stale-cache``, with no probe, and lands in the run's gauges."""
    t_lp._write_cache(t_lp.LinkProbe(20e-6, 40e9, 30e9))
    blob = json.load(open(link_cache))
    assert blob["bps"] == 30e9 and "measured_at" in blob
    robs = t_obs.start_run()
    try:
        got = t_lp.probe_link("cuda:0")
        assert got == t_lp.LinkProbe(20e-6, 40e9, 30e9)
        assert t_lp.link_info()["source"] == "stale-cache"
        g = robs.registry.snapshot()["gauges"]
        assert g["link/bps"]["value"] == 30e9
        assert g["link/stale"]["value"] == 1.0
        assert t_lp.probe_link("cuda:0") == got          # cached now
    finally:
        t_obs.finish_run(robs)
    # the reference reads the port's file alike
    from sam2consensus_tpu.utils import linkprobe as r_lp

    assert r_lp._read_cache()[:2] == (20e-6, 30e9)


def test_link_cache_corrupt_is_ignored(link_cache):
    link_cache.write_text("{not json")
    robs = t_obs.start_run(enabled=True)
    try:
        assert t_lp._read_cache() is None
        assert robs.registry.snapshot()["gauges"][
            "link/cache_corrupt"]["value"] == 1.0
        assert [s.name for s in robs.tracer.drain()] == \
            ["link/cache_corrupt"]
    finally:
        t_obs.finish_run(robs)


def test_link_cache_too_old_probes(link_cache, monkeypatch):
    """A cache older than ``S2C_LINK_CACHE_MAX_AGE`` is not taken in
    place of a probe; the fresh measurement is written back."""
    link_cache.write_text(json.dumps({"rt_sec": 1e-3, "bps": 1e8,
                                      "measured_at": time.time() - 100}))
    monkeypatch.setenv("S2C_LINK_CACHE_MAX_AGE", "10")
    fresh = t_lp.LinkProbe(15e-6, 38e9, 39e9)
    monkeypatch.setattr(t_lp, "_measure", lambda dev: fresh)
    assert t_lp.probe_link("cuda:0") == fresh
    assert t_lp.link_info()["source"] == "probed"
    assert json.load(open(link_cache))["bps"] == 38e9


def test_link_probe_timeout_serves_stale(monkeypatch):
    """``S2C_LINK_PROBE_TIMEOUT_S``: a hung probe is failed for the
    device and serves the last good constants (``stale-memory``)."""
    monkeypatch.delenv("S2C_LINK_CACHE", raising=False)
    t_lp._reset_for_tests()
    first = t_lp.LinkProbe(15e-6, 38e9, 39e9)
    monkeypatch.setattr(t_lp, "_measure", lambda dev: first)
    assert t_lp.probe_link("cuda:0") == first
    monkeypatch.setenv("S2C_LINK_PROBE_TIMEOUT_S", "0.05")
    release = threading.Event()
    monkeypatch.setattr(t_lp, "_measure",
                        lambda dev: release.wait(5) and first)
    robs = t_obs.start_run()
    try:
        got = t_lp.probe_link("cuda:1")
        assert got == first
        assert t_lp.link_info()["source"] == "stale-memory"
        g = robs.registry.snapshot()["gauges"]
        assert g["link/probe_failed"]["value"] == 1.0
        assert g["link/stale"]["value"] == 1.0
        assert t_lp.probe_link("cuda:1") == first       # remembered
    finally:
        release.set()
        t_obs.finish_run(robs)
        t_lp._reset_for_tests()


def test_link_cache_off_by_default(monkeypatch, tmp_path):
    monkeypatch.delenv("S2C_LINK_CACHE", raising=False)
    t_lp._reset_for_tests()
    monkeypatch.setattr(t_lp, "_measure",
                        lambda dev: t_lp.LinkProbe(1e-5, 1e10, 1e10))
    monkeypatch.chdir(tmp_path)
    try:
        t_lp.probe_link("cuda:0")
        assert os.listdir(tmp_path) == []
        assert t_lp._read_cache() is None
    finally:
        t_lp._reset_for_tests()


# -- the rate card ---------------------------------------------------------
@pytest.mark.parametrize("rc", [r_rc, t_rc], ids=["ref", "port"])
def test_rate_card_gates(rc, monkeypatch, tmp_path):
    """``S2C_RATECARD_MIN_SAMPLES`` and ``S2C_LINK_CACHE_MAX_AGE`` gate a
    learned rate alike in both packages; the card round-trips."""
    monkeypatch.setenv("S2C_RATECARD_MIN_SAMPLES", "2")
    card = rc.RateCard(worker="w", path=str(tmp_path / "card.json"))
    card.observe("link_bps", 1e9, now=1000.0)
    assert card.consult("link_bps", 5.0, now=1000.0) == (
        5.0, {"source": "default", "key": "link_bps", "n": 1,
              "age_sec": 0.0})
    card.observe("link_bps", 2e9, now=1001.0)
    value, prov = card.consult("link_bps", 5.0, now=1001.0)
    assert value == pytest.approx(1.3e9) and prov["source"] == "learned"
    monkeypatch.setenv("S2C_LINK_CACHE_MAX_AGE", "10")
    assert card.consult("link_bps", 5.0, now=1100.0)[0] == 5.0
    card.save(now=1001.0)
    again = rc.RateCard.load(str(tmp_path / "card.json"))
    assert again.restarts == 1 and again.rate("link_bps", now=1001.0) \
        == pytest.approx(1.3e9)
    rc.install(card)
    try:
        assert rc.consult("link_bps", 5.0, now=1001.0)[1]["source"] \
            == "learned"
    finally:
        rc.install(None)
    assert rc.consult("link_bps", 5.0) == (5.0, {"source": "default",
                                                 "key": "link_bps"})


# -- the kernel build's cache counters -------------------------------------
def test_kernel_build_cache_counters(tmp_path):
    lib = tmp_path / "ext.so"
    robs = t_obs.start_run()
    try:
        t_jitcache.counted_load(lambda: lib.write_bytes(b"x") or "m",
                                str(lib))
        assert t_jitcache.counted_load(lambda: "m", str(lib)) == "m"
        c = robs.registry.snapshot()["counters"]
        assert c["compile/persist_miss"] == 1
        assert c["compile/persist_hit"] == 1
    finally:
        t_obs.finish_run(robs)


# -- the RunConfig fields the port now runs --------------------------------
@pytest.mark.parametrize("field,value", [
    ("profile_dir", "prof"), ("json_metrics", "m.json"),
    ("trace_out", "t.json"), ("metrics_out", "m.jsonl"),
    ("log_level", "info"), ("log_format", "json")])
def test_observability_field_runs(tmp_path, field, value):
    """The six observability fields no longer raise; ``trace_out`` and
    ``metrics_out`` write their artifacts from ``TorchBackend.run``
    itself (the other four are the CLI's)."""
    text = simulate(SimSpec(n_contigs=1, contig_len=200, n_reads=60,
                            read_len=30, seed=3))
    handle = io.StringIO(text)
    contigs, _n, first = t_read_header(handle)
    path = str(tmp_path / value)
    cfg = TConfig(backend="torch", prefix="p", pileup="pallas",
                  **{field: path if field.endswith(("_dir", "_out",
                                                    "_metrics"))
                     else value})
    res = TorchBackend("cpu").run(contigs, TReadStream(handle, first), cfg)
    assert res.fastas
    if field == "trace_out":
        assert json.load(open(path))["traceEvents"]
    if field == "metrics_out":
        assert t_obs.read_metrics_jsonl(path)[0]["backend"] == "torch"
        assert os.path.exists(path + ".manifest.json")


# -- the recovery events against the reference -----------------------------
def _fault_trace(tmp_path, tag, spec, per_side=None, **kw) -> dict:
    """The recovery events (``resilience/*``, ``fault/*``,
    ``checkpoint/*``) of one traced port run and one traced
    ``--backend jax`` run of the same input and fault spec, by name."""
    from collections import Counter

    from sam2consensus_tpu.backends.jax_backend import JaxBackend
    from sam2consensus_tpu.config import RunConfig as RConfig
    from sam2consensus_tpu.io.sam import ReadStream as RReadStream
    from sam2consensus_tpu.io.sam import read_header as r_read_header

    text = simulate(SimSpec(n_contigs=2, contig_len=300, n_reads=600,
                            read_len=40, ins_read_rate=0.12, seed=5))
    base = dict(prefix="p", decoder="py", pileup="pallas",
                ins_kernel="pallas", chunk_reads=128, retry_backoff=0.001,
                fault_inject=spec, **kw)
    got = {}
    for side, backend, config, header, stream in (
            ("port", TorchBackend("cpu"), TConfig, t_read_header,
             TReadStream),
            ("ref", JaxBackend(), RConfig, r_read_header, RReadStream)):
        handle = io.StringIO(text)
        contigs, _n, first = header(handle)
        trace = str(tmp_path / f"{tag}_{side}.json")
        extra = {"shards": 1} if side == "ref" else {}
        extra.update((per_side or {}).get(side, {}))
        res = backend.run(contigs, stream(handle, first),
                          config(backend="torch" if side == "port"
                                 else "jax", trace_out=trace, **base,
                                 **extra))
        events = json.load(open(trace))["traceEvents"]
        got[side] = (Counter(e["name"] for e in events if e["ph"] == "i"
                             and e["name"].startswith(
                                 ("resilience/", "fault/", "checkpoint/"))),
                     res)
        gc.collect()
    return got


@pytest.mark.parametrize("spec,kw", [
    ("pileup_dispatch:rpc:1:2", {}),
    ("accumulate:fatal:1:inf", {"on_device_error": "fallback"}),
    ("vote:fatal:0:inf", {"on_device_error": "fallback"}),
], ids=["retry", "pileup-demotion", "tail-demotion"])
def test_recovery_events_match_reference(tmp_path, spec, kw):
    got = _fault_trace(tmp_path, "f", spec, **kw)
    port, ref = got["port"][0], got["ref"][0]
    assert port == ref and port["fault/injected"] > 0
    assert port["resilience/retry"] + port["resilience/demotion"] > 0
    assert port["resilience/retry"] == \
        got["port"][1].stats.extra.get("resilience/retries", 0)


def test_checkpoint_corrupt_event(tmp_path):
    """A corrupt checkpoint is counted and traced alike."""
    from sam2consensus_torch.utils import checkpoint as t_ckpt

    dirs = {}
    for side in ("port", "ref"):
        dirs[side] = {"checkpoint_dir": str(tmp_path / f"ck_{side}")}
        os.makedirs(dirs[side]["checkpoint_dir"])
        with open(t_ckpt.path_for(dirs[side]["checkpoint_dir"]), "wb") as fh:
            fh.write(b"not a zip file")
    got = _fault_trace(tmp_path, "c", "", per_side=dirs)
    assert got["port"][0] == got["ref"][0] == {"checkpoint/corrupt": 1}
    assert got["port"][1].stats.extra["checkpoint/corrupt"] == 1
