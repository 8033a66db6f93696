"""The port's serve telemetry plane on the CPU, held against the JAX package.

A served queue's OpenMetrics exposition has the reference's families
(less the JAX-only and plus the port-only ones listed below, each with
its reason) and passes the port's ``lint_openmetrics``, across two
scrapes too; the exposition renderer, parser and lint are the
reference's on the same inputs.  The localhost endpoint serves
``/metrics`` and ``/healthz`` (which names the in-flight job while a
job hangs), ``--telemetry-out`` and ``--health-out`` are written, SLO
breaches burn per tenant into the health snapshot and the job's
manifest, a touch-file profiler capture writes its span dump, and a
journaled server persists its rate card and publishes the scale hint.
"""

import gc
import json
import os
import threading
import time
import urllib.request

import pytest

from sam2consensus_torch.config import RunConfig as TConfig
from sam2consensus_torch.observability import telemetry as t_tel
from sam2consensus_tpu.observability import telemetry as r_tel
from test_torch_serve import runner, sim

#: families only the reference's CPU run exposes: JAX's retrace and
#: compile-cache counters (eager PyTorch has no trace to count); its
#: prefetch thread's staging pipeline (the port stages only to a CUDA
#: card); its link-constants decision (the port's CPU device has no
#: link to price); its host render epilogue (the port's CPU tail renders
#: in the fused device call)
JAX_ONLY = {
    "s2c_compile_jit_cache_hit_total", "s2c_compile_jit_cache_miss_total",
    "s2c_compile_jit_traces_total",
    "s2c_pipeline_backpressure_sec_total", "s2c_pipeline_overlap",
    "s2c_pipeline_overlap_sec_total", "s2c_residual_link_constants",
    "s2c_epilogue_host_tails_total",
}
#: the reference's per-shape retrace counters (one family a traced shape)
JAX_ONLY_PREFIX = "s2c_compile_trace_"
#: ... and only the port's: the fused call's device epilogue
PORT_ONLY = {"s2c_epilogue_device_tails_total"}


@pytest.fixture(autouse=True)
def _collect_jax_garbage(monkeypatch):
    """No automatic collection during a test (ROADMAP §C 2); no JAX
    persistent compilation cache, also where an earlier test of this
    process turned it on: a program that another process wrote there
    loads as a hit and adds the reference's ``compile/persist_hit``
    family, which a fresh process never shows."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    monkeypatch.setenv("S2C_JIT_CACHE", "")
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()
        jax.config.update("jax_enable_compilation_cache", was)
        compilation_cache.reset_cache()


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def _served_exposition(tmp_path, tag, paths, **kw):
    if tag == "t":
        from sam2consensus_torch.serve import JobSpec

        srv = runner(**kw)
        specs = [JobSpec(p, TConfig(pileup="scatter")) for p in paths]
    else:
        from sam2consensus_tpu.config import RunConfig
        from sam2consensus_tpu.serve import JobSpec, ServeRunner

        srv = ServeRunner(prewarm="off", persistent_cache=False, **kw)
        specs = [JobSpec(p, RunConfig(backend="jax", shards=1,
                                      pileup="scatter")) for p in paths]
    try:
        res = srv.submit_jobs(specs)
        first = srv.render_telemetry()
        second = srv.render_telemetry()
    finally:
        srv.close()
    assert all(x.ok for x in res)
    return first, second, srv


def test_exposition_families_equal_reference_and_lint(tmp_path,
                                                     monkeypatch):
    # a family that a phase's wall time decides would differ between the
    # two runs by the host's load alone: no seconds residual may drift
    # (the drift families), and every job breaches the decode objective
    monkeypatch.setenv("S2C_DRIFT_MIN_SEC", "1e9")
    paths = [sim(tmp_path, f"a{k}.sam", 5 + k, ins_read_rate=0.2)
             for k in range(2)]
    slo = "e2e=60s,decode=1e-9s"
    t1, t2, _srv = _served_exposition(tmp_path, "t", paths, slo=slo)
    r1, _r2, _ = _served_exposition(tmp_path, "r", paths, slo=slo)
    assert t_tel.lint_openmetrics(t1) == []
    assert t_tel.lint_openmetrics(t2, prev=t1) == []
    got, want = _families(t1), _families(r1)
    missing = {f for f in want - got
               if not f.startswith(JAX_ONLY_PREFIX)} - JAX_ONLY
    extra = got - want - PORT_ONLY
    assert not missing and not extra, (
        f"want - got: {sorted(missing)}; got - want: {sorted(extra)}")
    for fam in ("s2c_slo_phase_seconds", "s2c_slo_violations_total",
                "s2c_serve_jobs_total", "s2c_serve_overlap_sec_total",
                "s2c_burn_rate", "s2c_burn_alert_state",
                "s2c_process_start_time_seconds", "s2c_rate",
                "s2c_mem_rss_mb"):
        assert fam in got, fam
    samples = {(s["name"], tuple(sorted(s["labels"].items())))
               for s in t_tel.parse_openmetrics(t1)}
    assert ("s2c_slo_violations_total",
            (("phase", "decode"), ("tenant", "default"))) in samples


def test_render_parse_lint_equal_reference():
    from sam2consensus_torch.observability.metrics import \
        MetricsRegistry as TReg
    from sam2consensus_tpu.observability.metrics import \
        MetricsRegistry as RReg

    out = []
    for tel, reg_cls in ((t_tel, TReg), (r_tel, RReg)):
        reg = reg_cls()
        reg.add("phase/decode_sec", 0.25)
        reg.add("slo/violations/acme/e2e", 2)
        reg.add("serve/jobs", 3)
        reg.gauge("mem/live_bytes/counts").set(96)
        reg.gauge("rate/mean/decode_mbps_per_core").set(300.5)
        reg.gauge("burn/state/acme").set(1)
        reg.gauge('odd"name\n').set(1)
        for v in (0.1, 0.2, 0.4):
            reg.observe("slo/acme/e2e", v)
        text = tel.render_openmetrics(reg.snapshot(), worker="w1",
                                      restart_epoch=2)
        bad = text.replace("# EOF\n", "") + "x_total{a=\"1\"} -1\n"
        out.append((text, tel.parse_openmetrics(text),
                    tel.lint_openmetrics(text), tel.lint_openmetrics(bad),
                    tel.lint_openmetrics(text.replace(" 3\n", " 1\n"),
                                         prev=text)))
    assert out[0] == out[1]


@pytest.mark.parametrize("spec", ["e2e=5s,queue=1s", "decode=250ms",
                                  "e2e=0", "bogus=1s", "e2e=fast", "x",
                                  None, ""])
def test_parse_slo_equals_reference(spec):
    def outcome(tel):
        try:
            return tel.parse_slo(spec)
        except ValueError as exc:
            return str(exc)

    assert outcome(t_tel) == outcome(r_tel)


def test_aggregate_fold_equals_reference():
    from sam2consensus_torch.observability.metrics import \
        MetricsRegistry as TReg
    from sam2consensus_tpu.observability.metrics import \
        MetricsRegistry as RReg

    snaps = []
    for tel, reg_cls in ((t_tel, TReg), (r_tel, RReg)):
        agg = tel.AggregateRegistry()
        for k in range(3):
            job = reg_cls()
            job.add("phase/vote_sec", 0.5 + k)
            job.add("serve/overlap_sec", 1.0)         # runner-owned
            job.gauge("dispatch/pileup").set_info({"path": "device"})
            for v in range(50):
                job.observe("pileup/slab_sec/pallas", v / 100 + k)
            agg.fold(job, job_id=f"j{k}", tenant="t")
        snap = agg.snapshot()
        snap["gauges"]["dispatch/pileup"]["info"].pop("updated_unix")
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_endpoint_and_files_while_a_job_hangs(tmp_path, monkeypatch):
    """``/metrics`` and ``/healthz`` on an ephemeral localhost port,
    scraped while job 2 hangs under the watchdog: the health names the
    in-flight job, the exposition lints clean; ``--telemetry-out`` and
    ``--health-out`` are written."""
    from sam2consensus_torch.serve import JobSpec

    monkeypatch.setenv("S2C_FAULT_HANG_S", "3")
    before = set(threading.enumerate())
    paths = [sim(tmp_path, f"h{k}.sam", 50 + k) for k in range(3)]
    hang = TConfig(pileup="pallas", fault_inject="job_hang:timeout:0:1")
    tel_out = str(tmp_path / "metrics.prom")
    health_out = str(tmp_path / "health.json")
    srv = runner(telemetry_port=0, stall_timeout=1.5,
                 telemetry_out=tel_out, health_out=health_out,
                 telemetry_interval=0.2)
    port = srv.http.port
    seen = []

    def scrape():
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                health = json.loads(r.read())
            if health["in_flight"] == "job1:h1.sam":
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=5) as r:
                    seen.append((health, r.read().decode()))
                return
            time.sleep(0.05)

    th = threading.Thread(target=scrape)
    try:
        th.start()
        res = srv.submit_jobs([JobSpec(paths[0], TConfig(pileup="pallas")),
                               JobSpec(paths[1], hang),
                               JobSpec(paths[2], TConfig(pileup="pallas"))])
        th.join(30)
    finally:
        srv.close()
        for t in threading.enumerate():
            if t.name.startswith("serve-job-") and t not in before:
                t.join(60)
    assert [x.ok for x in res] == [True, False, True]
    [(health, text)] = seen
    assert health["schema"] == "s2c-health/1"
    assert health["in_flight_sec"] >= 0
    assert t_tel.lint_openmetrics(text) == []
    assert "s2c_serve_heartbeat_age_sec" in _families(text)
    assert t_tel.lint_openmetrics(open(tel_out).read()) == []
    assert json.load(open(health_out))["jobs"]["failed"] == 1


def test_slo_burn_reaches_health_and_manifest(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"s{k}.sam", 60 + k) for k in range(2)]
    mbase = str(tmp_path / "m")
    srv = runner(slo="e2e=1ms")
    try:
        res = srv.submit_jobs([JobSpec(p, TConfig(
            pileup="pallas", metrics_out=f"{mbase}{k}.jsonl"))
            for k, p in enumerate(paths)])
        snap = srv.health_snapshot()
    finally:
        srv.close()
    assert all(x.ok for x in res)
    assert srv.registry.value("slo/violations") == 2
    assert snap["slo"]["violations"] == 2
    assert snap["slo"]["burn_by_tenant"] == {"default": 2}
    assert snap["burn"]["tenants"]["default"]["state"] in ("warn", "page")
    man = json.load(open(f"{mbase}1.jsonl.manifest.json"))
    assert man["serve"]["slo"]["violated"] == ["e2e"]


def test_profiler_capture_touch_file_span_dump(tmp_path):
    from sam2consensus_torch.serve import JobSpec

    path = sim(tmp_path, "p.sam", 70)
    cap = tmp_path / "cap"
    cap.mkdir()
    (cap / t_tel.CAPTURE_TOUCH_NAME).write_text("")
    srv = runner(profile_capture_dir=str(cap))
    try:
        [res] = srv.submit_jobs([JobSpec(path, TConfig(pileup="pallas"))])
    finally:
        srv.close()
    assert res.ok
    assert srv.registry.value("telemetry/profile_captures") == 1
    [dest] = [d for d in os.listdir(cap)
              if d.startswith("profile_capture_")]
    dump = json.load(open(cap / dest / "span_dump.json"))
    assert dump["schema"] == "s2c-profile-capture/1"
    assert dump["mode"] == "span_dump"          # the CPU device
    assert dump["threads"]
    assert not (cap / t_tel.CAPTURE_TOUCH_NAME).exists()


def test_journaled_server_keeps_rate_card_and_scale_hint(tmp_path):
    from sam2consensus_torch.observability import ratecard
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"c{k}.sam", 80 + k) for k in range(3)]
    jdir = str(tmp_path / "j")
    out = str(tmp_path / "o") + "/"
    os.makedirs(out)
    srv = runner(journal_dir=jdir)
    try:
        res = srv.submit_jobs([JobSpec(p, TConfig(pileup="pallas",
                                                  outfolder=out))
                               for p in paths])
    finally:
        srv.close()
    assert all(x.ok for x in res)
    card = ratecard.RateCard.load(ratecard.card_path(jdir, "serve"))
    rates = card.snapshot()["rates"]
    assert rates["warm_jobs_per_sec"]["n"] == 3
    hint = srv.registry.info("fleet/scale_hint")
    assert hint is not None and hint["verdict"] in ("hold", "up", "down")
    assert ratecard.installed() is None         # close() uninstalled it
