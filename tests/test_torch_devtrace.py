"""The port's tracer on the device trace's clock
(``sam2consensus_torch/observability/devtrace.py``), on the CPU.

* With no profiler running and the tracer disabled, ``span()`` reads the
  profiler's flag once and returns the reference's shared null span, at
  the reference's "disabled is free" cost.
* Under ``torch.profiler`` a span is a ``user_annotation`` event of its
  name, with the tracer disabled or enabled; when enabled it is in
  ``Tracer.drain()`` as well, its args, events and ``sync`` unchanged.
* Every tracer ``observability`` builds is the bridged one, and importing
  the package still loads no torch.
* A served two-job queue and its FASTA writes, under the profiler, put
  the serving thread's leaf spans on one thread, none inside another.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sam2consensus_torch import observability as obs
from sam2consensus_torch.observability import devtrace, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the serving thread's leaf spans in a served K1 job's path
SERVE_LEAVES = ("batch_wait", "ahead_wait", "pileup_dispatch", "tail",
                "render", "finalize", "fasta_write")


@pytest.fixture(autouse=True, scope="module")
def _no_collection_inside_the_file():
    """No automatic collection while this file runs, and one collection
    after it, so that the profiles and the served queue leave a worker
    process as they found it (the JAX package's registry lock and memplane
    finalizers deadlock under a collection, ROADMAP §C 2)."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
        gc.collect()


def annotations(prof, tmp_path) -> list:
    """The profile's ``user_annotation`` events, as the exported Chrome
    trace holds them (what a profile's reader sees)."""
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# -- the flag and the null span ---------------------------------------------
class _CountingFlag:
    """A stand-in for ``torch.autograd.profiler`` counting flag reads."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return False


def test_off_and_disabled_reads_the_flag_once(monkeypatch):
    flag = _CountingFlag()
    monkeypatch.setattr(devtrace, "_profiler_mod", flag)
    tr = devtrace.DeviceTracer(enabled=False)
    assert tr.span("x") is trace._NULL_SPAN
    assert flag.reads == 1
    assert tr.span("y", sync=lambda: None, k=1) is trace._NULL_SPAN
    assert flag.reads == 2


def test_off_and_disabled_is_free():
    tr = devtrace.DeviceTracer(enabled=False)
    assert not torch.autograd.profiler._is_profiler_enabled
    with tr.span("x") as sp:
        sp.event("e", a=1)
        sp.set_args(b=2)
    assert tr.span("a") is tr.span("b") is trace._NULL_SPAN
    assert tr.drain() == []
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


def test_enabled_without_profiler_is_the_reference_span():
    tr = devtrace.DeviceTracer(enabled=True)
    sp = tr.span("phase", k=1)
    assert isinstance(sp, trace._LiveSpan)
    with sp:
        pass
    (s,) = tr.drain()
    assert s.name == "phase" and s.args == {"k": 1}


def test_the_null_span_returns_after_the_profile(tmp_path):
    tr = devtrace.DeviceTracer(enabled=False)
    with cpu_profile():
        assert tr.span("inside") is not trace._NULL_SPAN
    assert tr.span("after") is trace._NULL_SPAN


# -- under the profiler -----------------------------------------------------
def test_profiler_on_tracer_disabled(tmp_path):
    tr = devtrace.DeviceTracer(enabled=False)
    with cpu_profile() as prof:
        with tr.span("bridge_only", k=1) as sp:
            sp.event("e", a=1)
            sp.set_args(b=2)
            time.sleep(0.002)
    names = [e["name"] for e in annotations(prof, tmp_path)]
    assert names.count("bridge_only") == 1
    assert tr.drain() == []


def test_profiler_and_tracer_on(tmp_path):
    tr = devtrace.DeviceTracer(enabled=True)
    ran = []
    with cpu_profile() as prof:
        with tr.span("both", kind="phase") as sp:
            sp.event("decision", chosen="cpu")
            sp.set_args(rows=7)
            with tr.span("device", sync=lambda: (time.sleep(0.003),
                                                 ran.append(True))):
                pass
    ann = {e["name"]: e for e in annotations(prof, tmp_path)}
    assert {"both", "device"} <= set(ann)
    # the sync runs inside the profiler's range too
    assert ran == [True] and ann["device"]["dur"] >= 2500
    spans = {s.name: s for s in tr.drain()}
    assert spans["both"].args == {"kind": "phase", "rows": 7}
    assert spans["both"].events[0][0] == "decision"
    assert spans["device"].dur_us >= 2500
    assert trace.current_span_name() is None


def test_bridged_span_unwinds_an_exception(tmp_path):
    tr = devtrace.DeviceTracer(enabled=True)
    ran = []
    with cpu_profile() as prof:
        with pytest.raises(KeyError):
            with tr.span("fails", sync=lambda: ran.append(True)):
                raise KeyError("x")
        with tr.span("next"):
            pass
    names = [e["name"] for e in annotations(prof, tmp_path)]
    assert names.count("fails") == 1 and names.count("next") == 1
    assert ran == [] and [s.name for s in tr.drain()] == ["fails", "next"]


def test_a_thread_started_before_the_profile_is_bridged_safely(tmp_path):
    """A span on another thread under the profiler closes cleanly whether
    or not that thread's events are recorded."""
    tr = devtrace.DeviceTracer(enabled=True)
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait()
        with tr.span("worker"):
            pass
        done.set()

    t = threading.Thread(target=work)
    t.start()
    with cpu_profile():
        go.set()
        assert done.wait(30)
    t.join(30)
    assert [s.name for s in tr.drain()] == ["worker"]


# -- the package's tracers --------------------------------------------------
def test_every_tracer_is_bridged():
    assert isinstance(obs._disabled_tracer, devtrace.DeviceTracer)
    assert isinstance(obs.tracer(), devtrace.DeviceTracer)
    prepared = obs.prepare_run()
    assert isinstance(prepared.tracer, devtrace.DeviceTracer)
    assert not prepared.tracer.enabled
    robs = obs.start_run(enabled=True)
    try:
        assert obs.tracer() is robs.tracer
        assert isinstance(robs.tracer, devtrace.DeviceTracer)
        assert robs.tracer.enabled
    finally:
        obs.finish_run(robs)
    assert obs.tracer() is obs._disabled_tracer


def test_importing_the_package_loads_no_torch():
    code = ("import sys; import sam2consensus_torch.observability, "
            "sam2consensus_torch.io.fasta; print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


# -- the serving thread's leaves --------------------------------------------
def _sample(tmp_path, k: int) -> str:
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    path = str(tmp_path / f"s{k}.sam")
    with open(path, "w") as fh:
        fh.write(simulate(SimSpec(n_contigs=1, contig_len=3000,
                                  n_reads=1200, read_len=100,
                                  contig_len_jitter=0.0, seed=31 + k,
                                  contig_prefix="dev")))
    return path


def test_served_jobs_put_leaf_spans_on_the_serving_thread(tmp_path):
    from sam2consensus_torch.cli import build_serve_parser, config_from_args
    from sam2consensus_torch.io.fasta import write_outputs
    from sam2consensus_torch.serve import ServeRunner
    from sam2consensus_torch.serve.runner import JobSpec

    specs = []
    for k in range(2):
        path = _sample(tmp_path, k)
        out = str(tmp_path / f"out{k}") + os.sep
        os.makedirs(out)
        args = build_serve_parser().parse_args(
            ["-i", path, "-o", out, "--pileup", "pallas"])
        args.filename, args.prefix = path, ""
        specs.append(JobSpec(path, config_from_args(args), job_id=f"j{k}"))
    runner = ServeRunner(device="cpu", prewarm="off")
    try:
        runner.submit_jobs(specs)          # every shape built before
        with cpu_profile() as prof:
            results = runner.submit_jobs(specs)
            for spec, res in zip(specs, results):
                assert res.ok, res.error
                write_outputs(res.fastas, spec.config.outfolder,
                              spec.config.prefix, spec.config.nchar,
                              spec.config.thresholds,
                              echo=lambda *a, **k: None)
    finally:
        runner.close()
    leaves = [e for e in annotations(prof, tmp_path)
              if e["name"] in SERVE_LEAVES]
    assert {e["name"] for e in leaves} == set(SERVE_LEAVES)
    assert len({e["tid"] for e in leaves}) == 1
    for name in ("tail", "render", "finalize", "fasta_write"):
        assert sum(e["name"] == name for e in leaves) == 2, name
    assert sum(e["name"] == "ahead_wait" for e in leaves) == 1
    leaves.sort(key=lambda e: e["ts"])
    for a, b in zip(leaves, leaves[1:]):
        assert b["ts"] >= a["ts"] + a["dur"] - 0.5, \
            f"{b['name']} opens inside {a['name']}"
