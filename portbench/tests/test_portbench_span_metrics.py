"""The readers of the port's serving-thread spans in the device trace:
each sums its span's ``user_annotation`` events over the profiled queue
and divides by its jobs, found by its ``BENCHMARK.json`` name."""

from types import SimpleNamespace

import pytest

from portbench.harness import manifest
from portbench.harness.trace import Profile

#: metric -> the span it reads
SPANS = {"serve.batch_wait_s_per_job": "batch_wait",
         "serve.ahead_wait_s_per_job": "ahead_wait",
         "serve.finalize_s_per_job": "finalize",
         "fasta.write_s_per_job": "fasta_write"}


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


def window(events, jobs=4):
    p = Profile(events)
    p.jobs = [object()] * jobs
    return SimpleNamespace(profile=p)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_sums_its_span_over_the_jobs(metric):
    span = SPANS[metric]
    others = [ev(n, 0.0, 9e6) for n in SPANS.values() if n != span]
    w = window([ev(span, 10.0, 1500.0), ev(span, 2000.0, 2500.0),
                # the same name on the card's timeline is not the host's
                ev(span, 10.0, 7e6, cat="gpu_user_annotation"),
                ev(span, 10.0, 7e6, cat="cpu_op"),
                ev("pileup_rows_kernel", 5.0, 8e6, cat="kernel"),
                *others], jobs=4)
    assert manifest.reader(metric)(w) == pytest.approx(4000e-6 / 4)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_none_without_a_profile_or_its_span(metric):
    read = manifest.reader(metric)
    assert read(SimpleNamespace(profile=None)) is None
    others = [ev(n, 0.0, 100.0) for n in SPANS.values() if n != SPANS[metric]]
    assert read(window(others)) is None
    assert read(window([ev(SPANS[metric], 0.0, 100.0)], jobs=0)) is None


def test_each_is_an_entry_of_the_benchmark():
    bench = manifest.load_benchmark()
    per = {m["name"]: m for m in bench["per_layer"]}
    for metric in SPANS:
        m = per[metric]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("s", "lower", "program_span", "device_ms_per_gbase")
        assert m["workloads"] == ["artic_deep.sam", "ecoli_wgs.sam"]
        assert callable(manifest.reader(metric))
    for cell in ("artic_deep.sam", "ecoli_wgs.sam"):
        assert set(SPANS) <= {m["name"] for m in
                              manifest.cell(cell).per_layer}


def test_host_rate_over_the_unprofiled_queues():
    read = manifest.reader("serve.read_mbases_per_s")
    samples = [SimpleNamespace(aligned_bases=3e6),
               SimpleNamespace(aligned_bases=1e6)]
    jobs = [SimpleNamespace(sample=0), SimpleNamespace(sample=1),
            SimpleNamespace(sample=0)]
    w = SimpleNamespace(samples=samples, jobs=jobs, unprofiled_s=2.0)
    assert read(w) == pytest.approx(3.5)
    assert read(SimpleNamespace(samples=samples, jobs=[],
                                unprofiled_s=2.0)) is None
    assert read(SimpleNamespace(samples=samples, jobs=jobs,
                                unprofiled_s=0.0)) is None
