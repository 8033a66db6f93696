"""The port's flight recorder equals the JAX package's on the same events.

``sam2consensus_torch/observability/flight.py`` is a copy (pinned by
``tests/test_torch_copies.py``); these tests hold its behaviour: the same
journal event lists assemble into the same per-job tracks, scheduler
metrics, Chrome events, validation verdicts, critical paths and session
wave tracks in both packages, for hand-built lineages (a SIGKILL steal, a
fenced zombie commit, a claim race, a serial journal, a session with a
steal and a torn wave) and for a journal that the port's fleet protocol
wrote.
"""

import dataclasses
import time

import pytest

from sam2consensus_torch.observability import flight as t_flight
from sam2consensus_tpu.observability import flight as r_flight


def _ev(seq, ev, key, t, **kw):
    return {"schema": "s2c-journal/1", "seq": seq, "ev": ev,
            "key": key, "t": t, **kw}


def _sigkill(ttl=2.5):
    return [
        _ev(1, "submitted", "k", 100.0, job="x", tenant="ta"),
        _ev(2, "claimed", "k", 100.1, worker="w1",
            expires_unix=100.1 + ttl),
        _ev(3, "started", "k", 100.15, job="x", worker="w1"),
        _ev(4, "lease_renewed", "k", 101.0, worker="w1",
            expires_unix=101.0 + ttl),
        _ev(5, "lease_expired", "k", 103.6, worker="w1", reaper="w2"),
        _ev(6, "claimed", "k", 103.7, worker="w2",
            expires_unix=103.7 + ttl),
        _ev(7, "started", "k", 103.8, job="x", worker="w2"),
        _ev(8, "committed", "k", 104.9, job="x", worker="w2",
            claim_seq=6, outputs={}),
    ]


def _zombie():
    evs = _sigkill()
    evs.insert(7, _ev(9, "committed", "k", 104.0, job="x", worker="w1",
                      claim_seq=2, outputs={}))
    return evs


def _race():
    return [
        _ev(1, "submitted", "k", 10.0, job="x"),
        _ev(2, "claimed", "k", 10.1, worker="wa", expires_unix=70.0),
        _ev(3, "claimed", "k", 10.1, worker="wb", expires_unix=70.0),
        _ev(4, "started", "k", 10.2, job="x", worker="wa"),
        _ev(5, "committed", "k", 11.0, job="x", worker="wa",
            claim_seq=2, outputs={}),
    ]


def _serial():
    return [
        _ev(1, "submitted", "k", 5.0, job="x"),
        _ev(2, "started", "k", 5.4, job="x"),
        _ev(3, "committed", "k", 6.0, job="x", outputs={}),
        _ev(4, "submitted", "k2", 5.0, job="y", tenant="tb"),
        _ev(5, "started", "k2", 6.1, job="y"),
        _ev(6, "failed", "k2", 6.5, job="y", error="boom"),
    ]


def _session():
    return [
        _ev(1, "claimed", "s-1", 1.0, job="s-1", worker="w0",
            expires_unix=31.0),
        _ev(2, "session_open", "s-1", 1.1, tenant="t", header_sha="h",
            refs=1),
        _ev(3, "wave_received", "s-1", 1.2, wave=1, sha="a", reads=10,
            bytes=100),
        _ev(4, "wave_absorbed", "s-1", 1.5, wave=1, sha="a",
            reads_total=10, digest="d1", worker="w0", claim_seq=1),
        _ev(5, "wave_received", "s-1", 1.6, wave=2, sha="b", reads=10,
            bytes=100),
        _ev(6, "wave_rejected", "s-1", 1.7, wave=2, reason="torn"),
        _ev(7, "wave_received", "s-1", 1.8, wave=3, sha="c", reads=12,
            bytes=120),
        _ev(8, "lease_expired", "s-1", 40.0, worker="w0", reaper="w1"),
        _ev(9, "claimed", "s-1", 40.1, job="s-1", worker="w1",
            expires_unix=70.1),
        _ev(10, "wave_absorbed", "s-1", 40.5, wave=3, sha="c",
            reads_total=22, digest="d3", worker="w1", claim_seq=9),
        _ev(11, "session_stable", "s-1", 40.6, wave=3, digest="d3",
            waves_stable=1),
        _ev(12, "session_closed", "s-1", 41.0, digest="d3", outputs={},
            reads_total=22, worker="w1", claim_seq=9),
    ]


LINEAGES = {"sigkill": _sigkill, "zombie": _zombie, "race": _race,
            "serial": _serial, "session": _session}


def _assembled(flight, events):
    jobs = flight.assemble([dict(e) for e in events])
    return jobs, {k: dataclasses.asdict(v) for k, v in jobs.items()}


@pytest.mark.parametrize("name", sorted(LINEAGES))
def test_assemble_and_sched_metrics_equal_reference(name):
    events = LINEAGES[name]()
    t_jobs, t_view = _assembled(t_flight, events)
    r_jobs, r_view = _assembled(r_flight, events)
    assert t_view == r_view
    assert t_flight.sched_metrics(t_jobs) == r_flight.sched_metrics(r_jobs)
    phases = {"phase/decode_sec": 0.5, "phase/accumulate_sec": 1.0,
              "phase/vote_sec": 0.25}
    for key in t_jobs:
        for ph in (None, phases):
            assert t_flight.critical_path(t_jobs[key], ph) == \
                r_flight.critical_path(r_jobs[key], ph)
    by_tid = {jl.tid: phases for jl in t_jobs.values()}
    assert t_flight.wall_report(t_jobs, by_tid) == \
        r_flight.wall_report(r_jobs, by_tid)
    assert t_flight.session_wave_tracks(events) == \
        r_flight.session_wave_tracks(events)


@pytest.mark.parametrize("name", sorted(LINEAGES))
def test_chrome_events_and_validate_equal_reference(name):
    events = LINEAGES[name]()
    blob = {"traceEvents": [{"ph": "X", "tid": 0, "ts": 1000.0,
                             "dur": 10.0, "name": "decode"}],
            "s2c": {"epoch_unix": events[0]["t"] + 0.05,
                    "trace_id": "k", "worker": "w1"}}
    outs = []
    for flight in (t_flight, r_flight):
        jobs, _ = _assembled(flight, events)
        chrome = flight.chrome_events(jobs, [blob])
        outs.append((chrome, flight.validate(chrome)))
    assert outs[0] == outs[1]
    if name != "session":
        assert outs[0][1] == []


def test_validate_flags_breakage_equal_reference():
    bad = [{"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
            "args": {"name": "job j"}},
           {"ph": "X", "pid": 1, "tid": 1, "name": "s", "ts": 0.0,
            "dur": -5.0},
           {"ph": "X", "pid": 1, "tid": 9, "name": "o", "ts": 0.0,
            "dur": 1.0}]
    for events in ([], bad):
        assert t_flight.validate(events) == r_flight.validate(events)
    errs = t_flight.validate(bad)
    assert any("negative" in e for e in errs)
    assert any("orphaned" in e for e in errs)


def test_port_fleet_journal_assembles_equal_reference(tmp_path):
    """A journal the port's fleet protocol wrote (a claim, a reap and a
    steal, a commit fenced by the thief's claim) assembles alike, into
    a gap-free track whose steal gap the thief measured."""
    from sam2consensus_torch.observability.metrics import MetricsRegistry
    from sam2consensus_torch.serve import journal as sjournal
    from sam2consensus_torch.serve.fleet import FleetCoordinator

    j = sjournal.JobJournal(str(tmp_path / "j"), checkpoint_every=0)
    j.append("submitted", key="k", job="x", tenant="ta")
    a = FleetCoordinator(j, "wa", 0.05, MetricsRegistry())
    b = FleetCoordinator(sjournal.JobJournal(j.root, checkpoint_every=0),
                         "wb", 5.0, MetricsRegistry())
    assert a.try_claim("k", "x")
    j.append("started", key="k", job="x", worker="wa")
    time.sleep(0.08)
    assert b.try_claim("k", "x")
    j.append("started", key="k", job="x", worker="wb")
    j.append("committed", key="k", job="x", worker="wb",
             claim_seq=b.claim_seqs["k"], outputs={})
    events = j.events()
    t_jobs, t_view = _assembled(t_flight, events)
    r_jobs, r_view = _assembled(r_flight, events)
    assert t_view == r_view
    jl = t_jobs["k"]
    assert jl.terminal_ev == "committed" and jl.steals == 1
    assert jl.committed_worker == "wb"
    chrome = t_flight.chrome_events(t_jobs)
    assert t_flight.validate(chrome) == []
    assert chrome == r_flight.chrome_events(r_jobs)
    # the track tiles submit -> commit with no gap and no negative span
    segs = jl.segments
    assert all(s.t1 >= s.t0 for s in segs)
    assert all(x.t1 == pytest.approx(y.t0) for x, y in zip(segs, segs[1:]))
