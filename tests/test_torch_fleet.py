"""The port's fleet mode on the CPU, held against the JAX package.

The claim/lease protocol (``serve/fleet.py``, a copy) runs on the port's
journal with the reference's outcome on the same events: first claim
wins, a losing claim is ignored on replay, commits and failures close the
lease, an expired lease is reaped and stolen, a zombie's stale commit is
fenced void, a renewal voids a stale reap, the tick renews at half the
TTL, a restart adopts its own claim, and the burn and admission seeds
read the journal alike.  The port's ``ServeRunner(worker_id=...)`` drains
a queue with the JAX package's one-shot bytes, journals nothing for a job
whose lease a peer stole mid-run, refuses the same option combinations as
the reference (runner and CLI), and two worker processes on the CPU
(``cli.main(argv, device="cpu")``) drain one journal byte-identical to the
serial drain and to the JAX package's serve, with a clean audit.
"""

import dataclasses
import os
import subprocess
import sys
import time

import pytest

from sam2consensus_torch.config import RunConfig as TConfig
from test_torch_serve import (_collect_jax_garbage, jax_cold,  # noqa: F401
                              jax_serve_dir, read_dir, rendered, runner,
                              sim)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name):
    """The journal module, FleetCoordinator and MetricsRegistry of one
    package (``"t"``: the port, ``"r"``: the JAX package)."""
    import importlib

    root = {"t": "sam2consensus_torch", "r": "sam2consensus_tpu"}[name]
    jmod = importlib.import_module(f"{root}.serve.journal")
    fleet = importlib.import_module(f"{root}.serve.fleet")
    metrics = importlib.import_module(f"{root}.observability.metrics")
    return (jmod, lambda j, w, ttl=5.0: fleet.FleetCoordinator(
        j, w, ttl, metrics.MetricsRegistry()))


def _events(j):
    return [{k: v for k, v in e.items()
             if k not in ("t", "expires_unix", "schema")}
            for e in j.events()]


# -- the claim / lease protocol ----------------------------------------------
def case_first_claim_wins(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    a = coord(j, "wa")
    b = coord(jm.JobJournal(root, checkpoint_every=0), "wb")
    out = [a.try_claim("k1", "job1"), b.try_claim("k1", "job1"),
           a.registry.value("fleet/claims"),
           b.registry.value("fleet/claims"),
           j.replay().claims["k1"]["worker"]]
    return out + [_events(j)]


def case_losing_claim_ignored(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    now = time.time()
    j.append("claimed", key="k", worker="wa", expires_unix=now + 60)
    j.append("claimed", key="k", worker="wb", expires_unix=now + 60)
    return [j.replay().claims["k"]["worker"]]


def case_commit_and_failure_close(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    now = time.time()
    j.append("claimed", key="k", worker="wa", expires_unix=now + 60)
    j.append("committed", key="k", job="x", outputs={}, worker="wa")
    j.append("claimed", key="k2", worker="wa", expires_unix=now + 60)
    j.append("failed", key="k2", job="x", error="boom")
    return [sorted(j.replay().claims)]


def case_expired_reaped_and_stolen(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    a = coord(j, "wa", ttl=0.05)
    b = coord(jm.JobJournal(root, checkpoint_every=0), "wb", ttl=5.0)
    won = a.try_claim("k", "job")
    time.sleep(0.08)
    stole = b.try_claim("k", "job")
    return [won, stole, b.registry.value("fleet/steals"),
            b.registry.value("fleet/lease_reaped"),
            j.replay().claims["k"]["worker"], a.holds("k"),
            "k" in a.held, "k" in b.steal_gaps, _events(j)]


def case_zombie_commit_fenced(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    now = time.time()
    s_a = j.append("claimed", key="k", job="x", worker="wa",
                   expires_unix=now - 1.0)
    j.append("lease_expired", key="k", worker="wa", reaper="wb")
    s_b = j.append("claimed", key="k", job="x", worker="wb",
                   expires_unix=now + 60)
    j.append("committed", key="k", job="x", worker="wb", claim_seq=s_b,
             outputs={"f": None})
    j.append("committed", key="k", job="x", worker="wa", claim_seq=s_a,
             outputs={"stale": None})
    st = j.replay()
    audit = j.audit()
    j.append("committed", key="plain", job="y", outputs={})
    j.append("committed", key="plain", job="y", outputs={})
    return [st.commit_counts, st.committed["k"]["worker"],
            st.stale_commits, audit["duplicated"], audit["stale_commits"],
            j.replay().commit_counts["plain"]]


def case_renewal_voids_stale_reap(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    now = time.time()
    j.append("claimed", key="k", worker="wa", expires_unix=now - 1.0)
    j.append("lease_renewed", key="k", worker="wa",
             expires_unix=now + 60.0)
    j.append("lease_expired", key="k", worker="wa", reaper="wb")
    cur = j.replay().claims["k"]
    return [cur["worker"], round(cur["expires_unix"] - now, 1)]


def case_tick_renews_at_half_ttl(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    a = coord(j, "wa", ttl=0.2)
    won = a.try_claim("k", "job")
    time.sleep(0.12)
    a.tick()
    return [won, a.registry.value("fleet/lease_renewals") >= 1,
            a.holds("k")]


def case_restart_adopts_own_claim(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    a = coord(j, "wa", ttl=60.0)
    won = a.try_claim("k", "job")
    a2 = coord(jm.JobJournal(root, checkpoint_every=0), "wa", ttl=60.0)
    return [won, a2.try_claim("k", "job"), a2.holds("k"), _events(j)]


def case_burn_and_window_seed(jm, coord, root):
    j = jm.JobJournal(root, checkpoint_every=0)
    j.append("submitted", key="k1", job="a", tenant="tb")
    j.append("submitted", key="k2", job="b", tenant="tb")
    j.append("started", key="k1", job="a", worker="wa", tenant="tb")
    j.append("committed", key="k1", job="a", outputs={}, elapsed_sec=9.0,
             tenant="tb", worker="wa")
    st = j.replay()
    c = coord(j, "wb")
    return [c.fleet_burn(st, {"e2e": 5.0}), c.fleet_burn(st, {"e2e": 20.0}),
            c.seed_window_counts(st, own_keys=set()),
            c.seed_window_counts(st, own_keys={"k2"})]


def case_claim_refused_when_committed(jm, coord, root):
    os.makedirs(root, exist_ok=True)
    j = jm.JobJournal(root, checkpoint_every=0)
    p = os.path.join(root, "out.fasta")
    with open(p, "w") as fh:
        fh.write(">r\nACGT\n")
    j.append("committed", key="k", job="x",
             outputs={p: jm.file_fingerprint(p)})
    c = coord(j, "wb")
    refused = c.try_claim("k", "job")
    os.unlink(p)
    j.append("failed", key="f", job="x", error="old crash")
    return [refused, c.try_claim("k", "job"), c.try_claim("f", "job"),
            c.try_claim("f", "job", reclaim_stale_failed=True)]


CASES = {f.__name__[5:]: f for f in (
    case_first_claim_wins, case_losing_claim_ignored,
    case_commit_and_failure_close, case_expired_reaped_and_stolen,
    case_zombie_commit_fenced, case_renewal_voids_stale_reap,
    case_tick_renews_at_half_ttl, case_restart_adopts_own_claim,
    case_burn_and_window_seed, case_claim_refused_when_committed)}

#: what the reference's own tests (tests/test_fleet.py) pin, on the port
EXPECTED = {
    "first_claim_wins": lambda o: o[:5] == [True, False, 1, 0, "wa"],
    "losing_claim_ignored": lambda o: o == ["wa"],
    "commit_and_failure_close": lambda o: o == [[]],
    "expired_reaped_and_stolen": lambda o: o[:8] == [True, True, 1, 1,
                                                     "wb", False, False,
                                                     True],
    "zombie_commit_fenced": lambda o: o == [{"k": 1}, "wb", {"k": 1}, [],
                                            {"k": 1}, 2],
    "renewal_voids_stale_reap": lambda o: o == ["wa", 60.0],
    "tick_renews_at_half_ttl": lambda o: o == [True, True, True],
    "restart_adopts_own_claim": lambda o: o[:3] == [True, True, True],
    "burn_and_window_seed": lambda o: o == [{"tb": 1}, {}, {"tb": 1}, {}],
    "claim_refused_when_committed": lambda o: o == [False, True, False,
                                                    True],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_claim_protocol_equals_reference(tmp_path, case):
    outs = {}
    for tag in ("t", "r"):
        jm, coord = _pkg(tag)
        outs[tag] = CASES[case](jm, coord, str(tmp_path / tag / "j"))
    assert outs["t"] == outs["r"]
    assert EXPECTED[case](outs["t"]), outs["t"]


# -- the runner in fleet mode ------------------------------------------------
def _fleet_runner(tmp_path, worker="w0", **kw):
    return runner(journal_dir=str(tmp_path / "j"), worker_id=worker,
                  **kw)


def test_single_worker_fleet_equals_jax_one_shot(tmp_path):
    """``ServeRunner(worker_id=...)`` claims, runs and commits every job
    under its lease (commits carry the claim lineage), with the bytes of
    independent ``--backend jax`` runs, and a restarted worker of the
    same id resumes the committed queue without running anything."""
    from sam2consensus_torch.observability import flight
    from sam2consensus_torch.serve import JobSpec

    paths = [sim(tmp_path, f"f{k}.sam", 60 + k, contig_len=1500,
                 n_reads=400, ins_read_rate=0.2) for k in range(2)]
    out = str(tmp_path / "out")
    os.makedirs(out)
    cfg = TConfig(pileup="pallas", ins_kernel="pallas",
                  outfolder=out + os.sep)
    specs = [JobSpec(p, dataclasses.replace(cfg, prefix=f"f{k}"))
             for k, p in enumerate(paths)]
    r = _fleet_runner(tmp_path)
    try:
        results = r.submit_jobs(specs)
        assert all(x.ok for x in results), [x.error for x in results]
        assert [x.worker for x in results] == ["w0", "w0"]
        for p, spec, res in zip(paths, specs, results):
            assert rendered(res) == jax_cold(p, spec.config)
        audit = r.journal.audit()
        assert audit["lost"] == [] and audit["duplicated"] == []
        evs = r.journal.events()
        claims = {e["key"]: e["seq"] for e in evs if e["ev"] == "claimed"}
        commits = [e for e in evs if e["ev"] == "committed"]
        assert len(commits) == 2
        assert all(c["claim_seq"] == claims[c["key"]] and
                   c["worker"] == "w0" for c in commits)
        assert r.registry.value("fleet/claims") == 2
        jobs = flight.assemble(evs)
        assert flight.validate(flight.chrome_events(jobs)) == []
        assert "lease" in r.health_snapshot()
        assert 'worker="w0"' in r.render_telemetry()
    finally:
        r.close()
    again = _fleet_runner(tmp_path)
    try:
        res2 = again.submit_jobs(specs)
    finally:
        again.close()
    assert all(x.resumed for x in res2)


@pytest.mark.parametrize("outcome", ["ok", "failed"])
def test_stolen_lease_never_commits_or_fails_the_job(tmp_path, outcome):
    """A worker whose lease a peer reaped and re-claimed while its
    attempt ran journals nothing for the job — neither the commit of a
    result that finished after the steal nor the failure of one that
    raised — and the thief's claim stays intact (the reference's
    ``test_woken_zombie_never_journals_its_failure``, both outcomes)."""
    from sam2consensus_torch.serve import JobSpec
    from sam2consensus_torch.serve import journal as sjournal

    path = sim(tmp_path, "z.sam", 73, contig_len=1500, n_reads=300)
    out = str(tmp_path / "out")
    r = _fleet_runner(tmp_path, lease_ttl=0.2)
    real_execute = r._execute
    stolen = []

    def zombie_execute(*a, **k):
        result = real_execute(*a, **k) if outcome == "ok" else None
        time.sleep(0.3)                 # no renewal reaches the journal
        jj = sjournal.JobJournal(r.journal.root, checkpoint_every=0)
        (key, _cur), = jj.read_state().claims.items()
        stolen.append(key)
        jj.append("lease_expired", key=key, worker="w0", reaper="thief")
        jj.append("claimed", key=key, job="stolen", worker="thief",
                  expires_unix=time.time() + 60)
        if result is None:
            raise RuntimeError("boom after steal")
        return result

    r._execute = zombie_execute
    try:
        res = r.submit_jobs([JobSpec(path, TConfig(
            outfolder=out + os.sep, prefix="pz"))])[0]
        st = r.journal.read_state()
        assert not res.ok and "lease lost" in res.error
        assert st.failed == {} and st.committed == {}
        assert st.claims[stolen[0]]["worker"] == "thief"
        assert r.registry.value("fleet/lease_lost") == 1
        assert not os.path.exists(out) or os.listdir(out) == []
    finally:
        r.close()


RUNNER_REFUSALS = [dict(worker_id="w"), dict(worker_id="w", batch="4"),
                   dict(worker_id="w", count_cache="64M"),
                   dict(worker_id="w", lease_ttl=0.0)]


@pytest.mark.parametrize("kw", RUNNER_REFUSALS,
                         ids=["no_journal", "batch", "count_cache", "ttl"])
def test_worker_id_runner_refusals_equal_reference(tmp_path, kw):
    from sam2consensus_tpu.serve import ServeRunner

    kw = dict(kw)
    if len(kw) > 1:
        kw["journal_dir"] = str(tmp_path / "j")
    msgs = []
    for make in (lambda: runner(**kw),
                 lambda: ServeRunner(prewarm="off", persistent_cache=False,
                                     **kw)):
        with pytest.raises(ValueError) as exc:
            make().close()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


CLI_REFUSALS = [["--worker-id", "w"],
                ["--worker-id", "w", "--journal", "{j}", "--batch", "4"],
                ["--worker-id", "w", "--journal", "{j}", "--count-cache",
                 "64M"],
                ["--lease-ttl", "0"], ["--lease-ttl", "-2"],
                ["--worker-id", "w", "--journal", "{j}", "--lease-ttl",
                 "0"]]


@pytest.mark.parametrize("argv", CLI_REFUSALS,
                         ids=[" ".join(a) for a in CLI_REFUSALS])
def test_worker_id_cli_cross_checks_equal_reference(tmp_path, argv):
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    argv = [a.replace("{j}", str(tmp_path / "j")) for a in argv]
    full = ["serve", "-i", str(tmp_path / "x.sam"), "-o",
            str(tmp_path / "o"), "--quiet", *argv]
    codes = []
    for main in (lambda: t_cli.main(full, device="cpu"),
                 lambda: r_cli.main(full)):
        with pytest.raises(SystemExit) as exc:
            main()
        codes.append(str(exc.value.code))
    assert codes[0] == codes[1]
    assert codes[0].startswith("error: ")


def test_workers_sharing_an_output_folder_start_at_once(tmp_path,
                                                       monkeypatch):
    """Two fleet workers given one new ``-o`` both see it missing and
    both make it: the second must not fail (ROADMAP §C 5)."""
    from sam2consensus_torch import config as t_config

    out = tmp_path / "o"
    out.mkdir()                       # the peer made it first ...
    real = os.path.exists
    monkeypatch.setattr(os.path, "exists",  # ... after this one looked
                        lambda p: False if p == str(out) else real(p))
    assert t_config.normalize_outfolder(str(out)) == str(out) + "/"


_WORKER = ("import sys; from sam2consensus_torch.cli import main; "
           "sys.exit(main(sys.argv[1:], device='cpu'))")


def test_two_worker_processes_drain_byte_identical(tmp_path):
    """Two worker processes on the CPU share one journal: every job is
    committed once by one of them, the outputs equal the serial drain's
    and the JAX package's serve of the same queue, and the audit shows no
    lost and no duplicated job."""
    from sam2consensus_torch import cli
    from sam2consensus_torch.serve import journal as sjournal

    inputs = sum((["-i", sim(tmp_path, f"q{k}.sam", 80 + k,
                             contig_len=1500, n_reads=400)]
                  for k in range(3)), [])
    serial = str(tmp_path / "serial")
    assert cli.main(["serve", *inputs, "-o", serial, "--quiet"],
                    device="cpu") == 0
    out, jdir = str(tmp_path / "fleet"), str(tmp_path / "j")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, "serve", *inputs, "-o", out,
         "--journal", jdir, "--worker-id", w, "--quiet"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for w in ("fw0", "fw1")]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append((p.returncode, err.decode()[-600:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [rc for rc, _ in errs] == [0, 0], errs
    assert read_dir(out) == read_dir(serial)
    assert read_dir(out) == jax_serve_dir(inputs, str(tmp_path / "ref"))
    j = sjournal.JobJournal(jdir)
    audit = j.audit()
    assert audit["lost"] == [] and audit["duplicated"] == []
    committed_by = {e["key"]: e["worker"] for e in j.events()
                    if e["ev"] == "committed"}
    assert len(committed_by) == 3
    assert set(committed_by.values()) <= {"fw0", "fw1"}
